// The port's copy of the parts of lic_tpu/coding/rans.cpp that
// lic_tpu_torch/coding/rans.py binds (the indexed 64-bit coder and the
// interleaved rans16i lane coder), built into build/_rans.so at first use.
// Tests hold its streams byte-identical to the JAX package's coder.
//
// Host-side rANS range coder for the TPU codec.
//
// The reference relies on CompressAI's C++ rANS backend but never calls it
// (it reports likelihood-estimated bpp only; SURVEY.md §2.7).  This coder
// closes that gap: device-computed quantized CDF tables in, real bitstreams
// out.
//
// Design: standard 32-bit rANS with 32-bit renormalization emitting 32-bit
// words, LIFO (encode reversed, decode forward).  Each symbol carries an
// index selecting its CDF row — one row per channel (factorized prior) or
// per quantized scale (conditional Gaussian).  Out-of-table values use an
// escape slot followed by 4-bit-chunk bypass coding with continuation, so
// any integer round-trips.
//
// C ABI for ctypes binding (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;          // CDF precision (must match tables)
constexpr uint32_t kRansL = 1u << 23;       // lower bound of the interval
constexpr uint32_t kBypassBits = 4;
constexpr uint32_t kBypassMax = (1u << kBypassBits) - 1;

struct RansEncoder {
  uint64_t state = kRansL;
  std::vector<uint32_t> words;  // emitted backwards

  inline void put(uint32_t start, uint32_t freq) {
    // renormalize: keep state < (kRansL >> kProbBits << 32) * freq
    uint64_t x_max = ((uint64_t)(kRansL >> kProbBits) << 32) * freq;
    while (state >= x_max) {
      words.push_back((uint32_t)state);
      state >>= 32;
    }
    state = ((state / freq) << kProbBits) + (state % freq) + start;
  }

  inline void put_bits(uint32_t val, uint32_t nbits) {
    // raw bits = uniform cdf: start=val, freq=1 at precision nbits
    uint64_t x_max = ((uint64_t)(kRansL >> nbits) << 32);
    while (state >= x_max) {
      words.push_back((uint32_t)state);
      state >>= 32;
    }
    state = (state << nbits) + val;
  }

  size_t flush(uint8_t* out, size_t cap) {
    std::vector<uint32_t> final_words = words;
    final_words.push_back((uint32_t)state);
    final_words.push_back((uint32_t)(state >> 32));
    size_t nbytes = final_words.size() * 4;
    if (nbytes > cap) return (size_t)-1;
    // reverse word order so the decoder reads forward
    for (size_t i = 0; i < final_words.size(); ++i) {
      uint32_t wv = final_words[final_words.size() - 1 - i];
      std::memcpy(out + i * 4, &wv, 4);
    }
    return nbytes;
  }
};

struct RansDecoder {
  uint64_t state = 0;
  const uint8_t* ptr;
  const uint8_t* end;
  bool overrun = false;  // set when a read past end-of-buffer was attempted

  void init(const uint8_t* in, size_t n) {
    ptr = in;
    end = in + n;
    uint32_t hi = read_word();
    uint32_t lo = read_word();
    state = ((uint64_t)hi << 32) | lo;
  }

  inline uint32_t read_word() {
    if (ptr + 4 > end) {
      overrun = true;
      return 0;
    }
    uint32_t w;
    std::memcpy(&w, ptr, 4);
    ptr += 4;
    return w;
  }

  inline uint32_t peek() const { return (uint32_t)(state & ((1u << kProbBits) - 1)); }

  inline void advance(uint32_t start, uint32_t freq) {
    state = freq * (state >> kProbBits) + peek() - start;
    while (state < kRansL && ptr < end) {
      state = (state << 32) | read_word();
    }
  }

  inline uint32_t get_bits(uint32_t nbits) {
    uint32_t val = (uint32_t)(state & ((1u << nbits) - 1));
    state >>= nbits;
    while (state < kRansL && ptr < end) {
      state = (state << 32) | read_word();
    }
    return val;
  }
};

// zig-zag mapping for bypass-coded escape values
inline uint32_t zigzag(int32_t v) { return (v << 1) ^ (v >> 31); }
inline int32_t unzigzag(uint32_t u) { return (int32_t)(u >> 1) ^ -(int32_t)(u & 1); }

inline void bypass_encode(RansEncoder& enc, uint32_t u) {
  // emit 4-bit chunks most-significant-first with a continuation flag chunk
  // count first.  Encoder runs in reverse overall, so we collect then emit
  // reversed at the call site; simpler: encode value as a sequence of
  // (chunk, has_more) pairs in reverse order here.
  uint32_t chunks[12];
  int n = 0;
  do {
    chunks[n++] = u & kBypassMax;
    u >>= kBypassBits;
  } while (u != 0);
  // rANS is LIFO: the decoder reads items in reverse encode order.  It
  // reads the count first, then chunks most-significant-first.  So encode
  // chunks LSB-first (chunks[0]..chunks[n-1]) and the count last.
  for (int i = 0; i < n; ++i) {
    enc.put_bits(chunks[i], kBypassBits);
  }
  enc.put_bits((uint32_t)(n - 1), kBypassBits);  // n <= 8 for 32-bit values
}

inline uint32_t bypass_decode(RansDecoder& dec) {
  uint32_t n = dec.get_bits(kBypassBits) + 1;
  uint32_t u = 0;
  for (uint32_t i = 0; i < n; ++i) {
    u = (u << kBypassBits) | dec.get_bits(kBypassBits);
  }
  return u;
}

}  // namespace

extern "C" {

// cdfs: concatenated rows, each row_len entries, monotone, cdf[0]=0,
// cdf[row_len-1]=2^16.  Symbol alphabet per row = row_len-1 slots where the
// LAST slot is the escape symbol.
// symbols: integer values; for row r, in-table values are
// [offsets[r], offsets[r] + row_len - 3] mapping to slots [0, row_len-3];
// anything else escapes.
//
// Returns number of bytes written, or -1 on overflow.
long rans_encode_indexed(
    const int32_t* symbols, const int32_t* indexes, long n,
    const uint32_t* cdfs, long row_len,
    const int32_t* offsets,
    uint8_t* out, long out_cap) {
  RansEncoder enc;
  long nsyms = row_len - 2;  // usable value slots excluding escape
  // rANS is LIFO: encode in reverse so decode is forward.
  for (long i = n - 1; i >= 0; --i) {
    int32_t idx = indexes[i];
    const uint32_t* cdf = cdfs + (long)idx * row_len;
    int32_t off = offsets[idx];
    int64_t slot = (int64_t)symbols[i] - off;
    if (slot >= 0 && slot < nsyms) {
      enc.put(cdf[slot], cdf[slot + 1] - cdf[slot]);
    } else {
      // escape: bypass the zig-zagged overflow distance, then the escape slot
      int64_t delta = slot < 0 ? slot : slot - (nsyms - 1);
      bypass_encode(enc, zigzag((int32_t)delta));
      enc.put(cdf[nsyms], cdf[nsyms + 1] - cdf[nsyms]);
    }
  }
  return (long)enc.flush(out, (size_t)out_cap);
}

// First-level slot lookup: lut[row][cum >> 8] = largest slot s with
// cdf[s] <= (cum >> 8) << 8.  Turns the per-symbol binary search (~7
// probes, each a potential cache miss on a cold CDF row) into one lookup
// plus a short forward scan within the 256-wide bucket.  Gaussian CDFs
// concentrate mass in a few slots, so the scan is 0–2 steps on average.
constexpr uint32_t kLutBits = 8;
constexpr uint32_t kLutSize = 1u << kLutBits;

void rans_build_lut(
    const uint32_t* cdfs, long rows, long row_len, uint16_t* lut) {
  long nsyms = row_len - 2;
  for (long r = 0; r < rows; ++r) {
    const uint32_t* cdf = cdfs + r * row_len;
    uint16_t* row = lut + r * kLutSize;
    long slot = 0;
    for (uint32_t b = 0; b < kLutSize; ++b) {
      uint32_t cum = b << (kProbBits - kLutBits);
      while (slot < nsyms && cdf[slot + 1] <= cum) ++slot;
      row[b] = (uint16_t)slot;
    }
  }
}

static void decode_symbols(
    RansDecoder& dec,
    const int32_t* indexes, long n,
    const uint32_t* cdfs, long row_len,
    const int32_t* offsets,
    const uint16_t* lut,  // nullable: fall back to binary search
    int32_t* out) {
  long nsyms = row_len - 2;
  for (long i = 0; i < n; ++i) {
    int32_t idx = indexes[i];
    const uint32_t* cdf = cdfs + (long)idx * row_len;
    int32_t off = offsets[idx];
    uint32_t cum = dec.peek();
    long slot;
    if (lut != nullptr) {
      slot = lut[(long)idx * kLutSize + (cum >> (kProbBits - kLutBits))];
      while (slot < nsyms && cdf[slot + 1] <= cum) ++slot;
    } else {
      long lo = 0, hi = nsyms;
      while (lo < hi) {
        long mid = (lo + hi + 1) >> 1;
        if (cdf[mid] <= cum) lo = mid; else hi = mid - 1;
      }
      slot = lo;
    }
    dec.advance(cdf[slot], cdf[slot + 1] - cdf[slot]);
    if (slot < nsyms) {
      out[i] = (int32_t)(slot + off);
    } else {
      int32_t delta = unzigzag(bypass_decode(dec));
      long base = delta < 0 ? 0 : (nsyms - 1);
      out[i] = (int32_t)(base + delta + off);
    }
  }
}

long rans_decode_indexed(
    const uint8_t* in, long n_bytes,
    const int32_t* indexes, long n,
    const uint32_t* cdfs, long row_len,
    const int32_t* offsets,
    const uint16_t* lut,
    int32_t* out) {
  RansDecoder dec;
  dec.init(in, (size_t)n_bytes);
  decode_symbols(dec, indexes, n, cdfs, row_len, offsets, lut, out);
  // Integrity: decoding the exact encoder output must return the state to
  // the initial interval bound with every word consumed; truncated or
  // corrupt streams fail one of these instead of silently yielding zeros.
  if (dec.overrun || dec.state != kRansL || dec.ptr != dec.end) return -1;
  return n;
}

// ---- rans16: lane-parallel streams for the on-device decoder ----
//
// 32-bit state, 16-bit renormalization (ryg rans16 style), kProbBits=16
// CDF tables shared with the 64-bit coder above.  L lane states decode one
// symbol per lane per chunk; at most ONE 16-bit renorm per symbol decode
// (state >= 1 after advance; one word restores state >= 2^16), which is
// what makes the branchless vector decode possible.
//
// Escapes use the same 4-bit-chunk bypass scheme as the 64-bit coder
// (count first on decode, then chunks MSB-first).

namespace {

constexpr uint32_t kLaneL = 1u << 16;  // lower bound of the lane interval

// Shared-stream helpers: L lane states share ONE reversed word vector
// (interleaved renormalization).
inline void put16s(uint32_t& state, std::vector<uint16_t>& w,
                   uint32_t start, uint32_t freq) {
  uint64_t x_max = (uint64_t)freq << 16;
  while (state >= x_max) {
    w.push_back((uint16_t)state);
    state >>= 16;
  }
  state = ((state / freq) << kProbBits) + (state % freq) + start;
}

inline void put_bits16s(uint32_t& state, std::vector<uint16_t>& w,
                        uint32_t val, uint32_t nbits) {
  uint64_t x_max = (uint64_t)1 << (32 - nbits);
  while (state >= x_max) {
    w.push_back((uint16_t)state);
    state >>= 16;
  }
  state = (state << nbits) + val;
}

inline int nibble_count(uint32_t u) {
  int n = 1;
  u >>= 4;
  while (u) {
    ++n;
    u >>= 4;
  }
  return n;
}

}  // namespace

// ------------------------------------------------------------- rans16i --
// Shared-stream INTERLEAVED lane coding: one word stream feeds all L lane
// states.  The decoder's word-read order is fully deterministic given
// (step_counts, L): per chunk k of step t, phase A decodes one symbol per
// valid lane (lanes ascending, each reading ≤1 renorm word), phase B reads
// the escape nibble-counts (lanes ascending), then 8 nibble phases C_i
// (lanes ascending).  A TPU decoder therefore serves each phase's reads
// from ONE contiguous window at the shared pointer (prefix-sum the
// per-lane need), eliminating scattered per-lane gathers — and the
// per-lane word-count table of the segmented format disappears from the
// container (4 B/lane saved).
//
// The encoder mirrors this by processing the op list in exact REVERSE
// (steps, chunks, phases, lanes all descending), pushing renorm words of
// all lanes into one reversed buffer; the final per-lane state flushes
// (decoder init: 2 words per lane, lanes ascending, stream head) are
// pushed last and the whole buffer is reversed on output.
//
// symbols/indexes are in flat DECODE order (step-major), no per-lane
// permutation.  Returns total words or -1 on overflow.
long rans16i_encode(
    const int32_t* symbols, const int32_t* indexes,
    const int64_t* step_counts, long n_steps, long n_lanes,
    const uint32_t* cdfs, long row_len,
    const int32_t* offsets,
    uint16_t* out, long out_cap_words) {
  long nsyms = row_len - 2;
  std::vector<uint32_t> st((size_t)n_lanes, kLaneL);
  std::vector<uint16_t> words;
  long total = 0;
  for (long t = 0; t < n_steps; ++t) total += step_counts[t];
  words.reserve((size_t)total + 2 * n_lanes + 64);
  long base = total;
  for (long t = n_steps - 1; t >= 0; --t) {
    long sc = step_counts[t];
    base -= sc;
    long mc = (sc + n_lanes - 1) / n_lanes;
    for (long k = mc - 1; k >= 0; --k) {
      long lim = std::min(n_lanes, sc - k * n_lanes);
      long fb = base + k * n_lanes;
      // reverse of decode read order: C_7..C_0, B, A (lanes descending)
      for (int i = 7; i >= 0; --i) {
        for (long lane = lim - 1; lane >= 0; --lane) {
          int32_t idx = indexes[fb + lane];
          int64_t slot = (int64_t)symbols[fb + lane] - offsets[idx];
          if (slot >= 0 && slot < nsyms) continue;
          int64_t delta = slot < 0 ? slot : slot - (nsyms - 1);
          uint32_t u = zigzag((int32_t)delta);
          int nib = nibble_count(u);
          if (i >= nib) continue;
          put_bits16s(st[lane], words, (u >> (4 * (nib - 1 - i))) & 15u, 4);
        }
      }
      for (long lane = lim - 1; lane >= 0; --lane) {
        int32_t idx = indexes[fb + lane];
        int64_t slot = (int64_t)symbols[fb + lane] - offsets[idx];
        if (slot >= 0 && slot < nsyms) continue;
        int64_t delta = slot < 0 ? slot : slot - (nsyms - 1);
        int nib = nibble_count(zigzag((int32_t)delta));
        put_bits16s(st[lane], words, (uint32_t)(nib - 1), 4);
      }
      for (long lane = lim - 1; lane >= 0; --lane) {
        int32_t idx = indexes[fb + lane];
        const uint32_t* cdf = cdfs + (long)idx * row_len;
        int64_t slot = (int64_t)symbols[fb + lane] - offsets[idx];
        if (slot >= 0 && slot < nsyms)
          put16s(st[lane], words, cdf[slot], cdf[slot + 1] - cdf[slot]);
        else
          put16s(st[lane], words, cdf[nsyms], cdf[nsyms + 1] - cdf[nsyms]);
      }
    }
  }
  // decoder init reads (hi, lo) per lane ascending at the stream head
  for (long lane = n_lanes - 1; lane >= 0; --lane) {
    words.push_back((uint16_t)st[lane]);          // lo (read 2nd)
    words.push_back((uint16_t)(st[lane] >> 16));  // hi (read 1st)
  }
  if ((long)words.size() > out_cap_words) return -1;
  for (size_t i = 0; i < words.size(); ++i)
    out[i] = words[words.size() - 1 - i];
  return (long)words.size();
}

// Host mirror of the device interleaved decoder (tests/fallback).
// Returns 0 on clean end-of-stream + all states back at kLaneL.
long rans16i_decode(
    const uint16_t* in, long n_words,
    const int32_t* indexes,
    const int64_t* step_counts, long n_steps, long n_lanes,
    const uint32_t* cdfs, long row_len,
    const int32_t* offsets,
    int32_t* out) {
  long nsyms = row_len - 2;
  std::vector<uint32_t> st((size_t)n_lanes);
  const uint16_t* p = in;
  const uint16_t* end = in + n_words;
  bool overrun = false;
  auto rd = [&]() -> uint32_t {
    if (p >= end) {
      overrun = true;
      return 0;
    }
    return *p++;
  };
  for (long lane = 0; lane < n_lanes; ++lane) {
    uint32_t hi = rd(), lo = rd();
    st[lane] = (hi << 16) | lo;
  }
  std::vector<uint8_t> esc((size_t)n_lanes);
  std::vector<int> cnt((size_t)n_lanes);
  std::vector<uint32_t> uacc((size_t)n_lanes);
  long base = 0;
  for (long t = 0; t < n_steps; ++t) {
    long sc = step_counts[t];
    long mc = (sc + n_lanes - 1) / n_lanes;
    for (long k = 0; k < mc; ++k) {
      long lim = std::min(n_lanes, sc - k * n_lanes);
      long fb = base + k * n_lanes;
      for (long lane = 0; lane < lim; ++lane) {  // phase A
        int32_t idx = indexes[fb + lane];
        const uint32_t* cdf = cdfs + (long)idx * row_len;
        uint32_t cum = st[lane] & 0xFFFFu;
        long lo_ = 0, hi_ = nsyms;
        while (lo_ < hi_) {
          long mid = (lo_ + hi_ + 1) >> 1;
          if (cdf[mid] <= cum) lo_ = mid; else hi_ = mid - 1;
        }
        st[lane] =
            (cdf[lo_ + 1] - cdf[lo_]) * (st[lane] >> kProbBits) + cum - cdf[lo_];
        if (st[lane] < kLaneL) st[lane] = (st[lane] << 16) | rd();
        esc[lane] = lo_ == nsyms;
        uacc[lane] = 0;
        if (!esc[lane]) out[fb + lane] = (int32_t)(lo_ + offsets[idx]);
      }
      for (long lane = 0; lane < lim; ++lane) {  // phase B
        if (!esc[lane]) continue;
        cnt[lane] = (int)(st[lane] & 15u) + 1;
        st[lane] >>= 4;
        if (st[lane] < kLaneL) st[lane] = (st[lane] << 16) | rd();
      }
      for (int i = 0; i < 8; ++i) {  // phases C_i (MSB first)
        for (long lane = 0; lane < lim; ++lane) {
          if (!esc[lane] || i >= cnt[lane]) continue;
          uacc[lane] = (uacc[lane] << 4) | (st[lane] & 15u);
          st[lane] >>= 4;
          if (st[lane] < kLaneL) st[lane] = (st[lane] << 16) | rd();
        }
      }
      for (long lane = 0; lane < lim; ++lane) {
        if (!esc[lane]) continue;
        int32_t idx = indexes[fb + lane];
        int32_t delta = unzigzag(uacc[lane]);
        long b2 = delta < 0 ? 0 : (nsyms - 1);
        out[fb + lane] = (int32_t)(b2 + delta + offsets[idx]);
      }
    }
    base += sc;
  }
  bool ok = !overrun && p == end;
  for (long lane = 0; lane < n_lanes; ++lane) ok = ok && st[lane] == kLaneL;
  return ok ? 0 : -1;
}

}  // extern "C"
