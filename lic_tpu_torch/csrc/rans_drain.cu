// Kernel B1: the interleaved rANS16 drain, for sm_90a.
//
// Replaces lic_tpu/coding/pallas_rans.py::pallas_drain (_build_drain.run ->
// _drain_kernel).  It computes what DeviceRans16Interleaved._decode_chunk_live
// computes (lic_tpu/coding/device_rans.py:441-501), chunk after chunk, bit
// for bit: per chunk of L symbols, the CDF-row slot search, the state update,
// the shared-pointer window renorm (the k-th lane needing a word takes word
// ptr + k) and, only when a lane of the chunk escapes, the 4-bit-nibble
// bypass path (a count nibble, then up to 8 value nibbles, each a renorm
// phase).  Its plain PyTorch version is
// lic_tpu_torch/coding/device_rans.py::drain_plain.
//
// What bounds it on this card: the serial chain, not bytes or operations.
// The chunks of one stream form a chain (each chunk's renorm takes words at
// the pointer the previous chunk left), so a stream is one CTA walking its
// chunks, and a batch of B streams fills only B of the 132 SMs.  A chunk's
// time is the latency of its dependent steps: the slot search, the state
// update, the block-wide rank exchange of each renorm phase and the read of
// the renorm word.  A global load on that chain costs hundreds of cycles and
// a block barrier tens, and a chunk with an escape has ten renorm phases: a
// chain with a global load and two barriers per phase costs ~6,000 cycles
// a chunk on escape-heavy streams.
//
// What the design does about it:
//  * one CTA per stream, one thread per lane: L in {8, 16, ..., 256} (128
//    for the charm and entroformer streams; the neural-syntax coder takes
//    its lane count from the latent size).  The CTA has max(L, 32) threads
//    in NW = max(L / 32, 1) warps, a template constant, so every loop over
//    the warps unrolls; under 32 lanes the threads t >= L are dead: never
//    valid, so they join every ballot with a 0 and never take a word.  The
//    lane state lives in a register as uint32 and the shared pointer in a
//    register of every thread;
//  * no global load on the chain: each chunk starts one cp.async group that
//    copies the CDF rows of the chunk kLead chunks ahead into a shared ring
//    of rows, and, when the pointer has moved far enough, segments of the
//    payload into a shared ring of words kept 10 L kLead words ahead of the
//    pointer (a chunk consumes at most 10 L words: the main phase, the count
//    phase and 8 nibble phases); a chunk waits only for the group started
//    kLead chunks before it.  A word at or past the payload's end is
//    zero-filled by the copy (only a corrupt stream reads there: valid
//    streams end >= L zero words before it);
//  * the CDF table, its row offsets and a coarse slot index (per row and per
//    cum >> 7, the slot of the bucket's first cum, built on the host by
//    coding/drain.py::slot_index) sit in shared memory where they fit
//    beside the payload ring (the 64-row Gaussian table: 165 KB); a larger
//    table (GaussianMuCoder's 1,024 rows: 2.64 MB) stays in device memory,
//    read through the read-only path (L2 holds it).  The route is chosen by
//    the shared memory the table needs, nothing else (rans_drain_route);
//    both compute the same bits.  Where the table fits, shared memory is
//    the faster route (measured with tools/kernel_probe.py --kernel
//    b1_routes; PERF.md section 6).  The slot search is a binary search only
//    between a bucket's first slot and the next bucket's, zero steps where
//    one slot covers the bucket;
//  * one barrier per renorm exchange: per-warp counts (ballot / popc) go
//    into double-buffered shared words, so the next exchange's writes need
//    no second barrier; the main phase's exchange also says whether a lane
//    of the chunk escapes;
//  * one exchange for the whole escape path.  With the state S >= 2^16 after
//    the main phase, every escape phase shifts S right by 4 and, when the
//    result is < 2^16, shifts it up by 16 and fills the low 16 bits with a
//    word, so S stays >= 2^16 and whether a phase needs a word depends only
//    on S's bit length, never on the words read.  An escaping lane knows
//    its needs for all its phases once the count nibble is read; per-warp,
//    per-phase ballots give every word's index in one exchange
//    (ptr + earlier phases' totals + rank within the phase), and the lane
//    reads its words from the ring without further barriers.  A lane whose
//    state is below 2^16 after the main phase (a corrupt stream) sends the
//    chunk through the phase-by-phase path, which is exact in every case;
//  * (state, ptr) go in and out through device memory, so the per-slice
//    launches of one decode thread the state.
// The TPU kernel's one-hot fp32 matmuls, byte-split selects, aligned window
// supersets, sublane padding and segment budget have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEscPhases = 9;   // the count nibble and up to 8 value nibbles
constexpr int kBucketBits = 7;  // the coarse slot index keys on cum >> 7
constexpr int kIdxLen = (1 << (16 - kBucketBits)) + 1;  // entries per CDF row
constexpr int kLead = 4;        // chunks between a copy's start and its use
constexpr int kRowSlots = 8;    // the rows ring: chunks c .. c + kLead in use

__device__ __forceinline__ void cp_async4(uint32_t dst, const int32_t* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until every group but the kLead - 1 newest has landed
__device__ __forceinline__ void cp_async_wait_lead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLead - 1) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The payload ring: words [ptr, loaded) are requested.  Each thread copies
// 4 words of a segment of 4 NT (NT = 32 NW threads).
struct Ring {
  int32_t* buf;   // rlen words, rlen a power of two
  int mask;       // rlen - 1
  int ahead;      // loaded - ptr kept >= 10 L kLead (L lanes)
  int loaded;
};

// Every thread calls it with the same ptr: request segments until the ring
// runs `ahead` words past ptr, into the cp.async group being built.
template <int NT>
__device__ __forceinline__ void ring_refill(Ring& r, int ptr, const int32_t* __restrict__ pay,
                                            int W) {
  while (r.loaded - ptr < r.ahead) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = r.loaded + i * NT + static_cast<int>(threadIdx.x);
      const bool in = w < W;
      cp_async4(smem_addr(r.buf + (w & r.mask)), in ? pay + w : pay, in ? 4 : 0);
    }
    r.loaded += 4 * NT;
  }
}

// A table word: from shared memory, or (kGlobal) from device memory
// through the read-only path.
template <bool kGlobal, typename T>
__device__ __forceinline__ T tload(const T* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// One phase-by-phase renorm (the escape path of a corrupt stream): every
// thread of the block calls it.  Lanes with `need` take consecutive words
// from the shared pointer in lane order.
template <int NW>
__device__ __forceinline__ uint32_t window_renorm(uint32_t state, bool need, int& ptr,
                                                  const Ring& r, int* s_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, need);
  if (lane == 0) s_cnt[warp] = __popc(mask);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = s_cnt[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();  // s_cnt is rewritten by the next phase
  if (need) {
    const int idx = ptr + before + __popc(mask & ((1u << lane) - 1u));
    state = (state << 16) | static_cast<uint32_t>(r.buf[idx & r.mask]);
  }
  ptr += total;
  return state;
}

template <int NW, bool kGlobal>
__global__ void __launch_bounds__(32 * NW) rans_drain_kernel(
    const int32_t* __restrict__ rows,      // (B, S) CDF row per symbol
    const int32_t* __restrict__ payload,   // (B, W) zero-extended words
    uint32_t* __restrict__ state_io,       // (B, L) lane states, in/out
    int32_t* __restrict__ ptr_io,          // (B,) shared pointers, in/out
    int32_t* __restrict__ out,             // (B, S) decoded values
    const int32_t* __restrict__ cdf,       // (nrows, row_len)
    const int32_t* __restrict__ offsets,   // (nrows,)
    const uint32_t* __restrict__ slot_idx,  // (nrows, kIdxLen) coarse slot index
    int S, int s_tot, int W, int L, int nrows, int row_len, int rlen) {
  constexpr int NT = 32 * NW;  // threads; lanes t < L are live
  extern __shared__ __align__(16) int32_t smem[];
  // exchange words, double-buffered: the main phase's per-warp count (low
  // 16 bits) and escape flag (bit 16); the escape phases' per-warp counts,
  // two phases a word (16 bits each; phase 8 alone in word 4, whose bit 16
  // flags a lane that needs the phase-by-phase path)
  __shared__ int s_main[2][NW];
  __shared__ __align__(16) uint32_t s_esc[2][NW][8];
  __shared__ int s_fb[NW];  // phase-by-phase path
  __shared__ int s_fb_kmax;
  __shared__ int32_t s_rows[kRowSlots][NT];
  __shared__ uint16_t s_needs[8 * 16];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const unsigned lt = (1u << lane) - 1u;

  Ring ring;
  ring.buf = smem;
  ring.mask = rlen - 1;
  ring.ahead = 10 * L * kLead;
  // the table in shared memory behind the ring, or kGlobal: in place
  int32_t* s_cdf = smem + rlen;
  int32_t* s_off = s_cdf + nrows * row_len;
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(s_off + nrows);
  const int32_t* t_cdf = kGlobal ? cdf : s_cdf;
  const int32_t* t_off = kGlobal ? offsets : s_off;
  const uint32_t* t_idx = kGlobal ? slot_idx : s_idx;

  const bool live = t < L;
  const int32_t* pay = payload + static_cast<size_t>(b) * W;
  const int32_t* rrow = rows + static_cast<size_t>(b) * S;
  int32_t* orow = out + static_cast<size_t>(b) * S;
  uint32_t state = live ? state_io[static_cast<size_t>(b) * L + t] : 0u;
  int ptr = ptr_io[b];

  // this thread's row of chunk k (a zero past s_tot, and for a dead
  // thread) into its ring slot
  auto copy_row = [&](int k) {
    const int i = k * L + t;
    const bool in = live && i < s_tot;
    cp_async4(smem_addr(&s_rows[k % kRowSlots][t]), in ? rrow + i : rrow, in ? 4 : 0);
  };
  // groups 0 .. kLead - 1: the payload's first words and the rows of
  // chunks 0 .. kLead - 1; chunk c starts group kLead + c (the rows of chunk
  // c + kLead), so chunk c's rows and words are in groups <= c
  ring.loaded = ptr;
  ring_refill<NT>(ring, ptr, pay, W);
#pragma unroll
  for (int k = 0; k < kLead; ++k) {
    copy_row(k);
    cp_async_commit();
  }

  if constexpr (!kGlobal) {
    for (int i = t; i < nrows * row_len; i += NT) s_cdf[i] = cdf[i];
    for (int i = t; i < nrows; i += NT) s_off[i] = offsets[i];
    for (int i = t; i < nrows * kIdxLen; i += NT) s_idx[i] = slot_idx[i];
  }
  // s_needs[cnt - 1][nbits - 17]: which of the escape phases 0..cnt need a
  // word, for a state of bit length nbits after the main phase
  for (int i = t; i < 8 * 16; i += NT) {
    const int cnt = i / 16 + 1;
    int nbits = i % 16 + 17;
    uint32_t needs = 0;
    for (int p = 0; p <= cnt; ++p) {
      nbits -= 4;
      if (nbits <= 16) {
        needs |= 1u << p;
        nbits += 16;
      }
    }
    s_needs[i] = static_cast<uint16_t>(needs);
  }
  __syncthreads();
  const int nsyms = row_len - 2;  // value slots; slot nsyms = escape
  int par_main = 0, par_esc = 0;

  for (int c = 0, c0 = 0; c0 < s_tot; ++c, c0 += L) {
    const int idx = c0 + t;
    const bool valid = live && idx < s_tot;

    // start group kLead + c; wait for group c (this chunk's rows and the
    // words up to ptr + 10 L): the exchange's barrier shows every thread's
    // words to every other
    ring_refill<NT>(ring, ptr, pay, W);
    copy_row(c + kLead);
    cp_async_commit();
    cp_async_wait_lead();
    const int row = min(max(s_rows[c % kRowSlots][t], 0), nrows - 1);

    // slot = #{j : cdf[j] <= cum} - 1 lies between lo and hi, the slots of
    // the first cum of cum's bucket and of the next bucket's.  Two guesses,
    // tested at once: up from lo and down from hi as if every slot between
    // had frequency 1 (exact in the Gaussian tails, where most do; the
    // clamps make them lo or hi where one wide slot covers the bucket).
    // Only a lane whose guesses both miss searches [lo, hi].
    const int32_t* crow = t_cdf + row * row_len;
    const int cum = static_cast<int>(state & 0xFFFFu);
    const uint32_t* irow = t_idx + row * kIdxLen + (cum >> kBucketBits);
    const uint32_t e0 = tload<kGlobal>(irow), e1 = tload<kGlobal>(irow + 1);
    int lo = static_cast<int>(e0 & 0xFFu), hi = static_cast<int>(e1 & 0xFFu);
    const int up = min(hi, lo + (cum - static_cast<int>(e0 >> 8)));
    const int down = min(max(hi - (static_cast<int>(e1 >> 8) - cum), lo), hi);
    int c_up = tload<kGlobal>(crow + up), c_up1 = tload<kGlobal>(crow + up + 1);
    int c_dn = tload<kGlobal>(crow + down), c_dn1 = tload<kGlobal>(crow + down + 1);
    int slot;
    if (c_up <= cum && cum < c_up1) {
      slot = up;
    } else if (c_dn <= cum && cum < c_dn1) {
      slot = down;
      c_up = c_dn;
      c_up1 = c_dn1;
    } else {
      // what the guesses' loads showed narrows [lo, hi]
      if (c_up > cum) hi = up - 1; else lo = max(lo, up + 1);
      if (c_dn1 <= cum) lo = max(lo, down + 1); else hi = min(hi, down - (c_dn > cum));
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tload<kGlobal>(crow + mid) <= cum) lo = mid; else hi = mid - 1;
      }
      slot = lo;
      c_up = tload<kGlobal>(crow + slot);
      c_up1 = tload<kGlobal>(crow + slot + 1);
    }
    const uint32_t start = static_cast<uint32_t>(c_up);
    const uint32_t freq = static_cast<uint32_t>(c_up1) - start;
    if (valid) state = freq * (state >> 16) + (static_cast<uint32_t>(cum) - start);
    const bool esc = valid && slot == nsyms;

    // exchange 1: the main phase's ranks and whether the chunk escapes
    const bool need = valid && state < 65536u;
    const unsigned m_need = __ballot_sync(0xffffffffu, need);
    const unsigned m_esc = __ballot_sync(0xffffffffu, esc);
    if (lane == 0) s_main[par_main][warp] = __popc(m_need) | (m_esc ? 1 << 16 : 0);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int v = s_main[par_main][w];
      before += w < warp ? v & 0xFFFF : 0;
      total += v;
    }
    par_main ^= 1;
    if (need) {
      const int wi = ptr + before + __popc(m_need & lt);
      state = (state << 16) | static_cast<uint32_t>(ring.buf[wi & ring.mask]);
    }
    ptr += total & 0xFFFF;

    const int off = tload<kGlobal>(t_off + row);
    uint32_t value = static_cast<uint32_t>(slot + off);
    if (total >> 16) {
      // exchange 2: the ranks of every escape phase at once.  Phase 0 reads
      // the count nibble, phases 1..cnt the value nibbles; phase p needs a
      // word iff the state's bit length, less 4, is <= 16 after the phases
      // before it (each need adds 16 bits).
      const bool exact = !esc || state >= 65536u;
      uint32_t cnt = 0, needs = 0;
      if (esc && exact) {
        cnt = min((state & 15u) + 1u, 8u);
        needs = s_needs[(cnt - 1) * 16 + (15 - __clz(static_cast<int>(state)))];
      }
      unsigned bal[kEscPhases];
      uint32_t packed[5] = {0, 0, 0, 0, 0};
#pragma unroll
      for (int p = 0; p < kEscPhases; ++p) {
        bal[p] = __ballot_sync(0xffffffffu, (needs >> p) & 1u);
        packed[p >> 1] |= static_cast<uint32_t>(__popc(bal[p])) << (16 * (p & 1));
      }
      const unsigned m_fb = __ballot_sync(0xffffffffu, !exact);
      if (lane == 0) {
        uint32_t* dst = s_esc[par_esc][warp];
        *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[4] = packed[4] | (m_fb ? 1u << 16 : 0u);
      }
      __syncthreads();
      uint32_t pre[5] = {0, 0, 0, 0, 0}, tot[5] = {0, 0, 0, 0, 0};
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t* src = s_esc[par_esc][w];
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        const uint32_t vs[5] = {v.x, v.y, v.z, v.w, src[4]};
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          // 16-bit fields cannot carry: every field sums to <= L <= 256,
          // and the flags of word 4 to <= NW << 16
          tot[q] += vs[q];
          pre[q] += w < warp ? vs[q] : 0u;
        }
      }
      par_esc ^= 1;
      if ((tot[4] >> 16) == 0) {
        // each lane walks its own phases on words it already knows
        int base = ptr;
        uint32_t word[kEscPhases];
#pragma unroll
        for (int p = 0; p < kEscPhases; ++p) {
          const int sh = 16 * (p & 1);
          const int wi = base + static_cast<int>((pre[p >> 1] >> sh) & 0xFFFFu) +
                         __popc(bal[p] & lt);
          word[p] = (needs >> p) & 1u ? static_cast<uint32_t>(ring.buf[wi & ring.mask]) : 0u;
          base += static_cast<int>((tot[p >> 1] >> sh) & 0xFFFFu);
        }
        ptr = base;
        if (esc) {
          state >>= 4;
          if (needs & 1u) state = (state << 16) | word[0];
          uint32_t u = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (static_cast<uint32_t>(k) < cnt) {
              const uint32_t d = state & 15u;
              state >>= 4;
              if ((needs >> (k + 1)) & 1u) state = (state << 16) | word[k + 1];
              u = (u << 4) | d;
            }
          }
          // unzigzag with a logical shift; wrap-around sums as int32 in JAX
          const uint32_t delta = (u >> 1) ^ (0u - (u & 1u));
          const uint32_t base_v = static_cast<int32_t>(delta) < 0 ? 0u : nsyms - 1;
          value = base_v + delta + static_cast<uint32_t>(off);
        }
      } else {
        // the phase-by-phase path: a count phase, then the value phases up
        // to the block's largest count
        const uint32_t cntv = (esc ? (state & 15u) : 0u) + 1u;
        if (esc) state >>= 4;
        state = window_renorm<NW>(state, esc && state < 65536u, ptr, ring, s_fb);
        if (t == 0) s_fb_kmax = 0;
        __syncthreads();
        if (esc) atomicMax(&s_fb_kmax, static_cast<int>(min(cntv, 8u)));
        __syncthreads();
        const uint32_t kmax = static_cast<uint32_t>(s_fb_kmax);
        uint32_t u = 0;
        for (uint32_t k = 0; k < kmax; ++k) {
          const bool active = esc && k < cntv;
          const uint32_t d = state & 15u;
          if (active) state >>= 4;
          state = window_renorm<NW>(state, active && state < 65536u, ptr, ring, s_fb);
          if (active) u = (u << 4) | d;
        }
        const uint32_t delta = (u >> 1) ^ (0u - (u & 1u));
        const uint32_t base_v = static_cast<int32_t>(delta) < 0 ? 0u : nsyms - 1;
        if (esc) value = base_v + delta + static_cast<uint32_t>(off);
      }
    }
    if (valid) orow[idx] = static_cast<int32_t>(value);
  }
  cp_async_wait_all();
  if (live) state_io[static_cast<size_t>(b) * L + t] = state;
  if (t == 0) ptr_io[b] = ptr;
}

// Shared memory of one CTA: the payload ring and, on the shared route, the
// CDF table, the row offsets and the coarse slot index.  The ring holds the
// words a slow thread may still read (10 L behind the pointer), the words
// ahead of the pointer and one more segment of 4 NT: rlen >= 10 L +
// 10 L kLead + 4 NT.
size_t drain_smem(int L, int nt, int nrows, int row_len, bool global, int* rlen) {
  int r = 1;
  while (r < (10 + 10 * kLead) * L + 4 * nt) r <<= 1;
  *rlen = r;
  size_t words = static_cast<size_t>(r);
  if (!global)
    words += static_cast<size_t>(nrows) * (row_len + 1) + static_cast<size_t>(nrows) * kIdxLen;
  return words * sizeof(int32_t);
}

// The shared memory a CTA may take on sm_90 (227 KB), static and dynamic.
constexpr size_t kSmemPerBlock = 232448;

// The kernel's static shared arrays at nt threads (NW = nt / 32): s_main,
// s_esc, s_fb, s_fb_kmax, s_rows, s_needs.
size_t static_smem(int nt) {
  const size_t nw = static_cast<size_t>(nt) / 32;
  return (2 * nw + 2 * nw * 8 + nw + 1 + static_cast<size_t>(kRowSlots) * nt) * 4 + 8 * 16 * 2;
}

// 0: the table in shared memory, 1: in device memory; by whether the table
// fits beside the ring and the static arrays (the 64-row table does at
// L <= 128, not at 256; the 1,024-row table never does).
int table_route(int L, int nrows, int row_len) {
  int rlen = 0;
  const int nt = L < 32 ? 32 : L;
  return drain_smem(L, nt, nrows, row_len, false, &rlen) + static_smem(nt) <= kSmemPerBlock
             ? 0 : 1;
}

template <int NW, bool kGlobal>
int launch(const void* rows, const void* payload, void* state, void* ptr, void* out,
           const void* cdf, const void* offsets, const void* slot_idx, int B, int S, int s_tot,
           int W, int L, int nrows, int row_len, cudaStream_t stream) {
  int rlen = 0;
  const size_t smem = drain_smem(L, 32 * NW, nrows, row_len, kGlobal, &rlen);
  const cudaError_t e = cudaFuncSetAttribute(
      rans_drain_kernel<NW, kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_drain_kernel<NW, kGlobal><<<B, 32 * NW, smem, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(payload),
      static_cast<uint32_t*>(state), static_cast<int32_t*>(ptr), static_cast<int32_t*>(out),
      static_cast<const int32_t*>(cdf), static_cast<const int32_t*>(offsets),
      static_cast<const uint32_t*>(slot_idx), S, s_tot, W, L, nrows, row_len, rlen);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGlobal>
int launch_lanes(const void* rows, const void* payload, void* state, void* ptr, void* out,
                 const void* cdf, const void* offsets, const void* slot_idx, int B, int S,
                 int s_tot, int W, int L, int nrows, int row_len, cudaStream_t stream) {
#define RANS_DRAIN_LAUNCH(NW)                                                                   \
  launch<NW, kGlobal>(rows, payload, state, ptr, out, cdf, offsets, slot_idx, B, S, s_tot, W, \
                      L, nrows, row_len, stream)
  switch (L) {
    case 8: case 16: case 32: return RANS_DRAIN_LAUNCH(1);
    case 64: return RANS_DRAIN_LAUNCH(2);
    case 128: return RANS_DRAIN_LAUNCH(4);
    case 256: return RANS_DRAIN_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RANS_DRAIN_LAUNCH
}

bool takes(int L, int nrows, int row_len) {
  const bool lanes = L == 8 || L == 16 || L == 32 || L == 64 || L == 128 || L == 256;
  return lanes && row_len >= 3 && row_len <= 256 && nrows > 0;
}

}  // namespace

// Which route a shape takes: 0 the table in shared memory, 1 in device
// memory, -1 a shape the kernel does not take.  The wrapper asks once per
// coder and passes the answer to every launch.
extern "C" int rans_drain_route(int L, int nrows, int row_len) {
  return takes(L, nrows, row_len) ? table_route(L, nrows, row_len) : -1;
}

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// shape it does not take: L in {8, 16, 32, 64, 128, 256} lanes, rows of at
// most 256 entries (the slot index holds a byte), `route` 0 or 1, as
// rans_drain_route gives it (route 0 on a table too large for shared
// memory fails in cudaFuncSetAttribute).
extern "C" int rans_drain_launch(
    const void* rows, const void* payload, void* state, void* ptr, void* out,
    const void* cdf, const void* offsets, const void* slot_idx, int B, int S,
    int s_tot, int W, int L, int nrows, int row_len, int route, void* stream) {
  if (!takes(L, nrows, row_len) || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0)
    return launch_lanes<false>(rows, payload, state, ptr, out, cdf, offsets, slot_idx, B, S,
                               s_tot, W, L, nrows, row_len, st);
  return launch_lanes<true>(rows, payload, state, ptr, out, cdf, offsets, slot_idx, B, S,
                            s_tot, W, L, nrows, row_len, st);
}
