// Kernel B1: the interleaved rANS16 drain, for sm_90a.
//
// Replaces lic_tpu/coding/pallas_rans.py::pallas_drain (_build_drain.run ->
// _drain_kernel).  It computes what DeviceRans16Interleaved._decode_chunk_live
// computes (lic_tpu/coding/device_rans.py:441-501), chunk after chunk, bit
// for bit: per chunk of L symbols, the CDF-row slot search, the state update,
// the shared-pointer window renorm (the k-th lane needing a word takes word
// ptr + k) and, only when a lane of the chunk escapes, the 4-bit-nibble
// bypass path.  Its plain PyTorch version is
// lic_tpu_torch/coding/device_rans.py::drain_plain.
//
// What bounds it on this card: latency, not bytes or operations.  The
// chunks of one stream form a serial chain (each chunk's renorm consumes
// words at the pointer the previous chunk left), so a stream is one CTA
// walking its chunks, and a batch of B streams fills only B of the 132 SMs.
// Each chunk costs a binary search in shared memory, a block-wide rank
// exchange and one dependent load from the payload.
//
// What the design does about it:
//  * one CTA per stream, one thread per lane (L = 128: four warps); the lane
//    state lives in a register as uint32 and the shared pointer in a
//    register of every thread;
//  * the CDF table (64 x 131 int32, about 33 KB) and the row offsets are
//    copied once into shared memory, so the slot search never leaves the SM;
//  * renorm ranks come from __ballot_sync / __popc within each warp plus a
//    prefix over the four warps' counts in shared memory;
//  * the escape path runs only when __syncthreads_or says a lane escaped;
//  * (state, ptr) go in and out through device memory, so the per-slice
//    launches of one decode thread the state.
// The TPU kernel's one-hot fp32 matmuls, byte-split selects, aligned window
// supersets, sublane padding and segment budget have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;

// One interleaved renorm phase: every thread of the block calls it.  Lanes
// with `need` take consecutive words from the shared pointer in lane order.
// A word past the payload's end reads as 0 (only a corrupt stream gets
// there; valid streams end >= L zero words before it).
__device__ __forceinline__ uint32_t window_renorm(
    uint32_t state, bool need, int& ptr, const int32_t* __restrict__ pay,
    int W, int* s_cnt, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, need);
  if (lane == 0) s_cnt[warp] = __popc(mask);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = s_cnt[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();  // s_cnt is rewritten by the next phase
  if (need) {
    const int idx = ptr + before + __popc(mask & ((1u << lane) - 1u));
    const uint32_t word = idx < W ? static_cast<uint32_t>(pay[idx]) : 0u;
    state = (state << 16) | word;
  }
  ptr += total;
  return state;
}

__global__ void rans_drain_kernel(
    const int32_t* __restrict__ rows,     // (B, S) CDF row per symbol
    const int32_t* __restrict__ payload,  // (B, W) zero-extended words
    uint32_t* __restrict__ state_io,      // (B, L) lane states, in/out
    int32_t* __restrict__ ptr_io,         // (B,) shared pointers, in/out
    int32_t* __restrict__ out,            // (B, S) decoded values
    const int32_t* __restrict__ cdf,      // (nrows, row_len)
    const int32_t* __restrict__ offsets,  // (nrows,)
    int S, int s_tot, int W, int nrows, int row_len) {
  extern __shared__ int32_t smem[];
  __shared__ int s_cnt[kMaxWarps];
  int32_t* s_cdf = smem;
  int32_t* s_off = smem + nrows * row_len;

  const int L = blockDim.x;
  const int nwarps = L >> 5;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  for (int i = t; i < nrows * row_len; i += L) s_cdf[i] = cdf[i];
  for (int i = t; i < nrows; i += L) s_off[i] = offsets[i];
  __syncthreads();

  const int32_t* pay = payload + static_cast<size_t>(b) * W;
  const int32_t* rrow = rows + static_cast<size_t>(b) * S;
  int32_t* orow = out + static_cast<size_t>(b) * S;
  uint32_t state = state_io[static_cast<size_t>(b) * L + t];
  int ptr = ptr_io[b];
  const int nsyms = row_len - 2;  // value slots; slot nsyms = escape

  for (int c0 = 0; c0 < s_tot; c0 += L) {
    const int idx = c0 + t;
    const bool valid = idx < s_tot;
    const int row = min(max(valid ? rrow[idx] : 0, 0), nrows - 1);
    const int32_t* crow = s_cdf + row * row_len;
    const int cum = static_cast<int>(state & 0xFFFFu);

    // slot = #{j : cdf[j] <= cum} - 1 (the CDF ascends: a binary search)
    int lo = 0, hi = row_len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (crow[mid] <= cum) lo = mid + 1; else hi = mid;
    }
    const int slot = min(lo - 1, nsyms);
    const uint32_t start = static_cast<uint32_t>(crow[slot]);
    const uint32_t freq = static_cast<uint32_t>(crow[slot + 1]) - start;
    if (valid) state = freq * (state >> 16) + (static_cast<uint32_t>(cum) - start);
    state = window_renorm(state, valid && state < 65536u, ptr, pay, W, s_cnt,
                          nwarps);

    const bool esc = valid && slot == nsyms;
    const int off = s_off[row];
    uint32_t value = static_cast<uint32_t>(slot + off);
    if (__syncthreads_or(esc)) {
      // count nibble, then up to 8 value nibbles, each a renorm phase
      const uint32_t cnt = (esc ? (state & 15u) : 0u) + 1u;
      if (esc) state >>= 4;
      state = window_renorm(state, esc && state < 65536u, ptr, pay, W, s_cnt,
                            nwarps);
      uint32_t u = 0;
      for (uint32_t k = 0; k < 8; ++k) {
        const bool active = esc && k < cnt;
        const uint32_t d = state & 15u;
        if (active) state >>= 4;
        state = window_renorm(state, active && state < 65536u, ptr, pay, W,
                              s_cnt, nwarps);
        if (active) u = (u << 4) | d;
      }
      // unzigzag with a logical shift; wrap-around sums as int32 in JAX
      const uint32_t delta = (u >> 1) ^ (0u - (u & 1u));
      const uint32_t base = static_cast<int32_t>(delta) < 0 ? 0u : nsyms - 1;
      if (esc) value = base + delta + static_cast<uint32_t>(off);
    }
    if (valid) orow[idx] = static_cast<int32_t>(value);
  }
  state_io[static_cast<size_t>(b) * L + t] = state;
  if (t == 0) ptr_io[b] = ptr;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).  L must be a multiple of 32 and
// at most 1024; the wrapper checks shapes before it calls.
extern "C" int rans_drain_launch(
    const void* rows, const void* payload, void* state, void* ptr, void* out,
    const void* cdf, const void* offsets, int B, int S, int s_tot, int W,
    int L, int nrows, int row_len, void* stream) {
  const size_t smem =
      static_cast<size_t>(nrows) * (row_len + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rans_drain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rans_drain_kernel<<<B, L, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(payload),
      static_cast<uint32_t*>(state), static_cast<int32_t*>(ptr),
      static_cast<int32_t*>(out), static_cast<const int32_t*>(cdf),
      static_cast<const int32_t*>(offsets), S, s_tot, W, nrows, row_len);
  return static_cast<int>(cudaGetLastError());
}
