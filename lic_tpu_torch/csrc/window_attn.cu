// Kernels B4 and B5: Swin window attention (W-MSA) on NHWC fp32, for sm_90a.
//
// Replaces
//   B4  lic_tpu/layers/pallas_attn.py::window_attention_fused (_wba_kernel,
//       body _attend_window): qkv (B, Hp, Wp, 3C) -> (B, Hp, Wp, C), for each
//       ws x ws window and head softmax(q k^T hd^-1/2 + rel-pos bias + mask) v;
//   B5  pallas_attn.py::window_attention_fused_proj (_wba_proj_kernel): the
//       same with the qkv Dense (C -> 3C) and the output Dense (C -> C)
//       computed inside the kernel: x (B, Hp, Wp, C) -> (B, Hp, Wp, C).
// The windowing happens inside: a window's tokens are read straight from the
// padded, rolled map.  The TPU tricks (block-diagonal head masks, 0/1
// segment-sum matmuls, the head-broadcast mask) are not ported: a CTA
// computes one head's n x n logits directly, with a per-row max.
//
// What bounds them on an H100: at ws 8 (n = 64, hd = 24) B4 reads 3C and
// writes C floats per token and does 4 n hd FLOP per token and head: ~1.5
// FLOP per byte, so bytes bound it (its logits never leave shared memory).
// B5 adds 2 C (3C + C) FLOP per token for the two projections: ~400 FLOP per
// byte, so operations bound it.
//
// Design (simple first): B4 runs one CTA of 128 threads per (window, head)
// with q, k, v of that head (n x hd) and the n x n logits in shared memory.
// B5 runs one CTA of 256 threads per window: x (n x C) and the whole qkv
// (n x 3C) sit in shared memory (213 KB at n = 64, C = 192, hence dynamic
// shared memory), the heads run one after another, their outputs overwrite
// x, and the output projection streams W_proj from L2.  W_qkv (C x 3C,
// 442 KB) does not fit shared memory; it streams from L2 one 64-column block
// at a time, each thread reading one column and accumulating n/4 rows.
//
// The shift/pad mask is additive (-100, not -inf, as the reference's) and
// the softmax takes each head's own row max, so no head's row underflows.
// Every sum runs in one fixed order (serial over the contraction, warp
// shuffles in a fixed tree), independent of batch size and launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Offset (in pixels) of token t of window wi of image b.
__device__ __forceinline__ size_t token_pixel(int b, int wi, int t, int Hp, int Wp, int ws) {
  const int nww = Wp / ws;
  const int y = (wi / nww) * ws + t / ws;
  const int x = (wi % nww) * ws + t % ws;
  return ((size_t)b * Hp + y) * Wp + x;
}

// One head of one window, all operands in shared memory.  q (already
// scaled), k, v: n x hd with row strides qs, ks, vs; P: n x (n + 1) scratch.
// rel: this head's (n, n) bias; mask: this window's (n, n) mask or null.
// Writes the n x hd output to o (row stride os), which may alias q.
template <int N, int NT>
__device__ void attend_head(const float* q, int qs, const float* k, int ks,
                            const float* v, int vs, float* P,
                            const float* __restrict__ rel,
                            const float* __restrict__ mask, int hd, float* o,
                            int os) {
  constexpr int PLD = N + 1;
  const int tid = threadIdx.x;
  for (int e = tid; e < N * N; e += NT) {
    const int i = e / N, j = e % N;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(q[i * qs + d], k[j * ks + d], s);
    s += rel[e];
    if (mask) s += mask[e];
    P[i * PLD + j] = s;
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < N; i += NT / 32) {
    float* row = P + i * PLD;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < N; j += 32) row[j] = row[j] / s;
  }
  __syncthreads();
  for (int e = tid; e < N * hd; e += NT) {
    const int i = e / hd, d = e % hd;
    float acc = 0.f;
    for (int j = 0; j < N; ++j) acc = fmaf(P[i * PLD + j], v[j * vs + d], acc);
    o[i * os + d] = acc;
  }
  __syncthreads();
}

// B4: grid (B * nW, nh), 128 threads.
template <int N>
__global__ void __launch_bounds__(128) wba_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rel,
    const float* __restrict__ mask, float* __restrict__ out, int Hp, int Wp,
    int C, int nh, int ws, float scale) {
  constexpr int NT = 128;
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh;
  const int nW = (Hp / ws) * (Wp / ws);
  const int b = blockIdx.x / nW, wi = blockIdx.x % nW, h = blockIdx.y;
  float* q = smem;                 // N x hd, later the output
  float* k = q + N * hd;           // N x (hd + 1)
  float* v = k + N * (hd + 1);     // N x hd
  float* P = v + N * hd;           // N x (N + 1)
  for (int e = threadIdx.x; e < N * hd; e += NT) {
    const int t = e / hd, d = e % hd;
    const float* src = qkv + token_pixel(b, wi, t, Hp, Wp, ws) * 3 * C + h * hd + d;
    q[t * hd + d] = src[0] * scale;
    k[t * (hd + 1) + d] = src[C];
    v[t * hd + d] = src[2 * C];
  }
  __syncthreads();
  attend_head<N, NT>(q, hd, k, hd + 1, v, hd, P, rel + (size_t)h * N * N,
                     mask ? mask + (size_t)wi * N * N : nullptr, hd, q, hd);
  for (int e = threadIdx.x; e < N * hd; e += NT) {
    const int t = e / hd, d = e % hd;
    out[token_pixel(b, wi, t, Hp, Wp, ws) * C + h * hd + d] = q[t * hd + d];
  }
}

// dst[t][j] = sum_c src[t][c] * w[c][j] + bias[j] for the N tokens of a
// window: src in shared memory (row stride C), w (C x ncol) in global memory.
// 256 threads: each owns one column of a 64-column block and N / 4 rows;
// the warp reads one shared row (a broadcast) and 32 neighbouring columns.
template <int N>
__device__ void window_dense(const float* src, int C, const float* __restrict__ w,
                             const float* __restrict__ bias, int ncol,
                             float* dst, int dld, float* gdst, int b, int wi,
                             int Hp, int Wp, int ws) {
  constexpr int R = N / 4;
  const int jl = threadIdx.x % 64, g = threadIdx.x / 64;
  for (int j0 = 0; j0 < ncol; j0 += 64) {
    const int j = j0 + jl;
    if (j < ncol) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float wv = __ldg(w + (size_t)c * ncol + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(src[(g * R + r) * C + c], wv, acc[r]);
      }
      const float bj = bias[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = g * R + r;
        if (gdst)
          gdst[token_pixel(b, wi, t, Hp, Wp, ws) * ncol + j] = acc[r] + bj;
        else
          dst[t * dld + j] = acc[r] + bj;
      }
    }
  }
}

// B5: grid (B * nW), 256 threads, dynamic shared memory.
template <int N>
__global__ void __launch_bounds__(256) wba_proj_kernel(
    const float* __restrict__ x, const float* __restrict__ rel,
    const float* __restrict__ mask, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ wproj,
    const float* __restrict__ bproj, float* __restrict__ out, int Hp, int Wp,
    int C, int nh, int ws, float scale) {
  constexpr int NT = 256;
  extern __shared__ __align__(16) float smem[];
  const int hd = C / nh;
  const int LD = 3 * C + 1;  // odd row stride: k rows fall on distinct banks
  const int nW = (Hp / ws) * (Wp / ws);
  const int b = blockIdx.x / nW, wi = blockIdx.x % nW;
  float* xs = smem;            // N x C: the window's x, then the heads' output
  float* qkv = xs + N * C;     // N x LD
  float* P = qkv + N * LD;     // N x (N + 1)
  for (int e = threadIdx.x; e < N * C; e += NT) {
    const int t = e / C, c = e % C;
    xs[e] = x[token_pixel(b, wi, t, Hp, Wp, ws) * C + c];
  }
  __syncthreads();
  window_dense<N>(xs, C, wqkv, bqkv, 3 * C, qkv, LD, nullptr, b, wi, Hp, Wp, ws);
  __syncthreads();
  for (int e = threadIdx.x; e < N * C; e += NT) qkv[(e / C) * LD + e % C] *= scale;
  __syncthreads();
  const float* mask_w = mask ? mask + (size_t)wi * N * N : nullptr;
  for (int h = 0; h < nh; ++h)
    attend_head<N, NT>(qkv + h * hd, LD, qkv + C + h * hd, LD, qkv + 2 * C + h * hd,
                       LD, P, rel + (size_t)h * N * N, mask_w, hd, xs + h * hd, C);
  window_dense<N>(xs, C, wproj, bproj, C, nullptr, 0, out, b, wi, Hp, Wp, ws);
}

size_t wba_smem(int n, int hd) {
  return sizeof(float) * ((size_t)n * hd * 2 + (size_t)n * (hd + 1) + (size_t)n * (n + 1));
}

size_t wba_proj_smem(int n, int C) {
  return sizeof(float) * ((size_t)n * C + (size_t)n * (3 * C + 1) + (size_t)n * (n + 1));
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

bool bad_shape(int B, int Hp, int Wp, int C, int nh, int ws) {
  return B <= 0 || C <= 0 || nh <= 0 || C % nh || (ws != 4 && ws != 8) || Hp % ws ||
         Wp % ws || Hp <= 0 || Wp <= 0;
}

}  // namespace

// rel: (nh, n, n) fp32; mask: (nW, n, n) fp32 or null, nW windows per image.
extern "C" int wba_launch(const float* qkv, const float* rel, const float* mask,
                          float* out, int B, int Hp, int Wp, int C, int nh, int ws,
                          float scale, void* stream) {
  if (bad_shape(B, Hp, Wp, C, nh, ws)) return (int)cudaErrorInvalidValue;
  const int n = ws * ws;
  const size_t smem = wba_smem(n, C / nh);
  dim3 grid(B * (Hp / ws) * (Wp / ws), nh);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (ws == 8) {
    if ((err = set_smem(wba_kernel<64>, smem))) return err;
    wba_kernel<64><<<grid, 128, smem, s>>>(qkv, rel, mask, out, Hp, Wp, C, nh, ws, scale);
  } else {
    if ((err = set_smem(wba_kernel<16>, smem))) return err;
    wba_kernel<16><<<grid, 128, smem, s>>>(qkv, rel, mask, out, Hp, Wp, C, nh, ws, scale);
  }
  return (int)cudaGetLastError();
}

// wqkv: (C, 3C), wproj: (C, C), (in, out) layout; biases (3C,), (C,).
extern "C" int wba_proj_launch(const float* x, const float* rel, const float* mask,
                               const float* wqkv, const float* bqkv,
                               const float* wproj, const float* bproj, float* out,
                               int B, int Hp, int Wp, int C, int nh, int ws,
                               float scale, void* stream) {
  if (bad_shape(B, Hp, Wp, C, nh, ws)) return (int)cudaErrorInvalidValue;
  const int n = ws * ws;
  const size_t smem = wba_proj_smem(n, C);
  dim3 grid(B * (Hp / ws) * (Wp / ws));
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (ws == 8) {
    if ((err = set_smem(wba_proj_kernel<64>, smem))) return err;
    wba_proj_kernel<64><<<grid, 256, smem, s>>>(x, rel, mask, wqkv, bqkv, wproj, bproj,
                                                out, Hp, Wp, C, nh, ws, scale);
  } else {
    if ((err = set_smem(wba_proj_kernel<16>, smem))) return err;
    wba_proj_kernel<16><<<grid, 256, smem, s>>>(x, rel, mask, wqkv, bqkv, wproj, bproj,
                                                out, Hp, Wp, C, nh, ws, scale);
  }
  return (int)cudaGetLastError();
}
