// Kernels B3 and B6: direct k x k convolution on NHWC fp32, for sm_90a.
//
// Replaces
//   B3  lic_tpu/layers/pallas_conv.py::conv5s2_pallas (_conv5s2_kernel) and
//       conv5s2_pallas_v2 (_conv5s2_v2_kernel): ZeroPad2d(1,2,1,2) + 5x5
//       stride-2 conv; the v2 variant computes the same function;
//   B6  lic_tpu/layers/pallas_conv_s1.py::convk_s1_pallas (_convk_s1_kernel):
//       stride-1 "same" k x k conv with the bias + LeakyReLU(0.01) + residual
//       epilogue of ResidualBlock.
// Both are one launch of conv_direct_kernel; the TPU tricks (polyphase
// pre-split, 128-lane K-remainder packing) are not ported.
//
// What it computes: an implicit GEMM.  M = B*Ho*Wo output pixels, N = C_out,
// K = k*k*C_in.  The A operand is gathered from the input on the fly (the
// zero padding, symmetric or asymmetric, is a bounds test on the load), the B
// operand is the HWIO weight.  Accumulation is fp32 on the CUDA cores: no
// TF32, since the port holds fp32 parity at 1e-5.
//
// What bounds it on an H100: operations.  A 3x3 C=192 conv at 128x192, B=8,
// is 130.5 GFLOP against 0.3 GB of activations: ~430 FLOP per byte, far
// above the fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte).
//
// Design (CUDA cores; wgmma/TMA come later): a CTA of 128 threads owns a
// 128-pixel x 64-channel output tile and walks the (tap, 16-channel chunk)
// steps.  Each step stages the gathered input tile (16 x 128) and the weight
// tile (16 x 64) in shared memory, and each thread accumulates an 8 x 8
// register micro-tile from float4 shared-memory reads.  The tiles are double
// buffered: the next step's global loads are held in registers while the
// current step computes, then stored to the other buffer (one barrier per
// step).  The gather's addresses come from a per-tap offset table in shared
// memory (one entry per pixel, -1 where the tap falls in the padding), built
// one tap ahead, so the inner loads do no index arithmetic.
//
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;          // output pixels per CTA
constexpr int BN = 64;           // output channels per CTA
constexpr int BK = 16;           // input channels per step
constexpr int TM = 8, TN = 8;    // per-thread micro-tile
constexpr int NT = 128;          // threads: (BM / TM) * (BN / TN) = BM
constexpr int A_LD = BM + 4;     // +4 keeps rows 16-byte aligned
constexpr int B_LD = BN + 4;
constexpr int A_PER = BM * BK / NT;  // gathered input values per thread
constexpr int B_PER = BK * BN / NT;  // weight values per thread

__global__ void __launch_bounds__(NT) conv_direct_kernel(
    const float* __restrict__ x,      // (B, H, W, cin)
    const float* __restrict__ w,      // (k, k, cin, cout)
    const float* __restrict__ bias,   // (cout,) or null
    const float* __restrict__ res,    // (B, Ho, Wo, cout) or null
    float* __restrict__ y,            // (B, Ho, Wo, cout)
    int H, int W, int cin, int Ho, int Wo, int cout, int M,
    int k, int stride, int pad_t, int pad_l, int leaky) {
  __shared__ __align__(16) float As[2][BK][A_LD];
  __shared__ __align__(16) float Bs[2][BK][B_LD];
  __shared__ int s_off[2][BM];  // per tap: offset of the pixel's channel 0, or -1

  const int tid = threadIdx.x;
  const int m_blk = blockIdx.x * BM;
  const int n_blk = blockIdx.y * BN;

  // this thread's pixel of the offset table (NT == BM)
  int img = -1, ih0 = 0, iw0 = 0;
  {
    const int m = m_blk + tid;
    if (m < M) {
      const int b = m / (Ho * Wo);
      const int r = m - b * Ho * Wo;
      const int oh = r / Wo;
      img = b * H * W;
      ih0 = oh * stride - pad_t;
      iw0 = (r - oh * Wo) * stride - pad_l;
    }
  }
  auto offsets = [&](int tap, int buf) {
    const int ih = ih0 + tap / k, iw = iw0 + tap % k;
    s_off[buf][tid] = (img >= 0 && ih >= 0 && ih < H && iw >= 0 && iw < W)
                          ? (img + ih * W + iw) * cin : -1;
  };

  const int tm = tid / (BN / TN);  // micro-tile row block
  const int tn = tid % (BN / TN);  // micro-tile column block
  const int a_c = tid % BK;        // A loader: one channel, pixels a_p0 + 8 i
  const int a_p0 = tid / BK;
  const int b_n = tid % BN;        // B loader: one column, channels b_c0 + 2 i
  const int b_c0 = tid / BN;
  const int n_load = n_blk + b_n;
  const int nchunk = (cin + BK - 1) / BK;
  const int steps = k * k * nchunk;

  float a_reg[A_PER], b_reg[B_PER];
  auto load = [&](int step) {
    const int tap = step / nchunk;
    const int c0 = (step - tap * nchunk) * BK;
    const int* off = s_off[tap & 1];
    const int c = c0 + a_c;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int o = off[a_p0 + i * (NT / BK)];
      a_reg[i] = (o >= 0 && c < cin) ? x[o + c] : 0.f;
    }
    const float* wt = w + ((size_t)tap * cin + c0) * cout + n_load;
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int cc = b_c0 + i * (NT / BN);
      b_reg[i] = (c0 + cc < cin && n_load < cout) ? wt[(size_t)cc * cout] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[buf][a_c][a_p0 + i * (NT / BK)] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) Bs[buf][b_c0 + i * (NT / BN)][b_n] = b_reg[i];
  };

  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

  offsets(0, 0);
  __syncthreads();
  load(0);
  store(0);
  if (k * k > 1) offsets(1, 1);
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) load(step + 1);  // in flight while this step computes
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][tm * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][tm * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tn * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tn * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    const int tap = step / nchunk;
    if (step - tap * nchunk == nchunk - 1) {  // the tap's last chunk
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
    if (more) {
      store(buf ^ 1);
      // the next step opens a new tap: every load of the tap before it is
      // done, so its table slot takes the tap after
      const int next_tap = (step + 1) / nchunk;
      if (next_tap != tap && next_tap + 1 < k * k) offsets(next_tap + 1, (next_tap + 1) & 1);
    }
    __syncthreads();
  }

  // epilogue: + bias, LeakyReLU(0.01), + residual -- the order of
  // _convk_s1_kernel (pallas_conv_s1.py:122-132)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m_blk + tm * TM + i;
    if (m >= M) continue;
    const size_t row = (size_t)m * cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n_blk + tn * TN + j;
      if (n >= cout) continue;
      float v = acc[i][j];
      if (bias) v += bias[n];
      if (leaky) v = v >= 0.f ? v : 0.01f * v;
      if (res) v += res[row + n];
      y[row + n] = v;
    }
  }
}

}  // namespace

extern "C" int conv_direct_launch(
    const float* x, const float* w, const float* bias, const float* res, float* y,
    int B, int H, int W, int cin, int Ho, int Wo, int cout,
    int k, int stride, int pad_t, int pad_l, int leaky, void* stream) {
  const long long m = (long long)B * Ho * Wo;
  // the offset table holds int offsets into x
  if (m <= 0 || (long long)B * H * W * cin > 0x7fffffffLL || cin <= 0 || cout <= 0 ||
      k <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  const int M = (int)m;
  dim3 grid((M + BM - 1) / BM, (cout + BN - 1) / BN);
  conv_direct_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, w, bias, res, y, H, W, cin, Ho, Wo, cout, M, k, stride, pad_t, pad_l, leaky);
  return (int)cudaGetLastError();
}
