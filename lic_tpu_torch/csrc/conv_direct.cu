// Kernels B3 and B6: direct k x k convolution on NHWC fp32, for sm_90a.
//
// Replaces
//   B3  lic_tpu/layers/pallas_conv.py::conv5s2_pallas (_conv5s2_kernel) and
//       conv5s2_pallas_v2 (_conv5s2_v2_kernel): ZeroPad2d(1,2,1,2) + 5x5
//       stride-2 conv; the v2 variant computes the same function;
//   B6  lic_tpu/layers/pallas_conv_s1.py::convk_s1_pallas (_convk_s1_kernel):
//       stride-1 "same" k x k conv with the bias + LeakyReLU(0.01) + residual
//       epilogue of ResidualBlock.
// Both are one launch of conv_tf32x3_kernel; the TPU tricks (polyphase
// pre-split, 128-lane K-remainder packing) are not ported.
//
// What it computes: an implicit GEMM.  M = B*Ho*Wo output pixels, N = C_out,
// K = k*k*C_in, walked as (tap, 32-channel chunk) steps.  fp32 in, fp32 out,
// held to the float64 conv at 1e-5.
//
// What bounds it on an H100: operations.  A 3x3 C=192 conv at 128x192, B=8,
// is 130.5 GFLOP against 0.3 GB of activations: ~430 FLOP per byte.  On the
// fp32 CUDA cores (67 TFLOP/s) that bound is 1.95 ms; the earlier CUDA-core
// version of this file reached ~47% of it.  The tensor cores take TF32
// (10-bit mantissa), which alone misses 1e-5 by two orders, so the kernel
// runs 3xTF32: each fp32 operand is split into hi = tf32(a) and
// lo = tf32(a - hi), and a*b is summed as hi*lo + lo*hi + hi*hi (the lo*lo
// term and the rounding of lo are ~2^-22 relative).  Its operations bound is
// therefore FLOPs / (495 / 3 TFLOP/s): 0.79 ms for that 3x3.
//
// Design.
// * A CTA owns an 8 x 24 patch of output pixels of one image (BM = 192) and
//   96 output channels (BN).  Three consumer warpgroups each own 64 pixels
//   and run wgmma.mma_async m64n96k8 .tf32 with fp32 accumulators in
//   registers; one thread of a fourth, producer warpgroup starts the TMA
//   loads.  The producer warpgroup gives its registers to the consumers
//   (setmaxnreg: 40 and 152 a thread, from 128 at launch), which need ~150
//   without spills.
//   Against a 128-pixel tile with two consumer warpgroups and one producer
//   warp, this reads a third less weight per FLOP, keeps three warpgroups on
//   the tensor cores, and fills the 132 SMs in one wave at 32 x 48 (128 CTAs
//   instead of 192): 10-40% faster on an H100, with bit-identical outputs.
// * Loads: a 4-D tensor map over the NHWC input; each (tap, chunk) step is
//   one box of 32 channels x 24 x 8 pixels whose start is the tap's shift.
//   The zero padding, symmetric or (1,2,1,2), is TMA's out-of-bounds zero
//   fill: no offset table, no bounds tests.  B3's stride 2 is the tensor
//   map's element strides (a box of 48 x 16 elements read every second one
//   in W and H lands as the same 24 x 8 patch).  The weights come prepacked
//   by the wrapper as OHWI hi and lo tensors (split once per weight, not per
//   call); two 3-D tensor maps read a 96 x 32 box of each.  All boxes are
//   128-byte swizzled; a stage (A 24 KB + B_hi + B_lo 24 KB) sits in a ring
//   of four in dynamic shared memory, with a full and an empty mbarrier each.
// * A is split in registers: each consumer thread reads its 16 values of a
//   chunk from the swizzled tile (conflict-free), cvt.rna.tf32 gives hi and
//   the rounded rest lo, and wgmma takes A from registers; B_hi and B_lo are
//   read by wgmma from shared memory.  A second shared A_lo tile would cost
//   another pass over shared memory and a barrier per stage.
// * Summation order is fixed: per K-step of 8 channels hi*lo, lo*hi, hi*hi
//   (the small products first) into a partial held by wgmma for one
//   32-channel chunk; after each chunk the partial is added into a running
//   fp32 sum on the CUDA cores.  The tensor core's fp32 accumulation
//   truncates: on an H100, the whole K (up to 9,408) summed in it landed up
//   to 4.2e-4 from float64, and a partial per tap (192 channels) up to
//   8.4e-6, too close to the 1e-5 bar.  The chunk's wait comes anyway (each
//   warpgroup waits for its wgmma before the stage is released), so the
//   finer sum costs no extra synchronisation.  No split-K, no atomics, a tile
//   shape independent of B and of the data: repeats are bit-identical and an
//   image's output does not depend on the batch it rides in.
// * Epilogue: the tile goes through shared memory and leaves as 16-byte
//   vectors (C_out % 4 == 0): + bias, LeakyReLU(0.01), + residual, the order
//   of _convk_s1_kernel (pallas_conv_s1.py:122-132).
// Limits: C_in % 4 == 0 (TMA's 16-byte stride rule; the wrapper raises
// otherwise), stride 1 or 2.
//
// cuTensorMapEncodeTiled is looked up at run time through the CUDA
// runtime's entry-point query, so the library builds with one nvcc line and
// no -lcuda.

#include "sm90.cuh"

namespace {

constexpr int TH = 8, TW = 24;          // output patch of a CTA
constexpr int BM = TH * TW;             // 192 output pixels
constexpr int BN = 96;                  // output channels
constexpr int BK = 32;                  // input channels per step: one 128-byte row
constexpr int STAGES = 4;
constexpr int NCONS = 384;              // three consumer warpgroups
constexpr int NT = NCONS + 128;         // and one producer warpgroup
constexpr int A_BYTES = BM * BK * 4;    // 24 KB
constexpr int B_BYTES = BN * BK * 4;    // 12 KB each, hi and lo
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int C_LD = BN + 8;            // epilogue tile row: conflict-free float2 stores
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment
static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
              "128-byte swizzled tiles start on 1024-byte boundaries");
static_assert(BM * C_LD * 4 <= STAGES * STAGE_BYTES, "epilogue tile fits in the ring");

__global__ void __launch_bounds__(NT, 1) conv_tf32x3_kernel(
    __grid_constant__ const CUtensorMap xmap,   // input (B, H, W, cin)
    __grid_constant__ const CUtensorMap hmap,   // weight hi (cout, k*k, cin)
    __grid_constant__ const CUtensorMap lmap,   // weight lo (cout, k*k, cin)
    const float* __restrict__ bias,             // (cout,) or null
    const float* __restrict__ res,              // (B, Ho, Wo, cout) or null
    float* __restrict__ y,                      // (B, Ho, Wo, cout)
    int Ho, int Wo, int cout, int tiles_w, int tiles_h, int n_tiles,
    int k, int stride, int pad_t, int pad_l, int nchunk, int leaky, int vec) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + STAGES * STAGE_BYTES;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;

  int bid = blockIdx.x;
  const int nt = bid % n_tiles;
  bid /= n_tiles;
  const int tw = bid % tiles_w;
  bid /= tiles_w;
  const int th = bid % tiles_h;
  const int b = bid / tiles_h;
  const int oh0 = th * TH, ow0 = tw * TW, n0 = nt * BN;
  const int steps = k * k * nchunk;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONS / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // producer: one thread keeps the ring full; its warpgroup hands its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NCONS) {
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        mbar_wait(empty0 + 8 * s, ((step / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s, dst = ring + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        const int tap = step / nchunk;
        const int c0 = (step - tap * nchunk) * BK;
        const int r = tap / k, q = tap - r * k;
        tma_load_4d(dst, &xmap, full, c0, ow0 * stride + q - pad_l, oh0 * stride + r - pad_t, b);
        tma_load_3d(dst + A_BYTES, &hmap, full, c0, tap, n0);
        tma_load_3d(dst + A_BYTES + B_BYTES, &lmap, full, c0, tap, n0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
  // consumers: warpgroup wg owns pixels 64 wg .. 64 wg + 63 of the patch
  // (pixel p is output row p / TW, column p % TW), its warp w pixels
  // 16 w + g and 16 w + g + 8 (g = lane / 4)
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int p0 = tid / 32 * 16 + g;
  // this thread's A values in a stage: (pixel p0 + 8 h, channel 8 j + t + 4 h2)
  // at byte p*128 + (((2 j + h2) ^ g) << 4) + 4 t of the swizzled tile
  uint32_t a_off[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) a_off[c] = p0 * 128 + ((c ^ g) << 4) + 4 * t;

  float acc[48], part[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = part[i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int s = step % STAGES;
    mbar_wait(full0 + 8 * s, (step / STAGES) & 1);
    const unsigned char* st = smem + s * STAGE_BYTES;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // fragment register i: row g + 8 (i & 1), column t + 4 (i >> 1)
        const float v = *(const float*)(st + a_off[2 * j + (i >> 1)] + (i & 1) * 1024);
        ahi[j][i] = tf32_rna(v);
        alo[j][i] = tf32_rna(v - __uint_as_float(ahi[j][i]));
      }
    const uint32_t bhi = ring + s * STAGE_BYTES + A_BYTES, blo = bhi + B_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // K-step j: channels 8 j .. 8 j + 7, 32 bytes into each 128-byte row;
      // the chunk's first product starts the partial afresh
      wgmma_n96(part, ahi[j], desc_sw128(blo + 32 * j), j != 0);
      wgmma_n96(part, alo[j], desc_sw128(bhi + 32 * j), 1);
      wgmma_n96(part, ahi[j], desc_sw128(bhi + 32 * j), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] += part[i];
  }

  // epilogue: the tile through shared memory (the ring is drained: every
  // load was waited for and every wgmma has completed)
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* cs = (float*)smem;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    // accumulator 4 i + e: row g + 8 (e >> 1), column 8 i + 2 t + (e & 1)
    const int col = 8 * i + 2 * t;
    *(float2*)&cs[p0 * C_LD + col] = make_float2(acc[4 * i], acc[4 * i + 1]);
    *(float2*)&cs[(p0 + 8) * C_LD + col] = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
  for (int e = tid; e < BM * (BN / 4); e += NCONS) {
    const int p = e / (BN / 4), c4 = e - p * (BN / 4);
    const int oh = oh0 + p / TW, ow = ow0 + p % TW, n = n0 + 4 * c4;
    if (oh >= Ho || ow >= Wo || n >= cout) continue;
    const size_t o = ((size_t)(b * Ho + oh) * Wo + ow) * cout + n;
    const float4 a = *(const float4*)&cs[p * C_LD + 4 * c4];
    float v[4] = {a.x, a.y, a.z, a.w};
    const int cnt = min(4, cout - n);
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    if (res) {
      if (vec) {
        const float4 rv = *(const float4*)&res[o];
        r[0] = rv.x, r[1] = rv.y, r[2] = rv.z, r[3] = rv.w;
      } else {
        for (int i = 0; i < cnt; ++i) r[i] = res[o + i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (bias && i < cnt) v[i] += bias[n + i];
      if (leaky) v[i] = v[i] >= 0.f ? v[i] : 0.01f * v[i];
      if (res) v[i] += r[i];
    }
    if (vec) {
      *(float4*)&y[o] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < cnt; ++i) y[o + i] = v[i];
    }
  }
}

}  // namespace

// y = conv(x, w) (+ bias, LeakyReLU, + res) for x (B, H, W, cin) and the
// weight's TF32 split w_hi + w_lo (cout, k, k, cin), output (B, Ho, Wo, cout);
// the input is read at (stride * o + tap - pad), zero outside.  Returns a
// CUDA error (cudaErrorInvalidValue for a shape it does not take or a tensor
// map that cuTensorMapEncodeTiled refuses).
extern "C" int conv_direct_launch(
    const float* x, const float* w_hi, const float* w_lo, const float* bias, const float* res,
    float* y, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k, int stride,
    int pad_t, int pad_l, int leaky, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || cin <= 0 || cin % 4 || cout <= 0 ||
      k <= 0 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, hm, lm;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {(cuuint64_t)cin * 4, (cuuint64_t)W * cin * 4,
                              (cuuint64_t)H * W * cin * 4};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)(TW * stride), (cuuint32_t)(TH * stride), 1};
  const cuuint32_t xel[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)cin, (cuuint64_t)k * k, (cuuint64_t)cout};
  const cuuint64_t wstr[2] = {(cuuint64_t)cin * 4, (cuuint64_t)k * k * cin * 4};
  const cuuint32_t wbox[3] = {BK, 1, BN};
  const cuuint32_t wel[3] = {1, 1, 1};
  if (!encode(&xm, x, 4, xdims, xstr, xbox, xel) || !encode(&hm, w_hi, 3, wdims, wstr, wbox, wel) ||
      !encode(&lm, w_lo, 3, wdims, wstr, wbox, wel))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(conv_tf32x3_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  const int tiles_w = (Wo + TW - 1) / TW, tiles_h = (Ho + TH - 1) / TH;
  const int n_tiles = (cout + BN - 1) / BN;
  const long long grid = (long long)n_tiles * tiles_w * tiles_h * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = cout % 4 == 0 && (uintptr_t)y % 16 == 0 && (uintptr_t)res % 16 == 0;
  conv_tf32x3_kernel<<<(unsigned)grid, NT, SMEM, (cudaStream_t)stream>>>(
      xm, hm, lm, bias, res, y, Ho, Wo, cout, tiles_w, tiles_h, n_tiles, k, stride, pad_t, pad_l,
      (cin + BK - 1) / BK, leaky, vec);
  return (int)cudaGetLastError();
}

// shared memory per CTA and CTAs resident per SM, from the card's
// occupancy calculator
extern "C" int conv_direct_occupancy(int* smem_bytes, int* ctas_per_sm) {
  int err = (int)cudaFuncSetAttribute(conv_tf32x3_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  *smem_bytes = SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, conv_tf32x3_kernel, NT,
                                                            SMEM);
}
