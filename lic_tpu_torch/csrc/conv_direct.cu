// Kernels B3 and B6, and the Up5 deconv: direct convolutions on NHWC fp32,
// for sm_90a.
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
// Up5 (up5_tf32x3_kernel<BN>) replaces no Pallas kernel: the JAX package leaves
// g_s's ZeroPad2d(1,0,1,0) + ConvTranspose2d(5, stride 2, padding 3,
// output_padding 1) to XLA (lic_tpu/layers/conv.py:545-570,
// layers/polyphase.py).  On the card cuDNN's fp32 deconv took two thirds of
// source_net's decode; this kernel computes it on B3/B6's mainloop.
//
// What it computes: an implicit GEMM.  M = output pixels, N = C_out,
// K = taps * C_in, walked as (tap, 32-channel chunk) steps.  fp32 in, fp32
// out, held to the float64 conv at 1e-5.
//
// What bounds it on an H100: operations.  A 3x3 C=192 conv at 128x192, B=8,
// is 130.5 GFLOP against 0.3 GB of activations: ~430 FLOP per byte.  On the
// fp32 CUDA cores (67 TFLOP/s) that bound is 1.95 ms; the earlier CUDA-core
// version of this file reached ~47% of it.  The tensor cores take TF32
// (10-bit mantissa), which alone misses 1e-5 by two orders, so the kernel
// runs 3xTF32: each fp32 operand is split into hi = tf32(a) and
// lo = tf32(a - hi), and a*b is summed as hi*lo + lo*hi + hi*hi (the lo*lo
// term and the rounding of lo are ~2^-22 relative).  Its operations bound is
// therefore FLOPs / (495 / 3 TFLOP/s): 0.79 ms for that 3x3.  The Up5
// deconvs are bound the same way (g_s's up2 at B=8, 362 GFLOP: 2.2 ms; the
// last, C_out 16, 121 GFLOP: 0.73 ms), but where g_s gives RGB: C_out 3 is
// bound by reading its input (604 MB: 0.19 ms).
//
// Design.
// * A CTA owns an 8 x 24 patch of output pixels of one image (BM = 192) and
//   BN output channels (96; 16 or 8 for a narrow Up5).  Three consumer
//   warpgroups each own 64 pixels and run wgmma.mma_async m64nBNk8 .tf32
//   with fp32 accumulators in registers; one thread of a fourth, producer
//   warpgroup starts the TMA loads.  The producer warpgroup gives its
//   registers to the consumers (setmaxnreg: 40 and 152 a thread, from 128 at
//   launch), which need ~150 without spills.
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
//   call); two 3-D tensor maps read a BN x 32 box of each.  All boxes are
//   128-byte swizzled; a stage (A 24 KB + B_hi + B_lo) sits in a ring in
//   dynamic shared memory, with a full and an empty mbarrier each.
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
//   vectors (C_out % 4 == 0; else scalars): + bias, LeakyReLU(0.01),
//   + residual, the order of _convk_s1_kernel (pallas_conv_s1.py:122-132).
// * Up5, polyphase.  Output pixel (2m + ry, 2n + rx) of the deconv is a
//   stride-1 correlation over the unpadded input at (m - 1 + a, n - 1 + b),
//   a < 2 + ry, b < 2 + rx: the four phases take 3x3, 3x2, 2x3 and 2x2 taps,
//   the deconv's 25 taps each once and no zero tap (the enumeration is
//   layers/conv_direct.py::deconv_phase_taps).  A CTA owns one phase's
//   8 x 24 patch of (m, n) and walks that phase's taps; the grid's fastest
//   index is the phase (heaviest first), so the four CTAs of a patch read
//   its input from L2 together.  The (1,0,1,0) pre-pad and the deconv's own
//   border are TMA's zero fill, as B3's pad is.  The wrapper packs the
//   weight once as (C_out, 25, C_in) hi/lo, flipped to correlation order,
//   the phases in the grid's order.  The epilogue writes each phase's pixels
//   straight into their interleaved places of the 2H x 2W output: no shuffle
//   pass, no intermediate tensor.  g_s's last deconv (C_out M = 16, or 3
//   where g_s gives RGB) takes BN = 16 or 8 (the weight rows past C_out are
//   TMA's zero fill) and an 8-stage ring, so it does not pay for a 96-wide
//   tile.  Its four phases still read their 25 tap boxes one by one: 25
//   times its input through L2 (15 GB at B=8), at 0.22 of its bound at
//   C_out 16 on an H100.
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
constexpr int BK = 32;                  // input channels per step: one 128-byte row
constexpr int NCONS = 384;              // three consumer warpgroups
constexpr int NT = NCONS + 128;         // and one producer warpgroup
constexpr int A_BYTES = BM * BK * 4;    // 24 KB

// the shared-memory plan of a BN-wide tile
template <int BN>
struct Ring {
  static constexpr int STAGES = BN >= 96 ? 4 : 8;
  static constexpr int B_BYTES = BN * BK * 4;  // each, hi and lo
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int C_LD = BN + 8;          // epilogue tile row: conflict-free float2 stores
  // the ring, its barriers, and room to align it to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
                "128-byte swizzled tiles start on 1024-byte boundaries");
  static_assert(BM * C_LD * 4 <= STAGES * STAGE_BYTES, "epilogue tile fits in the ring");
  static_assert(SMEM <= 232448, "fits in an SM's shared memory");
};

// One CTA's tile: BM pixels of a grid (B3/B6: the output; Up5: one phase's
// input-sized grid) and BN output channels, and where its steps read.
struct Tile {
  int b, gy0, gx0, n0;  // image, the patch's first grid row and column, first channel
  int kh, kw, tap0;     // taps, and the first one's index in the weight maps
  int iy0, ix0;         // input element tap (0, 0) reads for grid pixel (gy0, gx0)
  int gh, gw;           // grid extent
  int ostep, ry, rx;    // grid pixel (gy, gx) is output pixel (ostep gy + ry, ostep gx + rx)
};

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (BN == 96) {
    wgmma_n96(d, a, b, scale_d);
  } else if constexpr (BN == 16) {
    wgmma_n16(d, a, b, scale_d);
  } else {
    static_assert(BN == 8, "tile widths 96, 16 and 8");
    wgmma_n8(d, a, b, scale_d);
  }
}

// The mainloop and epilogue shared by every kernel of this file.
template <int BN>
__device__ __forceinline__ void conv_tile(
    const CUtensorMap* xmap, const CUtensorMap* hmap, const CUtensorMap* lmap,
    const float* __restrict__ bias, const float* __restrict__ res, float* __restrict__ y,
    const Tile& t, int Ho, int Wo, int cout, int nchunk, int leaky, int vec) {
  using R = Ring<BN>;
  constexpr int STAGES = R::STAGES, STAGE_BYTES = R::STAGE_BYTES, B_BYTES = R::B_BYTES;
  constexpr int C_LD = R::C_LD, NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + STAGES * STAGE_BYTES;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;
  const int steps = t.kh * t.kw * nchunk;

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
        const int r = tap / t.kw, q = tap - r * t.kw;
        tma_load_4d(dst, xmap, full, c0, t.ix0 + q, t.iy0 + r, t.b);
        tma_load_3d(dst + A_BYTES, hmap, full, c0, t.tap0 + tap, t.n0);
        tma_load_3d(dst + A_BYTES + B_BYTES, lmap, full, c0, t.tap0 + tap, t.n0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
  // consumers: warpgroup wg owns pixels 64 wg .. 64 wg + 63 of the patch
  // (pixel p is grid row p / TW, column p % TW), its warp w pixels
  // 16 w + g and 16 w + g + 8 (g = lane / 4)
  const int lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int p0 = tid / 32 * 16 + g;
  // this thread's A values in a stage: (pixel p0 + 8 h, channel 8 j + tq + 4 h2)
  // at byte p*128 + (((2 j + h2) ^ g) << 4) + 4 tq of the swizzled tile
  uint32_t a_off[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) a_off[c] = p0 * 128 + ((c ^ g) << 4) + 4 * tq;

  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = part[i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int s = step % STAGES;
    mbar_wait(full0 + 8 * s, (step / STAGES) & 1);
    const unsigned char* st = smem + s * STAGE_BYTES;
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // fragment register i: row g + 8 (i & 1), column tq + 4 (i >> 1)
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
      wgmma_bn<BN>(part, ahi[j], desc_sw128(blo + 32 * j), j != 0);
      wgmma_bn<BN>(part, alo[j], desc_sw128(bhi + 32 * j), 1);
      wgmma_bn<BN>(part, ahi[j], desc_sw128(bhi + 32 * j), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
  }

  // epilogue: the tile through shared memory (the ring is drained: every
  // load was waited for and every wgmma has completed)
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* cs = (float*)smem;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    // accumulator 4 i + e: row g + 8 (e >> 1), column 8 i + 2 tq + (e & 1)
    const int col = 8 * i + 2 * tq;
    *(float2*)&cs[p0 * C_LD + col] = make_float2(acc[4 * i], acc[4 * i + 1]);
    *(float2*)&cs[(p0 + 8) * C_LD + col] = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
  for (int e = tid; e < BM * (BN / 4); e += NCONS) {
    const int p = e / (BN / 4), c4 = e - p * (BN / 4);
    const int gy = t.gy0 + p / TW, gx = t.gx0 + p % TW, n = t.n0 + 4 * c4;
    if (gy >= t.gh || gx >= t.gw || n >= cout) continue;
    const int oy = t.ostep * gy + t.ry, ox = t.ostep * gx + t.rx;
    const size_t o = ((size_t)(t.b * Ho + oy) * Wo + ox) * cout + n;
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

__global__ void __launch_bounds__(NT, 1) conv_tf32x3_kernel(
    __grid_constant__ const CUtensorMap xmap,   // input (B, H, W, cin)
    __grid_constant__ const CUtensorMap hmap,   // weight hi (cout, k*k, cin)
    __grid_constant__ const CUtensorMap lmap,   // weight lo (cout, k*k, cin)
    const float* __restrict__ bias,             // (cout,) or null
    const float* __restrict__ res,              // (B, Ho, Wo, cout) or null
    float* __restrict__ y,                      // (B, Ho, Wo, cout)
    int Ho, int Wo, int cout, int tiles_w, int tiles_h, int n_tiles,
    int k, int stride, int pad_t, int pad_l, int nchunk, int leaky, int vec) {
  int bid = blockIdx.x;
  const int nt = bid % n_tiles;
  bid /= n_tiles;
  const int tw = bid % tiles_w;
  bid /= tiles_w;
  const int th = bid % tiles_h;
  const int b = bid / tiles_h;
  const int oh0 = th * TH, ow0 = tw * TW;
  const Tile t{b, oh0, ow0, nt * 96, k, k, 0, oh0 * stride - pad_t, ow0 * stride - pad_l,
               Ho, Wo, 1, 0, 0};
  conv_tile<96>(&xmap, &hmap, &lmap, bias, res, y, t, Ho, Wo, cout, nchunk, leaky, vec);
}

// phase ph of the grid (0..3, heaviest first): (ry, rx) = (1, 1), (1, 0),
// (0, 1), (0, 0), with 2 + ry by 2 + rx taps; the weight maps hold the
// phases' taps in this order (conv_direct.py::UP5_PHASES)
template <int BN>
__global__ void __launch_bounds__(NT, 1) up5_tf32x3_kernel(
    __grid_constant__ const CUtensorMap xmap,   // input (B, H, W, cin)
    __grid_constant__ const CUtensorMap hmap,   // weight hi (cout, 25, cin)
    __grid_constant__ const CUtensorMap lmap,   // weight lo (cout, 25, cin)
    const float* __restrict__ bias,             // (cout,) or null
    float* __restrict__ y,                      // (B, 2H, 2W, cout)
    int H, int W, int cout, int tiles_w, int tiles_h, int n_tiles, int nchunk, int vec) {
  int bid = blockIdx.x;
  const int ph = bid & 3;
  bid >>= 2;
  const int nt = bid % n_tiles;
  bid /= n_tiles;
  const int tw = bid % tiles_w;
  bid /= tiles_w;
  const int th = bid % tiles_h;
  const int b = bid / tiles_h;
  const int ry = 1 - (ph >> 1), rx = 1 - (ph & 1);
  const int tap0 = ph == 0 ? 0 : ph == 1 ? 9 : ph == 2 ? 15 : 21;
  const int m0 = th * TH, n0 = tw * TW;
  const Tile t{b, m0, n0, nt * BN, 2 + ry, 2 + rx, tap0, m0 - 1, n0 - 1, H, W, 2, ry, rx};
  conv_tile<BN>(&xmap, &hmap, &lmap, bias, nullptr, y, t, 2 * H, 2 * W, cout, nchunk, 0, vec);
}

template <int BN>
int launch_up5(const CUtensorMap& xm, const CUtensorMap& hm, const CUtensorMap& lm,
               const float* bias, float* y, int B, int H, int W, int cin, int cout,
               cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int n_tiles = (cout + BN - 1) / BN;
  const long long grid = 4LL * n_tiles * tiles_w * tiles_h * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(
      up5_tf32x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::SMEM);
  if (err) return err;
  const int vec = cout % 4 == 0 && (uintptr_t)y % 16 == 0;
  up5_tf32x3_kernel<BN><<<(unsigned)grid, NT, Ring<BN>::SMEM, stream>>>(
      xm, hm, lm, bias, y, H, W, cout, tiles_w, tiles_h, n_tiles, (cin + BK - 1) / BK, vec);
  return (int)cudaGetLastError();
}

// the input map (B, H, W, cin) read with element strides `stride`, and the
// weight maps (cout, taps, cin) in BN-row boxes
bool encode_maps(CUtensorMap* xm, CUtensorMap* hm, CUtensorMap* lm, const float* x,
                 const float* w_hi, const float* w_lo, int B, int H, int W, int cin, int taps,
                 int cout, int stride, int bn) {
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {(cuuint64_t)cin * 4, (cuuint64_t)W * cin * 4,
                              (cuuint64_t)H * W * cin * 4};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)(TW * stride), (cuuint32_t)(TH * stride), 1};
  const cuuint32_t xel[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)cin, (cuuint64_t)taps, (cuuint64_t)cout};
  const cuuint64_t wstr[2] = {(cuuint64_t)cin * 4, (cuuint64_t)taps * cin * 4};
  const cuuint32_t wbox[3] = {BK, 1, (cuuint32_t)bn};
  const cuuint32_t wel[3] = {1, 1, 1};
  return encode(xm, x, 4, xdims, xstr, xbox, xel) && encode(hm, w_hi, 3, wdims, wstr, wbox, wel) &&
         encode(lm, w_lo, 3, wdims, wstr, wbox, wel);
}

template <typename K>
int occupancy_of(K kernel, int smem, int* smem_bytes, int* ctas_per_sm) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  *smem_bytes = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, NT, smem);
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
  if (!encode_maps(&xm, &hm, &lm, x, w_hi, w_lo, B, H, W, cin, k * k, cout, stride, 96))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(conv_tf32x3_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<96>::SMEM);
  if (err) return err;
  const int tiles_w = (Wo + TW - 1) / TW, tiles_h = (Ho + TH - 1) / TH;
  const int n_tiles = (cout + 95) / 96;
  const long long grid = (long long)n_tiles * tiles_w * tiles_h * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = cout % 4 == 0 && (uintptr_t)y % 16 == 0 && (uintptr_t)res % 16 == 0;
  conv_tf32x3_kernel<<<(unsigned)grid, NT, Ring<96>::SMEM, (cudaStream_t)stream>>>(
      xm, hm, lm, bias, res, y, Ho, Wo, cout, tiles_w, tiles_h, n_tiles, k, stride, pad_t, pad_l,
      (cin + BK - 1) / BK, leaky, vec);
  return (int)cudaGetLastError();
}

// y = ConvTranspose2d(5, stride 2, padding 3, output_padding 1)(ZeroPad2d(1,0,1,0)(x))
// (+ bias) for x (B, H, W, cin) and the phase-packed weight's TF32 split
// w_hi + w_lo (cout, 25, cin); output (B, 2H, 2W, cout).  bn is the tile's
// width: 96, or 16 / 8 for cout <= 16 / 8.  Returns a CUDA error as
// conv_direct_launch.
extern "C" int conv_up5_launch(const float* x, const float* w_hi, const float* w_lo,
                               const float* bias, float* y, int B, int H, int W, int cin,
                               int cout, int bn, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cin % 4 || cout <= 0 ||
      (bn != 96 && bn != 16 && bn != 8) || (bn != 96 && cout > bn))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, hm, lm;
  if (!encode_maps(&xm, &hm, &lm, x, w_hi, w_lo, B, H, W, cin, 25, cout, 1, bn))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bn == 96   ? launch_up5<96>(xm, hm, lm, bias, y, B, H, W, cin, cout, st)
         : bn == 16 ? launch_up5<16>(xm, hm, lm, bias, y, B, H, W, cin, cout, st)
                    : launch_up5<8>(xm, hm, lm, bias, y, B, H, W, cin, cout, st);
}

// shared memory per CTA and CTAs resident per SM, from the card's
// occupancy calculator: B3/B6's kernel (bn 0), or Up5's of tile width bn
extern "C" int conv_direct_occupancy(int bn, int* smem_bytes, int* ctas_per_sm) {
  if (bn == 0) return occupancy_of(conv_tf32x3_kernel, Ring<96>::SMEM, smem_bytes, ctas_per_sm);
  if (bn == 96)
    return occupancy_of(up5_tf32x3_kernel<96>, Ring<96>::SMEM, smem_bytes, ctas_per_sm);
  if (bn == 16)
    return occupancy_of(up5_tf32x3_kernel<16>, Ring<16>::SMEM, smem_bytes, ctas_per_sm);
  if (bn == 8) return occupancy_of(up5_tf32x3_kernel<8>, Ring<8>::SMEM, smem_bytes, ctas_per_sm);
  return (int)cudaErrorInvalidValue;
}
