// Kernel B2: GDN / IGDN, y = x * (x^2 Gamma^T + beta)^(-1/2 or +1/2), on
// (rows, C) fp32, for sm_90a.
//
// Replaces lic_tpu/layers/pallas_gdn.py::gdn_fused (_gdn_fwd_pallas ->
// _gdn_kernel): a row tile is read once, squared, multiplied by Gamma^T,
// and the epilogue's + beta, sqrt and product with x written once.  Its
// plain PyTorch version is lic_tpu_torch/layers/gdn.py::gdn_plain.
//
// What bounds it on an H100.  At C = 192 the pass reads x and writes y once
// (1,536 bytes a row) and does 2 * 192 * 192 FLOP a row: 48 FLOP a byte.  On
// the fp32 CUDA cores (67 TFLOP/s) that is operations-bound, at 2.7 times
// the bytes' time.  TF32 alone misses the 1e-5 parity, so the product runs
// 3xTF32 on the tensor cores, as the convs do (conv_direct.cu): at 495 / 3
// TFLOP/s the FLOPs take about as long as the bytes, and the bound is the
// bytes.  At C = 16 (the last IGDN) a row is 128 bytes and 512 FLOP: bytes,
// on the CUDA cores.
//
// Design, C in (16, 192] (gdn_tf32x3_kernel):
// * Persistent CTAs, one per SM: a CTA owns 96 output channels (N-tile) and
//   walks 64-row tiles of x with a stride of the CTAs of its N-tile; the two
//   N-tiles of a row tile run on neighbouring CTAs at the same time, so the
//   second read of x hits L2.
// * Gamma arrives fresh every forward (the module re-parametrises it), so a
//   cache of its split would key on a storage address that the allocator
//   reuses.  Each CTA splits its 96 rows of Gamma itself, once per launch:
//   hi = tf32(g), lo = tf32(g - hi), written into shared memory in the
//   128-byte-swizzled K-major tiles that wgmma reads (2 x 6 x 12 KB at C =
//   192), zero past C.
// * One producer thread keeps a ring of eight 64 x 32 fp32 chunks of x
//   filled with TMA (out-of-bounds rows and channels read as zero); three
//   consumer warpgroups take alternate row tiles.  A consumer reads its 16
//   values of a chunk from the swizzled tile, squares them, splits them
//   hi/lo in registers (cvt.rna.tf32) and releases the stage at once (A
//   lives in registers, B is resident); wgmma m64n96k8 runs lo*hi, hi*lo,
//   hi*hi per 8 channels into a partial that is added into an fp32 register
//   sum after every 32-channel chunk (the tensor core's accumulation
//   truncates: conv_direct.cu).  The producer warpgroup hands its registers
//   to the consumers (setmaxnreg 32 / 160).
// * Epilogue from registers: + beta, IEEE sqrtf, then x * sqrt(norm) or
//   x / sqrt(norm) with x read back at the output position (a row's 12
//   loads issued together), 8-byte stores; rows past the end are masked.
//   Keeping the CTA's own chunks of x in the ring for the epilogue instead
//   ran the whole pass at half this speed on an H100: the kept stages
//   starve the ring (PERF.md §6).  While one warpgroup runs its
//   epilogue the other two keep the tensor cores busy.
// * bf16 inputs reach the kernel widened to fp32 (exact) with `bf16_square`
//   set: the square is rounded to bf16, as the TPU kernel squares in bf16,
//   and every operand is then exact in TF32, so the lo terms are zero and
//   the products and their fp32 sums are those of a bf16 wgmma; the wrapper
//   rounds y to bf16.
// Design, C <= 16 (gdn_small_kernel): a CTA of 128 threads stages 128 rows
// in shared memory with coalesced loads, each thread squares its row and
// sums 16 FMAs per output against Gamma in shared memory (broadcast reads),
// and the tile leaves through shared memory again.
// Both kernels sum in a fixed order per row, with no atomics: repeats are
// bit-identical and a row's output does not depend on the rows around it.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 64;                  // rows of a consumer's tile
constexpr int BN = 96;                  // output channels of a CTA
constexpr int BK = 32;                  // channels per chunk: one 128-byte row
constexpr int MAX_CHUNKS = 6;           // C <= 192
constexpr int NWG = 3;                  // consumer warpgroups
constexpr int NCONS = 128 * NWG;
constexpr int NT = NCONS + 128;         // and one producer warpgroup
constexpr int STAGES = 8;               // the ring of x chunks
// registers a thread after setmaxnreg: the consumers' 160 and the
// producers' 32 fill the 65,536 of the SM (384 * 160 + 128 * 32)
constexpr int CONS_REGS = 160;
constexpr int PROD_REGS = (65536 - NCONS * CONS_REGS) / 128;
static_assert(PROD_REGS >= 24 && PROD_REGS % 8 == 0, "setmaxnreg takes 24..256 in steps of 8");
constexpr int A_BYTES = BM * BK * 4;    // 8 KB a chunk of x
constexpr int B_BYTES = BN * BK * 4;    // 12 KB a chunk of Gamma, hi or lo
static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
              "128-byte swizzled tiles start on 1024-byte boundaries");

__device__ __forceinline__ float square(float v, int bf16_square) {
  const float s = v * v;
  return bf16_square ? __bfloat162float(__float2bfloat16_rn(s)) : s;
}

__device__ __forceinline__ float gdn_out(float x, float norm, int inverse) {
  const float r = sqrtf(norm);
  return inverse ? x * r : x / r;
}

// byte offset of element (row, col) of a 128-byte-swizzled tile with 32
// fp32 columns
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

__global__ void __launch_bounds__(NT, 1) gdn_tf32x3_kernel(
    __grid_constant__ const CUtensorMap xmap,  // x (rows, C)
    const float* __restrict__ x,               // the same, for the epilogue
    const float* __restrict__ gamma,           // (C, C) [out, in]
    const float* __restrict__ beta,            // (C,)
    float* __restrict__ y,                     // (rows, C)
    int rows, int C, int nchunk, int n_row_tiles, int nrc, int ntn, int inverse,
    int bf16_square) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* g_hi = smem;                        // nchunk tiles of 96 x 32
  unsigned char* g_lo = smem + nchunk * B_BYTES;
  unsigned char* ring = smem + 2 * nchunk * B_BYTES;  // STAGES chunks of x
  float* s_beta = (float*)(ring + STAGES * A_BYTES);
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t full0 = smem_u32(s_beta + BN);      // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;

  const int nt = blockIdx.x % ntn;
  const int rc = blockIdx.x / ntn;
  const int n0 = nt * BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // lane 0 of each warp of one warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // the producer fills the ring while the consumers split Gamma
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS) : "memory");
    if (tid == NCONS) {
      int step = 0;
      for (int k = 0;; ++k) {
        const int rt = rc + k * nrc;
        if (rt >= n_row_tiles) break;
        for (int c = 0; c < nchunk; ++c, ++step) {
          const int s = step % STAGES;
          mbar_wait(empty0 + 8 * s, ((step / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, A_BYTES);
          tma_load_2d(ring_u + s * A_BYTES, &xmap, full, c * BK, rt * BM);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS) : "memory");
  {
    // this CTA's Gamma rows, split hi/lo into the swizzled K-major tiles;
    // all loads first, so their latencies overlap
    constexpr int PER = BN * MAX_CHUNKS * BK / NCONS;
    const int kp = nchunk * BK;
    float gv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NCONS, n = e / kp, k = e - n * kp;
      gv[i] = (e < BN * kp && n0 + n < C && k < C) ? gamma[(size_t)(n0 + n) * C + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NCONS, n = e / kp, k = e - n * kp;
      if (e >= BN * kp) break;
      const uint32_t hi = tf32_rna(gv[i]);
      const uint32_t lo = tf32_rna(gv[i] - __uint_as_float(hi));
      const uint32_t o = (k / BK) * B_BYTES + sw128(n, k % BK);
      *(uint32_t*)(g_hi + o) = hi;
      *(uint32_t*)(g_lo + o) = lo;
    }
    if (tid < BN) s_beta[tid] = n0 + tid < C ? beta[n0 + tid] : 1.f;
    // the split tiles are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
  }

  // consumer warpgroup wg takes local row tiles wg, wg + NWG, ...; its warp
  // w holds rows 16 w + g and 16 w + g + 8 of a tile (g = lane / 4)
  const int wg = tid / 128;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int p0 = (tid % 128) / 32 * 16 + g;
  uint32_t a_off[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) a_off[c] = p0 * 128 + ((c ^ g) << 4) + 4 * t;
  const uint32_t ghi_u = smem_u32(g_hi), glo_u = smem_u32(g_lo);

  float acc[48], part[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) part[i] = 0.f;
  for (int k = wg;; k += NWG) {
    const int rt = rc + k * nrc;
    if (rt >= n_row_tiles) break;
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] = 0.f;
    for (int c = 0; c < nchunk; ++c) {
      const int step = k * nchunk + c;  // as the producer counts them
      const int s = step % STAGES;
      mbar_wait(full0 + 8 * s, (step / STAGES) & 1);
      const unsigned char* st = ring + s * A_BYTES;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // fragment register i: row g + 8 (i & 1), column t + 4 (i >> 1)
          const float v = square(*(const float*)(st + a_off[2 * j + (i >> 1)] + (i & 1) * 1024),
                                 bf16_square);
          ahi[j][i] = tf32_rna(v);
          alo[j][i] = tf32_rna(v - __uint_as_float(ahi[j][i]));
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // A is in registers now
      const uint32_t bhi = ghi_u + c * B_BYTES, blo = glo_u + c * B_BYTES;
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_n96(part, ahi[j], desc_sw128(blo + 32 * j), j != 0);
        wgmma_n96(part, alo[j], desc_sw128(bhi + 32 * j), 1);
        wgmma_n96(part, ahi[j], desc_sw128(bhi + 32 * j), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < 48; ++i) acc[i] += part[i];
    }
    // accumulator 4 i + e: row g + 8 (e >> 1), column 8 i + 2 t + (e & 1).
    // A row's 12 x loads are issued before its first store, so it waits for
    // one L2 round trip, not 12.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * BM + p0 + 8 * h;
      if (row >= rows) continue;
      const float* xr = x + (size_t)row * C;
      float* yr = y + (size_t)row * C;
      float2 xv[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int n = n0 + 8 * i + 2 * t;  // C % 4 == 0: n < C means n + 1 < C
        xv[i] = n < C ? __ldg((const float2*)(xr + n)) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int col = 8 * i + 2 * t, n = n0 + col;
        if (n >= C) continue;
        const float y0 = gdn_out(xv[i].x, acc[4 * i + 2 * h] + s_beta[col], inverse);
        const float y1 = gdn_out(xv[i].y, acc[4 * i + 2 * h + 1] + s_beta[col + 1], inverse);
        *(float2*)(yr + n) = make_float2(y0, y1);
      }
    }
  }
}

// C <= CM: a thread per row, Gamma and the row tile in shared memory
constexpr int CM = 16;
__global__ void __launch_bounds__(128) gdn_small_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ y, int rows, int C, int inverse,
    int bf16_square) {
  __shared__ float s_g[CM * CM], s_b[CM];
  __shared__ float s_x[128][CM + 1];
  const int t = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * 128;
  const int nr = min(128, rows - (int)r0);
  for (int e = t; e < CM * CM; e += 128) {
    const int n = e / CM, k = e % CM;
    s_g[e] = n < C && k < C ? gamma[n * C + k] : 0.f;
  }
  for (int n = t; n < CM; n += 128) s_b[n] = n < C ? beta[n] : 1.f;
  const float* xt = x + r0 * C;
  for (int e = t; e < nr * C; e += 128) s_x[e / C][e % C] = xt[e];
  __syncthreads();
  if (t < nr) {
    float xv[CM], sq[CM];
#pragma unroll
    for (int k = 0; k < CM; ++k) {
      xv[k] = k < C ? s_x[t][k] : 0.f;
      sq[k] = square(xv[k], bf16_square);
    }
#pragma unroll
    for (int n = 0; n < CM; ++n) {
      if (n >= C) break;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < CM; ++k) a = fmaf(sq[k], s_g[n * CM + k], a);
      s_x[t][n] = gdn_out(xv[n], a + s_b[n], inverse);
    }
  }
  __syncthreads();
  float* yt = y + r0 * C;
  for (int e = t; e < nr * C; e += 128) yt[e] = s_x[e / C][e % C];
}

size_t tc_smem(int nchunk) {
  return 2 * (size_t)nchunk * B_BYTES + STAGES * A_BYTES + BN * 4 + 2 * STAGES * 8 + 1024;
}

}  // namespace

// y = x * (x^2 Gamma^T + beta)^(-1/2), or ^(+1/2) with `inverse`, for x and
// y (rows, C) fp32 and Gamma (C, C) [out, in]; `bf16_square` rounds x^2 to
// bf16.  C <= 16, or C <= 192 with C % 4 == 0 and x 16-byte aligned (TMA).
// Launches on `stream`; returns a CUDA error (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int gdn_launch(const float* x, const float* gamma, const float* beta, float* y,
                          int rows, int C, int inverse, int bf16_square, void* stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (C <= CM) {
    gdn_small_kernel<<<(unsigned)((rows + 127) / 128), 128, 0, st>>>(x, gamma, beta, y, rows, C,
                                                                      inverse, bf16_square);
    return (int)cudaGetLastError();
  }
  if (C > MAX_CHUNKS * BK || C % 4 || (uintptr_t)x % 16 || (uintptr_t)y % 8)
    return (int)cudaErrorInvalidValue;
  const int nchunk = (C + BK - 1) / BK, ntn = (C + BN - 1) / BN;
  const int n_row_tiles = (rows + BM - 1) / BM;
  CUtensorMap xm;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 4};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t el[2] = {1, 1};
  if (!encode(&xm, x, 2, dims, strides, box, el)) return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem(nchunk);
  int err = (int)cudaFuncSetAttribute(gdn_tf32x3_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const int nrc = max(1, min(sms / ntn, n_row_tiles));
  gdn_tf32x3_kernel<<<nrc * ntn, NT, smem, st>>>(xm, x, gamma, beta, y, rows, C, nchunk,
                                                 n_row_tiles, nrc, ntn, inverse, bf16_square);
  return (int)cudaGetLastError();
}

// shared memory per CTA and CTAs resident per SM of the tensor-core kernel
// at C = 192
extern "C" int gdn_occupancy(int* smem_bytes, int* ctas_per_sm) {
  const size_t smem = tc_smem(MAX_CHUNKS);
  int err = (int)cudaFuncSetAttribute(gdn_tf32x3_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, gdn_tf32x3_kernel, NT,
                                                            smem);
}
