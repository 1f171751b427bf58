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
// segment-sum matmuls, the head-broadcast mask) are not ported: a team of
// threads computes one head's n x n logits directly, with a per-row max.
//
// What bounds them on an H100.  At ws 8 (n = 64, hd = 24) B4 reads 3C and
// writes C floats per token and does 4 n hd FLOP per token and head: ~1.5
// FLOP per byte, so HBM bytes bound it.  B5 adds 2 C (3C + C) FLOP per token
// for the two projections: ~400 FLOP per byte, so the fp32 CUDA cores bound
// it.  The first port of both (one CTA per window and head, every FMA fed by
// two shared-memory loads) ran at the pace of shared memory instead: two
// wavefronts per 32 FMAs.
//
// Design.  Both products of the attention core (attend) are register tiled.
// A thread owns RPT logit rows x n/8 key columns; the eight threads of a
// row sit on eight neighbouring lanes, lane cg holding the consecutive keys
// cg n/8 .. cg n/8 + n/8 - 1, so its bias and mask columns are one 16-byte
// (or 8-byte) vector load.  q stays token-major in shared memory and k, v
// are stored with key cg n/8 + jj in row 8 jj + cg, all with a row stride
// of hd + 4 floats: eight neighbouring lanes read eight neighbouring rows,
// on distinct banks, and every operand load is one 16-byte vector.  QK^T
// does 4 RPT n/8 FMAs per RPT + n/8 vector loads (RPT = 4: 128 per 12), PV
// 4 RPT n/8 per n/8.  The logits never leave registers: the row max and
// row sum take three xor shuffles, PV sums each lane's own keys for four
// output columns at a time, and a reduce-scatter over the row's eight
// lanes (two halving steps and a pair sum) leaves output column cg / 2 on
// the even lane.  hd and n are template constants.
//
// B4: a CTA of 256 threads takes 64 tokens (one ws-8 window or four ws-4
// windows) and walks their (window, head) items in rounds, one item per
// team of 8n/4 threads.  A token table in shared memory holds each token's
// pixel.  Each round's q, k, v tiles arrive by 16-byte cp.async,
// neighbouring threads on neighbouring addresses, while the round before
// computes (two stages); the outputs go through shared memory, so that
// each token's head slice leaves as whole 16-byte vectors.  About 98 KB of
// shared memory at hd 24: two CTAs per SM; 182 KB at hd 48 (source_net_wam
// at is_high, N = 384 over 8 heads): one.
//
// B5: a CTA of 256 threads takes 64 tokens and runs the heads one after
// another.  Per head, K-chunks of 32 input channels of x and of the head's
// 3 hd rows of W_qkv (torch's Linear layout, (out, in), read as it is)
// stream through two cp.async stages into a register-tiled product (4 rows
// x 3hd/8 columns a thread; two groups of 128 threads each take half of a
// chunk's channels, and one group's sums are added to the other's at the
// end of the head); the last chunk of a head prefetches the next head's
// first.  The attention core runs on the head's q, k, v (one team
// per window) and writes its output columns into o (64 x C) in shared
// memory.  Then o W_proj^T + b is one register-tiled product (4 rows x C/16
// columns a thread) over K-chunks of W_proj.  An output accumulator held in
// registers across the heads does not fit: with the attention's live
// values it needs more than the 128 registers a thread has at two CTAs per
// SM, and ptxas spilled it.  About 109 KB of shared memory at C = 192: two
// CTAs per SM.  At C = 384 (hd 48) o alone takes 99 KB and the whole CTA
// 205 KB: one CTA per SM, and the launch bounds then let a thread keep 255
// registers (min_blocks).  There K-group 1's 4 x 18 qkv sums no longer fit
// in one stage, so it hands them over in two passes of 9 columns.
//
// The shift/pad mask is additive (-100, not -inf, as the reference's) and
// the softmax takes each head's own row max, so no head's row underflows.
// Every sum runs in one fixed order (serial over the contraction in
// ascending order, then a fixed shuffle tree), with no split across CTAs
// and no atomics: repeats are bit-identical and a window's output does not
// depend on the batch it comes in.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;  // threads per CTA, both kernels
constexpr int M = 64;    // tokens per CTA, both kernels

// CTAs per SM that the launch bounds ask registers for: two where two CTAs'
// shared memory (and the 1 KB the runtime reserves for each) fits in the
// SM's 228 KB, else one (hd 48, where a CTA takes 180-210 KB)
constexpr int min_blocks(size_t smem) { return 2 * (smem + 1024) <= 228 * 1024 ? 2 : 1; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a . b over four consecutive elements, in ascending order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// max / sum over the eight lanes of a row group (lanes differing in bits 0-2)
__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 4));
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v + __shfl_xor_sync(FULL, v, 4);
}

// Pixel index of token t of window wi of image b.
__device__ __forceinline__ int token_pixel(int b, int wi, int t, int Hp, int Wp, int ws) {
  const int nww = Wp / ws;
  const int y = (wi / nww) * ws + t / ws;
  const int x = (wi % nww) * ws + t % ws;
  return (b * Hp + y) * Wp + x;
}

// The CTA's token table: tok[i] = pixel of token i of the CTA's 64 tokens
// (window blockIdx.x * 64 / N + i / N), -1 past the last window.
template <int N>
__device__ __forceinline__ void token_table(int* tok, int nwin, int nW, int Hp, int Wp, int ws) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int g = blockIdx.x * (M / N) + i / N;
    tok[i] = g < nwin ? token_pixel(g / nW, g % nW, i % N, Hp, Wp, ws) : -1;
  }
}

// Shared-memory row of key (and value) token t of a window: lane cg's key
// columns jj = 0 .. N/8 - 1 are the consecutive tokens cg N/8 + jj, stored
// in rows jj 8 + cg, so eight neighbouring lanes read eight neighbouring
// rows and each lane's bias and mask columns are one contiguous run.
template <int N>
__device__ __forceinline__ int key_slot(int t) {
  return (t % (N / 8)) * 8 + t / (N / 8);
}

// o[0 .. JJ) = p[0 .. JJ) from global memory, as 16- or 8-byte vectors
template <int JJ>
__device__ __forceinline__ void ldg_run(const float* __restrict__ p, float (&o)[JJ]) {
  if constexpr (JJ % 4 == 0) {
#pragma unroll
    for (int u = 0; u < JJ / 4; ++u) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + u);
      o[4 * u] = t.x, o[4 * u + 1] = t.y, o[4 * u + 2] = t.z, o[4 * u + 3] = t.w;
    }
  } else {
    static_assert(JJ == 2, "key columns per lane");
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = t.x, o[1] = t.y;
  }
}

// One head of one window.  q: N x HD in shared memory, token-major; k, v:
// the same with token t in row key_slot(t); row stride HD + 4.  rel: this
// head's (N, N) bias; mask: this window's (N, N) mask or null.  The team
// has (N / RPT) * 8 threads, lt its thread index (a multiple of 32 threads,
// starting on a warp boundary).  Calls store(i, d, o[i][d]) once for every
// output element.
template <int N, int HD, int RPT, typename Store>
__device__ __forceinline__ void attend(const float* q, const float* k, const float* v,
                                       const float* __restrict__ rel,
                                       const float* __restrict__ mask, float scale, int lt,
                                       Store store) {
  constexpr int S = HD + 4, JJ = N / 8;
  static_assert(HD % 8 == 0 && N % 8 == 0 && N % RPT == 0, "tile shape");
  const int rg = lt >> 3, cg = lt & 7;

  // logits: s[r][jj] = q[rg RPT + r] . k[cg JJ + jj], d ascending
  float s[RPT][JJ];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) s[r][jj] = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 qv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) qv[r] = ld4(q + (rg * RPT + r) * S + d);
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const float4 kv = ld4(k + (jj * 8 + cg) * S + d);
#pragma unroll
      for (int r = 0; r < RPT; ++r) s[r][jj] = dot4(qv[r], kv, s[r][jj]);
    }
  }

  // softmax numerators in place, reciprocal row sums in il
  float il[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg * RPT + r;
    float bias[JJ], mk[JJ];
    ldg_run<JJ>(rel + i * N + cg * JJ, bias);
    if (mask) ldg_run<JJ>(mask + i * N + cg * JJ, mk);
    float m = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      float t = s[r][jj] * scale + bias[jj];
      if (mask) t += mk[jj];
      s[r][jj] = t;
      m = fmaxf(m, t);
    }
    m = group8_max(m);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const float e = expf(s[r][jj] - m);
      s[r][jj] = e;
      sum += e;
    }
    il[r] = 1.f / group8_sum(sum);
  }

  // PV, four output columns at a time: each lane sums its own key columns;
  // a reduce-scatter over lane bits 2 and 1, then a sum over bit 0, leaves
  // column dc + cg / 2 on lanes cg and cg ^ 1, and the even lane stores it
  const bool b2 = cg & 4, b1 = cg & 2;
#pragma unroll
  for (int dc = 0; dc < HD; dc += 4) {
    float a[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[r][e] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const float4 vv = ld4(v + (jj * 8 + cg) * S + dc);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        a[r][0] = fmaf(s[r][jj], vv.x, a[r][0]);
        a[r][1] = fmaf(s[r][jj], vv.y, a[r][1]);
        a[r][2] = fmaf(s[r][jj], vv.z, a[r][2]);
        a[r][3] = fmaf(s[r][jj], vv.w, a[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = b2 ? a[r][e] : a[r][e + 2];
        const float keep = b2 ? a[r][e + 2] : a[r][e];
        a[r][e] = keep + __shfl_xor_sync(FULL, send, 4);
      }
      const float send = b1 ? a[r][0] : a[r][1];
      const float keep = b1 ? a[r][1] : a[r][0];
      const float o = keep + __shfl_xor_sync(FULL, send, 2);
      const float sum = o + __shfl_xor_sync(FULL, o, 1);  // the same bits on both lanes
      if (!(cg & 1)) store(rg * RPT + r, dc + (cg >> 1), sum * il[r]);
    }
  }
}

// ---------------------------------------------------------------- B4
// grid: ceil(B nW / (64 / N)); 256 threads; dynamic shared memory: 2 stages
// of TEAMS tiles of 3 x N x (HD + 4) floats, TEAMS output tiles of
// N x (HD + 4) and the token table.
template <int N, int HD>
struct Wba {
  // 4 rows a thread; 2 at hd 8 (a test shape), where ptxas would hoist both
  // d-chunks' key loads and spill
  static constexpr int RPT = HD == 8 ? 2 : 4, T = N / RPT * 8, TEAMS = NT / T, WPC = M / N;
  static constexpr int S = HD + 4, TILE = 3 * N * S, STAGE = TEAMS * TILE;
  static constexpr size_t SMEM = (2 * STAGE + TEAMS * N * S) * sizeof(float) + M * sizeof(int);
  static constexpr int MINB = min_blocks(SMEM);
};

template <int N, int HD>
__global__ void __launch_bounds__(NT, Wba<N, HD>::MINB) wba_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rel,
    const float* __restrict__ mask, float* __restrict__ out, int nwin, int nW, int Hp,
    int Wp, int nh, int ws, float scale) {
  using K = Wba<N, HD>;
  constexpr int S = K::S, CH = HD / 4;  // 16-byte chunks per token row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* os = smem + 2 * K::STAGE + (threadIdx.x / K::T) * N * S;  // this team's output
  int* tok = reinterpret_cast<int*>(smem + 2 * K::STAGE + K::TEAMS * N * S);
  const int C = nh * HD;
  const int team = threadIdx.x / K::T, lt = threadIdx.x % K::T;
  const int items = K::WPC * nh, rounds = (items + K::TEAMS - 1) / K::TEAMS;

  // this team's window (within the CTA) and head in round r: false where
  // there is none
  auto item = [&](int r, int& w, int& h) {
    const int it = r * K::TEAMS + team;
    w = it / nh;
    h = it % nh;
    return it < items && tok[w * N] >= 0;
  };
  // issue the copies of round r's q, k, v tiles into stage st
  auto load = [&](int r, int st) {
    int w, h;
    if (!item(r, w, h)) return;
    float* dst = smem + st * K::STAGE + team * K::TILE;
#pragma unroll 1  // per-thread offsets are not worth registers held across rounds
    for (int e = lt; e < 3 * N * CH; e += K::T) {
      const int part = e / (N * CH), t = (e / CH) % N, c4 = e % CH;
      const float* src = qkv + (size_t)tok[w * N + t] * 3 * C + part * C + h * HD;
      const int row = part ? part * N + key_slot<N>(t) : t;
      cp_async16(dst + row * S + c4 * 4, src + c4 * 4);
    }
  };

  token_table<N>(tok, nwin, nW, Hp, Wp, ws);
  __syncthreads();
  load(0, 0);
  cp_async_commit();
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds) {
      load(r + 1, (r + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int w, h;
    const bool busy = item(r, w, h);
    if (busy) {
      const float* t = smem + (r & 1) * K::STAGE + team * K::TILE;
      const int wi = (blockIdx.x * K::WPC + w) % nW;
      attend<N, HD, K::RPT>(t, t + N * S, t + 2 * N * S, rel + (size_t)h * N * N,
                            mask ? mask + (size_t)wi * N * N : nullptr, scale, lt,
                            [&](int i, int d, float val) { os[i * S + d] = val; });
    }
    __syncthreads();  // stage r & 1 is refilled in round r + 1; os is complete
    if (busy) {  // whole 16-byte vectors of each token's head slice
      for (int e = lt; e < N * CH; e += K::T) {
        const int i = e / CH, c4 = e % CH;
        *reinterpret_cast<float4*>(out + (size_t)tok[w * N + i] * C + h * HD + c4 * 4) =
            ld4(os + i * S + c4 * 4);
      }
    }
  }
}

// ---------------------------------------------------------------- B5
// grid: ceil(B nW / (64 / N)); 256 threads; dynamic shared memory: the
// heads' outputs o (64 x (C + 4)), one work area and the token table.  The
// work area holds, per head, two stages of (x, W_qkv rows) K-chunks
// (64 + 3 HD rows x (KC + 4)) and the head's q, k, v (3 x 64 x (HD + 4));
// at the end, two stages of W_proj K-chunks (C x (KC + 4)).
template <int N, int HD, int C>
struct WbaProj {
  static constexpr int WPC = M / N, T = NT / WPC, RPT = N * 8 / T;
  static constexpr int S = HD + 4, OS = C + 4, Q3 = 3 * HD, QC = Q3 / 8, CPT = C / 16;
  static constexpr int KC = C < 32 ? C : 32, KS = KC + 4, NKC = C / KC;
  static constexpr int STAGE = (M + Q3) * KS, PSTAGE = C * KS;
  static constexpr int AREA = 2 * STAGE + 3 * M * S > 2 * PSTAGE ? 2 * STAGE + 3 * M * S
                                                                : 2 * PSTAGE;
  static constexpr size_t SMEM = sizeof(float) * ((size_t)M * OS + AREA) + M * sizeof(int);
  static constexpr int MINB = min_blocks(SMEM);
  // K-group 1 hands its 4 x QC sums to K-group 0 through one stage, in HP
  // passes of QH columns where they do not fit in one (hd 48)
  static constexpr int HP = 128 * 4 * QC <= STAGE ? 1 : 2, QH = QC / HP;
  static_assert(C % KC == 0 && KC % 8 == 0 && C % 16 == 0 && Q3 % 8 == 0 && N * 8 % T == 0 &&
                    QC % HP == 0 && 128 * 4 * QH <= STAGE,
                "tile shape");
};

template <int N, int HD, int C>
__global__ void __launch_bounds__(NT, WbaProj<N, HD, C>::MINB) wba_proj_kernel(
    const float* __restrict__ x, const float* __restrict__ rel,
    const float* __restrict__ mask, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ wproj,
    const float* __restrict__ bproj, float* __restrict__ out, int nwin, int nW, int Hp,
    int Wp, int ws, float scale) {
  using K = WbaProj<N, HD, C>;
  constexpr int S = K::S, OS = K::OS, KS = K::KS, KC = K::KC, NH = C / HD;
  extern __shared__ float4 smem4[];
  float* os = reinterpret_cast<float*>(smem4);  // M x OS: every head's output
  float* area = os + M * OS;                     // the work area
  float* qs = area + 2 * K::STAGE;               // q, k, v: 3 x M x S
  int* tok = reinterpret_cast<int*>(area + K::AREA);
  const int tid = threadIdx.x;

  // K-chunk kc of x and of head h's q, k, v rows of W_qkv into stage st
  auto load_qkv_chunk = [&](int h, int kc, int st) {
    float* xd = area + st * K::STAGE;
    float* wd = xd + M * KS;
#pragma unroll 1  // per-thread offsets are not worth registers held across heads
    for (int e = tid; e < M * (KC / 4); e += NT) {
      const int i = e / (KC / 4), c4 = e % (KC / 4);
      if (tok[i] >= 0) cp_async16(xd + i * KS + c4 * 4, x + (size_t)tok[i] * C + kc * KC + c4 * 4);
    }
#pragma unroll 1
    for (int e = tid; e < K::Q3 * (KC / 4); e += NT) {
      const int row = e / (KC / 4), c4 = e % (KC / 4);
      const int grow = (row / HD) * C + h * HD + row % HD;
      cp_async16(wd + row * KS + c4 * 4, wqkv + (size_t)grow * C + kc * KC + c4 * 4);
    }
  };
  // K-chunk kc of W_proj (all C output rows) into stage st
  auto load_proj_chunk = [&](int kc, int st) {
#pragma unroll 1
    for (int e = tid; e < C * (KC / 4); e += NT) {
      const int col = e / (KC / 4), c4 = e % (KC / 4);
      cp_async16(area + st * K::PSTAGE + col * KS + c4 * 4,
                 wproj + (size_t)col * C + kc * KC + c4 * 4);
    }
  };

  token_table<N>(tok, nwin, nW, Hp, Wp, ws);
  __syncthreads();
  load_qkv_chunk(0, 0, 0);
  cp_async_commit();

  // the qkv product: two K-groups of 128 threads each take half of every
  // chunk's input channels; a thread owns rows prow .. prow + 3 and columns
  // pcol + 8 m, and K-group 1's sums are added to K-group 0's at the end
  const int kg = tid >> 7, prow = ((tid & 127) >> 3) * 4, pcol = tid & 7;
  const int team = tid / K::T, lt = tid % K::T;
  int step = 0;  // K-chunks so far: the stage of the next one is step & 1

  for (int h = 0; h < NH; ++h) {
    // q, k, v of head h: (M x C) . (W_qkv rows)^T; the last chunk
    // prefetches the next head's first
    float pa[4][K::QC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < K::QC; ++m) pa[r][m] = 0.f;
    for (int kc = 0; kc < K::NKC; ++kc, ++step) {
      if (kc + 1 < K::NKC)
        load_qkv_chunk(h, kc + 1, (step + 1) & 1);
      else if (h + 1 < NH)
        load_qkv_chunk(h + 1, 0, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* xk = area + (step & 1) * K::STAGE + kg * (KC / 2);
      const float* wk = area + (step & 1) * K::STAGE + M * KS + kg * (KC / 2);
#pragma unroll
      for (int c = 0; c < KC / 2; c += 4) {
        float4 xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = ld4(xk + (prow + r) * KS + c);
#pragma unroll
        for (int m = 0; m < K::QC; ++m) {
          const float4 w = ld4(wk + (pcol + 8 * m) * KS + c);
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[r][m] = dot4(xv[r], w, pa[r][m]);
        }
      }
      __syncthreads();  // the stage is refilled next
    }
    // K-group 1 hands its sums to K-group 0 through the stage that is not
    // being filled (columns m0 .. m0 + QH per pass), and K-group 0 adds
    // them, then the bias, and stores q | k | v
    float* part1 = area + ((step + 1) & 1) * K::STAGE + (tid & 127);
#pragma unroll
    for (int m0 = 0; m0 < K::QC; m0 += K::QH) {
      if (kg) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int m = 0; m < K::QH; ++m) part1[(r * K::QH + m) * 128] = pa[r][m0 + m];
      }
      __syncthreads();
      if (!kg) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = prow + r, kv_row = (i / N) * N + key_slot<N>(i % N);
#pragma unroll
          for (int m = 0; m < K::QH; ++m) {
            // column pcol + 8 (m0 + m) of the head's q | k | v: part (m0 + m) / (HD / 8)
            constexpr int QD = HD / 8;
            const int part = (m0 + m) / QD, d = pcol + 8 * ((m0 + m) % QD);
            const float sum = pa[r][m0 + m] + part1[(r * K::QH + m) * 128];
            qs[(part * M + (part ? kv_row : i)) * S + d] =
                sum + __ldg(bqkv + part * C + h * HD + d);
          }
        }
      }
      __syncthreads();  // part1 is rewritten by the next pass
    }

    // attention, one team per window, into columns h HD .. of o (q, k, v
    // are rewritten only after the next head's chunk loop has synchronised)
    if (tok[team * N] >= 0) {
      const float* t = qs + team * N * S;
      float* o = os + team * N * OS + h * HD;
      const int wi = (blockIdx.x * K::WPC + team) % nW;
      attend<N, HD, K::RPT>(t, t + M * S, t + 2 * M * S, rel + (size_t)h * N * N,
                            mask ? mask + (size_t)wi * N * N : nullptr, scale, lt,
                            [&](int i, int d, float v) { o[i * OS + d] = v; });
    }
  }

  // out = o . W_proj^T + b, input channels (head by head, d ascending)
  // ascending; rows orow + r, columns ocol + 16 m
  __syncthreads();  // o is complete and the work area is free
  load_proj_chunk(0, 0);
  cp_async_commit();
  float acc[4][K::CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < K::CPT; ++m) acc[r][m] = 0.f;
  const int orow = (tid >> 4) * 4, ocol = tid & 15;
  for (int kc = 0; kc < K::NKC; ++kc) {
    if (kc + 1 < K::NKC) load_proj_chunk(kc + 1, (kc + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* wk = area + (kc & 1) * K::PSTAGE;
#pragma unroll
    for (int c = 0; c < KC; c += 4) {
      float4 ov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ov[r] = ld4(os + (orow + r) * OS + kc * KC + c);
#pragma unroll
      for (int m = 0; m < K::CPT; ++m) {
        const float4 w = ld4(wk + (ocol + 16 * m) * KS + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][m] = dot4(ov[r], w, acc[r][m]);
      }
    }
    __syncthreads();  // the stage is refilled next
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = tok[orow + r];
    if (p < 0) continue;
#pragma unroll
    for (int m = 0; m < K::CPT; ++m) {
      const int col = ocol + 16 * m;
      out[(size_t)p * C + col] = acc[r][m] + __ldg(bproj + col);
    }
  }
}

bool bad_grid(int B, int Hp, int Wp, int ws) {
  return B <= 0 || Hp <= 0 || Wp <= 0 || (ws != 4 && ws != 8) || Hp % ws || Wp % ws;
}

template <int N, int HD>
int wba_run(const float* qkv, const float* rel, const float* mask, float* out, int nwin,
            int nW, int Hp, int Wp, int nh, int ws, float scale, cudaStream_t s) {
  using K = Wba<N, HD>;
  int err = (int)cudaFuncSetAttribute(wba_kernel<N, HD>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err) return err;
  wba_kernel<N, HD><<<(nwin + K::WPC - 1) / K::WPC, NT, K::SMEM, s>>>(
      qkv, rel, mask, out, nwin, nW, Hp, Wp, nh, ws, scale);
  return (int)cudaGetLastError();
}

template <int N, int HD, int C>
int wba_proj_run(const float* x, const float* rel, const float* mask, const float* wqkv,
                 const float* bqkv, const float* wproj, const float* bproj, float* out,
                 int nwin, int nW, int Hp, int Wp, int ws, float scale, cudaStream_t s) {
  using K = WbaProj<N, HD, C>;
  int err = (int)cudaFuncSetAttribute(wba_proj_kernel<N, HD, C>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err) return err;
  wba_proj_kernel<N, HD, C><<<(nwin + K::WPC - 1) / K::WPC, NT, K::SMEM, s>>>(
      x, rel, mask, wqkv, bqkv, wproj, bproj, out, nwin, nW, Hp, Wp, ws, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// B4.  qkv (B, Hp, Wp, 3C) NHWC, 16-byte aligned; rel: (nh, n, n); mask:
// (nW, n, n) or null, nW windows per image.  hd = C / nh in {8, 24, 48}.
extern "C" int wba_launch(const float* qkv, const float* rel, const float* mask,
                          float* out, int B, int Hp, int Wp, int C, int nh, int ws,
                          float scale, void* stream) {
  if (bad_grid(B, Hp, Wp, ws) || nh <= 0 || C % nh) return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws), nwin = B * nW, hd = C / nh;
  cudaStream_t s = (cudaStream_t)stream;
  if (ws == 8 && hd == 48) return wba_run<64, 48>(qkv, rel, mask, out, nwin, nW, Hp, Wp, nh, ws, scale, s);
  if (ws == 4 && hd == 48) return wba_run<16, 48>(qkv, rel, mask, out, nwin, nW, Hp, Wp, nh, ws, scale, s);
  if (ws == 8 && hd == 24) return wba_run<64, 24>(qkv, rel, mask, out, nwin, nW, Hp, Wp, nh, ws, scale, s);
  if (ws == 4 && hd == 24) return wba_run<16, 24>(qkv, rel, mask, out, nwin, nW, Hp, Wp, nh, ws, scale, s);
  if (ws == 8 && hd == 8) return wba_run<64, 8>(qkv, rel, mask, out, nwin, nW, Hp, Wp, nh, ws, scale, s);
  if (ws == 4 && hd == 8) return wba_run<16, 8>(qkv, rel, mask, out, nwin, nW, Hp, Wp, nh, ws, scale, s);
  return (int)cudaErrorInvalidValue;
}

// B5.  x (B, Hp, Wp, C) NHWC; wqkv (3C, C) and wproj (C, C) in torch's
// Linear layout (out, in); biases (3C,), (C,); all 16-byte aligned.
// (C, nh) in {(192, 8), (16, 2), (384, 8)}: hd 24, 8 and 48.
extern "C" int wba_proj_launch(const float* x, const float* rel, const float* mask,
                               const float* wqkv, const float* bqkv,
                               const float* wproj, const float* bproj, float* out,
                               int B, int Hp, int Wp, int C, int nh, int ws,
                               float scale, void* stream) {
  if (bad_grid(B, Hp, Wp, ws)) return (int)cudaErrorInvalidValue;
  const int nW = (Hp / ws) * (Wp / ws), nwin = B * nW;
  cudaStream_t s = (cudaStream_t)stream;
#define WBA_PROJ(n, hd, c) \
  wba_proj_run<n, hd, c>(x, rel, mask, wqkv, bqkv, wproj, bproj, out, nwin, nW, Hp, Wp, ws, scale, s)
  if (C == 192 && nh == 8) return ws == 8 ? WBA_PROJ(64, 24, 192) : WBA_PROJ(16, 24, 192);
  if (C == 16 && nh == 2) return ws == 8 ? WBA_PROJ(64, 8, 16) : WBA_PROJ(16, 8, 16);
  if (C == 384 && nh == 8) return ws == 8 ? WBA_PROJ(64, 48, 384) : WBA_PROJ(16, 48, 384);
#undef WBA_PROJ
  return (int)cudaErrorInvalidValue;
}

// Shared memory per CTA (bytes) and CTAs resident per SM of B4 (proj 0;
// ws, hd = C / nh) or B5 (proj 1; ws, C), as the card's occupancy
// calculator gives them.  Returns a CUDA error, or cudaErrorInvalidValue
// for a shape the kernels do not take.
template <typename Kern>
int occupancy(Kern kernel, size_t smem, int* smem_bytes, int* ctas_per_sm) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, NT, smem);
}

template <int N, int HD>
int occupancy_b4(int* smem_bytes, int* ctas_per_sm) {
  return occupancy(wba_kernel<N, HD>, Wba<N, HD>::SMEM, smem_bytes, ctas_per_sm);
}

template <int N, int HD, int C>
int occupancy_b5(int* smem_bytes, int* ctas_per_sm) {
  return occupancy(wba_proj_kernel<N, HD, C>, WbaProj<N, HD, C>::SMEM, smem_bytes, ctas_per_sm);
}

extern "C" int wba_occupancy(int proj, int ws, int hd, int C, int* smem_bytes,
                             int* ctas_per_sm) {
  int *sb = smem_bytes, *cs = ctas_per_sm;
  const bool w8 = ws == 8;
  if (!proj && hd == 48) return w8 ? occupancy_b4<64, 48>(sb, cs) : occupancy_b4<16, 48>(sb, cs);
  if (!proj && hd == 24) return w8 ? occupancy_b4<64, 24>(sb, cs) : occupancy_b4<16, 24>(sb, cs);
  if (!proj && hd == 8) return w8 ? occupancy_b4<64, 8>(sb, cs) : occupancy_b4<16, 8>(sb, cs);
  if (proj && C == 192 && hd == 24)
    return w8 ? occupancy_b5<64, 24, 192>(sb, cs) : occupancy_b5<16, 24, 192>(sb, cs);
  if (proj && C == 16 && hd == 8)
    return w8 ? occupancy_b5<64, 8, 16>(sb, cs) : occupancy_b5<16, 8, 16>(sb, cs);
  if (proj && C == 384 && hd == 48)
    return w8 ? occupancy_b5<64, 48, 384>(sb, cs) : occupancy_b5<16, 48, 384>(sb, cs);
  return (int)cudaErrorInvalidValue;
}
