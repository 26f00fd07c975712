// Flash attention, backward, float32 — on CUDA cores (sm_90a).
//
// The Pallas TPU kernel `flash_attention` (src/repro/kernels/flash_attention/
// kernel.py) has no backward: the reference trains through XLA's autodiff
// of `blocked_attention` (src/repro/models/attention.py).  This file is the
// gradient of the port's float32 forward (flash_attention.cu) for float32
// inputs; bfloat16 inputs go to flash_attention_bwd_bf16.cu (tensor cores),
// a choice by dtype like the forward's, not a fallback.  It computes, for
//
//   o = softmax(cap(q k^T * dh^-1/2) + mask) v,
//
// with right-aligned causal masking (query row r sits at absolute position
// r + Skv - Sq), an optional sliding window (keep col > row - window), an
// optional tanh soft-cap and GQA (q-head h reads kv-head h / (H / Kv)).  It
// follows FlashAttention-2's backward: the forward keeps the float32 row
// log-sum-exp L, so the probabilities are recomputed tile by tile as
// P = exp(S - L) and never stored whole, and
//
//   D  = rowsum(dO * O)                      (flash_bwd_delta_kernel)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * cap'(S),
//   dK = dS^T Q * dh^-1/2                    (flash_bwd_dkdv_kernel)
//   dQ = dS K * dh^-1/2                      (flash_bwd_dq_kernel)
//
// where cap'(S) = 1 - tanh^2 is the soft-cap's derivative, applied after
// the mask (masked entries have P = 0, so they carry no gradient).  P is set
// to 0 wherever the mask hides a column, so a row that sees no key at all
// (Sq > Skv under the causal mask) gets zero gradients, not NaN.
//
// Deterministic by construction: no atomics.  Each dK/dV block owns one KV
// tile of one kv-head and walks, in a fixed order, every q-head of its GQA
// group and every Q tile that can see its columns; each dQ block owns one
// Q tile of one q-head and walks its visible KV tiles.  Every output element
// is summed by one thread in one order, so two calls give equal bits.
//
// Bound on an H100 SXM at llama3-8b's prefill shape (B=4, H=32, Kv=8,
// S=2048, dh=128, causal): the forward's 4 dh operations per visible pair,
// 137.5 GFLOP, times 2.5 for the backward's five products (two of them the
// recomputed S and dP) is 344 GFLOP: 5.13 ms at float32 CUDA-core peak (67
// TFLOP/s).  The float32 route stays on CUDA cores because its parity
// tolerance (rel 1e-4) rules out TF32 products.
//
// The first design (PR 18) took 40.5 ms there, 12.7% of that bound and
// 2.56x SDPA's float32 backward (15.8 ms; H100 80GB HBM3, 700 W), slower
// than its own plain version.  Shared-memory loads set its pace: each step
// over dh issued 12 scalar loads for 16 FMAs (rows padded to dh + 1 floats,
// so no 16-byte loads), every tile was loaded element by element with a
// division per element and no overlap with the products, and the mask and
// the cap were tested at run time on every element of every tile.
//
// This design:
//
// * Register-blocked products, 256 threads a block.  A score tile (64 x 64
//   at dh <= 128, 32 x 32 at dh 256) gives each thread 4 x 4 (2 x 2) of S
//   and of dP, read as 16-byte loads along dh: 8 16-byte loads feed 64
//   FMAs (4 feed 16 at dh 256).  In the dK/dV kernel the first half of the block
//   accumulates dV and the second dK, 8 keys x 8 columns of dh a thread: a
//   step over the tile's rows is two 16-byte loads of P (dS) and two of dO
//   (Q) for 64 FMAs.  The dQ kernel gives each thread 4 rows x 8 columns.
//   Operand rows are row-major in dh with the 16-byte chunks swizzled by
//   row (chunk ^ row % 8; a 4-float pad where dh / 4 is not a multiple of
//   8), so both the loads along dh of 8 different rows and those along one
//   row hit distinct banks.
// * Asynchronous staging.  The walked tile (Q, dO with their L and D rows
//   in the dK/dV kernel; K, V in the dQ kernel) is copied by cp.async into
//   a second buffer while the current one is multiplied: two barriers a
//   tile, no per-element division.  16-byte copies where every base and
//   stride allows them, 4-byte copies otherwise; rows past Sq or Skv are
//   zero-filled.
// * Masks and cap at compile time.  Only tiles that the diagonal, the
//   window's edge or a ragged end crosses test each element; the others run
//   an instantiation without the test.  The soft-cap is a template flag.
// * Heaviest tiles first: under the causal mask the first KV tiles and the
//   last Q tiles see the most rows; the tile index is the slowest grid
//   dimension, so they start first.
// * dh 256 takes 32-row tiles, so its accumulators (8 keys x 8 columns of
//   dK or dV, 4 rows x 8 columns of dQ a thread) stay in registers as at dh
//   128; no instantiation spills.
//
// Where it stands (chip_smoke, PR 20, H100 80GB HBM3, 700 W): at llama3's
// shape about 36% of the bound and below SDPA's float32 backward.  Its
// seven products (S and dP are computed by both kernels) run at about half
// the float32 rate; splitting the dK/dV products between the two halves of
// the block, or unrolling its loops further, moved it little.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDeltaRows = 8;  // rows a delta block covers (one warp a row)
constexpr float kLog2e = 1.4426950408889634f;

struct Tensor4 {  // a (batch, head, seq, dh) operand: base and element strides
  const void* ptr;
  long long sb, sh, ss;
};

struct Params {
  Tensor4 q, k, v, o, dout, dq, dk, dv;
  const float* lse;  // (B, H, Sq) float32, natural log units
  float* delta;      // (B, H, Sq) float32 scratch: rowsum(dO * O)
  int heads, kv_heads, sq, skv;
  float scale;
  int causal, window;
  float logit_cap;
  int vec;  // every operand's base and strides allow 16-byte copies and stores
};

__device__ __forceinline__ const float* row_ptr(const Tensor4& t, int b, int h, int s) {
  return static_cast<const float*>(t.ptr) + b * t.sb + h * t.sh + s * t.ss;
}

__device__ __forceinline__ float* row_ptr_mut(const Tensor4& t, int b, int h, int s) {
  return const_cast<float*>(row_ptr(t, b, h, s));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float (&acc)[4], float a, const float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// A tile of rows of COLS floats in shared memory: the float index of the
// 16-byte chunk `c` of row `r`.  Chunks are swizzled by the row (c ^ r % 8)
// where a row holds a multiple of 8 chunks, else rows are padded by one
// chunk (an odd number of chunks a row): either way eight rows' chunk c, or
// one row's eight neighbouring chunks, lie in eight different bank groups.
template <int COLS>
struct Rows {
  static constexpr int kChunks = COLS / 4;
  static constexpr bool kSwizzle = kChunks % 8 == 0;
  static_assert(kSwizzle || kChunks % 2 == 0, "rows of an even number of chunks");
  static constexpr int kLd = kSwizzle ? COLS : COLS + 4;
  __device__ __forceinline__ static int at(int r, int c) {
    return r * kLd + 4 * (kSwizzle ? (c ^ (r & 7)) : c);
  }
};

// Issue the copies of rows [s0, s0 + ROWS) of a (B, H, S, DH) operand into
// `dst` (layout Rows<DH>); rows at or past `limit` are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const Tensor4& t, int b, int h, int s0,
                                           int limit, bool vec) {
  constexpr int kChunks = DH / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;  // constant divisors
    const bool valid = s0 + r < limit;
    const float* src = row_ptr(t, b, h, valid ? s0 + r : 0) + 4 * c;
    float* d = dst + Rows<DH>::at(r, c);
    if (vec) {
      copy16(d, src, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) copy4(d + e, src + e, valid);
    }
  }
}

// Issue the copies of `rows` floats of a (B, H, S) row vector from s0,
// zero-filled at or past `limit`.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int s0, int rows,
                                          int limit) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool valid = s0 + i < limit;
    copy4(dst + i, src + (valid ? s0 + i : 0), valid);
  }
}

// The tiles of one dh: a score tile of BM owner rows (the block's keys, or
// its q rows) by BN walked rows.
template <int DH>
struct Shape {
  static constexpr int BM = DH <= 128 ? 64 : 32;
  static constexpr int BN = BM;
  static constexpr int MI = BM / 16, NJ = BN / 16;  // a thread's score tile
  // the gradient tile BM x DH: 4 rows a thread, chunks tx + TX * j of dh
  static constexpr int TY = BM / 4;
  static constexpr int TX = kThreads / TY;
  static constexpr int NC = (DH / 4 + TX - 1) / TX;
  // dK and dV split between the two halves of the block: BM x DH each, 8
  // rows a thread, chunks cx + CX * j of dh
  static constexpr int KY = BM / 8;
  static constexpr int CX = kThreads / 2 / KY;
  static constexpr int NK = (DH / 4 + CX - 1) / CX;
  static constexpr int kTile = BM * Rows<DH>::kLd;  // floats of one staged operand tile
  static constexpr int kScores = BN * Rows<BM>::kLd;  // floats of a (walked x owner) tile
  static_assert(BM == BN && kThreads == 256, "square tiles of 16 x 16 threads");
};

// The score tile's thread layout: a warp covers 4 owner rows x 8 walked
// rows (4 distinct 16-byte loads of A and 8 of B a step), 8 warps 4 x 2.
__device__ __forceinline__ int owner_thread() { return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8; }
__device__ __forceinline__ int walked_thread() {
  return ((threadIdx.x / 32) % 2) * 8 + threadIdx.x % 8;
}

// s[i][j] = sum_d a1[tm + 16i][d] b1[tn + 16j][d] and dp likewise from a2,
// b2, in order of d.
template <int DH, int MI, int NJ>
__device__ __forceinline__ void score_products(const float* a1, const float* b1, const float* a2,
                                               const float* b2, int tm, int tn,
                                               float (&s)[MI][NJ], float (&dp)[MI][NJ]) {
  using L = Rows<DH>;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.0f;
  const int am = tm * L::kLd, bn = tn * L::kLd;
  const int xm = tm & 7, xn = tn & 7;
#pragma unroll 4
  for (int c = 0; c < L::kChunks; ++c) {
    const int ca = 4 * (L::kSwizzle ? (c ^ xm) : c) + am;
    const int cb = 4 * (L::kSwizzle ? (c ^ xn) : c) + bn;
    float4 av[MI], bv[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) av[i] = ld4(a1 + ca + 16 * i * L::kLd);
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = ld4(b1 + cb + 16 * j * L::kLd);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dot4(av[i], bv[j], s[i][j]);
#pragma unroll
    for (int i = 0; i < MI; ++i) av[i] = ld4(a2 + ca + 16 * i * L::kLd);
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = ld4(b2 + cb + 16 * j * L::kLd);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dp[i][j] = dot4(av[i], bv[j], dp[i][j]);
  }
}

// The elementwise step of one score entry: P and dS from S, dP, the row's
// L (log2 units) and D.  Masked entries give P = dS = 0.
template <bool CAP>
__device__ __forceinline__ void probs(const Params& p, float s, float dp, float l2, float dd,
                                      bool visible, float& pr, float& ds) {
  float x = s * p.scale;
  float dcap = 1.0f;
  if constexpr (CAP) {
    const float t = tanhf(x / p.logit_cap);
    x = p.logit_cap * t;
    dcap = 1.0f - t * t;
  }
  pr = visible ? exp2_approx(fmaf(x, kLog2e, -l2)) : 0.0f;
  ds = pr * (dp - dd) * dcap;
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  const int pos = row + p.skv - p.sq;
  bool ok = row < p.sq && col < p.skv;
  if (p.causal) ok = ok && col <= pos;
  if (p.window > 0) ok = ok && col > pos - p.window;
  return ok;
}

// whether every entry of rows [r0, r0 + rows) x columns [c0, c0 + cols) is visible
__device__ __forceinline__ bool tile_visible(const Params& p, int r0, int rows, int c0, int cols) {
  const int off = p.skv - p.sq;
  bool ok = r0 + rows <= p.sq && c0 + cols <= p.skv;
  if (p.causal) ok = ok && c0 + cols - 1 <= r0 + off;
  if (p.window > 0) ok = ok && c0 > r0 + rows - 1 + off - p.window;
  return ok;
}

// ---- D = rowsum(dO * O) -----------------------------------------------------

__global__ void __launch_bounds__(32 * kDeltaRows) flash_bwd_delta_kernel(const Params p, int dh) {
  const int row = blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.sq) return;
  const float* o = row_ptr(p.o, b, h, row);
  const float* dout = row_ptr(p.dout, b, h, row);
  float sum = 0.0f;
  for (int d = lane; d < dh; d += 32) sum = fmaf(o[d], dout[d], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.heads + h) * p.sq + row] = sum;
}

// Store a thread's R rows x NC chunks (tx + TX j) of a gradient tile,
// times `mul`.
template <int DH, int R, int NC, int TX>
__device__ __forceinline__ void store_rows(const Params& p, const Tensor4& t, int b, int h, int r0,
                                           int limit, int tx, const float (&acc)[R][NC][4],
                                           float mul) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i >= limit) continue;
    float* dst = row_ptr_mut(t, b, h, r0 + i);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + TX * j;
      if (c >= DH / 4) continue;
      const float4 v = make_float4(acc[i][j][0] * mul, acc[i][j][1] * mul, acc[i][j][2] * mul,
                                   acc[i][j][3] * mul);
      if (p.vec) {
        *reinterpret_cast<float4*>(dst + 4 * c) = v;
      } else {
        dst[4 * c] = v.x;
        dst[4 * c + 1] = v.y;
        dst[4 * c + 2] = v.z;
        dst[4 * c + 3] = v.w;
      }
    }
  }
}

// ---- dK, dV: one block per (KV tile, kv-head, batch) ---------------------------

template <int DH>
struct DkdvSmem {
  using S = Shape<DH>;
  // ks, vs | qs[2], dos[2] | ps, dss | lse[2], delta[2]
  static constexpr int kFloats = 6 * S::kTile + 2 * S::kScores + 4 * S::BN;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int DH, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(const Params p) {
  using S = Shape<DH>;
  using L = Rows<DH>;
  using LP = Rows<S::BM>;
  constexpr int BM = S::BM, BN = S::BN, MI = S::MI, NJ = S::NJ, NK = S::NK;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + S::kTile;
  float* qs = vs + S::kTile;          // [2][kTile]
  float* dos = qs + 2 * S::kTile;     // [2][kTile]
  float* ps = dos + 2 * S::kTile;     // P^T as (q row, key)
  float* dss = ps + S::kScores;       // dS^T as (q row, key)
  float* lse_s = dss + S::kScores;    // [2][BN]
  float* delta_s = lse_s + 2 * BN;    // [2][BN]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BM;  // heaviest (first) KV tiles first
  const int group = p.heads / p.kv_heads;
  const int q_offset = p.skv - p.sq;
  const bool vec = p.vec;

  // the q rows some column of this tile is visible to: [r_lo, r_hi)
  int r_lo = 0, r_hi = p.sq;
  if (p.causal) r_lo = max(0, k0 - q_offset);
  if (p.window > 0) r_hi = min(r_hi, k0 + BM - 1 + p.window - q_offset);
  const int q_first = r_lo / BN * BN;
  const int q_tiles = r_hi > q_first ? (r_hi - q_first + BN - 1) / BN : 0;
  const int walk = group * q_tiles;

  auto stage_walked = [&](int w, int buf) {
    const int h = kvh * group + w / q_tiles;
    const int q0 = q_first + (w % q_tiles) * BN;
    const long long rows = (static_cast<long long>(b) * p.heads + h) * p.sq;
    stage_rows<DH, BN>(qs + buf * S::kTile, p.q, b, h, q0, p.sq, vec);
    stage_rows<DH, BN>(dos + buf * S::kTile, p.dout, b, h, q0, p.sq, vec);
    stage_vec(lse_s + buf * BN, p.lse + rows, q0, BN, p.sq);
    stage_vec(delta_s + buf * BN, p.delta + rows, q0, BN, p.sq);
  };

  stage_rows<DH, BM>(ks, p.k, b, kvh, k0, p.skv, vec);
  stage_rows<DH, BM>(vs, p.v, b, kvh, k0, p.skv, vec);
  if (walk > 0) stage_walked(0, 0);
  commit();

  const int tm = owner_thread(), tn = walked_thread();
  // the first half of the block accumulates dV = P^T dO, the second dK =
  // dS^T Q: 8 keys x NK chunks of dh a thread
  const int half = threadIdx.x / (kThreads / 2);
  const int cx = threadIdx.x % S::CX, ky = threadIdx.x % (kThreads / 2) / S::CX;
  const float* grad_scores = half ? dss : ps;
  float acc[8][NK][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int w = 0; w < walk; ++w) {
    const int buf = w & 1;
    wait_copies();
    __syncthreads();  // tile w landed; tile w - 1's buffers, P and dS are free
    if (w + 1 < walk) stage_walked(w + 1, buf ^ 1);
    commit();
    const float* qb = qs + buf * S::kTile;
    const float* dob = dos + buf * S::kTile;
    const int q0 = q_first + (w % q_tiles) * BN;

    // S^T = K Q^T and dP^T = V dO^T: owner rows are keys, walked rows queries
    float s[MI][NJ], dp[MI][NJ];
    score_products<DH, MI, NJ>(ks, qb, vs, dob, tm, tn, s, dp);
    float l2[NJ], dd[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      l2[j] = lse_s[buf * BN + tn + 16 * j] * kLog2e;
      dd[j] = delta_s[buf * BN + tn + 16 * j];
    }
    auto write = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int key = tm + 16 * i, row = tn + 16 * j;
          bool vis = true;
          if constexpr (decltype(masked)::value) vis = visible(p, q0 + row, k0 + key);
          float pr, ds;
          probs<CAP>(p, s[i][j], dp[i][j], l2[j], dd[j], vis, pr, ds);
          const int at = LP::at(row, key / 4) + key % 4;
          ps[at] = pr;
          dss[at] = ds;
        }
    };
    if (tile_visible(p, q0, BN, k0, BM)) {
      write(std::false_type{});
    } else {
      write(std::true_type{});
    }
    __syncthreads();  // P^T and dS^T complete

    // dV += P^T dO (first half), dK += dS^T Q (second half) over the
    // tile's rows, in row order
    const float* rows_b = half ? qb : dob;
#pragma unroll 8
    for (int r = 0; r < BN; ++r) {
      const float4 s0 = ld4(grad_scores + LP::at(r, 2 * ky));
      const float4 s1 = ld4(grad_scores + LP::at(r, 2 * ky + 1));
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int c = cx + S::CX * j;
        if (DH / 4 % S::CX != 0 && c >= DH / 4) continue;
        const float4 bv = ld4(rows_b + L::at(r, c));
#pragma unroll
        for (int i = 0; i < 8; ++i) axpy4(acc[i][j], sv[i], bv);
      }
    }
  }

  store_rows<DH, 8, NK, S::CX>(p, half ? p.dk : p.dv, b, kvh, k0 + 8 * ky, p.skv, cx, acc,
                               half ? p.scale : 1.0f);
}

// ---- dQ: one block per (Q tile, q-head, batch) ---------------------------------

template <int DH>
struct DqSmem {
  using S = Shape<DH>;
  // qs, dos | ks[2], vs[2] | dS^T | lse, delta
  static constexpr int kFloats = 6 * S::kTile + S::kScores + 2 * S::BM;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int DH, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const Params p) {
  using S = Shape<DH>;
  using L = Rows<DH>;
  using LP = Rows<S::BM>;
  constexpr int BM = S::BM, BN = S::BN, MI = S::MI, NJ = S::NJ, NC = S::NC, TX = S::TX;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + S::kTile;
  float* ks = dos + S::kTile;        // [2][kTile]
  float* vs = ks + 2 * S::kTile;     // [2][kTile]
  float* dst = vs + 2 * S::kTile;    // dS^T as (key, q row)
  float* lse_s = dst + S::kScores;
  float* delta_s = lse_s + BM;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest causal tiles first
  const int kvh = h / (p.heads / p.kv_heads);
  const int q_offset = p.skv - p.sq;
  const bool vec = p.vec;

  // the KV tiles some row of this tile can see
  const int pos_min = q_offset + q0;
  const int pos_max = q_offset + min(q0 + BM, p.sq) - 1;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, pos_max + 1);
  if (p.window > 0) kv_lo = max(0, pos_min - p.window + 1) / BN * BN;
  const int walk = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;

  const long long rows = (static_cast<long long>(b) * p.heads + h) * p.sq;
  stage_rows<DH, BM>(qs, p.q, b, h, q0, p.sq, vec);
  stage_rows<DH, BM>(dos, p.dout, b, h, q0, p.sq, vec);
  stage_vec(lse_s, p.lse + rows, q0, BM, p.sq);
  stage_vec(delta_s, p.delta + rows, q0, BM, p.sq);
  if (walk > 0) {
    stage_rows<DH, BN>(ks, p.k, b, kvh, kv_lo, p.skv, vec);
    stage_rows<DH, BN>(vs, p.v, b, kvh, kv_lo, p.skv, vec);
  }
  commit();

  const int tm = owner_thread(), tn = walked_thread();
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float dq[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][j][e] = 0.0f;

  float l2[MI], dd[MI];
  for (int w = 0; w < walk; ++w) {
    const int buf = w & 1;
    const int k0 = kv_lo + w * BN;
    wait_copies();
    __syncthreads();  // tile w landed; tile w - 1's buffers and dS are free
    if (w + 1 < walk) {
      stage_rows<DH, BN>(ks + (buf ^ 1) * S::kTile, p.k, b, kvh, k0 + BN, p.skv, vec);
      stage_rows<DH, BN>(vs + (buf ^ 1) * S::kTile, p.v, b, kvh, k0 + BN, p.skv, vec);
    }
    commit();
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        l2[i] = lse_s[tm + 16 * i] * kLog2e;
        dd[i] = delta_s[tm + 16 * i];
      }
    }
    const float* kb = ks + buf * S::kTile;
    const float* vb = vs + buf * S::kTile;

    // S = Q K^T and dP = dO V^T: owner rows are queries, walked rows keys
    float s[MI][NJ], dp[MI][NJ];
    score_products<DH, MI, NJ>(qs, kb, dos, vb, tm, tn, s, dp);
    auto write = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int row = tm + 16 * i, key = tn + 16 * j;
          bool vis = true;
          if constexpr (decltype(masked)::value) vis = visible(p, q0 + row, k0 + key);
          float pr, ds;
          probs<CAP>(p, s[i][j], dp[i][j], l2[i], dd[i], vis, pr, ds);
          dst[LP::at(key, row / 4) + row % 4] = ds;
        }
    };
    if (tile_visible(p, q0, BM, k0, BN)) {
      write(std::false_type{});
    } else {
      write(std::true_type{});
    }
    __syncthreads();  // dS^T complete

    // dQ += dS K over the tile's keys, in key order
#pragma unroll 8
    for (int kk = 0; kk < BN; ++kk) {
      const float4 da = ld4(dst + LP::at(kk, ty));
      const float dv4[4] = {da.x, da.y, da.z, da.w};
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + TX * j;
        if (DH / 4 % TX != 0 && c >= DH / 4) continue;
        const float4 kv = ld4(kb + L::at(kk, c));
#pragma unroll
        for (int i = 0; i < 4; ++i) axpy4(dq[i][j], dv4[i], kv);
      }
    }
  }

  store_rows<DH, 4, NC, TX>(p, p.dq, b, h, q0 + 4 * ty, p.sq, tx, dq, p.scale);
}

// ---- host side ----------------------------------------------------------------

template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH, bool CAP>
cudaError_t launch_passes(const Params& p, int batch, cudaStream_t stream) {
  using S = Shape<DH>;
  auto dk_kernel = flash_bwd_dkdv_kernel<DH, CAP>;
  auto dq_kernel = flash_bwd_dq_kernel<DH, CAP>;
  // the shared-memory limits belong to the instantiations: raised once
  static const cudaError_t attr_err = [&] {
    const cudaError_t e = raise_smem(dk_kernel, DkdvSmem<DH>::kBytes);
    return e != cudaSuccess ? e : raise_smem(dq_kernel, DqSmem<DH>::kBytes);
  }();
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 dk_grid(p.kv_heads, batch, (p.skv + S::BM - 1) / S::BM);
  dk_kernel<<<dk_grid, kThreads, DkdvSmem<DH>::kBytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(p.heads, batch, (p.sq + S::BM - 1) / S::BM);
  dq_kernel<<<dq_grid, kThreads, DqSmem<DH>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 delta_grid((p.sq + kDeltaRows - 1) / kDeltaRows, p.heads, batch);
  flash_bwd_delta_kernel<<<delta_grid, 32 * kDeltaRows, 0, stream>>>(p, DH);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return p.logit_cap > 0.0f ? launch_passes<DH, true>(p, batch, stream)
                            : launch_passes<DH, false>(p, batch, stream);
}

cudaError_t dispatch_dh(const Params& p, int batch, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<16>(p, batch, stream);
    case 32: return launch<32>(p, batch, stream);
    case 64: return launch<64>(p, batch, stream);
    case 80: return launch<80>(p, batch, stream);
    case 128: return launch<128>(p, batch, stream);
    case 256: return launch<256>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const Tensor4& t) {
  return reinterpret_cast<uintptr_t>(t.ptr) % 16 == 0 && t.sb % 4 == 0 && t.sh % 4 == 0 &&
         t.ss % 4 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes).  `ptrs` holds the base addresses
// of q, k, v, o, dO, dQ, dK and dV (in that order; dQ, dK, dV written), all
// float32 (`dtype` 0; flash_attention_bwd_bf16.cu exports the same entry
// point for bfloat16) with a contiguous dh; `strides` their
// (batch, head, seq) element strides, 24 values in the same order.  `lse`
// is the forward's float32 (B, H, Sq) log-sum-exp, `delta` float32 (B, H,
// Sq) scratch, both contiguous.  Launches three kernels on `stream` (D, then
// dK and dV, then dQ), does not synchronise, allocates nothing.  Returns the
// first launch error, or cudaErrorInvalidValue for an unknown dtype, a head
// dim without an instantiation, an empty shape or heads % kv_heads != 0.
extern "C" int flash_attention_bwd(const void* const* ptrs, const long long* strides,
                                   const float* lse, float* delta, int dtype, int batch,
                                   int heads, int kv_heads, int sq, int skv, int dh, float scale,
                                   int causal, int window, float logit_cap, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || sq <= 0 || skv <= 0 ||
      heads % kv_heads != 0 || dtype != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tensor4 t[8];
  bool vec = true;
  for (int i = 0; i < 8; ++i) {
    t[i] = Tensor4{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    vec = vec && aligned16(t[i]);
  }
  const Params p{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], lse, delta,
                 heads, kv_heads, sq, skv, scale, causal, window, logit_cap, vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_dh(p, batch, dh, s));
}
