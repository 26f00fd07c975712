// Flash attention, forward, float32 — on CUDA cores (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (body `_kernel`, grid
// (batch, q_head, q_block, kv_block) with the KV walk as a sequential
// "arbitrary" grid axis and (m, l, acc) carried across it in VMEM
// scratch).  No CUDA block carries state to another, so the KV walk is a
// loop inside the block instead:
//
//   o = softmax(cap(q k^T * dh^-1/2) + mask) v,
//
// with right-aligned causal masking (query row r sits at absolute
// position r + Skv - Sq), an optional sliding window (keep col > row -
// window), an optional tanh soft-cap, GQA (q-head h reads kv-head
// h / (H / Kv), K/V are never repeated), the mask value -1e30 (not -inf,
// so a tile whose columns are all masked for a row stays finite and is
// wiped by the next live tile's rescale) and the final sum clamped to
// 1e-30, all as in the TPU kernel.  This file takes float32 inputs (every
// product and sum in float32, which rules out TF32 and the bf16 tensor-core
// products); bfloat16 inputs go to flash_attention_bf16.cu.  For training it
// also writes each row's float32 log-sum-exp, m + log l in natural-log
// units, which the backward (flash_attention_bwd.cu) recomputes the
// probabilities from; serving passes a null pointer.
//
// Bound on an H100 SXM at llama3-8b's prefill shape (B=4, H=32, Kv=8,
// S=2048, dh=128, causal): 4 * dh operations for each of the
// B*H*S*(S+1)/2 visible (row, col) pairs is 137.5 GFLOP, 2.05 ms at the
// 67 TFLOP/s of float32 CUDA cores; q, k, v and o are 335.5 MB, 0.100 ms
// at 3.35 TB/s.  So operations bound it, as they do at gemma2-9b's shape
// (dh 256, window 4,096: 6.15 ms) and h2o-danube-1.8b's (dh 80, window
// 4,096: 3.85 ms).
//
// The first design of this file took 6.4259 ms at llama3's shape (32% of
// the bound) and 36.938 ms at gemma2's (17%) on an NVIDIA H100 80GB HBM3 at
// 700.00 W.  128 threads a block each held BQ/16 rows x BK/8 columns of the
// scores.  Its faults: rows of Q and K padded to dh + 1 floats, so only
// scalar shared loads (12 for 32 FMAs in the score loop, 20 for 64 in the
// P V loop, P read one column at a time); tiles staged one element at a
// time with a division per element and no overlap with the products; the
// cap and both masks tested, and expf taken, on every element of every
// tile; 4-8 warps an SM with 115 KB of shared memory at dh 128.
//
// What sets the pace on CUDA cores: an SM takes 128 FMAs a clock but
// carries only 128 bytes a clock from shared memory into registers, and a
// 16-byte load costs its bytes for every lane, shared or not.  So the
// design loads as few bytes per FMA as the registers allow:
//
// * One block of 256 threads per (q tile, q-head, batch), KV tiles of 64
//   keys.  Thread t of warp w owns R consecutive rows of the q tile
//   (R r .. R r + R - 1, r = 2w + lane / 16) and, with c = lane % 16, keys
//   c + 16j of each score tile and W = dh / 16 columns of the output
//   (chunks c + 16f where W is a multiple of 4, else columns c + 16e).
//   R = 8 and 128-row q tiles up to dh 128 (8 x 4 scores and 8 x 8 outputs
//   a thread at dh 128); R = 4 and 64-row q tiles at dh 256 (4 x 4 and
//   4 x 16).  A step of the score loop loads R + 4 chunks of 16 bytes for
//   16 R FMAs (1.5 bytes an FMA at R = 8); a key of the P V loop loads R / 4
//   chunks of P^T and W floats of V for R W FMAs (1.0 byte an FMA at dh
//   128).  A thread's score rows are its output rows, so the running max,
//   the rescale and the sum stay in registers: a row's max is reduced over
//   its 16 lanes by shuffles, its sum once at the end.
// * Q and K rows are row-major in dh, padded to a multiple of 8 chunks (dh
//   16, 80) and their 16-byte chunks swizzled by row (chunk ^ row % 8), so
//   16 lanes reading chunk c of 16 keys meet no bank conflict; P^T (key,
//   q row) is swizzled likewise; V is read along its rows and stays plain.
// * cp.async for K and V, Q staged once by the same route.  Up to dh 128
//   K and V are double-buffered: the next tile's copy runs while the
//   current one is multiplied, K and V in separate groups so the scores
//   wait for K alone.  At dh 256 the 64-key tiles leave room for one K and
//   one V buffer: this tile's V is copied during its scores, the next
//   tile's K during P V (three barriers a tile).  16-byte copies where
//   every base and stride allows them, 4-byte copies otherwise; rows past
//   Sq or Skv are zero-filled.  The scale is applied to the scores, not on
//   load, so the copies stay asynchronous.
// * Masks and the cap at compile time.  Only tiles that the diagonal, the
//   window's edge or a ragged end crosses test each element; the others run
//   the softmax without the test.  The soft-cap is a template flag.
//   log2(e) is folded into the scale, exponentials are ex2.approx
//   (MUFU.EX2); `lse` stays in natural-log units.
// * The outer steps of the score and P V loops are unrolled by two, not
//   fully: a fully unrolled dh 256 body (12,700 instructions) overflows the
//   instruction cache and ran at half speed.
// * Heavier causal q tiles start first (the q tile is the slowest grid
//   dimension, walked from the last); KV tiles wholly outside the causal or
//   window range are never loaded.
// * Shared memory: Q, K and V tiles and P^T take 224 KB at dh 128 (208 KB at
//   dh 256, 168 KB at dh 80), so one block (8 warps) an SM, with up to 255
//   registers a thread (254 at dh 128 and 256); no instantiation spills.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/flash_f32_ab.py) it takes
// 3.44 ms at llama3's shape (60% of the bound), 11.1 ms at gemma2's (55%)
// and 7.57 ms at danube's (51%).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr float kMaskValue = -1e30f;
constexpr double kLog2e = 1.4426950408889634;

struct Tensor4 {  // a (batch, head, seq, dh) operand: base and element strides
  const void* ptr;
  long long sb, sh, ss;
};

struct Params {
  Tensor4 q, k, v, o;
  float* lse;  // (B, H, Sq) float32, or null
  int heads, kv_heads, sq, skv;
  // a score t is the raw dot product q.k (no cap) or tanh(q.k * tanh_scale)
  // (cap); its logit is t * logit_scale, and exp2_scale = logit_scale * log2(e)
  float tanh_scale, logit_scale, exp2_scale;
  int causal, window;
  int vec;  // every operand's base and strides allow 16-byte copies and stores
};

__device__ __forceinline__ const float* row_ptr(const Tensor4& t, int b, int h, int s) {
  return static_cast<const float*>(t.ptr) + b * t.sb + h * t.sh + s * t.ss;
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

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// A tile of rows of COLS floats in shared memory: the float index of the
// 16-byte chunk `c` of row `r`.  Rows are padded to a multiple of 8 chunks
// (dh 16 and 80) and their chunks swizzled by the row (c ^ r % 8), so eight
// rows' chunk c, or one row's eight neighbouring chunks, lie in eight
// different bank groups.
template <int COLS>
struct Rows {
  static constexpr int kChunks = COLS / 4;
  static constexpr int kLd = (kChunks + 7) / 8 * 32;
  __device__ __forceinline__ static int at(int r, int c) { return r * kLd + 4 * (c ^ (r & 7)); }
};

// Rows read only along their length (V): row-major, unpadded.
template <int COLS>
struct PlainRows {
  static constexpr int kLd = COLS;
  __device__ __forceinline__ static int at(int r, int c) { return r * kLd + 4 * c; }
};

// Start the copies of ROWS rows of DH floats, `ss` elements apart from
// `src`, into `dst` (layout LAYOUT); rows at or past `rows` are zero-filled.
template <int DH, int ROWS, typename LAYOUT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long ss, int rows,
                                           bool vec) {
  constexpr int kChunks = DH / 4, kCopies = ROWS * kChunks;
#pragma unroll
  for (int n = 0; n < (kCopies + kThreads - 1) / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    if (kCopies % kThreads != 0 && i >= kCopies) break;
    const int r = i / kChunks, c = i % kChunks;  // constant divisors
    const bool valid = r < rows;
    const float* from = src + (valid ? r : 0) * ss + 4 * c;
    float* d = dst + LAYOUT::at(r, c);
    if (vec) {
      copy16(d, from, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) copy4(d + e, from + e, valid);
    }
  }
}

// A thread's W output columns of dh: chunks c + 16 f where W is a multiple
// of 4, else single columns c + 16 e, so that the 16 lanes of a row read
// (and store) neighbouring addresses.
template <int W>
__device__ __forceinline__ int out_col(int c, int e) {
  return W % 4 == 0 ? 4 * (c + 16 * (e / 4)) + e % 4 : c + 16 * e;
}

template <int W>
__device__ __forceinline__ void load_cols(const float* row, int c, float (&out)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int e = 0; e < W; e += 4) {
      const float4 v = ld4(row + out_col<W>(c, e));
      out[e] = v.x;
      out[e + 1] = v.y;
      out[e + 2] = v.z;
      out[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) out[e] = row[out_col<W>(c, e)];
  }
}

// The tiles of one dh.  Shared memory carries every operand to the
// registers at 128 bytes a clock an SM, against 128 FMAs a clock: the
// tiles are the largest whose register blocks fit, to load few bytes per
// FMA.
template <int DH>
struct Shape {
  static constexpr int R = DH > 128 ? 4 : 8;  // q rows of a thread
  static constexpr int BM = 16 * R;           // q rows of a block
  static constexpr int BN = 64;               // keys of a KV tile
  static constexpr int NJ = BN / 16;          // a thread's keys: c + 16 j
  static constexpr int W = DH / 16;           // a thread's output columns: out_col<W>(c, e)
  // dh 256 keeps one K and one V buffer, so that 64-key tiles fit: the next
  // tile's K is copied during P V, this tile's V during the scores
  static constexpr int kStages = DH > 128 ? 1 : 2;
  static constexpr int kQ = BM * Rows<DH>::kLd;
  static constexpr int kK = BN * Rows<DH>::kLd;
  static constexpr int kV = BN * PlainRows<DH>::kLd;
  static constexpr int kP = BN * BM;  // P^T as (key, q row): Rows<BM>
  static constexpr size_t kBytes = sizeof(float) * (kQ + kStages * (kK + kV) + kP);
  static_assert(DH % 16 == 0 && kBytes <= 232448, "tile shape");
};

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  const int pos = row + p.skv - p.sq;
  bool ok = key < p.skv;
  if (p.causal) ok = ok && key <= pos;
  if (p.window > 0) ok = ok && key > pos - p.window;
  return ok;
}

// whether every key of [k0, k0 + BN) is visible to every row of [q0, q0 + BM)
// below Sq (rows past Sq are computed on zeros and never stored)
__device__ __forceinline__ bool tile_visible(const Params& p, int q0, int bm, int k0, int bn) {
  const int off = p.skv - p.sq;
  const int last = min(q0 + bm, p.sq) - 1;
  bool ok = k0 + bn <= p.skv;
  if (p.causal) ok = ok && k0 + bn - 1 <= q0 + off;
  if (p.window > 0) ok = ok && k0 > last + off - p.window;
  return ok;
}

template <int DH, bool CAP>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Params p) {
  using S = Shape<DH>;
  using L = Rows<DH>;
  using LV = PlainRows<DH>;
  using LP = Rows<S::BM>;
  constexpr int R = S::R, BM = S::BM, BN = S::BN, NJ = S::NJ, W = S::W;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + S::kQ;            // [kStages][kK]
  float* vs = ks + kStages * S::kK;  // [kStages][kV]
  float* ps = vs + kStages * S::kV;  // P^T: (key, q row)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest causal tiles first
  const int kvh = h / (p.heads / p.kv_heads);
  const int q_offset = p.skv - p.sq;  // right-aligned queries
  const bool vec = p.vec;
  const float* kg = row_ptr(p.k, b, kvh, 0);
  const float* vg = row_ptr(p.v, b, kvh, 0);

  // the KV tiles some row of this tile can see
  const int pos_min = q_offset + q0;
  const int pos_max = q_offset + min(q0 + BM, p.sq) - 1;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, pos_max + 1);
  if (p.window > 0) kv_lo = max(0, pos_min - p.window + 1) / BN * BN;
  const int walk = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;

  auto stage_k = [&](float* dst, int k0) {
    stage_rows<DH, BN, L>(dst, kg + k0 * p.k.ss, p.k.ss, p.skv - k0, vec);
  };
  auto stage_v = [&](float* dst, int k0) {
    stage_rows<DH, BN, LV>(dst, vg + k0 * p.v.ss, p.v.ss, p.skv - k0, vec);
  };
  if (walk > 0) {
    stage_rows<DH, BM, L>(qs, row_ptr(p.q, b, h, q0), p.q.ss, p.sq - q0, vec);
    stage_k(ks, kv_lo);
    commit();
    if constexpr (kStages == 2) {
      stage_v(vs, kv_lo);
      commit();
    }
  }

  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 2 + lane / 16;  // rows R r .. R r + R - 1 of the tile
  const int c = lane % 16;  // keys c + 16 j; output columns out_col<W>(c, e)

  float m_run[R], l_run[R], acc[R][W];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m_run[i] = kMaskValue;
    l_run[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[i][e] = 0.0f;
  }

  const float* qrow = qs + R * r * L::kLd;
  const int qx = (R * r) & 7;  // (R r + i) % 8 == qx + i: the swizzle of Q row R r + i

  for (int w = 0; w < walk; ++w) {
    const int buf = kStages == 2 ? w & 1 : 0;
    const int k0 = kv_lo + w * BN;
    if constexpr (kStages == 2) {
      wait_copies<1>();  // Q and this tile's K landed (its V may be in flight)
      __syncthreads();   // ... for every thread; the previous tile's buffers and P^T are free
      if (w + 1 < walk) stage_k(ks + (buf ^ 1) * S::kK, k0 + BN);
      commit();
      if (w + 1 < walk) stage_v(vs + (buf ^ 1) * S::kV, k0 + BN);
      commit();
    } else {
      wait_copies<0>();  // Q and this tile's K landed
      __syncthreads();   // ... for every thread; the previous tile's V and P^T are free
      stage_v(vs, k0);
      commit();
    }

    // S = Q K^T over dh: rows R r + i, keys c + 16 j, in order of dh
    const float* krow = ks + buf * S::kK + c * L::kLd;
    float s[R][NJ];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.0f;
    const int kx = c & 7;  // (c + 16 j) % 8: the swizzle of K row c + 16 j
#pragma unroll 2
    for (int a = 0; a < (L::kChunks + 7) / 8; ++a) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {  // chunk 8a + x
        if (8 * a + x >= L::kChunks) break;
        float4 qv[R], kv[NJ];
#pragma unroll
        for (int i = 0; i < R; ++i) qv[i] = ld4(qrow + i * L::kLd + 32 * a + 4 * (x ^ (qx + i)));
#pragma unroll
        for (int j = 0; j < NJ; ++j) kv[j] = ld4(krow + 16 * j * L::kLd + 32 * a + 4 * (x ^ kx));
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
      }
    }

    // online softmax: the cap, the mask (crossed tiles only), the row max
    // over the row's 16 lanes, the rescale of the running sum and output
    auto softmax = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      float mx[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        mx[i] = kMaskValue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float t = s[i][j];
          if constexpr (CAP) t = tanhf(t * p.tanh_scale);
          if constexpr (kMasked) {
            if (!visible(p, q0 + R * r + i, k0 + c + 16 * j)) t = kMaskValue;
          }
          s[i][j] = t;
          mx[i] = fmaxf(mx[i], t);
        }
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
#pragma unroll
        for (int i = 0; i < R; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float m_new = fmaxf(m_run[i], mx[i]);
        const float alpha = exp2_approx((m_run[i] - m_new) * p.exp2_scale);
        const float shift = m_new * p.exp2_scale;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float e = exp2_approx(fmaf(s[i][j], p.exp2_scale, -shift));
          // a masked score weighs exp(-1e30 - m): 1 while the row has seen
          // no visible key (wiped by the first visible tile's rescale), else 0
          if constexpr (kMasked) {
            if (s[i][j] == kMaskValue) e = m_new == kMaskValue ? 1.0f : 0.0f;
          }
          s[i][j] = e;
          sum += e;
        }
        l_run[i] = l_run[i] * alpha + sum;
        m_run[i] = m_new;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[i][e] *= alpha;
      }
    };
    if (tile_visible(p, q0, BM, k0, BN)) {
      softmax(std::false_type{});
    } else {
      softmax(std::true_type{});
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
        *reinterpret_cast<float4*>(ps + LP::at(c + 16 * j, R / 4 * r + q)) =
            make_float4(s[4 * q][j], s[4 * q + 1][j], s[4 * q + 2][j], s[4 * q + 3][j]);
    if constexpr (kStages == 2) {
      wait_copies<2>();  // this tile's V landed (the next tile's K and V may be in flight)
      __syncthreads();   // P^T complete, V visible
    } else {
      __syncthreads();  // P^T complete; this tile's K no longer read
      if (w + 1 < walk) stage_k(ks, k0 + BN);
      commit();
      wait_copies<1>();  // this tile's V landed (the next tile's K may be in flight)
      __syncthreads();   // ... for every thread
    }

    // O += P V over the tile's keys, in key order
    const float* vb = vs + buf * S::kV;
#pragma unroll 2
    for (int a = 0; a < BN / 8; ++a) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int kk = 8 * a + x;
        float pr[R], vv[W];
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {  // LP::at(kk, R / 4 r + q): rows R r + 4q ..
          const float4 pv = ld4(ps + kk * BM + 4 * ((R / 4 * r + q) ^ x));
          pr[4 * q] = pv.x;
          pr[4 * q + 1] = pv.y;
          pr[4 * q + 2] = pv.z;
          pr[4 * q + 3] = pv.w;
        }
        load_cols<W>(vb + kk * LV::kLd, c, vv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < W; ++e) acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
      }
    }
  }

  // the row sums over the row's 16 lanes; normalise and store
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], off);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + R * r + i;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    float* dst = const_cast<float*>(row_ptr(p.o, b, h, row));
    if (W % 4 == 0 && vec) {
#pragma unroll
      for (int e = 0; e < W; e += 4)
        *reinterpret_cast<float4*>(dst + out_col<W>(c, e)) = make_float4(
            acc[i][e] / denom, acc[i][e + 1] / denom, acc[i][e + 2] / denom, acc[i][e + 3] / denom);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) dst[out_col<W>(c, e)] = acc[i][e] / denom;
    }
    if (p.lse != nullptr && c == 0)
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.sq + row] =
          m_run[i] * p.logit_scale + logf(denom);
  }
}

// ---- host side ----------------------------------------------------------------

template <int DH, bool CAP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using S = Shape<DH>;
  auto kernel = flash_fwd_kernel<DH, CAP>;
  // the shared-memory limit belongs to the instantiation: raised once
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kBytes));
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid(p.heads, batch, (p.sq + S::BM - 1) / S::BM);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_cap(const Params& p, int batch, bool cap, cudaStream_t stream) {
  return cap ? launch<DH, true>(p, batch, stream) : launch<DH, false>(p, batch, stream);
}

cudaError_t dispatch_dh(const Params& p, int batch, int dh, bool cap, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_cap<16>(p, batch, cap, stream);
    case 32: return launch_cap<32>(p, batch, cap, stream);
    case 64: return launch_cap<64>(p, batch, cap, stream);
    case 80: return launch_cap<80>(p, batch, cap, stream);
    case 128: return launch_cap<128>(p, batch, cap, stream);
    case 256: return launch_cap<256>(p, batch, cap, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const Tensor4& t) {
  return reinterpret_cast<uintptr_t>(t.ptr) % 16 == 0 && t.sb % 4 == 0 && t.sh % 4 == 0 &&
         t.ss % 4 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes), the signature of
// flash_attention_bf16.cu's; q, k, v and o are float32.  Strides are in
// elements; dh is contiguous; `lse` is null or a contiguous float32
// (B, H, Sq) buffer for the rows' log-sum-exp.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns cudaGetLastError() after the
// launch (or the error of cudaFuncSetAttribute), or cudaErrorInvalidValue
// for a head dim without an instantiation, an empty shape or heads %
// kv_heads != 0.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int kv_heads, int sq, int skv, int dh,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, float logit_cap, float* lse, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || sq <= 0 || skv <= 0 ||
      heads % kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tensor4 tq{q, q_sb, q_sh, q_ss}, tk{k, k_sb, k_sh, k_ss}, tv{v, v_sb, v_sh, v_ss},
      to{o, o_sb, o_sh, o_ss};
  const bool cap = logit_cap > 0.0f;
  const double logit_scale = cap ? logit_cap : scale;
  const Params p{tq, tk, tv, to, lse, heads, kv_heads, sq, skv,
                 cap ? static_cast<float>(static_cast<double>(scale) / logit_cap) : 0.0f,
                 static_cast<float>(logit_scale),
                 static_cast<float>(logit_scale * kLog2e),
                 causal, window,
                 aligned16(tq) && aligned16(tk) && aligned16(tv) && aligned16(to) ? 1 : 0};
  return static_cast<int>(dispatch_dh(p, batch, dh, cap, static_cast<cudaStream_t>(stream)));
}
