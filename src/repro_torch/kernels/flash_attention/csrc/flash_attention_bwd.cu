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
// Design: 128 threads a block; a score tile (BQ x BK) is split 16 rows x 8
// columns of threads, an accumulator tile (rows x dh) 16 x 8 as well.  The
// block stages its operands in shared memory as float32 (rows padded by one
// float against bank conflicts) and keeps its accumulators in registers.
// Tile sizes shrink with dh so the accumulators stay near 64 registers a
// thread: at dh 256 (gemma2's) a dK/dV block holds 16 keys and a dQ block
// 16 rows, in about 100 KB of shared memory.  Ragged Sq and Skv are masked
// (out-of-range rows and columns load as zeros and are never stored).
//
// Bound on an H100 SXM at llama3-8b's prefill shape (B=4, H=32, Kv=8,
// S=2048, dh=128, causal): the forward's 4 dh operations per visible pair,
// 137.5 GFLOP, times 2.5 for the backward's five products (two of them the
// recomputed S and dP) is 344 GFLOP: 5.1 ms at float32 CUDA-core peak (67
// TFLOP/s).  The float32 route stays on CUDA cores because its parity
// tolerance (rel 1e-4) rules out TF32 products.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRowThreads = 16;  // threads along the rows of a tile
constexpr int kColThreads = 8;   // threads along its columns
constexpr int kDeltaRows = 8;    // rows a delta block covers (one warp a row)

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
};

__device__ __forceinline__ const float* row_ptr(const Tensor4& t, int b, int h, int s) {
  return static_cast<const float*>(t.ptr) + b * t.sb + h * t.sh + s * t.ss;
}

__device__ __forceinline__ float* row_ptr_mut(const Tensor4& t, int b, int h, int s) {
  return const_cast<float*>(row_ptr(t, b, h, s));
}

// whether query row `row` (index into Sq) may attend key `col`
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  const int pos = row + p.skv - p.sq;
  bool ok = row < p.sq && col < p.skv;
  if (p.causal) ok = ok && col <= pos;
  if (p.window > 0) ok = ok && col > pos - p.window;
  return ok;
}

// Stage `rows` rows of a (B, H, S, DH) operand, starting at row s0, into
// shared memory as float32 with leading dimension LD; rows past `limit`
// load as zeros.
template <int DH, int LD>
__device__ __forceinline__ void stage(float* dst, const Tensor4& t, int b, int h, int s0,
                                      int rows, int limit) {
  for (int i = threadIdx.x; i < rows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int s = s0 + r;
    dst[r * LD + d] = s < limit ? row_ptr(t, b, h, s)[d] : 0.0f;
  }
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

// ---- the score tile shared by both passes ------------------------------------
//
// For rows q0 .. q0+BQ-1 and columns k0 .. k0+BK-1 held in shared memory
// (qs, dos: BQ x DH; ks, vs: BK x DH, leading dimension LD), writes
// P = exp(S - L) and dS = P * (dP - D) * cap'(S) for this thread's RPT x CPT
// entries: into `ps` (when not null) and `dss`, leading dimension LDP.
template <int DH, int BQ, int BK, int LD, int LDP>
__device__ __forceinline__ void score_tile(const Params& p, const float* qs, const float* dos,
                                           const float* ks, const float* vs, const float* lse_s,
                                           const float* delta_s, float* ps, float* dss, int q0,
                                           int k0) {
  constexpr int RPT = BQ / kRowThreads;
  constexpr int CPT = BK / kColThreads;
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qa[RPT], da[RPT], kb[CPT], vb[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qa[i] = qs[(ty + kRowThreads * i) * LD + d];
      da[i] = dos[(ty + kRowThreads * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kb[j] = ks[(tx + kColThreads * j) * LD + d];
      vb[j] = vs[(tx + kColThreads * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
  const bool capped = p.logit_cap > 0.0f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + kRowThreads * i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + kColThreads * j;
      float x = s[i][j] * p.scale;
      float dcap = 1.0f;
      if (capped) {
        const float t = tanhf(x / p.logit_cap);
        x = p.logit_cap * t;
        dcap = 1.0f - t * t;
      }
      const float pr = visible(p, q0 + r, k0 + c) ? __expf(x - lse_s[r]) : 0.0f;
      if (ps != nullptr) ps[r * LDP + c] = pr;
      dss[r * LDP + c] = pr * (dp[i][j] - delta_s[r]) * dcap;
    }
  }
}

// ---- dK, dV: one block per (KV tile, kv-head, batch) ---------------------------

template <int DH, int BQ, int BK>
struct DkdvTile {
  static constexpr int LD = DH + 1;
  static constexpr int LDP = BK + 1;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LDP + 2 * BQ);
};

template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Params p) {
  using L = DkdvTile<DH, BQ, BK>;
  constexpr int LD = L::LD, LDP = L::LDP;
  constexpr int KPT = BK / kRowThreads;  // keys a thread accumulates
  constexpr int DPT = DH / kColThreads;  // columns of dh a thread accumulates
  static_assert(BK % kRowThreads == 0 && BQ % kRowThreads == 0 && BK % kColThreads == 0 &&
                DH % kColThreads == 0, "tile shape");
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * LDP;
  float* lse_s = dss + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int q_offset = p.skv - p.sq;

  stage<DH, LD>(ks, p.k, b, kvh, k0, BK, p.skv);
  stage<DH, LD>(vs, p.v, b, kvh, k0, BK, p.skv);

  // the q rows some column of this tile is visible to
  int r_lo = 0, r_hi = p.sq;  // [r_lo, r_hi)
  if (p.causal) r_lo = max(0, k0 - q_offset);
  if (p.window > 0) r_hi = min(r_hi, k0 + BK - 1 + p.window - q_offset);
  const int q_first = r_lo / BQ * BQ;

  float dk[KPT][DPT], dv[KPT][DPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const float* lse_g = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
    const float* delta_g = p.delta + (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int q0 = q_first; q0 < r_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's qs, dos, ps and dss are no longer read
      stage<DH, LD>(qs, p.q, b, h, q0, BQ, p.sq);
      stage<DH, LD>(dos, p.dout, b, h, q0, BQ, p.sq);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < p.sq;
        lse_s[r] = in ? lse_g[q0 + r] : 0.0f;
        delta_s[r] = in ? delta_g[q0 + r] : 0.0f;
      }
      __syncthreads();
      score_tile<DH, BQ, BK, LD, LDP>(p, qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0);
      __syncthreads();  // P and dS complete
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[KPT], dsr[KPT], dov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          pr[i] = ps[r * LDP + ty + kRowThreads * i];
          dsr[i] = dss[r * LDP + ty + kRowThreads * i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dov[j] = dos[r * LD + tx + kColThreads * j];
          qv[j] = qs[r * LD + tx + kColThreads * j];
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            dv[i][j] = fmaf(pr[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(dsr[i], qv[j], dk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int col = k0 + ty + kRowThreads * i;
    if (col < p.skv) {
      float* dkg = row_ptr_mut(p.dk, b, kvh, col);
      float* dvg = row_ptr_mut(p.dv, b, kvh, col);
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        dkg[tx + kColThreads * j] = dk[i][j] * p.scale;
        dvg[tx + kColThreads * j] = dv[i][j];
      }
    }
  }
}

// ---- dQ: one block per (Q tile, q-head, batch) ---------------------------------

template <int DH, int BQ, int BK>
struct DqTile {
  static constexpr int LD = DH + 1;
  static constexpr int LDP = BK + 1;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LDP + 2 * BQ);
};

template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  using L = DqTile<DH, BQ, BK>;
  constexpr int LD = L::LD, LDP = L::LDP;
  constexpr int RPT = BQ / kRowThreads;
  constexpr int DPT = DH / kColThreads;
  static_assert(BQ % kRowThreads == 0 && BK % kColThreads == 0 && DH % kColThreads == 0,
                "tile shape");
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;
  float* lse_s = dss + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int q_offset = p.skv - p.sq;

  stage<DH, LD>(qs, p.q, b, h, q0, BQ, p.sq);
  stage<DH, LD>(dos, p.dout, b, h, q0, BQ, p.sq);
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < p.sq;
    lse_s[r] = in ? p.lse[row_base + q0 + r] : 0.0f;
    delta_s[r] = in ? p.delta[row_base + q0 + r] : 0.0f;
  }

  // the KV tiles some row of this tile can see
  const int pos_min = q_offset + q0;
  const int pos_max = q_offset + min(q0 + BQ, p.sq) - 1;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, pos_max + 1);
  if (p.window > 0) kv_lo = max(0, pos_min - p.window + 1) / BK * BK;

  float dq[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[i][j] = 0.0f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's ks, vs and dss are no longer read
    stage<DH, LD>(ks, p.k, b, kvh, k0, BK, p.skv);
    stage<DH, LD>(vs, p.v, b, kvh, k0, BK, p.skv);
    __syncthreads();
    score_tile<DH, BQ, BK, LD, LDP>(p, qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0);
    __syncthreads();  // dS complete
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float dsr[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsr[i] = dss[(ty + kRowThreads * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = ks[c * LD + tx + kColThreads * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dq[i][j] = fmaf(dsr[i], kv[j], dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + kRowThreads * i;
    if (row < p.sq) {
      float* dqg = row_ptr_mut(p.dq, b, h, row);
#pragma unroll
      for (int j = 0; j < DPT; ++j) dqg[tx + kColThreads * j] = dq[i][j] * p.scale;
    }
  }
}

// ---- host side ----------------------------------------------------------------

template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  // accumulators near 64 registers a thread at every dh (see the header)
  constexpr int kDqRows = DH <= 64 ? 64 : DH <= 128 ? 32 : 16;
  constexpr int kDqKeys = DH <= 64 ? 64 : 32;
  constexpr int kDkKeys = DH <= 64 ? 64 : DH <= 128 ? 32 : 16;
  constexpr int kDkRows = 32;
  using Dq = DqTile<DH, kDqRows, kDqKeys>;
  using Dk = DkdvTile<DH, kDkRows, kDkKeys>;
  auto dq_kernel = flash_bwd_dq_kernel<DH, kDqRows, kDqKeys>;
  auto dk_kernel = flash_bwd_dkdv_kernel<DH, kDkRows, kDkKeys>;
  // the shared-memory limits belong to the instantiations: raised once
  static const cudaError_t attr_err = [&] {
    const cudaError_t e = raise_smem(dq_kernel, Dq::kSmem);
    return e != cudaSuccess ? e : raise_smem(dk_kernel, Dk::kSmem);
  }();
  if (attr_err != cudaSuccess) return attr_err;

  const dim3 delta_grid((p.sq + kDeltaRows - 1) / kDeltaRows, p.heads, batch);
  flash_bwd_delta_kernel<<<delta_grid, 32 * kDeltaRows, 0, stream>>>(p, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dk_grid((p.skv + kDkKeys - 1) / kDkKeys, p.kv_heads, batch);
  dk_kernel<<<dk_grid, kThreads, Dk::kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((p.sq + kDqRows - 1) / kDqRows, p.heads, batch);
  dq_kernel<<<dq_grid, kThreads, Dq::kSmem, stream>>>(p);
  return cudaGetLastError();
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
  for (int i = 0; i < 8; ++i) {
    t[i] = Tensor4{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  const Params p{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], lse, delta,
                 heads, kv_heads, sq, skv, scale, causal, window, logit_cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_dh(p, batch, dh, s));
}
