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
// also writes each row's float32 log-sum-exp, m + log l, which the backward
// (flash_attention_bwd.cu) recomputes the probabilities from; serving
// passes a null pointer.
//
// Design:
// one block of 128 threads per (q tile of BQ rows, q-head, batch).  The
// block stages its Q tile (scaled, float32) in shared memory once, then
// walks the KV tiles (BK columns) its rows can see: tiles wholly in the
// causal future or wholly before the window are never loaded.  Per tile
// it stages K and V (float32) in shared memory, computes the BQ x BK
// scores with each thread owning BQ/16 rows x BK/8 columns, reduces the
// row max and sum across the 8 lanes that share a row with warp
// shuffles, writes P to shared memory, and adds P V into its BQ/16 rows x
// DH/8 output columns, held in registers with m and l.  Ragged Sq and
// Skv are masked here (rows past Sq are computed on zeros and not
// stored; columns past Skv are masked), so any S is taken.  Q, K, V and O
// are addressed through (batch, head, seq) strides with a unit stride
// for dh, so the model's (B, S, H, dh) layout is read without a
// transpose.  Heavier causal q tiles are scheduled first.
//
// Bound on an H100 SXM at llama3-8b's prefill shape (B=4, H=32, Kv=8,
// S=2048, dh=128, float32, causal): 4 * dh flops for each of the
// B*H*S*(S+1)/2 visible (row, col) pairs is 137.5 GFLOP, 2.05 ms at the
// 67 TFLOP/s of float32 CUDA cores; q, k, v and o are 335.5 MB, 0.100 ms
// at 3.35 TB/s.  So operations bound it.  The design is limited further by
// its shared-memory loads (12 per 32 FMAs in the score loop) and its
// occupancy (one or two 4-warp blocks per SM).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowThreads = 16;  // threads along the rows of a tile
constexpr int kColThreads = 8;   // threads along its columns (one row group per 8 lanes)
constexpr float kMaskValue = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // strides in elements: batch, head, seq
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, kv_heads, sq, skv;
  float scale;
  int causal, window;
  float logit_cap;
  float* lse;  // (B, H, Sq) float32, or null
};

template <int DH, int BQ, int BK>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float against bank conflicts; P padded too
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int RPT = BQ / kRowThreads;  // rows per thread
  constexpr int CPT = BK / kColThreads;  // score columns per thread
  constexpr int DPT = DH / kColThreads;  // output columns per thread
  constexpr int LD = DH + 1;
  constexpr int LDP = BK + 1;
  static_assert(BQ % kRowThreads == 0 && BK % kColThreads == 0 && DH % kColThreads == 0,
                "tile shape");

  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][LD]  q * scale
  float* ks = qs + BQ * LD;   // [BK][LD]
  float* vs = ks + BK * LD;   // [BK][DH]
  float* ps = vs + BK * DH;   // [BQ][LDP] probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q_offset = p.skv - p.sq;  // right-aligned queries

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int row = q0 + r;
    qs[r * LD + d] = row < p.sq ? qg[row * p.q_ss + d] * p.scale : 0.0f;
  }

  // KV tiles this q tile can see
  const int row_min = q_offset + q0;
  const int row_max = q_offset + min(q0 + BQ, p.sq) - 1;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, row_max + 1);
  if (p.window > 0) kv_lo = max(0, row_min - p.window + 1) / BK * BK;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile's K, V and P no longer read
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const int col = k0 + c;
      const bool in = col < p.skv;
      ks[c * LD + d] = in ? kg[col * p.k_ss + d] : 0.0f;
      vs[c * DH + d] = in ? vg[col * p.v_ss + d] : 0.0f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[RPT], bk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = qs[(ty + kRowThreads * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bk[j] = ks[(tx + kColThreads * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + kRowThreads * i;
      const int row = row_min + r;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + kColThreads * j;
        float x = s[i][j];
        if (p.logit_cap > 0.0f) x = p.logit_cap * tanhf(x / p.logit_cap);
        bool ok = col < p.skv;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) ok = ok && col > row - p.window;
        s[i][j] = ok ? x : kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kColThreads; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[r * LDP + tx + kColThreads * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 1; off < kColThreads; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = ps[(ty + kRowThreads * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * DH + tx + kColThreads * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + kRowThreads * i;
    if (row < p.sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        og[row * p.o_ss + tx + kColThreads * j] = acc[i][j] / denom;
      if (p.lse != nullptr && tx == 0)
        p.lse[(static_cast<long long>(b) * p.heads + h) * p.sq + row] = m[i] + logf(denom);
    }
  }
}

template <int DH>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  // dh 256 halves both tiles to keep registers (acc: 2 x 32) and shared memory
  constexpr int BQ = DH > 128 ? 32 : 64;
  constexpr int BK = DH > 128 ? 32 : 64;
  constexpr size_t smem = smem_bytes<DH, BQ, BK>();
  auto kernel = flash_fwd_kernel<DH, BQ, BK>;
  // the shared-memory limit belongs to the instantiation: raised once
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
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
  const Params p{q, k, v, o,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 heads, kv_heads, sq, skv, scale, causal, window, logit_cap, lse};
  return static_cast<int>(dispatch_dh(p, batch, dh, static_cast<cudaStream_t>(stream)));
}
