// Flash attention, forward, bfloat16 — on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (body `_kernel`, KV walk
// along a sequential grid axis with (m, l, acc) carried in VMEM scratch)
// for bfloat16 inputs; float32 inputs go to flash_attention.cu.  It
// computes
//
//   o = softmax(cap(q k^T * dh^-1/2) + mask) v,
//
// with right-aligned causal masking (query row r sits at absolute position
// r + Skv - Sq), an optional sliding window (keep col > row - window), an
// optional tanh soft-cap, GQA (q-head h reads kv-head h / (H / Kv)), the
// mask value -1e30 (a tile whose columns are all masked for a row stays
// finite and is wiped by the next live tile's rescale) and the final sum
// clamped to 1e-30, as the TPU kernel and flash_attention.cu do; for
// training it also writes each row's float32 log-sum-exp (the backward,
// flash_attention_bwd_bf16.cu, recomputes the probabilities from it;
// serving passes a null pointer).  Scores,
// the running max and sum, and the output accumulator are float32; the
// probabilities are rounded to bf16 for the P V product (at most 2^-9
// relative per weight); the output is bf16.
//
// Design: one block of three warpgroups per (128-row q tile, q-head,
// batch), heaviest causal tiles first.  Warpgroup 2 is the producer: it
// gives up registers (setmaxnreg 24) and one of its threads issues TMA
// loads — Q once, then each visible KV tile of BK keys into a ring of
// kStages stages, each stage with a "full" mbarrier (TMA bytes landed) and
// an "empty" one (both consumers done reading).  Warpgroups 0 and 1 are
// the consumers (setmaxnreg 240), 64 q rows each.  Per tile a consumer
// computes S = Q K^T with wgmma m64nBKk16 (A = Q and B = K from shared
// memory, both K-major), scales it in float32 (dh^-1/2 and log2 e folded,
// for exp2f), applies the soft-cap with tanhf and the mask (only on tiles
// that cross the causal diagonal, the window edge or Skv), takes the row
// max and sum across the 4 lanes that share a row of the accumulator,
// rescales O, rounds P to bf16 into the register A-fragment layout and
// adds P V with wgmma m64nDHPk16 (B = V from shared memory, MN-major).
// O stays in float32 registers; rows past Sq and columns past dh are not
// stored.
//
// Shared memory is laid out for TMA's 128-byte swizzle (tma.cuh): a tile of R rows
// is DHP / 64 panels of R rows x 64 bf16 (128 bytes a row), 1024-byte
// aligned, so the wgmma descriptors use the 128B-swizzle layout.  dh is
// padded to DHP, a multiple of 64, by TMA's out-of-bounds zero fill (the
// tensor maps keep the true dh): dh 16 and 32 run as 64, dh 80 as 128.
// Zero columns add nothing to q k^T and their outputs are not stored.
// Rows past Sq or Skv are zero-filled the same way; columns past Skv are
// masked.  The tensor maps are 4-d (dh, S, heads, batch) over the strides
// the caller passes, so the model's (B, S, H, dh) layout is read without
// a transpose; TMA needs a 16-byte-aligned base and strides.
//
// Shared memory: Q 128 x DHP plus kStages x (K and V, BK x DHP each):
// 160 KB at dh 128 (BK 128), 192 KB at dh 256 (BK 64), 80 KB at dh 64.
//
// Bound on an H100 SXM at llama3-8b's prefill shape (B=4, H=32, Kv=8,
// S=2048, dh=128, causal): 4 * dh flops for each of the B*H*S*(S+1)/2
// visible (row, col) pairs is 137.5 GFLOP, 0.139 ms at 989 TFLOP/s; q, k,
// v and o are 167.8 MB, 0.050 ms at 3.35 TB/s.  Operations bound it.
// Not done here: overlapping one tile's softmax with the next tile's
// products (intra-warpgroup pipelining, warpgroup ping-pong), persistent
// blocks.

#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 128;                   // q rows per block, 64 per consumer warpgroup
constexpr int kConsumerThreads = 256;      // warpgroups 0 and 1
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kStages = 2;                 // K/V ring depth
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using tma::kRowBytes;
using tma::make_map;
using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::pack_bf16;
using tma::pin;
using tma::sw128_desc;

struct Params {
  void* o;
  long long o_sb, o_sh, o_ss;  // output strides in elements: batch, head, seq
  int heads, kv_heads, sq, skv, dh;
  float scale;
  int causal, window;
  float logit_cap;
  float* lse;  // (B, H, Sq) float32, or null
};

template <int DHP, int BK>
struct Layout {
  static constexpr uint32_t kQBytes = kBQ * DHP * 2;
  static constexpr uint32_t kTileBytes = BK * DHP * 2;  // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQBytes;  // stage s: kK + s * 2 * kTileBytes
  static constexpr uint32_t kBarriers = kQBytes + kStages * 2 * kTileBytes;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of slack for alignment
  static constexpr size_t kSmem = kBarriers + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "swizzle atoms");
};

// ---- the kernel -----------------------------------------------------------

template <int DHP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<DHP, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t q_smem = base + L::kQ;
  const uint32_t bar_q = base + L::kBarriers;
  auto k_smem = [&](int s) { return base + L::kK + s * 2 * L::kTileBytes; };
  auto v_smem = [&](int s) { return k_smem(s) + L::kTileBytes; };
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q_offset = p.skv - p.sq;  // right-aligned queries

  // the KV tiles some row of this block can see
  const int row_min = q_offset + q0;
  const int row_max = q_offset + min(q0 + kBQ, p.sq) - 1;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, row_max + 1);
  if (p.window > 0) kv_lo = max(0, row_min - p.window + 1) / BK * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(bar_q, L::kQBytes);
      tma::load_tile<DHP>(q_smem, &tm_q, kBQ, q0, h, b, bar_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTileBytes);
        const int k0 = kv_lo + i * BK;
        tma::load_tile<DHP>(k_smem(s), &tm_k, BK, k0, kvh, b, full(s));
        tma::load_tile<DHP>(v_smem(s), &tm_v, BK, k0, kvh, b, full(s));
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int c0 = 2 * (lane % 4);            // its first column in each 8-column group
    const int wq0 = q0 + 64 * wg;             // the warpgroup's first q row
    const int w_first = q_offset + wq0;       // its absolute position
    const int w_last = q_offset + min(wq0 + 64, p.sq) - 1;  // last stored row's position
    const bool w_live = wq0 < p.sq;
    const bool capped = p.logit_cap > 0.0f;
    const float score_scale = capped ? p.scale / p.logit_cap : p.scale * kLog2e;
    const float cap_log2 = p.logit_cap * kLog2e;

    float o[DHP / 2];
#pragma unroll
    for (int j = 0; j < DHP / 2; ++j) o[j] = 0.0f;
    float m[2] = {kMaskValue, kMaskValue};
    float l[2] = {0.0f, 0.0f};

    mbar_wait(bar_q, 0);
    const uint32_t q_rows = q_smem + 64 * wg * kRowBytes;

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = kv_lo + i * BK;
      mbar_wait(full(s), (i / kStages) & 1);
      // a tile no row of this warpgroup can see is skipped (it would add
      // exactly nothing: every weight exp2(-1e30 - m) is 0)
      const bool skip = !w_live || (p.causal && k0 > w_last) ||
                        (p.window > 0 && k0 + BK - 1 <= w_first - p.window);
      if (!skip) {
        float sc[BK / 2];
        pin(sc);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns into the panel
          const uint64_t da = sw128_desc(q_rows + (kk / 4) * kBQ * kRowBytes + off, 16);
          const uint64_t db = sw128_desc(k_smem(s) + (kk / 4) * BK * kRowBytes + off, 16);
          wgmma::ss<BK>(sc, da, db, kk > 0);
        }
        wgmma::commit();
        wgmma::wait<0>();
        pin(sc);

        // scores in log2 units: x * dh^-1/2 * log2 e, or cap * tanh(x *
        // dh^-1/2 / cap) * log2 e
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          sc[j] = capped ? cap_log2 * tanhf(sc[j] * score_scale) : sc[j] * score_scale;
        const bool edge = k0 + BK > p.skv || (p.causal && k0 + BK - 1 > w_first) ||
                          (p.window > 0 && k0 <= w_first + 63 - p.window);
        if (edge) {
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) {
            const int col = k0 + 8 * (j / 4) + c0 + (j % 2);
            const int row = w_first + r0 + 8 * ((j / 2) % 2);
            bool ok = col < p.skv;
            if (p.causal) ok = ok && col <= row;
            if (p.window > 0) ok = ok && col > row - p.window;
            if (!ok) sc[j] = kMaskValue;
          }
        }

        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
        float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          sc[j] = exp2f(sc[j] - m[(j / 2) % 2]);
          sum[(j / 2) % 2] += sc[j];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          l[r] = l[r] * alpha[r] + sum[r];
        }
#pragma unroll
        for (int j = 0; j < DHP / 2; ++j) o[j] *= alpha[(j / 2) % 2];

        // O += P V: the score registers of keys 16 kb .. 16 kb + 15 are,
        // pairwise rounded to bf16, the A fragment of the kb-th k16 step
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
          for (int x = 0; x < 4; ++x) pa[kb][x] = pack_bf16(sc[8 * kb + 2 * x], sc[8 * kb + 2 * x + 1]);
        pin(o);
        wgmma::fence();  // orders the register writes above before the products
#pragma unroll
        for (int kb = 0; kb < BK / 16; ++kb) {
          const uint64_t db = sw128_desc(v_smem(s) + kb * 16 * kRowBytes, BK * kRowBytes);
          wgmma::rs<DHP>(o, pa[kb], db, 1);
        }
        wgmma::commit();
        wgmma::wait<0>();
        pin(o);
      }
      mbar_arrive(empty(s));
    }

    if (w_live) {
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
      const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
#pragma unroll
      for (int j = 0; j < DHP / 2; j += 2) {
        const int row = wq0 + r0 + 8 * ((j / 2) % 2);
        const int col = 8 * (j / 4) + c0;
        const float f = inv[(j / 2) % 2];
        if (row < p.sq && col < p.dh)
          *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + col) =
              __floats2bfloat162_rn(o[j] * f, o[j + 1] * f);
      }
      if (p.lse != nullptr && lane % 4 == 0) {
        // m and l are in log2 units: ln(sum e^s) = (m + log2 l) ln 2
        constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wq0 + r0 + 8 * r;
          if (row < p.sq)
            p.lse[(static_cast<long long>(b) * p.heads + h) * p.sq + row] =
                (m[r] + log2f(fmaxf(l[r], 1e-30f))) * kLn2;
        }
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

// q, k and v with their element strides (batch, head, seq)
struct Inputs {
  const void *q, *k, *v;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int batch;
};

template <int DHP, int BK>
cudaError_t launch(const Inputs& in, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Layout<DHP, BK>::kSmem;
  auto kernel = flash_fwd_bf16_kernel<DHP, BK>;
  // the shared-memory limit belongs to the instantiation: raised once
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr_err != cudaSuccess) return attr_err;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, in.q, p.dh, p.sq, p.heads, in.batch, in.q_ss, in.q_sh, in.q_sb, kBQ) ||
      !make_map(&tm_k, in.k, p.dh, p.skv, p.kv_heads, in.batch, in.k_ss, in.k_sh, in.k_sb, BK) ||
      !make_map(&tm_v, in.v, p.dh, p.skv, p.kv_heads, in.batch, in.v_ss, in.v_sh, in.v_sb, BK)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.heads, in.batch);
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes), the signature of
// flash_attention.cu's; q, k, v and o are bfloat16.  Strides are in
// elements; dh is contiguous; base addresses and the strides in bytes
// must be multiples of 16 (TMA); `lse` is null or a contiguous float32
// (B, H, Sq) buffer for the rows' log-sum-exp.  Makes q's device current in
// the calling thread, launches on `stream`, does not synchronise, allocates
// nothing.  Returns cudaGetLastError() after the
// launch (or the error of cudaFuncSetAttribute), or cudaErrorInvalidValue
// for a head dim that is not a multiple of 8 up to 256, an empty shape,
// heads % kv_heads != 0 or a tensor map the driver refuses.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int kv_heads, int sq, int skv, int dh,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, float logit_cap, float* lse, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || sq <= 0 || skv <= 0 ||
      heads % kv_heads != 0 || dh <= 0 || dh > 256 || dh % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, batch};
  const Params p{o, o_sb, o_sh, o_ss, heads, kv_heads, sq, skv, dh,
                 scale, causal, window, logit_cap, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t bound = tma::use_device_of(q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  // dh padded to 64, 128 or 256 columns; dh 256 takes 64-key tiles to fit
  // shared memory and registers
  const cudaError_t err = dh <= 64    ? launch<64, 128>(in, p, s)
                          : dh <= 128 ? launch<128, 128>(in, p, s)
                                      : launch<256, 64>(in, p, s);
  return static_cast<int>(err);
}
