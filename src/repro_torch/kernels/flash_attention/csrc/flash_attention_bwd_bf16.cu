// Flash attention, backward, bfloat16 — on Hopper's tensor cores (sm_90a).
//
// There is no Pallas source to replace: the Pallas TPU kernel
// `flash_attention` (src/repro/kernels/flash_attention/kernel.py) has no
// backward, and the reference trains through XLA's autodiff of
// `blocked_attention` (src/repro/models/attention.py:72).  This file is the
// gradient of the port's bf16 forward (flash_attention_bf16.cu) for bf16
// inputs; float32 inputs go to flash_attention_bwd.cu (CUDA cores).  For
//
//   o = softmax(cap(q k^T * dh^-1/2) + mask) v,
//
// with right-aligned causal masking (query row r sits at absolute position
// r + Skv - Sq), an optional sliding window (keep col > row - window), an
// optional tanh soft-cap and GQA (q-head h reads kv-head h / (H / Kv)), it
// recomputes the probabilities from the forward's float32 row log-sum-exp L
// (FlashAttention-2's backward) and computes
//
//   D  = rowsum(dO * O)                          (flash_bwd_delta_kernel)
//   P  = exp(S - L),  dP = dO V^T,  dS = P * (dP - D) * cap'(S),
//   dV = P^T dO,  dK = dS^T Q * dh^-1/2          (flash_bwd_dkdv_bf16_kernel)
//   dQ = dS K * dh^-1/2                          (flash_bwd_dq_bf16_kernel)
//
// where cap'(S) = 1 - tanh^2 is the soft-cap's derivative.  P is 0 wherever
// the mask hides a column, so a row that sees no key at all (Sq > Skv under
// the causal mask) gets zero gradients, not NaN.  Every product runs on
// wgmma with float32 accumulators; P and dS are rounded to bf16 (2^-9
// relative) as the A operands of their products, as the forward rounds P.
//
// Design (the forward's machinery: tma.cuh, wgmma.cuh).  Each of the two
// passes runs blocks of three warpgroups: warpgroup 2 is the producer
// (setmaxnreg 24), one of its threads issuing TMA loads into a ring of
// kStages stages guarded by "full" and "empty" mbarriers; warpgroups 0 and
// 1 are consumers (setmaxnreg 240).  Tiles are 128B-swizzled panels of 64
// columns; dh is padded to DHP = 64, 128 or 256 by TMA's zero fill (dh 80
// runs as 128), and the score products stop at dh's last 16-column step.
// Grids put the tile index in their slowest dimension, so the tiles with
// the most causal work are launched first.
//
// - dK/dV: one block per (KV tile, kv-head, batch).  K and V are loaded
//   once; the producer then streams 64-row Q and dO tiles of every q-head
//   of the GQA group and every q tile that can see the block's keys, in a
//   fixed order, and one producer warp copies each step's L (in log2
//   units) and D into the stage beside them.  Each consumer owns 64 keys
//   and, per step, computes S^T = K Q^T and dP^T = V dO^T (wgmma ss, both
//   operands K-major over dh, in two commit groups), forms P^T in float32
//   registers with L broadcast along the columns while dP^T's product runs,
//   rounds it to bf16 in the A-fragment layout (the transposed scores land
//   in registers already shaped as rs A operands) and issues dV += P^T dO;
//   while that product runs it forms dS^T = P^T (dP^T - D) cap' and then
//   issues dK += dS^T Q (wgmma rs, B read MN-major from the same Q and dO
//   tiles).  The accumulators take DHP / 2 + DHP / 2 registers a thread and
//   the two score tiles 2 x 32: 192 at dh 128.  At dh 256 that would be 256
//   for the accumulators alone, so there both consumers take the same 64
//   keys and split dh: each accumulates 128 of the 256 columns of dK and dV
//   and recomputes S^T and dP^T over the whole dh (twice the score products
//   at dh 256, reckoned below).
// - dQ: one block per (q tile, q-head, batch): 128 q rows, 64 a consumer
//   (64 rows split over dh at dh 256, as above), walking the KV tiles its
//   rows can see: S = Q K^T and dP = dO V^T (ss, two commit groups), P
//   while dP's product runs, dS, then dQ += dS K (rs, B = K read MN-major).
//   KV tiles hold 128 keys at dh <= 64 and 64 above, which keeps dQ and
//   the two score tiles at 128-192 registers.
// - The elementwise loops hold no branch: the soft-cap and the mask are
//   compile-time flags of each loop (with_flags), chosen once a tile.  A
//   runtime test inside the loop made the compiler serialise each
//   element's chain of exponential and products, which on an H100 made the
//   loop about four times slower and the whole backward about half again
//   as slow.
// - Both passes skip tiles the causal or window mask hides entirely (the
//   r_lo / r_hi and kv_lo / kv_hi ranges, then per consumer) and apply the
//   mask only on tiles that cross the diagonal, the window edge or the
//   ragged end of Sq or Skv.  Rows past Sq and keys past Skv load as zeros
//   and are never stored.
// - Deterministic, with no atomics: each output element is accumulated by
//   one thread in one fixed order (dK and dV over the group's q-heads and q
//   tiles in order; dQ in its own pass over the KV tiles in order), so two
//   calls give equal bits, as the resume check of a training run needs.
//
// Bound on an H100 SXM: the backward's five products (two of them the
// recomputed S and dP) are 2.5 times the forward's 4 dh operations per
// visible (row, col) pair.  At llama3-8b's training shape (B=4, H=32, Kv=8,
// S=2048, dh=128, causal) that is 344 GFLOP, 0.348 ms at 989 TFLOP/s; at
// h2o-danube-1.8b's micro-batch (B=2, S=2048, dh 80) 107 GFLOP, 0.109 ms.
// The design adds, reckoned apart: seven products where the function needs
// five (dQ's pass recomputes S and dP), 1.4x; dh 80 padded to 128 in the
// three rs products (the ss products stop at dh), 1.6x on those; at dh 256
// the split recomputes S^T and dP^T in both consumers (six score products
// instead of two in the dK/dV pass); and the diagonal tiles' masked half
// (64 x 64 tiles: about 1 + 64 / S).  Danube's micro-batch therefore does
// at least 1.76x, llama3's 1.4x the function's operations.  Bytes (q, k, v,
// o, dO read, dq, dk, dv written, L) are 3-10x below the operations bound.
// Not done here: ping-pong scheduling of the two consumers (they start each
// step together on the same stage, so their products and elementwise work
// overlap only partly), persistent blocks, and a split of the GQA group
// when the dK/dV grid has fewer blocks than the card has SMs (GQA 8:1 at
// B=2: 128 blocks, the first carrying 256 steps).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kConsumerThreads = 256;             // warpgroups 0 and 1
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kStages = 2;                        // ring depth of both passes
constexpr int kBQ = 64;                           // q rows a dK/dV step
constexpr int kDeltaRows = 8;                     // rows a delta block covers (one warp a row)
constexpr float kLog2e = 1.4426950408889634f;

using tma::kPanel;
using tma::kRowBytes;
using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::pack_bf16;
using tma::pin;
using tma::sw128_desc;

struct Tensor4 {  // a (batch, head, seq, dh) operand: base and element strides
  void* ptr;
  long long sb, sh, ss;
};

struct Params {
  Tensor4 o, dout, dq, dk, dv;  // read or written with plain loads and stores
  const float* lse;             // (B, H, Sq) float32, natural log units
  float* delta;                 // (B, H, Sq) float32 scratch: rowsum(dO * O)
  int heads, kv_heads, sq, skv;
  float scale;
  int causal, window;
  float logit_cap;
};

// dh padded to the tile width; at 256 the consumers split dh
template <int DH>
struct Dims {
  static constexpr int DHP = DH <= 64 ? 64 : DH <= 128 ? 128 : 256;
  static constexpr bool kSplit = DHP == 256;
  static constexpr int DN = kSplit ? DHP / 2 : DHP;  // output columns a consumer accumulates
  static constexpr int kSteps = (DH + 15) / 16;      // k16 steps of a score product
};

// whether query row `row` (index into Sq) may attend key `col`
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  const int pos = row + p.skv - p.sq;
  bool ok = row < p.sq && col < p.skv;
  if (p.causal) ok = ok && col <= pos;
  if (p.window > 0) ok = ok && col > pos - p.window;
  return ok;
}

// a raw q.k product -> the capped, scaled score in log2 units; `dcap` is
// the cap's derivative (1 without a cap)
struct Score {
  bool capped;
  float mul, cap_log2;
  __device__ explicit Score(const Params& p)
      : capped(p.logit_cap > 0.0f),
        mul(p.logit_cap > 0.0f ? p.scale / p.logit_cap : p.scale * kLog2e),
        cap_log2(p.logit_cap * kLog2e) {}
  template <bool kCapped>
  __device__ __forceinline__ float get(float x, float& dcap) const {
    if constexpr (kCapped) {
      const float t = tanhf(x * mul);
      dcap = 1.0f - t * t;
      return cap_log2 * t;
    }
    dcap = 1.0f;
    return x * mul;
  }
};

// calls f(capped, masked) with both flags as compile-time constants, so
// that the elementwise loops over a score tile hold no branch (a branch
// in each element's chain serialises the exponentials)
template <typename F>
__device__ __forceinline__ void with_flags(bool capped, bool masked, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (capped) {
    if (masked) f(T{}, T{}); else f(T{}, N{});
  } else {
    if (masked) f(N{}, T{}); else f(N{}, N{});
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- D = rowsum(dO * O) -----------------------------------------------------

__global__ void __launch_bounds__(32 * kDeltaRows) flash_bwd_delta_kernel(const Params p, int dh) {
  const int row = blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.sq) return;
  const auto* o = reinterpret_cast<const __nv_bfloat162*>(
      static_cast<const __nv_bfloat16*>(p.o.ptr) + b * p.o.sb + h * p.o.sh + row * p.o.ss);
  const auto* dout = reinterpret_cast<const __nv_bfloat162*>(
      static_cast<const __nv_bfloat16*>(p.dout.ptr) + b * p.dout.sb + h * p.dout.sh +
      row * p.dout.ss);
  float sum = 0.0f;
  for (int d = lane; d < dh / 2; d += 32) {
    const float2 x = __bfloat1622float2(o[d]), g = __bfloat1622float2(dout[d]);
    sum = fmaf(x.x, g.x, fmaf(x.y, g.y, sum));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.heads + h) * p.sq + row] = sum;
}

// ---- dK, dV: one block per (KV tile, kv-head, batch) ---------------------------

template <int DH>
struct DkdvLayout {
  using D = Dims<DH>;
  static constexpr int BK = D::kSplit ? 64 : 128;  // keys a block
  static constexpr uint32_t kKVBytes = BK * D::DHP * 2;  // the K or the V tile
  static constexpr uint32_t kQBytes = kBQ * D::DHP * 2;  // one Q or dO tile
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kKVBytes;
  static constexpr uint32_t kStage = 2 * kKVBytes;  // stage s: Q at kStage + 2 s kQBytes, dO after
  static constexpr uint32_t kRows = kStage + kStages * 2 * kQBytes;  // stage s: [L, D][kBQ] floats
  static constexpr uint32_t kBarriers = kRows + kStages * 2 * kBQ * 4;
  // kv_full, full[kStages], empty[kStages]; 1024 bytes of slack for alignment
  static constexpr size_t kSmem = kBarriers + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kKVBytes % 1024 == 0 && kQBytes % 1024 == 0, "swizzle atoms");
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using D = Dims<DH>;
  using L = DkdvLayout<DH>;
  constexpr int BK = L::BK, DHP = D::DHP, DN = D::DN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_smem = base + L::kK, v_smem = base + L::kV;
  auto q_smem = [&](int s) { return base + L::kStage + s * 2 * L::kQBytes; };
  auto do_smem = [&](int s) { return q_smem(s) + L::kQBytes; };
  float* rows_smem = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t bar_kv = base + L::kBarriers;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + kStages + s); };

  const int k0 = blockIdx.z * BK;  // the first keys see the most causal rows: launched first
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = p.heads / p.kv_heads;
  const int q_offset = p.skv - p.sq;  // right-aligned queries

  // the q tiles some key of this block is visible to: rows [r_lo, r_hi)
  int r_lo = 0, r_hi = p.sq;
  if (p.causal) r_lo = max(0, k0 - q_offset);
  if (p.window > 0) r_hi = min(r_hi, k0 + BK - 1 + p.window - q_offset);
  const int q_first = r_lo / kBQ * kBQ;
  const int n_q = r_hi > q_first ? (r_hi - q_first + kBQ - 1) / kBQ : 0;
  const int n_tiles = group * n_q;  // step i: q-head i / n_q of the group, q tile i % n_q

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread and the rows warp
      mbar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load; one warp copies
    // each step's L (in log2 units) and D into the stage ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int pt = threadIdx.x - kConsumerThreads;
    if (pt >= 32 && pt < 64) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int h = kvh * group + i / n_q;
        const int q0 = q_first + (i % n_q) * kBQ;
        const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.sq + q0;
        float* buf = rows_smem + s * 2 * kBQ;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
#pragma unroll
        for (int r = pt - 32; r < kBQ; r += 32) {
          const bool in = q0 + r < p.sq;
          buf[r] = in ? p.lse[row0 + r] * kLog2e : 0.0f;
          buf[kBQ + r] = in ? p.delta[row0 + r] : 0.0f;
        }
        mbar_arrive(full(s));
      }
    } else if (pt == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kKVBytes);
      tma::load_tile<DHP>(k_smem, &tm_k, BK, k0, kvh, b, bar_kv);
      tma::load_tile<DHP>(v_smem, &tm_v, BK, k0, kvh, b, bar_kv);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int h = kvh * group + i / n_q;
        const int q0 = q_first + (i % n_q) * kBQ;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kQBytes);
        tma::load_tile<DHP>(q_smem(s), &tm_q, kBQ, q0, h, b, full(s));
        tma::load_tile<DHP>(do_smem(s), &tm_do, kBQ, q0, h, b, full(s));
      }
    }
  } else {
    // ---- consumers: 64 keys each (at dh 256 the same 64, half of dh each) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;  // this thread's keys: r0 and r0 + 8
    const int c0 = 2 * (lane % 4);            // its first q column in each 8-column group
    const int key_off = D::kSplit ? 0 : 64 * wg;
    const int wk0 = k0 + key_off;                 // the warpgroup's first key
    const int col0 = D::kSplit ? wg * DN : 0;     // its first dK / dV column
    const uint32_t k_rows = k_smem + key_off * kRowBytes;
    const uint32_t v_rows = v_smem + key_off * kRowBytes;
    const uint32_t slice = (col0 / kPanel) * kBQ * kRowBytes;  // its panels of Q and dO
    const Score score(p);

    float dk[DN / 2], dv[DN / 2];
#pragma unroll
    for (int j = 0; j < DN / 2; ++j) dk[j] = dv[j] = 0.0f;

    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int q0 = q_first + (i % n_q) * kBQ;
      const int pos0 = q_offset + q0;                       // the tile's first row's position
      const int pos1 = q_offset + min(q0 + kBQ, p.sq) - 1;  // its last stored row's
      mbar_wait(full(s), (i / kStages) & 1);
      // a tile none of this warpgroup's keys is visible to adds nothing
      const bool skip = wk0 >= p.skv || (p.causal && wk0 > pos1) ||
                        (p.window > 0 && wk0 + 63 <= pos0 - p.window);
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 q rows each, in two
        // commit groups so that P^T's exponentials overlap dP^T's product
        float st[kBQ / 2], dpt[kBQ / 2];
        pin(st);
        pin(dpt);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < D::kSteps; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns into the panel
          wgmma::ss<kBQ>(st, sw128_desc(k_rows + (kk / 4) * BK * kRowBytes + off, 16),
                         sw128_desc(q_smem(s) + (kk / 4) * kBQ * kRowBytes + off, 16), kk > 0);
        }
        wgmma::commit();
#pragma unroll
        for (int kk = 0; kk < D::kSteps; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma::ss<kBQ>(dpt, sw128_desc(v_rows + (kk / 4) * BK * kRowBytes + off, 16),
                         sw128_desc(do_smem(s) + (kk / 4) * kBQ * kRowBytes + off, 16), kk > 0);
        }
        wgmma::commit();
        const float* buf = rows_smem + s * 2 * kBQ;  // the step's L and D
        const bool edge = wk0 + 64 > p.skv || q0 + kBQ > p.sq ||
                          (p.causal && wk0 + 63 > pos0) ||
                          (p.window > 0 && wk0 <= pos1 - p.window);

        // P^T, rounded to bf16 A fragments (registers 8 kb .. 8 kb + 7 hold q
        // rows 16 kb .. 16 kb + 15 of the kb-th k16 step); st keeps P^T cap'
        wgmma::wait<1>();
        pin(st);
        uint32_t pa[kBQ / 16][4];
        with_flags(score.capped, edge, [&](auto capped, auto masked) {
#pragma unroll
          for (int j = 0; j < kBQ / 2; j += 2) {
            const int c = 8 * (j / 4) + c0;  // q row in the tile of st[j]; st[j + 1] is c + 1
            const float2 lse = *reinterpret_cast<const float2*>(buf + c);
            float pr[2], dcap[2];
            pr[0] = score.get<decltype(capped)::value>(st[j], dcap[0]);
            pr[1] = score.get<decltype(capped)::value>(st[j + 1], dcap[1]);
            if constexpr (decltype(masked)::value) {
              const int key = wk0 + r0 + 8 * ((j / 2) % 2);
              if (!visible(p, q0 + c, key)) pr[0] = -INFINITY;
              if (!visible(p, q0 + c + 1, key)) pr[1] = -INFINITY;
            }
            pr[0] = exp2f(pr[0] - lse.x);
            pr[1] = exp2f(pr[1] - lse.y);
            st[j] = pr[0] * dcap[0];
            st[j + 1] = pr[1] * dcap[1];
            pa[j / 8][(j % 8) / 2] = pack_bf16(pr[0], pr[1]);
          }
        });
        // dV += P^T dO runs while dS^T is formed
        pin(dv);
        wgmma::fence();
#pragma unroll
        for (int kb = 0; kb < kBQ / 16; ++kb)
          wgmma::rs<DN>(dv, pa[kb],
                        sw128_desc(do_smem(s) + slice + kb * 16 * kRowBytes, kBQ * kRowBytes), 1);
        wgmma::commit();

        wgmma::wait<1>();  // dP^T landed (groups complete in order)
        pin(dpt);
        uint32_t da[kBQ / 16][4];
#pragma unroll
        for (int j = 0; j < kBQ / 2; j += 2) {
          const float2 d = *reinterpret_cast<const float2*>(buf + kBQ + 8 * (j / 4) + c0);
          da[j / 8][(j % 8) / 2] = pack_bf16(st[j] * (dpt[j] - d.x), st[j + 1] * (dpt[j + 1] - d.y));
        }
        pin(dk);
        wgmma::fence();
#pragma unroll
        for (int kb = 0; kb < kBQ / 16; ++kb)
          wgmma::rs<DN>(dk, da[kb],
                        sw128_desc(q_smem(s) + slice + kb * 16 * kRowBytes, kBQ * kRowBytes), 1);
        wgmma::commit();
        wgmma::wait<0>();
        pin(dv);
        pin(dk);
      }
      mbar_arrive(empty(s));
    }

    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk.ptr) + b * p.dk.sb + kvh * p.dk.sh;
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv.ptr) + b * p.dv.sb + kvh * p.dv.sh;
#pragma unroll
    for (int j = 0; j < DN / 2; j += 2) {
      const int key = wk0 + r0 + 8 * ((j / 2) % 2);
      const int col = col0 + 8 * (j / 4) + c0;
      if (key < p.skv && col < DH) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + key * p.dk.ss + col) =
            __floats2bfloat162_rn(dk[j] * p.scale, dk[j + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + key * p.dv.ss + col) =
            __floats2bfloat162_rn(dv[j], dv[j + 1]);
      }
    }
  }
}

// ---- dQ: one block per (q tile, q-head, batch) ---------------------------------

template <int DH>
struct DqLayout {
  using D = Dims<DH>;
  static constexpr int BM = D::kSplit ? 64 : 128;    // q rows a block
  static constexpr int BK = D::DHP <= 64 ? 128 : 64;  // keys a step
  static constexpr uint32_t kRowTileBytes = BM * D::DHP * 2;  // the Q or the dO tile
  static constexpr uint32_t kKVBytes = BK * D::DHP * 2;       // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kRowTileBytes;
  static constexpr uint32_t kStage = 2 * kRowTileBytes;  // stage s: K at kStage + 2 s kKVBytes, V after
  static constexpr uint32_t kBarriers = kStage + kStages * 2 * kKVBytes;
  // q_full, full[kStages], empty[kStages]; 1024 bytes of slack for alignment
  static constexpr size_t kSmem = kBarriers + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kRowTileBytes % 1024 == 0 && kKVBytes % 1024 == 0, "swizzle atoms");
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using D = Dims<DH>;
  using L = DqLayout<DH>;
  constexpr int BM = L::BM, BK = L::BK, DHP = D::DHP, DN = D::DN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base + L::kQ, do_smem = base + L::kDO;
  auto k_smem = [&](int s) { return base + L::kStage + s * 2 * L::kKVBytes; };
  auto v_smem = [&](int s) { return k_smem(s) + L::kKVBytes; };
  const uint32_t bar_q = base + L::kBarriers;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest causal tiles launched first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q_offset = p.skv - p.sq;

  // the KV tiles some row of this block can see
  const int row_min = q_offset + q0;
  const int row_max = q_offset + min(q0 + BM, p.sq) - 1;
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
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(bar_q, 2 * L::kRowTileBytes);
      tma::load_tile<DHP>(q_smem, &tm_q, BM, q0, h, b, bar_q);
      tma::load_tile<DHP>(do_smem, &tm_do, BM, q0, h, b, bar_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = kv_lo + i * BK;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kKVBytes);
        tma::load_tile<DHP>(k_smem(s), &tm_k, BK, k0, kvh, b, full(s));
        tma::load_tile<DHP>(v_smem(s), &tm_v, BK, k0, kvh, b, full(s));
      }
    }
  } else {
    // ---- consumers: 64 q rows each (at dh 256 the same 64, half of dh each) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int c0 = 2 * (lane % 4);            // its first key in each 8-column group
    const int row_off = D::kSplit ? 0 : 64 * wg;
    const int wq0 = q0 + row_off;  // the warpgroup's first q row
    const int w_first = q_offset + wq0;
    const int w_last = q_offset + min(wq0 + 64, p.sq) - 1;
    const bool w_live = wq0 < p.sq;
    const int col0 = D::kSplit ? wg * DN : 0;  // its first dQ column
    const uint32_t q_rows = q_smem + row_off * kRowBytes;
    const uint32_t do_rows = do_smem + row_off * kRowBytes;
    const uint32_t slice = (col0 / kPanel) * BK * kRowBytes;  // its panels of K
    const Score score(p);

    float lse2[2], dd[2];  // L in log2 units and D of rows r0 and r0 + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + r0 + 8 * r;
      const long long at = (static_cast<long long>(b) * p.heads + h) * p.sq + row;
      lse2[r] = row < p.sq ? p.lse[at] * kLog2e : 0.0f;
      dd[r] = row < p.sq ? p.delta[at] : 0.0f;
    }
    float dq[DN / 2];
#pragma unroll
    for (int j = 0; j < DN / 2; ++j) dq[j] = 0.0f;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = kv_lo + i * BK;
      mbar_wait(full(s), (i / kStages) & 1);
      const bool skip = !w_live || (p.causal && k0 > w_last) ||
                        (p.window > 0 && k0 + BK - 1 <= w_first - p.window);
      if (!skip) {
        // S = Q K^T and dP = dO V^T, 64 rows x BK keys each, in two commit
        // groups so that P's exponentials overlap dP's product
        float sc[BK / 2], dp[BK / 2];
        pin(sc);
        pin(dp);
        wgmma::fence();
#pragma unroll
        for (int kk = 0; kk < D::kSteps; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma::ss<BK>(sc, sw128_desc(q_rows + (kk / 4) * BM * kRowBytes + off, 16),
                        sw128_desc(k_smem(s) + (kk / 4) * BK * kRowBytes + off, 16), kk > 0);
        }
        wgmma::commit();
#pragma unroll
        for (int kk = 0; kk < D::kSteps; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma::ss<BK>(dp, sw128_desc(do_rows + (kk / 4) * BM * kRowBytes + off, 16),
                        sw128_desc(v_smem(s) + (kk / 4) * BK * kRowBytes + off, 16), kk > 0);
        }
        wgmma::commit();
        const bool edge = k0 + BK > p.skv || (p.causal && k0 + BK - 1 > w_first) ||
                          (p.window > 0 && k0 <= w_last - p.window);
        wgmma::wait<1>();
        pin(sc);
        with_flags(score.capped, edge, [&](auto capped, auto masked) {
#pragma unroll
          for (int j = 0; j < BK / 2; ++j) {  // sc becomes P cap'
            const int rr = (j / 2) % 2;
            float dcap;
            float x = score.get<decltype(capped)::value>(sc[j], dcap);
            if constexpr (decltype(masked)::value) {
              if (!visible(p, wq0 + r0 + 8 * rr, k0 + 8 * (j / 4) + c0 + (j % 2))) x = -INFINITY;
            }
            sc[j] = exp2f(x - lse2[rr]) * dcap;
          }
        });
        wgmma::wait<0>();
        pin(dp);
        uint32_t da[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 2; j += 2) {
          const int rr = (j / 2) % 2;
          da[j / 8][(j % 8) / 2] =
              pack_bf16(sc[j] * (dp[j] - dd[rr]), sc[j + 1] * (dp[j + 1] - dd[rr]));
        }
        pin(dq);
        wgmma::fence();
#pragma unroll
        for (int kb = 0; kb < BK / 16; ++kb)
          wgmma::rs<DN>(dq, da[kb],
                        sw128_desc(k_smem(s) + slice + kb * 16 * kRowBytes, BK * kRowBytes), 1);
        wgmma::commit();
        wgmma::wait<0>();
        pin(dq);
      }
      mbar_arrive(empty(s));
    }

    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq.ptr) + b * p.dq.sb + h * p.dq.sh;
#pragma unroll
    for (int j = 0; j < DN / 2; j += 2) {
      const int row = wq0 + r0 + 8 * ((j / 2) % 2);
      const int col = col0 + 8 * (j / 4) + c0;
      if (row < p.sq && col < DH)
        *reinterpret_cast<__nv_bfloat162*>(dqg + row * p.dq.ss + col) =
            __floats2bfloat162_rn(dq[j] * p.scale, dq[j + 1] * p.scale);
    }
  }
}

// ---- host side ----------------------------------------------------------------

// the TMA-read operands, q, k, v and dO, with their element strides
struct Inputs {
  const void *q, *k, *v, *dout;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, d_sb, d_sh, d_ss;
  int batch;
};

// the four tensor maps of one pass: q and dO in boxes of `q_rows` rows, k
// and v in boxes of `kv_rows`
bool make_maps(CUtensorMap (&m)[4], const Inputs& in, const Params& p, int dh, int q_rows,
               int kv_rows) {
  return tma::make_map(&m[0], in.q, dh, p.sq, p.heads, in.batch, in.q_ss, in.q_sh, in.q_sb,
                       q_rows) &&
         tma::make_map(&m[1], in.k, dh, p.skv, p.kv_heads, in.batch, in.k_ss, in.k_sh, in.k_sb,
                       kv_rows) &&
         tma::make_map(&m[2], in.v, dh, p.skv, p.kv_heads, in.batch, in.v_ss, in.v_sh, in.v_sb,
                       kv_rows) &&
         tma::make_map(&m[3], in.dout, dh, p.sq, p.heads, in.batch, in.d_ss, in.d_sh, in.d_sb,
                       q_rows);
}

template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH>
cudaError_t launch(const Inputs& in, const Params& p, cudaStream_t stream) {
  using Dk = DkdvLayout<DH>;
  using Dq = DqLayout<DH>;
  auto dk_kernel = flash_bwd_dkdv_bf16_kernel<DH>;
  auto dq_kernel = flash_bwd_dq_bf16_kernel<DH>;
  // the shared-memory limits belong to the instantiations: raised once
  static const cudaError_t attr_err = [&] {
    const cudaError_t e = raise_smem(dk_kernel, Dk::kSmem);
    return e != cudaSuccess ? e : raise_smem(dq_kernel, Dq::kSmem);
  }();
  if (attr_err != cudaSuccess) return attr_err;
  CUtensorMap dk_maps[4], dq_maps[4];
  if (!make_maps(dk_maps, in, p, DH, kBQ, Dk::BK) ||
      !make_maps(dq_maps, in, p, DH, Dq::BM, Dq::BK)) {
    return cudaErrorInvalidValue;
  }

  const dim3 delta_grid((p.sq + kDeltaRows - 1) / kDeltaRows, p.heads, in.batch);
  flash_bwd_delta_kernel<<<delta_grid, 32 * kDeltaRows, 0, stream>>>(p, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the tile index is the slowest grid dimension, so the heaviest causal
  // tiles are launched first
  const dim3 dk_grid(p.kv_heads, in.batch, (p.skv + Dk::BK - 1) / Dk::BK);
  dk_kernel<<<dk_grid, kThreads, Dk::kSmem, stream>>>(dk_maps[0], dk_maps[1], dk_maps[2],
                                                        dk_maps[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(p.heads, in.batch, (p.sq + Dq::BM - 1) / Dq::BM);
  dq_kernel<<<dq_grid, kThreads, Dq::kSmem, stream>>>(dq_maps[0], dq_maps[1], dq_maps[2],
                                                      dq_maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes), the signature of
// flash_attention_bwd.cu's.  `ptrs` holds the base addresses of q, k, v, o,
// dO, dQ, dK and dV (in that order; dQ, dK, dV written), all bfloat16
// (`dtype` 1) with a contiguous dh; `strides` their (batch, head, seq)
// element strides, 24 values in the same order.  Base addresses and the
// strides in bytes must be multiples of 16 (TMA reads q, k, v and dO).
// `lse` is the forward's float32 (B, H, Sq) log-sum-exp, `delta` float32 (B,
// H, Sq) scratch, both contiguous.  Launches three kernels on `stream` (D,
// then dK and dV, then dQ), does not synchronise, allocates nothing.
// Makes q's device current in the calling thread.  Returns the first launch
// error (or the error of cudaFuncSetAttribute), or cudaErrorInvalidValue for
// another dtype, a head dim without an
// instantiation, an empty shape, heads % kv_heads != 0 or a tensor map the
// driver refuses.
extern "C" int flash_attention_bwd(const void* const* ptrs, const long long* strides,
                                   const float* lse, float* delta, int dtype, int batch,
                                   int heads, int kv_heads, int sq, int skv, int dh, float scale,
                                   int causal, int window, float logit_cap, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || sq <= 0 || skv <= 0 ||
      heads % kv_heads != 0 || dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tensor4 t[8];
  for (int i = 0; i < 8; ++i) {
    t[i] = Tensor4{const_cast<void*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                   strides[3 * i + 2]};
  }
  const Inputs in{ptrs[0], ptrs[1], ptrs[2], ptrs[4],
                  t[0].sb, t[0].sh, t[0].ss, t[1].sb, t[1].sh, t[1].ss,
                  t[2].sb, t[2].sh, t[2].ss, t[4].sb, t[4].sh, t[4].ss, batch};
  const Params p{t[3], t[4], t[5], t[6], t[7], lse, delta,
                 heads, kv_heads, sq, skv, scale, causal, window, logit_cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tma::use_device_of(ptrs[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dh) {
    case 16: err = launch<16>(in, p, s); break;
    case 32: err = launch<32>(in, p, s); break;
    case 64: err = launch<64>(in, p, s); break;
    case 80: err = launch<80>(in, p, s); break;
    case 128: err = launch<128>(in, p, s); break;
    case 256: err = launch<256>(in, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

