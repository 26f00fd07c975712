// Mamba-1 selective scan, backward, float32 — hand-written for Hopper (sm_90a).
//
// The Pallas TPU kernel `selective_scan` (src/repro/kernels/mamba_scan/
// kernel.py) has no backward: the reference trains through the custom VJP
// of `_linear_scan` (src/repro/models/mamba.py:109-147), whose backward is
// the reverse linear recurrence lambda_t = dh_t + da_{t+1} lambda_{t+1}.
// This file is the gradient of the port's forward kernel (selective_scan.cu)
//
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = sum_n C_t h_t,  h_0 = 0,
//
// with that recurrence plus the C contraction folded in:
//
//   lambda_t = C_t dy_t + exp(dt_{t+1} A) lambda_{t+1}           (d, n)
//   ddt_t    = sum_n lambda_t (A exp(dt_t A) h_{t-1} + x_t B_t)  (d)
//   dx_t     = sum_n lambda_t dt_t B_t                           (d)
//   dA       = sum_t lambda_t exp(dt_t A) h_{t-1} dt_t           (d, n)
//   dB_t     = sum_d lambda_t dt_t x_t,  dC_t = sum_d dy_t h_t   (n)
//
// Bound on an H100 SXM at falcon-mamba-7b's width, B=2, S=2048,
// d_inner=8192, N=16: the function reads dt, x and dy and writes ddt and
// dx, 5 x 134 MB (0.20 ms at 3.35 TB/s), and does about 26 float32
// operations per (b, t, d, n), 537 M of them (0.21 ms at 67 TFLOP/s).
//
// The first design took 0.802 ms there, 26% of that bound (1.580 ms at
// B=1, S=8192; H100 80GB HBM3, 700 W).  It kept the chunk's 16 recomputed
// states and its per-step ddt/dx partials in registers, 255 a thread with
// 40-76 bytes of spills, and took each exponential twice (to recompute the
// states and again in the reverse pass).
//
// This design:
//
// * One exponential.  Recomputing a chunk keeps exp(dt_t A) beside each
//   state h_t in registers (a lane's 4 states x 16 steps of each); the
//   reverse pass reads both.  The per-step ddt/dx partials leave the
//   registers for a shared tile, so nothing spills at N = 16: 230
//   registers a thread, two blocks an SM.
// * Lanes.  kThreads = 128 a block over one batch row; warp w holds states
//   4 (w % (N/4)) .. +3 of 32 channels, one a lane, so B_t and C_t reach a
//   warp as one uniform 16-byte shared load.  A block covers 32 channels
//   at N = 16 (64 at N = 8, 128 at N = 4).
// * Reductions, all in a fixed order (no atomics, so two calls give equal
//   bits).  ddt and dx sum over the N/4 warps of a channel: each step a
//   lane writes its partials to a (group, step, channel) tile, and once a
//   chunk the block adds the groups in order and stores them coalesced, 16
//   bytes a thread.  dB and dC sum over the warp's 32 channels every step
//   (a transposing shuffle butterfly, 9 shuffles for eight sums) and go
//   straight to the slice of partials of those 32 channels, (slices, B, S,
//   N), which the wrapper sums in slice order; dA sums over time in
//   registers, one (B, d_inner, N) partial.
// * Copies.  Each chunk's dt, x, dy, B and C reach shared memory by
//   cp.async into a 2-stage ring while the previous chunk is walked (16-byte
//   copies where d_inner % 4 == 0 and every base is 16-byte aligned, else
//   4-byte; past S or d_inner zero-filled, so those steps leave lambda 0).
//
// What holds it at about 0.73 ms at the falcon shape (H100 80GB HBM3,
// 700 W), 29% of its bound, is its instruction stream at about three
// quarters of the SMs' issue rate: the SASS of the N = 16 kernel holds
// 2,240 instructions for its unrolled 16-step chunk, 35 per (b, t, d, n)
// (12 float operations, the exponential, the loads, the 9-shuffle dB/dC
// butterfly with its 14 selects, the partial stores).  Four blocks an SM
// (at most 128 registers: the exponentials of a chunk's first half parked
// in shared memory and its first half's states recomputed from them, a
// second barrier a chunk) ran at 0.90 ms; summing dB/dC over a cluster
// of four blocks through distributed shared memory, for one slice per 128
// channels, 1.33 ms; two channels and two states a lane 0.97-1.01 ms
// (PERF.md section 6 lists them).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "scan_async.cuh"

namespace {

using scan::commit;
using scan::copy16;
using scan::copy4;
using scan::exp2_approx;
using scan::wait_pending;

constexpr int kThreads = 128;       // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;          // time steps a chunk (the forward's state interval)
constexpr int kStages = 2;          // depth of the cp.async ring
constexpr int kStatesPerLane = 4;   // states of one channel a lane holds
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int N>
struct Tile {
  static_assert(N % kStatesPerLane == 0 && N <= 16, "N must be 4, 8 or 16");
  static constexpr int kLanes = N / kStatesPerLane;  // warps a set of 32 channels
  static constexpr int kSets = kWarps / kLanes;      // sets of 32 channels a block
  static constexpr int kChannels = 32 * kSets;       // channels a block
  // shared memory, in floats:
  static constexpr int kIo = kChunk * kChannels;    // a (step x channel) tile
  static constexpr int kBc = kChunk * N;            // a (step x state) row block
  static constexpr int kStage = 3 * kIo + 2 * kBc;  // dt | x | dy | B | C
  static constexpr int kPart = 2 * kLanes * kIo;    // ddt | dx partials of each state group
  // after the ring, two buffers of partials, so one chunk's are stored
  // while the next fills
  static constexpr int kOut = kStages * kStage;
  static constexpr int kFloats = kOut + 2 * kPart;
  static constexpr int kBytes = kFloats * 4;
};

// Issue the copies of time chunk `t0` into one ring stage: the dt, x and dy
// tiles (kChunk x kChannels) and the B and C rows (kChunk x N).
template <int N, bool kVec>
__device__ __forceinline__ void load_chunk(float* stage, const float* dt, const float* x,
                                           const float* dy, const float* b, const float* c,
                                           size_t row0, int t0, int seqlen, int d0,
                                           int d_inner) {
  using T = Tile<N>;
  constexpr int kWidth = kVec ? 4 : 1;
  constexpr int kPerRow = T::kChannels / kWidth;
  static_assert(kChunk * kPerRow % kThreads == 0);
#pragma unroll
  for (int i = 0; i < kChunk * kPerRow / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int t = p / kPerRow;
    const int col = (p % kPerRow) * kWidth;
    const bool valid = t0 + t < seqlen && d0 + col < d_inner;
    const size_t off = valid ? (row0 + t0 + t) * d_inner + d0 + col : 0;
    const int bytes = valid ? 4 * kWidth : 0;
    float* dst = stage + t * T::kChannels + col;
    if constexpr (kVec) {
      copy16(dst, dt + off, bytes);
      copy16(dst + T::kIo, x + off, bytes);
      copy16(dst + 2 * T::kIo, dy + off, bytes);
    } else {
      copy4(dst, dt + off, bytes);
      copy4(dst + T::kIo, x + off, bytes);
      copy4(dst + 2 * T::kIo, dy + off, bytes);
    }
  }
  const int live = min(kChunk, seqlen - t0) * N;
  const size_t bc = (row0 + t0) * N;
#pragma unroll
  for (int i = 0; i < (T::kBc + kThreads * kWidth - 1) / (kThreads * kWidth); ++i) {
    const int p = (threadIdx.x + i * kThreads) * kWidth;
    if (p >= T::kBc) break;
    const bool valid = p < live;
    const size_t off = valid ? bc + p : 0;
    const int bytes = valid ? 4 * kWidth : 0;
    if constexpr (kVec) {
      copy16(stage + 3 * T::kIo + p, b + off, bytes);
      copy16(stage + 3 * T::kIo + T::kBc + p, c + off, bytes);
    } else {
      copy4(stage + 3 * T::kIo + p, b + off, bytes);
      copy4(stage + 3 * T::kIo + T::kBc + p, c + off, bytes);
    }
  }
}

// Store a finished chunk's ddt and dx (time steps t0 ..), each the sum of
// its state groups' partials in group order, coalesced along the channels
// (16 bytes a thread where d_inner % 4 == 0).
template <int N, bool kVec>
__device__ __forceinline__ void flush_chunk(const float* part, float* ddt, float* dx,
                                            size_t row0, int t0, int seqlen, int d0,
                                            int d_inner) {
  using T = Tile<N>;
  constexpr int kWidth = kVec ? 4 : 1;
#pragma unroll
  for (int i = 0; i < 2 * T::kIo / kWidth / kThreads; ++i) {
    const int f = (threadIdx.x + i * kThreads) * kWidth;  // first float of the item
    const int which = f / T::kIo;                          // ddt | dx
    const int t = (f % T::kIo) / T::kChannels;
    const int cc = f % T::kChannels;
    const float* src = part + which * T::kLanes * T::kIo + (f % T::kIo);
    if (t0 + t < seqlen && d0 + cc < d_inner) {
      float* dst = (which ? dx : ddt) + (row0 + t0 + t) * d_inner + d0 + cc;
      if constexpr (kVec) {
        float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int g = 1; g < T::kLanes; ++g) {
          const float4 u = *reinterpret_cast<const float4*>(src + g * T::kIo);
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        float v = src[0];
#pragma unroll
        for (int g = 1; g < T::kLanes; ++g) v += src[g * T::kIo];
        *dst = v;
      }
    }
  }
}

// The sums of eight values over a warp's 32 lanes (its 32 channels), by a
// transposing butterfly: afterwards lane l holds the sum of value
// 4 bit4(l) + 2 bit3(l) + bit2(l), the same in each group of four lanes.  A
// fixed order, so equal bits every call.
__device__ __forceinline__ float warp_sums8(const float (&v)[8], int lane) {
  float a4[4];
  const bool u16 = lane & 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = u16 ? v[j] : v[j + 4];
    const float keep = u16 ? v[j + 4] : v[j];
    a4[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float a2[2];
  const bool u8 = lane & 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = u8 ? a4[j] : a4[j + 2];
    const float keep = u8 ? a4[j + 2] : a4[j];
    a2[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool u4 = lane & 4;
  float a1 = (u4 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, u4 ? a2[0] : a2[1], 4);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
  return a1;
}

template <int N, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(const float* __restrict__ dt,      // (B, S, di)
                          const float* __restrict__ a,       // (di, N)
                          const float* __restrict__ b,       // (B, S, N)
                          const float* __restrict__ c,       // (B, S, N)
                          const float* __restrict__ x,       // (B, S, di)
                          const float* __restrict__ dy,      // (B, S, di)
                          const float* __restrict__ states,  // (B, chunks, di, N)
                          float* __restrict__ ddt,           // (B, S, di)
                          float* __restrict__ dx,            // (B, S, di)
                          float* __restrict__ da_part,       // (B, di, N)
                          float* __restrict__ db_part,       // (slices, B, S, N)
                          float* __restrict__ dc_part,       // (slices, B, S, N)
                          int batch, int seqlen, int d_inner) {
  using T = Tile<N>;
  constexpr int J = kStatesPerLane;
  extern __shared__ __align__(16) float smem[];

  const int d0 = blockIdx.x * T::kChannels;
  const int bi = blockIdx.y;
  const size_t row0 = static_cast<size_t>(bi) * seqlen;
  const int chunks = (seqlen + kChunk - 1) / kChunk;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int group = warp % T::kLanes;  // warp w holds states 4 (w % kLanes) .. + 3
  const int set = warp / T::kLanes;    // of channels 32 (w / kLanes) + lane
  const int ch = set * 32 + lane;
  const int n0 = group * J;
  const bool live_ch = d0 + ch < d_inner;
  // lanes 0, 4, .., 28 store the dB / dC sums of warp_sums8 (value 0-3 dB,
  // 4-7 dC of state n0 + v % 4) to the slice of this block's channel set
  const int sum_index = 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);
  const size_t slice = static_cast<size_t>(blockIdx.x) * T::kSets + set;
  float* sum_rows = (sum_index < 4 ? db_part : dc_part) +
                    (slice * batch + bi) * static_cast<size_t>(seqlen) * N + n0 + sum_index % 4;

  float a2[J], lam[J], da_next[J], dA[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    a2[j] = live_ch ? a[static_cast<size_t>(d0 + ch) * N + n0 + j] * kLog2e : 0.0f;
    lam[j] = da_next[j] = dA[j] = 0.0f;
  }
  auto state_at = [&](int k) -> float4 {
    if (!live_ch) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const size_t at = ((static_cast<size_t>(bi) * chunks + k) * d_inner + d0 + ch) * N + n0;
    return *reinterpret_cast<const float4*>(states + at);
  };

  // prologue: the last kStages - 1 chunks in flight, latest first
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < chunks) {
      load_chunk<N, kVec>(smem + i * T::kStage, dt, x, dy, b, c, row0,
                          (chunks - 1 - i) * kChunk, seqlen, d0, d_inner);
    }
    commit();
  }
  float4 start = state_at(chunks - 1);

  for (int i = 0; i < chunks; ++i) {
    const int k = chunks - 1 - i;  // the chunk this iteration walks
    const int t0 = k * kChunk;
    wait_pending<kStages - 2>();
    __syncthreads();  // chunk k landed; chunk k + 1 and its partials are complete
    if (i + kStages - 1 < chunks) {
      load_chunk<N, kVec>(smem + ((i + kStages - 1) % kStages) * T::kStage, dt, x,
                          dy, b, c, row0, (k - (kStages - 1)) * kChunk, seqlen, d0, d_inner);
    }
    commit();
    const float4 next_start = k > 0 ? state_at(k - 1) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float* part = smem + T::kOut + (i % 2) * T::kPart + group * T::kIo + ch;

    const float* stage = smem + (i % kStages) * T::kStage;
    const float* s_dt = stage + ch;
    const float* s_x = stage + T::kIo + ch;
    const float* s_dy = stage + 2 * T::kIo + ch;
    const float4* s_b = reinterpret_cast<const float4*>(stage + 3 * T::kIo + n0);
    const float4* s_c = reinterpret_cast<const float4*>(stage + 3 * T::kIo + T::kBc + n0);

    // the chunk's states and exponentials, recomputed from its saved start
    // as the forward computes them (steps past S have dt = x = 0)
    float hs[kChunk][J], es[kChunk][J];
    {
      float h[J] = {start.x, start.y, start.z, start.w};
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const float dt_v = s_dt[t * T::kChannels];
        const float dxv = dt_v * s_x[t * T::kChannels];
        const float4 bq = s_b[t * (N / 4)];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          es[t][j] = exp2_approx(dt_v * a2[j]);
          h[j] = fmaf(h[j], es[t][j], dxv * bv[j]);
          hs[t][j] = h[j];
        }
      }
    }

    // the reverse recurrence; steps past S have dy = C = 0, so lambda stays 0
    const float h0[4] = {start.x, start.y, start.z, start.w};
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      const float dt_v = s_dt[t * T::kChannels];
      const float x_v = s_x[t * T::kChannels];
      const float dy_v = s_dy[t * T::kChannels];
      const float4 bq = s_b[t * (N / 4)];
      const float4 cq = s_c[t * (N / 4)];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
      const float dtx = dt_v * x_v;
      float sga = 0.0f, slb = 0.0f, prod[8];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        lam[j] = fmaf(lam[j], da_next[j], cv[j] * dy_v);
        const float g = lam[j] * ((t > 0 ? hs[t > 0 ? t - 1 : 0][j] : h0[j]) * es[t][j]);
        sga = fmaf(g, a2[j], sga);
        slb = fmaf(lam[j], bv[j], slb);
        dA[j] = fmaf(g, dt_v, dA[j]);
        prod[j] = lam[j] * dtx;         // dB of state n0 + j
        prod[4 + j] = dy_v * hs[t][j];  // dC of state n0 + j
        da_next[j] = es[t][j];
      }
      // this state group's part of ddt and dx; the flush adds the groups
      part[t * T::kChannels] = fmaf(sga, kLn2, x_v * slb);
      part[T::kLanes * T::kIo + t * T::kChannels] = dt_v * slb;

      // dB and dC: the sums of the 8 products over the warp's 32 channels
      const float reduced = warp_sums8(prod, lane);
      if (lane % 4 == 0 && t0 + t < seqlen) sum_rows[static_cast<size_t>(t0 + t) * N] = reduced;
    }
    start = next_start;

    if (i > 0) {  // the previous chunk's partials, complete since this chunk's barrier
      flush_chunk<N, kVec>(smem + T::kOut + ((i - 1) % 2) * T::kPart, ddt, dx, row0,
                           t0 + kChunk, seqlen, d0, d_inner);
    }
  }
  __syncthreads();
  flush_chunk<N, kVec>(smem + T::kOut + ((chunks - 1) % 2) * T::kPart, ddt, dx, row0, 0, seqlen,
                       d0, d_inner);

  if (live_ch) {
    const size_t at = (static_cast<size_t>(bi) * d_inner + d0 + ch) * N + n0;
    *reinterpret_cast<float4*>(da_part + at) = make_float4(dA[0], dA[1], dA[2], dA[3]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct Args {
  const float *dt, *a, *b, *c, *x, *dy, *states;
  float *ddt, *dx, *da_part, *db_part, *dc_part;
  int batch, seqlen, d_inner;
};

template <int N, bool kVec>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  using T = Tile<N>;
  auto kernel = selective_scan_bwd_kernel<N, kVec>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.d_inner + T::kChannels - 1) / T::kChannels, g.batch);
  kernel<<<grid, kThreads, T::kBytes, stream>>>(g.dt, g.a, g.b, g.c, g.x, g.dy, g.states, g.ddt,
                                                g.dx, g.da_part, g.db_part, g.dc_part, g.batch,
                                                g.seqlen, g.d_inner);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  const bool vec = g.d_inner % 4 == 0 && aligned16(g.dt) && aligned16(g.x) && aligned16(g.dy) &&
                   aligned16(g.b) && aligned16(g.c);
  return vec ? launch<N, true>(g, stream) : launch<N, false>(g, stream);
}

template <int N>
cudaError_t occupancy(int* out) {
  using T = Tile<N>;
  auto kernel = selective_scan_bwd_kernel<N, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, T::kBytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[1] = attr.numRegs;
  out[2] = T::kBytes;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Inputs as the forward's
// selective_scan_fwd_f32, plus dy (B, S, d_inner) and the states it saved
// (B, ceil(S / 16), d_inner, d_state); outputs ddt and dx (B, S, d_inner),
// the per-batch-row dA partial (B, d_inner, d_state) and the per-block dB
// and dC partials (slices, B, S, d_state; selective_scan_bwd_layout gives
// the slices, one per block of channels), every one contiguous float32 and
// written whole.  One launch on `stream`; does not synchronise, allocates
// nothing.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a state width without an instantiation, an
// empty shape, or states or partials not 16-byte aligned.
extern "C" int selective_scan_bwd_f32(const float* dt, const float* a, const float* b,
                                      const float* c, const float* x, const float* dy,
                                      const float* states, float* ddt, float* dx,
                                      float* da_part, float* db_part, float* dc_part, int batch,
                                      int seqlen, int d_inner, int d_state, void* stream) {
  if (batch <= 0 || seqlen <= 0 || d_inner <= 0 || !aligned16(states) || !aligned16(da_part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args g{dt, a, b, c, x, dy, states, ddt, dx, da_part, db_part, dc_part,
               batch, seqlen, d_inner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4: return static_cast<int>(launch<4>(g, s));
    case 8: return static_cast<int>(launch<8>(g, s));
    case 16: return static_cast<int>(launch<16>(g, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The layout the wrapper allocates for `d_inner` and `d_state`: writes
// {time steps between saved states, dB / dC partial slices (one per 32
// channels of every block)} to `out` and returns 0, or returns
// cudaErrorInvalidValue.
extern "C" int selective_scan_bwd_layout(int d_inner, int d_state, int* out) {
  int channels;  // channels a block
  switch (d_state) {
    case 4: channels = Tile<4>::kChannels; break;
    case 8: channels = Tile<8>::kChannels; break;
    case 16: channels = Tile<16>::kChannels; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = kChunk;
  out[1] = (d_inner + channels - 1) / channels * (channels / 32);
  return 0;
}

// The kernel's residency at `d_state` (its 16-byte-copy instantiation):
// writes {blocks an SM, registers a thread, dynamic shared bytes a block,
// local (spill) bytes a thread} to `out`; returns a CUDA error code.
extern "C" int selective_scan_bwd_occupancy(int d_state, int* out) {
  switch (d_state) {
    case 4: return static_cast<int>(occupancy<4>(out));
    case 8: return static_cast<int>(occupancy<8>(out));
    case 16: return static_cast<int>(occupancy<16>(out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
