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
// Layout and tiles follow the forward: one block of 128 threads per (batch
// row, tile of channels), four states a lane, warp w holding state group
// w % (N/4) of 32 channels.  The block walks the time chunks of kChunk = 16
// steps in reverse, each chunk's dt, x, dy, B and C copied by cp.async into
// a 4-stage ring as in the forward.  A chunk starts from the float32 state
// the forward saved at its start (prefetched one chunk ahead), recomputes
// its 16 states into registers with the forward's arithmetic, then runs the
// reverse recurrence over them.
//
// Reductions, all in a fixed order (no atomics, so two calls give equal
// bits):
// * ddt and dx sum over the N states, which span N/4 warps: each lane's
//   per-step partials go through a shared tile and are summed and stored
//   coalesced after the next chunk's barrier, as the forward stores y.
// * dA sums over time in registers; each batch row writes its own (d, n)
//   partial, (B, d_inner, N), summed over B by the wrapper.
// * dB and dC sum over channels: each step, a warp reduces its 32 channels
//   of its four states of each (a transposing butterfly: 9 shuffles for the
//   eight sums) and writes them to its 32-channel slice's partial,
//   (slices, B, S, N), summed over slices by the wrapper.
//
// Bound on an H100 SXM (3.35 TB/s) at falcon-mamba-7b's width, B=2,
// S=2048, d_inner=8192, N=16: dt, x and dy read and ddt and dx written are
// 5 x 134 MB, the saved states 134 MB and the dB, dC partials 2 x 67 MB:
// 940 MB, 0.28 ms.  It also takes two exponentials per (b, t, d, n), one in
// the recomputed forward and one in the reverse pass (the special-function
// unit's floor is about 0.26 ms there), and about twenty float32 operations.

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
constexpr int kChunk = 16;          // time steps a stage (the forward's state interval)
constexpr int kStages = 4;          // depth of the cp.async ring
constexpr int kStatesPerLane = 4;   // states of one channel a lane holds
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Tile {
  static_assert(N % kStatesPerLane == 0, "N must be a multiple of 4");
  static constexpr int kLanes = N / kStatesPerLane;     // lanes a channel
  static constexpr int kChannels = kThreads / kLanes;   // channels a block
  static_assert(kChannels % 32 == 0 && kChunk % 4 == 0);
  // shared memory, in floats: kStages x [dt | x | dy | B | C], then
  // 2 buffers x [ddt partials | dx partials]
  static constexpr int kIo = kChunk * kChannels;
  static constexpr int kBc = kChunk * N;
  static constexpr int kStage = 3 * kIo + 2 * kBc;
  static constexpr int kRow = kChunk + 4;  // padded as in the forward
  static constexpr int kPartial = kLanes * kChannels * kRow;
  static constexpr int kBytes = (kStages * kStage + 4 * kPartial) * 4;
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

// Sum each channel's kLanes partials of a finished chunk and store them
// (the forward's store_chunk, for one output).
template <int N>
__device__ __forceinline__ void store_chunk(const float* partial, float* out, size_t row0,
                                            int t0, int seqlen, int d0, int d_inner) {
  using T = Tile<N>;
  constexpr int kItems = T::kChannels * kChunk / 4;
  static_assert(kItems % kThreads == 0);
#pragma unroll
  for (int i = 0; i < kItems / kThreads; ++i) {
    const int ch = (threadIdx.x + i * kThreads) % T::kChannels;
    const int t = (threadIdx.x + i * kThreads) / T::kChannels * 4;
    float4 sum = *reinterpret_cast<const float4*>(partial + ch * T::kRow + t);
#pragma unroll
    for (int g = 1; g < T::kLanes; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(partial + (g * T::kChannels + ch) * T::kRow + t);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (d0 + ch < d_inner) {
      float* o = out + (row0 + t0 + t) * d_inner + d0 + ch;
      const int live = seqlen - t0 - t;
      if (live > 0) o[0] = sum.x;
      if (live > 1) o[d_inner] = sum.y;
      if (live > 2) o[2 * d_inner] = sum.z;
      if (live > 3) o[3 * d_inner] = sum.w;
    }
  }
}

// The sums over a warp's 32 lanes of eight values, by a transposing
// butterfly: after it, lane l holds the sum of value
// 4 bit4(l) + 2 bit3(l) + bit2(l) (every lane of a group of four the same).
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
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ __align__(16) float smem[];
  float* partials = smem + kStages * T::kStage;  // [buffer][ddt | dx][kPartial]

  const int d0 = blockIdx.x * T::kChannels;
  const int bi = blockIdx.y;
  const size_t row0 = static_cast<size_t>(bi) * seqlen;
  const int chunks = (seqlen + kChunk - 1) / kChunk;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int group = warp % T::kLanes;
  const int ch = (warp / T::kLanes) * 32 + lane;
  const int n0 = group * kStatesPerLane;
  const bool live_ch = d0 + ch < d_inner;
  // this warp's 32-channel slice of the dB / dC partials, and where its lane
  // writes: the lanes 0, 4, .., 28 hold the eight sums of warp_sums8
  const size_t slice = static_cast<size_t>(d0) / 32 + warp / T::kLanes;
  const int sum_index = 4 * ((lane >> 4) & 1) + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);
  float* bc_out = (sum_index < 4 ? db_part : dc_part) +
                  (slice * batch + bi) * static_cast<size_t>(seqlen) * N + n0 + (sum_index % 4);

  float an[kStatesPerLane], a2[kStatesPerLane];
  float lam[kStatesPerLane], da_next[kStatesPerLane], dA[kStatesPerLane];
#pragma unroll
  for (int i = 0; i < kStatesPerLane; ++i) {
    an[i] = live_ch ? a[static_cast<size_t>(d0 + ch) * N + n0 + i] : 0.0f;
    a2[i] = an[i] * kLog2e;
    lam[i] = 0.0f;
    da_next[i] = 0.0f;
    dA[i] = 0.0f;
  }
  auto state_at = [&](int k) -> float4 {
    if (!live_ch) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const size_t at = ((static_cast<size_t>(bi) * chunks + k) * d_inner + d0 + ch) * N + n0;
    return *reinterpret_cast<const float4*>(states + at);
  };

  // prologue: the last kStages-1 chunks in flight, latest first
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
    wait_pending<kStages - 2>();
    __syncthreads();  // chunk k landed; stage (i-1) % kStages and partials (i-1) % 2 free
    if (i + kStages - 1 < chunks) {
      load_chunk<N, kVec>(smem + ((i + kStages - 1) % kStages) * T::kStage, dt, x, dy, b, c,
                          row0, (k - (kStages - 1)) * kChunk, seqlen, d0, d_inner);
    }
    commit();
    const float4 next_start = k > 0 ? state_at(k - 1) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    const float* stage = smem + (i % kStages) * T::kStage;
    const float* s_dt = stage + ch;
    const float* s_x = stage + T::kIo + ch;
    const float* s_dy = stage + 2 * T::kIo + ch;
    const float4* s_b = reinterpret_cast<const float4*>(stage + 3 * T::kIo + n0);
    const float4* s_c = reinterpret_cast<const float4*>(stage + 3 * T::kIo + T::kBc + n0);

    // the chunk's states h_t, recomputed from its saved start as the forward
    // computes them (steps past S have dt = x = 0 and leave h unchanged)
    const float h0[kStatesPerLane] = {start.x, start.y, start.z, start.w};
    float hs[kChunk][kStatesPerLane];
    {
      float h[kStatesPerLane] = {start.x, start.y, start.z, start.w};
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const float dt_v = s_dt[t * T::kChannels];
        const float dxv = dt_v * s_x[t * T::kChannels];
        const float4 bv = s_b[t * (N / 4)];
        h[0] = fmaf(h[0], exp2_approx(dt_v * a2[0]), dxv * bv.x);
        h[1] = fmaf(h[1], exp2_approx(dt_v * a2[1]), dxv * bv.y);
        h[2] = fmaf(h[2], exp2_approx(dt_v * a2[2]), dxv * bv.z);
        h[3] = fmaf(h[3], exp2_approx(dt_v * a2[3]), dxv * bv.w);
#pragma unroll
        for (int j = 0; j < kStatesPerLane; ++j) hs[t][j] = h[j];
      }
    }

    // the reverse recurrence; steps past S have dy = C = 0, so lambda stays 0
    float acc_ddt[kChunk], acc_dx[kChunk];
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      const float dt_v = s_dt[t * T::kChannels];
      const float x_v = s_x[t * T::kChannels];
      const float dy_v = s_dy[t * T::kChannels];
      const float4 bq = s_b[t * (N / 4)];
      const float4 cq = s_c[t * (N / 4)];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
      float sum_ddt = 0.0f, sum_dx = 0.0f, sums[8];
#pragma unroll
      for (int j = 0; j < kStatesPerLane; ++j) {
        const float da = exp2_approx(dt_v * a2[j]);
        lam[j] = fmaf(lam[j], da_next[j], cv[j] * dy_v);
        const float h_prev = t > 0 ? hs[t > 0 ? t - 1 : 0][j] : h0[j];
        const float g = lam[j] * h_prev * da;
        sum_ddt = fmaf(g, an[j], fmaf(lam[j] * x_v, bv[j], sum_ddt));
        sum_dx = fmaf(lam[j] * dt_v, bv[j], sum_dx);
        dA[j] = fmaf(g, dt_v, dA[j]);
        sums[j] = lam[j] * dt_v * x_v;
        sums[4 + j] = dy_v * hs[t][j];
        da_next[j] = da;
      }
      acc_ddt[t] = sum_ddt;
      acc_dx[t] = sum_dx;
      const float reduced = warp_sums8(sums, lane);
      if (lane % 4 == 0 && k * kChunk + t < seqlen) {
        bc_out[static_cast<size_t>(k * kChunk + t) * N] = reduced;
      }
    }
    start = next_start;

    float* part = partials + (i % 2) * 2 * T::kPartial + (group * T::kChannels + ch) * T::kRow;
#pragma unroll
    for (int t = 0; t < kChunk; t += 4) {
      *reinterpret_cast<float4*>(part + t) =
          make_float4(acc_ddt[t], acc_ddt[t + 1], acc_ddt[t + 2], acc_ddt[t + 3]);
      *reinterpret_cast<float4*>(part + T::kPartial + t) =
          make_float4(acc_dx[t], acc_dx[t + 1], acc_dx[t + 2], acc_dx[t + 3]);
    }
    if (i > 0) {
      const float* prev = partials + ((i - 1) % 2) * 2 * T::kPartial;
      store_chunk<N>(prev, ddt, row0, (k + 1) * kChunk, seqlen, d0, d_inner);
      store_chunk<N>(prev + T::kPartial, dx, row0, (k + 1) * kChunk, seqlen, d0, d_inner);
    }
  }
  __syncthreads();
  const float* last = partials + ((chunks - 1) % 2) * 2 * T::kPartial;
  store_chunk<N>(last, ddt, row0, 0, seqlen, d0, d_inner);
  store_chunk<N>(last + T::kPartial, dx, row0, 0, seqlen, d0, d_inner);

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

}  // namespace

// Plain C entry point (bound with ctypes).  Inputs as the forward's
// selective_scan_fwd_f32, plus dy (B, S, d_inner) and the states it saved
// (B, ceil(S / 16), d_inner, d_state); outputs ddt and dx (B, S, d_inner),
// the per-batch-row dA partial (B, d_inner, d_state) and the per-32-channel
// dB and dC partials (slices, B, S, d_state; selective_scan_bwd_layout
// gives the slices, one per 32 channels of every block), every one
// contiguous float32 and written whole.  One launch on `stream`; does not
// synchronise, allocates nothing.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a state width without an
// instantiation, an empty shape, or states or partials not 16-byte aligned.
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
// {time steps between saved states, dB / dC partial slices} to `out` and
// returns 0, or returns cudaErrorInvalidValue.
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
