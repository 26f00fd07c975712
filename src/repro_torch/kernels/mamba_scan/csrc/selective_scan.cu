// Mamba-1 selective scan, forward, float32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `selective_scan` in
// src/repro/kernels/mamba_scan/kernel.py (body `_kernel`, grid over
// (batch, d_inner blocks, seq chunks) with the (block_d, N) state carried
// across the sequential chunk axis in VMEM scratch).  It computes
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = sum_n h_t * C_t,
//
// from h_0 = 0, in the (B, S, d_inner) layout; the final state is not
// returned (as in the TPU kernel).  For training it optionally writes the
// float32 state at the start of every time chunk, (B, S / kChunk, d_inner,
// N), from which selective_scan_bwd.cu recomputes a chunk's states; serving
// passes a null pointer and runs an instantiation without the store.  No CUDA block carries state to another,
// so the time walk is a loop inside the block, as the TPU grid's chunk axis.
//
// What bounds it on an H100 SXM (132 SMs, HBM3 at 3.35 TB/s).  At
// falcon-mamba-7b's width, B=2, S=2048, d_inner=8192, N=16, it must read dt
// and x and write y, 3 x 134 MB = 403 MB: 0.120 ms.  B, C and A are < 1 MB.
// It also takes one exponential per (b, t, d, n), 537 M of them, and the
// special-function unit gives 16 a clock on each SM: 0.128 ms at 1.98 GHz.
// Its other float work, four operations per (b, t, d, n) on the 128-lane
// float32 pipe, takes half that.  So the bytes and the exp pipe set two
// floors of about equal height, and the design overlaps them.
//
// The previous design (one thread per (batch, channel), dt and x loaded
// from device memory inside the time loop) waited one DRAM round trip a
// step: 1.446 ms at that shape and 5.61 ms at B=1, S=8192 (H100 80GB HBM3,
// 700 W).  This one takes 0.194 ms and 0.425 ms there:
//
// * Copies, not loads, feed the time loop.  A block owns one batch row and
//   a tile of kChannels channels and walks the sequence in chunks of
//   kChunk = 16 steps.  Each chunk's dt and x tiles (kChunk x kChannels)
//   and its B and C rows (kChunk x N) reach shared memory by cp.async into
//   a ring of kStages = 4 stages: while chunk k is scanned, chunks k+1..k+3
//   are in flight.  One __syncthreads a chunk hands a stage from the
//   copies to the scan.  16-byte copies where d_inner % 4 == 0 and every
//   base is 16-byte aligned; 4-byte copies otherwise (d_inner = 70 has a
//   280-byte row stride, which neither 16-byte copies nor TMA take).  Steps
//   past S and channels past d_inner are zero-filled by the copy (src-size
//   0), so the scan needs no mask: dt = 0 leaves h unchanged, and their y
//   is not stored.
// * Four lanes a channel at N = 16, four states a lane.  kThreads = 128
//   threads a block: warp w holds states 4 (w % (N/4)) .. +3 of 32
//   channels, so a block covers 32 channels at N = 16 (64 at N = 8, 128 at
//   N = 4).  That is 4x the threads of one per channel: 65,536 at the
//   falcon shape, 32,768 at B=1.  A lane keeps its four states and its row
//   of A (times log2 e) in registers; B_t and C_t reach it as one 16-byte
//   shared load each, the same for the whole warp.
// * y in coalesced tiles.  A lane keeps its partial sums of the chunk's y_t
//   in registers (a shared store between two steps would keep the compiler
//   from hoisting the next steps' loads and exponentials above it), then
//   writes them as 16-byte stores to a (group, channel, step) shared tile.
//   After the next chunk's barrier each thread adds one channel's N/4
//   partials of four steps and stores them; a warp stores 32 neighbouring
//   channels of a step, 128 contiguous bytes.  Two such tiles alternate, so
//   the one __syncthreads a chunk also orders them.
// * One special-function op an exponential: exp(dt a) = ex2(dt * a log2 e),
//   with log2 e folded into the row of A once; `ex2.approx.ftz.f32` is
//   exp2f's instruction without its denormal handling (MUFU.EX2 alone), 2
//   ulp, well inside the 1e-4 tolerance against the plain version.
//
// Where the time goes now (H100 80GB HBM3, 700 W, falcon shape).  The
// memory side alone holds about 0.15 ms: at N = 8 or N = 4, a half or a
// quarter of the exponentials on the same 403 MB, the kernel takes 0.154
// and 0.150 ms (2.6-2.7 TB/s).  The arithmetic alone holds about 0.19 ms:
// without any device-memory traffic it takes 0.186 ms; replacing the
// exponential by an FMA, or the B and C loads by arithmetic, changes
// nothing.  The loop issues about 32 instructions a warp and step (eight a
// state: the exponential, four float32 operations, the loads, the chunk's
// copies and stores) at about 1.4 clocks an instruction with four warps an
// SM sub-partition, so issue, not one pipe, is the limit; what stalls it is
// not measured (no profiler of stalls runs there).  Tiles of 32 or 64
// steps, 2-6 stages, 8 states a lane, 256 threads a block, loads fed by
// TMA instead of cp.async, or the exponentials of a chunk hoisted before
// its updates all ran within 0.184-0.236 ms.
//
// The time axis is not split: a chunked two-pass scan would read dt and x
// twice and take every exponential twice.  Shared memory a block:
// kStages x (2 kChunk kChannels + 2 kChunk N) + 2 x 128 (kChunk + 4)
// floats: 44 KB at N = 16, 56 KB at N = 8, 86 KB at N = 4.

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
constexpr int kChunk = 16;          // time steps a stage
constexpr int kStages = 4;          // depth of the cp.async ring
constexpr int kStatesPerLane = 4;   // states of one channel a lane holds
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Tile {
  static_assert(N % kStatesPerLane == 0, "N must be a multiple of 4");
  static constexpr int kLanes = N / kStatesPerLane;     // lanes a channel
  static constexpr int kChannels = kThreads / kLanes;   // channels a block
  static_assert(kChannels % 32 == 0 && kChunk % 4 == 0);
  // shared memory, in floats: kStages x [dt | x | B | C], then 2 x partials
  static constexpr int kIo = kChunk * kChannels;
  static constexpr int kBc = kChunk * N;
  static constexpr int kStage = 2 * kIo + 2 * kBc;
  // partial sums of y: one row of kChunk steps (padded by 4 floats, so
  // neighbouring channels' 16-byte accesses miss each other's banks) for
  // each (state group, channel)
  static constexpr int kRow = kChunk + 4;
  static constexpr int kPartial = kLanes * kChannels * kRow;
  static constexpr int kBytes = (kStages * kStage + 2 * kPartial) * 4;
};

// Issue the copies of time chunk `t0` of one (batch row, channel tile) into
// one ring stage: the dt and x tiles (kChunk x kChannels, rows d_inner
// apart in device memory) and the B and C rows (kChunk x N, contiguous).
template <int N, bool kVec>
__device__ __forceinline__ void load_chunk(float* stage, const float* dt, const float* x,
                                           const float* b, const float* c, size_t row0,
                                           int t0, int seqlen, int d0, int d_inner) {
  using T = Tile<N>;
  constexpr int kWidth = kVec ? 4 : 1;  // floats a copy
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
    if constexpr (kVec) {
      copy16(stage + t * T::kChannels + col, dt + off, bytes);
      copy16(stage + T::kIo + t * T::kChannels + col, x + off, bytes);
    } else {
      copy4(stage + t * T::kChannels + col, dt + off, bytes);
      copy4(stage + T::kIo + t * T::kChannels + col, x + off, bytes);
    }
  }
  const int live = min(kChunk, seqlen - t0) * N;  // floats of B (and C) in range
  const size_t bc = (row0 + t0) * N;
#pragma unroll
  for (int i = 0; i < (T::kBc + kThreads * kWidth - 1) / (kThreads * kWidth); ++i) {
    const int p = (threadIdx.x + i * kThreads) * kWidth;
    if (p >= T::kBc) break;
    const bool valid = p < live;
    const size_t off = valid ? bc + p : 0;
    const int bytes = valid ? 4 * kWidth : 0;
    if constexpr (kVec) {
      copy16(stage + 2 * T::kIo + p, b + off, bytes);
      copy16(stage + 2 * T::kIo + T::kBc + p, c + off, bytes);
    } else {
      copy4(stage + 2 * T::kIo + p, b + off, bytes);
      copy4(stage + 2 * T::kIo + T::kBc + p, c + off, bytes);
    }
  }
}

// Sum each channel's kLanes partials of a finished chunk and store its y
// rows: a thread takes four steps of one channel (16-byte shared loads), a
// warp stores 32 neighbouring channels of one step at a time.
template <int N>
__device__ __forceinline__ void store_chunk(const float* partial, float* y, size_t row0,
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
      float* out = y + (row0 + t0 + t) * d_inner + d0 + ch;
      const int live = seqlen - t0 - t;
      if (live > 0) out[0] = sum.x;
      if (live > 1) out[d_inner] = sum.y;
      if (live > 2) out[2 * d_inner] = sum.z;
      if (live > 3) out[3 * d_inner] = sum.w;
    }
  }
}

template <int N, bool kVec, bool kSave>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const float* __restrict__ dt,  // (B, S, di)
                          const float* __restrict__ a,   // (di, N)
                          const float* __restrict__ b,   // (B, S, N)
                          const float* __restrict__ c,   // (B, S, N)
                          const float* __restrict__ x,   // (B, S, di)
                          float* __restrict__ y,         // (B, S, di)
                          float* __restrict__ states,    // (B, chunks, di, N) or null
                          int seqlen, int d_inner) {
  using T = Tile<N>;
  extern __shared__ __align__(16) float smem[];
  float* partials = smem + kStages * T::kStage;

  const int d0 = blockIdx.x * T::kChannels;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seqlen;  // first (b, t) row
  const int chunks = (seqlen + kChunk - 1) / kChunk;

  // warp w takes states group w % kLanes of 32 channels: the warp's lanes
  // read one B and C row (a broadcast) and neighbouring dt, x and partials
  const int warp = threadIdx.x / 32;
  const int group = warp % T::kLanes;
  const int ch = (warp / T::kLanes) * 32 + threadIdx.x % 32;  // this lane's channel in the tile
  const int n0 = group * kStatesPerLane;  // and its first state
  float a2[kStatesPerLane], h[kStatesPerLane];
#pragma unroll
  for (int i = 0; i < kStatesPerLane; ++i) {
    a2[i] = d0 + ch < d_inner ? a[static_cast<size_t>(d0 + ch) * N + n0 + i] * kLog2e : 0.0f;
    h[i] = 0.0f;
  }

  // prologue: chunks 0 .. kStages-2 in flight, one commit group each
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < chunks) {
      load_chunk<N, kVec>(smem + k * T::kStage, dt, x, b, c, row0, k * kChunk, seqlen, d0, d_inner);
    }
    commit();
  }

  for (int k = 0; k < chunks; ++k) {
    wait_pending<kStages - 2>();  // this thread's copies of chunk k have landed
    __syncthreads();  // everyone's have; stage (k-1) % kStages and partials (k-1) % 2 are free
    if (k + kStages - 1 < chunks) {
      load_chunk<N, kVec>(smem + ((k + kStages - 1) % kStages) * T::kStage, dt, x, b, c, row0,
                          (k + kStages - 1) * kChunk, seqlen, d0, d_inner);
    }
    commit();

    if (kSave && d0 + ch < d_inner) {
      // the state entering chunk k, four states of this lane's channel
      const size_t at = ((static_cast<size_t>(blockIdx.y) * chunks + k) * d_inner + d0 + ch) * N + n0;
      *reinterpret_cast<float4*>(states + at) = make_float4(h[0], h[1], h[2], h[3]);
    }
    const float* stage = smem + (k % kStages) * T::kStage;
    const float* s_dt = stage + ch;
    const float* s_x = stage + T::kIo + ch;
    const float4* s_b = reinterpret_cast<const float4*>(stage + 2 * T::kIo + n0);
    const float4* s_c = reinterpret_cast<const float4*>(stage + 2 * T::kIo + T::kBc + n0);
    // the partial sums stay in registers until the chunk's last step: a
    // shared store between two steps would keep the compiler from hoisting
    // the next steps' shared loads and exponentials above it
    float acc[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const float dt_v = s_dt[t * T::kChannels];
      const float dx = dt_v * s_x[t * T::kChannels];
      const float4 bv = s_b[t * (N / 4)];
      const float4 cv = s_c[t * (N / 4)];
      h[0] = fmaf(h[0], exp2_approx(dt_v * a2[0]), dx * bv.x);
      h[1] = fmaf(h[1], exp2_approx(dt_v * a2[1]), dx * bv.y);
      h[2] = fmaf(h[2], exp2_approx(dt_v * a2[2]), dx * bv.z);
      h[3] = fmaf(h[3], exp2_approx(dt_v * a2[3]), dx * bv.w);
      acc[t] = fmaf(h[3], cv.w, fmaf(h[2], cv.z, fmaf(h[1], cv.y, h[0] * cv.x)));
    }
    float* part = partials + (k % 2) * T::kPartial + (group * T::kChannels + ch) * T::kRow;
#pragma unroll
    for (int t = 0; t < kChunk; t += 4) {
      *reinterpret_cast<float4*>(part + t) = make_float4(acc[t], acc[t + 1], acc[t + 2], acc[t + 3]);
    }
    if (k > 0) {
      store_chunk<N>(partials + ((k - 1) % 2) * T::kPartial, y, row0, (k - 1) * kChunk, seqlen,
                     d0, d_inner);
    }
  }
  __syncthreads();
  store_chunk<N>(partials + ((chunks - 1) % 2) * T::kPartial, y, row0, (chunks - 1) * kChunk,
                 seqlen, d0, d_inner);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int N, bool kVec, bool kSave>
cudaError_t launch(const float* dt, const float* a, const float* b, const float* c,
                   const float* x, float* y, float* states, int batch, int seqlen,
                   int d_inner, cudaStream_t stream) {
  using T = Tile<N>;
  auto kernel = selective_scan_fwd_kernel<N, kVec, kSave>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((d_inner + T::kChannels - 1) / T::kChannels, batch);
  kernel<<<grid, kThreads, T::kBytes, stream>>>(dt, a, b, c, x, y, states, seqlen, d_inner);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const float* dt, const float* a, const float* b, const float* c,
                   const float* x, float* y, float* states, int batch, int seqlen,
                   int d_inner, cudaStream_t stream) {
  const bool vec = d_inner % 4 == 0 && aligned16(dt) && aligned16(x) && aligned16(b) &&
                   aligned16(c);
  if (states != nullptr) {
    return vec ? launch<N, true, true>(dt, a, b, c, x, y, states, batch, seqlen, d_inner, stream)
               : launch<N, false, true>(dt, a, b, c, x, y, states, batch, seqlen, d_inner, stream);
  }
  return vec ? launch<N, true, false>(dt, a, b, c, x, y, states, batch, seqlen, d_inner, stream)
             : launch<N, false, false>(dt, a, b, c, x, y, states, batch, seqlen, d_inner, stream);
}

template <int N>
void describe(int* out) {
  out[0] = kChunk;
  out[1] = Tile<N>::kChannels;
  out[2] = kStages;
  out[3] = Tile<N>::kBytes;
}

}  // namespace

// Plain C entry point (bound with ctypes).  `states` is null, or float32
// (B, ceil(S / kChunk), d_inner, d_state), 16-byte aligned, and receives the
// state entering each time chunk.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a state width without an
// instantiation or an empty shape.
extern "C" int selective_scan_fwd_f32(const float* dt, const float* a,
                                      const float* b, const float* c,
                                      const float* x, float* y, float* states,
                                      int batch, int seqlen, int d_inner, int d_state,
                                      void* stream) {
  if (batch <= 0 || seqlen <= 0 || d_inner <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4:
      return static_cast<int>(launch<4>(dt, a, b, c, x, y, states, batch, seqlen, d_inner, s));
    case 8:
      return static_cast<int>(launch<8>(dt, a, b, c, x, y, states, batch, seqlen, d_inner, s));
    case 16:
      return static_cast<int>(launch<16>(dt, a, b, c, x, y, states, batch, seqlen, d_inner, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tiling of the instantiation for `d_state`: writes {time steps a
// chunk, channels a block, ring stages, dynamic shared memory bytes} to
// `out` and returns 0, or returns cudaErrorInvalidValue.
extern "C" int selective_scan_tiles(int d_state, int* out) {
  switch (d_state) {
    case 4: describe<4>(out); return 0;
    case 8: describe<8>(out); return 0;
    case 16: describe<16>(out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
