// Mamba-1 selective scan, forward, float32 — hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `selective_scan` in
// src/repro/kernels/mamba_scan/kernel.py (body `_kernel`, grid over
// (batch, d_inner blocks, seq chunks) with the (block_d, N) state carried
// across the sequential chunk axis in VMEM scratch).  That grid relies on
// the TPU running chunks in order; no CUDA block carries state to another,
// so the time loop lives inside the thread instead:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = sum_n h_t * C_t,
//   h_0 = 0; the final state is not returned (as in the TPU kernel).
//
// Design: one thread per (batch, channel).  The N-wide state h[N] and the
// channel's row a[d, :] live in registers; the loop over t runs inside the
// thread.  Loads of dt and x (and the store of y) are coalesced across
// neighbouring channels of a warp.  B_t and C_t are read by every thread of
// the block, so they are staged through shared memory one chunk of
// timesteps at a time.  expf (not __expf) keeps the result within 1e-4 of
// the plain version.
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s float32 without
// tensor cores): at B=2, S=2048, d_inner=8192, N=16 the kernel must read dt
// and x and write y, 3 x 134 MB = 403 MB (B, C and A are < 1 MB), which is
// 0.120 ms; its float work is about 7 operations per (b, t, d, n) including
// the exp, 3.8 GFLOP or 0.056 ms.  So bytes bound it.  This simple design
// runs only B * d_inner = 16,384 threads with a sequential chain of S steps
// each, so it is expected to be latency-bound well above that bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kChunk = 64;    // timesteps of B and C staged per pass

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const float* __restrict__ dt,  // (B, S, di)
                          const float* __restrict__ a,   // (di, N)
                          const float* __restrict__ b,   // (B, S, N)
                          const float* __restrict__ c,   // (B, S, N)
                          const float* __restrict__ x,   // (B, S, di)
                          float* __restrict__ y,         // (B, S, di)
                          int seqlen, int d_inner) {
  __shared__ float s_b[kChunk * N];
  __shared__ float s_c[kChunk * N];

  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  const bool live = d < d_inner;

  float a_row[N];
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a_row[n] = live ? a[static_cast<size_t>(d) * N + n] : 0.0f;
    h[n] = 0.0f;
  }

  const size_t bc_base = static_cast<size_t>(bi) * seqlen * N;
  const size_t io_base = static_cast<size_t>(bi) * seqlen * d_inner + d;

  for (int t0 = 0; t0 < seqlen; t0 += kChunk) {
    const int steps = min(kChunk, seqlen - t0);
    // the chunk's B and C rows are contiguous: steps * N floats each
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      s_b[i] = b[bc_base + static_cast<size_t>(t0) * N + i];
      s_c[i] = c[bc_base + static_cast<size_t>(t0) * N + i];
    }
    __syncthreads();
    if (live) {
      for (int tt = 0; tt < steps; ++tt) {
        const size_t off = io_base + static_cast<size_t>(t0 + tt) * d_inner;
        const float dt_v = dt[off];
        const float dx = dt_v * x[off];
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = h[n] * expf(dt_v * a_row[n]) + dx * s_b[tt * N + n];
          acc += h[n] * s_c[tt * N + n];
        }
        y[off] = acc;
      }
    }
    __syncthreads();
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* a, const float* b,
                   const float* c, const float* x, float* y, int batch,
                   int seqlen, int d_inner, cudaStream_t stream) {
  dim3 grid((d_inner + kThreads - 1) / kThreads, batch);
  selective_scan_fwd_kernel<N><<<grid, kThreads, 0, stream>>>(
      dt, a, b, c, x, y, seqlen, d_inner);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a state width without an
// instantiation or an empty shape.
extern "C" int selective_scan_fwd_f32(const float* dt, const float* a,
                                      const float* b, const float* c,
                                      const float* x, float* y, int batch,
                                      int seqlen, int d_inner, int d_state,
                                      void* stream) {
  if (batch <= 0 || seqlen <= 0 || d_inner <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_state) {
    case 4:
      return static_cast<int>(launch<4>(dt, a, b, c, x, y, batch, seqlen, d_inner, s));
    case 8:
      return static_cast<int>(launch<8>(dt, a, b, c, x, y, batch, seqlen, d_inner, s));
    case 16:
      return static_cast<int>(launch<16>(dt, a, b, c, x, y, batch, seqlen, d_inner, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
