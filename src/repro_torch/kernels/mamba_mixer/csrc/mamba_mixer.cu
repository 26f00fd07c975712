// The mamba-1 mixer's elementwise work around K2 in prefill: three passes,
// hand-written for Hopper (sm_90a), one launch each.
//
// Replaces no TPU kernel.  The reference (src/repro/models/mamba.py,
// `mamba_mixer`: `_causal_conv`, SiLU, `_ssm_inputs`' softplus, the D skip
// and the silu(z) gate) leaves this chain to XLA, which fuses elementwise
// work itself.  The port ran it as a dozen or more PyTorch operations a
// layer: a padding `cat`, transposes, the depthwise conv, SiLU, the dt
// bias cast, add and softplus, float32 widenings, the D skip, silu(z), the
// gate and the cast back, each a pass over device memory.  The three passes
// compute the same roundings (round_c rounds to the compute dtype, bf16 or
// float32, to nearest even):
//
//   mixer_conv_silu:   x_conv = round_c(silu(round_c(b + sum_k w_k x_{t-K+1+k})))
//                      from zero history, and xf = float(x_conv), K2's x;
//   mixer_dt_softplus: dt = float(round_c(softplus(round_c(dt_raw + round_c(dt_bias)))));
//   mixer_gate:        out = round_c((y + xf D) silu(float(z))), each
//                      operation rounded to float32 as PyTorch's are.
//
// What bounds them on an H100 SXM (HBM3 at 3.35 TB/s): bytes.  They do a
// few operations an element and move 6-12 bytes for each.  At
// falcon-mamba-7b's d_inner 8,192 in bf16, per token: the conv pass reads
// xin (16 KB) and writes x_conv (16 KB) and xf (32 KB); the dt pass reads
// dt_raw (16 KB) and writes dt (32 KB); the gate reads y (32 KB), x_conv
// (16 KB) and z (16 KB) and writes out (16 KB).  That is 192 KB a token
// against about 600 KB for the PyTorch chain; at B = 1 x 8,192 tokens the
// three bounds are 0.160, 0.120 and 0.200 ms.
//
// So the design moves each byte once and as wide accesses:
// * Each input is read once and each output written once, coalesced: a
//   thread owns V neighbouring channels, V = 16 bytes of the compute dtype
//   (8 in bf16, 4 in float32), read and written as 16-byte accesses (32
//   bytes for V float32 values in bf16).  The x and z halves of in_proj's
//   output are read in place through their (batch, position) strides (a
//   row stride of 2 d_inner), so no `chunk` copy and no padding exists.
// * conv: a thread walks a run of kRun = 4 positions.  It issues the
//   run's loads first, so they are in flight together, keeps the last
//   K - 1 inputs in registers as it walks, and reads the K - 1 rows before
//   the run (the halo; its neighbour's rows, so from L2) once at its
//   start; rows before position 0 are zero.  The grid is (position runs,
//   channel blocks, batch): at B = 1 x 1,024 tokens and d_inner 8,192,
//   2,048 blocks of 128 threads.  Runs of 4 beat runs of 8, 16 and 32 at
//   every falcon prompt length from 2,048 tokens (0.198 against 0.224,
//   0.268 and 0.708 ms at 8,192; H100 80GB HBM3, 700 W): a longer run
//   holds more registers (116 at 4, 154 at 8, 214 at 16, a spill at 32),
//   so fewer threads an SM keep loads in flight.
// * dt and gate: one block per (row, 128 V channels), one V-group a thread.
// * A scalar instantiation (V = 1) takes a d_inner that is no multiple of
//   V, or a base or row stride that is not 16-byte aligned.
// * The arithmetic is PyTorch's, so the roundings land where they did:
//   fmaf along the taps from the bias (PyTorch's depthwise kernel's
//   `value += w * x`, contracted by nvcc); expf and log1pf from CUDA's math
//   library, which PyTorch's SiLU and softplus kernels call; __fmul_rn and
//   __fadd_rn in the gate, which keep nvcc from contracting a product and
//   a sum that PyTorch rounds apart into one FMA.
//
// On an H100 80GB HBM3 at 700 W, bf16, B = 1 x 8,192 tokens: 0.198, 0.146
// and 0.221 ms, 81, 82 and 91% of the three bounds, against 1.81, 0.51
// and 1.29 ms for the PyTorch chain; every output equal to the chain's,
// bit for bit, at random inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kRun = 4;        // positions a conv thread walks
constexpr int kWidth = 4;      // the conv's taps (every configuration's ssm_conv)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_c(float v) { return widen(narrow<T>(v)); }

// silu in float32 as PyTorch computes it: x / (1 + exp(-x))
__device__ __forceinline__ float silu(float v) { return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v))); }

// V neighbouring values, moved as one access (two for 32 bytes)
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p) = v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mixer_conv_silu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ out,
                           float* __restrict__ out_f32, int seqlen, int d_inner,
                           long long stride_b, long long stride_s) {
  const int c = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (c >= d_inner) return;
  const int t0 = blockIdx.x * kRun;
  const T* xb = x + blockIdx.z * stride_b + c;
  const size_t ob = static_cast<size_t>(blockIdx.z) * seqlen * d_inner + c;

  Pack<T, V> rows[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (t0 + i < seqlen) rows[i] = load<T, V>(xb + (t0 + i) * stride_s);
  }
  float wk[kWidth][V], acc0[V], win[kWidth - 1][V];  // win[j]: x at t - (K - 1) + j
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    const Pack<T, V> p = load<T, V>(w + static_cast<size_t>(k) * d_inner + c);
#pragma unroll
    for (int v = 0; v < V; ++v) wk[k][v] = widen(p.v[v]);
  }
  const Pack<T, V> pb = load<T, V>(bias + c);
#pragma unroll
  for (int v = 0; v < V; ++v) acc0[v] = widen(pb.v[v]);
#pragma unroll
  for (int j = 0; j < kWidth - 1; ++j) {
    const int t = t0 - (kWidth - 1) + j;
    Pack<T, V> p;
    if (t >= 0) p = load<T, V>(xb + t * stride_s);
#pragma unroll
    for (int v = 0; v < V; ++v) win[j][v] = t >= 0 ? widen(p.v[v]) : 0.0f;
  }

#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (t0 + i >= seqlen) break;
    Pack<T, V> o;
    Pack<float, V> of;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float cur = widen(rows[i].v[v]);
      float acc = acc0[v];
#pragma unroll
      for (int k = 0; k < kWidth - 1; ++k) acc = fmaf(wk[k][v], win[k][v], acc);
      acc = fmaf(wk[kWidth - 1][v], cur, acc);
      o.v[v] = narrow<T>(silu(round_c<T>(acc)));
      of.v[v] = widen(o.v[v]);
#pragma unroll
      for (int k = 0; k < kWidth - 2; ++k) win[k][v] = win[k + 1][v];
      win[kWidth - 2][v] = cur;
    }
    const size_t off = ob + static_cast<size_t>(t0 + i) * d_inner;
    store<T, V>(out + off, o);
    store<float, V>(out_f32 + off, of);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mixer_dt_softplus_kernel(const T* __restrict__ dt_raw, const float* __restrict__ bias,
                             float* __restrict__ dt, int d_inner) {
  const int c = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (c >= d_inner) return;
  const size_t e = static_cast<size_t>(blockIdx.x) * d_inner + c;
  const Pack<T, V> r = load<T, V>(dt_raw + e);
  const Pack<float, V> b = load<float, V>(bias + c);
  Pack<float, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float u = round_c<T>(widen(r.v[v]) + round_c<T>(b.v[v]));
    // PyTorch's softplus at beta 1, threshold 20
    o.v[v] = round_c<T>(u > 20.0f ? u : log1pf(expf(u)));
  }
  store<float, V>(dt + e, o);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mixer_gate_kernel(const float* __restrict__ y, const T* __restrict__ xc,
                      const float* __restrict__ D, const T* __restrict__ z, T* __restrict__ out,
                      int seqlen, int d_inner, long long z_stride_b, long long z_stride_s) {
  const int c = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (c >= d_inner) return;
  const int row = blockIdx.x;  // b * seqlen + t
  const int b = row / seqlen;
  const size_t e = static_cast<size_t>(row) * d_inner + c;
  const Pack<float, V> yv = load<float, V>(y + e);
  const Pack<T, V> xv = load<T, V>(xc + e);
  const Pack<float, V> dv = load<float, V>(D + c);
  const Pack<T, V> zv = load<T, V>(z + b * z_stride_b + (row - b * seqlen) * z_stride_s + c);
  Pack<T, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float skip = __fadd_rn(yv.v[v], __fmul_rn(widen(xv.v[v]), dv.v[v]));
    o.v[v] = narrow<T>(__fmul_rn(skip, silu(widen(zv.v[v]))));
  }
  store<T, V>(out + e, o);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the 16-byte instantiation takes these: d_inner and every row
// stride whole groups of V, every base 16-byte aligned.
template <typename T>
bool vec_ok(int d_inner, std::initializer_list<long long> strides,
            std::initializer_list<const void*> bases) {
  constexpr long long kV = 16 / sizeof(T);
  if (d_inner % kV != 0) return false;
  for (long long s : strides) {
    if (s % kV != 0) return false;
  }
  for (const void* p : bases) {
    if (!aligned16(p)) return false;
  }
  return true;
}

dim3 row_grid(int rows, int d_inner, int v) {
  return dim3(rows, (d_inner + kThreads * v - 1) / (kThreads * v));
}

template <typename T>
cudaError_t conv(const void* x, const void* w, const void* bias, void* out, float* out_f32,
                 int batch, int seqlen, int d_inner, long long stride_b, long long stride_s,
                 cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = vec_ok<T>(d_inner, {stride_b, stride_s}, {x, w, bias, out, out_f32});
  const int v = vec ? kV : 1;
  const dim3 grid((seqlen + kRun - 1) / kRun, (d_inner + kThreads * v - 1) / (kThreads * v),
                  batch);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (vec) {
    mixer_conv_silu_kernel<T, kV><<<grid, kThreads, 0, stream>>>(
        xt, wt, bt, ot, out_f32, seqlen, d_inner, stride_b, stride_s);
  } else {
    mixer_conv_silu_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        xt, wt, bt, ot, out_f32, seqlen, d_inner, stride_b, stride_s);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dt_softplus(const void* dt_raw, const float* bias, float* dt, int rows, int d_inner,
                        cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = vec_ok<T>(d_inner, {}, {dt_raw, bias, dt});
  const T* raw = static_cast<const T*>(dt_raw);
  if (vec) {
    mixer_dt_softplus_kernel<T, kV>
        <<<row_grid(rows, d_inner, kV), kThreads, 0, stream>>>(raw, bias, dt, d_inner);
  } else {
    mixer_dt_softplus_kernel<T, 1>
        <<<row_grid(rows, d_inner, 1), kThreads, 0, stream>>>(raw, bias, dt, d_inner);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t gate(const float* y, const void* xc, const float* D, const void* z, void* out,
                 int batch, int seqlen, int d_inner, long long z_stride_b, long long z_stride_s,
                 cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = vec_ok<T>(d_inner, {z_stride_b, z_stride_s}, {y, xc, D, z, out});
  const int rows = batch * seqlen;
  const T* xt = static_cast<const T*>(xc);
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  if (vec) {
    mixer_gate_kernel<T, kV><<<row_grid(rows, d_inner, kV), kThreads, 0, stream>>>(
        y, xt, D, zt, ot, seqlen, d_inner, z_stride_b, z_stride_s);
  } else {
    mixer_gate_kernel<T, 1><<<row_grid(rows, d_inner, 1), kThreads, 0, stream>>>(
        y, xt, D, zt, ot, seqlen, d_inner, z_stride_b, z_stride_s);
  }
  return cudaGetLastError();
}

constexpr int kFloat32 = 0;
constexpr int kBfloat16 = 1;

bool bad_shape(int batch, int seqlen, int d_inner, int dtype) {
  return batch <= 0 || batch > 65535 || seqlen <= 0 || d_inner <= 0 ||
         static_cast<long long>(batch) * seqlen > 0x7fffffffLL ||
         (dtype != kFloat32 && dtype != kBfloat16);
}

}  // namespace

// Plain C entry points (bound with ctypes).  `dtype` is the compute dtype:
// 0 float32, 1 bfloat16.  Strides are in elements; every last dimension is
// contiguous, and outputs are contiguous (B, S, d_inner).  Each launches on
// `stream`, does not synchronise and allocates nothing, and returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// width, dtype or shape it has no instantiation or grid for.

// xin (B, S, d_inner) through (stride_b, stride_s); w (width, d_inner) and
// bias (d_inner,) contiguous in the compute dtype; out in the compute dtype,
// out_f32 float32.
extern "C" int mixer_conv_silu(const void* xin, const void* w, const void* bias, void* out,
                               float* out_f32, int batch, int seqlen, int d_inner, int width,
                               long long stride_b, long long stride_s, int dtype, void* stream) {
  if (width != kWidth || bad_shape(batch, seqlen, d_inner, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBfloat16
          ? conv<__nv_bfloat16>(xin, w, bias, out, out_f32, batch, seqlen, d_inner, stride_b,
                                stride_s, s)
          : conv<float>(xin, w, bias, out, out_f32, batch, seqlen, d_inner, stride_b, stride_s,
                        s));
}

// dt_raw (rows, d_inner) contiguous in the compute dtype; bias (d_inner,)
// float32; dt (rows, d_inner) float32.
extern "C" int mixer_dt_softplus(const void* dt_raw, const float* bias, float* dt, int rows,
                                 int d_inner, int dtype, void* stream) {
  if (bad_shape(1, rows, d_inner, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == kBfloat16
                              ? dt_softplus<__nv_bfloat16>(dt_raw, bias, dt, rows, d_inner, s)
                              : dt_softplus<float>(dt_raw, bias, dt, rows, d_inner, s));
}

// y (B, S, d_inner) float32 and x_conv in the compute dtype, contiguous;
// D (d_inner,) float32; z (B, S, d_inner) through (z_stride_b, z_stride_s)
// in the compute dtype; out contiguous in the compute dtype.
extern "C" int mixer_gate(const float* y, const void* x_conv, const float* D, const void* z,
                          void* out, int batch, int seqlen, int d_inner, long long z_stride_b,
                          long long z_stride_s, int dtype, void* stream) {
  if (bad_shape(batch, seqlen, d_inner, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBfloat16
          ? gate<__nv_bfloat16>(y, x_conv, D, z, out, batch, seqlen, d_inner, z_stride_b,
                                z_stride_s, s)
          : gate<float>(y, x_conv, D, z, out, batch, seqlen, d_inner, z_stride_b, z_stride_s,
                        s));
}
