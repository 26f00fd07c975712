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
//
// Training differentiates the same chain, so each pass has a backward
// (three more passes, one launch each, plus a small second pass for the
// channel sums).  Each recomputes what its forward computed from what the
// forward read, in the forward's arithmetic, and applies the derivative in
// the order PyTorch's backward kernels round (round_c where autograd's
// chain holds a tensor of the compute dtype):
//
//   mixer_gate_bwd:        from g (compute dtype): dy = float(g) silu(zf),
//                          dxf = dy D, dz = round_c(silu'(zf) float(g) (y + xf D)),
//                          dD = sum over (B, S) of dy xf;
//   mixer_dt_softplus_bwd: from ddt (float32), u = round_c(dt_raw + round_c(dt_bias)):
//                          d dt_raw = round_c(softplus'(u) round_c(ddt)),
//                          d dt_bias = round_c(sum over (B, S) of d dt_raw);
//   mixer_conv_silu_bwd:   from the gradients of x_conv (compute dtype, from
//                          x_proj's product) and of xf (float32, from K2 and
//                          from the gate), added as autograd adds them:
//                          dpre = round_c(silu'(pre) round_c(round_c(g_K2 + g_gate) + g_conv)),
//                          with pre the conv recomputed from the 4 taps;
//                          d xin[t] = round_c(sum_k w_k dpre[t + K - 1 - k]),
//                          dw_k, db = round_c(sums over (B, S) of dpre x[t - K + 1 + k], dpre).
//
// They are bytes-bound too: per element in bf16 the gate's backward moves
// 20 bytes (reads g, y, x_conv, z; writes dy, dxf, dz), the dt softplus's
// 8 (reads ddt, dt_raw; writes d dt_raw), the conv's 14 (reads xin, the
// x_conv gradient and the two float32 xf gradients; writes d xin).  The
// PyTorch chain's backward (autograd's float32 and bf16 elementwise kernels
// and the depthwise conv's two backward kernels) moves several times that.
// The design is the forward's: a thread owns V = 4 neighbouring channels
// (16-byte float32 accesses, 8-byte bf16 ones; V = 1 on the scalar path)
// and walks runs of positions, loads first (kRun = 4 in the gate and dt
// softplus, kConvRun = 2 in the conv).  A block walks `chunk`
// rows (positions for the conv) of 128 V channels: the conv's backward
// carries its window of x behind and of dpre ahead from run to run, so
// only a block's K - 1 halo rows at either end are read twice.  The sums
// over (B, S) are deterministic: each block writes its channels' partial
// sums to its own row of a float32 workspace, and mixer_channel_sum adds
// the rows in order; no atomics, so two calls give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kRun = 4;        // positions a conv thread walks (and a gate or dt backward run)
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

// g times SiLU's derivative at x, as PyTorch's silu_backward computes it
__device__ __forceinline__ float silu_grad(float g, float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return g * s * (1.0f + x * (1.0f - s));
}

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

// ---- backward passes ----

constexpr int kVb = 4;       // channels a backward thread owns on the vector path
constexpr int kConvRun = 2;  // positions a conv backward thread loads at once (at 4 the bf16
                             // instantiation spills)

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mixer_gate_bwd_kernel(const T* __restrict__ g, const float* __restrict__ y,
                          const T* __restrict__ xc, const float* __restrict__ D,
                          const T* __restrict__ z, float* __restrict__ dy,
                          float* __restrict__ dxf, T* __restrict__ dz, float* __restrict__ part,
                          int rows, int chunk, int seqlen, int d_inner, long long z_stride_b,
                          long long z_stride_s) {
  const int c = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (c >= d_inner) return;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows);
  const Pack<float, V> dv = load<float, V>(D + c);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;

  for (int r = r0; r < r1; r += kRun) {
    Pack<T, V> gv[kRun], xv[kRun], zv[kRun];
    Pack<float, V> yv[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int row = r + i;
      if (row >= r1) break;
      const size_t e = static_cast<size_t>(row) * d_inner + c;
      const int b = row / seqlen;
      gv[i] = load<T, V>(g + e);
      yv[i] = load<float, V>(y + e);
      xv[i] = load<T, V>(xc + e);
      zv[i] = load<T, V>(z + b * z_stride_b + (row - b * seqlen) * z_stride_s + c);
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int row = r + i;
      if (row >= r1) break;
      Pack<float, V> dyo, dxo;
      Pack<T, V> dzo;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gf = widen(gv[i].v[v]), zf = widen(zv[i].v[v]), xf = widen(xv[i].v[v]);
        const float skip = __fadd_rn(yv[i].v[v], __fmul_rn(xf, dv.v[v]));
        const float dskip = __fmul_rn(gf, silu(zf));  // the gradient of y and of xf D
        dyo.v[v] = dskip;
        dxo.v[v] = __fmul_rn(dskip, dv.v[v]);
        dzo.v[v] = narrow<T>(silu_grad(__fmul_rn(gf, skip), zf));
        acc[v] = __fadd_rn(acc[v], __fmul_rn(dskip, xf));
      }
      const size_t e = static_cast<size_t>(row) * d_inner + c;
      store<float, V>(dy + e, dyo);
      store<float, V>(dxf + e, dxo);
      store<T, V>(dz + e, dzo);
    }
  }
  Pack<float, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) o.v[v] = acc[v];
  store<float, V>(part + static_cast<size_t>(blockIdx.x) * d_inner + c, o);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mixer_dt_softplus_bwd_kernel(const float* __restrict__ ddt, const T* __restrict__ dt_raw,
                                 const float* __restrict__ bias, T* __restrict__ ddt_raw,
                                 float* __restrict__ part, int rows, int chunk, int d_inner) {
  const int c = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (c >= d_inner) return;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows);
  const Pack<float, V> bv = load<float, V>(bias + c);
  float bc[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    bc[v] = round_c<T>(bv.v[v]);
    acc[v] = 0.0f;
  }

  for (int r = r0; r < r1; r += kRun) {
    Pack<float, V> gv[kRun];
    Pack<T, V> rv[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (r + i >= r1) break;
      const size_t e = static_cast<size_t>(r + i) * d_inner + c;
      gv[i] = load<float, V>(ddt + e);
      rv[i] = load<T, V>(dt_raw + e);
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (r + i >= r1) break;
      Pack<T, V> o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float u = round_c<T>(widen(rv[i].v[v]) + bc[v]);
        const float gb = round_c<T>(gv[i].v[v]);
        // PyTorch's softplus_backward at beta 1, threshold 20
        const float ez = expf(u);
        const float du =
            round_c<T>(u > 20.0f ? gb : __fdiv_rn(__fmul_rn(gb, ez), __fadd_rn(ez, 1.0f)));
        o.v[v] = narrow<T>(du);
        acc[v] = __fadd_rn(acc[v], du);
      }
      store<T, V>(ddt_raw + static_cast<size_t>(r + i) * d_inner + c, o);
    }
  }
  Pack<float, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) o.v[v] = acc[v];
  store<float, V>(part + static_cast<size_t>(blockIdx.x) * d_inner + c, o);
}

// Positions [t0, t1) of one batch row: dpre is computed over [t0, t1 + K - 1)
// (the K - 1 rows after the block its halo, for d xin), x read over
// [t0 - K + 1, t1 + K - 1); d xin written and dw, db summed over [t0, t1).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mixer_conv_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               const T* __restrict__ bias, const T* __restrict__ g_conv,
                               const float* __restrict__ g_xf, const float* __restrict__ g_gate,
                               T* __restrict__ dx, float* __restrict__ part, int chunk,
                               int seqlen, int d_inner, long long stride_b, long long stride_s) {
  const int c = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (c >= d_inner) return;
  const int t0 = blockIdx.x * chunk;
  const int t1 = min(t0 + chunk, seqlen);
  const int tend = t1 + kWidth - 1;
  const T* xb = x + blockIdx.z * stride_b + c;
  const size_t ob = static_cast<size_t>(blockIdx.z) * seqlen * d_inner + c;

  float wk[kWidth][V], acc0[V], win[kWidth - 1][V], dwin[kWidth - 1][V];
  float dw[kWidth][V], db[V];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    const Pack<T, V> p = load<T, V>(w + static_cast<size_t>(k) * d_inner + c);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      wk[k][v] = widen(p.v[v]);
      dw[k][v] = 0.0f;
    }
  }
  const Pack<T, V> pb = load<T, V>(bias + c);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc0[v] = widen(pb.v[v]);
    db[v] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kWidth - 1; ++j) {
    const int t = t0 - (kWidth - 1) + j;
    Pack<T, V> p;
    if (t >= 0) p = load<T, V>(xb + t * stride_s);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      win[j][v] = t >= 0 ? widen(p.v[v]) : 0.0f;
      dwin[j][v] = 0.0f;  // dpre before t0: never read into d xin
    }
  }

  for (int t = t0; t < tend; t += kConvRun) {
    Pack<T, V> xr[kConvRun], gc[kConvRun];
    Pack<float, V> gk[kConvRun], gg[kConvRun];
#pragma unroll
    for (int i = 0; i < kConvRun; ++i) {
      const int tt = t + i;
      if (tt >= tend || tt >= seqlen) break;
      const size_t off = ob + static_cast<size_t>(tt) * d_inner;
      xr[i] = load<T, V>(xb + tt * stride_s);
      gc[i] = load<T, V>(g_conv + off);
      gk[i] = load<float, V>(g_xf + off);
      gg[i] = load<float, V>(g_gate + off);
    }
#pragma unroll
    for (int i = 0; i < kConvRun; ++i) {
      const int tt = t + i;
      if (tt >= tend) break;
      Pack<T, V> o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float dp = 0.0f;  // dpre past the sequence's end
        if (tt < seqlen) {
          const float cur = widen(xr[i].v[v]);
          float acc = acc0[v];
#pragma unroll
          for (int k = 0; k < kWidth - 1; ++k) acc = fmaf(wk[k][v], win[k][v], acc);
          acc = fmaf(wk[kWidth - 1][v], cur, acc);
          const float gxf = round_c<T>(__fadd_rn(gk[i].v[v], gg[i].v[v]));
          const float gt = round_c<T>(__fadd_rn(gxf, widen(gc[i].v[v])));
          dp = round_c<T>(silu_grad(gt, round_c<T>(acc)));
          if (tt < t1) {
#pragma unroll
            for (int k = 0; k < kWidth - 1; ++k) dw[k][v] = fmaf(dp, win[k][v], dw[k][v]);
            dw[kWidth - 1][v] = fmaf(dp, cur, dw[kWidth - 1][v]);
            db[v] += dp;
          }
#pragma unroll
          for (int k = 0; k < kWidth - 2; ++k) win[k][v] = win[k + 1][v];
          win[kWidth - 2][v] = cur;
        }
        // d xin at tt - (K - 1): its K taps' dpre are dwin and dp
        float s = wk[0][v] * dp;
#pragma unroll
        for (int k = 1; k < kWidth; ++k) s = fmaf(wk[k][v], dwin[kWidth - 1 - k][v], s);
        o.v[v] = narrow<T>(s);
#pragma unroll
        for (int k = 0; k < kWidth - 2; ++k) dwin[k][v] = dwin[k + 1][v];
        dwin[kWidth - 2][v] = dp;
      }
      if (tt - (kWidth - 1) >= t0) {
        store<T, V>(dx + ob + static_cast<size_t>(tt - (kWidth - 1)) * d_inner, o);
      }
    }
  }
  // this block's partial row: dw (K rows of d_inner), then db
  float* pr = part + (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) *
                         (kWidth + 1) * d_inner + c;
#pragma unroll
  for (int k = 0; k <= kWidth; ++k) {
    Pack<float, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) o.v[v] = k < kWidth ? dw[k][v] : db[v];
    store<float, V>(pr + static_cast<size_t>(k) * d_inner, o);
  }
}

// out[col] = the rows of part (rows, cols) summed in order, rounded to R,
// stored as To
template <typename R, typename To>
__global__ void __launch_bounds__(kThreads)
    mixer_channel_sum_kernel(const float* __restrict__ part, To* __restrict__ out, int rows,
                             int cols) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, part[static_cast<size_t>(r) * cols + col]);
  out[col] = narrow<To>(round_c<R>(acc));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the vector instantiation of v channels a thread takes these:
// d_inner and every row stride whole groups of v, every base 16-byte
// aligned.
bool vec_ok(int v, int d_inner, std::initializer_list<long long> strides,
            std::initializer_list<const void*> bases) {
  if (d_inner % v != 0) return false;
  for (long long s : strides) {
    if (s % v != 0) return false;
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
  const bool vec = vec_ok(kV, d_inner, {stride_b, stride_s}, {x, w, bias, out, out_f32});
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
  const bool vec = vec_ok(kV, d_inner, {}, {dt_raw, bias, dt});
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
  const bool vec = vec_ok(kV, d_inner, {z_stride_b, z_stride_s}, {y, xc, D, z, out});
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

template <typename R, typename To>
cudaError_t channel_sum(const float* part, To* out, int rows, int cols, cudaStream_t stream) {
  mixer_channel_sum_kernel<R, To>
      <<<(cols + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, out, rows, cols);
  return cudaGetLastError();
}

int chunks(int n, int chunk) { return (n + chunk - 1) / chunk; }

template <typename T>
cudaError_t gate_bwd(const void* g, const float* y, const void* xc, const float* D,
                     const void* z, float* dy, float* dxf, void* dz, float* dD, float* part,
                     int batch, int seqlen, int d_inner, long long z_stride_b,
                     long long z_stride_s, int chunk, cudaStream_t stream) {
  const bool vec =
      vec_ok(kVb, d_inner, {z_stride_b, z_stride_s}, {g, y, xc, D, z, dy, dxf, dz, part});
  const int rows = batch * seqlen;
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(xc);
  const T* zt = static_cast<const T*>(z);
  T* dzt = static_cast<T*>(dz);
  const dim3 grid = row_grid(chunks(rows, chunk), d_inner, vec ? kVb : 1);
  if (vec) {
    mixer_gate_bwd_kernel<T, kVb><<<grid, kThreads, 0, stream>>>(
        gt, y, xt, D, zt, dy, dxf, dzt, part, rows, chunk, seqlen, d_inner, z_stride_b,
        z_stride_s);
  } else {
    mixer_gate_bwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        gt, y, xt, D, zt, dy, dxf, dzt, part, rows, chunk, seqlen, d_inner, z_stride_b,
        z_stride_s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return channel_sum<float, float>(part, dD, chunks(rows, chunk), d_inner, stream);
}

template <typename T>
cudaError_t dt_softplus_bwd(const float* ddt, const void* dt_raw, const float* bias,
                            void* ddt_raw, float* dbias, float* part, int rows, int d_inner,
                            int chunk, cudaStream_t stream) {
  const bool vec = vec_ok(kVb, d_inner, {}, {ddt, dt_raw, bias, ddt_raw, part});
  const T* raw = static_cast<const T*>(dt_raw);
  T* draw = static_cast<T*>(ddt_raw);
  const dim3 grid = row_grid(chunks(rows, chunk), d_inner, vec ? kVb : 1);
  if (vec) {
    mixer_dt_softplus_bwd_kernel<T, kVb>
        <<<grid, kThreads, 0, stream>>>(ddt, raw, bias, draw, part, rows, chunk, d_inner);
  } else {
    mixer_dt_softplus_bwd_kernel<T, 1>
        <<<grid, kThreads, 0, stream>>>(ddt, raw, bias, draw, part, rows, chunk, d_inner);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return channel_sum<T, float>(part, dbias, chunks(rows, chunk), d_inner, stream);
}

template <typename T>
cudaError_t conv_bwd(const void* x, const void* w, const void* bias, const void* g_conv,
                     const float* g_xf, const float* g_gate, void* dx, void* dwb, float* part,
                     int batch, int seqlen, int d_inner, long long stride_b, long long stride_s,
                     int chunk, cudaStream_t stream) {
  const bool vec = vec_ok(kVb, d_inner, {stride_b, stride_s},
                          {x, w, bias, g_conv, g_xf, g_gate, dx, part});
  const int v = vec ? kVb : 1;
  const dim3 grid(chunks(seqlen, chunk), (d_inner + kThreads * v - 1) / (kThreads * v), batch);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g_conv);
  T* dxt = static_cast<T*>(dx);
  if (vec) {
    mixer_conv_silu_bwd_kernel<T, kVb><<<grid, kThreads, 0, stream>>>(
        xt, wt, bt, gt, g_xf, g_gate, dxt, part, chunk, seqlen, d_inner, stride_b, stride_s);
  } else {
    mixer_conv_silu_bwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        xt, wt, bt, gt, g_xf, g_gate, dxt, part, chunk, seqlen, d_inner, stride_b, stride_s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return channel_sum<T, T>(part, static_cast<T*>(dwb), batch * chunks(seqlen, chunk),
                           (kWidth + 1) * d_inner, stream);
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

// The backward passes.  `chunk` is the rows (positions, for the conv) a
// block walks; `part` is a float32 workspace of the partial channel sums,
// one row a block: (ceil(B S / chunk), d_inner) for the gate and the dt
// softplus, (B ceil(S / chunk), width + 1, d_inner) for the conv.  Each
// launches its pass and then the in-order sum of the partial rows.

// g (B, S, d_inner) contiguous in the compute dtype: the gradient of
// mixer_gate's output; y, x_conv, D and z as mixer_gate takes them.  Writes
// dy and dxf (B, S, d_inner) float32, dz (B, S, d_inner) contiguous in the
// compute dtype and dD (d_inner,) float32.
extern "C" int mixer_gate_bwd(const void* g, const float* y, const void* x_conv, const float* D,
                              const void* z, float* dy, float* dxf, void* dz, float* dD,
                              float* part, int batch, int seqlen, int d_inner,
                              long long z_stride_b, long long z_stride_s, int chunk, int dtype,
                              void* stream) {
  if (chunk <= 0 || bad_shape(batch, seqlen, d_inner, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBfloat16
          ? gate_bwd<__nv_bfloat16>(g, y, x_conv, D, z, dy, dxf, dz, dD, part, batch, seqlen,
                                    d_inner, z_stride_b, z_stride_s, chunk, s)
          : gate_bwd<float>(g, y, x_conv, D, z, dy, dxf, dz, dD, part, batch, seqlen, d_inner,
                            z_stride_b, z_stride_s, chunk, s));
}

// ddt (rows, d_inner) float32: the gradient of mixer_dt_softplus's dt;
// dt_raw and bias as it takes them.  Writes ddt_raw (rows, d_inner) in the
// compute dtype and dbias (d_inner,) float32, rounded to the compute dtype.
extern "C" int mixer_dt_softplus_bwd(const float* ddt, const void* dt_raw, const float* bias,
                                     void* ddt_raw, float* dbias, float* part, int rows,
                                     int d_inner, int chunk, int dtype, void* stream) {
  if (chunk <= 0 || bad_shape(1, rows, d_inner, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBfloat16
          ? dt_softplus_bwd<__nv_bfloat16>(ddt, dt_raw, bias, ddt_raw, dbias, part, rows,
                                           d_inner, chunk, s)
          : dt_softplus_bwd<float>(ddt, dt_raw, bias, ddt_raw, dbias, part, rows, d_inner,
                                   chunk, s));
}

// xin, w and bias as mixer_conv_silu takes them; g_conv (B, S, d_inner)
// contiguous in the compute dtype: the gradient of x_conv; g_xf and g_gate
// (B, S, d_inner) contiguous float32: xf's gradient from K2 and from the
// gate.  Writes dxin (B, S, d_inner) contiguous and dwb (width + 1,
// d_inner) in the compute dtype: the taps' gradient, then the bias's.
extern "C" int mixer_conv_silu_bwd(const void* xin, const void* w, const void* bias,
                                   const void* g_conv, const float* g_xf, const float* g_gate,
                                   void* dxin, void* dwb, float* part, int batch, int seqlen,
                                   int d_inner, int width, long long stride_b,
                                   long long stride_s, int chunk, int dtype, void* stream) {
  if (width != kWidth || chunk <= 0 || bad_shape(batch, seqlen, d_inner, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBfloat16
          ? conv_bwd<__nv_bfloat16>(xin, w, bias, g_conv, g_xf, g_gate, dxin, dwb, part, batch,
                                    seqlen, d_inner, stride_b, stride_s, chunk, s)
          : conv_bwd<float>(xin, w, bias, g_conv, g_xf, g_gate, dxin, dwb, part, batch, seqlen,
                            d_inner, stride_b, stride_s, chunk, s));
}
