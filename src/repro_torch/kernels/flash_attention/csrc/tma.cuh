// TMA loads, mbarriers and 128B-swizzled shared-memory tiles for the bf16
// flash-attention kernels (flash_attention_bf16.cu, flash_attention_bwd_bf16.cu;
// sm_90a only).
//
// A tile of R rows x DHP bf16 columns lives in shared memory as DHP / 64
// panels of R rows x 64 columns (128 bytes a row), each panel 1024-byte
// aligned and written by TMA with the 128-byte swizzle, so wgmma reads it
// through a 128B-swizzle descriptor (sw128_desc).  The tensor maps are 4-d
// (dh, seq, heads, batch) over the caller's element strides, so the model's
// (B, S, H, dh) layout is read without a transpose; columns past dh and rows
// past seq are zero-filled.  TMA needs a 16-byte-aligned base and strides.

#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <cstdint>

namespace tma {

constexpr int kPanel = 64;     // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of (64 columns, rows, 1, 1) at (col, row, head, batch) into shared
// memory at `dst`, completing on `bar`
__device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                     int head, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

// all DHP / 64 panels of a tile of `rows` rows starting at `row`
template <int DHP>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int rows, int row,
                                          int head, int batch, uint32_t bar) {
#pragma unroll
  for (int pn = 0; pn < DHP / kPanel; ++pn)
    load(dst + pn * rows * kRowBytes, map, pn * kPanel, row, head, batch, bar);
}

// wgmma shared-memory descriptor for a 128B-swizzled operand: start
// address, leading byte offset (K-major: unused, 16; MN-major: the stride
// between 64-column panels), stride byte offset 1024 (eight 128-byte rows)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// keep the compiler from moving accumulator registers across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Makes the device that holds `ptr` current in the calling thread, with
// its primary context.  Encoding a tensor map is a driver call and needs a
// current context, which a thread that has made no CUDA call yet lacks:
// autograd's backward thread, when the attention gradient is the first
// kernel it runs, or a new serving thread.
inline cudaError_t use_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  return err != cudaSuccess ? err : cudaSetDevice(attr.device);
}

inline PFN_cuTensorMapEncodeTiled encode_fn() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a 4-d map (dh, seq, heads, batch) of a bf16 tensor with element strides
// (1, ss, sh, sb), read in 128B-swizzled boxes of 64 columns x `rows`
inline bool make_map(CUtensorMap* map, const void* ptr, int dh, int seq, int heads, int batch,
                     long long ss, long long sh, long long sb, int rows) {
  const PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
