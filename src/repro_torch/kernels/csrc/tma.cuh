// TMA, mbarrier and tensor-map helpers for Hopper (sm_90a), shared by the
// warp-specialised kernels (flash_prefill.cu, paged_decode.cu):
//   * mbarriers in shared memory: init, arrive (with an expected byte
//     count), wait on a phase's parity;
//   * one TMA box of a 4-d tensor map into shared memory, completing on an
//     mbarrier (cp.async.bulk.tensor);
//   * the wgmma shared-memory descriptor of a 128-byte-swizzled operand;
//   * cuTensorMapEncodeTiled from the driver the runtime has loaded
//     (cudaGetDriverEntryPoint: no libcuda link), and the 4-d bf16 map of a
//     (B, S, heads, hd) tensor that both kernels read: q/k/v of flash,
//     contiguous cache rows (B, C, K, hd) or pages (P, page, K, hd) of
//     decode.
#pragma once
#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

// C interface errors of the tensor-map setup (CUDA's own codes are < 1000)
constexpr int ERR_NO_ENCODE = 1001;     // no cuTensorMapEncodeTiled in the driver
constexpr int ERR_ENCODE = 1002;        // the driver refused a tensor map

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the barriers' init visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3) : "memory");
}
// order this thread's shared-memory stores before later reads of the same
// bytes by the async proxy (a wgmma operand written by threads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// wgmma shared-memory descriptor of a 128-byte-swizzled operand (rows of
// 64 bf16, 8-row atoms of 1024 bytes, 1024-aligned): start address, leading
// byte offset (MN-major: the next 64-wide block; unused K-major), stride
// byte offset 1024 (the next 8 rows), in 16-byte units; layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16)
       | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// tile of 128-byte rows (what TMA writes under CU_TENSOR_MAP_SWIZZLE_128B)
__host__ __device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so that
// the library needs no link against libcuda
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (B, S, heads, hd) bf16 tensor as a 4-d tensor map, boxes of 64 hd
// columns (zero-filled past hd) by one head by `rows` positions (zero-filled
// past S), 128-byte swizzle
inline int tensor_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B,
                      int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
  if (enc == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

}  // namespace tma
