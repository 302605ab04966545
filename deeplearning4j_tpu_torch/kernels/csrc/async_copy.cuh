// Shared pieces of the kernels that pipeline their loads
// (dequant_matmul.cu, paged_flash_decode.cu, flash_attention_bwd.cu):
// 16-byte (and 4-byte) cp.async copies from device memory into shared
// memory, with zero-fill, and their group fences.
//
// A copy of fewer than 16 source bytes fills the rest of the 16-byte
// destination with zeros, so a ragged edge lands in shared memory already
// masked; a copy of 0 bytes reads nothing and writes 16 zero bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (src_bytes of them from src, the rest zeros) -> dst; both
// 16-byte aligned. .cg: cached in L2 only, the data is read once.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes (src_bytes of them from src, the rest zeros) -> dst; both
// 4-byte aligned. .ca: the only cache mode for copies under 16 bytes.
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace async
