// Warp-level tensor-core pieces shared by the kernels that run mma.sync
// (paged_flash_decode.cu, dequant_matmul.cu, flash_attention_bwd.cu): the
// bf16 m16n8k16 product with an f32 accumulator, ldmatrix loads of its
// fragments from shared memory, and the packing of two f32 values into
// one bf16x2 register.
//
// Fragment layout of m16n8k16 (lane = 4 g + kq):
//  - C (f32, m16 x n8): c[0], c[1] at row g, columns 2 kq, 2 kq + 1;
//    c[2], c[3] at row g + 8, the same columns.
//  - A (bf16, m16 x k16): a[0] row g, k 2 kq..; a[1] row g + 8, k 2 kq..;
//    a[2] row g, k 8 + 2 kq..; a[3] row g + 8, k 8 + 2 kq.. So the C
//    fragments of two neighbouring n8 tiles (columns 0-7 and 8-15) become
//    the A fragment of one k16 step as pack(c0[0], c0[1]), pack(c0[2],
//    c0[3]), pack(c1[0], c1[1]), pack(c1[2], c1[3]).
//  - B (bf16, k16 x n8, "col"): b0 at k 2 kq.. of column g, b1 at k
//    8 + 2 kq.. of column g.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace tc {

// c += a . b: bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i receives it
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(async::smem_addr(p)));
}

// the same, each matrix transposed on its way into the registers
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(async::smem_addr(p)));
}

// (lo, hi) rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

}  // namespace tc
