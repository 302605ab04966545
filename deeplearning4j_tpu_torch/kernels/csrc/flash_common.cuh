// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the tile geometry, the shared-memory layouts
// per element type, tile loads from a strided [B, S, H, D] tensor, and
// the two warp-level products every kernel is built from.
//
// Geometry: a block of 4 warps owns a 64-row tile of one (batch, head);
// warp w owns rows 16w..16w+15 of it and does all of its own arithmetic,
// so a block synchronises only around the loads of the streamed tiles.
// In the element-wise passes lane l of a warp takes row l/2 of the warp's
// 16 and the 32 columns (l%2)*32.. of the 64-wide score tile.
//
// Element types:
//  - bf16: products run on the tensor cores through wmma 16x16x16 with f32
//    accumulators (mma.sync underneath); D is zero-padded to a multiple of
//    16 in shared memory. Row pitches keep every wmma pointer 32-byte
//    aligned.
//  - f32: products run on the FMA units, so f32 is never rounded to TF32.
//    Odd row pitches keep the column reads of B free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

using namespace nvcuda;

constexpr int kRows = 64;      // rows of every tile (queries or keys)
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;  // the Pallas kernels' finite mask value
// an lse at or below this belongs to a row whose every key is masked
constexpr float kFullyMasked = 0.5f * kNegInf;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Pitches (in elements) of the shared-memory tiles for element type T:
// kd = the contraction width walked over D; ld_t = a [64, D] input tile;
// ld_f = an f32 [64, D] accumulator; ld_s = the f32 [64, 64] score tile;
// ld_p = the [64, 64] probability tile in T, which lives in the score
// tile's own bytes.
template <typename T>
struct Tr;

template <>
struct Tr<__nv_bfloat16> {
  __host__ __device__ static int kd(int D) { return (D + 15) / 16 * 16; }
  __host__ __device__ static int ld_t(int D) { return kd(D) + 8; }
  __host__ __device__ static int ld_f(int D) { return kd(D) + 4; }
  static constexpr int ld_s = 68;
  static constexpr int ld_p = 72;
};

template <>
struct Tr<float> {
  __host__ __device__ static int kd(int D) { return D; }
  __host__ __device__ static int ld_t(int D) { return D + 1; }
  __host__ __device__ static int ld_f(int D) { return D + 1; }
  static constexpr int ld_s = 65;
  static constexpr int ld_p = 65;
};

__host__ __device__ inline size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}
template <typename T>
__host__ __device__ inline size_t tile_bytes(int D) {
  return round128(sizeof(T) * kRows * Tr<T>::ld_t(D));
}
template <typename T>
__host__ __device__ inline size_t acc_bytes(int D) {
  return round128(sizeof(float) * kRows * Tr<T>::ld_f(D));
}
template <typename T>
__host__ __device__ inline size_t score_bytes() {
  return round128(sizeof(float) * kRows * Tr<T>::ld_s);
}

struct Strides {
  long long b, s, h;  // element strides of the B, S and H axes (D is 1)
};

// Rows [row0, row0 + 64) of one (batch, head) slice ``src`` (already
// offset to it) into ``dst`` [64, ld], columns [0, kd). Rows at or past S
// and columns at or past D are zero-filled, so the ragged edges add
// nothing to any product.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int S, int D, int kd) {
  for (int i = threadIdx.x; i < kRows * kd; i += kThreads) {
    const int r = i / kd, d = i - r * kd;
    const int row = row0 + r;
    dst[r * ld + d] = (row < S && d < D)
                          ? src[(long long)row * row_stride + d]
                          : from_f32<T>(0.f);
  }
}

// C[16, 64] (f32, pitch ldc) = A[16, kd] . B[64, kd]^T: the warp's score
// rows against a 64-row tile.
template <typename T>
__device__ void warp_abT(const T* A, int lda, const T* B, int ldb, float* C,
                         int ldc, int kd);

template <>
__device__ void warp_abT<__nv_bfloat16>(const __nv_bfloat16* A, int lda,
                                        const __nv_bfloat16* B, int ldb,
                                        float* C, int ldc, int kd) {
#pragma unroll
  for (int n = 0; n < kRows / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
    for (int k0 = 0; k0 < kd; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      // B^T as a column-major [kd, 16] slice of the row-major tile
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b;
      wmma::load_matrix_sync(a, A + k0, lda);
      wmma::load_matrix_sync(b, B + n * 16 * ldb + k0, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + n * 16, c, ldc, wmma::mem_row_major);
  }
}

template <>
__device__ void warp_abT<float>(const float* A, int lda, const float* B,
                                int ldb, float* C, int ldc, int kd) {
  const int lane = threadIdx.x % 32;
  float c0[16], c1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) c0[r] = c1[r] = 0.f;
  for (int d = 0; d < kd; ++d) {
    const float b0 = B[lane * ldb + d], b1 = B[(lane + 32) * ldb + d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = A[r * lda + d];
      c0[r] = fmaf(a, b0, c0[r]);
      c1[r] = fmaf(a, b1, c1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    C[r * ldc + lane] = c0[r];
    C[r * ldc + lane + 32] = c1[r];
  }
}

// C[16, kd] (f32, pitch ldc) += P[16, 64] . V[64, kd]: the warp's rows of
// a probability-like tile against a 64-row value-like tile.
template <typename T>
__device__ void warp_pv(const T* P, int ldp, const T* V, int ldv, float* C,
                        int ldc, int kd);

template <>
__device__ void warp_pv<__nv_bfloat16>(const __nv_bfloat16* P, int ldp,
                                       const __nv_bfloat16* V, int ldv,
                                       float* C, int ldc, int kd) {
  for (int n0 = 0; n0 < kd; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, C + n0, ldc, wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < kRows; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b;
      wmma::load_matrix_sync(a, P + k0, ldp);
      wmma::load_matrix_sync(b, V + k0 * ldv + n0, ldv);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
  }
}

template <>
__device__ void warp_pv<float>(const float* P, int ldp, const float* V,
                               int ldv, float* C, int ldc, int kd) {
  const int lane = threadIdx.x % 32;
  float c[4][16];  // columns lane + 32 j, j < kd / 32 (kd <= 128)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 16; ++r)
      c[j][r] = (lane + 32 * j < kd) ? C[r * ldc + lane + 32 * j] : 0.f;
  for (int k = 0; k < kRows; ++k) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (lane + 32 * j < kd) ? V[k * ldv + lane + 32 * j] : 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p = P[r * ldp + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j][r] = fmaf(p, v[j], c[j][r]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (lane + 32 * j < kd)
#pragma unroll
      for (int r = 0; r < 16; ++r) C[r * ldc + lane + 32 * j] = c[j][r];
}

// Whether key kj is hidden from query qi: a zero in the batch row of the
// key mask, or a key after the query under causal masking.
__device__ __forceinline__ bool hidden(const int* mask_b, int causal,
                                       int qi, int kj) {
  return (mask_b != nullptr && mask_b[kj] == 0) || (causal && kj > qi);
}

// Raise the kernel's dynamic shared-memory limit once it is needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
