// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the finite mask value, the tensor strides and
// the key-visibility test of every kernel, and the shared-memory tiles,
// tile loads and FMA products of the f32 kernels. The bf16 kernels'
// mma.sync pieces are in flash_mma.cuh.
//
// f32 geometry: a block of 4 warps owns a 64-row tile of one (batch,
// head); warp w owns rows 16w..16w+15 of it and does all of its own
// arithmetic, so a block synchronises only around the loads of the
// streamed tiles. In the element-wise passes lane l of a warp takes row
// l/2 of the warp's 16 and the 32 columns (l%2)*32.. of the 64-wide score
// tile. The products run on the FMA units, so f32 is never rounded to
// TF32; odd row pitches keep the column reads of B free of bank
// conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kRows = 64;      // rows of every f32 tile (queries or keys)
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;  // the Pallas kernels' finite mask value
// an lse at or below this belongs to a row whose every key is masked
constexpr float kFullyMasked = 0.5f * kNegInf;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Pitches (in floats) of the f32 shared-memory tiles: a [64, D] input
// tile or accumulator, and the [64, 64] score or probability tile.
__host__ __device__ inline int ld_f32(int D) { return D + 1; }
constexpr int kLdScore = 65;

__host__ __device__ inline size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}
// bytes of one [64, D] f32 tile (an input tile or an accumulator)
__host__ __device__ inline size_t tile_bytes(int D) {
  return round128(sizeof(float) * kRows * ld_f32(D));
}
__host__ __device__ inline size_t score_bytes() {
  return round128(sizeof(float) * kRows * kLdScore);
}

struct Strides {
  long long b, s, h;  // element strides of the B, S and H axes (D is 1)
};

// Rows [row0, row0 + 64) of one (batch, head) slice ``src`` (already
// offset to it) into ``dst`` [64, ld], columns [0, D). Rows at or past S
// land as zeros, so the ragged edge adds nothing to any product.
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src,
                                          long long row_stride, int row0,
                                          int S, int D) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < S ? src[(long long)row * row_stride + d] : 0.f;
  }
}

// C[16, 64] (f32, pitch ldc) = A[16, D] . B[64, D]^T: the warp's score
// rows against a 64-row tile.
__device__ inline void warp_abT(const float* A, int lda, const float* B,
                                int ldb, float* C, int ldc, int D) {
  const int lane = threadIdx.x % 32;
  float c0[16], c1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) c0[r] = c1[r] = 0.f;
  for (int d = 0; d < D; ++d) {
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

// C[16, D] (f32, pitch ldc) += P[16, 64] . V[64, D]: the warp's rows of
// a probability-like tile against a 64-row value-like tile (D <= 128).
__device__ inline void warp_pv(const float* P, int ldp, const float* V,
                               int ldv, float* C, int ldc, int D) {
  const int lane = threadIdx.x % 32;
  float c[4][16];  // columns lane + 32 j, j < D / 32
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 16; ++r)
      c[j][r] = (lane + 32 * j < D) ? C[r * ldc + lane + 32 * j] : 0.f;
  for (int k = 0; k < kRows; ++k) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (lane + 32 * j < D) ? V[k * ldv + lane + 32 * j] : 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p = P[r * ldp + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j][r] = fmaf(p, v[j], c[j][r]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (lane + 32 * j < D)
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
