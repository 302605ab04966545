// The mma.sync pieces of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the tile geometry at
// D zero-padded to 16 * DK, 16-byte cp.async copies of row tiles and
// 4-byte ones of row vectors into shared memory, the A fragments of a
// warp's 16 stationary rows, the ldmatrix row addresses of B fragments,
// and the epilogue that rounds a warp's f32 accumulators to bf16 and
// writes them with 16-byte stores.
//
// A block's warps each own 16 stationary rows; the streamed tiles hold
// kTile rows. Row pitches of D + 8 bf16 keep ldmatrix free of bank
// conflicts. The copies need 16-byte-aligned rows.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "tensor_core.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // streamed rows a tile
// the widest D / 16 whose A fragments the backward keeps in registers
constexpr int kRegAMaxDK = 4;

// Geometry at D padded to 16 * DK (DK = 1, 2, 4 or 8)
template <int DK>
struct Geo {
  static constexpr int kD = 16 * DK;
  static constexpr int kLd = kD + 8;      // bf16 pitch: conflict-free rows
  static constexpr int kChunks = kD / 8;  // 16-byte chunks a row
  static constexpr bool kRegA = DK <= kRegAMaxDK;  // A frags in registers
  static constexpr int kTileElems = kTile * kLd;
};

// Rows [row0, row0 + ROWS) of one (b, h) slice ``src`` into dst
// [ROWS][kLd] by 16-byte cp.async, by a block of THREADS; rows past S and
// columns past D land as zeros. A thread keeps one column chunk and walks
// its rows by one pointer, so a copy called in a loop keeps few registers
// live.
template <int DK, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int S, int D) {
  constexpr int C = Geo<DK>::kChunks, LD = Geo<DK>::kLd;
  constexpr int kStep = THREADS / C;  // rows a pass of the block
  static_assert(kStep * C == THREADS, "a pass must cover whole rows");
  const int r = threadIdx.x / C, c = (threadIdx.x % C) * 8;
  const bf16* from = src + (long long)(row0 + r) * row_stride + c;
  bf16* to = dst + r * LD + c;
#pragma unroll
  for (int i = 0; i < (ROWS + kStep - 1) / kStep; ++i) {
    if (ROWS % kStep == 0 || r + i * kStep < ROWS) {
      const bool in = c < D && row0 + r + i * kStep < S;
      async::copy16(to + i * kStep * LD, in ? from : src, in ? 16 : 0);
    }
    from += kStep * row_stride;
  }
}

// kTile 4-byte entries [row0, row0 + kTile) of a row vector (f32 lse or
// delta, int32 mask) into dst, by a block of THREADS; entries past S land
// as zeros.
template <int THREADS>
__device__ __forceinline__ void copy_vec(void* dst, const void* src,
                                         int row0, int S) {
  for (int i = threadIdx.x; i < kTile; i += THREADS) {
    const bool in = row0 + i < S;
    async::copy4(static_cast<char*>(dst) + 4 * i,
                 static_cast<const char*>(src) + 4 * (in ? row0 + i : 0),
                 in ? 4 : 0);
  }
}

// The A fragments (m16 x k16, one per 16 columns of D) of a warp's 16
// stationary rows: held in registers (REG) or read from shared memory at
// each use.
template <int DK, bool REG>
struct AFrags;

template <int DK>
struct AFrags<DK, true> {
  uint32_t r[DK][4];
  __device__ __forceinline__ void init(const bf16* rows) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      tc::ldsm_x4(r[kk], rows + (lane & 15) * Geo<DK>::kLd + kk * 16 +
                             (lane >> 4) * 8);
  }
  __device__ __forceinline__ const uint32_t* get(int kk, uint32_t*) const {
    return r[kk];
  }
};

template <int DK>
struct AFrags<DK, false> {
  const bf16* p;
  __device__ __forceinline__ void init(const bf16* rows) {
    const int lane = threadIdx.x & 31;
    p = rows + (lane & 15) * Geo<DK>::kLd + (lane >> 4) * 8;
  }
  __device__ __forceinline__ const uint32_t* get(int kk,
                                                 uint32_t* tmp) const {
    tc::ldsm_x4(tmp, p + kk * 16);
    return tmp;
  }
};

// Address of this lane's ldmatrix row for B fragments of 16 streamed rows
// (row0 .. row0 + 15 of a tile at pitch LD), one call per k16 step:
// non-transposed (the tile is n x k: rows are columns of B, as for S =
// A.tile^T) gives b0, b1 of n8 tile 0 and b0, b1 of n8 tile 1 over
// columns kk*16..; transposed (the tile is k x n: rows are the k of B, as
// for acc += A.tile) gives the same over D columns dk*16...
template <int LD>
__device__ __forceinline__ const bf16* b_rows(const bf16* tile, int row0) {
  const int lane = threadIdx.x & 31;
  return tile + (row0 + (lane & 7) + 8 * (lane >> 4)) * LD +
         8 * ((lane >> 3) & 1);
}
template <int LD>
__device__ __forceinline__ const bf16* bt_rows(const bf16* tile, int row0) {
  const int lane = threadIdx.x & 31;
  return tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
         8 * (lane >> 4);
}

// The warp's 16 x 16DN f32 accumulator (times mul) rounded to bf16
// through its own 16 stationary rows ``stage`` of shared memory (pitch
// LD), then written as 16-byte stores to rows row0.. of out (pitch
// row_stride), rows < S and columns < D only.
template <int LD, int DN>
__device__ __forceinline__ void store_rows(float (*acc)[4], float mul,
                                           bf16* stage, bf16* out,
                                           long long row_stride, int row0,
                                           int S, int D) {
  constexpr int C = 2 * DN;
  const int lane = threadIdx.x & 31, kq = lane & 3, g = lane >> 2;
  __syncwarp();  // the warp's last reads of its stationary rows are done
#pragma unroll
  for (int j = 0; j < 2 * DN; ++j) {
    const int c = 8 * j + 2 * kq;
    *reinterpret_cast<uint32_t*>(stage + g * LD + c) =
        tc::pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + c) =
        tc::pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = (i % C) * 8, row = row0 + r;
    if (row < S && c < D)
      *reinterpret_cast<uint4*>(out + (long long)row * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

}  // namespace flash
