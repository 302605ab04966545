// Fused int8 dequant-matmul for Hopper (sm_90a): out = (x @ q) * scale,
// a W8A16 GEMM with the weight kept int8 in device memory.
//
// Replaces: deeplearning4j_tpu/quant/transforms.py _fused_dequant_matmul
//   (Pallas body _fused_mm_kernel). As there, the int8 weight is widened
//   to the activation dtype on its way into the product, the sum is kept
//   in f32, and the per-output-channel scale multiplies the f32 sum once,
//   after the last K slice. A full-precision copy of the weight never
//   exists: the weight crosses device and shared memory at 1 byte an
//   element and is widened in registers, on its way into the fragments.
//
// What bounds it on the H100 (the int8 twin's MLP, K x N = 768 x 3072 and
// 3072 x 768, 2.36 MB of int8 weight each):
//  - decode (M = 8) and spec verify (M = 40): the weight bytes. 2.36 MB at
//    3.35 TB/s is 0.70 us; 2*M*K*N = 38 MFLOP at M = 8 is ~16 flops a
//    weight byte, far under the ~295 the tensor cores need. A few us of
//    launch and memory latency dominate; the designs keep every SM's
//    bytes in flight at once and avoid a second launch where they can.
//  - prefill (M up to 4 x 1024): the tensor-core rate. 2*4096*768*3072 =
//    19.3 GFLOP is 19.5 us at 989 TFLOP/s; the bytes (6.3 + 2.4 + 25 MB)
//    take 10 us.
//
// Designs, bf16 activations, picked by M from a sweep of all of them over
// M on the card (the readings are in PERF.md):
//  - whole K (M <= kWholeKMaxM = 48, where N / 32 fills two thirds of the
//    SMs: the 768 -> 3072 product): a block per 32 columns streams its
//    column slab of the weight, all of K, through a 3-deep cp.async ring
//    of 256 x 32 int8 tiles (at K = 768 the whole slab is in flight at
//    once); its 8 warps take an eighth of each tile's K rows each and meet
//    in shared memory. One launch, no partial sums in device memory. (8
//    warps a block read faster than 2, 4, 12 or 16: fewer warps lengthen
//    each warp's chain of products, more add to the sum in shared memory.)
//  - split K (M <= kSplitKMaxM = 16 otherwise: the 3072 -> 768 product):
//    a block owns 128 columns and a K slice sized so the grid holds two
//    blocks an SM (288 blocks: 6 x 48), stages its x slice once and
//    streams 32 x 128 int8 tiles through a 4-stage cp.async ring; each
//    warp owns 32 columns. The f32 partials go to a workspace the wrapper
//    allocates, and a second pass sums them in slice order, applies
//    scale[n] and rounds once. (Summing in the last-arriving block, or in
//    a thread-block cluster through distributed shared memory, measured
//    slower: one block then reads every slice's tile.)
//  - tiles (larger M): a 128 x 128 output tile per block of 4 warps, each
//    64 x 64 (4 x 8 mma tiles, 128 f32 accumulators in registers), two
//    blocks an SM, a 4-stage cp.async ring of 128 x 32 bf16 x tiles
//    (ldmatrix.x4 into A fragments) and 32 x 128 int8 weight tiles whose
//    copy sources are set up once per thread. K is split (with the second
//    pass) only when the tiles cannot fill the SMs once. The epilogue
//    scales in registers and stores 16 bytes a thread and row: no f32 tile
//    goes through shared memory.
//  In every design the small-M products pad M to 16 in registers only
//  (rows >= M are zero fragments, never loaded), mma.sync m16n8k16 takes
//  bf16 in and sums in f32, and no float atomic touches the output: two
//  calls give identical bits.
//  - int8 -> bf16: a 32-bit shared-memory word holds 4 neighbouring
//    columns of one K row. Warp column j of n8-tile t is weight column
//    4j + t, so one word feeds the same lane of 4 tiles and a lane's
//    accumulators land on 8 neighbouring columns. Each bf16 pair is made
//    exactly (|q| <= 127) with one byte_perm, two masks and one packed
//    bf16 subtraction (i8pair_to_bf16x2): no conversion unit.
//  - ragged M, N, K: copies past an edge read 0 bytes and zero-fill, and
//    stores are masked. Rows of x or of the weight that are not 16-byte
//    aligned (K % 8 or N % 16 not 0) take plain loads into the same
//    shared-memory layout. Nothing is padded in device memory.
//
// f32 activations: an FMA tile (16x64 or 64x64, each thread a TM x 4
// patch), never TF32: a tensor-core product would round f32 x to tf32.
// It runs a layer-API twin's f32 loss head (2048 -> 64 at M = 128), where
// the tiles alone make 2 blocks: when they cannot fill the SMs, K is
// split over blockIdx.z as well and a second pass adds the f32 partials
// in split order (the same bits every call). Not otherwise tuned.
//
// Left on the table: wgmma with TMA and a warp-specialised producer (the
// tiled design runs mma.sync, at a quarter of the bf16 peak or less at
// M = 4096), a persistent tile scheduler for the wave tail of 3072 -> 768,
// and for small M the launch latency itself (a CUDA graph of the step).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "tensor_core.cuh"

namespace {

using tc::ldsm_x4;
using tc::mma_bf16;
using tc::pack_bf16;

constexpr int kSplitKMaxM = 16;  // crossovers to the tiles (design sweep)
constexpr int kWholeKMaxM = 48;
constexpr int kBN = 128;        // output columns per block, both designs
constexpr int kKT = 32;         // K rows per pipelined tile
constexpr int kStages = 4;      // cp.async ring depth
constexpr int kWLd = kBN + 16;  // bytes per shared weight row (bank pad)
constexpr int kXLd = kKT + 8;   // large design: bf16 per shared x row
constexpr int kMaxKC = 1024;    // small design: longest K slice a block holds

// -- warp-level pieces ------------------------------------------------------

// Byte t of lo and byte t of hi (int8) as one bf16x2, exactly: for a
// byte b, 0x4300 | (b & 0x7f) is the bf16 128 + (b & 0x7f) and
// 0x4300 | (b & 0x80) is 128 (b >= 0) or 256 (b < 0); their difference is
// b, an integer every bf16 holds. One byte_perm, two masks, one packed
// bf16 subtraction: no conversion unit.
template <int t>
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t lo,
                                                     uint32_t hi) {
  constexpr uint32_t sel = (4 + t) << 12 | (4 + t) << 8 | t << 4 | t;
  const uint32_t x = __byte_perm(lo, hi, sel);
  const uint32_t big = (x & 0x007f007fu) | 0x43004300u;
  const uint32_t base = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&big),
              *reinterpret_cast<const __nv_bfloat162*>(&base));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// B fragments of the 4 n8-tiles of a warp's 32 columns for one k16 step:
// rows kk + 2kq (+1, +8, +9) of the int8 tile, the lane's word 4g..4g+3
template <int LD = kWLd>
__device__ __forceinline__ void load_b(const int8_t* wt, int kk, int col0,
                                       uint32_t b0[4], uint32_t b1[4]) {
  const int lane = threadIdx.x & 31, kq = lane & 3, g = lane >> 2;
  const int8_t* p = wt + (kk + 2 * kq) * LD + col0 + 4 * g;
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + LD);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 9 * LD);
  b0[0] = i8pair_to_bf16x2<0>(w0, w1);
  b0[1] = i8pair_to_bf16x2<1>(w0, w1);
  b0[2] = i8pair_to_bf16x2<2>(w0, w1);
  b0[3] = i8pair_to_bf16x2<3>(w0, w1);
  b1[0] = i8pair_to_bf16x2<0>(w2, w3);
  b1[1] = i8pair_to_bf16x2<1>(w2, w3);
  b1[2] = i8pair_to_bf16x2<2>(w2, w3);
  b1[3] = i8pair_to_bf16x2<3>(w2, w3);
}

// Store one row's 8 neighbouring columns col..col+7 of a lane: with the
// scale, rounded to bf16, into out (final), or as f32 into the split's
// partial sums.
template <bool kAligned>
__device__ __forceinline__ void store8(const float v[8], int row, int col,
                                       int N, const float* __restrict__ scale,
                                       __nv_bfloat16* __restrict__ out,
                                       float* __restrict__ part) {
  if (part != nullptr) {
    float* p = part + (long long)row * N + col;
    if (kAligned && col + 8 <= N) {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (col + i < N) p[i] = v[i];
    }
    return;
  }
  __nv_bfloat16* o = out + (long long)row * N + col;
  if (kAligned && col + 8 <= N) {
    const float4 s0 = reinterpret_cast<const float4*>(scale + col)[0];
    const float4 s1 = reinterpret_cast<const float4*>(scale + col)[1];
    uint4 r;
    r.x = pack_bf16(v[0] * s0.x, v[1] * s0.y);
    r.y = pack_bf16(v[2] * s0.z, v[3] * s0.w);
    r.z = pack_bf16(v[4] * s1.x, v[5] * s1.y);
    r.w = pack_bf16(v[6] * s1.z, v[7] * s1.w);
    *reinterpret_cast<uint4*>(o) = r;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < N) o[i] = __float2bfloat16(v[i] * scale[col + i]);
  }
}

// The epilogue of a warp's MT x 4 accumulator tiles: rows row0 + 16 mt +
// g (+8), columns col0 + 8 kq .. +7.
template <int MT, bool kAligned>
__device__ __forceinline__ void epilogue(const float (&acc)[MT][4][4],
                                         int row0, int col0, int M, int N,
                                         const float* __restrict__ scale,
                                         __nv_bfloat16* __restrict__ out,
                                         float* __restrict__ part) {
  const int lane = threadIdx.x & 31, kq = lane & 3, g = lane >> 2;
  const int col = col0 + 8 * kq;
  if (col >= N) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 16 * mt + g + 8 * half;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = acc[mt][t][2 * half];
        v[4 + t] = acc[mt][t][2 * half + 1];
      }
      store8<kAligned>(v, row, col, N, scale, out, part);
    }
}

// One 32 x 128 int8 weight tile, rows k0.. of [K, N] (rows >= k_end and
// columns >= N zero) -> shared wt[32][kWLd]; 128 or 256 threads.
template <bool kAligned, int kThreads>
__device__ __forceinline__ void load_w_tile(int8_t* wt,
                                            const int8_t* __restrict__ w,
                                            int k0, int k_end, int n0, int N) {
  if (kAligned) {
    for (int i = threadIdx.x; i < kKT * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < k_end && gn < N;
      async::copy16(wt + r * kWLd + c, in ? w + (long long)gk * N + gn : w,
                    in ? min(16, N - gn) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kKT * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      wt[r * kWLd + c] =
          (gk < k_end && gn < N) ? w[(long long)gk * N + gn] : int8_t(0);
    }
  }
}

// -- small M: split K, x slice staged once ---------------------------------

// grid (column tiles, K slices, 16*MT-row blocks); 4 warps; dynamic shared
// memory: the weight ring, then the x slice [16*MT][KC + 8] bf16. With
// K slices, each writes its f32 partial tile for the split-K pass.
template <int MT, bool kAligned>
__global__ void __launch_bounds__(128) dq_small_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int M, int K, int N, int KC) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wring = reinterpret_cast<int8_t*>(smem);
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * kKT * kWLd);
  const int xld = KC + 8;  // KC % 32 == 0 keeps the A loads conflict-free
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = lane & 3, g = lane >> 2;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.z * 16 * MT;
  const int k_begin = blockIdx.y * KC, k_end = min(K, k_begin + KC);
  const int m_rows = min(16 * MT, M - m0);
  const int nkt = (k_end - k_begin + kKT - 1) / kKT;

  // the x slice, zero past k_end, rows < m_rows only
  const int kc_pad = nkt * kKT;
  if (kAligned) {
    for (int i = threadIdx.x; i < m_rows * (kc_pad / 8); i += 128) {
      const int r = i / (kc_pad / 8), c = (i % (kc_pad / 8)) * 8;
      const int gk = k_begin + c;
      const bool in = gk < k_end;
      async::copy16(xs + r * xld + c,
                    in ? x + (long long)(m0 + r) * K + gk : x,
                    in ? 2 * min(8, k_end - gk) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < m_rows * kc_pad; i += 128) {
      const int r = i / kc_pad, c = i % kc_pad;
      const int gk = k_begin + c;
      xs[r * xld + c] = gk < k_end ? x[(long long)(m0 + r) * K + gk]
                                   : __float2bfloat16(0.f);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt)
      load_w_tile<kAligned, 128>(wring + s * kKT * kWLd, w,
                                 k_begin + s * kKT, k_end, n0, N);
    async::commit();
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    const int nt = t + kStages - 1;
    if (nt < nkt)
      load_w_tile<kAligned, 128>(wring + (nt % kStages) * kKT * kWLd, w,
                                 k_begin + nt * kKT, k_end, n0, N);
    async::commit();
    async::wait<kStages - 1>();
    __syncthreads();
    const int8_t* wt = wring + (t % kStages) * kKT * kWLd;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      uint32_t b0[4], b1[4];
      load_b(wt, kk, warp * 32, b0, b1);
      const int kc = t * kKT + kk + 2 * kq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = 16 * mt + g;
        uint32_t a[4];
        const uint32_t* lo =
            reinterpret_cast<const uint32_t*>(xs + r * xld + kc);
        const uint32_t* hi =
            reinterpret_cast<const uint32_t*>(xs + (r + 8) * xld + kc);
        a[0] = r < m_rows ? lo[0] : 0u;
        a[1] = r + 8 < m_rows ? hi[0] : 0u;
        a[2] = r < m_rows ? lo[4] : 0u;  // +8 bf16
        a[3] = r + 8 < m_rows ? hi[4] : 0u;
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) mma_bf16(acc[mt][tt], a, b0[tt], b1[tt]);
      }
    }
    __syncthreads();
  }
  async::wait<0>();
  epilogue<MT, kAligned>(acc, m0, n0 + warp * 32, M, N, scale, out,
                         gridDim.y > 1
                             ? part + (long long)blockIdx.y * M * N
                             : nullptr);
}

// -- small M, whole K: one block per 32 columns ----------------------------

constexpr int kGStages = 3;  // ring depth
constexpr int kGWarps = 8;   // warps a block, 32 K rows of a tile each
constexpr int kGBN = 32;     // output columns a block

// grid (N / 32 column tiles, 1, 1), M <= 16*MT; warp w takes the 32 K
// rows 32w .. 32w + 31 of every KT = 256-row tile. The block streams its
// column slab of the weight (all of K) through a cp.async ring, and
// its warps' sums meet in shared memory in warp order. No K is split
// across blocks, so there is no partial sum in device memory and no
// second pass. Dynamic shared memory: the ring [kGStages][KT][BN + 16]
// int8, the x slice [16*MT][kpad + 8] bf16, the warps' sums
// [kGWarps][16*MT][BN] f32.
template <int MT, bool kAligned>
__global__ void __launch_bounds__(32 * kGWarps) dq_gemv_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
    int K, int N) {
  constexpr int BN = kGBN, KW = kGWarps, KT = 32 * KW, LD = BN + 16;
  constexpr int kThreads = 32 * KW;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* wring = reinterpret_cast<int8_t*>(smem);
  const int kpad = (K + KT - 1) / KT * KT;
  const int xld = kpad + 8;  // kpad % 16 == 0 keeps the A loads conflict-free
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + kGStages * KT * LD);
  float* red = reinterpret_cast<float*>(xs + 16 * MT * xld);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = lane & 3, g = lane >> 2;
  const int wk = warp;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * 16 * MT;
  const int m_rows = min(16 * MT, M - m0);
  const int nkt = kpad / KT;

  auto load_x = [&]() {
    if (kAligned) {
      for (int i = threadIdx.x; i < m_rows * (kpad / 8); i += kThreads) {
        const int r = i / (kpad / 8), c = (i % (kpad / 8)) * 8;
        const bool in = c < K;
        async::copy16(xs + r * xld + c,
                      in ? x + (long long)(m0 + r) * K + c : x, in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < m_rows * kpad; i += kThreads) {
        const int r = i / kpad, c = i % kpad;
        xs[r * xld + c] = c < K ? x[(long long)(m0 + r) * K + c]
                                : __float2bfloat16(0.f);
      }
    }
  };
  auto load_tile = [&](int t) {
    int8_t* wt = wring + (t % kGStages) * KT * LD;
    const int k0 = t * KT;
    if (kAligned) {
      for (int i = threadIdx.x; i < KT * (BN / 16); i += kThreads) {
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        const bool in = k0 + r < K && n0 + c < N;
        async::copy16(wt + r * LD + c,
                      in ? w + (long long)(k0 + r) * N + n0 + c : w,
                      in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < KT * BN; i += kThreads) {
        const int r = i / BN, c = i % BN;
        wt[r * LD + c] = (k0 + r < K && n0 + c < N)
                             ? w[(long long)(k0 + r) * N + n0 + c]
                             : int8_t(0);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
  auto compute_tile = [&](int t) {
    const int8_t* wt = wring + (t % kGStages) * KT * LD;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 16) {
      uint32_t b0[4], b1[4];
      load_b<LD>(wt, wk * 32 + kk, 0, b0, b1);
      const int kc = t * KT + wk * 32 + kk + 2 * kq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = 16 * mt + g;
        uint32_t a[4];
        const uint32_t* lo =
            reinterpret_cast<const uint32_t*>(xs + r * xld + kc);
        const uint32_t* hi =
            reinterpret_cast<const uint32_t*>(xs + (r + 8) * xld + kc);
        a[0] = r < m_rows ? lo[0] : 0u;
        a[1] = r + 8 < m_rows ? hi[0] : 0u;
        a[2] = r < m_rows ? lo[4] : 0u;
        a[3] = r + 8 < m_rows ? hi[4] : 0u;
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
          mma_bf16(acc[mt][tt], a, b0[tt], b1[tt]);
      }
    }
  };

  if (nkt <= kGStages) {
    // the whole slab fits the ring (K <= 768 at 32 columns): every weight
    // copy first, then x, one wait and one barrier, and the tiles back to
    // back
    for (int t = 0; t < nkt; ++t) load_tile(t);
    load_x();
    async::commit();
    async::wait<0>();
    __syncthreads();
    for (int t = 0; t < nkt; ++t) compute_tile(t);
  } else {
    load_x();
#pragma unroll
    for (int s = 0; s < kGStages - 1; ++s) {
      load_tile(s);
      async::commit();
    }
    for (int t = 0; t < nkt; ++t) {
      if (t + kGStages - 1 < nkt) load_tile(t + kGStages - 1);
      async::commit();
      async::wait<kGStages - 1>();
      __syncthreads();
      compute_tile(t);
      __syncthreads();
    }
  }
  async::wait<0>();
  // the K groups' sums, in K-group order; lane columns 8kq .. 8kq+7
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* dst = red + (wk * 16 * MT + 16 * mt + g + 8 * half) * BN +
                   8 * kq;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        dst[tt] = acc[mt][tt][2 * half];
        dst[4 + tt] = acc[mt][tt][2 * half + 1];
      }
    }
  __syncthreads();
  for (int e = threadIdx.x; e < m_rows * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    if (n0 + c >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) v += red[(kw * 16 * MT + r) * BN + c];
    out[(long long)(m0 + r) * N + n0 + c] =
        __float2bfloat16(v * scale[n0 + c]);
  }
}

// -- large M: BM x 128 tiles on the tensor cores --------------------------

// grid (column tiles, row tiles, K slices); WM x WN warps, each owning a
// (BM / WM) x (128 / WN) patch of the tile (MT m16 tiles by NG groups of
// 32 columns); dynamic shared memory: the x ring [kStages][BM][kXLd] bf16,
// then the weight ring
template <int BM, int WM, int WN, int kMinBlocks, bool kAligned>
__global__ void __launch_bounds__(WM * WN * 32, kMinBlocks) dq_large_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int M, int K, int N, int KC) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int MT = BM / WM / 16;    // m16 tiles a warp
  constexpr int NG = kBN / WN / 32;   // 32-column groups a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xring = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* wring = reinterpret_cast<int8_t*>(
      smem + kStages * BM * kXLd * sizeof(__nv_bfloat16));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * KC, k_end = min(K, k_begin + KC);
  const int nkt = (k_end - k_begin + kKT - 1) / kKT;

  auto load_x_tile = [&](__nv_bfloat16* xt, int k0) {
    if (kAligned) {
      for (int i = threadIdx.x; i < BM * (kKT / 8); i += kThreads) {
        const int r = i / (kKT / 8), c = (i % (kKT / 8)) * 8;
        const int gm = m0 + r, gk = k0 + c;
        const bool in = gm < M && gk < k_end;
        async::copy16(xt + r * kXLd + c, in ? x + (long long)gm * K + gk : x,
                      in ? 2 * min(8, k_end - gk) : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BM * kKT; i += kThreads) {
        const int r = i / kKT, c = i % kKT;
        const int gm = m0 + r, gk = k0 + c;
        xt[r * kXLd + c] = (gm < M && gk < k_end)
                               ? x[(long long)gm * K + gk]
                               : __float2bfloat16(0.f);
      }
    }
  };
  // aligned: each thread's copies keep their rows and columns from tile
  // to tile, so their sources are set up once and only step along K
  constexpr int XCH = BM * (kKT / 8) / kThreads;   // x copies a tile
  constexpr int WCH = kKT * (kBN / 16) / kThreads;  // weight copies a tile
  const int xc = (threadIdx.x % (kKT / 8)) * 8;
  const int wc = (threadIdx.x % (kBN / 16)) * 16;
  const __nv_bfloat16* xsrc[XCH];
  const int8_t* wsrc[WCH];
  bool xok[XCH];
  const bool wok = n0 + wc < N;
#pragma unroll
  for (int j = 0; j < XCH; ++j) {
    const int r = threadIdx.x / (kKT / 8) + j * (kThreads / (kKT / 8));
    xok[j] = m0 + r < M;
    xsrc[j] = x + (long long)(xok[j] ? m0 + r : 0) * K + k_begin + xc;
  }
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    const int r = threadIdx.x / (kBN / 16) + j * (kThreads / (kBN / 16));
    wsrc[j] = w + (long long)(k_begin + r) * N + (wok ? n0 + wc : 0);
  }
  auto load_tile = [&](int t) {
    const int st = t % kStages;
    if (kAligned) {
      const int k0 = k_begin + t * kKT;
      __nv_bfloat16* xt = xring + st * BM * kXLd;
      int8_t* wt = wring + st * kKT * kWLd;
#pragma unroll
      for (int j = 0; j < XCH; ++j) {
        const int r = threadIdx.x / (kKT / 8) + j * (kThreads / (kKT / 8));
        const bool in = xok[j] && k0 + xc < k_end;
        async::copy16(xt + r * kXLd + xc, in ? xsrc[j] + t * kKT : x,
                      in ? 16 : 0);
      }
#pragma unroll
      for (int j = 0; j < WCH; ++j) {
        const int r = threadIdx.x / (kBN / 16) + j * (kThreads / (kBN / 16));
        const bool in = wok && k0 + r < k_end;
        async::copy16(wt + r * kWLd + wc,
                      in ? wsrc[j] + (long long)t * kKT * N : w, in ? 16 : 0);
      }
    } else {
      load_x_tile(xring + st * BM * kXLd, k_begin + t * kKT);
      load_w_tile<kAligned, kThreads>(wring + st * kKT * kWLd, w,
                                      k_begin + t * kKT, k_end, n0, N);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load_tile(s);
    async::commit();
  }

  float acc[NG][MT][4][4];
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][mt][t][e] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    if (t + kStages - 1 < nkt) load_tile(t + kStages - 1);
    async::commit();
    async::wait<kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* xt = xring + (t % kStages) * BM * kXLd;
    const int8_t* wt = wring + (t % kStages) * kKT * kWLd;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], xt + (wm * (BM / WM) + mt * 16 + (lane & 15)) *
                                    kXLd + kk + (lane >> 4) * 8);
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        uint32_t b0[4], b1[4];
        load_b(wt, kk, (wn * NG + gi) * 32, b0, b1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int tt = 0; tt < 4; ++tt)
            mma_bf16(acc[gi][mt][tt], a[mt], b0[tt], b1[tt]);
      }
    }
    __syncthreads();
  }
  async::wait<0>();
  float* p = gridDim.z > 1 ? part + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
    epilogue<MT, kAligned>(acc[gi], m0 + wm * (BM / WM),
                           n0 + (wn * NG + gi) * 32, M, N, scale, out, p);
}

// -- the split-K pass: sum the partials in split order, scale, round ------

__global__ void __launch_bounds__(256) dq_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const long long total = (long long)M * N;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
  out[i] = __float2bfloat16(s * scale[i % N]);
}

// -- f32 activations: FMA tiles --------------------------------------------

constexpr int kFBN = 64, kFBK = 32;

// One BM x 64 output tile over the K rows [blockIdx.z * KC, + KC). With
// one split it writes the scaled result; with several, its raw f32 sums
// to the split's slice of `part`, which dq_reduce_f32_kernel adds up.
template <int BM>
__global__ void __launch_bounds__(256) dequant_matmul_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out,
    float* __restrict__ part, int M, int K, int N, int KC) {
  constexpr int TM = BM / 16, TN = 4;  // 16 x 16 threads
  __shared__ float xs[kFBK][BM + 1];   // transposed x tile
  __shared__ float ws[kFBK][kFBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kFBN;
  const int kb = blockIdx.z * KC, ke = min(K, kb + KC);
  float acc[TM][TN] = {};
  for (int k0 = kb; k0 < ke; k0 += kFBK) {
    for (int i = tid; i < BM * kFBK; i += 256) {
      const int m = i / kFBK, k = i % kFBK;
      const int gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < ke) ? x[(long long)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < kFBK * kFBN; i += 256) {
      const int k = i / kFBN, n = i % kFBN;
      const int gk = k0 + k, gn = n0 + n;
      ws[k][n] = (gk < ke && gn < N) ? (float)w[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  float* dst = gridDim.z > 1 ? part + (long long)blockIdx.z * M * N : out;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty * TM + i, gn = n0 + tx * TN + j;
      if (gm < M && gn < N)
        dst[(long long)gm * N + gn] =
            gridDim.z > 1 ? acc[i][j] : acc[i][j] * scale[gn];
    }
}

// the f32 split-K pass: the partials summed in split order, then scaled
__global__ void __launch_bounds__(256) dq_reduce_f32_kernel(
    const float* __restrict__ part, const float* __restrict__ scale,
    float* __restrict__ out, int M, int N, int splits) {
  const long long total = (long long)M * N;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
  out[i] = s * scale[i % N];
}

// -- host side --------------------------------------------------------------

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// small M: split K, or whole K a block of 32 columns; large M: 128 x 128
// tiles of 4 warps (64 x 64 each)
enum Design { kSplitK, kWholeK, kTiles };

struct Plan {
  Design design;
  int mt, KC, splits;
  dim3 grid;
  size_t smem;
};

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// the whole-K design's shared memory
size_t gemv_smem(int K, int mt) {
  const int kt = 32 * kGWarps;
  return (size_t)kGStages * kt * (kGBN + 16) +
         (size_t)16 * mt * (round_up(K, kt) + 8) * sizeof(__nv_bfloat16) +
         (size_t)kGWarps * 16 * mt * kGBN * sizeof(float);
}

Plan make_plan(int M, int K, int N, Design design) {
  Plan p{};
  p.design = design;
  const int ct = (N + kBN - 1) / kBN;
  const int sms = num_sms();
  if (design == kWholeK) {
    // M <= kWholeKMaxM = 48: one block of up to 3 m16 tiles of rows
    p.mt = M <= 16 ? 1 : M <= 32 ? 2 : 3;
    p.KC = K;
    p.splits = 1;
    p.grid = dim3((N + kGBN - 1) / kGBN, 1, 1);
    p.smem = gemv_smem(K, p.mt);
  } else if (design == kSplitK) {
    // M <= kSplitKMaxM = 16: one m16 tile of rows
    p.mt = 1;
    // at least two blocks per SM: K slices of a multiple of 32 rows each
    const int want = (2 * sms + ct - 1) / ct;
    int kc = K / want / kKT * kKT;
    kc = kc < kKT ? kKT : kc > kMaxKC ? kMaxKC : kc;
    p.KC = kc;
    p.splits = (K + kc - 1) / kc;
    p.grid = dim3(ct, p.splits, 1);
    p.smem = (size_t)kStages * kKT * kWLd +
             (size_t)16 * p.mt * (kc + 8) * sizeof(__nv_bfloat16);
  } else {
    const int bm = 128;
    p.mt = 4;
    const int tiles = ct * ((M + bm - 1) / bm);
    // split K only when the tiles cannot fill the SMs once
    int splits = tiles >= sms ? 1 : sms / tiles;
    const int max_splits = (K + 4 * kKT - 1) / (4 * kKT);  // >= 4 tiles
    splits = splits < 1 ? 1 : splits > max_splits ? max_splits : splits;
    const int kc = round_up((K + splits - 1) / splits, kKT);
    p.KC = kc;
    p.splits = (K + kc - 1) / kc;
    p.grid = dim3(ct, (M + bm - 1) / bm, p.splits);
    p.smem = (size_t)kStages * (bm * kXLd * sizeof(__nv_bfloat16) +
                                kKT * kWLd);
  }
  return p;
}

size_t workspace_bytes(const Plan& p, int M, int N) {
  return p.splits > 1 ? (size_t)p.splits * M * N * sizeof(float) : 0;
}

// The f32 route's plan: BM = 16 rows a block for M <= 16, else 64; when
// those tiles cannot fill the SMs once (a narrow N, as a 64-class head),
// K is split too, at least two 32-row tiles a split.
Plan plan_f32(int M, int K, int N) {
  Plan p{};
  p.mt = M <= 16 ? 16 : 64;  // here: the rows of a block (BM)
  const int tiles = ((N + kFBN - 1) / kFBN) * ((M + p.mt - 1) / p.mt);
  const int sms = num_sms();
  int splits = tiles >= sms ? 1 : sms / tiles;
  const int max_splits = (K + 2 * kFBK - 1) / (2 * kFBK);
  splits = splits < 1 ? 1 : splits > max_splits ? max_splits : splits;
  p.KC = round_up((K + splits - 1) / splits, kFBK);
  p.splits = (K + p.KC - 1) / p.KC;
  p.grid = dim3((N + kFBN - 1) / kFBN, (M + p.mt - 1) / p.mt, p.splits);
  return p;
}

int run_f32(const Plan& p, const float* x, const int8_t* w,
            const float* scale, float* out, float* ws, int M, int K, int N,
            cudaStream_t st) {
  if (p.splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (p.mt == 16)
    dequant_matmul_f32_kernel<16><<<p.grid, 256, 0, st>>>(x, w, scale, out,
                                                          ws, M, K, N, p.KC);
  else
    dequant_matmul_f32_kernel<64><<<p.grid, 256, 0, st>>>(x, w, scale, out,
                                                          ws, M, K, N, p.KC);
  if (p.splits > 1) {
    const long long total = (long long)M * N;
    dq_reduce_f32_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        ws, scale, out, M, N, p.splits);
  }
  return (int)cudaGetLastError();
}


template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int MT, bool kAligned>
cudaError_t launch_small(const Plan& p, const __nv_bfloat16* x,
                         const int8_t* w, const float* scale,
                         __nv_bfloat16* out, float* ws, int M, int K, int N,
                         cudaStream_t st) {
  auto kernel = dq_small_kernel<MT, kAligned>;
  cudaError_t e = allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return e;
  kernel<<<p.grid, 128, p.smem, st>>>(x, w, scale, out, ws, M, K, N, p.KC);
  return cudaGetLastError();
}

template <int MT, bool kAligned>
cudaError_t launch_gemv(const Plan& p, const __nv_bfloat16* x,
                        const int8_t* w, const float* scale,
                        __nv_bfloat16* out, int M, int K, int N,
                        cudaStream_t st) {
  if (p.smem > 227 * 1024) return cudaErrorInvalidValue;  // K too long
  auto kernel = dq_gemv_kernel<MT, kAligned>;
  cudaError_t e = allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return e;
  kernel<<<p.grid, 32 * kGWarps, p.smem, st>>>(x, w, scale, out, M, K, N);
  return cudaGetLastError();
}

template <int BM, int WM, int WN, int kMinBlocks, bool kAligned>
cudaError_t launch_large(const Plan& p, const __nv_bfloat16* x,
                         const int8_t* w, const float* scale,
                         __nv_bfloat16* out, float* ws, int M, int K, int N,
                         cudaStream_t st) {
  auto kernel = dq_large_kernel<BM, WM, WN, kMinBlocks, kAligned>;
  cudaError_t e = allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return e;
  kernel<<<p.grid, WM * WN * 32, p.smem, st>>>(x, w, scale, out, ws, M, K, N,
                                               p.KC);
  return cudaGetLastError();
}

template <bool kAligned>
int launch_bf16(const Plan& p, const __nv_bfloat16* x, const int8_t* w,
                const float* scale, __nv_bfloat16* out, float* ws, int M,
                int K, int N, cudaStream_t st) {
  cudaError_t e = cudaSuccess;
  if (p.design == kSplitK) {
    e = launch_small<1, kAligned>(p, x, w, scale, out, ws, M, K, N, st);
  } else if (p.design == kWholeK) {
    switch (p.mt) {
      case 1:
        e = launch_gemv<1, kAligned>(p, x, w, scale, out, M, K, N, st);
        break;
      case 2:
        e = launch_gemv<2, kAligned>(p, x, w, scale, out, M, K, N, st);
        break;
      default:
        e = launch_gemv<3, kAligned>(p, x, w, scale, out, M, K, N, st);
    }
  } else {
    e = launch_large<128, 2, 2, 2, kAligned>(p, x, w, scale, out, ws, M, K,
                                             N, st);
  }
  if (e != cudaSuccess) return (int)e;
  if (p.splits > 1) {
    const long long total = (long long)M * N;
    dq_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        ws, scale, out, M, N, p.splits);
  }
  return (int)cudaGetLastError();
}

int run_bf16(const Plan& p, const void* x, const void* w, const void* scale,
             void* out, void* workspace, int M, int K, int N,
             cudaStream_t st) {
  if (p.splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  const bool aligned = K % 8 == 0 && N % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(workspace) % 16 == 0;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const int8_t*>(w);
  auto sb = static_cast<const float*>(scale);
  auto ob = static_cast<__nv_bfloat16*>(out);
  auto ws = static_cast<float*>(workspace);
  return aligned ? launch_bf16<true>(p, xb, wb, sb, ob, ws, M, K, N, st)
                 : launch_bf16<false>(p, xb, wb, sb, ob, ws, M, K, N, st);
}

// The plan by M, from a sweep of every design over M at both MLP shapes
// on the card (readings in PERF.md): the whole-K design up to kWholeKMaxM
// where its 32-column blocks fill two thirds of the SMs and its x slice
// fits, else split K up to kSplitKMaxM, else the tiles.
Plan plan(int M, int K, int N) {
  const int mt = M <= 16 ? 1 : M <= 32 ? 2 : 3;
  const int blocks = (N + kGBN - 1) / kGBN;
  if (M <= kWholeKMaxM && 3 * blocks >= 2 * num_sms() &&
      gemv_smem(K, mt) <= 160 * 1024)
    return make_plan(M, K, N, kWholeK);
  if (M <= kSplitKMaxM) return make_plan(M, K, N, kSplitK);
  return make_plan(M, K, N, kTiles);
}

}  // namespace

extern "C" {

// Bytes of f32 workspace the launch needs: 0 when it splits nothing.
long long dequant_matmul_workspace_bytes(int M, int K, int N, int dtype) {
  if (M == 0 || N == 0) return 0;
  return (long long)workspace_bytes(
      dtype == 1 ? plan(M, K, N) : plan_f32(M, K, N), M, N);
}

// the largest M the split-K design takes, and the whole-K design
int dequant_matmul_crossover_m() { return kSplitKMaxM; }
int dequant_matmul_whole_k_max_m() { return kWholeKMaxM; }

// dtype: 0 = float32, 1 = bfloat16 (x and out). workspace: at least
// dequant_matmul_workspace_bytes(M, K, N, dtype) bytes (may be
// null when that is 0). Returns cudaGetLastError() after the launches
// (0 = launched).
int dequant_matmul(const void* x, const void* w, const void* scale,
                   void* out, void* workspace, int M, int K, int N,
                   int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run_bf16(plan(M, K, N), x, w, scale, out, workspace, M, K, N, st);
  return run_f32(plan_f32(M, K, N), static_cast<const float*>(x),
                 static_cast<const int8_t*>(w),
                 static_cast<const float*>(scale), static_cast<float*>(out),
                 static_cast<float*>(workspace), M, K, N, st);
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
