// Paged-flash decode for Hopper (sm_90a): attention of each slot's Q
// query rows over its committed KV rows, read straight from the paged
// block pool through the slot's block table (flash-decoding).
//
// Replaces: deeplearning4j_tpu/kernels/paged_flash_decode.py
//   paged_flash_decode (Pallas body _kernel). There the grid walked
//   (slot, table column) in order on one TensorCore and carried the
//   online-softmax state in VMEM scratch from one column to the next.
//
// What bounds it on the H100: device-memory bytes, at both shapes of the
// main path. The decode step (Q = 1) and the spec verify (Q = 5) at the
// serving shape (8 slots, 12 heads of 64, bf16, Bs = 16, lengths 0 ..
// 1019) read about 7.8 MB of visible K/V rows a layer, 2.4 us at 3.35
// TB/s, at ~1 flop a byte (Q = 1) and ~5 (Q = 5), far under the ~295 the
// tensor cores need. What it has to beat is latency: one block per (slot,
// head) left the 1019-row slot's 12 blocks walking 64 columns alone.
//
// Design:
//  - split the column walk: block (split, head, slot) covers kSplitRows
//    table rows (128 = 8 pool blocks of 16 rows at the serving shape), so
//    the longest slot is read by 8 blocks at once. The grid comes from
//    host shapes only (S, H, MB * Bs, the split size), never from
//    lengths: a split past lengths[s] + Q exits at once and nothing reads
//    lengths on the host, so the launch can be captured in a CUDA graph.
//  - a block first reads what does not depend on the slot's length (its
//    split's table entries, into shared memory, and q), together with the
//    length, so one device-memory round trip precedes the first K/V copy.
//  - each split writes its m, l and f32 acc for its query rows to a
//    workspace (torch.empty in the wrapper); the last split of a (slot,
//    head) to finish (an atomic counter, reset by that block) merges the
//    splits in split order with the log-sum-exp rescale and divides by
//    max(l, 1e-30): one launch, and the same bits whichever block merges.
//    A slot whose rows fit one split has its output written by that
//    split. A split that sees no visible row for a query row gives m =
//    -1e30, l = 0, acc = 0 and adds nothing; row 0 is visible to every
//    query row (also at length 0), so no merge divides 0.
//  - K/V rows arrive as 16-byte cp.async copies through a 4-stage ring:
//    at D = 64 bf16 one head's row is 128 bytes, 8 lanes, one whole cache
//    line. Only rows up to the split's last visible row are read.
//  - Q = 1 (and f32, or D > 128): lane group g (8 lanes) takes rows g and
//    g + 16 of each 32-row tile (16-row tiles where a row passes 128 bytes)
//    and keeps its own online-softmax state: a score is a warp-level dot
//    product (each lane 16 bytes of the row, 3 xor shuffles), P.V is each
//    lane's own slice of D, with no shared-memory round trip for the
//    scores. The 16 groups merge at the end: 4 within a warp by shuffles,
//    4 warps through shared memory, in a fixed order. p stays f32. On
//    this path a slot's Q query rows take Q blocks (the K/V rows come
//    from L2 after the first).
//  - Q = 2 .. 16 in bf16 with D = 64 or 128: the tensor cores. All query
//    rows of the slot form one m16 tile (rows >= Q zero); each warp takes
//    16 key rows of a 64-row tile: S = q K^T on mma.sync m16n8k16 (K via
//    ldmatrix), the online softmax on the accumulator fragments, then
//    O += P V with p rounded to bf16 as the A operand (V via
//    ldmatrix.trans), as the Pallas body rounds p to V's dtype.
//  - the pool slice [N, Bs, H, D] is one layer of the [N, L, Bs, H, D]
//    pool and is not contiguous: its strides come in as arguments (the
//    d-stride is 1), so the caller never copies the layer's pool.
//  - the mask value is -1e30 and l is clamped at 1e-30, as in the Pallas
//    kernel. Output is in q's dtype.
//
// Left on the table: a split reads one head's rows, 128 bytes apart from
// the next head's in the same pool block; a head group a block would read
// the block's Bs*H*D bytes as one span. The Q = 1 step could also use the
// tensor cores (15 of 16 rows wasted, but one warp per 16 keys); the
// launch latency itself is the next bound (a CUDA graph of the step).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "tensor_core.cuh"

namespace {

using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::pack_bf16;

constexpr int kThreads = 128;   // 16 lane groups of 8
constexpr int kStages = 4;      // cp.async ring depth
constexpr int kSplitRows = 128;  // table rows per split: whole 64-row tiles
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPerChunk = 4;  // elements in 16 bytes
  __device__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float to_f32(float x) { return x; }
  __device__ static float from_f32(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  __device__ static void widen(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16(x);
  }
};

struct Args {
  const void* q;        // [S, Q, H, D] contiguous
  const void* k;        // [N, Bs, H, D] strided layer view
  const void* v;        // [N, Bs, H, D] strided layer view
  const int* tables;    // [S, MB]
  const int* lengths;   // [S]
  void* out;            // [S, Q, H, D] contiguous
  float* part;          // [S, H, n_splits, Q, D + 2]: acc[D], m, l
  int* counters;        // [S, H * n_qg], zero between launches
  int S, Q, H, D, Bs, MB, N, n_splits, qmax;
  long long k_sn, k_sb, k_sh, v_sn, v_sb, v_sh;
  float scale;
};

// query rows q0 .. q0 + nq - 1 of a block along the head axis, and the
// rows any of them can see: 0 .. len + q0 + nq - 1, within the table
struct Rows {
  int q0, nq, len, n_rows;
  __device__ Rows(const Args& a, int s, int qg) {
    q0 = qg * a.qmax;
    nq = min(a.qmax, a.Q - q0);
    len = max(a.lengths[s], 0);
    n_rows = min(len + q0 + nq, a.MB * a.Bs);
  }
};

// ctx of query rows rw.q0 .. of (slot s, head h): the n_act splits'
// partials merged in split order with the log-sum-exp rescale
template <typename T>
__device__ void merge_splits(const Args& a, int s, int h, const Rows& rw,
                             int n_act) {
  const int D = a.D;
  for (int i = threadIdx.x; i < rw.nq * D; i += kThreads) {
    const int qa = rw.q0 + i / D, d = i % D;
    const float* base =
        a.part + ((long long)(s * a.H + h) * a.n_splits * a.Q + qa) * (D + 2);
    const long long step = (long long)a.Q * (D + 2);  // next split
    float mx = kNegInf;
    for (int sp = 0; sp < n_act; ++sp)
      mx = fmaxf(mx, __ldcg(base + sp * step + D));
    float lsum = 0.f, asum = 0.f;
    for (int sp = 0; sp < n_act; ++sp) {
      const float* src = base + sp * step;
      const float f = __expf(__ldcg(src + D) - mx);
      lsum += __ldcg(src + D + 1) * f;
      asum += __ldcg(src + d) * f;
    }
    static_cast<T*>(a.out)[((long long)(s * a.Q + qa) * a.H + h) * D + d] =
        Elem<T>::from_f32(asum / fmaxf(lsum, 1e-30f));
  }
}

// The end of a split: the 4 warps' (m, l, acc) in red [4][QMAX][D + 2]
// (f32, this block's shared memory) merged in warp order; the context
// written when the slot has one active split, else the split's partial,
// and the last of the slot's splits to arrive merges them all.
template <typename T, int QMAX>
__device__ void finish_split(const Args& a, const float* red, int s, int h,
                             int sp, const Rows& rw, int n_act) {
  const int D = a.D, tid = threadIdx.x;
  for (int i = tid; i < rw.nq * D; i += kThreads) {
    const int qi = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      mx = fmaxf(mx, red[(w * QMAX + qi) * (D + 2) + D]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* src = red + (w * QMAX + qi) * (D + 2);
      const float f = __expf(src[D] - mx);
      lsum += src[D + 1] * f;
      asum += src[d] * f;
    }
    const int qa = rw.q0 + qi;
    if (n_act == 1) {
      static_cast<T*>(a.out)[((long long)(s * a.Q + qa) * a.H + h) * D + d] =
          Elem<T>::from_f32(asum / fmaxf(lsum, 1e-30f));
    } else {
      float* dst = a.part +
                   (((long long)(s * a.H + h) * a.n_splits + sp) * a.Q + qa) *
                       (D + 2);
      dst[d] = asum;
      if (d == 0) {
        dst[D] = mx;
        dst[D + 1] = lsum;
      }
    }
  }
  if (n_act == 1) return;
  // the last of the slot's active splits to arrive merges them all; the
  // barrier orders the block's partial writes before thread 0's fence
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    int* c = a.counters + (long long)s * gridDim.y + blockIdx.y;
    last = atomicAdd(c, 1) == n_act - 1;
    if (last) *c = 0;  // zero again for the next launch
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  merge_splits<T>(a, s, h, rw, n_act);
}

// grid (n_splits, H * ceil(Q / QMAX), S); VPL 16-byte chunks of D a lane;
// TR rows a tile (TR / 16 a lane group)
template <typename T, int VPL, int QMAX, int TR>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(Args a) {
  using E = Elem<T>;
  constexpr int EPC = E::kPerChunk;
  constexpr int W = VPL * EPC;  // elements of D a lane owns
  constexpr int RPG = TR / 16;  // rows a lane group takes per tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, nchunks = D / EPC;
  const int sp = blockIdx.x, s = blockIdx.z;
  const int h = blockIdx.y % a.H, qg = blockIdx.y / a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid >> 3, lg = tid & 7;
  const unsigned gmask = 0xffu << (lane & 24);

  const size_t ring_tile = (size_t)TR * D;  // elements
  T* kring = reinterpret_cast<T*>(smem);
  T* vring = kring + kStages * ring_tile;
  const size_t ring_bytes = 2 * kStages * ring_tile * sizeof(T);
  const size_t merge_bytes = (size_t)4 * QMAX * (D + 2) * sizeof(float);
  float* q_sh = reinterpret_cast<float*>(
      smem + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes));
  int* blk_sh = reinterpret_cast<int*>(q_sh + QMAX * D);

  // what does not depend on the slot's length goes first, so its reads
  // are in flight together with the length's: the split's table entries
  // (a copy's address then waits on shared memory only) and q
  const int r_begin = sp * kSplitRows;
  const int col0 = r_begin / a.Bs;
  const int n_cols = min((r_begin + kSplitRows - 1) / a.Bs, a.MB - 1) -
                     col0 + 1;
  const int* table = a.tables + (long long)s * a.MB;
  for (int c = tid; c < n_cols; c += kThreads)
    blk_sh[c] = min(max(table[col0 + c], 0), a.N - 1);
  const int q0 = qg * a.qmax, nq_blk = min(a.qmax, a.Q - q0);
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < nq_blk * D; i += kThreads) {
    const int qi = i / D, d = i % D;
    q_sh[i] = E::to_f32(q[((long long)(s * a.Q + q0 + qi) * a.H + h) * D +
                          d]) * a.scale;
  }
  const Rows rw(a, s, qg);
  if (r_begin >= rw.n_rows) return;  // past every visible row
  const int r_end = min(r_begin + kSplitRows, rw.n_rows);
  const int n_tiles = (r_end - r_begin + TR - 1) / TR;
  const int n_act = (rw.n_rows + kSplitRows - 1) / kSplitRows;
  __syncthreads();

  const T* kp = static_cast<const T*>(a.k) + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + h * a.v_sh;
  auto load_tile = [&](int t) {
    const int st = t % kStages;
    for (int i = tid; i < TR * nchunks; i += kThreads) {
      const int rr = i / nchunks, c = i % nchunks;
      const int r = r_begin + t * TR + rr;
      if (r >= r_end) continue;
      const int blk = blk_sh[r / a.Bs - col0];
      const int ib = r % a.Bs;
      async::copy16(kring + st * ring_tile + rr * D + c * EPC,
                    kp + blk * a.k_sn + ib * a.k_sb + c * EPC);
      async::copy16(vring + st * ring_tile + rr * D + c * EPC,
                    vp + blk * a.v_sn + ib * a.v_sb + c * EPC);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    async::commit();
  }

  float m[QMAX], l[QMAX], acc[QMAX][W];
#pragma unroll
  for (int qi = 0; qi < QMAX; ++qi) {
    m[qi] = kNegInf;
    l[qi] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[qi][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    async::commit();
    async::wait<kStages - 1>();
    __syncthreads();
    // scores of the group's rows first (independent: their loads and
    // shuffles overlap), then the online-softmax updates in row order
    float vf[RPG][W], sc[RPG][QMAX];
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) {
      const int r = r_begin + t * TR + grp + 16 * rr;
      if (r >= r_end) continue;  // the same for the group's 8 lanes
      const T* krow = kring + (t % kStages) * ring_tile + (grp + 16 * rr) * D;
      const T* vrow = vring + (t % kStages) * ring_tile + (grp + 16 * rr) * D;
      float kf[W];
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int c = lg + 8 * v;
        uint4 ku = make_uint4(0, 0, 0, 0), vu = ku;
        if (c < nchunks) {
          ku = *reinterpret_cast<const uint4*>(krow + c * EPC);
          vu = *reinterpret_cast<const uint4*>(vrow + c * EPC);
        }
        E::widen(ku, kf + v * EPC);
        E::widen(vu, vf[rr] + v * EPC);
      }
#pragma unroll
      for (int qi = 0; qi < QMAX; ++qi) {
        if (qi >= rw.nq) break;
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int c = lg + 8 * v;
          if (c < nchunks) {
            const float* qc = q_sh + qi * D + c * EPC;
#pragma unroll
            for (int e = 0; e < EPC; ++e) dot += qc[e] * kf[v * EPC + e];
          }
        }
        dot += __shfl_xor_sync(gmask, dot, 1);
        dot += __shfl_xor_sync(gmask, dot, 2);
        dot += __shfl_xor_sync(gmask, dot, 4);
        sc[rr][qi] = dot;
      }
    }
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) {
      const int r = r_begin + t * TR + grp + 16 * rr;
      if (r >= r_end) continue;
#pragma unroll
      for (int qi = 0; qi < QMAX; ++qi) {
        if (qi >= rw.nq) break;
        if (r > rw.len + rw.q0 + qi) continue;  // hidden from this row
        const float dot = sc[rr][qi];
        if (dot > m[qi]) {  // a new max: rescale, p = 1
          const float alpha = __expf(m[qi] - dot);
          l[qi] = l[qi] * alpha + 1.f;
#pragma unroll
          for (int e = 0; e < W; ++e)
            acc[qi][e] = acc[qi][e] * alpha + vf[rr][e];
          m[qi] = dot;
        } else {
          const float p = __expf(dot - m[qi]);
          l[qi] += p;
#pragma unroll
          for (int e = 0; e < W; ++e) acc[qi][e] += p * vf[rr][e];
        }
      }
    }
    __syncthreads();
  }
  async::wait<0>();

  // merge the 4 groups of each warp (xor 8, 16), then the 4 warps
  float* red = reinterpret_cast<float*>(smem);  // [4][QMAX][D + 2]
#pragma unroll
  for (int qi = 0; qi < QMAX; ++qi) {
    if (qi >= rw.nq) break;
    float mw = fmaxf(m[qi], __shfl_xor_sync(0xffffffffu, m[qi], 8));
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 16));
    const float f = __expf(m[qi] - mw);
    float lw = l[qi] * f;
    lw += __shfl_xor_sync(0xffffffffu, lw, 8);
    lw += __shfl_xor_sync(0xffffffffu, lw, 16);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float x = acc[qi][e] * f;
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      acc[qi][e] = x;
    }
    float* dst = red + (warp * QMAX + qi) * (D + 2);
    if (lane < 8) {
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int c = lg + 8 * v;
        if (c < nchunks) {
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            dst[c * EPC + e] = acc[qi][v * EPC + e];
        }
      }
      if (lane == 0) {
        dst[D] = mw;
        dst[D + 1] = lw;
      }
    }
  }
  __syncthreads();
  finish_split<T, QMAX>(a, red, s, h, sp, rw, n_act);
}

template <typename T, int VPL, int QMAX>
int launch_split(Args& a, cudaStream_t st) {
  // two rows a lane group and tile where a row is at most 128 bytes
  constexpr int TR = VPL == 1 ? 32 : 16;
  a.qmax = QMAX;
  const size_t ring = 2 * kStages * (size_t)TR * a.D * sizeof(T);
  const size_t merge = (size_t)4 * QMAX * (a.D + 2) * sizeof(float);
  const size_t smem = (ring > merge ? ring : merge) +
                      (size_t)QMAX * a.D * sizeof(float) +
                      sizeof(int) * (size_t)(kSplitRows / a.Bs + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, VPL, QMAX, TR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_qg = (a.Q + QMAX - 1) / QMAX;
  paged_split_kernel<T, VPL, QMAX, TR>
      <<<dim3(a.n_splits, a.H * n_qg, a.S), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// VPL = chunks of 16 bytes a lane owns (8 lanes a row); one query row a
// block (a Q-row slot takes Q blocks along the head axis, each reading
// the same K/V rows, from L2 after the first)
template <typename T, int VPL>
int launch_vpl(Args& a, cudaStream_t st) {
  return launch_split<T, VPL, 1>(a, st);
}

template <typename T>
int launch(Args& a, cudaStream_t st) {
  const int chunks = a.D * (int)sizeof(T) / 16;
  if (chunks <= 8) return launch_vpl<T, 1>(a, st);
  if (chunks <= 16) return launch_vpl<T, 2>(a, st);
  if (chunks <= 32) return launch_vpl<T, 4>(a, st);
  return launch_vpl<T, 8>(a, st);
}

// -- Q > 1 in bf16: the tensor cores ---------------------------------------

constexpr int kMmaRows = 64;    // key rows a tile: 16 a warp
constexpr int kMmaStages = 2;   // a 128-row split is in flight at once

// The same split for bf16 with Q of 2 .. 16 and D = 16 * DK <= 128: every
// query row of the slot in one m16 tile (rows >= Q are zero). Warp w takes
// key rows 16w .. 16w + 15 of each 64-row tile: S = q K^T on mma.sync
// m16n8k16 (K through ldmatrix), the online softmax on the accumulator
// fragments (a row's 4 lanes meet by two shuffles), then O += P V with P
// rounded to bf16 in registers as the A operand (V through ldmatrix.trans),
// as the Pallas body rounds p to V's dtype. Rows past the split's last
// visible row are copied as zeros, so every product is finite.
// grid (n_splits, H, S); dynamic shared memory: the K and V rings
// [kMmaStages][64][D + 8] bf16, then q [16][D + 8] bf16 and the split's
// table entries; the 4 warps' sums reuse the rings as [4][16][D + 2] f32.
template <int DK>
__global__ void __launch_bounds__(kThreads) paged_mma_kernel(Args a) {
  constexpr int D = 16 * DK, LD = D + 8;  // LD: conflict-free ldmatrix rows
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vring = kring + kMmaStages * kMmaRows * LD;
  __nv_bfloat16* q_sh = vring + kMmaStages * kMmaRows * LD;
  int* blk_sh = reinterpret_cast<int*>(q_sh + 16 * LD);
  const int sp = blockIdx.x, s = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kq = lane & 3, g = lane >> 2;

  const int r_begin = sp * kSplitRows;
  const int col0 = r_begin / a.Bs;
  const int n_cols = min((r_begin + kSplitRows - 1) / a.Bs, a.MB - 1) -
                     col0 + 1;
  const int* table = a.tables + (long long)s * a.MB;
  for (int c = tid; c < n_cols; c += kThreads)
    blk_sh[c] = min(max(table[col0 + c], 0), a.N - 1);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  for (int i = tid; i < 16 * DK * 2; i += kThreads) {  // 16 rows, 8-wide
    const int qi = i / (DK * 2), c = (i % (DK * 2)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (qi < a.Q)
      v = *reinterpret_cast<const uint4*>(
          q + ((long long)(s * a.Q + qi) * a.H + h) * D + c);
    *reinterpret_cast<uint4*>(q_sh + qi * LD + c) = v;
  }
  const Rows rw(a, s, 0);
  if (r_begin >= rw.n_rows) return;  // past every visible row
  const int r_end = min(r_begin + kSplitRows, rw.n_rows);
  const int n_tiles = (r_end - r_begin + kMmaRows - 1) / kMmaRows;
  const int n_act = (rw.n_rows + kSplitRows - 1) / kSplitRows;
  __syncthreads();

  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + h * a.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + h * a.v_sh;
  auto load_tile = [&](int t) {
    const int st = t % kMmaStages;
    for (int i = tid; i < kMmaRows * DK * 2; i += kThreads) {
      const int rr = i / (DK * 2), c = (i % (DK * 2)) * 8;
      const int r = r_begin + t * kMmaRows + rr;
      const bool in = r < r_end;
      const int blk = in ? blk_sh[r / a.Bs - col0] : 0;
      const int ib = in ? r % a.Bs : 0;
      async::copy16(kring + (st * kMmaRows + rr) * LD + c,
                    kp + blk * a.k_sn + ib * a.k_sb + c, in ? 16 : 0);
      async::copy16(vring + (st * kMmaRows + rr) * LD + c,
                    vp + blk * a.v_sn + ib * a.v_sb + c, in ? 16 : 0);
    }
  };
  load_tile(0);
  async::commit();

  // q as A fragments, one per 16 columns of D
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    ldsm_x4(qa[kk], q_sh + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);

  float o[2 * DK][4];  // D / 8 n8 tiles of the context
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8
  const int vis0 = rw.len + g, vis1 = rw.len + g + 8;  // last visible row

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    async::commit();
    async::wait<1>();
    __syncthreads();
    const int st = t % kMmaStages;
    const __nv_bfloat16* kt = kring + (st * kMmaRows + 16 * warp) * LD;
    const __nv_bfloat16* vt = vring + (st * kMmaRows + 16 * warp) * LD;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, kt + ((lane & 7) + 8 * (lane >> 4)) * LD + kk * 16 +
                     8 * ((lane >> 3) & 1));
      mma_bf16(sc[0], qa[kk], b[0], b[1]);
      mma_bf16(sc[1], qa[kk], b[2], b[3]);
    }
    // mask, then the online softmax of rows g and g + 8
    const int r0 = r_begin + t * kMmaRows + 16 * warp + 2 * kq;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * nt + (e & 1);
        const bool vis = r < r_end && r <= (e < 2 ? vis0 : vis1);
        sc[nt][e] = vis ? sc[nt][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = __expf(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= alpha[hr];
    }
    uint32_t pa[4];  // P as the A fragment of a k16 step over the 16 keys
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = sc[nt][e] > 0.5f * kNegInf ? __expf(sc[nt][e] - m[e >> 1])
                                          : 0.f;
        l[e >> 1] += p[e];
      }
      pa[2 * nt] = pack_bf16(p[0], p[1]);
      pa[2 * nt + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int dk = 0; dk < DK; ++dk) {
      uint32_t b[4];
      ldsm_x4_t(b, vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + dk * 16 +
                       8 * (lane >> 4));
      mma_bf16(o[2 * dk], pa, b[0], b[1]);
      mma_bf16(o[2 * dk + 1], pa, b[2], b[3]);
    }
    __syncthreads();
  }
  async::wait<0>();

  // each warp's rows: l summed over the row's 4 lanes, then (m, l, o) to
  // red [warp][row][D + 2], merged across the warps in finish_split
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  float* red = reinterpret_cast<float*>(smem);  // [4][16][D + 2]
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* dst = red + (warp * 16 + g + 8 * hr) * (D + 2);
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) {
      dst[8 * j + 2 * kq] = o[j][2 * hr];
      dst[8 * j + 2 * kq + 1] = o[j][2 * hr + 1];
    }
    if (kq == 0) {
      dst[D] = m[hr];
      dst[D + 1] = l[hr];
    }
  }
  __syncthreads();
  finish_split<__nv_bfloat16, 16>(a, red, s, h, sp, rw, n_act);
}

template <int DK>
int launch_mma(Args& a, cudaStream_t st) {
  constexpr int LD = 16 * DK + 8;
  a.qmax = 16;
  const size_t ring = (size_t)2 * kMmaStages * kMmaRows * LD * 2;
  const size_t red = (size_t)4 * 16 * (16 * DK + 2) * sizeof(float);
  const size_t smem = (ring > red ? ring : red) + (size_t)16 * LD * 2 +
                      sizeof(int) * (size_t)(kSplitRows / a.Bs + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_mma_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_mma_kernel<DK>
      <<<dim3(a.n_splits, a.H, a.S), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int n_splits_of(int MB, int Bs) {
  return (MB * Bs + kSplitRows - 1) / kSplitRows;
}

}  // namespace

extern "C" {

int paged_flash_decode_split_rows() { return kSplitRows; }

// Bytes of f32 workspace for the split partials (0 when one split covers
// the whole table).
long long paged_flash_decode_workspace_bytes(int S, int Q, int H, int D,
                                             int Bs, int MB) {
  const int ns = n_splits_of(MB, Bs);
  if (ns <= 1) return 0;
  return (long long)S * H * ns * Q * (D + 2) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. workspace: at least
// paged_flash_decode_workspace_bytes(...) bytes (null when that is 0).
// counters: S * H * Q int32, all 0; the launch leaves them 0 (the last
// split of each slot and head to finish merges the splits and resets its
// counter), so a buffer serves every launch on one stream. D *
// sizeof(dtype) must be a multiple of 16 and every pointer and stride
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 =
// launched).
int paged_flash_decode(const void* q, const void* k, const void* v,
                       const void* tables, const void* lengths, void* out,
                       void* workspace, void* counters, int S, int Q, int H,
                       int D, int Bs, int MB, int N, long long k_sn,
                       long long k_sb, long long k_sh, long long v_sn,
                       long long v_sb, long long v_sh, float scale,
                       int dtype, void* stream) {
  if (S == 0 || Q == 0 || H == 0) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.part = static_cast<float*>(workspace);
  a.counters = static_cast<int*>(counters);
  a.S = S;
  a.Q = Q;
  a.H = H;
  a.D = D;
  a.Bs = Bs;
  a.MB = MB;
  a.N = N;
  a.n_splits = n_splits_of(MB, Bs);
  a.k_sn = k_sn;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.v_sn = v_sn;
  a.v_sb = v_sb;
  a.v_sh = v_sh;
  a.scale = scale;
  if (a.n_splits > 1 && (workspace == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && Q > 1 && D % 16 == 0 && D <= 128 &&
      Q <= 16) {  // several query rows: the tensor cores
    if (D == 64) return launch_mma<4>(a, st);
    if (D == 128) return launch_mma<8>(a, st);
  }
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return launch<float>(a, st);
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
