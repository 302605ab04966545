// Flash-attention backward for Hopper (sm_90a): two kernels, as in the
// Pallas version, so that no block adds into another's output (no
// atomics, sums in a fixed order, the same bits from call to call):
//  - dq:    one block per (64-row query tile, b*h), looping over key
//           tiles: p = exp(s - lse), ds = p * (g.v^T - delta),
//           dq = scale * sum ds.k. Its prologue also computes
//           delta = rowsum(o * g) (f32) for its query rows, less the lse
//           cotangent where one is given, and writes it ([B, H, S]) for
//           the dk/dv kernel, which runs after it on the same stream.
//  - dk/dv: one block per (64-row key tile, b*h), looping over query
//           tiles: dv = sum p^T.g, dk = scale * sum ds^T.q.
// p is recomputed from q, k and the forward's saved lse ([B, H, S]).
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py _flash_bwd
//   (:222): its delta (:232, XLA there), its dq pallas_call (:260, body
//   _dq_kernel :160) and its dk/dv pallas_call (:287, body _dkv_kernel
//   :188). There each grid walked its streamed tiles along a sequential
//   axis and carried dq (or dk, dv) in VMEM scratch.
//
// What bounds it on the H100 (chip_smoke.py::flash_work; bf16, 12 heads
// of 64; the whole backward, each input read once and each output
// written once): at BERT's train shape (B = 128, S = 128) the
// device-memory bytes: q, k, v, g and o read, dq, dk and dv written,
// 0.13 MB a (b, h) against 14.7 MFLOP of products (7 products of 2*D
// flops per (query, key) pair; ~112 flops a byte, under the card's
// ~295): 0.060 ms. At S = 512 (B = 32) the products: 0.091 ms at 989
// TFLOP/s. What the first, simple kernels lost to was neither:
// scalar tile loads with a full stall per streamed tile, every product
// round-tripped through f32 shared tiles, and two blocks of 4 warps per
// SM.
//
// Design, bf16 (the main path):
//  - products on mma.sync m16n8k16 with f32 accumulators in registers.
//    The dk/dv kernel computes S^T = K.Q^T and dP^T = V.dO^T with the
//    key rows as M, so the C fragments of P^T and dS^T are already the A
//    fragments of dV += P^T.dO and dK += dS^T.Q; the dq kernel computes
//    S = Q.K^T and dP = dO.V^T, and dS is the A operand of dQ += dS.K.
//    Two neighbouring n8 C tiles pack into one k16 A fragment
//    (cvt.rn.bf16x2.f32), the pairing of paged_flash_decode.cu's
//    paged_mma_kernel (tensor_core.cuh). No S, dP, P or dS tile goes
//    through shared memory. A warp owns 16 stationary rows and walks
//    each streamed tile 16 rows at a time, so only 16 score columns
//    (16 f32 registers for S and dP) are live at once.
//  - the stationary tiles (q and g for dq; k and v for dk/dv) arrive
//    once by 16-byte cp.async; at D <= 64 the warp keeps their A
//    fragments in registers, at D > 64 it reads them again from shared
//    memory (ldmatrix) per chunk, as the accumulators double there (and
//    two dk/dv blocks share a key tile, each accumulating half of D's
//    columns: 128 accumulators would not fit in 255 registers). The
//    streamed tiles (k, v and the key mask for dq; q, g, lse and delta
//    for dk/dv) go through a 2-stage cp.async ring: the next tile is in
//    flight while the current one is multiplied. B operands come from
//    shared memory by ldmatrix (.trans for the k x n row-major ones).
//    Row pitches of D + 8 bf16 keep ldmatrix free of bank conflicts.
//  - dq, dk and dv stay in registers until the epilogue, which rounds
//    them to bf16 in the warp's own stationary rows of shared memory and
//    writes 16-byte stores.
//  - 4 warps (64 stationary rows) a block at about 56 KB of shared
//    memory at D = 64: four dq blocks an SM (128 registers a thread),
//    two dk/dv blocks (230 registers: 64 accumulators, 32 of fragments,
//    the rest the compiler's). A thread's cp.async copies walk its rows
//    by one pointer, which keeps the copies of the streamed tiles from
//    holding a register per row across the loop.
//  - the constants below (warps, ring depth, the dk/dv kernel's launch
//    bound and chunk unrolling) and flash_mma.cuh's tile rows and
//    register-held fragments come from timing other values on the card
//    (PERF.md). Three dk/dv blocks an SM would read faster, but at 168
//    registers the compiler spills, so the kernel keeps two.
//  - the grid's fastest axis is the row tile, so the blocks of one (b, h)
//    run together and share its streamed tiles in L2.
//
// Semantics (both element types):
//  - strided [B, S, H, D] inputs (d-stride 1), the key mask [B, S] int32
//    read through b = bh / H, any S, D a multiple of 8 up to 128
//    (zero-padded to k16 in shared memory; rows past S and columns past D
//    land as zeros and add nothing to any product, and a query row past S
//    adds nothing to dk or dv). The bf16 kernels' cp.async copies need
//    16-byte-aligned rows; the wrapper makes a tensor that is not so
//    contiguous before the launch.
//  - ds is rounded to k's (dq) or q's (dk) dtype and p to g's dtype before
//    their products, as the Pallas kernels round them (:174, :201, :207).
//  - a hidden (masked or causal) score has ds = 0: its -1e30 does not
//    depend on q or k. A fully masked row (lse <= -5e29: every key took
//    the -1e30, so the forward's lse rounds to -1e30 exactly) took the
//    uniform softmax 1/S over all S keys, so its p is 1/S and its ds is 0
//    (dk/dv), and its dq is 0: the gradient of the plain version.
//  - causal without a key mask skips the tiles past the diagonal, as the
//    forward does.
//
// f32 (not on the main path) keeps the first, simple kernels: one block
// per 64-row tile, tiles and products through shared memory, products on
// the FMA units (flash_common.cuh, shared with the forward), never on the
// tensor cores, so no f32 operand is rounded to TF32. Its dq kernel calls
// the same delta prologue.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::pack_bf16;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;        // dO, [B, S, H, D]
  const void* o;        // the forward's output (dq kernel: delta)
  const float* lse;     // [B, H, S]
  const float* g_lse;   // [B, H, S] lse cotangent, or null (dq kernel)
  float* delta;         // [B, H, S]: written by dq, read by dk/dv
  const int* mask;      // [B, S] int32 key validity, or null
  void* out1;           // dq (dq kernel) or dk (dk/dv kernel)
  void* out2;           // dv (dk/dv kernel)
  Strides sq, sk, sv, sg, so, s1, s2;
  int S, H, D;
  float scale;
  int causal;
};

// delta = rowsum(o * g) in f32, less the lse cotangent where one is
// given, for rows [row0, row0 + ROWS) of one (b, h) slice: into
// delta_s[ROWS] (0 past S) and a.delta. THREADS / ROWS neighbouring lanes
// share a row, each summing every (THREADS / ROWS)-th 16-byte chunk, then
// meeting by xor shuffles: a fixed order. o and g rows must be 16-byte
// aligned. Every thread of the block calls it.
template <typename T, int ROWS, int THREADS>
__device__ void block_delta(const BwdArgs& a, int bh, int b, int h, int row0,
                            float* delta_s) {
  constexpr int TPR = THREADS / ROWS, VEC = 16 / sizeof(T);
  static_assert(TPR * ROWS == THREADS && TPR <= 32 && (TPR & (TPR - 1)) == 0,
                "rows must split the block into power-of-2 lane groups");
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int row = row0 + r;
  float sum = 0.f;
  if (row < a.S) {
    const T* o = static_cast<const T*>(a.o) + b * a.so.b + h * a.so.h +
                 (long long)row * a.so.s;
    const T* g = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h +
                 (long long)row * a.sg.s;
    for (int c = part * VEC; c < a.D; c += TPR * VEC) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        sum = fmaf(to_f32(oe[i]), to_f32(ge[i]), sum);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) {
    float d = 0.f;
    if (row < a.S) {
      const long long i = (long long)bh * a.S + row;
      d = a.g_lse ? sum - a.g_lse[i] : sum;
      a.delta[i] = d;
    }
    delta_s[r] = d;
  }
}

// -- bf16: mma.sync with register accumulators -------------------------------

constexpr int kWarps = 4;                  // 16 stationary rows each
constexpr int kBlockRows = 16 * kWarps;    // stationary rows a block
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kStages = 2;                 // cp.async ring depth
constexpr int kDkvMinBlocks = 2;  // dk/dv blocks an SM holds, at least
constexpr int kDkvUnroll = 4;     // dk/dv chunks unrolled together

// bf16 elements of a block's stationary [kBlockRows][kLd] tile
template <int DK>
__host__ __device__ constexpr int block_elems() {
  return kBlockRows * Geo<DK>::kLd;
}

template <int DK>
constexpr size_t dq_mma_smem() {
  return (2 * block_elems<DK>() + 2 * kStages * Geo<DK>::kTileElems) *
             sizeof(bf16) +
         kStages * kTile * sizeof(int) + kBlockRows * sizeof(float);
}

template <int DK>
constexpr size_t dkv_mma_smem() {
  return (2 * block_elems<DK>() + 2 * kStages * Geo<DK>::kTileElems) *
             sizeof(bf16) +
         2 * kStages * kTile * sizeof(float);
}

// grid (ceil(S / 64), B * H). Dynamic shared memory: q, g [64][LD]; the
// k and v rings [kStages][64][LD]; the mask ring [kStages][64] int32;
// delta [64] f32.
template <int DK>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(BwdArgs a) {
  using G = Geo<DK>;
  constexpr int LD = G::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + block_elems<DK>();
  bf16* kring = gs + block_elems<DK>();
  bf16* vring = kring + kStages * G::kTileElems;
  int* mring = reinterpret_cast<int*>(vring + kStages * G::kTileElems);
  float* delta_s = reinterpret_cast<float*>(mring + kStages * kTile);

  const int S = a.S, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBlockRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kq = lane & 3, g = lane >> 2;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.sg.b + h * a.sg.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* mb = a.mask ? a.mask + (long long)b * S : nullptr;
  const int k_end = (a.causal && !mb) ? min(S, q0 + kBlockRows) : S;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  auto load_tile = [&](int t) {
    const int st = t % kStages, k0 = t * kTile;
    copy_rows<DK, kTile, kMmaThreads>(kring + st * G::kTileElems, kb,
                                      a.sk.s, k0, S, a.D);
    copy_rows<DK, kTile, kMmaThreads>(vring + st * G::kTileElems, vb,
                                      a.sv.s, k0, S, a.D);
    if (mb) copy_vec<kMmaThreads>(mring + st * kTile, mb, k0, S);
  };
  copy_rows<DK, kBlockRows, kMmaThreads>(qs, qb, a.sq.s, q0, S, a.D);
  copy_rows<DK, kBlockRows, kMmaThreads>(gs, gb, a.sg.s, q0, S, a.D);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    async::commit();
  }
  // delta from o and g while the first tiles are in flight
  block_delta<bf16, kBlockRows, kMmaThreads>(a, bh, b, h, q0, delta_s);
  __syncthreads();

  // this lane's query rows: g and g + 8 of the warp's 16
  int qi[2];
  float lse[2], dl[2];
  bool on[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + 16 * warp + g + 8 * hr;
    const bool live = qi[hr] < S;
    lse[hr] = live ? a.lse[(long long)bh * S + qi[hr]] : 0.f;
    dl[hr] = delta_s[16 * warp + g + 8 * hr];
    // a fully masked row has ds = 0 everywhere, so dq = 0
    on[hr] = live && lse[hr] > kFullyMasked;
  }
  AFrags<DK, G::kRegA> qa, ga;
  float acc[2 * DK][4];
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    async::commit();
    async::wait<kStages - 1>();
    __syncthreads();
    if (t == 0) {
      qa.init(qs + 16 * warp * LD);
      ga.init(gs + 16 * warp * LD);
    }
    const int st = t % kStages, k0 = t * kTile;
    const bf16* kt = kring + st * G::kTileElems;
    const bf16* vt = vring + st * G::kTileElems;
    const int* mt = mring + st * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {  // keys k0 + 16j ..
      float s[2][4] = {}, dp[2][4] = {};
      const bf16* kr = b_rows<LD>(kt, 16 * j);
      const bf16* vr = b_rows<LD>(vt, 16 * j);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t tmp[4], b4[4];
        const uint32_t* af = qa.get(kk, tmp);
        ldsm_x4(b4, kr + kk * 16);
        mma_bf16(s[0], af, b4[0], b4[1]);
        mma_bf16(s[1], af, b4[2], b4[3]);
        af = ga.get(kk, tmp);
        ldsm_x4(b4, vr + kk * 16);
        mma_bf16(dp[0], af, b4[0], b4[1]);
        mma_bf16(dp[1], af, b4[2], b4[3]);
      }
      // ds, rounded to k's dtype as the A fragment of dq += ds . k
      float ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = 16 * j + 8 * nt + 2 * kq;
        const int2 mv = mb ? *reinterpret_cast<const int2*>(mt + c)
                           : make_int2(1, 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, kj = k0 + c + (e & 1);
          const bool vis = on[hr] && kj < S && ((e & 1) ? mv.y : mv.x) &&
                           !(a.causal && kj > qi[hr]);
          const float p = __expf(s[nt][e] * a.scale - lse[hr]);
          ds[nt][e] = vis ? p * (dp[nt][e] - dl[hr]) : 0.f;
        }
      }
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]),
                              pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]),
                              pack_bf16(ds[1][2], ds[1][3])};
      const bf16* kr_t = bt_rows<LD>(kt, 16 * j);
#pragma unroll
      for (int dk = 0; dk < DK; ++dk) {
        uint32_t b4[4];
        ldsm_x4_t(b4, kr_t + dk * 16);
        mma_bf16(acc[2 * dk], da, b4[0], b4[1]);
        mma_bf16(acc[2 * dk + 1], da, b4[2], b4[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  async::wait<0>();

  bf16* out = static_cast<bf16*>(a.out1) + b * a.s1.b + h * a.s1.h;
  store_rows<LD, DK>(acc, a.scale, qs + 16 * warp * LD, out, a.s1.s,
                 q0 + 16 * warp, S, a.D);
}

// Column halves of dk and dv a dk/dv block accumulates: at D > 64 two
// blocks share a key tile, each computing all of s^T and dp^T but
// accumulating half of D's columns, as 128 accumulators (and the chunk's
// operands) would not fit in 255 registers.
template <int DK>
__host__ __device__ constexpr int dkv_halves() {
  return DK > 4 ? 2 : 1;
}

// grid (ceil(S / 64), B * H, dkv_halves). Dynamic shared memory: k, v
// [64][LD]; the q and g rings [kStages][64][LD]; the lse and delta rings
// [kStages][64] f32.
template <int DK>
__global__ void __launch_bounds__(kMmaThreads, kDkvMinBlocks)
    flash_dkv_mma_kernel(BwdArgs a) {
  using G = Geo<DK>;
  constexpr int LD = G::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + block_elems<DK>();
  bf16* qring = vs + block_elems<DK>();
  bf16* gring = qring + kStages * G::kTileElems;
  float* lring = reinterpret_cast<float*>(gring + kStages * G::kTileElems);
  float* dring = lring + kStages * kTile;

  const int S = a.S, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBlockRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kq = lane & 3, g = lane >> 2;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.sg.b + h * a.sg.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* lb = a.lse + (long long)bh * S;
  const float* db = a.delta + (long long)bh * S;
  const int* mb = a.mask ? a.mask + (long long)b * S : nullptr;
  // causal without a key mask: queries before k0 see none of these keys
  const int q_begin = (a.causal && !mb) ? k0 : 0;
  const int n_tiles = (S - q_begin + kTile - 1) / kTile;
  const float inv_s = 1.f / (float)S;

  auto load_tile = [&](int t) {
    const int st = t % kStages, q0 = q_begin + t * kTile;
    copy_rows<DK, kTile, kMmaThreads>(qring + st * G::kTileElems, qb,
                                      a.sq.s, q0, S, a.D);
    copy_rows<DK, kTile, kMmaThreads>(gring + st * G::kTileElems, gb,
                                      a.sg.s, q0, S, a.D);
    copy_vec<kMmaThreads>(lring + st * kTile, lb, q0, S);
    copy_vec<kMmaThreads>(dring + st * kTile, db, q0, S);
  };
  copy_rows<DK, kBlockRows, kMmaThreads>(ks, kb, a.sk.s, k0, S, a.D);
  copy_rows<DK, kBlockRows, kMmaThreads>(vs, vb, a.sv.s, k0, S, a.D);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    async::commit();
  }

  // this lane's key rows: g and g + 8 of the warp's 16
  int kj[2];
  bool key_on[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kj[hr] = k0 + 16 * warp + g + 8 * hr;
    key_on[hr] = kj[hr] < S && (!mb || mb[kj[hr]] != 0);
  }
  AFrags<DK, G::kRegA> ka, va;
  // this block's columns of dk and dv: d0 .. d0 + 16 DN - 1
  constexpr int DN = DK / dkv_halves<DK>();
  const int d0 = blockIdx.z * 16 * DN;
  float dk_acc[2 * DN][4], dv_acc[2 * DN][4];
#pragma unroll
  for (int j = 0; j < 2 * DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    async::commit();
    async::wait<kStages - 1>();
    __syncthreads();
    if (t == 0) {
      ka.init(ks + 16 * warp * LD);
      va.init(vs + 16 * warp * LD);
    }
    const int st = t % kStages, q0 = q_begin + t * kTile;
    const bf16* qt = qring + st * G::kTileElems;
    const bf16* gt = gring + st * G::kTileElems;
    const float* lt = lring + st * kTile;
    const float* dt = dring + st * kTile;
    // queries q0 + 16j .. q0 + 16j + 15, one product at a time, so that
    // no more than 8 score values are live at once: s^T, then p^T
    // (rounded to g's dtype) as the A fragment of dv += p^T . g; then
    // dp^T, then ds^T (rounded to q's dtype) as the A fragment of
    // dk += ds^T . q. Column c of S^T is query q0 + c.
#pragma unroll kDkvUnroll
    for (int j = 0; j < kTile / 16; ++j) {
      const bf16* qr = b_rows<LD>(qt, 16 * j);
      const bf16* gr = b_rows<LD>(gt, 16 * j);
      float sc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t tmp[4], b4[4];
        const uint32_t* af = ka.get(kk, tmp);
        ldsm_x4(b4, qr + kk * 16);
        mma_bf16(sc[0], af, b4[0], b4[1]);
        mma_bf16(sc[1], af, b4[2], b4[3]);
      }
      uint32_t vis = 0;  // bit 4 nt + e: the score is visible
      uint32_t pa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = 16 * j + 8 * nt + 2 * kq;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, qi = q0 + c + (e & 1);
          const float lq = (e & 1) ? l2.y : l2.x;
          const bool live = qi < S;
          const bool masked_row = lq <= kFullyMasked;
          const bool on = live && !masked_row && key_on[hr] &&
                          !(a.causal && kj[hr] > qi);
          vis |= (uint32_t)on << (4 * nt + e);
          // the score itself, for ds^T below
          sc[nt][e] = __expf(sc[nt][e] * a.scale - lq);
          p[e] = on ? sc[nt][e] : ((live && masked_row) ? inv_s : 0.f);
        }
        pa[2 * nt] = pack_bf16(p[0], p[1]);
        pa[2 * nt + 1] = pack_bf16(p[2], p[3]);
      }
      const bf16* gr_t = bt_rows<LD>(gt, 16 * j) + d0;
#pragma unroll
      for (int dk = 0; dk < DN; ++dk) {
        uint32_t b4[4];
        ldsm_x4_t(b4, gr_t + dk * 16);
        mma_bf16(dv_acc[2 * dk], pa, b4[0], b4[1]);
        mma_bf16(dv_acc[2 * dk + 1], pa, b4[2], b4[3]);
      }
      float dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t tmp[4], b4[4];
        const uint32_t* af = va.get(kk, tmp);
        ldsm_x4(b4, gr + kk * 16);
        mma_bf16(dp[0], af, b4[0], b4[1]);
        mma_bf16(dp[1], af, b4[2], b4[3]);
      }
      uint32_t da[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = 16 * j + 8 * nt + 2 * kq;
        const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = (vis >> (4 * nt + e)) & 1
                      ? sc[nt][e] * (dp[nt][e] - ((e & 1) ? d2.y : d2.x))
                      : 0.f;
        da[2 * nt] = pack_bf16(ds[0], ds[1]);
        da[2 * nt + 1] = pack_bf16(ds[2], ds[3]);
      }
      const bf16* qr_t = bt_rows<LD>(qt, 16 * j) + d0;
#pragma unroll
      for (int dk = 0; dk < DN; ++dk) {
        uint32_t b4[4];
        ldsm_x4_t(b4, qr_t + dk * 16);
        mma_bf16(dk_acc[2 * dk], da, b4[0], b4[1]);
        mma_bf16(dk_acc[2 * dk + 1], da, b4[2], b4[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  async::wait<0>();

  bf16* dk = static_cast<bf16*>(a.out1) + b * a.s1.b + h * a.s1.h;
  bf16* dv = static_cast<bf16*>(a.out2) + b * a.s2.b + h * a.s2.h;
  store_rows<LD, DN>(dk_acc, a.scale, ks + 16 * warp * LD + d0, dk + d0,
                     a.s1.s, k0 + 16 * warp, S, a.D - d0);
  store_rows<LD, DN>(dv_acc, 1.f, vs + 16 * warp * LD + d0, dv + d0,
                     a.s2.s, k0 + 16 * warp, S, a.D - d0);
}

// -- f32: FMA kernels --------------------------------------------------------

size_t dq_smem_f32(int D) {
  return 5 * tile_bytes(D) + 2 * score_bytes() +
         round128(kRows * sizeof(float));
}

size_t dkv_smem_f32(int D) {
  return 6 * tile_bytes(D) + 2 * score_bytes() +
         round128(2 * kRows * sizeof(float));
}

__global__ void __launch_bounds__(kThreads) flash_dq_f32_kernel(BwdArgs a) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, D = a.D;
  const int ldt = ld_f32(D), ldf = ldt;
  constexpr int lds = kLdScore, ldp = kLdScore;
  const size_t tb = tile_bytes(D), sb = score_bytes(), ab = tb;
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + tb);
  T* ks = reinterpret_cast<T*>(smem + 2 * tb);
  T* vs = reinterpret_cast<T*>(smem + 3 * tb);
  float* ss = reinterpret_cast<float*>(smem + 4 * tb);
  float* dps = reinterpret_cast<float*>(smem + 4 * tb + sb);
  float* acc = reinterpret_cast<float*>(smem + 4 * tb + 2 * sb);
  float* delta_s = reinterpret_cast<float*>(smem + 4 * tb + 2 * sb + ab);

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + r;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* gb = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* mb = a.mask ? a.mask + (long long)b * S : nullptr;

  load_tile(qs, ldt, qb, a.sq.s, q0, S, D);
  load_tile(gs, ldt, gb, a.sg.s, q0, S, D);
  for (int i = threadIdx.x; i < kRows * ldf; i += kThreads) acc[i] = 0.f;
  block_delta<T, kRows, kThreads>(a, bh, b, h, q0, delta_s);
  const bool live = qi < S;
  const float lse = live ? a.lse[(long long)bh * S + qi] : 0.f;
  // a fully masked row has ds = 0 everywhere, so dq = 0
  const bool row_on = live && lse > kFullyMasked;

  float* sw = ss + warp * 16 * lds;
  float* dpw = dps + warp * 16 * lds;
  T* dsw = reinterpret_cast<T*>(sw);
  float* accw = acc + warp * 16 * ldf;
  const int k_end = (a.causal && !mb) ? min(S, q0 + kRows) : S;
  __syncthreads();
  const float delta = delta_s[warp * 16 + r];

  for (int k0 = 0; k0 < k_end; k0 += kRows) {
    load_tile(ks, ldt, kb, a.sk.s, k0, S, D);
    load_tile(vs, ldt, vb, a.sv.s, k0, S, D);
    __syncthreads();
    warp_abT(qs + warp * 16 * ldt, ldt, ks, ldt, sw, lds, D);
    warp_abT(gs + warp * 16 * ldt, ldt, vs, ldt, dpw, lds, D);
    __syncwarp();
    float dsv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j, kj = k0 + c;
      float ds = 0.f;
      if (row_on && kj < S && !hidden(mb, a.causal, qi, kj)) {
        const float p = __expf(sw[r * lds + c] * a.scale - lse);
        ds = p * (dpw[r * lds + c] - delta);
      }
      dsv[j] = ds;
    }
    __syncwarp();  // every score is read before ds overwrites the rows
#pragma unroll
    for (int j = 0; j < 32; ++j) dsw[r * ldp + half * 32 + j] = dsv[j];
    __syncwarp();
    warp_pv(dsw, ldp, ks, ldt, accw, ldf, D);
    __syncthreads();
  }

  if (live) {
    T* row = static_cast<T*>(a.out1) + b * a.s1.b + h * a.s1.h +
             (long long)qi * a.s1.s;
    for (int d = half; d < D; d += 2) row[d] = accw[r * ldf + d] * a.scale;
  }
}

__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(BwdArgs a) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, D = a.D;
  const int ldt = ld_f32(D), ldf = ldt;
  constexpr int lds = kLdScore, ldp = kLdScore;
  const size_t tb = tile_bytes(D), sb = score_bytes(), ab = tb;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + tb);
  T* qs = reinterpret_cast<T*>(smem + 2 * tb);
  T* gs = reinterpret_cast<T*>(smem + 3 * tb);
  float* ss = reinterpret_cast<float*>(smem + 4 * tb);
  float* dps = reinterpret_cast<float*>(smem + 4 * tb + sb);
  float* dk_acc = reinterpret_cast<float*>(smem + 4 * tb + 2 * sb);
  float* dv_acc = reinterpret_cast<float*>(smem + 4 * tb + 2 * sb + ab);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * tb + 2 * sb + 2 * ab);
  float* delta_s = lse_s + kRows;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;
  const int kj = k0 + warp * 16 + r;  // this lane pair's key row
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* gb = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* mb = a.mask ? a.mask + (long long)b * S : nullptr;
  const float inv_s = 1.f / (float)S;

  load_tile(ks, ldt, kb, a.sk.s, k0, S, D);
  load_tile(vs, ldt, vb, a.sv.s, k0, S, D);
  for (int i = threadIdx.x; i < kRows * ldf; i += kThreads)
    dk_acc[i] = dv_acc[i] = 0.f;

  float* sw = ss + warp * 16 * lds;    // s^T rows: this warp's keys
  float* dpw = dps + warp * 16 * lds;  // dp^T rows
  T* pw = reinterpret_cast<T*>(sw);
  T* dsw = reinterpret_cast<T*>(dpw);
  float* dkw = dk_acc + warp * 16 * ldf;
  float* dvw = dv_acc + warp * 16 * ldf;
  // causal without a key mask: queries before k0 see none of these keys
  const int q_begin = (a.causal && !mb) ? k0 : 0;

  for (int q0 = q_begin; q0 < S; q0 += kRows) {
    __syncthreads();  // the previous tile's products are done
    load_tile(qs, ldt, qb, a.sq.s, q0, S, D);
    load_tile(gs, ldt, gb, a.sg.s, q0, S, D);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const bool in = q0 + i < S;
      lse_s[i] = in ? a.lse[(long long)bh * S + q0 + i] : 0.f;
      delta_s[i] = in ? a.delta[(long long)bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
    warp_abT(ks + warp * 16 * ldt, ldt, qs, ldt, sw, lds, D);
    warp_abT(vs + warp * 16 * ldt, ldt, gs, ldt, dpw, lds, D);
    __syncwarp();
    float pv[32], dsv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j, qi = q0 + c;
      float p = 0.f, ds = 0.f;
      if (kj < S && qi < S) {
        const float lq = lse_s[c];
        if (lq <= kFullyMasked) {
          p = inv_s;
        } else if (!hidden(mb, a.causal, qi, kj)) {
          p = __expf(sw[r * lds + c] * a.scale - lq);
          ds = p * (dpw[r * lds + c] - delta_s[c]);
        }
      }
      pv[j] = p;
      dsv[j] = ds;
    }
    __syncwarp();  // every score is read before p and ds overwrite them
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      pw[r * ldp + half * 32 + j] = pv[j];
      dsw[r * ldp + half * 32 + j] = dsv[j];
    }
    __syncwarp();
    warp_pv(pw, ldp, gs, ldt, dvw, ldf, D);
    warp_pv(dsw, ldp, qs, ldt, dkw, ldf, D);
  }
  __syncthreads();

  if (kj < S) {
    T* dk = static_cast<T*>(a.out1) + b * a.s1.b + h * a.s1.h +
            (long long)kj * a.s1.s;
    T* dv = static_cast<T*>(a.out2) + b * a.s2.b + h * a.s2.h +
            (long long)kj * a.s2.s;
    for (int d = half; d < D; d += 2) {
      dk[d] = dkw[r * ldf + d] * a.scale;
      dv[d] = dvw[r * ldf + d];
    }
  }
}

// -- launches ------------------------------------------------------------

BwdArgs make_args(const void* q, const void* k, const void* v, const void* g,
                  const void* o, const void* lse, const void* g_lse,
                  void* delta, const void* mask, void* out1, void* out2,
                  int S, int H, int D, const long long* strides, float scale,
                  int causal) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.o = o;
  a.lse = static_cast<const float*>(lse);
  a.g_lse = static_cast<const float*>(g_lse);
  a.delta = static_cast<float*>(delta);
  a.mask = static_cast<const int*>(mask);
  a.out1 = out1;
  a.out2 = out2;
  Strides* st[7] = {&a.sq, &a.sk, &a.sv, &a.sg, &a.so, &a.s1, &a.s2};
  for (int i = 0; i < 7; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  return a;
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, size_t smem, const BwdArgs& a,
           cudaStream_t stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_bf16(bool dq, const BwdArgs& a, int B, cudaStream_t stream) {
  const int tiles = (a.S + kBlockRows - 1) / kBlockRows;
  return dq ? launch(flash_dq_mma_kernel<DK>, dim3(tiles, B * a.H),
                     kMmaThreads, dq_mma_smem<DK>(), a, stream)
            : launch(flash_dkv_mma_kernel<DK>,
                     dim3(tiles, B * a.H, dkv_halves<DK>()), kMmaThreads,
                     dkv_mma_smem<DK>(), a, stream);
}

int launch_bwd(bool dq, const BwdArgs& a, int B, int dtype,
               cudaStream_t stream) {
  if (dtype == 1) {
    const int dk = (a.D + 15) / 16;
    return dk <= 1   ? launch_bf16<1>(dq, a, B, stream)
           : dk <= 2 ? launch_bf16<2>(dq, a, B, stream)
           : dk <= 4 ? launch_bf16<4>(dq, a, B, stream)
                     : launch_bf16<8>(dq, a, B, stream);
  }
  const dim3 grid(B * a.H, (a.S + kRows - 1) / kRows);
  return dq ? launch(flash_dq_f32_kernel, grid, kThreads,
                     dq_smem_f32(a.D), a, stream)
            : launch(flash_dkv_f32_kernel, grid, kThreads,
                     dkv_smem_f32(a.D), a, stream);
}

}  // namespace

extern "C" {

// dq, and delta = rowsum(o * g) - g_lse ([B, H, S] f32; g_lse may be
// null) for the dk/dv kernel. strides: 21 element strides, (b, s, h) of
// q, k, v, g, o, dq and an unused triple. q, k, v, g and o rows must be
// 16-byte aligned. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* g, const void* o, const void* lse,
                           const void* g_lse, const void* mask, void* delta,
                           void* dq, int B, int S, int H, int D,
                           const long long* strides, float scale,
                           int causal, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a = make_args(q, k, v, g, o, lse, g_lse, delta, mask, dq,
                              nullptr, S, H, D, strides, scale, causal);
  return launch_bwd(true, a, B, dtype, static_cast<cudaStream_t>(stream));
}

// dk and dv from the delta the dq kernel wrote. strides: 21 element
// strides, (b, s, h) of q, k, v, g, an unused triple, dk and dv.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* g, const void* lse,
                            const void* delta, const void* mask, void* dk,
                            void* dv, int B, int S, int H, int D,
                            const long long* strides, float scale,
                            int causal, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a =
      make_args(q, k, v, g, nullptr, lse, nullptr, const_cast<void*>(delta),
                mask, dk, dv, S, H, D, strides, scale, causal);
  return launch_bwd(false, a, B, dtype, static_cast<cudaStream_t>(stream));
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
