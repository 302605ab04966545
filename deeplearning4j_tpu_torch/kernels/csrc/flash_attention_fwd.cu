// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over [B, S, H, D] q/k/v, writing o (input dtype) and the row
// log-sum-exp lse = m + log(l) ([B, H, S], f32) that the backward
// kernels recompute the probabilities from.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py _flash_fwd
//   (:103; its pallas_call at :120, body _fwd_kernel :57-94). There the
//   grid (BH, nQ, nK) walked the key tiles along a sequential axis on one
//   TensorCore and carried m, l and the accumulator in VMEM scratch from
//   one grid step to the next; here a loop inside the block walks them.
//
// What bounds it on the H100 (chip_smoke.py::flash_work; bf16, 12 heads
// of 64): at BERT's shape (S = 128) the device-memory bytes: q, k, v read
// and o written once, about 100 MB at B = 128, 0.030 ms at 3.35 TB/s,
// against two products of 2 * D flops per (query, key) pair, ~64 flops a
// byte, under the ~295 the card needs before its tensor cores are the
// limit. The flops grow with S and the bytes do not: at S = 512 (B = 32)
// the two are about even (0.026 ms of products at 989 TFLOP/s), and past
// it the products bound it. What the first, simple kernel lost to was
// neither: scalar tile loads behind a full stall per key tile, and both
// products, the softmax and the rescale going through f32 shared tiles.
//
// Design, bf16 (the main path), after the backward's dq kernel, which has
// the same shape (stationary Q, streamed K and V):
//  - both products on mma.sync m16n8k16 (tensor_core.cuh) with the scores
//    S and the accumulator O in f32 registers. A warp owns 16 query rows
//    and takes a 64-key tile at once: 32 score values a lane, one online-
//    softmax update a tile.
//  - q arrives once by 16-byte cp.async and its A fragments are read again
//    by ldmatrix at each use: held in registers they push the kernel past
//    the 128 a thread that four blocks an SM allow. K, V and the key mask
//    stream through a cp.async ring of kStages tiles: the next tile is in
//    flight while the current one is multiplied. B fragments come by
//    ldmatrix (.trans for V); D + 8 row pitches (flash_mma.cuh).
//  - the online softmax runs on the C fragments: a row's max meets over
//    its quad by two __shfl_xor_sync, alpha rescales the O fragments in
//    registers, and each lane sums its own share of l, which the quad adds
//    up once at the end. Two neighbouring n8 P tiles pack into one k16 A
//    fragment of P.V (cvt.rn.bf16x2.f32, the backward's pairing). No S, P
//    or O tile goes through shared memory.
//  - at S = 512 the softmax's instructions, not the products, set the
//    pace, so a tile that every row of the warp sees whole (inside S, no
//    hidden key, not past a row's diagonal; one warp vote over the mask)
//    skips the masking: its row max is taken on the raw scores and scaled
//    once, and each p costs one FMA and one ex2.
//  - the epilogue divides by l, rounds to bf16 in the warp's own q rows of
//    shared memory and writes 16-byte stores; lane 0 of each quad writes
//    the lse of its two rows.
//  - one block of kWarps warps per (64-row query tile, b*h) on a 1-D grid,
//    the query tile the fastest index, so the blocks of one (b, h) run
//    together and share its K and V in L2. Causal without a key mask
//    stops at the diagonal, so there the longest query tiles go first and
//    b*h is the fastest index: the short tiles fill the last wave.
//    kWarps, kStages, the fragments read from shared memory and the order
//    come from timing other choices on the card (PERF.md).
//  - no atomics: every output has one writer, and sums run in a fixed
//    order, so two calls give the same bits.
//
// Semantics (both element types), those of the Pallas kernel:
//  - strided [B, S, H, D] inputs (d-stride 1), so no moveaxis copy is
//    made; the key mask [B, S] int32 is read through b = bh / H instead of
//    being repeated per head. Any S, D a multiple of 8 up to 128. The bf16
//    kernel's copies need 16-byte-aligned rows (the wrapper's _aligned).
//  - keys past S take p = 0 and count neither in the row max nor in l;
//    query rows past S are not written. Nothing is padded to 128 (a TPU
//    tiling fact), so a fully masked row averages V over S keys, as the
//    plain version does.
//  - masked scores take the finite -1e30 of the Pallas kernel (not -inf):
//    a tile of masked keys gives p = exp(0) = 1 until a later visible tile
//    resets it through alpha = exp(-1e30 - m) = 0, and a fully masked row
//    comes out as a uniform softmax whose lse rounds to -1e30 (the
//    backward's kFullyMasked test). l is clamped at 1e-30.
//  - the scale multiplies the f32 scores; p is rounded to v's dtype before
//    the value product, as the Pallas kernel does (jnp.dot(p.astype(
//    v.dtype), v)); l sums the f32 p.
//  - causal without a key mask stops at the diagonal tile (and a warp
//    skips a tile wholly after its rows): every later key is hidden from
//    every row and would add exactly 0. With a key mask all tiles are
//    walked, so a fully masked row still averages over all S keys.
//
// f32 (not on the main path) keeps the first, simple kernel: tiles and
// products through shared memory on the FMA units (flash_common.cuh,
// shared with the backward), never on the tensor cores, so no f32 operand
// is rounded to TF32.
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::pack_bf16;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // [B, S] int32 key validity, or null
  void* o;          // [B, S, H, D] (strides so)
  float* lse;       // [B, H, S]
  Strides sq, sk, sv, so;
  int S, H, D;
  float scale;
  int causal;
};

// -- bf16: mma.sync with register accumulators -------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (-inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kWarps = 4;             // 16 query rows each
constexpr int kRowsQ = 16 * kWarps;   // query rows a block
constexpr int kThreadsQ = 32 * kWarps;
constexpr int kStages = 2;            // cp.async ring depth

template <int DK>
constexpr size_t fwd_mma_smem() {
  return (kRowsQ * Geo<DK>::kLd + 2 * kStages * Geo<DK>::kTileElems) *
             sizeof(bf16) +
         kStages * kTile * sizeof(int);
}

// grid (ceil(S / kRowsQ) * B * H). Dynamic shared memory: q
// [kRowsQ][LD]; the k and v rings [kStages][64][LD]; the mask ring
// [kStages][64] int32. An SM holds four blocks at D <= 64 (128 registers
// a thread), two at D = 128, where shared memory holds no more.
template <int DK>
__global__ void __launch_bounds__(kThreadsQ, DK > 4 ? 2 : 4)
    flash_fwd_mma_kernel(FwdArgs a) {
  using G = Geo<DK>;
  constexpr int LD = G::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kring = qs + kRowsQ * LD;
  bf16* vring = kring + kStages * G::kTileElems;
  int* mring = reinterpret_cast<int*>(vring + kStages * G::kTileElems);

  // causal without a key mask stops at the diagonal tile, so a query
  // tile's work grows with its index: the longest tiles go first, b*h the
  // fastest index. Else the query tile is the fastest.
  const bool diag_stop = a.causal && !a.mask;
  const int S = a.S, n_qt = (S + kRowsQ - 1) / kRowsQ;
  const int n_bh = gridDim.x / n_qt;
  const int qt = diag_stop ? n_qt - 1 - (int)blockIdx.x / n_bh
                           : (int)blockIdx.x % n_qt;
  const int bh = diag_stop ? (int)blockIdx.x % n_bh : (int)blockIdx.x / n_qt;
  const int b = bh / a.H, h = bh % a.H, q0 = qt * kRowsQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kq = lane & 3, g = lane >> 2;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* mb = a.mask ? a.mask + (long long)b * S : nullptr;
  const int k_end = diag_stop ? min(S, q0 + kRowsQ) : S;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int warp_last = q0 + 16 * warp + 15;  // the warp's last query row

  auto load_tile = [&](int t) {
    const int st = t % kStages, k0 = t * kTile;
    copy_rows<DK, kTile, kThreadsQ>(kring + st * G::kTileElems, kb, a.sk.s,
                                    k0, S, a.D);
    copy_rows<DK, kTile, kThreadsQ>(vring + st * G::kTileElems, vb, a.sv.s,
                                    k0, S, a.D);
    if (mb) copy_vec<kThreadsQ>(mring + st * kTile, mb, k0, S);
  };
  copy_rows<DK, kRowsQ, kThreadsQ>(qs, qb, a.sq.s, q0, S, a.D);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    async::commit();
  }

  // this lane's query rows: g and g + 8 of the warp's 16
  const int qi[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  // q's A fragments, read again by ldmatrix at each use: held in
  // registers they push the kernel past 128 of them (PERF.md)
  AFrags<DK, false> qa;
  float o[2 * DK][4];
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // the running max of rows g, g + 8, and this lane's share of their sums
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    async::commit();
    async::wait<kStages - 1>();
    __syncthreads();
    if (t == 0) qa.init(qs + 16 * warp * LD);
    const int k0 = t * kTile;
    // causal without a mask: keys wholly after the warp's rows add 0
    if (!(diag_stop && k0 > warp_last)) {
      const int st = t % kStages;
      const bf16* kt = kring + st * G::kTileElems;
      const bf16* vt = vring + st * G::kTileElems;
      const int* mt = mring + st * kTile;
      // S = Q.K^T over the tile's 64 keys: n8 tile nt holds keys 8nt..
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        const bf16* kr = b_rows<LD>(kt, 16 * j);
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          uint32_t tmp[4], b4[4];
          const uint32_t* af = qa.get(kk, tmp);
          ldsm_x4(b4, kr + kk * 16);
          mma_bf16(s[2 * j], af, b4[0], b4[1]);
          mma_bf16(s[2 * j + 1], af, b4[2], b4[3]);
        }
      }
      // A tile every key of which every row of the warp sees (inside S,
      // unmasked, not past a row's diagonal) skips the masking: the max
      // of the raw scores, times the scale (> 0), is the scaled max, and
      // the exponent is one FMA. Else hidden keys take -1e30 and keys
      // past S -inf (p = 0, and they never win the max).
      bool full = a.scale > 0.f && k0 + kTile <= S &&
                  !(a.causal && k0 + kTile - 1 > q0 + 16 * warp);
      if (mb) {
        const int2 mv = *reinterpret_cast<const int2*>(mt + 2 * lane);
        full = __all_sync(0xffffffffu, full && mv.x != 0 && mv.y != 0);
      }
      float mx[2] = {kNegInf, kNegInf};
      if (full) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = 8 * nt + 2 * kq;
          const int2 mv = mb ? *reinterpret_cast<const int2*>(mt + c)
                             : make_int2(1, 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, kj = k0 + c + (e & 1);
            const bool vis = ((e & 1) ? mv.y : mv.x) != 0 &&
                             !(a.causal && kj > qi[hr]);
            const float x = vis ? s[nt][e] * a.scale : kNegInf;
            s[nt][e] = kj < S ? x : -INFINITY;
            mx[hr] = fmaxf(mx[hr], s[nt][e]);
          }
        }
      }
      float alpha[2], m2[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        if (full) mx[hr] *= a.scale;
        const float m_new = fmaxf(m[hr], mx[hr]);
        alpha[hr] = __expf(m[hr] - m_new);
        m[hr] = m_new;
        m2[hr] = m_new * kLog2e;
        l[hr] *= alpha[hr];
      }
#pragma unroll
      for (int j = 0; j < 2 * DK; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // the exponents of p in base 2; on the masked path x - m first, so
      // that a hidden score under a row max of -1e30 gives exactly 0 (p =
      // 1), which the rounding of an FMA's two large terms would not
      if (full) {
        const float scale2 = a.scale * kLog2e;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = fmaf(s[nt][e], scale2, -m2[e >> 1]);
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = (s[nt][e] - m[e >> 1]) * kLog2e;
      }
      // O += P.V, 16 keys a k16 step; P rounded to bf16, l sums it in f32
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[u][e] = ex2(s[2 * kk + u][e]);
            l[e >> 1] += p[u][e];
          }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                                pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]),
                                pack_bf16(p[1][2], p[1][3])};
        const bf16* vr = bt_rows<LD>(vt, 16 * kk);
#pragma unroll
        for (int dk = 0; dk < DK; ++dk) {
          uint32_t b4[4];
          ldsm_x4_t(b4, vr + dk * 16);
          mma_bf16(o[2 * dk], pa, b4[0], b4[1]);
          mma_bf16(o[2 * dk + 1], pa, b4[2], b4[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  async::wait<0>();

  float ll[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    ll[hr] = fmaxf(l[hr], 1e-30f);
    const float inv = 1.f / ll[hr];
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j) {
      o[j][2 * hr] *= inv;
      o[j][2 * hr + 1] *= inv;
    }
  }
  bf16* out = static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h;
  store_rows<LD, DK>(o, 1.f, qs + 16 * warp * LD, out, a.so.s,
                     q0 + 16 * warp, S, a.D);
  if (kq == 0) {
    for (int hr = 0; hr < 2; ++hr)
      if (qi[hr] < S)
        a.lse[(long long)bh * S + qi[hr]] = m[hr] + logf(ll[hr]);
  }
}

template <int DK>
int launch_bf16(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = fwd_mma_smem<DK>();
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<DK>, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)((a.S + kRowsQ - 1) / kRowsQ) * B * a.H;
  flash_fwd_mma_kernel<DK><<<(unsigned)blocks, kThreadsQ, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// -- f32: the FMA kernel -----------------------------------------------------

size_t fwd_smem_f32(int D) {
  return 4 * tile_bytes(D) + score_bytes();  // q, k, v, acc; scores
}

__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, D = a.D;
  const int ldt = ld_f32(D), ldf = ldt;
  constexpr int lds = kLdScore, ldp = kLdScore;
  const size_t tb = tile_bytes(D);
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + tb);
  float* vs = reinterpret_cast<float*>(smem + 2 * tb);
  float* ss = reinterpret_cast<float*>(smem + 3 * tb);
  float* acc = reinterpret_cast<float*>(smem + 3 * tb + score_bytes());

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + r;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* mb = a.mask ? a.mask + (long long)b * S : nullptr;

  load_tile(qs, ldt, qb, a.sq.s, q0, S, D);
  for (int i = threadIdx.x; i < kRows * ldf; i += kThreads) acc[i] = 0.f;

  float* sw = ss + warp * 16 * lds;    // this warp's 16 score rows
  float* pw = sw;                      // ... reused for its p rows
  float* accw = acc + warp * 16 * ldf;
  float m = kNegInf, l = 0.f;          // this lane pair's row
  const int k_end = (a.causal && !mb) ? min(S, q0 + kRows) : S;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kRows) {
    load_tile(ks, ldt, kb, a.sk.s, k0, S, D);
    load_tile(vs, ldt, vb, a.sv.s, k0, S, D);
    __syncthreads();
    warp_abT(qs + warp * 16 * ldt, ldt, ks, ldt, sw, lds, D);
    __syncwarp();
    float sv[32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j, kj = k0 + c;
      float s = sw[r * lds + c] * a.scale;
      if (kj < S && hidden(mb, a.causal, qi, kj)) s = kNegInf;
      sv[j] = s;
      if (kj < S) mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    __syncwarp();  // every score is read before p overwrites the rows
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const float p = (k0 + c < S) ? __expf(sv[j] - m_new) : 0.f;
      sum += p;
      pw[r * ldp + c] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = __expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    for (int d = half; d < D; d += 2) accw[r * ldf + d] *= alpha;
    __syncwarp();
    warp_pv(pw, ldp, vs, ldt, accw, ldf, D);
    __syncthreads();  // the next tile load overwrites ks and vs
  }

  if (qi < S) {
    const float ll = fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h +
                  (long long)qi * a.so.s;
    for (int d = half; d < D; d += 2) orow[d] = accw[r * ldf + d] / ll;
    if (!half) a.lse[(long long)bh * S + qi] = m + logf(ll);
  }
}

int launch_f32(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem_f32(a.D);
  cudaError_t e = allow_smem(flash_fwd_f32_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * a.H, (a.S + kRows - 1) / kRows);
  flash_fwd_f32_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_fwd(const FwdArgs& a, int B, int dtype, cudaStream_t stream) {
  if (dtype != 1) return launch_f32(a, B, stream);
  const int dk = (a.D + 15) / 16;
  return dk <= 1   ? launch_bf16<1>(a, B, stream)
         : dk <= 2 ? launch_bf16<2>(a, B, stream)
         : dk <= 4 ? launch_bf16<4>(a, B, stream)
                   : launch_bf16<8>(a, B, stream);
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, s, h) of q, k, v and o in that order.
// mask: [B, S] int32 or null. dtype: 0 = float32, 1 = bfloat16 (q, k and
// v rows then 16-byte aligned). Returns cudaGetLastError() after the
// launch (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* mask, void* o, void* lse, int B, int S,
                        int H, int D, const long long* strides, float scale,
                        int causal, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const int*>(mask);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  Strides* st[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  return launch_fwd(a, B, dtype, static_cast<cudaStream_t>(stream));
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
