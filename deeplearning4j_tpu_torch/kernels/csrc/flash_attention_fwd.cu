// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over [B, S, H, D] q/k/v, writing o (input dtype) and the row
// log-sum-exp lse = m + log(l) ([B, H, S], f32) that the backward
// kernels recompute the probabilities from.
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py _flash_fwd
//   (Pallas body _fwd_kernel). There the grid (BH, nQ, nK) walked the key
//   tiles along a sequential axis on one TensorCore and carried m, l and
//   the accumulator in VMEM scratch from one grid step to the next.
//
// What bounds it on the H100: at BERT's shape (S = 128, D = 64) the
// device-memory bytes: q, k, v and o are read or written once (about
// 100 MB at B = 128, H = 12 in bf16) against ~64 flops per byte of the
// two products, under the ~295 flops/byte the card needs before its
// tensor cores are the limit. At long S the products take over.
//
// Design (simple first, see flash_common.cuh for the tile geometry):
//  - one block per (b*h, 64-row query tile); a loop inside the block walks
//    the 64-row key tiles, which takes the place of the TPU's sequential
//    grid axis. m and l of a row live in the two registers of the lane
//    pair that owns it; the f32 accumulator lives in shared memory.
//  - q, k, v come in with their own [B, S, H, D] strides (d-stride 1), so
//    no moveaxis copy is made, and the key mask [B, S] is read through
//    b = bh / H instead of being repeated per head.
//  - any S: keys past S take p = 0 and query rows past S are not written.
//    Nothing is padded to 128 (a TPU tiling fact); a fully masked row thus
//    averages V over S keys, as the plain version does.
//  - masked scores take the finite -1e30 of the Pallas kernel (not -inf):
//    a tile of masked keys gives p = exp(0) = 1 until a later unmasked
//    tile resets it through alpha = exp(-1e30 - m) = 0, and a fully
//    masked row comes out as a uniform softmax. l is clamped at 1e-30.
//  - p is rounded to v's dtype before the value product, as the Pallas
//    kernel does (jnp.dot(p.astype(v.dtype), v)); l sums the f32 p.
//  - causal without a key mask stops at the diagonal tile: every later
//    key is hidden from every row of the tile and adds exactly 0. With a
//    key mask all tiles are walked, so a fully masked row still averages
//    over all S keys.
//  - scalar tile loads, no cp.async/TMA pipeline, wmma instead of wgmma:
//    the fast version is later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

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

template <typename T>
size_t fwd_smem(int D) {
  return 3 * tile_bytes<T>(D) + score_bytes<T>() + acc_bytes<T>(D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, D = a.D;
  const int kd = Tr<T>::kd(D), ldt = Tr<T>::ld_t(D), ldf = Tr<T>::ld_f(D);
  constexpr int lds = Tr<T>::ld_s, ldp = Tr<T>::ld_p;
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + tile_bytes<T>(D));
  T* vs = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>(D));
  float* ss = reinterpret_cast<float*>(smem + 3 * tile_bytes<T>(D));
  float* acc = reinterpret_cast<float*>(smem + 3 * tile_bytes<T>(D) +
                                        score_bytes<T>());

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;
  const int qi = q0 + warp * 16 + r;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const int* mb = a.mask ? a.mask + (long long)b * S : nullptr;

  load_tile(qs, ldt, qb, a.sq.s, q0, S, D, kd);
  for (int i = threadIdx.x; i < kRows * ldf; i += kThreads) acc[i] = 0.f;

  float* sw = ss + warp * 16 * lds;    // this warp's 16 score rows
  T* pw = reinterpret_cast<T*>(sw);    // ... reused for its p rows
  float* accw = acc + warp * 16 * ldf;
  float m = kNegInf, l = 0.f;          // this lane pair's row
  const int k_end = (a.causal && !mb) ? min(S, q0 + kRows) : S;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kRows) {
    load_tile(ks, ldt, kb, a.sk.s, k0, S, D, kd);
    load_tile(vs, ldt, vb, a.sv.s, k0, S, D, kd);
    __syncthreads();
    warp_abT<T>(qs + warp * 16 * ldt, ldt, ks, ldt, sw, lds, kd);
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
      pw[r * ldp + c] = from_f32<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = __expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    for (int d = half; d < kd; d += 2) accw[r * ldf + d] *= alpha;
    __syncwarp();
    warp_pv<T>(pw, ldp, vs, ldt, accw, ldf, kd);
    __syncthreads();  // the next tile load overwrites ks and vs
  }

  if (qi < S) {
    const float ll = fmaxf(l, 1e-30f);
    T* orow = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h +
              (long long)qi * a.so.s;
    for (int d = half; d < D; d += 2)
      orow[d] = from_f32<T>(accw[r * ldf + d] / ll);
    if (!half) a.lse[(long long)bh * S + qi] = m + logf(ll);
  }
}

template <typename T>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(a.D);
  cudaError_t e = allow_smem(flash_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * a.H, (a.S + kRows - 1) / kRows);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, s, h) of q, k, v and o in that order.
// mask: [B, S] int32 or null. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = launched).
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
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(a, B, st_)
                    : launch<float>(a, B, st_);
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
