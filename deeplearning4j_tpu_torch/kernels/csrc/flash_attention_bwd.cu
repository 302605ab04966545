// Flash-attention backward for Hopper (sm_90a): two kernels, as in the
// Pallas version, so that no block adds into another's output (no atomics,
// deterministic results):
//  - dq:    one block per (b*h, 64-row query tile), looping over key
//           tiles: p = exp(s - lse), ds = p * (g.v^T - delta),
//           dq = scale * sum ds.k;
//  - dk/dv: one block per (b*h, 64-row key tile), looping over query
//           tiles: dv = sum p^T.g, dk = scale * sum ds^T.q.
// p is recomputed from q, k and the forward's saved lse ([B, H, S]);
// delta = rowsum(o * g) ([B, H, S], f32) comes from the caller, with an
// lse cotangent already folded in (delta - g_lse).
//
// Replaces: deeplearning4j_tpu/kernels/flash_attention.py _flash_bwd, its
//   dq pallas_call (body _dq_kernel) and its dk/dv pallas_call (body
//   _dkv_kernel). There each grid walked its streamed tiles along a
//   sequential axis and carried dq (or dk, dv) in VMEM scratch.
//
// What bounds it on the H100: at BERT's shape (S = 128, D = 64) the
// device-memory bytes: q, k, v and g read once and dq, dk and dv written
// once are about 175 MB at B = 128, H = 12 in bf16, against about
// 22 GFLOP of products (~130 flops per byte, under the card's ~295), so
// bytes. Each kernel re-reads the streamed tiles of its (b, h), which
// the L2 cache mostly holds at this S. At long S the products take over.
//
// Design (simple first, see flash_common.cuh for the tile geometry):
//  - a loop inside each block replaces the TPU's sequential grid axis; the
//    f32 accumulators live in shared memory; lse and delta of a query row
//    live in the registers of the lanes that own it (dq) or in a
//    64-entry shared tile (dk/dv).
//  - strided [B, S, H, D] inputs (d-stride 1), the key mask [B, S] read
//    through b = bh / H, any S (keys and queries past S add nothing).
//  - ds is rounded to k's (dq) or q's (dk) dtype and p to g's dtype before
//    their products, as the Pallas kernels round them (:174, :201, :207).
//  - a hidden (masked or causal) score has ds = 0: its -1e30 does not
//    depend on q or k. A fully masked row (lse <= -5e29: every key took
//    the -1e30, so the forward's lse rounds to -1e30 exactly) took the
//    uniform softmax 1/S over all S keys, so its p is 1/S and its ds is 0:
//    the gradient of the plain version, written out.
//  - causal without a key mask skips the tiles past the diagonal, as the
//    forward does.
#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;        // dO, [B, S, H, D]
  const float* lse;     // [B, H, S]
  const float* delta;   // [B, H, S]
  const int* mask;      // [B, S] int32 key validity, or null
  void* out1;           // dq (dq kernel) or dk (dk/dv kernel)
  void* out2;           // dv (dk/dv kernel)
  Strides sq, sk, sv, sg, s1, s2;
  int S, H, D;
  float scale;
  int causal;
};

template <typename T>
size_t dq_smem(int D) {
  return 4 * tile_bytes<T>(D) + 2 * score_bytes<T>() + acc_bytes<T>(D);
}

template <typename T>
size_t dkv_smem(int D) {
  return 4 * tile_bytes<T>(D) + 2 * score_bytes<T>() + 2 * acc_bytes<T>(D) +
         round128(2 * kRows * sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, D = a.D;
  const int kd = Tr<T>::kd(D), ldt = Tr<T>::ld_t(D), ldf = Tr<T>::ld_f(D);
  constexpr int lds = Tr<T>::ld_s, ldp = Tr<T>::ld_p;
  const size_t tb = tile_bytes<T>(D), sb = score_bytes<T>();
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + tb);
  T* ks = reinterpret_cast<T*>(smem + 2 * tb);
  T* vs = reinterpret_cast<T*>(smem + 3 * tb);
  float* ss = reinterpret_cast<float*>(smem + 4 * tb);
  float* dps = reinterpret_cast<float*>(smem + 4 * tb + sb);
  float* acc = reinterpret_cast<float*>(smem + 4 * tb + 2 * sb);

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

  load_tile(qs, ldt, qb, a.sq.s, q0, S, D, kd);
  load_tile(gs, ldt, gb, a.sg.s, q0, S, D, kd);
  for (int i = threadIdx.x; i < kRows * ldf; i += kThreads) acc[i] = 0.f;
  const bool live = qi < S;
  const float lse = live ? a.lse[(long long)bh * S + qi] : 0.f;
  const float delta = live ? a.delta[(long long)bh * S + qi] : 0.f;
  // a fully masked row has ds = 0 everywhere, so dq = 0
  const bool row_on = live && lse > kFullyMasked;

  float* sw = ss + warp * 16 * lds;
  float* dpw = dps + warp * 16 * lds;
  T* dsw = reinterpret_cast<T*>(sw);
  float* accw = acc + warp * 16 * ldf;
  const int k_end = (a.causal && !mb) ? min(S, q0 + kRows) : S;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kRows) {
    load_tile(ks, ldt, kb, a.sk.s, k0, S, D, kd);
    load_tile(vs, ldt, vb, a.sv.s, k0, S, D, kd);
    __syncthreads();
    warp_abT<T>(qs + warp * 16 * ldt, ldt, ks, ldt, sw, lds, kd);
    warp_abT<T>(gs + warp * 16 * ldt, ldt, vs, ldt, dpw, lds, kd);
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
    for (int j = 0; j < 32; ++j)
      dsw[r * ldp + half * 32 + j] = from_f32<T>(dsv[j]);
    __syncwarp();
    warp_pv<T>(dsw, ldp, ks, ldt, accw, ldf, kd);
    __syncthreads();
  }

  if (live) {
    T* row = static_cast<T*>(a.out1) + b * a.s1.b + h * a.s1.h +
             (long long)qi * a.s1.s;
    for (int d = half; d < D; d += 2)
      row[d] = from_f32<T>(accw[r * ldf + d] * a.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, D = a.D;
  const int kd = Tr<T>::kd(D), ldt = Tr<T>::ld_t(D), ldf = Tr<T>::ld_f(D);
  constexpr int lds = Tr<T>::ld_s, ldp = Tr<T>::ld_p;
  const size_t tb = tile_bytes<T>(D), sb = score_bytes<T>(),
               ab = acc_bytes<T>(D);
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

  load_tile(ks, ldt, kb, a.sk.s, k0, S, D, kd);
  load_tile(vs, ldt, vb, a.sv.s, k0, S, D, kd);
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
    load_tile(qs, ldt, qb, a.sq.s, q0, S, D, kd);
    load_tile(gs, ldt, gb, a.sg.s, q0, S, D, kd);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const bool in = q0 + i < S;
      lse_s[i] = in ? a.lse[(long long)bh * S + q0 + i] : 0.f;
      delta_s[i] = in ? a.delta[(long long)bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
    warp_abT<T>(ks + warp * 16 * ldt, ldt, qs, ldt, sw, lds, kd);
    warp_abT<T>(vs + warp * 16 * ldt, ldt, gs, ldt, dpw, lds, kd);
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
      pw[r * ldp + half * 32 + j] = from_f32<T>(pv[j]);
      dsw[r * ldp + half * 32 + j] = from_f32<T>(dsv[j]);
    }
    __syncwarp();
    warp_pv<T>(pw, ldp, gs, ldt, dvw, ldf, kd);
    warp_pv<T>(dsw, ldp, qs, ldt, dkw, ldf, kd);
  }
  __syncthreads();

  if (kj < S) {
    T* dk = static_cast<T*>(a.out1) + b * a.s1.b + h * a.s1.h +
            (long long)kj * a.s1.s;
    T* dv = static_cast<T*>(a.out2) + b * a.s2.b + h * a.s2.h +
            (long long)kj * a.s2.s;
    for (int d = half; d < D; d += 2) {
      dk[d] = from_f32<T>(dkw[r * ldf + d] * a.scale);
      dv[d] = from_f32<T>(dvw[r * ldf + d]);
    }
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, const void* mask,
                  void* out1, void* out2, int S, int H, int D,
                  const long long* strides, float scale, int causal) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const int*>(mask);
  a.out1 = out1;
  a.out2 = out2;
  Strides* st[6] = {&a.sq, &a.sk, &a.sv, &a.sg, &a.s1, &a.s2};
  for (int i = 0; i < 6; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  return a;
}

template <typename T>
int launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = dq_smem<T>(a.D);
  cudaError_t e = allow_smem(flash_dq_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * a.H, (a.S + kRows - 1) / kRows);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = dkv_smem<T>(a.D);
  cudaError_t e = allow_smem(flash_dkv_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * a.H, (a.S + kRows - 1) / kRows);
  flash_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 18 element strides, (b, s, h) of q, k, v, g, then dq and an
// unused triple. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* g, const void* lse, const void* delta,
                           const void* mask, void* dq, int B, int S, int H,
                           int D, const long long* strides, float scale,
                           int causal, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a = make_args(q, k, v, g, lse, delta, mask, dq, nullptr, S,
                              H, D, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dq<__nv_bfloat16>(a, B, st)
                    : launch_dq<float>(a, B, st);
}

// strides: 18 element strides, (b, s, h) of q, k, v, g, dk and dv.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* g, const void* lse,
                            const void* delta, const void* mask, void* dk,
                            void* dv, int B, int S, int H, int D,
                            const long long* strides, float scale,
                            int causal, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const BwdArgs a = make_args(q, k, v, g, lse, delta, mask, dk, dv, S, H, D,
                              strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dkv<__nv_bfloat16>(a, B, st)
                    : launch_dkv<float>(a, B, st);
}

const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
