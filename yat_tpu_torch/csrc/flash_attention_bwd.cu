// K6b: the backward of K6, the flash-attention VJP from the forward's saved
//      row max m and exp-sum l, on the native [B, N, H, D] layout (strides,
//      no transposes), per (batch, head), fp32 unless stated:
//        s  = (q k^T) * sm_scale + bias          (bias: 0, or the mask value)
//        p  = exp(s - m) * (1 / l)
//        di = rowsum(o * dO)                     (o: the forward's output)
//        dv = sum_q p_c^T dO,   p_c = p rounded to dO's type
//        dp = dO v^T,  ds = ((dp - di) * p) * sm_scale
//        dk = sum_q ds_c^T q,   dq = sum_k ds_c k,   ds_c = ds rounded
//      dq, dk and dv accumulate in fp32 and are rounded once, at the end.
//      The bias gets no gradient.
//
// Replaces the TPU kernels of the Pallas library's flash-attention VJP that
// yat_tpu/ops/attention.py:dot_product_attention reaches through
// flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd :254-315 computes di outside the kernels, then
// _flash_attention_bwd_dkv, kernel :796-938, and _flash_attention_bwd_dq,
// kernel :1146-1284).  Its arithmetic, not K2b's: p is a multiply by the
// reciprocal of the saved l (:894-899), di comes from the rounded output
// (:273-275), and sm_scale is applied to ds before ds is rounded (:908-914,
// :1243-1248).  The plain version is ops/attention.py:flash_attention_bwd_ref.
//
// Bound on the H100: operations at the PixArt-Sigma 512px training shape
// (q/k/v/o/dO [8, 1024, 16, 72] bf16): five 2 N^2 D products per (b, h),
// 96.6 GFLOP on the tensor cores (0.098 ms at 989 TFLOP/s), against about
// 152 MB moved (0.045 ms at 3.35 TB/s).  Design, simple before fast:
//   * dq reduces over all keys and dk/dv over all queries, and blocks run in
//     no order, so the work is two launches with no atomics (results are
//     reproducible), as the library's split:
//     1. one block per (kB queries, head, batch element): di of its rows
//        (written to an fp32 scratch [B, H, N_q] for launch 2), then a walk
//        over kB-key tiles: S = q k^T, dP = dO v^T, p and ds, dq += ds_c k;
//     2. one block per (kB keys, head, batch element): a walk over kB-query
//        tiles: S^T = k q^T, dP^T = v dO^T, p and ds, dv += p_c^T dO,
//        dk += ds_c^T q;
//     so S and dP are formed twice: seven products where the VJP needs five;
//   * tiles are kB = 64 rows, or 32 where 64 would not fit in shared memory
//     (head dims past 128 in bf16, past 72 in fp32); every operand tile, the
//     [kB, kB] score and dP tiles, ds and p, and the fp32 accumulators live
//     in shared memory; no score reaches device memory;
//   * the ragged edges (N_k or N_q not a multiple of kB) are zero-filled
//     tiles whose p and ds are set to 0, so no length needs padding; fully
//     masked rows carry the finite mask value, as in the library;
//   * bf16 (the training path): all products on the tensor cores (WMMA
//     16x16x16, fp32 accumulation, head dim zero-padded to a multiple of 16
//     in shared memory, 16-byte tile loads); fp32: the same tiles, products
//     on the CUDA cores.
// Faster (register-resident accumulators with mma.sync, wgmma and TMA, one
// launch with the dq partials reduced apart) is later work.
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 128;   // 4 warps
constexpr int kMaxD = 256;
constexpr size_t kMaxSmem = 232448;

struct Strides {
  long long b, n, h;
};

template <typename T>
struct Layout {
  int dp;    // head dim padded to 16
  int ldt;   // row stride (elements) of the [kB, dp] operand tiles
  int lda;   // row stride of the fp32 [kB, dp] accumulators
  __host__ __device__ explicit Layout(int d) {
    dp = (d + 15) & ~15;
    ldt = std::is_same<T, float>::value ? dp + 1 : dp + 8;
    lda = dp + 4;
  }
};

__host__ __device__ inline size_t bump(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 127) & ~static_cast<size_t>(127);
  return at;
}

// Shared-memory plan of one block of kB-row tiles, in byte offsets.  Launch
// 1 (dq) uses q, g, k, v, s, dp, ds, acc; launch 2 (dk, dv) also p and a
// second accumulator.  For fp32, ds and p overwrite s and dp in place.
template <typename T, int kB>
struct Plan {
  static constexpr int kLdS = kB + 8;   // row stride of the [kB, kB] tiles
  size_t q, g, k, v, s, dp, ds, p, acc, acc2, bias, rows, total;
  __host__ __device__ Plan(int d, bool dkdv) {
    const Layout<T> L(d);
    const size_t tile = static_cast<size_t>(kB) * L.ldt * sizeof(T);
    const size_t sq = static_cast<size_t>(kB) * kLdS;
    size_t o = 0;
    q = bump(o, tile);
    g = bump(o, tile);
    k = bump(o, tile);
    v = bump(o, tile);
    s = bump(o, sq * sizeof(float));
    dp = bump(o, sq * sizeof(float));
    const bool f32 = std::is_same<T, float>::value;
    ds = f32 ? s : bump(o, sq * sizeof(T));
    p = f32 ? dp : (dkdv ? bump(o, sq * sizeof(T)) : ds);
    acc = bump(o, static_cast<size_t>(kB) * L.lda * sizeof(float));
    acc2 = dkdv ? bump(o, static_cast<size_t>(kB) * L.lda * sizeof(float))
                : acc;
    bias = bump(o, kB * sizeof(float));
    rows = bump(o, 3 * kB * sizeof(float));   // m, 1/l, di of kB queries
    total = o;
  }
};

// rows [row0, row0 + kB) of a [N, H, D] slab into a zero-padded [kB, dp]
// tile; kVec: 16-byte loads (bf16, D and strides multiples of 8)
template <typename T, int kB, bool kVec>
__device__ __forceinline__ void load_tile(T* dst, const T* src, Strides st,
                                          int b, int h, int row0, int rows,
                                          int d, const Layout<T>& L) {
  if (kVec) {
    const int cpr = L.dp / 8;
    for (int idx = threadIdx.x; idx < kB * cpr; idx += kThreads) {
      const int r = idx / cpr;
      const int e = (idx - r * cpr) * 8;
      const int gr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows && e < d)
        val = *reinterpret_cast<const uint4*>(
            src + b * st.b + gr * st.n + h * st.h + e);
      *reinterpret_cast<uint4*>(dst + r * L.ldt + e) = val;
    }
  } else {
    const T zero = yat::from_f<T>(0.f);
    for (int idx = threadIdx.x; idx < kB * L.dp; idx += kThreads) {
      const int r = idx / L.dp;
      const int e = idx - r * L.dp;
      const int gr = row0 + r;
      dst[r * L.ldt + e] = (gr < rows && e < d)
          ? src[b * st.b + gr * st.n + h * st.h + e] : zero;
    }
  }
}

// C[kB, kB] (fp32, row stride ldc) = A[kB, kdim] B[kB, kdim]^T; A and B are
// tiles with row stride ld.  The 16x16 output fragments are dealt out to
// the four warps.
template <int kB>
__device__ __forceinline__ void mm_nt(float* C, int ldc, const bf16* A,
                                      const bf16* B, int ld, int kdim) {
  constexpr int nf = kB / 16;
  for (int f = threadIdx.x >> 5; f < nf * nf; f += kThreads / 32) {
    const int rt = f / nf, ct = f - (f / nf) * nf;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < kdim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + rt * 16 * ld + kk, ld);
      wmma::load_matrix_sync(fb, B + ct * 16 * ld + kk, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + rt * 16 * ldc + ct * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

// fp32 on the CUDA cores: thread t computes rows (t / 8) * kB/16 + i and
// columns t % 8 + 8 j
template <int kB>
__device__ __forceinline__ void mm_nt(float* C, int ldc, const float* A,
                                      const float* B, int ld, int kdim) {
  constexpr int R = kB / 16, Cn = kB / 8;
  const int tr = threadIdx.x / 8;
  const int tc = threadIdx.x % 8;
  float acc[R][Cn];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < Cn; ++j) acc[i][j] = 0.f;
  for (int e = 0; e < kdim; ++e) {
    float a[R], c[Cn];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(tr * R + i) * ld + e];
#pragma unroll
    for (int j = 0; j < Cn; ++j) c[j] = B[(tc + 8 * j) * ld + e];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < Cn; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < Cn; ++j) C[(tr * R + i) * ldc + tc + 8 * j] = acc[i][j];
}

// C[kB, ncols] (fp32, row stride ldc) += A[kB, kB] (row stride lda)
// B[kB, ncols] (row stride ldb); ncols is a multiple of 16.
template <int kB>
__device__ __forceinline__ void mm_nn_acc(float* C, int ldc, const bf16* A,
                                          int lda, const bf16* B, int ldb,
                                          int ncols) {
  constexpr int nr = kB / 16;
  const int nc = ncols / 16;
  for (int f = threadIdx.x >> 5; f < nr * nc; f += kThreads / 32) {
    const int rt = f / nc, ct = f - (f / nc) * nc;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + rt * 16 * ldc + ct * 16, ldc,
                           wmma::mem_row_major);
    for (int kt = 0; kt < nr; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, A + rt * 16 * lda + kt * 16, lda);
      wmma::load_matrix_sync(fb, B + kt * 16 * ldb + ct * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + rt * 16 * ldc + ct * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

template <int kB>
__device__ __forceinline__ void mm_nn_acc(float* C, int ldc, const float* A,
                                          int lda, const float* B, int ldb,
                                          int ncols) {
  for (int idx = threadIdx.x; idx < kB * ncols; idx += kThreads) {
    const int r = idx / ncols;
    const int c = idx - r * ncols;
    float s = 0.f;
    for (int j = 0; j < kB; ++j) s = fmaf(A[r * lda + j], B[j * ldb + c], s);
    C[r * ldc + c] += s;
  }
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// p and ds of one (query, key) entry from the raw product s, the product dp,
// the key's bias and the query's m, 1/l and di; the library's order of
// operations, each rounded on its own (no contraction into an FMA)
__device__ __forceinline__ void p_ds(float s, float dp, float bias, float m,
                                     float linv, float di, float scale,
                                     float& p, float& ds) {
  const float z = __fadd_rn(__fmul_rn(s, scale), bias);
  p = __fmul_rn(expf(__fsub_rn(z, m)), linv);
  ds = __fmul_rn(__fmul_rn(__fsub_rn(dp, di), p), scale);
}

// Launch 1: di of the block's queries, then dq.
template <typename T, int kB, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ bias,
             const T* __restrict__ o, const T* __restrict__ g,
             const float* __restrict__ res_m, const float* __restrict__ res_l,
             float* __restrict__ di_out, T* __restrict__ dq, int nq, int nk,
             int d, Strides qs, Strides ks, Strides vs, long long bias_sb,
             Strides os, Strides gs, Strides dqs, float scale) {
  using P = Plan<T, kB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(d);
  const P pl(d, false);
  T* q_t = at<T>(smem, pl.q);
  T* g_t = at<T>(smem, pl.g);
  T* k_t = at<T>(smem, pl.k);
  T* v_t = at<T>(smem, pl.v);
  float* s_t = at<float>(smem, pl.s);
  float* dp_t = at<float>(smem, pl.dp);
  T* ds_t = at<T>(smem, pl.ds);
  float* acc = at<float>(smem, pl.acc);
  float* bias_t = at<float>(smem, pl.bias);
  float* m_t = at<float>(smem, pl.rows);
  float* linv_t = m_t + kB;
  float* di_t = m_t + 2 * kB;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * nq;

  load_tile<T, kB, kVec>(q_t, q, qs, b, h, q0, nq, d, L);
  load_tile<T, kB, kVec>(g_t, g, gs, b, h, q0, nq, d, L);
  for (int idx = threadIdx.x; idx < kB * L.lda; idx += kThreads) acc[idx] = 0.f;
  // di = rowsum(o * dO) in fp32, one warp per row; m and 1/l
  for (int r = warp; r < kB; r += kThreads / 32) {
    const int gq = q0 + r;
    float sum = 0.f;
    if (gq < nq) {
      const T* orow = o + b * os.b + gq * os.n + h * os.h;
      const T* grow = g + b * gs.b + gq * gs.n + h * gs.h;
      for (int e = lane; e < d; e += 32)
        sum += yat::to_f<T>(orow[e]) * yat::to_f<T>(grow[e]);
    }
    sum = yat::warp_sum(sum);
    if (lane == 0) {
      di_t[r] = sum;
      m_t[r] = gq < nq ? res_m[row0 + gq] : 0.f;
      linv_t[r] = gq < nq ? 1.f / res_l[row0 + gq] : 0.f;
      if (gq < nq) di_out[row0 + gq] = sum;
    }
  }

  for (int k0 = 0; k0 < nk; k0 += kB) {
    __syncthreads();
    load_tile<T, kB, kVec>(k_t, k, ks, b, h, k0, nk, d, L);
    load_tile<T, kB, kVec>(v_t, v, vs, b, h, k0, nk, d, L);
    for (int j = threadIdx.x; j < kB; j += kThreads)
      bias_t[j] = (k0 + j < nk && bias != nullptr) ? bias[b * bias_sb + k0 + j]
                                                   : 0.f;
    __syncthreads();
    mm_nt<kB>(s_t, P::kLdS, q_t, k_t, L.ldt, L.dp);     // S [queries, keys]
    mm_nt<kB>(dp_t, P::kLdS, g_t, v_t, L.ldt, L.dp);    // dP
    __syncthreads();
    for (int idx = threadIdx.x; idx < kB * kB; idx += kThreads) {
      const int r = idx / kB;
      const int c = idx - r * kB;
      float p = 0.f, ds = 0.f;
      if (q0 + r < nq && k0 + c < nk)
        p_ds(s_t[r * P::kLdS + c], dp_t[r * P::kLdS + c], bias_t[c], m_t[r],
             linv_t[r], di_t[r], scale, p, ds);
      ds_t[r * P::kLdS + c] = yat::from_f<T>(ds);
    }
    __syncthreads();
    mm_nn_acc<kB>(acc, L.lda, ds_t, P::kLdS, k_t, L.ldt, L.dp);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gq = q0 + r;
    if (gq < nq)
      dq[b * dqs.b + gq * dqs.n + h * dqs.h + e] =
          yat::from_f<T>(acc[r * L.lda + e]);
  }
}

// Launch 2: dk and dv for kB keys, walking the query tiles.
template <typename T, int kB, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               const T* __restrict__ g, const float* __restrict__ res_m,
               const float* __restrict__ res_l, const float* __restrict__ di,
               T* __restrict__ dk, T* __restrict__ dv, int nq, int nk, int d,
               Strides qs, Strides ks, Strides vs, long long bias_sb,
               Strides gs, Strides dks, Strides dvs, float scale) {
  using P = Plan<T, kB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(d);
  const P pl(d, true);
  T* q_t = at<T>(smem, pl.q);
  T* g_t = at<T>(smem, pl.g);
  T* k_t = at<T>(smem, pl.k);
  T* v_t = at<T>(smem, pl.v);
  float* s_t = at<float>(smem, pl.s);
  float* dp_t = at<float>(smem, pl.dp);
  T* ds_t = at<T>(smem, pl.ds);
  T* p_t = at<T>(smem, pl.p);
  float* dk_acc = at<float>(smem, pl.acc);
  float* dv_acc = at<float>(smem, pl.acc2);
  float* bias_t = at<float>(smem, pl.bias);
  float* m_t = at<float>(smem, pl.rows);
  float* linv_t = m_t + kB;
  float* di_t = m_t + 2 * kB;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * nq;

  load_tile<T, kB, kVec>(k_t, k, ks, b, h, k0, nk, d, L);
  load_tile<T, kB, kVec>(v_t, v, vs, b, h, k0, nk, d, L);
  for (int j = threadIdx.x; j < kB; j += kThreads)
    bias_t[j] = (k0 + j < nk && bias != nullptr) ? bias[b * bias_sb + k0 + j]
                                                 : 0.f;
  for (int idx = threadIdx.x; idx < kB * L.lda; idx += kThreads) {
    dk_acc[idx] = 0.f;
    dv_acc[idx] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kB) {
    __syncthreads();
    load_tile<T, kB, kVec>(q_t, q, qs, b, h, q0, nq, d, L);
    load_tile<T, kB, kVec>(g_t, g, gs, b, h, q0, nq, d, L);
    for (int j = threadIdx.x; j < kB; j += kThreads) {
      const bool ok = q0 + j < nq;
      m_t[j] = ok ? res_m[row0 + q0 + j] : 0.f;
      linv_t[j] = ok ? 1.f / res_l[row0 + q0 + j] : 0.f;
      di_t[j] = ok ? di[row0 + q0 + j] : 0.f;
    }
    __syncthreads();
    mm_nt<kB>(s_t, P::kLdS, k_t, q_t, L.ldt, L.dp);     // S^T [keys, queries]
    mm_nt<kB>(dp_t, P::kLdS, v_t, g_t, L.ldt, L.dp);    // dP^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < kB * kB; idx += kThreads) {
      const int kr = idx / kB;
      const int qc = idx - kr * kB;
      float p = 0.f, ds = 0.f;
      if (k0 + kr < nk && q0 + qc < nq)
        p_ds(s_t[kr * P::kLdS + qc], dp_t[kr * P::kLdS + qc], bias_t[kr],
             m_t[qc], linv_t[qc], di_t[qc], scale, p, ds);
      ds_t[kr * P::kLdS + qc] = yat::from_f<T>(ds);
      p_t[kr * P::kLdS + qc] = yat::from_f<T>(p);
    }
    __syncthreads();
    mm_nn_acc<kB>(dv_acc, L.lda, p_t, P::kLdS, g_t, L.ldt, L.dp);
    mm_nn_acc<kB>(dk_acc, L.lda, ds_t, P::kLdS, q_t, L.ldt, L.dp);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gk = k0 + r;
    if (gk < nk) {
      dk[b * dks.b + gk * dks.n + h * dks.h + e] =
          yat::from_f<T>(dk_acc[r * L.lda + e]);
      dv[b * dvs.b + gk * dvs.n + h * dvs.h + e] =
          yat::from_f<T>(dv_acc[r * L.lda + e]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The tile rows: 64 where both launches' plans fit, else 32.
template <typename T>
int tile_rows(int d) {
  return Plan<T, 64>(d, true).total <= kMaxSmem ? 64 : 32;
}

template <typename T>
size_t smem_bytes(int d) {
  return tile_rows<T>(d) == 64 ? Plan<T, 64>(d, true).total
                               : Plan<T, 32>(d, true).total;
}

struct Args {
  const void *q, *k, *v, *bias, *o, *g, *m, *l;
  void *di, *dq, *dk, *dv;
  int b, nq, nk, h, d;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  long long bias_sb;
  float scale;
};

template <typename T, int kB, bool kVec>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t s1 = Plan<T, kB>(a.d, false).total;
  const size_t s2 = Plan<T, kB>(a.d, true).total;
  if (s2 > kMaxSmem) return cudaErrorInvalidValue;
  auto k1 = flash_bwd_dq<T, kB, kVec>;
  auto k2 = flash_bwd_dkdv<T, kB, kVec>;
  cudaError_t e;
  if ((e = set_smem(k1, s1)) != cudaSuccess) return e;
  if ((e = set_smem(k2, s2)) != cudaSuccess) return e;
  const float* bias = static_cast<const float*>(a.bias);
  const float* m = static_cast<const float*>(a.m);
  const float* l = static_cast<const float*>(a.l);
  k1<<<dim3((a.nq + kB - 1) / kB, a.h, a.b), kThreads, s1, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), bias, static_cast<const T*>(a.o),
      static_cast<const T*>(a.g), m, l, static_cast<float*>(a.di),
      static_cast<T*>(a.dq), a.nq, a.nk, a.d, a.qs, a.ks, a.vs, a.bias_sb,
      a.os, a.gs, a.dqs, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k2<<<dim3((a.nk + kB - 1) / kB, a.h, a.b), kThreads, s2, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), bias, static_cast<const T*>(a.g), m, l,
      static_cast<const float*>(a.di), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.nq, a.nk, a.d, a.qs, a.ks, a.vs, a.bias_sb,
      a.gs, a.dks, a.dvs, a.scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool strides8(Strides s) { return s.b % 8 == 0 && s.n % 8 == 0 && s.h % 8 == 0; }

}  // namespace

// Shared memory one block of the larger launch needs, so the wrapper can
// refuse shapes that do not fit before launching.
extern "C" long long yat_flash_attention_bwd_smem_bytes(int d, int dtype) {
  if (dtype == yat::kBFloat16) return static_cast<long long>(smem_bytes<bf16>(d));
  return static_cast<long long>(smem_bytes<float>(d));
}

extern "C" int yat_flash_attention_bwd_max_head_dim() { return kMaxD; }

// q/o/g/dq [B, Nq, H, D], k/v/dk/dv [B, Nk, H, D], each with strides
// (b, n, h, 1); bias [B, Nk] fp32 with strides (bias_sb, 1), or null;
// m, l: the forward's fp32 [B, H, Nq] residuals; di: fp32 scratch
// [B, H, Nq] from launch 1 to launch 2.  Two launches on `stream`.
extern "C" int yat_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* o, const void* g, const void* m, const void* l, void* di,
    void* dq, void* dk, void* dv, int b, int nq, int nk, int h, int d,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long bias_sb, long long o_sb, long long o_sn,
    long long o_sh, long long g_sb, long long g_sn, long long g_sh,
    long long dq_sb, long long dq_sn, long long dq_sh, long long dk_sb,
    long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn,
    long long dv_sh, float scale, int dtype, void* stream) {
  if (d > kMaxD || d < 1 || nk < 1 || nq < 1 || m == nullptr || l == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q, k, v, bias, o, g, m, l, di, dq, dk, dv, b, nq, nk, h, d,
         Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
         Strides{v_sb, v_sn, v_sh}, Strides{o_sb, o_sn, o_sh},
         Strides{g_sb, g_sn, g_sh}, Strides{dq_sb, dq_sn, dq_sh},
         Strides{dk_sb, dk_sn, dk_sh}, Strides{dv_sb, dv_sn, dv_sh}, bias_sb,
         scale};
  if (dtype == yat::kFloat32) {
    auto run = tile_rows<float>(d) == 64 ? launch<float, 64, false>
                                         : launch<float, 32, false>;
    return static_cast<int>(run(a, st));
  }
  if (dtype == yat::kBFloat16) {
    // 16-byte loads when every row start of the tiled inputs is 16-byte
    // aligned
    const bool vec = d % 8 == 0 && strides8(a.qs) && strides8(a.ks) &&
        strides8(a.vs) && strides8(a.gs) && aligned16(q) && aligned16(k) &&
        aligned16(v) && aligned16(g);
    const bool wide = tile_rows<bf16>(d) == 64;
    auto run = wide ? (vec ? launch<bf16, 64, true> : launch<bf16, 64, false>)
                    : (vec ? launch<bf16, 32, true> : launch<bf16, 32, false>);
    return static_cast<int>(run(a, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
