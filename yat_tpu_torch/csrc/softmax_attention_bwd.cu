// K2b: the backward of K2, non-causal softmax attention over a short key
//      sequence with an optional fp32 additive key bias shared by all
//      heads, on the native [B, N, H, D] layout (strides, no transposes):
//        P  = softmax(q k^T / sqrt(D) + bias)            (recomputed, fp32)
//        dS = P * (dP - rowsum(dP * P)),  dP = g v^T      (fp32)
//        dq = (dS_c k) / sqrt(D),  dk = (dS_c^T q) / sqrt(D),  dv = P_c^T g
//      where dS_c is dS rounded to the storage type and P_c is P rounded to
//      g's type, as in the JAX kernel.  The bias gets no gradient.
//
// Replaces the TPU kernel yat_tpu/ops/attention.py:_vmem_mh_bwd_kernel
// (called through _vmem_attn_native_bwd), which held one batch element's
// [N, H*D] slabs in VMEM, looped over heads and formed the full [N_q, N_k]
// probability matrix.  The plain version is
// ops/attention.py:attention_bwd_ref.
//
// Bound on the H100: bytes at the training shapes (q/g [16,256,16,72],
// k/v [16,512,16,72] bf16: ~104 MB moved against ~24 GFLOP, ~230
// flop/byte, under the bf16 ridge of ~295).  Design, simple before fast:
//   * dq reduces over all keys and dk/dv over all queries, and blocks run in
//     no order, so the work is split into two launches with no atomics:
//     1. one block per (64 queries, head, batch element): pass 1 over 64-key
//        tiles finds each row's max, exp-sum and sum of exp * dP (online),
//        so rowsum(dP * P) = that sum / exp-sum; pass 2 recomputes P and dP,
//        forms dS and accumulates dq.  The three row statistics go to an
//        fp32 scratch [3, B, H, N_q] for launch 2;
//     2. one block per (64 keys, head, batch element): a loop over 64-query
//        tiles recomputes S^T = k q^T and dP^T = v g^T, forms P and dS with
//        the saved statistics and accumulates dk and dv;
//   * no probability or score tile leaves shared memory; the ragged edges
//     (N_k = 300, a tile of 16 keys, N_q not a multiple of 64) are
//     zero-filled tiles whose scores are masked;
//   * bf16 (the training path): all four products on the tensor cores (WMMA
//     16x16x16, fp32 accumulation; head dim zero-padded to a multiple of 16
//     in shared memory; 16-byte tile loads); fp32: the same tiles, products
//     on the CUDA cores;
//   * the accumulators (dq, or dk and dv) live in shared memory as fp32 and
//     each product adds into them, so one code path serves both types.
// The order of rounding is the JAX kernel's: P and dS in fp32, dS rounded to
// the storage type before the dq/dk products, P rounded before dv.
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kB = 64;          // query rows or key rows per tile
constexpr int kThreads = 128;   // 4 warps; warp w owns tile rows [16w, 16w+16)
constexpr int kMaxD = 128;
constexpr int kLdS = kB + 8;    // row stride of every [64, 64] tile

struct Strides {
  long long b, n, h;
};

template <typename T>
struct Layout {
  int dp;    // head dim padded to 16
  int ldt;   // row stride (elements) of the [64, dp] operand tiles
  int lda;   // row stride of the fp32 [64, dp] accumulators
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

// Shared-memory plan of one block, in byte offsets.  Launch 1 (dq) uses
// q, g, k, v, s, dp, ds, acc; launch 2 (dk, dv) uses the same tiles with
// k, v resident, a second accumulator and p.  For fp32 the dS and P tiles
// overwrite the score and dP tiles in place.
template <typename T>
struct Plan {
  size_t q, g, k, v, s, dp, ds, p, acc, acc2, bias, stats, total;
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
    stats = bump(o, 3 * kB * sizeof(float));
    total = o;
  }
};

// rows [row0, row0 + 64) of a [N, H, D] slab into a zero-padded
// [64, dp] tile; kVec: 16-byte loads (bf16, D and strides multiples of 8)
template <typename T, bool kVec>
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

// C[64, 64] (fp32, row stride kLdS) = A[64, kdim] B[64, kdim]^T; A and B
// are [64, dp] tiles with row stride ld.  Warp w writes rows [16w, 16w+16).
__device__ __forceinline__ void mm_nt(float* C, const bf16* A, const bf16* B,
                                      int ld, int kdim) {
  const int r0 = (threadIdx.x >> 5) * 16;
  for (int nt = 0; nt < kB / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < kdim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + r0 * ld + kk, ld);
      wmma::load_matrix_sync(fb, B + nt * 16 * ld + kk, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + r0 * kLdS + nt * 16, acc, kLdS,
                            wmma::mem_row_major);
  }
}

// fp32 on the CUDA cores: each thread a 4 x 8 patch; thread t's rows are
// 4*(t/8) .. 4*(t/8)+3, so warp w again writes rows [16w, 16w+16).
__device__ __forceinline__ void mm_nt(float* C, const float* A,
                                      const float* B, int ld, int kdim) {
  const int tr = threadIdx.x / 8;
  const int tc = threadIdx.x % 8;
  float acc[4][8] = {};
  for (int e = 0; e < kdim; ++e) {
    float a[4], c[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(tr * 4 + i) * ld + e];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = B[(tc + 8 * j) * ld + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) C[(tr * 4 + i) * kLdS + tc + 8 * j] = acc[i][j];
}

// C[64, ncols] (fp32, row stride ldc) += A[64, 64] (row stride kLdS)
// B[64, ncols] (row stride ldb); ncols is a multiple of 16.
__device__ __forceinline__ void mm_nn_acc(float* C, int ldc, const bf16* A,
                                          const bf16* B, int ldb, int ncols) {
  const int r0 = (threadIdx.x >> 5) * 16;
  for (int f = 0; f < ncols / 16; ++f) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, C + r0 * ldc + f * 16, ldc,
                           wmma::mem_row_major);
    for (int kt = 0; kt < kB / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, A + r0 * kLdS + kt * 16, kLdS);
      wmma::load_matrix_sync(fb, B + kt * 16 * ldb + f * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + r0 * ldc + f * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

__device__ __forceinline__ void mm_nn_acc(float* C, int ldc, const float* A,
                                          const float* B, int ldb,
                                          int ncols) {
  for (int idx = threadIdx.x; idx < kB * ncols; idx += kThreads) {
    const int r = idx / ncols;
    const int c = idx - r * ncols;
    float s = 0.f;
    for (int j = 0; j < kB; ++j) s = fmaf(A[r * kLdS + j], B[j * ldb + c], s);
    C[r * ldc + c] += s;
  }
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// score of tile entry (r, c): the raw product scaled, plus the key's bias
__device__ __forceinline__ float score(const float* s_t, const float* bias_t,
                                       int r, int c, float scale) {
  return __fadd_rn(__fmul_rn(s_t[r * kLdS + c], scale), bias_t[c]);
}

// Launch 1: dq, and the row statistics (max, exp-sum, rowsum(dP * P)).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ g, T* __restrict__ dq,
                 float* __restrict__ stats, int batch, int nq, int nk,
                 int heads, int d, Strides qs, Strides ks, Strides vs,
                 long long bias_sb, Strides gs, Strides dqs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(d);
  const Plan<T> P(d, false);
  T* q_t = at<T>(smem, P.q);
  T* g_t = at<T>(smem, P.g);
  T* k_t = at<T>(smem, P.k);
  T* v_t = at<T>(smem, P.v);
  float* s_t = at<float>(smem, P.s);
  float* dp_t = at<float>(smem, P.dp);
  T* ds_t = at<T>(smem, P.ds);
  float* acc = at<float>(smem, P.acc);
  float* bias_t = at<float>(smem, P.bias);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<T, kVec>(q_t, q, qs, b, h, q0, nq, d, L);
  load_tile<T, kVec>(g_t, g, gs, b, h, q0, nq, d, L);
  for (int idx = threadIdx.x; idx < kB * L.lda; idx += kThreads) acc[idx] = 0.f;

  auto load_kv = [&](int k0) {
    __syncthreads();
    load_tile<T, kVec>(k_t, k, ks, b, h, k0, nk, d, L);
    load_tile<T, kVec>(v_t, v, vs, b, h, k0, nk, d, L);
    for (int j = threadIdx.x; j < kB; j += kThreads)
      bias_t[j] = k0 + j >= nk ? -INFINITY
                               : (bias != nullptr ? bias[b * bias_sb + k0 + j]
                                                  : 0.f);
    __syncthreads();
    mm_nt(s_t, q_t, k_t, L.ldt, L.dp);
    mm_nt(dp_t, g_t, v_t, L.ldt, L.dp);
    __syncthreads();
  };

  // 1) per row: max m, exp-sum l and t = sum exp(z - m) * dP, online; the
  //    warp's 16 rows, lanes on columns lane and lane + 32 (every lane
  //    holds the same merged values)
  float m[16], l[16], t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    t[i] = 0.f;
  }
  for (int k0 = 0; k0 < nk; k0 += kB) {
    load_kv(k0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const float z0 = score(s_t, bias_t, r, lane, scale);
      const float z1 = score(s_t, bias_t, r, lane + 32, scale);
      const float mn = fmaxf(m[i], yat::warp_max(fmaxf(z0, z1)));
      const float e0 = z0 == -INFINITY ? 0.f : expf(z0 - mn);
      const float e1 = z1 == -INFINITY ? 0.f : expf(z1 - mn);
      const float se = yat::warp_sum(e0 + e1);
      const float st = yat::warp_sum(e0 * dp_t[r * kLdS + lane] +
                                     e1 * dp_t[r * kLdS + lane + 32]);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - mn);
      l[i] = l[i] * corr + se;
      t[i] = t[i] * corr + st;
      m[i] = mn;
    }
  }
  float dsum[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dsum[i] = t[i] / l[i];

  // 2) P, dS = P (dP - dsum) rounded to T, dq += dS k
  for (int k0 = 0; k0 < nk; k0 += kB) {
    load_kv(k0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
#pragma unroll
      for (int c = lane; c < kB; c += 32) {
        const float z = score(s_t, bias_t, r, c, scale);
        const float p = z == -INFINITY ? 0.f : expf(z - m[i]) / l[i];
        const float ds = p * (dp_t[r * kLdS + c] - dsum[i]);
        ds_t[r * kLdS + c] = yat::from_f<T>(ds);
      }
    }
    __syncthreads();
    mm_nn_acc(acc, L.lda, ds_t, k_t, L.ldt, L.dp);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gq = q0 + r;
    if (gq < nq)
      dq[b * dqs.b + gq * dqs.n + h * dqs.h + e] =
          yat::from_f<T>(acc[r * L.lda + e] * scale);
  }
  if (lane == 0) {
    const long long plane = static_cast<long long>(batch) * heads * nq;
    float* srow = stats + (static_cast<long long>(b) * heads + h) * nq;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int gq = q0 + warp * 16 + i;
      if (gq < nq) {
        srow[gq] = m[i];
        srow[plane + gq] = l[i];
        srow[2 * plane + gq] = dsum[i];
      }
    }
  }
}

// Launch 2: dk and dv for 64 keys, looping over the query tiles.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const T* __restrict__ g, T* __restrict__ dk,
                   T* __restrict__ dv, const float* __restrict__ stats,
                   int batch, int nq, int nk, int heads, int d, Strides qs,
                   Strides ks, Strides vs, long long bias_sb, Strides gs,
                   Strides dks, Strides dvs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(d);
  const Plan<T> P(d, true);
  T* q_t = at<T>(smem, P.q);
  T* g_t = at<T>(smem, P.g);
  T* k_t = at<T>(smem, P.k);
  T* v_t = at<T>(smem, P.v);
  float* s_t = at<float>(smem, P.s);
  float* dp_t = at<float>(smem, P.dp);
  T* ds_t = at<T>(smem, P.ds);
  T* p_t = at<T>(smem, P.p);
  float* dk_acc = at<float>(smem, P.acc);
  float* dv_acc = at<float>(smem, P.acc2);
  float* bias_t = at<float>(smem, P.bias);
  float* st_t = at<float>(smem, P.stats);   // [3][64]: m, l, dsum
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const long long plane = static_cast<long long>(batch) * heads * nq;
  const float* srow = stats + (static_cast<long long>(b) * heads + h) * nq;

  load_tile<T, kVec>(k_t, k, ks, b, h, k0, nk, d, L);
  load_tile<T, kVec>(v_t, v, vs, b, h, k0, nk, d, L);
  for (int j = threadIdx.x; j < kB; j += kThreads)
    bias_t[j] = (k0 + j < nk && bias != nullptr) ? bias[b * bias_sb + k0 + j]
                                                 : 0.f;
  for (int idx = threadIdx.x; idx < kB * L.lda; idx += kThreads) {
    dk_acc[idx] = 0.f;
    dv_acc[idx] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kB) {
    __syncthreads();
    load_tile<T, kVec>(q_t, q, qs, b, h, q0, nq, d, L);
    load_tile<T, kVec>(g_t, g, gs, b, h, q0, nq, d, L);
    for (int j = threadIdx.x; j < kB; j += kThreads) {
      const bool ok = q0 + j < nq;
      st_t[j] = ok ? srow[q0 + j] : 0.f;
      st_t[kB + j] = ok ? srow[plane + q0 + j] : 1.f;
      st_t[2 * kB + j] = ok ? srow[2 * plane + q0 + j] : 0.f;
    }
    __syncthreads();
    mm_nt(s_t, k_t, q_t, L.ldt, L.dp);     // S^T [keys, queries]
    mm_nt(dp_t, v_t, g_t, L.ldt, L.dp);    // dP^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < kB * kB; idx += kThreads) {
      const int kr = idx / kB;
      const int qc = idx - kr * kB;
      float p = 0.f, ds = 0.f;
      if (k0 + kr < nk && q0 + qc < nq) {
        const float z = __fadd_rn(__fmul_rn(s_t[kr * kLdS + qc], scale),
                                  bias_t[kr]);
        p = expf(z - st_t[qc]) / st_t[kB + qc];
        ds = p * (dp_t[kr * kLdS + qc] - st_t[2 * kB + qc]);
      }
      ds_t[kr * kLdS + qc] = yat::from_f<T>(ds);
      p_t[kr * kLdS + qc] = yat::from_f<T>(p);
    }
    __syncthreads();
    mm_nn_acc(dk_acc, L.lda, ds_t, q_t, L.ldt, L.dp);
    mm_nn_acc(dv_acc, L.lda, p_t, g_t, L.ldt, L.dp);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gk = k0 + r;
    if (gk < nk) {
      dk[b * dks.b + gk * dks.n + h * dks.h + e] =
          yat::from_f<T>(dk_acc[r * L.lda + e] * scale);
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

template <typename T>
size_t smem_bytes(int d) {
  const size_t a = Plan<T>(d, false).total;
  const size_t b = Plan<T>(d, true).total;
  return a > b ? a : b;
}

template <typename T, bool kVec>
cudaError_t launch(const T* q, const T* k, const T* v, const float* bias,
                   const T* g, T* dq, T* dk, T* dv, float* stats, int b,
                   int nq, int nk, int h, int d, Strides qs, Strides ks,
                   Strides vs, long long bias_sb, Strides gs, Strides dqs,
                   Strides dks, Strides dvs, float scale,
                   cudaStream_t stream) {
  const size_t s1 = Plan<T>(d, false).total;
  const size_t s2 = Plan<T>(d, true).total;
  cudaError_t e;
  if ((e = set_smem(attention_bwd_dq<T, kVec>, s1)) != cudaSuccess) return e;
  if ((e = set_smem(attention_bwd_dkdv<T, kVec>, s2)) != cudaSuccess) return e;
  attention_bwd_dq<T, kVec><<<dim3((nq + kB - 1) / kB, h, b), kThreads, s1,
                              stream>>>(q, k, v, bias, g, dq, stats, b, nq,
                                        nk, h, d, qs, ks, vs, bias_sb, gs,
                                        dqs, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attention_bwd_dkdv<T, kVec><<<dim3((nk + kB - 1) / kB, h, b), kThreads, s2,
                                stream>>>(q, k, v, bias, g, dk, dv, stats, b,
                                          nq, nk, h, d, qs, ks, vs, bias_sb,
                                          gs, dks, dvs, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Shared memory one block of the larger of the two launches needs, so the
// wrapper can refuse shapes that do not fit before launching.
extern "C" long long yat_attention_bwd_smem_bytes(int d, int dtype) {
  if (dtype == yat::kBFloat16) return static_cast<long long>(smem_bytes<bf16>(d));
  return static_cast<long long>(smem_bytes<float>(d));
}

extern "C" int yat_attention_bwd_max_head_dim() { return kMaxD; }

// q/g/dq [B, Nq, H, D], k/v/dk/dv [B, Nk, H, D], each with strides
// (b, n, h, 1); bias [B, Nk] fp32 with strides (bias_sb, 1), or null;
// stats: fp32 scratch of 3 * B * H * Nq values.  Two launches on `stream`.
extern "C" int yat_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* stats, int b, int nq,
    int nk, int h, int d, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long bias_sb, long long g_sb,
    long long g_sn, long long g_sh, long long dq_sb, long long dq_sn,
    long long dq_sh, long long dk_sb, long long dk_sn, long long dk_sh,
    long long dv_sb, long long dv_sn, long long dv_sh, float scale,
    int dtype, void* stream) {
  if (d > kMaxD || d < 1 || nk < 1 || nq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, gs{g_sb, g_sn, g_sh}, dqs{dq_sb, dq_sn, dq_sh},
      dks{dk_sb, dk_sn, dk_sh}, dvs{dv_sb, dv_sn, dv_sh};
  const float* bp = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(stats);
  if (dtype == yat::kFloat32) {
    using T = float;
    return static_cast<int>(launch<T, false>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bp, static_cast<const T*>(g),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), sp, b,
        nq, nk, h, d, qs, ks, vs, bias_sb, gs, dqs, dks, dvs, scale, st));
  }
  if (dtype == yat::kBFloat16) {
    using T = bf16;
    // 16-byte loads when every row start of the inputs is 16-byte aligned
    const bool vec = d % 8 == 0 && q_sb % 8 == 0 && q_sn % 8 == 0 &&
        q_sh % 8 == 0 && k_sb % 8 == 0 && k_sn % 8 == 0 && k_sh % 8 == 0 &&
        v_sb % 8 == 0 && v_sn % 8 == 0 && v_sh % 8 == 0 && g_sb % 8 == 0 &&
        g_sn % 8 == 0 && g_sh % 8 == 0 && aligned16(q) && aligned16(k) &&
        aligned16(v) && aligned16(g);
    auto run = vec ? launch<T, true> : launch<T, false>;
    return static_cast<int>(run(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bp, static_cast<const T*>(g),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), sp, b,
        nq, nk, h, d, qs, ks, vs, bias_sb, gs, dqs, dks, dvs, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
