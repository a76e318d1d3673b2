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
// flop/byte, under the bf16 ridge of ~295).  Design:
//   * dq reduces over all keys and dk/dv over all queries, and blocks run in
//     no order, so the work is split into two launches with no atomics
//     (bit-reproducible):
//     1. one block per (64 queries, head, batch element): pass 1 over 64-key
//        tiles finds each row's max, exp-sum and sum of exp * dP (online per
//        thread, merged across the four threads of a row after the last
//        tile), so rowsum(dP * P) = that sum / exp-sum; pass 2 recomputes P
//        and dP, forms dS and accumulates dq.  dS needs the whole row's sum
//        before any of it, hence two passes.  The three row statistics go
//        to an fp32 scratch [3, B, H, N_q] for launch 2;
//     2. one block per (64 keys, head, batch element): a walk over 64-query
//        tiles recomputes S^T = k q^T and dP^T = v g^T, forms P and dS with
//        the saved statistics and accumulates dk and dv;
//   * bf16 (the training path) on the body of attention_bwd_tiles.cuh: all
//     products with mma.sync m16n8k16 (fp32 accumulation), operands by
//     ldmatrix, the resident side's fragments (q and g in launch 1, K and V
//     up to D = 80 in launch 2), the score and dP tiles, P, dS and the
//     accumulators in registers; the streamed side through a two-stage
//     cp.async ring; no probability or score leaves the registers;
//   * the ragged edges (N_k = 300, a tile of 16 keys, N_q not a multiple of
//     64) are zero-filled tiles whose scores are masked;
//   * fp32: the first design, every tile, the score and dP tiles and the
//     accumulators in shared memory, products on the CUDA cores (no
//     training path runs it).
// The order of rounding is the JAX kernel's: P and dS in fp32, dS rounded to
// the storage type before the dq/dk products, P rounded before dv, the
// 1/sqrt(D) scale after the dq/dk products.
#include <math.h>
#include <stdint.h>

#include "attention_bwd_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using yat::attn::Strides;
using yat::attn::set_smem;

constexpr int kMaxD = 128;

struct Args {
  const void *q, *k, *v, *bias, *g;
  void *dq, *dk, *dv, *stats;
  int b, nq, nk, h, d;
  Strides qs, ks, vs, gs, dqs, dks, dvs;
  long long bias_sb;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync, registers)
// ---------------------------------------------------------------------------
namespace tc {

using namespace yat::attn;

// Launch 1: dq, and the row statistics (max, exp-sum, rowsum(dP * P)).
template <bool kVec, int kDC>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ g, bf16* __restrict__ dq,
                      float* __restrict__ stats, int batch, int nq, int nk,
                      int heads, int d, Strides qs, Strides ks, Strides vs,
                      long long bias_sb, Strides gs, Strides dqs,
                      float scale) {
  constexpr bool kHold = kDC <= 8;   // q and g fragments in registers
  constexpr int kNS = 4;             // 32 keys a sub-step
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(16 * kDC);
  const BwdPlan P(L);
  bf16* q_t = reinterpret_cast<bf16*>(smem);
  bf16* g_t = q_t + kBQ * L.ldt;
  unsigned char* ring = smem + 2 * P.tile;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const int gr = lane >> 2, tq = lane & 3;
  const int tiles = (nk + kBK - 1) / kBK;

  issue_bf16_tile<kVec>(q_t, q, qs, b, h, q0, nq, d, L);
  issue_bf16_tile<kVec>(g_t, g, gs, b, h, q0, nq, d, L);
  // the key tiles of both passes in one sequence
  auto issue = [&](int i, int stage) {
    const int k0 = (i % tiles) * kBK;
    bf16* k_s = reinterpret_cast<bf16*>(ring + stage * P.stage);
    issue_bf16_tile<kVec>(k_s, k, ks, b, h, k0, nk, d, L);
    issue_bf16_tile<kVec>(k_s + kBK * L.ldt, v, vs, b, h, k0, nk, d, L);
    issue_bias(reinterpret_cast<float*>(k_s + 2 * kBK * L.ldt), bias,
               bias_sb, b, k0, nk);
  };

  // rows gr and gr + 8 of the warp: max m, exp-sum l and t = sum exp(z - m)
  // dP, online over this thread's columns; after pass 1 merged across the
  // row's four threads, and t replaced by dsum = t / l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  RowFrags<kDC, kHold> qa, ga;
  float acc[2 * kDC][4];
  zero_acc<kDC>(acc);
  ring_walk(2 * tiles, issue, [&](int i, int stage) {
    if (i == 0) {
      qa.init(q_t, L.ldt, r0);
      ga.init(g_t, L.ldt, r0);
    }
    const bf16* k_s = reinterpret_cast<const bf16*>(ring + stage * P.stage);
    const bf16* v_s = k_s + kBK * L.ldt;
    const float* bias_s = reinterpret_cast<const float*>(v_s + kBK * L.ldt);
    const bool stats_pass = i < tiles;
    const int k0 = (i % tiles) * kBK;
    for (int c0 = 0; c0 < kBK && k0 + c0 < nk; c0 += 8 * kNS) {
      float z[kNS][4], dp[kNS][4];
      rows_by_rows<kDC, kNS>(z, qa, k_s, L.ldt, c0);   // S [queries, keys]
      rows_by_rows<kDC, kNS>(dp, ga, v_s, L.ldt, c0);  // dP
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          z[j][e] = k0 + col < nk
              ? __fadd_rn(__fmul_rn(z[j][e], scale), bias_s[col]) : -INFINITY;
        }
      if (stats_pass) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kNS; ++j)
            mx = fmaxf(mx, fmaxf(z[j][2 * hf], z[j][2 * hf + 1]));
          if (mx == -INFINITY) continue;
          const float mn = fmaxf(m[hf], mx);
          const float corr = m[hf] == -INFINITY ? 0.f : expf(m[hf] - mn);
          float se = 0.f, st = 0.f;
#pragma unroll
          for (int j = 0; j < kNS; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float ex = expf(z[j][2 * hf + c] - mn);
              se += ex;
              st += ex * dp[j][2 * hf + c];
            }
          l[hf] = l[hf] * corr + se;
          t[hf] = t[hf] * corr + st;
          m[hf] = mn;
        }
      } else {
        // P, dS = P (dP - dsum) rounded to bf16, dq += dS k
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1;
            const float p = z[j][e] == -INFINITY
                ? 0.f : expf(z[j][e] - m[hf]) / l[hf];
            z[j][e] = p * (dp[j][e] - t[hf]);
          }
        uint32_t a[kNS / 2][4];
        pack_a<kNS>(a, z);
        acc_rows<kDC, kNS>(acc, a, k_s, L.ldt, c0, 0);
      }
    }
    if (i == tiles - 1) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mb = m[hf];
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
        const float c = m[hf] == -INFINITY ? 0.f : expf(m[hf] - mb);
        float lb = l[hf] * c, tb = t[hf] * c;
        lb += __shfl_xor_sync(0xffffffffu, lb, 1);
        lb += __shfl_xor_sync(0xffffffffu, lb, 2);
        tb += __shfl_xor_sync(0xffffffffu, tb, 1);
        tb += __shfl_xor_sync(0xffffffffu, tb, 2);
        m[hf] = mb;
        l[hf] = lb;
        t[hf] = tb / lb;
      }
    }
  });
  store_rows<kDC>(dq, dqs, b, h, q0 + r0, nq, d, 0, acc, scale);
  if (tq == 0) {
    const long long plane = static_cast<long long>(batch) * heads * nq;
    float* srow = stats + (static_cast<long long>(b) * heads + h) * nq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gq = q0 + r0 + gr + 8 * hf;
      if (gq < nq) {
        srow[gq] = m[hf];
        srow[plane + gq] = l[hf];
        srow[2 * plane + gq] = t[hf];
      }
    }
  }
}

// Launch 2: dk and dv for 64 keys, walking the query tiles.  At D <= 32
// the hint of 2 blocks per SM keeps ptxas from spilling (8-16 bytes in the
// launch without 16-byte loads); 0 elsewhere is no hint.
template <bool kVec, int kDC>
__global__ void __launch_bounds__(kThreads, kDC <= 2 ? 2 : 0)
attention_bwd_dkdv_bf16(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const bf16* __restrict__ g, bf16* __restrict__ dk,
                        bf16* __restrict__ dv,
                        const float* __restrict__ stats, int batch, int nq,
                        int nk, int heads, int d, Strides qs, Strides ks,
                        Strides vs, long long bias_sb, Strides gs,
                        Strides dks, Strides dvs, float scale) {
  constexpr bool kHold = kDC <= 5;   // K and V fragments in registers
  constexpr int kNS = 2;             // 16 queries a sub-step
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(16 * kDC);
  const BwdPlan P(L);
  bf16* k_t = reinterpret_cast<bf16*>(smem);
  bf16* v_t = k_t + kBK * L.ldt;
  unsigned char* ring = smem + 2 * P.tile;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const int gr = lane >> 2, tq = lane & 3;
  const long long plane = static_cast<long long>(batch) * heads * nq;
  const float* srow = stats + (static_cast<long long>(b) * heads + h) * nq;

  issue_bf16_tile<kVec>(k_t, k, ks, b, h, k0, nk, d, L);
  issue_bf16_tile<kVec>(v_t, v, vs, b, h, k0, nk, d, L);
  // the bias of the thread's two key rows
  float kb[2];
  bool kin[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = k0 + r0 + gr + 8 * hf;
    kin[hf] = kr < nk;
    kb[hf] = kin[hf] && bias != nullptr ? bias[b * bias_sb + kr] : 0.f;
  }
  // the statistics m, l and dsum of a query tile's 64 rows: thread j < 64
  // holds m and l of query j, thread 64 + j its dsum; loaded one step ahead
  // into registers and stored to the stage after the current step
  const int rj = threadIdx.x & (kBK - 1);
  const bool second = threadIdx.x >= kBK;
  float pre0 = 0.f, pre1 = 1.f;
  auto load_rows = [&](int i) {
    const int gq = i * kBQ + rj;
    const bool ok = gq < nq;
    pre0 = ok ? srow[(second ? 2 * plane : 0) + gq] : 0.f;
    pre1 = ok && !second ? srow[plane + gq] : 1.f;
  };
  auto store_rows_to = [&](int stage) {
    float* rv = reinterpret_cast<float*>(ring + stage * P.stage + 2 * P.tile);
    if (second) {
      rv[2 * kBQ + rj] = pre0;
    } else {
      rv[rj] = pre0;
      rv[kBQ + rj] = pre1;
    }
  };
  auto issue = [&](int i, int stage) {
    bf16* q_s = reinterpret_cast<bf16*>(ring + stage * P.stage);
    issue_bf16_tile<kVec>(q_s, q, qs, b, h, i * kBQ, nq, d, L);
    issue_bf16_tile<kVec>(q_s + kBQ * L.ldt, g, gs, b, h, i * kBQ, nq, d, L);
    load_rows(i);
    if (i == 0) store_rows_to(0);
  };

  RowFrags<kDC, kHold> ka, va;
  float dka[2 * kDC][4], dva[2 * kDC][4];
  zero_acc<kDC>(dka);
  zero_acc<kDC>(dva);
  const int steps = (nq + kBQ - 1) / kBQ;
  ring_walk(steps, issue, [&](int i, int stage) {
    if (i == 0) {
      ka.init(k_t, L.ldt, r0);
      va.init(v_t, L.ldt, r0);
    }
    const bf16* q_s = reinterpret_cast<const bf16*>(ring + stage * P.stage);
    const bf16* g_s = q_s + kBQ * L.ldt;
    const float* rv = reinterpret_cast<const float*>(g_s + kBQ * L.ldt);
    const int q0 = i * kBQ;
    for (int c0 = 0; c0 < kBQ && q0 + c0 < nq; c0 += 8 * kNS) {
      float sc[kNS][4], dp[kNS][4];
      rows_by_rows<kDC, kNS>(sc, ka, q_s, L.ldt, c0);   // S^T [keys, queries]
      rows_by_rows<kDC, kNS>(dp, va, g_s, L.ldt, c0);   // dP^T
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          const int hf = e >> 1;
          float p = 0.f, ds = 0.f;
          if (kin[hf] && q0 + col < nq) {
            const float z = __fadd_rn(__fmul_rn(sc[j][e], scale), kb[hf]);
            p = expf(z - rv[col]) / rv[kBQ + col];
            ds = p * (dp[j][e] - rv[2 * kBQ + col]);
          }
          sc[j][e] = p;
          dp[j][e] = ds;
        }
      uint32_t pa[kNS / 2][4], da[kNS / 2][4];
      pack_a<kNS>(pa, sc);
      pack_a<kNS>(da, dp);
      acc_rows<kDC, kNS>(dva, pa, g_s, L.ldt, c0, 0);   // dv += P_c^T g
      acc_rows<kDC, kNS>(dka, da, q_s, L.ldt, c0, 0);   // dk += dS_c^T q
    }
    if (i + 1 < steps) store_rows_to(stage ^ 1);
  });
  store_rows<kDC>(dk, dks, b, h, k0 + r0, nk, d, 0, dka, scale);
  store_rows<kDC>(dv, dvs, b, h, k0 + r0, nk, d, 0, dva, 1.f);
}

template <bool kVec, int kDC>
cudaError_t launch_chunks(const Args& a, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(a.d);
  auto k1 = attention_bwd_dq_bf16<kVec, kDC>;
  auto k2 = attention_bwd_dkdv_bf16<kVec, kDC>;
  cudaError_t e;
  if ((e = set_smem(k1, smem)) != cudaSuccess) return e;
  if ((e = set_smem(k2, smem)) != cudaSuccess) return e;
  const float* bias = static_cast<const float*>(a.bias);
  float* stats = static_cast<float*>(a.stats);
  k1<<<dim3((a.nq + kBQ - 1) / kBQ, a.h, a.b), kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), bias, static_cast<const bf16*>(a.g),
      static_cast<bf16*>(a.dq), stats, a.b, a.nq, a.nk, a.h, a.d, a.qs, a.ks,
      a.vs, a.bias_sb, a.gs, a.dqs, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k2<<<dim3((a.nk + kBK - 1) / kBK, a.h, a.b), kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), bias, static_cast<const bf16*>(a.g),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), stats, a.b, a.nq,
      a.nk, a.h, a.d, a.qs, a.ks, a.vs, a.bias_sb, a.gs, a.dks, a.dvs,
      a.scale);
  return cudaGetLastError();
}

// Registers, local (spill) bytes, dynamic shared bytes and resident blocks
// per SM of both launches at head dim d, four values each.
template <bool kVec, int kDC>
cudaError_t info_chunks(int d, long long* out) {
  const size_t smem = bwd_smem_bytes(d);
  const cudaError_t e =
      launch_info(attention_bwd_dq_bf16<kVec, kDC>, smem, out);
  return e != cudaSuccess
      ? e : launch_info(attention_bwd_dkdv_bf16<kVec, kDC>, smem, out + 4);
}

#define YAT_BWD_CHUNKS(FN, DC, VEC, ...)                                     \
  case DC:                                                                   \
    return VEC ? FN<true, DC>(__VA_ARGS__) : FN<false, DC>(__VA_ARGS__);

cudaError_t launch(const Args& a, bool vec, cudaStream_t stream) {
  switch (head_chunks(a.d)) {
    YAT_BWD_CHUNKS(launch_chunks, 2, vec, a, stream)
    YAT_BWD_CHUNKS(launch_chunks, 4, vec, a, stream)
    YAT_BWD_CHUNKS(launch_chunks, 5, vec, a, stream)
    YAT_BWD_CHUNKS(launch_chunks, 8, vec, a, stream)
  }
  return cudaErrorInvalidValue;
}

cudaError_t info(int d, bool vec, long long* out) {
  switch (head_chunks(d)) {
    YAT_BWD_CHUNKS(info_chunks, 2, vec, d, out)
    YAT_BWD_CHUNKS(info_chunks, 4, vec, d, out)
    YAT_BWD_CHUNKS(info_chunks, 5, vec, d, out)
    YAT_BWD_CHUNKS(info_chunks, 8, vec, d, out)
  }
  return cudaErrorInvalidValue;
}
#undef YAT_BWD_CHUNKS

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores (shared-memory tiles and accumulators)
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kB = 64;          // query rows or key rows per tile
constexpr int kThreads = 128;   // 4 warps; warp w owns tile rows [16w, 16w+16)
constexpr int kLdS = kB + 8;    // row stride of every [64, 64] tile

__host__ __device__ inline size_t bump(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 127) & ~static_cast<size_t>(127);
  return at;
}

// Shared-memory plan of one block, in byte offsets: q, g, k, v tiles
// [64, d + 1], the score and dP tiles (dS and P overwrite them in place),
// the accumulator (dq, or dk and a second one for dv), the bias and the
// three row statistics.
struct Plan {
  size_t q, g, k, v, s, dp, acc, acc2, bias, stats, total;
  __host__ __device__ Plan(int d, bool dkdv) {
    const size_t tile = static_cast<size_t>(kB) * (d + 1) * sizeof(float);
    const size_t sq = static_cast<size_t>(kB) * kLdS * sizeof(float);
    const size_t accb = static_cast<size_t>(kB) * (d + 4) * sizeof(float);
    size_t o = 0;
    q = bump(o, tile);
    g = bump(o, tile);
    k = bump(o, tile);
    v = bump(o, tile);
    s = bump(o, sq);
    dp = bump(o, sq);
    acc = bump(o, accb);
    acc2 = dkdv ? bump(o, accb) : acc;
    bias = bump(o, kB * sizeof(float));
    stats = bump(o, 3 * kB * sizeof(float));
    total = o;
  }
};

// rows [row0, row0 + 64) of a [N, H, D] slab into a [64, d] tile (rows at
// or past ``rows`` are zero)
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          Strides st, int b, int h, int row0,
                                          int rows, int d) {
  const int ld = d + 1;
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gr = row0 + r;
    dst[r * ld + e] =
        gr < rows ? src[b * st.b + gr * st.n + h * st.h + e] : 0.f;
  }
}

// C[64, 64] (row stride kLdS) = A[64, kdim] B[64, kdim]^T, A and B with
// row stride ld: each thread a 4 x 8 patch; thread t's rows are
// 4*(t/8) .. 4*(t/8)+3, so warp w writes rows [16w, 16w+16).
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

// C[64, ncols] (row stride ldc) += A[64, 64] (row stride kLdS)
// B[64, ncols] (row stride ldb)
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

__device__ __forceinline__ float* at(unsigned char* base, size_t off) {
  return reinterpret_cast<float*>(base + off);
}

// score of tile entry (r, c): the raw product scaled, plus the key's bias
__device__ __forceinline__ float score(const float* s_t, const float* bias_t,
                                       int r, int c, float scale) {
  return __fadd_rn(__fmul_rn(s_t[r * kLdS + c], scale), bias_t[c]);
}

// Launch 1: dq, and the row statistics (max, exp-sum, rowsum(dP * P)).
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ g, float* __restrict__ dq,
                 float* __restrict__ stats, int batch, int nq, int nk,
                 int heads, int d, Strides qs, Strides ks, Strides vs,
                 long long bias_sb, Strides gs, Strides dqs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = d + 1, lda = d + 4;
  const Plan P(d, false);
  float* q_t = at(smem, P.q);
  float* g_t = at(smem, P.g);
  float* k_t = at(smem, P.k);
  float* v_t = at(smem, P.v);
  float* s_t = at(smem, P.s);
  float* dp_t = at(smem, P.dp);
  float* acc = at(smem, P.acc);
  float* bias_t = at(smem, P.bias);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile(q_t, q, qs, b, h, q0, nq, d);
  load_tile(g_t, g, gs, b, h, q0, nq, d);
  for (int idx = threadIdx.x; idx < kB * lda; idx += kThreads) acc[idx] = 0.f;

  auto load_kv = [&](int k0) {
    __syncthreads();
    load_tile(k_t, k, ks, b, h, k0, nk, d);
    load_tile(v_t, v, vs, b, h, k0, nk, d);
    for (int j = threadIdx.x; j < kB; j += kThreads)
      bias_t[j] = k0 + j >= nk ? -INFINITY
                               : (bias != nullptr ? bias[b * bias_sb + k0 + j]
                                                  : 0.f);
    __syncthreads();
    mm_nt(s_t, q_t, k_t, ldt, d);
    mm_nt(dp_t, g_t, v_t, ldt, d);
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

  // 2) P, dS = P (dP - dsum), dq += dS k
  for (int k0 = 0; k0 < nk; k0 += kB) {
    load_kv(k0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
#pragma unroll
      for (int c = lane; c < kB; c += 32) {
        const float z = score(s_t, bias_t, r, c, scale);
        const float p = z == -INFINITY ? 0.f : expf(z - m[i]) / l[i];
        s_t[r * kLdS + c] = p * (dp_t[r * kLdS + c] - dsum[i]);
      }
    }
    __syncthreads();
    mm_nn_acc(acc, lda, s_t, k_t, ldt, d);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gq = q0 + r;
    if (gq < nq)
      dq[b * dqs.b + gq * dqs.n + h * dqs.h + e] = acc[r * lda + e] * scale;
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
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias,
                   const float* __restrict__ g, float* __restrict__ dk,
                   float* __restrict__ dv, const float* __restrict__ stats,
                   int batch, int nq, int nk, int heads, int d, Strides qs,
                   Strides ks, Strides vs, long long bias_sb, Strides gs,
                   Strides dks, Strides dvs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = d + 1, lda = d + 4;
  const Plan P(d, true);
  float* q_t = at(smem, P.q);
  float* g_t = at(smem, P.g);
  float* k_t = at(smem, P.k);
  float* v_t = at(smem, P.v);
  float* s_t = at(smem, P.s);
  float* dp_t = at(smem, P.dp);
  float* dk_acc = at(smem, P.acc);
  float* dv_acc = at(smem, P.acc2);
  float* bias_t = at(smem, P.bias);
  float* st_t = at(smem, P.stats);   // [3][64]: m, l, dsum
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const long long plane = static_cast<long long>(batch) * heads * nq;
  const float* srow = stats + (static_cast<long long>(b) * heads + h) * nq;

  load_tile(k_t, k, ks, b, h, k0, nk, d);
  load_tile(v_t, v, vs, b, h, k0, nk, d);
  for (int j = threadIdx.x; j < kB; j += kThreads)
    bias_t[j] = (k0 + j < nk && bias != nullptr) ? bias[b * bias_sb + k0 + j]
                                                 : 0.f;
  for (int idx = threadIdx.x; idx < kB * lda; idx += kThreads) {
    dk_acc[idx] = 0.f;
    dv_acc[idx] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kB) {
    __syncthreads();
    load_tile(q_t, q, qs, b, h, q0, nq, d);
    load_tile(g_t, g, gs, b, h, q0, nq, d);
    for (int j = threadIdx.x; j < kB; j += kThreads) {
      const bool ok = q0 + j < nq;
      st_t[j] = ok ? srow[q0 + j] : 0.f;
      st_t[kB + j] = ok ? srow[plane + q0 + j] : 1.f;
      st_t[2 * kB + j] = ok ? srow[2 * plane + q0 + j] : 0.f;
    }
    __syncthreads();
    mm_nt(s_t, k_t, q_t, ldt, d);     // S^T [keys, queries]
    mm_nt(dp_t, v_t, g_t, ldt, d);    // dP^T
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
      s_t[kr * kLdS + qc] = ds;
      dp_t[kr * kLdS + qc] = p;
    }
    __syncthreads();
    mm_nn_acc(dk_acc, lda, s_t, q_t, ldt, d);
    mm_nn_acc(dv_acc, lda, dp_t, g_t, ldt, d);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gk = k0 + r;
    if (gk < nk) {
      dk[b * dks.b + gk * dks.n + h * dks.h + e] = dk_acc[r * lda + e] * scale;
      dv[b * dvs.b + gk * dvs.n + h * dvs.h + e] = dv_acc[r * lda + e];
    }
  }
}

inline size_t smem_bytes(int d) {
  const size_t a = Plan(d, false).total;
  const size_t b = Plan(d, true).total;
  return a > b ? a : b;
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t s1 = Plan(a.d, false).total;
  const size_t s2 = Plan(a.d, true).total;
  cudaError_t e;
  if ((e = set_smem(attention_bwd_dq, s1)) != cudaSuccess) return e;
  if ((e = set_smem(attention_bwd_dkdv, s2)) != cudaSuccess) return e;
  const float* bias = static_cast<const float*>(a.bias);
  float* stats = static_cast<float*>(a.stats);
  auto k1 = attention_bwd_dq;
  auto k2 = attention_bwd_dkdv;
  k1<<<dim3((a.nq + kB - 1) / kB, a.h, a.b), kThreads, s1, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), bias, static_cast<const float*>(a.g),
      static_cast<float*>(a.dq), stats, a.b, a.nq, a.nk, a.h, a.d, a.qs,
      a.ks, a.vs, a.bias_sb, a.gs, a.dqs, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k2<<<dim3((a.nk + kB - 1) / kB, a.h, a.b), kThreads, s2, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), bias, static_cast<const float*>(a.g),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), stats, a.b,
      a.nq, a.nk, a.h, a.d, a.qs, a.ks, a.vs, a.bias_sb, a.gs, a.dks, a.dvs,
      a.scale);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Shared memory one block of the larger of the two launches needs, so the
// wrapper can refuse shapes that do not fit before launching.
extern "C" long long yat_attention_bwd_smem_bytes(int d, int dtype) {
  if (dtype == yat::kBFloat16)
    return static_cast<long long>(yat::attn::bwd_smem_bytes(d));
  return static_cast<long long>(f32::smem_bytes(d));
}

extern "C" int yat_attention_bwd_max_head_dim() { return kMaxD; }

// The bf16 launches at head dim d with 16-byte loads (vec) or not: out[0:4]
// launch 1's registers a thread, local (spill) bytes a thread, dynamic
// shared bytes and resident blocks per SM; out[4:8] launch 2's.
extern "C" int yat_attention_bwd_launch_info(int d, int vec,
                                             long long* out) {
  if (d > kMaxD || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::info(d, vec != 0, out));
}

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
  const Args a{q, k, v, bias, g, dq, dk, dv, stats, b, nq, nk, h, d,
               Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
               Strides{v_sb, v_sn, v_sh}, Strides{g_sb, g_sn, g_sh},
               Strides{dq_sb, dq_sn, dq_sh}, Strides{dk_sb, dk_sn, dk_sh},
               Strides{dv_sb, dv_sn, dv_sh}, bias_sb, scale};
  if (dtype == yat::kFloat32) return static_cast<int>(f32::launch(a, st));
  if (dtype == yat::kBFloat16) {
    // 16-byte loads when every row start of the inputs is 16-byte aligned
    const bool vec = yat::attn::bwd_vec_ok(d, a.qs, a.ks, a.vs, a.gs, q, k,
                                           v, g);
    return static_cast<int>(tc::launch(a, vec, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
