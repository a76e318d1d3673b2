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
// 152 MB moved (0.045 ms at 3.35 TB/s).  Design:
//   * dq reduces over all keys and dk/dv over all queries, and blocks run in
//     no order, so the work is two launches with no atomics (results are
//     bit-reproducible), as the library's split.  One launch with per-key-
//     block dq partials reduced apart would write and re-read 16 fp32
//     [B, Nq, H, D] partials at this shape (1.2 GB, 0.36 ms of traffic):
//     1. one block per (64 queries, head, batch element): di of its rows
//        (written to an fp32 scratch [B, H, N_q] for launch 2), then a walk
//        over 64-key tiles: S = q k^T, dP = dO v^T, p and ds, dq += ds_c k;
//     2. one block per (64 keys, head, batch element): a walk over 64-query
//        tiles: S^T = k q^T, dP^T = v dO^T, p and ds, dv += p_c^T dO,
//        dk += ds_c^T q;
//     so S and dP are formed twice: seven products where the VJP needs five;
//   * bf16 (the training path) on the body of attention_bwd_tiles.cuh: all
//     products with mma.sync m16n8k16 (fp32 accumulation), operands by
//     ldmatrix, the resident side's fragments, the score and dP tiles, p,
//     ds and the accumulators in registers, the streamed side through a
//     two-stage cp.async ring; no score reaches shared or device memory.
//     Launch 1 walks each key tile in 32-key sub-steps and holds q and dO
//     as fragments up to D = 128; launch 2 walks 16-query sub-steps and
//     holds K and V up to D = 80 (registers: ptxas's log in chip_smoke.py's
//     build phase).  At D = 256 each block computes half of the output's
//     head dim (bwd_out_chunks), forming S and dP for both halves;
//   * the ragged edges (N_k or N_q not a multiple of 64) are zero-filled
//     tiles whose p and ds are set to 0, so no length needs padding; fully
//     masked rows carry the finite mask value, as in the library;
//   * fp32: tiles of 64 rows (32 past D = 72) with every operand, the score
//     and dP tiles and the accumulators in shared memory, products on the
//     CUDA cores (the first design; no training path runs it).
// Faster (wgmma and TMA, a producer warp) is later work.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_bwd_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using yat::attn::Strides;
using yat::attn::set_smem;

constexpr int kMaxD = 256;

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

struct Args {
  const void *q, *k, *v, *bias, *o, *g, *m, *l;
  void *di, *dq, *dk, *dv;
  int b, nq, nk, h, d;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  long long bias_sb;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync, registers)
// ---------------------------------------------------------------------------
namespace tc {

using namespace yat::attn;

// Launch 1: di of the block's queries, then dq over every key tile.
template <bool kVec, int kDC, int kOC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  const bf16* __restrict__ o, const bf16* __restrict__ g,
                  const float* __restrict__ res_m,
                  const float* __restrict__ res_l, float* __restrict__ di_out,
                  bf16* __restrict__ dq, int nq, int nk, int d, Strides qs,
                  Strides ks, Strides vs, long long bias_sb, Strides os,
                  Strides gs, Strides dqs, float scale) {
  constexpr bool kHold = kDC <= 8;   // q and dO fragments in registers
  constexpr int kNS = 4;             // 32 keys a sub-step
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(16 * kDC);
  const BwdPlan P(L);
  bf16* q_t = reinterpret_cast<bf16*>(smem);
  bf16* g_t = q_t + kBQ * L.ldt;
  unsigned char* ring = smem + 2 * P.tile;
  const int ncol = kDC / kOC;
  const int cg = blockIdx.x % ncol;
  const int col0 = 16 * kOC * cg;
  const int q0 = (blockIdx.x / ncol) * kBQ;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const int gr = lane >> 2, tq = lane & 3;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * nq;

  issue_bf16_tile<kVec>(q_t, q, qs, b, h, q0, nq, d, L);
  issue_bf16_tile<kVec>(g_t, g, gs, b, h, q0, nq, d, L);
  auto issue = [&](int i, int stage) {
    bf16* k_s = reinterpret_cast<bf16*>(ring + stage * P.stage);
    issue_bf16_tile<kVec>(k_s, k, ks, b, h, i * kBK, nk, d, L);
    issue_bf16_tile<kVec>(k_s + kBK * L.ldt, v, vs, b, h, i * kBK, nk, d, L);
    issue_bias(reinterpret_cast<float*>(k_s + 2 * kBK * L.ldt), bias,
               bias_sb, b, i * kBK, nk);
  };

  // while the first tiles land: di = rowsum(o * dO) in fp32 for the warp's
  // 16 rows (a warp-wide sum each), m and 1/l; lane 4 gr + tq keeps those
  // of rows gr and gr + 8
  float m[2], linv[2], di[2];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gq = q0 + r0 + i;
    float sum = 0.f;
    if (gq < nq) {
      const bf16* orow = o + b * os.b + gq * os.n + h * os.h;
      const bf16* grow = g + b * gs.b + gq * gs.n + h * gs.h;
      for (int e = lane; e < d; e += 32)
        sum += __bfloat162float(orow[e]) * __bfloat162float(grow[e]);
    }
    sum = yat::warp_sum(sum);
    if (i == gr) di[0] = sum;
    if (i == gr + 8) di[1] = sum;
    if (lane == 0 && cg == 0 && gq < nq) di_out[row0 + gq] = sum;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int gq = q0 + r0 + gr + 8 * hf;
    m[hf] = gq < nq ? res_m[row0 + gq] : 0.f;
    linv[hf] = gq < nq ? 1.f / res_l[row0 + gq] : 0.f;
  }

  RowFrags<kDC, kHold> qa, ga;
  float acc[2 * kOC][4];
  zero_acc<kOC>(acc);
  ring_walk((nk + kBK - 1) / kBK, issue, [&](int i, int stage) {
    if (i == 0) {
      qa.init(q_t, L.ldt, r0);
      ga.init(g_t, L.ldt, r0);
    }
    const bf16* k_s = reinterpret_cast<const bf16*>(ring + stage * P.stage);
    const bf16* v_s = k_s + kBK * L.ldt;
    const float* bias_s = reinterpret_cast<const float*>(v_s + kBK * L.ldt);
    const int k0 = i * kBK;
    for (int c0 = 0; c0 < kBK && k0 + c0 < nk; c0 += 8 * kNS) {
      float sc[kNS][4], dp[kNS][4];
      rows_by_rows<kDC, kNS>(sc, qa, k_s, L.ldt, c0);   // S [queries, keys]
      rows_by_rows<kDC, kNS>(dp, ga, v_s, L.ldt, c0);   // dP
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          const int hf = e >> 1;
          float p = 0.f, ds = 0.f;
          if (k0 + col < nk)
            p_ds(sc[j][e], dp[j][e], bias_s[col], m[hf], linv[hf], di[hf],
                 scale, p, ds);
          sc[j][e] = ds;
        }
      uint32_t a[kNS / 2][4];
      pack_a<kNS>(a, sc);
      acc_rows<kOC, kNS>(acc, a, k_s, L.ldt, c0, col0);   // dq += ds_c k
    }
  });
  store_rows<kOC>(dq, dqs, b, h, q0 + r0, nq, d, col0, acc, 1.f);
}

// Launch 2: dk and dv for 64 keys, walking the query tiles.
template <bool kVec, int kDC, int kOC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ bias,
                    const bf16* __restrict__ g,
                    const float* __restrict__ res_m,
                    const float* __restrict__ res_l,
                    const float* __restrict__ di, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int nq, int nk, int d, Strides qs,
                    Strides ks, Strides vs, long long bias_sb, Strides gs,
                    Strides dks, Strides dvs, float scale) {
  constexpr bool kHold = kDC <= 5;   // K and V fragments in registers
  constexpr int kNS = 2;             // 16 queries a sub-step
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(16 * kDC);
  const BwdPlan P(L);
  bf16* k_t = reinterpret_cast<bf16*>(smem);
  bf16* v_t = k_t + kBK * L.ldt;
  unsigned char* ring = smem + 2 * P.tile;
  const int ncol = kDC / kOC;
  const int cg = blockIdx.x % ncol;
  const int col0 = 16 * kOC * cg;
  const int k0 = (blockIdx.x / ncol) * kBK;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;
  const int gr = lane >> 2, tq = lane & 3;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * nq;

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
  // m, 1/l and di of a query tile's 64 rows: thread j < 64 holds m and l
  // of query j, thread 64 + j its di; loaded one step ahead into registers
  // and stored to the stage (1/l taken there) after the current step
  const int rj = threadIdx.x & (kBK - 1);
  const bool second = threadIdx.x >= kBK;
  float pre0 = 0.f, pre1 = 1.f;
  auto load_rows = [&](int i) {
    const int gq = i * kBQ + rj;
    const bool ok = gq < nq;
    pre0 = ok ? (second ? di[row0 + gq] : res_m[row0 + gq]) : 0.f;
    pre1 = ok && !second ? res_l[row0 + gq] : 1.f;
  };
  auto store_rows_to = [&](int stage) {
    float* rv = reinterpret_cast<float*>(ring + stage * P.stage + 2 * P.tile);
    if (second) {
      rv[2 * kBQ + rj] = pre0;
    } else {
      rv[rj] = pre0;
      rv[kBQ + rj] = 1.f / pre1;
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
  float dka[2 * kOC][4], dva[2 * kOC][4];
  zero_acc<kOC>(dka);
  zero_acc<kOC>(dva);
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
          if (kin[hf] && q0 + col < nq)
            p_ds(sc[j][e], dp[j][e], kb[hf], rv[col], rv[kBQ + col],
                 rv[2 * kBQ + col], scale, p, ds);
          sc[j][e] = p;
          dp[j][e] = ds;
        }
      uint32_t pa[kNS / 2][4], da[kNS / 2][4];
      pack_a<kNS>(pa, sc);
      pack_a<kNS>(da, dp);
      acc_rows<kOC, kNS>(dva, pa, g_s, L.ldt, c0, col0);   // dv += p_c^T dO
      acc_rows<kOC, kNS>(dka, da, q_s, L.ldt, c0, col0);   // dk += ds_c^T q
    }
    if (i + 1 < steps) store_rows_to(stage ^ 1);
  });
  store_rows<kOC>(dk, dks, b, h, k0 + r0, nk, d, col0, dka, 1.f);
  store_rows<kOC>(dv, dvs, b, h, k0 + r0, nk, d, col0, dva, 1.f);
}

template <bool kVec, int kDC>
struct Kernels {
  static constexpr int kOC = bwd_out_chunks<kDC>();
  static auto dq() { return flash_bwd_dq_bf16<kVec, kDC, kOC>; }
  static auto dkdv() { return flash_bwd_dkdv_bf16<kVec, kDC, kOC>; }
};

template <bool kVec, int kDC>
cudaError_t launch_chunks(const Args& a, cudaStream_t stream) {
  using K = Kernels<kVec, kDC>;
  const int ncol = kDC / K::kOC;
  const size_t smem = bwd_smem_bytes(a.d);
  auto k1 = K::dq();
  auto k2 = K::dkdv();
  cudaError_t e;
  if ((e = set_smem(k1, smem)) != cudaSuccess) return e;
  if ((e = set_smem(k2, smem)) != cudaSuccess) return e;
  const float* bias = static_cast<const float*>(a.bias);
  const float* m = static_cast<const float*>(a.m);
  const float* l = static_cast<const float*>(a.l);
  k1<<<dim3((a.nq + kBQ - 1) / kBQ * ncol, a.h, a.b), kThreads, smem,
       stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), bias, static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.g), m, l, static_cast<float*>(a.di),
      static_cast<bf16*>(a.dq), a.nq, a.nk, a.d, a.qs, a.ks, a.vs, a.bias_sb,
      a.os, a.gs, a.dqs, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k2<<<dim3((a.nk + kBK - 1) / kBK * ncol, a.h, a.b), kThreads, smem,
       stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), bias, static_cast<const bf16*>(a.g), m,
      l, static_cast<const float*>(a.di), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.nq, a.nk, a.d, a.qs, a.ks, a.vs, a.bias_sb,
      a.gs, a.dks, a.dvs, a.scale);
  return cudaGetLastError();
}

// Registers, local (spill) bytes, dynamic shared bytes and resident blocks
// per SM of both launches at head dim d, four values each.
template <bool kVec, int kDC>
cudaError_t info_chunks(int d, long long* out) {
  using K = Kernels<kVec, kDC>;
  const size_t smem = bwd_smem_bytes(d);
  const cudaError_t e = launch_info(K::dq(), smem, out);
  return e != cudaSuccess ? e : launch_info(K::dkdv(), smem, out + 4);
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
    YAT_BWD_CHUNKS(launch_chunks, 16, vec, a, stream)
  }
  return cudaErrorInvalidValue;
}

cudaError_t info(int d, bool vec, long long* out) {
  switch (head_chunks(d)) {
    YAT_BWD_CHUNKS(info_chunks, 2, vec, d, out)
    YAT_BWD_CHUNKS(info_chunks, 4, vec, d, out)
    YAT_BWD_CHUNKS(info_chunks, 5, vec, d, out)
    YAT_BWD_CHUNKS(info_chunks, 8, vec, d, out)
    YAT_BWD_CHUNKS(info_chunks, 16, vec, d, out)
  }
  return cudaErrorInvalidValue;
}
#undef YAT_BWD_CHUNKS

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores (shared-memory tiles and accumulators)
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 128;   // 4 warps
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline size_t bump(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 127) & ~static_cast<size_t>(127);
  return at;
}

// Shared-memory plan of one block of kB-row tiles, in byte offsets.  Launch
// 1 (dq) uses q, g, k, v, s, dp and acc; launch 2 (dk, dv) also a second
// accumulator.  ds and p overwrite s and dp in place.
template <int kB>
struct Plan {
  static constexpr int kLdS = kB + 8;   // row stride of the [kB, kB] tiles
  size_t q, g, k, v, s, dp, acc, acc2, bias, rows, total;
  __host__ __device__ Plan(int d, bool dkdv) {
    const size_t tile = static_cast<size_t>(kB) * (d + 1) * sizeof(float);
    const size_t sq = static_cast<size_t>(kB) * kLdS;
    const size_t accb = static_cast<size_t>(kB) * (d + 4) * sizeof(float);
    size_t o = 0;
    q = bump(o, tile);
    g = bump(o, tile);
    k = bump(o, tile);
    v = bump(o, tile);
    s = bump(o, sq * sizeof(float));
    dp = bump(o, sq * sizeof(float));
    acc = bump(o, accb);
    acc2 = dkdv ? bump(o, accb) : acc;
    bias = bump(o, kB * sizeof(float));
    rows = bump(o, 3 * kB * sizeof(float));   // m, 1/l, di of kB queries
    total = o;
  }
};

// rows [row0, row0 + kB) of a [N, H, D] slab into a [kB, d] tile (rows at
// or past ``rows`` are zero)
template <int kB>
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

// C[kB, kB] (row stride ldc) = A[kB, kdim] B[kB, kdim]^T, A and B with row
// stride ld: thread t computes rows (t / 8) * kB/16 + i and columns
// t % 8 + 8 j
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

// C[kB, ncols] (row stride ldc) += A[kB, kB] (row stride lda) B[kB, ncols]
// (row stride ldb)
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

__device__ __forceinline__ float* at(unsigned char* base, size_t off) {
  return reinterpret_cast<float*>(base + off);
}

// Launch 1: di of the block's queries, then dq.
template <int kB>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             const float* __restrict__ o, const float* __restrict__ g,
             const float* __restrict__ res_m, const float* __restrict__ res_l,
             float* __restrict__ di_out, float* __restrict__ dq, int nq,
             int nk, int d, Strides qs, Strides ks, Strides vs,
             long long bias_sb, Strides os, Strides gs, Strides dqs,
             float scale) {
  using P = Plan<kB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = d + 1, lda = d + 4;
  const P pl(d, false);
  float* q_t = at(smem, pl.q);
  float* g_t = at(smem, pl.g);
  float* k_t = at(smem, pl.k);
  float* v_t = at(smem, pl.v);
  float* s_t = at(smem, pl.s);
  float* dp_t = at(smem, pl.dp);
  float* acc = at(smem, pl.acc);
  float* bias_t = at(smem, pl.bias);
  float* m_t = at(smem, pl.rows);
  float* linv_t = m_t + kB;
  float* di_t = m_t + 2 * kB;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * nq;

  load_tile<kB>(q_t, q, qs, b, h, q0, nq, d);
  load_tile<kB>(g_t, g, gs, b, h, q0, nq, d);
  for (int idx = threadIdx.x; idx < kB * lda; idx += kThreads) acc[idx] = 0.f;
  // di = rowsum(o * dO) in fp32, one warp per row; m and 1/l
  for (int r = warp; r < kB; r += kThreads / 32) {
    const int gq = q0 + r;
    float sum = 0.f;
    if (gq < nq) {
      const float* orow = o + b * os.b + gq * os.n + h * os.h;
      const float* grow = g + b * gs.b + gq * gs.n + h * gs.h;
      for (int e = lane; e < d; e += 32) sum += orow[e] * grow[e];
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
    load_tile<kB>(k_t, k, ks, b, h, k0, nk, d);
    load_tile<kB>(v_t, v, vs, b, h, k0, nk, d);
    for (int j = threadIdx.x; j < kB; j += kThreads)
      bias_t[j] = (k0 + j < nk && bias != nullptr) ? bias[b * bias_sb + k0 + j]
                                                   : 0.f;
    __syncthreads();
    mm_nt<kB>(s_t, P::kLdS, q_t, k_t, ldt, d);     // S [queries, keys]
    mm_nt<kB>(dp_t, P::kLdS, g_t, v_t, ldt, d);    // dP
    __syncthreads();
    for (int idx = threadIdx.x; idx < kB * kB; idx += kThreads) {
      const int r = idx / kB;
      const int c = idx - r * kB;
      float p = 0.f, ds = 0.f;
      if (q0 + r < nq && k0 + c < nk)
        p_ds(s_t[r * P::kLdS + c], dp_t[r * P::kLdS + c], bias_t[c], m_t[r],
             linv_t[r], di_t[r], scale, p, ds);
      s_t[r * P::kLdS + c] = ds;
    }
    __syncthreads();
    mm_nn_acc<kB>(acc, lda, s_t, P::kLdS, k_t, ldt, d);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gq = q0 + r;
    if (gq < nq) dq[b * dqs.b + gq * dqs.n + h * dqs.h + e] = acc[r * lda + e];
  }
}

// Launch 2: dk and dv for kB keys, walking the query tiles.
template <int kB>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ g, const float* __restrict__ res_m,
               const float* __restrict__ res_l, const float* __restrict__ di,
               float* __restrict__ dk, float* __restrict__ dv, int nq, int nk,
               int d, Strides qs, Strides ks, Strides vs, long long bias_sb,
               Strides gs, Strides dks, Strides dvs, float scale) {
  using P = Plan<kB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = d + 1, lda = d + 4;
  const P pl(d, true);
  float* q_t = at(smem, pl.q);
  float* g_t = at(smem, pl.g);
  float* k_t = at(smem, pl.k);
  float* v_t = at(smem, pl.v);
  float* s_t = at(smem, pl.s);
  float* dp_t = at(smem, pl.dp);
  float* dk_acc = at(smem, pl.acc);
  float* dv_acc = at(smem, pl.acc2);
  float* bias_t = at(smem, pl.bias);
  float* m_t = at(smem, pl.rows);
  float* linv_t = m_t + kB;
  float* di_t = m_t + 2 * kB;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * nq;

  load_tile<kB>(k_t, k, ks, b, h, k0, nk, d);
  load_tile<kB>(v_t, v, vs, b, h, k0, nk, d);
  for (int j = threadIdx.x; j < kB; j += kThreads)
    bias_t[j] = (k0 + j < nk && bias != nullptr) ? bias[b * bias_sb + k0 + j]
                                                 : 0.f;
  for (int idx = threadIdx.x; idx < kB * lda; idx += kThreads) {
    dk_acc[idx] = 0.f;
    dv_acc[idx] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kB) {
    __syncthreads();
    load_tile<kB>(q_t, q, qs, b, h, q0, nq, d);
    load_tile<kB>(g_t, g, gs, b, h, q0, nq, d);
    for (int j = threadIdx.x; j < kB; j += kThreads) {
      const bool ok = q0 + j < nq;
      m_t[j] = ok ? res_m[row0 + q0 + j] : 0.f;
      linv_t[j] = ok ? 1.f / res_l[row0 + q0 + j] : 0.f;
      di_t[j] = ok ? di[row0 + q0 + j] : 0.f;
    }
    __syncthreads();
    mm_nt<kB>(s_t, P::kLdS, k_t, q_t, ldt, d);     // S^T [keys, queries]
    mm_nt<kB>(dp_t, P::kLdS, v_t, g_t, ldt, d);    // dP^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < kB * kB; idx += kThreads) {
      const int kr = idx / kB;
      const int qc = idx - kr * kB;
      float p = 0.f, ds = 0.f;
      if (k0 + kr < nk && q0 + qc < nq)
        p_ds(s_t[kr * P::kLdS + qc], dp_t[kr * P::kLdS + qc], bias_t[kr],
             m_t[qc], linv_t[qc], di_t[qc], scale, p, ds);
      s_t[kr * P::kLdS + qc] = ds;
      dp_t[kr * P::kLdS + qc] = p;
    }
    __syncthreads();
    mm_nn_acc<kB>(dv_acc, lda, dp_t, P::kLdS, g_t, ldt, d);
    mm_nn_acc<kB>(dk_acc, lda, s_t, P::kLdS, q_t, ldt, d);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kB * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gk = k0 + r;
    if (gk < nk) {
      dk[b * dks.b + gk * dks.n + h * dks.h + e] = dk_acc[r * lda + e];
      dv[b * dvs.b + gk * dvs.n + h * dvs.h + e] = dv_acc[r * lda + e];
    }
  }
}

// The tile rows: 64 where both launches' plans fit, else 32.
inline int tile_rows(int d) {
  return Plan<64>(d, true).total <= kMaxSmem ? 64 : 32;
}

inline size_t smem_bytes(int d) {
  return tile_rows(d) == 64 ? Plan<64>(d, true).total
                            : Plan<32>(d, true).total;
}

template <int kB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t s1 = Plan<kB>(a.d, false).total;
  const size_t s2 = Plan<kB>(a.d, true).total;
  if (s2 > kMaxSmem) return cudaErrorInvalidValue;
  auto k1 = flash_bwd_dq<kB>;
  auto k2 = flash_bwd_dkdv<kB>;
  cudaError_t e;
  if ((e = set_smem(k1, s1)) != cudaSuccess) return e;
  if ((e = set_smem(k2, s2)) != cudaSuccess) return e;
  const float* bias = static_cast<const float*>(a.bias);
  const float* m = static_cast<const float*>(a.m);
  const float* l = static_cast<const float*>(a.l);
  k1<<<dim3((a.nq + kB - 1) / kB, a.h, a.b), kThreads, s1, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), bias, static_cast<const float*>(a.o),
      static_cast<const float*>(a.g), m, l, static_cast<float*>(a.di),
      static_cast<float*>(a.dq), a.nq, a.nk, a.d, a.qs, a.ks, a.vs,
      a.bias_sb, a.os, a.gs, a.dqs, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k2<<<dim3((a.nk + kB - 1) / kB, a.h, a.b), kThreads, s2, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), bias, static_cast<const float*>(a.g), m,
      l, static_cast<const float*>(a.di), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.nq, a.nk, a.d, a.qs, a.ks, a.vs,
      a.bias_sb, a.gs, a.dks, a.dvs, a.scale);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Shared memory one block of the larger launch needs, so the wrapper can
// refuse shapes that do not fit before launching.
extern "C" long long yat_flash_attention_bwd_smem_bytes(int d, int dtype) {
  if (dtype == yat::kBFloat16)
    return static_cast<long long>(yat::attn::bwd_smem_bytes(d));
  return static_cast<long long>(f32::smem_bytes(d));
}

extern "C" int yat_flash_attention_bwd_max_head_dim() { return kMaxD; }

// The bf16 launches at head dim d with 16-byte loads (vec) or not: out[0:4]
// launch 1's registers a thread, local (spill) bytes a thread, dynamic
// shared bytes and resident blocks per SM; out[4:8] launch 2's.
extern "C" int yat_flash_attention_bwd_launch_info(int d, int vec,
                                                   long long* out) {
  if (d > kMaxD || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::info(d, vec != 0, out));
}

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
    auto run = f32::tile_rows(d) == 64 ? f32::launch<64> : f32::launch<32>;
    return static_cast<int>(run(a, st));
  }
  if (dtype == yat::kBFloat16) {
    // 16-byte loads when every row start of the tiled inputs is 16-byte
    // aligned
    const bool vec = yat::attn::bwd_vec_ok(d, a.qs, a.ks, a.vs, a.gs, q, k,
                                           v, g);
    return static_cast<int>(tc::launch(a, vec, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
