// The pieces of the bf16 attention backwards K2b (softmax_attention_bwd.cu)
// and K6b (flash_attention_bwd.cu), on the forward's mma.sync body
// (attention_tiles.cuh).  Both split the VJP into two launches without
// atomics (dq; then dk and dv), four warps of 16 rows each:
//
//   * a block keeps two [64, dp] tiles resident in shared memory (launch 1:
//     its queries' q and dO; launch 2: its keys' K and V) and walks the
//     other side's 64-row tiles through a two-stage cp.async ring (launch
//     1: K, V and the key bias; launch 2: q, dO and three fp32 values per
//     query);
//   * each warp's rows of the resident tiles are mma.sync A fragments, held
//     in registers where they fit (RowFrags) and re-read by ldmatrix where
//     they do not;
//   * every 64-row tile is walked in sub-steps of 8 kNS columns: the two
//     products (S = A B^T and dP) land in registers, the elementwise step
//     turns them into p and ds in registers, and these are packed to bf16
//     A fragments (pack_a) for the accumulating products (acc_rows), whose
//     B operand is the ring tile read transposed by ldmatrix; the fp32
//     accumulators stay in registers and are rounded once (store_rows);
//   * where the accumulators of a full head dim would not fit in registers
//     (K6b at D = 256), a block computes kOC of its kDC 16-wide output
//     chunks and blockIdx.x also picks the chunk group (the scores are then
//     formed once per group).
#pragma once

#include "attention_tiles.cuh"

namespace yat {
namespace attn {

// Shared memory of one backward block: two resident [64, ldt] bf16 tiles,
// then two ring stages, each two [64, ldt] tiles and 3 x 64 fp32 values.
struct BwdPlan {
  size_t tile, stage, total;
  __host__ __device__ explicit BwdPlan(const Layout& L) {
    tile = static_cast<size_t>(kBK) * L.ldt * sizeof(bf16);
    stage = 2 * tile + 3 * kBK * sizeof(float);
    total = 2 * tile + 2 * stage;
  }
};

inline size_t bwd_smem_bytes(int d) {
  return BwdPlan(Layout(16 * head_chunks(d))).total;
}

// Output chunks a block computes at kDC chunks of head dim: all of them up
// to D = 128; past that half, so that the accumulators fit in registers.
template <int kDC>
constexpr int bwd_out_chunks() { return kDC > 8 ? kDC / 2 : kDC; }

// 16-byte loads need D and every stride a multiple of 8 elements and
// 16-byte aligned base pointers
inline bool bwd_vec_ok(int d, Strides a, Strides b, Strides c, Strides e,
                       const void* pa, const void* pb, const void* pc,
                       const void* pe) {
  return vec_ok(d, a, b, c, pa, pb, pc) && vec_ok(d, e, e, e, pe, pe, pe);
}

// start copying the key bias of keys [k0, k0 + 64) (0 past nk, or when
// there is no bias)
__device__ __forceinline__ void issue_bias(float* dst, const float* bias,
                                           long long sb, int b, int k0,
                                           int nk) {
  for (int j = threadIdx.x; j < kBK; j += kThreads) {
    if (bias == nullptr) {
      dst[j] = 0.f;
    } else {
      const bool ok = k0 + j < nk;
      cp_async4(dst + j, ok ? bias + b * sb + k0 + j : bias, ok ? 4 : 0);
    }
  }
}

// A fragment of rows [r0, r0 + 16), head-dim chunk c, of a [64, ldt] tile
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile,
                                       int ldt, int r0, int c) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldsm_x4(a, tile + (r0 + mr + 8 * (mi & 1)) * ldt + 16 * c + 8 * (mi >> 1));
}

// A warp's 16 rows of a resident tile as A fragments: in registers with
// kHold, else re-read from shared memory at every use.
template <int kDC, bool kHold>
struct RowFrags {
  uint32_t f[kHold ? kDC : 1][4];
  const bf16* tile;
  int ldt, r0;

  __device__ __forceinline__ void init(const bf16* t, int ld, int r) {
    tile = t;
    ldt = ld;
    r0 = r;
    if constexpr (kHold) {
#pragma unroll
      for (int c = 0; c < kDC; ++c) ldsm_a(f[c], t, ld, r, c);
    }
  }

  __device__ __forceinline__ void get(uint32_t (&a)[4], int c) const {
    if constexpr (kHold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[c][i];
    } else {
      ldsm_a(a, tile, ldt, r0, c);
    }
  }
};

// s[16 x 8 kNS] = A[16 x 16 kDC] . B^T, B being rows [n0, n0 + 8 kNS) of
// a [64, ldt] tile (non-transposed ldmatrix); kNS even
template <int kDC, int kNS, class Frags>
__device__ __forceinline__ void rows_by_rows(float (&s)[kNS][4],
                                             const Frags& a_frags,
                                             const bf16* bt, int ldt,
                                             int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int j = 0; j < kNS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int c = 0; c < kDC; ++c) {
    uint32_t a[4];
    a_frags.get(a, c);
#pragma unroll
    for (int j = 0; j < kNS; j += 2) {
      uint32_t bk[4];
      ldsm_x4(bk, bt + (n0 + 8 * (j + (mi >> 1)) + mr) * ldt + 16 * c +
                      8 * (mi & 1));
      mma_bf16(s[j], a, bk[0], bk[1]);
      mma_bf16(s[j + 1], a, bk[2], bk[3]);
    }
  }
}

// x[16 x 8 kNS] in accumulator layout, rounded to bf16, as the A fragments
// of kNS / 2 products over 16 columns each
template <int kNS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[kNS / 2][4],
                                       const float (&x)[kNS][4]) {
#pragma unroll
  for (int kk = 0; kk < kNS / 2; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc[16 x 16 kOC] += A[16 x 8 kNS] . B, B being rows [k0, k0 + 8 kNS) and
// columns [col0, col0 + 16 kOC) of a row-major [64, ldt] tile (transposed
// ldmatrix)
template <int kOC, int kNS>
__device__ __forceinline__ void acc_rows(float (&acc)[2 * kOC][4],
                                         const uint32_t (&a)[kNS / 2][4],
                                         const bf16* bt, int ldt, int k0,
                                         int col0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kNS / 2; ++kk)
#pragma unroll
    for (int n = 0; n < 2 * kOC; n += 2) {
      uint32_t bv[4];
      ldsm_x4_t(bv, bt + (k0 + 16 * kk + 8 * (mi & 1) + mr) * ldt + col0 +
                        8 * (n + (mi >> 1)));
      mma_bf16(acc[n], a[kk], bv[0], bv[1]);
      mma_bf16(acc[n + 1], a[kk], bv[2], bv[3]);
    }
}

template <int kOC>
__device__ __forceinline__ void zero_acc(float (&acc)[2 * kOC][4]) {
#pragma unroll
  for (int n = 0; n < 2 * kOC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// A warp's accumulator rows [row0, row0 + 16) (output columns from col0),
// times mul, rounded to bf16 into a [N, H, D] slab; rows past ``rows`` and
// columns past d are not written
template <int kOC>
__device__ __forceinline__ void store_rows(bf16* dst, Strides st, int b,
                                           int h, int row0, int rows, int d,
                                           int col0,
                                           const float (&acc)[2 * kOC][4],
                                           float mul) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + gr + 8 * (e >> 1);
    if (r >= rows) continue;
    bf16* row = dst + b * st.b + r * st.n + h * st.h;
#pragma unroll
    for (int n = 0; n < 2 * kOC; ++n) {
      const int col = col0 + 8 * n + 2 * tq + (e & 1);
      if (col < d) row[col] = __float2bfloat16_rn(acc[n][e] * mul);
    }
  }
}

// Walk ``steps`` tiles through the two-stage ring: issue(i, stage) starts
// the copies of step i into a stage (the group it joins is committed
// here; copies the caller started before the walk join step 0's group),
// body(i, stage) computes on step i once its copies have landed.
template <class Issue, class Body>
__device__ __forceinline__ void ring_walk(int steps, Issue&& issue,
                                          Body&& body) {
  issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    const int stage = i & 1;
    if (i + 1 < steps) {
      issue(i + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(i, stage);
    // every warp is done with this stage before the next issue refills it
    __syncthreads();
  }
}

}  // namespace attn
}  // namespace yat
