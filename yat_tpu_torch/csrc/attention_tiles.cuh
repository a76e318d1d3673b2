// The softmax-attention forward shared by kernels K2 (softmax_attention.cu)
// and K6 (flash_attention.cu), q/k/v read as [B, N, H, D] through strides,
// the ragged key edge zero-filled and masked.
//
// Both dtypes walk the keys in "key blocks" of ``block_keys`` keys (a
// multiple of 64 unless it covers every key), each in two passes over its
// 64-key tiles: pass 1 finds each row's max and exp-sum over the block,
// pass 2 recomputes the scores and accumulates P.V.  With one block (K2,
// and K6 when N_k fits one library block) P is normalised before it is
// rounded and multiplied, as in K2's plain version and the library's
// single-step kernel; with several (K6 at long N_k) the running max moves
// from block to block, P is rounded unnormalised, the accumulator is
// rescaled at each block start and divided by the running sum at the end,
// as in the library flash kernel.  Only tiles live in shared memory, so
// every key count the shape gates admit fits.
//
// * bf16 (attention_bf16_block): one block per (128 queries, head, batch
//   element), eight warps of 16 query rows; both products on the tensor
//   cores with mma.sync m16n8k16, operands fetched by ldmatrix (V
//   transposed on the way), the scores, P and the accumulator in
//   registers; K and V through a cp.async ring of three stages (two past
//   D = 80) with one barrier per tile; the 64-key tiles whose keys are all
//   masked are never walked; the head dim zero-padded in shared memory to
//   16 x a compiled chunk count;
// * fp32 (attention_fwd_f32): one block per (64 queries, head, batch
//   element) on the CUDA cores, four warps, P never rounded, every tile
//   walked.
//
// When ``res_m``/``res_l`` are not null (K6 under autograd), each query
// row's final running max and exp-sum go there as fp32 [B, H, N_q]: the
// residuals of the flash backward (K6b).  K2 and serving pass null.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace yat {
namespace attn {

constexpr int kBQ = 64;               // queries per block (fp32, backwards)
constexpr int kBK = 64;               // keys per shared-memory tile
constexpr int kRows = 16;             // query rows per warp
constexpr int kWarps = kBQ / kRows;
constexpr int kThreads = kWarps * 32;

struct Strides {
  long long b, n, h;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// 16-byte loads need D and every stride a multiple of 8 bf16 elements and
// 16-byte aligned base pointers
inline bool vec_ok(int d, Strides a, Strides b, Strides c, const void* pa,
                   const void* pb, const void* pc) {
  auto ok = [](Strides s) { return s.b % 8 == 0 && s.n % 8 == 0 && s.h % 8 == 0; };
  return d % 8 == 0 && ok(a) && ok(b) && ok(c) &&
         reinterpret_cast<uintptr_t>(pa) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(pb) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(pc) % 16 == 0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

struct Layout {                           // shared-memory tile layout
  int dp, ldt;
  __host__ __device__ explicit Layout(int d) {
    dp = (d + 15) & ~15;                  // head dim padded to 16
    ldt = dp + 8;                         // row stride: ldmatrix rows of
  }                                       // 8 lanes fall in distinct banks
};

// rows [row0, row0 + nrows) of a [N, H, D] slab into a zero-padded bf16
// tile (rows at or past ``rows`` are zero) by nthr threads; kVec: 16-byte
// loads
template <bool kVec>
__device__ __forceinline__ void load_bf16_tile(bf16* dst, const bf16* src,
                                               Strides st, int b, int h,
                                               int row0, int rows, int d,
                                               const Layout& L,
                                               int nrows = kBK,
                                               int nthr = kThreads) {
  if (kVec) {
    const int cpr = L.dp / 8;
    for (int idx = threadIdx.x; idx < nrows * cpr; idx += nthr) {
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
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int idx = threadIdx.x; idx < nrows * L.dp; idx += nthr) {
      const int r = idx / L.dp;
      const int e = idx - r * L.dp;
      const int gr = row0 + r;
      dst[r * L.ldt + e] = (gr < rows && e < d)
          ? src[b * st.b + gr * st.n + h * st.h + e] : zero;
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory, one row address per lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-wide chunks of the padded head dim: the instantiated paddings
inline int head_chunks(int d) {
  return d <= 32 ? 2 : d <= 64 ? 4 : d <= 80 ? 5 : d <= 128 ? 8 : 16;
}

// asynchronous copies to shared memory (sm_80+): src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Start copying rows [row0, row0 + nrows) of a [N, H, D] slab into a
// zero-padded bf16 tile by nthr threads: 16-byte cp.async with kVec, else
// the synchronous element loads of load_bf16_tile.
template <bool kVec>
__device__ __forceinline__ void issue_bf16_tile(bf16* dst, const bf16* src,
                                                Strides st, int b, int h,
                                                int row0, int rows, int d,
                                                const Layout& L,
                                                int nrows = kBK,
                                                int nthr = kThreads) {
  if (kVec) {
    const int cpr = L.dp / 8;
    for (int idx = threadIdx.x; idx < nrows * cpr; idx += nthr) {
      const int r = idx / cpr;
      const int e = (idx - r * cpr) * 8;
      const int gr = row0 + r;
      const bool ok = gr < rows && e < d;
      cp_async16(dst + r * L.ldt + e,
                 ok ? src + b * st.b + gr * st.n + h * st.h + e : src,
                 ok ? 16 : 0);
    }
  } else {
    load_bf16_tile<false>(dst, src, st, b, h, row0, rows, d, L, nrows, nthr);
  }
}

// 2^x on the special-function unit; results below the smallest normal
// float are flushed to 0
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// e^x as 2^(x log2 e): both passes and the block merges take it, so the
// probabilities are normalised by the sum of the very values they hold
__device__ __forceinline__ float exp_sfu(float x) {
  return ex2_approx(__fmul_rn(x, kLog2e));
}

// Registers a thread, local (spill) bytes a thread, dynamic shared bytes
// and resident blocks per SM of one launch of ``threads`` threads, into
// out[0:4]
template <typename K>
cudaError_t launch_info(K kernel, size_t smem, long long* out,
                        int threads = kThreads) {
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    threads, smem);
  if (e != cudaSuccess) return e;
  out[0] = fa.numRegs;
  out[1] = static_cast<long long>(fa.localSizeBytes);
  out[2] = static_cast<long long>(smem);
  out[3] = blocks;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The bf16 forward body (K2, K4 and K6)
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 256;   // eight warps of 16 query rows
constexpr int kFwdBQ = kFwdThreads / 2;  // 128 queries a block
constexpr int kFwdFlags = 1024;    // key tiles with a kept flag (N_k <= 65,536;
                                   // later tiles are always walked)

// ring stages at kDC 16-wide head-dim chunks: three up to D = 80, two past
// it (so that two blocks share an SM at D = 128 and one fits at D = 256)
__host__ __device__ constexpr int fwd_stages(int dc) { return dc <= 5 ? 3 : 2; }
// resident blocks per SM the launch bound asks ptxas for: one past D = 128
// and with element loads (kVec false: unaligned rows, off the main paths),
// whose address arithmetic would otherwise spill under two
__host__ __device__ constexpr int fwd_min_blocks(int dc, bool vec) {
  return vec && dc <= 8 ? 2 : 1;
}
// the queries' A fragments held in registers up to D = 80, re-read from
// shared memory past it
__host__ __device__ constexpr bool fwd_q_regs(int dc) { return dc <= 5; }
// 8-key column tiles of a sub-step: 32 keys; 16 at D = 128, whose
// accumulators leave no room for more under the two-block launch bound
__host__ __device__ constexpr int fwd_sub_tiles(int dc) {
  return dc == 8 ? 2 : 4;
}

// Shared memory of a forward block: the kept flags of the key tiles, the
// [kFwdBQ, ldt] query tile, then the ring stages, each a K and a V tile
// [64, ldt] and 64 fp32 bias values.  Byte offsets.
struct FwdPlan {
  size_t q, ring, stage, total;
  __host__ __device__ FwdPlan(const Layout& L, int stages) {
    q = kFwdFlags;
    ring = q + static_cast<size_t>(kFwdBQ) * L.ldt * sizeof(bf16);
    stage = 2 * static_cast<size_t>(kBK) * L.ldt * sizeof(bf16) +
            kBK * sizeof(float);
    total = ring + stages * stage;
  }
};

inline size_t fwd_smem_bytes(int d) {
  const int dc = head_chunks(d);
  return FwdPlan(Layout(16 * dc), fwd_stages(dc)).total;
}

// the arguments of one forward launch; q [B, Nq, H, D], k/v [B, Nk, H, D],
// out [B, Nq, H, D] through strides; bias [B, Nk] fp32 or null; res_m/res_l
// fp32 [B, H, Nq] or null
struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;
  bf16* out;
  int b, nq, nk, h, d;
  Strides qs, ks, vs;
  long long bias_sb;
  Strides os;
  float scale;
  int block_keys;
  float* res_m;
  float* res_l;
};

// One 64-key tile of the walk: key block [blk0, blk1), pass 0 (row
// statistics) or 1 (P.V), first key k0.
struct Step {
  int blk0, blk1, pass, k0;
};

// The body of the bf16 forward kernels (K2's and K6's __global__ functions
// call it under their own names, so that a profile tells them apart).
// kDC: 16-wide chunks of the padded head dim; kBias: a key bias is given.
// A block holds kFwdBQ = 128 queries on kFwdThreads = 256 threads, 16 rows
// a warp.
//
// 1. The block reads its batch element's bias row once and flags the
//    64-key tiles that hold a kept key (a bias entry other than
//    ``mask_value``, the branch's mask: -1e9 for K2/K4, the library's
//    -0.7 FLT_MAX for K6).  Both passes walk only the flagged tiles.  This
//    is exact: with one kept key in the row, a masked key's
//    exp(z - max) underflows to 0, so it adds 0 to the sums and P.V, and a
//    key block with no flagged tile leaves the running max, sum and
//    accumulator as they are (a leading one would be wiped by the next
//    block's rescale by 0, a later one rescales by 1 and adds 0).  The one
//    condition: no kept key's |s * scale| comes within about 100 of the
//    mask's magnitude (1e9 for K2/K4).  A batch element with no kept key
//    walks every tile: the mask value is finite, so its rows take the
//    mean of V, as the library's do.  One key block or several
//    (``single``) follows from N_k and block_keys alone.
// 2. The walk's tiles (both passes of every key block) form one sequence
//    through a ring of fwd_stages(kDC) stages: cp.async fills the stage
//    the walk reaches fwd_stages - 1 tiles later, one barrier per tile.
// 3. Each tile goes in sub-steps of 32 keys (16 at D = 128): QK^T by
//    mma.sync into registers, z = fl(fl(s * scale) + bias) (the add only
//    with a bias, the ragged-key compare only on the last tile of a key
//    block), then pass 0 folds the sub-step into each thread's running
//    max and exp-sum, pass 1 forms P = exp(z - M) (divided by the row's
//    sum when one key block covers every key: a multiply by the
//    reciprocal and one FMA correction, the correctly rounded quotient
//    for normal results), packs it to bf16 A fragments and accumulates
//    P.V.
// 4. Each warp stages its rounded output rows in its own rows of the query
//    tile and stores them with 16-byte writes.
//
// Fragment layout (mma.sync m16n8k16): lane 4 g + t holds the elements
// (row g, columns 2t, 2t+1) and (row g + 8, the same columns) of each
// 16 x 8 accumulator, as c[0], c[1] and c[2], c[3]; "half" 0 is row g,
// half 1 row g + 8.  The score fragments of 16 keys are the A fragment of
// P for the P.V product, once packed to bf16.
//
// Against the plain versions the arithmetic differs in one place: e^x is
// 2^(x log2 e) on the special-function unit (ex2.approx, about 2 ulp),
// not expf; P is rounded to bf16 after it either way.
template <bool kVec, int kDC, bool kBias>
__device__ __forceinline__ void attention_bf16_block(
    const FwdArgs& a, float mask_value, unsigned char* smem_raw) {
  constexpr int kStages = fwd_stages(kDC);
  constexpr bool kQRegs = fwd_q_regs(kDC);
  constexpr int kNS = fwd_sub_tiles(kDC);
  const Layout L(16 * kDC);
  constexpr int nthr = kFwdThreads, bq = kFwdBQ;
  const FwdPlan plan(L, kStages);
  unsigned char* kept = smem_raw;                                // [kFwdFlags]
  bf16* q_t = reinterpret_cast<bf16*>(smem_raw + plan.q);       // [bq][ldt]
  auto k_tile = [&](int stage) {
    return reinterpret_cast<bf16*>(smem_raw + plan.ring + stage * plan.stage);
  };
  const int nk = a.nk, nq = a.nq, d = a.d, block_keys = a.block_keys;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * kRows;                // the warp's 16 query rows
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, row
  const bool single = block_keys >= nk;       // one key block
  const bool live = q0 + r0 < nq;             // the warp has a query

  // the queries' copy joins the first tile's group
  issue_bf16_tile<kVec>(q_t, a.q, a.qs, b, h, q0, nq, d, L, bq, nthr);

  // 1) kept[i]: key tile i holds a kept key
  int some = 0;
  if constexpr (kBias) {
    const float* row = a.bias + b * a.bias_sb;
    const int flagged = min((nk + kBK - 1) / kBK, kFwdFlags);
    for (int i = warp; i < flagged; i += nthr / 32) {
      const int j0 = i * kBK + lane, j1 = j0 + 32;
      const bool keep = (j0 < nk && row[j0] != mask_value) ||
                        (j1 < nk && row[j1] != mask_value);
      const int any = __any_sync(0xffffffffu, keep);
      if (lane == 0) kept[i] = static_cast<unsigned char>(any);
      some |= any;
    }
  }
  const bool walk_all = !__syncthreads_or(some);
  auto walked = [&](int k0) {
    const int i = k0 / kBK;
    return walk_all || i >= kFwdFlags || kept[i] != 0;
  };
  auto next = [&](Step p) {
    do {
      p.k0 += kBK;
      if (p.k0 >= p.blk1) {
        if (p.pass == 0) {
          p.pass = 1;
          p.k0 = p.blk0;
        } else {
          p.blk0 += block_keys;
          p.blk1 = min(nk, p.blk0 + block_keys);
          p.pass = 0;
          p.k0 = p.blk0;
        }
      }
    } while (p.blk0 < nk && !walked(p.k0));
    return p;
  };

  // 2) the ring: K (and V in pass 1) and the bias of a tile into a stage
  auto issue = [&](const Step& p, int stage) {
    bf16* k_s = k_tile(stage);
    issue_bf16_tile<kVec>(k_s, a.k, a.ks, b, h, p.k0, nk, d, L, kBK, nthr);
    if (p.pass == 1)
      issue_bf16_tile<kVec>(k_s + kBK * L.ldt, a.v, a.vs, b, h, p.k0, nk, d,
                            L, kBK, nthr);
    if constexpr (kBias) {
      float* bias_s = reinterpret_cast<float*>(k_s + 2 * kBK * L.ldt);
      for (int j = threadIdx.x; j < kBK; j += nthr) {
        const bool ok = p.k0 + j < nk;
        cp_async4(bias_s + j, ok ? a.bias + b * a.bias_sb + p.k0 + j : a.bias,
                  ok ? 4 : 0);
      }
    }
  };
  Step ahead = next(Step{0, min(nk, block_keys), 0, -kBK});
  Step cur = ahead;
  for (int stage = 0; stage < kStages - 1; ++stage) {
    if (ahead.blk0 < nk) {
      issue(ahead, stage);
      ahead = next(ahead);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // A fragments of the warp's queries, one per 16-wide head-dim chunk
  uint32_t qf[kQRegs ? kDC : 1][4];
  auto q_frag = [&](uint32_t (&f)[4], int c) {
    ldsm_x4(f, q_t + (r0 + mr + 8 * (mi & 1)) * L.ldt + 16 * c +
                   8 * (mi >> 1));
  };
  if constexpr (kQRegs) {
#pragma unroll
    for (int c = 0; c < kDC; ++c) q_frag(qf[c], c);
  }

  // z of keys [c0, c0 + 8 kNS) of a tile; -inf from key ``lim`` on when
  // ``ragged`` (the key block ends inside the tile)
  auto scores = [&](float (&s)[kNS][4], const bf16* k_s,
                    const float* bias_s, int c0, int lim, bool ragged) {
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      uint32_t f[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = qf[c][i];
      } else {
        q_frag(f, c);
      }
#pragma unroll
      for (int j = 0; j < kNS; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_s + (c0 + 8 * (j + (mi >> 1)) + mr) * L.ldt + 16 * c +
                        8 * (mi & 1));
        mma_bf16(s[j], f, bk[0], bk[1]);
        mma_bf16(s[j + 1], f, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float z = __fmul_rn(s[j][e], a.scale);
        if constexpr (kBias)
          z = __fadd_rn(z, bias_s[c0 + 8 * j + 2 * t + (e & 1)]);
        s[j][e] = z;
      }
    if (ragged) {
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + 2 * t + (e & 1) >= lim) s[j][e] = -INFINITY;
    }
  };

  float o[2 * kDC][4];
#pragma unroll
  for (int n = 0; n < 2 * kDC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // each row's running max, sum and the sum's reciprocal over the key
  // blocks so far, and this thread's partial max and sum over the current
  // block
  float M[2] = {-INFINITY, -INFINITY}, Lsum[2] = {0.f, 0.f}, R[2] = {1.f, 1.f};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  int stage = 0, fill = kStages - 1;
  while (cur.blk0 < nk) {
    // this tile has landed for every thread, and every warp is done with
    // the stage the issue below refills (the one computed on last)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ahead.blk0 < nk) {
      issue(ahead, fill);
      ahead = next(ahead);
    }
    cp_async_commit();
    fill = fill + 1 == kStages ? 0 : fill + 1;
    const Step nxt = next(cur);
    if (live) {
      const bf16* k_s = k_tile(stage);
      const bf16* v_s = k_s + kBK * L.ldt;
      const float* bias_s = reinterpret_cast<const float*>(v_s + kBK * L.ldt);
      const int lim = cur.blk1 - cur.k0;
      const bool ragged = lim < kBK;
      for (int c0 = 0; c0 < kBK && c0 < lim; c0 += 8 * kNS) {
        float s[kNS][4];
        scores(s, k_s, bias_s, c0, lim, ragged);
        if (cur.pass == 0) {
          // 1) this thread's max and exp-sum of each row over the block
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < kNS; ++j)
              mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
            if (mx == -INFINITY) continue;
            const float mn = fmaxf(m[hf], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kNS; ++j)
              sum += exp_sfu(s[j][2 * hf] - mn) +
                     exp_sfu(s[j][2 * hf + 1] - mn);
            l[hf] = (m[hf] == -INFINITY ? 0.f
                     : l[hf] * exp_sfu(m[hf] - mn)) + sum;
            m[hf] = mn;
          }
        } else {
          // 2) P rounded to bf16 (normalised first when one block covers
          //    every key), o += P.V
#pragma unroll
          for (int j = 0; j < kNS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hf = e >> 1;
              float p = exp_sfu(s[j][e] - M[hf]);  // 0 past the block's end
              if (single) {
                const float qt = __fmul_rn(p, R[hf]);
                p = fmaf(fmaf(-qt, Lsum[hf], p), R[hf], qt);
              }
              s[j][e] = p;
            }
#pragma unroll
          for (int kk = 0; kk < kNS / 2; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int n = 0; n < 2 * kDC; n += 2) {
              uint32_t bv[4];
              ldsm_x4_t(bv, v_s + (c0 + 16 * kk + 8 * (mi & 1) + mr) * L.ldt +
                                8 * (n + (mi >> 1)));
              mma_bf16(o[n], pa, bv[0], bv[1]);
              mma_bf16(o[n + 1], pa, bv[2], bv[3]);
            }
          }
        }
      }
      if (cur.pass == 0 && (nxt.pass != 0 || nxt.blk0 != cur.blk0)) {
        // the block's last walked tile: merge the row's four threads, then
        // the block into the running statistics
        float alpha[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mb = m[hf];
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
          float lb = m[hf] == -INFINITY ? 0.f : l[hf] * exp_sfu(m[hf] - mb);
          lb += __shfl_xor_sync(0xffffffffu, lb, 1);
          lb += __shfl_xor_sync(0xffffffffu, lb, 2);
          alpha[hf] = 1.f;
          // a block without a finite score changes nothing (and never
          // forms -inf - -inf)
          if (mb != -INFINITY) {
            const float mn = fmaxf(M[hf], mb);
            alpha[hf] = M[hf] == -INFINITY ? 0.f : exp_sfu(M[hf] - mn);
            Lsum[hf] = Lsum[hf] * alpha[hf] + lb * exp_sfu(mb - mn);
            M[hf] = mn;
            R[hf] = 1.f / Lsum[hf];
          }
          m[hf] = -INFINITY;
          l[hf] = 0.f;
        }
        if (!single) {
#pragma unroll
          for (int n = 0; n < 2 * kDC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
        }
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    cur = nxt;
  }
  cp_async_wait<0>();
  if (!live) return;

  // 3) divide by the running sum (several key blocks), round to bf16; the
  //    row statistics (the same in the four threads of a row) by t == 0
  if (a.res_m != nullptr && t == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gq = q0 + r0 + g + 8 * hf;
      if (gq >= nq) continue;
      const long long at = (static_cast<long long>(b) * gridDim.y + h) * nq + gq;
      a.res_m[at] = M[hf];
      a.res_l[at] = Lsum[hf];
    }
  }
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    inv[hf] = single ? 1.f : (Lsum[hf] == 0.f ? 1.f : 1.f / Lsum[hf]);
  // the warp's own rows of the query tile (no other warp reads them) take
  // its output, then go out in 16-byte stores where the layout allows
  bf16* o_t = q_t + r0 * L.ldt;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 2 * kDC; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<uint32_t*>(o_t + (g + 8 * hf) * L.ldt + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * hf] * inv[hf], o[n][2 * hf + 1] * inv[hf]);
  __syncwarp();
  const Strides os = a.os;
  const bool vec_out = ((d | os.b | os.n | os.h) & 7) == 0 &&
                       reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const int rows = min(kRows, nq - q0 - r0);
  bf16* dst = a.out + b * os.b + (q0 + r0) * os.n + h * os.h;
  if (vec_out) {
    const int cpr = d / 8;
    for (int idx = lane; idx < rows * cpr; idx += 32) {
      const int r = idx / cpr;
      const int e = (idx - r * cpr) * 8;
      *reinterpret_cast<uint4*>(dst + r * os.n + e) =
          *reinterpret_cast<const uint4*>(o_t + r * L.ldt + e);
    }
  } else {
    for (int idx = lane; idx < rows * d; idx += 32) {
      const int r = idx / d;
      const int e = idx - r * d;
      dst[r * os.n + e] = o_t[r * L.ldt + e];
    }
  }
}

// Launch ``Kernel::fn<kVec, kDC, kBias>()`` (a __global__ wrapper of
// attention_bf16_block) at the padding that covers d.
template <class Kernel, bool kVec, int kDC, bool kBias>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  const size_t smem = fwd_smem_bytes(a.d);
  auto kernel = Kernel::template fn<kVec, kDC, kBias>();
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((a.nq + kFwdBQ - 1) / kFwdBQ, a.h, a.b), kFwdThreads, smem,
           st>>>(a, Kernel::kMaskValue);
  return cudaGetLastError();
}

template <class Kernel, int kDC>
cudaError_t launch_fwd_dc(const FwdArgs& a, bool vec, cudaStream_t st) {
  if (a.bias != nullptr)
    return vec ? launch_fwd<Kernel, true, kDC, true>(a, st)
               : launch_fwd<Kernel, false, kDC, true>(a, st);
  return vec ? launch_fwd<Kernel, true, kDC, false>(a, st)
             : launch_fwd<Kernel, false, kDC, false>(a, st);
}

// registers, local bytes, shared bytes and blocks per SM of the launch
// without a bias (out[0:4]) and with one (out[4:8])
template <class Kernel, int kDC>
cudaError_t fwd_info_dc(int d, bool vec, long long* out) {
  const size_t smem = fwd_smem_bytes(d);
  cudaError_t e = launch_info(vec ? Kernel::template fn<true, kDC, false>()
                                  : Kernel::template fn<false, kDC, false>(),
                              smem, out, kFwdThreads);
  return e != cudaSuccess ? e : launch_info(
      vec ? Kernel::template fn<true, kDC, true>()
          : Kernel::template fn<false, kDC, true>(), smem, out + 4,
      kFwdThreads);
}

// Dispatch on the head-dim padding (up to Kernel::kMaxDC chunks): the
// launch (out == nullptr) or its launch info.
template <class Kernel>
cudaError_t fwd_bf16(const FwdArgs& a, bool vec, cudaStream_t st,
                     long long* out = nullptr) {
#define YAT_FWD_CASE(DC)                                                      \
  case DC:                                                                    \
    if constexpr (DC <= Kernel::kMaxDC)                                       \
      return out ? fwd_info_dc<Kernel, DC>(a.d, vec, out)                     \
                 : launch_fwd_dc<Kernel, DC>(a, vec, st);                     \
    break;
  switch (head_chunks(a.d)) {
    YAT_FWD_CASE(2)
    YAT_FWD_CASE(4)
    YAT_FWD_CASE(5)
    YAT_FWD_CASE(8)
    YAT_FWD_CASE(16)
  }
#undef YAT_FWD_CASE
  return cudaErrorInvalidValue;
}

// The bf16 launch: 16-byte loads when every row start is 16-byte aligned.
template <class Kernel>
cudaError_t launch_bf16(const FwdArgs& a, cudaStream_t st) {
  return fwd_bf16<Kernel>(a, vec_ok(a.d, a.qs, a.ks, a.vs, a.q, a.k, a.v),
                          st);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

// q, k and v tiles [64][D + 1] (odd row stride: lanes that read neighbouring
// rows hit distinct banks), probabilities [64][64], the bias tile
inline size_t f32_smem_bytes(int d) {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (d + 1) +
          static_cast<size_t>(kBQ) * kBK + kBK) * sizeof(float);
}

__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              Strides st, int b, int h,
                                              int row0, int rows, int d) {
  const int ld = d + 1;
  for (int idx = threadIdx.x; idx < kBK * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gr = row0 + r;
    dst[r * ld + e] =
        gr < rows ? src[b * st.b + gr * st.n + h * st.h + e] : 0.f;
  }
}

// Each lane owns key columns lane and lane + 32 of every tile (scores,
// per-lane softmax statistics) and output columns lane + 32 j, j < kMaxE,
// of its warp's 16 rows (the accumulator, in registers).
template <int kMaxE>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, int nq, int nk, int d, Strides qs,
                  Strides ks, Strides vs, long long bias_sb, Strides os,
                  float scale, int block_keys, float* __restrict__ res_m,
                  float* __restrict__ res_l) {
  extern __shared__ float smem_f[];
  const int ld = d + 1;
  float* q_t = smem_f;                    // [kBQ][ld]
  float* k_t = q_t + kBQ * ld;            // [kBK][ld]
  float* v_t = k_t + kBK * ld;            // [kBK][ld]
  float* p_t = v_t + kBK * ld;            // [kBQ][kBK]
  float* bias_t = p_t + kBQ * kBK;        // [kBK]
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;

  load_f32_tile(q_t, q, qs, b, h, q0, nq, d);

  auto load_bias = [&](int k0) {
    for (int j = threadIdx.x; j < kBK; j += kThreads)
      bias_t[j] = (k0 + j < nk && bias != nullptr)
          ? bias[b * bias_sb + k0 + j] : 0.f;
  };
  // scaled, biased scores of the lane's two columns, -inf past blk1
  auto scores = [&](float (&s)[kRows][2], int k0, int blk1) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float k_a = k_t[lane * ld + e];
      const float k_b = k_t[(lane + 32) * ld + e];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = q_t[(r0 + i) * ld + e];
        s[i][0] = fmaf(qv, k_a, s[i][0]);
        s[i][1] = fmaf(qv, k_b, s[i][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        s[i][j] = k0 + c < blk1
            ? __fadd_rn(__fmul_rn(s[i][j], scale), bias_t[c]) : -INFINITY;
    }
  };

  float acc[kRows][kMaxE];
  float M[kRows], L[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    M[i] = -INFINITY;
    L[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) acc[i][j] = 0.f;
  }
  bool single = true;
  for (int blk0 = 0; blk0 < nk; blk0 += block_keys) {
    const int blk1 = min(nk, blk0 + block_keys);
    single = blk0 == 0 && blk1 == nk;
    // 1) the block's row max and exp-sum, online per lane
    float m[kRows], l[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int k0 = blk0; k0 < blk1; k0 += kBK) {
      __syncthreads();
      load_f32_tile(k_t, k, ks, b, h, k0, nk, d);
      load_bias(k0);
      __syncthreads();
      float s[kRows][2];
      scores(s, k0, blk1);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float z = s[i][j];
          if (z == -INFINITY) continue;
          if (z > m[i]) {
            l[i] = l[i] * expf(m[i] - z) + 1.f;
            m[i] = z;
          } else {
            l[i] += expf(z - m[i]);
          }
        }
    }
    // merge the lanes, then the block into the running statistics
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float mb = warp_max(m[i]);
      const float lb = warp_sum(m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mb));
      const float mn = fmaxf(M[i], mb);
      const float alpha = M[i] == -INFINITY ? 0.f : expf(M[i] - mn);
      L[i] = L[i] * alpha + lb * expf(mb - mn);
      M[i] = mn;
#pragma unroll
      for (int j = 0; j < kMaxE; ++j) acc[i][j] *= alpha;
    }
    // 2) P = exp(z - M) (divided by the sum when one block covers every
    //    key), acc += P.V
    for (int k0 = blk0; k0 < blk1; k0 += kBK) {
      __syncthreads();
      load_f32_tile(k_t, k, ks, b, h, k0, nk, d);
      load_f32_tile(v_t, v, vs, b, h, k0, nk, d);
      load_bias(k0);
      __syncthreads();
      float s[kRows][2];
      scores(s, k0, blk1);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float z = s[i][j];
          float p = z == -INFINITY ? 0.f : expf(z - M[i]);
          if (single) p = p / L[i];
          p_t[(r0 + i) * kBK + lane + 32 * j] = p;
        }
      __syncwarp();
      const int kn = min(kBK, blk1 - k0);
      for (int c = 0; c < kn; ++c) {
        float vv[kMaxE];
#pragma unroll
        for (int j = 0; j < kMaxE; ++j) {
          const int e = lane + 32 * j;
          vv[j] = e < d ? v_t[c * ld + e] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = p_t[(r0 + i) * kBK + c];
#pragma unroll
          for (int j = 0; j < kMaxE; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gq = q0 + r0 + i;
    if (gq >= nq) continue;
    const float inv = single ? 1.f : (L[i] == 0.f ? 1.f : 1.f / L[i]);
    if (res_m != nullptr && lane == 0) {
      const long long at = (static_cast<long long>(b) * gridDim.y + h) * nq + gq;
      res_m[at] = M[i];
      res_l[at] = L[i];
    }
#pragma unroll
    for (int j = 0; j < kMaxE; ++j) {
      const int e = lane + 32 * j;
      if (e < d) out[b * os.b + gq * os.n + h * os.h + e] = acc[i][j] * inv;
    }
  }
}

// Launch the fp32 kernel: head dims up to 256 (kMaxE 4 up to D = 128).
inline cudaError_t launch_f32(const float* q, const float* k, const float* v,
                              const float* bias, float* out, int b, int nq,
                              int nk, int h, int d, Strides qs, Strides ks,
                              Strides vs, long long bias_sb, Strides os,
                              float scale, int block_keys, float* res_m,
                              float* res_l, cudaStream_t st) {
  const size_t smem = f32_smem_bytes(d);
  const dim3 grid((nq + kBQ - 1) / kBQ, h, b);
  auto kernel = d <= 128 ? attention_fwd_f32<4> : attention_fwd_f32<8>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, bias, out, nq, nk, d, qs, ks,
                                       vs, bias_sb, os, scale, block_keys,
                                       res_m, res_l);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace yat
