// The softmax-attention forward shared by kernels K2 (softmax_attention.cu)
// and K6 (flash_attention.cu): one block per (64 queries, head, batch
// element), four warps of 16 query rows each, keys in 64-row tiles through
// shared memory, q/k/v read as [B, N, H, D] through strides, the ragged
// key edge zero-filled and masked.
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
// * bf16: both products on the tensor cores with mma.sync m16n8k16,
//   operands fetched by ldmatrix (V transposed on the way), the queries'
//   fragments, the scores, P and the accumulator in registers; the head
//   dim zero-padded in shared memory to 16 x a compiled chunk count;
// * fp32: on the CUDA cores, P never rounded.
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

constexpr int kBQ = 64;               // queries per block
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

// rows [row0, row0 + 64) of a [N, H, D] slab into a zero-padded bf16 tile
// (rows at or past ``rows`` are zero); kVec: 16-byte loads
template <bool kVec>
__device__ __forceinline__ void load_bf16_tile(bf16* dst, const bf16* src,
                                               Strides st, int b, int h,
                                               int row0, int rows, int d,
                                               const Layout& L) {
  if (kVec) {
    const int cpr = L.dp / 8;
    for (int idx = threadIdx.x; idx < kBK * cpr; idx += kThreads) {
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
    for (int idx = threadIdx.x; idx < kBK * L.dp; idx += kThreads) {
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

// q tile, two stages of k and v tiles (64 rows each) and two bias tiles, at
// head dim d
inline size_t bf16_smem_bytes(int d) {
  const Layout L(16 * head_chunks(d));
  return static_cast<size_t>(kBQ + 4 * kBK) * L.ldt * sizeof(bf16) +
         2 * kBK * sizeof(float);
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

// Start copying rows [row0, row0 + 64) of a [N, H, D] slab into a
// zero-padded bf16 tile: 16-byte cp.async with kVec, else the synchronous
// element loads of load_bf16_tile.
template <bool kVec>
__device__ __forceinline__ void issue_bf16_tile(bf16* dst, const bf16* src,
                                                Strides st, int b, int h,
                                                int row0, int rows, int d,
                                                const Layout& L) {
  if (kVec) {
    const int cpr = L.dp / 8;
    for (int idx = threadIdx.x; idx < kBK * cpr; idx += kThreads) {
      const int r = idx / cpr;
      const int e = (idx - r * cpr) * 8;
      const int gr = row0 + r;
      const bool ok = gr < rows && e < d;
      cp_async16(dst + r * L.ldt + e,
                 ok ? src + b * st.b + gr * st.n + h * st.h + e : src,
                 ok ? 16 : 0);
    }
  } else {
    load_bf16_tile<false>(dst, src, st, b, h, row0, rows, d, L);
  }
}

constexpr int kNT = kBK / 8;  // 8-key column tiles of a 64-key tile

// One 64-key tile of the walk: key block [blk0, blk1), pass 0 (row
// statistics) or 1 (P.V), first key k0.
struct Step {
  int blk0, blk1, pass, k0;
};

// The body of the bf16 kernels (K2's and K6's __global__ functions call it
// under their own names, so that a profile tells them apart).  kDC:
// 16-wide chunks of the padded head dim.
//
// The tiles of both passes of every key block form one sequence; while the
// warps compute on one stage of shared memory, cp.async fills the other
// with the next tile (K, plus V for the P.V pass, plus their bias).
//
// Fragment layout (mma.sync m16n8k16): lane 4 g + t holds the elements
// (row g, columns 2t, 2t+1) and (row g + 8, the same columns) of each
// 16 x 8 accumulator, as c[0], c[1] and c[2], c[3]; "half" 0 is row g,
// half 1 row g + 8.  The score fragments of 16 keys are the A fragment of
// P for the P.V product, once packed to bf16.
template <bool kVec, int kDC>
__device__ __forceinline__ void attention_bf16_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    bf16* __restrict__ out, int nq, int nk, int d, Strides qs, Strides ks,
    Strides vs, long long bias_sb, Strides os, float scale, int block_keys,
    float* __restrict__ res_m, float* __restrict__ res_l,
    unsigned char* smem_raw) {
  constexpr bool kQRegs = kDC <= 8;
  const Layout L(16 * kDC);
  bf16* q_t = reinterpret_cast<bf16*>(smem_raw);       // [kBQ][ldt]
  bf16* kv_t = q_t + kBQ * L.ldt;                      // [2][k, v][kBK][ldt]
  float* bias_t = reinterpret_cast<float*>(kv_t + 4 * kBK * L.ldt);  // [2][kBK]
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;  // the warp's 16 query rows
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, row
  const bool single = block_keys >= nk;       // one key block

  // start the first key tile's copy, then load the queries
  auto issue = [&](const Step& p, int stage) {
    bf16* k_s = kv_t + 2 * stage * kBK * L.ldt;
    issue_bf16_tile<kVec>(k_s, k, ks, b, h, p.k0, nk, d, L);
    if (p.pass == 1)
      issue_bf16_tile<kVec>(k_s + kBK * L.ldt, v, vs, b, h, p.k0, nk, d, L);
    float* bias_s = bias_t + stage * kBK;
    for (int j = threadIdx.x; j < kBK; j += kThreads) {
      if (bias == nullptr) {
        bias_s[j] = 0.f;
      } else {
        const bool ok = p.k0 + j < nk;
        cp_async4(bias_s + j, ok ? bias + b * bias_sb + p.k0 + j : bias,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  auto next = [&](Step p) {
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
    return p;
  };
  Step cur{0, min(nk, block_keys), 0, 0};
  issue(cur, 0);

  load_bf16_tile<kVec>(q_t, q, qs, b, h, q0, nq, d, L);
  __syncthreads();
  // A fragments of the warp's queries, one per 16-wide head-dim chunk
  // (re-read from shared memory past D = 128)
  uint32_t qf[kQRegs ? kDC : 1][4];
  auto q_frag = [&](uint32_t (&a)[4], int c) {
    ldsm_x4(a, q_t + (r0 + mr + 8 * (mi & 1)) * L.ldt + 16 * c +
                   8 * (mi >> 1));
  };
  if constexpr (kQRegs) {
#pragma unroll
    for (int c = 0; c < kDC; ++c) q_frag(qf[c], c);
  }

  // z = q.k * scale + bias of the 64-key tile at k0; -inf past blk1
  auto scores = [&](float (&s)[kNT][4], const bf16* k_s, const float* bias_s,
                    int k0, int blk1) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[c][i];
      } else {
        q_frag(a, c);
      }
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_s + (8 * (j + (mi >> 1)) + mr) * L.ldt + 16 * c +
                        8 * (mi & 1));
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        s[j][e] = k0 + col < blk1
            ? __fadd_rn(__fmul_rn(s[j][e], scale), bias_s[col]) : -INFINITY;
      }
  };

  float o[2 * kDC][4];
#pragma unroll
  for (int n = 0; n < 2 * kDC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // running max and sum of each row over the key blocks so far, and this
  // thread's partial ones over the current block
  float M[2] = {-INFINITY, -INFINITY}, Lsum[2] = {0.f, 0.f};
  float m[2], l[2];
  int stage = 0;
  while (cur.blk0 < nk) {
    const Step nxt = next(cur);
    if (nxt.blk0 < nk) {
      issue(nxt, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = kv_t + 2 * stage * kBK * L.ldt;
    const bf16* v_s = k_s + kBK * L.ldt;
    const float* bias_s = bias_t + stage * kBK;
    float s[kNT][4];
    scores(s, k_s, bias_s, cur.k0, cur.blk1);
    if (cur.pass == 0) {
      // 1) the key block's max and exp-sum of each row: online over this
      //    thread's columns, merged across the row's four threads after
      //    the block's last tile
      if (cur.k0 == cur.blk0) {
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        if (mx == -INFINITY) continue;
        const float mn = fmaxf(m[hf], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          sum += expf(s[j][2 * hf] - mn) + expf(s[j][2 * hf + 1] - mn);
        l[hf] = (m[hf] == -INFINITY ? 0.f : l[hf] * expf(m[hf] - mn)) + sum;
        m[hf] = mn;
      }
      if (cur.k0 + kBK >= cur.blk1) {
        float alpha[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mb = m[hf];
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
          float lb = m[hf] == -INFINITY ? 0.f : l[hf] * expf(m[hf] - mb);
          lb += __shfl_xor_sync(0xffffffffu, lb, 1);
          lb += __shfl_xor_sync(0xffffffffu, lb, 2);
          const float mn = fmaxf(M[hf], mb);
          alpha[hf] = M[hf] == -INFINITY ? 0.f : expf(M[hf] - mn);
          Lsum[hf] = Lsum[hf] * alpha[hf] + lb * expf(mb - mn);
          M[hf] = mn;
        }
        if (cur.blk0 > 0) {
#pragma unroll
          for (int n = 0; n < 2 * kDC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
        }
      }
    } else {
      // 2) P rounded to bf16 (normalised first when one block covers every
      //    key), o += P.V
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[j][e] - M[e >> 1]);  // 0 past the block's end
          if (single) p = p / Lsum[e >> 1];
          s[j][e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < 2 * kDC; n += 2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, v_s + (16 * kk + 8 * (mi & 1) + mr) * L.ldt +
                            8 * (n + (mi >> 1)));
          mma_bf16(o[n], a, bv[0], bv[1]);
          mma_bf16(o[n + 1], a, bv[2], bv[3]);
        }
      }
    }
    // every warp is done with this stage before the next issue refills it
    __syncthreads();
    cur = nxt;
    stage ^= 1;
  }

  // 3) divide by the running sum (several key blocks), write bf16; the
  //    row statistics (the same in the four threads of a row) by t == 0
  if (res_m != nullptr && t == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gq = q0 + r0 + g + 8 * hf;
      if (gq >= nq) continue;
      const long long at = (static_cast<long long>(b) * gridDim.y + h) * nq + gq;
      res_m[at] = M[hf];
      res_l[at] = Lsum[hf];
    }
  }
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    inv[hf] = single ? 1.f : (Lsum[hf] == 0.f ? 1.f : 1.f / Lsum[hf]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int gq = q0 + r0 + g + 8 * (e >> 1);
    if (gq >= nq) continue;
    bf16* row = out + b * os.b + gq * os.n + h * os.h;
#pragma unroll
    for (int n = 0; n < 2 * kDC; ++n) {
      const int col = 8 * n + 2 * t + (e & 1);
      if (col < d) row[col] = __float2bfloat16_rn(o[n][e] * inv[e >> 1]);
    }
  }
}

// Launch ``Kernel::fn<kVec, kDC>()`` (a __global__ wrapper of
// attention_bf16_block) at the padding that covers d.
template <class Kernel, bool kVec, int kDC>
cudaError_t launch_bf16_chunks(const bf16* q, const bf16* k, const bf16* v,
                               const float* bias, bf16* out, int b, int nq,
                               int nk, int h, int d, Strides qs, Strides ks,
                               Strides vs, long long bias_sb, Strides os,
                               float scale, int block_keys, float* res_m,
                               float* res_l, cudaStream_t st) {
  const size_t smem = bf16_smem_bytes(d);
  const dim3 grid((nq + kBQ - 1) / kBQ, h, b);
  auto kernel = Kernel::template fn<kVec, kDC>();
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, bias, out, nq, nk, d, qs, ks,
                                       vs, bias_sb, os, scale, block_keys,
                                       res_m, res_l);
  return cudaGetLastError();
}

template <class Kernel>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        const float* bias, bf16* out, int b, int nq, int nk,
                        int h, int d, Strides qs, Strides ks, Strides vs,
                        long long bias_sb, Strides os, float scale,
                        int block_keys, float* res_m, float* res_l,
                        cudaStream_t st) {
  // 16-byte loads when every row start is 16-byte aligned
  const bool vec = vec_ok(d, qs, ks, vs, q, k, v);
#define YAT_BF16_CASE(DC)                                                    \
  case DC:                                                                   \
    return (vec ? launch_bf16_chunks<Kernel, true, DC>                       \
                : launch_bf16_chunks<Kernel, false, DC>)(                    \
        q, k, v, bias, out, b, nq, nk, h, d, qs, ks, vs, bias_sb, os, scale, \
        block_keys, res_m, res_l, st);
  switch (head_chunks(d)) {
    YAT_BF16_CASE(2)
    YAT_BF16_CASE(4)
    YAT_BF16_CASE(5)
    YAT_BF16_CASE(8)
    YAT_BF16_CASE(16)
  }
#undef YAT_BF16_CASE
  return cudaErrorInvalidValue;
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
