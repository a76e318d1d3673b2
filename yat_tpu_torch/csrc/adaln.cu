// K1: fused adaLN LayerNorm forward,
//     y = LayerNorm(x, affine-free) * (1 + scale) + shift, per token row.
//
// Replaces the TPU kernel yat_tpu/ops/norm.py:_fwd_kernel (called through
// _adaln_p), which ran one program per batch element with the whole
// [N, D] slab in VMEM.
//
// Bound on the H100: bytes.  The kernel reads x once and writes y once
// (plus the [B, D] modulators) and does about ten flops per element, far
// under the card's ~295 flops/byte ridge.  Design against that bound:
//   * one warp per token row, so B*N rows (2048 on SANA's serving path,
//     8192 on PixArt-Sigma's) spread over all SMs, eight rows a block;
//   * at the models' width (D = 1152, adaln_fwd_rows) the row lives in
//     registers: each lane issues its nine loads of four values (8 bytes
//     in bf16, 16 in fp32) at once, coalesced across the warp, and holds
//     them through both statistics passes and the normalize pass; scale
//     and shift arrive as the same four-value vectors, and y leaves as
//     them; no shared memory, so blocks per SM are bounded by registers
//     only (four of eight warps in bf16).  Variants timed on the H100 and
//     dropped: 16-byte bf16 loads, two or four rows a warp, scale and
//     shift prefetched to L1 or loaded with the row, a grid of resident
//     blocks whose warps prefetch their next row (PERF.md §6);
//   * other widths, or rows not aligned to the vectors (adaln_fwd_generic):
//     the same warp per row, one element a lane per step, x read once from
//     device memory and again from L1 for the later passes;
//   * fp32 statistics reduced with warp shuffles (the same butterfly).
// Numerics follow the plain version (ops/norm.py:adaln_ref, a copy of
// yat_tpu/ops/norm.py:_adaln_ref): mean and 1/sqrt(var + eps) in fp32, both
// rounded to the storage type, then every op of the normalize-and-modulate
// chain rounds to the storage type in the same order.  The explicit
// __fmul_rn/__fadd_rn keep the compiler from fusing two ops into one FMA,
// which would round differently from the plain version in fp32.
//
// K1b: its backward (yat_adaln_bwd), replacing the TPU kernel
// yat_tpu/ops/norm.py:_bwd_kernel (called through _adaln_bwd), which ran
// one program per batch element: dx, dscale = sum_N g * xhat and
// dshift = sum_N g, with the statistics recomputed from x and all
// intermediates in fp32 (the plain version is ops/norm.py:adaln_bwd_ref).
// Bound on the H100: bytes (x and g read once, dx written once; ~20 flops
// per element).  Design against that bound, in one launch:
//   * at the models' width (D = 1152, adaln_bwd_ring) one warp works one
//     token row at a time, several rows of one batch element in a fixed
//     order; the next row of x and g reaches the warp's two-slot ring in
//     shared memory by 16-byte cp.async while the warp works on the
//     current one from its slot, so x and g are read from device memory
//     once.  Lane l owns the four-value vectors l + 32 c (the layout of
//     adaln_fwd_rows); the row statistics and the two row means come from
//     warp shuffles, dx leaves as the same vectors, and each lane keeps its
//     36 columns' sums of g * xhat and g in fp32 registers over every row
//     it walks.  A warp walks enough rows for about one block per SM (four
//     at SANA's training shape, eight at PixArt-Sigma's): one block a
//     batch element's chunk of rows, its warps' column sums added in warp
//     order through their rings.  Timed on the H100 and dropped: two
//     blocks per SM (registers capped at 128, spilling; more blocks a
//     batch element, so a longer reduce), a three-slot ring (PERF.md §6);
//   * other widths, or rows off the vectors (adaln_bwd_generic): blocks of
//     16 rows; one warp per row for the statistics, then one thread per
//     column for dx and the block's column sums;
//   * each block writes its column sums to an fp32 scratch row; the last
//     block of its batch element to arrive (an arrival counter, which the
//     last block sets back to 0) adds the rows in chunk order: no float
//     atomics and no second launch, and the same bits from run to run.
#include "attention_tiles.cuh"

#include <stdint.h>

#include <algorithm>

namespace {

using yat::attn::cp_async16;
using yat::attn::cp_async_commit;
using yat::attn::cp_async_wait;

constexpr int kRowsPerBlock = 8;   // one warp per row, 256 threads
constexpr int kRowWidth = 1152;    // the width adaln_fwd_rows is built for

// Four consecutive values of a row: 8 bytes of bf16 or 16 of fp32.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using Raw = float4;
  __device__ __forceinline__ static void get(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static Raw put(const float (&v)[4]) {
    Raw r;
    r.x = v[0];
    r.y = v[1];
    r.z = v[2];
    r.w = v[3];
    return r;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static void get(const Raw& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t pair(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
  }
  __device__ __forceinline__ static Raw put(const float (&v)[4]) {
    Raw r;
    r.x = pair(v[0], v[1]);
    r.y = pair(v[2], v[3]);
    return r;
  }
};

struct FwdArgs {
  long long rows;
  int n, d;
  long long x_sb, x_sn, scale_sb, shift_sb, out_sb, out_sn;
  float eps;
};

// y for one value: the plain version's rounding chain
template <typename T>
__device__ __forceinline__ float modulate(float x, float mean_c, float inv_c,
                                          float sc, float sh) {
  float y = yat::rnd<T>(__fsub_rn(x, mean_c));
  y = yat::rnd<T>(__fmul_rn(y, inv_c));
  const float s1 = yat::rnd<T>(__fadd_rn(1.0f, sc));
  y = yat::rnd<T>(__fmul_rn(y, s1));
  return __fadd_rn(y, sh);
}

// The row in registers: lane l holds values 4 (l + 32 c) .. + 3 for
// c < kD / 128.
template <typename T, int kD>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
adaln_fwd_rows(const T* __restrict__ x, const T* __restrict__ scale,
               const T* __restrict__ shift, T* __restrict__ out,
               const FwdArgs a) {
  static_assert(kD % 128 == 0, "a lane holds whole four-value vectors");
  using V = Vec4<T>;
  using Raw = typename V::Raw;
  constexpr int kC = kD / 128;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= a.rows) return;
  const long long b = row / a.n;
  const long long i = row % a.n;
  const Raw* xr = reinterpret_cast<const Raw*>(x + b * a.x_sb + i * a.x_sn);
  Raw xv[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) xv[c] = xr[lane + 32 * c];

  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float v[4];
    V::get(xv[c], v);
#pragma unroll
    for (int e = 0; e < 4; ++e) s += v[e];
  }
  const float mean = yat::warp_sum(s) / static_cast<float>(kD);
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float v[4];
    V::get(xv[c], v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[e] - mean;
      ss += d * d;
    }
  }
  const float var = yat::warp_sum(ss) / static_cast<float>(kD);
  const float inv = 1.0f / sqrtf(var + a.eps);

  const float mean_c = yat::rnd<T>(mean);
  const float inv_c = yat::rnd<T>(inv);
  const Raw* sc = reinterpret_cast<const Raw*>(scale + b * a.scale_sb);
  const Raw* sh = reinterpret_cast<const Raw*>(shift + b * a.shift_sb);
  Raw* orow = reinterpret_cast<Raw*>(out + b * a.out_sb + i * a.out_sn);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float v[4], s4[4], h4[4], y[4];
    V::get(xv[c], v);
    V::get(sc[lane + 32 * c], s4);
    V::get(sh[lane + 32 * c], h4);
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = modulate<T>(v[e], mean_c, inv_c, s4[e], h4[e]);
    orow[lane + 32 * c] = V::put(y);
  }
}

// Any width: one value a lane per step, x read again (from L1) by the
// later passes.
template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
adaln_fwd_generic(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ shift, T* __restrict__ out,
                  const FwdArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= a.rows) return;
  const long long b = row / a.n;
  const long long i = row % a.n;
  const int d = a.d;
  const T* xr = x + b * a.x_sb + i * a.x_sn;

  float s = 0.f;
  for (int j = lane; j < d; j += 32) s += yat::to_f<T>(xr[j]);
  const float mean = yat::warp_sum(s) / static_cast<float>(d);
  float ss = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float c = yat::to_f<T>(xr[j]) - mean;
    ss += c * c;
  }
  const float var = yat::warp_sum(ss) / static_cast<float>(d);
  const float inv = 1.0f / sqrtf(var + a.eps);

  const float mean_c = yat::rnd<T>(mean);
  const float inv_c = yat::rnd<T>(inv);
  const T* sc = scale + b * a.scale_sb;
  const T* sh = shift + b * a.shift_sb;
  T* orow = out + b * a.out_sb + i * a.out_sn;
  for (int j = lane; j < d; j += 32)
    orow[j] = yat::from_f<T>(modulate<T>(yat::to_f<T>(xr[j]), mean_c, inv_c,
                                         yat::to_f<T>(sc[j]),
                                         yat::to_f<T>(sh[j])));
}

// whether the register path takes this call: the width it is built for,
// and every row and modulator starting on a four-value boundary
template <typename T>
bool rows_path(const void* x, const void* scale, const void* shift,
               const void* out, const FwdArgs& a) {
  const uintptr_t vb = 4 * sizeof(T);
  auto al = [&](const void* p) { return reinterpret_cast<uintptr_t>(p) % vb == 0; };
  return a.d == kRowWidth && al(x) && al(scale) && al(shift) && al(out) &&
         a.x_sb % 4 == 0 && a.x_sn % 4 == 0 && a.scale_sb % 4 == 0 &&
         a.shift_sb % 4 == 0 && a.out_sb % 4 == 0 && a.out_sn % 4 == 0;
}

// Launch K1 (info == nullptr), or write its path (1: registers, 0: the
// generic loop), registers, local bytes, shared bytes and blocks per SM
// into info[0:5].
template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* out, const FwdArgs& a, cudaStream_t stream,
                   long long* info) {
  const bool rows = rows_path<T>(x, scale, shift, out, a);
  auto kernel = rows ? adaln_fwd_rows<T, kRowWidth> : adaln_fwd_generic<T>;
  if (info != nullptr) {
    info[0] = rows ? 1 : 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kRowsPerBlock * 32, 0);
    info[1] = fa.numRegs;
    info[2] = static_cast<long long>(fa.localSizeBytes);
    info[3] = static_cast<long long>(fa.sharedSizeBytes);
    info[4] = blocks;
    return e;
  }
  const unsigned blocks =
      static_cast<unsigned>((a.rows + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<blocks, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(out), a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1b: the backward, recomputing the statistics from x.
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kMinRowsPerWarp = 2;         // ring path: rows a warp walks
constexpr int kStages = 2;                 // ring slots a warp
constexpr int kGenericRows = 16;           // rows a block (generic loop)
constexpr int kSumCols = 9;                // reduce: columns a thread

template <typename T>
struct BwdArgs {
  const T* x;
  const T* scale;
  const T* g;
  T* dx;
  T* dscale;
  T* dshift;
  float* partial;   // [B][chunks][2][d]: each block's dscale, dshift sums
  int* arrivals;    // [B], 0 between launches
  int n, d, chunks;
  int rows_per_warp;   // ring path
  long long x_sb, x_sn, scale_sb, g_sb, g_sn, dx_sb, dx_sn;
  float eps;
};

// The block's row of `partial` is written (every thread wrote its own
// values).  Each block of batch element b then counts itself in, as a
// grid barrier does: the block's barrier, then one thread's fence and
// atomic.  The last block to arrive adds the element's rows in chunk order
// (kSumCols columns a thread, their loads from four chunks in flight
// together), writes dscale and dshift, and sets the counter back to 0.
// The order of the sums does not depend on which block arrives last, so
// two launches give the same bits.
template <typename T>
__device__ __forceinline__ void arrive_and_reduce(const BwdArgs<T>& a) {
  const int b = blockIdx.y;
  const int w = 2 * a.d;
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    __threadfence();   // the block's row, before its arrival
    last = atomicAdd(a.arrivals + b, 1) == a.chunks - 1;
    if (last) __threadfence();   // the other rows, after their arrivals
  }
  if (!__syncthreads_or(last)) return;
  const float* rows = a.partial + static_cast<long long>(b) * a.chunks * w;
  const long long out = static_cast<long long>(b) * a.d;
  for (int j0 = threadIdx.x; j0 < w; j0 += kSumCols * kBwdThreads) {
    float s[kSumCols];
#pragma unroll
    for (int k = 0; k < kSumCols; ++k) s[k] = 0.f;
#pragma unroll 4
    for (int c = 0; c < a.chunks; ++c) {
      const float* r = rows + static_cast<long long>(c) * w;
#pragma unroll
      for (int k = 0; k < kSumCols; ++k) {
        const int j = j0 + k * kBwdThreads;
        if (j < w) s[k] += __ldcg(r + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kSumCols; ++k) {
      const int j = j0 + k * kBwdThreads;
      if (j < a.d)
        a.dscale[out + j] = yat::from_f<T>(s[k]);
      else if (j < w)
        a.dshift[out + j - a.d] = yat::from_f<T>(s[k]);
    }
  }
  if (threadIdx.x == 0) a.arrivals[b] = 0;
}

// Shared memory of the ring path: (1 + scale) of the batch element in
// fp32, then each warp's ring of kStages slots, a slot one row of x and
// then the same row of g.  After the walk a warp's ring holds its fp32
// column sums [2][kRowWidth].
template <typename T>
struct RingShape {
  static constexpr int kRowBytes = kRowWidth * static_cast<int>(sizeof(T));
  static constexpr int kSlotBytes = 2 * kRowBytes;
  static constexpr int kCopies = kSlotBytes / 16;   // 16-byte pieces a slot
  static constexpr int kWarpBytes = kStages * kSlotBytes;
  static constexpr int kScaleBytes = kRowWidth * 4;
  static constexpr size_t kSmem = kScaleBytes + kBwdWarps * kWarpBytes;
  static_assert(kWarpBytes >= 2 * kRowWidth * 4,
                "a warp's ring holds its column sums");
  static_assert(kCopies % 32 == 0, "whole copies a lane");
};

// The ring path (D = kRowWidth, x and g rows on 16-byte boundaries, dx
// rows on four-value ones).  Block (chunk, b) gives warp w the rows
// chunk * 8 * rows_per_warp + w + 8 * i of batch element b, i <
// rows_per_warp.  A warp copies its next row of x and g into its ring with
// 16-byte cp.async while it works on the current one; lane l works on the
// four-value vectors l + 32 c (c < 9) of the row, reading them from the
// slot three times: sum x and sum dxh (dxh = g * (1 + scale)); sum
// (x - mean)^2 and sum dxh * (x - mean); then dx and the column sums.
// m2 = mean(dxh * xhat) is inv * mean(dxh * (x - mean)).  The lane's 36
// columns keep their sums of g * xhat and g in registers over every row of
// the warp.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
adaln_bwd_ring(const BwdArgs<T> a) {
  using V = Vec4<T>;
  using Raw = typename V::Raw;
  using S = RingShape<T>;
  constexpr int kC = kRowWidth / 128;
  constexpr float kD = static_cast<float>(kRowWidth);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s1 = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* ring = smem + S::kScaleBytes + warp * S::kWarpBytes;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kBwdWarps * a.rows_per_warp + warp;
  const int rows = r0 >= a.n ? 0
                             : min(a.rows_per_warp,
                                   (a.n - r0 + kBwdWarps - 1) / kBwdWarps);

  // row i of the warp into slot i % kStages; one commit group a row, empty
  // past the warp's last row
  auto fetch = [&](int i) {
    if (i < rows) {
      const long long r = r0 + kBwdWarps * i;
      const unsigned char* xs = reinterpret_cast<const unsigned char*>(
          a.x + b * a.x_sb + r * a.x_sn);
      const unsigned char* gs = reinterpret_cast<const unsigned char*>(
          a.g + b * a.g_sb + r * a.g_sn);
      unsigned char* dst = ring + (i % kStages) * S::kSlotBytes;
#pragma unroll
      for (int k = lane; k < S::kCopies; k += 32) {
        const int off = 16 * k;
        cp_async16(dst + off,
                   off < S::kRowBytes ? xs + off : gs + (off - S::kRowBytes),
                   16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);
  const T* sc = a.scale + b * a.scale_sb;
  for (int j = threadIdx.x; j < kRowWidth; j += kBwdThreads)
    s1[j] = 1.0f + yat::to_f<T>(sc[j]);
  __syncthreads();

  const float4* s1v = reinterpret_cast<const float4*>(s1);
  float dsc[kC][4], dsh[kC][4];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsc[c][e] = dsh[c][e] = 0.f;

  for (int i = 0; i < rows; ++i) {
    fetch(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* slot = ring + (i % kStages) * S::kSlotBytes;
    const Raw* xr = reinterpret_cast<const Raw*>(slot);
    const Raw* gr = reinterpret_cast<const Raw*>(slot + S::kRowBytes);
    float sx = 0.f, sd = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float xv[4], gv[4];
      V::get(xr[lane + 32 * c], xv);
      V::get(gr[lane + 32 * c], gv);
      const float4 s = s1v[lane + 32 * c];
      sx += (xv[0] + xv[1]) + (xv[2] + xv[3]);
      sd += (gv[0] * s.x + gv[1] * s.y) + (gv[2] * s.z + gv[3] * s.w);
    }
    const float mean = yat::warp_sum(sx) / kD;
    const float m1 = yat::warp_sum(sd) / kD;
    float ss = 0.f, sm = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float xv[4], gv[4];
      V::get(xr[lane + 32 * c], xv);
      V::get(gr[lane + 32 * c], gv);
      const float4 s = s1v[lane + 32 * c];
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xc = xv[e] - mean;
        ss += xc * xc;
        sm += gv[e] * sv[e] * xc;
      }
    }
    const float inv = 1.0f / sqrtf(yat::warp_sum(ss) / kD + a.eps);
    const float m2 = yat::warp_sum(sm) / kD * inv;
    const long long r = r0 + kBwdWarps * i;
    Raw* out = reinterpret_cast<Raw*>(a.dx + b * a.dx_sb + r * a.dx_sn);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float xv[4], gv[4], dv[4];
      V::get(xr[lane + 32 * c], xv);
      V::get(gr[lane + 32 * c], gv);
      const float4 s = s1v[lane + 32 * c];
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xhat = (xv[e] - mean) * inv;
        dv[e] = inv * ((gv[e] * sv[e] - m1) - xhat * m2);
        dsc[c][e] += gv[e] * xhat;
        dsh[c][e] += gv[e];
      }
      out[lane + 32 * c] = V::put(dv);
    }
    __syncwarp();   // every lane has read the slot before it is refilled
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warps' column sums through their rings, added in warp order
  float* mine = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int j = 4 * (lane + 32 * c);
    *reinterpret_cast<float4*>(mine + j) =
        make_float4(dsc[c][0], dsc[c][1], dsc[c][2], dsc[c][3]);
    *reinterpret_cast<float4*>(mine + kRowWidth + j) =
        make_float4(dsh[c][0], dsh[c][1], dsh[c][2], dsh[c][3]);
  }
  __syncthreads();
  float* row = a.partial + (static_cast<long long>(b) * a.chunks +
                            blockIdx.x) * 2 * kRowWidth;
  for (int j = threadIdx.x; j < 2 * kRowWidth; j += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w)
      s += reinterpret_cast<const float*>(smem + S::kScaleBytes +
                                          w * S::kWarpBytes)[j];
    row[j] = s;
  }
  arrive_and_reduce(a);
}

// Any width, or rows off the vectors: blocks of kGenericRows rows.  Phase
// A, one warp per row: the row statistics and the two row means, kept in
// shared memory; phase B, one thread per column: dx of every row of the
// block and the block's sums of g * xhat and g, written to its row of
// `partial`; then the same reduce as the ring path.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
adaln_bwd_generic(const BwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*stats)[4] = reinterpret_cast<float(*)[4]>(smem);  // mean, inv, m1, m2
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kGenericRows;
  const int rows = min(kGenericRows, a.n - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = a.d;
  const float fd = static_cast<float>(d);
  const T* sc = a.scale + b * a.scale_sb;

  for (int r = warp; r < rows; r += kBwdWarps) {
    const T* xr = a.x + b * a.x_sb + (r0 + r) * a.x_sn;
    const T* gr = a.g + b * a.g_sb + (r0 + r) * a.g_sn;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s += yat::to_f<T>(xr[j]);
    const float mean = yat::warp_sum(s) / fd;
    float ss = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float c = yat::to_f<T>(xr[j]) - mean;
      ss += c * c;
    }
    const float inv = 1.0f / sqrtf(yat::warp_sum(ss) / fd + a.eps);
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float xhat = (yat::to_f<T>(xr[j]) - mean) * inv;
      const float dxh = yat::to_f<T>(gr[j]) * (1.0f + yat::to_f<T>(sc[j]));
      s1 += dxh;
      s2 += dxh * xhat;
    }
    s1 = yat::warp_sum(s1);
    s2 = yat::warp_sum(s2);
    if (lane == 0) {
      stats[r][0] = mean;
      stats[r][1] = inv;
      stats[r][2] = s1 / fd;
      stats[r][3] = s2 / fd;
    }
  }
  __syncthreads();

  float* row = a.partial +
               (static_cast<long long>(b) * a.chunks + blockIdx.x) * 2 * d;
  for (int j = threadIdx.x; j < d; j += kBwdThreads) {
    const float s1 = 1.0f + yat::to_f<T>(sc[j]);
    float dsc = 0.f, dsh = 0.f;
    for (int r = 0; r < rows; ++r) {
      const long long i = r0 + r;
      const float xv = yat::to_f<T>(a.x[b * a.x_sb + i * a.x_sn + j]);
      const float gv = yat::to_f<T>(a.g[b * a.g_sb + i * a.g_sn + j]);
      const float xhat = (xv - stats[r][0]) * stats[r][1];
      const float dxh = gv * s1;
      a.dx[b * a.dx_sb + i * a.dx_sn + j] = yat::from_f<T>(
          stats[r][1] * ((dxh - stats[r][2]) - xhat * stats[r][3]));
      dsc += gv * xhat;
      dsh += gv;
    }
    row[j] = dsc;
    row[d + j] = dsh;
  }
  arrive_and_reduce(a);
}

// whether the ring path takes this call: the width it is built for, x and
// g rows on 16-byte boundaries (the cp.async pieces), dx rows on
// four-value ones (the vector stores); scale is read a value at a time
template <typename T>
bool ring_path(const BwdArgs<T>& a) {
  constexpr long long kPiece = 16 / sizeof(T);
  auto al = [](const void* p, uintptr_t v) {
    return reinterpret_cast<uintptr_t>(p) % v == 0;
  };
  return a.d == kRowWidth && al(a.x, 16) && al(a.g, 16) &&
         al(a.dx, 4 * sizeof(T)) && a.x_sb % kPiece == 0 &&
         a.x_sn % kPiece == 0 && a.g_sb % kPiece == 0 &&
         a.g_sn % kPiece == 0 && a.dx_sb % 4 == 0 && a.dx_sn % 4 == 0;
}

// Launch K1b (info == nullptr), or write its path (1: the ring, 0: the
// generic loop), registers, local bytes, shared bytes and blocks per SM
// into info[0:5].
template <typename T>
cudaError_t launch_bwd(BwdArgs<T> a, int batch, cudaStream_t stream,
                       long long* info) {
  const bool ring = ring_path(a);
  int rows = kGenericRows;
  if (ring && info == nullptr) {
    // about one block per SM: a warp walks enough rows to cover the batch
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long long want = (static_cast<long long>(batch) * a.n +
                            kBwdWarps * sms - 1) / (kBwdWarps * sms);
    const long long whole = (a.n + kBwdWarps - 1) / kBwdWarps;
    a.rows_per_warp = static_cast<int>(
        std::max<long long>(kMinRowsPerWarp, std::min(want, whole)));
    rows = kBwdWarps * a.rows_per_warp;
  }
  const size_t smem =
      ring ? RingShape<T>::kSmem : kGenericRows * 4 * sizeof(float);
  auto kernel = ring ? adaln_bwd_ring<T> : adaln_bwd_generic<T>;
  if (info != nullptr) {
    info[0] = ring ? 1 : 0;
    return yat::attn::launch_info(kernel, smem, info + 1, kBwdThreads);
  }
  cudaError_t e = yat::attn::set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  a.chunks = (a.n + rows - 1) / rows;
  kernel<<<dim3(a.chunks, batch), kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int bwd_entry(const void* x, const void* scale, const void* g, void* dx,
              void* dscale, void* dshift, void* partial, void* arrivals,
              int b, int n, int d, long long x_sb, long long x_sn,
              long long scale_sb, long long g_sb, long long g_sn,
              long long dx_sb, long long dx_sn, float eps, void* stream,
              long long* info) {
  const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(scale),
                     static_cast<const T*>(g), static_cast<T*>(dx),
                     static_cast<T*>(dscale), static_cast<T*>(dshift),
                     static_cast<float*>(partial), static_cast<int*>(arrivals),
                     n, d, 0, 0, x_sb, x_sn, scale_sb, g_sb, g_sn, dx_sb, dx_sn,
                     eps};
  return static_cast<int>(
      launch_bwd<T>(a, b, static_cast<cudaStream_t>(stream), info));
}

int bwd_dispatch(const void* x, const void* scale, const void* g, void* dx,
                 void* dscale, void* dshift, void* partial, void* arrivals,
                 int b, int n, int d, long long x_sb, long long x_sn,
                 long long scale_sb, long long g_sb, long long g_sn,
                 long long dx_sb, long long dx_sn, float eps, int dtype,
                 void* stream, long long* info) {
  if (dtype == yat::kFloat32)
    return bwd_entry<float>(x, scale, g, dx, dscale, dshift, partial,
                            arrivals, b, n, d, x_sb, x_sn, scale_sb, g_sb,
                            g_sn, dx_sb, dx_sn, eps, stream, info);
  if (dtype == yat::kBFloat16)
    return bwd_entry<__nv_bfloat16>(x, scale, g, dx, dscale, dshift, partial,
                                    arrivals, b, n, d, x_sb, x_sn, scale_sb,
                                    g_sb, g_sn, dx_sb, dx_sn, eps, stream,
                                    info);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The most N-chunks a K1b launch cuts: `partial` holds
// [B][yat_adaln_bwd_chunks(n)][2][D] fp32 values.
extern "C" int yat_adaln_bwd_chunks(int n) {
  return (n + kGenericRows - 1) / kGenericRows;
}

// K1b, one launch.  x, g, dx [B, N, D] with strides (*_sb, *_sn, 1); scale
// [B, D] with strides (scale_sb, 1); dscale/dshift [B, D] contiguous, in
// scale's dtype (the dtype of x); partial: fp32 scratch of
// yat_adaln_bwd_chunks(n) chunks; arrivals: int32 [B], all 0, and left so.
extern "C" int yat_adaln_bwd(const void* x, const void* scale, const void* g,
                             void* dx, void* dscale, void* dshift,
                             void* partial, void* arrivals, int b, int n,
                             int d, long long x_sb, long long x_sn,
                             long long scale_sb, long long g_sb,
                             long long g_sn, long long dx_sb,
                             long long dx_sn, float eps, int dtype,
                             void* stream) {
  return bwd_dispatch(x, scale, g, dx, dscale, dshift, partial, arrivals, b,
                      n, d, x_sb, x_sn, scale_sb, g_sb, g_sn, dx_sb, dx_sn,
                      eps, dtype, stream, nullptr);
}

// The launch yat_adaln_bwd makes for the same arguments, without making it:
// path (1: the ring, 0: the generic loop), registers a thread, local
// (spill) bytes a thread, shared bytes and blocks per SM into info[0:5].
extern "C" int yat_adaln_bwd_info(const void* x, const void* scale,
                                  const void* g, void* dx, void* dscale,
                                  void* dshift, void* partial,
                                  void* arrivals, int b, int n, int d,
                                  long long x_sb, long long x_sn,
                                  long long scale_sb, long long g_sb,
                                  long long g_sn, long long dx_sb,
                                  long long dx_sn, float eps, int dtype,
                                  void* info) {
  return bwd_dispatch(x, scale, g, dx, dscale, dshift, partial, arrivals, b,
                      n, d, x_sb, x_sn, scale_sb, g_sb, g_sn, dx_sb, dx_sn,
                      eps, dtype, nullptr, static_cast<long long*>(info));
}

static int fwd_entry(const void* x, const void* scale, const void* shift,
                     void* out, int b, int n, int d, long long x_sb,
                     long long x_sn, long long scale_sb, long long shift_sb,
                     long long out_sb, long long out_sn, float eps, int dtype,
                     void* stream, long long* info) {
  const FwdArgs a{static_cast<long long>(b) * n, n, d, x_sb, x_sn, scale_sb,
                  shift_sb, out_sb, out_sn, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == yat::kFloat32)
    return static_cast<int>(launch<float>(x, scale, shift, out, a, s, info));
  if (dtype == yat::kBFloat16)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, scale, shift, out, a, s, info));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [B, N, D] with strides (x_sb, x_sn, 1); scale/shift [B, D] with
// strides (*_sb, 1); out [B, N, D] with strides (out_sb, out_sn, 1).
extern "C" int yat_adaln_fwd(const void* x, const void* scale,
                             const void* shift, void* out, int b, int n,
                             int d, long long x_sb, long long x_sn,
                             long long scale_sb, long long shift_sb,
                             long long out_sb, long long out_sn, float eps,
                             int dtype, void* stream) {
  return fwd_entry(x, scale, shift, out, b, n, d, x_sb, x_sn, scale_sb,
                   shift_sb, out_sb, out_sn, eps, dtype, stream, nullptr);
}

// The launch yat_adaln_fwd makes for the same arguments, without making it:
// path (1: the row in registers, 0: the generic loop), registers a thread,
// local (spill) bytes a thread, shared bytes and blocks per SM into
// info[0:5].
extern "C" int yat_adaln_fwd_info(const void* x, const void* scale,
                                  const void* shift, void* out, int b, int n,
                                  int d, long long x_sb, long long x_sn,
                                  long long scale_sb, long long shift_sb,
                                  long long out_sb, long long out_sn,
                                  float eps, int dtype, void* info) {
  return fwd_entry(x, scale, shift, out, b, n, d, x_sb, x_sn, scale_sb,
                   shift_sb, out_sb, out_sn, eps, dtype, nullptr,
                   static_cast<long long*>(info));
}
