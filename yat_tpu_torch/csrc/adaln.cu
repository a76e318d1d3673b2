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
// per element).  Design:
//   * blocks of 16 token rows of one batch element (256 blocks at the
//     training shape [16, 256, 1152], where one block per batch element
//     would give 16);
//   * phase A, one warp per row: the row statistics and the two row means
//     of the LayerNorm backward, kept in shared memory;
//   * phase B, one thread per column: dx of every row of the block, with
//     the block's dscale/dshift partial sums over its rows in registers;
//     the chunk re-reads its rows (~70 KB) from L1/L2, not from HBM;
//   * the partial sums go to an fp32 scratch and a second small launch
//     adds them in chunk order: no float atomics, so the result is the
//     same from run to run.
#include "common.cuh"

#include <stdint.h>

namespace {

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

constexpr int kBwdThreads = 256;   // 8 warps
constexpr int kBwdRows = 16;       // token rows per block (one chunk of N)

// Phase A, one warp per row: mean and 1/sqrt(var + eps) of x, then
// m1 = mean(dxh) and m2 = mean(dxh * xhat) with dxh = g * (1 + scale).
// Phase B, one thread per column: dx for every row of the chunk, and the
// chunk's fp32 partial sums of g * xhat (dscale) and g (dshift), written
// to `partial` [2][B][chunks][D] for the reduce launch.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
adaln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partial, int batch, int n, int d,
                 long long x_sb, long long x_sn, long long scale_sb,
                 long long g_sb, long long g_sn, long long dx_sb,
                 long long dx_sn, float eps) {
  __shared__ float stats[kBwdRows][4];   // mean, inv, m1, m2
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int r0 = chunk * kBwdRows;
  const int rows = min(kBwdRows, n - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float fd = static_cast<float>(d);
  const T* sc = scale + b * scale_sb;

  for (int r = warp; r < rows; r += kBwdThreads / 32) {
    const T* xr = x + b * x_sb + (r0 + r) * x_sn;
    const T* gr = g + b * g_sb + (r0 + r) * g_sn;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s += yat::to_f<T>(xr[j]);
    const float mean = yat::warp_sum(s) / fd;
    float ss = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float c = yat::to_f<T>(xr[j]) - mean;
      ss += c * c;
    }
    const float inv = 1.0f / sqrtf(yat::warp_sum(ss) / fd + eps);
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

  float* p_sc = partial + (static_cast<long long>(b) * chunks + chunk) * d;
  float* p_sh = p_sc + static_cast<long long>(batch) * chunks * d;
  for (int j = threadIdx.x; j < d; j += kBwdThreads) {
    const float s1 = 1.0f + yat::to_f<T>(sc[j]);
    float dsc = 0.f, dsh = 0.f;
    for (int r = 0; r < rows; ++r) {
      const long long i = r0 + r;
      const float xv = yat::to_f<T>(x[b * x_sb + i * x_sn + j]);
      const float gv = yat::to_f<T>(g[b * g_sb + i * g_sn + j]);
      const float xhat = (xv - stats[r][0]) * stats[r][1];
      const float dxh = gv * s1;
      dx[b * dx_sb + i * dx_sn + j] = yat::from_f<T>(
          stats[r][1] * ((dxh - stats[r][2]) - xhat * stats[r][3]));
      dsc += gv * xhat;
      dsh += gv;
    }
    p_sc[j] = dsc;
    p_sh[j] = dsh;
  }
}

// dscale/dshift [B, D] (contiguous): the chunks' partial sums added in
// chunk order, so the result does not depend on the schedule.
template <typename T>
__global__ void adaln_bwd_reduce(const float* __restrict__ partial,
                                 T* __restrict__ dscale,
                                 T* __restrict__ dshift, int batch,
                                 int chunks, int d) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(batch) * d) return;
  const long long b = idx / d;
  const long long j = idx - b * d;
  const float* p_sc = partial + b * chunks * d + j;
  const float* p_sh = p_sc + static_cast<long long>(batch) * chunks * d;
  float s = 0.f, t = 0.f;
  for (int c = 0; c < chunks; ++c) {
    s += p_sc[static_cast<long long>(c) * d];
    t += p_sh[static_cast<long long>(c) * d];
  }
  dscale[idx] = yat::from_f<T>(s);
  dshift[idx] = yat::from_f<T>(t);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* scale, const void* g,
                       void* dx, void* dscale, void* dshift, void* partial,
                       int b, int n, int d, long long x_sb, long long x_sn,
                       long long scale_sb, long long g_sb, long long g_sn,
                       long long dx_sb, long long dx_sn, float eps,
                       cudaStream_t stream) {
  const int chunks = (n + kBwdRows - 1) / kBwdRows;
  adaln_bwd_kernel<T><<<dim3(chunks, b), kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(partial), b, n, d, x_sb, x_sn, scale_sb, g_sb,
      g_sn, dx_sb, dx_sn, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(b) * d;
  adaln_bwd_reduce<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        stream>>>(static_cast<const float*>(partial),
                                  static_cast<T*>(dscale),
                                  static_cast<T*>(dshift), b, chunks, d);
  return cudaGetLastError();
}

}  // namespace

// Number of N-chunks of the backward: `partial` holds [2][B][chunks][D]
// fp32 values.
extern "C" int yat_adaln_bwd_chunks(int n) {
  return (n + kBwdRows - 1) / kBwdRows;
}

// K1b.  x, g, dx [B, N, D] with strides (*_sb, *_sn, 1); scale [B, D] with
// strides (scale_sb, 1); dscale/dshift [B, D] contiguous, in scale's dtype
// (the dtype of x); partial: fp32 scratch of yat_adaln_bwd_chunks(n) rows.
extern "C" int yat_adaln_bwd(const void* x, const void* scale, const void* g,
                             void* dx, void* dscale, void* dshift,
                             void* partial, int b, int n, int d,
                             long long x_sb, long long x_sn,
                             long long scale_sb, long long g_sb,
                             long long g_sn, long long dx_sb,
                             long long dx_sn, float eps, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == yat::kFloat32)
    return launch_bwd<float>(x, scale, g, dx, dscale, dshift, partial, b, n,
                             d, x_sb, x_sn, scale_sb, g_sb, g_sn, dx_sb,
                             dx_sn, eps, s);
  if (dtype == yat::kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, scale, g, dx, dscale, dshift,
                                     partial, b, n, d, x_sb, x_sn, scale_sb,
                                     g_sb, g_sn, dx_sb, dx_sn, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
