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
//   * one warp per token row, so B*N rows (2048 on the serving path) spread
//     over all SMs, where one block per batch element would give 8 blocks;
//   * the row is staged once in shared memory as fp32, so the mean, the
//     variance and the normalize pass read device memory once;
//   * fp32 statistics reduced with warp shuffles.
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

namespace {

constexpr int kRowsPerBlock = 8;   // one warp per row, 256 threads

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
adaln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                 const T* __restrict__ shift, T* __restrict__ out,
                 long long rows, int n, int d,
                 long long x_sb, long long x_sn,
                 long long scale_sb, long long shift_sb,
                 long long out_sb, long long out_sn, float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= rows) return;
  const long long b = row / n;
  const long long i = row % n;
  const T* xr = x + b * x_sb + i * x_sn;
  // each lane reads back only the entries it wrote: no barrier needed
  float* xs = smem + static_cast<long long>(warp) * d;

  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = yat::to_f<T>(xr[j]);
    xs[j] = v;
    s += v;
  }
  const float mean = yat::warp_sum(s) / static_cast<float>(d);
  float ss = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float c = xs[j] - mean;
    ss += c * c;
  }
  const float var = yat::warp_sum(ss) / static_cast<float>(d);
  const float inv = 1.0f / sqrtf(var + eps);

  const float mean_c = yat::rnd<T>(mean);
  const float inv_c = yat::rnd<T>(inv);
  const T* sc = scale + b * scale_sb;
  const T* sh = shift + b * shift_sb;
  T* orow = out + b * out_sb + i * out_sn;
  for (int j = lane; j < d; j += 32) {
    float y = yat::rnd<T>(__fsub_rn(xs[j], mean_c));
    y = yat::rnd<T>(__fmul_rn(y, inv_c));
    const float s1 = yat::rnd<T>(__fadd_rn(1.0f, yat::to_f<T>(sc[j])));
    y = yat::rnd<T>(__fmul_rn(y, s1));
    orow[j] = yat::from_f<T>(__fadd_rn(y, yat::to_f<T>(sh[j])));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* out, int b, int n, int d, long long x_sb,
                   long long x_sn, long long scale_sb, long long shift_sb,
                   long long out_sb, long long out_sn, float eps,
                   cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * n;
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = static_cast<size_t>(kRowsPerBlock) * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adaln_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  adaln_fwd_kernel<T><<<blocks, kRowsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(out), rows, n, d, x_sb,
      x_sn, scale_sb, shift_sb, out_sb, out_sn, eps);
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

// x [B, N, D] with strides (x_sb, x_sn, 1); scale/shift [B, D] with
// strides (*_sb, 1); out [B, N, D] with strides (out_sb, out_sn, 1).
extern "C" int yat_adaln_fwd(const void* x, const void* scale,
                             const void* shift, void* out, int b, int n,
                             int d, long long x_sb, long long x_sn,
                             long long scale_sb, long long shift_sb,
                             long long out_sb, long long out_sn, float eps,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == yat::kFloat32)
    return launch<float>(x, scale, shift, out, b, n, d, x_sb, x_sn, scale_sb,
                         shift_sb, out_sb, out_sn, eps, s);
  if (dtype == yat::kBFloat16)
    return launch<__nv_bfloat16>(x, scale, shift, out, b, n, d, x_sb, x_sn,
                                 scale_sb, shift_sb, out_sb, out_sn, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
