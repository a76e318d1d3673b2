// K5: the w8a8 matmul forward, y = x @ dequant(q)^T with the activation
//     quantized per row on the fly:
//       x_scale = absmax_row(x) * fp32(1/127)   (1 for a zero row),
//       x8      = clamp(rint(x / x_scale), -127, 127),
//       y       = ((float)(x8 . q) * x_scale[row]) * w_scale[col].
// Replaces the TPU kernel yat_tpu/ops/quant.py:_i8_fwd_kernel (called
// through _pallas_w8a8_fwd2d), which quantized its row tile into VMEM at the
// first N block and reused it for the others.
//
// K5b: its straight-through backward, replacing _i8_bwd_kernel (through
// _pallas_w8a8_bwd2d):
//       g32 = g * w_scale[col],  (g8, g_scale) = row quantization of g32,
//       dx  = (float)(g8 . q over N) * g_scale[row].
//
// Rounding follows the plain versions (ops/quant.py:w8a8_matmul_ref and
// w8a8_matmul_bwd_ref), which follow the JAX package as its jitted step runs
// it: the row scale is a product with the fp32 reciprocal of 127 (XLA's
// rewrite of the division by a constant), the payload an IEEE division
// (nvcc's default -prec-div, no fast math) rounded half to even by rintf,
// the sums exact in int32 (|acc| <= 6144 * 127^2 < 2^31), the epilogue two
// fp32 products in that order and one rounding to the output type.  Every
// step is exact or correctly rounded, so kernel and plain version agree bit
// for bit.
//
// Bound on the H100: at the SANA-0.6B shapes ([4096, 1152] x [1152 -> 1152],
// 10.9 G int8 operations, ~20 MB) the bytes and the int8 tensor-core rate
// give about the same time (6 us), so both matter.  Design, simple first:
//   * one entry point, two launches: a row-quantize pass (one warp per row,
//     the row read twice, the second time from L2) that writes the int8
//     payload and the row scales to scratch the wrapper allocates, then a
//     tiled int8 GEMM;
//   * the GEMM: 128x128 output tiles, 8 warps each owning 64x32, 64-byte
//     deep contraction steps, mma.sync.m16n8k32 s8 x s8 -> s32, two
//     shared-memory stages filled from registers (the next tile's loads are
//     in flight while the current one is multiplied), rows padded to 80
//     bytes so the fragment loads hit 32 distinct banks, and the epilogue
//     fused into the store;
//   * both int8 operands of mma.sync must be K-major ("row.col").  In the
//     forward, x8 [T, K] and the weight [N, K] already are.  K5b contracts
//     over the weight's leading dim N, so it transposes each [64 N, 128 K]
//     byte tile while staging it: every thread loads 4 rows x 4 bytes and
//     turns them into 4 columns with __byte_perm.  No transposed copy of the
//     frozen weight is kept (it would add one byte per weight).
// wgmma and TMA come in a later change.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 64;        // contraction bytes per stage
constexpr int kLd = kBK + 16;  // shared row stride in bytes
constexpr int kThreads = 256;
constexpr float kRecip127 = 1.0f / 127.0f;

// ---------------------------------------------------------------------------
// Row quantization: one warp per row, 4 consecutive values per lane, K a
// multiple of 128.  kColScale multiplies column j by col_scale[j] first (the
// backward's g * w_scale).
// ---------------------------------------------------------------------------

template <typename T, bool kColScale>
__device__ __forceinline__ float load_scaled(const T* __restrict__ row,
                                             const float* __restrict__ cs,
                                             int j) {
  const float v = yat::to_f<T>(row[j]);
  return kColScale ? __fmul_rn(v, cs[j]) : v;
}

template <typename T, bool kColScale>
__device__ __forceinline__ void row_quantize(const T* __restrict__ x,
                                             const float* __restrict__ col_scale,
                                             int8_t* __restrict__ x8,
                                             float* __restrict__ scale, int rows,
                                             int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp;
  if (row >= rows) return;
  const T* xr = x + row * k;
  float amax = 0.f;
  for (int j = lane * 4; j < k; j += 128) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      amax = fmaxf(amax, fabsf(load_scaled<T, kColScale>(xr, col_scale, j + e)));
  }
  amax = yat::warp_max(amax);
  const float s = amax > 0.f ? __fmul_rn(amax, kRecip127) : 1.0f;
  uint32_t* out = reinterpret_cast<uint32_t*>(x8 + row * k);
  for (int j = lane * 4; j < k; j += 128) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = load_scaled<T, kColScale>(xr, col_scale, j + e);
      const float r = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
      word |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xffu) << (8 * e);
    }
    out[j >> 2] = word;
  }
  if (lane == 0) scale[row] = s;
}

// ---------------------------------------------------------------------------
// The int8 GEMM: C[M, Nout] = A[M, Kc] . B, A K-major.  !kTransB: B is
// [Nout, Kc] (K-major, the forward's weight); kTransB: B is [Kc, Nout] (the
// backward's weight read over its leading dim).  Epilogue:
// out = ((float)acc * row_scale[m]) * col_scale[n] (col_scale may be null).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4x4 byte transpose: out[j] holds byte j of w0, w1, w2, w3 (in that order)
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// One stage's global reads, held in registers until they are stored.
struct Stage {
  uint4 a[2];        // two 16-byte chunks of the A tile
  uint4 b[2];        // !kTransB: two 16-byte chunks of the B tile
  uint32_t bt[2][4]; // kTransB: two 4x4 byte blocks (4 rows of 4 bytes)
};

template <bool kTransB>
__device__ __forceinline__ void load_stage(Stage& st, const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b, int kc,
                                           int nout, int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // 128 rows x 4 chunks of 16 bytes = 512 chunks, two per thread
    const int c = tid + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 16;
    st.a[i] = *reinterpret_cast<const uint4*>(a + static_cast<long long>(m0 + r) * kc + k0 + col);
    if (!kTransB)
      st.b[i] = *reinterpret_cast<const uint4*>(b + static_cast<long long>(n0 + r) * kc + k0 + col);
  }
  if (kTransB) {
    // the [64 K, 128 N] byte tile in 16 x 32 blocks of 4x4; a warp takes 8
    // neighbouring N blocks of 4 K rows, so each row read is a full 32-byte
    // sector
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 2 + i;           // 16 groups of 32 blocks
      const int kb = (blk & 3) * 4 + (lane >> 3);
      const int nb = (blk >> 2) * 8 + (lane & 7);
      const int8_t* src = b + static_cast<long long>(k0 + kb * 4) * nout + n0 + nb * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        st.bt[i][r] = *reinterpret_cast<const uint32_t*>(src + static_cast<long long>(r) * nout);
    }
  }
}

template <bool kTransB>
__device__ __forceinline__ void store_stage(const Stage& st, int8_t* as, int8_t* bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 16;
    *reinterpret_cast<uint4*>(as + r * kLd + col) = st.a[i];
    if (!kTransB) *reinterpret_cast<uint4*>(bs + r * kLd + col) = st.b[i];
  }
  if (kTransB) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 2 + i;
      const int kb = (blk & 3) * 4 + (lane >> 3);
      const int nb = (blk >> 2) * 8 + (lane & 7);
      uint32_t o[4];
      transpose4x4(st.bt[i], o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(bs + (nb * 4 + j) * kLd + kb * 4) = o[j];
    }
  }
}

template <typename T, bool kTransB>
__device__ __forceinline__ void int8_gemm(const int8_t* __restrict__ a,
                                          const int8_t* __restrict__ b,
                                          const float* __restrict__ row_scale,
                                          const float* __restrict__ col_scale,
                                          T* __restrict__ out, int m, int kc,
                                          int nout) {
  __shared__ __align__(16) int8_t smem[2][2][kBM * kLd];  // [stage][A/B]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 64;   // warp's rows in the tile
  const int wn = (warp & 3) * 32;    // warp's columns in the tile
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  Stage st;
  load_stage<kTransB>(st, a, b, kc, nout, m0, n0, 0);
  store_stage<kTransB>(st, smem[0][0], smem[0][1]);
  __syncthreads();

  const int steps = kc / kBK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load_stage<kTransB>(st, a, b, kc, nout, m0, n0, (s + 1) * kBK);
    const int8_t* as = smem[cur][0];
    const int8_t* bs = smem[cur][1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as + (wm + i * 16 + g) * kLd + kk + t4 * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn + j * 8 + g) * kLd + kk + t4 * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (s + 1 < steps) store_stage<kTransB>(st, smem[cur ^ 1][0], smem[cur ^ 1][1]);
    __syncthreads();
  }

  // epilogue: accumulator (i, j) holds rows g and g + 8 of the 16-row tile,
  // columns 2 * t4 and 2 * t4 + 1 of the 8-column tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      const float rs = row_scale[row];
      T* orow = out + static_cast<long long>(row) * nout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + t4 * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = __fmul_rn(static_cast<float>(acc[i][j][h * 2 + e]), rs);
          if (col_scale != nullptr) v = __fmul_rn(v, col_scale[col + e]);
          orow[col + e] = yat::from_f<T>(v);
        }
      }
    }
  }
}

// The four launches, named so that a profile tells K5's from K5b's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_fwd_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                         float* __restrict__ x_scale, int rows, int k) {
  row_quantize<T, false>(x, nullptr, x8, x_scale, rows, k);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_fwd_gemm_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ q,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale, T* __restrict__ y, int t,
                     int k, int n) {
  int8_gemm<T, false>(x8, q, x_scale, w_scale, y, t, k, n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_bwd_quantize_kernel(const T* __restrict__ g, const float* __restrict__ w_scale,
                         int8_t* __restrict__ g8, float* __restrict__ g_scale,
                         int rows, int n) {
  row_quantize<T, true>(g, w_scale, g8, g_scale, rows, n);
}

// dx [T, K] = g8 [T, N] . q [N, K] over N: q is read over its leading dim
template <typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_bwd_gemm_kernel(const int8_t* __restrict__ g8, const int8_t* __restrict__ q,
                     const float* __restrict__ g_scale, T* __restrict__ dx, int t,
                     int k, int n) {
  int8_gemm<T, true>(g8, q, g_scale, nullptr, dx, t, n, k);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* q, const void* w_scale,
                       void* y, void* x8, void* x_scale, int t, int k, int n,
                       cudaStream_t stream) {
  const int rows_per_block = kThreads / 32;
  w8a8_fwd_quantize_kernel<T><<<(t + rows_per_block - 1) / rows_per_block,
                                 kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(x8),
      static_cast<float*>(x_scale), t, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  w8a8_fwd_gemm_kernel<T><<<dim3(n / kBN, t / kBM), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const int8_t*>(q),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<T*>(y), t, k, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* q, const void* w_scale,
                       void* dx, void* g8, void* g_scale, int t, int k, int n,
                       cudaStream_t stream) {
  const int rows_per_block = kThreads / 32;
  w8a8_bwd_quantize_kernel<T><<<(t + rows_per_block - 1) / rows_per_block,
                                 kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(w_scale),
      static_cast<int8_t*>(g8), static_cast<float*>(g_scale), t, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  w8a8_bwd_gemm_kernel<T><<<dim3(k / kBN, t / kBM), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(g8), static_cast<const int8_t*>(q),
      static_cast<const float*>(g_scale), static_cast<T*>(dx), t, k, n);
  return cudaGetLastError();
}

bool shapes_ok(int t, int k, int n) {
  return t > 0 && t % kBM == 0 && k % 128 == 0 && n % 128 == 0 && k > 0 &&
         n > 0 && k <= 6144 && n <= 6144;
}

}  // namespace

// x [T, K] (fp32 or bf16), q [N, K] int8, w_scale [N] fp32 -> y [T, N] in
// x's type; x8 [T, K] int8 and x_scale [T] fp32 are scratch the caller
// reads back if it wants the payload.  All contiguous.
extern "C" int yat_w8a8_fwd(const void* x, const void* q, const void* w_scale,
                            void* y, void* x8, void* x_scale, int t, int k,
                            int n, int dtype, void* stream) {
  if (!shapes_ok(t, k, n)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == yat::kBFloat16)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(x, q, w_scale, y, x8, x_scale, t, k, n, s));
  return static_cast<int>(launch_fwd<float>(x, q, w_scale, y, x8, x_scale, t, k, n, s));
}

// g [T, N] (fp32 or bf16), q [N, K] int8, w_scale [N] fp32 -> dx [T, K] in
// g's type; g8 [T, N] int8 and g_scale [T] fp32 are scratch.
extern "C" int yat_w8a8_bwd(const void* g, const void* q, const void* w_scale,
                            void* dx, void* g8, void* g_scale, int t, int k,
                            int n, int dtype, void* stream) {
  if (!shapes_ok(t, k, n)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == yat::kBFloat16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(g, q, w_scale, dx, g8, g_scale, t, k, n, s));
  return static_cast<int>(launch_bwd<float>(g, q, w_scale, dx, g8, g_scale, t, k, n, s));
}
