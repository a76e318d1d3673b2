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
// rewrite of the division by a constant), the payload the correctly
// rounded quotient (an IEEE division there; here the same bits by a
// reciprocal and one FMA correction) rounded half to even by rintf, the
// sums exact in int32 (|acc| <= 6144 * 127^2 < 2^31), the epilogue two
// fp32 products in that order and one rounding to the output type.  Every
// step is exact or correctly rounded, so kernel and plain version agree bit
// for bit, whatever the tile or the order of the sums.
//
// Bound on the H100: at the SANA-0.6B shapes ([4096, 1152] x [1152 -> 1152],
// 10.9 G int8 operations, ~20 MB) the bytes and the int8 tensor-core rate
// give about the same time (6 us), so both matter; at K = 1152 a tile sees
// only nine ring stages, and its A and B tiles come again and again from
// L2, so the fill, the epilogue and the L2 traffic weigh too.  Design:
//   * one entry point, two launches: a row-quantize pass that writes the
//     int8 payload and the row scales to scratch the wrapper allocates, then
//     the int8 GEMM.  The quantize stays a launch of its own: the GEMM's
//     column tiles of one row block run in parallel on different SMs, and a
//     fused quantize would repeat the division once per column tile;
//   * the quantize: one warp per row, 16 consecutive values a lane per
//     step in 16-byte loads, the row held in registers between the absmax
//     and the payload (up to 6144 bf16 or 2048 fp32 values; longer fp32
//     rows are read again), the quotient a multiply by the row's
//     reciprocal with an FMA correction (bit-equal to the division),
//     16-byte payload stores;
//   * the GEMM, one body for both kernels (int8_gemm): C[M, Nout] = A . B
//     over Kc with A [M, Kc] K-major.  A block is a producer warpgroup and
//     two consumer warpgroups.  One producer thread keeps TMA loads
//     (cp.async.bulk.tensor.2d, 128-byte swizzle) of A and B tiles in
//     flight through a ring of full/empty mbarrier pairs, 128 contraction
//     bytes a stage, as many stages as fit in 220 KB (4 to 6).  Each
//     consumer warpgroup owns 64 rows of a 128 x 128 tile and issues
//     wgmma.mma_async m64n128k32 s8.s8 -> s32 from shared-memory
//     descriptors, four k32 steps a stage (the descriptor's start address
//     advances 32 bytes a step inside the swizzle span), one group in
//     flight while it waits for the next stage; the accumulators stay in
//     registers (setmaxnreg moves registers from the producer to the
//     consumers).  The grid is persistent (one block per SM walks the
//     tiles; one block a tile when there are fewer tiles than SMs), so a
//     tile's epilogue overlaps the next tile's loads;
//   * one tile, 128 x 128, for both kernels and every shape: wider K5
//     tiles (128 x 192, 128 x 256) gained at most a few per cent at the
//     shapes measured and lost at SANA's GLUMB up-projection, and K5b's
//     transposers take 128 columns (PERF.md, PR 8);
//   * the epilogue: ((float)acc * row_scale) * col_scale (forward only),
//     the scales loaded while the tile's products run, one rounding, then
//     16-byte stores after a shuffle among the four lanes that share a row;
//   * int8 wgmma takes B only K-major.  In the forward the weight q [N, K]
//     is.  K5b contracts over q's leading dim N: each q tile [128 N, 128 K]
//     lands by TMA (unswizzled) in a staging buffer, and two transposer
//     warps of the producer warpgroup turn it into the swizzled K-major B
//     stage, a 16 x 16 byte block a lane (16-byte reads and writes free of
//     bank conflicts, 4x4 byte transposes by prmt), then arrive on the
//     stage's full barrier.  No transposed copy of the frozen weight is
//     kept, and no transpose launch is added.
#include <cuda.h>

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kBM = 128;             // output rows per tile
constexpr int kBN = 128;             // output columns per tile
constexpr int kBK = 128;             // contraction bytes per ring stage
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kTransposers = 2;      // K5b: warps 1-2 of the producer group
constexpr int kRingBytes = 220 * 1024;
constexpr int kQThreads = 256;       // quantize block
constexpr float kRecip127 = 1.0f / 127.0f;

// ---------------------------------------------------------------------------
// Hopper primitives (inline PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// waits until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 2-D tensor map (c0 the inner coordinate) into shared memory,
// completing on bar's transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma issue or wait
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// The matrix descriptor of a K-major tile with the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO), the leading offset
// unused (1), the tile 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

#define YAT_ACC8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),              \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32, both
// operands from shared memory; scale_d = 0 overwrites d.  Thread (warp w,
// lane 4g+t) holds d[4j + e] = (row 16w + g + 8(e >> 1), column 8j + 2t +
// (e & 1)).
__device__ __forceinline__ void wgmma_s8(int (&d)[kBN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : YAT_ACC8(0), YAT_ACC8(8), YAT_ACC8(16), YAT_ACC8(24),
        YAT_ACC8(32), YAT_ACC8(40), YAT_ACC8(48), YAT_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef YAT_ACC8

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

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// Row quantization: one warp per row, 16 consecutive values a lane per
// chunk, chunks e = lane, lane + 32, ...; kHold chunks a lane held in
// registers between the absmax and the payload (the rest read again).
// kColScale multiplies column j by col_scale[j] first (the backward's
// g * w_scale).  Every dim is a multiple of 128, so no block is partial.
// ---------------------------------------------------------------------------

// 16 values from 16-byte loads
template <typename T>
struct Chunk {
  static constexpr int kVecs = sizeof(T);  // uint4 loads: 2 bf16, 4 fp32
  uint4 v[kVecs];
};

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* p) {
#pragma unroll
  for (int i = 0; i < Chunk<T>::kVecs; ++i)
    c.v[i] = reinterpret_cast<const uint4*>(p)[i];
}

template <typename T, bool kColScale>
__device__ __forceinline__ void unpack(const Chunk<T>& c, const float* cs,
                                       float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < Chunk<T>::kVecs; ++i) {
    const uint32_t w[4] = {c.v[i].x, c.v[i].y, c.v[i].z, c.v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 2) {
        f[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
        f[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      } else {
        f[4 * i + j] = __uint_as_float(w[j]);
      }
    }
  }
  if constexpr (kColScale) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 s = reinterpret_cast<const uint4*>(cs)[i];
      f[4 * i] = __fmul_rn(f[4 * i], __uint_as_float(s.x));
      f[4 * i + 1] = __fmul_rn(f[4 * i + 1], __uint_as_float(s.y));
      f[4 * i + 2] = __fmul_rn(f[4 * i + 2], __uint_as_float(s.z));
      f[4 * i + 3] = __fmul_rn(f[4 * i + 3], __uint_as_float(s.w));
    }
  }
}

__device__ __forceinline__ float chunk_amax(const float (&f)[16], float m) {
#pragma unroll
  for (int j = 0; j < 16; ++j) m = fmaxf(m, fabsf(f[j]));
  return m;
}

// The payload of 16 values: rint(v / s) clamped to +-127, the quotient as
// v * r plus one FMA correction with r = 1 / s correctly rounded
// (Markstein's step: the correctly rounded quotient wherever it is normal;
// a subnormal quotient rounds to 0 either way), so the bits are those of
// an IEEE division.
__device__ __forceinline__ uint4 chunk_payload(const float (&f)[16], float s,
                                               float r) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float q0 = __fmul_rn(f[j], r);
    const float q = fmaf(fmaf(-q0, s, f[j]), r, q0);
    const float v = fminf(fmaxf(rintf(q), -127.f), 127.f);
    w[j >> 2] |= (static_cast<uint32_t>(static_cast<int>(v)) & 0xffu)
                 << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, bool kColScale, int kHold>
__device__ __forceinline__ void row_quantize(const T* __restrict__ x,
                                             const float* __restrict__ col_scale,
                                             int8_t* __restrict__ x8,
                                             float* __restrict__ scale, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kQThreads + threadIdx.x) >> 5;
  const int chunks = k >> 4;
  const T* xr = x + row * k;
  Chunk<T> held[kHold];
  float f[16];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kHold; ++i) {
    const int e = lane + 32 * i;
    if (e < chunks) {
      load_chunk(held[i], xr + 16 * e);
      unpack<T, kColScale>(held[i], col_scale + 16 * e, f);
      amax = chunk_amax(f, amax);
    }
  }
  for (int e = lane + 32 * kHold; e < chunks; e += 32) {
    Chunk<T> c;
    load_chunk(c, xr + 16 * e);
    unpack<T, kColScale>(c, col_scale + 16 * e, f);
    amax = chunk_amax(f, amax);
  }
  amax = yat::warp_max(amax);
  const float s = amax > 0.f ? __fmul_rn(amax, kRecip127) : 1.0f;
  const float r = 1.0f / s;
  uint4* out = reinterpret_cast<uint4*>(x8 + row * k);
#pragma unroll
  for (int i = 0; i < kHold; ++i) {
    const int e = lane + 32 * i;
    if (e < chunks) {
      unpack<T, kColScale>(held[i], col_scale + 16 * e, f);
      out[e] = chunk_payload(f, s, r);
    }
  }
  for (int e = lane + 32 * kHold; e < chunks; e += 32) {
    Chunk<T> c;
    load_chunk(c, xr + 16 * e);
    unpack<T, kColScale>(c, col_scale + 16 * e, f);
    out[e] = chunk_payload(f, s, r);
  }
  if (lane == 0) scale[row] = s;
}

// ---------------------------------------------------------------------------
// The int8 GEMM
// ---------------------------------------------------------------------------

template <bool kBwd>
struct Ring {
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = kBN * kBK;
  static constexpr int kSBytes = kBwd ? kBK * kBN : 0;  // K5b's staging
  static constexpr int kStageBytes = kABytes + kBBytes + kSBytes;
  static constexpr int kStages =
      kRingBytes / kStageBytes > 6 ? 6 : kRingBytes / kStageBytes;
  // 1024 bytes of alignment slack, the ring, three barriers a stage
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 3 * 8 * kStages;
  static_assert(kStages >= 3, "the ring needs three stages");
};

template <typename T>
struct GemmArgs {
  const float* row_scale;
  const float* col_scale;  // the forward's w_scale; unused by K5b
  T* out;
  int m, kc, nout;
};

// Scale a 4-chunk group of one accumulator row by its row (and column)
// scale, round to T and store it as 16-byte vectors.  Lane t of the quad
// holds columns 8j + 2t, 8j + 2t + 1 of chunks j = j0 .. j0 + 3.
template <typename T, bool kBwd>
__device__ __forceinline__ void store_group(const int (&acc)[kBN / 2], int j0,
                                            int h, float rs,
                                            const float2 (&cs)[kBN / 8],
                                            T* __restrict__ orow, int n0,
                                            int t) {
  float v[4][2];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = j0 + jj;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[jj][e] = __fmul_rn(static_cast<float>(acc[4 * j + 2 * h + e]), rs);
    if constexpr (!kBwd) {
      v[jj][0] = __fmul_rn(v[jj][0], cs[j].x);
      v[jj][1] = __fmul_rn(v[jj][1], cs[j].y);
    }
  }
  if constexpr (sizeof(T) == 2) {
    // a 4x4 transpose of 32-bit words across the quad: lane t ends with
    // the 8 columns of chunk j0 + t
    uint32_t w[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[jj][0], v[jj][1]);
      w[jj] = *reinterpret_cast<const uint32_t*>(&p);
    }
    const bool odd = t & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t r = __shfl_xor_sync(0xffffffffu, odd ? w[2 * i] : w[2 * i + 1], 1);
      if (odd) w[2 * i] = r; else w[2 * i + 1] = r;
    }
    const bool hi = t & 2;
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? w[0] : w[2], 2);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? w[1] : w[3], 2);
    if (hi) { w[0] = r0; w[1] = r1; } else { w[2] = r0; w[3] = r1; }
    *reinterpret_cast<uint4*>(orow + n0 + 8 * (j0 + t)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    // pairs of chunks: the even lane of a pair takes chunk j's four
    // columns from 2t, the odd lane chunk j + 1's from 2t - 2
    const bool odd = t & 1;
#pragma unroll
    for (int jj = 0; jj < 4; jj += 2) {
      const float s0 = odd ? v[jj][0] : v[jj + 1][0];
      const float s1 = odd ? v[jj][1] : v[jj + 1][1];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const int j = j0 + jj + (odd ? 1 : 0);
      const uint4 o = odd ? make_uint4(__float_as_uint(r0), __float_as_uint(r1),
                                       __float_as_uint(v[jj + 1][0]),
                                       __float_as_uint(v[jj + 1][1]))
                          : make_uint4(__float_as_uint(v[jj][0]),
                                       __float_as_uint(v[jj][1]),
                                       __float_as_uint(r0), __float_as_uint(r1));
      *reinterpret_cast<uint4*>(orow + n0 + 8 * j + 2 * (t & 2)) = o;
    }
  }
}

// The GEMM body of K5 (!kBwd: B is q [Nout, Kc], K-major) and K5b (kBwd: B
// is q [Kc, Nout], read over its leading dim and transposed in shared
// memory).  map_a: A [M, Kc] in 128 x 128 boxes, 128-byte swizzle; map_b:
// the forward's q in 128 x 128 boxes, swizzled, or the backward's q in
// 128 x 128 boxes (128 contraction rows), unswizzled.
template <typename T, bool kBwd>
__device__ __forceinline__ void int8_gemm(const CUtensorMap* map_a,
                                          const CUtensorMap* map_b,
                                          const GemmArgs<T>& args,
                                          uint8_t* smem_raw) {
  using R = Ring<kBwd>;
  constexpr int S = R::kStages;
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                       // [S][128 rows][128 bytes]
  uint8_t* sb = sa + S * R::kABytes;        // [S][kBN rows][128 bytes]
  uint8_t* sst = sb + S * R::kBBytes;       // K5b: [S][128 rows][kBN bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(sst + S * R::kSBytes);
  uint64_t* empty = full + S;
  uint64_t* staged = empty + S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    tma_prefetch(map_a);
    tma_prefetch(map_b);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kBwd ? 1 + 32 * kTransposers : 1);
      mbar_init(&empty[s], kConsumerWarps);
      if (kBwd) mbar_init(&staged[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int tiles_n = args.nout / kBN;
  const int tiles = (args.m / kBM) * tiles_n;
  const int kblocks = args.kc / kBK;

  if (warp < 4) {
    // the producer warpgroup
    setmaxnreg_dec<kBwd ? 104 : 40>();
    if (warp == 0 && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          if constexpr (!kBwd) {
            mbar_expect_tx(&full[s], R::kABytes + R::kBBytes);
            tma_load_2d(sa + s * R::kABytes, map_a, &full[s], kb * kBK, m0);
            tma_load_2d(sb + s * R::kBBytes, map_b, &full[s], kb * kBK, n0);
          } else {
            mbar_expect_tx(&full[s], R::kABytes);
            tma_load_2d(sa + s * R::kABytes, map_a, &full[s], kb * kBK, m0);
            mbar_expect_tx(&staged[s], R::kSBytes);
            tma_load_2d(sst + s * R::kSBytes, map_b, &staged[s], n0, kb * kBK);
          }
        }
      }
    } else if (kBwd && warp >= 1 && warp <= kTransposers) {
      // transposers: staging [128 c][128 n] -> B stage [128 n][128 c]
      // (swizzled), one 16 x 16 byte block a lane: 16 rows of c read as
      // 16-byte vectors, sixteen 4x4 byte transposes, 16 rows of n written
      // as 16-byte vectors.  Lane 8p + l of transposer warp w takes the c
      // rows 16 l .. 16 l + 15 and the n columns 16 nc .. 16 nc + 15 with
      // nc = (l + p + 4 w) mod 8, so the 8 lanes of each quarter-warp read
      // 8 different 16-byte bank groups and write 8 different ones.
      const int l = lane & 7;
      const int nc = (l + (lane >> 3) + 4 * (warp - 1)) & 7;
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&staged[s], (it / S) & 1);
          const uint8_t* src = sst + s * R::kSBytes + 16 * l * kBN + 16 * nc;
          uint8_t* dst = sb + s * R::kBBytes;
          uint4 in[16];
#pragma unroll
          for (int i = 0; i < 16; ++i)
            in[i] = *reinterpret_cast<const uint4*>(src + i * kBN);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            // rows 4 rg .. 4 rg + 3 of word w -> o[rg][j]: word rg of
            // output row 16 nc + 4 w + j
            uint32_t o[4][4];
#pragma unroll
            for (int rg = 0; rg < 4; ++rg) {
              const uint32_t v[4] = {word(in[4 * rg], w), word(in[4 * rg + 1], w),
                                     word(in[4 * rg + 2], w),
                                     word(in[4 * rg + 3], w)};
              transpose4x4(v, o[rg]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = 16 * nc + 4 * w + j;
              *reinterpret_cast<uint4*>(dst + n * kBK + ((l ^ (n & 7)) << 4)) =
                  make_uint4(o[0][j], o[1][j], o[2][j], o[3][j]);
            }
          }
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: rows 64 c .. 64 c + 63 of each tile
  setmaxnreg_inc<kBwd ? 200 : 232>();
  const int c = (warp >> 2) - 1;
  const int g = lane >> 2, t = lane & 3;
  int acc[kBN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
    // the epilogue's scales, loaded while the products run: this thread's
    // two rows and (the forward) its columns 8j + 2t, 8j + 2t + 1
    const int row = m0 + 64 * c + 16 * (warp & 3) + g;
    const float rs[2] = {__ldg(args.row_scale + row),
                         __ldg(args.row_scale + row + 8)};
    float2 cs[kBN / 8];
    if constexpr (!kBwd) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        cs[j] = __ldg(reinterpret_cast<const float2*>(args.col_scale + n0 +
                                                      8 * j + 2 * t));
    }
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint64_t da = sw128_desc(sa + s * R::kABytes + c * 64 * kBK);
      const uint64_t db = sw128_desc(sb + s * R::kBBytes);
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j)
        wgmma_s8(acc, da + 2 * j, db + 2 * j, (kb > 0 || j > 0) ? 1 : 0);
      wgmma_commit();
      fence_acc(acc);
      // the previous stage's products are done: hand its slot back
      wgmma_wait<1>();
      fence_acc(acc);
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* orow = args.out + static_cast<long long>(row + 8 * h) * args.nout;
#pragma unroll
      for (int j0 = 0; j0 < kBN / 8; j0 += 4)
        store_group<T, kBwd>(acc, j0, h, rs[h], cs, orow, n0, t);
    }
  }
}

// The launches, named so that a profile tells K5's from K5b's.
template <typename T, int kHold>
__global__ void __launch_bounds__(kQThreads)
w8a8_fwd_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                         float* __restrict__ x_scale, int k) {
  row_quantize<T, false, kHold>(x, nullptr, x8, x_scale, k);
}

template <typename T, int kHold>
__global__ void __launch_bounds__(kQThreads)
w8a8_bwd_quantize_kernel(const T* __restrict__ g,
                         const float* __restrict__ w_scale,
                         int8_t* __restrict__ g8, float* __restrict__ g_scale,
                         int n) {
  row_quantize<T, true, kHold>(g, w_scale, g8, g_scale, n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_fwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const GemmArgs<T> args) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  int8_gemm<T, false>(&map_a, &map_b, args, smem_raw);
}

// dx [T, K] = g8 [T, N] . q [N, K] over N
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const GemmArgs<T> args) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  int8_gemm<T, true>(&map_a, &map_b, args, smem_raw);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, the tile choice, the launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// an int8 [rows, cols] row-major tensor in boxes of box_rows x box_cols
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows, int box_cols, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// The grid: one block per SM walking the 128 x 128 tiles, or one block a
// tile when there are fewer tiles than SMs.
int grid_size(int tiles) { return tiles < sm_count() ? tiles : sm_count(); }

template <typename T, bool kBwd>
auto gemm_kernel() {
  if constexpr (kBwd) return w8a8_bwd_gemm_kernel<T>;
  else return w8a8_fwd_gemm_kernel<T>;
}

// the dynamic shared memory of an instantiation, set once
template <typename T, bool kBwd>
cudaError_t gemm_smem_ready() {
  static const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<T, kBwd>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<kBwd>::kSmem);
  return e;
}

template <typename T, bool kBwd>
cudaError_t launch_gemm(const void* a, const void* b, const float* rs,
                        const float* cs, T* out, int m, int kc, int nout,
                        cudaStream_t stream) {
  using R = Ring<kBwd>;
  auto kernel = gemm_kernel<T, kBwd>();
  const cudaError_t attr = gemm_smem_ready<T, kBwd>();
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a, map_b;
  cudaError_t e = make_map(&map_a, a, m, kc, kBM, kBK, true);
  if (e != cudaSuccess) return e;
  e = kBwd ? make_map(&map_b, b, kc, nout, kBK, kBN, false)
           : make_map(&map_b, b, nout, kc, kBN, kBK, true);
  if (e != cudaSuccess) return e;
  const GemmArgs<T> args{rs, cs, out, m, kc, nout};
  const int grid = grid_size((m / kBM) * (nout / kBN));
  kernel<<<grid, kThreads, R::kSmem, stream>>>(map_a, map_b, args);
  return cudaGetLastError();
}

// chunks a lane of the quantize holds: the fewest of 3, 6, 12 (bf16; 96
// registers at 12) or 3, 4 (fp32, whose longer rows are read again) that
// hold the row
template <typename T>
int quantize_hold(int k) {
  const int per_lane = (k / 16 + 31) / 32;
  if (per_lane <= 3) return 3;
  if (sizeof(T) == 4) return 4;
  return per_lane <= 6 ? 6 : 12;
}

template <typename T, bool kBwd>
auto quantize_kernel(int hold) {
  if constexpr (kBwd) {
    if constexpr (sizeof(T) == 4)
      return hold == 3 ? w8a8_bwd_quantize_kernel<T, 3>
                       : w8a8_bwd_quantize_kernel<T, 4>;
    else
      return hold == 3   ? w8a8_bwd_quantize_kernel<T, 3>
             : hold == 6 ? w8a8_bwd_quantize_kernel<T, 6>
                         : w8a8_bwd_quantize_kernel<T, 12>;
  } else {
    if constexpr (sizeof(T) == 4)
      return hold == 3 ? w8a8_fwd_quantize_kernel<T, 3>
                       : w8a8_fwd_quantize_kernel<T, 4>;
    else
      return hold == 3   ? w8a8_fwd_quantize_kernel<T, 3>
             : hold == 6 ? w8a8_fwd_quantize_kernel<T, 6>
                         : w8a8_fwd_quantize_kernel<T, 12>;
  }
}

template <typename T, bool kBwd>
cudaError_t launch_quantize(const void* src, const float* col_scale,
                            void* dst8, void* row_scale, int rows, int k,
                            cudaStream_t stream) {
  const int blocks = rows / (kQThreads / 32);
  const T* x = static_cast<const T*>(src);
  int8_t* x8 = static_cast<int8_t*>(dst8);
  float* s = static_cast<float*>(row_scale);
  auto kernel = quantize_kernel<T, kBwd>(quantize_hold<T>(k));
  if constexpr (kBwd)
    kernel<<<blocks, kQThreads, 0, stream>>>(x, col_scale, x8, s, k);
  else
    kernel<<<blocks, kQThreads, 0, stream>>>(x, x8, s, k);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool args_ok(int t, int k, int n, std::initializer_list<const void*> ptrs) {
  if (!(t > 0 && t % kBM == 0 && k > 0 && n > 0 && k % 128 == 0 &&
        n % 128 == 0 && k <= 6144 && n <= 6144))
    return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

// the forward: quantize x's rows, then y = x8 . q^T
template <typename T>
cudaError_t launch_fwd(const void* x, const void* q, const void* w_scale,
                       void* y, void* x8, void* x_scale, int t, int k, int n,
                       cudaStream_t stream) {
  cudaError_t e = launch_quantize<T, false>(x, nullptr, x8, x_scale, t, k, stream);
  if (e != cudaSuccess) return e;
  return launch_gemm<T, false>(x8, q, static_cast<const float*>(x_scale),
                               static_cast<const float*>(w_scale),
                               static_cast<T*>(y), t, k, n, stream);
}

// the backward: quantize the rows of g * w_scale, then dx = g8 . q over N
template <typename T>
cudaError_t launch_bwd(const void* g, const void* q, const void* w_scale,
                       void* dx, void* g8, void* g_scale, int t, int k, int n,
                       cudaStream_t stream) {
  cudaError_t e = launch_quantize<T, true>(
      g, static_cast<const float*>(w_scale), g8, g_scale, t, n, stream);
  if (e != cudaSuccess) return e;
  return launch_gemm<T, true>(g8, q, static_cast<const float*>(g_scale),
                              nullptr, static_cast<T*>(dx), t, n, k, stream);
}

// registers, local bytes, shared bytes (static + dynamic) and blocks per SM
template <typename K>
void kernel_info(K kernel, int threads, int dyn_smem, long long* out) {
  cudaFuncAttributes fa{};
  cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                dyn_smem);
  out[0] = fa.numRegs;
  out[1] = static_cast<long long>(fa.localSizeBytes);
  out[2] = static_cast<long long>(fa.sharedSizeBytes) + dyn_smem;
  out[3] = blocks;
}

template <typename T, bool kBwd>
cudaError_t launch_info(int t, int k, int n, long long* out) {
  const int rows_k = kBwd ? n : k, nout = kBwd ? k : n;
  const cudaError_t attr = gemm_smem_ready<T, kBwd>();
  if (attr != cudaSuccess) return attr;
  out[1] = (t / kBM) * (nout / kBN);
  out[0] = grid_size(static_cast<int>(out[1]));
  out[2] = Ring<kBwd>::kStages;
  kernel_info(gemm_kernel<T, kBwd>(), kThreads, Ring<kBwd>::kSmem, out + 3);
  const int hold = quantize_hold<T>(rows_k);
  out[7] = hold;
  kernel_info(quantize_kernel<T, kBwd>(hold), kQThreads, 0, out + 8);
  return cudaGetLastError();
}

}  // namespace

// x [T, K] (fp32 or bf16), q [N, K] int8, w_scale [N] fp32 -> y [T, N] in
// x's type; x8 [T, K] int8 and x_scale [T] fp32 are scratch the caller
// reads back if it wants the payload.  All contiguous; x, q, w_scale, y and
// x8 16-byte aligned (TMA and the 16-byte loads need it).
extern "C" int yat_w8a8_fwd(const void* x, const void* q, const void* w_scale,
                            void* y, void* x8, void* x_scale, int t, int k,
                            int n, int dtype, void* stream) {
  if (!args_ok(t, k, n, {x, q, w_scale, y, x8}))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == yat::kBFloat16)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(x, q, w_scale, y, x8, x_scale, t, k, n, s));
  return static_cast<int>(launch_fwd<float>(x, q, w_scale, y, x8, x_scale, t, k, n, s));
}

// g [T, N] (fp32 or bf16), q [N, K] int8, w_scale [N] fp32 -> dx [T, K] in
// g's type; g8 [T, N] int8 and g_scale [T] fp32 are scratch.  Alignment as
// the forward's.
extern "C" int yat_w8a8_bwd(const void* g, const void* q, const void* w_scale,
                            void* dx, void* g8, void* g_scale, int t, int k,
                            int n, int dtype, void* stream) {
  if (!args_ok(t, k, n, {g, q, w_scale, dx, g8}))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == yat::kBFloat16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(g, q, w_scale, dx, g8, g_scale, t, k, n, s));
  return static_cast<int>(launch_bwd<float>(g, q, w_scale, dx, g8, g_scale, t, k, n, s));
}

// The launches of a call at [T, K] x [K -> N] (bwd: K5b's) in the given
// dtype: out[0] the GEMM's grid, out[1] its 128 x 128 tiles, out[2] the
// ring's stages, out[3:7] the GEMM's registers, local (spill) bytes a
// thread, shared bytes and blocks per SM, out[7] the chunks of 16 values a
// lane of the quantize holds in registers, out[8:12] the quantize's
// registers, local bytes, shared bytes and blocks per SM.
extern "C" int yat_w8a8_launch_info(int t, int k, int n, int bwd, int dtype,
                                    long long* out) {
  if (!args_ok(t, k, n, {})) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == yat::kBFloat16)
    e = bwd ? launch_info<__nv_bfloat16, true>(t, k, n, out)
            : launch_info<__nv_bfloat16, false>(t, k, n, out);
  else
    e = bwd ? launch_info<float, true>(t, k, n, out)
            : launch_info<float, false>(t, k, n, out);
  return static_cast<int>(e);
}
