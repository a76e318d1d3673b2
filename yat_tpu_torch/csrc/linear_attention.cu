// K3: ReLU linear attention (SANA's LiteMLA), per (batch, head):
//     o = relu(q) (relu(k)^T v) / (relu(q) . sum_n relu(k) + eps),
//     on the native [B, N, H, D] layout through strides.
//
// Replaces the TPU kernel yat_tpu/ops/attention.py:_linatt_fwd_kernel
// (called through _linear_attention_p), which took one (batch*head) slab
// per program on a transposed [B*H, N, D] copy.
//
// Bound on the H100: bytes at the serving shapes (q/k/v/o [8,256,36,32]
// bf16: 18.9 MB moved against 0.3 GFLOP).  Design against that bound:
//   * one block of eight warps per (head, batch element): 288 blocks on
//     the serving path, three resident per SM, so every block's loads are
//     in flight from the start;
//   * the warps split N into 16-row groups (group g to warp g mod 8); each
//     warp streams its own groups' rows of k and v, then of q, through a
//     ring of 16-row stages in shared memory with 16-byte cp.async (4-byte
//     where d or the strides leave rows unaligned), one commit group per
//     stage and __syncwarp only; at N = 256 the ring holds a warp's whole
//     stream, so q arrives while the first product runs.  Every byte is
//     read from device memory once, on the model's own layout;
//   * bf16 with a rounded state (SANA below N = 4096, the JAX einsum
//     branch): both products on the tensor cores (mma.sync m16n8k16,
//     fp32 accumulation).  relu(k)^T v takes relu(k)^T and v by transposed
//     ldmatrix; a column of ones beside v gives the key sum in fp32.  The
//     warps' fp32 partial states are added in a fixed order, rounded to
//     bf16 once and held as B fragments; each warp then runs relu(q) . kv
//     for its rows, the denominator relu(q) . ksum in fp32 on the CUDA
//     cores from the q fragments (a quad shuffle), divides by one
//     reciprocal a row with an FMA correction (the correctly rounded
//     quotient), and writes its rows with 16-byte stores staged through
//     its q stage;
//   * fp32, and bf16 with an fp32 state (implementation "pallas", or N >=
//     4096): the same ring and warp split, both products in fp32 on the
//     CUDA cores (no TF32), one state column a lane (D > 32: a second block
//     for columns 32..63, which reads k and q again), rows read four values
//     at a time from shared memory.
// The head dim is a template parameter (padded to 16, 32, 48 or 64 with
// zeros).  ReLU keeps NaN (a select in fp32, __hmax2_nan on packed bf16),
// as torch.relu and jnp.maximum do.  Sums run in a fixed order: two launches
// give the same bits.
// Numerics follow the plain version (ops/attention.py:linear_attention_ref):
// fp32 throughout, output rounded to the storage type once.  With round_kv
// set, the [D, D] state is rounded to the storage type before the second
// product, as the JAX package's einsum branch does
// (yat_tpu/ops/attention.py:498, kv.astype(q.dtype)); the key sum and the
// denominator stay fp32.  Without it the math is that of the Pallas kernel
// (_reference_linatt, an fp32 state).
#include "attention_tiles.cuh"

namespace {

using yat::attn::bf16;
using yat::attn::cp_async16;
using yat::attn::cp_async4;
using yat::attn::cp_async_commit;
using yat::attn::cp_async_wait;
using yat::attn::ldsm_x4;
using yat::attn::ldsm_x4_t;
using yat::attn::mma_bf16;
using yat::attn::pack_bf16;
using yat::attn::Strides;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;             // rows of a group, and of a stage
constexpr int kMaxD = 64;
constexpr uint32_t kOnes = 0x3f803f80u;   // two bf16 1.0

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  Strides qs, ks, vs, os;
  int n, d;
  float eps;
  int round_kv;
};

// The ring of one warp: kStages stages of kRows rows, each row padded by 16
// bytes (transposed ldmatrix rows fall in distinct banks); as many stages
// as fit in 96 KB for the eight warps, at most 6 (a warp's whole stream at
// N = 256: k, v and q of two groups) and at least 3.
template <typename T, int kDP>
struct Ring {
  static constexpr int kLdt = kDP + 16 / static_cast<int>(sizeof(T));
  static constexpr int kStage = kRows * kLdt;
  static constexpr int kStageBytes = kStage * static_cast<int>(sizeof(T));
  static constexpr int kFit = 98304 / (kWarps * kStageBytes);
  static constexpr int kStages = kFit > 6 ? 6 : kFit < 3 ? 3 : kFit;
  static constexpr int kBytes = kWarps * kStages * kStageBytes;
};

// groups of 16 rows that warp w owns: w, w + 8, w + 16, ... below
// ceil(n / 16)
__device__ __forceinline__ int own_groups(int n, int w) {
  const int g = (n + kRows - 1) / kRows;
  return g > w ? (g - w + kWarps - 1) / kWarps : 0;
}

// The block's head of k, v and q: row 0 of each and its row stride.
template <typename T>
struct Heads {
  const T* k;
  const T* v;
  const T* q;
  long long kn, vn, qn;
};

template <typename T>
__device__ __forceinline__ Heads<T> heads(const Args<T>& a, int b, int h) {
  return {a.k + b * a.ks.b + h * a.ks.h, a.v + b * a.vs.b + h * a.vs.h,
          a.q + b * a.qs.b + h * a.qs.h, a.ks.n, a.vs.n, a.qs.n};
}

// Start copying item s of warp w's stream into stage s % kStages: k and v
// of its groups in turn (k_0, v_0, k_1, v_1, ...), then q of its groups;
// past the stream, nothing.  Rows past n and columns past d are zero-filled.
// kVec: 16-byte copies, else 4-byte ones.
template <typename T, int kDP, bool kVec>
__device__ __forceinline__ void issue(T* ring, const Heads<T>& hd, int n,
                                      int d, int w, int lane, int s,
                                      int groups) {
  using R = Ring<T, kDP>;
  const T* src;
  long long sn;
  int g;
  if (s < 2 * groups) {
    src = (s & 1) ? hd.v : hd.k;
    sn = (s & 1) ? hd.vn : hd.kn;
    g = w + kWarps * (s >> 1);
  } else if (s < 3 * groups) {
    src = hd.q;
    sn = hd.qn;
    g = w + kWarps * (s - 2 * groups);
  } else {
    return;
  }
  T* dst = ring + (s % R::kStages) * R::kStage;
  const int row0 = g * kRows;
  const T* rows = src + row0 * sn;
  constexpr int kPer = (kVec ? 16 : 4) / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kDP / kPer;
#pragma unroll
  for (int it = 0; it < (kRows * kPerRow + 31) / 32; ++it) {
    const int idx = lane + 32 * it;
    if (idx >= kRows * kPerRow) break;
    const int r = idx / kPerRow;
    const int e = (idx - r * kPerRow) * kPer;
    const bool ok = row0 + r < n && e < d;
    const T* p = ok ? rows + r * sn + e : src;
    if (kVec)
      cp_async16(dst + r * R::kLdt + e, p, ok ? 16 : 0);
    else
      cp_async4(dst + r * R::kLdt + e, p, ok ? 4 : 0);
  }
}

// relu on two packed bf16, NaN kept
__device__ __forceinline__ uint32_t relu2(uint32_t u) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&u);
  x = __hmax2_nan(x, __floats2bfloat162_rn(0.f, 0.f));
  return *reinterpret_cast<uint32_t*>(&x);
}

// relu on an fp32 value, NaN kept (NaN < 0 is false)
__device__ __forceinline__ float relu1(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Warps `from` and from + 1 hand their partials (kE fp32 values a lane)
// to warps `to` and to + 1 through the two slots of red.
template <int kE>
__device__ __forceinline__ void hand_over(float* acc, float* red, int w,
                                          int lane, int from, int to) {
  if (w == from || w == from + 1) {
#pragma unroll
    for (int e = 0; e < kE; ++e) red[((w - from) * kE + e) * 32 + lane] = acc[e];
  }
  __syncthreads();
  if (w == to || w == to + 1) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] += red[((w - to) * kE + e) * 32 + lane];
  }
  __syncthreads();
}

// The eight warps' partial states added in a fixed order into warp 0's
// registers: ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7)).
template <int kE>
__device__ __forceinline__ void reduce_warps(float* acc, float* red, int w,
                                             int lane) {
  hand_over<kE>(acc, red, w, lane, 4, 0);
  hand_over<kE>(acc, red, w, lane, 6, 2);
  hand_over<kE>(acc, red, w, lane, 2, 0);
  if (w == 1) {
#pragma unroll
    for (int e = 0; e < kE; ++e) red[e * 32 + lane] = acc[e];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] += red[e * 32 + lane];
  }
}

// x / y as x * r corrected by one FMA, r = 1 / y correctly rounded: the
// correctly rounded quotient (Markstein), one division a row
__device__ __forceinline__ float div_by(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// ---------------------------------------------------------------------------
// bf16, rounded state: tensor cores
// ---------------------------------------------------------------------------

template <int kDP>
struct MmaShape {
  static constexpr int kMT = kDP / 16;          // 16-row tiles of the state
  static constexpr int kNT = kDP / 8;           // 8-column tiles of the state
  static constexpr int kE = kMT * (kNT + 1) * 4;   // accumulators a lane
  static constexpr int kRedBytes = 2 * kE * 32 * 4;
  // the rounded state [kDP, kLdt] bf16 and the key sum [kDP] fp32 live in
  // the second slot of red once the reduction is done
  static_assert(kDP * Ring<bf16, kDP>::kLdt * 2 + kDP * 4 <= kE * 32 * 4,
                "state does not fit the reduction slot");
  static constexpr size_t kSmem = Ring<bf16, kDP>::kBytes + kRedBytes;
};

template <int kDP, bool kVec>
__global__ void __launch_bounds__(kThreads, kDP <= 32 ? 3 : 1)
linear_attention_fwd_mma(const Args<bf16> a) {
  using R = Ring<bf16, kDP>;
  using M = MmaShape<kDP>;
  constexpr int kMT = M::kMT, kNT = M::kNT, kS = R::kStages, kL = R::kLdt;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int groups = own_groups(a.n, w);
  const Heads<bf16> hd = heads(a, b, h);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + w * kS * R::kStage;
  float* red = reinterpret_cast<float*>(smem_raw + R::kBytes);
  for (int s = 0; s < kS; ++s) {
    issue<bf16, kDP, kVec>(ring, hd, a.n, a.d, w, lane, s, groups);
    cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;

  // 1) acc[m][j] = relu(k)^T [v | 1] over the warp's groups
  float acc[kMT][kNT + 1][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j <= kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int step = 0; step < groups; ++step) {
    cp_async_wait<kS - 2>();
    __syncwarp();
    const bf16* kt = ring + ((2 * step) % kS) * R::kStage;
    const bf16* vt = ring + ((2 * step + 1) % kS) * R::kStage;
    uint32_t af[kMT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      // A = relu(k)^T: rows are k's columns, so a transposed load
      ldsm_x4_t(af[m], kt + (mr + 8 * (mi >> 1)) * kL + 16 * m + 8 * (mi & 1));
#pragma unroll
      for (int e = 0; e < 4; ++e) af[m][e] = relu2(af[m][e]);
    }
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vt + (mr + 8 * (mi & 1)) * kL + 8 * (j + (mi >> 1)));
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        mma_bf16(acc[m][j], af[m], bv[0], bv[1]);
        mma_bf16(acc[m][j + 1], af[m], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m) mma_bf16(acc[m][kNT], af[m], kOnes, kOnes);
    __syncwarp();
    issue<bf16, kDP, kVec>(ring, hd, a.n, a.d, w, lane, 2 * step + kS, groups);
    cp_async_commit();
    issue<bf16, kDP, kVec>(ring, hd, a.n, a.d, w, lane, 2 * step + 1 + kS, groups);
    cp_async_commit();
  }

  // 2) the state: the warps' partials added, rounded to bf16 once; the key
  // sum (any column of the ones tile) kept in fp32
  reduce_warps<M::kE>(&acc[0][0][0], red, w, lane);
  bf16* kvb = reinterpret_cast<bf16*>(red + M::kE * 32);
  float* ksum = reinterpret_cast<float*>(kvb + kDP * kL);
  if (w == 0) {
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<uint32_t*>(kvb + (16 * m + g) * kL + 8 * j + 2 * t) =
            pack_bf16(acc[m][j][0], acc[m][j][1]);
        *reinterpret_cast<uint32_t*>(kvb + (16 * m + g + 8) * kL + 8 * j +
                                     2 * t) =
            pack_bf16(acc[m][j][2], acc[m][j][3]);
      }
      if (t == 0) {
        ksum[16 * m + g] = acc[m][kNT][0];
        ksum[16 * m + g + 8] = acc[m][kNT][2];
      }
    }
  }
  __syncthreads();
  uint32_t bq[kMT][kNT][2];     // the state as B fragments
#pragma unroll
  for (int c = 0; c < kMT; ++c)
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, kvb + (16 * c + mr + 8 * (mi & 1)) * kL + 8 * (j + (mi >> 1)));
      bq[c][j][0] = r[0];
      bq[c][j][1] = r[1];
      bq[c][j + 1][0] = r[2];
      bq[c][j + 1][1] = r[3];
    }
  float ks[kMT][4];             // ksum at this lane's q-fragment columns
#pragma unroll
  for (int c = 0; c < kMT; ++c) {
    ks[c][0] = ksum[16 * c + 2 * t];
    ks[c][1] = ksum[16 * c + 2 * t + 1];
    ks[c][2] = ksum[16 * c + 8 + 2 * t];
    ks[c][3] = ksum[16 * c + 9 + 2 * t];
  }

  // 3) o = relu(q) kv / (relu(q) . ksum + eps) for the warp's groups
  for (int u = 0; u < groups; ++u) {
    cp_async_wait<kS - 1>();
    __syncwarp();
    const int item = 2 * groups + u;
    bf16* qt = ring + (item % kS) * R::kStage;
    uint32_t af[kMT][4];
    float d0 = 0.f, d1 = 0.f;   // rows g and g + 8
#pragma unroll
    for (int c = 0; c < kMT; ++c) {
      ldsm_x4(af[c], qt + (mr + 8 * (mi & 1)) * kL + 16 * c + 8 * (mi >> 1));
#pragma unroll
      for (int e = 0; e < 4; ++e) af[c][e] = relu2(af[c][e]);
      d0 = fmaf(lo_f(af[c][0]), ks[c][0], d0);
      d0 = fmaf(hi_f(af[c][0]), ks[c][1], d0);
      d0 = fmaf(lo_f(af[c][2]), ks[c][2], d0);
      d0 = fmaf(hi_f(af[c][2]), ks[c][3], d0);
      d1 = fmaf(lo_f(af[c][1]), ks[c][0], d1);
      d1 = fmaf(hi_f(af[c][1]), ks[c][1], d1);
      d1 = fmaf(lo_f(af[c][3]), ks[c][2], d1);
      d1 = fmaf(hi_f(af[c][3]), ks[c][3], d1);
    }
    d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
    float num[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) num[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kMT; ++c)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_bf16(num[j], af[c], bq[c][j][0], bq[c][j][1]);
    const float y0 = d0 + a.eps, y1 = d1 + a.eps;
    const float r0 = 1.0f / y0, r1 = 1.0f / y1;
    __syncwarp();   // every lane has read the stage before it is overwritten
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      *reinterpret_cast<uint32_t*>(qt + g * kL + 8 * j + 2 * t) =
          pack_bf16(div_by(num[j][0], y0, r0), div_by(num[j][1], y0, r0));
      *reinterpret_cast<uint32_t*>(qt + (g + 8) * kL + 8 * j + 2 * t) =
          pack_bf16(div_by(num[j][2], y1, r1), div_by(num[j][3], y1, r1));
    }
    __syncwarp();
    const int row0 = (w + kWarps * u) * kRows;
    bf16* out = a.o + b * a.os.b + h * a.os.h;
    constexpr int kPer = kVec ? 8 : 2;
    constexpr int kPerRow = kDP / kPer;
#pragma unroll
    for (int idx = lane; idx < kRows * kPerRow; idx += 32) {
      const int r = idx / kPerRow;
      const int e = (idx - r * kPerRow) * kPer;
      if (row0 + r < a.n && e < a.d) {
        bf16* dst = out + (row0 + r) * a.os.n + e;
        if (kVec)
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(qt + r * kL + e);
        else
          *reinterpret_cast<uint32_t*>(dst) =
              *reinterpret_cast<const uint32_t*>(qt + r * kL + e);
      }
    }
    __syncwarp();
    issue<bf16, kDP, kVec>(ring, hd, a.n, a.d, w, lane, item + kS, groups);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// fp32, and bf16 with an fp32 state: CUDA cores, one state column a lane
// ---------------------------------------------------------------------------

// four values of a shared-memory row as fp32 (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ void ld4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = lo_f(v.x);
  f[1] = hi_f(v.x);
  f[2] = lo_f(v.y);
  f[3] = hi_f(v.y);
}

template <typename T, int kDP>
struct F32Shape {
  static constexpr int kBlocks = (kDP + 31) / 32;  // column blocks (grid z)
  static constexpr int kE = kDP + kBlocks;         // accumulators a lane
  static constexpr int kRedBytes = 2 * kE * 32 * 4;
  // the block's 32 state columns [kDP, 32] fp32 and the key sum [kDP] in
  // red's second slot
  static_assert(kDP * 32 * 4 + kDP * 4 <= kE * 32 * 4,
                "state does not fit the reduction slot");
  static constexpr size_t kSmem = Ring<T, kDP>::kBytes + kRedBytes;
};

template <typename T, int kDP, bool kVec>
__global__ void __launch_bounds__(kThreads)
linear_attention_fwd_f32(const Args<T> a) {
  using R = Ring<T, kDP>;
  using F = F32Shape<T, kDP>;
  constexpr int kS = R::kStages, kL = R::kLdt, kK = F::kBlocks;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int j = 32 * blockIdx.z + lane;    // this lane's state column
  const int groups = own_groups(a.n, w);
  const Heads<T> hd = heads(a, b, h);
  T* ring = reinterpret_cast<T*>(smem_raw) + w * kS * R::kStage;
  float* red = reinterpret_cast<float*>(smem_raw + R::kBytes);
  for (int s = 0; s < kS; ++s) {
    issue<T, kDP, kVec>(ring, hd, a.n, a.d, w, lane, s, groups);
    cp_async_commit();
  }

  // 1) acc[i] = sum_n relu(k)[n][i] v[n][j];
  //    acc[kDP + c] = sum_n relu(k)[n][lane + 32 c]
  float acc[kDP + kK];
#pragma unroll
  for (int i = 0; i < kDP + kK; ++i) acc[i] = 0.f;
  for (int step = 0; step < groups; ++step) {
    cp_async_wait<kS - 2>();
    __syncwarp();
    const T* kt = ring + ((2 * step) % kS) * R::kStage;
    const T* vt = ring + ((2 * step + 1) % kS) * R::kStage;
    for (int r = 0; r < kRows; ++r) {
      const T* kr = kt + r * kL;
      const float vv = j < kDP ? yat::to_f<T>(vt[r * kL + j]) : 0.f;
#pragma unroll
      for (int c = 0; c < kK; ++c)
        if (lane + 32 * c < kDP)
          acc[kDP + c] += relu1(yat::to_f<T>(kr[lane + 32 * c]));
#pragma unroll
      for (int i = 0; i < kDP; i += 4) {
        float k4[4];
        ld4(kr + i, k4);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i + e] = fmaf(relu1(k4[e]), vv, acc[i + e]);
      }
    }
    __syncwarp();
    issue<T, kDP, kVec>(ring, hd, a.n, a.d, w, lane, 2 * step + kS, groups);
    cp_async_commit();
    issue<T, kDP, kVec>(ring, hd, a.n, a.d, w, lane, 2 * step + 1 + kS, groups);
    cp_async_commit();
  }

  // 2) the block's state columns in fp32 (rounded to the storage type with
  // round_kv) and the whole key sum
  reduce_warps<F::kE>(acc, red, w, lane);
  float* kv = red + F::kE * 32;          // [kDP][32]
  float* ksum = kv + kDP * 32;           // [kDP], 16-byte aligned
  if (w == 0) {
#pragma unroll
    for (int i = 0; i < kDP; ++i)
      kv[i * 32 + lane] = a.round_kv ? yat::rnd<T>(acc[i]) : acc[i];
#pragma unroll
    for (int c = 0; c < kK; ++c)
      if (lane + 32 * c < kDP) ksum[lane + 32 * c] = acc[kDP + c];
  }
  __syncthreads();

  // 3) o[n][j] = (relu(q)[n] . kv[:, j]) / (relu(q)[n] . ksum + eps)
  for (int u = 0; u < groups; ++u) {
    cp_async_wait<kS - 1>();
    __syncwarp();
    const int item = 2 * groups + u;
    const T* qt = ring + (item % kS) * R::kStage;
    const int row0 = (w + kWarps * u) * kRows;
    T* out = a.o + b * a.os.b + h * a.os.h;
    for (int r = 0; r < kRows; ++r) {
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int i = 0; i < kDP; i += 4) {
        float q4[4], s4[4];
        ld4(qt + r * kL + i, q4);
        ld4(ksum + i, s4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float qr = relu1(q4[e]);
          den = fmaf(qr, s4[e], den);
          num = fmaf(qr, kv[(i + e) * 32 + lane], num);
        }
      }
      if (row0 + r < a.n && j < a.d)
        out[(row0 + r) * a.os.n + j] = yat::from_f<T>(num / (den + a.eps));
    }
    __syncwarp();
    issue<T, kDP, kVec>(ring, hd, a.n, a.d, w, lane, item + kS, groups);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// whether every row of q/k/v/out starts on a `bytes` boundary and d fills
// whole copies of that size
template <typename T>
bool aligned(const Args<T>& a, int bytes) {
  const long long es = sizeof(T);
  auto ok = [&](const void* p, Strides s) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
           (s.b * es) % bytes == 0 && (s.n * es) % bytes == 0 &&
           (s.h * es) % bytes == 0;
  };
  return (a.d * es) % bytes == 0 && ok(a.q, a.qs) && ok(a.k, a.ks) &&
         ok(a.v, a.vs) && ok(a.o, a.os);
}

// Launch kernel (info == nullptr), or write its path (1: tensor cores, 0:
// CUDA cores), copy width in bytes, registers, local bytes, shared bytes
// and blocks per SM into info[0:6].
template <typename K, typename T>
cudaError_t run(K kernel, size_t smem, bool tensor, bool vec, int blocks_z,
                const Args<T>& a, int b, int h, cudaStream_t st,
                long long* info) {
  if (info != nullptr) {
    info[0] = tensor ? 1 : 0;
    info[1] = vec ? 16 : 4;
    return yat::attn::launch_info(kernel, smem, info + 2, kThreads);
  }
  cudaError_t e = yat::attn::set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(h, b, blocks_z), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int kDP>
cudaError_t dispatch_dp(const Args<T>& a, int b, int h, bool vec,
                        cudaStream_t st, long long* info) {
  if constexpr (sizeof(T) == 2) {
    if (a.round_kv) {
      constexpr size_t smem = MmaShape<kDP>::kSmem;
      return vec ? run(linear_attention_fwd_mma<kDP, true>, smem, true, true,
                       1, a, b, h, st, info)
                 : run(linear_attention_fwd_mma<kDP, false>, smem, true,
                       false, 1, a, b, h, st, info);
    }
  }
  using F = F32Shape<T, kDP>;
  return vec ? run(linear_attention_fwd_f32<T, kDP, true>, F::kSmem, false,
                   true, F::kBlocks, a, b, h, st, info)
             : run(linear_attention_fwd_f32<T, kDP, false>, F::kSmem, false,
                   false, F::kBlocks, a, b, h, st, info);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int b, int n, int h, int d, Strides qs, Strides ks,
                     Strides vs, Strides os, float eps, int round_kv,
                     cudaStream_t st, long long* info) {
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs,
                  os, n, d, eps, round_kv};
  const bool vec = aligned(a, 16);
  if (!vec && !aligned(a, 4)) return cudaErrorInvalidValue;
  if (d <= 16) return dispatch_dp<T, 16>(a, b, h, vec, st, info);
  if (d <= 32) return dispatch_dp<T, 32>(a, b, h, vec, st, info);
  if (d <= 48) return dispatch_dp<T, 48>(a, b, h, vec, st, info);
  return dispatch_dp<T, 64>(a, b, h, vec, st, info);
}

int entry(const void* q, const void* k, const void* v, void* out, int b,
          int n, int h, int d, long long q_sb, long long q_sn, long long q_sh,
          long long k_sb, long long k_sn, long long k_sh, long long v_sb,
          long long v_sn, long long v_sh, long long o_sb, long long o_sn,
          long long o_sh, float eps, int round_kv, int dtype, void* stream,
          long long* info) {
  if (d > kMaxD || d < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  if (dtype == yat::kFloat32)
    return static_cast<int>(dispatch<float>(q, k, v, out, b, n, h, d, qs, ks,
                                            vs, os, eps, round_kv, s, info));
  if (dtype == yat::kBFloat16)
    return static_cast<int>(dispatch<bf16>(q, k, v, out, b, n, h, d, qs, ks,
                                           vs, os, eps, round_kv, s, info));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int yat_linear_attention_max_head_dim() { return kMaxD; }

// q/k/v/out [B, N, H, D], each with strides (b, n, h, 1); round_kv: 1 to
// round the state to the storage type before the second product.  Rows
// must start on 4-byte boundaries with whole 4-byte pairs (bf16: even D and
// strides); 16-byte ones take 16-byte copies.
extern "C" int yat_linear_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int b, int n,
    int h, int d, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn,
    long long o_sh, float eps, int round_kv, int dtype, void* stream) {
  return entry(q, k, v, out, b, n, h, d, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
               v_sb, v_sn, v_sh, o_sb, o_sn, o_sh, eps, round_kv, dtype,
               stream, nullptr);
}

// The launch yat_linear_attention_fwd makes for the same arguments, without
// making it: path (1 tensor cores, 0 CUDA cores), copy bytes, registers a
// thread, local (spill) bytes a thread, shared bytes and blocks per SM into
// info[0:6].
extern "C" int yat_linear_attention_info(
    const void* q, const void* k, const void* v, void* out, int b, int n,
    int h, int d, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn,
    long long o_sh, float eps, int round_kv, int dtype, void* info) {
  return entry(q, k, v, out, b, n, h, d, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
               v_sb, v_sn, v_sh, o_sb, o_sn, o_sh, eps, round_kv, dtype,
               nullptr, static_cast<long long*>(info));
}

// ---------------------------------------------------------------------------
// K3s and K3a: K3 split into its two products, for token-sharded blocks
// (sequence parallelism).  Each process holds a slice of the tokens; the
// state of its slice is summed over the processes before the second
// product, as GSPMD reduces the JAX einsum branch's fp32 partial state
// before kv.astype(q.dtype) (yat_tpu/ops/attention.py:494-498).
//   K3s: kv = relu(k)^T v [B, H, D, D] and ksum = sum_n relu(k) [B, H, D],
//        fp32, contiguous;
//   K3a: o = relu(q) . round(kv) / (relu(q) . ksum + eps), with round_kv
//        rounding the state to the storage type first.
// Both run on the CUDA cores in fp32, one block of eight warps a (head,
// batch element) for K3s and a (64-row group, head, batch element) for
// K3a; every sum runs in a fixed order (two launches give the same bits).
// ---------------------------------------------------------------------------

namespace {

constexpr int kStateRows = 32;              // rows of k and v a stage
constexpr int kStateEntries = kMaxD * kMaxD / kThreads;   // per thread
constexpr int kApplyRows = 64;              // rows of q a block

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attention_state(const T* k, const T* v, float* kv, float* ksum,
                       Strides ks, Strides vs, int n, int d) {
  __shared__ float sk[kStateRows][kMaxD];
  __shared__ float sv[kStateRows][kMaxD];
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  float acc[kStateEntries];
#pragma unroll
  for (int u = 0; u < kStateEntries; ++u) acc[u] = 0.f;
  float sacc = 0.f;
  for (int n0 = 0; n0 < n; n0 += kStateRows) {
    const int rows = min(kStateRows, n - n0);
    for (int i = t; i < rows * d; i += kThreads) {
      const int r = i / d, c = i % d;
      sk[r][c] = relu1(yat::to_f<T>(kp[(n0 + r) * ks.n + c]));
      sv[r][c] = yat::to_f<T>(vp[(n0 + r) * vs.n + c]);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kStateEntries; ++u) {
      const int e = t + kThreads * u;
      if (e < d * d) {
        const int i = e / d, j = e % d;
        float a = acc[u];
        for (int r = 0; r < rows; ++r) a = fmaf(sk[r][i], sv[r][j], a);
        acc[u] = a;
      }
    }
    if (t < d)
      for (int r = 0; r < rows; ++r) sacc += sk[r][t];
    __syncthreads();
  }
  const long long head = static_cast<long long>(b) * gridDim.x + h;
#pragma unroll
  for (int u = 0; u < kStateEntries; ++u) {
    const int e = t + kThreads * u;
    if (e < d * d) kv[head * d * d + e] = acc[u];
  }
  if (t < d) ksum[head * d + t] = sacc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attention_apply(const T* q, const float* kv, const float* ksum, T* o,
                       Strides qs, Strides os, int n, int d, float eps,
                       int round_kv) {
  __shared__ float skv[kMaxD * kMaxD];
  __shared__ float ss[kMaxD];
  __shared__ float sq[kWarps][kMaxD];
  const int h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int w = t / 32, lane = t % 32;
  const long long head = static_cast<long long>(b) * gridDim.y + h;
  for (int e = t; e < d * d; e += kThreads) {
    const float x = kv[head * d * d + e];
    skv[e] = round_kv ? yat::rnd<T>(x) : x;
  }
  if (t < d) ss[t] = ksum[head * d + t];
  __syncthreads();
  const T* qp = q + b * qs.b + h * qs.h;
  T* op = o + b * os.b + h * os.h;
  const int end = min(n, (blockIdx.x + 1) * kApplyRows);
  for (int row = blockIdx.x * kApplyRows + w; row < end; row += kWarps) {
    for (int c = lane; c < d; c += 32)
      sq[w][c] = relu1(yat::to_f<T>(qp[row * qs.n + c]));
    __syncwarp();
    float den = 0.f;
    for (int i = 0; i < d; ++i) den = fmaf(sq[w][i], ss[i], den);
    for (int j = lane; j < d; j += 32) {
      float num = 0.f;
      for (int i = 0; i < d; ++i) num = fmaf(sq[w][i], skv[i * d + j], num);
      op[row * os.n + j] = yat::from_f<T>(num / (den + eps));
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t state_launch(const void* k, const void* v, float* kv,
                         float* ksum, int b, int n, int h, int d, Strides ks,
                         Strides vs, cudaStream_t st) {
  linear_attention_state<T><<<dim3(h, b), kThreads, 0, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), kv, ksum, ks, vs,
      n, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply_launch(const void* q, const float* kv, const float* ksum,
                         void* out, int b, int n, int h, int d, Strides qs,
                         Strides os, float eps, int round_kv,
                         cudaStream_t st) {
  const int groups = (n + kApplyRows - 1) / kApplyRows;
  linear_attention_apply<T><<<dim3(groups, h, b), kThreads, 0, st>>>(
      static_cast<const T*>(q), kv, ksum, static_cast<T*>(out), qs, os, n, d,
      eps, round_kv);
  return cudaGetLastError();
}

}  // namespace

// K3s: k/v [B, N, H, D] with strides (b, n, h, 1) -> kv [B, H, D, D] and
// ksum [B, H, D], fp32 and contiguous.  N may be 0 (zeros).
extern "C" int yat_linear_attention_state(
    const void* k, const void* v, void* kv, void* ksum, int b, int n, int h,
    int d, long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, int dtype, void* stream) {
  if (d > kMaxD || d < 1 || n < 0 || b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  float* kvf = static_cast<float*>(kv);
  float* ksf = static_cast<float*>(ksum);
  if (dtype == yat::kFloat32)
    return static_cast<int>(
        state_launch<float>(k, v, kvf, ksf, b, n, h, d, ks, vs, s));
  if (dtype == yat::kBFloat16)
    return static_cast<int>(
        state_launch<bf16>(k, v, kvf, ksf, b, n, h, d, ks, vs, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3a: q/out [B, N, H, D] with strides (b, n, h, 1), kv [B, H, D, D] and
// ksum [B, H, D] fp32 contiguous; round_kv: 1 to round the state to the
// storage type before the product.
extern "C" int yat_linear_attention_apply(
    const void* q, const void* kv, const void* ksum, void* out, int b, int n,
    int h, int d, long long q_sb, long long q_sn, long long q_sh,
    long long o_sb, long long o_sn, long long o_sh, float eps, int round_kv,
    int dtype, void* stream) {
  if (d > kMaxD || d < 1 || n < 1 || b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, os{o_sb, o_sn, o_sh};
  const float* kvf = static_cast<const float*>(kv);
  const float* ksf = static_cast<const float*>(ksum);
  if (dtype == yat::kFloat32)
    return static_cast<int>(apply_launch<float>(q, kvf, ksf, out, b, n, h, d,
                                                 qs, os, eps, round_kv, s));
  if (dtype == yat::kBFloat16)
    return static_cast<int>(apply_launch<bf16>(q, kvf, ksf, out, b, n, h, d,
                                               qs, os, eps, round_kv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
