// K3: ReLU linear attention (SANA's LiteMLA), per (batch, head), in fp32:
//     o = relu(q) (relu(k)^T v) / (relu(q) . sum_n relu(k) + eps),
//     on the native [B, N, H, D] layout through strides.
//
// Replaces the TPU kernel yat_tpu/ops/attention.py:_linatt_fwd_kernel
// (called through _linear_attention_p), which took one (batch*head) slab
// per program on a transposed [B*H, N, D] copy.
//
// Bound on the H100: bytes at the serving shapes (q/k/v/o [8,256,36,32]
// bf16, ~19 MB moved against ~0.3 GFLOP).  Design against that bound:
//   * one block per (head, batch element): 288 blocks on the serving path;
//   * q, k and v are each read from device memory once and o written once,
//     on the model's own layout (no transposed copies as on the TPU);
//   * the [D, D] state relu(k)^T v and the [D] key sum stay in shared
//     memory in fp32, accumulated over 32-row tiles of k and v;
//   * products run on the CUDA cores in fp32.
// Numerics follow the plain version (ops/attention.py:linear_attention_ref):
// fp32 throughout, output rounded to the storage type once.  With round_kv
// set, the [D, D] state is rounded to the storage type before the second
// product, as the JAX package's einsum branch does
// (yat_tpu/ops/attention.py:498, kv.astype(q.dtype)); the key sum and the
// denominator stay fp32.  Without it the math is that of the Pallas kernel
// (_reference_linatt, an fp32 state).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;            // rows per shared-memory tile
constexpr int kMaxD = 64;
constexpr int kMaxState = kMaxD * kMaxD / kThreads;   // state entries/thread
constexpr int kMaxOut = kBN * kMaxD / kThreads;       // outputs/thread/tile

struct Strides {
  long long b, n, h;
};

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          Strides st, int b, int h, int row0,
                                          int rows, int d, bool relu) {
  for (int idx = threadIdx.x; idx < kBN * d; idx += kThreads) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < rows) x = yat::to_f<T>(src[b * st.b + gr * st.n + h * st.h + e]);
    dst[idx] = relu ? fmaxf(x, 0.f) : x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int n, int d, Strides qs, Strides ks, Strides vs,
                            Strides os, float eps, int round_kv) {
  __shared__ float a_t[kBN * kMaxD];     // relu(k) tiles, then relu(q)
  __shared__ float v_t[kBN * kMaxD];
  __shared__ float kv[kMaxD * kMaxD];
  __shared__ float ksum[kMaxD];
  __shared__ float den[kBN];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_state = d * d;

  // 1) kv[i][j] = sum_n relu(k)[n][i] v[n][j];  ksum[i] = sum_n relu(k)[n][i]
  float acc[kMaxState];
#pragma unroll
  for (int r = 0; r < kMaxState; ++r) acc[r] = 0.f;
  float ks_acc = 0.f;
  for (int n0 = 0; n0 < n; n0 += kBN) {
    __syncthreads();
    load_rows<T>(a_t, k, ks, b, h, n0, n, d, true);
    load_rows<T>(v_t, v, vs, b, h, n0, n, d, false);
    __syncthreads();
    const int rows = min(kBN, n - n0);
#pragma unroll
    for (int r = 0; r < kMaxState; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < n_state) {
        const int i = idx / d;
        const int j = idx - i * d;
        float a = acc[r];
        for (int t = 0; t < rows; ++t) a = fmaf(a_t[t * d + i], v_t[t * d + j], a);
        acc[r] = a;
      }
    }
    if (tid < d)
      for (int t = 0; t < rows; ++t) ks_acc += a_t[t * d + tid];
  }
#pragma unroll
  for (int r = 0; r < kMaxState; ++r) {
    const int idx = tid + r * kThreads;
    if (idx < n_state) kv[idx] = round_kv ? yat::rnd<T>(acc[r]) : acc[r];
  }
  if (tid < d) ksum[tid] = ks_acc;

  // 2) o[n][j] = (relu(q)[n] . kv[:, j]) / (relu(q)[n] . ksum + eps)
  for (int n0 = 0; n0 < n; n0 += kBN) {
    __syncthreads();
    load_rows<T>(a_t, q, qs, b, h, n0, n, d, true);
    __syncthreads();
    if (tid < kBN) {
      float s = 0.f;
      for (int i = 0; i < d; ++i) s = fmaf(a_t[tid * d + i], ksum[i], s);
      den[tid] = s;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < kBN * d) {
        const int t = idx / d;
        const int j = idx - t * d;
        if (n0 + t < n) {
          float num = 0.f;
          for (int i = 0; i < d; ++i) num = fmaf(a_t[t * d + i], kv[i * d + j], num);
          out[b * os.b + (n0 + t) * os.n + h * os.h + j] =
              yat::from_f<T>(num / (den[t] + eps));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int n, int h, int d, Strides qs, Strides ks,
                   Strides vs, Strides os, float eps, int round_kv,
                   cudaStream_t stream) {
  const dim3 grid(h, b);
  linear_attention_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, d, qs, ks, vs, os,
      eps, round_kv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int yat_linear_attention_max_head_dim() { return kMaxD; }

// q/k/v/out [B, N, H, D], each with strides (b, n, h, 1); round_kv: 1 to
// round the state to the storage type before the second product.
extern "C" int yat_linear_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int b, int n,
    int h, int d, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn,
    long long o_sh, float eps, int round_kv, int dtype, void* stream) {
  if (d > kMaxD || d < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  if (dtype == yat::kFloat32)
    return launch<float>(q, k, v, out, b, n, h, d, qs, ks, vs, os, eps,
                         round_kv, s);
  if (dtype == yat::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, out, b, n, h, d, qs, ks, vs, os,
                                 eps, round_kv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
