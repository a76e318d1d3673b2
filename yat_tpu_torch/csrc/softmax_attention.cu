// K2: non-causal softmax attention over a short key sequence with an
//     optional fp32 additive key bias shared by all heads,
//     o = softmax(q k^T / sqrt(D) + bias) v, on the native [B, N, H, D]
//     layout (read and written through strides: no head transposes).
//
// Replaces the TPU kernel yat_tpu/ops/attention.py:_vmem_mh_fwd_kernel
// (called through _vmem_attn_native_p), which held one batch element's
// [N, H*D] slabs in VMEM and looped over heads, and the folded-layout
// _vmem_attn_fwd_kernel (K4, called through _vmem_attn_p), which computes
// the same arithmetic on [B*H, N, D] copies: this kernel reads either
// layout's [B, N, H, D] source through strides, so both land here.
//
// Bound on the H100: bytes at the serving shapes (q [8,256,16,72], k/v
// [8,512,16,72] bf16: ~28 MB moved against ~4.8 GFLOP, about 170 flop/byte,
// under the bf16 ridge of ~295).  Design, simple before fast:
//   * one block per (64 queries, head, batch element): 512 blocks on the
//     serving path; no score reaches device memory;
//   * K and V pass through shared memory in 64-key tiles; the ragged last
//     tile is zero-filled and masked out of the softmax, so N_k needs no
//     padding;
//   * bf16 (the serving path): the tensor-core body shared with K6
//     (attention_tiles.cuh) with one key block covering every key: two
//     passes over the key tiles, mma.sync products from ldmatrix operands,
//     scores, P and the accumulator in registers, 16-byte tile loads; only
//     tiles live in shared memory (34 KB at D = 72), so several blocks
//     share an SM;
//   * fp32: the same two passes over 64-key tiles on the CUDA cores
//     (attention_tiles.cuh), so any N_k the short-sequence gate admits fits
//     in shared memory.
// Numerics follow the plain version (ops/attention.py:attention_ref): fp32
// scores, max-subtracted exp, division by the row sum, probabilities
// rounded to the storage type of v before the fp32-accumulated P.V.
#include "attention_tiles.cuh"

namespace {

using namespace yat::attn;

constexpr int kMaxD = 128;

template <bool kVec, int kDC>
__global__ void __launch_bounds__(kThreads, 3)
attention_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ out, int nq, int nk, int d, Strides qs,
                   Strides ks, Strides vs, long long bias_sb, Strides os,
                   float scale, int block_keys, float* res_m, float* res_l) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  attention_bf16_block<kVec, kDC>(q, k, v, bias, out, nq, nk, d, qs, ks, vs,
                                  bias_sb, os, scale, block_keys, res_m, res_l,
                                  smem_raw);
}

struct SoftmaxKernel {
  template <bool kVec, int kDC>
  static auto fn() { return attention_fwd_bf16<kVec, kDC>; }
};

}  // namespace

// Shared memory one block needs, so the wrapper can refuse shapes that do
// not fit before launching.
extern "C" long long yat_attention_smem_bytes(int d, int dtype) {
  if (dtype == yat::kBFloat16) return static_cast<long long>(bf16_smem_bytes(d));
  return static_cast<long long>(f32_smem_bytes(d));
}

extern "C" int yat_attention_max_head_dim() { return kMaxD; }

// q [B, Nq, H, D], k/v [B, Nk, H, D], out [B, Nq, H, D], each with strides
// (b, n, h, 1); bias [B, Nk] fp32 with strides (bias_sb, 1), or null.
extern "C" int yat_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    void* out, int b, int nq, int nk, int h, int d,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long bias_sb,
    long long o_sb, long long o_sn, long long o_sh, float scale, int dtype,
    void* stream) {
  if (d > kMaxD || d < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  const float* bp = static_cast<const float*>(bias);
  // one key block covering every key: P normalised before it is rounded
  if (dtype == yat::kFloat32)
    return static_cast<int>(launch_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bp, static_cast<float*>(out), b, nq,
        nk, h, d, qs, ks, vs, bias_sb, os, scale, nk, nullptr, nullptr, st));
  if (dtype != yat::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bf16<SoftmaxKernel>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bp, static_cast<bf16*>(out), b, nq, nk, h,
      d, qs, ks, vs, bias_sb, os, scale, nk, nullptr, nullptr, st));
}
