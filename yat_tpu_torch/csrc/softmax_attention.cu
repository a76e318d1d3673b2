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
// [8,512,16,72] bf16, counting the kept keys only: the captions keep 1 or
// about 150 of 512).  Design (the bf16 body attention_bf16_block of
// attention_tiles.cuh, shared with K6, with one key block covering every
// key):
//   * one block per (128 queries, head, batch element): 256 blocks on the
//     serving path, eight warps; no score reaches device memory;
//   * the 64-key tiles whose keys are all masked (the caption's padding,
//     bias -1e9) are never walked: the block flags the kept tiles from its
//     batch element's bias row first; a caption with no kept key walks
//     every tile (the mean of V, as the plain version gives);
//   * K and V pass through a three-stage cp.async ring (two past D = 80)
//     in 64-key tiles, one barrier per tile; the ragged last tile is
//     zero-filled and masked out of the softmax, so N_k needs no padding;
//   * two passes over the walked tiles (mma.sync products from ldmatrix
//     operands, scores, P and the accumulator in registers), P divided by
//     the row sum as a multiply by the reciprocal plus one FMA correction
//     (the correctly rounded quotient), e^x as ex2.approx(x log2 e);
//   * fp32: the same two passes over every 64-key tile on the CUDA cores
//     (attention_tiles.cuh), so any N_k the short-sequence gate admits fits
//     in shared memory.
// Numerics follow the plain version (ops/attention.py:attention_ref): fp32
// scores, max-subtracted exp, division by the row sum, probabilities
// rounded to the storage type of v before the fp32-accumulated P.V; bf16
// takes e^x on the special-function unit (about 2 ulp of fp32 before P is
// rounded to bf16).
#include "attention_tiles.cuh"

namespace {

using namespace yat::attn;

constexpr int kMaxD = 128;

template <bool kVec, int kDC, bool kBias>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks(kDC, kVec))
attention_fwd_bf16(const FwdArgs a, float mask_value) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  attention_bf16_block<kVec, kDC, kBias>(a, mask_value, smem_raw);
}

struct SoftmaxKernel {
  // the JAX package's _VMEM_MASK_VALUE: the bias of a masked key
  static constexpr float kMaskValue = -1e9f;
  static constexpr int kMaxDC = 8;
  template <bool kVec, int kDC, bool kBias>
  static auto fn() { return attention_fwd_bf16<kVec, kDC, kBias>; }
};

}  // namespace

// Shared memory one block needs (bf16: a 128-query block), so the wrapper
// can refuse shapes that do not fit before launching.
extern "C" long long yat_attention_smem_bytes(int d, int dtype) {
  if (dtype == yat::kBFloat16)
    return static_cast<long long>(fwd_smem_bytes(d));
  return static_cast<long long>(f32_smem_bytes(d));
}

extern "C" int yat_attention_max_head_dim() { return kMaxD; }

// Registers a thread, local (spill) bytes a thread, shared bytes and
// blocks per SM of the bf16 launch at head dim d with 16-byte loads (vec)
// or element loads, without a bias (out[0:4]) and with one (out[4:8]).
extern "C" int yat_attention_launch_info(int d, int vec, long long* out) {
  if (d > kMaxD || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  a.d = d;
  return static_cast<int>(fwd_bf16<SoftmaxKernel>(a, vec != 0, nullptr, out));
}

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
  const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), bp, static_cast<bf16*>(out),
                  b, nq, nk, h, d, qs, ks, vs, bias_sb, os, scale, nk,
                  nullptr, nullptr};
  return static_cast<int>(launch_bf16<SoftmaxKernel>(a, st));
}
