// K6: non-causal softmax attention over a long key sequence with an
//     optional fp32 additive key bias shared by all heads (0 to keep a key,
//     -0.7 * FLT_MAX to mask it), o = softmax(q k^T / sqrt(D) + bias) v, on
//     the native [B, N, H, D] layout read and written through strides.
//
// Replaces the TPU kernel that yat_tpu/ops/attention.py:dot_product_attention
// reaches through the Pallas library's flash_attention (forward kernels
// _flash_attention_kernel_single_batch and ..._single_step of
// jax/experimental/pallas/ops/tpu/flash_attention.py), which the JAX package
// runs with block_q = block_k = _flash_block(N) (<= 1024) and a key mask
// carried as segment ids.
//
// What it computes, as the library does: the keys fall into "key blocks"
// of block_keys = _flash_block(N_k) keys (passed in by the wrapper).  With
// one block (N_k <= 1024 at the PixArt shapes: the library's single-step
// kernel) P = exp(s - max) / sum is normalised in fp32 before it is rounded
// to bf16 for P.V.  With several (N_k = 2048, 4096, ...), each block's
// P = exp(s - m) is taken against the running max m after that block and
// rounded to bf16 unnormalised; the fp32 accumulator is rescaled by
// exp(m_old - m_new) at each block start and divided by the running sum at
// the end.  A row whose keys are all masked gets the mean of V, because
// the mask value is finite.  Under autograd it also writes each row's final
// running max m and exp-sum l, fp32 [B, H, N_q] (the library's l and m
// residuals, _flash_attention_kernel_single_batch :464-481 and
// ..._single_step :544-552), which the backward K6b
// (flash_attention_bwd.cu) reads; serving passes null and writes neither.
//
// Bound on the H100: operations at the PixArt-Sigma 512px self-attention
// shape, q/k/v [8, 1024, 16, 72] bf16: 4 * 8 * 16 * 1024^2 * 72 = 38.7
// GFLOP on the tensor cores (0.039 ms at 989 TFLOP/s) against 75.5 MB
// (0.0225 ms at 3.35 TB/s).  With a key mask, the bound counts the kept
// keys only, and so does the kernel's walk.  Design (attention_tiles.cuh,
// attention_bf16_block):
//   * one block per (128 queries, head, batch element): 1024 blocks at that
//     shape, two per SM; eight warps of 16 query rows; K and V tiles of 64
//     keys serve all 128 queries; no score reaches device memory;
//   * per key block, two passes over its 64-key tiles, because the single
//     block's probabilities are normalised before they are rounded: pass 1
//     the rows' max and exp-sum (online per thread in 32-key sub-steps,
//     merged across the four threads that share a row), pass 2 recomputes
//     the scores, rounds P and accumulates P.V;
//   * the 64-key tiles whose keys are all masked (every bias entry the
//     library's mask value) are walked by neither pass: the block flags
//     the kept tiles from its batch element's bias row first.  Exact: see
//     attention_bf16_block;
//   * per score: the scale multiply, the bias add only with a bias, the
//     ragged-key compare only on a key block's last tile, e^x as
//     ex2.approx(x log2 e); the single block's division a multiply by the
//     row's reciprocal and one FMA correction (the correctly rounded
//     quotient);
//   * both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     fp32 accumulation), operands by ldmatrix (V transposed on the way);
//     the queries' fragments (up to D = 80), the scores, P and the
//     accumulator stay in registers;
//   * K and V through a three-stage cp.async ring (two stages past D = 80)
//     with one barrier per tile;
//   * the head dim is zero-padded in shared memory to a multiple of 16 (72
//     -> 80) chosen at compile time, up to 256; no head dim spills (the
//     launch bound asks for two blocks per SM up to D = 128, one at 256);
//   * the output goes out through shared memory in 16-byte stores;
//   * fp32: the same key blocks on the CUDA cores, without rounding P, every
//     tile walked (attention_fwd_f32).
// Faster still (wgmma, TMA, a producer warp) is later work.
#include "attention_tiles.cuh"

namespace {

using namespace yat::attn;

constexpr int kMaxD = 256;

template <bool kVec, int kDC, bool kBias>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks(kDC, kVec))
flash_attention_fwd_bf16(const FwdArgs a, float mask_value) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  attention_bf16_block<kVec, kDC, kBias>(a, mask_value, smem_raw);
}

struct FlashKernel {
  // the library's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX rounded to fp32: the
  // bias of a masked key
  static constexpr float kMaskValue =
      static_cast<float>(-0.7 * 3.4028234663852886e38);
  static constexpr int kMaxDC = 16;
  template <bool kVec, int kDC, bool kBias>
  static auto fn() { return flash_attention_fwd_bf16<kVec, kDC, kBias>; }
};

}  // namespace

// Shared memory one block needs (bf16: a 128-query block), so the wrapper
// can refuse shapes that do not fit before launching.
extern "C" long long yat_flash_attention_smem_bytes(int d, int dtype) {
  if (dtype == yat::kBFloat16)
    return static_cast<long long>(fwd_smem_bytes(d));
  return static_cast<long long>(f32_smem_bytes(d));
}

extern "C" int yat_flash_attention_max_head_dim() { return kMaxD; }

// Registers a thread, local (spill) bytes a thread, shared bytes and
// blocks per SM of the bf16 launch at head dim d with 16-byte loads (vec)
// or element loads, without a bias (out[0:4]) and with one (out[4:8]).
extern "C" int yat_flash_attention_launch_info(int d, int vec,
                                               long long* out) {
  if (d > kMaxD || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  a.d = d;
  return static_cast<int>(fwd_bf16<FlashKernel>(a, vec != 0, nullptr, out));
}

// q [B, Nq, H, D], k/v [B, Nk, H, D], out [B, Nq, H, D], each with strides
// (b, n, h, 1); bias [B, Nk] fp32 with strides (bias_sb, 1), or null;
// block_keys: the library's key block, a multiple of 64 unless >= Nk;
// res_m/res_l: fp32 [B, H, Nq] for the row max and exp-sum, or both null.
extern "C" int yat_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias,
    void* out, int b, int nq, int nk, int h, int d,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long bias_sb,
    long long o_sb, long long o_sn, long long o_sh, float scale,
    int block_keys, void* res_m, void* res_l, int dtype, void* stream) {
  if (d > kMaxD || d < 1 || nk < 1 || block_keys < 1 ||
      (block_keys < nk && block_keys % kBK != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh},
      vs{v_sb, v_sn, v_sh}, os{o_sb, o_sn, o_sh};
  const float* bp = static_cast<const float*>(bias);
  float* rm = static_cast<float*>(res_m);
  float* rl = static_cast<float*>(res_l);
  if ((rm == nullptr) != (rl == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == yat::kFloat32)
    return static_cast<int>(launch_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bp, static_cast<float*>(out), b, nq,
        nk, h, d, qs, ks, vs, bias_sb, os, scale, block_keys, rm, rl, st));
  if (dtype != yat::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), bp, static_cast<bf16*>(out),
                  b, nq, nk, h, d, qs, ks, vs, bias_sb, os, scale,
                  block_keys, rm, rl};
  return static_cast<int>(launch_bf16<FlashKernel>(a, st));
}
