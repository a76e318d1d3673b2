"""Attention: short-sequence softmax attention and ReLU linear attention.

Counterpart of ``yat_tpu/ops/attention.py``.  Tensors keep the JAX
package's ``[B, N, H, D]`` layout at these functions, and the kernels read
and write it through strides.  Each public function is a
``torch.autograd.Function``:

* :func:`dot_product_attention`: on a CUDA tensor kernel K2 forward
  (``csrc/softmax_attention.cu``, replacing the TPU kernel
  ``yat_tpu/ops/attention.py:_vmem_mh_fwd_kernel``) and kernel K2b backward
  (``csrc/softmax_attention_bwd.cu``, replacing ``_vmem_mh_bwd_kernel``);
  on a CPU tensor :func:`attention_ref` and :func:`attention_bwd_ref`.
* :func:`linear_attention`: on a CUDA tensor kernel K3 forward
  (``csrc/linear_attention.cu``, replacing ``_linatt_fwd_kernel``); on a CPU
  tensor :func:`linear_attention_ref`.  Its backward recomputes the plain
  version under autograd on either device, as the JAX package's
  ``_linatt_bwd`` does with ``jax.vjp``: the JAX package has no backward
  kernel there.

The JAX package picks among its TPU lowerings by shape and by the
``implementation`` string.  The port has one lowering per device: the
strings are checked exactly as there (unknown ones raise), a CUDA tensor
always goes to its kernel, and for linear attention the string and the
shape select the numerics of the JAX branch that would run (``round_kv``,
see :func:`linear_attention`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from yat_tpu_torch.kernels.build import CudaKernel, dtype_code, stream_of
from yat_tpu_torch.ops.norm import acc_dtype

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

SOFTMAX_ATTENTION = CudaKernel(
    "dot_product_attention", "softmax_attention.cu", "yat_attention_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 13 + [_F, _I, _P])
SOFTMAX_ATTENTION_BWD = CudaKernel(
    "dot_product_attention_bwd", "softmax_attention_bwd.cu",
    "yat_attention_bwd", [_P] * 9 + [_I] * 5 + [_L] * 22 + [_F, _I, _P])
LINEAR_ATTENTION = CudaKernel(
    "linear_attention", "linear_attention.cu", "yat_linear_attention_fwd",
    [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12 + [_F, _I, _I, _P])

# shared memory one block may use on the H100 (232,448 bytes)
_MAX_SMEM = 232448


def _key_bias(mask: Optional[torch.Tensor], b: int) -> Optional[torch.Tensor]:
    """[B, N_k] keep-mask (or [B, 1, 1, N_k]) → fp32 additive bias."""
    if mask is None:
        return None
    key_mask = mask if mask.ndim == 2 else mask.reshape(b, -1)
    return torch.where(key_mask.bool(), 0.0, -1e9).to(torch.float32)


def _probs(q, k, bias, acc):
    """fp32 (or wider) softmax probabilities [B, H, Nq, Nk]."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if bias is not None:
        s = s + bias.to(acc)[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(-1, keepdim=True)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: q [B, Nq, H, D], k/v [B, Nk, H, D], bias [B, Nk] fp32
    additive (the math of ``yat_tpu/ops/attention.py:_vmem_mh_fwd_kernel``:
    fp32 scores and softmax, probabilities in v's dtype, fp32 P.V)."""
    acc = acc_dtype(q)
    p = _probs(q, k, bias, acc)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return o.to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: Optional[torch.Tensor], g: torch.Tensor):
    """Plain backward, a copy of
    ``yat_tpu/ops/attention.py:_vmem_mh_bwd_kernel``: recompute P in fp32,
    ``dS = P (dP - rowsum(dP P))``, dS rounded to q's dtype before
    ``dq = dS k / sqrt(D)`` and ``dk = dSᵀ q / sqrt(D)``, P rounded to g's
    dtype before ``dv = Pᵀ g``.  Returns (dq, dk, dv); the bias gets none."""
    acc = acc_dtype(q)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = _probs(q, k, bias, acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(acc), v.to(acc))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_c = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q.to(acc)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).to(acc), g.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(name, ts, ndim=4):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.ndim != ndim or t.stride(-1) != 1:
            raise ValueError(f"{name} takes [B, N, H, D] tensors contiguous "
                             f"in D, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} / {ts[0].dtype}")


def _check_attention(q, k, v, bias):
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, N_k, H, D] matching q {tuple(q.shape)},"
                         f" got {tuple(k.shape)} / {tuple(v.shape)}")
    if nk == 0:
        raise ValueError("dot_product_attention needs at least one key")
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32)
        if bias.shape != (b, nk) or bias.stride(-1) != 1:
            raise ValueError(f"bias must be [B, N_k] = {(b, nk)}")
    return bias


def _attention_cuda(q, k, v, bias):
    _check_cuda("dot_product_attention", (q, k, v))
    b, nq, h, d = q.shape
    nk = k.shape[1]
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    bias = _check_attention(q, k, v, bias)
    max_d = SOFTMAX_ATTENTION.function("yat_attention_max_head_dim")()
    smem = SOFTMAX_ATTENTION.function(
        "yat_attention_smem_bytes", [_I, _I, _I], ctypes.c_longlong)(
            nk, d, dtype_code(q))
    if d > max_d or smem > _MAX_SMEM:
        raise ValueError(
            f"dot_product_attention kernel takes head_dim <= {max_d} and a "
            f"[64, N_k] score block in shared memory; N_k={nk}, D={d} "
            f"needs {smem} bytes of {_MAX_SMEM}")
    with torch.cuda.device(q.device):
        SOFTMAX_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, nq, nk, h, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], bias.stride(0) if bias is not None else 0,
            *out.stride()[:3], 1.0 / (d ** 0.5), dtype_code(q),
            stream_of(q))
    return out


def _attention_bwd_cuda(q, k, v, bias, g):
    g = g if g.stride(-1) == 1 else g.contiguous()
    _check_cuda("dot_product_attention backward", (q, k, v, g))
    if g.shape != q.shape:
        raise ValueError(f"g must have q's shape {tuple(q.shape)}")
    b, nq, h, d = q.shape
    nk = k.shape[1]
    bias = _check_attention(q, k, v, bias)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, nk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, nk, h, d), dtype=v.dtype, device=v.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    kern = SOFTMAX_ATTENTION_BWD
    max_d = kern.function("yat_attention_bwd_max_head_dim")()
    smem = kern.function("yat_attention_bwd_smem_bytes", [_I, _I],
                         ctypes.c_longlong)(d, dtype_code(q))
    if d > max_d or smem > _MAX_SMEM:
        raise ValueError(
            f"dot_product_attention backward kernel takes head_dim <= "
            f"{max_d} within {_MAX_SMEM} bytes of shared memory; D={d} in "
            f"{q.dtype} needs {smem}")
    # per-query max, exp-sum and rowsum(dP * P), from the dq launch to the
    # dk/dv launch
    stats = torch.empty((3, b, h, nq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        kern.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, nq, nk, h, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], bias.stride(0) if bias is not None else 0,
            *g.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
            *dv.stride()[:3], 1.0 / (d ** 0.5), dtype_code(q),
            stream_of(q))
    return dq, dk, dv


class _SoftmaxAttention(torch.autograd.Function):
    """K2 forward, K2b backward on CUDA; the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cpu":
            return attention_ref(q, k, v, bias)
        return _attention_cuda(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_ref(q, k, v, bias, g)
        else:
            dq, dk, dv = _attention_bwd_cuda(q, k, v, bias, g)
        return dq, dk, dv, None


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          implementation: str = "auto") -> torch.Tensor:
    """q,k,v: [B, N, H, D]; mask: [B, N_k] keep-mask or [B,1,1,N_k] bool."""
    if implementation not in ("auto", "xla", "vmem", "flash"):
        raise ValueError(
            f"unknown attention implementation {implementation!r}; expected "
            "'auto', 'xla', 'vmem', or 'flash'")
    if implementation == "flash" and (
            q.shape[1] % 128 != 0 or k.shape[1] % 128 != 0):
        raise ValueError(
            "flash attention requires both sequence lengths to be "
            f"multiples of 128, got N_q={q.shape[1]}, N_k={k.shape[1]} — "
            "use implementation='auto' to fall back automatically")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dot_product_attention runs on cuda or cpu, got {q.device}")
    return _SoftmaxAttention.apply(q, k, v, _key_bias(mask, q.shape[0]))


def linear_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         eps: float = 1e-15,
                         round_kv: bool = False) -> torch.Tensor:
    """Plain version, fp32 throughout (the math of
    ``yat_tpu/ops/attention.py:_reference_linatt`` on [B, N, H, D]).  With
    ``round_kv`` the [D, D] state is rounded to q's dtype before the second
    product, as the JAX einsum branch does (``attention.py:493-502``); the
    key sum and the denominator stay fp32."""
    acc = acc_dtype(q)
    qf = torch.relu(q.to(acc))
    kf = torch.relu(k.to(acc))
    kv = torch.einsum("bnhd,bnhe->bhde", kf, v.to(acc))
    if round_kv:
        kv = kv.to(q.dtype).to(acc)
    ksum = kf.sum(1)                                    # [B, H, D]
    num = torch.einsum("bnhd,bhde->bnhe", qf, kv)
    den = torch.einsum("bnhd,bhd->bnh", qf, ksum)[..., None]
    return (num / (den + eps)).to(q.dtype)


def _linear_attention_cuda(q, k, v, eps, round_kv):
    _check_cuda("linear_attention", (q, k, v))
    b, n, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("linear_attention takes q, k, v of one shape")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    max_d = LINEAR_ATTENTION.function("yat_linear_attention_max_head_dim")()
    if d > max_d:
        raise ValueError(f"linear_attention kernel takes head_dim <= {max_d},"
                         f" got {d}")
    with torch.cuda.device(q.device):
        LINEAR_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(eps), int(round_kv), dtype_code(q),
            stream_of(q))
    return out


class _LinearAttention(torch.autograd.Function):
    """K3 forward on CUDA, the plain version on the CPU; the backward
    recomputes the plain version under autograd (the JAX package's
    ``_linatt_bwd``), with the same ``round_kv``."""

    @staticmethod
    def forward(ctx, q, k, v, eps, round_kv):
        ctx.eps, ctx.round_kv = eps, round_kv
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return linear_attention_ref(q, k, v, eps, round_kv)
        return _linear_attention_cuda(q, k, v, eps, round_kv)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = linear_attention_ref(q, k, v, ctx.eps, ctx.round_kv)
            dq, dk, dv = torch.autograd.grad(out.to(g.dtype), (q, k, v), g)
        return dq, dk, dv, None, None


def kv_rounding(n: int, d: int, implementation: str = "auto") -> bool:
    """Whether the JAX package's ``linear_attention`` rounds the state to the
    compute dtype for this sequence length, head dim and implementation
    string: its Pallas kernel (fp32 state) runs for ``"pallas"``, and for
    ``"auto"`` at long sequences (``attention.py:484-487``, leaving out its
    backend test); its einsum branch (rounded state) otherwise."""
    fp32_state = implementation == "pallas" or (
        implementation == "auto" and n >= 4096
        and n * d * 12 < 8 * 1024 * 1024 and n % 8 == 0)
    return not fp32_state


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-15,
                     implementation: str = "auto") -> torch.Tensor:
    """ReLU linear attention.  q,k,v: [B, N, H, D] → [B, N, H, D].

    Every implementation runs kernel K3 on a CUDA tensor; the string selects
    the numerics of the JAX branch it names (:func:`kv_rounding`), which in
    fp32 change nothing."""
    if implementation not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown linear-attention implementation "
                         f"{implementation!r}; expected 'auto', 'xla', or "
                         "'pallas'")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_attention runs on cuda or cpu, got {q.device}")
    round_kv = kv_rounding(q.shape[1], q.shape[3], implementation)
    return _LinearAttention.apply(q, k, v, eps, round_kv)
