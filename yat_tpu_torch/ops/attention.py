"""Attention: softmax attention (short, folded, flash and XLA branches) and
ReLU linear attention.

Counterpart of ``yat_tpu/ops/attention.py``.  Tensors keep the JAX
package's ``[B, N, H, D]`` layout at these functions, and the kernels read
and write it through strides.

:func:`dot_product_attention` takes the branch the JAX package takes for
the same shape and ``implementation`` string (:func:`attention_branch`,
leaving out only its test for a TPU backend); the branches round
differently, and each keeps its own rounding:

* ``"native"`` and ``"folded"``, short sequences: kernel K2 forward
  (``csrc/softmax_attention.cu``, replacing the TPU kernels
  ``_vmem_mh_fwd_kernel`` (K2) and ``_vmem_attn_fwd_kernel`` (K4), which
  differ only in the memory layout they read) and kernel K2b backward
  (``csrc/softmax_attention_bwd.cu``); the plain versions
  :func:`attention_ref` and :func:`attention_bwd_ref`.  The two branches
  launch one kernel through two handles in each direction (K2/K4 forward,
  K2b/K4b backward), so each counts its own launches;
* ``"flash"``, long sequences: kernel K6 forward
  (``csrc/flash_attention.cu``, replacing the Pallas library's
  ``flash_attention``), which under autograd also writes the rows' max and
  exp-sum, and kernel K6b backward (``csrc/flash_attention_bwd.cu``,
  replacing the library's ``_flash_attention_bwd_dkv`` and ``_dq``); the
  plain versions :func:`flash_attention_ref` and
  :func:`flash_attention_bwd_ref`.  :func:`flash_attention` calls these
  two kernels directly, without the gate or a mask, at any lengths (the
  MMDiT's joint attention);
* ``"xla"``, every other shape: :func:`attention_xla`, plain tensor code
  with the rounding of ``jax.nn.dot_product_attention``.  It stands for no
  TPU kernel; it counts its calls on CUDA tensors, so a run on the card
  can show that it was not taken.

:func:`linear_attention`: on a CUDA tensor kernel K3 forward
(``csrc/linear_attention.cu``, replacing ``_linatt_fwd_kernel``); on a CPU
tensor :func:`linear_attention_ref`.  Its backward recomputes the plain
version under autograd on either device, as the JAX package's
``_linatt_bwd`` does with ``jax.vjp``: the JAX package has no backward
kernel there.  Its implementation string and the shape select the numerics
of the JAX branch that would run (``round_kv``, see
:func:`linear_attention`).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel
of its branch or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from yat_tpu_torch.kernels.build import (
    CudaKernel,
    LaunchCounter,
    dtype_code,
    stream_of,
)
from yat_tpu_torch.ops.norm import acc_dtype

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_K2_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 13 + [_F, _I, _P]
SOFTMAX_ATTENTION = CudaKernel(
    "dot_product_attention", "softmax_attention.cu", "yat_attention_fwd",
    _K2_ARGS)
# K2's kernel where the JAX package runs its folded-layout kernel K4
SOFTMAX_ATTENTION_FOLDED = CudaKernel(
    "dot_product_attention_folded", "softmax_attention.cu",
    "yat_attention_fwd", _K2_ARGS)
_K2B_ARGS = [_P] * 9 + [_I] * 5 + [_L] * 22 + [_F, _I, _P]
SOFTMAX_ATTENTION_BWD = CudaKernel(
    "dot_product_attention_bwd", "softmax_attention_bwd.cu",
    "yat_attention_bwd", _K2B_ARGS)
# K2b's kernel where the JAX package runs its folded-layout backward K4b
SOFTMAX_ATTENTION_FOLDED_BWD = CudaKernel(
    "dot_product_attention_folded_bwd", "softmax_attention_bwd.cu",
    "yat_attention_bwd", _K2B_ARGS)
FLASH_ATTENTION = CudaKernel(
    "flash_attention", "flash_attention.cu", "yat_flash_attention_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 13
    + [_F, _I, _P, _P, _I, _P])
FLASH_ATTENTION_BWD = CudaKernel(
    "flash_attention_bwd", "flash_attention_bwd.cu", "yat_flash_attention_bwd",
    [_P] * 12 + [_I] * 5 + [_L] * 25 + [_F, _I, _P])
LINEAR_ATTENTION = CudaKernel(
    "linear_attention", "linear_attention.cu", "yat_linear_attention_fwd",
    [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12 + [_F, _I, _I, _P])
# K3 split in two for token-sharded blocks: the state (K3s) and the apply
# (K3a) launches
LINEAR_ATTENTION_STATE = CudaKernel(
    "linear_attention_state", "linear_attention.cu",
    "yat_linear_attention_state", [_P] * 4 + [_I] * 4 + [_L] * 6 + [_I, _P])
LINEAR_ATTENTION_APPLY = CudaKernel(
    "linear_attention_apply", "linear_attention.cu",
    "yat_linear_attention_apply",
    [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _I, _I, _P])
ATTENTION_XLA = LaunchCounter("attention_xla")

# shared memory one block may use on the H100 (232,448 bytes)
_MAX_SMEM = 232448
# the additive bias of a masked key: K2's wrapper in the JAX package adds
# -1e9; the flash library adds -0.7 * FLT_MAX (its DEFAULT_MASK_VALUE), and
# jax.nn.dot_product_attention puts the same number in place of the logit
_VMEM_MASK_VALUE = -1e9
FLASH_MASK_VALUE = -0.7 * torch.finfo(torch.float32).max


def flash_block(n: int) -> int:
    """The flash kernel's key (and query) block: the largest of 1024, 512,
    256, 128 that divides ``n``, else ``min(n, 128)`` (a copy of
    ``yat_tpu/ops/attention.py:_flash_block``)."""
    for b in (1024, 512, 256, 128):
        if n % b == 0:
            return b
    return min(n, 128)


def attention_branch(n_q: int, n_k: int, h: int, d: int,
                     implementation: str = "auto") -> str:
    """The branch the JAX package's ``dot_product_attention`` takes for
    these sizes (``yat_tpu/ops/attention.py:74-124, 357-395``, leaving out
    its TPU-backend test): ``"native"`` (``_vmem_attn_native_p``, K2),
    ``"folded"`` (``_vmem_attn_p``, K4), ``"flash"`` (the library
    ``flash_attention``, K6) or ``"xla"`` (``jax.nn.dot_product_attention``).
    """
    n_kp = -(-n_k // 128) * 128
    short = n_q % 8 == 0 and d <= 128 and n_q * n_kp <= 512 * 1024
    if implementation == "vmem" or (implementation == "auto" and short):
        hd = h * d
        # the native kernel needs lane-aligned [N, H*D] slabs and its
        # backward's blocks resident in 12 MB of VMEM
        vmem_bwd = 3 * (n_q + 2 * n_kp) * hd * 2 + 3 * n_q * n_kp * 4
        native = hd % 128 == 0 and vmem_bwd <= 12 * 2 ** 20
        return "native" if native else "folded"
    long = (n_q >= 1024 and n_k >= 128 and n_q % 128 == 0 and n_k % 128 == 0
            and d <= 256)
    if implementation == "xla" or (implementation == "auto" and not long):
        return "xla"
    return "flash"


def _key_bias(mask: Optional[torch.Tensor], b: int,
              masked: float = _VMEM_MASK_VALUE) -> Optional[torch.Tensor]:
    """[B, N_k] keep-mask (or [B, 1, 1, N_k]) → fp32 additive bias: 0 where
    a key is kept, ``masked`` where it is not."""
    if mask is None:
        return None
    key_mask = mask if mask.ndim == 2 else mask.reshape(b, -1)
    return torch.where(key_mask.bool(), 0.0, masked).to(torch.float32)


def _scores(q, k, bias, acc):
    """fp32 (or wider) scaled scores [B, H, Nq, Nk] plus the key bias."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if bias is not None:
        s = s + bias.to(acc)[:, None, None, :]
    return s


def _softmax(s):
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(-1, keepdim=True)


def _probs(q, k, bias, acc):
    """fp32 (or wider) softmax probabilities [B, H, Nq, Nk]."""
    return _softmax(_scores(q, k, bias, acc))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: q [B, Nq, H, D], k/v [B, Nk, H, D], bias [B, Nk] fp32
    additive (the math of ``yat_tpu/ops/attention.py:_vmem_mh_fwd_kernel``
    and ``_vmem_attn_fwd_kernel``: fp32 scores and softmax, probabilities in
    v's dtype, fp32 P.V)."""
    acc = acc_dtype(q)
    p = _probs(q, k, bias, acc)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return o.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        residuals: bool = False):
    """Plain version of K6: the Pallas library flash kernel's arithmetic,
    key block by key block of :func:`flash_block` keys (the last one may be
    short).  One block: ``P = exp(s - max) / sum`` in fp32, rounded to v's
    dtype before P.V (its single-step kernel).  Several: per block
    ``P = exp(s - m_next)`` against the running max, rounded unnormalised,
    and ``acc = acc * (l_corr / l_next) + (P.V) / l_next``
    (``flash_attention.py:_flash_attention_kernel_single_batch``).  ``bias``
    is [B, Nk] fp32 additive (``FLASH_MASK_VALUE`` at masked keys).

    With ``residuals`` it returns ``(o, l, m)``: each row's exp-sum and max
    as the library's forward saves them for its backward (the single
    block's, or the final running values), fp32 ``[B, H, Nq]``."""
    acc = acc_dtype(q)
    s = _scores(q, k, bias, acc)
    v32 = v.to(acc)
    nk = k.shape[1]
    blk = flash_block(nk)
    if blk >= nk:
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", (e / l).to(v.dtype).to(acc),
                         v32).to(q.dtype)
        return (o, l[..., 0], m[..., 0]) if residuals else o
    o = m_prev = l_prev = None
    for k0 in range(0, nk, blk):
        sb = s[..., k0:k0 + blk]
        m_cur = sb.amax(-1, keepdim=True)
        m_next = m_cur if m_prev is None else torch.maximum(m_prev, m_cur)
        p = torch.exp(sb - m_next)
        l_corr = 0.0 if m_prev is None else torch.exp(m_prev - m_next) * l_prev
        l_next = p.sum(-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc),
                          v32[:, k0:k0 + blk])
        o = pv * inv if o is None else o * (l_corr * inv) + pv * inv
        m_prev, l_prev = m_next, l_next
    o = o.permute(0, 2, 1, 3).to(q.dtype)
    return (o, l_prev[..., 0], m_prev[..., 0]) if residuals else o


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: Optional[torch.Tensor],
                            o: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                            g: torch.Tensor):
    """Plain version of K6b: the Pallas library's flash VJP
    (``flash_attention.py:_flash_attention_bwd`` and the kernels of
    ``_flash_attention_bwd_dkv``/``_dq``) from the forward's rounded output
    ``o`` and its residuals ``l``, ``m`` ([B, H, Nq]), in fp32:

    1. ``s = (q kᵀ) · sm_scale + bias`` (the mask after the scale);
    2. ``p = exp(s − m) · (1 / l)``, a multiply by the reciprocal;
    3. ``di = rowsum(o · g)``;
    4. ``dv = (p rounded to g's dtype)ᵀ g``;
    5. ``ds = ((g vᵀ − di) · p) · sm_scale``, the scale before ``ds`` is
       rounded;
    6. ``dk = (ds rounded)ᵀ q``, ``dq = (ds rounded) k``, no further scale.

    Returns (dq, dk, dv), each rounded once; the bias gets none."""
    acc = acc_dtype(q)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k, bias, acc)
    p = torch.exp(s - m.to(acc)[..., None]) * (1.0 / l.to(acc))[..., None]
    g32 = g.to(acc)
    di = (o.to(acc) * g32).sum(-1).permute(0, 2, 1)          # [B, H, Nq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).to(acc), g32)
    dp = torch.einsum("bqhd,bkhd->bhqk", g32, v.to(acc))
    ds = (dp - di[..., None]) * p * scale
    ds_c = ds.to(g.dtype).to(acc)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q.to(acc))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's non-Pallas branch, ``jax.nn.dot_product_attention``
    in plain tensor code on either device: fp32 logits, masked logits
    replaced by ``FLASH_MASK_VALUE``, fp32 softmax, probabilities rounded to
    k's dtype, fp32 P.V.  ``mask`` is a [B, N_k] keep-mask or
    [B, 1, 1, N_k].  Under autograd it keeps only its inputs: the backward
    recomputes this arithmetic and differentiates it (:class:`_XlaAttention`),
    so no [B, H, N_q, N_k] tensor outlives the call."""
    if q.is_cuda:
        ATTENTION_XLA.launches += 1
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _XlaAttention.apply(q, k, v, mask)
    return _attention_xla(q, k, v, mask)


def _attention_xla(q, k, v, mask):
    acc = acc_dtype(q)
    s = _scores(q, k, None, acc)
    if mask is not None:
        key_mask = mask if mask.ndim == 2 else mask.reshape(q.shape[0], -1)
        s = torch.where(key_mask.bool()[:, None, None, :], s,
                        FLASH_MASK_VALUE)
    p = _softmax(s)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(k.dtype).to(acc), v.to(acc))
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


def _forward_launch(kern, q, k, v, bias, extra, prefix):
    """Check q/k/v/bias, allocate the output and launch the forward kernel
    ``kern`` (K2 or K6: one argument layout, ``extra`` before the dtype
    code; ``prefix`` names its head-dim and shared-memory queries)."""
    _check_cuda(kern.name, (q, k, v))
    b, nq, h, d = q.shape
    nk = k.shape[1]
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    bias = _check_attention(q, k, v, bias)
    _check_head_dim(kern, prefix, q)
    with torch.cuda.device(q.device):
        kern.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, nq, nk, h, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], bias.stride(0) if bias is not None else 0,
            *out.stride()[:3], 1.0 / (d ** 0.5), *extra, dtype_code(q),
            stream_of(q))
    return out


def _attention_cuda(q, k, v, bias, folded=False):
    """Kernel K2 (counted as K4 where the JAX package folds heads)."""
    kern = SOFTMAX_ATTENTION_FOLDED if folded else SOFTMAX_ATTENTION
    return _forward_launch(kern, q, k, v, bias, (), "yat_attention")


def _flash_attention_cuda(q, k, v, bias, residuals=False):
    """Kernel K6, with the library's key block of :func:`flash_block`; with
    ``residuals`` it returns ``(o, l, m)`` as :func:`flash_attention_ref`
    does, the kernel writing l and m."""
    b, nq, h, _ = q.shape
    m = l = None
    if residuals:
        m, l = torch.empty((2, b, h, nq), dtype=torch.float32,
                           device=q.device)
    out = _forward_launch(FLASH_ATTENTION, q, k, v, bias,
                          (flash_block(k.shape[1]),
                           m.data_ptr() if residuals else None,
                           l.data_ptr() if residuals else None),
                          "yat_flash_attention")
    return (out, l, m) if residuals else out


def _check_bwd_shapes(name, q, k, v, g, bias):
    g = g if g.stride(-1) == 1 else g.contiguous()
    _check_cuda(name, (q, k, v, g))
    if g.shape != q.shape:
        raise ValueError(f"g must have q's shape {tuple(q.shape)}")
    bias = _check_attention(q, k, v, bias)
    return g, bias


def _check_head_dim(kern, prefix, q):
    """Raise unless the kernel takes q's head dim within the shared memory
    of one block (``{prefix}_max_head_dim`` and ``{prefix}_smem_bytes``)."""
    d = q.shape[-1]
    max_d = kern.function(f"{prefix}_max_head_dim")()
    smem = kern.function(f"{prefix}_smem_bytes", [_I, _I],
                         ctypes.c_longlong)(d, dtype_code(q))
    if d > max_d or smem > _MAX_SMEM:
        raise ValueError(
            f"{kern.name} kernel takes head_dim <= {max_d} within "
            f"{_MAX_SMEM} bytes of shared memory; D={d} in {q.dtype} needs "
            f"{smem}")


def _attention_bwd_cuda(q, k, v, bias, g, folded=False):
    """Kernel K2b (counted as K4b where the JAX package folds heads)."""
    kern = SOFTMAX_ATTENTION_FOLDED_BWD if folded else SOFTMAX_ATTENTION_BWD
    g, bias = _check_bwd_shapes(kern.name, q, k, v, g, bias)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, nk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, nk, h, d), dtype=v.dtype, device=v.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    _check_head_dim(kern, "yat_attention_bwd", q)
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


def _flash_attention_bwd_cuda(q, k, v, bias, o, l, m, g):
    """Kernel K6b: two launches (dq, then dk/dv) from the forward's output
    ``o`` and its residuals ``l``, ``m``."""
    kern = FLASH_ATTENTION_BWD
    g, bias = _check_bwd_shapes(kern.name, q, k, v, g, bias)
    _check_cuda(kern.name, (q, o))
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if o.shape != q.shape:
        raise ValueError(f"o must have q's shape {tuple(q.shape)}")
    for t in (l, m):
        if (t.shape != (b, h, nq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"l and m must be contiguous fp32 [B, H, Nq] = "
                             f"{(b, h, nq)} on {q.device}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, nk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, nk, h, d), dtype=v.dtype, device=v.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    _check_head_dim(kern, "yat_flash_attention_bwd", q)
    # rowsum(o * g) per query, from the dq launch to the dk/dv launch
    di = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        kern.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, o.data_ptr(),
            g.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, nq, nk, h, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], bias.stride(0) if bias is not None else 0,
            *o.stride()[:3], *g.stride()[:3], *dq.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], 1.0 / (d ** 0.5),
            dtype_code(q), stream_of(q))
    return dq, dk, dv


class _XlaAttention(torch.autograd.Function):
    """:func:`attention_xla` with its probabilities recomputed in the
    backward, which is autograd's gradient of the same plain arithmetic."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _attention_xla(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        ins = [t.detach().requires_grad_(need)
               for t, need in zip((q, k, v), ctx.needs_input_grad)]
        with torch.enable_grad():
            o = _attention_xla(*ins, mask)
        grads = iter(torch.autograd.grad(
            o, [t for t in ins if t.requires_grad], g))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None)


class _SoftmaxAttention(torch.autograd.Function):
    """K2 (or K4) forward, K2b (or K4b) backward on CUDA; the plain versions
    on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, bias, folded):
        ctx.save_for_backward(q, k, v, bias)
        ctx.folded = folded
        if q.device.type == "cpu":
            return attention_ref(q, k, v, bias)
        return _attention_cuda(q, k, v, bias, folded)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_ref(q, k, v, bias, g)
        else:
            dq, dk, dv = _attention_bwd_cuda(q, k, v, bias, g, ctx.folded)
        return dq, dk, dv, None, None


class _FlashAttention(torch.autograd.Function):
    """K6 forward, K6b backward on CUDA; the plain versions on the CPU.
    ``residuals``: whether a backward will follow, so that the forward
    keeps the rows' max and exp-sum (serving does not ask)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, residuals):
        if q.device.type == "cpu":
            out = flash_attention_ref(q, k, v, bias, residuals)
        else:
            out = _flash_attention_cuda(q, k, v, bias, residuals)
        if not residuals:
            return out
        o, l, m = out
        ctx.save_for_backward(q, k, v, bias, o, l, m)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, l, m = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, bias, o, l, m, g)
        else:
            dq, dk, dv = _flash_attention_bwd_cuda(q, k, v, bias, o, l, m, g)
        return dq, dk, dv, None, None


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          implementation: str = "auto",
                          whole: Optional[tuple] = None) -> torch.Tensor:
    """q,k,v: [B, N, H, D]; mask: [B, N_k] keep-mask or [B,1,1,N_k] bool.
    The branch is :func:`attention_branch`'s; ``whole`` ``(N_q, H)``: this
    call holds a slice of the queries (``sp``) or of the heads (``tp``) of
    an attention of that size, whose branch it takes (the JAX package
    chooses on the whole shapes under GSPMD)."""
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
    b, n_q, h, d = q.shape
    if whole is not None:
        n_q, h = whole
    branch = attention_branch(n_q, k.shape[1], h, d, implementation)
    if branch == "xla":
        return attention_xla(q, k, v, mask)
    if branch == "flash":
        return _flash(q, k, v, _key_bias(mask, b, FLASH_MASK_VALUE))
    return _SoftmaxAttention.apply(q, k, v, _key_bias(mask, b),
                                   branch == "folded")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Unmasked softmax attention on K6 (forward, keeping its rows' max and
    exp-sum under autograd) and K6b (backward), called directly: q
    ``[B, N_q, H, D]``, k/v ``[B, N_k, H, D]``, any lengths (the last key
    and query blocks may be short), no gate.  The MMDiT's joint attention
    runs here where the JAX package calls ``jax.nn.dot_product_attention``
    (its plain arithmetic would build ``[B, H, N_q, N_k]`` fp32 scores).
    A CPU tensor takes :func:`flash_attention_ref` and
    :func:`flash_attention_bwd_ref`."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return _flash(q, k, v, None)


def _flash(q, k, v, bias):
    """K6/K6b under autograd; the forward keeps its rows' max and exp-sum
    only when a backward will follow."""
    residuals = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, bias, residuals)


def linear_attention_state_ref(k: torch.Tensor, v: torch.Tensor):
    """K3s's plain version, the first half of :func:`linear_attention_ref`:
    ``(relu(k)^T v`` ``[B, H, D, D]``, ``sum_n relu(k)`` ``[B, H, D])`` in
    the accumulation dtype (fp32 for fp32 and bf16)."""
    acc = acc_dtype(k)
    kf = torch.relu(k.to(acc))
    kv = torch.einsum("bnhd,bnhe->bhde", kf, v.to(acc))
    return kv, kf.sum(1)


def linear_attention_apply_ref(q: torch.Tensor, kv: torch.Tensor,
                               ksum: torch.Tensor, eps: float = 1e-15,
                               round_kv: bool = False) -> torch.Tensor:
    """K3a's plain version, the second half of :func:`linear_attention_ref`:
    ``relu(q) . kv / (relu(q) . ksum + eps)`` in the accumulation dtype,
    the state rounded to q's dtype first with ``round_kv``, the output in
    q's dtype."""
    acc = acc_dtype(q)
    qf = torch.relu(q.to(acc))
    if round_kv:
        kv = kv.to(q.dtype).to(acc)
    num = torch.einsum("bnhd,bhde->bnhe", qf, kv)
    den = torch.einsum("bnhd,bhd->bnh", qf, ksum)[..., None]
    return (num / (den + eps)).to(q.dtype)


def linear_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         eps: float = 1e-15,
                         round_kv: bool = False) -> torch.Tensor:
    """Plain version, fp32 throughout (the math of
    ``yat_tpu/ops/attention.py:_reference_linatt`` on [B, N, H, D]): the
    state (:func:`linear_attention_state_ref`), then its product with the
    queries (:func:`linear_attention_apply_ref`).  With ``round_kv`` the
    [D, D] state is rounded to q's dtype before the second product, as the
    JAX einsum branch does (``attention.py:493-502``); the key sum and the
    denominator stay fp32."""
    kv, ksum = linear_attention_state_ref(k, v)
    return linear_attention_apply_ref(q, kv, ksum, eps, round_kv)


def _check_linear_rows(name, ts):
    """K3, K3s and K3a copy rows in 4-byte pieces: raise unless D and the
    strides of ``ts`` keep every row on a 4-byte boundary and D is at most
    the kernels' largest head dim."""
    d = ts[0].shape[3]
    es = ts[0].element_size()
    for t in ts:
        if (d * es) % 4 or t.data_ptr() % 4 or any(
                (s * es) % 4 for s in t.stride()[:3]):
            raise ValueError(
                f"{name} kernel copies rows in 4-byte pieces: D and the "
                "strides must keep every row on a 4-byte boundary (got "
                f"D={d}, {t.dtype}, strides {[u.stride() for u in ts]})")
    max_d = LINEAR_ATTENTION.function("yat_linear_attention_max_head_dim")()
    if d > max_d:
        raise ValueError(f"{name} kernel takes head_dim <= {max_d}, got {d}")


def _linear_attention_args(q, k, v, out, eps, round_kv):
    """Check q/k/v/out for K3 and return its C arguments up to the dtype
    code (the stream, or the info buffer, follows)."""
    _check_cuda("linear_attention", (q, k, v, out))
    b, n, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("linear_attention takes q, k, v of one shape")
    _check_linear_rows("linear_attention", (q, k, v, out))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(eps), int(round_kv), dtype_code(q))


def _linear_attention_cuda(q, k, v, eps, round_kv):
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    args = _linear_attention_args(q, k, v, out, eps, round_kv)
    with torch.cuda.device(q.device):
        LINEAR_ATTENTION.launch(*args, stream_of(q))
    return out


def linear_attention_launch_info(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 implementation: str = "auto") -> dict:
    """The launch K3 makes for these CUDA tensors (without making it): its
    path (``"tensor cores"`` for bf16 with a rounded state, else ``"CUDA
    cores"``), copy width in bytes, registers and local (spill) bytes a
    thread, shared bytes and blocks per SM."""
    round_kv = kv_rounding(q.shape[1], q.shape[3], implementation)
    return _info_of(LINEAR_ATTENTION, "yat_linear_attention_info",
                    _linear_attention_args(q, k, v, torch.empty_like(q),
                                           1e-15, round_kv))


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


def _state_args(k, v):
    """Check k/v for K3s; (kv, ksum, its C arguments up to the dtype
    code)."""
    _check_cuda("linear_attention_state", (k, v))
    if k.shape != v.shape:
        raise ValueError("linear_attention_state takes k, v of one shape")
    _check_linear_rows("linear_attention_state", (k, v))
    b, n, h, d = k.shape
    kv = torch.empty((b, h, d, d), dtype=torch.float32, device=k.device)
    ksum = torch.empty((b, h, d), dtype=torch.float32, device=k.device)
    return kv, ksum, (k.data_ptr(), v.data_ptr(), kv.data_ptr(),
                      ksum.data_ptr(), b, n, h, d, *k.stride()[:3],
                      *v.stride()[:3], dtype_code(k))


def linear_attention_state(k: torch.Tensor, v: torch.Tensor):
    """K3s: ``(kv [B, H, D, D], ksum [B, H, D])``, fp32, of k/v ``[B, N,
    H, D]`` (the plain version on a CPU tensor); bf16 on the tensor cores,
    fp32 on the CUDA cores."""
    if k.device.type == "cpu":
        return linear_attention_state_ref(k, v)
    kv, ksum, args = _state_args(k, v)
    with torch.cuda.device(k.device):
        LINEAR_ATTENTION_STATE.launch(*args, stream_of(k))
    return kv, ksum


def _apply_args(q, kv, ksum, out, eps, round_kv):
    """Check q and the state for K3a; its C arguments up to the dtype
    code."""
    _check_cuda("linear_attention_apply", (q, out))
    b, n, h, d = q.shape
    if kv.shape != (b, h, d, d) or ksum.shape != (b, h, d) or \
            kv.dtype != torch.float32 or ksum.dtype != torch.float32 or \
            kv.device != q.device or ksum.device != q.device or \
            not kv.is_contiguous() or not ksum.is_contiguous():
        raise ValueError(f"linear_attention_apply takes an fp32 state "
                         f"[{b}, {h}, {d}, {d}] and key sum [{b}, {h}, {d}] "
                         f"on {q.device}, got {tuple(kv.shape)} {kv.dtype} "
                         f"and {tuple(ksum.shape)} {ksum.dtype}")
    _check_linear_rows("linear_attention_apply", (q, out))
    return (q.data_ptr(), kv.data_ptr(), ksum.data_ptr(), out.data_ptr(), b,
            n, h, d, *q.stride()[:3], *out.stride()[:3], float(eps),
            int(round_kv), dtype_code(q))


def linear_attention_apply(q: torch.Tensor, kv: torch.Tensor,
                           ksum: torch.Tensor, eps: float = 1e-15,
                           round_kv: bool = False) -> torch.Tensor:
    """K3a: ``relu(q) . kv / (relu(q) . ksum + eps)`` for q ``[B, N, H,
    D]`` and an fp32 state (the plain version on a CPU tensor); bf16 with
    ``round_kv`` on the tensor cores, otherwise on the CUDA cores."""
    if q.device.type == "cpu":
        return linear_attention_apply_ref(q, kv, ksum, eps, round_kv)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    args = _apply_args(q, kv.contiguous(), ksum.contiguous(), out, eps,
                       round_kv)
    with torch.cuda.device(q.device):
        LINEAR_ATTENTION_APPLY.launch(*args, stream_of(q))
    return out


def linear_attention_state_launch_info(k: torch.Tensor,
                                       v: torch.Tensor) -> dict:
    """The launch K3s makes for these CUDA tensors (without making it), as
    :func:`linear_attention_launch_info` gives K3's."""
    _, _, args = _state_args(k, v)
    return _info_of(LINEAR_ATTENTION_STATE, "yat_linear_attention_state_info",
                    args)


def linear_attention_apply_launch_info(q: torch.Tensor,
                                       round_kv: bool = False) -> dict:
    """The launch K3a makes for this CUDA q (without making it), as
    :func:`linear_attention_launch_info` gives K3's."""
    b, n, h, d = q.shape
    kv = torch.empty((b, h, d, d), dtype=torch.float32, device=q.device)
    ksum = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    return _info_of(LINEAR_ATTENTION_APPLY, "yat_linear_attention_apply_info",
                    _apply_args(q, kv, ksum, torch.empty_like(q), 1e-15,
                                round_kv))


def _info_of(kernel, symbol, args) -> dict:
    """K3's, K3s's or K3a's launch info: ``symbol`` takes the launch's C
    arguments with an info buffer in place of the stream."""
    buf = (ctypes.c_longlong * 6)()
    fn = kernel.function(symbol, kernel.argtypes[:-1] + [_P])
    err = fn(*args, ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"{kernel.name} launch info failed: CUDA error "
                           f"{err}")
    return {"path": "tensor cores" if buf[0] else "CUDA cores",
            "copy_bytes": buf[1], "registers": buf[2], "local_bytes": buf[3],
            "shared_bytes": buf[4], "blocks_per_sm": buf[5]}


class _LinearAttentionState(torch.autograd.Function):
    """K3s forward; the backward recomputes the plain state under
    autograd."""

    @staticmethod
    def forward(ctx, k, v):
        ctx.save_for_backward(k, v)
        return linear_attention_state(k, v)

    @staticmethod
    def backward(ctx, g_kv, g_ksum):
        k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            kv, ksum = linear_attention_state_ref(k, v)
            dk, dv = torch.autograd.grad((kv, ksum), (k, v), (g_kv, g_ksum))
        return dk, dv


class _LinearAttentionApply(torch.autograd.Function):
    """K3a forward; the backward recomputes the plain apply under
    autograd, with the same ``round_kv``."""

    @staticmethod
    def forward(ctx, q, kv, ksum, eps, round_kv):
        ctx.eps, ctx.round_kv = eps, round_kv
        ctx.save_for_backward(q, kv, ksum)
        return linear_attention_apply(q, kv, ksum, eps, round_kv)

    @staticmethod
    def backward(ctx, g):
        q, kv, ksum = (t.detach().requires_grad_()
                       for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = linear_attention_apply_ref(q, kv, ksum, ctx.eps,
                                             ctx.round_kv)
            dq, dkv, dksum = torch.autograd.grad(out.to(g.dtype),
                                                 (q, kv, ksum), g)
        return dq, dkv, dksum, None, None


def linear_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, group, eps: float = 1e-15,
                             implementation: str = "auto") -> torch.Tensor:
    """:func:`linear_attention` of a token slice: q/k/v ``[B, N/P, H, D]``
    hold this process's tokens of the ``P`` processes of ``group``.  The
    state of the slice (K3s), summed in fp32 over the group (its gradient
    summed back), then rounded as the JAX einsum branch rounds the whole
    state (``round_kv`` at the whole length ``N``), then the apply (K3a).
    A CUDA tensor launches K3s and K3a, never K3."""
    from yat_tpu_torch.parallel.tensor import all_reduce_sum
    import torch.distributed as dist
    if implementation not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown linear-attention implementation "
                         f"{implementation!r}; expected 'auto', 'xla', or "
                         "'pallas'")
    n = q.shape[1] * dist.get_world_size(group)
    round_kv = kv_rounding(n, q.shape[3], implementation)
    kv, ksum = _LinearAttentionState.apply(k, v)
    kv, ksum = all_reduce_sum(kv, group), all_reduce_sum(ksum, group)
    return _LinearAttentionApply.apply(q, kv, ksum, eps, round_kv)


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
