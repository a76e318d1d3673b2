"""Shared building blocks of the SANA and PixArt-Sigma denoisers and the
text encoders.

Counterpart of the SANA/PixArt/Gemma/T5 subset of
``yat_tpu/models/layers.py``.
Modules keep the JAX package's parameter names (``kernel`` becomes
``weight`` in PyTorch's ``[out, in]`` orientation; see ``convert.py``),
its ``[B, N, D]`` token and NHWC latent layouts, and its dtype policy:
parameters are stored as given (fp32 by default), and each module casts
them to its compute ``dtype`` at use; norm statistics accumulate in fp32
while data stays in the compute dtype.

Parameters are created uninitialised; :func:`init_params` fills them the
way flax's initialisers do (or ``convert.load_flax_params`` loads them).
Adapters (LoRA, DoRA, LoHa, LoKr, FourierFT) ride on :class:`AdapterDense`
as parameters of their own (``adapters/builder.py`` attaches them); the
modules that the JAX package
calls with ``deterministic`` take it too, and pass it to their dense layers
(it gates LoRA dropout).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yat_tpu_torch.ops.attention import (dot_product_attention,
                                         flash_attention, linear_attention,
                                         linear_attention_sharded)
from yat_tpu_torch.ops.quant import (
    dequantize_kernel,
    quantize_kernel,
    w8a8_matmul,
)
from yat_tpu_torch.parallel.tensor import (
    all_reduce_sum,
    contiguous_chunk,
    copy_to_group,
    depthwise_conv3x3_sharded,
    gather_along,
    pair,
    reduce_from_group,
)

# flax's truncated-normal variance scaling divides by this so the kept
# samples have the requested standard deviation
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _round_scalar(v: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype`` (the JAX ``scale.astype(dtype)``)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


class _LoraMerged(torch.autograd.Function):
    """``y = x @ (W + s·A@B)`` with the chain backward of
    ``yat_tpu/models/layers.py:_lora_merged_matmul``: ``dA = s·xᵀ(g·Bᵀ)``
    and ``dB = s·(x·A)ᵀ·g``; no full ``dW_eff`` is formed.  The residuals
    are the raw leaves and the backward merges again.  ``w`` is the torch
    ``[out, in]`` weight, ``a`` is ``[in, r]`` and ``b`` is ``[r, out]``,
    all in the compute dtype; ``s`` is a float."""

    @staticmethod
    def forward(ctx, x, w, a, b, s):
        ctx.s = s
        ctx.save_for_backward(x, w, a, b)
        return F.linear(x, w + s * (a @ b).t())

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        s = ctx.s
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g @ (w + s * (a @ b).t())) if ctx.needs_input_grad[0] else None
        dw = (g2.t() @ x2) if ctx.needs_input_grad[1] else None
        da = s * (x2.t() @ (g2 @ b.t())) if ctx.needs_input_grad[2] else None
        db = s * ((x2 @ a).t() @ g2) if ctx.needs_input_grad[3] else None
        return dx, dw, da, db, None


# the trainable leaves of each adapter kind, in the JAX package's leaf
# names (``yat_tpu/models/layers.py:AdapterDense``)
ADAPTER_LEAVES = {
    "lora": ("lora_a", "lora_b"),
    "dora": ("lora_a", "lora_b", "dora_m"),
    "loha": ("hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b"),
    "lokr": ("lokr_w1", "lokr_w2_a", "lokr_w2_b"),
    "fourierft": ("fft_spectrum",),
}
_ALL_LEAVES = tuple(dict.fromkeys(
    n for leaves in ADAPTER_LEAVES.values() for n in leaves))


def adapter_delta(kind: str, leaves, scale: float, w: torch.Tensor,
                  dtype: torch.dtype, fft_indices=None, tp=None
                  ) -> torch.Tensor:
    """The merged weight ``W'`` ``[out, in]`` of a non-LoRA adapter kind
    over the base weight ``w`` (``[out, in]`` in ``dtype``), with the JAX
    package's cast order: LoHa's and LoKr's deltas are formed in ``dtype``;
    DoRA merges in ``dtype``, takes the column norm in fp32 and casts back;
    FourierFT builds its dense grid and ``ifft2(norm="ortho").real`` in
    fp32, then casts.  ``scale`` is the float scale (``scale``,
    ``lora_scale`` or ``fft_alpha``), already gated.

    Under ``tp`` (a ``parallel.tensor.TPShard``) ``w`` is this process's
    slice and so is the result: the deltas are sliced alike, and a
    row-parallel DoRA layer sums its columns' squares over ``tp``."""
    s = _round_scalar(scale, dtype)
    if kind == "dora":
        a, b, m = leaves
        if tp is not None and tp.role == "col":
            b, m = tp.take(b, 1), tp.take(m, 0)
        elif tp is not None:
            a = tp.take(a, 0)
        merged = w + s * (a.to(dtype) @ b.to(dtype)).t()
        m32 = merged.float()
        if tp is not None and tp.role == "row":
            norm = all_reduce_sum(m32.square().sum(1, keepdim=True),
                                  tp.group).sqrt()
        else:
            norm = torch.linalg.vector_norm(m32, dim=1, keepdim=True)
        return (m.float()[:, None] * m32 / (norm + 1e-8)).to(dtype)
    if kind == "loha":
        w1a, w1b, w2a, w2b = (t.to(dtype) for t in leaves)
        delta = (w1a @ w1b) * (w2a @ w2b)
    elif kind == "lokr":
        w1, w2a, w2b = (t.to(dtype) for t in leaves)
        delta = torch.kron(w1, w2a @ w2b)
    elif kind == "fourierft":
        (spectrum,) = leaves
        d_out, d_in = w.shape
        if tp is not None and tp.role == "col":
            d_out = tp.full
        elif tp is not None:
            d_in = tp.full
        dense = torch.zeros((d_in, d_out), dtype=torch.float32,
                            device=spectrum.device).index_put(
            (fft_indices[0].long(), fft_indices[1].long()),
            spectrum.float())
        delta = torch.fft.ifft2(dense, norm="ortho").real.to(dtype)
    else:
        raise ValueError(f"no merged form for adapter kind {kind!r}")
    delta = delta.t()
    if tp is not None:
        delta = tp.take(delta, 0 if tp.role == "col" else 1)
    return w + s * delta


class AdapterDense(nn.Module):
    """Dense layer ``y = x @ W + b`` in the compute dtype, with an optional
    adapter and an optional quantized base (counterpart of
    ``yat_tpu/models/layers.py:AdapterDense``).  ``dtype=None`` computes in
    the input's dtype.

    :meth:`attach_adapter` adds the trainable leaves of one adapter kind as
    parameters, in the JAX package's names and orientations
    (``ADAPTER_LEAVES``): LoRA ``lora_a`` ``[in, r]``, ``lora_b``
    ``[r, out]``; DoRA adds the magnitude ``dora_m`` ``[out]``; LoHa
    ``hada_w1_a``/``hada_w2_a`` ``[in, r]``, ``hada_w1_b``/``hada_w2_b``
    ``[r, out]``; LoKr ``lokr_w1`` ``[u_in, u_out]``, ``lokr_w2_a``
    ``[v_in, r]``, ``lokr_w2_b`` ``[r, v_out]``; FourierFT
    ``fft_spectrum`` ``[n]`` with its ``fft_indices`` ``[2, n]`` (an int32
    buffer: meta, never trained).  ``lora_scale`` holds the kind's float
    scale (the JAX meta leaf ``lora_scale``, ``scale`` or ``fft_alpha``),
    rounded to the compute dtype at use.

    LoRA takes the merged form ``x @ (W + s·A@B)`` (:class:`_LoraMerged`)
    when ``lora_merged`` is set (the ``lora_fused_matmul`` key), else the
    chain form ``x@W + s·((x@A)@B)``; with LoRA dropout active
    (``deterministic`` false, a rate above 0 and a ``dropout_seed``) it
    always takes the chain form, dropping inputs of the adapter branch
    only.  The mask comes from a ``torch.Generator`` seeded with
    ``dropout_seed``, so a recomputation under remat draws the same mask.
    DoRA, LoHa, LoKr and FourierFT multiply by their merged weight
    (:func:`adapter_delta`); DoRA has no dropout (the JAX branch ignores
    the rate).

    :meth:`quantize` replaces ``weight`` with the buffers ``qweight`` (an
    int8 ``[out, in]`` payload, -127..127 or, at 4 bits, -7..7) and
    ``weight_scale`` (fp32 ``[out]``).  The base product is then
    ``ops.quant.w8a8_matmul`` when ``w8a8`` is set (the trainer sets it from
    ``int8_w8a8``) and the payload has 8 bits, and LoRA takes the chain form
    on top of it, as in the JAX package (a merged ``W + s·A@B`` would need
    the weight in the compute dtype); every other kind, and every other
    base, uses the weight dequantized to the compute dtype,
    ``(q * s).to(dtype)``.

    Two switches turn the adapter off, with the JAX package's two
    meanings.  ``lora_gate`` is the per-step gate of refiner timestep
    gating (:func:`set_adapter_gate`; the counterpart of
    ``gate_adapter_meta``, which multiplies the adapter's scale by a 0/1
    gate): a gate multiplies the scale, and at 0 the branch of every kind
    but DoRA is skipped (its output is the base's exactly); a DoRA layer at
    0 computes ``m · W / ‖W‖``.  ``adapter_off`` (:func:`adapters_off`)
    drops the adapter whatever its kind: the preservation term's base,
    which the JAX package applies without its adapter trees."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.in_features, self.features = in_features, features
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.register_buffer("qweight", None)
        self.register_buffer("weight_scale", None)
        self.register_buffer("fft_indices", None)
        self.bits: Optional[int] = None
        self.w8a8 = False
        self.adapter_kind: Optional[str] = None
        for name in _ALL_LEAVES:
            setattr(self, name, None)
        self.lora_scale = 1.0
        self.lora_dropout = 0.0
        self.lora_merged = True
        self.dropout_seed: Optional[int] = None
        self.lora_gate: Optional[float] = None
        self.adapter_off = False
        # the tensor-parallel split (parallel.tensor.TPShard), or None
        self.tp = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.weight is not None:
            _lecun_normal_(self.weight.data, self.in_features, gen)
        if self.bias is not None:
            self.bias.data.zero_()

    def quantize(self, bits: int = 8) -> None:
        """Quantize the floating weight per output channel into the
        ``qweight``/``weight_scale`` buffers; the weight is dropped."""
        q, s = quantize_kernel(self.weight.detach(), bits)
        self.set_quantized(q, s, bits)

    def set_quantized(self, q: torch.Tensor, scale: torch.Tensor,
                      bits: int) -> None:
        """Hold ``q`` (int8 ``[out, in]``) and ``scale`` (fp32 ``[out]``)
        as the base, in place of the floating weight."""
        if tuple(q.shape) != (self.features, self.in_features) \
                or tuple(scale.shape) != (self.features,):
            raise ValueError(f"quantized base {tuple(q.shape)} / "
                             f"{tuple(scale.shape)} does not fit a "
                             f"[{self.in_features} -> {self.features}] layer")
        device = self.weight.device if self.weight is not None else q.device
        self.weight = None
        self.qweight = q.to(device, torch.int8)
        self.weight_scale = scale.to(device, torch.float32)
        self.bits = int(bits)

    def dequantize(self, dtype=torch.float32) -> None:
        """Back to a floating weight of ``dtype`` (for export)."""
        w = dequantize_kernel(self.qweight, self.weight_scale, dtype)
        self.qweight = self.weight_scale = self.bits = None
        self.weight = nn.Parameter(w, requires_grad=False)

    @property
    def base_device(self) -> torch.device:
        return (self.weight if self.weight is not None else self.qweight).device

    def base_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The base weight ``[out, in]`` in ``dtype`` (dequantized when the
        base is quantized)."""
        if self.qweight is None:
            return self.weight.to(dtype)
        return dequantize_kernel(self.qweight, self.weight_scale, dtype)

    def adapter_leaves(self) -> List[Tuple[str, nn.Parameter]]:
        """The trainable leaves of the attached adapter, by leaf name, in
        ``ADAPTER_LEAVES`` order (none without an adapter)."""
        if self.adapter_kind is None:
            return []
        return [(n, getattr(self, n)) for n in
                ADAPTER_LEAVES[self.adapter_kind]]

    def attach_adapter(self, kind: str, leaves: Dict[str, torch.Tensor],
                       scale: float, dropout: float = 0.0,
                       fft_indices: Optional[torch.Tensor] = None) -> None:
        """Add (or replace) the leaves of adapter ``kind`` (a key of
        ``ADAPTER_LEAVES``; shapes checked against the layer); they train,
        the base does not.  ``fft_indices`` (``[2, n]``) goes with
        FourierFT."""
        if kind not in ADAPTER_LEAVES:
            raise ValueError(f"unknown adapter kind {kind!r}")
        names = ADAPTER_LEAVES[kind]
        if set(leaves) != set(names):
            raise ValueError(f"{kind} takes the leaves {list(names)}, got "
                             f"{sorted(leaves)}")
        d_in, d_out = self.in_features, self.features
        shapes = {n: tuple(t.shape) for n, t in leaves.items()}
        if kind in ("lora", "dora"):
            a, b = shapes["lora_a"], shapes["lora_b"]
            ok = a[0] == d_in and b[1] == d_out and a[1] == b[0]
            ok = ok and shapes.get("dora_m", (d_out,)) == (d_out,)
        elif kind == "loha":
            r = shapes["hada_w1_a"][1]
            ok = (shapes["hada_w1_a"] == shapes["hada_w2_a"] == (d_in, r)
                  and shapes["hada_w1_b"] == shapes["hada_w2_b"] == (r, d_out))
        elif kind == "lokr":
            (u_in, u_out), (v_in, r) = shapes["lokr_w1"], shapes["lokr_w2_a"]
            ok = (u_in * v_in == d_in and shapes["lokr_w2_b"][0] == r
                  and u_out * shapes["lokr_w2_b"][1] == d_out)
        else:
            n = shapes["fft_spectrum"]
            ok = (fft_indices is not None and len(n) == 1
                  and tuple(fft_indices.shape) == (2, n[0]))
        if not ok:
            raise ValueError(f"{kind} leaves {shapes} do not fit a "
                             f"[{d_in} -> {d_out}] layer")
        self.detach_adapter()
        for name in names:
            setattr(self, name, nn.Parameter(leaves[name]))
        self.fft_indices = (fft_indices.to(torch.int32)
                            if kind == "fourierft" else None)
        self.adapter_kind = kind
        self.lora_scale = float(scale)
        # DoRA keeps the rate as meta (the JAX tree has it) and ignores it
        self.lora_dropout = (float(dropout) if kind in ("lora", "dora")
                             else 0.0)

    def detach_adapter(self) -> None:
        """Drop the adapter: the layer is its base alone again."""
        for name in _ALL_LEAVES:
            setattr(self, name, None)
        self.fft_indices = None
        self.adapter_kind = None

    def attach_lora(self, lora_a: torch.Tensor, lora_b: torch.Tensor,
                    scale: float, dropout: float = 0.0) -> None:
        """:meth:`attach_adapter` for plain LoRA."""
        self.attach_adapter("lora", {"lora_a": lora_a, "lora_b": lora_b},
                            scale, dropout)

    def tp_sliced_leaves(self) -> List[Tuple[str, int]]:
        """(name, torch dimension) of the frozen leaves that ``tp`` slices
        (the base weight or its quantized payload and, column-parallel,
        the per-output-channel scales and a frozen bias)."""
        tp = self.tp
        col = tp.role == "col"
        out = []
        if self.weight is not None and not self.weight.requires_grad:
            out.append(("weight", 0 if col else 1))
        if self.qweight is not None:
            out.append(("qweight", 0 if col else 1))
            if col:
                out.append(("weight_scale", 0))
        if col and self.bias is not None and not self.bias.requires_grad:
            out.append(("bias", 0))
        return out

    def shard_tp_base(self) -> None:
        """Keep only this process's ``tp`` slice of the frozen leaves
        (named in ``tp.sliced``; a trainable leaf stays whole and is sliced
        at use)."""
        self.tp.sliced = {name for name, _ in self.tp_sliced_leaves()}
        for name, dim in self.tp_sliced_leaves():
            part = self.tp.take(getattr(self, name).detach(), dim).contiguous()
            if name in self._parameters:
                self._parameters[name] = nn.Parameter(part,
                                                      requires_grad=False)
            else:
                self._buffers[name] = part

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        tp = self.tp
        col = tp is not None and tp.role == "col"
        if tp is not None and (col or tp.lone):
            # a whole input: its gradient is summed over tp; a lone
            # row-parallel layer takes its slice of it
            x = copy_to_group(x, tp.group)
            if not col:
                x = tp.take(x, -1)
        kind = None if self.adapter_off else self.adapter_kind
        gate = 1.0 if self.lora_gate is None else self.lora_gate
        if gate == 0.0 and kind != "dora":
            kind = None
        # None: the int8 base multiplies through w8a8_matmul (K5/K5b); only
        # the base alone and chain LoRA take it
        w8a8 = self.w8a8 and self.bits == 8 and kind in (None, "lora")
        w = None if w8a8 else self.base_weight(dtype)
        if tp is not None and w is not None and not (
                {"weight", "qweight"} & tp.sliced):
            w = tp.take(w, 0 if col else 1)

        def base(t):
            if w is None:
                return w8a8_matmul(t, self.qweight, self.weight_scale)
            return F.linear(t, w)
        if kind is None:
            y = base(x)
        elif kind == "lora":
            a = self.lora_a.to(dtype)
            b = self.lora_b.to(dtype)
            if col:
                b = tp.take(b, 1)
            elif tp is not None:
                a = tp.take(a, 0)
            s = _round_scalar(self.lora_scale * gate, dtype)
            dropout = (self.lora_dropout > 0.0 and not deterministic
                       and self.dropout_seed is not None)
            if self.lora_merged and not dropout and w is not None:
                y = _LoraMerged.apply(x, w, a, b, s)
            else:
                xa = x
                if dropout:
                    keep_p = 1.0 - self.lora_dropout
                    gen = torch.Generator(device=x.device).manual_seed(
                        self.dropout_seed)
                    # the mask of the whole input, then this slice's
                    keep = torch.rand((*x.shape[:-1], self.in_features),
                                      generator=gen, device=x.device) < keep_p
                    if tp is not None and not col:
                        keep = tp.take(keep, -1)
                    xa = torch.where(keep, x / _round_scalar(keep_p, dtype),
                                     torch.zeros_like(x))
                y = base(x) + s * ((xa @ a) @ b)
        else:
            y = F.linear(x, adapter_delta(
                kind, [p for _, p in self.adapter_leaves()],
                self.lora_scale * gate, w, dtype, self.fft_indices, tp))
        if tp is not None and not col:
            y = reduce_from_group(y, tp.group)
        if self.bias is not None:
            y = y + (tp.take(self.bias, 0) if col and "bias" not in tp.sliced
                     else self.bias).to(dtype)
        if col and tp.lone:
            y = gather_along(y, -1, tp.group)
        return y


class ZeroDense(AdapterDense):
    """A dense layer whose random initialisation is zero (flax
    ``zeros_init``), as the JAX package's modulation layers are (the
    MMDiT's and Flux's)."""

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.data.zero_()
        if self.bias is not None:
            self.bias.data.zero_()


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NHWC tensors ('SAME' padding for odd kernels, or
    ``padding=(lo, hi)`` on both spatial dims as flax's explicit
    ``((lo, hi), (lo, hi))``; ``stride`` on both): the input is viewed as
    NCHW only around the convolution.  Weight ``[O, I/groups, kh, kw]``;
    inputs and parameters cast to ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 groups: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, stride: int = 1,
                 padding: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dtype = dtype
        self.groups = groups
        self.stride = stride
        self.pad = padding
        self.padding = kernel // 2 if padding is None else 0
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        _lecun_normal_(self.weight.data, i * kh * kw, gen)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor,
                channels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``channels`` (a depthwise conv only): the input holds these
        channels alone, and their filters run."""
        weight, bias, groups = self.weight, self.bias, self.groups
        if channels is not None:
            weight = weight.index_select(0, channels.to(weight.device))
            if bias is not None:
                bias = bias.index_select(0, channels.to(bias.device))
            groups = len(channels)
        bias = bias.to(self.dtype) if bias is not None else None
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.pad is not None:
            lo, hi = self.pad
            x = F.pad(x, (lo, hi, lo, hi))
        y = F.conv2d(x, weight.to(self.dtype), bias,
                     stride=self.stride, padding=self.padding,
                     groups=groups)
        return y.permute(0, 2, 3, 1)


class Embed(nn.Module):
    """flax ``nn.Embed``: table ``[num, features]``, rows cast to ``dtype``."""

    def __init__(self, num: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.weight.data, 0.0,
                        self.weight.shape[1] ** -0.5, generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        y = F.embedding(ids, self.weight)
        return y.to(self.dtype) if self.dtype is not None else y


def _pair_elementwise(first: "AdapterDense", second: "AdapterDense",
                      size: int, rank: int) -> None:
    """Pair two dense layers with only elementwise work between them
    (``first``'s output is ``second``'s input), when both are split."""
    if first.features % size == 0:
        pair(first, second, contiguous_chunk(first.features, size, rank))


class CaptionProjection(nn.Module):
    """linear_1 → gelu(tanh) → linear_2 (diffusers
    PixArtAlphaTextProjection layout)."""

    def __init__(self, in_features: int, hidden_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear_1 = AdapterDense(in_features, hidden_dim, dtype=dtype)
        self.linear_2 = AdapterDense(hidden_dim, hidden_dim, dtype=dtype)

    def tensor_parallel(self, size: int, rank: int) -> None:
        _pair_elementwise(self.linear_1, self.linear_2, size, rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(x), approximate="tanh"))


class RMSNorm(nn.Module):
    """RMS norm: statistics in fp32, data in the input dtype."""

    def __init__(self, dim: int, epsilon: float = 1e-6, use_scale: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.dim = dim
        self.scale = nn.Parameter(torch.empty(dim)) if use_scale else None
        # inside a tensor-parallel pair (a TPShard): the norm of this
        # process's heads; over the whole inner dim (rms_norm_across_heads)
        # its sum of squares is summed over tp
        self.tp_local = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.scale is not None:
            self.scale.data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        tp = self.tp_local
        scale = self.scale
        if tp is not None and self.dim == tp.full:
            # across heads: x holds this process's heads
            var = all_reduce_sum((x32 * x32).sum(-1, keepdim=True),
                                 tp.group) / self.dim
            scale = tp.take(scale, 0) if scale is not None else None
        else:
            var = (x32 * x32).mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + self.epsilon).to(x.dtype)
        if scale is not None:
            y = y * scale.to(x.dtype)
        return y


class GroupNorm(nn.Module):
    """GroupNorm on NHWC tensors with the norm dtype policy of
    ``yat_tpu/models/layers.py:GroupNorm`` (the UNet's): the statistics of
    each (batch, group) in fp32, the mean subtracted in fp32 (two passes,
    not ``E[x^2] - E[x]^2``), the normalised data rounded to the input's
    dtype before the affine, which runs in that dtype.  The VAEs keep flax
    ``nn.GroupNorm`` (``models/vae.py``)."""

    def __init__(self, channels: int, num_groups: int = 32,
                 epsilon: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by groups "
                             f"{num_groups}")
        self.num_groups, self.epsilon = num_groups, epsilon
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        x32 = x.float().reshape(b, -1, g, c // g)
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((x32 - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        return (y.reshape(x.shape) * self.scale.to(x.dtype)
                + self.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm: statistics in fp32, data in the input dtype; optionally
    affine-free."""

    def __init__(self, dim: int, epsilon: float = 1e-6, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.empty(dim)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.scale is not None:
            self.scale.data.fill_(1.0)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + self.epsilon)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        if self.scale is not None:
            y = y * self.scale.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int,
                                  max_period: float = 10000.0,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0
                                  ) -> torch.Tensor:
    """Sinusoidal embedding of (possibly fractional) timesteps, fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedder(nn.Module):
    """MLP(swish) over the sinusoidal embedding → conditioning vector."""

    def __init__(self, hidden_dim: int, freq_dim: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.freq_dim = freq_dim
        self.linear_1 = AdapterDense(freq_dim, hidden_dim, dtype=dtype)
        self.linear_2 = AdapterDense(hidden_dim, hidden_dim, dtype=dtype)

    def tensor_parallel(self, size: int, rank: int) -> None:
        _pair_elementwise(self.linear_1, self.linear_2, size, rank)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_timestep_embedding(timesteps, self.freq_dim)
        return self.linear_2(F.silu(self.linear_1(emb)))


_QK_NORMS = (None, "rms", "rms_norm", "rms_norm_across_heads")


def _check_qk_norm(qk_norm):
    if qk_norm not in _QK_NORMS:
        raise ValueError(f"unsupported qk_norm {qk_norm!r}; expected None, "
                         "'rms'/'rms_norm', or 'rms_norm_across_heads'")


def _qk_norm_modules(qk_norm, num_heads, head_dim):
    """diffusers qk-norm variants (eps 1e-5): per-head RMS over head_dim
    ('rms'/'rms_norm', after the head split) or over the full inner dim
    ('rms_norm_across_heads', before it)."""
    _check_qk_norm(qk_norm)
    if qk_norm is None:
        return None, None
    dim = head_dim if qk_norm in ("rms", "rms_norm") else num_heads * head_dim
    return RMSNorm(dim, epsilon=1e-5), RMSNorm(dim, epsilon=1e-5)


def pair_joint_heads(cols, rows, norms, num_heads: int, head_dim: int,
                     size: int, rank: int) -> bool:
    """Put the q/k/v layers ``cols`` and the output layers ``rows`` of one
    (joint) attention on this process's heads, the same heads in every
    stream, when all of them are split and ``size`` divides the heads; the
    per-head ``norms`` then see these heads only (their scales' gradients
    become parts).  False, changing nothing, otherwise."""
    if num_heads % size or any(getattr(m, "tp", None) is None
                               or m.tp.role != "col" for m in cols) or any(
            getattr(m, "tp", None) is None or m.tp.role != "row"
            for m in rows):
        return False
    idx = contiguous_chunk(num_heads * head_dim, size, rank)
    for m in list(cols) + list(rows):
        m.tp.idx, m.tp.lone = idx, False
    for norm in norms:
        norm.tp_local = cols[0].tp
    return True


def _pair_heads(module, cols, row, num_heads: int, head_dim: int,
                size: int, rank: int) -> None:
    """:func:`pair_joint_heads` for one attention module (``module``'s
    ``norm_q``/``norm_k``), which then computes its local heads."""
    norms = [n for n in (getattr(module, "norm_q", None),
                         getattr(module, "norm_k", None)) if n is not None]
    if pair_joint_heads(cols, [row], norms, num_heads, head_dim, size, rank):
        module.local_heads = num_heads // size


class Attention(nn.Module):
    """Multi-head softmax attention (self or cross) with fp32 softmax,
    through ``ops.attention.dot_product_attention`` (kernels K2, K4 or K6
    on CUDA, by shape).

    ``forward(..., return_kv=True)`` returns the final (post-norm,
    head-split) K/V of the context; ``cached_kv`` replaces their
    computation (the per-request caption K/V cache of sampling);
    ``perturbed=True`` is the identity attention map of perturbed-attention
    guidance: each query takes its own position's V.  Built with
    ``flash=True`` it calls ``ops.attention.flash_attention`` (K6/K6b)
    directly, without the gate, at any length and without a mask
    (PixelDiT's pixel-stage self-attention)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 out_features: Optional[int] = None,
                 qk_norm: Optional[str] = None, use_bias: bool = True,
                 out_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 context_dim: Optional[int] = None, flash: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim, self.qk_norm = num_heads, head_dim, qk_norm
        self.flash = flash
        kv_dim = context_dim or query_dim
        self.to_q = AdapterDense(query_dim, inner, use_bias, dtype)
        self.to_k = AdapterDense(kv_dim, inner, use_bias, dtype)
        self.to_v = AdapterDense(kv_dim, inner, use_bias, dtype)
        self.norm_q, self.norm_k = _qk_norm_modules(qk_norm, num_heads, head_dim)
        self.to_out = AdapterDense(inner, out_features or query_dim, out_bias,
                                   dtype)
        # the heads this process computes (fewer under a tp pair)
        self.local_heads = num_heads

    def tensor_parallel(self, size: int, rank: int) -> None:
        _pair_heads(self, (self.to_q, self.to_k, self.to_v), self.to_out,
                    self.num_heads, self.head_dim, size, rank)

    def project_kv(self, context: torch.Tensor, deterministic: bool = True):
        k = self.to_k(context, deterministic)
        v = self.to_v(context, deterministic)
        if self.qk_norm == "rms_norm_across_heads":
            k = self.norm_k(k)
        b, nk = k.shape[0], k.shape[1]
        k = k.reshape(b, nk, self.local_heads, self.head_dim)
        v = v.reshape(b, nk, self.local_heads, self.head_dim)
        if self.qk_norm in ("rms", "rms_norm"):
            k = self.norm_k(k)
        return k, v

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, *,
                cached_kv: Optional[tuple] = None, return_kv: bool = False,
                perturbed: bool = False, deterministic: bool = True,
                sp=None):
        """``sp`` (a ``parallel.tensor.SequenceParallel``; token-sharded
        ``x``): this process's queries, against the keys and values of
        every process's tokens in self-attention.  A slice of the queries
        or of the heads takes the kernel branch of the whole attention."""
        if cached_kv is not None and not return_kv:
            k, v = cached_kv
        else:
            k, v = self.project_kv(x if context is None else context,
                                   deterministic)
            if sp is not None and context is None and not perturbed:
                k, v = sp.gather_kv(k), sp.gather_kv(v)
        if return_kv:
            return k, v
        b, nq = x.shape[0], x.shape[1]
        if perturbed:
            # the query goes unused (the JAX package computes and drops it)
            y = v
        else:
            q = self.to_q(x, deterministic)
            if self.qk_norm == "rms_norm_across_heads":
                q = self.norm_q(q)
            q = q.reshape(b, nq, self.local_heads, self.head_dim)
            if self.qk_norm in ("rms", "rms_norm"):
                q = self.norm_q(q)
            if self.flash:
                if mask is not None:
                    raise ValueError("flash attention is called without a "
                                     "mask")
                y = flash_attention(q, k, v)
            else:
                whole = None
                if sp is not None or self.local_heads != self.num_heads:
                    whole = (nq * (sp.size if sp is not None else 1),
                             self.num_heads)
                y = dot_product_attention(q, k, v, mask=mask, whole=whole)
        return self.to_out(y.reshape(b, nq, self.local_heads * self.head_dim),
                           deterministic)


class LiteLinearAttention(nn.Module):
    """SANA's ReLU linear attention (LiteMLA), O(N) in sequence length,
    through ``ops.attention.linear_attention`` (kernel K3 on CUDA)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 dtype: Optional[torch.dtype] = None, eps: float = 1e-15,
                 qk_norm: Optional[str] = None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.eps, self.qk_norm = eps, qk_norm
        self.to_q = AdapterDense(dim, inner, False, dtype)
        self.to_k = AdapterDense(dim, inner, False, dtype)
        self.to_v = AdapterDense(dim, inner, False, dtype)
        self.norm_q, self.norm_k = _qk_norm_modules(qk_norm, num_heads, head_dim)
        self.to_out = AdapterDense(inner, dim, True, dtype)
        self.local_heads = num_heads

    def tensor_parallel(self, size: int, rank: int) -> None:
        _pair_heads(self, (self.to_q, self.to_k, self.to_v), self.to_out,
                    self.num_heads, self.head_dim, size, rank)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                sp=None) -> torch.Tensor:
        """``sp`` (token-sharded ``x``): the state summed over the ``sp``
        group between K3s and K3a."""
        b, n, _ = x.shape
        q, k, v = (self.to_q(x, deterministic), self.to_k(x, deterministic),
                   self.to_v(x, deterministic))
        if self.qk_norm == "rms_norm_across_heads":
            q, k = self.norm_q(q), self.norm_k(k)
        shape = (b, n, self.local_heads, self.head_dim)
        q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
        if self.qk_norm in ("rms", "rms_norm"):
            q, k = self.norm_q(q), self.norm_k(k)
        if sp is not None:
            y = linear_attention_sharded(q, k, v, sp.group, eps=self.eps)
        else:
            y = linear_attention(q, k, v, eps=self.eps)
        return self.to_out(y.to(x.dtype).reshape(
            b, n, self.local_heads * self.head_dim), deterministic)


class GLUMBConv(nn.Module):
    """SANA's gated conv FFN over the 2D token grid: 1x1 expand → 3x3
    depthwise → GLU gate → 1x1 project."""

    def __init__(self, dim: int, expand_ratio: float = 2.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = int(dim * expand_ratio)
        self.hidden = hidden
        self.conv_inverted = AdapterDense(dim, hidden * 2, True, dtype)
        self.conv_depth = Conv2d(hidden * 2, hidden * 2, 3, groups=hidden * 2,
                                 dtype=dtype or torch.float32)
        self.conv_point = AdapterDense(hidden, dim, False, dtype)
        # the hidden channels this process computes (fewer under a tp
        # pair) and their indices into [y | gate]
        self.local_hidden = hidden
        self.channels: Optional[torch.Tensor] = None

    def tensor_parallel(self, size: int, rank: int) -> None:
        """A pair on matching ranges of ``y`` and ``gate``: a contiguous
        split of ``conv_inverted``'s ``[y | gate]`` output would give one
        process all of ``y`` and the other all of ``gate``."""
        if self.hidden % size:
            return
        part = contiguous_chunk(self.hidden, size, rank)
        both = torch.cat([part, self.hidden + part])
        if pair(self.conv_inverted, self.conv_point, both, part):
            self.local_hidden = self.hidden // size
            self.channels = both
            self.conv_depth.tp_local = both

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                deterministic: bool = True, sp=None) -> torch.Tensor:
        """``sp`` (token-sharded ``x``): the depthwise conv takes its
        neighbours' tokens (``parallel.tensor.depthwise_conv3x3_sharded``)."""
        b, n, _ = x.shape
        c = 2 * self.local_hidden
        y = F.silu(self.conv_inverted(x, deterministic))
        if sp is not None:
            conv = self.conv_depth
            weight, bias = conv.weight, conv.bias
            if self.channels is not None:
                weight = weight.index_select(0, self.channels.to(x.device))
                bias = (bias.index_select(0, self.channels.to(x.device))
                        if bias is not None else None)
            y = depthwise_conv3x3_sharded(
                y.to(conv.dtype), weight.to(conv.dtype),
                bias.to(conv.dtype) if bias is not None else None, hw, sp)
            y = y.reshape(b, n, c)
        else:
            y = self.conv_depth(y.reshape(b, hw[0], hw[1], c), self.channels)
        y, gate = y.chunk(2, dim=-1)
        y = y * F.silu(gate)
        return self.conv_point(y.reshape(b, n, self.local_hidden),
                               deterministic)


_ACTIVATIONS = {
    "gelu_tanh": lambda y: F.gelu(y, approximate="tanh"),
    "silu": F.silu,
    "gelu": lambda y: F.gelu(y, approximate="none"),
}


class MLP(nn.Module):
    """Transformer FFN: fc1 → activation (``gelu_tanh``, ``silu`` or exact
    ``gelu``) → fc2, as in PixArt and DiT."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 activation: str = "gelu_tanh",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(activation)
        hidden = int(dim * mlp_ratio)
        self.activation = activation
        self.fc1 = AdapterDense(dim, hidden, dtype=dtype)
        self.fc2 = AdapterDense(hidden, dim, dtype=dtype)

    def tensor_parallel(self, size: int, rank: int) -> None:
        _pair_elementwise(self.fc1, self.fc2, size, rank)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        y = _ACTIVATIONS[self.activation](self.fc1(x, deterministic))
        return self.fc2(y, deterministic)


class PatchEmbed(nn.Module):
    """[B, H, W, C] latents → [B, N, D] tokens via non-overlapping patches."""

    def __init__(self, in_channels: int, hidden_dim: int, patch_size: int = 1,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = AdapterDense(patch_size * patch_size * in_channels,
                                 hidden_dim, use_bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch_size
        if p > 1:
            x = x.reshape(b, h // p, p, w // p, p, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                                    p * p * c)
        else:
            x = x.reshape(b, h * w, c)
        return self.proj(x)


def unpatchify(tokens: torch.Tensor, hw: Tuple[int, int], patch_size: int,
               out_channels: int) -> torch.Tensor:
    """[B, N, p*p*C] → [B, H, W, C]."""
    b = tokens.shape[0]
    h, w = hw
    p = patch_size
    x = tokens.reshape(b, h // p, w // p, p, p, out_channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, out_channels)


def set_adapter_gate(module: nn.Module, gate: Optional[float]) -> None:
    """Gate the adapter of every :class:`AdapterDense` in ``module``: the
    gate multiplies the adapter's scale (0.0 drops every kind's branch but
    DoRA's, whose layer then computes ``m · W / ‖W‖``), None clears it.
    The sampler sets it for each step of a refiner-gated ladder and clears
    it afterwards."""
    for m in module.modules():
        if isinstance(m, AdapterDense):
            m.lora_gate = gate


@contextlib.contextmanager
def adapters_off(module: nn.Module):
    """Every :class:`AdapterDense` of ``module`` computes without its
    adapter inside the block, whatever its kind (the preservation term's
    base)."""
    dense = [m for m in module.modules() if isinstance(m, AdapterDense)]
    for m in dense:
        m.adapter_off = True
    try:
        yield module
    finally:
        for m in dense:
            m.adapter_off = False


def init_params(module: nn.Module, gen: torch.Generator) -> None:
    """Fill every parameter of ``module`` the way flax initialises it:
    lecun-normal (truncated) dense and conv kernels, zero biases, unit norm
    scales, normal(D^-0.5) embedding and modulation tables.  ``gen`` lives
    on the parameters' device, so a model built there never touches the
    host."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
