"""Fused adaLN LayerNorm: ``LayerNorm(x, affine-free) * (1 + scale) + shift``.

Counterpart of ``yat_tpu/ops/norm.py``.  :func:`adaln_layernorm` is a
``torch.autograd.Function``:

* on a CUDA tensor its forward launches kernel K1 (``csrc/adaln.cu``,
  replacing the TPU kernel ``yat_tpu/ops/norm.py:_fwd_kernel``) and its
  backward launches kernel K1b (``yat_adaln_bwd`` in the same source,
  replacing ``_bwd_kernel``);
* on a CPU tensor the same function runs :func:`adaln_ref` forward and
  :func:`adaln_bwd_ref` backward, the plain versions of the two kernels.

Numerics (the JAX package's norm dtype policy): fp32 mean and variance;
``mean`` and ``1/sqrt(var + eps)`` are rounded to the compute dtype before
the normalize-and-modulate chain, which then runs in the compute dtype.
The backward recomputes the statistics from ``x`` and keeps every
intermediate in fp32 (the residuals are ``x`` and ``scale`` only, as in the
JAX custom VJP).
"""

from __future__ import annotations

import ctypes

import torch

from yat_tpu_torch.kernels.build import CudaKernel, dtype_code, stream_of

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

ADALN = CudaKernel(
    "adaln_layernorm", "adaln.cu", "yat_adaln_fwd",
    [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _I, _P])
ADALN_BWD = CudaKernel(
    "adaln_layernorm_bwd", "adaln.cu", "yat_adaln_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I] + [_L] * 7 + [_F, _I, _P])


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The accumulation type of the plain versions: fp32, or the input's
    own type when that is wider (float64 for gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def adaln_ref(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Plain version; scale/shift are [B, D] in x's dtype (a copy of
    ``yat_tpu/ops/norm.py:_adaln_ref``)."""
    x32 = x.to(acc_dtype(x))
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return y * (1 + scale[:, None, :]) + shift[:, None, :]


def adaln_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-6):
    """Plain backward: the math of ``yat_tpu/ops/norm.py:_bwd_kernel``,
    fp32 throughout.  Returns ``dx`` in x's dtype and ``dscale``/``dshift``
    reduced over N in fp32, then cast to scale's dtype."""
    acc = acc_dtype(x)
    x32 = x.to(acc)
    g32 = g.to(acc)
    d = x.shape[-1]
    mean = x32.sum(-1, keepdim=True) / d
    xc = x32 - mean
    var = (xc * xc).sum(-1, keepdim=True) / d
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    dscale = (g32 * xhat).sum(1)
    dshift = g32.sum(1)
    dxh = g32 * (1.0 + scale.to(acc)[:, None, :])
    m1 = dxh.sum(-1, keepdim=True) / d
    m2 = (dxh * xhat).sum(-1, keepdim=True) / d
    dx = inv * (dxh - m1 - xhat * m2)
    return dx.to(x.dtype), dscale.to(scale.dtype), dshift.to(scale.dtype)


def _check_rows(x, mods):
    if x.ndim != 3:
        raise ValueError(f"adaln_layernorm takes x [B, N, D], got {tuple(x.shape)}")
    b, _, d = x.shape
    for name, t in (("x", x),) + mods:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if name != "x" and name != "g" and t.shape != (b, d):
            raise ValueError(f"{name} must be [B, D] = {(b, d)}, got "
                             f"{tuple(t.shape)}")
        if name == "g" and t.shape != x.shape:
            raise ValueError(f"g must have x's shape {tuple(x.shape)}")


def _adaln_args(x, scale, shift, out, eps):
    """K1's C arguments up to the dtype code (the stream, or the info
    buffer, follows)."""
    b, n, d = x.shape
    return (x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            b, n, d, x.stride(0), x.stride(1), scale.stride(0),
            shift.stride(0), out.stride(0), out.stride(1), float(eps),
            dtype_code(x))


def _adaln_cuda(x, scale, shift, eps):
    _check_rows(x, (("scale", scale), ("shift", shift)))
    b, n, d = x.shape
    out = torch.empty((b, n, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        ADALN.launch(*_adaln_args(x, scale, shift, out, eps), stream_of(x))
    return out


def adaln_launch_info(x: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor) -> dict:
    """The launch K1 makes for these CUDA tensors (scale/shift [B, D] or
    [B, 1, D]), without making it: its path (``"registers"``, the row held
    in registers at the width it is built for, else ``"generic"``),
    registers and local (spill) bytes a thread, shared bytes and blocks
    per SM."""
    scale = scale.reshape(scale.shape[0], scale.shape[-1])
    shift = shift.reshape(shift.shape[0], shift.shape[-1])
    _check_rows(x, (("scale", scale), ("shift", shift)))
    out = torch.empty_like(x)
    buf = (ctypes.c_longlong * 5)()
    fn = ADALN.function("yat_adaln_fwd_info", ADALN.argtypes[:-1] + [_P])
    err = fn(*_adaln_args(x, scale, shift, out, 1e-6), ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"adaln_layernorm launch info failed: CUDA error "
                           f"{err}")
    return {"path": "registers" if buf[0] else "generic",
            "registers": buf[1], "local_bytes": buf[2],
            "shared_bytes": buf[3], "blocks_per_sm": buf[4]}


def _adaln_bwd_cuda(x, scale, g, eps):
    g = g if g.stride(-1) == 1 else g.contiguous()
    _check_rows(x, (("scale", scale), ("g", g)))
    if g.dtype != x.dtype or scale.dtype != x.dtype:
        raise TypeError("adaln backward: x, scale and g must share a dtype")
    b, n, d = x.shape
    dx = torch.empty((b, n, d), dtype=x.dtype, device=x.device)
    dscale = torch.empty((b, d), dtype=scale.dtype, device=x.device)
    dshift = torch.empty((b, d), dtype=scale.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, dscale, dshift
    chunks = ADALN_BWD.function("yat_adaln_bwd_chunks", [_I], _I)(n)
    # per-chunk fp32 partial sums of dscale and dshift, reduced in a fixed
    # order by the entry point's second launch (deterministic)
    partial = torch.empty((2, b, chunks, d), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        ADALN_BWD.launch(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                         dx.data_ptr(), dscale.data_ptr(), dshift.data_ptr(),
                         partial.data_ptr(), b, n, d, x.stride(0),
                         x.stride(1), scale.stride(0), g.stride(0),
                         g.stride(1), dx.stride(0), dx.stride(1), float(eps),
                         dtype_code(x), stream_of(x))
    return dx, dscale, dshift


class _AdaLN(torch.autograd.Function):
    """K1 forward, K1b backward on CUDA; the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return adaln_ref(x, scale, shift, eps)
        return _adaln_cuda(x, scale, shift, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dsc, dsh = adaln_bwd_ref(x, scale, g, ctx.eps)
        else:
            dx, dsc, dsh = _adaln_bwd_cuda(x, scale, g, ctx.eps)
        return dx, dsc, dsh, None


def adaln_layernorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """x: [B, N, D] (compute dtype); scale/shift: [B, D] or [B, 1, D]
    (per-batch AdaLN modulation, broadcast over tokens).

    CUDA tensor: kernel K1 forward, K1b backward.  CPU tensor:
    :func:`adaln_ref` and :func:`adaln_bwd_ref`."""
    if scale.ndim == 3:
        scale = scale.reshape(scale.shape[0], scale.shape[-1])
    if shift.ndim == 3:
        shift = shift.reshape(shift.shape[0], shift.shape[-1])
    scale = scale.to(x.dtype)
    shift = shift.to(x.dtype)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"adaln_layernorm runs on cuda or cpu, got {x.device}")
    return _AdaLN.apply(x, scale, shift, eps)
