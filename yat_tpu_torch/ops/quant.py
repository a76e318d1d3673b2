"""Quantized base weights and the w8a8 matmul.

Counterpart of ``yat_tpu/ops/quant.py``: symmetric per-output-channel
quantization of the frozen base's dense weights (int8, or int4 packed two
values a byte), and :func:`w8a8_matmul`, the product of an activation
with an int8 weight on the int8 tensor cores.

The port keeps PyTorch's ``[out, in]`` weight, so a payload is ``[N, K]``
int8 with an fp32 scale ``[N]`` (the JAX package's ``kernel [in, out]``
transposed).  A 4-bit payload is held as :func:`pack_int4` packs it,
uint8 ``[N, ceil(K / 2)]`` (the JAX package stores ``jnp.int4``); its
values are unpacked (:func:`unpack_int4`) before every rescale.  :func:`quantize_params` quantizes only the weights of
:class:`~yat_tpu_torch.models.layers.AdapterDense` (the JAX leaves named
``kernel``) with at least ``min_size`` elements; the modulation tables,
embeddings, norms and convolutions stay in floating point, as there.

:func:`w8a8_matmul` runs through a ``torch.autograd.Function``.  Where
:func:`w8a8_branch` admits the shape (the gate ``_pallas_w8a8_ok`` of the
JAX package without its backend test; its device-count test is the
process count: a step over more than one process takes the dequantized
matmul, as the JAX step over more than one device does):

* on a CUDA tensor its forward launches kernel K5 (``csrc/w8a8_matmul.cu``,
  replacing the TPU kernel ``_i8_fwd_kernel``) and its backward kernel K5b
  (same source, replacing ``_i8_bwd_kernel``);
* on a CPU tensor it runs :func:`w8a8_matmul_ref` and
  :func:`w8a8_matmul_bwd_ref`, the plain versions of the two kernels.

Elsewhere it computes ``x @ dequant(q, s)`` in the compute dtype, the plain
matmul the JAX package takes outside Pallas.  The residuals are ``q`` and
the scale; ``x`` is never saved.

Rounding, as the JAX package computes it (its step is jitted, and XLA
rewrites a division by the constant 127 into a product with its fp32
reciprocal; the eager ``quantize_params`` divides):

* activation rows: ``scale = absmax * fp32(1/127)`` (1.0 for a zero row),
  ``x8 = clamp(round_half_even(x / scale), -127, 127)`` with an IEEE
  division;
* weights: ``scale = absmax / qmax`` with an IEEE division, then the same
  payload rule with ``qmax`` 127 or 7;
* the product: exact int32 sums, then ``((float)acc * x_scale) * w_scale``
  and one rounding to the output dtype.

The plain versions compute the integer sums exactly as float64 products of
the int8 values (|acc| < 2^31 < 2^53), so kernel and plain version agree
bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yat_tpu_torch.kernels.build import CudaKernel, dtype_code, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int

W8A8_MATMUL = CudaKernel("w8a8_matmul", "w8a8_matmul.cu", "yat_w8a8_fwd",
                         [_P] * 6 + [_I] * 4 + [_P])
W8A8_MATMUL_BWD = CudaKernel("w8a8_matmul_bwd", "w8a8_matmul.cu",
                             "yat_w8a8_bwd", [_P] * 6 + [_I] * 4 + [_P])

# fp32(1/127): XLA's rewrite of ``absmax / 127.0`` inside the jitted step
RECIP_127 = 1.0 / 127.0
# the kernels' largest K and N, and their tile
MAX_DIM = 6144
TILE = 128


def quantize_kernel(w: torch.Tensor, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantization of an ``[out, in]``
    weight: ``(q, scale)``, q int8 ``[out, in]`` holding -127..127 (8 bits)
    or -7..7 (4 bits), scale fp32 ``[out]``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w32 = w.float()
    absmax = w32.abs().amax(dim=1)
    qmax = float(2 ** (bits - 1) - 1)
    # a tensor divisor: a CUDA tensor divided by a Python number is
    # multiplied by its reciprocal, which rounds differently
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                        torch.ones_like(absmax))
    q = torch.round(w32 / scale[:, None]).clamp_(-qmax, qmax)
    return q.to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """4-bit values (an integer tensor holding -7..7) ``[..., n]`` packed
    two a byte along the last dimension: uint8 ``[..., ceil(n / 2)]``,
    value 2j in byte j's low nibble and 2j + 1 in its high nibble, each as
    a two's-complement nibble; an odd ``n`` leaves the last high nibble 0."""
    u = q.to(torch.uint8) & 0xF
    if q.shape[-1] % 2:
        u = F.pad(u, (0, 1))
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` values of a :func:`pack_int4` payload ``[..., m]``
    as int8 ``[..., n]`` (``n`` at most ``2 m``)."""
    nib = torch.stack([p & 0xF, p >> 4], -1).to(torch.int8)
    return ((nib ^ 8) - 8).flatten(-2)[..., :n]


_INT4_TABLES = {}


def dequantize_int4(p: torch.Tensor, scale: torch.Tensor, n: int,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`dequantize_kernel` of the first ``n`` values of a
    :func:`pack_int4` payload ``[out, m]``, bit for bit: each byte's two
    values looked up in a 256-entry fp32 table (four launches, where the
    nibble arithmetic of :func:`unpack_int4` takes ten)."""
    table = _INT4_TABLES.get(p.device)
    if table is None:
        table = _INT4_TABLES[p.device] = unpack_int4(
            torch.arange(256, dtype=torch.uint8)[:, None], 2).float().to(
                p.device)
    v = table.index_select(0, p.flatten().int()).view(p.shape[0], -1)
    return (v[:, :n] * scale[:, None].float()).to(dtype)


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """``(q * scale)`` in fp32, rounded once to ``dtype``: ``[out, in]``."""
    return (q.float() * scale[:, None].float()).to(dtype)


def quantize_params(module: nn.Module, bits: int = 8,
                    min_size: int = 4096) -> int:
    """Quantize, in place, the weight of every ``AdapterDense`` of
    ``module`` with at least ``min_size`` elements into an int8 (or packed
    4-bit) payload and fp32 scale (buffers); returns how many were
    quantized."""
    from yat_tpu_torch.models.layers import AdapterDense
    n = 0
    for m in module.modules():
        if isinstance(m, AdapterDense) and m.weight is not None \
                and m.weight.numel() >= min_size:
            m.quantize(bits)
            n += 1
    return n


def dequantize_params(module: nn.Module, dtype=torch.bfloat16) -> int:
    """Turn every quantized ``AdapterDense`` of ``module`` back into a
    floating weight of ``dtype`` (for export); returns how many."""
    from yat_tpu_torch.models.layers import AdapterDense
    n = 0
    for m in module.modules():
        if isinstance(m, AdapterDense) and m.qweight is not None:
            m.dequantize(dtype)
            n += 1
    return n


def w8a8_branch(t: int, k: int, n: int) -> bool:
    """The int8 kernels take ``[t, k] x [k -> n]`` when every dimension is
    a multiple of 128, k, n are at most 6144 and the run has one process
    (``_pallas_w8a8_ok``); the other shapes, and every step over more
    than one process, take the dequantized matmul."""
    from yat_tpu_torch.parallel.multihost import process_count
    return (t % TILE == 0 and k % TILE == 0 and n % TILE == 0
            and k <= MAX_DIM and n <= MAX_DIM and process_count() == 1)


def row_quantize(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantization of an fp32 ``[T, C]``:
    ``(x8 int8 [T, C], scale fp32 [T])``."""
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax * RECIP_127,
                        torch.ones_like(absmax))
    x8 = torch.round(x32 / scale[:, None]).clamp_(-127, 127)
    return x8.to(torch.int8), scale


def int8_product(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """``a8 @ b8`` of int8 matrices, exact, as fp32 (the kernels' int32
    sums, converted with one rounding)."""
    return (a8.double() @ b8.double()).float()


def w8a8_matmul_ref(x: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor,
                    quantized: bool = False):
    """Plain version of K5 on ``x [T, K]``, ``q [N, K]``, ``w_scale [N]``:
    ``y [T, N]`` in x's dtype, and with ``quantized`` also the row payload
    ``x8`` and scale."""
    x8, xs = row_quantize(x.float())
    y = ((int8_product(x8, q.t()) * xs[:, None]) * w_scale[None, :].float()
         ).to(x.dtype)
    return (y, x8, xs) if quantized else y


def w8a8_matmul_bwd_ref(g: torch.Tensor, q: torch.Tensor,
                        w_scale: torch.Tensor, quantized: bool = False):
    """Plain version of K5b on ``g [T, N]``: the straight-through ``dx
    [T, K]`` in g's dtype (``g * w_scale`` row-quantized over N, contracted
    with ``q`` over N, times the row scale), and with ``quantized`` also
    the payload ``g8`` and scale."""
    g8, gs = row_quantize(g.float() * w_scale[None, :].float())
    dx = (int8_product(g8, q) * gs[:, None]).to(g.dtype)
    return (dx, g8, gs) if quantized else dx


def _check(a, q, w_scale, name):
    if a.ndim != 2 or q.ndim != 2 or q.dtype != torch.int8:
        raise ValueError(f"{name} takes a [T, C] activation and an int8 "
                         f"[N, K] weight, got {tuple(a.shape)} and "
                         f"{tuple(q.shape)} {q.dtype}")
    for label, t in (("weight", q), ("scale", w_scale)):
        if t.device != a.device:
            raise ValueError(f"{name}: the {label} is on {t.device}, the "
                             f"activation on {a.device}")
    if w_scale.dtype != torch.float32 or w_scale.shape != (q.shape[0],):
        raise ValueError(f"{name}: the scale must be fp32 [{q.shape[0]}]")
    if not w8a8_branch(a.shape[0], q.shape[1], q.shape[0]):
        raise ValueError(f"{name}: [{a.shape[0]}, {q.shape[1]}] x "
                         f"[{q.shape[1]} -> {q.shape[0]}] is not a shape of "
                         "the int8 kernels (multiples of 128, K and N at "
                         f"most {MAX_DIM})")


def _check_aligned(name, **tensors):
    """The kernels read their inputs by TMA and 16-byte loads: every base
    pointer on a 16-byte boundary."""
    for label, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the {label} starts at "
                             f"{t.data_ptr():#x}, not on a 16-byte boundary")


def _w8a8_cuda(x, q, w_scale, quantized=False):
    """K5: quantize the rows of x, then the int8 GEMM with the fused
    epilogue (two launches of one entry point, one count)."""
    _check(x, q, w_scale, "w8a8_matmul")
    x, q = x.contiguous(), q.contiguous()
    _check_aligned("w8a8_matmul", activation=x, weight=q, scale=w_scale)
    t, k = x.shape
    n = q.shape[0]
    y = torch.empty((t, n), dtype=x.dtype, device=x.device)
    x8 = torch.empty((t, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((t,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        W8A8_MATMUL.launch(x.data_ptr(), q.data_ptr(), w_scale.data_ptr(),
                           y.data_ptr(), x8.data_ptr(), xs.data_ptr(), t, k,
                           n, dtype_code(x), stream_of(x))
    return (y, x8, xs) if quantized else y


def _w8a8_bwd_cuda(g, q, w_scale, quantized=False):
    """K5b: quantize the rows of g * w_scale, then the int8 GEMM over N
    with q's tiles transposed in shared memory."""
    g = g.contiguous()
    if g.ndim != 2 or g.shape[1] != q.shape[0]:
        raise ValueError(f"w8a8_matmul backward: g {tuple(g.shape)} does not "
                         f"fit the weight {tuple(q.shape)}")
    _check(g, q, w_scale, "w8a8_matmul backward")
    q = q.contiguous()
    _check_aligned("w8a8_matmul backward", gradient=g, weight=q,
                   scale=w_scale)
    t, n = g.shape
    k = q.shape[1]
    dx = torch.empty((t, k), dtype=g.dtype, device=g.device)
    g8 = torch.empty((t, n), dtype=torch.int8, device=g.device)
    gs = torch.empty((t,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        W8A8_MATMUL_BWD.launch(g.data_ptr(), q.data_ptr(), w_scale.data_ptr(),
                               dx.data_ptr(), g8.data_ptr(), gs.data_ptr(), t,
                               k, n, dtype_code(g), stream_of(g))
    return (dx, g8, gs) if quantized else dx


class _W8A8(torch.autograd.Function):
    """K5 forward, K5b backward on CUDA; the plain versions on the CPU.
    ``x`` is ``[T, K]`` on the kernels' shapes."""

    @staticmethod
    def forward(ctx, x, q, w_scale):
        ctx.save_for_backward(q, w_scale)
        if x.device.type == "cpu":
            return w8a8_matmul_ref(x, q, w_scale)
        return _w8a8_cuda(x, q, w_scale)

    @staticmethod
    def backward(ctx, g):
        q, w_scale = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (w8a8_matmul_bwd_ref(g, q, w_scale)
                  if g.device.type == "cpu"
                  else _w8a8_bwd_cuda(g, q, w_scale))
        # the scale is frozen by contract: a zero gradient, as in the JAX
        # package; the int8 payload has none
        dws = torch.zeros_like(w_scale) if ctx.needs_input_grad[2] else None
        return dx, None, dws


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q, w_scale)ᵀ`` with x ``[..., K]``, the int8 payload
    ``q [N, K]`` and its fp32 scale ``[N]``; ``[..., N]`` in x's dtype.

    Kernel shapes (:func:`w8a8_branch`): per-token dynamic int8
    quantization of x and an int8 x int8 -> int32 product, K5 forward and a
    straight-through K5b backward on CUDA, the plain versions on the CPU.
    Other shapes: the matmul with the weight dequantized to x's dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"w8a8_matmul runs on cuda or cpu, got {x.device}")
    n, k = q.shape
    lead = x.shape[:-1]
    t = math.prod(lead)
    if not w8a8_branch(t, k, n):
        return F.linear(x, dequantize_kernel(q, w_scale, x.dtype))
    y = _W8A8.apply(x.reshape(t, k), q, w_scale)
    return y.reshape(*lead, n)
