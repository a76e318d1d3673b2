"""Lion with 8-bit momentum (the optimizer of ``use_adamw_8bit``).

Counterpart of ``yat_tpu/ops/opt8bit.py``: the reference's
``use_adamw_8bit`` key instantiates bitsandbytes' Lion8bit, whose single
moment is stored as int8 with one fp32 absmax scale per block of 2048
values of the flattened leaf.  Plain tensor code, as in the JAX package
(which has no Pallas kernel here).

One update of a leaf ``p`` with gradient ``g`` and stored momentum ``m``:
``u = sign(b1·m + (1−b1)·g)`` (plus ``wd·p`` with weight decay), the update
is ``−u`` (Lion's own rate is 1.0; the schedule scales it after), and
``m' = b2·m + (1−b2)·g`` is stored again as int8.  The block scale is
``absmax · fp32(1/127)`` (1.0 for a zero block), as XLA computes the JAX
package's ``absmax / 127.0`` inside its jitted step.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from yat_tpu_torch.ops.quant import RECIP_127

BLOCK = 2048


def quantize_blockwise(x: torch.Tensor, block: int = BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flattened fp32 ``x``, zero-padded to whole blocks: ``(q int8
    [n_blocks * block], scale fp32 [n_blocks])``."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax * RECIP_127,
                        torch.ones_like(absmax))
    q = torch.round(blocks / scale[:, None]).clamp_(-127, 127)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape,
                         block: int = BLOCK) -> torch.Tensor:
    """The fp32 tensor of ``shape`` that :func:`quantize_blockwise`
    stored."""
    blocks = q.reshape(-1, block).float() * scale[:, None]
    return blocks.reshape(-1)[:math.prod(shape)].reshape(shape)


class Lion8bit:
    """Lion's update and int8 momentum for a fixed list of leaves."""

    def __init__(self, leaves: Sequence[torch.Tensor], b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 0.0,
                 block: int = BLOCK):
        self.b1, self.b2, self.weight_decay, self.block = (
            b1, b2, weight_decay, block)
        self.momentum: List[Tuple[torch.Tensor, torch.Tensor]] = [
            quantize_blockwise(torch.zeros_like(p, dtype=torch.float32),
                               block) for p in leaves]

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor],
                leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The updates ``−u`` (in each gradient's dtype) for ``grads``, and
        the momentum advanced to ``m'``."""
        out = []
        for i, (g, p) in enumerate(zip(grads, leaves)):
            m = dequantize_blockwise(*self.momentum[i], g.shape, self.block)
            g32 = g.float()
            u = torch.sign(self.b1 * m + (1.0 - self.b1) * g32)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            out.append((-1.0 * u).to(g.dtype))
            self.momentum[i] = quantize_blockwise(
                self.b2 * m + (1.0 - self.b2) * g32, self.block)
        return out
