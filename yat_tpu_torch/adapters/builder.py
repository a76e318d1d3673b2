"""LoRA adapters on the port's ``AdapterDense`` modules.

Counterpart of the LoRA part of ``yat_tpu/adapters/builder.py``.  The JAX
package keeps adapters in a tree of their own that mirrors the parameter
tree; the port attaches them to the ``AdapterDense`` modules they adapt, as
parameters ``lora_a`` ``[in, r]`` and ``lora_b`` ``[r, out]`` (the JAX
orientation).  Modules are named by their flax path (``blocks_3.attn1.to_q``
for ``blocks[3].attn1.to_q``), so target matching, export names and the
carry-over of JAX adapters (``convert.load_flax_adapters``) agree with the
JAX package.

Initialisation as in PEFT and the JAX package: ``A ~ kaiming-uniform(a=√5)``
(bound ``1/√in``), ``B = 0``, scale ``α/r`` (``α/√r`` under rsLoRA).  The
other adapter kinds (DoRA, LoHa, LoKr, FourierFT) are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yat_tpu_torch.models.layers import AdapterDense

NOT_PORTED = ("is not implemented in the PyTorch port yet (ROADMAP queue 1, "
              "item 9: the remaining adapters)")


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    algo: str                       # only 'lora' is ported
    rank: int = 8
    alpha: float = 8.0
    dropout: float = 0.0
    target_modules: Sequence[str] = ()
    use_dora: bool = False
    use_rslora: bool = False

    @property
    def scale(self) -> float:
        if self.use_rslora:
            return self.alpha / math.sqrt(self.rank)
        return self.alpha / self.rank


def _matches(path: Tuple[str, ...], targets: Sequence[str]) -> bool:
    """PEFT-style matching: the module name equals a target, or the dotted
    path ends with '.' + target — plus an '_' + target suffix rule for the
    stream-prefixed flattened names the JAX models use (``x_to_q``), the
    flattened spelling of PEFT's '.' boundary (a copy of
    ``yat_tpu/adapters/builder.py:_matches``)."""
    if not targets:
        return False
    name = path[-1]
    dotted = ".".join(path)
    for t in targets:
        if name == t or dotted.endswith("." + t) or name.endswith("_" + t):
            return True
    return False


def _kaiming_uniform(gen: torch.Generator, shape: Tuple[int, int]
                     ) -> torch.Tensor:
    """``torch.nn.init.kaiming_uniform_(a=√5)`` on an (in, out) kernel:
    bound = √(6 / ((1 + a²)·fan_in)) = 1/√fan_in, fan_in = in."""
    bound = 1.0 / math.sqrt(shape[0])
    return torch.empty(shape, device=gen.device).uniform_(
        -bound, bound, generator=gen)


def module_paths(module: nn.Module, prefix: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[Tuple[str, ...], nn.Module]]:
    """Every submodule with its flax path, in definition order: the child
    ``i`` of an ``nn.ModuleList`` named ``blocks`` is ``blocks_i``."""
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            for i, sub in enumerate(child):
                path = prefix + (f"{name}_{i}",)
                yield path, sub
                yield from module_paths(sub, path)
        else:
            path = prefix + (name,)
            yield path, child
            yield from module_paths(child, path)


def adapted_modules(model: nn.Module
                    ) -> List[Tuple[Tuple[str, ...], AdapterDense]]:
    """The ``AdapterDense`` modules of ``model`` that carry LoRA."""
    return [(p, m) for p, m in module_paths(model)
            if isinstance(m, AdapterDense) and m.lora_a is not None]


def build_adapter_params(model: nn.Module, spec: AdapterSpec,
                         gen: torch.Generator,
                         merged: bool = True) -> int:
    """Attach LoRA to every ``AdapterDense`` whose flax path matches
    ``spec.target_modules`` (``lora_a`` uniform from ``gen``, on its device;
    ``lora_b`` zeros; both fp32), freeze every other parameter, and return
    the number of adapted modules.  ``merged`` selects the merged forward
    (the ``lora_fused_matmul`` key)."""
    if spec.algo != "lora":
        raise NotImplementedError(f"adapter algo {spec.algo!r} {NOT_PORTED}")
    if spec.use_dora:
        raise NotImplementedError(f"DoRA {NOT_PORTED}")
    dense = [(p, m) for p, m in module_paths(model)
             if isinstance(m, AdapterDense)]
    matched = 0
    for path, m in dense:
        if not _matches(path, spec.target_modules):
            continue
        d_in, d_out = m.in_features, m.features
        m.attach_lora(_kaiming_uniform(gen, (d_in, spec.rank)),
                      torch.zeros((spec.rank, d_out), device=gen.device),
                      spec.scale, spec.dropout)
        m.lora_merged = merged
        matched += 1
    if matched == 0:
        available = sorted({p[-1] for p, _ in dense})
        raise ValueError(
            f"target_modules {list(spec.target_modules)} matched nothing in "
            f"the base parameter tree; adaptable module names include: "
            f"{available[:24]}")
    freeze_base(model)
    return matched


def freeze_base(model: nn.Module) -> None:
    """Only the LoRA leaves train: every other parameter stops requiring
    a gradient."""
    lora = {id(m.lora_a) for _, m in adapted_modules(model)} | {
        id(m.lora_b) for _, m in adapted_modules(model)}
    for p in model.parameters():
        p.requires_grad_(id(p) in lora)


def lora_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """The trainable leaves in a fixed order, named
    ``{flax.path}.lora_a`` / ``.lora_b``."""
    out = []
    for path, m in adapted_modules(model):
        dotted = ".".join(path)
        out += [(f"{dotted}.lora_a", m.lora_a), (f"{dotted}.lora_b", m.lora_b)]
    return out


def count_adapter_params(model: nn.Module) -> int:
    return sum(p.numel() for _, p in lora_parameters(model))


def adapter_tree(model: nn.Module):
    """(adapters, meta) as the JAX package's nested dicts of numpy arrays:
    ``{"blocks_0": {"attn1": {"to_q": {"lora_a": ..., "lora_b": ...}}}}``
    and the matching ``lora_scale`` (and ``lora_dropout`` when active)."""
    adapters: Dict = {}
    meta: Dict = {}
    for path, m in adapted_modules(model):
        leaves = {"lora_a": m.lora_a.detach().float().cpu().numpy(),
                  "lora_b": m.lora_b.detach().float().cpu().numpy()}
        meta_leaves = {"lora_scale": np.float32(m.lora_scale)}
        if m.lora_dropout > 0.0:
            meta_leaves["lora_dropout"] = np.float32(m.lora_dropout)
        for tree, value in ((adapters, leaves), (meta, meta_leaves)):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = value
    return adapters, meta


def set_dropout_seed(model: nn.Module, seed: int) -> None:
    """Give every adapted module its own LoRA-dropout seed for this step
    (``seed + index``); a recomputation under remat draws the same masks."""
    for i, (_, m) in enumerate(adapted_modules(model)):
        m.dropout_seed = seed + i
