"""Adapters on the port's ``AdapterDense`` modules: LoRA, DoRA, LoHa,
LoKr and FourierFT.

Counterpart of ``yat_tpu/adapters/builder.py``.  The JAX package keeps
adapters in a tree of their own that mirrors the parameter tree
(``adapters`` for the trainable leaves, ``adapters_meta`` for the scales
and FourierFT's indices); the port attaches them to the ``AdapterDense``
modules they adapt, as parameters under the JAX leaf names
(``lora_a``, ``dora_m``, ``hada_w1_a``, ``lokr_w2_b``, ``fft_spectrum``,
...; ``models.layers.ADAPTER_LEAVES``), with FourierFT's ``fft_indices``
as an int32 buffer.  Modules are named by their flax path
(``blocks_3.attn1.to_q`` for ``blocks[3].attn1.to_q``), so target
matching, export names and the carry-over of JAX adapters
(``convert.load_flax_adapters``) agree with the JAX package.

Initialisation as in PEFT and the JAX package (the draws come from a
``torch.Generator``, so they differ from ``jax.random``'s):

* LoRA: ``A ~ kaiming-uniform(a=√5)`` (bound ``1/√in``), ``B = 0``, scale
  ``α/r`` (``α/√r`` under rsLoRA); DoRA adds ``m = ‖W‖_col``;
* LoHa: ``w1_a ~ normal(0.1)``, ``w1_b`` and ``w2_a`` kaiming, ``w2_b = 0``;
* LoKr: ``w1`` and ``w2_a`` kaiming, ``w2_b = 0`` over the LyCORIS
  factorization of each side (:func:`_factorize`);
* FourierFT: a zero spectrum at ``n_frequency`` distinct positions drawn
  from the generator, scale ``fourier_alpha``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yat_tpu_torch.models.layers import AdapterDense

# the meta leaf that holds each kind's scale in the JAX package's trees
_SCALE_LEAF = {"lora": "lora_scale", "dora": "lora_scale", "loha": "scale",
               "lokr": "scale", "fourierft": "fft_alpha"}


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    algo: str                       # 'lora' | 'loha' | 'lokr' | 'fourierft'
    rank: int = 8
    alpha: float = 8.0
    dropout: float = 0.0
    target_modules: Sequence[str] = ()
    use_dora: bool = False
    use_rslora: bool = False
    # fourierft
    n_frequency: int = 1000
    fourier_alpha: float = 0.01
    # lokr: factorization split heuristic
    lokr_factor: int = -1

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
    """The ``AdapterDense`` modules of ``model`` that carry an adapter."""
    return [(p, m) for p, m in module_paths(model)
            if isinstance(m, AdapterDense) and m.adapter_kind is not None]


def _factorize(n: int, factor: int = -1) -> Tuple[int, int]:
    """LyCORIS LoKr dimension factorization (a copy of the JAX package's):
    ``n = u * v`` with ``v`` the largest divisor ``<= √n`` (or ``factor``
    when it divides ``n``), returned as ``(u, v)``."""
    if factor > 0 and n % factor == 0:
        return n // factor, factor
    limit = int(math.sqrt(n))
    for v in range(limit, 0, -1):
        if n % v == 0:
            return n // v, v
    return n, 1


def _init_leaves(m: AdapterDense, spec: AdapterSpec, gen: torch.Generator):
    """(kind, leaves, scale, fft_indices) of ``spec`` for layer ``m``."""
    d_in, d_out, r = m.in_features, m.features, spec.rank
    dev = gen.device
    if spec.algo == "lora":
        leaves = {"lora_a": _kaiming_uniform(gen, (d_in, r)),
                  "lora_b": torch.zeros((r, d_out), device=dev)}
        if not spec.use_dora:
            return "lora", leaves, spec.scale, None
        with torch.no_grad():
            leaves["dora_m"] = torch.linalg.vector_norm(
                m.base_weight(torch.float32), dim=1).to(dev)
        return "dora", leaves, spec.scale, None
    if spec.algo == "loha":
        w1a = torch.empty((d_in, r), device=dev).normal_(generator=gen) * 0.1
        return "loha", {
            "hada_w1_a": w1a,
            "hada_w1_b": _kaiming_uniform(gen, (r, d_out)),
            "hada_w2_a": _kaiming_uniform(gen, (d_in, r)),
            "hada_w2_b": torch.zeros((r, d_out), device=dev)}, spec.scale, None
    if spec.algo == "lokr":
        u_in, v_in = _factorize(d_in, spec.lokr_factor)
        u_out, v_out = _factorize(d_out, spec.lokr_factor)
        # kron(w1 [u_in, u_out], w2 [v_in, v_out]) = [d_in, d_out]
        return "lokr", {
            "lokr_w1": _kaiming_uniform(gen, (u_in, u_out)),
            "lokr_w2_a": _kaiming_uniform(gen, (v_in, r)),
            "lokr_w2_b": torch.zeros((r, v_out), device=dev)}, \
            spec.scale, None
    n_freq = min(spec.n_frequency, d_in * d_out)
    flat = torch.randperm(d_in * d_out, generator=gen, device=dev)[:n_freq]
    indices = torch.stack([flat // d_out, flat % d_out]).to(torch.int32)
    return "fourierft", {"fft_spectrum": torch.zeros((n_freq,), device=dev)}, \
        spec.fourier_alpha, indices


def build_adapter_params(model: nn.Module, spec: AdapterSpec,
                         gen: torch.Generator,
                         merged: bool = True) -> int:
    """Attach ``spec``'s adapter to every ``AdapterDense`` whose flax path
    matches ``spec.target_modules`` (the leaves fp32, drawn from ``gen`` on
    its device, module by module in definition order), freeze every other
    parameter, and return the number of adapted modules.  ``merged``
    selects LoRA's merged forward (the ``lora_fused_matmul`` key)."""
    if spec.algo not in ("lora", "loha", "lokr", "fourierft"):
        raise ValueError(f"unknown adapter algo {spec.algo!r}")
    dense = [(p, m) for p, m in module_paths(model)
             if isinstance(m, AdapterDense)]
    matched = 0
    for path, m in dense:
        if not _matches(path, spec.target_modules):
            continue
        kind, leaves, scale, indices = _init_leaves(m, spec, gen)
        m.attach_adapter(kind, leaves, scale, spec.dropout, indices)
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
    """Only the adapter leaves train: every other parameter stops
    requiring a gradient."""
    leaves = {id(p) for _, p in adapter_parameters(model)}
    for p in model.parameters():
        p.requires_grad_(id(p) in leaves)


def adapter_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """The trainable adapter leaves in a fixed order, named
    ``{flax.path}.{leaf}`` (``blocks_0.attn1.to_q.lokr_w1``)."""
    out = []
    for path, m in adapted_modules(model):
        dotted = ".".join(path)
        out += [(f"{dotted}.{n}", p) for n, p in m.adapter_leaves()]
    return out


def count_adapter_params(model: nn.Module) -> int:
    return sum(p.numel() for _, p in adapter_parameters(model))


def _set_path(tree: Dict, path: Sequence[str], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def adapter_tree(model: nn.Module):
    """(adapters, meta) as the JAX package's nested dicts of numpy arrays:
    ``{"blocks_0": {"attn1": {"to_q": {"lora_a": ..., "lora_b": ...}}}}``
    and the matching meta (``lora_scale`` and ``lora_dropout`` when
    active; ``scale``; ``fft_alpha`` and ``fft_indices``)."""
    adapters: Dict = {}
    meta: Dict = {}
    for path, m in adapted_modules(model):
        leaves = {n: p.detach().float().cpu().numpy()
                  for n, p in m.adapter_leaves()}
        meta_leaves = {_SCALE_LEAF[m.adapter_kind]: np.float32(m.lora_scale)}
        if m.lora_dropout > 0.0:
            meta_leaves["lora_dropout"] = np.float32(m.lora_dropout)
        if m.fft_indices is not None:
            meta_leaves["fft_indices"] = m.fft_indices.cpu().numpy()
        _set_path(adapters, path, leaves)
        _set_path(meta, path, meta_leaves)
    return adapters, meta


def load_pretrained_adapters(model: nn.Module, path: str) -> None:
    """The leaves of the adapters attached to ``model`` from the adapter
    file at ``path`` (``adapters.io.load_adapter_safetensors``: the export
    of either package, bare flax paths or a real PEFT file), in place;
    every leaf must be in the file.  FourierFT's indices stay as built
    (a file does not carry them)."""
    from yat_tpu_torch.adapters.io import load_adapter_safetensors
    tree = load_adapter_safetensors(path, like=adapter_tree(model)[0])
    with torch.no_grad():
        for mpath, m in adapted_modules(model):
            node = tree
            for k in mpath:
                node = node[k]
            for name, p in m.adapter_leaves():
                p.copy_(torch.as_tensor(node[name]))


def _delta_for(leaves: Dict[str, torch.Tensor], meta: Dict,
               kernel: torch.Tensor) -> torch.Tensor:
    """The fp32 delta ``[in, out]`` of one module's adapter over its fp32
    ``kernel`` ``[in, out]`` (``yat_tpu/adapters/builder.py:_delta_for``)."""
    if "lora_a" in leaves:
        delta = (leaves["lora_a"] @ leaves["lora_b"]) * meta["lora_scale"]
        if "dora_m" in leaves:
            merged = kernel + delta
            col = torch.linalg.vector_norm(merged, dim=0, keepdim=True)
            return leaves["dora_m"][None, :] * merged / (col + 1e-8) - kernel
        return delta
    if "hada_w1_a" in leaves:
        return meta["scale"] * (
            (leaves["hada_w1_a"] @ leaves["hada_w1_b"])
            * (leaves["hada_w2_a"] @ leaves["hada_w2_b"]))
    if "lokr_w1" in leaves:
        w2 = leaves["lokr_w2_a"] @ leaves["lokr_w2_b"]
        return meta["scale"] * torch.kron(leaves["lokr_w1"], w2)
    if "fft_spectrum" in leaves:
        idx = meta["fft_indices"].long()
        dense = torch.zeros(kernel.shape, dtype=torch.float32,
                            device=kernel.device)
        dense[idx[0], idx[1]] = leaves["fft_spectrum"]
        return meta["fft_alpha"] * torch.fft.ifft2(dense, norm="ortho").real
    raise ValueError(f"unrecognised adapter leaves: {list(leaves)}")


@torch.no_grad()
def merge_adapters(model: nn.Module) -> int:
    """Fold every adapter's delta into its module's base weight, in fp32
    (``W + Δ`` cast back to the weight's dtype, as the JAX package's
    ``merge_adapters`` does), and detach the adapters; returns how many
    were merged.  A quantized base raises."""
    n = 0
    for path, m in adapted_modules(model):
        if m.weight is None:
            raise ValueError(f"{'.'.join(path)}: a quantized base has no "
                             "floating weight to merge into")
        leaves = {k: p.detach().float() for k, p in m.adapter_leaves()}
        meta = {_SCALE_LEAF[m.adapter_kind]: m.lora_scale,
                "fft_indices": m.fft_indices}
        kernel = m.weight.detach().float().t()
        merged = kernel + _delta_for(leaves, meta, kernel)
        m.weight.copy_(merged.t().to(m.weight.dtype))
        m.detach_adapter()
        n += 1
    return n


def set_dropout_seed(model: nn.Module, seed: int) -> None:
    """Give every adapted module its own LoRA-dropout seed for this step
    (``seed + index``); a recomputation under remat draws the same masks."""
    for i, (_, m) in enumerate(adapted_modules(model)):
        m.dropout_seed = seed + i
