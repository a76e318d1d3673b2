"""Load a JAX-package parameter tree into the port's modules.

``load_flax_params(module, tree)`` takes the tree that the JAX package's
``Module.init`` returns under ``"params"``, as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables["params"])``), and copies every leaf
into the matching parameter of ``module``:

* a dense ``kernel`` ``[in, out]`` becomes ``weight`` ``[out, in]``;
* a conv ``kernel`` HWIO becomes ``weight`` OIHW (a depthwise or grouped
  conv's ``I`` is already ``in / groups``, as PyTorch's ``groups`` wants);
* an ``nn.Embed`` ``embedding`` becomes ``weight``, as it is;
* every other leaf (``bias``, norm ``scale``, modulation tables) keeps its
  name and shape.

Flax names a repeated submodule ``blocks_3``; where the port holds such
modules in an ``nn.ModuleList`` named ``blocks``, ``blocks_3`` resolves to
``blocks[3]``.  Every parameter of ``module`` must be covered by the tree
and every leaf of the tree must land, else it raises.

``load_flax_adapters(module, adapters, meta)`` does the same for the JAX
package's LoRA trees (``adapters``/``adapters_meta`` of its train state):
each ``{"lora_a", "lora_b"}`` leaf set is attached to the ``AdapterDense``
at its path, with its scale and dropout rate, and the base is frozen.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(.*)_(\d+)$")


def _child(mod: nn.Module, name: str, path: str) -> nn.Module:
    sub = getattr(mod, name, None)
    if isinstance(sub, nn.Module):
        return sub
    m = _INDEXED.match(name)
    if m is not None:
        seq = getattr(mod, m.group(1), None)
        if isinstance(seq, nn.ModuleList) and int(m.group(2)) < len(seq):
            return seq[int(m.group(2))]
    raise KeyError(f"{path}: no submodule {name!r} in "
                   f"{type(mod).__name__}")


def _torch_leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")
    if name == "embedding":
        return "weight", arr
    return name, arr


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy the flax parameter ``tree`` into ``module`` (in place; each
    parameter keeps its own dtype and device)."""
    loaded = set()

    def walk(mod: nn.Module, node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            path = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(_child(mod, key, path), val, path + "/")
                continue
            name, arr = _torch_leaf(key, np.asarray(val, dtype=np.float32))
            param = getattr(mod, name, None)
            if not isinstance(param, nn.Parameter):
                raise KeyError(f"{path}: {type(mod).__name__} has no "
                               f"parameter {name!r}")
            if tuple(param.shape) != arr.shape:
                raise ValueError(f"{path}: shape {arr.shape} does not fit "
                                 f"{name} {tuple(param.shape)}")
            with torch.no_grad():
                param.copy_(torch.from_numpy(np.array(arr)))
            loaded.add(id(param))

    walk(module, tree, "")
    missing = [n for n, p in module.named_parameters() if id(p) not in loaded]
    if missing:
        raise KeyError(f"parameters not in the tree: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")


def load_flax_adapters(module: nn.Module, adapters: Mapping,
                       meta: Mapping) -> int:
    """Attach the JAX package's LoRA leaves (nested dicts of numpy arrays,
    ``lora_a`` ``[in, r]``, ``lora_b`` ``[r, out]``) and their
    ``lora_scale``/``lora_dropout`` to the matching ``AdapterDense`` modules
    of ``module``, on its device, in fp32; freeze every other parameter.
    Returns the number of adapted modules."""
    from yat_tpu_torch.adapters.builder import freeze_base
    from yat_tpu_torch.models.layers import AdapterDense

    count = 0

    def walk(mod: nn.Module, node: Mapping, mnode: Mapping, prefix: str):
        nonlocal count
        if "lora_a" in node:
            if not isinstance(mod, AdapterDense):
                raise KeyError(f"{prefix}: LoRA leaves on a "
                               f"{type(mod).__name__}, not an AdapterDense")
            extra = set(node) - {"lora_a", "lora_b"}
            if extra:
                raise NotImplementedError(
                    f"{prefix}: adapter leaves {sorted(extra)} are not "
                    "ported (LoRA only)")
            dev = mod.weight.device
            mod.attach_lora(
                torch.tensor(np.asarray(node["lora_a"], np.float32), device=dev),
                torch.tensor(np.asarray(node["lora_b"], np.float32), device=dev),
                float(np.asarray(mnode["lora_scale"])),
                float(np.asarray(mnode.get("lora_dropout", 0.0))))
            count += 1
            return
        for key, val in node.items():
            path = f"{prefix}{key}"
            walk(_child(mod, key, path), val, mnode[key], path + "/")

    walk(module, adapters, meta, "")
    freeze_base(module)
    return count
