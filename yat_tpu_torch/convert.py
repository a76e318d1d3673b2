"""Load a JAX-package parameter tree into the port's modules.

``load_flax_params(module, tree)`` takes the tree that the JAX package's
``Module.init`` returns under ``"params"``, as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables["params"])``), and copies every leaf
into the matching parameter of ``module``:

* a dense ``kernel`` ``[in, out]`` becomes ``weight`` ``[out, in]``;
* a conv ``kernel`` HWIO becomes ``weight`` OIHW (a depthwise or grouped
  conv's ``I`` is already ``in / groups``, as PyTorch's ``groups`` wants);
* an ``nn.Embed`` ``embedding`` becomes ``weight``, as it is;
* an int8 or int4 dense ``kernel`` with its ``quant_scales`` leaf
  ``kernel_scale`` becomes the ``AdapterDense`` buffers ``qweight``
  ``[out, in]`` (int8) and ``weight_scale``;
* every other leaf keeps its name and shape: ``bias``, norm ``scale``
  (RMSNorm, LayerNorm, flax ``GroupNorm``'s ``scale`` and ``bias``), the
  ``(6, D)`` and ``(2, D)`` scale-shift tables, T5's
  ``relative_attention_bias``.

This covers the SANA, PixArt-Sigma, Gemma-2, T5, DC-AE and KL-VAE trees
(both VAE halves, encoder and decoder).  Flax names a repeated submodule ``blocks_3`` (``layers_3``); where
the port holds such modules in an ``nn.ModuleList`` named ``blocks``
(``layers``), ``blocks_3`` resolves to ``blocks[3]``; other indexed names
(``up_0_resnet_1``) are plain submodule names.  Every leaf of the tree
must land (an orphan raises), and every parameter of ``module`` must be
covered, except a ``bias``: a bias the tree lacks (a torch layer built with
``bias=False``) is set to zero, the value flax's initialiser gives it in
the JAX package, never left as the constructor made it.

``flax_params(module)`` is the inverse view: every parameter under its
flax path, as a tensor in the flax layout (``[in, out]`` kernels, HWIO
conv kernels), sharing the parameter's storage; ``flax_named_parameters``
names the parameters themselves by those paths (the trainable leaves of
full fine-tuning and the ``unfreeze_modules`` mask).  A caption encoder's or
VAE's converted checkpoint is merged against its paths
(``frontends/common.py``).

``load_flax_adapters(module, adapters, meta)`` does the same for the JAX
package's adapter trees (``adapters``/``adapters_meta`` of its train
state): each module's leaf set (LoRA, DoRA, LoHa, LoKr or FourierFT) is
attached to the ``AdapterDense`` at its path, with its meta, and the base
is frozen.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(.*)_(\d+)$")
# integer kernel dtypes of the JAX package's quantized base, by bits
_INT_BITS = {"int8": 8, "int4": 4}


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


def load_flax_params(module: nn.Module, tree: Mapping,
                     quant_scales: Optional[Mapping] = None,
                     keep: Tuple[str, ...] = ()) -> None:
    """Copy the flax parameter ``tree`` into ``module`` (in place; each
    parameter keeps its own dtype and device).  An int8 or int4 dense
    ``kernel`` (the JAX package's quantized base) becomes the module's
    int8 ``qweight`` ``[out, in]``, with its ``kernel_scale`` from the same
    path of ``quant_scales``.  A parameter the tree lacks under a module
    named in ``keep`` keeps its value (modules with no checkpoint
    counterpart)."""
    loaded = set()

    def walk(mod: nn.Module, node: Mapping, scales: Mapping,
             prefix: str) -> None:
        for key, val in node.items():
            path = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(_child(mod, key, path), val, scales.get(key, {}),
                     path + "/")
                continue
            raw = np.asarray(val)
            if key == "kernel" and raw.dtype.name in _INT_BITS:
                if "kernel_scale" not in scales:
                    raise KeyError(f"{path}: a quantized kernel without its "
                                   "kernel_scale in quant_scales")
                mod.set_quantized(
                    torch.from_numpy(raw.astype(np.int8).T.copy()),
                    torch.from_numpy(np.asarray(scales["kernel_scale"],
                                                np.float32)),
                    _INT_BITS[raw.dtype.name])
                continue
            name, arr = _torch_leaf(key, raw.astype(np.float32, copy=False))
            param = getattr(mod, name, None)
            if not isinstance(param, nn.Parameter):
                raise KeyError(f"{path}: {type(mod).__name__} has no "
                               f"parameter {name!r}")
            if tuple(param.shape) != arr.shape:
                raise ValueError(f"{path}: shape {arr.shape} does not fit "
                                 f"{name} {tuple(param.shape)}")
            with torch.no_grad():
                # a transposed view copies in torch's (threaded) copy
                param.copy_(torch.from_numpy(arr) if arr.flags.writeable
                            else torch.tensor(arr))
            loaded.add(id(param))

    walk(module, tree, quant_scales or {}, "")
    missing = [(n, p) for n, p in module.named_parameters()
               if id(p) not in loaded
               and not set(keep) & set(n.split("."))]
    # only a leaf named ``bias`` (not T5's ``relative_attention_bias``)
    hard = [n for n, _ in missing if n.rsplit(".", 1)[-1] != "bias"]
    if hard:
        raise KeyError(f"parameters not in the tree: {hard[:8]}"
                       f"{' ...' if len(hard) > 8 else ''}")
    with torch.no_grad():
        for _, p in missing:
            p.zero_()


def flax_module_path(name: str, lists) -> List[str]:
    """The flax path (a list of names) of the submodule at the dotted
    torch ``name``: an index into one of the ``nn.ModuleList`` names in
    ``lists`` joins its list's name (``blocks.3`` → ``blocks_3``)."""
    parts = name.split(".") if name else []
    path: List[str] = []
    for i, part in enumerate(parts):
        if part.isdigit() and ".".join(parts[:i]) in lists:
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    return path


def _flax_entries(module: nn.Module):
    """(dotted flax path, parameter, the parameter viewed in the flax
    layout) for every parameter of ``module``, in ``named_parameters``
    order."""
    from yat_tpu_torch.models.layers import Embed

    lists = {name for name, m in module.named_modules()
             if isinstance(m, nn.ModuleList)}
    for name, p in module.named_parameters():
        parts = name.split(".")
        path = flax_module_path(".".join(parts[:-1]), lists)
        owner = module.get_submodule(".".join(parts[:-1]))
        leaf, t = parts[-1], p.detach()
        if leaf == "weight":
            if isinstance(owner, (Embed, nn.Embedding)):
                leaf = "embedding"
            elif t.ndim == 2:
                leaf, t = "kernel", t.t()
            elif t.ndim == 4:
                leaf, t = "kernel", t.permute(2, 3, 1, 0)
        yield ".".join(path + [leaf]), p, t


def flax_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``{dotted flax path: parameter viewed in the flax layout}`` for every
    parameter of ``module`` (the inverse of :func:`load_flax_params`'s
    mapping); the views share the parameters' storage."""
    return {path: t for path, _, t in _flax_entries(module)}


def flax_named_parameters(module: nn.Module
                          ) -> List[Tuple[str, nn.Parameter]]:
    """``[(dotted flax path, parameter)]`` for every parameter of
    ``module``, in ``named_parameters`` order: the names of the JAX
    package's parameter tree for the port's own tensors."""
    return [(path, p) for path, p, _ in _flax_entries(module)]


def flax_shapes(module: nn.Module) -> Dict[str, Any]:
    """The nested tree of :func:`flax_params`' paths, each leaf a
    ``torch.Size`` (the model side of a coverage check)."""
    tree: Dict[str, Any] = {}
    for path, t in flax_params(module).items():
        *keys, leaf = path.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = t.shape
    return tree


def load_flax_adapters(module: nn.Module, adapters: Mapping,
                       meta: Mapping) -> int:
    """Attach the JAX package's adapter leaves (nested dicts of numpy
    arrays in the JAX layouts: LoRA ``lora_a`` ``[in, r]``/``lora_b``
    ``[r, out]`` with DoRA's ``dora_m``, LoHa's ``hada_*``, LoKr's
    ``lokr_*``, FourierFT's ``fft_spectrum``) and their meta
    (``lora_scale``/``lora_dropout``, ``scale``, ``fft_alpha`` and
    ``fft_indices``) to the matching ``AdapterDense`` modules of
    ``module``, on its device, in fp32; freeze every other parameter.  An
    unknown leaf raises.  Returns the number of adapted modules."""
    from yat_tpu_torch.adapters.builder import freeze_base
    from yat_tpu_torch.models.layers import ADAPTER_LEAVES, AdapterDense

    kinds = {frozenset(v): k for k, v in ADAPTER_LEAVES.items()}
    count = 0

    def walk(mod: nn.Module, node: Mapping, mnode: Mapping, prefix: str):
        nonlocal count
        if any(not isinstance(v, Mapping) for v in node.values()):
            if not isinstance(mod, AdapterDense):
                raise KeyError(f"{prefix}: adapter leaves on a "
                               f"{type(mod).__name__}, not an AdapterDense")
            kind = kinds.get(frozenset(node))
            if kind is None:
                raise KeyError(f"{prefix}: adapter leaves {sorted(node)} "
                               "are no adapter kind's "
                               f"({sorted(ADAPTER_LEAVES)})")
            dev = mod.base_device
            scale = mnode.get("lora_scale", mnode.get(
                "scale", mnode.get("fft_alpha")))
            indices = mnode.get("fft_indices")
            mod.attach_adapter(
                kind, {k: torch.tensor(np.asarray(v, np.float32), device=dev)
                       for k, v in node.items()},
                float(np.asarray(scale)),
                float(np.asarray(mnode.get("lora_dropout", 0.0))),
                None if indices is None else torch.tensor(
                    np.asarray(indices, np.int32), device=dev))
            count += 1
            return
        for key, val in node.items():
            path = f"{prefix}{key}"
            walk(_child(mod, key, path), val, mnode[key], path + "/")

    walk(module, adapters, meta, "")
    freeze_base(module)
    return count
