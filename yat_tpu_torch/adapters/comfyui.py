"""Export SDXL LoRA adapters to ComfyUI/Kohya ``lora_unet_*`` naming.

Counterpart of ``yat_tpu/adapters/comfyui.py`` (numpy only; the files are
read and written by ``adapters/io.py``): the UNet's block coordinates are
remapped to LDM input/middle/output block indices, ``lora_a``/``lora_b``
become ``lora_down``/``lora_up`` in torch's ``[r, in]``/``[out, r]``
layout, and a per-module ``alpha`` tensor is added.

Input is an adapter tree over the SDXL UNet (``models/unet.py``; the
trainer's ``adapters.builder.adapter_tree``), whose module paths are
translated:

    down_{L}_attn_{J}.transformer_blocks_{T}.attn1.to_q
        → lora_unet_input_blocks_{1+3L+J}_1_transformer_blocks_{T}_attn1_to_q
    mid_attn.…      → lora_unet_middle_block_1_…
    up_{L}_attn_{J}.… → lora_unet_output_blocks_{3(maxL-L)+J}_1_…
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Tuple

import numpy as np

_DOWN = re.compile(r"^down_(\d+)_attn_(\d+)$")
_UP = re.compile(r"^up_(\d+)_attn_(\d+)$")
_DOWN_RES = re.compile(r"^down_(\d+)_resnet_(\d+)$")
_UP_RES = re.compile(r"^up_(\d+)_resnet_(\d+)$")
_MID_RES = re.compile(r"^mid_resnet_(\d+)$")
_DOWN_SAMPLE = re.compile(r"^down_(\d+)_downsample$")
_UP_SAMPLE = re.compile(r"^up_(\d+)_upsample$")
_LEAF_MAP = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v",
             "to_out": "to_out_0",
             # resnet / FF / conditioning leaves
             "time_emb_proj": "emb_layers_1",
             "conv1": "in_layers_2", "conv2": "out_layers_3",
             "conv_shortcut": "skip_connection",
             "proj": "net_0_proj", "out": "net_2"}


def _ldm_block_name(head: str, num_levels: int) -> str:
    m = _DOWN.match(head)
    if m:
        level, j = int(m.group(1)), int(m.group(2))
        return f"input_blocks_{1 + level * 3 + j}_1"
    if head == "mid_attn":
        return "middle_block_1"
    m = _UP.match(head)
    if m:
        level, j = int(m.group(1)), int(m.group(2))
        return f"output_blocks_{(num_levels - 1 - level) * 3 + j}_1"
    m = _DOWN_RES.match(head)
    if m:
        level, j = int(m.group(1)), int(m.group(2))
        return f"input_blocks_{1 + level * 3 + j}_0"
    m = _MID_RES.match(head)
    if m:
        return f"middle_block_{2 * int(m.group(1))}"
    m = _UP_RES.match(head)
    if m:
        level, j = int(m.group(1)), int(m.group(2))
        return f"output_blocks_{(num_levels - 1 - level) * 3 + j}_0"
    m = _DOWN_SAMPLE.match(head)
    if m:
        level = int(m.group(1))
        return f"input_blocks_{(level + 1) * 3}_0_op"
    m = _UP_SAMPLE.match(head)
    if m:
        level = int(m.group(1))
        u = num_levels - 1 - level
        return f"output_blocks_{u * 3 + 2}_2_conv"
    if head == "time_linear_1":
        return "time_embed_0"
    if head == "time_linear_2":
        return "time_embed_2"
    if head == "add_linear_1":
        return "label_emb_0_0"
    if head == "add_linear_2":
        return "label_emb_0_2"
    raise KeyError(f"unrecognised UNet block path head: {head}")


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def convert_sdxl_adapters_to_comfyui(
    adapters: Dict[str, Any],
    meta: Dict[str, Any],
    lora_alpha: float,
    num_levels: int = 3,
) -> Dict[str, np.ndarray]:
    """Adapter tree → flat ComfyUI tensor dict (save with safetensors)."""
    out: Dict[str, np.ndarray] = {}
    modules_seen = set()
    for path, leaf in _flatten(adapters):
        *module_path, leaf_name = path
        if leaf_name not in ("lora_a", "lora_b"):
            continue
        head = module_path[0]
        ldm = _ldm_block_name(head, num_levels)
        rest = [p if not p.startswith("transformer_blocks_") else
                p.replace("transformer_blocks_", "transformer_blocks_")
                for p in module_path[1:]]
        tail = "_".join(_LEAF_MAP.get(p, p) for p in rest)
        key_base = f"lora_unet_{ldm}" + (f"_{tail}" if tail else "")
        arr = np.asarray(leaf, np.float32)
        if leaf_name == "lora_a":
            # ours [in, r] → kohya lora_down [r, in]
            out[f"{key_base}.lora_down.weight"] = np.ascontiguousarray(arr.T)
        else:
            # ours [r, out] → kohya lora_up [out, r]
            out[f"{key_base}.lora_up.weight"] = np.ascontiguousarray(arr.T)
        if key_base not in modules_seen:
            out[f"{key_base}.alpha"] = np.asarray(lora_alpha, np.float32)
            modules_seen.add(key_base)
    return out


def export_comfyui_safetensors(path: str, adapters: Dict[str, Any],
                               meta: Dict[str, Any], lora_alpha: float,
                               num_levels: int = 3) -> None:
    from yat_tpu_torch.adapters.io import write_safetensors
    write_safetensors(path, convert_sdxl_adapters_to_comfyui(
        adapters, meta, lora_alpha, num_levels))


# ---------------------------------------------------------------------------
# The file-to-file CLI, on a saved adapter_model.safetensors
# ---------------------------------------------------------------------------

_EXPORT_KEY = re.compile(
    r"^base_model\.model\.(?P<module>.+)\.lora_(?P<ab>[AB])\.weight$")


def load_exported_adapter_file(path: str):
    """Read an ``adapter_model.safetensors`` written by either package's
    ``save_adapter_safetensors`` back into an adapter tree (lora_a
    ``[in, r]``, lora_b ``[r, out]``) plus the per-module scale map from
    the ``yat_meta`` header."""
    import json

    from yat_tpu_torch.adapters.io import read_safetensors

    tree: Dict[str, Any] = {}
    scales: Dict[str, float] = {}
    tensors, header = read_safetensors(path)
    if "yat_meta" in header:
        for k, v in json.loads(header["yat_meta"]).items():
            if k.endswith(".lora_scale"):
                scales[k[: -len(".lora_scale")]] = float(v)
    for key in sorted(tensors):
        m = _EXPORT_KEY.match(key)
        if m is None:
            continue
        arr = tensors[key]               # torch layout [out, in]-style
        leaf = "lora_a" if m.group("ab") == "A" else "lora_b"
        node = tree
        for part in m.group("module").split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(np.asarray(arr).T)
    if not tree:
        raise ValueError(
            f"{path} contains no 'base_model.model.*.lora_A/B.weight' keys "
            "— expected an adapter file exported by a trainer")
    return tree, scales


def _infer_num_levels(tree: Dict[str, Any]) -> int:
    levels = [int(m.group(1)) for head in tree
              for m in (_DOWN.match(head), _UP.match(head),
                        _DOWN_RES.match(head), _UP_RES.match(head))
              if m is not None]
    return max(levels) + 1 if levels else 3


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Convert an exported SDXL LoRA adapter safetensors to "
                    "ComfyUI/Kohya lora_unet_* naming")
    p.add_argument("input", help="adapter_model.safetensors (or its dir)")
    p.add_argument("output", help="output .safetensors path")
    p.add_argument("--alpha", type=float, default=None,
                   help="per-module alpha tensor value; default derives "
                        "alpha = lora_scale * rank from the file header")
    args = p.parse_args(argv)

    in_path = args.input
    if os.path.isdir(in_path):
        in_path = os.path.join(in_path, "adapter_model.safetensors")
    tree, scales = load_exported_adapter_file(in_path)

    alpha = args.alpha
    if alpha is None:
        # every module shares one (scale, rank) in the configs the
        # trainers write; derive alpha from the first adapted module
        first_mod, scale = next(iter(scales.items()), (None, None))
        if scale is None:
            raise SystemExit(
                "no yat_meta scale header in the file — pass --alpha")
        node = tree
        for part in first_mod.split("."):
            node = node[part]
        alpha = scale * node["lora_a"].shape[1]

    export_comfyui_safetensors(args.output, tree, {}, float(alpha),
                               num_levels=_infer_num_levels(tree))
    print(f"wrote {args.output} (alpha={alpha})")


if __name__ == "__main__":
    main()
