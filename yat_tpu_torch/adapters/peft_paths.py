"""Module-path translation between our flax trees and torch/diffusers
naming, for PEFT adapter interop.

A copy of ``yat_tpu/adapters/peft_paths.py`` (framework-free); for SANA
and PixArt-Sigma files the ``blocks_N`` and ``ff.fc1``/``ff.fc2`` rules
are the ones that apply.

A real PEFT ``adapter_model.safetensors`` names modules with torch paths
(``base_model.model.down_blocks.0.attentions.0.transformer_blocks.0.attn1
.to_q.lora_A.weight``); our trees use the flax naming
(``down_0_attn_0.transformer_blocks_0.attn1.to_q``).  The reference resumes
adapters straight from PEFT checkpoints (common/trainer.py:239-240), so
import must accept both — round-1 only accepted our own naming.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

_DOWN_ATTN = re.compile(r"^down_(\d+)_attn_(\d+)$")
_UP_ATTN = re.compile(r"^up_(\d+)_attn_(\d+)$")
_DOWN_RES = re.compile(r"^down_(\d+)_resnet_(\d+)$")
_UP_RES = re.compile(r"^up_(\d+)_resnet_(\d+)$")
_MID_RES = re.compile(r"^mid_resnet_(\d+)$")
_TBLOCK = re.compile(r"^transformer_blocks_(\d+)$")
_BLOCK = re.compile(r"^blocks_(\d+)$")
_DOWN_SAMPLE = re.compile(r"^down_(\d+)_downsample$")
_UP_SAMPLE = re.compile(r"^up_(\d+)_upsample$")

# inner leaf-module renames (flax → diffusers)
_INNER = {
    "to_out": "to_out.0",
    "ff.proj": "ff.net.0.proj",        # UNet BasicTransformerBlock FF
    "ff.out": "ff.net.2",
    "ff.fc1": "ff.net.0.proj",         # DiT-family FF
    "ff.fc2": "ff.net.2",
}

_TOP = {
    "time_linear_1": "time_embedding.linear_1",
    "time_linear_2": "time_embedding.linear_2",
    "add_linear_1": "add_embedding.linear_1",
    "add_linear_2": "add_embedding.linear_2",
    "time_proj": "adaln_single.linear",
    "caption_projection": "caption_projection.linear_1",
    "conv_norm_out": "conv_norm_out",
}


def num_levels_from_tree(module_paths: Sequence[Sequence[str]]) -> int:
    """Highest UNet level mentioned in the tree + 1 (for up-index flips)."""
    levels = [-1]
    for path in module_paths:
        for part in path:
            for pat in (_DOWN_ATTN, _UP_ATTN, _DOWN_RES, _UP_RES):
                m = pat.match(part)
                if m:
                    levels.append(int(m.group(1)))
    return max(levels) + 1


def flax_to_diffusers(module_path: Sequence[str],
                      num_levels: int) -> Optional[str]:
    """Our dotted module path → the diffusers torch module path, or None
    when the head is not a recognised structural name (DiT caption/time
    heads etc. fall back to identity handling by the caller)."""
    parts = list(module_path)
    head = parts[0]
    out = []
    m = _DOWN_ATTN.match(head)
    if m:
        out.append(f"down_blocks.{m.group(1)}.attentions.{m.group(2)}")
    elif head == "mid_attn":
        out.append("mid_block.attentions.0")
    elif (m := _UP_ATTN.match(head)):
        u = num_levels - 1 - int(m.group(1))
        out.append(f"up_blocks.{u}.attentions.{m.group(2)}")
    elif (m := _DOWN_RES.match(head)):
        out.append(f"down_blocks.{m.group(1)}.resnets.{m.group(2)}")
    elif (m := _MID_RES.match(head)):
        out.append(f"mid_block.resnets.{m.group(1)}")
    elif (m := _UP_RES.match(head)):
        u = num_levels - 1 - int(m.group(1))
        out.append(f"up_blocks.{u}.resnets.{m.group(2)}")
    elif (m := _DOWN_SAMPLE.match(head)):
        out.append(f"down_blocks.{m.group(1)}.downsamplers.0.conv")
    elif (m := _UP_SAMPLE.match(head)):
        u = num_levels - 1 - int(m.group(1))
        out.append(f"up_blocks.{u}.upsamplers.0.conv")
    elif (m := _BLOCK.match(head)):
        out.append(f"transformer_blocks.{m.group(1)}")     # DiT families
    elif head in _TOP:
        out.append(_TOP[head])
    else:
        return None
    rest = parts[1:]
    i = 0
    while i < len(rest):
        part = rest[i]
        m = _TBLOCK.match(part)
        if m:
            out.append(f"transformer_blocks.{m.group(1)}")
            i += 1
            continue
        two = ".".join(rest[i:i + 2])
        if two in _INNER:
            out.append(_INNER[two])
            i += 2
            continue
        out.append(_INNER.get(part, part))
        i += 1
    return ".".join(out)
