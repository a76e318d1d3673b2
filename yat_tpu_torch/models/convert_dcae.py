"""DC-AE checkpoint converter: diffusers AutoencoderDC
(dc-ae-f32c32-sana-1.0-diffusers, the VAE of the SANA pipelines) → the
flax-layout DCAE tree.

Counterpart of ``yat_tpu/models/convert_dcae.py``; the tree has an
``encoder`` and a ``decoder`` half, and the port's ``models/vae.DCAE``
loads the ``decoder`` half (its encoder comes with the precompute slice).

The converter is **structure-driven** rather than index-driven: checkpoint
keys are grouped by their ``(down|up)_blocks.{i}.{j}`` prefix, each group is
classified by its key set (``conv1`` → ResBlock, ``attn`` → EfficientViT
block, a lone ``conv`` → down/upsample), and groups are assigned to our
model's slot sequence in serialized order.  That makes the mapping robust
to whether the torch layout places resample blocks at the end of a stage or
the start of the next one.

Per-leaf layout rules are the standard ones (models/convert.py): torch conv
[out,in,kh,kw] → flax [kh,kw,in,out], Linear transposed, RMSNorm weight →
``scale``.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import numpy as np

from yat_tpu_torch.models.convert import _set


def _put_conv(tree, fp, w, b=None):
    _set(tree, f"{fp}.kernel", np.transpose(w, (2, 3, 1, 0)))
    if b is not None:
        _set(tree, f"{fp}.bias", b)


def _put_linear(tree, fp, w, b=None):
    _set(tree, f"{fp}.kernel", w.T)
    if b is not None:
        _set(tree, f"{fp}.bias", b)


def _classify(group: Dict[str, np.ndarray]) -> str:
    keys = set(group)
    if any(k.startswith("attn.") for k in keys):
        return "vit"
    if any(k.startswith("conv1.") for k in keys):
        return "res"
    if any(k.startswith("conv_inverted.") for k in keys):
        return "glu"          # bare GLUMBConv block (no attention)
    if keys <= {"conv.weight", "conv.bias"} or \
            any(k.startswith("conv.") for k in keys):
        return "resample"
    return "unknown"


def _convert_res(group, tree, fp):
    _put_conv(tree, f"{fp}.conv1", group["conv1.weight"],
              group.get("conv1.bias"))
    _put_conv(tree, f"{fp}.conv2", group["conv2.weight"],
              group.get("conv2.bias"))
    for nk in ("norm.weight", "norm.gamma"):
        if nk in group:
            _set(tree, f"{fp}.norm.scale", group[nk].reshape(-1))
            break


def _convert_glu(group, tree, fp, prefix=""):
    p = prefix
    inv_w = group[f"{p}conv_inverted.weight"]
    if inv_w.ndim == 2:
        inv_w = inv_w[:, :, None, None]
    _put_conv(tree, f"{fp}.conv_inverted", inv_w,
              group.get(f"{p}conv_inverted.bias"))
    _put_conv(tree, f"{fp}.conv_depth", group[f"{p}conv_depth.weight"],
              group.get(f"{p}conv_depth.bias"))
    pt_w = group[f"{p}conv_point.weight"]
    if pt_w.ndim == 2:
        pt_w = pt_w[:, :, None, None]
    _put_conv(tree, f"{fp}.conv_point", pt_w,
              group.get(f"{p}conv_point.bias"))
    for nk in (f"{p}norm.weight", f"{p}norm.gamma"):
        if nk in group:
            _set(tree, f"{fp}.norm.scale", group[nk].reshape(-1))
            break


def _convert_vit(group, tree, fp):
    # attention: to_q/k/v linear (occasionally stored as 1x1 conv)
    for n in ("to_q", "to_k", "to_v", "to_out"):
        cands = [f"attn.{n}.weight", f"attn.{n}.0.weight",
                 f"attn.proj_out.weight" if n == "to_out" else None]
        for c in cands:
            if c and c in group:
                w = group[c]
                b = group.get(c.replace("weight", "bias"))
                if w.ndim == 4:
                    w = w[:, :, 0, 0]
                _put_linear(tree, f"{fp}.attn.{n}", w, b)
                break
    # multiscale aggregation convs
    s = 0
    while f"attn.to_qkv_multiscale.{s}.proj_in.weight" in group:
        _put_conv(tree, f"{fp}.attn.ms_{s}_proj_in",
                  group[f"attn.to_qkv_multiscale.{s}.proj_in.weight"],
                  group.get(f"attn.to_qkv_multiscale.{s}.proj_in.bias"))
        _put_conv(tree, f"{fp}.attn.ms_{s}_proj_out",
                  group[f"attn.to_qkv_multiscale.{s}.proj_out.weight"],
                  group.get(f"attn.to_qkv_multiscale.{s}.proj_out.bias"))
        s += 1
    for nk in ("attn.norm_out.weight", "attn.norm_out.gamma"):
        if nk in group:
            _set(tree, f"{fp}.attn.norm_out.scale", group[nk].reshape(-1))
            break
    # GLUMBConv half
    _convert_glu(group, tree, f"{fp}.conv_out", prefix="conv_out.")


def _serialize_groups(sd: Dict[str, np.ndarray], side: str,
                      kind: str) -> List[Dict[str, np.ndarray]]:
    """Collect ``{side}.{kind}.{i}(.{j})?.rest`` into ordered groups."""
    pat = re.compile(rf"^{side}\.{kind}\.(\d+)\.(?:(\d+)\.)?(.+)$")
    groups: Dict[Tuple[int, int], Dict[str, np.ndarray]] = defaultdict(dict)
    for k, v in sd.items():
        m = pat.match(k)
        if not m:
            continue
        i = int(m.group(1))
        j = int(m.group(2)) if m.group(2) is not None else -1
        groups[(i, j)][m.group(3)] = v
    return [groups[k] for k in sorted(groups)]


def convert_dcae(sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """diffusers AutoencoderDC state dict → DCAE tree (models/vae.py)."""
    tree: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    n = len(cfg.block_out_channels)

    for side, stage_depths, resample_name in (
            ("encoder", cfg.encoder_layers, "down"),
            ("decoder", cfg.decoder_layers, "up")):
        sub = tree[side]
        for name in ("conv_in", "conv_out"):
            k = f"{side}.{name}.weight"
            if k in sd:
                _put_conv(sub, name, sd[k], sd.get(f"{side}.{name}.bias"))
        for nk in (f"{side}.norm_out.weight", f"{side}.norm_out.gamma"):
            if nk in sd:
                _set(sub, "norm_out.scale", sd[nk].reshape(-1))
                break

        kind = "down_blocks" if side == "encoder" else "up_blocks"
        groups = _serialize_groups(sd, side, kind)
        # our slot sequence in traversal order
        depths = stage_depths if side == "encoder" \
            else tuple(reversed(stage_depths))
        attn = cfg.attention_stages if side == "encoder" \
            else tuple(reversed(cfg.attention_stages))
        block_slots: List[Tuple[str, bool]] = []
        resample_slots: List[str] = []
        for i in range(n):
            if i > 0:
                resample_slots.append(f"{resample_name}_{i}")
            for j in range(depths[i]):
                block_slots.append((f"stage_{i}_block_{j}", attn[i]))
        bi = ri = 0
        for g in groups:
            klass = _classify(g)
            if klass == "resample":
                if ri >= len(resample_slots):
                    raise ValueError(
                        f"{side}: more resample convs in checkpoint than "
                        f"model stages ({len(resample_slots)})")
                _put_conv(sub, f"{resample_slots[ri]}.conv",
                          g["conv.weight"], g.get("conv.bias"))
                ri += 1
                continue
            if bi >= len(block_slots):
                raise ValueError(
                    f"{side}: checkpoint has more blocks than the model "
                    f"({len(block_slots)}) — config mismatch")
            slot, is_attn = block_slots[bi]
            bi += 1
            if klass == "vit":
                if not is_attn:
                    raise ValueError(
                        f"{side}.{slot}: checkpoint block is attention but "
                        "model stage is conv — attention_stages mismatch")
                _convert_vit(g, sub, slot)
            elif klass == "res":
                _convert_res(g, sub, slot)
            elif klass == "glu":
                _convert_glu(g, sub, slot)
            else:
                raise ValueError(f"{side}: unclassifiable block with keys "
                                 f"{sorted(g)[:6]}")
        if bi != len(block_slots):
            raise ValueError(
                f"{side}: checkpoint supplied {bi} blocks, model expects "
                f"{len(block_slots)} — encoder/decoder depths mismatch")
    return tree
