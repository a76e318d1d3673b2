"""PixArt-Sigma checkpoint converter: diffusers PixArtTransformer2DModel →
the flax-layout PixArtTransformer2D tree.

Counterpart of ``convert_pixart`` of ``yat_tpu/models/convert_dit.py``
(with its ``_lin_opt``/``_norm_opt`` helpers).  Same layout rules as
``models/convert.py``; the 2x2 conv patch embed becomes the Dense over
``p*p*C`` in (h, w, c) patch order.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from yat_tpu_torch.models.convert import _linear, _norm, _set


def _lin_opt(sd, tp, tree, fp):
    if f"{tp}.weight" in sd:
        _linear(sd, tp, tree, fp)


def _norm_opt(sd, tp, tree, fp):
    if f"{tp}.weight" in sd:
        _norm(sd, tp, tree, fp)


def convert_pixart(sd: Dict[str, np.ndarray],
                   num_layers: int) -> Dict[str, Any]:
    """diffusers PixArtTransformer2DModel → PixArtTransformer2D."""
    tree: dict = {}
    if "pos_embed.proj.weight" in sd:
        w = sd["pos_embed.proj.weight"]
        if w.ndim == 4:
            # conv patch embed (2x2) → Dense over p*p*C: torch conv
            # [D, C, p, p] → dense [(p*p*C), D] in (h, w, c) patch order
            d, c, p, _ = w.shape
            k = np.transpose(w, (2, 3, 1, 0)).reshape(p * p * c, d)
            _set(tree, "pos_embed.proj.kernel", np.ascontiguousarray(k))
            _set(tree, "pos_embed.proj.bias", sd["pos_embed.proj.bias"])
        else:
            _linear(sd, "pos_embed.proj", tree, "pos_embed.proj")
    _linear(sd, "adaln_single.emb.timestep_embedder.linear_1", tree,
            "time_embed.linear_1")
    _linear(sd, "adaln_single.emb.timestep_embedder.linear_2", tree,
            "time_embed.linear_2")
    _linear(sd, "adaln_single.linear", tree, "time_proj")
    _linear(sd, "caption_projection.linear_1", tree,
            "caption_projection.linear_1")
    _lin_opt(sd, "caption_projection.linear_2", tree,
             "caption_projection.linear_2")
    if "scale_shift_table" in sd:
        # top-level (2, dim) table modulates the output head (the per-block
        # (6, dim) tables live at transformer_blocks.{i}.scale_shift_table)
        tree["out_scale_shift_table"] = sd["scale_shift_table"]
    for i in range(num_layers):
        p = f"transformer_blocks.{i}"
        q = f"blocks_{i}"
        if f"{p}.scale_shift_table" in sd:
            _set(tree, f"{q}.scale_shift_table",
                 sd[f"{p}.scale_shift_table"])
        for a in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{p}.{a}.{name}", tree, f"{q}.{a}.{name}")
            _linear(sd, f"{p}.{a}.to_out.0", tree, f"{q}.{a}.to_out")
        _linear(sd, f"{p}.ff.net.0.proj", tree, f"{q}.ff.fc1")
        _linear(sd, f"{p}.ff.net.2", tree, f"{q}.ff.fc2")
    _lin_opt(sd, "proj_out", tree, "proj_out")
    return tree
