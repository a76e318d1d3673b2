"""DiT checkpoint converters: diffusers PixArtTransformer2DModel → the
flax-layout PixArtTransformer2D tree, SD3Transformer2DModel → MMDiT and
FluxTransformer2DModel → FluxTransformer.

Counterparts of ``convert_pixart``, ``convert_sd3_mmdit`` and
``convert_flux`` of
``yat_tpu/models/convert_dit.py`` (with its ``_lin_opt``/``_norm_opt``
helpers).  Same layout rules as ``models/convert.py``; the 2x2 conv patch
embed becomes the Dense over ``p*p*C`` in (h, w, c) patch order.  SD3's
dual-stream naming maps the attention halves: diffusers ``attn.to_q``
(image) / ``attn.add_q_proj`` (text) → ``x_to_q`` / ``c_to_q``; the
checkpoint's ``pos_embed.pos_embed`` buffer is not read (the MMDiT
computes its table).  Flux's single blocks keep ``attn.to_q/to_k/to_v``
and ``proj_mlp`` apart in the file; the model's ``linear1`` is their
concatenation along the output axis, in that order.
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


def _conv_patch_embed(sd, tree, flax_prefix):
    """The conv patch embed (2x2) ``pos_embed.proj`` → the Dense over
    ``p*p*C`` at ``flax_prefix.proj``: torch conv ``[D, C, p, p]`` →
    dense ``[(p*p*C), D]`` in (h, w, c) patch order."""
    w = sd["pos_embed.proj.weight"]
    d, c, p, _ = w.shape
    k = np.transpose(w, (2, 3, 1, 0)).reshape(p * p * c, d)
    _set(tree, f"{flax_prefix}.proj.kernel", np.ascontiguousarray(k))
    _set(tree, f"{flax_prefix}.proj.bias", sd["pos_embed.proj.bias"])


def convert_pixart(sd: Dict[str, np.ndarray],
                   num_layers: int) -> Dict[str, Any]:
    """diffusers PixArtTransformer2DModel → PixArtTransformer2D."""
    tree: dict = {}
    if "pos_embed.proj.weight" in sd:
        w = sd["pos_embed.proj.weight"]
        if w.ndim == 4:
            _conv_patch_embed(sd, tree, "pos_embed")
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


def convert_sd3_mmdit(sd: Dict[str, np.ndarray],
                      num_layers: int) -> Dict[str, Any]:
    """diffusers SD3Transformer2DModel → MMDiT: the patch embed, the time
    and pooled-text embedders, the context embedder, each block's
    ``norm1``/``norm1_context`` modulation, the joint attention's image
    (``attn.to_*``) and text (``attn.add_*_proj``, ``to_add_out``)
    halves with their qk norms, a dual block's ``attn2``, both FFNs (the
    last block has no text output or FFN), ``norm_out`` and
    ``proj_out``."""
    tree: dict = {}
    w = sd.get("pos_embed.proj.weight")
    if w is not None and w.ndim == 4:
        _conv_patch_embed(sd, tree, "patch_embed")
    for src, dst in (("timestep_embedder.linear_1", "time_embed.linear_1"),
                     ("timestep_embedder.linear_2", "time_embed.linear_2"),
                     ("text_embedder.linear_1", "pool_linear_1"),
                     ("text_embedder.linear_2", "pool_linear_2")):
        _lin_opt(sd, f"time_text_embed.{src}", tree, dst)
    _lin_opt(sd, "context_embedder", tree, "context_embedder")
    for i in range(num_layers):
        p = f"transformer_blocks.{i}"
        q = f"blocks_{i}"
        _lin_opt(sd, f"{p}.norm1.linear", tree, f"{q}.x_mod.mod")
        _lin_opt(sd, f"{p}.norm1_context.linear", tree, f"{q}.c_mod.mod")
        # the joint attention: image half, then text half
        for name in ("to_q", "to_k", "to_v"):
            _lin_opt(sd, f"{p}.attn.{name}", tree, f"{q}.x_{name}")
        _lin_opt(sd, f"{p}.attn.to_out.0", tree, f"{q}.x_to_out")
        for src, dst in (("add_q_proj", "c_to_q"), ("add_k_proj", "c_to_k"),
                         ("add_v_proj", "c_to_v"), ("to_add_out", "c_to_out")):
            _lin_opt(sd, f"{p}.attn.{src}", tree, f"{q}.{dst}")
        for src, dst in (("norm_q", "x_norm_q"), ("norm_k", "x_norm_k"),
                         ("norm_added_q", "c_norm_q"),
                         ("norm_added_k", "c_norm_k")):
            _norm_opt(sd, f"{p}.attn.{src}", tree, f"{q}.{dst}")
        # a dual block's (MMDiT-X) second image self-attention
        for name in ("to_q", "to_k", "to_v"):
            _lin_opt(sd, f"{p}.attn2.{name}", tree, f"{q}.x2_{name}")
        _lin_opt(sd, f"{p}.attn2.to_out.0", tree, f"{q}.x2_to_out")
        for src, dst in (("norm_q", "x2_norm_q"), ("norm_k", "x2_norm_k")):
            _norm_opt(sd, f"{p}.attn2.{src}", tree, f"{q}.{dst}")
        _lin_opt(sd, f"{p}.ff.net.0.proj", tree, f"{q}.x_ff.fc1")
        _lin_opt(sd, f"{p}.ff.net.2", tree, f"{q}.x_ff.fc2")
        _lin_opt(sd, f"{p}.ff_context.net.0.proj", tree, f"{q}.c_ff.fc1")
        _lin_opt(sd, f"{p}.ff_context.net.2", tree, f"{q}.c_ff.fc2")
    _lin_opt(sd, "norm_out.linear", tree, "final_mod")
    _lin_opt(sd, "proj_out", tree, "proj_out")
    return tree


def convert_flux(sd: Dict[str, np.ndarray], num_double: int,
                 num_single: int) -> Dict[str, Any]:
    """diffusers FluxTransformer2DModel → FluxTransformer: the image and
    caption embedders, the timestep and guidance embedders, each double
    block's ``norm1``/``norm1_context`` modulation, the joint attention's
    image (``attn.to_*``) and caption (``attn.add_*_proj``,
    ``to_add_out``) halves with their qk norms and both FFNs; each single
    block's modulation, ``linear1`` fused from ``to_q``, ``to_k``,
    ``to_v`` and ``proj_mlp``, ``proj_out`` as ``linear2`` and its qk
    norms; ``norm_out.linear`` (diffusers' (scale, shift) order, as the
    model reads it) and ``proj_out``."""
    tree: dict = {}
    _lin_opt(sd, "x_embedder", tree, "img_in")
    _lin_opt(sd, "context_embedder", tree, "txt_in")
    for src, dst in (("timestep_embedder", "time_embed"),
                     ("guidance_embedder", "guidance_embed")):
        for j in (1, 2):
            _lin_opt(sd, f"time_text_embed.{src}.linear_{j}", tree,
                     f"{dst}.linear_{j}")
    for i in range(num_double):
        p, q = f"transformer_blocks.{i}", f"double_{i}"
        _lin_opt(sd, f"{p}.norm1.linear", tree, f"{q}.img_mod.lin")
        _lin_opt(sd, f"{p}.norm1_context.linear", tree, f"{q}.txt_mod.lin")
        for name in ("to_q", "to_k", "to_v"):
            _lin_opt(sd, f"{p}.attn.{name}", tree, f"{q}.img_{name}")
        _lin_opt(sd, f"{p}.attn.to_out.0", tree, f"{q}.img_to_out")
        for src, dst in (("add_q_proj", "txt_to_q"),
                         ("add_k_proj", "txt_to_k"),
                         ("add_v_proj", "txt_to_v"),
                         ("to_add_out", "txt_to_out")):
            _lin_opt(sd, f"{p}.attn.{src}", tree, f"{q}.{dst}")
        for src, dst in (("norm_q", "img_norm_q"), ("norm_k", "img_norm_k"),
                         ("norm_added_q", "txt_norm_q"),
                         ("norm_added_k", "txt_norm_k")):
            _norm_opt(sd, f"{p}.attn.{src}", tree, f"{q}.{dst}")
        for src, tag in (("ff", "img"), ("ff_context", "txt")):
            _lin_opt(sd, f"{p}.{src}.net.0.proj", tree, f"{q}.{tag}_ff_1")
            _lin_opt(sd, f"{p}.{src}.net.2", tree, f"{q}.{tag}_ff_2")
    for i in range(num_single):
        p, q = f"single_transformer_blocks.{i}", f"single_{i}"
        _lin_opt(sd, f"{p}.norm.linear", tree, f"{q}.mod.lin")
        if f"{p}.proj_mlp.weight" in sd:
            parts = [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v",
                     f"{p}.proj_mlp"]
            w = np.concatenate([sd[f"{t}.weight"] for t in parts], 0)
            _set(tree, f"{q}.linear1.kernel", np.ascontiguousarray(w.T))
            _set(tree, f"{q}.linear1.bias", np.concatenate(
                [sd[f"{t}.bias"] for t in parts], 0))
        _lin_opt(sd, f"{p}.proj_out", tree, f"{q}.linear2")
        _norm_opt(sd, f"{p}.attn.norm_q", tree, f"{q}.norm_q")
        _norm_opt(sd, f"{p}.attn.norm_k", tree, f"{q}.norm_k")
    _lin_opt(sd, "norm_out.linear", tree, "final_mod")
    _lin_opt(sd, "proj_out", tree, "proj_out")
    return tree
