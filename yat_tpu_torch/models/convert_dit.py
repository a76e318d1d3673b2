"""DiT checkpoint converters: diffusers PixArtTransformer2DModel → the
flax-layout PixArtTransformer2D tree, SD3Transformer2DModel → MMDiT,
FluxTransformer2DModel → FluxTransformer and a DiT-named PixelDiT
checkpoint → PixelDiT.

Counterparts of ``convert_pixart``, ``convert_sd3_mmdit``,
``convert_flux`` and ``convert_pixeldit`` of
``yat_tpu/models/convert_dit.py`` (with its ``_lin_opt``/``_norm_opt``
helpers).  Same layout rules as ``models/convert.py``; the 2x2 conv patch
embed becomes the Dense over ``p*p*C`` in (h, w, c) patch order.  SD3's
dual-stream naming maps the attention halves: diffusers ``attn.to_q``
(image) / ``attn.add_q_proj`` (text) → ``x_to_q`` / ``c_to_q``; the
checkpoint's ``pos_embed.pos_embed`` buffer is not read (the MMDiT
computes its table).  Flux's single blocks keep ``attn.to_q/to_k/to_v``
and ``proj_mlp`` apart in the file; the model's ``linear1`` is their
concatenation along the output axis, in that order.  PixelDiT's file
(the DiT naming its text-to-image code derives from) fuses the
self-attention's ``attn.qkv`` and the cross-attention's
``cross_attn.kv_linear``; each is cut along its output axis.
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


def convert_pixeldit(sd: Dict[str, np.ndarray], num_layers: int,
                     num_pixel_layers: int) -> Dict[str, Any]:
    """A DiT-named PixelDiT checkpoint → PixelDiT: the conv (or dense)
    ``x_embedder.proj`` patch embed, ``t_embedder.mlp.0/.2``, the caption
    embedder (``cap_embedder.1``, ``y_embedder.proj`` or
    ``caption_projection``), ``token_expand``, ``pixel_time_proj``; each
    block (``blocks.{i}``, then ``pixel_blocks.{i}``) with the fused
    ``attn.qkv`` (or ``attn.to_q/to_k/to_v``) cut in three, ``attn.proj``
    (or ``attn.to_out.0``), PixArt-style ``cross_attn.q_linear``, the fused
    ``cross_attn.kv_linear`` cut in two and ``cross_attn.proj``,
    ``adaLN_modulation.1`` and ``mlp.fc1/fc2``; ``final_layer.linear``
    as ``proj_out``."""
    tree: dict = {}
    w = sd.get("x_embedder.proj.weight")
    if w is not None:
        if w.ndim == 4:
            d, c, p, _ = w.shape
            k = np.transpose(w, (2, 3, 1, 0)).reshape(p * p * c, d)
            _set(tree, "patch_embed.proj.kernel", np.ascontiguousarray(k))
            _set(tree, "patch_embed.proj.bias", sd["x_embedder.proj.bias"])
        else:
            _linear(sd, "x_embedder.proj", tree, "patch_embed.proj")
    _lin_opt(sd, "t_embedder.mlp.0", tree, "time_embed.linear_1")
    _lin_opt(sd, "t_embedder.mlp.2", tree, "time_embed.linear_2")
    for src in ("cap_embedder.1", "y_embedder.proj", "caption_projection"):
        if f"{src}.weight" in sd:
            _lin_opt(sd, src, tree, "caption_projection")
            break
    _lin_opt(sd, "token_expand", tree, "token_expand")
    _lin_opt(sd, "pixel_time_proj", tree, "pixel_time_proj")

    def fused(src, dst, names):
        """``src`` cut along its output axis into ``dst.{name}``."""
        weight, bias = sd[f"{src}.weight"], sd.get(f"{src}.bias")
        n = weight.shape[0] // len(names)
        for j, name in enumerate(names):
            _set(tree, f"{dst}.{name}.kernel",
                 np.ascontiguousarray(weight[j * n:(j + 1) * n].T))
            if bias is not None:
                _set(tree, f"{dst}.{name}.bias", bias[j * n:(j + 1) * n])

    def block(p: str, q: str):
        if f"{p}.attn.qkv.weight" in sd:
            fused(f"{p}.attn.qkv", f"{q}.attn", ("to_q", "to_k", "to_v"))
        else:
            for name in ("to_q", "to_k", "to_v"):
                _lin_opt(sd, f"{p}.attn.{name}", tree, f"{q}.attn.{name}")
        for src in (f"{p}.attn.proj", f"{p}.attn.to_out.0"):
            if f"{src}.weight" in sd:
                _lin_opt(sd, src, tree, f"{q}.attn.to_out")
                break
        if f"{p}.cross_attn.q_linear.weight" in sd:
            _lin_opt(sd, f"{p}.cross_attn.q_linear", tree,
                     f"{q}.cross_attn.to_q")
            fused(f"{p}.cross_attn.kv_linear", f"{q}.cross_attn",
                  ("to_k", "to_v"))
            _lin_opt(sd, f"{p}.cross_attn.proj", tree,
                     f"{q}.cross_attn.to_out")
        _lin_opt(sd, f"{p}.adaLN_modulation.1", tree, f"{q}.mod")
        _lin_opt(sd, f"{p}.mlp.fc1", tree, f"{q}.ff.fc1")
        _lin_opt(sd, f"{p}.mlp.fc2", tree, f"{q}.ff.fc2")

    for i in range(num_layers):
        block(f"blocks.{i}", f"blocks_{i}")
    for i in range(num_pixel_layers):
        block(f"pixel_blocks.{i}", f"pixel_blocks_{i}")
    _lin_opt(sd, "final_layer.linear", tree, "proj_out")
    return tree
