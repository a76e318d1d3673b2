"""UNet and KL-VAE checkpoint converters: diffusers
``UNet2DConditionModel`` and ``AutoencoderKL``, and the CompVis single-file
SD format, → the flax-layout trees.

Counterpart of ``yat_tpu/models/convert_unet.py`` (numpy only):

* ``convert_unet``: diffusers UNet → the ``models/unet.UNet2DCondition``
  tree.  diffusers' ``up_blocks.0`` is the lowest-resolution block; the
  tree's ``up_{level}`` keeps the down path's level index, so
  ``up_blocks[i] ↔ up_{n_levels-1-i}``; SD1.5's 1x1-conv ``proj_in`` and
  ``proj_out`` become dense layers;
* ``convert_vae_kl``: diffusers AutoencoderKL → the AutoencoderKL tree
  (an ``encoder`` half with ``quant_conv``, a ``decoder`` half with
  ``post_quant_conv``);
* ``split_compvis_checkpoint`` splits a single file into its UNet, VAE and
  CLIP parts; ``ldm_unet_to_diffusers`` and ``ldm_vae_to_diffusers``
  rename the LDM keys to diffusers' (the published mechanical table), and
  ``convert_vae_compvis`` finishes the VAE.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

from yat_tpu_torch.models.convert import _conv, _conv_as_linear, _linear, \
    _norm


def _resnet(sd, tp, tree, fp, time_emb=True):
    _norm(sd, f"{tp}.norm1", tree, f"{fp}.norm1")
    _conv(sd, f"{tp}.conv1", tree, f"{fp}.conv1")
    if time_emb and f"{tp}.time_emb_proj.weight" in sd:
        _linear(sd, f"{tp}.time_emb_proj", tree, f"{fp}.time_emb_proj")
    _norm(sd, f"{tp}.norm2", tree, f"{fp}.norm2")
    _conv(sd, f"{tp}.conv2", tree, f"{fp}.conv2")
    if f"{tp}.conv_shortcut.weight" in sd:
        _conv(sd, f"{tp}.conv_shortcut", tree, f"{fp}.conv_shortcut")


def _attn_inner(sd, tp, tree, fp):
    """One transformer block: attn1/attn2/ff + norms."""
    for attn in ("attn1", "attn2"):
        for name in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{tp}.{attn}.{name}", tree, f"{fp}.{attn}.{name}")
        _linear(sd, f"{tp}.{attn}.to_out.0", tree, f"{fp}.{attn}.to_out")
    for i in (1, 2, 3):
        _norm(sd, f"{tp}.norm{i}", tree, f"{fp}.norm{i}")
    _linear(sd, f"{tp}.ff.net.0.proj", tree, f"{fp}.ff.proj")
    _linear(sd, f"{tp}.ff.net.2", tree, f"{fp}.ff.out")


def _spatial_transformer(sd, tp, tree, fp, n_layers):
    _norm(sd, f"{tp}.norm", tree, f"{fp}.norm")
    for io in ("proj_in", "proj_out"):
        w = sd[f"{tp}.{io}.weight"]
        if w.ndim == 4:   # SD1.5 uses 1x1 convs for the projections
            _conv_as_linear(sd, f"{tp}.{io}", tree, f"{fp}.{io}")
        else:
            _linear(sd, f"{tp}.{io}", tree, f"{fp}.{io}")
    for t in range(n_layers):
        _attn_inner(sd, f"{tp}.transformer_blocks.{t}", tree,
                    f"{fp}.transformer_blocks_{t}")


def convert_unet(sd: Dict[str, np.ndarray],
                 block_out_channels: Tuple[int, ...],
                 layers_per_block: int,
                 transformer_layers: Tuple[int, ...]) -> Dict[str, Any]:
    """diffusers UNet2DConditionModel state dict → the UNet2DCondition
    tree."""
    tree: dict = {}
    n = len(block_out_channels)
    _conv(sd, "conv_in", tree, "conv_in")
    _linear(sd, "time_embedding.linear_1", tree, "time_linear_1")
    _linear(sd, "time_embedding.linear_2", tree, "time_linear_2")
    if "add_embedding.linear_1.weight" in sd:   # SDXL micro-conditioning
        _linear(sd, "add_embedding.linear_1", tree, "add_linear_1")
        _linear(sd, "add_embedding.linear_2", tree, "add_linear_2")

    for level in range(n):
        for j in range(layers_per_block):
            _resnet(sd, f"down_blocks.{level}.resnets.{j}", tree,
                    f"down_{level}_resnet_{j}")
            if transformer_layers[level] > 0:
                _spatial_transformer(
                    sd, f"down_blocks.{level}.attentions.{j}", tree,
                    f"down_{level}_attn_{j}", transformer_layers[level])
        key = f"down_blocks.{level}.downsamplers.0.conv.weight"
        if key in sd:
            _conv(sd, f"down_blocks.{level}.downsamplers.0.conv", tree,
                  f"down_{level}_downsample")

    _resnet(sd, "mid_block.resnets.0", tree, "mid_resnet_0")
    _spatial_transformer(sd, "mid_block.attentions.0", tree, "mid_attn",
                         max(1, transformer_layers[-1]))
    _resnet(sd, "mid_block.resnets.1", tree, "mid_resnet_1")

    for i in range(n):                      # diffusers up index
        level = n - 1 - i                   # our level index
        for j in range(layers_per_block + 1):
            _resnet(sd, f"up_blocks.{i}.resnets.{j}", tree,
                    f"up_{level}_resnet_{j}")
            if transformer_layers[level] > 0:
                _spatial_transformer(
                    sd, f"up_blocks.{i}.attentions.{j}", tree,
                    f"up_{level}_attn_{j}", transformer_layers[level])
        key = f"up_blocks.{i}.upsamplers.0.conv.weight"
        if key in sd:
            _conv(sd, f"up_blocks.{i}.upsamplers.0.conv", tree,
                  f"up_{level}_upsample")

    _norm(sd, "conv_norm_out", tree, "conv_norm_out")
    _conv(sd, "conv_out", tree, "conv_out")
    return tree


def _vae_attn(sd, tp, tree, fp):
    _norm(sd, f"{tp}.group_norm", tree, f"{fp}.group_norm")
    legacy = f"{tp}.query.weight" in sd
    names = (("query", "to_q"), ("key", "to_k"), ("value", "to_v")) if legacy \
        else (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"))
    for src, dst in names:
        _linear(sd, f"{tp}.{src}", tree, f"{fp}.{dst}")
    out_src = f"{tp}.proj_attn" if legacy else f"{tp}.to_out.0"
    _linear(sd, out_src, tree, f"{fp}.to_out")


def convert_vae_kl(sd: Dict[str, np.ndarray],
                   block_out_channels: Tuple[int, ...],
                   layers_per_block: int = 2) -> Dict[str, Any]:
    """diffusers AutoencoderKL → the AutoencoderKL tree."""
    tree: dict = {"encoder": {}, "decoder": {}}
    enc, dec = tree["encoder"], tree["decoder"]
    n = len(block_out_channels)

    _conv(sd, "encoder.conv_in", enc, "conv_in")
    for i in range(n):
        for j in range(layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", enc,
                    f"down_{i}_resnet_{j}", time_emb=False)
        key = f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"
        if key in sd:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", enc,
                  f"down_{i}_downsample")
    _resnet(sd, "encoder.mid_block.resnets.0", enc, "mid_resnet_0",
            time_emb=False)
    _vae_attn(sd, "encoder.mid_block.attentions.0", enc, "mid_attn")
    _resnet(sd, "encoder.mid_block.resnets.1", enc, "mid_resnet_1",
            time_emb=False)
    _norm(sd, "encoder.conv_norm_out", enc, "conv_norm_out")
    _conv(sd, "encoder.conv_out", enc, "conv_out")
    _conv(sd, "quant_conv", enc, "quant_conv")

    _conv(sd, "post_quant_conv", dec, "post_quant_conv")
    _conv(sd, "decoder.conv_in", dec, "conv_in")
    _resnet(sd, "decoder.mid_block.resnets.0", dec, "mid_resnet_0",
            time_emb=False)
    _vae_attn(sd, "decoder.mid_block.attentions.0", dec, "mid_attn")
    _resnet(sd, "decoder.mid_block.resnets.1", dec, "mid_resnet_1",
            time_emb=False)
    for i in range(n):                      # decoder up index == ours
        for j in range(layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", dec,
                    f"up_{i}_resnet_{j}", time_emb=False)
        key = f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"
        if key in sd:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dec,
                  f"up_{i}_upsample")
    _norm(sd, "decoder.conv_norm_out", dec, "conv_norm_out")
    _conv(sd, "decoder.conv_out", dec, "conv_out")
    return tree


# ---------------------------------------------------------------------------
# CompVis single-file SD1.5 (.safetensors / .ckpt)
# ---------------------------------------------------------------------------

# LDM→diffusers key remapping is a published, mechanical table; here only
# the pieces the SD1.5 frontend needs (UNet + VAE + CLIP).

def split_compvis_checkpoint(sd: Dict[str, np.ndarray]
                             ) -> Dict[str, Dict[str, np.ndarray]]:
    """Split a CompVis single-file state dict into component dicts with the
    LDM prefixes stripped (``pretrained_pipe_single_file``)."""
    out = {"unet": {}, "vae": {}, "clip": {}}
    for k, v in sd.items():
        if k.startswith("model.diffusion_model."):
            out["unet"][k[len("model.diffusion_model."):]] = v
        elif k.startswith("first_stage_model."):
            out["vae"][k[len("first_stage_model."):]] = v
        elif k.startswith("cond_stage_model.transformer."):
            out["clip"][k[len("cond_stage_model.transformer."):]] = v
    return out


_LDM_RESNET = (("in_layers.0", "norm1"), ("in_layers.2", "conv1"),
               ("emb_layers.1", "time_emb_proj"), ("out_layers.0", "norm2"),
               ("out_layers.3", "conv2"), ("skip_connection", "conv_shortcut"))


def _remap_prefix(sd, out, src: str, dst: str):
    for k, v in sd.items():
        if k.startswith(src + "."):
            out[dst + k[len(src):]] = v


def _remap_ldm_resnet(sd, out, src: str, dst: str):
    for a, b in _LDM_RESNET:
        for wb in ("weight", "bias"):
            k = f"{src}.{a}.{wb}"
            if k in sd:
                out[f"{dst}.{b}.{wb}"] = sd[k]


def ldm_unet_to_diffusers(sd: Dict[str, np.ndarray],
                          block_out_channels: Tuple[int, ...],
                          layers_per_block: int,
                          transformer_layers: Tuple[int, ...]
                          ) -> Dict[str, np.ndarray]:
    """CompVis/LDM UNet naming (the ``model.diffusion_model`` split of a
    single-file checkpoint) → diffusers UNet2DConditionModel naming, so
    ``convert_unet`` can finish.  LDM's SpatialTransformer inner keys already
    match diffusers' BasicTransformerBlock, so attention is a pure prefix
    remap; resnets use the in_layers/out_layers table."""
    out: Dict[str, np.ndarray] = {}
    n = len(block_out_channels)
    lpb = layers_per_block

    out["conv_in.weight"] = sd["input_blocks.0.0.weight"]
    out["conv_in.bias"] = sd["input_blocks.0.0.bias"]
    for src, dst in (("time_embed.0", "time_embedding.linear_1"),
                     ("time_embed.2", "time_embedding.linear_2"),
                     ("label_emb.0.0", "add_embedding.linear_1"),
                     ("label_emb.0.2", "add_embedding.linear_2"),
                     ("out.0", "conv_norm_out"), ("out.2", "conv_out")):
        for wb in ("weight", "bias"):
            if f"{src}.{wb}" in sd:
                out[f"{dst}.{wb}"] = sd[f"{src}.{wb}"]

    k = 1
    for i in range(n):
        for j in range(lpb):
            _remap_ldm_resnet(sd, out, f"input_blocks.{k}.0",
                              f"down_blocks.{i}.resnets.{j}")
            if transformer_layers[i] > 0:
                _remap_prefix(sd, out, f"input_blocks.{k}.1",
                              f"down_blocks.{i}.attentions.{j}")
            k += 1
        if i < n - 1:
            for wb in ("weight", "bias"):
                out[f"down_blocks.{i}.downsamplers.0.conv.{wb}"] = \
                    sd[f"input_blocks.{k}.0.op.{wb}"]
            k += 1

    _remap_ldm_resnet(sd, out, "middle_block.0", "mid_block.resnets.0")
    _remap_prefix(sd, out, "middle_block.1", "mid_block.attentions.0")
    _remap_ldm_resnet(sd, out, "middle_block.2", "mid_block.resnets.1")

    k = 0
    for u in range(n):                      # diffusers up index, 0 = lowest
        level = n - 1 - u
        for j in range(lpb + 1):
            _remap_ldm_resnet(sd, out, f"output_blocks.{k}.0",
                              f"up_blocks.{u}.resnets.{j}")
            mod = 1
            if transformer_layers[level] > 0:
                _remap_prefix(sd, out, f"output_blocks.{k}.{mod}",
                              f"up_blocks.{u}.attentions.{j}")
                mod += 1
            if j == lpb and u < n - 1:
                for wb in ("weight", "bias"):
                    key = f"output_blocks.{k}.{mod}.conv.{wb}"
                    if key in sd:
                        out[f"up_blocks.{u}.upsamplers.0.conv.{wb}"] = sd[key]
            k += 1
    return out


def ldm_vae_to_diffusers(sd: Dict[str, np.ndarray],
                         n_levels: int = 4) -> Dict[str, np.ndarray]:
    """CompVis/LDM VAE key naming → diffusers AutoencoderKL naming, so
    ``convert_vae_kl`` can finish the job.  The remap is the published
    mechanical table: ``down.{i}.block.{j}`` → ``down_blocks.{i}.resnets.{j}``,
    ``mid.block_1/2`` → ``mid_block.resnets.0/1``, ``mid.attn_1`` →
    ``mid_block.attentions.0`` with 1x1-conv q/k/v/proj_out squeezed to
    linears, ``nin_shortcut`` → ``conv_shortcut``, ``norm_out`` →
    ``conv_norm_out``, and decoder ``up.{i}`` reversed (LDM's highest up
    index runs first)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        nk = k.replace("nin_shortcut", "conv_shortcut")
        nk = re.sub(r"^encoder\.down\.(\d+)\.block\.(\d+)",
                    r"encoder.down_blocks.\1.resnets.\2", nk)
        nk = re.sub(r"^encoder\.down\.(\d+)\.downsample\.conv",
                    r"encoder.down_blocks.\1.downsamplers.0.conv", nk)
        m = re.match(r"^decoder\.up\.(\d+)\.(.*)$", nk)
        if m:
            i = n_levels - 1 - int(m.group(1))   # reversed up index
            rest = m.group(2)
            rest = re.sub(r"^block\.(\d+)", r"resnets.\1", rest)
            rest = re.sub(r"^upsample\.conv", "upsamplers.0.conv", rest)
            nk = f"decoder.up_blocks.{i}.{rest}"
        for side in ("encoder", "decoder"):
            nk = nk.replace(f"{side}.mid.block_1", f"{side}.mid_block.resnets.0")
            nk = nk.replace(f"{side}.mid.block_2", f"{side}.mid_block.resnets.1")
            nk = nk.replace(f"{side}.mid.attn_1", f"{side}.mid_block.attentions.0")
            nk = nk.replace(f"{side}.norm_out", f"{side}.conv_norm_out")
        if ".attentions.0." in nk:
            tail = nk.rsplit(".attentions.0.", 1)[1]
            head = nk[: len(nk) - len(tail)]
            name, _, wb = tail.partition(".")
            remap = {"norm": "group_norm", "q": "to_q", "k": "to_k",
                     "v": "to_v", "proj_out": "to_out.0"}
            if name in remap:
                nk = head + remap[name] + ("." + wb if wb else "")
                if name in ("q", "k", "v", "proj_out") and v.ndim == 4:
                    v = v[:, :, 0, 0]            # 1x1 conv → linear
        out[nk] = v
    return out


def convert_vae_compvis(ldm_sd: Dict[str, np.ndarray],
                        block_out_channels: Tuple[int, ...],
                        layers_per_block: int = 2) -> Dict[str, Any]:
    """CompVis/LDM-named VAE state dict (the ``first_stage_model`` split of
    a single-file checkpoint) → our AutoencoderKL tree
    (the single-file path)."""
    return convert_vae_kl(
        ldm_vae_to_diffusers(ldm_sd, n_levels=len(block_out_channels)),
        block_out_channels, layers_per_block)
