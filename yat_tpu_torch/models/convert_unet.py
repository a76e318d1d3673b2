"""SD KL-VAE checkpoint converter: diffusers AutoencoderKL → the
flax-layout AutoencoderKL tree.

Counterpart of ``convert_vae_kl`` of ``yat_tpu/models/convert_unet.py``
and the helpers it calls.  The tree has an ``encoder`` half (with
``quant_conv``) and a ``decoder`` half (with ``post_quant_conv``); the
port's ``models/vae.AutoencoderKL`` loads the ``decoder`` half.  The UNet
converter comes with the UNet families.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from yat_tpu_torch.models.convert import _conv, _linear, _norm


def _resnet(sd, tp, tree, fp, time_emb=True):
    _norm(sd, f"{tp}.norm1", tree, f"{fp}.norm1")
    _conv(sd, f"{tp}.conv1", tree, f"{fp}.conv1")
    if time_emb and f"{tp}.time_emb_proj.weight" in sd:
        _linear(sd, f"{tp}.time_emb_proj", tree, f"{fp}.time_emb_proj")
    _norm(sd, f"{tp}.norm2", tree, f"{fp}.norm2")
    _conv(sd, f"{tp}.conv2", tree, f"{fp}.conv2")
    if f"{tp}.conv_shortcut.weight" in sd:
        _conv(sd, f"{tp}.conv_shortcut", tree, f"{fp}.conv_shortcut")


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
