"""DINOv2 ViT-B/14 image encoder (frozen) for the REPA alignment targets.

Counterpart of ``yat_tpu/models/dinov2.py``: a pre-LN ViT with a patch-14
conv embedding, a cls token, LayerScale, and the patch tokens taken after
the final norm (cls dropped), ``x_norm_patchtokens`` ``[B, 256, 768]`` of
224x224 bicubic-resized, ImageNet-normalised images.  Everything runs in
fp32 (on the card with TF32 off, as ``device.resolve_device`` sets it);
the attention is plain tensor code, as the JAX package computes it outside
any Pallas kernel (``jax.nn.dot_product_attention``).

``convert_dinov2`` maps a torch.hub ``dinov2_vitb14`` state dict onto the
flax-layout tree that ``convert.load_flax_params`` loads.  The published
checkpoint is built at 518 px: its ``pos_embed`` is ``[1, 1370, 768]``
(37x37 + cls) against the 224 px model's ``[1, 257, 768]``, and it does
not load in either package (``merge_into`` raises naming both shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yat_tpu_torch.models.layers import AdapterDense, Conv2d, LayerNorm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    patch_size: int = 14
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    image_size: int = 224
    layerscale_init: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


DINOV2_VITB14 = DinoV2Config()
DINOV2_TINY_TEST = DinoV2Config(patch_size=14, hidden_dim=32, num_layers=2,
                                num_heads=2, image_size=28)


class DinoBlock(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        d = cfg.hidden_dim
        self.cfg = cfg
        self.ls1 = nn.Parameter(torch.empty(d))
        self.ls2 = nn.Parameter(torch.empty(d))
        self.norm1 = LayerNorm(d)
        self.q = AdapterDense(d, d, dtype=torch.float32)
        self.k = AdapterDense(d, d, dtype=torch.float32)
        self.v = AdapterDense(d, d, dtype=torch.float32)
        self.proj = AdapterDense(d, d, dtype=torch.float32)
        self.norm2 = LayerNorm(d)
        self.fc1 = AdapterDense(d, int(d * cfg.mlp_ratio), dtype=torch.float32)
        self.fc2 = AdapterDense(int(d * cfg.mlp_ratio), d, dtype=torch.float32)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ls1.data.fill_(self.cfg.layerscale_init)
        self.ls2.data.fill_(self.cfg.layerscale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, n, d = x.shape
        hd = d // c.num_heads
        h = self.norm1(x)
        q, k, v = (m(h).reshape(b, n, c.num_heads, hd)
                   for m in (self.q, self.k, self.v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        attn = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
        x = x + self.ls1 * self.proj(attn.reshape(b, n, d))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="none")
        return x + self.ls2 * self.fc2(h)


class DinoV2(nn.Module):
    """``forward(images)``: ``[B, 224, 224, 3]`` ImageNet-normalised →
    ``x_norm_patchtokens`` ``[B, 256, 768]``."""

    def __init__(self, cfg: DinoV2Config = DINOV2_VITB14):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_dim, cfg.patch_size
        self.patch_embed = Conv2d(3, d, p, stride=p, padding=(0, 0))
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.grid ** 2 + 1, d))
        self.blocks = nn.ModuleList(DinoBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = LayerNorm(d)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.cls_token.data.zero_()
        nn.init.normal_(self.pos_embed.data, 0.0, 0.02, generator=gen)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images.float())
        b, gh, gw, d = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, d),
                       x.reshape(b, gh * gw, d)], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1:]                        # drop cls


def preprocess_for_dino(images_m1_1: torch.Tensor,
                        size: int = 224) -> torch.Tensor:
    """``[-1, 1]`` NHWC → ``size``² ImageNet-normalised NHWC: the ``[0, 1]``
    rescale, an antialiased bicubic resize (what ``jax.image.resize(...,
    "bicubic")`` computes; without ``antialias`` a 512 px downscale differs
    by up to 0.7) and the ImageNet mean and std."""
    x = (images_m1_1.float() + 1.0) / 2.0
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bicubic", align_corners=False, antialias=True)
    x = x.permute(0, 2, 3, 1)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def convert_dinov2(sd: Dict[str, np.ndarray], num_layers: int = 12) -> Dict:
    """A torch.hub ``dinov2_vitb14`` state dict → the flax-layout tree (a
    copy of the JAX package's converter; the checkpoint's ``mask_token``
    has no place in the model and is not read)."""
    from yat_tpu_torch.models.convert import _linear, _norm, _set

    tree: Dict = {}
    w = sd["patch_embed.proj.weight"]            # [D, 3, 14, 14]
    _set(tree, "patch_embed.kernel", np.transpose(w, (2, 3, 1, 0)))
    _set(tree, "patch_embed.bias", sd["patch_embed.proj.bias"])
    tree["cls_token"] = sd["cls_token"]
    tree["pos_embed"] = sd["pos_embed"]
    for i in range(num_layers):
        p, q = f"blocks.{i}", f"blocks_{i}"
        qkv_w = sd[f"{p}.attn.qkv.weight"]       # [3D, D]
        qkv_b = sd[f"{p}.attn.qkv.bias"]
        d = qkv_w.shape[1]
        for j, name in enumerate(("q", "k", "v")):
            _set(tree, f"{q}.{name}.kernel", qkv_w[j * d:(j + 1) * d].T)
            _set(tree, f"{q}.{name}.bias", qkv_b[j * d:(j + 1) * d])
        _linear(sd, f"{p}.attn.proj", tree, f"{q}.proj")
        _norm(sd, f"{p}.norm1", tree, f"{q}.norm1")
        _norm(sd, f"{p}.norm2", tree, f"{q}.norm2")
        _set(tree, f"{q}.ls1", sd[f"{p}.ls1.gamma"])
        _set(tree, f"{q}.ls2", sd[f"{p}.ls2.gamma"])
        _linear(sd, f"{p}.mlp.fc1", tree, f"{q}.fc1")
        _linear(sd, f"{p}.mlp.fc2", tree, f"{q}.fc2")
    _norm(sd, "norm", tree, "norm")
    return tree
