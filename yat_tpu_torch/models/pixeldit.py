"""PixelDiT: the pixel-space DiT (no VAE) with its in-model REPA projector.

Counterpart of ``yat_tpu/models/pixeldit.py``: a *patch* stage (16 px
patches embedded to width 1024, 24 DiT blocks of adaLN-zero modulation,
self-attention, cross-attention over the projected caption and a GELU
MLP; the REPA projector taps the tokens after block ``repa_depth``)
followed by a *pixel* stage: ``token_expand`` turns each patch token into
``(patch / pixel_patch)^2`` tokens of width 256, laid out row-major over
the 4 px grid, and 4 DiT blocks without cross-attention (``heads // 4``
heads, conditioned on ``pixel_time_proj`` of the timestep embedding)
refine them; an affine-free LayerNorm (not K1), ``proj_out`` and the
unpatchify give the ``[B, H, W, 3]`` velocity.

Kernels on CUDA: each block's two modulated norms are ``adaln_layernorm``
(K1 forward, K1b backward; 56 a forward at full depth); the patch stage's
attentions go through the JAX package's gate (``ops.attention.
dot_product_attention``): at 512 px its 1024-token self-attention takes
K6 and its cross-attention over the 300-token caption K4 (K2's kernel,
folded: the native backward's block set is 15 MiB at width 1024), both
the XLA branch at buckets whose token count the gate refuses.  The pixel
stage's self-attention runs K6/K6b through ``ops.attention.
flash_attention`` directly, with no gate and no mask, where the JAX
model takes its gate: at 512 px it is 16384 tokens long, and at 12 of
the 34 buckets of 512 px its length is no multiple of 128, where the
gate's XLA branch would build ``[B, 4, N, N]`` fp32 scores (15.5 GB a
tensor at batch 4 and N = 15552).  :func:`kernel_calls` lists each
forward's calls.

The modulation layers start at zero (flax ``zeros_init``).  With
``gradient_checkpointing`` each block runs under
``torch.utils.checkpoint`` (the JAX ``nn.remat``) while gradients are
recorded.  A model built with ``repa=True`` holds the projector (fc1 and
fc2 2048 wide, fc3 ``repa_target_dim``, fp32 on fp32 input) when its tap
lies within the patch stage; ``return_repa`` then returns its projection
beside the prediction (None for a tap past the last block).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from yat_tpu_torch.models.layers import (MLP, AdapterDense, Attention,
                                         LayerNorm, PatchEmbed,
                                         TimestepEmbedder, ZeroDense,
                                         unpatchify)
from yat_tpu_torch.models.pixart import RepaProjector
from yat_tpu_torch.ops.norm import adaln_layernorm


@dataclasses.dataclass(frozen=True)
class PixelDiTConfig:
    in_channels: int = 3
    out_channels: int = 3
    patch_size: int = 16            # patch stage granularity (pixels)
    pixel_patch: int = 4            # pixel stage granularity
    hidden_dim: int = 1024
    pixel_hidden_dim: int = 256
    num_layers: int = 24
    num_pixel_layers: int = 4
    num_heads: int = 16
    caption_channels: int = 2304    # Gemma-2-2B
    max_caption_len: int = 300
    mlp_ratio: float = 4.0
    repa_depth: Optional[int] = 12
    repa_target_dim: int = 768

    @property
    def pixel_heads(self) -> int:
        return max(1, self.num_heads // 4)

    @property
    def ratio(self) -> int:
        """Pixel tokens along each side of one patch token."""
        return self.patch_size // self.pixel_patch


PIXELDIT_BASE = PixelDiTConfig()
PIXELDIT_TINY_TEST = PixelDiTConfig(
    patch_size=8, pixel_patch=2, hidden_dim=32, pixel_hidden_dim=16,
    num_layers=2, num_pixel_layers=1, num_heads=2, caption_channels=16,
    max_caption_len=8, mlp_ratio=1.0, repa_depth=0)


class DiTBlock(nn.Module):
    """adaLN-zero DiT block: the 6-way fp32 modulation of ``silu(cond)``,
    modulated norm → self-attention → gated residual, cross-attention over
    the caption (when built with it; ungated, unnormed), modulated norm →
    GELU MLP → gated residual.  ``flash`` routes the self-attention to
    K6/K6b directly (the pixel stage)."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_ratio: float,
                 cross: bool = True, flash: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d, hd = hidden_dim, hidden_dim // num_heads
        self.hidden_dim = d
        self.mod = ZeroDense(d, 6 * d, dtype=torch.float32)
        self.attn = Attention(d, num_heads, hd, dtype=dtype, flash=flash)
        self.cross_attn = (Attention(d, num_heads, hd, dtype=dtype)
                           if cross else None)
        self.ff = MLP(d, mlp_ratio=mlp_ratio, dtype=dtype)

    def forward(self, x, cond, ctx=None, ctx_mask=None,
                deterministic: bool = True):
        d = self.hidden_dim
        mod = self.mod(F.silu(cond)).reshape(x.shape[0], 6, d)
        sh1, sc1, g1, sh2, sc2, g2 = [mod[:, i][:, None, :].to(x.dtype)
                                      for i in range(6)]
        h = self.attn(adaln_layernorm(x, sc1, sh1),
                      deterministic=deterministic)
        x = x + g1 * h
        if ctx is not None:
            x = x + self.cross_attn(x, context=ctx, mask=ctx_mask,
                                    deterministic=deterministic)
        h = self.ff(adaln_layernorm(x, sc2, sh2), deterministic)
        return x + g2 * h


class PixelDiT(nn.Module):
    """The denoiser.  ``forward(pixels, text_emb, timesteps, text_mask)``
    on ``[B, H, W, 3]`` pixels in [-1, 1] → the ``[B, H, W, 3]``
    velocity (and, under ``return_repa``, the projection of the tap)."""

    def __init__(self, cfg: PixelDiTConfig = PIXELDIT_BASE,
                 dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: bool = False, repa: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        self.gradient_checkpointing = gradient_checkpointing
        self.time_embed = TimestepEmbedder(c.hidden_dim, dtype=torch.float32)
        self.caption_projection = AdapterDense(c.caption_channels,
                                               c.hidden_dim, dtype=dtype)
        self.patch_embed = PatchEmbed(c.in_channels, c.hidden_dim,
                                      patch_size=c.patch_size, dtype=dtype)
        for i in range(c.num_layers):
            setattr(self, f"blocks_{i}", DiTBlock(
                c.hidden_dim, c.num_heads, c.mlp_ratio, dtype=dtype))
        self.repa_projector = (
            RepaProjector(c.hidden_dim, out_dim=c.repa_target_dim)
            if repa and self.has_tap else None)
        self.token_expand = AdapterDense(
            c.hidden_dim, c.ratio ** 2 * c.pixel_hidden_dim, dtype=dtype)
        self.pixel_time_proj = AdapterDense(c.hidden_dim, c.pixel_hidden_dim,
                                            dtype=torch.float32)
        for i in range(c.num_pixel_layers):
            setattr(self, f"pixel_blocks_{i}", DiTBlock(
                c.pixel_hidden_dim, c.pixel_heads, c.mlp_ratio, cross=False,
                flash=True, dtype=dtype))
        self.norm_out = LayerNorm(c.pixel_hidden_dim, use_scale=False,
                                  use_bias=False)
        self.proj_out = AdapterDense(
            c.pixel_hidden_dim, c.pixel_patch ** 2 * c.out_channels,
            dtype=dtype)

    @property
    def has_tap(self) -> bool:
        """Whether the REPA tap lies within the patch stage."""
        d = self.cfg.repa_depth
        return d is not None and 0 <= d < self.cfg.num_layers

    def forward(self, pixels: torch.Tensor, text_emb: torch.Tensor,
                timesteps: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True, return_repa: bool = False):
        c = self.cfg
        if return_repa and self.has_tap and self.repa_projector is None:
            raise ValueError("return_repa needs a model built with repa=True")
        b, h, w, _ = pixels.shape
        t_emb = self.time_embed(timesteps)
        ctx = self.caption_projection(text_emb.to(self.dtype))
        remat = self.gradient_checkpointing and torch.is_grad_enabled()

        def run(blk, *args):
            if remat:
                return torch.utils.checkpoint.checkpoint(
                    blk, *args, deterministic, use_reentrant=False)
            return blk(*args, deterministic)

        # patch stage
        x = self.patch_embed(pixels.to(self.dtype))
        repa_proj = None
        for i in range(c.num_layers):
            x = run(getattr(self, f"blocks_{i}"), x, t_emb, ctx, text_mask)
            if return_repa and i == c.repa_depth:
                repa_proj = self.repa_projector(x.float())

        # pixel stage: each patch token expands into ratio x ratio tokens,
        # row-major over the pixel_patch grid
        r, dp = c.ratio, c.pixel_hidden_dim
        gh, gw = h // c.patch_size, w // c.patch_size
        x = self.token_expand(x)
        x = x.reshape(b, gh, gw, r, r, dp).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * r * gw * r, dp)
        t_px = self.pixel_time_proj(t_emb)
        for i in range(c.num_pixel_layers):
            x = run(getattr(self, f"pixel_blocks_{i}"), x, t_px, None, None)

        x = self.proj_out(self.norm_out(x))
        out = unpatchify(x, (h, w), c.pixel_patch, c.out_channels)
        return (out, repa_proj) if return_repa else out


def kernel_calls(cfg: PixelDiTConfig, gh: int, gw: int, n_txt: int,
                 batch: int = 1) -> Dict[str, List[tuple]]:
    """The kernel calls of one forward on ``batch`` images of ``gh`` x
    ``gw`` patch tokens with ``n_txt`` caption keys, in the order they
    run: the gated attentions ``dot_product_attention`` as ``(B, N_q,
    N_k, H, D)`` (each patch block's self-attention, then its
    cross-attention; ``ops.attention.attention_branch`` names the kernel
    each takes), the direct ``flash_attention`` q shapes ``[B, N, H, D]``
    (each pixel block's self-attention over ``gh * gw * ratio^2``
    tokens), and ``adaln_layernorm`` x shapes ``[B, N, D]`` (each block's
    two norms, patch blocks first; ``norm_out`` is plain)."""
    c = cfg
    n = gh * gw
    n_px = n * c.ratio ** 2
    hd = c.hidden_dim // c.num_heads
    gated = []
    for _ in range(c.num_layers):
        gated += [(batch, n, n, c.num_heads, hd),
                  (batch, n, n_txt, c.num_heads, hd)]
    flash = [(batch, n_px, c.pixel_heads,
              c.pixel_hidden_dim // c.pixel_heads)] * c.num_pixel_layers
    norms = [(batch, n, c.hidden_dim)] * (2 * c.num_layers) + [
        (batch, n_px, c.pixel_hidden_dim)] * (2 * c.num_pixel_layers)
    return {"dot_product_attention": gated, "flash_attention": flash,
            "adaln_layernorm": norms}
