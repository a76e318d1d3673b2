"""Conditional UNet of SD1.5 and SDXL (epsilon prediction).

Counterpart of ``yat_tpu/models/unet.py`` (diffusers'
``UNet2DConditionModel``): a conv stem, a timestep MLP over a sinusoidal
embedding, time-conditioned resnets interleaved with cross-attention
transformer blocks over a down / mid / up topology with skip connections;
SDXL adds micro-conditioning, the pooled text and six ``time_ids``
embedded sinusoidally and added to the time embedding (fp32, as the time
MLP).

NHWC, the compute dtype of ``dtype``; GroupNorms keep their statistics in
fp32 and the data in the compute dtype (``layers.GroupNorm``).  Submodules
carry the JAX package's flax names (``down_0_resnet_1``,
``mid_attn.transformer_blocks_0.attn2.to_q``), so ``lora_target_modules``
patterns and ``convert.load_flax_params`` carry across.  Attention goes
through ``layers.Attention`` → ``ops.attention.dot_product_attention``,
so on the card the self- and cross-attentions take kernels K6, K4 or K2
(or the plain XLA branch) by the shapes each level gives
(:func:`attention_calls` lists them).

``gradient_checkpointing`` (``low_vram``) recomputes every resnet and
every spatial transformer in the backward (``torch.utils.checkpoint``).
The JAX package means to do the same, but its remat wrapper of the
spatial transformers is built and never used, so there only the resnets
are recomputed; the numbers are equal either way.

The up path resizes (nearest) to the grid of the skip it joins, as
diffusers' ``upsample_size`` does: a latent side that turns odd on the
way down (44 → 22 → 11 at SD1.5's 352 px side of the 0.5 bucket) comes
back to 11, not 12.  The JAX package doubles the grid and cannot join
such a skip; where every side halves evenly the two are the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from yat_tpu_torch.models.layers import (
    AdapterDense,
    Attention,
    Conv2d,
    GroupNorm,
    LayerNorm,
    sinusoidal_timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # per level: transformer layers in each attention block (0 = none)
    transformer_layers: Tuple[int, ...] = (1, 1, 1, 0)
    cross_attention_dim: int = 768
    attention_head_dim: int = 64
    # when set, head_dim = channels // num_heads (SD1.5: 8 heads)
    num_heads: Optional[int] = None
    # SDXL micro-conditioning: the pooled text's width (1280)
    addition_embed_dim: Optional[int] = None
    addition_time_embed_dim: int = 256
    num_time_ids: int = 6
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0


SD15_UNET = UNetConfig(num_heads=8)
SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    transformer_layers=(0, 2, 10),
    cross_attention_dim=2048,
    attention_head_dim=64,
    addition_embed_dim=1280,
)
UNET_TINY_TEST = UNetConfig(
    block_out_channels=(32, 64),
    layers_per_block=1,
    transformer_layers=(1, 1),
    cross_attention_dim=16,
    attention_head_dim=16,
    num_heads=2,
)


def heads_of(cfg: UNetConfig, ch: int) -> Tuple[int, int]:
    """(heads, head dim) of the attention blocks at width ``ch``."""
    if cfg.num_heads is not None:
        return cfg.num_heads, ch // cfg.num_heads
    return ch // cfg.attention_head_dim, cfg.attention_head_dim


def attention_calls(cfg: UNetConfig, h: int, w: int, n_ctx: int = 77
                    ) -> List[Tuple[str, int, int, int, int]]:
    """Every attention of one denoiser forward on an ``h`` x ``w`` latent:
    ``(kind, n_q, n_k, heads, head_dim)`` with ``kind`` ``"self"`` or
    ``"cross"`` (over ``n_ctx`` caption tokens), in the order they run."""
    out = []
    n_levels = len(cfg.block_out_channels)

    def block(level, ch, hh, ww, layers):
        heads, hd = heads_of(cfg, ch)
        for _ in range(layers):
            out.append(("self", hh * ww, hh * ww, heads, hd))
            out.append(("cross", hh * ww, n_ctx, heads, hd))

    hh, ww = h, w
    sizes = []
    for level, ch in enumerate(cfg.block_out_channels):
        sizes.append((hh, ww))
        for _ in range(cfg.layers_per_block):
            block(level, ch, hh, ww, cfg.transformer_layers[level])
        if level < n_levels - 1:
            hh, ww = (hh + 1) // 2, (ww + 1) // 2
    block(n_levels - 1, cfg.block_out_channels[-1], hh, ww,
          max(1, cfg.transformer_layers[-1]))
    for level in reversed(range(n_levels)):
        hh, ww = sizes[level]
        for _ in range(cfg.layers_per_block + 1):
            block(level, cfg.block_out_channels[level], hh, ww,
                  cfg.transformer_layers[level])
    return out


class TimeResnetBlock(nn.Module):
    """GroupNorm → SiLU → conv3x3, twice, with the time embedding's
    projection added between them; a 1x1 conv on the shortcut when the
    width changes."""

    def __init__(self, in_channels: int, out_channels: int, t_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, 1e-5)
        self.conv1 = Conv2d(in_channels, out_channels, 3, dtype=dtype)
        self.time_emb_proj = AdapterDense(t_dim, out_channels, dtype=dtype)
        self.norm2 = GroupNorm(out_channels, 32, 1e-5)
        self.conv2 = Conv2d(out_channels, out_channels, 3, dtype=dtype)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1,
                                     dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x, t_emb):
        h = self.conv1(F.silu(self.norm1(x)))
        t = self.time_emb_proj(F.silu(t_emb))
        h = h + t[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLUFeedForward(nn.Module):
    """proj (d → 8d) → a · GELU(g) (exact erf) over its halves → out
    (4d → d)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.proj = AdapterDense(dim, dim * 8, dtype=dtype)
        self.out = AdapterDense(dim * 4, dim, dtype=dtype)

    def forward(self, x, deterministic: bool = True):
        a, g = self.proj(x, deterministic).chunk(2, dim=-1)
        return self.out(a * F.gelu(g, approximate="none"), deterministic)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads, head_dim, use_bias=False,
                               dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, num_heads, head_dim, use_bias=False,
                               dtype=dtype, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dtype)

    def forward(self, x, context, mask, deterministic: bool = True):
        x = x + self.attn1(self.norm1(x), deterministic=deterministic)
        x = x + self.attn2(self.norm2(x), context, mask,
                           deterministic=deterministic)
        return x + self.ff(self.norm3(x), deterministic)


class SpatialTransformer(nn.Module):
    """GroupNorm → proj_in → transformer blocks over the H·W tokens →
    proj_out, plus the input."""

    def __init__(self, channels: int, num_layers: int, num_heads: int,
                 head_dim: int, context_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = channels
        self.norm = GroupNorm(c, 32, 1e-6)
        self.proj_in = AdapterDense(c, c, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(c, num_heads, head_dim, context_dim, dtype)
            for _ in range(num_layers))
        self.proj_out = AdapterDense(c, c, dtype=dtype)

    def forward(self, x, context, mask, deterministic: bool = True):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(b, h * w, c), deterministic)
        for blk in self.transformer_blocks:
            y = blk(y, context, mask, deterministic)
        y = self.proj_out(y, deterministic)
        return x + y.reshape(b, h, w, c)


class UNet2DCondition(nn.Module):
    """``forward(latents [B, H, W, C], text_emb [B, L, D], timesteps [B],
    text_mask [B, L] = None, *, pooled_text [B, P] = None, time_ids [B, 6]
    = None)`` → the prediction ``[B, H, W, out_channels]`` in ``dtype``.
    SDXL's configuration (``addition_embed_dim``) needs ``pooled_text``
    and ``time_ids``."""

    def __init__(self, cfg: UNetConfig = SD15_UNET,
                 dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.gradient_checkpointing = gradient_checkpointing
        ch0 = c.block_out_channels[0]
        t_dim = ch0 * 4
        f32 = torch.float32
        self.time_linear_1 = AdapterDense(ch0, t_dim, dtype=f32)
        self.time_linear_2 = AdapterDense(t_dim, t_dim, dtype=f32)
        if c.addition_embed_dim is not None:
            self.add_linear_1 = AdapterDense(
                c.addition_embed_dim
                + c.num_time_ids * c.addition_time_embed_dim, t_dim,
                dtype=f32)
            self.add_linear_2 = AdapterDense(t_dim, t_dim, dtype=f32)
        self.conv_in = Conv2d(c.in_channels, ch0, 3, dtype=dtype)

        def attn(name, ch, layers):
            if layers:
                heads, hd = heads_of(c, ch)
                self.add_module(name, SpatialTransformer(
                    ch, layers, heads, hd, c.cross_attention_dim, dtype))

        n = len(c.block_out_channels)
        cur, skips = ch0, [ch0]
        for level, ch in enumerate(c.block_out_channels):
            for j in range(c.layers_per_block):
                self.add_module(f"down_{level}_resnet_{j}",
                                TimeResnetBlock(cur, ch, t_dim, dtype))
                cur = ch
                attn(f"down_{level}_attn_{j}", ch,
                     c.transformer_layers[level])
                skips.append(ch)
            if level < n - 1:
                self.add_module(f"down_{level}_downsample", Conv2d(
                    ch, ch, 3, dtype=dtype, stride=2, padding=(1, 1)))
                skips.append(ch)
        ch = c.block_out_channels[-1]
        self.mid_resnet_0 = TimeResnetBlock(cur, ch, t_dim, dtype)
        attn("mid_attn", ch, max(1, c.transformer_layers[-1]))
        self.mid_resnet_1 = TimeResnetBlock(ch, ch, t_dim, dtype)
        cur = ch
        for level in reversed(range(n)):
            ch = c.block_out_channels[level]
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{level}_resnet_{j}", TimeResnetBlock(
                    cur + skips.pop(), ch, t_dim, dtype))
                cur = ch
                attn(f"up_{level}_attn_{j}", ch, c.transformer_layers[level])
            if level > 0:
                self.add_module(f"up_{level}_upsample",
                                Conv2d(cur, cur, 3, dtype=dtype))
        self.conv_norm_out = GroupNorm(cur, 32, 1e-5)
        self.conv_out = Conv2d(cur, c.out_channels, 3, dtype=dtype)

    def _time_embedding(self, timesteps, pooled_text, time_ids):
        c = self.cfg
        ch0 = c.block_out_channels[0]
        t_freq = sinusoidal_timestep_embedding(
            timesteps, ch0, flip_sin_to_cos=c.flip_sin_to_cos,
            downscale_freq_shift=c.freq_shift)
        t_emb = self.time_linear_2(F.silu(self.time_linear_1(t_freq)))
        if c.addition_embed_dim is None:
            return t_emb
        if pooled_text is None or time_ids is None:
            raise ValueError("SDXL UNet needs pooled_text and time_ids")
        b = time_ids.shape[0]
        ids_emb = sinusoidal_timestep_embedding(
            time_ids.reshape(-1), c.addition_time_embed_dim,
            flip_sin_to_cos=c.flip_sin_to_cos).reshape(
            b, c.num_time_ids * c.addition_time_embed_dim)
        add = torch.cat([pooled_text.float(), ids_emb], dim=-1)
        add = self.add_linear_2(F.silu(self.add_linear_1(add)))
        return t_emb + add

    def _run(self, module, *args):
        if self.gradient_checkpointing and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(module, *args,
                                                     use_reentrant=False)
        return module(*args)

    def forward(self, latents: torch.Tensor, text_emb: torch.Tensor,
                timesteps: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None, *,
                pooled_text: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        c = self.cfg
        t_emb = self._time_embedding(timesteps, pooled_text, time_ids)
        ctx = text_emb.to(self.dtype)
        x = self.conv_in(latents.to(self.dtype))

        def attn(name, x):
            st = getattr(self, name, None)
            if st is None:
                return x
            return self._run(st, x, ctx, text_mask, deterministic)

        n = len(c.block_out_channels)
        skips = [x]
        for level in range(n):
            for j in range(c.layers_per_block):
                x = self._run(getattr(self, f"down_{level}_resnet_{j}"),
                              x, t_emb)
                x = attn(f"down_{level}_attn_{j}", x)
                skips.append(x)
            if level < n - 1:
                x = getattr(self, f"down_{level}_downsample")(x)
                skips.append(x)
        x = self._run(self.mid_resnet_0, x, t_emb)
        x = attn("mid_attn", x)
        x = self._run(self.mid_resnet_1, x, t_emb)
        for level in reversed(range(n)):
            for j in range(c.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = self._run(getattr(self, f"up_{level}_resnet_{j}"),
                              x, t_emb)
                x = attn(f"up_{level}_attn_{j}", x)
            if level > 0:
                # nearest to the next skip's grid: 2x where the side was
                # even on the way down; diffusers' upsample_size where it
                # was odd (the JAX package's 2x resize cannot join it)
                size = tuple(skips[-1].shape[1:3])
                x = F.interpolate(x.permute(0, 3, 1, 2), size=size,
                                  mode="nearest").permute(0, 2, 3, 1)
                x = getattr(self, f"up_{level}_upsample")(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
