"""SANA: linear-attention DiT for text-to-image flow matching.

Counterpart of ``yat_tpu/models/sana.py``: patch-1 embedding of
32x-compressed DC-AE latents, N blocks of [ReLU linear self-attention →
softmax cross-attention over Gemma text embeddings → GLUMBConv gated conv
FFN], AdaLN-single timestep conditioning (one shared 6-way modulation plus
per-block learned tables) and an AdaLN-modulated output projection.

Layout: latents are NHWC, tokens are [B, N, D].  Three kernels run
inside, forward and backward: K1/K1b (adaLN LayerNorm, twice per block and
once at the output), K2/K2b (cross-attention, and the self-attention of
blocks listed in ``softmax_self_attn_blocks``) and K3 (linear
self-attention; its backward is a plain recompute).  With
``gradient_checkpointing`` each block runs under
``torch.utils.checkpoint`` (the JAX ``nn.remat``): its forward runs again
in the backward, so the forward kernels launch twice per block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from yat_tpu_torch.models.layers import (
    AdapterDense,
    Attention,
    CaptionProjection,
    GLUMBConv,
    LiteLinearAttention,
    PatchEmbed,
    RMSNorm,
    TimestepEmbedder,
    unpatchify,
)
from yat_tpu_torch.ops.norm import adaln_layernorm


@dataclasses.dataclass(frozen=True)
class SanaConfig:
    """SANA-0.6B (512px) defaults; 1.6B = dim 2240 / 20 heads / 20 layers."""

    in_channels: int = 32
    out_channels: int = 32
    hidden_dim: int = 1152            # 36 heads x 32
    num_layers: int = 28
    num_attention_heads: int = 36
    attention_head_dim: int = 32
    num_cross_attention_heads: int = 16
    cross_attention_head_dim: int = 72
    caption_channels: int = 2304      # Gemma-2-2b hidden size
    mlp_ratio: float = 2.5
    patch_size: int = 1
    sample_size: int = 16             # 512px / 32x VAE
    vae_compression: int = 32
    max_caption_len: int = 512
    # the published SANA-0.6B/1.6B checkpoints carry no attn2 qk norms
    qk_norm: Optional[str] = None
    # blocks whose self-attention is full softmax instead of linear
    softmax_self_attn_blocks: Tuple[int, ...] = ()

    @property
    def resolution(self) -> int:
        return self.sample_size * self.vae_compression


class SanaBlock(nn.Module):
    def __init__(self, cfg: SanaConfig, use_softmax_self_attn: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = cfg
        # AdaLN-single: per-block table added to the shared per-step emb
        self.scale_shift_table = nn.Parameter(torch.empty(6, c.hidden_dim))
        if use_softmax_self_attn:
            self.attn1 = Attention(c.hidden_dim, c.num_attention_heads,
                                   c.attention_head_dim,
                                   out_features=c.hidden_dim,
                                   qk_norm=c.qk_norm, dtype=dtype)
        else:
            self.attn1 = LiteLinearAttention(c.hidden_dim,
                                             c.num_attention_heads,
                                             c.attention_head_dim,
                                             qk_norm=c.qk_norm, dtype=dtype)
        self.attn2 = Attention(c.hidden_dim, c.num_cross_attention_heads,
                               c.cross_attention_head_dim,
                               out_features=c.hidden_dim, qk_norm=c.qk_norm,
                               dtype=dtype)
        self.ff = GLUMBConv(c.hidden_dim, expand_ratio=c.mlp_ratio,
                            dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.scale_shift_table.data, 0.0,
                        self.scale_shift_table.shape[1] ** -0.5,
                        generator=gen)

    def forward(self, x, cond_emb, text_emb, text_mask, hw: Tuple[int, int],
                ctx_kv=None, deterministic: bool = True, sp=None):
        """``sp`` (a ``parallel.tensor.SequenceParallel``): ``x`` holds
        this process's slice of the grid's tokens."""
        mod = self.scale_shift_table[None] + cond_emb          # [B, 6, D]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = [
            mod[:, i][:, None, :].to(x.dtype) for i in range(6)]

        # 1) self-attention: linear by default, softmax for listed blocks
        h = adaln_layernorm(x, scale_msa, shift_msa)
        x = x + gate_msa * self.attn1(h, deterministic=deterministic, sp=sp)

        # 2) softmax cross-attention on the caption tokens
        x = x + self.attn2(x, context=text_emb, mask=text_mask,
                           cached_kv=ctx_kv, deterministic=deterministic,
                           sp=sp)

        # 3) gated conv FFN
        h = adaln_layernorm(x, scale_mlp, shift_mlp)
        return x + gate_mlp * self.ff(h, hw, deterministic, sp)


class SanaTransformer2D(nn.Module):
    """The denoiser.  ``forward(latents, text_emb, timesteps, text_mask)``
    → velocity prediction with the same shape as ``latents``."""

    # sampling may cache the caption K/V across denoise steps (the text
    # embeddings are constant within a request)
    supports_context_cache = True

    def __init__(self, cfg: SanaConfig = SanaConfig(),
                 dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        self.gradient_checkpointing = gradient_checkpointing
        p = c.patch_size
        self.patch_embed = PatchEmbed(c.in_channels, c.hidden_dim,
                                      patch_size=p, dtype=dtype)
        self.time_embed = TimestepEmbedder(c.hidden_dim, dtype=torch.float32)
        self.time_proj = AdapterDense(c.hidden_dim, 6 * c.hidden_dim,
                                      dtype=torch.float32)
        self.caption_projection = CaptionProjection(c.caption_channels,
                                                    c.hidden_dim, dtype=dtype)
        self.caption_norm = RMSNorm(c.hidden_dim)
        self.blocks = nn.ModuleList(
            SanaBlock(c, use_softmax_self_attn=(i in c.softmax_self_attn_blocks),
                      dtype=dtype)
            for i in range(c.num_layers))
        self.out_scale_shift_table = nn.Parameter(torch.empty(2, c.hidden_dim))
        self.proj_out = AdapterDense(c.hidden_dim, p * p * c.out_channels,
                                     dtype=dtype)
        # the sp group (parallel.tensor.SequenceParallel), or None
        self.sequence_parallel = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.out_scale_shift_table.data, 0.0,
                        self.cfg.hidden_dim ** -0.5, generator=gen)

    def forward(self, latents: Optional[torch.Tensor], text_emb: torch.Tensor,
                timesteps: Optional[torch.Tensor],
                text_mask: Optional[torch.Tensor] = None, *,
                cached_ctx_kv: Optional[tuple] = None,
                return_ctx_kv: bool = False, deterministic: bool = True):
        c = self.cfg
        # caption projection into model width
        ctx = self.caption_norm(
            self.caption_projection(text_emb.to(self.dtype)))
        if return_ctx_kv:
            # per-request context-K/V pass of sampling: only the caption
            # projection and every block's attn2 K/V (latents and
            # timesteps are not read)
            return tuple(blk.attn2.project_kv(ctx) for blk in self.blocks)

        b, h, w, _ = latents.shape
        p = c.patch_size
        grid_hw = (h // p, w // p)
        x = self.patch_embed(latents.to(self.dtype))
        # under sp, this process's slice of the tokens (the JAX
        # constrain_tokens, sana.py:171-175)
        n, sp = x.shape[1], self.sequence_parallel
        if sp is not None:
            x = sp.shard(x)
            sp = sp if x.shape[1] != n else None

        # timestep conditioning → 6-way modulation shared by all blocks
        t_emb = self.time_embed(timesteps)
        cond = self.time_proj(F.silu(t_emb)).reshape(b, 6, c.hidden_dim)

        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            args = (x, cond, ctx, text_mask, grid_hw,
                    cached_ctx_kv[i] if cached_ctx_kv is not None else None,
                    deterministic, sp)
            if remat:
                x = torch.utils.checkpoint.checkpoint(blk, *args,
                                                      use_reentrant=False)
            else:
                x = blk(*args)

        # output: AdaLN-modulated norm → projection to patch pixels
        out_mod = self.out_scale_shift_table[None] + t_emb[:, None, :]
        shift = out_mod[:, 0][:, None, :].to(x.dtype)
        scale = out_mod[:, 1][:, None, :].to(x.dtype)
        x = self.proj_out(adaln_layernorm(x, scale, shift), deterministic)
        if sp is not None:
            x = sp.gather(x, n)
        return unpatchify(x, (h, w), p, c.out_channels)


# Named size presets (diffusers checkpoints map onto these shapes)
SANA_600M = SanaConfig()
SANA_1600M = SanaConfig(hidden_dim=2240, num_layers=20,
                        num_attention_heads=70, attention_head_dim=32,
                        num_cross_attention_heads=20,
                        cross_attention_head_dim=112)
SANA_TINY_TEST = SanaConfig(hidden_dim=64, num_layers=2,
                            num_attention_heads=2, attention_head_dim=32,
                            num_cross_attention_heads=2,
                            cross_attention_head_dim=32,
                            caption_channels=32, max_caption_len=16,
                            in_channels=4, out_channels=4, sample_size=8)
