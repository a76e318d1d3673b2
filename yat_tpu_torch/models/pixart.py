"""PixArt-Sigma: epsilon-prediction DiT (softmax attention, patch 2).

Counterpart of ``yat_tpu/models/pixart.py``: patch-2 embedding of 8x VAE
latents, N blocks of [softmax self-attention → cross-attention over T5
embeddings → gelu MLP], AdaLN-single conditioning (one shared 6-way
modulation plus per-block learned tables) and a learned-sigma output head
(``out_channels`` = 2 x ``in_channels``; sampling keeps the epsilon half).

Layout: latents are NHWC, tokens are [B, N, D].  Two kernels of the port
run in every block on CUDA, by the JAX package's shape gates: at 512px the
self-attention (1024 x 1024 tokens) takes K6 (flash attention) and the
cross-attention (1024 queries x 300 T5 keys) takes K2's kernel in K4's
place; K1 (adaLN LayerNorm) runs twice per block and once at the output.
``pag=True`` is the perturbed pass of perturbed-attention guidance: the
self-attention of ``pag_applied_layers`` (the middle block by default) is
the identity map.

REPA: a model built with ``repa=True`` holds the ``RepaProjector`` (fc1
and fc2 2048 wide, fc3 ``repa_target_dim``, fp32 on fp32 input) and, under
``return_repa``, returns its projection of the tokens after block
``repa_depth`` beside the prediction.  ``resnet_expansion`` adds the
``ResidualConvBranch`` after each block's self-attention: three 3x3 convs
over the token grid, SiLU after the first two, scaled by a learnable fp32
``out_alpha``.  Neither has a checkpoint counterpart; a pretrained load
leaves them at their initialisation (``frontends/common.py``).

In training the backward kernels run too: K6b for the self-attention, K4b
(K2b's kernel) for the cross-attention at the caption rungs where the JAX
package folds heads (256 and 300 tokens) and K2/K2b at the 128 rung, K1b
for the norms.  With ``gradient_checkpointing`` each block runs under
``torch.utils.checkpoint`` (the JAX ``nn.remat``) while gradients are
recorded: its forward runs again in the backward, so the forward kernels
launch twice per block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from yat_tpu_torch.models.layers import (
    MLP,
    AdapterDense,
    Attention,
    CaptionProjection,
    Conv2d,
    PatchEmbed,
    TimestepEmbedder,
    unpatchify,
)
from yat_tpu_torch.ops.norm import adaln_layernorm


@dataclasses.dataclass(frozen=True)
class PixArtConfig:
    """PixArt-Sigma-XL-2 defaults (~610M)."""

    in_channels: int = 4
    out_channels: int = 8            # 4 + 4 learned sigma
    hidden_dim: int = 1152
    num_layers: int = 28
    num_attention_heads: int = 16
    attention_head_dim: int = 72
    caption_channels: int = 4096     # T5-XXL
    mlp_ratio: float = 4.0
    patch_size: int = 2
    sample_size: int = 64            # 512px / 8x VAE
    vae_compression: int = 8
    max_caption_len: int = 300
    repa_depth: Optional[int] = None
    repa_target_dim: int = 768
    # blocks whose self-attention the PAG pass replaces with the identity;
    # None → the middle block
    pag_applied_layers: Optional[Tuple[int, ...]] = None
    resnet_expansion: bool = False
    resnet_alpha_init: float = 0.1

    @property
    def resolution(self) -> int:
        return self.sample_size * self.vae_compression


class RepaProjector(nn.Module):
    """The three-layer SiLU projection head of the REPA tap."""

    def __init__(self, in_dim: int, hidden: int = 2048, out_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = AdapterDense(in_dim, hidden, dtype=dtype)
        self.fc2 = AdapterDense(hidden, hidden, dtype=dtype)
        self.fc3 = AdapterDense(hidden, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.silu(self.fc2(F.silu(self.fc1(x)))))


class ResidualConvBranch(nn.Module):
    """``tokens + out_alpha · conv(silu(conv(silu(conv(grid)))))`` over the
    ``[B, H, W, D]`` token grid (3x3 'SAME' convs)."""

    def __init__(self, channels: int, alpha_init: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.alpha_init = alpha_init
        self.conv_0, self.conv_1, self.conv_2 = (
            Conv2d(channels, channels, 3, dtype=dtype) for _ in range(3))
        self.out_alpha = nn.Parameter(torch.empty(()))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.out_alpha.data.fill_(self.alpha_init)

    def forward(self, tokens: torch.Tensor, hw: Tuple[int, int]
                ) -> torch.Tensor:
        b, n, d = tokens.shape
        y = tokens.reshape(b, *hw, d)
        y = self.conv_2(F.silu(self.conv_1(F.silu(self.conv_0(y)))))
        return tokens + self.out_alpha.to(tokens.dtype) * y.reshape(b, n, d)


class PixArtBlock(nn.Module):
    def __init__(self, cfg: PixArtConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = cfg
        # per-block table added to the shared 6-way modulation
        self.scale_shift_table = nn.Parameter(torch.empty(6, c.hidden_dim))
        self.attn1 = Attention(c.hidden_dim, c.num_attention_heads,
                               c.attention_head_dim, dtype=dtype)
        self.attn2 = Attention(c.hidden_dim, c.num_attention_heads,
                               c.attention_head_dim, dtype=dtype,
                               context_dim=c.hidden_dim)
        self.ff = MLP(c.hidden_dim, mlp_ratio=c.mlp_ratio, dtype=dtype)
        self.resnet_branch = (ResidualConvBranch(
            c.hidden_dim, c.resnet_alpha_init, dtype)
            if c.resnet_expansion else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.scale_shift_table.data, 0.0,
                        self.scale_shift_table.shape[1] ** -0.5,
                        generator=gen)

    def forward(self, x, cond_emb, text_emb, text_mask, ctx_kv=None,
                pag_perturbed: bool = False, deterministic: bool = True,
                hw: Optional[Tuple[int, int]] = None, sp=None):
        """``sp`` (a ``parallel.tensor.SequenceParallel``): ``x`` holds
        this process's slice of the grid's tokens; self-attention gathers
        every process's keys and values, the residual conv branch every
        process's tokens."""
        mod = self.scale_shift_table[None] + cond_emb          # [B, 6, D]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = [
            mod[:, i][:, None, :].to(x.dtype) for i in range(6)]

        h = adaln_layernorm(x, scale_msa, shift_msa)
        h = self.attn1(h, perturbed=pag_perturbed,
                       deterministic=deterministic, sp=sp)
        if self.resnet_branch is not None and sp is not None:
            n = h.shape[1]
            first, end = sp.bounds(n)
            h = self.resnet_branch(sp.gather_kv(h), hw)[:, first:end]
        elif self.resnet_branch is not None:
            h = self.resnet_branch(h, hw)
        x = x + gate_msa * h

        x = x + self.attn2(x, context=text_emb, mask=text_mask,
                           cached_kv=ctx_kv, deterministic=deterministic,
                           sp=sp)

        h = adaln_layernorm(x, scale_mlp, shift_mlp)
        return x + gate_mlp * self.ff(h, deterministic)


class PixArtTransformer2D(nn.Module):
    """The denoiser.  ``forward(latents, text_emb, timesteps, text_mask)``
    → [B, H, W, out_channels] (epsilon, then the learned sigma)."""

    # the caption K/V are constant within a request: sampling may project
    # them once (cross-attention over frozen T5 tokens)
    supports_context_cache = True

    def __init__(self, cfg: PixArtConfig = PixArtConfig(),
                 dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: bool = False, repa: bool = False):
        super().__init__()
        c = cfg
        self.gradient_checkpointing = gradient_checkpointing
        if repa and c.repa_depth is None:
            raise ValueError("a REPA projector needs cfg.repa_depth")
        self.cfg, self.dtype = cfg, dtype
        p = c.patch_size
        self.pos_embed = PatchEmbed(c.in_channels, c.hidden_dim,
                                    patch_size=p, dtype=dtype)
        self.time_embed = TimestepEmbedder(c.hidden_dim, dtype=torch.float32)
        self.time_proj = AdapterDense(c.hidden_dim, 6 * c.hidden_dim,
                                      dtype=torch.float32)
        self.caption_projection = CaptionProjection(c.caption_channels,
                                                    c.hidden_dim, dtype=dtype)
        self.blocks = nn.ModuleList(PixArtBlock(c, dtype=dtype)
                                    for _ in range(c.num_layers))
        self.out_scale_shift_table = nn.Parameter(torch.empty(2, c.hidden_dim))
        self.proj_out = AdapterDense(c.hidden_dim, p * p * c.out_channels,
                                     dtype=dtype)
        self.repa_projector = (RepaProjector(c.hidden_dim,
                                             out_dim=c.repa_target_dim)
                               if repa else None)
        # the sp group (parallel.tensor.SequenceParallel), or None
        self.sequence_parallel = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.out_scale_shift_table.data, 0.0,
                        self.cfg.hidden_dim ** -0.5, generator=gen)

    def pag_layers(self, pag: bool):
        c = self.cfg
        if not pag:
            return set()
        if c.pag_applied_layers is not None:
            return set(c.pag_applied_layers)
        return {c.num_layers // 2}

    def forward(self, latents: Optional[torch.Tensor], text_emb: torch.Tensor,
                timesteps: Optional[torch.Tensor],
                text_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True, return_repa: bool = False,
                pag: bool = False, cached_ctx_kv: Optional[tuple] = None,
                return_ctx_kv: bool = False):
        c = self.cfg
        if return_repa and self.repa_projector is None:
            raise ValueError("return_repa needs a model built with repa=True")
        ctx = self.caption_projection(text_emb.to(self.dtype))
        if return_ctx_kv:
            # per-request context-K/V pass of sampling: the caption
            # projection and every block's attn2 K/V only (latents and
            # timesteps are not read)
            return tuple(blk.attn2.project_kv(ctx, deterministic)
                         for blk in self.blocks)

        b, h, w, _ = latents.shape
        p = c.patch_size
        x = self.pos_embed(latents.to(self.dtype))
        # under sp, this process's slice of the tokens (the JAX
        # constrain_tokens, pixart.py:195-198)
        n, sp = x.shape[1], self.sequence_parallel
        if sp is not None:
            x = sp.shard(x)
            sp = sp if x.shape[1] != n else None
        t_emb = self.time_embed(timesteps)
        cond = self.time_proj(F.silu(t_emb)).reshape(b, 6, c.hidden_dim)

        perturbed = self.pag_layers(pag)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        repa_proj = None
        for i, blk in enumerate(self.blocks):
            args = (x, cond, ctx, text_mask,
                    cached_ctx_kv[i] if cached_ctx_kv is not None else None,
                    i in perturbed, deterministic, (h // p, w // p), sp)
            if remat:
                x = torch.utils.checkpoint.checkpoint(blk, *args,
                                                      use_reentrant=False)
            else:
                x = blk(*args)
            if return_repa and i == c.repa_depth:
                repa_proj = self.repa_projector(
                    (x if sp is None else sp.gather(x, n)).float())

        # diffusers' top-level (2, D) table, modulated by the raw timestep
        # embedding
        out_mod = self.out_scale_shift_table[None] + t_emb[:, None, :]
        shift = out_mod[:, 0][:, None, :].to(x.dtype)
        scale = out_mod[:, 1][:, None, :].to(x.dtype)
        x = self.proj_out(adaln_layernorm(x, scale, shift), deterministic)
        if sp is not None:
            x = sp.gather(x, n)
        out = unpatchify(x, (h, w), p, c.out_channels)
        return (out, repa_proj) if return_repa else out


PIXART_SIGMA_XL2 = PixArtConfig()
PIXART_TINY_TEST = PixArtConfig(hidden_dim=32, num_layers=2,
                                num_attention_heads=2, attention_head_dim=16,
                                caption_channels=16, max_caption_len=8,
                                sample_size=8, mlp_ratio=1.0, repa_depth=0)
