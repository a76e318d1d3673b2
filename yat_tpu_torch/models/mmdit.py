"""MMDiT: the SD3.5 flow-matching backbone (dual-stream joint attention).

Counterpart of ``yat_tpu/models/mmdit.py`` (diffusers
``SD3Transformer2DModel``): patch-2 embedding of 16-channel VAE latents
plus a 2-D sin-cos position table; the text stream is the joined CLIP and
T5 states projected to the model's width; the conditioning vector is the
timestep embedding plus the projected pooled text (fp32); N dual-stream
blocks whose image and text tokens carry their own QKV, output and MLP
weights but attend jointly over ``[text; image]``, with AdaLN-zero
modulation per stream; the text stream is dropped after the last block.
MMDiT-X blocks (SD3.5-medium's 0-12, ``dual_attention_layers``) carry a
second image-only self-attention off the same norm output, with 9
modulation chunks.  The last block's text modulation is diffusers'
``AdaLayerNormContinuous``: 2 chunks, (scale, shift), no gates; the final
modulation is (scale, shift) too.

Kernels on CUDA: every attention (24 joint calls over ``4096 + n_ctx``
tokens and 13 image-only calls over 4096 tokens a forward at 1024 px) runs
K6 forward and K6b backward through ``ops.attention.flash_attention``,
where the JAX package runs ``jax.nn.dot_product_attention`` (a deliberate
divergence: the plain arithmetic builds ``[B, 24, 4429, 4429]`` fp32
scores).  The second norms of each stream and the final norm are
``adaln_layernorm``, K1 forward and K1b backward: 48 calls a forward at
SD3.5-medium's depth (:func:`kernel_calls` lists them).  The first norms
are the affine-free ``LayerNorm`` with the modulation in plain code, as in
the JAX package.  No mask: the JAX MMDiT takes ``text_mask`` and never
reads it, so caption padding is attended.

The position table is the published one (diffusers' SD3 ``PatchEmbed``:
a ``pos_embed_max_size``-square sin-cos table on a grid scaled by
``SAMPLE_SIZE // patch_size / pos_embed_max_size``, its first half
encoding the column, centre-cropped to the latent grid), where the JAX
package starts an unscaled grid at 0 with the row half first
(ROADMAP §3, a reference fault).

With ``gradient_checkpointing`` each block runs under
``torch.utils.checkpoint`` (non-reentrant; the JAX ``nn.remat``) while
gradients are recorded: its forward runs again in the backward, so the
forward kernels launch twice per block and the recomputed K6 saves its
row statistics again for K6b.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from yat_tpu_torch.models.layers import (
    MLP,
    AdapterDense,
    LayerNorm,
    PatchEmbed,
    RMSNorm,
    TimestepEmbedder,
    ZeroDense,
    pair_joint_heads,
    unpatchify,
)
from yat_tpu_torch.ops.attention import flash_attention
from yat_tpu_torch.ops.norm import adaln_layernorm


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """SD3.5-medium-like defaults (scale via presets)."""

    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    hidden_dim: int = 1536
    num_layers: int = 24
    num_heads: int = 24
    caption_dim: int = 4096          # T5 + padded CLIP joint embedding
    pooled_dim: int = 2048           # CLIP-L + CLIP-G pooled concat
    mlp_ratio: float = 4.0
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = "rms"
    max_caption_len: int = 333       # 256 T5 + 77 CLIP
    # MMDiT-X (SD3.5-medium): these blocks carry a second image-stream
    # self-attention with 9 modulation chunks
    dual_attention_layers: Tuple[int, ...] = ()


SD35_MEDIUM = MMDiTConfig(dual_attention_layers=tuple(range(13)))
SD35_LARGE = MMDiTConfig(hidden_dim=2432, num_layers=38, num_heads=38)
# diffusers' ``sample_size`` of the published SD3 configurations: the
# position grid's scale is ``SAMPLE_SIZE // patch_size`` over
# ``pos_embed_max_size``
SAMPLE_SIZE = 128
MMDIT_TINY_TEST = MMDiTConfig(hidden_dim=32, num_layers=2, num_heads=2,
                              caption_dim=16, pooled_dim=16,
                              max_caption_len=8, mlp_ratio=1.0)


def _sincos_1d(pos: np.ndarray, dim: int) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000.0 ** omega
    out = np.outer(pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed_2d(h: int, w: int, dim: int, max_size: int = 192,
                 base_size: int = 64) -> torch.Tensor:
    """The published SD3 position table for an ``h`` x ``w`` token grid,
    fp32 ``[h*w, dim]``: diffusers' ``get_2d_sincos_pos_embed`` on the
    ``max_size`` square grid whose coordinates are ``i * base_size /
    max_size`` (the first half of each row encodes the column, the second
    the row; sin before cos), centre-cropped to ``h`` x ``w`` as
    ``PatchEmbed.cropped_pos_embed`` does."""
    if h > max_size or w > max_size:
        raise ValueError(f"a {h}x{w} token grid exceeds pos_embed_max_size "
                         f"{max_size}")
    coords = np.arange(max_size, dtype=np.float32) / np.float32(
        max_size / base_size)
    top, left = (max_size - h) // 2, (max_size - w) // 2
    rows = np.repeat(coords[top:top + h], w)
    cols = np.tile(coords[left:left + w], h)
    table = np.concatenate([_sincos_1d(cols, dim // 2),
                            _sincos_1d(rows, dim // 2)], axis=1)
    return torch.from_numpy(table.astype(np.float32))


class StreamModulation(nn.Module):
    """AdaLN-zero: conditioning → ``n_mods`` chunks ``[B, 1, D]`` (fp32)."""

    def __init__(self, hidden_dim: int, n_mods: int = 6):
        super().__init__()
        self.n_mods = n_mods
        self.mod = ZeroDense(hidden_dim, n_mods * hidden_dim,
                              dtype=torch.float32)

    def forward(self, cond: torch.Tensor) -> List[torch.Tensor]:
        m = self.mod(F.silu(cond))
        return list(m[:, None, :].chunk(self.n_mods, dim=-1))


class MMDiTBlock(nn.Module):
    """One dual-stream block; ``last`` drops the text stream's output,
    ``dual`` adds the MMDiT-X image self-attention (``x2_*``)."""

    def __init__(self, cfg: MMDiTConfig, last: bool = False,
                 dual: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = cfg
        self.cfg, self.last, self.dual = cfg, last, dual
        d, hd = c.hidden_dim, c.hidden_dim // c.num_heads
        if c.qk_norm not in (None, "rms"):
            raise ValueError(f"MMDiT takes qk_norm None or 'rms', got "
                             f"{c.qk_norm!r}")
        self.x_mod = StreamModulation(d, 9 if dual else 6)
        self.c_mod = StreamModulation(d, 2 if last else 6)
        for tag in ("x", "c") + (("x2",) if dual else ()):
            for name in ("to_q", "to_k", "to_v"):
                setattr(self, f"{tag}_{name}", AdapterDense(d, d, dtype=dtype))
            if c.qk_norm == "rms":
                setattr(self, f"{tag}_norm_q", RMSNorm(hd))
                setattr(self, f"{tag}_norm_k", RMSNorm(hd))
        self.x_norm1 = LayerNorm(d, use_scale=False, use_bias=False)
        self.c_norm1 = LayerNorm(d, use_scale=False, use_bias=False)
        self.x_to_out = AdapterDense(d, d, dtype=dtype)
        if dual:
            self.x2_to_out = AdapterDense(d, d, dtype=dtype)
        self.x_ff = MLP(d, mlp_ratio=c.mlp_ratio, dtype=dtype)
        if not last:
            self.c_to_out = AdapterDense(d, d, dtype=dtype)
            self.c_ff = MLP(d, mlp_ratio=c.mlp_ratio, dtype=dtype)

    def tensor_parallel(self, size: int, rank: int) -> None:
        """Every stream's attention on this process's heads (the joint
        attention needs the same heads in both) when the tp rule split
        them all."""
        c = self.cfg
        tags = ("x", "c") + (("x2",) if self.dual else ())
        cols = [getattr(self, f"{t}_to_{n}") for t in tags for n in "qkv"]
        rows = [getattr(self, f"{t}_to_out") for t in tags
                if hasattr(self, f"{t}_to_out")]
        norms = [getattr(self, f"{t}_norm_{n}") for t in tags for n in "qk"
                 if hasattr(self, f"{t}_norm_{n}")]
        pair_joint_heads(cols, rows, norms, c.num_heads,
                         c.hidden_dim // c.num_heads, size, rank)

    def _qkv(self, h, tag, det):
        c = self.cfg
        b, n, _ = h.shape
        hd = c.hidden_dim // c.num_heads
        out = []
        for name in ("q", "k", "v"):
            t = getattr(self, f"{tag}_to_{name}")(h, det)
            # this process's heads under a tp pair
            t = t.reshape(b, n, -1, hd)
            if c.qk_norm == "rms" and name != "v":
                t = getattr(self, f"{tag}_norm_{name}")(t)
            out.append(t)
        return out

    def forward(self, x, ctx, cond, deterministic: bool = True):
        c, det, dt = self.cfg, deterministic, x.dtype
        b, n_c = x.shape[0], ctx.shape[1]
        mods_x = self.x_mod(cond)
        sx_shift, sx_scale, sx_gate, mx_shift, mx_scale, mx_gate = mods_x[:6]
        if self.last:
            sc_scale, sc_shift = self.c_mod(cond)
        else:
            (sc_shift, sc_scale, sc_gate, mc_shift, mc_scale,
             mc_gate) = self.c_mod(cond)

        nx = self.x_norm1(x)
        hx = nx * (1 + sx_scale.to(dt)) + sx_shift.to(dt)
        hc = self.c_norm1(ctx) * (1 + sc_scale.to(dt)) + sc_shift.to(dt)
        qx, kx, vx = self._qkv(hx, "x", det)
        qc, kc, vc = self._qkv(hc, "c", det)
        # joint attention over the [text; image] concatenation
        attn = flash_attention(torch.cat([qc, qx], 1), torch.cat([kc, kx], 1),
                               torch.cat([vc, vx], 1))
        attn = attn.reshape(b, attn.shape[1], -1)
        attn_c, attn_x = attn[:, :n_c], attn[:, n_c:]

        x = x + sx_gate.to(dt) * self.x_to_out(attn_x, det)
        if self.dual:
            # the second image-only self-attention off the same norm output
            s2_shift, s2_scale, s2_gate = mods_x[6:]
            hx2 = nx * (1 + s2_scale.to(dt)) + s2_shift.to(dt)
            a2 = flash_attention(*self._qkv(hx2, "x2", det))
            a2 = a2.reshape(b, a2.shape[1], -1)
            x = x + s2_gate.to(dt) * self.x2_to_out(a2, det)
        hx = adaln_layernorm(x, mx_scale, mx_shift)
        x = x + mx_gate.to(dt) * self.x_ff(hx, det)
        if self.last:
            return x, None
        ctx = ctx + sc_gate.to(dt) * self.c_to_out(attn_c, det)
        hc = adaln_layernorm(ctx, mc_scale, mc_shift)
        ctx = ctx + mc_gate.to(dt) * self.c_ff(hc, det)
        return x, ctx


class MMDiT(nn.Module):
    """The denoiser.  ``forward(latents, text_emb, timesteps, text_mask,
    pooled_text=...)`` → the velocity ``[B, H, W, out_channels]``; latents
    NHWC, ``text_emb`` ``[B, L, caption_dim]``, ``pooled_text``
    ``[B, pooled_dim]`` (zeros when None); ``text_mask`` is not read."""

    # the joint attention rewrites the caption stream in every block: no
    # per-request caption K/V to cache
    supports_context_cache = False

    def __init__(self, cfg: MMDiTConfig = SD35_MEDIUM,
                 dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        self.gradient_checkpointing = gradient_checkpointing
        d, p = c.hidden_dim, c.patch_size
        self.patch_embed = PatchEmbed(c.in_channels, d, patch_size=p,
                                      dtype=dtype)
        self.time_embed = TimestepEmbedder(d, dtype=torch.float32)
        self.pool_linear_1 = AdapterDense(c.pooled_dim, d,
                                          dtype=torch.float32)
        self.pool_linear_2 = AdapterDense(d, d, dtype=torch.float32)
        self.context_embedder = AdapterDense(c.caption_dim, d, dtype=dtype)
        self.blocks = nn.ModuleList(
            MMDiTBlock(c, last=(i == c.num_layers - 1),
                       dual=(i in c.dual_attention_layers), dtype=dtype)
            for i in range(c.num_layers))
        self.final_mod = ZeroDense(d, 2 * d, dtype=torch.float32)
        self.proj_out = AdapterDense(d, p * p * c.out_channels, dtype=dtype)
        # the position table by (grid, device), made once
        self._pos: Dict[tuple, torch.Tensor] = {}

    def pos_table(self, gh: int, gw: int, device) -> torch.Tensor:
        c = self.cfg
        key = (gh, gw, str(device))
        if key not in self._pos:
            self._pos[key] = pos_embed_2d(
                gh, gw, c.hidden_dim, c.pos_embed_max_size,
                SAMPLE_SIZE // c.patch_size).to(device)
        return self._pos[key]

    def forward(self, latents: torch.Tensor, text_emb: torch.Tensor,
                timesteps: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None, *,
                pooled_text: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        c = self.cfg
        b, h, w, _ = latents.shape
        p = c.patch_size
        x = self.patch_embed(latents.to(self.dtype))
        x = x + self.pos_table(h // p, w // p, x.device)[None].to(x.dtype)
        t_emb = self.time_embed(timesteps)
        if pooled_text is None:
            pooled_text = torch.zeros((b, c.pooled_dim), dtype=torch.float32,
                                      device=latents.device)
        pool = self.pool_linear_1(pooled_text.float())
        cond = t_emb + self.pool_linear_2(F.silu(pool))
        ctx = self.context_embedder(text_emb.to(self.dtype))

        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x, ctx = torch.utils.checkpoint.checkpoint(
                    blk, x, ctx, cond, deterministic, use_reentrant=False)
            else:
                x, ctx = blk(x, ctx, cond, deterministic)

        # diffusers' AdaLayerNormContinuous: (scale, shift)
        scale, shift = self.final_mod(F.silu(cond))[:, None, :].chunk(2, -1)
        x = self.proj_out(adaln_layernorm(x, scale, shift), deterministic)
        return unpatchify(x, (h, w), p, c.out_channels)


def kernel_calls(cfg: MMDiTConfig, h: int, w: int, n_ctx: int,
                 batch: int = 1) -> Dict[str, List[tuple]]:
    """The kernel calls of one forward on ``batch`` latents of ``h`` x
    ``w`` with ``n_ctx`` caption tokens, in the order they run:
    ``flash_attention`` q/k/v shapes ``[B, N, H, D]`` (each block's joint
    attention over ``n_ctx + h*w/p^2`` tokens, then, in a dual block, its
    image-only one) and ``adaln_layernorm`` x shapes ``[B, N, D]`` (each
    block's image stream, then its text stream but in the last block, then
    the final norm)."""
    c = cfg
    n_img = (h // c.patch_size) * (w // c.patch_size)
    hd = c.hidden_dim // c.num_heads
    attn, norms = [], []
    for i in range(c.num_layers):
        attn.append((batch, n_ctx + n_img, c.num_heads, hd))
        if i in c.dual_attention_layers:
            attn.append((batch, n_img, c.num_heads, hd))
        norms.append((batch, n_img, c.hidden_dim))
        if i < c.num_layers - 1:
            norms.append((batch, n_ctx, c.hidden_dim))
    norms.append((batch, n_img, c.hidden_dim))
    return {"flash_attention": attn, "adaln_layernorm": norms}
