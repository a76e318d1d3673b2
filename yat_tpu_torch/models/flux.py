"""Flux-2 Klein: the flow-matching transformer on packed 2x2 latent patches.

Counterpart of ``yat_tpu/models/flux.py``: 16-channel KL-VAE latents are
patchified 2x2 into 64-channel tokens (standardized only when batch-norm
statistics are given: the frontends give none), packed into a sequence
and given 3-D rotary ids (caption index, y, x); N *double-stream* blocks
(image and caption tokens with their own weights, attending jointly over
``[caption; image]``) are followed by M *single-stream* blocks over the
concatenation (one fused q/k/v/MLP projection, attention and the
tanh-GELU MLP in parallel, one fused output projection); the
conditioning is the timestep embedding (plus the guidance embedding),
and the timesteps come in as ``t / 1000`` (the model multiplies by 1000).
RoPE rotates interleaved (even, odd) pairs in fp32.

Kernels on CUDA: every attention (8 double and 16 single blocks: 24
calls a forward over ``n_txt + h*w`` tokens, 24 heads of 128 at full
width) runs K6 forward and K6b backward through
``ops.attention.flash_attention``, where the JAX package calls
``jax.nn.dot_product_attention`` (a deliberate divergence: the plain
arithmetic builds ``[B, 24, 4608, 4608]`` fp32 scores at 1024 px).  No
mask: the caption padding is attended, as in the JAX package.  Every
norm with modulation is ``adaln_layernorm``, K1 forward and K1b
backward: 4 a double block, 1 a single block and the final one, 49 a
forward (:func:`kernel_calls` lists them).

The modulation layers start at zero (flax ``zeros_init``), so a random
model's blocks add nothing until they are trained or loaded.  With
``gradient_checkpointing`` each block runs under
``torch.utils.checkpoint`` (non-reentrant; the JAX ``nn.remat``) while
gradients are recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from yat_tpu_torch.models.layers import (AdapterDense, RMSNorm,
                                         TimestepEmbedder, ZeroDense,
                                         pair_joint_heads)
from yat_tpu_torch.ops.attention import flash_attention
from yat_tpu_torch.ops.norm import adaln_layernorm


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64            # 16 VAE channels x 2x2 patch
    hidden_dim: int = 3072
    num_double_blocks: int = 8       # Klein is the distilled small variant
    num_single_blocks: int = 16
    num_heads: int = 24
    mlp_ratio: float = 4.0
    text_dim: int = 4096
    axes_dims: Tuple[int, ...] = (16, 56, 56)   # rope split: (idx, y, x)
    guidance_embed: bool = True
    theta: float = 10000.0


FLUX2_KLEIN = FluxConfig()
FLUX_TINY_TEST = FluxConfig(in_channels=16, hidden_dim=32,
                            num_double_blocks=1, num_single_blocks=1,
                            num_heads=2, text_dim=16, axes_dims=(4, 6, 6))


# ---------------------------------------------------------------------------
# latent packing
# ---------------------------------------------------------------------------

def patchify_latents(latents: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` → ``[B, H/2, W/2, 4C]`` (2x2 space-to-depth)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def unpatchify_latents(x: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, 4C]`` → ``[B, 2h, 2w, C]``."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * 2, w * 2, c)


def standardize_latents(x: torch.Tensor, mean: torch.Tensor,
                        var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm-style standardization with running statistics."""
    return (x - mean) * torch.rsqrt(var + eps)


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, C]`` grid → ``[B, h*w, C]`` token sequence."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def unpack_latents(tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    b, _, c = tokens.shape
    return tokens.reshape(b, hw[0], hw[1], c)


def latent_ids(h: int, w: int, device=None) -> torch.Tensor:
    """``[h*w, 3]`` rotary ids ``(0, y, x)``, row-major."""
    ys = torch.arange(h, device=device).repeat_interleave(w)
    xs = torch.arange(w, device=device).repeat(h)
    return torch.stack([torch.zeros_like(ys), ys, xs], dim=-1)


def text_ids(n: int, device=None) -> torch.Tensor:
    return torch.zeros((n, 3), dtype=torch.int64, device=device)


def rope_freqs(ids: torch.Tensor, axes_dims: Sequence[int],
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids ``[N, 3]`` → (cos, sin), each fp32 ``[N, sum(axes_dims) / 2]``."""
    cos, sin = [], []
    for i, d in enumerate(axes_dims):
        pos = ids[:, i].float()
        freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                       device=ids.device) / d)
        ang = pos[:, None] * freq[None, :]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope_pairs(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, N, H, D]`` rotated pairwise (even/odd interleave), in fp32,
    back in x's dtype."""
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class Modulation(nn.Module):
    """Conditioning → ``n`` chunks ``[B, 1, D]`` (fp32, zero-initialised)."""

    def __init__(self, hidden_dim: int, n: int):
        super().__init__()
        self.n = n
        self.lin = ZeroDense(hidden_dim, n * hidden_dim, dtype=torch.float32)

    def forward(self, cond: torch.Tensor) -> List[torch.Tensor]:
        return list(self.lin(F.silu(cond))[:, None, :].chunk(self.n, dim=-1))


def _heads(t: torch.Tensor, cfg: FluxConfig) -> torch.Tensor:
    """[B, N, H·D] → [B, N, H, D] (H: this process's heads under a tp
    pair)."""
    b, n, _ = t.shape
    return t.reshape(b, n, -1, cfg.hidden_dim // cfg.num_heads)


class FluxDoubleBlock(nn.Module):
    """Image and caption streams with their own weights and modulation,
    one joint attention over ``[caption; image]``."""

    def __init__(self, cfg: FluxConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_dim, cfg.hidden_dim // cfg.num_heads
        mlp = int(d * cfg.mlp_ratio)
        self.img_mod = Modulation(d, 6)
        self.txt_mod = Modulation(d, 6)
        for tag in ("img", "txt"):
            for name in ("to_q", "to_k", "to_v", "to_out"):
                setattr(self, f"{tag}_{name}", AdapterDense(d, d, dtype=dtype))
            setattr(self, f"{tag}_norm_q", RMSNorm(hd))
            setattr(self, f"{tag}_norm_k", RMSNorm(hd))
            setattr(self, f"{tag}_ff_1", AdapterDense(d, mlp, dtype=dtype))
            setattr(self, f"{tag}_ff_2", AdapterDense(mlp, d, dtype=dtype))

    def tensor_parallel(self, size: int, rank: int) -> None:
        """Both streams' attention on this process's heads (the joint
        attention needs the same heads in both) when the tp rule split
        them all."""
        c = self.cfg
        tags = ("img", "txt")
        pair_joint_heads(
            [getattr(self, f"{t}_to_{n}") for t in tags for n in "qkv"],
            [getattr(self, f"{t}_to_out") for t in tags],
            [getattr(self, f"{t}_norm_{n}") for t in tags for n in "qk"],
            c.num_heads, c.hidden_dim // c.num_heads, size, rank)

    def _qkv(self, h, tag, det):
        q, k, v = (_heads(getattr(self, f"{tag}_to_{n}")(h, det), self.cfg)
                   for n in "qkv")
        return (getattr(self, f"{tag}_norm_q")(q),
                getattr(self, f"{tag}_norm_k")(k), v)

    def _ff(self, h, tag, det):
        ff = getattr(self, f"{tag}_ff_1")(h, det)
        return getattr(self, f"{tag}_ff_2")(F.gelu(ff, approximate="tanh"),
                                           det)

    def forward(self, img, txt, cond, cos, sin, deterministic: bool = True):
        c, det, dt = self.cfg, deterministic, img.dtype
        n_txt = txt.shape[1]
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(cond)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(cond)
        qi, ki, vi = self._qkv(adaln_layernorm(img, i_sc1, i_sh1), "img", det)
        qt, kt, vt = self._qkv(adaln_layernorm(txt, t_sc1, t_sh1), "txt", det)
        q = apply_rope_pairs(torch.cat([qt, qi], 1), cos, sin)
        k = apply_rope_pairs(torch.cat([kt, ki], 1), cos, sin)
        attn = flash_attention(q, k, torch.cat([vt, vi], 1))
        attn = attn.reshape(img.shape[0], attn.shape[1], -1)
        a_txt, a_img = attn[:, :n_txt], attn[:, n_txt:]

        img = img + i_g1.to(dt) * self.img_to_out(a_img, det)
        img = img + i_g2.to(dt) * self._ff(
            adaln_layernorm(img, i_sc2, i_sh2), "img", det)
        txt = txt + t_g1.to(dt) * self.txt_to_out(a_txt, det)
        txt = txt + t_g2.to(dt) * self._ff(
            adaln_layernorm(txt, t_sc2, t_sh2), "txt", det)
        return img, txt


class FluxSingleBlock(nn.Module):
    """The fused single-stream block: q/k/v and the MLP's input in one
    projection (``linear1``), attention and the tanh-GELU MLP side by side,
    one output projection (``linear2``)."""

    def __init__(self, cfg: FluxConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_dim, cfg.hidden_dim // cfg.num_heads
        self.mlp_dim = int(d * cfg.mlp_ratio)
        self.mod = Modulation(d, 3)
        self.linear1 = AdapterDense(d, 3 * d + self.mlp_dim, dtype=dtype)
        self.norm_q = RMSNorm(hd)
        self.norm_k = RMSNorm(hd)
        self.linear2 = AdapterDense(d + self.mlp_dim, d, dtype=dtype)

    def forward(self, x, cond, cos, sin, deterministic: bool = True):
        c, det = self.cfg, deterministic
        d = c.hidden_dim
        sh, sc, gate = self.mod(cond)
        fused = self.linear1(adaln_layernorm(x, sc, sh), det)
        q, k, v, mlp = fused.split([d, d, d, self.mlp_dim], dim=-1)
        q = apply_rope_pairs(self.norm_q(_heads(q, c)), cos, sin)
        k = apply_rope_pairs(self.norm_k(_heads(k, c)), cos, sin)
        attn = flash_attention(q, k, _heads(v, c))
        attn = attn.reshape(x.shape[0], x.shape[1], d)
        out = self.linear2(torch.cat(
            [attn, F.gelu(mlp, approximate="tanh")], -1), det)
        return x + gate.to(x.dtype) * out


class FluxTransformer(nn.Module):
    """The denoiser.  ``forward(packed, text_emb, timesteps, img_ids,
    txt_ids=None, guidance=...)`` → the velocity ``[B, N_img,
    in_channels]``; ``timesteps`` in ``[0, 1]`` (``t / 1000``), the guidance
    ones when None."""

    def __init__(self, cfg: FluxConfig = FLUX2_KLEIN,
                 dtype: torch.dtype = torch.bfloat16,
                 gradient_checkpointing: bool = False):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        self.gradient_checkpointing = gradient_checkpointing
        d = c.hidden_dim
        self.img_in = AdapterDense(c.in_channels, d, dtype=dtype)
        self.txt_in = AdapterDense(c.text_dim, d, dtype=dtype)
        self.time_embed = TimestepEmbedder(d, dtype=torch.float32)
        if c.guidance_embed:
            self.guidance_embed = TimestepEmbedder(d, dtype=torch.float32)
        for i in range(c.num_double_blocks):
            setattr(self, f"double_{i}", FluxDoubleBlock(c, dtype))
        for i in range(c.num_single_blocks):
            setattr(self, f"single_{i}", FluxSingleBlock(c, dtype))
        self.final_mod = ZeroDense(d, 2 * d, dtype=torch.float32)
        self.proj_out = AdapterDense(d, c.in_channels, dtype=dtype)

    def forward(self, packed_latents: torch.Tensor, text_emb: torch.Tensor,
                timesteps: torch.Tensor, img_ids: torch.Tensor,
                txt_ids: Optional[torch.Tensor] = None, *,
                guidance: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        c = self.cfg
        b = packed_latents.shape[0]
        n_txt = text_emb.shape[1]
        img = self.img_in(packed_latents.to(self.dtype), deterministic)
        txt = self.txt_in(text_emb.to(self.dtype), deterministic)
        cond = self.time_embed(timesteps.float() * 1000.0)
        if c.guidance_embed:
            g = guidance if guidance is not None else torch.ones(
                (b,), dtype=torch.float32, device=packed_latents.device)
            cond = cond + self.guidance_embed(g.float() * 1000.0)
        if txt_ids is None:
            txt_ids = text_ids(n_txt, img_ids.device)
        cos, sin = rope_freqs(torch.cat([txt_ids, img_ids.to(txt_ids.dtype)],
                                        0), c.axes_dims, c.theta)

        remat = self.gradient_checkpointing and torch.is_grad_enabled()

        def run(blk, *args):
            if remat:
                return torch.utils.checkpoint.checkpoint(
                    blk, *args, deterministic, use_reentrant=False)
            return blk(*args, deterministic)

        for i in range(c.num_double_blocks):
            img, txt = run(getattr(self, f"double_{i}"), img, txt, cond, cos,
                           sin)
        x = torch.cat([txt, img], 1)
        for i in range(c.num_single_blocks):
            x = run(getattr(self, f"single_{i}"), x, cond, cos, sin)
        x = x[:, n_txt:]
        # diffusers' AdaLayerNormContinuous: (scale, shift)
        scale, shift = self.final_mod(F.silu(cond))[:, None, :].chunk(2, -1)
        return self.proj_out(adaln_layernorm(x, scale, shift), deterministic)


def kernel_calls(cfg: FluxConfig, gh: int, gw: int, n_txt: int,
                 batch: int = 1) -> Dict[str, List[tuple]]:
    """The kernel calls of one forward on ``batch`` token grids of ``gh`` x
    ``gw`` with ``n_txt`` caption tokens, in the order they run:
    ``flash_attention`` q/k/v shapes ``[B, N, H, D]`` (every block's
    attention over ``n_txt + gh*gw`` tokens) and ``adaln_layernorm`` x
    shapes ``[B, N, D]`` (each double block's image and caption first
    norms, then its image and caption second norms; each single block's
    norm over the whole sequence; the final norm on the image tokens)."""
    c = cfg
    n_img = gh * gw
    hd = c.hidden_dim // c.num_heads
    n_blocks = c.num_double_blocks + c.num_single_blocks
    attn = [(batch, n_txt + n_img, c.num_heads, hd)] * n_blocks
    img, txt = (batch, n_img, c.hidden_dim), (batch, n_txt, c.hidden_dim)
    norms = [img, txt, img, txt] * c.num_double_blocks
    norms += [(batch, n_txt + n_img, c.hidden_dim)] * c.num_single_blocks
    norms.append(img)
    return {"flash_attention": attn, "adaln_layernorm": norms}
