"""Caption encoders: CLIP (SD1.5, SDXL), Gemma-2 (SANA) and T5
(PixArt-Sigma).

Counterpart of ``yat_tpu/models/text_encoders.py``:

* the CLIP text transformer (CLIP-L/14, OpenCLIP-G/14): pre-LayerNorm
  layers with causal attention and a quick-GELU or exact-GELU MLP; the
  hidden states of the final LayerNorm or of the penultimate layer, and
  the pooled vector at each sequence's largest token id (the EOT token in
  CLIP's vocabulary), through the bias-free ``text_projection`` where the
  configuration has one;

* a decoder-only Gemma-2 whose last hidden state is the caption embedding;
  its attention is plain tensor code with a tanh soft-cap on the logits;
* the T5 encoder stack (T5-XXL for PixArt-Sigma): pre-RMSNorm layers,
  attention with a learned relative-position bias and no ``1/sqrt(d)``
  scale, and a gated-gelu FFN.

The three attentions are plain einsums or ``jax.nn.dot_product_attention``
in the JAX package (no Pallas kernel), so they are plain tensor code here
too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yat_tpu_torch.data.sampler import caption_rung
from yat_tpu_torch.models.layers import AdapterDense, Embed, LayerNorm, \
    RMSNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    max_length: int = 77
    # "quick_gelu" for OpenAI CLIP-L, "gelu" for OpenCLIP-G
    act: str = "quick_gelu"
    # the hidden states of the penultimate layer instead of the final LN's
    penultimate: bool = False
    # CLIPTextModelWithProjection: the pooled vector through a bias-free
    # projection of this width
    projection_dim: Optional[int] = None


CLIP_L_14 = CLIPTextConfig()
CLIP_L_14_PROJ = CLIPTextConfig(projection_dim=768)
CLIP_G_14 = CLIPTextConfig(hidden_dim=1280, num_layers=32, num_heads=20,
                           act="gelu", penultimate=True,
                           projection_dim=1280)
CLIP_TINY_TEST = CLIPTextConfig(vocab_size=256, hidden_dim=32, num_layers=2,
                                num_heads=2, max_length=16)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.layer_norm1 = LayerNorm(d, epsilon=1e-5)
        self.q_proj = AdapterDense(d, d, True, dtype)
        self.k_proj = AdapterDense(d, d, True, dtype)
        self.v_proj = AdapterDense(d, d, True, dtype)
        self.out_proj = AdapterDense(d, d, True, dtype)
        self.layer_norm2 = LayerNorm(d, epsilon=1e-5)
        self.fc1 = AdapterDense(d, int(d * cfg.mlp_ratio), True, dtype)
        self.fc2 = AdapterDense(int(d * cfg.mlp_ratio), d, True, dtype)

    def forward(self, x, causal):
        c = self.cfg
        b, n, d = x.shape
        hd = d // c.num_heads
        h = self.layer_norm1(x)
        shape = (b, n, c.num_heads, hd)
        q, k, v = (self.q_proj(h).reshape(shape), self.k_proj(h).reshape(shape),
                   self.v_proj(h).reshape(shape))
        # jax.nn.dot_product_attention: fp32 logits scaled by 1/sqrt(d),
        # the masked logits replaced, softmax, then P.V in the data's dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
        logits = torch.where(causal, logits,
                             torch.finfo(torch.float32).min)
        attn = torch.softmax(logits, -1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, d)
        x = x + self.out_proj(out)
        h = self.fc1(self.layer_norm2(x))
        if c.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h, approximate="none")
        return x + self.fc2(h)


class CLIPTextModel(nn.Module):
    """``forward(input_ids [B, L])`` → ``(hidden [B, L, D], pooled [B, P])``:
    the final LayerNorm's states (or the penultimate layer's, under
    ``penultimate``) and the final LayerNorm's state at each sequence's
    largest token id, projected where ``projection_dim`` is set.  The SD
    and SDXL builders run it in fp32."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_L_14,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_embedding = Embed(cfg.vocab_size, cfg.hidden_dim, dtype)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_length, cfg.hidden_dim))
        self.layers = nn.ModuleList(CLIPLayer(cfg, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_dim, epsilon=1e-5)
        self.text_projection = (
            AdapterDense(cfg.hidden_dim, cfg.projection_dim, False, dtype)
            if cfg.projection_dim is not None else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.position_embedding.data, 0.0, 0.01,
                        generator=gen)

    def forward(self, input_ids: torch.Tensor):
        c = self.cfg
        b, n = input_ids.shape
        x = self.token_embedding(input_ids) + \
            self.position_embedding[:n].to(self.dtype)[None]
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                       device=x.device))[None, None]
        penult = x
        for i, layer in enumerate(self.layers):
            if i == c.num_layers - 1:
                penult = x
            x = layer(x, causal)
        final = self.final_layer_norm(x)
        eot = input_ids.argmax(dim=-1)
        pooled = final[torch.arange(b, device=x.device), eot]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return (penult if c.penultimate else final), pooled


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256000
    hidden_dim: int = 2304          # Gemma-2-2b
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    ffn_dim: int = 9216
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 50.0
    final_logit_softcap: float = 30.0


GEMMA2_2B = GemmaConfig()
GEMMA_TINY_TEST = GemmaConfig(vocab_size=256, hidden_dim=32, num_layers=2,
                              num_heads=2, num_kv_heads=1, head_dim=16,
                              ffn_dim=64)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, N, H, D] with rotary embedding over D (fp32 math)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class GemmaLayer(nn.Module):
    def __init__(self, cfg: GemmaConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = cfg
        self.cfg = cfg
        d = c.hidden_dim
        self.input_norm = RMSNorm(d)
        self.q_proj = AdapterDense(d, c.num_heads * c.head_dim, False, dtype)
        self.k_proj = AdapterDense(d, c.num_kv_heads * c.head_dim, False, dtype)
        self.v_proj = AdapterDense(d, c.num_kv_heads * c.head_dim, False, dtype)
        self.o_proj = AdapterDense(c.num_heads * c.head_dim, d, False, dtype)
        self.post_attn_norm = RMSNorm(d)
        self.pre_ffn_norm = RMSNorm(d)
        self.gate_proj = AdapterDense(d, c.ffn_dim, False, dtype)
        self.up_proj = AdapterDense(d, c.ffn_dim, False, dtype)
        self.down_proj = AdapterDense(c.ffn_dim, d, False, dtype)
        self.post_ffn_norm = RMSNorm(d)

    def forward(self, x, positions, mask):
        c = self.cfg
        b, n, _ = x.shape
        h = self.input_norm(x)
        q = apply_rope(self.q_proj(h).reshape(b, n, c.num_heads, c.head_dim),
                       positions, c.rope_theta)
        k = apply_rope(self.k_proj(h).reshape(b, n, c.num_kv_heads,
                                              c.head_dim),
                       positions, c.rope_theta)
        v = self.v_proj(h).reshape(b, n, c.num_kv_heads, c.head_dim)
        # GQA: repeat kv heads
        rep = c.num_heads // c.num_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (
            c.head_dim ** -0.5)
        if c.attn_logit_softcap:
            logits = torch.tanh(logits / c.attn_logit_softcap) * \
                c.attn_logit_softcap
        logits = torch.where(mask, logits, -1e9)
        attn = torch.softmax(logits, -1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, -1)
        x = x + self.post_attn_norm(self.o_proj(out))

        h = self.pre_ffn_norm(x)
        h = F.gelu(self.gate_proj(h), approximate="tanh") * self.up_proj(h)
        return x + self.post_ffn_norm(self.down_proj(h))


class Gemma2Encoder(nn.Module):
    """Decoder-only Gemma-2 used as a caption encoder (last hidden state),
    the way the SANA pipeline consumes it."""

    def __init__(self, cfg: GemmaConfig = GEMMA2_2B,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_embedding = Embed(cfg.vocab_size, cfg.hidden_dim, dtype)
        self.layers = nn.ModuleList(GemmaLayer(cfg, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        c = self.cfg
        b, n = input_ids.shape
        x = self.token_embedding(input_ids)
        # the JAX package rounds sqrt(D) to the compute dtype first
        x = x * torch.tensor(math.sqrt(c.hidden_dim), dtype=self.dtype,
                             device=x.device)
        positions = torch.arange(n, device=x.device)[None].expand(b, n)
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=x.device))[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        for layer in self.layers:
            x = layer(x, positions, mask)
        return self.final_norm(x)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    hidden_dim: int = 4096          # T5-XXL
    num_layers: int = 24
    num_heads: int = 64
    head_dim: int = 64
    ffn_dim: int = 10240
    relative_buckets: int = 32
    relative_max_distance: int = 128


T5_XXL = T5Config()
T5_TINY_TEST = T5Config(vocab_size=256, hidden_dim=32, num_layers=2,
                        num_heads=2, head_dim=16, ffn_dim=64)


def t5_relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                                max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucket of each relative position (int32), with the
    JAX package's fp32 log arithmetic."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int32) * num_buckets
    n = rel_pos.abs().to(torch.int32)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class _T5Query(AdapterDense):
    """T5's query projection.  T5 folds attention's ``1/sqrt(head_dim)``
    into the query's initialisation (Raffel et al. 2020; Mesh TensorFlow's
    and HF's ``std = (d_model * d_kv)^-0.5``), so random weights here are
    lecun-normal times ``head_dim^-0.5``: with plain lecun-normal, random
    T5-XXL logits have a standard deviation of 8 and its near-argmax
    softmax turns rounding noise into different captions at another batch
    size.  Loaded weights replace it."""

    def __init__(self, d: int, inner: int, head_dim: int, dtype):
        super().__init__(d, inner, False, dtype)
        self.head_dim = head_dim

    def reset_parameters(self, gen: torch.Generator) -> None:
        super().reset_parameters(gen)
        self.weight.data.mul_(self.head_dim ** -0.5)


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        d, inner = c.hidden_dim, c.num_heads * c.head_dim
        self.norm1 = RMSNorm(d)
        self.q = _T5Query(d, inner, c.head_dim, dtype)
        self.k = AdapterDense(d, inner, False, dtype)
        self.v = AdapterDense(d, inner, False, dtype)
        self.o = AdapterDense(inner, d, False, dtype)
        self.norm2 = RMSNorm(d)
        self.wi_0 = AdapterDense(d, c.ffn_dim, False, dtype)
        self.wi_1 = AdapterDense(d, c.ffn_dim, False, dtype)
        self.wo = AdapterDense(c.ffn_dim, d, False, dtype)

    def forward(self, x, pos_bias, mask):
        c = self.cfg
        b, n, _ = x.shape
        h = self.norm1(x)
        shape = (b, n, c.num_heads, c.head_dim)
        q, k, v = (self.q(h).reshape(shape), self.k(h).reshape(shape),
                   self.v(h).reshape(shape))
        # no 1/sqrt(d): the position bias carries the scale
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + pos_bias
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits, -1e9)
        attn = torch.softmax(logits, -1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, -1)
        x = x + self.o(out)
        h = self.norm2(x)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h)


class T5Encoder(nn.Module):
    """The T5 encoder stack; its final RMS-normed hidden state is the
    caption embedding."""

    def __init__(self, cfg: T5Config = T5_XXL,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_embedding = Embed(cfg.vocab_size, cfg.hidden_dim, dtype)
        self.relative_attention_bias = nn.Parameter(
            torch.empty(cfg.relative_buckets, cfg.num_heads))
        self.layers = nn.ModuleList(T5Layer(cfg, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.relative_attention_bias.data, 0.0, 0.1,
                        generator=gen)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        c = self.cfg
        n = input_ids.shape[1]
        x = self.token_embedding(input_ids)
        pos = torch.arange(n, device=x.device)
        buckets = t5_relative_position_bucket(
            pos[None, :] - pos[:, None], c.relative_buckets,
            c.relative_max_distance)
        table = self.relative_attention_bias.float()
        pos_bias = table[buckets].permute(2, 0, 1)[None]     # [1, H, N, N]
        mask = attention_mask.bool() if attention_mask is not None else None
        for layer in self.layers:
            x = layer(x, pos_bias, mask)
        return self.final_norm(x)


def compress_embeddings(hidden: torch.Tensor, mask) -> List[np.ndarray]:
    """Mask-compress per-sample embeddings to their real lengths: a list of
    fp32 ``[L_i, D]`` host arrays.  Only the 64-token rung covering the
    longest real caption leaves the device."""
    mask_np = np.asarray(mask).astype(bool)
    real = int(mask_np.sum(axis=1).max()) if mask_np.any() else 1
    rung = caption_rung(real, hidden.shape[1])
    if rung < hidden.shape[1]:
        hidden = hidden[:, :rung]
        mask_np = mask_np[:, :rung]
    host = hidden.float().cpu().numpy()
    return [host[i][mask_np[i]] for i in range(host.shape[0])]
