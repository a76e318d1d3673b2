"""Autoencoders: SD's AutoencoderKL (8x, PixArt-Sigma) and DC-AE (32x,
SANA), both halves (serving builds the decoder alone: ``encoder=False``).

Counterpart of ``yat_tpu/models/vae.py``:

* ``AutoencoderKL``: the SD structure one to one (conv stem, down stages
  of resnets with a stride-2 conv padded on the bottom and right, up
  stages of resnets with nearest x2 upsampling, mid blocks of two resnets
  around a single-head attention over the latent grid), flax
  ``nn.GroupNorm`` semantics (32 groups, eps 1e-6, the one-pass variance);
  ``encode`` gives the mean and the log-variance clipped to [-30, 20],
  ``encode_mode`` the mean, shifted where the config has a shift, times
  the scaling factor;
* DC-AE (weight-compatible with diffusers ``AutoencoderDC``): conv stem,
  ResBlock stages, EfficientViT stages (multiscale ReLU linear attention +
  gated GLUMBConv, both residual with a trailing channel RMSNorm),
  pixel-unshuffle downsampling with the channel-group-mean shortcut and
  pixel-shuffle upsampling with the channel-duplication shortcut;
  ``encode_mode`` is the encoder's output times the scaling factor.

The VAEs always run in fp32, with TF32 off on the card (the entry points'
``device.resolve_device`` turns it off for matmuls and cuDNN's
convolutions); their attentions are plain tensor code, as in
the JAX package (no Pallas kernel there, so no kernel of the port here).
Tensors are NHWC at every module boundary.  ``decode_tiled`` decodes in
overlapping latent tiles, feathered together (``low_vram`` and 2048 px).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yat_tpu_torch.models.layers import AdapterDense, Conv2d


# ---------------------------------------------------------------------------
# AutoencoderKL (SD 8x)
# ---------------------------------------------------------------------------

class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NHWC fp32: statistics per (batch, group)
    over the grid and the group's channels, ``var = E[x^2] - E[x]^2``
    clipped at 0, ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, channels: int, num_groups: int = 32,
                 epsilon: float = 1e-6):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(b, -1, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.reshape(
            1, 1, g, c // g)
        y = (xg - mean) * mul + self.bias.reshape(1, 1, g, c // g)
        return y.reshape(x.shape)


class ResnetBlock(nn.Module):
    """GroupNorm → silu → conv3x3, twice, plus the input (through a 1x1
    conv when the width changes)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full attention over the spatial grid (the mid block)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.group_norm = GroupNorm(c)
        f32 = torch.float32
        self.to_q = AdapterDense(c, c, True, f32)
        self.to_k = AdapterDense(c, c, True, f32)
        self.to_v = AdapterDense(c, c, True, f32)
        self.to_out = AdapterDense(c, c, True, f32)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax((q @ k.transpose(1, 2)).float()
                             / torch.sqrt(torch.tensor(float(c))), -1)
        y = self.to_out(attn.to(v.dtype) @ v)
        return x + y.reshape(b, h, w, c)


@dataclasses.dataclass(frozen=True)
class KLVAEConfig:
    """SD1.5/SDXL defaults; scaling_factor 0.18215 (SD15) / 0.13025 (SDXL)."""

    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    shift_factor: Optional[float] = None    # SD3/Flux VAEs use a shift

    @property
    def compression(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class KLEncoder(nn.Module):
    def __init__(self, cfg: KLVAEConfig):
        super().__init__()
        c = cfg
        ch = c.block_out_channels
        self.conv_in = Conv2d(c.in_channels, ch[0], 3)
        # flax names: down_{i}_resnet_{j}, then down_{i}_downsample
        self.stages = []
        ch_in = ch[0]
        for i, out in enumerate(ch):
            names = []
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}",
                                ResnetBlock(ch_in, out))
                names.append(f"down_{i}_resnet_{j}")
                ch_in = out
            if i < len(ch) - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv2d(out, out, 3, stride=2, padding=(0, 1)))
                names.append(f"down_{i}_downsample")
            self.stages.append(names)
        self.mid_resnet_0 = ResnetBlock(ch[-1], ch[-1])
        self.mid_attn = AttnBlock(ch[-1])
        self.mid_resnet_1 = ResnetBlock(ch[-1], ch[-1])
        self.conv_norm_out = GroupNorm(ch[-1])
        self.conv_out = Conv2d(ch[-1], 2 * c.latent_channels, 3)
        self.quant_conv = Conv2d(2 * c.latent_channels,
                                 2 * c.latent_channels, 1)

    def forward(self, x):
        h = self.conv_in(x)
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return self.quant_conv(h)


class KLDecoder(nn.Module):
    def __init__(self, cfg: KLVAEConfig):
        super().__init__()
        c = cfg
        rev = tuple(reversed(c.block_out_channels))
        self.cfg = cfg
        self.post_quant_conv = Conv2d(c.latent_channels, c.latent_channels, 1)
        self.conv_in = Conv2d(c.latent_channels, rev[0], 3)
        self.mid_resnet_0 = ResnetBlock(rev[0], rev[0])
        self.mid_attn = AttnBlock(rev[0])
        self.mid_resnet_1 = ResnetBlock(rev[0], rev[0])
        # flax names: up_{i}_resnet_{j}, then up_{i}_upsample
        self.stages = []
        ch_in = rev[0]
        for i, ch in enumerate(rev):
            names = []
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{i}_resnet_{j}", ResnetBlock(ch_in, ch))
                names.append(f"up_{i}_resnet_{j}")
                ch_in = ch
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Conv2d(ch, ch, 3))
                names.append(f"up_{i}_upsample")
            self.stages.append(names)
        self.conv_norm_out = GroupNorm(rev[-1])
        self.conv_out = Conv2d(rev[-1], c.in_channels, 3)

    def forward(self, z):
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        for names in self.stages:
            for name in names:
                if name.endswith("_upsample"):
                    # nearest x2 (jax.image.resize "nearest" at scale 2)
                    h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """SD's KL autoencoder, fp32; without ``encoder`` the decode side only
    (serving).  The decoder comes first, so its weights from a seed do not
    depend on whether the encoder is built."""

    def __init__(self, cfg: KLVAEConfig = KLVAEConfig(),
                 encoder: bool = True):
        super().__init__()
        self.cfg = cfg
        self.decoder = KLDecoder(cfg)
        if encoder:
            self.encoder = KLEncoder(cfg)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images in [-1, 1] → (mean, log-variance clipped to
        [-30, 20]), fp32."""
        mean, logvar = self.encoder(x.float()).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic latents: the mean, shifted where the config has a
        shift, times the scaling factor."""
        z, _ = self.encode(x)
        if self.cfg.shift_factor is not None:
            z = z - self.cfg.shift_factor
        return z * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents → NHWC images in about [-1, 1], fp32."""
        z = z.float() / self.cfg.scaling_factor
        if self.cfg.shift_factor is not None:
            z = z + self.cfg.shift_factor
        return self.decoder(z)


KLVAE_SD15 = KLVAEConfig(scaling_factor=0.18215)
# SDXL's VAE (also PixArt-Sigma's published pipe): the same structure,
# latents scaled by 0.13025
KLVAE_SDXL = KLVAEConfig(scaling_factor=0.13025)
# SD3.5's VAE: 16 latent channels, shifted then scaled
KLVAE_SD35 = KLVAEConfig(latent_channels=16, scaling_factor=1.5305,
                         shift_factor=0.0609)
# the Flux-2 Klein VAE: 16 channels, its own scale and shift
KLVAE_FLUX = KLVAEConfig(latent_channels=16, scaling_factor=0.3611,
                         shift_factor=0.1159)
KLVAE_TINY_TEST = KLVAEConfig(block_out_channels=(32, 32),
                              layers_per_block=1)


# ---------------------------------------------------------------------------
# DC-AE (SANA 32x)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DCAEConfig:
    in_channels: int = 3
    latent_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512, 1024, 1024)
    encoder_layers: Tuple[int, ...] = (2, 2, 2, 3, 3, 3)
    decoder_layers: Tuple[int, ...] = (3, 3, 3, 3, 3, 3)
    attention_stages: Tuple[bool, ...] = (False, False, False, True, True, True)
    attention_head_dim: int = 32
    qkv_multiscales: Tuple[int, ...] = (5,)
    glu_expand: float = 4.0
    scaling_factor: float = 0.41407

    @property
    def compression(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class ChannelRMSNorm(nn.Module):
    """RMSNorm over the channel (last) dim with an affine scale, in fp32."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float()
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + self.epsilon)
        return (y * self.scale).to(x.dtype)


class DCResBlock(nn.Module):
    """conv1 → silu → conv2 (no bias) → RMSNorm → +x."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3)
        self.conv2 = Conv2d(channels, channels, 3, use_bias=False)
        self.norm = ChannelRMSNorm(channels)

    def forward(self, x):
        return x + self.norm(self.conv2(F.silu(self.conv1(x))))


class DCGLUMBConv(nn.Module):
    """Gated inverted-residual conv FFN with trailing RMSNorm, residual."""

    def __init__(self, channels: int, expand: float = 4.0):
        super().__init__()
        hidden = int(channels * expand)
        self.conv_inverted = Conv2d(channels, hidden * 2, 1)
        self.conv_depth = Conv2d(hidden * 2, hidden * 2, 3, groups=hidden * 2)
        self.conv_point = Conv2d(hidden, channels, 1, use_bias=False)
        self.norm = ChannelRMSNorm(channels)

    def forward(self, x):
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        a, g = h.chunk(2, dim=-1)
        return x + self.norm(self.conv_point(a * F.silu(g)))


class DCLiteMLA(nn.Module):
    """SANA multiscale ReLU linear attention: per-scale depthwise +
    grouped-1x1 aggregation of the fused qkv, ReLU kernel, ones-row
    normalisation (inline fp32 math, as in the JAX package), trailing
    RMSNorm, residual."""

    def __init__(self, channels: int, head_dim: int = 32,
                 scales: Tuple[int, ...] = (5,), eps: float = 1e-15):
        super().__init__()
        c = channels
        self.heads = c // head_dim
        self.head_dim, self.scales, self.eps = head_dim, scales, eps
        f32 = torch.float32
        self.to_q = AdapterDense(c, c, False, f32)
        self.to_k = AdapterDense(c, c, False, f32)
        self.to_v = AdapterDense(c, c, False, f32)
        for s_i, ks in enumerate(scales):
            self.add_module(f"ms_{s_i}_proj_in",
                            Conv2d(3 * c, 3 * c, ks, groups=3 * c,
                                   use_bias=False))
            self.add_module(f"ms_{s_i}_proj_out",
                            Conv2d(3 * c, 3 * c, 1, groups=3 * self.heads,
                                   use_bias=False))
        self.to_out = AdapterDense(c * (1 + len(scales)), c, False, f32)
        self.norm_out = ChannelRMSNorm(c)

    def _linear_attn(self, qkv_flat: torch.Tensor) -> torch.Tensor:
        b, n, c3 = qkv_flat.shape
        c = c3 // 3
        shape = (b, n, self.heads, self.head_dim)
        qs, ks, vs = qkv_flat.chunk(3, dim=-1)
        qs = torch.relu(qs).float().reshape(shape)
        ks = torch.relu(ks).float().reshape(shape)
        vs = vs.float().reshape(shape)
        vs = torch.cat([vs, vs.new_ones(shape[:-1] + (1,))], dim=-1)
        kv = torch.einsum("bnhd,bnhe->bhde", ks, vs)
        out = torch.einsum("bnhd,bhde->bnhe", qs, kv)
        out = out[..., :-1] / (out[..., -1:] + self.eps)
        return out.reshape(b, n, c)

    def forward(self, x):
        b, h, w, c = x.shape
        flat = x.reshape(b, h * w, c)
        qkv = torch.cat([self.to_q(flat), self.to_k(flat), self.to_v(flat)],
                        dim=-1)
        multi = [qkv]
        grid = qkv.reshape(b, h, w, 3 * c)
        for s_i in range(len(self.scales)):
            y = getattr(self, f"ms_{s_i}_proj_in")(grid)
            y = getattr(self, f"ms_{s_i}_proj_out")(y)
            multi.append(y.reshape(b, h * w, 3 * c))
        y = torch.cat([self._linear_attn(m) for m in multi], dim=-1)
        y = self.norm_out(self.to_out(y))
        return x + y.reshape(b, h, w, c)


class EfficientViTBlock(nn.Module):
    def __init__(self, channels: int, head_dim: int = 32,
                 scales: Tuple[int, ...] = (5,), expand: float = 4.0):
        super().__init__()
        self.attn = DCLiteMLA(channels, head_dim=head_dim, scales=scales)
        self.conv_out = DCGLUMBConv(channels, expand=expand)

    def forward(self, x):
        return self.conv_out(self.attn(x))


def _pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC pixel-unshuffle with torch's channel-major ordering (output
    channel k = c*r^2 + i*r + j)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)      # (b, H, i, W, j, c)
    x = x.permute(0, 1, 3, 5, 2, 4)                # (b, H, W, c, i, j)
    return x.reshape(b, h // r, w // r, c * r * r)


def _pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC pixel-shuffle with torch's channel-major ordering (input channel
    k = c*r^2 + i*r + j)."""
    b, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(b, h, w, co, r, r)               # (b, h, w, c, i, j)
    x = x.permute(0, 1, 4, 2, 5, 3)                # (b, h, i, w, j, c)
    return x.reshape(b, h * r, w * r, co)


class DCDownsample(nn.Module):
    """conv(in → out/4) → pixel-unshuffle, + the shortcut: the input
    pixel-unshuffled, averaged over groups of consecutive channels down to
    ``out``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.out_channels = out_channels
        self.conv = Conv2d(in_channels, out_channels // 4, 3)

    def forward(self, x):
        y = _pixel_unshuffle(self.conv(x), 2)
        sc = _pixel_unshuffle(x, 2)
        g = sc.shape[-1] // self.out_channels
        return y + sc.reshape(*sc.shape[:-1], self.out_channels, g).mean(-1)


class DCUpsample(nn.Module):
    """conv(in → out*4) → pixel-shuffle, + channel-duplication shortcut."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.conv = Conv2d(in_channels, out_channels * 4, 3)

    def forward(self, x):
        y = _pixel_shuffle(self.conv(x), 2)
        rep = (self.out_channels * 4) // x.shape[-1]
        return y + _pixel_shuffle(x.repeat_interleave(rep, dim=-1), 2)


class DCAEEncoder(nn.Module):
    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        c = cfg
        ch = c.block_out_channels
        self.conv_in = Conv2d(c.in_channels, ch[0], 3)
        # flax names: down_{i} before stage i, stage_{i}_block_{j}
        self.stages = []
        for i, out in enumerate(ch):
            names = []
            if i > 0:
                self.add_module(f"down_{i}", DCDownsample(ch[i - 1], out))
                names.append(f"down_{i}")
            for j in range(c.encoder_layers[i]):
                blk = (EfficientViTBlock(out, head_dim=c.attention_head_dim,
                                         scales=c.qkv_multiscales,
                                         expand=c.glu_expand)
                       if c.attention_stages[i] else DCResBlock(out))
                self.add_module(f"stage_{i}_block_{j}", blk)
                names.append(f"stage_{i}_block_{j}")
            self.stages.append(names)
        self.conv_out = Conv2d(ch[-1], c.latent_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
        return self.conv_out(h)


class DCAEDecoder(nn.Module):
    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        rev_ch = tuple(reversed(c.block_out_channels))
        rev_layers = tuple(reversed(c.decoder_layers))
        rev_attn = tuple(reversed(c.attention_stages))
        self.conv_in = Conv2d(c.latent_channels, rev_ch[0], 3)
        # flax names: up_{i} before stage i, stage_{i}_block_{j}
        self.stages = []
        for i, ch in enumerate(rev_ch):
            names = []
            if i > 0:
                self.add_module(f"up_{i}", DCUpsample(rev_ch[i - 1], ch))
                names.append(f"up_{i}")
            for j in range(rev_layers[i]):
                blk = (EfficientViTBlock(ch, head_dim=c.attention_head_dim,
                                         scales=c.qkv_multiscales,
                                         expand=c.glu_expand)
                       if rev_attn[i] else DCResBlock(ch))
                self.add_module(f"stage_{i}_block_{j}", blk)
                names.append(f"stage_{i}_block_{j}")
            self.stages.append(names)
        self.norm_out = ChannelRMSNorm(rev_ch[-1])
        self.conv_out = Conv2d(rev_ch[-1], c.in_channels, 3)

    def forward(self, z):
        h = self.conv_in(z)
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class DCAE(nn.Module):
    """Deterministic 32x autoencoder (no KL); without ``encoder`` the
    decode side only (serving), the decoder first as in
    :class:`AutoencoderKL`."""

    def __init__(self, cfg: DCAEConfig = DCAEConfig(), encoder: bool = True):
        super().__init__()
        self.cfg = cfg
        self.decoder = DCAEDecoder(cfg)
        if encoder:
            self.encoder = DCAEEncoder(cfg)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images in [-1, 1] → latents times the scaling factor,
        fp32."""
        return self.encoder(x.float()) * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents → NHWC images in about [-1, 1], fp32."""
        return self.decoder(z.float() / self.cfg.scaling_factor)


DCAE_SANA = DCAEConfig()
DCAE_TINY_TEST = DCAEConfig(block_out_channels=(32, 32, 64),
                            encoder_layers=(1, 1, 1),
                            decoder_layers=(1, 1, 1),
                            attention_stages=(False, False, True),
                            attention_head_dim=16, glu_expand=1.0)


def decode_tiled(vae, latents: torch.Tensor, tile_latent: int = 128,
                 overlap: int = 16) -> torch.Tensor:
    """Memory-bounded decode by overlapping latent tiles, feathered
    together with weights that ramp linearly across the ``overlap``-latent
    bands (counterpart of ``yat_tpu/models/vae.py:decode_tiled``).
    Latents that fit one tile decode whole."""
    b, h, w, _ = latents.shape
    comp = vae.cfg.compression
    step = tile_latent - overlap
    if h <= tile_latent and w <= tile_latent:
        return vae.decode(latents)

    dev = latents.device
    out = weight = None
    band = float(overlap * comp)
    for y0 in range(0, max(h - overlap, 1), step):
        for x0 in range(0, max(w - overlap, 1), step):
            y1, x1 = min(y0 + tile_latent, h), min(x0 + tile_latent, w)
            img = vae.decode(latents[:, y0:y1, x0:x1])
            ph, pw = img.shape[1], img.shape[2]
            if out is None:
                out = torch.zeros((b, h * comp, w * comp, img.shape[-1]),
                                  dtype=torch.float32, device=dev)
                weight = torch.zeros((b, h * comp, w * comp, 1),
                                     dtype=torch.float32, device=dev)
            ry = torch.arange(ph, device=dev)
            rx = torch.arange(pw, device=dev)
            wy = torch.minimum(ry + 1, ry.flip(0) + 1).clamp(
                max=overlap * comp).float() / band
            wx = torch.minimum(rx + 1, rx.flip(0) + 1).clamp(
                max=overlap * comp).float() / band
            wmap = (wy[:, None] * wx[None, :])[None, :, :, None]
            oy, ox = y0 * comp, x0 * comp
            out[:, oy:oy + ph, ox:ox + pw] += img.float() * wmap
            weight[:, oy:oy + ph, ox:ox + pw] += wmap
    return (out / weight.clamp(min=1e-8)).to(latents.dtype)
