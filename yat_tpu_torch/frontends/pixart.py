"""PixArt-Sigma frontend: config → denoiser, encoders, decoder, pipeline.

Counterpart of ``yat_tpu/frontends/pixart.py``, its serving half:
``make_pipeline`` builds the PixArt-Sigma XL-2 denoiser, the T5-XXL caption
encoder and the SD KL-VAE decoder and samples the way the JAX frontend's
validation does (20 DDIM steps, CFG 5.0, PAG 2.0, the epsilon half of the
learned-sigma output, seed 42).  The repository holds no PixArt, T5 or VAE
weights, so the modules are random from ``dataset_seed``, or loaded from
JAX parameter trees through ``convert.load_flax_params``.  Training
(``make_trainer``, ``main``) waits for the next slice of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    build_module,
    build_t5_vae_encoders,
    make_prompt_encoder,
    override_config,
)
from yat_tpu_torch.models.pixart import PIXART_SIGMA_XL2, PixArtConfig, \
    PixArtTransformer2D
from yat_tpu_torch.ops.schedulers import DDPMSchedule
from yat_tpu_torch.train.validation import ValidationPipeline

_TRAINING = ("PixArt-Sigma training is not ported to PyTorch yet; it is the "
             "next slice (ROADMAP queue 1, slice 4)")


def build_pixart_config(params: TrainingParameters) -> PixArtConfig:
    if (params.pretrained_model_path or params.pretrained_pipe_path
            or params.pretrained_pipe_single_file):
        raise ValueError("loading pretrained checkpoints is not implemented "
                         "in the PyTorch port yet; unset the pretrained "
                         "paths to serve with random weights")
    if params.use_repa:
        raise NotImplementedError("REPA is not ported to PyTorch yet "
                                  "(ROADMAP queue 1, item 10)")
    return override_config(PIXART_SIGMA_XL2, params.model_config_overrides)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The PixArt-Sigma serving pipeline: the denoiser (bf16 when
    ``bfloat16`` is set, its parameters stored in bf16 too), the T5 encoder
    (same) and the fp32 KL-VAE decoder; 20 DDIM steps, CFG 5.0, PAG 2.0,
    ``pred_slice`` = ``in_channels`` for a learned-sigma head, seed 42.
    ``device`` defaults to ``cuda``.  ``weights`` may hold JAX parameter
    trees under ``"transformer"``, ``"text_encoder"`` and ``"vae"``."""
    device = resolve_device(device)
    if params.low_vram:
        raise ValueError("low_vram (tiled decode, prompt-at-a-time) is not "
                         "implemented in the PyTorch port yet")
    if params.timesteps:
        raise ValueError("refiner timestep gating is not implemented in the "
                         "PyTorch port yet")
    if params.use_ema:
        raise ValueError("EMA weights are not implemented in the PyTorch "
                         "port yet")
    cfg = build_pixart_config(params)
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    weights = weights or {}
    model = build_module(lambda: PixArtTransformer2D(cfg, dtype=dtype),
                         device, weights.get("transformer"),
                         params.dataset_seed,
                         dtype if params.bfloat16 else None)
    encode_captions, decode_latents = build_t5_vae_encoders(
        params, device, cfg.max_caption_len, weights)
    lat = (params.aspect_ratios or cfg.resolution) // cfg.vae_compression
    return ValidationPipeline(
        model, DDPMSchedule(), latent_shape=(lat, lat, cfg.in_channels),
        encode_prompts=make_prompt_encoder(encode_captions,
                                           cfg.max_caption_len, device),
        decode_latents=decode_latents, guidance_scale=5.0, num_steps=20,
        params=params, device=device, pag_scale=2.0,
        pred_slice=(cfg.in_channels
                    if cfg.out_channels == 2 * cfg.in_channels else None))


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None):
    raise NotImplementedError(_TRAINING)


def main(argv: Optional[list] = None):
    raise NotImplementedError(_TRAINING)


if __name__ == "__main__":
    main()
