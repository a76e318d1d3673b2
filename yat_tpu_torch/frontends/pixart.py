"""PixArt-Sigma frontend: config → denoiser, encoders, decoder, trainer,
pipeline.

Counterpart of ``yat_tpu/frontends/pixart.py``: ``make_trainer`` wires the
training path (LoRA or full fine-tuning, the epsilon-prediction DDPM loss
with the learned-sigma half sliced off, the preservation term, local
feature shards, validation when prompts are configured) and
``make_pipeline`` the serving path, which samples the way the JAX
frontend's validation does (20 DDIM steps, CFG 5.0, PAG 2.0, the epsilon
half of the learned-sigma output, seed 42).  The denoiser loads
from a diffusers checkpoint (``pretrained_model_path``, or
``transformer/`` of ``pretrained_pipe_path``), T5 and the KL-VAE from
``text_encoder/`` and ``vae/`` of ``pretrained_pipe_path``; without those
paths the modules are random from ``dataset_seed``.  Tests may pass JAX
parameter trees instead (``weights``).

    python -m yat_tpu_torch.frontends.pixart --config cfg.yaml [--device cpu]

REPA and LoKr raise, each naming its ROADMAP item.  The quantized base
(``lora_base_model_8bit``/``_4bit``, ``int8_w8a8``) and Lion with 8-bit
momentum (``use_adamw_8bit``) run as in the SANA trainer.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    build_backbone,
    build_feature_sampler,
    build_t5_vae_encoders,
    cli_main,
    make_prompt_encoder,
    override_config,
)
from yat_tpu_torch.models.pixart import PIXART_SIGMA_XL2, PixArtConfig, \
    PixArtTransformer2D
from yat_tpu_torch.ops.schedulers import DDPMSchedule
from yat_tpu_torch.train.engine import Trainer, stored_dtype
from yat_tpu_torch.train.tasks import (make_epsilon_loss,
                                      make_preservation_loss)
from yat_tpu_torch.train.validation import ValidationPipeline


def build_pixart_config(params: TrainingParameters) -> PixArtConfig:
    if params.use_repa:
        raise NotImplementedError("REPA is not ported to PyTorch yet "
                                  "(ROADMAP queue 1, item 10)")
    return override_config(PIXART_SIGMA_XL2, params.model_config_overrides)


def build_denoiser(params: TrainingParameters, cfg: PixArtConfig, device,
                   tree=None, store=None, remat: bool = False):
    """The PixArt-Sigma denoiser (see ``common.build_backbone``)."""
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    return build_backbone(
        lambda: PixArtTransformer2D(cfg, dtype=dtype,
                                    gradient_checkpointing=remat),
        params, "pixart", cfg, device, tree, store)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The PixArt-Sigma serving pipeline: the denoiser (bf16 when
    ``bfloat16`` is set, its parameters stored in bf16 too), the T5 encoder
    (same) and the fp32 KL-VAE decoder; 20 DDIM steps, CFG 5.0, PAG 2.0,
    ``pred_slice`` = ``in_channels`` for a learned-sigma head, seed 42,
    refiner gating on ``timesteps``.  ``device`` defaults to ``cuda``.  The
    weights come from the pretrained paths, or from JAX parameter trees
    under ``"transformer"``, ``"text_encoder"`` and ``"vae"`` of
    ``weights``, else at random."""
    device = resolve_device(device)
    cfg = build_pixart_config(params)
    weights = weights or {}
    model = build_denoiser(params, cfg, device, weights.get("transformer"),
                           torch.bfloat16 if params.bfloat16 else None)
    encode_captions, decode_latents = build_t5_vae_encoders(
        params, device, cfg.max_caption_len, weights)
    return _pipeline(params, cfg, model, encode_captions, decode_latents,
                     device)


def _pipeline(params, cfg, model, encode_captions, decode_latents, device):
    """The 20-step DDIM, CFG 5.0, PAG 2.0 sampler around ``model``."""
    lat = (params.aspect_ratios or cfg.resolution) // cfg.vae_compression
    return ValidationPipeline(
        model, DDPMSchedule(), latent_shape=(lat, lat, cfg.in_channels),
        encode_prompts=make_prompt_encoder(encode_captions,
                                           cfg.max_caption_len, device),
        decode_latents=decode_latents, guidance_scale=5.0, num_steps=20,
        params=params, device=device, pag_scale=2.0,
        pred_slice=_pred_slice(cfg),
        active_timesteps=params.timesteps or None)


def _pred_slice(cfg: PixArtConfig) -> Optional[int]:
    """The epsilon half of a learned-sigma head, else None."""
    return cfg.in_channels if cfg.out_channels == 2 * cfg.in_channels \
        else None


def build_sampler(params: TrainingParameters, cfg: PixArtConfig):
    """The pre-extracted feature-shard sampler (local shards) at PixArt's
    300-token caption budget: rungs 128, 256 and 300 under
    ``caption_length_bucketing``."""
    if params.dreambooth_dataset_folder:
        raise NotImplementedError(
            "Dreambooth sampling is not implemented in the PyTorch port yet "
            "(ROADMAP queue 1, item 8)")
    sampler = build_feature_sampler(params, cfg.max_caption_len)
    if sampler is None:
        raise ValueError("need local_shard_paths")
    return sampler


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None) -> Trainer:
    """The PixArt-Sigma trainer (LoRA, or full fine-tuning without an
    adapter spec): the denoiser (bf16 compute, with a bf16 frozen base under
    LoRA when ``bfloat16`` is set, fp32 leaves under full fine-tuning, or an
    int8/int4 base quantized from fp32 by the trainer, remat under
    ``low_vram``; loaded from the pretrained paths before any
    quantization), the epsilon-prediction loss on ``DDPMSchedule`` with the
    learned-sigma half sliced off (and the epsilon-form preservation term
    under ``use_preservation``), the local feature-shard sampler, and with
    ``validation_prompts`` the T5 encoder (its empty caption feeds
    unconditional-caption dropout), the KL-VAE decoder and the 20-step
    DDIM, CFG 5.0, PAG 2.0 validation pipeline on the live model (on its
    EMA leaves under ``use_ema``; refiner-gated on ``timesteps``).
    ``device`` defaults to ``cuda``; ``weights`` may hold JAX parameter
    trees as for :func:`make_pipeline`."""
    device = resolve_device(device)
    cfg = build_pixart_config(params)
    weights = weights or {}
    model = build_denoiser(params, cfg, device, weights.get("transformer"),
                           stored_dtype(params), remat=params.low_vram)
    schedule = DDPMSchedule()
    loss = make_epsilon_loss(model, schedule,
                             timestep_list=params.timesteps or None,
                             learned_sigma=_pred_slice(cfg) is not None)
    pres = (make_preservation_loss(model, schedule, is_flow=False)
            if params.use_preservation else None)
    if sampler is None:
        sampler = build_sampler(params, cfg)
    trainer = Trainer(params, model, loss, sampler=sampler, device=device,
                      preservation_loss=pres)
    trainer.pixart_config = cfg
    trainer.schedule = schedule
    if params.validation_prompts:
        encode_captions, decode_latents = build_t5_vae_encoders(
            params, device, cfg.max_caption_len, weights)
        trainer.encode_captions = encode_captions
        pipeline = _pipeline(params, cfg, model, encode_captions,
                             decode_latents, device)
        trainer.validation_pipeline = pipeline
        trainer.validate_fn = pipeline.validate
    return trainer


def main(argv: Optional[list] = None):
    """``python -m yat_tpu_torch.frontends.pixart --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
