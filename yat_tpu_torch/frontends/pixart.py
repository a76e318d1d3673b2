"""PixArt-Sigma frontend: config → denoiser, encoders, decoder, trainer,
pipeline.

Counterpart of ``yat_tpu/frontends/pixart.py``: ``make_trainer`` wires the
training path (LoRA or full fine-tuning, the epsilon-prediction DDPM loss
with the learned-sigma half sliced off, the preservation term, the data
path of ``common.build_family_sampler``: Dreambooth folders, raw images
encoded on the fly by T5 and the KL-VAE, or feature shards; validation
when prompts are configured) and ``make_pipeline`` the serving path, which samples the way the JAX
frontend's validation does (20 DDIM steps, CFG 5.0, PAG 2.0, the epsilon
half of the learned-sigma output, seed 42).  The denoiser loads
from a diffusers checkpoint (``pretrained_model_path``, or
``transformer/`` of ``pretrained_pipe_path``), T5 and the KL-VAE from
``text_encoder/`` and ``vae/`` of ``pretrained_pipe_path``; without those
paths the modules are random from ``dataset_seed``.  Tests may pass JAX
parameter trees instead (``weights``).

    python -m yat_tpu_torch.frontends.pixart --config cfg.yaml [--device cpu]

Every adapter kind trains (``lora_algo``), and ``lora_pretrained`` loads
adapters into training and serving.  ``use_repa`` builds the denoiser
with its REPA projector after block ``repa_depth`` (4 unless the overrides
set it) and adds the alignment term against DINOv2's tokens, which the
on-the-fly sampler encodes.  The projector sits in the base parameters:
under adapter training it stays frozen at its initialisation (and is
quantized with the base), as in the JAX package, so the term trains the
adapters of the blocks up to the tap through a fixed random head.  The
quantized base (``lora_base_model_8bit``/``_4bit``, ``int8_w8a8``) and
Lion with 8-bit momentum (``use_adamw_8bit``) run as in the SANA trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    FamilySpec,
    attach_pretrained_adapters,
    build_backbone,
    build_family_sampler,
    build_t5_vae_encoders,
    cli_main,
    encodes_images,
    ensure_encoders,
    make_prompt_encoder,
    override_config,
)
from yat_tpu_torch.models.pixart import PIXART_SIGMA_XL2, PixArtConfig, \
    PixArtTransformer2D
from yat_tpu_torch.ops.schedulers import DDPMSchedule
from yat_tpu_torch.train.engine import (Trainer, adapter_spec_from_params,
                                        stored_dtype)
from yat_tpu_torch.train.tasks import (make_epsilon_loss,
                                      make_preservation_loss)
from yat_tpu_torch.train.validation import ValidationPipeline


def build_pixart_config(params: TrainingParameters) -> PixArtConfig:
    """The overridden PixArt-Sigma XL-2 configuration; under ``use_repa``
    the tap sits after block 4 unless ``repa_depth`` is set."""
    cfg = override_config(PIXART_SIGMA_XL2, params.model_config_overrides)
    if params.use_repa and cfg.repa_depth is None:
        cfg = dataclasses.replace(cfg, repa_depth=4)
    return cfg


def build_denoiser(params: TrainingParameters, cfg: PixArtConfig, device,
                   tree=None, store=None, remat: bool = False):
    """The PixArt-Sigma denoiser (see ``common.build_backbone``), with its
    REPA projector under ``use_repa``."""
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    return build_backbone(
        lambda: PixArtTransformer2D(cfg, dtype=dtype,
                                    gradient_checkpointing=remat,
                                    repa=params.use_repa),
        params, "pixart", cfg, device, tree, store)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The PixArt-Sigma serving pipeline: the denoiser (bf16 when
    ``bfloat16`` is set, its parameters stored in bf16 too), the T5 encoder
    (same) and the fp32 KL-VAE decoder (no encoder half); 20 DDIM steps, CFG 5.0, PAG 2.0,
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
    attach_pretrained_adapters(model, params, device)
    _, encode_captions, decode_latents = build_t5_vae_encoders(
        params, device, cfg.max_caption_len, weights, images=False)
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


def family_spec(params: TrainingParameters, cfg: PixArtConfig, device,
                weights: Optional[Mapping] = None) -> FamilySpec:
    """PixArt-Sigma's part of the shared sampler selection: the 300-token
    caption budget (rungs 128, 256 and 300 under
    ``caption_length_bucketing``), its resolution's bin table, and
    ``build_t5_vae_encoders`` (the KL-VAE's encoder half only for a run
    that encodes images)."""

    def encoders(p):
        ei, ec, dl = build_t5_vae_encoders(p, device, cfg.max_caption_len,
                                           weights,
                                           images=encodes_images(p))
        return {"encode_images": ei, "encode_captions": ec,
                "decode_latents": dl}

    return FamilySpec(family="pixart", max_caption_len=cfg.max_caption_len,
                      default_resolution=cfg.resolution,
                      build_encoders=encoders, device=device)


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None) -> Trainer:
    """The PixArt-Sigma trainer (LoRA, or full fine-tuning without an
    adapter spec): the denoiser (bf16 compute, with a bf16 frozen base under
    LoRA when ``bfloat16`` is set, fp32 leaves under full fine-tuning, or an
    int8/int4 base quantized from fp32 by the trainer, remat under
    ``low_vram``; loaded from the pretrained paths before any
    quantization), the epsilon-prediction loss on ``DDPMSchedule`` with the
    learned-sigma half sliced off (and the epsilon-form preservation term
    under ``use_preservation``), the sampler of
    ``common.build_family_sampler`` (its encoders, when it builds them, set
    on the trainer), and with ``validation_prompts`` the encoders (the
    empty caption feeds unconditional-caption dropout) and the 20-step
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
    loss = make_epsilon_loss(
        model, schedule, timestep_list=params.timesteps or None,
        learned_sigma=_pred_slice(cfg) is not None,
        repa_lambda=params.repa_lambda if params.use_repa else 0.0)
    if params.use_repa and adapter_spec_from_params(params) is not None:
        print(f"[repa] the projector after block {cfg.repa_depth} is part "
              "of the frozen base under adapter training: it stays at its "
              "initialisation, as in the JAX package")
    pres = (make_preservation_loss(model, schedule, is_flow=False)
            if params.use_preservation else None)
    holder: dict = {}
    spec = family_spec(params, cfg, device, weights)
    if sampler is None:
        sampler = build_family_sampler(params, spec, holder)
    trainer = Trainer(params, model, loss, sampler=sampler, device=device,
                      preservation_loss=pres)
    trainer.pixart_config = cfg
    trainer.family_spec = spec
    trainer.schedule = schedule
    if params.validation_prompts:
        ensure_encoders(params, spec, holder)
        pipeline = _pipeline(params, cfg, model, holder["encode_captions"],
                             holder["decode_latents"], device)
        trainer.validation_pipeline = pipeline
        trainer.validate_fn = pipeline.validate
    for k, v in holder.items():
        setattr(trainer, k, v)
    return trainer


def main(argv: Optional[list] = None):
    """``python -m yat_tpu_torch.frontends.pixart --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
