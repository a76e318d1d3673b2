"""SD1.5 frontend: config → UNet, CLIP-L, KL-VAE, trainer, pipeline.

Counterpart of ``yat_tpu/frontends/sd15.py``: ``make_trainer`` wires the
UNet's epsilon-prediction training on the DDPM schedule (LoRA or full
fine-tuning, the preservation term, the data path of
``common.build_family_sampler``: Dreambooth folders, raw images encoded
on the fly by CLIP-L and the KL-VAE with each caption compressed to
CLIP's 77 tokens, or feature shards; the 512 px bins; validation when
prompts are configured) and ``make_pipeline`` the serving path (20 DDIM
steps, CFG 5.0, seed 42; the KL-VAE's decoder half alone).  The UNet loads
from a diffusers checkpoint (``pretrained_model_path``, or ``unet/`` of
``pretrained_pipe_path``) or from the CompVis single file
(``pretrained_pipe_single_file``), CLIP-L and the VAE from the same
places; without them the modules are random from ``dataset_seed``.  Tests
may pass JAX parameter trees instead (``weights``: ``"unet"``,
``"text_encoder"``, ``"vae"``).

    python -m yat_tpu_torch.frontends.sd15 --config cfg.yaml [--device cpu]

``use_repa`` takes the generic REPA path on ``repa_target_modules``
(``mid_attn`` by default) through a projection head from
``dataset_seed + 7`` that trains beside the adapters.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    FamilySpec,
    attach_pretrained_adapters,
    build_backbone,
    build_clip_vae_encoders,
    build_family_sampler,
    cli_main,
    dino_token_dim,
    encodes_images,
    ensure_encoders,
    make_prompt_encoder,
    override_config,
)
from yat_tpu_torch.models.unet import SD15_UNET, UNet2DCondition, UNetConfig
from yat_tpu_torch.ops.repa import RepaConfig, init_repa_head
from yat_tpu_torch.ops.schedulers import DDPMSchedule
from yat_tpu_torch.train.engine import Trainer, stored_dtype
from yat_tpu_torch.train.tasks import (make_epsilon_loss,
                                      make_preservation_loss)
from yat_tpu_torch.train.validation import ValidationPipeline

CLIP_MAX_LEN = 77
RESOLUTION = 512
VAE_COMPRESSION = 8


def build_unet(params: TrainingParameters, cfg: UNetConfig, family: str,
               device, tree=None, store=None, remat: bool = False):
    """The UNet (see ``common.build_backbone``): bf16 compute under
    ``bfloat16``, remat under ``low_vram`` when training."""
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    return build_backbone(
        lambda: UNet2DCondition(cfg, dtype=dtype,
                                gradient_checkpointing=remat),
        params, family, cfg, device, tree, store)


def latent_side(params: TrainingParameters, default: int) -> int:
    """The square latent side of sampling: the resolution over 8."""
    return (params.aspect_ratios or default) // VAE_COMPRESSION


def repa_parts(params: TrainingParameters, cfg: UNetConfig, device):
    """``(repa_cfg, repa_head)`` of the generic REPA path (``mid_attn`` by
    default, at the UNet's deepest width), or ``(None, None)``."""
    if not params.use_repa:
        return None, None
    repa_cfg = RepaConfig(
        target_modules=tuple(params.repa_target_modules or ("mid_attn",)),
        target_shape=dino_token_dim(params))
    return repa_cfg, init_repa_head(repa_cfg, cfg.block_out_channels[-1],
                                    params.dataset_seed + 7, device)


def _encoders(params, device, weights, images):
    ei, ec, _, dl = build_clip_vae_encoders(params, device, CLIP_MAX_LEN,
                                            weights, images=images)
    return ei, ec, dl


def _pipeline(params, cfg, model, encode_captions, decode_latents, device):
    """The 20-step DDIM, CFG 5.0 sampler around ``model``."""
    lat = latent_side(params, RESOLUTION)
    return ValidationPipeline(
        model, DDPMSchedule(), latent_shape=(lat, lat, cfg.in_channels),
        encode_prompts=make_prompt_encoder(encode_captions, CLIP_MAX_LEN,
                                           device),
        decode_latents=decode_latents, guidance_scale=5.0, num_steps=20,
        params=params, device=device,
        active_timesteps=params.timesteps or None)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The SD1.5 serving pipeline: the UNet (bf16 when ``bfloat16`` is
    set, its parameters stored in bf16 too), CLIP-L (fp32) and the fp32
    KL-VAE decoder; 20 DDIM steps, CFG 5.0, seed 42, refiner gating on
    ``timesteps``.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = override_config(SD15_UNET, params.model_config_overrides)
    weights = weights or {}
    model = build_unet(params, cfg, "sd15", device, weights.get("unet"),
                       torch.bfloat16 if params.bfloat16 else None)
    attach_pretrained_adapters(model, params, device)
    _, encode_captions, decode_latents = _encoders(params, device, weights,
                                                   False)
    return _pipeline(params, cfg, model, encode_captions, decode_latents,
                     device)


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None) -> Trainer:
    """The SD1.5 trainer: the UNet (bf16 compute, with a bf16 frozen base
    under LoRA when ``bfloat16`` is set, fp32 leaves under full
    fine-tuning, an int8/int4 base quantized by the trainer, remat under
    ``low_vram``), the epsilon loss on ``DDPMSchedule`` (the preservation
    term under ``use_preservation``, REPA under ``use_repa``), the sampler
    of ``common.build_family_sampler`` at the 512 px bins, and with
    ``validation_prompts`` the encoders and the 20-step DDIM, CFG 5.0
    validation pipeline.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = override_config(SD15_UNET, params.model_config_overrides)
    weights = weights or {}
    model = build_unet(params, cfg, "sd15", device, weights.get("unet"),
                       stored_dtype(params), remat=params.low_vram)
    schedule = DDPMSchedule()
    repa_cfg, repa_head = repa_parts(params, cfg, device)
    loss = make_epsilon_loss(
        model, schedule, timestep_list=params.timesteps or None,
        repa_lambda=params.repa_lambda if params.use_repa else 0.0,
        repa_cfg=repa_cfg, repa_head=repa_head)
    pres = (make_preservation_loss(model, schedule, is_flow=False)
            if params.use_preservation else None)
    holder: dict = {}

    def encoders(p):
        ei, ec, dl = _encoders(p, device, weights, encodes_images(p))
        return {"encode_images": ei, "encode_captions": ec,
                "decode_latents": dl}

    spec = FamilySpec(family="sd15", max_caption_len=CLIP_MAX_LEN,
                      default_resolution=RESOLUTION,
                      build_encoders=encoders, device=device)
    if sampler is None:
        sampler = build_family_sampler(params, spec, holder)
    trainer = Trainer(params, model, loss, sampler=sampler, device=device,
                      preservation_loss=pres)
    trainer.unet_config = cfg
    trainer.family_spec = spec
    trainer.schedule = schedule
    trainer.repa_head, trainer.repa_config = repa_head, repa_cfg
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
    """``python -m yat_tpu_torch.frontends.sd15 --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
