"""PixelDiT frontend: pixel-space flow matching with the in-model REPA
projector; trainer and pipeline.

Counterpart of ``yat_tpu/frontends/pixeldit.py``: there is no VAE, the
"latents" are the pixels (the identity encoder maps uint8 to ``x / 127.5
- 1`` on the device, ``common.u8_to_unit``); captions go through SANA's
Gemma-2 encoder at 300 tokens; training is flow matching at shift 1.0
with, under ``use_repa``, the model's own alignment term weighted
``REPA_LOSS_WEIGHT`` (0.1) against DINOv2's tokens, which the on-the-fly
sampler encodes; validation and serving sample DPM-Solver++(2M) in flow
form, 20 steps at CFG 4.0, seed 42, at ``aspect_ratio`` (else 1024 px),
and the sample is the image.  The denoiser loads from a raw ``.pth`` or
``.safetensors`` file in DiT naming (``pretrained_model_path``; a hub repo
id fetches its ``model.pth``), Gemma-2 from ``text_encoder/`` of
``pretrained_pipe_path``; without those paths the modules are random from
``dataset_seed``.  Tests may pass JAX trees under ``"transformer"`` and
``"text_encoder"`` of ``weights``.

    python -m yat_tpu_torch.frontends.pixeldit --config cfg.yaml [--device cpu]

The projector sits in the base parameters, as in the JAX package: under
adapter training it stays frozen at its initialisation (a pretrained
file has none, so it is drawn from the seed) and is quantized with a
4-bit or int8 base, so the REPA term trains the adapters of the blocks
up to the tap toward a fixed random projection.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    FamilySpec,
    attach_pretrained_adapters,
    build_backbone,
    build_family_sampler,
    cli_main,
    ensure_encoders,
    make_prompt_encoder,
    override_config,
    repa_warmup_fields,
    u8_to_unit,
)
from yat_tpu_torch.models.pixeldit import PIXELDIT_BASE, PixelDiT, \
    PixelDiTConfig
from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
from yat_tpu_torch.train.engine import (Trainer, adapter_spec_from_params,
                                        stored_dtype)
from yat_tpu_torch.train.tasks import make_flow_matching_loss
from yat_tpu_torch.train.validation import ValidationPipeline

REPA_LOSS_WEIGHT = 0.1
# the sampler's bins without aspect_ratio, and the validation's side
DEFAULT_RESOLUTION = 256
VALIDATION_RESOLUTION = 1024


def build_config(params: TrainingParameters) -> PixelDiTConfig:
    return override_config(PIXELDIT_BASE, params.model_config_overrides)


def build_denoiser(params: TrainingParameters, cfg: PixelDiTConfig, device,
                   tree=None, store=None, remat: bool = False):
    """PixelDiT (see ``common.build_backbone``), with its REPA projector
    under ``use_repa``."""
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    return build_backbone(
        lambda: PixelDiT(cfg, dtype=dtype, gradient_checkpointing=remat,
                         repa=params.use_repa),
        params, "pixeldit", cfg, device, tree, store)


def make_identity_encoder(device):
    """``encode_images(pixels)``: uint8 pixels → fp32 ``[-1, 1]`` on the
    host, normalised on ``device``; float pixels are taken as they are."""

    @torch.inference_mode()
    def encode_images(images):
        arr = np.asarray(images)
        if arr.dtype != np.uint8:
            return arr
        return u8_to_unit(torch.as_tensor(arr).to(device)).cpu().numpy()

    return encode_images


def family_spec(params: TrainingParameters, cfg: PixelDiTConfig, device,
                weights: Optional[Mapping] = None) -> FamilySpec:
    """PixelDiT's part of the shared sampler selection: the 300-token
    caption budget, the 256 px bins by default, the identity image
    encoder and Gemma-2 (``frontends.sana.build_caption_encoder``)."""
    from yat_tpu_torch.frontends.sana import build_caption_encoder

    def encoders(p):
        return {"encode_images": make_identity_encoder(device),
                "encode_captions": build_caption_encoder(
                    p, device, cfg.max_caption_len, weights)}

    return FamilySpec(family="pixeldit", max_caption_len=cfg.max_caption_len,
                      default_resolution=DEFAULT_RESOLUTION,
                      build_encoders=encoders, device=device)


def warmup_spec(params: TrainingParameters, cfg: PixelDiTConfig) -> dict:
    """The batch shapes a run meets, as the JAX trainer's ``warmup_spec``
    lists them: the bins, no compression (pixel space), 3 channels, the
    caption's length and width, and REPA's targets."""
    from yat_tpu_torch.data.bins import bin_for_resolution
    return {"aspect_ratios": bin_for_resolution(
                params.aspect_ratios or DEFAULT_RESOLUTION),
            "vae_compression": 1, "latent_channels": cfg.in_channels,
            "caption_len": cfg.max_caption_len,
            "caption_dim": cfg.caption_channels,
            **repa_warmup_fields(params)}


def _pipeline(params, cfg, model, encode_captions, device):
    """DPM-Solver++(2M) in flow form, 20 steps, CFG 4.0, in pixel space."""
    res = params.aspect_ratios or VALIDATION_RESOLUTION
    return ValidationPipeline(
        model, FlowMatchSchedule(shift=1.0),
        latent_shape=(res, res, cfg.in_channels),
        encode_prompts=make_prompt_encoder(encode_captions,
                                           cfg.max_caption_len, device),
        decode_latents=lambda z: z, guidance_scale=4.0, num_steps=20,
        params=params, device=device, sampler="dpm",
        active_timesteps=params.timesteps or None)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The PixelDiT serving pipeline: the denoiser (bf16 when ``bfloat16``
    is set, stored in bf16 too) and Gemma-2; DPM-Solver++(2M) flow, 20
    steps, CFG 4.0, seed 42, at ``aspect_ratio`` (else 1024 px).
    ``device`` defaults to ``cuda``."""
    from yat_tpu_torch.frontends.sana import build_caption_encoder

    device = resolve_device(device)
    cfg = build_config(params)
    weights = weights or {}
    model = build_denoiser(params, cfg, device, weights.get("transformer"),
                           torch.bfloat16 if params.bfloat16 else None)
    attach_pretrained_adapters(model, params, device)
    encode_captions = build_caption_encoder(params, device,
                                            cfg.max_caption_len, weights)
    return _pipeline(params, cfg, model, encode_captions, device)


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None) -> Trainer:
    """The PixelDiT trainer (any adapter kind, or full fine-tuning): the
    denoiser (bf16 frozen base under adapters and ``bfloat16``, an int8 or
    4-bit base quantized from fp32 by the trainer, remat under
    ``low_vram``), flow matching at shift 1.0 with the REPA term at 0.1
    under ``use_repa``, the sampler of ``common.build_family_sampler``,
    and with ``validation_prompts`` the DPM CFG 4.0 pipeline on the live
    model.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = build_config(params)
    weights = weights or {}
    model = build_denoiser(params, cfg, device, weights.get("transformer"),
                           stored_dtype(params), remat=params.low_vram)
    schedule = FlowMatchSchedule(shift=1.0)
    loss = make_flow_matching_loss(
        model, schedule, timestep_list=params.timesteps or None,
        repa_lambda=REPA_LOSS_WEIGHT if params.use_repa else 0.0)
    if model.repa_projector is not None and \
            adapter_spec_from_params(params) is not None:
        print(f"[repa] the projector after block {cfg.repa_depth} is part "
              "of the frozen base under adapter training: it stays at its "
              "initialisation (quantized with a quantized base), as in the "
              "JAX package")
    holder: dict = {}
    spec = family_spec(params, cfg, device, weights)
    if sampler is None:
        sampler = build_family_sampler(params, spec, holder)
    trainer = Trainer(params, model, loss, sampler=sampler, device=device)
    trainer.pixeldit_config = cfg
    trainer.family_spec = spec
    trainer.schedule = schedule
    trainer.warmup_spec = warmup_spec(params, cfg)
    if params.validation_prompts:
        ensure_encoders(params, spec, holder)
        pipeline = _pipeline(params, cfg, model, holder["encode_captions"],
                             device)
        trainer.validation_pipeline = pipeline
        trainer.validate_fn = pipeline.validate
    for k, v in holder.items():
        setattr(trainer, k, v)
    return trainer


def main(argv: Optional[list] = None):
    """``python -m yat_tpu_torch.frontends.pixeldit --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
