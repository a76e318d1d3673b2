"""SDXL frontend: the UNet with micro-conditioning, two CLIP text
encoders and the KL-VAE; trainer and pipeline.

Counterpart of ``yat_tpu/frontends/sdxl.py``: the captions go through
CLIP-L and OpenCLIP-G, whose states are concatenated to 2048 wide, the
pooled text comes from OpenCLIP-G's projection, and every batch carries
``time_ids`` = ``[h, w, 0, 0, h, w]`` of its bucket (the original size is
the bucket's, no crop) and its pooled text (zeros when feature shards hold
none); 1024 px bins; 20 DDIM steps at CFG 5.0 for validation and serving.
Weights load as for SD1.5 (``frontends/sd15.py``), with
``text_encoder_2/`` for OpenCLIP-G; tests may pass JAX trees under
``"unet"``, ``"text_encoder"``, ``"text_encoder_2"`` and ``"vae"`` of
``weights``.

    python -m yat_tpu_torch.frontends.sdxl --config cfg.yaml [--device cpu]

Two divergences from the JAX package, both repairs (ROADMAP §3): the
first text encoder gives the penultimate layer's states, as diffusers'
SDXL pipeline takes them from both encoders (the JAX builder takes
CLIP-L's final LayerNorm states), and the VAE scales its latents by
SDXL's 0.13025 (the JAX builder takes SD1.5's 0.18215).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.data.bins import bin_for_resolution
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    FamilySpec,
    attach_pretrained_adapters,
    build_clip_text_encoder,
    build_clip_vae_encoders,
    build_family_sampler,
    cli_main,
    encodes_images,
    ensure_encoders,
    make_clip_encoders,
    make_prompt_encoder,
    override_config,
    single_file,
)
from yat_tpu_torch.frontends.sd15 import build_unet, latent_side, repa_parts
from yat_tpu_torch.models.unet import SDXL_UNET, UNetConfig
from yat_tpu_torch.ops.schedulers import DDPMSchedule
from yat_tpu_torch.train.engine import Trainer, stored_dtype
from yat_tpu_torch.train.tasks import (make_epsilon_loss,
                                      make_preservation_loss)
from yat_tpu_torch.train.validation import ValidationPipeline

CLIP_MAX_LEN = 77
RESOLUTION = 1024
EXTRA_KEYS = ("pooled_text", "time_ids")


def make_time_ids(bucket_hw, batch_size: int) -> np.ndarray:
    """``[orig_h, orig_w, crop_top, crop_left, target_h, target_w]`` for
    each sample: the bucket's size as the original and the target, crop
    (0, 0)."""
    h, w = bucket_hw
    row = np.asarray([h, w, 0, 0, h, w], np.float32)
    return np.tile(row[None], (batch_size, 1))


def build_sdxl_encoders(params: TrainingParameters, device,
                        weights: Optional[Mapping] = None,
                        images: bool = True, return_pool_l: bool = False,
                        clip_l_projection: bool = False):
    """SDXL's prompt pipeline: ``(encode_images, encode_captions,
    encode_pooled, decode_latents)`` (and CLIP-L's pooled encoder last
    under ``return_pool_l``, which SD3.5 concatenates with OpenCLIP-G's).
    ``encode_captions`` gives CLIP-L's penultimate states beside
    OpenCLIP-G's, ``[77, 768 + 1280]`` fp32 host arrays; ``encode_pooled``
    OpenCLIP-G's projected pooled vector ``[B, 1280]``.  Both encoders run
    in fp32; under ``tiny_encoders`` both are the tiny test CLIP."""
    from yat_tpu_torch.models.text_encoders import CLIP_G_14, CLIP_TINY_TEST
    from yat_tpu_torch.models.vae import KLVAE_SDXL
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    weights = weights or {}
    enc_img, enc_cap1, enc_pool_l, dec = build_clip_vae_encoders(
        params, device, CLIP_MAX_LEN, weights, images=images,
        clip_l_projection=clip_l_projection, penultimate=True,
        vae_cfg=KLVAE_SDXL)
    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    te2_cfg = (dataclasses.replace(CLIP_TINY_TEST, penultimate=True)
               if tiny else CLIP_G_14)
    te2 = build_clip_text_encoder(params, device, te2_cfg, "text_encoder_2",
                                  params.dataset_seed + 3,
                                  weights.get("text_encoder_2"))
    ml = min(CLIP_MAX_LEN, te2_cfg.max_length)
    tokenize2 = load_tokenizer(params.pretrained_pipe_path,
                               subfolder="tokenizer_2",
                               vocab_size=te2_cfg.vocab_size, max_length=ml,
                               require=single_file(params) is not None)
    enc_cap2, encode_pooled = make_clip_encoders(te2, tokenize2, ml, device,
                                                 params.low_vram)

    def dispatch(captions):
        fin1, fin2 = enc_cap1.dispatch(captions), enc_cap2.dispatch(captions)
        return lambda: [np.concatenate([a, b], -1)
                        for a, b in zip(fin1(), fin2())]

    def encode_captions(captions):
        return dispatch(captions)()

    encode_captions.dispatch = dispatch
    encode_captions.module = enc_cap1.module
    if return_pool_l:
        return enc_img, encode_captions, encode_pooled, dec, enc_pool_l
    return enc_img, encode_captions, encode_pooled, dec


def _pipeline(params, cfg, model, encode_captions, encode_pooled,
              decode_latents, device):
    """The 20-step DDIM, CFG 5.0 sampler around ``model``, each prompt
    (the empty one of CFG's unconditional half too) with its pooled text
    and the square ``time_ids`` of the resolution."""
    lat = latent_side(params, RESOLUTION)
    res = params.aspect_ratios or RESOLUTION
    return ValidationPipeline(
        model, DDPMSchedule(), latent_shape=(lat, lat, cfg.in_channels),
        encode_prompts=make_prompt_encoder(
            encode_captions, CLIP_MAX_LEN, device,
            encode_pooled=encode_pooled, time_ids_hw=(res, res)),
        decode_latents=decode_latents, guidance_scale=5.0, num_steps=20,
        params=params, device=device,
        active_timesteps=params.timesteps or None)


def build_config(params: TrainingParameters) -> UNetConfig:
    return override_config(SDXL_UNET, params.model_config_overrides)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The SDXL serving pipeline: the UNet (bf16 when ``bfloat16`` is set,
    stored in bf16 too), CLIP-L and OpenCLIP-G (fp32) and the fp32 KL-VAE
    decoder; 20 DDIM steps, CFG 5.0, seed 42, refiner gating on
    ``timesteps``.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = build_config(params)
    weights = weights or {}
    model = build_unet(params, cfg, "sdxl", device, weights.get("unet"),
                       torch.bfloat16 if params.bfloat16 else None)
    attach_pretrained_adapters(model, params, device)
    _, ec, ep, dl = build_sdxl_encoders(params, device, weights,
                                        images=False)
    return _pipeline(params, cfg, model, ec, ep, dl, device)


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None) -> Trainer:
    """The SDXL trainer: as SD1.5's (``frontends/sd15.make_trainer``) at
    the 1024 px bins, with the pooled text and ``time_ids`` in every batch
    (``batch_transform``; shards without pooled text get zeros of the
    UNet's ``addition_embed_dim``) and passed to the UNet by the loss and
    the preservation term."""
    device = resolve_device(device)
    cfg = build_config(params)
    pooled_dim = cfg.addition_embed_dim
    # the JAX package sizes its zero pooled vector from this key
    asked = params.model_config_overrides.get("pooled_dim")
    if asked is not None and int(asked) != pooled_dim:
        raise ValueError(
            f"model_config_overrides.pooled_dim {asked} differs from the "
            f"UNet's addition_embed_dim {pooled_dim}, which the pooled text "
            "feeds")
    weights = weights or {}
    model = build_unet(params, cfg, "sdxl", device, weights.get("unet"),
                       stored_dtype(params), remat=params.low_vram)
    schedule = DDPMSchedule()
    repa_cfg, repa_head = repa_parts(params, cfg, device)
    loss = make_epsilon_loss(
        model, schedule, timestep_list=params.timesteps or None,
        repa_lambda=params.repa_lambda if params.use_repa else 0.0,
        repa_cfg=repa_cfg, repa_head=repa_head, extra_keys=EXTRA_KEYS)
    pres = (make_preservation_loss(model, schedule, is_flow=False,
                                   extra_keys=EXTRA_KEYS)
            if params.use_preservation else None)
    holder: dict = {}

    def encoders(p):
        ei, ec, ep, dl = build_sdxl_encoders(p, device, weights,
                                             images=encodes_images(p))
        return {"encode_images": ei, "encode_captions": ec,
                "encode_pooled": ep, "decode_latents": dl}

    spec = FamilySpec(family="sdxl", max_caption_len=CLIP_MAX_LEN,
                      default_resolution=RESOLUTION,
                      build_encoders=encoders, device=device)
    if sampler is None:
        sampler = build_family_sampler(params, spec, holder)
    bins = bin_for_resolution(params.aspect_ratios or RESOLUTION)

    def batch_transform(batch, out):
        b = out["latents"].shape[0]
        out["time_ids"] = make_time_ids(
            bins.get(str(batch.ratio), (RESOLUTION, RESOLUTION)), b)
        out["pooled_text"] = (
            np.asarray(batch.pooled_text, np.float32)
            if batch.pooled_text is not None
            else np.zeros((b, pooled_dim), np.float32))
        return out

    trainer = Trainer(params, model, loss, sampler=sampler, device=device,
                      preservation_loss=pres,
                      batch_transform=batch_transform)
    trainer.unet_config = cfg
    trainer.family_spec = spec
    trainer.schedule = schedule
    trainer.repa_head, trainer.repa_config = repa_head, repa_cfg
    if params.validation_prompts:
        ensure_encoders(params, spec, holder)
        pipeline = _pipeline(params, cfg, model, holder["encode_captions"],
                             holder["encode_pooled"],
                             holder["decode_latents"], device)
        trainer.validation_pipeline = pipeline
        trainer.validate_fn = pipeline.validate
    for k, v in holder.items():
        setattr(trainer, k, v)
    return trainer


def main(argv: Optional[list] = None):
    """``python -m yat_tpu_torch.frontends.sdxl --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
