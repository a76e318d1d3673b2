"""SD3.5 frontend: the MMDiT with three text encoders and the 16-channel
KL-VAE; trainer and pipeline.

Counterpart of ``yat_tpu/frontends/sd35.py``: CLIP-L (with its projection)
and OpenCLIP-G take the compressed caption (``frontends/sdxl.py``'s
encoders), T5-XXL the full caption up to 256 tokens, in fp32; the CLIP
states (``[77, 768 + 1280]``) and T5's (``[L, 4096]``) are zero-padded to
the caption width and joined into ``[77 + L, 4096]``; the pooled text is
CLIP-L's projected pooled vector beside OpenCLIP-G's (2048).  Training is
flow matching at shift 3.0 with the pooled text in every batch (zeros
when feature shards hold none), validation and serving 20 flow-match
Euler steps at CFG 5.0, 1024 px bins.  Weights load from
``pretrained_pipe_path`` (``transformer/``, ``text_encoder/``,
``text_encoder_2/``, ``text_encoder_3/``, ``vae/``); tests may pass JAX
trees under those names in ``weights``.

    python -m yat_tpu_torch.frontends.sd35 --config cfg.yaml [--device cpu]

Under ``low_vram`` the MMDiT recomputes each block in the backward, the
encoders' and the VAE's weights rest on the host between calls, and the
decode is tiled.  One divergence from the JAX package, as for SDXL
(ROADMAP §3): CLIP-L gives its penultimate layer's states, as diffusers'
SD3 pipeline takes them from both CLIPs (the JAX builder gives CLIP-L's
final LayerNorm's).
"""

from __future__ import annotations

import dataclasses
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
    build_pipe_component,
    cli_main,
    dino_token_dim,
    encodes_images,
    ensure_encoders,
    make_caption_encoder,
    make_image_encoder,
    make_prompt_encoder,
    make_tiling_decoder,
    override_config,
)
from yat_tpu_torch.frontends.sdxl import build_sdxl_encoders
from yat_tpu_torch.models.mmdit import SD35_MEDIUM, MMDiT, MMDiTConfig
from yat_tpu_torch.ops.repa import RepaConfig, init_repa_head
from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
from yat_tpu_torch.train.engine import Trainer, stored_dtype
from yat_tpu_torch.train.tasks import (make_flow_matching_loss,
                                      make_preservation_loss)
from yat_tpu_torch.train.validation import ValidationPipeline

RESOLUTION = 1024
VAE_COMPRESSION = 8
T5_MAX_LEN = 256
EXTRA_KEYS = ("pooled_text",)


def build_config(params: TrainingParameters) -> MMDiTConfig:
    return override_config(SD35_MEDIUM, params.model_config_overrides,
                           mirror_out_channels=True)


def vae_config(params: TrainingParameters):
    """``KLVAE_SD35``, or the tiny test VAE with its 16 channels, scale and
    shift under ``tiny_encoders``."""
    from yat_tpu_torch.models.vae import KLVAE_SD35, KLVAE_TINY_TEST
    if params.model_config_overrides.get("tiny_encoders"):
        return dataclasses.replace(
            KLVAE_TINY_TEST, latent_channels=KLVAE_SD35.latent_channels,
            scaling_factor=KLVAE_SD35.scaling_factor,
            shift_factor=KLVAE_SD35.shift_factor)
    return KLVAE_SD35


def join_clip_t5(clip, t5, width: int) -> list:
    """Each sample's CLIP states ``[77, d_clip]`` and T5 states
    ``[L, d_t5]``, zero-padded to ``width`` channels, stacked into
    ``[77 + L, width]`` fp32."""
    out = []
    for c, t in zip(clip, t5):
        c, t = np.asarray(c), np.asarray(t)
        row = np.zeros((c.shape[0] + t.shape[0], width), np.float32)
        row[:c.shape[0], :c.shape[1]] = c
        row[c.shape[0]:, :t.shape[1]] = t
        out.append(row)
    return out


def build_sd35_encoders(params: TrainingParameters, cfg: MMDiTConfig, device,
                        weights: Optional[Mapping] = None,
                        images: bool = True):
    """``(encode_images, encode_captions, encode_pooled, decode_latents)``
    of SD3.5: the CLIP pair of SDXL (``build_sdxl_encoders`` with CLIP-L's
    projection and its pooled vector), T5-XXL in fp32 (its tiny test
    configuration under ``tiny_encoders``) and the KL-VAE of
    :func:`vae_config` (its decoder alone without ``images``).
    ``encode_captions`` gives :func:`join_clip_t5` of the two, and
    ``encode_pooled`` CLIP-L's pooled vector beside OpenCLIP-G's; both
    carry ``.dispatch`` hooks that launch the encoders together and join
    at fetch."""
    from yat_tpu_torch.models.convert import convert_t5_encoder
    from yat_tpu_torch.models.convert_unet import convert_vae_kl
    from yat_tpu_torch.models.text_encoders import (T5_TINY_TEST, T5_XXL,
                                                    T5Encoder)
    from yat_tpu_torch.models.vae import AutoencoderKL
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    weights = weights or {}
    low = params.low_vram
    _, enc_clip, enc_pool_g, _, enc_pool_l = build_sdxl_encoders(
        params, device, weights, images=False, return_pool_l=True,
        clip_l_projection=True, include_vae=False)
    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    t5_cfg = T5_TINY_TEST if tiny else T5_XXL
    t5 = build_pipe_component(
        params, "text_encoder_3",
        lambda sd: convert_t5_encoder(sd, t5_cfg.num_layers),
        lambda: T5Encoder(t5_cfg, dtype=torch.float32), device,
        params.dataset_seed + 4, tree=weights.get("text_encoder_3"))
    t5_len = min(cfg.max_caption_len, T5_MAX_LEN)
    tokenize_t5 = load_tokenizer(params.pretrained_pipe_path,
                                 subfolder="tokenizer_3",
                                 vocab_size=t5_cfg.vocab_size,
                                 max_length=t5_len)
    enc_t5 = make_caption_encoder(t5, tokenize_t5, t5_len, device, low)

    def dispatch(captions):
        fin_clip = enc_clip.dispatch(captions)
        fin_t5 = enc_t5.dispatch(captions)
        return lambda: join_clip_t5(fin_clip(), fin_t5(), cfg.caption_dim)

    def encode_captions(captions):
        return dispatch(captions)()

    def dispatch_pooled(captions):
        fin_l, fin_g = (enc_pool_l.dispatch(captions),
                        enc_pool_g.dispatch(captions))
        return lambda: np.concatenate([fin_l(), fin_g()], axis=-1)

    def encode_pooled(captions):
        return dispatch_pooled(captions)()

    encode_captions.dispatch, encode_pooled.dispatch = (dispatch,
                                                        dispatch_pooled)
    encode_captions.module, encode_pooled.module = t5, enc_pool_g.module

    vae_cfg = vae_config(params)
    vae = build_pipe_component(
        params, "vae", lambda sd: convert_vae_kl(
            sd, vae_cfg.block_out_channels, vae_cfg.layers_per_block),
        lambda: AutoencoderKL(vae_cfg, encoder=images), device,
        params.dataset_seed + 2, tree=weights.get("vae"))
    return (make_image_encoder(vae, device, low) if images else None,
            encode_captions, encode_pooled,
            make_tiling_decoder(vae, device, low))


def build_mmdit(params: TrainingParameters, cfg: MMDiTConfig, device,
                tree=None, store=None, remat: bool = False):
    """The MMDiT (see ``common.build_backbone``): bf16 compute under
    ``bfloat16``, remat under ``low_vram`` when training."""
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    return build_backbone(
        lambda: MMDiT(cfg, dtype=dtype, gradient_checkpointing=remat),
        params, "sd35", cfg, device, tree, store)


def _pipeline(params, cfg, model, encode_captions, encode_pooled,
              decode_latents, device):
    """The 20-step flow-match Euler, CFG 5.0 sampler around ``model``,
    each prompt (the empty one too) with its pooled text."""
    lat = (params.aspect_ratios or RESOLUTION) // VAE_COMPRESSION
    return ValidationPipeline(
        model, FlowMatchSchedule(shift=3.0),
        latent_shape=(lat, lat, cfg.in_channels),
        encode_prompts=make_prompt_encoder(encode_captions,
                                           cfg.max_caption_len, device,
                                           encode_pooled=encode_pooled),
        decode_latents=decode_latents, guidance_scale=5.0, num_steps=20,
        params=params, device=device,
        active_timesteps=params.timesteps or None)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The SD3.5 serving pipeline: the MMDiT (bf16 when ``bfloat16`` is
    set, stored in bf16 too), CLIP-L, OpenCLIP-G and T5-XXL (fp32) and the
    fp32 KL-VAE decoder; 20 Euler steps at shift 3.0, CFG 5.0, seed 42,
    refiner gating on ``timesteps``.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = build_config(params)
    weights = weights or {}
    model = build_mmdit(params, cfg, device, weights.get("transformer"),
                        torch.bfloat16 if params.bfloat16 else None)
    attach_pretrained_adapters(model, params, device)
    _, ec, ep, dl = build_sd35_encoders(params, cfg, device, weights,
                                        images=False)
    return _pipeline(params, cfg, model, ec, ep, dl, device)


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None) -> Trainer:
    """The SD3.5 trainer (any adapter kind, or full fine-tuning): the
    MMDiT (bf16 frozen base under adapters and ``bfloat16``, remat under
    ``low_vram``), the flow-matching loss at shift 3.0 with the pooled
    text (and the preservation term under ``use_preservation``), generic
    REPA on ``blocks_{num_layers // 2}`` by default under ``use_repa``,
    the sampler of ``common.build_family_sampler``, and with
    ``validation_prompts`` the encoders and the 20-step CFG 5.0 validation
    pipeline on the live model (on its EMA leaves under ``use_ema``).
    ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = build_config(params)
    weights = weights or {}
    model = build_mmdit(params, cfg, device, weights.get("transformer"),
                        stored_dtype(params), remat=params.low_vram)
    schedule = FlowMatchSchedule(shift=3.0)
    repa_cfg = repa_head = None
    if params.use_repa:
        repa_cfg = RepaConfig(
            target_modules=tuple(params.repa_target_modules or
                                 (f"blocks_{cfg.num_layers // 2}",)),
            target_shape=dino_token_dim(params))
        repa_head = init_repa_head(repa_cfg, cfg.hidden_dim,
                                   params.dataset_seed + 7, device)
    loss = make_flow_matching_loss(
        model, schedule, timestep_list=params.timesteps or None,
        repa_lambda=params.repa_lambda if params.use_repa else 0.0,
        repa_cfg=repa_cfg, repa_head=repa_head, extra_keys=EXTRA_KEYS)
    pres = (make_preservation_loss(model, schedule, is_flow=True,
                                   extra_keys=EXTRA_KEYS)
            if params.use_preservation else None)
    holder: dict = {}

    def encoders(p):
        ei, ec, ep, dl = build_sd35_encoders(p, cfg, device, weights,
                                             images=encodes_images(p))
        return {"encode_images": ei, "encode_captions": ec,
                "encode_pooled": ep, "decode_latents": dl}

    spec = FamilySpec(family="sd35", max_caption_len=cfg.max_caption_len,
                      default_resolution=RESOLUTION,
                      build_encoders=encoders, device=device)
    if sampler is None:
        sampler = build_family_sampler(params, spec, holder)

    def batch_transform(batch, out):
        b = out["latents"].shape[0]
        out["pooled_text"] = (
            np.asarray(batch.pooled_text, np.float32)
            if batch.pooled_text is not None
            else np.zeros((b, cfg.pooled_dim), np.float32))
        return out

    trainer = Trainer(params, model, loss, sampler=sampler, device=device,
                      preservation_loss=pres,
                      batch_transform=batch_transform)
    trainer.mmdit_config = cfg
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
    """``python -m yat_tpu_torch.frontends.sd35 --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
