"""Flux-2 Klein frontend: the Flux transformer with Gemma-2-2B and the
16-channel KL-VAE; trainer and pipeline.

Counterpart of ``yat_tpu/frontends/flux.py``: Gemma-2-2B in fp32 encodes
captions of up to 512 tokens (trimmed to the batch's caption rung, then
mask-compressed), the KL-VAE (``KLVAE_FLUX``: scale 0.3611, shift
0.1159, fp32) encodes and decodes; training is flow matching on 2x2-
patchified, packed latents with the dynamic shift of the token count
(``make_flux_loss``; the latents are not standardized: neither package
has the VAE's batch-norm statistics), validation and serving 20 Euler
steps in token space at CFG 7.0 with the guidance embedding at 7.0, seed
42, prompts padded to 512 tokens, 1024 px bins.  The velocity cache is
honoured; DPM-Solver++(2M) is refused, as in the JAX package.  Weights load
from ``pretrained_pipe_path`` (``transformer/``, ``text_encoder/``,
``vae/``) or ``pretrained_model_path``; tests may pass JAX trees under
those names in ``weights``.

    python -m yat_tpu_torch.frontends.flux --config cfg.yaml [--device cpu]

``text_dim`` must be the caption encoder's width (2304 for Gemma-2-2B,
32 for its tiny test configuration).  The JAX package's preset holds 4096
and fails at its first step with flax's ``ScopeParamShapeError`` for
``/txt_in`` (ROADMAP §3); the port raises a ``ValueError`` before any
weight is built, wherever it builds the encoder (serving, validation,
encoding images).  Under ``low_vram`` each block is recomputed in the
backward, the encoders' and the VAE's weights rest on the host between
calls, and the decode is tiled.
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
    encodes_images,
    ensure_encoders,
    make_caption_encoder,
    make_image_encoder,
    make_prompt_encoder,
    make_tiling_decoder,
    override_config,
)
from yat_tpu_torch.models.flux import (FLUX2_KLEIN, FluxConfig,
                                       FluxTransformer, unpack_latents,
                                       unpatchify_latents)
from yat_tpu_torch.ops.sampling import sample_flux
from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
from yat_tpu_torch.train.engine import Trainer, stored_dtype
from yat_tpu_torch.train.tasks import make_flux_loss
from yat_tpu_torch.train.validation import ValidationPipeline

FLUX_CAPTION_LEN = 512
RESOLUTION = 1024
# the KL-VAE's 8x, then the 2x2 patch: one token per 16 px
TOKEN_PX = 16


def build_config(params: TrainingParameters) -> FluxConfig:
    return override_config(FLUX2_KLEIN, params.model_config_overrides,
                           mirror_out_channels=True)


def flux_schedule() -> FlowMatchSchedule:
    return FlowMatchSchedule(use_dynamic_shifting=True, shift=3.0)


def text_encoder_config(params: TrainingParameters):
    """Gemma-2-2B, or its tiny test configuration under
    ``tiny_encoders``."""
    from yat_tpu_torch.models.text_encoders import GEMMA2_2B, GEMMA_TINY_TEST
    if params.model_config_overrides.get("tiny_encoders"):
        return GEMMA_TINY_TEST
    return GEMMA2_2B


def vae_config(params: TrainingParameters):
    """``KLVAE_FLUX``, or the tiny test VAE with 16 channels and Flux's
    shift under ``tiny_encoders`` (its scale stays the tiny one's, as in
    the JAX builder)."""
    from yat_tpu_torch.models.vae import KLVAE_FLUX, KLVAE_TINY_TEST
    if params.model_config_overrides.get("tiny_encoders"):
        return dataclasses.replace(KLVAE_TINY_TEST, latent_channels=16,
                                   shift_factor=KLVAE_FLUX.shift_factor)
    return KLVAE_FLUX


def check_text_dim(params: TrainingParameters, cfg: FluxConfig) -> None:
    """Raise unless ``cfg.text_dim`` is the width of the caption encoder
    that ``params`` builds (``txt_in`` is never resized)."""
    width = text_encoder_config(params).hidden_dim
    if cfg.text_dim != width:
        raise ValueError(
            f"Flux's text_dim is {cfg.text_dim} but its caption encoder "
            f"(Gemma-2) gives {width}-wide states: set "
            f"model_config_overrides.text_dim: {width} (the JAX package "
            "builds txt_in from the preset's 4096 and fails at its first "
            "step with flax's ScopeParamShapeError for /txt_in)")


def builds_encoders(params: TrainingParameters) -> bool:
    """Whether a training run builds the caption encoder: validation
    prompts, or a run that encodes images (on the fly, Dreambooth,
    extraction); a feature-shard run without prompts builds none."""
    return bool(params.validation_prompts) or encodes_images(params)


def build_flux_encoders(params: TrainingParameters, device,
                        weights: Optional[Mapping] = None,
                        images: bool = True):
    """``(encode_images, encode_captions, decode_latents)`` of Flux:
    the fp32 KL-VAE of :func:`vae_config` (its decoder alone without
    ``images``, and ``encode_images`` None) and Gemma-2 in fp32 (as the JAX
    builder has it) on captions of up to 512 tokens (tokenize, trim to the
    caption rung, encode, mask-compress).  The weights are the JAX trees
    under ``"text_encoder"`` and ``"vae"`` of ``weights`` when given, else
    ``text_encoder/`` and ``vae/`` of ``pretrained_pipe_path`` where
    present, else random from ``dataset_seed``."""
    from yat_tpu_torch.models.convert import convert_gemma2
    from yat_tpu_torch.models.convert_unet import convert_vae_kl
    from yat_tpu_torch.models.text_encoders import Gemma2Encoder
    from yat_tpu_torch.models.vae import AutoencoderKL
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    weights = weights or {}
    low = params.low_vram
    te_cfg, vae_cfg = text_encoder_config(params), vae_config(params)
    te = build_pipe_component(
        params, "text_encoder",
        lambda sd: convert_gemma2(sd, te_cfg.num_layers),
        lambda: Gemma2Encoder(te_cfg, dtype=torch.float32), device,
        params.dataset_seed + 1, tree=weights.get("text_encoder"))
    vae = build_pipe_component(
        params, "vae", lambda sd: convert_vae_kl(
            sd, vae_cfg.block_out_channels, vae_cfg.layers_per_block),
        lambda: AutoencoderKL(vae_cfg, encoder=images), device,
        params.dataset_seed + 2, tree=weights.get("vae"))
    tokenize = load_tokenizer(params.pretrained_pipe_path,
                              vocab_size=te_cfg.vocab_size,
                              max_length=FLUX_CAPTION_LEN)
    return (make_image_encoder(vae, device, low) if images else None,
            make_caption_encoder(te, tokenize, FLUX_CAPTION_LEN, device, low),
            make_tiling_decoder(vae, device, low))


def build_transformer(params: TrainingParameters, cfg: FluxConfig, device,
                      tree=None, store=None, remat: bool = False):
    """The Flux transformer (see ``common.build_backbone``): bf16 compute
    under ``bfloat16``, remat under ``low_vram`` when training."""
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    return build_backbone(
        lambda: FluxTransformer(cfg, dtype=dtype,
                                gradient_checkpointing=remat),
        params, "flux", cfg, device, tree, store)


class FluxPipeline(ValidationPipeline):
    """The counterpart of the JAX ``FluxValidate``: prompts padded to 512
    tokens, :func:`~yat_tpu_torch.ops.sampling.sample_flux` on a ``gh`` x
    ``gw`` token grid (the guidance embedding at ``guidance_scale`` and
    true CFG), the tokens unpacked and unpatchified, then decoded; images
    ``(x + 1) / 2``.  The velocity cache applies; DPM does not
    (``set_sampler`` refuses it)."""

    supports_dpm = False

    def __init__(self, model, grid_hw, encode_prompts, decode_latents,
                 params=None, device=None):
        self.grid_hw = tuple(grid_hw)
        super().__init__(
            model, flux_schedule(),
            latent_shape=(*self.grid_hw, model.cfg.in_channels),
            encode_prompts=encode_prompts, decode_latents=decode_latents,
            guidance_scale=7.0, num_steps=20, seed=42, params=params,
            device=device)

    def sample_latents(self, cond, uncond, x0=None) -> torch.Tensor:
        tokens = sample_flux(
            self.model, self.schedule, self.grid_hw, cond["embeddings"],
            uncond_emb=uncond["embeddings"],
            guidance_scale=self.guidance_scale, num_steps=self.num_steps,
            seed=self.seed, cache_interval=self.cache_interval,
            device=self.device, x0=x0)
        return unpatchify_latents(unpack_latents(tokens, self.grid_hw))

    @staticmethod
    def to_unit(img: np.ndarray) -> np.ndarray:
        return np.clip((img + 1) / 2, 0, 1)


def _pipeline(params, model, encode_captions, decode_latents, device):
    side = (params.aspect_ratios or RESOLUTION) // TOKEN_PX
    return FluxPipeline(
        model, (side, side),
        make_prompt_encoder(encode_captions, FLUX_CAPTION_LEN, device),
        decode_latents, params=params, device=device)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> FluxPipeline:
    """The Flux serving pipeline: the transformer (bf16 when ``bfloat16``
    is set, stored in bf16 too), Gemma-2 and the KL-VAE decoder in fp32;
    20 Euler steps with the dynamic shift, CFG 7.0 and guidance 7.0, seed
    42.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = build_config(params)
    check_text_dim(params, cfg)
    weights = weights or {}
    model = build_transformer(params, cfg, device, weights.get("transformer"),
                              torch.bfloat16 if params.bfloat16 else None)
    attach_pretrained_adapters(model, params, device)
    _, ec, dl = build_flux_encoders(params, device, weights, images=False)
    return _pipeline(params, model, ec, dl, device)


def make_trainer(params: TrainingParameters, sampler=None, device=None,
                 weights: Optional[Mapping] = None) -> Trainer:
    """The Flux trainer (any adapter kind, or full fine-tuning): the
    transformer (bf16 frozen base under adapters and ``bfloat16``, remat
    under ``low_vram``), ``make_flux_loss`` at shift 3.0 with dynamic
    shifting, the sampler of ``common.build_family_sampler``, and with
    ``validation_prompts`` the encoders and :class:`FluxPipeline` on the
    live model (on its EMA leaves under ``use_ema``).  ``text_dim`` is
    checked before any weight is built when the run builds the caption
    encoder.  ``device`` defaults to ``cuda``."""
    device = resolve_device(device)
    cfg = build_config(params)
    if builds_encoders(params):
        check_text_dim(params, cfg)
    weights = weights or {}
    model = build_transformer(params, cfg, device, weights.get("transformer"),
                              stored_dtype(params), remat=params.low_vram)
    schedule = flux_schedule()
    loss = make_flux_loss(model, schedule,
                          timestep_list=params.timesteps or None)
    holder: dict = {}

    def encoders(p):
        ei, ec, dl = build_flux_encoders(p, device, weights,
                                         images=encodes_images(p))
        return {"encode_images": ei, "encode_captions": ec,
                "decode_latents": dl}

    spec = FamilySpec(family="flux", max_caption_len=FLUX_CAPTION_LEN,
                      default_resolution=RESOLUTION,
                      build_encoders=encoders, device=device)
    if sampler is None:
        sampler = build_family_sampler(params, spec, holder)
    trainer = Trainer(params, model, loss, sampler=sampler, device=device)
    trainer.flux_config = cfg
    trainer.family_spec = spec
    trainer.schedule = schedule
    if params.validation_prompts:
        ensure_encoders(params, spec, holder)
        pipeline = _pipeline(params, model, holder["encode_captions"],
                             holder["decode_latents"], device)
        trainer.validation_pipeline = pipeline
        trainer.validate_fn = pipeline.validate
    for k, v in holder.items():
        setattr(trainer, k, v)
    return trainer


def main(argv: Optional[list] = None):
    """``python -m yat_tpu_torch.frontends.flux --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
