"""SANA frontend: config → denoiser, encoders, decoder, trainer, pipeline.

Counterpart of ``yat_tpu/frontends/sana.py``: ``make_trainer`` wires the
LoRA training path (flow-matching loss, local feature shards, validation
when prompts are configured) and ``make_pipeline`` the serving path.  The
repository holds no SANA, Gemma-2 or DC-AE weights, so the modules are
initialised at random from ``dataset_seed`` (as the JAX frontend does
without ``pretrained_pipe_path``), or loaded from JAX parameter trees
through ``convert.load_flax_params``.

    python -m yat_tpu_torch.frontends.sana --config cfg.yaml [--device cpu]
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    build_feature_sampler,
    build_module,
    cli_main,
    make_prompt_encoder,
    override_config,
    slice_caption_rung,
)
from yat_tpu_torch.models.sana import (
    SANA_600M,
    SANA_1600M,
    SanaConfig,
    SanaTransformer2D,
)
from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
from yat_tpu_torch.train.engine import Trainer, quantized_bits
from yat_tpu_torch.train.tasks import make_flow_matching_loss
from yat_tpu_torch.train.validation import ValidationPipeline, enhance_prompt

PRESETS = {"600M": SANA_600M, "1600M": SANA_1600M}


def build_sana_config(params: TrainingParameters) -> SanaConfig:
    if (params.pretrained_model_path or params.pretrained_pipe_path
            or params.pretrained_pipe_single_file):
        raise NotImplementedError(
            "loading pretrained checkpoints is not ported to PyTorch yet "
            "(ROADMAP queue 1, item 7); unset the pretrained paths to run "
            "with random weights")
    cfg = SANA_600M
    over = dict(params.model_config_overrides)
    preset = over.pop("preset", None)
    if preset:
        cfg = PRESETS[preset]
    return override_config(cfg, over, mirror_out_channels=True)


def build_encoders(params: TrainingParameters, cfg: SanaConfig,
                   device: torch.device,
                   weights: Optional[Mapping] = None):
    """Gemma-2 caption encoder and DC-AE decoder as callables.

    ``encode_captions(captions)`` → list of fp32 ``[L_i, D]`` host arrays
    (tokenize, trim to the caption rung, encode, mask-compress);
    ``decode_latents(z)`` → NHWC images (fp32).  ``weights`` may hold JAX
    parameter trees under ``"text_encoder"`` and ``"vae"`` (the VAE tree
    needs only its ``"decoder"`` part)."""
    from yat_tpu_torch.models.text_encoders import (
        GEMMA2_2B, GEMMA_TINY_TEST, Gemma2Encoder, compress_embeddings)
    from yat_tpu_torch.models.vae import DCAE, DCAE_SANA, DCAE_TINY_TEST
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    weights = weights or {}
    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    te_cfg = GEMMA_TINY_TEST if tiny else GEMMA2_2B
    te = build_module(lambda: Gemma2Encoder(te_cfg, dtype=dtype), device,
                      weights.get("text_encoder"), params.dataset_seed + 1,
                      dtype if params.bfloat16 else None)
    vae_tree = weights.get("vae")
    vae = build_module(lambda: DCAE(DCAE_TINY_TEST if tiny else DCAE_SANA),
                       device,
                       {"decoder": vae_tree["decoder"]} if vae_tree else None,
                       params.dataset_seed + 2)
    tokenize = load_tokenizer(params.pretrained_pipe_path,
                              vocab_size=te.cfg.vocab_size,
                              max_length=cfg.max_caption_len)

    @torch.inference_mode()
    def encode_captions(captions):
        ids, mask = tokenize(list(captions), max_length=cfg.max_caption_len)
        ids, mask = slice_caption_rung(ids, mask)
        hidden = te(torch.as_tensor(ids, device=device),
                    torch.as_tensor(mask, device=device))
        return compress_embeddings(hidden, mask)

    @torch.inference_mode()
    def decode_latents(z):
        return vae.decode(z)

    return encode_captions, decode_latents


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The SANA serving pipeline: SANA denoiser (bf16 when ``bfloat16``
    is set, its parameters stored in bf16 too), Gemma-2 encoder (same), and
    the fp32 DC-AE decoder; 20 flow-match Euler steps at shift 3.0, CFG 5.0,
    prompt enhancement, seed 42.  ``device`` defaults to ``cuda``.
    ``weights`` may hold JAX parameter trees under ``"transformer"``,
    ``"text_encoder"`` and ``"vae"``."""
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
    cfg = build_sana_config(params)
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    weights = weights or {}
    model = build_module(lambda: SanaTransformer2D(cfg, dtype=dtype),
                         device, weights.get("transformer"),
                         params.dataset_seed,
                         dtype if params.bfloat16 else None)
    encode_captions, decode_latents = build_encoders(params, cfg, device,
                                                     weights)
    lat = cfg.sample_size
    return ValidationPipeline(
        model, FlowMatchSchedule(shift=3.0),
        latent_shape=(lat, lat, cfg.in_channels),
        encode_prompts=make_prompt_encoder(encode_captions,
                                           cfg.max_caption_len, device),
        decode_latents=decode_latents,
        guidance_scale=5.0, num_steps=20,
        prompt_transform=enhance_prompt, params=params, device=device)


def build_sampler(params: TrainingParameters, cfg: SanaConfig):
    """The pre-extracted feature-shard sampler (local shards)."""
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
    """The SANA LoRA trainer: the denoiser (bf16 compute and a bf16 frozen
    base when ``bfloat16`` is set, or an int8/int4 base quantized from fp32
    by the trainer, remat under ``low_vram``), the
    flow-matching loss at shift 3.0, the local feature-shard sampler, and
    with ``validation_prompts`` the Gemma-2 encoder (its empty caption feeds
    unconditional-caption dropout), the DC-AE decoder and the 20-step CFG
    5.0 validation pipeline on the live model.  ``device`` defaults to
    ``cuda``; ``weights`` may hold JAX parameter trees as for
    :func:`make_pipeline`."""
    device = resolve_device(device)
    cfg = build_sana_config(params)
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    weights = weights or {}
    # a quantized base is quantized from the fp32 weights by the trainer,
    # which then stores the rest in bf16
    store = (dtype if params.bfloat16 and quantized_bits(params) is None
             else None)
    model = build_module(lambda: SanaTransformer2D(
        cfg, dtype=dtype, gradient_checkpointing=params.low_vram),
        device, weights.get("transformer"), params.dataset_seed, store)
    schedule = FlowMatchSchedule(shift=3.0)
    loss = make_flow_matching_loss(model, schedule,
                                   timestep_list=params.timesteps or None)
    if sampler is None:
        sampler = build_sampler(params, cfg)
    trainer = Trainer(params, model, loss, sampler=sampler, device=device)
    trainer.sana_config = cfg
    trainer.schedule = schedule
    if params.validation_prompts:
        if params.timesteps:
            raise NotImplementedError(
                "validation with refiner timestep gating is not implemented "
                "in the PyTorch port yet (ROADMAP queue 1, item 7)")
        encode_captions, decode_latents = build_encoders(params, cfg, device,
                                                         weights)
        trainer.encode_captions = encode_captions
        lat = cfg.sample_size
        pipeline = ValidationPipeline(
            model, schedule, latent_shape=(lat, lat, cfg.in_channels),
            encode_prompts=make_prompt_encoder(encode_captions,
                                               cfg.max_caption_len, device),
            decode_latents=decode_latents, guidance_scale=5.0, num_steps=20,
            prompt_transform=enhance_prompt, params=params, device=device)
        trainer.validate_fn = lambda tr: pipeline(
            list(params.validation_prompts))
    return trainer


def main(argv: Optional[list] = None):
    """``python -m yat_tpu_torch.frontends.sana --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
