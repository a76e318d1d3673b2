"""SANA frontend: config → denoiser, encoders, decoder, trainer, pipeline.

Counterpart of ``yat_tpu/frontends/sana.py``: ``make_trainer`` wires the
training path (LoRA or full fine-tuning, flow-matching loss, the
preservation term, local feature shards, validation when prompts are
configured) and ``make_pipeline`` the serving path.  The
denoiser loads from a diffusers checkpoint (``pretrained_model_path``, or
``transformer/`` of ``pretrained_pipe_path``, whose ``config.json`` sets
the architecture), Gemma-2 and the DC-AE from ``text_encoder/`` and
``vae/`` of ``pretrained_pipe_path``; without those paths the modules are
random from ``dataset_seed``, as in the JAX frontend.  Tests may pass JAX
parameter trees instead (``weights``).

    python -m yat_tpu_torch.frontends.sana --config cfg.yaml [--device cpu]
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.frontends.common import (
    build_backbone,
    build_feature_sampler,
    build_pipe_component,
    cli_main,
    find_model_config_json,
    make_prompt_encoder,
    make_tiling_decoder,
    override_config,
    slice_caption_rung,
    staged,
)
from yat_tpu_torch.models.sana import (
    SANA_600M,
    SANA_1600M,
    SanaConfig,
    SanaTransformer2D,
)
from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
from yat_tpu_torch.train.engine import Trainer, stored_dtype
from yat_tpu_torch.train.tasks import (make_flow_matching_loss,
                                      make_preservation_loss)
from yat_tpu_torch.train.validation import ValidationPipeline, enhance_prompt

PRESETS = {"600M": SANA_600M, "1600M": SANA_1600M}


def build_sana_config(params: TrainingParameters) -> SanaConfig:
    """The preset (``model_config_overrides.preset``), replaced by the
    diffusers ``config.json`` next to the weights when a pretrained path
    has one (its head counts, caption channels, ``qk_norm`` and the
    softmax ``modified_blocks``), then the overrides."""
    cfg = SANA_600M
    over = dict(params.model_config_overrides)
    preset = over.pop("preset", None)
    if preset:
        cfg = PRESETS[preset]
    if params.pretrained_model_path or params.pretrained_pipe_path:
        dj = find_model_config_json(params)
        if dj is not None:
            heads = dj.get("num_attention_heads", cfg.num_attention_heads)
            head_dim = dj.get("attention_head_dim", cfg.attention_head_dim)
            cfg = SanaConfig(
                in_channels=dj.get("in_channels", cfg.in_channels),
                out_channels=dj.get("out_channels", cfg.out_channels),
                hidden_dim=heads * head_dim,
                num_layers=dj.get("num_layers", cfg.num_layers),
                num_attention_heads=heads,
                attention_head_dim=head_dim,
                num_cross_attention_heads=dj.get(
                    "num_cross_attention_heads",
                    cfg.num_cross_attention_heads),
                cross_attention_head_dim=dj.get(
                    "cross_attention_head_dim", cfg.cross_attention_head_dim),
                caption_channels=dj.get("caption_channels",
                                        cfg.caption_channels),
                mlp_ratio=dj.get("mlp_ratio", cfg.mlp_ratio),
                patch_size=dj.get("patch_size", cfg.patch_size),
                sample_size=dj.get("sample_size", cfg.sample_size),
                softmax_self_attn_blocks=tuple(
                    int(i) for i in dj.get("modified_blocks", ())),
                qk_norm=dj.get("qk_norm", cfg.qk_norm))
    return override_config(cfg, over, mirror_out_channels=True)


def build_encoders(params: TrainingParameters, cfg: SanaConfig,
                   device: torch.device,
                   weights: Optional[Mapping] = None):
    """Gemma-2 caption encoder and DC-AE decoder as callables.

    ``encode_captions(captions)`` → list of fp32 ``[L_i, D]`` host arrays
    (tokenize, trim to the caption rung, encode, mask-compress);
    ``decode_latents(z)`` → NHWC images (fp32; tiled under ``low_vram``).
    The weights are the JAX parameter trees under ``"text_encoder"`` and
    ``"vae"`` of ``weights`` when given (the VAE tree needs only its
    ``"decoder"`` part), else they load from ``text_encoder/`` and ``vae/``
    of ``pretrained_pipe_path`` where present, else they are random.
    Under ``low_vram`` both rest on the host between calls.  The Gemma
    module rides along as ``encode_captions.module`` (``chip_smoke.py``
    checks its weights)."""
    from yat_tpu_torch.models.convert import convert_gemma2
    from yat_tpu_torch.models.convert_dcae import convert_dcae
    from yat_tpu_torch.models.text_encoders import (
        GEMMA2_2B, GEMMA_TINY_TEST, Gemma2Encoder, compress_embeddings)
    from yat_tpu_torch.models.vae import DCAE, DCAE_SANA, DCAE_TINY_TEST
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    weights = weights or {}
    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    te_cfg = GEMMA_TINY_TEST if tiny else GEMMA2_2B
    vae_cfg = DCAE_TINY_TEST if tiny else DCAE_SANA
    low = params.low_vram
    te = build_pipe_component(
        params, "text_encoder",
        lambda sd: convert_gemma2(sd, te_cfg.num_layers),
        lambda: Gemma2Encoder(te_cfg, dtype=dtype), device,
        params.dataset_seed + 1, dtype if params.bfloat16 else None,
        weights.get("text_encoder"))
    vae = build_pipe_component(
        params, "vae", lambda sd: convert_dcae(sd, vae_cfg),
        lambda: DCAE(vae_cfg), device, params.dataset_seed + 2,
        tree=weights.get("vae"), pick="decoder")
    tokenize = load_tokenizer(params.pretrained_pipe_path,
                              vocab_size=te_cfg.vocab_size,
                              max_length=cfg.max_caption_len)

    @torch.inference_mode()
    def encode_captions(captions):
        ids, mask = tokenize(list(captions), max_length=cfg.max_caption_len)
        ids, mask = slice_caption_rung(ids, mask)
        with staged(te, device, low):
            hidden = te(torch.as_tensor(ids, device=device),
                        torch.as_tensor(mask, device=device))
        return compress_embeddings(hidden, mask)

    encode_captions.module = te
    return encode_captions, make_tiling_decoder(vae, device, low)


def build_denoiser(params: TrainingParameters, cfg: SanaConfig, device,
                   tree=None, store=None, remat: bool = False):
    """The SANA denoiser (see ``common.build_backbone``)."""
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    return build_backbone(
        lambda: SanaTransformer2D(cfg, dtype=dtype,
                                  gradient_checkpointing=remat),
        params, "sana", cfg, device, tree, store)


def make_pipeline(params: TrainingParameters, device=None,
                  weights: Optional[Mapping] = None) -> ValidationPipeline:
    """The SANA serving pipeline: SANA denoiser (bf16 when ``bfloat16``
    is set, its parameters stored in bf16 too), Gemma-2 encoder (same), and
    the fp32 DC-AE decoder; 20 flow-match Euler steps at shift 3.0, CFG 5.0,
    prompt enhancement, seed 42, refiner gating on ``timesteps``.
    ``device`` defaults to ``cuda``.  The weights come from the pretrained
    paths, or from JAX parameter trees under ``"transformer"``,
    ``"text_encoder"`` and ``"vae"`` of ``weights``, else at random."""
    device = resolve_device(device)
    cfg = build_sana_config(params)
    weights = weights or {}
    model = build_denoiser(params, cfg, device, weights.get("transformer"),
                           torch.bfloat16 if params.bfloat16 else None)
    encode_captions, decode_latents = build_encoders(params, cfg, device,
                                                     weights)
    return _pipeline(params, cfg, model, encode_captions, decode_latents,
                     device)


def _pipeline(params, cfg, model, encode_captions, decode_latents, device):
    """The 20-step flow-match Euler, CFG 5.0 sampler around ``model``."""
    lat = cfg.sample_size
    return ValidationPipeline(
        model, FlowMatchSchedule(shift=3.0),
        latent_shape=(lat, lat, cfg.in_channels),
        encode_prompts=make_prompt_encoder(encode_captions,
                                           cfg.max_caption_len, device),
        decode_latents=decode_latents,
        guidance_scale=5.0, num_steps=20,
        prompt_transform=enhance_prompt, params=params, device=device,
        active_timesteps=params.timesteps or None)


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
    """The SANA trainer (LoRA, or full fine-tuning without an adapter
    spec): the denoiser (bf16 compute, with a bf16 frozen base under LoRA
    when ``bfloat16`` is set, fp32 leaves under full fine-tuning, or an
    int8/int4 base quantized from fp32 by the trainer, remat under
    ``low_vram``; loaded from the pretrained paths before any
    quantization), the flow-matching loss at shift 3.0 (and the
    preservation term under ``use_preservation``), the export's
    ``config.json`` for softmax-patched blocks or ``qk_norm``, the local
    feature-shard sampler, and with ``validation_prompts`` the
    Gemma-2 encoder (its empty caption feeds unconditional-caption
    dropout), the DC-AE decoder and the 20-step CFG 5.0 validation
    pipeline on the live model (on its EMA leaves under ``use_ema``;
    refiner-gated on ``timesteps``).  ``device`` defaults to ``cuda``;
    ``weights`` may hold JAX parameter trees as for
    :func:`make_pipeline`."""
    device = resolve_device(device)
    cfg = build_sana_config(params)
    weights = weights or {}
    model = build_denoiser(params, cfg, device, weights.get("transformer"),
                           stored_dtype(params), remat=params.low_vram)
    schedule = FlowMatchSchedule(shift=3.0)
    loss = make_flow_matching_loss(model, schedule,
                                   timestep_list=params.timesteps or None)
    pres = (make_preservation_loss(model, schedule, is_flow=True)
            if params.use_preservation else None)
    if sampler is None:
        sampler = build_sampler(params, cfg)
    trainer = Trainer(params, model, loss, sampler=sampler, device=device,
                      preservation_loss=pres)
    trainer.sana_config = cfg
    trainer.schedule = schedule
    if cfg.softmax_self_attn_blocks or cfg.qk_norm:
        # the export records the architecture flags, so a reload through
        # pretrained_model_path builds the same model
        trainer.model_config_json = {}
        if cfg.softmax_self_attn_blocks:
            trainer.model_config_json["modified_blocks"] = [
                int(i) for i in cfg.softmax_self_attn_blocks]
        if cfg.qk_norm:
            trainer.model_config_json["qk_norm"] = cfg.qk_norm
    if params.validation_prompts:
        encode_captions, decode_latents = build_encoders(params, cfg, device,
                                                         weights)
        trainer.encode_captions = encode_captions
        pipeline = _pipeline(params, cfg, model, encode_captions,
                             decode_latents, device)
        trainer.validation_pipeline = pipeline
        trainer.validate_fn = pipeline.validate
    return trainer


def main(argv: Optional[list] = None):
    """``python -m yat_tpu_torch.frontends.sana --config cfg.yaml
    [--device cuda|cpu]``; returns the trainer after its run."""
    return cli_main(make_trainer, argv)


if __name__ == "__main__":
    main()
