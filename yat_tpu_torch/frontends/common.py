"""Frontend helpers shared by the model families.

Counterparts of the helpers of ``yat_tpu/frontends/common.py`` that the
SANA and PixArt-Sigma paths need: YAML config overrides, the caption rung
slicer, the module builder (random weights from a seed, or a JAX parameter
tree), the prompt encoder's padding, the T5 caption encoder and KL-VAE
decoder of ``build_t5_vae_encoders``, the local feature-shard sampler and
the training CLI (``cli_main``, which adds ``--device`` to the JAX
package's ``--config``).  Streaming from URLs or R2, the image encoders and
the feature-extraction phase are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.convert import load_flax_params
from yat_tpu_torch.data.sampler import (
    FeatureBucketSampler,
    LocalShardSource,
    caption_length_buckets,
    caption_rung,
    pad_embeddings,
)
from yat_tpu_torch.models.layers import init_params
from yat_tpu_torch.parallel.multihost import host_seed


def slice_caption_rung(ids, mask, multiple: int = 64):
    """Trim tokenized captions to the smallest ``multiple``-token rung
    covering the batch's longest real caption before the text-encoder
    forward.  Outputs at kept positions are unchanged: padding is masked out
    of attention and positions are absolute."""
    m = np.asarray(mask)
    real = int(m.sum(axis=1).max()) if m.any() else 1
    rung = caption_rung(real, ids.shape[1], multiple)
    if rung == ids.shape[1]:
        return ids, mask
    return ids[:, :rung], mask[:, :rung]


def build_module(module_fn, device, tree, seed, dtype=None):
    """Construct a module on ``device`` (no host copy of its parameters),
    then load the JAX parameter ``tree`` or initialise it from ``seed``;
    optionally store the parameters in ``dtype``.  Returns it in eval
    mode."""
    with torch.device(device):
        module = module_fn()
    if tree is not None:
        load_flax_params(module, tree)
    else:
        init_params(module, torch.Generator(device=device).manual_seed(seed))
    if dtype is not None:
        module.to(dtype)
    return module.eval()


def make_prompt_encoder(encode_captions, max_len: int, device):
    """Prompt strings → the conditioning the denoiser consumes: the encoded
    captions padded to ``max_len`` tokens, ``{"embeddings", "text_mask"}``
    on ``device``."""

    def encode(prompts):
        padded, mask = pad_embeddings(encode_captions(list(prompts)), max_len)
        return {"embeddings": torch.as_tensor(padded, device=device),
                "text_mask": torch.as_tensor(mask, device=device)}

    return encode


def build_t5_vae_encoders(params: TrainingParameters, device,
                          max_caption_len: int = 300,
                          weights: Optional[Mapping] = None):
    """The T5 caption encoder and the fp32 KL-VAE decoder of the
    PixArt-Sigma path as callables (T5-XXL and SD's VAE, or their tiny test
    configurations under ``tiny_encoders``).

    ``encode_captions(captions)`` → list of fp32 ``[L_i, D]`` host arrays
    (tokenize to ``max_caption_len``, trim to the caption rung, encode,
    mask-compress); ``decode_latents(z)`` → NHWC images (fp32).  ``weights``
    may hold JAX parameter trees under ``"text_encoder"`` and ``"vae"`` (the
    VAE tree needs only its ``"decoder"`` part); without them the modules
    are random from ``dataset_seed``.  The image encoder waits for the
    precompute slice (ROADMAP queue 1, item 8)."""
    from yat_tpu_torch.models.text_encoders import (
        T5_TINY_TEST, T5_XXL, T5Encoder, compress_embeddings)
    from yat_tpu_torch.models.vae import (
        KLVAE_SD15, KLVAE_TINY_TEST, AutoencoderKL)
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    weights = weights or {}
    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    te_cfg = T5_TINY_TEST if tiny else T5_XXL
    te = build_module(lambda: T5Encoder(te_cfg, dtype=dtype), device,
                      weights.get("text_encoder"), params.dataset_seed + 1,
                      dtype if params.bfloat16 else None)
    vae_tree = weights.get("vae")
    vae = build_module(
        lambda: AutoencoderKL(KLVAE_TINY_TEST if tiny else KLVAE_SD15),
        device, {"decoder": vae_tree["decoder"]} if vae_tree else None,
        params.dataset_seed + 2)
    tokenize = load_tokenizer(params.pretrained_pipe_path,
                              vocab_size=te_cfg.vocab_size,
                              max_length=max_caption_len)

    @torch.inference_mode()
    def encode_captions(captions):
        ids, mask = tokenize(list(captions), max_length=max_caption_len)
        ids, mask = slice_caption_rung(ids, mask)
        hidden = te(torch.as_tensor(ids, device=device),
                    torch.as_tensor(mask, device=device))
        return compress_embeddings(hidden, mask)

    @torch.inference_mode()
    def decode_latents(z):
        return vae.decode(z)

    return encode_captions, decode_latents


def _coerce_like(cur, v):
    if cur is None:
        # Optional fields: infer numeric types from the value itself
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    return v
        return v
    if isinstance(cur, bool):
        return str(v).lower() in ("1", "true", "yes")
    if isinstance(cur, (tuple, list)):
        elem_t = type(cur[0]) if len(cur) else int
        return type(cur)(elem_t(x) for x in v)
    return type(cur)(v)


def override_config(cfg, overrides: dict, mirror_out_channels: bool = False):
    """Apply YAML ``model_config_overrides``, coercing string values to the
    field's type (tuple fields element-wise).  Keys unknown to this config
    (frontend-level knobs) are skipped.  ``mirror_out_channels``: an
    ``in_channels`` override also sets ``out_channels`` unless that is
    overridden too (velocity families predict in the latent space)."""
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        if k == "preset" or not hasattr(cfg, k):
            continue
        typed[k] = _coerce_like(getattr(cfg, k), v)
    if (mirror_out_channels and "in_channels" in typed
            and "out_channels" not in typed and hasattr(cfg, "out_channels")):
        typed["out_channels"] = typed["in_channels"]
    return dataclasses.replace(cfg, **typed)


def make_local_source(params: TrainingParameters) -> LocalShardSource:
    """The local shard source of process 0 (one process: every path), its
    shuffle seeded with ``host_seed(dataset_seed)`` as in the JAX
    package."""
    return LocalShardSource(list(params.local_shard_paths),
                            seed=host_seed(params.dataset_seed))


def build_feature_sampler(params: TrainingParameters, max_caption_len: int):
    """The pre-extracted feature-shard sampler over ``local_shard_paths``;
    None when no data source is configured."""
    if params.urls or params.r2_endpoint:
        raise NotImplementedError(
            "streaming feature shards from urls or R2 is not implemented in "
            "the PyTorch port yet (ROADMAP queue 1, item 8); use "
            "local_shard_paths")
    if not params.local_shard_paths:
        return None
    cb = (caption_length_buckets(max_caption_len)
          if params.caption_length_bucketing else None)
    return FeatureBucketSampler(make_local_source(params), params.batch_size,
                                max_caption_len, seed=params.dataset_seed,
                                caption_buckets=cb,
                                bucket_repeat=params.bucket_repeat)


def cli_main(make_trainer: Callable[..., object],
             argv: Optional[list] = None):
    """``--config config.yaml [--device cuda|cpu]``: build the trainer on
    the device (the card unless asked otherwise) and run it; returns the
    trainer."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    params = TrainingParameters.read_yaml(args.config)
    if params.extract_features or params.compute_features:
        raise NotImplementedError(
            "feature extraction and on-the-fly encoding are not implemented "
            "in the PyTorch port yet (ROADMAP queue 1, item 8)")
    trainer = make_trainer(params, device=args.device)
    trainer.run()
    return trainer
