"""Frontend helpers shared by the model families.

Counterparts of the helpers of ``yat_tpu/frontends/common.py`` that the
SANA and PixArt-Sigma paths need: YAML config overrides, the caption rung
slicer, the module builder (random weights from a seed, or a JAX parameter
tree), pretrained loading (``load_pretrained_backbone`` for the denoiser
from ``pretrained_model_path`` or ``pretrained_pipe_path/transformer``,
``load_pipe_component`` for the caption encoder and VAE of
``pretrained_pipe_path``), the ``low_vram`` staging of encoder and decoder
weights, the tiling decoder, the prompt encoder's padding, the T5 caption
encoder and KL-VAE decoder of ``build_t5_vae_encoders``, the local
feature-shard sampler and the training CLI (``cli_main``, which adds
``--device`` to the JAX package's ``--config``).  Streaming from URLs or
R2, the image encoders, the feature-extraction phase, the single-file
CompVis checkpoints and the PixelDiT hub fetch are not ported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.convert import flax_shapes, load_flax_params
from yat_tpu_torch.models.convert import CKPT_NAMES
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


# families whose converters are ported; the others wait for ROADMAP item 10
_PORTED_FAMILIES = ("sana", "pixart")
def _synced_seconds(t0: float, device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def pretrained_requested(params: TrainingParameters) -> bool:
    return bool(params.pretrained_model_path or params.pretrained_pipe_path
                or params.pretrained_pipe_single_file)


def _denoiser_candidates(params: TrainingParameters) -> list:
    candidates = []
    if params.pretrained_model_path:
        candidates.append(params.pretrained_model_path)
    if params.pretrained_pipe_path:
        for sub in ("transformer", "unet"):
            candidates.append(os.path.join(params.pretrained_pipe_path, sub))
    return candidates


def _find_denoiser_dir(params: TrainingParameters) -> Optional[str]:
    """The denoiser checkpoint directory among the three path keys:
    ``pretrained_model_path`` itself, or ``transformer/`` (``unet/``) of
    ``pretrained_pipe_path``."""
    for c in _denoiser_candidates(params):
        if os.path.isdir(c) and any(
                os.path.exists(os.path.join(c, n)) for n in CKPT_NAMES):
            return c
    return None


def find_model_config_json(params: TrainingParameters) -> Optional[dict]:
    """The diffusers ``config.json`` next to the denoiser weights, or None.
    It is looked up in the directories the weights load from (then in the
    configured ones, for a checkpoint the loader cannot index), so
    architecture flags such as ``qk_norm`` follow a pipe-path load."""
    dirpath = _find_denoiser_dir(params)
    for c in ([dirpath] if dirpath else []) + _denoiser_candidates(params):
        cfg_path = os.path.join(c, "config.json")
        if os.path.isdir(c) and os.path.exists(cfg_path):
            with open(cfg_path) as f:
                return json.load(f)
    return None


def load_pretrained_backbone(params: TrainingParameters, family: str, cfg):
    """The converted flax-layout tree of the denoiser checkpoint of
    ``pretrained_model_path`` or ``pretrained_pipe_path/transformer``, or
    None when no pretrained path is configured.  A full fine-tuning export
    of either package (``model.safetensors`` with flat flax keys, whose
    ``config.json`` carries the architecture flags) is read as the tree
    itself; the JAX loader converts diffusers keys only.

    Raises when a path is configured but no checkpoint is found (a random
    backbone is never trained or served silently), as the JAX package's
    loader does.  Loading the tree (:func:`build_backbone`, through
    ``convert.load_flax_params``) refuses orphan leaves and missing
    parameters other than a bias, and sets a missing bias to zero."""
    if not pretrained_requested(params):
        return None
    if family not in _PORTED_FAMILIES:
        raise NotImplementedError(
            f"pretrained {family} checkpoints are not ported to PyTorch yet "
            "(ROADMAP queue 1, item 10)")
    from yat_tpu_torch.models.convert import load_torch_state_dict

    dirpath = _find_denoiser_dir(params)
    if dirpath is None and params.pretrained_model_path and \
            os.path.isfile(params.pretrained_model_path):
        dirpath = params.pretrained_model_path
    if dirpath is None:
        for c in _denoiser_candidates(params):
            if os.path.isdir(c) and any(n.endswith(".index.json")
                                        for n in os.listdir(c)):
                load_torch_state_dict(c)   # raises: shards are not read
        raise ValueError(
            f"pretrained weights requested for {family} "
            f"(pretrained_model_path={params.pretrained_model_path!r}, "
            f"pretrained_pipe_path={params.pretrained_pipe_path!r}, "
            f"pretrained_pipe_single_file="
            f"{params.pretrained_pipe_single_file!r}) but no denoiser "
            "checkpoint was found — refusing to run a randomly "
            "initialized backbone")
    sd = load_torch_state_dict(dirpath)
    if any(k.endswith(".kernel") for k in sd):
        # the full fine-tuning export (``model.safetensors`` with flat
        # flax keys): already the tree, no converter
        tree: dict = {}
        for k, v in sd.items():
            *keys, leaf = k.split(".")
            node = tree
            for key in keys:
                node = node.setdefault(key, {})
            node[leaf] = v
        print(f"[{family}] read a full fine-tuning export from {dirpath}: "
              f"{len(sd)} tensors")
        return tree
    if family == "sana":
        from yat_tpu_torch.models.convert import convert_sana
        tree = convert_sana(sd, cfg.num_layers)
    else:
        from yat_tpu_torch.models.convert_dit import convert_pixart
        tree = convert_pixart(sd, cfg.num_layers)
    print(f"[{family}] read the pretrained backbone from {dirpath}: "
          f"{len(sd)} tensors")
    return tree


def load_pipe_component(params: TrainingParameters, sub: str, convert):
    """The converted tree of ``pretrained_pipe_path/sub`` (the caption
    encoder's ``text_encoder/`` or the ``vae/``), or None when the pipe
    path or that directory is absent (the component is then random, as in
    the JAX package).  ``convert(state_dict) -> tree``."""
    if not params.pretrained_pipe_path:
        return None
    path = os.path.join(params.pretrained_pipe_path, sub)
    if not os.path.isdir(path):
        return None
    from yat_tpu_torch.models.convert import load_torch_state_dict
    return convert(load_torch_state_dict(path))


def build_pipe_component(params: TrainingParameters, sub: str, convert,
                         module_fn, device, seed, dtype=None, tree=None,
                         pick: Optional[str] = None):
    """A caption encoder or VAE of the pipe directory: the JAX parameter
    ``tree`` when given, else ``pretrained_pipe_path/sub`` converted by
    ``convert(state_dict)`` where present (its ``pick`` half for a VAE),
    else random from ``seed`` (:func:`build_component`).  A module loaded
    from its file carries the seconds that took in ``load_seconds``, which
    ``chip_smoke.py`` reports."""
    t0 = time.perf_counter()
    from_file = tree is None
    if from_file:
        tree = load_pipe_component(params, sub, convert)
    if tree is not None and pick:
        tree = {pick: tree[pick]}
    module = build_component(module_fn, device, tree, seed, dtype,
                             params.low_vram)
    if from_file and tree is not None:
        module.load_seconds = _synced_seconds(t0, device)
        print(f"[{sub}] loaded {os.path.join(params.pretrained_pipe_path, sub)}"
              f" in {module.load_seconds:.1f} s")
    return module


def build_component(module_fn, device, tree, seed, dtype=None,
                    low_vram: bool = False):
    """A caption encoder or VAE: :func:`build_module` on ``device`` with
    the converted ``tree`` merged strictly (every parameter must be in it;
    leaves the module has no place for, such as a VAE's encoder half, are
    dropped), or random from ``seed``.  Under ``low_vram`` its weights then
    rest on the host (:func:`staged` brings them to the device for a
    call)."""
    if tree is not None:
        from yat_tpu_torch.models.convert import merge_into
        with torch.device("meta"):
            shapes = flax_shapes(module_fn())
        tree = merge_into(shapes, tree)
    module = build_module(module_fn, device, tree, seed, dtype)
    if low_vram:
        module.to("cpu")
    return module


@contextlib.contextmanager
def staged(module, device, low_vram: bool):
    """Hold ``module``'s weights on ``device`` for the block; under
    ``low_vram`` they go back to the host after it (the counterpart of the
    JAX package's ``host_offload_vars``: the device never holds encoder or
    decoder weights at rest)."""
    if not low_vram:
        yield module
        return
    module.to(device)
    try:
        yield module
    finally:
        module.to("cpu")


def make_tiling_decoder(vae, device, low_vram: bool):
    """``decode_latents(z)`` with the VAE-tiling rule of the JAX package:
    tiles of 64 latents under ``low_vram`` (whose decoder weights come to
    the device for the whole decode, once), of 128 once the image reaches
    2048 px; a whole decode otherwise.  The VAE rides along as
    ``decode_latents.module``, where ``chip_smoke.py`` checks its loaded
    weights and where they rest."""
    from yat_tpu_torch.models.vae import decode_tiled

    @torch.inference_mode()
    def decode_latents(z):
        comp = vae.cfg.compression
        px = max(int(z.shape[1]), int(z.shape[2])) * comp
        with staged(vae, device, low_vram):
            if low_vram or px >= 2048:
                return decode_tiled(vae, z,
                                    tile_latent=64 if low_vram else 128)
            return vae.decode(z)

    decode_latents.module = vae
    return decode_latents


def build_backbone(module_fn, params: TrainingParameters, family: str, cfg,
                   device, tree=None, dtype=None):
    """The denoiser on ``device``: from the JAX parameter ``tree`` when
    given, else from the pretrained checkpoint when a path is configured
    (:func:`load_pretrained_backbone`), else random from ``dataset_seed``;
    then stored in ``dtype`` when given (a quantized base stays fp32 until
    the trainer quantizes it).  A backbone loaded from its file carries the
    seconds from file to device in ``load_seconds``, which ``chip_smoke.py``
    reports."""
    if tree is not None or not pretrained_requested(params):
        return build_module(module_fn, device, tree, params.dataset_seed,
                            dtype)
    t0 = time.perf_counter()
    tree = load_pretrained_backbone(params, family, cfg)
    try:
        module = build_module(module_fn, device, tree, params.dataset_seed,
                              dtype)
    except KeyError as e:
        raise ValueError(f"the {family} checkpoint does not fit the model "
                         f"({e.args[0]}): converter/checkpoint mismatch"
                         ) from e
    module.load_seconds = _synced_seconds(t0, device)
    print(f"[{family}] the backbone took {module.load_seconds:.1f} s "
          f"from file to {device}")
    return module


def make_prompt_encoder(encode_captions, max_len: int, device):
    """Prompt strings → the conditioning the denoiser consumes: the encoded
    captions padded to ``max_len`` tokens, ``{"embeddings", "text_mask"}``
    on ``device``.  ``encode.encode_captions`` keeps the caption encoder
    callable for the measurements of ``chip_smoke.py``."""

    def encode(prompts):
        padded, mask = pad_embeddings(encode_captions(list(prompts)), max_len)
        return {"embeddings": torch.as_tensor(padded, device=device),
                "text_mask": torch.as_tensor(mask, device=device)}

    encode.encode_captions = encode_captions
    return encode


def build_t5_vae_encoders(params: TrainingParameters, device,
                          max_caption_len: int = 300,
                          weights: Optional[Mapping] = None):
    """The T5 caption encoder and the fp32 KL-VAE decoder of the
    PixArt-Sigma path as callables (T5-XXL and SD's VAE, or their tiny test
    configurations under ``tiny_encoders``).

    ``encode_captions(captions)`` → list of fp32 ``[L_i, D]`` host arrays
    (tokenize to ``max_caption_len``, trim to the caption rung, encode,
    mask-compress); ``decode_latents(z)`` → NHWC images (fp32).  The
    weights are the JAX parameter trees under ``"text_encoder"`` and
    ``"vae"`` of ``weights`` when given, else they load from
    ``pretrained_pipe_path``'s ``text_encoder/`` and ``vae/`` where present
    (the VAE's decoder half), else they are random from ``dataset_seed``;
    under ``low_vram`` both rest on the host.  The T5 module rides along as
    ``encode_captions.module`` (``chip_smoke.py`` checks its weights).
    The image encoder waits for the precompute slice (ROADMAP queue 1,
    item 8)."""
    from yat_tpu_torch.models.convert import convert_t5_encoder
    from yat_tpu_torch.models.convert_unet import convert_vae_kl
    from yat_tpu_torch.models.text_encoders import (
        T5_TINY_TEST, T5_XXL, T5Encoder, compress_embeddings)
    from yat_tpu_torch.models.vae import (
        KLVAE_SD15, KLVAE_TINY_TEST, AutoencoderKL)
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    te_cfg = T5_TINY_TEST if tiny else T5_XXL
    vae_cfg = KLVAE_TINY_TEST if tiny else KLVAE_SD15
    low = params.low_vram
    weights = weights or {}
    te = build_pipe_component(
        params, "text_encoder",
        lambda sd: convert_t5_encoder(sd, te_cfg.num_layers),
        lambda: T5Encoder(te_cfg, dtype=dtype), device,
        params.dataset_seed + 1, dtype if params.bfloat16 else None,
        weights.get("text_encoder"))
    vae = build_pipe_component(
        params, "vae", lambda sd: convert_vae_kl(
            sd, vae_cfg.block_out_channels, vae_cfg.layers_per_block),
        lambda: AutoencoderKL(vae_cfg), device, params.dataset_seed + 2,
        tree=weights.get("vae"), pick="decoder")
    tokenize = load_tokenizer(params.pretrained_pipe_path,
                              vocab_size=te_cfg.vocab_size,
                              max_length=max_caption_len)

    @torch.inference_mode()
    def encode_captions(captions):
        ids, mask = tokenize(list(captions), max_length=max_caption_len)
        ids, mask = slice_caption_rung(ids, mask)
        with staged(te, device, low):
            hidden = te(torch.as_tensor(ids, device=device),
                        torch.as_tensor(mask, device=device))
        return compress_embeddings(hidden, mask)

    encode_captions.module = te
    return encode_captions, make_tiling_decoder(vae, device, low)


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
