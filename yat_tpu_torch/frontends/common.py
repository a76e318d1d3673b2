"""Frontend helpers shared by the model families.

Counterparts of the helpers of ``yat_tpu/frontends/common.py`` that the
SANA and PixArt-Sigma paths need: YAML config overrides, the caption rung
slicer, the module builder (random weights from a seed, or a JAX parameter
tree), pretrained loading (``load_pretrained_backbone`` for the denoiser
from ``pretrained_model_path`` or ``pretrained_pipe_path/transformer``,
``load_pipe_component`` for the caption encoder and VAE of
``pretrained_pipe_path``; a VAE's encoder half only for a run that
encodes images: ``encodes_images``), the ``low_vram`` staging of
encoder and decoder weights, the tiling decoder, the image encoder (uint8
pixels cross to the device and are normalised there: ``pixels_to_u8``,
``u8_to_unit``), the prompt encoder's padding, the T5 caption encoder and
KL-VAE of ``build_t5_vae_encoders``, the CLIP-L caption encoder (plain
or with its projection; the captions compressed to CLIP's 77 tokens) and
KL-VAE of SD1.5 and SDXL (``build_clip_vae_encoders``, with
``encode_pooled``), the shard sources (local paths, then
``urls``, then R2), the sampler selection every family shares
(``build_family_sampler``: Dreambooth, then ``compute_features``, then
feature shards) and the training CLI (``cli_main``, which adds
``--device`` to the JAX package's ``--config`` and routes
``extract_features`` to the extraction pass), the frozen DINOv2 encoder
of REPA's targets (``build_dino_encoder``, which the on-the-fly and
Dreambooth samplers call on each whole batch under ``use_repa``) and
the pretrained adapters of ``lora_pretrained`` for serving
(``attach_pretrained_adapters``).  The denoisers of SANA, PixArt-Sigma,
SD1.5, SDXL, SD3.5 and Flux load from diffusers files, the UNet, CLIP
and VAE of SD1.5 and SDXL also from a CompVis single file
(``pretrained_pipe_single_file``), and PixelDiT from a raw ``.pth`` or
``.safetensors`` file in DiT naming, or from a hub repo id
(``org/name``), whose ``model.pth`` ``hf_hub_fetch`` downloads into
``./checkpoints`` once (the library is optional; nothing is fetched when
the file is there).

Across processes (``torchrun``; ``cli_main`` brings the process group up
when torchrun's environment names more than one process, where the JAX
``cli_main`` never initialises its distributed runtime) the shard lists
are split by process, the feature sampler takes ``WindowedBucketSync``,
and process 0 alone fetches from the hub while the others wait for it.

Two divergences from the JAX package, both repairs: the SDXL VAE (and
PixArt-Sigma's, whose published pipe ships SDXL's) scales its latents by
0.13025 (``KLVAE_SDXL``), where the JAX builders always take SD1.5's
0.18215; and SDXL's first text encoder gives the penultimate layer's
states (``penultimate``), as diffusers' SDXL pipeline does, where the
JAX builder gives the final LayerNorm's.
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
    RemoteShardSource,
    UrlShardSource,
    caption_length_buckets,
    caption_rung,
    pad_embeddings,
)
from yat_tpu_torch.models.layers import init_params
from yat_tpu_torch.parallel.multihost import (broadcast_from_main,
                                              data_count, data_index,
                                              host_seed,
                                              initialize_distributed,
                                              process_count, process_index)


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


# modules of the denoisers with no checkpoint counterpart: a pretrained
# load leaves them at their initialisation
NEW_CAPABILITY_MODULES = ("repa_projector", "resnet_branch")


def build_module(module_fn, device, tree, seed, dtype=None,
                 keep: tuple = ()):
    """Construct a module on ``device`` (no host copy of its parameters),
    then load the JAX parameter ``tree`` or initialise it from ``seed``;
    optionally store the parameters in ``dtype``.  The parameters of the
    submodules named in ``keep`` that the tree lacks are initialised from
    ``seed``.  Returns it in eval mode."""
    with torch.device(device):
        module = module_fn()
    if tree is None or any(k in n.split(".") for n, _ in
                           module.named_parameters() for k in keep):
        init_params(module, torch.Generator(device=device).manual_seed(seed))
    if tree is not None:
        load_flax_params(module, tree, keep=keep)
    if dtype is not None:
        module.to(dtype)
    return module.eval()


# the families whose denoiser checkpoints load (every family of the JAX
# package)
_PORTED_FAMILIES = ("sana", "pixart", "sd15", "sdxl", "sd35", "flux",
                    "pixeldit")
# the families whose single-file CompVis checkpoints load
_SINGLE_FILE_FAMILIES = ("sd15", "sdxl")


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


def single_file(params: TrainingParameters) -> Optional[str]:
    """``pretrained_pipe_single_file`` when it names an existing file."""
    path = params.pretrained_pipe_single_file
    return path if path and os.path.exists(path) else None


def load_single_file(params: TrainingParameters) -> dict:
    """The parts of the CompVis single file (``split_compvis_checkpoint``:
    ``unet``, ``vae``, ``clip``, LDM prefixes stripped).  Each caller
    reads the file again, as the JAX package does."""
    from yat_tpu_torch.models.convert import load_torch_state_dict
    from yat_tpu_torch.models.convert_unet import split_compvis_checkpoint
    return split_compvis_checkpoint(load_torch_state_dict(single_file(params)))


def load_pretrained_backbone(params: TrainingParameters, family: str, cfg):
    """The converted flax-layout tree of the denoiser checkpoint of
    ``pretrained_model_path`` or ``pretrained_pipe_path/transformer``
    (``unet/``), or, for SD1.5 and SDXL, of the CompVis single file's
    UNet, or None when no pretrained path is configured.  A full
    fine-tuning export of either package (``model.safetensors`` with flat
    flax keys, whose
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
        raise ValueError(f"unknown model family {family!r}")
    from yat_tpu_torch.models.convert import load_torch_state_dict

    dirpath = _find_denoiser_dir(params)
    if dirpath is None and params.pretrained_model_path and \
            os.path.isfile(params.pretrained_model_path):
        # a raw checkpoint file (PixelDiT's .pth)
        dirpath = params.pretrained_model_path
    if dirpath is None and family == "pixeldit" and \
            looks_like_hub_repo(params.pretrained_model_path or ""):
        # PixelDiT ships as one .pth in a hub repo
        dirpath = hf_hub_fetch(params.pretrained_model_path)
    if dirpath is None and single_file(params) and \
            family in _SINGLE_FILE_FAMILIES:
        from yat_tpu_torch.models.convert_unet import (convert_unet,
                                                       ldm_unet_to_diffusers)
        parts = load_single_file(params)
        if parts["unet"]:
            sd = ldm_unet_to_diffusers(
                parts["unet"], cfg.block_out_channels,
                cfg.layers_per_block, cfg.transformer_layers)
            print(f"[{family}] read the pretrained UNet from "
                  f"{params.pretrained_pipe_single_file}: {len(sd)} tensors")
            return convert_unet(sd, cfg.block_out_channels,
                                cfg.layers_per_block, cfg.transformer_layers)
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
    elif family in _SINGLE_FILE_FAMILIES:
        from yat_tpu_torch.models.convert_unet import convert_unet
        tree = convert_unet(sd, cfg.block_out_channels,
                            cfg.layers_per_block, cfg.transformer_layers)
    elif family == "sd35":
        from yat_tpu_torch.models.convert_dit import convert_sd3_mmdit
        tree = convert_sd3_mmdit(sd, cfg.num_layers)
    elif family == "flux":
        from yat_tpu_torch.models.convert_dit import convert_flux
        tree = convert_flux(sd, cfg.num_double_blocks, cfg.num_single_blocks)
    elif family == "pixeldit":
        from yat_tpu_torch.models.convert_dit import convert_pixeldit
        tree = convert_pixeldit(sd, cfg.num_layers, cfg.num_pixel_layers)
    else:
        from yat_tpu_torch.models.convert_dit import convert_pixart
        tree = convert_pixart(sd, cfg.num_layers)
    print(f"[{family}] read the pretrained backbone from {dirpath}: "
          f"{len(sd)} tensors")
    return tree


def hf_hub_fetch(repo_id: str, filename: str = "model.pth",
                 local_dir: str = "./checkpoints") -> str:
    """The path of ``filename`` of the hub repo ``repo_id``, downloaded
    into ``local_dir`` with ``huggingface_hub.hf_hub_download`` unless it
    is there already.  A missing library or a failed download raises a
    ``ValueError`` that names where to put the file, never a random
    backbone.  Across processes process 0 fetches and the others wait for
    it (``broadcast_from_main``, which also carries its failure to
    them)."""
    target = os.path.join(local_dir, filename)
    error = None
    if process_index() == 0:
        try:
            target = _hub_download(repo_id, filename, local_dir, target)
        except ValueError as e:
            error = e
    failed = broadcast_from_main(np.asarray([error is not None], np.int32))
    if error is not None:
        raise error
    if failed[0]:
        raise ValueError(f"process 0 failed to fetch {filename!r} from hub "
                         f"repo {repo_id!r}; place it at {target!r}")
    return target


def _hub_download(repo_id: str, filename: str, local_dir: str,
                  target: str) -> str:
    if os.path.exists(target):
        return target
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ValueError(
            f"pretrained_model_path={repo_id!r} is not a local file and "
            "huggingface_hub is unavailable to download it — place the "
            f"checkpoint at {target!r}") from e
    try:
        return hf_hub_download(repo_id=repo_id, filename=filename,
                               local_dir=local_dir)
    except Exception as e:  # noqa: BLE001 — any failure names the file
        raise ValueError(
            f"failed to download {filename!r} from hub repo {repo_id!r} — "
            f"place the checkpoint at {target!r} or point "
            "pretrained_model_path at a local file") from e


def looks_like_hub_repo(path: str) -> bool:
    """An ``org/name`` repo id: nothing that exists locally, one slash."""
    import re
    return (not os.path.exists(path)
            and re.fullmatch(r"[\w.\-]+/[\w.\-]+", path) is not None)


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
                         module_fn, device, seed, dtype=None, tree=None):
    """A caption encoder or VAE of the pipe directory: the JAX parameter
    ``tree`` when given, else ``pretrained_pipe_path/sub`` converted by
    ``convert(state_dict)`` where present, else random from ``seed``
    (:func:`build_component`; a VAE built without its encoder drops that
    half of the tree).  A module loaded from
    its file carries the seconds that took in ``load_seconds``, which
    ``chip_smoke.py`` reports."""
    t0 = time.perf_counter()
    from_file = tree is None
    if from_file:
        tree = load_pipe_component(params, sub, convert)
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
    leaves the module has no place for, such as the encoder half of a
    decode-only VAE, are dropped), or random from ``seed``.  Under
    ``low_vram`` its weights then
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


def pixels_to_u8(images) -> np.ndarray:
    """Host pixels → uint8 for the trip to the device: uint8 stays as it
    is, float pixels in [-1, 1] round to the nearest of 256 steps (exact
    for decoded images, which are uint8 to begin with)."""
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        return arr
    return np.rint((arr.astype(np.float32) + 1.0) * 127.5).clip(
        0, 255).astype(np.uint8)


def u8_to_unit(x: torch.Tensor) -> torch.Tensor:
    """The device side of :func:`pixels_to_u8`: uint8 → fp32 in [-1, 1]."""
    return x.float() / 127.5 - 1.0


def make_image_encoder(vae, device, low_vram: bool):
    """``encode_images(pixels)`` → fp32 NHWC latents on the host
    (``vae.encode_mode``; pixels go to the device as uint8 and are
    normalised there).  ``encode_images.dispatch(pixels)`` launches the
    encode on the device's stream and returns a closure that waits for it
    as it copies the latents to the host, so several chunks can be in
    flight (the extraction pass).  The VAE rides along as
    ``encode_images.module``."""

    @torch.inference_mode()
    def dispatch(images):
        u8 = torch.as_tensor(pixels_to_u8(images)).to(device)
        with staged(vae, device, low_vram):
            z = vae.encode_mode(u8_to_unit(u8))
        return lambda: z.cpu().numpy()

    def encode_images(images):
        return dispatch(images)()

    encode_images.dispatch = dispatch
    encode_images.module = vae
    return encode_images


def make_caption_encoder(te, tokenize, max_len: int, device,
                         low_vram: bool):
    """``encode_captions(captions)`` → list of fp32 ``[L_i, D]`` host
    arrays: tokenize to ``max_len``, trim to the caption rung, encode,
    mask-compress.  ``encode_captions.dispatch`` launches and returns a
    closure that compresses (and so waits) later.  The encoder rides along
    as ``encode_captions.module``."""
    from yat_tpu_torch.models.text_encoders import compress_embeddings

    @torch.inference_mode()
    def dispatch(captions):
        ids, mask = tokenize(list(captions), max_length=max_len)
        ids, mask = slice_caption_rung(ids, mask)
        with staged(te, device, low_vram):
            hidden = te(torch.as_tensor(ids, device=device),
                        torch.as_tensor(mask, device=device))
        return lambda: compress_embeddings(hidden, mask)

    def encode_captions(captions):
        return dispatch(captions)()

    encode_captions.dispatch = dispatch
    encode_captions.module = te
    return encode_captions


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
                              dtype, keep=NEW_CAPABILITY_MODULES)
    except KeyError as e:
        raise ValueError(f"the {family} checkpoint does not fit the model "
                         f"({e.args[0]}): converter/checkpoint mismatch"
                         ) from e
    module.load_seconds = _synced_seconds(t0, device)
    print(f"[{family}] the backbone took {module.load_seconds:.1f} s "
          f"from file to {device}")
    return module


def make_prompt_encoder(encode_captions, max_len: int, device,
                        encode_pooled=None, time_ids_hw=None):
    """Prompt strings → the conditioning the denoiser consumes: the encoded
    captions padded to ``max_len`` tokens, ``{"embeddings", "text_mask"}``
    on ``device``, with ``encode_pooled`` the pooled text
    (``"pooled_text"``, fp32 ``[B, P]``) and with ``time_ids_hw`` SDXL's
    ``"time_ids"`` ``[h, w, 0, 0, h, w]`` for every prompt (so the empty
    prompt of CFG's unconditional half gets both too).
    ``encode.encode_captions`` keeps the caption encoder callable for the
    measurements of ``chip_smoke.py``."""

    def encode(prompts):
        prompts = list(prompts)
        padded, mask = pad_embeddings(encode_captions(prompts), max_len)
        out = {"embeddings": torch.as_tensor(padded, device=device),
               "text_mask": torch.as_tensor(mask, device=device)}
        if encode_pooled is not None:
            out["pooled_text"] = torch.as_tensor(
                np.asarray(encode_pooled(prompts), np.float32),
                device=device)
        if time_ids_hw is not None:
            h, w = time_ids_hw
            out["time_ids"] = torch.tensor([[h, w, 0, 0, h, w]] * len(prompts),
                                           dtype=torch.float32, device=device)
        return out

    encode.encode_captions = encode_captions
    return encode


def make_clip_encoders(te, tokenize, max_len: int, device, low_vram: bool):
    """``(encode_captions, encode_pooled)`` of a CLIP text model: each
    caption compressed to CLIP's budget (``compress_caption``), tokenized
    to ``max_len`` and encoded whole (CLIP consumes every position, so no
    rung and no mask compression): ``encode_captions`` → list of fp32
    ``[max_len, D]`` host arrays, ``encode_pooled`` → fp32 ``[B, P]``.
    Both have ``.dispatch`` hooks (launch now, fetch later) and carry the
    encoder as ``.module``.  One forward gives both: ``encode_pooled`` of
    the captions last encoded takes that forward's pooled vector."""
    from yat_tpu_torch.utils.compress_caption import compress_caption

    # (captions, pooled) of the last forward, swapped whole
    last = [((), None)]

    @torch.inference_mode()
    def run(captions):
        ids, _ = tokenize([compress_caption(c) for c in captions],
                          max_length=max_len)
        with staged(te, device, low_vram):
            hidden, pooled = te(torch.as_tensor(ids, device=device))
        last[0] = (tuple(captions), pooled)
        return hidden, pooled

    def dispatch(captions):
        hidden, _ = run(captions)
        return lambda: list(hidden.float().cpu().numpy())

    def dispatch_pooled(captions):
        seen, pooled = last[0]
        if pooled is None or seen != tuple(captions):
            _, pooled = run(captions)
        return lambda: pooled.float().cpu().numpy()

    def encode_captions(captions):
        return dispatch(captions)()

    def encode_pooled(captions):
        return dispatch_pooled(captions)()

    encode_captions.dispatch, encode_pooled.dispatch = (dispatch,
                                                        dispatch_pooled)
    encode_captions.module = encode_pooled.module = te
    return encode_captions, encode_pooled


def build_clip_text_encoder(params: TrainingParameters, device, cfg, sub: str,
                            seed: int, tree=None, from_single_file=False):
    """A CLIP text model of ``cfg`` in fp32 (the JAX builders run CLIP in
    fp32): from the JAX parameter ``tree`` when given, else from the
    single file's CLIP part (``from_single_file``), else from
    ``pretrained_pipe_path/sub``, else random from ``seed``."""
    from yat_tpu_torch.models.convert import convert_clip_text
    from yat_tpu_torch.models.text_encoders import CLIPTextModel

    if tree is None and from_single_file and single_file(params):
        clip = load_single_file(params)["clip"]
        if clip:
            tree = convert_clip_text(clip, cfg.num_layers)
    return build_pipe_component(
        params, sub, lambda sd: convert_clip_text(sd, cfg.num_layers),
        lambda: CLIPTextModel(cfg, dtype=torch.float32), device, seed,
        tree=tree)


def build_clip_vae_encoders(params: TrainingParameters, device,
                            max_caption_len: int = 77,
                            weights: Optional[Mapping] = None,
                            images: bool = True,
                            clip_l_projection: bool = False,
                            penultimate: bool = False, vae_cfg=None,
                            include_vae: bool = True):
    """The fp32 CLIP-L caption encoder and fp32 KL-VAE of SD1.5 (SDXL's
    first text encoder and VAE) as callables: ``(encode_images,
    encode_captions, encode_pooled, decode_latents)``; without ``images``
    the KL-VAE is its decoder alone and ``encode_images`` is None; without
    ``include_vae`` no VAE is built and both are None (SD3.5 builds its
    own).

    CLIP-L is plain (``CLIP_L_14``) or with its projection
    (``clip_l_projection``), its tiny test configuration under
    ``tiny_encoders``; ``penultimate`` takes the penultimate layer's
    states.  The KL-VAE is ``vae_cfg`` (SD1.5's by default).  Captions are
    compressed to CLIP's 77 tokens and encoded whole
    (:func:`make_clip_encoders`).  The weights are the JAX parameter trees
    under ``"text_encoder"`` and ``"vae"`` of ``weights`` when given, else
    they load from the CompVis single file (``pretrained_pipe_single_file``:
    its CLIP and VAE parts), else from ``pretrained_pipe_path``'s
    ``text_encoder/`` and ``vae/`` where present, else they are random from
    ``dataset_seed``.  A single file carries no tokenizer, so it needs
    ``pretrained_pipe_path`` for one (``load_tokenizer(require=True)``)."""
    from yat_tpu_torch.models.convert_unet import (convert_vae_compvis,
                                                   convert_vae_kl)
    from yat_tpu_torch.models.text_encoders import (
        CLIP_L_14, CLIP_L_14_PROJ, CLIP_TINY_TEST)
    from yat_tpu_torch.models.vae import (KLVAE_SD15, KLVAE_TINY_TEST,
                                          AutoencoderKL)
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    te_cfg = CLIP_TINY_TEST if tiny else (
        CLIP_L_14_PROJ if clip_l_projection else CLIP_L_14)
    if penultimate:
        te_cfg = dataclasses.replace(te_cfg, penultimate=True)
    vae_cfg = KLVAE_TINY_TEST if tiny else (vae_cfg or KLVAE_SD15)
    weights = weights or {}
    low = params.low_vram
    one_file = single_file(params) is not None
    te = build_clip_text_encoder(params, device, te_cfg, "text_encoder",
                                 params.dataset_seed + 1,
                                 weights.get("text_encoder"), one_file)
    ml = min(max_caption_len, te_cfg.max_length)
    tokenize = load_tokenizer(params.pretrained_pipe_path,
                              vocab_size=te_cfg.vocab_size, max_length=ml,
                              require=one_file)
    encode_captions, encode_pooled = make_clip_encoders(
        te, tokenize, ml, device, low)
    if not include_vae:
        return None, encode_captions, encode_pooled, None
    vae_tree = weights.get("vae")
    if vae_tree is None and one_file:
        ldm = load_single_file(params)["vae"]
        if ldm:
            vae_tree = convert_vae_compvis(ldm, vae_cfg.block_out_channels,
                                           vae_cfg.layers_per_block)
    vae = build_pipe_component(
        params, "vae", lambda sd: convert_vae_kl(
            sd, vae_cfg.block_out_channels, vae_cfg.layers_per_block),
        lambda: AutoencoderKL(vae_cfg, encoder=images), device,
        params.dataset_seed + 2, tree=vae_tree)
    return (make_image_encoder(vae, device, low) if images else None,
            encode_captions, encode_pooled,
            make_tiling_decoder(vae, device, low))


def build_t5_vae_encoders(params: TrainingParameters, device,
                          max_caption_len: int = 300,
                          weights: Optional[Mapping] = None,
                          images: bool = True):
    """The fp32 KL-VAE encoder, the T5 caption encoder and the fp32 KL-VAE
    decoder of the PixArt-Sigma path as callables (the SDXL VAE, which
    PixArt-Sigma's published pipe ships, and T5-XXL, or their tiny test
    configurations under ``tiny_encoders``):
    ``(encode_images, encode_captions, decode_latents)``; without
    ``images`` the KL-VAE is its decoder alone and ``encode_images`` is
    None (serving).

    ``encode_images(pixels)`` → latents (:func:`make_image_encoder`);
    ``encode_captions(captions)`` → list of fp32 ``[L_i, D]`` host arrays
    (:func:`make_caption_encoder`); ``decode_latents(z)`` → NHWC images
    (fp32).  The weights are the JAX parameter trees under
    ``"text_encoder"`` and ``"vae"`` of ``weights`` when given, else they
    load from ``pretrained_pipe_path``'s ``text_encoder/`` and ``vae/``
    where present, else they are random from
    ``dataset_seed``; under ``low_vram`` both rest on the host.  The
    modules ride along as ``.module`` of each callable (``chip_smoke.py``
    checks their weights)."""
    from yat_tpu_torch.models.convert import convert_t5_encoder
    from yat_tpu_torch.models.convert_unet import convert_vae_kl
    from yat_tpu_torch.models.text_encoders import (
        T5_TINY_TEST, T5_XXL, T5Encoder)
    from yat_tpu_torch.models.vae import (
        KLVAE_SDXL, KLVAE_TINY_TEST, AutoencoderKL)
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    dtype = torch.bfloat16 if params.bfloat16 else torch.float32
    te_cfg = T5_TINY_TEST if tiny else T5_XXL
    # 0.13025, where the JAX package takes SD1.5's 0.18215 (a fault there)
    vae_cfg = KLVAE_TINY_TEST if tiny else KLVAE_SDXL
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
        lambda: AutoencoderKL(vae_cfg, encoder=images), device,
        params.dataset_seed + 2, tree=weights.get("vae"))
    tokenize = load_tokenizer(params.pretrained_pipe_path,
                              vocab_size=te_cfg.vocab_size,
                              max_length=max_caption_len)
    return (make_image_encoder(vae, device, low) if images else None,
            make_caption_encoder(te, tokenize, max_caption_len, device, low),
            make_tiling_decoder(vae, device, low))


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


def shard_range_for_host(num_shards: int, index: Optional[int] = None,
                         count: Optional[int] = None) -> range:
    """The shards of data index ``index`` of ``count`` (default: this
    process's, ``multihost.data_index``): an even split, the last taking
    the remainder; every shard when there are fewer shards than data
    indices."""
    index = data_index() if index is None else index
    count = data_count() if count is None else count
    if num_shards < count:
        return range(0, num_shards)
    per = num_shards // count
    begin = index * per
    end = num_shards if index == count - 1 else begin + per
    return range(begin, end)


def r2_shard_names(params: TrainingParameters, per_host: bool = True
                   ) -> list:
    """The R2 shard list: ``r2_tar_files``, else ``shard-%06d.tar`` over
    ``num_shards``; ``per_host`` restricts it to this process's range."""
    if params.r2_tar_files:
        names = list(params.r2_tar_files)
        if per_host:
            names = [names[i] for i in shard_range_for_host(len(names))]
        return names
    n = params.num_shards or 1
    rng = shard_range_for_host(n) if per_host else range(n)
    return [f"shard-{i:06d}.tar" for i in rng]


def make_remote_source(params: TrainingParameters, per_host: bool = True,
                       one_pass: bool = False) -> RemoteShardSource:
    """The R2 source over ``r2_dataset_folder`` (presigned GETs)."""
    return RemoteShardSource(
        r2_shard_names(params, per_host=per_host),
        params.r2_dataset_folder or "",
        params.r2_access_key, params.r2_secret_key,
        params.r2_endpoint, params.r2_bucket_name,
        seed=params.dataset_seed, process_index=data_index(),
        local_temp_dir=download_dir(), one_pass=one_pass)


def download_dir() -> str:
    """The sources' download directory: ``temp``, one of its own for each
    process where ``tp``/``sp`` peers share a data index (their files
    would take the same names)."""
    if process_count() == data_count():
        return "temp"
    return os.path.join("temp", f"rank{process_index()}")


def local_paths(params: TrainingParameters) -> list:
    """This process's ``local_shard_paths``: its data index's range of the
    list when there are at least as many paths as data indices, else every
    path."""
    paths = list(params.local_shard_paths)
    if data_count() > 1 and len(paths) >= data_count():
        paths = [paths[i] for i in shard_range_for_host(len(paths))]
    return paths


def make_local_source(params: TrainingParameters) -> LocalShardSource:
    """The local shard source of this process (:func:`local_paths`), its
    shuffle seeded with ``host_seed(dataset_seed)`` as in the JAX
    package."""
    return LocalShardSource(local_paths(params),
                            seed=host_seed(params.dataset_seed))


def make_shard_source(params: TrainingParameters, one_pass: bool = False):
    """The shard source by precedence: ``local_shard_paths``, then
    ``urls``, then R2; None when none is configured.  ``one_pass`` (the
    extraction pass) reads every shard once, in the configured order, and
    ends; otherwise the sources cycle."""
    if params.local_shard_paths:
        if one_pass:
            return local_paths(params)
        return make_local_source(params)
    if params.urls:
        return UrlShardSource(params.urls, seed=params.dataset_seed,
                              probs=params.url_probs,
                              process_index=data_index(),
                              local_temp_dir=download_dir(),
                              one_pass=one_pass)
    if params.r2_endpoint:
        return make_remote_source(params, one_pass=one_pass)
    return None


def make_image_source(params: TrainingParameters, one_pass: bool = False):
    """The raw ``{jpg, txt}`` shard source of ``compute_features`` and
    ``extract_features`` (:func:`make_shard_source`); raises when none is
    configured."""
    source = make_shard_source(params, one_pass=one_pass)
    if source is None:
        raise ValueError(
            "a raw-image shard source is required (compute_features / "
            "extract_features): configure local_shard_paths, urls, or R2 "
            "credentials")
    return source


def build_feature_sampler(params: TrainingParameters, max_caption_len: int,
                          resolution: int = 512):
    """The pre-extracted feature-shard sampler over the configured source
    (:func:`make_shard_source`); None when no data source is configured.
    Across processes it takes ``WindowedBucketSync`` over the canonical
    keys: the aspect bins of ``aspect_ratios`` (or ``resolution``), each
    with every caption rung under ``caption_length_bucketing``."""
    source = make_shard_source(params)
    if source is None:
        return None
    cb = (caption_length_buckets(max_caption_len)
          if params.caption_length_bucketing else None)
    sync_hook = None
    if process_count() > 1:
        from yat_tpu_torch.data.bins import bin_for_resolution
        from yat_tpu_torch.data.sampler import bucket_key
        from yat_tpu_torch.parallel.multihost import WindowedBucketSync
        bins = sorted(bin_for_resolution(params.aspect_ratios or resolution))
        sync_hook = WindowedBucketSync(
            [bucket_key(b, r) for b in bins for r in (cb or (None,))])
    return FeatureBucketSampler(source, params.batch_size, max_caption_len,
                                seed=params.dataset_seed, caption_buckets=cb,
                                bucket_repeat=params.bucket_repeat,
                                sync_hook=sync_hook)


def encodes_images(params: TrainingParameters) -> bool:
    """Whether a run encodes images (Dreambooth, ``compute_features`` or
    the extraction pass), and so needs its VAE's encoder half."""
    return bool(params.dreambooth_dataset_folder or params.extract_features
                or (params.compute_features
                    and not params.use_calculated_features))


def dino_config(params: TrainingParameters):
    """DINOv2 ViT-B/14, or its tiny test configuration under
    ``tiny_encoders``."""
    from yat_tpu_torch.models.dinov2 import DINOV2_TINY_TEST, DINOV2_VITB14
    tiny = bool(params.model_config_overrides.get("tiny_encoders"))
    return DINOV2_TINY_TEST if tiny else DINOV2_VITB14


def dino_token_dim(params: TrainingParameters) -> int:
    """The width of the REPA targets (768 for ViT-B/14)."""
    return dino_config(params).hidden_dim


def dino_num_tokens(params: TrainingParameters) -> int:
    """The patch-token count of the REPA targets (256 for ViT-B/14 at
    224 px)."""
    return dino_config(params).grid ** 2


def repa_warmup_fields(params: TrainingParameters) -> dict:
    """The REPA targets' shape for a trainer's ``warmup_spec``
    (``repa_tokens``, ``repa_dim``), or nothing without ``use_repa``."""
    if not params.use_repa:
        return {}
    return {"repa_tokens": dino_num_tokens(params),
            "repa_dim": dino_token_dim(params)}


def build_dino_encoder(params: TrainingParameters, device):
    """``encode_repa(images)``: the frozen DINOv2's ``x_norm_patchtokens``
    (fp32 ``[B, 256, 768]`` on the host) of a batch of pixels (uint8, or
    float in [-1, 1]; 224 px antialiased bicubic, ImageNet-normalised) on
    ``device``.  The weights come from ``repa_pretrained_model`` (a
    torch.hub ``dinov2_vitb14`` state dict) when that file exists;
    otherwise they are random from ``dataset_seed + 11`` (the draws differ
    from the JAX package's) and one line names the missing file.  The
    callable carries ``grid_hw`` (the token grid) and ``module``."""
    from yat_tpu_torch.models.convert import load_torch_state_dict, \
        merge_into
    from yat_tpu_torch.models.dinov2 import DinoV2, convert_dinov2, \
        preprocess_for_dino

    cfg = dino_config(params)
    path = params.repa_pretrained_model
    tree = None
    if path and os.path.exists(path):
        with torch.device("meta"):
            shapes = flax_shapes(DinoV2(cfg))
        tree = merge_into(shapes, convert_dinov2(load_torch_state_dict(path),
                                                 cfg.num_layers))
        print(f"[repa] DINOv2 weights from {path}")
    else:
        print(f"[repa] repa_pretrained_model {path!r} is not a file: the "
              "REPA targets come from a random DINOv2 (seed "
              f"{params.dataset_seed + 11})")
    dino = build_module(lambda: DinoV2(cfg), device, tree,
                        params.dataset_seed + 11)

    @torch.inference_mode()
    def encode_repa(images):
        u8 = torch.as_tensor(pixels_to_u8(images)).to(device)
        x = preprocess_for_dino(u8_to_unit(u8), size=cfg.image_size)
        return dino(x).cpu().numpy()

    encode_repa.grid_hw = (cfg.grid, cfg.grid)
    encode_repa.module = dino
    return encode_repa


def attach_pretrained_adapters(model, params: TrainingParameters,
                               device) -> int:
    """``lora_pretrained`` on a serving pipeline's denoiser: the adapters
    of the configured spec built as the trainer builds them (from
    ``dataset_seed`` on ``device``), then their leaves read from the file
    (``adapters.builder.load_pretrained_adapters``).
    Returns the number of adapted modules (0 without ``lora_pretrained``).
    """
    if not params.lora_pretrained:
        return 0
    from yat_tpu_torch.adapters.builder import (build_adapter_params,
                                                load_pretrained_adapters)
    from yat_tpu_torch.train.engine import adapter_spec_from_params
    spec = adapter_spec_from_params(params)
    if spec is None:
        raise ValueError("lora_pretrained needs the adapter's spec: set "
                         "lora_rank, lora_algo and lora_target_modules")
    gen = torch.Generator(device=device).manual_seed(params.dataset_seed)
    n = build_adapter_params(model, spec, gen,
                             merged=params.lora_fused_matmul)
    load_pretrained_adapters(model, params.lora_pretrained)
    print(f"[adapters] {n} {spec.algo} modules from {params.lora_pretrained}")
    return n


@dataclasses.dataclass
class FamilySpec:
    """What a model family gives the shared sampler selection: its caption
    budget, its default resolution (the bin table), and how to build its
    encoders: ``build_encoders(params)`` → a dict with ``encode_images``,
    ``encode_captions`` and ``decode_latents`` (and ``encode_pooled`` for
    a family conditioned on pooled text)."""

    family: str
    max_caption_len: int
    default_resolution: int
    build_encoders: Callable[[TrainingParameters], dict]
    # where the DINOv2 encoder of use_repa runs
    device: object = "cpu"


def ensure_encoders(params: TrainingParameters, spec: FamilySpec,
                    holder: dict, trainer=None) -> dict:
    """Build the family's encoders once into ``holder`` (shared by the
    sampler, validation and the extraction pass); with ``trainer``, set
    them on it as attributes too."""
    if "encode_captions" not in holder:
        built = spec.build_encoders(params)
        holder.update({k: v for k, v in built.items() if v is not None})
    if trainer is not None:
        for k, v in holder.items():
            setattr(trainer, k, v)
    return holder


def build_family_sampler(params: TrainingParameters, spec: FamilySpec,
                         holder: dict):
    """The sampler every family selects the same way:

    1. ``dreambooth_dataset_folder`` → ``DreamboothSampler`` (with R2
       regularization shards when R2 is configured), encoded on the fly;
    2. ``compute_features`` (without ``use_calculated_features``) →
       ``ImageBucketSampler`` over the raw shard source →
       ``OnTheFlyEncodingSampler`` (``bucket_repeat`` after the encode) →
       ``FeatureCache`` of ``cache_size // batch_size`` batches;
    3. otherwise → ``FeatureBucketSampler`` over feature shards.

    Raises when no data source is configured (the JAX package returns
    None for its validation-only trainers; the port serves through
    ``make_pipeline``)."""
    from yat_tpu_torch.data.bins import bin_for_resolution
    from yat_tpu_torch.data.sampler import (DreamboothSampler,
                                            ImageBucketSampler)
    from yat_tpu_torch.train.encode import (FeatureCache,
                                            OnTheFlyEncodingSampler)

    bins = bin_for_resolution(params.aspect_ratios or spec.default_resolution)

    def on_the_fly(images, repeat=1, cache=False):
        h = ensure_encoders(params, spec, holder)
        cb = (caption_length_buckets(spec.max_caption_len)
              if params.caption_length_bucketing else None)
        if params.use_repa and "encode_repa" not in holder:
            holder["encode_repa"] = build_dino_encoder(params, spec.device)
        encoded = OnTheFlyEncodingSampler(
            images, h["encode_images"], h["encode_captions"],
            spec.max_caption_len,
            vae_max_batch_size=params.vae_max_batch_size,
            text_encoder_max_batch_size=params.text_encoder_max_batch_size,
            encode_repa=holder.get("encode_repa"),
            encode_pooled=h.get("encode_pooled"), caption_buckets=cb,
            repeat=repeat)
        if not cache:
            return encoded
        return FeatureCache(
            encoded, cache_size=max(1, params.cache_size // params.batch_size),
            save_to_disk=params.save_to_disk)

    if params.dreambooth_dataset_folder:
        reg_source = None
        if params.r2_endpoint and (params.num_shards or params.r2_tar_files):
            reg_source = make_remote_source(params, per_host=False)
        images = DreamboothSampler(
            params.dreambooth_dataset_folder,
            params.dreambooth_regularization_folder,
            params.dreambooth_instance, params.dreambooth_class,
            params.dreambooth_num_repeats, params.batch_size, bins,
            num_regularisation_passes=(
                params.dreambooth_num_regularisation_passes),
            seed=params.dataset_seed, reg_shard_source=reg_source)
        return on_the_fly(images)

    if params.compute_features and not params.use_calculated_features:
        images = ImageBucketSampler(make_image_source(params),
                                    params.batch_size, bins,
                                    seed=params.dataset_seed)
        print(f"[data] raw images decode through {images.decoder}")
        return on_the_fly(images, repeat=params.bucket_repeat, cache=True)

    sampler = build_feature_sampler(params, spec.max_caption_len,
                                    spec.default_resolution)
    if sampler is None:
        raise ValueError("no data source: configure local_shard_paths, "
                         "urls, R2 credentials or a "
                         "dreambooth_dataset_folder")
    return sampler


def cli_main(make_trainer: Callable[..., object],
             argv: Optional[list] = None):
    """``--config config.yaml [--device cuda|cpu]``: build the trainer on
    the device (the card unless asked otherwise) and run it, or, under
    ``extract_features``, run the extraction pass with its encoders
    (:func:`~yat_tpu_torch.train.extract.run_feature_extraction`, whose
    extractor the trainer keeps as ``extraction``); returns the
    trainer.  Under ``torchrun`` with more than one process the process
    group comes up first (``parallel.multihost.initialize_distributed``;
    one process a card)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        initialize_distributed(
            device_type=torch.device(args.device or "cuda").type)
    params = TrainingParameters.read_yaml(args.config)
    trainer = make_trainer(params, device=args.device)
    if params.extract_features:
        from yat_tpu_torch.train.extract import run_feature_extraction
        trainer.extraction = run_feature_extraction(trainer)
    else:
        trainer.run()
    return trainer
