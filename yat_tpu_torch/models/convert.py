"""Torch checkpoint → flax-layout parameter tree converters.

Counterpart of ``yat_tpu/models/convert.py`` (the state-dict reader, the
layout helpers, CLIP, Gemma-2, T5 and the SANA denoiser).  A checkpoint loads in
four steps: :func:`load_torch_state_dict` reads the file into numpy, a
converter here maps the diffusers/transformers keys onto the JAX package's
tree (the one key mapping both packages share), the frontend checks the
tree's coverage, and ``yat_tpu_torch.convert.load_flax_params`` copies it
into the port's modules.

Layout rules: torch ``Linear.weight`` is [out, in] → flax kernel [in, out]
(transpose); ``Conv2d.weight`` [out, in, kh, kw] → flax [kh, kw, in, out]
(the port's trees hold these as views of the checkpoint's arrays, which
``load_flax_params`` transposes back without a copy);
norm ``weight``/``bias`` → ``scale``/``bias``; Gemma's RMSNorm stores w
with ``y = x * (1 + w)``, so +1 is folded in here (and nowhere else).

The reader needs no ``safetensors`` package: ``adapters/io.py`` parses the
format (F32, F16 and BF16, widened to fp32 here); ``.bin``/``.pt`` files go
through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

# the monolithic checkpoint names a directory is searched for, in order
CKPT_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
              "pytorch_model.bin", "diffusion_pytorch_model.bin")


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .safetensors or .pt/.bin/.ckpt file (or the first of
    ``CKPT_NAMES`` in a directory) into fp32 numpy arrays.  A directory
    that holds only a sharded ``*.safetensors.index.json`` checkpoint
    raises: neither package reads shards."""
    if os.path.isdir(path):
        found = next((os.path.join(path, n) for n in CKPT_NAMES
                      if os.path.exists(os.path.join(path, n))), None)
        if found is None:
            shards = sorted(n for n in os.listdir(path)
                            if n.endswith(".index.json"))
            if shards:
                raise ValueError(
                    f"{path} holds a sharded checkpoint ({shards[0]}); "
                    "sharded checkpoints are not read, merge the shards "
                    f"into one of {CKPT_NAMES}")
            raise ValueError(f"no checkpoint file in {path} (looked for "
                             f"{CKPT_NAMES})")
        path = found
    if path.endswith(".safetensors"):
        from yat_tpu_torch.adapters.io import read_safetensors
        tensors, _ = read_safetensors(path)
        return {k: v.astype(np.float32, copy=False) if v.dtype.kind == "f"
                else v for k, v in tensors.items()}
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() for k, v in sd.items()}


def _set(tree: dict, dotted: str, value: np.ndarray):
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _linear(sd, torch_prefix, tree, flax_prefix, bias=True):
    _set(tree, f"{flax_prefix}.kernel", sd[f"{torch_prefix}.weight"].T)
    if bias and f"{torch_prefix}.bias" in sd:
        _set(tree, f"{flax_prefix}.bias", sd[f"{torch_prefix}.bias"])


def _norm(sd, torch_prefix, tree, flax_prefix, plus_one=False):
    w = sd[f"{torch_prefix}.weight"]
    _set(tree, f"{flax_prefix}.scale", w + 1.0 if plus_one else w)
    if f"{torch_prefix}.bias" in sd:
        _set(tree, f"{flax_prefix}.bias", sd[f"{torch_prefix}.bias"])


def _conv(sd, torch_prefix, tree, flax_prefix):
    w = sd[f"{torch_prefix}.weight"]           # [out, in, kh, kw]
    _set(tree, f"{flax_prefix}.kernel", np.transpose(w, (2, 3, 1, 0)))
    if f"{torch_prefix}.bias" in sd:
        _set(tree, f"{flax_prefix}.bias", sd[f"{torch_prefix}.bias"])


def _embed(sd, torch_prefix, tree, flax_prefix):
    _set(tree, f"{flax_prefix}.embedding", sd[f"{torch_prefix}.weight"])


def _conv_as_linear(sd, torch_prefix, tree, flax_prefix):
    """1x1 Conv2d checkpoint → a Dense (patch_size=1 patch embed)."""
    w = sd[f"{torch_prefix}.weight"]           # [out, in, 1, 1]
    _set(tree, f"{flax_prefix}.kernel", w[:, :, 0, 0].T)
    if f"{torch_prefix}.bias" in sd:
        _set(tree, f"{flax_prefix}.bias", sd[f"{torch_prefix}.bias"])


# ---------------------------------------------------------------------------
# CLIP text model (transformers CLIPTextModel / CLIPTextModelWithProjection)
# ---------------------------------------------------------------------------

def convert_clip_text(sd: Dict[str, np.ndarray],
                      num_layers: int) -> Dict[str, Any]:
    """transformers CLIP text encoder (``text_model.`` prefixed or bare,
    as a single-file checkpoint's ``cond_stage_model.transformer`` split
    gives it) → the CLIPTextModel tree; the bias-free
    ``text_projection`` of the WithProjection variant where present."""
    t = "text_model."
    if not any(k.startswith(t) for k in sd):
        t = ""
    tree: dict = {}
    _embed(sd, f"{t}embeddings.token_embedding", tree, "token_embedding")
    tree["position_embedding"] = sd[f"{t}embeddings.position_embedding.weight"]
    for i in range(num_layers):
        p = f"{t}encoder.layers.{i}"
        q = f"layers_{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{p}.self_attn.{name}", tree, f"{q}.{name}")
        _norm(sd, f"{p}.layer_norm1", tree, f"{q}.layer_norm1")
        _norm(sd, f"{p}.layer_norm2", tree, f"{q}.layer_norm2")
        _linear(sd, f"{p}.mlp.fc1", tree, f"{q}.fc1")
        _linear(sd, f"{p}.mlp.fc2", tree, f"{q}.fc2")
    _norm(sd, f"{t}final_layer_norm", tree, "final_layer_norm")
    if "text_projection.weight" in sd:
        _set(tree, "text_projection.kernel", sd["text_projection.weight"].T)
    return tree


# ---------------------------------------------------------------------------
# T5 encoder (transformers T5EncoderModel)
# ---------------------------------------------------------------------------

def convert_t5_encoder(sd: Dict[str, np.ndarray],
                       num_layers: int) -> Dict[str, Any]:
    tree: dict = {}
    emb_key = "shared.weight" if "shared.weight" in sd else \
        "encoder.embed_tokens.weight"
    tree["token_embedding"] = {"embedding": sd[emb_key]}
    tree["relative_attention_bias"] = sd[
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    for i in range(num_layers):
        p = f"encoder.block.{i}"
        q = f"layers_{i}"
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{p}.layer.0.SelfAttention.{name}", tree,
                    f"{q}.{name}", bias=False)
        _norm(sd, f"{p}.layer.0.layer_norm", tree, f"{q}.norm1")
        _linear(sd, f"{p}.layer.1.DenseReluDense.wi_0", tree, f"{q}.wi_0",
                bias=False)
        _linear(sd, f"{p}.layer.1.DenseReluDense.wi_1", tree, f"{q}.wi_1",
                bias=False)
        _linear(sd, f"{p}.layer.1.DenseReluDense.wo", tree, f"{q}.wo",
                bias=False)
        _norm(sd, f"{p}.layer.1.layer_norm", tree, f"{q}.norm2")
    _norm(sd, "encoder.final_layer_norm", tree, "final_norm")
    return tree


# ---------------------------------------------------------------------------
# Gemma-2 (transformers Gemma2Model)
# ---------------------------------------------------------------------------

def convert_gemma2(sd: Dict[str, np.ndarray],
                   num_layers: int) -> Dict[str, Any]:
    t = "model." if any(k.startswith("model.") for k in sd) else ""
    tree: dict = {}
    _embed(sd, f"{t}embed_tokens", tree, "token_embedding")
    for i in range(num_layers):
        p = f"{t}layers.{i}"
        q = f"layers_{i}"
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(sd, f"{p}.self_attn.{name}", tree, f"{q}.{name}",
                    bias=False)
        _norm(sd, f"{p}.input_layernorm", tree, f"{q}.input_norm",
              plus_one=True)
        _norm(sd, f"{p}.post_attention_layernorm", tree,
              f"{q}.post_attn_norm", plus_one=True)
        _norm(sd, f"{p}.pre_feedforward_layernorm", tree,
              f"{q}.pre_ffn_norm", plus_one=True)
        _norm(sd, f"{p}.post_feedforward_layernorm", tree,
              f"{q}.post_ffn_norm", plus_one=True)
        for name in ("gate_proj", "up_proj", "down_proj"):
            _linear(sd, f"{p}.mlp.{name}", tree, f"{q}.{name}", bias=False)
    _norm(sd, f"{t}norm", tree, "final_norm", plus_one=True)
    return tree


# ---------------------------------------------------------------------------
# SANA transformer (diffusers SanaTransformer2DModel)
# ---------------------------------------------------------------------------

def _dense_or_conv1x1(sd, torch_prefix, tree, flax_prefix, bias=True):
    """A Dense whose checkpoint may store it as a [out, in, 1, 1] Conv2d
    (SANA's patch embed and GLUMBConv 1x1 convs)."""
    w = sd.get(f"{torch_prefix}.weight", np.zeros(2))
    if w.ndim == 2:
        _linear(sd, torch_prefix, tree, flax_prefix, bias=bias)
    else:
        _conv_as_linear(sd, torch_prefix, tree, flax_prefix)


def convert_sana(sd: Dict[str, np.ndarray], num_layers: int) -> Dict[str, Any]:
    tree: dict = {}
    _dense_or_conv1x1(sd, "patch_embed.proj", tree, "patch_embed.proj")
    _linear(sd, "time_embed.emb.timestep_embedder.linear_1", tree,
            "time_embed.linear_1")
    _linear(sd, "time_embed.emb.timestep_embedder.linear_2", tree,
            "time_embed.linear_2")
    _linear(sd, "time_embed.linear", tree, "time_proj")
    if "caption_projection.linear_1.weight" in sd:
        _linear(sd, "caption_projection.linear_1", tree,
                "caption_projection.linear_1")
        _linear(sd, "caption_projection.linear_2", tree,
                "caption_projection.linear_2")
    else:
        # single-linear synthetic checkpoints: fill linear_1; linear_2
        # stays missing and the coverage check refuses the load
        _linear(sd, "caption_projection", tree,
                "caption_projection.linear_1")
    if "caption_norm.weight" in sd:
        _norm(sd, "caption_norm", tree, "caption_norm")
    for i in range(num_layers):
        p = f"transformer_blocks.{i}"
        q = f"blocks_{i}"
        for a in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{p}.{a}.{name}", tree, f"{q}.{a}.{name}")
            _linear(sd, f"{p}.{a}.to_out.0", tree, f"{q}.{a}.to_out")
            if f"{p}.{a}.norm_q.weight" in sd:
                _norm(sd, f"{p}.{a}.norm_q", tree, f"{q}.{a}.norm_q")
                _norm(sd, f"{p}.{a}.norm_k", tree, f"{q}.{a}.norm_k")
        # GLUMBConv's 1x1 convs are Dense layers in the model; published
        # checkpoints store them as [out, in, 1, 1] Conv2d
        _dense_or_conv1x1(sd, f"{p}.ff.conv_inverted", tree,
                          f"{q}.ff.conv_inverted")
        _conv(sd, f"{p}.ff.conv_depth", tree, f"{q}.ff.conv_depth")
        _dense_or_conv1x1(sd, f"{p}.ff.conv_point", tree,
                          f"{q}.ff.conv_point", bias=False)
        if f"{p}.scale_shift_table" in sd:
            # per-block (6, dim) adaLN table
            _set(tree, f"{q}.scale_shift_table",
                 sd[f"{p}.scale_shift_table"])
    if "scale_shift_table" in sd:
        # top-level (2, dim) table modulates the output head
        tree["out_scale_shift_table"] = sd["scale_shift_table"]
    if "proj_out.weight" in sd:
        _linear(sd, "proj_out", tree, "proj_out")
    return tree


def merge_into(base: Dict[str, Any], converted: Dict[str, Any],
               strict: bool = True) -> Dict[str, Any]:
    """Overlay converted leaves onto a tree of the model's leaves (arrays,
    tensors or shapes), shape-checked; the leaves keep
    the checkpoint's dtype (``load_flax_params`` casts each to its
    parameter's).  ``strict``: a base leaf the checkpoint lacks raises;
    converted leaves with no base leaf are dropped."""

    def walk(b, c, path=""):
        out = {}
        for k, v in b.items():
            name = f"{path}.{k}" if path else k
            if k in c:
                if isinstance(v, dict):
                    out[k] = walk(v, c[k], name)
                else:
                    arr = np.asarray(c[k])
                    want = tuple(getattr(v, "shape", v))
                    if tuple(arr.shape) != want:
                        raise ValueError(
                            f"shape mismatch at {name}: checkpoint "
                            f"{arr.shape} vs model {want}")
                    out[k] = arr
            else:
                if strict and not isinstance(v, dict):
                    raise KeyError(f"checkpoint missing parameter {name}")
                out[k] = v
        return out

    return walk(base, converted)
