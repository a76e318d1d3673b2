"""Seeded synthetic checkpoints in the torch/diffusers key layout.

The repository holds no pretrained weights, so the loaders of both
packages are tested on files synthesized here: the same keys, shapes and
dtypes as the published SANA, PixArt-Sigma, Gemma-2, T5, DC-AE and SD
KL-VAE checkpoints, with seeded values.  Imports numpy only (``torch`` for
``.bin`` files, inside :func:`write_bin`), never JAX or either package, so
the JAX package's tests, the port's tests and ``chip_smoke.py`` share it.

A model is described by its leaves in the flax layout,
``{dotted flax path: shape}`` (from a flax init tree through
:func:`leaf_shapes`, or from the port's ``convert.flax_params``).  A rule
list maps each leaf onto a torch key; the first rule whose regex matches a
path wins, and a leaf no rule matches raises, so a synthesized checkpoint
provably covers the whole model.  A rule is ``(regex, template, kind)``;
``template`` is formatted with the regex groups, and ``kind`` is

* ``auto``: ``kernel`` → ``{template}.weight`` in the torch layout (a 2-D
  kernel ``[in, out]`` transposed, a 4-D HWIO kernel as OIHW), ``scale``
  and ``embedding`` → ``.weight`` as they are, ``bias`` → ``.bias``;
* ``conv1x1``: a 2-D kernel stored as a ``[out, in, 1, 1]`` convolution;
* ``patch{p}``: a ``[p·p·c, d]`` patch-embed kernel stored as the
  ``[d, c, p, p]`` convolution, in (h, w, c) patch order;
* ``norm1``: Gemma's RMSNorm, stored as ``scale - 1``;
* ``raw``: ``template`` is the whole key, the leaf as it is;
* ``drop``: not in the checkpoint (a torch layer without that bias); the
  loader must set it to zero.

Each leaf's value depends only on the seed and its path
(:func:`leaf_value`), so a checker regenerates what any parameter must hold
without keeping the checkpoint in memory.  Values are scaled like an
initialised model (kernels ``fan_in^-0.5``, norm scales near 1) and are
exactly representable in the file's dtype, so F32, F16 and BF16 files of
one seed hold the same numbers.
"""

from __future__ import annotations

import json
import os
import re
import struct
import zlib
from typing import Callable, Dict, Iterable, List, Mapping, Tuple

import numpy as np

Rule = Tuple[str, str, str]

# file dtype → its safetensors code
DTYPES = ("F32", "F16", "BF16")


def leaf_shapes(tree: Mapping, prefix: str = "") -> Dict[str, tuple]:
    """``{dotted path: shape}`` of a nested dict whose leaves are arrays,
    tensors or shapes."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(leaf_shapes(v, name))
        else:
            out[name] = tuple(getattr(v, "shape", v))
    return out


# elements one generator fills: values do not depend on the thread count
_CHUNK = 1 << 22


def _chunked(n: int, fn) -> None:
    """``fn(begin, end)`` over fixed chunks of ``n`` elements, in threads
    when there is more than one (numpy releases the GIL while it fills
    and computes)."""
    bounds = [(a, min(a + _CHUNK, n)) for a in range(0, n, _CHUNK)]
    if len(bounds) <= 1:
        for a, b in bounds:
            fn(a, b)
        return
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as pool:
        for f in [pool.submit(fn, a, b) for a, b in bounds]:
            f.result()


def _round_inplace(x: np.ndarray, dtype: str) -> None:
    """Round fp32 ``x`` in place to the nearest ``dtype`` value (ties to
    even); finite values only."""
    if dtype == "F16":
        x[...] = x.astype(np.float16)
    elif dtype == "BF16":
        bits = x.view(np.uint32)
        bits += np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
        bits &= np.uint32(0xFFFF0000)


def round_to(x: np.ndarray, dtype: str) -> np.ndarray:
    """fp32 values rounded to the nearest ``dtype`` value (ties to even),
    still as fp32."""
    x = np.array(x, np.float32)
    _round_inplace(x, dtype)
    return x


def _encode(x: np.ndarray, dtype: str) -> memoryview:
    """Little-endian bytes of fp32 values already on ``dtype``'s grid."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    if dtype == "F32":
        return memoryview(x.astype("<f4", copy=False)).cast("B")
    out = np.empty(x.size, "<f2" if dtype == "F16" else "<u2")

    def enc(a, b):
        out[a:b] = x[a:b] if dtype == "F16" else \
            x[a:b].view(np.uint32) >> np.uint32(16)
    _chunked(x.size, enc)
    return memoryview(out).cast("B")


def match(path: str, rules: Iterable[Rule]):
    """``(torch key or None, kind)`` of a flax leaf path."""
    for pat, template, kind in rules:
        m = re.match(pat, path)
        if m is None:
            continue
        if kind == "drop":
            return None, kind
        if kind == "raw":
            return template.format(*m.groups()), kind
        leaf = path.rsplit(".", 1)[-1]
        suffix = "bias" if leaf == "bias" else "weight"
        return f"{template.format(*m.groups())}.{suffix}", kind
    raise KeyError(f"no synthesis rule for model leaf {path}")


def torch_shape(shape: tuple, kind: str, path: str) -> tuple:
    """The checkpoint tensor's shape of a flax-layout leaf."""
    shape = tuple(int(s) for s in shape)
    if kind in ("raw", "norm1") or not path.endswith(".kernel"):
        return shape
    if len(shape) == 2 and kind == "conv1x1":
        return (shape[1], shape[0], 1, 1)
    if len(shape) == 2 and kind.startswith("patch"):
        p = int(kind[len("patch"):])
        return (shape[1], shape[0] // (p * p), p, p)
    if len(shape) == 2:
        return (shape[1], shape[0])
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    return shape


def from_torch_layout(t: np.ndarray, kind: str, path: str) -> np.ndarray:
    """The flax-layout leaf of a checkpoint tensor (a view where the
    layout is a transpose)."""
    if kind == "norm1":
        return t + np.float32(1.0)
    if kind == "raw" or not path.endswith(".kernel"):
        return t
    if t.ndim == 4 and kind == "conv1x1":
        return t[:, :, 0, 0].T
    if t.ndim == 4 and kind.startswith("patch"):
        d, c, p, _ = t.shape
        return np.ascontiguousarray(t.transpose(2, 3, 1, 0)).reshape(
            p * p * c, d)
    if t.ndim == 2:
        return t.T
    if t.ndim == 4:
        return t.transpose(2, 3, 1, 0)
    return t


def to_torch_layout(value: np.ndarray, kind: str, path: str) -> np.ndarray:
    """A flax-layout leaf as its checkpoint tensor (no copy for a leaf
    :func:`leaf_value` made)."""
    if kind == "norm1":
        return value - np.float32(1.0)
    if kind == "raw" or not path.endswith(".kernel"):
        return value
    if value.ndim == 2 and kind == "conv1x1":
        return np.ascontiguousarray(value.T)[:, :, None, None]
    if value.ndim == 2 and kind.startswith("patch"):
        p = int(kind[len("patch"):])
        d = value.shape[1]
        c = value.shape[0] // (p * p)
        return np.ascontiguousarray(
            value.reshape(p, p, c, d).transpose(3, 2, 0, 1))
    if value.ndim == 2:
        return np.ascontiguousarray(value.T)
    if value.ndim == 4:
        return np.ascontiguousarray(value.transpose(3, 2, 0, 1))
    return value


def leaf_value(seed: int, path: str, shape: tuple, kind: str,
               dtype: str = "F32") -> np.ndarray:
    """The flax-layout value of one leaf (zeros for a dropped one), drawn
    in the checkpoint's layout in fixed chunks, each from its own seeded
    generator, and rounded to ``dtype``'s grid."""
    shape = tuple(int(s) for s in shape)
    if kind == "drop":
        return np.zeros(shape, np.float32)
    leaf = path.rsplit(".", 1)[-1]
    add = 0.0
    if leaf == "kernel":
        mul = int(np.prod(shape[:-1])) ** -0.5
    elif leaf == "scale":
        mul, add = 0.05, (0.0 if kind == "norm1" else 1.0)
    elif leaf == "embedding" or kind == "raw":
        mul = shape[-1] ** -0.5
    else:
        mul = 0.02
    tshape = torch_shape(shape, kind, path)
    t = np.empty(int(np.prod(tshape)), np.float32)
    key = zlib.crc32(path.encode())

    def fill(a, b):
        seg = t[a:b]
        np.random.default_rng([int(seed), key, a // _CHUNK]).standard_normal(
            out=seg, dtype=np.float32)
        seg *= np.float32(mul)
        if add:
            seg += np.float32(add)
        _round_inplace(seg, dtype)
        if kind == "norm1":
            # the file holds scale - 1: keep it exact through the +1
            seg[np.abs(seg) < 2.0 ** -12] = 0.0
    _chunked(t.size, fill)
    return from_torch_layout(t.reshape(tshape), kind, path)


def plan(shapes: Mapping[str, tuple], rules: List[Rule]):
    """``[(flax path, shape, torch key, kind)]`` for every leaf written to
    the checkpoint, plus the dropped paths."""
    written, dropped = [], []
    for path in sorted(shapes):
        key, kind = match(path, rules)
        if key is None:
            dropped.append(path)
        else:
            written.append((path, tuple(shapes[path]), key, kind))
    keys = [w[2] for w in written]
    if len(set(keys)) != len(keys):
        raise ValueError("two model leaves map onto one checkpoint key")
    return written, dropped


def synth(shapes: Mapping[str, tuple], rules: List[Rule], seed: int,
          dtype: str = "F32"):
    """``(state_dict, expected)``: the checkpoint's tensors (fp32 numpy on
    ``dtype``'s grid, torch layout) and ``{flax path: value}`` that a
    correct load gives every leaf (zeros for the dropped ones)."""
    written, dropped = plan(shapes, rules)
    sd, expected = {}, {}
    for path, shape, key, kind in written:
        v = leaf_value(seed, path, shape, kind, dtype)
        sd[key] = to_torch_layout(v, kind, path)
        expected[path] = v
    for path in dropped:
        expected[path] = np.zeros(shapes[path], np.float32)
    return sd, expected


def expected_values(shapes: Mapping[str, tuple], rules: List[Rule],
                    seed: int, dtype: str = "F32"):
    """Yield ``(flax path, value)`` for every leaf, one at a time."""
    for path in sorted(shapes):
        _, kind = match(path, rules)
        yield path, leaf_value(seed, path, shapes[path], kind, dtype)


def write_safetensors(path: str, tensors: List[Tuple[str, tuple,
                                                     Callable[[], np.ndarray]]],
                      dtype: str = "F32",
                      metadata: Mapping[str, str] = None) -> int:
    """Write ``[(key, shape, make_value)]`` in the safetensors format, one
    tensor in memory at a time; ``make_value()`` returns fp32 values on
    ``dtype``'s grid.  Returns the bytes written."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} not in {DTYPES}")
    width = {"F32": 4, "F16": 2, "BF16": 2}[dtype]
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = dict(metadata)
    for key, shape, _ in tensors:
        n = int(np.prod(shape)) * width
        header[key] = {"dtype": dtype, "shape": [int(s) for s in shape],
                       "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for key, shape, make in tensors:
            x = make()
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"{key}: made {x.shape}, declared {shape}")
            f.write(_encode(x, dtype))
    return 8 + len(raw) + offset


def write_checkpoint(dirpath: str, shapes: Mapping[str, tuple],
                     rules: List[Rule], seed: int, dtype: str = "F32",
                     name: str = "diffusion_pytorch_model.safetensors",
                     config: Mapping = None, grid: str = None) -> dict:
    """Synthesize a model's checkpoint into ``dirpath/name`` (safetensors,
    streamed) with an optional ``config.json``; the values lie on
    ``grid``'s values (default: the file's ``dtype``), so an F32 file with
    ``grid="BF16"`` holds what the BF16 file of the same seed holds.
    Returns ``{"tensors", "bytes", "dropped"}``."""
    written, dropped = plan(shapes, rules)
    grid = grid or dtype

    def maker(path, shape, kind):
        return lambda: to_torch_layout(
            leaf_value(seed, path, shape, kind, grid), kind, path)

    entries = [(key, torch_shape(shape, kind, path),
                maker(path, shape, kind))
               for path, shape, key, kind in written]
    os.makedirs(dirpath, exist_ok=True)
    nbytes = write_safetensors(os.path.join(dirpath, name), entries, dtype)
    if config is not None:
        with open(os.path.join(dirpath, "config.json"), "w") as f:
            json.dump(dict(config), f)
    return {"tensors": len(entries), "bytes": nbytes, "dropped": dropped}


def write_bin(path: str, state_dict: Mapping[str, np.ndarray]) -> None:
    """A ``.bin`` checkpoint (``torch.save`` of fp32 tensors)."""
    import torch
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                for k, v in state_dict.items()}, path)


# ---------------------------------------------------------------------------
# key layouts of the published checkpoints
# ---------------------------------------------------------------------------

# diffusers SanaTransformer2DModel: 1x1 convs for the patch embed and the
# GLUMBConv ends; no q/k/v biases (tests/test_checkpoint_inventory.py)
SANA_RULES: List[Rule] = [
    (r"^patch_embed\.proj\.kernel$", "patch_embed.proj", "conv1x1"),
    (r"^patch_embed\.proj\.bias$", "patch_embed.proj", "auto"),
    (r"^time_embed\.linear_(\d)\.", "time_embed.emb.timestep_embedder."
     "linear_{0}", "auto"),
    (r"^time_proj\.", "time_embed.linear", "auto"),
    (r"^caption_projection\.linear_(\d)\.", "caption_projection.linear_{0}",
     "auto"),
    (r"^caption_norm\.", "caption_norm", "auto"),
    (r"^blocks_(\d+)\.scale_shift_table$",
     "transformer_blocks.{0}.scale_shift_table", "raw"),
    (r"^blocks_(\d+)\.attn\d\.to_[qkv]\.bias$", "", "drop"),
    (r"^blocks_(\d+)\.(attn\d)\.(to_[qkv]|norm_[qk])\.",
     "transformer_blocks.{0}.{1}.{2}", "auto"),
    (r"^blocks_(\d+)\.(attn\d)\.to_out\.", "transformer_blocks.{0}.{1}."
     "to_out.0", "auto"),
    (r"^blocks_(\d+)\.ff\.(conv_inverted|conv_point)\.kernel$",
     "transformer_blocks.{0}.ff.{1}", "conv1x1"),
    (r"^blocks_(\d+)\.ff\.(conv_\w+)\.", "transformer_blocks.{0}.ff.{1}",
     "auto"),
    (r"^out_scale_shift_table$", "scale_shift_table", "raw"),
    (r"^proj_out\.", "proj_out", "auto"),
]


def pixart_rules(patch_size: int = 2) -> List[Rule]:
    """diffusers PixArtTransformer2DModel (a conv patch embed)."""
    return [
        (r"^pos_embed\.proj\.kernel$", "pos_embed.proj", f"patch{patch_size}"),
        (r"^pos_embed\.proj\.bias$", "pos_embed.proj", "auto"),
        (r"^time_embed\.linear_(\d)\.", "adaln_single.emb.timestep_embedder."
         "linear_{0}", "auto"),
        (r"^time_proj\.", "adaln_single.linear", "auto"),
        (r"^caption_projection\.linear_(\d)\.",
         "caption_projection.linear_{0}", "auto"),
        (r"^out_scale_shift_table$", "scale_shift_table", "raw"),
        (r"^blocks_(\d+)\.scale_shift_table$",
         "transformer_blocks.{0}.scale_shift_table", "raw"),
        (r"^blocks_(\d+)\.(attn\d)\.(to_[qkv])\.",
         "transformer_blocks.{0}.{1}.{2}", "auto"),
        (r"^blocks_(\d+)\.(attn\d)\.to_out\.",
         "transformer_blocks.{0}.{1}.to_out.0", "auto"),
        (r"^blocks_(\d+)\.ff\.fc1\.", "transformer_blocks.{0}.ff.net.0.proj",
         "auto"),
        (r"^blocks_(\d+)\.ff\.fc2\.", "transformer_blocks.{0}.ff.net.2",
         "auto"),
        (r"^proj_out\.", "proj_out", "auto"),
    ]


# transformers Gemma2Model (the text_encoder/ of the SANA pipelines)
GEMMA2_RULES: List[Rule] = [
    (r"^token_embedding\.", "embed_tokens", "auto"),
    (r"^layers_(\d+)\.(q_proj|k_proj|v_proj|o_proj)\.",
     "layers.{0}.self_attn.{1}", "auto"),
    (r"^layers_(\d+)\.input_norm\.", "layers.{0}.input_layernorm", "norm1"),
    (r"^layers_(\d+)\.post_attn_norm\.",
     "layers.{0}.post_attention_layernorm", "norm1"),
    (r"^layers_(\d+)\.pre_ffn_norm\.",
     "layers.{0}.pre_feedforward_layernorm", "norm1"),
    (r"^layers_(\d+)\.post_ffn_norm\.",
     "layers.{0}.post_feedforward_layernorm", "norm1"),
    (r"^layers_(\d+)\.(gate_proj|up_proj|down_proj)\.", "layers.{0}.mlp.{1}",
     "auto"),
    (r"^final_norm\.", "norm", "norm1"),
]

# transformers T5EncoderModel (the text_encoder/ of the PixArt pipelines)
T5_RULES: List[Rule] = [
    (r"^token_embedding\.", "shared", "auto"),
    (r"^relative_attention_bias$",
     "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
     "raw"),
    (r"^layers_(\d+)\.([qkvo])\.", "encoder.block.{0}.layer.0."
     "SelfAttention.{1}", "auto"),
    (r"^layers_(\d+)\.norm1\.", "encoder.block.{0}.layer.0.layer_norm",
     "auto"),
    (r"^layers_(\d+)\.(wi_0|wi_1|wo)\.", "encoder.block.{0}.layer.1."
     "DenseReluDense.{1}", "auto"),
    (r"^layers_(\d+)\.norm2\.", "encoder.block.{0}.layer.1.layer_norm",
     "auto"),
    (r"^final_norm\.", "encoder.final_layer_norm", "auto"),
]

# diffusers AutoencoderKL (the vae/ of the SD and PixArt pipelines)
_KL_RESNET = r"(norm1|conv1|norm2|conv2|conv_shortcut)"
VAE_KL_RULES: List[Rule] = [
    (r"^encoder\.quant_conv\.", "quant_conv", "auto"),
    (r"^decoder\.post_quant_conv\.", "post_quant_conv", "auto"),
    (r"^(encoder|decoder)\.(conv_in|conv_out|conv_norm_out)\.", "{0}.{1}",
     "auto"),
    (rf"^encoder\.down_(\d+)_resnet_(\d+)\.{_KL_RESNET}\.",
     "encoder.down_blocks.{0}.resnets.{1}.{2}", "auto"),
    (r"^encoder\.down_(\d+)_downsample\.",
     "encoder.down_blocks.{0}.downsamplers.0.conv", "auto"),
    (rf"^decoder\.up_(\d+)_resnet_(\d+)\.{_KL_RESNET}\.",
     "decoder.up_blocks.{0}.resnets.{1}.{2}", "auto"),
    (r"^decoder\.up_(\d+)_upsample\.",
     "decoder.up_blocks.{0}.upsamplers.0.conv", "auto"),
    (rf"^(encoder|decoder)\.mid_resnet_(\d)\.{_KL_RESNET}\.",
     "{0}.mid_block.resnets.{1}.{2}", "auto"),
    (r"^(encoder|decoder)\.mid_attn\.group_norm\.",
     "{0}.mid_block.attentions.0.group_norm", "auto"),
    (r"^(encoder|decoder)\.mid_attn\.(to_[qkv])\.",
     "{0}.mid_block.attentions.0.{1}", "auto"),
    (r"^(encoder|decoder)\.mid_attn\.to_out\.",
     "{0}.mid_block.attentions.0.to_out.0", "auto"),
]


def dcae_rules(cfg) -> List[Rule]:
    """diffusers AutoencoderDC, with each down/up sample conv serialized as
    the last entry of its stage (the converter is structure-driven and
    assigns blocks in serialized order).  ``cfg`` is either package's
    ``DCAEConfig``."""
    n = len(cfg.block_out_channels)
    rules: List[Rule] = []

    def at(flax_prefix, torch_prefix):
        rules.append((rf"^{re.escape(flax_prefix)}\.", torch_prefix, "auto"))

    def glu(fp, tp):
        for conv in ("conv_inverted", "conv_depth", "conv_point", "norm"):
            at(f"{fp}.{conv}", f"{tp}.{conv}")

    for side, layers, resample, kind in (
            ("encoder", cfg.encoder_layers, "down", "down_blocks"),
            ("decoder", tuple(reversed(cfg.decoder_layers)), "up",
             "up_blocks")):
        attn = cfg.attention_stages if side == "encoder" \
            else tuple(reversed(cfg.attention_stages))
        for name in ("conv_in", "conv_out", "norm_out"):
            at(f"{side}.{name}", f"{side}.{name}")
        for i in range(n):
            j = 0
            for b in range(layers[i]):
                tp, fp = f"{side}.{kind}.{i}.{j}", f"{side}.stage_{i}_block_{b}"
                if attn[i]:
                    for proj in ("to_q", "to_k", "to_v", "to_out"):
                        at(f"{fp}.attn.{proj}", f"{tp}.attn.{proj}")
                    for s in range(len(cfg.qkv_multiscales)):
                        for io in ("proj_in", "proj_out"):
                            at(f"{fp}.attn.ms_{s}_{io}",
                               f"{tp}.attn.to_qkv_multiscale.{s}.{io}")
                    at(f"{fp}.attn.norm_out", f"{tp}.attn.norm_out")
                    glu(f"{fp}.conv_out", f"{tp}.conv_out")
                else:
                    for part in ("conv1", "conv2", "norm"):
                        at(f"{fp}.{part}", f"{tp}.{part}")
                j += 1
            if i < n - 1:
                at(f"{side}.{resample}_{i + 1}.conv", f"{side}.{kind}.{i}.{j}"
                   ".conv")
    return rules


def sana_config_json(cfg, **extra) -> dict:
    """The diffusers ``config.json`` of a SANA transformer (either
    package's ``SanaConfig``)."""
    out = {"in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
           "num_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_attention_heads,
           "attention_head_dim": cfg.attention_head_dim,
           "num_cross_attention_heads": cfg.num_cross_attention_heads,
           "cross_attention_head_dim": cfg.cross_attention_head_dim,
           "caption_channels": cfg.caption_channels,
           "mlp_ratio": cfg.mlp_ratio, "patch_size": cfg.patch_size,
           "sample_size": cfg.sample_size}
    if cfg.qk_norm:
        out["qk_norm"] = cfg.qk_norm
    out.update(extra)
    return out
