"""Seeded synthetic checkpoints in the torch/diffusers key layout.

The repository holds no pretrained weights, so the loaders of both
packages are tested on files synthesized here: the same keys, shapes and
dtypes as the published SANA, PixArt-Sigma, Gemma-2, T5, CLIP, SD1.5/SDXL
UNet, SD3.5 MMDiT, Flux transformer, DC-AE and SD KL-VAE checkpoints (and the CompVis single file of
SD1.5, :func:`write_compvis_single_file`), with seeded values.  Imports numpy only (``torch`` for
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
* ``split{w0},{w1},...``: one flax leaf stored as several torch tensors
  (``template`` holds their keys, ``|``-separated), the leaf's output axis
  cut in the ratio of the weights (Flux's fused ``linear1`` from
  ``to_q``, ``to_k``, ``to_v`` and ``proj_mlp``);
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
        return "|".join(f"{t}.{suffix}" for t in
                        template.format(*m.groups()).split("|")), kind
    raise KeyError(f"no synthesis rule for model leaf {path}")


def _split(kind: str):
    """``(whole kind, piece index or None)`` of a rule kind: a written
    piece of a ``split`` leaf carries ``@{index}``."""
    base, _, j = kind.partition("@")
    return base, (int(j) if j else None)


def split_sizes(kind: str, total: int) -> List[int]:
    """The pieces' sizes along the output axis of a ``split`` leaf."""
    w = [float(x) for x in _split(kind)[0][len("split"):].split(",")]
    sizes = [int(round(total * x / sum(w))) for x in w]
    sizes[-1] = total - sum(sizes[:-1])
    return sizes


def _piece(t: np.ndarray, kind: str) -> np.ndarray:
    """The ``@j`` piece of a ``split`` leaf's torch tensor (rows of a
    weight, entries of a bias)."""
    j = _split(kind)[1]
    sizes = split_sizes(kind, t.shape[0])
    a = sum(sizes[:j])
    return np.ascontiguousarray(t[a:a + sizes[j]])


def torch_shape(shape: tuple, kind: str, path: str) -> tuple:
    """The checkpoint tensor's shape of a flax-layout leaf."""
    shape = tuple(int(s) for s in shape)
    base, j = _split(kind)
    if j is not None:
        whole = torch_shape(shape, base, path)
        return (split_sizes(kind, whole[0])[j],) + whole[1:]
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
        elif "|" in key:
            written += [(path, tuple(shapes[path]), k, f"{kind}@{j}")
                        for j, k in enumerate(key.split("|"))]
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
        base, j = _split(kind)
        v = leaf_value(seed, path, shape, base, dtype)
        t = to_torch_layout(v, base, path)
        sd[key] = t if j is None else _piece(t, kind)
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
        base, j = _split(kind)

        def make():
            t = to_torch_layout(leaf_value(seed, path, shape, base, grid),
                                base, path)
            return t if j is None else _piece(t, kind)
        return make

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


def sd3_rules(patch_size: int = 2) -> List[Rule]:
    """diffusers SD3Transformer2DModel (the transformer/ of the SD3.5
    pipelines): the joint attention's image half under ``attn.to_*``, its
    text half under ``attn.add_*_proj`` and ``to_add_out``, a dual
    block's second image attention under ``attn2``.  The published file
    also holds the ``pos_embed.pos_embed`` table, which neither loader
    reads; it is not written."""
    b = "transformer_blocks.{0}"
    return [
        (r"^patch_embed\.proj\.kernel$", "pos_embed.proj",
         f"patch{patch_size}"),
        (r"^patch_embed\.proj\.bias$", "pos_embed.proj", "auto"),
        (r"^time_embed\.linear_(\d)\.",
         "time_text_embed.timestep_embedder.linear_{0}", "auto"),
        (r"^pool_linear_(\d)\.", "time_text_embed.text_embedder.linear_{0}",
         "auto"),
        (r"^context_embedder\.", "context_embedder", "auto"),
        (r"^blocks_(\d+)\.x_mod\.mod\.", f"{b}.norm1.linear", "auto"),
        (r"^blocks_(\d+)\.c_mod\.mod\.", f"{b}.norm1_context.linear",
         "auto"),
        (r"^blocks_(\d+)\.x_(to_[qkv])\.", f"{b}.attn.{{1}}", "auto"),
        (r"^blocks_(\d+)\.x_to_out\.", f"{b}.attn.to_out.0", "auto"),
        (r"^blocks_(\d+)\.c_to_([qkv])\.", f"{b}.attn.add_{{1}}_proj",
         "auto"),
        (r"^blocks_(\d+)\.c_to_out\.", f"{b}.attn.to_add_out", "auto"),
        (r"^blocks_(\d+)\.x_norm_([qk])\.", f"{b}.attn.norm_{{1}}", "auto"),
        (r"^blocks_(\d+)\.c_norm_([qk])\.", f"{b}.attn.norm_added_{{1}}",
         "auto"),
        (r"^blocks_(\d+)\.x2_(to_[qkv])\.", f"{b}.attn2.{{1}}", "auto"),
        (r"^blocks_(\d+)\.x2_to_out\.", f"{b}.attn2.to_out.0", "auto"),
        (r"^blocks_(\d+)\.x2_norm_([qk])\.", f"{b}.attn2.norm_{{1}}",
         "auto"),
        (r"^blocks_(\d+)\.x_ff\.fc1\.", f"{b}.ff.net.0.proj", "auto"),
        (r"^blocks_(\d+)\.x_ff\.fc2\.", f"{b}.ff.net.2", "auto"),
        (r"^blocks_(\d+)\.c_ff\.fc1\.", f"{b}.ff_context.net.0.proj",
         "auto"),
        (r"^blocks_(\d+)\.c_ff\.fc2\.", f"{b}.ff_context.net.2", "auto"),
        (r"^final_mod\.", "norm_out.linear", "auto"),
        (r"^proj_out\.", "proj_out", "auto"),
    ]


def flux_rules(mlp_ratio: float = 4.0) -> List[Rule]:
    """diffusers FluxTransformer2DModel (the transformer/ of the Flux
    pipelines): a double block's image half under ``attn.to_*`` and ``ff``,
    its caption half under ``attn.add_*_proj``, ``to_add_out`` and
    ``ff_context``; a single block's fused ``linear1`` as ``attn.to_q``,
    ``attn.to_k``, ``attn.to_v`` and ``proj_mlp`` (the MLP ``mlp_ratio``
    times as wide), its ``linear2`` as ``proj_out``."""
    d, s = "transformer_blocks.{0}", "single_transformer_blocks.{0}"
    fused = "|".join(f"{s}.{t}" for t in ("attn.to_q", "attn.to_k",
                                          "attn.to_v", "proj_mlp"))
    return [
        (r"^img_in\.", "x_embedder", "auto"),
        (r"^txt_in\.", "context_embedder", "auto"),
        (r"^time_embed\.linear_(\d)\.",
         "time_text_embed.timestep_embedder.linear_{0}", "auto"),
        (r"^guidance_embed\.linear_(\d)\.",
         "time_text_embed.guidance_embedder.linear_{0}", "auto"),
        (r"^double_(\d+)\.img_mod\.lin\.", f"{d}.norm1.linear", "auto"),
        (r"^double_(\d+)\.txt_mod\.lin\.", f"{d}.norm1_context.linear",
         "auto"),
        (r"^double_(\d+)\.img_(to_[qkv])\.", f"{d}.attn.{{1}}", "auto"),
        (r"^double_(\d+)\.img_to_out\.", f"{d}.attn.to_out.0", "auto"),
        (r"^double_(\d+)\.txt_to_([qkv])\.", f"{d}.attn.add_{{1}}_proj",
         "auto"),
        (r"^double_(\d+)\.txt_to_out\.", f"{d}.attn.to_add_out", "auto"),
        (r"^double_(\d+)\.img_norm_([qk])\.", f"{d}.attn.norm_{{1}}",
         "auto"),
        (r"^double_(\d+)\.txt_norm_([qk])\.", f"{d}.attn.norm_added_{{1}}",
         "auto"),
        (r"^double_(\d+)\.img_ff_1\.", f"{d}.ff.net.0.proj", "auto"),
        (r"^double_(\d+)\.img_ff_2\.", f"{d}.ff.net.2", "auto"),
        (r"^double_(\d+)\.txt_ff_1\.", f"{d}.ff_context.net.0.proj",
         "auto"),
        (r"^double_(\d+)\.txt_ff_2\.", f"{d}.ff_context.net.2", "auto"),
        (r"^single_(\d+)\.mod\.lin\.", f"{s}.norm.linear", "auto"),
        (r"^single_(\d+)\.linear1\.", fused, f"split1,1,1,{mlp_ratio:g}"),
        (r"^single_(\d+)\.linear2\.", f"{s}.proj_out", "auto"),
        (r"^single_(\d+)\.norm_([qk])\.", f"{s}.attn.norm_{{1}}", "auto"),
        (r"^final_mod\.", "norm_out.linear", "auto"),
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

# diffusers AutoencoderKL (the vae/ of the SD, SD3.5 and PixArt pipelines;
# the shapes, 4 or 16 latent channels, come from the model's leaves)
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


# transformers CLIPTextModel (WithProjection: ``text_projection`` outside
# ``text_model.``)
CLIP_RULES: List[Rule] = [
    (r"^token_embedding\.", "text_model.embeddings.token_embedding", "auto"),
    (r"^position_embedding$", "text_model.embeddings.position_embedding."
     "weight", "raw"),
    (r"^layers_(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.",
     "text_model.encoder.layers.{0}.self_attn.{1}", "auto"),
    (r"^layers_(\d+)\.(layer_norm\d)\.", "text_model.encoder.layers.{0}.{1}",
     "auto"),
    (r"^layers_(\d+)\.(fc\d)\.", "text_model.encoder.layers.{0}.mlp.{1}",
     "auto"),
    (r"^final_layer_norm\.", "text_model.final_layer_norm", "auto"),
    (r"^text_projection\.", "text_projection", "auto"),
]

_UNET_RESNET = r"(norm1|conv1|time_emb_proj|norm2|conv2|conv_shortcut)"


def unet_rules(n_levels: int, conv_proj: bool) -> List[Rule]:
    """diffusers UNet2DConditionModel: ``up_blocks.{i}`` is the tree's
    ``up_{n_levels-1-i}``; ``conv_proj``: the spatial transformers'
    ``proj_in``/``proj_out`` are 1x1 convolutions (SD1.5), else linears
    (SDXL)."""
    rules: List[Rule] = [
        (r"^(conv_in|conv_out|conv_norm_out)\.", "{0}", "auto"),
        (r"^time_linear_(\d)\.", "time_embedding.linear_{0}", "auto"),
        (r"^add_linear_(\d)\.", "add_embedding.linear_{0}", "auto"),
    ]

    def attention(flax, torch_):
        rules.extend([
            (rf"^{flax}\.norm\.", torch_ + ".norm", "auto"),
            (rf"^{flax}\.(proj_in|proj_out)\.kernel$", torch_ + ".{0}",
             "conv1x1" if conv_proj else "auto"),
            (rf"^{flax}\.(proj_in|proj_out)\.", torch_ + ".{0}", "auto"),
            (rf"^{flax}\.transformer_blocks_(\d+)\.(attn\d)\.to_out\.",
             torch_ + ".transformer_blocks.{0}.{1}.to_out.0", "auto"),
            (rf"^{flax}\.transformer_blocks_(\d+)\.(attn\d\.to_[qkv]|"
             r"norm\d)\.", torch_ + ".transformer_blocks.{0}.{1}", "auto"),
            (rf"^{flax}\.transformer_blocks_(\d+)\.ff\.proj\.",
             torch_ + ".transformer_blocks.{0}.ff.net.0.proj", "auto"),
            (rf"^{flax}\.transformer_blocks_(\d+)\.ff\.out\.",
             torch_ + ".transformer_blocks.{0}.ff.net.2", "auto")])

    rules.append((rf"^down_(\d+)_resnet_(\d+)\.{_UNET_RESNET}\.",
                  "down_blocks.{0}.resnets.{1}.{2}", "auto"))
    rules.append((r"^down_(\d+)_downsample\.",
                  "down_blocks.{0}.downsamplers.0.conv", "auto"))
    rules.append((rf"^mid_resnet_(\d)\.{_UNET_RESNET}\.",
                  "mid_block.resnets.{0}.{1}", "auto"))
    attention("mid_attn", "mid_block.attentions.0")
    for level in range(n_levels):
        u = n_levels - 1 - level
        rules.append((rf"^up_{level}_resnet_(\d+)\.{_UNET_RESNET}\.",
                      f"up_blocks.{u}.resnets.{{0}}.{{1}}", "auto"))
        rules.append((rf"^up_{level}_upsample\.",
                      f"up_blocks.{u}.upsamplers.0.conv", "auto"))
        for j in range(8):
            attention(rf"down_{level}_attn_{j}",
                      f"down_blocks.{level}.attentions.{j}")
            attention(rf"up_{level}_attn_{j}",
                      f"up_blocks.{u}.attentions.{j}")
    return rules


# diffusers resnet part → LDM's (the inverse of the CompVis converter's
# table)
_LDM_RESNET_PARTS = {"norm1": "in_layers.0", "conv1": "in_layers.2",
                     "time_emb_proj": "emb_layers.1",
                     "norm2": "out_layers.0", "conv2": "out_layers.3",
                     "conv_shortcut": "skip_connection"}


def ldm_unet_key(key: str, layers_per_block: int,
                 transformer_layers: Tuple[int, ...]) -> str:
    """A diffusers UNet key → its CompVis/LDM name (``input_blocks``,
    ``middle_block``, ``output_blocks``), as SD1.5's single file holds
    it."""
    lpb, n = layers_per_block, len(transformer_layers)
    fixed = {"conv_in": "input_blocks.0.0",
             "time_embedding.linear_1": "time_embed.0",
             "time_embedding.linear_2": "time_embed.2",
             "add_embedding.linear_1": "label_emb.0.0",
             "add_embedding.linear_2": "label_emb.0.2",
             "conv_norm_out": "out.0", "conv_out": "out.2"}
    head, _, wb = key.rpartition(".")
    if head in fixed:
        return f"{fixed[head]}.{wb}"

    def resnet(rest):
        part, _, tail = rest.partition(".")
        return f"{_LDM_RESNET_PARTS[part]}.{tail}"

    m = re.match(r"^down_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.*)$",
                 key)
    if m:
        i, kind, j, rest = int(m.group(1)), m.group(2), int(m.group(3)), \
            m.group(4)
        k = 1 + i * (lpb + 1) + j
        return (f"input_blocks.{k}.0.{resnet(rest)}" if kind == "resnets"
                else f"input_blocks.{k}.1.{rest}")
    m = re.match(r"^down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.*)$", key)
    if m:
        k = 1 + int(m.group(1)) * (lpb + 1) + lpb
        return f"input_blocks.{k}.0.op.{m.group(2)}"
    m = re.match(r"^mid_block\.resnets\.(\d)\.(.*)$", key)
    if m:
        return f"middle_block.{2 * int(m.group(1))}.{resnet(m.group(2))}"
    if key.startswith("mid_block.attentions.0."):
        return "middle_block.1." + key[len("mid_block.attentions.0."):]
    m = re.match(r"^up_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\.(.*)$",
                 key)
    if m:
        u, kind, j, rest = int(m.group(1)), m.group(2), int(m.group(3)), \
            m.group(4)
        k = u * (lpb + 1) + j
        return (f"output_blocks.{k}.0.{resnet(rest)}" if kind == "resnets"
                else f"output_blocks.{k}.1.{rest}")
    m = re.match(r"^up_blocks\.(\d+)\.upsamplers\.0\.conv\.(.*)$", key)
    if m:
        u = int(m.group(1))
        mod = 2 if transformer_layers[n - 1 - u] > 0 else 1
        return f"output_blocks.{u * (lpb + 1) + lpb}.{mod}.conv.{m.group(2)}"
    raise KeyError(f"no LDM name for the UNet key {key}")


def ldm_vae_key(key: str, n_levels: int) -> Tuple[str, bool]:
    """A diffusers AutoencoderKL key → ``(its CompVis/LDM name, whether
    the LDM file holds it as a 1x1 convolution)`` (the mid attention's
    q/k/v/proj_out)."""
    nk = key.replace("conv_shortcut", "nin_shortcut")
    nk = re.sub(r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)",
                r"encoder.down.\1.block.\2", nk)
    nk = re.sub(r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv",
                r"encoder.down.\1.downsample.conv", nk)
    m = re.match(r"^decoder\.up_blocks\.(\d+)\.(.*)$", nk)
    if m:
        rest = re.sub(r"^resnets\.(\d+)", r"block.\1", m.group(2))
        rest = re.sub(r"^upsamplers\.0\.conv", "upsample.conv", rest)
        nk = f"decoder.up.{n_levels - 1 - int(m.group(1))}.{rest}"
    conv = False
    for side in ("encoder", "decoder"):
        nk = nk.replace(f"{side}.mid_block.resnets.0", f"{side}.mid.block_1")
        nk = nk.replace(f"{side}.mid_block.resnets.1", f"{side}.mid.block_2")
        nk = nk.replace(f"{side}.conv_norm_out", f"{side}.norm_out")
        a = f"{side}.mid_block.attentions.0."
        if nk.startswith(a):
            name, _, wb = nk[len(a):].partition(".")
            if name == "to_out":
                name, wb = "proj_out", wb.partition(".")[2]
            name = {"group_norm": "norm", "to_q": "q", "to_k": "k",
                    "to_v": "v"}.get(name, name)
            conv = name in ("q", "k", "v", "proj_out") and wb == "weight"
            nk = f"{side}.mid.attn_1.{name}.{wb}"
    return nk, conv


def write_compvis_single_file(path: str, unet_shapes: Mapping[str, tuple],
                              unet_cfg, seed: int, dtype: str = "F16",
                              vae_shapes: Mapping[str, tuple] = None,
                              clip_shapes: Mapping[str, tuple] = None
                              ) -> dict:
    """A CompVis single file of SD1.5 (``model.diffusion_model.``,
    ``first_stage_model.``, ``cond_stage_model.transformer.``) streamed to
    ``path``: the UNet of ``unet_shapes`` (flax paths; ``unet_cfg`` gives
    its levels, ``layers_per_block``, ``transformer_layers``) and, when
    given, the KL-VAE and CLIP-L.  Each leaf holds what
    :func:`write_checkpoint` with the diffusers rules and ``seed`` would
    write (``expected_values`` of those rules gives it).  Returns
    ``{"tensors", "bytes"}``."""
    n = len(unet_cfg.block_out_channels)
    parts = [(unet_shapes, unet_rules(n, conv_proj=True),
              lambda k: ("model.diffusion_model." + ldm_unet_key(
                  k, unet_cfg.layers_per_block,
                  tuple(unet_cfg.transformer_layers)), False))]
    if vae_shapes is not None:
        n_vae = 1 + max(int(m.group(1)) for m in (
            re.match(r"^decoder\.up_(\d+)_", p) for p in vae_shapes) if m)

        def vae_key(k):
            nk, conv = ldm_vae_key(k, n_vae)
            return "first_stage_model." + nk, conv
        parts.append((vae_shapes, VAE_KL_RULES, vae_key))
    if clip_shapes is not None:
        parts.append((clip_shapes, CLIP_RULES, lambda k: (
            "cond_stage_model.transformer." + k, False)))

    def maker(path_, shape, kind, conv):
        def make():
            t = to_torch_layout(leaf_value(seed, path_, shape, kind, dtype),
                                kind, path_)
            return t[:, :, None, None] if conv else t
        return make

    entries = []
    for shapes, rules, rename in parts:
        written, _ = plan(shapes, rules)
        for path_, shape, key, kind in written:
            ldm, conv = rename(key)
            tshape = torch_shape(shape, kind, path_)
            entries.append((ldm, tshape + ((1, 1) if conv else ()),
                            maker(path_, shape, kind, conv)))
    nbytes = write_safetensors(path, entries, dtype)
    return {"tensors": len(entries), "bytes": nbytes}


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


# torch.hub dinov2_vitb14: a fused qkv per block, LayerScale ``gamma``s,
# a ``mask_token``, and the ``pos_embed`` of its 518 px build (37x37 + cls)
DINOV2_PUBLISHED_GRID = 37


def dinov2_state_dict(hidden: int = 768, num_layers: int = 12,
                      mlp_ratio: float = 4.0, patch_size: int = 14,
                      grid: int = DINOV2_PUBLISHED_GRID,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded ``dinov2_vitb14`` state dict in the published keys and
    shapes (fp32 numpy; write it with :func:`write_bin` as a ``.pth``).
    ``grid`` sets ``pos_embed`` to ``[1, grid² + 1, hidden]``: the
    published 37 does not fit a 224 px model (16), which a test of the
    misfit wants."""
    d, h = hidden, int(hidden * mlp_ratio)
    shapes = {"patch_embed.proj.weight": (d, 3, patch_size, patch_size),
              "patch_embed.proj.bias": (d,), "cls_token": (1, 1, d),
              "pos_embed": (1, grid * grid + 1, d), "mask_token": (1, d),
              "norm.weight": (d,), "norm.bias": (d,)}
    for i in range(num_layers):
        p = f"blocks.{i}"
        shapes.update({
            f"{p}.norm1.weight": (d,), f"{p}.norm1.bias": (d,),
            f"{p}.attn.qkv.weight": (3 * d, d), f"{p}.attn.qkv.bias": (3 * d,),
            f"{p}.attn.proj.weight": (d, d), f"{p}.attn.proj.bias": (d,),
            f"{p}.ls1.gamma": (d,), f"{p}.norm2.weight": (d,),
            f"{p}.norm2.bias": (d,), f"{p}.mlp.fc1.weight": (h, d),
            f"{p}.mlp.fc1.bias": (h,), f"{p}.mlp.fc2.weight": (d, h),
            f"{p}.mlp.fc2.bias": (d,), f"{p}.ls2.gamma": (d,)})
    out = {}
    for key, shape in shapes.items():
        rng = np.random.default_rng([int(seed), zlib.crc32(key.encode())])
        v = rng.standard_normal(shape, dtype=np.float32)
        if key.endswith("weight") and len(shape) > 1:
            v *= np.float32(int(np.prod(shape[1:])) ** -0.5)
        elif "norm" in key and key.endswith("weight"):
            v = 1.0 + 0.05 * v
        elif key.endswith("gamma"):
            v = 0.1 * v
        else:
            v *= np.float32(0.02)
        out[key] = v.astype(np.float32)
    return out


# a real PEFT file's names for the DiT families (SANA, PixArt-Sigma):
# (regex over the flax module path, the diffusers module path)
PEFT_DIT_MODULES: List[Tuple[str, str]] = [
    (r"^blocks_(\d+)\.(attn\d)\.to_out$", "transformer_blocks.{0}.{1}.to_out.0"),
    (r"^blocks_(\d+)\.(attn\d)\.(to_[qkv])$", "transformer_blocks.{0}.{1}.{2}"),
    (r"^blocks_(\d+)\.ff\.fc1$", "transformer_blocks.{0}.ff.net.0.proj"),
    (r"^blocks_(\d+)\.ff\.fc2$", "transformer_blocks.{0}.ff.net.2"),
]
# an adapter leaf's PEFT/LyCORIS suffix, and whether the file holds its
# transpose (the torch ``[out, in]`` layout)
PEFT_LEAVES = {
    "lora_a": ("lora_A.weight", True), "lora_b": ("lora_B.weight", True),
    "dora_m": ("lora_magnitude_vector.weight", False),
    "hada_w1_a": ("hada_w1_a", True), "hada_w1_b": ("hada_w1_b", True),
    "hada_w2_a": ("hada_w2_a", True), "hada_w2_b": ("hada_w2_b", True),
    "lokr_w1": ("lokr_w1", True), "lokr_w2_a": ("lokr_w2_a", True),
    "lokr_w2_b": ("lokr_w2_b", True),
    "fft_spectrum": ("fourierft_spectrum", False),
}


def write_peft_adapters(path: str, leaves: Mapping[str, tuple],
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """A PEFT-named adapter file (``base_model.model.{diffusers module
    path}.{suffix}``, F32) for the leaves ``{"blocks_0.attn1.to_q.lokr_w1":
    shape in the JAX layout}``, seeded per leaf.  Returns ``{leaf path:
    value in the JAX layout}``, what a correct load gives each leaf."""
    tensors, expected = [], {}
    for name in sorted(leaves):
        module, leaf = name.rsplit(".", 1)
        for pat, template in PEFT_DIT_MODULES:
            m = re.match(pat, module)
            if m is not None:
                torch_module = template.format(*m.groups())
                break
        else:
            raise KeyError(f"no PEFT module name for {module}")
        suffix, transpose = PEFT_LEAVES[leaf]
        shape = tuple(int(s) for s in leaves[name])
        rng = np.random.default_rng([int(seed), zlib.crc32(name.encode())])
        v = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        expected[name] = v
        t = np.ascontiguousarray(v.T if transpose and v.ndim == 2 else v)
        tensors.append((f"base_model.model.{torch_module}.{suffix}", t.shape,
                        lambda t=t: t))
    write_safetensors(path, tensors, "F32")
    return expected
