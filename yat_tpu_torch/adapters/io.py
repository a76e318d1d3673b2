"""Adapter export and import: safetensors with PEFT-compatible naming.

Counterpart of ``yat_tpu/adapters/io.py``.  Export keys are

    base_model.model.{dotted.flax.module.path}.lora_A.weight   [r, in]
    base_model.model.{dotted.flax.module.path}.lora_B.weight   [out, r]

(the torch layout; every kind's leaf is renamed and transposed through
``_PEFT_NAMES``), and the header's metadata carries the 0-d meta (the
scales) as JSON under ``yat_meta``, as the JAX package writes them;
FourierFT's indices are not in the file.  ``load_adapter_safetensors``
reads the export of either package, bare flax paths, and real PEFT files
with torch/diffusers module paths (``adapters/peft_paths.py``).  The safetensors format
is written and read here directly (an 8-byte little-endian header length,
a JSON header, then the raw little-endian tensors back to back), so the
port needs no ``safetensors`` package.  Adapter files are written in F32;
the reader also takes the F16 and BF16 tensors of pretrained checkpoints
(``models/convert.py``).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

# our leaf name ↔ (peft suffix, transpose_needed)
_PEFT_NAMES = {
    "lora_a": ("lora_A.weight", True),
    "lora_b": ("lora_B.weight", True),
    "dora_m": ("lora_magnitude_vector.weight", False),
    "hada_w1_a": ("hada_w1_a", True),
    "hada_w1_b": ("hada_w1_b", True),
    "hada_w2_a": ("hada_w2_a", True),
    "hada_w2_b": ("hada_w2_b", True),
    "lokr_w1": ("lokr_w1", True),
    "lokr_w2_a": ("lokr_w2_a", True),
    "lokr_w2_b": ("lokr_w2_b", True),
    "fft_spectrum": ("fourierft_spectrum", False),
}

# the adapter files hold fp32 tensors only
_DTYPES = {np.dtype("float32"): "F32"}
# what the reader takes; BF16 has no numpy type and is widened to fp32
_NP_DTYPES = {"F32": np.dtype("float32"), "F16": np.dtype("float16"),
              "F64": np.dtype("float64"), "I64": np.dtype("int64"),
              "I32": np.dtype("int32"), "I8": np.dtype("int8"),
              "U8": np.dtype("uint8"), "BOOL": np.dtype("bool")}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def write_safetensors(path: str, tensors: Dict[str, np.ndarray],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (name → array) in the safetensors format."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors "
                            "code here")
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _DTYPES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)          # the data starts 8-byte aligned
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.part"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)
    os.replace(tmp, path)


def _decode(raw: bytearray, code: str, shape) -> np.ndarray:
    if code == "BF16":
        import torch
        if not raw:
            return np.zeros(shape, np.float32)
        return torch.frombuffer(raw, dtype=torch.bfloat16).float().numpy(
            ).reshape(shape)
    if code not in _NP_DTYPES:
        raise TypeError(f"safetensors dtype {code} is not read here")
    dt = _NP_DTYPES[code].newbyteorder("<")
    return np.frombuffer(raw, dtype=dt).reshape(shape).astype(
        dt.newbyteorder("="))


def read_safetensors(path: str) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, str]]:
    """(tensors, metadata) of a safetensors file: F32, F16 and the integer
    types as numpy arrays of their own dtype, BF16 widened to fp32.  Each
    tensor is read on its own, so the file never sits in memory whole."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        meta = header.pop("__metadata__", {}) or {}
        for name, info in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            begin, end = info["data_offsets"]
            raw = bytearray(end - begin)
            f.seek(base + begin)
            if f.readinto(raw) != len(raw):
                raise ValueError(f"{path}: {name} runs past the end of the "
                                 "file")
            out[name] = _decode(raw, info["dtype"], info["shape"])
    return out, meta


def save_adapter_safetensors(path: str, adapters: Dict[str, Any],
                             meta: Optional[Dict[str, Any]] = None) -> None:
    """``adapters``/``meta`` are the nested dicts of
    ``adapters.builder.adapter_tree`` (the JAX package's tree layout)."""
    tensors = {}
    for path_keys, leaf in _flatten(adapters):
        *module, leaf_name = path_keys
        suffix, transpose = _PEFT_NAMES.get(leaf_name, (leaf_name, False))
        arr = np.asarray(leaf, dtype=np.float32)
        if transpose and arr.ndim == 2:
            arr = arr.T          # torch linear layout is [out, in]
        tensors["base_model.model." + ".".join(module) + "." + suffix] = arr
    header = None
    if meta is not None:
        scales = {".".join(p): float(v) for p, v in _flatten(meta)
                  if np.asarray(v).ndim == 0}
        header = {"yat_meta": json.dumps(scales)}
    write_safetensors(path, tensors, header)


def load_adapter_safetensors(path: str, like: Dict[str, Any]
                             ) -> Dict[str, Any]:
    """Adapter weights from ``path`` (a file, or a directory holding
    ``adapter_model.safetensors``) in the structure of ``like`` (the nested
    dicts of ``adapters.builder.adapter_tree``), fp32.

    A copy of the JAX package's reader.  Three namings are accepted: the
    export's (flax paths under ``base_model.model.``), bare flax paths,
    and real PEFT files with torch/diffusers module paths, probed at two
    UNet level counts.  A candidate is taken only when it is present and
    its shape (after the transpose ``_PEFT_NAMES`` names) agrees; a leaf
    with no such candidate raises."""
    from yat_tpu_torch.adapters.peft_paths import (flax_to_diffusers,
                                                   num_levels_from_tree)
    if os.path.isdir(path):
        path = os.path.join(path, "adapter_model.safetensors")
    tensors, _ = read_safetensors(path)

    n_levels = num_levels_from_tree([p for p, _ in _flatten(like)])
    out: Dict[str, Any] = {}
    for path_keys, leaf in _flatten(like):
        *module, leaf_name = path_keys
        suffix, transpose = _PEFT_NAMES.get(leaf_name, (leaf_name, False))
        dotted = ".".join(module)
        candidates = [f"base_model.model.{dotted}.{suffix}",
                      f"{dotted}.{leaf_name}", f"{dotted}.{suffix}"]
        # the tree undercounts UNet levels when the deepest level has no
        # adapted module, which would flip the up-block index
        for nl in (n_levels, n_levels + 1):
            torch_path = flax_to_diffusers(module, nl)
            if torch_path is not None:
                candidates += [f"base_model.model.{torch_path}.{suffix}",
                               f"{torch_path}.{suffix}"]
        want = tuple(np.asarray(leaf).shape)
        arr = mismatch = None
        for c in candidates:
            if c not in tensors:
                continue
            cand = tensors[c]
            if transpose and cand.ndim == 2:
                cand = cand.T
            if tuple(cand.shape) != want:
                mismatch = (c, cand.shape)
                continue
            arr = cand
            break
        if arr is None:
            if mismatch is not None:
                raise ValueError(
                    f"shape mismatch for {dotted}.{leaf_name}: file "
                    f"{mismatch[0]} has {mismatch[1]} vs expected {want} "
                    "(no other candidate matched)")
            raise KeyError(f"adapter file {path} missing weight for "
                           f"{dotted}.{leaf_name}")
        node = out
        for k in path_keys[:-1]:
            node = node.setdefault(k, {})
        node[path_keys[-1]] = np.ascontiguousarray(arr, np.float32)
    return out
