"""Adapter export: safetensors with PEFT-compatible naming.

Counterpart of the export half of ``yat_tpu/adapters/io.py``.  Keys are

    base_model.model.{dotted.flax.module.path}.lora_A.weight   [r, in]
    base_model.model.{dotted.flax.module.path}.lora_B.weight   [out, r]

(the torch layout), and the header's metadata carries the scales as JSON
under ``yat_meta``, as the JAX package writes them; its
``load_adapter_safetensors`` reads the file back.  The safetensors format
is written here directly (an 8-byte little-endian header length, a JSON
header, then the raw little-endian tensors back to back), so the port
needs no ``safetensors`` package.
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
}

# the adapter files hold fp32 tensors only
_DTYPES = {np.dtype("float32"): "F32"}
_NP_DTYPES = {v: k for k, v in _DTYPES.items()}


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


def read_safetensors(path: str) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, str]]:
    """(tensors, metadata) of a safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        body = f.read()
    meta = header.pop("__metadata__", {}) or {}
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dt = _NP_DTYPES[info["dtype"]].newbyteorder("<")
        out[name] = np.frombuffer(body[begin:end], dtype=dt).reshape(
            info["shape"]).astype(dt.newbyteorder("="))
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
