"""WebDataset-format TAR shard reader/writer, dependency-free.

A copy of ``yat_tpu/data/tar.py`` (stdlib and numpy; ``.pt`` fields load
with ``torch``) so the port reads and writes the JAX package's feature
shards without importing it (``ShardWriter`` rolls ``shard-%06d.tar``
files of a fixed sample count, for the feature extractor and the shard
generator):

* samples are groups of files sharing a basename key: ``key.jpg``,
  ``key.txt``, ``key.ratio``, ``key.latent.npy`` ...
* extension decides decoding; multi-dot extensions (``latent.npy``) keep the
  full suffix after the first dot as the field name.

Field decoders: txt/ratio → str, npy → np.ndarray, jpg/jpeg/png/webp → raw
bytes (image decode is the data plane's job, not the reader's), pt → torch
tensor → np.ndarray.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Any, Dict, Iterator, Optional

import numpy as np

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")


def _split_key(name: str):
    """'dir/abc123.latent.npy' → ('abc123', 'latent.npy')."""
    base = os.path.basename(name)
    if "." not in base:
        return base, ""
    key, ext = base.split(".", 1)
    return key, ext.lower()


def decode_field(ext: str, data: bytes) -> Any:
    if ext in ("txt", "ratio", "text", "caption"):
        return data.decode("utf-8")
    if ext == "json":
        return json.loads(data)
    if ext.endswith("npy"):
        return np.load(io.BytesIO(data), allow_pickle=False)
    if ext.endswith("npz"):
        return dict(np.load(io.BytesIO(data), allow_pickle=False))
    if ext.endswith("pt"):
        # feature shards of the reference trainer store torch tensors
        import torch
        t = torch.load(io.BytesIO(data), map_location="cpu",
                       weights_only=True)
        return t.float().numpy() if hasattr(t, "numpy") else t
    # images and unknown types stay raw bytes
    return data


def encode_field(ext: str, value: Any) -> bytes:
    if isinstance(value, bytes):
        return value
    if ext in ("txt", "ratio", "text", "caption"):
        return str(value).encode("utf-8")
    if ext == "json":
        return json.dumps(value).encode("utf-8")
    if ext.endswith("npy"):
        buf = io.BytesIO()
        np.save(buf, np.asarray(value), allow_pickle=False)
        return buf.getvalue()
    raise ValueError(f"cannot encode field of type {type(value)} as .{ext}")


def iter_tar_samples(path_or_fileobj, decode: bool = True,
                     handler: str = "skip") -> Iterator[Dict[str, Any]]:
    """Stream samples from a TAR shard, grouped by key.

    ``handler='skip'`` skips corrupt members; 'raise' propagates.
    """
    if isinstance(path_or_fileobj, (str, os.PathLike)):
        tf = tarfile.open(path_or_fileobj, mode="r|*")
    else:
        tf = tarfile.open(fileobj=path_or_fileobj, mode="r|*")

    current_key: Optional[str] = None
    sample: Dict[str, Any] = {}
    with tf:
        for member in tf:
            if not member.isfile():
                continue
            key, ext = _split_key(member.name)
            if key != current_key:
                if current_key is not None and sample:
                    yield sample
                current_key = key
                sample = {"__key__": key}
            try:
                data = tf.extractfile(member).read()
                sample[ext] = decode_field(ext, data) if decode else data
            except Exception:
                if handler == "raise":
                    raise
                continue
    if current_key is not None and sample:
        yield sample


class TarShardWriter:
    """Write WebDataset-format shards (features_extractor.py:82-89 parity).

    Usage:
        with TarShardWriter('shard-000000.tar') as w:
            w.write({'__key__': '000001', 'ratio': '1.0',
                     'latent.npy': latent, 'emb.npy': emb})
    """

    def __init__(self, path: str):
        self.path = path
        self._tf = tarfile.open(path, mode="w")
        self.count = 0

    def write(self, sample: Dict[str, Any]) -> None:
        key = sample["__key__"]
        for field, value in sample.items():
            if field == "__key__":
                continue
            data = encode_field(field, value)
            info = tarfile.TarInfo(name=f"{key}.{field}")
            info.size = len(data)
            self._tf.addfile(info, io.BytesIO(data))
        self.count += 1

    def close(self):
        self._tf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardWriter:
    """Multi-shard writer: ``pattern % index`` files of at most
    ``maxcount`` samples each; ``on_shard_complete(path, index)`` runs as
    each shard closes (the uploaders hang off it)."""

    def __init__(self, pattern: str, maxcount: int = 10000,
                 on_shard_complete=None):
        self.pattern = pattern
        self.maxcount = maxcount
        self.on_shard_complete = on_shard_complete
        self.shard_index = 0
        self._writer: Optional[TarShardWriter] = None

    def _close_current(self):
        path = self._writer.path
        self._writer.close()
        self._writer = None
        if self.on_shard_complete:
            self.on_shard_complete(path, self.shard_index - 1)

    def _roll(self):
        if self._writer is not None:
            self._close_current()
        path = self.pattern % self.shard_index
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._writer = TarShardWriter(path)
        self.shard_index += 1

    def write(self, sample: Dict[str, Any]) -> None:
        if self._writer is None or self._writer.count >= self.maxcount:
            self._roll()
        self._writer.write(sample)

    def close(self):
        if self._writer is not None:
            self._close_current()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
