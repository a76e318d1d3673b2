"""The feature-shard data plane: shard source, bucket sampler, captions.

Copies of ``Batch``, ``LocalShardSource``, ``FeatureBucketSampler``,
``caption_length_buckets``, ``caption_rung`` and ``pad_embeddings`` from
``yat_tpu/data/sampler.py`` (stdlib and numpy only), so the port yields
the same batches, in the same order, as the JAX package from the same
shards and seed, without importing it.  Single process: the multi-host
bucket sync hook, the URL/R2 sources and the raw-image samplers are not
ported (ROADMAP queue 1, items 8 and 12).
"""

from __future__ import annotations

import dataclasses
import os
import random
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from yat_tpu_torch.data.tar import IMAGE_EXTS, iter_tar_samples


@dataclasses.dataclass
class Batch:
    """One bucket batch of pre-extracted features (host numpy arrays)."""

    ratio: str
    latents: Optional[np.ndarray] = None          # [B, H, W, C]
    embeddings: Optional[np.ndarray] = None       # [B, L, D]
    text_mask: Optional[np.ndarray] = None        # [B, L]
    pooled_text: Optional[np.ndarray] = None      # [B, D_pool]
    is_regularization: bool = False


class LocalShardSource:
    """Cycle over local TAR paths, shuffled per pass from a seed.  Optional
    ``probs`` weight the draw per path."""

    def __init__(self, paths: Sequence[str], seed: int = 0,
                 probs: Optional[Sequence[float]] = None):
        if not paths:
            raise ValueError("no shard paths given")
        self.paths = list(paths)
        self.rng = random.Random(seed)
        self.probs = list(probs) if probs else None
        if self.probs and len(self.probs) != len(self.paths):
            raise ValueError("probs must match paths length")

    def __iter__(self) -> Iterator[str]:
        if self.probs:
            while True:
                p = self.rng.choices(self.paths, weights=self.probs, k=1)[0]
                if os.path.exists(p):
                    yield p
            return
        while True:
            order = list(self.paths)
            self.rng.shuffle(order)
            for p in order:
                if os.path.exists(p):
                    yield p


def caption_length_buckets(max_len: int, step: int = 128) -> Tuple[int, ...]:
    """Static caption-length ladder: multiples of ``step`` up to max_len.
    Padding to the smallest rung >= the batch's real max skips dead caption
    tokens while keeping few distinct shapes."""
    if max_len <= step:
        return (max_len,)
    return tuple(range(step, max_len, step)) + (max_len,)


def caption_rung(real: int, budget: int, multiple: int = 64) -> int:
    """Smallest ``multiple``-token rung covering ``real`` tokens, capped at
    the padded ``budget`` (shared by the token slicer and the embedding
    fetch so the two never disagree)."""
    return min(budget, max(multiple, -(-int(real) // multiple) * multiple))


def pad_embeddings(embs: Sequence[np.ndarray], max_len: int,
                   dtype=np.float32,
                   length_buckets: Optional[Sequence[int]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Variable-length [L_i, D] embeddings → ([B, L_pad, D], [B, L_pad])
    mask; with ``length_buckets`` L_pad is the smallest rung covering the
    batch."""
    b = len(embs)
    cleaned = []
    for e in embs:
        e = np.asarray(e)
        if e.ndim == 3:   # [1, L, D] squeeze
            e = e[0]
        cleaned.append(e)
    pad_to = max_len
    if length_buckets:
        real_max = min(max(e.shape[0] for e in cleaned), max_len)
        pad_to = next((r for r in sorted(length_buckets) if r >= real_max),
                      max_len)
    d = cleaned[0].shape[-1]
    out = np.zeros((b, pad_to, d), dtype=dtype)
    mask = np.zeros((b, pad_to), dtype=np.int32)
    for i, e in enumerate(cleaned):
        n = min(e.shape[0], pad_to)
        out[i, :n] = e[:n]
        mask[i, :n] = 1
    return out, mask


def _chw_to_hwc(x: np.ndarray, from_torch: bool) -> np.ndarray:
    """``.pt`` latents are [C, H, W]; ``.npy`` shards are already
    [H, W, C].  The field extension says which."""
    if from_torch and x.ndim == 3:
        return np.transpose(x, (1, 2, 0))
    return x


class FeatureBucketSampler:
    """Pre-extracted feature shards → batches of one aspect bucket.

    Each sample carries its bucket key in the ``ratio`` field.  Samples go
    through a bounded shuffle buffer into per-key buckets, and buckets drain
    in sorted key order the moment one holds ``batch_size`` items; partial
    buckets carry over to the next pass.  Each drained batch is yielded
    ``bucket_repeat`` times."""

    def __init__(self, shard_source, batch_size: int, max_caption_len: int,
                 shuffle_buffer: int = 1000, seed: int = 0,
                 latent_dtype=np.float32,
                 caption_buckets: Optional[Sequence[int]] = None,
                 bucket_repeat: int = 1):
        self.source = shard_source
        self.batch_size = batch_size
        self.max_caption_len = max_caption_len
        self.buckets: Dict[str, deque] = {}
        self.shuffle_buffer = shuffle_buffer
        self.rng = random.Random(seed)
        self.latent_dtype = latent_dtype
        self.caption_buckets = caption_buckets
        self.bucket_repeat = max(1, int(bucket_repeat))
        self._raw_image_drops = 0
        self._ingested_any = False

    def _emit(self, key: str) -> Batch:
        items = [self.buckets[key].popleft() for _ in range(self.batch_size)]
        latents = np.stack([
            _chw_to_hwc(np.asarray(lat, self.latent_dtype), from_torch=pt)
            for lat, _, _, pt in items])
        embs, mask = pad_embeddings([e for _, e, _, _ in items],
                                    self.max_caption_len,
                                    length_buckets=self.caption_buckets)
        pooled = None
        have_pooled = [p is not None for _, _, p, _ in items]
        if any(have_pooled):
            if not all(have_pooled):
                raise ValueError(
                    f"bucket {key!r} mixes samples with and without "
                    "pooled.npy — re-extract the shards with one "
                    "consistent encoder pipeline")
            pooled = np.stack([np.asarray(p, np.float32).reshape(-1)
                               for _, _, p, _ in items])
        return Batch(ratio=key, latents=latents, embeddings=embs,
                     text_mask=mask, pooled_text=pooled)

    def __iter__(self) -> Iterator[Batch]:
        buf: List[Tuple[str, Any, Any, Any, bool]] = []
        for shard_path in self.source:
            for elem in iter_tar_samples(shard_path):
                from_pt = "latent.pt" in elem
                latent = elem.get("latent.npy", elem.get("latent.pt"))
                emb = elem.get("emb.npy", elem.get("emb.pt"))
                pooled = elem.get("pooled.npy", elem.get("pooled.pt"))
                if "ratio" not in elem or latent is None or emb is None:
                    # raw-image shards on the feature path would starve the
                    # run sample by sample: fail loudly instead
                    if any(e in elem for e in IMAGE_EXTS):
                        self._raw_image_drops += 1
                        if (self._raw_image_drops >= 64
                                and not self._ingested_any):
                            raise ValueError(
                                f"shard {shard_path} contains raw image "
                                "samples but this run is on the "
                                "pre-extracted-feature path — every sample "
                                "would be dropped and the run would starve; "
                                "point at {ratio, latent, emb} feature "
                                "shards")
                    continue
                self._ingested_any = True
                buf.append((str(elem["ratio"]), latent, emb, pooled, from_pt))
                if len(buf) < self.shuffle_buffer:
                    continue
                idx = self.rng.randrange(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield from self._ingest(*buf.pop())
        while buf:
            yield from self._ingest(*buf.pop())
        leftover = {k: len(v) for k, v in self.buckets.items() if v}
        if leftover:
            n = sum(leftover.values())
            print(f"[sampler] source exhausted; holding {n} samples in "
                  f"partial buckets {leftover} for the next pass")

    def _ingest(self, key: str, latent, emb, pooled=None,
                from_pt: bool = False) -> Iterator[Batch]:
        self.buckets.setdefault(key, deque()).append(
            (latent, emb, pooled, from_pt))
        ready = sorted(k for k, v in self.buckets.items()
                       if len(v) >= self.batch_size)
        for k in ready:
            batch = self._emit(k)
            for _ in range(self.bucket_repeat):
                yield batch

    def stop(self):
        stop = getattr(self.source, "stop", None)
        if stop is not None:
            stop()
