"""The data plane: shard sources, bucket samplers, captions.

Copies of ``yat_tpu/data/sampler.py`` (stdlib and numpy only), so the port
yields the same batches, in the same order, as the JAX package from the
same shards and seed, without importing it:

* shard sources: ``LocalShardSource`` (local TARs, shuffled per pass),
  ``UrlShardSource`` (plain or presigned URLs) and ``RemoteShardSource``
  (R2 presigned GETs), the last two downloading ahead on a thread;
* ``FeatureBucketSampler``: pre-extracted ``{ratio, latent, emb}`` shards;
* ``ImageBucketSampler``: raw ``{jpg, txt}`` shards bucketed by aspect
  ratio, uint8 pixels at the bucket's size (JPEGs bucketed from their
  header and decoded at emit by the native decoder when it is available,
  else cv2 per image; ``decoder`` says which);
* ``DreamboothSampler``: instance and regularization passes in turn;
* the caption padding helpers.

Across processes ``FeatureBucketSampler`` takes the JAX sampler's
``sync_hook`` (``parallel.multihost.WindowedBucketSync``), and the remote
sources take the process index.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import random
import threading
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from yat_tpu_torch.data.bins import find_closest_ratio
from yat_tpu_torch.data.tar import IMAGE_EXTS, iter_tar_samples


@dataclasses.dataclass
class Batch:
    """One bucket batch (host numpy arrays): features, or raw pixels and
    captions before the encoders."""

    ratio: str
    latents: Optional[np.ndarray] = None          # [B, H, W, C]
    images: Optional[np.ndarray] = None           # [B, H, W, 3] uint8
    captions: Optional[List[str]] = None
    embeddings: Optional[np.ndarray] = None       # [B, L, D]
    text_mask: Optional[np.ndarray] = None        # [B, L]
    pooled_text: Optional[np.ndarray] = None      # [B, D_pool]
    repa_features: Optional[np.ndarray] = None    # [B, 256, 768]
    repa_spatial_dims: Optional[Tuple[int, int]] = None
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



class _DownloadingSource:
    """Shards downloaded ahead by a daemon thread into ``local_temp_dir``
    through a queue of ``queue_depth`` paths; each path is removed once the
    consumer moves past it.  After 20 failed downloads in a row the
    consumer gets a RuntimeError instead of waiting forever.  ``one_pass``
    walks the shard list once, in order, and then ends (the extraction
    pass); otherwise shards are drawn at random forever.  ``stop`` ends
    both sides within 0.2 s: the thread downloads no further shard and the
    consumer's iteration ends, whether or not a shard is on its way (the
    feature cache joins its thread through here)."""

    _MAX_CONSECUTIVE_FAILURES = 20
    _END = object()
    _prefix = "shard"

    def __init__(self, names: Sequence[str], seed: int,
                 probs: Optional[Sequence[float]], local_temp_dir: str,
                 queue_depth: int, process_index: int, one_pass: bool):
        self.names = list(names)
        self.probs = list(probs) if probs else None
        self.rng = random.Random(seed + process_index)
        self.temp = local_temp_dir
        self.q: "queue.Queue[object]" = queue.Queue(maxsize=queue_depth)
        self.process_index = process_index
        self.one_pass = one_pass
        self._started = False
        self._stop = threading.Event()

    def _pick(self) -> str:
        if self.probs:
            return self.rng.choices(self.names, weights=self.probs, k=1)[0]
        return self.names[self.rng.randrange(len(self.names))]

    def _url(self, name: str) -> str:
        raise NotImplementedError

    def _worker(self):
        from yat_tpu_torch.data.r2 import download_tar
        os.makedirs(self.temp, exist_ok=True)
        order = iter(self.names) if self.one_pass else None
        item = failures = 0
        while not self._stop.is_set():
            name = next(order, None) if order is not None else self._pick()
            if name is None:
                self._put(self._END)
                return
            path = os.path.join(
                self.temp, f"{self._prefix}_{self.process_index}_{item}.tar")
            try:
                download_tar(self._url(name), path)
            except Exception as e:  # noqa: BLE001 — skip to the next shard
                print(f"[sampler] shard download failed, skipping: {e}")
                failures += 1
                if failures >= self._MAX_CONSECUTIVE_FAILURES:
                    self._put(RuntimeError(
                        f"{failures} consecutive shard download failures "
                        f"(last: {e}) — the urls or the R2 credentials, "
                        "endpoint, bucket or shard list are wrong or "
                        "expired"))
                    return
                continue
            failures = 0
            if not self._put(path):
                os.remove(path)
                return
            item += 1

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``stop`` comes first."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[str]:
        if not self._started:
            threading.Thread(target=self._worker, daemon=True).start()
            self._started = True
        while not self._stop.is_set():
            try:
                path = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            if path is self._END:
                return
            if isinstance(path, Exception):
                raise path
            yield path
            if os.path.exists(path):
                os.remove(path)

    def stop(self):
        self._stop.set()


class UrlShardSource(_DownloadingSource):
    """Shards streamed from plain (public or presigned) URLs, drawn at
    random (weighted by ``probs``)."""

    _prefix = "urlshard"

    def __init__(self, urls: Sequence[str], seed: int = 0,
                 probs: Optional[Sequence[float]] = None,
                 local_temp_dir: str = "temp", queue_depth: int = 4,
                 process_index: int = 0, one_pass: bool = False):
        if not urls:
            raise ValueError("no urls given")
        super().__init__(urls, seed, probs, local_temp_dir, queue_depth,
                         process_index, one_pass)
        self.urls = self.names

    def _url(self, name: str) -> str:
        return name


class RemoteShardSource(_DownloadingSource):
    """Shards of an R2 bucket (``features_path/name``), each fetched
    through a presigned GET."""

    def __init__(self, shards: Sequence[str], features_path: str,
                 r2_access_key: str, r2_secret_key: str, r2_endpoint: str,
                 r2_bucket_name: str, seed: int = 0,
                 local_temp_dir: str = "temp", queue_depth: int = 4,
                 process_index: int = 0, one_pass: bool = False):
        from yat_tpu_torch.data.r2 import R2Client
        super().__init__(shards, seed, None, local_temp_dir, queue_depth,
                         process_index, one_pass)
        self.shards = self.names
        self.features_path = features_path
        self.client = R2Client(r2_access_key, r2_secret_key, r2_endpoint)
        self.bucket = r2_bucket_name

    def _url(self, name: str) -> str:
        key = f"{self.features_path}/{name}" if self.features_path else name
        return self.client.presign_get(self.bucket, key)


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


def bucket_key(ratio: str, rung: Optional[int] = None) -> str:
    """The lockstep key of an aspect bucket, and of its caption rung under
    caption-length bucketing (``"1.0"``, ``"1.0|256"``)."""
    return ratio if rung is None else f"{ratio}|{rung}"


class FeatureBucketSampler:
    """Pre-extracted feature shards → batches of one aspect bucket.

    Each sample carries its bucket key in the ``ratio`` field.  Samples go
    through a bounded shuffle buffer into per-key buckets, and buckets drain
    in sorted key order the moment one holds ``batch_size`` items; partial
    buckets carry over to the next pass.  Each drained batch is yielded
    ``bucket_repeat`` times.

    ``sync_hook`` (across processes, ``WindowedBucketSync``) is called with
    the bucket counts once per ingested sample; a bucket drains only when
    the hook's ``min_counts`` (the minimum over the processes) reach
    ``batch_size``, keys outside the hook's canonical ``keys`` are held
    (with a warning printed once), and the hook's ``on_drain`` follows each
    emit, so every process emits the same sequence of buckets.  With a
    hook and ``caption_buckets`` a sample's key also holds its caption rung
    (:func:`bucket_key`; the smallest rung covering its caption), so a
    batch's caption length is the same on every process; the JAX sampler
    keys on the aspect bucket alone there, and its processes can pad one
    batch to different lengths."""

    def __init__(self, shard_source, batch_size: int, max_caption_len: int,
                 shuffle_buffer: int = 1000, seed: int = 0,
                 latent_dtype=np.float32,
                 caption_buckets: Optional[Sequence[int]] = None,
                 bucket_repeat: int = 1, sync_hook=None):
        self.source = shard_source
        self.batch_size = batch_size
        self.max_caption_len = max_caption_len
        self.buckets: Dict[str, deque] = {}
        self.shuffle_buffer = shuffle_buffer
        self.rng = random.Random(seed)
        self.latent_dtype = latent_dtype
        self.caption_buckets = caption_buckets
        self.bucket_repeat = max(1, int(bucket_repeat))
        self.sync_hook = sync_hook
        self._warned_keys: set = set()
        self._raw_image_drops = 0
        self._ingested_any = False

    def _key(self, ratio: str, emb) -> str:
        if self.sync_hook is None or not self.caption_buckets:
            return ratio
        e = np.asarray(emb)
        n = min(e.shape[-2], self.max_caption_len)
        rung = next((r for r in sorted(self.caption_buckets) if r >= n),
                    self.max_caption_len)
        return bucket_key(ratio, rung)

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
        return Batch(ratio=key.split("|")[0], latents=latents,
                     embeddings=embs, text_mask=mask, pooled_text=pooled)

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
                                "would be dropped and the run would starve. "
                                "Set 'compute_features' (with "
                                "vae_max_batch_size/"
                                "text_encoder_max_batch_size) to encode "
                                "raw {jpg, txt} shards on the fly, or "
                                "point at {ratio, latent, emb} feature "
                                "shards")
                    continue
                self._ingested_any = True
                buf.append((self._key(str(elem["ratio"]), emb), latent, emb,
                            pooled, from_pt))
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
        hook = self.sync_hook
        if hook is not None:
            hook({k: len(v) for k, v in self.buckets.items()})
        ready = sorted(k for k, v in self.buckets.items()
                       if len(v) >= self.batch_size)
        if hook is not None and ready and hook.min_counts:
            kept = []
            for k in ready:
                if k not in hook.keys:
                    if k not in self._warned_keys:
                        self._warned_keys.add(k)
                        print(f"[sampler] bucket key {k!r} is not in the "
                              "canonical sync table — holding it (shard "
                              "ratio keys vs bin table mismatch?)")
                    continue
                if hook.min_counts.get(k, 0) >= self.batch_size:
                    kept.append(k)
            ready = kept
        for k in ready:
            batch = self._emit(k)
            if hook is not None:
                hook.on_drain(k, self.batch_size)
            for _ in range(self.bucket_repeat):
                yield batch

    def stop(self):
        stop = getattr(self.source, "stop", None)
        if stop is not None:
            stop()


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """JPEG/PNG/WebP bytes → RGB uint8 HWC through cv2, or None."""
    import cv2
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def resize_u8(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """cv2 resize to ``(th, tw)``: area filter when shrinking the height,
    bilinear otherwise; stays uint8 (the encoders normalise on the
    device)."""
    import cv2
    interp = cv2.INTER_AREA if img.shape[0] > th else cv2.INTER_LINEAR
    return cv2.resize(img, (int(tw), int(th)), interpolation=interp)


class ImageBucketSampler:
    """Raw ``{jpg/jpeg/png/webp, txt}`` shards → uint8 NHWC batches at one
    aspect bucket's size, with their captions.

    JPEGs are bucketed from their header alone and decoded and resized at
    emit, in one pass across a thread pool, by the native decoder when it
    is available (``decoder == "native"``); other images, and every image
    without it, decode through cv2 at ingest (``decoder == "cv2"``).  A
    sample whose deferred decode fails is replaced by another sample of its
    batch, never zero-filled (black pixels under a real caption) and never
    dropped (every batch keeps ``batch_size``); a batch with no decodable
    image is dropped.  Samples pass a bounded shuffle of
    ``shuffle_buffer``; buckets drain in sorted key order the moment one
    holds ``batch_size``.  (The JAX sampler's ``bucket_repeat`` is left
    out: the port repeats after the encode, ``OnTheFlyEncodingSampler``.)"""

    def __init__(self, shard_source, batch_size: int,
                 aspect_ratios: Dict[str, Tuple[int, int]],
                 seed: int = 0, shuffle_buffer: int = 256,
                 use_native: bool = True):
        self.source = shard_source
        self.batch_size = batch_size
        self.aspect_ratios = aspect_ratios
        self.buckets: Dict[str, deque] = {}
        self.rng = random.Random(seed)
        self.shuffle_buffer = shuffle_buffer
        self.native = None
        if use_native:
            from yat_tpu_torch.data import native as _native
            self.native = _native if _native.available() else None

    @property
    def decoder(self) -> str:
        """``"native"`` (libjpeg through ``native/decode.cpp``) or
        ``"cv2"``."""
        return "native" if self.native is not None else "cv2"

    def _emit(self, key: str) -> Optional[Batch]:
        items = [self.buckets[key].popleft() for _ in range(self.batch_size)]
        th, tw = (int(d) for d in self.aspect_ratios[key])
        raw = [im for im, _ in items]
        captions = [c for _, c in items]
        bad: list = []
        if self.native is not None and all(isinstance(r, bytes) for r in raw):
            images, status = self.native.decode_batch(raw, th, tw)
            for i in np.nonzero(status != 0)[0]:
                img = decode_image(raw[int(i)])
                if img is not None:
                    images[int(i)] = resize_u8(img, th, tw)
                else:
                    bad.append(int(i))
        else:
            decoded = [r if not isinstance(r, bytes) else decode_image(r)
                       for r in raw]
            bad = [i for i, im in enumerate(decoded) if im is None]
            images = np.stack([
                resize_u8(im, th, tw) if im is not None
                else np.zeros((th, tw, 3), np.uint8) for im in decoded])
        if bad:
            good = [i for i in range(len(raw)) if i not in set(bad)]
            if not good:
                print(f"[sampler] dropping bucket batch {key}: every "
                      "image failed to decode")
                return None
            for j, b in enumerate(bad):
                g = good[j % len(good)]
                images[b] = images[g]
                captions[b] = captions[g]
        return Batch(ratio=key, images=images, captions=captions)

    def _bucket_and_emit(self, payload, ratio, caption) -> Iterator[Batch]:
        key = find_closest_ratio(ratio, self.aspect_ratios)
        self.buckets.setdefault(key, deque()).append((payload, caption))
        for k in sorted(k for k, v in self.buckets.items()
                        if len(v) >= self.batch_size):
            batch = self._emit(k)
            if batch is not None:
                yield batch

    def __iter__(self) -> Iterator[Batch]:
        buf: list = []
        for shard_path in self.source:
            for elem in iter_tar_samples(shard_path):
                img_bytes = next((elem[e] for e in IMAGE_EXTS if e in elem),
                                 None)
                caption = elem.get("txt")
                if img_bytes is None or caption is None:
                    continue
                item = None
                if self.native is not None and ("jpg" in elem
                                                or "jpeg" in elem):
                    dims = self.native.jpeg_dims(img_bytes)
                    if dims is not None:
                        h, w = dims
                        item = (img_bytes, h / w)   # decode at emit
                if item is None:
                    img = decode_image(img_bytes)
                    if img is None:
                        continue
                    item = (img, img.shape[0] / img.shape[1])
                payload, ratio = item
                buf.append((payload, ratio, caption))
                if len(buf) < self.shuffle_buffer:
                    continue
                idx = self.rng.randrange(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield from self._bucket_and_emit(*buf.pop())
        while buf:
            idx = self.rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield from self._bucket_and_emit(*buf.pop())

    def stop(self):
        stop = getattr(self.source, "stop", None)
        if stop is not None:
            stop()


class DreamboothSampler(ImageBucketSampler):
    """Instance-folder passes (``num_repeats`` of them) in turn with
    ``num_regularisation_passes`` regularization passes (over
    ``reg_shard_source`` shards when given, else the regularization
    folder), forever; buckets are cleared between the two.  Instance images
    caption as ``"<instance> <class>"``, regularization images as
    ``"<class>"``, unless an image carries its own ``.txt``; the
    regularization batches carry ``is_regularization`` (the loss scales
    them by ``dreambooth_lambda``).  Images decode through cv2."""

    def __init__(self, instance_folder: str,
                 regularization_folder: Optional[str],
                 instance: str, class_name: str, num_repeats: int,
                 batch_size: int, aspect_ratios: Dict[str, Tuple[int, int]],
                 num_regularisation_passes: int = 1, seed: int = 0,
                 reg_shard_source=None):
        super().__init__(shard_source=None, batch_size=batch_size,
                         aspect_ratios=aspect_ratios, seed=seed,
                         use_native=False)
        self.instance_folder = instance_folder
        self.regularization_folder = regularization_folder
        self.instance = instance
        self.class_name = class_name
        self.num_repeats = num_repeats
        self.num_reg_passes = num_regularisation_passes
        self._reg_source_raw = reg_shard_source
        self.reg_shard_source = (iter(reg_shard_source)
                                 if reg_shard_source else None)

    def stop(self):
        stop = getattr(self._reg_source_raw, "stop", None)
        if stop is not None:
            stop()

    def _iter_folder(self, folder: str
                     ) -> Iterator[Tuple[np.ndarray, Optional[str]]]:
        names = sorted(os.listdir(folder))
        self.rng.shuffle(names)
        for name in names:
            if not name.lower().endswith((".jpg", ".jpeg", ".png", ".webp")):
                continue
            with open(os.path.join(folder, name), "rb") as f:
                img = decode_image(f.read())
            if img is None:
                continue
            cap_path = os.path.splitext(os.path.join(folder, name))[0] + ".txt"
            caption = None
            if os.path.exists(cap_path):
                with open(cap_path) as f:
                    caption = f.read().strip()
            yield img, caption

    def _drain(self, is_reg: bool) -> Iterator[Batch]:
        for k in sorted(k for k, v in self.buckets.items()
                        if len(v) >= self.batch_size):
            b = self._emit(k)
            if b is None:
                continue
            b.is_regularization = is_reg
            yield b

    def _ingest_image(self, img, caption, default_caption):
        key = find_closest_ratio(img.shape[0] / img.shape[1],
                                 self.aspect_ratios)
        self.buckets.setdefault(key, deque()).append(
            (img, caption or default_caption))

    def _next_reg_shard(self) -> Optional[str]:
        """The next regularization shard; a finite source starts over."""
        try:
            return next(self.reg_shard_source)
        except StopIteration:
            self.reg_shard_source = iter(self._reg_source_raw)
        try:
            return next(self.reg_shard_source)
        except StopIteration:
            print("[dreambooth] regularization shard source is empty; "
                  "skipping reg pass")
            return None

    def __iter__(self) -> Iterator[Batch]:
        instance_caption = f"{self.instance} {self.class_name}"
        while True:
            for _ in range(self.num_repeats):
                for img, cap in self._iter_folder(self.instance_folder):
                    self._ingest_image(img, cap, instance_caption)
                    yield from self._drain(False)
            self.buckets.clear()
            for _ in range(self.num_reg_passes):
                if self.reg_shard_source is not None:
                    shard = self._next_reg_shard()
                    if shard is None:
                        continue
                    for elem in iter_tar_samples(shard):
                        data = next((elem[e] for e in IMAGE_EXTS
                                     if e in elem), None)
                        if data is None:
                            continue
                        img = decode_image(data)
                        if img is None:
                            continue
                        self._ingest_image(img, elem.get("txt"),
                                           self.class_name)
                        yield from self._drain(True)
                elif self.regularization_folder:
                    for img, cap in self._iter_folder(
                            self.regularization_folder):
                        self._ingest_image(img, cap, self.class_name)
                        yield from self._drain(True)
            self.buckets.clear()
