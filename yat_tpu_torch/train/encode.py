"""On-the-fly feature encoding: image + caption batches → training batches.

Counterpart of ``yat_tpu/train/encode.py`` (the framework-free parts, so
no JAX): the ``compute_features`` path encodes each bucketed image batch on
the device right before training on it.

* ``OnTheFlyEncodingSampler`` wraps an image sampler with the frontend's
  encoder callables: latents in chunks of ``vae_max_batch_size``, caption
  embeddings in chunks of ``text_encoder_max_batch_size`` (padded to the
  caption-length rung), with ``encode_repa`` the DINOv2 tokens of the
  whole batch (``repa_features``, ``repa_spatial_dims``), with
  ``encode_pooled`` the pooled text of the batch's captions
  (``pooled_text``, SDXL), each encoded
  batch yielded ``repeat`` times (``bucket_repeat`` reuses encoded
  batches, never re-encodes them).
  ``skip_batches`` fast-forwards a resumed run without running an encoder.
* ``FeatureCache`` is the bounded cache of ``cache_size`` (in batches): a
  daemon thread drains the encoding sampler into a queue so decode and
  encode run ahead of the training step; ``save_to_disk`` keeps every
  encoded batch and replays them from disk once the source is exhausted.

The encoders run on the same device and stream as the training step (no
second stream, as the JAX package has no second device for them); the
thread overlaps the host's decode and the launches with the step.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

from yat_tpu_torch.data.sampler import Batch, pad_embeddings


class SkipUnsupported(Exception):
    """Raised by ``skip_batches`` when the wrapped sampler cannot skip
    without encoding; the engine then drains the sampler instead.  A type
    of its own, so a real error inside the skip path propagates instead of
    turning a resume into hours of re-encoding."""


class OnTheFlyEncodingSampler:
    def __init__(
        self,
        image_sampler: Iterable[Batch],
        encode_images: Callable[[np.ndarray], np.ndarray],
        encode_captions: Callable[[List[str]], List[np.ndarray]],
        max_caption_len: int,
        vae_max_batch_size: Optional[int] = None,
        text_encoder_max_batch_size: Optional[int] = None,
        encode_repa: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        encode_pooled: Optional[Callable[[List[str]], np.ndarray]] = None,
        caption_buckets=None,
        repeat: int = 1,
    ):
        self.image_sampler = image_sampler
        self.encode_images = encode_images
        self.encode_captions = encode_captions
        self.max_caption_len = max_caption_len
        self.vae_bs = vae_max_batch_size
        self.te_bs = text_encoder_max_batch_size
        self.encode_repa = encode_repa
        self.encode_pooled = encode_pooled
        self.caption_buckets = caption_buckets
        self.repeat = max(1, int(repeat))
        self._resume_iter = None       # set by skip_batches
        self._resume_partial = 0

    def _encode_batch(self, batch: Batch) -> Batch:
        images, captions = batch.images, batch.captions
        vb = self.vae_bs or len(images)
        latents = np.concatenate([
            np.asarray(self.encode_images(images[i:i + vb]))
            for i in range(0, len(images), vb)])
        tb = self.te_bs or len(captions)
        embs: List[np.ndarray] = []
        for i in range(0, len(captions), tb):
            embs.extend(self.encode_captions(captions[i:i + tb]))
        padded, mask = pad_embeddings(embs, self.max_caption_len,
                                      length_buckets=self.caption_buckets)
        out = Batch(ratio=batch.ratio, latents=latents, embeddings=padded,
                    text_mask=mask,
                    is_regularization=batch.is_regularization)
        if self.encode_repa is not None:
            # the whole batch at once, as the JAX package encodes it
            out.repa_features = np.asarray(self.encode_repa(images))
            out.repa_spatial_dims = getattr(self.encode_repa, "grid_hw",
                                            (16, 16))
        if self.encode_pooled is not None:
            out.pooled_text = np.asarray(self.encode_pooled(captions),
                                         np.float32)
        return out

    def skip_batches(self, n: int) -> None:
        """Advance the image stream past the ``n`` encoded batches a
        previous run consumed, without encoding.  Encoded batches are the
        image batches times ``repeat``; a skip that ends inside a batch's
        repeats encodes that batch once and yields only the repeats left.
        A finite stream that ends during the skip starts over; one that
        yields nothing in a whole pass raises."""
        it = self._resume_iter
        if it is None:
            it = iter(self.image_sampler)
        k, r = divmod(int(n), self.repeat)
        skipped = 0
        yielded_this_pass = False
        while skipped < k:
            try:
                next(it)
                skipped += 1
                yielded_this_pass = True
            except StopIteration:
                if not yielded_this_pass:
                    raise RuntimeError(
                        f"image stream yielded no batches while skipping "
                        f"{n} already-consumed batches ({skipped} skipped) "
                        "— empty or mis-keyed dataset (disable "
                        "resume_data_fastforward to start the stream "
                        "over)") from None
                it = iter(self.image_sampler)
                yielded_this_pass = False
        self._resume_iter = it
        self._resume_partial = r

    def __iter__(self) -> Iterator[Batch]:
        it = self._resume_iter
        partial = self._resume_partial
        self._resume_iter = None
        self._resume_partial = 0
        if it is None:
            it = iter(self.image_sampler)
        for batch in it:
            encoded = self._encode_batch(batch)
            for _ in range(self.repeat - partial):
                yield encoded
            partial = 0
        if partial:
            # the skip ended on the stream's last batch with repeats left:
            # the next pass's first batch gives them up instead
            self._resume_partial = partial

    def stop(self):
        stop = getattr(self.image_sampler, "stop", None)
        if stop is not None:
            stop()


class FeatureCache:
    """Bounded producer/consumer cache of encoded batches: a daemon thread
    drains the encoding sampler into a queue of up to ``cache_size``
    batches, and iteration pops from it.  A failure in the thread reaches
    the consumer as a RuntimeError; ``stop`` ends the thread and waits for
    it (it finishes the batch it is encoding; a downloading shard source
    stops with it), and a consumer waiting on the queue returns.  A
    finite source ends an
    iteration when it ends; the next iteration starts a new pass (or,
    under ``save_to_disk``, replays the saved batches from
    ``cache_dir``)."""

    _END = object()
    _FIELDS = ("latents", "embeddings", "text_mask", "pooled_text",
               "repa_features")

    def __init__(self, encoded_sampler: Iterable[Batch],
                 cache_size: int = 1000, save_to_disk: bool = False,
                 cache_dir: str = "cache"):
        self.sampler = encoded_sampler
        self.q: "queue.Queue[object]" = queue.Queue(maxsize=max(1, cache_size))
        self._started = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.save_to_disk = save_to_disk
        self.cache_dir = cache_dir
        self._disk_count = 0
        self._disk_complete = False

    def _disk_path(self, i: int) -> str:
        return os.path.join(self.cache_dir, f"batch_{i:06d}.npz")

    def _save_batch(self, batch: Batch) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        arrays = {"ratio": np.asarray(str(batch.ratio)),
                  "is_regularization": np.asarray(batch.is_regularization)}
        for f in self._FIELDS:
            v = getattr(batch, f)
            if v is not None:
                arrays[f] = np.asarray(v)
        if batch.repa_spatial_dims is not None:
            arrays["repa_spatial_dims"] = np.asarray(batch.repa_spatial_dims)
        np.savez(self._disk_path(self._disk_count), **arrays)
        self._disk_count += 1

    def _replay(self) -> Iterator[Batch]:
        for i in range(self._disk_count):
            with np.load(self._disk_path(i), allow_pickle=False) as z:
                fields = {f: z[f] for f in self._FIELDS if f in z.files}
                if "repa_spatial_dims" in z.files:
                    fields["repa_spatial_dims"] = tuple(
                        int(x) for x in z["repa_spatial_dims"])
                yield Batch(ratio=str(z["ratio"]),
                            is_regularization=bool(z["is_regularization"]),
                            **fields)

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``stop`` comes first."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self.sampler:
                if self._stop.is_set():
                    return
                if self.save_to_disk:
                    self._save_batch(batch)
                if not self._put(batch):
                    return
            if self._stop.is_set():
                return
            self._disk_complete = self.save_to_disk
            self._put(self._END)
        except Exception as e:  # noqa: BLE001 — re-raised by the consumer
            self._put(e)

    def skip_batches(self, n: int) -> None:
        """The encode-free resume skip of the encoding sampler; before
        iteration starts only (the thread consumes the stream)."""
        if self._started:
            raise RuntimeError("skip_batches must be called before "
                               "iteration starts")
        skip = getattr(self.sampler, "skip_batches", None)
        if skip is None:
            raise SkipUnsupported("underlying sampler has no skip_batches")
        skip(n)

    def stop(self):
        self._stop.set()
        stop = getattr(self.sampler, "stop", None)
        if stop is not None:
            stop()
        if self._thread is not None:
            self._thread.join()

    def __iter__(self) -> Iterator[Batch]:
        if self._disk_complete:
            yield from self._replay()
            return
        if not self._started:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
            self._started = True
        while not self._stop.is_set():
            try:
                item = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is self._END:
                self._started = False
                return
            if isinstance(item, Exception):
                raise RuntimeError("encoding worker failed") from item
            yield item
