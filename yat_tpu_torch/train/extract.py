"""The feature-extraction pass: raw image shards → ``{ratio, latent, emb}``
feature shards (with ``pooled`` where the family encodes pooled text),
written locally and uploaded to R2.

Counterpart of ``yat_tpu/train/extract.py``.  ``FeatureExtractor`` reads
bucketed image batches from a thread two batches ahead (host decode
overlaps the device), launches every VAE and caption-encoder chunk of a
batch through the encoders' ``.dispatch`` hooks (up to 3 batches in
flight on the device's stream; the host waits only when it copies a
batch's results back), writes the samples through ``ShardWriter`` as
``shard-%06d.tar`` (``shard-p{rank}-%06d.tar`` across processes, so
that the processes' uploads never collide), and uploads each finished shard on a pool of 2
threads with at most 4 uploads pending (a shard uploaded is removed
locally).  It
keeps the wall seconds of each phase (``phase_ms``: ``decode`` on the
reading thread, ``host_wait`` for it, ``dispatch``, ``device_wait``,
``write``) and the images per second.

``run_feature_extraction`` is the CLI's ``extract_features`` path: one pass
over the raw shard source (local paths, urls or R2, each shard once, in
the configured order), the trainer's encoders, presigned-PUT uploads to
``r2_upload_key`` when R2 is configured.  The JAX package's pass over
local paths cycles them forever; the port's ends after one pass.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional

import numpy as np

from yat_tpu_torch.data.sampler import Batch
from yat_tpu_torch.data.tar import ShardWriter
from yat_tpu_torch.parallel.multihost import (data_count, data_index,
                                              data_peer_rank)


class FeatureExtractor:
    PIPELINE_DEPTH = 3           # batches of encodes in flight
    MAX_PENDING_UPLOADS = 4
    SHARD_PATTERN = "shard-%06d.tar"

    def __init__(
        self,
        sampler: Iterable[Batch],
        encode_images: Callable[[np.ndarray], np.ndarray],
        encode_captions: Callable[[List[str]], List[np.ndarray]],
        output_dir: str = "features",
        shard_size: int = 1000,
        vae_max_batch_size: Optional[int] = None,
        text_encoder_max_batch_size: Optional[int] = None,
        upload_url_fn: Optional[Callable[[str, int], str]] = None,
        encode_pooled: Optional[Callable[[List[str]], np.ndarray]] = None,
    ):
        self.sampler = sampler
        # SDXL's pooled text: without it the shards would train on zeroed
        # pooled vectors
        self.encode_pooled = encode_pooled
        self.encode_images = encode_images
        self.encode_captions = encode_captions
        self.output_dir = output_dir
        self.shard_size = shard_size
        self.vae_bs = vae_max_batch_size
        self.te_bs = text_encoder_max_batch_size
        self.upload_url_fn = upload_url_fn
        self._pending = 0
        self._lock = threading.Condition()
        self._pool = (ThreadPoolExecutor(max_workers=2) if upload_url_fn
                      else None)
        self.uploaded: List[str] = []
        self.upload_failures = 0
        self.phase_ms = {"decode": 0.0, "host_wait": 0.0, "dispatch": 0.0,
                         "device_wait": 0.0, "write": 0.0}
        self._phase_lock = threading.Lock()
        self.images_per_sec = 0.0
        self.phase_ms_per_image: dict = {}

    def _phase_add(self, name: str, seconds: float):
        with self._phase_lock:
            self.phase_ms[name] += seconds * 1e3

    # -- uploads: 2 threads, at most MAX_PENDING_UPLOADS shards queued ----
    def _upload(self, path: str, index: int):
        from yat_tpu_torch.data.r2 import upload_file
        try:
            upload_file(self.upload_url_fn(path, index), path)
            os.remove(path)
            with self._lock:
                self.uploaded.append(os.path.basename(path))
        except Exception as e:  # noqa: BLE001 — the shard stays on disk
            print(f"[extract] upload failed for {path}: {e}")
            with self._lock:
                self.upload_failures += 1
        finally:
            with self._lock:
                self._pending -= 1
                self._lock.notify_all()

    def _on_shard_complete(self, path: str, index: int):
        if self._pool is None:
            return
        with self._lock:
            while self._pending >= self.MAX_PENDING_UPLOADS:
                self._lock.wait()
            self._pending += 1
        self._pool.submit(self._upload, path, index)

    # -- the encodes of one batch, launched now, fetched later ------------
    def _dispatch_encode(self, images: np.ndarray, captions: List[str]):
        """Launch every VAE and caption-encoder chunk of a batch (and the
        pooled text's) and return a closure that fetches ``(latents,
        embeddings, pooled)`` (``pooled`` None without ``encode_pooled``).
        Encoders without ``.dispatch`` hooks run at once."""
        vb = self.vae_bs or len(images)
        tb = self.te_bs or len(captions)
        img_d = getattr(self.encode_images, "dispatch", None)
        cap_d = getattr(self.encode_captions, "dispatch", None)
        pool = self.encode_pooled
        pool_d = getattr(pool, "dispatch", None)
        if img_d is None or cap_d is None or (pool and pool_d is None):
            latents = np.concatenate([
                np.asarray(self.encode_images(images[i:i + vb]))
                for i in range(0, len(images), vb)])
            embs: List[np.ndarray] = []
            for i in range(0, len(captions), tb):
                embs.extend(self.encode_captions(captions[i:i + tb]))
            pooled = None if pool is None else np.concatenate([
                np.asarray(pool(captions[i:i + tb]))
                for i in range(0, len(captions), tb)])
            return lambda: (latents, embs, pooled)
        lat_fins = [img_d(images[i:i + vb])
                    for i in range(0, len(images), vb)]
        cap_fins = [cap_d(captions[i:i + tb])
                    for i in range(0, len(captions), tb)]
        pool_fins = [] if pool is None else [
            pool_d(captions[i:i + tb]) for i in range(0, len(captions), tb)]

        def finish():
            latents = np.concatenate([np.asarray(f()) for f in lat_fins])
            embs: List[np.ndarray] = []
            for f in cap_fins:
                embs.extend(f())
            pooled = (np.concatenate([np.asarray(f()) for f in pool_fins])
                      if pool_fins else None)
            return latents, embs, pooled

        return finish

    def _prefetch(self, depth: int = 2):
        """The sampler read ``depth`` batches ahead on a daemon thread,
        which stops when the consumer leaves early (an error)."""
        q: "queue.Queue[object]" = queue.Queue(maxsize=depth)
        end = object()
        stop = threading.Event()

        def put_or_stop(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                it = iter(self.sampler)
                while True:
                    t = time.monotonic()
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    self._phase_add("decode", time.monotonic() - t)
                    if not put_or_stop(b):
                        return
                put_or_stop(end)
            except Exception as e:  # noqa: BLE001 — re-raised below
                put_or_stop(e)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                t = time.monotonic()
                item = q.get()
                self._phase_add("host_wait", time.monotonic() - t)
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def run(self) -> int:
        """Extract until the sampler ends; returns the number of samples
        written."""
        if data_peer_rank() > 0:
            # a tp/sp peer of a data index that another process extracts
            print(f"[extract] data index {data_index()}: its first process "
                  "extracts; nothing written here", flush=True)
            return 0
        os.makedirs(self.output_dir, exist_ok=True)
        written = 0
        pending: deque = deque()
        t0 = time.monotonic()
        pattern = (self.SHARD_PATTERN if data_count() == 1 else
                   f"shard-p{data_index()}-%06d.tar")
        with ShardWriter(os.path.join(self.output_dir, pattern),
                         maxcount=self.shard_size,
                         on_shard_complete=self._on_shard_complete) as w:

            def drain_one():
                nonlocal written
                ratio, finish = pending.popleft()
                t = time.monotonic()
                latents, embs, pooled = finish()
                self._phase_add("device_wait", time.monotonic() - t)
                t = time.monotonic()
                for i in range(len(latents)):
                    elem = {"__key__": f"{written:08d}",
                            "ratio": str(ratio),
                            "latent.npy": np.asarray(latents[i], np.float32),
                            "emb.npy": np.asarray(embs[i], np.float32)}
                    if pooled is not None:
                        elem["pooled.npy"] = np.asarray(pooled[i],
                                                        np.float32)
                    w.write(elem)
                    written += 1
                self._phase_add("write", time.monotonic() - t)

            for batch in self._prefetch():
                t = time.monotonic()
                fin = self._dispatch_encode(batch.images, batch.captions)
                self._phase_add("dispatch", time.monotonic() - t)
                pending.append((batch.ratio, fin))
                if len(pending) >= self.PIPELINE_DEPTH:
                    drain_one()
            while pending:
                drain_one()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        dt = time.monotonic() - t0
        self.images_per_sec = written / dt if dt > 0 else 0.0
        self.phase_ms_per_image = {
            k: round(v / written, 2) if written else 0.0
            for k, v in self.phase_ms.items()}
        if written:
            phases = ", ".join(f"{k} {v / 1e3:.2f} s"
                               for k, v in self.phase_ms.items())
            print(f"[extract] {written} samples in {dt:.2f} s, "
                  f"{self.images_per_sec:.2f} imgs/s ({phases})")
        return written


def run_feature_extraction(trainer) -> FeatureExtractor:
    """The ``extract_features`` pass of the CLI: one pass over the raw
    shard source (:func:`~yat_tpu_torch.frontends.common.make_image_source`
    with ``one_pass``), bucketed at ``batch_size`` with no shuffle
    holdback, the trainer's encoders (built through its ``family_spec``
    when the sampler did not build them), shards of
    ``r2_upload_shard_size`` (1000) samples into ``features/`` (or
    ``r2_dataset_folder`` when nothing uploads), each uploaded to
    ``r2_upload_key/`` through a presigned PUT when R2 and an upload key
    are configured.  Returns the extractor (``written``, ``phase_ms``,
    ``images_per_sec``, ``uploaded``)."""
    from yat_tpu_torch.data.bins import bin_for_resolution
    from yat_tpu_torch.data.sampler import ImageBucketSampler
    from yat_tpu_torch.frontends.common import (ensure_encoders,
                                                make_image_source)

    params = trainer.params
    spec = trainer.family_spec
    bins = bin_for_resolution(params.aspect_ratios or spec.default_resolution)
    source = make_image_source(params, one_pass=True)
    sampler = ImageBucketSampler(source, params.batch_size, bins,
                                 seed=params.dataset_seed, shuffle_buffer=1)
    print(f"[extract] raw images decode through {sampler.decoder}")
    if getattr(trainer, "encode_images", None) is None:
        ensure_encoders(params, spec, {}, trainer)

    upload_url_fn = None
    if params.r2_endpoint and params.r2_upload_key:
        from yat_tpu_torch.data.r2 import R2Client
        client = R2Client(params.r2_access_key, params.r2_secret_key,
                          params.r2_endpoint)

        def upload_url_fn(path, index):
            name = os.path.basename(path)
            return client.presign_put(params.r2_bucket_name,
                                      f"{params.r2_upload_key}/{name}")

    ex = FeatureExtractor(
        sampler, trainer.encode_images, trainer.encode_captions,
        output_dir=("features" if params.r2_upload_key
                    else params.r2_dataset_folder or "features"),
        shard_size=params.r2_upload_shard_size or 1000,
        vae_max_batch_size=params.vae_max_batch_size,
        text_encoder_max_batch_size=params.text_encoder_max_batch_size,
        upload_url_fn=upload_url_fn,
        encode_pooled=getattr(trainer, "encode_pooled", None))
    try:
        ex.written = ex.run()
    finally:
        stop = getattr(source, "stop", None)
        if stop is not None:
            stop()
    return ex
