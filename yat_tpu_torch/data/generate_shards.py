"""Dataset shard generation: repackage source WebDatasets into uniform
``shard-%06d.tar`` files of ``{jpg, txt}``, uploaded as they finish.

A copy of ``yat_tpu/data/generate_shards.py`` on the port's own
``data/tar.py`` and ``data/r2.py``.  Sources are local TARs or
presigned/public URLs (streamed), or R2 objects (``r2_tar_files``, through
presigned GETs); captions may come from separate caption shards joined by
key.  Each finished shard is uploaded to ``r2_upload_key/`` when R2 is
configured.

    python -m yat_tpu_torch.data.generate_shards --config cfg.yaml \
        [--sources a.tar https://...] [--caption-sources c.tar] \
        [--output-dir shards]
"""

from __future__ import annotations

import argparse
import io
import os
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional

from yat_tpu_torch.data.tar import IMAGE_EXTS, ShardWriter, iter_tar_samples


def iter_source_samples(sources: Iterable[str]) -> Iterator[dict]:
    """Stream {__key__, jpg, txt} records from each source TAR (local path
    or URL); a source that fails is skipped with a message."""
    for src in sources:
        try:
            if src.startswith(("http://", "https://")):
                resp = urllib.request.urlopen(src, timeout=60)
                stream = io.BufferedReader(resp, buffer_size=1 << 20)
                samples = iter_tar_samples(stream, decode=False)
            else:
                samples = iter_tar_samples(src, decode=False)
            for elem in samples:
                img = next((elem[e] for e in IMAGE_EXTS if e in elem), None)
                txt = elem.get("txt")
                if img is None or txt is None:
                    continue
                yield {"__key__": elem["__key__"], "jpg": img,
                       "txt": txt if isinstance(txt, bytes) else
                       str(txt).encode()}
        except Exception as e:  # noqa: BLE001 — skip a bad source
            print(f"[generate_shards] skipping source {src}: {e}")


def join_captions(image_sources: Iterable[str],
                  caption_sources: Iterable[str]) -> Iterator[dict]:
    """Caption records (JSON ``caption``/``sharecap``, or txt) of
    ``caption_sources`` joined to the images of ``image_sources`` by
    key."""
    captions: Dict[str, str] = {}
    for src in caption_sources:
        for elem in iter_tar_samples(src, decode=True):
            cap = elem.get("json")
            if isinstance(cap, dict):
                cap = cap.get("caption") or cap.get("sharecap") or ""
            cap = cap or elem.get("txt")
            if cap:
                captions[elem["__key__"]] = str(cap)
    for src in image_sources:
        for elem in iter_tar_samples(src, decode=False):
            img = next((elem[e] for e in IMAGE_EXTS if e in elem), None)
            cap = captions.get(elem["__key__"])
            if img is None or cap is None:
                continue
            yield {"__key__": elem["__key__"], "jpg": img,
                   "txt": cap.encode()}


class ShardUploader:
    """Each finished shard PUT to ``remote_folder/`` of the bucket on a pool
    of 2 threads, at most 4 pending, and removed locally once uploaded."""

    def __init__(self, client, bucket: str, remote_folder: str,
                 max_pending: int = 4):
        self.client = client
        self.bucket = bucket
        self.remote_folder = remote_folder
        self._pending = 0
        self._cv = threading.Condition()
        self._pool = ThreadPoolExecutor(max_workers=2)

    def __call__(self, path: str, index: int):
        with self._cv:
            while self._pending >= 4:
                self._cv.wait()
            self._pending += 1
        self._pool.submit(self._upload, path, index)

    def _upload(self, path: str, index: int):
        from yat_tpu_torch.data.r2 import upload_file
        key = f"{self.remote_folder}/{os.path.basename(path)}" \
            if self.remote_folder else os.path.basename(path)
        try:
            upload_file(self.client.presign_put(self.bucket, key), path)
            os.remove(path)
        except Exception as e:  # noqa: BLE001
            print(f"[generate_shards] upload failed for {path}: {e}")
        finally:
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    def close(self):
        self._pool.shutdown(wait=True)


def generate_shards(sources: Iterable[str], output_dir: str,
                    shard_size: int = 1000,
                    caption_sources: Optional[Iterable[str]] = None,
                    uploader=None) -> int:
    os.makedirs(output_dir, exist_ok=True)
    stream = (join_captions(sources, caption_sources) if caption_sources
              else iter_source_samples(sources))
    written = 0
    with ShardWriter(os.path.join(output_dir, "shard-%06d.tar"),
                     maxcount=shard_size,
                     on_shard_complete=uploader) as w:
        for sample in stream:
            sample["__key__"] = f"{written:08d}"
            w.write(sample)
            written += 1
    if uploader is not None:
        uploader.close()
    return written


def list_hf_dataset_urls(repo_id: str, pattern: str = ".tar") -> list:
    """A Hugging Face dataset repo's TAR files as download URLs
    (``huggingface_dataset_repo``).  Needs ``huggingface_hub`` and the
    network; raises a clear error without the package."""
    try:
        from huggingface_hub import HfApi, hf_hub_url
    except ImportError as e:
        raise RuntimeError(
            "huggingface_dataset_repo needs the huggingface_hub package; "
            "use 'urls' or 'local_shard_paths' in offline environments"
        ) from e
    api = HfApi()
    files = [f for f in api.list_repo_files(repo_id, repo_type="dataset")
             if f.endswith(pattern)]
    return [hf_hub_url(repo_id, f, repo_type="dataset") for f in files]


def main(argv=None):
    from yat_tpu_torch.config import TrainingParameters
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--sources", nargs="*", default=None,
                   help="override source TAR paths/URLs")
    p.add_argument("--caption-sources", nargs="*", default=None)
    p.add_argument("--output-dir", default="shards")
    args = p.parse_args(argv)
    params = TrainingParameters.read_yaml(args.config)
    sources = args.sources or params.urls or params.local_shard_paths or []
    if not sources and params.r2_endpoint and params.r2_tar_files:
        # presigned GET urls for the configured R2 tar list
        from yat_tpu_torch.data.r2 import get_secured_urls
        sources = get_secured_urls(
            params.r2_access_key, params.r2_secret_key, params.r2_endpoint,
            params.r2_bucket_name, params.r2_tar_files)
    if not sources and params.huggingface_dataset_repo:
        sources = list_hf_dataset_urls(params.huggingface_dataset_repo)
    uploader = None
    if params.r2_endpoint and params.r2_upload_key:
        from yat_tpu_torch.data.r2 import R2Client
        uploader = ShardUploader(
            R2Client(params.r2_access_key, params.r2_secret_key,
                     params.r2_endpoint),
            params.r2_bucket_name, params.r2_upload_key)
    n = generate_shards(sources, args.output_dir,
                        shard_size=params.r2_upload_shard_size or 1000,
                        caption_sources=args.caption_sources,
                        uploader=uploader)
    print(f"wrote {n} samples")


if __name__ == "__main__":
    main()
