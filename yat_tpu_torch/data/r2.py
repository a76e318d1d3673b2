"""Cloudflare R2 / S3-compatible object store client, stdlib only.

A copy of ``yat_tpu/data/r2.py``, so the port signs and moves shards as
the JAX package does without importing it:

* ``R2Client.presign`` / ``presign_get`` / ``presign_put``: AWS Signature
  V4 query-string presigning with stdlib hmac/hashlib (path-style keys,
  ``UNSIGNED-PAYLOAD``, the ``host`` header signed); GETs expire after a
  week by default, PUTs after an hour;
* ``download_tar``: a streaming download with a total-time abort
  (240 s by default) and the partial file removed on failure;
* ``upload_file``: one PUT of a whole file to a presigned URL, retried.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import time
import urllib.parse
import urllib.request
from typing import Iterable, List, Optional


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def _quote(s: str) -> str:
    return urllib.parse.quote(s, safe="-_.~")


class R2Client:
    """S3 SigV4 signer bound to one endpoint + credential pair."""

    def __init__(self, access_key: str, secret_key: str, endpoint: str,
                 region: str = "auto"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.endpoint = endpoint.rstrip("/")
        self.region = region
        parsed = urllib.parse.urlparse(self.endpoint)
        self.host = parsed.netloc
        self.scheme = parsed.scheme or "https"

    def presign(self, method: str, bucket: str, key: str,
                expires: int = 604800,
                now: Optional[datetime.datetime] = None) -> str:
        """AWS SigV4 query presign (the algorithm is public AWS spec)."""
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        scope = f"{datestamp}/{self.region}/s3/aws4_request"

        # path-style (R2 account endpoints); empty bucket → virtual-hosted
        prefix = "/" + _quote(bucket) if bucket else ""
        canonical_uri = prefix + "/" + "/".join(
            _quote(part) for part in key.split("/"))
        params = {
            "X-Amz-Algorithm": "AWS4-HMAC-SHA256",
            "X-Amz-Credential": f"{self.access_key}/{scope}",
            "X-Amz-Date": amz_date,
            "X-Amz-Expires": str(expires),
            "X-Amz-SignedHeaders": "host",
        }
        canonical_query = "&".join(
            f"{_quote(k)}={_quote(v)}" for k, v in sorted(params.items()))
        canonical_headers = f"host:{self.host}\n"
        canonical_request = "\n".join([
            method, canonical_uri, canonical_query, canonical_headers,
            "host", "UNSIGNED-PAYLOAD"])
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical_request.encode()).hexdigest()])
        k_date = _hmac(b"AWS4" + self.secret_key.encode(), datestamp)
        k_region = _hmac(k_date, self.region)
        k_service = _hmac(k_region, "s3")
        k_signing = _hmac(k_service, "aws4_request")
        signature = hmac.new(k_signing, string_to_sign.encode(),
                             hashlib.sha256).hexdigest()
        return (f"{self.scheme}://{self.host}{canonical_uri}?"
                f"{canonical_query}&X-Amz-Signature={signature}")

    def presign_get(self, bucket: str, key: str, expires: int = 604800) -> str:
        return self.presign("GET", bucket, key, expires)

    def presign_put(self, bucket: str, key: str, expires: int = 3600) -> str:
        return self.presign("PUT", bucket, key, expires)


def get_secured_urls(access_key: str, secret_key: str, endpoint: str,
                     bucket_name: str, keys: Iterable[str],
                     expires: int = 604800) -> List[str]:
    """Presigned GETs for ``keys`` (one week by default)."""
    client = R2Client(access_key, secret_key, endpoint)
    return [client.presign_get(bucket_name, k, expires) for k in keys]


class DownloadTimeout(Exception):
    pass


def download_tar(url: str, local_path: str, chunk_size: int = 1 << 16,
                 max_seconds: float = 240.0, timeout: float = 30.0) -> str:
    """Streaming download with a total-time abort: 64 KiB chunks into
    ``local_path + ".part"``, renamed into place at the end.  Raises
    DownloadTimeout when the whole transfer exceeds ``max_seconds``; the
    partial file is removed on any failure."""
    start = time.monotonic()
    tmp_path = local_path + ".part"
    os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
    try:
        req = urllib.request.Request(url, headers={"User-Agent": "yat-tpu/0.1"})
        with urllib.request.urlopen(req, timeout=timeout) as resp, \
                open(tmp_path, "wb") as f:
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    break
                f.write(chunk)
                if time.monotonic() - start > max_seconds:
                    raise DownloadTimeout(
                        f"download exceeded {max_seconds}s: {url[:80]}")
        os.replace(tmp_path, local_path)
        return local_path
    except Exception:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise


def upload_file(url: str, local_path: str, retries: int = 3,
                timeout: float = 300.0) -> None:
    """PUT a file to a presigned URL; ``retries`` attempts with a backoff
    of 1, 2, 4 ... seconds, then RuntimeError."""
    with open(local_path, "rb") as f:
        data = f.read()
    last = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url, data=data, method="PUT")
            req.add_header("Content-Length", str(len(data)))
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if 200 <= resp.status < 300:
                    return
                last = RuntimeError(f"PUT status {resp.status}")
        except Exception as e:  # noqa: BLE001
            last = e
        time.sleep(2.0 ** attempt)
    raise RuntimeError(f"upload failed after {retries} attempts: {last}")
