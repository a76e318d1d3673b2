"""Aspect-ratio bucket tables and bucket-assignment math.

A copy of ``yat_tpu/data/bins.py`` (stdlib only), so the port buckets raw
images exactly as the JAX package does without importing it.  Every image
is binned into a fixed table of (height, width) buckets keyed by a
stringified aspect ratio (h/w): the canonical PixArt 1024 table, and its
exact 0.25x/0.5x/2x scalings for 256/512/2048, every dimension a multiple
of 32 (so latent sizes divide the 8x/32x VAE compression and the DiT patch
sizes).  The string keys are also the ``ratio`` field of feature shards,
so they are part of the on-disk format.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Canonical PixArt 1024 bin table: {h/w ratio (string key): (height, width)}.
_BASE_1024: Dict[str, Tuple[int, int]] = {
    "0.25": (512, 2048),
    "0.28": (512, 1856),
    "0.32": (576, 1792),
    "0.33": (576, 1728),
    "0.35": (576, 1664),
    "0.4": (640, 1600),
    "0.42": (640, 1536),
    "0.48": (704, 1472),
    "0.5": (704, 1408),
    "0.52": (704, 1344),
    "0.57": (768, 1344),
    "0.6": (768, 1280),
    "0.68": (832, 1216),
    "0.72": (832, 1152),
    "0.78": (896, 1152),
    "0.82": (896, 1088),
    "0.88": (960, 1088),
    "0.94": (960, 1024),
    "1.0": (1024, 1024),
    "1.07": (1024, 960),
    "1.13": (1088, 960),
    "1.21": (1088, 896),
    "1.29": (1152, 896),
    "1.38": (1152, 832),
    "1.46": (1216, 832),
    "1.67": (1280, 768),
    "1.75": (1344, 768),
    "2.0": (1408, 704),
    "2.09": (1472, 704),
    "2.4": (1536, 640),
    "2.5": (1600, 640),
    "3.0": (1728, 576),
    "4.0": (2048, 512),
}


def _scale(table: Dict[str, Tuple[int, int]], factor: float) -> Dict[str, Tuple[int, int]]:
    return {k: (int(h * factor), int(w * factor)) for k, (h, w) in table.items()}


ASPECT_RATIO_1024_BIN = dict(_BASE_1024)
ASPECT_RATIO_512_BIN = _scale(_BASE_1024, 0.5)
ASPECT_RATIO_256_BIN = _scale(_BASE_1024, 0.25)
ASPECT_RATIO_2048_BIN = _scale(_BASE_1024, 2.0)

_BY_RESOLUTION = {
    256: ASPECT_RATIO_256_BIN,
    512: ASPECT_RATIO_512_BIN,
    1024: ASPECT_RATIO_1024_BIN,
    2048: ASPECT_RATIO_2048_BIN,
}


def bin_for_resolution(resolution: int) -> Dict[str, Tuple[int, int]]:
    """Pick the bin table for a model's native resolution: an exact match
    for 256/512/1024, the 2048 table for everything else."""
    return _BY_RESOLUTION.get(resolution, ASPECT_RATIO_2048_BIN)


def find_closest_ratio(ratio: float, aspect_ratios: Dict[str, Tuple[int, int]]) -> str:
    """Nearest bucket key for an image aspect ratio (h/w): a linear scan by
    absolute difference, the first key wins a tie; returns the string
    key."""
    best_key = None
    best_err = float("inf")
    for key in aspect_ratios:
        err = abs(float(key) - ratio)
        if err < best_err:
            best_err = err
            best_key = key
    return best_key


def bucket_size(ratio_key: str, aspect_ratios: Dict[str, Tuple[int, int]]) -> Tuple[int, int]:
    """(height, width) pixel size of a bucket."""
    h, w = aspect_ratios[ratio_key]
    return int(h), int(w)


def latent_size(ratio_key: str, aspect_ratios: Dict[str, Tuple[int, int]],
                vae_compression: int) -> Tuple[int, int]:
    """(height, width) of the latent grid for a bucket under a VAE factor."""
    h, w = bucket_size(ratio_key, aspect_ratios)
    return h // vae_compression, w // vae_compression
