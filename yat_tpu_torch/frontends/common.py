"""Frontend helpers shared by the model families.

Counterparts of the helpers of ``yat_tpu/frontends/common.py`` that the
SANA paths need: YAML config overrides, the caption rung slicer, the local
feature-shard sampler and the training CLI (``cli_main``, which adds
``--device`` to the JAX package's ``--config``).  Streaming from URLs or
R2 and the feature-extraction phase are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import numpy as np

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.data.sampler import (
    FeatureBucketSampler,
    LocalShardSource,
    caption_length_buckets,
    caption_rung,
)
from yat_tpu_torch.parallel.multihost import host_seed


def slice_caption_rung(ids, mask, multiple: int = 64):
    """Trim tokenized captions to the smallest ``multiple``-token rung
    covering the batch's longest real caption before the text-encoder
    forward.  Outputs at kept positions are unchanged: padding is masked out
    of attention and positions are absolute."""
    m = np.asarray(mask)
    real = int(m.sum(axis=1).max()) if m.any() else 1
    rung = caption_rung(real, ids.shape[1], multiple)
    if rung == ids.shape[1]:
        return ids, mask
    return ids[:, :rung], mask[:, :rung]


def _coerce_like(cur, v):
    if cur is None:
        # Optional fields: infer numeric types from the value itself
        if isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    return v
        return v
    if isinstance(cur, bool):
        return str(v).lower() in ("1", "true", "yes")
    if isinstance(cur, (tuple, list)):
        elem_t = type(cur[0]) if len(cur) else int
        return type(cur)(elem_t(x) for x in v)
    return type(cur)(v)


def override_config(cfg, overrides: dict, mirror_out_channels: bool = False):
    """Apply YAML ``model_config_overrides``, coercing string values to the
    field's type (tuple fields element-wise).  Keys unknown to this config
    (frontend-level knobs) are skipped.  ``mirror_out_channels``: an
    ``in_channels`` override also sets ``out_channels`` unless that is
    overridden too (velocity families predict in the latent space)."""
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        if k == "preset" or not hasattr(cfg, k):
            continue
        typed[k] = _coerce_like(getattr(cfg, k), v)
    if (mirror_out_channels and "in_channels" in typed
            and "out_channels" not in typed and hasattr(cfg, "out_channels")):
        typed["out_channels"] = typed["in_channels"]
    return dataclasses.replace(cfg, **typed)


def make_local_source(params: TrainingParameters) -> LocalShardSource:
    """The local shard source of process 0 (one process: every path), its
    shuffle seeded with ``host_seed(dataset_seed)`` as in the JAX
    package."""
    return LocalShardSource(list(params.local_shard_paths),
                            seed=host_seed(params.dataset_seed))


def build_feature_sampler(params: TrainingParameters, max_caption_len: int):
    """The pre-extracted feature-shard sampler over ``local_shard_paths``;
    None when no data source is configured."""
    if params.urls or params.r2_endpoint:
        raise NotImplementedError(
            "streaming feature shards from urls or R2 is not implemented in "
            "the PyTorch port yet (ROADMAP queue 1, item 8); use "
            "local_shard_paths")
    if not params.local_shard_paths:
        return None
    cb = (caption_length_buckets(max_caption_len)
          if params.caption_length_bucketing else None)
    return FeatureBucketSampler(make_local_source(params), params.batch_size,
                                max_caption_len, seed=params.dataset_seed,
                                caption_buckets=cb,
                                bucket_repeat=params.bucket_repeat)


def cli_main(make_trainer: Callable[..., object],
             argv: Optional[list] = None):
    """``--config config.yaml [--device cuda|cpu]``: build the trainer on
    the device (the card unless asked otherwise) and run it; returns the
    trainer."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    params = TrainingParameters.read_yaml(args.config)
    if params.extract_features or params.compute_features:
        raise NotImplementedError(
            "feature extraction and on-the-fly encoding are not implemented "
            "in the PyTorch port yet (ROADMAP queue 1, item 8)")
    trainer = make_trainer(params, device=args.device)
    trainer.run()
    return trainer
