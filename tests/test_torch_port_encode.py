"""PyTorch port, the encode path on the CPU against the JAX package: the
DC-AE and KL-VAE encoders, the on-the-fly encoding sampler and the feature
cache, the engine's encode-free resume, and the extraction pass (the same
shards from the same raw shard, each package reading the other's; the
entry point uploading to a signed endpoint).  The training runs on raw
images are in ``test_torch_port_raw_train.py``."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

from yat_tpu_torch.convert import load_flax_params  # noqa: E402

# fp32 encoders on the CPU, summation order only (the decoders' tolerance,
# tests/test_torch_port_models.py)
MODEL_TOL = 1e-4
TARGETS = ["to_q", "to_k", "to_v", "to_out"]
# the JAX package's tiny SANA on the DC-AE and Gemma test encoders
TINY_SANA = {
    "hidden_dim": "32", "num_layers": "1", "num_attention_heads": "2",
    "attention_head_dim": "16", "num_cross_attention_heads": "2",
    "cross_attention_head_dim": "16", "caption_channels": "32",
    "max_caption_len": "8", "mlp_ratio": "1.0", "in_channels": "32",
    "out_channels": "32", "sample_size": "4", "vae_compression": "4",
    "tiny_encoders": "1"}
# the tiny PixArt on the KL-VAE and T5 test encoders (2x compression)
TINY_PIXART = {
    "hidden_dim": "32", "num_layers": "1", "num_attention_heads": "2",
    "attention_head_dim": "16", "caption_channels": "32",
    "max_caption_len": "8", "mlp_ratio": "1.0", "in_channels": "4",
    "out_channels": "4", "sample_size": "8", "vae_compression": "2",
    "tiny_encoders": "1"}


def _tree(variables):
    return jax.tree.map(np.asarray, variables["params"])


@contextlib.contextmanager
def jitted_flax_init():
    """flax ``init`` under one ``jax.jit`` a module (cached by module)
    instead of op by op, inside the block.  The JAX package's encoder
    builders init eagerly, which compiles every op on its own: about 20 s
    of CPU for the tiny DC-AE and Gemma, against about 8 s jitted.  Both
    packages get the jitted weights (within 6e-8 of the eager ones)."""
    import flax.linen as nn

    eager = nn.Module.init
    jitted = jax.jit(eager, static_argnums=0)

    def init(self, rngs, *args, **kw):
        if kw:
            return eager(self, rngs, *args, **kw)
        return jitted(self, rngs, *args)
    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


@pytest.fixture
def jit_flax_init():
    """:func:`jitted_flax_init` for one test."""
    with jitted_flax_init():
        yield


def make_image_shard(path, n=8, hw=(256, 256), seed=0, wide=True):
    """Random JPEGs of ``hw`` (every fourth twice as wide, unless not
    ``wide``) with captions of 4-9 words."""
    from yat_tpu_torch.data.tar import TarShardWriter

    rng = np.random.default_rng(seed)
    with TarShardWriter(str(path)) as w:
        for i in range(n):
            h, wd = hw if i % 4 or not wide else (hw[0], hw[1] * 2)
            img = rng.integers(0, 255, (h, wd, 3), np.uint8)
            w.write({"__key__": f"{i:04d}",
                     "jpg": cv2.imencode(".jpg", img)[1].tobytes(),
                     "txt": " ".join(["word"] * (1 + i % 6))
                     + f" test image {i}"})
    return str(path)


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------

def test_dcae_encode_mode_matches_jax():
    from yat_tpu.models.vae import DCAE as JDCAE
    from yat_tpu.models.vae import DCAE_TINY_TEST
    from yat_tpu_torch.models.vae import DCAE

    jm = JDCAE(cfg=DCAE_TINY_TEST)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4),
                                 jnp.zeros((1, 16, 16, 3)))
    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 48, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode_mode))(
        variables, x)
    tm = DCAE(DCAE_TINY_TEST)
    load_flax_params(tm, _tree(variables))
    with torch.inference_mode():
        got = tm.encode_mode(torch.from_numpy(x))
    assert got.shape == (2, 8, 12, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def test_card_entry_points_turn_tf32_off(monkeypatch):
    """The fp32 encoders compute in fp32 on the card: resolving a CUDA
    device turns TF32 off for matmuls and cuDNN's convolutions (cuDNN's
    default is on); the CPU leaves the flags alone."""
    from yat_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    resolve_device("cpu")
    assert torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("variant", ["sd15", "shift", "clipped"])
def test_klvae_encode_matches_jax(variant):
    """``encode`` (mean, log-variance clipped to [-30, 20]) and
    ``encode_mode`` (shifted, scaled); ``clipped`` scales the log-variance
    half of the moments' projection by 400, so the clip binds on both
    sides (its unclipped entries, hundreds large, are held to 1e-4 of the
    largest)."""
    import dataclasses

    from yat_tpu.models import vae as JV
    from yat_tpu_torch.models import vae as TV

    jcfg = JV.KLVAE_TINY_TEST
    if variant == "shift":
        jcfg = dataclasses.replace(jcfg, latent_channels=16,
                                   scaling_factor=1.5305, shift_factor=0.0609)
    tcfg = TV.KLVAEConfig(**dataclasses.asdict(jcfg))
    jm = JV.AutoencoderKL(cfg=jcfg)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    if variant == "clipped":
        qc = params["encoder"]["quant_conv"]
        c = jcfg.latent_channels
        qc["kernel"] = np.concatenate(
            [qc["kernel"][..., :c], qc["kernel"][..., c:] * 400.0], -1)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 16, 24, 3)).astype(
        np.float32)
    jmean, jlogvar, jz = jax.jit(lambda p, x: (
        *jm.apply({"params": p}, x, method=jm.encode),
        jm.apply({"params": p}, x, method=jm.encode_mode)))(params, x)
    tm = TV.AutoencoderKL(tcfg)
    load_flax_params(tm, params)
    with torch.inference_mode():
        mean, logvar = tm.encode(torch.from_numpy(x))
        z = tm.encode_mode(torch.from_numpy(x))
    assert mean.shape == (2, 8, 12, jcfg.latent_channels)
    for got, want in ((mean, jmean), (logvar, jlogvar), (z, jz)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=MODEL_TOL,
            atol=MODEL_TOL * max(1.0, float(np.abs(want).max())))
    if variant == "clipped":
        assert float(logvar.max()) == 20.0 and float(logvar.min()) == -30.0


# ---------------------------------------------------------------------------
# the on-the-fly sampler and the feature cache
# ---------------------------------------------------------------------------

def _fake_encoders(calls):
    """Deterministic stand-ins for both packages: latents from the pixels,
    caption embeddings of one row per word."""
    def encode_images(x):
        calls.append(("img", len(x)))
        return x[:, ::8, ::8, :2].astype(np.float32) / 255.0

    def encode_captions(caps):
        calls.append(("cap", len(caps)))
        return [np.full((len(c.split()), 3), len(c), np.float32)
                for c in caps]
    return encode_images, encode_captions


def _stream(pkg, shard, skip=None, n=7, cache=False):
    if pkg == "jax":
        from yat_tpu.data import bins, sampler
        from yat_tpu.train import encode
    else:
        from yat_tpu_torch.data import bins, sampler
        from yat_tpu_torch.train import encode
    calls = []
    ei, ec = _fake_encoders(calls)
    images = sampler.ImageBucketSampler(
        sampler.LocalShardSource([shard], seed=1), 2,
        bins.bin_for_resolution(256), seed=2, shuffle_buffer=3)
    s = encode.OnTheFlyEncodingSampler(
        images, ei, ec, 16, vae_max_batch_size=1,
        text_encoder_max_batch_size=2,
        caption_buckets=sampler.caption_length_buckets(16, 4), repeat=3)
    if cache:
        s = encode.FeatureCache(s, cache_size=2)
    if skip is not None:
        s.skip_batches(skip)
        assert calls == [], "skip_batches ran an encoder"
    out = []
    for b in s:
        out.append(b)
        if len(out) == n:
            break
    if cache:
        s.stop()
    return out, calls


@pytest.mark.parametrize("skip", [None, 4, 6], ids=["noskip", "partial",
                                                     "whole"])
def test_on_the_fly_stream_matches_jax(tmp_path, skip):
    """Chunked encodes, caption-length rungs, ``repeat`` after the encode
    and an encode-free ``skip_batches`` that lands inside or between a
    batch's repeats: the same batches as the JAX package's sampler."""
    shard = make_image_shard(tmp_path / "s.tar", n=12, hw=(64, 64))
    got, tcalls = _stream("port", shard, skip)
    want, jcalls = _stream("jax", shard, skip)
    assert tcalls == jcalls
    assert ("img", 1) in tcalls and ("cap", 2) in tcalls
    for g, w in zip(got, want):
        assert g.ratio == w.ratio
        for f in ("latents", "embeddings", "text_mask"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert len(got) == len(want) == 7
    assert {g.embeddings.shape[1] for g in got} <= {4, 8, 12, 16}


def test_feature_cache_matches_and_stops(tmp_path):
    """The cache yields the sampler's batches in order; ``stop`` ends its
    thread (which would otherwise wait on a full queue) and a failure in
    the thread reaches the consumer."""
    from yat_tpu_torch.data.sampler import Batch
    from yat_tpu_torch.train.encode import FeatureCache, SkipUnsupported

    shard = make_image_shard(tmp_path / "s.tar", n=12, hw=(64, 64))
    direct, _ = _stream("port", shard, n=7)
    cached, _ = _stream("port", shard, n=7, cache=True)
    for a, b in zip(direct, cached):
        np.testing.assert_array_equal(a.latents, b.latents)

    c = FeatureCache(iter(Batch(ratio=str(i)) for i in range(100)),
                     cache_size=2)
    it = iter(c)
    assert next(it).ratio == "0"
    c.stop()
    assert not c._thread.is_alive()
    with pytest.raises(SkipUnsupported):
        FeatureCache([]).skip_batches(1)

    def broken():
        yield Batch(ratio="a")
        raise OSError("disk gone")
    with pytest.raises(RuntimeError, match="encoding worker failed"):
        list(FeatureCache(broken()))


def test_feature_cache_stops_over_a_stalled_url_source(tmp_path):
    """``stop`` returns while the cache's thread waits on a url source
    whose next download stalls (the shard before it filled no batch), and
    a consumer waiting on the cache returns too."""
    import http.server
    import threading

    from yat_tpu_torch.data.bins import bin_for_resolution
    from yat_tpu_torch.data.sampler import ImageBucketSampler, UrlShardSource
    from yat_tpu_torch.train.encode import (FeatureCache,
                                            OnTheFlyEncodingSampler)

    body = open(make_image_shard(tmp_path / "a.tar", n=3, hw=(64, 64)),
                "rb").read()
    stalled, release = threading.Event(), threading.Event()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/a.tar":
                stalled.set()
                release.wait(30)
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        source = UrlShardSource([url + "/a.tar", url + "/b.tar"],
                                local_temp_dir=str(tmp_path / "dl"),
                                one_pass=True)
        images = ImageBucketSampler(source, 4, bin_for_resolution(256))
        cache = FeatureCache(OnTheFlyEncodingSampler(
            images, *_fake_encoders([]), 16), cache_size=2)
        consumer = threading.Thread(target=lambda: list(cache), daemon=True)
        consumer.start()
        assert stalled.wait(30), "the second download never started"
        stopper = threading.Thread(target=cache.stop, daemon=True)
        stopper.start()
        stopper.join(10)
        assert not stopper.is_alive(), "FeatureCache.stop hangs"
        assert not cache._thread.is_alive()
        consumer.join(10)
        assert not consumer.is_alive(), "the cache's consumer hangs"
    finally:
        release.set()
        srv.shutdown()
        srv.server_close()
        serving.join(timeout=10)


def test_feature_cache_save_to_disk_replays(tmp_path):
    from yat_tpu_torch.data.sampler import Batch
    from yat_tpu_torch.train.encode import FeatureCache

    rng = np.random.default_rng(0)
    batches = [Batch(ratio=r, latents=rng.standard_normal((2, 2, 2, 3)),
                     embeddings=rng.standard_normal((2, 4, 5)),
                     text_mask=np.ones((2, 4), np.int32),
                     is_regularization=i == 1)
               for i, r in enumerate(["1.0", "0.5"])]
    produced = []

    def source():
        for b in batches:
            produced.append(b.ratio)
            yield b
    c = FeatureCache(source(), cache_size=4, save_to_disk=True,
                     cache_dir=str(tmp_path / "cache"))
    first = list(c)
    again = list(c)
    assert produced == ["1.0", "0.5"]            # the replay encodes nothing
    assert [b.ratio for b in again] == ["1.0", "0.5"]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.latents, b.latents)
        np.testing.assert_array_equal(a.embeddings, b.embeddings)
        assert a.is_regularization == b.is_regularization
        assert b.pooled_text is None


def test_engine_resume_skips_encode_free_or_drains():
    """The engine's fast-forward calls ``skip_batches`` when the sampler
    has it, and drains the sampler when it raises ``SkipUnsupported``."""
    from yat_tpu_torch.train.encode import SkipUnsupported
    from yat_tpu_torch.train.engine import Trainer

    class Skipping:
        def __init__(self, supported):
            self.supported, self.skipped, self.drained = supported, [], 0

        def skip_batches(self, n):
            if not self.supported:
                raise SkipUnsupported("no")
            self.skipped.append(n)

        def __iter__(self):
            for i in range(10):
                self.drained += 1
                yield i

    for supported in (True, False):
        t = Trainer.__new__(Trainer)
        t.sampler = Skipping(supported)
        it = t._fastforward_data(3)
        assert next(it) == (0 if supported else 3)
        assert t.sampler.skipped == ([3] if supported else [])


# ---------------------------------------------------------------------------
# extraction: both packages on the same raw shard and weights
# ---------------------------------------------------------------------------

def _jax_sana_encoder_trees(seed=0):
    """The weights the JAX package's build_encoders draws at the tiny size
    (``PRNGKey(dataset_seed)`` for both)."""
    from yat_tpu.models.text_encoders import GEMMA_TINY_TEST, Gemma2Encoder
    from yat_tpu.models.vae import DCAE, DCAE_TINY_TEST

    rng = jax.random.PRNGKey(seed)
    vae = DCAE(cfg=DCAE_TINY_TEST).init(rng, jnp.zeros((1, 16, 16, 3)))
    te = Gemma2Encoder(cfg=GEMMA_TINY_TEST, dtype=jnp.float32).init(
        rng, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    return {"vae": _tree(vae), "text_encoder": _tree(te)}


def _raw(tmp_path, shard, **extra):
    cfg = dict(local_shard_paths=[shard], batch_size="2",
               learning_rate="1e-3", steps="3", warmup_steps="1",
               num_steps_per_validation="100", validation_prompts=[],
               output_dir=str(tmp_path / "models"), compute_features="1",
               vae_max_batch_size="1", text_encoder_max_batch_size="2",
               cache_size="8", aspect_ratio="256", lora_rank="4",
               lora_alpha="4", lora_algo="lora", lora_target_modules=TARGETS,
               model_config_overrides=TINY_SANA)
    cfg.update(extra)
    return cfg


def _shard_samples(directory):
    from yat_tpu_torch.data.tar import iter_tar_samples
    out = []
    for name in sorted(os.listdir(directory)):
        out.extend(iter_tar_samples(os.path.join(directory, name)))
    return out


def test_extraction_matches_jax_and_shards_cross_read(tmp_path,
                                                     jit_flax_init):
    """One raw shard through both packages' extractors (chunks of 1 and 2,
    shards of 3 samples): the same keys, ratios and shapes, latents and
    embeddings within 1e-4; each package's feature sampler reads the
    other's shards into the same batches."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.data import sampler as JS
    from yat_tpu.data.bins import bin_for_resolution as jbins
    from yat_tpu.frontends.sana import build_encoders as j_build
    from yat_tpu.frontends.sana import build_sana_config as j_cfg
    from yat_tpu.train.extract import FeatureExtractor as JEx
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.data import sampler as TS
    from yat_tpu_torch.data.bins import bin_for_resolution
    from yat_tpu_torch.frontends.sana import build_encoders, build_sana_config
    from yat_tpu_torch.train.extract import FeatureExtractor

    shard = make_image_shard(tmp_path / "raw.tar", n=8)
    raw = _raw(tmp_path, shard)
    jp = JParams.from_dict(raw)
    j_img, j_cap, _ = j_build(jp, j_cfg(jp))
    tp = TrainingParameters.from_dict(raw)
    t_img, t_cap, _ = build_encoders(tp, build_sana_config(tp), "cpu",
                                     _jax_sana_encoder_trees())
    kw = dict(shard_size=3, vae_max_batch_size=1,
              text_encoder_max_batch_size=2)
    jn = JEx(JS.ImageBucketSampler([shard], 2, jbins(256), shuffle_buffer=1),
             j_img, j_cap, output_dir=str(tmp_path / "jax"), **kw).run()
    tex = FeatureExtractor(
        TS.ImageBucketSampler([shard], 2, bin_for_resolution(256),
                              shuffle_buffer=1),
        t_img, t_cap, output_dir=str(tmp_path / "port"), **kw)
    assert tex.run() == jn == 8
    assert set(tex.phase_ms) == {"decode", "host_wait", "dispatch",
                                 "device_wait", "write"}
    assert tex.images_per_sec > 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [f"shard-00000{i}.tar"
                                          for i in range(3)]
    got, want = _shard_samples(tmp_path / "port"), _shard_samples(
        tmp_path / "jax")
    assert [(s["__key__"], s["ratio"]) for s in got] == [
        (s["__key__"], s["ratio"]) for s in want]
    assert {s["ratio"] for s in got} == {"1.0", "0.5"}
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"__key__", "ratio", "latent.npy",
                                    "emb.npy"}
        for f in ("latent.npy", "emb.npy"):
            assert g[f].shape == w[f].shape and g[f].dtype == np.float32
            np.testing.assert_allclose(g[f], w[f], atol=MODEL_TOL,
                                       rtol=MODEL_TOL)

    # each package reads the other's shards
    def batches(S, directory):
        src = [os.path.join(directory, n) for n in sorted(os.listdir(
            directory))]
        s = S.FeatureBucketSampler(src, 2, 8, shuffle_buffer=1)
        return list(s)
    for a, b in ((batches(JS, tmp_path / "port"), batches(TS, tmp_path /
                                                             "port")),
                 (batches(TS, tmp_path / "jax"), batches(JS, tmp_path /
                                                         "jax"))):
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.ratio == y.ratio
            for f in ("latents", "embeddings", "text_mask"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_extract_entry_point_uploads_to_a_signed_endpoint(tmp_path,
                                                          monkeypatch):
    """``extract_features`` through ``main([... "--device", "cpu"])``: one
    pass over the raw shard, shards of 3 uploaded by presigned PUTs that
    the stand-in endpoint of ``chip_smoke.py`` verifies (a bad signature is
    refused), and removed locally once uploaded."""
    import yaml

    import chip_smoke
    from yat_tpu_torch.data.r2 import upload_file
    from yat_tpu_torch.frontends.sana import main

    shard = make_image_shard(tmp_path / "raw.tar", n=8)
    monkeypatch.chdir(tmp_path)
    ak, sk, bucket = chip_smoke.S3_KEYS
    with chip_smoke.StandInS3(str(tmp_path / "s3"), *chip_smoke.S3_KEYS) \
            as s3:
        raw = _raw(tmp_path, shard, extract_features="1", r2_endpoint=s3.url,
                   r2_access_key=ak, r2_secret_key=sk,
                   r2_bucket_name=bucket, r2_upload_key="feat",
                   r2_upload_shard_size="3")
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text(yaml.safe_dump(raw))
        trainer = main(["--config", str(cfg), "--device", "cpu"])
        bad = tmp_path / "bad.tar"
        bad.write_bytes(b"x")
        with pytest.raises(RuntimeError, match="upload failed"):
            monkeypatch.setattr("time.sleep", lambda s: None)
            upload_file(f"{s3.url}/{bucket}/feat/bad.tar?X-Amz-Date="
                        "20260101T000000Z&X-Amz-Signature=00", str(bad),
                        retries=1)
    ex = trainer.extraction
    assert ex.written == 8 and ex.upload_failures == 0
    assert sorted(ex.uploaded) == [f"shard-00000{i}.tar" for i in range(3)]
    assert sorted(n for n, _ in s3.stored) == [
        f"feat/shard-00000{i}.tar" for i in range(3)]
    assert s3.rejected == 1
    assert os.listdir(tmp_path / "features") == []
    assert len(_shard_samples(tmp_path / "s3" / "feat")) == 8
