"""PyTorch port, the serving slice end to end on the CPU: the port's SANA
pipeline against the JAX package's ``ValidationPipeline`` on the same
weights, prompts and initial noise; the port's batching sampler, HTTP
server, generation CLI and their option checks (``device="cpu"``)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_frontends import TINY_DIT, write_shard
from tests.test_validation_frontends import base
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# the tiny SANA stack of tests/test_serve.py
TINY_SANA = {**TINY_DIT, "caption_channels": "32",
             "num_cross_attention_heads": "2",
             "cross_attention_head_dim": "16", "in_channels": "32",
             "out_channels": "32", "sample_size": "4", "tiny_encoders": "1"}
RAW = dict(batch_size="2", learning_rate="1e-3", steps="1",
           num_steps_per_validation="100",
           model_config_overrides=TINY_SANA)
# images in [0, 1] after fp32 sampling (2 Euler steps at CFG 5.0) and an
# fp32 decode: summation order only
IMAGE_TOL = 1e-3


def _port_params(**over):
    from yat_tpu_torch.config import TrainingParameters
    return TrainingParameters.from_dict({**RAW, **over})


def _port_pipeline(**over):
    from yat_tpu_torch.frontends.sana import make_pipeline
    vp = make_pipeline(_port_params(**over), "cpu")
    vp.num_steps = 2
    return vp


def test_pipeline_matches_jax_validation(tmp_path):
    """JAX: the tiny SANA trainer of tests/test_serve.py and its
    validate_fn.  Port: make_pipeline on the trainer's transformer weights
    and the encoder weights the JAX frontend initialises from
    PRNGKey(dataset_seed), with JAX's seed_noise(42) injected as x0."""
    from yat_tpu.frontends.sana import make_trainer
    from yat_tpu.models.text_encoders import GEMMA_TINY_TEST, Gemma2Encoder
    from yat_tpu.models.vae import DCAE, DCAE_TINY_TEST
    from yat_tpu.ops.sampling import seed_noise
    from yat_tpu_torch.frontends.sana import make_pipeline

    shard = write_shard(tmp_path / "s.tar", (4, 4, 32), 32)
    p = base(tmp_path, shard, model_config_overrides=TINY_SANA)
    assert not p.bfloat16
    trainer = make_trainer(p)
    trainer.validate_fn.num_steps = 2
    trainer.initialize()
    want = trainer.validate_fn(trainer)

    rng = jax.random.PRNGKey(p.dataset_seed)
    te = Gemma2Encoder(cfg=GEMMA_TINY_TEST, dtype=jnp.float32)
    te_vars = te.init(rng, jnp.zeros((1, 8), jnp.int32),
                      jnp.ones((1, 8), jnp.int32))
    vae_vars = DCAE(cfg=DCAE_TINY_TEST).init(rng, jnp.zeros((1, 16, 16, 3)))
    weights = {k: jax.tree.map(np.asarray, v["params"]) for k, v in (
        ("transformer", trainer.state.variables()),
        ("text_encoder", te_vars), ("vae", vae_vars))}
    vp = make_pipeline(_port_params(), "cpu", weights)
    vp.num_steps = 2
    x0 = torch.from_numpy(np.array(seed_noise(42, (1, 4, 4, 32))))
    got = vp(list(p.validation_prompts), x0=x0)

    assert list(got) == list(want)
    for tag in want:
        assert got[tag].shape == want[tag].shape == (16, 16, 3)
        np.testing.assert_allclose(got[tag], np.asarray(want[tag]),
                                   atol=IMAGE_TOL)


def test_batching_sampler_groups_and_orders():
    from yat_tpu_torch.serve import BatchingSampler

    s = BatchingSampler(_port_pipeline(), max_batch=4, batch_window_ms=400.0)
    try:
        prompts = ["a red fox", "a blue bird", "a green tree"]
        results = [None] * len(prompts)

        def worker(i):
            results[i] = s.submit(prompts[i], timeout=300)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        for img in results:
            assert img is not None and np.isfinite(img).all()
            assert img.shape == (16, 16, 3)
        assert s.stats["batches"] == 1, s.stats
        assert s.stats["requests"] == 3
        # same prompt, same seed: the image reproduces (now in a batch of 1)
        again = s.submit("a red fox", timeout=300)
        np.testing.assert_allclose(again, results[0], atol=1e-5)
    finally:
        s.stop()


def test_timed_out_requests_are_shed():
    import time

    from yat_tpu_torch.serve import BatchingSampler

    sampled = []

    def pipeline(prompts):
        sampled.append(list(prompts))
        time.sleep(0.3)               # hold the sampler thread busy
        return {f"validation/{i}/{p}": np.zeros((4, 4, 3), np.float32)
                for i, p in enumerate(prompts)}

    s = BatchingSampler(pipeline, max_batch=2, batch_window_ms=0.0)
    try:
        t1 = threading.Thread(target=s.submit, args=("first",),
                              kwargs={"timeout": 30})
        t1.start()
        time.sleep(0.1)               # "first" is now sampling
        with pytest.raises(TimeoutError):
            s.submit("abandoned", timeout=0.01)
        t1.join(timeout=30)
        assert not t1.is_alive()
        assert s.submit("third", timeout=30) is not None
        assert "abandoned" not in [p for b in sampled for p in b], sampled
        assert s.stats["shed"] == 1, s.stats
    finally:
        s.stop()


def test_http_roundtrip_and_health():
    from yat_tpu_torch.serve import BatchingSampler, make_server

    s = BatchingSampler(_port_pipeline(), max_batch=2, batch_window_ms=50.0)
    server = make_server(s, host="127.0.0.1", port=0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": "a red fox"}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            ctype = resp.headers["Content-Type"]
            body = resp.read()
        assert ctype in ("image/png", "application/x-npy")
        if ctype == "image/png":
            assert body[:8] == b"\x89PNG\r\n\x1a\n"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["images"] >= 1
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=b"   ", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        s.stop()


def test_build_sampler_batch_cap_and_refused_options():
    from yat_tpu_torch.serve import build_sampler

    p = _port_params(validation_batch="1")
    s = build_sampler(p, "sana", max_batch=4, device="cpu", steps=2)
    try:
        assert p.validation_batch == 1            # explicit cap kept
        assert s.pipeline.num_steps == 2
    finally:
        s.stop()
    p2 = _port_params()
    s2 = build_sampler(p2, "sana", max_batch=4, device="cpu")
    try:
        assert p2.validation_batch == 4           # default aligns
    finally:
        s2.stop()
    # the sampler options go through the JAX package's gates: the cache
    # and DPM reach the pipeline, a bad interval or family raises
    s3 = build_sampler(_port_params(), "sana", cache_interval=2,
                       sampler="auto", device="cpu")
    try:
        assert s3.pipeline.cache_interval == 2
    finally:
        s3.stop()
    with pytest.raises(ValueError, match=">= 1"):
        build_sampler(_port_params(), "sana", cache_interval=0, device="cpu")
    with pytest.raises(ValueError, match="requires a flow-match family"):
        build_sampler(_port_params(), "sana", cache_interval=2,
                      sampler="dpm", device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        build_sampler(_port_params(), "pixeldit", device="cpu")
    # low_vram serves one prompt at a time
    s4 = build_sampler(_port_params(low_vram=""), "sana", device="cpu")
    try:
        assert s4.pipeline.params.low_vram
    finally:
        s4.stop()


def test_chip_smoke_serve_phase_on_cpu():
    """chip_smoke.py's serve phase, rehearsed at the tiny size on the CPU:
    4 concurrent HTTP requests and one more through the port's server, the
    image, reproducibility and batch checks; no kernel launches on the
    CPU."""
    import chip_smoke

    params = chip_smoke.serve_params(model_config_overrides=TINY_SANA)
    params.bfloat16 = False
    counts = chip_smoke.phase_serve(params, torch.device("cpu"), "cpu",
                                    px=16, window_ms=2000.0)
    assert set(counts) == {"adaln_layernorm", "dot_product_attention",
                           "linear_attention"}
    assert not any(counts.values())


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device given the port asks for the card, and raises when
    there is none instead of running elsewhere."""
    from yat_tpu_torch.device import resolve_device
    from yat_tpu_torch.frontends.sana import make_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pipeline(_port_params())
    assert resolve_device("cpu") == torch.device("cpu")


def test_generate_cli_writes_pngs(tmp_path):
    import yaml

    from yat_tpu_torch import generate

    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({**RAW, "dataset_seed": "3"}))
    out = tmp_path / "out"
    generate.main(["--config", str(cfg), "--prompt", "a red fox",
                   "--prompt", "a blue bird", "--steps", "2", "--out",
                   str(out), "--device", "cpu"])
    lines = (out / "prompts.txt").read_text().splitlines()
    assert [ln.split("\t")[1] for ln in lines] == ["a red fox", "a blue bird"]
    for ln in lines:
        assert (out / ln.split("\t")[0]).stat().st_size > 0
    # DPM-Solver++(2M) and the velocity cache reach the pipeline; a cache
    # interval below 1 raises
    generate.main(["--config", str(cfg), "--prompt", "x", "--sampler",
                   "dpm", "--steps", "2", "--device", "cpu", "--out",
                   str(out / "dpm")])
    assert (out / "dpm" / "prompts.txt").exists()
    with pytest.raises(ValueError, match=">= 1"):
        generate.main(["--config", str(cfg), "--prompt", "x",
                       "--cache-interval", "0", "--device", "cpu", "--out",
                       str(out)])
