"""PyTorch port, training from raw images on the CPU: a 3-step SANA
``compute_features`` run through the entry point against the JAX
trainer's losses on the same weights, raw shard and draws, and
``chip_smoke.py``'s raw-image phase (extraction, training on its shards,
on-the-fly training and its encode-free resume, PixArt-Sigma on the fly,
Dreambooth) rehearsed at the tiny size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

from tests.test_torch_port_encode import (  # noqa: E402,F401
    MODEL_TOL, TINY_PIXART, TINY_SANA, _jax_sana_encoder_trees, _raw,
    jit_flax_init, make_image_shard)

# the training step's loss, as tests/test_torch_port_train.py holds it on
# its batch of 4 x 8 x 8 x 4 latent entries
METRIC_RTOL = 1e-5
STEP_TEST_LATENTS = 4 * 8 * 8 * 4


# ---------------------------------------------------------------------------
# a compute_features run through the entry point against the JAX trainer
# ---------------------------------------------------------------------------

def _jax_draws(key, shape, p_uncond):
    """The draws the JAX step and flow-matching loss make from ``key``
    (step.py's split, tasks.py's three-way split)."""
    from yat_tpu.ops.schedulers import FlowMatchSchedule
    rng_drop, rng_noise = jax.random.split(key)
    use = bool(jax.random.bernoulli(rng_drop, p_uncond))
    k_t, k_n, _ = jax.random.split(rng_noise, 3)
    ts, sig = FlowMatchSchedule(shift=3.0).training_draw(k_t, shape[0])
    noise = jax.random.normal(k_n, shape, jnp.float32)
    return {"uncond": use, "timesteps": torch.from_numpy(np.array(ts)),
            "sigmas": torch.from_numpy(np.array(sig)),
            "noise": torch.from_numpy(np.array(noise))}


def test_compute_features_entry_point_matches_jax_trainer(tmp_path,
                                                          monkeypatch,
                                                          jit_flax_init):
    """3 steps of SANA with ``compute_features`` through
    ``main([... "--device", "cpu"])`` against the JAX trainer on the same
    raw shard: the same denoiser, adapters and encoder weights (the JAX
    trainer's) and the JAX engine's keys' draws.  Every batch the port's
    sampler, encoders and cache deliver to its step (with the empty
    caption of the dropout) equals the JAX trainer's within the encoders'
    1e-4; the step then runs on the JAX batch, and the losses agree to
    the step's tolerance scaled to this batch's size."""
    import yaml

    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.frontends.sana import make_trainer as j_make
    from yat_tpu_torch.convert import load_flax_adapters
    from yat_tpu_torch.frontends import sana
    from yat_tpu_torch.train import engine

    # one bucket: one compiled JAX step and encoder
    shard = make_image_shard(tmp_path / "raw.tar", n=8, wide=False)
    raw = _raw(tmp_path, shard, train_unconditional_prob="0.5",
               validation_prompts=["a tiny fox"],
               num_steps_per_validation="100")
    jt = j_make(JParams.from_dict({**raw, "mesh_shape": {"dp": "1"}}))
    jt.initialize()
    base = jax.tree.map(np.asarray, jt.state.params)
    adapters = jax.tree.map(np.asarray, jt.state.adapters)
    meta = jax.tree.map(np.asarray, jt.state.adapters_meta)
    jsteps = []
    j_step = jt._step_fn

    def recording(state, batch, key):
        state, metrics = j_step(state, batch, key)
        jsteps.append((jax.device_get(batch), key, float(metrics["loss"])))
        return state, metrics
    jt._step_fn = recording
    jt.run()
    assert len(jsteps) == 3

    # the port: the JAX trainer's weights, the JAX engine's keys
    trees = _jax_sana_encoder_trees()
    build_encoders, build_denoiser = sana.build_encoders, sana.build_denoiser
    monkeypatch.setattr(sana, "build_encoders",
                        lambda p, c, d, w=None, images=True: build_encoders(
                            p, c, d, trees, images))

    def denoiser(params, cfg, device, tree=None, store=None, remat=False):
        m = build_denoiser(params, cfg, device, base, store, remat)
        load_flax_adapters(m, adapters, meta)
        return m
    monkeypatch.setattr(sana, "build_denoiser", denoiser)
    tbatches = []
    make_step = engine.make_train_step

    def make(**kw):
        step = make_step(**kw)

        def on_jax_inputs(batch, gen, draws=None):
            jb, key, _ = jsteps[len(tbatches)]
            tbatches.append({k: v.numpy() for k, v in batch.items()})
            # the port's batch is held to the JAX one below (the encoders'
            # 1e-4); the step runs on the JAX one, as the step parity tests
            # do, so the losses differ by the step's arithmetic only
            same = {k: torch.as_tensor(np.asarray(jb[k]), dtype=v.dtype)
                    for k, v in batch.items()}
            return step(same, gen, _jax_draws(key, batch["latents"].shape,
                                              0.5))
        return on_jax_inputs
    monkeypatch.setattr(engine, "make_train_step", make)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    trainer = sana.main(["--config", str(cfg), "--device", "cpu"])

    assert len(trainer.history) == 3
    # the step's tolerance was set on 1024 latent entries; fp32 summation
    # noise grows as the square root of the entries summed, and a batch
    # here holds 2 x 64 x 64 x 32 (losses differ by 4.6e-6 to 1.03e-5)
    n = int(np.prod(tbatches[0]["latents"].shape))
    loss_rtol = METRIC_RTOL * (n / STEP_TEST_LATENTS) ** 0.5
    for (jb, _, jloss), tb, h in zip(jsteps, tbatches, trainer.history):
        for f in ("latents", "embeddings", "text_mask", "empty_embeddings"):
            np.testing.assert_allclose(tb[f], np.asarray(jb[f]),
                                       atol=MODEL_TOL, rtol=MODEL_TOL,
                                       err_msg=f)
        np.testing.assert_allclose(h["loss"], jloss, rtol=loss_rtol)


# ---------------------------------------------------------------------------
# chip_smoke.py's raw-image phase, rehearsed at the tiny size
# ---------------------------------------------------------------------------

def test_chip_smoke_raw_images_phase_on_cpu(monkeypatch):
    """Phase 12 at the tiny size on the CPU: the decoder, the extraction
    through the entry point with signed uploads to the stand-in endpoint,
    training on its shards, the on-the-fly run and its encode-free resume,
    ``configs/pixart_repa.yaml`` (LoKr, REPA) and SANA with generic REPA
    on the fly, and Dreambooth; no kernel launches on the CPU.  The tiny
    KL-VAE takes a third level (compression 4): PixArt's 256 px images
    then give 64x64 latents, where the two-level VAE's 128x128 grid makes
    its mid-block attention 16384 tokens long on the CPU."""
    import dataclasses

    import chip_smoke
    from yat_tpu_torch.models import vae

    monkeypatch.setattr(vae, "KLVAE_TINY_TEST", dataclasses.replace(
        vae.KLVAE_TINY_TEST, block_out_channels=(32, 32, 32)))

    counts = chip_smoke.phase_raw_images(
        torch.device("cpu"), "cpu",
        tiny={"sana": TINY_SANA, "pixart": TINY_PIXART, "resolution": 256,
              "batch": 2, "chunk": 1, "per_bucket": 4})
    assert set(counts) == {"raw_sana", "raw_pixart", "raw_sana_repa"}
    assert not any(v for c in counts.values() for v in c.values())
