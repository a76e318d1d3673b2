"""PyTorch port, the SANA LoRA training slice on the CPU: the port's
training step against ``yat_tpu/train/step.py`` on ``SANA_TINY_TEST`` with
the same weights, adapters, batches and draws; the data plane against the
JAX package's sampler on the same shards; and the entry point
``yat_tpu_torch.frontends.sana.main`` end to end (``--device cpu``)."""

import glob
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yat_tpu_torch.convert import load_flax_adapters, load_flax_params
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 on the CPU: several optimizer steps of summation-order noise.
# loss and grad_norm agree to 1e-5 relative; the adapters and EMA after
# the steps to 1e-4
METRIC_RTOL = 1e-5
LEAF_TOL = 1e-4
TARGETS = ["to_q", "to_k", "to_v", "to_out"]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def _raw(**over):
    raw = {"batch_size": "4", "learning_rate": "1e-2", "steps": "3",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "warmup_steps": "2", "weight_decay": "0.01", "use_ema": "",
           "train_unconditional_prob": "0.5"}
    raw.update(over)
    return raw


@pytest.fixture(scope="module")
def tiny_setup():
    """The JAX tiny SANA with LoRA on to_q/to_k/to_v/to_out (random
    lora_b, so lora_a gets gradients too) and one batch with an empty
    caption, built once."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.models.sana import SANA_TINY_TEST, SanaTransformer2D

    cfg = SANA_TINY_TEST
    rng = np.random.default_rng(0)
    b, cap = 4, 12
    mask = np.ones((b, cap), np.int32)
    mask[0, 5:] = 0
    mask[2, 9:] = 0
    batch = {
        "latents": rng.standard_normal(
            (b, cfg.sample_size, cfg.sample_size, cfg.in_channels),
            np.float32),
        "embeddings": rng.standard_normal((b, cap, cfg.caption_channels),
                                          np.float32),
        "text_mask": mask,
        "empty_embeddings": np.pad(
            rng.standard_normal((1, 3, cfg.caption_channels), np.float32),
            ((0, 0), (0, cap - 3), (0, 0))),
        "empty_text_mask": (np.arange(cap)[None] < 3).astype(np.int32),
    }
    model = SanaTransformer2D(cfg=cfg, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.asarray(batch["latents"]),
                           jnp.asarray(batch["embeddings"]),
                           jnp.zeros((b,)), jnp.asarray(mask))
    adapters, meta = build_adapter_params(
        variables, AdapterSpec("lora", rank=4, alpha=8,
                               target_modules=TARGETS),
        jax.random.PRNGKey(3))
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(0.1 * rng.standard_normal(x.shape),
                                  jnp.float32)
                      if p[-1].key == "lora_b" else x), adapters)
    return cfg, model, variables, adapters, meta, batch


def _port_model(cfg_j, variables, adapters, meta):
    import dataclasses

    from yat_tpu_torch.models.sana import SanaConfig, SanaTransformer2D

    cfg = SanaConfig(**dataclasses.asdict(cfg_j))
    model = SanaTransformer2D(cfg, dtype=torch.float32)
    load_flax_params(model, jax.tree.map(np.asarray, variables["params"]))
    n = load_flax_adapters(model, jax.tree.map(np.asarray, adapters),
                           jax.tree.map(np.asarray, meta))
    return model, n


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(tiny_setup, accum):
    """Three optimizer steps (six micro-steps with accumulation 2) of the
    port's step against the JAX package's jitted step: EMA, warmup (the
    first update at lr 0), weight decay, the global-norm clip and
    unconditional-caption dropout at p = 0.5, on JAX's own draws."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JSchedule
    from yat_tpu.train.state import create_train_state, make_optimizer
    from yat_tpu.train.step import make_train_step as j_make_step
    from yat_tpu.train.tasks import make_flow_matching_loss as j_loss
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    from yat_tpu_torch.train.state import Optimizer
    from yat_tpu_torch.train.step import make_train_step
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    cfg_j, jmodel, variables, adapters, meta, batch = tiny_setup
    raw = _raw(gradient_accumulation_steps=str(accum))
    jparams = JParams.from_dict({**raw, "urls": []})
    tx = make_optimizer(jparams)
    state = create_train_state(variables["params"], tx, adapters=adapters,
                               adapters_meta=meta, use_ema=True)
    jsched = JSchedule(shift=3.0)
    jstep = j_make_step(task_loss=j_loss(jmodel, jsched), tx=tx,
                        ema_decay=0.999, use_ema=True, uncond_prob=0.5,
                        accum_steps=accum, donate=False)

    model, n = _port_model(cfg_j, variables, adapters, meta)
    assert n == 2 * 4 * cfg_j.num_layers
    params = TrainingParameters.from_dict(raw)
    leaves = adapter_parameters(model)
    opt = Optimizer(params, [p for _, p in leaves])
    ema = [p.detach().clone() for _, p in leaves]
    step = make_train_step(
        task_loss=make_flow_matching_loss(model, FlowMatchSchedule(shift=3.0)),
        optimizer=opt, ema=ema, ema_decay=0.999, uncond_prob=0.5)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    rng = jax.random.PRNGKey(42)
    b = batch["latents"].shape[0]
    uncond_seen = set()
    for _ in range(3 * accum):
        rng, sub = jax.random.split(rng)
        # the draws the JAX step makes from its key (step.py:95-96,
        # tasks.py:88-91)
        rng_drop, rng_noise = jax.random.split(sub)
        use = bool(jax.random.bernoulli(rng_drop, 0.5))
        k_t, k_n, _ = jax.random.split(rng_noise, 3)
        ts, sig = jsched.training_draw(k_t, b)
        noise = jax.random.normal(k_n, batch["latents"].shape, jnp.float32)
        uncond_seen.add(use)
        draws = {"uncond": use, "timesteps": torch.from_numpy(np.array(ts)),
                 "sigmas": torch.from_numpy(np.array(sig)),
                 "noise": torch.from_numpy(np.array(noise))}
        state, jm = jstep(state, jbatch, sub)
        tm = step(tbatch, torch.Generator().manual_seed(0), draws)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=METRIC_RTOL)
    assert uncond_seen == {True, False}, "both dropout branches ran"
    assert opt.count == 3

    want = dict(_flat(jax.device_get(state.adapters)))
    want_ema = dict(_flat(jax.device_get(state.ema)))
    for (name, p), e in zip(leaves, ema):
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   atol=LEAF_TOL, rtol=LEAF_TOL)
        np.testing.assert_allclose(e.numpy(), want_ema[name], atol=LEAF_TOL,
                                   rtol=LEAF_TOL)


def test_every_lora_leaf_gets_a_gradient(tiny_setup):
    """Gradients reach every LoRA leaf through the three autograd.Functions
    (adaLN, softmax and linear attention) on the CPU path."""
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    cfg_j, _, variables, adapters, meta, batch = tiny_setup
    model, _ = _port_model(cfg_j, variables, adapters, meta)
    leaves = [p for _, p in adapter_parameters(model)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = loss_and_grads(
        make_flow_matching_loss(model, FlowMatchSchedule(shift=3.0)),
        leaves, tb, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert all(bool((g != 0).any()) for g in grads)
    # remat recomputes each block in the backward: same loss and grads
    model.gradient_checkpointing = True
    loss2, grads2 = loss_and_grads(
        make_flow_matching_loss(model, FlowMatchSchedule(shift=3.0)),
        leaves, tb, torch.Generator().manual_seed(0))
    assert torch.equal(loss, loss2)
    for g, g2 in zip(grads, grads2):
        assert torch.equal(g, g2)


def test_grad_reference_accounts_for_flipped_relu_kinks(tiny_setup):
    """chip_smoke.py's gradient reference, on two CPU runs that differ only
    in the side of 0 on which four ReLU(q) pre-activations of block 0's
    linear attention lie (±1e-30): the flips' share added to the first
    run's LoRA gradients gives the second run's within 1e-5 of each leaf's
    largest entry (fp32 runs), while the raw gradients of to_q differ by
    more than 1e-3 of it."""
    import chip_smoke
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    cfg_j, _, variables, adapters, meta, batch = tiny_setup
    model, _ = _port_model(cfg_j, variables, adapters, meta)
    attn = model.blocks[0].attn1
    leaves = [p for _, p in adapter_parameters(model)]
    names = [n for n, _ in adapter_parameters(model)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    picked = torch.zeros(4 * 64 * 64, dtype=torch.bool)
    picked[[5, 1000, 4000, 9000]] = True

    def run(side):
        def place(module, inputs, out):
            at = picked.reshape(out.shape)
            # the value ``side`` there, the gradient passed on to ``out``
            return torch.where(at, side + (out - out.detach()), out)
        seen = {}
        hooks = [attn.to_q.register_forward_hook(place)]
        hooks += chip_smoke._relu_input_hooks(attn, seen)
        loss, grads = loss_and_grads(
            make_flow_matching_loss(model, FlowMatchSchedule(shift=3.0)),
            leaves, tb, torch.Generator().manual_seed(0))
        for h in hooks:
            h.remove()
        return dict(zip(names, grads)), seen

    grads_a, seen_a = run(-1e-30)
    grads_b, seen_b = run(1e-30)
    expected, flips = chip_smoke.with_flips_share(
        attn, "blocks_0.attn1", grads_a, seen_a, seen_b)
    assert flips == {"to_q": 4, "to_k": 0}
    for name, gb in grads_b.items():
        scale = float(gb.abs().max())
        fixed = float((gb.double() - expected[name]).abs().max())
        assert fixed <= 1e-5 * scale, name
        if name.startswith("blocks_0.attn1.to_q"):
            assert float((gb - grads_a[name]).abs().max()) > 1e-3 * scale


def test_lr_schedule_and_clip_match_optax():
    """The schedule at the pre-increment count (warmup: lr 0 first), the
    cyclic mode, and the clip's (g / norm) * max_norm."""
    import optax

    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.train.state import make_lr_schedule as j_sched
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.train.state import make_lr_schedule

    for over in ({"warmup_steps": "3"}, {},
                 {"cyclic_lr_max_lr": "1e-2", "cyclic_lr_step_size_up": "3",
                  "cyclic_lr_step_size_down": "2", "warmup_steps": "2"}):
        raw = _raw(**over)
        js = j_sched(JParams.from_dict({**raw, "urls": []}))
        ts = make_lr_schedule(TrainingParameters.from_dict(raw))
        for step in range(12):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)
    g = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    for scale in (0.01, 10.0):
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g * scale)], None)
        from yat_tpu_torch.train.state import global_norm
        t = torch.from_numpy(g * scale)
        norm = global_norm([t])
        got = t if bool(norm < 1.0) else (t / norm) * 1.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want[0]),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the data plane
# ---------------------------------------------------------------------------

def _write_shards(tmp_path, n_shards=2, per=10, dim=8, lat_c=4):
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(5)
    paths = []
    for s in range(n_shards):
        p = str(tmp_path / f"shard-{s:06d}.tar")
        with TarShardWriter(p) as w:
            for i in range(per):
                ratio = "1.0" if (i + s) % 3 else "0.5"
                hw = (4, 4) if ratio == "1.0" else (4, 8)
                w.write({"__key__": f"{s}{i:05d}", "ratio": ratio,
                         "latent.npy": rng.standard_normal(
                             (*hw, lat_c), dtype=np.float32),
                         "emb.npy": rng.standard_normal(
                             (100 + 37 * ((i * 7 + s) % 11), dim),
                             dtype=np.float32)})
        paths.append(p)
    return paths


def test_data_plane_matches_jax_sampler(tmp_path):
    """The port's FeatureBucketSampler over LocalShardSource yields the JAX
    package's batches, in its order, from the same shards and seed:
    caption rungs and bucket_repeat included."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.frontends.common import build_feature_sampler as j_build
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.common import build_feature_sampler

    paths = _write_shards(tmp_path)
    raw = _raw(local_shard_paths=paths, batch_size="3", dataset_seed="7",
               caption_length_bucketing="true", bucket_repeat="2")
    js = j_build(JParams.from_dict(raw), 512)
    ts = build_feature_sampler(TrainingParameters.from_dict(raw), 512)
    rungs = set()
    for jb, tb in itertools.islice(zip(js, ts), 12):
        assert jb.ratio == tb.ratio
        for key in ("latents", "embeddings", "text_mask"):
            np.testing.assert_array_equal(getattr(jb, key), getattr(tb, key))
        rungs.add(tb.embeddings.shape[1])
    assert len(rungs) > 1 and rungs <= {128, 256, 384, 512}


# ---------------------------------------------------------------------------
# the entry point end to end
# ---------------------------------------------------------------------------

TINY_OVERRIDES = {"hidden_dim": "32", "num_layers": "1",
                  "num_attention_heads": "1", "attention_head_dim": "32",
                  "num_cross_attention_heads": "1",
                  "cross_attention_head_dim": "32", "caption_channels": "16",
                  "max_caption_len": "8", "in_channels": "4",
                  "sample_size": "8", "mlp_ratio": "1.0"}


def _tiny_shard(path, n=24, lat=(8, 8), lat_c=4, dim=16, ratios=True):
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(0)
    with TarShardWriter(str(path)) as w:
        for i in range(n):
            ratio = "1.0" if (i % 3 or not ratios) else "0.5"
            hw = lat if ratio == "1.0" else (lat[0], 2 * lat[1])
            w.write({"__key__": f"{i:06d}", "ratio": ratio,
                     "latent.npy": rng.standard_normal((*hw, lat_c),
                                                       dtype=np.float32),
                     "emb.npy": rng.standard_normal((5 + i % 4, dim),
                                                    dtype=np.float32)})
    return str(path)


def _write_config(tmp_path, shard, **over):
    import yaml
    cfg = {"local_shard_paths": [shard], "batch_size": "2",
           "learning_rate": "1e-3", "steps": "3", "warmup_steps": "1",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "use_ema": "", "lora_rank": "4", "lora_alpha": "4",
           "lora_algo": "lora", "lora_target_modules": TARGETS,
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": dict(TINY_OVERRIDES)}
    cfg.update(over)
    path = tmp_path / "config.yaml"
    # None drops a key
    path.write_text(yaml.safe_dump({k: v for k, v in cfg.items()
                                    if v is not None}))
    return str(path)


def test_entry_point_trains_and_exports(tmp_path):
    """main(['--config', ..., '--device', 'cpu']) trains 3 steps on a tiny
    shard; the adapter file reads back through safetensors and through the
    JAX package's load_adapter_safetensors, equal to the port's leaves."""
    from safetensors.numpy import load_file

    from yat_tpu.adapters.io import load_adapter_safetensors
    from yat_tpu_torch.adapters.builder import adapter_tree
    from yat_tpu_torch.adapters.io import read_safetensors
    from yat_tpu_torch.frontends.sana import main

    cfg = _write_config(tmp_path, _tiny_shard(tmp_path / "s.tar"))
    trainer = main(["--config", cfg, "--device", "cpu"])
    assert trainer.global_step == 3 and len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert trainer.history[0]["lr"] == 0.0
    path = tmp_path / "out" / "3" / "adapter_model.safetensors"
    adapters, _ = adapter_tree(trainer.model)
    back = load_adapter_safetensors(str(path), like=adapters)
    files = load_file(str(path))
    ours, meta = read_safetensors(str(path))
    # 2 attentions x 4 projections x (lora_A, lora_B)
    assert set(files) == set(ours) and len(files) == 16
    assert "yat_meta" in meta
    for (name, want), (_, got) in zip(_flat(adapters), _flat(back)):
        np.testing.assert_array_equal(got, want)
    for key, arr in files.items():
        np.testing.assert_array_equal(ours[key], arr)
    assert files["base_model.model.blocks_0.attn1.to_q.lora_A.weight"
                 ].shape == (4, 32)
    # lora_b moved off zero after the first update with lr > 0
    assert np.abs(adapters["blocks_0"]["attn2"]["to_v"]["lora_b"]).max() > 0


@pytest.mark.parametrize("over,exc,match", [
    pytest.param({"train_unconditional_prob": "0.5"}, ValueError,
                 "empty-caption", id="over2-ValueError-empty-caption"),
    pytest.param({"pretrained_model_path": "ckpt"}, ValueError,
                 "no denoiser checkpoint was found",
                 id="over5-ValueError-no denoiser checkpoint was found"),
    pytest.param({"lora_pretrained": "a.safetensors"}, FileNotFoundError,
                 "a.safetensors", id="lora_pretrained-missing-file"),
    pytest.param({"use_repa": "true"}, ValueError, "no DINOv2 tokens",
                 id="use_repa-on-feature-shards"),
    pytest.param({"lora_rank": None, "lora_algo": None,
                  "unfreeze_modules": ["blocks_9"]}, ValueError,
                 "matched no parameter", id="unfreeze_modules-matching-none"),
])
def test_entry_point_refuses_unported_options(tmp_path, over, exc, match):
    from yat_tpu_torch.frontends.sana import main

    cfg = _write_config(tmp_path, _tiny_shard(tmp_path / "s.tar"), **over)
    with pytest.raises(exc, match=match):
        main(["--config", cfg, "--device", "cpu"])


def _ported_effect(key, tmp_path, trainer, out, counts):
    """What each formerly refused key does in a run of 3 steps."""
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.frontends.sana import build_denoiser

    if key == "checkpoint_dir":
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["1.pt", "2.pt",
                                                         "3.pt"]
    elif key == "resume":
        assert "resumed from step 3" in out and trainer.global_step == 5
        assert len(trainer.history) == 2
    elif key == "exploration_steps":
        # one search of 2 candidates a step
        assert counts == {"explore": 3}
    elif key == "unfreeze_modules":
        init = flax_params(build_denoiser(trainer.params,
                                          trainer.sana_config, "cpu"))
        moved = {k for k, v in flax_params(trainer.model).items()
                 if not torch.equal(v, init[k])}
        assert moved and all(k.startswith("blocks_0.attn2.") for k in moved)
    elif key == "use_preservation":
        assert counts == {"preservation": 3}
    elif key == "compute_features":
        assert "raw images decode through" in out
        assert trainer.global_step == 3
        assert all(np.isfinite(h["loss"]) for h in trainer.history)
        assert trainer.encode_images.module.encoder is not None
    else:
        assert len(glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
                   ) == 1


@pytest.mark.parametrize("key", ["checkpoint_dir", "resume",
                                 "exploration_steps", "unfreeze_modules",
                                 "use_preservation", "profile_dir",
                                 "compute_features"])
def test_entry_point_runs_ported_options(tmp_path, monkeypatch, capsys, key):
    """The keys the port once refused run through ``main([...,
    "--device", "cpu"])`` and do what they say: checkpoints on the
    validation cadence, a resume from them, a best-of-2 search a step,
    only ``attn2`` (a path segment) trained under full fine-tuning, the
    preservation term a step, a profiler trace (a run of 12 steps ends
    inside the window of steps 10-14), and ``compute_features`` (raw JPEG
    shards encoded on the fly by the tiny DC-AE and Gemma-2)."""
    from yat_tpu_torch.frontends.sana import main
    from tests.test_torch_port_encode import make_image_shard
    from yat_tpu_torch.train import step as step_module

    counts = {}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(step_module, "explore",
                        counted("explore", step_module.explore))
    ckpt = {"checkpoint_dir": str(tmp_path / "ckpt"),
            "num_steps_per_validation": "1"}
    over = {"checkpoint_dir": ckpt,
            "exploration_steps": {"exploration_steps": "2"},
            "unfreeze_modules": {"lora_rank": None, "lora_algo": None,
                                 "unfreeze_modules": ["attn2"]},
            "use_preservation": {"use_preservation": "true"},
            "profile_dir": {"profile_dir": str(tmp_path / "prof"),
                            "steps": "12"},
            "compute_features": {
                "local_shard_paths": [make_image_shard(
                    tmp_path / "raw.tar", n=6, hw=(64, 64), wide=False)],
                "compute_features": "true", "vae_max_batch_size": "1",
                "text_encoder_max_batch_size": "2", "aspect_ratio": "256",
                "model_config_overrides": {
                    **TINY_OVERRIDES, "in_channels": "32",
                    "caption_channels": "32", "vae_compression": "4",
                    "tiny_encoders": "1"}}}.get(key, {})
    shard = _tiny_shard(tmp_path / "s.tar")
    if key == "resume":
        main(["--config", _write_config(tmp_path, shard, **ckpt),
              "--device", "cpu"])
        capsys.readouterr()
        over = dict(ckpt, resume="true", steps="5")
    if key == "use_preservation":
        from yat_tpu_torch.frontends import sana
        make = sana.make_preservation_loss
        monkeypatch.setattr(sana, "make_preservation_loss",
                            lambda *a, **kw: counted("preservation",
                                                     make(*a, **kw)))
    trainer = main(["--config", _write_config(tmp_path, shard, **over),
                    "--device", "cpu"])
    _ported_effect(key, tmp_path, trainer, capsys.readouterr().out, counts)


@pytest.mark.parametrize("key", ["pretrained_model_path",
                                 "pretrained_pipe_path",
                                 "pretrained_pipe_single_file"])
def test_pretrained_paths_name_their_roadmap_item(key, tmp_path):
    """Each of the three pretrained paths, pointing at no checkpoint,
    raises naming the configured paths instead of running random weights
    (loading itself is tests/test_torch_port_pretrained.py)."""
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.common import load_pretrained_backbone
    from yat_tpu_torch.frontends.sana import build_sana_config

    params = TrainingParameters()
    setattr(params, key, str(tmp_path / "weights"))
    cfg = build_sana_config(params)
    with pytest.raises(ValueError, match="no denoiser checkpoint was found"
                       ) as e:
        load_pretrained_backbone(params, "sana", cfg)
    assert repr(str(tmp_path / "weights")) in str(e.value)


def test_trainer_with_encoders_encodes_empty_caption_and_validates(tmp_path):
    """With tiny encoders and a validation prompt: the empty caption is
    encoded for unconditional dropout, and validation runs once on its
    cadence."""
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.sana import make_trainer

    over = {**TINY_OVERRIDES, "caption_channels": "32", "in_channels": "32",
            "sample_size": "4", "tiny_encoders": "1"}
    shard = _tiny_shard(tmp_path / "s.tar", n=8, lat=(4, 4), lat_c=32,
                        dim=32, ratios=False)
    params = TrainingParameters.from_dict({
        "local_shard_paths": [shard], "batch_size": "2",
        "learning_rate": "1e-3", "steps": "2",
        "num_steps_per_validation": "2", "validation_prompts": ["a fox"],
        "train_unconditional_prob": "0.5", "lora_rank": "2",
        "lora_algo": "lora", "lora_target_modules": TARGETS,
        "output_dir": str(tmp_path / "out"),
        "model_config_overrides": over})
    trainer = make_trainer(params, device="cpu")
    calls = []
    validate = trainer.validate_fn

    def counted(tr):
        out = validate(tr)
        calls.append(sorted(out))
        return out
    trainer.validate_fn = counted
    trainer.run()
    assert trainer._empty_raw is not None and trainer._empty_raw.shape[1] == 32
    assert calls == [["validation/0/a fox"]]
    assert (tmp_path / "out" / "2" / "adapter_model.safetensors").exists()


def test_chip_smoke_grad_reference_phase_on_cpu():
    """chip_smoke.py's gradient reference phase with both runs on the CPU
    (two full-width SANA blocks): the same gradients, no flipped kinks."""
    import chip_smoke

    chip_smoke.phase_grad_reference(torch.device("cpu"))


def test_chip_smoke_train_phase_on_cpu():
    """chip_smoke.py's train phase, rehearsed at the tiny size on the CPU
    in fp32: the entry point, the loss/adapter/export checks, the launch
    bookkeeping (no launches on the CPU) and the remat step."""
    import chip_smoke

    counts = chip_smoke.phase_train(
        torch.device("cpu"), "cpu",
        shard_args={"n": 24, "latent": (8, 8, 4), "dim": 16,
                    "lengths": (3, 8)},
        cfg_extra={"batch_size": "4", "bfloat16": None,
                   "model_config_overrides": dict(TINY_OVERRIDES)})
    assert set(counts) == {"adaln_layernorm", "dot_product_attention",
                           "linear_attention", "adaln_layernorm_bwd",
                           "dot_product_attention_bwd"}
    assert not any(counts.values())
