"""PyTorch port, the PixArt-Sigma LoRA training slice on the CPU: the DDPM
schedule's training half and the epsilon loss against ``yat_tpu``; the
port's training step against ``yat_tpu/train/step.py`` on
``PIXART_TINY_TEST`` with the same weights, adapters, batches and draws
(and at 1024 image tokens, where the port's self-attention takes the flash
branch and its plain backward); remat; and the entry point
``yat_tpu_torch.frontends.pixart.main`` end to end (``--device cpu``)."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_pixart import TINY_PIXART
from yat_tpu_torch.convert import load_flax_adapters, load_flax_params
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 modules: reduction order only (MODEL_TOL of test_torch_port_models)
MODEL_TOL = 1e-4
# several optimizer steps of summation-order noise (test_torch_port_train):
# loss and grad_norm to 1e-5 relative, the adapters and EMA to 1e-4
METRIC_RTOL = 1e-5
LEAF_TOL = 1e-4
TARGETS = ["to_q", "to_k", "to_v", "to_out"]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


# ---------------------------------------------------------------------------
# the DDPM schedule's training half and the epsilon loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", ["linear", "scaled_linear",
                                  "squaredcos_cap_v2"])
def test_ddpm_training_half_matches_jax(beta):
    """add_noise (sqrt(abar) rounded to the latents' dtype) and both
    targets against the JAX schedule; the draws' range, dtype and the
    fixed-list choice."""
    from yat_tpu.ops.schedulers import DDPMSchedule as JS
    from yat_tpu_torch.ops.schedulers import DDPMSchedule

    rng = np.random.default_rng(4)
    x, eps = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
              for _ in range(2))
    t = np.array([0, 517, 999], np.int32)
    for pred in ("epsilon", "v_prediction"):
        js = JS(beta_schedule=beta, prediction_type=pred)
        ts = DDPMSchedule(beta_schedule=beta, prediction_type=pred)
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
            jx, je = jnp.asarray(x, jd), jnp.asarray(eps, jd)
            tx, te = (torch.from_numpy(a).to(td) for a in (x, eps))
            for want, got in (
                    (js.add_noise(jx, je, jnp.asarray(t)),
                     ts.add_noise(tx, te, torch.from_numpy(t))),
                    (js.target(jx, je, jnp.asarray(t)),
                     ts.target(tx, te, torch.from_numpy(t)))):
                assert got.dtype == td
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                    atol=1e-6 if td == torch.float32 else 2.0 ** -7,
                    rtol=1e-6 if td == torch.float32 else 2.0 ** -7)
    ts = DDPMSchedule(beta_schedule=beta)
    gen = torch.Generator().manual_seed(0)
    draw = ts.training_draw(gen, 4096)
    assert draw.dtype == torch.int32
    assert int(draw.min()) >= 0 and int(draw.max()) <= 999
    # the logit-normal density's median is t = 500
    assert 450 <= float(draw.float().median()) <= 550
    listed = ts.training_draw(gen, 64, timestep_list=(5, 700))
    assert set(listed.tolist()) == {5, 700}
    jlist = JS().training_draw(jax.random.PRNGKey(0), 64,
                               timestep_list=(5, 700))
    assert set(np.asarray(jlist).tolist()) == {5, 700}


def test_epsilon_loss_refuses_repa():
    """With REPA on, a batch without DINOv2 tokens (feature shards) raises
    at the step; the JAX loss drops the term silently (ROADMAP §3)."""
    from yat_tpu_torch.ops.schedulers import DDPMSchedule
    from yat_tpu_torch.train.tasks import make_epsilon_loss
    loss = make_epsilon_loss(None, DDPMSchedule(), repa_lambda=0.5)
    batch = {"latents": torch.zeros(1, 4, 4, 4),
             "embeddings": torch.zeros(1, 2, 4)}
    with pytest.raises(ValueError, match="no DINOv2 tokens"):
        loss(batch, torch.Generator())


# ---------------------------------------------------------------------------
# the training step against the JAX package's
# ---------------------------------------------------------------------------

def _setup(sample_size=8, hidden=None, layers=None, seed=0):
    """The JAX tiny PixArt (optionally at another latent size and width)
    with LoRA on to_q/to_k/to_v/to_out (random lora_b, so lora_a gets
    gradients too), nonzero modulation tables, and one batch with an empty
    caption."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.models.pixart import PIXART_TINY_TEST, PixArtTransformer2D

    over = {"sample_size": sample_size}
    if hidden is not None:
        over.update(hidden_dim=hidden, attention_head_dim=hidden // 2)
    if layers is not None:
        over["num_layers"] = layers
    cfg = dataclasses.replace(PIXART_TINY_TEST, **over)
    rng = np.random.default_rng(seed)
    b, cap = 4, cfg.max_caption_len
    mask = np.ones((b, cap), np.int32)
    mask[0, 3:] = 0
    mask[2, 6:] = 0
    batch = {
        "latents": rng.standard_normal(
            (b, sample_size, sample_size, cfg.in_channels), np.float32),
        "embeddings": rng.standard_normal((b, cap, cfg.caption_channels),
                                          np.float32),
        "text_mask": mask,
        "empty_embeddings": np.pad(
            rng.standard_normal((1, 2, cfg.caption_channels), np.float32),
            ((0, 0), (0, cap - 2), (0, 0))),
        "empty_text_mask": (np.arange(cap)[None] < 2).astype(np.int32),
    }
    model = PixArtTransformer2D(cfg=cfg, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.asarray(batch["latents"]),
                           jnp.asarray(batch["embeddings"]),
                           jnp.zeros((b,)), jnp.asarray(mask))
    variables = {"params": jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.05 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), a.shape)
        if "table" in path[-1].key else a, variables["params"])}
    adapters, meta = build_adapter_params(
        variables, AdapterSpec("lora", rank=4, alpha=8,
                               target_modules=TARGETS),
        jax.random.PRNGKey(3))
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(0.1 * rng.standard_normal(x.shape),
                                  jnp.float32)
                      if p[-1].key == "lora_b" else x), adapters)
    return cfg, model, variables, adapters, meta, batch


@pytest.fixture(scope="module")
def tiny_setup():
    return _setup()


def _port_model(cfg_j, variables, adapters, meta):
    from yat_tpu_torch.models.pixart import PixArtConfig, PixArtTransformer2D

    cfg = PixArtConfig(**dataclasses.asdict(cfg_j))
    model = PixArtTransformer2D(cfg, dtype=torch.float32)
    load_flax_params(model, jax.tree.map(np.asarray, variables["params"]))
    n = load_flax_adapters(model, jax.tree.map(np.asarray, adapters),
                           jax.tree.map(np.asarray, meta))
    return model, n


def _jax_draws(jsched, rng, latents):
    """The draws of the JAX epsilon loss from its key (tasks.py:146-149)."""
    k_t, k_n, _ = jax.random.split(rng, 3)
    ts = jsched.training_draw(k_t, latents.shape[0])
    noise = jax.random.normal(k_n, latents.shape, jnp.float32)
    return {"timesteps": torch.from_numpy(np.array(ts)),
            "noise": torch.from_numpy(np.array(noise))}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(tiny_setup, accum):
    """Three optimizer steps (six micro-steps with accumulation 2) of the
    port's step on the epsilon loss with the learned-sigma slice against
    the JAX package's jitted step: EMA, warmup, weight decay, the clip and
    unconditional-caption dropout at p = 0.5, on JAX's own draws."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.ops.schedulers import DDPMSchedule as JSchedule
    from yat_tpu.train.state import create_train_state, make_optimizer
    from yat_tpu.train.step import make_train_step as j_make_step
    from yat_tpu.train.tasks import make_epsilon_loss as j_loss
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.ops.schedulers import DDPMSchedule
    from yat_tpu_torch.train.state import Optimizer
    from yat_tpu_torch.train.step import make_train_step
    from yat_tpu_torch.train.tasks import make_epsilon_loss

    cfg_j, jmodel, variables, adapters, meta, batch = tiny_setup
    raw = {"batch_size": "4", "learning_rate": "1e-2", "steps": "3",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "warmup_steps": "2", "weight_decay": "0.01", "use_ema": "",
           "train_unconditional_prob": "0.5",
           "gradient_accumulation_steps": str(accum)}
    tx = make_optimizer(JParams.from_dict({**raw, "urls": []}))
    state = create_train_state(variables["params"], tx, adapters=adapters,
                               adapters_meta=meta, use_ema=True)
    jsched = JSchedule()
    jstep = j_make_step(task_loss=j_loss(jmodel, jsched, learned_sigma=True),
                        tx=tx, ema_decay=0.999, use_ema=True, uncond_prob=0.5,
                        accum_steps=accum, donate=False)

    model, n = _port_model(cfg_j, variables, adapters, meta)
    assert n == 8 * cfg_j.num_layers
    leaves = adapter_parameters(model)
    opt = Optimizer(TrainingParameters.from_dict(raw),
                    [p for _, p in leaves])
    ema = [p.detach().clone() for _, p in leaves]
    step = make_train_step(
        task_loss=make_epsilon_loss(model, DDPMSchedule(),
                                    learned_sigma=True),
        optimizer=opt, ema=ema, ema_decay=0.999, uncond_prob=0.5)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    rng = jax.random.PRNGKey(42)
    uncond_seen = set()
    for _ in range(3 * accum):
        rng, sub = jax.random.split(rng)
        # the draws the JAX step makes from its key (step.py:95-96)
        rng_drop, rng_noise = jax.random.split(sub)
        use = bool(jax.random.bernoulli(rng_drop, 0.5))
        uncond_seen.add(use)
        draws = {"uncond": use,
                 **_jax_draws(jsched, rng_noise, batch["latents"])}
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


def _loss_and_grads_both(setup, seed=7):
    """The epsilon loss and every LoRA gradient of one batch, on the JAX
    package (jax.value_and_grad of its task loss) and on the port, on the
    JAX draws."""
    from yat_tpu.ops.schedulers import DDPMSchedule as JSchedule
    from yat_tpu.train.tasks import make_epsilon_loss as j_loss
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.ops.schedulers import DDPMSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_epsilon_loss

    cfg_j, jmodel, variables, adapters, meta, batch = setup
    jsched = JSchedule()
    jl = j_loss(jmodel, jsched, learned_sigma=True)
    keys = ("latents", "embeddings", "text_mask")
    jbatch = {k: jnp.asarray(batch[k]) for k in keys}
    rng = jax.random.PRNGKey(seed)

    def jfn(ad):
        return jl({"params": variables["params"], "adapters": ad,
                   "adapters_meta": meta}, jbatch, rng, deterministic=False)
    jloss, jgrads = jax.value_and_grad(jfn)(adapters)
    model, _ = _port_model(cfg_j, variables, adapters, meta)
    named = adapter_parameters(model)
    task = make_epsilon_loss(model, DDPMSchedule(), learned_sigma=True)
    tbatch = {k: torch.from_numpy(batch[k]) for k in keys}
    draws = _jax_draws(jsched, rng, batch["latents"])
    loss, grads = loss_and_grads(task, [p for _, p in named], tbatch,
                                 torch.Generator(), draws)
    jflat = dict(_flat(jax.device_get(jgrads)))
    return (float(jloss), jflat, float(loss),
            {n: g for (n, _), g in zip(named, grads)}, model, task, tbatch,
            draws)


def test_loss_and_every_lora_gradient_match_jax(tiny_setup):
    """The epsilon loss with the learned-sigma slice and the gradient of
    every LoRA leaf against jax.value_and_grad of the JAX loss, on its
    draws; every gradient nonzero."""
    jloss, jgrads, loss, grads, *_ = _loss_and_grads_both(tiny_setup)
    np.testing.assert_allclose(loss, jloss, rtol=METRIC_RTOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert bool((g != 0).any()), name
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=MODEL_TOL,
                                   rtol=MODEL_TOL)


def test_flash_branch_step_matches_jax():
    """At sample_size 64 (1024 image tokens, width 32, one block) the port's
    self-attention takes the flash branch, so its backward is K6b's plain
    version; the JAX package takes its XLA branch on the CPU.  The loss
    and every LoRA gradient agree in fp32."""
    from yat_tpu_torch.kernels.build import launch_counts
    from yat_tpu_torch.ops.attention import attention_branch

    setup = _setup(sample_size=64, hidden=32, layers=1, seed=1)
    cfg = setup[0]
    tokens = (cfg.sample_size // cfg.patch_size) ** 2
    assert attention_branch(tokens, tokens, cfg.num_attention_heads,
                            cfg.attention_head_dim) == "flash"
    before = launch_counts()
    jloss, jgrads, loss, grads, *_ = _loss_and_grads_both(setup, seed=3)
    assert launch_counts() == before           # CPU: the plain versions
    np.testing.assert_allclose(loss, jloss, rtol=MODEL_TOL)
    for name, g in grads.items():
        assert bool((g != 0).any()), name
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=MODEL_TOL,
                                   rtol=MODEL_TOL)


def test_remat_gives_the_same_loss_and_gradients(tiny_setup):
    """gradient_checkpointing recomputes each block in the backward: the
    same loss and gradients, bit for bit."""
    from yat_tpu_torch.train.step import loss_and_grads

    *_, loss, grads, model, task, tbatch, draws = _loss_and_grads_both(
        tiny_setup)
    model.gradient_checkpointing = True
    leaves = [p for p in model.parameters() if p.requires_grad]
    loss2, grads2 = loss_and_grads(task, leaves, tbatch, torch.Generator(),
                                   draws)
    assert float(loss2) == loss
    for g, g2 in zip(grads.values(), grads2):
        assert torch.equal(g, g2)


# ---------------------------------------------------------------------------
# the entry point end to end
# ---------------------------------------------------------------------------

def _tiny_shard(path, n=16, lat=(8, 8), lat_c=4, dim=32, lengths=(3, 8)):
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(0)
    with TarShardWriter(str(path)) as w:
        for i in range(n):
            w.write({"__key__": f"{i:06d}", "ratio": "1.0",
                     "latent.npy": rng.standard_normal((*lat, lat_c),
                                                       dtype=np.float32),
                     "emb.npy": rng.standard_normal(
                         (lengths[0] + i % (lengths[1] - lengths[0] + 1),
                          dim), dtype=np.float32)})
    return str(path)


def _write_config(tmp_path, shard, **over):
    import yaml
    cfg = {"local_shard_paths": [shard], "batch_size": "2",
           "learning_rate": "1e-3", "steps": "3", "warmup_steps": "1",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "use_ema": "", "lora_rank": "4", "lora_alpha": "4",
           "lora_algo": "lora", "lora_target_modules": TARGETS,
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": dict(TINY_PIXART)}
    cfg.update(over)
    path = tmp_path / "config.yaml"
    # None drops a key
    path.write_text(yaml.safe_dump({k: v for k, v in cfg.items()
                                    if v is not None}))
    return str(path)


def test_entry_point_trains_and_exports(tmp_path):
    """main(['--config', ..., '--device', 'cpu']) trains 3 steps on a tiny
    shard; the PEFT adapter file reads back through safetensors and the JAX
    package's load_adapter_safetensors, equal to the port's leaves."""
    from safetensors.numpy import load_file

    from yat_tpu.adapters.io import load_adapter_safetensors
    from yat_tpu_torch.adapters.builder import adapter_tree
    from yat_tpu_torch.frontends.pixart import main

    cfg = _write_config(tmp_path, _tiny_shard(tmp_path / "s.tar"))
    trainer = main(["--config", cfg, "--device", "cpu"])
    assert trainer.global_step == 3 and len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert trainer.history[0]["lr"] == 0.0
    path = tmp_path / "out" / "3" / "adapter_model.safetensors"
    adapters, _ = adapter_tree(trainer.model)
    back = load_adapter_safetensors(str(path), like=adapters)
    files = load_file(str(path))
    layers = trainer.pixart_config.num_layers
    # 2 attentions x 4 projections x (lora_A, lora_B) per block
    assert len(files) == 16 * layers
    for (name, want), (_, got) in zip(_flat(adapters), _flat(back)):
        np.testing.assert_array_equal(got, want)
    assert files["base_model.model.blocks_0.attn2.to_out.lora_B.weight"
                 ].shape == (trainer.pixart_config.hidden_dim, 4)
    assert np.abs(adapters["blocks_0"]["attn1"]["to_k"]["lora_b"]).max() > 0


@pytest.mark.parametrize("over,exc,match", [
    pytest.param({"use_repa": "true"}, ValueError, "no DINOv2 tokens",
                 id="use_repa-on-feature-shards"),
    pytest.param({"train_unconditional_prob": "0.1"}, ValueError,
                 "empty-caption", id="over6-ValueError-empty-caption"),
    pytest.param({"pretrained_model_path": "ckpt"}, ValueError,
                 "no denoiser checkpoint was found",
                 id="over7-ValueError-no denoiser checkpoint was found"),
    pytest.param({"lora_pretrained": "a.safetensors"}, FileNotFoundError,
                 "a.safetensors", id="lora_pretrained-missing-file"),
])
def test_entry_point_refuses_unported_options(tmp_path, over, exc, match):
    from yat_tpu_torch.frontends.pixart import main

    cfg = _write_config(tmp_path, _tiny_shard(tmp_path / "s.tar"), **over)
    with pytest.raises(exc, match=match):
        main(["--config", cfg, "--device", "cpu"])


@pytest.mark.parametrize("key", ["use_preservation", "profile_dir",
                                 "full_finetune", "compute_features"])
def test_entry_point_runs_ported_options(tmp_path, monkeypatch, capsys, key):
    """The keys the port once refused run through ``main([...,
    "--device", "cpu"])``: the epsilon-form preservation term once a step,
    a profiler trace (a run of 12 steps ends inside the window of steps
    10-14), full fine-tuning (no adapter spec) of every parameter, stored
    in fp32 under ``bfloat16`` (cast at use), exported as
    ``model.safetensors``, and ``compute_features`` (raw JPEG shards
    encoded on the fly by the tiny KL-VAE and T5)."""
    from yat_tpu_torch.frontends import pixart
    from tests.test_torch_port_encode import make_image_shard

    calls = []
    if key == "use_preservation":
        make = pixart.make_preservation_loss

        def counted(*a, **kw):
            pres = make(*a, **kw)

            def call(*b, **kwb):
                calls.append(1)
                return pres(*b, **kwb)
            return call
        monkeypatch.setattr(pixart, "make_preservation_loss", counted)
    over = {"use_preservation": {"use_preservation": "true"},
            "profile_dir": {"profile_dir": str(tmp_path / "prof"),
                            "steps": "12"},
            "full_finetune": {"lora_rank": None, "lora_algo": None,
                              "lora_target_modules": None,
                              "bfloat16": "true"},
            "compute_features": {
                "local_shard_paths": [make_image_shard(
                    tmp_path / "raw.tar", n=6, hw=(64, 64), wide=False)],
                "compute_features": "true", "vae_max_batch_size": "1",
                "text_encoder_max_batch_size": "2",
                "aspect_ratio": "256"}}[key]
    cfg = _write_config(tmp_path, _tiny_shard(tmp_path / "s.tar"), **over)
    trainer = pixart.main(["--config", cfg, "--device", "cpu"])
    out = capsys.readouterr().out
    if key == "use_preservation":
        assert len(calls) == 3
    elif key == "profile_dir":
        assert "[engine] profiler trace in" in out
        assert len(glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
                   ) == 1
    elif key == "compute_features":
        assert "raw images decode through" in out
        assert trainer.global_step == 3
        assert all(np.isfinite(h["loss"]) for h in trainer.history)
        assert trainer.encode_images.module.encoder is not None
    else:
        leaves = trainer.trainable_leaves()
        assert len(leaves) == len(list(trainer.model.parameters()))
        assert all(p.dtype == torch.float32 for p in leaves)
        assert os.path.exists(tmp_path / "out" / "3" / "model.safetensors")


@pytest.mark.parametrize("key", ["pretrained_model_path",
                                 "pretrained_pipe_path",
                                 "pretrained_pipe_single_file"])
def test_pretrained_paths_name_their_roadmap_item(key, tmp_path):
    """Each of the three pretrained paths, pointing at no checkpoint,
    raises naming the configured paths instead of running random weights
    (loading itself is tests/test_torch_port_pretrained.py)."""
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.common import load_pretrained_backbone
    from yat_tpu_torch.frontends.pixart import build_pixart_config

    params = TrainingParameters()
    setattr(params, key, str(tmp_path / "weights"))
    cfg = build_pixart_config(params)
    with pytest.raises(ValueError, match="no denoiser checkpoint was found"
                       ) as e:
        load_pretrained_backbone(params, "pixart", cfg)
    assert repr(str(tmp_path / "weights")) in str(e.value)


def test_trainer_with_encoders_encodes_empty_caption_and_validates(tmp_path):
    """With tiny T5/KL-VAE encoders and a validation prompt: the empty
    caption is encoded for unconditional dropout, and the DDIM + CFG + PAG
    validation runs once on its cadence on the live model."""
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.pixart import make_trainer

    shard = _tiny_shard(tmp_path / "s.tar", n=8, lat=(2, 2))
    params = TrainingParameters.from_dict({
        "local_shard_paths": [shard], "batch_size": "2",
        "learning_rate": "1e-3", "steps": "2",
        "num_steps_per_validation": "2", "validation_prompts": ["a fox"],
        "train_unconditional_prob": "0.5", "lora_rank": "2",
        "lora_algo": "lora", "lora_target_modules": TARGETS,
        "output_dir": str(tmp_path / "out"),
        "model_config_overrides": {**TINY_PIXART, "sample_size": "2"}})
    trainer = make_trainer(params, device="cpu")
    calls = []
    validate = trainer.validate_fn

    def counted(tr):
        out = validate(tr)
        calls.append({k: v.shape for k, v in out.items()})
        return out
    trainer.validate_fn = counted
    trainer.run()
    assert trainer._empty_raw is not None
    assert trainer._empty_raw.shape[1] == 32
    # resolution 2 x 16 = 32 px: latents [2, 2, 4], the tiny KL-VAE
    # upsamples twice
    assert calls == [{"validation/0/a fox": (4, 4, 3)}]
    assert (tmp_path / "out" / "2" / "adapter_model.safetensors").exists()


# ---------------------------------------------------------------------------
# chip_smoke.py's new phases, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_pixart_grad_reference_phase_on_cpu():
    """chip_smoke.py's PixArt gradient reference with both runs on the CPU
    (two blocks, cut in width for the CPU): the same gradients."""
    import chip_smoke

    chip_smoke.phase_pixart_grad_reference(
        torch.device("cpu"), width={"hidden_dim": 64, "num_attention_heads": 2,
                                    "attention_head_dim": 32,
                                    "caption_channels": 32})


def test_chip_smoke_pixart_train_phase_on_cpu():
    """chip_smoke.py's PixArt train phase at the tiny size on the CPU in
    fp32: the entry point, the rung and loss/adapter/export checks, the
    launch bookkeeping (no launches on the CPU) and the remat step."""
    import chip_smoke

    counts = chip_smoke.phase_pixart_train(
        torch.device("cpu"), "cpu",
        shard_args={"n": 16, "latent": (8, 8, 4), "dim": 32},
        cfg_extra={"batch_size": "2", "bfloat16": None,
                   "model_config_overrides": {
                       k: v for k, v in TINY_PIXART.items()
                       if k != "tiny_encoders"}})
    assert set(counts) >= {"adaln_layernorm", "adaln_layernorm_bwd",
                           "flash_attention", "flash_attention_bwd",
                           "dot_product_attention_folded",
                           "dot_product_attention_folded_bwd",
                           "dot_product_attention",
                           "dot_product_attention_bwd", "attention_xla"}
    assert not any(counts.values())
