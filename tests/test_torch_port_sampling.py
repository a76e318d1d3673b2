"""PyTorch port, the rest of sampling on the CPU: DPM-Solver++(2M) in its
epsilon and flow forms, the cached-velocity Euler sampler and refiner
timestep gating against ``yat_tpu/ops/sampling.py`` on an analytic
denoiser; the sampler and velocity-cache gates against the JAX package's;
the SANA and PixArt-Sigma pipelines with those samplers against the JAX
``ValidationPipeline``; the trainer's EMA validation and its
``validation_cache_interval`` key; ``decode_tiled`` against the JAX
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_frontends import TINY_DIT, write_shard
from tests.test_torch_port_encode import jitted_flax_init
from tests.test_validation_frontends import base
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 samplers over an analytic denoiser: summation order only
SAMPLER_TOL = 1e-5
# images in [0, 1] after fp32 sampling and an fp32 decode (IMAGE_TOL of
# tests/test_torch_port_serve.py)
IMAGE_TOL = 1e-3
# fp32 decodes of the same tiles (the decoders' MODEL_TOL is 1e-4; a tiled
# decode feathers fp32 images)
TILE_TOL = 2e-5
TARGETS = ["to_q", "to_k", "to_v", "to_out"]
SHAPE = (2, 4, 4, 3)


def _x0(shape=SHAPE):
    from yat_tpu.ops.sampling import seed_noise
    return np.array(seed_noise(42, (1, *shape[1:])))


def _analytic(flow: bool):
    """A denoiser affine in x and t, plus a gated term: the JAX form
    ``(x, t, gate)`` and the port's ``(x, t)`` reading the gate that
    ``set_gate`` holds."""
    a = np.linspace(-0.6, 0.4, SHAPE[-1]).astype(np.float32)
    c = np.float32(0.3)
    scale = np.float32(1000.0)

    def j_fn(x, t, gate):
        tt = t.astype(jnp.float32)[:, None, None, None] / scale
        return jnp.asarray(a) * x + 0.5 * tt + c * gate

    held = {"gate": None}

    def t_fn(x, t):
        tt = t.float()[:, None, None, None] / scale
        g = 1.0 if held["gate"] is None else held["gate"]
        return torch.from_numpy(a) * x + 0.5 * tt + c * g

    return j_fn, t_fn, held


def _active(flow: bool, num_steps: int):
    """Every other timestep of the ladder, as integers."""
    if flow:
        from yat_tpu.ops.schedulers import FlowMatchSchedule
        s = np.asarray(FlowMatchSchedule(shift=3.0).inference_sigmas(
            num_steps))[:-1]
        ts = np.round(s * np.float32(1000.0)).astype(np.int64)
    else:
        ts = np.asarray(jnp.linspace(999, 0, num_steps + 1).astype(
            jnp.int32))[:-1]
    return [int(t) for t in ts[::2]]


def _run(j_sampler, t_sampler, flow, num_steps, gated, **kw):
    from yat_tpu.ops.schedulers import DDPMSchedule as JD
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JF
    from yat_tpu_torch.ops.schedulers import DDPMSchedule, FlowMatchSchedule

    j_fn, t_fn, held = _analytic(flow)
    active = _active(flow, num_steps) if gated else None
    js = JF(shift=3.0) if flow else JD()
    ts = FlowMatchSchedule(shift=3.0) if flow else DDPMSchedule()
    want = j_sampler(j_fn, SHAPE, js, num_steps, 42,
                     active_timesteps=active, **kw)
    gates = []

    def set_gate(g):
        held["gate"] = g
        gates.append(g)

    got = t_sampler(t_fn, SHAPE, ts, num_steps, 42,
                    x0=torch.from_numpy(_x0()), active_timesteps=active,
                    set_gate=set_gate, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLER_TOL, rtol=SAMPLER_TOL)
    if gated:
        assert gates[-1] is None and {0.0, 1.0} <= set(gates[:-1]) \
            or num_steps == 1
    else:
        assert not gates
    return got


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("num_steps", [1, 2, 10, 20])
@pytest.mark.parametrize("flow", [False, True])
def test_dpm_solver_2m_matches_jax(flow, num_steps, gated):
    """DPM-Solver++(2M), epsilon and flow forms: the integer ladder, the
    1e-6/1e-8 guards and the first-order final step, gated and not."""
    from yat_tpu.ops import sampling as JS
    from yat_tpu_torch.ops import sampling as TS

    if flow:
        _run(JS.sample_dpm_solver_2m_flow, TS.sample_dpm_solver_2m_flow,
             True, num_steps, gated)
    else:
        _run(JS.sample_dpm_solver_2m, TS.sample_dpm_solver_2m, False,
             num_steps, gated)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("interval", [1, 2, 3])
def test_cached_euler_matches_jax(interval, gated):
    """The cached-velocity Euler sampler at intervals 1 (plain Euler), 2
    and 3 over 20 steps, gated and not; the model runs on the JAX mask's
    steps only."""
    from yat_tpu.ops import sampling as JS
    from yat_tpu_torch.ops import sampling as TS

    assert TS.cache_eval_mask(20, interval) == JS._cache_eval_mask(
        20, interval)
    calls = []
    j_fn, t_fn, held = _analytic(True)

    def counting(x, t):
        calls.append(1)
        return t_fn(x, t)

    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    TS.sample_flow_match_cached(counting, SHAPE, FlowMatchSchedule(shift=3.0),
                                20, 42, x0=torch.from_numpy(_x0()),
                                cache_interval=interval)
    assert len(calls) == sum(JS._cache_eval_mask(20, interval))
    assert len(calls) == {1: 20, 2: 12, 3: 9}[interval]
    _run(JS.sample_flow_match_cached, TS.sample_flow_match_cached, True, 20,
         gated, cache_interval=interval)


@pytest.mark.parametrize("flow", [False, True])
def test_gated_euler_and_ddim_match_jax(flow):
    """The refiner gate on the default ladders (Euler, DDIM)."""
    from yat_tpu.ops import sampling as JS
    from yat_tpu_torch.ops import sampling as TS

    if flow:
        _run(JS.sample_flow_match, TS.sample_flow_match, True, 10, True)
    else:
        _run(JS.sample_ddim, TS.sample_ddim, False, 10, True)
    assert TS.timestep_gate(torch.tensor(750.4), [750]) == 1.0
    assert TS.timestep_gate(torch.tensor(750.5), [751]) == 0.0   # to even
    assert TS.int_ladder(999, 21) == [
        int(t) for t in np.asarray(jnp.linspace(999, 0, 21).astype(
            jnp.int32))]


def test_gate_needs_its_setter():
    from yat_tpu_torch.ops import sampling as TS
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule

    with pytest.raises(ValueError, match="set_gate"):
        TS.sample_flow_match(lambda x, t: x, SHAPE,
                             FlowMatchSchedule(shift=3.0), 2, 42,
                             x0=torch.from_numpy(_x0()),
                             active_timesteps=[1000])


# ---------------------------------------------------------------------------
# the sampler and velocity-cache gates
# ---------------------------------------------------------------------------

def _gate_case(case):
    """(JAX pipeline, port pipeline, call) for one gate case."""
    from yat_tpu.ops.schedulers import DDPMSchedule as JD
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JF
    from yat_tpu.train import validation as JV
    from yat_tpu_torch.ops.schedulers import DDPMSchedule, FlowMatchSchedule
    from yat_tpu_torch.train import validation as TV

    flow = case != "cache_ddpm"
    gated = case == "cache_gated"
    kw = dict(latent_shape=(4, 4, 3), encode_prompts=None,
              active_timesteps=[1000] if gated else None)
    jvp = JV.ValidationPipeline(None, JF() if flow else JD(), **kw)
    tvp = TV.ValidationPipeline(None, FlowMatchSchedule() if flow
                                else DDPMSchedule(), **kw)
    if case == "cache_dpm":
        JV.set_sampler(jvp, "dpm")
        TV.set_sampler(tvp, "dpm")
    if case == "unknown_sampler":
        return jvp, tvp, lambda V, vp: V.set_sampler(vp, "heun")
    if case == "interval_0":
        return jvp, tvp, lambda V, vp: V.set_cache_interval(vp, 0)
    if case == "cache_euler":
        return jvp, tvp, lambda V, vp: V.set_cache_interval(vp, 2)
    return jvp, tvp, lambda V, vp: V.set_cache_interval(vp, 2)


@pytest.mark.parametrize("case", ["cache_ddpm", "cache_dpm", "cache_gated",
                                  "unknown_sampler", "interval_0",
                                  "cache_euler"])
def test_sampler_gates_match_jax(case):
    """The cache on DDPM, with dpm and with gating, an unknown sampler and
    an interval below 1 raise in both packages, with the same message; the
    cache on flow-match Euler is accepted by both."""
    from yat_tpu.train import validation as JV
    from yat_tpu_torch.train import validation as TV

    jvp, tvp, call = _gate_case(case)
    outcomes = []
    for V, vp in ((JV, jvp), (TV, tvp)):
        try:
            call(V, vp)
            outcomes.append(("ok", vp.cache_interval))
        except ValueError as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[0] == outcomes[1], outcomes
    assert (outcomes[0][0] == "ok") == (case == "cache_euler")


# ---------------------------------------------------------------------------
# the pipelines against the JAX package
# ---------------------------------------------------------------------------

TINY_SANA = {**TINY_DIT, "caption_channels": "32",
             "num_cross_attention_heads": "2",
             "cross_attention_head_dim": "16", "in_channels": "32",
             "out_channels": "32", "sample_size": "4", "tiny_encoders": "1"}
TINY_PIXART = {**TINY_DIT, "caption_channels": "32", "in_channels": "4",
               "out_channels": "8", "sample_size": "8",
               "vae_compression": "16", "tiny_encoders": "1"}


def _random_lora_b(trainer, seed):
    """The JAX trainer's adapters with a random nonzero lora_b."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(0.2 * rng.standard_normal(x.shape),
                                  jnp.float32)
                      if p[-1].key == "lora_b" else x),
        trainer.state.adapters)


def _encoder_weights(family, seed):
    from yat_tpu.models.text_encoders import (GEMMA_TINY_TEST, T5_TINY_TEST,
                                              Gemma2Encoder, T5Encoder)
    from yat_tpu.models.vae import (DCAE, DCAE_TINY_TEST, KLVAE_TINY_TEST,
                                    AutoencoderKL)
    rng = jax.random.PRNGKey(seed)
    if family == "sana":
        te = Gemma2Encoder(cfg=GEMMA_TINY_TEST, dtype=jnp.float32)
        vae = DCAE(cfg=DCAE_TINY_TEST)
    else:
        te = T5Encoder(cfg=T5_TINY_TEST, dtype=jnp.float32)
        vae = AutoencoderKL(cfg=KLVAE_TINY_TEST)
    te_vars = te.init(rng, jnp.zeros((1, 8), jnp.int32),
                      jnp.ones((1, 8), jnp.int32))
    vae_vars = vae.init(rng, jnp.zeros((1, 16, 16, 3)))
    return {"text_encoder": jax.tree.map(np.asarray, te_vars["params"]),
            "vae": jax.tree.map(np.asarray, vae_vars["params"])}


def _lora_over():
    return dict(lora_rank="4", lora_alpha="8", lora_algo="lora",
                lora_target_modules=TARGETS)


def _port_raw(family, over):
    raw = dict(batch_size="2", learning_rate="1e-3", steps="1",
               num_steps_per_validation="100",
               model_config_overrides=TINY_SANA if family == "sana"
               else TINY_PIXART)
    if family == "pixart":
        raw["aspect_ratio"] = "256"
    raw.update(over)
    return raw


@pytest.fixture(scope="module")
def sana_pair(tmp_path_factory):
    """The tiny SANA trainer of the JAX package with LoRA (random nonzero
    lora_b) and refiner timesteps [1000], and the port's pipeline on the
    same weights and adapters."""
    from yat_tpu.frontends.sana import make_trainer
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.convert import load_flax_adapters
    from yat_tpu_torch.frontends.sana import make_pipeline

    tmp = tmp_path_factory.mktemp("sana")
    shard = write_shard(tmp / "s.tar", (4, 4, 32), 32)
    p = base(tmp, shard, model_config_overrides=TINY_SANA, timesteps=[1000],
             **_lora_over())
    # the JAX package's flax inits under one jit each
    with jitted_flax_init():
        trainer = make_trainer(p)
        trainer.initialize()
        encoders = _encoder_weights("sana", p.dataset_seed)
    adapters = _random_lora_b(trainer, 5)
    trainer.state = trainer.state.replace(adapters=adapters)
    weights = {"transformer": jax.tree.map(
        np.asarray, trainer.state.params), **encoders}
    vp = make_pipeline(TrainingParameters.from_dict(_port_raw(
        "sana", dict(timesteps=[1000]))), "cpu", weights)
    n = load_flax_adapters(vp.model, jax.tree.map(np.asarray, adapters),
                           jax.tree.map(np.asarray,
                                        trainer.state.adapters_meta))
    assert n == 2 * 4 * vp.model.cfg.num_layers
    return trainer, vp, p


@pytest.mark.parametrize("case", ["dpm", "cache2", "gated"])
def test_sana_pipeline_samplers_match_jax(sana_pair, case):
    """SANA with sampler='dpm', with cache_interval=2 (5 steps: 4 model
    calls) and with active_timesteps=[1000] over a nonzero LoRA (on at
    the first step, off at the rest), against the JAX validate_fn on the
    same weights and x0."""
    from yat_tpu.train.validation import set_cache_interval as j_cache
    from yat_tpu.train.validation import set_sampler as j_sampler
    from yat_tpu_torch.train.validation import set_cache_interval, set_sampler

    trainer, vp, p = sana_pair
    jvp = trainer.validate_fn
    steps = 5 if case == "cache2" else 3
    for pipe in (jvp, vp):
        pipe.num_steps = steps
        pipe.sampler = "auto"
        pipe.cache_interval = 1
        pipe.active_timesteps = (1000,) if case == "gated" else None
    if case == "dpm":
        j_sampler(jvp, "dpm")
        set_sampler(vp, "dpm")
    if case == "cache2":
        j_cache(jvp, 2)
        set_cache_interval(vp, 2)
    want = jvp(trainer)
    got = vp(list(p.validation_prompts),
             x0=torch.from_numpy(_x0((1, 4, 4, 32))))
    assert list(got) == list(want)
    for tag in want:
        np.testing.assert_allclose(got[tag], np.asarray(want[tag]),
                                   atol=IMAGE_TOL)
    if case == "gated":
        # the gate matters: the ungated LoRA pipeline gives other images
        vp.active_timesteps = None
        other = vp(list(p.validation_prompts)[:1],
                   x0=torch.from_numpy(_x0((1, 4, 4, 32))))
        tag = next(iter(other))
        assert np.abs(other[tag] - got[tag]).max() > 10 * IMAGE_TOL


def test_pixart_pipeline_dpm_with_pag_matches_jax(tmp_path):
    """PixArt-Sigma with sampler='dpm' under CFG 5.0 and PAG 2.0 (the
    learned-sigma slice), against the JAX validate_fn on the same weights
    and x0."""
    from yat_tpu.frontends.pixart import make_trainer
    from yat_tpu.train.validation import set_sampler as j_sampler
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.pixart import make_pipeline
    from yat_tpu_torch.train.validation import set_sampler

    shard = write_shard(tmp_path / "s.tar", (8, 8, 4), 32)
    p = base(tmp_path, shard, model_config_overrides=TINY_PIXART)
    # the JAX package's flax inits under one jit each
    with jitted_flax_init():
        trainer = make_trainer(p)
        trainer.initialize()
        encoders = _encoder_weights("pixart", p.dataset_seed)
    jvp = trainer.validate_fn
    jvp.num_steps = 4
    j_sampler(jvp, "dpm")
    want = jvp(trainer)
    weights = {"transformer": jax.tree.map(
        np.asarray, trainer.state.variables()["params"]), **encoders}
    vp = make_pipeline(TrainingParameters.from_dict(_port_raw("pixart", {})),
                       "cpu", weights)
    vp.num_steps = 4
    set_sampler(vp, "dpm")
    got = vp(list(p.validation_prompts),
             x0=torch.from_numpy(_x0((1, *vp.latent_shape))))
    assert list(got) == list(want)
    for tag in want:
        np.testing.assert_allclose(got[tag], np.asarray(want[tag]),
                                   atol=IMAGE_TOL)


# ---------------------------------------------------------------------------
# the two trainer faults: EMA validation, validation_cache_interval
# ---------------------------------------------------------------------------

def test_ema_validation_matches_jax_and_restores_live_leaves(tmp_path):
    """A tiny SANA run with use_ema validates on the EMA leaves: the port's
    validate_fn gives the JAX trainer's images when both hold the same
    live and EMA adapters (which differ), and the live leaves come back
    bit for bit."""
    from yat_tpu.frontends.sana import make_trainer as j_make_trainer
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.convert import load_flax_adapters
    from yat_tpu_torch.frontends.sana import make_trainer

    shard = write_shard(tmp_path / "s.tar", (4, 4, 32), 32)
    over = dict(use_ema="", **_lora_over())
    p = base(tmp_path, shard, model_config_overrides=TINY_SANA, **over)
    # the JAX package's flax inits under one jit each
    with jitted_flax_init():
        jt = j_make_trainer(p)
        jt.validate_fn.num_steps = 2
        jt.initialize()
        encoders = _encoder_weights("sana", p.dataset_seed)
    live = _random_lora_b(jt, 6)
    ema = _random_lora_b(jt, 7)
    jt.state = jt.state.replace(adapters=live, ema=ema)
    want = jt.validate_fn(jt)

    weights = {"transformer": jax.tree.map(np.asarray, jt.state.params),
               **encoders}
    raw = _port_raw("sana", dict(
        over, local_shard_paths=[shard],
        validation_prompts=list(p.validation_prompts),
        output_dir=str(tmp_path / "port")))
    tt = make_trainer(TrainingParameters.from_dict(raw), device="cpu",
                      weights=weights)
    tt.validation_pipeline.num_steps = 2
    tt.initialize()
    meta = jax.tree.map(np.asarray, jt.state.adapters_meta)
    load_flax_adapters(tt.model, jax.tree.map(np.asarray, live), meta)
    from yat_tpu_torch.adapters.builder import adapter_parameters
    flat_ema = {".".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(ema)}
    tt.ema = [torch.from_numpy(flat_ema[name].copy())
              for name, _ in adapter_parameters(tt.model)]
    before = [q.detach().clone() for q in tt.trainable_leaves()]
    got = tt.validate_fn(tt, x0=torch.from_numpy(_x0((1, 4, 4, 32))))
    assert list(got) == list(want)
    for tag in want:
        np.testing.assert_allclose(got[tag], np.asarray(want[tag]),
                                   atol=IMAGE_TOL)
    for q, b in zip(tt.trainable_leaves(), before):
        assert torch.equal(q, b)
    # the live leaves give other images: the EMA swap is what matched
    live_images = tt.validation_pipeline(
        list(p.validation_prompts), x0=torch.from_numpy(_x0((1, 4, 4, 32))))
    tag = next(iter(want))
    assert np.abs(live_images[tag] - got[tag]).max() > 10 * IMAGE_TOL


@pytest.mark.parametrize("family", ["sana", "pixart"])
def test_validation_cache_interval_key_reaches_the_pipeline(tmp_path,
                                                            family):
    """``validation_cache_interval: 2`` sets SANA's validation pipeline to
    the cached sampler before the first step, and makes a PixArt-Sigma
    run raise before step 1 (the velocity cache has no epsilon form), as
    the JAX trainer does."""
    from yat_tpu_torch.config import TrainingParameters

    if family == "sana":
        from yat_tpu_torch.frontends.sana import make_trainer
        shard = write_shard(tmp_path / "s.tar", (4, 4, 32), 32)
    else:
        from yat_tpu_torch.frontends.pixart import make_trainer
        shard = write_shard(tmp_path / "s.tar", (8, 8, 4), 32)
    raw = _port_raw(family, dict(
        _lora_over(), local_shard_paths=[shard], validation_prompts=["a"],
        validation_cache_interval="2", output_dir=str(tmp_path / "out")))
    trainer = make_trainer(TrainingParameters.from_dict(raw), device="cpu")
    assert trainer.validation_pipeline.cache_interval == 1
    if family == "pixart":
        with pytest.raises(ValueError, match="requires a flow-match family"):
            trainer.run()
        assert trainer.global_step == 0
        return
    trainer.validation_pipeline.num_steps = 2
    trainer.run()
    assert trainer.global_step == 1
    assert trainer.validation_pipeline.cache_interval == 2


# ---------------------------------------------------------------------------
# the tiled decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["klvae", "dcae"])
def test_decode_tiled_matches_jax(family):
    """``decode_tiled`` with a small tile (6 latents, overlap 2) against
    the JAX version on the tiny VAEs' decoders, same weights."""
    from yat_tpu.models import vae as JV
    from yat_tpu_torch.convert import load_flax_params
    from yat_tpu_torch.models import vae as TV

    if family == "klvae":
        jvae, tvae = JV.AutoencoderKL(cfg=JV.KLVAE_TINY_TEST), \
            TV.AutoencoderKL(TV.KLVAE_TINY_TEST)
        lat = (1, 10, 14, 4)
    else:
        jvae, tvae = JV.DCAE(cfg=JV.DCAE_TINY_TEST), TV.DCAE(
            TV.DCAE_TINY_TEST)
        lat = (1, 10, 14, 32)
    # the init and each tile shape's decode compiled once (the JAX
    # function's documented decode_fn), not op by op
    v = jax.jit(jvae.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    load_flax_params(tvae, jax.tree.map(np.asarray, v["params"]))
    z = np.random.default_rng(0).standard_normal(lat).astype(np.float32)
    want = JV.decode_tiled(
        jvae, v, jnp.asarray(z), tile_latent=6, overlap=2,
        decode_fn=jax.jit(lambda v, t: jvae.apply(v, t, method=jvae.decode)))
    with torch.no_grad():
        got = TV.decode_tiled(tvae, torch.from_numpy(z), tile_latent=6,
                              overlap=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TILE_TOL, rtol=TILE_TOL)
