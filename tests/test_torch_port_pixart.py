"""PyTorch port, the PixArt-Sigma serving slice on the CPU: T5, the KL-VAE
decoder, the PixArt-Sigma denoiser (with its PAG and context-K/V passes),
the DDPM schedule, DDIM and the PAG denoiser, each against ``yat_tpu`` on
the same numpy inputs and weights (``convert.load_flax_params``); then the
tiny pipeline end to end against the JAX ``ValidationPipeline``, and the
serving and generation entry points with ``--family pixart``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_frontends import TINY_DIT, write_shard
from tests.test_validation_frontends import base
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 modules: reduction order only (MODEL_TOL of test_torch_port_models)
MODEL_TOL = 1e-4
# images in [0, 1] after fp32 sampling and an fp32 decode: summation order
# only (IMAGE_TOL of test_torch_port_serve)
IMAGE_TOL = 1e-3

# the tiny PixArt stack of tests/test_validation_frontends.py
TINY_PIXART = {**TINY_DIT, "caption_channels": "32", "in_channels": "4",
               "out_channels": "8", "sample_size": "8",
               "vae_compression": "16", "tiny_encoders": "1"}


def _tree(variables):
    return jax.tree.map(np.asarray, variables["params"])


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------

def test_t5_relative_position_bucket_matches_jax():
    from yat_tpu.models.text_encoders import t5_relative_position_bucket as J
    from yat_tpu_torch.models.text_encoders import \
        t5_relative_position_bucket as T
    rel = np.arange(-400, 401, dtype=np.int32)[None]
    for nb, md in ((32, 128), (16, 64)):
        want = np.asarray(J(jnp.asarray(rel), nb, md))
        got = T(torch.from_numpy(rel), nb, md).numpy()
        np.testing.assert_array_equal(got, want)


def test_t5_tiny_matches_jax():
    from yat_tpu.models.text_encoders import T5_TINY_TEST as JC
    from yat_tpu.models.text_encoders import T5Encoder as JT5
    from yat_tpu_torch.convert import load_flax_params
    from yat_tpu_torch.models.text_encoders import T5_TINY_TEST, T5Encoder

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([[12], [5]])).astype(np.int32)
    jm = JT5(cfg=JC, dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                        jnp.asarray(mask))
    want = jm.apply(variables, jnp.asarray(ids), jnp.asarray(mask))
    tm = T5Encoder(T5_TINY_TEST, dtype=torch.float32)
    load_flax_params(tm, _tree(variables))
    got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)


def test_t5_random_init_folds_the_attention_scale_into_q():
    """Random T5 weights: the query projection is lecun-normal times
    head_dim^-0.5 (T5's own initialisation, which stands in for the
    1/sqrt(d) its attention leaves out), the key and value projections
    plain lecun-normal."""
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.models.text_encoders import T5_TINY_TEST, T5Encoder

    tm = T5Encoder(T5_TINY_TEST, dtype=torch.float32)
    init_params(tm, torch.Generator().manual_seed(0))
    layer = tm.layers[0]
    ratio = float(layer.q.weight.std() / layer.k.weight.std())
    assert ratio == pytest.approx(T5_TINY_TEST.head_dim ** -0.5, rel=0.15)
    assert float(layer.v.weight.std()) == pytest.approx(
        float(layer.k.weight.std()), rel=0.15)


# ---------------------------------------------------------------------------
# the KL-VAE decoder
# ---------------------------------------------------------------------------

def test_kl_decoder_tiny_matches_jax():
    from yat_tpu.models.vae import KLVAE_TINY_TEST as JC
    from yat_tpu.models.vae import AutoencoderKL as JKL
    from yat_tpu_torch.convert import load_flax_params
    from yat_tpu_torch.models.vae import KLVAE_TINY_TEST, AutoencoderKL

    jm = JKL(cfg=JC)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    # nonzero norm affines, so the GroupNorm scale and bias are exercised
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), a.shape)
        if path[-1].key in ("scale", "bias") else a, variables["params"])
    z = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    want = jm.apply({"params": params}, jnp.asarray(z), method=jm.decode)
    tm = AutoencoderKL(KLVAE_TINY_TEST)
    load_flax_params(tm, _tree({"params": params}))
    got = tm.decode(torch.from_numpy(z))
    assert got.shape == (2, 16, 16, 3)
    _close(got, want)


# ---------------------------------------------------------------------------
# the denoiser
# ---------------------------------------------------------------------------

def _pixart_pair(seed=0):
    from yat_tpu.models.pixart import PIXART_TINY_TEST as JC
    from yat_tpu.models.pixart import PixArtTransformer2D as JP
    from yat_tpu_torch.convert import load_flax_params
    from yat_tpu_torch.models.pixart import PIXART_TINY_TEST, \
        PixArtTransformer2D

    rng = np.random.default_rng(seed)
    c = JC
    lat = rng.standard_normal((2, 8, 8, c.in_channels)).astype(np.float32)
    emb = rng.standard_normal((2, c.max_caption_len,
                               c.caption_channels)).astype(np.float32)
    mask = (np.arange(c.max_caption_len)[None]
            < np.array([[1], [6]])).astype(np.int32)
    t = np.array([999.0, 412.0], np.float32)
    jm = JP(cfg=c, dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in
                                                    (lat, emb, t, mask)))
    # nonzero modulation tables and gates
    variables = {"params": jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.05 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), a.shape)
        if "table" in path[-1].key or path[-1].key == "bias" else a,
        variables["params"])}
    tm = PixArtTransformer2D(PIXART_TINY_TEST, dtype=torch.float32)
    load_flax_params(tm, _tree(variables))
    return jm, variables, tm, (lat, emb, t, mask)


@pytest.mark.parametrize("pag", [False, True])
def test_pixart_tiny_matches_jax(pag):
    jm, variables, tm, arrays = _pixart_pair()
    want = jm.apply(variables, *(jnp.asarray(a) for a in arrays), pag=pag)
    got = tm(*(torch.from_numpy(a) for a in arrays), pag=pag)
    assert got.shape == (2, 8, 8, 8)
    _close(got, want)


def test_pixart_context_kv_pass_matches_jax():
    """return_ctx_kv gives every block's caption K/V; feeding them back as
    cached_ctx_kv reproduces the full forward."""
    jm, variables, tm, (lat, emb, t, mask) = _pixart_pair(1)
    j_kv = jm.apply(variables, *(jnp.asarray(a) for a in (lat, emb, t, mask)),
                    return_ctx_kv=True)
    t_kv = tm(None, torch.from_numpy(emb), None, torch.from_numpy(mask),
              return_ctx_kv=True)
    assert len(t_kv) == len(j_kv) == 2
    for (tk, tv), (jk, jv) in zip(t_kv, j_kv):
        _close(tk, jk)
        _close(tv, jv)
    args = [torch.from_numpy(a) for a in (lat, emb, t, mask)]
    cached = tm(*args, cached_ctx_kv=t_kv)
    full = tm(*args)
    torch.testing.assert_close(cached, full)


@pytest.mark.parametrize("activation", ["gelu_tanh", "silu", "gelu"])
def test_mlp_matches_jax(activation):
    from yat_tpu.models.layers import MLP as JMLP
    from yat_tpu_torch.convert import load_flax_params
    from yat_tpu_torch.models.layers import MLP

    x = np.random.default_rng(2).standard_normal((2, 5, 24)).astype(
        np.float32)
    jm = JMLP(mlp_ratio=2.0, activation=activation)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = MLP(24, 2.0, activation)
    load_flax_params(tm, _tree(variables))
    _close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# DDPM schedule, DDIM and the PAG denoiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", ["linear", "scaled_linear",
                                  "squaredcos_cap_v2"])
def test_ddpm_schedule_matches_jax(beta):
    from yat_tpu.ops.schedulers import DDPMSchedule as JS
    from yat_tpu_torch.ops.schedulers import DDPMSchedule

    js, ts = JS(beta_schedule=beta), DDPMSchedule(beta_schedule=beta)
    _close(ts.betas(), js.betas(), 1e-6)
    _close(ts.alphas_cumprod(), js.alphas_cumprod(), 1e-6)
    rng = np.random.default_rng(3)
    x, eps = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
              for _ in range(2))
    for t, t_prev in ((999, 946), (52, 0), (0, -1)):
        want = js.ddim_step(jnp.asarray(x), jnp.asarray(eps), jnp.int32(t),
                            jnp.int32(t_prev))
        got = ts.ddim_step(torch.from_numpy(x), torch.from_numpy(eps), t,
                           t_prev)
        _close(got, want, 1e-5)


def _toy_model(x, t, scale):
    """A denoiser stand-in: a fixed function of (x, t, a conditioning
    scale); the same formula in either framework."""
    tt = t.reshape(-1, *([1] * (x.ndim - 1))) / 1000.0
    return 0.3 * x * (1.0 - tt) + 0.1 * scale * tt


def test_sample_ddim_and_pag_denoiser_match_jax():
    """DDIM with the PAG + CFG denoiser over a toy model whose perturbed
    branch differs, against yat_tpu's sample_ddim and
    make_pag_cfg_denoiser; the initial noise is JAX's seed_noise(42)."""
    from yat_tpu.ops import sampling as JS
    from yat_tpu.ops.schedulers import DDPMSchedule as JD
    from yat_tpu_torch.ops import sampling as TS
    from yat_tpu_torch.ops.schedulers import DDPMSchedule

    shape = (2, 4, 4, 4)
    cond = np.array([[1.0], [2.0]], np.float32)
    uncond = np.zeros((2, 1), np.float32)

    def j_apply(vs, x, timesteps, scale, pag=False):
        s = scale.reshape(-1, 1, 1, 1)
        return _toy_model(x, timesteps.astype(jnp.float32),
                          s * (0.5 if pag else 1.0))

    def t_apply(x, timesteps, scale, pag=False):
        s = scale.reshape(-1, 1, 1, 1)
        return _toy_model(x, timesteps.float(), s * (0.5 if pag else 1.0))

    jd = JS.make_pag_cfg_denoiser(j_apply, {}, {"scale": jnp.asarray(cond)},
                                  {"scale": jnp.asarray(uncond)}, 5.0, 2.0)
    want = JS.sample_ddim(jd, shape, JD(), 20, 42)
    td = TS.make_pag_cfg_denoiser(t_apply, {"scale": torch.from_numpy(cond)},
                                  {"scale": torch.from_numpy(uncond)}, 5.0,
                                  2.0)
    x0 = torch.from_numpy(np.array(JS.seed_noise(42, (1, *shape[1:]))))
    got = TS.sample_ddim(td, shape, DDPMSchedule(), 20, 42, x0=x0)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the pipeline end to end, and the entry points
# ---------------------------------------------------------------------------

RAW = dict(batch_size="2", learning_rate="1e-3", steps="1",
           num_steps_per_validation="100", aspect_ratio="256",
           model_config_overrides=TINY_PIXART)


def _port_params(**over):
    from yat_tpu_torch.config import TrainingParameters
    return TrainingParameters.from_dict({**RAW, **over})


def test_pipeline_matches_jax_validation(tmp_path):
    """JAX: the tiny PixArt trainer of tests/test_validation_frontends.py
    and its validate_fn (20 DDIM steps, CFG 5.0, PAG 2.0, learned-sigma
    slice).  Port: make_pipeline on the trainer's denoiser weights and the
    T5 and VAE weights the JAX frontend initialises from
    PRNGKey(dataset_seed), with JAX's seed_noise(42) injected as x0."""
    from yat_tpu.frontends.pixart import make_trainer
    from yat_tpu.models.text_encoders import T5_TINY_TEST, T5Encoder
    from yat_tpu.models.vae import KLVAE_TINY_TEST, AutoencoderKL
    from yat_tpu.ops.sampling import seed_noise
    from yat_tpu_torch.frontends.pixart import make_pipeline

    shard = write_shard(tmp_path / "s.tar", (8, 8, 4), 32)
    p = base(tmp_path, shard, model_config_overrides=TINY_PIXART)
    assert not p.bfloat16
    trainer = make_trainer(p)
    trainer.initialize()
    want = trainer.validate_fn(trainer)

    rng = jax.random.PRNGKey(p.dataset_seed)
    te_vars = T5Encoder(cfg=T5_TINY_TEST, dtype=jnp.float32).init(
        rng, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    vae_vars = AutoencoderKL(cfg=KLVAE_TINY_TEST).init(
        rng, jnp.zeros((1, 16, 16, 3)))
    weights = {k: jax.tree.map(np.asarray, v["params"]) for k, v in (
        ("transformer", trainer.state.variables()),
        ("text_encoder", te_vars), ("vae", vae_vars))}
    vp = make_pipeline(_port_params(), "cpu", weights)
    assert (vp.num_steps, vp.guidance_scale, vp.pag_scale, vp.pred_slice) \
        == (20, 5.0, 2.0, 4)
    lat = vp.latent_shape
    x0 = torch.from_numpy(np.array(seed_noise(42, (1, *lat))))
    got = vp(list(p.validation_prompts), x0=x0)

    assert list(got) == list(want)
    for tag in want:
        assert got[tag].shape == want[tag].shape == (32, 32, 3)
        np.testing.assert_allclose(got[tag], np.asarray(want[tag]),
                                   atol=IMAGE_TOL)


def test_serve_and_generate_pixart_on_cpu(tmp_path):
    import yaml

    from yat_tpu_torch import generate
    from yat_tpu_torch.frontends import pixart
    from yat_tpu_torch.serve import build_sampler

    s = build_sampler(_port_params(), "pixart", max_batch=2, device="cpu",
                      steps=2)
    try:
        img = s.submit("a red fox", timeout=300)
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    finally:
        s.stop()
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(RAW))
    out = tmp_path / "out"
    generate.main(["--config", str(cfg), "--family", "pixart", "--prompt",
                   "a red fox", "--steps", "2", "--out", str(out),
                   "--device", "cpu"])
    assert len((out / "prompts.txt").read_text().splitlines()) == 1
    # the velocity cache has no epsilon form: the gate refuses it
    with pytest.raises(ValueError, match="requires a flow-match family"):
        generate.main(["--config", str(cfg), "--family", "pixart",
                       "--prompt", "x", "--cache-interval", "2", "--device",
                       "cpu", "--out", str(out)])
    # the trainer (tests/test_torch_port_pixart_train.py) needs shards
    with pytest.raises(ValueError, match="local_shard_paths"):
        pixart.make_trainer(_port_params(), device="cpu")


def test_chip_smoke_pixart_serve_phase_on_cpu():
    """chip_smoke.py's PixArt serve phase, rehearsed at the tiny size on
    the CPU: 4 concurrent HTTP requests and one more, the image,
    reproducibility and batch checks; no kernel launches on the CPU and no
    XLA-branch attention."""
    import chip_smoke

    params = chip_smoke.serve_params(aspect_ratio="256",
                                     model_config_overrides=TINY_PIXART)
    params.bfloat16 = False
    counts = chip_smoke.phase_serve(params, torch.device("cpu"), "cpu",
                                    family="pixart", px=32, window_ms=2000.0)
    assert set(counts) == {"adaln_layernorm", "flash_attention",
                           "dot_product_attention_folded",
                           "dot_product_attention", "attention_xla"}
    assert not any(counts.values())
