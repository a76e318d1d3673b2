"""PyTorch port, models (yat_tpu_torch/models, convert.py and the copied
helpers): each port module against its JAX counterpart on the same
weights, carried over by ``convert.load_flax_params``, and the same numpy
inputs, in fp32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yat_tpu_torch.convert import load_flax_params

# fp32 forwards through several layers: float summation order only
MODEL_TOL = 1e-4


def _tree(variables):
    return jax.tree.map(np.asarray, variables["params"])


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# SANA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm,softmax", [(None, False), ("rms", False),
                                             ("rms_norm_across_heads", False),
                                             (None, True)])
def test_sana_block_matches_jax(qk_norm, softmax):
    from yat_tpu.models.sana import SANA_TINY_TEST, SanaBlock as JBlock
    from yat_tpu_torch.models.sana import SanaBlock

    cfg = dataclasses.replace(SANA_TINY_TEST, qk_norm=qk_norm)
    hw = (2, 4)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, cfg.hidden_dim)).astype(np.float32)
    cond = rng.standard_normal((2, 6, cfg.hidden_dim)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, cfg.hidden_dim)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    jb = JBlock(cfg=cfg, hw=hw, use_softmax_self_attn=softmax,
                dtype=jnp.float32)
    variables = jax.jit(jb.init)(jax.random.PRNGKey(0), x, cond, ctx, mask)
    want = jax.jit(jb.apply)(variables, x, cond, ctx, mask)

    tb = SanaBlock(cfg, use_softmax_self_attn=softmax, dtype=torch.float32)
    load_flax_params(tb, _tree(variables))
    got = tb(_t(x), _t(cond), _t(ctx), _t(mask), hw)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_TOL)


@pytest.fixture(scope="module")
def tiny_sana():
    """SANA_TINY_TEST (2 blocks, the second one softmax self-attention)
    built in both packages on the JAX init's weights."""
    from yat_tpu.models.sana import SANA_TINY_TEST
    from yat_tpu.models.sana import SanaTransformer2D as JSana
    from yat_tpu_torch.models.sana import SanaTransformer2D

    cfg = dataclasses.replace(SANA_TINY_TEST, softmax_self_attn_blocks=(1,))
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 8, 8, cfg.in_channels)).astype(np.float32)
    emb = rng.standard_normal((2, cfg.max_caption_len, cfg.caption_channels)
                              ).astype(np.float32)
    mask = (np.arange(cfg.max_caption_len)[None]
            < np.array([[1], [11]])).astype(np.int32)
    t = np.array([999.0, 250.5], np.float32)
    jm = JSana(cfg=cfg, dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), lat, emb, t, mask)
    tm = SanaTransformer2D(cfg, dtype=torch.float32)
    load_flax_params(tm, _tree(variables))
    return jm, variables, tm, (lat, emb, t, mask)


def test_sana_transformer_matches_jax(tiny_sana):
    jm, variables, tm, (lat, emb, t, mask) = tiny_sana
    want = jax.jit(jm.apply)(variables, lat, emb, t, mask)
    with torch.inference_mode():
        got = tm(_t(lat), _t(emb), _t(t), _t(mask))
    assert got.shape == lat.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_TOL)


def test_sana_context_kv_cache_matches_jax(tiny_sana):
    """return_ctx_kv gives JAX's per-block (K, V); a forward on the cache
    equals the uncached forward of both packages."""
    jm, variables, tm, (lat, emb, t, mask) = tiny_sana
    jkv = jax.jit(lambda *a: jm.apply(*a, return_ctx_kv=True))(
        variables, lat, emb, t, mask)
    with torch.inference_mode():
        tkv = tm(None, _t(emb), None, _t(mask), return_ctx_kv=True)
        cached = tm(_t(lat), _t(emb), _t(t), _t(mask), cached_ctx_kv=tkv)
    assert len(tkv) == len(jkv) == 2
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=MODEL_TOL)
        np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=MODEL_TOL)
    want = jax.jit(jm.apply)(variables, lat, emb, t, mask)
    np.testing.assert_allclose(_np(cached), np.asarray(want), atol=MODEL_TOL)


def test_layers_match_jax():
    from yat_tpu.models import layers as JL
    from yat_tpu_torch.models import layers as TL

    t = np.array([0.0, 1.5, 999.0], np.float32)
    # sin/cos of arguments up to 1e3 rad: the two libraries' range
    # reductions differ by about one fp32 ulp of the argument (6e-5)
    for dim in (256, 7):
        np.testing.assert_allclose(
            _np(TL.sinusoidal_timestep_embedding(_t(t), dim)),
            np.asarray(JL.sinusoidal_timestep_embedding(jnp.asarray(t), dim)),
            atol=1e-4)
    x = np.random.default_rng(0).standard_normal((2, 3, 16)).astype(np.float32)
    for jmod, tmod in ((JL.RMSNorm(), TL.RMSNorm(16)),
                       (JL.LayerNorm(), TL.LayerNorm(16))):
        v = jmod.init(jax.random.PRNGKey(0), x)
        v = jax.tree.map(lambda a: a + 0.1, v)       # non-trivial affine
        load_flax_params(tmod, _tree(v))
        np.testing.assert_allclose(_np(tmod(_t(x))),
                                   np.asarray(jmod.apply(v, x)), atol=1e-6)
    with pytest.raises(ValueError, match="unsupported qk_norm"):
        TL.Attention(16, 2, 8, qk_norm="layer_norm")


def test_convert_rejects_mismatch():
    from yat_tpu_torch.models.layers import AdapterDense

    dense = AdapterDense(4, 3)
    good = {"kernel": np.zeros((4, 3), np.float32),
            "bias": np.zeros((3,), np.float32)}
    load_flax_params(dense, good)
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_params(dense, {**good, "kernel": np.zeros((3, 4))})
    with pytest.raises(KeyError, match="not in the tree"):
        load_flax_params(dense, {"bias": good["bias"]})
    # a bias the tree lacks (a torch layer without one) is set to zero,
    # whatever the constructor left there
    with torch.no_grad():
        dense.bias.fill_(float("nan"))
    load_flax_params(dense, {"kernel": good["kernel"]})
    assert torch.equal(dense.bias, torch.zeros(3))
    with pytest.raises(KeyError, match="no parameter"):
        load_flax_params(dense, {**good, "scale": np.zeros((3,))})
    # only a leaf named ``bias`` may be missing: T5's learned position
    # table ``relative_attention_bias`` is a weight
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.models.text_encoders import T5_TINY_TEST, T5Encoder

    t5 = T5Encoder(T5_TINY_TEST, dtype=torch.float32)
    tree = {}
    for path, t in flax_params(t5).items():
        if not path.endswith("relative_attention_bias"):
            *keys, leaf = path.split(".")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = t.numpy().copy()
    with pytest.raises(KeyError, match="relative_attention_bias"):
        load_flax_params(t5, tree)


# ---------------------------------------------------------------------------
# Gemma-2 and DC-AE
# ---------------------------------------------------------------------------

def test_gemma2_encoder_matches_jax():
    from yat_tpu.models.text_encoders import GEMMA_TINY_TEST
    from yat_tpu.models.text_encoders import Gemma2Encoder as JGemma
    from yat_tpu_torch.models.text_encoders import Gemma2Encoder
    from yat_tpu_torch.utils.tokenizer import HashTokenizer

    ids, mask = HashTokenizer(vocab_size=256, max_length=12)(
        ["a red fox in the snow", "hello"])
    jm = JGemma(cfg=GEMMA_TINY_TEST, dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), ids, mask)
    want = jax.jit(jm.apply)(variables, ids, mask)
    tm = Gemma2Encoder(GEMMA_TINY_TEST, dtype=torch.float32)
    load_flax_params(tm, _tree(variables))
    with torch.inference_mode():
        got = tm(_t(ids).long(), _t(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_TOL)


def test_dcae_decode_matches_jax():
    from yat_tpu.models.vae import DCAE as JDCAE
    from yat_tpu.models.vae import DCAE_TINY_TEST
    from yat_tpu_torch.models.vae import DCAE

    jm = JDCAE(cfg=DCAE_TINY_TEST)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4),
                                 jnp.zeros((1, 16, 16, 3)))
    z = np.random.default_rng(5).standard_normal((2, 4, 4, 32)).astype(
        np.float32)
    want = jax.jit(lambda v, z: jm.apply(v, z, method=jm.decode))(
        variables, z)
    tm = DCAE(DCAE_TINY_TEST)
    load_flax_params(tm, _tree(variables))
    with torch.inference_mode():
        got = tm.decode(_t(z))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


# ---------------------------------------------------------------------------
# schedule, sampling and the copied framework-free helpers
# ---------------------------------------------------------------------------

def test_flow_match_schedule_matches_jax():
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JSched
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule

    for kw in ({}, {"use_dynamic_shifting": True}):
        j, t = JSched(shift=3.0, **kw), FlowMatchSchedule(shift=3.0, **kw)
        for steps in (2, 20):
            np.testing.assert_allclose(_np(t.inference_sigmas(steps)),
                                       np.asarray(j.inference_sigmas(steps)),
                                       atol=1e-6)
        # the two linspace implementations round the odd point one fp32
        # ulp apart (6e-5 at t = 1000)
        np.testing.assert_allclose(_np(t.timesteps()),
                                   np.asarray(j.timesteps()), atol=1e-4)
        assert t.mu_for_seq_len(1024) == pytest.approx(j.mu_for_seq_len(1024))


def test_seed_noise_and_euler_with_injected_x0():
    from yat_tpu_torch.ops.sampling import sample_flow_match, seed_noise
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule

    cpu = torch.device("cpu")
    a = seed_noise(42, (3, 2, 2, 4), cpu)
    assert torch.equal(a, seed_noise(42, (3, 2, 2, 4), cpu))
    assert torch.equal(a[0], a[2])                 # one draw, tiled
    # v = -x drives x to (1 - ...)·x0: Euler on the ladder, by hand
    sched = FlowMatchSchedule()
    x0 = torch.ones((1, 2, 2, 4))
    out = sample_flow_match(lambda x, t: -x, (2, 2, 2, 4), sched, 3,
                            device=cpu, x0=x0)
    s = sched.inference_sigmas(3)
    want = 1.0
    for i in range(3):
        want = want + (s[i + 1] - s[i]) * (-want)
    torch.testing.assert_close(out, torch.full((2, 2, 2, 4), float(want)))


def test_copied_helpers_match_jax():
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.data import sampler as JS
    from yat_tpu.frontends.common import override_config as j_override
    from yat_tpu.frontends.common import slice_caption_rung as j_slice
    from yat_tpu.models.sana import SANA_600M as J600
    from yat_tpu.utils.tokenizer import HashTokenizer as JTok
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.data import sampler as TS
    from yat_tpu_torch.frontends.common import override_config
    from yat_tpu_torch.frontends.common import slice_caption_rung
    from yat_tpu_torch.models.sana import SANA_600M
    from yat_tpu_torch.utils.tokenizer import HashTokenizer

    texts = ["a red fox", "", "one two three four five six seven"]
    ids, mask = HashTokenizer(vocab_size=1000, max_length=130)(texts)
    jids, jmask = JTok(vocab_size=1000, max_length=130)(texts)
    assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)
    for a, b in zip(slice_caption_rung(ids, mask), j_slice(ids, mask)):
        assert np.array_equal(a, b)
    for real in (1, 64, 65, 500):
        assert TS.caption_rung(real, 512) == JS.caption_rung(real, 512)
    embs = [np.ones((3, 4)), np.ones((1, 5, 4))]
    for a, b in zip(TS.pad_embeddings(embs, 8), JS.pad_embeddings(embs, 8)):
        assert np.array_equal(a, b)
    over = {"hidden_dim": "64", "in_channels": "8", "qk_norm": "rms",
            "softmax_self_attn_blocks": ["1"], "tiny_encoders": "1"}
    assert dataclasses.asdict(override_config(SANA_600M, over, True)) == \
        dataclasses.asdict(j_override(J600, over, True))
    raw = {"batch_size": "2", "learning_rate": "1e-4", "steps": "3",
           "num_steps_per_validation": "1", "bfloat16": "", "low_vram": "",
           "validation_batch": "2", "dataset_seed": "5"}
    assert dataclasses.asdict(TrainingParameters.from_dict(raw)) == \
        dataclasses.asdict(JParams.from_dict(raw))


def test_compress_embeddings_matches_jax():
    from yat_tpu.models.text_encoders import compress_embeddings as j_comp
    from yat_tpu_torch.models.text_encoders import compress_embeddings

    hidden = np.random.default_rng(0).standard_normal((2, 128, 4)).astype(
        np.float32)
    mask = (np.arange(128)[None] < np.array([[3], [70]])).astype(np.int32)
    got = compress_embeddings(_t(hidden), mask)
    want = j_comp(jnp.asarray(hidden), mask)
    assert [g.shape for g in got] == [(3, 4), (70, 4)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
