"""PyTorch port, the SD1.5/SDXL UNet on the CPU: the UNet's GroupNorm, the
UNet forward (SD1.5- and SDXL-shaped, with remat on and off), one LoRA
training step of each family (the epsilon loss and every LoRA gradient),
the converters of diffusers and CompVis single-file UNets and VAEs, the
attention launches the JAX gates give at the shipped shapes, and the
ComfyUI export names, each against ``yat_tpu`` on the same numpy inputs
and weights (``convert.load_flax_params``)."""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.synth_checkpoint as S
from yat_tpu_torch.convert import (flax_params, load_flax_adapters,
                                   load_flax_params)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 modules: reduction order only
MODEL_TOL = 2e-5
# the loss and the LoRA gradients (tests/test_norm.py, test_attention.py)
GRAD_TOL = 1e-4
TARGETS = ["to_q", "to_k", "to_v", "to_out"]


def _tree(variables):
    return jax.tree.map(np.asarray, variables["params"])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def _jitter_norms(params):
    """Nonzero norm affines, so the GroupNorm/LayerNorm scale and bias are
    exercised."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), a.shape)
        if path[-1].key in ("scale", "bias") else a, params)


# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(dtype):
    """fp32 statistics with the mean subtracted in fp32, data and affine
    in the input's dtype: fp32 to 1e-6; bf16 to one bf16 step of the
    output, or where the affine's add cancels, one bf16 step of the bias
    (the largest term that rounds there)."""
    from yat_tpu.models.layers import GroupNorm as JG
    from yat_tpu_torch.models.layers import GroupNorm

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 6, 64)) * 3 + 1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JG(num_groups=32, epsilon=1e-5)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jd))
    params = _jitter_norms(variables["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x, jd)),
                      np.float32)
    tm = GroupNorm(64, 32, 1e-5)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    got = tm(torch.from_numpy(x).to(td))
    assert got.dtype == td
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        bias = np.abs(np.asarray(params["bias"])).max()
        np.testing.assert_allclose(got, want, atol=2.0 ** -8 * bias,
                                   rtol=2.0 ** -7)


# ---------------------------------------------------------------------------
# the UNet forward
# ---------------------------------------------------------------------------

def _configs(family):
    """(JAX config, port config) of the tiny UNet, SD1.5- or SDXL-shaped
    (pooled text and time_ids, no attention at level 0)."""
    from yat_tpu.models.unet import UNET_TINY_TEST
    from yat_tpu_torch.models.unet import UNetConfig
    jc = UNET_TINY_TEST
    if family == "sdxl":
        jc = dataclasses.replace(
            jc, transformer_layers=(0, 2), num_heads=None,
            attention_head_dim=16, addition_embed_dim=8,
            addition_time_embed_dim=4)
    return jc, UNetConfig(**dataclasses.asdict(jc))


def _inputs(family, seed=0, b=2):
    rng = np.random.default_rng(seed)
    out = {"latents": rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
           "embeddings": rng.standard_normal((b, 7, 16)).astype(np.float32),
           "text_mask": np.ones((b, 7), np.int32)}
    out["text_mask"][1, 4:] = 0
    if family == "sdxl":
        out["pooled_text"] = rng.standard_normal((b, 8)).astype(np.float32)
        out["time_ids"] = np.tile(np.array([[64, 48, 0, 0, 64, 48]],
                                           np.float32), (b, 1))
    return out


_EXTRA = ("pooled_text", "time_ids")


def numpy_params(shapes, seed):
    """A parameter tree of the shapes of a JAX ``init`` (``jax.eval_shape``:
    an eager or jitted init of the tiny UNet costs 20-40 s of CPU), drawn
    with numpy: kernels ``normal * fan_in^-0.5``, norm scales ``1 +
    0.1 normal``, biases ``0.1 normal``, embeddings ``0.02 normal``."""
    def draw(path, leaf):
        name = path[-1].key
        rng = np.random.default_rng(
            [seed, zlib.crc32(jax.tree_util.keystr(path).encode())])
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return v * np.float32(np.prod(leaf.shape[:-1]) ** -0.5)
        if name == "scale":
            return 1.0 + 0.1 * v
        if name == "embedding" or name.endswith("embedding"):
            return 0.02 * v
        return 0.1 * v
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_unets():
    """The JAX tiny UNet of each family: (config, module, variables), its
    tree's structure from ``init`` and its values from numpy."""
    from yat_tpu.models.unet import UNet2DCondition as JU
    out = {}
    for family in ("sd15", "sdxl"):
        jc, _ = _configs(family)
        x = _inputs(family)
        jm = JU(cfg=jc, dtype=jnp.float32)
        shapes = jax.eval_shape(
            jm.init, jax.random.PRNGKey(1), jnp.asarray(x["latents"]),
            jnp.asarray(x["embeddings"]), jnp.zeros((2,)),
            jnp.asarray(x["text_mask"]),
            **{k: jnp.asarray(x[k]) for k in _EXTRA if k in x})
        out[family] = (jc, jm, {"params": numpy_params(shapes["params"],
                                                       1)})
    return out


def _port_unet(family, variables, remat=False):
    from yat_tpu_torch.models.unet import UNet2DCondition
    _, cfg = _configs(family)
    m = UNet2DCondition(cfg, dtype=torch.float32,
                        gradient_checkpointing=remat)
    load_flax_params(m, _tree(variables))
    return m


_FORWARD_T = np.array([999.0, 41.5], np.float32)


@pytest.fixture(scope="module")
def jax_forwards(jax_unets):
    """The JAX UNet's prediction of each family on the forward test's
    inputs (jitted; the JAX package's remat changes no number)."""
    out = {}
    for family, (_, jm, variables) in jax_unets.items():
        x = _inputs(family, seed=3)
        out[family] = np.asarray(jax.jit(jm.apply)(
            variables, jnp.asarray(x["latents"]),
            jnp.asarray(x["embeddings"]), jnp.asarray(_FORWARD_T),
            jnp.asarray(x["text_mask"]),
            **{k: jnp.asarray(x[k]) for k in _EXTRA if k in x}))
    return out


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
@pytest.mark.parametrize("remat", [False, True])
def test_unet_forward_matches_jax(jax_unets, jax_forwards, family, remat):
    """The UNet at 8x8 latents, two timesteps (one fractional), a partial
    caption mask; SDXL with its pooled text and time_ids.  With remat the
    forward runs with gradients on, so the checkpointed path is the one
    built."""
    x = _inputs(family, seed=3)
    m = _port_unet(family, jax_unets[family][2], remat)
    with torch.set_grad_enabled(remat):
        got = m(torch.from_numpy(x["latents"]),
                torch.from_numpy(x["embeddings"]),
                torch.from_numpy(_FORWARD_T),
                torch.from_numpy(x["text_mask"]),
                **{k: torch.from_numpy(x[k]) for k in _EXTRA if k in x})
    assert got.shape == (2, 8, 8, 4) and got.requires_grad == remat
    np.testing.assert_allclose(got.detach().numpy(), jax_forwards[family],
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def test_unet_joins_skips_of_odd_sides(jax_unets):
    """A latent side that turns odd on the way down (9 -> 5): the port
    resizes to the skip's grid, as diffusers does, and predicts the whole
    latent; the JAX package doubles the grid (5 -> 10) and cannot join the
    9-wide skip (ROADMAP §3)."""
    _, jm, variables = jax_unets["sd15"]
    x = np.random.default_rng(4).standard_normal((1, 9, 12, 4)).astype(
        np.float32)
    args = (np.zeros((1, 7, 16), np.float32), np.array([500.0], np.float32),
            np.ones((1, 7), np.int32))
    with pytest.raises(TypeError):
        jm.apply(variables, jnp.asarray(x), *(jnp.asarray(a) for a in args))
    m = _port_unet("sd15", variables)
    with torch.no_grad():
        got = m(torch.from_numpy(x), *(torch.from_numpy(a) for a in args))
    assert got.shape == (1, 9, 12, 4) and bool(torch.isfinite(got).all())


def test_sdxl_unet_needs_its_micro_conditioning(jax_unets):
    m = _port_unet("sdxl", jax_unets["sdxl"][2])
    x = _inputs("sd15")
    with pytest.raises(ValueError, match="pooled_text and time_ids"):
        m(torch.from_numpy(x["latents"]), torch.zeros(2, 7, 16),
          torch.zeros(2))


# ---------------------------------------------------------------------------
# one LoRA training step of each family
# ---------------------------------------------------------------------------

def _lora(variables, seed=3):
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    rng = np.random.default_rng(seed)
    adapters, meta = build_adapter_params(
        variables, AdapterSpec("lora", rank=4, alpha=8,
                               target_modules=TARGETS),
        jax.random.PRNGKey(seed))
    # a nonzero lora_b, so lora_a gets gradients too
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                  jnp.float32)
                      if p[-1].key == "lora_b" else a), adapters)
    return adapters, meta


def _jax_draws(jsched, rng, latents):
    """The draws of the JAX epsilon loss from its key."""
    k_t, k_n, _ = jax.random.split(rng, 3)
    ts = jsched.training_draw(k_t, latents.shape[0])
    noise = jax.random.normal(k_n, latents.shape, jnp.float32)
    return {"timesteps": torch.from_numpy(np.array(ts)),
            "noise": torch.from_numpy(np.array(noise))}


def _port_loss_and_grads(jax_unets, family, adapters, meta, draws,
                         remat=False):
    """The port's epsilon loss and LoRA gradients of the fixed batch."""
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.ops.schedulers import DDPMSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_epsilon_loss

    model = _port_unet(family, jax_unets[family][2], remat)
    n = load_flax_adapters(model, jax.tree.map(np.asarray, adapters),
                           jax.tree.map(np.asarray, meta))
    named = adapter_parameters(model)
    task = make_epsilon_loss(model, DDPMSchedule(),
                             extra_keys=_EXTRA if family == "sdxl" else ())
    loss, grads = loss_and_grads(
        task, [p for _, p in named],
        {k: torch.from_numpy(v) for k, v in _inputs(family, 5).items()},
        torch.Generator(), draws)
    return float(loss), {name: g for (name, _), g in zip(named, grads)}, n


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_lora_loss_and_gradients_match_jax(jax_unets, family):
    """The epsilon loss (SDXL's with pooled_text and time_ids through
    ``extra_keys``) and the gradient of every LoRA leaf on to_q/to_k/to_v/
    to_out against jax.value_and_grad of the JAX loss on its draws; every
    gradient nonzero."""
    from yat_tpu.ops.schedulers import DDPMSchedule as JSchedule
    from yat_tpu.train.tasks import make_epsilon_loss as j_loss

    _, jm, variables = jax_unets[family]
    adapters, meta = _lora(variables)
    batch = _inputs(family, seed=5)
    jsched = JSchedule()
    jl = j_loss(jm, jsched, extra_keys=_EXTRA if family == "sdxl" else ())
    rng = jax.random.PRNGKey(7)

    def jfn(ad):
        return jl({"params": variables["params"], "adapters": ad,
                   "adapters_meta": meta},
                  {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                  deterministic=False)
    jloss, jgrads = jax.jit(jax.value_and_grad(jfn))(adapters)
    jgrads = dict(_flat(jax.device_get(jgrads)))
    loss, grads, n = _port_loss_and_grads(
        jax_unets, family, adapters, meta,
        _jax_draws(jsched, rng, batch["latents"]))
    # transformer blocks: SD1.5 1 + 1 down, 1 mid, 2 + 2 up; SDXL 2 down,
    # 2 mid, 2 x 2 up
    assert n == 8 * (7 if family == "sd15" else 8)
    np.testing.assert_allclose(loss, float(jloss), rtol=GRAD_TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert bool((g != 0).any()), name
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_remat_recomputes_the_spatial_transformers_too(jax_unets,
                                                       monkeypatch):
    """``low_vram`` recomputes every resnet and every spatial transformer
    (the JAX package builds the transformers' remat wrapper and never uses
    it, so it recomputes the resnets only): the checkpointed modules
    include the spatial transformers, and the loss and gradients equal
    those without remat, bit for bit."""
    import torch.utils.checkpoint as ckpt

    from yat_tpu_torch.models.unet import SpatialTransformer, TimeResnetBlock
    adapters, meta = _lora(jax_unets["sd15"][2])
    rng = np.random.default_rng(1)
    draws = {"timesteps": torch.tensor([17, 802]),
             "noise": torch.from_numpy(rng.standard_normal(
                 (2, 8, 8, 4)).astype(np.float32))}
    loss0, grads0, _ = _port_loss_and_grads(jax_unets, "sd15", adapters,
                                            meta, draws)
    seen = []
    real = ckpt.checkpoint

    def spy(fn, *args, **kw):
        seen.append(type(fn))
        return real(fn, *args, **kw)
    monkeypatch.setattr(ckpt, "checkpoint", spy)
    loss, grads, _ = _port_loss_and_grads(jax_unets, "sd15", adapters, meta,
                                          draws, remat=True)
    assert seen.count(SpatialTransformer) == 7
    assert seen.count(TimeResnetBlock) == 8
    assert loss == loss0
    for name, g in grads.items():
        torch.testing.assert_close(g, grads0[name], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# converters: diffusers and CompVis single files
# ---------------------------------------------------------------------------

def _shapes(module_fn):
    with torch.device("meta"):
        return S.leaf_shapes(flax_params(module_fn()))


def _assert_trees_equal(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_convert_unet_matches_jax(family):
    """A synthesized diffusers UNet (SD1.5's 1x1-conv projections, SDXL's
    linear ones and add_embedding) through both packages' convert_unet:
    equal trees, which load into the port's UNet."""
    from yat_tpu.models.convert_unet import convert_unet as J
    from yat_tpu_torch.models.convert_unet import convert_unet
    from yat_tpu_torch.models.unet import UNet2DCondition

    _, cfg = _configs(family)
    shapes = _shapes(lambda: UNet2DCondition(cfg))
    sd, expected = S.synth(shapes, S.unet_rules(
        len(cfg.block_out_channels), conv_proj=family == "sd15"), 0)
    args = (cfg.block_out_channels, cfg.layers_per_block,
            cfg.transformer_layers)
    tree = convert_unet(sd, *args)
    _assert_trees_equal(tree, J(sd, *args))
    m = UNet2DCondition(cfg, dtype=torch.float32)
    load_flax_params(m, tree)
    for path, t in flax_params(m).items():
        np.testing.assert_array_equal(t.numpy(), expected[path])


def test_compvis_single_file_matches_jax(tmp_path):
    """A synthesized CompVis single file (UNet, KL-VAE, CLIP under their
    LDM prefixes) through split_compvis_checkpoint, ldm_unet_to_diffusers,
    ldm_vae_to_diffusers and convert_vae_compvis of both packages: equal
    dicts and trees, the UNet's equal to the diffusers file's."""
    from yat_tpu.models import convert_unet as J
    from yat_tpu_torch.models import convert_unet as P
    from yat_tpu_torch.models.convert import load_torch_state_dict
    from yat_tpu_torch.models.text_encoders import CLIP_TINY_TEST, \
        CLIPTextModel
    from yat_tpu_torch.models.unet import UNet2DCondition
    from yat_tpu_torch.models.vae import KLVAE_TINY_TEST, AutoencoderKL

    _, cfg = _configs("sd15")
    us = _shapes(lambda: UNet2DCondition(cfg))
    vs = _shapes(lambda: AutoencoderKL(KLVAE_TINY_TEST))
    cs = _shapes(lambda: CLIPTextModel(CLIP_TINY_TEST))
    path = str(tmp_path / "sd15.safetensors")
    S.write_compvis_single_file(path, us, cfg, 0, "F16", vs, cs)
    raw = load_torch_state_dict(path)
    parts, jparts = P.split_compvis_checkpoint(raw), \
        J.split_compvis_checkpoint(raw)
    assert {k: len(v) for k, v in parts.items()} == \
        {"unet": len(us), "vae": len(vs), "clip": len(cs)}
    for k in parts:
        _assert_trees_equal(parts[k], jparts[k])
    args = (cfg.block_out_channels, cfg.layers_per_block,
            cfg.transformer_layers)
    unet = P.ldm_unet_to_diffusers(parts["unet"], *args)
    _assert_trees_equal(unet, J.ldm_unet_to_diffusers(parts["unet"], *args))
    diffusers, _ = S.synth(us, S.unet_rules(2, True), 0, "F16")
    _assert_trees_equal(unet, diffusers)
    n = len(KLVAE_TINY_TEST.block_out_channels)
    _assert_trees_equal(P.ldm_vae_to_diffusers(parts["vae"], n),
                        J.ldm_vae_to_diffusers(parts["vae"], n))
    vae = P.convert_vae_compvis(parts["vae"], KLVAE_TINY_TEST.block_out_channels,
                                KLVAE_TINY_TEST.layers_per_block)
    _assert_trees_equal(vae, J.convert_vae_compvis(
        parts["vae"], KLVAE_TINY_TEST.block_out_channels,
        KLVAE_TINY_TEST.layers_per_block))
    assert set(S.leaf_shapes(vae)) == set(vs)


def test_pretrained_unet_loads_from_pipe_dir_and_single_file(tmp_path):
    """``load_pretrained_backbone`` for sd15 from ``unet/`` of a pipe
    directory and from a CompVis single file: the same tree, every
    parameter of the UNet built by the frontend equal to its synthesized
    value; PixelDiT loads from a raw ``.pth`` beside them and a family
    that no package has raises."""
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.common import (build_backbone,
                                                load_pretrained_backbone)
    from yat_tpu_torch.models.unet import UNet2DCondition

    _, cfg = _configs("sd15")
    us = _shapes(lambda: UNet2DCondition(cfg))
    S.write_checkpoint(str(tmp_path / "pipe" / "unet"), us,
                       S.unet_rules(2, True), 0, "BF16")
    single = str(tmp_path / "sd15.safetensors")
    S.write_compvis_single_file(single, us, cfg, 0, "BF16")
    base = {"batch_size": "1", "learning_rate": "1e-4", "steps": "1",
            "num_steps_per_validation": "1"}
    p1 = TrainingParameters.from_dict(
        {**base, "pretrained_pipe_path": str(tmp_path / "pipe")})
    p2 = TrainingParameters.from_dict(
        {**base, "pretrained_pipe_single_file": single})
    t1 = load_pretrained_backbone(p1, "sd15", cfg)
    t2 = load_pretrained_backbone(p2, "sd15", cfg)
    _assert_trees_equal(t2, t1)
    m = build_backbone(lambda: UNet2DCondition(cfg, dtype=torch.float32),
                       p2, "sd15", cfg, "cpu")
    want = dict(S.expected_values(us, S.unet_rules(2, True), 0, "BF16"))
    for path, t in flax_params(m).items():
        np.testing.assert_array_equal(t.numpy(), want[path])
    from tests.test_torch_port_pixeldit import write_tiny_checkpoint
    from yat_tpu_torch.models.pixeldit import PIXELDIT_TINY_TEST
    pth = str(tmp_path / "pixeldit.pth")
    shapes, _ = write_tiny_checkpoint(pth)
    p3 = TrainingParameters.from_dict({**base,
                                       "pretrained_model_path": pth})
    assert S.leaf_shapes(load_pretrained_backbone(
        p3, "pixeldit", PIXELDIT_TINY_TEST)) == shapes
    with pytest.raises(ValueError, match="unknown model family"):
        load_pretrained_backbone(p1, "dit-xl", None)


# ---------------------------------------------------------------------------
# the attention launches at the shipped shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,side,want", [
    ("sd15", 64, {("self", "flash"): 10, ("cross", "folded"): 5,
                  ("cross", "native"): 5, ("self", "xla"): 6,
                  ("cross", "xla"): 6}),
    ("sdxl", 128, {("self", "flash"): 70, ("cross", "folded"): 10,
                   ("cross", "native"): 60}),
])
def test_attention_calls_take_the_jax_branches(monkeypatch, family, side,
                                               want):
    """One denoiser forward on the square bucket (SD1.5 at 512 px, SDXL at
    1024 px): every attention's branch through the JAX package's own gates
    (``_use_vmem_attn``, ``_use_pallas_flash`` with the backend a TPU, and
    ``_vmem_attention``'s native-layout test) equals the port's
    ``attention_branch``, and the counts per forward are those the
    kernels' launch checks expect (SD1.5: 10 K6, 5 K4, 5 K2; SDXL: 70 K6,
    10 K4, 60 K2)."""
    from types import SimpleNamespace

    import yat_tpu.ops.attention as JA
    from yat_tpu_torch.models.unet import SD15_UNET, SDXL_UNET, \
        attention_calls
    from yat_tpu_torch.ops.attention import attention_branch

    monkeypatch.setattr(JA.jax, "default_backend", lambda: "tpu")
    cfg = SD15_UNET if family == "sd15" else SDXL_UNET
    got = {}
    for kind, nq, nk, h, d in attention_calls(cfg, side, side):
        q, k = (SimpleNamespace(shape=(2, n, h, d)) for n in (nq, nk))
        if JA._use_vmem_attn(q, k, k):
            nkp = -(-nk // 128) * 128
            vmem_bwd = 3 * (nq + 2 * nkp) * h * d * 2 + 3 * nq * nkp * 4
            native = (h * d) % 128 == 0 and vmem_bwd <= 12 * 2 ** 20
            jbranch = "native" if native else "folded"
        else:
            jbranch = "flash" if JA._use_pallas_flash(q, k, k) else "xla"
        branch = attention_branch(nq, nk, h, d)
        assert branch == jbranch, (kind, nq, nk, h, d)
        got[(kind, branch)] = got.get((kind, branch), 0) + 1
    assert got == want


# ---------------------------------------------------------------------------
# the ComfyUI export
# ---------------------------------------------------------------------------

def test_comfyui_export_matches_jax(tmp_path):
    """An SDXL-shaped adapter tree (LoRA on every attention projection and
    the resnets' time_emb_proj) through both packages' ComfyUI converter:
    the same lora_unet_* keys and arrays; the CLI reads the trainer's
    export and writes the same file the JAX CLI writes."""
    from yat_tpu.adapters import comfyui as J
    from yat_tpu.adapters.io import save_adapter_safetensors
    from yat_tpu_torch.adapters import comfyui as P
    from yat_tpu_torch.adapters.io import read_safetensors

    rng = np.random.default_rng(0)
    tree = {}
    for head in ("down_1_attn_0", "mid_attn", "up_1_attn_2", "up_0_attn_1"):
        for proj in TARGETS:
            tree.setdefault(head, {}).setdefault(
                "transformer_blocks_1", {}).setdefault("attn2", {})[proj] = {
                "lora_a": rng.standard_normal((8, 4)).astype(np.float32),
                "lora_b": rng.standard_normal((4, 8)).astype(np.float32)}
    for head in ("down_0_resnet_1", "up_2_resnet_0", "mid_resnet_1"):
        tree[head] = {"time_emb_proj": {
            "lora_a": rng.standard_normal((8, 4)).astype(np.float32),
            "lora_b": rng.standard_normal((4, 8)).astype(np.float32)}}
    got = P.convert_sdxl_adapters_to_comfyui(tree, {}, 16.0)
    want = J.convert_sdxl_adapters_to_comfyui(tree, {}, 16.0)
    _assert_trees_equal(got, want)
    assert "lora_unet_middle_block_1_transformer_blocks_1_attn2_to_out_0" \
        ".lora_down.weight" in got

    meta = jax.tree.map(lambda _: {"lora_scale": np.float32(0.5)},
                        tree, is_leaf=lambda x: "lora_a" in x)
    src = str(tmp_path / "adapter_model.safetensors")
    save_adapter_safetensors(src, tree, meta)
    P.main([src, str(tmp_path / "port.safetensors")])
    J.main([src, str(tmp_path / "jax.safetensors")])
    a, _ = read_safetensors(str(tmp_path / "port.safetensors"))
    b, _ = read_safetensors(str(tmp_path / "jax.safetensors"))
    _assert_trees_equal(a, b)
