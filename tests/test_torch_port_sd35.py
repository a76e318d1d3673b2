"""PyTorch port, SD3.5 on the CPU, against ``yat_tpu`` on the same numpy
inputs and weights: the joint attention's route (K6/K6b called directly;
their plain versions here) against ``jax.nn.dot_product_attention``; the
MMDiT's blocks (plain, MMDiT-X dual, last) and the whole tiny MMDiT with
every leaf carried across by ``load_flax_params``; the published position
table, which the JAX package does not compute (a reference fault: the JAX
side is given the published table here); the kernel calls of a forward;
one LoKr step on a tiny SD3.5-shaped batch against the JAX package's
step's loss and gradients; the converter on a synthesized
``SD3Transformer2DModel`` file; ``KLVAE_SD35``'s shift and scale; the
pooled concat and the CLIP/T5 join; the trainer's entry point with
``low_vram``, EMA validation and the tiled decode; ``serve`` and
``generate`` with ``--family sd35``; the ``mesh_shape`` refusal.

Tolerances as the JAX tests pin them: fp32 modules 2e-5, the attention's
VJP 2e-4, gradients 1e-4 of the largest entry."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import tools.synth_checkpoint as S
from tests.test_torch_port_unet import numpy_params
from yat_tpu_torch.convert import (flax_params, load_flax_adapters,
                                   load_flax_params)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

FWD_TOL = 2e-5
VJP_TOL = 2e-4
GRAD_TOL = 1e-4
TARGETS = ["to_q", "to_k", "to_v", "to_out"]
# the tiny MMDiT with one MMDiT-X block, at the tiny encoders' widths
# (the tiny CLIPs give 32 + 32 wide states and pooled vectors)
TINY_SD35 = {"hidden_dim": "32", "num_layers": "2", "num_heads": "2",
             "caption_dim": "64", "pooled_dim": "64", "max_caption_len": "24",
             "mlp_ratio": "1.0", "dual_attention_layers": ["0"],
             "tiny_encoders": "1"}


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _published_pos_embed(h, w, dim, max_size, base_size):
    """diffusers' SD3 ``PatchEmbed`` table written out on its own:
    ``get_2d_sincos_pos_embed(dim, max_size, base_size=base_size)`` (a
    meshgrid of the w then h coordinates ``arange / (max_size /
    base_size)``, the first half of each embedding from the first grid)
    and ``cropped_pos_embed``'s centre crop."""
    grid_h = np.arange(max_size, dtype=np.float32) / (max_size / base_size)
    grid_w = np.arange(max_size, dtype=np.float32) / (max_size / base_size)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, max_size, max_size])

    def one_d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64)
        omega /= d / 2.0
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    table = np.concatenate([one_d(dim // 2, grid[0]),
                            one_d(dim // 2, grid[1])], axis=1)
    top, left = (max_size - h) // 2, (max_size - w) // 2
    table = table.reshape(max_size, max_size, dim)[top:top + h,
                                                   left:left + w]
    return table.reshape(h * w, dim).astype(np.float32)


@pytest.fixture
def published_pos_embed(monkeypatch):
    """The JAX MMDiT given the published table (its own starts an unscaled
    grid at 0 with the row half first)."""
    import yat_tpu.models.mmdit as JM
    from yat_tpu_torch.models.mmdit import pos_embed_2d
    monkeypatch.setattr(JM, "pos_embed_2d", lambda h, w, d: jnp.asarray(
        pos_embed_2d(h, w, d).numpy()))


def test_pos_embed_is_the_published_table():
    """The port's table equals the published formula at SD3.5's grid
    (1024 px: a 64x64 crop of a 192 table of base 64; 256 of the 1536
    widths) and at a tiny odd one; the JAX package's differs (ROADMAP
    §3)."""
    from yat_tpu.models.mmdit import pos_embed_2d as jax_table
    from yat_tpu_torch.models.mmdit import pos_embed_2d

    for h, w, dim, mx, base in ((64, 64, 256, 192, 64), (3, 5, 32, 192, 64),
                                (4, 4, 16, 8, 4)):
        got = pos_embed_2d(h, w, dim, mx, base).numpy()
        np.testing.assert_allclose(
            got, _published_pos_embed(h, w, dim, mx, base), rtol=0,
            atol=1e-6)
    assert np.abs(pos_embed_2d(64, 64, 1536).numpy()
                  - np.asarray(jax_table(64, 64, 1536))).max() > 0.5
    with pytest.raises(ValueError, match="pos_embed_max_size"):
        pos_embed_2d(200, 8, 16)


def test_flash_attention_matches_jax_dot_product_attention():
    """The joint attention's route at a ragged multi-block length (397
    tokens: key blocks of 128, the last of 13): forward 2e-5 and VJP 2e-4
    against ``jax.nn.dot_product_attention``, unmasked, fp32."""
    from yat_tpu_torch.ops.attention import flash_attention

    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((1, 397, 2, 64), np.float32)
                  for _ in range(4))
    out, vjp = jax.vjp(jax.nn.dot_product_attention, *map(jnp.asarray,
                                                            (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = flash_attention(*ts)
    _close(got.detach().numpy(), np.asarray(out), FWD_TOL)
    got.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        _close(t.grad.numpy(), np.asarray(w), VJP_TOL)


def _port_cfg(cfg_j):
    from yat_tpu_torch.models.mmdit import MMDiTConfig
    return MMDiTConfig(**dataclasses.asdict(cfg_j))


@pytest.mark.parametrize("kind", ["plain", "dual", "last"])
def test_mmdit_block_matches_jax(kind):
    """One block of each kind, every leaf from numpy through
    ``load_flax_params``: both streams' outputs (the last block's text
    stream is dropped), fp32 2e-5."""
    from yat_tpu.models.mmdit import MMDIT_TINY_TEST, MMDiTBlock as JB
    from yat_tpu_torch.models.mmdit import MMDiTBlock

    cfg = MMDIT_TINY_TEST
    last, dual = kind == "last", kind == "dual"
    jb = JB(cfg=cfg, last=last, dual=dual, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 32), np.float32)
    ctx = rng.standard_normal((2, 8, 32), np.float32)
    cond = rng.standard_normal((2, 32), np.float32)
    args = tuple(map(jnp.asarray, (x, ctx, cond)))
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0), *args)
    params = numpy_params(shapes["params"], 2)
    want_x, want_c = jb.apply({"params": params}, *args)
    blk = MMDiTBlock(_port_cfg(cfg), last=last, dual=dual,
                     dtype=torch.float32)
    load_flax_params(blk, jax.tree.map(np.asarray, params))
    assert sum(p.numel() for p in blk.parameters()) == sum(
        np.prod(s.shape) for s in jax.tree.leaves(shapes["params"]))
    got_x, got_c = blk(*map(torch.from_numpy, (x, ctx, cond)))
    _close(got_x.detach().numpy(), np.asarray(want_x), FWD_TOL)
    if last:
        assert got_c is None and want_c is None
    else:
        _close(got_c.detach().numpy(), np.asarray(want_c), FWD_TOL)


@functools.lru_cache(maxsize=None)
def _tiny_mmdit():
    """The JAX tiny MMDiT with an MMDiT-X first block, its numpy
    parameters and one batch."""
    from yat_tpu.models.mmdit import MMDIT_TINY_TEST, MMDiT as JM

    cfg = dataclasses.replace(MMDIT_TINY_TEST, dual_attention_layers=(0,))
    jm = JM(cfg=cfg, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    batch = {"latents": rng.standard_normal((2, 8, 8, 16), np.float32),
             "embeddings": rng.standard_normal((2, 8, 16), np.float32),
             "text_mask": np.ones((2, 8), np.int32),
             "pooled_text": rng.standard_normal((2, 16), np.float32)}
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(batch["latents"]),
        jnp.asarray(batch["embeddings"]), jnp.zeros((2,)), None,
        pooled_text=jnp.asarray(batch["pooled_text"]))
    return cfg, jm, numpy_params(shapes["params"], 4), batch


def test_mmdit_matches_jax(published_pos_embed):
    """The whole tiny MMDiT (a dual block, then the last block), the
    pooled text and the timesteps through fp32 paths: 2e-5; the port's
    leaves are the JAX tree's, one for one."""
    from yat_tpu_torch.models.mmdit import MMDiT

    cfg, jm, params, batch = _tiny_mmdit()
    ts = np.array([30.0, 870.0], np.float32)
    want = jm.apply({"params": params}, jnp.asarray(batch["latents"]),
                    jnp.asarray(batch["embeddings"]), jnp.asarray(ts),
                    jnp.asarray(batch["text_mask"]),
                    pooled_text=jnp.asarray(batch["pooled_text"]))
    model = MMDiT(_port_cfg(cfg), dtype=torch.float32)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    assert set(flax_params(model)) == set(S.leaf_shapes(params))
    got = model(torch.from_numpy(batch["latents"]),
                torch.from_numpy(batch["embeddings"]), torch.from_numpy(ts),
                torch.from_numpy(batch["text_mask"]),
                pooled_text=torch.from_numpy(batch["pooled_text"]))
    _close(got.detach().numpy(), np.asarray(want), FWD_TOL)


def test_kernel_calls_list_each_forward(monkeypatch):
    """``kernel_calls`` names every K6 and K1 call of a forward in order
    (the tiny model's, recorded), and at SD3.5-medium's 1024 px: 24 joint
    calls over 4096 + 333 tokens, 13 image-only calls, and 48 norms."""
    from yat_tpu_torch.models import mmdit

    cfg = mmdit.MMDiTConfig(hidden_dim=32, num_layers=3, num_heads=2,
                            caption_dim=16, pooled_dim=16, mlp_ratio=1.0,
                            dual_attention_layers=(1,))
    seen = {"flash_attention": [], "adaln_layernorm": []}
    for name in seen:
        real = getattr(mmdit, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name].append(tuple(a[0].shape))
            return _real(*a, **kw)
        monkeypatch.setattr(mmdit, name, spy)
    model = mmdit.MMDiT(cfg, dtype=torch.float32)
    from yat_tpu_torch.models.layers import init_params
    init_params(model, torch.Generator().manual_seed(0))
    model(torch.zeros(2, 8, 6, 16), torch.zeros(2, 5, 16), torch.ones(2))
    assert seen == mmdit.kernel_calls(cfg, 8, 6, 5, batch=2)
    full = mmdit.kernel_calls(mmdit.SD35_MEDIUM, 128, 128, 333, batch=8)
    attn = full["flash_attention"]
    assert attn.count((8, 4429, 24, 64)) == 24
    assert attn.count((8, 4096, 24, 64)) == 13 and len(attn) == 37
    norms = full["adaln_layernorm"]
    assert len(norms) == 48 and norms.count((8, 333, 1536)) == 23


def _draws_of(jsched, rng_noise, latents):
    """The JAX flow loss's draws from its key (tasks.py)."""
    k_t, k_n, _ = jax.random.split(rng_noise, 3)
    ts, sig = jsched.training_draw(k_t, latents.shape[0])
    return {"timesteps": torch.from_numpy(np.array(ts)),
            "sigmas": torch.from_numpy(np.array(sig)),
            "noise": torch.from_numpy(np.array(jax.random.normal(
                k_n, latents.shape, jnp.float32)))}


def test_lokr_step_matches_jax(tmp_path, monkeypatch, published_pos_embed):
    """``configs/sd35_flow_lokr.yaml``'s step at the tiny size: LoKr on
    to_q/to_k/to_v/to_out of both streams and the MMDiT-X attention, the
    flow loss at shift 3.0 with the pooled text, on the JAX step's draws
    (``yat_tpu/train/step.py``: its key split, ``deterministic=False``):
    the loss, and every adapter leaf's gradient within 1e-4; then the
    port's step runs on the same batch and reports that loss."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JS
    from yat_tpu.train.tasks import make_flow_matching_loss
    from tests.test_torch_port_adapters import _flat, _np, _trained
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import sd35
    from yat_tpu_torch.train.step import loss_and_grads

    monkeypatch.chdir(tmp_path)
    cfg, jm, params, batch = _tiny_mmdit()
    adapters, meta = build_adapter_params(
        {"params": params}, AdapterSpec("lokr", rank=4, alpha=8,
                                        target_modules=TARGETS),
        jax.random.PRNGKey(3))
    adapters = _trained(adapters)
    jsched = JS(shift=3.0)
    jloss = make_flow_matching_loss(jm, jsched, extra_keys=("pooled_text",))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the step's keys: make_train_step splits its rng into the dropout key
    # and the noise key
    _, rng_noise = jax.random.split(jax.random.PRNGKey(42))

    def loss_for(ad):
        return jloss({"params": params, "adapters": ad,
                      "adapters_meta": meta}, jbatch, rng_noise,
                     deterministic=False)
    jl, jg = jax.jit(jax.value_and_grad(loss_for))(adapters)
    jgrads = dict(_flat(jax.device_get(jg)))

    over = {k: str(v) for k, v in dataclasses.asdict(cfg).items()
            if not isinstance(v, tuple) and v is not None}
    raw = {"batch_size": "2", "learning_rate": "1e-3", "steps": "1",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "warmup_steps": "0", "train_unconditional_prob": "0",
           "lora_rank": "4", "lora_alpha": "8", "lora_algo": "lokr",
           "lora_target_modules": TARGETS, "dataset_seed": "0",
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": {**over, "dual_attention_layers": ["0"]}}
    trainer = sd35.make_trainer(TrainingParameters.from_dict(raw),
                                sampler=[], device="cpu",
                                weights={"transformer": _np(params)})
    load_flax_adapters(trainer.model, _np(adapters), _np(meta))
    trainer.initialize()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = _draws_of(jsched, rng_noise, batch["latents"])
    loss, grads = loss_and_grads(trainer.task_loss, trainer.trainable_leaves(),
                                 tbatch, torch.Generator(), draws)
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_TOL)
    names = trainer.trainable_names()
    assert set(names) == set(jgrads) and any("x2_to_q" in n for n in names)
    for name, g in zip(names, grads):
        _close(g.numpy(), jgrads[name], GRAD_TOL)
    metrics = trainer._step_fn(tbatch, torch.Generator(), draws)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               rtol=FWD_TOL)


def test_convert_sd3_mmdit_synthesized_file(tmp_path):
    """A synthesized ``SD3Transformer2DModel`` file (BF16, the published
    keys of every leaf, an MMDiT-X block): both packages' converters give
    the same tree, and the port's MMDiT loads it through
    ``pretrained_model_path`` with every parameter at its synthesized
    value and no leaf left over or missing."""
    from yat_tpu.models.convert import load_torch_state_dict as j_load
    from yat_tpu.models.convert_dit import convert_sd3_mmdit as j_convert
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import sd35
    from yat_tpu_torch.models.convert import load_torch_state_dict
    from yat_tpu_torch.models.convert_dit import convert_sd3_mmdit

    params = TrainingParameters.from_dict({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "pretrained_model_path":
        str(tmp_path / "transformer"), "model_config_overrides": TINY_SD35})
    cfg = sd35.build_config(params)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in flax_params(
            sd35.MMDiT(cfg, dtype=torch.float32)).items()}
    rules = S.sd3_rules()
    S.write_checkpoint(str(tmp_path / "transformer"), shapes, rules, 7,
                       "BF16")
    want = dict(S.expected_values(shapes, rules, 7, "BF16"))
    sd = load_torch_state_dict(str(tmp_path / "transformer"))
    tree = convert_sd3_mmdit(sd, cfg.num_layers)
    jtree = j_convert(j_load(str(tmp_path / "transformer")), cfg.num_layers)
    assert S.leaf_shapes(tree) == S.leaf_shapes(jtree) and \
        set(S.leaf_shapes(tree)) == set(shapes)
    flat, jflat = (dict(_flat_tree(t)) for t in (tree, jtree))
    for path, value in flat.items():
        np.testing.assert_array_equal(value, jflat[path], err_msg=path)
    model = sd35.build_mmdit(params, cfg, "cpu")
    got = flax_params(model)
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path].detach().numpy(), value,
                                      err_msg=path)


def _flat_tree(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_tree(v, path)
        else:
            yield path, np.asarray(v)


def test_klvae_sd35_shift_and_scale():
    """``KLVAE_SD35`` is the JAX preset; on the same (tiny) weights the
    port's ``encode_mode`` subtracts the shift before the scale and
    ``decode`` undoes both, as the JAX VAE does."""
    from yat_tpu.models.vae import KLVAE_SD35 as J35, KLVAE_TINY_TEST
    from yat_tpu.models.vae import AutoencoderKL as JV
    from yat_tpu_torch.models.vae import KLVAE_SD35, AutoencoderKL, \
        KLVAEConfig

    assert dataclasses.asdict(KLVAE_SD35) == dataclasses.asdict(J35)
    jcfg = dataclasses.replace(KLVAE_TINY_TEST, latent_channels=16,
                               scaling_factor=1.5305, shift_factor=0.0609)
    jv = JV(cfg=jcfg)
    x = np.random.default_rng(5).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(jv.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = numpy_params(shapes["params"], 6)
    jz = jv.apply({"params": params}, jnp.asarray(x), method=jv.encode_mode)
    jimg = jv.apply({"params": params}, jz, method=jv.decode)
    tv = AutoencoderKL(KLVAEConfig(**dataclasses.asdict(jcfg)))
    load_flax_params(tv, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        z = tv.encode_mode(torch.from_numpy(x))
        img = tv.decode(z)
        mean = tv.encode(torch.from_numpy(x))[0]
    _close(z.numpy(), np.asarray(jz), FWD_TOL)
    _close(img.numpy(), np.asarray(jimg), FWD_TOL)
    np.testing.assert_allclose(z.numpy(), (mean.numpy() - 0.0609) * 1.5305,
                               rtol=1e-6, atol=1e-6)


def _params(over=None, **kw):
    from yat_tpu_torch.config import TrainingParameters
    raw = {"batch_size": "2", "learning_rate": "1e-3", "steps": "2",
           "num_steps_per_validation": "100", "aspect_ratio": "256",
           "model_config_overrides": dict(TINY_SD35 if over is None
                                             else over)}
    raw.update(kw)
    return TrainingParameters.from_dict(raw)


def test_builders_pick_sd35_parts(monkeypatch):
    """At full size the SD3.5 builder takes CLIP-L with its projection and
    OpenCLIP-G, both on their penultimate states (diffusers' SD3 pipeline;
    the JAX builder gives CLIP-L's final states, ROADMAP §3), T5-XXL in
    fp32 and ``KLVAE_SD35`` (built on the meta device here)."""
    from yat_tpu_torch.frontends import common, sd35

    built = []

    def meta_component(params, sub, convert, module_fn, device, seed,
                       dtype=None, tree=None):
        with torch.device("meta"):
            m = module_fn()
        built.append((sub, m))
        return m
    monkeypatch.setattr(common, "build_pipe_component", meta_component)
    monkeypatch.setattr(sd35, "build_pipe_component", meta_component)
    full = _params({})
    sd35.build_sd35_encoders(full, sd35.build_config(full), "cpu")
    parts = dict(built)
    assert sorted(parts) == ["text_encoder", "text_encoder_2",
                             "text_encoder_3", "vae"]
    assert parts["text_encoder"].cfg.penultimate and \
        parts["text_encoder"].cfg.projection_dim == 768
    assert parts["text_encoder_2"].cfg.penultimate
    assert parts["text_encoder_3"].cfg.num_layers == 24 and \
        parts["text_encoder_3"].dtype == torch.float32
    assert parts["vae"].cfg.latent_channels == 16 and \
        parts["vae"].cfg.shift_factor == 0.0609


def test_pooled_concat_and_clip_t5_join():
    """The caption states: the tiny CLIPs' ``[16, 32 + 32]`` states, then
    T5's compressed states zero-padded to the caption width
    (the JAX ``_join_clip_t5``); the pooled text: CLIP-L's projected
    pooled vector beside OpenCLIP-G's, one CLIP forward a batch."""
    from yat_tpu_torch.frontends import sd35
    from yat_tpu_torch.frontends.sdxl import build_sdxl_encoders

    p = _params()
    cfg = sd35.build_config(p)
    _, ec, ep, dl = sd35.build_sd35_encoders(p, cfg, "cpu", images=False)
    caps = ["a red fox in the snow", "a lighthouse"]
    joined, pooled = ec(caps), ep(caps)
    _, clip, pool_g, _, pool_l = build_sdxl_encoders(
        p, "cpu", images=False, return_pool_l=True, clip_l_projection=True,
        include_vae=False)
    from yat_tpu_torch.frontends.common import make_caption_encoder
    t5 = ec.module
    from yat_tpu_torch.utils.tokenizer import load_tokenizer
    enc_t5 = make_caption_encoder(t5, load_tokenizer(
        None, vocab_size=t5.cfg.vocab_size, max_length=24), 24, "cpu", False)
    for row, c, t in zip(joined, clip(caps), enc_t5(caps)):
        assert row.shape == (c.shape[0] + t.shape[0], 64)
        np.testing.assert_array_equal(row[:c.shape[0], :c.shape[1]], c)
        np.testing.assert_array_equal(row[c.shape[0]:, :t.shape[1]], t)
        assert not row[c.shape[0]:, t.shape[1]:].any()
    np.testing.assert_array_equal(
        pooled, np.concatenate([pool_l(caps), pool_g(caps)], -1))
    assert pooled.shape == (2, 64)
    assert dl.module.cfg.latent_channels == 16


def _feature_shard(path, n=4, lat=(8, 8)):
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(0)
    with TarShardWriter(str(path)) as w:
        for i in range(n):
            w.write({"__key__": f"{i:06d}", "ratio": "1.0",
                     "latent.npy": rng.standard_normal((*lat, 16),
                                                       dtype=np.float32),
                     "emb.npy": rng.standard_normal((16 + 2 * i, 64),
                                                    dtype=np.float32),
                     "pooled.npy": rng.standard_normal((64,),
                                                       dtype=np.float32)})
    return str(path)


def _write_config(tmp_path, **kw):
    cfg = {"batch_size": "2", "learning_rate": "1e-3", "steps": "2",
           "warmup_steps": "1", "num_steps_per_validation": "2",
           "validation_prompts": ["a macro photo of a spiderweb"],
           "bfloat16": "false", "use_ema": "true", "low_vram": "true",
           "lora_rank": "4", "lora_alpha": "4", "lora_algo": "lokr",
           "lora_target_modules": TARGETS, "aspect_ratio": "256",
           "local_shard_paths": [_feature_shard(tmp_path / "s.tar")],
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": TINY_SD35}
    cfg.update(kw)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_entry_point_trains_lokr_with_low_vram(tmp_path, monkeypatch):
    """``python -m yat_tpu_torch.frontends.sd35`` as the shipped config
    at the tiny size: LoKr, EMA, ``low_vram`` (block remat, encoders on
    the host between calls, the tiled decode), feature shards with
    ``pooled.npy``; each forward gets the shard's pooled text, the
    remat recomputes every block once, validation runs on the EMA leaves
    and the export lands."""
    from yat_tpu_torch.frontends.sd35 import main
    from yat_tpu_torch.models.mmdit import MMDiT, MMDiTBlock

    monkeypatch.chdir(tmp_path)
    seen, blocks = [], []
    real, real_blk = MMDiT.forward, MMDiTBlock.forward

    def spy(self, *a, pooled_text=None, **kw):
        seen.append((torch.is_grad_enabled(), pooled_text))
        return real(self, *a, pooled_text=pooled_text, **kw)

    def blk_spy(self, *a, **kw):
        blocks.append(torch.is_grad_enabled())
        return real_blk(self, *a, **kw)
    monkeypatch.setattr(MMDiT, "forward", spy)
    monkeypatch.setattr(MMDiTBlock, "forward", blk_spy)
    trainer = main(["--config", _write_config(tmp_path), "--device", "cpu"])
    assert trainer.global_step == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert (tmp_path / "out" / "2" / "adapter_model.safetensors").exists()
    train = [p for grad, p in seen if grad]
    assert len(train) == 2 and all(
        p.shape == (2, 64) and bool(p.abs().sum() > 0) for p in train)
    # 2 blocks a forward, run again in each backward
    assert blocks.count(True) == 2 * 2 * 2
    sampled = [p for grad, p in seen if not grad]
    # validation: 20 Euler steps of CFG at batch 2 (the prompt, then "")
    assert len(sampled) == 20 and sampled[0].shape == (2, 64)


def test_serve_and_generate_sd35_on_cpu(tmp_path):
    """``serve`` answers a request and ``generate`` writes a PNG for
    ``--family sd35`` at the tiny size (2 Euler steps)."""
    from yat_tpu_torch import generate
    from yat_tpu_torch.serve import build_sampler

    s = build_sampler(_params(), "sd35", max_batch=2, device="cpu", steps=2)
    try:
        img = s.submit("a red fox", timeout=300)
        # 256 px over 8 = 32 latents, the tiny VAE's 2x decode: 64 px
        assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    finally:
        s.stop()
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "aspect_ratio": "256",
        "model_config_overrides": TINY_SD35}))
    out = tmp_path / "out"
    generate.main(["--config", str(cfg), "--family", "sd35", "--prompt",
                   "a red fox", "--steps", "2", "--out", str(out),
                   "--device", "cpu"])
    assert len((out / "prompts.txt").read_text().splitlines()) == 1


def test_mesh_shape_beyond_one_device_raises(tmp_path, monkeypatch, capsys):
    """The shipped config's ``mesh_shape: {dp: 2, fsdp: 4}`` needs 8
    devices: the port's trainer raises, naming the key and ROADMAP item
    12, where the JAX trainer's mesh raises too; a mesh of one trains as
    before; ``compilation_cache_dir`` is said to be unread once."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.parallel.mesh import create_mesh
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import sd35
    from yat_tpu_torch.train import engine

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(engine, "_SAID", set())
    with open(f"{__import__('chip_smoke').REPO}/configs/sd35_flow_lokr.yaml"
              ) as f:
        shipped = yaml.safe_load(f)
    assert shipped["mesh_shape"] == {"dp": 2, "fsdp": 4}
    with pytest.raises(ValueError, match="needs 8 devices"):
        create_mesh(JParams.from_dict({**shipped, "urls": []}).mesh_shape,
                    jax.devices()[:1])
    raw = {"batch_size": "2", "learning_rate": "1e-3", "steps": "1",
           "num_steps_per_validation": "100", "lora_rank": "4",
           "lora_algo": "lokr", "lora_target_modules": TARGETS,
           "output_dir": str(tmp_path / "out"),
           "compilation_cache_dir": str(tmp_path / "xla"),
           "model_config_overrides": TINY_SD35}
    with pytest.raises(ValueError, match=r"mesh_shape.*8 devices.*item 12"):
        sd35.make_trainer(TrainingParameters.from_dict(
            {**raw, "mesh_shape": shipped["mesh_shape"]}), sampler=[],
            device="cpu")
    for _ in range(2):
        trainer = sd35.make_trainer(TrainingParameters.from_dict(
            {**raw, "mesh_shape": {"dp": 1, "fsdp": 1}}), sampler=[],
            device="cpu")
    assert trainer.params.mesh_shape == {"dp": 1, "fsdp": 1}
    said = capsys.readouterr().out
    assert said.count("compilation_cache_dir") == 1


def test_chip_smoke_sd35_phases_on_cpu():
    """``chip_smoke.py``'s SD3.5 phases rehearsed at the tiny size: the
    HTTP serve phase (4 concurrent requests and one more, the images and
    the repeated prompt; no launch on the CPU), then the shipped LoKr
    config's training phase (4 steps, EMA validation at the last, every
    LoKr leaf changed and exported, the launch model by step)."""
    import chip_smoke

    cpu = torch.device("cpu")
    # 64 px (below the bin tables' 256, set past the config's check): 8x8
    # latents, the tiny VAE's 2x decode gives 16 px images
    params = chip_smoke.serve_params(aspect_ratio="256",
                                     model_config_overrides=TINY_SD35)
    params.bfloat16, params.aspect_ratios = False, 64
    counts = chip_smoke.phase_sd35_serve(cpu, "cpu", params, px=16,
                                         window_ms=2000.0)
    assert "flash_attention" in counts and not any(counts.values())
    out = chip_smoke.phase_sd35_train(cpu, "cpu", tiny=TINY_SD35)
    assert set(out) == set(chip_smoke.SD35_KERNELS) and not any(
        out.values())


def test_chip_smoke_sd35_launch_model():
    """The launch counts the phases expect at SD3.5-medium's 1024 px: a
    CFG call is 37 K6 and 48 K1; a ``low_vram`` training step 74 K6, 95
    K1, 37 K6b and 48 K1b; LoKr on the four targets adapts 243
    projections; the train config is the shipped one but for its files,
    its mesh, its steps and its validation cadence."""
    import chip_smoke
    from yat_tpu_torch.models.mmdit import SD35_MEDIUM

    assert chip_smoke.sd35_launches(SD35_MEDIUM, (128, 128), (1, 0)) == {
        "flash_attention": 37, "adaln_layernorm": 48,
        "flash_attention_bwd": 0, "adaln_layernorm_bwd": 0,
        "attention_xla": 0}
    assert chip_smoke.sd35_launches(SD35_MEDIUM, (128, 128), (1, 1),
                                    remat=True) == {
        "flash_attention": 74, "adaln_layernorm": 95,
        "flash_attention_bwd": 37, "adaln_layernorm_bwd": 48,
        "attention_xla": 0}
    assert chip_smoke.sd35_adapted(SD35_MEDIUM) == 243
    # the feature sampler pads captions to the 333-token budget, or to
    # the rungs 128, 256 and 333 under caption_length_bucketing
    from yat_tpu_torch.data.sampler import caption_length_buckets
    assert SD35_MEDIUM.max_caption_len == 333
    assert caption_length_buckets(333) == (128, 256, 333)
    with open(f"{chip_smoke.REPO}/configs/sd35_flow_lokr.yaml") as f:
        shipped = yaml.safe_load(f)
    cfg = chip_smoke.sd35_train_config("a.tar", "out", "ckpt")
    assert "pretrained_pipe_path" not in cfg and "mesh_shape" not in cfg
    assert cfg["steps"] == cfg["num_steps_per_validation"] == "4"
    for key in ("batch_size", "learning_rate", "warmup_steps", "use_ema",
                "low_vram", "lora_rank", "lora_alpha", "lora_algo",
                "lora_target_modules", "validation_prompts", "bfloat16"):
        want = shipped[key]
        assert cfg[key] == (want if isinstance(want, list) else str(want))


def test_chip_smoke_sd35_depth_cut_keeps_every_block_kind():
    """The smoke's SD3.5 depth cut removes blocks only: the cut model still
    holds MMDiT-X blocks, a plain MMDiT block and the published last block
    (no second attention, no text output), and its launches are the full
    model's less the blocks cut."""
    import chip_smoke
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.sd35 import build_config
    from yat_tpu_torch.models.mmdit import MMDiT, SD35_MEDIUM

    cfg = build_config(TrainingParameters.from_dict(
        chip_smoke.sd35_train_config("a.tar", "out", "ckpt",
                                     **chip_smoke.depth_cut("sd35"))))
    assert cfg.num_layers == 4 and cfg.dual_attention_layers == (0, 1)
    assert dataclasses.replace(
        cfg, num_layers=SD35_MEDIUM.num_layers,
        dual_attention_layers=SD35_MEDIUM.dual_attention_layers) == \
        SD35_MEDIUM
    with torch.device("meta"):
        blocks = MMDiT(cfg).blocks
    kinds = [(b.dual, b.last) for b in blocks]
    assert (True, False) in kinds and (False, False) in kinds
    assert kinds[-1] == (False, True)
    assert chip_smoke.sd35_launches(cfg, (128, 128), (1, 0)) == {
        "flash_attention": 6, "adaln_layernorm": 8,
        "flash_attention_bwd": 0, "adaln_layernorm_bwd": 0,
        "attention_xla": 0}
    assert chip_smoke.sd35_adapted(cfg) == 8 * 4 - 1 + 4 * 2
