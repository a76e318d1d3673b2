"""PyTorch port, Flux-2 Klein on the CPU, against ``yat_tpu`` on the same
numpy inputs and weights: the packing, id and RoPE helpers; both block
kinds and the whole tiny transformer with every leaf (the modulation too)
drawn nonzero and carried across by ``load_flax_params``; the kernel
calls of a forward and of a LoRA step; ``make_flux_loss``'s loss and
every LoRA gradient on the JAX step's draws, with and without batch-norm
statistics; ``sample_flux`` with and without CFG and with the velocity
cache; the converter on a synthesized ``FluxTransformer2DModel`` file;
the builders (fp32 Gemma-2, ``KLVAE_FLUX``, 512 caption tokens) and the
``text_dim`` check beside the JAX package's failure; the entry point
training LoRA from feature shards and from raw images; ``serve`` and
``generate`` with ``--family flux`` (DPM refused); ``chip_smoke.py``'s
Flux phases rehearsed.

Tolerances as the JAX tests pin them: the helpers 1e-6, fp32 modules
2e-5, gradients 1e-4 of the largest entry; sampling 1e-4 (up to 4 model
calls, each difference carried through CFG 7.0)."""

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

HELPER_TOL = 1e-6
FWD_TOL = 2e-5
GRAD_TOL = 1e-4
SAMPLE_TOL = 1e-4
TARGETS = ["to_q", "to_k", "to_v", "to_out"]
# the tiny Flux on 16-channel latents patchified 2x2, at the tiny Gemma's
# width (32)
TINY_FLUX = {"in_channels": "64", "hidden_dim": "32",
             "num_double_blocks": "1", "num_single_blocks": "1",
             "num_heads": "2", "text_dim": "32", "axes_dims": ["4", "6", "6"],
             "tiny_encoders": "1"}


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _port_cfg(cfg_j):
    from yat_tpu_torch.models.flux import FluxConfig
    return FluxConfig(**dataclasses.asdict(cfg_j))


def test_packing_ids_and_rope_match_jax():
    """patchify/unpatchify, pack/unpack, standardize, the latent and text
    ids, ``rope_freqs`` and ``apply_rope_pairs`` (fp32, interleaved pairs)
    against the JAX helpers, 1e-6; the round trips are exact."""
    import yat_tpu.models.flux as J
    import yat_tpu_torch.models.flux as P

    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 6, 8, 3), np.float32)
    mean, var = (rng.standard_normal(12).astype(np.float32),
                 rng.uniform(0.5, 2, 12).astype(np.float32))
    x = P.patchify_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(x.numpy(),
                                  np.asarray(J.patchify_latents(lat)))
    assert torch.equal(P.unpatchify_latents(x), torch.from_numpy(lat))
    np.testing.assert_allclose(
        P.standardize_latents(x, torch.from_numpy(mean),
                              torch.from_numpy(var)).numpy(),
        np.asarray(J.standardize_latents(jnp.asarray(x.numpy()), mean, var)),
        rtol=HELPER_TOL, atol=HELPER_TOL)
    tok = P.pack_latents(x)
    assert torch.equal(P.unpack_latents(tok, (3, 4)), x)
    ids = P.latent_ids(3, 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(J.latent_ids(3, 4)))
    np.testing.assert_array_equal(P.text_ids(5).numpy(),
                                  np.asarray(J.text_ids(5)))
    all_ids = torch.cat([P.text_ids(5), ids])
    cos, sin = P.rope_freqs(all_ids, (4, 6, 6), 10000.0)
    jc, js = J.rope_freqs(jnp.asarray(all_ids.numpy()), (4, 6, 6), 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=HELPER_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), atol=HELPER_TOL)
    q = rng.standard_normal((2, 17, 2, 16), np.float32)
    np.testing.assert_allclose(
        P.apply_rope_pairs(torch.from_numpy(q), cos, sin).numpy(),
        np.asarray(J.apply_rope_pairs(q, jc, js)), rtol=HELPER_TOL,
        atol=HELPER_TOL)


def _block_inputs(cfg, n_txt=5, gh=3, gw=4, seed=1):
    import yat_tpu.models.flux as J
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, gh * gw, cfg.hidden_dim), np.float32)
    txt = rng.standard_normal((2, n_txt, cfg.hidden_dim), np.float32)
    cond = rng.standard_normal((2, cfg.hidden_dim), np.float32)
    ids = jnp.concatenate([J.text_ids(n_txt), J.latent_ids(gh, gw)], 0)
    cos, sin = J.rope_freqs(ids, cfg.axes_dims, cfg.theta)
    return img, txt, cond, np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("kind", ["double", "single"])
def test_flux_block_matches_jax(kind):
    """One block of each kind, every leaf (the zero-initialised modulation
    too) drawn from numpy and loaded through ``load_flax_params``: its
    outputs, fp32 2e-5."""
    import yat_tpu.models.flux as J
    import yat_tpu_torch.models.flux as P

    cfg = J.FLUX_TINY_TEST
    img, txt, cond, cos, sin = _block_inputs(cfg)
    if kind == "double":
        jb = J.FluxDoubleBlock(cfg=cfg, dtype=jnp.float32)
        args = (img, txt, cond, cos, sin)
        blk = P.FluxDoubleBlock(_port_cfg(cfg), dtype=torch.float32)
    else:
        jb = J.FluxSingleBlock(cfg=cfg, dtype=jnp.float32)
        args = (np.concatenate([txt, img], 1), cond, cos, sin)
        blk = P.FluxSingleBlock(_port_cfg(cfg), dtype=torch.float32)
    jargs = tuple(map(jnp.asarray, args))
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0), *jargs)
    params = numpy_params(shapes["params"], 2)
    want = jax.jit(jb.apply)({"params": params}, *jargs)
    load_flax_params(blk, jax.tree.map(np.asarray, params))
    assert set(flax_params(blk)) == set(S.leaf_shapes(params))
    got = blk(*map(torch.from_numpy, args))
    for g, w in zip(got if kind == "double" else [got],
                    want if kind == "double" else [want]):
        _close(g.detach().numpy(), np.asarray(w), FWD_TOL)


@functools.lru_cache(maxsize=None)
def _tiny_flux(in_channels=16):
    """The JAX tiny Flux, its numpy parameters (the modulation drawn) and
    one feature batch: latents ``[2, 8, 8, 4]`` (patchified 2x2 to the
    16 input channels) or ``[2, 8, 8, 16]`` at ``in_channels`` 64."""
    import yat_tpu.models.flux as J

    cfg = dataclasses.replace(J.FLUX_TINY_TEST, in_channels=in_channels)
    jm = J.FluxTransformer(cfg=cfg, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    batch = {"latents": rng.standard_normal((2, 8, 8, in_channels // 4),
                                            np.float32),
             "embeddings": rng.standard_normal((2, 6, 16), np.float32),
             "text_mask": np.ones((2, 6), np.int32)}
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, in_channels)),
        jnp.zeros((1, 6, 16)), jnp.full((1,), 0.5), J.latent_ids(4, 4))
    return cfg, jm, numpy_params(shapes["params"], 4), batch


def _port_model(cfg, params):
    from yat_tpu_torch.models.flux import FluxTransformer
    model = FluxTransformer(_port_cfg(cfg), dtype=torch.float32)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    return model


def test_flux_transformer_matches_jax():
    """The whole tiny transformer (a double block, a single block, the
    guidance embedding, the final (scale, shift) modulation) on packed
    tokens and a 6-token caption: 2e-5 with and without a guidance; the
    port's leaves are the JAX tree's, one for one."""
    import yat_tpu.models.flux as J

    cfg, jm, params, _ = _tiny_flux()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 16), np.float32)
    emb = rng.standard_normal((2, 6, 16), np.float32)
    t = np.array([0.03, 0.87], np.float32)
    g = np.array([7.0, 1.5], np.float32)
    ids = J.latent_ids(3, 4)
    model = _port_model(cfg, params)
    assert set(flax_params(model)) == set(S.leaf_shapes(params))
    from yat_tpu_torch.models.flux import latent_ids

    # one compiled JAX forward; its default guidance is ones
    apply = jax.jit(lambda gd: jm.apply({"params": params}, x, emb, t, ids,
                                        guidance=gd))
    for guidance in (None, g):
        want = apply(jnp.ones((2,)) if guidance is None
                     else jnp.asarray(guidance))
        got = model(torch.from_numpy(x), torch.from_numpy(emb),
                    torch.from_numpy(t), latent_ids(3, 4),
                    guidance=None if guidance is None
                    else torch.from_numpy(guidance))
        _close(got.detach().numpy(), np.asarray(want), FWD_TOL)


def test_kernel_calls_list_each_forward_and_step(monkeypatch):
    """``kernel_calls`` names every K6 and K1 call of a forward in order
    (a tiny model's, recorded), and at Flux-2 Klein's 1024 px: 24
    attentions over 4096 + 512 tokens in 24 heads of 128 and 49 norms a
    forward.  A LoRA step runs the backward of every attention and of
    every norm but double block 0's two first ones, whose inputs are all
    frozen (recorded at the tiny size: 2 and 4), as ``chip_smoke``'s
    launch model gives at full size (24 and 47)."""
    import chip_smoke
    from yat_tpu_torch.adapters.builder import AdapterSpec, \
        build_adapter_params
    from yat_tpu_torch.models import flux
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.ops import attention as A
    from yat_tpu_torch.ops import norm as N

    cfg = flux.FluxConfig(in_channels=16, hidden_dim=32,
                          num_double_blocks=2, num_single_blocks=3,
                          num_heads=2, text_dim=16, axes_dims=(4, 6, 6))
    seen = {"flash_attention": [], "adaln_layernorm": []}
    for name in seen:
        real = getattr(flux, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name].append(tuple(a[0].shape))
            return _real(*a, **kw)
        monkeypatch.setattr(flux, name, spy)
    bwd = {"adaln": 0, "flash": 0}
    for mod, name, key in ((N, "adaln_bwd_ref", "adaln"),
                           (A, "flash_attention_bwd_ref", "flash")):
        real = getattr(mod, name)

        def counting(*a, _real=real, _key=key, **kw):
            bwd[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counting)
    model = flux.FluxTransformer(cfg, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with chip_smoke.drawn_modulation():
        init_params(model, gen)
    for p in model.parameters():
        p.requires_grad_(False)
    assert build_adapter_params(model, AdapterSpec(
        "lora", rank=2, alpha=2, target_modules=TARGETS), gen) == \
        chip_smoke.flux_adapted(cfg) == 16
    out = model(torch.randn(2, 20, 16), torch.randn(2, 5, 16),
                torch.rand(2), flux.latent_ids(4, 5))
    assert seen == flux.kernel_calls(cfg, 4, 5, 5, batch=2)
    out.square().mean().backward()
    assert bwd == {"flash": 5, "adaln": 4 * 2 + 3 + 1 - 2}
    full = flux.kernel_calls(flux.FLUX2_KLEIN, 64, 64, 512, batch=8)
    assert full["flash_attention"] == [(8, 4608, 24, 128)] * 24
    norms = full["adaln_layernorm"]
    assert len(norms) == 49 and norms.count((8, 4608, 3072)) == 16
    assert norms.count((8, 4096, 3072)) == 17 and \
        norms.count((8, 512, 3072)) == 16
    assert chip_smoke.flux_launches(flux.FLUX2_KLEIN, (64, 64), 512,
                                    (1, 1)) == {
        "flash_attention": 24, "adaln_layernorm": 49,
        "flash_attention_bwd": 24, "adaln_layernorm_bwd": 47,
        "attention_xla": 0}
    assert chip_smoke.flux_adapted(flux.FLUX2_KLEIN) == 64


def _draws_of(jsched, rng_noise, tokens_shape, grid):
    """The JAX Flux loss's draws from its key (``make_flux_loss``)."""
    k_t, k_n, _ = jax.random.split(rng_noise, 3)
    ts, sig = jsched.training_draw(
        k_t, tokens_shape[0], mu=jsched.mu_for_seq_len(grid[0] * grid[1]))
    return {"timesteps": torch.from_numpy(np.array(ts)),
            "sigmas": torch.from_numpy(np.array(sig)),
            "noise": torch.from_numpy(np.array(jax.random.normal(
                k_n, tokens_shape, jnp.float32)))}


def _flux_params(tmp_path, over=None, **kw):
    from yat_tpu_torch.config import TrainingParameters
    raw = {"batch_size": "2", "learning_rate": "1e-3", "steps": "1",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "warmup_steps": "0", "train_unconditional_prob": "0",
           "lora_rank": "4", "lora_alpha": "8", "lora_algo": "lora",
           "lora_target_modules": TARGETS, "dataset_seed": "0",
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": over or {}}
    raw.update(kw)
    return TrainingParameters.from_dict(raw)


@pytest.mark.parametrize("bn", [False, True], ids=["as-configured", "bn"])
def test_lora_step_matches_jax(tmp_path, monkeypatch, bn):
    """``configs/flux_klein_lora.yaml``'s step at the tiny size: LoRA on
    to_q/to_k/to_v/to_out (both streams of the double block; the single
    block's fused projections match no target), 16-channel latents
    patchified 2x2 and packed, the dynamic shift of 16 tokens, on the JAX
    step's draws (``deterministic=False``): the loss and every LoRA leaf's
    gradient within 1e-4, then the port's step reports that loss.  With
    ``bn`` the same at the function level with batch-norm statistics (the
    frontends pass none)."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JS
    from yat_tpu.train.tasks import make_flux_loss as j_loss
    from tests.test_torch_port_adapters import _flat, _np, _trained
    from yat_tpu_torch.frontends import flux
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flux_loss

    monkeypatch.chdir(tmp_path)
    cfg, jm, params, batch = _tiny_flux(64)
    adapters, meta = build_adapter_params(
        {"params": params}, AdapterSpec("lora", rank=4, alpha=8,
                                        target_modules=TARGETS),
        jax.random.PRNGKey(3))
    adapters = _trained(adapters)
    jsched = JS(use_dynamic_shifting=True, shift=3.0)
    rng = np.random.default_rng(9)
    stats = ((rng.standard_normal(64).astype(np.float32),
              rng.uniform(0.5, 2.0, 64).astype(np.float32)) if bn
             else (None, None))
    jloss = j_loss(jm, jsched, bn_mean=stats[0], bn_var=stats[1])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, rng_noise = jax.random.split(jax.random.PRNGKey(42))

    def loss_for(ad):
        return jloss({"params": params, "adapters": ad,
                      "adapters_meta": meta}, jbatch, rng_noise,
                     deterministic=False)
    jl, jg = jax.jit(jax.value_and_grad(loss_for))(adapters)
    jgrads = dict(_flat(jax.device_get(jg)))

    over = {k: (list(map(str, v)) if isinstance(v, tuple) else str(v))
            for k, v in dataclasses.asdict(cfg).items()}
    trainer = flux.make_trainer(_flux_params(tmp_path, over), sampler=[],
                                device="cpu",
                                weights={"transformer": _np(params)})
    load_flax_adapters(trainer.model, _np(adapters), _np(meta))
    trainer.initialize()
    names = trainer.trainable_names()
    assert set(names) == set(jgrads) and len(names) == 16 and not any(
        "single" in n for n in names)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = _draws_of(jsched, rng_noise, (2, 16, 64), (4, 4))
    task = trainer.task_loss if not bn else make_flux_loss(
        trainer.model, trainer.schedule,
        bn_mean=torch.from_numpy(stats[0]), bn_var=torch.from_numpy(stats[1]))
    loss, grads = loss_and_grads(task, trainer.trainable_leaves(), tbatch,
                                 torch.Generator(), draws)
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_TOL)
    for name, g in zip(names, grads):
        _close(g.numpy(), jgrads[name], GRAD_TOL)
    if not bn:
        metrics = trainer._step_fn(tbatch, torch.Generator(), draws)
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=FWD_TOL)
        # the loss's own draw: the tokens' noise, the shifted sigmas
        own = trainer.task_loss.draw(tbatch, torch.Generator().manual_seed(1))
        assert own["noise"].shape == (2, 16, 64)
        sig = trainer.schedule.sigmas(trainer.schedule.mu_for_seq_len(16))
        assert all(bool((sig == s).any()) for s in own["sigmas"])


@pytest.mark.parametrize("case", ["cfg", "no-cfg", "cache-2"])
def test_sample_flux_matches_jax(case):
    """``sample_flux`` on the tiny transformer over a 4x4 token grid with
    the JAX package's seed-42 noise: 3 Euler steps with CFG 7.0 and the
    guidance embedding, 2 steps without an unconditional caption, and 5
    steps of the velocity cache at interval 2 (4 model calls, step 3
    extrapolated)."""
    from yat_tpu.ops.sampling import sample_flux as j_sample
    from yat_tpu.ops.sampling import seed_noise
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JS
    from yat_tpu_torch.ops.sampling import sample_flux
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule

    cfg, jm, params, _ = _tiny_flux()
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2, 6, 16), np.float32)
    un = np.repeat(rng.standard_normal((1, 6, 16), np.float32), 2, 0)
    steps, interval = {"cfg": (3, 1), "no-cfg": (2, 1),
                       "cache-2": (5, 2)}[case]
    uncond = None if case == "no-cfg" else un
    want = j_sample(jm, {"params": params},
                    JS(use_dynamic_shifting=True, shift=3.0), (4, 4),
                    jnp.asarray(emb), uncond_emb=None if uncond is None
                    else jnp.asarray(uncond), guidance_scale=7.0,
                    num_steps=steps, seed=42, cache_interval=interval)
    model = _port_model(cfg, params)
    with torch.no_grad():
        got = sample_flux(model, FlowMatchSchedule(use_dynamic_shifting=True,
                                                   shift=3.0), (4, 4),
                          torch.from_numpy(emb),
                          uncond_emb=None if uncond is None
                          else torch.from_numpy(uncond), guidance_scale=7.0,
                          num_steps=steps, cache_interval=interval,
                          x0=torch.from_numpy(np.asarray(
                              seed_noise(42, (2, 16, 16)))))
    _close(got.numpy(), np.asarray(want), SAMPLE_TOL)


def test_convert_flux_synthesized_file(tmp_path):
    """A synthesized ``FluxTransformer2DModel`` file (BF16, the published
    keys of every leaf; each single block's ``linear1`` written as
    ``attn.to_q``, ``to_k``, ``to_v`` and ``proj_mlp``): both packages'
    converters give the same tree, and the port's transformer loads it
    through ``pretrained_model_path`` with every parameter at its
    synthesized value."""
    from yat_tpu.models.convert import load_torch_state_dict as j_load
    from yat_tpu.models.convert_dit import convert_flux as j_convert
    from yat_tpu_torch.frontends import flux
    from yat_tpu_torch.models.convert import load_torch_state_dict
    from yat_tpu_torch.models.convert_dit import convert_flux

    params = _flux_params(tmp_path, TINY_FLUX, pretrained_model_path=str(
        tmp_path / "transformer"))
    cfg = flux.build_config(params)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in flax_params(
            flux.FluxTransformer(cfg, dtype=torch.float32)).items()}
    rules = S.flux_rules(cfg.mlp_ratio)
    S.write_checkpoint(str(tmp_path / "transformer"), shapes, rules, 7,
                       "BF16")
    sd = load_torch_state_dict(str(tmp_path / "transformer"))
    assert {"single_transformer_blocks.0.proj_mlp.weight",
            "single_transformer_blocks.0.attn.to_v.bias",
            "transformer_blocks.0.attn.add_q_proj.weight",
            "norm_out.linear.weight"} <= set(sd)
    assert sd["single_transformer_blocks.0.proj_mlp.weight"].shape == (128,
                                                                      32)
    tree = convert_flux(sd, cfg.num_double_blocks, cfg.num_single_blocks)
    jtree = j_convert(j_load(str(tmp_path / "transformer")),
                      cfg.num_double_blocks, cfg.num_single_blocks)
    assert S.leaf_shapes(tree) == S.leaf_shapes(jtree) and \
        set(S.leaf_shapes(tree)) == set(shapes)
    from tests.test_torch_port_sd35 import _flat_tree
    flat, jflat = (dict(_flat_tree(t)) for t in (tree, jtree))
    for path, value in flat.items():
        np.testing.assert_array_equal(value, jflat[path], err_msg=path)
    want = dict(S.expected_values(shapes, rules, 7, "BF16"))
    got = flax_params(flux.build_transformer(params, cfg, "cpu"))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path].detach().numpy(), value,
                                      err_msg=path)


def test_builders_pick_flux_parts(monkeypatch):
    """At full size the Flux builder takes Gemma-2-2B in fp32 (SANA's is
    bf16) and ``KLVAE_FLUX`` (the JAX preset: 16 channels, scale 0.3611,
    shift 0.1159), built on the meta device here; captions of 512 tokens
    (the sampler's budget and the prompt encoder's padding)."""
    from yat_tpu.models.vae import KLVAE_FLUX as JF
    from yat_tpu_torch.frontends import flux
    from yat_tpu_torch.models.vae import KLVAE_FLUX

    assert dataclasses.asdict(KLVAE_FLUX) == dataclasses.asdict(JF)
    built, tokenized = [], []

    def meta_component(params, sub, convert, module_fn, device, seed,
                       dtype=None, tree=None):
        with torch.device("meta"):
            m = module_fn()
        built.append((sub, m))
        return m

    def tokenizer(path, vocab_size=256, max_length=77, **kw):
        tokenized.append(max_length)
        return None
    monkeypatch.setattr(flux, "build_pipe_component", meta_component)
    monkeypatch.setattr("yat_tpu_torch.utils.tokenizer.load_tokenizer",
                        tokenizer)
    from yat_tpu_torch.config import TrainingParameters
    full = TrainingParameters.from_dict({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1"})
    flux.build_flux_encoders(full, "cpu")
    parts = dict(built)
    assert sorted(parts) == ["text_encoder", "vae"]
    te = parts["text_encoder"]
    assert te.cfg.hidden_dim == 2304 and te.cfg.num_layers == 26
    assert {p.dtype for p in te.parameters()} == {torch.float32}
    assert parts["vae"].cfg == KLVAE_FLUX and tokenized == [512]
    assert flux.FLUX_CAPTION_LEN == 512


def test_text_dim_check_and_the_jax_failure(tmp_path):
    """The tiny Gemma (32 wide) against ``text_dim`` 16: the port raises a
    ``ValueError`` naming ``model_config_overrides.text_dim``, both widths
    and the JAX error, before any transformer weight is built (serving,
    and a training run with validation prompts); a feature-shard run
    without prompts builds no encoder and is not checked.  The JAX
    package's ``txt_in``, built 16 wide, fails on the encoder's 32-wide
    states with flax's ``ScopeParamShapeError``."""
    import flax

    import yat_tpu.models.flux as J
    from yat_tpu_torch.frontends import flux

    over = {**TINY_FLUX, "text_dim": "16"}
    built = []
    real = flux.build_transformer
    flux.build_transformer = lambda *a, **k: built.append(1) or real(*a, **k)
    try:
        for make in (
                lambda: flux.make_pipeline(_flux_params(tmp_path, over),
                                           "cpu"),
                lambda: flux.make_trainer(_flux_params(
                    tmp_path, over, validation_prompts=["a fox"]),
                    sampler=[], device="cpu")):
            with pytest.raises(ValueError) as err:
                make()
            msg = str(err.value)
            for part in ("model_config_overrides.text_dim", "16", "32",
                         "ScopeParamShapeError", "/txt_in"):
                assert part in msg
        assert not built
        trainer = flux.make_trainer(_flux_params(tmp_path, over), sampler=[],
                                    device="cpu")
        assert trainer.model.txt_in.in_features == 16 and built
    finally:
        flux.build_transformer = real
    jm = J.FluxTransformer(cfg=dataclasses.replace(
        J.FLUX_TINY_TEST, text_dim=16), dtype=jnp.float32)
    ids = J.latent_ids(2, 2)
    x, t = jnp.zeros((1, 4, 16)), jnp.full((1,), 0.5)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x,
                       jnp.zeros((1, 3, 16)), t, ids)
    with pytest.raises(flax.errors.ScopeParamShapeError, match="txt_in"):
        jax.eval_shape(jm.apply, v, x, jnp.zeros((1, 3, 32)), t, ids)


@pytest.fixture
def small_vae(monkeypatch):
    """The tiny VAE with a third level (compression 4): raw images at the
    256 px bins then give 64x64 latents, where the two-level one's 128x128
    grid makes its mid-block attention 16384 tokens long on the CPU."""
    from yat_tpu_torch.frontends import flux
    real = flux.vae_config
    monkeypatch.setattr(flux, "vae_config", lambda p: dataclasses.replace(
        real(p), block_out_channels=(32, 32, 32)))


def _feature_shard(path, n=4):
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(0)
    with TarShardWriter(str(path)) as w:
        for i in range(n):
            w.write({"__key__": f"{i:06d}", "ratio": "1.0",
                     "latent.npy": rng.standard_normal((8, 8, 16),
                                                       dtype=np.float32),
                     "emb.npy": rng.standard_normal((5 + 2 * i, 32),
                                                    dtype=np.float32)})
    return str(path)


def _write_config(tmp_path, **kw):
    cfg = {"batch_size": "2", "learning_rate": "1e-3", "steps": "2",
           "warmup_steps": "1", "num_steps_per_validation": "2",
           "validation_prompts": ["a macro photo of a spiderweb"],
           "bfloat16": "false", "lora_rank": "4", "lora_alpha": "4",
           "lora_algo": "lora", "lora_target_modules": TARGETS,
           "aspect_ratio": "256", "output_dir": str(tmp_path / "out"),
           "model_config_overrides": TINY_FLUX}
    cfg.update(kw)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("source", ["shards", "on-the-fly"])
def test_entry_point_trains_lora(tmp_path, monkeypatch, small_vae, source):
    """``python -m yat_tpu_torch.frontends.flux`` at the tiny size: LoRA
    on feature shards (16-channel latents, padded captions) with
    ``low_vram`` (each block recomputed in the backward, the tiled
    decode), or on raw JPEGs encoded on the fly (Gemma-2 and the KL-VAE);
    each forward gets the packed tokens, the validation runs 20 CFG calls
    over 512 caption tokens and the export lands."""
    from tests.test_torch_port_encode import make_image_shard
    from yat_tpu_torch.frontends.flux import main
    from yat_tpu_torch.models.flux import FluxDoubleBlock, FluxTransformer

    monkeypatch.chdir(tmp_path)
    seen, blocks = [], []
    real, real_blk = FluxTransformer.forward, FluxDoubleBlock.forward

    def spy(self, x, emb, *a, **kw):
        seen.append((torch.is_grad_enabled(), tuple(x.shape),
                     tuple(emb.shape)))
        return real(self, x, emb, *a, **kw)

    def blk_spy(self, *a, **kw):
        blocks.append(torch.is_grad_enabled())
        return real_blk(self, *a, **kw)
    monkeypatch.setattr(FluxTransformer, "forward", spy)
    monkeypatch.setattr(FluxDoubleBlock, "forward", blk_spy)
    if source == "shards":
        keys = {"low_vram": "true",
                "local_shard_paths": [_feature_shard(tmp_path / "s.tar")]}
    else:
        keys = {"compute_features": "true", "vae_max_batch_size": "2",
                "text_encoder_max_batch_size": "2", "cache_size": "4",
                "local_shard_paths": [make_image_shard(
                    tmp_path / "raw.tar", n=4, hw=(64, 64), wide=False)]}
    trainer = main(["--config", _write_config(tmp_path, **keys),
                    "--device", "cpu"])
    assert trainer.global_step == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert (tmp_path / "out" / "2" / "adapter_model.safetensors").exists()
    assert trainer.family_spec.max_caption_len == 512
    train = [s for grad, *s in seen if grad]
    # 16-channel latents [2, H, W, 16] → 64-channel tokens [2, H*W/4, 64]
    assert len(train) == 2 and all(x[0] == 2 and x[2] == 64
                                   for x, _ in train)
    # shards: 8x8 latents; raw images: 256 px over the VAE's 4
    assert all(x[1] == (16 if source == "shards" else 1024)
               for x, _ in train)
    if source == "shards":
        # 1 double block a forward, run again in each backward
        assert blocks.count(True) == 2 * 2
    sampled = [s for grad, *s in seen if not grad]
    # validation: 20 Euler steps of CFG at batch 2 over a 16x16 grid
    assert len(sampled) == 20 and tuple(sampled[0]) == ((2, 256, 64),
                                                        (2, 512, 32))
    px = 256 // 16 * 2 * trainer.decode_latents.module.cfg.compression
    assert trainer.validation_pipeline(["a fox"])[
        "validation/0/a fox"].shape == (px, px, 3)


def _serve_params(**kw):
    from yat_tpu_torch.config import TrainingParameters
    return TrainingParameters.from_dict({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "aspect_ratio": "256",
        "model_config_overrides": TINY_FLUX, **kw})


def test_serve_and_generate_flux_on_cpu(tmp_path):
    """``serve`` answers a request and ``generate`` writes a PNG for
    ``--family flux`` at the tiny size (2 Euler steps, the cache at
    interval 2 accepted); ``--sampler dpm`` is refused, as the JAX
    package's Flux validation has no DPM ladder."""
    from yat_tpu_torch import generate
    from yat_tpu_torch.serve import build_sampler

    s = build_sampler(_serve_params(), "flux", max_batch=2, device="cpu",
                      steps=2, cache_interval=2)
    try:
        assert s.pipeline.cache_interval == 2 and \
            s.pipeline.guidance_scale == 7.0
        img = s.submit("a red fox", timeout=300)
        # 256 px over 16 = 16x16 tokens, 32x32 latents, the tiny VAE's 2x
        assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    finally:
        s.stop()
    with pytest.raises(ValueError, match="dpm"):
        build_sampler(_serve_params(), "flux", device="cpu", sampler="dpm")
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "aspect_ratio": "256",
        "model_config_overrides": TINY_FLUX}))
    out = tmp_path / "out"
    generate.main(["--config", str(cfg), "--family", "flux", "--prompt",
                   "a red fox", "--steps", "2", "--out", str(out),
                   "--device", "cpu"])
    assert len((out / "prompts.txt").read_text().splitlines()) == 1


def test_chip_smoke_flux_phases_on_cpu(tmp_path, monkeypatch, small_vae):
    """``chip_smoke.py``'s Flux phases rehearsed at the tiny size: the
    HTTP serve phase (4 concurrent requests and one more; no launch on the
    CPU), then the shipped LoRA config's training phase through the
    stand-in S3 endpoint's signed GETs (3 steps, validation at the last,
    every LoRA leaf changed and exported, the launch model by step)."""
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    cpu = torch.device("cpu")
    params = chip_smoke.serve_params(aspect_ratio="256",
                                     model_config_overrides=TINY_FLUX)
    params.bfloat16, params.aspect_ratios = False, 64
    # 64 px (below the bin tables' 256, set past the config's check): 4x4
    # tokens, 8x8 latents, the three-level VAE's 4x decode gives 32 px
    counts = chip_smoke.phase_flux_serve(cpu, "cpu", params, px=32,
                                         window_ms=2000.0)
    assert "flash_attention" in counts and not any(counts.values())
    out = chip_smoke.phase_flux_train(cpu, "cpu", tiny=TINY_FLUX)
    assert list(out) == ["flux train"]
    assert set(out["flux train"]) == set(chip_smoke.FLUX_KERNELS) and \
        not any(out["flux train"].values())


def test_chip_smoke_flux_config_cuts():
    """The train phase's config is the shipped one but for its files (the
    R2 endpoint; its keys, bucket and shard names kept), its pretrained
    pipe, its mesh, ``text_dim``, the run's length and the depth cut (2
    double and 4 single blocks: both kinds run)."""
    import chip_smoke

    with open(f"{chip_smoke.REPO}/configs/flux_klein_lora.yaml") as f:
        shipped = yaml.safe_load(f)
    cfg = chip_smoke.flux_train_config("http://127.0.0.1:1", "out")
    assert "pretrained_pipe_path" not in cfg and "mesh_shape" not in cfg
    assert cfg["r2_endpoint"] == "http://127.0.0.1:1"
    assert cfg["model_config_overrides"] == {
        "text_dim": "2304", "num_double_blocks": "2",
        "num_single_blocks": "4"}
    assert cfg["steps"] == cfg["num_steps_per_validation"] == "3"
    for key in ("r2_access_key", "r2_secret_key", "r2_bucket_name",
                "r2_tar_files", "compute_features", "vae_max_batch_size",
                "text_encoder_max_batch_size", "batch_size", "learning_rate",
                "validation_prompts", "bfloat16", "lora_rank", "lora_alpha",
                "lora_algo", "lora_target_modules", "aspect_ratio"):
        want = shipped[key]
        assert cfg[key] == (want if isinstance(want, list) else str(want))
