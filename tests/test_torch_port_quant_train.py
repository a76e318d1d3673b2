"""PyTorch port, the int8-base LoRA training slice on the CPU: one training
step of the quantized-base trainer (``lora_base_model_8bit``,
``int8_w8a8``, ``use_adamw_8bit``) through the port's ``make_trainer``
against the JAX package's step on the same fp32 weights, adapters, batch
and draws, with K5/K5b run interpreted on the JAX side and as their plain
versions on the port's; the same for PixArt-Sigma's trainer on the
dequantized branch; and ``chip_smoke.py``'s int8 phases rehearsed on the
CPU.

An int8 rounding of an activation (or of g * w_scale) can land on the other
side in the two packages, whose fp32 values differ by a few ulps.  Each such
flip is counted the way the chip's gradient reference counts them
(``chip_smoke.W8A8Payloads``): one step, at a near-tie, and the port then
takes the JAX package's step there.  Everything else agrees to
``GRAD_REF_TOL`` of each leaf's largest gradient entry (1e-4, fp32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from yat_tpu_torch.convert import load_flax_adapters
from yat_tpu_torch.ops import quant as TQ
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

TARGETS = ["to_q", "to_k", "to_v", "to_out"]
# loss and grad_norm of one step: fp32 sums in another order
METRIC_RTOL = 1e-5
# the updated leaves: p - lr * (sign(g) + wd * p) in fp32
LEAF_TOL = 1e-6
# SANA at widths that pass the w8a8 gate (128; GLUMB's 320-wide
# down-projection falls back as SANA-0.6B's 2880 does), batch 2 of 8x8
# latents (T = 128) and a 64-token caption (T = 128)
TINY_W8A8 = {"hidden_dim": 128, "num_layers": 2, "num_attention_heads": 4,
             "attention_head_dim": 32, "num_cross_attention_heads": 2,
             "cross_attention_head_dim": 64, "caption_channels": 128,
             "max_caption_len": 64, "in_channels": 4, "out_channels": 4,
             "sample_size": 8, "mlp_ratio": 2.5}


def _raw(**over):
    raw = {"batch_size": "2", "learning_rate": "1e-3", "steps": "1",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "warmup_steps": "0", "weight_decay": "0.01",
           "train_unconditional_prob": "0", "lora_rank": "4",
           "lora_alpha": "8", "lora_algo": "lora",
           "lora_target_modules": TARGETS, "lora_base_model_8bit": "true",
           "use_adamw_8bit": "true", "dataset_seed": "0"}
    raw.update(over)
    return raw


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


class JaxPayloads:
    """The inputs of every interpreted K5/K5b call of the JAX package's
    step, read back through ``jax.debug.callback``; their int8 payloads
    (computed with the port's ``row_quantize``, equal to the JAX
    package's rounding) keyed as ``chip_smoke.W8A8Payloads`` keys them."""

    def __init__(self, monkeypatch, jq):
        self.calls = []
        fwd, bwd = jq._pallas_w8a8_fwd2d, jq._pallas_w8a8_bwd2d

        def keep(kind):
            def cb(a, q, ws):
                self.calls.append((kind, np.asarray(a, np.float32),
                                   np.asarray(q), np.asarray(ws)))
            return cb

        def rec_fwd(x2, q, ws, out_dtype):
            jax.debug.callback(keep("fwd"), x2.astype(jnp.float32), q, ws)
            return fwd(x2, q, ws, out_dtype)

        def rec_bwd(g2, q, ws, out_dtype):
            jax.debug.callback(keep("bwd"), g2.astype(jnp.float32), q, ws)
            return bwd(g2, q, ws, out_dtype)
        monkeypatch.setattr(jq, "_pallas_w8a8_fwd2d", rec_fwd)
        monkeypatch.setattr(jq, "_pallas_w8a8_bwd2d", rec_bwd)

    def reference(self, model):
        """The payloads recorded since the last call, by (module path,
        "fwd"/"bwd", 0), the path found from the int8 weight."""
        by_weight = {m.qweight.t().contiguous().numpy().tobytes(): path
                     for path, m in model.named_modules()
                     if getattr(m, "qweight", None) is not None}
        out = {}
        for kind, a, q, ws in self.calls:
            a32 = torch.from_numpy(a.copy())
            if kind == "bwd":
                a32 = a32 * torch.from_numpy(ws)[None, :]
            key = (by_weight[q.tobytes()], kind, 0)
            assert key not in out, key
            out[key] = TQ.row_quantize(a32)[0]
        self.calls = []
        return out


def _sana_setup():
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.models.sana import SanaConfig, SanaTransformer2D

    cfg = SanaConfig(**TINY_W8A8)
    rng = np.random.default_rng(0)
    b, cap = 2, cfg.max_caption_len
    mask = np.ones((b, cap), np.int32)
    mask[0, 40:] = 0
    batch = {"latents": rng.standard_normal((b, 8, 8, cfg.in_channels),
                                            np.float32),
             "embeddings": rng.standard_normal((b, cap, cfg.caption_channels),
                                               np.float32),
             "text_mask": mask}
    model = SanaTransformer2D(cfg=cfg, dtype=jnp.float32)
    # one compiled init (eager flax compiles op by op)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1),
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
    return model, variables, adapters, meta, batch


def _one_step_both(monkeypatch, tmp_path, frontend, jmodel, variables,
                   adapters, meta, batch, raw, j_task_loss, draws_of,
                   w8a8, bits=8):
    """One quantized-base training step on both packages: the JAX state
    quantized as ``Trainer.initialize`` does, the port's trainer from its
    ``make_trainer`` on the same fp32 tree.  Returns, for both, the loss
    and the LoRA gradients of one batch (their own program on the JAX side)
    and the step's metrics and updated leaves, plus the flips counted."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.models import layers as JL
    from yat_tpu.ops import quant as JQ
    from yat_tpu.train.state import create_train_state, make_optimizer
    from yat_tpu.train.step import make_train_step as j_make_step
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.train.step import loss_and_grads

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(JQ, "_FORCE_PALLAS_INTERPRET", True)
    monkeypatch.setattr(JL, "_INT8_W8A8", w8a8)
    rec = JaxPayloads(monkeypatch, JQ)
    raw = {**raw, "output_dir": str(tmp_path / "out")}
    jparams = JParams.from_dict({**raw, "urls": []})
    assert jparams.use_adamw_8bit and jparams.int8_w8a8 == w8a8
    qparams, scales = JQ.quantize_params(variables["params"], bits=bits)
    tx = make_optimizer(jparams)
    state = create_train_state(qparams, tx, adapters=adapters,
                               adapters_meta=meta, quant_scales=scales)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    sub = jax.random.PRNGKey(42)
    _, rng_noise = jax.random.split(sub)

    def jloss(tr):
        return j_task_loss(state.variables(tr), jbatch, rng_noise,
                           deterministic=False)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(state.trainable)
    jax.effects_barrier()

    params = TrainingParameters.from_dict(raw)
    trainer = frontend.make_trainer(
        params, sampler=[], device="cpu",
        weights={"transformer": jax.tree.map(np.asarray,
                                             variables["params"])})
    load_flax_adapters(trainer.model, jax.tree.map(np.asarray, adapters),
                       jax.tree.map(np.asarray, meta))
    trainer.initialize()
    model = trainer.model
    grad_ref = rec.reference(model)
    assert bool(grad_ref) == w8a8
    tap = chip_smoke.W8A8Payloads([model])
    leaves = adapter_parameters(model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = draws_of(rng_noise, batch["latents"])
    with tap.forcing(grad_ref):
        tl, tg = loss_and_grads(trainer.task_loss, [p for _, p in leaves],
                                tbatch, torch.Generator(), draws)
    grad_flips = tap.flips

    jstep = j_make_step(task_loss=j_task_loss, tx=tx, donate=False)
    state, jm = jstep(state, jbatch, sub)
    jax.effects_barrier()
    with tap.forcing(rec.reference(model)):
        tm = trainer._step_fn(tbatch, torch.Generator(), draws)
    assert not tap.bad, tap.bad
    jgrads = dict(_flat(jax.device_get(jg)))
    jleaves = dict(_flat(jax.device_get(state.adapters)))
    return {"loss": (float(tl), float(jl)),
            "grads": [(n, g.numpy(), jgrads[n])
                      for (n, _), g in zip(leaves, tg)],
            "metrics": {k: (float(tm[k]), float(jm[k]))
                        for k in ("loss", "grad_norm")},
            "leaves": [(n, p.detach().numpy(), jleaves[n])
                       for n, p in leaves],
            "flips": (grad_flips, tap.flips), "trainer": trainer}


def _check(out, lr, wd):
    tol = chip_smoke.GRAD_REF_TOL
    got, want = out["loss"]
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    scale = {}
    for name, g, gj in out["grads"]:
        scale[name] = float(np.abs(gj).max())
        assert scale[name] > 0, name
        err = float(np.abs(g - gj).max())
        assert err <= tol * scale[name], (name, err / scale[name])
    for key, (got, want) in out["metrics"].items():
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, err_msg=key)
    grads = {name: gj for name, _, gj in out["grads"]}
    for name, p, pj in out["leaves"]:
        # Lion moves each entry by lr (1 + wd p) either way: an entry
        # whose gradient is within the tolerance of 0 may take the other
        # sign on the two sides; every other entry agrees
        off = np.abs(p - pj) > LEAF_TOL
        tiny = np.abs(grads[name]) <= tol * scale[name]
        assert not (off & ~tiny).any(), name
        assert (np.abs(p - pj)[off] <= 2 * lr * (1 + wd * np.abs(pj[off]))
                + LEAF_TOL).all(), name


def test_sana_int8_w8a8_step_matches_jax(monkeypatch, tmp_path):
    """The quantized-base trainer's step (int8 base from the fp32 weights,
    K5/K5b, chain LoRA, Lion with 8-bit momentum) against the JAX
    package's on the tiny w8a8 SANA: loss, every LoRA gradient, the step's
    loss and grad_norm, and the updated leaves."""
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JSchedule
    from yat_tpu.train.tasks import make_flow_matching_loss as j_loss
    from yat_tpu_torch.frontends import sana
    from yat_tpu_torch.models.layers import AdapterDense

    jmodel, variables, adapters, meta, batch = _sana_setup()
    jsched = JSchedule(shift=3.0)

    def draws_of(rng_noise, latents):
        # the draws of the JAX flow-matching loss from its key
        k_t, k_n, _ = jax.random.split(rng_noise, 3)
        ts, sig = jsched.training_draw(k_t, latents.shape[0])
        noise = jax.random.normal(k_n, latents.shape, jnp.float32)
        return {"timesteps": torch.from_numpy(np.array(ts)),
                "sigmas": torch.from_numpy(np.array(sig)),
                "noise": torch.from_numpy(np.array(noise))}
    overrides = {k: str(v) for k, v in TINY_W8A8.items()}
    raw = _raw(int8_w8a8="true", model_config_overrides=overrides)
    out = _one_step_both(monkeypatch, tmp_path, sana, jmodel, variables,
                         adapters, meta, batch, raw,
                         j_loss(jmodel, jsched), draws_of, w8a8=True)
    _check(out, lr=1e-3, wd=0.01)
    model = out["trainer"].model
    dense = [m for m in model.modules() if isinstance(m, AdapterDense)]
    assert all(m.w8a8 for m in dense)
    assert sum(m.qweight is not None for m in dense) == 25
    # the frontend built the base in fp32 (quantized from it); the layers
    # that stay floating are fp32 without bfloat16
    assert model.blocks[0].scale_shift_table.dtype == torch.float32
    print("int8 roundings flipped (gradient program, step program):",
          out["flips"])


@pytest.mark.parametrize("bits", [8, 4])
def test_pixart_int8_base_lion_step_matches_jax(monkeypatch, tmp_path, bits):
    """PixArt-Sigma's trainer with ``lora_base_model_8bit`` (or ``_4bit``)
    and Lion-8bit (no w8a8: the weight dequantized to the compute dtype,
    merged LoRA) against the JAX package's step on the tiny PixArt at width
    64 (its dense kernels reach the 4096-element quantization
    threshold)."""
    from tests.test_torch_port_pixart_train import _jax_draws, _setup
    from yat_tpu.ops.schedulers import DDPMSchedule as JSchedule
    from yat_tpu.train.tasks import make_epsilon_loss as j_loss
    from yat_tpu_torch.frontends import pixart
    from yat_tpu_torch.models.layers import AdapterDense

    cfg, jmodel, variables, adapters, meta, batch = _setup(hidden=64)
    batch = {k: batch[k] for k in ("latents", "embeddings", "text_mask")}
    jsched = JSchedule()
    overrides = {k: str(v) for k, v in dataclasses.asdict(cfg).items()
                 if k in ("hidden_dim", "num_layers", "num_attention_heads",
                          "attention_head_dim", "caption_channels",
                          "max_caption_len", "sample_size", "mlp_ratio")}
    raw = _raw(batch_size="4", model_config_overrides=overrides)
    if bits == 4:
        raw.pop("lora_base_model_8bit")
        raw["lora_base_model_4bit"] = "true"
    out = _one_step_both(monkeypatch, tmp_path, pixart, jmodel, variables,
                         adapters, meta, batch, raw,
                         j_loss(jmodel, jsched, learned_sigma=True),
                         lambda rng, lat: _jax_draws(jsched, rng, lat),
                         w8a8=False, bits=bits)
    _check(out, lr=1e-3, wd=0.01)
    assert out["flips"] == (0, 0)
    dense = [m for m in out["trainer"].model.modules()
             if isinstance(m, AdapterDense)]
    quantized = [m for m in dense if m.qweight is not None]
    assert quantized and {m.bits for m in quantized} == {bits}
    assert max(int(m.payload_values().abs().max())
               for m in quantized) == 2 ** (bits - 1) - 1
    assert not any(m.w8a8 for m in dense)


# PixArt-Sigma at widths that pass the w8a8 gate: width 128 (2 heads of
# 64, MLP ratio 1), 128 caption channels, batch 2 of 16x16 latents (64
# image tokens: T = 128); the caption length is the rung
TINY_PIXART_W8A8 = {"hidden_dim": 128, "num_layers": 2,
                    "num_attention_heads": 2, "attention_head_dim": 64,
                    "caption_channels": 128, "sample_size": 16,
                    "mlp_ratio": 1.0}


def _pixart_w8a8_setup(cap):
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.models.pixart import PIXART_TINY_TEST, PixArtTransformer2D

    cfg = dataclasses.replace(PIXART_TINY_TEST, max_caption_len=cap,
                              **TINY_PIXART_W8A8)
    rng = np.random.default_rng(0)
    b, n = 2, cfg.sample_size
    mask = np.ones((b, cap), np.int32)
    mask[0, cap // 2:] = 0
    batch = {"latents": rng.standard_normal((b, n, n, cfg.in_channels),
                                            np.float32),
             "embeddings": rng.standard_normal((b, cap, cfg.caption_channels),
                                               np.float32),
             "text_mask": mask}
    model = PixArtTransformer2D(cfg=cfg, dtype=jnp.float32)
    # one compiled init (eager flax compiles op by op)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1),
                                    jnp.asarray(batch["latents"]),
                                    jnp.asarray(batch["embeddings"]),
                                    jnp.zeros((b,)), jnp.asarray(mask))
    # nonzero modulation tables, so every LoRA leaf gets a gradient
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


@pytest.mark.parametrize("cap", [64, 40])
def test_pixart_int8_w8a8_step_matches_jax(monkeypatch, tmp_path, cap):
    """PixArt-Sigma's quantized-base trainer with ``int8_w8a8`` (K5/K5b,
    chain LoRA, Lion-8bit) against the JAX package's step on a tiny PixArt
    whose widths pass the w8a8 gate, at two caption rungs: at 64 tokens
    the caption-side products (T = 128) take K5 like the image side; at 40
    (T = 80) they fall back to the dequantized weight.  Flips are counted
    and taken from the JAX side as for SANA."""
    from tests.test_torch_port_pixart_train import _jax_draws
    from yat_tpu.ops.schedulers import DDPMSchedule as JSchedule
    from yat_tpu.train.tasks import make_epsilon_loss as j_loss
    from yat_tpu_torch.frontends import pixart
    from yat_tpu_torch.models.layers import AdapterDense

    cfg, jmodel, variables, adapters, meta, batch = _pixart_w8a8_setup(cap)
    jsched = JSchedule()
    overrides = {k: str(v) for k, v in dataclasses.asdict(cfg).items()
                 if k in ("hidden_dim", "num_layers", "num_attention_heads",
                          "attention_head_dim", "caption_channels",
                          "max_caption_len", "sample_size", "mlp_ratio")}
    raw = _raw(int8_w8a8="true", model_config_overrides=overrides)
    branches = []
    gate = TQ.w8a8_branch

    def spy(t, k, n):
        branches.append(((t, k, n), gate(t, k, n)))
        return branches[-1][1]
    monkeypatch.setattr(TQ, "w8a8_branch", spy)
    out = _one_step_both(monkeypatch, tmp_path, pixart, jmodel, variables,
                         adapters, meta, batch, raw,
                         j_loss(jmodel, jsched, learned_sigma=True),
                         lambda rng, lat: _jax_draws(jsched, rng, lat),
                         w8a8=True)
    _check(out, lr=1e-3, wd=0.01)
    dense = [m for m in out["trainer"].model.modules()
             if isinstance(m, AdapterDense)]
    assert all(m.w8a8 for m in dense)
    kernel = {shape for shape, ok in branches if ok}
    fallback = {shape for shape, ok in branches if not ok}
    # the image side (T = 128) takes K5 on both rungs; the caption side
    # only where 2 x cap is a multiple of 128
    assert (128, 128, 128) in kernel
    assert ((2 * cap, 128, 128) in kernel) == (cap == 64)
    assert ((2 * cap, 128, 128) in fallback) == (cap == 40)
    print(f"rung {cap}: int8 roundings flipped (gradient program, step "
          f"program):", out["flips"])


def test_payload_flips_are_counted_and_forced():
    """``chip_smoke.W8A8Payloads``: an entry rounded one step the other way
    at a near-tie is a flip (counted; the run takes the reference's step);
    two steps, or one step far from the midpoint, is an error."""
    from yat_tpu_torch.models.layers import AdapterDense

    m = AdapterDense(256, 128, use_bias=False)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.quantize(8)
    m.w8a8 = True
    x = torch.randn((128, 256), generator=torch.Generator().manual_seed(1))
    x8, xs = TQ.row_quantize(x)
    v = x / xs[:, None]
    near = (v.abs() - v.abs().floor() - 0.5).abs()
    i = int(near.argmin())            # the entry nearest a midpoint
    j = int(near.argmax())            # one far from it
    for shift, at, ok in ((1, i, True), (2, i, False), (1, j, False)):
        ref = x8.clone().reshape(-1)
        ref[at] = ref[at] + (shift if ref[at] < 0 else -shift)
        tap = chip_smoke.W8A8Payloads([m])
        with tap.forcing({("", "fwd", 0): ref.reshape(x8.shape)}):
            y = m(x)
        assert tap.flips == 1 and (not tap.bad) == ok
        if ok:
            want = TQ.w8a8_matmul_ref(x, m.qweight, m.weight_scale)
            assert not torch.equal(y, want)
    # a run against itself: no flips
    tap = chip_smoke.W8A8Payloads([m])
    with tap.recording():
        y = m(x)
    with tap.forcing(dict(tap.seen)):
        assert torch.equal(m(x), y)
    assert tap.flips == 0 and not tap.bad


def test_chip_smoke_int8_grad_reference_phase_on_cpu():
    """chip_smoke.py's int8 gradient reference with both runs on the CPU,
    at widths that pass the gate: the same gradients, no flips."""
    width = {k: TINY_W8A8[k] for k in (
        "hidden_dim", "num_attention_heads", "attention_head_dim",
        "num_cross_attention_heads", "cross_attention_head_dim",
        "caption_channels")}
    assert chip_smoke.phase_int8_grad_reference(torch.device("cpu"),
                                                width=width) == 0


def test_chip_smoke_int8_train_phase_on_cpu():
    """chip_smoke.py's int8 train phase (phase 9) rehearsed at the tiny
    w8a8 size on the CPU in fp32: the entry point with the three 8-bit
    keys, the loss/adapter/export checks, the launch bookkeeping (no
    launches on the CPU), the int8 base's bytes and the remat step."""
    counts = chip_smoke.phase_train(
        torch.device("cpu"), "cpu",
        shard_args={"n": 24, "latent": (8, 8, 4), "dim": 128,
                    "lengths": (40, 64)},
        cfg_extra={**chip_smoke.INT8_KEYS, "batch_size": "2",
                   "bfloat16": None,
                   "model_config_overrides": {
                       k: str(v) for k, v in TINY_W8A8.items()}},
        label="int8 train")
    assert counts["w8a8_matmul"] == 0 and counts["w8a8_matmul_bwd"] == 0
    assert len(counts) == 7
