"""PyTorch port, tensor and sequence parallelism, against the JAX package
on the same meshes of the conftest's virtual CPU devices.

* The SANA LoRA step (the tiny SANA at one block with
  ``rms_norm_across_heads``, LoRA on every layer the ``tp`` rule splits,
  global batch 4) over three steps on ``{tp: 2}`` (also on a 4-bit base,
  its packed payloads sliced at whole bytes), ``{sp: 2}``,
  ``{fsdp: 2, tp: 2}`` and ``{tp: 2, sp: 2}``: the JAX step on the mesh
  (``constrain_tokens`` active) against the port's step in 2 or 4 gloo
  processes (``tests/torch_mp_worker.py`` ``step_parity``), each on its
  data index's rows with the JAX draws for them: loss, ``grad_norm``,
  the adapters and the EMA at ``tests/test_torch_port_train.py``'s
  tolerances, equal on every process.
* SANA on ``{sp: 2}`` at a 3x8 grid (the shard boundary mid-row, so the
  depthwise conv's neighbour tokens cross it), at a 3x3 grid (9 tokens:
  left whole), and with the generic REPA term on ``blocks_0`` (its head
  trains on the block's tokens gathered whole, so its gradient is whole
  on each peer), one step each; PixArt's LoRA step on ``{sp: 2}`` (the
  softmax self-attention's gathered keys, K6's path on the CPU's plain
  version).
* Full fine-tuning of the tiny SDXL UNet, the MMDiT-X and Flux on
  ``{tp: 2}`` (``tests/test_train_step.py``'s sharded steps): the loss
  and every parameter's gradient against ``jax.value_and_grad`` of the
  JAX loss on the ``{tp: 2}`` mesh (``tp_grads``).
* The ``tp`` rule and ``fsdp``'s still-free dimension against
  ``param_sharding_rules`` on the real SANA, Flux and MMDiT trees.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_dist_parity import _flat
from tests.test_torch_port_multiprocess import (launch_in_background,
                                                results)
from tests.test_torch_port_train import LEAF_TOL, METRIC_RTOL
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

STEPS = 3
RAW = {"batch_size": "2", "learning_rate": "1e-2", "steps": "3",
       "num_steps_per_validation": "100", "validation_prompts": [],
       "warmup_steps": "2", "weight_decay": "0.01", "use_ema": "",
       "train_unconditional_prob": "0.5", "use_adamw_8bit": "false"}


def _size(mesh_shape):
    return int(np.prod(list(mesh_shape.values())))


def _draws(setup, family, steps):
    """The draws the JAX step makes from its keys (``step.py``,
    ``tasks.py``) over ``steps`` steps: the caption dropout, the
    timesteps (and sigmas) and the noise."""
    from yat_tpu.ops.schedulers import DDPMSchedule, FlowMatchSchedule
    batch = setup[-1]
    b = batch["latents"].shape[0]
    sched = DDPMSchedule() if family == "pixart" else FlowMatchSchedule(
        shift=3.0)
    rng = jax.random.PRNGKey(42)
    draws = {}
    for i in range(steps):
        rng, sub = jax.random.split(rng)
        rng_drop, rng_noise = jax.random.split(sub)
        draws[f"draw/{i}/uncond"] = np.asarray(
            jax.random.bernoulli(rng_drop, 0.5))
        k_t, k_n, _ = jax.random.split(rng_noise, 3)
        if family == "pixart":
            draws[f"draw/{i}/timesteps"] = np.asarray(
                sched.training_draw(k_t, b))
        else:
            ts, sig = sched.training_draw(k_t, b)
            draws[f"draw/{i}/timesteps"] = np.asarray(ts)
            draws[f"draw/{i}/sigmas"] = np.asarray(sig)
        draws[f"draw/{i}/noise"] = np.asarray(jax.random.normal(
            k_n, batch["latents"].shape, jnp.float32))
    return draws


def _jax_run(setup, mesh_shape, family, steps):
    """The JAX LoRA step over the global batch on ``mesh_shape`` (state
    and batch placed as the JAX trainer places them, the active mesh set
    so ``constrain_tokens`` shards the tokens over ``sp``) for ``steps``
    steps from the key of :func:`_draws`: its metrics, its state and the
    token constraints it traced (under :func:`_threaded_active_mesh`)."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.ops.schedulers import DDPMSchedule, FlowMatchSchedule
    import yat_tpu.parallel.mesh as JMesh
    from yat_tpu.parallel.mesh import (batch_sharding, create_mesh,
                                       shard_pytree)
    from yat_tpu.train.state import create_train_state, make_optimizer
    from yat_tpu.train.step import make_train_step
    from yat_tpu.train.tasks import (make_epsilon_loss,
                                     make_flow_matching_loss)

    cfg, model, variables, adapters, meta, batch = setup
    mesh = create_mesh(mesh_shape, jax.devices()[:_size(mesh_shape)])
    tx = make_optimizer(JParams.from_dict({**RAW, "urls": []}))
    params, scales = variables["params"], None
    if family.endswith("-4bit"):
        from yat_tpu.ops.quant import quantize_params
        params, scales = quantize_params(params, bits=4)
    state = shard_pytree(create_train_state(
        params, tx, adapters=adapters, adapters_meta=meta, use_ema=True,
        quant_scales=scales), mesh)
    if family == "pixart":
        task = make_epsilon_loss(model, DDPMSchedule(), learned_sigma=True)
    elif family == "sana-repa":
        from yat_tpu.ops.repa import RepaConfig
        *repa, weight = REPA
        task = make_flow_matching_loss(
            model, FlowMatchSchedule(shift=3.0), repa_lambda=weight,
            repa_cfg=RepaConfig(tuple(repa[0]), *repa[1:]))
    else:
        task = make_flow_matching_loss(model, FlowMatchSchedule(shift=3.0))
    step = make_train_step(task_loss=task, tx=tx, ema_decay=0.999,
                           use_ema=True, uncond_prob=0.5, donate=False)
    placed = {k: jax.device_put(v, batch_sharding(mesh))
              if k in ("latents", "embeddings", "text_mask")
              else jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(42)
    metrics = []
    JMesh.set_active_mesh(mesh)
    try:
        with mesh:
            for _ in range(steps):
                rng, sub = jax.random.split(rng)
                state, m = step(state, placed, sub)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
        constrained = getattr(_LOCAL, "constrained", None)
    finally:
        JMesh.set_active_mesh(None)
    want = {"leaf/" + k.replace("/", "."): v for k, v in
            _flat(jax.device_get(state.adapters))}
    want.update({"ema/" + k.replace("/", "."): v for k, v in
                 _flat(jax.device_get(state.ema))})
    return np.asarray(metrics), want, constrained


# LoRA on every layer the tp rule splits: attention, GLUMBConv's pair, the
# caption and timestep projections' pairs, the lone proj_out
SPLIT_TARGETS = ["to_q", "to_k", "to_v", "to_out", "conv_inverted",
                 "conv_point", "linear_1", "linear_2", "proj_out"]


@pytest.fixture(scope="module")
def sana_lora():
    """The JAX tiny SANA cut to one block, with ``rms_norm_across_heads``
    qk norms (summed over ``tp``), LoRA (random ``lora_b``) on
    ``SPLIT_TARGETS`` and a global batch of 4 rows."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.models.sana import SANA_TINY_TEST, SanaTransformer2D

    cfg = dataclasses.replace(SANA_TINY_TEST, num_layers=1,
                              qk_norm="rms_norm_across_heads")
    rng = np.random.default_rng(0)
    b, cap = 4, 12
    mask = np.ones((b, cap), np.int32)
    mask[0, 5:] = 0
    mask[3, 9:] = 0
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
        "empty_text_mask": (np.arange(cap)[None] < 3).astype(np.int32)}
    model = SanaTransformer2D(cfg=cfg, dtype=jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1),
                                    jnp.asarray(batch["latents"]),
                                    jnp.asarray(batch["embeddings"]),
                                    jnp.zeros((b,)), jnp.asarray(mask))
    adapters, meta = build_adapter_params(
        variables, AdapterSpec("lora", rank=4, alpha=8,
                               target_modules=SPLIT_TARGETS),
        jax.random.PRNGKey(3))
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(0.1 * rng.standard_normal(x.shape),
                                  jnp.float32)
                      if p[-1].key == "lora_b" else x), adapters)
    return cfg, model, variables, adapters, meta, batch


# the generic REPA term: target modules, target width, head width, weight
REPA = (["blocks_0"], 32, 64, 0.5)


@pytest.fixture(scope="module")
def sana_repa(sana_lora):
    """``sana_lora`` with a REPA head (``repa_head`` in the adapters, as
    the JAX trainer keeps it) and DINOv2-like targets of 16 tokens."""
    from yat_tpu_torch.ops.repa import RepaConfig, head_tree, init_repa_head
    cfg, model, variables, adapters, meta, batch = sana_lora
    head = init_repa_head(RepaConfig(tuple(REPA[0]), *REPA[1:3]),
                          cfg.hidden_dim, 11)
    target = np.random.default_rng(12).standard_normal(
        (batch["latents"].shape[0], 16, REPA[1])).astype(np.float32)
    return (cfg, model, variables,
            dict(adapters, repa_head=jax.tree_util.tree_map(
                jnp.asarray, head_tree(head))),
            meta, {**batch, "repa_features": target})


@pytest.fixture(scope="module")
def pixart_lora():
    from tests.test_torch_port_pixart_train import _setup
    return _setup(layers=1)


def _with_grid(setup, hw):
    """``setup`` with its batch's latents at the grid ``hw``."""
    *head, batch = setup
    rng = np.random.default_rng(11)
    lat = batch["latents"]
    return (*head, {**batch, "latents": rng.standard_normal(
        (lat.shape[0], *hw, lat.shape[-1])).astype(np.float32)})


# case: (mesh, family, grid or None, steps); "sana-4bit" quantizes the
# base to 4 bits first (the 64-wide layers packed; tp slices the
# row-parallel to_out's payload at whole bytes)
CASES = {
    "tp2": ({"tp": 2}, "sana", None, STEPS),
    "tp2-4bit": ({"tp": 2}, "sana-4bit", None, STEPS),
    "sp2": ({"sp": 2}, "sana", None, STEPS),
    "fsdp2-tp2": ({"fsdp": 2, "tp": 2}, "sana", None, STEPS),
    "tp2-sp2": ({"tp": 2, "sp": 2}, "sana", None, STEPS),
    "sp2-midrow": ({"sp": 2}, "sana", (3, 8), 1),
    "sp2-unsharded": ({"sp": 2}, "sana", (3, 3), 1),
    "sp2-repa": ({"sp": 2}, "sana-repa", None, 1),
    "pixart-sp2": ({"sp": 2}, "pixart", None, STEPS),
}


def _write_step_case(tmp, case, setup, mesh, family, steps):
    """The case file of the port's processes (the model, the adapters,
    the batch, the JAX draws); returns the draws."""
    cfg, _, variables, adapters, meta, batch = setup
    draws = _draws(setup, family, steps)
    rows = batch["latents"].shape[0] // (mesh.get("dp", 1)
                                         * mesh.get("fsdp", 1))
    spec = {"config": dataclasses.asdict(cfg), "mesh": mesh, "raw": RAW,
            "rows": rows, "steps": steps, "family": family.split("-")[0],
            "bits": 4 if family.endswith("-4bit") else None}
    adapters = dict(adapters)
    head = adapters.pop("repa_head", None)
    if head is not None:
        spec["repa"] = REPA
    np.savez(tmp / f"step_parity-{case}.npz", spec=json.dumps(spec),
             **{f"params/{k}": v for k, v in _flat(variables["params"])},
             **{f"adapters/{k}": v for k, v in _flat(adapters)},
             **{f"head/{k}": v for k, v in _flat(head or {})},
             **{f"meta/{k}": v for k, v in _flat(meta)},
             **{f"batch/{k}": v for k, v in batch.items()}, **draws)
    return draws


# --- full fine-tuning on {tp: 2}: the JAX loss and gradients -------------

def _tp_grad_setups():
    """(family, JAX config, JAX model, params, batch, the JAX loss, the
    draws from its key) of the tiny SDXL UNet, MMDiT-X and Flux."""
    from tests.test_torch_port_unet import numpy_params
    from yat_tpu.models import flux as JF
    from yat_tpu.models.mmdit import MMDIT_TINY_TEST, MMDiT
    from yat_tpu.models.unet import UNet2DCondition, UNetConfig
    from yat_tpu.ops.schedulers import DDPMSchedule, FlowMatchSchedule
    from yat_tpu.train.tasks import (make_epsilon_loss, make_flow_matching_loss,
                                     make_flux_loss)

    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(7)
    k_t, k_n, _ = jax.random.split(key, 3)
    out = []
    # SDXL-shaped: pooled text and time_ids (tests/test_train_step.py)
    cfg = UNetConfig(in_channels=4, out_channels=4,
                     block_out_channels=(32, 64), layers_per_block=1,
                     transformer_layers=(1, 1), cross_attention_dim=16,
                     num_heads=2, addition_embed_dim=16)
    b = 2
    batch = {"latents": rng.standard_normal((b, 16, 16, 4), np.float32),
             "embeddings": rng.standard_normal((b, 8, 16), np.float32),
             "text_mask": np.ones((b, 8), np.int32),
             "pooled_text": rng.standard_normal((b, 16), np.float32),
             "time_ids": np.tile(np.asarray([[16., 16., 0., 0., 16., 16.]],
                                            np.float32), (b, 1))}
    model = UNet2DCondition(cfg=cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(1), jnp.asarray(batch["latents"]),
        jnp.asarray(batch["embeddings"]), jnp.zeros((b,)),
        jnp.asarray(batch["text_mask"]),
        pooled_text=jnp.asarray(batch["pooled_text"]),
        time_ids=jnp.asarray(batch["time_ids"]))
    sched = DDPMSchedule()
    draws = {"timesteps": np.asarray(sched.training_draw(k_t, b)),
             "noise": np.asarray(jax.random.normal(
                 k_n, batch["latents"].shape, jnp.float32))}
    out.append(("sdxl", cfg, model, numpy_params(shapes["params"], 4), batch,
                make_epsilon_loss(model, sched,
                                  extra_keys=("pooled_text", "time_ids")),
                draws))
    # MMDiT-X: a dual-attention first block
    cfg = dataclasses.replace(MMDIT_TINY_TEST, dual_attention_layers=(0,))
    batch = {"latents": rng.standard_normal((b, 8, 8, 16), np.float32),
             "embeddings": rng.standard_normal((b, 8, 16), np.float32),
             "text_mask": np.ones((b, 8), np.int32),
             "pooled_text": rng.standard_normal((b, 16), np.float32)}
    model = MMDiT(cfg=cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(1), jnp.asarray(batch["latents"]),
        jnp.asarray(batch["embeddings"]), jnp.zeros((b,)), None,
        pooled_text=jnp.asarray(batch["pooled_text"]))
    sched = FlowMatchSchedule(shift=3.0)
    ts, sig = sched.training_draw(k_t, b)
    draws = {"timesteps": np.asarray(ts), "sigmas": np.asarray(sig),
             "noise": np.asarray(jax.random.normal(
                 k_n, batch["latents"].shape, jnp.float32))}
    out.append(("mmdit", cfg, model, numpy_params(shapes["params"], 4),
                batch, make_flow_matching_loss(model, sched,
                                               extra_keys=("pooled_text",)),
                draws))
    # Flux: packed 2x2 tokens, a double and a single block
    cfg = JF.FLUX_TINY_TEST
    batch = {"latents": rng.standard_normal((b, 8, 8, 4), np.float32),
             "embeddings": rng.standard_normal((b, 6, 16), np.float32),
             "text_mask": np.ones((b, 6), np.int32)}
    model = JF.FluxTransformer(cfg=cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16)),
        jnp.zeros((1, 6, 16)), jnp.full((1,), 0.5), JF.latent_ids(4, 4))
    ts, sig = sched.training_draw(
        k_t, b, mu=sched.mu_for_seq_len(16)
        if sched.use_dynamic_shifting else None)
    draws = {"timesteps": np.asarray(ts), "sigmas": np.asarray(sig),
             "noise": np.asarray(jax.random.normal(k_n, (b, 16, 16),
                                                   jnp.float32))}
    out.append(("flux", cfg, model, numpy_params(shapes["params"], 4), batch,
                make_flux_loss(model, sched), draws))
    return key, out


def _write_tp_grad_cases(tmp, setups):
    """Each family's case file (parameters, batch, the JAX loss's
    draws)."""
    for family, cfg, model, params, batch, loss, draws in setups:
        spec = {"family": family, "config": dataclasses.asdict(cfg),
                "mesh": {"tp": 2}}
        np.savez(tmp / f"tp_grads-{family}.npz", spec=json.dumps(spec),
                 **{f"params/{k}": v for k, v in _flat(params)},
                 **{f"batch/{k}": v for k, v in batch.items()},
                 **{f"draw/{k}": v for k, v in draws.items()})


def _jax_tp_grads(key, setup):
    """One family's JAX loss and gradients on a {tp: 2} mesh (the
    parameters placed by ``param_sharding_rules``; the MMDiT given the
    published position table, as the port's: ``_published_tables``)."""
    from yat_tpu.parallel.mesh import create_mesh, shard_pytree
    family, cfg, model, params, batch, loss, draws = setup
    mesh = create_mesh({"tp": 2}, jax.devices()[:2])
    placed = shard_pytree(params, mesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: loss({"params": p}, jb, key,
                           deterministic=False)))(placed)
    return float(jl), {k.replace("/", "."): np.asarray(v)
                       for k, v in _flat(jax.device_get(jg))}


@contextlib.contextmanager
def _published_tables():
    """The JAX MMDiT given the published position table, as the port's
    (``tests/test_torch_port_sd35.py``)."""
    import yat_tpu.models.mmdit as JM
    from yat_tpu_torch.models.mmdit import pos_embed_2d
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "pos_embed_2d", lambda h, w, d: jnp.asarray(
            pos_embed_2d(h, w, d).numpy()))
        yield


# the calling thread's active JAX mesh, and the token constraints it put
_LOCAL = threading.local()


@contextlib.contextmanager
def _threaded_active_mesh():
    """``yat_tpu.parallel.mesh``'s active mesh kept per thread, so the JAX
    references on different meshes trace on threads side by side: its
    ``constrain_tokens`` (imported by the models at each call) reads the
    calling thread's mesh, with the same logic."""
    import yat_tpu.parallel.mesh as JMesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    def set_active_mesh(mesh):
        _LOCAL.mesh, _LOCAL.constrained = mesh, 0

    def constrain_tokens(x, axis="sp"):
        mesh = getattr(_LOCAL, "mesh", None)
        if mesh is None or mesh.shape.get(axis, 1) <= 1:
            return x
        if x.ndim < 2 or x.shape[1] % mesh.shape[axis] != 0:
            return x
        _LOCAL.constrained += 1
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(P.UNCONSTRAINED, axis)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMesh, "set_active_mesh", set_active_mesh)
        mp.setattr(JMesh, "constrain_tokens", constrain_tokens)
        yield


@pytest.fixture(scope="module")
def runs(sana_lora, sana_repa, pixart_lora, tmp_path_factory):
    """The case files, the port's processes on them (one launch for each
    world size, on threads while the JAX references compile), then every
    case's JAX run: {case: (JAX draws, metrics, state; each process's
    results)} and {family: (JAX loss, gradients; each process's)}."""
    tmps = {w: tmp_path_factory.mktemp(f"tp_sp_{w}") for w in (2, 4)}
    setups = {}
    draws = {}
    for case, (mesh, family, grid, steps) in CASES.items():
        setup = {"sana": sana_lora, "sana-4bit": sana_lora,
                 "sana-repa": sana_repa, "pixart": pixart_lora}[family]
        if grid is not None:
            setup = _with_grid(setup, grid)
        setups[case] = setup
        draws[case] = _write_step_case(tmps[_size(mesh)], case, setup, mesh,
                                       family, steps)
    key, grad_setups = _tp_grad_setups()
    _write_tp_grad_cases(tmps[2], grad_setups)
    joins = [launch_in_background("step_parity,tp_grads", 2, tmps[2]),
             launch_in_background("step_parity", 4, tmps[4])]
    with _threaded_active_mesh(), _published_tables(), \
            concurrent.futures.ThreadPoolExecutor(6) as pool:
        grads = {setup[0]: pool.submit(_jax_tp_grads, key, setup)
                 for setup in grad_setups}
        futures = {case: pool.submit(_jax_run, setups[case], mesh, family,
                                     steps)
                   for case, (mesh, family, _, steps) in CASES.items()}
        jax_side = {case: f.result() for case, f in futures.items()}
        grads = {family: f.result() for family, f in grads.items()}
    for join in joins:
        join()
    steps = {case: (draws[case], *jax_side[case],
                    results(tmps[_size(m)], case, _size(m),
                            scenario="step_parity"))
             for case, (m, *_) in CASES.items()}
    grads = {f: (*grads[f], results(tmps[2], f, 2, scenario="tp_grads"))
             for f in grads}
    return steps, grads


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_mesh_step(runs, case):
    """The JAX step on the mesh against the port's processes on their data
    indices' rows: the global loss and grad_norm on every process, the
    adapters and the EMA, equal on every process and to the JAX state's
    (warmup, weight decay, the clip, caption dropout at p = 0.5, EMA)."""
    draws, metrics, want, constrained, res = runs[0][case]
    # the JAX step sharded the tokens wherever N divides by sp (patch
    # embedding, one constraint a trace)
    mesh, _, grid, _ = CASES[case]
    assert bool(constrained) == ("sp" in mesh and grid != (3, 3))
    for r in res:
        np.testing.assert_allclose(r["metrics"], metrics, rtol=METRIC_RTOL)
        assert set(r) - {"metrics", "packed"} == set(want)
        # a 4-bit base: the tiny SANA's 64-wide layers packed
        assert ("packed" in r) == CASES[case][1].endswith("-4bit")
        assert r.get("packed", 1) > 0
        for k, v in want.items():
            np.testing.assert_allclose(r[k], v, atol=LEAF_TOL, rtol=LEAF_TOL,
                                       err_msg=k)
    for r in res[1:]:
        for k in res[0]:
            np.testing.assert_array_equal(res[0][k], r[k], err_msg=k)
    if CASES[case][3] == STEPS:
        # the caption dropout took both branches over the steps
        assert {bool(draws[f"draw/{i}/uncond"])
                for i in range(STEPS)} == {True, False}


@pytest.mark.parametrize("family", ["sdxl", "mmdit", "flux"])
def test_full_finetune_gradients_on_tp2_match_jax(runs, family):
    """One full fine-tuning loss of the tiny SDXL UNet, MMDiT-X or Flux on
    ``{tp: 2}``: the loss and every parameter's gradient (column- and
    row-parallel layers, their biases, the replicated rest) against the
    JAX ``value_and_grad`` on a ``{tp: 2}`` mesh, the same on both
    processes."""
    jloss, jgrads, res = runs[1][family]
    for r in res:
        np.testing.assert_allclose(float(r["loss"][0]), jloss,
                                   rtol=METRIC_RTOL)
        got = {k[len("grad/"):]: v for k, v in r.items()
               if k.startswith("grad/")}
        assert set(got) == set(jgrads)
        for k, v in jgrads.items():
            scale = max(float(np.abs(v).max()), 1e-3)
            np.testing.assert_allclose(got[k], v, atol=LEAF_TOL * scale,
                                       rtol=LEAF_TOL, err_msg=k)
    for k in res[0]:
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)


def _port_tree(family):
    from yat_tpu_torch.convert import flax_params
    with torch.device("meta"):
        if family == "sana":
            from yat_tpu_torch.models.sana import SANA_600M, SanaTransformer2D
            return flax_params(SanaTransformer2D(SANA_600M))
        if family == "flux":
            from yat_tpu_torch.models.flux import FLUX2_KLEIN, FluxTransformer
            return flax_params(FluxTransformer(
                dataclasses.replace(FLUX2_KLEIN, text_dim=2304)))
        from yat_tpu_torch.models.mmdit import MMDiT, SD35_MEDIUM
        return flax_params(MMDiT(SD35_MEDIUM))


@pytest.mark.parametrize("family", ["sana", "flux", "mmdit"])
def test_tp_rule_matches_param_sharding_rules(family):
    """``mesh.tp_dim`` and ``mesh.shard_dim`` (``fsdp`` on the largest
    dimension ``tp`` left free) over the real parameter tree against the
    JAX ``param_sharding_rules`` on a ``{fsdp: 2, tp: 2}`` mesh: the same
    spec on every leaf, but Flux's ``lin`` kernels under a modulation
    (replicated here, the JAX rule's ``fsdp`` there); the rule splits
    attention, MLP and projection kernels of each family."""
    from jax.sharding import PartitionSpec as P

    from yat_tpu.parallel.mesh import create_mesh, param_sharding_rules
    from yat_tpu_torch.parallel.mesh import shard_dim, tp_dim

    tree = _port_tree(family)
    mesh = create_mesh({"fsdp": 2, "tp": 2}, jax.devices()[:4])
    split, differ = set(), set()
    for path, t in tree.items():
        names, shape = path.split("."), tuple(t.shape)
        ours = [None] * len(shape)
        d = tp_dim(names, shape, 2)
        if d is not None:
            ours[d] = "tp"
            split.add(names[-2])
        f = shard_dim(names, shape, 2, 2)
        if f is not None:
            ours[f] = "fsdp"
        theirs = param_sharding_rules(
            tuple(names), jax.ShapeDtypeStruct(shape, jnp.float32), mesh)
        theirs = list(theirs) + [None] * (len(shape) - len(theirs))
        if ours != theirs:
            differ.add(path)
            assert ".lin." in path and path.endswith("kernel"), (
                path, ours, theirs)
            assert theirs.count("fsdp") == 1 and "fsdp" not in ours
    assert not differ or family == "flux"
    want = {"sana": {"to_q", "to_out", "conv_inverted", "conv_point",
                     "linear_1", "linear_2", "proj_out"},
            "flux": {"img_to_q", "txt_to_out", "img_to_out", "proj_out"},
            "mmdit": {"x_to_q", "c_to_out", "x_to_out", "pool_linear_1",
                      "proj_out"}}[family]
    assert want <= split, want - split
