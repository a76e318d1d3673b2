"""PyTorch port across processes against the JAX package on the CPU.

* The JAX SANA LoRA step on a ``{dp: 2}`` and on a ``{dp: 1, fsdp: 2}``
  mesh of the conftest's virtual CPU devices, at a global batch of 4,
  against the port's step in 2 gloo processes (``tests/torch_mp_worker.py``
  ``step_parity``), each on its half of the rows with the JAX step's draws
  for them: the loss, ``grad_norm``, the adapters and the EMA after three
  steps, at ``tests/test_torch_port_train.py``'s tolerances; AdamW, and
  Lion with 8-bit momentum under ``fsdp``.
* The ``fsdp`` sharding rule on a real Flux parameter tree: every
  modulation leaf replicated, and the rule differs from the JAX
  ``param_sharding_rules`` exactly at Flux's ``lin`` under a modulation.
* ``w8a8_branch`` under a world of 2 takes the dequantized matmul.
"""

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_multiprocess import (launch_in_background,
                                                results)
from tests.test_torch_port_train import LEAF_TOL, METRIC_RTOL, TARGETS
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

STEPS = 3


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def sana_lora():
    """The JAX tiny SANA with LoRA (random ``lora_b``) and a global batch
    of 4 rows, built once."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.models.sana import SANA_TINY_TEST, SanaTransformer2D

    cfg = SANA_TINY_TEST
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
                               target_modules=TARGETS),
        jax.random.PRNGKey(3))
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(0.1 * rng.standard_normal(x.shape),
                                  jnp.float32)
                      if p[-1].key == "lora_b" else x), adapters)
    return cfg, model, variables, adapters, meta, batch


def _jax_draws(batch):
    """The draws the JAX step makes from its keys over ``STEPS`` steps
    (step.py:95-96, tasks.py:88-91): the caption dropout, the timesteps
    and sigmas, the noise."""
    from yat_tpu.ops.schedulers import FlowMatchSchedule
    sched = FlowMatchSchedule(shift=3.0)
    b = batch["latents"].shape[0]
    rng = jax.random.PRNGKey(42)
    draws = {}
    for i in range(STEPS):
        rng, sub = jax.random.split(rng)
        rng_drop, rng_noise = jax.random.split(sub)
        draws[f"draw/{i}/uncond"] = np.asarray(
            jax.random.bernoulli(rng_drop, 0.5))
        k_t, k_n, _ = jax.random.split(rng_noise, 3)
        ts, sig = sched.training_draw(k_t, b)
        draws[f"draw/{i}/timesteps"] = np.asarray(ts)
        draws[f"draw/{i}/sigmas"] = np.asarray(sig)
        draws[f"draw/{i}/noise"] = np.asarray(jax.random.normal(
            k_n, batch["latents"].shape, jnp.float32))
    return draws


def _jax_run(setup, mesh_shape, raw):
    """The JAX step over the global batch on ``mesh_shape`` (the state and
    the batch placed as the JAX trainer places them) for ``STEPS`` steps
    from the keys of :func:`_jax_draws`: its metrics and state."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.ops.schedulers import FlowMatchSchedule
    from yat_tpu.parallel.mesh import batch_sharding, create_mesh, shard_pytree
    from yat_tpu.train.state import create_train_state, make_optimizer
    from yat_tpu.train.step import make_train_step
    from yat_tpu.train.tasks import make_flow_matching_loss

    cfg, model, variables, adapters, meta, batch = setup
    mesh = create_mesh(mesh_shape, jax.devices()[:2])
    tx = make_optimizer(JParams.from_dict({**raw, "urls": []}))
    state = shard_pytree(create_train_state(
        variables["params"], tx, adapters=adapters, adapters_meta=meta,
        use_ema=True), mesh)
    sched = FlowMatchSchedule(shift=3.0)
    step = make_train_step(task_loss=make_flow_matching_loss(model, sched),
                           tx=tx, ema_decay=0.999, use_ema=True,
                           uncond_prob=0.5, donate=False)
    placed = {k: jax.device_put(v, batch_sharding(mesh))
              if k in ("latents", "embeddings", "text_mask")
              else jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(42)
    metrics = []
    with mesh:
        for _ in range(STEPS):
            rng, sub = jax.random.split(rng)
            state, m = step(state, placed, sub)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    want = {"leaf/" + k.replace("/", "."): v for k, v in
            _flat(jax.device_get(state.adapters))}
    want.update({"ema/" + k.replace("/", "."): v for k, v in
                 _flat(jax.device_get(state.ema))})
    return np.asarray(metrics), want


CASES = {"dp2-adamw": ({"dp": 2}, "adamw"),
         "fsdp2-adamw": ({"dp": 1, "fsdp": 2}, "adamw"),
         "fsdp2-lion8bit": ({"dp": 1, "fsdp": 2}, "lion8bit")}


@pytest.fixture(scope="module")
def parity_runs(sana_lora, tmp_path_factory):
    """Every case's file, the port's 2 processes over all cases in one
    launch (on a thread), and meanwhile every case's JAX run (on threads
    of their own): {case: (JAX draws, metrics, state; each process's
    results)}."""
    cfg, _, variables, adapters, meta, batch = sana_lora
    tmp = tmp_path_factory.mktemp("parity")
    draws = _jax_draws(batch)
    raws = {}
    for case, (mesh_shape, optim) in CASES.items():
        raws[case] = {"batch_size": "2", "learning_rate": "1e-2",
                      "steps": "3", "num_steps_per_validation": "100",
                      "validation_prompts": [], "warmup_steps": "2",
                      "weight_decay": "0.01", "use_ema": "",
                      "train_unconditional_prob": "0.5",
                      "use_adamw_8bit": str(optim == "lion8bit").lower()}
        port_mesh = {k: v for k, v in mesh_shape.items() if v > 1}
        spec = {"config": dataclasses.asdict(cfg), "mesh": port_mesh,
                "raw": raws[case], "rows": 2, "steps": STEPS}
        np.savez(tmp / f"step_parity-{case}.npz", spec=json.dumps(spec),
                 **{f"params/{k}": v for k, v in
                    _flat(variables["params"])},
                 **{f"adapters/{k}": v for k, v in _flat(adapters)},
                 **{f"meta/{k}": v for k, v in _flat(meta)},
                 **{f"batch/{k}": v for k, v in batch.items()}, **draws)
    join = launch_in_background("step_parity", 2, tmp, timeout=240)
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        runs = {case: pool.submit(_jax_run, sana_lora, mesh_shape,
                                  raws[case])
                for case, (mesh_shape, _) in CASES.items()}
        jax_side = {case: (draws, *f.result()) for case, f in runs.items()}
    join()
    return {case: (*jax_side[case],
                   results(tmp, case, 2, scenario="step_parity"))
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_two_process_step_matches_jax_mesh_step(parity_runs, case):
    """Three steps (warmup, weight decay, the clip, caption dropout at
    p = 0.5 on both branches, EMA) of the JAX step on the mesh against the
    port's 2-process step on the halves: the global loss and grad_norm on
    both processes, the adapters and the EMA, equal on both processes and
    to the JAX state's."""
    draws, metrics, want, res = parity_runs[case]
    uncond = {bool(draws[f"draw/{i}/uncond"]) for i in range(STEPS)}
    for r in res:
        np.testing.assert_allclose(r["metrics"], metrics, rtol=METRIC_RTOL)
        assert set(r) - {"metrics"} == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r[k], v, atol=LEAF_TOL, rtol=LEAF_TOL,
                                       err_msg=k)
    for k in res[0]:
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
    # the caption dropout took both branches over the 3 steps
    assert uncond == {True, False}


def test_fsdp_rule_on_the_flux_tree_replicates_every_modulation():
    """``mesh.shard_dim`` over ``convert.flax_params`` of the Flux-2 Klein
    transformer (meta device) at ``fsdp`` 2 against the JAX
    ``param_sharding_rules`` on a ``{fsdp: 2}`` mesh: every leaf of a
    modulation layer is replicated, and the two rules differ exactly at
    the ``lin`` kernels under ``img_mod``, ``txt_mod`` and ``mod``, which
    the JAX rule shards."""
    from jax.sharding import PartitionSpec as P

    from yat_tpu.parallel.mesh import create_mesh, param_sharding_rules
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.models.flux import FLUX2_KLEIN, FluxTransformer
    from yat_tpu_torch.parallel.mesh import is_modulation, shard_dim

    with torch.device("meta"):
        tree = flax_params(FluxTransformer(
            dataclasses.replace(FLUX2_KLEIN, text_dim=2304)))
    mesh = create_mesh({"fsdp": 2}, jax.devices()[:2])
    differ, modulation = set(), set()
    for path, t in tree.items():
        names = path.split(".")
        ours = shard_dim(names, tuple(t.shape), 2)
        spec = param_sharding_rules(
            tuple(names), jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
            mesh)
        theirs = next((i for i, ax in enumerate(spec) if ax == "fsdp"), None)
        if spec == P():
            theirs = None
        if is_modulation(names):
            modulation.add(path)
            assert ours is None, path
        if ours != theirs:
            differ.add(path)
    # the kernel and bias of each img_mod/txt_mod/mod.lin
    lins = {p for p in tree if ".lin." in p and "mod.lin." in p}
    n_double, n_single = FLUX2_KLEIN.num_double_blocks, \
        FLUX2_KLEIN.num_single_blocks
    assert len(lins) == 2 * (2 * n_double + n_single)
    assert differ == {p for p in lins if p.endswith("kernel")}
    assert lins <= modulation and "final_mod.kernel" in modulation
    assert any(shard_dim(p.split("."), tuple(t.shape), 2) is not None
               for p, t in tree.items())


def test_w8a8_branch_under_a_world_of_two(monkeypatch):
    """The int8 gate's process test: a shape the kernels take at one
    process takes the dequantized matmul at two (as the JAX gate sends
    every multi-device step there), launching nothing and equal to the
    dequantized product."""
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.ops import quant
    from yat_tpu_torch.parallel import multihost

    assert quant.w8a8_branch(256, 1152, 1152)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    assert not quant.w8a8_branch(256, 1152, 1152)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 128, 256, generator=gen)
    w = torch.randn(384, 256, generator=gen)
    q, s = quant.quantize_kernel(w, 8)
    reset_launch_counts()
    got = quant.w8a8_matmul(x, q, s)
    assert launch_counts()["w8a8_matmul"] == 0
    want = x @ quant.dequantize_kernel(q, s, torch.float32).t()
    torch.testing.assert_close(got, want.to(got.dtype), atol=1e-5,
                               rtol=1e-5)
