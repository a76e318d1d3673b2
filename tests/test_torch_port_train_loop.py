"""PyTorch port, the rest of the training loop on the CPU, against the JAX
package on the same weights, batches and draws: full fine-tuning,
``unfreeze_modules`` (the mask, and the clip over the unfrozen leaves
only), the preservation term (LoRA: the base with its adapters off; full
fine-tuning: the initial snapshot) in SANA's flow form and PixArt-Sigma's
epsilon form, and exploration steps (the port given the draws of JAX's N
keys picks the same candidate).  PixArt-Sigma's cases are in
``tests/test_torch_port_pixart_train_loop.py``.  Each step runs the port's
``make_train_step`` beside ``yat_tpu/train/step.py``'s jitted step; the
draws are the ones the JAX step makes from its key."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yat_tpu_torch.convert import (flax_named_parameters, load_flax_adapters,
                                   load_flax_params)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 on the CPU, a few optimizer steps of summation-order noise
# (tests/test_torch_port_train.py): loss and grad_norm to 1e-5 relative,
# the leaves and EMA after the steps to 1e-4
METRIC_RTOL = 1e-5
LEAF_TOL = 1e-4
LR = 1e-2
TARGETS = ["to_q", "to_k", "to_v", "to_out"]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def _flax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    """A torch-layout parameter (or its EMA copy) in the flax layout of
    ``name``'s leaf."""
    t = t.detach()
    if name.endswith(".kernel") and t.ndim == 2:
        t = t.t()
    elif name.endswith(".kernel") and t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    return t.numpy()


@functools.lru_cache(maxsize=None)
def _family(name: str):
    """The JAX tiny model of ``name`` (SANA with a softmax self-attention
    block, or PixArt-Sigma with its learned-sigma head and nonzero
    modulation tables), its variables, rank-4 LoRA with a random
    ``lora_b`` and one batch of 2."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params

    rng = np.random.default_rng(0)
    if name == "sana":
        from yat_tpu.models.sana import SANA_TINY_TEST, SanaTransformer2D
        cfg = dataclasses.replace(SANA_TINY_TEST,
                                  softmax_self_attn_blocks=(1,))
        model = SanaTransformer2D(cfg=cfg, dtype=jnp.float32)
        cap = 8
    else:
        from yat_tpu.models.pixart import PIXART_TINY_TEST, \
            PixArtTransformer2D
        cfg = PIXART_TINY_TEST
        model = PixArtTransformer2D(cfg=cfg, dtype=jnp.float32)
        cap = cfg.max_caption_len
    b = 2
    mask = np.ones((b, cap), np.int32)
    mask[0, 5:] = 0
    batch = {
        "latents": rng.standard_normal(
            (b, cfg.sample_size, cfg.sample_size, cfg.in_channels),
            np.float32),
        "embeddings": rng.standard_normal((b, cap, cfg.caption_channels),
                                          np.float32),
        "text_mask": mask}
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


def _port_model(name, cfg_j, variables, adapters=None, meta=None):
    if name == "sana":
        from yat_tpu_torch.models.sana import SanaConfig as C
        from yat_tpu_torch.models.sana import SanaTransformer2D as M
    else:
        from yat_tpu_torch.models.pixart import PixArtConfig as C
        from yat_tpu_torch.models.pixart import PixArtTransformer2D as M
    model = M(C(**dataclasses.asdict(cfg_j)), dtype=torch.float32)
    load_flax_params(model, jax.tree.map(np.asarray, variables["params"]))
    if adapters is not None:
        load_flax_adapters(model, jax.tree.map(np.asarray, adapters),
                           jax.tree.map(np.asarray, meta))
    return model


def _raw(**over):
    raw = {"batch_size": "2", "learning_rate": str(LR), "steps": "2",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "warmup_steps": "1", "weight_decay": "0.01"}
    raw.update(over)
    return raw


def _schedules(name):
    if name == "sana":
        from yat_tpu.ops.schedulers import FlowMatchSchedule as J
        from yat_tpu_torch.ops.schedulers import FlowMatchSchedule as T
        return J(shift=3.0), T(shift=3.0)
    from yat_tpu.ops.schedulers import DDPMSchedule as J
    from yat_tpu_torch.ops.schedulers import DDPMSchedule as T
    return J(), T()


def _key_draws(name, jsched, key, shape, split):
    """The timesteps (sigmas) and noise JAX draws from ``key``: split in 3
    by the task losses (tasks.py:88,141), in 2 by the preservation term
    (tasks.py:242)."""
    k_t, k_n = jax.random.split(key, split)[:2]
    out = {}
    if name == "sana":
        ts, sig = jsched.training_draw(k_t, shape[0])
        out["sigmas"] = torch.from_numpy(np.array(sig))
    else:
        ts = jsched.training_draw(k_t, shape[0])
    out["timesteps"] = torch.from_numpy(np.array(ts))
    out["noise"] = torch.from_numpy(np.array(
        jax.random.normal(k_n, shape, jnp.float32)))
    return out


def _run(name, lora, steps=2, explore=0, pres=False, unfreeze=None):
    """``steps`` steps of the JAX step and the port's on JAX's draws;
    metrics compared at each step.  Returns (JAX state, port model, port
    names, port leaves, port EMA, the exploration indices both chose)."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.train.state import create_train_state, make_optimizer
    from yat_tpu.train.step import make_train_step as j_make_step
    from yat_tpu.train import tasks as jt
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.train import tasks as tt
    from yat_tpu_torch.train.state import Optimizer, unfreeze_mask
    from yat_tpu_torch.train.step import explore as t_explore
    from yat_tpu_torch.train.step import make_train_step

    cfg_j, jmodel, variables, adapters, meta, batch = _family(name)
    over = {"unfreeze_modules": unfreeze} if unfreeze else {}
    raw = _raw(**over)
    tx = make_optimizer(JParams.from_dict({**raw, "urls": []}))
    if lora:
        state = create_train_state(variables["params"], tx,
                                   adapters=adapters, adapters_meta=meta,
                                   use_ema=True)
    else:
        state = create_train_state(variables["params"], tx, use_ema=True,
                                   preserve_base=pres)
    jsched, tsched = _schedules(name)
    flow = name == "sana"
    if flow:
        jloss = jt.make_flow_matching_loss(jmodel, jsched)
    else:
        jloss = jt.make_epsilon_loss(jmodel, jsched, learned_sigma=True)
    jstep = j_make_step(
        task_loss=jloss, tx=tx, ema_decay=0.999, use_ema=True,
        exploration_steps=explore or None,
        preservation_ratio=0.5 if pres else 0.0,
        preservation_loss=(jt.make_preservation_loss(jmodel, jsched, flow)
                           if pres else None), donate=False)

    model = _port_model(name, cfg_j, variables,
                        *((adapters, meta) if lora else ()))
    if lora:
        named = adapter_parameters(model)
    else:
        for p in model.parameters():
            p.requires_grad_(True)
        named = flax_named_parameters(model)
    names = [n for n, _ in named]
    leaves = [p for _, p in named]
    opt = Optimizer(TrainingParameters.from_dict(raw), leaves,
                    unfreeze_mask(names, unfreeze) if unfreeze else None)
    ema = [p.detach().clone() for p in leaves]
    frozen = ({n: p.detach().clone() for n, p in model.named_parameters()}
              if pres and not lora else None)
    if flow:
        tloss = tt.make_flow_matching_loss(model, tsched)
    else:
        tloss = tt.make_epsilon_loss(model, tsched, learned_sigma=True)
    step = make_train_step(
        task_loss=tloss, optimizer=opt, ema=ema, ema_decay=0.999,
        exploration_steps=explore or None,
        preservation_ratio=0.5 if pres else 0.0,
        preservation_loss=(tt.make_preservation_loss(model, tsched, flow)
                           if pres else None), frozen_base=frozen)

    shape = batch["latents"].shape
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def key_draws(key):
        d = _key_draws(name, jsched, key, shape, 3)
        if pres:
            d["preservation"] = _key_draws(name, jsched, key, shape, 2)
        return d

    rng = jax.random.PRNGKey(42)
    picks = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        _, rng_noise = jax.random.split(sub)      # step.py:95
        if explore:
            keys = jax.random.split(rng_noise, explore)
            cands = [key_draws(k) for k in keys]
            jl = [float(jloss(state.variables(), jbatch, k,
                              deterministic=True)) for k in keys]
            _, tl, idx = t_explore(tloss, tbatch, torch.Generator(), explore,
                                   cands)
            np.testing.assert_allclose(tl.numpy(), jl, rtol=METRIC_RTOL)
            picks.append((int(idx), int(np.argmin(jl))))
            draws = {"candidates": cands}
        else:
            draws = key_draws(rng_noise)
        state, jm = jstep(state, jbatch, sub)
        tm = step(tbatch, torch.Generator().manual_seed(0), draws)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=METRIC_RTOL)
    return state, model, names, leaves, ema, picks


def _softmax_key_bias(name: str) -> bool:
    """The key bias of a softmax attention (SANA's linear attention has no
    key bias): it adds one constant to every logit of a row, so its
    gradient is 0 in exact arithmetic and rounding noise in both packages,
    which Adam's normalisation turns into steps of up to the learning
    rate."""
    return name.endswith("to_k.bias")


def _check_leaves(state, model, names, leaves, ema, lora, steps):
    want = dict(_flat(jax.device_get(state.trainable)))
    want_ema = dict(_flat(jax.device_get(state.ema)))
    assert set(want) == set(names)
    for name, p, e in zip(names, leaves, ema):
        tol = 2 * LR * steps if _softmax_key_bias(name) else LEAF_TOL
        got = p.detach().numpy() if lora else _flax_layout(name, p)
        got_e = e.numpy() if lora else _flax_layout(name, e)
        np.testing.assert_allclose(got, want[name], atol=tol, rtol=LEAF_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got_e, want_ema[name], atol=tol,
                                   rtol=LEAF_TOL, err_msg=name)


def test_full_finetune_with_exploration_matches_jax():
    """Two steps of SANA full fine-tuning (every parameter a leaf, AdamW
    with weight decay, warmup, the clip, EMA over every leaf) with
    exploration over 4 candidates (JAX's keys' draws): the same index as
    ``jnp.argmin`` and the same loss, grad_norm, leaves and EMA copies; on
    a tie the first candidate wins."""
    from yat_tpu_torch.train.step import explore

    state, model, names, leaves, ema, picks = _run("sana", lora=False,
                                                   explore=4)
    _check_leaves(state, model, names, leaves, ema, False, 2)
    assert len(names) == len(list(model.parameters()))
    assert all(got == want for got, want in picks)

    calls = []

    def flat_loss(batch, gen, deterministic=True, draws=None):
        calls.append(deterministic)
        return torch.tensor(float(draws["v"]))
    cands = [{"v": torch.tensor(v)} for v in (3.0, 1.0, 1.0, 2.0)]
    chosen, losses, idx = explore(flat_loss, {}, torch.Generator(), 4, cands)
    assert int(idx) == 1 and float(chosen["v"]) == 1.0
    assert calls == [True] * 4



def test_unfreeze_modules_with_preservation_matches_jax():
    """SANA full fine-tuning with ``unfreeze_modules: [blocks_1]`` and the
    preservation term on the initial snapshot: grad_norm over every leaf,
    the clip over the unfrozen ones, only blocks_1 moves (the rest bit
    for bit), and the snapshot never changes."""
    cfg_j, _, variables, *_ = _family("sana")
    state, model, names, leaves, ema, _ = _run(
        "sana", lora=False, pres=True, unfreeze=["blocks_1"])
    _check_leaves(state, model, names, leaves, ema, False, 2)
    init = dict(_flat(jax.device_get(variables["params"])))
    moved = [n for n, p in zip(names, leaves)
             if not np.array_equal(_flax_layout(n, p), init[n])]
    assert moved and all(n.split(".")[0] == "blocks_1" for n in moved)
    assert len(moved) == sum(n.startswith("blocks_1.") for n in names)



def test_lora_preservation_and_exploration_match_jax():
    """SANA LoRA with the preservation term in its flow form (the base: the
    model with its adapters gated off) and exploration over 3 candidates,
    each with its own preservation draws: the same choices and steps, and
    every adapter gate cleared afterwards."""
    from yat_tpu_torch.models.layers import AdapterDense

    state, model, names, leaves, ema, picks = _run(
        "sana", lora=True, pres=True, explore=3)
    _check_leaves(state, model, names, leaves, ema, True, 2)
    assert all(got == want for got, want in picks)
    assert all(m.lora_gate is None for m in model.modules()
               if isinstance(m, AdapterDense))



def test_unfreeze_mask_matches_jax_segments():
    """The mask of ``unfreeze_modules`` against ``make_optimizer``'s
    mask_fn: exact segments (blocks_1 is not blocks_10), or the whole
    dotted path."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.train.state import make_optimizer
    from yat_tpu_torch.train.state import unfreeze_mask

    tree = {f"blocks_{i}": {"attn1": {"to_q": {"kernel": jnp.ones((2, 2)),
                                               "bias": jnp.ones((2,))}}}
            for i in (1, 10, 11)}
    tree["scale_shift_table"] = jnp.ones((2, 2))
    names = [n for n, _ in _flat(tree)]
    for pats in (["blocks_1"], ["blocks_10", "scale_shift_table"],
                 ["blocks_11.attn1.to_q.bias"], ["to_q"], ["attn"]):
        tx = make_optimizer(JParams.from_dict(
            {**_raw(warmup_steps="0"), "urls": [],
             "unfreeze_modules": pats}))
        # the first masked() of the chain holds the mask as its
        # inner state's tree of MaskedNode / state
        upd, _ = tx.update(jax.tree.map(jnp.ones_like, tree),
                           tx.init(tree), tree)
        moved = {n: bool(np.any(v != 0)) for n, v in _flat(upd)}
        assert unfreeze_mask(names, pats) == [moved[n] for n in names], pats
    assert unfreeze_mask(names, ["blocks_1"]) == [True, True, False, False,
                                                  False, False, False]



@pytest.mark.parametrize("lion", [False, True])
def test_masked_optimizer_matches_optax(lion):
    """One update of the masked chain on random gradients against optax:
    the clip's norm over the unfrozen leaves only (the frozen leaf's large
    gradient would change it), AdamW (or Lion-8bit) state for the
    unfrozen leaves, an update of exactly 0 for the frozen one."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.train.state import make_optimizer
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.train.state import Optimizer, unfreeze_mask

    rng = np.random.default_rng(3)
    tree = {"a": {"kernel": rng.standard_normal((8, 4), np.float32)},
            "b": {"kernel": rng.standard_normal((4, 4), np.float32)}}
    grads = {"a": {"kernel": 0.5 * rng.standard_normal((8, 4), np.float32)},
             "b": {"kernel": 50 * rng.standard_normal((4, 4), np.float32)}}
    raw = _raw(unfreeze_modules=["a"], warmup_steps="0",
               **({"use_adamw_8bit": "true"} if lion else {}))
    tx = make_optimizer(JParams.from_dict({**raw, "urls": []}))
    jtree = jax.tree.map(jnp.asarray, tree)
    upd, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(jtree),
                       jtree)
    want = jax.tree.map(lambda p, u: np.asarray(p + u), jtree, upd)

    leaves = [torch.from_numpy(tree[k]["kernel"].copy()) for k in "ab"]
    opt = Optimizer(TrainingParameters.from_dict(raw), leaves,
                    unfreeze_mask(["a.kernel", "b.kernel"], ["a"]))
    opt.update([torch.from_numpy(grads[k]["kernel"]) for k in "ab"])
    np.testing.assert_allclose(leaves[0].numpy(), want["a"]["kernel"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(leaves[1].numpy(), tree["b"]["kernel"])
    assert len(opt.active) == 1
    assert (len(opt.mu), len(opt.lion.momentum) if lion else 0) == (
        (0, 1) if lion else (1, 0))
