"""One process of the PyTorch port's multi-process scenarios on the CPU.

    python tests/torch_mp_worker.py SCENARIO[,SCENARIO...] RANK WORLD TMPDIR

Every process joins one gloo process group through a ``FileStore`` in
``TMPDIR`` (no TCP port, so concurrent runs cannot collide), with a
timeout on the group, and runs the scenarios in turn on one torch thread,
each in ``TMPDIR/SCENARIO/``, where it writes ``SCENARIO-RANK.npz``, then
prints ``SCENARIO OK``.
It imports no JAX: the tests compare what the processes wrote.  The
scenarios mirror ``tests/mp_worker.py`` of the JAX package at the tiny
SANA size.
"""

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from yat_tpu_torch.parallel.multihost import (  # noqa: E402
    WindowedBucketSync, barrier, initialize_distributed, process_count)

TARGETS = ["to_q", "to_k", "to_v", "to_out"]
TINY = {"hidden_dim": "32", "num_layers": "1", "num_attention_heads": "1",
        "attention_head_dim": "32", "num_cross_attention_heads": "1",
        "cross_attention_head_dim": "32", "caption_channels": "16",
        "max_caption_len": "8", "in_channels": "4", "sample_size": "8",
        "mlp_ratio": "1.0"}


def write_shard(path, seed, n, ratios=("1.0", "0.5"), cap_lens=(5, 8),
                dim=16, lat=(8, 8), lat_c=4):
    """A feature shard of ``n`` samples: aspect keys cycling through
    ``ratios``, caption lengths through ``cap_lens``."""
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(seed)
    with TarShardWriter(str(path)) as w:
        for i in range(n):
            ratio = ratios[int(rng.integers(len(ratios)))]
            hw = lat if ratio != "0.5" else (lat[0], 2 * lat[1])
            length = cap_lens[int(rng.integers(len(cap_lens)))]
            w.write({"__key__": f"{i:06d}", "ratio": ratio,
                     "latent.npy": rng.standard_normal(
                         (*hw, lat_c), dtype=np.float32),
                     "emb.npy": rng.standard_normal((length, dim),
                                                    dtype=np.float32)})
    return str(path)


def tiny_params(tmp, **over):
    from yat_tpu_torch.config import TrainingParameters
    raw = {"batch_size": "2", "learning_rate": "1e-2", "steps": "3",
           "warmup_steps": "1", "num_steps_per_validation": "100",
           "validation_prompts": [], "use_ema": "", "lora_rank": "4",
           "lora_alpha": "4", "lora_algo": "lora",
           "lora_target_modules": TARGETS, "bfloat16": "false",
           "output_dir": os.path.join(tmp, "out"),
           "model_config_overrides": dict(TINY)}
    raw.update(over)
    return TrainingParameters.from_dict(raw)


def leaves_of(trainer):
    """The trainable leaves, the EMA and the optimizer's tensors, by
    name."""
    out = {}
    for name, p in zip(trainer.trainable_names(), trainer.trainable_leaves()):
        out[f"leaf/{name}"] = p.detach().numpy().copy()
    for name, e in zip(trainer.trainable_names(), trainer.ema or []):
        out[f"ema/{name}"] = e.numpy().copy()
    opt = trainer.optimizer.state_dict()
    for key in ("mu", "nu", "lion_payload", "lion_scale"):
        for i, t in enumerate(opt.get(key) or []):
            out[f"opt/{key}/{i}"] = t.numpy().copy()
    return out


# ---------------------------------------------------------------------------

def run_lockstep(rank, tmp):
    """Processes with different streams (aspect keys and caption lengths
    over the rungs 128/256/300, plus a key outside the bin table) emit the
    same bucket sequence."""
    from yat_tpu_torch.frontends.common import build_feature_sampler
    world = process_count()
    paths = [os.path.join(tmp, f"s{r}.tar") for r in range(world)]
    write_shard(paths[rank], seed=100 + rank, n=30 + 7 * rank,
                ratios=("1.0", "0.5", "9.9") if rank == 0 else ("1.0", "0.5"),
                cap_lens=(100, 200, 290) if rank % 2 else (100, 290, 290),
                dim=8, lat=(2, 2))
    barrier()
    params = tiny_params(tmp, local_shard_paths=paths, batch_size="3",
                         caption_length_bucketing="true")
    sampler = build_feature_sampler(params, max_caption_len=300)
    hook = sampler.sync_hook
    assert hook is not None and len(hook.keys) == 33 * 3, len(hook.keys)
    assert "1.0|256" in hook.keys
    hook.window = 8
    seq, first_mins = [], None
    for batch in sampler:
        if first_mins is None:
            first_mins = dict(hook.min_counts)
        seq.append([batch.ratio, batch.embeddings.shape[1],
                    batch.latents.shape[0], *batch.latents.shape[1:3]])
        if len(seq) == 12:
            break
    np.savez(os.path.join(tmp, f"lockstep-{rank}.npz"),
             seq=json.dumps(seq), ingested=hook._ingested,
             warned=json.dumps(sorted(sampler._warned_keys)),
             paths=json.dumps(sampler.source.paths))


def run_timeout(rank, tmp):
    """Unequal finite streams: the longer process's all-gather times out
    with the diagnostics, then the object refuses every later call."""
    hook = WindowedBucketSync(["a", "b"], window=2, allgather_timeout=3.0)
    hook({"a": 1})
    zeros = dict(hook.min_counts)
    hook({"a": 2, "b": 1})                  # all-gather 1: both processes
    mins = dict(hook.min_counts)
    flag = os.path.join(tmp, "timeout-done")
    said = []
    if rank == 0:
        hook({"a": 3, "b": 1})
        t0 = time.monotonic()
        for _ in range(2):
            try:
                # all-gather 2 (alone), then the next window's
                for _ in range(2):
                    hook({"a": 4, "b": 1})
            except RuntimeError as e:
                said.append(str(e))
        waited = time.monotonic() - t0
        open(flag, "w").close()
    else:
        waited = 0.0
        deadline = time.monotonic() + 60
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.1)
    np.savez(os.path.join(tmp, f"timeout-{rank}.npz"),
             zeros=json.dumps(zeros), mins=json.dumps(mins),
             said=json.dumps(said), waited=waited)


def _fsdp_trainer(tmp, **over):
    from yat_tpu_torch.frontends import sana
    shard = os.path.join(tmp, "s.tar")
    if process_count() == 1 or torch.distributed.get_rank() == 0:
        write_shard(shard, seed=0, n=12)
    barrier()
    params = tiny_params(tmp, local_shard_paths=[shard],
                         mesh_shape={"fsdp": process_count()}, **over)
    trainer = sana.make_trainer(params, device="cpu")
    trainer.initialize()
    return trainer


def run_checkpoint(rank, tmp):
    """{fsdp: 2}: process 0 writes the whole state; a restore puts back
    every process's shard and the replicated leaves."""
    trainer = _fsdp_trainer(tmp, checkpoint_dir=os.path.join(tmp, "ckpt"))
    assert trainer.sharded is not None
    from yat_tpu_torch.parallel.mesh import frozen_bytes
    resident = frozen_bytes(trainer.model)
    with trainer.whole():
        whole = frozen_bytes(trainer.model)
        full_model = {k: v.clone() for k, v in
                      trainer.model.state_dict().items()}
    shards = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    before = leaves_of(trainer)
    trainer.global_step = 5
    trainer.save_checkpoint()
    from yat_tpu_torch.train.checkpoint import _PENDING, wait_for_checkpoints
    pending = len(_PENDING)
    wait_for_checkpoints()
    barrier()
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
        for e in trainer.ema:
            e.add_(1.0)
    trainer.global_step = 0
    trainer.optimizer.count = 7
    trainer.restore_checkpoint()
    after = leaves_of(trainer)
    restored = trainer.model.state_dict()
    equal_shards = all(torch.equal(restored[k], v) for k, v in shards.items())
    saved = torch.load(os.path.join(tmp, "ckpt", "5.pt"), weights_only=True)
    saved_whole = all(torch.equal(saved["model"][k], v)
                      for k, v in full_model.items())
    np.savez(os.path.join(tmp, f"checkpoint-{rank}.npz"),
             resident=resident, whole=whole, pending=pending,
             step=trainer.global_step, count=trainer.optimizer.count,
             equal_shards=equal_shards, saved_whole=saved_whole,
             files=json.dumps(sorted(os.listdir(os.path.join(tmp, "ckpt")))),
             **{f"before/{k}": v for k, v in before.items()},
             **{f"after/{k}": v for k, v in after.items()})


def run_save_validate(rank, tmp):
    """Collective validation (every process runs the model under fsdp) and
    one export by process 0; a validation failure propagates instead of
    being counted."""
    from yat_tpu_torch.data.sampler import Batch
    trainer = _fsdp_trainer(tmp)
    rng = np.random.default_rng(7)
    batch = trainer._device_batch(Batch(
        ratio="1.0",
        latents=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        embeddings=rng.standard_normal((2, 8, 16), dtype=np.float32),
        text_mask=np.ones((2, 8), np.int32)))
    losses = []

    def validate(tr):
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            losses.append(float(tr.task_loss(batch, gen)))
        return {"validation/0": np.zeros((4, 4, 3), np.uint8)}

    trainer.validate_fn = validate
    trainer.global_step = 2
    trainer._validate_and_save()
    barrier()
    path = os.path.join(tmp, "out", "2", "adapter_model.safetensors")
    from yat_tpu_torch.adapters.builder import adapter_tree
    from yat_tpu_torch.adapters.io import read_safetensors
    from yat_tpu_torch.adapters.io import save_adapter_safetensors
    mine = os.path.join(tmp, f"mine-{rank}.safetensors")
    adapters, meta = adapter_tree(trainer.model)
    save_adapter_safetensors(mine, adapters, meta)
    same = all(np.array_equal(a, b) for a, b in zip(
        read_safetensors(path)[0].values(),
        read_safetensors(mine)[0].values()))

    def broken(tr):
        raise ValueError("validation broke")

    trainer.validate_fn = broken
    trainer.global_step = 4
    said = ""
    try:
        trainer._validate_and_save()
    except ValueError as e:
        said = str(e)
    np.savez(os.path.join(tmp, f"save_validate-{rank}.npz"),
             losses=np.asarray(losses), same=same, said=said,
             failures=trainer._validation_failures,
             exports=json.dumps(sorted(os.listdir(os.path.join(tmp, "out")))))


def run_rehearsal(rank, tmp):
    """Trainer.run() through the SANA entry point at {dp: 2, fsdp: 2}:
    4 steps with a checkpoint at 2 and 4, then a resume to step 6."""
    import yaml

    from yat_tpu_torch.frontends.sana import main
    world = process_count()
    paths = [os.path.join(tmp, f"s{r}.tar") for r in range(world)]
    write_shard(paths[rank], seed=10 + rank, n=16 + 3 * rank)
    barrier()
    cfg = {"local_shard_paths": paths, "batch_size": "2",
           "learning_rate": "1e-2", "steps": "4", "warmup_steps": "1",
           "num_steps_per_validation": "2", "validation_prompts": [],
           "use_ema": "", "lora_rank": "4", "lora_alpha": "4",
           "lora_algo": "lora", "lora_target_modules": TARGETS,
           "bfloat16": "false", "train_unconditional_prob": "0.0",
           "caption_length_bucketing": "true",
           "checkpoint_dir": os.path.join(tmp, "ckpt"),
           "output_dir": os.path.join(tmp, "out"),
           "mesh_shape": {"dp": 2, "fsdp": 2},
           "model_config_overrides": dict(TINY)}
    out = {}
    for steps, resume in (("4", False), ("6", True)):
        path = os.path.join(tmp, f"cfg-{rank}-{steps}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({**cfg, "steps": steps,
                            "resume": "true" if resume else "false"}, f)
        barrier()
        trainer = main(["--config", path, "--device", "cpu"])
        state = leaves_of(trainer)
        out.update({f"{steps}/{k}": v for k, v in state.items()})
        out[f"{steps}/loss"] = np.asarray([h["loss"] for h in trainer.history])
        out[f"{steps}/step"] = trainer.global_step
        out[f"{steps}/count"] = trainer.optimizer.count
        out[f"{steps}/sharded"] = trainer.sharded is not None
        barrier()
    out["ckpts"] = json.dumps(sorted(os.listdir(os.path.join(tmp, "ckpt"))))
    out["exports"] = json.dumps(sorted(os.listdir(os.path.join(tmp, "out"))))
    np.savez(os.path.join(tmp, f"rehearsal-{rank}.npz"), **out)


def _cases(tmp, prefix):
    """The case files ``PREFIX-CASE.npz`` that the test wrote beside the
    scenario's directory."""
    root = os.path.dirname(tmp)
    return [os.path.join(root, p) for p in sorted(os.listdir(root))
            if p.startswith(prefix + "-") and p.endswith(".npz")]


def run_step_parity(rank, tmp):
    """The port's step on this process's rows of the global batch (those
    of its data index: ``tp`` and ``sp`` peers take the same), with the
    draws the JAX step made for these rows, for each case the test wrote
    beside the scenario's directory (``step_parity-CASE.npz``: SANA or
    PixArt LoRA at {dp: 2} or {fsdp: 2} with AdamW or Lion with 8-bit
    momentum, or on a mesh with ``tp`` and ``sp``; a ``bits`` key
    quantizes the base first, and the result counts its packed 4-bit
    layers)."""
    for case in _cases(tmp, "step_parity"):
        _step_parity_case(rank, tmp, case)


def _tree(data, prefix):
    out = {}
    for key in data.files:
        if key.startswith(prefix):
            node = out
            *path, leaf = key[len(prefix):].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return out


def _config(cls, raw):
    """``cls`` from the JSON of a JAX config (lists back to tuples)."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items()})


def _parallel(model, spec, head=None):
    """The mesh of ``spec`` over ``model``: its tp split, its sp group,
    the frozen base's fsdp shards; (mesh, the leaves' GradSync maker).
    ``head`` (a REPA head) runs on tokens gathered whole, as the engine's
    does."""
    from yat_tpu_torch.parallel.mesh import create_mesh
    from yat_tpu_torch.parallel.tensor import parallelize
    mesh = create_mesh(spec["mesh"], "cpu")

    def grad_sync(leaves):
        tensor, _, sharded, sync = parallelize(
            model, mesh, leaves, (getattr(model, "repa_projector", None),
                                  head))
        assert (sharded is not None) == ("fsdp" in spec["mesh"])
        assert (tensor is not None) == ("tp" in spec["mesh"])
        return sync
    return mesh, grad_sync


def _step_parity_case(rank, tmp, case):
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.convert import load_flax_adapters, load_flax_params
    from yat_tpu_torch.adapters.builder import adapter_parameters
    from yat_tpu_torch.train.state import Optimizer
    from yat_tpu_torch.train.step import make_train_step

    data = np.load(case)
    spec = json.loads(str(data["spec"]))
    head = None
    if spec.get("family", "sana") == "pixart":
        from yat_tpu_torch.models.pixart import (PixArtConfig,
                                                 PixArtTransformer2D)
        from yat_tpu_torch.ops.schedulers import DDPMSchedule
        from yat_tpu_torch.train.tasks import make_epsilon_loss
        model = PixArtTransformer2D(_config(PixArtConfig, spec["config"]),
                                    dtype=torch.float32)
        task = make_epsilon_loss(model, DDPMSchedule(), learned_sigma=True)
    else:
        from yat_tpu_torch.models.sana import SanaConfig, SanaTransformer2D
        from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
        from yat_tpu_torch.train.tasks import make_flow_matching_loss
        model = SanaTransformer2D(_config(SanaConfig, spec["config"]),
                                  dtype=torch.float32)
        repa = None
        if "repa" in spec:
            # the generic REPA term, its head training beside the adapters
            from yat_tpu_torch.ops.repa import RepaConfig, init_repa_head
            targets, target, hidden, weight = spec["repa"]
            repa = RepaConfig(tuple(targets), target, hidden)
            head = init_repa_head(repa, model.cfg.hidden_dim, 0)
            load_flax_params(head, _tree(data, "head/"))
        task = make_flow_matching_loss(
            model, FlowMatchSchedule(shift=3.0),
            repa_lambda=spec["repa"][3] if repa else 0.0, repa_cfg=repa,
            repa_head=head)
    load_flax_params(model, _tree(data, "params/"))
    load_flax_adapters(model, _tree(data, "adapters/"), _tree(data, "meta/"))
    packed = 0
    if spec.get("bits"):
        # the quantized base, as Trainer.initialize makes it before the
        # split
        from yat_tpu_torch.models.layers import AdapterDense
        from yat_tpu_torch.ops.quant import quantize_params
        quantize_params(model, spec["bits"])
        packed = sum(isinstance(m, AdapterDense) and m.qweight is not None
                     and m.qweight.dtype == torch.uint8
                     for m in model.modules())
    mesh, grad_sync = _parallel(model, spec, head)
    params = TrainingParameters.from_dict(spec["raw"])
    leaves = adapter_parameters(model)
    if head is not None:
        from yat_tpu_torch.convert import flax_named_parameters
        leaves = leaves + [(f"repa_head.{n}", p)
                           for n, p in flax_named_parameters(head)]
    opt = Optimizer(params, [p for _, p in leaves])
    ema = [p.detach().clone() for _, p in leaves]
    step = make_train_step(
        task_loss=task, optimizer=opt, ema=ema, ema_decay=0.999,
        uncond_prob=0.5, grad_sync=grad_sync([p for _, p in leaves]))
    at = mesh.data_rank * spec["rows"]
    rows = slice(at, at + spec["rows"])
    batch = {k[len("batch/"):]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("batch/")}
    for k in ("latents", "embeddings", "text_mask", "repa_features"):
        if k in batch:
            batch[k] = batch[k][rows]
    metrics = []
    for i in range(spec["steps"]):
        draws = {"uncond": bool(data[f"draw/{i}/uncond"])}
        for k in ("timesteps", "sigmas", "noise"):
            if f"draw/{i}/{k}" in data.files:
                draws[k] = torch.from_numpy(data[f"draw/{i}/{k}"][rows])
        m = step(batch, torch.Generator().manual_seed(0), draws)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    out = {"metrics": np.asarray(metrics)}
    if spec.get("bits"):
        out["packed"] = np.asarray(packed)
    for (name, p), e in zip(leaves, ema):
        # the head's kernels in the flax layout, as the adapters are
        flip = name.startswith("repa_head.") and name.endswith("kernel")
        out[f"leaf/{name}"] = (p.detach().t() if flip else p.detach()).numpy()
        out[f"ema/{name}"] = (e.t() if flip else e).numpy()
    name = os.path.basename(case)[len("step_parity-"):-len(".npz")]
    np.savez(os.path.join(tmp, f"{name}-{rank}.npz"), **out)


def run_tp_grads(rank, tmp):
    """Full fine-tuning of the tiny SDXL UNet, MMDiT-X or Flux on a
    ``tp`` mesh: the loss and every parameter's gradient, reduced over the
    processes, on the JAX loss's draws (``tp_grads-CASE.npz``)."""
    import dataclasses  # noqa: F401 (configs)

    from yat_tpu_torch.convert import flax_named_parameters, load_flax_params
    from yat_tpu_torch.train.step import loss_and_grads
    for case in _cases(tmp, "tp_grads"):
        data = np.load(case)
        spec = json.loads(str(data["spec"]))
        family = spec["family"]
        if family == "sdxl":
            from yat_tpu_torch.models.unet import UNet2DCondition, UNetConfig
            from yat_tpu_torch.ops.schedulers import DDPMSchedule
            from yat_tpu_torch.train.tasks import make_epsilon_loss
            model = UNet2DCondition(_config(UNetConfig, spec["config"]),
                                    dtype=torch.float32)
            make = lambda m: make_epsilon_loss(  # noqa: E731
                m, DDPMSchedule(), extra_keys=("pooled_text", "time_ids"))
        elif family == "mmdit":
            from yat_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
            from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
            from yat_tpu_torch.train.tasks import make_flow_matching_loss
            model = MMDiT(_config(MMDiTConfig, spec["config"]),
                          dtype=torch.float32)
            make = lambda m: make_flow_matching_loss(  # noqa: E731
                m, FlowMatchSchedule(shift=3.0), extra_keys=("pooled_text",))
        else:
            from yat_tpu_torch.models.flux import FluxConfig, FluxTransformer
            from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
            from yat_tpu_torch.train.tasks import make_flux_loss
            model = FluxTransformer(_config(FluxConfig, spec["config"]),
                                    dtype=torch.float32)
            make = lambda m: make_flux_loss(  # noqa: E731
                m, FlowMatchSchedule(shift=3.0))
        load_flax_params(model, _tree(data, "params/"))
        for p in model.parameters():
            p.requires_grad_(True)
        named = flax_named_parameters(model)
        _, grad_sync = _parallel(model, spec)
        sync = grad_sync([p for _, p in named])
        batch = {k[len("batch/"):]: torch.from_numpy(data[k])
                 for k in data.files if k.startswith("batch/")}
        draws = {k[len("draw/"):]: torch.from_numpy(data[k])
                 for k in data.files if k.startswith("draw/")}
        loss, grads = loss_and_grads(make(model), [p for _, p in named],
                                     batch, torch.Generator(), draws)
        loss = loss.float().reshape(1)
        sync.reduce_grads_(grads, loss)
        name = os.path.basename(case)[len("tp_grads-"):-len(".npz")]
        # each gradient in its parameter's flax layout
        flax = {n: (g.t() if n.endswith("kernel") and g.ndim == 2 else
                    g.permute(2, 3, 1, 0) if n.endswith("kernel") else g)
                for (n, _), g in zip(named, grads)}
        np.savez(os.path.join(tmp, f"{name}-{rank}.npz"), loss=loss.numpy(),
                 **{f"grad/{n}": g.numpy() for n, g in flax.items()})


def run_context_parallel(rank, tmp):
    """``context_parallel_attention`` and ``ring_attention`` over the
    processes on the test's q/k/v (``context_parallel.npz``): this
    process's key and value shard, the queries whole or its shard; the
    outputs and the gradients of ``sum(out ** 2)``."""
    from yat_tpu_torch.ops.context_parallel import (
        context_parallel_attention, ring_attention)
    data = np.load(os.path.join(os.path.dirname(tmp),
                                "context_parallel.npz"))
    world = process_count()
    q, k, v = (torch.from_numpy(data[n]) for n in ("q", "k", "v"))
    kv = slice(rank * (k.shape[1] // world),
               (rank + 1) * (k.shape[1] // world))
    qs = slice(rank * (q.shape[1] // world),
               (rank + 1) * (q.shape[1] // world))
    out = {}
    for name, fn, rows in (("cp", context_parallel_attention, slice(None)),
                           ("ring", ring_attention, slice(None)),
                           ("ring_sharded", ring_attention, qs)):
        qq = q[:, rows].clone().requires_grad_()
        kk, vv = (t[:, kv].clone().requires_grad_() for t in (k, v))
        o = fn(qq, kk, vv, None)
        dq, dk, dv = torch.autograd.grad((o ** 2).sum(), (qq, kk, vv))
        out.update({f"{name}/out": o.detach().numpy(),
                    f"{name}/dq": dq.numpy(), f"{name}/dk": dk.numpy(),
                    f"{name}/dv": dv.numpy()})
    np.savez(os.path.join(tmp, f"context_parallel-{rank}.npz"), **out)


SCENARIOS = {"lockstep": run_lockstep, "timeout": run_timeout,
             "checkpoint": run_checkpoint, "save_validate": run_save_validate,
             "rehearsal": run_rehearsal, "step_parity": run_step_parity,
             "tp_grads": run_tp_grads,
             "context_parallel": run_context_parallel}


def main():
    scenarios, rank, world, tmp = (sys.argv[1].split(","), int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(os.path.join(tmp, "store"), world)
    initialize_distributed(num_processes=world, process_id=rank,
                           device_type="cpu", store=store, timeout_s=120)
    for scenario in scenarios:
        sub = os.path.join(tmp, scenario)
        os.makedirs(sub, exist_ok=True)
        os.chdir(sub)
        SCENARIOS[scenario](rank, sub)
        print(f"{scenario} OK", flush=True)
    # leave without tearing the groups down: a scenario that abandoned a
    # collective (the timeout) must not wait for it at exit
    os._exit(0)


if __name__ == "__main__":
    main()
