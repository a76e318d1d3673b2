"""PyTorch port, full train-state checkpoints, resume, the profiler window
and the exports on the CPU: round trips of the whole state (AdamW, Lion
with 8-bit momentum over an int8 base, accumulation stopped mid-cycle,
EMA, the preservation snapshot) bit for bit, followed by steps equal to
those taken without the save; retention of 3; a missing directory; the
``lora_dropout`` rate changed across a resume in both directions; an
engine resume that continues the data stream where the checkpointed run
stopped (``tests/test_resume_fastforward.py``); the profiler trace of runs
of 16 and 12 steps; the full fine-tuning export read by the JAX package's
``load_params_only`` and reloaded through ``pretrained_model_path`` with
its softmax-patched blocks; and ``output_repo``."""

import glob
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from tests.test_torch_port_train import TARGETS, TINY_OVERRIDES, _tiny_shard
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# hidden 64: the 64 x 64 attention kernels reach the int8 base's
# 4096-element quantization threshold
WIDE = {**TINY_OVERRIDES, "hidden_dim": "64", "attention_head_dim": "32",
        "num_attention_heads": "2", "cross_attention_head_dim": "32",
        "num_cross_attention_heads": "2", "num_layers": "2",
        "softmax_self_attn_blocks": [1]}
LORA = {"lora_rank": "4", "lora_alpha": "4", "lora_algo": "lora",
        "lora_target_modules": TARGETS}
CASES = {
    "lora-adamw-ema": {**LORA, "use_ema": "true", "lora_dropout": "0.1"},
    "lora-lion8bit-int8-base": {**LORA, "use_ema": "true",
                                "use_adamw_8bit": "true",
                                "lora_base_model_8bit": "true"},
    "full-unfreeze-accum-mid-cycle": {
        "use_ema": "true", "gradient_accumulation_steps": "2",
        "unfreeze_modules": ["blocks_1"]},
    "full-preservation-snapshot": {"use_preservation": "true"},
}


def _params(tmp_path, **over):
    from yat_tpu_torch.config import TrainingParameters
    raw = {"batch_size": "2", "learning_rate": "1e-2", "steps": "10",
           "warmup_steps": "1", "weight_decay": "0.01",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": dict(WIDE)}
    raw.update(over)
    return TrainingParameters.from_dict(raw)


def _trainer(tmp_path, **over):
    from yat_tpu_torch.frontends.sana import make_trainer
    t = make_trainer(_params(tmp_path, **over), sampler=(), device="cpu")
    t.initialize()
    return t


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones((2, 8), dtype=torch.int32)
    mask[0, 5:] = 0
    return {"latents": torch.randn((2, 8, 8, 4), generator=g),
            "embeddings": torch.randn((2, 8, 16), generator=g),
            "text_mask": mask}


def _steps(trainer, n, seed):
    for i in range(n):
        trainer._step_fn(_batch(i), torch.Generator().manual_seed(seed + i))


def _leaves(node, path=""):
    if isinstance(node, torch.Tensor):
        yield path, node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, node


def _assert_same_state(a, b):
    la, lb = list(_leaves(a.train_state())), list(_leaves(b.train_state()))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_round_trip_is_bit_exact(tmp_path, case):
    """Train a few micro-steps, save, restore into a fresh trainer through
    ``resume``: every tensor of the state bit-equal (the int8 payloads and
    scales, the Lion payloads and block scales, the accumulator after one
    of two micro-steps, the EMA copies, the snapshot); then two more
    micro-steps on the same batches and draws give the same bits in both."""
    from yat_tpu_torch.train.checkpoint import save_train_state

    over = dict(CASES[case], checkpoint_dir=str(tmp_path / "ckpt"))
    a = _trainer(tmp_path, **over)
    _steps(a, 3, seed=10)
    a.global_step = 1
    save_train_state(str(tmp_path / "ckpt"), a.train_state(), 1, wait=True)
    state = dict(_leaves(a.train_state()))
    if case.startswith("full-unfreeze"):
        assert a.optimizer.mini_step == 1
        assert any(bool(t.abs().sum() > 0) for t in a.optimizer.acc)
    if "lion" in case:
        assert any(k.startswith("/optimizer/lion_payload") for k in state)
        assert any(t.dtype == torch.int8 for k, t in state.items()
                   if k.startswith("/model/") and k.endswith("qweight"))
    if "preservation" in case:
        assert a.frozen_base is not None

    b = _trainer(tmp_path, resume="true", **over)
    assert b.global_step == 1
    _assert_same_state(a, b)
    _steps(a, 2, seed=20)
    _steps(b, 2, seed=20)
    _assert_same_state(a, b)


def test_retention_keeps_the_latest_three(tmp_path):
    """Five saves leave steps 3, 4 and 5 (no temporary files); the restore
    takes step 5's values into the live tensors."""
    from yat_tpu_torch.train.checkpoint import (checkpoint_steps,
                                                restore_train_state,
                                                save_train_state,
                                                wait_for_checkpoints)
    d = str(tmp_path / "ckpt")
    for step in range(1, 6):
        save_train_state(d, {"w": torch.full((3,), float(step)),
                             "n": step}, step)
    wait_for_checkpoints()
    assert checkpoint_steps(d) == [3, 4, 5]
    assert sorted(os.listdir(d)) == ["3.pt", "4.pt", "5.pt"]
    live = {"w": torch.zeros(3), "n": 0}
    restored, step = restore_train_state(d, live)
    assert step == 5 and restored["n"] == 5
    assert restored["w"] is live["w"] and torch.equal(live["w"],
                                                      torch.full((3,), 5.0))


def test_missing_directory_and_misfit_state(tmp_path):
    """A directory that does not exist (or holds no step) restores as
    (None, 0); a state of another structure, shape or dtype raises."""
    from yat_tpu_torch.train.checkpoint import (restore_train_state,
                                                save_train_state)
    like = {"w": torch.zeros(3)}
    assert restore_train_state(str(tmp_path / "nope"), like) == (None, 0)
    os.makedirs(tmp_path / "empty")
    assert restore_train_state(str(tmp_path / "empty"), like) == (None, 0)
    save_train_state(str(tmp_path / "c"), {"w": torch.ones(3)}, 2, wait=True)
    for bad in ({"w": torch.zeros(4)}, {"w": torch.zeros(3, dtype=torch.int8)},
                {"v": torch.zeros(3)}):
        with pytest.raises(ValueError):
            restore_train_state(str(tmp_path / "c"), bad)


@pytest.mark.parametrize("save_rate,resume_rate", [(0.1, 0.0), (0.0, 0.1)])
def test_dropout_rate_toggle_resumes(tmp_path, save_rate, resume_rate):
    """``lora_dropout`` is configuration, not state: a checkpoint saved at
    one rate resumes at the other, with the live rate kept
    (``tests/test_checkpoint.py:72``)."""
    from yat_tpu_torch.adapters.builder import adapted_modules

    over = dict(LORA, checkpoint_dir=str(tmp_path / "ckpt"),
                num_steps_per_validation="1")
    a = _trainer(tmp_path, lora_dropout=str(save_rate), **over)
    _steps(a, 1, seed=3)
    a.global_step = 3
    a.save_checkpoint()
    b = _trainer(tmp_path, lora_dropout=str(resume_rate), resume="true",
                 **over)
    assert b.global_step == 3
    _assert_same_state(a, b)
    assert {m.lora_dropout for _, m in adapted_modules(b.model)} == {
        resume_rate}


def _config(tmp_path, shard, name="config.yaml", **over):
    import yaml
    cfg = {"local_shard_paths": [shard], "batch_size": "2",
           "learning_rate": "1e-3", "steps": "3", "warmup_steps": "1",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": dict(TINY_OVERRIDES), **LORA}
    cfg.update(over)
    path = tmp_path / name
    # None drops a key
    path.write_text(yaml.safe_dump({k: v for k, v in cfg.items()
                                    if v is not None}))
    return str(path)


def test_engine_resume_continues_the_data_stream(tmp_path, monkeypatch,
                                                 capsys):
    """A run of 3 steps checkpoints at step 3; a run with ``resume`` to
    step 6 restores it, skips the 3 batches it consumed and trains on the
    batches 4-6 of an uninterrupted run of 6 steps
    (``tests/test_resume_fastforward.py:30,108``)."""
    from yat_tpu_torch.frontends.sana import main
    from yat_tpu_torch.train.engine import Trainer

    shard = _tiny_shard(tmp_path / "s.tar", n=16, ratios=False)
    seen = []
    device_batch = Trainer._device_batch

    def record(self, batch):
        seen.append(np.array(batch.latents))
        return device_batch(self, batch)
    monkeypatch.setattr(Trainer, "_device_batch", record)

    main(["--config", _config(tmp_path, shard, "whole.yaml", steps="6"),
          "--device", "cpu"])
    whole, seen[:] = list(seen), []
    ckpt = {"checkpoint_dir": str(tmp_path / "ckpt"),
            "num_steps_per_validation": "3"}
    t1 = main(["--config", _config(tmp_path, shard, "a.yaml", **ckpt),
               "--device", "cpu"])
    assert t1.global_step == 3 and os.listdir(tmp_path / "ckpt") == ["3.pt"]
    seen[:] = []
    t2 = main(["--config", _config(tmp_path, shard, "b.yaml", steps="6",
                                   resume="true", **ckpt),
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert t2.global_step == 6 and len(t2.history) == 3
    assert "resumed from step 3" in out
    assert "data fast-forward: skipped 3 batches" in out
    assert len(seen) == 3
    for got, want in zip(seen, whole[3:6]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("steps", [16, 12])
def test_profiler_trace_written(tmp_path, capsys, steps):
    """``profile_dir``: the window opens when a batch arrives at step 10
    and closes at step 15, or when the run ends first (12 steps: the JAX
    trainer's window would never close and write nothing)."""
    from yat_tpu_torch.frontends.sana import main

    shard = _tiny_shard(tmp_path / "s.tar", n=8, ratios=False)
    prof = tmp_path / "prof"
    main(["--config", _config(tmp_path, shard, steps=str(steps),
                              profile_dir=str(prof)), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[engine] profiler trace in") == 1
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the window held the forwards of the steps it covered
    assert sum(e.get("name") == "aten::linear" for e in events) > 0


def test_full_finetune_export_reads_in_jax_and_reloads(tmp_path):
    """Full fine-tuning of a softmax-patched tiny SANA through the entry
    point: ``{output_dir}/{step}/model.safetensors`` (fp32, flat flax
    keys) reads back through the JAX package's ``load_params_only`` equal
    to the trained parameters, ``config.json`` records the patched blocks,
    and a trainer built on ``pretrained_model_path`` = that directory has
    the patched blocks and the trained weights."""
    from yat_tpu.train.checkpoint import load_params_only as j_load
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.frontends.sana import main, make_trainer
    from yat_tpu_torch.models.layers import Attention, LiteLinearAttention
    from yat_tpu_torch.train.checkpoint import load_params_only

    shard = _tiny_shard(tmp_path / "s.tar")
    over = dict(TINY_OVERRIDES, num_layers="2", softmax_self_attn_blocks=[1])
    cfg = _config(tmp_path, shard, steps="2", lora_rank=None,
                  lora_algo=None, lora_target_modules=None,
                  model_config_overrides=over)
    trainer = main(["--config", cfg, "--device", "cpu"])
    out = tmp_path / "out" / "2"
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    assert json.loads((out / "config.json").read_text()) == {
        "modified_blocks": [1]}
    want = {k: v.numpy() for k, v in flax_params(trainer.model).items()}
    like: dict = {}
    for k, v in want.items():
        *keys, leaf = k.split(".")
        node = like
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = v
    for loader in (j_load, load_params_only):
        got = dict(_flat_tree(loader(str(out), like)))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    from yat_tpu_torch.config import TrainingParameters
    reload = TrainingParameters.from_dict({
        "local_shard_paths": [shard], "batch_size": "2",
        "learning_rate": "1e-3", "steps": "1",
        "num_steps_per_validation": "100", "validation_prompts": [],
        "output_dir": str(tmp_path / "again"),
        "pretrained_model_path": str(out),
        "model_config_overrides": dict(TINY_OVERRIDES, num_layers="2")})
    again = make_trainer(reload, device="cpu")
    assert again.sana_config.softmax_self_attn_blocks == (1,)
    assert isinstance(again.model.blocks[1].attn1, Attention)
    assert isinstance(again.model.blocks[0].attn1, LiteLinearAttention)
    for k, v in flax_params(again.model).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def _flat_tree(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tree(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("hub", ["uploads", "upload-fails", "absent"])
def test_output_repo_uploads_or_warns(tmp_path, monkeypatch, capsys, hub):
    """``output_repo``: each export goes to the hub repository under its
    step; a failed upload, or no ``huggingface_hub``, prints the JAX
    trainer's warning and the run goes on.  (A stand-in module: nothing
    leaves the machine.)"""
    from yat_tpu_torch.frontends.sana import main

    calls = []

    class HfApi:
        def upload_folder(self, **kw):
            if hub == "upload-fails":
                raise OSError("no network")
            calls.append(kw)
    fake = None if hub == "absent" else types.SimpleNamespace(HfApi=HfApi)
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    shard = _tiny_shard(tmp_path / "s.tar", n=8, ratios=False)
    main(["--config", _config(tmp_path, shard, steps="2",
                              output_repo="user/repo"), "--device", "cpu"])
    out = capsys.readouterr().out
    if hub == "uploads":
        assert calls == [{"folder_path": str(tmp_path / "out" / "2"),
                          "repo_id": "user/repo", "path_in_repo": "2"}]
        assert "pushed" in out
    else:
        assert "[Warning] output_repo upload failed" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's phases of this slice, rehearsed on the CPU
# ---------------------------------------------------------------------------

TINY_SHARD = {"n": 24, "latent": (8, 8, 4), "dim": 16, "lengths": (3, 8)}


def test_chip_smoke_full_finetune_phase_on_cpu():
    """chip_smoke.py's full fine-tuning phase at the tiny size in fp32: 16
    steps with checkpoints and the profiler, blocks_1 the only one
    unfrozen, the cut back to step 8 and the resumed run (no launches on
    the CPU)."""
    import chip_smoke

    counts = chip_smoke.phase_full_finetune(
        torch.device("cpu"), "cpu", shard_args=TINY_SHARD,
        cfg_extra={"batch_size": "4", "bfloat16": None,
                   "unfreeze_modules": ["blocks_1"],
                   "model_config_overrides": dict(
                       TINY_OVERRIDES, num_layers="2",
                       softmax_self_attn_blocks=[1])})
    assert counts["adaln_layernorm_bwd"] == 0 and set(counts) == {
        "adaln_layernorm", "dot_product_attention", "linear_attention",
        "adaln_layernorm_bwd", "dot_product_attention_bwd"}


def test_chip_smoke_full_ft_grad_reference_phase_on_cpu():
    """chip_smoke.py's full fine-tuning gradient reference with both runs
    on the CPU (two SANA blocks cut in width): every parameter's gradient,
    no flipped kinks."""
    import chip_smoke

    chip_smoke.phase_full_ft_grad_reference(
        torch.device("cpu"), width={"hidden_dim": 64, "num_attention_heads": 2,
                                    "attention_head_dim": 32,
                                    "num_cross_attention_heads": 2,
                                    "cross_attention_head_dim": 32,
                                    "caption_channels": 32})


def test_chip_smoke_full_ft_launch_counts():
    """A full fine-tuning step launches K1b once more than a LoRA step
    (block 0's first norm has trainable inputs): 57 at SANA-0.6B's 28
    blocks; exploration and the preservation term multiply the forwards
    (1 + N + 2) and the backwards (2)."""
    import chip_smoke
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.models.sana import SANA_600M
    import dataclasses

    cfg = dataclasses.replace(SANA_600M,
                              softmax_self_attn_blocks=(12, 13, 14, 15))
    full, _ = chip_smoke.sana_step_launches(cfg, False, full_ft=True)
    lora, _ = chip_smoke.sana_step_launches(cfg, False)
    assert full == {"adaln_layernorm": 57, "dot_product_attention": 32,
                    "linear_attention": 24, "adaln_layernorm_bwd": 57,
                    "dot_product_attention_bwd": 32}
    assert lora["adaln_layernorm_bwd"] == 56
    params = TrainingParameters.from_dict(
        {"urls": [], "batch_size": "1", "learning_rate": "1", "steps": "1",
         "num_steps_per_validation": "1", "validation_prompts": [],
         **chip_smoke.EXPLORE_KEYS})
    assert chip_smoke.step_passes(params) == (7, 2)
    scaled = chip_smoke.scale_launches(lora, chip_smoke.step_passes(params))
    assert scaled["adaln_layernorm"] == 7 * 57
    assert scaled["adaln_layernorm_bwd"] == 2 * 56


def test_chip_smoke_explore_preserve_phases_on_cpu():
    """chip_smoke.py's SANA phase with exploration and the preservation
    term, and its PixArt-Sigma phase with the preservation term, at the
    tiny size in fp32 (the checkpoint round trip of the SANA run
    included)."""
    import chip_smoke
    from tests.test_torch_port_pixart import TINY_PIXART

    counts = chip_smoke.phase_train(
        torch.device("cpu"), "cpu", shard_args=TINY_SHARD,
        cfg_extra={**chip_smoke.EXPLORE_KEYS, "batch_size": "4",
                   "bfloat16": None,
                   "model_config_overrides": dict(TINY_OVERRIDES)},
        label="explore+preserve train", remat=False)
    assert not any(counts.values())
    counts = chip_smoke.phase_pixart_train(
        torch.device("cpu"), "cpu",
        shard_args={"n": 16, "latent": (8, 8, 4), "dim": 32},
        cfg_extra={**chip_smoke.PIXART_PRESERVE_KEYS, "batch_size": "2",
                   "bfloat16": None,
                   "model_config_overrides": {
                       k: v for k, v in TINY_PIXART.items()
                       if k != "tiny_encoders"}},
        label="pixart preserve train", remat=False)
    assert not any(counts.values())
