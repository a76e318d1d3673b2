"""PyTorch port, training across processes on the CPU: 2 and 4 processes
over gloo, each a ``tests/torch_mp_worker.py`` subprocess joined through a
``FileStore`` in ``tmp_path`` (no TCP port) and held to its own timeout, as
``tests/test_multiprocess.py`` runs the JAX package across processes.
Imports no JAX.

* bucket lockstep with different streams (caption rungs in the key, a key
  outside the bin table held), at 2 and at 4 processes;
* ``WindowedBucketSync``'s timeout and poisoning on unequal finite
  streams;
* a ``{fsdp: 2}`` checkpoint saved by process 0 and restored into every
  process's shard;
* collective validation and one export by process 0;
* ``Trainer.run()`` through the SANA entry point at ``{dp: 2, fsdp: 2}``
  with checkpoints and a resume, the state identical on every process;
* the mesh's checks at the shipped configs' sizes.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")


def launch(scenarios, world, tmp_path, timeout=150):
    """Run the comma-separated ``scenarios`` in turn in ``world`` worker
    processes; returns each process's output.  A worker that fails or
    outlives ``timeout`` seconds fails the test, and every worker is
    killed."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenarios, str(r), str(world),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{scenarios}: a worker outlived {timeout}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and all(
            f"{s} OK" in out for s in scenarios.split(",")), \
            f"{scenarios} worker {r} failed:\n{out[-4000:]}"
    return outs


def launch_in_background(scenarios, world, tmp, timeout=300):
    """:func:`launch` on a thread (a test's JAX references compile
    meanwhile); the returned ``join()`` gives its outputs or raises its
    failure."""
    box = {}

    def run():
        try:
            box["out"] = launch(scenarios, world, tmp, timeout)
        except BaseException as e:  # noqa: BLE001 — re-raised at join
            box["error"] = e
    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["out"]
    return join


def results(tmp_path, name, world, scenario=None):
    """What each process wrote as ``name`` in ``scenario``'s directory."""
    d = tmp_path / (scenario or name)
    return [dict(np.load(d / f"{name}-{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both worlds' launches, started together on threads: {world: (its
    directory, the join of its launch)}.  2 processes: lockstep, the fsdp
    checkpoint, the collective validation and export, then the bucket
    sync's timeout (last: it abandons a collective); 4 processes:
    lockstep, then the trainer's rehearsal at {dp: 2, fsdp: 2}."""
    out = {}
    for world, scenarios, timeout in (
            (2, "lockstep,checkpoint,save_validate,timeout", 150),
            (4, "lockstep,rehearsal", 300)):
        tmp = tmp_path_factory.mktemp(f"world{world}")
        out[world] = tmp, launch_in_background(scenarios, world, tmp,
                                               timeout)
    return out


@pytest.fixture(scope="module")
def pair(launches):
    """The 2-process launch's directory and outputs."""
    tmp, join = launches[2]
    return tmp, join()


@pytest.fixture(scope="module")
def quad(launches):
    """The 4-process launch's directory and outputs."""
    tmp, join = launches[4]
    return tmp, join()


@pytest.mark.parametrize("world", [2, 4])
def test_bucket_lockstep(world, request):
    """Processes reading different shards (one with a key outside the bin
    table, the rungs 128/256/300 in different mixes) emit the same 12
    batches: same bucket, same caption length, full batches; a rung that
    only some processes fill is never drained; the unknown key is held
    with one warning on the process that has it."""
    tmp, outs = request.getfixturevalue("quad" if world == 4 else "pair")
    res = results(tmp, "lockstep", world)
    seqs = [json.loads(str(r["seq"])) for r in res]
    assert all(s == seqs[0] for s in seqs)
    assert len(seqs[0]) == 12
    assert {tuple(b[:2]) for b in seqs[0]} >= {("1.0", 300), ("1.0", 128)}
    assert all(b[1] in (128, 300) and b[2] == 3 for b in seqs[0])
    assert [json.loads(str(r["paths"])) for r in res] == [
        [str(tmp / "lockstep" / f"s{i}.tar")] for i in range(world)]
    warned = json.loads(str(res[0]["warned"]))
    assert warned and all(k.startswith("9.9|") for k in warned)
    assert outs[0].count("not in the canonical sync table") == len(warned)
    assert all(json.loads(str(r["warned"])) == [] for r in res[1:])


def test_bucket_sync_timeout_poisons(pair):
    """Unequal finite streams: zeros before the first all-gather, the
    element-wise minimum after it; the longer process's next all-gather
    raises within its 3 s timeout naming the window, and every later one
    refuses as poisoned."""
    res = results(pair[0], "timeout", 2)
    for r in res:
        assert json.loads(str(r["zeros"])) == {"a": 0, "b": 0}
        assert json.loads(str(r["mins"])) == {"a": 2, "b": 1}
    said = json.loads(str(res[0]["said"]))
    assert len(said) == 2
    assert "all-gather #2 did not complete within 3s" in said[0]
    assert "unequal finite streams" in said[0]
    assert "poisoned" in said[1]
    assert 2.5 < float(res[0]["waited"]) < 30


def test_fsdp_checkpoint_save_and_restore(pair):
    """{fsdp: 2}: each process holds about half the frozen base; process 0
    alone writes ``5.pt`` with the whole leaves; after every tensor is
    moved, the restore brings back each process's shard, the adapters,
    the EMA, the optimizer and the step."""
    res = results(pair[0], "checkpoint", 2)
    assert [int(r["pending"]) for r in res] == [1, 0]
    for r in res:
        assert int(r["resident"]) < 0.6 * int(r["whole"])
        assert json.loads(str(r["files"])) == ["5.pt"]
        assert bool(r["saved_whole"]) and bool(r["equal_shards"])
        assert int(r["step"]) == 5 and int(r["count"]) == 0
        before = [k for k in r if k.startswith("before/")]
        assert before
        for k in before:
            np.testing.assert_array_equal(r[k], r["after/" + k[7:]])


def test_collective_validation_and_export(pair):
    """Every process runs validation (the model's forward gathers the
    sharded base) to the same loss; process 0 writes the one export,
    equal to every process's adapters; a validation failure propagates
    on every process and is not counted."""
    res = results(pair[0], "save_validate", 2)
    assert res[0]["losses"].tolist() == res[1]["losses"].tolist()
    for r in res:
        assert bool(r["same"])
        assert str(r["said"]) == "validation broke"
        assert int(r["failures"]) == 0
        assert json.loads(str(r["exports"])) == ["2"]


def test_trainer_run_dp2_fsdp2_with_resume(quad):
    """``yat_tpu_torch.frontends.sana.main`` at ``{dp: 2, fsdp: 2}`` over
    4 processes: 4 steps with checkpoints at 2 and 4, then a resume to 6
    (checkpoint, data fast-forward); the adapters, the EMA, the AdamW
    moments and the logged global losses are identical on every process,
    and the resumed steps moved the adapters."""
    tmp, outs = quad
    res = results(tmp, "rehearsal", 4)
    for r in res[1:]:
        assert set(r) == set(res[0])
        for k, v in res[0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)
    r0 = res[0]
    assert int(r0["4/step"]) == 4 and int(r0["6/step"]) == 6
    assert int(r0["6/count"]) == 6 and bool(r0["4/sharded"])
    assert np.isfinite(r0["4/loss"]).all() and len(r0["6/loss"]) == 2
    assert json.loads(str(r0["ckpts"])) == ["2.pt", "4.pt", "6.pt"]
    assert json.loads(str(r0["exports"])) == ["2", "4", "6"]
    moved = [k for k in r0 if k.startswith("4/leaf/")
             and not np.array_equal(r0[k], r0["6/" + k[2:]])]
    assert moved
    assert all("resumed from step 4" in o and "backend gloo" in o
               for o in outs)


def test_mesh_checks_at_the_shipped_sizes():
    """The shipped configs' meshes are accepted at their world sizes, as
    the four axes; ``tp`` and ``sp`` are accepted beside ``dp``; another
    size names both numbers."""
    import yaml

    from yat_tpu_torch.parallel.mesh import mesh_dims
    repo = os.path.dirname(os.path.dirname(WORKER))
    want = {"sana_512_lora": (8, {"dp": 8, "fsdp": 1, "tp": 1, "sp": 1}),
            "sd35_flow_lokr": (8, {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1}),
            "flux_klein_lora": (8, {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1})}
    for name, (world, dims) in want.items():
        with open(os.path.join(repo, "configs", f"{name}.yaml")) as f:
            shape = yaml.safe_load(f)["mesh_shape"]
        assert mesh_dims(shape, world) == dims
        with pytest.raises(ValueError, match=rf"needs {world} devices.*"
                           r"has 2 processes"):
            mesh_dims(shape, 2)
    assert mesh_dims(None, 3) == {"dp": 3, "fsdp": 1, "tp": 1, "sp": 1}
    for ax in ("tp", "sp"):
        assert mesh_dims({"dp": 2, ax: 2}, 4) == {
            "dp": 2, "fsdp": 1, "tp": 1, "sp": 1, ax: 2}


def test_chip_smoke_multiprocess_phase_on_cpu(tmp_path, monkeypatch):
    """``chip_smoke.phase_multiprocess_train`` rehearsed at the tiny SANA
    (tiny encoders, one validation prompt) and the tiny PixArt: four
    processes of the SANA entry point under ``torch.distributed.run`` at
    ``{fsdp: 2, tp: 2}`` then ``{dp: 2, sp: 2}``, two of PixArt's at
    ``{sp: 2}``, every check of the phase (backend, equal states, one
    writer, the restore, each run's reduced step against the one-process
    step on the whole batch in fp32 and in bf16, launches 0 on the CPU, a
    quarter of the split frozen base resident)."""
    import torch

    import chip_smoke
    monkeypatch.setattr(chip_smoke.tempfile, "tempdir", str(tmp_path))
    tiny = {"hidden_dim": "32", "num_layers": "1",
            "num_attention_heads": "2", "attention_head_dim": "16",
            "num_cross_attention_heads": "2",
            "cross_attention_head_dim": "16", "caption_channels": "32",
            "max_caption_len": "8", "mlp_ratio": "1.0", "in_channels": "32",
            "out_channels": "32", "sample_size": "4",
            "vae_compression": "4", "tiny_encoders": "1"}
    pixart = {"hidden_dim": "32", "num_layers": "1",
              "num_attention_heads": "2", "attention_head_dim": "16",
              "caption_channels": "16", "max_caption_len": "8",
              "mlp_ratio": "1.0", "sample_size": "8"}
    counts = chip_smoke.phase_multiprocess_train(
        torch.device("cpu"), "cpu",
        shard_args={"n": 24, "latent": (4, 4, 32), "dim": 32,
                    "lengths": (3, 8)},
        cfg_extra={"model_config_overrides": tiny, "batch_size": 2,
                   "validation_prompts": ["a fox"]}, timeout=240,
        pixart_shard={"n": 12, "latent": (8, 8, 4), "dim": 16,
                      "lengths": (3, 8)},
        pixart_extra={"model_config_overrides": pixart, "batch_size": "2"})
    assert set(counts) == {"fsdp-tp", "dp-sp", "pixart-sp"}
    assert not any(any(c.values()) for c in counts.values())
