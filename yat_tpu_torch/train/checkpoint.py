"""Full train-state checkpoints and the weights-only export.

Counterpart of ``yat_tpu/train/checkpoint.py``, with ``torch.save`` in
place of Orbax.  A train state is a nested structure of dicts and lists
whose leaves are tensors, ints, floats or None (``Trainer.train_state``:
the step, the model's state dict with a quantized base's int8 payloads and
scales, the optimizer's count, micro-step, accumulator and moments or Lion
payloads and block scales, the EMA copies and the frozen snapshot).

* :func:`save_train_state` copies every tensor to the host before it
  returns, then writes ``{directory}/{step}.pt`` on a background thread:
  first under a temporary name, then renamed, so a half-written step is
  never the latest.  A save waits for the previous write to the same
  directory; once a write lands, only the latest 3 steps are kept
  (Orbax's ``max_to_keep=3``).
* :func:`wait_for_checkpoints` waits for pending writes (the run's end);
  a write that failed raises there.
* :func:`restore_train_state` waits for pending writes, reads the latest
  step with ``torch.load(weights_only=True)`` and copies it into the live
  tensors of a state of the same structure, in place (each keeps its
  device and dtype; a shape, dtype or structure that differs raises).  A
  directory that does not exist, or holds no step, restores as
  ``(None, 0)``.  LoRA dropout is configuration, not state: a checkpoint
  saved at one rate resumes at another.
* Across processes the trainer gathers the sharded leaves on every
  process and calls :func:`save_train_state` on process 0 alone; every
  process restores, after process 0's writes have landed, and keeps its
  own slice (``train/engine.py``).  The writer thread runs no collective.
* :func:`save_params_only` / :func:`load_params_only`: the weights-only
  export of full fine-tuning, ``model.safetensors`` with flat dotted flax
  keys (the JAX package's ``load_params_only`` reads it).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

MAX_TO_KEEP = 3
_STEP_FILE = re.compile(r"^(\d+)\.pt$")

# directory → its pending write (a thread and the error it met, if any)
_PENDING: Dict[str, "_Write"] = {}
_LOCK = threading.Lock()


class _Write(threading.Thread):
    def __init__(self, directory: str, step: int, state):
        super().__init__(name=f"checkpoint-{step}", daemon=False)
        self.directory, self.step, self.state = directory, step, state
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            final = os.path.join(self.directory, f"{self.step}.pt")
            tmp = os.path.join(self.directory, f".{self.step}.pt.part")
            torch.save(self.state, tmp)
            os.replace(tmp, final)
            for old in checkpoint_steps(self.directory)[:-MAX_TO_KEEP]:
                os.remove(os.path.join(self.directory, f"{old}.pt"))
        except BaseException as e:  # noqa: BLE001 — raised at the wait
            self.error = e
        finally:
            self.state = None


def checkpoint_steps(directory: str) -> list:
    """The steps saved in ``directory``, in increasing order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def _to_host(node):
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_host(v) for v in node]
    return node


def _wait(directory: str) -> None:
    with _LOCK:
        write = _PENDING.pop(directory, None)
    if write is None:
        return
    write.join()
    if write.error is not None:
        raise RuntimeError(f"checkpoint step {write.step} in {directory} "
                           "was not written") from write.error


def save_train_state(directory: str, state, step: int,
                     wait: bool = False) -> None:
    """Copy ``state`` to the host now and write it as step ``step`` in the
    background (``wait=True`` blocks until it lands)."""
    directory = os.path.abspath(directory)
    _wait(directory)
    os.makedirs(directory, exist_ok=True)
    write = _Write(directory, int(step), _to_host(state))
    with _LOCK:
        _PENDING[directory] = write
    write.start()
    if wait:
        _wait(directory)


def wait_for_checkpoints(directory: Optional[str] = None) -> None:
    """Block until the pending writes (to ``directory``, or to every
    directory) land; raise if one failed."""
    if directory is not None:
        _wait(os.path.abspath(directory))
        return
    with _LOCK:
        dirs = list(_PENDING)
    for d in dirs:
        _wait(d)


def _copy_into(live, saved, path: str):
    """``saved`` copied into ``live``'s tensors in place; returns the live
    structure with ``saved``'s ints and floats."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{path}: the checkpoint holds "
                             f"{type(saved).__name__}, not a tensor")
        if saved.shape != live.shape or saved.dtype != live.dtype:
            raise ValueError(
                f"{path}: the checkpoint holds {tuple(saved.shape)} "
                f"{saved.dtype}, the live state {tuple(live.shape)} "
                f"{live.dtype}")
        with torch.no_grad():
            live.copy_(saved)
        return live
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            extra = sorted(set(saved) - set(live)) if isinstance(
                saved, dict) else []
            missing = sorted(set(live) - set(saved)) if isinstance(
                saved, dict) else sorted(live)
            raise ValueError(f"{path or 'the state'}: the checkpoint's keys "
                             f"differ (missing {missing[:4]}, extra "
                             f"{extra[:4]})")
        return {k: _copy_into(v, saved[k], f"{path}/{k}")
                for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
            raise ValueError(f"{path}: the checkpoint holds another number "
                             "of entries")
        return [_copy_into(v, s, f"{path}[{i}]")
                for i, (v, s) in enumerate(zip(live, saved))]
    if (live is None) != (saved is None):
        raise ValueError(f"{path}: present in only one of the checkpoint "
                         "and the live state")
    return saved


def restore_train_state(directory: str, like) -> Tuple[Optional[Any], int]:
    """The latest step of ``directory`` copied into ``like`` (a state of
    the same structure, whose tensors are overwritten in place) and the
    step, or ``(None, 0)`` when there is none."""
    directory = os.path.abspath(directory)
    _wait(directory)
    steps = checkpoint_steps(directory)
    if not steps:
        return None, 0
    saved = torch.load(os.path.join(directory, f"{steps[-1]}.pt"),
                       map_location="cpu", weights_only=True)
    return _copy_into(like, saved, ""), steps[-1]


def save_params_only(directory: str, params: Dict[str, Any]) -> None:
    """Weights-only export: ``params`` (a nested dict of arrays, or flat
    dotted names) as ``{directory}/model.safetensors``, fp32, flat dotted
    keys."""
    from yat_tpu_torch.adapters.io import write_safetensors

    flat: Dict[str, np.ndarray] = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                if isinstance(v, torch.Tensor):
                    v = v.detach().float().cpu().numpy()
                flat[name] = np.ascontiguousarray(v, dtype=np.float32)

    walk(params)
    write_safetensors(os.path.join(directory, "model.safetensors"), flat)


def load_params_only(path: str, like) -> Any:
    """A flat ``model.safetensors`` (``path`` or its directory) back into
    the nested tree of ``like``; a missing parameter or another shape
    raises."""
    from yat_tpu_torch.adapters.io import read_safetensors
    if os.path.isdir(path):
        path = os.path.join(path, "model.safetensors")
    flat, _ = read_safetensors(path)

    def walk(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, name)
                continue
            if name not in flat:
                raise KeyError(f"{path} missing parameter {name}")
            arr = flat[name]
            if tuple(arr.shape) != tuple(np.shape(v)):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {tuple(np.shape(v))}")
            out[k] = arr
        return out

    return walk(like)
