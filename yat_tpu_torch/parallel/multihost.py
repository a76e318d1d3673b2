"""Multi-process coordination over ``torch.distributed``.

Counterpart of ``yat_tpu/parallel/multihost.py``.  One process drives one
card; ``torchrun --nproc_per_node N`` launches them.

* :func:`initialize_distributed` brings the process group up once, from
  arguments or from torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), with an explicit
  timeout.  The backend is NCCL when every process has a card of its own,
  gloo on the CPU or when processes share a card (NCCL refuses two ranks
  on one device); the choice is printed in one line.  A failure raises:
  no other backend is tried.  A second, gloo group carries the host-side
  collectives (the bucket sync, barriers, broadcasts), so that they never
  interleave with the step's collectives on one communicator.
* :func:`process_index` / :func:`process_count`: the rank and the world
  size (0 and 1 without a process group).
* :func:`data_index` / :func:`data_count`: the ``dp`` × ``fsdp``
  coordinate of this process and the number of such coordinates (the
  rank and the world size until a mesh with ``tp`` or ``sp`` sets them,
  :func:`set_data_axes`).  Every reader that picks rows (shard lists,
  the sampler's shuffle, extraction names, the noise seed) takes them, so
  ``tp`` and ``sp`` peers read the same rows.
* :func:`host_seed`: per-process seeds derived from the global seed.
* :func:`broadcast_from_main`: a small host value from process 0.
* :class:`WindowedBucketSync`: the amortised bucket reconciliation of the
  feature sampler's ``sync_hook``.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch

# the default timeout of the process groups (every collective fails after
# it instead of hanging)
DEFAULT_TIMEOUT_S = 1800.0

_HOST_GROUP = None
# (data index, data count) set by the mesh, or None: the rank and world
_DATA_AXES = None


def _dist():
    import torch.distributed as dist
    return dist


def is_distributed() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return _dist().get_rank() if is_distributed() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_distributed() else 1


def set_data_axes(index: Optional[int], count: Optional[int] = None) -> None:
    """This process's ``dp`` × ``fsdp`` coordinate and their number (None:
    back to the rank and the world size)."""
    global _DATA_AXES
    _DATA_AXES = None if index is None else (int(index), int(count))


def data_index() -> int:
    return _DATA_AXES[0] if _DATA_AXES is not None else process_index()


def data_count() -> int:
    return _DATA_AXES[1] if _DATA_AXES is not None else process_count()


def data_peer_rank() -> int:
    """This process's rank among the processes of its data coordinate (0
    for the one that writes what that coordinate produces)."""
    return process_index() % max(1, process_count() // data_count())


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK`` (the rank when it is not set)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_count() -> int:
    """torchrun's ``LOCAL_WORLD_SIZE`` (the world size when it is not
    set)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def choose_backend(device_type: str) -> str:
    """``nccl`` when every local process has a card of its own, else
    ``gloo`` (the CPU, or processes sharing a card)."""
    if device_type != "cuda":
        return "gloo"
    if local_count() > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: Optional[str] = None,
                           store=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring the process group up once; returns whether it is up.

    Idempotent, and a no-op for one process.  Without arguments it reads
    torchrun's environment.  ``coordinator_address`` is ``host:port`` (a
    ``tcp://`` rendezvous); ``store`` (a ``torch.distributed.Store``, e.g.
    a ``FileStore``) replaces it.  ``device_type`` (``cuda`` unless no card
    is visible) picks the backend (:func:`choose_backend`)."""
    global _HOST_GROUP
    dist = _dist()
    if dist.is_initialized():
        return True
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return False
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = choose_backend(device_type)
    timeout = datetime.timedelta(seconds=timeout_s)
    kwargs = dict(backend=backend, rank=rank, world_size=world,
                  timeout=timeout)
    if store is not None:
        kwargs["store"] = store
    elif coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    _HOST_GROUP = (dist.new_group(backend="gloo", timeout=timeout)
                   if backend != "gloo" else dist.new_group(timeout=timeout))
    why = ("one card a process" if backend == "nccl" else
           "processes share a card" if device_type == "cuda" else "the CPU")
    print(f"[dist] rank {rank} of {world}: backend {backend} ({why}), "
          f"host collectives over gloo, timeout {timeout_s:.0f}s",
          flush=True)
    return True


def host_group():
    """The gloo group of the host-side collectives (None for one
    process)."""
    return _HOST_GROUP if is_distributed() else None


def barrier() -> None:
    """All processes meet here (nothing for one process)."""
    if is_distributed():
        _dist().barrier(group=host_group())


def host_seed(global_seed: int, process_index: Optional[int] = None) -> int:
    """Decorrelated per-process seed of the shard shuffle and the noise
    (the index defaults to this process's data index, so ``tp`` and
    ``sp`` peers draw alike)."""
    pi = process_index if process_index is not None else data_index()
    return int(np.random.SeedSequence([global_seed, pi]).generate_state(1)[0])


def broadcast_from_main(value: np.ndarray) -> np.ndarray:
    """``value`` as process 0 holds it (a small host array)."""
    if process_count() == 1:
        return value
    arr = np.ascontiguousarray(value)
    t = torch.from_numpy(arr.copy())
    _dist().broadcast(t, src=0, group=host_group())
    return t.numpy().reshape(arr.shape)


class WindowedBucketSync:
    """Amortised cross-process bucket reconciliation (the ``sync_hook`` of
    ``FeatureBucketSampler``): one small all-gather every ``window``
    ingested samples instead of one per sample.

    * The k-th all-gather is entered after exactly ``k * window`` local
      samples (the hook is called once per ingested sample), so processes
      meet it in order.
    * The gathered vector follows the canonical key order fixed at
      construction, so the element-wise minimum compares like with like.
    * Before the first all-gather every canonical bucket reads 0: nothing
      drains during the first window.
    * ``on_drain`` lowers the reconciled minimum as buckets drain between
      all-gathers, so the holdback stays conservative.
    * An all-gather that does not complete within ``allgather_timeout``
      raises with the diagnostics (usually unequal finite streams: another
      process ran out before this window), and the object is poisoned:
      the abandoned collective cannot be rejoined, so every later call
      raises too.

    One process never communicates: ``min_counts`` is its own counts."""

    def __init__(self, bucket_keys, window: int = 256,
                 allgather_timeout: Optional[float] = 600.0):
        self.keys = [str(k) for k in bucket_keys]
        self.window = max(1, int(window))
        self._ingested = 0
        self.min_counts: Dict[str, int] = {}
        self.allgather_timeout = allgather_timeout
        self._poisoned = False

    def _guarded_allgather(self, local: np.ndarray) -> np.ndarray:
        if self._poisoned:
            raise RuntimeError(
                "WindowedBucketSync is poisoned by an earlier all-gather "
                "timeout — restart the run; its abandoned collective "
                "cannot be safely rejoined")
        mine = torch.from_numpy(local)
        out = [torch.zeros_like(mine) for _ in range(process_count())]
        work = _dist().all_gather(out, mine, group=host_group(),
                                  async_op=True)
        try:
            if self.allgather_timeout:
                work.wait(datetime.timedelta(seconds=self.allgather_timeout))
            else:
                work.wait()
        except RuntimeError as e:
            self._poisoned = True
            raise RuntimeError(
                f"WindowedBucketSync all-gather "
                f"#{self._ingested // self.window} did not complete within "
                f"{self.allgather_timeout:.0f}s on process "
                f"{process_index()} of {process_count()} — another process "
                "likely exhausted its stream before reaching this window "
                "(unequal finite streams). Give processes equal-length "
                "streams (per-process shard ranges do) or cycling "
                f"sources") from e
        return torch.stack(out).numpy()

    def __call__(self, counts: Dict[str, int]) -> None:
        self._ingested += 1
        if process_count() == 1:
            self.min_counts = dict(counts)
            return
        if not self.min_counts:
            self.min_counts = {k: 0 for k in self.keys}
        if self._ingested % self.window != 0:
            return
        local = np.asarray([counts.get(k, 0) for k in self.keys], np.int64)
        mins = self._guarded_allgather(local).reshape(
            -1, len(self.keys)).min(axis=0)
        self.min_counts = {k: int(m) for k, m in zip(self.keys, mins)}

    def on_drain(self, key: str, n: int) -> None:
        """A local drain of ``n`` from ``key`` lowers its minimum."""
        if key in self.min_counts:
            self.min_counts[key] = max(0, self.min_counts[key] - n)
