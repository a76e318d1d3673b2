"""The axes of ``mesh_shape`` over ``torch.distributed``.

Counterpart of ``yat_tpu/parallel/mesh.py``.  One process drives one
card; the processes form a ``dp`` × ``fsdp`` × ``tp`` × ``sp`` grid
(:class:`ProcessMesh`, a four-axis ``DeviceMesh`` in the JAX package's
axis order, so process ``r`` sits where device ``r`` sits in the JAX
mesh):

* the batch shards over ``dp`` × ``fsdp`` only: every process takes
  ``batch_size`` rows at its data rank (:attr:`ProcessMesh.data_rank`),
  so the global batch is ``data_count * batch_size`` rows, and ``tp`` and
  ``sp`` peers see the same rows;
* the trainable leaves (adapters, the REPA head, every parameter under
  full fine-tuning), their optimizer state and the EMA are replicated;
  their gradients are reduced over every process before the clip and the
  update (:class:`GradSync`), so each process applies the global batch's
  update to identical leaves;
* ``tp`` splits the dense layers that the rule below matches, and ``sp``
  the tokens of SANA's and PixArt's blocks (``parallel/tensor.py``);
* the frozen base is sharded over ``fsdp`` (:class:`ShardedBase`): each
  process keeps one slice of every leaf the rule below shards (of its
  ``tp`` slice, where ``tp`` split the leaf), and a module's leaves are
  all-gathered within the ``fsdp`` group when its forward starts and
  dropped when it ends (again in the backward's recomputation under
  remat).  A gathered leaf that autograd saves for the backward lives
  until the backward has used it.

The sharding rules are the JAX package's ``param_sharding_rules``.
:func:`tp_dim`: a 2-D kernel whose module name matches ``_TP_COL`` is
split on its output dimension, one matching ``_TP_ROW`` on its input
dimension, where ``tp`` divides it; modulation layers stay replicated.
:func:`shard_dim`: 1-D leaves and the adaLN modulation layers stay
replicated, every other leaf is sharded over ``fsdp`` on its largest
dimension that ``tp`` left free and ``fsdp`` divides (in the flax layout).
They differ from the JAX rules in one place: the JAX rules look at the
leaf's module name alone, so Flux's ``lin`` under ``img_mod``,
``txt_mod`` and ``mod`` escapes them; here a ``lin`` under a modulation
module is replicated too.

A grid whose size is not the number of processes raises (the JAX
``create_mesh`` takes a subset of the devices; the port refuses).
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from yat_tpu_torch.parallel.multihost import (process_count, process_index,
                                              set_data_axes)

MESH_AXES = ("dp", "fsdp", "tp", "sp")
DATA_AXES = ("dp", "fsdp")

# the JAX package's tp rule (yat_tpu/parallel/mesh.py:_TP_COL, _TP_ROW)
_TP_COL = re.compile(r"(to_q|to_k|to_v|fc1|linear_1|conv_inverted|qkv)$")
_TP_ROW = re.compile(r"(to_out|fc2|linear_2|conv_point|proj_out)$")


def mesh_dims(mesh_shape: Optional[Dict[str, int]],
              world: int) -> Dict[str, int]:
    """``{"dp", "fsdp", "tp", "sp"}`` of ``mesh_shape`` at ``world``
    processes (no mesh: every process on ``dp``).  A grid of another size
    than ``world`` raises."""
    if not mesh_shape:
        return {"dp": world, "fsdp": 1, "tp": 1, "sp": 1}
    shape = {ax: int(mesh_shape.get(ax, 1)) for ax in MESH_AXES}
    need = 1
    for ax in MESH_AXES:
        need *= shape[ax]
    if need != world:
        raise ValueError(
            f"mesh_shape {dict(mesh_shape)} needs {need} devices, one "
            f"process each, and this run has {world} process"
            f"{'es' if world != 1 else ''}: launch {need} with torchrun "
            f"--nproc_per_node {need} or set mesh_shape to {world} "
            "(ROADMAP item 12)")
    return shape


class ProcessMesh:
    """The processes' ``dp`` × ``fsdp`` × ``tp`` × ``sp`` grid: its
    ``DeviceMesh`` (one process group an axis), each axis's size, group
    and this process's coordinate, and the data rank and count (the
    ``dp`` × ``fsdp`` coordinate, by which a process picks its rows)."""

    def __init__(self, dims: Dict[str, int], device_type: str = "cpu"):
        from torch.distributed.device_mesh import init_device_mesh
        self.dims = dict(dims)
        self.device_mesh = init_device_mesh(
            device_type, tuple(dims[ax] for ax in MESH_AXES),
            mesh_dim_names=MESH_AXES)
        r, self.coords = process_index(), {}
        for ax in reversed(MESH_AXES):
            r, self.coords[ax] = divmod(r, dims[ax])
        set_data_axes(self.data_rank, self.data_count)

    def size(self, ax: str) -> int:
        return self.dims[ax]

    def group(self, ax: str):
        return self.device_mesh.get_group(ax)

    def rank(self, ax: str) -> int:
        return self.coords[ax]

    @property
    def data_rank(self) -> int:
        return self.coords["dp"] * self.dims["fsdp"] + self.coords["fsdp"]

    @property
    def data_count(self) -> int:
        return self.dims["dp"] * self.dims["fsdp"]

    def __str__(self) -> str:
        return " x ".join(f"{ax} {self.dims[ax]}" for ax in MESH_AXES)


def create_mesh(mesh_shape: Optional[Dict[str, int]] = None,
                device_type: str = "cpu") -> Optional[ProcessMesh]:
    """The :class:`ProcessMesh` of this run's processes, or None for one
    process (:func:`mesh_dims` checks the shape)."""
    world = process_count()
    dims = mesh_dims(mesh_shape, world)
    if world == 1:
        return None
    return ProcessMesh(dims, device_type)


def is_modulation(names: Sequence[str]) -> bool:
    """Whether the leaf at flax path ``names`` belongs to an adaLN
    modulation layer: its module is ``mod`` or ``*_mod``, or a ``lin``
    under one (Flux)."""
    mods = list(names[:-1])
    module = mods[-1] if mods else ""
    if module == "mod" or module.endswith("_mod"):
        return True
    return module == "lin" and len(mods) >= 2 and (
        mods[-2] == "mod" or mods[-2].endswith("_mod"))


def tp_dim(names: Sequence[str], shape: Sequence[int],
           tp: int) -> Optional[int]:
    """The dimension (flax layout) of the leaf at flax path ``names`` that
    ``tp`` splits: 1 (output) for a 2-D kernel of a column-parallel
    module, 0 (input) for a row-parallel one, where ``tp`` divides it;
    None elsewhere."""
    if tp <= 1 or len(shape) != 2 or is_modulation(names):
        return None
    module = names[-2] if len(names) >= 2 else ""
    if _TP_COL.search(module) and shape[1] % tp == 0:
        return 1
    if _TP_ROW.search(module) and shape[0] % tp == 0:
        return 0
    return None


def shard_dim(names: Sequence[str], shape: Sequence[int],
              fsdp: int, tp: int = 1) -> Optional[int]:
    """The dimension (flax layout) of the leaf at flax path ``names`` that
    ``fsdp`` shards (its largest one that :func:`tp_dim` left free and
    ``fsdp`` divides), or None where it stays replicated."""
    if fsdp <= 1 or len(shape) < 2 or is_modulation(names):
        return None
    taken = tp_dim(names, shape, tp)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != taken and shape[i] % fsdp == 0:
            return i
    return None


def frozen_bytes(model: nn.Module) -> int:
    """The bytes of ``model``'s frozen leaves that this process holds
    (parameters that take no gradient and a quantized base's
    ``qweight``)."""
    n = sum(p.numel() * p.element_size() for p in model.parameters()
            if not p.requires_grad)
    return n + sum(b.numel() * b.element_size()
                   for name, b in model.named_buffers()
                   if name.endswith("qweight"))


class GradSync:
    """Reduces tensors over the processes of ``group`` (None: the default
    group), one all-reduce per dtype; each call's milliseconds (the device
    synchronised around it on a card) are kept in ``ms``.

    :meth:`mean_` averages values every ``tp``/``sp`` peer holds whole.
    :meth:`reduce_grads_` turns each process's gradients into the global
    batch's: a leaf in ``tp_partial`` holds a part on each ``tp`` peer
    (summed), any other the whole (averaged); under ``sp`` each peer holds
    its tokens' part (summed) when the forward of ``sequence`` (the
    model's ``tensor.SequenceParallel``) sliced them, else the whole
    (averaged), and a leaf in ``sp_whole`` (used only on tokens gathered
    whole) always the whole; then the mean over the ``dp`` × ``fsdp``
    rows."""

    def __init__(self, group=None, mesh: Optional[ProcessMesh] = None,
                 tp_partial: Optional[Sequence[bool]] = None,
                 sequence=None, sp_whole: Optional[Sequence[bool]] = None):
        import torch.distributed as dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.tp = mesh.size("tp") if mesh is not None else 1
        self.sp = mesh.size("sp") if mesh is not None else 1
        self.tp_partial = list(tp_partial) if tp_partial is not None else None
        self.sequence = sequence
        self.sp_whole = list(sp_whole) if sp_whole is not None else None
        self.ms: List[float] = []

    @torch.no_grad()
    def mean_(self, tensors: Sequence[torch.Tensor],
              scales: Optional[Sequence[float]] = None) -> None:
        """Each tensor replaced, in place, by its mean over the processes
        (each first multiplied by its entry of ``scales``, when given)."""
        import torch.distributed as dist
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        tensors = list(tensors)
        cuda = any(t.is_cuda for t in tensors)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if scales is not None:
            for t, s in zip(tensors, scales):
                if s != 1.0:
                    t.mul_(s)
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = _flatten_dense_tensors(group)
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            for t, r in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(r)
        if cuda:
            torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)

    def reduce_grads_(self, grads: Sequence[torch.Tensor],
                      loss: torch.Tensor) -> None:
        """``grads`` and ``loss`` (a whole value on every ``tp``/``sp``
        peer) reduced in place to the global batch's."""
        sharded = self.sequence is not None and self.sequence.sharded
        split = self.tp * self.sp
        partial = self.tp_partial or [False] * len(grads)
        whole = self.sp_whole or [False] * len(grads)
        scales = [split / ((1 if p else self.tp)
                           * (1 if sharded and not w else self.sp))
                  for p, w in zip(partial, whole)]
        self.mean_(list(grads) + [loss], scales + [1.0])


def _flax_layout(module: nn.Module, name: str, t: torch.Tensor):
    """(flax leaf name, the torch dimension of each flax dimension) of the
    leaf ``name`` of ``module`` (as ``convert.load_flax_params`` maps
    them)."""
    from yat_tpu_torch.models.layers import Embed
    if name == "qweight":
        return "kernel", (1, 0)
    if name == "weight" and not isinstance(module, (Embed, nn.Embedding)):
        if t.ndim == 2:
            return "kernel", (1, 0)
        if t.ndim == 4:
            return "kernel", (2, 3, 1, 0)
    if name == "weight" and isinstance(module, (Embed, nn.Embedding)):
        return "embedding", tuple(range(t.ndim))
    return name, tuple(range(t.ndim))


class ShardedBase:
    """The frozen leaves of ``model`` sharded over the processes of
    ``group`` (the ``fsdp`` axis).  Frozen means a parameter that takes no
    gradient, or a quantized base's ``qweight``; :func:`shard_dim` picks
    which and where.  Each process keeps the slice at its rank in the
    group; forward hooks on the owning module gather the whole leaf while
    that module runs."""

    def __init__(self, model: nn.Module, group, fsdp: int):
        import torch.distributed as dist
        from yat_tpu_torch.convert import flax_module_path
        self.group, self.size = group, fsdp
        self.rank = dist.get_rank(group)
        # owner module → [(leaf name, torch dim, is a parameter)]
        self.owned: Dict[nn.Module, List] = {}
        self._depth: Dict[nn.Module, int] = {}
        # owner module → its shards while the whole leaves stand in
        self._held: Dict[nn.Module, List[torch.Tensor]] = {}
        lists = {n for n, m in model.named_modules()
                 if isinstance(m, nn.ModuleList)}
        for mname, m in model.named_modules():
            leaves = [(n, p, True) for n, p in m._parameters.items()
                      if p is not None and not p.requires_grad]
            q = m._buffers.get("qweight")
            if q is not None:
                leaves.append(("qweight", q, False))
            for n, t, is_param in leaves:
                leaf, dims = _flax_layout(m, n, t)
                names = flax_module_path(mname, lists) + [leaf]
                shape = [t.shape[d] for d in dims]
                tp = getattr(m, "tp", None)
                if tp is not None and leaf == "kernel":
                    # the tp rule on the whole leaf: the split dimension
                    # holds this process's part
                    shape[1 if tp.role == "col" else 0] = tp.full
                fd = shard_dim(names, shape, fsdp,
                               tp.size if tp is not None else 1)
                if fd is None:
                    continue
                td = dims[fd]
                self.owned.setdefault(m, []).append((n, td, is_param))
                part = t.detach().chunk(fsdp, td)[self.rank].contiguous()
                if is_param:
                    t.data = part
                else:
                    m._buffers[n] = part
        for m in self.owned:
            m.register_forward_pre_hook(self._pre)
            m.register_forward_hook(self._post)

    def _gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist
        out = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(out, part, group=self.group)
        return torch.cat(out, dim)

    def _swap_in(self, m: nn.Module) -> None:
        held = []
        for n, td, is_param in self.owned[m]:
            part = m._parameters[n] if is_param else m._buffers[n]
            full = self._gather(part.detach(), td)
            if is_param:
                m._parameters[n] = nn.Parameter(full, requires_grad=False)
            else:
                m._buffers[n] = full
            held.append(part)
        self._held[m] = held

    def _swap_out(self, m: nn.Module, write_back: bool = False) -> None:
        for (n, td, is_param), part in zip(self.owned[m], self._held.pop(m)):
            if write_back:
                full = m._parameters[n] if is_param else m._buffers[n]
                with torch.no_grad():
                    part.copy_(full.detach().chunk(self.size, td)[self.rank])
            if is_param:
                m._parameters[n] = part
            else:
                m._buffers[n] = part

    def _pre(self, m: nn.Module, args) -> None:
        depth = self._depth.get(m, 0)
        if depth == 0:
            self._swap_in(m)
        self._depth[m] = depth + 1

    def _post(self, m: nn.Module, args, out) -> None:
        self._depth[m] -= 1
        if self._depth[m] == 0:
            self._swap_out(m)

    @contextlib.contextmanager
    def gathered(self, write_back: bool = False):
        """Every sharded leaf whole for the duration (collective: every
        process enters); ``write_back`` copies each process's slice of the
        whole leaves back into its shards at the exit (a restore)."""
        mods = [m for m in self.owned if self._depth.get(m, 0) == 0]
        for m in mods:
            self._swap_in(m)
            self._depth[m] = 1
        try:
            yield
        finally:
            for m in mods:
                self._depth[m] = 0
                self._swap_out(m, write_back)


def shard_frozen_base(model: nn.Module, mesh) -> Optional[ShardedBase]:
    """:class:`ShardedBase` of ``model`` over ``mesh``'s ``fsdp`` axis, or
    None when that axis has one process."""
    if mesh is None or mesh.size("fsdp") <= 1:
        return None
    return ShardedBase(model, mesh.group("fsdp"), mesh.size("fsdp"))

