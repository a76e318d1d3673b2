"""The data axes of ``mesh_shape`` over ``torch.distributed``.

Counterpart of ``yat_tpu/parallel/mesh.py`` for the data axes.  One
process drives one card; the processes form a ``dp`` × ``fsdp`` grid
(:func:`create_mesh`, a ``DeviceMesh``):

* every process takes ``batch_size`` rows of its own, so the global batch
  is ``process_count() * batch_size`` rows, sharded over both axes as
  ``batch_sharding`` shards it in the JAX package;
* the trainable leaves (adapters, the REPA head, every parameter under
  full fine-tuning), their optimizer state and the EMA are replicated;
  their gradients are averaged over every process before the clip and
  the update (:class:`GradSync`), so each process applies the global
  batch's update to identical leaves;
* the frozen base is sharded over ``fsdp`` (:class:`ShardedBase`): each
  process keeps one slice of every leaf the rule below shards, and a
  module's leaves are all-gathered when its forward starts and dropped
  when it ends (again in the backward's recomputation under remat).  A
  gathered leaf that autograd saves for the backward lives until the
  backward has used it.

The sharding rule (:func:`shard_dim`) is the JAX package's
``param_sharding_rules`` for the ``fsdp`` axis: 1-D leaves and the adaLN
modulation layers stay replicated, every other leaf is sharded on its
largest dimension that ``fsdp`` divides (in the flax layout).  It differs
from the JAX rule in one place: the JAX rule looks at the leaf's module
name alone, so Flux's ``lin`` under ``img_mod``, ``txt_mod`` and ``mod``
escapes it; here a ``lin`` under a modulation module is replicated too.

``tp`` and ``sp`` (tensor and sequence parallelism) are ROADMAP item 12b:
a mesh that asks for them raises, and so does a grid whose size is not
the number of processes (the JAX ``create_mesh`` takes a subset of the
devices; the port refuses).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from yat_tpu_torch.parallel.multihost import process_count

MESH_AXES = ("dp", "fsdp", "tp", "sp")
DATA_AXES = ("dp", "fsdp")


def mesh_dims(mesh_shape: Optional[Dict[str, int]],
              world: int) -> Dict[str, int]:
    """``{"dp": a, "fsdp": b}`` of ``mesh_shape`` at ``world`` processes
    (no mesh: every process on ``dp``).  ``tp`` or ``sp`` above 1, or a
    grid of another size than ``world``, raises."""
    if not mesh_shape:
        return {"dp": world, "fsdp": 1}
    shape = {ax: int(mesh_shape.get(ax, 1)) for ax in MESH_AXES}
    for ax in ("tp", "sp"):
        if shape[ax] > 1:
            raise ValueError(
                f"mesh_shape {dict(mesh_shape)}: the {ax!r} axis (tensor "
                "and sequence parallelism) is not ported to PyTorch yet "
                "(ROADMAP item 12b); use dp and fsdp")
    need = shape["dp"] * shape["fsdp"]
    if need != world:
        raise ValueError(
            f"mesh_shape {dict(mesh_shape)} needs {need} devices, one "
            f"process each, and this run has {world} process"
            f"{'es' if world != 1 else ''}: launch {need} with torchrun "
            f"--nproc_per_node {need} or set mesh_shape to {world} "
            "(ROADMAP item 12)")
    return {"dp": shape["dp"], "fsdp": shape["fsdp"]}


def create_mesh(mesh_shape: Optional[Dict[str, int]] = None,
                device_type: str = "cpu"):
    """The ``DeviceMesh`` over ``("dp", "fsdp")`` of this run's processes,
    or None for one process (:func:`mesh_dims` checks the shape)."""
    world = process_count()
    dims = mesh_dims(mesh_shape, world)
    if world == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dims["dp"], dims["fsdp"]),
                            mesh_dim_names=DATA_AXES)


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


def shard_dim(names: Sequence[str], shape: Sequence[int],
              fsdp: int) -> Optional[int]:
    """The dimension (flax layout) of the leaf at flax path ``names`` that
    ``fsdp`` shards, or None where it stays replicated."""
    if fsdp <= 1 or len(shape) < 2 or is_modulation(names):
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % fsdp == 0:
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
    """Averages tensors over the processes of ``group`` (None: the
    default group), one all-reduce per dtype; each call's milliseconds
    (the device synchronised around it on a card) are kept in ``ms``."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.ms: List[float] = []

    @torch.no_grad()
    def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor replaced, in place, by its mean over the
        processes."""
        import torch.distributed as dist
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        tensors = list(tensors)
        cuda = any(t.is_cuda for t in tensors)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
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
                fd = shard_dim(names, [t.shape[d] for d in dims], fsdp)
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
    if mesh is None or mesh["fsdp"].size() <= 1:
        return None
    return ShardedBase(model, mesh.get_group("fsdp"), mesh["fsdp"].size())

