"""Tensor and sequence parallelism: the ``tp`` and ``sp`` axes of
``mesh_shape``.

Counterpart of what GSPMD derives for the JAX package from
``yat_tpu/parallel/mesh.py``'s annotations: there the ``tp`` rule places
parameters (``param_sharding_rules``) and ``constrain_tokens`` shards the
token dimension, and XLA inserts the collectives.  Here the collectives
are explicit, as autograd functions whose backward is the collective that
the forward's use requires:

* :func:`copy_to_group` (identity; its gradient summed over the group):
  the input of a column-parallel layer, whose peers each see the whole
  input and return a part of its gradient;
* :func:`reduce_from_group` (a sum; its gradient passed through): the
  output of a row-parallel layer, whose peers each hold a partial product
  and then go on with the same replicated work;
* :func:`all_reduce_sum` (a sum both ways): a partial state that every
  peer goes on using with partial work after it (ReLU linear attention's
  state under ``sp``, DoRA's and ``rms_norm_across_heads``' sums of
  squares under ``tp``);
* :func:`gather_along` (an all-gather; its gradient sliced, or
  reduce-scattered with ``reduce_grad``): a lone column-parallel output
  and the tokens at ``unpatchify`` feed replicated work, so each peer's
  gradient is already the whole one; the K/V of softmax attention under
  ``sp`` feed each peer's own queries, so their gradients are summed.

Only ``all_reduce``, ``all_gather`` and ``reduce_scatter`` are used: gloo
takes them on CUDA tensors (on an H100 two processes sharing the card
ran each; ``all_to_all`` is not in gloo and ``isend``/``irecv`` failed),
so the same code runs on gloo (the CPU, and processes sharing a card) and
on NCCL.

**Tensor parallelism** (:class:`TensorParallel`).  Every
:class:`~yat_tpu_torch.models.layers.AdapterDense` that the JAX ``tp`` rule
matches (``mesh.tp_dim``) becomes column-parallel (its output features
split over the ``tp`` group) or row-parallel (its input features split).
A lone layer computes the whole function: a column-parallel output is
gathered, a row-parallel input is sliced.  A pair (attention's q/k/v and
out, an MLP's two layers, GLUMBConv's expand and project, the caption and
timestep projections) keeps its activations split between the two, so
attention runs on this process's heads.  The frozen base keeps only this
process's slice (a quantized payload with its per-output-channel scales);
trainable leaves (adapters, every parameter under full fine-tuning) stay
whole and are sliced at use.

**Gradients** (``mesh.GradSync``).  A leaf used inside a ``tp``-split
product gets a part of its gradient on each ``tp`` peer, summed over
``tp``; a leaf used in replicated work gets the whole gradient on each
peer, averaged.  :meth:`TensorParallel.partial_leaves` names the first
kind.  Under ``sp`` a leaf's gradient is a part (each peer's tokens),
summed over ``sp``, when the forward sliced the tokens
(:attr:`SequenceParallel.sharded`), except for a leaf used only on tokens
gathered whole (a REPA head or projector:
:meth:`SequenceParallel.whole_leaves`), whose gradient each peer holds
whole, averaged.

**Sequence parallelism** (:class:`SequenceParallel`): SANA and PixArt
slice their ``[B, N, D]`` tokens after the patch embedding when ``N``
divides by ``sp`` (contiguous slices of the flattened grid, as GSPMD
shards them, so a boundary may fall mid-row) and gather them before
``unpatchify``.  In between, ReLU linear attention sums its state over
``sp`` (``ops.attention.linear_attention_sharded``), softmax
self-attention gathers K/V, and SANA's depthwise conv takes ``w + 1``
flattened tokens from each neighbour (:meth:`SequenceParallel.halo`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
from torch import nn


def _dist():
    import torch.distributed as dist
    return dist


# ---------------------------------------------------------------------------
# collectives under autograd
# ---------------------------------------------------------------------------

# the tp/sp collectives of the forwards and backwards since the last
# reset: calls, bytes sent, seconds on the host's clock around them
COLLECTIVES: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _count(x: torch.Tensor, t0: float) -> None:
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += x.numel() * x.element_size()
    COLLECTIVES["seconds"] += time.perf_counter() - t0


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    t0 = time.perf_counter()
    out = x.contiguous().clone()
    _dist().all_reduce(out, group=group)
    _count(out, t0)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    t0 = time.perf_counter()
    dist = _dist()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _count(x, t0)
    return torch.cat(parts, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This peer's part along ``dim`` of the sum over ``group`` of the
    peers' ``x``."""
    t0 = time.perf_counter()
    dist = _dist()
    parts = [p.contiguous() for p in x.chunk(dist.get_world_size(group), dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    _count(x, t0)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        dist = _dist()
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return g.chunk(ctx.size, ctx.dim)[ctx.rank].contiguous(), None, \
            None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (whole on every peer) into a split product: the identity,
    its gradient summed over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the peers' partial ``x``, going on in
    replicated work: its gradient passes through."""
    return _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the peers' partial ``x``, going on in
    split work: its gradient is summed over ``group`` too."""
    return _AllReduceSum.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group,
                 reduce_grad: bool = False) -> torch.Tensor:
    """The peers' ``x`` concatenated along ``dim`` in rank order.  The
    backward takes this peer's slice of the gradient; ``reduce_grad``
    sums the gradient over ``group`` first (the gathered tensor feeds
    split work)."""
    return _GatherAlong.apply(x, dim, group, reduce_grad)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

class TPShard:
    """The ``tp`` split of one dense layer: ``role`` ``"col"`` (output
    features) or ``"row"`` (input features), this peer's feature indices
    ``idx`` of the ``full`` ones, and whether the layer is ``lone`` (its
    output gathered, or its input sliced, so that it computes the whole
    function)."""

    def __init__(self, group, size: int, rank: int, role: str, full: int,
                 idx: Optional[torch.Tensor] = None, lone: bool = True):
        self.group, self.size, self.rank = group, size, rank
        self.role, self.full, self.lone = role, full, lone
        self.idx = (idx if idx is not None
                    else contiguous_chunk(full, size, rank))
        # every peer's indices, for the gathers of whole()
        self.order: Optional[torch.Tensor] = None
        # the layer's leaves held as this peer's slice (the frozen base)
        self.sliced: set = set()

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t``'s slice (``full`` long along ``dim``) at this peer's
        indices."""
        return t.index_select(dim, self.idx.to(t.device))


def contiguous_chunk(full: int, size: int, rank: int) -> torch.Tensor:
    """The indices of part ``rank`` of ``size`` equal parts of ``full``."""
    part = full // size
    return torch.arange(rank * part, (rank + 1) * part)


def pair(col, row, idx: torch.Tensor, row_idx: Optional[torch.Tensor] = None
         ) -> bool:
    """Make ``col`` (column-parallel) and ``row`` (row-parallel) a pair
    at ``idx`` (``row_idx`` for the row layer, default the same): the
    activation between them stays split.  False, changing nothing, where
    the two are not both split that way."""
    a, b = getattr(col, "tp", None), getattr(row, "tp", None)
    if a is None or b is None or a.role != "col" or b.role != "row":
        return False
    a.idx, a.lone = idx, False
    b.idx, b.lone = (idx if row_idx is None else row_idx), False
    return True


class TensorParallel:
    """The ``tp`` split of ``model`` over the processes of ``group``: the
    rule's layers split, the pairs formed (each module class's
    ``tensor_parallel(size, rank)``), the frozen base sliced.
    :meth:`gathered` makes every sliced leaf whole for a while (the
    checkpoint and the export)."""

    def __init__(self, model: nn.Module, group):
        from yat_tpu_torch.convert import flax_module_path
        from yat_tpu_torch.models.layers import AdapterDense
        from yat_tpu_torch.parallel.mesh import tp_dim
        dist = _dist()
        self.group = group
        self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        lists = {n for n, m in model.named_modules()
                 if isinstance(m, nn.ModuleList)}
        self.dense: List[AdapterDense] = []
        for mname, m in model.named_modules():
            if not isinstance(m, AdapterDense):
                continue
            names = flax_module_path(mname, lists) + ["kernel"]
            d = tp_dim(names, (m.in_features, m.features), self.size)
            if d is None:
                continue
            role = "col" if d == 1 else "row"
            full = m.features if role == "col" else m.in_features
            m.tp = TPShard(group, self.size, self.rank, role, full)
            self.dense.append(m)
        for m in model.modules():
            hook = getattr(m, "tensor_parallel", None)
            if callable(hook) and not isinstance(m, AdapterDense):
                hook(self.size, self.rank)
        for m in self.dense:
            order = [torch.empty_like(m.tp.idx) for _ in range(self.size)]
            dist.all_gather(order, m.tp.idx, group=group)
            m.tp.order = torch.argsort(torch.cat(order))
            m.shard_tp_base()

    def partial_leaves(self, model: nn.Module) -> set:
        """The ids of the parameters of ``model`` used inside a split
        product: their gradients are parts, summed over ``tp``."""
        from yat_tpu_torch.models.layers import AdapterDense
        out = set()
        for m in model.modules():
            if isinstance(m, AdapterDense) and m.tp is not None:
                for n, p in m.named_parameters(recurse=False):
                    if not (n == "bias" and m.tp.role == "row"):
                        out.add(id(p))
            elif getattr(m, "tp_local", None) is not None:
                out.update(id(p) for p in m.parameters(recurse=False))
        return out

    @contextlib.contextmanager
    def gathered(self, write_back: bool = False):
        """Every sliced frozen leaf whole for the duration (collective);
        ``write_back`` copies this peer's slice of the whole leaves back
        at the exit (a restore)."""
        held = []
        for m in self.dense:
            for name, dim in m.tp_sliced_leaves():
                part = getattr(m, name)
                full = _all_gather(part.detach(), dim, self.group)
                full = full.index_select(dim, m.tp.order.to(full.device))
                held.append((m, name, dim, part, full))
                _set_leaf(m, name, full)
        try:
            yield
        finally:
            for m, name, dim, part, full in held:
                if write_back:
                    with torch.no_grad():
                        part.copy_(m.tp.take(getattr(m, name).detach(), dim))
                _set_leaf(m, name, part)


def _set_leaf(m: nn.Module, name: str, t: torch.Tensor) -> None:
    if name in m._parameters:
        m._parameters[name] = (t if isinstance(t, nn.Parameter)
                               else nn.Parameter(t, requires_grad=False))
    else:
        m._buffers[name] = t


def tensor_parallel(model: nn.Module, mesh) -> Optional[TensorParallel]:
    """:class:`TensorParallel` of ``model`` over ``mesh``'s ``tp`` axis,
    or None when that axis has one process."""
    if mesh is None or mesh.size("tp") <= 1:
        return None
    return TensorParallel(model, mesh.group("tp"))


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

class SequenceParallel:
    """The ``sp`` group of a model's token-sharded blocks: ``size``
    processes, this one's ``rank``; ``sharded`` says whether the model's
    last forward sliced its tokens (read by ``mesh.GradSync`` and REPA's
    ``capture_features``)."""

    def __init__(self, group):
        dist = _dist()
        self.group = group
        self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.sharded = False

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This process's contiguous slice of the tokens (dim 1) of ``x``,
        or ``x`` itself where ``N`` does not divide by ``sp`` (the JAX
        ``constrain_tokens`` leaves it unsharded there)."""
        n = x.shape[1]
        self.sharded = n % self.size == 0
        if not self.sharded:
            return x
        part = n // self.size
        return x[:, self.rank * part:(self.rank + 1) * part]

    def gather(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The whole ``n`` tokens from the slices (``x`` itself when it
        holds them all already); the gradient takes this slice."""
        if x.shape[1] == n:
            return x
        return gather_along(x, 1, self.group)

    @staticmethod
    def whole_leaves(*modules: Optional[nn.Module]) -> set:
        """The ids of the parameters of ``modules`` (None skipped), which
        run only on tokens gathered whole (SANA's REPA head, PixArt's REPA
        projector): every peer holds their whole gradient, so it is
        averaged over ``sp``, not summed."""
        return {id(p) for m in modules if m is not None
                for p in m.parameters()}

    def gather_kv(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's keys or values for this process's queries; the
        gradient is reduce-scattered back."""
        return gather_along(x, 1, self.group, reduce_grad=True)

    def bounds(self, n_local: int):
        """(first, end) of this process's tokens."""
        return self.rank * n_local, (self.rank + 1) * n_local

    def halo(self, x: torch.Tensor, hw, reach: int) -> torch.Tensor:
        """The flattened tokens ``[first - reach, end + reach)`` of the
        grid ``hw`` around this process's slice ``x`` ``[B, n, C]``, zeros
        outside the grid: the first and last ``min(reach, n)`` tokens of
        every process gathered (their gradients summed back to their
        owners)."""
        b, n, c = x.shape
        e = min(reach, n)
        edges = torch.cat([x[:, :e], x[:, n - e:]], 1)
        every = gather_along(edges.unsqueeze(0), 0, self.group,
                             reduce_grad=True)          # [P, B, 2e, C]
        first, end = self.bounds(n)
        total = hw[0] * hw[1]
        # a source table: 0 a zero token, 1..n this slice, then the edges
        src = torch.cat([x.new_zeros(b, 1, c), x,
                         every.permute(1, 0, 2, 3).reshape(b, -1, c)], 1)
        t = torch.arange(first - reach, end + reach, device=x.device)
        p, off = t.div(n, rounding_mode="floor"), t.remainder(n)
        slot = torch.where(off < e, off, e + off - (n - e))
        index = torch.where((t >= first) & (t < end), 1 + t - first,
                            1 + n + p * 2 * e + slot)
        index = torch.where((t < 0) | (t >= total), 0, index)
        return src.index_select(1, index)


def depthwise_conv3x3_sharded(x: torch.Tensor, weight: torch.Tensor,
                              bias: Optional[torch.Tensor], hw,
                              sp: SequenceParallel) -> torch.Tensor:
    """A 3x3 depthwise 'SAME' convolution of the grid ``hw`` on this
    process's flattened slice of its tokens ``x`` ``[B, n, C]`` (weight
    ``[C, 1, 3, 3]``), the neighbours' ``w + 1`` tokens on each side
    from :meth:`SequenceParallel.halo`; fp32 sums, the output in ``x``'s
    dtype."""
    b, n, c = x.shape
    h, w = hw
    strip = sp.halo(x, hw, w + 1).float()               # [B, n + 2w + 2, C]
    first, _ = sp.bounds(n)
    col = (torch.arange(first, first + n, device=x.device) % w)[None, :, None]
    wt = weight.float().reshape(c, 3, 3)
    out = torch.zeros((b, n, c), dtype=torch.float32, device=x.device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            start = w + 1 + dr * w + dc
            tap = strip[:, start:start + n]
            ok = ((col + dc >= 0) & (col + dc < w)).to(tap.dtype)
            out = out + tap * ok * wt[:, dr + 1, dc + 1]
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def sequence_parallel(model: nn.Module, mesh) -> Optional[SequenceParallel]:
    """Give ``model`` (SANA, PixArt: a ``sequence_parallel`` attribute)
    the ``sp`` group of ``mesh``; None when that axis has one process.
    Another family keeps its tokens whole (every ``sp`` peer computes the
    same, as in the JAX package, which has no call site there)."""
    if mesh is None or mesh.size("sp") <= 1:
        return None
    sp = SequenceParallel(mesh.group("sp"))
    if hasattr(model, "sequence_parallel"):
        model.sequence_parallel = sp
    return sp


def parallelize(model: nn.Module, mesh, leaves, whole_modules=()):
    """``model`` split over ``mesh`` as the trainer splits it: the ``tp``
    layers (:func:`tensor_parallel`), the ``sp`` group
    (:func:`sequence_parallel`), the frozen base's ``fsdp`` shards
    (``mesh.shard_frozen_base``, after the ``tp`` slices), and the
    ``mesh.GradSync`` of its trainable ``leaves``; ``whole_modules`` (None
    entries skipped) run only on tokens gathered whole.  Returns
    (TensorParallel or None, SequenceParallel or None, ShardedBase or
    None, GradSync)."""
    from yat_tpu_torch.parallel.mesh import GradSync, shard_frozen_base
    tensor = tensor_parallel(model, mesh)
    sequence = sequence_parallel(model, mesh)
    partial = tensor.partial_leaves(model) if tensor is not None else set()
    whole = (sequence.whole_leaves(*whole_modules) if sequence is not None
             else set())
    sync = GradSync(mesh=mesh, tp_partial=[id(p) in partial for p in leaves],
                    sequence=sequence,
                    sp_whole=[id(p) in whole for p in leaves])
    return tensor, sequence, shard_frozen_base(model, mesh), sync
