"""Context-parallel attention: the keys and values sharded over a process
group.

Counterpart of ``yat_tpu/ops/context_parallel.py``.  Two forms, each over
the processes of a ``torch.distributed`` group instead of a mesh axis:

* :func:`context_parallel_attention`: each process attends its queries
  (the same on every process, or its batch rows) to its local key shard;
  the partial outputs merge with the online-softmax correction across the
  group (one max and two sums): only ``D + 2`` values a query travel,
  never the keys.  The output is the same on every process, and its
  gradient is that of one loss on it (the queries' gradient summed over
  the group).
* :func:`ring_attention`: each process merges every process's key and
  value block into its queries' online softmax, in the ring's order (its
  own block, then the previous process's, and so on round the group).
  Each process's queries are its own (a sequence shard, or the same on
  every process); the gradient is that of the sum of the processes'
  losses.  Its backward (:class:`_RingAttention`) visits the blocks again
  from the saved log-sum-exp and sends each block's key and value
  gradients home with one ``reduce_scatter``.

The blocks travel by one ``all_gather`` of K/V up front, not by a
send/receive each turn: gloo's ``isend``/``irecv`` do not take CUDA
tensors (on an H100 two processes sharing the card over gloo failed with
"Bad address", and gloo has no ``all_to_all``), and the port runs gloo
wherever processes share a card.  So the ring keeps its merge order but
not its memory advantage: every process holds all of K/V for the call.

The local step is plain arithmetic (as the JAX file's is: it runs outside
any Pallas kernel), fp32 scores and statistics.  Both are exercised
against the JAX functions under ``jax.shard_map`` in
``tests/test_torch_port_context_parallel.py``; no model calls them.
"""

from __future__ import annotations

from typing import Optional

import torch

from yat_tpu_torch.parallel.tensor import (_all_gather, _reduce_scatter,
                                           copy_to_group, reduce_from_group)


def _dist():
    import torch.distributed as dist
    return dist


def _partial_attention(q, k, v, scale):
    """Local attention with its softmax statistics: q ``[B, Nq, H, D]``,
    k/v ``[B, Nk, H, D]`` → (unnormalised o ``[B, Nq, H, D]`` fp32, m and
    l ``[B, H, Nq]``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o.float(), m, l


def context_parallel_attention(q: torch.Tensor, k_shard: torch.Tensor,
                               v_shard: torch.Tensor, group,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The all-reduce form over ``group``: the same queries on every
    process, the keys and values sharded along the sequence."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q = copy_to_group(q, group)
    o, m, l = _partial_attention(q, k_shard, v_shard, scale)
    # the merge's shift cancels in the quotient: no gradient through it
    with torch.no_grad():
        m_global = _all_gather(m[None], 0, group).amax(0)
    alpha = torch.exp(m - m_global)
    l_global = reduce_from_group(alpha * l, group)
    o_global = reduce_from_group(o * alpha.transpose(1, 2)[..., None], group)
    out = o_global / torch.clamp(l_global.transpose(1, 2)[..., None],
                                 min=1e-20)
    return out.to(q.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        dist = _dist()
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        # block j of every process, visited from this one's own backwards
        order = [(rank - step) % size for step in range(size)]
        ks = _all_gather(k[None], 0, group)
        vs = _all_gather(v[None], 0, group)
        b, nq, h, _ = q.shape
        m = torch.full((b, h, nq), float("-inf"), device=q.device)
        l = torch.zeros((b, h, nq), device=q.device)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for j in order:
            o_new, m_new, l_new = _partial_attention(q, ks[j], vs[j], scale)
            m_next = torch.maximum(m, m_new)
            alpha, beta = torch.exp(m - m_next), torch.exp(m_new - m_next)
            l = alpha * l + beta * l_new
            o = (o * alpha.transpose(1, 2)[..., None]
                 + o_new * beta.transpose(1, 2)[..., None])
            m = m_next
        out = (o / torch.clamp(l.transpose(1, 2)[..., None], min=1e-20))
        ctx.group, ctx.scale, ctx.order = group, scale, order
        ctx.save_for_backward(q, ks, vs, out, m + torch.log(l))
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, ks, vs, out, lse = ctx.saved_tensors
        scale = ctx.scale
        g = g.float()
        qf = q.float()
        # rowsum(dO * O) [B, H, Nq]
        di = (g * out).sum(-1).transpose(1, 2)
        dq = torch.zeros_like(qf)
        # this process's part of every block's gradient
        dks = torch.zeros(ks.shape, dtype=torch.float32, device=q.device)
        dvs = torch.zeros_like(dks)
        for j in ctx.order:
            kb, vb = ks[j], vs[j]
            logits = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
            p = torch.exp(logits - lse[..., None])
            dvs[j] = torch.einsum("bhqk,bqhd->bkhd", p, g)
            dp = torch.einsum("bqhd,bkhd->bhqk", g, vb.float())
            ds = p * (dp - di[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scale
            dks[j] = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
        # each block's gradient summed over the processes, at its owner
        dk = _reduce_scatter(dks, 0, ctx.group)[0]
        dv = _reduce_scatter(dvs, 0, ctx.group)[0]
        return (dq.to(q.dtype), dk.to(ks.dtype), dv.to(vs.dtype), None,
                None)


def ring_attention(q: torch.Tensor, k_local: torch.Tensor,
                   v_local: torch.Tensor, group,
                   scale: Optional[float] = None) -> torch.Tensor:
    """The ring form over ``group``: this process's queries against every
    process's key and value block, the blocks rotating around it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k_local, v_local, group, scale)
