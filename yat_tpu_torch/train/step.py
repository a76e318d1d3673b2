"""The training step.

Counterpart of ``yat_tpu/train/step.py:make_train_step``: unconditional-
caption dropout (a whole-batch swap with the empty caption), exploration
steps (best-of-N draws), the task loss plus ``preservation_ratio`` times
the preservation term, ``loss_scale``, the gradients with respect to the
trainable leaves only, the optimizer update, and EMA advanced on the steps
where the accumulation synced.  Metrics are ``loss`` and ``grad_norm``, the
global norm of the unclipped micro-step gradients of every trainable leaf
(frozen ones under ``unfreeze_modules`` included), as device tensors.

Exploration (``exploration_steps`` N, after the caption dropout): N
deterministic no-grad task losses, one per candidate set of timesteps,
sigmas and noise; the gradient pass takes the candidate with the lowest
loss (the first one on ties, as ``jnp.argmin``).  The choice stays on the
device: the candidates' draws are stacked and indexed by the argmin.  A
step with N candidates and the preservation term runs 1 + N + 2 forwards
(N no-grad, the base's no-grad) and 2 backwards.

Across processes (``grad_sync``, a ``parallel.mesh.GradSync``), each
process takes its own rows (``tp`` and ``sp`` peers the same ones): the
gradients and the loss are reduced over the processes before the norm,
the clip and the update (a leaf's parts summed over ``tp`` and ``sp``,
its whole copies averaged, then the mean over the rows' processes), so
``loss`` and ``grad_norm`` are the global batch's, as in the JAX step over a sharded
batch (under accumulation, each micro-step's).  The draws made once per
step agree on every process: the caption dropout's ``use`` comes from
``shared_gen`` (seeded alike everywhere), and exploration takes the
argmin of the candidates' losses averaged over the processes; the
per-sample draws (timesteps, noise, LoRA dropout) come from each
process's own ``gen``.

``draws`` (optional) fixes the step's random choices: ``uncond`` (bool),
``timesteps``, ``sigmas`` and ``noise`` for the loss, ``preservation``
(the same keys) for the preservation term, and ``candidates`` (a list of N
such dicts, each optionally with its own ``preservation``) for
exploration, whose chosen entry replaces the loss's draws.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from yat_tpu_torch.train.state import Optimizer, ema_update, global_norm


def apply_uncond_dropout(batch: Dict[str, torch.Tensor], use_uncond
                         ) -> Dict[str, torch.Tensor]:
    """Swap the whole batch's captions (and mask) for the empty caption
    where ``use_uncond`` (a bool tensor or a bool) holds."""
    emb = batch["embeddings"]
    empty = batch["empty_embeddings"].to(emb.dtype).expand(emb.shape)
    use = torch.as_tensor(use_uncond, device=emb.device)
    new = dict(batch)
    new["embeddings"] = torch.where(use, empty, emb)
    if "text_mask" in batch and "empty_text_mask" in batch:
        m = batch["text_mask"]
        em = batch["empty_text_mask"].to(m.dtype).expand(m.shape)
        new["text_mask"] = torch.where(use, em, m)
    return new


def loss_and_grads(task_loss, leaves: List[torch.Tensor],
                   batch: Dict[str, torch.Tensor], gen: torch.Generator,
                   draws: Optional[Dict] = None,
                   preservation: Optional[Tuple] = None):
    """The scaled training loss and its gradients with respect to
    ``leaves`` (forward with LoRA dropout active, as in training).
    ``preservation`` = ``(ratio, pres_loss, base)`` adds ``ratio`` times
    the preservation term on its own draws (``draws["preservation"]``).
    A leaf cut off from the loss raises."""
    draws = draws or {}
    loss = task_loss(batch, gen, deterministic=False, draws=draws)
    if preservation is not None:
        ratio, pres_loss, base = preservation
        loss = loss + ratio * pres_loss(batch, gen,
                                        draws.get("preservation"), base)
    if "loss_scale" in batch:
        loss = loss * batch["loss_scale"]
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def _pick(values: List, idx: torch.Tensor):
    """Entry ``idx`` (a device scalar) of ``values``: tensors stacked and
    indexed on the device, dicts key by key."""
    if isinstance(values[0], dict):
        return {k: _pick([v[k] for v in values], idx) for k in values[0]}
    return torch.stack(values).index_select(0, idx.reshape(1))[0]


@torch.no_grad()
def explore(task_loss, batch: Dict[str, torch.Tensor], gen: torch.Generator,
            n: int, candidates: Optional[List[Dict]] = None, grad_sync=None):
    """Best-of-``n`` draws: ``(chosen draws, the candidates' losses, the
    argmin)``; the candidates come from ``task_loss.draw`` unless given.
    With ``grad_sync`` the losses are the means over the processes."""
    if candidates is None:
        candidates = [task_loss.draw(batch, gen) for _ in range(n)]
    if len(candidates) != n:
        raise ValueError(f"{len(candidates)} candidate draws for "
                         f"exploration_steps={n}")
    losses = torch.stack([task_loss(batch, gen, deterministic=True, draws=c)
                          for c in candidates])
    if grad_sync is not None:
        grad_sync.mean_([losses])
    idx = torch.argmin(losses)
    return _pick(candidates, idx), losses, idx


def make_train_step(*, task_loss, optimizer: Optimizer,
                    ema: Optional[List[torch.Tensor]] = None,
                    ema_decay: float = 0.999, uncond_prob: float = 0.0,
                    exploration_steps: Optional[int] = None,
                    preservation_ratio: float = 0.0,
                    preservation_loss=None,
                    frozen_base: Optional[Dict[str, torch.Tensor]] = None,
                    grad_sync=None):
    """``step(batch, gen, draws=None, shared_gen=None) -> {"loss",
    "grad_norm"}``; updates the optimizer's leaves and ``ema`` in place.
    ``frozen_base`` is the preservation term's base under full fine-tuning
    (None: the model with its adapters gated off); ``grad_sync`` averages
    over the processes, and ``shared_gen`` (default ``gen``) draws the
    caption dropout."""
    leaves = optimizer.leaves
    preservation = ((preservation_ratio, preservation_loss, frozen_base)
                    if preservation_ratio > 0.0
                    and preservation_loss is not None else None)

    def step(batch: Dict[str, torch.Tensor], gen: torch.Generator,
             draws: Optional[Dict] = None,
             shared_gen: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        draws = dict(draws or {})
        if uncond_prob > 0.0 and "empty_embeddings" in batch:
            use = draws.get("uncond")
            if use is None:
                g = shared_gen if shared_gen is not None else gen
                use = torch.rand((), generator=g,
                                 device=g.device) < uncond_prob
            batch = apply_uncond_dropout(batch, use)
        if exploration_steps:
            chosen, _, _ = explore(task_loss, batch, gen, exploration_steps,
                                   draws.pop("candidates", None), grad_sync)
            draws.update(chosen)
        loss, grads = loss_and_grads(task_loss, leaves, batch, gen, draws,
                                     preservation)
        if grad_sync is not None:
            loss = loss.float().reshape(1)
            grad_sync.reduce_grads_(grads, loss)
            loss = loss[0]
        grad_norm = global_norm(grads)
        synced = optimizer.update(grads)
        if ema is not None and synced:
            ema_update(ema, leaves, ema_decay)
        return {"loss": loss.float(), "grad_norm": grad_norm}

    return step
