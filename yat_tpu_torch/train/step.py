"""The training step.

Counterpart of ``yat_tpu/train/step.py:make_train_step``: unconditional-
caption dropout (a whole-batch swap with the empty caption), the task loss
and its gradients with respect to the trainable leaves only, ``loss_scale``,
the optimizer update, and EMA advanced on the steps where the accumulation
synced.  Metrics are ``loss`` and ``grad_norm``, the global norm of the
unclipped micro-step gradients, as device tensors.

``draws`` (optional) fixes the step's random choices: ``uncond`` (bool),
and ``timesteps``, ``sigmas`` and ``noise`` for the loss.
"""

from __future__ import annotations

from typing import Dict, List, Optional

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
                   draws: Optional[Dict] = None):
    """The scaled training loss and its gradients with respect to
    ``leaves`` (forward with LoRA dropout active, as in training).  A leaf
    cut off from the loss raises."""
    loss = task_loss(batch, gen, deterministic=False, draws=draws)
    if "loss_scale" in batch:
        loss = loss * batch["loss_scale"]
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def make_train_step(*, task_loss, optimizer: Optimizer,
                    ema: Optional[List[torch.Tensor]] = None,
                    ema_decay: float = 0.999, uncond_prob: float = 0.0,
                    exploration_steps: Optional[int] = None,
                    use_preservation: bool = False):
    """``step(batch, gen, draws=None) -> {"loss", "grad_norm"}``; updates
    the optimizer's leaves and ``ema`` in place."""
    if exploration_steps:
        raise NotImplementedError(
            "exploration_steps (best-of-N noise search) is not implemented in "
            "the PyTorch port yet (ROADMAP queue 1, item 13)")
    if use_preservation:
        raise NotImplementedError(
            "use_preservation (the preservation loss) is not implemented in "
            "the PyTorch port yet (ROADMAP queue 1, item 13)")
    leaves = optimizer.leaves

    def step(batch: Dict[str, torch.Tensor], gen: torch.Generator,
             draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        if uncond_prob > 0.0 and "empty_embeddings" in batch:
            use = draws.get("uncond")
            if use is None:
                use = torch.rand((), generator=gen,
                                 device=gen.device) < uncond_prob
            batch = apply_uncond_dropout(batch, use)
        loss, grads = loss_and_grads(task_loss, leaves, batch, gen, draws)
        grad_norm = global_norm(grads)
        synced = optimizer.update(grads)
        if ema is not None and synced:
            ema_update(ema, leaves, ema_decay)
        return {"loss": loss.float(), "grad_norm": grad_norm}

    return step
