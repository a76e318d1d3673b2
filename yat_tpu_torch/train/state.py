"""The learning-rate schedule and the optimizer of the trainable leaves.

Counterpart of ``yat_tpu/train/state.py:make_lr_schedule`` and
``make_optimizer``: the optax chain ``clip_by_global_norm(max_grad_norm)``
→ ``adamw(schedule, weight_decay)`` (→ ``MultiSteps(k)`` with gradient
accumulation), written out with optax's own update rules so the numbers
agree:

* the clip scales by ``max_norm / norm`` as ``(g / norm) * max_norm`` when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` and would not match);
* Adam with b1 0.9, b2 0.999, eps 1e-8 and bias correction at the
  incremented count; weight decay ``wd * p`` is added to the Adam update
  and the sum is scaled by ``-lr``;
* the schedule is evaluated at the update count BEFORE it is incremented,
  so with ``warmup_steps > 0`` the first update has lr 0;
* accumulation keeps the running mean of the micro-step gradients and
  applies it on the k-th.

The leaves are updated in place.  Lion-8bit and ``unfreeze_modules`` are not
ported.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from yat_tpu_torch.config import TrainingParameters


def make_lr_schedule(params: TrainingParameters) -> Callable[[int], float]:
    """Warmup ramp with an optional cyclic-triangular mode."""
    base = params.learning_rate
    warmup = params.warmup_steps or 0

    if params.cyclic_lr_max_lr is not None:
        up, down = params.cyclic_lr_step_size_up, params.cyclic_lr_step_size_down
        max_lr = params.cyclic_lr_max_lr

        def cyclic(step):
            pos = step % (up + down)
            frac = pos / up if pos < up else 1.0 - (pos - up) / down
            return base + (max_lr - base) * frac

        if warmup == 0:
            return cyclic
        return lambda step: (base * step / warmup if step < warmup
                             else cyclic(step - warmup))

    if warmup == 0:
        return lambda step: base
    return lambda step: base * min(1.0, step / warmup)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the fp32 L2 norm over every leaf."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class Optimizer:
    """clip by global norm → AdamW → accumulation over ``k`` micro-steps,
    on a fixed list of fp32 leaves."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: TrainingParameters,
                 leaves: List[torch.Tensor]):
        if params.use_adamw_8bit:
            raise NotImplementedError(
                "use_adamw_8bit (Lion with 8-bit momentum) is not implemented "
                "in the PyTorch port yet (ROADMAP queue 1, item 11)")
        if params.unfreeze_modules:
            raise NotImplementedError(
                "unfreeze_modules (partial fine-tuning) is not implemented "
                "in the PyTorch port yet (ROADMAP queue 1, item 13)")
        self.leaves = list(leaves)
        self.schedule = make_lr_schedule(params)
        self.max_norm = float(params.max_grad_norm)
        self.weight_decay = float(params.weight_decay)
        self.k = max(1, int(params.gradient_accumulation_steps))
        self.count = 0           # inner updates applied
        self.mini_step = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p) for p in self.leaves]
            self.nu = [torch.zeros_like(p) for p in self.leaves]
            self.acc: Optional[List[torch.Tensor]] = (
                [torch.zeros_like(p) for p in self.leaves] if self.k > 1
                else None)

    @property
    def lr(self) -> float:
        """The rate the next inner update will use."""
        return self.schedule(self.count)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-step's gradients; returns True when an update
        was applied (the accumulation synced)."""
        if self.acc is None:
            self._apply(grads)
            return True
        # running mean: acc + (g - acc) / (n + 1)
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, diff)
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            return False
        self._apply(self.acc)
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        return True

    def _apply(self, grads: List[torch.Tensor]) -> None:
        norm = global_norm(grads)
        g = list(grads)
        # the one host read of the step: the clip's branch
        if not bool(norm < self.max_norm):
            g = torch._foreach_div(g, norm)
            torch._foreach_mul_(g, self.max_norm)
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - self.b2))
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        mhat = torch._foreach_div(self.mu, bc1)
        vhat = torch._foreach_div(self.nu, bc2)
        denom = torch._foreach_sqrt(vhat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mhat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(
                self.leaves, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.leaves, upd)


def ema_update(ema: List[torch.Tensor], leaves: Sequence[torch.Tensor],
               decay: float) -> None:
    """``e * decay + p * (1 - decay)`` in place."""
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(list(leaves),
                                                    1.0 - decay))

