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

``unfreeze_modules`` (partial fine-tuning) is the mask of
``yat_tpu/train/state.py:105-127``: a leaf updates when one pattern equals a
segment of its dotted flax path (``blocks_1`` never matches ``blocks_10``)
or the whole path.  As under ``optax.masked``, the clip's global norm, the
Adam moments (or Lion's momentum) and weight decay see only the unfrozen
leaves, and a frozen leaf's update is exactly 0; accumulation keeps the
unfrozen leaves' mean only (``MultiSteps`` accumulates every leaf, but the
frozen ones' mean is never read).

With ``use_adamw_8bit`` the chain is ``clip_by_global_norm`` → Lion with
8-bit momentum at rate 1.0 (``ops/opt8bit.py``) → ``scale_by_schedule``
(``yat_tpu/train/state.py:93-104``): the update ``−u`` is scaled by the
schedule at the same pre-increment count, so the first update under
warmup is 0 here too.

The leaves are updated in place.  :meth:`Optimizer.state_dict` is the
state a checkpoint holds: the update count, the accumulation's micro-step
and mean, and the moments (the Lion payloads and block scales).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.ops.opt8bit import Lion8bit


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


def unfreeze_mask(names: Sequence[str], patterns: Sequence[str]
                  ) -> List[bool]:
    """For each dotted flax path in ``names``: whether ``unfreeze_modules``
    (``patterns``) lets it update: a pattern equal to one path segment, or
    to the whole path."""
    pats = tuple(patterns)
    return [any(p in name.split(".") or p == name for p in pats)
            for name in names]


class Optimizer:
    """clip by global norm → AdamW (or, with ``use_adamw_8bit``, Lion with
    8-bit momentum and the schedule) → accumulation over ``k`` micro-steps,
    on a fixed list of fp32 leaves, of which ``mask`` (default: all) says
    which update."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: TrainingParameters,
                 leaves: List[torch.Tensor],
                 mask: Optional[Sequence[bool]] = None):
        self.leaves = list(leaves)
        if mask is not None and len(mask) != len(self.leaves):
            raise ValueError(f"a mask of {len(mask)} entries for "
                             f"{len(self.leaves)} leaves")
        self.mask = list(mask) if mask is not None else None
        # the leaves that update (all of them without a mask)
        self.active = (self.leaves if mask is None else
                       [p for p, m in zip(self.leaves, mask) if m])
        self.schedule = make_lr_schedule(params)
        self.max_norm = float(params.max_grad_norm)
        self.weight_decay = float(params.weight_decay)
        self.k = max(1, int(params.gradient_accumulation_steps))
        self.count = 0           # inner updates applied
        self.mini_step = 0
        self.lion = (Lion8bit(self.active, weight_decay=self.weight_decay)
                     if params.use_adamw_8bit else None)
        with torch.no_grad():
            adam_leaves = self.active if self.lion is None else []
            self.mu = [torch.zeros_like(p) for p in adam_leaves]
            self.nu = [torch.zeros_like(p) for p in adam_leaves]
            self.acc: Optional[List[torch.Tensor]] = (
                [torch.zeros_like(p) for p in self.active] if self.k > 1
                else None)

    @property
    def lr(self) -> float:
        """The rate the next inner update will use."""
        return self.schedule(self.count)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-step's gradients (one per leaf, frozen leaves
        included); returns True when an update was applied (the
        accumulation synced)."""
        if self.mask is not None:
            grads = [g for g, m in zip(grads, self.mask) if m]
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
        leaves = self.active
        if self.lion is not None:
            upd = self.lion.updates(g, leaves)
            torch._foreach_mul_(upd, self.schedule(self.count))
            self.count += 1
            torch._foreach_add_(leaves, upd)
            return
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
                leaves, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(leaves, upd)

    def state_dict(self) -> Dict[str, object]:
        """The optimizer's state as the live tensors (no copies)."""
        state: Dict[str, object] = {
            "count": self.count, "mini_step": self.mini_step,
            "mu": self.mu, "nu": self.nu, "acc": self.acc}
        if self.lion is not None:
            state["lion_payload"] = [q for q, _ in self.lion.momentum]
            state["lion_scale"] = [s for _, s in self.lion.momentum]
        return state


def ema_update(ema: List[torch.Tensor], leaves: Sequence[torch.Tensor],
               decay: float) -> None:
    """``e * decay + p * (1 - decay)`` in place."""
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(list(leaves),
                                                    1.0 - decay))

