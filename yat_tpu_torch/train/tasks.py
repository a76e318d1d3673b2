"""Task losses: flow matching.

Counterpart of ``yat_tpu/train/tasks.py:make_flow_matching_loss`` without
REPA: ``x_t = (1 - s) x + s eps``, target ``eps - x``, MSE in fp32,
timesteps from the logit-normal density (or a fixed ``timestep_list``).

The loss draws its timesteps and noise from the ``torch.Generator`` it is
given, unless the caller passes them in ``draws`` (``timesteps``,
``sigmas``, ``noise``): ``jax.random`` cannot be reproduced in torch, so a
test hands both packages the same draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from yat_tpu_torch.adapters.builder import adapted_modules, set_dropout_seed
from yat_tpu_torch.ops.schedulers import FlowMatchSchedule

# (batch, gen, deterministic, draws) -> scalar fp32 loss
TaskLoss = Callable[..., torch.Tensor]


def make_flow_matching_loss(model, schedule: FlowMatchSchedule,
                            timestep_list: Optional[Sequence[int]] = None,
                            snr_weighting: bool = False) -> TaskLoss:
    timestep_list = tuple(timestep_list) if timestep_list else None

    def task_loss(batch: Dict[str, torch.Tensor], gen: torch.Generator,
                  deterministic: bool = True,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
        draws = draws or {}
        latents = batch["latents"]
        b = latents.shape[0]
        if "timesteps" in draws:
            timesteps, sigmas = draws["timesteps"], draws["sigmas"]
        else:
            timesteps, sigmas = schedule.training_draw(
                gen, b, timestep_list=timestep_list)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(latents.shape, generator=gen,
                                device=latents.device).to(latents.dtype)
        if not deterministic and any(m.lora_dropout > 0.0
                                     for _, m in adapted_modules(model)):
            set_dropout_seed(model, int(torch.randint(
                0, 2 ** 62, (), generator=gen, device=gen.device)))
        x_t = schedule.add_noise(latents, noise.to(latents.dtype), sigmas)
        pred = model(x_t, batch["embeddings"], timesteps,
                     batch.get("text_mask"), deterministic=deterministic)
        target = schedule.velocity_target(latents, noise.to(latents.dtype))
        err = (pred.float() - target.float()) ** 2
        if snr_weighting:
            err = err * (sigmas.float() ** -2.0).reshape(
                b, *([1] * (latents.ndim - 1)))
        return err.mean()

    return task_loss
