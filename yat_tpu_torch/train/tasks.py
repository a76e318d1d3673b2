"""Task losses: flow matching, DDPM epsilon prediction, preservation.

Counterparts of ``yat_tpu/train/tasks.py:make_flow_matching_loss``,
``make_epsilon_loss`` (without REPA) and ``make_preservation_loss``:

* flow matching: ``x_t = (1 - s) x + s eps``, target ``eps - x``;
* epsilon prediction (PixArt-Sigma): ``x_t = sqrt(abar) x +
  sqrt(1 - abar) eps`` at integer timesteps, target the schedule's (eps, or
  v), and with a learned-sigma head the prediction sliced to the latent
  channels before the MSE.

* preservation: the MSE between the adapted model's prediction and the
  frozen base's on the same noisy input, both deterministic (no LoRA
  dropout), in the flow or the epsilon form, the whole prediction (a
  learned-sigma head's both halves).  With adapters the base is the model
  with its adapter branches gated off (``AdapterDense.lora_gate`` = 0);
  under full fine-tuning it is a snapshot of the initial parameters
  (``base``), run through ``torch.func.functional_call``.  The base's
  prediction is taken without gradients.

The task losses take the MSE in fp32 and draw timesteps from the
logit-normal density (or a fixed ``timestep_list``; the preservation term
always draws from the density, as in the JAX package).  A loss draws its
timesteps and noise from the ``torch.Generator`` it is given, unless the
caller passes them in ``draws`` (``timesteps``, ``sigmas`` for flow
matching, ``noise``): ``jax.random`` cannot be reproduced in torch, so a
test hands both packages the same draws.  Each task loss carries its draw
as ``task_loss.draw(batch, gen)`` (the candidates of exploration steps).
The preservation term draws a set of its own (JAX splits the step's key in
two there and in three in the task loss), given as ``draws`` to it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from yat_tpu_torch.adapters.builder import adapted_modules, set_dropout_seed
from yat_tpu_torch.models.layers import set_adapter_gate
from yat_tpu_torch.ops.schedulers import DDPMSchedule, FlowMatchSchedule

# (batch, gen, deterministic, draws) -> scalar fp32 loss
TaskLoss = Callable[..., torch.Tensor]


def make_flow_matching_loss(model, schedule: FlowMatchSchedule,
                            timestep_list: Optional[Sequence[int]] = None,
                            snr_weighting: bool = False) -> TaskLoss:
    timestep_list = tuple(timestep_list) if timestep_list else None

    def draw_t(gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
        timesteps, sigmas = schedule.training_draw(
            gen, b, timestep_list=timestep_list)
        return {"timesteps": timesteps, "sigmas": sigmas}

    def task_loss(batch: Dict[str, torch.Tensor], gen: torch.Generator,
                  deterministic: bool = True,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
        latents = batch["latents"]
        b = latents.shape[0]
        draws = _complete(draws, latents, gen, draw_t)
        timesteps, sigmas, noise = (draws["timesteps"], draws["sigmas"],
                                    draws["noise"])
        _seed_lora_dropout(model, gen, deterministic)
        x_t = schedule.add_noise(latents, noise.to(latents.dtype), sigmas)
        pred = model(x_t, batch["embeddings"], timesteps,
                     batch.get("text_mask"), deterministic=deterministic)
        target = schedule.velocity_target(latents, noise.to(latents.dtype))
        err = (pred.float() - target.float()) ** 2
        if snr_weighting:
            err = err * (sigmas.float() ** -2.0).reshape(
                b, *([1] * (latents.ndim - 1)))
        return err.mean()

    task_loss.draw = _drawer(draw_t)
    return task_loss


def _complete(draws, latents: torch.Tensor, gen: torch.Generator,
              draw_t) -> Dict[str, torch.Tensor]:
    """``draws`` with what they lack drawn from ``gen``: the timesteps
    (``draw_t(gen, b)``), then the noise, in the latents' dtype."""
    draws = dict(draws or {})
    if "timesteps" not in draws:
        draws.update(draw_t(gen, latents.shape[0]))
    if draws.get("noise") is None:
        draws["noise"] = torch.randn(latents.shape, generator=gen,
                                     device=latents.device).to(latents.dtype)
    return draws


def _drawer(draw_t):
    """``draw(batch, gen)``: a whole set of draws for ``batch``."""
    return lambda batch, gen: _complete(None, batch["latents"], gen, draw_t)


def _seed_lora_dropout(model, gen: torch.Generator,
                       deterministic: bool) -> None:
    """Draw this step's LoRA-dropout seed when dropout is active."""
    if not deterministic and any(m.lora_dropout > 0.0
                                 for _, m in adapted_modules(model)):
        set_dropout_seed(model, int(torch.randint(
            0, 2 ** 62, (), generator=gen, device=gen.device)))


def make_epsilon_loss(model, schedule: DDPMSchedule,
                      timestep_list: Optional[Sequence[int]] = None,
                      learned_sigma: bool = False,
                      repa_lambda: float = 0.0) -> TaskLoss:
    """``learned_sigma`` keeps the first ``latents.shape[-1]`` channels of
    the prediction (the PixArt learned-variance head's epsilon half) before
    the MSE.  REPA raises (ROADMAP queue 1, item 10)."""
    if repa_lambda > 0.0:
        raise NotImplementedError(
            "REPA (the representation-alignment term of the epsilon loss) is "
            "not implemented in the PyTorch port yet (ROADMAP queue 1, item "
            "10)")
    timestep_list = tuple(timestep_list) if timestep_list else None

    def draw_t(gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
        return {"timesteps": schedule.training_draw(
            gen, b, timestep_list=timestep_list)}

    def task_loss(batch: Dict[str, torch.Tensor], gen: torch.Generator,
                  deterministic: bool = True,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
        latents = batch["latents"]
        draws = _complete(draws, latents, gen, draw_t)
        timesteps, noise = draws["timesteps"], draws["noise"].to(latents.dtype)
        _seed_lora_dropout(model, gen, deterministic)
        x_t = schedule.add_noise(latents, noise, timesteps)
        pred = model(x_t, batch["embeddings"], timesteps,
                     batch.get("text_mask"), deterministic=deterministic)
        if learned_sigma:
            pred = pred[..., :latents.shape[-1]]
        target = schedule.target(latents, noise, timesteps)
        return ((pred.float() - target.float()) ** 2).mean()

    task_loss.draw = _drawer(draw_t)
    return task_loss


# (batch, gen, draws, base) -> scalar fp32 preservation term
PreservationLoss = Callable[..., torch.Tensor]


def make_preservation_loss(model, schedule, is_flow: bool = True
                           ) -> PreservationLoss:
    """The preservation term ``pres(batch, gen, draws=None, base=None)``:
    ``base`` is None for adapter training (the base is the model with its
    adapters gated off) or the frozen snapshot ``{parameter name: tensor}``
    of full fine-tuning."""

    def draw_t(gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
        if is_flow:
            timesteps, sigmas = schedule.training_draw(gen, b)
            return {"timesteps": timesteps, "sigmas": sigmas}
        return {"timesteps": schedule.training_draw(gen, b)}

    def pres_loss(batch: Dict[str, torch.Tensor], gen: torch.Generator,
                  draws: Optional[Dict[str, torch.Tensor]] = None,
                  base: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
        latents = batch["latents"]
        draws = _complete(draws, latents, gen, draw_t)
        timesteps, noise = draws["timesteps"], draws["noise"].to(latents.dtype)
        x_t = schedule.add_noise(latents, noise, draws["sigmas"] if is_flow
                                 else timesteps)
        args = (x_t, batch["embeddings"], timesteps, batch.get("text_mask"))
        pred = model(*args, deterministic=True)
        with torch.no_grad():
            if base is not None:
                ref = torch.func.functional_call(
                    model, base, args, {"deterministic": True})
            else:
                set_adapter_gate(model, 0.0)
                try:
                    ref = model(*args, deterministic=True)
                finally:
                    set_adapter_gate(model, None)
        return ((pred.float() - ref.float()) ** 2).mean()

    return pres_loss
