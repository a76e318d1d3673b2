"""Task losses: flow matching, DDPM epsilon prediction, preservation.

Counterparts of ``yat_tpu/train/tasks.py:make_flow_matching_loss``,
``make_epsilon_loss``, ``repa_alignment_loss`` and
``make_preservation_loss``:

* flow matching: ``x_t = (1 - s) x + s eps``, target ``eps - x``;
* epsilon prediction (PixArt-Sigma, SD1.5, SDXL): ``x_t = sqrt(abar) x +
  sqrt(1 - abar) eps`` at integer timesteps, target the schedule's (eps, or
  v), and with a learned-sigma head the prediction sliced to the latent
  channels before the MSE; ``extra_keys`` names the batch entries that go
  to the model as keyword arguments (SDXL's ``pooled_text`` and
  ``time_ids``).

* preservation: the MSE between the adapted model's prediction and the
  frozen base's on the same noisy input, both deterministic (no LoRA
  dropout), in the flow or the epsilon form, the whole prediction (a
  learned-sigma head's both halves).  With adapters the base is the model
  without its adapters (``models.layers.adapters_off``: a DoRA layer
  computes ``W`` there, not the gated ``m · W / ‖W‖``);
  under full fine-tuning it is a snapshot of the initial parameters
  (``base``), run through ``torch.func.functional_call``.  The base's
  prediction is taken without gradients.

* REPA (``repa_lambda > 0``): the loss adds ``repa_lambda`` times the
  alignment term between the model's features and the batch's DINOv2
  tokens ``repa_features``.  With ``repa_cfg`` (``ops.repa.RepaConfig``)
  and ``repa_head`` the features are the target modules' outputs captured
  during the forward, each projected by the head (SANA's generic path);
  without, the model's own tap (``return_repa``, PixArt-Sigma's
  projector).  A batch without ``repa_features`` raises at the step; the
  JAX package then trains without the term (the feature-shard path, whose
  extraction writes no DINO tokens).

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
from yat_tpu_torch.models.layers import adapters_off
from yat_tpu_torch.ops.schedulers import DDPMSchedule, FlowMatchSchedule

# (batch, gen, deterministic, draws) -> scalar fp32 loss
TaskLoss = Callable[..., torch.Tensor]


def repa_alignment_loss(proj: torch.Tensor, target: torch.Tensor
                        ) -> torch.Tensor:
    """The mean-token MSE between projected features and DINO tokens, in
    fp32; when the token counts differ (PixArt's 1024 tokens at 512 px
    against DINO's 256) both sides are mean-pooled over tokens first."""
    p, t = proj.float(), target.float()
    if p.shape[1] != t.shape[1]:
        p, t = p.mean(1), t.mean(1)
    return ((p - t) ** 2).mean()


def _model_kwargs(batch, extra_keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The batch's entries of ``extra_keys`` (SDXL's ``pooled_text`` and
    ``time_ids``) as keyword arguments of the model."""
    return {k: batch[k] for k in extra_keys if k in batch}


def _predict(model, args, deterministic: bool, batch, repa_lambda: float,
             repa_cfg, repa_head, extra_keys: Sequence[str] = ()):
    """The model's prediction, and the REPA term (None when REPA is off)."""
    kw = _model_kwargs(batch, extra_keys)
    if repa_lambda <= 0.0:
        return model(*args, deterministic=deterministic, **kw), None
    if "repa_features" not in batch:
        raise ValueError(
            "use_repa is on and this batch carries no DINOv2 tokens "
            "(repa_features): only the on-the-fly and Dreambooth samplers "
            "encode them (compute_features); feature shards hold none")
    target = batch["repa_features"]
    if repa_cfg is None:
        pred, proj = model(*args, deterministic=deterministic,
                           return_repa=True, **kw)
        # a tap past the last block projects nothing (no term)
        return pred, (None if proj is None
                      else repa_alignment_loss(proj, target))
    from yat_tpu_torch.ops.repa import capture_features, generic_repa_loss
    with capture_features(model, repa_cfg) as feats:
        pred = model(*args, deterministic=deterministic, **kw)
    return pred, generic_repa_loss(feats, repa_head, target)


def make_flow_matching_loss(model, schedule: FlowMatchSchedule,
                            timestep_list: Optional[Sequence[int]] = None,
                            snr_weighting: bool = False,
                            repa_lambda: float = 0.0, repa_cfg=None,
                            repa_head=None) -> TaskLoss:
    """``repa_lambda`` with ``repa_cfg`` and ``repa_head`` adds the generic
    REPA term (SANA); with neither, the model's own tap."""
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
        pred, repa = _predict(model, (x_t, batch["embeddings"], timesteps,
                                      batch.get("text_mask")), deterministic,
                              batch, repa_lambda, repa_cfg, repa_head)
        target = schedule.velocity_target(latents, noise.to(latents.dtype))
        err = (pred.float() - target.float()) ** 2
        if snr_weighting:
            err = err * (sigmas.float() ** -2.0).reshape(
                b, *([1] * (latents.ndim - 1)))
        loss = err.mean()
        return loss if repa is None else loss + repa_lambda * repa

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
                      repa_lambda: float = 0.0, repa_cfg=None,
                      repa_head=None,
                      extra_keys: Sequence[str] = ()) -> TaskLoss:
    """``learned_sigma`` keeps the first ``latents.shape[-1]`` channels of
    the prediction (the PixArt learned-variance head's epsilon half) before
    the MSE.  ``repa_lambda`` adds the REPA term through the model's tap
    (PixArt-Sigma), or the generic path with ``repa_cfg`` (SD1.5, SDXL).
    The batch's entries of ``extra_keys`` (SDXL's ``pooled_text`` and
    ``time_ids``) go to the model as keyword arguments."""
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
        pred, repa = _predict(model, (x_t, batch["embeddings"], timesteps,
                                      batch.get("text_mask")), deterministic,
                              batch, repa_lambda, repa_cfg, repa_head,
                              extra_keys)
        if learned_sigma:
            pred = pred[..., :latents.shape[-1]]
        target = schedule.target(latents, noise, timesteps)
        loss = ((pred.float() - target.float()) ** 2).mean()
        return loss if repa is None else loss + repa_lambda * repa

    task_loss.draw = _drawer(draw_t)
    return task_loss


# (batch, gen, draws, base) -> scalar fp32 preservation term
PreservationLoss = Callable[..., torch.Tensor]


def make_preservation_loss(model, schedule, is_flow: bool = True,
                           extra_keys: Sequence[str] = ()
                           ) -> PreservationLoss:
    """The preservation term ``pres(batch, gen, draws=None, base=None)``:
    ``base`` is None for adapter training (the base is the model without
    its adapters) or the frozen snapshot ``{parameter name: tensor}``
    of full fine-tuning.  The batch's entries of ``extra_keys`` go to both
    predictions as keyword arguments."""

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
        kw = {"deterministic": True, **_model_kwargs(batch, extra_keys)}
        pred = model(*args, **kw)
        with torch.no_grad():
            if base is not None:
                ref = torch.func.functional_call(model, base, args, kw)
            else:
                with adapters_off(model):
                    ref = model(*args, **kw)
        return ((pred.float() - ref.float()) ** 2).mean()

    return pres_loss
