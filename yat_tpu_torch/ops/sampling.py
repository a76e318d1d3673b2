"""Inference sampling: flow-match Euler and DDIM, with classifier-free
guidance and perturbed-attention guidance.

Counterpart of the flow-match Euler and DDIM paths of
``yat_tpu/ops/sampling.py``: a Python loop over the step ladder takes the
place of ``lax.scan``; ``make_cfg_denoiser`` batches the unconditional and
conditional branches into one model call, and ``make_pag_cfg_denoiser``
adds one perturbed call of the conditional branch.  DPM-Solver++(2M), the
velocity cache and refiner adapter gating wait for later slices of the
port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from yat_tpu_torch.ops.schedulers import DDPMSchedule, FlowMatchSchedule


def seed_noise(seed: int, latent_shape: Tuple[int, ...],
               device: torch.device) -> torch.Tensor:
    """Initial noise: ONE seeded batch-1 draw, tiled over the batch, so every
    prompt of a batch starts from the same noise as it would alone.  The
    draw comes from a ``torch.Generator`` on ``device`` and does not
    reproduce ``jax.random``; tests inject the JAX draw through
    ``sample_flow_match(x0=...)``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    one = torch.randn((1, *latent_shape[1:]), generator=gen,
                      dtype=torch.float32, device=device)
    return one.expand(latent_shape)


def sample_flow_match(
    denoise_fn: Callable,            # (x, t) -> velocity
    latent_shape: Tuple[int, ...],
    schedule: FlowMatchSchedule,
    num_steps: int = 20,
    seed: int = 42,
    mu: Optional[float] = None,
    device: Optional[torch.device] = None,
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Euler integration from noise; ``denoise_fn`` already folds in CFG.
    ``x0`` (batch 1 or the full batch) replaces the seeded draw."""
    x = _initial_noise(seed, latent_shape, device, x0)
    sigmas = schedule.inference_sigmas(num_steps, mu).to(device)
    for i in range(num_steps):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        t = (sigma * schedule.num_train_timesteps).expand(latent_shape[0])
        v = denoise_fn(x, t)
        x = schedule.euler_step(x, v.to(x.dtype), sigma, sigma_next)
    return x


def _initial_noise(seed, latent_shape, device, x0):
    if x0 is None:
        return seed_noise(seed, latent_shape, device)
    return x0.to(device=device, dtype=torch.float32).expand(latent_shape)


def ddim_timesteps(schedule: DDPMSchedule, num_steps: int):
    """The integer timestep ladder from ``n - 1`` down to 0 and each step's
    target (-1 after the last): ``jnp.linspace(n - 1, 0, num_steps)``
    truncated to int32, with the fp32 arithmetic XLA gives that function
    (``start * (1 - i * (1 / (num - 1)))``, which lands just under some
    integers)."""
    n = schedule.num_train_timesteps
    if num_steps == 1:
        return [n - 1], [-1]
    recip = torch.tensor(1.0, dtype=torch.float32) / (num_steps - 1)
    step = torch.arange(num_steps - 1, dtype=torch.float32) * recip
    ts = ((n - 1) * (1 - step)).to(torch.int32).tolist() + [0]
    return ts, ts[1:] + [-1]


def sample_ddim(
    denoise_fn: Callable,            # (x, t) -> epsilon
    latent_shape: Tuple[int, ...],
    schedule: DDPMSchedule,
    num_steps: int = 20,
    seed: int = 42,
    device: Optional[torch.device] = None,
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deterministic DDIM (eta = 0) from noise; ``denoise_fn`` already folds
    in the guidance.  ``x0`` (batch 1 or the full batch) replaces the seeded
    draw."""
    x = _initial_noise(seed, latent_shape, device, x0)
    ts, ts_prev = ddim_timesteps(schedule, num_steps)
    for t, t_prev in zip(ts, ts_prev):
        eps = denoise_fn(x, torch.full((latent_shape[0],), float(t),
                                       device=x.device))
        x = schedule.ddim_step(x, eps.to(x.dtype), t, t_prev)
    return x


def _tree_cat(u: Any, c: Any) -> Any:
    """Concatenate two structurally equal trees of tensors on dim 0."""
    if isinstance(u, torch.Tensor):
        return torch.cat([u, c], dim=0)
    if isinstance(u, dict):
        return {k: _tree_cat(u[k], c[k]) for k in u}
    if isinstance(u, (tuple, list)):
        return type(u)(_tree_cat(a, b) for a, b in zip(u, c))
    if u is None and c is None:
        return None
    raise TypeError(f"cannot batch conditioning of type {type(u).__name__}")


def make_cfg_denoiser(
    model_apply: Callable,
    cond_kwargs: Dict[str, Any],
    uncond_kwargs: Dict[str, Any],
    guidance_scale: float,
) -> Callable:
    """Classifier-free guidance: ``fn(x, t) -> prediction``.  The
    unconditional and conditional branches run as one batch, in that
    order; tree-valued conditioning (the per-layer context-K/V cache) is
    concatenated leaf by leaf."""

    if guidance_scale <= 1.0:
        return lambda x, t: model_apply(x, timesteps=t, **cond_kwargs)
    both = {k: _tree_cat(uncond_kwargs[k], cond_kwargs[k]) for k in cond_kwargs}

    def fn(x, t):
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.cat([t, t], dim=0)
        pred = model_apply(x2, timesteps=t2, **both)
        uncond, cond = pred.chunk(2, dim=0)
        return uncond + guidance_scale * (cond - uncond)

    return fn


def make_pag_cfg_denoiser(
    model_apply: Callable,
    cond_kwargs: Dict[str, Any],
    uncond_kwargs: Dict[str, Any],
    guidance_scale: float,
    pag_scale: float,
) -> Callable:
    """Perturbed-attention guidance with CFG: one call at batch 2B
    (unconditional, conditional) and one perturbed call of the conditional
    branch at batch B (``pag=True``: identity self-attention in the
    configured blocks)::

        pred = uncond + g (cond - uncond) + pag (cond - cond_perturbed)
    """
    both = {k: _tree_cat(uncond_kwargs[k], cond_kwargs[k]) for k in cond_kwargs}

    def fn(x, t):
        pred = model_apply(torch.cat([x, x], dim=0),
                           timesteps=torch.cat([t, t], dim=0), **both)
        uncond, cond = pred.chunk(2, dim=0)
        perturbed = model_apply(x, timesteps=t, pag=True, **cond_kwargs)
        return (uncond + guidance_scale * (cond - uncond)
                + pag_scale * (cond - perturbed))

    return fn
