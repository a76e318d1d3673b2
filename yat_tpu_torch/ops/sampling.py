"""Inference sampling: flow-match Euler (with or without the velocity
cache), DDIM and DPM-Solver++(2M) in its epsilon and flow forms, with
classifier-free guidance, perturbed-attention guidance and refiner
timestep gating.

Counterpart of ``yat_tpu/ops/sampling.py``: a Python loop over the step
ladder takes the place of ``lax.scan`` (and of ``lax.cond`` for the cached
sampler's skipped steps, whose model call never runs);
``make_cfg_denoiser`` batches the unconditional and conditional branches
into one model call, and ``make_pag_cfg_denoiser`` adds one perturbed call
of the conditional branch.  Every sampler takes ``x0=`` in place of its
seeded draw.

``sample_flux`` is Flux's token-space Euler ladder (guidance embedding
and true CFG) on the same flow-match machinery.

Refiner timestep gating: with ``active_timesteps`` a sampler calls
``set_gate(timestep_gate(t, active_timesteps))`` before each step's model
call and ``set_gate(None)`` when the ladder ends; the pipeline's
``set_gate`` is ``models.layers.set_adapter_gate`` on its denoiser, the
counterpart of the JAX package's per-step ``gate_adapter_meta``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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


def timestep_gate(timestep, active_timesteps: Sequence[int]) -> float:
    """1.0 when the timestep, rounded to an integer (half to even, in
    fp32), is in the refiner list, else 0.0."""
    t = int(torch.round(torch.as_tensor(timestep, dtype=torch.float32)))
    return 1.0 if t in {int(a) for a in active_timesteps} else 0.0


@contextlib.contextmanager
def _gating(active_timesteps, set_gate):
    """``gate(t)`` sets a step's gate, or None when ``active_timesteps``
    is not given (an ungated step then does no host work for the gate);
    the gate is cleared when the ladder ends."""
    if not active_timesteps:
        yield None
        return
    if set_gate is None:
        raise ValueError("active_timesteps needs set_gate (the adapter "
                         "gate of the denoiser)")
    try:
        yield lambda t: set_gate(timestep_gate(t, active_timesteps))
    finally:
        set_gate(None)


def sample_flow_match(
    denoise_fn: Callable,            # (x, t) -> velocity
    latent_shape: Tuple[int, ...],
    schedule: FlowMatchSchedule,
    num_steps: int = 20,
    seed: int = 42,
    mu: Optional[float] = None,
    device: Optional[torch.device] = None,
    x0: Optional[torch.Tensor] = None,
    active_timesteps: Optional[Sequence[int]] = None,
    set_gate: Optional[Callable] = None,
) -> torch.Tensor:
    """Euler integration from noise; ``denoise_fn`` already folds in CFG.
    ``x0`` (batch 1 or the full batch) replaces the seeded draw."""
    x = _initial_noise(seed, latent_shape, device, x0)
    host = schedule.inference_sigmas(num_steps, mu)
    sigmas = host.to(device)
    n = schedule.num_train_timesteps
    with _gating(active_timesteps, set_gate) as gate:
        for i in range(num_steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            if gate is not None:
                gate(host[i] * n)
            t = (sigma * n).expand(latent_shape[0])
            v = denoise_fn(x, t)
            x = schedule.euler_step(x, v.to(x.dtype), sigma, sigma_next)
    return x


def cache_eval_mask(num_steps: int, cache_interval: int) -> Tuple[bool, ...]:
    """Which steps of the cached-velocity sampler call the model: steps 0
    and 1 (the extrapolation's two anchors), the last step (the ladder's
    largest interval under shift > 1) and every ``cache_interval``-th step
    in between."""
    if cache_interval <= 1:
        return tuple(True for _ in range(num_steps))
    return tuple(i < 2 or i == num_steps - 1 or i % cache_interval == 0
                 for i in range(num_steps))


def sample_flow_match_cached(
    denoise_fn: Callable,            # (x, t) -> velocity
    latent_shape: Tuple[int, ...],
    schedule: FlowMatchSchedule,
    num_steps: int = 20,
    seed: int = 42,
    mu: Optional[float] = None,
    device: Optional[torch.device] = None,
    x0: Optional[torch.Tensor] = None,
    active_timesteps: Optional[Sequence[int]] = None,
    set_gate: Optional[Callable] = None,
    cache_interval: int = 2,
) -> torch.Tensor:
    """Euler flow-match sampling with trajectory velocity caching: on a
    step :func:`cache_eval_mask` skips, the model call is replaced by the
    linear extrapolation in sigma of the two most recent evaluated
    velocities, ``v1 + (v1 - v2) (s - s1) / (s1 - s2)``, so the whole
    ``num_steps`` ladder is integrated while the model runs only on the
    evaluated steps (12 of 20 at interval 2).  Interval 1 is
    :func:`sample_flow_match`."""
    if cache_interval <= 1:
        return sample_flow_match(denoise_fn, latent_shape, schedule,
                                 num_steps, seed, mu, device, x0,
                                 active_timesteps, set_gate)
    x = _initial_noise(seed, latent_shape, device, x0)
    host = schedule.inference_sigmas(num_steps, mu)
    sigmas = host.to(device)
    n = schedule.num_train_timesteps
    mask = cache_eval_mask(num_steps, cache_interval)
    v1 = v2 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    s1 = s2 = torch.ones((), dtype=torch.float32, device=x.device)
    with _gating(active_timesteps, set_gate) as gate:
        for i in range(num_steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            if mask[i]:
                if gate is not None:
                    gate(host[i] * n)
                v = denoise_fn(x, (sigma * n).expand(latent_shape[0])
                               ).float()
                # anchors advance: (v1, s1) <- this step, (v2, s2) <- old
                v1, v2, s1, s2 = v, v1, sigma, s1
            else:
                # the ladder descends, so s1 < s2: guard the (negative)
                # denominator by magnitude, keeping its sign
                d = s1 - s2
                denom = torch.where(d.abs() < 1e-6, d.new_tensor(-1e-6), d)
                v = v1 + (v1 - v2) / denom * (sigma - s1)
            x = schedule.euler_step(x, v.to(x.dtype), sigma, sigma_next)
    return x


def sample_flux(model, schedule: FlowMatchSchedule,
                grid_hw: Tuple[int, int], text_emb: torch.Tensor,
                uncond_emb: Optional[torch.Tensor] = None,
                guidance_scale: float = 7.0, num_steps: int = 20,
                seed: int = 42, cache_interval: int = 1,
                device: Optional[torch.device] = None,
                x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-space Euler sampling of the Flux family
    (``yat_tpu/ops/sampling.py:sample_flux``): packed ``[B, h*w, C]``
    tokens with rotary ids, the sigma ladder shifted by the token count
    (``mu_for_seq_len``) under dynamic shifting, the model fed ``t / 1000``
    with the guidance embedding at ``guidance_scale``, and with
    ``uncond_emb`` true CFG by batch doubling (the guidance tiled).  The
    seeded noise is one draw tiled over the batch; ``x0`` replaces it;
    ``cache_interval > 1`` takes :func:`sample_flow_match_cached`."""
    from yat_tpu_torch.models.flux import latent_ids
    gh, gw = grid_hw
    device = device if device is not None else text_emb.device
    ids = latent_ids(gh, gw, device)
    batch = text_emb.shape[0]
    mu = (schedule.mu_for_seq_len(gh * gw)
          if schedule.use_dynamic_shifting else None)
    n = schedule.num_train_timesteps
    g = torch.full((batch,), guidance_scale, dtype=torch.float32,
                   device=device)
    cfg = uncond_emb is not None and guidance_scale > 1.0
    if cfg:
        emb2, g2 = torch.cat([uncond_emb, text_emb], 0), torch.cat([g, g], 0)

    def denoise(x, t):
        t = t / n
        if not cfg:
            return model(x, text_emb, t, ids, guidance=g)
        pred = model(torch.cat([x, x], 0), emb2, torch.cat([t, t], 0), ids,
                     guidance=g2)
        un, co = pred.chunk(2, dim=0)
        return un + guidance_scale * (co - un)

    shape = (batch, gh * gw, model.cfg.in_channels)
    if cache_interval > 1:
        return sample_flow_match_cached(denoise, shape, schedule, num_steps,
                                        seed, mu, device, x0,
                                        cache_interval=cache_interval)
    return sample_flow_match(denoise, shape, schedule, num_steps, seed, mu,
                             device, x0)


def _initial_noise(seed, latent_shape, device, x0):
    if x0 is None:
        return seed_noise(seed, latent_shape, device)
    return x0.to(device=device, dtype=torch.float32).expand(latent_shape)


def int_ladder(start: int, num: int) -> list:
    """``jnp.linspace(start, 0, num)`` truncated to int32, with the fp32
    arithmetic XLA gives that function (``start * (1 - i * (1 / (num -
    1)))``, which lands just under some integers)."""
    if num == 1:
        return [start]
    recip = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    step = torch.arange(num - 1, dtype=torch.float32) * recip
    return (start * (1 - step)).to(torch.int32).tolist() + [0]


def ddim_timesteps(schedule: DDPMSchedule, num_steps: int):
    """The integer timestep ladder from ``n - 1`` down to 0
    (:func:`int_ladder`) and each step's target (-1 after the last)."""
    ts = int_ladder(schedule.num_train_timesteps - 1, num_steps)
    return ts, ts[1:] + [-1]


def sample_ddim(
    denoise_fn: Callable,            # (x, t) -> epsilon
    latent_shape: Tuple[int, ...],
    schedule: DDPMSchedule,
    num_steps: int = 20,
    seed: int = 42,
    device: Optional[torch.device] = None,
    x0: Optional[torch.Tensor] = None,
    active_timesteps: Optional[Sequence[int]] = None,
    set_gate: Optional[Callable] = None,
) -> torch.Tensor:
    """Deterministic DDIM (eta = 0) from noise; ``denoise_fn`` already folds
    in the guidance.  ``x0`` (batch 1 or the full batch) replaces the seeded
    draw."""
    x = _initial_noise(seed, latent_shape, device, x0)
    ts, ts_prev = ddim_timesteps(schedule, num_steps)
    with _gating(active_timesteps, set_gate) as gate:
        for t, t_prev in zip(ts, ts_prev):
            if gate is not None:
                gate(t)
            eps = denoise_fn(x, torch.full((latent_shape[0],), float(t),
                                           device=x.device))
            x = schedule.ddim_step(x, eps.to(x.dtype), t, t_prev)
    return x


def _second_order(x0, prev_x0, l_t, l_prev, h):
    """The DPM-Solver++(2M) correction from the previous x0 estimate."""
    r = (l_t - l_prev) / torch.clamp(h, min=1e-8)
    c = 1.0 / (2.0 * torch.clamp(r, min=1e-8))
    return (1.0 + c) * x0 - c * prev_x0


def sample_dpm_solver_2m(
    denoise_fn: Callable,            # (x, t) -> epsilon
    latent_shape: Tuple[int, ...],
    schedule: DDPMSchedule,
    num_steps: int = 20,
    seed: int = 42,
    device: Optional[torch.device] = None,
    x0: Optional[torch.Tensor] = None,
    active_timesteps: Optional[Sequence[int]] = None,
    set_gate: Optional[Callable] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) for epsilon models, in its data-prediction
    multistep form over the integer ladder ``linspace(n - 1, 0,
    num_steps + 1)``.  As in the JAX package, the final step is first
    order at every step count (the last interval's ``h`` is the ladder's
    largest, where the second-order extrapolation would be amplified
    most)."""
    x = _initial_noise(seed, latent_shape, device, x0)
    ts = int_ladder(schedule.num_train_timesteps - 1, num_steps + 1)
    abar = schedule.alphas_cumprod().to(x.device)
    alpha = torch.sqrt(abar)
    sigma = torch.sqrt(1.0 - abar)
    lam = torch.log(alpha) - torch.log(sigma)
    prev_x0 = None
    with _gating(active_timesteps, set_gate) as gate:
        for i in range(num_steps):
            t, t_next = ts[i], max(ts[i + 1], 0)
            if gate is not None:
                gate(t)
            eps = denoise_fn(x, torch.full((latent_shape[0],), float(t),
                                           device=x.device))
            x0_hat = (x - sigma[t] * eps.to(x.dtype)) / alpha[t]
            h = lam[t_next] - lam[t]
            x0_eff = x0_hat
            if prev_x0 is not None and i < num_steps - 1:
                x0_eff = _second_order(x0_hat, prev_x0, lam[t],
                                       lam[ts[max(i - 1, 0)]], h)
            x = (sigma[t_next] / sigma[t]) * x \
                - alpha[t_next] * torch.expm1(-h) * x0_eff
            prev_x0 = x0_hat
    return x


def sample_dpm_solver_2m_flow(
    denoise_fn: Callable,            # (x, t) -> velocity (eps - x0)
    latent_shape: Tuple[int, ...],
    schedule: FlowMatchSchedule,
    num_steps: int = 20,
    seed: int = 42,
    device: Optional[torch.device] = None,
    x0: Optional[torch.Tensor] = None,
    active_timesteps: Optional[Sequence[int]] = None,
    set_gate: Optional[Callable] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) for flow-matching models.  With ``x_t = (1 - s) x0
    + s eps`` and the model predicting ``v = eps - x0``: ``x0 = x - s v``,
    ``alpha = 1 - s``, ``sigma = s``, ``lambda = log(alpha / sigma)`` (s
    clipped to [1e-6, 1 - 1e-6]); the update is ``x <- (s_next / s) x -
    (1 - s_next) expm1(-h) x0_eff``.  The final step is first order (the
    ladder ends at s = 0, where the clipped lambda makes h huge)."""
    x = _initial_noise(seed, latent_shape, device, x0)
    host = schedule.inference_sigmas(num_steps)
    sigmas = host.to(x.device)
    n = schedule.num_train_timesteps
    eps_s = 1e-6

    def lam(s):
        s = torch.clamp(s, eps_s, 1.0 - eps_s)
        return torch.log((1.0 - s) / s)

    prev_x0 = None
    with _gating(active_timesteps, set_gate) as gate:
        for i in range(num_steps):
            s, s_next = sigmas[i], sigmas[i + 1]
            if gate is not None:
                gate(host[i] * n)
            v = denoise_fn(x, (s * n).expand(latent_shape[0]))
            x0_hat = x - s * v.to(x.dtype)
            l_t = lam(s)
            h = lam(s_next) - l_t
            x0_eff = x0_hat
            if prev_x0 is not None and i < num_steps - 1:
                x0_eff = _second_order(x0_hat, prev_x0, l_t,
                                       lam(sigmas[max(i - 1, 0)]), h)
            x = (s_next / torch.clamp(s, min=eps_s)) * x \
                - (1.0 - s_next) * torch.expm1(-h) * x0_eff
            prev_x0 = x0_hat
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
