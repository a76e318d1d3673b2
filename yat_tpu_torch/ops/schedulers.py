"""Noise schedules and the training timestep density.

Counterpart of ``yat_tpu/ops/schedulers.py``:

* :class:`FlowMatchSchedule` (diffusers ``FlowMatchEulerDiscreteScheduler``
  parity): sigmas are a shifted linear ramp, the noisy input is
  ``(1 - sigma) x + sigma eps``, the model predicts the velocity
  ``eps - x``, and sampling integrates it with Euler steps;
* :class:`DDPMSchedule` (diffusers ``DDPMScheduler`` parity): the betas,
  the cumulative alphas, the training half (noising with sqrt(abar) and
  sqrt(1 - abar) rounded to the latents' dtype, integer timesteps from the
  logit-normal density or a fixed list, epsilon and v-prediction targets)
  and the deterministic DDIM step that sampling takes.

Training draws come from a ``torch.Generator``; they cannot reproduce
``jax.random``'s numbers, so tests hand both sides the same draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


def _expand_to(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-pad trailing singleton dims so x broadcasts over a batch."""
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def sample_timestep_density(gen: torch.Generator, batch_size: int,
                            weighting_scheme: str = "logit_normal",
                            logit_mean: float = 0.0, logit_std: float = 1.0,
                            mode_scale: float = 1.29) -> torch.Tensor:
    """Draw u in (0, 1) controlling which sigma each sample trains at
    (diffusers ``compute_density_for_timestep_sampling``), fp32 on the
    generator's device."""
    dev = gen.device
    if weighting_scheme == "logit_normal":
        z = torch.randn((batch_size,), generator=gen, device=dev)
        return torch.sigmoid(z * logit_std + logit_mean)
    if weighting_scheme == "mode":
        u = torch.rand((batch_size,), generator=gen, device=dev)
        return 1.0 - u - mode_scale * (torch.cos(math.pi * u / 2.0) ** 2
                                       - 1.0 + u)
    if weighting_scheme == "uniform":
        return torch.rand((batch_size,), generator=gen, device=dev)
    raise ValueError(f"unknown weighting scheme {weighting_scheme!r}")


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    num_train_timesteps: int = 1000
    shift: float = 3.0
    use_dynamic_shifting: bool = False
    base_shift: float = 0.5       # Flux dynamic-shift line endpoints
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096

    def _shifted(self, t: torch.Tensor, mu: Optional[float]) -> torch.Tensor:
        if self.use_dynamic_shifting:
            if mu is None:
                mu = math.log(self.shift)
            e = math.exp(mu)
            return e / (e + (1.0 / t - 1.0))
        return self.shift * t / (1.0 + (self.shift - 1.0) * t)

    def sigmas(self, mu: Optional[float] = None) -> torch.Tensor:
        n = self.num_train_timesteps
        t = torch.linspace(1.0, 1.0 / n, n, dtype=torch.float32)
        return self._shifted(t, mu)

    def mu_for_seq_len(self, seq_len: int) -> float:
        """Flux-style resolution-dependent shift exponent."""
        m = (self.max_shift - self.base_shift) / (
            self.max_image_seq_len - self.base_image_seq_len)
        b = self.base_shift - m * self.base_image_seq_len
        return seq_len * m + b

    def timesteps(self, mu: Optional[float] = None) -> torch.Tensor:
        return self.sigmas(mu) * self.num_train_timesteps

    def euler_step(self, sample: torch.Tensor, velocity: torch.Tensor,
                   sigma: torch.Tensor, sigma_next: torch.Tensor
                   ) -> torch.Tensor:
        """One Euler integration step for inference."""
        return sample + (sigma_next - sigma) * velocity

    def inference_sigmas(self, num_steps: int, mu: Optional[float] = None
                         ) -> torch.Tensor:
        """Sigma ladder for sampling: num_steps+1 fp32 values ending at 0
        (on the CPU; callers move it to their device)."""
        n = self.num_train_timesteps
        t = torch.linspace(1.0, 1.0 / n, num_steps, dtype=torch.float32)
        return torch.cat([self._shifted(t, mu),
                          torch.zeros((1,), dtype=torch.float32)])

    def training_draw(self, gen: torch.Generator, batch_size: int,
                      weighting_scheme: str = "logit_normal",
                      logit_mean: float = 0.0, logit_std: float = 1.0,
                      mode_scale: float = 1.29,
                      timestep_list: Optional[Sequence[int]] = None,
                      mu: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(timesteps, sigmas) for a training batch, fp32 on the generator's
        device: the density → an index into the sigma table, or a uniform
        choice from ``timestep_list`` (refiner mode)."""
        n = self.num_train_timesteps
        sig = self.sigmas(mu).to(gen.device)
        if timestep_list:
            choice = torch.randint(0, len(timestep_list), (batch_size,),
                                   generator=gen, device=gen.device)
            indices = torch.tensor(list(timestep_list),
                                   device=gen.device)[choice]
        else:
            u = sample_timestep_density(gen, batch_size, weighting_scheme,
                                        logit_mean, logit_std, mode_scale)
            indices = (u * n).to(torch.int64)
        sigmas = sig[indices.clamp(0, n - 1)]
        return sigmas * n, sigmas

    def add_noise(self, latents: torch.Tensor, noise: torch.Tensor,
                  sigmas: torch.Tensor) -> torch.Tensor:
        """x_sigma = (1 - sigma) x + sigma eps, in the latents' dtype."""
        s = _expand_to(sigmas.to(latents.dtype), latents.ndim)
        return (1.0 - s) * latents + s * noise

    def velocity_target(self, latents: torch.Tensor, noise: torch.Tensor
                        ) -> torch.Tensor:
        """target = eps - x."""
        return noise - latents


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Classic DDPM cumulative-alpha schedule: scaled-linear betas from
    0.00085 to 0.012 over 1000 steps (SD1.5, SDXL, PixArt-Sigma).  The
    tables are fp32 on the CPU; callers move them to their device."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"

    def betas(self) -> torch.Tensor:
        n = self.num_train_timesteps
        if self.beta_schedule == "linear":
            return torch.linspace(self.beta_start, self.beta_end, n,
                                  dtype=torch.float32)
        if self.beta_schedule == "scaled_linear":
            return torch.linspace(self.beta_start ** 0.5,
                                  self.beta_end ** 0.5, n,
                                  dtype=torch.float32) ** 2
        if self.beta_schedule == "squaredcos_cap_v2":
            steps = torch.arange(n + 1, dtype=torch.float32) / n
            alpha_bar = torch.cos((steps + 0.008) / 1.008 * math.pi / 2) ** 2
            return torch.clamp(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0.0,
                               0.999)
        raise ValueError(f"unknown beta schedule {self.beta_schedule!r}")

    def alphas_cumprod(self) -> torch.Tensor:
        return torch.cumprod(1.0 - self.betas(), dim=0)

    def _sqrt_abar(self, latents: torch.Tensor, timesteps: torch.Tensor):
        """sqrt(abar_t) and sqrt(1 - abar_t), fp32 then rounded to the
        latents' dtype, shaped to broadcast over them."""
        abar = self.alphas_cumprod().to(latents.device)[timesteps.long()]
        return (_expand_to(torch.sqrt(abar).to(latents.dtype), latents.ndim),
                _expand_to(torch.sqrt(1.0 - abar).to(latents.dtype),
                           latents.ndim))

    def add_noise(self, latents: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(abar_t) x + sqrt(1 - abar_t) eps."""
        sqrt_abar, sqrt_1m = self._sqrt_abar(latents, timesteps)
        return sqrt_abar * latents + sqrt_1m * noise

    def training_draw(self, gen: torch.Generator, batch_size: int,
                      weighting_scheme: str = "logit_normal",
                      logit_mean: float = 0.0, logit_std: float = 1.0,
                      mode_scale: float = 1.29,
                      timestep_list: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
        """int32 timesteps for a training batch on the generator's device:
        the density (the same as flow matching's) times the step count,
        clipped to [0, N - 1], or a uniform choice from ``timestep_list``."""
        dev = gen.device
        if timestep_list:
            choice = torch.randint(0, len(timestep_list), (batch_size,),
                                   generator=gen, device=dev)
            return torch.tensor(list(timestep_list), dtype=torch.int32,
                                device=dev)[choice]
        u = sample_timestep_density(gen, batch_size, weighting_scheme,
                                    logit_mean, logit_std, mode_scale)
        n = self.num_train_timesteps
        return (u * n).to(torch.int32).clamp(0, n - 1)

    def target(self, latents: torch.Tensor, noise: torch.Tensor,
               timesteps: torch.Tensor) -> torch.Tensor:
        """The prediction's target: eps, or v = sqrt(abar) eps -
        sqrt(1 - abar) x."""
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            sqrt_abar, sqrt_1m = self._sqrt_abar(latents, timesteps)
            return sqrt_abar * noise - sqrt_1m * latents
        raise ValueError(f"unknown prediction type {self.prediction_type!r}")

    def ddim_step(self, sample: torch.Tensor, eps_pred: torch.Tensor,
                  t: int, t_prev: int) -> torch.Tensor:
        """Deterministic DDIM update (eta = 0) from integer timestep ``t``
        to ``t_prev`` (-1 past the last step), in the sample's dtype."""
        abar = self.alphas_cumprod()
        a_t = abar[int(t)].to(sample.dtype)
        a_prev = (abar[int(t_prev)] if t_prev >= 0
                  else torch.tensor(1.0)).to(sample.dtype)
        a_t, a_prev = a_t.to(sample.device), a_prev.to(sample.device)
        x0 = (sample - torch.sqrt(1.0 - a_t) * eps_pred) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps_pred
