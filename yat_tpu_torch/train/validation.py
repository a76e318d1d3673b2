"""Text-to-image sampling pipeline: encode prompts, sample, decode.

Counterpart of ``yat_tpu/train/validation.py``: prompts are encoded (with
an optional prompt transform), a batch-1 unconditional caption is encoded
once per call and tiled, the caption K/V of every block is projected once
per request batch (context-K/V cache; not under PAG or refiner gating),
the CFG-batched denoiser (with a perturbed-attention-guidance call when
``pag_scale`` > 0) runs the family's ladder, keeping the first
``pred_slice`` channels of a learned-sigma prediction, and the VAE
decodes.  Images come back as ``{"validation/{i}/{prompt}": [H, W, 3]
float in [0, 1]}``.

The ladder (``sampler``, ``cache_interval``): ``auto`` is flow-match
Euler on a flow-match schedule (the velocity cache at ``cache_interval`` >
1) and DDIM on a DDPM one; ``dpm`` is DPM-Solver++(2M) in the schedule's
form.  ``set_sampler``, ``set_cache_interval`` and
``apply_cache_interval`` are the one gate every entry point goes through.
``active_timesteps`` gates the denoiser's adapters per step.
:meth:`ValidationPipeline.validate` samples a trainer's validation prompts
on the EMA copies of its trainable leaves when it keeps them (swapped in,
then restored and checked).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from yat_tpu_torch.models.layers import set_adapter_gate
from yat_tpu_torch.ops.sampling import (
    make_cfg_denoiser,
    make_pag_cfg_denoiser,
    sample_ddim,
    sample_dpm_solver_2m,
    sample_dpm_solver_2m_flow,
    sample_flow_match,
    sample_flow_match_cached,
)
from yat_tpu_torch.ops.schedulers import DDPMSchedule, FlowMatchSchedule


def validation_prompt_groups(params, prompts):
    """Yield ``(start, group)`` chunks of prompts: 1 at a time under
    ``low_vram``, else up to ``validation_batch`` prompts (default 4;
    0 = all) per sampling run."""
    if getattr(params, "low_vram", False):
        chunk = 1
    else:
        chunk = int(getattr(params, "validation_batch", 4)) or len(prompts)
    for start in range(0, len(prompts), max(1, chunk)):
        yield start, prompts[start:start + max(1, chunk)]


def tile_batch(x, p: int):
    """Tile leading batch-1 tensors (or every batch-1 leaf of a dict) to
    batch ``p``."""
    if isinstance(x, dict):
        return {k: tile_batch(v, p) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.ndim > 0 and x.shape[0] == 1 and p > 1:
        return x.repeat_interleave(p, dim=0)
    return x


def set_cache_interval(vp, cache_interval: int) -> None:
    """The one velocity-cache gate (generate, serve and the trainer's
    ``validation_cache_interval`` key go through it): interval 1 is the
    full ladder, below 1 raises, above 1 needs a pipeline that supports
    the cache (flow-match Euler with no refiner timestep gating: a gated
    adapter's active steps could land only on skipped steps)."""
    ci = int(cache_interval)
    if ci < 1:
        raise ValueError("cache interval must be >= 1 (1 = full ladder, "
                         "no velocity caching)")
    if ci == 1:
        return
    if not getattr(vp, "supports_velocity_cache", False):
        raise ValueError(
            "cache interval > 1 requires a flow-match family with the "
            "default Euler sampler and no refiner timestep gating")
    vp.cache_interval = ci


def set_sampler(vp, sampler: str) -> None:
    """The one sampler-selection gate: 'auto' keeps the pipeline's
    default ladder, 'dpm' selects DPM-Solver++(2M)."""
    if sampler not in ("auto", "dpm"):
        raise ValueError(f"unknown sampler {sampler!r}; use auto|dpm")
    if sampler == "auto":
        return
    if not getattr(vp, "supports_dpm", False):
        raise ValueError("sampler='dpm' is not supported by this family's "
                         "pipeline")
    vp.sampler = sampler


def apply_cache_interval(params, vp) -> None:
    """Apply the ``validation_cache_interval`` key to a validation
    pipeline (the trainer calls it before its first step, so a key the
    pipeline cannot honour fails at step 0)."""
    set_cache_interval(
        vp, int(getattr(params, "validation_cache_interval", 1) or 1))


class ValidationPipeline:
    """Bundles denoiser + schedule + encoders/decoder into one callable,
    ``pipeline(prompts) -> {tag: image}``; :meth:`validate` is the
    trainer's ``validate_fn``."""

    # set_sampler's gate: this pipeline routes sampler='dpm'
    supports_dpm = True

    def __init__(
        self,
        model,                                # a denoiser module
        schedule,                             # FlowMatch- or DDPMSchedule
        latent_shape,                         # (H, W, C) for one image
        encode_prompts: Callable[[List[str]], Dict[str, torch.Tensor]],
        decode_latents: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        guidance_scale: float = 5.0,
        num_steps: int = 20,
        seed: int = 42,
        prompt_transform: Optional[Callable[[str], str]] = None,
        params=None,
        device: Optional[torch.device] = None,
        pag_scale: float = 0.0,
        pred_slice: Optional[int] = None,
        sampler: str = "auto",
        active_timesteps: Optional[Sequence[int]] = None,
        cache_interval: int = 1,
    ):
        if not isinstance(schedule, (FlowMatchSchedule, DDPMSchedule)):
            raise ValueError("the PyTorch port samples flow-match and DDPM "
                             f"schedules, got {type(schedule).__name__}")
        self.model = model
        self.schedule = schedule
        self.latent_shape = tuple(latent_shape)
        self.encode_prompts = encode_prompts
        self.decode_latents = decode_latents
        self.guidance_scale = guidance_scale
        self.num_steps = num_steps
        self.seed = seed
        self.prompt_transform = prompt_transform
        self.params = params
        self.device = device
        self.pag_scale = pag_scale
        self.pred_slice = pred_slice
        if sampler not in ("auto", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}; "
                             "expected 'auto' or 'dpm'")
        self.sampler = sampler
        self.active_timesteps = (tuple(active_timesteps)
                                 if active_timesteps else None)
        self.cache_interval = 1
        set_cache_interval(self, cache_interval)

    @property
    def supports_velocity_cache(self) -> bool:
        # not under refiner gating: a skipped step never sets its gate
        return (self.sampler != "dpm"
                and isinstance(self.schedule, FlowMatchSchedule)
                and self.active_timesteps is None)

    def sample_latents(self, cond: Dict, uncond: Dict,
                       x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = (cond["embeddings"].shape[0], *self.latent_shape)
        if (getattr(self.model, "supports_context_cache", False)
                and self.pag_scale == 0.0
                and self.active_timesteps is None):
            # the caption embeddings are constant across every denoise
            # step: project each block's caption K/V once per request (not
            # under PAG, whose perturbed call runs the full model, nor
            # under refiner gating, whose per-step gate may change the K/V
            # projections' adapters, as in the JAX package)
            cond, uncond = dict(cond), dict(uncond)
            for branch in (cond, uncond):
                branch["cached_ctx_kv"] = self.model(
                    None, branch["embeddings"], None, branch.get("text_mask"),
                    return_ctx_kv=True)

        def apply_fn(x, timesteps, **kw):
            out = self.model(x, kw.pop("embeddings"), timesteps,
                             kw.pop("text_mask", None), **kw)
            if self.pred_slice is not None:
                # learned-sigma models: keep the epsilon half
                out = out[..., :self.pred_slice]
            return out

        if self.pag_scale > 0.0:
            denoise = make_pag_cfg_denoiser(apply_fn, cond, uncond,
                                            self.guidance_scale,
                                            self.pag_scale)
        else:
            denoise = make_cfg_denoiser(apply_fn, cond, uncond,
                                        self.guidance_scale)
        flow = isinstance(self.schedule, FlowMatchSchedule)
        kw = dict(device=self.device, x0=x0,
                  active_timesteps=self.active_timesteps,
                  set_gate=lambda g: set_adapter_gate(self.model, g))
        if self.sampler == "dpm":
            sample = sample_dpm_solver_2m_flow if flow \
                else sample_dpm_solver_2m
        elif flow and self.cache_interval > 1:
            sample = sample_flow_match_cached
            kw["cache_interval"] = self.cache_interval
        else:
            sample = sample_flow_match if flow else sample_ddim
        return sample(denoise, shape, self.schedule, self.num_steps,
                      self.seed, **kw)

    def validate(self, trainer, x0: Optional[torch.Tensor] = None
                 ) -> Dict[str, np.ndarray]:
        """The trainer's validation: its ``validation_prompts``, on the EMA
        copies of the trainable leaves when the trainer keeps them (the
        live leaves are swapped out for the call and restored after it;
        the restore is checked)."""
        prompts = list(trainer.params.validation_prompts or [])
        ema = getattr(trainer, "ema", None)
        if not prompts or ema is None:
            return self(prompts, x0)
        leaves = trainer.trainable_leaves()
        if len(leaves) != len(ema):
            raise ValueError(f"{len(ema)} EMA copies for {len(leaves)} "
                             "trainable leaves")
        saved = [p.detach().clone() for p in leaves]
        with torch.no_grad():
            for p, e in zip(leaves, ema):
                p.copy_(e)
        try:
            return self(prompts, x0)
        finally:
            with torch.no_grad():
                for p, live in zip(leaves, saved):
                    p.copy_(live)
            if not all(torch.equal(p, live) for p, live in zip(leaves,
                                                                saved)):
                raise RuntimeError("the live trainable leaves were not "
                                   "restored after the EMA validation")

    @staticmethod
    def to_unit(img: np.ndarray) -> np.ndarray:
        """An image in [0, 1]: a signed one (decoded, in [-1, 1]) maps
        through ``(x + 1) / 2``."""
        return np.clip((img + 1) / 2 if img.min() < -0.01 else img, 0, 1)

    @torch.inference_mode()
    def __call__(self, prompts: List[str],
                 x0: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
        """Sample every prompt (in chunks of ``validation_batch``); ``x0``
        replaces the seeded initial noise (batch 1, tiled)."""
        prompts = list(prompts)
        if not prompts:
            return {}
        images: Dict[str, np.ndarray] = {}
        uncond1 = self.encode_prompts([""] * 1)
        for start, group in validation_prompt_groups(self.params, prompts):
            enhanced = [self.prompt_transform(p) if self.prompt_transform
                        else p for p in group]
            cond = tile_batch(self.encode_prompts(enhanced), len(group))
            uncond = tile_batch(uncond1, len(group))
            latents = self.sample_latents(cond, uncond, x0)
            decoded = None
            if self.decode_latents is not None:
                decoded = self.decode_latents(latents).float().cpu().numpy()
            for j, prompt in enumerate(group):
                if decoded is not None:
                    img = decoded[j]
                else:
                    # no decoder: visualize first three latent channels
                    lat = latents[j].float().cpu().numpy()
                    img = lat[..., :3]
                    img = (img - img.min()) / (img.max() - img.min() + 1e-8)
                images[f"validation/{start + j}/{prompt}"] = self.to_unit(img)
        return images


# SANA prompt enhancement: the complex-human-instruction preamble prepended
# to each prompt before Gemma encoding.
COMPLEX_HUMAN_INSTRUCTION = "\n".join([
    "Given a user prompt, generate an 'Enhanced prompt' that provides "
    "detailed visual descriptions suitable for image generation. Evaluate "
    "the level of detail in the user prompt:",
    "- If the prompt is simple, focus on adding specifics about colors, "
    "shapes, sizes, textures, and spatial relationships to create vivid "
    "and concrete scenes.",
    "- If the prompt is already detailed, refine and enhance the existing "
    "details slightly without overcomplicating.",
    "Here are examples of how to transform or refine prompts:",
    "- User Prompt: A cat sleeping -> Enhanced: A small, fluffy white cat "
    "curled up in a round shape, sleeping peacefully on a warm sunny "
    "windowsill, surrounded by pots of blooming red flowers.",
    "- User Prompt: A busy city street -> Enhanced: A bustling city street "
    "scene at dusk, featuring glowing street lamps, a diverse crowd of "
    "people in colorful clothing, and a double-decker bus passing by "
    "towering glass skyscrapers.",
    "Please generate only the enhanced description for the prompt below "
    "and avoid including any additional commentary or evaluations:",
    "User Prompt: ",
])


def enhance_prompt(prompt: str) -> str:
    """complex_human_instruction + prompt."""
    return COMPLEX_HUMAN_INSTRUCTION + prompt
