"""Standalone generation CLI: build the family's sampling pipeline, sample
images for a prompt list, write PNGs.

Counterpart of ``yat_tpu/generate.py`` on the PyTorch port:

    python -m yat_tpu_torch.generate --family sana|pixart|sd15|sdxl|sd35|flux \
        --config config.yaml --prompt "a red fox in snow" \
        --prompt "a lighthouse at dusk" --steps 20 --guidance-scale 5.0 \
        [--sampler auto|dpm] [--cache-interval N] --out generated/ \
        [--device cuda]

The YAML is a training config: ``pretrained_pipe_path`` (a diffusers
pipeline directory) or ``pretrained_model_path`` decides what weights
load; without them the modules are random from ``dataset_seed``.
``lora_pretrained`` (a trained adapter of any kind, or a PEFT file)
rides on the denoiser, built from the config's ``lora_*`` keys.
``--sampler dpm`` selects DPM-Solver++(2M); ``--cache-interval N`` (flow
families: SANA, SD3.5, Flux) evaluates the denoiser on every Nth step and
extrapolates the velocity in between.  Flux samples with its own guidance embedding
beside true CFG and has no DPM ladder (``--sampler dpm`` raises).
"""

from __future__ import annotations

import importlib
import os
from typing import Optional

import numpy as np

FAMILIES = {
    "sana": "yat_tpu_torch.frontends.sana",
    "pixart": "yat_tpu_torch.frontends.pixart",
    "sd15": "yat_tpu_torch.frontends.sd15",
    "sdxl": "yat_tpu_torch.frontends.sdxl",
    "sd35": "yat_tpu_torch.frontends.sd35",
    "flux": "yat_tpu_torch.frontends.flux",
}


def family_module(family: str):
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} is not ported to PyTorch yet; "
                         f"available: {sorted(FAMILIES)}")
    return importlib.import_module(FAMILIES[family])


def png_bytes(img: np.ndarray) -> tuple:
    """Encode [H, W, 3] float [0, 1] → (bytes, content_type); cv2 → PIL →
    raw .npy fallback chain."""
    import io
    arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    try:
        import cv2
        ok, buf = cv2.imencode(".png", arr[..., ::-1])   # RGB → BGR
        if ok:
            return bytes(buf), "image/png"
    except Exception:  # noqa: BLE001 — try the next encoder
        pass
    try:
        from PIL import Image
        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, format="PNG")
        return bio.getvalue(), "image/png"
    except Exception:  # noqa: BLE001 — fall back to raw .npy
        bio = io.BytesIO()
        np.save(bio, arr)
        return bio.getvalue(), "application/x-npy"


def write_png(path: str, img: np.ndarray) -> str:
    """img: [H, W, 3] float in [0, 1]; returns the written path (a .npy
    sibling when no PNG encoder is available)."""
    data, ctype = png_bytes(img)
    if ctype != "image/png":
        path = os.path.splitext(path)[0] + ".npy"
    with open(path, "wb") as f:
        f.write(data)
    return path


def configure_pipeline(vp, steps=None, guidance_scale=None, seed=None,
                       sampler=None, cache_interval=None) -> None:
    """Apply the CLI's sampling settings to the pipeline; the sampler and
    the velocity cache go through their gates
    (``train/validation.py:set_sampler``, ``set_cache_interval``)."""
    from yat_tpu_torch.train.validation import (set_cache_interval,
                                                set_sampler)
    if steps is not None:
        vp.num_steps = int(steps)
    if guidance_scale is not None:
        vp.guidance_scale = float(guidance_scale)
    if seed is not None:
        vp.seed = int(seed)
    if sampler is not None:
        set_sampler(vp, sampler)
    if cache_interval is not None:
        set_cache_interval(vp, cache_interval)


def generate(params, family: str, prompts: list,
             steps: Optional[int] = None,
             guidance_scale: Optional[float] = None,
             seed: Optional[int] = None,
             sampler: Optional[str] = None,
             cache_interval: Optional[int] = None,
             output_dir: str = "generated", device=None) -> dict:
    """Build the family pipeline, sample, write files.  Returns
    {written_path: prompt}."""
    mod = family_module(family)
    vp = mod.make_pipeline(params, device)
    configure_pipeline(vp, steps, guidance_scale, seed, sampler,
                       cache_interval)
    images = vp(list(prompts))                   # {key: [H, W, 3] float}
    os.makedirs(output_dir, exist_ok=True)
    written = {}
    for idx, (key, img) in enumerate(images.items()):
        prompt = key.split("/", 2)[-1]
        path = write_png(os.path.join(output_dir, f"{idx:03d}.png"),
                         np.asarray(img))
        written[path] = prompt
    with open(os.path.join(output_dir, "prompts.txt"), "w") as f:
        for path, prompt in written.items():
            f.write(f"{os.path.basename(path)}\t{prompt}\n")
    return written


def main(argv: Optional[list] = None) -> None:
    import argparse

    from yat_tpu_torch.config import TrainingParameters

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--family", default="sana", choices=sorted(FAMILIES))
    p.add_argument("--prompt", action="append", required=True,
                   help="repeatable")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sampler", default=None, choices=("auto", "dpm"),
                   help="auto: the family's ladder (flow-match Euler, "
                        "DDIM); dpm: DPM-Solver++(2M) (not flux)")
    p.add_argument("--cache-interval", type=int, default=None,
                   help="flow families: evaluate the denoiser every Nth "
                        "step and extrapolate the velocity in between")
    p.add_argument("--out", default="generated", dest="out")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    params = TrainingParameters.read_yaml(args.config)
    written = generate(params, args.family, args.prompt, steps=args.steps,
                       guidance_scale=args.guidance_scale, seed=args.seed,
                       sampler=args.sampler,
                       cache_interval=args.cache_interval,
                       output_dir=args.out, device=args.device)
    for path, prompt in written.items():
        print(f"{path}  <-  {prompt}")


if __name__ == "__main__":
    main()
