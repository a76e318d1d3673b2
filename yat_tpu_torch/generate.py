"""Standalone generation CLI: build the family's sampling pipeline, sample
images for a prompt list, write PNGs.

Counterpart of ``yat_tpu/generate.py`` on the PyTorch port:

    python -m yat_tpu_torch.generate --family sana|pixart \
        --config config.yaml --prompt "a red fox in snow" \
        --prompt "a lighthouse at dusk" --steps 20 --guidance-scale 5.0 \
        --out generated/ [--device cuda]

The port serves with random weights until checkpoint loading is ported.
"""

from __future__ import annotations

import importlib
import os
from typing import Optional

import numpy as np

FAMILIES = {
    "sana": "yat_tpu_torch.frontends.sana",
    "pixart": "yat_tpu_torch.frontends.pixart",
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


def refuse_unported(sampler: Optional[str] = None,
                    cache_interval: Optional[int] = None) -> None:
    """Raise for sampling options this slice of the port does not implement
    (DPM-Solver++(2M), the velocity cache), so that none is silently
    ignored; 'auto' and interval 1 are the family's own ladder (flow-match
    Euler for SANA, DDIM for PixArt-Sigma)."""
    if sampler is not None and sampler not in ("auto", "dpm"):
        raise ValueError(f"unknown sampler {sampler!r}; use auto|dpm")
    if sampler == "dpm":
        raise ValueError("sampler='dpm' (DPM-Solver++(2M)) is not "
                         "implemented in the PyTorch port yet (ROADMAP queue "
                         "1, item 7); use auto")
    if cache_interval is not None and int(cache_interval) < 1:
        raise ValueError("cache interval must be >= 1 (1 = full ladder, "
                         "no velocity caching)")
    if cache_interval is not None and int(cache_interval) > 1:
        raise ValueError("cache interval > 1 (velocity caching) is not "
                         "implemented in the PyTorch port yet; use 1")


def configure_pipeline(vp, steps=None, guidance_scale=None,
                       seed=None) -> None:
    """Apply the CLI's sampling settings to the pipeline."""
    if steps is not None:
        vp.num_steps = int(steps)
    if guidance_scale is not None:
        vp.guidance_scale = float(guidance_scale)
    if seed is not None:
        vp.seed = int(seed)


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
    # refuse unsupported options before building the models
    refuse_unported(sampler, cache_interval)
    vp = mod.make_pipeline(params, device)
    configure_pipeline(vp, steps, guidance_scale, seed)
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
                   help="only auto (the family's own ladder) is ported")
    p.add_argument("--cache-interval", type=int, default=None,
                   help="only 1 (no velocity cache) is ported")
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
