#!/usr/bin/env python3
"""Where the device memory of ``configs/pixart_repa.yaml``'s on-the-fly
run goes, on the card.

    python3 tools/repa_memory.py [--device cuda|cpu]

Builds the run of ``chip_smoke.py`` phase 12 (e) through
``yat_tpu_torch.frontends.pixart.make_trainer`` (PixArt-Sigma XL-2 with
LoKr on an int8 base, T5-XXL, the SD KL-VAE, a random DINOv2 ViT-B/14; batch
8, chunks of 8) on the seeded JPEGs of phase 12, then measures, each from
a reset of the allocator's peak: the resident weights; one call of each
encoder on one batch (the KL-VAE encoder on a chunk of 8 at the batch's
bucket, T5-XXL on 8 captions, DINOv2 on 8 images); one training step on
that batch with no encoder running beside it; and the run of 3 steps
through the trainer, whose feature cache encodes the next batches while
the step runs.  Prints each peak in GiB beside the card's name and power
limit.  ``--device cpu`` rehearses the control flow at the tiny sizes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    import torch

    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import pixart

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    card = chip_smoke.phase_device() if cuda else "cpu"
    tiny = None if cuda else {
        "pixart": {"hidden_dim": "32", "num_layers": "1",
                   "num_attention_heads": "2", "attention_head_dim": "16",
                   "caption_channels": "32", "max_caption_len": "8",
                   "mlp_ratio": "1.0", "in_channels": "4",
                   "out_channels": "4", "sample_size": "8",
                   "vae_compression": "2", "tiny_encoders": "1"},
        "resolution": 256, "batch": 2}
    gib = 2.0 ** 30

    def peak_of(label, fn):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            chip_smoke.log(f"memory [{card}]: {label}: peak "
                           f"{peak / gib:.2f} GiB ({(peak - base) / gib:.2f} "
                           f"above the {base / gib:.2f} GiB resident)")
        return out

    with tempfile.TemporaryDirectory() as tmp, \
            chip_smoke.working_dir(tmp):
        raw, _ = chip_smoke.write_raw_shards(tmp, 4 if tiny else 16,
                                             scale=0.5 if tiny else 1.0)
        cfg = chip_smoke.pixart_otf_config(raw, os.path.join(tmp, "out"),
                                           int(tiny["batch"]) if tiny else 8,
                                           tiny)
        params = TrainingParameters.from_dict(cfg)
        trainer = peak_of("building the trainer",
                          lambda: pixart.make_trainer(params, device=device))
        trainer.initialize()
        if cuda:
            chip_smoke.log(f"memory [{card}]: resident after initialize "
                           f"(PixArt int8 + LoKr, T5-XXL, KL-VAE, DINOv2): "
                           f"{torch.cuda.memory_allocated() / gib:.2f} GiB")
        cache = trainer.sampler
        images = next(iter(cache.sampler.image_sampler))
        chunk = int(cfg["vae_max_batch_size"])
        peak_of(f"the KL-VAE encoder, {chunk} images at "
                f"{images.images.shape[1]}x{images.images.shape[2]}",
                lambda: trainer.encode_images(images.images[:chunk]))
        peak_of(f"T5-XXL, {chunk} captions",
                lambda: trainer.encode_captions(images.captions[:chunk]))
        peak_of(f"DINOv2 ViT-B/14, {len(images.images)} images",
                lambda: trainer.encode_repa(images.images))
        batch = cache.sampler._encode_batch(images)
        device_batch = trainer._device_batch(batch)
        gen = torch.Generator(device=device).manual_seed(5)
        peak_of("one training step, no encoder beside it",
                lambda: trainer._step_fn(device_batch, gen))
        trainer.params.steps = 3
        peak_of("3 steps through the trainer, the cache encoding beside "
                "them", trainer.run)


if __name__ == "__main__":
    main()
