"""chip_smoke.py's SD1.5/SDXL phases, rehearsed on the CPU at the tiny
size: serving over HTTP (4 concurrent requests and one more, the images,
the batch and the reproducibility checks; no kernel launch on the CPU),
the full-UNet gradient reference, the single-file converter, the SD1.5
training phase's configuration, and SDXL Dreambooth training with
preservation (and with ``low_vram``) as ``configs/sdxl_dreambooth.yaml``
configures it, then its extraction pass with ``pooled.npy``."""

import torch

from tests.test_torch_port_sd import TINY_SDXL
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
# three levels, attention at the deepest only: the tiny VAE's 2x latents
# of 256 px images stay cheap on the CPU
RAW_SDXL = {**TINY_SDXL, "block_out_channels": ["32", "32", "32"],
            "transformer_layers": ["0", "0", "1"]}


def test_chip_smoke_sdxl_serve_phase_on_cpu():
    """The serve phase with SDXL's pooled text and time_ids (SD1.5 takes
    the same code without them; its tiny pipeline is served in
    test_torch_port_sd.py)."""
    import chip_smoke

    # 64 px (below the bin tables' 256, set past the config's check): 8x8
    # latents, the tiny VAE's 2x decode gives 16 px images
    params = chip_smoke.serve_params(aspect_ratio="256",
                                     model_config_overrides=TINY_SDXL)
    params.bfloat16, params.aspect_ratios = False, 64
    counts = chip_smoke.phase_serve(params, CPU, "cpu", family="sdxl",
                                    px=16, window_ms=2000.0)
    assert "flash_attention" in counts and not any(counts.values())


def test_chip_smoke_unet_launch_model():
    """The launch counts the phases expect: one SD1.5 512 px forward is
    10 K6, 5 K4, 5 K2 and 12 XLA-branch calls; a training step of SDXL's
    Dreambooth config (3 forwards, 2 backwards) at 1024 px is 210 K6 and
    140 K6b; the UNets' transformer blocks, 16 and 70."""
    import chip_smoke
    from yat_tpu_torch.models.unet import SD15_UNET, SDXL_UNET

    one = chip_smoke.unet_launches(SD15_UNET, (64, 64))
    assert (one["flash_attention"], one["dot_product_attention_folded"],
            one["dot_product_attention"], one["attention_xla"],
            one["flash_attention_bwd"]) == (10, 5, 5, 12, 0)
    step = chip_smoke.unet_launches(SDXL_UNET, (128, 128), passes=(3, 2))
    assert (step["flash_attention"], step["flash_attention_bwd"],
            step["dot_product_attention_bwd"],
            step["dot_product_attention_folded_bwd"]) == (210, 140, 120, 20)
    assert chip_smoke.unet_blocks(SD15_UNET) == 16
    assert chip_smoke.unet_blocks(SDXL_UNET) == 70


def test_chip_smoke_sd15_grad_reference_and_single_file_on_cpu():
    import chip_smoke

    over = {"block_out_channels": (32, 64), "layers_per_block": 1,
            "transformer_layers": (1, 1), "cross_attention_dim": 32,
            "num_heads": 2}
    chip_smoke.phase_sd15_grad_reference(CPU, over, side=8)
    chip_smoke.phase_single_file(CPU, "cpu", over)


def test_chip_smoke_sd15_train_config_is_the_shipped_one(tmp_path):
    """The SD1.5 training phase runs ``configs/sd15_single_file_lora.yaml``
    as written but for its files: the raw shards for ``/data/raw``, no
    single file, 6 steps (its entry point trains on the fly in
    ``test_torch_port_sd.py``)."""
    import yaml

    import chip_smoke

    with open(f"{chip_smoke.REPO}/configs/sd15_single_file_lora.yaml") as f:
        shipped = yaml.safe_load(f)
    cfg = chip_smoke.sd15_train_config(["a.tar"], str(tmp_path))
    assert "pretrained_pipe_single_file" not in cfg
    assert cfg["local_shard_paths"] == ["a.tar"] and cfg["steps"] == "6"
    for key in ("batch_size", "lora_rank", "lora_target_modules",
                "train_unconditional_prob", "compute_features",
                "validation_prompts", "aspect_ratio", "bfloat16"):
        want = shipped[key]
        assert cfg[key] == (want if isinstance(want, list) else str(want))


def test_chip_smoke_sdxl_train_phase_on_cpu(monkeypatch):
    """The SDXL phase: Dreambooth with preservation as configured, then
    with ``low_vram`` (one step each at the tiny size), each with its
    launch checks, then the extraction pass with ``pooled.npy``.  The tiny
    VAE takes a third level (compression 4): the 256 px images' latents
    are 64x64, where the two-level VAE's 128x128 grid makes its mid-block
    attention 16384 tokens long on the CPU."""
    import dataclasses

    import chip_smoke
    from yat_tpu_torch.models import vae

    monkeypatch.setattr(vae, "KLVAE_TINY_TEST", dataclasses.replace(
        vae.KLVAE_TINY_TEST, block_out_channels=(32, 32, 32)))
    out = chip_smoke.phase_sdxl_train(CPU, "cpu", tiny=RAW_SDXL)
    assert set(out) == {"sdxl train", "sdxl train low_vram"}
    assert not any(v for c in out.values() for v in c.values())
