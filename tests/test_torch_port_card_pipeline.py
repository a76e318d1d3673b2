"""PyTorch port on the card: a synthesized BF16 checkpoint loaded onto the
device (every parameter its synthesized value), and DPM-Solver++(2M) and
the cached-velocity sampler on CUDA tensors against the same samplers on
the CPU.  Imports no JAX, so it runs on the card's machine:

    python -m pytest tests/test_torch_port_card_pipeline.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from tools import synth_checkpoint as S

# elementwise fp32 sampler arithmetic on two devices
CARD_SAMPLER_TOL = 1e-5
SEED = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_card_pipeline.py -m gpu "
                    "--noconftest)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_backbone_loads_from_a_bf16_file(cuda, tmp_path):
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.frontends.common import build_backbone
    from yat_tpu_torch.models.sana import SANA_TINY_TEST, SanaTransformer2D

    cfg = SANA_TINY_TEST
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  flax_params(SanaTransformer2D(cfg)).items()}
    tdir = str(tmp_path / "transformer")
    S.write_checkpoint(tdir, shapes, S.SANA_RULES, SEED, "BF16",
                       config=S.sana_config_json(cfg))
    params = TrainingParameters.from_dict({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "pretrained_model_path": tdir})
    model = build_backbone(
        lambda: SanaTransformer2D(cfg, dtype=torch.bfloat16), params,
        "sana", cfg, cuda, None, torch.bfloat16)
    for path, t in flax_params(model).items():
        assert t.device.type == "cuda" and t.dtype == torch.bfloat16
        _, kind = S.match(path, S.SANA_RULES)
        want = torch.from_numpy(S.leaf_value(SEED, path, tuple(t.shape),
                                             kind, "BF16"))
        assert torch.equal(t, want.to(cuda, t.dtype)), path


def _affine(x, t):
    a = torch.linspace(-0.6, 0.4, x.shape[-1], device=x.device)
    return a * x + 0.5 * t.float()[:, None, None, None] / 1000.0


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["dpm", "dpm_flow", "cached"])
def test_card_samplers_match_the_cpu(cuda, sampler):
    from yat_tpu_torch.ops import sampling as TS
    from yat_tpu_torch.ops.schedulers import DDPMSchedule, FlowMatchSchedule

    shape = (2, 4, 4, 3)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, *shape[1:])).astype(np.float32))
    fn, sched, kw = {
        "dpm": (TS.sample_dpm_solver_2m, DDPMSchedule(), {}),
        "dpm_flow": (TS.sample_dpm_solver_2m_flow,
                     FlowMatchSchedule(shift=3.0), {}),
        "cached": (TS.sample_flow_match_cached, FlowMatchSchedule(shift=3.0),
                   {"cache_interval": 2})}[sampler]
    out = [fn(_affine, shape, sched, 20, 42, device=dev, x0=x0, **kw).cpu()
           for dev in (torch.device("cpu"), cuda)]
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(),
                               atol=CARD_SAMPLER_TOL, rtol=CARD_SAMPLER_TOL)


# a 40x24 JPEG (gradients), so the card test needs no encoder of its own
TINY_JPEG = (
    "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQY"
    "GBcUFhYaHSUfGhsjHBYWICwgIyYnKSopGR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYa"
    "KCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCj/wAAR"
    "CAAYACgDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA"
    "AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK"
    "FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG"
    "h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl"
    "5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    "AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk"
    "NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE"
    "hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
    "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD57g0bp8taMGjf7NdvBo3T5a0YNG/2a5MF"
    "mm2pw0sd5nEQaN/s1owaN0+Wu3g0b/ZrRg0bp8tfW4LNNtT0qWO8ziING6fLRXpEGjdPlor6"
    "ejmnu7noRx2m5LBo3+zWjBo3T5aKK/m/BYiemp+Z0q0jQg0bp8taMGjf7NFFfXYLET01PTpV"
    "pGjBo3T5aKKK+no4ifLuehGtKx//2Q==")


@pytest.mark.gpu
def test_card_native_decoder_builds_and_decodes(cuda):
    """On the card's machine: build ``native/decode.cpp`` into the port's
    ``_build/`` and decode one JPEG to a bucket's size; the pixels reach
    the device as uint8.  Skips, with g++'s message, where the machine
    cannot build it (no libjpeg headers): the samplers then decode
    through cv2."""
    import base64

    from yat_tpu_torch.data import native

    if not native.available():
        pytest.skip(f"native decoder unavailable on this machine: "
                    f"{native.unavailable_reason()}")
    data = base64.b64decode(TINY_JPEG)
    assert native.jpeg_dims(data) == (24, 40)
    out, status = native.decode_batch([data, b"junk"], 32, 48)
    assert list(status != 0) == [False, True]
    assert out.dtype == np.uint8 and out.shape == (2, 32, 48, 3)
    dev = torch.as_tensor(out[:1]).to(cuda)
    assert dev.dtype == torch.uint8 and int(dev.max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dcae", "klvae"])
def test_card_vae_encoders_match_cpu(cuda, kind):
    """The tiny DC-AE and KL-VAE encoders (``encode_mode`` from uint8
    pixels normalised on the device) on the card against the CPU, fp32
    with TF32 off, within the decoders' tolerance 1e-4."""
    from yat_tpu_torch.frontends.common import u8_to_unit
    from yat_tpu_torch.models import vae as V
    from yat_tpu_torch.models.layers import init_params

    vae = (V.DCAE(V.DCAE_TINY_TEST) if kind == "dcae"
           else V.AutoencoderKL(V.KLVAE_TINY_TEST))
    init_params(vae, torch.Generator().manual_seed(SEED))
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (2, 32, 48, 3), np.uint8))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = vae.encode_mode(u8_to_unit(u8))
            got = vae.to(cuda).encode_mode(u8_to_unit(u8.to(cuda))).cpu()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
