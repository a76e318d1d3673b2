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
