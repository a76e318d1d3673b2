"""PyTorch port, REPA on the CPU, against the JAX package on the same
weights and inputs: the DINOv2 encoder (forward, the antialiased bicubic
preprocessing at the four 512 px buckets, the converter on a synthesized
``dinov2_vitb14`` file, and the published ``pos_embed`` that fits neither
package), the projection heads and both branches of the alignment loss,
PixArt-Sigma's tap and ``resnet_expansion``, SANA's capture of a target
module with and without remat, one trainer step of each family with REPA
(PixArt-Sigma: LoKr on an int8 base with Lion-8bit; SANA: LoHa with the
generic head), and a tiny on-the-fly run of each family through its entry
point.

Tolerances: fp32 forwards 1e-5 and gradients 1e-4 of the reference's
largest entry; the step's loss and grad_norm 1e-5 relative."""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_adapters import _close, _flat, _nest, _np, \
    _trained
from yat_tpu_torch.convert import flax_params, load_flax_adapters, \
    load_flax_params
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synth_checkpoint  # noqa: E402

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
METRIC_RTOL = 1e-5


def _seeded(module, seed=0):
    from yat_tpu_torch.models.layers import init_params
    init_params(module, torch.Generator().manual_seed(seed))
    return module


@functools.lru_cache(maxsize=None)
def _dino(cfg_name="tiny"):
    from yat_tpu_torch.models.dinov2 import DINOV2_TINY_TEST, DinoV2
    model = _seeded(DinoV2(DINOV2_TINY_TEST), 4)
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.ndim == 1 and p.shape[0] == 32:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                         .manual_seed(p.numel())))
    return model


def test_dinov2_forward_matches_jax():
    from yat_tpu.models.dinov2 import DINOV2_TINY_TEST as JC
    from yat_tpu.models.dinov2 import DinoV2 as JD

    model = _dino()
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 3)).astype(
        np.float32)
    want = jax.jit(JD(cfg=JC).apply)({"params": _nest(flax_params(model))},
                                     jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 4, 32)
    _close(got.numpy(), np.asarray(want), FWD_TOL)


@pytest.mark.parametrize("hw,size", [((512, 512), 224), ((448, 576), 224),
                                     ((576, 448), 224), ((352, 704), 224),
                                     ((16, 16), 28), ((24, 40), 28)])
def test_preprocess_for_dino_matches_jax(hw, size):
    """The antialiased bicubic resize agrees with ``jax.image.resize``'s
    (down- and upscaling); the default, unantialiased one would not."""
    import torch.nn.functional as F

    from yat_tpu.models.dinov2 import preprocess_for_dino as jpre
    from yat_tpu_torch.models.dinov2 import preprocess_for_dino

    x = np.random.default_rng(1).uniform(-1, 1, (1, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jpre(jnp.asarray(x), size=size))
    got = preprocess_for_dino(torch.from_numpy(x), size=size).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if hw[0] > size:
        plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2) / 2
                              + 0.5, size=(size, size), mode="bicubic",
                              align_corners=False).permute(0, 2, 3, 1)
        mean = torch.tensor((0.485, 0.456, 0.406))
        std = torch.tensor((0.229, 0.224, 0.225))
        assert np.abs(((plain - mean) / std).numpy() - want).max() > 0.05


def test_convert_dinov2_file_and_pos_embed_misfit(tmp_path):
    """A ``.pth`` in the published keys (fused qkv, LayerScale gammas, a
    ``mask_token``) loads into both packages alike; the published
    ``pos_embed`` grid (37x37 + cls at ViT-B/14) does not fit the 224 px
    model, and both packages raise naming both shapes."""
    from yat_tpu.models.convert import load_torch_state_dict as jload
    from yat_tpu.models.convert import merge_into as jmerge
    from yat_tpu.models.dinov2 import DINOV2_TINY_TEST as JC
    from yat_tpu.models.dinov2 import DinoV2 as JD
    from yat_tpu.models.dinov2 import convert_dinov2 as jconvert
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.common import build_dino_encoder

    fits = str(tmp_path / "dinov2_fits.pth")
    synth_checkpoint.write_bin(fits, synth_checkpoint.dinov2_state_dict(
        32, 2, grid=2, seed=3))
    raw = {"batch_size": "1", "learning_rate": "1e-3", "steps": "1",
           "num_steps_per_validation": "1", "dataset_seed": "0",
           "model_config_overrides": {"tiny_encoders": "1"},
           "repa_pretrained_model": fits}
    encode = build_dino_encoder(TrainingParameters.from_dict(raw), "cpu")
    jtree = jmerge(_np(_nest(flax_params(_dino()))),
                   jconvert(jload(fits), 2))
    px = np.random.default_rng(2).integers(0, 255, (2, 40, 56, 3), np.uint8)
    from yat_tpu.models.dinov2 import preprocess_for_dino as jpre
    want = jax.jit(lambda v, x: JD(cfg=JC).apply(v, jpre(x, size=28)))(
        {"params": jtree}, jnp.asarray(px, jnp.float32) / 127.5 - 1.0)
    _close(encode(px), np.asarray(want), FWD_TOL)
    assert encode.grid_hw == (2, 2)

    misfit = str(tmp_path / "dinov2_vitb14.pth")
    synth_checkpoint.write_bin(misfit, synth_checkpoint.dinov2_state_dict(
        32, 2, grid=synth_checkpoint.DINOV2_PUBLISHED_GRID, seed=3))
    with pytest.raises(ValueError, match=r"pos_embed.*\(1, 1370, 32\).*"
                                         r"\(1, 5, 32\)"):
        build_dino_encoder(TrainingParameters.from_dict(
            {**raw, "repa_pretrained_model": misfit}), "cpu")
    with pytest.raises(ValueError, match=r"pos_embed.*\(1, 1370, 32\).*"
                                         r"\(1, 5, 32\)"):
        jmerge(jtree, jconvert(jload(misfit), 2))


def test_repa_heads_and_alignment_loss_match_jax(tmp_path):
    """``RepaMLP`` (and its bundle, read by the JAX package), PixArt's
    ``RepaProjector`` and both branches of ``repa_alignment_loss``: token
    counts that differ are mean-pooled, equal ones compared token-wise."""
    from yat_tpu.models.pixart import RepaProjector as JP
    from yat_tpu.ops.repa import RepaConfig as JRC
    from yat_tpu.ops.repa import RepaMLP as JM
    from yat_tpu.ops.repa import load_repa_bundle as jload_bundle
    from yat_tpu.train.tasks import repa_alignment_loss as jloss
    from yat_tpu_torch.models.pixart import RepaProjector
    from yat_tpu_torch.ops.repa import (RepaConfig, init_repa_head,
                                        load_repa_bundle, save_repa_bundle)
    from yat_tpu_torch.train.tasks import repa_alignment_loss

    rng = np.random.default_rng(0)
    cfg = RepaConfig(target_modules=("blocks_0",), target_shape=24,
                     hidden_shape=40)
    head = init_repa_head(cfg, 32, 7)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    want = jax.jit(JM(JRC(("blocks_0",), 24, 40)).apply)(
        {"params": _nest(flax_params(head))}, jnp.asarray(x))
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), FWD_TOL)
    save_repa_bundle(str(tmp_path / "b"), cfg, head)
    jcfg, jparams = jload_bundle(str(tmp_path / "b"), 32)
    assert jcfg == JRC(("blocks_0",), 24, 40)
    for n, v in _flat(jparams):
        np.testing.assert_array_equal(v, flax_params(head)[n].numpy())
    assert load_repa_bundle(str(tmp_path / "b"), 32)[0] == cfg

    proj = _seeded(RepaProjector(32, hidden=48, out_dim=24), 2)
    want = jax.jit(JP(hidden=48, out_dim=24).apply)(
        {"params": _nest(flax_params(proj))}, jnp.asarray(x))
    with torch.no_grad():
        _close(proj(torch.from_numpy(x)).numpy(), np.asarray(want), FWD_TOL)

    for n_target in (16, 4):
        t = rng.standard_normal((2, n_target, 24)).astype(np.float32)
        p = got.numpy()
        np.testing.assert_allclose(
            float(repa_alignment_loss(got, torch.from_numpy(t))),
            float(jloss(jnp.asarray(p), jnp.asarray(t))), rtol=FWD_TOL)
    assert float(repa_alignment_loss(got, got[:, :4])) > 0


def _pixart(over, repa=False, remat=False):
    """The tiny PixArt-Sigma of ``over`` in both packages, on the port's
    seeded weights, and one batch."""
    from yat_tpu.models.pixart import PIXART_TINY_TEST
    from yat_tpu.models.pixart import PixArtTransformer2D as JM
    from yat_tpu_torch.models.pixart import PixArtConfig, \
        PixArtTransformer2D

    cfg = dataclasses.replace(PIXART_TINY_TEST, **over)
    model = _seeded(PixArtTransformer2D(
        PixArtConfig(**dataclasses.asdict(cfg)), dtype=torch.float32,
        gradient_checkpointing=remat, repa=repa), 1)
    rng = np.random.default_rng(0)
    b, cap = 2, cfg.max_caption_len
    mask = np.ones((b, cap), np.int32)
    mask[0, 5:] = 0
    args = [rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
            rng.standard_normal((b, cap, cfg.caption_channels)).astype(
                np.float32),
            np.array([100.0, 800.0], np.float32), mask]
    return JM(cfg=cfg, dtype=jnp.float32), model, args


def test_pixart_repa_tap_matches_jax():
    """The tap after block ``repa_depth`` 0: the prediction and the fp32
    projection beside it."""
    jm, model, args = _pixart({"repa_depth": 0}, repa=True)
    want, wproj = jax.jit(functools.partial(jm.apply, return_repa=True))(
        {"params": _nest(flax_params(model))}, *map(jnp.asarray, args))
    with torch.no_grad():
        got, proj = model(*map(torch.from_numpy, args), return_repa=True)
    assert proj.dtype == torch.float32 and proj.shape == (2, 16, 768)
    _close(got.numpy(), np.asarray(want), FWD_TOL)
    _close(proj.numpy(), np.asarray(wproj), FWD_TOL)


def test_pixart_resnet_expansion_matches_jax():
    """The conv-residual branch: forward, and the gradients of every
    parameter (``out_alpha`` and the convs included)."""
    jm, model, args = _pixart({"resnet_expansion": True,
                               "resnet_alpha_init": 0.3})
    params = _nest(flax_params(model))

    def jloss(p):
        pred = jm.apply({"params": p}, *map(jnp.asarray, args))
        return jnp.mean(pred ** 2), pred
    (jl, jpred), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    pred = model(*map(torch.from_numpy, args))
    pred.pow(2).mean().backward()
    _close(pred.detach().numpy(), np.asarray(jpred), FWD_TOL)
    jgrads = dict(_flat(jax.device_get(jg)))
    from yat_tpu_torch.convert import flax_named_parameters
    assert any("resnet_branch.out_alpha" in n for n in jgrads)
    for name, p in flax_named_parameters(model):
        g = p.grad
        if name.endswith(".kernel"):
            g = g.t() if g.ndim == 2 else g.permute(2, 3, 1, 0)
        _close(g.numpy(), jgrads[name], GRAD_TOL)


def test_sana_capture_matches_jax_with_and_without_remat():
    """The generic capture of ``blocks_0``: the features equal the JAX
    package's ``capture_features``; with remat the hooks capture each
    forward once, so the REPA loss and its gradients equal those without
    remat."""
    from yat_tpu.models.sana import SANA_TINY_TEST
    from yat_tpu.models.sana import SanaTransformer2D as JM
    from yat_tpu.ops.repa import RepaConfig as JRC
    from yat_tpu.ops.repa import capture_features as jcap
    from yat_tpu_torch.models.sana import SanaConfig, SanaTransformer2D
    from yat_tpu_torch.ops.repa import (RepaConfig, capture_features,
                                        generic_repa_loss, init_repa_head)

    cfg = dataclasses.replace(SANA_TINY_TEST, num_layers=2)
    rng = np.random.default_rng(0)
    args = [rng.standard_normal((2, 8, 8, cfg.in_channels)).astype(
                np.float32),
            rng.standard_normal((2, 8, cfg.caption_channels)).astype(
                np.float32),
            np.array([100.0, 800.0], np.float32), np.ones((2, 8), np.int32)]
    dino = torch.randn(2, 4, 24, generator=torch.Generator().manual_seed(3))
    rcfg = RepaConfig(("blocks_0",), target_shape=24, hidden_shape=40)
    head = init_repa_head(rcfg, cfg.hidden_dim, 7)
    out = {}
    for remat in (False, True):
        model = _seeded(SanaTransformer2D(
            SanaConfig(**dataclasses.asdict(cfg)), dtype=torch.float32,
            gradient_checkpointing=remat), 1)
        head.zero_grad()
        with capture_features(model, rcfg) as feats:
            pred = model(*map(torch.from_numpy, args))
        loss = generic_repa_loss(feats, head, dino) + pred.pow(2).mean()
        loss.backward()
        out[remat] = (feats, loss.item(), [p.grad.clone() for p in
                                           model.parameters()] +
                      [p.grad.clone() for p in head.parameters()])
    jfeats = jax.jit(lambda v, *a: jcap(
        JM(cfg=cfg, dtype=jnp.float32), v, JRC(("blocks_0",)), args=a)[1])(
        {"params": _nest(flax_params(model))}, *map(jnp.asarray, args))
    assert len(jfeats) == len(out[False][0]) == len(out[True][0]) == 1
    for remat in (False, True):
        _close(out[remat][0][0].detach().numpy(), np.asarray(jfeats[0]),
               FWD_TOL)
    assert out[False][1] == out[True][1]
    for a, b in zip(out[False][2], out[True][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _step_both(jvars, adapters, meta, batch, jloss, draws_of, trainer,
               raw, qbits=None, head=None):
    """One step of the JAX package's jitted step (its optimizer from
    ``raw``) and of the port's ``trainer`` (built on the same weights, its
    adapters carried over) on the JAX draws; the metrics compared.
    Returns the JAX state and the port's gradients before the step."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.ops.quant import quantize_params
    from yat_tpu.train.state import create_train_state, make_optimizer
    from yat_tpu.train.step import make_train_step as j_make_step
    from yat_tpu_torch.train.step import loss_and_grads

    params = jvars["params"]
    scales = None
    # jitted whole: eager, each op compiles on its own
    if qbits:
        params, scales = jax.jit(functools.partial(
            quantize_params, bits=qbits))(params)
    jad = dict(adapters, repa_head=head) if head is not None else adapters
    tx = make_optimizer(JParams.from_dict({**raw, "urls": []}))
    state = jax.jit(lambda p, a, s: create_train_state(
        p, tx, adapters=a, adapters_meta=meta, quant_scales=s))(
            params, jad, scales)
    sub = jax.random.PRNGKey(42)
    _, rng_noise = jax.random.split(sub)
    state, jm = jax.jit(j_make_step(task_loss=jloss, tx=tx, donate=False))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, sub)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    draws = draws_of(rng_noise, batch["latents"])
    _, grads = loss_and_grads(trainer.task_loss, trainer.trainable_leaves(),
                              tbatch, torch.Generator(), draws)
    tm = trainer._step_fn(tbatch, torch.Generator(), draws)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=METRIC_RTOL, err_msg=key)
    return state, grads


_RAW = {"batch_size": "2", "learning_rate": "1e-3", "steps": "1",
        "num_steps_per_validation": "100", "validation_prompts": [],
        "warmup_steps": "0", "weight_decay": "0.01",
        "train_unconditional_prob": "0", "lora_rank": "4", "lora_alpha": "8",
        "lora_target_modules": ["to_q", "to_k", "to_v", "to_out"],
        "dataset_seed": "0", "use_repa": "true", "repa_lambda": "0.5"}


def _check_leaves(trainer, state, grads, lion):
    """Every trainable leaf after the step against the JAX state's (Lion:
    an entry whose gradient is within the tolerance of 0 may step the
    other way)."""
    want = dict(_flat(jax.device_get(state.adapters)))
    names = trainer.trainable_names()
    assert set(names) == set(want)
    for name, p, g in zip(names, trainer.trainable_leaves(), grads):
        got, g = p.detach().numpy(), g.numpy()
        if name.endswith(".kernel"):
            got, g = got.T, g.T
        if not lion:
            _close(got, want[name], 1e-4)
            continue
        off = np.abs(got - want[name]) > 1e-6
        tiny = np.abs(g) <= GRAD_TOL * float(np.abs(g).max())
        assert not (off & ~tiny).any(), name


def test_pixart_lokr_int8_repa_step_matches_jax(tmp_path, monkeypatch):
    """``configs/pixart_repa.yaml``'s trainer at the tiny size: LoKr on an
    int8 base, Lion-8bit, REPA through the projector after block 0 (which
    the base quantization makes int8 too): the step's loss and grad_norm
    and every LoKr leaf after it agree with the JAX package's; the
    projector stays as it was."""
    from tests.test_torch_port_pixart_train import _jax_draws
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.ops.schedulers import DDPMSchedule as JS
    from yat_tpu.train.tasks import make_epsilon_loss
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import pixart

    monkeypatch.chdir(tmp_path)
    over = {"hidden_dim": 64, "attention_head_dim": 32, "repa_depth": 0,
            "num_layers": 1}
    jm, model, _ = _pixart(over, repa=True)
    jvars = {"params": _nest(flax_params(model))}
    adapters, meta = build_adapter_params(
        jvars, AdapterSpec("lokr", rank=4, alpha=8,
                           target_modules=["to_q", "to_k", "to_v", "to_out"]),
        jax.random.PRNGKey(3))
    adapters = _trained(adapters)
    rng = np.random.default_rng(5)
    batch = {"latents": rng.standard_normal((2, 8, 8, 4), np.float32),
             "embeddings": rng.standard_normal((2, 8, 16), np.float32),
             "text_mask": np.ones((2, 8), np.int32),
             "repa_features": rng.standard_normal((2, 4, 768), np.float32)}
    extra = {"lora_algo": "lokr", "lora_base_model_8bit": "true",
             "use_adamw_8bit": "true",
             "model_config_overrides": {k: str(v) for k, v in {
                 **over, "num_attention_heads": 2,
                 "caption_channels": 16, "max_caption_len": 8,
                 "sample_size": 8, "mlp_ratio": 1.0}.items()}}
    raw = {**_RAW, **extra, "output_dir": str(tmp_path / "out")}
    trainer = pixart.make_trainer(TrainingParameters.from_dict(raw),
                                  sampler=[], device="cpu",
                                  weights={"transformer": _np(jvars["params"])})
    load_flax_adapters(trainer.model, _np(adapters), _np(meta))
    trainer.initialize()
    proj = trainer.model.repa_projector
    assert proj.fc1.qweight is not None
    before = [t.clone() for t in proj.state_dict().values()]
    jsched = JS()
    state, grads = _step_both(
        jvars, adapters, meta, batch,
        make_epsilon_loss(jm, jsched, learned_sigma=True, repa_lambda=0.5),
        lambda rng, lat: _jax_draws(jsched, rng, lat), trainer, raw, qbits=8)
    _check_leaves(trainer, state, grads, lion=True)
    for a, b in zip(before, proj.state_dict().values()):
        assert torch.equal(a, b)


def test_sana_loha_generic_repa_step_matches_jax(tmp_path, monkeypatch):
    """SANA's trainer with LoHa and generic REPA on ``blocks_0`` (the
    head trains beside the adapters under ``repa_head``, AdamW): the
    step's loss and grad_norm and every leaf after it, the head's
    included, agree with the JAX package's."""
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.models.sana import SANA_TINY_TEST
    from yat_tpu.models.sana import SanaTransformer2D as JM
    from yat_tpu.ops.repa import RepaConfig as JRC
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JS
    from yat_tpu.train.tasks import make_flow_matching_loss
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import sana
    from yat_tpu_torch.models.sana import SanaConfig, SanaTransformer2D
    from yat_tpu_torch.ops import repa as TR

    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(SANA_TINY_TEST, num_layers=2)
    model = _seeded(SanaTransformer2D(SanaConfig(**dataclasses.asdict(cfg)),
                                      dtype=torch.float32), 1)
    jvars = {"params": _nest(flax_params(model))}
    adapters, meta = build_adapter_params(
        jvars, AdapterSpec("loha", rank=4, alpha=8,
                           target_modules=["to_q", "to_k", "to_v", "to_out"]),
        jax.random.PRNGKey(3))
    adapters = _trained(adapters)
    head = TR.init_repa_head(TR.RepaConfig(("blocks_0",), 32),
                             cfg.hidden_dim, 11)
    jhead = _nest(flax_params(head))
    init = TR.init_repa_head

    def carried(rcfg, dim, seed, device="cpu"):
        h = init(rcfg, dim, seed, device)
        load_flax_params(h, _np(jhead))
        return h
    monkeypatch.setattr(sana, "init_repa_head", carried)
    rng = np.random.default_rng(5)
    batch = {"latents": rng.standard_normal((2, 8, 8, cfg.in_channels),
                                            np.float32),
             "embeddings": rng.standard_normal((2, 8, cfg.caption_channels),
                                               np.float32),
             "text_mask": np.ones((2, 8), np.int32),
             "repa_features": rng.standard_normal((2, 16, 32), np.float32)}
    over = {k: str(v) for k, v in dataclasses.asdict(cfg).items()
            if not isinstance(v, tuple) and v is not None}
    extra = {"lora_algo": "loha", "repa_target_modules": ["blocks_0"],
             "model_config_overrides": {**over, "tiny_encoders": "1"}}
    raw = {**_RAW, **extra, "output_dir": str(tmp_path / "out")}
    trainer = sana.make_trainer(TrainingParameters.from_dict(raw),
                                sampler=[], device="cpu",
                                weights={"transformer": _np(jvars["params"])})
    load_flax_adapters(trainer.model, _np(adapters), _np(meta))
    trainer.initialize()
    jsched = JS(shift=3.0)

    def draws_of(rng_noise, latents):
        k_t, k_n, _ = jax.random.split(rng_noise, 3)
        ts, sig = jsched.training_draw(k_t, latents.shape[0])
        return {"timesteps": torch.from_numpy(np.array(ts)),
                "sigmas": torch.from_numpy(np.array(sig)),
                "noise": torch.from_numpy(np.array(jax.random.normal(
                    k_n, latents.shape, jnp.float32)))}
    jloss = make_flow_matching_loss(JM(cfg=cfg, dtype=jnp.float32), jsched,
                                    repa_lambda=0.5,
                                    repa_cfg=JRC(("blocks_0",), 32))
    state, grads = _step_both(jvars, adapters, meta, batch, jloss,
                               draws_of, trainer, raw, head=jhead)
    _check_leaves(trainer, state, grads, lion=False)


@pytest.mark.parametrize("family", ["sana", "pixart"])
def test_entry_point_trains_on_the_fly_with_repa(tmp_path, monkeypatch,
                                                 family):
    """Two steps of each family through its entry point on raw images
    encoded on the fly with the tiny encoders and a random tiny DINOv2
    (the configured file is missing, as in ``configs/pixart_repa.yaml``):
    every batch carries the DINO tokens, the loss is finite, the REPA term
    moves it, and the trainable leaves change (SANA's head too; PixArt's
    projector does not)."""
    import yaml

    from tests.test_torch_port_encode import TINY_PIXART, TINY_SANA, \
        make_image_shard
    from yat_tpu_torch.frontends import pixart, sana
    from yat_tpu_torch.train import tasks

    shard = make_image_shard(tmp_path / "raw.tar", n=4, wide=False)
    over = dict(TINY_SANA if family == "sana" else TINY_PIXART)
    if family == "pixart":
        # the projector's width is the model's, not DINO's: the tiny
        # encoder's tokens are 32 wide
        over.update(repa_depth="0", repa_target_dim="32")
    cfg = {"local_shard_paths": [shard], "batch_size": "2",
           "learning_rate": "1e-3", "steps": "2", "warmup_steps": "0",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "output_dir": str(tmp_path / "models"), "compute_features": "1",
           "vae_max_batch_size": "1", "text_encoder_max_batch_size": "2",
           "cache_size": "4", "aspect_ratio": "256", "lora_rank": "4",
           "lora_alpha": "4", "lora_algo": "lokr" if family == "pixart"
           else "loha", "lora_target_modules": ["to_q", "to_k", "to_v",
                                                "to_out"],
           "use_repa": "true", "repa_lambda": "0.5",
           "repa_pretrained_model": str(tmp_path / "missing.pth"),
           "model_config_overrides": over}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    seen = []
    align = tasks.repa_alignment_loss

    def spy(p, t):
        seen.append((tuple(t.shape), float(align(p, t))))
        return align(p, t)
    monkeypatch.setattr(tasks, "repa_alignment_loss", spy)
    monkeypatch.chdir(tmp_path)
    mod = sana if family == "sana" else pixart
    trainer = mod.main(["--config", str(path), "--device", "cpu"])
    assert trainer.global_step == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert len(seen) >= 2 and all(s == (2, 4, 32) and v > 0
                                  for s, v in seen)
    if family == "sana":
        assert trainer.repa_head is not None
    else:
        assert trainer.repa_head is None
        assert trainer.model.repa_projector is not None
    exports = os.listdir(tmp_path / "models")
    assert exports
