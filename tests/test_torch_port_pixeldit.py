"""PyTorch port, PixelDiT on the CPU, against ``yat_tpu`` on the same numpy
inputs and weights: the DiT block with and without cross-attention; the
whole tiny model with its REPA tap and its K1 sites; the pixel stage's
self-attention at a token count that is no multiple of 128 (the port
calls K6/K6b directly where the JAX model's gate takes
``jax.nn.dot_product_attention``); the kernel calls of a forward and of a
LoRA step; ``convert_pixeldit`` on synthesized ``.safetensors`` and
``.pth`` files and the missing-file error; the hub fetch with a stand-in
``huggingface_hub``; one 4-bit REPA LoRA step against the JAX step on its
draws; the DPM CFG 4.0 validation batch against the JAX pipeline; the
entry point training from raw images on the fly; ``serve`` and
``generate`` with ``--family pixeldit``; ``chip_smoke.py``'s PixelDiT
phases rehearsed.

Tolerances as the JAX tests pin them: fp32 modules 2e-5 and their VJPs
2e-4; the adaLN norm 1e-6 forward, 1e-4 backward; gradients 1e-4 of the
largest entry; images 1e-3."""

import dataclasses
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import tools.synth_checkpoint as S
from tests.test_torch_port_adapters import _close, _flat, _nest, _np, \
    _trained
from tests.test_torch_port_unet import numpy_params
from yat_tpu_torch.convert import (flax_params, load_flax_adapters,
                                   load_flax_params)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

FWD_TOL = 2e-5
VJP_TOL = 2e-4
NORM_FWD_TOL = 1e-6
NORM_BWD_TOL = 1e-4
GRAD_TOL = 1e-4
IMAGE_TOL = 1e-3
TARGETS = ["to_q", "to_k", "to_v", "to_out"]
# the tiny PixelDiT at the tiny Gemma's width (32) with its REPA tap after
# block 0 projecting to the tiny DINOv2's width (32)
TINY_PIXELDIT = {"patch_size": "8", "pixel_patch": "2", "hidden_dim": "32",
                 "pixel_hidden_dim": "16", "num_layers": "2",
                 "num_pixel_layers": "1", "num_heads": "2",
                 "caption_channels": "32", "max_caption_len": "8",
                 "mlp_ratio": "1.0", "repa_depth": "0",
                 "repa_target_dim": "32", "tiny_encoders": "1"}
# the same with 16 px patches and 8 px pixel tokens, for runs at the 256
# px bins: 256 patch tokens, 1024 pixel tokens at 256x256, 972 at the
# 432x144 bucket (8 px patches of 2 px pixel tokens would give 16384)
TINY_256 = {**TINY_PIXELDIT, "patch_size": "16", "pixel_patch": "8"}


def _port_cfg(cfg_j):
    from yat_tpu_torch.models.pixeldit import PixelDiTConfig
    return PixelDiTConfig(**dataclasses.asdict(cfg_j))


def _vjp_close(port_fn, jax_fn, args, cot, tol_fwd, tol_vjp):
    """``port_fn`` and ``jax_fn`` on the same numpy ``args``: the outputs
    within ``tol_fwd`` and every input's VJP of the cotangent ``cot``
    within ``tol_vjp``."""
    def both(cot, *xs):
        out, vjp = jax.vjp(jax_fn, *xs)
        return out, vjp(cot)
    # one compiled program (eager flax compiles op by op)
    want, wgrads = jax.jit(both)(jnp.asarray(cot), *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = port_fn(*leaves)
    _close(got.detach().numpy(), np.asarray(want), tol_fwd)
    got.backward(torch.from_numpy(cot))
    for leaf, w in zip(leaves, wgrads):
        _close(leaf.grad.numpy(), np.asarray(w), tol_vjp)


@pytest.mark.parametrize("cross", [True, False], ids=["patch", "pixel"])
def test_dit_block_matches_jax(cross):
    """A patch block (cross-attention over a masked 8-token caption, 12
    tokens) and a pixel block (no cross-attention, 200 tokens: no
    multiple of 128, so the port's direct K6 runs two key blocks, the last
    of 72), every leaf (the zero-initialised modulation too) drawn from
    numpy: fp32 forward 2e-5, the VJP of x and the conditioning 2e-4.  The
    pixel block's self-attention goes through ``flash_attention``."""
    import yat_tpu.models.pixeldit as J
    import yat_tpu_torch.models.pixeldit as P
    from yat_tpu_torch.models import layers

    d, h, n = (32, 2, 12) if cross else (16, 1, 200)
    jb = J.DiTBlock(hidden_dim=d, num_heads=h, mlp_ratio=1.0,
                    dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n, d), np.float32)
    cond = rng.standard_normal((2, d), np.float32)
    ctx = rng.standard_normal((2, 8, d), np.float32) if cross else None
    mask = np.array([[1] * 8, [1] * 3 + [0] * 5], np.int32) if cross \
        else None
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0), x, cond, ctx,
                            mask)
    params = numpy_params(shapes["params"], 2)
    blk = P.DiTBlock(d, h, 1.0, cross=cross, flash=not cross,
                     dtype=torch.float32)
    load_flax_params(blk, _np(params))
    assert set(flax_params(blk)) == set(S.leaf_shapes(params))
    calls = []
    real = layers.flash_attention
    layers.flash_attention = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        _vjp_close(
            lambda xt, ct: blk(xt, ct, None if ctx is None else
                               torch.from_numpy(ctx),
                               None if mask is None else
                               torch.from_numpy(mask)),
            lambda xj, cj: jb.apply({"params": params}, xj, cj, ctx, mask),
            (x, cond), rng.standard_normal((2, n, d), np.float32), FWD_TOL,
            VJP_TOL)
    finally:
        layers.flash_attention = real
    assert calls == ([] if cross else [(2, n, h, d // h)])


def test_pixel_attention_at_unaligned_length_matches_jax():
    """The pixel stage's attention, ``flash_attention`` at 4 heads of 64
    over 330 tokens (two key blocks of 128 and one of 74), against
    ``jax.nn.dot_product_attention``, which the JAX model's gate takes at
    such a length: fp32 forward 2e-5, the VJP of q, k and v 2e-4."""
    from yat_tpu_torch.ops.attention import flash_attention

    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((2, 330, 4, 64), np.float32)
                  for _ in range(4))
    want, vjp = jax.vjp(jax.nn.dot_product_attention, *map(jnp.asarray,
                                                          (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = flash_attention(*leaves)
    _close(got.detach().numpy(), np.asarray(want), FWD_TOL)
    got.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, vjp(jnp.asarray(g))):
        _close(leaf.grad.numpy(), np.asarray(w), VJP_TOL)


@functools.lru_cache(maxsize=None)
def _tiny(hidden=32, num_layers=2):
    """The JAX tiny PixelDiT with its projector (a tap after block 0), its
    numpy parameters (the modulation drawn) and one batch: 16x24 pixels
    (2x3 patch tokens, 96 pixel tokens), a masked 8-token caption."""
    import yat_tpu.models.pixeldit as J

    cfg = dataclasses.replace(J.PIXELDIT_TINY_TEST, hidden_dim=hidden,
                              num_layers=num_layers, repa_target_dim=32)
    jm = J.PixelDiT(cfg=cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batch = {"latents": rng.uniform(-1, 1, (2, 16, 24, 3)).astype(
        np.float32),
        "embeddings": rng.standard_normal((2, 8, 16), np.float32),
        "text_mask": np.array([[1] * 8, [1] * 3 + [0] * 5], np.int32)}
    shapes = jax.eval_shape(functools.partial(jm.init, return_repa=True),
                            jax.random.PRNGKey(0), batch["latents"],
                            batch["embeddings"], jnp.zeros((2,)),
                            batch["text_mask"])
    return cfg, jm, numpy_params(shapes["params"], 4), batch


def test_pixeldit_matches_jax(monkeypatch):
    """The whole tiny model (patch embed, 2 patch blocks with the tap
    after block 0, token expansion, a pixel block, the affine-free
    ``norm_out``, unpatchify) under ``return_repa``: the prediction and
    the fp32 projection 2e-5; the port's leaves are the JAX tree's, one
    for one.  Each of its 6 K1 sites (``adaln_layernorm``, at widths 32
    and 16) against the JAX function on the inputs it got: 1e-6 forward,
    the VJP 1e-4."""
    from yat_tpu.ops.norm import adaln_layernorm as j_adaln
    import yat_tpu_torch.models.pixeldit as P
    from yat_tpu_torch.ops.norm import adaln_layernorm

    cfg, jm, params, batch = _tiny()
    t = np.array([100.0, 800.0], np.float32)
    args = (batch["latents"], batch["embeddings"], t, batch["text_mask"])
    want, wproj = jax.jit(functools.partial(jm.apply, return_repa=True))(
        {"params": params}, *args)
    model = P.PixelDiT(_port_cfg(cfg), dtype=torch.float32, repa=True)
    load_flax_params(model, _np(params))
    assert set(flax_params(model)) == set(S.leaf_shapes(params))
    sites = []
    monkeypatch.setattr(P, "adaln_layernorm", lambda x, sc, sh: sites.append(
        tuple(a.detach().numpy() for a in (x, sc, sh))) or adaln_layernorm(
            x, sc, sh))
    with torch.no_grad():
        got, proj = model(*map(torch.from_numpy, args), return_repa=True)
    assert proj.dtype == torch.float32 and proj.shape == (2, 6, 32)
    _close(got.numpy(), np.asarray(want), FWD_TOL)
    _close(proj.numpy(), np.asarray(wproj), FWD_TOL)
    assert [s[0].shape for s in sites] == [(2, 6, 32)] * 4 + [(2, 96, 16)] * 2
    rng = np.random.default_rng(8)
    for x, sc, sh in sites:
        _vjp_close(adaln_layernorm, j_adaln, (x, sc, sh),
                   rng.standard_normal(x.shape).astype(np.float32),
                   NORM_FWD_TOL, NORM_BWD_TOL)


def test_kernel_calls_list_each_forward_and_step(monkeypatch):
    """``kernel_calls`` names every gated attention, direct K6 call and K1
    call of a forward in order (a tiny model's, recorded), and at 512 px
    full size: 24 self-attentions over 1024 tokens (K6 through the gate)
    and 24 cross-attentions over 300 keys (K4), 4 pixel self-attentions
    over 16384 tokens in 4 heads of 64, 56 norms.  A LoRA step runs the
    backward of every attention and every norm but block 0's first,
    whose inputs are all frozen (recorded at the tiny size), as
    ``chip_smoke``'s launch model gives at full size."""
    import chip_smoke
    from yat_tpu_torch.adapters.builder import AdapterSpec, \
        build_adapter_params
    from yat_tpu_torch.models import layers, pixeldit
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.ops import attention as A
    from yat_tpu_torch.ops import norm as N

    cfg = dataclasses.replace(pixeldit.PIXELDIT_TINY_TEST, num_layers=3,
                              num_pixel_layers=2)
    seen = {"dot_product_attention": [], "flash_attention": [],
            "adaln_layernorm": []}
    for mod, name in ((layers, "dot_product_attention"),
                      (layers, "flash_attention"),
                      (pixeldit, "adaln_layernorm")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            shape = tuple(a[0].shape)
            if _name == "dot_product_attention":
                shape = shape[:2] + (a[1].shape[1],) + shape[2:]
            seen[_name].append(shape)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    bwd = {"adaln": 0, "flash": 0, "softmax": 0}
    for mod, name, key in ((N, "adaln_bwd_ref", "adaln"),
                           (A, "flash_attention_bwd_ref", "flash"),
                           (A, "attention_bwd_ref", "softmax")):
        real = getattr(mod, name)

        def counting(*a, _real=real, _key=key, **kw):
            bwd[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counting)
    model = pixeldit.PixelDiT(cfg, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with chip_smoke.drawn_modulation():
        init_params(model, gen)
    for p in model.parameters():
        p.requires_grad_(False)
    n_adapted = build_adapter_params(model, AdapterSpec(
        "lora", rank=2, alpha=2, target_modules=TARGETS), gen)
    assert n_adapted == chip_smoke.pixeldit_adapted(cfg) == 8 * 3 + 4 * 2
    out = model(torch.rand(2, 16, 32, 3), torch.randn(2, 5, 16),
                torch.rand(2) * 1000, torch.ones(2, 5, dtype=torch.int32))
    assert seen == pixeldit.kernel_calls(cfg, 2, 4, 5, batch=2)
    out.square().mean().backward()
    # 8 patch tokens: the gate's short branch (K4's plain version) for the
    # 3 self- and 3 cross-attentions
    assert bwd == {"flash": 2, "softmax": 6, "adaln": 2 * 3 + 2 * 2 - 1}
    full = pixeldit.kernel_calls(pixeldit.PIXELDIT_BASE, 32, 32, 300,
                                 batch=8)
    assert full["dot_product_attention"] == [
        (8, 1024, 1024, 16, 64), (8, 1024, 300, 16, 64)] * 24
    assert full["flash_attention"] == [(8, 16384, 4, 64)] * 4
    assert full["adaln_layernorm"] == [(8, 1024, 1024)] * 48 + [
        (8, 16384, 256)] * 8
    assert chip_smoke.pixeldit_launches(
        pixeldit.PIXELDIT_BASE, (32, 32), 300, (1, 1)) == {
        "flash_attention": 28, "dot_product_attention_folded": 24,
        "dot_product_attention": 0, "adaln_layernorm": 56,
        "flash_attention_bwd": 28, "dot_product_attention_folded_bwd": 24,
        "dot_product_attention_bwd": 0, "adaln_layernorm_bwd": 55,
        "attention_xla": 0}
    # a bucket whose token counts the gate refuses: 18x54 patch tokens
    # (972) take the XLA branch for both patch-stage attentions
    assert chip_smoke.pixeldit_launches(
        pixeldit.PIXELDIT_BASE, (18, 54), 300, (1, 1)) == {
        "flash_attention": 4, "dot_product_attention_folded": 0,
        "dot_product_attention": 0, "adaln_layernorm": 56,
        "flash_attention_bwd": 4, "dot_product_attention_folded_bwd": 0,
        "dot_product_attention_bwd": 0, "adaln_layernorm_bwd": 55,
        "attention_xla": 48}
    assert chip_smoke.pixeldit_adapted(pixeldit.PIXELDIT_BASE) == 208


# ---------------------------------------------------------------------------
# loading: the converter, the hub fetch
# ---------------------------------------------------------------------------

def _pixeldit_params(tmp_path, over=None, **kw):
    from yat_tpu_torch.config import TrainingParameters
    raw = {"batch_size": "2", "learning_rate": "1e-3", "steps": "1",
           "num_steps_per_validation": "100", "validation_prompts": [],
           "warmup_steps": "0", "train_unconditional_prob": "0",
           "dataset_seed": "0", "output_dir": str(tmp_path / "out"),
           "model_config_overrides": TINY_PIXELDIT if over is None
           else over}
    raw.update(kw)
    return TrainingParameters.from_dict(raw)


def write_tiny_checkpoint(path, seed=7):
    """A synthesized tiny PixelDiT file (BF16 values) at ``path``
    (``.safetensors`` or ``.pth``); returns its shapes and rules."""
    from yat_tpu_torch.models import pixeldit
    cfg = pixeldit.PIXELDIT_TINY_TEST
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in flax_params(
            pixeldit.PixelDiT(cfg, dtype=torch.float32)).items()}
    rules = S.pixeldit_rules(cfg.patch_size)
    if str(path).endswith(".pth"):
        S.write_pth(str(path), shapes, rules, seed, "BF16")
    else:
        S.write_checkpoint(os.path.dirname(str(path)), shapes, rules, seed,
                           "BF16", name=os.path.basename(str(path)))
    return shapes, rules


@pytest.mark.parametrize("name", ["model.safetensors", "checkpoint.pth"])
def test_convert_pixeldit_synthesized_file(tmp_path, name):
    """A synthesized PixelDiT file in DiT naming (the fused ``attn.qkv``
    and ``cross_attn.kv_linear``, the ``x_embedder.proj`` convolution,
    ``final_layer.linear``), as ``.safetensors`` and as a ``torch.save``
    ``.pth`` (BF16): both packages read it to equal trees; the port's
    trainer loads it through ``pretrained_model_path`` with every
    parameter at its synthesized value and its REPA projector drawn from
    the seed.  A missing file raises in both packages."""
    from yat_tpu.models.convert import load_torch_state_dict as j_load
    from yat_tpu.models.convert_dit import convert_pixeldit as j_convert
    from yat_tpu_torch.frontends import pixeldit
    from yat_tpu_torch.frontends.common import load_pretrained_backbone
    from yat_tpu_torch.models.convert import load_torch_state_dict
    from yat_tpu_torch.models.convert_dit import convert_pixeldit

    path = tmp_path / name
    shapes, rules = write_tiny_checkpoint(path)
    sd = load_torch_state_dict(str(path))
    assert sd["blocks.0.attn.qkv.weight"].shape == (96, 32)
    assert sd["blocks.1.cross_attn.kv_linear.bias"].shape == (64,)
    assert sd["x_embedder.proj.weight"].shape == (32, 3, 8, 8)
    tree = convert_pixeldit(sd, 2, 1)
    jtree = j_convert(j_load(str(path)), 2, 1)
    flat, jflat = dict(_flat(tree)), dict(_flat(jtree))
    assert set(flat) == set(jflat) == set(shapes)
    for p, value in flat.items():
        np.testing.assert_array_equal(value, jflat[p], err_msg=p)
    over = {k: v for k, v in TINY_PIXELDIT.items()
            if k not in ("caption_channels", "repa_target_dim")}
    params = _pixeldit_params(tmp_path, {**over, "caption_channels": "16"},
                              pretrained_model_path=str(path),
                              use_repa="true")
    cfg = pixeldit.build_config(params)
    model = pixeldit.build_denoiser(params, cfg, "cpu")
    want = dict(S.expected_values(shapes, rules, 7, "BF16"))
    got = flax_params(model)
    assert set(got) - set(want) == {
        p for p in got if p.startswith("repa_projector.")} != set()
    for p, value in want.items():
        np.testing.assert_array_equal(got[p].detach().numpy(), value,
                                      err_msg=p)
    missing = _pixeldit_params(tmp_path, pretrained_model_path=str(
        tmp_path / "missing" / "checkpoint.pth"))
    with pytest.raises(ValueError, match="refusing"):
        load_pretrained_backbone(missing, "pixeldit", cfg)
    from yat_tpu.config import TrainingParameters as JP
    from yat_tpu.frontends.common import load_pretrained_backbone as j_lpb
    with pytest.raises(ValueError, match="refusing"):
        j_lpb(JP.from_dict({"batch_size": "1", "learning_rate": "1e-3",
                            "steps": "1", "num_steps_per_validation": "1",
                            "pretrained_model_path": str(
                                tmp_path / "missing" / "checkpoint.pth")}),
              "pixeldit", cfg, {"params": {}})


def test_hub_fetch_with_stand_in_module(tmp_path, monkeypatch):
    """An ``org/name`` ``pretrained_model_path`` fetches ``model.pth`` into
    ``./checkpoints`` through ``hf_hub_download`` (a stand-in module in
    ``sys.modules``: its arguments, the file it writes loaded); a second
    run finds the file and calls nothing; without the library, or when
    the download fails, a ``ValueError`` names where to put the file.
    Nothing is downloaded."""
    from yat_tpu_torch.frontends import common, pixeldit

    monkeypatch.chdir(tmp_path)
    calls = []

    def hf_hub_download(repo_id, filename, local_dir):
        calls.append((repo_id, filename, local_dir))
        path = os.path.join(local_dir, filename)
        os.makedirs(local_dir, exist_ok=True)
        write_tiny_checkpoint(path)
        return path
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        hf_hub_download=hf_hub_download))
    over = dict(TINY_PIXELDIT, caption_channels="16")
    params = _pixeldit_params(tmp_path, over,
                              pretrained_model_path="nvlabs/pixeldit")
    cfg = pixeldit.build_config(params)
    assert common.looks_like_hub_repo("nvlabs/pixeldit")
    assert not common.looks_like_hub_repo("a/b/c")
    tree = common.load_pretrained_backbone(params, "pixeldit", cfg)
    assert calls == [("nvlabs/pixeldit", "model.pth", "./checkpoints")]
    again = common.load_pretrained_backbone(params, "pixeldit", cfg)
    assert len(calls) == 1
    for (p, a), (_, b) in zip(sorted(_flat(tree)), sorted(_flat(again))):
        np.testing.assert_array_equal(a, b, err_msg=p)
    os.remove(os.path.join("checkpoints", "model.pth"))

    def offline(**kw):
        raise OSError("no network")
    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        hf_hub_download=offline))
    with pytest.raises(ValueError, match="place the checkpoint at"):
        common.load_pretrained_backbone(params, "pixeldit", cfg)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ValueError, match="huggingface_hub is unavailable"):
        common.load_pretrained_backbone(params, "pixeldit", cfg)


# ---------------------------------------------------------------------------
# training and sampling against the JAX package
# ---------------------------------------------------------------------------

def test_repa_lora_step_on_4bit_base_matches_jax(tmp_path, monkeypatch):
    """``configs/pixeldit_repa.yaml``'s step at the tiny size (width 64,
    so the attention and MLP weights reach the quantizer's 4096
    elements; one patch block with the tap after it, one pixel block):
    rank-4 LoRA on to_q/to_k/to_v/to_out over a 4-bit base,
    AdamW, REPA at 0.1 through the projector after block 0 (quantized
    with the base, frozen), on the JAX step's draws: the loss and each
    LoRA leaf's gradient within 1e-4, the step's loss and grad_norm and
    every leaf after it; the projector stays as it was.  The 4-bit
    payloads equal the JAX package's but for roundings at a near-tie
    (XLA divides by 7 through its reciprocal inside jit): at most one in
    these 0.2 M weights, counted, and the port takes the JAX side."""
    from tests.test_torch_port_repa import _RAW, _check_leaves, _step_both
    from yat_tpu.adapters.builder import AdapterSpec, build_adapter_params
    from yat_tpu.ops.quant import quantize_params
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JS
    from yat_tpu.train.tasks import make_flow_matching_loss as j_loss
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import pixeldit
    from yat_tpu_torch.train.step import loss_and_grads

    monkeypatch.chdir(tmp_path)
    cfg, jm, params, batch = _tiny(64, 1)
    batch = dict(batch, repa_features=np.random.default_rng(6)
                 .standard_normal((2, 4, 32)).astype(np.float32))
    jvars = {"params": params}
    adapters, meta = build_adapter_params(
        jvars, AdapterSpec("lora", rank=4, alpha=8, target_modules=TARGETS),
        jax.random.PRNGKey(3))
    adapters = _trained(adapters)
    over = {k: str(v) for k, v in dataclasses.asdict(cfg).items()}
    raw = {**_RAW, "lora_algo": "lora", "lora_base_model_4bit": "true",
           "repa_lambda": "0.1",
           "model_config_overrides": over,
           "output_dir": str(tmp_path / "out")}
    trainer = pixeldit.make_trainer(TrainingParameters.from_dict(raw),
                                    sampler=[], device="cpu",
                                    weights={"transformer": _np(params)})
    load_flax_adapters(trainer.model, _np(adapters), _np(meta))
    trainer.initialize()
    proj = trainer.model.repa_projector
    assert proj.fc1.qweight is not None and \
        int(proj.fc1.payload_values().abs().max()) <= 7
    assert trainer.model.blocks_0.attn.to_q.qweight is not None
    jsched = JS(shift=1.0)

    def draws_of(rng_noise, latents):
        k_t, k_n, _ = jax.random.split(rng_noise, 3)
        ts, sig = jsched.training_draw(k_t, latents.shape[0])
        return {"timesteps": torch.from_numpy(np.array(ts)),
                "sigmas": torch.from_numpy(np.array(sig)),
                "noise": torch.from_numpy(np.array(jax.random.normal(
                    k_n, latents.shape, jnp.float32)))}
    jloss = j_loss(jm, jsched, repa_lambda=pixeldit.REPA_LOSS_WEIGHT)
    # the JAX loss and gradients on the 4-bit base, on the step's key
    qparams, scales = jax.jit(functools.partial(quantize_params, bits=4))(
        params)
    flips, n_quantized = 0, 0
    modules = dict(trainer.model.named_modules())
    for path, q in _flat(qparams):
        if not path.endswith(".kernel") or q.dtype == np.float32:
            continue
        layer, s = modules[path[:-len(".kernel")]], np.asarray(
            _get(scales, path[:-len("kernel")] + "kernel_scale"))
        want_q = torch.from_numpy(q.astype(np.int8).T.copy())
        flips += int((layer.payload_values() != want_q).sum())
        n_quantized += 1
        layer.set_quantized(want_q, torch.from_numpy(s), 4)
    assert n_quantized == sum(m.qweight is not None
                              for m in modules.values()
                              if hasattr(m, "qweight")) and flips <= 1
    before = [t.clone() for t in proj.state_dict().values()]
    _, rng_noise = jax.random.split(jax.random.PRNGKey(42))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda a: jloss(
        {"params": qparams, "adapters": a, "adapters_meta": meta,
         "quant_scales": scales}, jbatch, rng_noise,
        deterministic=False)))(adapters)
    jgrads = dict(_flat(jax.device_get(jg)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = loss_and_grads(trainer.task_loss,
                                 trainer.trainable_leaves(), tbatch,
                                 torch.Generator(), draws_of(rng_noise,
                                                             batch["latents"]))
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_TOL)
    names = trainer.trainable_names()
    # lora_a and lora_b of 8 projections a patch block, 4 a pixel block
    assert set(names) == set(jgrads) and len(names) == 2 * (8 + 4)
    for name, g in zip(names, grads):
        g = g.numpy()
        _close(g.T if name.endswith(".kernel") else g, jgrads[name],
               GRAD_TOL)
    state, grads = _step_both(jvars, adapters, meta, batch, jloss, draws_of,
                              trainer, raw, qbits=4)
    _check_leaves(trainer, state, grads, lion=False)
    for a, b in zip(before, proj.state_dict().values()):
        assert torch.equal(a, b)


def _get(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def test_validation_batch_matches_jax(tmp_path):
    """The serving pipeline's batch of two prompts (the tiny Gemma's
    captions, DPM-Solver++(2M) in flow form at CFG 4.0, 3 of its 20 steps,
    at 48 px: 36 patch tokens, 576 pixel tokens, no multiple of 128)
    against the JAX package's ``ValidationPipeline`` with the JAX
    frontend's settings on the same weights, conditioning and seed-42
    noise; the sample is the image."""
    import yat_tpu.models.pixeldit as J
    from tests.test_torch_port_sampling import _x0
    from yat_tpu.ops.schedulers import FlowMatchSchedule as JF
    from yat_tpu.train.validation import ValidationPipeline as JVP
    from yat_tpu_torch.frontends.pixeldit import make_pipeline

    over = {k: v for k, v in TINY_PIXELDIT.items()
            if k not in ("repa_depth", "repa_target_dim")}
    cfg = dataclasses.replace(J.PIXELDIT_TINY_TEST, caption_channels=32)
    jm = J.PixelDiT(cfg=cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 8, 32)),
                            jnp.zeros((1,)), jnp.ones((1, 8), jnp.int32))
    params = numpy_params(shapes["params"], 6)
    tp = _pixeldit_params(tmp_path, over)
    tp.aspect_ratios = 48
    vp = make_pipeline(tp, "cpu", {"transformer": _np(params)})
    assert (vp.sampler, vp.guidance_scale, vp.num_steps, vp.latent_shape) \
        == ("dpm", 4.0, 20, (48, 48, 3))
    prompts = ["a tiny red fox", "a blue bird"]
    jvp = JVP(jm, JF(shift=1.0), latent_shape=(48, 48, 3),
              encode_prompts=lambda ps: {
                  k: jnp.asarray(v.numpy())
                  for k, v in vp.encode_prompts(ps).items()},
              decode_latents=np.asarray, guidance_scale=4.0, num_steps=3,
              sampler="dpm")
    vp.num_steps = 3
    want = jvp(types.SimpleNamespace(
        params=types.SimpleNamespace(validation_prompts=prompts,
                                     validation_batch=4, low_vram=False),
        state=types.SimpleNamespace(ema=None,
                                    variables=lambda: {"params": params})))
    got = vp(prompts, x0=torch.from_numpy(_x0((1, 48, 48, 3))))
    assert list(got) == list(want)
    for tag in want:
        assert got[tag].shape == (48, 48, 3)
        np.testing.assert_allclose(got[tag], np.asarray(want[tag]),
                                   atol=IMAGE_TOL)


def test_warmup_spec_and_repa_fields_match_jax(tmp_path):
    """``warmup_spec`` (the bins, no compression, 3 channels, the caption's
    300 tokens and 2304 width, DINOv2's 256 tokens of 768) and the tiny
    encoders' REPA fields against the JAX package's helpers."""
    from yat_tpu.config import TrainingParameters as JP
    from yat_tpu.frontends import common as JC
    from yat_tpu_torch.frontends import common, pixeldit

    for over in ({}, {"tiny_encoders": "1"}):
        raw = {"batch_size": "1", "learning_rate": "1e-3", "steps": "1",
               "num_steps_per_validation": "1", "use_repa": "true",
               "aspect_ratio": "512", "model_config_overrides": over}
        p, jp = _pixeldit_params(tmp_path, **raw), JP.from_dict(raw)
        assert common.repa_warmup_fields(p) == JC.repa_warmup_fields(jp)
        assert common.dino_num_tokens(p) == JC.dino_num_tokens(jp)
    assert common.repa_warmup_fields(_pixeldit_params(tmp_path)) == {}
    p = _pixeldit_params(tmp_path, {}, use_repa="true", aspect_ratio="512")
    spec = pixeldit.warmup_spec(p, pixeldit.build_config(p))
    assert spec["vae_compression"] == 1 and spec["latent_channels"] == 3
    assert (spec["caption_len"], spec["caption_dim"]) == (300, 2304)
    assert (spec["repa_tokens"], spec["repa_dim"]) == (256, 768)
    from yat_tpu.data.bins import bin_for_resolution
    assert spec["aspect_ratios"] == bin_for_resolution(512)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _write_config(tmp_path, **kw):
    cfg = {"batch_size": "2", "learning_rate": "1e-3", "steps": "2",
           "warmup_steps": "0", "num_steps_per_validation": "2",
           "validation_prompts": ["an oil painting of mountains at dusk"],
           "lora_rank": "4", "lora_alpha": "4",
           "lora_algo": "lora", "lora_target_modules": TARGETS,
           "lora_base_model_4bit": "true", "use_repa": "true",
           "repa_lambda": "0.1", "compute_features": "true",
           "vae_max_batch_size": "2", "text_encoder_max_batch_size": "2",
           "cache_size": "4", "aspect_ratio": "256",
           "repa_pretrained_model": str(tmp_path / "missing.pth"),
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": TINY_256}
    cfg.update(kw)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_entry_point_trains_on_the_fly(tmp_path, monkeypatch):
    """``python -m yat_tpu_torch.frontends.pixeldit`` at the tiny size, as
    ``configs/pixeldit_repa.yaml`` is written but for its files: raw JPEGs
    on the fly (the identity encoder: the batch is the pixels in [-1, 1];
    the tiny Gemma; the tiny DINOv2, random for the missing file), LoRA
    over a 4-bit base (the projector quantized), REPA at 0.1: 2 steps with
    the alignment term on every step, the validation's 20 DPM CFG calls,
    the export."""
    from tests.test_torch_port_encode import make_image_shard
    from yat_tpu_torch.frontends import pixeldit
    from yat_tpu_torch.models.pixeldit import PixelDiT
    from yat_tpu_torch.train import tasks

    monkeypatch.chdir(tmp_path)
    seen, terms, encoded = [], [], []
    real = PixelDiT.forward

    def spy(self, x, emb, *a, **kw):
        seen.append((torch.is_grad_enabled(), tuple(x.shape),
                     tuple(emb.shape)))
        return real(self, x, emb, *a, **kw)
    monkeypatch.setattr(PixelDiT, "forward", spy)
    identity = pixeldit.make_identity_encoder

    def recording(device):
        enc = identity(device)

        def encode_images(images):
            out = enc(images)
            want = np.asarray(images).astype(np.float32) / 127.5 - 1.0
            encoded.append((np.asarray(images).dtype, out.shape,
                            float(np.abs(out - want).max())))
            return out
        return encode_images
    monkeypatch.setattr(pixeldit, "make_identity_encoder", recording)
    align = tasks.repa_alignment_loss
    monkeypatch.setattr(tasks, "repa_alignment_loss", lambda p, t: (
        terms.append((tuple(p.shape), tuple(t.shape))) or align(p, t)))
    shard = make_image_shard(tmp_path / "raw.tar", n=4, hw=(64, 64),
                             wide=False)
    trainer = pixeldit.main(["--config", _write_config(
        tmp_path, local_shard_paths=[shard]), "--device", "cpu"])
    assert trainer.global_step == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert (tmp_path / "out" / "2" / "adapter_model.safetensors").exists()
    assert trainer.family_spec.max_caption_len == 8
    assert trainer.model.repa_projector.fc1.qweight is not None
    # the identity encoder: uint8 batches of 2 as x / 127.5 - 1
    assert encoded and all(dt == np.uint8 and shape == (2, 256, 256, 3)
                           and err <= 1e-6 for dt, shape, err in encoded)
    train = [s for grad, *s in seen if grad]
    # 256 px: 16x16 patch tokens of 16 px
    assert len(train) == 2 and all(x == (2, 256, 256, 3) for x, _ in train)
    # the projection of 256 patch tokens against the tiny DINOv2's 4
    assert terms == [((2, 256, 32), (2, 4, 32))] * 2
    sampled = [s for grad, *s in seen if not grad]
    # validation: 20 DPM steps of CFG at batch 2 over 256 px
    assert len(sampled) == 20 and sampled[0] == [(2, 256, 256, 3),
                                                 (2, 8, 32)]


def _serve_params(**kw):
    from yat_tpu_torch.config import TrainingParameters
    params = TrainingParameters.from_dict({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "aspect_ratio": "256",
        "model_config_overrides": TINY_PIXELDIT, **kw})
    # 32 px (below the bin tables' 256, set past the config's check)
    params.aspect_ratios = 32
    return params


def test_serve_and_generate_pixeldit_on_cpu(tmp_path):
    """``serve`` answers a request and ``generate`` writes a PNG for
    ``--family pixeldit`` at the tiny size (2 DPM steps at CFG 4.0; the
    sample is the image); a family no package has is refused."""
    from yat_tpu_torch import generate
    from yat_tpu_torch.serve import build_sampler

    s = build_sampler(_serve_params(), "pixeldit", max_batch=2,
                      device="cpu", steps=2)
    try:
        assert s.pipeline.sampler == "dpm" and \
            s.pipeline.guidance_scale == 4.0
        img = s.submit("a red fox", timeout=300)
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    finally:
        s.stop()
    with pytest.raises(ValueError, match="unknown model family"):
        build_sampler(_serve_params(), "dit-xl", device="cpu")
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "aspect_ratio": "256",
        "model_config_overrides": TINY_256}))
    out = tmp_path / "out"
    generate.main(["--config", str(cfg), "--family", "pixeldit", "--prompt",
                   "a red fox", "--steps", "2", "--out", str(out),
                   "--device", "cpu"])
    assert len((out / "prompts.txt").read_text().splitlines()) == 1


def test_chip_smoke_pixeldit_phases_on_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py``'s PixelDiT phases rehearsed at the tiny size: the
    HTTP serve phase (4 concurrent requests and one more; no launch on the
    CPU), the gradient reference (the CPU against itself), then the
    shipped config's training phase from a synthesized ``.pth`` (3 steps
    at the square and the 432x144 bucket, whose 972 pixel tokens are no
    multiple of 128; validation at the last; every base value loaded,
    every LoRA leaf changed and exported, the REPA term reaching block 0
    alone, the launch model by step)."""
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    cpu = torch.device("cpu")
    params = chip_smoke.serve_params(aspect_ratio="256",
                                     model_config_overrides=TINY_PIXELDIT)
    params.bfloat16, params.aspect_ratios = False, 32
    counts = chip_smoke.phase_pixeldit_serve(cpu, "cpu", params, px=32,
                                             window_ms=2000.0)
    assert "flash_attention" in counts and not any(counts.values())
    chip_smoke.phase_pixeldit_grad_reference(
        cpu, {"hidden_dim": 32, "pixel_hidden_dim": 16, "num_heads": 2,
              "caption_channels": 16, "max_caption_len": 8,
              "mlp_ratio": 1.0, "repa_target_dim": 32, "patch_size": 8,
              "pixel_patch": 2}, side=32)
    out = chip_smoke.phase_pixeldit_train(cpu, "cpu", tiny=TINY_256)
    assert list(out) == ["pixeldit train"]
    assert set(out["pixeldit train"]) == set(chip_smoke.PIXELDIT_KERNELS) \
        and not any(out["pixeldit train"].values())
    from yat_tpu_torch.models.pixeldit import PIXELDIT_BASE
    # the 864x288 bucket of the card's run: no multiple of 128
    assert chip_smoke.pixel_tokens(PIXELDIT_BASE, (864, 288)) == 15552


def test_chip_smoke_pixeldit_config_cuts():
    """The train phase's config is the shipped one but for its files (the
    raw shards, the synthesized ``.pth``), the run's length and the depth
    cut (14 patch and 2 pixel blocks: the REPA projector still taps block
    12, block 13 lies past it)."""
    import chip_smoke
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.pixeldit import build_config

    with open(f"{chip_smoke.REPO}/configs/pixeldit_repa.yaml") as f:
        shipped = yaml.safe_load(f)
    cfg = chip_smoke.pixeldit_train_config(
        ["a.tar"], "w.pth", "out", **chip_smoke.depth_cut("pixeldit"))
    model_cfg = build_config(TrainingParameters.from_dict(cfg))
    assert (model_cfg.num_layers, model_cfg.num_pixel_layers) == (14, 2)
    assert model_cfg.repa_depth == 12
    assert cfg["local_shard_paths"] == ["a.tar"]
    assert cfg["pretrained_model_path"] == "w.pth"
    assert cfg["steps"] == cfg["num_steps_per_validation"] == "3"
    assert "repa_pretrained_model" not in cfg
    for key, want in shipped.items():
        if key in ("local_shard_paths", "pretrained_model_path", "steps",
                   "num_steps_per_validation"):
            continue
        assert cfg[key] == (want if isinstance(want, list) else str(want))
