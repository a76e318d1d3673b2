"""PyTorch port, the remaining adapters on the CPU: DoRA, LoHa, LoKr and
FourierFT beside LoRA, against the JAX package on the same weights and
inputs.  ``AdapterDense``'s forward and leaf gradients on a floating base
(fp32 and bf16, whose deltas are formed in the compute dtype as the JAX
package forms them) and on an int8 base (the dequantized weight); the
tiny SANA and PixArt-Sigma denoisers with every kind; ``_factorize``,
the initial leaves and ``merge_adapters``; DoRA under the refiner gate
(``m · W / ‖W‖``) and in the preservation term's base (``W``); adapter
files across the packages under the export's naming, bare flax paths and
real PEFT module paths; FourierFT's round trip through ``lora_pretrained``
at one seed, and its indices, which a file does not carry across
packages.

Tolerances: fp32 forwards 1e-5 and gradients 1e-4 of the reference's
largest entry; bf16 one storage step (2^-8 relative, as the port's bf16
tests pin)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yat_tpu_torch.convert import load_flax_adapters, load_flax_params

KINDS = ["lora", "dora", "loha", "lokr", "fourierft"]
TARGETS = ["to_q", "to_k", "to_v", "to_out"]
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = {"atol": 2.0 ** -9, "rtol": 2.0 ** -8}


def _jspec(kind, targets, rank=4, n_frequency=40):
    from yat_tpu.adapters.builder import AdapterSpec
    return AdapterSpec("lora" if kind == "dora" else kind, rank=rank,
                       alpha=8.0, target_modules=targets,
                       use_dora=kind == "dora", n_frequency=n_frequency,
                       fourier_alpha=0.5)


def _trained(adapters, seed=0):
    """Every trainable leaf random (no zero factor left), so each one
    gets a gradient; DoRA's magnitude positive."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        v = 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "dora_m":
            v = np.abs(v) + 1.0
        return jnp.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, adapters)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


def _close(got, want, tol):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


class _Holder(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer


def _layer_case(kind, base, d_in=48, d_out=40, seed=0):
    """One dense layer with adapter ``kind`` in both packages: (JAX
    variables, port layer, x, cotangent)."""
    from yat_tpu.adapters.builder import build_adapter_params
    from yat_tpu.ops.quant import quantize_params
    from yat_tpu_torch.models.layers import AdapterDense

    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(d_out)).astype(np.float32)
    params = {"layer": {"kernel": jnp.asarray(kernel),
                        "bias": jnp.asarray(bias)}}
    adapters, meta = build_adapter_params(params, _jspec(kind, ["layer"]),
                                          jax.random.PRNGKey(seed))
    adapters = _trained(adapters, seed)
    variables = {"params": params["layer"], "adapters": adapters["layer"],
                 "adapters_meta": meta["layer"]}
    dtype = torch.bfloat16 if base == "bf16" else torch.float32
    port = AdapterDense(d_in, d_out, dtype=dtype)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.T.copy()))
        port.bias.copy_(torch.from_numpy(bias))
    if base == "int8":
        qparams, scales = quantize_params(params, bits=8, min_size=0)
        variables["params"] = qparams["layer"]
        variables["quant_scales"] = scales["layer"]
        port.set_quantized(torch.from_numpy(np.asarray(
            qparams["layer"]["kernel"]).T.copy()),
            torch.from_numpy(np.array(scales["layer"]["kernel_scale"])), 8)
    load_flax_adapters(_Holder(port), _np(adapters), _np(meta))
    x = rng.standard_normal((2, 5, d_in)).astype(np.float32)
    g = rng.standard_normal((2, 5, d_out)).astype(np.float32)
    return variables, port, x, g


@pytest.mark.parametrize("base", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_adapter_dense_matches_jax(kind, base):
    """Every kind's forward and leaf gradients on one dense layer."""
    from yat_tpu.models.layers import AdapterDense as JDense

    variables, port, x, g = _layer_case(kind, base)
    jdtype = jnp.bfloat16 if base == "bf16" else jnp.float32
    layer = JDense(features=port.features, dtype=jdtype)
    jx = jnp.asarray(x, jdtype)

    def jfwd(ad):
        return layer.apply({**variables, "adapters": ad}, jx)

    def jloss(ad):
        return jnp.sum(jfwd(ad).astype(jnp.float32) * g)
    # bf16 runs eagerly: jitted on the CPU, XLA drops the bf16 roundings
    # between elementwise ops that the JAX source states (and that eager
    # JAX, a TPU and the port keep)
    fwd = jfwd if base == "bf16" else jax.jit(jfwd)
    want = np.asarray(fwd(variables["adapters"]), np.float32)
    jgrads = dict(_flat(jax.device_get(jax.jit(jax.grad(jloss))(
        variables["adapters"]))))

    tx = torch.from_numpy(x).to(port.dtype)
    y = port(tx)
    (y.float() * torch.from_numpy(g)).sum().backward()
    got = y.detach().float().numpy()
    if base == "bf16":
        np.testing.assert_allclose(got, want, **BF16_TOL)
        return
    _close(got, want, FWD_TOL)
    names = dict(port.adapter_leaves())
    assert set(names) == set(jgrads)
    for name, p in names.items():
        _close(p.grad.numpy(), jgrads[name], GRAD_TOL)


def _nest(flat):
    tree = {}
    for path, t in flat.items():
        *keys, leaf = path.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(t.detach().numpy())
    return tree


@functools.lru_cache(maxsize=None)
def _family_setup(family):
    """The JAX tiny denoiser of ``family``, its variables and one batch.
    The variables are a seeded port model's parameters in the flax
    layout (``convert.flax_params``; a flax init would compile for
    seconds)."""
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.models.layers import init_params

    rng = np.random.default_rng(0)
    if family == "sana":
        from yat_tpu.models.sana import SANA_TINY_TEST as cfg
        from yat_tpu.models.sana import SanaTransformer2D as M
        from yat_tpu_torch.models.sana import SanaConfig as TC
        from yat_tpu_torch.models.sana import SanaTransformer2D as TM
        cap = 8
    else:
        from yat_tpu.models.pixart import PIXART_TINY_TEST as cfg
        from yat_tpu.models.pixart import PixArtTransformer2D as M
        from yat_tpu_torch.models.pixart import PixArtConfig as TC
        from yat_tpu_torch.models.pixart import PixArtTransformer2D as TM
        cap = cfg.max_caption_len
    model = M(cfg=cfg, dtype=jnp.float32)
    b = 2
    mask = np.ones((b, cap), np.int32)
    mask[0, 5:] = 0
    batch = {"latents": rng.standard_normal(
                 (b, cfg.sample_size, cfg.sample_size, cfg.in_channels),
                 np.float32),
             "embeddings": rng.standard_normal((b, cap, cfg.caption_channels),
                                               np.float32),
             "text_mask": mask,
             "timesteps": np.array([120.0, 740.0], np.float32)}
    seeded = TM(TC(**dataclasses.asdict(cfg)), dtype=torch.float32)
    init_params(seeded, torch.Generator().manual_seed(1))
    return cfg, model, {"params": _nest(flax_params(seeded))}, batch


def _port_denoiser(family, cfg, variables, adapters, meta):
    if family == "sana":
        from yat_tpu_torch.models.sana import SanaConfig as C
        from yat_tpu_torch.models.sana import SanaTransformer2D as M
    else:
        from yat_tpu_torch.models.pixart import PixArtConfig as C
        from yat_tpu_torch.models.pixart import PixArtTransformer2D as M
    model = M(C(**dataclasses.asdict(cfg)), dtype=torch.float32)
    load_flax_params(model, _np(variables["params"]))
    load_flax_adapters(model, _np(adapters), _np(meta))
    return model


@pytest.mark.parametrize("kind", ["dora", "loha", "lokr", "fourierft"])
@pytest.mark.parametrize("family", ["sana", "pixart"])
def test_denoiser_with_adapters_matches_jax(family, kind):
    """The tiny denoiser with every attention projection adapted: the
    prediction and every adapter leaf's gradient of the mean square."""
    from yat_tpu.adapters.builder import build_adapter_params
    from yat_tpu_torch.adapters.builder import adapter_parameters

    cfg, jmodel, variables, batch = _family_setup(family)
    adapters, meta = build_adapter_params(variables, _jspec(kind, TARGETS),
                                          jax.random.PRNGKey(3))
    adapters = _trained(adapters)
    keys = ("latents", "embeddings", "timesteps", "text_mask")
    args = [jnp.asarray(batch[k]) for k in keys]

    def jloss(ad):
        pred = jmodel.apply({"params": variables["params"], "adapters": ad,
                             "adapters_meta": meta}, *args)
        return jnp.mean(pred ** 2), pred
    model = _port_denoiser(family, cfg, variables, adapters, meta)
    pred = model(*[torch.from_numpy(batch[k]) for k in keys])
    loss = pred.pow(2).mean()
    loss.backward()
    (jl, jpred), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        adapters)
    jgrads = dict(_flat(jax.device_get(jg)))
    named = adapter_parameters(model)
    assert {n for n, _ in named} == set(jgrads)
    for name, p in named:
        _close(p.grad.numpy(), jgrads[name], GRAD_TOL)
    _close(pred.detach().numpy(), np.asarray(jpred), FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=FWD_TOL)


@pytest.mark.parametrize("n", [1, 7, 12, 32, 48, 1152, 4608, 97 * 3])
@pytest.mark.parametrize("factor", [-1, 4, 8])
def test_factorize_matches_jax(n, factor):
    from yat_tpu.adapters.builder import _factorize as jf
    from yat_tpu_torch.adapters.builder import _factorize as tf
    assert tf(n, factor) == jf(n, factor)


@pytest.mark.parametrize("kind", KINDS)
def test_initial_leaves_match_jax_shapes_and_laws(kind):
    """The port's initial adapters: the JAX package's leaves, shapes and
    meta on the tiny PixArt-Sigma (its MLP too), the zero factor that
    makes the initial delta 0 (DoRA: ``m = ‖W‖_col``, the output
    unchanged), the kaiming bounds, FourierFT's distinct indices."""
    from yat_tpu.adapters.builder import build_adapter_params
    from yat_tpu_torch.adapters.builder import (AdapterSpec, adapter_tree,
                                                build_adapter_params as tb)
    from yat_tpu_torch.models.pixart import PixArtConfig, \
        PixArtTransformer2D
    from yat_tpu_torch.models.layers import init_params

    cfg, _, variables, batch = _family_setup("pixart")
    targets = TARGETS + ["fc1", "fc2"]
    js = _jspec(kind, targets, n_frequency=300)
    jad, jmeta = build_adapter_params(variables, js, jax.random.PRNGKey(3))
    model = PixArtTransformer2D(PixArtConfig(**dataclasses.asdict(cfg)),
                                dtype=torch.float32)
    init_params(model, torch.Generator().manual_seed(0))
    args = [torch.from_numpy(batch[k]) for k in
            ("latents", "embeddings", "timesteps", "text_mask")]
    with torch.no_grad():
        before = model(*args)
    tb(model, AdapterSpec(**dataclasses.asdict(js)),
       torch.Generator().manual_seed(5))
    ad, meta = adapter_tree(model)
    shapes = lambda t: {k: v.shape for k, v in _flat(t)}  # noqa: E731
    assert shapes(ad) == shapes(_np(jad))
    assert shapes(meta) == shapes(_np(jmeta))
    with torch.no_grad():
        np.testing.assert_allclose(model(*args).numpy(), before.numpy(),
                                   atol=1e-5)
    leaves = dict(_flat(ad))
    for name, v in leaves.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("lora_a", "hada_w1_b", "hada_w2_a", "lokr_w1",
                    "lokr_w2_a"):
            assert 0 < np.abs(v).max() <= 1 / np.sqrt(v.shape[0]), name
    if kind == "fourierft":
        for name, idx in _flat(meta):
            if name.endswith("fft_indices"):
                assert idx.dtype == np.int32
                assert len({tuple(c) for c in idx.T}) == idx.shape[1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", ["sana", "pixart"])
def test_merge_adapters_matches_jax(family, kind):
    """Folding the adapters into the base kernels (fp32, then the
    kernel's dtype) gives the JAX package's merged tree, and the merged
    model (no adapters left) predicts what the adapted one did."""
    from yat_tpu.adapters.builder import build_adapter_params, merge_adapters
    from yat_tpu_torch.adapters.builder import adapted_modules
    from yat_tpu_torch.adapters.builder import merge_adapters as tmerge
    from yat_tpu_torch.convert import flax_params

    cfg, _, variables, batch = _family_setup(family)
    adapters, meta = build_adapter_params(variables, _jspec(kind, TARGETS),
                                          jax.random.PRNGKey(3))
    adapters = _trained(adapters)
    merged = dict(_flat(jax.device_get(merge_adapters(
        variables, adapters, meta)["params"])))
    model = _port_denoiser(family, cfg, variables, adapters, meta)
    args = [torch.from_numpy(batch[k]) for k in
            ("latents", "embeddings", "timesteps", "text_mask")]
    with torch.no_grad():
        adapted = model(*args)
    assert tmerge(model) == 8 * cfg.num_layers and not adapted_modules(model)
    got = {k: v.detach().numpy() for k, v in flax_params(model).items()}
    assert set(got) == set(merged)
    for k, v in merged.items():
        _close(got[k], v, FWD_TOL)
    with torch.no_grad():
        _close(model(*args).numpy(), adapted.numpy(), FWD_TOL)


def test_dora_gate_and_preservation_base_match_jax():
    """A trained DoRA magnitude: the refiner gate at 0 multiplies the
    scale by 0 in the JAX package, so the layer computes ``m · W / ‖W‖``,
    not ``W``; the preservation term's base is the model without its
    adapters (``W``).  The port keeps the two apart
    (``set_adapter_gate``, ``adapters_off``); for the other kinds the
    gate at 0 gives the base."""
    from yat_tpu.adapters.builder import build_adapter_params
    from yat_tpu.ops.sampling import gate_adapter_meta
    from yat_tpu_torch.models.layers import adapters_off, set_adapter_gate

    cfg, jmodel, variables, batch = _family_setup("sana")
    keys = ("latents", "embeddings", "timesteps", "text_mask")
    jargs = [jnp.asarray(batch[k]) for k in keys]
    args = [torch.from_numpy(batch[k]) for k in keys]
    apply = jax.jit(jmodel.apply)
    base = np.asarray(apply({"params": variables["params"]}, *jargs))
    for kind in ("dora", "loha"):
        adapters, meta = build_adapter_params(
            variables, _jspec(kind, TARGETS), jax.random.PRNGKey(3))
        adapters = _trained(adapters)
        gated = np.asarray(apply(
            {"params": variables["params"], "adapters": adapters,
             "adapters_meta": gate_adapter_meta(meta, jnp.float32(0.0))},
            *jargs))
        model = _port_denoiser("sana", cfg, variables, adapters, meta)
        with torch.no_grad():
            set_adapter_gate(model, 0.0)
            got_gated = model(*args).numpy()
            set_adapter_gate(model, None)
            with adapters_off(model):
                got_base = model(*args).numpy()
            assert not any(m.adapter_off for m in model.modules()
                           if hasattr(m, "adapter_off"))
        _close(got_gated, gated, FWD_TOL)
        _close(got_base, base, FWD_TOL)
        if kind == "dora":
            assert np.abs(gated - base).max() > 1e-3
        else:
            np.testing.assert_array_equal(got_gated, got_base)


def _jax_export(tmp_path, adapters, meta):
    from yat_tpu.adapters.io import save_adapter_safetensors
    path = str(tmp_path / "jax" / "adapter_model.safetensors")
    save_adapter_safetensors(path, adapters, meta)
    return path


def _rename(path, out, rule):
    """The file at ``path`` with every key renamed by ``rule``."""
    from yat_tpu_torch.adapters.io import read_safetensors, \
        write_safetensors
    tensors, meta = read_safetensors(path)
    write_safetensors(out, {rule(k): v for k, v in tensors.items()}, meta)
    return out


@pytest.mark.parametrize("naming", ["export", "flax", "peft"])
@pytest.mark.parametrize("kind", KINDS)
def test_adapter_files_cross_packages(tmp_path, kind, naming):
    """Adapters of the tiny PixArt-Sigma (attention and ``ff.fc1/fc2``)
    across the packages: the port's export read by the JAX package's
    ``load_adapter_safetensors``, and the JAX export read by the port's,
    renamed to bare flax paths or to real PEFT module paths
    (``transformer_blocks.N``, ``ff.net.0.proj``, ``to_out.0``)."""
    from yat_tpu.adapters.builder import build_adapter_params
    from yat_tpu.adapters.io import load_adapter_safetensors as jload
    from yat_tpu.adapters.peft_paths import flax_to_diffusers
    from yat_tpu_torch.adapters.builder import adapter_tree
    from yat_tpu_torch.adapters.io import (_PEFT_NAMES,
                                           load_adapter_safetensors,
                                           save_adapter_safetensors)

    cfg, _, variables, _ = _family_setup("pixart")
    adapters, meta = build_adapter_params(
        variables, _jspec(kind, TARGETS + ["fc1", "fc2"]),
        jax.random.PRNGKey(3))
    adapters = _np(_trained(adapters))
    suffixes = {v[0]: k for k, v in _PEFT_NAMES.items()}

    def rule(key):
        dotted = key[len("base_model.model."):]
        for suffix, leaf in suffixes.items():
            if dotted.endswith("." + suffix):
                module = dotted[:-len(suffix) - 1]
                break
        if naming == "flax":
            return f"{module}.{leaf}"
        return "base_model.model." + flax_to_diffusers(
            module.split("."), 0) + "." + suffix

    src = _jax_export(tmp_path, adapters, meta)
    if naming != "export":
        src = _rename(src, str(tmp_path / f"{naming}.safetensors"), rule)
    like = jax.tree.map(np.zeros_like, adapters)
    got = load_adapter_safetensors(src, like)
    for (n, g), (_, w) in zip(_flat(got), _flat(adapters)):
        np.testing.assert_array_equal(g, w, err_msg=n)

    model = _port_denoiser("pixart", cfg, variables, adapters, meta)
    out = str(tmp_path / "port" / "adapter_model.safetensors")
    save_adapter_safetensors(out, *adapter_tree(model))
    if naming != "export":
        out = _rename(out, str(tmp_path / f"port_{naming}.safetensors"),
                      rule)
    back = jload(out, like)
    for (n, g), (_, w) in zip(_flat(back), _flat(adapters)):
        np.testing.assert_array_equal(g, w, err_msg=n)


def test_peft_file_missing_or_misshapen_leaf_raises(tmp_path):
    from yat_tpu_torch.adapters.io import (load_adapter_safetensors,
                                           write_safetensors)
    like = {"blocks_0": {"attn1": {"to_q": {
        "lora_a": np.zeros((8, 4), np.float32),
        "lora_b": np.zeros((4, 8), np.float32)}}}}
    path = str(tmp_path / "a.safetensors")
    write_safetensors(path, {
        "base_model.model.transformer_blocks.0.attn1.to_q.lora_A.weight":
            np.zeros((4, 8), np.float32),
        "base_model.model.transformer_blocks.0.attn1.to_q.lora_B.weight":
            np.zeros((8, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_adapter_safetensors(path, like)
    like["blocks_0"]["attn1"]["to_k"] = like["blocks_0"]["attn1"]["to_q"]
    with pytest.raises((KeyError, ValueError)):
        load_adapter_safetensors(path, like)


def test_fourierft_round_trip_through_lora_pretrained(tmp_path):
    """A FourierFT export reloads through ``lora_pretrained`` at the same
    seed exactly (the indices rebuilt from the seed, the spectrum from the
    file); across packages the file carries the spectrum alone, and the
    port's seeded indices are not the JAX package's draws (ROADMAP §3)."""
    from yat_tpu.adapters.builder import build_adapter_params
    from yat_tpu_torch.adapters.builder import (AdapterSpec, adapter_tree,
                                                build_adapter_params as tb)
    from yat_tpu_torch.adapters.io import save_adapter_safetensors
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.common import attach_pretrained_adapters
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.models.sana import SANA_TINY_TEST, SanaTransformer2D

    raw = {"batch_size": "1", "learning_rate": "1e-3", "steps": "1",
           "num_steps_per_validation": "1", "lora_rank": "4", "lora_algo": "fourierft",
           "lora_target_modules": TARGETS, "fourierft_n_frequency": "40",
           "fourierft_alpha": "0.5", "dataset_seed": "3"}

    def denoiser():
        m = SanaTransformer2D(SANA_TINY_TEST, dtype=torch.float32)
        init_params(m, torch.Generator().manual_seed(0))
        return m
    live = denoiser()
    params = TrainingParameters.from_dict(raw)
    from yat_tpu_torch.train.engine import adapter_spec_from_params
    tb(live, adapter_spec_from_params(params),
       torch.Generator().manual_seed(3))
    with torch.no_grad():
        for _, m in live.named_modules():
            if getattr(m, "fft_spectrum", None) is not None:
                m.fft_spectrum.normal_(generator=torch.Generator()
                                       .manual_seed(9))
    path = str(tmp_path / "adapter_model.safetensors")
    save_adapter_safetensors(path, *adapter_tree(live))
    params = TrainingParameters.from_dict({**raw, "lora_pretrained": path})
    served = denoiser()
    assert attach_pretrained_adapters(served, params, "cpu") == 16
    for (n, a), (_, b) in zip(_flat(adapter_tree(live)[1]),
                              _flat(adapter_tree(served)[1])):
        np.testing.assert_array_equal(a, b, err_msg=n)
    lat = torch.randn(1, 8, 8, SANA_TINY_TEST.in_channels,
                      generator=torch.Generator().manual_seed(1))
    emb = torch.randn(1, 8, SANA_TINY_TEST.caption_channels,
                      generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        args = (lat, emb, torch.tensor([300.0]), torch.ones(1, 8))
        assert torch.equal(live(*args), served(*args))
    _, jmeta = build_adapter_params(
        {"params": {"blocks_0": {"attn1": {"to_q": {
            "kernel": jnp.zeros((32, 32))}}}}}, _jspec("fourierft", ["to_q"]),
        jax.random.PRNGKey(3))
    jidx = np.asarray(jmeta["blocks_0"]["attn1"]["to_q"]["fft_indices"])
    tidx = adapter_tree(served)[1]["blocks_0"]["attn1"]["to_q"][
        "fft_indices"]
    assert jidx.shape == tidx.shape and not np.array_equal(jidx, tidx)


def test_chip_smoke_adapter_phases_on_cpu():
    """chip_smoke.py's adapter phase (LoHa, LoKr, FourierFT and DoRA, 2
    steps each through the entry point, the export reloaded through
    ``lora_pretrained`` into ``make_pipeline`` bit for bit, DoRA's gate)
    and its gradient reference (for DoRA: the path is one for every kind,
    and each kind's backward is held above), rehearsed at the tiny size on
    the CPU; no kernel launches on the CPU."""
    import chip_smoke
    from tests.test_torch_port_train import TINY_OVERRIDES

    counts = chip_smoke.phase_adapter_kinds(
        torch.device("cpu"), "cpu",
        shard_args={"n": 8, "latent": (8, 8, 4), "dim": 16,
                    "lengths": (3, 8)},
        cfg_extra={"batch_size": "4", "bfloat16": None,
                   "model_config_overrides": dict(TINY_OVERRIDES,
                                                  tiny_encoders="1")})
    assert set(counts) == set(chip_smoke.ADAPTER_KINDS)
    assert not any(n for c in counts.values() for n in c.values())
    chip_smoke.phase_grad_reference(
        torch.device("cpu"), width={"hidden_dim": 64,
                                    "num_attention_heads": 2,
                                    "attention_head_dim": 32,
                                    "num_cross_attention_heads": 2,
                                    "cross_attention_head_dim": 32,
                                    "caption_channels": 32},
        kinds=("dora",))


@pytest.mark.parametrize("kind", KINDS)
def test_synthesized_peft_file_loads_in_both_packages(tmp_path, kind):
    """``tools/synth_checkpoint.write_peft_adapters``: a real PEFT file's
    names (``transformer_blocks.N``, ``to_out.0``, ``ff.net.0.proj``) for
    every leaf of the tiny PixArt-Sigma's adapters, read by both
    packages into the values the tool says each leaf must hold."""
    import os
    import sys

    from yat_tpu.adapters.io import load_adapter_safetensors as jload
    from yat_tpu_torch.adapters.builder import (AdapterSpec, adapter_tree,
                                                build_adapter_params)
    from yat_tpu_torch.adapters.io import load_adapter_safetensors
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.models.pixart import PIXART_TINY_TEST, \
        PixArtTransformer2D

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import synth_checkpoint

    model = PixArtTransformer2D(PIXART_TINY_TEST, dtype=torch.float32)
    init_params(model, torch.Generator().manual_seed(0))
    build_adapter_params(model, AdapterSpec(**dataclasses.asdict(
        _jspec(kind, TARGETS + ["fc1", "fc2"]))),
        torch.Generator().manual_seed(1))
    like = adapter_tree(model)[0]
    path = str(tmp_path / "adapter_model.safetensors")
    want = synth_checkpoint.write_peft_adapters(
        path, {n: v.shape for n, v in _flat(like)}, seed=4)
    for got in (load_adapter_safetensors(path, like), jload(path, like)):
        got = dict(_flat(got))
        assert set(got) == set(want)
        for n, v in want.items():
            np.testing.assert_array_equal(got[n], v, err_msg=n)
