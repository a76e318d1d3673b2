"""PyTorch port, pretrained loading on the CPU: each converter copy of the
port (``yat_tpu_torch/models/convert*.py``) against its JAX original on the
same synthesized state dict; SANA, PixArt-Sigma, Gemma-2, T5, DC-AE and
KL-VAE checkpoints written to disk in the torch/diffusers key layout
(``tools/synth_checkpoint.py``: F32, BF16 and ``.bin`` files, a
``pretrained_model_path`` directory and a pipe directory with its
``config.json`` and tokenizer) loaded by the port's ``make_pipeline`` and
``make_trainer`` and by the JAX package's ``load_pretrained_backbone`` and
encoder builders, every parameter compared, then one forward and one
decode per family; and the loader's refusals.  In a process with JAX
loaded, the JAX package's ``safetensors.numpy`` reader reads BF16 as
ml_dtypes' bfloat16, so both packages read the same files."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_frontends import TINY_DIT
from tools import synth_checkpoint as S
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 forwards of the same weights: summation order only
FORWARD_TOL = 2e-5
# fp32 caption encoders and decoders (MODEL_TOL of the port's model tests)
MODEL_TOL = 1e-4
SEED = 11

TINY_PIXART = {**TINY_DIT, "caption_channels": "32", "in_channels": "4",
               "out_channels": "8", "sample_size": "8",
               "vae_compression": "16", "tiny_encoders": "1"}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


# ---------------------------------------------------------------------------
# the tiny models of the JAX package, their trees and key layouts
# ---------------------------------------------------------------------------

def _jax_pixart_cfg():
    from yat_tpu.frontends.common import override_config
    from yat_tpu.models.pixart import PIXART_SIGMA_XL2
    return override_config(PIXART_SIGMA_XL2, TINY_PIXART)


def _jax_model(family, qk_norm=None):
    """(JAX module, its config, init params as numpy, rules)."""
    import dataclasses

    if family == "sana":
        from yat_tpu.models.sana import SANA_TINY_TEST, SanaTransformer2D
        cfg = dataclasses.replace(SANA_TINY_TEST, qk_norm=qk_norm)
        m = SanaTransformer2D(cfg=cfg, dtype=jnp.float32)
        v = m.init(jax.random.PRNGKey(0),
                   jnp.zeros((1, cfg.sample_size, cfg.sample_size,
                              cfg.in_channels)),
                   jnp.zeros((1, cfg.max_caption_len, cfg.caption_channels)),
                   jnp.zeros((1,)), jnp.ones((1, cfg.max_caption_len),
                                             jnp.int32))
        rules = S.SANA_RULES
    elif family == "pixart":
        from yat_tpu.models.pixart import PixArtTransformer2D
        cfg = _jax_pixart_cfg()
        m = PixArtTransformer2D(cfg=cfg, dtype=jnp.float32)
        s = cfg.sample_size
        v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, cfg.in_channels)),
                   jnp.zeros((1, cfg.max_caption_len, cfg.caption_channels)),
                   jnp.zeros((1,)), jnp.ones((1, cfg.max_caption_len),
                                             jnp.int32))
        rules = S.pixart_rules(cfg.patch_size)
    elif family in ("gemma2", "t5"):
        from yat_tpu.models import text_encoders as T
        cfg = T.GEMMA_TINY_TEST if family == "gemma2" else T.T5_TINY_TEST
        m = (T.Gemma2Encoder if family == "gemma2" else T.T5Encoder)(
            cfg=cfg, dtype=jnp.float32)
        v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                   jnp.ones((1, 8), jnp.int32))
        rules = S.GEMMA2_RULES if family == "gemma2" else S.T5_RULES
    else:
        from yat_tpu.models import vae as V
        if family == "dcae":
            cfg, m = V.DCAE_TINY_TEST, V.DCAE(cfg=V.DCAE_TINY_TEST)
            rules = S.dcae_rules(cfg)
        else:
            cfg = V.KLVAE_TINY_TEST
            m = V.AutoencoderKL(cfg=cfg)
            rules = S.VAE_KL_RULES
        v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return m, cfg, jax.tree.map(np.asarray, v["params"]), rules


def _convert(pkg, family, sd, cfg):
    """The converter of ``pkg`` (``yat_tpu`` or ``yat_tpu_torch``)."""
    import importlib
    conv = importlib.import_module(f"{pkg}.models.convert")
    if family == "sana":
        return conv.convert_sana(sd, cfg.num_layers)
    if family == "pixart":
        return importlib.import_module(
            f"{pkg}.models.convert_dit").convert_pixart(sd, cfg.num_layers)
    if family == "gemma2":
        return conv.convert_gemma2(sd, cfg.num_layers)
    if family == "t5":
        return conv.convert_t5_encoder(sd, cfg.num_layers)
    if family == "dcae":
        return importlib.import_module(
            f"{pkg}.models.convert_dcae").convert_dcae(sd, cfg)
    return importlib.import_module(f"{pkg}.models.convert_unet"
                                   ).convert_vae_kl(
        sd, cfg.block_out_channels, cfg.layers_per_block)


FAMILIES = ["sana", "pixart", "gemma2", "t5", "dcae", "klvae"]


@pytest.mark.parametrize("family", FAMILIES)
def test_converter_matches_jax_bit_for_bit(family):
    """Each converter copy returns the JAX original's tree on the same
    synthesized state dict (the full key space of the tiny model; the
    VAEs with both halves): the same leaves, dtypes and bits; and the tree
    covers the JAX model but for the biases the layout drops."""
    from yat_tpu.frontends.common import merge_with_report

    _, cfg, params, rules = _jax_model(family, qk_norm=(
        "rms_norm_across_heads" if family == "sana" else None))
    shapes = S.leaf_shapes(params)
    sd, expected = S.synth(shapes, rules, SEED)
    want = dict(_flat(_convert("yat_tpu", family, sd, cfg)))
    got = dict(_flat(_convert("yat_tpu_torch", family, sd, cfg)))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    _, missing, orphans = merge_with_report(params, dict(
        _convert("yat_tpu", family, sd, cfg)))
    assert not orphans
    _, dropped = S.plan(shapes, rules)
    assert sorted(missing) == sorted(dropped)
    for name, value in expected.items():
        if name in want:
            np.testing.assert_array_equal(want[name], value, err_msg=name)


def test_reader_reads_f16_and_bf16(tmp_path):
    """The port's safetensors reader: F16 as float16, BF16 widened to
    fp32, the values the file holds; the state-dict loader gives fp32."""
    from yat_tpu_torch.adapters.io import read_safetensors
    from yat_tpu_torch.models.convert import load_torch_state_dict

    x = S.round_to(np.random.default_rng(0).standard_normal((3, 5)).astype(
        np.float32), "BF16")
    for dtype in ("F16", "BF16"):
        path = str(tmp_path / f"{dtype}.safetensors")
        S.write_safetensors(path, [("w", x.shape, lambda: x)], dtype)
        got, _ = read_safetensors(path)
        want = x.astype(np.float16) if dtype == "F16" else x
        assert got["w"].dtype == want.dtype
        np.testing.assert_array_equal(got["w"], want)
        sd = load_torch_state_dict(path)
        assert sd["w"].dtype == np.float32
        np.testing.assert_array_equal(sd["w"], want.astype(np.float32))


# ---------------------------------------------------------------------------
# the denoisers end to end
# ---------------------------------------------------------------------------

def _write(dirpath, family, params, rules, fmt, cfg, grid="BF16"):
    """The checkpoint in ``fmt``; every format holds the same values (on
    bf16's grid), which are returned by flax path."""
    shapes = S.leaf_shapes(params)
    config = S.sana_config_json(cfg) if family == "sana" else None
    if fmt == "bin":
        sd, _ = S.synth(shapes, rules, SEED, grid)
        S.write_bin(os.path.join(dirpath, "diffusion_pytorch_model.bin"), sd)
        if config:
            with open(os.path.join(dirpath, "config.json"), "w") as f:
                json.dump(config, f)
    else:
        S.write_checkpoint(dirpath, shapes, rules, SEED, fmt, config=config,
                           grid=grid)
    return dict(S.expected_values(shapes, rules, SEED, grid))


def _raw(family, **over):
    raw = {"batch_size": "1", "learning_rate": "1e-4", "steps": "1",
           "num_steps_per_validation": "10"}
    if family == "sana":
        from yat_tpu.models.sana import SANA_TINY_TEST
        raw["model_config_overrides"] = {
            "max_caption_len": str(SANA_TINY_TEST.max_caption_len)}
    else:
        raw["model_config_overrides"] = dict(TINY_PIXART)
        raw["aspect_ratio"] = "256"
    raw.update(over)
    return raw


def _jax_load(family, raw, init):
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.frontends.common import load_pretrained_backbone
    from yat_tpu.frontends.sana import build_sana_config
    p = JParams.from_dict(raw)
    cfg = build_sana_config(p) if family == "sana" else _jax_pixart_cfg()
    out = load_pretrained_backbone(p, family, cfg, {"params": init})
    return cfg, jax.tree.map(np.asarray, out["params"])


def _assert_params(module, want_tree, expected=None):
    """Every parameter of the port's ``module`` equals the JAX tree's leaf
    (and the synthesized value) bit for bit."""
    from yat_tpu_torch.convert import flax_params
    got = {k: v.float().numpy() for k, v in flax_params(module).items()}
    want = dict(_flat(want_tree))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
        if expected is not None:
            np.testing.assert_array_equal(got[name], expected[name],
                                          err_msg=name)


def _forward(family, jmodel, jparams, tmodel, cfg):
    rng = np.random.default_rng(3)
    s = cfg.sample_size
    x = rng.standard_normal((2, s, s, cfg.in_channels)).astype(np.float32)
    emb = rng.standard_normal((2, cfg.max_caption_len,
                               cfg.caption_channels)).astype(np.float32)
    t = np.array([999.0, 250.0], np.float32)
    mask = np.ones((2, cfg.max_caption_len), np.int32)
    mask[1, 5:] = 0
    want = jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(emb),
                        jnp.asarray(t), jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(emb),
                     torch.from_numpy(t), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FORWARD_TOL, rtol=FORWARD_TOL)


@pytest.mark.parametrize("fmt", ["F32", "BF16", "bin"])
@pytest.mark.parametrize("family", ["sana", "pixart"])
def test_denoiser_loads_like_jax(tmp_path, family, fmt):
    """A checkpoint with the full torch key space in ``transformer/``
    (safetensors F32 or BF16, or ``.bin``), loaded through the port's
    ``make_pipeline`` and ``make_trainer`` (``pretrained_model_path``; on
    an int8 base the fp32 weights land before the trainer quantizes) and
    through the JAX package's ``load_pretrained_backbone``: every
    parameter equal, the dropped q/k/v biases of SANA's layout exactly
    zero, and one forward within FORWARD_TOL."""
    from yat_tpu_torch.config import TrainingParameters

    front = __import__(f"yat_tpu_torch.frontends.{family}",
                       fromlist=["make_pipeline"])
    jmodel, jcfg, init, rules = _jax_model(family)
    tdir = str(tmp_path / "transformer")
    expected = _write(tdir, family, init, rules, fmt, jcfg)
    cfg, jtree = _jax_load(family, _raw(family, pretrained_model_path=tdir),
                           init)
    raw = _raw(family, pretrained_model_path=tdir,
               model_config_overrides={**_raw(family)[
                   "model_config_overrides"], "tiny_encoders": "1"})
    vp = front.make_pipeline(TrainingParameters.from_dict(raw), "cpu")
    _assert_params(vp.model, jtree, expected)
    _forward(family, jmodel, jtree, vp.model, cfg)
    trainer = front.make_trainer(
        TrainingParameters.from_dict({**raw, "bfloat16": "true",
                                      "lora_base_model_8bit": "true",
                                      "lora_rank": "4", "lora_algo": "lora",
                                      "lora_target_modules": ["to_q"]}),
        sampler=[], device="cpu")
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    _assert_params(trainer.model, jtree)


# ---------------------------------------------------------------------------
# the pipe-path layout: denoiser, caption encoder, VAE, tokenizer
# ---------------------------------------------------------------------------

def _write_tokenizer(pipe):
    """A word-level tokenizer in ``pipe/tokenizer`` that transformers'
    AutoTokenizer loads (both packages tokenize through it)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    words = "a tiny red fox blue bird in the snow".split()
    vocab = {"[PAD]": 0, "[UNK]": 1, **{w: i + 2 for i, w in
                                        enumerate(words)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    os.makedirs(os.path.join(pipe, "tokenizer"))
    tok.save(os.path.join(pipe, "tokenizer", "tokenizer.json"))
    with open(os.path.join(pipe, "tokenizer", "tokenizer_config.json"),
              "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "pad_token": "[PAD]", "unk_token": "[UNK]",
                   "model_max_length": 512}, f)


def _jax_component(family, sub, pipe, init, cfg):
    """What the JAX encoder builders load from ``pipe/sub``."""
    from yat_tpu.models.convert import load_torch_state_dict, merge_into
    tree = _convert("yat_tpu", family,
                    load_torch_state_dict(os.path.join(pipe, sub)), cfg)
    return merge_into(init, tree)


@pytest.mark.parametrize("family", ["sana", "pixart"])
def test_pipe_path_loads_like_jax(tmp_path, family):
    """A diffusers pipe directory (``transformer/`` with its
    ``config.json``, SANA's with ``qk_norm``; ``text_encoder/``; ``vae/``
    with both halves; ``tokenizer/``) through the port's make_pipeline
    against the JAX package's loaders and encoder builders: every
    parameter equal, the architecture flag followed, one denoiser forward,
    the caption encodings and one decode within their tolerances."""
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu_torch.config import TrainingParameters

    pipe = str(tmp_path / "pipe")
    qk = "rms_norm_across_heads" if family == "sana" else None
    jmodel, jcfg, init, rules = _jax_model(family, qk_norm=qk)
    _write(os.path.join(pipe, "transformer"), family, init, rules, "F32",
           jcfg)
    te_family, vae_family = (("gemma2", "dcae") if family == "sana"
                             else ("t5", "klvae"))
    parts = {}
    for sub, fam in (("text_encoder", te_family), ("vae", vae_family)):
        _, ccfg, cinit, crules = _jax_model(fam)
        S.write_checkpoint(os.path.join(pipe, sub), S.leaf_shapes(cinit),
                           crules, SEED + 1, "BF16",
                           name="model.safetensors")
        parts[sub] = (ccfg, cinit)
    _write_tokenizer(pipe)

    over = {**_raw(family)["model_config_overrides"], "tiny_encoders": "1"}
    raw = _raw(family, pretrained_pipe_path=pipe,
               model_config_overrides=over)
    front = __import__(f"yat_tpu_torch.frontends.{family}",
                       fromlist=["make_pipeline"])
    vp = front.make_pipeline(TrainingParameters.from_dict(raw), "cpu")
    if family == "sana":
        assert vp.model.cfg.qk_norm == qk
    cfg, jtree = _jax_load(family, raw, init)
    _assert_params(vp.model, jtree)
    _forward(family, jmodel, jtree, vp.model, cfg)
    trainer = front.make_trainer(TrainingParameters.from_dict(
        {**raw, "lora_rank": "4", "lora_algo": "lora",
         "lora_target_modules": ["to_q"]}), sampler=[], device="cpu")
    _assert_params(trainer.model, jtree)

    te_cfg, te_init = parts["text_encoder"]
    vae_cfg, vae_init = parts["vae"]
    te_mod = _port_module(vp, "encode")
    vae_mod = _port_module(vp, "decode")
    _assert_params(te_mod, _jax_component(te_family, "text_encoder", pipe,
                                          te_init, te_cfg))
    jvae = _jax_component(vae_family, "vae", pipe, vae_init, vae_cfg)
    # serving holds the decoder half; a run that encodes images both
    _assert_params(vae_mod, {"decoder": jvae["decoder"]})
    tp = TrainingParameters.from_dict(raw)
    if family == "sana":
        t_images = front.build_encoders(tp, front.build_sana_config(tp),
                                        "cpu")[0]
    else:
        from yat_tpu_torch.frontends.common import build_t5_vae_encoders
        t_images = build_t5_vae_encoders(
            tp, "cpu", front.build_pixart_config(tp).max_caption_len)[0]
    _assert_params(t_images.module, jvae)

    jp = JParams.from_dict(raw)
    if family == "sana":
        from yat_tpu.frontends.sana import build_encoders
        _, j_encode, j_decode = build_encoders(jp, cfg)
    else:
        from yat_tpu.frontends.common import build_t5_vae_encoders
        _, j_encode, j_decode = build_t5_vae_encoders(jp, cfg.max_caption_len)
    caps = ["a tiny red fox", "blue bird in the snow"]
    t_encode, t_decode = _port_callables(vp)
    for got, want in zip(t_encode(caps), j_encode(caps)):
        np.testing.assert_allclose(got, np.asarray(want), atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
    z = np.random.default_rng(4).standard_normal(
        (1, 4, 4, vae_mod.cfg.latent_channels)).astype(np.float32)
    np.testing.assert_allclose(t_decode(torch.from_numpy(z)).numpy(),
                               np.asarray(j_decode(jnp.asarray(z))),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def _port_callables(vp):
    """The pipeline's caption encoder and decoder callables."""
    encode = vp.encode_prompts.encode_captions
    return encode, vp.decode_latents


def _port_module(vp, which):
    return (_port_callables(vp)[0] if which == "encode"
            else vp.decode_latents).module


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _sana_dir(tmp_path, edit=None):
    from yat_tpu.models.sana import SANA_TINY_TEST
    _, jcfg, init, rules = _jax_model("sana")
    sd, _ = S.synth(S.leaf_shapes(init), rules, SEED)
    if edit:
        edit(sd)
    tdir = tmp_path / "transformer"
    tdir.mkdir()
    S.write_bin(str(tdir / "diffusion_pytorch_model.bin"), sd)
    (tdir / "config.json").write_text(json.dumps(S.sana_config_json(
        SANA_TINY_TEST)))
    return str(tdir), init


def _nan_model(raw):
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.sana import build_sana_config
    from yat_tpu_torch.models.sana import SanaTransformer2D
    params = TrainingParameters.from_dict(raw)
    cfg = build_sana_config(params)
    model = SanaTransformer2D(cfg, dtype=torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    return params, cfg, model


@pytest.mark.parametrize("case", ["no_checkpoint", "orphan", "missing_weight",
                                  "missing_bias", "sharded"])
def test_loader_refusals_match_jax(tmp_path, case):
    """A configured path with no checkpoint, an orphan leaf (a bias the
    model has no place for), a missing weight and a sharded checkpoint
    raise in the port as in the JAX package; a missing bias loads as
    exactly zero in both, whatever the constructor left."""
    from yat_tpu_torch.frontends.common import build_backbone, \
        load_pretrained_backbone
    from yat_tpu_torch.frontends.sana import make_pipeline

    edits = {"orphan": lambda sd: sd.__setitem__(
                 "caption_norm.bias", np.zeros(64, np.float32)),
             "missing_weight": lambda sd: (sd.pop("proj_out.weight"),
                                           sd.pop("proj_out.bias")),
             "missing_bias": lambda sd: sd.pop("proj_out.bias")}
    if case == "no_checkpoint":
        pipe = tmp_path / "pipe"
        (pipe / "transformer").mkdir(parents=True)
        raw = _raw("sana", pretrained_pipe_path=str(pipe))
        with pytest.raises(ValueError, match="refusing to run a randomly"):
            make_pipeline(__import__("yat_tpu_torch.config", fromlist=["x"])
                          .TrainingParameters.from_dict(raw), "cpu")
        _, _, init, _ = _jax_model("sana")
        with pytest.raises(ValueError, match="randomly initialized"):
            _jax_load("sana", raw, init)
        return
    if case == "sharded":
        tdir = tmp_path / "transformer"
        tdir.mkdir()
        (tdir / "diffusion_pytorch_model.safetensors.index.json").write_text(
            json.dumps({"weight_map": {}}))
        params, cfg, model = _nan_model(_raw(
            "sana", pretrained_model_path=str(tdir)))
        with pytest.raises(ValueError, match="sharded") as e:
            load_pretrained_backbone(params, "sana", cfg)
        assert str(tdir) in str(e.value)
        return
    tdir, init = _sana_dir(tmp_path, edits[case])
    raw = _raw("sana", pretrained_model_path=tdir)
    params, cfg, model = _nan_model(raw)

    def load():
        # the NaN-filled model stands for whatever a constructor leaves
        return build_backbone(lambda: model, params, "sana", cfg, "cpu")

    if case == "missing_bias":
        assert load() is model
        assert torch.equal(model.proj_out.bias,
                           torch.zeros_like(model.proj_out.bias))
        _, jtree = _jax_load("sana", raw, init)
        assert not jtree["proj_out"]["bias"].any()
        _assert_params(model, jtree)
        return
    # the port names the leaf: the orphan's path, the missing parameter
    port_match = {"orphan": r"caption_norm/bias: .* no parameter 'bias'",
                  "missing_weight": r"not in the tree: \['proj_out.weight'\]"
                  }[case]
    with pytest.raises(ValueError, match=port_match):
        load()
    jax_match = {"orphan": "no model-parameter destination",
                 "missing_weight": "got no weights"}[case]
    with pytest.raises(ValueError, match=jax_match):
        _jax_load("sana", raw, init)


def test_other_families_name_their_roadmap_item(tmp_path):
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends.common import load_pretrained_backbone

    params = TrainingParameters.from_dict(_raw(
        "sana", pretrained_model_path=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="item 10"):
        load_pretrained_backbone(params, "pixeldit", None)


# ---------------------------------------------------------------------------
# chip_smoke.py's pretrained phase, rehearsed at the tiny size
# ---------------------------------------------------------------------------

TINY_SANA = {**TINY_DIT, "caption_channels": "32",
             "num_cross_attention_heads": "2",
             "cross_attention_head_dim": "16", "in_channels": "32",
             "out_channels": "32", "sample_size": "4", "tiny_encoders": "1"}


@pytest.mark.parametrize("family", ["sana", "pixart"])
def test_chip_smoke_pretrained_phase_on_cpu(family):
    """chip_smoke.py's pretrained phase at the tiny size on the CPU: the
    synthesized pipe directory, the parameter check, the HTTP main path,
    each sampler's batch, and for SANA the gating invariants and the
    low_vram batch; no kernel launches on the CPU."""
    import chip_smoke
    from yat_tpu_torch.convert import flax_params
    from yat_tpu_torch.models import vae as TV

    # the encoder halves the phase synthesizes (the port's VAEs' own) have
    # the JAX encoders' shapes
    for family_vae, port_vae in (("dcae", TV.DCAE(TV.DCAE_TINY_TEST)),
                                 ("klvae", TV.AutoencoderKL(
                                     TV.KLVAE_TINY_TEST))):
        _, _, init, _ = _jax_model(family_vae)
        want = {k: v for k, v in S.leaf_shapes(init).items()
                if k.startswith("encoder.")}
        got = {k: tuple(v.shape) for k, v in flax_params(port_vae).items()
               if k.startswith("encoder.")}
        assert got == want
    if family == "sana":
        extra, px = {"model_config_overrides": TINY_SANA}, 16
    else:
        extra, px = {"model_config_overrides": TINY_PIXART,
                     "aspect_ratio": "256"}, 32
    counts = chip_smoke.phase_pretrained(torch.device("cpu"), "cpu", family,
                                         extra=extra, px=px,
                                         window_ms=2000.0, bfloat16=False)
    assert counts and not any(counts.values())
