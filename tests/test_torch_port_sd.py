"""PyTorch port, the SD1.5/SDXL prompt and data paths on the CPU: CLIP
(final and penultimate states, the pooled vector with and without its
projection), caption compression, the CLIP converter, the three faults of
the JAX package the port does not copy (SDXL's VAE scaling, SDXL's first
text encoder's states, ``low_vram``'s remat in ``test_torch_port_unet``),
the SDXL sampling pipeline with pooled text and ``time_ids`` against the
JAX ``ValidationPipeline``, SDXL's extraction pass writing ``pooled.npy``,
both training entry points (on the fly, and from feature shards with
pooled text), and ``serve``/``generate`` with ``--family sd15|sdxl``;
against ``yat_tpu`` on the same numpy inputs and weights."""

import dataclasses
import glob
import io
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import tools.synth_checkpoint as S
from tests.test_torch_port_encode import make_image_shard
from tests.test_torch_port_unet import numpy_params
from yat_tpu_torch.convert import flax_params, load_flax_params
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# fp32 modules: reduction order only
MODEL_TOL = 2e-5
# sampled latents after 2 fp32 DDIM steps at CFG 5.0, whose guidance
# multiplies the reduction-order noise by 1 + 5.0 a step: 1e-4 of each
# element, plus 1e-5 of the largest
SAMPLE_TOL = 1e-4
SAMPLE_FIELD_TOL = 1e-5

# the tiny SD1.5 UNet on the tiny CLIP (width 32)
TINY_SD15 = {"block_out_channels": ["32", "64"], "layers_per_block": "1",
             "transformer_layers": ["1", "1"], "cross_attention_dim": "32",
             "num_heads": "2", "tiny_encoders": "1"}
# the tiny SDXL UNet on two tiny CLIPs (32 + 32 wide, pooled 32)
TINY_SDXL = {"block_out_channels": ["32", "64"], "layers_per_block": "1",
             "transformer_layers": ["0", "1"], "cross_attention_dim": "64",
             "num_heads": "2", "addition_embed_dim": "32",
             "addition_time_embed_dim": "8", "tiny_encoders": "1"}
CAPTIONS = ["a photo of a small red fox sitting in fresh snow",
            "A portrait of Ada Lovelace; oil painting, dramatic light",
            "the view of a lighthouse at dusk - waves, rocks and gulls", ""]


def _params(over=None, **kw):
    from yat_tpu_torch.config import TrainingParameters
    raw = {"batch_size": "2", "learning_rate": "1e-3", "steps": "2",
           "num_steps_per_validation": "100", "aspect_ratio": "256",
           "model_config_overrides": dict(TINY_SD15 if over is None
                                             else over)}
    raw.update(kw)
    return TrainingParameters.from_dict(raw)


def _clip_pair(cfg_j, seed=0):
    """The JAX CLIPTextModel of ``cfg_j`` with numpy weights, and the
    port's with the same weights."""
    from yat_tpu.models.text_encoders import CLIPTextModel as JC
    from yat_tpu_torch.models.text_encoders import CLIPTextConfig, \
        CLIPTextModel
    jm = JC(cfg=cfg_j, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, cfg_j.max_length), jnp.int32))
    params = numpy_params(shapes["params"], seed)
    tm = CLIPTextModel(CLIPTextConfig(**dataclasses.asdict(cfg_j)),
                       dtype=torch.float32)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, {"params": params}, tm


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("penultimate", [False, True])
@pytest.mark.parametrize("projection", [None, 24])
def test_clip_matches_jax(penultimate, projection):
    """The hidden states (the final LayerNorm's or the penultimate
    layer's) and the pooled vector at each sequence's largest token id,
    through the bias-free projection where configured; quick-GELU and
    exact GELU."""
    from yat_tpu.models.text_encoders import CLIP_TINY_TEST
    cfg = dataclasses.replace(CLIP_TINY_TEST, penultimate=penultimate,
                              projection_dim=projection,
                              act="gelu" if projection else "quick_gelu")
    jm, variables, tm = _clip_pair(cfg)
    ids = np.random.default_rng(1).integers(0, 255, (3, 16)).astype(np.int32)
    ids[0, 5] = ids[1, 15] = ids[2, 0] = 255
    want_h, want_p = jm.apply(variables, jnp.asarray(ids))
    got_h, got_p = tm(torch.from_numpy(ids))
    assert got_p.shape == (3, projection or 32)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def test_compress_caption_matches_jax():
    """The rule-based compressor (no spaCy on either machine), with and
    without the Dreambooth identifier."""
    from yat_tpu.utils.compress_caption import compress_caption as J
    from yat_tpu_torch.utils.compress_caption import compress_caption
    long = " ".join(f"word{i} and a photo of thing{i}," for i in range(40))
    for c in CAPTIONS + [long, "a cat scattered near the cat tree"]:
        assert compress_caption(c) == J(c)
        assert compress_caption(c, max_words=5) == J(c, max_words=5)
        assert compress_caption(c, class_label="cat", id_label="sks") == \
            J(c, class_label="cat", id_label="sks")


def test_clip_encoders_take_states_and_pooled_from_one_forward():
    """``encode_pooled`` of the captions just encoded (directly or through
    ``.dispatch``) reuses that forward's pooled vector, so a batch runs
    CLIP once; other captions run their own forward.  Values equal a
    forward of their own."""
    from yat_tpu_torch.frontends.common import make_clip_encoders
    from yat_tpu_torch.models.text_encoders import CLIP_TINY_TEST, \
        CLIPTextModel
    from yat_tpu_torch.utils.compress_caption import compress_caption
    from yat_tpu_torch.utils.tokenizer import load_tokenizer

    torch.manual_seed(0)
    te = CLIPTextModel(dataclasses.replace(CLIP_TINY_TEST, projection_dim=24))
    calls = []
    te.register_forward_hook(lambda *_: calls.append(1))
    tok = load_tokenizer(None, vocab_size=256, max_length=16)
    enc, pooled = make_clip_encoders(te, tok, 16, torch.device("cpu"), False)
    a, b = CAPTIONS[:2], CAPTIONS[2:]
    states = enc(a)
    got = pooled(a)
    assert len(calls) == 1
    enc.dispatch(b)()
    got_b = pooled.dispatch(b)()
    assert len(calls) == 2
    assert pooled(a).shape == (2, 24) and len(calls) == 3
    for caps, s, p in ((a, states, got), (b, None, got_b)):
        ids, _ = tok([compress_caption(c) for c in caps], max_length=16)
        with torch.no_grad():
            want_h, want_p = te(torch.as_tensor(ids))
        np.testing.assert_array_equal(p, want_p.numpy())
        if s is not None:
            np.testing.assert_array_equal(np.stack(s), want_h.numpy())


@pytest.mark.parametrize("prefixed", [True, False])
def test_convert_clip_text_matches_jax(prefixed):
    """A synthesized transformers CLIP-with-projection state dict
    (``text_model.`` prefixed, or bare as a single file's
    ``cond_stage_model.transformer`` split has it when prefixed
    differently) through both converters: equal trees, loaded into the
    port's model with every value as synthesized."""
    from yat_tpu.models.convert import convert_clip_text as J
    from yat_tpu_torch.models.convert import convert_clip_text
    from yat_tpu_torch.models.text_encoders import CLIP_TINY_TEST, \
        CLIPTextModel
    cfg = dataclasses.replace(CLIP_TINY_TEST, projection_dim=24)
    with torch.device("meta"):
        shapes = S.leaf_shapes(flax_params(CLIPTextModel(cfg)))
    sd, expected = S.synth(shapes, S.CLIP_RULES, 0)
    if not prefixed:
        sd = {k.replace("text_model.", "", 1): v for k, v in sd.items()}
    tree = convert_clip_text(sd, cfg.num_layers)
    want = J(sd, cfg.num_layers)
    flat, jflat = S.leaf_shapes(tree), S.leaf_shapes(want)
    assert flat == jflat
    tm = CLIPTextModel(cfg)
    load_flax_params(tm, tree)
    for path, t in flax_params(tm).items():
        np.testing.assert_array_equal(t.numpy(), expected[path])


# ---------------------------------------------------------------------------
# the faults of the JAX package the port does not copy
# ---------------------------------------------------------------------------

def test_builders_pick_sdxl_vae_and_penultimate_states(monkeypatch):
    """At full size the SDXL builder takes the SDXL VAE (0.13025) and
    CLIP-L's penultimate states, the SD1.5 builder SD1.5's VAE (0.18215)
    and CLIP-L's final states, and PixArt-Sigma's T5 builder the SDXL VAE
    its published pipe ships; the JAX builders take 0.18215 for all three
    and CLIP-L's final states for SDXL (the modules are built on the meta
    device here)."""
    from yat_tpu_torch.frontends import common
    from yat_tpu_torch.frontends.sdxl import build_sdxl_encoders

    built = []

    def meta_component(params, sub, convert, module_fn, device, seed,
                       dtype=None, tree=None):
        with torch.device("meta"):
            m = module_fn()
        built.append((sub, m.cfg))
        return m
    monkeypatch.setattr(common, "build_pipe_component", meta_component)
    full = _params({})
    common.build_clip_vae_encoders(full, "cpu")
    sd15 = dict(built)
    built.clear()
    build_sdxl_encoders(full, "cpu")
    sdxl = dict(built)
    built.clear()
    common.build_t5_vae_encoders(full, "cpu")
    pixart = dict(built)
    assert sd15["vae"].scaling_factor == 0.18215
    assert sdxl["vae"].scaling_factor == pixart["vae"].scaling_factor \
        == 0.13025
    assert not sd15["text_encoder"].penultimate
    assert sdxl["text_encoder"].penultimate and \
        sdxl["text_encoder_2"].penultimate
    assert sdxl["text_encoder_2"].projection_dim == 1280


def test_sdxl_latents_are_the_jax_latents_rescaled():
    """The same KL-VAE weights encode the same pixels; the port's SDXL
    latents (scaling 0.13025) are the JAX builders' (0.18215) times
    0.13025 / 0.18215 and otherwise equal; decoding undoes each scale."""
    from yat_tpu.models.vae import KLVAE_SD15 as J15
    from yat_tpu.models.vae import KLVAE_TINY_TEST as JT
    from yat_tpu.models.vae import AutoencoderKL as JKL
    from yat_tpu_torch.models.vae import KLVAE_SDXL, KLVAE_TINY_TEST, \
        AutoencoderKL

    jcfg = dataclasses.replace(JT, scaling_factor=J15.scaling_factor)
    jm = JKL(cfg=jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))
    params = numpy_params(shapes["params"], 2)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               method=jm.encode_mode))
    tm = AutoencoderKL(dataclasses.replace(
        KLVAE_TINY_TEST, scaling_factor=KLVAE_SDXL.scaling_factor))
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    got = tm.encode_mode(torch.from_numpy(x)).detach().numpy()
    ratio = np.float32(0.13025) / np.float32(0.18215)
    np.testing.assert_allclose(got, want * ratio, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    assert not np.allclose(got, want, atol=1e-3)


def _jax_sdxl_prompt_encoder(te1, te2, time_ids_hw):
    """The JAX package's make_prompt_encoder over the two tiny CLIPs (both
    penultimate: the repair applied through the JAX config), with its
    compress_caption and hash tokenizer."""
    from yat_tpu.frontends.common import make_prompt_encoder
    from yat_tpu.utils.compress_caption import compress_caption
    from yat_tpu.utils.tokenizer import HashTokenizer

    tok = HashTokenizer(vocab_size=256, max_length=16)

    def ids_of(captions):
        ids, _ = tok([compress_caption(c) for c in captions], max_length=16)
        return jnp.asarray(ids)

    def encode_captions(captions):
        h1, _ = te1[0].apply(te1[1], ids_of(captions))
        h2, _ = te2[0].apply(te2[1], ids_of(captions))
        return list(np.concatenate([np.asarray(h1), np.asarray(h2)], -1))

    def encode_pooled(captions):
        return np.asarray(te2[0].apply(te2[1], ids_of(captions))[1])

    return make_prompt_encoder(encode_captions, 77, encode_pooled,
                               time_ids_hw), encode_pooled


@pytest.fixture(scope="module")
def sdxl_weights():
    """The tiny SDXL's JAX trees: the UNet, both CLIPs (penultimate) and
    the KL-VAE, from numpy, with the JAX modules."""
    from yat_tpu.models.text_encoders import CLIP_TINY_TEST
    from yat_tpu.models.unet import UNet2DCondition as JU
    from yat_tpu.models.vae import KLVAE_TINY_TEST, AutoencoderKL
    from yat_tpu_torch.frontends.common import override_config
    from yat_tpu.models.unet import SDXL_UNET

    ucfg = override_config(SDXL_UNET, TINY_SDXL)
    ju = JU(cfg=ucfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)),
        jnp.zeros((1, 77, 64)), jnp.zeros((1,)), jnp.ones((1, 77)),
        pooled_text=jnp.zeros((1, 32)), time_ids=jnp.zeros((1, 6)))
    pen = dataclasses.replace(CLIP_TINY_TEST, penultimate=True)
    te1, te2 = _clip_pair(pen, 4)[:2], _clip_pair(pen, 5)[:2]
    jv = AutoencoderKL(cfg=KLVAE_TINY_TEST)
    vshapes = jax.eval_shape(jv.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 16, 16, 3)))
    trees = {"unet": numpy_params(shapes["params"], 6),
             "text_encoder": te1[1]["params"],
             "text_encoder_2": te2[1]["params"],
             "vae": numpy_params(vshapes["params"], 7)}
    return ju, te1, te2, {k: jax.tree.map(np.asarray, v)
                          for k, v in trees.items()}


def test_sdxl_pipeline_matches_jax_validation(sdxl_weights):
    """The port's SDXL pipeline (make_pipeline on the JAX trees) against
    the JAX package's ValidationPipeline on the same UNet and prompt
    encoder (pooled text and time_ids with every prompt, the empty one of
    the unconditional half included), 2 DDIM steps at CFG 5.0, JAX's
    seed_noise(42): the same latents."""
    from yat_tpu.ops.schedulers import DDPMSchedule as JS
    from yat_tpu.ops.sampling import seed_noise
    from yat_tpu.train.validation import ValidationPipeline as JVP
    from yat_tpu_torch.frontends.sdxl import make_pipeline

    ju, te1, te2, trees = sdxl_weights
    vp = make_pipeline(_params(TINY_SDXL), "cpu", trees)
    assert (vp.num_steps, vp.guidance_scale) == (20, 5.0)
    cond = vp.encode_prompts(["a red fox"])
    assert cond["time_ids"].tolist() == [[256, 256, 0, 0, 256, 256]]
    assert cond["pooled_text"].shape == (1, 32)
    vp.num_steps, vp.decode_latents = 2, None
    encode, _ = _jax_sdxl_prompt_encoder(te1, te2, (256, 256))
    jvp = JVP(ju, JS(), vp.latent_shape, encode, None, num_steps=2)
    prompts = ["a red fox in snow", "a lighthouse"]
    jcond = encode(prompts)
    juncond = {k: jnp.repeat(v, 2, axis=0)
               for k, v in encode([""]).items()}
    want = np.asarray(jvp._sample_latents(
        {"params": trees["unet"]}, jcond, juncond))
    x0 = torch.from_numpy(np.array(seed_noise(42, (1, *vp.latent_shape))))
    tcond = vp.encode_prompts(prompts)
    tuncond = {k: v.repeat_interleave(2, 0)
               for k, v in vp.encode_prompts([""]).items()}
    with torch.no_grad():
        got = vp.sample_latents(tcond, tuncond, x0)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=SAMPLE_TOL,
        atol=SAMPLE_FIELD_TOL * float(np.abs(want).max()))


def _pooled_of_shards(root):
    out = {}
    for path in sorted(glob.glob(f"{root}/shard-*.tar")):
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if m.name.endswith(".pooled.npy"):
                    out[m.name.split(".")[0]] = np.load(
                        io.BytesIO(tf.extractfile(m).read()))
    return out


def test_sdxl_extraction_writes_the_jax_pooled_text(tmp_path, monkeypatch,
                                                    sdxl_weights):
    """SDXL's extraction pass (``extract_features``) through the entry
    point on raw JPEGs: each sample's ``pooled.npy`` is OpenCLIP-G's
    pooled vector of its compressed caption, equal to the JAX package's
    encoder on the same weights; latents and embeddings beside it."""
    from yat_tpu_torch.frontends import sdxl

    _, _, te2, trees = sdxl_weights
    shard = make_image_shard(tmp_path / "raw.tar", n=4, hw=(256, 256),
                             wide=False)
    # make_image_shard's captions
    captions = [" ".join(["word"] * (1 + i % 6)) + f" test image {i}"
                for i in range(4)]
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({
        "local_shard_paths": [str(shard)], "batch_size": "2",
        "learning_rate": "1e-3", "steps": "1", "extract_features": "true",
        "num_steps_per_validation": "100", "aspect_ratio": "256",
        "r2_dataset_folder": str(tmp_path / "features"),
        "model_config_overrides": TINY_SDXL}))
    real = sdxl.make_trainer
    monkeypatch.setattr(sdxl, "make_trainer",
                        lambda p, device=None: real(p, device=device,
                                                    weights=trees))
    trainer = sdxl.main(["--config", str(cfg), "--device", "cpu"])
    assert trainer.extraction.written == 4
    pooled = _pooled_of_shards(tmp_path / "features")
    assert len(pooled) == 4
    _, encode_pooled = _jax_sdxl_prompt_encoder(None, te2, None)
    want = encode_pooled(captions)
    # the shards' keys are the write order (bucketed); each vector must be
    # one caption's, and every caption's must be there
    hits = set()
    for vec in pooled.values():
        assert vec.shape == (32,)
        err = np.abs(want - vec).max(axis=1)
        assert err.min() < MODEL_TOL
        hits.add(int(err.argmin()))
    assert hits == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _feature_shard(path, n=8, lat=(8, 8), dim=64, pooled=32):
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(0)
    with TarShardWriter(str(path)) as w:
        for i in range(n):
            elem = {"__key__": f"{i:06d}", "ratio": "1.0",
                    "latent.npy": rng.standard_normal((*lat, 4),
                                                      dtype=np.float32),
                    "emb.npy": rng.standard_normal((77, dim),
                                                   dtype=np.float32)}
            if pooled:
                elem["pooled.npy"] = rng.standard_normal(
                    (pooled,), dtype=np.float32)
            w.write(elem)
    return str(path)


def _train_config(tmp_path, over, **kw):
    cfg = {"batch_size": "2", "learning_rate": "1e-3", "steps": "2",
           "warmup_steps": "1", "num_steps_per_validation": "100",
           "validation_prompts": [], "lora_rank": "4", "lora_alpha": "4",
           "lora_algo": "lora",
           "lora_target_modules": ["to_q", "to_k", "to_v", "to_out"],
           "output_dir": str(tmp_path / "out"),
           "model_config_overrides": dict(over)}
    cfg.update(kw)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_sdxl_entry_point_trains_on_feature_shards_with_pooled_text(
        tmp_path, monkeypatch):
    """``python -m yat_tpu_torch.frontends.sdxl`` on feature shards with
    ``pooled.npy``: each device batch carries the shards' pooled text and
    the bucket's time_ids to the UNet; LoRA trains and exports."""
    from yat_tpu_torch.frontends.sdxl import main
    from yat_tpu_torch.models.unet import UNet2DCondition

    seen = []
    real = UNet2DCondition.forward

    def spy(self, *a, pooled_text=None, time_ids=None, **kw):
        seen.append((pooled_text, time_ids))
        return real(self, *a, pooled_text=pooled_text, time_ids=time_ids,
                    **kw)
    monkeypatch.setattr(UNet2DCondition, "forward", spy)
    cfg = _train_config(tmp_path, TINY_SDXL, local_shard_paths=[
        _feature_shard(tmp_path / "s.tar")], use_preservation="true")
    trainer = main(["--config", cfg, "--device", "cpu"])
    assert trainer.global_step == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert (tmp_path / "out" / "2" / "adapter_model.safetensors").exists()
    # the task loss and the preservation term's two predictions a step
    assert len(seen) == 2 * 3
    for pooled, ids in seen:
        assert pooled.shape == (2, 32) and bool(pooled.abs().sum() > 0)
        # the 1024 px bins' square bucket (no aspect_ratio configured)
        assert ids.tolist() == [[1024, 1024, 0, 0, 1024, 1024]] * 2


def test_sdxl_trainer_refuses_a_pooled_dim_off_the_unet():
    """The zero pooled text of shards without one is as wide as the UNet's
    ``addition_embed_dim``; a ``pooled_dim`` override (the JAX package's
    key) that differs raises before anything is built."""
    from yat_tpu_torch.frontends.sdxl import make_trainer

    with pytest.raises(ValueError, match="addition_embed_dim 32"):
        make_trainer(_params({**TINY_SDXL, "pooled_dim": "16"}), device="cpu")


def test_sd15_entry_point_trains_on_the_fly(tmp_path, monkeypatch):
    """``python -m yat_tpu_torch.frontends.sd15`` with ``compute_features``
    on raw JPEGs: CLIP-L on the compressed captions (77 tokens, every
    position kept) and the KL-VAE encode on the fly, 2 LoRA steps (three
    UNet levels, attention at the deepest only, and a third level of the
    tiny VAE, so its 64x64 latents stay cheap on the CPU where the
    two-level VAE's 128x128 grid makes its mid-block attention 16384
    tokens long), with REPA on ``mid_attn`` through the generic path (the
    tiny DINOv2's tokens, a head that trains)."""
    import dataclasses

    from yat_tpu_torch.frontends.sd15 import main
    from yat_tpu_torch.models import vae

    monkeypatch.setattr(vae, "KLVAE_TINY_TEST", dataclasses.replace(
        vae.KLVAE_TINY_TEST, block_out_channels=(32, 32, 32)))

    shard = make_image_shard(tmp_path / "raw.tar", n=4, hw=(256, 256),
                             wide=False)
    over = {**TINY_SD15, "block_out_channels": ["32", "32", "32"],
            "transformer_layers": ["0", "0", "1"]}
    cfg = _train_config(tmp_path, over, local_shard_paths=[str(shard)],
                        compute_features="true", aspect_ratio="256",
                        vae_max_batch_size="2",
                        text_encoder_max_batch_size="2", cache_size="2",
                        use_repa="true")
    trainer = main(["--config", cfg, "--device", "cpu"])
    assert trainer.global_step == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert trainer.history[0]["caption_len"] == 77
    assert trainer.repa_config.target_modules == ("mid_attn",)
    assert any(n.startswith("repa_head.") for n in trainer.trainable_names())


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_serve_and_generate_on_cpu(tmp_path, family):
    """``serve`` answers a request and ``generate`` writes a PNG for the
    family at the tiny size (2 DDIM steps)."""
    from yat_tpu_torch import generate
    from yat_tpu_torch.serve import build_sampler

    over = TINY_SD15 if family == "sd15" else TINY_SDXL
    s = build_sampler(_params(over), family, max_batch=2, device="cpu",
                      steps=2)
    try:
        img = s.submit("a red fox", timeout=300)
        # 256 px over 8 = 32 latents, the tiny VAE's 2x decode: 64 px
        assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    finally:
        s.stop()
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "aspect_ratio": "256",
        "model_config_overrides": over}))
    out = tmp_path / "out"
    generate.main(["--config", str(cfg), "--family", family, "--prompt",
                   "a red fox", "--steps", "2", "--out", str(out),
                   "--device", "cpu"])
    assert len((out / "prompts.txt").read_text().splitlines()) == 1
