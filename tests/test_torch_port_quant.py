"""PyTorch port, the quantized base and the 8-bit optimizer on the CPU:
``yat_tpu_torch/ops/quant.py`` (quantization, the w8a8 gate, the plain
versions of K5 and K5b; the 4-bit payload packed two values a byte, its
``tp`` slices, ``fsdp`` chunks, resident bytes and old-layout
checkpoints), the quantized branch of ``AdapterDense``,
``convert.load_flax_params`` on a quantized tree, and Lion with 8-bit
momentum (``ops/opt8bit.py`` through ``train/state.py:Optimizer``), each
against the JAX package on the same numpy inputs.  The Pallas kernels run
interpreted (``_FORCE_PALLAS_INTERPRET``, as ``tests/test_quant.py`` does).

Equality is expected wherever both sides round the same values the same
way: the int8 payloads and scales, the K5/K5b outputs (exact int32 sums,
then the same fp32 products).  The JAX package runs the kernels inside jit,
where XLA turns ``absmax / 127.0`` into a product with fp32(1/127); the
port does the same, and the eager ``quantize_kernel`` divides on both
sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yat_tpu_torch.ops import quant as TQ
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# the LoRA branch, the dequantized matmul and the optimizer run fp32
# matmuls and sums in another order on the two sides: each output within
# 1e-5 of its largest magnitude, the optimizer's leaves within 1e-6
FP32_TOL = 1e-5
LEAF_TOL = 1e-6


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=FP32_TOL * float(np.abs(want).max()))


@pytest.fixture
def interpret(monkeypatch):
    from yat_tpu.ops import quant as JQ
    monkeypatch.setattr(JQ, "_FORCE_PALLAS_INTERPRET", True)
    return JQ


def _weight(k, n, seed=0):
    """A ``[k, n]`` kernel in the JAX layout with a zero output channel."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * k ** -0.5
    w[:, 3] = 0.0
    return w


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kernel_matches_jax(bits):
    from yat_tpu.ops.quant import quantize_kernel as jq
    w = _weight(256, 384)
    qj, sj = jq(jnp.asarray(w), bits)
    q, s = TQ.quantize_kernel(torch.from_numpy(w.T.copy()), bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj).astype(np.int8).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert int(q.abs().max()) == 2 ** (bits - 1) - 1 and s[3] == 1.0
    back = TQ.dequantize_kernel(q, s, torch.float32)
    from yat_tpu.ops.quant import dequantize_kernel as jd
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jd(qj, sj, jnp.float32)).T)


# --- the 4-bit base packed two values a byte ------------------------------

def _int4(shape, seed):
    """4-bit values -7..7 as int8, every value at both nibble positions."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -7, 8, shape).astype(np.int8))


@pytest.mark.parametrize("n", [30, 31])
def test_pack_int4_round_trips_every_value(n):
    """``pack_int4``/``unpack_int4`` at an even and an odd length: every
    value -7..7 in either nibble comes back; the layout is column 2j in
    byte j's low nibble and 2j + 1 in its high one, two's complement, an
    odd length's last high nibble 0."""
    q = ((torch.arange(15)[:, None] + torch.arange(n)[None]) % 15 - 7).to(
        torch.int8)
    p = TQ.pack_int4(q)
    assert p.dtype == torch.uint8 and tuple(p.shape) == (15, (n + 1) // 2)
    assert torch.equal(TQ.unpack_int4(p, n), q)
    assert set(q[:, 0::2].flatten().tolist()) == set(range(-7, 8)) == set(
        q[:, 1::2].flatten().tolist())
    assert TQ.pack_int4(torch.tensor([[-1, 3, -7]], dtype=torch.int8)
                        ).tolist() == [[0x3F, 0x09]]
    if n % 2:
        assert not bool((p[:, -1] >> 4).any())


@pytest.mark.parametrize("k", [64, 37])
def test_adapter_dense_4bit_base_is_packed_and_matches_jax(k):
    """A 4-bit ``AdapterDense`` holds its payload packed, uint8
    ``[out, ceil(in / 2)]``, and its output is bit-equal to the JAX
    ``AdapterDense`` on the same int4 kernel (values, power-of-two scales
    and small-integer inputs make every product and sum exact, so the two
    sides' summation orders cannot differ); ``base_weight`` and
    ``dequantize_params`` give the floats of the unpacked values, as the
    payload held one value a byte gave them."""
    from yat_tpu.models import layers as JL
    from yat_tpu_torch.models.layers import AdapterDense
    rng = np.random.default_rng(5)
    n = 24
    q = _int4((n, k), 6)
    s = (2.0 ** rng.integers(-4, 1, n)).astype(np.float32)
    bias = rng.integers(-3, 4, n).astype(np.float32)
    x = rng.integers(-4, 5, (2, 5, k)).astype(np.float32)
    yj = JL.AdapterDense(n, dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(q.numpy().T, jnp.int4),
                    "bias": jnp.asarray(bias)},
         "quant_scales": {"kernel_scale": jnp.asarray(s)}}, jnp.asarray(x))
    m = AdapterDense(k, n, dtype=torch.float32)
    m.set_quantized(q, torch.from_numpy(s), 4)
    m.bias.data = torch.from_numpy(bias)
    assert m.weight is None and m.qweight.dtype == torch.uint8
    assert tuple(m.qweight.shape) == (n, (k + 1) // 2)
    assert torch.equal(m.payload_values(), q)
    y = m(torch.from_numpy(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(yj))
    want = TQ.dequantize_kernel(q, torch.from_numpy(s), torch.bfloat16)
    assert torch.equal(m.base_weight(torch.bfloat16), want)
    holder = torch.nn.Sequential(m)
    assert TQ.dequantize_params(holder, torch.bfloat16) == 1
    assert m.qweight is None and torch.equal(m.weight, want)


def test_tp_slices_a_packed_payload_at_whole_bytes():
    """``tp``'s slices of a packed payload are the packing of the values'
    slice: a row-parallel layer's inputs at per-head indices (whole
    bytes), a column-parallel one's outputs; the peers' bytes gather back
    into the whole payload (``packed_order``); indices that split a byte
    raise, naming the layer and the indices."""
    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.parallel.tensor import TPShard
    k, n = 16, 8
    q = _int4((n, k), 7)
    s = torch.rand(n) + 0.5
    heads = [torch.tensor([4, 5, 6, 7, 12, 13, 14, 15]),
             torch.tensor([0, 1, 2, 3, 8, 9, 10, 11])]
    for role, idx, dim in (("row", heads[0], 1),
                           ("col", torch.tensor([1, 2, 5, 6]), 0)):
        m = AdapterDense(k, n, dtype=torch.float32)
        m.set_quantized(q, s, 4)
        m.tp = TPShard(None, 2, 0, role, k if role == "row" else n, idx,
                       name="blocks.0.attn.to_out")
        m.shard_tp_base()
        part = q.index_select(dim, idx)
        assert torch.equal(m.qweight, TQ.pack_int4(part)), role
        assert torch.equal(m.payload_values(), part), role
        assert torch.equal(m.base_weight(torch.float32),
                           TQ.dequantize_kernel(
                               part, s if role == "row" else s[idx],
                               torch.float32)), role
    packed = TQ.pack_int4(q)
    shards = [TPShard(None, 2, r, "row", k, idx) for r, idx in
              enumerate(heads)]
    shards[0].order = torch.argsort(torch.cat(heads))
    gathered = torch.cat([t.take(packed, 1, True) for t in shards], 1)
    assert torch.equal(gathered.index_select(1, shards[0].packed_order()),
                       packed)
    m = AdapterDense(k, n, dtype=torch.float32)
    m.set_quantized(q, s, 4)
    m.tp = TPShard(None, 2, 0, "row", k, torch.tensor([1, 2, 3, 4, 5, 6,
                                                        7, 8]),
                   name="blocks.0.attn.to_out")
    with pytest.raises(ValueError, match=r"blocks\.0\.attn\.to_out at "
                       r"input indices that split a byte \(\[1, 2, 3"):
        m.shard_tp_base()


def test_fsdp_shards_a_packed_payload_in_whole_bytes(monkeypatch):
    """``ShardedBase`` decides on the 4-bit payload's unpacked flax shape
    ``[in, out]``: fsdp 2 takes its 16 inputs, 4 bytes a process; the
    chunks gather back into the whole payload and the layer computes what
    the unsharded one does; 6 inputs do not make whole bytes for 2
    processes and raise, naming the leaf."""
    import torch.distributed as dist
    from torch import nn

    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.parallel.mesh import ShardedBase
    q, s = _int4((8, 16), 8), torch.rand(8) + 0.5

    def model(k, n, values):
        root = nn.Module()
        root.proj = AdapterDense(k, n, dtype=torch.float32)
        root.proj.set_quantized(values, s[:n], 4)
        root.proj.bias.data.zero_()
        return root
    whole = model(16, 8, q)
    x = torch.randn(3, 16)
    want = whole.proj(x)
    models, bases = [], []
    for rank in (0, 1):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=rank: r)
        models.append(model(16, 8, q))
        bases.append(ShardedBase(models[-1], None, 2))
        assert bases[-1].owned[models[-1].proj] == [("qweight", 1, False)]
    parts = [m.proj.qweight for m in models]
    assert all(tuple(p.shape) == (8, 4) for p in parts)
    monkeypatch.setattr(bases[0], "_gather",
                        lambda part, dim: torch.cat(parts, dim))
    with bases[0].gathered():
        assert torch.equal(models[0].proj.qweight, TQ.pack_int4(q))
    assert models[0].proj.qweight is parts[0]
    assert torch.equal(models[0].proj(x), want)
    with pytest.raises(ValueError, match="proj/kernel along its 6 inputs"):
        ShardedBase(model(6, 4, q[:4, :6]), None, 2)


def test_frozen_bytes_count_the_packed_payload():
    """``frozen_bytes`` of a 4-bit base is half that of the same layer's
    8-bit payload (one value a byte)."""
    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.parallel.mesh import frozen_bytes
    held = {}
    for bits in (8, 4):
        m = AdapterDense(64, 32, dtype=torch.float32)
        m.reset_parameters(torch.Generator().manual_seed(0))
        m.quantize(bits)
        held[bits] = frozen_bytes(m)
    assert held == {8: 64 * 32, 4: 64 * 32 // 2}


def test_an_unpacked_4bit_checkpoint_names_its_layout(tmp_path):
    """Restoring a checkpoint whose 4-bit base holds one value a byte
    (int8 ``[out, in]``, the layout before packing) raises a message that
    names both layouts, not a bare shape error."""
    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.train.checkpoint import restore_train_state
    m = AdapterDense(16, 8, dtype=torch.float32)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m.quantize(4)
    old = {k: v.clone() for k, v in m.state_dict().items()}
    old["qweight"] = m.payload_values().clone()
    torch.save({"step": 3, "model": old}, tmp_path / "3.pt")
    with pytest.raises(ValueError, match=r"model/qweight: .*unpacked layout "
                       r"\(int8 \(8, 16\).*two values a byte \(uint8 "
                       r"\(8, 8\)"):
        restore_train_state(str(tmp_path), {"step": 0,
                                            "model": m.state_dict()})


def _row_inputs(t, c, seed=1):
    x = np.random.default_rng(seed).standard_normal((t, c)).astype(
        np.float32)
    x[0] = 0.0                  # a zero row: scale 1.0
    x[1, 7] = 1e4               # one large value among normal ones
    return x


def test_row_quantize_matches_jax():
    from yat_tpu.ops.quant import _row_quantize
    x = _row_inputs(256, 384)
    x8j, sj = jax.jit(_row_quantize)(jnp.asarray(x))
    x8, s = TQ.row_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(x8j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj)[:, 0])
    assert s[0] == 1.0 and int(x8[1, 7]) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_plain_versions_match_interpreted_kernels(interpret, dtype):
    """K5's plain version against ``_pallas_w8a8_fwd2d`` and K5b's against
    ``jax.grad`` through ``w8a8_matmul`` (``_pallas_w8a8_bwd2d``), both
    interpreted, at T = 384 (three row blocks of 128) and N = 768 (two
    column blocks of 384): equal (tolerance 0).  The port's autograd
    Function on CPU tensors gives the same bits."""
    JQ = interpret
    t, k, n = 384, 256, 768
    x = _row_inputs(t, k)
    w = _weight(k, n)
    g = np.random.default_rng(2).standard_normal((t, n)).astype(np.float32)
    g[5] = 0.0
    qj, sj = JQ.quantize_kernel(jnp.asarray(w), 8)
    jdt = jnp.dtype(dtype)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    yj = JQ._pallas_w8a8_fwd2d(xj, qj, sj, jdt)
    dxj = jax.grad(lambda a: jnp.sum(
        (JQ.w8a8_matmul(a, qj, sj) * gj).astype(jnp.float32)))(xj)
    tdt = getattr(torch, dtype)
    q = torch.from_numpy(np.asarray(qj).T.copy())
    s = torch.from_numpy(np.array(sj))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(tdt)
    y = TQ.w8a8_matmul_ref(xt, q, s)
    dx = TQ.w8a8_matmul_bwd_ref(gt, q, s)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(yj.astype(jnp.float32)))
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dxj.astype(jnp.float32)))
    leaf = xt.clone().requires_grad_()
    out = TQ.w8a8_matmul(leaf, q, s)
    out.backward(gt)
    assert torch.equal(out, y) and torch.equal(leaf.grad, dx)


def test_w8a8_branch_matches_jax_gate(interpret):
    """The gate tabulated against ``_pallas_w8a8_ok`` with the force flag
    on (the backend and device-count test are not ported)."""
    JQ = interpret
    dims = (16, 64, 128, 256, 384, 1152, 2880, 4608, 5760, 6144, 6272, 8192)
    for t in dims:
        for k in dims:
            for n in dims:
                assert TQ.w8a8_branch(t, k, n) == JQ._pallas_w8a8_ok(t, k, n), \
                    (t, k, n)
    # SANA-0.6B: every projection takes K5 but GLUMB's down-projection
    assert TQ.w8a8_branch(4096, 1152, 5760)
    assert not TQ.w8a8_branch(4096, 2880, 1152)
    assert not TQ.w8a8_branch(16, 1152, 6912)


def test_w8a8_fallback_is_the_dequant_matmul(interpret):
    """Off the gate (K = 320, T = 100) both packages multiply by the weight
    dequantized to the input's dtype, forward and backward."""
    JQ = interpret
    x = _row_inputs(100, 320)
    w = _weight(320, 128)
    qj, sj = JQ.quantize_kernel(jnp.asarray(w), 8)
    yj, vjp = jax.vjp(lambda a: JQ.w8a8_matmul(a, qj, sj), jnp.asarray(x))
    g = np.random.default_rng(3).standard_normal((100, 128)).astype(
        np.float32)
    (dxj,) = vjp(jnp.asarray(g))
    q = torch.from_numpy(np.asarray(qj).T.copy())
    s = torch.from_numpy(np.asarray(sj))
    leaf = torch.from_numpy(x).requires_grad_()
    y = TQ.w8a8_matmul(leaf, q, s)
    assert torch.equal(y, torch.nn.functional.linear(
        leaf, TQ.dequantize_kernel(q, s, torch.float32)))
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), yj)
    _close(leaf.grad.numpy(), dxj)


@pytest.mark.parametrize("w8a8", [False, True])
def test_adapter_dense_int8_base_matches_jax(interpret, monkeypatch, w8a8):
    """``AdapterDense`` with an int8 base and LoRA against the JAX module:
    without w8a8 the merged LoRA form over the dequantized weight, with it
    K5 (plain version) and the chain form on top.  Output and the gradients
    of x, lora_a and lora_b within ``FP32_TOL`` of their largest entry."""
    from yat_tpu.models import layers as JL
    from yat_tpu_torch.models import layers as TL
    monkeypatch.setattr(JL, "_INT8_W8A8", w8a8)
    monkeypatch.setattr(JL, "_LORA_MERGED", True)
    rng = np.random.default_rng(4)
    k, n, r = 128, 256, 4
    x = rng.standard_normal((2, 64, k)).astype(np.float32)
    qj, sj = interpret.quantize_kernel(jnp.asarray(_weight(k, n)), 8)
    bias = 0.1 * rng.standard_normal(n).astype(np.float32)
    a = rng.standard_normal((k, r)).astype(np.float32) * 0.1
    b = rng.standard_normal((r, n)).astype(np.float32) * 0.1
    g = rng.standard_normal((2, 64, n)).astype(np.float32)
    dense = JL.AdapterDense(n, dtype=jnp.float32)

    def jf(xx, aa, bb):
        return dense.apply({"params": {"kernel": qj, "bias": bias},
                            "quant_scales": {"kernel_scale": sj},
                            "adapters": {"lora_a": aa, "lora_b": bb},
                            "adapters_meta": {"lora_scale": jnp.float32(2.0)}},
                           xx)
    yj, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    grads_j = vjp(jnp.asarray(g))

    m = TL.AdapterDense(k, n, dtype=torch.float32)
    m.set_quantized(torch.from_numpy(np.asarray(qj).T.copy()),
                    torch.from_numpy(np.asarray(sj)), 8)
    m.bias.data = torch.from_numpy(bias)
    m.attach_lora(torch.from_numpy(a), torch.from_numpy(b), 2.0)
    m.w8a8 = w8a8
    if w8a8:
        def merged(*args):
            raise AssertionError("w8a8 takes the chain form")
        monkeypatch.setattr(TL._LoraMerged, "apply", merged)
    assert m.weight is None and m.qweight.dtype == torch.int8
    assert {n for n, _ in m.named_parameters()} == {"bias", "lora_a",
                                                    "lora_b"}
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), yj)
    for got, want in zip((xt.grad, m.lora_a.grad, m.lora_b.grad), grads_j):
        _close(got.numpy(), want)


# the slice parity configuration cut to a CPU test: widths that pass the
# w8a8 gate (128; GLUMB's 320-wide down-projection falls back as 2880 does)
TINY_W8A8 = dict(hidden_dim=128, num_layers=2, num_attention_heads=4,
                 attention_head_dim=32, num_cross_attention_heads=2,
                 cross_attention_head_dim=64, caption_channels=128,
                 max_caption_len=64, in_channels=4, out_channels=4,
                 sample_size=8, mlp_ratio=2.5)


@pytest.fixture(scope="module")
def w8a8_sana_params():
    """The JAX SANA's parameters at ``TINY_W8A8`` (numpy), its init under
    one jit (an eager flax init compiles op by op)."""
    from yat_tpu.models.sana import SanaConfig as JConfig
    from yat_tpu.models.sana import SanaTransformer2D as JSana
    variables = jax.jit(JSana(cfg=JConfig(**TINY_W8A8),
                              dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1, 64, 128)), jnp.zeros((1,)),
        jnp.ones((1, 64), jnp.int32))
    return jax.tree.map(np.asarray, variables["params"])


@pytest.mark.parametrize("min_size", [4096, 256])
def test_quantize_params_and_convert_match_jax(w8a8_sana_params, min_size):
    """``quantize_params`` quantizes the same dense kernels as the JAX
    package's (only ``AdapterDense`` weights, never the scale-shift tables,
    which reach 768 elements here and so pass ``min_size`` 256), with equal
    payloads and scales; ``load_flax_params`` carries the JAX quantized tree
    (int8 kernels plus ``quant_scales``) into the same buffers."""
    from yat_tpu.ops.quant import quantize_params as jqp
    from yat_tpu_torch.convert import load_flax_params
    from yat_tpu_torch.models.layers import AdapterDense
    from yat_tpu_torch.models.sana import SanaConfig, SanaTransformer2D

    params = w8a8_sana_params
    qparams, scales = jqp(params, bits=8, min_size=min_size)

    def paths(tree, prefix=()):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from paths(val, prefix + (key,))
            elif key == "kernel" and np.asarray(val).dtype == np.int8:
                yield ".".join(prefix).replace("blocks_", "blocks.")
    want = set(paths(qparams))
    assert want and not any("scale_shift" in p for p in want)

    tcfg = SanaConfig(**TINY_W8A8)
    ours = SanaTransformer2D(tcfg, dtype=torch.float32)
    load_flax_params(ours, params)
    n = TQ.quantize_params(ours, 8, min_size=min_size)
    loaded = SanaTransformer2D(tcfg, dtype=torch.float32)
    load_flax_params(loaded, jax.tree.map(np.asarray, qparams),
                     jax.tree.map(np.asarray, scales))
    got = {p for p, m in ours.named_modules()
           if isinstance(m, AdapterDense) and m.qweight is not None}
    assert got == want and n == len(want)
    for (p, m), (_, m2) in zip(ours.named_modules(), loaded.named_modules()):
        if isinstance(m, AdapterDense) and m.qweight is not None:
            assert torch.equal(m.qweight, m2.qweight), p
            assert torch.equal(m.weight_scale, m2.weight_scale), p
            assert m2.bits == 8 and m.weight is None and m2.weight is None
    # everything else stays floating and trainable-shaped
    assert ours.blocks[0].scale_shift_table.dtype == torch.float32
    assert all(p.is_floating_point() for p in ours.parameters())
    assert TQ.dequantize_params(loaded) == len(want)
    assert all(m.qweight is None for m in loaded.modules()
               if isinstance(m, AdapterDense))


def test_lion_8bit_matches_optax():
    """``use_adamw_8bit``: clip → Lion with 8-bit momentum → the schedule
    → accumulation over 2 micro-steps, 4 updates, against the JAX
    ``make_optimizer`` (jitted, as inside the JAX step): the int8 momentum
    payloads equal; the block scales (absmax of a momentum summed in
    another order: one fp32 ulp apart at most here) and the leaves within
    1e-6.  One leaf
    spans two blocks of 2048 with padding; the first update has lr 0."""
    import optax

    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.train.state import make_optimizer
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.train.state import Optimizer

    raw = {"batch_size": "2", "learning_rate": "1e-2", "steps": "4",
           "num_steps_per_validation": "10", "validation_prompts": [],
           "warmup_steps": "2", "weight_decay": "0.01",
           "gradient_accumulation_steps": "2", "use_adamw_8bit ": "",
           "max_grad_norm": "1.0"}
    rng = np.random.default_rng(6)
    shapes = [(300, 8), (8, 64)]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = make_optimizer(JParams.from_dict({**raw, "urls": []}))
    jleaves = [jnp.asarray(p) for p in leaves]
    state = tx.init(jleaves)

    @jax.jit
    def jstep(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    params = TrainingParameters.from_dict(raw)
    assert params.use_adamw_8bit
    tleaves = [torch.from_numpy(p.copy()) for p in leaves]
    opt = Optimizer(params, tleaves)
    for i in range(8):
        # the clip engages on some micro-steps only
        grads = [rng.standard_normal(s).astype(np.float32) * (0.01 + i % 3)
                 for s in shapes]
        jleaves, state = jstep(jleaves, state, [jnp.asarray(g) for g in grads])
        synced = opt.update([torch.from_numpy(g) for g in grads])
        assert synced == (i % 2 == 1)
        if i == 1:
            assert opt.count == 1
            np.testing.assert_array_equal(tleaves[0].numpy(), leaves[0])
    assert opt.count == 4
    for got, want in zip(tleaves, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LEAF_TOL, rtol=LEAF_TOL)
    from yat_tpu.ops.opt8bit import _Quantized
    mom = [leaf for leaf in jax.tree.leaves(
        state, is_leaf=lambda x: isinstance(x, _Quantized))
        if isinstance(leaf, _Quantized)]
    assert len(mom) == 2
    for (q, s), qj in zip(opt.lion.momentum, mom):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj.q))
        np.testing.assert_allclose(s.numpy(), np.asarray(qj.scale),
                                   rtol=LEAF_TOL, atol=0)
    assert opt.lion.momentum[0][0].numel() == 2 * 2048
