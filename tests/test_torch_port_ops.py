"""PyTorch port, kernel modules (yat_tpu_torch/ops): the plain versions that
CPU tensors run against the JAX package's Pallas kernels (interpret mode)
and its public functions, on the same numpy inputs.  The CUDA kernels
against the plain versions are in test_torch_port_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yat_tpu.ops import attention as JA
from yat_tpu.ops import norm as JN
from yat_tpu_torch.ops import attention as TA
from yat_tpu_torch.ops import norm as TN

# tolerances pinned by the JAX package's own tests (tests/test_norm.py,
# tests/test_attention.py): fp32 forward
ADALN_TOL = 1e-6
ATTN_TOL = 2e-5
LINATT_TOL = 1e-4


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# K1: adaLN LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod_form", ["BD", "B1D"])
def test_adaln_matches_jax_kernel_and_public(mod_form):
    rng = np.random.default_rng(0)
    b, n, d = 2, 128, 256
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    sc = (0.1 * rng.standard_normal((b, d))).astype(np.float32)
    sh = (0.1 * rng.standard_normal((b, d))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        kern = JN._adaln_p(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(sh),
                           1e-6)
    shape = (b, d) if mod_form == "BD" else (b, 1, d)
    pub = JN.adaln_layernorm(jnp.asarray(x), jnp.asarray(sc.reshape(shape)),
                             jnp.asarray(sh.reshape(shape)))
    port = TN.adaln_layernorm(torch.from_numpy(x),
                              torch.from_numpy(sc.reshape(shape)),
                              torch.from_numpy(sh.reshape(shape)))
    np.testing.assert_allclose(_np(port), np.asarray(kern), atol=ADALN_TOL)
    np.testing.assert_allclose(_np(port), np.asarray(pub), atol=ADALN_TOL)


def test_adaln_ragged_rows_and_cpu_never_launches():
    """N not a multiple of anything (77 rows); a CPU tensor takes the plain
    version and never touches the kernel (no build, no launch count)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 77, 96)).astype(np.float32)
    sc = (0.1 * rng.standard_normal((1, 1, 96))).astype(np.float32)
    sh = (0.1 * rng.standard_normal((1, 1, 96))).astype(np.float32)
    before = TN.ADALN.launches
    port = TN.adaln_layernorm(*(torch.from_numpy(a) for a in (x, sc, sh)))
    pub = JN.adaln_layernorm(*(jnp.asarray(a) for a in (x, sc, sh)))
    np.testing.assert_allclose(_np(port), np.asarray(pub), atol=ADALN_TOL)
    assert TN.ADALN.launches == before


def test_adaln_bf16_keeps_rounding_order():
    """bf16: mean and 1/sqrt(var+eps) round to bf16 before the bf16 chain
    (the plain version replicates yat_tpu's _adaln_ref op by op); checked
    against an fp64 emulation of that chain with explicit bf16 rounding."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(
        np.float32)).bfloat16()
    sc = (0.1 * torch.from_numpy(rng.standard_normal((2, 64)).astype(
        np.float32))).bfloat16()
    sh = (0.1 * torch.from_numpy(rng.standard_normal((2, 64)).astype(
        np.float32))).bfloat16()
    out = TN.adaln_layernorm(x, sc, sh)
    assert out.dtype == torch.bfloat16

    def r(t):                                  # round to bf16
        return t.to(torch.bfloat16).double()
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-6)
    y = r(x.double() - r(mean))
    y = r(y * r(inv))
    y = r(y * r(1 + sc.double()[:, None]))
    y = r(y + sh.double()[:, None])
    assert torch.equal(out.double(), y)


def test_adaln_rejects_other_devices():
    """No silent fallback: only cpu (plain) and cuda (kernel) run."""
    x = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        TN.adaln_layernorm(x, torch.empty((1, 8), device="meta"),
                           torch.empty((1, 8), device="meta"))


# ---------------------------------------------------------------------------
# K2: short-sequence softmax attention
# ---------------------------------------------------------------------------

def _qkv(b, nq, nk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))


def test_attention_matches_jax_native_kernel_with_bias():
    """The port's plain version against the native-layout Pallas kernel
    (_vmem_attn_native_p, interpreted), with a shared fp32 key bias."""
    b, nq, nk, h, d = 2, 16, 128, 2, 64
    q, k, v = _qkv(b, nq, nk, h, d)
    keep = np.array([[1], [77]])
    bias = np.where(np.arange(nk)[None] < keep, 0.0, -1e9).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        kern = JA._vmem_attn_native_p(
            1.0 / d ** 0.5, h, d, jnp.asarray(q.reshape(b, nq, h * d)),
            jnp.asarray(k.reshape(b, nk, h * d)),
            jnp.asarray(v.reshape(b, nk, h * d)), jnp.asarray(bias[:, None]))
    port = TA.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(bias))
    np.testing.assert_allclose(_np(port).reshape(b, nq, h * d),
                               np.asarray(kern), atol=ATTN_TOL)


@pytest.mark.parametrize("nk,mask_form", [(16, "BN"), (24, "B11N"),
                                          (300, "BN"), (40, None)])
def test_attention_matches_jax_public_and_vmem(nk, mask_form):
    """Ragged key counts (the JAX wrapper pads to 128 with -1e9; the port
    masks the edge) and both mask forms, against the JAX 'vmem' path
    (interpreted) and the public CPU path."""
    b, nq, h, d = 2, 16, 2, 64
    q, k, v = _qkv(b, nq, nk, h, d, seed=nk)
    mask = None
    if mask_form is not None:
        m = (np.arange(nk)[None] < np.array([[1], [nk - 3]])).astype(np.int32)
        mask = m if mask_form == "BN" else m.astype(bool)[:, None, None, :]
    jm = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        vmem = JA.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                        mask=jm, implementation="vmem")
    pub = JA.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   mask=jm)
    port = TA.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(port), np.asarray(vmem), atol=ATTN_TOL)
    np.testing.assert_allclose(_np(port), np.asarray(pub), atol=ATTN_TOL)


def test_attention_implementation_strings():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 1, 8))
    ref = TA.dot_product_attention(q, k, v)
    for impl in ("xla", "vmem"):
        assert torch.equal(TA.dot_product_attention(q, k, v,
                                                    implementation=impl), ref)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    with pytest.raises(ValueError, match="unknown attention"):
        TA.dot_product_attention(q, k, v, implementation="splash")
    with pytest.raises(ValueError, match="unknown attention"):
        JA.dot_product_attention(jq, jk, jv, implementation="splash")
    with pytest.raises(ValueError, match="multiples of 128"):
        TA.dot_product_attention(q, k, v, implementation="flash")
    with pytest.raises(ValueError, match="multiples of 128"):
        JA.dot_product_attention(jq, jk, jv, implementation="flash")


# ---------------------------------------------------------------------------
# K3: ReLU linear attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [24, 100])
def test_linear_attention_matches_jax_kernel_and_public(n):
    b, h, d = 2, 3, 16
    q, k, v = _qkv(b, n, n, h, d, seed=n)

    def fold(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, n, d))
    with pltpu.force_tpu_interpret_mode():
        kern = JA._linear_attention_p(fold(q), fold(k), fold(v), 1e-15)
    kern = np.asarray(kern).reshape(b, h, n, d).transpose(0, 2, 1, 3)
    pub = JA.linear_attention(*(jnp.asarray(a) for a in (q, k, v)))
    port = TA.linear_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(_np(port), kern, atol=LINATT_TOL,
                               rtol=LINATT_TOL)
    np.testing.assert_allclose(_np(port), np.asarray(pub), atol=LINATT_TOL,
                               rtol=LINATT_TOL)


def test_linear_attention_implementation_strings():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 1, 8))
    ref = TA.linear_attention(q, k, v)
    for impl in ("xla", "pallas"):
        assert torch.equal(TA.linear_attention(q, k, v, implementation=impl),
                           ref)
    with pytest.raises(ValueError, match="unknown linear-attention"):
        TA.linear_attention(q, k, v, implementation="triton")
    with pytest.raises(ValueError, match="unknown linear-attention"):
        JA.linear_attention(q.numpy(), k.numpy(), v.numpy(),
                            implementation="triton")


# ---------------------------------------------------------------------------
# Backward: K1b, K2b and the K3 gradient (fp32; tolerances of the JAX
# package's own backward tests: adaLN 1e-4 against autodiff, attention VJP
# 2e-4, linear attention 1e-4)
# ---------------------------------------------------------------------------

ADALN_BWD_TOL = 1e-4
ATTN_BWD_TOL = 2e-4
LINATT_BWD_TOL = 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("mod_form", ["BD", "B1D"])
def test_adaln_bwd_matches_jax_kernel_and_autograd(mod_form):
    """adaln_bwd_ref against the JAX _adaln_bwd (interpreted) and torch
    autograd of adaln_ref; the autograd.Function on CPU tensors runs it."""
    rng = np.random.default_rng(3)
    b, n, d = 2, 128, 256
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    sc = (0.1 * rng.standard_normal((b, d))).astype(np.float32)
    sh = (0.1 * rng.standard_normal((b, d))).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = JN._adaln_bwd(1e-6, (jnp.asarray(x), jnp.asarray(sc)),
                             jnp.asarray(g))
    port = TN.adaln_bwd_ref(_t(x), _t(sc), _t(g))
    xs, scs, shs = _t(x, True), _t(sc, True), _t(sh, True)
    TN.adaln_ref(xs, scs, shs).backward(_t(g))
    shape = (b, d) if mod_form == "BD" else (b, 1, d)
    xf = _t(x, True)
    scf, shf = _t(sc.reshape(shape), True), _t(sh.reshape(shape), True)
    TN.adaln_layernorm(xf, scf, shf).backward(_t(g))
    for p, w, a, f in zip(port, want, (xs.grad, scs.grad, shs.grad),
                          (xf.grad, scf.grad, shf.grad)):
        np.testing.assert_allclose(_np(p), np.asarray(w), atol=ADALN_BWD_TOL,
                                   rtol=ADALN_BWD_TOL)
        np.testing.assert_allclose(_np(p), _np(a), atol=ADALN_BWD_TOL,
                                   rtol=ADALN_BWD_TOL)
        np.testing.assert_array_equal(_np(f).reshape(_np(p).shape), _np(p))


@pytest.mark.parametrize("nk,keep", [(128, 77), (40, 33), (16, None)])
def test_attention_bwd_matches_jax_native_vjp(nk, keep):
    """attention_bwd_ref against the VJP of the native-layout Pallas kernel
    (_vmem_attn_native_p, interpreted) and against autodiff of the JAX
    public function, with a key mask and ragged key counts."""
    b, nq, h, d = 2, 16, 2, 32
    q, k, v = _qkv(b, nq, nk, h, d, seed=nk)
    g = np.random.default_rng(nk + 1).standard_normal(
        (b, nq, h, d)).astype(np.float32)
    mask = None
    bias = np.zeros((b, nk), np.float32)
    if keep is not None:
        mask = (np.arange(nk)[None] < np.array([[1], [keep]])).astype(
            np.int32)
        bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q_, k_, v_: JA._vmem_attn_native_p(
                1.0 / d ** 0.5, h, d, q_, k_, v_,
                jnp.asarray(bias[:, None])),
            *(jnp.asarray(a.reshape(a.shape[0], a.shape[1], h * d))
              for a in (q, k, v)))
        kern = vjp(jnp.asarray(g.reshape(b, nq, h * d)))
    jm = None if mask is None else jnp.asarray(mask)
    _, pub_vjp = jax.vjp(lambda q_, k_, v_: JA.dot_product_attention(
        q_, k_, v_, mask=jm), *(jnp.asarray(a) for a in (q, k, v)))
    pub = pub_vjp(jnp.asarray(g))
    port = TA.attention_bwd_ref(
        _t(q), _t(k), _t(v), None if mask is None else _t(bias), _t(g))
    qs, ks, vs = _t(q, True), _t(k, True), _t(v, True)
    TA.dot_product_attention(
        qs, ks, vs, mask=None if mask is None else _t(mask)).backward(_t(g))
    for p, kw, pw, f in zip(port, kern, pub, (qs.grad, ks.grad, vs.grad)):
        np.testing.assert_allclose(_np(p).reshape(np.asarray(kw).shape),
                                   np.asarray(kw), atol=ATTN_BWD_TOL)
        np.testing.assert_allclose(_np(p), np.asarray(pw), atol=ATTN_BWD_TOL)
        np.testing.assert_array_equal(_np(f), _np(p))


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_linear_attention_grad_matches_jax_vjp(impl):
    """The port's linear_attention gradient against jax.vjp of the JAX
    public function: 'auto' is the einsum branch on this backend (rounded
    state, a no-op in fp32), 'pallas' the kernel's custom VJP
    (interpreted)."""
    b, n, h, d = 2, 24, 3, 16
    q, k, v = _qkv(b, n, n, h, d, seed=5)
    g = np.random.default_rng(6).standard_normal((b, n, h, d)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: JA.linear_attention(
            *a, implementation=impl), *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(g))
    qs, ks, vs = _t(q, True), _t(k, True), _t(v, True)
    TA.linear_attention(qs, ks, vs, implementation=impl).backward(_t(g))
    for got, w in zip((qs.grad, ks.grad, vs.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(w),
                                   atol=LINATT_BWD_TOL, rtol=LINATT_BWD_TOL)


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_linear_attention_bf16_rounds_kv_like_jax_einsum():
    """bf16 at n = 256: the JAX package takes its einsum branch, which
    rounds the [D, D] state to bf16 before the second product
    (attention.py:493-502).  XLA:CPU cannot run that branch in bf16 (its
    bf16 x bf16 = f32 dots raise), so the reference is the branch's own jnp
    code with the bf16 operands upcast to fp32 before each contraction
    (exact products) and the kv.astype(bfloat16) kept.  Only fp32 summation
    order may remain: at most 1% of the elements differ, by at most one
    bf16 ulp (with an fp32 state, 25.5% differ)."""
    rng = np.random.default_rng(0)
    shape = (2, 256, 4, 32)
    q, k, v = (jnp.asarray(rng.standard_normal(shape, np.float32),
                           jnp.bfloat16) for _ in range(3))
    eps = 1e-15
    f32 = jnp.float32
    qf = jnp.maximum(q, 0)
    kf = jnp.maximum(k, 0)
    kv = jnp.einsum("bnhd,bnhe->bhde", kf.astype(f32), v.astype(f32))
    ksum = jnp.sum(kf.astype(f32), axis=1)
    num = jnp.einsum("bnhd,bhde->bnhe", qf.astype(f32),
                     kv.astype(jnp.bfloat16).astype(f32))
    den = jnp.einsum("bnhd,bhd->bnh", qf.astype(f32), ksum)[..., None]
    want = np.asarray((num / (den + eps)).astype(jnp.bfloat16).astype(f32))
    port = TA.linear_attention(*(torch.from_numpy(
        np.array(t.astype(f32))).bfloat16() for t in (q, k, v)), eps=eps)
    assert port.dtype == torch.bfloat16
    got = _np(port)
    diff = np.abs(got - want)
    share = float(np.mean(diff > 0))
    assert share <= 0.01, f"{share:.2%} of the elements differ"
    assert np.all(diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


def test_autograd_functions_gradcheck():
    """gradcheck in float64 of the three autograd.Functions on CPU tensors
    (plain forward, plain backward) at tiny shapes."""
    gen = torch.Generator().manual_seed(0)

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen, dtype=torch.float64)
                ).requires_grad_()

    x, sc, sh = r(2, 5, 8), r(2, 1, 8, scale=0.1), r(2, 8, scale=0.1)
    assert torch.autograd.gradcheck(
        lambda a, b, c: TN.adaln_layernorm(a, b, c), (x, sc, sh))
    q, k, v = r(2, 3, 2, 4), r(2, 6, 2, 4), r(2, 6, 2, 4)
    mask = torch.tensor([[1, 1, 0, 0, 0, 0], [1, 1, 1, 1, 1, 0]])
    assert torch.autograd.gradcheck(
        lambda a, b, c: TA.dot_product_attention(a, b, c, mask=mask),
        (q, k, v))
    q, k, v = r(1, 5, 2, 4), r(1, 5, 2, 4), r(1, 5, 2, 4)
    for impl in ("auto", "pallas"):
        assert torch.autograd.gradcheck(
            lambda a, b, c: TA.linear_attention(a, b, c,
                                                implementation=impl),
            (q, k, v))


def test_kv_rounding_follows_the_jax_branch_choice():
    assert TA.kv_rounding(256, 32, "auto")
    assert TA.kv_rounding(256, 32, "xla")
    assert TA.kv_rounding(8192, 32, "xla")
    assert not TA.kv_rounding(256, 32, "pallas")
    assert not TA.kv_rounding(4096, 32, "auto")
    # the auto gate's VMEM and alignment conditions
    assert TA.kv_rounding(4100, 32, "auto")
    assert TA.kv_rounding(32768, 32, "auto")


# ---------------------------------------------------------------------------
# Merged LoRA (models/layers.py:_LoraMerged) against the JAX custom VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_merged_matches_jax_vjp(dtype):
    """Forward and chain backward of the merged LoRA matmul against
    jax.vjp of yat_tpu's _lora_merged_matmul on the same leaves; fp32:
    summation order (1e-5); bf16: the two round the same ops, a few bf16
    ulps where the sums run in another order."""
    from yat_tpu.models.layers import _lora_merged_matmul
    from yat_tpu_torch.models.layers import _LoraMerged

    rng = np.random.default_rng(11)
    x, w, a, b, g = (rng.standard_normal(s).astype(np.float32) for s in
                     ((2, 5, 16), (16, 12), (16, 4), (4, 12), (2, 5, 12)))
    s = 0.5
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    y_j, vjp = jax.vjp(_lora_merged_matmul,
                       *(jnp.asarray(t, jd) for t in (x, w, a, b)),
                       jnp.asarray(s, jd))
    dx_j, _, da_j, db_j, _ = vjp(jnp.asarray(g, jd))
    xs, as_, bs = (_t(t).to(td).requires_grad_() for t in (x, a, b))
    y = _LoraMerged.apply(xs, _t(w.T).to(td), as_, bs, s)
    y.backward(_t(g).to(td))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for got, want in ((y, y_j), (xs.grad, dx_j), (as_.grad, da_j),
                      (bs.grad, db_j)):
        assert got.dtype == td
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_lora_chain_with_dropout_matches_its_formula():
    """Active LoRA dropout takes the chain form: y = x W + s ((x·m/keep) A) B
    with the mask m drawn from a generator seeded with dropout_seed; the
    same seed draws the same mask (remat recomputation)."""
    from yat_tpu_torch.models.layers import AdapterDense

    gen = torch.Generator().manual_seed(1)
    layer = AdapterDense(8, 6, dtype=torch.float32)
    layer.reset_parameters(gen)
    a = torch.randn(8, 2, generator=gen)
    b = torch.randn(2, 6, generator=gen)
    layer.attach_lora(a, b, scale=2.0, dropout=0.25)
    layer.dropout_seed = 123
    x = torch.randn(3, 4, 8, generator=gen)
    y = layer(x, deterministic=False)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(
        123)) < 0.75
    xa = torch.where(keep, x / 0.75, torch.zeros_like(x))
    want = x @ layer.weight.detach().T + layer.bias.detach() + 2.0 * (
        (xa @ a) @ b)
    torch.testing.assert_close(y.detach(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(layer(x, deterministic=False), y)
    # deterministic: the merged form, no dropout
    full = x @ (layer.weight.detach().T + 2.0 * a @ b) + layer.bias.detach()
    torch.testing.assert_close(layer(x).detach(), full, rtol=1e-5,
                               atol=1e-5)
    y.sum().backward()
    assert layer.lora_a.grad is not None and layer.lora_b.grad is not None
