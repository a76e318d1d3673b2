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
# The branch choice, K4 (folded layout), K6 (flash) and the XLA branch
# ---------------------------------------------------------------------------

# bf16: one bf16 rounding step of the output (2^-8 relative), where an
# exponential or a sum rounds the other way before the probabilities are
# rounded; fp32 as ATTN_TOL
BF16_TOL = {"atol": 2.0 ** -9, "rtol": 2.0 ** -8}


def _jax_branch(monkeypatch, b, nq, nk, h, d, impl):
    """The JAX package's own branch for these sizes, its gates asked as on
    a TPU; the native/folded split is the condition of
    yat_tpu/ops/attention.py:382-383, copied."""
    monkeypatch.setattr(JA.jax, "default_backend", lambda: "tpu")
    q = jax.ShapeDtypeStruct((b, nq, h, d), jnp.bfloat16)
    k = jax.ShapeDtypeStruct((b, nk, h, d), jnp.bfloat16)
    if impl == "vmem" or (impl == "auto" and JA._use_vmem_attn(q, k, k)):
        nkp = -(-nk // 128) * 128
        vmem_bwd = (3 * (nq + 2 * nkp) * h * d * 2) + 3 * nq * nkp * 4
        native = (JA._VMEM_NATIVE_LAYOUT and h * d % 128 == 0
                  and vmem_bwd <= 12 * 2 ** 20)
        return "native" if native else "folded"
    if impl == "xla" or (impl == "auto" and not JA._use_pallas_flash(q, k, k)):
        return "xla"
    return "flash"


@pytest.mark.parametrize("case,sizes,impl,branch", [
    ("SANA cross", (16, 256, 512, 16, 72), "auto", "native"),
    ("SANA softmax-patch self", (16, 256, 256, 36, 32), "auto", "native"),
    ("SANA cross, rung 128", (16, 256, 128, 16, 72), "auto", "native"),
    ("PixArt cross", (8, 1024, 300, 16, 72), "auto", "folded"),
    ("PixArt self", (8, 1024, 1024, 16, 72), "auto", "flash"),
    ("PixArt 1024px self", (2, 4096, 4096, 16, 72), "auto", "flash"),
    ("896-token bucket", (2, 896, 896, 16, 72), "auto", "xla"),
    ("d = 512", (2, 1024, 1024, 2, 512), "auto", "xla"),
    ("longest short keys", (2, 128, 4096, 4, 72), "auto", "folded"),
    ("ragged queries", (4, 100, 300, 16, 72), "auto", "xla"),
    ("ragged queries, vmem", (4, 100, 300, 16, 72), "vmem", "native"),
    ("tiny heads", (2, 64, 16, 2, 32), "auto", "folded"),
    ("xla asked", (8, 256, 512, 16, 72), "xla", "xla"),
    ("flash asked", (2, 256, 384, 2, 32), "flash", "flash"),
])
def test_attention_branch_matches_jax_gates(monkeypatch, case, sizes, impl,
                                            branch):
    b, nq, nk, h, d = sizes
    assert TA.attention_branch(nq, nk, h, d, impl) == branch, case
    assert _jax_branch(monkeypatch, b, nq, nk, h, d, impl) == branch, case


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,nq,nk,h,d", [(1, 256, 256, 2, 72),
                                         (2, 128, 128, 2, 32),
                                         (1, 128, 384, 2, 32)])
def test_flash_plain_matches_jax_library_kernel(b, nq, nk, h, d, masked,
                                                dtype):
    """K6's plain version against the Pallas library flash kernel
    (interpreted) through the JAX package's 'flash' branch: one key block
    (N_k <= 1024 here: P normalised before it is rounded) and three (N_k =
    384 in blocks of 128: P rounded against the running max)."""
    q, k, v = _qkv(b, nq, nk, h, d, seed=nk + d)
    mask = None
    if masked:
        keep = np.array([nk // 3] + [nk] * (b - 1))[:, None]
        mask = (np.arange(nk)[None] < keep).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = JA.dot_product_attention(
            *(jnp.asarray(a, jd) for a in (q, k, v)),
            mask=None if mask is None else jnp.asarray(mask),
            implementation="flash")
    got = TA.dot_product_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        implementation="flash")
    assert got.dtype == td
    tol = {"atol": ATTN_TOL} if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **tol)


def test_flash_plain_masks_like_the_library():
    """A fully masked row gives the mean of V (the mask value is finite);
    a row keeping one key gives that key's V."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 128, 256, 2, 16, seed=9))
    mask = torch.from_numpy((np.arange(256)[None] < np.array([[0], [1]])
                             ).astype(np.int32))
    out = TA.dot_product_attention(q, k, v, mask=mask, implementation="flash")
    torch.testing.assert_close(out[0], v[0].mean(0, keepdim=True).expand(
        128, 2, 16), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[1], v[1, :1].expand(128, 2, 16))


def _drop_masked_tiles(k, v, bias, mask_value):
    """k, v and bias of one batch element without its 64-key tiles whose
    keys are all masked."""
    keep = torch.cat([torch.arange(k0, min(k0 + 64, k.shape[1]))
                      for k0 in range(0, k.shape[1], 64)
                      if bool((bias[0, k0:k0 + 64] != mask_value).any())])
    return k[:, keep], v[:, keep], bias[:, keep]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["tile-middle", "tile-last",
                                  "flash-leading-block", "zero-probs",
                                  "no-kept-key"])
def test_masked_key_tiles_contribute_exactly_nothing(case, dtype,
                                                    monkeypatch):
    """What lets the bf16 forwards (K2, K4, K6) skip the 64-key tiles whose
    keys are all masked, held on the plain versions:

    * tile-middle, tile-last: K2's plain version with those tiles removed
      equals the full one bit for bit (kept keys in one middle tile; in the
      ragged last tile only);
    * flash-leading-block: K6's plain version with a fully masked leading
      key block removed, at the full N_k's key block (384 keys in blocks of
      128), equals the full one bit for bit, its l and m too;
    * zero-probs: with one kept key in the row, the probabilities at the
      masked keys are exactly 0.0 (both mask values);
    * no-kept-key: a batch element with no kept key returns the mean of V
      (fp32: within fp32 rounding; bf16: one bf16 step)."""
    td = getattr(torch, dtype)
    nk = {"tile-middle": 256, "tile-last": 300, "flash-leading-block": 384,
          "zero-probs": 256, "no-kept-key": 256}[case]
    q, k, v = (torch.from_numpy(a).to(td)
               for a in _qkv(1, 24, nk, 2, 32, seed=nk))
    idx = torch.arange(nk)[None]
    if case == "tile-middle":
        bias = TA._key_bias(((idx >= 130) & (idx < 141)).int(), 1)
        full = TA.attention_ref(q, k, v, bias)
        kd, vd, bd = _drop_masked_tiles(k, v, bias, TA._VMEM_MASK_VALUE)
        assert kd.shape[1] == 64
        assert torch.equal(TA.attention_ref(q, kd, vd, bd), full)
    elif case == "tile-last":
        bias = TA._key_bias((idx >= 290).int(), 1)
        full = TA.attention_ref(q, k, v, bias)
        kd, vd, bd = _drop_masked_tiles(k, v, bias, TA._VMEM_MASK_VALUE)
        assert kd.shape[1] == 44
        assert torch.equal(TA.attention_ref(q, kd, vd, bd), full)
    elif case == "flash-leading-block":
        assert TA.flash_block(nk) == 128
        bias = TA._key_bias((idx >= 128).int(), 1, TA.FLASH_MASK_VALUE)
        full = TA.flash_attention_ref(q, k, v, bias, residuals=True)
        # the remaining 256 keys in the full N_k's blocks of 128
        monkeypatch.setattr(TA, "flash_block", lambda n: 128)
        part = TA.flash_attention_ref(q, k[:, 128:], v[:, 128:],
                                      bias[:, 128:], residuals=True)
        for a, b in zip(part, full):
            assert torch.equal(a, b)
    elif case == "zero-probs":
        keep = ((idx >= 100) & (idx < 101)) | (idx >= 250)
        for mask_value in (TA._VMEM_MASK_VALUE, TA.FLASH_MASK_VALUE):
            bias = TA._key_bias(keep.int(), 1, mask_value)
            p = TA._probs(q, k, bias, torch.float32)
            assert bool((p[..., ~keep[0]] == 0.0).all())
            assert bool((p[..., keep[0]] > 0.0).all())
    else:
        mean = v.float().mean(1, keepdim=True).expand(1, 24, 2, 32)
        tol = (dict(atol=1e-6, rtol=1e-6) if dtype == "float32"
               else dict(atol=0.0, rtol=2.0 ** -8))
        none = torch.zeros((1, nk), dtype=torch.int32)
        for out in (TA.attention_ref(q, k, v, TA._key_bias(none, 1)),
                    TA.flash_attention_ref(q, k, v, TA._key_bias(
                        none, 1, TA.FLASH_MASK_VALUE))):
            torch.testing.assert_close(out.float(), mean, **tol)


def test_folded_plain_matches_jax_vmem_attn_p():
    """K4: the port's plain version against the folded-layout Pallas kernel
    _vmem_attn_p (interpreted) itself and through the JAX package's 'vmem'
    branch at h = 2, d = 40 (h * d = 80 is not lane-aligned: folded)."""
    b, nq, nk, h, d = 2, 24, 300, 2, 40
    assert TA.attention_branch(nq, nk, h, d, "vmem") == "folded"
    q, k, v = _qkv(b, nq, nk, h, d, seed=4)
    mask = (np.arange(nk)[None] < np.array([[10], [300]])).astype(np.int32)
    nkp = 384
    bias = np.where(np.arange(nkp)[None] < np.array([[10], [300]]), 0.0,
                    -1e9).astype(np.float32)

    def fold(a, n):
        a = np.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0), (0, 0)))
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, n, d))
    with pltpu.force_tpu_interpret_mode():
        kern = JA._vmem_attn_p(
            1.0 / d ** 0.5, fold(q, nq), fold(k, nkp), fold(v, nkp),
            jnp.asarray(np.repeat(bias[:, None, None], h, 1).reshape(
                b * h, 1, nkp)))
        vmem = JA.dot_product_attention(
            *(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask),
            implementation="vmem")
    kern = np.asarray(kern).reshape(b, h, nq, d).transpose(0, 2, 1, 3)
    port = TA.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=torch.from_numpy(mask), implementation="vmem")
    np.testing.assert_allclose(_np(port), kern, atol=ATTN_TOL)
    np.testing.assert_allclose(_np(port), np.asarray(vmem), atol=ATTN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_form", [None, "BN", "B11N"])
def test_attention_xla_matches_jax_nn(dtype, mask_form):
    """The XLA branch against jax.nn.dot_product_attention (what the JAX
    package's branch calls), masks replaced by the large negative and
    fully masked rows included."""
    b, nq, nk, h, d = 3, 20, 36, 2, 24
    q, k, v = _qkv(b, nq, nk, h, d, seed=5)
    mask = None
    if mask_form is not None:
        m = np.arange(nk)[None] < np.array([[0], [7], [36]])
        mask = m.astype(np.int32) if mask_form == "BN" else m[:, None, None]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    want = JA.dot_product_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                    mask=jm, implementation="xla")
    got = TA.attention_xla(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                           None if mask is None else torch.from_numpy(mask))
    tol = {"atol": ATTN_TOL} if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_form", [None, "BN"])
def test_attention_xla_grad_recomputes_its_scores(dtype, mask_form):
    """Under autograd the XLA branch keeps no [B, H, Nq, Nk] tensor (the
    plain arithmetic alone keeps several), and its recomputing backward
    gives autograd's gradients of that arithmetic bit for bit; in fp32 they
    match jax.vjp of the JAX package's XLA branch."""
    b, nq, nk, h, d = 3, 20, 36, 2, 8
    q, k, v = _qkv(b, nq, nk, h, d, seed=9)
    g = np.random.default_rng(10).standard_normal((b, nq, h, d)).astype(
        np.float32)
    mask = None if mask_form is None else (
        np.arange(nk)[None] < np.array([[0], [7], [36]])).astype(np.int32)
    td = getattr(torch, dtype)
    grads, biggest = [], []
    for fn in (TA.attention_xla, TA._attention_xla):
        ins = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
        sizes = []

        def keep(t, sizes=sizes):
            sizes.append(t.numel())
            return t
        with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
            out = fn(*ins, None if mask is None else torch.from_numpy(mask))
        out.backward(torch.from_numpy(g).to(td))
        grads.append([t.grad for t in ins])
        biggest.append(max(sizes))
    assert biggest[0] < b * h * nq * nk <= biggest[1]
    for got, plain in zip(*grads):
        assert torch.equal(got, plain)
    if dtype == "float32":
        jm = None if mask is None else jnp.asarray(mask)
        _, vjp = jax.vjp(lambda q_, k_, v_: JA.dot_product_attention(
            q_, k_, v_, mask=jm, implementation="xla"),
            *(jnp.asarray(a) for a in (q, k, v)))
        for got, want in zip(grads[0], vjp(jnp.asarray(g))):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       atol=ATTN_BWD_TOL)


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


@pytest.mark.parametrize("where", ["k", "q"])
def test_linear_attention_ref_carries_nan_like_jax(where):
    """A NaN in k (its head's every output) or in q (its row) lands where
    the JAX package's linear_attention and its Pallas kernel (interpret
    mode) put it: torch.relu and jnp.maximum both keep NaN.  The finite
    entries agree at the pinned 1e-4."""
    b, n, h, d = 2, 40, 3, 16
    q, k, v = _qkv(b, n, n, h, d, seed=5)
    (k if where == "k" else q)[1, 17, 2, 6] = np.nan

    def fold(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, n, d))
    with pltpu.force_tpu_interpret_mode():
        kern = JA._linear_attention_p(fold(q), fold(k), fold(v), 1e-15)
    kern = np.asarray(kern).reshape(b, h, n, d).transpose(0, 2, 1, 3)
    pub = np.asarray(JA.linear_attention(*(jnp.asarray(a) for a in (q, k, v))))
    port = _np(TA.linear_attention_ref(*(torch.from_numpy(a)
                                         for a in (q, k, v))))
    nan = np.isnan(port)
    assert nan.sum() == (n * d if where == "k" else d)
    for want in (pub, kern):
        np.testing.assert_array_equal(np.isnan(want), nan)
        np.testing.assert_allclose(port[~nan], want[~nan], atol=LINATT_TOL,
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,nq,nk,h,d", [(1, 256, 256, 2, 72),
                                         (1, 128, 384, 2, 32)])
def test_flash_bwd_plain_matches_jax_library_vjp(b, nq, nk, h, d, masked,
                                                 dtype):
    """K6b's plain version against jax.vjp of the JAX package's 'flash'
    branch, the Pallas library's forward and backward kernels interpreted:
    one key block (N_k = 256) and three (N_k = 384 in blocks of 128), with
    and without a key mask.  The port's autograd path (K6's residuals,
    then flash_attention_bwd_ref) gives the same bits as the direct call."""
    q, k, v = _qkv(b, nq, nk, h, d, seed=nk + d + 1)
    g = np.random.default_rng(nk).standard_normal((b, nq, h, d)).astype(
        np.float32)
    mask = None
    if masked:
        mask = (np.arange(nk)[None] < np.array([[nk // 3]])).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q_, k_, v_: JA.dot_product_attention(
            q_, k_, v_, mask=jm, implementation="flash"),
            *(jnp.asarray(a, jd) for a in (q, k, v)))
        want = vjp(jnp.asarray(g, jd))
    tq, tk, tv, tg = (torch.from_numpy(a).to(td) for a in (q, k, v, g))
    bias = (None if mask is None else
            TA._key_bias(torch.from_numpy(mask), b, TA.FLASH_MASK_VALUE))
    o, l, m = TA.flash_attention_ref(tq, tk, tv, bias, residuals=True)
    assert l.shape == m.shape == (b, h, nq) and l.dtype == torch.float32
    assert torch.equal(o, TA.flash_attention_ref(tq, tk, tv, bias))
    port = TA.flash_attention_bwd_ref(tq, tk, tv, bias, o, l, m, tg)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    TA.dot_product_attention(
        *leaves, mask=None if mask is None else torch.from_numpy(mask),
        implementation="flash").backward(tg)
    tol = {"atol": ATTN_BWD_TOL} if dtype == "float32" else BF16_TOL
    for p, w, leaf in zip(port, want, leaves):
        assert p.dtype == td
        np.testing.assert_allclose(_np(p), np.asarray(w.astype(jnp.float32)),
                                   **tol)
        assert torch.equal(leaf.grad, p)
    if masked:                          # masked keys get no gradient
        assert not bool(port[1][:, nk // 3:].any())
        assert not bool(port[2][:, nk // 3:].any())


def test_folded_bwd_plain_matches_jax_vmem_attn_vjp():
    """K4b: the port's plain backward on the folded branch against jax.vjp
    of the folded-layout Pallas kernel _vmem_attn_p (interpreted; keys
    padded to 384 with a -1e9 bias) and of the JAX package's 'vmem' branch,
    at h = 2, d = 40, N_k = 300.  exp(-1e9 - m) is 0 in fp32, so the padded
    and masked keys get exactly zero gradients on both sides."""
    b, nq, nk, h, d = 2, 24, 300, 2, 40
    nkp = 384
    assert TA.attention_branch(nq, nk, h, d, "vmem") == "folded"
    assert np.exp(np.float32(-1e9) - np.float32(10.0)) == 0.0
    q, k, v = _qkv(b, nq, nk, h, d, seed=11)
    g = np.random.default_rng(12).standard_normal((b, nq, h, d)).astype(
        np.float32)
    keep = np.array([[10], [300]])
    mask = (np.arange(nk)[None] < keep).astype(np.int32)
    bias = np.where(np.arange(nkp)[None] < keep, 0.0, -1e9).astype(np.float32)

    def fold(a, n):
        a = np.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0), (0, 0)))
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, n, d))

    def unfold(a, n):
        return np.asarray(a).reshape(b, h, n, d).transpose(0, 2, 1, 3)
    fb = jnp.asarray(np.repeat(bias[:, None, None], h, 1).reshape(
        b * h, 1, nkp))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q_, k_, v_: JA._vmem_attn_p(
            1.0 / d ** 0.5, q_, k_, v_, fb),
            fold(q, nq), fold(k, nkp), fold(v, nkp))
        kern = [unfold(a, n) for a, n in zip(vjp(fold(g, nq)),
                                             (nq, nkp, nkp))]
        _, pub_vjp = jax.vjp(lambda q_, k_, v_: JA.dot_product_attention(
            q_, k_, v_, mask=jnp.asarray(mask), implementation="vmem"),
            *(jnp.asarray(a) for a in (q, k, v)))
        pub = pub_vjp(jnp.asarray(g))
    for a in kern[1:]:                   # the padded keys: exactly zero
        assert not a[:, nk:].any()
    leaves = [_t(a, True) for a in (q, k, v)]
    TA.dot_product_attention(*leaves, mask=_t(mask),
                             implementation="vmem").backward(_t(g))
    port = TA.attention_bwd_ref(_t(q), _t(k), _t(v),
                                TA._key_bias(_t(mask), b), _t(g))
    for p, kw, pw, leaf in zip(port, kern, pub, leaves):
        np.testing.assert_allclose(_np(p), kw[:, :p.shape[1]],
                                   atol=ATTN_BWD_TOL)
        np.testing.assert_allclose(_np(p), np.asarray(pw), atol=ATTN_BWD_TOL)
        np.testing.assert_array_equal(_np(leaf.grad), _np(p))
    for a in port[1:]:                   # the masked keys of row 0: zero
        assert not bool(a[0, 10:].any())


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
