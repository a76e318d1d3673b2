"""PyTorch port, the CUDA kernels (yat_tpu_torch/csrc, kernels/build.py):
the build route on any machine, and on a card (``gpu`` marker) each kernel
against its plain version at the serving and training shapes and at
ragged shapes.

This file imports neither JAX nor the JAX package, so the card tests run
on a machine without JAX, skipping tests/conftest.py (which sets JAX up):

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from yat_tpu_torch.kernels import build as KB
from yat_tpu_torch.ops import attention as TA
from yat_tpu_torch.ops import norm as TN

# ---------------------------------------------------------------------------
# the build route
# ---------------------------------------------------------------------------


def test_build_flags_and_library_names():
    flags = " ".join(KB.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    names = {k.source for k in KB.KERNELS.values()}
    assert names == {"adaln.cu", "softmax_attention.cu",
                     "softmax_attention_bwd.cu", "linear_attention.cu"}
    for src in names:
        p = KB.library_path(src)
        assert p.parent == KB.BUILD_DIR and p.name.endswith(".so")
        assert p == KB.library_path(src)          # stable hash
        assert (KB.CSRC_DIR / src).exists()


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ce
    monkeypatch.setattr(ce, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KB.find_nvcc()


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version: no build, no launch count."""
    rng = np.random.default_rng(0)
    x, q = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 5, 8), (1, 6, 2, 8)))
    before = KB.launch_counts()
    TN.adaln_layernorm(x, torch.zeros(1, 8), torch.zeros(1, 1, 8))
    TA.dot_product_attention(q, q, q)
    TA.linear_attention(q, q, q)
    assert KB.launch_counts() == before


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_port_kernels.py -m gpu --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# |kernel - plain| <= atol + rtol*|plain|: bf16 one rounding step where
# the fp32 sums run in another order; fp32 reduction order only
CARD_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}


def _close(got, want):
    atol, rtol = CARD_TOL[want.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 256, 1152), (16, 256, 1152),
                                   (1, 77, 96)])
def test_card_adaln_kernel(cuda, dtype, shape):
    b, n, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    sc = (0.1 * torch.randn((b, 1, d), generator=g, device=cuda)).to(dtype)
    sh = (0.1 * torch.randn((b, 1, d), generator=g, device=cuda)).to(dtype)
    before = TN.ADALN.launches
    out = TN.adaln_layernorm(x, sc, sh)
    torch.cuda.synchronize()
    assert TN.ADALN.launches == before + 1
    _close(out, TN.adaln_ref(x, sc[:, 0], sh[:, 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h,d", [(8, 256, 512, 16, 72),
                                         (16, 256, 512, 16, 72),
                                         (4, 100, 300, 16, 72),
                                         (2, 64, 16, 2, 32)])
def test_card_attention_kernel(cuda, dtype, b, nq, nk, h, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))
    keep = torch.linspace(1, nk, b, device=cuda).round()
    mask = (torch.arange(nk, device=cuda)[None] < keep[:, None]).int()
    before = TA.SOFTMAX_ATTENTION.launches
    out = TA.dot_product_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert TA.SOFTMAX_ATTENTION.launches == before + 1
    _close(out, TA.attention_ref(q, k, v, TA._key_bias(mask, b)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,d", [(8, 256, 36, 32), (16, 256, 36, 32),
                                     (2, 100, 36, 32)])
def test_card_linear_attention_kernel(cuda, dtype, b, n, h, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = TA.LINEAR_ATTENTION.launches
    out = TA.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert TA.LINEAR_ATTENTION.launches == before + 1
    # n < 4096: the JAX einsum branch's numerics, the state rounded
    _close(out, TA.linear_attention_ref(q, k, v, round_kv=True))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_linear_attention_fp32_state(cuda, dtype):
    """implementation='pallas' keeps the state in fp32 (the Pallas math)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 100, 36, 32), generator=g,
                           device=cuda).to(dtype) for _ in range(3))
    out = TA.linear_attention(q, k, v, implementation="pallas")
    torch.cuda.synchronize()
    _close(out, TA.linear_attention_ref(q, k, v, round_kv=False))


# backward kernels, each output against the plain backward, with
# chip_smoke.py's tolerance: bf16 one bf16 step of the element (rtol 2^-7)
# plus 2^-8 of the output's largest magnitude; fp32 reduction order only
# (K1b 1e-4, K2b 2e-4)
def _close_bwd(name, got, want):
    import chip_smoke
    err, used, ok, tol = chip_smoke.compare(name, tuple(got), tuple(want))
    assert ok, f"{name}: max_abs_err {err:.3e}, {used:.3f} of ({tol})"


def _train_like(b, nq, nk, h, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, gy = (torch.randn(s, generator=g).to(dtype)
                   for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                             (b, nq, h, d)))
    keep = torch.linspace(100, 500, b).round()
    bias = TA._key_bias((torch.arange(nk)[None] < keep[:, None]).int(), b)
    return q, k, v, bias, gy


def test_bwd_tolerance_catches_a_backward_without_the_row_term():
    """The bf16 backward tolerance at the training shape (batch cut to 2):
    the plain backward passes against itself and with every element moved
    one bf16 step; a backward without rowsum(dP P) fails."""
    import chip_smoke
    name = "dot_product_attention_bwd"
    args = _train_like(2, 256, 512, 16, 72, torch.bfloat16)
    want = TA.attention_bwd_ref(*args)
    _close_bwd(name, want, want)
    step = tuple(torch.nextafter(w, torch.full_like(w, float("inf")))
                 for w in want)
    _close_bwd(name, step, want)
    wrong = chip_smoke.attention_bwd_without_row_term(*args)
    assert not chip_smoke.compare(name, wrong, want)[2]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 256, 1152), (1, 100, 1152)])
def test_card_adaln_bwd_kernel(cuda, dtype, shape):
    b, n, d = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    sc = (0.1 * torch.randn((b, 1, d), generator=g, device=cuda)).to(dtype)
    sh = (0.1 * torch.randn((b, 1, d), generator=g, device=cuda)).to(dtype)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    xs, scs, shs = (t.clone().requires_grad_() for t in (x, sc, sh))
    before = TN.ADALN_BWD.launches
    out = TN.adaln_layernorm(xs, scs, shs)
    assert out.grad_fn is not None
    out.backward(gy)
    torch.cuda.synchronize()
    assert TN.ADALN_BWD.launches == before + 1
    want = TN.adaln_bwd_ref(x, sc[:, 0], gy)
    _close_bwd("adaln_layernorm_bwd",
               (xs.grad, scs.grad[:, 0], shs.grad[:, 0]), want)
    # deterministic: the same inputs give the same bits
    again = TN._adaln_bwd_cuda(x, sc[:, 0].contiguous(), gy, 1e-6)
    first = TN._adaln_bwd_cuda(x, sc[:, 0].contiguous(), gy, 1e-6)
    for a, c in zip(again, first):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h,d", [(16, 256, 512, 16, 72),
                                         (16, 256, 128, 16, 72),
                                         (4, 100, 300, 16, 72),
                                         (2, 64, 16, 2, 32)])
def test_card_attention_bwd_kernel(cuda, dtype, b, nq, nk, h, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, gy = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                             (b, nq, h, d)))
    keep = torch.linspace(1, nk, b, device=cuda).round()
    mask = (torch.arange(nk, device=cuda)[None] < keep[:, None]).int()
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    before = TA.SOFTMAX_ATTENTION_BWD.launches
    out = TA.dot_product_attention(qs, ks, vs, mask=mask)
    assert out.grad_fn is not None
    out.backward(gy)
    torch.cuda.synchronize()
    assert TA.SOFTMAX_ATTENTION_BWD.launches == before + 1
    want = TA.attention_bwd_ref(q, k, v, TA._key_bias(mask, b), gy)
    _close_bwd("dot_product_attention_bwd", (qs.grad, ks.grad, vs.grad),
               want)


@pytest.mark.gpu
def test_card_linear_attention_grad_is_a_plain_recompute(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, gy = (torch.randn((2, 100, 36, 32), generator=g,
                               device=cuda) for _ in range(4))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = TA.linear_attention(qs, ks, vs)
    assert out.grad_fn is not None
    out.backward(gy)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    TA.linear_attention_ref(qr, kr, vr, round_kv=True).backward(gy)
    for got, w in zip((qs.grad, ks.grad, vs.grad),
                      (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(got, w, atol=1e-5, rtol=1e-5)
