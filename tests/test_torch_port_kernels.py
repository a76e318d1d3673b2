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
from yat_tpu_torch.ops import quant as TQ
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# ---------------------------------------------------------------------------
# the build route
# ---------------------------------------------------------------------------


def test_build_flags_and_library_names():
    flags = " ".join(KB.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    names = {k.source for k in KB.KERNELS.values()}
    assert names == {"adaln.cu", "softmax_attention.cu",
                     "softmax_attention_bwd.cu", "linear_attention.cu",
                     "flash_attention.cu", "flash_attention_bwd.cu",
                     "w8a8_matmul.cu"}
    for src in names:
        p = KB.library_path(src)
        assert p.parent == KB.BUILD_DIR and p.name.endswith(".so")
        assert p == KB.library_path(src)          # stable hash
        assert (KB.CSRC_DIR / src).exists()


def test_ptxas_entry_names_are_read_from_mangled_names():
    """chip_smoke.py names each ptxas register/spill line by its kernel and
    integer template arguments."""
    import chip_smoke
    assert chip_smoke.entry_name(
        "_ZN12_GLOBAL__N_12tc17flash_bwd_dq_bf16ILb1ELi5ELi5EEEvPK13__nv_"
        "bfloat16S3_") == "flash_bwd_dq_bf16<1,5,5>"
    assert chip_smoke.entry_name(
        "_ZN12_GLOBAL__N_13f3216attention_bwd_dqEPKfS2_") == \
        "attention_bwd_dq"


def test_profile_trace_check_counts_records_per_call():
    """chip_smoke.py's trace check: two device records per K5/K5b/K2b/K6b
    call, one per forward and per K1b call; a family short of records is
    named."""
    import chip_smoke
    calls = {"w8a8_matmul": 254, "dot_product_attention": 28,
             "dot_product_attention_folded_bwd": 28, "adaln_layernorm": 57,
             "adaln_layernorm_bwd": 56}
    families = {"K5 w8a8_matmul": (508, 1.0),
                "K2/K4 dot_product_attention": (28, 1.0),
                "K2b/K4b dot_product_attention_bwd": (56, 1.0),
                "K1 adaln_layernorm": (57, 1.0),
                "K1b adaln_layernorm_bwd": (56, 1.0)}
    assert chip_smoke.trace_shortfall(families, calls) == {}
    families["K5 w8a8_matmul"] = (506, 1.0)
    assert chip_smoke.trace_shortfall(families, calls) == {
        "K5 w8a8_matmul": (508, 506)}
    # every family the profile knows is covered
    assert {f for f, _ in chip_smoke.KERNEL_FAMILIES if f.startswith("K")} \
        == set(chip_smoke.FAMILY_COUNTERS)


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
    long = torch.from_numpy(rng.standard_normal((1, 128, 1, 8)).astype(
        np.float32))
    TA.dot_product_attention(q, q, q)
    TA.dot_product_attention(q, q, q, implementation="vmem")
    TA.dot_product_attention(long, long, long, implementation="flash")
    TA.linear_attention(q, q, q)
    # K5/K5b's shape (multiples of 128), forward and backward
    x = torch.from_numpy(rng.standard_normal((128, 256)).astype(
        np.float32)).requires_grad_()
    qw, ws = TQ.quantize_kernel(torch.from_numpy(
        rng.standard_normal((128, 256)).astype(np.float32)))
    assert TQ.w8a8_branch(128, 256, 128)
    TQ.w8a8_matmul(x, qw, ws).sum().backward()
    assert KB.launch_counts() == before


def test_linear_attention_wrapper_refuses_rows_off_four_bytes():
    """K3 copies rows in 4-byte pieces at least: an odd bf16 head dim, or a
    stride that leaves rows on 2-byte boundaries, raises before any build
    or launch."""
    q = torch.zeros((1, 4, 2, 5), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4-byte"):
        TA._linear_attention_args(q, q, q, torch.empty_like(q), 1e-15, True)
    wide = torch.zeros((1, 4, 2, 9), dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="4-byte"):
        TA._linear_attention_args(wide, wide, wide, torch.empty_like(wide),
                                  1e-15, True)


def test_compare_nan_holds_nan_positions():
    """chip_smoke.compare_nan passes NaN where the plain version has them
    and fails a NaN swallowed or moved."""
    import chip_smoke
    want = torch.tensor([[1.0, float("nan")], [2.0, 3.0]])
    count, where, _, _, ok, _ = chip_smoke.compare_nan(
        "linear_attention", want.clone(), want)
    assert (count, where, ok) == (1, True, True)
    swallowed = torch.tensor([[1.0, 0.0], [2.0, 3.0]])
    moved = torch.tensor([[float("nan"), 5.0], [2.0, 3.0]])
    for got in (swallowed, moved):
        assert not chip_smoke.compare_nan("linear_attention", got, want)[4]


def test_chip_smoke_k1_k3_cases_on_cpu():
    """chip_smoke.py's K1 and K3 cases, fp32 on the CPU (the wrappers take
    the plain versions there): every case builds its inputs, runs and
    passes its comparison; the NaN case puts NaN in one k head and one q
    row."""
    import chip_smoke
    labels = {"adaln_layernorm": [], "linear_attention": []}
    for case in chip_smoke.kernel_cases("cpu"):
        name, label, dtype, make, kern, plain = case[:6]
        if name not in labels or dtype != torch.float32:
            continue
        labels[name].append(label)
        args = make()
        got, want = kern(*args), plain(*args)
        if (name, label) in chip_smoke.NAN_CASES:
            count, where, _, _, ok, _ = chip_smoke.compare_nan(name, got,
                                                               want)
            assert count == 256 * 32 + 32 and where and ok
        else:
            assert chip_smoke.compare(name, got, want)[2]
    assert labels == {
        "adaln_layernorm": ["serve", "train", "ragged", "pixart-serve",
                            "generic", "sd35-image", "sd35-text",
                            "flux-image", "flux-text", "flux-single"],
        "linear_attention": ["serve", "train", "ragged", "ragged-17", "d64",
                             "fp32-state", "nan"]}


def _k1b_cases(dtype):
    import chip_smoke
    return [c for c in chip_smoke.kernel_cases("cpu")
            if c[0] == "adaln_layernorm_bwd" and c[2] == dtype]


def test_chip_smoke_k1b_cases_on_cpu():
    """chip_smoke.py's K1b cases, fp32 on the CPU: every case builds its
    inputs (the unaligned one a view one value off the vectors) and its
    plain backward passes the comparison against itself."""
    import chip_smoke
    labels = []
    for case in _k1b_cases(torch.float32):
        name, label, _, make, _, plain = case[:6]
        labels.append(label)
        x, sc, g = make()
        assert x.shape[:2] == g.shape[:2] and sc.shape == (x.shape[0],
                                                          x.shape[2])
        assert (x.storage_offset() == 1) == (label == "unaligned")
        want = plain(x, sc, g)
        assert chip_smoke.compare(name, want, want)[2]
    assert labels == ["train", "pixart-train", "ragged", "generic",
                      "unaligned", "sd35-image", "sd35-text", "flux-image",
                      "flux-text"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1b_tolerance_rejects_a_backward_without_m2(dtype):
    """The K1b tolerance at the ragged and generic cases: the plain
    backward moved one step of its type passes; the backward without the
    xhat * m2 term of dx fails."""
    import chip_smoke
    name = "adaln_layernorm_bwd"
    for case in _k1b_cases(dtype):
        if case[1] not in ("ragged", "generic"):
            continue
        args = case[3]()
        want = case[5](*args)
        step = tuple(torch.nextafter(w, torch.full_like(w, float("inf")))
                     for w in want)
        assert chip_smoke.compare(name, step, want)[2]
        wrong, _ = chip_smoke.WRONG_BWD[name]
        assert not chip_smoke.compare(name, wrong(*args), want)[2]


def test_k1b_yardstick_is_layer_norm_backward():
    """K1b's library yardstick computes K1b's function where one weight is
    shared: at one batch element its dx, dweight and dbias are the plain
    backward's dx, dscale and dshift."""
    import chip_smoke
    rng = np.random.default_rng(3)
    x, g = (torch.from_numpy(rng.standard_normal((1, 40, 96)).astype(
        np.float32)) for _ in range(2))
    sc = torch.from_numpy(0.1 * rng.standard_normal((1, 96)).astype(
        np.float32))
    got = chip_smoke.layer_norm_bwd_yardstick()(x, sc, g)
    want = TN.adaln_bwd_ref(x, sc, g)
    torch.testing.assert_close(got[0].reshape(x.shape), want[0],
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b[0], atol=1e-4, rtol=1e-4)


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
    # the ragged shapes lie outside the short-sequence gate: "vmem" sends
    # them to the kernel; h * d = 64 is the folded (K4) branch
    handle = (TA.SOFTMAX_ATTENTION_FOLDED if h * d % 128
              else TA.SOFTMAX_ATTENTION)
    before = handle.launches
    out = TA.dot_product_attention(q, k, v, mask=mask, implementation="vmem")
    torch.cuda.synchronize()
    assert handle.launches == before + 1
    _close(out, TA.attention_ref(q, k, v, TA._key_bias(mask, b)))


def _keep_mask(keep, nk, device):
    """[B, N_k] keep-mask: an int keeps that many leading keys, a (lo, hi)
    pair the keys [lo, hi)."""
    import chip_smoke
    return chip_smoke._mask(keep, nk, device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h,d,keep", [
    (8, 1024, 300, 16, 72, [10 + 290 * i // 7 for i in range(8)]),
    (2, 128, 4096, 4, 72, [4096, 77])])
def test_card_folded_attention_kernel(cuda, dtype, b, nq, nk, h, d, keep):
    """K4's shapes: PixArt-Sigma's cross-attention over T5 captions (10-300
    kept keys) and the longest key sequence the short-sequence gate admits
    (fp32 included): the JAX package folds heads there, the port runs K2's
    kernel and counts it as K4."""
    assert TA.attention_branch(nq, nk, h, d) == "folded"
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))
    mask = _keep_mask(keep, nk, cuda)
    before = TA.SOFTMAX_ATTENTION_FOLDED.launches
    out = TA.dot_product_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert TA.SOFTMAX_ATTENTION_FOLDED.launches == before + 1
    _close(out, TA.attention_ref(q, k, v, TA._key_bias(mask, b)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h,d,keep", [
    (8, 1024, 1024, 16, 72, None),           # PixArt-Sigma 512px self
    (2, 4096, 4096, 16, 72, None),           # 1024px: four key blocks
    (4, 1024, 1024, 16, 72, [0, 1, 517, 1024]),   # a fully masked row
    (2, 1024, 1000, 16, 72, [1000, 333]),    # ragged N_k, 8 key blocks
    (2, 256, 384, 2, 256, [384, 100])])      # head dim 256, 3 key blocks
def test_card_flash_attention_kernel(cuda, dtype, b, nq, nk, h, d, keep):
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))
    bias = (None if keep is None else
            TA._key_bias(_keep_mask(keep, nk, cuda), b, TA.FLASH_MASK_VALUE))
    before = TA.FLASH_ATTENTION.launches
    out = TA._flash_attention_cuda(q, k, v, bias)
    torch.cuda.synchronize()
    assert TA.FLASH_ATTENTION.launches == before + 1
    want = TA.flash_attention_ref(q, k, v, bias)
    _close(out, want)
    if keep is not None and 0 in keep:
        # every key masked: the mask value is finite, so the mean of V
        i = keep.index(0)
        _close(out[i], v[i].float().mean(0, keepdim=True).expand(
            nq, h, d).to(dtype))


@pytest.mark.gpu
def test_card_flash_attention_dispatch_and_no_backward(cuda):
    """The flash branch launches K6 once forward and K6b once backward;
    under inference_mode the forward keeps no residuals and nothing can
    take a backward."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 1024, 16, 72), generator=g, device=cuda,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    before = KB.launch_counts()
    out = TA.dot_product_attention(q, k, v)
    after = KB.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["attention_xla"] == before["attention_xla"]
    out.float().sum().backward()
    assert KB.launch_counts()["flash_attention_bwd"] == (
        before["flash_attention_bwd"] + 1)
    with torch.inference_mode():
        served = TA.dot_product_attention(q, k, v)
    assert served.grad_fn is None
    torch.testing.assert_close(served, out.detach(), atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h,d,keep", [
    (8, 1024, 1024, 16, 72, None),           # PixArt-Sigma 512px self
    (2, 4096, 4096, 16, 72, None),           # 1024px: four key blocks
    (2, 1024, 1000, 16, 72, [1000, 333])])   # ragged N_k, 8 key blocks
def test_card_flash_attention_residuals(cuda, dtype, b, nq, nk, h, d, keep):
    """K6 under autograd writes each row's final max and exp-sum, as the
    plain version computes them; the output is the serving launch's."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))
    bias = (None if keep is None else
            TA._key_bias(_keep_mask(keep, nk, cuda), b, TA.FLASH_MASK_VALUE))
    o, l, m = TA._flash_attention_cuda(q, k, v, bias, residuals=True)
    torch.cuda.synchronize()
    assert torch.equal(o, TA._flash_attention_cuda(q, k, v, bias))
    _, l_ref, m_ref = TA.flash_attention_ref(q, k, v, bias, residuals=True)
    # fp32 statistics of the same scores summed in another order
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-4)


# the forwards' tile walk: kept keys in one middle 64-key tile, in the last
# tile only, none (the mean of V), every key; N_q = 200 is no multiple of
# 128; K6's N_k = 640 is five key blocks of 128
FWD_TILE_MASKS = [(130, 190), (600, 640), 0, 640]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel,d", [
    (kernel, d) for kernel in ("flash", "softmax", "folded")
    for d in (32, 64, 72, 128, 256) if kernel == "flash" or d <= 128])
def test_card_attention_fwd_mask_layouts(cuda, dtype, kernel, d):
    """K6, K2 and K4 at the mask layouts of the tile walk against the
    plain version, at the head dims each admits; two launches give the
    same bits, and in bf16 so do K and V rows of NaN in the fully masked
    tiles, which the walk never reads."""
    flash = kernel == "flash"
    b, nq, nk, h = 4, 200, 640 if flash else 300, 2
    keep = FWD_TILE_MASKS if flash else [(130, 190), (290, 300), 0, 300]
    mask_value = TA.FLASH_MASK_VALUE if flash else TA._VMEM_MASK_VALUE
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))
    bias = TA._key_bias(_keep_mask(keep, nk, cuda), b, mask_value)
    if flash:
        handle = TA.FLASH_ATTENTION
        want = TA.flash_attention_ref(q, k, v, bias)

        def run(k, v):
            return TA._flash_attention_cuda(q, k, v, bias)
    else:
        handle = (TA.SOFTMAX_ATTENTION_FOLDED if kernel == "folded"
                  else TA.SOFTMAX_ATTENTION)
        want = TA.attention_ref(q, k, v, bias)

        def run(k, v):
            return TA._attention_cuda(q, k, v, bias,
                                      folded=kernel == "folded")
    import chip_smoke
    pk, pv = chip_smoke.poison_masked_tiles(k, v, bias != mask_value)
    before = handle.launches
    out = run(k, v)
    again = run(k, v)
    torch.cuda.synchronize()
    assert handle.launches == before + 2
    _close(out, want)
    assert torch.equal(out, again)
    if dtype == torch.bfloat16:
        assert torch.equal(run(pk, pv), out)
    _close(out[2], v[2].float().mean(0, keepdim=True).expand(
        nq, h, d).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_flash_attention_first_key_block_masked(cuda, dtype):
    """K6 in four key blocks of 1024 with the first fully masked (and, in
    the second batch element, the second): output and l/m residuals
    against the plain version."""
    b, nq, nk, h, d = 2, 256, 4096, 4, 72
    g = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))
    bias = TA._key_bias(_keep_mask([(1024, 4096), (0, 1024)], nk, cuda),
                        b, TA.FLASH_MASK_VALUE)
    o, l, m = TA._flash_attention_cuda(q, k, v, bias, residuals=True)
    torch.cuda.synchronize()
    o_ref, l_ref, m_ref = TA.flash_attention_ref(q, k, v, bias,
                                                 residuals=True)
    _close(o, o_ref)
    torch.testing.assert_close(m, m_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash", "softmax", "folded"])
def test_card_attention_fwd_kernels_are_bit_reproducible(cuda, kernel):
    """K6, K2 and K4 at their serving shapes in bf16: two launches on the
    same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(15)
    b, nq, nk, h, d = {"flash": (8, 1024, 1024, 16, 72),
                       "softmax": (8, 256, 512, 16, 72),
                       "folded": (8, 1024, 300, 16, 72)}[kernel]
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d)))
    if kernel == "flash":
        def run():
            return TA._flash_attention_cuda(q, k, v, None)
    else:
        bias = TA._key_bias(_keep_mask(
            [10 + (nk - 10) * i // (b - 1) for i in range(b)], nk, cuda), b)

        def run():
            return TA._attention_cuda(q, k, v, bias,
                                      folded=kernel == "folded")
    first = run()
    second = run()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def flash_bwd_cases():
    """K6b's shapes: PixArt-Sigma 512px self-attention, 1024px in four key
    blocks, a masked flash case at PixArt-1024px's cross-attention shape
    (0-256 of 256 keys kept), shapes the flash gate admits with several key
    blocks (N_k = 640: five; head dim 256: three) and a ragged one (N = 1000,
    called directly)."""
    return [(8, 1024, 1024, 16, 72, None),
            (2, 4096, 4096, 16, 72, None),
            (8, 4096, 256, 16, 72, [0, 1, 37, 100, 128, 200, 255, 256]),
            (2, 1280, 640, 16, 72, [640, 311]),
            (2, 1024, 384, 2, 256, [384, 100]),
            (2, 1000, 1000, 16, 72, [1000, 333]),
            # the other head dims of the bf16 body (16-wide chunks 2, 4 and
            # 8), each with N_q not a multiple of 64 and a fully masked row
            (2, 1000, 300, 4, 32, [0, 300]),
            (2, 1000, 300, 4, 64, [0, 150]),
            (2, 1000, 300, 4, 128, [0, 299])]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h,d,keep", flash_bwd_cases())
def test_card_flash_attention_bwd_kernel(cuda, dtype, b, nq, nk, h, d, keep):
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, gy = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                             (b, nq, h, d)))
    bias = (None if keep is None else
            TA._key_bias(_keep_mask(keep, nk, cuda), b, TA.FLASH_MASK_VALUE))
    o, l, m = TA._flash_attention_cuda(q, k, v, bias, residuals=True)
    before = TA.FLASH_ATTENTION_BWD.launches
    got = TA._flash_attention_bwd_cuda(q, k, v, bias, o, l, m, gy)
    torch.cuda.synchronize()
    assert TA.FLASH_ATTENTION_BWD.launches == before + 1
    want = TA.flash_attention_bwd_ref(q, k, v, bias, o, l, m, gy)
    _close_bwd("flash_attention_bwd", got, want)
    again = TA._flash_attention_bwd_cuda(q, k, v, bias, o, l, m, gy)
    for a, c in zip(again, got):          # no atomics: the same bits
        assert torch.equal(a, c)


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


# K3's launches: (b, n, h, d, implementation, the path it takes in bf16)
K3_PATH_CASES = [(8, 256, 36, 32, "auto", "tensor cores"),
                 (2, 17, 36, 32, "auto", "tensor cores"),
                 (4, 256, 18, 64, "auto", "tensor cores"),
                 (2, 600, 4, 16, "auto", "tensor cores"),
                 (8, 256, 36, 32, "pallas", "CUDA cores"),
                 (2, 17, 36, 64, "pallas", "CUDA cores")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,h,d,impl,path", K3_PATH_CASES)
def test_card_linear_attention_paths(cuda, dtype, b, n, h, d, impl, path):
    """Both K3 paths (bf16 with a rounded state on the tensor cores; the
    fp32 state and fp32 on the CUDA cores) against the plain version with
    the state of the JAX branch that implementation names."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    info = TA.linear_attention_launch_info(q, k, v, impl)
    assert info["path"] == (path if dtype == torch.bfloat16
                            else "CUDA cores")
    assert info["copy_bytes"] == 16 and info["local_bytes"] == 0
    out = TA.linear_attention(q, k, v, implementation=impl)
    torch.cuda.synchronize()
    _close(out, TA.linear_attention_ref(
        q, k, v, round_kv=TA.kv_rounding(n, d, impl)))


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_linear_attention_carries_nan(cuda, dtype, impl):
    """ReLU keeps NaN on both paths: a NaN in k spoils its head, a NaN in q
    its row, exactly where linear_attention_ref puts them."""
    import chip_smoke
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 100, 4, 32), generator=g,
                           device=cuda).to(dtype) for _ in range(3))
    k[1, 40, 2, 5] = float("nan")
    q[0, 70, 1, 9] = float("nan")
    out = TA.linear_attention(q, k, v, implementation=impl)
    want = TA.linear_attention_ref(q, k, v,
                                   round_kv=TA.kv_rounding(100, 32, impl))
    torch.cuda.synchronize()
    count, where, _, _, ok, _ = chip_smoke.compare_nan("linear_attention",
                                                       out, want)
    assert count == 100 * 32 + 32 and where and ok


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,layout,path", [
    ((2, 77, 1000), "plain", "generic"),
    ((1, 9, 96), "plain", "generic"),
    ((2, 33, 1152), "unaligned", "generic"),
    ((8, 1024, 1152), "plain", "registers")])
def test_card_adaln_paths(cuda, dtype, shape, layout, path):
    """K1's generic loop (other widths; rows off the four-value vectors)
    and its row in registers (D = 1152) against the plain version."""
    b, n, d = shape
    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((b, n, d + (layout == "unaligned")), generator=g,
                    device=cuda).to(dtype)
    x = x[..., 1:] if layout == "unaligned" else x
    sc, sh = ((0.1 * torch.randn((b, 1, d), generator=g, device=cuda)
               ).to(dtype) for _ in range(2))
    info = TN.adaln_launch_info(x, sc, sh)
    assert info["path"] == path and info["local_bytes"] == 0
    assert info["shared_bytes"] == 0
    out = TN.adaln_layernorm(x, sc, sh)
    torch.cuda.synchronize()
    _close(out, TN.adaln_ref(x, sc[:, 0], sh[:, 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k3", "k3-fp32-state", "k3-fp32",
                                    "k1", "k1-generic", "k1-fp32"])
def test_card_k1_k3_are_bit_reproducible(cuda, kernel):
    """K3 on each path and K1 on each path, at the serving shapes: two
    launches on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(21)
    dtype = torch.float32 if kernel.endswith("fp32") else torch.bfloat16
    if kernel.startswith("k3"):
        q, k, v = (torch.randn((8, 256, 36, 32), generator=g,
                               device=cuda).to(dtype) for _ in range(3))
        impl = "pallas" if kernel == "k3-fp32-state" else "auto"

        def run():
            return TA.linear_attention(q, k, v, implementation=impl)
    else:
        d = 1000 if kernel == "k1-generic" else 1152
        x = torch.randn((8, 256, d), generator=g, device=cuda).to(dtype)
        sc, sh = ((0.1 * torch.randn((8, 1, d), generator=g,
                                     device=cuda)).to(dtype)
                  for _ in range(2))

        def run():
            return TN.adaln_layernorm(x, sc, sh)
    first = run()
    second = run()
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(first.view(bits), second.view(bits))


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


def _k1b_device_records(run):
    """K1b's device records while ``run()`` runs, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    return out, sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "adaln_bwd" in e.name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,layout", [
    ((16, 256, 1152), "plain"), ((1, 100, 1152), "plain"),
    ((8, 1024, 1152), "plain"), ((4, 77, 1000), "plain"),
    ((2, 100, 1152), "unaligned")])
def test_card_adaln_bwd_kernel(cuda, dtype, shape, layout):
    """K1b through autograd against the plain backward (x a view one value
    off the vectors in the unaligned layout): one launch and one device
    record a call, the same bits twice."""
    b, n, d = shape
    wide = d + (layout == "unaligned")
    g = torch.Generator(device=cuda).manual_seed(2)
    x_wide = torch.randn((b, n, wide), generator=g, device=cuda).to(dtype)
    x = x_wide[..., wide - d:]
    sc = (0.1 * torch.randn((b, 1, d), generator=g, device=cuda)).to(dtype)
    sh = (0.1 * torch.randn((b, 1, d), generator=g, device=cuda)).to(dtype)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    xw, scs, shs = (t.clone().requires_grad_() for t in (x_wide, sc, sh))
    xs = xw[..., wide - d:]
    before = TN.ADALN_BWD.launches
    out = TN.adaln_layernorm(xs, scs, shs)
    assert out.grad_fn is not None
    out.backward(gy)
    torch.cuda.synchronize()
    assert TN.ADALN_BWD.launches == before + 1
    want = TN.adaln_bwd_ref(x, sc[:, 0], gy)
    _close_bwd("adaln_layernorm_bwd",
               (xw.grad[..., wide - d:], scs.grad[:, 0], shs.grad[:, 0]),
               want)
    # one device record a call; deterministic: the same inputs give the
    # same bits
    first, records = _k1b_device_records(
        lambda: TN._adaln_bwd_cuda(x, sc[:, 0].contiguous(), gy, 1e-6))
    again = TN._adaln_bwd_cuda(x, sc[:, 0].contiguous(), gy, 1e-6)
    assert records == 1
    for a, c in zip(again, first):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,layout,path", [
    ((16, 256, 1152), "plain", "ring"),
    ((8, 1024, 1152), "plain", "ring"),
    ((3, 17, 1152), "plain", "ring"),
    ((4, 77, 1000), "plain", "generic"),
    ((1, 9, 96), "plain", "generic"),
    ((2, 33, 1152), "unaligned", "generic"),
    ((2, 33, 1152), "g-unaligned", "generic")])
def test_card_adaln_bwd_paths(cuda, dtype, shape, layout, path):
    """K1b's ring (D = 1152, x and g rows on 16-byte boundaries) and its
    generic loop (other widths; x or g off the vectors) against the plain
    backward, without spills, in one device record a call, leaving the
    arrival counters at 0."""
    b, n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(d + n)

    def rows(off):
        t = torch.randn((b, n, d + off), generator=gen, device=cuda)
        return t.to(dtype)[..., off:]
    x = rows(layout == "unaligned")
    gy = rows(layout == "g-unaligned")
    sc = (0.1 * torch.randn((b, d), generator=gen, device=cuda)).to(dtype)
    info = TN.adaln_bwd_launch_info(x, sc, gy)
    assert info["path"] == path and info["local_bytes"] == 0
    got, records = _k1b_device_records(
        lambda: TN._adaln_bwd_cuda(x, sc, gy, 1e-6))
    assert records == 1
    _close_bwd("adaln_layernorm_bwd", got, TN.adaln_bwd_ref(x, sc, gy))
    for partial, arrivals in TN._BWD_SCRATCH.values():
        assert not bool(arrivals.any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nk,h,d", [(16, 256, 512, 16, 72),
                                         (16, 256, 128, 16, 72),
                                         (4, 100, 300, 16, 72),
                                         (2, 64, 16, 2, 32),
                                         (4, 100, 300, 16, 32),
                                         (4, 100, 300, 16, 64),
                                         (4, 100, 300, 8, 128)])
def test_card_attention_bwd_kernel(cuda, dtype, b, nq, nk, h, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, gy = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                             (b, nq, h, d)))
    keep = torch.linspace(1, nk, b, device=cuda).round()
    mask = (torch.arange(nk, device=cuda)[None] < keep[:, None]).int()
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    # the folded branch (h * d = 64 here) counts as K4b
    kern = (TA.SOFTMAX_ATTENTION_FOLDED_BWD
            if TA.attention_branch(nq, nk, h, d, "vmem") == "folded"
            else TA.SOFTMAX_ATTENTION_BWD)
    before = kern.launches
    out = TA.dot_product_attention(qs, ks, vs, mask=mask,
                                   implementation="vmem")
    assert out.grad_fn is not None
    if dtype == torch.float32 and d == 128:
        # the fp32 path's shared-memory tiles do not fit one block at
        # D = 128: the wrapper refuses before launching
        with pytest.raises(ValueError, match="shared memory"):
            out.backward(gy)
        assert kern.launches == before
        return
    out.backward(gy)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = TA.attention_bwd_ref(q, k, v, TA._key_bias(mask, b), gy)
    _close_bwd("dot_product_attention_bwd", (qs.grad, ks.grad, vs.grad),
               want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_softmax_self_attention_fwd_bwd(cuda, dtype):
    """The self-attention of SANA's softmax-patched blocks in training:
    q/k/v [16, 256, 36, 32], 256 keys, no key bias; the short-sequence
    gate sends it to K2 (native layout), its backward to K2b, one launch
    each, against the plain versions."""
    b, n, h, d = 16, 256, 36, 32
    assert TA.attention_branch(n, n, h, d) == "native"
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, gy = (torch.randn((b, n, h, d), generator=g,
                               device=cuda).to(dtype) for _ in range(4))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    fwd, bwd = TA.SOFTMAX_ATTENTION.launches, TA.SOFTMAX_ATTENTION_BWD.launches
    out = TA.dot_product_attention(qs, ks, vs)
    out.backward(gy)
    torch.cuda.synchronize()
    assert TA.SOFTMAX_ATTENTION.launches == fwd + 1
    assert TA.SOFTMAX_ATTENTION_BWD.launches == bwd + 1
    _close(out.detach(), TA.attention_ref(q, k, v, None))
    _close_bwd("dot_product_attention_bwd", (qs.grad, ks.grad, vs.grad),
               TA.attention_bwd_ref(q, k, v, None, gy))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nk", [256, 300])
def test_card_folded_attention_bwd_kernel(cuda, dtype, nk):
    """K4b: PixArt-Sigma's cross-attention backward at the folded caption
    rungs (10-300 kept keys) through K2b's kernel under its own counter."""
    b, nq, h, d = 8, 1024, 16, 72
    assert TA.attention_branch(nq, nk, h, d) == "folded"
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v, gy = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                             (b, nq, h, d)))
    mask = _keep_mask([10 + (nk - 10) * i // 7 for i in range(8)], nk, cuda)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    before = KB.launch_counts()
    TA.dot_product_attention(qs, ks, vs, mask=mask).backward(gy)
    torch.cuda.synchronize()
    after = KB.launch_counts()
    assert after["dot_product_attention_folded_bwd"] == (
        before["dot_product_attention_folded_bwd"] + 1)
    assert after["dot_product_attention_bwd"] == (
        before["dot_product_attention_bwd"])
    want = TA.attention_bwd_ref(q, k, v, TA._key_bias(mask, b), gy)
    _close_bwd("dot_product_attention_folded_bwd",
               (qs.grad, ks.grad, vs.grad), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 72, 128])
@pytest.mark.parametrize("folded", [False, True])
def test_card_attention_bwd_masked_rows(cuda, dtype, d, folded):
    """K2b and K4b called directly with N_q = 100 (not a multiple of 64), a
    ragged N_k = 300 and a fully masked row (batch element 0 keeps no
    key)."""
    b, nq, nk, h = 3, 100, 300, 4
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, gy = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                             (b, nq, h, d)))
    bias = TA._key_bias(_keep_mask([0, 1, 300], nk, cuda), b)
    kern = (TA.SOFTMAX_ATTENTION_FOLDED_BWD if folded
            else TA.SOFTMAX_ATTENTION_BWD)
    before = kern.launches
    if dtype == torch.float32 and d == 128:
        # the fp32 path's tiles do not fit one block's shared memory
        with pytest.raises(ValueError, match="shared memory"):
            TA._attention_bwd_cuda(q, k, v, bias, gy, folded=folded)
        assert kern.launches == before
        return
    got = TA._attention_bwd_cuda(q, k, v, bias, gy, folded=folded)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _close_bwd("dot_product_attention_bwd", got,
               TA.attention_bwd_ref(q, k, v, bias, gy))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash", "softmax", "folded"])
def test_card_attention_bwd_kernels_are_bit_reproducible(cuda, kernel):
    """K6b, K2b and K4b at their training shapes in bf16: two launches on
    the same inputs give the same bits (no atomics; every sum in a fixed
    order)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    b, nq, nk, h, d = {"flash": (8, 1024, 1024, 16, 72),
                       "softmax": (16, 256, 512, 16, 72),
                       "folded": (8, 1024, 300, 16, 72)}[kernel]
    q, k, v, gy = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
                   for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                             (b, nq, h, d)))
    if kernel == "flash":
        bias = None
        o, l, m = TA._flash_attention_cuda(q, k, v, bias, residuals=True)

        def run():
            return TA._flash_attention_bwd_cuda(q, k, v, bias, o, l, m, gy)
    else:
        bias = TA._key_bias(_keep_mask(
            [10 + (nk - 10) * i // (b - 1) for i in range(b)], nk, cuda), b)

        def run():
            return TA._attention_bwd_cuda(q, k, v, bias, gy,
                                          folded=kernel == "folded")
    first = run()
    second = run()
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a.view(torch.int16), c.view(torch.int16))


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


# ---------------------------------------------------------------------------
# K5/K5b, the w8a8 matmul: bit-equal to the plain versions
# ---------------------------------------------------------------------------

# [T, K] x [K -> N]: SANA-0.6B's attention projections on the image tokens
# and on the caption, its GLUMB up-projection; PixArt-Sigma's MLP; the
# largest K the gate admits at the smallest T; then T = 128, 256, 384 at
# N = 128 and 5760 (K5b contracting over 5760) and K = 2304 and 6144, so
# the quantize holds 3, 6 and 12 chunks a lane (fp32: 3, 4 and rows read
# again) and the GEMM takes both grids: one block a tile (fewer tiles than
# SMs) and one block per SM walking the tiles
W8A8_SHAPES = [(4096, 1152, 1152), (8192, 1152, 1152), (4096, 1152, 5760),
               (8192, 1152, 4608), (8192, 4608, 1152), (128, 6144, 6144),
               (128, 1152, 128), (256, 2304, 384), (384, 1152, 5760),
               (128, 6144, 256), (384, 256, 6144)]

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,k,n", W8A8_SHAPES)
def test_card_w8a8_kernels_bit_equal(cuda, dtype, t, k, n):
    """K5 and K5b against their plain versions: the int8 payload, the row
    scales and the output equal bit for bit (zero rows and rows with one
    large value included)."""
    import chip_smoke
    x, q, ws, g = chip_smoke.w8a8_inputs(t, k, n, dtype, cuda, seed=t + k + n,
                                         special=True)
    for kern, plain, a in ((TQ._w8a8_cuda, TQ.w8a8_matmul_ref, x),
                           (TQ._w8a8_bwd_cuda, TQ.w8a8_matmul_bwd_ref, g)):
        got = kern(a, q, ws, quantized=True)
        want = plain(a, q, ws, quantized=True)
        torch.cuda.synchronize()
        assert chip_smoke.w8a8_mismatch(got, want) is None, (
            kern.__name__, chip_smoke.w8a8_mismatch(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_w8a8_kernels_are_bit_reproducible(cuda, dtype):
    """Two launches of K5 and of K5b on the same inputs give the same bits
    (payload, row scales and output)."""
    import chip_smoke
    x, q, ws, g = chip_smoke.w8a8_inputs(4096, 1152, 1152, dtype, cuda)
    for kern, a in ((TQ._w8a8_cuda, x), (TQ._w8a8_bwd_cuda, g)):
        first = kern(a, q, ws, quantized=True)
        second = kern(a, q, ws, quantized=True)
        torch.cuda.synchronize()
        for u, v in zip(first, second):
            assert torch.equal(chip_smoke._bits(u), chip_smoke._bits(v))


@pytest.mark.gpu
def test_card_w8a8_wrappers_refuse_unaligned_bases(cuda):
    """TMA and the 16-byte loads need 16-byte-aligned bases: an activation,
    gradient or weight that starts off a 16-byte boundary raises, and
    launches nothing."""
    import chip_smoke
    t, k, n = 256, 1152, 1152
    x, q, ws, g = chip_smoke.w8a8_inputs(t, k, n, torch.bfloat16, cuda)
    x_off = torch.empty(t * k + 1, dtype=x.dtype, device=cuda)[1:].view(t, k)
    x_off.copy_(x)
    g_off = torch.empty(t * n + 1, dtype=g.dtype, device=cuda)[1:].view(t, n)
    g_off.copy_(g)
    q_off = torch.empty(n * k + 8, dtype=q.dtype, device=cuda)[8:].view(n, k)
    q_off.copy_(q)
    before = KB.launch_counts()
    for call in (lambda: TQ._w8a8_cuda(x_off, q, ws),
                 lambda: TQ._w8a8_cuda(x, q_off, ws),
                 lambda: TQ._w8a8_bwd_cuda(g_off, q, ws),
                 lambda: TQ._w8a8_bwd_cuda(g, q_off, ws)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            call()
    assert KB.launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_w8a8_matmul_launches_the_kernels(cuda, dtype, monkeypatch):
    """A CUDA tensor never takes the plain path: ``w8a8_matmul`` on
    ``[16, 256, 1152]`` launches K5 forward and K5b backward once each (the
    plain versions raise here) with the plain versions' bits, and the scale
    gets a zero gradient.  A shape off the gate takes the dequantized matmul
    and launches nothing."""
    import chip_smoke
    x, q, ws, g = chip_smoke.w8a8_inputs(4096, 1152, 1152, dtype, cuda)
    want_y = TQ.w8a8_matmul_ref(x, q, ws)
    want_dx = TQ.w8a8_matmul_bwd_ref(g, q, ws)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(TQ, "w8a8_matmul_ref", plain)
    monkeypatch.setattr(TQ, "w8a8_matmul_bwd_ref", plain)
    xs = x.reshape(16, 256, 1152).clone().requires_grad_()
    wss = ws.clone().requires_grad_()
    before = KB.launch_counts()
    y = TQ.w8a8_matmul(xs, q, wss)
    y.backward(g.reshape(16, 256, 1152))
    torch.cuda.synchronize()
    after = KB.launch_counts()
    assert after["w8a8_matmul"] == before["w8a8_matmul"] + 1
    assert after["w8a8_matmul_bwd"] == before["w8a8_matmul_bwd"] + 1
    assert torch.equal(chip_smoke._bits(y.reshape(4096, 1152)),
                       chip_smoke._bits(want_y))
    assert torch.equal(chip_smoke._bits(xs.grad.reshape(4096, 1152)),
                       chip_smoke._bits(want_dx))
    assert torch.equal(wss.grad, torch.zeros_like(ws))
    # off the gate (T = 100): the dequantized matmul, no launch
    before = KB.launch_counts()
    out = TQ.w8a8_matmul(x[:100], q, ws)
    assert KB.launch_counts() == before
    torch.testing.assert_close(
        out, torch.nn.functional.linear(
            x[:100], TQ.dequantize_kernel(q, ws, dtype)), atol=0, rtol=0)
    with pytest.raises(ValueError, match="not a shape"):
        TQ._w8a8_cuda(x[:100], q, ws)


def _unet_cases():
    import chip_smoke
    return [(name, label) for name, cases in chip_smoke.UNET_CASES.items()
            for label, _ in cases]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,label", _unet_cases())
def test_card_unet_attention_shapes(cuda, dtype, name, label):
    """K6/K6b, K4/K4b and K2/K2b at the UNet's shapes (chip_smoke.py's
    ``UNET_CASES``: SD1.5's head dims 40 and 80, SDXL's 64, over CLIP's 77
    keys all kept or partly masked): each kernel launches once and holds
    against its plain version with chip_smoke.py's tolerance."""
    import chip_smoke
    case = next(c for c in chip_smoke.kernel_cases(cuda)
                if c[:3] == (name, label, dtype))
    _, _, _, make, kern, plain = case[:6]
    args = make()
    handle = {"flash_attention": TA.FLASH_ATTENTION,
              "flash_attention_bwd": TA.FLASH_ATTENTION_BWD,
              "dot_product_attention": TA.SOFTMAX_ATTENTION,
              "dot_product_attention_bwd": TA.SOFTMAX_ATTENTION_BWD,
              "dot_product_attention_folded": TA.SOFTMAX_ATTENTION_FOLDED,
              "dot_product_attention_folded_bwd":
                  TA.SOFTMAX_ATTENTION_FOLDED_BWD}[name]
    before = handle.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert handle.launches == before + 1
    assert chip_smoke.compare(name, got, plain(*args))[2]


def _sd35_cases():
    import chip_smoke
    return [(name, label) for name, cases in chip_smoke.SD35_CASES.items()
            for label, _ in cases]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,label", _sd35_cases())
def test_card_sd35_shapes(cuda, dtype, name, label):
    """K6/K6b at SD3.5's joint and MMDiT-X attentions (head dim 64, the
    ragged 4429 tokens: a last query and key block of 77 rows) and K1/K1b
    at width 1536 (chip_smoke.py's ``SD35_CASES``): one launch each,
    within chip_smoke.py's tolerance of the plain version."""
    import chip_smoke
    case = next(c for c in chip_smoke.kernel_cases(cuda)
                if c[:3] == (name, label, dtype))
    _, _, _, make, kern, plain = case[:6]
    args = make()
    handle = {"flash_attention": TA.FLASH_ATTENTION,
              "flash_attention_bwd": TA.FLASH_ATTENTION_BWD,
              "adaln_layernorm": TN.ADALN,
              "adaln_layernorm_bwd": TN.ADALN_BWD}[name]
    before = handle.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert handle.launches == before + 1
    assert chip_smoke.compare(name, got, plain(*args))[2]


def _flux_cases():
    import chip_smoke
    return [(name, label) for name, cases in chip_smoke.FLUX_CASES.items()
            for label, _ in cases]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,label", _flux_cases())
def test_card_flux_shapes(cuda, dtype, name, label):
    """K6/K6b at Flux-2 Klein's attention (head dim 128 over 4096 + 512
    tokens, at the held batch 2) and K1/K1b at width 3072 (chip_smoke.py's
    ``FLUX_CASES``): one launch each, within chip_smoke.py's tolerance of
    the plain version."""
    import chip_smoke
    case = next(c for c in chip_smoke.kernel_cases(cuda)
                if c[:3] == (name, label, dtype))
    _, _, _, make, kern, plain = case[:6]
    args = make()
    handle = {"flash_attention": TA.FLASH_ATTENTION,
              "flash_attention_bwd": TA.FLASH_ATTENTION_BWD,
              "adaln_layernorm": TN.ADALN,
              "adaln_layernorm_bwd": TN.ADALN_BWD}[name]
    before = handle.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert handle.launches == before + 1
    assert chip_smoke.compare(name, got, plain(*args))[2]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_flash_attention_direct_under_remat(cuda, dtype):
    """``flash_attention`` (the MMDiT's joint attention) through autograd
    at a ragged length with short last blocks, plain and under
    ``torch.utils.checkpoint``: K6 launches once (twice under remat, the
    recomputed forward saving its row statistics again), K6b once, and
    the gradients are the same bits both ways and hold against the plain
    backward."""
    import torch.utils.checkpoint as ckpt

    import chip_smoke
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, gy = (torch.randn((2, 333, 4, 64), generator=g,
                               device=cuda).to(dtype) for _ in range(4))
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (TA.FLASH_ATTENTION.launches, TA.FLASH_ATTENTION_BWD.launches)
        out = (ckpt.checkpoint(TA.flash_attention, *leaves,
                               use_reentrant=False) if remat
               else TA.flash_attention(*leaves))
        out.backward(gy)
        torch.cuda.synchronize()
        assert (TA.FLASH_ATTENTION.launches - before[0],
                TA.FLASH_ATTENTION_BWD.launches - before[1]) == (
                    2 if remat else 1, 1)
        grads.append([t.grad for t in leaves])
    for a, c in zip(*grads):
        assert torch.equal(a, c)
    o, l, m = TA._flash_attention_cuda(q, k, v, None, residuals=True)
    want = TA.flash_attention_bwd_ref(q, k, v, None, o, l, m, gy)
    assert chip_smoke.compare("flash_attention_bwd", tuple(grads[0]),
                              want)[2]
