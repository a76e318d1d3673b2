#!/usr/bin/env python3
"""Run the port's attention, int8, linear-attention and adaLN kernels on
the host CPU, to check fragment maps, masks, descriptors and ring stages
of a kernel before its first call on the card.

    python3 tools/cuda_emulator/emulate.py [fwd] [k2] [k6b] [k2b] [k5] [k5b]
                                           [k3] [k3s] [k3a] [k1] [k1b]

The sources of ``yat_tpu_torch/csrc`` are copied to ``_build/`` beside this
file with the inline-asm helpers of ``attention_tiles.cuh`` (ldmatrix,
mma.sync, cp.async) replaced by the warp-level model of ``runtime.cpp``,
``extern __shared__`` arrays by one host buffer and ``<<<...>>>`` launches
by ``emu_launch``; ``g++`` builds one shared library per source, and each
case calls its C entry point on CPU tensors and holds the result against
the plain version with ``chip_smoke.py``'s tolerance, and checks that two
launches give the same bits (and, for the backwards, that a backward
without its row term is rejected).  The forwards ``fwd`` (K6) and ``k2``
(K2, K4) also run at masks whose kept keys fill one middle or the last
64-key tile, with a leading or middle key block of K6 fully masked, at
and N_q past 128, and must give the same bits when the K and V rows of
every fully masked tile are NaN: such tiles are never read.  All four
also run the UNet's shapes cut to size (``UNET_CASES``: head dims 40, 64
and 80 over CLIP's 77 keys, all kept or partly masked) and SD3.5's joint
attention cut to size (``SD35_CASES``: head dim 64, ragged N_q = N_k
whose last query and key blocks hold 77 rows), Flux's (``FLUX_CASES``:
head dim 128, N_q = N_k with a last block of 64 rows, and whole blocks)
and PixelDiT's (``PIXELDIT_CASES``: 4 heads of 64 with a last block of 64
rows, and 300 caption keys at head dim 64).

``k5`` and ``k5b`` (the w8a8 matmul and its backward, one source) run
with Hopper's mbarriers, TMA tile loads (128-byte swizzle) and wgmma s8
from shared-memory descriptors replaced by runtime.cpp's models, on a
3-SM device, at small shapes that take a persistent grid (each block
walking several tiles, the ring wrapping) and a grid of one block per
tile, and every quantize hold (3, 6 and 12 chunks a lane; fp32 rows past
2048 read again), zero rows and large values included; payload, row
scales and output must equal the plain versions' bit for bit, twice.

``k3`` (ReLU linear attention) runs bf16 with a rounded state (the
tensor-core path), bf16 with an fp32 state and fp32 (the CUDA-core path)
at N = 256, the ragged N = 100 and 17, N = 600 (each warp's ring of
stages wrapping), head dims 16, 32, 64 and 20 (4-byte copies), q/k/v as
views of one fused [B, N, 3, H, D] tensor, and with a NaN in one k entry
and one q entry (the NaN positions must be the plain version's).  ``k3s``
and ``k3a`` (K3's halves for token-sharded blocks, K3s the fp32 state
and key sum, K3a the apply on a given state) run ``chip_smoke.py``'s two
cases ([16, 128, 36, 32] and N = 17 at head dim 64; a minute or two
each, the first on 576 blocks), a fused view at head dim 20 and N = 600
at head dim 48, on the same three paths and fp32 with the state
rounded, each against its plain half with ``chip_smoke.py``'s tolerance,
twice for the same bits and on its path (the tensor cores for K3s on
bf16 and for K3a on bf16 with ``round_kv``); then K3a on K3s's state must
give K3's bits where K3 runs the same halves (bf16 with ``round_kv``, and
fp32).
``k1``
(the adaLN forward) runs D = 1152 (the row in registers), D = 1000,
SD3.5's D = 1536, Flux's D = 3072, PixelDiT's D = 1024 and 256 and an
unaligned D = 1152 view (the generic loop), at
ragged N.  ``k1b`` (its
backward, one launch whose last block of each batch element adds the
blocks' column sums) runs the same three layouts, bf16 and fp32, at N =
256 (each warp's ring wraps), 100 (a last block with fewer rows than
warps) and 17, B = 1 and 3; the blocks run in an order drawn anew for
every launch, so the block that arrives last changes, and the arrival
counters must be back at 0 after each launch.  Each case names the path
the launch took, is held against its plain version with ``chip_smoke.py``'s
tolerance and must give the same bits twice (a bf16 K1b without its
xhat * m2 term must be rejected).

Timings mean nothing here, and nvcc may still refuse what g++ accepts.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
BUILD = HERE / "_build"
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from yat_tpu_torch.kernels.build import CSRC_DIR  # noqa: E402
from yat_tpu_torch.ops import attention as A  # noqa: E402

SOURCES = {"fwd": "flash_attention", "k2": "softmax_attention",
           "k6b": "flash_attention_bwd", "k2b": "softmax_attention_bwd",
           "k5": "w8a8_matmul", "k5b": "w8a8_matmul",
           "k3": "linear_attention", "k3s": "linear_attention",
           "k3a": "linear_attention", "k1": "adaln", "k1b": "adaln"}
ASM = {"ldsm_x4": "emu_ldsm(r, p, false);",
       "ldsm_x4_t": "emu_ldsm(r, p, true);",
       "mma_bf16": "emu_mma(c, a, b0, b1);",
       "cp_async16": "emu_cp_async(dst, src, src_bytes, 16);",
       "cp_async4": "emu_cp_async(dst, src, src_bytes, 4);",
       "cp_async_commit": "emu_commit();",
       "cp_async_wait": "emu_wait(kPending);",
       "ex2_approx": "return emu_ex2(x);"}
# w8a8_matmul.cu's Hopper primitives
W8A8_ASM = {"smem_addr": "return emu_smem_offset(p);",
            "mbar_init": "emu_mbar_init(bar, count);",
            "mbar_fence_init": "",
            "mbar_expect_tx": "emu_mbar_arrive(bar, bytes);",
            "mbar_arrive": "emu_mbar_arrive(bar, 0);",
            "mbar_wait": "emu_mbar_wait(bar, parity);",
            "tma_load_2d": "emu_tma_load_2d(dst, map, bar, c0, c1);",
            "tma_prefetch": "(void)map;",
            "fence_proxy_async": "",
            # .sync.aligned: the lanes of a warp meet at each wgmma
            # instruction, and a retired group is done for all of them
            "wgmma_fence": "__syncwarp();",
            "wgmma_commit": "__syncwarp(); emu_wgmma_commit();",
            "wgmma_wait": "__syncwarp(); emu_wgmma_wait(N); __syncwarp();",
            "setmaxnreg_inc": "",
            "setmaxnreg_dec": "",
            "fence_acc": "(void)d;",
            "wgmma_s8": "__syncwarp(); emu_wgmma_s8(d, kBN, da, db, scale_d);"}


def _top_level_split(text):
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<"
        depth -= ch in ")>"
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def _launch(m):
    grid, threads = _top_level_split(m.group(2))[:2]
    return f"emu_launch({grid}, {threads}, [&] {{ {m.group(1)}({m.group(3)}); }});"


def prepare():
    """Copy csrc/ to _build/src with the device-only constructs replaced."""
    out = BUILD / "src"
    out.mkdir(parents=True, exist_ok=True)
    for p in list(CSRC_DIR.glob("*.cuh")) + list(CSRC_DIR.glob("*.cu")):
        s = p.read_text()
        for table, owner in ((ASM, "attention_tiles.cuh"),
                             (W8A8_ASM, "w8a8_matmul.cu")):
            for name, body in table.items():
                s, n = re.subn(
                    r"(__device__ __forceinline__ \w+ %s\(.*?\)\s*)"
                    r"\{.*?\n\}\n" % name,
                    lambda m: m.group(1) + "{ " + body + " }\n", s,
                    flags=re.S)
                if p.name == owner and n != 1:
                    raise RuntimeError(f"{name} not found in {p.name}")
        s = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?"
                   r"((?:unsigned )?\w+) (\w+)\[\];",
                   r"\1* \2 = (\1*)emu_smem();", s)
        s = re.sub(r"(\w+(?:<[\w\s,]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                   _launch, s, flags=re.S)
        (out / p.name).write_text(s)
    return out


def build(names):
    src = prepare()
    procs = {}
    for name in dict.fromkeys(names):
        lib = BUILD / f"lib{name}.so"
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-Wno-unknown-pragmas", f"-I{HERE / 'include'}",
             f"-I{src}", "-include", "fake_cuda.h", "-x", "c++",
             str(src / f"{name}.cu"), str(HERE / "runtime.cpp"), "-o",
             str(lib), "-lpthread"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"g++ failed on {name}.cu:\n{log}")
    return {name: ctypes.CDLL(str(BUILD / f"lib{name}.so")) for name in names}


V, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _st(t):
    return list(t.stride()[:3])


def _bias_stride(bias):
    return bias.stride(0) if bias is not None else 0


def run_fwd(lib, q, k, v, bias):
    b, nq, h, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    m, l = torch.empty(2, b, h, nq)
    fn = lib.yat_flash_attention_fwd
    fn.argtypes = [V] * 5 + [I] * 5 + [L] * 13 + [F, I, V, V, I, V]
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), b, nq, nk, h,
             d, *_st(q), *_st(k), *_st(v), _bias_stride(bias), *_st(out),
             1 / d ** 0.5, A.flash_block(nk), _ptr(m), _ptr(l), DTYPE[q.dtype],
             None)
    assert err == 0, err
    return out, l, m


def run_k2(lib, q, k, v, bias):
    b, nq, h, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    fn = lib.yat_attention_fwd
    fn.argtypes = [V] * 5 + [I] * 5 + [L] * 13 + [F, I, V]
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), b, nq, nk, h,
             d, *_st(q), *_st(k), *_st(v), _bias_stride(bias), *_st(out),
             1 / d ** 0.5, DTYPE[q.dtype], None)
    assert err == 0, err
    return out


def run_k6b(lib, q, k, v, bias, o, l, m, g):
    b, nq, h, d = q.shape
    nk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty(b, h, nq)
    fn = lib.yat_flash_attention_bwd
    fn.argtypes = [V] * 12 + [I] * 5 + [L] * 25 + [F, I, V]
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(o), _ptr(g),
             _ptr(m), _ptr(l), _ptr(di), _ptr(dq), _ptr(dk), _ptr(dv), b, nq,
             nk, h, d, *_st(q), *_st(k), *_st(v), _bias_stride(bias),
             *_st(o), *_st(g), *_st(dq), *_st(dk), *_st(dv), 1 / d ** 0.5,
             DTYPE[q.dtype], None)
    assert err == 0, err
    return dq, dk, dv


def run_k2b(lib, q, k, v, bias, g):
    b, nq, h, d = q.shape
    nk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(3, b, h, nq)
    fn = lib.yat_attention_bwd
    fn.argtypes = [V] * 9 + [I] * 5 + [L] * 22 + [F, I, V]
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(g), _ptr(dq),
             _ptr(dk), _ptr(dv), _ptr(stats), b, nq, nk, h, d, *_st(q),
             *_st(k), *_st(v), _bias_stride(bias), *_st(g), *_st(dq),
             *_st(dk), *_st(dv), 1 / d ** 0.5, DTYPE[q.dtype], None)
    assert err == 0, err
    return dq, dk, dv


def inputs(b, nq, nk, h, d, dtype, keep, mask_value, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(s, generator=gen).to(dtype)
                  for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d),
                            (b, nq, h, d)))
    bias = None
    if keep is not None:
        bias = A._key_bias(chip_smoke._mask(keep, nk, "cpu"), b, mask_value)
    return q, k, v, bias, g


# (b, nq, nk, h, d, keep): d = 20 and 40 take the element loads, the
# others 16-byte cp.async; ragged edges; a fully masked row (keep 0); the
# head dims 32, 64, 72, 128 and (K6, K6b) 256
CASES = [(1, 70, 50, 2, 20, [30]), (1, 30, 200, 1, 40, None),
         (1, 100, 100, 2, 32, None), (2, 64, 16, 2, 32, None),
         (2, 100, 300, 1, 72, [1, 300]), (2, 130, 70, 1, 72, [0, 70]),
         (1, 64, 64, 1, 64, None), (1, 80, 90, 1, 128, [90]),
         (1, 70, 100, 1, 256, [100])]
# the forwards' tile walk: kept keys in one middle tile, in the last tile
# only, none (mean of V); N_k = 400 is four key blocks of K6 (128, 128,
# 128, 16), its first or second fully masked; N_q past 128 and ragged
FWD_CASES = [(2, 200, 300, 1, 72, [(130, 141), (290, 300)]),
             (2, 150, 400, 1, 64, [(128, 400), (0, 130)]),
             (3, 40, 400, 1, 72, [(300, 310), 0, (256, 400)]),
             (1, 130, 200, 1, 40, [(70, 75)])]


# the UNet's attention shapes, cut to size: head dims 40 (padded to 64 in
# 4 chunks of 16), 64 (4 chunks) and 80 (5 chunks) over CLIP's 77 keys
# (all kept, and a partial mask), and self-attention past one key block
UNET_CASES = [(2, 136, 77, 2, 40, [77, 20]), (1, 256, 256, 2, 40, None),
              (2, 72, 77, 3, 80, [77, 5]), (1, 200, 200, 1, 80, [200]),
              (2, 130, 77, 2, 64, [77, 33]), (1, 256, 256, 1, 64, None)]
# SD3.5's joint attention cut to size (K6 and K6b called directly, no
# mask): head dim 64 over N_q = N_k = 2 * 128 + 77, as 4429 = 34 * 128 +
# 77 leaves a last query block and a last key block of 77 rows; one full
# block and the short one
SD35_CASES = [(1, 333, 333, 2, 64, None), (2, 205, 205, 1, 64, None)]
# Flux's attention cut to size (K6 and K6b called directly, no mask):
# head dim 128 (8 chunks of 16, the forward's key sub-step halved to 16)
# over N_q = N_k = 2 * 128 + 64, as 4096 image tokens plus a 64-token
# caption rung leave a last query and key block of 64 rows, and over
# 2 * 128, as 4608 = 36 * 128 fills every block
FLUX_CASES = [(1, 320, 320, 2, 128, None), (2, 256, 256, 1, 128, None)]
# PixelDiT's attentions cut to size: the pixel stage's self-attention (K6
# and K6b called directly, no mask) in 4 heads of 64 over N_q = N_k =
# 2 * 128 + 64, as the 15552 pixel tokens of its 864x288 bucket leave a
# last query and key block of 64 rows; the patch stage's cross-attention
# (K4/K4b) at head dim 64 over the 300-token caption, all kept or 9 kept
PIXELDIT_CASES = [(1, 320, 320, 4, 64, None), (2, 136, 300, 2, 64, [300, 9])]


def check_fwd(which, lib, dtype, case):
    """K6 (``fwd``, with its l and m residuals) or K2 (``k2``) against its
    plain version; two launches, and one with the fully masked tiles'
    K and V rows poisoned, give the same bits."""
    b, nq, nk, h, d, keep = case
    if d > (128 if which == "k2" or dtype == torch.float32 else 256):
        return None
    flash = which == "fwd"
    mask_value = A.FLASH_MASK_VALUE if flash else A._VMEM_MASK_VALUE
    q, k, v, bias, _ = inputs(b, nq, nk, h, d, dtype, keep, mask_value)
    if flash:
        def run(k, v):
            return run_fwd(lib, q, k, v, bias)
        want = A.flash_attention_ref(q, k, v, bias, residuals=True)
        name = "flash_attention"
    else:
        def run(k, v):
            return (run_k2(lib, q, k, v, bias),)
        want = (A.attention_ref(q, k, v, bias),)
        name = "dot_product_attention"
    got = run(k, v)
    # the output against the tolerance; l and m (fp32 statistics of the
    # same scores summed in another order) printed beside it
    err, used, ok, _ = chip_smoke.compare(name, got[0], want[0])
    stats = ", ".join(f"|{n} - plain| {float((x - y).abs().max()):.1e}"
                      for n, x, y in zip("lm", got[1:], want[1:]))
    same = all(torch.equal(x, y) for x, y in zip(got, run(k, v)))
    pk, pv = ((k, v) if bias is None else
              chip_smoke.poison_masked_tiles(k, v, bias != mask_value))
    skipped = dtype == torch.float32 or all(
        torch.equal(x, y) for x, y in zip(got, run(pk, pv)))
    text = (f"max_abs_err {err:.3e}, {used:.3f} of the allowance"
            + (f" ({stats})" if stats else "")
            + f", {'ok' if ok else 'MISMATCH'}, "
            f"{'same bits' if same else 'NOT REPRODUCIBLE'}"
            + ("" if dtype == torch.float32 else
               ", masked tiles " + ("skipped" if skipped else "READ")))
    if not (ok and same and skipped):
        raise SystemExit(f"{which} {dtype} {case}: {text}")
    return text


def check(which, lib, dtype, case):
    b, nq, nk, h, d, keep = case
    if which == "k2b":
        if d > 128:
            return None
        q, k, v, bias, g = inputs(b, nq, nk, h, d, dtype, keep, -1e9)
        args = (q, k, v, bias, g)
        got, want = run_k2b(lib, *args), A.attention_bwd_ref(*args)
        name, wrong = ("dot_product_attention_bwd",
                       chip_smoke.attention_bwd_without_row_term)
        again = run_k2b(lib, *args)
    else:
        if dtype == torch.float32 and d > 128 and which == "fwd":
            return None
        q, k, v, bias, g = inputs(b, nq, nk, h, d, dtype, keep,
                                  A.FLASH_MASK_VALUE)
        o, l, m = A.flash_attention_ref(q, k, v, bias, residuals=True)
        args = (q, k, v, bias, o, l, m, g)
        got, want = run_k6b(lib, *args), A.flash_attention_bwd_ref(*args)
        name, wrong = ("flash_attention_bwd",
                       chip_smoke.flash_attention_bwd_without_di)
        again = run_k6b(lib, *args)
    err, used, ok, _ = chip_smoke.compare(name, got, want)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    text = f"max_abs_err {err:.3e}, {used:.3f} of the allowance, " \
        f"{'ok' if ok else 'MISMATCH'}, {'same bits' if same else 'NOT REPRODUCIBLE'}"
    if dtype == torch.bfloat16:
        rejected = not chip_smoke.compare(name, wrong(*args), want)[2]
        text += ", row-term-less backward " + (
            "rejected" if rejected else "ACCEPTED")
        ok = ok and rejected
    if not (ok and same):
        raise SystemExit(f"{which} {dtype} {case}: {text}")
    return text


# (t, k, n): K5 at [t, k] x [k -> n], K5b contracting over n into [t, k].
# 3 x 3 tiles on 3 SMs (each block walks three, the ring wraps more than
# once), 2 x 3 (two each), 1 x 4 (unequal counts), 1 x 3 and 1 x 1 (one
# block a tile); the quantize holding 3, 6 and 12 chunks a lane (fp32
# rows past 2048 read again)
W8A8_CASES = {"k5": [(384, 512, 384), (256, 256, 384), (128, 256, 512),
                     (128, 512, 384), (128, 1664, 128), (128, 3200, 128)],
              "k5b": [(384, 384, 512), (256, 384, 256), (128, 512, 256),
                      (128, 384, 512), (128, 128, 1664), (128, 128, 3200)]}


def run_w8a8(lib, which, a, q, w_scale):
    """One K5 (``k5``) or K5b call on CPU tensors: (out, payload, row
    scales)."""
    t, c = a.shape
    n, k = q.shape
    out = torch.empty((t, n if which == "k5" else k), dtype=a.dtype)
    a8 = torch.empty((t, c), dtype=torch.int8)
    scale = torch.empty((t,), dtype=torch.float32)
    fn = lib.yat_w8a8_fwd if which == "k5" else lib.yat_w8a8_bwd
    fn.argtypes = [V] * 6 + [I] * 4 + [V]
    err = fn(a.data_ptr(), q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
             a8.data_ptr(), scale.data_ptr(), t, k, n, DTYPE[a.dtype], None)
    assert err == 0, err
    return out, a8, scale


def check_w8a8(which, lib, dtype, case):
    """K5 or K5b against its plain version, bit for bit, twice."""
    from yat_tpu_torch.ops import quant as Q
    t, k, n = case
    x, q, w_scale, g = chip_smoke.w8a8_inputs(t, k, n, dtype, "cpu",
                                              seed=t + k + n, special=True)
    bwd = which == "k5b"
    info = (ctypes.c_longlong * 12)()
    lib.yat_w8a8_launch_info.argtypes = [I] * 5 + [V]
    assert lib.yat_w8a8_launch_info(t, k, n, int(bwd), DTYPE[dtype],
                                    ctypes.addressof(info)) == 0
    a = g if bwd else x
    got = run_w8a8(lib, which, a, q, w_scale)
    again = run_w8a8(lib, which, a, q, w_scale)
    want = (Q.w8a8_matmul_bwd_ref if bwd else Q.w8a8_matmul_ref)(
        a, q, w_scale, quantized=True)
    bad = chip_smoke.w8a8_mismatch(got, want)
    same = all(torch.equal(u, v) for u, v in zip(got, again))
    text = (f"grid {info[0]} for {info[1]} tiles, {info[2]} stages, "
            f"quantize holding {info[7]} chunks a lane: "
            + ("bit-equal" if bad is None else f"DIFFER at the {bad}")
            + (", same bits" if same else ", NOT REPRODUCIBLE"))
    if bad is not None or not same:
        raise SystemExit(f"{which} {dtype} {case}: {text}")
    return text


# K3: (b, n, h, d, layout): N = 256 (a warp's whole stream in its ring),
# ragged 100 and 17, 600 (the ring wraps); head dims 16, 64 and 20 (4-byte
# copies); q/k/v as views of one fused [B, N, 3, H, D] tensor
K3_CASES = [(1, 256, 2, 32, "plain"), (1, 100, 2, 32, "plain"),
            (1, 17, 2, 32, "plain"), (1, 600, 1, 32, "plain"),
            (1, 256, 1, 16, "plain"), (1, 100, 1, 64, "plain"),
            (1, 70, 1, 20, "plain"), (2, 40, 2, 32, "fused")]
# (dtype, round_kv): the tensor-core path, then the CUDA-core path
K3_MODES = [(torch.bfloat16, True), (torch.bfloat16, False),
            (torch.float32, False)]


def k3_inputs(b, n, h, d, dtype, layout, nan=False, seed=0):
    gen = torch.Generator().manual_seed(seed + n + d)
    if layout == "fused":
        qkv = torch.randn((b, n, 3, h, d), generator=gen).to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn((b, n, h, d), generator=gen).to(dtype)
                   for _ in range(3))
    if nan:
        # k's NaN spoils its whole head, q's its own row
        k[0, n // 3, h - 1, d // 4] = float("nan")
        q[0, n // 2, 0, d // 3] = float("nan")
    return q, k, v


def run_k3(lib, q, k, v, round_kv):
    """One K3 call: (output, [path, copy bytes, ...] of the launch)."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n,
            h, d, *_st(q), *_st(k), *_st(v), *_st(out), 1e-15,
            int(round_kv), DTYPE[q.dtype]]
    argtypes = [V] * 4 + [I] * 4 + [L] * 12 + [F, I, I, V]
    lib.yat_linear_attention_fwd.argtypes = argtypes
    lib.yat_linear_attention_info.argtypes = argtypes
    info = (ctypes.c_longlong * 6)()
    assert lib.yat_linear_attention_info(*args, ctypes.addressof(info)) == 0
    err = lib.yat_linear_attention_fwd(*args, None)
    assert err == 0, err
    return out, list(info)


def check_k3(lib, dtype, round_kv, case, nan=False):
    b, n, h, d, layout = case
    q, k, v = k3_inputs(b, n, h, d, dtype, layout, nan)
    got, info = run_k3(lib, q, k, v, round_kv)
    again, _ = run_k3(lib, q, k, v, round_kv)
    want = A.linear_attention_ref(q, k, v, round_kv=round_kv)
    same = torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    path = (f"{'tensor cores' if info[0] else 'CUDA cores'}, "
            f"{info[1]}-byte copies")
    if nan:
        count, where, err, used, ok, _ = chip_smoke.compare_nan(
            "linear_attention", got, want)
        placed = "where the plain version has them" if where else "MISPLACED"
        text = (f"{path}: {count} NaN outputs {placed}, the rest "
                f"max_abs_err {err:.3e}, {used:.3f} of the allowance")
    else:
        err, used, ok, _ = chip_smoke.compare("linear_attention", got, want)
        text = f"{path}: max_abs_err {err:.3e}, {used:.3f} of the allowance"
    text += (f", {'ok' if ok else 'MISMATCH'}, "
             f"{'same bits' if same else 'NOT REPRODUCIBLE'}")
    if not (ok and same):
        raise SystemExit(f"k3 {dtype} round_kv={round_kv} {case}: {text}")
    return text


# K3s and K3a: chip_smoke.py's two cases (one process's tokens of a SANA
# training step at {sp: 2}; N = 17 at head dim 64, two state columns a
# lane on the CUDA cores), plus a fused q/k/v view at an odd head dim (4-byte
# copies) and N = 600 (the rings wrap); bf16 with a rounded state (the
# tensor cores), bf16 and fp32 with an fp32 state and fp32 rounded (the CUDA
# cores)
K3S_CASES = [(16, 128, 36, 32, "plain"), (2, 17, 4, 64, "plain"),
             (2, 40, 2, 20, "fused"), (1, 600, 1, 48, "plain")]
K3S_MODES = K3_MODES + [(torch.float32, True)]


def run_k3s(lib, k, v):
    """One K3s call: ((kv, ksum), [path, copy bytes, ...])."""
    b, n, h, d = k.shape
    kv = torch.full((b, h, d, d), float("nan"))
    ksum = torch.full((b, h, d), float("nan"))
    args = [k.data_ptr(), v.data_ptr(), kv.data_ptr(), ksum.data_ptr(), b, n,
            h, d, *_st(k), *_st(v), DTYPE[k.dtype]]
    argtypes = [V] * 4 + [I] * 4 + [L] * 6 + [I, V]
    lib.yat_linear_attention_state.argtypes = argtypes
    lib.yat_linear_attention_state_info.argtypes = argtypes
    info = (ctypes.c_longlong * 6)()
    assert lib.yat_linear_attention_state_info(*args,
                                               ctypes.addressof(info)) == 0
    err = lib.yat_linear_attention_state(*args, None)
    assert err == 0, err
    return (kv, ksum), list(info)


def run_k3a(lib, q, kv, ksum, round_kv):
    """One K3a call: (output, [path, copy bytes, ...])."""
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype)
    args = [q.data_ptr(), kv.data_ptr(), ksum.data_ptr(), out.data_ptr(), b,
            n, h, d, *_st(q), *_st(out), 1e-15, int(round_kv),
            DTYPE[q.dtype]]
    argtypes = [V] * 4 + [I] * 4 + [L] * 6 + [F, I, I, V]
    lib.yat_linear_attention_apply.argtypes = argtypes
    lib.yat_linear_attention_apply_info.argtypes = argtypes
    info = (ctypes.c_longlong * 6)()
    assert lib.yat_linear_attention_apply_info(*args,
                                               ctypes.addressof(info)) == 0
    err = lib.yat_linear_attention_apply(*args, None)
    assert err == 0, err
    return out, list(info)


def _int_view(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_k3s_k3a(lib, which, dtype, round_kv, case):
    """K3s (``which`` "k3s") or K3a ("k3a", on the plain state) against its
    plain half, twice; then K3a on K3s's state against K3 on the same q, k,
    v, bit for bit where K3 runs the same halves (one process's state is
    K3's first half)."""
    b, n, h, d, layout = case
    q, k, v = k3_inputs(b, n, h, d, dtype, layout)
    if which == "k3s":
        got, info = run_k3s(lib, k, v)
        again, _ = run_k3s(lib, k, v)
        want = A.linear_attention_state_ref(k, v)
        name = "linear_attention_state"
    else:
        kv, ksum = A.linear_attention_state_ref(k, v)
        got, info = run_k3a(lib, q, kv, ksum, round_kv)
        again, _ = run_k3a(lib, q, kv, ksum, round_kv)
        want = A.linear_attention_apply_ref(q, kv, ksum, 1e-15, round_kv)
        name = "linear_attention_apply"
        got, again, want = (got,), (again,), (want,)
    err, used, ok, _ = chip_smoke.compare(name, got, want)
    same = all(torch.equal(_int_view(x), _int_view(y))
               for x, y in zip(got, again))
    bf16 = dtype == torch.bfloat16
    as_k3 = True
    text = (f"{'tensor cores' if info[0] else 'CUDA cores'}, {info[1]}-byte "
            f"copies: max_abs_err {err:.3e}, {used:.3f} of the allowance, "
            f"{'ok' if ok else 'MISMATCH'}, "
            f"{'same bits' if same else 'NOT REPRODUCIBLE'}")
    if round_kv or not bf16:
        state, _ = run_k3s(lib, k, v)
        split, _ = run_k3a(lib, q, *state, round_kv)
        whole, _ = run_k3(lib, q, k, v, round_kv)
        as_k3 = torch.equal(_int_view(split), _int_view(whole))
        text += ", K3s then K3a " + ("K3's bits" if as_k3
                                     else "NOT K3's BITS")
    tensor = bf16 and (round_kv or which == "k3s")
    if not (ok and same and as_k3 and bool(info[0]) == tensor):
        raise SystemExit(f"{which} {dtype} round_kv={round_kv} {case}: "
                         f"{text}")
    return text


# K1: (b, n, d, layout): the width the row-in-registers path is built for,
# another width, and a view whose rows are not 8-byte aligned (the generic
# loop at D = 1152); ragged N
K1_CASES = [(2, 37, 1152, "plain"), (1, 5, 1152, "plain"),
            (1, 77, 1000, "plain"), (2, 9, 1152, "unaligned"),
            (2, 9, 1536, "plain"), (1, 5, 1536, "plain"),
            (2, 9, 3072, "plain"), (1, 5, 3072, "plain"),
            (2, 9, 1024, "plain"), (1, 5, 256, "plain")]


def run_k1(lib, x, sc, sh):
    b, n, d = x.shape
    out = torch.empty((b, n, d), dtype=x.dtype)
    args = [x.data_ptr(), sc.data_ptr(), sh.data_ptr(), out.data_ptr(), b, n,
            d, x.stride(0), x.stride(1), sc.stride(0), sh.stride(0),
            out.stride(0), out.stride(1), 1e-6, DTYPE[x.dtype]]
    argtypes = [V] * 4 + [I] * 3 + [L] * 6 + [F, I, V]
    lib.yat_adaln_fwd.argtypes = argtypes
    lib.yat_adaln_fwd_info.argtypes = argtypes
    info = (ctypes.c_longlong * 5)()
    assert lib.yat_adaln_fwd_info(*args, ctypes.addressof(info)) == 0
    err = lib.yat_adaln_fwd(*args, None)
    assert err == 0, err
    return out, list(info)


def check_k1(lib, dtype, case):
    from yat_tpu_torch.ops import norm as N
    b, n, d, layout = case
    gen = torch.Generator().manual_seed(n + d)
    if layout == "unaligned":
        x = torch.randn((b, n, d + 1), generator=gen).to(dtype)[..., 1:]
    else:
        x = torch.randn((b, n, d), generator=gen).to(dtype)
    sc, sh = ((0.1 * torch.randn((b, d), generator=gen)).to(dtype)
              for _ in range(2))
    got, info = run_k1(lib, x, sc, sh)
    again, _ = run_k1(lib, x, sc, sh)
    want = N.adaln_ref(x, sc, sh)
    err, used, ok, _ = chip_smoke.compare("adaln_layernorm", got, want)
    same = torch.equal(got, again)
    text = (f"{'row in registers' if info[0] else 'generic loop'}: "
            f"max_abs_err {err:.3e}, {used:.3f} of the allowance, "
            f"{'ok' if ok else 'MISMATCH'}, "
            f"{'same bits' if same else 'NOT REPRODUCIBLE'}")
    if not (ok and same):
        raise SystemExit(f"k1 {dtype} {case}: {text}")
    return text


# K1b: (b, n, d, layout): the ring path's width, where every warp's ring
# wraps (on the 3-SM device a warp walks 2 to 32 rows), a batch element is
# cut into one to three blocks, and N = 17 at B = 1 leaves its last block
# one row; the generic loop (16-row blocks) at D = 1000 and on an
# unaligned D = 1152 view; B = 1 and 3
K1B_CASES = [(3, 256, 1152, "plain"), (1, 256, 1152, "plain"),
             (1, 100, 1152, "plain"), (3, 17, 1152, "plain"),
             (1, 17, 1152, "plain"), (3, 100, 1000, "plain"),
             (1, 17, 1000, "plain"), (3, 100, 1152, "unaligned"),
             (1, 17, 1152, "unaligned"), (3, 17, 1536, "plain"),
             (1, 100, 1536, "plain"), (3, 17, 3072, "plain"),
             (1, 100, 3072, "plain"), (3, 17, 1024, "plain"),
             (1, 100, 256, "plain")]


def run_k1b(lib, x, sc, g):
    """One K1b call: ((dx, dscale, dshift), the launch's path, the arrival
    counters after it)."""
    b, n, d = x.shape
    dx = torch.empty((b, n, d), dtype=x.dtype)
    dsc, dsh = torch.empty((2, b, d), dtype=x.dtype)
    lib.yat_adaln_bwd_chunks.argtypes = [I]
    partial = torch.full((b * lib.yat_adaln_bwd_chunks(n) * 2 * d,),
                         float("nan"))
    arrivals = torch.zeros(b, dtype=torch.int32)
    args = [x.data_ptr(), sc.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dsc.data_ptr(), dsh.data_ptr(), partial.data_ptr(),
            arrivals.data_ptr(), b, n, d, x.stride(0), x.stride(1),
            sc.stride(0), g.stride(0), g.stride(1), dx.stride(0),
            dx.stride(1), 1e-6, DTYPE[x.dtype]]
    argtypes = [V] * 8 + [I] * 3 + [L] * 7 + [F, I, V]
    lib.yat_adaln_bwd.argtypes = argtypes
    lib.yat_adaln_bwd_info.argtypes = argtypes
    info = (ctypes.c_longlong * 5)()
    assert lib.yat_adaln_bwd_info(*args, ctypes.addressof(info)) == 0
    err = lib.yat_adaln_bwd(*args, None)
    assert err == 0, err
    return (dx, dsc, dsh), info[0], arrivals


def check_k1b(lib, dtype, case):
    from yat_tpu_torch.ops import norm as N
    b, n, d, layout = case
    gen = torch.Generator().manual_seed(n + d + b)
    x = torch.randn((b, n, d + (layout == "unaligned")), generator=gen)
    x = x.to(dtype)[..., 1:] if layout == "unaligned" else x.to(dtype)
    sc = (0.1 * torch.randn((b, d), generator=gen)).to(dtype)
    g = torch.randn((b, n, d), generator=gen).to(dtype)
    got, ring, arrivals = run_k1b(lib, x, sc, g)
    again, _, _ = run_k1b(lib, x, sc, g)
    want = N.adaln_bwd_ref(x, sc, g)
    err, used, ok, _ = chip_smoke.compare("adaln_layernorm_bwd", got, want)
    same = all(torch.equal(u, v) for u, v in zip(got, again))
    reset = not bool(arrivals.any())
    path = "ring" if ring else "generic loop"
    text = (f"{path}: max_abs_err {err:.3e}, {used:.3f} of the allowance, "
            f"{'ok' if ok else 'MISMATCH'}, "
            f"{'same bits' if same else 'NOT REPRODUCIBLE'}, counters "
            + ("back at 0" if reset else "LEFT SET"))
    if dtype == torch.bfloat16:
        wrong, term = chip_smoke.WRONG_BWD["adaln_layernorm_bwd"]
        rejected = not chip_smoke.compare("adaln_layernorm_bwd",
                                          wrong(x, sc, g), want)[2]
        text += f", a backward without {term} " + (
            "rejected" if rejected else "ACCEPTED")
        ok = ok and rejected
    if not (ok and same and reset and ring == (d == 1152
                                              and layout == "plain")):
        raise SystemExit(f"k1b {dtype} {case}: {text}")
    return text


def main(argv):
    which = argv or list(SOURCES)
    libs = build([SOURCES[w] for w in which])
    for w in which:
        if w == "k3":
            for dtype, round_kv in K3_MODES:
                for case, nan in ([(c, False) for c in K3_CASES]
                                  + [(K3_CASES[1], True)]):
                    t0 = time.perf_counter()
                    text = check_k3(libs[SOURCES[w]], dtype, round_kv, case,
                                    nan)
                    print(f"k3 {str(dtype)[6:]} round_kv={int(round_kv)} "
                          f"{case}{' NaN' if nan else ''}: {text} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        if w in ("k3s", "k3a"):
            for dtype, round_kv in K3S_MODES:
                for case in K3S_CASES:
                    t0 = time.perf_counter()
                    text = check_k3s_k3a(libs[SOURCES[w]], w, dtype,
                                         round_kv, case)
                    print(f"{w} {str(dtype)[6:]} round_kv={int(round_kv)} "
                          f"{case}: {text} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        if w in ("k1", "k1b"):
            check_one, cases = ((check_k1, K1_CASES) if w == "k1"
                                else (check_k1b, K1B_CASES))
            for dtype in (torch.bfloat16, torch.float32):
                for case in cases:
                    t0 = time.perf_counter()
                    text = check_one(libs[SOURCES[w]], dtype, case)
                    print(f"{w} {str(dtype)[6:]} {case}: {text} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        if w in W8A8_CASES:
            for dtype in (torch.bfloat16, torch.float32):
                for case in W8A8_CASES[w]:
                    t0 = time.perf_counter()
                    text = check_w8a8(w, libs[SOURCES[w]], dtype, case)
                    print(f"{w} {str(dtype)[6:]} {case}: {text} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        fwd = w in ("fwd", "k2")
        for dtype in (torch.bfloat16, torch.float32):
            for case in (CASES + UNET_CASES + SD35_CASES + FLUX_CASES
                         + PIXELDIT_CASES + (FWD_CASES if fwd else [])):
                t0 = time.perf_counter()
                text = (check_fwd(w, libs[SOURCES[w]], dtype, case)
                        if fwd else check(w, libs[SOURCES[w]], dtype, case))
                if text is not None:
                    print(f"{w} {str(dtype)[6:]} {case}: {text} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
