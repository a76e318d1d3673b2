#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``yat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) when it fails:

1. device: a CUDA device must be present; prints the card's name and power
   limit and turns TF32 off for fp32 matmuls and convolutions;
2. build: compiles every CUDA kernel of the port from
   ``yat_tpu_torch/csrc`` with nvcc (one process per source, in parallel);
3. kernels: holds each kernel (K1, K2, K3 forward; K1b, K2b backward)
   against its plain PyTorch version at the serving and training paths'
   shapes and at ragged shapes, in bf16 and fp32, and times the kernel, the
   plain version and (where one exists) one PyTorch call computing the same
   function, beside the least time the card could take;
4. reference: a two-block full-width SANA denoiser on the card against the
   same module on the CPU (the plain versions), fp32;
5. gradient reference: the same two blocks with LoRA (nonzero ``lora_b``),
   one flow-matching loss and every LoRA gradient on the card (kernels)
   against the CPU (plain versions), fp32, once the share of the ReLU
   kinks that fall on different sides of 0 on the two devices is counted
   and added; every gradient nonzero;
6. serve: the port's SANA-0.6B 512px server (Gemma-2-2B caption encoder,
   SANA-0.6B denoiser with CFG 5.0 and 20 flow-match Euler steps, fp32
   DC-AE decoder) with random weights from a seed, on 127.0.0.1: four
   concurrent /generate requests and one more; checks the images and that
   the kernels' launch counters rose by their per-denoiser-call counts;
   then one more batch of 4 under ``torch.profiler`` for the device time by
   layer and the device's idle share (after the counters are read);
7. train: SANA-0.6B 512px LoRA training through the port's entry point
   ``yat_tpu_torch.frontends.sana.main`` on a synthetic feature shard
   (batch 16, bf16, rank-8 LoRA on to_q/to_k/to_v/to_out, AdamW with
   warmup, EMA, caption-length buckets), 6 steps; checks the losses, the
   adapters and their export, and the launches per step; then one more
   step with remat (``low_vram``) on the same batch and draws, whose loss
   and gradients must equal the step without, and one step under
   ``torch.profiler``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s,
# bf16 tensor-core FLOP/s, fp32 (non-tensor) FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# tolerances |kernel - plain| <= atol + rtol * |plain|
TOL = {
    # bf16: one storage-type rounding step (2^-8 relative) flips where the
    # fp32 reductions sum in another order
    "bfloat16": {"adaln_layernorm": (2e-2, 2e-2),
                 "dot_product_attention": (2e-2, 2e-2),
                 "linear_attention": (2e-2, 2e-2)},
    # fp32: reduction order only
    "float32": {"adaln_layernorm": (1e-5, 1e-5),
                "dot_product_attention": (1e-4, 1e-4),
                "linear_attention": (1e-4, 1e-4)},
}
# backward kernels, each output against the plain backward.  bf16: rtol
# 2^-7 is one bf16 step of the element itself, where the stored result
# rounds the other way; atol (None here) is 2^-8 of that output's largest
# magnitude, for the fp32 sums run in another order and the dS entries that
# round the other way before the dq/dk products.  fp32: reduction order only
BWD_BF16_ATOL_SHARE = 2.0 ** -8
TOL["bfloat16"].update({"adaln_layernorm_bwd": (None, 2.0 ** -7),
                        "dot_product_attention_bwd": (None, 2.0 ** -7)})
TOL["float32"].update({"adaln_layernorm_bwd": (1e-4, 1e-4),
                       "dot_product_attention_bwd": (2e-4, 2e-4)})
# the gradient reference (fp32, TF32 off): every entry of every LoRA leaf's
# gradient within this share of the leaf's largest entry, once the share of
# the ReLU kinks that fell on different sides on the two devices is added
GRAD_REF_TOL = 1e-4
# the case of each kernel that is timed and reported: the main path's shape
MAIN_CASE = {"adaln_layernorm": "serve", "dot_product_attention": "serve",
             "linear_attention": "serve", "adaln_layernorm_bwd": "train",
             "dot_product_attention_bwd": "train-512"}

PROMPTS = ["a red fox in fresh snow", "a lighthouse at dusk",
           "a bowl of ramen on a wooden table", "a city street in the rain"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    if not os.path.isdir(os.path.join(REPO, "yat_tpu_torch")):
        fail(f"yat_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for fp32 matmuls and convolutions")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    import yat_tpu_torch.ops.attention  # noqa: F401  (registers K2, K2b, K3)
    import yat_tpu_torch.ops.norm  # noqa: F401  (registers K1, K1b)
    from yat_tpu_torch.kernels.build import KERNELS, build_all
    out = build_all()
    log(f"built {sorted({k.source for k in KERNELS.values()})} in "
        f"{out['seconds']:.1f} s")
    for source, text in out["logs"].items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {source}: {line.strip()}")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _rotations(make, nbytes):
    """Enough copies of one call's inputs that cycling through them reads
    about 100 MB, twice the 50 MB L2: each launch finds its inputs cold,
    as the serving path does."""
    return [make() for _ in range(max(2, min(16, math.ceil(100e6 / nbytes))))]


def time_ms(fn, inputs, iters, hold_cycles=50_000_000):
    """Device milliseconds of one call: CUDA events around ``iters`` calls.
    A spin kernel holds the stream while the host enqueues the calls, so
    they run back to back and the host's cost per launch (Python, checks,
    ctypes) stays out of the time; if the hold ran out before the last
    call was queued, it doubles and the measurement is repeated."""
    import torch
    for args in inputs * 2:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    if not held:
        if hold_cycles > 5_000_000_000:
            fail("the host could not queue the timed calls within a "
                 "seconds-long hold of the stream")
        return time_ms(fn, inputs, iters, 2 * hold_cycles)
    return start.elapsed_time(end) / iters


def compare(name, got, want):
    """Largest |kernel - plain| over every output, the largest share of its
    allowance ``atol + rtol * |plain|`` that any element uses (at most 1 to
    pass), whether all pass, and the tolerance as text."""
    import torch
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    atol, rtol = TOL[str(want[0].dtype).replace("torch.", "")][name]
    err_max, used, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        g, w = a.float(), b.float()
        err = (g - w).abs()
        limit = (BWD_BF16_ATOL_SHARE * float(w.abs().max()) if atol is None
                 else atol) + rtol * w.abs()
        ok = ok and bool(torch.isfinite(g).all())
        err_max = max(err_max, float(err.max()))
        used = max(used, float((err / limit.clamp_min(1e-30)).max()))
    text = (f"atol {BWD_BF16_ATOL_SHARE:g} x max|plain|" if atol is None
            else f"atol {atol:g}") + f", rtol {rtol:g}"
    return err_max, used, ok and used <= 1.0, text


def _mask(keep, nk, device):
    import torch
    idx = torch.arange(nk, device=device)[None, :]
    return (idx < torch.tensor(keep, device=device)[:, None]).to(torch.int32)


def kernel_cases(device):
    """(kernel name, case label, dtype, make_inputs, kernel_fn, plain_fn,
    library_fn, a (fwd+bwd, fwd) pair or None, bytes, flops) for every
    case; the first case of each kernel is its main path's shape
    (``MAIN_CASE``), timed in bf16."""
    import torch
    import torch.nn.functional as F

    from yat_tpu_torch.ops import attention as A
    from yat_tpu_torch.ops import norm as N

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)
                ).to(dtype)

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        # K1: serving shape x [8, 256, 1152], modulators [8, 1, 1152];
        # training shape x [16, 256, 1152]; ragged: one batch element,
        # N = 77 rows
        for label, (b, n, d) in (("serve", (8, 256, 1152)),
                                 ("train", (16, 256, 1152)),
                                 ("ragged", (1, 77, 1152))):
            def make(b=b, n=n, d=d, dtype=dtype):
                return (randn((b, n, d), dtype), randn((b, 1, d), dtype, 0.1),
                        randn((b, 1, d), dtype, 0.1))

            def plain(x, sc, sh):
                return N.adaln_ref(x, sc.reshape(sc.shape[0], -1),
                                   sh.reshape(sh.shape[0], -1))
            cases.append(("adaln_layernorm", label, dtype, make,
                          N.adaln_layernorm, plain, None,
                          es * (2 * b * n * d + 2 * b * d),
                          8 * b * n * d))
        # K2: serving shape q [8, 256, 16, 72], k/v [8, 512, 16, 72] with
        # caption masks (uncond keeps 1 key, cond ~150); training shape
        # q [16, 256, 16, 72], k/v [16, 512, 16, 72] with the training
        # shard's captions (100-500 of 512 keys kept); ragged: N_k = 300
        # keeping 1-300 keys with N_q = 100, and N_k = 16 without a mask
        for label, (b, nq, nk, h, d, keep) in (
                ("serve", (8, 256, 512, 16, 72,
                           [1, 1, 1, 1, 143, 151, 139, 160])),
                ("train-512", (16, 256, 512, 16, 72,
                               [100 + 400 * i // 15 for i in range(16)])),
                ("ragged-300", (4, 100, 300, 16, 72, [1, 37, 150, 300])),
                ("ragged-16", (2, 64, 16, 2, 32, None))):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                m = _mask(keep, nk, device) if keep is not None else None
                return (randn((b, nq, h, d), dtype), randn((b, nk, h, d), dtype),
                        randn((b, nk, h, d), dtype), m)

            def plain(q, k, v, m):
                return A.attention_ref(q, k, v, A._key_bias(m, q.shape[0]))

            def library(q, k, v, m):
                am = None if m is None else m.bool()[:, None, None, :]
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=am).transpose(1, 2)
            cases.append(("dot_product_attention", label, dtype, make,
                          A.dot_product_attention, plain, library,
                          es * b * h * d * (2 * nq + 2 * nk)
                          + (4 * b * nk if keep is not None else 0),
                          4 * b * h * nq * nk * d + 5 * b * h * nq * nk))
        # K3: serving shape q/k/v [8, 256, 36, 32], training shape
        # [16, 256, 36, 32]; ragged: N = 100.  At these lengths the JAX
        # package's einsum branch runs, which rounds the state to the
        # compute dtype (round_kv)
        for label, (b, n, h, d) in (("serve", (8, 256, 36, 32)),
                                    ("train", (16, 256, 36, 32)),
                                    ("ragged", (2, 100, 36, 32))):
            def make(b=b, n=n, h=h, d=d, dtype=dtype):
                return tuple(randn((b, n, h, d), dtype) for _ in range(3))

            def plain(q, k, v):
                return A.linear_attention_ref(
                    q, k, v, round_kv=A.kv_rounding(q.shape[1], q.shape[3]))
            cases.append(("linear_attention", label, dtype, make,
                          A.linear_attention, plain, None,
                          es * 4 * b * n * h * d,
                          b * h * (4 * n * d * d + 4 * n * d)))
        # K1b: training shape x, g [16, 256, 1152], scale [16, 1152];
        # ragged: one batch element, N = 100.  ~17 flops per element
        for label, (b, n, d) in (("train", (16, 256, 1152)),
                                 ("ragged", (1, 100, 1152))):
            def make(b=b, n=n, d=d, dtype=dtype):
                return (randn((b, n, d), dtype), randn((b, d), dtype, 0.1),
                        randn((b, n, d), dtype))

            def kern(x, sc, g):
                return N._adaln_bwd_cuda(x, sc, g, 1e-6)

            def plain(x, sc, g):
                return N.adaln_bwd_ref(x, sc, g, 1e-6)
            cases.append(("adaln_layernorm_bwd", label, dtype, make, kern,
                          plain, None, es * (3 * b * n * d + 3 * b * d),
                          17 * b * n * d))
        # K2b: training shapes q/g [16, 256, 16, 72], k/v [16, L, 16, 72]
        # at the caption rungs L = 512 (the training shard's 100-500 kept
        # keys) and 128 (100-115 kept); ragged: L = 300 keeping 1-300 keys,
        # and L = 16 unmasked
        for label, (b, nq, nk, h, d, keep) in (
                ("train-512", (16, 256, 512, 16, 72,
                               [100 + 400 * i // 15 for i in range(16)])),
                ("train-128", (16, 256, 128, 16, 72,
                               [100 + i for i in range(16)])),
                ("ragged-300", (4, 100, 300, 16, 72, [1, 37, 150, 300])),
                ("ragged-16", (2, 64, 16, 2, 32, None))):
            def make(b=b, nq=nq, nk=nk, h=h, d=d, keep=keep, dtype=dtype):
                m = _mask(keep, nk, device) if keep is not None else None
                return (randn((b, nq, h, d), dtype),
                        randn((b, nk, h, d), dtype),
                        randn((b, nk, h, d), dtype), A._key_bias(m, b),
                        randn((b, nq, h, d), dtype))
            # the library yardstick: SDPA forward+backward, minus its
            # forward (both with inputs that require grad)
            cases.append(("dot_product_attention_bwd", label, dtype, make,
                          A._attention_bwd_cuda, A.attention_bwd_ref,
                          (_sdpa_fwd_bwd, _sdpa_fwd),
                          es * b * h * d * (3 * nq + 4 * nk)
                          + (4 * b * nk if keep is not None else 0),
                          10 * b * h * nq * nk * d + 8 * b * h * nq * nk))
    return cases


def _sdpa(q, k, v, bias):
    import torch.nn.functional as F
    am = None if bias is None else (bias > -1.0)[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=am)


def _sdpa_fwd(q, k, v, bias, g):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return _sdpa(*leaves, bias)


def _sdpa_fwd_bwd(q, k, v, bias, g):
    import torch
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(_sdpa(*leaves, bias), leaves,
                               g.transpose(1, 2))


def attention_bwd_without_row_term(q, k, v, bias, g):
    """A wrong K2b, for checking that the bf16 tolerance catches it: the
    plain backward with ``dS = P dP``, the ``rowsum(dP P)`` term dropped."""
    import torch

    from yat_tpu_torch.ops import attention as A
    acc = torch.float32
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = A._probs(q, k, bias, acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(acc), v.to(acc))
    ds_c = (p * dp).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q.to(acc)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).to(acc), g.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def phase_kernels(device):
    import torch

    results = {}
    for (name, label, dtype, make, kern, plain, library, nbytes,
         flops) in kernel_cases(device):
        args = make()
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err, used, ok, tol = compare(name, got, want)
        dt = str(dtype).replace("torch.", "")
        log(f"{name} [{label}, {dt}] max_abs_err {err:.3e}, {used:.3f} of "
            f"the allowance ({tol}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} [{label}, {dt}] disagrees with its plain version")
        if name == "dot_product_attention_bwd" and dtype == torch.bfloat16:
            # the tolerance's power: a K2b without the row term must fail
            w_err, w_used, w_ok, _ = compare(
                name, attention_bwd_without_row_term(*args), want)
            log(f"{name} [{label}, {dt}] a K2b without rowsum(dP P): "
                f"max_abs_err {w_err:.3e}, {w_used:.1f} of the allowance "
                f"{'ACCEPTED' if w_ok else 'rejected'}")
            if w_ok:
                fail(f"{name} [{label}, {dt}]: the tolerance accepts a "
                     "backward without the row term")
        if label != MAIN_CASE[name] or dtype != torch.bfloat16:
            continue
        inputs = _rotations(make, nbytes)
        ms = time_ms(kern, inputs, 50)
        plain_ms = time_ms(plain, inputs, 20)
        if isinstance(library, tuple):
            lib_ms = time_ms(library[0], inputs, 50) - time_ms(
                library[1], inputs, 50)
        else:
            lib_ms = time_ms(library, inputs, 50) if library else None
        # K2's and K2b's products are tensor-core work on bf16 inputs; K1's,
        # K1b's and K3's arithmetic is fp32 whatever the storage type
        peak = (BF16_FLOPS if name.startswith("dot_product_attention")
                else FP32_FLOPS)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / peak * 1e3
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations",
                         "bytes": nbytes, "flops": flops}
        log(f"{name} [{label}, bf16] kernel_ms {ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}  bound_ms "
            f"{results[name]['bound_ms']:.4f} ({results[name]['bound_by']}:"
            f" {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return results


# ---------------------------------------------------------------------------
# 4. reference: the CUDA path against the CPU path on a small input
# ---------------------------------------------------------------------------

def phase_reference(device):
    import copy
    import dataclasses

    import torch

    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.models.sana import SANA_600M, SanaTransformer2D

    cfg = dataclasses.replace(SANA_600M, num_layers=2,
                              softmax_self_attn_blocks=(1,))
    cpu = SanaTransformer2D(cfg, dtype=torch.float32)
    init_params(cpu, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 16, cfg.in_channels), np.float32)
    emb = rng.standard_normal((2, 300, cfg.caption_channels), np.float32)
    mask = (np.arange(300)[None] < np.array([[1], [217]])).astype(np.int32)
    t = np.array([999.0, 412.5], np.float32)
    with torch.inference_mode():
        want = cpu(*(torch.from_numpy(a) for a in (lat, emb, t)),
                   torch.from_numpy(mask))
        got = gpu(*(torch.from_numpy(a).to(device) for a in (lat, emb, t)),
                  torch.from_numpy(mask).to(device)).cpu()
    err = float((got - want).abs().max())
    # fp32 throughout (TF32 off): reduction order only
    ok = bool(torch.isfinite(got).all()) and err <= 1e-3 + 1e-3 * float(
        want.abs().max())
    log(f"reference: 2-block full-width SANA (one softmax self-attention "
        f"block), CUDA vs CPU, fp32: max_abs_err {err:.3e} (tol 1e-3 + "
        f"1e-3 * max|ref|) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the CUDA denoiser disagrees with the CPU one")


# ---------------------------------------------------------------------------
# 5. gradient reference: LoRA gradients through the kernels against the CPU
# ---------------------------------------------------------------------------

LORA_TARGETS = ["to_q", "to_k", "to_v", "to_out"]


def phase_grad_reference(device):
    import copy
    import dataclasses

    import torch

    from yat_tpu_torch.adapters.builder import (
        AdapterSpec, adapted_modules, build_adapter_params, lora_parameters)
    from yat_tpu_torch.models.layers import init_params
    from yat_tpu_torch.models.sana import SANA_600M, SanaTransformer2D
    from yat_tpu_torch.ops.schedulers import FlowMatchSchedule
    from yat_tpu_torch.train.step import loss_and_grads
    from yat_tpu_torch.train.tasks import make_flow_matching_loss

    cfg = dataclasses.replace(SANA_600M, num_layers=2,
                              softmax_self_attn_blocks=(1,))
    cpu = SanaTransformer2D(cfg, dtype=torch.float32)
    init_params(cpu, torch.Generator().manual_seed(0))
    n = build_adapter_params(cpu, AdapterSpec("lora", rank=8, alpha=8,
                                              target_modules=LORA_TARGETS),
                             torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for _, m in adapted_modules(cpu):       # nonzero B: A gets gradients
            m.lora_b.normal_(0.0, 0.02, generator=gen)
    gpu = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 16, cfg.in_channels), np.float32)
    emb = rng.standard_normal((2, 300, cfg.caption_channels), np.float32)
    mask = (np.arange(300)[None] < np.array([[1], [217]])).astype(np.int32)
    sched = FlowMatchSchedule(shift=3.0)
    ts, sig = sched.training_draw(torch.Generator().manual_seed(3), 2)
    noise = rng.standard_normal(lat.shape, np.float32)
    results = []
    for model, dev in ((cpu, torch.device("cpu")), (gpu, device)):
        batch = {"latents": torch.from_numpy(lat).to(dev),
                 "embeddings": torch.from_numpy(emb).to(dev),
                 "text_mask": torch.from_numpy(mask).to(dev)}
        draws = {"timesteps": ts.to(dev), "sigmas": sig.to(dev),
                 "noise": torch.from_numpy(noise).to(dev)}
        leaves = [p for _, p in lora_parameters(model)]
        seen = {}
        hooks = _relu_input_hooks(model.blocks[0].attn1, seen)
        loss, grads = loss_and_grads(make_flow_matching_loss(model, sched),
                                     leaves, batch, torch.Generator(), draws)
        for h in hooks:
            h.remove()
        results.append((float(loss), [g.detach().cpu() for g in grads],
                        {k: {n: t.cpu() for n, t in v.items()}
                         for k, v in seen.items()}))
    (loss_c, grads_c, seen_c), (loss_g, grads_g, seen_g) = results
    names = [name for name, _ in lora_parameters(cpu)]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    # ReLU(q) and ReLU(k) of block 0's linear attention pass a gradient only
    # where the pre-activation is > 0.  A pre-activation within rounding of
    # 0 can fall on either side on the two devices; its whole gradient then
    # reaches to_q's (to_k's) leaves on one device only.  Each such flip is
    # counted, and its share of the leaves' gradients, s (xA)ᵀ Δg for B and
    # s xᵀ (Δg Bᵀ) for A with Δg the card's minus the CPU's gradient at the
    # flipped entries, is added to the CPU's gradients; then every entry of
    # every leaf must agree
    expected, flips = with_flips_share(cpu.blocks[0].attn1, "blocks_0.attn1",
                                       dict(zip(names, grads_c)), seen_c,
                                       seen_g)
    zero, rows, ok = [], [], loss_err <= 1e-4
    for name, gc, gg in zip(names, grads_c, grads_g):
        scale = float(gc.abs().max())
        raw = float((gg - gc).abs().max()) / scale
        fixed = float((gg.double() - expected[name]).abs().max()) / scale
        rows.append((fixed, raw, name, scale))
        ok = ok and fixed <= GRAD_REF_TOL and bool(torch.isfinite(gg).all())
        if not bool((gg != 0).any()):
            zero.append(name)
    for fixed, raw, name, scale in sorted(rows, key=lambda r: -r[1])[:3]:
        log(f"grad reference:   {name}: max|g| {scale:.3e}; max|dg|/max|g| "
            f"{raw:.2e} as measured, {fixed:.2e} with the flips' share")
    log(f"grad reference: 2-block full-width SANA with LoRA on {n} modules "
        f"({len(names)} leaves), CUDA vs CPU, fp32: loss {loss_g:.6f} vs "
        f"{loss_c:.6f} (rel {loss_err:.2e}, tol 1e-4); ReLU kinks flipped "
        f"between the devices in block 0's linear attention: "
        f"{flips.get('to_q', 0)} of q, {flips.get('to_k', 0)} of k; worst "
        f"leaf max|dg|/max|g| {max(r[1] for r in rows):.2e} as measured, "
        f"{max(r[0] for r in rows):.2e} with the flips' share (tol "
        f"{GRAD_REF_TOL:g}); zero gradients on the card: {len(zero)}")
    if zero:
        fail(f"LoRA leaves with no gradient on the card: {zero[:4]}")
    if not ok:
        fail("LoRA gradients on the card disagree with the CPU")


def with_flips_share(attn, path, grads, seen_a, seen_b):
    """``grads`` (name → the LoRA gradients of run a), in fp64, plus the
    share of the ReLU kinks of the linear attention ``attn`` (named
    ``path``) that fall on the other side in run b: for each of to_q and
    to_k, Δg is b's minus a's gradient at the entries whose pre-activation
    is > 0 in one run only, and A gains ``s xᵀ (Δg Bᵀ)``, B gains
    ``s (xA)ᵀ Δg``.  Returns those gradients and the flips per
    projection."""
    import torch
    out = {name: g.detach().double() for name, g in grads.items()}
    flips = {}
    for proj, a_run in seen_a.items():
        b_run = seen_b[proj]
        flip = (a_run["y"] > 0) != (b_run["y"] > 0)
        flips[proj] = int(flip.sum())
        dg = torch.where(flip, b_run["g"] - a_run["g"], 0.0).double()
        dg = dg.reshape(-1, dg.shape[-1])
        x = a_run["x"].double().reshape(-1, a_run["x"].shape[-1])
        m = getattr(attn, proj)
        a, b = m.lora_a.detach().double(), m.lora_b.detach().double()
        out[f"{path}.{proj}.lora_a"] += m.lora_scale * x.t() @ (dg @ b.t())
        out[f"{path}.{proj}.lora_b"] += m.lora_scale * (x @ a).t() @ dg
    return out, flips


def _relu_input_hooks(attn, seen):
    """Hooks that keep, for the linear attention ``attn``'s to_q and to_k,
    the input, the output (the pre-activation of ReLU(q), ReLU(k)) and the
    loss's gradient with respect to that output."""
    def keep(proj):
        def hook(module, inputs, out):
            seen[proj] = {"x": inputs[0].detach(), "y": out.detach()}
            out.register_hook(
                lambda g: seen[proj].__setitem__("g", g.detach()))
        return hook
    return [getattr(attn, p).register_forward_hook(keep(p))
            for p in ("to_q", "to_k")]


# ---------------------------------------------------------------------------
# 6. serve
# ---------------------------------------------------------------------------

def png_shape(body: bytes, ctype: str):
    """(H, W, C) of a PNG from its IHDR chunk, or of a raw .npy body."""
    if ctype == "application/x-npy":
        import io
        return np.load(io.BytesIO(body)).shape
    if body[:8] != b"\x89PNG\r\n\x1a\n" or body[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", body[16:26])
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}")
    return (h, w, channels)


def _post(port, prompt, out, i):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt": prompt}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=900) as resp:
        out[i] = (resp.status, resp.headers["Content-Type"], resp.read())


def serve_params(**extra):
    """The serving configuration: SANA-0.6B 512px defaults, bf16, random
    weights from dataset_seed 0."""
    from yat_tpu_torch.config import TrainingParameters
    return TrainingParameters.from_dict({
        "batch_size": "1", "learning_rate": "1e-4", "steps": "1",
        "num_steps_per_validation": "1", "bfloat16": "true",
        "dataset_seed": "0", **extra})


def phase_serve(params, device, card, px=512, profile=False):
    import torch

    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.serve import build_sampler, make_server

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    # the window only has to cover the arrival of 4 concurrent requests
    sampler = build_sampler(params, "sana", max_batch=4,
                            batch_window_ms=100.0, device=device)
    vp = sampler.pipeline
    cfg = vp.model.cfg
    if cuda:
        torch.cuda.synchronize()
    log(f"serve: built the SANA denoiser, Gemma-2 encoder and DC-AE "
        f"decoder ({cfg.hidden_dim}-wide, {cfg.num_layers} blocks) with "
        f"random weights in {time.perf_counter() - t0:.1f} s")
    server = make_server(sampler, host="127.0.0.1", port=0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        t0 = time.perf_counter()
        sampler.warmup()
        log(f"serve: warm-up (batch 4 + batch 1) "
            f"{time.perf_counter() - t0:.2f} s")

        seen = []

        def recording(prompts):
            out = vp(prompts)
            seen.append(out)
            return out
        sampler.pipeline = recording

        batches0 = sampler.stats["batches"]
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        # main path: 4 concurrent requests, then 1 more
        results = [None] * 5
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_post,
                                    args=(port, PROMPTS[i], results, i))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        _post(port, PROMPTS[0], results, 4)
        t1 = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        batches = sampler.stats["batches"] - batches0
        if profile:
            profile_batch(vp, card)
    finally:
        server.shutdown()
        server.server_close()
        sampler.stop()

    for i, r in enumerate(results):
        if r is None or r[0] != 200:
            fail(f"request {i} failed: {r and r[0]}")
        shape = png_shape(r[2], r[1])
        if shape != (px, px, 3):
            fail(f"request {i}: image {shape}, expected {(px, px, 3)}")
    floats = [img for out in seen for img in out.values()]
    if len(floats) != 5:
        fail(f"expected 5 sampled images, got {len(floats)}")
    for img in floats:
        if img.shape != (px, px, 3) or not np.isfinite(img).all():
            fail(f"image {img.shape} not finite / not {px}x{px}x3")
    first = {k.split("/", 2)[2]: v for k, v in seen[0].items()}
    again = next(iter(seen[-1].values()))
    diff = float(np.abs(first[PROMPTS[0]] - again).max())
    # the same prompt and seed, sampled in a batch of 4 and alone: the
    # kernels are batch-invariant, the library GEMMs may round differently
    # at another batch size
    log(f"serve: repeated prompt max |diff| {diff:.3e} (tol 2e-2)")
    if diff > 2e-2:
        fail("the repeated prompt did not reproduce its image")
    if batches != 2:
        fail(f"expected 2 batches (4 coalesced + 1), got {batches}")

    n_soft = len(cfg.softmax_self_attn_blocks)
    per_call = {"adaln_layernorm": 2 * cfg.num_layers + 1,
                "dot_product_attention": cfg.num_layers + n_soft,
                "linear_attention": cfg.num_layers - n_soft}
    calls = batches * vp.num_steps
    for name, n in per_call.items():
        want = n * calls if cuda else 0
        log(f"serve: {name} launches {counts[name]} (expected {n} per "
            f"denoiser call x {calls} calls = {want})")
        if counts[name] != want:
            fail(f"{name}: {counts[name]} launches, expected {want}")
    log(f"serve [{card}]: batch of 4 in {t4:.3f} s ({4 / t4:.3f} images/s), "
        f"batch of 1 in {t1:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB; {vp.num_steps} steps, CFG "
        f"{vp.guidance_scale}")
    return {name: counts[name] for name in per_call}


# kernel-name fragments → the layer they belong to
KERNEL_FAMILIES = (
    ("K1 adaln_layernorm", ("adaln_fwd",)),
    ("K1b adaln_layernorm_bwd", ("adaln_bwd",)),
    ("K2 dot_product_attention", ("attention_fwd_bf16", "attention_fwd_f32")),
    ("K2b dot_product_attention_bwd", ("attention_bwd_dq",
                                       "attention_bwd_dkdv")),
    ("K3 linear_attention", ("linear_attention_fwd",)),
    # convolutions first: cuDNN's implicit-GEMM kernels carry "gemm" too
    ("convolution (cuDNN)", ("conv", "cudnn", "depthwise", "implicit",
                             "fprop")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
)


def profile_batch(vp, card):
    """One batch of 4 prompts under torch.profiler."""
    profile_run("batch of 4", lambda: vp(PROMPTS), card)


def profile_run(label, fn, card):
    """``fn()`` under torch.profiler: device time by layer and by kernel,
    and the share of the wall time the device sat idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):                 # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"profile [{card}]: {label} in {wall_us / 1e3:.1f} ms (profiler "
        f"on), device busy {busy / 1e3:.1f} ms, idle share "
        f"{1 - busy / wall_us:.3f}")
    families = {}
    for name, (n, t) in by_name.items():
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(k in name.lower() for k in keys)), "other")
        c, tt = families.get(fam, (0, 0.0))
        families[fam] = (c + n, tt + t)
    for fam, (n, t) in sorted(families.items(), key=lambda x: -x[1][1]):
        log(f"profile:   {fam:28s} {t / 1e3:9.2f} ms  {n:6d} launches  "
            f"{t / busy:.3f} of busy")
    for name, (n, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:12]:
        log(f"profile:     {t / 1e3:9.2f} ms {n:6d}x  {name[:90]}")


# ---------------------------------------------------------------------------
# 7. train
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6


def write_train_shard(path, n=48, latent=(16, 16, 32), dim=2304,
                      lengths=(100, 500), seed=0):
    """``n`` feature samples, by default SANA-0.6B 512px ones: ratio "1.0",
    latents [16, 16, 32] fp32, caption embeddings [L_i, 2304] fp32 with L_i
    spread over 100-500 tokens."""
    from yat_tpu_torch.data.tar import TarShardWriter
    rng = np.random.default_rng(seed)
    ls = rng.permutation(np.linspace(*lengths, n).round().astype(int))
    with TarShardWriter(path) as w:
        for i, length in enumerate(ls):
            w.write({"__key__": f"{i:06d}", "ratio": "1.0",
                     "latent.npy": rng.standard_normal(latent,
                                                       dtype=np.float32),
                     "emb.npy": rng.standard_normal((int(length), dim),
                                                    dtype=np.float32)})


def train_config(shard, out_dir, **extra):
    """configs/sana_512_lora.yaml without what needs files (pretrained
    weights, checkpoints, validation prompts, the TPU mesh) and without
    caption dropout, for ``TRAIN_STEPS`` steps."""
    cfg = {"local_shard_paths": [shard], "batch_size": "16",
           "learning_rate": "1e-4", "steps": str(TRAIN_STEPS),
           "warmup_steps": "2", "num_steps_per_validation": "500",
           "validation_prompts": [], "bfloat16": "true", "use_ema": "true",
           "gradient_accumulation_steps": "1",
           "train_unconditional_prob": "0", "lora_rank": "8",
           "lora_alpha": "8", "lora_algo": "lora",
           "lora_target_modules": LORA_TARGETS,
           "caption_length_bucketing": "true", "output_dir": out_dir,
           "dataset_seed": "0", **extra}
    return cfg


def phase_train(device, card, shard_args=None, cfg_extra=None):
    """The training main path through the entry point; returns the launch
    counts of its run.  ``shard_args``/``cfg_extra`` shrink it for a
    rehearsal on the CPU."""
    import torch
    import yaml

    from yat_tpu_torch.adapters.builder import adapted_modules, lora_parameters
    from yat_tpu_torch.adapters.io import read_safetensors
    from yat_tpu_torch.frontends.sana import main as train_main
    from yat_tpu_torch.kernels.build import launch_counts, reset_launch_counts
    from yat_tpu_torch.train.step import loss_and_grads

    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "shard-000000.tar")
        t0 = time.perf_counter()
        write_train_shard(shard, **(shard_args or {}))
        cfg = {k: v for k, v in train_config(
            shard, os.path.join(tmp, "out"), **(cfg_extra or {})).items()
            if v is not None}              # None drops a key
        cfg_path = os.path.join(tmp, "config.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        log(f"train: wrote a {os.path.getsize(shard) / 1e6:.1f} MB feature "
            f"shard in {time.perf_counter() - t0:.1f} s")

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        # main path: the entry point, as a user runs it
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg_path, "--device", device.type])
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() if cuda else 0

        steps = int(cfg["steps"])
        hist = trainer.history
        model = trainer.model
        adapted = adapted_modules(model)
        for h in hist:
            log(f"train: step {h['step']} caption rung {h['caption_len']} "
                f"loss {h['loss']:.6f} grad_norm {h['grad_norm']:.4f} "
                f"lr {h['lr']:.3g}")
        if len(hist) != steps or not all(
                math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist):
            fail(f"train: expected {steps} finite losses, got {hist}")
        if hist[0]["lr"] != 0.0 or hist[1]["lr"] <= 0.0:
            fail("train: warmup should give lr 0 on the first update only")
        cfg_model = trainer.sana_config
        # to_q/to_k/to_v/to_out of attn1 and attn2 in every block: 224
        if len(adapted) != 8 * cfg_model.num_layers:
            fail(f"train: {len(adapted)} adapted modules, expected "
                 f"{8 * cfg_model.num_layers}")
        zero_b = [".".join(p) for p, m in adapted
                  if not bool((m.lora_b != 0).any())]
        if zero_b:
            fail(f"train: lora_b still zero after the updates: {zero_b[:4]}")
        path = os.path.join(cfg["output_dir"], str(steps),
                            "adapter_model.safetensors")
        tensors, meta = read_safetensors(path)
        if len(tensors) != 2 * len(adapted) or "yat_meta" not in meta:
            fail(f"train: adapter file holds {len(tensors)} tensors, "
                 f"expected {2 * len(adapted)}")
        for name, p in lora_parameters(model):
            dotted, leaf = name.rsplit(".", 1)
            key = (f"base_model.model.{dotted}."
                   f"{'lora_A' if leaf == 'lora_a' else 'lora_B'}.weight")
            if not np.array_equal(tensors[key],
                                  p.detach().float().cpu().numpy().T):
                fail(f"train: exported {key} differs from the live leaf")
        log(f"train: {len(adapted)} adapted modules; adapter export "
            f"{os.path.basename(path)} holds {len(tensors)} tensors")

        n_layers = cfg_model.num_layers
        n_soft = len(cfg_model.softmax_self_attn_blocks)
        # launches per step; the first norm of block 0 gets no backward:
        # its input and modulation come from the frozen patch and timestep
        # embeddings, so no trainable leaf lies upstream of it
        per_step = {"adaln_layernorm": 2 * n_layers + 1,
                    "dot_product_attention": n_layers + n_soft,
                    "linear_attention": n_layers - n_soft,
                    "adaln_layernorm_bwd": 2 * n_layers,
                    "dot_product_attention_bwd": n_layers + n_soft}
        # launches inside the blocks, which remat runs twice
        in_blocks = {"adaln_layernorm": 2 * n_layers,
                     "dot_product_attention": n_layers + n_soft,
                     "linear_attention": n_layers - n_soft}
        for name, n in per_step.items():
            want = n * steps if cuda else 0
            log(f"train: {name} launches {counts[name]} (expected {n} per "
                f"step x {steps} steps = {want})")
            if counts[name] != want:
                fail(f"train: {name}: {counts[name]} launches, expected "
                     f"{want}")
        times = trainer._step_times[1:]
        step_s = sum(times) / len(times)
        log(f"train [{card}]: {steps} steps in {wall:.2f} s through the "
            f"entry point (shard read included); steps 2-{steps}: "
            f"{step_s:.4f} s a step, {1 / step_s:.3f} steps/s, "
            f"{trainer.params.batch_size / step_s:.2f} images/s; first "
            f"step {trainer._step_times[0]:.3f} s; peak device memory "
            f"{peak / 2**30:.2f} GiB")

        # one more step with remat (low_vram), on one batch and one set of
        # draws, against the step without: the same loss and gradients
        gen = torch.Generator(device=device).manual_seed(5)
        b, rung = trainer.params.batch_size, cfg_model.max_caption_len
        lat_dtype = torch.bfloat16 if trainer.params.bfloat16 else torch.float32
        batch = {
            "latents": torch.randn((b, cfg_model.sample_size,
                                    cfg_model.sample_size,
                                    cfg_model.in_channels), generator=gen,
                                   device=device).to(lat_dtype),
            "embeddings": torch.randn((b, rung, cfg_model.caption_channels),
                                      generator=gen, device=device),
            "text_mask": (torch.arange(rung, device=device)[None]
                          < torch.tensor([rung - i * rung // (4 * b)
                                          for i in range(b)],
                                         device=device)[:, None]
                          ).to(torch.int32)}
        ts, sig = trainer.schedule.training_draw(gen, b)
        draws = {"timesteps": ts, "sigmas": sig,
                 "noise": torch.randn(batch["latents"].shape, generator=gen,
                                      device=device)}
        leaves = [p for _, p in lora_parameters(model)]
        runs = {}
        for remat in (False, True):
            model.gradient_checkpointing = remat
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(trainer.task_loss, leaves, batch,
                                         gen, draws)
            if cuda:
                torch.cuda.synchronize()
            runs[remat] = (loss, grads, launch_counts(),
                           time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated() if cuda else 0)
        model.gradient_checkpointing = False
        (l0, g0, c0, t_0, m0), (l1, g1, c1, t_1, m1) = runs[False], runs[True]
        same = bool(torch.equal(l0, l1)) and all(
            bool(torch.equal(a, c)) for a, c in zip(g0, g1))
        worst = max(float((a.float() - c.float()).abs().max()) for a, c in
                    zip(g0, g1))
        log(f"train: remat step loss {float(l1):.6f} vs {float(l0):.6f}, "
            f"largest gradient difference {worst:.3e}: "
            f"{'bit-identical' if same else 'DIFFERENT'}; forward launches "
            f"{c1['adaln_layernorm']}/{c1['dot_product_attention']}/"
            f"{c1['linear_attention']} vs {c0['adaln_layernorm']}/"
            f"{c0['dot_product_attention']}/{c0['linear_attention']}, "
            f"backward {c1['adaln_layernorm_bwd']}/"
            f"{c1['dot_product_attention_bwd']}")
        log(f"train [{card}]: loss and gradients of one step at rung {rung}: "
            f"{t_0:.3f} s and peak {m0 / 2**30:.2f} GiB without remat, "
            f"{t_1:.3f} s and peak {m1 / 2**30:.2f} GiB with remat")
        if not same:
            fail("train: the remat step's loss or gradients differ")
        for name, n in in_blocks.items():
            want = c0[name] + (n if cuda else 0)
            if c1[name] != want:
                fail(f"train: remat forward launches of {name}: {c1[name]},"
                     f" expected {want}")
        for name in ("adaln_layernorm_bwd", "dot_product_attention_bwd"):
            if c1[name] != c0[name]:
                fail(f"train: remat backward launches of {name} changed")
        if cuda:
            profile_run(f"one training step at rung {rung}",
                        lambda: trainer._step_fn(batch, gen, draws), card)
    return {name: counts[name] for name in per_step}


def main() -> None:
    card = phase_device()
    import torch
    device = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(device)
    phase_reference(device)
    phase_grad_reference(device)
    serve_counts = phase_serve(serve_params(), device, card, profile=True)
    torch.cuda.empty_cache()
    train_counts = phase_train(device, card)

    rows = []
    meta = {"adaln_layernorm": ("yat_tpu_torch/csrc/adaln.cu",
                                "yat_tpu/ops/norm.py:111"),
            "adaln_layernorm_bwd": ("yat_tpu_torch/csrc/adaln.cu",
                                    "yat_tpu/ops/norm.py:132"),
            "dot_product_attention": ("yat_tpu_torch/csrc/softmax_attention.cu",
                                      "yat_tpu/ops/attention.py:311"),
            "dot_product_attention_bwd": (
                "yat_tpu_torch/csrc/softmax_attention_bwd.cu",
                "yat_tpu/ops/attention.py:334"),
            "linear_attention": ("yat_tpu_torch/csrc/linear_attention.cu",
                                 "yat_tpu/ops/attention.py:424")}
    for name, (source, replaces) in meta.items():
        k = kernels[name]
        # launches: the serving path's run for the forward kernels (each
        # also launches in the training run: launches_train), the training
        # path's run for the backward kernels
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": serve_counts.get(name, train_counts[name]),
                     "launches_train": train_counts[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
