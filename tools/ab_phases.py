#!/usr/bin/env python3
"""Run this checkout's ``chip_smoke.py`` phases against another checkout's
``yat_tpu_torch`` on the card: the kernel phase of the attention forwards
(K2, K4 and K6), of K1 (the adaLN forward) and of K3, K3s and K3a (the
ReLU linear attention and its halves for token-sharded blocks; every K1,
K3, K3s and K3a case timed, and a digest of K3's outputs), the kernel phase of K1b (``k1b``,
the adaLN backward: every case timed beside LayerNorm's fused backward,
the host's time a call at the main case), the kernel phase of K3, K3s and
K3a alone (``k3``, with K3's digest), the kernel phase of K5 and K5b
(the w8a8 matmul and its backward: bit equality, the main case's times
and yardsticks), the serve phase of SANA-0.6B and PixArt-Sigma XL-2 at
512px (random weights from a seed, five requests over HTTP and one
profiled batch of 4), the SANA-0.6B LoRA training phase on a bf16 base
(``train``) and on an int8 base with w8a8 (``int8``), and the
PixArt-Sigma XL-2 LoRA training phase (``pixart-train``; six steps, a
remat step and a profiled step each) and the PixelDiT training phase
(``pixeldit-train``: ``configs/pixeldit_repa.yaml`` on its 4-bit base at
the phase's depth cut, with its resident base bytes).  Each serve phase then times five
more batches of 4 straight through the pipeline.

    python3 tools/ab_phases.py TREE [kernels] [k1b] [k3] [w8a8] [sana] [pixart]
                                    [train] [int8] [pixart-train]
                                    [pixeldit-train]

TREE is the root of the checkout whose package runs; the cases, the
tolerance and the timing are this checkout's, so two checkouts run the
same cases.  The kernel phase's check that fully masked key tiles go
unread is left to ``chip_smoke.py`` itself: a checkout from before the
tile walk reads them.  So is K3's NaN case where TREE's K3 predates its
launch info (``linear_attention_launch_info``), as it predates the ReLU
that keeps NaN, and the check that K3s then K3a give K3's bits where
TREE's K3s and K3a predate their launch info
(``linear_attention_state_launch_info``): those sum on the CUDA cores in
another order than K3.  K1b's path is printed where TREE has its launch info
(``adaln_bwd_launch_info``).  The SANA training phases write
checkpoints (``checkpoint_dir``), so TREE's trainer must take that key
(a checkout with ``yat_tpu_torch/train/checkpoint.py``).  To compare two
checkouts on one card, run them in turns in one call: parent, change,
change, parent.  Imports
nothing of JAX.
"""

from __future__ import annotations

import gc
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FORWARDS = ("dot_product_attention", "dot_product_attention_folded",
            "flash_attention", "adaln_layernorm", "linear_attention",
            "linear_attention_state", "linear_attention_apply")


def has_symbol(kernel, symbol):
    """Whether TREE's library of ``kernel`` (a ``CudaKernel``) exports
    ``symbol``."""
    try:
        kernel.function(symbol, [])
    except AttributeError:
        return False
    return True


def timed_batches(cs, family, vp, card, n=5):
    """``n`` batches of 4 straight through the pipeline (no HTTP), each
    timed to its images on the host: the batch latency with the server's
    queue taken out."""
    import statistics
    import time

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        vp(cs.PROMPTS)
        times.append(time.perf_counter() - t0)
    cs.log(f"serve {family} [{card}]: {n} batches of 4 through the "
           f"pipeline in {', '.join(f'{t:.3f}' for t in times)} s; median "
           f"{statistics.median(times):.3f} s")


def k3_digests(cs, device):
    """A sha256 of K3's outputs on seeded inputs at the serving, ragged and
    head-dim-64 shapes, each dtype and implementation: equal digests on two
    checkouts mean equal bits."""
    import hashlib

    import torch

    from yat_tpu_torch.ops import attention as A
    for dtype in (torch.bfloat16, torch.float32):
        for impl in ("auto", "pallas"):
            gen = torch.Generator(device=device).manual_seed(7)
            h = hashlib.sha256()
            for shape in ((8, 256, 36, 32), (2, 100, 36, 32),
                          (8, 256, 18, 64)):
                q, k, v = (torch.randn(shape, generator=gen, device=device)
                           .to(dtype) for _ in range(3))
                out = A.linear_attention(q, k, v, implementation=impl)
                h.update(out.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32).cpu().numpy().tobytes())
            cs.log(f"linear_attention {str(dtype)[6:]} {impl} outputs: "
                   f"sha256 {h.hexdigest()[:16]}")


def main(argv):
    tree = Path(argv[0]).resolve()
    phases = argv[1:] or ["kernels", "k1b", "w8a8", "sana", "pixart",
                          "train", "int8", "pixart-train", "pixeldit-train"]
    spec = importlib.util.spec_from_file_location("chip_smoke_cases",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = cs.phase_device()  # puts this checkout on sys.path; TREE goes first
    sys.path.insert(0, str(tree))
    import torch

    from yat_tpu_torch.ops import attention
    assert Path(attention.__file__).is_relative_to(tree), attention.__file__
    device = torch.device("cuda", 0)
    cs.log(f"phases {phases} of {tree}")
    # every kernel of TREE built first, so that no phase times a build
    import yat_tpu_torch.ops.norm  # noqa: F401  (registers K1, K1b)
    import yat_tpu_torch.ops.quant  # noqa: F401  (registers K5, K5b)
    from yat_tpu_torch.kernels.build import build_all
    cs.log(f"TREE's kernels built in {build_all()['seconds']:.1f} s")
    if not hasattr(attention, "linear_attention_state_launch_info"):
        # K3s and K3a from before their redesign: no launch info, and
        # CUDA-core sums that are not K3's (the split's bit check is this
        # checkout's alone)
        attention.linear_attention_state_launch_info = (
            lambda *args: None)
        attention.linear_attention_apply_launch_info = (
            lambda *args: None)
        launch_text = cs.launch_text
        cs.launch_text = (lambda info: "no launch info in TREE"
                          if info is None else launch_text(info))
        cs.check_k3_split_bits = lambda device: None
    if "kernels" in phases:
        cs.FWD_SKIP = {}
        skip = () if hasattr(attention, "linear_attention_launch_info") \
            else ("nan",)
        cs.phase_kernels(device, names=FORWARDS, skip_labels=skip)
        k3_digests(cs, device)
    if "k1b" in phases:
        cs.phase_kernels(device, names=("adaln_layernorm_bwd",))
    if "k3" in phases:
        cs.phase_kernels(device, names=FORWARDS[-3:])
        k3_digests(cs, device)
    if "w8a8" in phases:
        from yat_tpu_torch.ops import quant
        if not has_symbol(quant.W8A8_MATMUL, "yat_w8a8_launch_info"):
            # a library from before the launch info: nothing to print
            cs.w8a8_launch_info = lambda *args: None
            cs.w8a8_info_text = lambda info: "no launch info in this library"
        cs.phase_w8a8_kernels(device)
    for family in ("sana", "pixart"):
        if family in phases:
            cs.phase_serve(cs.serve_params(), device, card, family=family,
                           profile=True,
                           after=lambda vp, f=family: timed_batches(
                               cs, f, vp, card))
            gc.collect()
            torch.cuda.empty_cache()
    if "train" in phases:
        cs.phase_train(device, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "int8" in phases:
        cs.phase_train(device, card, cfg_extra=cs.INT8_KEYS,
                       label="int8 train")
        gc.collect()
        torch.cuda.empty_cache()
    if "pixart-train" in phases:
        cs.phase_pixart_train(device, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "pixeldit-train" in phases:
        from yat_tpu_torch.models.layers import AdapterDense
        if not hasattr(AdapterDense, "payload_values"):
            # a 4-bit base held one value a byte: its resident bytes only
            from yat_tpu_torch.parallel.mesh import frozen_bytes
            AdapterDense.payload_values = lambda self: self.qweight
            cs.log_4bit_base = lambda label, trainer, card: cs.log(
                f"{label} [{card}]: resident frozen base "
                f"{frozen_bytes(trainer.model) / 2**20:.2f} MiB (one value "
                "a byte)")
        cs.phase_pixeldit_train(device, card)


if __name__ == "__main__":
    main(sys.argv[1:])
