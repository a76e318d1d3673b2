#!/usr/bin/env python3
"""Run this checkout's ``chip_smoke.py`` phases against another checkout's
``yat_tpu_torch`` on the card: the kernel phase of the attention forwards
(K2, K4 and K6), of K1 (the adaLN forward) and of K3 (the ReLU linear
attention; every K1 and K3 case timed), the kernel phase of K1b (``k1b``,
the adaLN backward: every case timed beside LayerNorm's fused backward,
the host's time a call at the main case), the kernel phase of K5 and K5b
(the w8a8 matmul and its backward: bit equality, the main case's times
and yardsticks), the serve phase of SANA-0.6B and PixArt-Sigma XL-2 at
512px (random weights from a seed, five requests over HTTP and one
profiled batch of 4), the SANA-0.6B LoRA training phase on a bf16 base
(``train``) and on an int8 base with w8a8 (``int8``), and the
PixArt-Sigma XL-2 LoRA training phase (``pixart-train``; six steps, a
remat step and a profiled step each).  Each serve phase then times five
more batches of 4 straight through the pipeline.

    python3 tools/ab_phases.py TREE [kernels] [k1b] [w8a8] [sana] [pixart]
                                    [train] [int8] [pixart-train]

TREE is the root of the checkout whose package runs; the cases, the
tolerance and the timing are this checkout's, so two checkouts run the
same cases.  The kernel phase's check that fully masked key tiles go
unread is left to ``chip_smoke.py`` itself: a checkout from before the
tile walk reads them.  So is K3's NaN case where TREE's K3 predates its
launch info (``linear_attention_launch_info``), as it predates the ReLU
that keeps NaN.  K1b's path is printed where TREE has its launch info
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
            "flash_attention", "adaln_layernorm", "linear_attention")


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


def main(argv):
    tree = Path(argv[0]).resolve()
    phases = argv[1:] or ["kernels", "k1b", "w8a8", "sana", "pixart",
                          "train", "int8", "pixart-train"]
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
    if "kernels" in phases:
        cs.FWD_SKIP = {}
        skip = () if hasattr(attention, "linear_attention_launch_info") \
            else ("nan",)
        cs.phase_kernels(device, names=FORWARDS, skip_labels=skip)
    if "k1b" in phases:
        cs.phase_kernels(device, names=("adaln_layernorm_bwd",))
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


if __name__ == "__main__":
    main(sys.argv[1:])
