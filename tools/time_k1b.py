#!/usr/bin/env python3
"""Time K1b's kernel-phase cases on another checkout's ``yat_tpu_torch``,
printing the ptxas lines of its backward entry functions, each case's
launch (where the checkout has ``adaln_bwd_launch_info``) and its share of
the tolerance without enforcing it: for design variants of K1b whose
output is wrong on purpose (a variant without the reduce across blocks,
timed to see what the reduce costs).

    python3 tools/time_k1b.py TREE LABEL

Cases, inputs and timing (``time_ms``, 50 calls twice) are this
checkout's ``chip_smoke.py``'s; bf16 at every K1b case, fp32 at the two
training shapes.  Run the variants and the parent in turns in one call.
Imports nothing of JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv):
    tree, label = str(Path(argv[0]).resolve()), argv[1]
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    cs.log = lambda m: print(f"[{label}] {m}", flush=True)
    cs.phase_device()
    sys.path.insert(0, tree)
    import torch

    from yat_tpu_torch.kernels import build as KB
    from yat_tpu_torch.ops import norm as N
    assert N.__file__.startswith(tree), N.__file__
    for text in KB.build(["adaln.cu"]).values():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = cs.entry_name(line.split("'")[1])
            elif ("Used" in line or "spill" in line) and "bwd" in entry:
                print(f"[{label}] {entry}: {line.strip()}")
    info_fn = getattr(N, "adaln_bwd_launch_info", None)
    for case in cs.kernel_cases(torch.device("cuda", 0)):
        name, lab, dtype, make, kern, plain, _, nbytes = case[:8]
        if name != "adaln_layernorm_bwd" or (
                dtype == torch.float32
                and lab not in ("train", "pixart-train")):
            continue
        args = make()
        _, used, ok, _ = cs.compare(name, kern(*args), plain(*args))
        path = cs.launch_text(info_fn(*args)) if info_fn else ""
        inputs = cs._rotations(make, nbytes)
        ms = [cs.time_ms(kern, inputs, 50) for _ in range(2)]
        print(f"[{label}] {lab} {str(dtype)[6:]}: kernel_ms {ms[0]:.4f} "
              f"{ms[1]:.4f} bound {nbytes / cs.HBM_BYTES_S * 1e3:.4f} used "
              f"{used:.3f} {'ok' if ok else 'MISMATCH'}; {path}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
