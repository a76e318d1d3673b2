"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take ``cuda``, and they raise when it is absent instead
of carrying on elsewhere.  On the card, fp32 math stays fp32: TF32 is off
for matmuls and for cuDNN's convolutions (PyTorch leaves it on for the
convolutions by default), so the fp32 VAE encoders and decoders compute
as the JAX package's do.  The flags are process-wide: threads such as
the feature cache's share them.

Under more than one process (``torch.distributed``, one process a card)
``cuda`` names this process's card, ``cuda:{LOCAL_RANK}``; where
processes share cards (more local processes than cards) it is
``cuda:{LOCAL_RANK % cards}``, so ``cuda:0`` when they share one.  The
card becomes the process's current device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA device must exist, else RuntimeError.
    For ``cuda``, TF32 goes off for fp32 matmuls and convolutions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or "
                "--device cpu) to run the port on the CPU explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from yat_tpu_torch.parallel.multihost import local_rank, process_count
        if dev.index is None and process_count() > 1:
            dev = torch.device("cuda",
                               local_rank() % torch.cuda.device_count())
        if dev.index is not None:
            torch.cuda.set_device(dev)
    return dev
