"""TensorBoard metric/image logging.

A copy of ``yat_tpu/utils/logging.py``: scalars such as ``train/loss`` and
``train/lr``, images keyed ``validation/{idx}/{prompt}``.  Where
``tensorboardX`` is missing the writer warns once and the run goes on;
logging failures are swallowed with a warning.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class MetricLogger:
    def __init__(self, logdir: Optional[str] = None, enabled: bool = True):
        self.enabled = enabled
        self._writer = None
        if enabled:
            try:
                from tensorboardX import SummaryWriter
                self._writer = SummaryWriter(logdir) if logdir else SummaryWriter()
            except Exception as e:  # noqa: BLE001
                print(f"[Warning] TensorBoard writer unavailable: {e}")
                self._writer = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is None:
            return
        try:
            self._writer.add_scalar(tag, float(value), step)
        except Exception as e:  # noqa: BLE001
            print(f"[Warning] TensorBoard logging failed: {e}")

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: HWC uint8 or float in [0,1]."""
        if self._writer is None:
            return
        try:
            img = np.asarray(image)
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            self._writer.add_image(tag, img, step, dataformats="HWC")
        except Exception as e:  # noqa: BLE001
            print(f"[Warning] TensorBoard logging failed: {e}")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
