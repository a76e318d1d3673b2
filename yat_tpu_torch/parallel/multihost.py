"""Per-process seeds.

``host_seed`` is a copy of ``yat_tpu/parallel/multihost.py:host_seed``
(numpy only).  The port runs one process, so the process index defaults
to 0; multi-process training is not ported (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import numpy as np


def host_seed(global_seed: int, process_index: int = 0) -> int:
    """Decorrelated per-process seed of the shard shuffle."""
    return int(np.random.SeedSequence([global_seed, process_index])
               .generate_state(1)[0])
