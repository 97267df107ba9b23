"""Measurement tools of the port, run on the card.

* :mod:`.knn_ablate`: the visited-list search in seven ablation modes
  (kernel ``csrc/visited_ablate.cu``), which split its time by cause.
* :mod:`.resident_bench`: the kd block search's probe decomposition
  (prefix, staging, distance) at the ETH shapes.

``chip_smoke.py`` drives both; each can also be called by hand on a
machine with a card.
"""

from __future__ import annotations

import numpy as np
import torch


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn()`` over ``reps`` calls, each between two CUDA
    events, after one warm-up call. Raises without a card: these tools
    time the device and have no CPU reading."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device; none is available")
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))
