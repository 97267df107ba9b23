"""Per-iteration ops (``ops/selection``, ``ops/weighting``,
``ops/rejection``, ``core/se3``, ``pipeline/measure``): device milliseconds
per registered pair or tracked frame in every kernel that is neither a
matcher's nor cuBLAS's."""

from __future__ import annotations

from benchmark.harness.trace import kernel_us
from benchmark.metrics.cublas_ms import FAMILIES as CUBLAS
from benchmark.metrics.matcher_ms import FAMILIES as MATCHER


def read(stretch):
    us = kernel_us(stretch.device, exclude=MATCHER + CUBLAS)
    return us / 1e3 / stretch.units if us else None
