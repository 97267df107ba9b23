"""Solver layer: device milliseconds per registered pair or tracked frame
in cuBLAS's kernels, which run the normal-equation products of
``solvers/linear`` (nearly all of this time) and the pose products."""

from __future__ import annotations

from benchmark.harness.trace import kernel_us
from benchmark.metrics.matcher_ms import FAMILIES as MATCHER

FAMILIES = ("gemm", "gemv", "cutlass", "xmma", "cublas", "dot_kernel", "splitkreduce",
            "reduce_1block")


def read(stretch):
    us = kernel_us(stretch.device, FAMILIES, exclude=MATCHER)
    return us / 1e3 / stretch.units if us else None
