"""Solvers layer: device milliseconds per registered pair or tracked frame
launched in the program's ``icp.reduce`` spans, the linear solvers'
normal-equation products (``wJ^T J``, ``wJ^T r``), a part of
``span_solve_ms``; absent for a solver without them (LM)."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or "icp.reduce" not in a.names():
        return None
    return spans.per_unit(stretch, a.inclusive_us["icp.reduce"])
