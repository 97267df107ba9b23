"""Solvers layer: device milliseconds per registered pair or tracked frame
launched in the program's ``icp.solve`` spans (the Jacobians, the
normal-equation products, the 6 x 6 solve and the pose update), nested
spans included, attributed through the launches
(``benchmark/harness/spans.py``)."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or "icp.solve" not in a.names():
        return None
    return spans.per_unit(stretch, a.parts_us["solve"])
