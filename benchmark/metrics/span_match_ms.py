"""Matching layer: device milliseconds per registered pair or tracked
frame launched in the program's ``icp.matching`` spans: the matcher
kernels and their PyTorch glue (gathers, the certificate, the fallback,
the target-row gather, the cache update), attributed through the launches
(``benchmark/harness/spans.py``)."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or "icp.matching" not in a.names():
        return None
    return spans.per_unit(stretch, a.parts_us["match"])
