"""Entry layer: device milliseconds per registered pair or tracked frame
launched in each call's set-up, the program's ``icp.prepare`` and
``icp.level`` spans (device moves, the tile index, the fused row tables,
the caches, a pyramid level's slice and seed), attributed through the
launches (``benchmark/harness/spans.py``)."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or not a.names() & {"icp.prepare", "icp.level"}:
        return None
    return spans.per_unit(stretch, a.parts_us["prepare"])
