"""Per-iteration ops layer: device milliseconds per registered pair or
tracked frame launched inside the program's ``icp.call`` spans outside
``icp.prepare``, ``icp.level``, ``icp.matching`` and ``icp.solve``
(selection, the transform, weighting, rejection, measure, Anderson mixing,
the trace's writes). With ``span_prepare_ms``, ``span_match_ms`` and
``span_solve_ms`` it adds up to all the device time a call launches."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or spans.CALL not in a.names():
        return None
    return spans.per_unit(stretch, a.parts_us["ops"])
