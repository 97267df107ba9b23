"""Matching layer: the share of the rows kd_block_search searched that
failed the certificate and visited_search searched again, from the
kernels' own counters (``fallback_rows / kd_rows``, ``runtime/spans.py``)."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or not a.counters.get("kd_rows"):
        return None
    return a.counters["fallback_rows"] / a.counters["kd_rows"]
