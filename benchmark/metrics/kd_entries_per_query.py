"""Matching layer: (query, block) entries that kd_block_search bucketed
per row it searched, summed over the stretch's launches from the kernel's
own counters (``kd_entries / kd_rows``, ``runtime/spans.py``): the blocks
each query needs, at most the k of box_topk. Where a pruning change cuts
it, the walk does less work."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or not a.counters.get("kd_rows"):
        return None
    return a.counters["kd_entries"] / a.counters["kd_rows"]
