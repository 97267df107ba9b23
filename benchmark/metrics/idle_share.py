"""Device layer: the share of the profiled stretch, from its first device
operation's start to its last one's end, in which no operation ran on the
device (1 - union of their intervals / the stretch)."""

from __future__ import annotations

from benchmark.harness.trace import busy_us, span_us


def read(stretch):
    span = span_us(stretch.device)
    return 1.0 - busy_us(stretch.device) / span if span > 0 else None
