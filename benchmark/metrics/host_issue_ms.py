"""Entry layer: host milliseconds from entering a call to its return,
median over the traced run's calls outside the profiled stretch (host
clock). Moves the cell's rate: where the host issues a call more slowly
than the device runs it, the host sets the pace."""

from __future__ import annotations

import statistics


def read(stretch):
    return statistics.median(stretch.issue_ms) if stretch.issue_ms else None
