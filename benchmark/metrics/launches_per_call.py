"""Entry layer: device kernels launched per call, counted in the profiled
stretch. Each launch costs the host issue time and the device a gap."""

from __future__ import annotations


def read(stretch):
    n = sum(1 for e in stretch.device if e["kind"] == "kernel")
    return n / stretch.calls if n else None
