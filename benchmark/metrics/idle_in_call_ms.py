"""Device layer: milliseconds per registered pair or tracked frame in
which the device was idle while the host ran the program, the gaps
between device operations that opened inside an ``icp.call`` span (gaps
that opened in the harness between calls are left out), attributed by
``benchmark/harness/spans.py``."""

from __future__ import annotations

from benchmark.harness import spans


def read(stretch):
    a = spans.of(stretch)
    if a is None or spans.CALL not in a.names():
        return None
    return spans.per_unit(stretch, a.idle_in_call_us)
