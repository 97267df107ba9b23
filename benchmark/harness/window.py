"""The measured window: one caller issuing calls back to back.

The loop dispatches call i, records a CUDA event behind it, then waits for
call i - 1's event: the next call is always issued before the previous one
is read, as a sweep over a sequence runs. Dispatching stops once
``seconds`` have passed since the first dispatch; the window ends when the
last call's event completes, and every call dispatched counts.

With a trace stretch ``(first, count)`` the device is drained before call
``first`` and after call ``first + count - 1``, and the profiler records
those calls' device activity and CUDA runtime calls in between, still
issued one ahead of the wait. The stretch's drains and the profiler's cost
fall inside that run's window, whose rates are therefore not reported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


class _HostEvent:
    """Stand-in for a CUDA event where the program runs on the CPU (the
    harness's own tests): the work is done when the call returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


@dataclass
class Window:
    seconds: float = 0.0
    calls: int = 0
    outputs: list = field(default_factory=list)
    issue_ms: list = field(default_factory=list)   # host ms per call, outside the stretch
    profile: object = None                         # the stopped profiler, when traced
    stretch_calls: int = 0
    port_launches: dict = field(default_factory=dict)


def _event(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.Event()
    return _HostEvent()


def run(dispatch, seconds: float, device, stretch: tuple[int, int] | None = None,
        launches=None) -> Window:
    """Issue ``dispatch(0)``, ``dispatch(1)``, ... for ``seconds``.
    ``launches`` (a Counter the program updates per C entry launched) is
    read across the stretch."""
    from torch.profiler import ProfilerActivity, profile

    win = Window()
    first, count = stretch if stretch is not None else (-1, 0)
    last = first + count - 1
    prof, before = None, None
    prev = None
    i = 0
    t0 = time.perf_counter()
    while True:
        if i == first:
            if prev is not None:
                prev.synchronize()
                prev = None
            before = dict(launches) if launches is not None else None
            # Device activity and the CUDA runtime calls that issue it; the
            # host's operators stay unrecorded, since recording them would
            # slow the issue the stretch measures (on the CPU, the tests').
            cuda = torch.device(device).type == "cuda"
            prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            prof.start()
        ts = time.perf_counter()
        with torch.profiler.record_function("bench.call"):
            out = dispatch(i)
        te = time.perf_counter()
        ev = _event(device)
        ev.record()
        win.outputs.append(out)
        if not first <= i <= last:
            win.issue_ms.append((te - ts) * 1e3)
        if i == last:
            ev.synchronize()
            prof.stop()
            win.profile, win.stretch_calls = prof, count
            if launches is not None:
                win.port_launches = {k: launches[k] - before.get(k, 0) for k in launches}
            ev = None
        elif prev is not None:
            prev.synchronize()
        prev = ev
        i += 1
        if time.perf_counter() - t0 >= seconds and i > last:
            break
    if prev is not None:
        prev.synchronize()
    win.seconds = time.perf_counter() - t0
    win.calls = i
    return win
