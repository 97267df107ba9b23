"""Stage spans and matcher work counters of the ICP loop.

A span is a named interval of host time at a layer boundary of
``pipeline/icp.py`` and ``solvers/linear.py``, stamped with
``time.time_ns()``: the clock torch's profiler gives its events, so a span
lines up with the operators and CUDA calls made inside it. Counters are
int64 slots that the kd matcher kernels add their work to where it happens.

    from icp_variants_tpu_torch.runtime import spans
    with spans.recording() as rec:
        icp.run_icp_batch(cfg, sources, targets, ...)
    rec.spans      # [Span(name, parent, call, t0_ns, t1_ns), ...]
    rec.counters   # {"kd_rows": ..., "kd_entries": ..., ...}

Spans record inside :func:`recording`, and during an entry call made while
a torch profiler runs and no recording is open: those go to
:data:`PROFILED`, so every profile of the port carries its spans. Otherwise
(the default, and every unprofiled run) :func:`span` makes one
module-level check and returns a shared null context: nothing is allocated,
launched, synchronised or recorded. Spans change no result.

The names, each a span per occurrence (a stage probe's early return closes
its spans like any other exit):

- ``icp.call``: one entry call (:func:`call`); a nested entry call (a
  pyramid level's ``run_icp_batch``) opens none.
- ``icp.prepare``: a call's set-up before the loop: device moves, the tile
  index, the fused row tables, the caches and the trace buffers.
- ``icp.level``: a pyramid level's stride slice and membership seed.
- ``icp.selection``: the selection and the transform of points and normals.
- ``icp.matching``: the matcher up to the built match arrays, with the
  target-row gather and the cache update.
- ``icp.weighting``, ``icp.rejection``.
- ``icp.solve``: the solve and the left-multiplied update; ``icp.reduce``
  inside it, around the normal-equation products (the linear solvers).
- ``icp.measure``: rmse, the benchmark error, the match count and the
  writes into the trace buffers.
- ``icp.anderson``: the mixing step, when ``anderson_m > 0``.

The counters (:data:`COUNTERS`), summed over the launches recorded:

- ``kd_rows``: rows ``kd_block_search`` searched (rows with a pick);
- ``kd_entries``: its (query, block) entries, the blocks those rows need;
- ``kd_chunks``: its bucket chunks staged, the block loads the entries
  share;
- ``fallback_rows``: live rows ``visited_search`` searched again (the rows
  whose certificate failed).
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

COUNTERS = ("kd_rows", "kd_entries", "kd_chunks", "fallback_rows")
# The first counter slot each kernel adds to (its C entry's pointer).
SLOTS = {"kd_block_search": 0, "visited_search": 3}
CALL = "icp.call"
# PROFILED drops its spans before an entry call past this many.
PROFILED_MAX_SPANS = 1_000_000

_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    parent: int   # index of the enclosing span in the same list, -1 for none
    call: int     # the entry call's number, shared by all its spans
    t0_ns: int    # time.time_ns() at open and at close
    t1_ns: int


class Recording:
    """Spans and counters of one recording. ``spans`` is filled as
    spans close (a span's slot is taken when it opens, so a parent's index
    is known); ``counters`` is read from the device buffers by
    :meth:`read_counters`."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = dict.fromkeys(COUNTERS, 0)
        self._stack: list = []      # (index, name, t0) of the open spans
        self._calls = 0
        self._buffers: dict = {}    # device -> (len(COUNTERS),) int64
        self._slots: dict = {}      # (kernel, device) -> the kernel's view of its buffer

    def slots(self, kernel: str, device) -> torch.Tensor:
        """Kernel ``kernel``'s counter slots on ``device``: a view of the
        device's buffer (zeroed at its first use) from the kernel's first
        slot."""
        key = (kernel, device)
        if key not in self._slots:
            dev = torch.device(device)
            if dev not in self._buffers:
                self._buffers[dev] = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
            self._slots[key] = self._buffers[dev][SLOTS[kernel]:]
        return self._slots[key]

    def read_counters(self) -> dict:
        """The counters summed over the devices' buffers (waits for them)."""
        total = dict.fromkeys(COUNTERS, 0)
        for buf in self._buffers.values():
            for name, v in zip(COUNTERS, buf.tolist()):
                total[name] += v
        return total

    def clear(self) -> None:
        if self._stack:
            raise RuntimeError("spans are open")
        self.spans.clear()
        for buf in self._buffers.values():
            buf.zero_()


class _Open:
    """One open span of a recording."""

    __slots__ = ("rec", "name", "slot")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.slot = len(rec.spans)
        rec.spans.append(None)
        rec._stack.append((self.slot, self.name, time.time_ns()))
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        slot, name, t0 = rec._stack.pop()
        parent = rec._stack[-1][0] if rec._stack else -1
        rec.spans[slot] = Span(name, parent, rec._calls, t0, t1)
        return False


_NULL = contextlib.nullcontext()
_rec: Recording | None = None   # where spans go now; None = nowhere
PROFILED = Recording()


def span(name: str):
    """A context manager recording span ``name`` when a recording is open;
    the shared null context otherwise."""
    rec = _rec
    if rec is None:
        return _NULL
    return _Open(rec, name)


class _Call:
    """An entry call's ``icp.call`` span; with ``auto``, the call records
    into :data:`PROFILED` and stops recording when it returns."""

    __slots__ = ("open", "auto")

    def __init__(self, rec: Recording, auto: bool):
        self.open, self.auto = _Open(rec, CALL), auto

    def __enter__(self):
        global _rec
        rec = self.open.rec
        if self.auto:
            if len(rec.spans) > PROFILED_MAX_SPANS:
                rec.spans.clear()
            _rec = rec
        rec._calls += 1
        self.open.__enter__()
        return self

    def __exit__(self, *exc):
        global _rec
        self.open.__exit__(*exc)
        if self.auto:
            _rec = None
        return False


def call():
    """The ``icp.call`` span of one entry call. Inside another ``icp.call``
    it opens nothing. With no recording open it opens nothing either,
    unless a torch profiler runs: then the call records into
    :data:`PROFILED`."""
    rec = _rec
    if rec is None:
        if not _profiler_enabled():
            return _NULL
        return _Call(PROFILED, True)
    if any(name == CALL for _, name, _ in rec._stack):
        return _NULL
    return _Call(rec, False)


def counters(kernel: str, device) -> torch.Tensor | None:
    """The counter slots a launch of ``kernel`` adds to on ``device`` (a
    view of the open recording's buffer from the kernel's first slot), or
    None when nothing records."""
    rec = _rec
    if rec is None:
        return None
    return rec.slots(kernel, device)


@contextlib.contextmanager
def recording():
    """Record spans and counters until the block ends; yields the
    :class:`Recording`, whose ``counters`` are read when it ends."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        rec.counters = rec.read_counters()
