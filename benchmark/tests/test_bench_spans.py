"""The attribution of the stretch's device time and idle gaps to the
program's spans (``benchmark/harness/spans.py``), on hand-built events,
and the readers that report it."""

from __future__ import annotations

import pytest

from benchmark.harness import spans, spec, trace

# Spans (name, parent, t0_us, t1_us) of one call: set-up, then matching,
# then a solve with its reduction inside.
RECORDED = [
    ("icp.call", -1, 0.0, 100.0),
    ("icp.prepare", 0, 1.0, 10.0),
    ("icp.matching", 0, 10.0, 40.0),
    ("icp.solve", 0, 40.0, 80.0),
    ("icp.reduce", 3, 50.0, 70.0),
]


def ev(name, kind, start, end, corr=None):
    e = {"name": name, "kind": kind, "start_us": float(start), "end_us": float(end)}
    if corr is not None:
        e["corr"] = corr
    return e


def events(corr: bool):
    """Launch calls on the host and their device operations: one in each
    span, one in the call outside the four parts, and the harness's before
    and after the call."""
    c = (lambda i: i) if corr else (lambda i: None)
    host = [
        ev("cudaLaunchKernel", "host", -5, -4, c(1)),       # the harness's, before the call
        ev("cudaMemsetAsync", "host", 2, 3, c(2)),          # icp.prepare
        ev("cudaLaunchKernel", "host", 12, 13, c(3)),       # icp.matching
        ev("cudaLaunchKernelExC", "host", 20, 21, c(4)),    # icp.matching
        ev("cudaStreamSynchronize", "host", 22, 30),        # a sync inside the call
        ev("cudaLaunchKernel", "host", 45, 46, c(5)),       # icp.solve, outside icp.reduce
        ev("cuLaunchKernel", "host", 55, 56, c(6)),         # icp.reduce
        ev("cudaMemcpyAsync", "host", 60, 61, c(7)),        # icp.reduce
        ev("cudaLaunchKernel", "host", 85, 86, c(8)),       # icp.call, outside the parts
        ev("cudaLaunchKernel", "host", 101, 101.5, c(9)),   # the harness's, after the call
        ev("cudaLaunchKernel", "host", 104, 104.5, c(10)),
    ]
    device = [
        ev("pose_draw", "kernel", 0, 2, c(1)),
        ev("Memset (Device)", "memset", 4, 5, c(2)),
        ev("box_topk", "kernel", 14, 20, c(3)),
        ev("kd_block_search_walk", "kernel", 22, 42, c(4)),
        ev("elementwise", "kernel", 47, 50, c(5)),
        ev("gemm", "kernel", 57, 67, c(6)),
        ev("Memcpy DtoH", "memcpy", 67, 68, c(7)),
        ev("sum", "kernel", 90, 92, c(8)),
        ev("event_wait", "kernel", 102, 103, c(9)),
        ev("pose_draw", "kernel", 110, 111, c(10)),
    ]
    return device, host


@pytest.mark.parametrize("corr", [True, False], ids=["by-correlation", "by-launch-order"])
def test_device_time_lands_in_its_launch_span(corr):
    device, host = events(corr)
    a = spans.attribute(device, host, RECORDED, {"kd_rows": 4})
    assert a.checks["by"] == ("corr" if corr else "order") and a.checks["lead_us"] == 0
    assert a.checks["unpaired"] == 0
    assert a.device_us == {"outside": 4, "icp.prepare": 1, "icp.matching": 26,
                           "icp.solve": 3, "icp.reduce": 11, "icp.call": 2}
    assert a.kernels == {"outside": 3, "icp.matching": 2, "icp.solve": 1, "icp.reduce": 1,
                         "icp.call": 1}
    assert a.inclusive_us["icp.solve"] == 14 and a.inclusive_us["icp.reduce"] == 11
    assert a.inclusive_us["icp.call"] == 43
    assert a.parts_us == {"prepare": 1, "match": 26, "solve": 14, "ops": 2, "outside": 4}
    assert sum(a.parts_us[p] for p, _ in spans.PARTS) == a.inclusive_us["icp.call"]
    assert a.calls == 1 and a.syncs == 1 and a.counters == {"kd_rows": 4}


def test_host_self_time_leaves_out_the_children():
    a = spans.attribute(*events(True), RECORDED, {})
    assert a.host_self_us == {"icp.call": 100 - 9 - 30 - 40, "icp.prepare": 9,
                              "icp.matching": 30, "icp.solve": 20, "icp.reduce": 20}


def test_idle_gaps_go_to_the_span_open_at_the_gap():
    """Gaps between busy intervals, labelled by the innermost span open on
    the host when each opened; those opened inside icp.call summed apart."""
    device, host = events(True)
    a = spans.attribute(device, host, RECORDED, {})
    # busy: [0,2] [4,5] [14,20] [22,42] [47,50] [57,68] [90,92] [102,103] [110,111]
    assert a.idle_us == {"icp.prepare": 2 + 9, "icp.matching": 2, "icp.solve": 5,
                         "icp.reduce": 7 + 22, "icp.call": 10, "outside": 7}
    assert a.idle_in_call_us == 11 + 2 + 5 + 29 + 10
    gaps = trace.idle_gaps(device, host)
    assert sum(us for us, _ in gaps) == sum(a.idle_us.values())


def test_operations_the_profiler_lost_leave_launches_unpaired():
    """A lost device operation (the last draw's): its launch goes unpaired,
    the checks count it, and the rest is attributed as before."""
    device, host = events(False)
    a = spans.attribute(device[:-1], host, RECORDED, {})
    assert a.checks["kernel"] == [7, 8] and a.checks["unpaired"] == 0
    assert a.device_us == {"outside": 3, "icp.prepare": 1, "icp.matching": 26,
                           "icp.solve": 3, "icp.reduce": 11, "icp.call": 2}
    b = spans.attribute(device, host[:-1], RECORDED, {})
    assert b.checks["unpaired"] == 1 and b.device_us["outside"] == 4


def test_device_clock_ahead_of_the_host_is_moved_back():
    """Device timestamps that lead their launch calls: the idle gaps are
    placed after shifting every device operation by the largest lead."""
    device, host = events(False)
    ahead = [dict(e, start_us=e["start_us"] - 3, end_us=e["end_us"] - 3) for e in device]
    a, b = (spans.attribute(d, host, RECORDED, {}) for d in (device, ahead))
    assert b.checks["lead_us"] == 2.0 and b.checks["early"] == 6
    assert b.device_us == a.device_us
    assert sum(b.idle_us.values()) == sum(a.idle_us.values())
    assert b.idle_us["icp.prepare"] == 2 + 9


def test_innermost_interval_by_time():
    iv = [(0, 10), (2, 5), (2, 3), (6, 9)]
    assert spans.innermost(iv, [-1, 0, 2, 3, 4, 5, 7, 9.5, 10]) == [-1, 0, 2, 1, 1, 0, 3, 0, -1]


def test_readers_report_the_attribution(monkeypatch):
    device, host = events(False)
    st = trace.Stretch(device, host, calls=1, units_per_call=2)
    a = spans.attribute(device, host, RECORDED, {"kd_rows": 10, "kd_entries": 25,
                                                 "kd_chunks": 3, "fallback_rows": 1})
    monkeypatch.setattr(spans, "of", lambda stretch: a)
    got = {name: spec.metric_reader(name)(st) for name in (
        "span_prepare_ms.pairs", "span_match_ms.pairs", "span_solve_ms.pairs",
        "span_reduce_ms.pairs", "span_ops_ms.pairs", "idle_in_call_ms.pairs",
        "kd_entries_per_query.pairs", "fallback_share.pairs")}
    assert got == pytest.approx({
        "span_prepare_ms.pairs": 0.0005, "span_match_ms.pairs": 0.013,
        "span_solve_ms.pairs": 0.007, "span_reduce_ms.pairs": 0.0055,
        "span_ops_ms.pairs": 0.001, "idle_in_call_ms.pairs": 0.0285,
        "kd_entries_per_query.pairs": 2.5, "fallback_share.pairs": 0.1})
    b = spans.attribute(device, host, [s for s in RECORDED if s[0] != "icp.reduce"], {})
    monkeypatch.setattr(spans, "of", lambda stretch: b)
    assert spec.metric_reader("span_reduce_ms.frames")(st) is None       # an LM solve
    assert spec.metric_reader("kd_entries_per_query.frames")(st) is None  # no kd matcher


def test_without_program_spans_the_readers_report_nothing(monkeypatch):
    """A checkout whose program records no span (or a stretch with no
    device operation): every reader returns None and nothing raises."""
    device, host = events(False)
    st = trace.Stretch(device, host, calls=1, units_per_call=2)
    monkeypatch.setattr(spans, "_recorded", lambda stretch: None)
    spans._CACHE.clear()
    for m in ("span_prepare_ms", "span_match_ms", "span_solve_ms", "span_reduce_ms",
              "span_ops_ms", "idle_in_call_ms", "kd_entries_per_query", "fallback_share"):
        assert spec.metric_reader(m + ".pairs")(st) is None
    assert spec.metric_reader("span_match_ms.pairs")(trace.Stretch([], host, 1, 2)) is None
    spans._CACHE.clear()
