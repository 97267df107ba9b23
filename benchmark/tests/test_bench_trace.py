"""The per-layer arithmetic on a hand-built trace: the union of device
intervals, the idle share, kernel families, idle gaps by host activity,
and the reduction of profiler events of either API."""

from __future__ import annotations

import pytest

from benchmark.harness import spec, trace


def ev(name, kind, start, end):
    return {"name": name, "kind": kind, "start_us": float(start), "end_us": float(end)}


DEVICE = [
    ev("void kd_block_search_walk<3>(float const*)", "kernel", 0, 40),
    ev("box_topk_kernel", "kernel", 30, 50),            # overlaps the walk
    ev("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", "kernel", 60, 100),
    ev("Memcpy DtoD (Device -> Device)", "memcpy", 100, 110),
    ev("elementwise_kernel<128, 4>", "kernel", 150, 160),
    ev("cutlass_80_simt_sgemm_64x64_8x5_nn_align1", "kernel", 170, 200),
]
HOST = [
    ev("bench.call", "host", -10, 210),
    ev("aten::mm", "host", 45, 70),
    ev("cudaLaunchKernel", "host", 48, 52),
    ev("aten::nonzero", "host", 105, 160),
    ev("cudaStreamSynchronize", "host", 108, 150),
]


def stretch(calls=2, units=4, issue=(3.0, 5.0, 4.0)):
    return trace.Stretch(DEVICE, HOST, calls, units, issue_ms=list(issue))


def test_union_span_and_idle_share():
    assert trace.union(DEVICE) == [(0.0, 50.0), (60.0, 110.0), (150.0, 160.0), (170.0, 200.0)]
    assert trace.busy_us(DEVICE) == 50 + 50 + 10 + 30
    assert trace.span_us(DEVICE) == 200
    read = spec.metric_reader("idle_share.pairs")
    assert read(stretch()) == pytest.approx(1 - 140 / 200)
    assert read(trace.Stretch([], HOST, 1, 1)) is None


def test_kernel_families_split_the_device_time():
    s = stretch()
    matcher = spec.metric_reader("matcher_ms.pairs")(s)
    cublas = spec.metric_reader("cublas_ms.frames")(s)
    other = spec.metric_reader("other_kernel_ms.pairs")(s)
    assert matcher == pytest.approx((40 + 20) / 1e3 / 8)
    assert cublas == pytest.approx((40 + 30) / 1e3 / 8)
    assert other == pytest.approx(10 / 1e3 / 8)          # the memcpy is no kernel
    total = sum(e["end_us"] - e["start_us"] for e in DEVICE if e["kind"] == "kernel")
    assert (matcher + cublas + other) * 8 * 1e3 == pytest.approx(total)
    assert spec.metric_reader("launches_per_call.pairs")(s) == 5 / 2
    assert spec.metric_reader("host_issue_ms.frames")(s) == 4.0
    assert spec.metric_reader("host_issue_ms.frames")(stretch(issue=())) is None
    no_matcher = trace.Stretch([DEVICE[2]], HOST, 1, 1)
    assert spec.metric_reader("matcher_ms.pairs")(no_matcher) is None


def test_idle_gaps_name_what_the_host_was_doing():
    gaps = trace.idle_gaps(DEVICE, HOST)
    assert gaps == [(10.0, "cudaLaunchKernel"), (40.0, "cudaStreamSynchronize"), (10.0, "python")]
    b = trace.breakdown(DEVICE, HOST, top=2)
    assert b["idle_gaps"] == [["cudaStreamSynchronize", 40e-6], ["cudaLaunchKernel", 10e-6]]
    assert b["device_ops"][0][1] == pytest.approx(40e-6) and len(b["device_ops"]) == 2


class _Old:
    """A profiler event of an API without ``activity_type``."""

    def __init__(self, name, device, start_us, dur_us, thread=1):
        self._n, self._d, self._s, self._u, self._t = name, device, start_us, dur_us, thread

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_us(self):
        return self._s

    def duration_us(self):
        return self._u

    def start_thread_id(self):
        return self._t


class _New(_Old):
    def __init__(self, name, kind, start_us, dur_us, thread=1):
        super().__init__(name, "CPU", start_us, dur_us, thread)
        self._k = kind

    def activity_type(self):
        return self._k

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._u * 1000)


def _prof(events):
    results = type("R", (), {"events": lambda self: events})()
    return type("P", (), {"profiler": type("K", (), {"kineto_results": results})()})()


@pytest.mark.parametrize("style", ["old", "new"])
def test_profiler_events_reduce_alike(style):
    if style == "old":
        raw = [_Old("bench.call", "CPU", 0, 100), _Old("aten::add", "CPU", 5, 5),
               _Old("aten::other_thread", "CPU", 5, 5, thread=2),
               _Old("add_kernel", "CUDA", 20, 10), _Old("Memset (Device)", "CUDA", 40, 1),
               _Old("bench.call", "CUDA", 0, 100)]
    else:
        raw = [_New("bench.call", "user_annotation", 0, 100), _New("aten::add", "cpu_op", 5, 5),
               _New("aten::other_thread", "cpu_op", 5, 5, thread=2),
               _New("add_kernel", "kernel", 20, 10), _New("Memset (Device)", "gpu_memset", 40, 1),
               _New("bench.call", "gpu_user_annotation", 0, 100)]
    device, host = trace.from_profiler(_prof(raw))
    assert [(e["name"], e["kind"]) for e in device] == [("add_kernel", "kernel"),
                                                        ("Memset (Device)", "memset")]
    assert [e["name"] for e in host] == ["bench.call", "aten::add"]
    assert device[0]["start_us"] == 20 and device[0]["end_us"] == 30
