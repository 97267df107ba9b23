"""The traced stretch, reduced to plain events, and the arithmetic the
per-layer readers share.

An event is a dict ``{"name", "kind", "start_us", "end_us"}`` with
``kind`` one of ``kernel``, ``memcpy``, ``memset`` (device activity) or
``host`` (a CUDA runtime call, or an operator or annotation where those
were recorded).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
CALL_ANNOTATION = "bench.call"
NAME_CHARS = 160   # of a name in the breakdown (templated kernel names run long)


@dataclass
class Stretch:
    """What the per-layer readers see: the stretch's device and host events,
    the calls it holds, the units (pairs, frames) a call carries, and the
    host ms of the window's calls outside the stretch."""

    device: list
    host: list
    calls: int
    units_per_call: int
    issue_ms: list = field(default_factory=list)

    @property
    def units(self) -> int:
        return self.calls * self.units_per_call


def _kind(e) -> str:
    """``kernel``, ``memcpy``, ``memset`` or ``host`` (older profilers have
    no ``activity_type``: their device events are the CUDA ones)."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        if kind in DEVICE_KINDS:
            return DEVICE_KINDS[kind]
        return "host" if kind in HOST_KINDS else "other"
    if "CUDA" in str(e.device_type()):
        name = e.name()
        if name == CALL_ANNOTATION:     # the annotation's span on the device's timeline
            return "other"
        return ("memcpy" if name.startswith("Memcpy")
                else "memset" if name.startswith("Memset") else "kernel")
    return "host"


def _interval_us(e) -> tuple[float, float]:
    if hasattr(e, "start_ns"):
        start = e.start_ns() / 1e3
        return start, start + e.duration_ns() / 1e3
    return e.start_us(), e.start_us() + e.duration_us()


def from_profiler(prof) -> tuple[list, list]:
    """``(device events, host events)`` of a stopped ``torch.profiler``
    profile; host events on the thread that issued the calls where the
    profile holds their annotation (it records the host's operators),
    else every runtime call."""
    device, host = [], []
    raw = [(e, _kind(e)) for e in prof.profiler.kineto_results.events()]
    call_threads = {e.start_thread_id() for e, kind in raw
                    if kind == "host" and e.name() == CALL_ANNOTATION}
    for e, kind in raw:
        if kind == "host" and call_threads and e.start_thread_id() not in call_threads:
            continue
        if kind == "other":
            continue
        start, end = _interval_us(e)
        (host if kind == "host" else device).append(
            {"name": e.name(), "kind": kind, "start_us": start, "end_us": end})
    device.sort(key=lambda e: e["start_us"])
    host.sort(key=lambda e: e["start_us"])
    return device, host


def union(events) -> list[tuple[float, float]]:
    """Merged [start, end) intervals covered by ``events``, in order."""
    out = []
    for s, e in sorted((ev["start_us"], ev["end_us"]) for ev in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def span_us(events) -> float:
    """From the first device event's start to the last one's end."""
    if not events:
        return 0.0
    return max(e["end_us"] for e in events) - min(e["start_us"] for e in events)


def busy_us(events) -> float:
    return sum(e - s for s, e in union(events))


def matches(name: str, families) -> bool:
    low = name.lower()
    return any(f.lower() in low for f in families)


def kernel_us(events, families=None, exclude=()) -> float:
    """Summed duration of the kernels whose names hold one of ``families``
    (every kernel when None), leaving out those that hold one of
    ``exclude``."""
    return sum(e["end_us"] - e["start_us"] for e in events
               if e["kind"] == "kernel"
               and (families is None or matches(e["name"], families))
               and not matches(e["name"], exclude))


def idle_gaps(device, host) -> list[tuple[float, str]]:
    """Each gap between the device's busy intervals inside the stretch,
    ``(us, what the host was doing)``: the innermost host event open at the
    gap's start (host events on one thread nest), else ``python``."""
    busy = union(device)
    hosts = sorted((h for h in host if h["name"] != CALL_ANNOTATION),
                   key=lambda h: (h["start_us"], -h["end_us"]))
    gaps, stack, k = [], [], 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        while k < len(hosts) and hosts[k]["start_us"] <= e0:
            while stack and stack[-1]["end_us"] <= hosts[k]["start_us"]:
                stack.pop()
            stack.append(hosts[k])
            k += 1
        while stack and stack[-1]["end_us"] <= e0:
            stack.pop()
        gaps.append((s1 - e0, stack[-1]["name"] if stack else "python"))
    return gaps


def breakdown(device, host, top: int = 10) -> dict:
    """The device operations that took the most time and the idle time by
    what the host was doing, in seconds, at most ``top`` of each."""
    ops, idle = Counter(), Counter()
    for e in device:
        ops[e["name"][:NAME_CHARS]] += (e["end_us"] - e["start_us"]) / 1e6
    for us, label in idle_gaps(device, host):
        idle[label[:NAME_CHARS]] += us / 1e6
    return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}
