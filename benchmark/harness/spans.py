"""The program's spans and work counters in the traced stretch, and the
device time and idle gaps put down to them.

While a torch profiler runs, each entry call of the program records its
spans into ``icp_variants_tpu_torch.runtime.spans.PROFILED``, stamped with
``time.time_ns()``, the clock of the profiler's events, and its kd matchers
add their work to the counters there. A device operation belongs to the
innermost span open on the host when its launch call ran; an idle gap
(``trace.idle_gaps``' rule) to the innermost span open on the host when the
gap opened. An operation or gap with no span is the harness's (``outside``).

Each device operation is paired with its launch call by correlation id
where the events carry one (``"corr"``). The stretch's events do not
(``trace.from_profiler`` keeps name, kind and interval), so there each
launch call is paired with the device operation of its kind (kernel,
memcpy, memset) of the same rank in launch order: on one stream the device
runs them in that order. Where the profiler lost operations of a kind
(counts that differ: seen in the second profile of one process, never in
the first), the surplus at the end goes unpaired and ``checks`` says how
many, so the attribution is then approximate. Where the program recorded
no span (a checkout without the recorder), :func:`of` returns None and
the readers report nothing.

The profiler's device timestamps can run ahead of its host ones (on an
H100 host, device operations read up to 70-150 us, once 2.5 ms, before
the launch calls that made them): the idle gaps are placed after moving every device
operation later by the largest such lead, the least shift that puts each
operation after its launch call.
"""

from __future__ import annotations

import json
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from benchmark.harness.trace import union

CALL = "icp.call"
OUTSIDE = "outside"
# The device time of a call in four parts that add up to all of it: each
# operation goes to the first part whose spans hold its launch.
PARTS = (("prepare", ("icp.prepare", "icp.level")), ("match", ("icp.matching",)),
         ("solve", ("icp.solve",)), ("ops", (CALL,)))
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def launch_kind(name: str) -> str | None:
    """The kind of device operation a host call launches, or None."""
    if name.startswith(("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")):
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "memcpy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    return None


def pair(device: list, host: list) -> tuple[list, dict]:
    """For each device operation the index of its launch call in ``host``
    (None: unpaired), and the checks: per kind the counts of operations and
    launch calls, the unpaired, and ``lead_us``, the largest lead of an
    operation's start over its launch call's."""
    if device and all("corr" in e for e in device):
        by_corr = {h["corr"]: i for i, h in enumerate(host) if "corr" in h}
        out = [by_corr.get(e["corr"]) for e in device]
        checks = {"by": "corr", "unpaired": out.count(None)}
    else:
        out = [None] * len(device)
        checks = {"by": "order"}
        for kind in ("kernel", "memcpy", "memset"):
            devs = sorted((j for j, e in enumerate(device) if e["kind"] == kind),
                          key=lambda j: device[j]["start_us"])
            calls = sorted((i for i, h in enumerate(host) if launch_kind(h["name"]) == kind),
                           key=lambda i: host[i]["start_us"])
            checks[kind] = [len(devs), len(calls)]
            for j, i in zip(devs, calls):
                out[j] = i
        checks["unpaired"] = out.count(None)
    leads = [host[i]["start_us"] - e["start_us"] for e, i in zip(device, out) if i is not None]
    checks["early"] = sum(1 for x in leads if x > 0)
    checks["lead_us"] = max([0.0, *leads])
    return out, checks


def innermost(intervals: list, times: list) -> list:
    """For each time the index of the innermost of the nested ``intervals``
    (``(start, end)``; parents before children at equal starts) open at it,
    or -1."""
    order = sorted(range(len(intervals)), key=lambda k: (intervals[k][0], -intervals[k][1]))
    out = [-1] * len(times)
    stack, k = [], 0
    for q in sorted(range(len(times)), key=lambda q: times[q]):
        t = times[q]
        while k < len(order) and intervals[order[k]][0] <= t:
            while stack and intervals[stack[-1]][1] <= intervals[order[k]][0]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and intervals[stack[-1]][1] <= t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


@dataclass
class Attribution:
    """The stretch's device time by span, microseconds over all its calls."""

    calls: int                                             # icp.call spans in the stretch
    spans: list                                            # (name, parent, t0_us, t1_us)
    device_us: dict = field(default_factory=Counter)       # innermost span -> device us
    inclusive_us: dict = field(default_factory=Counter)    # span or an ancestor -> device us
    parts_us: dict = field(default_factory=Counter)        # PARTS and OUTSIDE -> device us
    kernels: dict = field(default_factory=Counter)         # innermost span -> kernels
    host_self_us: dict = field(default_factory=Counter)    # span -> its time less its children's
    idle_us: dict = field(default_factory=Counter)         # innermost span at a gap -> idle us
    idle_in_call_us: float = 0.0
    syncs: int = 0                                         # host syncs inside icp.call
    counters: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)

    def names(self) -> set:
        return {s[0] for s in self.spans}

    def chain(self, k: int) -> list:
        """Span ``k`` and its ancestors, innermost first."""
        out = []
        while k >= 0:
            out.append(k)
            k = self.spans[k][1]
        return out


def attribute(device: list, host: list, recorded: list, counters: dict) -> Attribution:
    """The attribution of ``device`` events to ``recorded`` spans
    ``(name, parent, t0_us, t1_us)``, parents as indices into the list."""
    paired, checks = pair(device, host)
    a = Attribution(calls=sum(1 for s in recorded if s[0] == CALL), spans=recorded,
                    counters=counters, checks=checks)
    intervals = [(s[2], s[3]) for s in recorded]
    launches = [host[i]["start_us"] if i is not None else None for i in paired]
    at = innermost(intervals, [t if t is not None else float("-inf") for t in launches])
    for e, k, t in zip(device, at, launches):
        us = e["end_us"] - e["start_us"]
        k = k if t is not None else -1
        names = [recorded[j][0] for j in a.chain(k)]
        a.device_us[names[0] if names else OUTSIDE] += us
        for name in set(names):
            a.inclusive_us[name] += us
        part = next((p for p, held in PARTS if any(n in held for n in names)), OUTSIDE)
        a.parts_us[part] += us
        if e["kind"] == "kernel":
            a.kernels[names[0] if names else OUTSIDE] += 1
    children = defaultdict(list)
    for k, s in enumerate(recorded):
        if s[1] >= 0:
            children[s[1]].append((s[2], s[3]))
    for k, s in enumerate(recorded):
        covered = sum(e - s0 for s0, e in union([{"start_us": c0, "end_us": c1}
                                                 for c0, c1 in children[k]]))
        a.host_self_us[s[0]] += (s[3] - s[2]) - covered
    lead = checks["lead_us"]
    busy = [(s0 + lead, e0 + lead) for s0, e0 in union(device)]
    gaps = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    for (_, us), k in zip(gaps, innermost(intervals, [g[0] for g in gaps])):
        names = [recorded[j][0] for j in a.chain(k)]
        a.idle_us[names[0] if names else OUTSIDE] += us
        if CALL in names:
            a.idle_in_call_us += us
    calls = [(s[2], s[3]) for s in recorded if s[0] == CALL]
    a.syncs = sum(1 for h, k in zip(host, innermost(calls, [h["start_us"] for h in host]))
                  if k >= 0 and h["name"] in SYNCS)
    return a


def _recorded(stretch):
    """The program's spans of the stretch's calls, ``(name, parent, t0_us,
    t1_us)``, and its counters; None without the recorder."""
    try:
        from icp_variants_tpu_torch.runtime import spans
    except ImportError:
        return None
    events = stretch.device + stretch.host
    lo = min(e["start_us"] for e in events)
    hi = max(e["end_us"] for e in events)
    recorded = [s for s in spans.PROFILED.spans if s is not None]
    keep = {s.call for s in recorded if s.name == CALL and lo <= s.t0_ns / 1e3 <= hi}
    index, out = {}, []
    for k, s in enumerate(spans.PROFILED.spans):
        if s is not None and s.call in keep:
            index[k] = len(out)
            out.append((s.name, s.parent, s.t0_ns / 1e3, s.t1_ns / 1e3))
    out = [(n, index.get(p, -1), t0, t1) for n, p, t0, t1 in out]
    return (out, spans.PROFILED.read_counters()) if out else None


_CACHE: dict = {}


def of(stretch) -> Attribution | None:
    """The stretch's attribution (computed once a stretch; the first call
    prints its summary to standard error), or None where the stretch holds
    no device operation or no span of the program."""
    key = id(stretch)
    if key not in _CACHE:
        _CACHE.clear()
        got = _recorded(stretch) if stretch.device else None
        _CACHE[key] = attribute(stretch.device, stretch.host, *got) if got else None
        print(summary(_CACHE[key], stretch.calls), file=sys.stderr)
    return _CACHE[key]


def summary(a: Attribution | None, calls: int) -> str:
    """One line: per span and call its device ms (innermost), host self ms
    and kernels, idle ms by span, host syncs inside icp.call, the raw
    counters and the pairing's checks."""
    if a is None:
        return "spans: none (no device operation or no program span in the stretch)"

    def per(d):
        return {k: round(v / 1e3 / calls, 4) for k, v in sorted(d.items())}

    return "spans: " + json.dumps({
        "calls": a.calls, "device_ms": per(a.device_us), "parts_ms": per(a.parts_us),
        "host_self_ms": per(a.host_self_us),
        "kernels": {k: v / calls for k, v in sorted(a.kernels.items())},
        "idle_ms": per(a.idle_us), "syncs_per_call": a.syncs / calls,
        "counters": a.counters, "checks": a.checks})


def per_unit(stretch, us: float) -> float:
    return us / 1e3 / stretch.units
