"""Per-stage instrumentation: the TimeMeasure equivalent, and tracing.

PyTorch port of the eager part of ``icp_variants_tpu.pipeline.profiling``.
The reference brackets each pipeline stage with ``clock()`` and prints
per-iteration averages (TimeMeasure.h:7-62, filled at
ICPOptimizer.h:245-302):

* :func:`profile_stages` runs one ICP iteration stage by stage, the device
  synchronised after each, several repetitions, and reports the
  reference's six accumulators (selection / matching / weighting /
  rejection / solver / convergence). It models the JAX package's legacy
  full-tile chain: mask-based RANDOM selection (no compaction) and the
  dense matcher ``knn.match`` (CUDA kernel ``csrc/dense_nn_search.cu`` on
  the card), or the projective window search.
* :func:`profile_fused_stages` times the real driver (``icp.run_icp``)
  truncated after each stage by its ``stop_after`` probes and attributes
  per-iteration time by differencing, on the host's clock;
  :func:`profile_fused_device` differences the card's kernel time of the
  same probes; :func:`kernel_efficiency` sets the matching and solve
  stages' times against the work that :func:`matcher_work_model` counts
  from the real iteration-0 queries; :func:`fused_report` prints them all.
* :func:`trace` records a ``torch.profiler`` trace of whatever runs inside
  it, with the ICP loop's spans, and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import kdtree, knn, projective, rejection, selection, weighting
from icp_variants_tpu_torch.pipeline import icp as icp_mod
from icp_variants_tpu_torch.pipeline.config import ICPConfig, Matching, Metric, Selection
from icp_variants_tpu_torch.pipeline.icp import _solve
from icp_variants_tpu_torch.runtime import spans


@dataclass
class StageTimes:
    """The reference's six accumulators (TimeMeasure.h:20-26), in seconds
    per iteration, with the JAX package's fields: ``full_run`` (the whole
    unprobed run, fused profiler), ``total_wall`` (the whole profiling run)
    and ``overhead`` (the fused profiler's floor probe; zero for the eager
    harness)."""

    selection: float = 0.0
    matching: float = 0.0
    weighting: float = 0.0
    rejection: float = 0.0
    solver: float = 0.0
    convergence: float = 0.0
    n_iterations: int = 0
    full_run: float = 0.0
    total_wall: float = 0.0
    overhead: float = 0.0

    def report(self) -> str:
        """calculateIterationTime-style report (TimeMeasure.h:43-60)."""
        total = (
            self.selection + self.matching + self.weighting
            + self.rejection + self.solver + self.convergence
        )
        lines = [
            f"Mean time per ICP iteration ({self.n_iterations} iterations):",
            f"  selection:   {self.selection * 1e3:9.3f} ms",
            f"  matching:    {self.matching * 1e3:9.3f} ms",
            f"  weighting:   {self.weighting * 1e3:9.3f} ms",
            f"  rejection:   {self.rejection * 1e3:9.3f} ms",
            f"  solver:      {self.solver * 1e3:9.3f} ms",
            f"  convergence: {self.convergence * 1e3:9.3f} ms",
            f"  total:       {total * 1e3:9.3f} ms",
        ]
        if self.overhead:
            lines.append(
                f"  scan/dispatch floor: {self.overhead * 1e3:9.3f} ms"
                " (not attributed to stages)"
            )
        if self.full_run:
            lines.append(f"  full fused run: {self.full_run:.4f} s")
        return "\n".join(lines)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _timed(fn, *args):
    """``fn(*args)`` and its host seconds, the devices of the result's
    tensors synchronised before the clock stops."""
    t0 = time.perf_counter()
    out = fn(*args)
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _match(cfg: ICPConfig, source: Cloud, target: Cloud, tfeat, pts, mask):
    """The matching stage of the eager chain: the projective window search,
    else the dense matcher over the colour features ``tfeat`` of the
    target (color-ICP) or its points."""
    if cfg.matching == Matching.PROJECTIVE:
        return projective.projective_match(
            pts, target.points, target.valid, fx=cfg.projective_fx, fy=cfg.projective_fy,
            cx=cfg.projective_cx, cy=cfg.projective_cy, width=cfg.projective_width,
            height=cfg.projective_height, window=cfg.projective_window,
            max_distance=cfg.max_distance, query_mask=mask,
            chunk=cfg.projective_chunk or projective.CHUNK)
    if cfg.color_icp:
        return knn.match(knn.color_features(pts, source.colors), tfeat, cfg.max_distance,
                         query_mask=mask)
    return knn.match(pts, target.points, cfg.max_distance, query_mask=mask)


def _iteration_stages(cfg: ICPConfig, source: Cloud, target: Cloud, pose, mask):
    """One iteration after selection on clouds with a pair axis, the device
    synchronised after each stage; returns the (B, 4, 4) increment and the
    seconds of matching, weighting, rejection and the solve."""
    tfeat = knn.color_features(target.points, target.colors) if cfg.color_icp else None

    def transform():
        pts = torch.where(mask[..., None], se3.transform_points(source.points, pose),
                          cloud_lib.PAD_SENTINEL)
        return pts, se3.transform_normals(source.normals, pose)

    (pts, nrm), _ = _timed(transform)
    (idx, _d2, valid), dt_match = _timed(_match, cfg, source, target, tfeat, pts, mask)
    idx = torch.clamp(idx, 0, target.capacity - 1)
    m = weighting.MatchArrays(
        src_points=pts,
        tgt_points=knn.take_rows(target.points, idx),
        src_normals=nrm,
        tgt_normals=knn.take_rows(target.normals, idx),
        src_colors=source.colors,
        tgt_colors=knn.take_rows(target.colors, idx),
        valid=valid & knn.take_rows(target.valid, idx),
    )
    w, dt_weight = _timed(weighting.apply_weights, cfg.weighting, m, cfg.max_distance)
    newvalid, dt_reject = _timed(rejection.normal_angle_mask, m.src_normals, m.tgt_normals,
                                 m.valid)
    m = m._replace(valid=newvalid if cfg.rejection else m.valid)
    inc, dt_solve = _timed(_solve, cfg, m, w)
    return inc, (dt_match, dt_weight, dt_reject, dt_solve)


def profile_stages(
    cfg: ICPConfig,
    source: Cloud,
    target: Cloud,
    pose=None,
    repetitions: int = 3,
    generator: torch.Generator | None = None,
    *,
    device=None,
) -> StageTimes:
    """Eager per-stage timing of one ICP iteration: each stage runs once as
    a warm-up, then ``repetitions`` timed passes (a new selection draw from
    ``generator`` each; default: a generator on the device seeded with 0).

    ``source`` / ``target`` are one pair (or carry a leading pair axis);
    ``pose`` (4, 4) (or (B, 4, 4)) defaults to the identity. ``device``
    (``None`` = the card) is where the stages run; the clouds are moved
    there. This eager harness models the legacy full-tile pipeline only:
    mask-based RANDOM selection (no compaction) and the dense matcher or
    the projective window search."""
    dev = resolve_device(device)
    if source.points.dim() == 2:
        source, target = Cloud(*(f[None] for f in source)), Cloud(*(f[None] for f in target))
    source, target = source.to(dev), target.to(dev)
    b = source.points.shape[0]
    if pose is None:
        pose = torch.eye(4, dtype=torch.float32, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32).to(dev)
    pose = pose.expand(b, 4, 4) if pose.dim() == 2 else pose
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def select():
        if cfg.selection == Selection.RANDOM:
            return selection.random_sampling(generator, source.valid, cfg.selection_proba)
        return source.valid

    times = StageTimes(n_iterations=repetitions)
    t_run0 = time.perf_counter()
    for rep in range(repetitions + 1):  # rep 0 = warm-up
        mask, dt_sel = _timed(select)
        _, (dt_match, dt_weight, dt_reject, dt_solve) = _iteration_stages(
            cfg, source, target, pose, mask)
        if rep == 0:
            continue
        times.selection += dt_sel / repetitions
        times.matching += dt_match / repetitions
        times.weighting += dt_weight / repetitions
        times.rejection += dt_reject / repetitions
        times.solver += dt_solve / repetitions
    times.total_wall = time.perf_counter() - t_run0
    return times


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace (CPU, and the card's kernels where there is
    one) of the block's work, written to ``log_dir/trace.json`` as a
    Chrome trace; yields the profiler. The ICP loop's spans
    (:mod:`~icp_variants_tpu_torch.runtime.spans`) are recorded over the
    block and written into the same file as complete events of category
    ``icp_span`` on the thread that ran the block, on the profiler's time
    base, so Perfetto shows each stage above the operators and kernels it
    launched."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with spans.recording() as rec, torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    _add_spans(path, rec.spans, threading.get_native_id())


def _add_spans(path: str, recorded, tid: int) -> None:
    """Append ``recorded`` spans to the Chrome trace at ``path`` as complete
    events on thread ``tid``: microseconds from the file's
    ``baseTimeNanoseconds``, as the profiler writes its own events."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "icp_span", "name": s.name, "pid": os.getpid(), "tid": tid,
         "ts": (s.t0_ns - base) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
         "args": {"call": s.call, "parent": s.parent}}
        for s in recorded)
    with open(path, "w") as f:
        json.dump(doc, f)


# ---------------------------------------------------------------------------
# Fused TimeMeasure: stage differencing of the real driver
# ---------------------------------------------------------------------------

# The card's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
# limit): f32 outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 6.7e13
PEAK_HBM_BYTES = 3.35e12

_STAGES = (*icp_mod.PROBE_STAGES, None)


def _split_stages(totals: dict, n_iter: int) -> StageTimes:
    """Per-iteration stage times from whole-run ``totals`` per probe
    (:data:`_STAGES`), each stage the difference of successive probes."""

    def per_iter(a, b):
        return max(totals[a] - totals[b], 0.0) / n_iter

    times = StageTimes(n_iterations=n_iter)
    times.overhead = totals["floor"] / n_iter
    times.selection = per_iter("selection", "floor")
    times.matching = per_iter("matching", "selection")
    times.weighting = per_iter("weighting", "matching")
    times.rejection = per_iter("rejection", "weighting")
    times.solver = per_iter("solve", "rejection")
    times.convergence = per_iter(None, "solve")
    times.full_run = totals[None]
    return times


def _n_iterations(cfg: ICPConfig, source: Cloud) -> int:
    return int(cloud_lib.multires_stride_schedule(
        int(source.num_valid()), cfg.n_iterations, cfg.multi_resolution,
        cfg.multi_resolution_min_points).shape[0])


def profile_fused_stages(
    cfg: ICPConfig,
    source: Cloud,
    target: Cloud,
    *,
    seed: int = 0,
    repetitions: int = 3,
    run_benchmark: bool = False,
    kd_index=None,
    device=None,
) -> StageTimes:
    """Per-stage timing of the real driver (TimeMeasure.h:20-60 semantics
    over whole runs) on the host's clock: :func:`icp.run_icp` truncated
    after each stage by its ``stop_after`` probes, every run from the same
    ``seed`` and ended by a device synchronise, and the per-iteration time
    of a stage taken as the difference of successive probes' minimum over
    ``repetitions`` (after one warm-up round). Each round runs every probe
    once, so a slow spell of a shared host falls on all stages alike rather
    than on one. Unlike :func:`profile_stages` the numbers include whatever
    the production run overlaps; where the run is bound by host dispatch
    they are dispatch times (:func:`profile_fused_device` reads the card's).
    ``device`` (``None`` = the card) is where the runs happen."""
    if repetitions < 1:
        raise ValueError(f"repetitions must be >= 1, got {repetitions}")
    dev = resolve_device(device)

    def run_variant(stage):
        res = icp_mod.run_icp(cfg, source, target, seed=seed, run_benchmark=run_benchmark,
                              stop_after=stage, kd_index=kd_index, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res

    wall0 = time.perf_counter()
    for stage in _STAGES:
        run_variant(stage)  # warm-up
    # The minimum, not the mean: one contention spike would inflate a
    # single run.
    totals = dict.fromkeys(_STAGES, math.inf)
    for _ in range(repetitions):
        for stage in _STAGES:
            t0 = time.perf_counter()
            run_variant(stage)
            totals[stage] = min(totals[stage], time.perf_counter() - t0)
    times = _split_stages(totals, _n_iterations(cfg, source))
    times.total_wall = time.perf_counter() - wall0
    return times


def _kernel_seconds(fn) -> float:
    """The card's kernel time in one call of ``fn``: the sum of every CUDA
    kernel's device time that ``torch.profiler`` records (nan if it records
    none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e6 if total_us > 0 else math.nan


def profile_fused_device(
    cfg: ICPConfig,
    source: Cloud,
    target: Cloud,
    *,
    seed: int = 0,
    run_benchmark: bool = False,
    kd_index=None,
    device=None,
) -> StageTimes:
    """:func:`profile_fused_stages`' stage split on the card's own time:
    one run of each ``stop_after`` probe under ``torch.profiler``, its
    kernels' device time summed, and the stages differenced as there. The
    card runs the same kernels on the same data in every run, so one run
    of each probe resolves stages far below the host clock's spread; idle
    gaps between kernels count in no stage. ``total_wall`` is the
    profiling's host seconds. ``device`` must be a CUDA device (``None`` =
    the card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"profile_fused_device reads the card's kernel time; got {dev}")
    wall0 = time.perf_counter()
    totals = {stage: _kernel_seconds(lambda stage=stage: icp_mod.run_icp(
        cfg, source, target, seed=seed, run_benchmark=run_benchmark, stop_after=stage,
        kd_index=kd_index, device=dev)) for stage in _STAGES}
    times = _split_stages(totals, _n_iterations(cfg, source))
    times.total_wall = time.perf_counter() - wall0
    return times


def matcher_work_model(cfg: ICPConfig, source: Cloud, target: Cloud, *, seed: int = 0,
                       kd_index=None, device=None):
    """Modelled bytes and f32 operations of the matching kernels at the
    first iteration, from the real first-iteration queries (the driver's
    own selection stage, :func:`icp._queries`, drawn from ``seed`` at the
    first stride, under the identity start pose) and the kernels' own
    membership rules. The prunes skip part of both, so the model is an
    upper bound.

    With ``kd_index``: the kd blocks each 128-query tile (the JAX package's
    ``TILE_Q_DEFAULT``, rows padded to 8 tiles) has among its rows' top-k
    picks within the bound (k = ``checks_to_k`` on the approximate arm,
    ``K_DEFAULT`` on the exact one), and the box ranking of every (query,
    block). Without: the target tiles each ``V2_TILE_Q``-query tile visits
    within the bound (:func:`knn._visit_lists` over ``V2_TILE_T``-row
    tiles). ``visited``, ``n_tiles``, ``nq_pad`` and ``m_flops`` are the
    JAX package's; ``m_bytes`` counts what the port's kernels read, the D
    feature rows of each visited block or tile, where the JAX package
    counts its 8-row TPU page: the JAX figure times D / 8.

    Returns ``(visited, n_tiles, nq_pad, m_bytes, m_flops, label)``."""
    dev = resolve_device(device)
    sources, target = icp_mod.stack_clouds([source.to(dev)]), target.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stride0 = int(cloud_lib.multires_stride_schedule(
        int(source.num_valid()), cfg.n_iterations, cfg.multi_resolution,
        cfg.multi_resolution_min_points)[0])
    sel, _, q = icp_mod._queries(cfg, sources, icp_mod._fuse_cloud_table(sources),
                                 torch.eye(4, device=dev)[None], stride0, gen, None, 0)
    q = (knn.color_features(q, sel.colors) if cfg.color_icp else q)[0]
    bound = knn.bound_value(cfg.max_distance)
    if kd_index is not None:
        kd_index = kdtree.KDIndex(*(None if f is None else f.to(dev) for f in kd_index))
        nc, cap_pad = kd_index.pages.shape[-3], kd_index.pages.shape[-1]
        d = kd_index.block_min.shape[-1]
        tq = cfg.kd_warm_tile_q or kdtree.TILE_Q_DEFAULT
        if cfg.matching_checks > 0:
            kk = kdtree.checks_to_k(cfg.matching_checks, kd_index)
        else:
            kk = min(kdtree.K_DEFAULT, nc)
        qp = knn._pad_rows(knn._pad_features(q), kdtree._PREFIX_GROUP * tq, 0.0)
        lb = knn.box_lb(qp[None, :, :d], kd_index.block_min[None], kd_index.block_max[None])[0]
        sel, _ = kdtree._extract_min(lb, kk)
        sel = sel.long()
        nqt = qp.shape[0] // tq
        rows = torch.arange(qp.shape[0], device=dev)
        hit = (torch.gather(lb, 1, sel) <= bound) & (rows[:, None] < q.shape[0])
        member = torch.zeros((nqt, nc), dtype=torch.int32, device=dev)
        member.index_put_(((rows // tq)[:, None].expand_as(sel), sel), hit.to(torch.int32),
                          accumulate=True)
        visited = int((member > 0).sum())
        m_bytes = visited * d * cap_pad * 4
        m_flops = (visited * cap_pad * tq * (3 * d + 2)   # block distances
                   + q.shape[0] * nc * (3 * d + 2))       # box ranking
        if icp_mod._warm_applies(cfg):
            kind = "warm"
        elif knn.resident_fits(nc, cap_pad):
            kind = "resident"
        else:
            kind = "union"
        if cfg.matching_checks > 0:
            kind += f" approx(checks={cfg.matching_checks}, k={kk})"
        label = (f"  kd {kind} matcher: {visited} member blocks/iter "
                 f"({visited / max(nqt, 1):.1f}/tile of {nc}): "
                 f"modeled {m_bytes / 1e6:.1f} MB, {m_flops / 1e9:.2f} GFLOP")
        return visited, nqt, int(qp.shape[0]), m_bytes, m_flops, label
    tile_t, tile_q, d = knn.V2_TILE_T, knn.V2_TILE_Q, q.shape[-1]
    feats = knn.color_features(target.points, target.colors) if cfg.color_icp else target.points
    index = knn.build_target_index(feats, tile_t=tile_t)
    qp = knn._pad_rows(knn._pad_features(q), tile_q, 0.0)
    nqt = qp.shape[0] // tile_q
    qtiles = qp.reshape(nqt, tile_q, knn.FEATURE_PAD)
    _, _, counts, _ = knn._visit_lists(qtiles.amin(1), qtiles.amax(1), index.bbox_min,
                                       index.bbox_max, bound)
    visited = int(counts.sum())
    m_bytes = visited * d * tile_t * 4
    m_flops = visited * tile_t * tile_q * (3 * d + 2)
    label = (f"  k-NN matcher: {visited} visited tiles/iter, "
             f"modeled {m_bytes / 1e6:.1f} MB, {m_flops / 1e9:.2f} GFLOP")
    return visited, nqt, int(qp.shape[0]), m_bytes, m_flops, label


_TIMINGS = {
    "host": ["times MEASURED on the host's clock (stop-after differencing of the",
             "real driver's runs; where the driver is bound by host dispatch they",
             "are dispatch times, and the rates below understate the kernels')"],
    "device": ["times MEASURED as the card's kernel time (torch.profiler, stop-after",
               "differencing of the real driver's runs)"],
}


def kernel_efficiency(cfg: ICPConfig, source: Cloud, target: Cloud, matching_time: float,
                      solver_time: float, *, seed: int = 0, kd_index=None, device=None,
                      timing: str = "host") -> str:
    """Achieved rates of the matching stage (modelled by
    :func:`matcher_work_model`) and of the normal-equation accumulation
    (about 4 residual rows per query, 6 wide) against their per-iteration
    stage times, as shares of :data:`PEAK_HBM_BYTES` and
    :data:`PEAK_F32_FLOPS`. ``timing`` says what the times are: "host"
    (:func:`profile_fused_stages`) or "device"
    (:func:`profile_fused_device`). The work is a model and the times are
    differences of whole runs, so a share can exceed 100%; the report says
    so."""
    if timing not in _TIMINGS:
        raise ValueError(f"timing must be one of {tuple(_TIMINGS)}, got {timing!r}")
    _, _, n, m_bytes, m_flops, matcher_line = matcher_work_model(
        cfg, source, target, seed=seed, kd_index=kd_index, device=device)
    rows = 4 if cfg.metric != Metric.POINT_TO_POINT else 3
    s_flops = n * rows * (2 * 36 + 2 * 6 + 30)
    s_bytes = n * rows * (6 + 1) * 4 * 2
    # Below ~10 us per iteration a difference is timing noise.
    resolution = 1e-5

    def achieved(nbytes, flops, t):
        if t < resolution:
            return (f"    stage time < {resolution * 1e6:.0f} us/iter: below the "
                    "differencing resolution")
        bw, fl = nbytes / t, flops / t
        line = (f"    achieved {bw / 1e9:7.1f} GB/s ({100 * bw / PEAK_HBM_BYTES:5.1f}% HBM "
                f"peak), {fl / 1e12:6.2f} TFLOP/s ({100 * fl / PEAK_F32_FLOPS:5.1f}% f32 peak)")
        if bw > PEAK_HBM_BYTES or fl > PEAK_F32_FLOPS:
            line += " [>100%: min-estimator understated the stage time]"
        return line

    head, *rest = _TIMINGS[timing]
    return "\n".join([
        f"Kernel efficiency: {head}",
        *rest,
        "byte/FLOP work MODELED from the real iteration-0 membership (an upper",
        "bound: the kernels' running-best prunes skip part of both); peaks:",
        "H100 SXM, 3.35 TB/s HBM and 67 TFLOP/s f32:",
        matcher_line,
        achieved(m_bytes, m_flops, matching_time),
        f"  JTJ accumulate: {n} matches x {rows} rows: "
        f"modeled {s_bytes / 1e6:.2f} MB, {s_flops / 1e9:.3f} GFLOP",
        achieved(s_bytes, s_flops, solver_time),
    ])


class FusedReport(NamedTuple):
    """:func:`fused_report`'s readings and its text."""

    host: StageTimes             # profile_fused_stages
    device: StageTimes | None    # profile_fused_device; None off the card
    text: str


def fused_report(cfg: ICPConfig, source: Cloud, target: Cloud, *, seed: int = 0,
                 repetitions: int = 3, kd_index=None, device=None) -> FusedReport:
    """The fused per-stage breakdown of the real driver on the host's clock
    and, on the card, on its kernel time, and the kernel efficiency report
    over the card's stage times (the host's off the card)."""
    host = profile_fused_stages(cfg, source, target, seed=seed, repetitions=repetitions,
                                kd_index=kd_index, device=device)
    text = ["Host wall clock:", host.report()]
    dev_times = None
    if resolve_device(device).type == "cuda":
        dev_times = profile_fused_device(cfg, source, target, seed=seed, kd_index=kd_index,
                                         device=device)
        text += ["Card kernel time (torch.profiler):", dev_times.report()]
    timed = host if dev_times is None else dev_times
    text.append(kernel_efficiency(cfg, source, target, timed.matching, timed.solver, seed=seed,
                                  kd_index=kd_index, device=device,
                                  timing="host" if dev_times is None else "device"))
    return FusedReport(host, dev_times, "\n".join(text))
