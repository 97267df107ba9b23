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
* :func:`trace` records a ``torch.profiler`` trace of whatever runs inside
  it and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import knn, projective, rejection, selection, weighting
from icp_variants_tpu_torch.pipeline.config import ICPConfig, Matching, Selection
from icp_variants_tpu_torch.pipeline.icp import _solve


@dataclass
class StageTimes:
    """The reference's six accumulators (TimeMeasure.h:20-26), in seconds
    (mean over repetitions), with the JAX package's fields: ``full_run``,
    ``total_wall`` (the whole profiling run) and ``overhead`` (zero
    for the eager harness)."""

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
    Chrome trace; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
