"""The ICP driver loop.

PyTorch port of ``icp_variants_tpu.pipeline.icp`` on the ETH main path,
the dense colour-multires tracker and the projective RGB-D tracker
(``{Ceres,Linear}ICPOptimizer::estimatePose``, ICPOptimizer.h:185-349,
493-663). Each iteration runs

    selection -> transform -> matching -> weighting -> rejection
              -> solve -> left-multiply pose update -> record error

over an explicit leading pair axis B (the JAX package's ``vmap``), and the
iterations are a Python loop (its ``lax.scan``); with ``anderson_m`` > 0
each pair's pose is mixed by Anderson acceleration after every iteration.
The loop makes no host sync (the linear point-to-point solve's
``torch.linalg.svd`` aside, which checks its result on the host): draws
come from a ``torch.Generator`` on the device, the per-iteration
trace is written into preallocated device tensors, and the matcher's
fallback runs unconditionally with frozen rows, so the host queues the
whole run and only the caller's read of the result waits for the device.

Dense multi-resolution runs go through
:func:`run_icp_batch_multires_segmented`: each pyramid level (or group of
coarse levels) runs on the stride-sliced source, and the approximate arm's
block-membership cache threads from a level into the next. On the exact
arm of a dense selection each row's last match rides the iterations in a
granule cache and warm-starts the next search (:func:`_warm_applies`).

Each entry call, its set-up, each pyramid level and each stage of every
iteration run in a span of :mod:`icp_variants_tpu_torch.runtime.spans`
(``icp.call``, ``icp.prepare``, ``icp.level``, ``icp.selection``, ...),
recorded inside ``spans.recording()`` or under a torch profiler.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import kdtree, knn, projective, rejection, selection, weighting
from icp_variants_tpu_torch.parallel.distributed import psum, shard_seed
from icp_variants_tpu_torch.pipeline import measure
from icp_variants_tpu_torch.pipeline.config import (
    ICPConfig,
    Matching,
    Metric,
    Minimizer,
    Selection,
    Weighting,
)
from icp_variants_tpu_torch.runtime import spans
from icp_variants_tpu_torch.solvers import anderson, gauss_newton, linear, procrustes

# Below this size the kd build outweighs the candidate savings.
KD_MIN_POINTS = 20_000
# Past the resident rule the kd path serves sparse compacted selection
# only (the JAX package's rule).
KD_MAX_SELECTION_P = 0.05
# Seed a pyramid level's block membership only from a parent level of at
# most this stride: farther parents cross colour boundaries in the 6-dim
# tree and starve the restricted rows (the JAX package's value).
SEED_MAX_PARENT_STRIDE = 2
# Segment planner cost model of the JAX package's segmented driver: the
# cost of one more program per segment, and of one stride-masked query row
# per iteration. They decide which pyramid levels run together, and with
# it which levels are seeded, so the port keeps the JAX package's values.
SEGMENT_PROGRAM_OVERHEAD_MS = 5.0
SEGMENT_QUERY_COST_MS = 5.6e-5
# The stop_after probes of the fused stage profiler: an iteration ends after
# the named stage (None = the whole iteration).
PROBE_STAGES = ("floor", "selection", "matching", "weighting", "rejection", "solve")


class ICPTrace(NamedTuple):
    """Per-iteration record, (B, T) each (or (T,) from :func:`run_icp`)."""

    rmse: torch.Tensor
    benchmark: torch.Tensor    # Fontana error (0 when not requested)
    num_matches: torch.Tensor  # valid correspondences entering the solver


class ICPResult(NamedTuple):
    pose: torch.Tensor         # (B, 4, 4) or (4, 4) final estimate
    trace: ICPTrace
    # Final matched kd BLOCK id per source row ((B, capacity) int32, -1 =
    # none) when the approximate arm's membership cache ran, else None
    # (also under warm start, whose cache holds target rows).
    match_blocks: torch.Tensor | None = None


def _solve(cfg: ICPConfig, m: weighting.MatchArrays, w: torch.Tensor,
           group=None) -> torch.Tensor:
    """Stages 5+6 (metric + minimizer): the (B, 4, 4) increment applied
    from the left. With ``group`` the match axis is split over its ranks
    and the solvers sum their reductions across them."""
    if cfg.minimizer == Minimizer.NONLINEAR_LM:
        return gauss_newton.estimate_pose_lm(
            cfg.metric, m.src_points, m.tgt_points, m.src_normals, m.tgt_normals, w, m.valid,
            max_iterations=cfg.lm_max_inner_iterations,
            function_tolerance=cfg.lm_function_tolerance, group=group)
    if cfg.metric == Metric.POINT_TO_POINT:
        # Robust weights zero out outliers; the reference's unweighted-mean
        # quirk would feed them into the translation (solvers/procrustes.py).
        return procrustes.estimate_pose_point_to_point(
            m.src_points, m.tgt_points, w, m.valid,
            weighted_means=cfg.weighting in (Weighting.HUBER, Weighting.TUKEY), group=group)
    if cfg.metric == Metric.POINT_TO_PLANE:
        return linear.estimate_pose_point_to_plane(
            m.src_points, m.tgt_points, m.tgt_normals, w, m.valid, group=group)
    if cfg.metric == Metric.GICP:
        return linear.estimate_pose_gicp(
            m.src_points, m.tgt_points, m.src_normals, m.tgt_normals, w, m.valid, group=group)
    return linear.estimate_pose_symmetric(
        m.src_points, m.tgt_points, m.src_normals, m.tgt_normals, w, m.valid, group=group)


def _compact_capacity(n: int, proba: float) -> int:
    """Static query capacity for compacted random selection: expected count
    plus a 10-sigma binomial margin + 64, rounded to a multiple of 128."""
    expected = n * proba
    sigma = (n * proba * (1.0 - proba)) ** 0.5
    k = int(expected + 10.0 * sigma) + 64
    k = ((k + 127) // 128) * 128
    return min(n, k)


def _fuse_cloud_table(cloud: Cloud) -> torch.Tensor:
    """(..., capacity, 8) f32 row table [points | normals | valid | pad], so
    one row gather fetches all three."""
    return torch.cat(
        [
            cloud.points,
            cloud.normals,
            cloud.valid.to(torch.float32)[..., None],
            torch.zeros_like(cloud.points[..., :1]),
        ],
        dim=-1,
    )


def _compact_cloud(
    source: Cloud,
    src_table: torch.Tensor,
    sel_idx: torch.Tensor,
    pre_mask: torch.Tensor,
    need_colors: bool = True,
    *,
    fold_table_valid: bool = True,
    require_finite_normals: bool = False,
) -> tuple[Cloud, torch.Tensor]:
    """Gather the compacted query cloud (B, k) through one fused row gather;
    masked rows' points become the pad sentinel. Returns
    ``(cloud, sel_mask)``."""
    rows = knn.take_rows(src_table, sel_idx)
    sel_mask = pre_mask
    if fold_table_valid:
        sel_mask = sel_mask & (rows[..., 6] > 0.5)
    if require_finite_normals:
        sel_mask = sel_mask & torch.isfinite(rows[..., 3:6]).all(dim=-1)
    colors = (knn.take_rows(source.colors, sel_idx) if need_colors
              else torch.zeros((*sel_idx.shape, 4), device=sel_idx.device))
    return Cloud(
        points=torch.where(sel_mask[..., None], rows[..., :3], cloud_lib.PAD_SENTINEL),
        normals=rows[..., 3:6],
        colors=colors,
        valid=sel_mask,
    ), sel_mask


def _needs_colors(cfg: ICPConfig) -> bool:
    return cfg.weighting == Weighting.COLORS or cfg.color_icp


def _membership_applies(cfg: ICPConfig) -> bool:
    """Whether the approximate arm's per-row block-membership cache rides
    the iterations: dense SELECT_ALL (row identity is stable), checks > 0,
    kd matching, and no COLORS weighting (the JAX package's rule: its
    sorted-domain match table carries no colours). Unseeded, the cache only records each row's
    matched block; seeded (a pyramid level of the segmented driver), each
    row searches exactly its cached block."""
    return (
        cfg.kd_seed_membership
        and cfg.matching == Matching.KNN
        and cfg.matching_checks > 0
        and cfg.selection == Selection.ALL
        and cfg.weighting != Weighting.COLORS
    )


def _warm_applies(cfg: ICPConfig) -> bool:
    """Whether warm-start kd matching runs (the JAX package's rule): dense
    SELECT_ALL, where every row re-seeds its own cache granule each
    iteration, and the exact arm only (on the approximate arm the top-k cap
    already bounds the work the radii would)."""
    return (
        cfg.kd_warm_start
        and cfg.selection == Selection.ALL
        and cfg.matching_checks == 0
    )


def _granule_update(cache: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                    granule: int) -> torch.Tensor:
    """The warm cache after one iteration: each granule of ``granule``
    consecutive rows takes the match of its LAST valid row (the JAX
    package's CPU scatter order, and deterministic on the card, where a
    scatter with duplicate indices is not); granules without a valid row
    keep their slot. ``cache`` (B, G) int32, ``idx`` / ``valid`` (B, N)."""
    b, n = idx.shape
    g = cache.shape[1]
    v = torch.nn.functional.pad(valid, (0, g * granule - n)).reshape(b, g, granule)
    pos = torch.where(v, torch.arange(granule, device=idx.device), -1).amax(-1)
    rows = torch.arange(g, device=idx.device) * granule + pos.clamp(min=0)
    last = torch.gather(idx, 1, rows.clamp(max=n - 1))
    return torch.where(pos >= 0, last.to(cache.dtype), cache)


def _select(cfg, source, src_table, stride, generator, selected, t, index_offset):
    """Stage 1. Returns the (possibly compacted) query cloud and its mask.
    ``index_offset`` is the global number of the source's first row (a
    points shard's), on which the stride lattice is laid."""
    b, cap = source.valid.shape
    base_mask = (cloud_lib.coarse_stride_mask(source, stride, index_offset)
                 if cfg.multi_resolution else source.valid)
    if cfg.selection == Selection.RANDOM and cfg.compact_queries:
        if selected is not None:
            sel_idx, in_range = selected[0][:, t], selected[1][:, t]
        else:
            k_cap = _compact_capacity(cap, cfg.selection_proba)
            sel_idx, in_range = selection.bernoulli_gap_indices(
                generator, cfg.selection_proba,
                stride if cfg.multi_resolution else 1, cap, k_cap, index_offset,
                batch=(b,), device=source.points.device)
        return _compact_cloud(
            source, src_table, sel_idx, in_range, _needs_colors(cfg),
            require_finite_normals=cfg.multi_resolution)
    if cfg.selection == Selection.RANDOM:
        return source, selection.random_sampling(generator, base_mask, cfg.selection_proba)
    if cfg.selection == Selection.RANDOM_FAST:
        k_cap = _compact_capacity(cap, cfg.selection_proba)
        n_draw = min(int(cap * cfg.selection_proba + 0.5), k_cap)
        sel_idx, draw_mask = selection.random_indices(
            generator, cap, n_draw, k_cap, batch=(b,), device=source.points.device)
        if cfg.multi_resolution:
            pre = draw_mask & torch.gather(base_mask, 1, sel_idx.long())
        else:
            pre = draw_mask
        return _compact_cloud(
            source, src_table, sel_idx, pre, _needs_colors(cfg),
            fold_table_valid=not cfg.multi_resolution)
    return source, selection.select_all(base_mask)


def _queries(cfg, source, src_table, pose, stride, generator, selected, t, index_offset=0):
    """Stage 1 and the transform (ICPOptimizer.h:251-252): ``(source,
    sel_mask, src_pts)``, the (possibly compacted) query cloud, its mask and
    its points under ``pose``, masked queries pinned to the first valid one
    so they keep query tiles spatially tight (to row 0 where none is: a
    points shard of padding only)."""
    source, sel_mask = _select(cfg, source, src_table, stride, generator, selected, t,
                               index_offset)
    src_pts = se3.transform_points(source.points, pose)
    first = torch.argmax(sel_mask.to(torch.uint8), dim=-1)
    anchor = knn.take_rows(src_pts, first[:, None])
    return source, sel_mask, torch.where(sel_mask[..., None], src_pts, anchor)


def _match_kd_stage(cfg, q, kd_index, target_index, sel_mask, cache, seeded, target_feats):
    """kd matching stage; returns ``(idx, d2, valid, new_cache)`` with idx
    the original target row. ``cache`` is None for the cold search,
    :func:`kdtree.match_kd`.

    Under :func:`_membership_applies` ``cache`` (B, capacity) int32 is the
    approximate arm's block-membership cache. Seeded, each row searches
    exactly its cached block (:func:`kdtree.match_kd_cached`, no box
    ranking); unseeded, the k-capped search runs and only records each row's
    matched block. Either way the search answers in the sorted page domain,
    the block is read from it, and a row keeps its last block when an
    iteration finds no match.

    Under :func:`_warm_applies` ``cache`` (B, ceil(capacity / granule))
    int32 is the warm cache: row i reads slot ``i // kd_warm_granule``, a
    matched target row (-1 = none), and searches within the exact distance
    to it in ``target_feats`` (:func:`kdtree.match_kd_warm`, with the
    fallback through ``target_index``); then each slot takes the match of
    its granule's last valid row (:func:`_granule_update`)."""
    if cache is None:
        idx, d2, valid = kdtree.match_kd(
            q, kd_index, target_index, cfg.max_distance, query_mask=sel_mask,
            checks=cfg.matching_checks)
        return idx, d2, valid, None
    if _membership_applies(cfg):
        if seeded:
            sidx, d2, valid = kdtree.match_kd_cached(
                q, kd_index, cfg.max_distance, cache, query_mask=sel_mask)
        else:
            sidx, d2, valid = kdtree.match_kd(
                q, kd_index, target_index, cfg.max_distance, query_mask=sel_mask,
                checks=cfg.matching_checks, orig_map=False)
        cache = torch.where(sidx >= 0, sidx // kd_index.pages.shape[-1], cache)
        return kdtree.to_orig(kd_index, sidx), d2, valid, cache
    granules = torch.arange(q.shape[1], device=q.device) // cfg.kd_warm_granule
    idx, d2, valid = kdtree.match_kd_warm(
        q, kd_index, cfg.max_distance, cache[:, granules], target_feats,
        query_mask=sel_mask, fallback_index=target_index, checks=cfg.matching_checks)
    return idx, d2, valid, _granule_update(cache, idx, valid, cfg.kd_warm_granule)


def _iteration(
    cfg: ICPConfig,
    source: Cloud,
    target: Cloud,
    pose: torch.Tensor,
    stride: int,
    generator: torch.Generator | None,
    selected,
    t: int,
    gt_src: torch.Tensor,
    gt_tgt: torch.Tensor,
    gt_valid: torch.Tensor,
    run_benchmark: bool,
    target_index: knn.TargetIndex | None,
    kd_index: kdtree.KDIndex | None,
    src_table: torch.Tensor,
    tgt_table: torch.Tensor,
    cache: torch.Tensor | None,
    seeded: bool,
    target_feats: torch.Tensor | None,
    trace: ICPTrace,
    stop_after: str | None = None,
    group=None,
    shard_index: int = 0,
):
    """One pipeline iteration over all B pairs: writes iteration ``t`` of
    the (B, T) ``trace`` buffers (rmse, benchmark error, match count) and
    returns ``(new_pose, cache)``. ``cache`` / ``seeded`` are the
    membership or warm cache and ``target_feats`` the warm cache's feature
    table (see :func:`_match_kd_stage`).

    ``group`` (None = one device): the ranks the source rows are split
    over, this rank holding shard ``shard_index``. Its rows are numbered
    from ``shard_index * capacity`` on the stride lattice and in the gap
    draws; the weighting, rejection, solve and error reductions and the
    match count sum across the group, so every rank gets the same pose.

    ``stop_after`` (one of :data:`PROBE_STAGES`) ends the iteration after
    that stage, as the JAX package's stage probes do: the pose comes back
    unchanged (the solve's probe: updated), the cache as it stands, and
    :func:`_probe_trace` writes the stage's checksum.

    Each stage runs in its :mod:`~icp_variants_tpu_torch.runtime.spans`
    span (``icp.selection``, ``icp.matching``, ``icp.weighting``,
    ``icp.rejection``, ``icp.solve``, ``icp.measure``)."""
    # No anti-hoisting pose epsilon (JAX icp.py:487-503): eager PyTorch hoists nothing.
    if stop_after == "floor":
        return _probe_trace(trace, t, pose, pose.sum((-2, -1)), cache)
    with spans.span("icp.selection"):
        source, sel_mask, src_pts = _queries(cfg, source, src_table, pose, stride, generator,
                                             selected, t, shard_index * source.capacity)
        src_nrm = se3.transform_normals(source.normals, pose)
    if stop_after == "selection":
        return _probe_trace(trace, t, pose, src_pts.sum((-2, -1)) + src_nrm.sum((-2, -1)), cache)

    # --- stage 2: matching: the projective window search against the
    # image-shaped target, else k-NN, over the 6-dim colour features under
    # color-ICP (NearestNeighbor.h:212-224) ------------------------------------
    with spans.span("icp.matching"):
        if cfg.matching == Matching.PROJECTIVE:
            idx, d2, valid = projective.projective_match(
                src_pts, target.points, target.valid, fx=cfg.projective_fx,
                fy=cfg.projective_fy, cx=cfg.projective_cx, cy=cfg.projective_cy,
                width=cfg.projective_width, height=cfg.projective_height,
                window=cfg.projective_window, max_distance=cfg.max_distance,
                query_mask=sel_mask, chunk=cfg.projective_chunk or projective.CHUNK)
        else:
            q = knn.color_features(src_pts, source.colors) if cfg.color_icp else src_pts
            if kd_index is not None:
                idx, d2, valid, cache = _match_kd_stage(
                    cfg, q, kd_index, target_index, sel_mask, cache, seeded, target_feats)
            else:
                idx, d2, valid = knn.match_indexed(
                    q, target_index, cfg.max_distance, query_mask=sel_mask)
        if stop_after == "matching":
            return _probe_trace(trace, t, pose, d2.sum(-1) + idx.sum(-1) + valid.sum(-1), cache)
        idx = torch.clamp(idx, 0, tgt_table.shape[-2] - 1)
        tgt_rows = knn.take_rows(tgt_table, idx)
        valid = valid & (tgt_rows[..., 6] > 0.5)
        m = weighting.MatchArrays(
            src_points=src_pts,
            tgt_points=tgt_rows[..., :3],
            src_normals=src_nrm,
            tgt_normals=tgt_rows[..., 3:6],
            src_colors=source.colors,
            tgt_colors=(knn.take_rows(target.colors, idx)
                        if cfg.weighting == Weighting.COLORS
                        else torch.zeros_like(source.colors)),
            valid=valid,
        )

    # --- stage 3: weighting; stage 4: rejection ------------------------------
    with spans.span("icp.weighting"):
        w = weighting.apply_weights(cfg.weighting, m, cfg.max_distance, group=group)
    if stop_after == "weighting":
        return _probe_trace(trace, t, pose, w.sum(-1) + m.tgt_points.sum((-2, -1)), cache)
    with spans.span("icp.rejection"):
        if cfg.rejection:
            m = m._replace(
                valid=rejection.normal_angle_mask(m.src_normals, m.tgt_normals, m.valid))
        if cfg.trim_ratio < 1.0:
            m = m._replace(valid=rejection.trimmed_mask(
                d2, m.valid, cfg.trim_ratio, cfg.max_distance, group=group))
    if stop_after == "rejection":
        return _probe_trace(
            trace, t, pose, w.sum(-1) + m.valid.sum(-1) + m.tgt_points.sum((-2, -1)), cache)

    # --- stages 5+6: solve + left-multiplied pose update ---------------------
    with spans.span("icp.solve"):
        increment = _solve(cfg, m, w, group)
        new_pose = increment @ pose
    if stop_after == "solve":
        return _probe_trace(trace, t, new_pose, increment.sum((-2, -1)), cache)

    # The ground-truth rows are split alongside the source's.
    with spans.span("icp.measure"):
        rmse = measure.rmse_alignment_error(new_pose, gt_src, gt_tgt, gt_valid, group=group)
        bench = (measure.benchmark_error(new_pose, gt_src, gt_tgt, gt_valid, group=group)
                 if run_benchmark else torch.zeros_like(rmse))
        num_matches = psum(torch.sum(m.valid, dim=-1, dtype=torch.int32), group)
        trace.rmse[:, t], trace.benchmark[:, t], trace.num_matches[:, t] = rmse, bench, num_matches
    return new_pose, cache


def _probe_trace(trace, t, pose, checksum, cache):
    """A stage probe's iteration: the (B,) checksum of the stage's outputs
    written into iteration ``t`` of ``trace``'s rmse, zero benchmark and
    match counts; returns the pose and the cache."""
    checksum = checksum.to(torch.float32)
    trace.rmse[:, t], trace.benchmark[:, t], trace.num_matches[:, t] = (
        checksum, torch.zeros_like(checksum),
        torch.zeros(checksum.shape, dtype=torch.int32, device=checksum.device))
    return pose, cache


def stack_clouds(clouds) -> Cloud:
    """Stack equal-capacity Clouds along a new leading pair axis."""
    return Cloud(*(torch.stack(f) for f in zip(*clouds)))


def run_icp_batch(
    cfg: ICPConfig,
    sources: Cloud,
    targets: Cloud,
    init_poses=None,
    *,
    gt_source_points=None,
    gt_target_points=None,
    gt_valid=None,
    generator: torch.Generator | None = None,
    seed: int = 0,
    run_benchmark: bool = False,
    num_source_points: int | None = None,
    kd_indexes: kdtree.KDIndex | None = None,
    selected: tuple[torch.Tensor, torch.Tensor] | None = None,
    strides: np.ndarray | None = None,
    membership_seed=None,
    stop_after: str | None = None,
    device=None,
    group=None,
    shard_index: int = 0,
) -> ICPResult:
    """Register a batch of B scan pairs; every Cloud field carries the
    leading pair axis. The ETH sweep's data-parallel runner, and one level
    of the segmented multires driver.

    ``device`` (``None`` = the card) is where the run happens; clouds and
    kd indexes are moved there if needed. Random selection draws from
    ``generator`` (default: a new generator on ``device`` seeded with
    ``seed``). ``selected = (sel_idx, in_range)``, each (B, T, k_cap),
    replaces the draws of compacted RANDOM selection — the parity tests
    feed the JAX package's own draws through it. ``kd_indexes`` (a stacked
    :class:`kdtree.KDIndex`, see :func:`build_kd_for`) switches matching
    to the kd path; under color-ICP the kd index and the tile index cover
    the 6-dim colour features. ``num_source_points`` seeds the multires
    schedule (default: the padded capacity); ``strides`` overrides it.

    On the approximate arm of a dense selection (:func:`_membership_applies`,
    within the JAX package's resident rule) each row's matched kd block
    rides the iterations and comes back as ``ICPResult.match_blocks``;
    ``membership_seed`` ((B, capacity) int, -1 = none) seeds it, and each
    row then searches exactly its cached block. On the exact arm of a dense
    selection (:func:`_warm_applies`) with a kd index the warm cache rides
    instead, starting empty; ``match_blocks`` is then None.

    ``stop_after`` (one of :data:`PROBE_STAGES`) ends every iteration after
    that stage (the fused stage profiler's probes, :func:`_iteration`): the
    trace then holds the stage's checksum in ``rmse`` and zeros in
    ``benchmark`` and ``num_matches``, and the results are no registration.

    ``group`` (None = one device) splits each pair's source rows, and the
    ground-truth rows with them, over the ranks of a process group: the
    clouds here are this rank's shard ``shard_index`` (targets and kd
    indexes whole), and the reductions of every iteration sum across the
    group (:func:`_iteration`), so each rank returns the same poses and
    traces. The default generator's seed is then
    ``distributed.shard_seed(seed, shard_index)``, and ``selected`` holds
    this shard's own draws (its rows numbered from 0).
    :mod:`icp_variants_tpu_torch.parallel.sharded_icp` lays the shards out."""
    if stop_after is not None and stop_after not in PROBE_STAGES:
        raise ValueError(f"stop_after must be None or one of {PROBE_STAGES}, got {stop_after!r}")
    if cfg.matching == Matching.PROJECTIVE and (
            targets.capacity != cfg.projective_width * cfg.projective_height):
        raise ValueError(
            f"projective matching needs image-shaped targets of "
            f"{cfg.projective_width} x {cfg.projective_height} rows, got {targets.capacity}")
    with spans.call():
        with spans.span("icp.prepare"):
            dev = resolve_device(device)
            sources, targets = sources.to(dev), targets.to(dev)
            if kd_indexes is not None:
                kd_indexes = kdtree.KDIndex(
                    *(None if f is None else f.to(dev) for f in kd_indexes))
            b, cap = sources.valid.shape
            if init_poses is None:
                init_poses = torch.eye(4, dtype=torch.float32, device=dev).expand(b, 4, 4)
            pose = torch.as_tensor(init_poses, dtype=torch.float32).to(dev).contiguous()
            if gt_source_points is None:
                gt_src = torch.zeros((b, 1, 3), device=dev)
                gt_tgt = torch.zeros((b, 1, 3), device=dev)
                gtv = torch.ones((b, 1), dtype=torch.bool, device=dev)
            else:
                gt_src = torch.as_tensor(gt_source_points, dtype=torch.float32).to(dev)
                gt_tgt = torch.as_tensor(gt_target_points, dtype=torch.float32).to(dev)
                gtv = (torch.ones(gt_src.shape[:2], dtype=torch.bool, device=dev)
                       if gt_valid is None else torch.as_tensor(gt_valid, dtype=torch.bool).to(dev))
            if strides is None:
                strides = cloud_lib.multires_stride_schedule(
                    cap if num_source_points is None else num_source_points,
                    cfg.n_iterations, cfg.multi_resolution, cfg.multi_resolution_min_points)
            strides = [int(s) for s in np.asarray(strides)]
            n_iter = len(strides)
            if selected is not None:
                if not (cfg.selection == Selection.RANDOM and cfg.compact_queries):
                    raise ValueError("selected= replaces compacted RANDOM selection draws only")
                k_cap = _compact_capacity(cap, cfg.selection_proba)
                want = (b, n_iter, k_cap)
                if tuple(selected[0].shape) != want or tuple(selected[1].shape) != want:
                    raise ValueError(f"selected arrays must be {want}")
                selected = (torch.as_tensor(selected[0]).to(dev, torch.int32),
                            torch.as_tensor(selected[1]).to(dev, torch.bool))
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(
                    seed if group is None else shard_seed(seed, shard_index))

            target_index = feats = None
            if cfg.matching == Matching.KNN:
                feats = (knn.color_features(targets.points, targets.colors) if cfg.color_icp
                         else targets.points)
                target_index = knn.build_target_index(feats, tile_t=knn.V2_TILE_T)
            src_table = _fuse_cloud_table(sources)
            tgt_table = _fuse_cloud_table(targets)

            cache, seeded, emit_blocks = None, False, False
            if (kd_indexes is not None and _membership_applies(cfg)
                    and knn.resident_fits(kd_indexes.pages.shape[1], kd_indexes.pages.shape[-1])):
                seeded, emit_blocks = membership_seed is not None, True
                if seeded:
                    cache = torch.as_tensor(membership_seed).to(dev, torch.int32)
                    if tuple(cache.shape) != (b, cap):
                        raise ValueError(f"membership_seed must be {(b, cap)}, "
                                         f"got {tuple(cache.shape)}")
                else:
                    cache = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
            elif kd_indexes is not None and _warm_applies(cfg):
                n_granules = -(-cap // cfg.kd_warm_granule)
                cache = torch.full((b, n_granules), -1, dtype=torch.int32, device=dev)
            rmse = torch.empty((b, n_iter), dtype=torch.float32, device=dev)
            bench = torch.empty_like(rmse)
            num_matches = torch.empty((b, n_iter), dtype=torch.int32, device=dev)
            # Anderson acceleration: a fresh mixing state per call (so per level
            # of the segmented pyramid), one per pair; anderson_m == 0 keeps the
            # plain fixed-point iteration.
            aa = anderson.init_like(cfg.anderson_m, pose) if cfg.anderson_m > 0 else None
        trace = ICPTrace(rmse=rmse, benchmark=bench, num_matches=num_matches)
        for t, stride in enumerate(strides):
            new_pose, cache = _iteration(
                cfg, sources, targets, pose, stride, generator, selected, t,
                gt_src, gt_tgt, gtv, run_benchmark, target_index, kd_indexes,
                src_table, tgt_table, cache, seeded, feats, trace, stop_after=stop_after,
                group=group, shard_index=shard_index,
            )
            if aa is not None:
                # The trace holds the plain step's pose (the fixed-point
                # evaluation); the carried pose is the mixed one. The mixing is
                # elementwise on the pose, the same on every rank of a group.
                with spans.span("icp.anderson"):
                    aa, x_next = anderson.step(aa, anderson.pose_to_vec(pose),
                                               anderson.pose_to_vec(new_pose), cfg.anderson_m)
                    new_pose = anderson.vec_to_pose(x_next)
            pose = new_pose
        return ICPResult(pose=pose, trace=trace, match_blocks=cache if emit_blocks else None)


def run_icp(
    cfg: ICPConfig,
    source: Cloud,
    target: Cloud,
    init_pose=None,
    *,
    gt_source_points=None,
    gt_target_points=None,
    gt_valid=None,
    generator: torch.Generator | None = None,
    seed: int = 0,
    run_benchmark: bool = False,
    num_source_points: int | None = None,
    kd_index: kdtree.KDIndex | None = None,
    stop_after: str | None = None,
    device=None,
) -> ICPResult:
    """Estimate the pose aligning one ``source`` onto ``target``
    (``ICPOptimizer::estimatePose``): :func:`run_icp_batch` with B = 1.
    The multires base size defaults to the source's valid count.
    ``stop_after``: the stage probes of :func:`run_icp_batch`."""
    dev = resolve_device(device)

    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    if num_source_points is None:
        num_source_points = int(source.num_valid())
    res = run_icp_batch(
        cfg, stack_clouds([source]), stack_clouds([target]), one(init_pose),
        gt_source_points=one(gt_source_points), gt_target_points=one(gt_target_points),
        gt_valid=one(gt_valid), generator=generator, seed=seed,
        run_benchmark=run_benchmark, num_source_points=num_source_points,
        kd_indexes=None if kd_index is None else kdtree.stack_kd_indexes([kd_index]),
        stop_after=stop_after, device=dev,
    )
    return ICPResult(pose=res.pose[0], trace=ICPTrace(*(x[0] for x in res.trace)),
                     match_blocks=None if res.match_blocks is None else res.match_blocks[0])


def _kd_resident_will_run(cfg: ICPConfig, capacity: int) -> bool:
    """Whether a target of this capacity falls within the JAX package's
    resident rule (:func:`knn.resident_fits`, one-block or packed pages;
    page-table shapes depend on the capacity alone)."""
    depth = kdtree.kd_depth_for(
        capacity, cfg.kd_block_target or kdtree.default_block_target(
            cfg.color_icp, cfg.matching_checks > 0))
    nc = 1 << depth
    cap_pad = ((-(-capacity // nc)) + 127) // 128 * 128
    return knn.resident_fits(nc, cap_pad) or knn.resident_fits(
        nc, cap_pad, d=6 if cfg.color_icp else 3)


def _kd_selection_applies(cfg: ICPConfig, capacity: int) -> bool:
    """Whether the per-query kd path serves this selection: any selection
    when the target capacity is within the resident rule, sparse compacted
    random selection otherwise. The rule fixes which answer a configuration
    gets (on the approximate arm the kd path returns the top-1 block's best,
    not the exact neighbour), so the port copies the JAX package's rule to
    give its results; it chooses no kernel."""
    if _kd_resident_will_run(cfg, capacity):
        return True
    if cfg.selection not in (Selection.RANDOM, Selection.RANDOM_FAST):
        return False
    if cfg.selection_proba > KD_MAX_SELECTION_P:
        return False
    if cfg.selection == Selection.RANDOM and not cfg.compact_queries:
        return False
    return True


def build_kd_for(
    cfg: ICPConfig, target: Cloud, min_points: int = KD_MIN_POINTS, device=None
) -> kdtree.KDIndex | None:
    """Host-side kd build for the production matching path: a
    :class:`kdtree.KDIndex` over ``target`` (over its 6-dim colour features
    under color-ICP) on ``device`` (``None`` = the card) when k-NN matching
    is configured, :func:`_kd_selection_applies` holds at the target's
    capacity and the cloud is large enough; ``None`` otherwise."""
    dev = resolve_device(device)
    if cfg.matching != Matching.KNN or not _kd_selection_applies(cfg, target.capacity):
        return None
    valid = target.valid.detach().cpu().numpy()
    if int(valid.sum()) < min_points:
        return None
    if cfg.color_icp:
        feats = knn.color_features(target.points, target.colors)
    else:
        feats = target.points
    return kdtree.build_kd_index(
        feats.detach().cpu().numpy(), valid,
        block_target=cfg.kd_block_target or kdtree.default_block_target(
            cfg.color_icp, cfg.matching_checks > 0),
        device=dev,
    )


# ---------------------------------------------------------------------------
# The segmented multires driver (dense SELECT_ALL pyramids)
# ---------------------------------------------------------------------------


def _stride_groups(strides) -> list[tuple[int, int]]:
    """Consecutive (stride, count) runs of a multires schedule."""
    groups: list[list[int]] = []
    for s in np.asarray(strides).tolist():
        if groups and groups[-1][0] == s:
            groups[-1][1] += 1
        else:
            groups.append([int(s), 1])
    return [(s, c) for s, c in groups]


def _slice_clouds_stride(clouds: Cloud, stride: int) -> Cloud:
    """The stride-lattice subclouds (rows i with i % stride == 0) as
    compact clouds; the finite-normal part of ``coarse_stride_mask`` folds
    into ``valid``."""
    finite = torch.isfinite(clouds.normals).all(dim=-1)
    return Cloud(
        points=clouds.points[:, ::stride].contiguous(),
        normals=clouds.normals[:, ::stride].contiguous(),
        colors=clouds.colors[:, ::stride].contiguous(),
        valid=(clouds.valid & finite)[:, ::stride].contiguous(),
    )


def _level_seed(blk: torch.Tensor, stride: int, prev_stride: int, cap_l: int) -> torch.Tensor:
    """Membership seed of a pyramid level from its parent level's matched
    blocks ``blk`` (B, parent capacity): fine row j takes parent row
    ``j * stride // prev_stride``. Rows whose parent never matched (-1)
    borrow the nearest seeded neighbour's block in log steps, clamped at
    the array edges (a wrap would hand edge rows a block from the other end
    of the cloud); rows with no seeded neighbour within 63 stay -1."""
    dev = blk.device
    n_parent = blk.shape[1]
    parent = torch.clamp(
        torch.arange(cap_l, dtype=torch.int64, device=dev) * stride // prev_stride,
        max=n_parent - 1)
    seed = blk[:, parent]
    rows = torch.arange(cap_l, device=dev)
    for shift in (1, 2, 4, 8, 16, 32):
        fwd = seed[:, torch.clamp(rows + shift, max=cap_l - 1)]
        bwd = seed[:, torch.clamp(rows - shift, min=0)]
        seed = torch.where(seed >= 0, seed, torch.where(fwd >= 0, fwd, bwd))
    return seed


def _plan_segments(levels, num_points, protect_tail=0):
    """Partition a schedule's consecutive [(stride, count), ...] runs into
    segments, each run as one :func:`run_icp_batch` call on the slice of
    the segment's finest stride, its coarser members stride-masked. A run
    joins the open segment while the extra masked rows cost less than
    ``SEGMENT_PROGRAM_OVERHEAD_MS`` (the JAX package's cost model, kept
    because the plan decides which levels are seeded). ``protect_tail``
    keeps the last N runs as single segments: the membership seed hands
    over from the stride-2 level to the stride-1 level between calls."""

    def extra_ms(seg, slice_stride):
        cap = num_points / slice_stride
        return sum(c * (cap - num_points / s) * SEGMENT_QUERY_COST_MS for s, c in seg)

    protect_tail = min(protect_tail, len(levels))
    head = levels[:len(levels) - protect_tail] if protect_tail else levels
    segments, cur = [], []
    for s, c in head:
        if cur:
            delta = extra_ms(cur + [(s, c)], s) - extra_ms(cur, cur[-1][0])
            if delta < SEGMENT_PROGRAM_OVERHEAD_MS:
                cur.append((s, c))
                continue
            segments.append(cur)
        cur = [(s, c)]
    if cur:
        segments.append(cur)
    for s, c in levels[len(levels) - protect_tail:] if protect_tail else []:
        segments.append([(s, c)])
    return segments


def run_icp_batch_multires_segmented(
    cfg: ICPConfig,
    sources: Cloud,
    targets: Cloud,
    init_poses=None,
    *,
    generator: torch.Generator | None = None,
    seed: int = 0,
    num_source_points: int | None = None,
    kd_indexes: kdtree.KDIndex | None = None,
    run_benchmark: bool = False,
    gt_source_points=None,
    gt_target_points=None,
    gt_valid=None,
    device=None,
) -> ICPResult:
    """Dense (SELECT_ALL) multi-resolution registration, level by level:
    each segment of :func:`_plan_segments` runs :func:`run_icp_batch` on
    the stride-sliced sources (coarser members of a grouped segment
    stride-masked), threading the poses; targets and kd indexes are shared.
    On the approximate arm with the membership cache, a level whose parent
    level's stride is at most ``SEED_MAX_PARENT_STRIDE`` is seeded from the
    parent's matched blocks (:func:`_level_seed`). ``match_blocks`` of the
    result is the last level's (None without the cache).

    Other configurations fall through to :func:`run_icp_batch`. ``device``
    (``None`` = the card) is where the run happens."""
    common = dict(generator=generator, run_benchmark=run_benchmark,
                  gt_source_points=gt_source_points, gt_target_points=gt_target_points,
                  gt_valid=gt_valid)
    if not (cfg.multi_resolution and cfg.selection == Selection.ALL):
        return run_icp_batch(cfg, sources, targets, init_poses, seed=seed,
                             num_source_points=num_source_points, kd_indexes=kd_indexes,
                             device=device, **common)
    with spans.call():
        with spans.span("icp.prepare"):
            dev = resolve_device(device)
            sources, targets = sources.to(dev), targets.to(dev)
            if kd_indexes is not None:
                kd_indexes = kdtree.KDIndex(
                    *(None if f is None else f.to(dev) for f in kd_indexes))
            if num_source_points is None:
                num_source_points = sources.capacity
            strides = cloud_lib.multires_stride_schedule(
                num_source_points, cfg.n_iterations, True, cfg.multi_resolution_min_points)
            protect = 2 if _membership_applies(cfg) else 0
            segments = _plan_segments(_stride_groups(strides), num_source_points,
                                      protect_tail=protect)
        poses, traces = init_poses, []
        blk, prev_stride, res = None, None, None
        for li, seg in enumerate(segments):
            s_min = seg[-1][0]
            n_it = sum(c for _, c in seg)
            if len(seg) == 1:
                cfg_l = cfg.replace(multi_resolution=False, n_iterations=n_it)
                seg_strides = None
            else:
                cfg_l = cfg.replace(multi_resolution=True, n_iterations=n_it)
                seg_strides = np.concatenate([np.full(c, s // s_min, np.int32) for s, c in seg])
            with spans.span("icp.level"):
                src_l = _slice_clouds_stride(sources, s_min)
                level_seed = None
                if (blk is not None and prev_stride <= SEED_MAX_PARENT_STRIDE
                        and _membership_applies(cfg_l)):
                    level_seed = _level_seed(blk, s_min, prev_stride, src_l.capacity)
            res = run_icp_batch(cfg_l, src_l, targets, poses, seed=seed + li,
                                kd_indexes=kd_indexes, membership_seed=level_seed,
                                strides=seg_strides, device=dev, **common)
            poses = res.pose
            traces.append(res.trace)
            if res.match_blocks is not None:
                blk, prev_stride = res.match_blocks, s_min
        trace = ICPTrace(*(torch.cat(xs, dim=1) for xs in zip(*traces)))
        return ICPResult(pose=poses, trace=trace, match_blocks=res.match_blocks)


def run_icp_multires_segmented(
    cfg: ICPConfig,
    source: Cloud,
    target: Cloud,
    init_pose=None,
    *,
    gt_source_points=None,
    gt_target_points=None,
    gt_valid=None,
    generator: torch.Generator | None = None,
    seed: int = 0,
    run_benchmark: bool = False,
    num_source_points: int | None = None,
    kd_index: kdtree.KDIndex | None = None,
    device=None,
) -> ICPResult:
    """Single-pair counterpart of :func:`run_icp_batch_multires_segmented`
    (falls through to :func:`run_icp` for any other configuration)."""
    if not (cfg.multi_resolution and cfg.selection == Selection.ALL):
        return run_icp(cfg, source, target, init_pose, gt_source_points=gt_source_points,
                       gt_target_points=gt_target_points, gt_valid=gt_valid,
                       generator=generator, seed=seed, run_benchmark=run_benchmark,
                       num_source_points=num_source_points, kd_index=kd_index, device=device)

    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    res = run_icp_batch_multires_segmented(
        cfg, stack_clouds([source]), stack_clouds([target]), one(init_pose),
        generator=generator, seed=seed, num_source_points=num_source_points,
        kd_indexes=None if kd_index is None else kdtree.stack_kd_indexes([kd_index]),
        run_benchmark=run_benchmark, gt_source_points=one(gt_source_points),
        gt_target_points=one(gt_target_points), gt_valid=one(gt_valid), device=device)
    return ICPResult(pose=res.pose[0], trace=ICPTrace(*(x[0] for x in res.trace)),
                     match_blocks=None if res.match_blocks is None else res.match_blocks[0])
