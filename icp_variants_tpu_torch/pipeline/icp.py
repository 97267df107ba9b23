"""The ICP driver loop.

PyTorch port of ``icp_variants_tpu.pipeline.icp`` on the ETH main path
(``{Ceres,Linear}ICPOptimizer::estimatePose``, ICPOptimizer.h:185-349,
493-663). Each iteration runs

    selection -> transform -> matching -> weighting -> rejection
              -> solve -> left-multiply pose update -> record error

over an explicit leading pair axis B (the JAX package's ``vmap``), and the
iterations are a Python loop (its ``lax.scan``). The loop makes no host
sync: draws come from a ``torch.Generator`` on the device, the per-iteration
trace is written into preallocated device tensors, and the matcher's
fallback runs unconditionally with frozen rows, so the host queues the
whole run and only the caller's read of the result waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import kdtree, knn, rejection, selection, weighting
from icp_variants_tpu_torch.pipeline import measure
from icp_variants_tpu_torch.pipeline.config import (
    ICPConfig,
    Matching,
    Metric,
    Minimizer,
    Selection,
    Weighting,
)
from icp_variants_tpu_torch.solvers import linear

# Below this size the kd build outweighs the candidate savings.
KD_MIN_POINTS = 20_000
# The kd path serves sparse compacted selection (the JAX package's rule).
KD_MAX_SELECTION_P = 0.05


class ICPTrace(NamedTuple):
    """Per-iteration record, (B, T) each (or (T,) from :func:`run_icp`)."""

    rmse: torch.Tensor
    benchmark: torch.Tensor    # Fontana error (0 when not requested)
    num_matches: torch.Tensor  # valid correspondences entering the solver


class ICPResult(NamedTuple):
    pose: torch.Tensor         # (B, 4, 4) or (4, 4) final estimate
    trace: ICPTrace


def _solve(cfg: ICPConfig, m: weighting.MatchArrays, w: torch.Tensor) -> torch.Tensor:
    """Stages 5+6 (metric + minimizer): the (B, 4, 4) increment applied
    from the left. Only the linear plane and symmetric metrics are ported."""
    if cfg.minimizer != Minimizer.LINEAR:
        raise NotImplementedError(
            "the LM minimizer (solvers/gauss_newton.py) is not ported yet: "
            "ROADMAP.md queue 1 item 12")
    if cfg.metric == Metric.POINT_TO_PLANE:
        return linear.estimate_pose_point_to_plane(
            m.src_points, m.tgt_points, m.tgt_normals, w, m.valid)
    if cfg.metric == Metric.SYMMETRIC:
        return linear.estimate_pose_symmetric(
            m.src_points, m.tgt_points, m.src_normals, m.tgt_normals, w, m.valid)
    if cfg.metric == Metric.POINT_TO_POINT:
        raise NotImplementedError(
            "linear point-to-point (solvers/procrustes.py) is not ported yet: "
            "ROADMAP.md queue 1 item 6")
    raise NotImplementedError(
        "the linear GICP metric is not ported yet: ROADMAP.md queue 1 item 6")


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
    """The JAX package's approximate-arm block-membership cache condition
    (dense SELECT_ALL + checks > 0); that mode is not ported yet."""
    return (
        cfg.kd_seed_membership
        and cfg.matching == Matching.KNN
        and cfg.matching_checks > 0
        and cfg.selection == Selection.ALL
        and cfg.weighting != Weighting.COLORS
    )


def _select(cfg, source, src_table, stride, generator, selected, t):
    """Stage 1. Returns the (possibly compacted) query cloud and its mask."""
    b, cap = source.valid.shape
    base_mask = (cloud_lib.coarse_stride_mask(source, stride)
                 if cfg.multi_resolution else source.valid)
    if cfg.selection == Selection.RANDOM and cfg.compact_queries:
        if selected is not None:
            sel_idx, in_range = selected[0][:, t], selected[1][:, t]
        else:
            k_cap = _compact_capacity(cap, cfg.selection_proba)
            sel_idx, in_range = selection.bernoulli_gap_indices(
                generator, cfg.selection_proba,
                stride if cfg.multi_resolution else 1, cap, k_cap,
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
):
    """One pipeline iteration over all B pairs; returns
    ``(new_pose, rmse, benchmark, num_matches)``, each with leading B."""
    source, sel_mask = _select(cfg, source, src_table, stride, generator, selected, t)

    # --- transform (ICPOptimizer.h:251-252); masked queries are pinned to
    # the first valid query so they keep query tiles spatially tight.
    src_pts = se3.transform_points(source.points, pose)
    first = torch.argmax(sel_mask.to(torch.uint8), dim=-1)
    anchor = knn.take_rows(src_pts, first[:, None])
    src_pts = torch.where(sel_mask[..., None], src_pts, anchor)
    src_nrm = se3.transform_normals(source.normals, pose)

    # --- stage 2: matching ---------------------------------------------------
    if cfg.matching == Matching.PROJECTIVE:
        raise NotImplementedError(
            "projective matching is not ported yet: ROADMAP.md queue 1 item 10")
    if cfg.color_icp:
        raise NotImplementedError(
            "color-ICP matching is not ported yet: ROADMAP.md queue 1 item 9")
    if kd_index is not None:
        if _membership_applies(cfg):
            raise NotImplementedError(
                "the approximate arm's membership cache (dense selection) is "
                "not ported yet: ROADMAP.md queue 1 item 9")
        # Cold kd search. The JAX package's warm start (dense exact arm)
        # returns the same matches by its exactness contract.
        idx, d2, valid = kdtree.match_kd(
            src_pts, kd_index, target_index, cfg.max_distance,
            query_mask=sel_mask, checks=cfg.matching_checks)
    else:
        idx, d2, valid = knn.match_indexed(
            src_pts, target_index, cfg.max_distance, query_mask=sel_mask)
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
    w = weighting.apply_weights(cfg.weighting, m, cfg.max_distance)
    if cfg.rejection:
        m = m._replace(valid=rejection.normal_angle_mask(m.src_normals, m.tgt_normals, m.valid))
    if cfg.trim_ratio < 1.0:
        m = m._replace(valid=rejection.trimmed_mask(d2, m.valid, cfg.trim_ratio, cfg.max_distance))

    # --- stages 5+6: solve + left-multiplied pose update ---------------------
    new_pose = _solve(cfg, m, w) @ pose

    rmse = measure.rmse_alignment_error(new_pose, gt_src, gt_tgt, gt_valid)
    bench = (measure.benchmark_error(new_pose, gt_src, gt_tgt, gt_valid)
             if run_benchmark else torch.zeros_like(rmse))
    num_matches = torch.sum(m.valid, dim=-1, dtype=torch.int32)
    return new_pose, rmse, bench, num_matches


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
    device=None,
) -> ICPResult:
    """Register a batch of B scan pairs; every Cloud field carries the
    leading pair axis. The ETH sweep's data-parallel runner.

    ``device`` (``None`` = the card) is where the run happens; clouds and
    kd indexes are moved there if needed. Random selection draws from
    ``generator`` (default: a new generator on ``device`` seeded with
    ``seed``). ``selected = (sel_idx, in_range)``, each (B, T, k_cap),
    replaces the draws of compacted RANDOM selection — the parity tests
    feed the JAX package's own draws through it. ``kd_indexes`` (a stacked
    :class:`kdtree.KDIndex`, see :func:`build_kd_for`) switches matching
    to the kd path. ``num_source_points`` seeds the multires schedule
    (default: the padded capacity); ``strides`` overrides it."""
    dev = resolve_device(device)
    sources, targets = sources.to(dev), targets.to(dev)
    if kd_indexes is not None:
        kd_indexes = kdtree.KDIndex(*(None if f is None else f.to(dev) for f in kd_indexes))
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
        gtv = (torch.ones(gt_src.shape[:2], dtype=torch.bool, device=dev) if gt_valid is None
               else torch.as_tensor(gt_valid, dtype=torch.bool).to(dev))
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
        generator = torch.Generator(device=dev).manual_seed(seed)

    target_index = None
    if cfg.matching == Matching.KNN:
        target_index = knn.build_target_index(targets.points, tile_t=knn.V2_TILE_T)
    src_table = _fuse_cloud_table(sources)
    tgt_table = _fuse_cloud_table(targets)

    rmse = torch.empty((b, n_iter), dtype=torch.float32, device=dev)
    bench = torch.empty_like(rmse)
    num_matches = torch.empty((b, n_iter), dtype=torch.int32, device=dev)
    for t, stride in enumerate(strides):
        pose, rmse[:, t], bench[:, t], num_matches[:, t] = _iteration(
            cfg, sources, targets, pose, stride, generator, selected, t,
            gt_src, gt_tgt, gtv, run_benchmark, target_index, kd_indexes,
            src_table, tgt_table,
        )
    return ICPResult(pose=pose, trace=ICPTrace(rmse=rmse, benchmark=bench, num_matches=num_matches))


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
    device=None,
) -> ICPResult:
    """Estimate the pose aligning one ``source`` onto ``target``
    (``ICPOptimizer::estimatePose``): :func:`run_icp_batch` with B = 1.
    The multires base size defaults to the source's valid count."""
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
        device=dev,
    )
    return ICPResult(pose=res.pose[0], trace=ICPTrace(*(x[0] for x in res.trace)))


def _kd_selection_applies(cfg: ICPConfig) -> bool:
    """Whether the per-query kd path serves this selection: sparse
    compacted random selection. (The JAX package also opens it to any
    selection when its TPU resident kernel fits VMEM; that capacity rule
    has no counterpart on the card.)"""
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
    :class:`kdtree.KDIndex` over ``target`` on ``device`` (``None`` = the
    card) when k-NN matching is configured, the selection suits the kd
    path and the cloud is large enough; ``None`` otherwise."""
    dev = resolve_device(device)
    if cfg.matching != Matching.KNN or not _kd_selection_applies(cfg):
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
