"""Multi-rank ICP: scan pairs and source-point shards over a 2-D mesh.

Port of ``icp_variants_tpu.parallel.sharded_icp``. The two natural axes
spread over a :class:`distributed.Mesh` of ranks, one device each:

* ``pairs``  -- data parallel over registration problems (scan pairs,
  frames); each rank registers its slice of the batch, with no collective.
* ``points`` -- within a pair the SOURCE rows split over the ranks; each
  rank matches its query shard against the whole target with the same
  kernels as one device, and the solvers' and measures' reductions
  (means, the 3x3 cross-covariance, the 6x6 normal equations, J^T J and
  J^T r per LM step, the trimming and robust-scale histograms, the error
  sums, the match count) sum across the ``points`` group, a few hundred
  bytes a pair per reduction.

Targets, kd indexes and the tile index are whole on every rank of a
``points`` group; each rank builds its tile index itself, as
``run_icp_batch`` does. The pose and Anderson state are therefore the same
on every rank of the group, bit for bit. Results are independent of the
mesh layout up to the order of float sums; the integer sums are exact.

Each rank runs this module's functions with the same global arguments
(SPMD, as under ``torchrun``) and gets back the result of its own pairs.
The JAX package caches one compiled runner per configuration; eager
PyTorch compiles nothing and needs no such cache.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.ops import kdtree
from icp_variants_tpu_torch.parallel.distributed import Mesh, shard_seed
from icp_variants_tpu_torch.pipeline import icp
from icp_variants_tpu_torch.pipeline.config import ICPConfig

POINTS_AXIS = "points"
PAIRS_AXIS = "pairs"


class ShardedResult(NamedTuple):
    """A rank's share of a sharded run: the result of its pairs (the same
    on every rank of its ``points`` group) and the rows of the batch they
    occupy."""

    result: icp.ICPResult
    pairs: slice


def pad_cloud_rows(cloud: Cloud, multiple: int) -> Cloud:
    """Pad a (possibly batched) Cloud's point axis to a multiple of
    ``multiple`` rows: sentinel points, NaN normals, zero colours, invalid
    rows."""
    pad = (-cloud.capacity) % multiple
    if pad == 0:
        return cloud

    def grow(x, value):
        fill = torch.full((*x.shape[:-2], pad, x.shape[-1]), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, fill], dim=-2)

    valid = torch.cat([cloud.valid, torch.zeros((*cloud.valid.shape[:-1], pad),
                                                dtype=torch.bool, device=cloud.valid.device)],
                      dim=-1)
    return Cloud(points=grow(cloud.points, cloud_lib.PAD_SENTINEL),
                 normals=grow(cloud.normals, float("nan")),
                 colors=grow(cloud.colors, 0.0), valid=valid)


def shard_draws(sel_idx, in_range, n_shards: int, shard_cap: int, proba: float):
    """Split compacted RANDOM draws over the whole source (``(B, T, k)``
    rows and in-range flags, as ``run_icp_batch(selected=)`` takes them)
    into each points shard's own: ``(B, n_shards, T, k_shard)`` local rows
    and flags, ``k_shard`` the shard's query capacity. Every shard then
    queries exactly the rows the unsharded run draws. Raises when a shard
    draws more rows than its capacity holds."""
    sel_idx = torch.as_tensor(sel_idx).to(torch.int64)
    in_range = torch.as_tensor(in_range).to(torch.bool)
    b, t, _ = sel_idx.shape
    k_shard = icp._compact_capacity(shard_cap, proba)
    shard = torch.where(in_range, sel_idx // shard_cap, n_shards)
    rows = torch.full((b, n_shards, t, k_shard), shard_cap - 1, dtype=torch.int32)
    flags = torch.zeros((b, n_shards, t, k_shard), dtype=torch.bool)
    for s in range(n_shards):
        mine = shard == s
        count = mine.sum(-1)
        if int(count.max()) > k_shard:
            raise ValueError(f"shard {s} draws {int(count.max())} rows, more than its "
                             f"capacity of {k_shard}")
        # The draws ascend, so a shard's rows keep their order compacted.
        slot = torch.cumsum(mine.to(torch.int64), dim=-1) - 1
        bi, ti, ki = torch.nonzero(mine, as_tuple=True)
        rows[bi, s, ti, slot[bi, ti, ki]] = (sel_idx[bi, ti, ki] - s * shard_cap).to(torch.int32)
        flags[bi, s, ti, slot[bi, ti, ki]] = True
    return rows, flags


def _shard_rows(x, n_shards: int, index: int, fill):
    """Rows ``[index * n / n_shards, (index + 1) * n / n_shards)`` of axis 1
    of ``x``, padded with ``fill`` to a multiple of ``n_shards`` first."""
    x = torch.as_tensor(x)
    pad = (-x.shape[1]) % n_shards
    if pad:
        x = torch.cat([x, torch.full((x.shape[0], pad, *x.shape[2:]), fill, dtype=x.dtype,
                                     device=x.device)], dim=1)
    n = x.shape[1] // n_shards
    return x[:, index * n:(index + 1) * n].contiguous()


def run_icp_batch_sharded(
    cfg: ICPConfig,
    sources: Cloud,          # leading batch axis on every field
    targets: Cloud,
    mesh: Mesh,
    init_poses=None,
    *,
    gt_source_points=None,   # (B, G, 3)
    gt_target_points=None,   # (B, G, 3)
    gt_valid=None,           # (B, G)
    seed: int = 0,
    run_benchmark: bool = False,
    num_source_points: int | None = None,
    kd_indexes: kdtree.KDIndex | None = None,
    selected=None,
    strides=None,
    device=None,
) -> ShardedResult:
    """The full ICP driver (``run_icp_batch``: the multires stride schedule,
    the per-iteration trace, the benchmark error, Anderson acceleration)
    over the mesh: the batch splits over ``pairs``, each pair's source rows
    (padded by :func:`pad_cloud_rows` to ``points`` x ``PAD_MULTIPLE``)
    and ground-truth rows over ``points``. Every rank passes the same
    global arguments and gets its pairs' :class:`ShardedResult`.

    The stride schedule comes from ``num_source_points`` (default: the
    capacity before padding), so it does not depend on the mesh.
    ``kd_indexes`` (stacked over the batch) split over ``pairs`` like the
    targets and stay whole over ``points``. Random selection draws from a
    generator seeded from ``seed`` and this rank's pair shard and points
    shard (:func:`distributed.shard_seed`); ``selected`` ((B, points, T,
    k_shard) local rows and flags, see :func:`shard_draws`) replaces
    compacted RANDOM draws. ``device`` defaults to the mesh's."""
    n_pairs_shards = mesh.size(PAIRS_AXIS)
    n_points_shards = mesh.size(POINTS_AXIS)
    pi, qi = mesh.coords[PAIRS_AXIS], mesh.coords[POINTS_AXIS]
    b = sources.points.shape[0]
    if b % n_pairs_shards != 0:
        raise ValueError(
            f"batch {b} does not divide over {n_pairs_shards} pair shards; "
            "pad the batch (repeat a pair) to a multiple"
        )
    # The stride schedule comes from the capacity before padding: the pad
    # depends on the points axis, and a mesh-dependent schedule would part
    # the layouts' results (and the unsharded runner's).
    if num_source_points is None:
        num_source_points = sources.capacity
    if strides is None:
        strides = cloud_lib.multires_stride_schedule(
            num_source_points, cfg.n_iterations, cfg.multi_resolution,
            cfg.multi_resolution_min_points)
    sources = pad_cloud_rows(sources, n_points_shards * cloud_lib.PAD_MULTIPLE)
    per = b // n_pairs_shards
    pairs = slice(pi * per, (pi + 1) * per)
    local_src = Cloud(*(_shard_rows(f[pairs], n_points_shards, qi, 0) for f in sources))
    local_tgt = Cloud(*(f[pairs] for f in targets))
    gt = {}
    if gt_source_points is not None:
        gsrc = torch.as_tensor(gt_source_points, dtype=torch.float32)[pairs]
        gtgt = torch.as_tensor(gt_target_points, dtype=torch.float32)[pairs]
        gv = (torch.ones(gsrc.shape[:2], dtype=torch.bool) if gt_valid is None
              else torch.as_tensor(gt_valid, dtype=torch.bool)[pairs])
        gt = dict(gt_source_points=_shard_rows(gsrc, n_points_shards, qi, 0.0),
                  gt_target_points=_shard_rows(gtgt, n_points_shards, qi, 0.0),
                  gt_valid=_shard_rows(gv, n_points_shards, qi, False))
    if kd_indexes is not None:
        kd_indexes = kdtree.KDIndex(*(None if f is None else f[pairs] for f in kd_indexes))
    if init_poses is not None:
        init_poses = torch.as_tensor(init_poses, dtype=torch.float32)[pairs]
    if selected is not None:
        selected = tuple(torch.as_tensor(x)[pairs, qi] for x in selected)
    res = icp.run_icp_batch(
        cfg, local_src, local_tgt, init_poses, seed=shard_seed(seed, pi),
        run_benchmark=run_benchmark, kd_indexes=kd_indexes, selected=selected,
        strides=strides, device=mesh.device if device is None else device,
        group=mesh.group(POINTS_AXIS), shard_index=qi, **gt)
    return ShardedResult(result=res, pairs=pairs)


def make_sharded_icp_step(cfg: ICPConfig, mesh: Mesh, device=None):
    """One ICP iteration at stride 1 over the mesh (see
    :func:`run_icp_batch_sharded` for the full run): returns
    ``step(sources, targets, poses, seed=0) -> ShardedResult``, every
    argument global, the result this rank's pairs'."""

    def step(sources: Cloud, targets: Cloud, poses, seed: int = 0) -> ShardedResult:
        return run_icp_batch_sharded(cfg, sources, targets, mesh, poses, seed=seed,
                                     strides=np.ones(1, np.int32), device=device)

    return step


def run_icp_sharded(
    cfg: ICPConfig,
    source: Cloud,
    target: Cloud,
    mesh: Mesh,
    init_pose=None,
    **kwargs,
) -> icp.ICPResult:
    """One pair over the ``points`` axis: :func:`run_icp_batch_sharded`
    with a batch of one (so a ``pairs`` axis of one). ``kd_index`` and the
    ground-truth arrays are the pair's own, without the batch axis."""
    for k in ("gt_source_points", "gt_target_points", "gt_valid"):
        if kwargs.get(k) is not None:
            kwargs[k] = torch.as_tensor(kwargs[k])[None]
    kd_index = kwargs.pop("kd_index", None)
    if kd_index is not None:
        kwargs["kd_indexes"] = kdtree.stack_kd_indexes([kd_index])
    init_poses = None if init_pose is None else torch.as_tensor(init_pose)[None]
    res = run_icp_batch_sharded(cfg, icp.stack_clouds([source]), icp.stack_clouds([target]),
                                mesh, init_poses, **kwargs).result
    return icp.ICPResult(pose=res.pose[0], trace=icp.ICPTrace(*(x[0] for x in res.trace)),
                         match_blocks=None if res.match_blocks is None else res.match_blocks[0])
