"""ETH laser-registration benchmark: the headline workload.

Port of ``icp_variants_tpu.workloads.eth`` (``alignETH``,
main.cpp:343-514): for every scan pair of an ETH sequence, perturb the
source by the (0.1-scaled) ground-truth pose, register with 50 ICP
iterations at max squared distance 10, and record RMSE and the Fontana
benchmark error per iteration (the oracle is the unperturbed source cloud
itself, main.cpp:417-439).

Two pose-scaling conventions exist in the reference: main.cpp:419-429
scales the Euler angles and translation by 0.1, experiment.cpp:327-328
applies the unscaled pose; ``pose_scaling`` selects either.

Everything runs on ``device`` (``None`` = the card). Random selection
draws from a ``torch.Generator`` seeded ``seed + start`` per batch (``seed
+ index`` per pair in :func:`align_eth`), where the JAX package takes
``PRNGKey(seed + start)``.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.core.device import resolve_device, timing_event
from icp_variants_tpu_torch.data.loaders import ETHDataLoader
from icp_variants_tpu_torch.ops import kdtree
from icp_variants_tpu_torch.parallel import pose_graph
from icp_variants_tpu_torch.pipeline import icp, measure
from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer
from icp_variants_tpu_torch.runtime.prefetch import Prefetcher

logger = logging.getLogger("icp_variants_tpu_torch.eth")


def default_config(**overrides) -> ICPConfig:
    """The ETH run configuration of main.cpp:360-398."""
    cfg = ICPConfig(
        metric=Metric.POINT_TO_POINT,
        minimizer=Minimizer.NONLINEAR_LM,
        n_iterations=50,
        max_distance=10.0,
    )
    return cfg.replace(**overrides)


def scale_pose(pose: np.ndarray, scaling: float) -> np.ndarray:
    """Scale a pose by ``scaling`` through its Euler angles and translation
    (main.cpp:419-429, Eigen ``eulerAngles(0, 1, 2)``), in float32 on the
    host."""
    abg = se3.matrix_to_euler_xyz(torch.from_numpy(np.asarray(pose[:3, :3], np.float32)))
    R = se3.euler_xyz_to_matrix(*(abg * np.float32(scaling)))
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.numpy()
    out[:3, 3] = scaling * pose[:3, 3]
    return out


def perturb_cloud(cloud: cloud_lib.Cloud, pose: np.ndarray) -> cloud_lib.Cloud:
    """Apply a pose to points and normals (rotation only for normals),
    matching ``PointCloud::change_pose`` (PointCloud.h:277-282); the
    products run in numpy float32 on the host, as the JAX package's do,
    and the result lands on the cloud's device."""
    dev = cloud.points.device
    pts = cloud.points.cpu().numpy() @ pose[:3, :3].T + pose[:3, 3]
    valid = cloud.valid.cpu().numpy()
    pts = np.where(valid[:, None], pts, cloud_lib.PAD_SENTINEL)
    nrm = cloud.normals.cpu().numpy() @ pose[:3, :3].T
    return cloud._replace(points=torch.from_numpy(pts.astype(np.float32)).to(dev),
                          normals=torch.from_numpy(nrm.astype(np.float32)).to(dev))


@dataclass
class ETHPairResult:
    index: int
    initial_error: float
    final_error: float
    initial_rmse: float
    final_rmse: float
    rmse_per_iteration: np.ndarray
    benchmark_per_iteration: np.ndarray
    pose: np.ndarray
    # The scaled GT pose applied to the source before registration
    # (main.cpp:419-429); the true scan-to-scan transform is
    # ``pose @ perturbation``.
    perturbation: np.ndarray = None

    @property
    def relative_pose(self) -> np.ndarray:
        """The ICP estimate composed with the applied perturbation: maps raw
        source-scan coordinates onto the target scan."""
        if self.perturbation is None:
            return self.pose
        return self.pose @ self.perturbation


@dataclass
class ETHRunResult:
    pairs: list = field(default_factory=list)
    min_error: float = float("inf")
    index_min_error: int = -1
    min_relative_error: float = 1.0
    index_min_relative_error: int = -1
    # align_eth_batch's load profile (see there); None elsewhere.
    load: dict | None = None

    @property
    def final_errors(self) -> np.ndarray:
        return np.asarray([p.final_error for p in self.pairs])

    def add(self, pair: ETHPairResult) -> None:
        self.pairs.append(pair)
        if pair.final_error < self.min_error:
            self.min_error, self.index_min_error = pair.final_error, pair.index
        rel = pair.final_error / max(pair.initial_error, 1e-30)
        if rel < self.min_relative_error:
            self.min_relative_error, self.index_min_relative_error = rel, pair.index


def _overlap_ms(loads, runs) -> float:
    """Device milliseconds during which a batch's normals (worker stream)
    and some batch's run (consumer stream) were both in flight; each span
    is a pair of recorded events, read from the first load's start."""
    t0 = loads[0][0]

    def span(a, b):
        return t0.elapsed_time(a), t0.elapsed_time(b)

    run_spans = [span(*r) for r in runs]
    total = 0.0
    for a, b in (span(*ld) for ld in loads):
        total += sum(max(0.0, min(b, d) - max(a, c)) for c, d in run_spans)
    return total


def align_eth_batch(
    csv_path: str,
    cfg: ICPConfig | None = None,
    pose_scaling: float = 0.1,
    data_root: str | None = None,
    capacity: int | None = None,
    max_pairs: int | None = None,
    batch_size: int = 4,
    seed: int = 0,
    downsample: int | None = None,
    checkpoint_dir: str | None = None,
    device=None,
) -> ETHRunResult:
    """Data-parallel ETH sweep: registers ``batch_size`` scan pairs per
    ``run_icp_batch`` call on ``device`` (``None`` = the card). All pairs
    share one ``capacity``: by default the largest cloud of the sweep (from
    the .pcd headers), rounded up to 512.

    A worker thread (``runtime/prefetch``) loads the next batch while this
    one runs: the native parse, normals on the device (on the worker's own
    stream), Morton order, the kd builds and the perturbation. The result's
    ``load`` holds that work's host seconds by step (``parse``,
    ``normals``, ``kd``, ``perturb``, their sum ``load``), the seconds the
    consumer waited for a batch (``wait``; ``load - wait`` were hidden
    behind the runs), and on the card the device-clock milliseconds of the
    worker's normals spans (``normals_device_ms``) and of them those during
    which a run was in flight on the consumer's stream (``overlap_ms``).

    ``checkpoint_dir`` writes the accumulated pair results after every
    batch (atomically), and a rerun with the same configuration resumes
    from the first incomplete batch."""
    dev = resolve_device(device)
    cfg = cfg or default_config()
    loader = ETHDataLoader(csv_path, data_root=data_root, capacity=capacity,
                           downsample=downsample, device=dev)
    n = loader.get_length() if max_pairs is None else min(max_pairs, loader.get_length())
    result = ETHRunResult()

    num_source_points = None
    if capacity is None and n > 0:
        # One capacity for every batch, from the headers, rounded up to
        # the k-NN tile multiple.
        counts = loader.point_counts(max_pairs=n)
        capacity = int(-(-int(counts.max()) // 512) * 512)
        loader.capacity = capacity
        num_source_points = int(counts.max())
    elif cfg.multi_resolution and n > 0:
        # The multires stride schedule comes from the true point count, not
        # the padded capacity (run_icp semantics, ICPOptimizer.h:196).
        num_source_points = int(loader.point_counts(max_pairs=n).max())

    def load_batch(idxs):
        # All per-pair preparation happens here, on the worker thread; the
        # consumer only stacks and launches.
        timing: dict = {}
        samples = loader.get_items(idxs, timing)
        t0 = time.perf_counter()
        kds = [icp.build_kd_for(cfg, s.target, device=dev) for s in samples]
        t1 = time.perf_counter()
        scaled = [scale_pose(s.pose, pose_scaling) for s in samples]
        perturbed = [perturb_cloud(s.source, sc) for s, sc in zip(samples, scaled)]
        timing.update(kd=t1 - t0, perturb=time.perf_counter() - t1)
        kd = None if any(k is None for k in kds) else kdtree.stack_kd_indexes(kds)
        return samples, kd, scaled, perturbed, timing

    batch_indices = [list(range(start, min(start + batch_size, n)))
                     for start in range(0, n, batch_size)]
    ckpt = (_SweepCheckpoint(checkpoint_dir, csv_path, cfg, n, batch_size, pose_scaling, seed,
                             capacity, downsample) if checkpoint_dir is not None else None)
    if ckpt is not None:
        done = ckpt.load_into(result)
        if done:
            logger.info("resumed %d completed pairs from %s", len(done), ckpt.path)
        batch_indices = [idxs for idxs in batch_indices if not all(i in done for i in idxs)]

    load = dict(parse=0.0, normals=0.0, kd=0.0, perturb=0.0, wait=0.0)
    load_events, run_events = [], []
    prefetched = Prefetcher(batch_indices, load_batch, depth=1, device=dev)
    for idxs in batch_indices:
        t_wait = time.perf_counter()
        samples, kd_indexes, perturbations, sources, timing = next(prefetched)
        load["wait"] += time.perf_counter() - t_wait
        load_events.append(timing.pop("normals_events"))
        for k, v in timing.items():
            load[k] += v
        start = idxs[0]
        batch_src = icp.stack_clouds(sources)
        originals = torch.stack([s.source.points for s in samples])
        r0 = timing_event(dev)
        res = icp.run_icp_batch(
            cfg, batch_src, icp.stack_clouds([s.target for s in samples]),
            gt_source_points=batch_src.points, gt_target_points=originals,
            gt_valid=batch_src.valid,
            generator=torch.Generator(device=dev).manual_seed(seed + start),
            run_benchmark=True, kd_indexes=kd_indexes,
            num_source_points=num_source_points, device=dev,
        )
        eye = torch.eye(4, device=dev)
        initial_error = measure.benchmark_error(eye, batch_src.points, originals, batch_src.valid)
        initial_rmse = measure.rmse_alignment_error(eye, batch_src.points, originals,
                                                    batch_src.valid)
        run_events.append((r0, timing_event(dev)))
        rmse = res.trace.rmse.cpu().numpy()
        bench = res.trace.benchmark.cpu().numpy()
        poses = res.pose.cpu().numpy()
        initial_error, initial_rmse = initial_error.cpu().numpy(), initial_rmse.cpu().numpy()
        for bi, index in enumerate(idxs):
            result.add(ETHPairResult(
                index=index, initial_error=float(initial_error[bi]),
                final_error=float(bench[bi, -1]), initial_rmse=float(initial_rmse[bi]),
                final_rmse=float(rmse[bi, -1]), rmse_per_iteration=rmse[bi],
                benchmark_per_iteration=bench[bi], pose=poses[bi],
                perturbation=perturbations[bi]))
        if ckpt is not None:
            ckpt.save(result)

    load["load"] = load["parse"] + load["normals"] + load["kd"] + load["perturb"]
    if dev.type == "cuda" and run_events:
        torch.cuda.synchronize(dev)
        load["normals_device_ms"] = sum(a.elapsed_time(b) for a, b in load_events)
        load["overlap_ms"] = _overlap_ms(load_events, run_events)
    result.load = load
    result.pairs.sort(key=lambda p: p.index)
    return result


class _SweepCheckpoint:
    """Atomic npz checkpoint of an ETH sweep's accumulated pair results (the
    JAX package's layout and manifest).

    The manifest (config repr, csv path, pair count, batching, seed,
    capacity, downsample) guards against resuming into a different run;
    the state file is replaced atomically after each batch, so a crash
    never leaves a torn checkpoint."""

    def __init__(self, directory, csv_path, cfg, n, batch_size, pose_scaling, seed,
                 capacity=None, downsample=None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "eth_sweep.npz")
        self.manifest = dict(
            csv=os.path.abspath(csv_path), cfg=repr(cfg), n=int(n),
            batch_size=int(batch_size), pose_scaling=float(pose_scaling), seed=int(seed),
            capacity=None if capacity is None else int(capacity),
            downsample=None if downsample is None else int(downsample),
        )

    def load_into(self, result: ETHRunResult) -> set:
        if not os.path.exists(self.path):
            return set()
        with np.load(self.path, allow_pickle=False) as z:
            if json.loads(str(z["manifest"])) != self.manifest:
                logger.warning("checkpoint %s belongs to a different run config; ignoring it",
                               self.path)
                return set()
            for row, index in enumerate(z["indices"]):
                result.add(ETHPairResult(
                    index=int(index),
                    initial_error=float(z["initial_errors"][row]),
                    final_error=float(z["final_errors"][row]),
                    initial_rmse=float(z["initial_rmses"][row]),
                    final_rmse=float(z["final_rmses"][row]),
                    rmse_per_iteration=z["rmse_curves"][row],
                    benchmark_per_iteration=z["benchmark_curves"][row],
                    pose=z["poses"][row],
                    perturbation=z["perturbations"][row],
                ))
        return {p.index for p in result.pairs}

    def save(self, result: ETHRunResult) -> None:
        pairs = sorted(result.pairs, key=lambda p: p.index)
        payload = dict(
            manifest=np.asarray(json.dumps(self.manifest)),
            indices=np.asarray([p.index for p in pairs], np.int32),
            initial_errors=np.asarray([p.initial_error for p in pairs]),
            final_errors=np.asarray([p.final_error for p in pairs]),
            initial_rmses=np.asarray([p.initial_rmse for p in pairs]),
            final_rmses=np.asarray([p.final_rmse for p in pairs]),
            rmse_curves=np.stack([p.rmse_per_iteration for p in pairs]),
            benchmark_curves=np.stack([p.benchmark_per_iteration for p in pairs]),
            poses=np.stack([p.pose for p in pairs]),
            perturbations=np.stack([p.perturbation for p in pairs]),
        )
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path), suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


def refine_trajectory(result: ETHRunResult, weights: np.ndarray | None = None, *,
                      extra_edges=None, mesh=None, device=None):
    """Pose-graph refinement over a sequential ETH run (pair k registers
    scan k+1 onto scan k): chains the per-pair poses into absolute scan
    poses and refines them jointly (``parallel/pose_graph.refine``, on
    ``device``, ``None`` = the card). With ``mesh`` (a
    ``distributed.Mesh``) the solve is ``pose_graph.refine_sharded``, the
    edges split over the mesh's ``pairs`` ranks, on the mesh's device.

    Each pair was solved in its own perturbed frame, so the relative edge
    is ``icp_pose @ scaled_perturbation`` (``ETHPairResult.relative_pose``).
    ``extra_edges`` appends loop-closure edges ``(i, j, rel_pose, weight)``
    with ``rel_pose`` mapping scan j's coordinates onto scan i's
    (:func:`register_closures` builds them). Returns ``(odometry, refined,
    graph)``, the poses as host arrays."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    rel = np.stack([p.relative_pose for p in result.pairs])
    odometry, graph = pose_graph.sequential_graph(rel, weights, device=dev)
    if extra_edges:
        graph = pose_graph.PoseGraph(
            edge_i=torch.cat([graph.edge_i, torch.tensor([e[0] for e in extra_edges],
                                                         dtype=torch.int64, device=dev)]),
            edge_j=torch.cat([graph.edge_j, torch.tensor([e[1] for e in extra_edges],
                                                         dtype=torch.int64, device=dev)]),
            rel_poses=torch.cat([graph.rel_poses, torch.from_numpy(np.stack(
                [np.asarray(e[2], np.float32) for e in extra_edges])).to(dev)]),
            weights=torch.cat([graph.weights, torch.tensor([e[3] for e in extra_edges],
                                                           dtype=torch.float32, device=dev)]),
        )
    if mesh is not None:
        refined = pose_graph.refine_sharded(odometry, graph, mesh)
    else:
        refined = pose_graph.refine(odometry, graph)
    return odometry, refined.cpu().numpy(), graph


def find_loop_closures(odometry: np.ndarray, *, radius: float = 1.0, min_separation: int = 3,
                       max_closures: int = 8) -> list[tuple[int, int]]:
    """Candidate loop-closure scan pairs from trajectory proximity: scans
    ``(i, j)`` with ``j - i >= min_separation`` whose odometry positions
    lie within ``radius`` metres. Greedy, farthest separation first; each
    scan joins at most one closure."""
    pos = np.asarray([T[:3, 3] for T in odometry])
    n = len(pos)
    cands = []
    for i in range(n):
        for j in range(i + min_separation, n):
            d = float(np.linalg.norm(pos[j] - pos[i]))
            if d <= radius:
                cands.append((j - i, d, i, j))
    cands.sort(key=lambda c: (-c[0], c[1]))
    used: set[int] = set()
    out = []
    for _, _, i, j in cands:
        if i in used or j in used:
            continue
        out.append((i, j))
        used.update((i, j))
        if len(out) >= max_closures:
            break
    return out


def register_closures(loader: ETHDataLoader, closures: list[tuple[int, int]], cfg: ICPConfig,
                      odometry: np.ndarray, *, seed: int = 0):
    """Register each loop-closure scan pair (scan j onto scan i) with the
    sweep's configuration on the loader's device, starting from the
    odometry guess (the source moved by ``odometry[i]^-1 @ odometry[j]``,
    so ICP solves only for the residual drift). Returns ``(i, j, rel_pose,
    weight)`` edges, ``rel_pose`` mapping scan j's raw coordinates onto
    scan i's."""
    dev = loader.device
    edges = []
    for k, (i, j) in enumerate(closures):
        scan_i = loader.get_scan(i)
        scan_j = loader.get_scan(j)
        guess = (np.linalg.inv(odometry[i]) @ odometry[j]).astype(np.float32)
        res = icp.run_icp(
            cfg, perturb_cloud(scan_j, guess), scan_i,
            generator=torch.Generator(device=dev).manual_seed(seed + 7919 * k),
            kd_index=icp.build_kd_for(cfg, scan_i, device=dev), device=dev,
        )
        pose = res.pose.cpu().numpy()
        edges.append((i, j, (pose @ guess).astype(np.float32), 1.0))
        logger.info("closure %d-%d registered (|t| drift %.4f m)", i, j,
                    float(np.linalg.norm(pose[:3, 3])))
    return edges


def align_eth(
    csv_path: str,
    cfg: ICPConfig | None = None,
    pose_scaling: float = 0.1,
    data_root: str | None = None,
    capacity: int | None = None,
    max_pairs: int | None = None,
    seed: int = 0,
    downsample: int | None = None,
    device=None,
) -> ETHRunResult:
    """The sequential ETH sweep (``alignETH``): one ``run_icp`` per pair on
    ``device`` (``None`` = the card)."""
    if not (0.0 < pose_scaling <= 1.0):
        raise ValueError("pose scaling must be in (0, 1]")  # main.cpp:346-349
    dev = resolve_device(device)
    cfg = cfg or default_config()
    loader = ETHDataLoader(csv_path, data_root=data_root, capacity=capacity,
                           downsample=downsample, device=dev)
    result = ETHRunResult()
    logger.info("%s", cfg.describe())
    n = loader.get_length() if max_pairs is None else min(max_pairs, loader.get_length())
    eye = torch.eye(4, device=dev)
    for index in range(n):
        logger.info("processing pair %d/%d", index, n)
        sample = loader.get_item(index)
        original = sample.source.points
        scaled = scale_pose(sample.pose, pose_scaling)
        source = perturb_cloud(sample.source, scaled)
        initial_error = float(measure.benchmark_error(eye, source.points, original, source.valid))
        initial_rmse = float(measure.rmse_alignment_error(eye, source.points, original,
                                                          source.valid))
        res = icp.run_icp(
            cfg, source, sample.target,
            gt_source_points=source.points, gt_target_points=original, gt_valid=source.valid,
            generator=torch.Generator(device=dev).manual_seed(seed + index),
            run_benchmark=True, kd_index=icp.build_kd_for(cfg, sample.target, device=dev),
            device=dev,
        )
        rmse = res.trace.rmse.cpu().numpy()
        bench = res.trace.benchmark.cpu().numpy()
        logger.info("pair %d: benchmark %.5f -> %.5f, rmse %.5f -> %.5f",
                    index, initial_error, float(bench[-1]), initial_rmse, float(rmse[-1]))
        result.add(ETHPairResult(
            index=index, initial_error=initial_error, final_error=float(bench[-1]),
            initial_rmse=initial_rmse, final_rmse=float(rmse[-1]), rmse_per_iteration=rmse,
            benchmark_per_iteration=bench, pose=res.pose.cpu().numpy(), perturbation=scaled))
    return result
