"""The bunny workload: mesh-to-mesh ICP, the reference's canonical entry.

Port of ``icp_variants_tpu.workloads.bunny`` (``alignBunnyWithICP``,
main.cpp:43-181): align ``bunny_part2_trans`` onto ``bunny_part1`` with
k-NN matching at max squared distance 3e-4, 20 iterations, and the 4
hand-verified GT pairs as the convergence oracle. The targets are far
below the kd path's size, so matching runs the tile-pruned visited search
(``knn.match_indexed``: ``csrc/visited_search.cu`` on the card).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.data import mesh as mesh_lib
from icp_variants_tpu_torch.data import ply_io
from icp_variants_tpu_torch.data.loaders import BunnyDataLoader
from icp_variants_tpu_torch.pipeline import icp
from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer


def default_config(**overrides) -> ICPConfig:
    """The bunny run configuration of main.cpp:59-98."""
    cfg = ICPConfig(
        metric=Metric.POINT_TO_POINT,
        minimizer=Minimizer.NONLINEAR_LM,
        n_iterations=20,
        max_distance=0.0003,
    )
    return cfg.replace(**overrides)


@dataclass
class BunnyRunResult:
    pose: np.ndarray
    rmse_per_iteration: np.ndarray
    final_rmse: float
    num_matches: np.ndarray


def align_bunny(
    cfg: ICPConfig | None = None,
    data_dir: str | None = None,
    seed: int = 0,
    artifacts_dir: str | None = None,
    device=None,
) -> BunnyRunResult:
    """Register the bunny halves on ``device`` (``None`` = the card); the
    draws of a random selection come from a ``torch.Generator`` seeded with
    ``seed`` on the device. ``artifacts_dir``: write the driver's output
    files there (:func:`write_artifacts`)."""
    dev = resolve_device(device)
    cfg = cfg or default_config()
    loader = BunnyDataLoader(data_dir=data_dir, device=dev)
    sample = loader.get_item(0)
    gt_src, gt_tgt = loader.gt_correspondences()
    result = icp.run_icp(
        cfg, sample.source, sample.target,
        init_pose=np.eye(4, dtype=np.float32),
        gt_source_points=gt_src, gt_target_points=gt_tgt,
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev,
    )
    rmse = result.trace.rmse.cpu().numpy()
    run = BunnyRunResult(
        pose=result.pose.cpu().numpy(),
        rmse_per_iteration=rmse,
        final_rmse=float(rmse[-1]),
        num_matches=result.trace.num_matches.cpu().numpy(),
    )
    if artifacts_dir is not None:
        write_artifacts(artifacts_dir, loader, sample, run, gt_src, gt_tgt)
    return run


def write_artifacts(out_dir, loader, sample, run, gt_src, gt_tgt) -> None:
    """The bunny driver's output files (main.cpp:144-176): source, target
    and aligned clouds as .ply, the per-iteration RMSE.txt, and the joined
    visualization mesh with correspondence spheres as bunny_icp.off."""
    from icp_variants_tpu_torch.workloads.experiments import write_error_file

    os.makedirs(out_dir, exist_ok=True)
    src_valid = sample.source.valid.cpu().numpy()
    src_pts = sample.source.points.cpu().numpy()[src_valid]
    src_nrm = sample.source.normals.cpu().numpy()[src_valid]
    tgt_valid = sample.target.valid.cpu().numpy()
    tgt_pts = sample.target.points.cpu().numpy()[tgt_valid]
    tgt_nrm = sample.target.normals.cpu().numpy()[tgt_valid]
    ones_s = np.ones(len(src_pts), np.float32)

    ply_io.write_ply(os.path.join(out_dir, "bunny_source.ply"), src_pts,
                     normals=src_nrm, intensity=ones_s)
    ply_io.write_ply(os.path.join(out_dir, "bunny_target.ply"), tgt_pts,
                     normals=tgt_nrm, intensity=np.ones(len(tgt_pts), np.float32))
    moved = src_pts @ run.pose[:3, :3].T + run.pose[:3, 3]
    ply_io.write_ply(os.path.join(out_dir, "bunny_final_source.ply"), moved,
                     normals=src_nrm @ run.pose[:3, :3].T, intensity=ones_s)
    write_error_file(os.path.join(out_dir, "RMSE.txt"), run.rmse_per_iteration)

    # The joined visualization mesh with GT-correspondence spheres
    # (SHOW_BUNNY_CORRESPONDENCES, main.cpp:153-172); spheres only at the
    # GT pairs, to keep the file a few MB.
    src_mesh = mesh_lib.TriMesh(loader.source_mesh.vertices, loader.source_mesh.triangles,
                                loader.source_mesh.vertex_colors)
    tgt_mesh = mesh_lib.TriMesh(loader.target_mesh.vertices, loader.target_mesh.triangles,
                                loader.target_mesh.vertex_colors)
    joined = mesh_lib.join_meshes(src_mesh, tgt_mesh, pose_a=run.pose)
    for p in gt_src:
        joined = mesh_lib.join_meshes(mesh_lib.sphere(p, 0.003, color=(0, 255, 0, 255)), joined,
                                      pose_a=run.pose)
    for p in gt_tgt:
        joined = mesh_lib.join_meshes(mesh_lib.sphere(p, 0.003, color=(255, 0, 255, 0)), joined)
    joined.write(os.path.join(out_dir, "bunny_icp.off"))
