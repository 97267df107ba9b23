"""TUM RGB-D room reconstruction: frame-to-frame-0 camera tracking.

Port of ``icp_variants_tpu.workloads.room`` (``reconstructRoom``,
main.cpp:183-341): track every ``frame_step``-th frame of a TUM sequence
against frame 0 with 35 ICP iterations at max squared distance 0.1.
Projective matching uses the full-size image-shaped target; k-NN uses the
compacted one with a kd index; multires keeps the source full-size,
otherwise the source is stride-8 downsampled (main.cpp:293-298). Ground
truth per frame comes from the trajectory: ``currentToZero =
targetTrajectory @ inv(currentTrajectory)`` (main.cpp:300-303).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.data import mesh as mesh_lib
from icp_variants_tpu_torch.data import rgbd, tum
from icp_variants_tpu_torch.pipeline import icp, measure
from icp_variants_tpu_torch.pipeline.config import ICPConfig, Matching, Metric, Minimizer

logger = logging.getLogger("icp_variants_tpu_torch.room")


def default_config(**overrides) -> ICPConfig:
    """The room run configuration of main.cpp:211-268."""
    cfg = ICPConfig(
        metric=Metric.POINT_TO_POINT,
        minimizer=Minimizer.NONLINEAR_LM,
        n_iterations=35,
        max_distance=0.1,
    )
    cfg = cfg.with_camera(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                          width=tum.WIDTH, height=tum.HEIGHT)
    return cfg.replace(**overrides)


@dataclass
class RoomRunResult:
    estimated_poses: list = field(default_factory=list)   # camera poses (inverted)
    rmse_per_frame: list = field(default_factory=list)    # per-iteration curves
    initial_rmse: list = field(default_factory=list)
    final_rmse: list = field(default_factory=list)


def save_room_frame(out_path, frame, sensor, camera_pose) -> None:
    """Per-frame mesh dump with a camera marker (saveRoomToFile,
    utils.h:179-193): the triangulated RGB-D mesh joined with a frustum."""
    camera_pose_inv = np.linalg.inv(camera_pose)
    depth_mesh = mesh_lib.from_rgbd_frame(frame.depth, frame.color, sensor.intrinsics,
                                          camera_pose_inv, edge_threshold=0.1)
    cam = mesh_lib.camera_marker(camera_pose_inv, scale=0.0015)
    mesh_lib.join_meshes(depth_mesh, cam).write(out_path)


def reconstruct_room(
    dataset_dir: str,
    cfg: ICPConfig | None = None,
    frame_step: int = 10,
    max_frames: int = 10,
    seed: int = 0,
    artifacts_dir: str | None = None,
    device=None,
) -> RoomRunResult:
    """Track the sequence on ``device`` (``None`` = the card); frame i's
    random selection draws from a ``torch.Generator`` seeded ``seed + i``."""
    dev = resolve_device(device)
    cfg = cfg or default_config()
    sensor = tum.VirtualSensor(dataset_dir, increment=frame_step)
    if cfg.matching == Matching.PROJECTIVE:
        # setCameraParamsMatchingMethod with the sensor calibration
        # (main.cpp:236-238).
        K = sensor.intrinsics
        cfg = cfg.with_camera(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                              width=sensor.width, height=sensor.height)

    frame0 = sensor.process_frame_index(0)
    if frame0 is None:
        raise RuntimeError(f"no frames in {dataset_dir}")

    target = rgbd.cloud_from_depth(
        frame0.depth, frame0.color, sensor.intrinsics, sensor.extrinsics,
        keep_original_size=cfg.matching == Matching.PROJECTIVE,
        capacity=sensor.width * sensor.height, device=dev,
    )
    target_trajectory = frame0.trajectory
    # One kd build over the tracked frame-0 target (k-NN runs only).
    target_kd = icp.build_kd_for(cfg, target, device=dev)

    # Source shape contract (main.cpp:293-298): full-size for multires,
    # stride-8 compacted otherwise.
    if cfg.multi_resolution:
        # 6-dim colour Morton order for the colour k-NN matcher; projective
        # matching needs the image-shaped rows.
        src_kwargs = dict(keep_original_size=True, downsample_factor=1,
                          capacity=sensor.width * sensor.height,
                          color_morton_order=cfg.color_icp and cfg.matching == Matching.KNN)
        num_source_points = sensor.width * sensor.height
    else:
        src_kwargs = dict(keep_original_size=False, downsample_factor=8,
                          capacity=sensor.width * sensor.height // 8, morton_order=True)
        num_source_points = None  # the valid count of the compacted cloud

    result = RoomRunResult()
    current_camera_to_world = np.eye(4, dtype=np.float32)
    result.estimated_poses.append(np.linalg.inv(current_camera_to_world))
    if artifacts_dir is not None:
        os.makedirs(artifacts_dir, exist_ok=True)
        save_room_frame(f"{artifacts_dir}/mesh_0.off", frame0, sensor, current_camera_to_world)

    i = 0
    while i <= max_frames:
        frame = sensor.process_frame_index((i + 1) * frame_step)
        if frame is None:
            break
        source = rgbd.cloud_from_depth(frame.depth, frame.color, sensor.intrinsics,
                                       sensor.extrinsics, device=dev, **src_kwargs)
        current_to_zero = target_trajectory @ np.linalg.inv(frame.trajectory)
        src_pts = source.points.cpu().numpy()
        gt_tgt = src_pts @ current_to_zero[:3, :3].T + current_to_zero[:3, 3]
        init_rmse = float(measure.rmse_alignment_error(
            torch.from_numpy(current_camera_to_world).to(dev), source.points,
            torch.from_numpy(gt_tgt.astype(np.float32)).to(dev), source.valid))
        # Dense multires configurations run the segmented per-level driver;
        # everything else falls through to run_icp inside.
        res = icp.run_icp_multires_segmented(
            cfg, source, target, init_pose=current_camera_to_world,
            gt_source_points=src_pts, gt_target_points=gt_tgt, gt_valid=source.valid,
            generator=torch.Generator(device=dev).manual_seed(seed + i),
            num_source_points=num_source_points, kd_index=target_kd, device=dev,
        )
        current_camera_to_world = res.pose.cpu().numpy()
        rmse = res.trace.rmse.cpu().numpy()
        logger.info("frame %d: rmse %.5f -> %.5f", frame.index, init_rmse, float(rmse[-1]))
        result.rmse_per_frame.append(rmse)
        result.initial_rmse.append(init_rmse)
        result.final_rmse.append(float(rmse[-1]))
        result.estimated_poses.append(np.linalg.inv(current_camera_to_world))
        if artifacts_dir is not None:
            save_room_frame(f"{artifacts_dir}/mesh_{frame.index}.off", frame, sensor,
                            current_camera_to_world)
        i += 1
    return result
