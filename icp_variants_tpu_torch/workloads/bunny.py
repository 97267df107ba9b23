"""The bunny workload: mesh-to-mesh ICP, the reference's canonical entry.

Port of ``icp_variants_tpu.workloads.bunny`` (``alignBunnyWithICP``,
main.cpp:43-181): align ``bunny_part2_trans`` onto ``bunny_part1`` with
k-NN matching at max squared distance 3e-4, 20 iterations, and the 4
hand-verified GT pairs as the convergence oracle. The targets are far
below the kd path's size, so matching runs the tile-pruned visited search
(``knn.match_indexed``: ``csrc/visited_search.cu`` on the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from icp_variants_tpu_torch.core.device import resolve_device
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
    ``seed`` on the device. ``artifacts_dir`` (the driver's .ply / RMSE.txt
    / .off outputs) needs ``data/ply_io.py`` and
    ``workloads/experiments.write_error_file``, not ported yet."""
    if artifacts_dir is not None:
        raise NotImplementedError(
            "align_bunny(artifacts_dir=...) needs data/ply_io.py and "
            "workloads/experiments.write_error_file, not ported yet: ROADMAP.md queue 1 item 6")
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
    return BunnyRunResult(
        pose=result.pose.cpu().numpy(),
        rmse_per_iteration=rmse,
        final_rmse=float(rmse[-1]),
        num_matches=result.trace.num_matches.cpu().numpy(),
    )
