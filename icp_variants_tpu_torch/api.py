"""High-level one-call registration API.

Port of ``icp_variants_tpu.api``. The reference's user experience is
"configure an ICPOptimizer, call estimatePose" (ICPOptimizer.h:41-140);
here it is one function:

    from icp_variants_tpu_torch import api
    result = api.register(source_points, target_points,
                          config=ICPConfig(metric=Metric.SYMMETRIC))
    result.pose          # (4, 4) aligning source onto target
    result.rmse          # per-iteration curve against the given oracle

Host numpy in, host numpy out; the run happens on ``device`` (``None`` =
the card). Normals are estimated there when not given (k = 5 k-NN PCA,
the PCL path of PointCloud.h:41-76).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import normals as normals_ops
from icp_variants_tpu_torch.pipeline import icp as icp_mod
from icp_variants_tpu_torch.pipeline.config import ICPConfig, Matching

@dataclass
class RegistrationResult:
    pose: np.ndarray               # (4, 4) estimated transform (source -> target)
    rmse: np.ndarray               # (T,) per-iteration RMSE against the oracle
    benchmark_error: np.ndarray    # (T,) Fontana error (zeros unless requested)
    num_matches: np.ndarray        # (T,) valid correspondences per iteration

    @property
    def final_rmse(self) -> float:
        return float(self.rmse[-1])


def register(
    source_points: np.ndarray,
    target_points: np.ndarray,
    config: ICPConfig | None = None,
    *,
    source_normals: np.ndarray | None = None,
    target_normals: np.ndarray | None = None,
    source_colors: np.ndarray | None = None,
    target_colors: np.ndarray | None = None,
    initial_pose: np.ndarray | None = None,
    gt_source_points: np.ndarray | None = None,
    gt_target_points: np.ndarray | None = None,
    run_benchmark: bool = False,
    normal_k: int = 5,
    seed: int = 0,
    device=None,
) -> RegistrationResult:
    """Align ``source_points`` onto ``target_points`` with the configured
    ICP variant on ``device`` (``None`` = the card); returns the pose and
    per-iteration diagnostics.

    Without normals they are estimated on the device: k-NN PCA by the
    Morton-banded exact search from ``normals.FAST_NORMALS_MIN_POINTS`` points on,
    else by the dense one. The clouds are Morton ordered unless matching is
    projective (which indexes the target as an image grid). Large targets
    get a kd index (``icp.build_kd_for``). Random selection draws from a
    ``torch.Generator`` on the device seeded with ``seed`` (its draws are
    not the JAX package's). Without a GT oracle the RMSE curve measures the
    source against its own start (a motion magnitude, not an error)."""
    dev = resolve_device(device)
    config = config or ICPConfig()
    morton = config.matching != Matching.PROJECTIVE

    def make_cloud(pts, nrm, col):
        pts = np.asarray(pts, np.float32)
        if nrm is None:
            nrm = normals_ops.estimate_normals_host(pts, k=normal_k, device=dev)
        return cloud_lib.from_numpy(pts, normals=nrm, colors=col, morton_order=morton,
                                    device=dev)

    source = make_cloud(source_points, source_normals, source_colors)
    target = make_cloud(target_points, target_normals, target_colors)

    if (gt_source_points is None) != (gt_target_points is None):
        raise ValueError(
            "gt_source_points and gt_target_points must be given together "
            "(row i of one corresponds to row i of the other)")
    if gt_source_points is None:
        gt_src = source.points.cpu().numpy()
        gt_tgt = gt_src.copy()
        gt_valid = source.valid.cpu().numpy()
    else:
        gt_src = np.asarray(gt_source_points, np.float32)
        gt_tgt = np.asarray(gt_target_points, np.float32)
        gt_valid = None

    res = icp_mod.run_icp(
        config, source, target, init_pose=initial_pose,
        gt_source_points=gt_src, gt_target_points=gt_tgt, gt_valid=gt_valid,
        generator=torch.Generator(device=dev).manual_seed(seed),
        run_benchmark=run_benchmark,
        kd_index=icp_mod.build_kd_for(config, target, device=dev), device=dev,
    )
    return RegistrationResult(
        pose=res.pose.cpu().numpy(),
        rmse=res.trace.rmse.cpu().numpy(),
        benchmark_error=res.trace.benchmark.cpu().numpy(),
        num_matches=res.trace.num_matches.cpu().numpy(),
    )
