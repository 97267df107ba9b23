"""Convergence measurement: GT-correspondence RMSE and the ETH (Fontana)
benchmark error.

PyTorch port of ``icp_variants_tpu.pipeline.measure``
(``ConvergenceMeasure``, ConvergenceMeasure.h:15-184). Both are evaluated
on the device inside the ICP loop every iteration; they broadcast over a
leading pair axis.
"""

from __future__ import annotations

import torch

from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.parallel.distributed import psum


def rmse_alignment_error(
    pose: torch.Tensor,            # (..., 4, 4)
    source_points: torch.Tensor,   # (..., G, 3) stored source correspondences
    target_points: torch.Tensor,   # (..., G, 3) fixed counterpart points
    valid: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """RMSE over known correspondences after moving the source by ``pose``
    (ConvergenceMeasure.h:50-66); non-finite pairs are skipped. With
    ``group`` the rows are split over its ranks: the sum and the (integer)
    count are summed across them."""
    moved = se3.transform_points(source_points, pose)
    finite = torch.isfinite(moved).all(dim=-1) & torch.isfinite(target_points).all(dim=-1)
    if valid is not None:
        finite = finite & valid
    d2 = torch.where(finite, torch.sum((moved - target_points) ** 2, dim=-1), 0.0)
    total = psum(torch.sum(d2, dim=-1), group)
    count = psum(torch.sum(finite, dim=-1), group)
    return torch.sqrt(total / torch.clamp_min(count, 1))


def benchmark_error(
    pose: torch.Tensor,
    source_points: torch.Tensor,
    target_points: torch.Tensor,
    valid: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """The ETH/Fontana error (ConvergenceMeasure.h:133-151):
    mean_i |p_i - q_i| / |p_i - centroid(p)| with p the moved source.
    ``group``: as :func:`rmse_alignment_error`."""
    moved = se3.transform_points(source_points, pose)
    if valid is None:
        valid = torch.ones(moved.shape[:-1], dtype=torch.bool, device=moved.device)
    centroid = se3.masked_mean(moved, valid, group=group)
    num = torch.linalg.norm(moved - target_points, dim=-1)
    den = torch.linalg.norm(moved - centroid[..., None, :], dim=-1)
    ratio = torch.where(valid, num / torch.clamp_min(den, 1e-30), 0.0)
    total = psum(torch.sum(ratio, dim=-1), group)
    count = psum(torch.sum(valid, dim=-1), group)
    return total / torch.clamp_min(count, 1)
