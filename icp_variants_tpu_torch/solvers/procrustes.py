"""Weighted Procrustes / Kabsch alignment (linear point-to-point metric).

PyTorch port of ``icp_variants_tpu.solvers.procrustes``
(``ProcrustesAligner``, ProcrustesAligner.h:4-73), batched over a leading
pair axis: the 3x3 cross-covariance is a masked weighted reduction, its SVD
a batched ``torch.linalg.svd``, and the det-correction plus the
rotate-about-target-mean composition follow the reference.

Reference quirks kept:
* the means are UNWEIGHTED over matched pairs (ProcrustesAligner.h:32-41),
* only the source matrix rows are weighted (ProcrustesAligner.h:51),
* translation = targetMean - sourceMean, composed as
  ``t = R t - R targetMean + targetMean`` (ProcrustesAligner.h:24-26).
"""

from __future__ import annotations

import torch

from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.parallel.distributed import psum, psum_many


def _det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices as a triple product (no LU)."""
    return torch.sum(A[..., 0, :] * torch.linalg.cross(A[..., 1, :], A[..., 2, :], dim=-1),
                     dim=-1)


def estimate_pose_point_to_point(
    src: torch.Tensor,      # (..., N, 3) matched (already-transformed) source points
    tgt: torch.Tensor,      # (..., N, 3) matched target points
    weights: torch.Tensor,  # (..., N)
    valid: torch.Tensor,    # (..., N) bool
    weighted_means: bool = False,
    group=None,
) -> torch.Tensor:
    """Closed-form weighted Kabsch; returns the (..., 4, 4) increment.

    With ``group`` the N axis is split over its ranks: the means and the
    3x3 cross-covariance are summed across them, the SVD runs on every rank.

    ``weighted_means=False`` keeps the reference's unweighted means and its
    weighted-source-rows-only covariance (the quirks above).
    ``weighted_means=True`` is the proper weighted Kabsch (weighted
    centroids, weights applied once in the covariance) that the robust
    HUBER / TUKEY weightings use: their near-zero outlier weights would
    otherwise still move the translation through the unweighted means."""
    m = valid.to(src.dtype)
    if weighted_means:
        wm = weights * m
        wsum, swsum, twsum = psum_many(
            (torch.sum(wm, dim=-1), torch.sum(src * wm[..., None], dim=-2),
             torch.sum(tgt * wm[..., None], dim=-2)), group)
        denom = torch.clamp(wsum, min=1e-30)[..., None]
        src_mean = swsum / denom
        tgt_mean = twsum / denom
        sc = (src - src_mean[..., None, :]) * wm[..., None]
        dc = tgt - tgt_mean[..., None, :]
    else:
        src_mean = se3.masked_mean(src, valid, group=group)
        tgt_mean = se3.masked_mean(tgt, valid, group=group)
        sc = (src - src_mean[..., None, :]) * (weights * m)[..., None]
        dc = (tgt - tgt_mean[..., None, :]) * m[..., None]
    A = psum(dc.transpose(-1, -2) @ sc, group)  # targetMatrix^T * sourceMatrix

    U, _, Vt = torch.linalg.svd(A)
    D = torch.ones_like(A[..., 0]).diag_embed()
    D[..., 2, 2] = _det3(U @ Vt)
    R = U @ D @ Vt

    t = tgt_mean - src_mean
    trans = (R @ t[..., None] - R @ tgt_mean[..., None])[..., 0] + tgt_mean
    return se3.pose_matrix(R, trans)
