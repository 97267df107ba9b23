"""Rejection stage (stage 4): normal-compatibility pruning as a mask.

PyTorch port of ``icp_variants_tpu.ops.rejection``
(``ICPOptimizer::pruneCorrespondences``, ICPOptimizer.h:157-174): a match
is invalidated when its normals differ by more than 60 degrees. As in
C++, ``acos(nan) > threshold`` is false, so matches with non-finite
normals are kept.
"""

from __future__ import annotations

import math

import torch

from icp_variants_tpu_torch.parallel.distributed import psum

ANGLE_THRESHOLD_RAD = 60.0 * math.pi / 180.0
TRIM_BINS = 1024


def normal_angle_mask(
    src_normals: torch.Tensor,
    tgt_normals: torch.Tensor,
    valid: torch.Tensor,
    threshold_rad: float = ANGLE_THRESHOLD_RAD,
) -> torch.Tensor:
    """Validity after the normal-angle test: reject iff cos(angle) <
    cos(threshold), and never when the cosine is NaN."""
    dot = torch.sum(src_normals * tgt_normals, dim=-1)
    norm_prod = torch.linalg.norm(src_normals, dim=-1) * torch.linalg.norm(tgt_normals, dim=-1)
    cos_angle = dot / norm_prod
    reject = (cos_angle < math.cos(threshold_rad)) & ~torch.isnan(cos_angle)
    return valid & ~reject


def quantile_bin(d2, valid, q: float, max_d2: float, group=None):
    """Histogram quantile over the last axis: ``(bin_idx, cut, bin_w)``
    where ``cut`` is the first of TRIM_BINS equal bins over [0, max_d2]
    whose cumulative valid count reaches ``ceil(q * n)``. With ``group`` the
    last axis is split over its ranks: the (..., TRIM_BINS) int32 counts
    are summed across them, so the cut is bit-identical on every rank."""
    nbins = TRIM_BINS
    bin_w = max_d2 / nbins
    idx = torch.clamp((d2 * (nbins / max_d2)).to(torch.int32), 0, nbins - 1)
    bins = torch.arange(nbins, dtype=torch.int32, device=d2.device)
    cum = torch.sum(
        (idx[..., :, None] <= bins) & valid[..., :, None], dim=-2, dtype=torch.int32)
    cum = psum(cum, group)
    n = cum[..., -1]
    k = torch.ceil(q * n.float()).to(torch.int32)
    cut = torch.argmax((cum >= k[..., None]).to(torch.uint8), dim=-1).to(torch.int32)
    return idx, cut, bin_w


def trimmed_mask(d2, valid, ratio: float, max_d2: float, group=None) -> torch.Tensor:
    """Trimmed-ICP rejection (extension): keep the best ``ratio`` fraction
    of valid matches by squared distance; ties at the cut bin are kept.
    ``group``: see :func:`quantile_bin`."""
    idx, cut, _ = quantile_bin(d2, valid, ratio, max_d2, group=group)
    return valid & (idx <= cut[..., None])
