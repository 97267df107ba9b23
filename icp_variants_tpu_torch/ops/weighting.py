"""Weighting stage (stage 3): per-correspondence scalar weights.

PyTorch port of ``icp_variants_tpu.ops.weighting`` (weighting.h:8-100),
including the reference's quirks: COLORS multiplies the distance weight by
the color term, and the color difference wraps modulo 256 like Eigen's
``unsigned char`` vectors. Non-finite points/normals weigh 0. Invalid
matches are left untouched; consumers fold the validity mask in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_variants_tpu_torch.pipeline.config import Weighting

MAX_COLOR_DIFFERENCE = 195075.0  # weighting.h:6


class MatchArrays(NamedTuple):
    """Gathered per-correspondence data (the SoA form of ``Match``)."""

    src_points: torch.Tensor   # (..., N, 3) transformed source points
    tgt_points: torch.Tensor   # (..., N, 3) matched target points
    src_normals: torch.Tensor  # (..., N, 3) transformed source normals
    tgt_normals: torch.Tensor  # (..., N, 3) matched target normals
    src_colors: torch.Tensor   # (..., N, 4)
    tgt_colors: torch.Tensor   # (..., N, 4)
    valid: torch.Tensor        # (..., N) bool


def _finite(*xs: torch.Tensor) -> torch.Tensor:
    out = None
    for x in xs:
        f = torch.isfinite(x).all(dim=-1)
        out = f if out is None else out & f
    return out


def _distances_weight(src, tgt, max_distance) -> torch.Tensor:
    """1 - |s - t|^2 / maxDistance (weighting.h:16-20)."""
    d2 = torch.sum((src - tgt) ** 2, dim=-1)
    return torch.where(_finite(src, tgt), 1.0 - d2 / max_distance, 0.0)


def _normals_weight(src_n, tgt_n) -> torch.Tensor:
    """n_s . n_t (weighting.h:22-25)."""
    return torch.where(_finite(src_n, tgt_n), torch.sum(src_n * tgt_n, dim=-1), 0.0)


def _robust_center_scale(d2, valid, max_d2, group=None):
    """Robust (median, 1.4826 * MAD) of the residual magnitudes from two
    histogram quantiles; floored at one bin width. With ``group`` both
    histograms sum over its ranks, so every rank weighs against one scale."""
    from icp_variants_tpu_torch.ops import rejection

    _, cut, bin_w = rejection.quantile_bin(d2, valid, 0.5, max_d2, group=group)
    med = torch.sqrt((cut.float() + 0.5) * bin_w)
    dev2 = (torch.sqrt(torch.clamp_min(d2, 0.0)) - med[..., None]) ** 2
    _, cut_dev, _ = rejection.quantile_bin(dev2, valid, 0.5, max_d2, group=group)
    mad = torch.sqrt((cut_dev.float() + 0.5) * bin_w)
    sigma = 1.4826 * torch.clamp_min(mad, bin_w ** 0.5)
    return med, sigma


def _huber_weight(src, tgt, valid, max_d2, group=None) -> torch.Tensor:
    """Huber IRLS weight, k = 1.345 sigma (extension)."""
    d2 = torch.sum((src - tgt) ** 2, dim=-1)
    r = torch.sqrt(d2)
    _, sigma = _robust_center_scale(d2, valid, max_d2, group=group)
    w = torch.clamp(1.345 * sigma[..., None] / torch.clamp_min(r, 1e-30), max=1.0)
    return torch.where(_finite(src, tgt), w, 0.0)


def _tukey_weight(src, tgt, valid, max_d2, group=None) -> torch.Tensor:
    """Tukey biweight IRLS weight, c = 4.685 sigma (extension)."""
    d2 = torch.sum((src - tgt) ** 2, dim=-1)
    r = torch.sqrt(d2)
    _, sigma = _robust_center_scale(d2, valid, max_d2, group=group)
    u = torch.clamp(r / (4.685 * sigma[..., None]), 0.0, 1.0)
    return torch.where(_finite(src, tgt), (1.0 - u * u) ** 2, 0.0)


def _colors_weight(src_c, tgt_c) -> torch.Tensor:
    """1 - |wrap8(c_s - c_t)|^2 / 195075 over RGB (weighting.h:27-30)."""
    diff = torch.remainder(src_c[..., :3] - tgt_c[..., :3], 256.0)
    return 1.0 - torch.sum(diff * diff, dim=-1) / MAX_COLOR_DIFFERENCE


def apply_weights(method: Weighting, m: MatchArrays, max_distance: float,
                  group=None) -> torch.Tensor:
    """Per-match weights for the configured method (not masked). ``group``:
    the ranks the match axis is split over; the robust methods sum their
    scale histograms across them (the others are pointwise)."""
    if method == Weighting.CONSTANT:
        return torch.ones(m.valid.shape, dtype=torch.float32, device=m.valid.device)
    if method == Weighting.DISTANCES:
        return _distances_weight(m.src_points, m.tgt_points, max_distance)
    if method == Weighting.NORMALS:
        return _normals_weight(m.src_normals, m.tgt_normals)
    if method == Weighting.COLORS:
        w = _distances_weight(m.src_points, m.tgt_points, max_distance)
        return w * _colors_weight(m.src_colors, m.tgt_colors)
    if method == Weighting.HUBER:
        return _huber_weight(m.src_points, m.tgt_points, m.valid, max_distance, group=group)
    if method == Weighting.TUKEY:
        return _tukey_weight(m.src_points, m.tgt_points, m.valid, max_distance, group=group)
    raise ValueError(f"unknown weighting method {method}")
