"""Padded, masked point-cloud container.

PyTorch port of ``icp_variants_tpu.core.cloud``. A :class:`Cloud` holds
fixed-size tensors plus a validity mask, optionally with a leading pair
axis B on every field (the batched driver stacks clouds that way):

* ``points  (..., N, 3) float32`` — padded/invalid rows hold ``PAD_SENTINEL``,
* ``normals (..., N, 3) float32`` — NaN rows mark "invalid normal",
* ``colors  (..., N, 4) float32`` in [0, 255],
* ``valid   (..., N)    bool``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.core.device import resolve_device

# Coordinate written into padded/invalid rows: a padded target never
# matches (distance^2 ~ 1e13 >> any threshold), squares stay finite in f32.
PAD_SENTINEL = 2.0e6

# Row-count granularity; kept equal to the JAX package's so capacities
# (and hence kd index shapes and selection draws) agree.
PAD_MULTIPLE = 256


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Cloud(NamedTuple):
    """Fixed-size masked point cloud."""

    points: torch.Tensor   # (..., N, 3) f32
    normals: torch.Tensor  # (..., N, 3) f32, NaN rows = invalid normal
    colors: torch.Tensor   # (..., N, 4) f32 in [0, 255]
    valid: torch.Tensor    # (..., N) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)

    def to(self, device) -> "Cloud":
        return Cloud(*(t.to(device) for t in self))


def from_numpy(
    points: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    valid: np.ndarray | None = None,
    capacity: int | None = None,
    morton_order: bool = False,
    device=None,
) -> Cloud:
    """Build a padded :class:`Cloud` from host arrays on ``device``
    (``None`` = the card).

    ``morton_order=True`` reorders rows along the same Z-order curve as the
    JAX package (``ops.knn.morton_codes_np``, stable sort) — the order is
    semantic (it decides which rows a query tile or a stride level holds),
    so it comes out bit for bit the same.
    """
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if morton_order and n > 0:
        from icp_variants_tpu_torch.ops.knn import morton_codes_np

        order = np.argsort(morton_codes_np(points), kind="stable")
        points = points[order]
        if normals is not None:
            normals = np.asarray(normals, dtype=np.float32)[order]
        if colors is not None:
            colors = np.asarray(colors, dtype=np.float32)[order]
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)[order]
    cap = capacity if capacity is not None else _round_up(max(n, 1), PAD_MULTIPLE)
    if cap < n:
        raise ValueError(f"capacity {cap} < number of points {n}")
    cap = _round_up(cap, PAD_MULTIPLE)

    normals = (np.full((n, 3), np.nan, np.float32) if normals is None
               else np.asarray(normals, dtype=np.float32))
    if colors is None:
        colors = np.zeros((n, 4), dtype=np.float32)
    else:
        colors = np.asarray(colors, dtype=np.float32)
        if colors.shape[1] == 3:
            colors = np.concatenate([colors, np.zeros((n, 1), np.float32)], axis=1)
    finite = np.isfinite(points).all(axis=1)
    valid = finite if valid is None else np.asarray(valid, dtype=bool) & finite

    pts = np.full((cap, 3), PAD_SENTINEL, dtype=np.float32)
    pts[:n] = np.where(valid[:, None], points, PAD_SENTINEL)
    nrm = np.full((cap, 3), np.nan, dtype=np.float32)
    nrm[:n] = normals
    col = np.zeros((cap, 4), dtype=np.float32)
    col[:n] = colors
    val = np.zeros((cap,), dtype=bool)
    val[:n] = valid
    return Cloud(
        points=torch.from_numpy(pts).to(dev),
        normals=torch.from_numpy(nrm).to(dev),
        colors=torch.from_numpy(col).to(dev),
        valid=torch.from_numpy(val).to(dev),
    )


def coarse_stride_mask(
    cloud: Cloud, stride: int, index_offset: int = 0
) -> torch.Tensor:
    """Validity mask of the stride-subsampled cloud
    (``getCoarseResolution``, PointCloud.h:325-343): row i survives iff
    ``(i + index_offset) % stride == 0``, it is valid and its normal is
    finite."""
    idx = torch.arange(cloud.capacity, device=cloud.points.device) + index_offset
    finite_normal = torch.isfinite(cloud.normals).all(dim=-1)
    return (idx % stride == 0) & cloud.valid & finite_normal


def multires_initial_stride(num_points: int, minimum_points: int = 100) -> int:
    """Coarsest level stride: halve the point count until it would drop
    below ``minimum_points`` (ICPOptimizer.h:21, 196-208)."""
    stride = 1
    size = num_points
    while True:
        size = size // 2
        if size < minimum_points:
            break
        stride *= 2
    return stride


def multires_stride_schedule(
    num_points: int, n_iterations: int, enabled: bool, minimum_points: int = 100
) -> np.ndarray:
    """Per-iteration stride schedule of the reference's coarse-to-fine loop
    (ICPOptimizer.h:238, 319-341): iteration i runs at stride
    ``max(R / 2^i, 1)``; the loop runs past ``n_iterations`` until full
    resolution is reached."""
    if not enabled:
        return np.ones((n_iterations,), dtype=np.int32)
    stride = multires_initial_stride(num_points, minimum_points)
    strides = []
    i = 0
    while True:
        strides.append(stride)
        if stride == 1 and i >= n_iterations - 1:
            break
        stride = max(stride // 2, 1)
        i += 1
    return np.asarray(strides, dtype=np.int32)
