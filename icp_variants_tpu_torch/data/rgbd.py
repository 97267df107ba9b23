"""RGB-D frame -> Cloud bridge (the depth-map PointCloud constructor).

Port of ``icp_variants_tpu.data.rgbd`` (PointCloud.h:78-165): host-side
back-projection (``ops.normals.backproject_depth``), central-difference
normals, stride downsampling and the ``keep_original_size`` contract that
projective matching and multi-resolution rely on. Like the JAX package it
indexes pixel colours at ``4*i`` where the reference reads byte ``i``
(PointCloud.h:158).
"""

from __future__ import annotations

import numpy as np

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.ops import normals as normals_ops
from icp_variants_tpu_torch.ops.knn import morton6_codes_np


def cloud_from_depth(
    depth: np.ndarray,             # (H, W) float32, non-finite = invalid
    color: np.ndarray,             # (H, W, 4) uint8
    intrinsics: np.ndarray,        # (3, 3)
    extrinsics: np.ndarray,        # (4, 4)
    keep_original_size: bool = False,
    downsample_factor: int = 1,
    max_distance: float = 0.1,
    capacity: int | None = None,
    morton_order: bool = False,
    color_morton_order: bool = False,
    *,
    for_projective: bool = False,
    device=None,
) -> Cloud:
    """Build a padded Cloud on ``device`` (``None`` = the card) from an
    RGB-D frame.

    ``keep_original_size=True`` keeps invalid rows in place (validity =
    valid depth; rows with invalid normals carry NaN normals); otherwise
    rows whose point or normal is invalid are dropped on the host.
    ``downsample_factor`` strides pixels in linearized order like the
    reference. ``morton_order`` (compacted path only) Z-orders the kept
    rows in xyz.

    ``color_morton_order`` orders the rows (on both paths; invalid rows
    last) along the 6-dim Morton curve of ``morton6_codes_np``, so the
    seeded colour matcher's 32-row gates hold same-block queries. Multires
    strides then subsample that order rather than the image (a PARITY.md
    deviation of the JAX package, reproduced bit for bit). It destroys the
    image-order row indexing projective matching needs: with
    ``for_projective=True`` (a cloud that feeds projective matching) it
    raises ``ValueError``."""
    if color_morton_order and for_projective:
        raise ValueError(
            "color_morton_order reorders rows off the image grid; projective "
            "matching needs image-order rows")
    extrinsics_inv = np.linalg.inv(np.asarray(extrinsics, np.float32))
    pts, nrm, valid_pt, valid_nm = normals_ops.backproject_depth(
        depth, intrinsics, extrinsics_inv, max_distance=float(max_distance))
    cols = np.asarray(color, np.float32).reshape(-1, 4)

    sel = slice(None, None, downsample_factor)
    pts, nrm, cols = pts[sel], nrm[sel], cols[sel]
    valid_pt, valid_nm = valid_pt[sel], valid_nm[sel]

    if keep_original_size:
        if color_morton_order:
            order = np.argsort(morton6_codes_np(pts, cols, valid_pt & valid_nm), kind="stable")
            pts, nrm, cols = pts[order], nrm[order], cols[order]
            valid_pt, valid_nm = valid_pt[order], valid_nm[order]
        return cloud_lib.from_numpy(
            pts, normals=nrm, colors=cols, valid=valid_pt, capacity=capacity, device=device)

    keep = valid_pt & valid_nm
    pts, nrm, cols = pts[keep], nrm[keep], cols[keep]
    if color_morton_order:
        order = np.argsort(morton6_codes_np(pts, cols), kind="stable")
        pts, nrm, cols = pts[order], nrm[order], cols[order]
    return cloud_lib.from_numpy(
        pts, normals=nrm, colors=cols, capacity=capacity,
        morton_order=morton_order and not color_morton_order, device=device)
