"""Depth back-projection on the host.

Port of ``icp_variants_tpu.ops.normals.backproject_depth`` (the depth-map
PointCloud constructor, PointCloud.h:92-142). It runs once per frame at
load time, like the kd build, in numpy float32 with the JAX package's
operation order, so the points (and with them the 6-dim Morton order of
``data.rgbd.cloud_from_depth``) equal the JAX package's on the same inputs.
The k-NN PCA normals of the rest of the JAX module are not ported yet
(ROADMAP.md queue 1 item 2).
"""

from __future__ import annotations

import numpy as np


def backproject_depth(depth, intrinsics, extrinsics_inv, max_distance: float = 0.1):
    """Back-project a depth image into a (H*W)-row point set with normals.

    * point = Rinv @ [(u - cx) / fx * d, (v - cy) / fy * d, d] + tinv;
    * normal = normalize([-du, -dv, 1]) from central differences of the
      depth (wrapping at the image edge), invalid when non-finite or
      |du|, |dv| > max_distance / 2; left in the camera frame, as the
      reference does;
    * image borders get invalid normals.

    Returns numpy ``(points (H*W, 3) f32, normals (H*W, 3) f32 with NaN
    rows where invalid, valid_point (H*W,), valid_normal (H*W,))``.
    """
    depth = np.asarray(depth, np.float32)
    k = np.asarray(intrinsics, np.float32)
    e = np.asarray(extrinsics_inv, np.float32)
    h, w = depth.shape
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    valid_point = np.isfinite(depth)
    d = np.where(valid_point, depth, np.float32(0.0))
    cam = (((uu - cx) / fx * d).reshape(-1), ((vv - cy) / fy * d).reshape(-1), d.reshape(-1))
    pts = np.stack([cam[0] * e[i, 0] + cam[1] * e[i, 1] + cam[2] * e[i, 2] + e[i, 3]
                    for i in range(3)], axis=-1)

    half = np.float32(max_distance / 2.0)
    with np.errstate(invalid="ignore"):
        du = np.float32(0.5) * (np.roll(depth, -1, axis=1) - np.roll(depth, 1, axis=1))
        dv = np.float32(0.5) * (np.roll(depth, -1, axis=0) - np.roll(depth, 1, axis=0))
        grad_ok = (np.isfinite(du) & np.isfinite(dv)
                   & (np.abs(du) <= half) & (np.abs(dv) <= half))
        n = np.stack([-du, -dv, np.ones_like(du)], axis=-1)
        n = n / np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    border = (uu == 0) | (uu == w - 1) | (vv == 0) | (vv == h - 1)
    valid_normal = grad_ok & ~border
    normals = np.where(valid_normal[..., None], n, np.float32(np.nan)).reshape(-1, 3)
    return (pts.astype(np.float32), normals.astype(np.float32),
            valid_point.reshape(-1), valid_normal.reshape(-1))
