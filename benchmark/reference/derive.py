"""What the program derives from the raw inputs before it registers them,
worked out again in plain NumPy: row orders along Morton curves, padding
to the capacity, back-projection of depth frames and their
central-difference normals.

A frozen copy of the plain semantics the port documents (its
``core.cloud.from_numpy``, ``data.rgbd.cloud_from_depth``,
``ops.normals.backproject_depth`` and the two Morton codes), so that the
reference orders and masks rows as the program does without importing it.
"""

from __future__ import annotations

import numpy as np

PAD_SENTINEL = 2.0e6   # coordinate of padded and invalid rows
PAD_MULTIPLE = 256     # row-count granularity of a padded cloud


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def morton3_codes(points, valid_mask=None):
    """10-bit-per-axis Z-order codes of xyz over the valid rows' box;
    invalid rows get 2**40."""
    xyz = np.asarray(points)[:, :3]
    if valid_mask is None:
        valid_mask = np.abs(xyz).max(axis=1) < 1.0e5
    if not valid_mask.any():
        return np.zeros(len(xyz), np.int64)
    lo = xyz[valid_mask].min(axis=0)
    hi = xyz[valid_mask].max(axis=0)
    scale = 1023.0 / np.maximum(hi - lo, 1e-12)
    q = np.clip((xyz - lo) * scale, 0.0, 1023.0).astype(np.uint32)

    def part(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = part(q[:, 0]) | (part(q[:, 1]) << 1) | (part(q[:, 2]) << 2)
    code = code.astype(np.int64)
    return np.where(valid_mask, code, np.int64(1) << 40)


def morton6_codes(points, colors, valid_mask=None):
    """Z-order codes over [x, y, z, r/255, g/255, b/255] with one shared
    quantisation scale; invalid rows get the largest code."""
    feats = np.concatenate([
        np.asarray(points, np.float64)[:, :3],
        np.asarray(colors, np.float64)[:, :3] / 255.0,
    ], axis=1)
    if valid_mask is None:
        valid_mask = np.abs(feats[:, :3]).max(axis=1) < 1.0e5
    valid_mask = np.asarray(valid_mask, bool)
    if not valid_mask.any():
        return np.zeros(len(feats), np.uint64)
    lo = feats[valid_mask].min(axis=0)
    rng = feats[valid_mask].max(axis=0) - lo
    scale = 1023.0 / max(float(rng.max()), 1e-12)
    q = np.clip((feats - lo) * scale, 0.0, 1023.0).astype(np.uint64)
    code = np.zeros(feats.shape[0], np.uint64)
    for d in range(6):
        for b in range(10):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(6 * b + d)
    code[~valid_mask] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return code


def padded_cloud(points, normals=None, colors=None, valid=None, capacity=None,
                 morton_order=False) -> dict:
    """Rows (optionally in xyz Morton order, stable) padded to the capacity:
    ``points`` (pad rows and invalid rows at PAD_SENTINEL), ``normals``
    (NaN where absent), ``colors`` (first three channels, 0..255),
    ``valid``."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    normals = (np.full((n, 3), np.nan, np.float32) if normals is None
               else np.asarray(normals, np.float32))
    colors = (np.zeros((n, 3), np.float32) if colors is None
              else np.asarray(colors, np.float32)[:, :3])
    if morton_order and n > 0:
        order = np.argsort(morton3_codes(points), kind="stable")
        points, normals, colors = points[order], normals[order], colors[order]
        if valid is not None:
            valid = np.asarray(valid, bool)[order]
    cap = _round_up(capacity if capacity is not None else max(n, 1), PAD_MULTIPLE)
    finite = np.isfinite(points).all(axis=1)
    valid = finite if valid is None else np.asarray(valid, bool) & finite
    out = {
        "points": np.full((cap, 3), PAD_SENTINEL, np.float32),
        "normals": np.full((cap, 3), np.nan, np.float32),
        "colors": np.zeros((cap, 3), np.float32),
        "valid": np.zeros((cap,), bool),
    }
    out["points"][:n] = np.where(valid[:, None], points, PAD_SENTINEL)
    out["normals"][:n] = normals
    out["colors"][:n] = colors
    out["valid"][:n] = valid
    return out


def backproject(depth, intrinsics, max_distance=0.1):
    """Camera-frame points of every pixel in raster order, their normals
    from central differences of the depth (wrapping at the edges; invalid
    where non-finite, where a difference exceeds ``max_distance / 2``, and
    on the image border), and both validity masks."""
    depth = np.asarray(depth, np.float32)
    k = np.asarray(intrinsics, np.float32)
    h, w = depth.shape
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    valid_point = np.isfinite(depth)
    d = np.where(valid_point, depth, np.float32(0.0))
    cam = (((uu - cx) / fx * d).reshape(-1), ((vv - cy) / fy * d).reshape(-1), d.reshape(-1))
    # The camera is the world frame: the identity extrinsics, multiplied out
    # in the order the program spells it.
    e = np.eye(4, dtype=np.float32)
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


def depth_cloud(depth, color, intrinsics, layout: str, capacity: int, downsample: int = 1) -> dict:
    """One frame as the program lays it out. ``layout``:

    * ``image``: every pixel in raster order, validity = valid depth;
    * ``full_colour_morton``: every pixel, rows in 6-dim colour Morton
      order (rows whose point or normal is invalid last), validity = valid
      depth;
    * ``compact``: the pixels with a valid point and normal, in raster
      order;
    * ``compact_xyz_morton``: those pixels, every ``downsample``-th
      first, in xyz Morton order."""
    pts, nrm, ok_pt, ok_nm = backproject(depth, intrinsics)
    cols = np.asarray(color, np.float32).reshape(-1, 4)
    sel = slice(None, None, downsample)
    pts, nrm, cols, ok_pt, ok_nm = pts[sel], nrm[sel], cols[sel], ok_pt[sel], ok_nm[sel]
    if layout in ("image", "full_colour_morton"):
        if layout == "full_colour_morton":
            order = np.argsort(morton6_codes(pts, cols, ok_pt & ok_nm), kind="stable")
            pts, nrm, cols, ok_pt = pts[order], nrm[order], cols[order], ok_pt[order]
        return padded_cloud(pts, nrm, cols, valid=ok_pt, capacity=capacity)
    keep = ok_pt & ok_nm
    return padded_cloud(pts[keep], nrm[keep], cols[keep], capacity=capacity,
                        morton_order=layout == "compact_xyz_morton")
