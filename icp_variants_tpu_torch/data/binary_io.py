"""The reference's custom binary point-cloud format.

Port of ``icp_variants_tpu.data.binary_io`` (numpy only):
``PointCloud::readFromFile`` (PointCloud.h:167-227): one byte giving the
scalar width (4 = float, 8 = double), a uint32 point count, then n xyz
points followed by n xyz normals, raw little-endian.
"""

from __future__ import annotations

import struct

import numpy as np


def read_binary_cloud(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (points (N,3) f32, normals (N,3) f32)."""
    with open(path, "rb") as f:
        n_bytes = struct.unpack("<b", f.read(1))[0]
        n = struct.unpack("<I", f.read(4))[0]
        dtype = np.float32 if n_bytes == 4 else np.float64
        pts = np.frombuffer(f.read(3 * n_bytes * n), dtype=dtype, count=3 * n)
        nrm = np.frombuffer(f.read(3 * n_bytes * n), dtype=dtype, count=3 * n)
    return (
        pts.reshape(n, 3).astype(np.float32),
        nrm.reshape(n, 3).astype(np.float32),
    )


def write_binary_cloud(
    path: str, points: np.ndarray, normals: np.ndarray, double: bool = False
) -> None:
    points = np.asarray(points)
    normals = np.asarray(normals)
    dtype = np.float64 if double else np.float32
    with open(path, "wb") as f:
        f.write(struct.pack("<b", 8 if double else 4))
        f.write(struct.pack("<I", len(points)))
        f.write(points.astype(dtype).tobytes())
        f.write(normals.astype(dtype).tobytes())
