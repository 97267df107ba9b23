"""Synthetic scans and RGB-D frames, made on the host from a seed.

Copies of the repository's ``bench.py`` generators (``synth_cloud``,
``synth_depth_frame`` and the TUM camera constants), taken from its text
so that the yardstick does not move when the program's files do. The
depth frame's camera sits at ``x = -TUM_SHIFT * i``.
"""

from __future__ import annotations

import numpy as np

TUM_W, TUM_H = 640, 480
TUM_FX = TUM_FY = 525.0                 # main.cpp:236 sensor calibration
TUM_CX, TUM_CY = 319.5, 239.5
TUM_SHIFT = 0.01                        # camera x-shift per frame (m)


def synth_cloud(n, seed):
    """Structured surface-ish cloud at ETH scale (~tens of meters)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    z = (
        2.0 * np.sin(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1])
        + 0.1 * rng.standard_normal(n)
    ).astype(np.float32)
    pts = np.column_stack([xy, z])
    nrm = np.column_stack(
        [
            -0.6 * np.cos(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1]),
            0.4 * np.sin(0.3 * xy[:, 0]) * np.sin(0.2 * xy[:, 1]),
            np.ones(n, np.float32),
        ]
    ).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def synth_depth_frame(i):
    """Indoor-like 640x480 depth frame: wavy surface + raised boxes
    ('furniture' with sharp depth steps -> invalid normals at the edges,
    like real TUM frames), viewed from a camera at x = -TUM_SHIFT*i.
    Returns (depth f32 (H, W) in meters, color u8 (H, W, 4))."""
    vv, uu = np.meshgrid(np.arange(TUM_H), np.arange(TUM_W), indexing="ij")
    sx = TUM_SHIFT * i
    z = np.full((TUM_H, TUM_W), 2.0)
    boxes = [(-0.6, -0.3, 0.35, 0.25, 0.5), (0.4, 0.2, 0.3, 0.3, 0.35),
             (0.1, -0.5, 0.2, 0.2, 0.25)]
    for _ in range(8):  # fixed-point solve of the pixel-ray / surface hit
        xw = (uu - TUM_CX) / TUM_FX * z - sx
        yw = (vv - TUM_CY) / TUM_FY * z
        base = 2.0 + 0.12 * np.sin(3.0 * xw) * np.cos(3.0 * yw)
        for (bx, by, w, h, dz) in boxes:
            inside = (np.abs(xw - bx) < w) & (np.abs(yw - by) < h)
            base = np.where(inside, base - dz, base)
        z = base
    # Smooth structured colors from the world coordinates so the 6-dim
    # color features carry real matching signal.
    xw = (uu - TUM_CX) / TUM_FX * z - sx
    yw = (vv - TUM_CY) / TUM_FY * z
    color = np.stack([
        (127 + 120 * np.sin(5.0 * xw)).astype(np.uint8),
        (127 + 120 * np.cos(4.0 * yw)).astype(np.uint8),
        (127 + 120 * np.sin(3.0 * (xw + yw))).astype(np.uint8),
        np.full((TUM_H, TUM_W), 255, np.uint8),
    ], axis=-1)
    return z.astype(np.float32), color


def intrinsics() -> np.ndarray:
    """The TUM depth camera's 3x3 intrinsics."""
    return np.array([[TUM_FX, 0, TUM_CX], [0, TUM_FY, TUM_CY], [0, 0, 1]], np.float32)
