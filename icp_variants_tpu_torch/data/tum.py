"""TUM RGB-D dataset sensor (host side).

Port of ``icp_variants_tpu.data.tum``, the equivalent of ``VirtualSensor``
(VirtualSensor.h:14-288): reads the
``depth.txt`` / ``rgb.txt`` / ``groundtruth.txt`` lists of a TUM sequence
(https://vision.in.tum.de/data/datasets/rgbd-dataset/file_formats),
decodes frames on demand, and exposes the hardcoded 640x480 / f=525 /
c=(319.5, 239.5) calibration (VirtualSensor.h:38-48).

Conventions preserved:
* depth = u16 png / 5000, zero -> -inf (the reference's MINF sentinel,
  VirtualSensor.h:80-85),
* ground-truth trajectory entries are INVERTED to world-to-camera on load
  (VirtualSensor.h:243), matched to a frame by nearest timestamp
  (VirtualSensor.h:87-98).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from PIL import Image

MINF = -np.inf

WIDTH = 640
HEIGHT = 480


def default_intrinsics() -> np.ndarray:
    """f=525, c=(319.5, 239.5) (VirtualSensor.h:44-46)."""
    return np.array(
        [[525.0, 0.0, 319.5], [0.0, 525.0, 239.5], [0.0, 0.0, 1.0]], np.float32
    )


def _read_file_list(path: str) -> tuple[list[str], np.ndarray]:
    """Parse a TUM list file: 3 comment lines, then 'timestamp filename'."""
    names, stamps = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            stamps.append(float(parts[0]))
            names.append(parts[1])
    return names, np.asarray(stamps, np.float64)


def _quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ],
        np.float64,
    )


def _read_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt rows 'ts tx ty tz qx qy qz qw' -> world-to-camera
    poses (inverted like VirtualSensor.h:243)."""
    poses, stamps = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            T = np.eye(4)
            T[:3, :3] = _quat_to_matrix(qx, qy, qz, qw)
            T[:3, 3] = (tx, ty, tz)
            poses.append(np.linalg.inv(T).astype(np.float32))
            stamps.append(ts)
    return np.asarray(poses, np.float32), np.asarray(stamps, np.float64)


@dataclass
class Frame:
    index: int
    depth: np.ndarray       # (H, W) float32, MINF where invalid
    color: np.ndarray       # (H, W, 4) uint8 RGBX
    trajectory: np.ndarray  # (4, 4) world-to-camera GT pose


class VirtualSensor:
    """Frame-indexed access to a TUM RGB-D sequence."""

    def __init__(
        self,
        dataset_dir: str,
        increment: int = 1,
        width: int = WIDTH,
        height: int = HEIGHT,
    ):
        # The reference hardcodes 640x480 (VirtualSensor.h:38-41); the
        # override exists for small synthetic test sequences.
        self.base_dir = dataset_dir
        self.increment = increment
        self.depth_files, self.depth_stamps = _read_file_list(
            os.path.join(dataset_dir, "depth.txt")
        )
        self.color_files, self.color_stamps = _read_file_list(
            os.path.join(dataset_dir, "rgb.txt")
        )
        self.trajectory, self.traj_stamps = _read_trajectory(
            os.path.join(dataset_dir, "groundtruth.txt")
        )
        if len(self.depth_files) != len(self.color_files):
            # The reference init fails outright (VirtualSensor.h:35); pairing
            # by index is its contract, so mismatched lists are an error.
            raise ValueError("depth.txt and rgb.txt length mismatch")
        self.intrinsics = default_intrinsics()
        if (width, height) != (WIDTH, HEIGHT):
            # Scale the principal point for non-standard test resolutions.
            self.intrinsics = np.array(
                [[525.0 * width / WIDTH, 0.0, (width - 1) / 2.0],
                 [0.0, 525.0 * height / HEIGHT, (height - 1) / 2.0],
                 [0.0, 0.0, 1.0]], np.float32,
            )
        self.extrinsics = np.eye(4, dtype=np.float32)
        self.width = width
        self.height = height
        self.current_index = -1

    def __len__(self) -> int:
        return len(self.depth_files)

    def process_frame_index(self, index: int) -> Frame | None:
        """Load frame ``index`` (VirtualSensor.h:104-140); None past the end."""
        if index < 0 or index >= len(self.depth_files):
            return None
        depth_raw = np.asarray(
            Image.open(os.path.join(self.base_dir, self.depth_files[index]))
        )
        depth = np.where(
            depth_raw == 0, MINF, depth_raw.astype(np.float32) / 5000.0
        ).astype(np.float32)

        rgb = np.asarray(
            Image.open(os.path.join(self.base_dir, self.color_files[index])).convert(
                "RGB"
            )
        )
        color = np.concatenate(
            [rgb, np.full((*rgb.shape[:2], 1), 255, np.uint8)], axis=2
        )

        ts = self.depth_stamps[index]
        nearest = int(np.argmin(np.abs(self.traj_stamps - ts)))
        self.current_index = index
        return Frame(
            index=index,
            depth=depth,
            color=color,
            trajectory=self.trajectory[nearest],
        )

    def process_next_frame(self) -> Frame | None:
        idx = 0 if self.current_index < 0 else self.current_index + self.increment
        return self.process_frame_index(idx)
