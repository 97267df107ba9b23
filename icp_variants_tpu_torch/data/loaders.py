"""Dataset loaders: the ``DataLoader`` family.

Port of ``icp_variants_tpu.data.loaders`` (the reference loaders
DataLoader.h:4-15, BunnyDataLoader.h and ETHDataLoader.h): each
``get_item`` yields a :class:`Sample` of padded clouds on a device plus a
ground-truth pose. File parsing happens on the host (the native scanner
for ASCII .pcd bodies); the ETH clouds' normals are estimated on the
loader's device.
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass

import numpy as np

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.core.device import resolve_device, timing_event
from icp_variants_tpu_torch.data import off_io, pcd_io
from icp_variants_tpu_torch.ops import normals as normals_ops

# The repository's asset root: the bunny halves (Stanford bunny split, from
# the reference's Data/ directory, MIT-licensed).
ASSET_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")


@dataclass
class Sample:
    """One registration problem (DataLoader.h:4-10)."""

    source: Cloud
    target: Cloud
    pose: np.ndarray  # (4, 4) ground-truth pose


class DataLoader:
    """Abstract dataset of registration pairs (DataLoader.h:12-15)."""

    def get_length(self) -> int:
        raise NotImplementedError

    def get_item(self, index: int) -> Sample:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.get_length()

    def __getitem__(self, index: int) -> Sample:
        return self.get_item(index)


class BunnyDataLoader(DataLoader):
    """The Stanford-bunny pair: part2_trans (source) -> part1 (target),
    identity GT pose (BunnyDataLoader.h:9-39), its clouds on ``device``
    (``None`` = the card). Vertex normals are the summed incident face
    normals of the mesh constructor (PointCloud.h:24-37)."""

    # Hand-verified GT correspondence indices (main.cpp:106-120).
    GT_SOURCE_INDICES = (215, 424, 640, 1023)
    GT_TARGET_INDICES = (294, 258, 1238, 1310)

    def __init__(self, data_dir: str | None = None, capacity: int | None = None, device=None):
        data_dir = data_dir or os.path.join(ASSET_ROOT, "bunny")
        self.source_mesh = off_io.read_off(os.path.join(data_dir, "bunny_part2_trans.off"))
        self.target_mesh = off_io.read_off(os.path.join(data_dir, "bunny_part1.off"))
        self._capacity = capacity
        self.device = resolve_device(device)

    def get_length(self) -> int:
        return 1

    def _cloud_from_mesh(self, mesh: off_io.OffMesh) -> Cloud:
        normals = cloud_lib.mesh_vertex_normals(mesh.vertices, mesh.triangles)
        colors = None
        if mesh.vertex_colors is not None:
            colors = mesh.vertex_colors.astype(np.float32)
        return cloud_lib.from_numpy(mesh.vertices, normals=normals, colors=colors,
                                    capacity=self._capacity, device=self.device)

    def get_item(self, index: int) -> Sample:
        if index != 0:
            raise IndexError("BunnyDataLoader has exactly one sample")
        return Sample(
            source=self._cloud_from_mesh(self.source_mesh),
            target=self._cloud_from_mesh(self.target_mesh),
            pose=np.eye(4, dtype=np.float32),
        )

    def gt_correspondences(self) -> tuple[np.ndarray, np.ndarray]:
        src = self.source_mesh.vertices[list(self.GT_SOURCE_INDICES)]
        tgt = self.target_mesh.vertices[list(self.GT_TARGET_INDICES)]
        return src, tgt


class ETHDataLoader(DataLoader):
    """ETH laser-registration benchmark loader (ETHDataLoader.h:11-107).

    Reads a pose CSV (``eth/plain_global.csv``-style: per-row source and
    target .pcd file names in columns 1-2 and a 3x4 GT pose in columns
    4-15), loads both clouds from ``<data_root>/<data_name>/``, and
    estimates normals with k-NN PCA (k = 5, the PCL ``NormalEstimation``
    equivalent, PointCloud.h:41-76) on ``device`` (``None`` = the card).

    ``capacity`` pads every cloud of the sequence to one shape so all
    pairs of a batch stack. ``downsample`` strides the points at load time
    (before normals, so they see the subsampled neighbourhood).
    """

    def __init__(
        self,
        csv_path: str,
        data_root: str | None = None,
        capacity: int | None = None,
        estimate_normals: bool = True,
        normal_k: int = 5,
        downsample: int | None = None,
        device=None,
    ):
        self.csv_path = csv_path
        # dataName: the base name without .csv and the _local/_global
        # suffix (ETHDataLoader.h:20-24).
        name = os.path.basename(csv_path)
        if name.endswith(".csv"):
            name = name[: -len(".csv")]
        for suffix in ("_local", "_global"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        self.data_name = name
        self.data_root = data_root or os.path.dirname(csv_path)
        self.capacity = capacity
        self.estimate_normals = estimate_normals
        self.normal_k = normal_k
        self.downsample = downsample
        self.device = resolve_device(device)
        with open(csv_path, newline="") as f:
            self.rows = [r for r in csv.reader(f) if r]  # the first row is the header

    def get_length(self) -> int:
        return len(self.rows) - 1

    def _path(self, pcd_name: str) -> str:
        return os.path.join(self.data_root, self.data_name, pcd_name)

    def _load_cloud(self, pcd_name: str) -> Cloud:
        return self._cloud_from_points(pcd_io.read_pcd(self._path(pcd_name)))

    def point_counts(self, max_pairs: int | None = None) -> np.ndarray:
        """(n_pairs, 2) point counts of every (source, target) pair, from the
        .pcd headers only: a cheap pre-scan for one shared capacity."""
        n = self.get_length() if max_pairs is None else min(max_pairs, self.get_length())
        out = np.zeros((n, 2), np.int64)
        for i in range(n):
            for c, name in enumerate(self.rows[i + 1][1:3]):
                out[i, c] = pcd_io.read_pcd_point_count(self._path(name))
        if self.downsample is not None and self.downsample > 1:
            out = -(-out // self.downsample)  # ceil: the rows the stride keeps
        return out

    def _gt_pose(self, index: int) -> np.ndarray:
        row = self.rows[index + 1]
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :4] = np.asarray([float(x) for x in row[4:16]], np.float32).reshape(3, 4)
        return pose

    def _cloud_from_points(self, pts: np.ndarray) -> Cloud:
        if self.downsample is not None and self.downsample > 1:
            pts = pts[:: self.downsample]
        normals = None
        if self.estimate_normals:
            normals = normals_ops.estimate_normals_host(pts, k=self.normal_k, device=self.device)
        return cloud_lib.from_numpy(pts, normals=normals, capacity=self.capacity,
                                    morton_order=True, device=self.device)

    def _check_index(self, index: int) -> None:
        if index >= self.get_length():
            raise IndexError(f"index {index} out of range, only {self.get_length()} samples")

    def get_item(self, index: int) -> Sample:
        self._check_index(index)
        row = self.rows[index + 1]
        return Sample(source=self._load_cloud(row[1]), target=self._load_cloud(row[2]),
                      pose=self._gt_pose(index))

    def get_scan(self, index: int) -> Cloud:
        """Scan ``index`` (0..n_pairs) of the sequential sequence: pair k
        registers scan k+1 (reading, column 1) onto scan k (reference,
        column 2), so scan k is row k's reference and the last scan is the
        last row's reading (the loop-closure registration's loader)."""
        n = self.get_length()
        if not (0 <= index <= n):
            raise IndexError(f"scan {index} out of range (0..{n})")
        if index < n:
            return self._load_cloud(self.rows[index + 1][2])
        return self._load_cloud(self.rows[n][1])

    def get_items(self, indices, timing: dict | None = None) -> list[Sample]:
        """Load a batch of pairs, parsing all 2B .pcd files concurrently
        through the native thread pool (``pcd_io.read_pcd_batch``); the same
        results as :meth:`get_item` per index. ``timing``, if given, gains
        the host seconds of the parse (``"parse"``) and of the normals,
        Morton order and upload (``"normals"``), and on the card the timing
        events recorded around the latter (``"normals_events"``)."""
        indices = list(indices)
        for i in indices:
            self._check_index(i)
        paths = [self._path(name) for i in indices for name in self.rows[i + 1][1:3]]
        t0 = time.perf_counter()
        points = pcd_io.read_pcd_batch(paths)
        t1 = time.perf_counter()
        ev = timing_event(self.device)
        clouds = [self._cloud_from_points(pts) for pts in points]
        if timing is not None:
            timing["parse"] = timing.get("parse", 0.0) + t1 - t0
            timing["normals"] = timing.get("normals", 0.0) + time.perf_counter() - t1
            timing["normals_events"] = (ev, timing_event(self.device))
        return [Sample(source=clouds[2 * b], target=clouds[2 * b + 1], pose=self._gt_pose(i))
                for b, i in enumerate(indices)]
