"""Dataset loaders: the ``DataLoader`` family.

Port of the bunny part of ``icp_variants_tpu.data.loaders`` (the reference
loaders DataLoader.h:4-15 and BunnyDataLoader.h): each ``get_item`` yields
a :class:`Sample` of padded clouds on a device plus a ground-truth pose.
File parsing happens on the host. The ETH loader waits for the ETH data
path (``pcd_io`` and the native parser).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from icp_variants_tpu_torch.core import cloud as cloud_lib
from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.data import off_io

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
