"""Triangle meshes: load/save, RGB-D triangulation, debug geometry.

A numpy copy of ``icp_variants_tpu.data.mesh``, the equivalent of
``SimpleMesh`` (SimpleMesh.h:8-439): OFF/COFF io (via ``off_io``), mesh
construction from an RGB-D frame with edge-threshold
triangulation (SimpleMesh.h:36-119), ``join_meshes`` (265-302) and the
debug-geometry generators sphere/camera/cylinder (307-406) used for
correspondence visualization in the bunny workload (main.cpp:154-172).

All host-side numpy: meshes are artifacts for inspection, not compute.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from icp_variants_tpu_torch.data import off_io


@dataclass
class TriMesh:
    vertices: np.ndarray                       # (V, 3) float32
    triangles: np.ndarray                      # (T, 3) int32
    colors: np.ndarray | None = None           # (V, 4) uint8

    @staticmethod
    def load(path: str) -> "TriMesh":
        m = off_io.read_off(path)
        return TriMesh(m.vertices, m.triangles, m.vertex_colors)

    def write(self, path: str) -> None:
        off_io.write_off(path, self.vertices, self.triangles, self.colors)

    def transformed(self, pose: np.ndarray) -> "TriMesh":
        v = self.vertices @ pose[:3, :3].T + pose[:3, 3]
        return TriMesh(v.astype(np.float32), self.triangles, self.colors)


def from_rgbd_frame(
    depth: np.ndarray,            # (H, W), MINF invalid
    color: np.ndarray,            # (H, W, 4) uint8
    intrinsics: np.ndarray,
    camera_pose_inv: np.ndarray,  # camera-to-world (4, 4)
    edge_threshold: float = 0.01,
) -> TriMesh:
    """Back-project + triangulate an RGB-D frame (SimpleMesh.h:36-119):
    two triangles per pixel quad, dropped when any edge exceeds
    ``edge_threshold`` or any corner is invalid."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]

    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    valid = np.isfinite(depth)
    d = np.where(valid, depth, 0.0)
    cam = np.stack([(uu - cx) / fx * d, (vv - cy) / fy * d, d, np.ones_like(d)], -1)
    world = cam.reshape(-1, 4) @ camera_pose_inv.T
    verts = world[:, :3].astype(np.float32)
    verts[~valid.reshape(-1)] = np.nan

    cols = color.reshape(-1, 4).astype(np.uint8)

    # Quad corners: i0 = (i,j), i1 = (i+1,j), i2 = (i,j+1), i3 = (i+1,j+1).
    i = np.arange(h - 1)[:, None]
    j = np.arange(w - 1)[None, :]
    i0 = (i * w + j).reshape(-1)
    i1 = ((i + 1) * w + j).reshape(-1)
    i2 = (i * w + j + 1).reshape(-1)
    i3 = ((i + 1) * w + j + 1).reshape(-1)

    def edge_ok(a, b):
        e = np.linalg.norm(verts[a] - verts[b], axis=1)
        return np.isfinite(e) & (e < edge_threshold)

    v0, v1, v2, v3 = (valid.reshape(-1)[k] for k in (i0, i1, i2, i3))
    tri1_ok = v0 & v1 & v2 & edge_ok(i0, i1) & edge_ok(i0, i2) & edge_ok(i1, i2)
    tri2_ok = v1 & v2 & v3 & edge_ok(i3, i1) & edge_ok(i3, i2) & edge_ok(i1, i2)

    tris = np.concatenate(
        [
            np.stack([i0, i1, i2], 1)[tri1_ok],
            np.stack([i1, i3, i2], 1)[tri2_ok],
        ]
    ).astype(np.int32)
    return TriMesh(verts, tris, cols)


def join_meshes(a: TriMesh, b: TriMesh, pose_a: np.ndarray | None = None) -> TriMesh:
    """Concatenate two meshes, transforming ``a`` by ``pose_a``
    (SimpleMesh::joinMeshes, SimpleMesh.h:265-302)."""
    if pose_a is not None:
        a = a.transformed(pose_a)
    verts = np.concatenate([a.vertices, b.vertices])
    tris = np.concatenate([a.triangles, b.triangles + len(a.vertices)])
    if a.colors is not None or b.colors is not None:
        ca = a.colors if a.colors is not None else np.full((len(a.vertices), 4), 255, np.uint8)
        cb = b.colors if b.colors is not None else np.full((len(b.vertices), 4), 255, np.uint8)
        colors = np.concatenate([ca, cb])
    else:
        colors = None
    return TriMesh(verts.astype(np.float32), tris.astype(np.int32), colors)


def sphere(
    center: np.ndarray,
    radius: float,
    color: tuple[int, int, int, int] = (0, 0, 255, 255),
    slices: int = 6,
    stacks: int = 6,
) -> TriMesh:
    """Small UV sphere marker (SimpleMesh::sphere, SimpleMesh.h:307-331)."""
    cs = np.asarray(center, np.float32)
    verts = []
    for st in range(stacks + 1):
        phi = np.pi * st / stacks
        for sl in range(slices):
            theta = 2 * np.pi * sl / slices
            verts.append(
                cs
                + radius
                * np.array(
                    [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
                    np.float32,
                )
            )
    verts = np.asarray(verts, np.float32)
    tris = []
    for st in range(stacks):
        for sl in range(slices):
            a = st * slices + sl
            b = st * slices + (sl + 1) % slices
            c = (st + 1) * slices + sl
            d = (st + 1) * slices + (sl + 1) % slices
            tris.append((a, b, c))
            tris.append((b, d, c))
    colors = np.tile(np.asarray(color, np.uint8), (len(verts), 1))
    return TriMesh(verts, np.asarray(tris, np.int32), colors)


def camera_marker(pose: np.ndarray, scale: float = 0.0015) -> TriMesh:
    """Camera frustum marker at ``pose`` (SimpleMesh::camera,
    SimpleMesh.h:336-359): a small pyramid opening along +z."""
    apex = np.zeros(3, np.float32)
    base = np.array(
        [[-4, -3, 6], [4, -3, 6], [4, 3, 6], [-4, 3, 6]], np.float32
    ) * scale
    verts = np.concatenate([apex[None], base])
    verts = verts @ pose[:3, :3].T + pose[:3, 3]
    tris = np.asarray(
        [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 3, 2], [1, 4, 3]], np.int32
    )
    colors = np.tile(np.asarray((255, 0, 0, 255), np.uint8), (len(verts), 1))
    return TriMesh(verts.astype(np.float32), tris, colors)


def cylinder(
    p0: np.ndarray, p1: np.ndarray, radius: float, segments: int = 8,
    color: tuple[int, int, int, int] = (0, 255, 0, 255),
) -> TriMesh:
    """Cylinder between two points (SimpleMesh::cylinder, SimpleMesh.h:364-406)
    — correspondence-line visualization."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    if length < 1e-12:
        axis = np.array([0, 0, 1], np.float32)
        length = 1e-12
    axis = axis / length
    ref = np.array([1, 0, 0], np.float32)
    if abs(axis @ ref) > 0.9:
        ref = np.array([0, 1, 0], np.float32)
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)

    verts = []
    for end in (p0, p1):
        for s in range(segments):
            ang = 2 * np.pi * s / segments
            verts.append(end + radius * (np.cos(ang) * u + np.sin(ang) * v))
    verts = np.asarray(verts, np.float32)
    tris = []
    for s in range(segments):
        a, b = s, (s + 1) % segments
        c, d = segments + s, segments + (s + 1) % segments
        tris.append((a, b, c))
        tris.append((b, d, c))
    colors = np.tile(np.asarray(color, np.uint8), (len(verts), 1))
    return TriMesh(verts, np.asarray(tris, np.int32), colors)
