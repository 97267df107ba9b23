"""OFF / COFF triangle-mesh reader and writer (host side, numpy).

Port of ``icp_variants_tpu.data.off_io`` (the reference's
``SimpleMesh::loadMesh`` / ``writeMesh``, SimpleMesh.h:161-259). The port
parses with numpy alone; the JAX package's native scanner waits for the
ETH data path's ctypes wrapper.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


@dataclass
class OffMesh:
    vertices: np.ndarray          # (V, 3) float32
    triangles: np.ndarray         # (T, 3) int32
    vertex_colors: np.ndarray | None = None  # (V, 4) uint8 if COFF


def read_off(path: str) -> OffMesh:
    """Read an OFF or COFF file.

    COFF rows carry ``x y z r g b a`` (SimpleMesh.h:176-203); face rows are
    ``3 i0 i1 i2``. Vertex rows parse to float64 and round once to float32,
    as the JAX package's parsers (its native scanner or this numpy path)
    do, so the vertices are bit for bit the same."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", errors="replace").strip()
        if header not in ("OFF", "COFF"):
            raise ValueError(f"{path}: not an OFF/COFF file (header {header!r})")
        has_color = header == "COFF"
        counts = f.readline().decode("ascii", errors="replace").split()
        n_vertices, n_faces = int(counts[0]), int(counts[1])
        body = f.read().decode("ascii", errors="replace")

    data = np.loadtxt(io.StringIO(body), max_rows=n_vertices, dtype=np.float64, ndmin=2)
    vertices = data[:, :3].astype(np.float32)
    colors = None
    if has_color and data.shape[1] >= 7:
        colors = data[:, 3:7].astype(np.uint8)

    triangles = np.zeros((n_faces, 3), dtype=np.int32)
    if n_faces > 0:
        # Faces start right after the vertex block.
        lines = [ln for ln in body.splitlines() if ln.strip()]
        face_lines = lines[n_vertices:n_vertices + n_faces]
        face_data = np.loadtxt(io.StringIO("\n".join(face_lines)), dtype=np.int64, ndmin=2)
        if not np.all(face_data[:, 0] == 3):
            raise ValueError(f"{path}: only triangle faces supported")
        triangles = face_data[:, 1:4].astype(np.int32)
    return OffMesh(vertices=vertices, triangles=triangles, vertex_colors=colors)


def write_off(
    path: str,
    vertices: np.ndarray,
    triangles: np.ndarray,
    vertex_colors: np.ndarray | None = None,
) -> None:
    """Write an OFF (or COFF when colors given) file, matching the layout the
    reference emits (SimpleMesh.h:231-259)."""
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles, dtype=np.int64)
    with open(path, "w") as f:
        if vertex_colors is not None:
            f.write("COFF\n")
        else:
            f.write("OFF\n")
        f.write(f"{len(vertices)} {len(triangles)} 0\n")
        if vertex_colors is not None:
            cols = np.asarray(vertex_colors, dtype=np.int64)
            for v, c in zip(vertices, cols):
                f.write(
                    f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]} {c[3]}\n"
                )
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
