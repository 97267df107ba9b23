"""PLY point-cloud/mesh io (host side).

Port of ``icp_variants_tpu.data.ply_io`` (numpy only), the equivalent of
the reference's ``pcl::io::savePLYFile`` usage in
``PointCloud::writeToFile`` (PointCloud.h:229-247: x/y/z + intensity +
normals per vertex) and the .ply artifacts the bunny driver emits
(main.cpp:144-148). ASCII + binary_little_endian, read and write.
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
}


def write_ply(
    path: str,
    points: np.ndarray,
    normals: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    intensity: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write a PLY vertex cloud. With normals and intensity the layout
    matches the reference's XYZINormal export (PointCloud.h:230-243)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    props = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    columns = [points[:, 0], points[:, 1], points[:, 2]]
    if intensity is not None:
        props.append(("intensity", np.float32))
        columns.append(np.asarray(intensity, np.float32))
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        props += [("nx", np.float32), ("ny", np.float32), ("nz", np.float32)]
        columns += [normals[:, 0], normals[:, 1], normals[:, 2]]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        props += [("red", np.uint8), ("green", np.uint8), ("blue", np.uint8)]
        columns += [colors[:, 0], colors[:, 1], colors[:, 2]]

    fmt = "binary_little_endian" if binary else "ascii"
    type_names = {np.float32: "float", np.uint8: "uchar"}
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    header += [f"property {type_names[t]} {name}" for name, t in props]
    header.append("end_header")

    rec = np.empty(n, dtype=[(name, t) for name, t in props])
    for (name, t), col in zip(props, columns):
        rec[name] = col.astype(t)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            np.savetxt(f, np.column_stack([c.astype(np.float64) for c in columns]), fmt="%.7g")


def read_ply(path: str) -> dict:
    """Read a PLY vertex element; returns a dict with 'points' and any of
    'normals', 'colors', 'intensity' present in the file."""
    with open(path, "rb") as f:
        line = f.readline().decode("ascii").strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = 0
        props: list[tuple[str, np.dtype]] = []
        in_vertex = False
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(
                    f"{path}: EOF before end_header (truncated PLY)"
                )
            line = raw.decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((name, _PLY_DTYPES[typ]))
            elif line == "end_header":
                break
        if fmt == "ascii":
            rows = []
            for _ in range(n):
                rows.append([float(x) for x in f.readline().split()])
            arr = np.asarray(rows)
            cols = {name: arr[:, k] for k, (name, _t) in enumerate(props)}
        else:
            dt = np.dtype([(name, t) for name, t in props])
            rec = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            cols = {name: rec[name] for name, _t in props}

    out = {
        "points": np.stack(
            [cols["x"], cols["y"], cols["z"]], axis=1
        ).astype(np.float32)
    }
    if "nx" in cols:
        out["normals"] = np.stack(
            [cols["nx"], cols["ny"], cols["nz"]], axis=1
        ).astype(np.float32)
    if "red" in cols:
        out["colors"] = np.stack(
            [cols["red"], cols["green"], cols["blue"]], axis=1
        ).astype(np.uint8)
    if "intensity" in cols:
        out["intensity"] = np.asarray(cols["intensity"], np.float32)
    return out
