"""PCD (Point Cloud Data) file reader and writer, on the host.

Port of ``icp_variants_tpu.data.pcd_io`` (the PCL ``loadPCDFile`` of the
ETH loader, ETHDataLoader.h:66-89): v0.7 files in ``ascii`` or ``binary``
with any field layout; only x/y/z are extracted, like the reference's
``pcl::PointXYZ`` load. ASCII bodies are parsed by the native f32 scanner
(``runtime/native``); :func:`read_pcd_batch` parses many files at once
through its thread pool. The native library is required: the port has no
numpy fallback for ASCII bodies.
"""

from __future__ import annotations

import numpy as np

from icp_variants_tpu_torch.runtime import native

_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


def _read_header(path: str):
    """Parse a .pcd header; returns ``(header_dict, body_offset)``."""
    with open(path, "rb") as f:
        header = {}
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: EOF before DATA line (truncated or not a .pcd)")
            line = raw.decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        return header, f.tell()


def _fields(header):
    fields = [s.lower() for s in header["FIELDS"]]
    counts = [int(s) for s in header.get("COUNT", ["1"] * len(fields))]
    return fields, counts


def _ascii_xyz(arr: np.ndarray, header) -> np.ndarray:
    fields, counts = _fields(header)
    n_points = int(header["POINTS"][0])
    row_len = sum(counts)
    arr = arr[: n_points * row_len].reshape(n_points, row_len)
    cols = {}
    off = 0
    for name, cnt in zip(fields, counts):
        cols[name] = arr[:, off]
        off += cnt
    return np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)


def _binary_xyz(body: bytes, header) -> np.ndarray:
    fields, counts = _fields(header)
    sizes = [int(s) for s in header["SIZE"]]
    n_points = int(header["POINTS"][0])
    dtype_fields = []
    for name, size, typ, cnt in zip(fields, sizes, header["TYPE"], counts):
        base = _DTYPES[(typ, size)]
        dtype_fields.append((name, base) if cnt == 1 else (name, base, (cnt,)))
    arr = np.frombuffer(body, dtype=np.dtype(dtype_fields), count=n_points)
    return np.stack([arr["x"].astype(np.float32), arr["y"].astype(np.float32),
                     arr["z"].astype(np.float32)], axis=1)


def _ascii_count(header) -> int:
    _, counts = _fields(header)
    return int(header["POINTS"][0]) * sum(counts)


def _read_binary(path: str, header, body_offset: int) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(body_offset)
        return _binary_xyz(f.read(), header)


def _checked_ascii(path: str, arr: np.ndarray, header) -> np.ndarray:
    want = _ascii_count(header)
    if arr.size != want:
        raise ValueError(f"{path}: ascii body holds {arr.size} numbers, the header says {want}")
    return _ascii_xyz(arr, header)


def read_pcd(path: str) -> np.ndarray:
    """Read a .pcd file; returns (N, 3) float32 xyz."""
    header, body_offset = _read_header(path)
    kind = header["DATA"][0].lower()
    if kind == "ascii":
        # f32 scan, the same rounding as the batch path (strtof in both).
        arr = native.parse_floats(path, body_offset, _ascii_count(header), dtype=np.float32)
        return _checked_ascii(path, arr, header)
    if kind == "binary":
        return _read_binary(path, header, body_offset)
    raise ValueError(f"{path}: unsupported PCD DATA kind {kind!r}")


def read_pcd_batch(paths: list[str], n_threads: int = 0) -> list[np.ndarray]:
    """Read many .pcd files, parsing all ASCII bodies concurrently through
    the native thread pool; the same per-file results as :func:`read_pcd`."""
    headers = [_read_header(p) for p in paths]
    out: list[np.ndarray | None] = [None] * len(paths)
    ascii_ids = [i for i, (h, _) in enumerate(headers) if h["DATA"][0].lower() == "ascii"]
    specs = [(paths[i], headers[i][1], _ascii_count(headers[i][0])) for i in ascii_ids]
    for i, arr in zip(ascii_ids, native.parse_floats_f32_batch(specs, n_threads=n_threads)):
        out[i] = _checked_ascii(paths[i], arr, headers[i][0])
    for i, (header, body_offset) in enumerate(headers):
        if out[i] is not None:
            continue
        kind = header["DATA"][0].lower()
        if kind != "binary":
            raise ValueError(f"{paths[i]}: unsupported PCD DATA kind {kind!r}")
        out[i] = _read_binary(paths[i], header, body_offset)
    return out


def read_pcd_point_count(path: str) -> int:
    """Read only the POINTS field from a .pcd header (no body parse), so a
    sweep can fix one capacity before building any device arrays."""
    with open(path, "rb") as f:
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: EOF before POINTS/DATA line (truncated or not a .pcd)")
            line = raw.decode("ascii", errors="replace").strip()
            if not line:
                continue
            key, _, rest = line.partition(" ")
            if key.upper() == "POINTS":
                return int(rest.split()[0])
            if key.upper() == "DATA":
                raise ValueError(f"{path}: header has no POINTS field")


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write xyz points as a v0.7 .pcd (the round-trip partner of
    :func:`read_pcd`; ASCII values as ``%.7g``, as the JAX package writes
    them)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%.7g")
