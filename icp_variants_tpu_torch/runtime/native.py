"""ctypes bridge to the native IO library (``native/icpio.cpp``).

Port of ``icp_variants_tpu.runtime.native`` with the same C signatures.
The library is required: its threaded f32 scanner parses the ASCII .pcd
bodies, and its widest-axis median partition is the kd build's route at
D = 3 (the partition's order is semantic: it decides each block's page
order, and with it how exact ties break). So a failed build raises with
the compiler's message; nothing falls back to numpy.

The unchanged ``native/icpio.cpp`` is compiled with ``native/Makefile``'s
flags into ``build/icp_variants_tpu_torch/libicpio.so`` at the first call,
under a file lock, to a temporary name that is then renamed into place, so
concurrent processes never load a half-written library. Nothing is
written into ``native/``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "icpio.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "icp_variants_tpu_torch"
LIB_PATH = BUILD_DIR / "libicpio.so"
# native/Makefile's CXXFLAGS.
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_ARGTYPES = {
    "icpio_parse_floats": [ctypes.c_char_p, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_double), ctypes.c_int64],
    "icpio_parse_floats_f32": [ctypes.c_char_p, ctypes.c_int64, _F32P, ctypes.c_int64],
    "icpio_kd_partition": [_F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           _I64P, _I64P, _I64P, ctypes.c_int64],
    "icpio_parse_files_f32": [ctypes.POINTER(ctypes.c_char_p), _I64P,
                              ctypes.POINTER(_F32P), _I64P, _I64P,
                              ctypes.c_int64, ctypes.c_int64],
}


def _build() -> None:
    """Compile ``SOURCE`` into ``LIB_PATH`` unless it is there and newer,
    holding an exclusive lock on a file beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libicpio.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
            return
        tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise RuntimeError(f"cannot build {LIB_PATH}: {' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {LIB_PATH} failed (rc {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded (building it if needed;
    a failed build raises)."""
    return load() is not None


def parse_floats(path: str, offset: int, max_count: int, dtype=np.float64) -> np.ndarray:
    """Parse whitespace-separated numbers from ``path`` starting at byte
    ``offset`` (at most ``max_count``; ``strtof`` for float32, ``strtod``
    otherwise)."""
    lib = load()
    if dtype == np.float32:
        out = np.empty(max_count, np.float32)
        n = lib.icpio_parse_floats_f32(path.encode(), offset, out.ctypes.data_as(_F32P),
                                       max_count)
    else:
        out = np.empty(max_count, np.float64)
        n = lib.icpio_parse_floats(path.encode(), offset,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_count)
    if n < 0:
        raise IOError(f"icpio failed to read {path}")
    return out[:n]


def parse_floats_f32_batch(specs: list[tuple[str, int, int]], n_threads: int = 0
                           ) -> list[np.ndarray]:
    """Parse many files concurrently through the native thread pool.
    ``specs`` is ``[(path, byte_offset, max_count), ...]``; returns one f32
    array per file and raises on any file's I/O error, like
    :func:`parse_floats`."""
    lib = load()
    n = len(specs)
    if n == 0:
        return []
    outs = [np.empty(mc, np.float32) for (_, _, mc) in specs]
    paths = (ctypes.c_char_p * n)(*[p.encode() for (p, _, _) in specs])
    offsets = (ctypes.c_int64 * n)(*[o for (_, o, _) in specs])
    max_counts = (ctypes.c_int64 * n)(*[mc for (_, _, mc) in specs])
    counts = (ctypes.c_int64 * n)()
    ptrs = (_F32P * n)(*[a.ctypes.data_as(_F32P) for a in outs])
    lib.icpio_parse_files_f32(paths, offsets, ptrs, max_counts, counts, n, n_threads)
    results = []
    for i, a in enumerate(outs):
        if counts[i] < 0:
            raise IOError(f"icpio failed to read {specs[i][0]}")
        results.append(a[: counts[i]])
    return results


def kd_partition(points: np.ndarray, depth: int):
    """Native widest-axis median partition (``ops/kdtree.kd_partition_np``
    semantics, splitting on the first 3 columns only): returns ``(perm,
    blocks)`` with ``blocks`` a list of (start, count) in tree order.
    Subtrees split in parallel on all host cores; the result does not
    depend on the thread count."""
    lib = load()
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = len(pts)
    perm = np.arange(n, dtype=np.int64)
    n_blocks = 1 << depth
    starts = np.zeros(n_blocks, np.int64)
    counts = np.zeros(n_blocks, np.int64)
    lib.icpio_kd_partition(pts.ctypes.data_as(_F32P), n, pts.strides[0] // 4, depth,
                           perm.ctypes.data_as(_I64P), starts.ctypes.data_as(_I64P),
                           counts.ctypes.data_as(_I64P), 0)
    return perm, list(zip(starts.tolist(), counts.tolist()))
