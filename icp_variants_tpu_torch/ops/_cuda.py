"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``icp_variants_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``. Nothing is built at import: the first CUDA launch builds
every kernel (one ``nvcc`` per source, all started together) into
``build/icp_variants_tpu_torch/`` at the repository root, named by a hash
of the source and flags so a changed source rebuilds.

Every C entry point takes device pointers, sizes and the CUDA stream, and
returns the ``cudaError_t`` of ``cudaGetLastError()`` after its launch;
:func:`launch` raises on anything but 0. :data:`LAUNCHES` counts the
launches per kernel name. :func:`variant` builds a source again with extra
preprocessor defines (a measurement build, loaded beside the production
one); its launches are not counted.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "icp_variants_tpu_torch"

# -fmad=false: no a*b+c contraction, so the kernels round every product
# and sum like the plain PyTorch versions (lower bounds and distances then
# agree bit for bit and a top-k pick cannot flip on a near-tie). The
# sources also spell the arithmetic with __fmul_rn / __fadd_rn.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Features per point the kd kernels are built for (``D`` of the templates
# in ``csrc/``): 3 for geometry, 6 for the colour-ICP features.
KERNEL_DIMS = (3, 6)

# kernel name -> (source file, C function, ctypes argtypes); every C
# function ends with (..., void* stream), and all but
# projective_window_search (geometry only), normal_equations and pose_step
# (the solvers' f32 sums and 6 x 6 systems) with (..., int D, void* stream).
# kd_block_search and visited_search take, just before D, the work counters
# they add to (null: none; runtime/spans.py).
# dense_nn_search and pruned_nn_search are two entries of one source;
# visited_ablate is the measurement kernel of scripts/knn_ablate.py;
# normal_equations (solvers/linear.py) is the linear solvers' reduction, on
# f32 rows whatever D, and pose_step their 6 x 6 solve and increment.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "box_topk": ("box_topk.cu", "box_topk_launch", [_P] * 6 + [_I] * 5 + [_P]),
    "kd_block_search": (
        "kd_block_search.cu", "kd_block_search_launch",
        [_P] * 7 + [ctypes.c_longlong] + [_I] * 6 + [_P, _I, _P]),
    "visited_search": (
        "visited_search.cu", "visited_search_launch",
        [_P] * 8 + [ctypes.c_longlong] + [_I] * 4 + [_P, _I, _P]),
    "cached_block_search": (
        "cached_block_search.cu", "cached_block_search_launch",
        [_P, _P, _P, _F] + [_P] * 4 + [ctypes.c_longlong] + [_I] * 5 + [_P]),
    "kd_radius_search": (
        "kd_radius_search.cu", "kd_radius_search_launch",
        [_P] * 9 + [ctypes.c_longlong] + [_I] * 6 + [_P]),
    "projective_window_search": (
        "projective_window_search.cu", "projective_window_search_launch",
        [_P] * 6 + [_I] * 6 + [_P]),
    "dense_nn_search": (
        "dense_nn_search.cu", "dense_nn_search_launch",
        [_P] * 5 + [ctypes.c_longlong] + [_I] * 4 + [_P]),
    "pruned_nn_search": (
        "dense_nn_search.cu", "pruned_nn_search_launch",
        [_P] * 3 + [_F] + [_P] * 3 + [ctypes.c_longlong] + [_I] * 7 + [_P]),
    "visited_ablate": (
        "visited_ablate.cu", "visited_ablate_launch",
        [_P] * 6 + [_F] + [_P] * 2 + [_I] * 6 + [_P]),
    "normal_equations": (
        "normal_equations.cu", "normal_equations_launch",
        [_P] * 4 + [ctypes.c_longlong] * 8 + [_P] * 8 + [_I] * 3 + [_F] * 2 + [_I, _P]),
    "pose_step": (
        "pose_step.cu", "pose_step_launch", [_P] * 6 + [_I, ctypes.c_double, _I, _P]),
}

LAUNCHES: collections.Counter = collections.Counter()
BUILD_LOG: dict[str, str] = {}   # source file -> nvcc/ptxas output

_libs: dict[str, ctypes.CDLL] = {}
_variants: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS + [f"-D{d}" for d in defines]).encode())
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"{src.stem}{tag}-{h.hexdigest()[:16]}.so"


def _start_nvcc(src: Path, out: Path, defines: tuple[str, ...] = ()):
    """Start one nvcc of ``src`` into a temporary file beside ``out``;
    returns ``(tmp, process)``."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC), "-o", str(tmp),
           str(src)]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(path: Path, src_name: str) -> ctypes.CDLL:
    """Load a built library and type the C entries of ``src_name``."""
    lib = ctypes.CDLL(str(path))
    for name, (src, fn_name, argtypes) in KERNELS.items():
        if src == src_name:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.icp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.icp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_all(variants: tuple[tuple[str, tuple[str, ...]], ...] = ()) -> float:
    """Build every kernel library that is missing, and the :func:`variant`
    builds ``(source file, defines)`` in ``variants`` (one nvcc per
    library, all in parallel), and load them all; returns the seconds
    spent. Raises on any build failure."""
    with _lock:
        todo = [(src, ()) for src in sorted({src for src, _, _ in KERNELS.values()})
                if len(_libs) < len(KERNELS)]
        todo += [(src, tuple(d)) for src, d in variants if (src, tuple(d)) not in _variants]
        if not todo:
            return 0.0
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for src_name, defines in todo:
            out = _lib_path(CSRC / src_name, defines)
            if not out.exists():
                jobs[(src_name, defines)] = (out, *_start_nvcc(CSRC / src_name, out, defines))
        failed = []
        for (src_name, defines), (out, tmp, proc) in jobs.items():
            log, _ = proc.communicate()
            BUILD_LOG[" ".join((src_name, *defines))] = log
            if proc.returncode != 0:
                failed.append(f"{src_name} {defines} (nvcc rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        loaded = {}
        for name, (src_name, _, _) in KERNELS.items():
            if src_name not in loaded:
                loaded[src_name] = _load(_lib_path(CSRC / src_name), src_name)
            _libs[name] = loaded[src_name]
        for src_name, defines in todo:
            if defines:
                _variants[(src_name, defines)] = _load(_lib_path(CSRC / src_name, defines),
                                                       src_name)
        return time.perf_counter() - t0


def variant(src_name: str, defines: tuple[str, ...]) -> ctypes.CDLL:
    """The library of ``csrc/<src_name>`` built with ``-D`` ``defines``
    (built at the first call, beside the production build; its log under
    ``BUILD_LOG[src_name + " " + defines]``)."""
    key = (src_name, tuple(defines))
    with _lock:
        if key not in _variants:
            src = CSRC / src_name
            out = _lib_path(src, key[1])
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp, proc = _start_nvcc(src, out, key[1])
                log, _ = proc.communicate()
                BUILD_LOG[f"{src_name} {' '.join(key[1])}"] = log
                if proc.returncode != 0:
                    raise RuntimeError(f"CUDA kernel build failed: {src_name} with "
                                       f"{key[1]} (nvcc rc {proc.returncode}):\n{log}")
                os.replace(tmp, out)
            _variants[key] = _load(out, src_name)
        return _variants[key]


def library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (its :func:`variant` build with
    ``defines``), for its C entries other than the launch."""
    if defines:
        return variant(KERNELS[name][0], defines)
    build_all()
    return _libs[name]


def launch(name: str, *args, defines: tuple[str, ...] = ()) -> None:
    """Launch kernel ``name`` on the current stream of its tensors' device.
    ``args`` are tensors (passed by data pointer), Python ints and floats,
    in the order of the C function; the stream is appended here. With
    ``defines``, the :func:`variant` build of its source runs, uncounted."""
    lib = library(name, defines)
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, KERNELS[name][1])(*c_args, stream)
    if err != 0:
        msg = lib.icp_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    if not defines:
        LAUNCHES[name] += 1


def feature_dim(name: str, d: int) -> int:
    """Raise unless the kernels are built for ``d`` features per point."""
    if d not in KERNEL_DIMS:
        raise ValueError(f"{name}: the kernels take D in {KERNEL_DIMS}, got {d}")
    return d


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (None entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
