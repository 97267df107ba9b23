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
launches per kernel name.
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

# Coordinates per point the kernels take (``D`` in ``csrc/common.cuh``).
KERNEL_DIM = 3

# kernel name -> (source file, C function, ctypes argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "box_topk": ("box_topk.cu", "box_topk_launch", [_P] * 6 + [_I] * 4 + [_P]),
    "kd_block_search": (
        "kd_block_search.cu", "kd_block_search_launch", [_P] * 6 + [_I] * 5 + [_P]),
    "visited_search": (
        "visited_search.cu", "visited_search_launch", [_P] * 7 + [_I] * 4 + [_P]),
}

LAUNCHES: collections.Counter = collections.Counter()
BUILD_LOG: dict[str, str] = {}   # kernel name -> nvcc/ptxas output

_libs: dict[str, ctypes.CDLL] = {}
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


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Build every kernel library that is missing (in parallel) and load
    them all; returns the seconds spent. Raises on any build failure."""
    with _lock:
        if len(_libs) == len(KERNELS):
            return 0.0
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name, (src_name, _, _) in KERNELS.items():
            src = CSRC / src_name
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            jobs[name] = (out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (out, tmp, proc) in jobs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name, (src_name, fn_name, argtypes) in KERNELS.items():
            lib = ctypes.CDLL(str(_lib_path(CSRC / src_name)))
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.icp_cuda_error_string.argtypes = [ctypes.c_int]
            lib.icp_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return time.perf_counter() - t0


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream of its tensors' device.
    ``args`` are tensors (passed by data pointer) and Python ints, in the
    order of the C function; the stream is appended here."""
    build_all()
    lib = _libs[name]
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, KERNELS[name][1])(*c_args, stream)
    if err != 0:
        msg = lib.icp_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


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
