"""Multi-process bring-up: ``torch.distributed`` initialization, the
(``pairs``, ``points``) mesh and the shard-safe sum.

Port of ``icp_variants_tpu.parallel.distributed``. Each process (rank)
drives one device. The ``pairs`` axis of the mesh spreads registration
problems over ranks with no collective at all; the ``points`` axis splits
each pair's source rows, and the solvers' and measures' reductions cross it
as one ``all_reduce`` (:func:`psum`) each. ``group=None`` everywhere means
one device: no collective, the single-device arithmetic unchanged.

Launch recipe (one process per rank)
------------------------------------
Under a launcher that sets ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` (such
as ``torchrun``), no arguments are needed::

    torchrun --nproc-per-node 2 my_driver.py

    # in my_driver.py:
    from icp_variants_tpu_torch.parallel import distributed
    distributed.initialize()          # False (single process) without a launcher
    mesh = distributed.global_mesh(points_per_pair=1)

Without one, pass the rendezvous explicitly, for example a file every rank
can reach::

    distributed.initialize("file:///tmp/rdzv", world_size=2, rank=RANK)

The backend defaults to ``nccl`` on the card and ``gloo`` on the CPU. NCCL
refuses a communicator whose ranks share one device, so ranks that share a
card pass ``backend="gloo"``: gloo reduces CUDA tensors through the host,
and each rank's tensors, kernels and solves stay on the card.
``icp_variants_tpu_torch/scripts/multihost_rehearsal.py`` is a runnable
per-rank worker.
"""

from __future__ import annotations

import collections
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pairs", "points")
# A collective that waits longer than this raises instead of hanging.
TIMEOUT = datetime.timedelta(seconds=120)
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
# Collectives issued by :func:`psum` in this process: ``calls`` and
# ``bytes`` (of one rank's operand); the per-rank workers read them around
# a run.
COLLECTIVES: collections.Counter = collections.Counter()


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``jax.lax.psum``): a new
    tensor, the same on every rank; ``x`` itself when ``group`` is None.
    Integer tensors sum as integers; a bool tensor is summed as int32 (gloo
    reduces no bool)."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    out = torch.clone(x, memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += out.numel() * out.element_size()
    return out


def psum_many(xs, group) -> list[torch.Tensor]:
    """:func:`psum` of several tensors of one dtype in one collective (each
    element sums on its own, so the result equals one :func:`psum` each)."""
    if group is None:
        return list(xs)
    flat = psum(torch.cat([x.reshape(-1) for x in xs]), group)
    return [part.reshape(x.shape) for part, x in
            zip(torch.split(flat, [x.numel() for x in xs]), xs)]


def shard_seed(seed: int, index: int) -> int:
    """The generator seed of shard ``index`` of a run seeded ``seed``: the
    seed itself for shard 0 (so one shard draws as the unsharded run),
    a hash of both for the others, so shards draw independent streams (the
    JAX package's ``fold_in(key, shard)``)."""
    if index == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None, device=None) -> bool:
    """Bring up the process group. Returns True in distributed mode, False
    for a single process.

    With no ``init_method`` it initializes from a launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) where one is set, and
    otherwise keeps single-process mode, so one driver runs alone or under
    a launcher. ``backend`` defaults to ``nccl`` when ``device`` (``None`` =
    the card) is CUDA and to ``gloo`` on the CPU."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not all(os.environ.get(k) for k in _LAUNCHER_ENV):
            return False
        init_method = "env://"
    if backend is None:
        backend = "nccl" if _device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, timeout=TIMEOUT)
    return True


def _device(device) -> torch.device:
    # Imported here: the core modules import this one (their psums).
    from icp_variants_tpu_torch.core.device import resolve_device

    return resolve_device(device)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the rank that writes summaries and artifacts."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given (``"cuda"`` without an
    index and ``None`` mean ``cuda:{local rank % device count}``, the local
    rank from ``LOCAL_RANK``, else the global rank)."""
    dev = _device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """A (``pairs``, ``points``) mesh over the ranks, seen from this rank:
    ``shape`` and this rank's ``coords`` per axis, the process ``groups``
    along each axis (None without a process group) and this rank's
    ``device``. ``device_mesh`` is the ``torch.distributed.DeviceMesh``
    the groups come from."""

    def __init__(self, shape: dict, coords: dict, groups: dict, device: torch.device,
                 device_mesh=None):
        self.shape, self.coords, self.groups = shape, coords, groups
        self.device, self.device_mesh = device, device_mesh

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, coords={self.coords}, device={self.device})"


def global_mesh(points_per_pair: int = 1, device=None) -> Mesh:
    """A (``pairs``, ``points``) mesh over all ranks: ``points_per_pair``
    consecutive ranks cooperate on each registration problem (their source
    rows split between them); the rest of the world is the ``pairs`` axis.
    Without a process group, a 1 x 1 mesh over this process, whose groups
    are None. ``device`` is this rank's (:func:`rank_device`)."""
    dev = rank_device(device)
    n = process_count()
    if n % points_per_pair != 0:
        raise ValueError(f"{n} ranks do not divide into points_per_pair={points_per_pair}")
    shape = {"pairs": n // points_per_pair, "points": points_per_pair}
    if not dist.is_initialized():
        return Mesh(shape, {"pairs": 0, "points": 0}, {"pairs": None, "points": None}, dev)
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        # Before the mesh: it would otherwise pick a device by its own rule.
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, (shape["pairs"], shape["points"]), mesh_dim_names=AXES)
    return Mesh(shape, {a: dm.get_local_rank(a) for a in AXES},
                {a: dm.get_group(a) for a in AXES}, dev, device_mesh=dm)
