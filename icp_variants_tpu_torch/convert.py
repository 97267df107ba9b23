"""Carry host-built state of the JAX package into the port's containers.

The JAX package's ``Cloud``, ``KDIndex`` and ``TargetIndex`` are
NamedTuples of arrays that numpy can read (``np.asarray``), stacked along a
leading pair axis or not. These helpers copy each field onto ``device`` as
a tensor in the port's container of the same name, so both packages search
the very same index: geometric or colour clouds, 3-dim or 6-dim kd indexes
alike. A ``match_blocks`` array of the JAX package's ``ICPResult`` becomes
a membership seed. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_variants_tpu_torch.core.cloud import Cloud
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops.kdtree import KDIndex
from icp_variants_tpu_torch.ops.knn import TargetIndex


def _tensor(x, dev):
    if x is None:
        return None
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def _convert(cls, obj, device):
    dev = resolve_device(device)
    return cls(*(_tensor(getattr(obj, f, None), dev) for f in cls._fields))


def cloud_from_arrays(cloud, device=None) -> Cloud:
    """A ``Cloud`` of the JAX package (or any object with its fields)."""
    return _convert(Cloud, cloud, device)


def kd_index_from_arrays(index, device=None) -> KDIndex:
    """A ``kdtree.KDIndex`` of the JAX package (``pages_packed`` may be None)."""
    return _convert(KDIndex, index, device)


def target_index_from_arrays(index, device=None) -> TargetIndex:
    """A ``knn.TargetIndex`` of the JAX package."""
    return _convert(TargetIndex, index, device)


def match_blocks_from_array(blocks, device=None) -> torch.Tensor:
    """An ``ICPResult.match_blocks`` array of the JAX package as an int32
    tensor, ready for ``run_icp_batch(membership_seed=...)``."""
    return _tensor(np.asarray(blocks, np.int32), resolve_device(device))
