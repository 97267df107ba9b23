"""Selection stage (stage 1): which source rows query the matcher.

PyTorch port of ``icp_variants_tpu.ops.selection``. Draws come from an
explicit ``torch.Generator`` on the tensors' device, so the batched driver
never leaves the device. The JAX threefry stream cannot be reproduced:
parity tests feed both packages the same selections instead
(``pipeline.icp.run_icp_batch(selected=...)``).
"""

from __future__ import annotations

import numpy as np
import torch


def select_all(base_mask: torch.Tensor) -> torch.Tensor:
    """SELECT_ALL: the base validity mask unchanged (selection.h:30-34)."""
    return base_mask


def random_sampling(
    generator: torch.Generator, base_mask: torch.Tensor, proba: float
) -> torch.Tensor:
    """RANDOM_SAMPLING: keep each valid point independently with
    probability ``proba`` (selection.h:88-106)."""
    u = torch.rand(base_mask.shape, generator=generator, device=base_mask.device)
    return base_mask & (u < proba)


def bernoulli_gap_indices(
    generator: torch.Generator,
    proba: float,
    stride: int,
    capacity: int,
    k_cap: int,
    index_offset: int = 0,
    *,
    batch: tuple[int, ...] = (),
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions of a Bernoulli(``proba``) process over the stride lattice,
    drawn as geometric inter-arrival gaps: slot i holds the row of the
    i-th success, the exact distribution of per-point Bernoulli +
    compaction (selection.h:88-106) at O(k) cost. Rows come out ascending.
    Successes past the ``k_cap``-th are dropped. Returns ``(rows,
    in_range)``, each ``batch + (k_cap,)``; out-of-range slots hold
    ``capacity - 1``."""
    device = generator.device if device is None else device
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.rand(*batch, k_cap, generator=generator, device=device).clamp_min(tiny)
    g = torch.floor(torch.log(u) / np.log1p(-proba)).to(torch.int64)
    lattice = torch.cumsum(g + 1, dim=-1) - 1
    lattice = torch.clamp(lattice, max=(capacity + stride - 1) // stride)
    rows = lattice * stride + ((-index_offset) % stride)
    in_range = rows < capacity
    return torch.clamp(rows, max=capacity - 1).to(torch.int32), in_range


def random_indices(
    generator: torch.Generator,
    n: int,
    count: int,
    capacity: int,
    *,
    batch: tuple[int, ...] = (),
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RANDOM_FAST: jittered stratified draw — slot k samples uniformly
    inside stratum [k*n/count, (k+1)*n/count); ascending, fixed count."""
    device = generator.device if device is None else device
    # int64 stratum bounds, made on the device (no host copy in the loop).
    slots = torch.arange(capacity, dtype=torch.int64, device=device)
    starts = (slots * n) // count
    width = torch.clamp_min(((slots + 1) * n) // count - starts, 1)
    u = torch.rand(*batch, capacity, generator=generator, device=device)
    idx = torch.clamp(starts + (u * width).to(torch.int64), max=n - 1)
    mask = torch.arange(capacity, device=device) < count
    return idx.to(torch.int32), mask.expand(*batch, capacity)
