"""Nearest-neighbour search over a tiled target index.

PyTorch port of the parts of ``icp_variants_tpu.ops.knn`` that the kd
matcher needs: the host-side Morton order, the tile-bbox
:class:`TargetIndex`, and the visited-list search that serves the exact
arm's fallback. :func:`visited_search` launches the hand-written CUDA
kernel ``csrc/visited_search.cu`` on CUDA tensors and runs its plain
PyTorch version, :func:`visited_search_plain`, on CPU tensors.

Distances are direct coordinate differences ``sum_j (t_j - q_j)^2``
everywhere, never the ``|q|^2 + |t|^2 - 2 q.t`` expansion, which cancels
catastrophically in f32 at 20 m scene scale and flips near-tie winners.

Every tensor carries a leading pair axis B; the search functions also take
one unbatched pair and return unbatched results.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.ops import _cuda

# Feature dim of the index tables (coordinates, then zeros).
FEATURE_PAD = 8
# Target tile of the fallback index (one CTA walks these tiles).
V2_TILE_T = 1024
V2_TILE_Q = 128
# Row fill of the tile-multiple padding of a target index.
_ROW_PAD = 1.0e6


def _pad_features(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the trailing feature dim to FEATURE_PAD columns."""
    d = x.shape[-1]
    if d == FEATURE_PAD:
        return x
    return torch.nn.functional.pad(x, (0, FEATURE_PAD - d))


def _pad_rows(x: torch.Tensor, multiple: int, fill: float) -> torch.Tensor:
    """Pad axis -2 up to a multiple of ``multiple`` with ``fill``."""
    n = x.shape[-2]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, target - n), value=fill)


def color_features(points: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """6-dim [x, y, z, r/255, g/255, b/255] rows of the color-ICP matcher
    (NearestNeighbor.h:212-224)."""
    return torch.cat([points, colors[..., :3] * (1.0 / 255.0)], dim=-1)


def morton_codes_np(points, valid_mask=None):
    """Host-side Morton codes (numpy) for load-time cloud ordering; the
    same code as the JAX package's, so the order is bit for bit equal."""
    xyz = np.asarray(points)[:, :3]
    if valid_mask is None:
        valid_mask = np.abs(xyz).max(axis=1) < 1.0e5
    if not valid_mask.any():
        return np.zeros(len(xyz), np.int64)
    lo = xyz[valid_mask].min(axis=0)
    hi = xyz[valid_mask].max(axis=0)
    scale = 1023.0 / np.maximum(hi - lo, 1e-12)
    q = np.clip((xyz - lo) * scale, 0.0, 1023.0).astype(np.uint32)

    def part(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = part(q[:, 0]) | (part(q[:, 1]) << 1) | (part(q[:, 2]) << 2)
    code = code.astype(np.int64)
    return np.where(valid_mask, code, np.int64(1) << 40)


class TargetIndex(NamedTuple):
    """Tile-bbox search structure over a target cloud (the ``buildIndex``
    phase, NearestNeighbor.h:122-141); the JAX package's fields but its
    ``norm2`` (and the ``0.5*|t|^2`` feature row of its pages), which only
    its expanded-distance kernels read, with an optional leading pair
    axis."""

    points: torch.Tensor     # (..., Nt_pad, 8) feature-padded rows
    points_t3: torch.Tensor  # (..., n_tiles, 8, tile_t) feature-major pages
    perm: torch.Tensor       # (..., Nt_pad) int32 tiled position -> original row
    bbox_min: torch.Tensor   # (..., n_tiles, 8)
    bbox_max: torch.Tensor   # (..., n_tiles, 8)


def build_target_index(targets: torch.Tensor, *, tile_t: int = V2_TILE_T) -> TargetIndex:
    """Tile-bbox index over ``targets`` (..., N, d) on their device. No
    sort: pruning quality comes from the load-time Morton order."""
    t = _pad_rows(_pad_features(targets.float()), tile_t, _ROW_PAD)
    lead = t.shape[:-2]
    n_tiles = t.shape[-2] // tile_t
    tiles = t.reshape(*lead, n_tiles, tile_t, FEATURE_PAD)
    perm = torch.arange(t.shape[-2], dtype=torch.int32, device=t.device)
    return TargetIndex(
        points=t,
        points_t3=tiles.transpose(-1, -2).contiguous(),
        perm=perm.expand(*lead, -1).contiguous(),
        bbox_min=torch.amin(tiles, dim=-2),
        bbox_max=torch.amax(tiles, dim=-2),
    )


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-pair row gather: ``table`` (B, M, ...) at ``idx`` (B, ...) ->
    (B, ..., trailing dims of table). ``idx`` must be in range."""
    b = table.shape[0]
    flat = idx.reshape(b, -1).long()
    if table.dim() == 2:
        return torch.gather(table, 1, flat).reshape(idx.shape)
    tail = table.shape[2:]
    g = flat.reshape(b, -1, *([1] * len(tail))).expand(b, flat.shape[1], *tail)
    return torch.gather(table, 1, g).reshape(*idx.shape, *tail)


def visited_search_plain(
    queries: torch.Tensor, radius: torch.Tensor, index: TargetIndex, *, chunk: int = 8192
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`visited_search`: a chunked direct-difference
    exact 1-NN over every tiled target row, strictly below each query's
    radius (negative = frozen: idx -1, d2 = radius). Ties go to the lowest
    tiled row."""
    d = queries.shape[-1]
    pts = index.points[..., :d]
    best = radius.clone()
    idx = torch.full(radius.shape, -1, dtype=torch.int64, device=radius.device)
    for c0 in range(0, pts.shape[-2], chunk):
        t = pts[:, c0:c0 + chunk]
        d2 = None
        for j in range(d):
            diff = t[:, None, :, j] - queries[:, :, None, j]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        m, a = torch.min(d2, dim=-1)
        better = m < best
        best = torch.where(better, m, best)
        idx = torch.where(better, a + c0, idx)
    return best, idx.to(torch.int32)


def visited_search(
    queries: torch.Tensor, radius: torch.Tensor, index: TargetIndex
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN with per-query radii over a batched :class:`TargetIndex`.

    ``queries`` (B, N, d) f32, ``radius`` (B, N) f32 (negative = frozen).
    Returns ``(d2, idx)``, (B, N) each: idx is the tiled position (map
    through ``index.perm``), -1 where nothing beats the radius, and d2 is
    then the radius. A CUDA tensor launches ``csrc/visited_search.cu``
    (d = 3 only); a CPU tensor runs :func:`visited_search_plain`."""
    if queries.device.type == "cpu":
        return visited_search_plain(queries, radius, index)
    b, n, d = queries.shape[0], queries.shape[1], _cuda.KERNEL_DIM
    n_tiles, tile_t = index.points_t3.shape[-3], index.points_t3.shape[-1]
    chk = _cuda.check_cuda_tensor
    chk("queries", queries, torch.float32, (b, n, d))
    chk("radius", radius, torch.float32, (b, n))
    chk("points_t3", index.points_t3, torch.float32, (b, n_tiles, FEATURE_PAD, tile_t))
    chk("bbox_min", index.bbox_min, torch.float32, (b, n_tiles, FEATURE_PAD))
    chk("bbox_max", index.bbox_max, torch.float32, (b, n_tiles, FEATURE_PAD))
    d2 = torch.empty((b, n), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=queries.device)
    _cuda.launch(
        "visited_search", queries, radius, index.points_t3, index.bbox_min,
        index.bbox_max, d2, idx, b, n, n_tiles, tile_t,
    )
    return d2, idx


def bound_value(max_distance: float) -> float:
    """The f32 miss bound ``max_distance * (1 + 1e-6) + 1e-30`` every
    matcher starts from (the JAX package's ``bound_val``)."""
    return float(
        np.float32(max_distance) * np.float32(1.0 + 1e-6) + np.float32(1e-30)
    )


def _batch_args(queries, *rest):
    """Add a pair axis to an unbatched call; returns (batched, args...)."""
    if queries.dim() == 3:
        return True, (queries, *rest)

    def up(x):
        if x is None:
            return None
        if isinstance(x, tuple):  # an index NamedTuple
            return type(x)(*(None if f is None else f.unsqueeze(0) for f in x))
        return x.unsqueeze(0)

    return False, tuple(up(x) for x in (queries, *rest))


def nn_search_pruned_v2(
    queries: torch.Tensor,
    index: TargetIndex,
    max_distance: float,
    *,
    per_query_bound: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Visited-list exact 1-NN in ORIGINAL target numbering:
    ``(idx, d2)``, idx -1 where nothing beats the bound (d2 = the bound).
    ``per_query_bound`` gives per-query radii (negative = frozen), else
    every query searches within :func:`bound_value`."""
    batched, (q, index, radius) = _batch_args(queries, index, per_query_bound)
    if radius is None:
        radius = torch.full(q.shape[:2], bound_value(max_distance),
                            dtype=torch.float32, device=q.device)
    d2, sidx = visited_search(q.float().contiguous(), radius.float().contiguous(), index)
    orig = take_rows(index.perm, sidx.clamp(min=0))
    idx = torch.where(sidx < 0, -1, orig)
    return (idx, d2) if batched else (idx[0], d2[0])


def match_indexed(
    queries: torch.Tensor,
    index: TargetIndex,
    max_distance: float,
    query_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matching stage against a :class:`TargetIndex`: exact 1-NN + squared
    threshold (NearestNeighbor.h:182). Returns ``(indices, dist2, valid)``."""
    idx, d2 = nn_search_pruned_v2(queries, index, max_distance)
    valid = (d2 <= max_distance) & (idx >= 0)
    if query_mask is not None:
        valid = valid & query_mask
    return idx, d2, valid
