"""Nearest-neighbour search.

PyTorch port of ``icp_variants_tpu.ops.knn``: the host-side Morton orders
(3-dim and the 6-dim colour order), the tile-bbox :class:`TargetIndex`, the
visited-list search that serves the exact arm's fallback (and the JAX
package's lb-sorted visit lists, :func:`_visit_lists`, which the ablation
tool and the profiler's work model read), the JAX
package's resident-table rule (:func:`resident_fits`), the per-query radius
search over kd blocks that serves tables past that rule, and the dense and
tile-pruned matchers behind ``knn.match`` / ``nn_search`` and
``nn_search_pruned``, and the exact k-NN of the PCA normals
(:func:`knn_k`, plain PyTorch on every device, as the JAX package's is
plain XLA). :func:`visited_search`, :func:`kd_radius_search`,
:func:`dense_nn_search` and :func:`pruned_nn_search` launch the
hand-written CUDA kernels ``csrc/visited_search.cu``,
``csrc/kd_radius_search.cu`` and ``csrc/dense_nn_search.cu`` on CUDA
tensors and run their plain PyTorch versions (:func:`visited_search_plain`,
:func:`kd_radius_search_plain`, :func:`nn_search_xla`,
:func:`pruned_nn_search_plain`) on CPU tensors.

The kd and visited-list searches score direct coordinate differences
``sum_j (t_j - q_j)^2``. The dense and pruned matchers keep the JAX
package's ``|q|^2 + |t|^2 - 2 q.t`` expansion, which cancels in f32 at 20 m
scene scale: their answers are exact to within that rounding.

Every tensor carries a leading pair axis B; the search functions also take
one unbatched pair and return unbatched results.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.runtime import spans

# Feature dim of the index tables (coordinates, then zeros).
FEATURE_PAD = 8
# Target tile of the fallback index (one CTA walks these tiles).
V2_TILE_T = 1024
V2_TILE_Q = 128
# The JAX package's default target tile of a TargetIndex, and the query
# tile of its pruned search's visit mask.
INDEX_TILE_T = 512
TILE_Q = 256
# Row fill of the tile-multiple padding of a target index.
_ROW_PAD = 1.0e6
# Largest kd block count per pair that kd_radius_search takes (at k = 0 its
# CUDA kernel holds a pair's boxes in shared memory).
KD_RADIUS_MAX_BLOCKS = 1024
# Largest top-k pick count of the kd kernels (ICP_MAX_K in csrc/common.cuh),
# and the blocks one k = 0 round of kd_radius_search looks at (RS_SPAN in
# csrc/kd_radius_search.cu): the entries a row may give in one round.
KD_MAX_K = 16
KD_RADIUS_SPAN = 32
# The visited search keeps one f32 bound per tile per warp in shared memory
# (VS_SMEM_MAX in csrc/visited_search.cu).
VISITED_MAX_TILES = 200 * 1024 // 4
# The dense and pruned searches' query band and target group (NN_BAND and
# NN_GROUP in csrc/dense_nn_search.cu): a CTA holds a band's rows, and the
# packed target tiles are padded to whole groups.
NN_BAND = 256
NN_GROUP = 32


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


def morton6_codes_np(points, colors, valid_mask=None):
    """Host-side Morton codes (numpy, uint64) over the 6-dim colour-ICP
    features [x, y, z, r/255, g/255, b/255] with one shared quantization
    scale across the six dims; invalid rows get the largest code. The same
    code as the JAX package's, so the colour order is bit for bit equal."""
    feats = np.concatenate([
        np.asarray(points, np.float64)[:, :3],
        np.asarray(colors, np.float64)[:, :3] / 255.0,
    ], axis=1)
    if valid_mask is None:
        valid_mask = np.abs(feats[:, :3]).max(axis=1) < 1.0e5
    valid_mask = np.asarray(valid_mask, bool)
    if not valid_mask.any():
        return np.zeros(len(feats), np.uint64)
    lo = feats[valid_mask].min(axis=0)
    rng = feats[valid_mask].max(axis=0) - lo
    scale = 1023.0 / max(float(rng.max()), 1e-12)
    q = np.clip((feats - lo) * scale, 0.0, 1023.0).astype(np.uint64)

    def spread6(x):
        out = np.zeros_like(x, np.uint64)
        for b in range(10):
            out |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(6 * b)
        return out

    code = np.zeros(feats.shape[0], np.uint64)
    for d in range(6):
        code |= spread6(q[:, d]) << np.uint64(d)
    code[~valid_mask] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return code


# The JAX package's resident-kernel budget: one pair's kd page table must
# fit 13 MiB of a TPU core's VMEM. There it decides which matcher, and so
# which answer, a configuration gets: the kd path for dense selections
# (pipeline/icp.py:_kd_selection_applies) and the approximate arm's block
# membership cache (run_icp_batch). The port keeps it as that result rule,
# so that every configuration gets the JAX package's answer; beyond that
# it picks the warm search's route as the JAX package picks its kernel
# (kdtree._resident_layout), with results equal on both routes.
RESIDENT_VMEM_BUDGET = 13 * 1024 * 1024


def resident_fits(nc: int, tile_t: int, d: int | None = None) -> bool:
    """Whether a page table of ``nc`` blocks x ``tile_t`` slots falls
    within the JAX package's resident rule; ``d <= 3`` counts its packed
    layout (two blocks per 8-row page), ``d`` omitted the one-block-per-page
    table."""
    n_pages = (nc + 1) // 2 if d is not None and d <= 3 else nc
    return n_pages * 8 * tile_t * 4 <= RESIDENT_VMEM_BUDGET


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


def build_target_index(targets: torch.Tensor, *, tile_t: int = INDEX_TILE_T) -> TargetIndex:
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


def box_lb(q: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor) -> torch.Tensor:
    """Squared distance lower bound from each query to each box:
    (B, N, D) x (B, M, D) -> (B, N, M), coordinate at a time."""
    lb = None
    for j in range(q.shape[-1]):
        qj = q[:, :, None, j]
        gap = torch.clamp_min(
            torch.maximum(bmin[:, None, :, j] - qj, qj - bmax[:, None, :, j]), 0.0)
        lb = gap * gap if lb is None else lb + gap * gap
    return lb


# Suffix-list fill past a tile's visit count: above any real squared bound,
# finite in f32.
_LB_PAD = 1.0e30
# Bins of the visit lists' counting sort, on the sqrt scale of lb / bound.
_VISIT_BINS = 8


def _visit_lists(qmin, qmax, bbox_min, bbox_max, bound_val):
    """Per query tile, the target tiles it visits, in the JAX package's
    ``_visit_lists`` order. ``qmin`` / ``qmax`` (nqt, F) are the query
    tiles' boxes, ``bbox_min`` / ``bbox_max`` (ntt, F) the target tiles';
    a tile is visited when its squared box gap (summed in column order)
    is <= ``bound_val``, a scalar or a per-query-tile (nqt,) tensor
    (negative = an empty list). Returns :func:`_visit_lists_from`'s four
    lists."""
    lb = None
    for j in range(qmin.shape[-1]):
        gap = torch.clamp_min(torch.maximum(qmin[:, None, j] - bbox_max[None, :, j],
                                            bbox_min[None, :, j] - qmax[:, None, j]), 0.0)
        lb = gap * gap if lb is None else lb + gap * gap
    bound = torch.as_tensor(bound_val, dtype=torch.float32, device=lb.device)
    bound = bound.expand(lb.shape[:1])[:, None]
    return _visit_lists_from(lb, lb <= bound, bound)


def _visit_lists_from(lb, visited, bound_val):
    """Visit lists from the (nqt, ntt) lower bounds ``lb``, membership
    ``visited`` and (nqt, 1) bounds: ``(vlist, suffix, counts, counts0)``.

    Each row of ``vlist`` (nqt, ntt) int32 lists the visited tile ids by
    the JAX package's 8-bin counting sort: bin ``min(floor(8 sqrt(lb /
    max(bound, 1e-30))), 7)``, then ascending tile id within a bin (the
    counting sort is stable, so a stable sort on (bin, id) gives the same
    list); positions past the count hold tile 0. ``suffix`` (nqt, ntt) is
    the suffix minimum of the listed lower bounds (:data:`_LB_PAD` past the
    count), ``counts`` the visit counts and ``counts0`` the visited tiles
    of bin 0."""
    nqt, ntt = visited.shape
    scale = torch.sqrt(torch.clamp_min(lb, 0.0) / torch.clamp_min(bound_val, 1e-30))
    # Clamped in f32 before the cast: JAX's conversion saturates, torch's wraps.
    binid = torch.clamp(scale * _VISIT_BINS, 0, _VISIT_BINS - 1).to(torch.int64)
    cols = torch.arange(ntt, device=lb.device)
    key = torch.where(visited, binid * ntt + cols, _VISIT_BINS * ntt + cols)
    order = torch.sort(key, dim=1, stable=True).indices
    counts = visited.sum(1).to(torch.int32)
    listed = cols[None, :] < counts[:, None]
    vlist = torch.where(listed, order, 0).to(torch.int32)
    lblist = torch.where(listed, torch.gather(lb, 1, order), _LB_PAD)
    suffix = torch.flip(torch.cummin(torch.flip(lblist, [1]), dim=1).values, [1])
    counts0 = (visited & (binid == 0)).sum(1).to(torch.int32)
    return vlist, suffix, counts, counts0


def visited_search_plain(
    queries: torch.Tensor, radius: torch.Tensor, index: TargetIndex, *, chunk: int = 8192,
    counters=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`visited_search`: a chunked direct-difference
    exact 1-NN over every tiled target row, strictly below each query's
    radius (negative = frozen: idx -1, d2 = radius). Ties go to the lowest
    tiled row. Only the live rows of each pair are computed. ``counters``
    (an int64 slot, or None) takes the number of live rows."""
    if counters is not None:
        counters[0] += (radius >= 0).sum()
    d = queries.shape[-1]
    best = radius.clone()
    idx = torch.full(radius.shape, -1, dtype=torch.int32, device=radius.device)
    for b in range(queries.shape[0]):
        rows = torch.nonzero(radius[b] >= 0).flatten()
        if rows.numel() == 0:
            continue
        pts = index.points[b, :, :d]
        q = queries[b, rows]
        rb = radius[b, rows]
        ib = torch.full(rb.shape, -1, dtype=torch.int64, device=radius.device)
        for c0 in range(0, pts.shape[0], chunk):
            t = pts[c0:c0 + chunk]
            d2 = None
            for j in range(d):
                diff = t[None, :, j] - q[:, j, None]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            m, a = torch.min(d2, dim=-1)
            better = m < rb
            rb = torch.where(better, m, rb)
            ib = torch.where(better, a + c0, ib)
        best[b, rows] = rb
        idx[b, rows] = ib.to(torch.int32)
    return best, idx


def visited_search(
    queries: torch.Tensor, radius: torch.Tensor, index: TargetIndex
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN with per-query radii over a batched :class:`TargetIndex`.

    ``queries`` (B, N, d) f32, ``radius`` (B, N) f32 (negative = frozen).
    Returns ``(d2, idx)``, (B, N) each: idx is the tiled position (map
    through ``index.perm``), -1 where nothing beats the radius, and d2 is
    then the radius. A CUDA tensor launches ``csrc/visited_search.cu``
    (d = 3 or 6); a CPU tensor runs :func:`visited_search_plain`.

    The kernel lists each pair's live rows in a scratch workspace the
    wrapper allocates from the shapes, and walks each live query's tiles
    in ascending order of its box bound to them, stopping once the next
    bound exceeds its running best.

    While :mod:`~icp_variants_tpu_torch.runtime.spans` records, the launch
    adds its live rows to the recording's ``fallback_rows`` counter."""
    counters = spans.counters("visited_search", queries.device)
    if queries.device.type == "cpu":
        return visited_search_plain(queries, radius, index, counters=counters)
    b, n = queries.shape[0], queries.shape[1]
    d = _cuda.feature_dim("visited_search", queries.shape[-1])
    n_tiles, tile_t = index.points_t3.shape[-3], index.points_t3.shape[-1]
    chk = _cuda.check_cuda_tensor
    chk("queries", queries, torch.float32, (b, n, d))
    chk("radius", radius, torch.float32, (b, n))
    chk("points_t3", index.points_t3, torch.float32, (b, n_tiles, FEATURE_PAD, tile_t))
    chk("bbox_min", index.bbox_min, torch.float32, (b, n_tiles, FEATURE_PAD))
    chk("bbox_max", index.bbox_max, torch.float32, (b, n_tiles, FEATURE_PAD))
    d2 = torch.empty((b, n), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=queries.device)
    ws_bytes = _visited_search_workspace_bytes(b, n, n_tiles, tile_t)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=queries.device)
    if counters is not None:
        chk("counters", counters, torch.int64, (None,))
    _cuda.launch(
        "visited_search", queries, radius, index.points_t3, index.bbox_min,
        index.bbox_max, d2, idx, ws, ws_bytes, b, n, n_tiles, tile_t, counters, d,
    )
    return d2, idx


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _visited_search_workspace_bytes(b: int, n: int, n_tiles: int, tile_t: int) -> int:
    """Scratch bytes of one visited_search launch (the kernel's
    ``workspace_bytes``: per-pair live counts, 16-byte aligned, then the
    per-pair lists of live rows). Raises on a tiling the kernel does not
    take: tile_t not a multiple of 4, a tiled index past an int32, or more
    tiles than one warp's bounds can hold in shared memory."""
    if tile_t < 4 or tile_t % 4 or n_tiles < 1:
        raise ValueError(f"visited_search: tile_t must be a positive multiple of 4, got {tile_t}")
    if n_tiles * tile_t >= 2**31 or n_tiles > VISITED_MAX_TILES:
        raise ValueError(f"visited_search: {n_tiles} tiles of {tile_t} rows: at most "
                         f"{VISITED_MAX_TILES} tiles and 2**31 rows")
    return _align16(4 * b) + 4 * b * n


def kd_radius_search_plain(q, binit, bmin, bmax, pages, sel=None):
    """Plain version of :func:`kd_radius_search`: each row's member blocks
    in ascending id order (padded with -1), gathered, and the first
    minimum of the flattened (block, slot) distances, which is the lowest
    page index among ties."""
    b, n, d = q.shape
    nc, cap_pad = pages.shape[1], pages.shape[-1]
    if sel is None:
        member = box_lb(q, bmin, bmax) <= binit[..., None]
        ids = torch.where(member, torch.arange(nc, device=q.device), nc)
        m = max(int(member.sum(-1).max()), 1) if n else 1
    else:
        ids = torch.where(sel >= 0, sel.clamp(max=nc - 1), nc)
        m = sel.shape[-1]
    ids = torch.sort(ids, dim=-1).values[..., :m]
    ids = torch.where(ids < nc, ids, -1).to(torch.int32)
    bidx = torch.arange(b, device=q.device)[:, None, None]
    cand = pages[bidx, ids.clamp(min=0).long(), :d]            # (B, N, m, D, cap_pad)
    d2 = None
    for j in range(d):
        diff = cand[..., j, :] - q[:, :, None, j, None]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    d2 = torch.where((ids >= 0)[..., None], d2, torch.inf)
    best, a = torch.min(d2.reshape(b, n, m * cap_pad), dim=-1)
    better = best < binit
    blk = torch.gather(ids, -1, (a // cap_pad)[..., None])[..., 0]
    idx = torch.where(better, blk * cap_pad + (a % cap_pad).to(torch.int32), -1)
    return torch.where(better, best, binit), idx.to(torch.int32)


def kd_radius_search(
    q: torch.Tensor,
    binit: torch.Tensor,
    bmin: torch.Tensor,
    bmax: torch.Tensor,
    pages: torch.Tensor,
    sel: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each query strictly below its own radius among the
    points of its member kd blocks, at any page-table size.

    ``q`` (B, N, D), ``binit`` (B, N) radii (negative = frozen), ``bmin`` /
    ``bmax`` (B, nc, D) block boxes, ``pages`` (B, nc, 8, cap_pad). The
    members of a row are its picks in ``sel`` (B, N, k) int32 when given
    (``box_topk``'s, -1 = none), else every block whose :func:`box_lb` is
    <= the row's radius. Ties go to the lowest pair-local page index
    ``block * cap_pad + slot``. Returns ``(d2, idx)``, (B, N) each; idx -1
    where nothing beats the radius (or the row is frozen), and d2 is then
    the radius. A CUDA tensor launches ``csrc/kd_radius_search.cu`` (D = 3
    or 6, nc <= :data:`KD_RADIUS_MAX_BLOCKS`); a CPU tensor runs
    :func:`kd_radius_search_plain`.

    The kernel walks the (row, member block) entries block-major in rounds
    (each row's first pick, then its other picks within its running best;
    at k = 0 the member of least bound, then the rest in spans of
    :data:`KD_RADIUS_SPAN` blocks) in a scratch workspace the wrapper
    allocates from the shapes."""
    if q.device.type == "cpu":
        return kd_radius_search_plain(q, binit, bmin, bmax, pages, sel)
    return _kd_radius_search_launch(q, binit, bmin, bmax, pages, sel)


def _kd_radius_search_launch(q, binit, bmin, bmax, pages, sel, defines=()):
    """Check the CUDA operands and launch ``csrc/kd_radius_search.cu`` (with
    ``defines=("RS_PROBE",)`` its staging-only measurement build, uncounted:
    every row returns (radius, -1))."""
    b, n = q.shape[0], q.shape[1]
    d = _cuda.feature_dim("kd_radius_search", q.shape[-1])
    nc, cap_pad = pages.shape[1], pages.shape[-1]
    k = 0 if sel is None else sel.shape[-1]
    ws_bytes = _radius_search_workspace_bytes(b, n, nc, cap_pad, k)
    chk = _cuda.check_cuda_tensor
    chk("q", q, torch.float32, (b, n, d))
    chk("binit", binit, torch.float32, (b, n))
    chk("bmin", bmin, torch.float32, (b, nc, d))
    chk("bmax", bmax, torch.float32, (b, nc, d))
    chk("pages", pages, torch.float32, (b, nc, FEATURE_PAD, cap_pad))
    if sel is not None:
        chk("sel", sel, torch.int32, (b, n, k))
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    _cuda.launch("kd_radius_search", q, binit, bmin, bmax, pages, sel, d2, idx, ws, ws_bytes,
                 b, n, nc, cap_pad, k, d, defines=defines)
    return d2, idx


def _radius_search_workspace_bytes(b: int, n: int, nc: int, cap_pad: int, k: int) -> int:
    """Scratch bytes of one kd_radius_search launch (the kernel's
    ``workspace_layout``: row keys, bucket counts, bucket and chunk offsets,
    k = 0's round-0 blocks, and per (row, round slot) the block, its rank
    and the bucketed row, each 16-byte aligned; a row gives at most k
    entries a round, :data:`KD_RADIUS_SPAN` at k = 0). Raises on what the
    kernel does not take: k outside [0, 16], nc outside [1,
    :data:`KD_RADIUS_MAX_BLOCKS`], cap_pad not a positive multiple of 4, a
    page index past an int32, or entries past an int32."""
    if not 0 <= k <= KD_MAX_K:
        raise ValueError(f"kd_radius_search: k must be in [0, {KD_MAX_K}], got {k}")
    if not 1 <= nc <= KD_RADIUS_MAX_BLOCKS:
        raise ValueError(f"kd_radius_search: at most {KD_RADIUS_MAX_BLOCKS} blocks, got {nc}")
    if cap_pad < 4 or cap_pad % 4:
        raise ValueError(f"kd_radius_search: cap_pad must be a positive multiple of 4, "
                         f"got {cap_pad}")
    slots = k if k > 0 else KD_RADIUS_SPAN
    if nc * cap_pad >= 2**31 or b * n * slots >= 2**31:
        raise ValueError(f"kd_radius_search: {nc} x {cap_pad} pages and {b} x {n} x {slots} "
                         "entries must each stay below 2**31")
    rows, nb = b * n, b * nc
    sizes = (8 * rows, 4 * nb, 4 * (nb + 1), 4 * (nb + 1), 4 * rows,
             4 * rows * slots, 4 * rows * slots, 4 * rows * slots)
    return sum(_align16(x) for x in sizes)


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


# ---------------------------------------------------------------------------
# Dense and tile-pruned exact 1-NN by the |q|^2 + |t|^2 - 2 q.t expansion
# ---------------------------------------------------------------------------
#
# The JAX package's dense matcher (nn_search_xla / nn_search_pallas behind
# knn.match) and its tile-pruned matcher (nn_search_pruned) score with the
# expansion. Here the product q.t is summed feature by feature and every
# product and sum is rounded on its own, in the plain versions and in the
# CUDA kernels alike, so the two agree bit for bit. No matrix product: a
# lower-precision product flips near-tie winners.


def norm2(x: torch.Tensor) -> torch.Tensor:
    """``sum_j x_j^2`` over the trailing feature dim, summed in column
    order: the ``|q|^2`` and ``|t|^2`` of the expansion."""
    acc = x[..., 0] * x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j] * x[..., j]
    return acc


def expanded_d2(q, qn2, t, tn2) -> torch.Tensor:
    """(B, W, M) squared distances ``(|q|^2 + |t|^2) - 2 g`` of queries
    ``q`` (B, W, D) to targets ``t`` (B, M, >= D), with ``g = ((q_0 t_0 +
    q_1 t_1) + q_2 t_2) ...`` over the D features of ``q``."""
    g = q[:, :, None, 0] * t[:, None, :, 0]
    for j in range(1, q.shape[-1]):
        g += q[:, :, None, j] * t[:, None, :, j]
    d2 = qn2[:, :, None] + tn2[:, None, :]
    return d2.sub_(g.mul_(2.0))


def nn_search_xla(
    queries: torch.Tensor, targets: torch.Tensor, *, chunk: int = 1024
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`dense_nn_search` (the JAX package's
    ``nn_search_xla``): exact 1-NN of each query over every target row by
    :func:`expanded_d2`, ``chunk`` query rows at a time; ties go to the
    lowest target row. ``queries`` (B, N, D) and ``targets`` (B, M, D), or
    one unbatched pair. Returns ``(idx, d2)``."""
    batched, (q, t) = _batch_args(queries, targets)
    q, t = q.float(), t.float()
    qn2, tn2 = norm2(q), norm2(t)
    idx, d2 = [], []
    for s in range(0, max(q.shape[1], 1), chunk):
        m, a = torch.min(expanded_d2(q[:, s:s + chunk], qn2[:, s:s + chunk], t, tn2), dim=-1)
        idx.append(a.to(torch.int32))
        d2.append(m)
    idx, d2 = torch.cat(idx, dim=1), torch.cat(d2, dim=1)
    return (idx, d2) if batched else (idx[0], d2[0])


def k_smallest(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``d2`` (..., M), ascending,
    the lower column first on a tie: k rounds of argmin, each masking its
    winner (``torch.topk`` promises no tie order). Returns ``(cols (..., k)
    int64, values (..., k))``; ``d2`` is overwritten."""
    cols, vals = [], []
    for _ in range(k):
        v, a = torch.min(d2, dim=-1, keepdim=True)
        cols.append(a)
        vals.append(v)
        d2.scatter_(-1, a, float("inf"))
    return torch.cat(cols, dim=-1), torch.cat(vals, dim=-1)


def knn_k(
    queries: torch.Tensor, targets: torch.Tensor, k: int, *, chunk: int = 1024
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN (small k) by :func:`expanded_d2` over every target row,
    ``chunk`` query rows at a time (the JAX package's ``knn_k``, a load-time
    op of the PCA normals): ``(idx (..., N, k) int32, d2 (..., N, k))``,
    ascending, the lower target row first on a tie. ``queries`` (B, N, D)
    and ``targets`` (B, M, D), or one unbatched pair."""
    batched, (q, t) = _batch_args(queries, targets)
    q, t = q.float(), t.float()
    qn2, tn2 = norm2(q), norm2(t)
    idx, d2 = [], []
    for s in range(0, max(q.shape[1], 1), chunk):
        c, v = k_smallest(expanded_d2(q[:, s:s + chunk], qn2[:, s:s + chunk], t, tn2), k)
        idx.append(c.to(torch.int32))
        d2.append(v)
    idx, d2 = torch.cat(idx, dim=1), torch.cat(d2, dim=1)
    return (idx, d2) if batched else (idx[0], d2[0])


def dense_nn_search(
    queries: torch.Tensor, targets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each query over every target row, by the expansion
    (the JAX package's ``nn_search_pallas``): ``(idx, d2)``, ties to the
    lowest target row. ``queries`` (B, N, D), ``targets`` (B, M, D), or one
    unbatched pair. A CUDA tensor launches ``csrc/dense_nn_search.cu`` (D =
    3 or 6: the targets packed into a workspace, then one CTA per band of
    :data:`NN_BAND` query rows walking every target); a CPU tensor runs
    :func:`nn_search_xla`."""
    if queries.device.type == "cpu":
        return nn_search_xla(queries, targets)
    batched, (q, t) = _batch_args(queries, targets)
    idx, d2 = _dense_nn_search_launch(q, t)
    return (idx, d2) if batched else (idx[0], d2[0])


def _dense_nn_search_launch(q, t, defines: tuple[str, ...] = ()):
    """One launch of ``csrc/dense_nn_search.cu``'s dense entry on batched
    CUDA tensors (with ``defines``, that measurement build, uncounted)."""
    d = _cuda.feature_dim("dense_nn_search", q.shape[-1])
    q, t = q.float().contiguous(), t.float().contiguous()
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    chk = _cuda.check_cuda_tensor
    chk("queries", q, torch.float32, (b, n, d))
    chk("targets", t, torch.float32, (b, m, d))
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws_bytes = _dense_search_workspace_bytes(b, m, d)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    _cuda.launch("dense_nn_search", q, t, d2, idx, ws, ws_bytes, b, n, m, d, defines=defines)
    return idx, d2


def _record_bytes(d: int) -> int:
    """Bytes of one packed target record [t_0 .. t_{d-1}, |t|^2]: whole
    16-byte words."""
    return 16 * ((d + 4) // 4)


def _dense_search_workspace_bytes(b: int, m: int, d: int) -> int:
    """Scratch bytes of one dense_nn_search launch (the kernel's
    ``nn_workspace``): each pair's m targets packed as records, padded to
    whole groups of :data:`NN_GROUP`."""
    return b * (-(-m // NN_GROUP) * NN_GROUP) * _record_bytes(d)


# The JAX package's nn_search dispatches on its backend; here the tensors'
# device decides (a CUDA tensor launches the kernel).
nn_search = dense_nn_search


def match(
    queries: torch.Tensor,
    targets: torch.Tensor,
    max_distance: float,
    query_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full matching stage: dense exact 1-NN + squared-distance threshold
    (NearestNeighbor.h:182). Returns ``(indices, dist2, valid)``."""
    idx, d2 = nn_search(queries, targets)
    valid = d2 <= max_distance
    if query_mask is not None:
        valid = valid & query_mask
    return idx, d2, valid


def pruned_visit_mask(
    queries: torch.Tensor, index: TargetIndex, bound_val: float, tile_q: int = TILE_Q
) -> torch.Tensor:
    """(B, ceil(N / tile_q), n_tiles) bool: whether the bbox of each
    ``tile_q``-row query tile (zero-padded rows included, over
    FEATURE_PAD columns) lies within ``bound_val`` of each target tile's
    bbox, the squared gaps summed in column order (the JAX package's
    ``nn_search_pruned`` visit mask)."""
    q = _pad_rows(_pad_features(queries.float()), tile_q, 0.0)
    tiles = q.reshape(q.shape[0], -1, tile_q, FEATURE_PAD)
    qmin, qmax = torch.amin(tiles, dim=-2), torch.amax(tiles, dim=-2)
    lb = None
    for j in range(FEATURE_PAD):
        gap = torch.clamp_min(torch.maximum(
            qmin[:, :, None, j] - index.bbox_max[:, None, :, j],
            index.bbox_min[:, None, :, j] - qmax[:, :, None, j]), 0.0)
        lb = gap * gap if lb is None else lb + gap * gap
    return lb <= bound_val


def pruned_nn_search_plain(
    q, t, visit, bound_val: float, *, tile_q: int, tile_t: int, chunk: int = 1024
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`pruned_nn_search`: :func:`expanded_d2` over
    every target row, rows of tiles the visit mask skips set to +inf, then
    the first minimum, kept only if strictly below ``bound_val``."""
    b, n, d = q.shape
    m = t.shape[1]
    t = t[..., :d]
    qn2, tn2 = norm2(q), norm2(t)
    col_tile = torch.arange(m, device=q.device) // tile_t
    best, idx = [], []
    for s in range(0, max(n, 1), chunk):
        e = min(s + chunk, n)
        d2 = expanded_d2(q[:, s:e], qn2[:, s:e], t, tn2)
        row_tile = torch.arange(s, e, device=q.device) // tile_q
        vis = visit[:, row_tile][:, :, col_tile]
        mn, a = torch.min(d2.masked_fill_(~vis, torch.inf), dim=-1)
        better = mn < bound_val
        best.append(torch.where(better, mn, bound_val))
        idx.append(torch.where(better, a.to(torch.int32), -1))
    return torch.cat(idx, dim=1), torch.cat(best, dim=1)


def pruned_nn_search(
    q: torch.Tensor,
    t: torch.Tensor,
    visit: torch.Tensor,
    bound_val: float,
    *,
    tile_q: int,
    tile_t: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN strictly below ``bound_val`` over the target tiles that
    ``visit`` (B, ceil(N / tile_q), ceil(M / tile_t)) lets each query tile
    see, by the expansion. ``q`` (B, N, D); ``t`` (B, M, >= D), whose first
    D columns are the features. Returns ``(idx, d2)``, (B, N) each: idx -1
    (d2 = the bound) where nothing beats the bound; ties go to the lowest
    target row. A CUDA tensor launches ``csrc/dense_nn_search.cu`` (D = 3
    or 6, any tiles: the visited (query band, target tile) items listed on
    the card, walked by CTAs that fill it, each row's best merged with a
    64-bit atomicMin; the workspace from
    :func:`_pruned_search_workspace_bytes`); a CPU tensor runs
    :func:`pruned_nn_search_plain`."""
    if q.device.type == "cpu":
        return pruned_nn_search_plain(q, t, visit, bound_val, tile_q=tile_q, tile_t=tile_t)
    return _pruned_nn_search_launch(q, t, visit, bound_val, tile_q, tile_t)


def _pruned_nn_search_launch(q, t, visit, bound_val, tile_q, tile_t,
                             defines: tuple[str, ...] = ()):
    """One launch of ``csrc/dense_nn_search.cu``'s pruned entry on CUDA
    tensors (with ``defines``, that measurement build, uncounted)."""
    b, n = q.shape[0], q.shape[1]
    d = _cuda.feature_dim("pruned_nn_search", q.shape[-1])
    m, ts = t.shape[1], t.shape[-1]
    if ts < d:
        raise ValueError(f"pruned_nn_search: targets have {ts} columns, queries {d}")
    ws_bytes = _pruned_search_workspace_bytes(b, n, m, d, tile_q, tile_t)
    nqt, n_tiles = -(-n // tile_q), -(-m // tile_t)
    chk = _cuda.check_cuda_tensor
    chk("q", q, torch.float32, (b, n, d))
    chk("t", t, torch.float32, (b, m, ts))
    chk("visit", visit, torch.bool, (b, nqt, n_tiles))
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    _cuda.launch("pruned_nn_search", q, t, visit, bound_val, d2, idx, ws, ws_bytes, b, n, m, ts,
                 tile_q, tile_t, d, defines=defines)
    return idx, d2


def _pruned_search_workspace_bytes(b: int, n: int, m: int, d: int, tile_q: int,
                                   tile_t: int) -> int:
    """Scratch bytes of one pruned_nn_search launch (the kernel's
    ``nn_workspace``, each piece 16-byte aligned): the target tiles packed
    as records, each padded to whole groups of :data:`NN_GROUP`; a 64-bit
    merge key per row; the item count; and room for every (pair, query
    tile, band of :data:`NN_BAND` rows in the tile, target tile) item.
    Raises on a tiling the kernel does not take: a tile below one row, a
    packed row or an item id past an int32."""
    if tile_q < 1 or tile_t < 1:
        raise ValueError(f"pruned_nn_search: tiles must hold a row, got tile_q {tile_q}, "
                         f"tile_t {tile_t}")
    n_tiles, tile_pad = -(-m // tile_t), -(-tile_t // NN_GROUP) * NN_GROUP
    n_items = b * -(-n // tile_q) * -(-tile_q // NN_BAND) * n_tiles
    if n_tiles * tile_pad >= 2**31 or n_items >= 2**31:
        raise ValueError(f"pruned_nn_search: {n_tiles} tiles of {tile_pad} packed rows and "
                         f"{n_items} items: each must stay below 2**31")
    return (_align16(b * n_tiles * tile_pad * _record_bytes(d)) + _align16(8 * b * n)
            + _align16(4) + _align16(4 * n_items))


def nn_search_pruned(
    queries: torch.Tensor,
    index: TargetIndex,
    max_distance: float,
    *,
    tile_q: int = TILE_Q,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threshold-bounded exact 1-NN against a :class:`TargetIndex` (the
    JAX package's ``nn_search_pruned``): ``(idx, d2)`` in ORIGINAL target
    numbering, idx -1 and d2 = :func:`bound_value` where nothing lies
    strictly below that bound among the target tiles whose bbox lies
    within it of the query tile's (:func:`pruned_visit_mask`). The target
    tile is the index's."""
    batched, (q, index) = _batch_args(queries, index)
    q = q.float().contiguous()
    bv = bound_value(max_distance)
    tile_t = index.points_t3.shape[-1]
    visit = pruned_visit_mask(q, index, bv, tile_q)
    sidx, d2 = pruned_nn_search(q, index.points, visit, bv, tile_q=tile_q, tile_t=tile_t)
    orig = take_rows(index.perm, sidx.clamp(min=0))
    idx = torch.where(sidx < 0, -1, orig)
    return (idx, d2) if batched else (idx[0], d2[0])


def nn_search_pruned_xla(
    queries: torch.Tensor, index: TargetIndex, max_distance: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Portable equivalent of :func:`nn_search_pruned` (no pruning, the
    same result contract; the JAX package's ``nn_search_pruned_xla``): the
    dense plain search over the index's rows, rows past ``max_distance``
    returned as -1 at :func:`bound_value`."""
    batched, (q, index) = _batch_args(queries, index)
    idx, d2 = nn_search_xla(q, index.points[..., :q.shape[-1]])
    over = d2 > max_distance
    orig = take_rows(index.perm, idx)
    idx = torch.where(over, -1, orig)
    d2 = torch.where(over, bound_value(max_distance), d2)
    return (idx, d2) if batched else (idx[0], d2[0])
