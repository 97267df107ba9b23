"""Per-query 1-NN over a balanced k-d partition, exact within the threshold.

PyTorch port of ``icp_variants_tpu.ops.kdtree`` on the ETH main path:

* The target cloud is partitioned once per pair on the host by recursive
  widest-axis median splits (:func:`build_kd_index`): equal-count blocks
  with disjoint boxes.
* Per iteration each query ranks the block boxes by squared lower bound
  and keeps its top k (:func:`box_topk`, kernel ``csrc/box_topk.cu``),
  then takes exact direct-difference distances over the points of its own
  k blocks (:func:`kd_block_search`, kernel ``csrc/kd_block_search.cu``).
* The approximate arm's seeded mode searches exactly one cached block per
  query instead (:func:`nn_search_kd_cached`, kernel
  ``csrc/cached_block_search.cu``): the membership cache of the dense
  segmented multires driver.
* With ``pose=`` the seeded search takes raw source features and moves
  them itself (the JAX package's in-kernel transform).
* Certificate: the (k+1)-th smallest bound is the smallest bound of any
  unexamined block. A query whose best distance does not beat it re-searches
  through the fallback (``knn.visited_search``, kernel
  ``csrc/visited_search.cu``). The JAX package hid that fallback behind a
  batch-global ``lax.cond``; here it launches every iteration, and rows
  whose certificate closed are frozen (radius -1) and exit at once — no
  host sync decides anything.
* Warm start (:func:`match_kd_warm`): each query searches within the exact
  distance to its previous match. Within the JAX package's resident rule
  that is box_topk + kd_block_search from the per-query radius; past it
  (and for radius-complete membership, k = 0) the radius search
  ``knn.kd_radius_search`` (kernel ``csrc/kd_radius_search.cu``), as the
  JAX package picks its bitmap kernel there (:func:`_resident_layout`).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version (``*_plain``, same module) for CPU tensors only.
Every tensor carries a leading pair axis B; the search functions also take
one unbatched pair.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import _cuda, knn
from icp_variants_tpu_torch.runtime import native, spans

# Sentinel for padded block slots: finite in f32, never the argmin.
LEAF_PAD = 1.0e9
# Default top-k block count of the exact arm.
K_DEFAULT = 4
# The JAX package's query tile of its kd prefix and search kernels, and the
# query tiles per prefix step (its rows are padded to the product). The port
# reads them only to model that work (pipeline/profiling.py).
TILE_Q_DEFAULT = 128
_PREFIX_GROUP = 8
# Points per block at full occupancy (the JAX package's defaults, so both
# packages partition a cloud into the same blocks).
BLOCK_TARGET = 3072
BLOCK_TARGET_COLOR_APPROX = 1536


def default_block_target(color: bool, approx: bool) -> int:
    """Block size for a matching configuration (narrower for the
    approximate 6-dim color matcher)."""
    return BLOCK_TARGET_COLOR_APPROX if (color and approx) else BLOCK_TARGET


class KDIndex(NamedTuple):
    """Balanced k-d partition of a target cloud (fields as in the JAX
    package, with an optional leading pair axis)."""

    block_pts: torch.Tensor    # (..., C, D*cap) coordinate-major rows, LEAF_PAD padding
    block_orig: torch.Tensor   # (..., C, cap) int32 original rows, -1 padding
    block_min: torch.Tensor    # (..., C, D) box mins (+inf for empty blocks)
    block_max: torch.Tensor    # (..., C, D) box maxs (-inf for empty blocks)
    pages: torch.Tensor        # (..., C, 8, cap_pad) feature-major pages
    page_orig: torch.Tensor    # (..., C*cap_pad) int32 original rows, -1 padding
    # Two blocks per 8-row page (d <= 3), the JAX index's packed table. Its
    # presence decides _resident_layout's packed fit (the JAX package's
    # rule); no kernel reads it: kd_block_search serves tables of that size
    # from the one-block pages.
    pages_packed: torch.Tensor | None = None


def kd_depth_for(capacity: int, block_target: int = BLOCK_TARGET) -> int:
    """Split depth so blocks hold ~block_target points at full occupancy."""
    depth = 1
    while (capacity >> depth) > block_target:
        depth += 1
    return depth


def kd_partition_np(points: np.ndarray, depth: int):
    """Host-side recursive widest-axis median partition. Returns
    ``(perm, blocks)``: ``points[perm]`` is block-grouped and ``blocks``
    lists each block's ``(start, count)`` in tree order (exact floor/ceil
    halves at every split)."""
    n = len(points)
    perm = np.arange(n)
    nodes = [(0, n)]
    for _ in range(depth):
        nxt = []
        for s, c in nodes:
            h = c // 2
            if c > 1:
                seg = perm[s:s + c]
                p = points[seg]
                ax = int(np.argmax(p.max(0) - p.min(0)))
                seg = seg[np.argpartition(p[:, ax], h)]
                perm[s:s + c] = seg
            nxt.append((s, h))
            nxt.append((s + h, c - h))
        nodes = nxt
    return perm, nodes


def build_kd_index(
    points,
    valid=None,
    *,
    block_target: int = BLOCK_TARGET,
    capacity: int | None = None,
    device=None,
) -> KDIndex:
    """Build the k-d search index of one target cloud on the host (the
    native partition at D = 3, numpy at D = 6, as the JAX package builds
    it) and place it on ``device`` (``None`` = the card). ``points`` is the
    (capacity, D) padded cloud array; ``valid`` masks its real rows
    (default: finite-coordinate rows). Shapes depend on ``capacity`` only."""
    dev = resolve_device(device)
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    if isinstance(valid, torch.Tensor):
        valid = valid.detach().cpu().numpy()
    points = np.asarray(points, np.float32)
    if capacity is None:
        capacity = len(points)
    if valid is None:
        valid = np.abs(points[:, :3]).max(axis=1) < 1.0e5
    rows = np.flatnonzero(np.asarray(valid, bool))
    depth = kd_depth_for(capacity, block_target)
    n_blocks = 1 << depth
    cap = -(-capacity // n_blocks)
    d = points.shape[1]

    # The JAX package's route: the native partition at D = 3 (multi-core),
    # numpy at D = 6 (6-dim features split on their widest axis there).
    if d == 3:
        perm, blocks = native.kd_partition(points[rows], depth)
    else:
        perm, blocks = kd_partition_np(points[rows], depth)
    pts = np.full((n_blocks, cap, d), LEAF_PAD, np.float32)
    block_orig = np.full((n_blocks, cap), -1, np.int32)
    block_min = np.full((n_blocks, d), np.inf, np.float32)
    block_max = np.full((n_blocks, d), -np.inf, np.float32)
    for i, (s, c) in enumerate(blocks):
        if c == 0:
            continue
        sel = rows[perm[s:s + c]]
        pts[i, :c] = points[sel]
        block_orig[i, :c] = sel
        block_min[i] = pts[i, :c].min(0)
        block_max[i] = pts[i, :c].max(0)
    block_pts = np.ascontiguousarray(pts.transpose(0, 2, 1).reshape(n_blocks, d * cap))
    cap_pad = ((cap + 127) // 128) * 128
    pages = np.zeros((n_blocks, 8, cap_pad), np.float32)
    pages[:, :d, :] = LEAF_PAD
    pages[:, :d, :cap] = pts.transpose(0, 2, 1)
    page_orig = np.full((n_blocks, cap_pad), -1, np.int32)
    page_orig[:, :cap] = block_orig
    pages_packed = None
    if d <= 3:
        n_pages = (n_blocks + 1) // 2
        pk = np.zeros((n_pages, 8, cap_pad), np.float32)
        pk[:, 0:3, :] = LEAF_PAD
        pk[:, 3:6, :] = LEAF_PAD
        coords = pts.transpose(0, 2, 1)
        pk[:, 0:d, :cap] = coords[0::2]
        pk[:n_blocks // 2, 3:3 + d, :cap] = coords[1::2]
        pages_packed = torch.from_numpy(pk).to(dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return KDIndex(
        block_pts=put(block_pts),
        block_orig=put(block_orig),
        block_min=put(block_min),
        block_max=put(block_max),
        pages=put(pages),
        page_orig=put(page_orig.reshape(-1)),
        pages_packed=pages_packed,
    )


def checks_to_k(checks: int, index: KDIndex) -> int:
    """FLANN-style ``checks`` budget (candidate points per query) -> top-k
    block count: enough whole blocks to cover it, at least 1, at most all."""
    nc, cap = index.block_orig.shape[-2:]
    return max(1, min(-(-int(checks) // cap), nc))


def stack_kd_indexes(indexes) -> KDIndex:
    """Stack equal-shape KDIndexes along a new leading pair axis."""
    return KDIndex(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*indexes)
    ))


def _resident_layout(index: KDIndex) -> tuple[bool, bool]:
    """The JAX package's resident rule for this index: ``(packed, fits)``.
    The one-block-per-page table fits when :func:`knn.resident_fits` says
    so; else a 3-dim index with its packed table fits in the packed layout.
    Read at call time (``knn.RESIDENT_VMEM_BUDGET``). The JAX package runs
    its resident kernel when ``fits`` and its bitmap kernel past the rule;
    the warm search takes the matching route (:func:`_warm_search`)."""
    nc, tile_t = index.pages.shape[-3], index.pages.shape[-1]
    if knn.resident_fits(nc, tile_t):
        return False, True
    if index.pages_packed is not None and knn.resident_fits(
            nc, tile_t, d=index.block_min.shape[-1]):
        return True, True
    return False, False


# ---------------------------------------------------------------------------
# Kernel 1: box top-k
# ---------------------------------------------------------------------------


def _extract_min(w: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k argmin-extraction rounds over the last axis (lowest index on
    ties). Returns the picked ids (..., k) int32 and the residual minimum
    after extraction (...)."""
    picks = []
    for _ in range(k):
        a = torch.argmin(w, dim=-1)
        picks.append(a)
        w = w.scatter(-1, a[..., None], torch.inf)
    return torch.stack(picks, dim=-1).to(torch.int32), torch.amin(w, dim=-1)


def box_topk_plain(q, binit, bmin, bmax, k: int):
    """Plain version of :func:`box_topk`."""
    lb = knn.box_lb(q, bmin, bmax)
    sel, resid = _extract_min(lb, k)
    member = torch.gather(lb, -1, sel.long()) <= binit[..., None]
    return torch.where(member, sel, -1), resid


def box_topk(
    q: torch.Tensor, binit: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per query, the k blocks of smallest squared box lower bound.

    ``q`` (B, N, D), ``binit`` (B, N) per-query radii, ``bmin``/``bmax``
    (B, nc, D). Returns ``sel`` (B, N, k) int32 — the picks in extraction
    order, -1 where the pick's bound exceeds ``binit`` (no member) — and
    ``resid`` (B, N), the (k+1)-th smallest bound (the certificate). A CUDA
    tensor launches ``csrc/box_topk.cu`` (D = 3 or 6, from the boxes); a
    CPU tensor runs :func:`box_topk_plain`."""
    if q.device.type == "cpu":
        return box_topk_plain(q, binit, bmin, bmax, k)
    b, n = q.shape[0], q.shape[1]
    nc, d = bmin.shape[1], _cuda.feature_dim("box_topk", bmin.shape[-1])
    chk = _cuda.check_cuda_tensor
    chk("q", q, torch.float32, (b, n, d))
    chk("binit", binit, torch.float32, (b, n))
    chk("bmin", bmin, torch.float32, (b, nc, d))
    chk("bmax", bmax, torch.float32, (b, nc, d))
    sel = torch.empty((b, n, k), dtype=torch.int32, device=q.device)
    resid = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _cuda.launch("box_topk", q, binit, bmin, bmax, sel, resid, b, n, nc, k, d)
    return sel, resid


# ---------------------------------------------------------------------------
# Kernel 2: kd block search
# ---------------------------------------------------------------------------


def _block_search_workspace_bytes(b: int, n: int, nc: int, k: int) -> int:
    """Scratch bytes of one kd_block_search launch, or of one
    cached_block_search launch at k = 1 (``csrc/block_major.cuh``'s
    ``workspace_layout``: row keys, bucket counts and offsets, chunk
    offsets, entry ranks and the bucketed entries, each 16-byte aligned)."""
    rows, nb = b * n, b * nc
    sizes = (8 * rows, 4 * nb, 4 * (nb + 1), 4 * (nb + 1), 4 * rows * k, 4 * rows * k)
    return sum(-(-s // 16) * 16 for s in sizes)


# Entries of a (pair, block) bucket that one walk CTA stages, by D
# (KdbShape<D, false> in csrc/block_major.cuh).
KDB_CHUNK = {3: 64, 6: 512}


def kd_block_search_counts(sel: torch.Tensor, nc: int, d: int) -> torch.Tensor:
    """The work counts of one :func:`kd_block_search` launch, as its kernel
    adds them (``csrc/block_major.cuh``), int64 ``[rows with a pick,
    (query, block) entries, bucket chunks staged]``: ids < 0 are no pick,
    ids past nc - 1 are clipped, a block repeated in a row is one entry,
    and each (pair, block) bucket is staged in chunks of ``KDB_CHUNK[d]``
    entries."""
    c = torch.sort(torch.where(sel < 0, -1, sel.clamp(max=nc - 1)).long(), dim=-1).values
    keep = c >= 0
    keep[..., 1:] &= c[..., 1:] != c[..., :-1]
    pair = torch.arange(sel.shape[0], device=sel.device)[:, None, None]
    buckets = torch.bincount((pair * nc + c)[keep], minlength=sel.shape[0] * nc)
    chunk = KDB_CHUNK[d]
    return torch.stack([keep.any(-1).sum(), keep.sum(), ((buckets + chunk - 1) // chunk).sum()])


def kd_block_search_plain(q, sel, binit, pages, probe: int = 0, counters=None):
    """Plain version of :func:`kd_block_search`: gather each query's k
    blocks and take the first minimum in (sel position, slot) order; with
    ``probe`` >= 1, ``(binit, -1)``. ``counters`` (three int64 slots, or
    None) take :func:`kd_block_search_counts`."""
    if counters is not None:
        counters[:3] += kd_block_search_counts(sel, pages.shape[1], q.shape[-1])
    if probe:
        return binit.clone(), torch.full(binit.shape, -1, dtype=torch.int32, device=q.device)
    b, n, d = q.shape
    k = sel.shape[-1]
    cap_pad = pages.shape[-1]
    bidx = torch.arange(b, device=q.device)[:, None, None]
    cand = pages[bidx, sel.clamp(min=0).long(), :d]          # (B, N, k, D, cap_pad)
    d2 = None
    for j in range(d):
        diff = cand[..., j, :] - q[:, :, None, j, None]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    d2 = torch.where((sel >= 0)[..., None], d2, torch.inf)
    m, a = torch.min(d2.reshape(b, n, k * cap_pad), dim=-1)
    better = m < binit
    blk = torch.gather(sel, -1, (a // cap_pad)[..., None])[..., 0]
    idx = torch.where(better, blk * cap_pad + (a % cap_pad).to(torch.int32), -1)
    return torch.where(better, m, binit), idx.to(torch.int32)


def kd_block_search(
    q: torch.Tensor, sel: torch.Tensor, binit: torch.Tensor, pages: torch.Tensor,
    probe: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each query among the points of its own blocks.

    ``q`` (B, N, D), ``sel`` (B, N, k) int32 block ids (-1 = none),
    ``binit`` (B, N) starting bounds, ``pages`` (B, nc, 8, cap_pad). A point
    counts only if its squared distance is strictly below the running best
    (starting at ``binit``); ties go to the earliest sel position, then the
    lowest slot. Returns ``(d2, idx)``, (B, N) each: idx is the pair-local
    page index ``block * cap_pad + slot`` (-1 if nothing beat ``binit``,
    and d2 is then ``binit``). A CUDA tensor launches
    ``csrc/kd_block_search.cu`` (D = 3 or 6, from ``q``); a CPU tensor runs
    :func:`kd_block_search_plain`.

    The kernel is block-major: it buckets the (query, pick) entries by
    (pair, block) in a scratch workspace and stages each block once per
    chunk of its bucket (a launch shape fixed per D in the source).

    ``probe`` 1 or 2 (a measurement aid, the JAX package's resident-kernel
    probe): the entries are still bucketed and each chunk still stages its
    block, but no distance is computed, and every row returns
    ``(binit, -1)``, not a match. As in the
    JAX package, whose probe zeroes every gate's member count
    (``knn.py:1467``), both values do the same.

    While :mod:`~icp_variants_tpu_torch.runtime.spans` records, the launch
    adds its work to the recording's counters (``kd_rows``,
    ``kd_entries``, ``kd_chunks``; :func:`kd_block_search_counts`)."""
    if probe not in (0, 1, 2):
        raise ValueError(f"kd_block_search: probe must be 0, 1 or 2, got {probe}")
    counters = spans.counters("kd_block_search", q.device)
    if q.device.type == "cpu":
        return kd_block_search_plain(q, sel, binit, pages, probe, counters)
    return _kd_block_search_launch(q, sel, binit, pages, probe, counters=counters)


def _kd_block_search_launch(q, sel, binit, pages, probe, defines=(), counters=None):
    """Check the CUDA operands and launch ``csrc/kd_block_search.cu``
    (its :func:`_cuda.variant` build with ``defines``, uncounted);
    ``counters``: None, or three int64 slots on ``q``'s device the kernel
    adds its work to."""
    b, n = q.shape[0], q.shape[1]
    d = _cuda.feature_dim("kd_block_search", q.shape[-1])
    k = sel.shape[-1]
    nc, cap_pad = pages.shape[1], pages.shape[-1]
    chk = _cuda.check_cuda_tensor
    chk("q", q, torch.float32, (b, n, d))
    chk("sel", sel, torch.int32, (b, n, k))
    chk("binit", binit, torch.float32, (b, n))
    chk("pages", pages, torch.float32, (b, nc, 8, cap_pad))
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws_bytes = _block_search_workspace_bytes(b, n, nc, k)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    if counters is not None:
        chk("counters", counters, torch.int64, (None,))
    _cuda.launch("kd_block_search", q, sel, binit, pages, d2, idx, ws, ws_bytes, b, n, nc,
                 cap_pad, k, int(probe > 0), counters, d, defines=defines)
    return d2, idx


# ---------------------------------------------------------------------------
# Searches and the matching stage
# ---------------------------------------------------------------------------


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python scalar (no host-to-device copy)."""
    return float(np.float32(x))


def _certificate_fail(resid, d2, max_distance):
    """Certificate with one-ulp slack: unexamined boxes must be strictly
    farther than both the found minimum and the threshold."""
    return resid <= torch.clamp(d2, max=_f32(max_distance)) * (1.0 + 1e-6)


def _search(q, index, binit_value, k):
    """box_topk + kd_block_search at one starting bound for every query;
    returns (sorted page idx, d2, resid)."""
    d = index.block_min.shape[-1]
    q = q[..., :d].float().contiguous()
    binit = torch.full(q.shape[:2], binit_value, dtype=torch.float32, device=q.device)
    sel, resid = box_topk(q, binit, index.block_min, index.block_max, k)
    d2, sidx = kd_block_search(q, sel, binit, index.pages)
    return sidx, d2, resid


def to_orig(index: KDIndex, sidx: torch.Tensor) -> torch.Tensor:
    """Pair-local page index -> original target row (-1 passes through)."""
    orig = knn.take_rows(index.page_orig, sidx.clamp(min=0))
    return torch.where(sidx < 0, -1, orig)


def nn_search_kd(
    queries: torch.Tensor, index: KDIndex, max_distance: float, *, k: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-unless-flagged 1-NN with the JAX oracle's result rule:
    ``(orig_idx, dist2, fail)``. The search is unbounded over each query's
    top-k blocks; rows whose best exceeds ``max_distance`` report idx -1
    and dist2 = the miss bound. ``fail`` marks rows whose certificate did
    not close."""
    batched, (q, index) = knn._batch_args(queries, index)
    nc = index.pages.shape[-3]
    k = min(K_DEFAULT if k is None else k, nc)
    sidx, d2, resid = _search(q, index, float("inf"), k)
    fail = _certificate_fail(resid, d2, max_distance)
    over = d2 > _f32(max_distance)
    idx = torch.where(over, -1, to_orig(index, sidx))
    d2 = torch.where(over, knn.bound_value(max_distance), d2)
    return (idx, d2, fail) if batched else (idx[0], d2[0], fail[0])


def nn_search_kd_resident(
    queries: torch.Tensor,
    index: KDIndex,
    max_distance: float,
    *,
    k: int | None = None,
    orig_map: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The production cold kd search: ``(orig_idx, dist2, fail)`` with the
    search bounded by the miss bound from the start (the JAX resident
    kernel's rule): rows where nothing beats it report idx -1 and dist2 =
    the bound; a best in (max_distance, bound) keeps its row and is
    rejected by the caller's threshold. ``orig_map=False`` returns the
    pair-local page index (``block * cap_pad + slot``) instead of the
    original target row."""
    batched, (q, index) = knn._batch_args(queries, index)
    nc = index.pages.shape[-3]
    k = min(K_DEFAULT if k is None else k, nc)
    sidx, d2, resid = _search(q, index, knn.bound_value(max_distance), k)
    fail = _certificate_fail(resid, d2, max_distance)
    idx = to_orig(index, sidx) if orig_map else sidx
    return (idx, d2, fail) if batched else (idx[0], d2[0], fail[0])


def match_kd(
    queries: torch.Tensor,
    index: KDIndex,
    fallback_index: knn.TargetIndex,
    max_distance: float,
    query_mask: torch.Tensor | None = None,
    *,
    k: int | None = None,
    checks: int = 0,
    orig_map: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matching stage over the k-d index: ``(indices, dist2, valid)`` with
    the squared threshold of NearestNeighbor.h:182.

    ``checks == 0`` is the exact arm: rows whose certificate fails re-search
    through ``fallback_index`` with the visited-list search, launched every
    call; rows whose certificate closed pass radius -1 and are frozen.
    ``checks > 0`` is the FLANN-parity approximate arm: top
    ``checks_to_k(checks)`` blocks, no certificate, no fallback; there
    ``orig_map=False`` returns indices in the sorted page domain
    (``block * cap_pad + slot``, as the JAX package's
    ``match_kd(orig_map=False)``), from which the membership cache reads
    each row's block (:func:`to_orig` maps them to target rows)."""
    batched, (q, index, fallback_index, query_mask) = knn._batch_args(
        queries, index, fallback_index, query_mask)
    if checks > 0:
        k = checks_to_k(checks, index)
    idx, d2, fail = nn_search_kd_resident(
        q, index, max_distance, k=k, orig_map=orig_map or checks == 0)
    if checks == 0:
        bound_val = knn.bound_value(max_distance)
        radii = torch.where(fail, bound_val, -1.0).to(torch.float32)
        d = index.block_min.shape[-1]
        idxf, d2f = knn.nn_search_pruned_v2(
            q[..., :d], fallback_index, max_distance, per_query_bound=radii)
        idx = torch.where(fail, idxf, idx)
        d2 = torch.where(fail, d2f, d2)
    valid = (d2 <= max_distance) & (idx >= 0)
    if query_mask is not None:
        valid = valid & query_mask
    return (idx, d2, valid) if batched else (idx[0], d2[0], valid[0])


# ---------------------------------------------------------------------------
# Warm start: per-query radii from the previous iteration's matches
# ---------------------------------------------------------------------------


def _warm_search(q, index, max_distance, radius, k):
    """Core of the JAX package's ``_kd_bitmap_search``: per-query top-k
    membership (k = 0: every block within the radius) intersected with the
    radius ``binit = min(radius, bound_value)``; a negative radius freezes
    the row. Returns ``(sidx, d2, resid)``: the pair-local page index (-1
    where nothing beat ``binit``, d2 then ``binit``) and the certificate
    residual (the (k+1)-th smallest bound; +inf when k = 0).

    Within the resident rule (:func:`_resident_layout`) and k > 0 the
    search is box_topk + kd_block_search from ``binit``; past it, and for
    k = 0 at any size (box_topk takes at most ICP_MAX_K picks), box_topk
    (k > 0) + ``knn.kd_radius_search``: the JAX package's bitmap route."""
    d = index.block_min.shape[-1]
    q = q[..., :d].float().contiguous()
    binit = torch.clamp(radius.float(), max=knn.bound_value(max_distance)).contiguous()
    if k > 0:
        sel, resid = box_topk(q, binit, index.block_min, index.block_max, k)
    else:
        sel, resid = None, torch.full_like(binit, torch.inf)
    if k > 0 and _resident_layout(index)[1]:
        d2, sidx = kd_block_search(q, sel, binit, index.pages)
    else:
        d2, sidx = knn.kd_radius_search(
            q, binit, index.block_min, index.block_max, index.pages, sel)
    return sidx, d2, resid


def nn_search_kd_radius(
    queries: torch.Tensor, index: KDIndex, max_distance: float, radius: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN within per-query radii, radius-complete membership (a
    block is searched iff its box lower bound is within the query's
    radius): ``(orig_idx, d2)``. ``radius`` must upper-bound the query's
    squared NN distance (e.g. the distance to a real target point); a
    negative radius freezes the row. Rows where nothing beats
    ``min(radius, bound_value)`` return idx -1 and d2 = that bound."""
    batched, (q, index, radius) = knn._batch_args(queries, index, radius)
    sidx, d2, _ = _warm_search(q, index, max_distance, radius, 0)
    idx = to_orig(index, sidx)
    return (idx, d2) if batched else (idx[0], d2[0])


def nn_search_kd_warm(
    queries: torch.Tensor,
    index: KDIndex,
    max_distance: float,
    radius: torch.Tensor,
    *,
    k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-unless-flagged 1-NN: per-query top-k membership intersected
    with the warm radii; ``(orig_idx, dist2, fail)``, ``fail`` where the
    certificate does not close (the caller's fallback re-searches those).
    A top-k block dropped by the radius has lb > radius >= the found
    distance, so it cannot improve the result."""
    batched, (q, index, radius) = knn._batch_args(queries, index, radius)
    nc = index.pages.shape[-3]
    k = min(K_DEFAULT if k is None else k, nc)
    sidx, d2, resid = _warm_search(q, index, max_distance, radius, k)
    fail = _certificate_fail(resid, d2, max_distance)
    idx = to_orig(index, sidx)
    return (idx, d2, fail) if batched else (idx[0], d2[0], fail[0])


def warm_radius(queries, cache_idx, target_feats, max_distance, query_mask=None):
    """Per-query warm radii from cached matches: ``(radius, cached_d2,
    has_cache)``. ``cached_d2`` is the squared distance to the cached
    original target row (-1 = none), summed in the JAX package's order of
    f32 operations; the radius adds one rounding step of slack,
    ``cached_d2 * (1 + 1e-6) + 1e-30``, so the search re-finds the cached
    point, and is capped at :func:`knn.bound_value`. Cache-less rows take
    the bound, masked-out rows -1 (frozen). Every tensor has the pair axis."""
    d = target_feats.shape[-1]
    bound_val = knn.bound_value(max_distance)
    has_cache = cache_idx >= 0
    cached = knn.take_rows(target_feats, cache_idx.clamp(0, target_feats.shape[-2] - 1))
    diff = queries[..., :d] - cached[..., :d]
    cached_d2 = None
    for j in range(d):
        term = diff[..., j] * diff[..., j]
        cached_d2 = term if cached_d2 is None else cached_d2 + term
    radius = torch.where(has_cache, cached_d2 * _f32(1.0 + 1e-6) + _f32(1e-30), bound_val)
    radius = torch.clamp(radius, max=bound_val)
    if query_mask is not None:
        radius = torch.where(query_mask, radius, -1.0)
    return radius, cached_d2, has_cache


def nn_search_xla_flat(queries: torch.Tensor, index: KDIndex, *, chunk: int = 1024):
    """Portable exact 1-NN over a KDIndex's block table (direct differences
    against every block point, the first minimum in block-table order):
    ``(orig_idx, d2)``, the JAX package's CPU oracle of the warm path.
    Queries go ``chunk`` rows at a time; the results do not depend on it."""
    batched, (q, index) = knn._batch_args(queries, index)
    b, nc, dcap = index.block_pts.shape
    d = index.block_min.shape[-1]
    pts = index.block_pts.reshape(b, 1, nc, d, dcap // d)
    best, d2min = [], []
    for s in range(0, q.shape[1], chunk):
        qc = q[:, s:s + chunk]
        d2 = None
        for j in range(d):
            diff = pts[..., j, :] - qc[:, :, None, j, None]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        m, a = torch.min(d2.reshape(b, qc.shape[1], -1), dim=-1)
        best.append(a)
        d2min.append(m)
    orig = knn.take_rows(index.block_orig.reshape(b, -1), torch.cat(best, dim=1))
    d2 = torch.cat(d2min, dim=1)
    return (orig, d2) if batched else (orig[0], d2[0])


def match_kd_warm(
    queries: torch.Tensor,
    index: KDIndex,
    max_distance: float,
    cache_idx: torch.Tensor,
    target_feats: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    *,
    fallback_index: knn.TargetIndex | None = None,
    k: int | None = None,
    checks: int = 0,
    impl: str = "search",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warm-start matching stage: ``(indices, dist2, valid)`` with the
    squared threshold of NearestNeighbor.h:182, each query searching within
    the exact distance to its cached match.

    ``cache_idx`` (..., N) holds each query's last matched original target
    row (-1 = none); ``target_feats`` (..., capacity, d) is the original
    feature table distances are measured in (points, or 6-dim colour
    features). Radii come from :func:`warm_radius`. On the exact arm
    (``checks == 0``) with ``fallback_index`` (a ``knn.TargetIndex``) the
    search is :func:`nn_search_kd_warm` and rows whose certificate fails
    re-search through the visited-list search; with ``k == 0`` or no
    fallback it is :func:`nn_search_kd_radius`. ``checks > 0`` is the
    approximate arm: top ``checks_to_k(checks)`` blocks within the radii,
    no certificate, no fallback. Rows whose search finds nothing strictly
    better keep their cached match within the threshold (the tie and
    round-off backstop).

    ``impl="oracle"`` is the JAX package's portable CPU oracle instead (a
    full exact search with radii ignored, or on the approximate arm the
    cold top-k search deferring to the cached match); it takes CPU tensors
    only."""
    if impl not in ("search", "oracle"):
        raise ValueError(f"match_kd_warm: impl must be 'search' or 'oracle', got {impl!r}")
    batched, (q, index, cache_idx, target_feats, query_mask, fallback_index) = knn._batch_args(
        queries, index, cache_idx, target_feats, query_mask, fallback_index)
    if impl == "oracle" and q.device.type != "cpu":
        raise ValueError("match_kd_warm: the oracle takes CPU tensors only")
    if checks > 0:
        k = checks_to_k(checks, index)
    d = index.block_min.shape[-1]
    bound_val = knn.bound_value(max_distance)
    radius, cached_d2, has_cache = warm_radius(
        q, cache_idx, target_feats, max_distance, query_mask)
    if impl == "oracle" and checks > 0:
        fidx, fd2, _ = nn_search_kd(q, index, max_distance, k=k)
        not_better = has_cache & (fd2 >= cached_d2)
        idx = torch.where(not_better, -1, fidx)
        d2 = torch.where(not_better, bound_val, fd2)
    elif impl == "oracle":
        fidx, fd2 = nn_search_xla_flat(q[..., :d].float(), index)
        over = fd2 > _f32(max_distance)
        idx = torch.where(over, -1, fidx)
        d2 = torch.where(over, bound_val, fd2)
    elif checks > 0:
        idx, d2, _ = nn_search_kd_warm(q, index, max_distance, radius, k=k)
    elif k == 0 or fallback_index is None:
        idx, d2 = nn_search_kd_radius(q, index, max_distance, radius)
    else:
        idx, d2, fail = nn_search_kd_warm(q, index, max_distance, radius, k=k)
        fradii = torch.where(fail, bound_val, -1.0).to(torch.float32)
        idxf, d2f = knn.nn_search_pruned_v2(
            q[..., :d], fallback_index, max_distance, per_query_bound=fradii)
        idx = torch.where(fail, idxf, idx)
        d2 = torch.where(fail, d2f, d2)
    keep = (idx < 0) & has_cache & (cached_d2 <= _f32(max_distance))
    if query_mask is not None:
        keep = keep & query_mask
    idx = torch.where(keep, cache_idx.to(idx.dtype), idx)
    d2 = torch.where(keep, cached_d2, d2)
    valid = (d2 <= max_distance) & (idx >= 0)
    if query_mask is not None:
        valid = valid & query_mask
    return (idx, d2, valid) if batched else (idx[0], d2[0], valid[0])


# ---------------------------------------------------------------------------
# Seeded block membership: kernel 4 fused with kernel 2's restrict_col mode
# ---------------------------------------------------------------------------


def _pose_args(q: torch.Tensor, pose) -> torch.Tensor | None:
    """A (4, 4) or (B, 4, 4) pose as (B, 4, 4) f32 on ``q``'s device, for
    ``q`` (B, N, D); None stays None."""
    if pose is None:
        return None
    p = torch.as_tensor(pose, dtype=torch.float32).to(q.device)
    return p.expand(q.shape[0], 4, 4) if p.dim() == 2 else p


def nn_search_kd_cached_oracle(
    queries: torch.Tensor, index: KDIndex, max_distance: float, blk_ids: torch.Tensor,
    pose: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`nn_search_kd_cached`: the best point of each
    query's assigned block through one row gather of its coordinate-major
    block row; ties go to the lowest slot. With ``pose`` the queries are
    raw features and their spatial columns are moved first by
    :func:`se3.transform_points` (the kernel's order of products and sums)."""
    batched, (q, index, blk) = knn._batch_args(queries, index, blk_ids)
    pose = _pose_args(q, pose)
    if pose is not None:
        q = torch.cat([se3.transform_points(q[..., :3], pose), q[..., 3:]], dim=-1)
    nc, dcap = index.block_pts.shape[-2:]
    d = index.block_min.shape[-1]
    cap, cap_pad = dcap // d, index.pages.shape[-1]
    blk = blk.to(torch.int32).clamp(-1, nc - 1)
    cand = knn.take_rows(index.block_pts, blk.clamp(min=0))       # (B, N, D*cap)
    d2 = None
    for j in range(d):
        diff = cand[..., j * cap:(j + 1) * cap] - q[..., j, None]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    best, slot = torch.min(d2, dim=-1)
    bound_val = knn.bound_value(max_distance)
    # The kernel's miss rule: its running best starts at bound_val and
    # takes only strictly smaller distances.
    miss = (blk < 0) | (best >= bound_val)
    sidx = torch.where(miss, -1, blk.clamp(min=0) * cap_pad + slot.to(torch.int32))
    d2 = torch.where(miss, bound_val, best)
    return (sidx, d2) if batched else (sidx[0], d2[0])


def nn_search_kd_cached(
    queries: torch.Tensor, index: KDIndex, max_distance: float, blk_ids: torch.Tensor,
    pose: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate 1-NN with seeded membership: query i searches exactly
    block ``blk_ids[i]`` of the index (-1 = nothing: idx -1, d2 = the miss
    bound), strictly below :func:`knn.bound_value`. Returns ``(sorted_idx,
    d2)`` in the pair-local page domain; no certificate.

    ``queries`` (B, N, >= D), ``blk_ids`` (B, N) int. ``pose`` ((4, 4), or
    (B, 4, 4) one per pair): the queries are RAW source features, and the
    search moves their three spatial columns by ``R p + t`` itself (the
    JAX package's in-kernel transform); the other features pass through.
    A CUDA tensor launches ``csrc/cached_block_search.cu`` (D = 3 or 6,
    from the index): :func:`kd_block_search`'s block-major machinery at
    k = 1 from the common bound, in a workspace sized as its own; a CPU
    tensor runs :func:`nn_search_kd_cached_oracle`."""
    if queries.device.type == "cpu":
        return nn_search_kd_cached_oracle(queries, index, max_distance, blk_ids, pose=pose)
    batched, (q, index, blk) = knn._batch_args(queries, index, blk_ids)
    d = _cuda.feature_dim("cached_block_search", index.block_min.shape[-1])
    q = q[..., :d].float().contiguous()
    blk = blk.to(torch.int32).contiguous()
    b, n = q.shape[0], q.shape[1]
    nc, cap_pad = index.pages.shape[1], index.pages.shape[-1]
    pose = _pose_args(q, pose)
    chk = _cuda.check_cuda_tensor
    chk("blk_ids", blk, torch.int32, (b, n))
    chk("pages", index.pages, torch.float32, (b, nc, 8, cap_pad))
    if pose is not None:
        pose = pose.contiguous()
        chk("pose", pose, torch.float32, (b, 4, 4))
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws_bytes = _block_search_workspace_bytes(b, n, nc, 1)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    _cuda.launch("cached_block_search", q, blk, pose, knn.bound_value(max_distance),
                 index.pages, d2, idx, ws, ws_bytes, b, n, nc, cap_pad, d)
    return (idx, d2) if batched else (idx[0], d2[0])


def match_kd_cached(
    queries: torch.Tensor,
    index: KDIndex,
    max_distance: float,
    blk_ids: torch.Tensor,
    query_mask: torch.Tensor | None = None,
    pose: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matching stage over seeded block membership (approximate arm only):
    the ``(indices, dist2, valid)`` contract of :func:`match_kd` with
    ``orig_map=False``. Masked-out queries search nothing. ``pose``: see
    :func:`nn_search_kd_cached`."""
    blk = blk_ids if query_mask is None else torch.where(query_mask, blk_ids, -1)
    idx, d2 = nn_search_kd_cached(queries, index, max_distance, blk, pose=pose)
    valid = (d2 <= max_distance) & (idx >= 0)
    if query_mask is not None:
        valid = valid & query_mask
    return idx, d2, valid
