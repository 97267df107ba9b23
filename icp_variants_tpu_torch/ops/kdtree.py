"""Per-query 1-NN over a balanced k-d partition, exact within the threshold.

PyTorch port of ``icp_variants_tpu.ops.kdtree`` on the ETH main path:

* The target cloud is partitioned once per pair on the host by recursive
  widest-axis median splits (:func:`build_kd_index`): equal-count blocks
  with disjoint boxes.
* Per iteration each query ranks the block boxes by squared lower bound
  and keeps its top k (:func:`box_topk`, kernel ``csrc/box_topk.cu``),
  then takes exact direct-difference distances over the points of its own
  k blocks (:func:`kd_block_search`, kernel ``csrc/kd_block_search.cu``).
* Certificate: the (k+1)-th smallest bound is the smallest bound of any
  unexamined block. A query whose best distance does not beat it re-searches
  through the fallback (``knn.visited_search``, kernel
  ``csrc/visited_search.cu``). The JAX package hid that fallback behind a
  batch-global ``lax.cond``; here it launches every iteration, and rows
  whose certificate closed are frozen (radius -1) and exit at once — no
  host sync decides anything.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version (``*_plain``, same module) for CPU tensors only.
Every tensor carries a leading pair axis B; the search functions also take
one unbatched pair.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import _cuda, knn

# Sentinel for padded block slots: finite in f32, never the argmin.
LEAF_PAD = 1.0e9
# Default top-k block count of the exact arm.
K_DEFAULT = 4
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
    # Two blocks per 8-row page (d <= 3), carried for parity with the JAX
    # index; nothing in the port reads it.
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
    """Build the k-d search index of one target cloud on the host (numpy)
    and place it on ``device`` (``None`` = the card). ``points`` is the
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


# ---------------------------------------------------------------------------
# Kernel 1: box top-k
# ---------------------------------------------------------------------------


def _box_lb(q: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor) -> torch.Tensor:
    """Squared distance lower bound from each query to each box:
    (B, N, D) x (B, M, D) -> (B, N, M), coordinate at a time."""
    lb = None
    for j in range(q.shape[-1]):
        qj = q[:, :, None, j]
        gap = torch.clamp_min(
            torch.maximum(bmin[:, None, :, j] - qj, qj - bmax[:, None, :, j]), 0.0)
        lb = gap * gap if lb is None else lb + gap * gap
    return lb


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
    lb = _box_lb(q, bmin, bmax)
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
    tensor launches ``csrc/box_topk.cu`` (D = 3 only); a CPU tensor runs
    :func:`box_topk_plain`."""
    if q.device.type == "cpu":
        return box_topk_plain(q, binit, bmin, bmax, k)
    b, n, d = q.shape[0], q.shape[1], _cuda.KERNEL_DIM
    nc = bmin.shape[1]
    chk = _cuda.check_cuda_tensor
    chk("q", q, torch.float32, (b, n, d))
    chk("binit", binit, torch.float32, (b, n))
    chk("bmin", bmin, torch.float32, (b, nc, d))
    chk("bmax", bmax, torch.float32, (b, nc, d))
    sel = torch.empty((b, n, k), dtype=torch.int32, device=q.device)
    resid = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _cuda.launch("box_topk", q, binit, bmin, bmax, sel, resid, b, n, nc, k)
    return sel, resid


# ---------------------------------------------------------------------------
# Kernel 2: kd block search
# ---------------------------------------------------------------------------


def kd_block_search_plain(q, sel, binit, pages):
    """Plain version of :func:`kd_block_search`: gather each query's k
    blocks and take the first minimum in (sel position, slot) order."""
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
    q: torch.Tensor, sel: torch.Tensor, binit: torch.Tensor, pages: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each query among the points of its own blocks.

    ``q`` (B, N, D), ``sel`` (B, N, k) int32 block ids (-1 = none),
    ``binit`` (B, N) starting bounds, ``pages`` (B, nc, 8, cap_pad). A point
    counts only if its squared distance is strictly below the running best
    (starting at ``binit``); ties go to the earliest sel position, then the
    lowest slot. Returns ``(d2, idx)``, (B, N) each: idx is the pair-local
    page index ``block * cap_pad + slot`` (-1 if nothing beat ``binit``,
    and d2 is then ``binit``). A CUDA tensor launches
    ``csrc/kd_block_search.cu`` (D = 3 only); a CPU tensor runs
    :func:`kd_block_search_plain`."""
    if q.device.type == "cpu":
        return kd_block_search_plain(q, sel, binit, pages)
    b, n, d = q.shape[0], q.shape[1], _cuda.KERNEL_DIM
    k = sel.shape[-1]
    nc, cap_pad = pages.shape[1], pages.shape[-1]
    chk = _cuda.check_cuda_tensor
    chk("q", q, torch.float32, (b, n, d))
    chk("sel", sel, torch.int32, (b, n, k))
    chk("binit", binit, torch.float32, (b, n))
    chk("pages", pages, torch.float32, (b, nc, 8, cap_pad))
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    _cuda.launch("kd_block_search", q, sel, binit, pages, d2, idx, b, n, nc, cap_pad, k)
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


def _to_orig(index: KDIndex, sidx: torch.Tensor) -> torch.Tensor:
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
    idx = torch.where(over, -1, _to_orig(index, sidx))
    d2 = torch.where(over, knn.bound_value(max_distance), d2)
    return (idx, d2, fail) if batched else (idx[0], d2[0], fail[0])


def nn_search_kd_resident(
    queries: torch.Tensor, index: KDIndex, max_distance: float, *, k: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The production cold kd search: ``(orig_idx, dist2, fail)`` with the
    search bounded by the miss bound from the start (the JAX resident
    kernel's rule): rows where nothing beats it report idx -1 and dist2 =
    the bound; a best in (max_distance, bound) keeps its row and is
    rejected by the caller's threshold."""
    batched, (q, index) = knn._batch_args(queries, index)
    nc = index.pages.shape[-3]
    k = min(K_DEFAULT if k is None else k, nc)
    sidx, d2, resid = _search(q, index, knn.bound_value(max_distance), k)
    fail = _certificate_fail(resid, d2, max_distance)
    idx = _to_orig(index, sidx)
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matching stage over the k-d index: ``(indices, dist2, valid)`` with
    the squared threshold of NearestNeighbor.h:182.

    ``checks == 0`` is the exact arm: rows whose certificate fails re-search
    through ``fallback_index`` with the visited-list search, launched every
    call; rows whose certificate closed pass radius -1 and are frozen.
    ``checks > 0`` is the FLANN-parity approximate arm: top
    ``checks_to_k(checks)`` blocks, no certificate, no fallback."""
    batched, (q, index, fallback_index, query_mask) = knn._batch_args(
        queries, index, fallback_index, query_mask)
    if checks > 0:
        k = checks_to_k(checks, index)
    idx, d2, fail = nn_search_kd_resident(q, index, max_distance, k=k)
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
