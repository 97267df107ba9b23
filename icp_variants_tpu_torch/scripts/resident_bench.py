"""The kd block search's probe decomposition at the ETH shapes.

PyTorch port of ``probe_decomp`` of the JAX package's
``scripts/resident_bench.py``: three launches, each timed alone on the
card, split the kd matcher's time by cause:

* ``box_topk``: the prefix (block ranking, top-k, certificate);
* ``kd_block_search`` at probe 1: the bucketing of the (query, pick)
  entries by block and the staging of each chunk's block, no distances;
* ``kd_block_search`` in full.

So prefix = the first, staging = the second, distance = the third less the
second. The queries are the JAX script's draw (:func:`probe_queries`). Its
gate-width and tile sweeps tune TPU constants that the port does not have
and are not ported. :func:`lane_use` reads the block search's lane use from
a measurement build of its kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from icp_variants_tpu_torch.ops import _cuda, kdtree, knn
from icp_variants_tpu_torch.scripts import cuda_ms

N_QUERIES = 4736
PROBE_P = 0.012
PROBE_SIGMA = 0.02


def probe_queries(points, valid, *, n_q: int = N_QUERIES, p: float = PROBE_P,
                  sigma: float = PROBE_SIGMA, seed: int = 0) -> np.ndarray:
    """The JAX script's query draw: per pair (``points`` (B, N, 3) and
    ``valid`` (B, N), numpy, in Morton order), the valid rows kept with
    probability ``p`` (the first ``n_q``, the last repeated to fill), plus
    N(0, ``sigma``) noise; one numpy generator from ``seed`` across the
    pairs. Returns (B, n_q, 3) f32."""
    rng = np.random.default_rng(seed)
    qs = []
    for pts, ok in zip(points, valid):
        rows = np.flatnonzero((rng.random(len(pts)) < p) & ok)[:n_q]
        rows = np.pad(rows, (0, n_q - len(rows)), mode="edge")
        qs.append(pts[rows] + rng.normal(0, sigma, (n_q, 3)).astype(np.float32))
    return np.stack(qs).astype(np.float32)


def probe_decomp(kd: kdtree.KDIndex, q: torch.Tensor, max_distance: float = 10.0, *,
                 k: int = kdtree.K_DEFAULT, reps: int = 20) -> dict:
    """Time box_topk, kd_block_search at probe 1 and in full on the card
    for queries ``q`` (B, N, D) against the stacked ``kd`` index, every row
    starting from ``knn.bound_value(max_distance)``. Returns the median ms
    of each (``prefix_ms``, ``staging_ms`` for the probe, ``full_ms``),
    ``distance_ms`` = full - staging, and the launches' operands and
    outputs (``sel``, ``binit``, ``probe`` and ``full`` as (d2, idx)) for
    the caller's checks."""
    q = q.float().contiguous()
    binit = torch.full(q.shape[:2], knn.bound_value(max_distance), dtype=torch.float32,
                       device=q.device)
    sel, _ = kdtree.box_topk(q, binit, kd.block_min, kd.block_max, k)
    out = dict(sel=sel, binit=binit,
               probe=kdtree.kd_block_search(q, sel, binit, kd.pages, probe=1),
               full=kdtree.kd_block_search(q, sel, binit, kd.pages))
    out["prefix_ms"] = cuda_ms(lambda: kdtree.box_topk(q, binit, kd.block_min, kd.block_max, k),
                               reps)
    out["staging_ms"] = cuda_ms(
        lambda: kdtree.kd_block_search(q, sel, binit, kd.pages, probe=1), reps)
    out["full_ms"] = cuda_ms(lambda: kdtree.kd_block_search(q, sel, binit, kd.pages), reps)
    out["distance_ms"] = out["full_ms"] - out["staging_ms"]
    return out



LANE_DEFINES = ("KDB_LANE_COUNT",)


def lane_use(q: torch.Tensor, sel: torch.Tensor, binit: torch.Tensor,
             pages: torch.Tensor) -> dict:
    """Read how many of each warp's 32 lanes kd_block_search's walk keeps
    busy, on the card, for these operands: one launch of the measurement
    build of ``csrc/kd_block_search.cu`` (``-DKDB_LANE_COUNT``; not counted
    in ``_cuda.LAUNCHES``), whose walk sums ``__activemask()``'s lanes at
    each warp step. Returns ``spatial`` (active lanes / 32 over the steps
    of the first min(D, 3) features), ``colour`` (the same over the steps
    that add the colour terms at D = 6, else None), the step counts, and
    ``equal``: that build's (d2, idx) equal the production build's."""
    lib = _cuda.variant("kd_block_search.cu", LANE_DEFINES)
    read = lib.kd_block_search_lanes
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    counts = (ctypes.c_ulonglong * 4)()
    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise RuntimeError("kd_block_search_lanes: reset failed")
    got = kdtree._kd_block_search_launch(q, sel, binit, pages, 0, LANE_DEFINES)
    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise RuntimeError("kd_block_search_lanes: read failed")
    want = kdtree.kd_block_search(q, sel, binit, pages)
    active, steps, c_active, c_steps = (int(c) for c in counts)
    return dict(
        spatial=active / steps if steps else None, spatial_steps=steps // 32,
        colour=c_active / c_steps if c_steps else None, colour_steps=c_steps // 32,
        equal=bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
