"""The kd block search's probe decomposition at the ETH shapes.

PyTorch port of ``probe_decomp`` of the JAX package's
``scripts/resident_bench.py``: three launches, each timed alone on the
card, split the kd matcher's time by cause:

* ``box_topk``: the prefix (block ranking, top-k, certificate);
* ``kd_block_search`` at probe 1: per gate the pick and walk lists and the
  staging of each member block, no distances;
* ``kd_block_search`` in full.

So prefix = the first, staging = the second, distance = the third less the
second. The queries are the JAX script's draw (:func:`probe_queries`). Its
gate-width and tile sweeps tune TPU constants that the port does not have
(the gate is fixed at 32 rows, ``csrc/common.cuh``) and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_variants_tpu_torch.ops import kdtree, knn
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
