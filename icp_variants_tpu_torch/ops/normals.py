"""Depth back-projection and k-NN PCA normal estimation.

Port of ``icp_variants_tpu.ops.normals``:

* :func:`backproject_depth` (the depth-map PointCloud constructor,
  PointCloud.h:92-142) runs once per frame at load time, like the kd build,
  in numpy float32 with the JAX package's operation order, so the points
  (and with them the 6-dim Morton order of ``data.rgbd.cloud_from_depth``)
  equal the JAX package's on the same inputs;
* PCL's k-NN ``NormalEstimation`` with k = 5 (PointCloud.h:41-76): each
  point's k nearest neighbours, their covariance, its smallest eigenvector
  by a closed-form symmetric 3x3 eigensolver (:func:`smallest_eigenvector_sym3`,
  elementwise, no batched LAPACK), oriented toward the viewpoint.
  :func:`estimate_normals_knn` finds the neighbours densely
  (``knn.knn_k``); :func:`estimate_normals_knn_fast`, for large clouds, in
  Morton tiles under a per-tile bound. Both are plain PyTorch on the card
  (plain XLA in the JAX package, no Pallas kernel), chunked over tiles so
  the candidate distances of a 365k-point cloud never sit in memory at
  once.

Every product and sum of a distance or covariance is rounded on its own,
in a fixed order, so a CUDA run and a CPU run differ only where the card's
``sqrt`` / ``acos`` / ``cos`` round differently.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.ops import knn as knn_lib

# Far-away fill of invalid rows and of the tile padding (never in a real
# point's top-k; their own normals are masked).
SENTINEL = 2.0e6
# Candidate distances held at once by the tiled k-NN (floats): a chunk of
# query tiles is sized to stay within this.
CHUNK_CANDIDATES = 1 << 25
# From this many points on, a host cloud's normals come from the
# Morton-banded exact k-NN, below it from the dense one (the JAX package's
# switch in its api.py and data/loaders.py).
FAST_NORMALS_MIN_POINTS = 20_000


def backproject_depth(depth, intrinsics, extrinsics_inv, max_distance: float = 0.1):
    """Back-project a depth image into a (H*W)-row point set with normals.

    * point = Rinv @ [(u - cx) / fx * d, (v - cy) / fy * d, d] + tinv;
    * normal = normalize([-du, -dv, 1]) from central differences of the
      depth (wrapping at the image edge), invalid when non-finite or
      |du|, |dv| > max_distance / 2; left in the camera frame, as the
      reference does;
    * image borders get invalid normals.

    Returns numpy ``(points (H*W, 3) f32, normals (H*W, 3) f32 with NaN
    rows where invalid, valid_point (H*W,), valid_normal (H*W,))``.
    """
    depth = np.asarray(depth, np.float32)
    k = np.asarray(intrinsics, np.float32)
    e = np.asarray(extrinsics_inv, np.float32)
    h, w = depth.shape
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    valid_point = np.isfinite(depth)
    d = np.where(valid_point, depth, np.float32(0.0))
    cam = (((uu - cx) / fx * d).reshape(-1), ((vv - cy) / fy * d).reshape(-1), d.reshape(-1))
    pts = np.stack([cam[0] * e[i, 0] + cam[1] * e[i, 1] + cam[2] * e[i, 2] + e[i, 3]
                    for i in range(3)], axis=-1)

    half = np.float32(max_distance / 2.0)
    with np.errstate(invalid="ignore"):
        du = np.float32(0.5) * (np.roll(depth, -1, axis=1) - np.roll(depth, 1, axis=1))
        dv = np.float32(0.5) * (np.roll(depth, -1, axis=0) - np.roll(depth, 1, axis=0))
        grad_ok = (np.isfinite(du) & np.isfinite(dv)
                   & (np.abs(du) <= half) & (np.abs(dv) <= half))
        n = np.stack([-du, -dv, np.ones_like(du)], axis=-1)
        n = n / np.sqrt(np.sum(n * n, axis=-1, keepdims=True))
    border = (uu == 0) | (uu == w - 1) | (vv == 0) | (vv == h - 1)
    valid_normal = grad_ok & ~border
    normals = np.where(valid_normal[..., None], n, np.float32(np.nan)).reshape(-1, 3)
    return (pts.astype(np.float32), normals.astype(np.float32),
            valid_point.reshape(-1), valid_normal.reshape(-1))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # Separate products and differences (torch.linalg.cross may contract
    # them on the card), so the card and the CPU round alike.
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def smallest_eigenvector_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    matrices, elementwise: the trigonometric eigenvalue (``arccos`` of the
    clipped ratio), then the largest of three cross products of the rows of
    ``A - lambda I``; +z where that vanishes (isotropic neighbourhoods)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    b2 = (B * B).flatten(-2)
    p2 = b2[..., 0]
    for j in range(1, 9):
        p2 = p2 + b2[..., j]
    p2 = p2 / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    det_b = _dot3(B[..., 0, :], _cross(B[..., 1, :], B[..., 2, :]))
    r = torch.clamp(det_b / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)

    M = A - lam[..., None, None] * eye
    cands = torch.stack([_cross(M[..., 0, :], M[..., 1, :]),
                         _cross(M[..., 0, :], M[..., 2, :]),
                         _cross(M[..., 1, :], M[..., 2, :])], dim=-2)
    norms = torch.sqrt(_dot3(cands, cands))
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    vn = torch.sqrt(_dot3(v, v))[..., None]
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(vn > 1e-20, v / torch.clamp(vn, min=1e-30), fallback)


def _covariance_normals(points, valid, idx, k, viewpoint):
    """Normals from k-NN indices (N, k): neighbour covariance -> smallest
    eigenvector -> flipped toward ``viewpoint``; NaN on invalid rows."""
    neigh = points[idx.long()]                          # (N, k, 3)
    mean = neigh[:, 0]
    for j in range(1, k):
        mean = mean + neigh[:, j]
    c = neigh - (mean / k)[:, None, :]
    cov = c[:, 0, :, None] * c[:, 0, None, :]
    for j in range(1, k):
        cov = cov + c[:, j, :, None] * c[:, j, None, :]
    n = smallest_eigenvector_sym3(cov / k)
    flip = _dot3(n, viewpoint - points) < 0
    n = torch.where(flip[:, None], -n, n)
    return torch.where(valid[:, None], n, torch.nan)


def _tile_chunks(n_tiles: int, tile: int, n_cols: int):
    """[start, end) ranges of query tiles whose candidate distances fit
    :data:`CHUNK_CANDIDATES`."""
    per = max(1, CHUNK_CANDIDATES // (tile * n_cols))
    return [(a, min(a + per, n_tiles)) for a in range(0, n_tiles, per)]


def _tile_d2(qt: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """(C, T, W) squared distances of query tiles (C, T, 3) to candidate
    rows (C, W, 3), by direct differences summed in coordinate order."""
    d = qt[:, :, None, 0] - ct[:, None, :, 0]
    d2 = d * d
    for j in (1, 2):
        d = qt[:, :, None, j] - ct[:, None, :, j]
        d2 += d * d
    return d2


def _self_knn_band_ub(points: torch.Tensor, k: int, tile: int) -> torch.Tensor:
    """Per-row upper bound on the k-th neighbour distance (squared): the
    exact k-th smallest over the row's own Morton tile and the two beside
    it, wrapping around at the ends (each candidate a distinct point, so
    the bound holds; edge clamping would count own-tile rows twice and
    undercut it). Clouds of fewer than 3 tiles take every row as a
    candidate (exact). ``points`` (n_pad, 3), n_pad a multiple of ``tile``."""
    n = points.shape[0]
    n_tiles = n // tile
    tiles = points.reshape(n_tiles, tile, 3)
    n_cols = 3 * tile if n_tiles >= 3 else n
    out = []
    for a, b in _tile_chunks(n_tiles, tile, n_cols):
        ids = torch.arange(a, b, device=points.device)
        if n_tiles >= 3:
            cand = torch.cat([tiles[(ids - 1) % n_tiles], tiles[ids],
                              tiles[(ids + 1) % n_tiles]], dim=1)
        else:
            cand = points[None].expand(b - a, n, 3)
        _, vals = knn_lib.k_smallest(_tile_d2(tiles[a:b], cand), k)
        out.append(vals[..., -1].reshape(-1))
    return torch.cat(out)


def _gather_chunk(tiles: torch.Tensor, qt: torch.Tensor, tids: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Exact k-NN rows (C, T, k) of query tiles ``qt`` (C, T, 3) over the
    candidate tiles ``tids`` (C, S) of ``tiles``. A slot repeating an
    earlier slot's tile is masked out: a duplicated candidate column would
    let the k rounds pick one point twice and push a true neighbour out.
    Ties go to the earlier slot, then the lower row of the tile."""
    c, n_slots = tids.shape
    tile = tiles.shape[1]
    slot = torch.arange(n_slots, device=tids.device)
    cand = tiles[tids].reshape(c, n_slots * tile, 3)
    d2 = _tile_d2(qt, cand)
    dup = ((tids[:, :, None] == tids[:, None, :])
           & (slot[None, :] < slot[:, None])[None]).any(-1)          # (C, S)
    d2.masked_fill_(dup.repeat_interleave(tile, dim=1)[:, None, :], float("inf"))
    pos, _ = knn_lib.k_smallest(d2, k)
    lanes = torch.arange(tile, device=tids.device)
    cols = (tids[:, :, None] * tile + lanes).reshape(c, 1, -1).expand(-1, qt.shape[1], -1)
    return torch.gather(cols, -1, pos)


def _self_knn_gather_topk(points: torch.Tensor, vlist: torch.Tensor, k: int, tile: int,
                          counts: np.ndarray) -> torch.Tensor:
    """Exact k-NN indices (n_pad, k) from per-query-tile candidate lists:
    row t of ``vlist`` (n_tiles, S) holds, in its first ``counts[t]``
    slots, every tile within tile t's bound in ascending order, padded by
    repeats of tile 0 (masked out, :func:`_gather_chunk`).

    Tiles are taken in order of their count (on the host), each chunk
    scanning only the slots its longest list needs, rounded up to 4 (the
    JAX package scans every tile to the longest list of all): the same
    candidates in the same slots, so the same answer, but a few wide tiles
    (a Morton jump, the padded last tile) no longer set every tile's
    width. Equal ``counts`` give the JAX package's uniform width."""
    n_tiles = points.shape[0] // tile
    tiles = points.reshape(n_tiles, tile, 3)
    order = np.argsort(counts, kind="stable")
    width = np.maximum((counts[order] + 3) // 4 * 4, 4)
    out = torch.empty((n_tiles, tile, k), dtype=torch.int64, device=points.device)
    a = 0
    while a < n_tiles:
        b = a + 1
        while b < n_tiles and (b + 1 - a) * tile * tile * width[b] <= CHUNK_CANDIDATES:
            b += 1
        ids = torch.from_numpy(order[a:b]).to(points.device)
        out[ids] = _gather_chunk(tiles, tiles[ids], vlist[ids, :int(width[b - 1])].long(), k)
        a = b
    return out.reshape(-1, k)


def _self_knn_fast(points, valid, k: int, tile: int, dev: torch.device):
    """The Morton-banded exact self k-NN of :func:`estimate_normals_knn_fast`.
    Returns ``(sp, valid_sorted, idx_sorted, order)``: the Morton-ordered
    cloud padded to whole tiles with sentinels (n_pad, 3), its validity,
    each row's k nearest rows (n_pad, k) in that order, and the host
    permutation (sorted row i is input row ``order[i]``)."""
    pts_np = np.asarray(points, np.float32)
    valid_np = np.asarray(valid, bool) & np.isfinite(pts_np).all(axis=1)
    n = len(pts_np)
    pts_np = np.where(valid_np[:, None], pts_np, np.float32(SENTINEL)).astype(np.float32)
    order = np.argsort(knn_lib.morton_codes_np(pts_np, valid_np), kind="stable")
    pad = (-n) % tile
    sp = torch.from_numpy(np.concatenate(
        [pts_np[order], np.full((pad, 3), SENTINEL, np.float32)])).to(dev)
    valid_sorted = torch.from_numpy(
        np.concatenate([valid_np[order], np.zeros(pad, bool)])).to(dev)

    ub = torch.where(valid_sorted, _self_knn_band_ub(sp, k, tile), 0.0)
    n_tiles = sp.shape[0] // tile
    tiles = sp.reshape(n_tiles, tile, 3)
    bound = ub.reshape(n_tiles, tile).amax(dim=1)
    qmin, qmax = tiles.amin(dim=1), tiles.amax(dim=1)
    gap = torch.clamp(torch.maximum(qmin[:, None, :] - qmax[None, :, :],
                                    qmin[None, :, :] - qmax[:, None, :]), min=0.0)
    lb = _dot3(gap, gap)                                            # (nt, nt)
    visited = lb <= bound[:, None] * (1.0 + 1e-6)
    counts = visited.sum(dim=1).cpu().numpy()                       # the one host sync
    cand_tiles = max(((int(counts.max()) + 3) // 4) * 4, 4)
    ids = torch.arange(n_tiles, device=dev)
    vlist = torch.sort(torch.where(visited, ids, n_tiles), dim=1).values
    if vlist.shape[1] < cand_tiles:
        vlist = torch.nn.functional.pad(vlist, (0, cand_tiles - vlist.shape[1]),
                                        value=n_tiles)
    vlist = torch.where(vlist < n_tiles, vlist, 0)[:, :cand_tiles]
    idx_sorted = _self_knn_gather_topk(sp, vlist, k, tile, counts)
    return sp, valid_sorted, idx_sorted, order


def self_knn_fast(points, valid, k: int = 5, tile: int = 256, device=None) -> torch.Tensor:
    """Each valid row's k nearest rows of the same cloud (itself first, at
    distance 0), (N, k) int64 in the input's numbering on ``device``
    (``None`` = the card): the exact search behind
    :func:`estimate_normals_knn_fast`. Rows of invalid points hold
    sentinel neighbours."""
    dev = resolve_device(device)
    _, _, idx_sorted, order = _self_knn_fast(points, valid, k, tile, dev)
    n = len(order)
    order_t = torch.from_numpy(order).to(dev)
    inv_order = torch.empty_like(order_t)
    inv_order[order_t] = torch.arange(n, device=dev)
    orig = torch.cat([order_t, torch.full((idx_sorted.shape[0] - n,), -1, device=dev)])
    return orig[idx_sorted[:n][inv_order]]


def estimate_normals_knn_fast(points, valid, k: int = 5, viewpoint=None, tile: int = 256,
                              device=None) -> torch.Tensor:
    """Exact k-NN PCA normals for large clouds (PCL's kSearch = 5 at ETH
    scale, PointCloud.h:41-76), in the JAX package's Morton-banded form, on
    ``device`` (``None`` = the card).

    On the host: invalid rows become far sentinels, the cloud is Morton
    ordered and padded to whole tiles. On the device: each row's k-th
    neighbour distance is bounded within its own and the two adjacent tiles
    (:func:`_self_knn_band_ub`; sentinel rows' bounds dropped, else their
    reach to real points would mark every tile visited), each tile takes
    the largest bound of its rows, every tile whose box lies within it
    joins the tile's candidate list, and the exact top-k runs over those
    lists (:func:`_self_knn_gather_topk`, tiles grouped by list length).
    One host sync reads the lists' lengths. Returns (N, 3) normals in the
    input's row order on ``device``, NaN on invalid rows."""
    dev = resolve_device(device)
    sp, valid_sorted, idx_sorted, order = _self_knn_fast(points, valid, k, tile, dev)
    vp = (torch.zeros(3, dtype=torch.float32, device=dev) if viewpoint is None
          else torch.as_tensor(viewpoint, dtype=torch.float32).to(dev))
    normals_sorted = _covariance_normals(sp, valid_sorted, idx_sorted, k, vp)
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(len(order))
    return normals_sorted[:len(order)][torch.from_numpy(inv_order).to(dev)]


def estimate_normals_knn(points: torch.Tensor, valid: torch.Tensor, k: int = 5,
                         viewpoint=None) -> torch.Tensor:
    """PCL-style k-NN normals (PointCloud.h:41-76, kSearch = 5) with the
    neighbours found densely by ``knn.knn_k`` (the query is one of its own
    neighbours, as in PCL): (N, 3) on the points' device, NaN on invalid
    rows. For small clouds; see :func:`estimate_normals_knn_fast`."""
    vp = (torch.zeros(3, dtype=points.dtype, device=points.device) if viewpoint is None
          else torch.as_tensor(viewpoint, dtype=points.dtype).to(points.device))
    idx, _ = knn_lib.knn_k(points, points, k)
    return _covariance_normals(points, valid, idx, k, vp)


def estimate_normals_host(points: np.ndarray, k: int = 5, device=None) -> np.ndarray:
    """k-NN PCA normals of a host (N, 3) cloud, estimated on ``device``
    (``None`` = the card) and returned on the host: the Morton-banded
    search from :data:`FAST_NORMALS_MIN_POINTS` points on, the dense one
    below. Rows with a non-finite coordinate are invalid (NaN normals)."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    finite = np.isfinite(points).all(axis=1)
    if len(points) >= FAST_NORMALS_MIN_POINTS:
        nrm = estimate_normals_knn_fast(points, finite, k=k, device=dev)
    else:
        nrm = estimate_normals_knn(torch.from_numpy(points).to(dev),
                                   torch.from_numpy(finite).to(dev), k=k)
    return nrm.cpu().numpy()
