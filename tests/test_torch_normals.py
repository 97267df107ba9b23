"""The port's exact k-NN (``knn.knn_k``) and k-NN PCA normals
(``ops/normals.py``) against the JAX package on the CPU and against
scipy's cKDTree, on the same numpy inputs made from a seed.

Tolerances:
* ``knn_k`` sums the expansion ``|q|^2 + |t|^2 - 2 q.t`` with each product
  rounded on its own; JAX's CPU path (a matrix product) is looser, at about
  ``(|q|^2 + |t|^2) 2^-22``. Distances agree within that bound; indices are
  equal except where both picks' float64 distances lie within it (ties);
  an exact tie (a duplicated target) goes to the lower row.
* The tiled searches sum direct differences, as JAX's jitted ones do up to
  a fused multiply-add: bounds to rtol 5e-7, indices equal except ties
  within 4 f32 ulps of the float64 distance.
* Normals: rows whose covariance has a relative eigen-gap
  ``(l2 - l1) / l3`` below 1e-3 are skipped (there two correct solvers
  may pick different vectors); elsewhere ``|cos|`` to JAX's normal and to a
  float64 PCA over the same neighbours above 1 - 1e-4, and the sign (the
  viewpoint flip) equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu.ops import normals as jnormals
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.ops import normals as tnormals

torch.set_num_threads(2)

GAP_FLOOR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _sheet(n, seed, noise=0.01):
    """A wavy 10 m sheet with small noise (well-defined normals)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-5, 5, (n, 2))
    z = 0.5 * np.sin(0.6 * xy[:, 0]) * np.cos(0.4 * xy[:, 1]) + noise * rng.standard_normal(n)
    return np.column_stack([xy, z]).astype(np.float32)


def _pca64(points, idx, viewpoint=np.zeros(3)):
    """Float64 PCA normal (flipped toward the viewpoint) and the relative
    eigen-gap of each row's neighbourhood."""
    neigh = points[idx].astype(np.float64)
    c = neigh - neigh.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", c, c) / idx.shape[1]
    w, v = np.linalg.eigh(cov)
    n = v[..., 0]
    flip = np.sum(n * (viewpoint - points), axis=1) < 0
    n = np.where(flip[:, None], -n, n)
    gap = (w[:, 1] - w[:, 0]) / np.maximum(w[:, 2], 1e-30)
    return n, gap


# ---------------------------------------------------------------------------
# knn_k
# ---------------------------------------------------------------------------


def test_knn_k_matches_jax_and_ckdtree():
    t = _sheet(3000, 1)
    t[100:140] = t[200:240]                       # exact duplicates: ties
    q = np.concatenate([t[:600], _sheet(400, 2)]).astype(np.float32)
    k = 5
    ti, td = (x.numpy() for x in tknn.knn_k(_t(q), _t(t), k, chunk=256))
    ji, jd = (np.asarray(x) for x in jknn.knn_k(jnp.asarray(q), jnp.asarray(t), k))
    assert ti.shape == (1000, k) and ti.dtype == np.int32
    tol = (np.sum(q.astype(np.float64) ** 2, 1)[:, None]
           + np.sum(t.astype(np.float64) ** 2, 1)[ti]) * 2.0 ** -22 + 1e-12
    np.testing.assert_array_less(np.abs(td - jd), tol * 2)
    assert np.all(np.diff(td, axis=1) >= 0)
    true = lambda idx: np.sum((q[:, None, :].astype(np.float64) - t[idx]) ** 2, -1)  # noqa: E731
    diff = ti != ji
    assert np.all(np.abs(true(ti) - true(ji))[diff] <= (2 * tol)[diff])
    assert diff.mean() < 0.05
    # Against cKDTree: the same neighbour distances within the rounding.
    dref, _ = cKDTree(t.astype(np.float64)).query(q.astype(np.float64), k=k)
    np.testing.assert_array_less(np.abs(true(ti) - dref ** 2), 2 * tol)
    # An exact tie goes to the lower row: query 100 sees rows 100 and 200
    # at one distance (0, or the same rounding of it), 100 first.
    assert ti[100, 0] == 100 and ti[100, 1] == 200 and td[100, 0] == td[100, 1]
    # Unbatched and batched calls agree.
    bi, bd = tknn.knn_k(_t(q)[None], _t(t)[None], k, chunk=256)
    np.testing.assert_array_equal(bi[0].numpy(), ti)
    np.testing.assert_array_equal(bd[0].numpy(), td)


def test_k_smallest_breaks_ties_to_the_lower_column():
    d2 = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, 0.5]])
    cols, vals = tknn.k_smallest(d2.clone(), 4)
    assert cols.tolist() == [[3, 5, 1, 2]] and vals.tolist() == [[0.5, 0.5, 1.0, 1.0]]


# ---------------------------------------------------------------------------
# The eigensolver and covariance normals
# ---------------------------------------------------------------------------


def test_smallest_eigenvector_matches_jax_and_eigh():
    pts = _sheet(2000, 3)
    idx = cKDTree(pts).query(pts, k=5)[1]
    neigh = pts[idx]
    c = neigh - neigh.mean(1, keepdims=True)
    cov = (np.einsum("nki,nkj->nij", c, c) / 5).astype(np.float32)
    rng = np.random.default_rng(4)
    iso = np.tile(np.eye(3, dtype=np.float32) * 2.0, (3, 1, 1))      # isotropic: +z
    A = np.concatenate([cov, iso, rng.normal(0, 1, (50, 3, 3)).astype(np.float32)])
    A[-50:] = A[-50:] @ np.swapaxes(A[-50:], -1, -2)                 # random SPD
    tv = tnormals.smallest_eigenvector_sym3(_t(A)).numpy()
    jv = np.asarray(jnormals.smallest_eigenvector_sym3(jnp.asarray(A)))
    w, v = np.linalg.eigh(A.astype(np.float64))
    ok = (w[:, 1] - w[:, 0]) / np.maximum(w[:, 2], 1e-30) >= GAP_FLOOR
    assert ok.sum() > 1900
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, atol=1e-5)
    assert np.all(np.abs(np.sum(tv * jv, 1))[ok] > 1 - 1e-4)
    assert np.all(np.abs(np.sum(tv * v[..., 0], 1))[ok] > 1 - 1e-4)
    np.testing.assert_array_equal(tv[2000:2003], [[0, 0, 1]] * 3)
    np.testing.assert_array_equal(jv[2000:2003], [[0, 0, 1]] * 3)


def _compare_normals(tn, jn, pts, idx, valid):
    """The normals of the module docstring's tolerance, against JAX and a
    float64 PCA over ``idx``; NaN exactly on invalid rows."""
    np.testing.assert_array_equal(np.isnan(tn).any(1), ~valid)
    np.testing.assert_array_equal(np.isnan(jn).any(1), ~valid)
    n64, gap = _pca64(pts, idx)
    ok = valid & (gap >= GAP_FLOOR)
    assert ok.sum() > 0.95 * valid.sum()
    cos_j = np.sum(tn * jn, 1)[ok]
    assert np.all(np.abs(cos_j) > 1 - 1e-4) and np.all(cos_j > 0)
    assert np.all(np.abs(np.sum(tn * n64, 1))[ok] > 1 - 1e-4)


def test_estimate_normals_knn_matches_jax():
    """The dense path (knn_k neighbours), invalid rows NaN."""
    pts = _sheet(1500, 5)
    valid = np.ones(1500, bool)
    valid[::97] = False
    tn = tnormals.estimate_normals_knn(_t(pts), _t(valid)).numpy()
    jn = np.asarray(jnormals.estimate_normals_knn(jnp.asarray(pts), jnp.asarray(valid)))
    idx = cKDTree(pts).query(pts, k=5)[1]
    _compare_normals(tn, jn, pts, idx, valid)


# ---------------------------------------------------------------------------
# The Morton-banded fast path
# ---------------------------------------------------------------------------


def _sorted_cloud(n, seed, tile=256, n_invalid=0):
    """A Morton-ordered sheet padded to whole tiles with sentinel rows (the
    fast path's layout), with ``n_invalid`` rows made sentinels."""
    pts = _sheet(n, seed)
    valid = np.ones(n, bool)
    valid[:n_invalid] = False
    pts = np.where(valid[:, None], pts, np.float32(2e6)).astype(np.float32)
    order = np.argsort(tknn.morton_codes_np(pts, valid), kind="stable")
    pad = (-n) % tile
    sp = np.concatenate([pts[order], np.full((pad, 3), 2e6, np.float32)])
    vs = np.concatenate([valid[order], np.zeros(pad, bool)])
    return sp, vs


@pytest.mark.parametrize("n", [5000, 600])
def test_band_ub_is_a_true_upper_bound(n):
    """The own-and-adjacent-tiles bound against JAX (rtol 5e-7) and against
    cKDTree's true k-th distance; 600 points (3 tiles) wrap around, and the
    tiny-cloud branch (< 3 tiles) is exact."""
    sp, vs = _sorted_cloud(n, 6, n_invalid=7)
    ub = tnormals._self_knn_band_ub(_t(sp), 5, 256).numpy()
    jub = np.asarray(jnormals._self_knn_band_ub(jnp.asarray(sp), 5, 256))
    np.testing.assert_allclose(ub, jub, rtol=5e-7, atol=1e-12)
    real = sp[vs].astype(np.float64)
    kth = cKDTree(real).query(real, k=5)[0][:, -1] ** 2
    assert np.all(ub[vs] >= kth * (1 - 1e-6) - 1e-9)
    tiny, tv = _sorted_cloud(400, 7)
    ub_t = tnormals._self_knn_band_ub(_t(tiny), 5, 256).numpy()
    real = tiny[tv].astype(np.float64)
    np.testing.assert_allclose(ub_t[tv], cKDTree(real).query(real, k=5)[0][:, -1] ** 2,
                               rtol=1e-5, atol=1e-9)


def test_gather_topk_masks_duplicate_pad_slots():
    """Candidate lists padded with repeats of tile 0 (and tile 0 also a real
    entry of some lists): the k rounds never pick one point twice; tiles
    grouped by their list lengths give the same answer as every tile at
    the JAX package's uniform width, bit for bit; both equal JAX's and
    cKDTree's neighbours except at ties."""
    sp, vs = _sorted_cloud(5000, 8)
    n_tiles = len(sp) // 256
    counts = np.array([1 + (t % 4) for t in range(n_tiles)])
    vlist = np.zeros((n_tiles, 8), np.int32)
    for t in range(n_tiles):
        near = sorted({t, (t + 1) % n_tiles, (t - 1) % n_tiles, 0}, key=lambda u: abs(u - t))
        row = sorted(near[:counts[t]])
        vlist[t, :len(row)] = row
        counts[t] = len(row)
    ti = tnormals._self_knn_gather_topk(_t(sp), _t(vlist), 5, 256, np.full(n_tiles, 8)).numpy()
    gi = tnormals._self_knn_gather_topk(_t(sp), _t(vlist), 5, 256, counts).numpy()
    np.testing.assert_array_equal(gi, ti)
    ji = np.asarray(jnormals._self_knn_gather_topk(jnp.asarray(sp), jnp.asarray(vlist), 5, 256, 8))
    assert all(len(set(r)) == 5 for r in ti)
    d = lambda idx: np.sum((sp[:, None, :].astype(np.float64) - sp[idx]) ** 2, -1)  # noqa: E731
    tol = 4 * 2.0 ** -24 * np.maximum(d(ti), d(ji)) + 1e-12
    assert np.all(np.abs(d(ti) - d(ji)) <= tol)
    # Within its candidate tiles, each row's k nearest (cKDTree over them);
    # slots past a list's length repeat tile 0, so tile 0 is a candidate of
    # every list shorter than its slots (all here).
    for t in (0, 5, n_tiles - 1):
        cand = np.concatenate([np.arange(u * 256, (u + 1) * 256)
                               for u in set(vlist[t, :counts[t]]) | {0}])
        rows = np.arange(t * 256, (t + 1) * 256)
        ref = cKDTree(sp[cand].astype(np.float64)).query(sp[rows].astype(np.float64), k=5)[0] ** 2
        np.testing.assert_allclose(d(ti)[rows], ref, rtol=1e-6, atol=1e-9)


def test_estimate_normals_knn_fast_matches_jax_and_ckdtree():
    """The fast path on 6,000 points with 40 invalid rows (sentinels whose
    bounds are dropped): the same neighbours as cKDTree (k = 5) but at
    exact ties, and normals as the module docstring states against JAX's
    fast path and a float64 PCA over cKDTree's neighbours."""
    pts = _sheet(6000, 9)
    valid = np.ones(6000, bool)
    valid[np.random.default_rng(10).choice(6000, 40, replace=False)] = False
    pts_in = np.where(valid[:, None], pts, np.nan).astype(np.float32)
    tn = tnormals.estimate_normals_knn_fast(pts_in, valid, device="cpu").numpy()
    jn = np.asarray(jnormals.estimate_normals_knn_fast(pts_in, valid))
    real = np.flatnonzero(valid)
    idx = np.zeros((6000, 5), np.int64)
    idx[real] = real[cKDTree(pts[real]).query(pts[real], k=5)[1]]
    _compare_normals(tn, jn, pts, idx, valid)
    # The search behind it: cKDTree's neighbours on every valid row (no
    # exact ties in this cloud), in ascending distance.
    fi = tnormals.self_knn_fast(pts_in, valid, device="cpu").numpy()
    np.testing.assert_array_equal(fi[valid], idx[valid])
    # The dense path agrees with the fast one on the rows where its
    # expansion-rounded neighbours are cKDTree's (elsewhere a near tie
    # within the expansion's rounding swapped the 5th neighbour).
    filled = _t(np.where(valid[:, None], pts, 2e6).astype(np.float32))
    dn = tnormals.estimate_normals_knn(filled, _t(valid)).numpy()
    di = tknn.knn_k(filled, filled, 5)[0].numpy()
    same = np.all(np.sort(di, 1) == np.sort(idx, 1), axis=1)
    _, gap = _pca64(pts, idx)
    ok = valid & (gap >= GAP_FLOOR) & same
    assert ok.sum() > 0.9 * valid.sum()
    assert np.all(np.abs(np.sum(dn * tn, 1))[ok] > 1 - 1e-4)


@pytest.mark.cuda
def test_fast_normals_on_card_match_cpu():
    """The fast path on the card against its own CPU run: the same
    neighbours (the distances are the same f32 operations), normals within
    the card's sqrt / acos / cos rounding (|cos| > 1 - 1e-5 off the
    degenerate rows, signs equal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pts = _sheet(20000, 11)
    valid = np.ones(20000, bool)
    valid[::501] = False
    gn = tnormals.estimate_normals_knn_fast(pts, valid, device="cuda").cpu().numpy()
    cn = tnormals.estimate_normals_knn_fast(pts, valid, device="cpu").numpy()
    np.testing.assert_array_equal(np.isnan(gn), np.isnan(cn))
    idx = cKDTree(pts).query(pts, k=5)[1]
    _, gap = _pca64(pts, idx)
    ok = valid & (gap >= GAP_FLOOR)
    cos = np.sum(gn * cn, 1)[ok]
    assert np.all(cos > 1 - 1e-5)
