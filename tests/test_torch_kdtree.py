"""The port's kd index, its three matching kernels' plain versions and the
kd matcher, held against the JAX package on the CPU (JAX's Pallas kernels
run in interpret mode) and against scipy's cKDTree.

Search results are compared on rows with ``d2 <= max_distance``; every
other row must be invalid on both sides (the JAX oracle maps d2 in
(bound, bound_val] to -1 while a radius-bounded search returns the row).

Tolerances: the port rounds every product and sum on its own (as do its
CUDA kernels, built without FMA contraction), and equals the JAX package's
eager ``_box_lb`` / ``_extract_min`` bit for bit. Inside ``jit`` (and in a
Pallas kernel's interpret mode) XLA:CPU fuses ``a*b + c`` and rounds once,
so bounds and distances from JAX's jitted functions may differ by one ulp
per fused add (two for a 3-term sum):
they are compared to 2 ulp, and indices may differ only where the two
candidates tie to within that rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn

torch.set_num_threads(2)


def _clouds(n_t=8000, n_q=600, seed=0):
    """Bench-style surface sheet target and noisy queries near it."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-8, 8, (n_t, 2))
    z = 0.5 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])
    t = np.column_stack([xy, z]).astype(np.float32)
    q = (t[rng.integers(0, n_t, n_q)] + rng.normal(0, 0.3, (n_q, 3))).astype(np.float32)
    return q, t


def _both_indexes(t, block_target=256):
    jidx = jkd.build_kd_index(t, block_target=block_target)
    return jidx, convert.kd_index_from_arrays(jidx, "cpu")


def _n(x):
    return np.asarray(x)


def _assert_ties(q, t, ia, ib):
    """Where the two index arrays differ, both points must lie at the same
    distance from the query to within f32 rounding (a few ulp)."""
    diff = np.flatnonzero(ia != ib)
    assert len(diff) <= max(2, len(ia) // 100), len(diff)
    if len(diff):
        qa = q[diff].astype(np.float64)
        da = ((qa - t[ia[diff]]) ** 2).sum(1)
        db = ((qa - t[ib[diff]]) ** 2).sum(1)
        np.testing.assert_allclose(da, db, rtol=4 * np.finfo(np.float32).eps)


def test_build_kd_index_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.uniform(-5, 5, (5000, 3)).astype(np.float32)
    t = np.concatenate([t, np.full((120, 3), 2.0e6, np.float32)])  # padded rows
    jidx = jkd.build_kd_index(t, block_target=200)
    tidx = tkd.build_kd_index(t, block_target=200, device="cpu")
    assert tuple(tidx.pages.shape) == jidx.pages.shape
    np.testing.assert_array_equal(tidx.block_min.numpy(), _n(jidx.block_min))
    np.testing.assert_array_equal(tidx.block_max.numpy(), _n(jidx.block_max))
    jo, to = _n(jidx.block_orig), tidx.block_orig.numpy()
    cap = jo.shape[1]
    for blk in range(jo.shape[0]):
        n_real = int((jo[blk] >= 0).sum())
        assert int((to[blk] >= 0).sum()) == n_real
        assert (to[blk, n_real:] == -1).all() and (jo[blk, n_real:] == -1).all()
        np.testing.assert_array_equal(np.sort(to[blk, :n_real]), np.sort(jo[blk, :n_real]))
        # pages hold the same points (coordinate columns), padded alike
        jp, tp = _n(jidx.pages)[blk], tidx.pages[blk].numpy()
        np.testing.assert_array_equal(tp[:, n_real:], jp[:, n_real:])
        jord, tord = np.argsort(jo[blk, :n_real]), np.argsort(to[blk, :n_real])
        np.testing.assert_array_equal(tp[:, :n_real][:, tord], jp[:, :n_real][:, jord])
        np.testing.assert_array_equal(
            np.sort(tidx.page_orig.numpy().reshape(jo.shape[0], -1)[blk]),
            np.sort(_n(jidx.page_orig).reshape(jo.shape[0], -1)[blk]))
    assert cap == to.shape[1]
    assert tkd.checks_to_k(16, tidx) == jkd.checks_to_k(16, jidx)
    assert tkd.kd_depth_for(365056) == jkd.kd_depth_for(365056)


def test_build_target_index_matches_jax():
    _, t = _clouds(n_t=3000, seed=2)
    jt = jknn.build_target_index(jnp.asarray(t), tile_t=jknn.V2_TILE_T)
    tt = tknn.build_target_index(torch.from_numpy(t), tile_t=tknn.V2_TILE_T)
    assert tt._fields == tuple(f for f in jt._fields if f != "norm2")
    for name in tt._fields:
        got, want = getattr(tt, name).numpy(), _n(getattr(jt, name))
        if name == "points_t3":
            # JAX's last feature row holds 0.5*|t|^2 for its expanded-distance
            # kernels; the port's pages hold the plain padded rows there.
            got, want = got[:, :-1], want[:, :-1]
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [4, 1])
def test_box_topk_plain_matches_jax_ranking(k):
    q, t = _clouds(seed=3)
    jidx, tidx = _both_indexes(t)
    jsel, jres = jkd._extract_min(jkd._box_lb(jnp.asarray(q), jidx.block_min, jidx.block_max), k)
    binit = torch.full((1, len(q)), float("inf"))
    tsel, tres = tkd.box_topk(torch.from_numpy(q)[None], binit,
                              tidx.block_min[None], tidx.block_max[None], k)
    np.testing.assert_array_equal(tsel[0].numpy(), _n(jsel))
    np.testing.assert_array_equal(tres[0].numpy(), _n(jres))


@pytest.mark.parametrize("k", [4, 1])
def test_box_topk_matches_prefix_kernel(k):
    """resid equals the TPU prefix kernel's (interpret mode), and the
    per-128-query-tile union of members equals its member rows."""
    q, t = _clouds(n_q=900, seed=4)
    jidx, tidx = _both_indexes(t)
    maxd = 1.0
    bound_val = tknn.bound_value(maxd)
    nq, tile_q = len(q), 128
    qp = np.zeros((1024, 8), np.float32)
    qp[:nq, :3] = q
    binit = np.full((1024,), -1.0, np.float32)
    binit[:nq] = bound_val
    member, _hot, _lbt, resid, _mask, _ranges = jkd._radius_prefix(
        jnp.asarray(qp), jnp.asarray(binit), jidx, tile_q=tile_q, k=k, interpret=True)
    tsel, tres = tkd.box_topk(
        torch.from_numpy(q)[None], torch.full((1, nq), bound_val),
        tidx.block_min[None], tidx.block_max[None], k)
    np.testing.assert_array_max_ulp(tres[0].numpy(), _n(resid)[:nq, 0], maxulp=2)
    sel = tsel[0].numpy()
    nc = tidx.block_min.shape[0]
    union = np.zeros((1024 // tile_q, nc), bool)
    for i in range(nq):
        union[i // tile_q, sel[i][sel[i] >= 0]] = True
    np.testing.assert_array_equal(union, _n(member))


@pytest.mark.parametrize("k", [4, 1])
def test_block_search_matches_nn_search_kd(k):
    q, t = _clouds(seed=5)
    jidx, tidx = _both_indexes(t)
    maxd = 0.5
    ji, jd, jf = (_n(x) for x in jkd.nn_search_kd(jnp.asarray(q), jidx, maxd, k=k))
    ti, td, tf = (x.numpy() for x in tkd.nn_search_kd(torch.from_numpy(q), tidx, maxd, k=k))
    np.testing.assert_array_max_ulp(td, jd, maxulp=2)
    both = (ti >= 0) & (ji >= 0)
    assert (ti >= 0).sum() - both.sum() <= 1 and (ji >= 0).sum() - both.sum() <= 1
    _assert_ties(q, t, ti[both], ji[both])
    assert (tf != jf).sum() <= 1
    assert both.mean() > 0.5


def test_block_search_k1_against_resident_kernel():
    """JAX's resident kernel (interpret mode) at k=1 may search gate-mates'
    blocks: its match is a real point at the reported distance, never worse
    than the port's per-query result, and found wherever the port finds one
    (the contract of tests/test_kdtree.py:761-785)."""
    rng = np.random.default_rng(32)
    t = rng.uniform(-10, 10, (8000, 3)).astype(np.float32)
    q = (t[rng.integers(0, 8000, 512)] + rng.normal(0, 0.3, (512, 3))).astype(np.float32)
    jidx = jkd.build_kd_index(t)
    tidx = convert.kd_index_from_arrays(jidx, "cpu")
    maxd = 4.0
    i_k, d2_k, _ = jkd.nn_search_kd_resident(jnp.asarray(q), jidx, maxd, k=1, interpret=True)
    i_p, d2_p, _ = tkd.nn_search_kd_resident(torch.from_numpy(q), tidx, maxd, k=1)
    i_k, d2_k, i_p, d2_p = _n(i_k), _n(d2_k), i_p.numpy(), d2_p.numpy()
    wp = (i_p >= 0) & (d2_p <= maxd)
    np.testing.assert_allclose(d2_p[wp], ((q[wp] - t[i_p[wp]]) ** 2).sum(1), rtol=1e-5, atol=1e-6)
    wk = (i_k >= 0) & (d2_k <= maxd)
    assert wk[wp].all()
    assert (d2_k[wp] <= d2_p[wp] * (1 + 1e-6) + 1e-7).all()
    assert (i_k[wp] == i_p[wp]).mean() > 0.9


def test_fallback_matches_visited_kernel_and_ckdtree():
    q, t = _clouds(n_q=700, seed=6)
    jt = jknn.build_target_index(jnp.asarray(t), tile_t=jknn.V2_TILE_T)
    tt = convert.target_index_from_arrays(jt, "cpu")
    maxd = 0.6
    bound_val = tknn.bound_value(maxd)
    rng = np.random.default_rng(7)
    radii = np.where(rng.random(len(q)) < 0.5, bound_val, -1.0).astype(np.float32)
    radii[::5] = 0.05
    ji, jd = jknn.nn_search_pruned_v2(
        jnp.asarray(q), jt, maxd, interpret=True, tile_t=jknn.V2_TILE_T,
        per_query_bound=jnp.asarray(radii), use_phase1=False)
    ti, td = tknn.nn_search_pruned_v2(torch.from_numpy(q), tt, maxd,
                                      per_query_bound=torch.from_numpy(radii))
    ji, jd, ti, td = _n(ji), _n(jd), ti.numpy(), td.numpy()
    np.testing.assert_array_max_ulp(td, jd, maxulp=2)
    found = (ti >= 0) & (ji >= 0)
    assert ((ti >= 0) != (ji >= 0)).sum() <= 1
    _assert_ties(q, t, ti[found], ji[found])
    dref, iref = cKDTree(t).query(q, k=1)
    d2ref = dref ** 2
    live = radii >= 0
    hit = live & (d2ref < radii * (1 - 1e-5))
    np.testing.assert_array_equal(ti[hit], iref[hit])
    np.testing.assert_allclose(td[hit], d2ref[hit], rtol=1e-5, atol=1e-6)
    miss = live & (d2ref > radii * (1 + 1e-5))
    assert (ti[miss] == -1).all() and (ti[~live] == -1).all()
    np.testing.assert_array_equal(td[~live], radii[~live])


@pytest.mark.parametrize("checks", [0, 16])
def test_match_kd_matches_jax(checks):
    q, t = _clouds(n_q=800, seed=8)
    jidx, tidx = _both_indexes(t, block_target=16)
    jt = jknn.build_target_index(jnp.asarray(t), tile_t=jknn.V2_TILE_T)
    tt = convert.target_index_from_arrays(jt, "cpu")
    maxd = 0.5
    mask = np.random.default_rng(9).random(len(q)) > 0.1
    ji, jd, jv = jkd.match_kd(jnp.asarray(q), jidx, jt, maxd, jnp.asarray(mask), checks=checks)
    ti, td, tv = tkd.match_kd(torch.from_numpy(q), tidx, tt, maxd, torch.from_numpy(mask),
                              checks=checks)
    ji, jd, jv, ti, td, tv = (_n(x) for x in (ji, jd, jv, ti, td, tv))
    if checks == 0:
        _, _, fail = tkd.nn_search_kd_resident(torch.from_numpy(q), tidx, maxd)
        assert fail.numpy().sum() > 0           # the fallback is exercised
        dref, iref = cKDTree(t).query(q, k=1)
        within = mask & (dref ** 2 <= maxd * (1 - 1e-5))
        np.testing.assert_array_equal(ti[within], iref[within])
    # Away from the threshold both sides agree on validity; where valid,
    # on the index and on d2 (JAX's CPU fallback expands
    # |q|^2+|t|^2-2q.t, good to ~|q|^2 * eps).
    clear = np.abs(td - maxd) > 1e-4
    np.testing.assert_array_equal(tv[clear], jv[clear])
    both = tv & jv
    _assert_ties(q, t, ti[both], ji[both])
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-5, atol=5e-5)
    assert both.mean() > 0.5


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; anything else
    must be a CUDA tensor or it raises (no silent fallback)."""
    q = torch.zeros((1, 4, 3), device="meta")
    binit = torch.zeros((1, 4), device="meta")
    box = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tkd.box_topk(q, binit, box, box, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tkd.kd_block_search(q, torch.zeros((1, 4, 2), dtype=torch.int32, device="meta"),
                            binit, torch.zeros((1, 8, 8, 128), device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build_all()


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card (the full-size
    check is chip_smoke.py's phase 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, t = _clouds(n_q=1000, seed=10)
    _, tidx = _both_indexes(t)
    dev = torch.device("cuda")
    qc = torch.from_numpy(q)[None].to(dev)
    kd = tkd.KDIndex(*(None if f is None else f[None].to(dev) for f in tidx))
    binit = torch.full((1, len(q)), tknn.bound_value(0.5), device=dev)
    for k in (4, 1):
        sel, resid = tkd.box_topk(qc, binit, kd.block_min, kd.block_max, k)
        sel_p, resid_p = tkd.box_topk_plain(qc, binit, kd.block_min, kd.block_max, k)
        assert torch.equal(sel, sel_p) and torch.equal(resid, resid_p)
        d2, idx = tkd.kd_block_search(qc, sel, binit, kd.pages)
        d2_p, idx_p = tkd.kd_block_search_plain(qc, sel, binit, kd.pages)
        assert torch.equal(d2, d2_p) and torch.equal(idx, idx_p)
    fi = tknn.build_target_index(torch.from_numpy(t)[None].to(dev))
    radius = binit.clone()
    radius[:, ::3] = -1.0
    assert all(torch.equal(a, b) for a, b in zip(
        tknn.visited_search(qc, radius, fi), tknn.visited_search_plain(qc, radius, fi)))
