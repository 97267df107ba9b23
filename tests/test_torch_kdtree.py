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

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.core import se3 as tse3
from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.ops import projective as tproj

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
    meta_idx = tkd.KDIndex(*(torch.zeros(s, device="meta") for s in (
        (1, 8, 3 * 100), (1, 8, 100), (1, 8, 3), (1, 8, 3), (1, 8, 8, 128), (1, 8 * 128))))
    with pytest.raises(ValueError, match="CUDA"):
        tkd.nn_search_kd_cached(q, meta_idx, 1.0, torch.zeros((1, 4), dtype=torch.int32,
                                                              device="meta"))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_wrappers_refuse_other_feature_dims(d):
    """The kernels are built for D = 3 and D = 6 only."""
    q = torch.zeros((1, 4, d), device="meta")
    binit = torch.zeros((1, 4), device="meta")
    box = torch.zeros((1, 8, d), device="meta")
    with pytest.raises(ValueError, match="D in"):
        tkd.box_topk(q, binit, box, box, 2)
    with pytest.raises(ValueError, match="D in"):
        tkd.kd_block_search(q, torch.zeros((1, 4, 2), dtype=torch.int32, device="meta"),
                            binit, torch.zeros((1, 8, 8, 128), device="meta"))
    with pytest.raises(ValueError, match="D in"):
        tknn.visited_search(q, binit, tknn.TargetIndex(*(torch.zeros(s, device="meta") for s in (
            (1, 1024, 8), (1, 1, 8, 1024), (1, 1024), (1, 1, 8), (1, 1, 8)))))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build_all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_kernels_match_plain_on_card(d):
    """Each CUDA kernel against its plain version on the card, at D = 3 and
    the colour features' D = 6, the cached block search with -1 rows, and
    at D = 3 the projective window search (the full-size checks are
    chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, t = _clouds(n_q=1000, seed=10)
    if d == 6:
        rng = np.random.default_rng(11)
        t = np.concatenate([t, rng.uniform(0, 1, (len(t), 3)).astype(np.float32)], axis=1)
        q = np.concatenate([q, rng.uniform(0, 1, (len(q), 3)).astype(np.float32)], axis=1)
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
    blk = sel[..., 0].clone()
    blk[:, ::5] = -1
    assert all(torch.equal(a, b) for a, b in zip(
        tkd.nn_search_kd_cached(qc, kd, 0.5, blk), tkd.nn_search_kd_cached_oracle(qc, kd, 0.5, blk)))
    fi = tknn.build_target_index(torch.from_numpy(t)[None].to(dev))
    radius = binit.clone()
    radius[:, ::3] = -1.0
    assert all(torch.equal(a, b) for a, b in zip(
        tknn.visited_search(qc, radius, fi), tknn.visited_search_plain(qc, radius, fi)))
    if d == 3:
        # The projective window search on a 96 x 64 image seen from 2 m,
        # queries near it and off its edges.
        w_img, h_img = 96, 64
        rng = np.random.default_rng(12)
        vv, uu = np.meshgrid(np.arange(h_img), np.arange(w_img), indexing="ij")
        z = 2.0 + 0.1 * np.sin(uu / 7.0) * np.cos(vv / 5.0)
        img = np.stack([(uu - 47.5) / 80.0 * z, (vv - 31.5) / 80.0 * z, z], -1)
        img = torch.from_numpy(img.reshape(1, -1, 3).astype(np.float32)).to(dev)
        ok = torch.from_numpy(rng.random((1, w_img * h_img)) > 0.1).to(dev)
        pq = (img[:, rng.integers(0, w_img * h_img, 1000)]
              + torch.from_numpy(rng.normal(0, 0.3, (1, 1000, 3)).astype(np.float32)).to(dev))
        pix = tproj.project_pixels(pq, 80.0, 80.0, 47.5, 31.5)
        kw = dict(width=w_img, height=h_img, window=12)
        got = tproj.projective_window_search(pq, pix, img, ok, **kw)
        want = tproj.projective_match_plain(pq, pix, img, ok, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert bool((got[0] >= 0).any()) and bool((got[0] < 0).any())


def _tie_boxes(d, seed):
    """Two pairs of integer boxes (every bound exact in f32): pair 0 with
    repeated boxes (equal bounds), empty boxes (+inf bounds) and one box
    whose square overflows to +inf; pair 1 with only two finite boxes, so
    that k > 2 reaches argmin's all-+inf rounds."""
    rng = np.random.default_rng(seed)
    nc = 24
    lo = rng.integers(-4, 3, (2, nc, d)).astype(np.float32)
    hi = lo + rng.integers(0, 3, (2, nc, d)).astype(np.float32)
    lo[0, 10:14], hi[0, 10:14] = lo[0, 0:4], hi[0, 0:4]
    lo[0, 2::5], hi[0, 2::5] = np.inf, -np.inf
    lo[0, 7, 0] = hi[0, 7, 0] = 3.0e38
    lo[1, :], hi[1, :] = np.inf, -np.inf
    lo[1, 0], hi[1, 0] = lo[0, 0], hi[0, 0]
    lo[1, 9], hi[1, 9] = lo[0, 1], hi[0, 1]
    q = rng.integers(-5, 6, (2, 300, d)).astype(np.float32)
    return q, lo, hi


@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_box_topk_plain_matches_jax_on_ties_and_inf_bounds(d, k):
    """box_topk_plain's picks and residual are JAX's eager box ranking
    (``_box_lb`` + ``_extract_min``) on equal and +inf bounds, including
    argmin's rounds over all-+inf rows (block 0 again); sel is -1 exactly
    where the pick's bound exceeds binit."""
    q, lo, hi = _tie_boxes(d, seed=40 + d + k)
    rng = np.random.default_rng(k)
    binit = rng.choice([np.inf, 3.0, 0.0, -1.0], q.shape[:2]).astype(np.float32)
    tsel, tres = tkd.box_topk(*(torch.from_numpy(a) for a in (q, binit, lo, hi)), k)
    for b in range(2):
        lb = jkd._box_lb(jnp.asarray(q[b]), jnp.asarray(lo[b]), jnp.asarray(hi[b]))
        jsel, jres = (_n(x) for x in jkd._extract_min(lb, k))
        member = np.take_along_axis(_n(lb), jsel, axis=1) <= binit[b][:, None]
        np.testing.assert_array_equal(tsel[b].numpy(), np.where(member, jsel, -1))
        np.testing.assert_array_equal(tres[b].numpy(), jres)
        assert np.isinf(_n(lb)).any()
    if k > 2:
        assert (jsel[:, 2:] == 0).all()  # pair 1: the all-+inf rounds pick block 0


def _tie_cloud(d, n_valid, capacity, seed):
    """An integer-valued target cloud (every distance exact in f32, so JAX's
    jitted sums equal the port's) with repeated points, padded to
    ``capacity`` rows."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-6, 7, (n_valid, d)).astype(np.float32)
    t[n_valid // 2:n_valid // 2 + n_valid // 8] = t[:n_valid // 8]
    pad = np.full((capacity - n_valid, d), 2.0e6, np.float32)
    q = rng.integers(-7, 8, (400, d)).astype(np.float32)
    return q, np.concatenate([t, pad])


@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("k", [1, 4])
def test_block_search_plain_matches_nn_search_kd_on_ties(d, k):
    """kd_block_search_plain (through the port's nn_search_kd) equals JAX's
    nn_search_kd exactly on integer clouds: ties across picks and within a
    block go to the earliest pick, then the lowest slot; on a cloud with
    two points in 16 blocks, k = 4 repeats block 0 (duplicate picks)."""
    for n_valid, capacity, target, maxd, seed in ((2000, 2048, 128, 30.0, 50),
                                                  (2, 64, 4, 1000.0, 51)):
        q, t = _tie_cloud(d, n_valid, capacity, seed + d + k)
        jidx, tidx = _both_indexes(t, block_target=target)
        ji, jd, jf = (_n(x) for x in jkd.nn_search_kd(jnp.asarray(q), jidx, maxd, k=k))
        ti, td, tf = (x.numpy() for x in tkd.nn_search_kd(torch.from_numpy(q), tidx, maxd, k=k))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tf, jf)
        sel, _ = tkd.box_topk(torch.from_numpy(q)[None], torch.full((1, len(q)), np.inf),
                              tidx.block_min[None], tidx.block_max[None], k)
        if n_valid == 2 and k == 4:
            assert (sel[0, :, 2:] == 0).all()
        assert (ti >= 0).mean() > 0.5


def _card_tie_inputs(d, k, seed):
    """Integer pages and queries on the card (exact distances, many ties),
    B = 3 pairs of N = 3,001 rows (not a multiple of 32 or 128) over 9
    blocks of 256 slots: picks with repeats, ids past nc - 1, rows of all
    -1, every query picking block 2 first in pair 2 (a bucket past one
    chunk), and starting bounds inf, 2 (equal to many distances), 0 and -1."""
    rng = np.random.default_rng(seed)
    b, n, nc, cap_pad = 3, 3001, 9, 256
    pages = rng.integers(-3, 4, (b, nc, 8, cap_pad)).astype(np.float32)
    pages[:, :, 1, 7] = pages[:, :, 1, 3]
    q = rng.integers(-3, 4, (b, n, d)).astype(np.float32)
    sel = rng.integers(-1, nc + 3, (b, n, k)).astype(np.int32)
    sel[:, ::17] = -1
    if k > 1:
        sel[:, 1::5, 1] = sel[:, 1::5, 0]
    sel[2, :, 0] = 2
    binit = rng.choice([np.inf, 2.0, 6.0, 0.0, -1.0], (b, n)).astype(np.float32)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(a).to(dev) for a in (q, sel, binit, pages))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_block_search_contract_on_card(d, k):
    """The block-major kd_block_search equals its plain version (on the
    picks clipped to nc - 1) on ties across picks and within a block,
    repeated and clipped picks, all -1 rows, d2 == binit, one bucket far
    past a chunk (and buckets whose last chunk is short, so its slots split
    over several threads each), and N not a multiple of 32 or 128; probe = 1
    gives (binit, -1) on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, sel, binit, pages = _card_tie_inputs(d, k, seed=60 + d + k)
    nc = pages.shape[1]
    want = tkd.kd_block_search_plain(q, sel.clamp(max=nc - 1), binit, pages)
    assert bool((want[1] >= 0).any()) and bool((want[1] < 0).any())
    got = tkd.kd_block_search(q, sel, binit, pages)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    pd2, pidx = tkd.kd_block_search(q, sel, binit, pages, probe=1)
    torch.cuda.synchronize()
    assert torch.equal(pd2, binit) and bool((pidx == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_block_search_lane_counts_on_card(d):
    """The lane-counting measurement build of kd_block_search gives the
    production result, uncounted, and shares of active lanes in (0, 1]: the
    spatial steps, and the colour-term steps at D = 6 only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from icp_variants_tpu_torch.ops import _cuda
    from icp_variants_tpu_torch.scripts import resident_bench

    q, sel, binit, pages = _card_tie_inputs(d, 4, seed=80 + d)
    before = _cuda.LAUNCHES["kd_block_search"]
    r = resident_bench.lane_use(q, sel.clamp(max=pages.shape[1] - 1), binit, pages)
    assert _cuda.LAUNCHES["kd_block_search"] == before + 1  # the production comparison only
    assert r["equal"] and r["spatial_steps"] > 0 and 0.0 < r["spatial"] <= 1.0
    if d == 6:
        assert r["colour_steps"] > 0 and 0.0 < r["colour"] <= 1.0
    else:
        assert r["colour"] is None and r["colour_steps"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_box_topk_contract_on_card(d):
    """The one-pass box_topk equals its plain version on equal bounds, +inf
    bounds (empty boxes, overflowing squares) and all-+inf rounds, for
    k = 1, 2, 3, 4, 5, 9 and 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, lo, hi = _tie_boxes(d, seed=70 + d)
    rng = np.random.default_rng(71)
    binit = rng.choice([np.inf, 3.0, 0.0, -1.0], q.shape[:2]).astype(np.float32)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (q, binit, lo, hi)]
    for k in (1, 2, 3, 4, 5, 9, 16):
        got = tkd.box_topk(*args, k)
        want = tkd.box_topk_plain(*args, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k


# ---------------------------------------------------------------------------
# The kernels' C entries, and the seeded search (cached_block_search) on the
# block-major machinery at k = 1
# ---------------------------------------------------------------------------


def _c_params(src: str, fn: str) -> list[str]:
    """The parameter types of ``extern "C" int fn(...)`` in ``csrc/<src>``."""
    text = (_cuda.CSRC / src).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"{fn} not in {src}"
    return [re.sub(r"\s*\b\w+$", "", p.strip()).replace("const ", "")
            for p in m.group(1).split(",")]


def _ctype_of(c_type: str):
    if c_type.endswith("*"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "double": ctypes.c_double}[c_type]


@pytest.mark.parametrize("name", sorted(_cuda.KERNELS))
def test_ctypes_table_matches_c_entries(name):
    """Each kernel's ctypes argument list is its C entry's, type for type
    (a pointer as c_void_p, so that ctypes does not cut it to 32 bits)."""
    src, fn, argtypes = _cuda.KERNELS[name]
    assert [_ctype_of(t) for t in _c_params(src, fn)] == argtypes


@pytest.mark.parametrize("with_pose", [False, True])
def test_cached_search_launch_takes_a_k1_workspace(monkeypatch, with_pose):
    """On a CUDA tensor nn_search_kd_cached launches its kernel once with
    block_major.cuh's workspace at k = 1, the common bound, and arguments
    matching the C entry's types (launch and checks replaced, meta tensors)."""
    calls = []
    monkeypatch.setattr(_cuda, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    b, n, nc, cap, cap_pad, d = 2, 37, 8, 100, 128, 6
    q = torch.zeros((b, n, d), device="meta")
    index = tkd.KDIndex(*(torch.zeros(s, device="meta") for s in (
        (b, nc, d * cap), (b, nc, cap), (b, nc, d), (b, nc, d), (b, nc, 8, cap_pad),
        (b, nc * cap_pad))))
    blk = torch.zeros((b, n), dtype=torch.int32, device="meta")
    tkd.nn_search_kd_cached(q, index, 0.5, blk, pose=torch.eye(4) if with_pose else None)
    (name, args), = calls
    assert name == "cached_block_search"
    argtypes = _cuda.KERNELS[name][2]
    assert len(args) + 1 == len(argtypes)  # the stream is appended at launch
    for a, t in zip(args, argtypes):
        if a is None or isinstance(a, torch.Tensor):
            assert t is ctypes.c_void_p
        elif isinstance(a, float):
            assert t is ctypes.c_float
        else:
            assert t in (ctypes.c_int, ctypes.c_longlong), (a, t)
    pose, bound, ws, ws_bytes = args[2], args[3], args[7], args[8]
    assert (pose is None) != with_pose and (pose is None or pose.shape == (b, 4, 4))
    assert bound == tknn.bound_value(0.5)
    assert ws_bytes == ws.numel() == tkd._block_search_workspace_bytes(b, n, nc, 1)
    assert ws_bytes < tkd._block_search_workspace_bytes(b, n, nc, 4)
    assert args[9:] == (b, n, nc, cap_pad, d)


def _at_squared_distance(target: np.float32) -> tuple[np.float32, np.float32]:
    """f32 (a, c) with fl(fl(a * a) + fl(c * c)) == target exactly."""
    a = np.float32(np.sqrt(target / 2))
    for _ in range(4096):
        c0 = np.float32(np.sqrt(np.float64(target) - np.float64(np.float32(a * a))))
        for c in (c0, np.nextafter(c0, np.float32(0)), np.nextafter(c0, np.float32(np.inf))):
            if np.float32(np.float32(a * a) + np.float32(c * c)) == target:
                return a, c
        a = np.nextafter(a, np.float32(0))
    raise AssertionError(f"no f32 pair at squared distance {target}")


def _cached_contract_inputs(d, with_pose, seed):
    """Integer pages on the card, B = 3 pairs of N = 3,001 rows (not a
    multiple of 32 or 128) over 9 blocks of 256 slots, and the seeded
    blocks: ids of -1, below -1 and past nc - 1; the rows of block 2 of
    pair 2 far past one chunk; rows 100-119 of pair 0 at the origin seeded
    with block 8, whose only near point lies at exactly the bound (a
    miss), the rest far. With a pose (pairs 0 and 1 a signed permutation
    and an integer translation, so the moved queries are the same integers;
    pair 2 a general rotation) the queries are raw, moved back through the
    pose. Returns (queries, index, blk, pose, max_distance)."""
    rng = np.random.default_rng(seed)
    b, n, nc, cap = 3, 3001, 9, 256
    maxd = 2.0
    pages = np.zeros((b, nc, 8, cap), np.float32)
    pages[:, :, :d] = rng.integers(-3, 4, (b, nc, d, cap))
    q = rng.integers(-3, 4, (b, n, d)).astype(np.float32)
    blk = rng.integers(-1, nc + 3, (b, n)).astype(np.int32)
    blk[:, ::17] = -1
    blk[:, 5::17] = -7
    blk[2, 200:1800] = 2
    a, c = _at_squared_distance(np.float32(tknn.bound_value(maxd)))
    pages[0, 8, :d] = 9.0
    pages[0, 8, :d, 5] = 0.0
    pages[0, 8, 0, 5], pages[0, 8, 1, 5] = a, c
    q[0, 100:120] = 0.0
    blk[0, 100:120] = 8
    pose = None
    raw = q
    if with_pose:
        pose = np.zeros((b, 4, 4), np.float32)
        pose[:, 3, 3] = 1.0
        pose[0, :3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
        pose[0, :3, 3] = [2, -1, 3]
        pose[1, :3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
        pose[1, :3, 3] = [-3, 0, 1]
        t = 0.3
        pose[2, :3, :3] = [[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]]
        pose[2, :3, 3] = [0.25, -0.5, 0.125]
        raw = q.copy()
        for i in (0, 1):
            R, tr = pose[i, :3, :3], pose[i, :3, 3]
            raw[i, :, :3] = (q[i, :, :3] - tr) @ R  # R^T (q - t), exact
    dev = torch.device("cuda")
    pg = torch.from_numpy(pages).to(dev)
    index = tkd.KDIndex(
        pg[:, :, :d].reshape(b, nc, d * cap).contiguous(),
        torch.zeros((b, nc, cap), dtype=torch.int32, device=dev),
        torch.zeros((b, nc, d), device=dev), torch.zeros((b, nc, d), device=dev), pg,
        torch.zeros((b, nc * cap), dtype=torch.int32, device=dev))
    to = lambda x: None if x is None else torch.from_numpy(x).to(dev)  # noqa: E731
    return to(raw), index, to(blk), to(pose), maxd


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("with_pose", [False, True])
def test_cached_block_search_contract_on_card(d, with_pose):
    """The block-major cached_block_search equals its plain version bit for
    bit, with and without a pose, on inputs that hold each hard case (and
    the test asserts that they do): -1 rows (and ids below -1), ids past
    nc - 1 (clipped), a bucket far past one chunk, rows whose least d2
    equals the bound exactly (a miss: (bound, -1)), and rows whose least d2
    lies at two slots or more (the lowest slot wins)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    queries, index, blk, pose, maxd = _cached_contract_inputs(d, with_pose, 90 + d)
    moved = queries if pose is None else torch.cat(
        [tse3.transform_points(queries[..., :3], pose), queries[..., 3:]], dim=-1)
    nc = index.pages.shape[1]
    bound = np.float32(tknn.bound_value(maxd))
    got = tkd.nn_search_kd_cached(queries, index, maxd, blk, pose=pose)
    want = tkd.nn_search_kd_cached_oracle(queries, index, maxd, blk, pose=pose)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ids, d2 = want
    assert bool((blk == -1).any()) and bool((blk < -1).any()) and bool((blk > nc - 1).any())
    assert bool((ids[blk < 0] == -1).all()) and bool((d2[blk < 0] == float(bound)).all())
    # The planted rows: least d2 == the bound, so a miss.
    cand = index.pages[0, 8, :d]                                    # (d, cap)
    least = ((cand[None] - moved[0, 100:120, :, None]) ** 2).sum(1).min(-1).values
    assert bool((least == float(bound)).all())
    assert bool((ids[0, 100:120] == -1).all()) and bool((d2[0, 100:120] == float(bound)).all())
    # Ties: rows with a hit whose least d2 lies at two slots or more.
    bi = torch.arange(3, device=blk.device)[:, None]
    pts = index.pages[bi, blk.clamp(0, nc - 1).long(), :d]          # (B, N, d, cap)
    dd = None
    for j in range(d):
        diff = pts[:, :, j] - moved[..., j, None]
        dd = diff * diff if dd is None else dd + diff * diff
    at_min = (dd == dd.min(-1, keepdim=True).values).sum(-1)
    tied = (ids >= 0) & (at_min >= 2)
    assert int(tied.sum()) > 0
    slot = ids % index.pages.shape[-1]
    first = (dd == dd.min(-1, keepdim=True).values).int().argmax(-1)
    assert bool((slot[tied] == first[tied]).all())


# ---------------------------------------------------------------------------
# The visited search's merge and prune: ties across tiles, distances equal
# to a radius, sparse live rows, and the kernel's contract on the card
# ---------------------------------------------------------------------------


def _lattice_targets(d, n, seed):
    """Integer targets (every distance and bound exact in f32) in clumps of
    3 x 3 x 3 lattice cells at spacing 3, ordered clump by clump so that a
    1,024-row tile covers a few clumps, with repeated points within and
    across tiles; at d = 6 three colour features in {0, 1} follow."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 64, n)
    c.sort()
    centres = np.stack([(c % 4) * 3, (c // 4 % 4) * 3, (c // 16) * 3], 1)
    t = centres + rng.integers(0, 3, (n, 3))
    if d == 6:
        t = np.concatenate([t, rng.integers(0, 2, (n, 3))], 1)
    return t.astype(np.float32)


def _lattice_queries(d, n, seed, lo=-1, hi=12):
    rng = np.random.default_rng(seed)
    q = rng.integers(lo, hi, (n, d)).astype(np.float32)
    if d == 6:
        q[:, 3:] = rng.integers(0, 2, (n, 3))
    return q


@pytest.mark.parametrize("d", [3, 6])
def test_visited_search_plain_matches_visited_kernel_on_ties(d):
    """visited_search_plain (through the port's nn_search_pruned_v2) equals
    JAX's nn_search_pruned_v2 (per_query_bound, use_phase1=False, its
    visited kernel in interpret mode) exactly on integer clouds: exact ties
    across tiles go to the lowest row, a nearest point at exactly the
    radius is no match; with one live row per 128-row query tile, and on
    an all-frozen call. The result is also numpy's brute force."""
    t = _lattice_targets(d, 6000, seed=110 + d)
    q = _lattice_queries(d, 512, seed=111 + d)
    jt = jknn.build_target_index(jnp.asarray(t), tile_t=jknn.V2_TILE_T)
    tt = convert.target_index_from_arrays(jt, "cpu")
    rng = np.random.default_rng(112 + d)
    d2all = ((t[None].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    nn = d2all.min(1)
    cases = {
        "mixed": rng.choice([1.0, 2.0, 5.0, 30.0, 0.0, -1.0], len(q)).astype(np.float32),
        "one_live_per_tile": np.full(len(q), -1.0, np.float32),
        "frozen": np.full(len(q), -1.0, np.float32),
    }
    mixed = cases["mixed"]
    mixed[::9] = np.where(nn[::9] > 0, nn[::9], 1.0)      # nearest point at exactly the radius
    cases["one_live_per_tile"][5::128] = 30.0
    for name, radius in cases.items():
        ji, jd = (_n(x) for x in jknn.nn_search_pruned_v2(
            jnp.asarray(q), jt, 1.0, interpret=True, tile_t=jknn.V2_TILE_T,
            per_query_bound=jnp.asarray(radius), use_phase1=False))
        ti, td = (x.numpy() for x in tknn.nn_search_pruned_v2(
            torch.from_numpy(q), tt, 1.0, per_query_bound=torch.from_numpy(radius)))
        np.testing.assert_array_equal(td, jd, err_msg=name)
        np.testing.assert_array_equal(ti, ji, err_msg=name)
        ok = d2all < radius[:, None]
        want_i = np.where(ok.any(1), np.argmin(np.where(ok, d2all, np.inf), 1), -1)
        want_d = np.where(want_i >= 0, d2all[np.arange(len(q)), np.maximum(want_i, 0)], radius)
        np.testing.assert_array_equal(ti, want_i, err_msg=name)
        np.testing.assert_array_equal(td, want_d.astype(np.float32), err_msg=name)
        if name == "mixed":
            tiles_tied = [len(set(np.flatnonzero(d2all[i] == nn[i]) // jknn.V2_TILE_T))
                          for i in range(len(q))]
            assert (np.array(tiles_tied) > 1).sum() > 10       # ties across tiles
            assert ((ti < 0) & (radius > 0) & (nn == radius)).sum() > 10
        if name == "frozen":
            assert (ti == -1).all() and np.array_equal(td, radius)


@pytest.mark.parametrize("b,n,n_tiles,tile_t", [
    (4, 1_000_192, 977, 1024), (16, 4352, 357, 1024), (3, 4097, 1, 4)])
def test_visited_search_workspace_bytes(b, n, n_tiles, tile_t):
    """The wrapper's scratch size is the kernel's: per-pair live counts,
    16-byte aligned, then a live-row list per pair."""
    assert tknn._visited_search_workspace_bytes(b, n, n_tiles, tile_t) == (
        -(-4 * b // 16) * 16 + 4 * b * n)


def test_visited_search_workspace_bytes_refuses():
    """Tilings the kernel does not take are refused before any launch."""
    ws = tknn._visited_search_workspace_bytes
    with pytest.raises(ValueError, match="multiple of 4"):
        ws(1, 8, 4, 1022)
    with pytest.raises(ValueError, match="multiple of 4"):
        ws(1, 8, 0, 1024)
    with pytest.raises(ValueError, match="at most"):
        ws(1, 8, tknn.VISITED_MAX_TILES + 1, 4)
    with pytest.raises(ValueError, match="at most"):
        ws(1, 8, 2**21, 1024)


def _visited_contract_inputs(d, n_t, seed, dev="cuda"):
    """On ``dev``: B = 3 pairs of N = 4,097 query rows against n_t integer
    targets each (tiles of 1,024 rows; the last tile padded), the queries
    reaching 3 cells past the cloud on every side (so many answers lie on
    a tile's box at its bound). Pair 0: radii
    1, 2, 5, 30, 0 and -1, every 9th row's radius its exact nearest
    distance; pair 1 all frozen; pair 2 one live row among 4,096 frozen."""
    b, n = 3, 4097
    t = np.stack([_lattice_targets(d, n_t, seed + i) for i in range(b)])
    q = np.stack([_lattice_queries(d, n, seed + 10 + i, -3, 15) for i in range(b)])
    rng = np.random.default_rng(seed + 20)
    radius = rng.choice([1.0, 2.0, 5.0, 30.0, 0.0, -1.0], (b, n)).astype(np.float32)
    nn = ((t[0][None].astype(np.float64) - q[0][::9, None]) ** 2).sum(-1).min(1)
    radius[0, ::9] = np.where(nn > 0, nn, 1.0)
    radius[1] = -1.0
    radius[2] = -1.0
    radius[2, 3001] = 30.0
    dev = torch.device(dev)
    fi = tknn.build_target_index(torch.from_numpy(t).to(dev), tile_t=tknn.V2_TILE_T)
    return torch.from_numpy(q).to(dev), torch.from_numpy(radius).to(dev), fi


def _visited_prune_ties(q, fi, want):
    """Pair 0's rows whose answer lies in a tile whose box bound equals the
    answer's d2, while a tile of smaller bound (walked before it, and at
    higher indices) holds a point at that d2 too. Once that tile is walked
    the row's best equals the answer's tile's bound: an exact walk must not
    stop there (a stop on bound >= best would)."""
    d = q.shape[-1]
    d2, idx = (x[0].cpu().numpy() for x in want)
    tmin, tmax = (x[0, :, :d].cpu().numpy() for x in (fi.bbox_min, fi.bbox_max))
    pts = fi.points_t3[0, :, :d].cpu().numpy()                      # (n_tiles, d, tile_t)
    tile_t = pts.shape[-1]
    qn = q[0].cpu().numpy()
    gap = np.maximum(np.maximum(tmin[None] - qn[:, None], qn[:, None] - tmax[None]), 0)
    lb = (gap * gap).sum(-1)                                        # exact on integers
    rows = np.flatnonzero(idx >= 0)
    rows = rows[lb[rows, idx[rows] // tile_t] == d2[rows]]
    count = 0
    for r in rows:
        before = np.flatnonzero(lb[r] < d2[r])
        dd = ((pts[before] - qn[r][None, :, None]) ** 2).sum(1)      # (m, tile_t)
        count += bool((dd == d2[r]).any())
    return count


@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("n_t", [6000, 40000])
def test_visited_contract_inputs_hold_prune_ties(d, n_t):
    """The card contract test's inputs (built here on the CPU) hold rows
    whose answer lies in a tile whose bound equals the best after an
    earlier-walked tile (see _visited_prune_ties)."""
    q, radius, fi = _visited_contract_inputs(d, n_t, seed=120 + d, dev="cpu")
    want = tknn.visited_search_plain(q, radius, fi)
    assert _visited_prune_ties(q, fi, want) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_visited_search_contract_on_card(d):
    """The compacted, pruned visited_search equals its plain version on
    exact ties across tiles, nearest distances equal to the radius, tiles
    whose bound equals a row's best (rows that hold a tie there are
    asserted present), all-frozen pairs, one live row among 4,096 frozen
    ones, 6 and 40 tiles (fewer and more than a warp's lanes), and B = 3
    with N not a multiple of any launch width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n_t in (6000, 40000):
        q, radius, fi = _visited_contract_inputs(d, n_t, seed=120 + d)
        want = tknn.visited_search_plain(q, radius, fi)
        got = tknn.visited_search(q, radius, fi)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), n_t
        assert bool((want[1][0] >= 0).any()) and bool((want[1][0] < 0).any())
        assert bool((want[1][1] < 0).all()) and int((want[1][2] >= 0).sum()) == 1
        assert _visited_prune_ties(q, fi, want) > 0, n_t
