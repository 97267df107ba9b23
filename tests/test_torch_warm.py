"""The port's warm-start kd matching against the JAX package on the CPU:
the warm rule and the resident rule, the radius search
(``knn.kd_radius_search_plain``, the plain version of the CUDA kernel that
replaces TPU kernel 5) against JAX's bitmap kernel in interpret mode, the
warm searches and ``match_kd_warm`` on both routes (within the resident
rule, and with ``RESIDENT_VMEM_BUDGET`` made small in both packages), the
granule cache, and the exact arm of dense registration end to end (ETH-style
pairs through ``run_icp_batch``, the colour tracker through the segmented
driver).

Tolerances (see tests/test_torch_kdtree.py): the port rounds every product
and sum on its own; inside ``jit`` and in Pallas interpret mode XLA:CPU
fuses ``a*b + c``, so distances, bounds and certificate residuals from JAX
are compared to 2 ulp at D = 3 and to 4 ulp at D = 6 (a 6-term sum has five
adds that may fuse; 3 ulp was read), and indices may differ only where the
two candidates tie within that rounding. Runs: per-iteration match counts equal, RMSE
within rtol 1e-4 (atol 1e-5), poses within atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import bench
from icp_variants_tpu.core import cloud as jcloud
from icp_variants_tpu.data import rgbd as jrgbd
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu.runtime import native as jnative
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.runtime import native as tnative

torch.set_num_threads(2)

MAXD = 1.0


def _n(x):
    return np.asarray(x)


def _sheet(n_t, n_q, seed, d=3):
    """Bench-style surface sheet target and noisy queries near it; with
    d = 6 three colour-like features in [0, 1] follow the coordinates."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-8, 8, (n_t, 2))
    t = np.column_stack([xy, 0.5 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])])
    rows = rng.integers(0, n_t, n_q)
    q = t[rows] + rng.normal(0, 0.3, (n_q, 3))
    if d == 6:
        tc = rng.uniform(0, 1, (n_t, 3))
        t = np.concatenate([t, tc], axis=1)
        q = np.concatenate([q, tc[rows] + rng.normal(0, 0.1, (n_q, 3))], axis=1)
    return q.astype(np.float32), t.astype(np.float32)


def _cached_radii(q, t, seed):
    """Radii the warm path makes: the one-step slack over the exact distance
    to a real target point near the query (a neighbour of its NN, as a
    granule-mate's match would be), a third of rows cache-less (the bound),
    every seventh row frozen (-1)."""
    rng = np.random.default_rng(seed)
    _, nbr = cKDTree(t).query(q, k=4)
    pick = nbr[np.arange(len(q)), rng.integers(0, 4, len(q))]
    cached = ((q - t[pick]) ** 2).sum(1).astype(np.float32)
    bound = tknn.bound_value(MAXD)
    r = np.minimum(cached * np.float32(1 + 1e-6) + np.float32(1e-30), np.float32(bound))
    r[rng.random(len(q)) < 0.33] = bound
    r[::7] = -1.0
    return r.astype(np.float32)


def _ulp(d):
    """Distance tolerance against jitted JAX at D features (see above)."""
    return 2 if d == 3 else 4


def _assert_ties(q, tpts, ia, ib):
    """Where two (original-row) index arrays differ, both points lie at the
    same distance from the query to within f32 rounding."""
    diff = np.flatnonzero(ia != ib)
    assert len(diff) <= max(2, len(ia) // 100), len(diff)
    if len(diff):
        qa = q[diff].astype(np.float64)
        da = ((qa - tpts[ia[diff]]) ** 2).sum(1)
        db = ((qa - tpts[ib[diff]]) ** 2).sum(1)
        np.testing.assert_allclose(da, db, rtol=4 * np.finfo(np.float32).eps)


@pytest.fixture(scope="module", params=[3, 6], ids=["d3", "d6"])
def sheet(request):
    """~8,000 targets, 512 queries, 32 kd blocks; both packages' indexes."""
    d = request.param
    q, t = _sheet(8000, 512, seed=20 + d, d=d)
    jidx = jkd.build_kd_index(t, block_target=256)
    return dict(d=d, q=q, t=t, jidx=jidx, tidx=convert.kd_index_from_arrays(jidx, "cpu"),
                radius=_cached_radii(q, t, seed=30 + d))


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(kd_warm_start=False), dict(matching_checks=16),
    dict(selection="RANDOM"), dict(selection="RANDOM_FAST"), dict(color_icp=True),
    dict(multi_resolution=True), dict(matching="PROJECTIVE"),
])
def test_warm_applies_matches_jax(kw):
    def cfg(mod):
        args = dict(kw)
        for key, enum in (("selection", mod.Selection), ("matching", mod.Matching)):
            if key in args:
                args[key] = getattr(enum, args[key])
        return mod.ICPConfig(**args)

    assert ticp._warm_applies(cfg(tconfig)) == jicp._warm_applies(cfg(jconfig))


@pytest.mark.parametrize("n_points,d,budget", [
    (365_056, 3, None), (600_000, 3, None), (1_000_000, 3, None),
    (365_056, 6, None), (600_000, 6, None), (1_000_000, 6, None),
    (365_056, 3, 6 * 2**20), (600_000, 3, 40 * 2**20), (1_000_000, 3, 40 * 2**20),
])
def test_resident_layout_matches_jax(monkeypatch, n_points, d, budget):
    """(packed, fits) equal to the JAX rule's for tables computed from
    shapes: 128 x 2,944 (unpacked), 256 x 2,432 (packed at d = 3), 512 x
    2,048 (past both at d = 3), at the real budget and at others."""
    if budget is not None:
        monkeypatch.setattr(jknn, "RESIDENT_VMEM_BUDGET", budget)
        monkeypatch.setattr(tknn, "RESIDENT_VMEM_BUDGET", budget)
    nc = 1 << tkd.kd_depth_for(n_points)
    cap_pad = (-(-n_points // nc) + 127) // 128 * 128
    packed_shape = ((nc + 1) // 2, 8, cap_pad) if d <= 3 else None
    jfields = dict(pages=(nc, 8, cap_pad), block_min=(nc, d), pages_packed=packed_shape)
    jidx = jkd.KDIndex(*(
        None if jfields.get(f, ()) is None else jax.ShapeDtypeStruct(jfields.get(f, (1,)), jnp.float32)
        for f in jkd.KDIndex._fields))
    tidx = tkd.KDIndex(*(
        None if jfields.get(f, ()) is None else torch.empty(jfields.get(f, (1,)), device="meta")
        for f in tkd.KDIndex._fields))
    _, packed, fits = jkd._resident_layout(jidx)
    assert tkd._resident_layout(tidx) == (packed, fits)
    if budget is None:
        assert (packed, fits) == {365_056: (False, True), 600_000: (d <= 3, d <= 3),
                                  1_000_000: (False, False)}[n_points]


# ---------------------------------------------------------------------------
# The radius search (TPU kernel 5's counterpart) and the warm searches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 4])
def test_kd_radius_search_plain_matches_bitmap_kernel(sheet, k):
    """kd_radius_search_plain (with box_topk's picks at k = 4) against JAX's
    _kd_bitmap_search on its bitmap kernel in interpret mode, at cached-match
    radii with frozen and cache-less rows. k = 0 compares every live row;
    k = 4 the rows whose certificate closes, and resid."""
    q, tidx, radius = sheet["q"], sheet["tidx"], sheet["radius"]
    ji, jd, jres = (_n(x) for x in jkd._kd_bitmap_search(
        jnp.asarray(q), sheet["jidx"], MAXD, jnp.asarray(radius), k=k, impl="bitmap",
        interpret=True, orig_map=False))
    qt = torch.from_numpy(q)[None]
    binit = torch.clamp(torch.from_numpy(radius), max=tknn.bound_value(MAXD))[None]
    bmin, bmax = tidx.block_min[None], tidx.block_max[None]
    sel = None
    if k:
        sel, tres = tkd.box_topk(qt, binit, bmin, bmax, k)
        np.testing.assert_array_max_ulp(tres[0].numpy(), jres, maxulp=_ulp(sheet["d"]))
    td, ti = (x[0].numpy() for x in tknn.kd_radius_search_plain(
        qt, binit, bmin, bmax, tidx.pages[None], sel))
    frozen = radius < 0
    np.testing.assert_array_equal(ti[frozen], -1)
    np.testing.assert_array_equal(td[frozen], radius[frozen])
    rows = ~frozen
    if k:
        fail = jres <= np.minimum(jd, np.float32(MAXD)) * np.float32(1 + 1e-6)
        rows &= ~fail
        assert fail.sum() < 0.2 * len(q)
    np.testing.assert_array_max_ulp(td[rows], jd[rows], maxulp=_ulp(sheet["d"]))
    # Page-domain indices: where they differ, both pages hold points at tied
    # distances from the query.
    page_pts = tidx.pages.numpy()[:, :sheet["d"]].transpose(0, 2, 1).reshape(-1, sheet["d"])
    both = rows & (ti >= 0) & (ji >= 0)
    assert ((ti >= 0) != (ji >= 0))[rows].sum() <= 1
    _assert_ties(q, page_pts, ti[both], ji[both])
    assert both.mean() > 0.4


@pytest.mark.parametrize("budget", ["resident", "small"])
def test_nn_search_kd_radius_and_warm_match_jax(sheet, monkeypatch, budget):
    """nn_search_kd_radius and nn_search_kd_warm against the JAX package's
    (interpret mode; its resident kernel within the rule, its bitmap kernel
    past it) and against cKDTree."""
    if budget == "small":
        monkeypatch.setattr(jknn, "RESIDENT_VMEM_BUDGET", 1024)
        monkeypatch.setattr(tknn, "RESIDENT_VMEM_BUDGET", 1024)
    q, t, radius = sheet["q"], sheet["t"], sheet["radius"]
    assert tkd._resident_layout(sheet["tidx"])[1] == (budget == "resident")
    dref, iref = cKDTree(t).query(q, k=1)
    d2ref = dref ** 2
    live = radius >= 0
    ji, jd = (_n(x) for x in jkd.nn_search_kd_radius(
        jnp.asarray(q), sheet["jidx"], MAXD, jnp.asarray(radius), interpret=True))
    ti, td = (x.numpy() for x in tkd.nn_search_kd_radius(
        torch.from_numpy(q), sheet["tidx"], MAXD, torch.from_numpy(radius)))
    np.testing.assert_array_max_ulp(td, jd, maxulp=_ulp(sheet["d"]))
    found = (ti >= 0) & (ji >= 0)
    assert ((ti >= 0) != (ji >= 0)).sum() <= 1
    _assert_ties(q, t, ti[found], ji[found])
    hit = live & (d2ref < np.minimum(radius, MAXD) * (1 - 1e-5))
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(ti[hit] == iref[hit], True)
    np.testing.assert_allclose(td[hit], d2ref[hit], rtol=1e-5, atol=1e-6)
    assert (ti[~live] == -1).all()

    ji, jd, jf = (_n(x) for x in jkd.nn_search_kd_warm(
        jnp.asarray(q), sheet["jidx"], MAXD, jnp.asarray(radius), k=2, interpret=True))
    ti, td, tf = (x.numpy() for x in tkd.nn_search_kd_warm(
        torch.from_numpy(q), sheet["tidx"], MAXD, torch.from_numpy(radius), k=2))
    # JAX's kernels may also search gate-mates' blocks, so rows whose
    # certificate fails can differ; where it closes both are exact.
    assert (tf != jf).sum() <= 1 and tf.sum() > 0
    ok = ~tf & ~jf
    np.testing.assert_array_max_ulp(td[ok], jd[ok], maxulp=_ulp(sheet["d"]))
    found = ok & (ti >= 0) & (ji >= 0)
    _assert_ties(q, t, ti[found], ji[found])
    hit = ok & live & (d2ref < np.minimum(radius, MAXD) * (1 - 1e-5))
    np.testing.assert_allclose(td[hit], d2ref[hit], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# match_kd_warm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def iterated():
    """15,000 targets and 1,024 queries (tests/test_kdtree.py's warm
    fixture), both packages' kd and tile indexes."""
    q0, t = _sheet(15000, 1024, seed=9)
    jidx = jkd.build_kd_index(t)
    jt = jknn.build_target_index(jnp.asarray(t), tile_t=jknn.V2_TILE_T)
    return dict(q0=q0, t=t, jidx=jidx, jt=jt, tidx=convert.kd_index_from_arrays(jidx, "cpu"),
                tt=convert.target_index_from_arrays(jt, "cpu"))


@pytest.mark.parametrize("budget", ["resident", "small"])
def test_match_kd_warm_iterated_matches_jax(iterated, monkeypatch, budget):
    """Three iterated calls with the cache carried from each into the next,
    masked and cache-less rows (mirrors tests/test_kdtree.py:552-583):
    JAX's kernel path (interpret mode; resident kernel, or bitmap kernel
    with the budget made small in both packages) against the port's plain
    routes, and both against cKDTree."""
    if budget == "small":
        monkeypatch.setattr(jknn, "RESIDENT_VMEM_BUDGET", 1024)
        monkeypatch.setattr(tknn, "RESIDENT_VMEM_BUDGET", 1024)
    rng = np.random.default_rng(9)
    q0, t = iterated["q0"], iterated["t"]
    tree = cKDTree(t)
    maxd = 4.0
    cache = np.full(len(q0), -1, np.int32)
    mask = rng.random(len(q0)) > 0.1
    for it in range(3):
        q = (q0 + 0.04 * (2 - it) * rng.normal(0, 1, q0.shape)).astype(np.float32)
        ji, jd, jv = (_n(x) for x in jkd.match_kd_warm(
            jnp.asarray(q), iterated["jidx"], maxd, jnp.asarray(cache), jnp.asarray(t),
            query_mask=jnp.asarray(mask), fallback_index=iterated["jt"], impl="v2",
            interpret=True))
        ti, td, tv = (x.numpy() for x in tkd.match_kd_warm(
            torch.from_numpy(q), iterated["tidx"], maxd, torch.from_numpy(cache),
            torch.from_numpy(t), torch.from_numpy(mask), fallback_index=iterated["tt"]))
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_max_ulp(td[tv], jd[tv], maxulp=2)
        _assert_ties(q, t, ti[tv], ji[tv])
        dref, iref = tree.query(q, k=1)
        w = mask & (dref ** 2 <= maxd)
        np.testing.assert_array_equal(tv, w)
        assert ((ti[w] == iref[w]) | np.isclose(td[w], dref[w] ** 2, rtol=1e-5, atol=1e-6)).all()
        assert (cache >= 0).any() or it == 0
        cache = np.where(tv, ti, cache).astype(np.int32)


@pytest.mark.parametrize("checks", [0, 16])
def test_match_kd_warm_oracle_and_cacheless_rows_match_jax(iterated, checks):
    """impl="oracle" against the JAX package's portable CPU oracle
    (impl="xla") on both arms, and the search routes against it: without a
    fallback (k = 0) on the exact arm, top-k within the radii on the
    approximate arm; a cache that points at the true neighbours for half
    the rows. The approximate search accepts a point within the radius'
    one-step slack where the oracle keeps the cached match, so there d2
    agrees to 2e-6 and indices need not."""
    q, t = iterated["q0"], iterated["t"]
    maxd = 4.0
    _, iref = cKDTree(t).query(q, k=1)
    cache = np.where(np.arange(len(q)) % 2 == 0, iref, -1).astype(np.int32)
    mask = np.arange(len(q)) % 11 != 0
    ji, jd, jv = (_n(x) for x in jkd.match_kd_warm(
        jnp.asarray(q), iterated["jidx"], maxd, jnp.asarray(cache), jnp.asarray(t),
        query_mask=jnp.asarray(mask), checks=checks, impl="xla"))
    for impl, k in (("oracle", None), ("search", 0 if checks == 0 else None)):
        ti, td, tv = (x.numpy() for x in tkd.match_kd_warm(
            torch.from_numpy(q), iterated["tidx"], maxd, torch.from_numpy(cache),
            torch.from_numpy(t), torch.from_numpy(mask), k=k, checks=checks, impl=impl))
        np.testing.assert_array_equal(tv, jv)
        if impl == "search" and checks:
            np.testing.assert_allclose(td[tv], jd[tv], rtol=2e-6)
            assert (ti[tv] == ji[tv]).mean() > 0.99
            continue
        np.testing.assert_array_max_ulp(td[tv], jd[tv], maxulp=2)
        _assert_ties(q, t, ti[tv], ji[tv])
    with pytest.raises(ValueError, match="impl"):
        tkd.match_kd_warm(torch.from_numpy(q), iterated["tidx"], maxd, torch.from_numpy(cache),
                          torch.from_numpy(t), impl="v2")


@pytest.mark.parametrize("budget", ["resident", "small"])
def test_match_kd_warm_exact_cache_hit(monkeypatch, budget):
    """Queries exactly at their cached match (radius 0 plus the slack): the
    backstop keeps the cached match (mirrors tests/test_kdtree.py:585-600),
    on both routes."""
    if budget == "small":
        monkeypatch.setattr(tknn, "RESIDENT_VMEM_BUDGET", 1024)
    rng = np.random.default_rng(10)
    t = rng.normal(0, 1, (5000, 3)).astype(np.float32)
    tidx = tkd.build_kd_index(t, device="cpu")
    tt = tknn.build_target_index(torch.from_numpy(t))
    rows = rng.integers(0, 5000, 256)
    for fallback in (tt, None):
        _, d2, valid = tkd.match_kd_warm(
            torch.from_numpy(t[rows]), tidx, 1.0, torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(t), fallback_index=fallback)
        assert bool(valid.all()) and float(d2.max()) < 1e-10


def test_granule_update_matches_jax_scatter():
    """The port's rule (each slot takes its granule's last valid match)
    against the JAX package's ``cache.at[granules].set(idx, mode="drop")``
    with invalid rows sent out of range, on the CPU."""
    rng = np.random.default_rng(5)
    for n, g in ((1000, 128), (257, 4), (64, 1)):
        cache = rng.integers(-1, 50, -(-n // g)).astype(np.int32)
        idx = rng.integers(-1, 5000, (2, n)).astype(np.int32)
        valid = rng.random((2, n)) < 0.3
        valid[:, : 2 * g] = False              # granules with no valid row
        for b in range(2):
            granules = np.arange(n) // g
            want = jnp.asarray(cache).at[jnp.where(valid[b], granules, len(cache))].set(
                jnp.asarray(idx[b]), mode="drop")
            got = ticp._granule_update(torch.from_numpy(cache)[None], torch.from_numpy(idx[b])[None],
                                       torch.from_numpy(valid[b])[None], g)
            np.testing.assert_array_equal(got[0].numpy(), _n(want))


def test_granule_cache_after_one_iteration_matches_jax(iterated):
    """Both packages' matching stages on one dense iteration with a warm
    cache: the new caches agree (equal but at tied matches)."""
    q, t = iterated["q0"], iterated["t"]
    jcfg = jconfig.ICPConfig(max_distance=4.0, kd_warm_granule=8)
    tcfg = tconfig.ICPConfig(max_distance=4.0, kd_warm_granule=8)
    mask = np.arange(len(q)) % 13 != 0
    cache = np.full(-(-len(q) // 8), -1, np.int32)
    cache[::3] = np.arange(len(cache))[::3] * 7
    ji, _, jv, jc = (_n(x) for x in jicp._match_kd_stage(
        jcfg, jnp.asarray(q), iterated["jidx"], iterated["jt"], jnp.asarray(mask), None,
        jnp.asarray(cache), jnp.asarray(t)))
    ti, _, tv, tc = (x[0].numpy() for x in ticp._match_kd_stage(
        tcfg, torch.from_numpy(q)[None], tkd.stack_kd_indexes([iterated["tidx"]]),
        tknn.TargetIndex(*(f[None] for f in iterated["tt"])), torch.from_numpy(mask)[None],
        torch.from_numpy(cache)[None], False, torch.from_numpy(t)[None]))
    np.testing.assert_array_equal(tv, jv)
    assert (tc >= 0).mean() > 0.9 and (tc != cache).any()
    differ = tc != jc
    last = np.array([np.flatnonzero(tv[s * 8:(s + 1) * 8])[-1] + s * 8 for s in np.flatnonzero(differ)],
                    dtype=np.int64)
    _assert_ties(q, t, ti[last], ji[last])


# ---------------------------------------------------------------------------
# Dense exact registration end to end
# ---------------------------------------------------------------------------

N_DENSE, N_ITER = 16_384, 8


@pytest.fixture(scope="module")
def dense():
    """Two ETH-style pairs (``bench.synth_cloud``) moved by
    ``bench.eth_true_pose``, kd indexes of 128 blocks built directly, and
    the JAX package's dense exact run on them (its CPU driver takes the
    portable warm oracle)."""
    pairs = []
    for i in range(2):
        tp, tn = bench.synth_cloud(N_DENSE, 2 * i + 1)
        T = bench.eth_true_pose(i)
        pairs.append(((tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32),
                      (tn @ T[:3, :3].T).astype(np.float32), tp, tn))
    js = jicp.stack_clouds([jcloud.from_numpy(p[0], normals=p[1], morton_order=True) for p in pairs])
    jt_list = [jcloud.from_numpy(p[2], normals=p[3], morton_order=True) for p in pairs]
    jt = jicp.stack_clouds(jt_list)
    jkds = jkd.stack_kd_indexes([
        jkd.build_kd_index(np.asarray(t.points), np.asarray(t.valid), block_target=128)
        for t in jt_list])
    gts, gtt = np.stack([p[0] for p in pairs]), np.stack([p[2] for p in pairs])
    jcfg, _ = _dense_cfgs()
    jr = jicp.run_icp_batch(jcfg, js, jt, key=jax.random.PRNGKey(0), kd_indexes=jkds,
                            gt_source_points=gts, gt_target_points=gtt)
    return dict(jr=jr, jcfg=jcfg, ts=convert.cloud_from_arrays(js, "cpu"),
                tt=convert.cloud_from_arrays(jt, "cpu"),
                tkds=convert.kd_index_from_arrays(jkds, "cpu"), gts=gts, gtt=gtt)


def _dense_cfgs(**kw):
    common = dict(n_iterations=N_ITER, max_distance=10.0, **kw)
    return (jconfig.ICPConfig(metric=jconfig.Metric.SYMMETRIC,
                              minimizer=jconfig.Minimizer.LINEAR, **common),
            tconfig.ICPConfig(metric=tconfig.Metric.SYMMETRIC,
                              minimizer=tconfig.Minimizer.LINEAR, **common))


@pytest.mark.parametrize("budget", ["resident", "small"])
def test_dense_exact_run_matches_jax(dense, monkeypatch, budget):
    """JAX run_icp_batch against the port's warm run on its plain routes, within the resident
    rule and past it (budget made small: box_topk + kd_radius_search); the
    port's warm run equals its cold one, and ``match_blocks`` is None."""
    _, tcfg = _dense_cfgs()
    jr = dense["jr"]
    assert jicp._warm_applies(dense["jcfg"]) and ticp._warm_applies(tcfg)
    if budget == "small":
        monkeypatch.setattr(tknn, "RESIDENT_VMEM_BUDGET", 1024)
    routes = []
    real = tknn.kd_radius_search
    monkeypatch.setattr(tknn, "kd_radius_search",
                        lambda *a, **kw: routes.append(1) or real(*a, **kw))
    run = dict(kd_indexes=dense["tkds"], gt_source_points=dense["gts"],
               gt_target_points=dense["gtt"], device="cpu")
    tr = ticp.run_icp_batch(tcfg, dense["ts"], dense["tt"], **run)
    assert len(routes) == (N_ITER if budget == "small" else 0)
    assert tr.match_blocks is None
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), _n(jr.trace.num_matches))
    np.testing.assert_allclose(tr.trace.rmse.numpy(), _n(jr.trace.rmse), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.pose.numpy(), _n(jr.pose), atol=1e-4)
    cold = ticp.run_icp_batch(tcfg.replace(kd_warm_start=False), dense["ts"], dense["tt"], **run)
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), cold.trace.num_matches.numpy())
    np.testing.assert_allclose(tr.pose.numpy(), cold.pose.numpy(), rtol=1e-4, atol=1e-5)
    assert float(tr.trace.rmse[:, -1].max()) < 1e-3


CW, CH = 64, 48


def _depth_frame(i):
    """``bench.synth_depth_frame`` at CW x CH (see tests/test_torch_color.py)."""
    fx = 525.0 * CW / 640
    cx, cy = (CW - 1) / 2, (CH - 1) / 2
    vv, uu = np.meshgrid(np.arange(CH), np.arange(CW), indexing="ij")
    z = np.full((CH, CW), 2.0)
    boxes = [(-0.6, -0.3, 0.35, 0.25, 0.5), (0.4, 0.2, 0.3, 0.3, 0.35),
             (0.1, -0.5, 0.2, 0.2, 0.25)]
    for _ in range(8):
        xw = (uu - cx) / fx * z - 0.01 * i
        yw = (vv - cy) / fx * z
        base = 2.0 + 0.12 * np.sin(3.0 * xw) * np.cos(3.0 * yw)
        for (bx, by, w, h, dz) in boxes:
            base = np.where((np.abs(xw - bx) < w) & (np.abs(yw - by) < h), base - dz, base)
        z = base
    xw = (uu - cx) / fx * z - 0.01 * i
    yw = (vv - cy) / fx * z
    color = np.stack([(127 + 120 * np.sin(5.0 * xw)).astype(np.uint8),
                      (127 + 120 * np.cos(4.0 * yw)).astype(np.uint8),
                      (127 + 120 * np.sin(3.0 * (xw + yw))).astype(np.uint8),
                      np.full((CH, CW), 255, np.uint8)], axis=-1)
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)
    return z.astype(np.float32), color, K


def test_colour_segmented_exact_arm_matches_jax(monkeypatch):
    """The colour tracker's exact arm at 64 x 48 through the segmented
    driver: warm in both packages (every segment's run_icp_batch carries a
    warm cache), equal per-iteration match counts, poses within 1e-4; the
    port's warm run equals its cold run."""
    eye = np.eye(4, dtype=np.float32)
    frames = [_depth_frame(i) for i in range(3)]
    srcs = [jrgbd.cloud_from_depth(z, c, K, eye, keep_original_size=True, capacity=CW * CH,
                                   color_morton_order=True) for z, c, K in frames[1:]]
    tgt = jrgbd.cloud_from_depth(*frames[0], eye, keep_original_size=False, capacity=CW * CH)
    js, jt = jicp.stack_clouds(srcs), jicp.stack_clouds([tgt] * 2)
    common = dict(n_iterations=8, max_distance=0.1, color_icp=True, multi_resolution=True,
                  kd_block_target=128)
    jcfg = jconfig.ICPConfig(metric=jconfig.Metric.POINT_TO_PLANE,
                             minimizer=jconfig.Minimizer.LINEAR, **common)
    tcfg = tconfig.ICPConfig(metric=tconfig.Metric.POINT_TO_PLANE,
                             minimizer=tconfig.Minimizer.LINEAR, **common)
    jkds = jkd.stack_kd_indexes([jicp.build_kd_for(jcfg, tgt, min_points=0)] * 2)
    jr = jicp.run_icp_batch_multires_segmented(jcfg, js, jt, key=jax.random.PRNGKey(1),
                                               num_source_points=CW * CH, kd_indexes=jkds)
    calls = []
    real = tkd.match_kd_warm
    monkeypatch.setattr(tkd, "match_kd_warm", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    run = dict(num_source_points=CW * CH, kd_indexes=convert.kd_index_from_arrays(jkds, "cpu"),
               device="cpu")
    ts, tt = convert.cloud_from_arrays(js, "cpu"), convert.cloud_from_arrays(jt, "cpu")
    tr = ticp.run_icp_batch_multires_segmented(tcfg, ts, tt, **run)
    assert len(calls) == tr.trace.num_matches.shape[1] == 8
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), _n(jr.trace.num_matches))
    np.testing.assert_allclose(tr.pose.numpy(), _n(jr.pose), atol=1e-4)
    assert tr.match_blocks is None and (tr.pose[:, 0, 3] < 0).all()
    cold = ticp.run_icp_batch_multires_segmented(tcfg.replace(kd_warm_start=False), ts, tt, **run)
    assert len(calls) == 8
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), cold.trace.num_matches.numpy())
    np.testing.assert_allclose(tr.pose.numpy(), cold.pose.numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The wrapper and the card
# ---------------------------------------------------------------------------


def test_kd_radius_search_wrapper_refuses():
    """Anything but a CPU tensor must be a CUDA tensor (no silent fallback);
    the kernel takes D = 3 or 6 and at most KD_RADIUS_MAX_BLOCKS blocks."""
    def args(d, nc):
        return (torch.zeros((1, 4, d), device="meta"), torch.zeros((1, 4), device="meta"),
                torch.zeros((1, nc, d), device="meta"), torch.zeros((1, nc, d), device="meta"),
                torch.zeros((1, nc, 8, 128), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tknn.kd_radius_search(*args(3, 8))
    with pytest.raises(ValueError, match="D in"):
        tknn.kd_radius_search(*args(4, 8))
    with pytest.raises(ValueError, match="at most"):
        tknn.kd_radius_search(*args(3, tknn.KD_RADIUS_MAX_BLOCKS + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_kd_radius_search_matches_plain_on_card(d):
    """The CUDA kernel against its plain version on the card at k = 0 and
    k = 4, cached-match radii with frozen and cache-less rows, and with
    nc = 1,024 blocks (the full-size checks are chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for n_t, bt in ((8000, 256), (40000, 40)):
        q, t = _sheet(n_t, 2000, seed=40 + d, d=d)
        kd = tkd.build_kd_index(t, block_target=bt, device=dev)
        kd = tkd.KDIndex(*(None if f is None else f[None] for f in kd))
        qc = torch.from_numpy(q)[None].to(dev)
        r = torch.clamp(torch.from_numpy(_cached_radii(q, t, seed=50 + d)),
                        max=tknn.bound_value(MAXD))[None].to(dev)
        for k in (0, 4):
            sel = tkd.box_topk(qc, r, kd.block_min, kd.block_max, k)[0] if k else None
            got = tknn.kd_radius_search(qc, r, kd.block_min, kd.block_max, kd.pages, sel)
            want = tknn.kd_radius_search_plain(qc, r, kd.block_min, kd.block_max, kd.pages, sel)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (n_t, k)
            assert torch.equal(got[1], want[1]), (n_t, k)
            assert bool((got[1] >= 0).any()) and bool((got[1] < 0).any())


# ---------------------------------------------------------------------------
# The radius search's merge and prune: ties, bounds equal to a radius or a
# best, and the kernel's contract on the card
# ---------------------------------------------------------------------------


def _grid_cloud(d, n_blocks, per, seed):
    """Integer points (every distance and bound exact in f32, so JAX's
    fused sums equal the port's and ties are exact) in clumps of 3 x 3 x 3
    lattice cells at spacing 3, repeated points within and across clumps;
    at d = 6 three colour features in {0, 1} follow."""
    rng = np.random.default_rng(seed)
    c = np.arange(n_blocks)
    centres = np.stack([(c % 4) * 3, (c // 4 % 4) * 3, (c // 16) * 3], 1)
    pts = (centres[:, None, :] + rng.integers(0, 3, (n_blocks, per, 3))).reshape(-1, 3)
    if d == 6:
        pts = np.concatenate([pts, rng.integers(0, 2, (len(pts), 3))], 1)
    return pts.astype(np.float32)


def _grid_queries(d, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, 11, (n, d)).astype(np.float32)
    if d == 6:
        q[:, 3:] = rng.integers(0, 2, (n, 3))
    return q


def _radius_reference(q, radius, bmin, bmax, pages, members):
    """numpy: per row, the least d2 strictly below the radius over the
    points of its member blocks (``members`` (N, nc) bool), the lowest page
    index among equals; (radius, -1) where none. Also the number of member
    points at that d2 and whether the lowest-index one lies in a block that
    is not the row's first member."""
    d, cap_pad = q.shape[1], pages.shape[-1]
    pts = pages[:, :d].transpose(0, 2, 1).reshape(-1, d)            # (nc * cap_pad, d)
    d2 = None
    for j in range(d):
        diff = pts[None, :, j] - q[:, None, j]
        d2 = diff * diff if d2 is None else d2 + diff * diff          # f32, exact on integers
    ok = np.repeat(members, cap_pad, axis=1) & (d2 < radius[:, None])
    d2 = np.where(ok, d2, np.inf)
    idx = np.argmin(d2, axis=1)
    best = d2[np.arange(len(q)), idx]
    found = np.isfinite(best)
    n_tied = (d2 == best[:, None]).sum(1) * found
    return (np.where(found, best, radius).astype(np.float32),
            np.where(found, idx, -1).astype(np.int32), n_tied)


@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("k", [0, 4])
def test_kd_radius_search_plain_ties_match_bitmap_kernel(d, k, monkeypatch):
    """On integer clouds, kd_radius_search_plain equals JAX's bitmap route
    (_kd_bitmap_search in interpret mode) in d2 on every row, and wherever
    the two indices differ both points lie at that d2; the plain version's
    index is the lowest page index among the member points at the least d2
    strictly below the radius (a numpy brute force), with exact ties where
    a later pick holds the lower index, rows whose nearest point lies at
    exactly the radius (no match), and picks whose bound equals the
    radius (members).

    The tied cases' presence depends on the kd partition's order within
    blocks, so JAX's build is pinned to its native route at D = 3 (the
    port's route; the library built from the same ``native/icpio.cpp``):
    otherwise it takes numpy's wherever its own library failed to load."""
    monkeypatch.setattr(jnative, "kd_partition", tnative.kd_partition)
    maxd = 100.0
    t = _grid_cloud(d, 8, 600, seed=90 + d)
    q = _grid_queries(d, 400, seed=91 + d)
    jidx = jkd.build_kd_index(t, block_target=256)
    tidx = convert.kd_index_from_arrays(jidx, "cpu")
    qt = torch.from_numpy(q)[None]
    bmin, bmax = tidx.block_min[None], tidx.block_max[None]
    lb = tknn.box_lb(qt, bmin, bmax)[0].numpy()
    rng = np.random.default_rng(92 + d + k)
    radius = rng.choice([1.0, 2.0, 5.0, 9.0, -1.0], len(q)).astype(np.float32)
    # Every sixth row: the radius equal to the bound of its second-nearest block.
    second = np.sort(lb, axis=1)[:, 1]
    rows_eq = np.arange(0, len(q), 6)
    radius[rows_eq] = np.where(second[rows_eq] > 0, second[rows_eq], radius[rows_eq])
    ji, jd, _ = (_n(x) for x in jkd._kd_bitmap_search(
        jnp.asarray(q), jidx, maxd, jnp.asarray(radius), k=k, impl="bitmap", interpret=True,
        orig_map=False))
    binit = torch.clamp(torch.from_numpy(radius), max=tknn.bound_value(maxd))[None]
    sel = tkd.box_topk(qt, binit, bmin, bmax, k)[0] if k else None
    td, ti = (x[0].numpy() for x in tknn.kd_radius_search_plain(
        qt, binit, bmin, bmax, tidx.pages[None], sel))
    np.testing.assert_array_equal(td, jd)
    pts = tidx.pages.numpy()[:, :d].transpose(0, 2, 1).reshape(-1, d)
    diff = np.flatnonzero(ti != ji)
    assert ((ti >= 0) == (ji >= 0)).all()
    for idx in (ti[diff], ji[diff]):
        np.testing.assert_array_equal(((pts[idx] - q[diff]) ** 2).sum(1), td[diff])

    nc = lb.shape[1]
    r = binit[0].numpy()
    if k:
        s = sel[0].numpy()
        members = np.zeros((len(q), nc), bool)
        for p in range(k):
            ok = s[:, p] >= 0
            members[np.flatnonzero(ok), s[ok, p]] = True
    else:
        members = lb <= r[:, None]
    rd, ri, n_tied = _radius_reference(q, r, *(x[0].numpy() for x in (bmin, bmax)),
                                       tidx.pages.numpy(), members)
    np.testing.assert_array_equal(td, rd)
    np.testing.assert_array_equal(ti, ri)
    # The cases the kernel's merge and prune must keep are in the data.
    if k:
        later = (ti >= 0) & (ti // tidx.pages.shape[-1] != s[:, 0]) & (n_tied > 1)
        assert later.sum() > 0
    at_radius = (ti < 0) & (r > 0) & members.any(1)
    pd = np.where(np.repeat(members, tidx.pages.shape[-1], axis=1),
                  ((pts[None] - q[:, None]) ** 2).sum(-1), np.inf).min(1)
    assert (at_radius & (pd == r)).sum() > 0
    assert ((lb == r[:, None]) & members).any(1).sum() > 0
    assert (n_tied > 1).sum() > 10


def _midpoint_ties(t, tidx, n_max=400):
    """Queries at the midpoint of two integer target points in different kd
    blocks that are its only nearest points (an exact f32 tie), kept where
    the two blocks' box bounds differ, so that the first ``box_topk`` pick
    may hold either point."""
    po = tidx.page_orig.numpy()
    page = np.empty(len(t), np.int64)
    page[po[po >= 0]] = np.flatnonzero(po >= 0)
    blk = page // tidx.pages.shape[-1]
    bmin, bmax = tidx.block_min.numpy(), tidx.block_max.numpy()
    tree = cKDTree(t)
    _, nbr = tree.query(t, k=4)
    out = []
    for a in range(len(t)):
        for b in nbr[a, 1:]:
            m = (t[a] + t[b]) / 2
            if blk[a] == blk[b] or len(out) >= n_max:
                continue
            d, _ = tree.query(m, k=3)
            lb = [float((np.maximum(np.maximum(bmin[k] - m, m - bmax[k]), 0) ** 2).sum())
                  for k in (blk[a], blk[b])]
            if d[0] == d[1] < d[2] and lb[0] != lb[1]:
                out.append(m)
    return np.unique(np.array(out, np.float32), axis=0)


@pytest.mark.parametrize("data,parts", [("grid", "jax"), ("midpoints", "port")])
def test_warm_and_cold_part_only_on_exact_ties(data, parts, monkeypatch):
    """Why the dense warm and cold runs may part (``chip_smoke.py`` phase 6
    gates it row by row on the card), in both packages: fed the cold
    matches as its cache (the previous iteration at the same pose), the
    warm matcher past the resident rule agrees with the cold one in
    validity and d2 on every row, and takes another point only on exact
    ties. The cold matcher takes a tie in its earliest ``box_topk`` pick,
    the port's warm one (kd_radius_search) at the lowest page index, and
    JAX's bitmap kernel by its own rule, so the two packages part on
    different tied rows: JAX's on the integer grid's ties, the port's on
    midpoints of two points in different blocks. Across the packages
    validity and d2 are equal, indices equal or tied. JAX's kd build is
    pinned to its native route, as in the test above."""
    monkeypatch.setattr(jnative, "kd_partition", tnative.kd_partition)
    maxd = 100.0
    if data == "grid":
        t = _grid_cloud(3, 8, 600, seed=93)
        q = _grid_queries(3, 400, seed=94)
    else:
        rng = np.random.default_rng(95)
        t = np.unique(rng.integers(0, 48, (6000, 3)), axis=0)
        t = t[rng.permutation(len(t))][:4096].astype(np.float32)
    jidx = jkd.build_kd_index(t, block_target=256)
    tidx = convert.kd_index_from_arrays(jidx, "cpu")
    if data == "midpoints":
        q = _midpoint_ties(t, tidx)
    jt = jknn.build_target_index(jnp.asarray(t), tile_t=jknn.V2_TILE_T)
    tt = convert.target_index_from_arrays(jt, "cpu")
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    assert jkd._resident_layout(jidx)[-1] and tkd._resident_layout(tidx)[-1]
    cold = dict(jax=[_n(x) for x in jkd.match_kd(jq, jidx, jt, maxd, impl="v2", interpret=True)],
                port=[x.numpy() for x in tkd.match_kd(tq, tidx, tt, maxd)])
    monkeypatch.setattr(jknn, "RESIDENT_VMEM_BUDGET", 1024)
    monkeypatch.setattr(tknn, "RESIDENT_VMEM_BUDGET", 1024)
    assert not jkd._resident_layout(jidx)[-1] and not tkd._resident_layout(tidx)[-1]
    warm = dict(
        jax=[_n(x) for x in jkd.match_kd_warm(
            jq, jidx, maxd, jnp.asarray(cold["jax"][0].astype(np.int32)), jnp.asarray(t),
            fallback_index=jt, impl="v2", interpret=True)],
        port=[x.numpy() for x in tkd.match_kd_warm(
            tq, tidx, maxd, torch.from_numpy(cold["port"][0].astype(np.int32)),
            torch.from_numpy(t), fallback_index=tt)])

    def d2_to(idx):
        return ((t[idx] - q) ** 2).sum(1)

    for a, b in ((cold["port"], cold["jax"]), (warm["port"], warm["jax"])):
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[1][a[2]], b[1][b[2]])
        np.testing.assert_array_equal(d2_to(a[0])[a[2]], d2_to(b[0])[b[2]])
    parted = {}
    for pkg in ("jax", "port"):
        (wi, wd, wv), (ci, cd, cv) = warm[pkg], cold[pkg]
        np.testing.assert_array_equal(wv, cv)
        np.testing.assert_array_equal(wd[cv], cd[cv])
        part = cv & (wi != ci)
        np.testing.assert_array_equal(d2_to(wi)[part], cd[part])
        np.testing.assert_array_equal(d2_to(ci)[part], cd[part])
        parted[pkg] = int(part.sum())
    assert parted[parts] > 0, parted


@pytest.mark.parametrize("b,n,nc,cap_pad,k", [
    (4, 1_000_192, 512, 2048, 4), (1, 1_000_192, 512, 2048, 0), (3, 4097, 1024, 64, 16),
    (16, 4352, 128, 2944, 1)])
def test_radius_search_workspace_bytes(b, n, nc, cap_pad, k):
    """The wrapper's scratch size is the kernel's layout: row keys, bucket
    counts, bucket and chunk offsets, round-0 blocks, and three int arrays
    of (row, round slot) entries, each 16-byte aligned."""
    slots = k if k else tknn.KD_RADIUS_SPAN
    a16 = lambda x: -(-x // 16) * 16  # noqa: E731
    want = (a16(8 * b * n) + a16(4 * b * nc) + 2 * a16(4 * (b * nc + 1)) + a16(4 * b * n)
            + 3 * a16(4 * b * n * slots))
    assert tknn._radius_search_workspace_bytes(b, n, nc, cap_pad, k) == want


def test_radius_search_workspace_bytes_refuses():
    """Shapes the kernel does not take are refused before any launch."""
    ws = tknn._radius_search_workspace_bytes
    with pytest.raises(ValueError, match="k must be"):
        ws(1, 8, 8, 128, 17)
    with pytest.raises(ValueError, match="k must be"):
        ws(1, 8, 8, 128, -1)
    with pytest.raises(ValueError, match="at most"):
        ws(1, 8, tknn.KD_RADIUS_MAX_BLOCKS + 1, 128, 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        ws(1, 8, 8, 130, 4)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ws(1, 8, 1024, 2**21, 4)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ws(64, 2**21, 512, 2048, 16)


def _radius_contract_inputs(d, k, nc, seed, dev="cuda"):
    """Integer pages on ``dev``: B = 3 pairs of N = 4,097 rows (not a
    multiple of 32, 64, 256 or 512) over nc blocks of 64 slots laid out on
    a lattice (clumps at spacing 3), boxes the min / max over every slot
    (so a box bound holds for each slot). Pair 0: radii 1, 2, 5, 9 (equal
    to many distances and bounds), 0 and -1, and every 7th row's radius
    the bound of its second-nearest box; pair 1 all frozen; pair 2 one live row
    among 4,096 frozen. Picks (k > 0): the k nearest boxes, shuffled (a
    later pick may hold the lower index), with repeats, ids past nc - 1
    and -1; pair 0's rows mostly pick a handful of blocks (buckets far past
    one chunk)."""
    rng = np.random.default_rng(seed)
    b, n, cap_pad = 3, 4097, 64
    c = np.arange(nc)
    centres = np.stack([(c % 8) * 3, (c // 8 % 8) * 3, (c // 64) * 3], 1)
    pts = centres[:, None, :] + rng.integers(0, 3, (nc, cap_pad, 3))
    if d == 6:
        pts = np.concatenate([pts, rng.integers(0, 2, (nc, cap_pad, 3))], -1)
    pages = np.zeros((b, nc, 8, cap_pad), np.float32)
    pages[:, :, :d] = pts.transpose(0, 2, 1)
    bmin = np.broadcast_to(pts.min(1), (b, nc, d)).astype(np.float32).copy()
    bmax = np.broadcast_to(pts.max(1), (b, nc, d)).astype(np.float32).copy()
    q = rng.integers(-1, 8, (b, n, d)).astype(np.float32)
    if d == 6:
        q[..., 3:] = rng.integers(0, 2, (b, n, 3))
    radius = rng.choice([1.0, 2.0, 5.0, 9.0, 0.0, -1.0], (b, n)).astype(np.float32)
    radius[1] = -1.0
    radius[2] = -1.0
    radius[2, 2049] = 9.0
    dev = torch.device(dev)
    qt, bmin_t, bmax_t = (torch.from_numpy(a).to(dev) for a in (q, bmin, bmax))
    lb = tknn.box_lb(qt, bmin_t, bmax_t)                       # (B, N, nc)
    lb_sorted, order = (x.cpu().numpy() for x in torch.sort(lb, dim=-1, stable=True))
    second = lb_sorted[0, ::7, 1]                              # the second-nearest box's bound
    radius[0, ::7] = np.where(second > 0, second, radius[0, ::7])
    sel = None
    if k:
        sel = rng.permuted(order[..., :k], axis=-1).astype(np.int32)
        if k > 1:
            sel[:, 1::5, -1] = sel[:, 1::5, 0]
        sel[:, 2::9, 0] = nc + 2
        sel[:, ::11] = -1
        sel = torch.from_numpy(sel).to(dev)
    r = torch.from_numpy(radius).to(dev)
    return qt, r, bmin_t, bmax_t, torch.from_numpy(pages).to(dev), sel


def _radius_prune_ties(args, want):
    """Pair 0's rows whose answer lies in a block walked after the row's
    first one (k > 0: not its pick 0; k = 0: not its member of least bound,
    lowest id on ties), whose box bound equals the answer's d2, while the
    first block holds a point at that d2 too (so at a higher page index).
    After the first round such a row's best equals that block's bound: an
    exact kernel must neither prune the block (a skip on lb >= best would)
    nor pass over the tie (a restart at the best itself would)."""
    q, r, bmin, bmax, pages, sel = (None if x is None else x[:1].cpu() for x in args)
    d2, idx = (x[0].cpu().numpy() for x in want)
    nc, cap_pad, d = pages.shape[1], pages.shape[-1], q.shape[-1]
    lb = tknn.box_lb(q, bmin, bmax)[0].numpy()                  # (N, nc)
    if sel is not None:
        first = sel[0, :, 0].numpy()
        first = np.where(first < 0, -1, np.minimum(first, nc - 1))
    else:
        first = np.where(lb.min(1) <= r[0].numpy(), np.argmin(lb, 1), -1)
    rows = np.flatnonzero((idx >= 0) & (first >= 0) & (idx // cap_pad != first))
    rows = rows[lb[rows, idx[rows] // cap_pad] == d2[rows]]
    pts = pages[0].numpy()[first[rows], :d]                     # (m, d, cap_pad)
    qr = q[0].numpy()[rows]
    d2f = None
    for j in range(d):
        diff = pts[:, j] - qr[:, j, None]
        d2f = diff * diff if d2f is None else d2f + diff * diff
    return int((d2f == d2[rows, None]).any(1).sum())


@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("k", [0, 4, 16])
@pytest.mark.parametrize("nc", [16, 1024])
def test_radius_contract_inputs_hold_prune_ties(d, k, nc):
    """The card contract test's inputs (built here on the CPU, pair 0)
    hold rows whose answer is a tie in a later-walked block whose bound
    equals the row's best after its first block (see _radius_prune_ties).
    k = 1 walks one block a row, so it has no such row."""
    args = _radius_contract_inputs(d, k, nc, seed=100 + d + k + nc, dev="cpu")
    pair0 = tuple(None if x is None else x[:1] for x in args)
    want = tknn.kd_radius_search_plain(*pair0)
    assert _radius_prune_ties(pair0, want) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
@pytest.mark.parametrize("k", [0, 1, 4, 16])
def test_kd_radius_search_contract_on_card(d, k):
    """The block-major kd_radius_search equals its plain version on ties
    across picks and within a block, distances and bounds equal to the
    radius or to a row's best (rows that hold such a tie in a later-walked
    block are asserted present, k != 1), repeated, clipped and -1 picks,
    all-frozen pairs, one live row among 4,096 frozen ones, buckets far past
    one chunk, nc = 16 and nc = 1,024, and B = 3 with N not a multiple of
    any launch width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for nc in (16, 1024):
        args = _radius_contract_inputs(d, k, nc, seed=100 + d + k + nc)
        want = tknn.kd_radius_search_plain(*args)
        got = tknn.kd_radius_search(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), nc
        assert bool((want[1][0] >= 0).any()) and bool((want[1][0] < 0).any())
        assert bool((want[1][1] < 0).all()) and int((want[1][2] >= 0).sum()) <= 1
        if k != 1:
            assert _radius_prune_ties(args, want) > 0, nc
