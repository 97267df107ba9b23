"""The port's ICP driver — the ETH headline path as a whole — against the
JAX package on the CPU: 2 bench-style pairs of 8,192-point sheets, both
matching arms, p = 0.05, 8 iterations. Both packages search the same kd
indexes (carried across with ``convert``) and use the same selections (the
JAX package's own geometric-gap draws from its key splits, fed to the port
through ``selected=``).

Tolerances: per-iteration match counts are equal; RMSE curves agree to
rtol 1e-4 with atol 1e-5 and poses to atol 1e-4. Both sum in f32 in
different orders; once converged the RMSE sits at the f32 resolution of
20 m coordinates (~2e-6 m), where only the absolute tolerance is
meaningful."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from icp_variants_tpu.core import cloud as jcloud
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu.ops import selection as jsel
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.core import cloud as tcloud
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp

torch.set_num_threads(2)

N_POINTS, N_PAIRS, N_ITER, P, MAXD = 8192, 2, 8, 0.05, 10.0


def _cfgs(checks):
    kw = dict(selection_proba=P, n_iterations=N_ITER, max_distance=MAXD, matching_checks=checks)
    j = jconfig.ICPConfig(metric=jconfig.Metric.SYMMETRIC, minimizer=jconfig.Minimizer.LINEAR,
                          selection=jconfig.Selection.RANDOM, **kw)
    t = tconfig.ICPConfig(metric=tconfig.Metric.SYMMETRIC, minimizer=tconfig.Minimizer.LINEAR,
                          selection=tconfig.Selection.RANDOM, **kw)
    return j, t


@pytest.fixture(scope="module")
def data():
    pairs = []
    for i in range(N_PAIRS):
        tp, tn = bench.synth_cloud(N_POINTS, 2 * i)
        T = bench.eth_true_pose(i)
        sp = (tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        sn = (tn @ T[:3, :3].T).astype(np.float32)
        pairs.append((sp, sn, tp, tn))
    js = jicp.stack_clouds([jcloud.from_numpy(p[0], normals=p[1], morton_order=True) for p in pairs])
    jt_list = [jcloud.from_numpy(p[2], normals=p[3], morton_order=True) for p in pairs]
    jt = jicp.stack_clouds(jt_list)
    jkds = jkd.stack_kd_indexes([
        jkd.build_kd_index(np.asarray(t.points), np.asarray(t.valid), block_target=256)
        for t in jt_list])
    cap = js.points.shape[1]
    k_cap = jicp._compact_capacity(cap, P)
    key = jax.random.PRNGKey(0)
    sel = np.zeros((N_PAIRS, N_ITER, k_cap), np.int32)
    inr = np.zeros((N_PAIRS, N_ITER, k_cap), bool)
    for b, kb in enumerate(jax.random.split(key, N_PAIRS)):       # icp.py:985
        for t, kt in enumerate(jax.random.split(kb, N_ITER)):      # icp.py:718
            s, r = jsel.bernoulli_gap_indices(kt, P, jnp.int32(1), cap, k_cap)
            sel[b, t], inr[b, t] = np.asarray(s), np.asarray(r)
    return dict(
        js=js, jt=jt, jkds=jkds, key=key, sel=sel, inr=inr,
        gts=np.stack([p[0] for p in pairs]), gtt=np.stack([p[2] for p in pairs]),
        ts=convert.cloud_from_arrays(js, "cpu"), tt=convert.cloud_from_arrays(jt, "cpu"),
        tkds=convert.kd_index_from_arrays(jkds, "cpu"),
    )


@pytest.mark.parametrize("checks,use_kd", [(0, True), (16, True), (0, False)])
def test_run_icp_batch_matches_jax(data, checks, use_kd):
    """Both kd arms, and the KNN branch without a kd index (the tile index
    search alone)."""
    jcfg, tcfg = _cfgs(checks)
    jr = jicp.run_icp_batch(jcfg, data["js"], data["jt"], key=data["key"],
                            kd_indexes=data["jkds"] if use_kd else None,
                            gt_source_points=data["gts"], gt_target_points=data["gtt"])
    tr = ticp.run_icp_batch(tcfg, data["ts"], data["tt"],
                            kd_indexes=data["tkds"] if use_kd else None,
                            selected=(torch.from_numpy(data["sel"]), torch.from_numpy(data["inr"])),
                            gt_source_points=data["gts"], gt_target_points=data["gtt"],
                            device="cpu")
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), np.asarray(jr.trace.num_matches))
    np.testing.assert_allclose(tr.trace.rmse.numpy(), np.asarray(jr.trace.rmse),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-4)
    assert float(tr.trace.rmse[:, -1].max()) < 1e-4


@pytest.mark.parametrize("checks", [0, 16])
def test_first_iteration_matches_match_jax(data, checks):
    """One iteration's matching stage on the headline path's own queries
    (the selected source rows, masked rows pinned to the first valid one):
    indices equal except at ties within f32 rounding, d2 to f32 rounding,
    validity equal."""
    jt = data["jt"]
    sel, inr = data["sel"][:, 0], data["inr"][:, 0]
    pts = np.asarray(data["js"].points)
    valid = np.asarray(data["js"].valid)
    for b in range(N_PAIRS):
        q = pts[b][sel[b]]
        m = inr[b] & valid[b][sel[b]]
        q = np.where(m[:, None], q, q[np.argmax(m)])
        jtin = jknn.build_target_index(jt.points[b], tile_t=jknn.V2_TILE_T)
        jidx = jax.tree.map(lambda x: x[b], data["jkds"])
        ji, jd, jv = (np.asarray(x) for x in jkd.match_kd(
            jnp.asarray(q), jidx, jtin, MAXD, jnp.asarray(m), checks=checks))
        tidx = tkd.KDIndex(*(None if f is None else f[b] for f in data["tkds"]))
        ti, td, tv = (x.numpy() for x in tkd.match_kd(
            torch.from_numpy(q), tidx, convert.target_index_from_arrays(jtin, "cpu"), MAXD,
            torch.from_numpy(m), checks=checks))
        np.testing.assert_array_equal(tv, jv)
        t_np = np.asarray(jt.points[b])
        diff = np.flatnonzero(tv & (ti != ji))
        qa = q[diff].astype(np.float64)
        np.testing.assert_allclose(((qa - t_np[ti[diff]]) ** 2).sum(1),
                                   ((qa - t_np[ji[diff]]) ** 2).sum(1), rtol=5e-7)
        np.testing.assert_allclose(td[tv], jd[tv], rtol=5e-7, atol=1e-6)


def test_generator_run_and_single_pair(data):
    """Without ``selected`` the port draws its own selections: deterministic
    per seed, converging; run_icp is the batch of one."""
    _, tcfg = _cfgs(0)
    a = ticp.run_icp_batch(tcfg, data["ts"], data["tt"], kd_indexes=data["tkds"],
                           seed=3, device="cpu")
    b = ticp.run_icp_batch(tcfg, data["ts"], data["tt"], kd_indexes=data["tkds"],
                           seed=3, device="cpu")
    assert torch.equal(a.pose, b.pose)
    for i in range(N_PAIRS):
        resid = a.pose[i].double().numpy() @ bench.eth_true_pose(i).astype(np.float64)
        assert np.abs(resid[:3, 3]).max() < 1e-3
    src0 = tcloud.Cloud(*(f[0] for f in data["ts"]))
    tgt0 = tcloud.Cloud(*(f[0] for f in data["tt"]))
    kd0 = tkd.KDIndex(*(None if f is None else f[0] for f in data["tkds"]))
    one = ticp.run_icp(tcfg, src0, tgt0, kd_index=kd0, seed=3, device="cpu")
    assert one.pose.shape == (4, 4) and one.trace.rmse.shape == (N_ITER,)
    resid = one.pose.double().numpy() @ bench.eth_true_pose(0).astype(np.float64)
    assert np.abs(resid[:3, 3]).max() < 1e-3


@pytest.mark.parametrize("change", [
    dict(selection=tconfig.Selection.ALL),
    dict(selection=tconfig.Selection.ALL, multi_resolution=True),
    dict(selection=tconfig.Selection.RANDOM, compact_queries=False, selection_proba=0.3),
    dict(selection=tconfig.Selection.RANDOM_FAST, selection_proba=0.3),
    dict(selection=tconfig.Selection.RANDOM_FAST, selection_proba=0.3, multi_resolution=True),
])
def test_selection_modes_converge(change):
    """The driver's other selection branches (no kd index, so the tile
    index search) register two small sheets from their known poses."""
    clouds = []
    for i in range(2):
        tp, tn = bench.synth_cloud(2048, 2 * i)
        T = bench.eth_true_pose(i)
        sp = (tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        clouds.append((tcloud.from_numpy(sp, normals=(tn @ T[:3, :3].T), morton_order=True,
                                         device="cpu"),
                       tcloud.from_numpy(tp, normals=tn, morton_order=True, device="cpu")))
    _, tcfg = _cfgs(0)
    tcfg = tcfg.replace(n_iterations=12, multi_resolution_min_points=500, **change)
    res = ticp.run_icp_batch(tcfg, ticp.stack_clouds([c[0] for c in clouds]),
                             ticp.stack_clouds([c[1] for c in clouds]), seed=1, device="cpu")
    assert (res.trace.num_matches > 0).all()
    for i in range(2):
        resid = res.pose[i].double().numpy() @ bench.eth_true_pose(i).astype(np.float64)
        assert np.abs(resid[:3, 3]).max() < 1e-2


def test_build_kd_for(data):
    _, tcfg = _cfgs(0)
    rng = np.random.default_rng(0)
    big = tcloud.from_numpy(rng.uniform(-5, 5, (30000, 3)).astype(np.float32), device="cpu")
    idx = ticp.build_kd_for(tcfg, big, device="cpu")
    assert isinstance(idx, tkd.KDIndex) and idx.pages.shape[1] == 8
    assert ticp.build_kd_for(tcfg.replace(selection=tconfig.Selection.ALL), big, device="cpu") is None
    small = tcloud.Cloud(*(f[0] for f in data["tt"]))
    assert ticp.build_kd_for(tcfg, small, device="cpu") is None


def test_entry_points_need_a_card_unless_cpu_is_asked(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ticp.run_icp_batch(tcfg, data["ts"], data["tt"], kd_indexes=data["tkds"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcloud.from_numpy(np.zeros((10, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkd.build_kd_index(np.zeros((10, 3), np.float32))


@pytest.mark.parametrize("change", [
    dict(minimizer=tconfig.Minimizer.NONLINEAR_LM),
    dict(metric=tconfig.Metric.POINT_TO_POINT),
    dict(matching=tconfig.Matching.PROJECTIVE),
])
def test_unported_options_raise(data, change):
    _, tcfg = _cfgs(16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ticp.run_icp_batch(tcfg.replace(n_iterations=1, **change), data["ts"], data["tt"],
                           kd_indexes=data["tkds"], device="cpu")
