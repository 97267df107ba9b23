"""The port's linear point-to-point (Procrustes) and GICP solvers against
the JAX package on the CPU, on the same numpy inputs made from a seed.

Tolerances: single solves to atol 1e-5 on the increment's entries (both
sum in f32, in different orders: the port one batched product, JAX one
reduction per entry; the port's 3x3 inverse and Cholesky are closed form,
JAX's LAPACK); whiteners as the test states, within the f32 loss of an
ill-conditioned 3x3 inverse; LM increments to 1e-6
as tests/test_torch_solvers.py holds the other metrics. Driver runs (2
pairs of ``bench.synth_cloud(4096)``, JAX's draws fed through
``selected=``, the same kd indexes in both, 8 iterations): match counts
equal in every iteration, RMSE curves to rtol 1e-4 / atol 1e-5, poses to
atol 1e-4 (f32 at 20 m scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from icp_variants_tpu.core import cloud as jcloud
from icp_variants_tpu.core import se3 as jse3
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import selection as jsel
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu.solvers import gauss_newton as jgn
from icp_variants_tpu.solvers import linear as jlin
from icp_variants_tpu.solvers import procrustes as jpro
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.solvers import gauss_newton as tgn
from icp_variants_tpu_torch.solvers import linear as tlin
from icp_variants_tpu_torch.solvers import procrustes as tpro

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _matches(seed, n=400, b=3):
    """B sets of correspondences on a 20 m sheet moved by a small rigid
    motion with noise; source normals NaN every 13th row and zero every
    11th, target normals NaN every 17th; 15% of rows masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        xy = rng.uniform(-20, 20, (n, 2))
        z = 2.0 * np.sin(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1])
        tgt = np.column_stack([xy, z]).astype(np.float32)
        nt = np.column_stack([-0.6 * np.cos(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1]),
                              0.4 * np.sin(0.3 * xy[:, 0]) * np.sin(0.2 * xy[:, 1]),
                              np.ones(n)])
        nt = (nt / np.linalg.norm(nt, axis=1, keepdims=True)).astype(np.float32)
        R = np.asarray(jse3.axis_angle_to_matrix(jnp.asarray(rng.normal(0, 0.02, 3),
                                                             jnp.float32)))
        src = (tgt @ R.T + rng.normal(0, 0.1, 3) + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
        ns = (nt @ R.T).astype(np.float32)
        ns[::13] = np.nan
        ns[5::11] = 0.0
        nt[::17] = np.nan
        weights = rng.uniform(0.5, 1.0, n).astype(np.float32)
        valid = rng.random(n) > 0.15
        out.append((src, tgt, ns, nt, weights, valid))
    return [np.stack(x) for x in zip(*out)]


# ---------------------------------------------------------------------------
# Procrustes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted_means", [False, True])
def test_procrustes_matches_jax(weighted_means):
    """Three pairs in one batched call against JAX pair by pair; robust
    weights near zero on a quarter of the rows under weighted means."""
    src, tgt, _, _, w, valid = _matches(1)
    if weighted_means:
        w[:, ::4] = 1e-4
    tp = tpro.estimate_pose_point_to_point(_t(src), _t(tgt), _t(w), _t(valid),
                                           weighted_means=weighted_means)
    assert tp.shape == (3, 4, 4)
    for i in range(len(src)):
        jp = jpro.estimate_pose_point_to_point(src[i], tgt[i], w[i], valid[i],
                                               weighted_means=weighted_means)
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp), atol=1e-5)
    R = tp[:, :3, :3].double()
    np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(), np.tile(np.eye(3), (3, 1, 1)),
                               atol=1e-5)


def test_procrustes_reflection_and_rank2():
    """A cross-covariance whose plain orthogonal fit is a reflection (the
    target is the source mirrored through a plane, det(U Vt) = -1) and a
    rank-2 one (every point on one plane): R is a rotation in both
    packages and they agree, whatever sign conventions the SVDs pick."""
    rng = np.random.default_rng(2)
    src = rng.normal(0, 1.0, (200, 3)).astype(np.float32)
    mirrored = src * np.array([1.0, 1.0, -1.0], np.float32) + 0.01 * rng.normal(
        0, 1, (200, 3)).astype(np.float32)
    planar = src.copy()
    planar[:, 2] = 0.0
    w, valid = np.ones(200, np.float32), np.ones(200, bool)
    Rz = np.asarray(jse3.axis_angle_to_matrix(jnp.asarray([0.0, 0.0, 0.3], jnp.float32)))
    cases = {"reflection": (src, mirrored),
             "rank2": (planar, (planar @ Rz.T + np.array([0.2, -0.1, 0.0])).astype(np.float32))}
    for name, (s, d) in cases.items():
        A = (d - d.mean(0)).T.astype(np.float64) @ (s - s.mean(0))
        U, _, Vt = np.linalg.svd(A)
        if name == "reflection":
            assert np.linalg.det(U @ Vt) < 0
        else:
            assert np.linalg.matrix_rank(A, tol=1e-6 * np.abs(A).max()) == 2
        tp = tpro.estimate_pose_point_to_point(_t(s), _t(d), _t(w), _t(valid)).numpy()
        jp = np.asarray(jpro.estimate_pose_point_to_point(s, d, w, valid))
        assert abs(np.linalg.det(tp[:3, :3].astype(np.float64)) - 1.0) < 1e-5, name
        np.testing.assert_allclose(tp, jp, atol=1e-5, err_msg=name)
    # The rank-2 case recovers the planted rotation.
    s, d = cases["rank2"]
    tp = tpro.estimate_pose_point_to_point(_t(s), _t(d), _t(w), _t(valid)).numpy()
    np.testing.assert_allclose(tp[:3, :3], Rz, atol=1e-5)


# ---------------------------------------------------------------------------
# GICP
# ---------------------------------------------------------------------------


def test_gicp_point_rows_and_normal_equations_match_jax():
    src, tgt, _, _, w, _ = _matches(3, b=1)
    s, d = src[0] - tgt[0].mean(0), tgt[0] - tgt[0].mean(0)
    np.testing.assert_array_equal(tlin._point_rows(_t(s)).numpy(), np.asarray(jlin._point_rows(s)))
    rows = np.asarray(jlin._point_rows(s))
    rhs, row_w = d - s, np.stack([w[0]] * 3, axis=1)
    ja, jb = jlin._accumulate_normal_equations(rows, rhs, row_w)
    ta, tb = tlin._accumulate_normal_equations(_t(rows), _t(rhs), _t(row_w))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)


def test_gicp_whitener_matches_jax():
    """Unit, zero and non-finite normals: L lower-triangular and, like
    JAX's, within 2 cond(C) f32 ulps (relative to its largest entry) of the
    float64 factor of the inverse combined covariance C; near-parallel
    normals make C's smallest eigenvalue 2 * eps, so cond(C) reaches ~1e3
    and both f32 inverses lose that much. Where cond(C) < 10 the port
    equals JAX to rtol 1e-5 / atol 1e-6."""
    _, _, ns, nt, _, _ = _matches(4, b=2)
    tl = tlin.gicp_whitener(_t(ns), _t(nt)).numpy()
    jl = np.stack([np.asarray(jlin.gicp_whitener(ns[i], nt[i])) for i in range(2)])
    assert tl.shape == (2, 400, 3, 3) and np.isfinite(tl).all()
    np.testing.assert_array_equal(np.triu(tl, 1), 0.0)
    n_s = np.where(np.isfinite(ns), ns, 0.0).astype(np.float64)
    n_t = np.where(np.isfinite(nt), nt, 0.0).astype(np.float64)
    c = (2.0 * np.eye(3) - (1 - tlin.GICP_EPSILON) * n_s[..., :, None] * n_s[..., None, :]
         - (1 - tlin.GICP_EPSILON) * n_t[..., :, None] * n_t[..., None, :])
    l64 = np.linalg.cholesky(np.linalg.inv(c))
    cond = np.linalg.cond(c)
    tol = 2.0 * cond * 2.0 ** -24 * np.abs(l64).max((-2, -1))
    assert (np.abs(tl - l64).max((-2, -1)) <= tol).all()
    assert (np.abs(jl - l64).max((-2, -1)) <= tol).all()
    calm = cond < 10
    assert calm.sum() > 100
    np.testing.assert_allclose(tl[calm], jl[calm], rtol=1e-5, atol=1e-6)
    # Zero normals on both sides: isotropic, L = I / sqrt(2).
    z = np.zeros((1, 3), np.float32)
    np.testing.assert_allclose(tlin.gicp_whitener(_t(z), _t(z)).numpy()[0],
                               np.eye(3) / np.sqrt(2.0), rtol=1e-6)


def test_linear_gicp_matches_jax():
    src, tgt, ns, nt, w, valid = _matches(5)
    tp = tlin.estimate_pose_gicp(*(_t(x) for x in (src, tgt, ns, nt, w, valid)))
    assert tp.shape == (3, 4, 4) and torch.isfinite(tp).all()
    for i in range(len(src)):
        jp = jlin.estimate_pose_gicp(src[i], tgt[i], ns[i], nt[i], w[i], valid[i])
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp), atol=1e-5)


def test_lm_gicp_matches_jax():
    """GICP through LM: the whitened residual stack, three pairs batched,
    against JAX pair by pair (increment 1e-6, costs rtol 1e-5)."""
    src, tgt, ns, nt, w, valid = _matches(6)
    tr = tgn.solve_lm(tconfig.Metric.GICP, *(_t(x) for x in (src, tgt, ns, nt, w, valid)))
    for i in range(len(src)):
        jr = jgn.solve_lm(jconfig.Metric.GICP, src[i], tgt[i], ns[i], nt[i], w[i], valid[i])
        np.testing.assert_allclose(tr.increment[i].numpy(), np.asarray(jr.increment), atol=1e-6)
        np.testing.assert_allclose(tr.cost[i].numpy(), np.asarray(jr.cost), rtol=1e-5)
        np.testing.assert_allclose(tr.initial_cost[i].numpy(), np.asarray(jr.initial_cost),
                                   rtol=1e-5)
    assert (tr.n_accepted >= 1).all()


# ---------------------------------------------------------------------------
# The driver: run_icp_batch with the new solvers on the exact kd arm
# ---------------------------------------------------------------------------

N_POINTS, N_PAIRS, N_ITER, P, MAXD = 4096, 2, 8, 0.05, 10.0


@pytest.fixture(scope="module")
def sheets():
    """2 pairs of bench.synth_cloud(4096), sources moved by
    bench.eth_true_pose; kd indexes of 256-point blocks built by JAX and
    carried across; JAX's own geometric-gap draws for every iteration."""
    pairs = []
    for i in range(N_PAIRS):
        tp, tn = bench.synth_cloud(N_POINTS, 2 * i)
        T = bench.eth_true_pose(i)
        pairs.append(((tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32),
                      (tn @ T[:3, :3].T).astype(np.float32), tp, tn))
    js = jicp.stack_clouds([jcloud.from_numpy(p[0], normals=p[1], morton_order=True)
                            for p in pairs])
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
    for b, kb in enumerate(jax.random.split(key, N_PAIRS)):
        for t, kt in enumerate(jax.random.split(kb, N_ITER)):
            s, r = jsel.bernoulli_gap_indices(kt, P, jnp.int32(1), cap, k_cap)
            sel[b, t], inr[b, t] = np.asarray(s), np.asarray(r)
    return dict(js=js, jt=jt, jkds=jkds, key=key, sel=sel, inr=inr,
                gts=np.stack([p[0] for p in pairs]), gtt=np.stack([p[2] for p in pairs]),
                ts=convert.cloud_from_arrays(js, "cpu"), tt=convert.cloud_from_arrays(jt, "cpu"),
                tkds=convert.kd_index_from_arrays(jkds, "cpu"))


@pytest.mark.parametrize("metric,minimizer", [
    ("POINT_TO_POINT", "LINEAR"), ("GICP", "LINEAR"), ("GICP", "NONLINEAR_LM"),
])
def test_run_icp_batch_matches_jax(sheets, metric, minimizer):
    kw = dict(selection_proba=P, n_iterations=N_ITER, max_distance=MAXD)
    jcfg = jconfig.ICPConfig(metric=getattr(jconfig.Metric, metric),
                             minimizer=getattr(jconfig.Minimizer, minimizer),
                             selection=jconfig.Selection.RANDOM, **kw)
    tcfg = tconfig.ICPConfig(metric=getattr(tconfig.Metric, metric),
                             minimizer=getattr(tconfig.Minimizer, minimizer),
                             selection=tconfig.Selection.RANDOM, **kw)
    jr = jicp.run_icp_batch(jcfg, sheets["js"], sheets["jt"], key=sheets["key"],
                            kd_indexes=sheets["jkds"],
                            gt_source_points=sheets["gts"], gt_target_points=sheets["gtt"])
    tr = ticp.run_icp_batch(tcfg, sheets["ts"], sheets["tt"], kd_indexes=sheets["tkds"],
                            selected=(_t(sheets["sel"]), _t(sheets["inr"])),
                            gt_source_points=sheets["gts"], gt_target_points=sheets["gtt"],
                            device="cpu")
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), np.asarray(jr.trace.num_matches))
    np.testing.assert_allclose(tr.trace.rmse.numpy(), np.asarray(jr.trace.rmse),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-4)
