"""The port's linear solvers and measures against the JAX package on the
CPU, at rtol 1e-5: both sum in f32, in different orders (JAX one reduction
per normal-equation entry, the port one batched product per row type)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_variants_tpu.core import se3 as jse3
from icp_variants_tpu.pipeline import measure as jmeasure
from icp_variants_tpu.solvers import linear as jlin
from icp_variants_tpu_torch.pipeline import measure as tmeasure
from icp_variants_tpu_torch.solvers import linear as tlin

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _matches(seed, n=500, b=3):
    """B sets of correspondences: a smooth sheet at 20 m scale moved by a
    small rigid motion, with noise, NaN normals and masked rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(b):
        xy = rng.uniform(-20, 20, (n, 2))
        z = 2.0 * np.sin(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1])
        tgt = np.column_stack([xy, z]).astype(np.float32)
        nt = np.column_stack([-0.6 * np.cos(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1]),
                              0.4 * np.sin(0.3 * xy[:, 0]) * np.sin(0.2 * xy[:, 1]),
                              np.ones(n)])
        nt = (nt / np.linalg.norm(nt, axis=1, keepdims=True)).astype(np.float32)
        w = rng.normal(0, 0.02, 3).astype(np.float32)
        R = np.asarray(jse3.axis_angle_to_matrix(jnp.asarray(w)))
        src = (tgt @ R.T + rng.normal(0, 0.1, 3) + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
        ns = (nt @ R.T).astype(np.float32)
        ns[::13] = np.nan
        weights = rng.uniform(0.5, 1.0, n).astype(np.float32)
        valid = rng.random(n) > 0.15
        out.append((src, tgt, ns, nt, weights, valid))
    return [np.stack(x) for x in zip(*out)]


def test_normal_equations_match_jax():
    src, tgt, _, _, w, _ = _matches(1, b=1)
    s, d = src[0] - src[0].mean(0), tgt[0] - tgt[0].mean(0)
    ja, jb = jlin._accumulate_normal_equations_soa(jlin._point_row_specs(s, d, w[0]))
    ta, tb = tlin._accumulate_normal_equations_soa(tlin._point_row_specs(_t(s), _t(d), _t(w[0])))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["symmetric", "point_to_plane"])
def test_linear_solvers_match_jax(metric):
    src, tgt, ns, nt, w, valid = _matches(2)
    if metric == "symmetric":
        tp = tlin.estimate_pose_symmetric(*(_t(x) for x in (src, tgt, ns, nt, w, valid)))
        jp = [jlin.estimate_pose_symmetric(src[i], tgt[i], ns[i], nt[i], w[i], valid[i])
              for i in range(len(src))]
    else:
        tp = tlin.estimate_pose_point_to_plane(*(_t(x) for x in (src, tgt, nt, w, valid)))
        jp = [jlin.estimate_pose_point_to_plane(src[i], tgt[i], nt[i], w[i], valid[i])
              for i in range(len(src))]
    jp = np.stack([np.asarray(p) for p in jp])
    assert tp.shape == (len(src), 4, 4)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-5, atol=1e-5)
    # Unbatched call gives the same pose as its row of the batch.
    one = tlin.estimate_pose_symmetric(*(_t(x[0]) for x in (src, tgt, ns, nt, w, valid)))
    if metric == "symmetric":
        np.testing.assert_allclose(one.numpy(), tp[0].numpy(), rtol=1e-6, atol=1e-6)


def test_measures_match_jax():
    src, tgt, _, _, _, valid = _matches(3)
    rng = np.random.default_rng(4)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(src), 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.05, (len(src), 3))
    t_rmse = tmeasure.rmse_alignment_error(_t(poses), _t(src), _t(tgt), _t(valid)).numpy()
    t_bench = tmeasure.benchmark_error(_t(poses), _t(src), _t(tgt), _t(valid)).numpy()
    for i in range(len(src)):
        np.testing.assert_allclose(
            t_rmse[i], np.asarray(jmeasure.rmse_alignment_error(poses[i], src[i], tgt[i], valid[i])),
            rtol=1e-5)
        np.testing.assert_allclose(
            t_bench[i], np.asarray(jmeasure.benchmark_error(poses[i], src[i], tgt[i], valid[i])),
            rtol=1e-5)


# ---------------------------------------------------------------------------
# The LM solver (solvers/gauss_newton.py), mirroring tests/test_solvers.py's
# TestLM cases against the JAX package's solve_lm. Tolerances: increments
# to 1e-6 and costs to rtol 1e-5 on the well-posed sheets (the f32 normal
# equations sum in another order; the last accepted steps move the
# increment by less than that); the number of accepted steps is compared
# where a step is rejected before convergence, not on the noise floor,
# where either side may accept a last step whose cost decrease is f32 noise.
# ---------------------------------------------------------------------------

from icp_variants_tpu.pipeline.config import Metric as JMetric  # noqa: E402
from icp_variants_tpu.solvers import gauss_newton as jgn  # noqa: E402
from icp_variants_tpu_torch.pipeline.config import Metric as TMetric  # noqa: E402
from icp_variants_tpu_torch.solvers import gauss_newton as tgn  # noqa: E402


@pytest.mark.parametrize("metric", ["POINT_TO_POINT", "POINT_TO_PLANE", "SYMMETRIC"])
def test_lm_matches_jax(metric):
    """Three pairs in one batched call, with NaN source and target normals
    and masked rows, against JAX pair by pair; the 4x4 increments agree
    too."""
    src, tgt, ns, nt, w, valid = _matches(5)
    nt[:, ::17] = np.nan
    tr = tgn.solve_lm(getattr(TMetric, metric), *(_t(x) for x in (src, tgt, ns, nt, w, valid)))
    tpose = tgn.estimate_pose_lm(getattr(TMetric, metric),
                                 *(_t(x) for x in (src, tgt, ns, nt, w, valid)))
    assert tr.increment.shape == (3, 6) and tpose.shape == (3, 4, 4)
    for i in range(len(src)):
        args = (src[i], tgt[i], ns[i], nt[i], w[i], valid[i])
        jr = jgn.solve_lm(getattr(JMetric, metric), *args)
        np.testing.assert_allclose(tr.increment[i].numpy(), np.asarray(jr.increment), atol=1e-6)
        np.testing.assert_allclose(tr.cost[i].numpy(), np.asarray(jr.cost), rtol=1e-5)
        np.testing.assert_allclose(tr.initial_cost[i].numpy(), np.asarray(jr.initial_cost),
                                   rtol=1e-5)
        assert int(tr.n_accepted[i]) >= 1
        np.testing.assert_allclose(
            tpose[i].numpy(), np.asarray(jgn.estimate_pose_lm(getattr(JMetric, metric), *args)),
            atol=1e-6)
    assert torch.isfinite(tpose).all()


def test_lm_rejected_steps_match_jax():
    """A deliberately non-rigid fit (a line along x against one along y)
    whose second and third LM steps raise the cost and are rejected in both
    packages (mu grows, x stays). The f32 solve of this ill-conditioned
    problem is compared to 2e-5."""
    rng = np.random.default_rng(0)
    src = (rng.standard_normal((100, 3)) * [3, 0.05, 0.05]).astype(np.float32)
    tgt = (rng.standard_normal((100, 3)) * [0.05, 3, 0.05]).astype(np.float32)
    nrm = rng.standard_normal((100, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    w, valid = np.ones(100, np.float32), np.ones(100, bool)
    jr = jgn.solve_lm(JMetric.POINT_TO_PLANE, src, tgt, nrm, nrm, w, valid, max_iterations=3)
    tr = tgn.solve_lm(TMetric.POINT_TO_PLANE,
                      *(_t(x)[None] for x in (src, tgt, nrm, nrm, w, valid)), max_iterations=3)
    assert int(jr.n_accepted) == 1 and int(tr.n_accepted[0]) == 1
    np.testing.assert_allclose(tr.increment[0].numpy(), np.asarray(jr.increment), atol=2e-5)
    np.testing.assert_allclose(tr.cost[0].numpy(), np.asarray(jr.cost), rtol=1e-5)
    assert float(tr.cost[0]) < float(tr.initial_cost[0])


def test_lm_gicp_is_not_ported():
    """GICP through LM, which raised NotImplementedError until
    ``linear.gicp_whitener`` was ported (the test keeps its name): three
    pairs batched against JAX pair by pair, at the tolerances above."""
    src, tgt, ns, nt, w, valid = _matches(6)
    tr = tgn.solve_lm(TMetric.GICP, *(_t(x) for x in (src, tgt, ns, nt, w, valid)))
    tpose = tgn.estimate_pose_lm(TMetric.GICP, *(_t(x) for x in (src, tgt, ns, nt, w, valid)))
    for i in range(len(src)):
        args = (src[i], tgt[i], ns[i], nt[i], w[i], valid[i])
        jr = jgn.solve_lm(JMetric.GICP, *args)
        np.testing.assert_allclose(tr.increment[i].numpy(), np.asarray(jr.increment), atol=1e-6)
        np.testing.assert_allclose(tr.cost[i].numpy(), np.asarray(jr.cost), rtol=1e-5)
        np.testing.assert_allclose(
            tpose[i].numpy(), np.asarray(jgn.estimate_pose_lm(JMetric.GICP, *args)), atol=1e-6)
    assert (tr.n_accepted >= 1).all()
