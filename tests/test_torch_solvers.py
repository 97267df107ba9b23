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
