"""The port's Anderson acceleration (solvers/anderson.py and its mixing in
the driver) against the JAX package on the CPU.

Tolerances: the pose chart to 1e-6; ``anderson.step`` outputs over 8
steps within 1e-4 of a float64 run of the same step and of JAX's (the (m,
m) solve of nearly parallel differences amplifies f32 rounding: JAX's own
step reads up to ~2e-5 from the float64 one); counts and restarts equal;
driver runs (2 pairs of ``bench.synth_cloud(4096)``, JAX's draws fed through ``selected=``, the
same kd indexes in both): match counts equal in every iteration, RMSE
curves to rtol 1e-4 / atol 1e-5, poses to atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu.solvers import anderson as janderson
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.solvers import anderson as tanderson

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_pose_chart_matches_jax():
    rng = np.random.default_rng(0)
    vecs = np.concatenate([rng.normal(0, 0.5, (6, 3)), rng.normal(0, 2.0, (6, 3))], 1)
    vecs[0, :3] = 0.0                        # identity rotation
    vecs[1, :3] = [0.0, 0.0, 3.1]            # near pi
    vecs = vecs.astype(np.float32)
    tposes = tanderson.vec_to_pose(_t(vecs))
    jposes = np.stack([np.asarray(janderson.vec_to_pose(v)) for v in vecs])
    np.testing.assert_allclose(tposes.numpy(), jposes, atol=1e-6)
    back = tanderson.pose_to_vec(tposes).numpy()
    jback = np.stack([np.asarray(janderson.pose_to_vec(p)) for p in jposes])
    np.testing.assert_allclose(back, jback, atol=2e-6)
    np.testing.assert_allclose(back, vecs, atol=2e-5)


def _sequence(b=3, steps=8, seed=1):
    """Per pair, a contraction x -> A x + c whose plain update is kicked
    away (residual growth, so a restart) at step 2 on pair 0 and step 4 on
    pair 1; pair 2 is never kicked."""
    rng = np.random.default_rng(seed)
    As = []
    for _ in range(b):
        Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
        As.append((Q * rng.uniform(0.3, 0.95, 6)) @ Q.T)
    cs = [rng.normal(0, 0.5, 6) for _ in range(b)]
    kicks = {(0, 2): rng.normal(0, 3.0, 6), (1, 4): rng.normal(0, 3.0, 6)}

    def G(i, k, x):
        g = As[i] @ x + cs[i] + kicks.get((i, k), 0.0)
        return g.astype(np.float32)

    return G, steps, b


@pytest.mark.parametrize("m", [2, 3])
def test_step_matches_jax_with_per_pair_restarts(m, monkeypatch):
    """Three pairs batched against JAX pair by pair over 8 steps: the
    growth restarts land at different steps for different pairs (one
    pair's restart leaves the others' history and counts alone), and the
    trust clamp engages (a run of JAX's step without it gives another
    answer)."""
    G, steps, b = _sequence()
    tstate = tanderson.init(m, (b,))
    state64 = tanderson.init(m, (b,), dtype=torch.float64)
    jstates = [janderson.init(m) for _ in range(b)]
    x = np.zeros((b, 6), np.float32)
    restarts, counts, j_outs = [], [], []
    for k in range(steps):
        g = np.stack([G(i, k, x[i]) for i in range(b)])
        tstate, tx = tanderson.step(tstate, _t(x), _t(g), m)
        state64, x64 = tanderson.step(state64, _t(x).double(), _t(g).double(), m)
        jx = []
        for i in range(b):
            jstates[i], out = janderson.step(jstates[i], jnp.asarray(x[i]), jnp.asarray(g[i]), m)
            jx.append(np.asarray(out))
        jx = np.stack(jx)
        # The mixing solve of nearly parallel differences loses f32 digits
        # (JAX's own step reads up to ~2e-5 from the float64 one here):
        # both within 1e-4 of the float64 step, and of each other.
        err_t = np.abs(tx.numpy() - x64.numpy()).max()
        err_j = np.abs(jx - x64.numpy()).max()
        assert err_t <= 1e-4 and err_j <= 1e-4, (k, err_t, err_j)
        np.testing.assert_allclose(tx.numpy(), jx, atol=1e-4, err_msg=f"step {k}")
        np.testing.assert_array_equal(tstate.count.numpy(),
                                      [int(s.count) for s in jstates])
        np.testing.assert_array_equal(tstate.restarts.numpy(),
                                      [int(s.restarts) for s in jstates])
        restarts.append(tstate.restarts.numpy().copy())
        counts.append(tstate.count.numpy().copy())
        j_outs.append(jx)
        x = jx
    restarts, counts = np.stack(restarts), np.stack(counts)
    assert restarts[2, 0] == 1 and restarts[1, 0] == 0      # pair 0 restarts at step 2
    assert restarts[4, 1] == 1 and restarts[3, 1] == 0      # pair 1 at step 4
    assert counts[2, 0] == 1 and counts[2, 1] == 3 and counts[4, 1] == 1
    assert counts[4, 0] == min(3, m + 1)                    # pair 0's history refills
    # The clamp: JAX's step without it (CLAMP huge) answers differently.
    monkeypatch.setattr(janderson, "CLAMP", 1e30)
    x = np.zeros((b, 6), np.float32)
    states = [janderson.init(m) for _ in range(b)]
    differs = False
    for k in range(steps):
        for i in range(b):
            states[i], out = janderson.step(states[i], jnp.asarray(x[i]),
                                            jnp.asarray(G(i, k, x[i])), m)
            differs |= not np.allclose(np.asarray(out), j_outs[k][i], atol=1e-4)
        x = j_outs[k]
    assert differs


def test_init_like_and_fixed_point():
    pose = torch.eye(4).expand(5, 4, 4)
    st = tanderson.init_like(2, pose)
    assert st.xs.shape == (5, 3, 6) and st.count.shape == (5,)
    assert torch.isinf(st.prev_norm).all() and st.count.dtype == torch.int32
    x = torch.randn(5, 6)
    for _ in range(4):
        st, out = tanderson.step(st, x, x, 2)
    torch.testing.assert_close(out, x, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

# The driver runs share tests/test_torch_gicp.py's data: 2 pairs of
# bench.synth_cloud(4096), JAX's kd indexes and draws.
from test_torch_gicp import MAXD, N_ITER, P, sheets  # noqa: E402, F401 (a fixture)


def _cfgs(**kw):
    j = jconfig.ICPConfig(metric=jconfig.Metric.SYMMETRIC, minimizer=jconfig.Minimizer.LINEAR,
                          max_distance=MAXD, n_iterations=N_ITER, anderson_m=2, **kw)
    t = tconfig.ICPConfig(metric=tconfig.Metric.SYMMETRIC, minimizer=tconfig.Minimizer.LINEAR,
                          max_distance=MAXD, n_iterations=N_ITER, anderson_m=2,
                          **{k: getattr(tconfig.Selection, v.name) if k == "selection" else v
                             for k, v in kw.items()})
    return j, t


def _compare(tr, jr):
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), np.asarray(jr.trace.num_matches))
    np.testing.assert_allclose(tr.trace.rmse.numpy(), np.asarray(jr.trace.rmse),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-4)


def test_run_icp_batch_anderson_matches_jax(sheets):
    """Symmetric linear ICP with AA(2) on the exact kd arm: the trace keeps
    the plain step's pose and the carry the mixed one, per pair, as JAX's
    vmapped scan does."""
    jcfg, tcfg = _cfgs(selection=jconfig.Selection.RANDOM, selection_proba=P)
    jr = jicp.run_icp_batch(jcfg, sheets["js"], sheets["jt"], key=sheets["key"],
                            kd_indexes=sheets["jkds"],
                            gt_source_points=sheets["gts"], gt_target_points=sheets["gtt"])
    tr = ticp.run_icp_batch(tcfg, sheets["ts"], sheets["tt"], kd_indexes=sheets["tkds"],
                            selected=(_t(sheets["sel"]), _t(sheets["inr"])),
                            gt_source_points=sheets["gts"], gt_target_points=sheets["gtt"],
                            device="cpu")
    _compare(tr, jr)
    plain = ticp.run_icp_batch(tcfg.replace(anderson_m=0), sheets["ts"], sheets["tt"],
                               kd_indexes=sheets["tkds"],
                               selected=(_t(sheets["sel"]), _t(sheets["inr"])),
                               gt_source_points=sheets["gts"], gt_target_points=sheets["gtt"],
                               device="cpu")
    assert not torch.equal(plain.trace.rmse, tr.trace.rmse)


def test_segmented_multires_anderson_matches_jax(sheets):
    """The segmented multires driver (SELECT_ALL pyramid, exact kd arm with
    warm start) with AA(2): a fresh mixing state at every level in both
    packages."""
    jcfg, tcfg = _cfgs(selection=jconfig.Selection.ALL, multi_resolution=True,
                       multi_resolution_min_points=500)
    jr = jicp.run_icp_batch_multires_segmented(
        jcfg, sheets["js"], sheets["jt"], key=sheets["key"], kd_indexes=sheets["jkds"],
        gt_source_points=sheets["gts"], gt_target_points=sheets["gtt"])
    tr = ticp.run_icp_batch_multires_segmented(
        tcfg, sheets["ts"], sheets["tt"], kd_indexes=sheets["tkds"],
        gt_source_points=sheets["gts"], gt_target_points=sheets["gtt"], device="cpu")
    assert tr.trace.rmse.shape[1] > N_ITER - 1
    _compare(tr, jr)
