"""The port's ETH data path and workload against the JAX package on the
CPU: ``data/loaders.ETHDataLoader``, ``workloads/eth`` (``align_eth_batch``
with its prefetch worker and checkpoint, ``align_eth``,
``refine_trajectory``, loop closures), ``parallel/pose_graph`` and the
``eth`` command of the CLI.

The sequence: 4 scans of one static scene (``bench.synth_cloud(4096, 0)``)
written as .pcd files, pre-aligned as in ``plain_global.csv`` (scan 2 as
ASCII, the rest binary); row k registers scan k+1 onto scan k and its pose
column holds ``bench.eth_true_pose(k)``, which the driver scales and
applies to the reading. The runs select every point (SELECT_ALL: no random
draws) and both packages match through kd indexes (``build_kd_for`` with
the minimum size lowered to the sequence's), built by the native
partition on both sides (JAX's native route pinned, as in
tests/test_torch_io.py).

Tolerances: points, validity and Morton order equal bit for bit; normals
as tests/test_torch_normals.py holds them (rows of relative eigen-gap
>= 1e-3 whose 5th and 6th neighbours are not tied within the expansion's
rounding, 8 |q|^2 2^-22: ``|cos|`` above 1 - 1e-4, signs equal). Registrations: both sum
in f32 in different orders, and the normals differ in their last bits, so
poses agree to atol 1e-5, RMSE and benchmark curves to rtol 1e-4 with
atol 1e-5, as tests/test_torch_icp.py holds the driver (once converged the
RMSE sits at the f32 resolution of 20 m coordinates, ~2e-6 m, where only
the absolute tolerance means anything), the initial errors to rtol 1e-5. Pose graphs: refined
poses to atol 1e-5 (reading 3e-7).
"""

import contextlib
import functools
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from icp_variants_tpu import __main__ as jmain
from icp_variants_tpu.data import pcd_io as jpcd
from icp_variants_tpu.data.loaders import ETHDataLoader as JLoader
from icp_variants_tpu.parallel import pose_graph as jpg
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu.runtime import native as jnative
from icp_variants_tpu.workloads import eth as jeth
from icp_variants_tpu_torch import __main__ as tmain
from icp_variants_tpu_torch.data import loaders as tloaders
from icp_variants_tpu_torch.data.loaders import ETHDataLoader as TLoader
from icp_variants_tpu_torch.parallel import pose_graph as tpg
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.runtime import native as tnative
from icp_variants_tpu_torch.workloads import eth as teth

torch.set_num_threads(2)

N_POINTS, N_PAIRS, N_ITER = 4096, 3, 6
ASCII_SCANS = (2,)
POSE_ATOL, CURVE_RTOL, CURVE_ATOL = 1e-5, 1e-4, 1e-5


def write_sequence(root, n_points=N_POINTS, n_pairs=N_PAIRS, ascii_scans=ASCII_SCANS):
    """The module docstring's sequence under ``root``; returns the CSV path."""
    data = os.path.join(root, "plain")
    os.makedirs(data, exist_ok=True)
    scene, _ = bench.synth_cloud(n_points, 0)
    for i in range(n_pairs + 1):
        jpcd.write_pcd(os.path.join(data, f"scan{i}.pcd"), scene, binary=i not in ascii_scans)
    rows = [f"{k},scan{k + 1}.pcd,scan{k}.pcd,0.9,"
            + ",".join(f"{x:.6f}" for x in bench.eth_true_pose(k)[:3, :4].reshape(-1))
            for k in range(n_pairs)]
    csv = os.path.join(root, "plain_global.csv")
    with open(csv, "w") as f:
        f.write("id,source,target,overlap," + ",".join(f"t{k}" for k in range(12)) + "\n")
        f.write("\n".join(rows) + "\n")
    return csv


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    return write_sequence(str(tmp_path_factory.mktemp("eth")))


@pytest.fixture
def same_route(monkeypatch):
    """JAX's native route pinned, and kd indexes at the sequence's size in
    both packages."""
    _patch_route(monkeypatch)


def _cfgs(**kw):
    base = dict(n_iterations=N_ITER, max_distance=10.0)
    base.update(kw)
    j = jeth.default_config(metric=jconfig.Metric.SYMMETRIC, minimizer=jconfig.Minimizer.LINEAR,
                            **base)
    t = teth.default_config(metric=tconfig.Metric.SYMMETRIC, minimizer=tconfig.Minimizer.LINEAR,
                            **base)
    return j, t


def _compare_normals(tn, jn, pts, valid):
    from scipy.spatial import cKDTree

    assert (np.isnan(tn).any(1) == np.isnan(jn).any(1)).all()
    dist, idx = cKDTree(pts[valid]).query(pts[valid], k=6)
    neigh = pts[valid][idx[:, :5]].astype(np.float64)
    c = neigh - neigh.mean(1, keepdims=True)
    w = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c))
    ok = (w[:, 1] - w[:, 0]) / np.maximum(w[:, 2], 1e-30) >= 1e-3
    # JAX's dense search sums the expansion |q|^2 + |t|^2 - 2 q.t (rounding
    # about (|q|^2 + |t|^2) 2^-22), the port's fast one direct differences:
    # a 5th and 6th neighbour within that rounding may swap.
    sq = np.sum(pts[valid].astype(np.float64) ** 2, axis=1)
    ok &= dist[:, 5] ** 2 - dist[:, 4] ** 2 > 8 * sq * 2.0 ** -22
    cos = np.sum(tn[valid][ok].astype(np.float64) * jn[valid][ok], axis=1)
    assert (np.abs(cos) > 1 - 1e-4).all()
    assert (cos > 0).all()
    assert ok.mean() > 0.95


def _compare_clouds(tc, jc):
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    valid = np.asarray(jc.valid)
    _compare_normals(tc.normals.numpy(), np.asarray(jc.normals), np.asarray(jc.points), valid)


@pytest.mark.parametrize("fast", [False, True])
def test_loader_matches_jax(seq, jax_pinned, monkeypatch, fast):
    """Points, validity and Morton order bit for bit; normals through both
    of the port's paths (the dense one, and the Morton-banded one with its
    threshold lowered) against JAX's dense one."""
    if fast:
        calls = []
        fn = tloaders.normals_ops.estimate_normals_knn_fast
        monkeypatch.setattr(tloaders.normals_ops, "FAST_NORMALS_MIN_POINTS", 1000)
        monkeypatch.setattr(tloaders.normals_ops, "estimate_normals_knn_fast",
                            lambda *a, **k: calls.append(1) or fn(*a, **k))
    t = TLoader(seq, capacity=4608, device="cpu")
    j = JLoader(seq, capacity=4608)
    assert t.data_name == j.data_name == "plain"
    assert t.get_length() == j.get_length() == N_PAIRS
    np.testing.assert_array_equal(t.point_counts(), j.point_counts())
    ts, js = t.get_item(1), j.get_item(1)
    np.testing.assert_array_equal(ts.pose, js.pose)
    _compare_clouds(ts.source, js.source)          # scan 2: ASCII
    _compare_clouds(ts.target, js.target)
    for b, (tb, jb) in enumerate(zip(t.get_items([2, 0]), j.get_items([2, 0]))):
        np.testing.assert_array_equal(tb.pose, jb.pose)
        for tc in (tb.source, tb.target):
            assert tc.capacity == 4608
        np.testing.assert_array_equal(tb.source.points.numpy(), np.asarray(jb.source.points))
        np.testing.assert_array_equal(tb.target.normals.numpy(),
                                      t.get_item([2, 0][b]).target.normals.numpy())
    np.testing.assert_array_equal(t.get_scan(N_PAIRS).points.numpy(),
                                  np.asarray(j.get_scan(N_PAIRS).points))
    with pytest.raises(IndexError):
        t.get_scan(N_PAIRS + 1)
    with pytest.raises(IndexError):
        t.get_items([N_PAIRS])
    timing = {}
    t.get_items([0], timing)
    assert timing["parse"] > 0 and timing["normals"] > 0 and timing["normals_events"] == (None, None)
    if fast:
        assert len(calls) >= 4


def test_loader_downsample_matches_jax(seq, jax_pinned):
    t = TLoader(seq, downsample=3, device="cpu")
    j = JLoader(seq, downsample=3)
    np.testing.assert_array_equal(t.point_counts(), j.point_counts())
    _compare_clouds(t.get_item(0).target, j.get_item(0).target)


@pytest.fixture
def jax_pinned(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", tnative.load())
    monkeypatch.setattr(jnative, "_load_failed", False)


def test_scale_and_perturb_match_jax():
    from icp_variants_tpu.core import cloud as jcloud
    from icp_variants_tpu_torch.core import cloud as tcloud

    pose = bench.eth_true_pose(5)
    pose[:3, :3] = pose[:3, :3] @ np.array([[1, 0, 0], [0, 0.8, -0.6], [0, 0.6, 0.8]], np.float32)
    for s in (0.1, 0.5, 1.0):
        np.testing.assert_allclose(teth.scale_pose(pose, s), jeth.scale_pose(pose, s), atol=2e-7)
    pts, nrm = bench.synth_cloud(500, 3)
    jc = jcloud.from_numpy(pts, normals=nrm, capacity=768)
    tc = tcloud.from_numpy(pts, normals=nrm, capacity=768, device="cpu")
    sc = jeth.scale_pose(pose, 0.1)
    jp, tp = jeth.perturb_cloud(jc, sc), teth.perturb_cloud(tc, sc)
    np.testing.assert_array_equal(tp.points.numpy(), np.asarray(jp.points))
    np.testing.assert_array_equal(tp.normals.numpy(), np.asarray(jp.normals))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))


def _compare_runs(tr, jr):
    assert [p.index for p in tr.pairs] == [p.index for p in jr.pairs]
    for tp, jp in zip(tr.pairs, jr.pairs):
        np.testing.assert_allclose(tp.pose, jp.pose, atol=POSE_ATOL)
        np.testing.assert_allclose(tp.perturbation, jp.perturbation, atol=2e-7)
        for key in ("rmse_per_iteration", "benchmark_per_iteration"):
            np.testing.assert_allclose(getattr(tp, key), getattr(jp, key),
                                       rtol=CURVE_RTOL, atol=CURVE_ATOL, err_msg=key)
        for key in ("initial_error", "initial_rmse"):
            np.testing.assert_allclose(getattr(tp, key), getattr(jp, key), rtol=1e-5)
        assert tp.final_error < 0.1 * tp.initial_error
    assert tr.index_min_error == jr.index_min_error
    np.testing.assert_allclose(tr.final_errors, jr.final_errors, rtol=CURVE_RTOL, atol=CURVE_ATOL)


def _patch_route(mp):
    mp.setattr(jnative, "_lib", tnative.load())
    mp.setattr(jnative, "_load_failed", False)
    mp.setattr(jicp, "build_kd_for", functools.partial(jicp.build_kd_for, min_points=1000))
    mp.setattr(ticp, "build_kd_for", functools.partial(ticp.build_kd_for, min_points=1000))


@pytest.fixture(scope="module")
def jax_batch_run(seq):
    mp = pytest.MonkeyPatch()
    _patch_route(mp)
    try:
        jcfg, _ = _cfgs()
        return jeth.align_eth_batch(seq, jcfg, batch_size=N_PAIRS, seed=4)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_batch_run(seq):
    """The port's sweep in batches of 2 (the second batch one pair)."""
    mp = pytest.MonkeyPatch()
    _patch_route(mp)
    try:
        _, tcfg = _cfgs()
        return teth.align_eth_batch(seq, tcfg, batch_size=2, seed=4, device="cpu")
    finally:
        mp.undo()


def test_align_eth_batch_matches_jax(port_batch_run, jax_batch_run):
    tr = port_batch_run
    _compare_runs(tr, jax_batch_run)
    load = tr.load
    assert set(load) == {"parse", "normals", "kd", "perturb", "wait", "load"}
    assert load["load"] == pytest.approx(load["parse"] + load["normals"] + load["kd"]
                                         + load["perturb"])


def test_align_eth_matches_jax_and_batch(seq, same_route, jax_batch_run):
    jcfg, tcfg = _cfgs()
    jr = jeth.align_eth(seq, jcfg, seed=4)
    tr = teth.align_eth(seq, tcfg, seed=4, device="cpu")
    _compare_runs(tr, jr)
    # SELECT_ALL draws nothing: the sequential sweep equals the batched one
    # (which pads to a common capacity).
    _compare_runs(tr, jax_batch_run)
    with pytest.raises(ValueError):
        teth.align_eth(seq, pose_scaling=0.0, device="cpu")


def test_align_eth_batch_random_selection_runs(seq, same_route):
    """The headline selection (RANDOM, compacted): per-batch generator
    seeds, deterministic, converging."""
    _, tcfg = _cfgs(selection=tconfig.Selection.RANDOM, selection_proba=0.2, n_iterations=10)
    a = teth.align_eth_batch(seq, tcfg, batch_size=2, seed=1, device="cpu")
    b = teth.align_eth_batch(seq, tcfg, batch_size=2, seed=1, device="cpu")
    for pa, pb in zip(a.pairs, b.pairs):
        np.testing.assert_array_equal(pa.pose, pb.pose)
        assert pa.final_error < 0.1 * pa.initial_error


def test_checkpoint_resume(seq, same_route, port_batch_run, tmp_path, monkeypatch):
    """A crash in the second batch leaves the first batch's pairs in the
    checkpoint; the rerun loads only the missing batch and ends equal to an
    uninterrupted run; a third run resumes everything and loads nothing;
    another configuration ignores the checkpoint. The file holds the JAX
    package's arrays."""
    _, tcfg = _cfgs()
    full = port_batch_run
    loaded = []
    get_items = TLoader.get_items

    def crash_on(bad):
        def fn(self, idxs, timing=None):
            loaded.append(list(idxs))
            if list(idxs) == bad:
                raise OSError("disk gone")
            return get_items(self, idxs, timing)
        return fn

    ck = str(tmp_path / "ck")
    monkeypatch.setattr(TLoader, "get_items", crash_on([2]))
    with pytest.raises(OSError, match="disk gone"):
        teth.align_eth_batch(seq, tcfg, batch_size=2, seed=4, checkpoint_dir=ck, device="cpu")
    with np.load(os.path.join(ck, "eth_sweep.npz")) as z:
        assert sorted(z.files) == sorted(
            ["manifest", "indices", "initial_errors", "final_errors", "initial_rmses",
             "final_rmses", "rmse_curves", "benchmark_curves", "poses", "perturbations"])
        assert z["indices"].tolist() == [0, 1]
    loaded.clear()
    monkeypatch.setattr(TLoader, "get_items", crash_on(None))
    resumed = teth.align_eth_batch(seq, tcfg, batch_size=2, seed=4, checkpoint_dir=ck,
                                   device="cpu")
    assert loaded == [[2]]
    for a, b in zip(resumed.pairs, full.pairs):
        np.testing.assert_array_equal(a.pose, b.pose)
        np.testing.assert_array_equal(a.benchmark_per_iteration, b.benchmark_per_iteration)
    loaded.clear()
    again = teth.align_eth_batch(seq, tcfg, batch_size=2, seed=4, checkpoint_dir=ck, device="cpu")
    assert loaded == [] and [p.index for p in again.pairs] == [0, 1, 2]
    assert again.min_error == resumed.min_error
    teth.align_eth_batch(seq, tcfg, batch_size=2, seed=5, checkpoint_dir=ck, device="cpu")
    assert loaded == [[0, 1], [2]]


def _graph_pair(rel, extra=None):
    o_j, g_j = jpg.sequential_graph(rel)
    o_t, g_t = tpg.sequential_graph(rel, device="cpu")
    if extra is not None:
        i, j, T = extra
        g_j = jpg.PoseGraph(jnp.concatenate([g_j.edge_i, jnp.array([i], jnp.int32)]),
                            jnp.concatenate([g_j.edge_j, jnp.array([j], jnp.int32)]),
                            jnp.concatenate([g_j.rel_poses, jnp.asarray(T)[None]]),
                            jnp.concatenate([g_j.weights, jnp.array([1.0], jnp.float32)]))
        g_t = tpg.PoseGraph(torch.cat([g_t.edge_i, torch.tensor([i])]),
                            torch.cat([g_t.edge_j, torch.tensor([j])]),
                            torch.cat([g_t.rel_poses, torch.from_numpy(T)[None]]),
                            torch.cat([g_t.weights, torch.tensor([1.0])]))
    return o_j, g_j, o_t, g_t


def _noisy_chain(n, seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix()
        T[:3, 3] = rng.normal(0, 1, 3)
        out.append(T.astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("dense", [True, False])
def test_pose_graph_refine_matches_jax(monkeypatch, dense):
    """A chain of 7 noisy edges and one loop closure that disagrees with it,
    through the dense solve and (threshold lowered) the matrix-free CG."""
    if not dense:
        monkeypatch.setattr(jpg, "DENSE_MAX_POSES", 2)
        monkeypatch.setattr(tpg, "DENSE_MAX_POSES", 2)
    rel = _noisy_chain(7, 21)
    closure = _noisy_chain(1, 22)[0]
    o_j, g_j, o_t, g_t = _graph_pair(rel, (1, 6, closure))
    np.testing.assert_array_equal(o_t, o_j)
    np.testing.assert_allclose(
        tpg.edge_residuals(torch.zeros(8, 6), torch.from_numpy(o_t), g_t).numpy(),
        np.asarray(jpg.edge_residuals(jnp.zeros((8, 6)), jnp.asarray(o_j), g_j)), atol=1e-6)
    rt = tpg.refine(o_t, g_t).numpy()
    rj = np.asarray(jpg.refine(o_j, g_j))
    np.testing.assert_allclose(rt, rj, atol=1e-5)
    assert np.abs(rt - o_t).max() > 1e-2          # the closure moved the chain
    r, Ji, Jj = tpg._edge_blocks(torch.from_numpy(o_t), g_t)
    assert Ji.dtype == Jj.dtype == r.dtype == torch.float32


def test_refine_trajectory_and_closures_match_jax(seq, same_route, port_batch_run):
    _, tcfg = _cfgs()
    run = port_batch_run
    od_t, ref_t, g_t = teth.refine_trajectory(run, device="cpu")
    od_j, ref_j, g_j = jeth.refine_trajectory(run)
    np.testing.assert_allclose(od_t, od_j, atol=1e-6)
    np.testing.assert_allclose(ref_t, ref_j, atol=1e-5)
    odo = np.stack([np.eye(4, dtype=np.float32)] * 6)
    for k in range(6):
        odo[k, :3, 3] = [0.4 * np.sin(k), 0.3 * k % 1.1, 0.0]
    for kw in ({}, dict(radius=0.5, min_separation=2, max_closures=1)):
        assert teth.find_loop_closures(odo, **kw) == jeth.find_loop_closures(odo, **kw)
    jcfg, _ = _cfgs()
    cands = [(0, 3)]
    loader_t = TLoader(seq, capacity=4608, device="cpu")
    loader_j = JLoader(seq, capacity=4608)
    e_t = teth.register_closures(loader_t, cands, tcfg, od_t)
    e_j = jeth.register_closures(loader_j, cands, jcfg, od_j)
    assert [e[:2] for e in e_t] == [e[:2] for e in e_j] == cands
    np.testing.assert_allclose(e_t[0][2], e_j[0][2], atol=POSE_ATOL)
    od2_t, ref2_t, g2_t = teth.refine_trajectory(run, extra_edges=e_t, device="cpu")
    od2_j, ref2_j, _ = jeth.refine_trajectory(run, extra_edges=e_t)
    assert g2_t.edge_i.shape[0] == N_PAIRS + 1
    np.testing.assert_allclose(ref2_t, ref2_j, atol=1e-5)


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]


def test_eth_cli_matches_jax(seq, same_route, tmp_path, monkeypatch):
    """`eth --batch` with --refine, its output line for line against JAX's
    (numbers within the registration tolerances; JAX shown one device, as
    the port refines on one), and the checkpoint flag refused without
    --batch, as JAX refuses it."""
    import jax

    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:1])
    argv = ["eth", seq, "--metric", "2", "--linear", "--iterations", str(N_ITER),
            "--batch", "2", "--refine", "--loop-closure-radius", "0.5"]
    jout = _cli(jmain.main, argv)
    tout = _cli(tmain.main, argv + ["--device", "cpu"])
    jl, tl = jout.splitlines(), tout.splitlines()
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert re.sub(r"-?\d+\.\d+(e-?\d+)?", "#", a) == re.sub(r"-?\d+\.\d+(e-?\d+)?", "#", b)
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-3, atol=1e-5, err_msg=a)
    assert "trajectory ATE vs GT (global convention)" in tout
    with pytest.raises(SystemExit, match="--checkpoint-dir requires the batched runner"):
        tmain.main(["eth", seq, "--checkpoint-dir", str(tmp_path), "--device", "cpu"])


def test_cli_refuses_without_card(seq):
    """The default device is the card: without one every command raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["eth", seq, "--batch", "2", "--iterations", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["bunny", "--iterations", "1"])
