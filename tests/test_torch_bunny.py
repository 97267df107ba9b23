"""The port's bunny workload and one-call API against the JAX package on
the CPU, on the repository's bunny halves (``assets/bunny``): OFF io,
meshes, mesh vertex normals, the loader, ``workloads.bunny.align_bunny``
and ``api.register``.

Tolerances:
* io, meshes, vertex normals and the loader's clouds: equal bit for bit;
* ``align_bunny`` against JAX's run: JAX's CPU matcher without a kd index
  sums the expansion, the port (and JAX's TPU kernel) direct differences
  (ROADMAP.md queue 3), so match counts may differ by a few rows (at most
  5 an iteration) and the final poses by ``POSE_GAP`` per configuration
  (the port's CPU readings: 1.4e-4 LM point-to-point, 8e-5 linear, 2e-7
  GICP, 1.1e-3 with Anderson acceleration, whose extrapolation amplifies
  the LM solves' f32 rounding: its step alone agrees with JAX's to 1e-8
  on the same inputs); the final RMSE under tests/test_icp_bunny.py's
  ``CONVERGED_RMSE`` for the metric (GICP: the plane metrics' 1e-3);
* with one kd index built by JAX and carried across (both sides then sum
  direct differences), match counts equal and poses within ``TIGHT_GAP``
  (readings 2.1e-5, 1.4e-6, 6e-8, 1.8e-7); Anderson equal for its first 4
  iterations (RMSE rtol 1e-5), then as above;
* ``register`` as ``align_bunny``, its PCA normals as
  tests/test_torch_normals.py holds them.
"""

import os

import jax
import numpy as np
import pytest
import torch

from icp_variants_tpu import api as japi
from icp_variants_tpu.core import cloud as jcloud
from icp_variants_tpu.data import mesh as jmesh
from icp_variants_tpu.data import off_io as joff
from icp_variants_tpu.data import ply_io as jply
from icp_variants_tpu.data.loaders import BunnyDataLoader as JLoader
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu.workloads import bunny as jbunny
from icp_variants_tpu_torch import api as tapi
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.core import cloud as tcloud
from icp_variants_tpu_torch.data import mesh as tmesh
from icp_variants_tpu_torch.data import off_io as toff
from icp_variants_tpu_torch.data import ply_io as tply
from icp_variants_tpu_torch.data.loaders import ASSET_ROOT
from icp_variants_tpu_torch.data.loaders import BunnyDataLoader as TLoader
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.workloads import bunny as tbunny

torch.set_num_threads(2)

HALVES = [os.path.join(ASSET_ROOT, "bunny", f) for f in ("bunny_part1.off",
                                                          "bunny_part2_trans.off")]
RUNS = {
    "default": {},
    "p2p_linear": {"minimizer": "LINEAR"},
    "gicp_linear": {"metric": "GICP", "minimizer": "LINEAR"},
    "gicp_lm": {"metric": "GICP"},
    "p2p_lm_aa2": {"anderson_m": 2},
}
POSE_GAP = {"default": 5e-4, "p2p_linear": 5e-4, "gicp_linear": 1e-5, "gicp_lm": 1e-5,
            "p2p_lm_aa2": 5e-3}
TIGHT_GAP = {"default": 1e-4, "p2p_linear": 1e-5, "gicp_linear": 1e-6, "gicp_lm": 1e-6}
CONVERGED_RMSE = {"POINT_TO_POINT": 5.0e-3, "GICP": 1.0e-3}


def _cfg(config, bunny, name):
    change = {k: getattr(getattr(config, k.capitalize()), v) if isinstance(v, str) else v
              for k, v in RUNS[name].items()}
    return bunny.default_config(**change)


# ---------------------------------------------------------------------------
# Host data: OFF io, meshes, vertex normals, the loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", HALVES, ids=["part1", "part2_trans"])
def test_off_io_matches_jax(path, tmp_path):
    t, j = toff.read_off(path), joff.read_off(path)
    assert t.vertices.dtype == np.float32 and t.triangles.dtype == np.int32
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.triangles, j.triangles)
    np.testing.assert_array_equal(t.vertex_colors, j.vertex_colors)
    for colors in (t.vertex_colors, None):
        toff.write_off(tmp_path / "t.off", t.vertices, t.triangles, colors)
        joff.write_off(tmp_path / "j.off", j.vertices, j.triangles, colors)
        assert (tmp_path / "t.off").read_bytes() == (tmp_path / "j.off").read_bytes()
        back = toff.read_off(str(tmp_path / "t.off"))
        np.testing.assert_array_equal(back.vertices, t.vertices)
        np.testing.assert_array_equal(back.triangles, t.triangles)


@pytest.mark.parametrize("path", HALVES, ids=["part1", "part2_trans"])
def test_mesh_vertex_normals_match_jax(path):
    m = toff.read_off(path)
    tn = tcloud.mesh_vertex_normals(m.vertices, m.triangles)
    np.testing.assert_array_equal(tn, jcloud.mesh_vertex_normals(m.vertices, m.triangles))
    assert tn.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0, atol=1e-6)


def test_mesh_helpers_match_jax(tmp_path):
    """TriMesh io and transform, join_meshes, the marker geometries and an
    RGB-D triangulation, array for array."""
    def same(a, b):
        for f in ("vertices", "triangles", "colors"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)

    t, j = tmesh.TriMesh.load(HALVES[1]), jmesh.TriMesh.load(HALVES[1])
    same(t, j)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, 0.05]
    same(t.transformed(pose), j.transformed(pose))
    same(tmesh.join_meshes(t, tmesh.TriMesh.load(HALVES[0]), pose_a=pose),
         jmesh.join_meshes(j, jmesh.TriMesh.load(HALVES[0]), pose_a=pose))
    same(tmesh.sphere(np.array([0.1, 0.2, 0.3]), 0.003),
         jmesh.sphere(np.array([0.1, 0.2, 0.3]), 0.003))
    same(tmesh.camera_marker(pose), jmesh.camera_marker(pose))
    same(tmesh.cylinder([0, 0, 0], [0.1, 0.2, 0.3], 0.01),
         jmesh.cylinder([0, 0, 0], [0.1, 0.2, 0.3], 0.01))
    rng = np.random.default_rng(0)
    depth = (1.0 + 0.01 * rng.random((12, 16))).astype(np.float32)
    depth[3, 4] = np.nan
    color = rng.integers(0, 255, (12, 16, 4), dtype=np.uint8)
    K = np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]])
    same(tmesh.from_rgbd_frame(depth, color, K, np.eye(4)),
         jmesh.from_rgbd_frame(depth, color, K, np.eye(4)))
    t.write(str(tmp_path / "t.off"))
    j.write(str(tmp_path / "j.off"))
    assert (tmp_path / "t.off").read_bytes() == (tmp_path / "j.off").read_bytes()


def test_bunny_loader_matches_jax():
    tl, jl = TLoader(device="cpu"), JLoader()
    ts, js = tl.get_item(0), jl.get_item(0)
    for t, j in ((ts.source, js.source), (ts.target, js.target)):
        for f in ("points", "normals", "colors", "valid"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    np.testing.assert_array_equal(ts.pose, js.pose)
    for a, b in zip(tl.gt_correspondences(), jl.gt_correspondences()):
        np.testing.assert_array_equal(a, b)
    assert len(tl) == 1 and tl[0].source.capacity == 1280
    with pytest.raises(IndexError):
        tl.get_item(1)


# ---------------------------------------------------------------------------
# align_bunny and register
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_align_bunny_matches_jax(name):
    tcfg, jcfg = _cfg(tconfig, tbunny, name), _cfg(jconfig, jbunny, name)
    t = tbunny.align_bunny(tcfg, device="cpu")
    j = jbunny.align_bunny(jcfg)
    assert np.abs(t.num_matches - j.num_matches).max() <= 5
    assert np.abs(t.pose.astype(np.float64) - j.pose).max() <= POSE_GAP[name]
    assert t.final_rmse < CONVERGED_RMSE[tcfg.metric.name], t.rmse_per_iteration
    assert t.final_rmse < 0.5 * t.rmse_per_iteration[0]
    R = t.pose[:3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_align_bunny_with_shared_kd_index_matches_jax(name):
    """Both packages match through one kd index built by JAX (built below
    the production size with ``min_points=0``) and carried across, so both
    sum direct differences: a tight comparison of everything else."""
    tcfg, jcfg = _cfg(tconfig, tbunny, name), _cfg(jconfig, jbunny, name)
    jl = JLoader()
    s = jl.get_item(0)
    gs, gt = jl.gt_correspondences()
    kd = jicp.build_kd_for(jcfg, s.target, min_points=0)
    assert kd is not None
    eye = np.eye(4, dtype=np.float32)
    j = jicp.run_icp(jcfg, s.source, s.target, init_pose=eye, gt_source_points=gs,
                     gt_target_points=gt, key=jax.random.PRNGKey(0), kd_index=kd)
    t = ticp.run_icp(tcfg, convert.cloud_from_arrays(s.source, "cpu"),
                     convert.cloud_from_arrays(s.target, "cpu"), init_pose=eye,
                     gt_source_points=gs, gt_target_points=gt,
                     kd_index=convert.kd_index_from_arrays(kd, "cpu"), device="cpu")
    jrmse, trmse = np.asarray(j.trace.rmse), t.trace.rmse.numpy()
    if name in TIGHT_GAP:
        np.testing.assert_array_equal(t.trace.num_matches.numpy(), np.asarray(j.trace.num_matches))
        np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=TIGHT_GAP[name])
        np.testing.assert_allclose(trmse, jrmse, rtol=1e-3, atol=1e-7)
    else:
        np.testing.assert_allclose(trmse[:4], jrmse[:4], rtol=1e-5)
        assert np.abs(t.pose.numpy() - np.asarray(j.pose)).max() <= POSE_GAP[name]
        assert trmse[-1] < CONVERGED_RMSE["POINT_TO_POINT"]


def test_register_matches_jax():
    """api.register on the halves' vertices with no normals (the dense k-NN
    PCA path below 20,000 points) and the GT pairs as the oracle."""
    jl = JLoader()
    src, tgt = jl.source_mesh.vertices, jl.target_mesh.vertices
    gs, gt = jl.gt_correspondences()
    t = tapi.register(src, tgt, tbunny.default_config(), gt_source_points=gs,
                      gt_target_points=gt, device="cpu")
    j = japi.register(src, tgt, jbunny.default_config(), gt_source_points=gs,
                      gt_target_points=gt)
    assert np.abs(t.num_matches - j.num_matches).max() <= 5
    assert np.abs(t.pose.astype(np.float64) - j.pose).max() <= POSE_GAP["default"]
    assert t.final_rmse < CONVERGED_RMSE["POINT_TO_POINT"]
    assert t.rmse.shape == (20,) and np.all(t.benchmark_error == 0)
    # Without an oracle the curve is the source's motion from its start.
    m = tapi.register(src, tgt, tbunny.default_config(n_iterations=3), device="cpu")
    assert m.rmse.shape == (3,) and m.rmse[-1] > 0


def test_register_large_cloud_takes_fast_normals_and_kd_path(monkeypatch):
    """At 20,000 points or more register estimates normals by the
    Morton-banded path and matches through a kd index; a sheet moved by a
    known pose registers back to it (symmetric linear, p = 0.05)."""
    import bench
    from icp_variants_tpu_torch.ops import normals as tnormals

    calls = []
    fast = tnormals.estimate_normals_knn_fast
    monkeypatch.setattr(tnormals, "estimate_normals_knn_fast",
                        lambda *a, **k: calls.append(len(a[0])) or fast(*a, **k))
    tp, _ = bench.synth_cloud(20_000, 0)
    T = bench.eth_true_pose(0)
    sp = (tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    cfg = tconfig.ICPConfig(metric=tconfig.Metric.SYMMETRIC, minimizer=tconfig.Minimizer.LINEAR,
                            selection=tconfig.Selection.RANDOM, selection_proba=0.05,
                            n_iterations=15, max_distance=10.0)
    kd_calls = []
    build = ticp.build_kd_for
    monkeypatch.setattr(ticp, "build_kd_for",
                        lambda *a, **k: kd_calls.append(build(*a, **k)) or kd_calls[-1])
    res = tapi.register(sp, tp, cfg, device="cpu", seed=1)
    assert calls == [20_000, 20_000] and kd_calls[0] is not None
    resid = res.pose.astype(np.float64) @ T.astype(np.float64)
    assert np.abs(resid[:3, 3]).max() < 1e-3


def test_align_bunny_artifacts_are_not_ported(tmp_path):
    """(Kept name: the artifacts were not ported before.) align_bunny's
    artifacts against JAX's: the same files; source and target clouds
    equal bit for bit, the moved source within the runs' pose gap; the
    joined mesh of the same size; RMSE.txt the run's curve."""
    jbunny.align_bunny(artifacts_dir=str(tmp_path / "j"))
    run = tbunny.align_bunny(artifacts_dir=str(tmp_path / "t"), device="cpu")
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "RMSE.txt", "bunny_final_source.ply", "bunny_icp.off", "bunny_source.ply",
        "bunny_target.ply"]
    for n in ("bunny_source.ply", "bunny_target.ply"):
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()
    a = tply.read_ply(str(tmp_path / "t" / "bunny_final_source.ply"))
    b = jply.read_ply(str(tmp_path / "j" / "bunny_final_source.ply"))
    np.testing.assert_allclose(a["points"], b["points"], atol=1e-3)
    np.testing.assert_allclose(a["normals"], b["normals"], atol=1e-3)
    tm = tmesh.TriMesh.load(str(tmp_path / "t" / "bunny_icp.off"))
    jm = tmesh.TriMesh.load(str(tmp_path / "j" / "bunny_icp.off"))
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    np.testing.assert_array_equal(tm.colors, jm.colors)
    np.testing.assert_allclose(tm.vertices, jm.vertices, atol=1e-3)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "RMSE.txt"), run.rmse_per_iteration,
                               rtol=1e-5)


@pytest.mark.cuda
def test_align_bunny_on_card_matches_cpu():
    """align_bunny on the card (visited_search) against the port's own CPU
    run (its plain version). The card's f32 reductions (the LM solver's
    products) sum in another order: equal match counts and poses within
    1e-5 (card readings, NVIDIA H100 80GB HBM3: 1.8e-7, 3.2e-6, 6e-8,
    1.2e-7), except under Anderson acceleration, whose extrapolation
    amplifies that rounding along the halves' slide: there up to 10 rows an
    iteration and 2e-2 (reading: 5 rows, 6.7e-3; against JAX's CPU run the
    card reads 7.7e-3, the CPU port 1.1e-3), the final RMSE within 10% of
    the CPU run's. Every final RMSE under the metric's bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in RUNS:
        cfg = _cfg(tconfig, tbunny, name)
        g = tbunny.align_bunny(cfg, device="cuda")
        c = tbunny.align_bunny(cfg, device="cpu")
        rows = int(np.abs(g.num_matches - c.num_matches).max())
        gap = float(np.abs(g.pose.astype(np.float64) - c.pose).max())
        chaotic = cfg.anderson_m > 0
        assert rows <= (10 if chaotic else 0), (name, rows)
        assert gap <= (2e-2 if chaotic else 1e-5), (name, gap)
        assert abs(g.final_rmse / c.final_rmse - 1.0) <= 0.1, name
        assert g.final_rmse < CONVERGED_RMSE[cfg.metric.name], name
