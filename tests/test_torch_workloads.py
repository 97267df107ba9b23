"""The port's TUM room tracker, experiments runner, analysis tools and
CLI commands against the JAX package on the CPU (``align_bunny``'s
artifacts are in tests/test_torch_bunny.py).

Data: two small TUM sequences written by the test (a wavy surface seen by
a camera moving along x, 48 x 64 pixels, the sensor shrunk to that size in
both packages as tests/test_workloads.py does), the repository's bunny
halves and experiment CSVs.

Tolerances: the room runs' poses agree to atol 1e-5 and their RMSE curves
to rtol 1e-4 with atol 1e-6 (f32 sums in different orders; the k-NN arm
also matches through different exact matchers, JAX's summing the
expansion, which agree here on every row); bunny runs as
tests/test_torch_bunny.py holds them (final RMSE within 1%, which its
pose gaps imply); artifacts written from the same clouds are equal bit
for bit, those of the moved source within the pose gap; analysis tools
exactly.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from icp_variants_tpu import __main__ as jmain
from icp_variants_tpu.analysis import compare_variants as jcompare
from icp_variants_tpu.analysis import convert as jconvert
from icp_variants_tpu.analysis import errors_statistic as jstats
from icp_variants_tpu.data import tum as jtum
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.workloads import experiments as jexp
from icp_variants_tpu.workloads import room as jroom
from icp_variants_tpu_torch import __main__ as tmain
from icp_variants_tpu_torch.analysis import compare_variants as tcompare
from icp_variants_tpu_torch.analysis import convert as tconvert
from icp_variants_tpu_torch.analysis import errors_statistic as tstats
from icp_variants_tpu_torch.analysis import generate_plot as tplot
from icp_variants_tpu_torch.data import mesh as tmesh
from icp_variants_tpu_torch.data import tum as ttum
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.workloads import experiments as texp
from icp_variants_tpu_torch.workloads import room as troom

torch.set_num_threads(2)

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tum(root, n_frames=3, shift_per_frame=0.005):
    """A wavy surface translated along +x each frame, with its trajectory
    (tests/test_workloads.py's sequence)."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    fx, fy = 525.0 * W / 640, 525.0 * H / 480
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    lines = {"depth.txt": [], "rgb.txt": [], "groundtruth.txt": []}
    rng = np.random.default_rng(0)
    for i in range(n_frames):
        ts = 100.0 + i * 0.1
        shift = shift_per_frame * i
        z = np.full((H, W), 2.0)
        for _ in range(8):
            x_world = (uu - cx) / fx * z - shift
            y_world = (vv - cy) / fy * z
            z = 2.0 + 0.12 * np.sin(4.0 * x_world) * np.cos(4.0 * y_world)
        Image.fromarray(np.round(z * 5000).astype(np.uint16)).save(
            os.path.join(root, f"depth/{i}.png"))
        Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8), "RGB").save(
            os.path.join(root, f"rgb/{i}.png"))
        lines["depth.txt"].append(f"{ts} depth/{i}.png")
        lines["rgb.txt"].append(f"{ts} rgb/{i}.png")
        lines["groundtruth.txt"].append(f"{ts} {-shift} 0 0 0 0 0 1")
    for name, rows in lines.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("# h\n# h\n# h\n" + "\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tum"))
    write_tum(d)
    return d


@pytest.fixture
def small_sensor(monkeypatch):
    """Both packages' sensors at the sequence's resolution."""
    for mod in (jtum, ttum):
        init = mod.VirtualSensor.__init__

        def patched(self, dataset_dir, increment=1, width=640, height=480, _init=init):
            _init(self, dataset_dir, increment=increment, width=W, height=H)

        monkeypatch.setattr(mod.VirtualSensor, "__init__", patched)


def _room_cfgs(matching):
    kw = dict(n_iterations=10, max_distance=0.1)
    j = jroom.default_config(metric=jconfig.Metric.POINT_TO_PLANE,
                             minimizer=jconfig.Minimizer.LINEAR,
                             matching=jconfig.Matching(int(matching)), **kw)
    t = troom.default_config(metric=tconfig.Metric.POINT_TO_PLANE,
                             minimizer=tconfig.Minimizer.LINEAR, matching=matching, **kw)
    return j, t


@pytest.mark.parametrize("matching", [tconfig.Matching.KNN, tconfig.Matching.PROJECTIVE])
def test_reconstruct_room_matches_jax(tum_dir, small_sensor, tmp_path, matching):
    """Two tracked frames against frame 0; the projective run also writes
    its per-frame meshes, equal to JAX's."""
    jcfg, tcfg = _room_cfgs(matching)
    art = matching == tconfig.Matching.PROJECTIVE
    jr = jroom.reconstruct_room(tum_dir, jcfg, frame_step=1, max_frames=1, seed=0,
                                artifacts_dir=str(tmp_path / "j") if art else None)
    tr = troom.reconstruct_room(tum_dir, tcfg, frame_step=1, max_frames=1, seed=0,
                                artifacts_dir=str(tmp_path / "t") if art else None,
                                device="cpu")
    assert len(tr.final_rmse) == len(jr.final_rmse) == 2
    np.testing.assert_allclose(tr.initial_rmse, jr.initial_rmse, rtol=1e-5)
    for a, b in zip(tr.rmse_per_frame, jr.rmse_per_frame):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    for a, b in zip(tr.estimated_poses, jr.estimated_poses):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for init_r, final_r in zip(tr.initial_rmse, tr.final_rmse):
        assert final_r < max(init_r, 1e-4) * 0.95
    if art:
        names = sorted(os.listdir(tmp_path / "t"))
        assert names == sorted(os.listdir(tmp_path / "j")) == ["mesh_0.off", "mesh_1.off",
                                                               "mesh_2.off"]
        for n in names:
            tm, jm = tmesh.TriMesh.load(str(tmp_path / "t" / n)), tmesh.TriMesh.load(
                str(tmp_path / "j" / n))
            np.testing.assert_array_equal(tm.triangles, jm.triangles)
            np.testing.assert_allclose(tm.vertices, jm.vertices, atol=1e-4)


def _exp_csv(path, rows):
    with open(path, "w") as f:
        f.write("expName,expType,useLinear,useMetric,matchingMethod,selectionMethod,"
                "weightingMethod,useMultiresolution,numIterations,maxMatchingDist,"
                "samplingProba\n")
        f.write("\n".join(rows) + "\n")


def test_run_experiments_matches_jax_and_resumes(tmp_path, tum_dir, small_sensor):
    """A bunny row, a room row and an ETH row without its CSV (skipped):
    the summaries and error files against JAX's, then a rerun that skips
    every completed row."""
    csv = str(tmp_path / "exp.csv")
    _exp_csv(csv, ["b0,bunny,1,1,0,0,0,0,5,0.0003,1.0", "r0,room,1,1,0,0,0,0,4,0.1,1.0",
                   "e0,eth,1,2,0,0,0,0,4,10,1.0"])
    js = jexp.run_experiments(csv, out_dir=str(tmp_path / "j"), room_data_dir=tum_dir)
    ts = texp.run_experiments(csv, out_dir=str(tmp_path / "t"), room_data_dir=tum_dir,
                              device="cpu")
    assert ts.keys() == js.keys() == {"b0:0", "r0:1", "e0:2"}
    assert ts["e0:2"] == js["e0:2"] == {"type": "eth", "skipped": "no eth_csv_path"}
    np.testing.assert_allclose(ts["b0:0"]["final_rmse"], js["b0:0"]["final_rmse"], rtol=1e-2)
    assert ts["b0:0"]["config"] == js["b0:0"]["config"]
    assert ts["r0:1"]["final_rmse"] == [] and js["r0:1"]["final_rmse"] == []
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "b0_RMSE.txt"),
                               np.loadtxt(tmp_path / "j" / "b0_RMSE.txt"), rtol=1e-2)
    rmse_path = tmp_path / "t" / "b0_RMSE.txt"
    mtime = os.path.getmtime(rmse_path)
    again = texp.run_experiments(csv, out_dir=str(tmp_path / "t"), room_data_dir=tum_dir,
                                 device="cpu")
    assert again == ts and os.path.getmtime(rmse_path) == mtime


def test_experiment_rows_and_failures(tmp_path):
    """Both shipped matrices parse as JAX's do; a crashing row is recorded
    and the sweep goes on."""
    for name in ("experiment.csv", "bunny_experiments.csv"):
        path = os.path.join(REPO, "assets", name)
        for t, j in zip(texp.read_experiment_csv(path), jexp.read_experiment_csv(path)):
            assert (t.name, t.exp_type) == (j.name, j.exp_type)
            assert t.config.describe() == j.config.describe()
    csv = str(tmp_path / "bad.csv")
    _exp_csv(csv, ["b0,bunny,1,1,0,0,0,0,2,0.0003,1.0", "x,nosuch,1,1,0,0,0,0,2,0.1,1.0"])
    s = texp.run_experiments(csv, out_dir=str(tmp_path / "o"), bunny_data_dir="/nonexistent",
                             device="cpu")
    assert "error" in s["b0:0"] and s["x:1"] == {"skipped": "unknown expType 'nosuch'"}
    texp.write_error_file(str(tmp_path / "e.txt"), np.array([[1.5, 2e-7], [3.0, 4.0]]))
    jexp.write_error_file(str(tmp_path / "j.txt"), np.array([[1.5, 2e-7], [3.0, 4.0]]))
    assert (tmp_path / "e.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_analysis_tools_match_jax(tmp_path):
    src = tmp_path / "poses.txt"
    src.write_text("1 2.5 -3\n\n4 5e-3 6\n")
    tconvert.convert(str(src), str(tmp_path / "t.csv"))
    jconvert.convert(str(src), str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text() == \
        "1,2.5,-3\n4,5e-3,6\n"
    assert tconvert.main([]) == 2
    vals = np.random.default_rng(0).normal(0, 1, 101)
    for arr in (vals, vals[:1], vals[:0]):
        assert tstats.describe(arr) == jstats.describe(arr)
    np.savetxt(tmp_path / "a_RMSE.txt", vals)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tstats.main([str(tmp_path / "a_RMSE.txt")]) == 0
    assert "count" in out.getvalue() and "  max:" in out.getvalue()
    tplot.plot_curves([str(tmp_path / "a_RMSE.txt")], ["a"], str(tmp_path / "c.png"), logy=False)
    assert (tmp_path / "c.png").stat().st_size > 1000
    assert tplot.main([str(tmp_path / "a_RMSE.txt"), "--labels", "a", "b"]) == 2
    assert list(tcompare.VARIANTS) == list(jcompare.VARIANTS)
    for name, cfg in tcompare.VARIANTS.items():
        assert cfg.describe() == jcompare.VARIANTS[name].describe()


def test_compare_variants_matches_jax(tmp_path):
    names = ["point_linear", "plane_linear"]
    ts = tcompare.run_variants(names, str(tmp_path / "t"), device="cpu")
    js = jcompare.run_variants(names, str(tmp_path / "j"))
    for n in names:
        np.testing.assert_allclose(ts[n]["final_rmse"], js[n]["final_rmse"], rtol=1e-2)
        assert abs(ts[n]["iters_to_90pct"] - js[n]["iters_to_90pct"]) <= 1
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / f"{n}_RMSE.txt"),
                                   np.loadtxt(tmp_path / "j" / f"{n}_RMSE.txt"), rtol=1e-2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcompare.main(["--list"]) == 0
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jcompare.main(["--list"]) == 0
    assert out.getvalue() == jout.getvalue()


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _same_lines(tout, jout, rtol):
    tl, jl = tout.splitlines(), jout.splitlines()
    assert len(tl) == len(jl)
    num = r"-?\d+\.\d+(?:e-?\d+)?"
    for a, b in zip(tl, jl):
        assert re.sub(num, "#", a) == re.sub(num, "#", b)
        np.testing.assert_allclose([float(x) for x in re.findall(num, a)],
                                   [float(x) for x in re.findall(num, b)], rtol=rtol, atol=1e-6)


def test_cli_bunny_room_experiments_match_jax(tmp_path, tum_dir, small_sensor):
    argv = ["bunny", "--linear", "--iterations", "5", "--artifacts-dir", str(tmp_path / "a")]
    _same_lines(_cli(tmain.main, argv + ["--device", "cpu"]), _cli(jmain.main, argv), 1e-2)
    assert os.path.exists(tmp_path / "a" / "bunny_icp.off")
    argv = ["room", tum_dir, "--projective", "--linear", "--metric", "1", "--frame-step", "1",
            "--max-frames", "1", "--iterations", "6"]
    _same_lines(_cli(tmain.main, argv + ["--device", "cpu"]), _cli(jmain.main, argv), 1e-3)
    csv = str(tmp_path / "exp.csv")
    _exp_csv(csv, ["b1,bunny,1,2,0,0,1,0,3,0.0003,1.0"])
    tout = _cli(tmain.main, ["experiments", csv, "--out-dir", str(tmp_path / "t"),
                             "--device", "cpu"])
    jout = _cli(jmain.main, ["experiments", csv, "--out-dir", str(tmp_path / "j")])
    ts, js = json.loads(tout), json.loads(jout)
    assert ts.keys() == js.keys() and ts["b1:0"]["config"] == js["b1:0"]["config"]
    np.testing.assert_allclose(ts["b1:0"]["final_rmse"], js["b1:0"]["final_rmse"], rtol=1e-2)
