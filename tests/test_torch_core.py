"""The PyTorch port's core, selection, weighting and rejection, held against
the JAX package on the CPU (small sizes, inputs from numpy seeds)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_variants_tpu.core import cloud as jcloud
from icp_variants_tpu.core import se3 as jse3
from icp_variants_tpu.ops import rejection as jrej
from icp_variants_tpu.ops import weighting as jw
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu_torch.core import cloud as tcloud
from icp_variants_tpu_torch.core import se3 as tse3
from icp_variants_tpu_torch.ops import rejection as trej
from icp_variants_tpu_torch.ops import selection as tsel
from icp_variants_tpu_torch.ops import weighting as tw
from icp_variants_tpu_torch.pipeline import config as tconfig

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.normal(0, 0.4, 3).astype(np.float32)
        R = np.asarray(jse3.axis_angle_to_matrix(jnp.asarray(w)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = rng.normal(0, 2.0, 3)
        out.append(T)
    return np.stack(out)


def test_config_defaults_match_field_for_field():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.ICPConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.ICPConfig)}
    assert jf == tf
    for enum_name in ("Selection", "Matching", "Weighting", "Metric", "Minimizer"):
        je, te = getattr(jconfig, enum_name), getattr(tconfig, enum_name)
        assert {m.name: m.value for m in je} == {m.name: m.value for m in te}


@pytest.mark.parametrize("with_extras", [False, True])
def test_from_numpy_morton_identical(with_extras):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    pts[7] = np.nan
    kw = {}
    if with_extras:
        kw = dict(normals=rng.normal(size=(1000, 3)).astype(np.float32),
                  colors=rng.uniform(0, 255, (1000, 3)).astype(np.float32),
                  valid=rng.random(1000) > 0.1)
    jc = jcloud.from_numpy(pts, morton_order=True, **kw)
    tc = tcloud.from_numpy(pts, morton_order=True, device="cpu", **kw)
    for name in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)), getattr(tc, name).numpy())


def test_stride_mask_and_schedule():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, (600, 3)).astype(np.float32)
    nrm = rng.normal(size=(600, 3)).astype(np.float32)
    nrm[::7] = np.nan
    jc = jcloud.from_numpy(pts, normals=nrm)
    tc = tcloud.from_numpy(pts, normals=nrm, device="cpu")
    for stride in (1, 2, 8):
        np.testing.assert_array_equal(
            np.asarray(jcloud.coarse_stride_mask(jc, stride, 3)),
            tcloud.coarse_stride_mask(tc, stride, 3).numpy())
    for args in ((365000, 50, True), (5000, 3, True), (5000, 20, False)):
        np.testing.assert_array_equal(
            jcloud.multires_stride_schedule(*args), tcloud.multires_stride_schedule(*args))


def test_se3_matches_jax():
    rng = np.random.default_rng(3)
    poses = _poses(3, 3)
    pts = rng.uniform(-20, 20, (3, 50, 3)).astype(np.float32)
    nrm = rng.normal(size=(3, 50, 3)).astype(np.float32)
    tp = tse3.transform_points(_t(pts), _t(poses))
    tn = tse3.transform_normals(_t(nrm), _t(poses))
    for i in range(3):
        np.testing.assert_allclose(
            tp[i].numpy(), np.asarray(jse3.transform_points(pts[i], poses[i])), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(
            tn[i].numpy(), np.asarray(jse3.transform_normals(nrm[i], poses[i])), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tse3.invert_pose(_t(poses[i])).numpy(), np.asarray(jse3.invert_pose(poses[i])),
            rtol=1e-5, atol=1e-6)
        R = poses[i][:3, :3]
        np.testing.assert_allclose(
            tse3.matrix_to_axis_angle(_t(R)).numpy(), np.asarray(jse3.matrix_to_axis_angle(R)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tse3.matrix_to_euler_xyz(_t(R)).numpy(), np.asarray(jse3.matrix_to_euler_xyz(R)),
            rtol=1e-5, atol=1e-6)
    ws = rng.normal(0, 0.5, (4, 3)).astype(np.float32)
    ws[0] = 0.0
    np.testing.assert_allclose(
        tse3.axis_angle_to_matrix(_t(ws)).numpy(),
        np.stack([np.asarray(jse3.axis_angle_to_matrix(w)) for w in ws]), rtol=1e-5, atol=1e-6)
    x = rng.normal(0, 0.3, 6).astype(np.float32)
    np.testing.assert_allclose(
        tse3.apply_increment(_t(x), _t(pts[0])).numpy(),
        np.asarray(jse3.apply_increment(x, pts[0])), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tse3.increment_to_matrix(_t(x)).numpy(), np.asarray(jse3.increment_to_matrix(x)),
        rtol=1e-5, atol=1e-6)
    mask = rng.random(50) > 0.3
    np.testing.assert_allclose(
        tse3.masked_mean(_t(pts[0]), _t(mask)).numpy(),
        np.asarray(jse3.masked_mean(pts[0], mask)), rtol=1e-5)


def test_gap_sampler_distribution():
    g = torch.Generator(device="cpu").manual_seed(5)
    p, cap, k_cap = 0.01, 200_000, 2560
    rows, in_range = tsel.bernoulli_gap_indices(g, p, 1, cap, k_cap, batch=(64,))
    assert rows.shape == (64, k_cap) and rows.dtype == torch.int32
    r = rows.numpy()
    ok = in_range.numpy()
    assert np.all(np.diff(r, axis=1) >= 0)
    assert np.all(np.diff(r, axis=1)[ok[:, 1:]] > 0)        # strictly ascending in range
    assert np.all(r[ok] < cap)
    counts = ok.sum(1)
    sigma = np.sqrt(cap * p * (1 - p))
    assert abs(counts.mean() - p * cap) < 4 * sigma / np.sqrt(64)
    assert abs(counts.std() - sigma) < 0.3 * sigma
    # Strided lattice: every in-range row sits on it.
    rows2, ok2 = tsel.bernoulli_gap_indices(g, 0.05, 4, cap, 4096, index_offset=1, batch=(2,))
    assert np.all((rows2.numpy()[ok2.numpy()] + 1) % 4 == 0)


def test_random_indices_stratified():
    g = torch.Generator(device="cpu").manual_seed(6)
    idx, mask = tsel.random_indices(g, 1000, 100, 128, batch=(3,))
    i = idx.numpy()
    assert mask.numpy()[:, :100].all() and not mask.numpy()[:, 100:].any()
    assert np.all(i[:, :100] // 10 == np.arange(100))


def _match_arrays(seed, n=300):
    rng = np.random.default_rng(seed)
    src = rng.normal(0, 1, (n, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    sn = rng.normal(size=(n, 3)).astype(np.float32)
    tn = (sn + rng.normal(0, 0.8, (n, 3))).astype(np.float32)
    sn[::11] = np.nan
    sc = rng.integers(0, 256, (n, 4)).astype(np.float32)
    tc = rng.integers(0, 256, (n, 4)).astype(np.float32)
    valid = rng.random(n) > 0.2
    return src, tgt, sn, tn, sc, tc, valid


@pytest.mark.parametrize("method", list(tconfig.Weighting))
def test_weighting_matches_jax(method):
    arrays = _match_arrays(7)
    jm = jw.MatchArrays(*(jnp.asarray(a) for a in arrays))
    tm = tw.MatchArrays(*(_t(a) for a in arrays))
    jv = np.asarray(jw.apply_weights(jconfig.Weighting(int(method)), jm, 2.0))
    tv = tw.apply_weights(method, tm, 2.0).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_rejection_matches_jax():
    src, tgt, sn, tn, _, _, valid = _match_arrays(8)
    np.testing.assert_array_equal(
        trej.normal_angle_mask(_t(sn), _t(tn), _t(valid)).numpy(),
        np.asarray(jrej.normal_angle_mask(sn, tn, valid)))
    d2 = ((src - tgt) ** 2).sum(1)
    for ratio in (0.5, 0.9):
        np.testing.assert_array_equal(
            trej.trimmed_mask(_t(d2), _t(valid), ratio, 4.0).numpy(),
            np.asarray(jrej.trimmed_mask(d2, valid, ratio, 4.0)))


def test_port_imports_no_jax():
    """Importing the port (every module, and chip_smoke) and running its CLI's
    ``--help`` leave jax, the JAX package and bench.py out of sys.modules;
    ``icp_variants_tpu`` is a prefix of the port's own name, so the check is
    on the module itself and its submodules."""
    code = (
        "import sys, pkgutil, importlib, contextlib, io\n"
        "import icp_variants_tpu_torch, icp_variants_tpu_torch.convert\n"
        "for m in pkgutil.walk_packages(icp_variants_tpu_torch.__path__,\n"
        "                               'icp_variants_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from icp_variants_tpu_torch.__main__ import main\n"
        "for argv in (['--help'], ['eth', '--help'], ['room', '--help']):\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        try:\n"
        "            main(argv)\n"
        "        except SystemExit:\n"
        "            pass\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'bench'\n"
        "       or m == 'icp_variants_tpu' or m.startswith('icp_variants_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
