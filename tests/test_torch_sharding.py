"""The port's sharded ICP driver against the JAX package's on the CPU.

The port runs on four gloo ranks (``scripts/multihost_rehearsal.py``,
rendezvous through a file under the test's temporary directory), a mesh of
2 ``pairs`` x 2 ``points``; the JAX package runs ``run_icp_batch_sharded``
on a (2, 2) mesh of tests/conftest.py's virtual devices. The ranks are
started once for the module, run every case in turn and write their
results; each case is one parametrised test. Data as
tests/test_sharding.py's ``_batch``: 4 pairs x 512 rows (384 for the
multires case, padded to 512), made from a numpy seed.

Tolerances: tests/test_sharding.py's own. Poses within rtol 1e-3 / atol
5e-5, RMSE and benchmark curves within rtol 1e-3 / atol 1e-5, match counts
equal in every iteration; the two ranks of a ``points`` group hold the
same poses and traces bit for bit. Both packages sum partial sums across
shards, in f32, in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from icp_variants_tpu.core.cloud import Cloud as JCloud
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import selection as jsel
from icp_variants_tpu.parallel import sharded_icp as jsh
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.core import cloud as tcloud
from icp_variants_tpu_torch.core.cloud import Cloud as TCloud
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.ops import selection as tsel
from icp_variants_tpu_torch.parallel import distributed as tdist
from icp_variants_tpu_torch.parallel import sharded_icp as tsh
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.scripts import multihost_rehearsal as rehearsal

torch.set_num_threads(2)

WORLD, MESH = 4, (2, 2)
N_PAIRS, CAP, N_ITER, P_RANDOM = 4, 512, 4, 0.5
RANKS_TIMEOUT_S = 240

# Data sets: name -> (numpy seed, rows a pair, kd indexes, JAX draws).
DATA = {
    "s0": (0, CAP, False, False),
    "s7": (7, CAP, False, False),
    "s9": (9, CAP, False, False),
    "s11": (11, CAP, False, False),
    "s5": (5, CAP, False, False),
    "s5_pad": (5, 384, False, False),
    "s3_kd": (3, CAP, True, False),
    "s9_kd": (9, CAP, True, False),
    "s2_rand": (2, CAP, False, True),
}
_SOLVERS = {f"{m.lower()}_{s.lower()}": ("s0", dict(metric=m, minimizer=s))
            for m in ("POINT_TO_POINT", "POINT_TO_PLANE", "SYMMETRIC")
            for s in ("LINEAR", "NONLINEAR_LM")}
# Case -> (data set, config fields; enums by name).
CASES = {
    **_SOLVERS,
    "trimmed": ("s7", dict(metric="POINT_TO_POINT", minimizer="LINEAR", trim_ratio=0.7)),
    "huber": ("s9", dict(metric="POINT_TO_POINT", minimizer="LINEAR", weighting="HUBER")),
    "tukey": ("s9", dict(metric="POINT_TO_POINT", minimizer="LINEAR", weighting="TUKEY")),
    "gicp": ("s11", dict(metric="GICP", minimizer="LINEAR")),
    "anderson": ("s5", dict(metric="POINT_TO_PLANE", minimizer="LINEAR", anderson_m=2,
                            n_iterations=6)),
    "multires_padded": ("s5_pad", dict(metric="POINT_TO_PLANE", minimizer="LINEAR",
                                       multi_resolution=True, n_iterations=6)),
    "kd_exact": ("s3_kd", dict(metric="POINT_TO_PLANE", minimizer="LINEAR")),
    "kd_checks16": ("s9_kd", dict(metric="POINT_TO_PLANE", minimizer="LINEAR",
                                  matching_checks=16)),
    "random_compacted": ("s2_rand", dict(metric="POINT_TO_PLANE", minimizer="LINEAR",
                                         selection="RANDOM", selection_proba=P_RANDOM)),
}


def _cfg(module, fields):
    kw = dict(max_distance=1.0, n_iterations=N_ITER, lm_max_inner_iterations=3)
    for k, v in fields.items():
        kw[k] = getattr(module, {"metric": "Metric", "minimizer": "Minimizer",
                                 "weighting": "Weighting", "selection": "Selection"}[k])[v] \
            if isinstance(v, str) else v
    return module.ICPConfig(**kw)


def _batch(n_pairs, cap, seed):
    """tests/test_sharding.py's ``_batch``: targets are the sources rotated
    0.05 rad about z and moved 0.01."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n_pairs, cap, 3)).astype(np.float32) * 0.1
    nrm = rng.standard_normal((n_pairs, cap, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    col = rng.integers(0, 256, (n_pairs, cap, 4)).astype(np.float32)
    valid = np.ones((n_pairs, cap), bool)
    ang = 0.05
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    return src, nrm, col, valid, src @ R.T + 0.01, nrm @ R.T, col, valid


def _jax_shard_draws(cap, n_iter, key):
    """The per-shard draws of the JAX runner (``icp.py:414-421``): pair b's
    key split per iteration and folded with the points shard's index, the
    gaps on the shard's capacity from its global row offset. Returns
    (B, points, T, k_cap) rows and flags."""
    q = MESH[1]
    local = cap // q
    k_cap = jicp._compact_capacity(local, P_RANDOM)
    assert k_cap == ticp._compact_capacity(local, P_RANDOM)
    rows = np.zeros((N_PAIRS, q, n_iter, k_cap), np.int32)
    flags = np.zeros((N_PAIRS, q, n_iter, k_cap), bool)
    for b, kb in enumerate(jax.random.split(key, N_PAIRS)):
        for t, kt in enumerate(jax.random.split(kb, n_iter)):
            for s in range(q):
                r, f = jsel.bernoulli_gap_indices(jax.random.fold_in(kt, s), P_RANDOM,
                                                  jnp.int32(1), local, k_cap,
                                                  index_offset=s * local)
                rows[b, s, t], flags[b, s, t] = np.asarray(r), np.asarray(f)
    return rows, flags


def _dataset(name):
    seed, cap, use_kd, draws = DATA[name]
    a = _batch(N_PAIRS, cap, seed)
    out = {f"src_{f}": x for f, x in zip(TCloud._fields, a[:4])}
    out.update({f"tgt_{f}": x for f, x in zip(TCloud._fields, a[4:])})
    out.update(gt_src=a[0], gt_tgt=a[4], gt_valid=a[3])
    jkds = None
    if use_kd:
        jkds = jkd.stack_kd_indexes([jkd.build_kd_index(a[4][b], a[7][b])
                                     for b in range(N_PAIRS)])
        for f, x in zip(tkd.KDIndex._fields, convert.kd_index_from_arrays(jkds, "cpu")):
            if x is not None:
                out[f"kd_{f}"] = x.numpy()
    if draws:
        out["rand_rows"], out["rand_flags"] = _jax_shard_draws(cap, N_ITER,
                                                               jax.random.PRNGKey(0))
    return out, jkds


@pytest.fixture(scope="module")
def data():
    return {name: _dataset(name) for name in DATA}


class _Ranks:
    """The four ranks running every case; :meth:`result` waits for them
    (once) and reads a case's per-rank results."""

    def __init__(self, root):
        self.root, self.procs, self.joined = root, None, False

    def result(self, name):
        if not self.joined:
            self.joined = True
            outs = rehearsal.join_ranks(self.procs, self.root, RANKS_TIMEOUT_S)
            assert all("CASES OK" in out for out in outs), outs
        return [dict(np.load(self.root / "out" / f"{name}.rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):
    root = tmp_path_factory.mktemp("sharding")
    for name, (arrays, _) in data.items():
        np.savez(root / f"{name}.npz", **arrays)
    rehearsal.write_spec(root, [
        dict(name=name, kind="icp", points_per_pair=MESH[1], data=f"{ds}.npz",
             cfg=_cfg(tconfig, fields), run_benchmark=True,
             **({"selected": "rand"} if DATA[ds][3] else {}))
        for name, (ds, fields) in CASES.items()])
    handle = _Ranks(root)
    handle.procs = rehearsal.start_ranks(WORLD, f"file://{root}/rdzv", root, cases=root,
                                         device="cpu")
    yield handle
    if not handle.joined:
        rehearsal.join_ranks(handle.procs, root, RANKS_TIMEOUT_S)


def _assemble(per_rank):
    """The batch's results from the ranks' shares; the ranks of a points
    group must hold the same bits."""
    out = {}
    for key in ("pose", "rmse", "benchmark", "num_matches"):
        parts = {}
        for r, res in enumerate(per_rank):
            lo, hi = (int(x) for x in res["pairs"])
            if (lo, hi) in parts:
                np.testing.assert_array_equal(res[key], parts[(lo, hi)],
                                              err_msg=f"{key}: rank {r} and its points group")
            parts[(lo, hi)] = res[key]
        assert sorted(parts) == [(0, 2), (2, 4)]
        out[key] = np.concatenate([parts[k] for k in sorted(parts)])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_run_matches_jax(data, ranks, name):
    ds, fields = CASES[name]
    arrays, jkds = data[ds]
    jmesh = jax.make_mesh(MESH, ("pairs", "points"), devices=jax.devices()[:WORLD])
    js = JCloud(*(jnp.asarray(arrays[f"src_{f}"]) for f in TCloud._fields))
    jt = JCloud(*(jnp.asarray(arrays[f"tgt_{f}"]) for f in TCloud._fields))
    jr = jsh.run_icp_batch_sharded(
        _cfg(jconfig, fields), js, jt, jmesh, gt_source_points=arrays["gt_src"],
        gt_target_points=arrays["gt_tgt"], gt_valid=arrays["gt_valid"],
        key=jax.random.PRNGKey(0), run_benchmark=True, kd_indexes=jkds)
    port = _assemble(ranks.result(name))
    assert port["num_matches"].shape == np.asarray(jr.trace.num_matches).shape
    np.testing.assert_array_equal(port["num_matches"], np.asarray(jr.trace.num_matches))
    np.testing.assert_allclose(port["pose"], np.asarray(jr.pose), rtol=1e-3, atol=5e-5)
    np.testing.assert_allclose(port["rmse"], np.asarray(jr.trace.rmse), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(port["benchmark"], np.asarray(jr.trace.benchmark),
                               rtol=1e-3, atol=1e-5)


def _tclouds(arrays):
    t = torch.from_numpy
    return (TCloud(*(t(arrays[f"src_{f}"]) for f in TCloud._fields)),
            TCloud(*(t(arrays[f"tgt_{f}"]) for f in TCloud._fields)))


def test_pad_cloud_rows_matches_jax():
    a = _batch(2, 300, seed=4)
    jc = jsh.pad_cloud_rows(JCloud(*(jnp.asarray(x) for x in a[:4])), 512)
    tc = tsh.pad_cloud_rows(TCloud(*(torch.from_numpy(x) for x in a[:4])), 512)
    assert tc.capacity == 512
    for f in TCloud._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    assert tsh.pad_cloud_rows(tc, 256) is tc


def test_indivisible_batch_raises_as_jax():
    a = _batch(3, 256, seed=1)
    jmesh = jax.make_mesh(MESH, ("pairs", "points"), devices=jax.devices()[:WORLD])
    jcfg, tcfg = _cfg(jconfig, {}), _cfg(tconfig, {})
    with pytest.raises(ValueError) as jerr:
        jsh.run_icp_batch_sharded(jcfg, JCloud(*(jnp.asarray(x) for x in a[:4])),
                                  JCloud(*(jnp.asarray(x) for x in a[4:])), jmesh)
    mesh = tdist.Mesh({"pairs": 2, "points": 2}, {"pairs": 0, "points": 0},
                      {"pairs": None, "points": None}, torch.device("cpu"))
    src, tgt = _tclouds({**{f"src_{f}": x for f, x in zip(TCloud._fields, a[:4])},
                         **{f"tgt_{f}": x for f, x in zip(TCloud._fields, a[4:])}})
    with pytest.raises(ValueError) as terr:
        tsh.run_icp_batch_sharded(tcfg, src, tgt, mesh)
    assert str(terr.value) == str(jerr.value)


def test_one_by_one_mesh_is_run_icp_batch(data):
    """Without a process group the mesh is 1 x 1 and the sharded driver is
    ``run_icp_batch`` bit for bit, generator draws included."""
    arrays, _ = data["s0"]
    src, tgt = _tclouds(arrays)
    cfg = _cfg(tconfig, dict(metric="SYMMETRIC", minimizer="LINEAR", selection="RANDOM",
                             selection_proba=P_RANDOM))
    gt = dict(gt_source_points=arrays["gt_src"], gt_target_points=arrays["gt_tgt"],
              gt_valid=arrays["gt_valid"])
    mesh = tdist.global_mesh(device="cpu")
    res, pairs = tsh.run_icp_batch_sharded(cfg, src, tgt, mesh, seed=3, run_benchmark=True, **gt)
    ref = ticp.run_icp_batch(cfg, src, tgt, seed=3, run_benchmark=True, device="cpu", **gt)
    assert pairs == slice(0, N_PAIRS)
    assert torch.equal(res.pose, ref.pose)
    for x, y in zip(res.trace, ref.trace):
        assert torch.equal(x, y)
    step = tsh.make_sharded_icp_step(cfg, mesh)(src, tgt, torch.eye(4).expand(N_PAIRS, 4, 4))
    one = ticp.run_icp_batch(cfg, src, tgt, strides=np.ones(1, np.int32), device="cpu")
    assert torch.equal(step.result.pose, one.pose)
    pair = [TCloud(*(f[1] for f in c)) for c in (src, tgt)]
    single = tsh.run_icp_sharded(cfg, *pair, mesh, seed=3)
    alone = ticp.run_icp(cfg, *pair, seed=3, num_source_points=CAP, device="cpu")
    assert torch.equal(single.pose, alone.pose)
    assert torch.equal(single.trace.num_matches, alone.trace.num_matches)


def test_two_shards_draw_differently():
    """Shard 0 draws as the unsharded run; shard 1's generator seed (from
    (seed, 1)) gives other gaps."""
    seeds = [tdist.shard_seed(7, s) for s in range(2)]
    assert seeds[0] == 7 and seeds[1] != 7

    def draw(seed, offset):
        g = torch.Generator().manual_seed(seed)
        return tsel.bernoulli_gap_indices(g, 0.05, 1, 4096, 512, offset, batch=(2,))[0]

    assert torch.equal(draw(seeds[0], 0), draw(7, 0))
    assert not torch.equal(draw(seeds[0], 0), draw(seeds[1], 4096))


def test_shard_draws_keep_the_unsharded_queries():
    """``shard_draws`` splits one run's draws over two shards: each shard's
    rows, moved by its offset, are the unsharded in-range rows in its half,
    in order."""
    g = torch.Generator().manual_seed(0)
    cap, p, t = 4096, 0.05, 3
    k = ticp._compact_capacity(cap, p)
    rows, flags = tsel.bernoulli_gap_indices(g, p, 1, cap, k * t, batch=(2,))
    rows, flags = rows.reshape(2, t, k), flags.reshape(2, t, k)
    srows, sflags = tsh.shard_draws(rows, flags, 2, cap // 2, p)
    assert srows.shape[:3] == (2, 2, t)
    for b in range(2):
        for i in range(t):
            want = rows[b, i][flags[b, i]]
            got = torch.cat([srows[b, s, i][sflags[b, s, i]] + s * cap // 2 for s in range(2)])
            assert torch.equal(got.to(want.dtype), want)
            assert bool((srows[b, :, i][~sflags[b, :, i]] == cap // 2 - 1).all())


def test_all_padding_shard_returns_misses(data):
    """A points shard of padding only (the sentinel rows ``pad_cloud_rows``
    adds): under SELECT_ALL its query mask is all false, the exact kd arm
    (box_topk, kd_block_search and the fallback, each in its plain version
    on the CPU) returns -1 on every row, and the run counts no match and
    keeps the pose."""
    arrays, _ = data["s3_kd"]
    src, tgt = _tclouds(arrays)
    # 256 real rows split over two points shards: the second is padding.
    m = tcloud.PAD_MULTIPLE
    padded = tsh.pad_cloud_rows(TCloud(*(f[:, :m] for f in src)), 2 * m)
    pad = TCloud(*(tsh._shard_rows(f, 2, 1, 0) for f in padded))
    assert pad.capacity == m and not bool(pad.valid.any())
    assert bool((pad.points == tcloud.PAD_SENTINEL).all())
    kd = tkd.KDIndex(*(None if f"kd_{f}" not in arrays else torch.from_numpy(arrays[f"kd_{f}"])
                       for f in tkd.KDIndex._fields))
    cfg = _cfg(tconfig, dict(metric="SYMMETRIC", minimizer="LINEAR"))
    res = ticp.run_icp_batch(cfg, pad, tgt, kd_indexes=kd, device="cpu")
    assert int(res.trace.num_matches.abs().sum()) == 0
    assert torch.equal(res.pose, torch.eye(4).expand(N_PAIRS, 4, 4))
    fidx = tknn.build_target_index(tgt.points, tile_t=tknn.V2_TILE_T)
    for checks in (0, 16):
        idx, _, valid = tkd.match_kd(pad.points, kd, fidx, cfg.max_distance,
                                     query_mask=pad.valid, checks=checks)
        assert not bool(valid.any()) and bool((idx == -1).all())
