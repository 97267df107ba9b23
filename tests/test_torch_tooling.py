"""The port's measurement slice against the JAX package on the CPU: the
visit lists, the stage probes of the driver, the fused stage profiler and
its work model, the kd block search's probe, and (with the kd path's trim
parity) the driver's trimmed arm. The ablation kernel's tests are in
``tests/test_torch_ablate.py``.

Tolerances: lower bounds from JAX's jitted sums may differ from the port's
step-by-step rounding by one ulp per fused add, so suffix lists are held
to 2 ulp; stage checksums are sums over thousands of rows taken in another
order, held to rtol 1e-5 (1e-6 for the matching stage, whose index sum is
exact); poses of runs that agree in every match to atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from icp_variants_tpu.core import cloud as jcloud
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu.pipeline import profiling as jprof
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.pipeline import profiling as tprof

torch.set_num_threads(2)

N_POINTS, MAXD = 4096, 10.0


# ---------------------------------------------------------------------------
# Visit lists
# ---------------------------------------------------------------------------


def _boxes(rng, n, spread, size):
    """(n, 8) boxes over 3 spatial columns, the 5 padding columns zero."""
    lo = np.zeros((n, 8), np.float32)
    lo[:, :3] = rng.uniform(-spread, spread, (n, 3))
    hi = lo.copy()
    hi[:, :3] += rng.uniform(0, size, (n, 3))
    return lo, hi


@pytest.mark.parametrize("bound", ["scalar", "per_tile"])
def test_visit_lists_match_jax(bound):
    rng = np.random.default_rng(3)
    qmin, qmax = _boxes(rng, 24, 6.0, 1.5)
    tmin, tmax = _boxes(rng, 300, 6.0, 1.0)
    if bound == "scalar":
        bv = np.float32(tknn.bound_value(4.0))
    else:
        bv = rng.uniform(0.0, 12.0, 24).astype(np.float32)
        bv[::5] = -1.0                                    # frozen tiles: empty lists
    jv, js, jc, jc0 = (np.asarray(x) for x in jknn._visit_lists(
        jnp.asarray(qmin), jnp.asarray(qmax), jnp.asarray(tmin), jnp.asarray(tmax),
        jnp.asarray(bv)))
    tv, ts, tc, tc0 = (x.numpy() for x in tknn._visit_lists(
        torch.from_numpy(qmin), torch.from_numpy(qmax), torch.from_numpy(tmin),
        torch.from_numpy(tmax), torch.from_numpy(np.asarray(bv))))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc0, jc0)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_max_ulp(ts, js, maxulp=2)
    assert 0 < tc.sum() < tc.size * 300 and (tc0 < tc).any()
    if bound == "per_tile":
        assert (tc[::5] == 0).all()


# ---------------------------------------------------------------------------
# The stage probes, the fused profiler and its work model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    tp, tn = bench.synth_cloud(N_POINTS, 0)
    T = bench.eth_true_pose(0)
    sp = (tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    sn = (tn @ T[:3, :3].T).astype(np.float32)
    js = jcloud.from_numpy(sp, normals=sn, morton_order=True)
    jt = jcloud.from_numpy(tp, normals=tn, morton_order=True)
    jkdi = jkd.build_kd_index(np.asarray(jt.points), np.asarray(jt.valid), block_target=256)
    return dict(js=js, jt=jt, jkd=jkdi, ts=convert.cloud_from_arrays(js, "cpu"),
                tt=convert.cloud_from_arrays(jt, "cpu"),
                tkd=convert.kd_index_from_arrays(jkdi, "cpu"))


def _cfgs(**kw):
    kw = dict(dict(n_iterations=3, max_distance=MAXD, matching_checks=16), **kw)
    j = jconfig.ICPConfig(metric=jconfig.Metric.SYMMETRIC, minimizer=jconfig.Minimizer.LINEAR,
                          selection=jconfig.Selection.ALL, **kw)
    t = tconfig.ICPConfig(metric=tconfig.Metric.SYMMETRIC, minimizer=tconfig.Minimizer.LINEAR,
                          selection=tconfig.Selection.ALL, **kw)
    return j, t


@pytest.mark.parametrize("stage", [*ticp.PROBE_STAGES, None])
def test_stop_after_probes_match_jax(pair, stage):
    """Each probe's checksum trace on the kd path at checks=16 (both
    packages score direct differences in original target numbering), the
    pose it hands on, and zero benchmark and match counts; the floor's
    checksum reads JAX's key, so only its shape is held."""
    jcfg, tcfg = _cfgs(kd_seed_membership=False)
    jr = jicp.run_icp(jcfg, pair["js"], pair["jt"], kd_index=pair["jkd"], stop_after=stage)
    tr = ticp.run_icp(tcfg, pair["ts"], pair["tt"], kd_index=pair["tkd"], stop_after=stage,
                      device="cpu")
    rmse, jrmse = tr.trace.rmse.numpy(), np.asarray(jr.trace.rmse)
    assert rmse.shape == jrmse.shape == (3,) and np.isfinite(rmse).all()
    if stage is None:
        np.testing.assert_array_equal(tr.trace.num_matches.numpy(),
                                      np.asarray(jr.trace.num_matches))
        np.testing.assert_allclose(rmse, jrmse, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-5)
        return
    assert not tr.trace.benchmark.numpy().any() and not tr.trace.num_matches.numpy().any()
    if stage != "floor":
        rtol = 1e-6 if stage == "matching" else 1e-5
        np.testing.assert_allclose(rmse, jrmse, rtol=rtol)
    if stage == "solve":
        # Each iteration solves from the unchanged pose: the one increment.
        np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-6)
        assert np.abs(tr.pose.numpy() - np.eye(4)).max() > 1e-3
    else:
        np.testing.assert_array_equal(tr.pose.numpy(), np.eye(4, dtype=np.float32))


@pytest.mark.parametrize("stage", ["selection", "matching", "solve"])
def test_stop_after_returns_the_membership_cache(pair, stage):
    """On the approximate arm's membership cache the cache comes back as it
    stood after the matching stage (unchanged before it), as in JAX."""
    jcfg, tcfg = _cfgs()
    jr = jicp.run_icp(jcfg, pair["js"], pair["jt"], kd_index=pair["jkd"], stop_after=stage)
    tr = ticp.run_icp(tcfg, pair["ts"], pair["tt"], kd_index=pair["tkd"], stop_after=stage,
                      device="cpu")
    blk = tr.match_blocks.numpy()
    np.testing.assert_array_equal(blk, np.asarray(jr.match_blocks))
    assert (blk == -1).all() == (stage == "selection")


def test_stop_after_rejects_unknown_stage(pair):
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="stop_after"):
        ticp.run_icp(tcfg, pair["ts"], pair["tt"], stop_after="matcher", device="cpu")


def test_stop_after_none_is_the_plain_run(pair):
    _, tcfg = _cfgs()
    a = ticp.run_icp(tcfg, pair["ts"], pair["tt"], kd_index=pair["tkd"], device="cpu")
    b = ticp.run_icp(tcfg, pair["ts"], pair["tt"], kd_index=pair["tkd"], stop_after=None,
                     device="cpu")
    assert torch.equal(a.pose, b.pose) and torch.equal(a.match_blocks, b.match_blocks)
    for x, y in zip(a.trace, b.trace):
        assert torch.equal(x, y)


def test_fused_stage_profile_accounting(pair):
    """The stage sum accounts for the full run (JAX's invariant,
    tests/test_aux.py), with its three attempts against host contention;
    off the card the report reads the host's clock and says so."""
    _, tcfg = _cfgs(n_iterations=5)
    for attempt in range(3):
        rep = tprof.fused_report(tcfg, pair["ts"], pair["tt"], repetitions=2,
                                 kd_index=pair["tkd"], device="cpu")
        times = rep.host
        assert times.full_run > 0 and times.n_iterations == 5
        total = (times.selection + times.matching + times.weighting + times.rejection
                 + times.solver + times.convergence)
        if total * times.n_iterations <= times.full_run * 1.5 + 0.05:
            break
        print(f"fused-stage accounting attempt {attempt}: stage sum {total:.4f} x "
              f"{times.n_iterations} vs full_run {times.full_run:.4f}")
    else:
        raise AssertionError(f"stage sum {total:.4f} x {times.n_iterations} exceeds "
                             f"full_run {times.full_run:.4f} after 3 attempts")
    assert rep.device is None
    for label in ("matching", "kd resident approx(checks=16", "JTJ accumulate", "f32 peak",
                  "host's clock"):
        assert label in rep.text, label
    with pytest.raises(ValueError, match="card"):
        tprof.profile_fused_device(tcfg, pair["ts"], pair["tt"], device="cpu")


@pytest.mark.parametrize("selection", ["random_fast", "random_compact", "all"])
def test_work_model_reads_the_drivers_first_queries(pair, selection, monkeypatch):
    """matcher_work_model's queries are the driver's first-iteration
    queries from the same seed, under multi-resolution too (its stride mask
    and compaction included)."""
    kw = dict(random_fast=dict(selection=tconfig.Selection.RANDOM_FAST, selection_proba=0.3),
              random_compact=dict(selection=tconfig.Selection.RANDOM, selection_proba=0.3),
              all=dict(selection=tconfig.Selection.ALL))[selection]
    tcfg = tconfig.ICPConfig(n_iterations=4, max_distance=MAXD, multi_resolution=True,
                             multi_resolution_min_points=256, **kw)
    seen = []
    queries = ticp._queries

    def record(*args):
        out = queries(*args)
        seen.append((out[1].clone(), out[2].clone()))
        return out

    monkeypatch.setattr(ticp, "_queries", record)
    ticp.run_icp(tcfg, pair["ts"], pair["tt"], seed=5, stop_after="selection", device="cpu")
    tprof.matcher_work_model(tcfg, pair["ts"], pair["tt"], seed=5, device="cpu")
    (run_mask, run_q), model = seen[0], seen[-1]
    assert torch.equal(run_mask, model[0]) and torch.equal(run_q, model[1])
    assert 0 < int(run_mask.sum()) < N_POINTS


@pytest.mark.parametrize("arm", ["kd_exact", "kd_checks16", "knn"])
def test_matcher_work_model_matches_jax(pair, arm):
    """At SELECT_ALL (the packages' random streams differ): visited blocks
    or tiles, tiles, padded queries and operations equal JAX's; bytes are
    JAX's times D / 8 (the port reads D feature rows, not 8-row pages);
    the labels read alike."""
    checks = 16 if arm == "kd_checks16" else 0
    jcfg, tcfg = _cfgs(matching_checks=checks)
    jkdi = None if arm == "knn" else pair["jkd"]
    tkdi = None if arm == "knn" else pair["tkd"]
    jw = jprof.matcher_work_model(jcfg, pair["js"], pair["jt"], kd_index=jkdi)
    tw = tprof.matcher_work_model(tcfg, pair["ts"], pair["tt"], kd_index=tkdi, device="cpu")
    assert tw[0] == jw[0] and tw[1] == jw[1] and tw[2] == jw[2] and tw[4] == jw[4]
    assert tw[3] * 8 == jw[3] * 3
    assert tw[5].split("modeled")[0] == jw[5].split("modeled")[0]
    assert tw[0] > 0
    jrep = jprof.kernel_efficiency(jcfg, pair["js"], pair["jt"], 1e-3, 1e-4, kd_index=jkdi)
    trep = tprof.kernel_efficiency(tcfg, pair["ts"], pair["tt"], 1e-3, 1e-4, kd_index=tkdi,
                                   device="cpu")
    jtjt = [line for line in jrep.splitlines() if "JTJ accumulate" in line]
    assert jtjt and jtjt == [line for line in trep.splitlines() if "JTJ accumulate" in line]
    assert "MXU" not in trep and trep.count("f32 peak") == 2


# ---------------------------------------------------------------------------
# The kd block search's probe
# ---------------------------------------------------------------------------


def test_block_search_probe_matches_jax_resident_probe():
    """JAX's resident kernel at probe=1 (interpret mode) and the port's
    probe both return every row's start and -1."""
    rng = np.random.default_rng(11)
    t = rng.uniform(-10, 10, (6000, 3)).astype(np.float32)
    q = (t[rng.integers(0, 6000, 300)] + rng.normal(0, 0.3, (300, 3))).astype(np.float32)
    jidx = jkd.build_kd_index(t, block_target=256)
    tidx = convert.kd_index_from_arrays(jidx, "cpu")
    bound = np.float32(tknn.bound_value(MAXD))
    tq = jkd.TILE_Q_DEFAULT
    qp = np.zeros((jkd._PREFIX_GROUP * tq, 8), np.float32)
    qp[:300, :3] = q
    binit = np.full(len(qp), -1.0, np.float32)
    binit[:300] = bound
    member, hot, lb_tile, _resid, submask, _rng = jkd._radius_prefix(
        jnp.asarray(qp), jnp.asarray(binit), jidx, tile_q=tq, k=4, interpret=True)
    dist, idx = jknn._run_resident_kernel_flat(
        jnp.asarray(qp)[None], jnp.asarray(binit)[None], hot[None], (member & ~hot)[None],
        lb_tile[None], submask[None], jidx.pages[None], MAXD, tile_q=tq,
        tile_t=jidx.pages.shape[2], n_features=3, gate_width=8, interpret=True, probe=1)
    tq_, tb = torch.from_numpy(q)[None], torch.full((1, 300), float(bound))
    sel, _ = tkd.box_topk(tq_, tb, tidx.block_min[None], tidx.block_max[None], 4)
    for probe in (1, 2):
        d2, ti = tkd.kd_block_search(tq_, sel, tb, tidx.pages[None], probe=probe)
        np.testing.assert_array_equal(d2[0].numpy(), np.asarray(dist)[0, :300, 0])
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(idx)[0, :300, 0])
    assert (ti == -1).all() and (d2 == float(bound)).all()
    full = tkd.kd_block_search(tq_, sel, tb, tidx.pages[None])
    assert (full[1] >= 0).any()
    with pytest.raises(ValueError, match="probe"):
        tkd.kd_block_search(tq_, sel, tb, tidx.pages[None], probe=3)


def test_measurement_build_is_kept_apart_from_the_production_build():
    """kd_block_search's lane-counting build (``resident_bench.lane_use``)
    gets a library path of its own, so it never replaces the production
    build; its sources guard the counters (in the walk that
    ``block_major.cuh`` holds) and their reader behind the define; and the
    CUDA launch path refuses CPU tensors rather than running the plain
    version."""
    from icp_variants_tpu_torch.ops import _cuda
    from icp_variants_tpu_torch.scripts import resident_bench

    src = _cuda.CSRC / "kd_block_search.cu"
    prod, lanes = _cuda._lib_path(src), _cuda._lib_path(src, resident_bench.LANE_DEFINES)
    assert prod != lanes and prod.parent == lanes.parent
    assert lanes.name.startswith("kd_block_search-kdb_lane_count-")
    assert (_cuda.CSRC / "block_major.cuh").read_text().count("#ifdef KDB_LANE_COUNT") >= 3
    text = src.read_text()
    guarded = text[text.rindex("#ifdef KDB_LANE_COUNT"):]
    assert 'extern "C" int kd_block_search_lanes(' in guarded
    q = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tkd._kd_block_search_launch(q, torch.zeros((1, 4, 1), dtype=torch.int32),
                                    torch.zeros((1, 4)), torch.zeros((1, 1, 8, 4)), 0,
                                    resident_bench.LANE_DEFINES)


# The ids of the d3 / d6 cases are those they had when the kd search's
# shapes were written KdbShape<D> (before the seeded search had its own).
@pytest.mark.parametrize("spec, old, new", [
    ("unroll=8", "#pragma unroll 4\n  for (int s4", "#pragma unroll 8\n  for (int s4"),
    pytest.param(
        "d3=32x2", "KdbShape<3, false> { static constexpr int chunk = 64, queries = 1; }",
        "KdbShape<3, false> { static constexpr int chunk = 32, queries = 2; }",
        id="d3=32x2-KdbShape<3> { static constexpr int chunk = 64, queries = 1; }"
           "-KdbShape<3> { static constexpr int chunk = 32, queries = 2; }"),
    pytest.param(
        "d6=1024x4", "KdbShape<6, false> { static constexpr int chunk = 512, queries = 2; }",
        "KdbShape<6, false> { static constexpr int chunk = 1024, queries = 4; }",
        id="d6=1024x4-KdbShape<6> { static constexpr int chunk = 512, queries = 2; }"
           "-KdbShape<6> { static constexpr int chunk = 1024, queries = 4; }"),
    ("s6=128x1", "KdbShape<6, true> { static constexpr int chunk = 256, queries = 1; }",
     "KdbShape<6, true> { static constexpr int chunk = 128, queries = 1; }"),
])
def test_kd_variants_edit_one_line_of_the_walk(spec, old, new):
    """scripts/kd_variants' edits change exactly the named line of the
    production block_major.cuh (the slot loop's unroll, one D's launch
    shape of the kd or the seeded search) and refuse a spec they cannot
    place."""
    from icp_variants_tpu_torch.ops import _cuda
    from icp_variants_tpu_torch.scripts import kd_variants

    src = (_cuda.CSRC / "block_major.cuh").read_text()
    assert src.count(old) == 1
    assert kd_variants._edit(src, spec) == src.replace(old, new)
    with pytest.raises(ValueError):
        kd_variants._edit(src.replace(old, ""), spec)
    with pytest.raises(ValueError):
        kd_variants._edit(src, "chunk=64")


# ---------------------------------------------------------------------------
# Trim parity on the kd path (ROADMAP.md queue 3)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs2():
    js, jt, tkds = [], [], []
    for i in range(2):
        tp, tn = bench.synth_cloud(N_POINTS, 2 * i)
        T = bench.eth_true_pose(i)
        sp = (tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        sn = (tn @ T[:3, :3].T).astype(np.float32)
        js.append(jcloud.from_numpy(sp, normals=sn, morton_order=True))
        jt.append(jcloud.from_numpy(tp, normals=tn, morton_order=True))
    jkds = jkd.stack_kd_indexes([
        jkd.build_kd_index(np.asarray(t.points), np.asarray(t.valid), block_target=256)
        for t in jt])
    js, jt = jicp.stack_clouds(js), jicp.stack_clouds(jt)
    return dict(js=js, jt=jt, jkds=jkds, ts=convert.cloud_from_arrays(js, "cpu"),
                tt=convert.cloud_from_arrays(jt, "cpu"),
                tkds=convert.kd_index_from_arrays(jkds, "cpu"))


@pytest.mark.parametrize("trim", [0.5, 0.8])
def test_trimmed_kd_checks16_matches_jax(pairs2, trim):
    """Trimmed ICP on the kd path at checks=16, where both packages score
    direct differences and no fallback runs (JAX kdtree.py:391-394): the
    match counts of every iteration are equal and the poses agree."""
    jcfg, tcfg = _cfgs(n_iterations=8, trim_ratio=trim)
    jr = jicp.run_icp_batch(jcfg, pairs2["js"], pairs2["jt"], kd_indexes=pairs2["jkds"],
                            key=jax.random.PRNGKey(0))
    tr = ticp.run_icp_batch(tcfg, pairs2["ts"], pairs2["tt"], kd_indexes=pairs2["tkds"],
                            device="cpu")
    nm = tr.trace.num_matches.numpy()
    np.testing.assert_array_equal(nm, np.asarray(jr.trace.num_matches))
    assert (nm[:, 0] < N_POINTS * trim + 128).all()       # the trim bites early on
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-6)
