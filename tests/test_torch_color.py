"""The dense colour-multires tracker of the port against the JAX package on
the CPU: RGB-D back-projection and the colour clouds, the 6-dim Morton order
and kd partition, the three kd kernels' plain versions at D = 6, the seeded
block search, the pyramid seed and planner, and the segmented driver on
both matching arms. Frames are small synthetic 80 x 60 RGB-D images (a
scaled copy of ``bench.synth_depth_frame``); the kd and tile indexes are
the JAX package's, carried across with ``convert``, so both packages search
the same blocks.

Tolerances: back-projected points, the Morton codes and order, colours and
masks are equal bit for bit; normals to 2 ulp (XLA may fuse the norm's
sum of squares). The port's bounds equal eager JAX bit for bit; against
jitted JAX (its search oracles, Pallas interpret mode) distances are
compared to 2 ulp and indices may differ only at ties within that rounding
(see tests/test_torch_kdtree.py). The segmented runs: per-iteration match
counts equal, poses within 1e-4 (f32 sums in another order), final matched
blocks equal except at ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_variants_tpu.data import rgbd as jrgbd
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu.ops import normals as jnormals
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.data import rgbd as trgbd
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.ops import normals as tnormals
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp

torch.set_num_threads(2)

W, H = 80, 60
FX = FY = 525.0 * W / 640
CX, CY = (W - 1) / 2, (H - 1) / 2
SHIFT = 0.01
N_FRAMES = 2
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
EYE = np.eye(4, dtype=np.float32)


def synth_depth_frame(i):
    """``bench.synth_depth_frame`` at W x H: a wavy surface with raised
    boxes (depth steps, invalid normals at their edges) and smooth colours,
    seen from a camera at x = -SHIFT * i."""
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    sx = SHIFT * i
    z = np.full((H, W), 2.0)
    boxes = [(-0.6, -0.3, 0.35, 0.25, 0.5), (0.4, 0.2, 0.3, 0.3, 0.35),
             (0.1, -0.5, 0.2, 0.2, 0.25)]
    for _ in range(8):
        xw = (uu - CX) / FX * z - sx
        yw = (vv - CY) / FY * z
        base = 2.0 + 0.12 * np.sin(3.0 * xw) * np.cos(3.0 * yw)
        for (bx, by, w, h, dz) in boxes:
            inside = (np.abs(xw - bx) < w) & (np.abs(yw - by) < h)
            base = np.where(inside, base - dz, base)
        z = base
    xw = (uu - CX) / FX * z - sx
    yw = (vv - CY) / FY * z
    color = np.stack([
        (127 + 120 * np.sin(5.0 * xw)).astype(np.uint8),
        (127 + 120 * np.cos(4.0 * yw)).astype(np.uint8),
        (127 + 120 * np.sin(3.0 * (xw + yw))).astype(np.uint8),
        np.full((H, W), 255, np.uint8),
    ], axis=-1)
    z = z.astype(np.float32)
    z[:2, :5] = np.nan                                   # a few invalid depths
    return z, color


def _n(x):
    return np.asarray(x)


def _cloud_equal(tc, jc):
    for name in ("points", "colors", "valid"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), _n(getattr(jc, name)), err_msg=name)
    tn, jn = tc.normals.numpy(), _n(jc.normals)
    np.testing.assert_array_equal(np.isnan(tn), np.isnan(jn))
    ok = ~np.isnan(jn)
    np.testing.assert_array_max_ulp(tn[ok], jn[ok], maxulp=2)


@pytest.fixture(scope="module")
def frames():
    return [synth_depth_frame(i) for i in range(N_FRAMES + 1)]


def test_backproject_depth_matches_jax(frames):
    depth, _ = frames[1]
    rot = np.array([[0.96, -0.28, 0.0], [0.28, 0.96, 0.0], [0.0, 0.0, 1.0]], np.float32)
    for ext_inv, exact in ((EYE, True), (np.block([[rot, np.array([[0.1], [-0.2], [0.3]])],
                                                   [np.zeros((1, 3)), np.ones((1, 1))]]), False)):
        ext_inv = ext_inv.astype(np.float32)
        jp, jn, jvp, jvn = (_n(x) for x in jnormals.backproject_depth(
            jnp.asarray(depth), jnp.asarray(K), jnp.asarray(ext_inv), max_distance=0.1))
        tp, tn, tvp, tvn = tnormals.backproject_depth(depth, K, ext_inv, max_distance=0.1)
        np.testing.assert_array_equal(tvp, jvp)
        np.testing.assert_array_equal(tvn, jvn)
        if exact:
            np.testing.assert_array_equal(tp, jp)
        else:   # XLA's 3x3 product may sum in another order
            np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.isnan(tn), np.isnan(jn))
        np.testing.assert_array_max_ulp(tn[tvn], jn[jvn], maxulp=2)


@pytest.mark.parametrize("kw", [
    dict(keep_original_size=True, capacity=W * H, color_morton_order=True),
    dict(keep_original_size=True, capacity=W * H),
    dict(keep_original_size=False, capacity=W * H),
    dict(keep_original_size=False, color_morton_order=True),
    dict(keep_original_size=False, downsample_factor=4, morton_order=True),
])
def test_cloud_from_depth_matches_jax(frames, kw):
    depth, color = frames[1]
    jc = jrgbd.cloud_from_depth(depth, color, K, EYE, **kw)
    tc = trgbd.cloud_from_depth(depth, color, K, EYE, device="cpu", **kw)
    _cloud_equal(tc, jc)


def test_color_morton_order_refuses_projective(frames):
    depth, color = frames[1]
    with pytest.raises(ValueError, match="projective"):
        trgbd.cloud_from_depth(depth, color, K, EYE, keep_original_size=True,
                               color_morton_order=True, for_projective=True, device="cpu")


def test_morton6_codes_bit_for_bit(frames):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    cols = rng.uniform(0, 255, (5000, 4)).astype(np.float32)
    valid = rng.random(5000) > 0.1
    for v in (valid, None):
        want = jknn.morton6_codes_np(pts, cols, v)
        got = tknn.morton6_codes_np(pts, cols, v)
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


def _color_target(frames):
    depth, color = frames[0]
    return jrgbd.cloud_from_depth(depth, color, K, EYE, keep_original_size=False, capacity=W * H)


def test_kd_partition_6dim_matches_jax(frames):
    jt = _color_target(frames)
    tt = convert.cloud_from_arrays(jt, "cpu")
    cfg_j = jconfig.ICPConfig(color_icp=True, matching_checks=16)
    cfg_t = tconfig.ICPConfig(color_icp=True, matching_checks=16)
    for bt in (0, 256):
        jidx = jicp.build_kd_for(cfg_j.replace(kd_block_target=bt), jt, min_points=0)
        tidx = ticp.build_kd_for(cfg_t.replace(kd_block_target=bt), tt, min_points=0, device="cpu")
        assert tidx.block_min.shape[-1] == 6 and tidx.pages_packed is None
        assert tuple(tidx.pages.shape) == _n(jidx.pages).shape
        np.testing.assert_array_equal(tidx.block_min.numpy(), _n(jidx.block_min))
        np.testing.assert_array_equal(tidx.block_max.numpy(), _n(jidx.block_max))
        np.testing.assert_array_equal(np.sort(tidx.block_orig.numpy(), axis=1),
                                      np.sort(_n(jidx.block_orig), axis=1))


@pytest.fixture(scope="module")
def feats6(frames):
    """6-dim target features of frame 0, queries from frame 1's features,
    and the JAX package's kd index over the target (and the port's copy)."""
    jt = _color_target(frames)
    t = _n(jknn.color_features(jt.points, jt.colors))[_n(jt.valid)]
    depth, color = frames[1]
    js = jrgbd.cloud_from_depth(depth, color, K, EYE, keep_original_size=False,
                                color_morton_order=True)
    q = _n(jknn.color_features(js.points, js.colors))[_n(js.valid)]
    jidx = jkd.build_kd_index(t, block_target=256)
    return t, q, jidx, convert.kd_index_from_arrays(jidx, "cpu")


@pytest.mark.parametrize("k", [4, 1])
def test_box_topk_plain_d6_matches_jax(feats6, k):
    _, q, jidx, tidx = feats6
    jsel, jres = jkd._extract_min(jkd._box_lb(jnp.asarray(q), jidx.block_min, jidx.block_max), k)
    tsel, tres = tkd.box_topk(torch.from_numpy(q)[None], torch.full((1, len(q)), float("inf")),
                              tidx.block_min[None], tidx.block_max[None], k)
    np.testing.assert_array_equal(tsel[0].numpy(), _n(jsel))
    np.testing.assert_array_equal(tres[0].numpy(), _n(jres))


@pytest.mark.parametrize("k", [4, 1])
def test_kd_block_search_plain_d6_matches_nn_search_kd(feats6, k):
    t, q, jidx, tidx = feats6
    maxd = 0.1
    ji, jd, jf = (_n(x) for x in jkd.nn_search_kd(jnp.asarray(q), jidx, maxd, k=k))
    ti, td, tf = (x.numpy() for x in tkd.nn_search_kd(torch.from_numpy(q), tidx, maxd, k=k))
    np.testing.assert_array_max_ulp(td, jd, maxulp=2)
    both = (ti >= 0) & (ji >= 0)
    assert ((ti >= 0) != (ji >= 0)).sum() <= 1
    diff = np.flatnonzero(both & (ti != ji))
    qa = q[diff].astype(np.float64)
    np.testing.assert_allclose(((qa - t[ti[diff]]) ** 2).sum(1), ((qa - t[ji[diff]]) ** 2).sum(1),
                               rtol=4 * np.finfo(np.float32).eps)
    assert (tf != jf).sum() <= 1
    assert both.mean() > 0.5


def test_cached_search_matches_jax_kernel_and_oracle(feats6):
    """The seeded block search's plain version against the JAX cached
    kernel (interpret mode) and its oracle, -1 rows included (mirrors
    tests/test_kdtree.py::TestCachedMembership)."""
    t, q, jidx, tidx = feats6
    maxd = 0.1
    lb = _n(jkd._box_lb(jnp.asarray(q), jidx.block_min, jidx.block_max))
    blk = np.argmin(lb, axis=1).astype(np.int32)
    blk[::7] = -1
    blk[5] = 10_000                                  # clipped to the last block
    oi, od = (_n(x) for x in jkd.nn_search_kd_cached_oracle(jnp.asarray(q), jidx, maxd,
                                                            jnp.asarray(blk)))
    ki, kd2 = (_n(x) for x in jkd.nn_search_kd_cached(jnp.asarray(q), jidx, maxd,
                                                      jnp.asarray(blk), interpret=True))
    ti, td = (x.numpy() for x in tkd.nn_search_kd_cached(torch.from_numpy(q), tidx, maxd,
                                                         torch.from_numpy(blk)))
    assert (ti[::7] == -1).all() and (td[::7] == np.float32(tknn.bound_value(maxd))).all()
    assert (ti >= 0).sum() > 0.5 * len(q)
    for ji, jd in ((oi, od), (ki, kd2)):
        np.testing.assert_array_max_ulp(td, jd, maxulp=2)
        assert ((ti >= 0) != (ji >= 0)).sum() <= 1
        assert ((ti >= 0) & (ji >= 0) & (ti != ji)).sum() <= 2
    # batched call with a query mask: masked rows search nothing
    mask = np.ones(len(q), bool)
    mask[:40] = False
    batched = tkd.KDIndex(*(None if f is None else f[None] for f in tidx))
    mi, md, mv = tkd.match_kd_cached(torch.from_numpy(q)[None], batched, maxd,
                                     torch.from_numpy(blk)[None],
                                     query_mask=torch.from_numpy(mask)[None])
    assert not mv[0, :40].any() and (mi[0, :40] == -1).all()
    np.testing.assert_array_equal(mi[0, 40:].numpy(), ti[40:])


def test_level_seed_matches_jax():
    rng = np.random.default_rng(5)
    blk = rng.integers(-1, 30, (2, 600)).astype(np.int32)
    blk[:, 100:180] = -1                              # a run wider than one shift
    blk[1, :] = -1
    blk[1, 300] = 7
    for stride, prev, cap_l in ((1, 2, 1200), (2, 4, 600), (1, 1, 600), (1, 2, 1150)):
        want = _n(jicp._level_seed(jnp.asarray(blk), stride=stride, prev_stride=prev, cap_l=cap_l))
        got = ticp._level_seed(torch.from_numpy(blk), stride, prev, cap_l).numpy()
        np.testing.assert_array_equal(got, want)


def test_plan_segments_matches_jax():
    strides = ticp.cloud_lib.multires_stride_schedule(W * H * 64, 35, True)
    levels = ticp._stride_groups(strides)
    assert levels == jicp._stride_groups(strides)
    plan = ticp._plan_segments(levels, 640 * 480, protect_tail=2)
    assert plan == jicp._plan_segments(levels, 640 * 480, protect_tail=2)
    assert [[s for s, _ in seg] for seg in plan] == [
        [2048, 1024, 512, 256, 128, 64, 32, 16], [8, 4], [2], [1]]
    assert plan[-1] == [(1, 24)]
    # protect_tail keeps the last runs apart where the cost model merges all
    small = ticp._stride_groups(ticp.cloud_lib.multires_stride_schedule(W * H, 8, True))
    assert len(ticp._plan_segments(small, W * H)) == 1
    for tail in (0, 1, 2, 3):
        got = ticp._plan_segments(small, W * H, protect_tail=tail)
        assert got == jicp._plan_segments(small, W * H, protect_tail=tail)
        assert all(len(seg) == 1 for seg in got[len(got) - tail:])


@pytest.fixture(scope="module")
def tracker(frames):
    """N_FRAMES full-size colour-Morton sources (frames 1..), the compact
    frame-0 target, in both packages."""
    srcs = [jrgbd.cloud_from_depth(*frames[i], K, EYE, keep_original_size=True, capacity=W * H,
                                   color_morton_order=True) for i in range(1, N_FRAMES + 1)]
    tgt = _color_target(frames)
    js, jt = jicp.stack_clouds(srcs), jicp.stack_clouds([tgt] * N_FRAMES)
    return dict(tgt=tgt, js=js, jt=jt, ts=convert.cloud_from_arrays(js, "cpu"),
                tt=convert.cloud_from_arrays(jt, "cpu"))


def _cfgs(checks, **kw):
    common = dict(n_iterations=8, max_distance=0.1, color_icp=True, multi_resolution=True,
                  matching_checks=checks, kd_block_target=256, **kw)
    j = jconfig.ICPConfig(metric=jconfig.Metric.POINT_TO_PLANE,
                          minimizer=jconfig.Minimizer.LINEAR, **common)
    t = tconfig.ICPConfig(metric=tconfig.Metric.POINT_TO_PLANE,
                          minimizer=tconfig.Minimizer.LINEAR, **common)
    return j, t


@pytest.mark.parametrize("forced", [False, True], ids=["planned", "one-level-per-segment"])
@pytest.mark.parametrize("checks", [0, 16], ids=["exact", "checks16"])
def test_segmented_driver_matches_jax(tracker, monkeypatch, checks, forced):
    """Both arms through the segmented driver; ``forced`` plans every level
    as its own segment (no program overhead), the default plan groups the
    coarse levels. The approximate arm records blocks on the coarse levels
    and seeds the stride-1 level from the stride-2 level."""
    if forced:
        monkeypatch.setattr(jicp, "SEGMENT_PROGRAM_OVERHEAD_MS", 0.0)
        monkeypatch.setattr(ticp, "SEGMENT_PROGRAM_OVERHEAD_MS", 0.0)
    jlevels, tlevels = [], []

    def capture(run, out):
        def wrapped(*a, **kw):
            res = run(*a, **kw)
            out.append((kw.get("membership_seed") is not None, res))
            return res
        return wrapped

    monkeypatch.setattr(jicp, "run_icp_batch", capture(jicp.run_icp_batch, jlevels))
    monkeypatch.setattr(ticp, "run_icp_batch", capture(ticp.run_icp_batch, tlevels))
    jcfg, tcfg = _cfgs(checks)
    jidx = jicp.build_kd_for(jcfg, tracker["tgt"], min_points=0)
    jkds = jkd.stack_kd_indexes([jidx] * N_FRAMES)
    jr = jicp.run_icp_batch_multires_segmented(
        jcfg, tracker["js"], tracker["jt"], key=jax.random.PRNGKey(1),
        num_source_points=W * H, kd_indexes=jkds)
    tr = ticp.run_icp_batch_multires_segmented(
        tcfg, tracker["ts"], tracker["tt"], num_source_points=W * H,
        kd_indexes=convert.kd_index_from_arrays(jkds, "cpu"), device="cpu")
    assert len(tlevels) == len(jlevels) >= (5 if forced else 3 if checks else 1)
    assert [s for s, _ in tlevels] == [s for s, _ in jlevels]
    assert any(s for s, _ in tlevels) == (checks > 0)          # the seeded level ran
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), _n(jr.trace.num_matches))
    assert (tr.trace.num_matches[:, -1] > 0.5 * W * H).all()
    np.testing.assert_allclose(tr.pose.numpy(), _n(jr.pose), atol=1e-4)
    assert (tr.pose[:, 0, 3] < 0).all()          # towards the cameras' -x shifts
    if checks:
        jb, tb = _n(jlevels[-1][1].match_blocks), tr.match_blocks.numpy()
        assert tb.shape == (N_FRAMES, tracker["ts"].capacity)
        assert (tb != jb).mean() < 0.01, (tb != jb).sum()
        np.testing.assert_array_equal(tb, tlevels[-1][1].match_blocks.numpy())
    else:
        assert tr.match_blocks is None and jlevels[-1][1].match_blocks is None


def test_membership_blocks_emitted_and_seeded(tracker):
    """run_icp_batch on the approximate arm records each row's matched
    block; seeding those back searches exactly them (mirrors
    tests/test_pipeline_ops.py::TestSeededMembership)."""
    _, tcfg = _cfgs(16)
    tcfg = tcfg.replace(multi_resolution=False, n_iterations=3)
    kd = ticp.build_kd_for(tcfg, convert.cloud_from_arrays(tracker["tgt"], "cpu"),
                           min_points=0, device="cpu")
    kds = tkd.stack_kd_indexes([kd] * N_FRAMES)
    res = ticp.run_icp_batch(tcfg, tracker["ts"], tracker["tt"], kd_indexes=kds, device="cpu")
    blk = res.match_blocks
    assert blk is not None and tuple(blk.shape) == (N_FRAMES, tracker["ts"].capacity)
    assert (blk >= 0).sum() > 0.5 * W * H and int(blk.max()) < kd.block_orig.shape[0]
    res2 = ticp.run_icp_batch(tcfg, tracker["ts"], tracker["tt"], kd_indexes=kds,
                              membership_seed=blk, device="cpu")
    assert torch.isfinite(res2.pose).all()
    assert (res2.trace.num_matches >= 0.9 * res.trace.num_matches[:, -1:]).all()
    with pytest.raises(ValueError, match="membership_seed"):
        ticp.run_icp_batch(tcfg, tracker["ts"], tracker["tt"], kd_indexes=kds,
                           membership_seed=blk[:, :100], device="cpu")
    res3 = ticp.run_icp_batch(tcfg.replace(matching_checks=0), tracker["ts"], tracker["tt"],
                              kd_indexes=kds, device="cpu")
    assert res3.match_blocks is None


def test_convert_carries_colour_state(tracker):
    """JAX colour clouds, a 6-dim kd index and a match_blocks seed cross into
    the port's containers unchanged."""
    jcfg, _ = _cfgs(16)
    jidx = jicp.build_kd_for(jcfg, tracker["tgt"], min_points=0)
    tidx = convert.kd_index_from_arrays(jidx, "cpu")
    assert tidx.pages_packed is None and tidx.block_min.shape[-1] == 6
    np.testing.assert_array_equal(tidx.pages.numpy(), _n(jidx.pages))
    seed = jnp.asarray(np.arange(-1, W * H - 1, dtype=np.int32) % 7 - 1)
    t_seed = convert.match_blocks_from_array(seed, "cpu")
    assert t_seed.dtype == torch.int32
    np.testing.assert_array_equal(t_seed.numpy(), _n(seed))
    np.testing.assert_array_equal(tracker["ts"].colors.numpy(), _n(tracker["js"].colors))


def test_single_pair_segmented(tracker):
    """run_icp_multires_segmented is the batch of one; a non-multires config
    falls through to run_icp."""
    _, tcfg = _cfgs(16)
    src = ticp.Cloud(*(f[0] for f in tracker["ts"]))
    tgt = ticp.Cloud(*(f[0] for f in tracker["tt"]))
    kd = ticp.build_kd_for(tcfg, tgt, min_points=0, device="cpu")
    one = ticp.run_icp_multires_segmented(tcfg, src, tgt, kd_index=kd,
                                          num_source_points=W * H, device="cpu")
    assert one.pose.shape == (4, 4) and one.match_blocks.shape == (src.capacity,)
    assert float(one.pose[0, 3]) < 0
    flat = ticp.run_icp_multires_segmented(tcfg.replace(multi_resolution=False, n_iterations=3),
                                           src, tgt, kd_index=kd, device="cpu")
    assert flat.trace.rmse.shape == (3,)
