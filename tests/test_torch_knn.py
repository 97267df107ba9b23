"""The port's dense and tile-pruned matchers and the seeded search's pose
mode against the JAX package on the CPU: ``knn.nn_search`` / ``match``
(the plain version of the CUDA kernel that replaces TPU kernel 6) against
JAX ``nn_search_xla`` and ``nn_search_pallas`` in interpret mode,
``nn_search_pruned`` (TPU kernel 7's counterpart) and
``nn_search_pruned_xla`` against JAX's, the target index's default tile,
``nn_search_kd_cached`` / ``_oracle`` / ``match_kd_cached`` with ``pose=``
(TPU kernel 2's transform_pose mode) against JAX's kernel in interpret mode
and its oracle, and the eager per-stage profiler.

Tolerances. The expansion ``(|q|^2 + |t|^2) - 2 q.t`` rounds differently in
the two packages (XLA's dot and sums take their own order and may fuse),
so distances agree to ``EXP_ULPS * 2^-24 * (|q|^2 + |t|^2)``, with
EXP_ULPS = 2D + 2, the first-order bound of the D products and sums of
each norm and of the product; indices agree except where the two
candidates' exact (f64) distances lie within that rounding of each other.
Against a float64 brute force the same bound holds. The pose mode: the
port's oracle equals transform-then-search bit for bit; against JAX (whose
oracle multiplies by ``@`` and whose interpret-mode kernel may fuse)
distances agree within rtol 1e-4 / atol 1e-6 and indices in at least 99%
of rows, as ``tests/test_kdtree.py::test_in_kernel_pose_transform`` holds
the JAX package itself. The profiler's increment: within atol 1e-5 of the
JAX stage chain on the same mask."""

import ctypes
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_variants_tpu.core import cloud as jcloud
from icp_variants_tpu.core import se3 as jse3
from icp_variants_tpu.ops import kdtree as jkd
from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu.ops import projective as jproj
from icp_variants_tpu.ops import rejection as jrej
from icp_variants_tpu.ops import weighting as jw
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu.pipeline import profiling as jprof
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.core import cloud as tcloud
from icp_variants_tpu_torch.core import se3 as tse3
from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import profiling as tprof
from icp_variants_tpu_torch.runtime import spans

torch.set_num_threads(2)

U = 2.0 ** -24


def _n(x):
    return np.asarray(x)


def _exp_tol(q, t, d):
    """The expansion's rounding bound for rows ``q`` against ``t`` (f64)."""
    s = (q.astype(np.float64) ** 2).sum(-1) + (t.astype(np.float64) ** 2).sum(-1)
    return (2 * d + 2) * U * s


def _assert_expansion_match(q, t, ti, td, ri, rd, rows=None):
    """Port (ti, td) against reference (ri, rd) on ``rows``: distances
    within the expansion's rounding; where indices differ, the two targets'
    exact distances within twice that rounding."""
    d = q.shape[-1]
    rows = np.ones(len(q), bool) if rows is None else rows
    q, ti, td, ri, rd = q[rows], ti[rows], td[rows], ri[rows], rd[rows]
    tol = _exp_tol(q, t[ti], d)
    assert np.all(np.abs(td.astype(np.float64) - rd) <= tol)
    diff = ti != ri
    exact = lambda i: ((q[diff].astype(np.float64) - t[i[diff]]) ** 2).sum(1)  # noqa: E731
    assert np.all(np.abs(exact(ti) - exact(ri)) <= 2 * tol[diff])
    assert diff.mean() < 0.02


def _assert_found_rows(q, t, ti, td, ri, rd, bound):
    """Rows that one result finds (idx >= 0) and the other misses are few,
    and the finder's distance lies at ``bound`` within the rounding."""
    one = np.flatnonzero((ti < 0) != (ri < 0))
    assert len(one) <= max(2, len(q) // 500)
    got = np.where(ti[one] < 0, rd[one], td[one]).astype(np.float64)
    hit = np.where(ti[one] < 0, ri[one], ti[one])
    assert np.all(np.abs(got - bound) <= _exp_tol(q[one], t[hit], q.shape[-1]))


def _scene(n_t, n_q, d, seed, offset=15.0):
    """Targets on a surface sheet away from the origin (so the expansion
    cancels as at scan scale), noisy queries near them; with d = 6 colour
    features in [0, 1] follow the coordinates. Returns f32 (q, t)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-6, 6, (n_t, 2))
    t = np.column_stack([xy, 0.6 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])]) + offset
    rows = rng.integers(0, n_t, n_q)
    q = t[rows] + rng.normal(0, 0.15, (n_q, 3))
    if d == 6:
        tc = rng.uniform(0, 1, (n_t, 3))
        t = np.concatenate([t, tc], axis=1)
        q = np.concatenate([q, tc[rows] + rng.normal(0, 0.05, (n_q, 3))], axis=1)
    return q.astype(np.float32), t.astype(np.float32)


# ---------------------------------------------------------------------------
# The target index's default tile (the repaired fault)
# ---------------------------------------------------------------------------


def test_build_target_index_default_matches_jax():
    """A caller that omits ``tile_t`` gets the JAX package's table (512-row
    tiles), as the pruned search takes its tile from the index."""
    _, t = _scene(3000, 1, 3, seed=1)
    jt, tt = jknn.build_target_index(jnp.asarray(t)), tknn.build_target_index(torch.from_numpy(t))
    assert tknn.INDEX_TILE_T == jknn.INDEX_TILE_T == 512
    for name in tt._fields:
        got, want = getattr(tt, name).numpy(), _n(getattr(jt, name))
        assert got.shape == want.shape, name
        if name == "points_t3":
            got, want = got[:, :-1], want[:, :-1]   # JAX's 0.5*|t|^2 row
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# The dense matcher (TPU kernel 6's counterpart)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[3, 6], ids=["d3", "d6"])
def dense(request):
    """~2,000 targets with duplicated rows (exact ties), 700 queries of
    which every 9th sits at the pad sentinel; both packages' results."""
    d = request.param
    q, t = _scene(2000, 700, d, seed=10 + d)
    t[1500:1600] = t[100:200]                        # duplicates: ties to the lower row
    q[5:40] = t[1500:1535]                           # queries exactly on duplicated points
    q[::9, :3] = tcloud.PAD_SENTINEL
    jx = [_n(x) for x in jknn.nn_search_xla(jnp.asarray(q), jnp.asarray(t))]
    jp = [_n(x) for x in jknn.nn_search_pallas(jnp.asarray(q), jnp.asarray(t), interpret=True)]
    return dict(d=d, q=q, t=t, jx=jx, jp=jp)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_nn_search_matches_jax(dense, ref):
    """nn_search (CPU: nn_search_xla) against JAX's dense XLA search and
    its Pallas kernel in interpret mode, on the rows with a real match (the
    JAX kernel may return a padding row >= Nt for sentinel queries)."""
    q, t = dense["q"], dense["t"]
    ti, td = (x.numpy() for x in tknn.nn_search(torch.from_numpy(q), torch.from_numpy(t)))
    ri, rd = dense[{"xla": "jx", "pallas": "jp"}[ref]]
    assert ti.dtype == np.int32 and (ti >= 0).all() and (ti < len(t)).all()
    real = np.abs(q[:, 0]) < 1e5
    _assert_expansion_match(q, t, ti, td, ri, rd, rows=real)
    # Queries on duplicated points: both packages pick the lower row.
    on = np.arange(5, 40)
    on = on[on % 9 != 0]
    np.testing.assert_array_equal(ti[on], on + 95)
    np.testing.assert_array_equal(ri[on], on + 95)


def test_nn_search_xla_matches_float64_brute_force(dense):
    """Each returned row is a nearest neighbour within the expansion's
    rounding; the chunk size does not change the answer; a batched call
    equals the unbatched one."""
    q, t = dense["q"], dense["t"]
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    ti, td = (x.numpy() for x in tknn.nn_search_xla(qt, tt))
    d2 = ((q[:, None].astype(np.float64) - t[None]) ** 2).sum(-1)
    ri = np.argmin(d2, axis=1).astype(np.int32)
    _assert_expansion_match(q, t, ti, td, ri, d2[np.arange(len(q)), ri])
    for chunk in (1, 64, 5000):
        got = tknn.nn_search_xla(qt, tt, chunk=chunk)
        np.testing.assert_array_equal(got[0].numpy(), ti)
        np.testing.assert_array_equal(got[1].numpy(), td)
    bi, bd = tknn.dense_nn_search(torch.stack([qt, qt.flip(0)]), torch.stack([tt, tt]))
    np.testing.assert_array_equal(bi[0].numpy(), ti)
    np.testing.assert_array_equal(bd[1].numpy(), td[::-1])


def test_match_matches_jax(dense):
    """match: the squared threshold and the query mask, as JAX's."""
    q, t, d = dense["q"], dense["t"], dense["d"]
    maxd = 0.05 if d == 3 else 0.08
    mask = np.ones(len(q), bool)
    mask[::4] = False
    ji, jd, jv = (_n(x) for x in jknn.match(jnp.asarray(q), jnp.asarray(t), maxd,
                                            query_mask=jnp.asarray(mask)))
    ti, td, tv = (x.numpy() for x in tknn.match(torch.from_numpy(q), torch.from_numpy(t), maxd,
                                                query_mask=torch.from_numpy(mask)))
    tol = _exp_tol(q, t[ti], d)
    clear = np.abs(jd.astype(np.float64) - maxd) > tol
    np.testing.assert_array_equal(tv[clear], jv[clear])
    assert 0.2 < tv.mean() < 0.75 and not tv[::4].any()
    _assert_expansion_match(q, t, ti, td, ji, jd, rows=tv & jv)
    tv0 = tknn.match(torch.from_numpy(q), torch.from_numpy(t), maxd)[2].numpy()
    np.testing.assert_array_equal(tv0 & mask, tv)


# ---------------------------------------------------------------------------
# The tile-pruned matcher (TPU kernel 7's counterpart)
# ---------------------------------------------------------------------------


def _pruned_case(case):
    """``tests/test_knn.py``'s fixtures, and a Morton-ordered sheet."""
    if case == "oracle":
        rng = np.random.default_rng(5)
        t = rng.standard_normal((1500, 3)).astype(np.float32) * 3.0
        q = rng.standard_normal((300, 3)).astype(np.float32) * 3.0
        return q, t, 1e6, 256
    if case == "threshold":
        rng = np.random.default_rng(6)
        t = rng.standard_normal((1000, 3)).astype(np.float32)
        q = rng.standard_normal((256, 3)).astype(np.float32)
        return q, t, 0.02, 256
    q, t = _scene(12000, 2000, 3, seed=7)
    t = t[np.argsort(tknn.morton_codes_np(t), kind="stable")]
    q = q[np.argsort(tknn.morton_codes_np(q), kind="stable")]
    return q, t, 0.01, 512


@pytest.mark.parametrize("case", ["oracle", "threshold", "morton"])
def test_nn_search_pruned_matches_jax(case):
    """nn_search_pruned against JAX's pruned kernel in interpret mode (same
    tiles, 128-row query tiles), its visit mask against JAX's, the -1 /
    bound_val rule, and nn_search_pruned_xla against JAX's."""
    q, t, maxd, tile_t = _pruned_case(case)
    jidx = jknn.build_target_index(jnp.asarray(t), tile_t=tile_t)
    tidx = tknn.build_target_index(torch.from_numpy(t), tile_t=tile_t)
    ji, jd = (_n(x) for x in jknn.nn_search_pruned(
        jnp.asarray(q), jidx, maxd, interpret=True, tile_q=128, tile_t=tile_t))
    ti, td = (x.numpy() for x in tknn.nn_search_pruned(torch.from_numpy(q), tidx, maxd, tile_q=128))
    bv = np.float32(tknn.bound_value(maxd))
    miss = ti < 0
    assert (td[miss] == bv).all() and (td[~miss] < bv).all()
    _assert_found_rows(q, t, ti, td, ji, jd, bv)
    _assert_expansion_match(q, t, ti, td, ji, jd, rows=~miss & (ji >= 0))
    if case == "morton":
        assert 0.2 < miss.mean() < 0.9
        # The visit mask skips cells at this bound, and only cells that hold
        # nothing below it: the answer equals that of visiting every cell.
        qb, ib = torch.from_numpy(q)[None], tknn.TargetIndex(*(f[None] for f in tidx))
        visit = tknn.pruned_visit_mask(qb, ib, float(bv), 128)
        assert visit.float().mean() < 0.8
        full = tknn.pruned_nn_search_plain(qb, ib.points, torch.ones_like(visit), float(bv),
                                           tile_q=128, tile_t=tile_t)
        np.testing.assert_array_equal(full[1][0].numpy(), td)
    # Against a float64 brute force: every row whose nearest point lies
    # below the bound by more than the rounding is found.
    d2 = ((q[:, None].astype(np.float64) - t[None]) ** 2).sum(-1)
    ri = np.argmin(d2, axis=1)
    within = d2[np.arange(len(q)), ri] + _exp_tol(q, t[ri], 3) < bv
    assert within.any() and (ti[within] >= 0).all()
    xi, xd = (x.numpy() for x in tknn.nn_search_pruned_xla(torch.from_numpy(q), tidx, maxd))
    jxi, jxd = (_n(x) for x in jknn.nn_search_pruned_xla(jnp.asarray(q), jidx, maxd))
    _assert_found_rows(q, t, xi, xd, jxi, jxd, maxd)
    assert (xd[xi < 0] == bv).all()
    _assert_expansion_match(q, t, xi, xd, jxi, jxd, rows=(xi >= 0) & (jxi >= 0))
    np.testing.assert_array_equal(xi[~miss], ti[~miss])


def test_pruned_plain_matches_dense_on_visited_tiles():
    """pruned_nn_search_plain with every cell visited and an infinite bound
    is the dense search; with a visit mask its answer is the dense search
    over the visited target tiles only, batched over two pairs."""
    q, t = _scene(1000, 300, 6, seed=3)
    qt, tt = torch.from_numpy(q)[None], torch.from_numpy(t)[None]
    di, dd = tknn.nn_search_xla(qt, tt)
    nqt, ntt = -(-300 // 64), -(-1000 // 128)
    all_vis = torch.ones((1, nqt, ntt), dtype=torch.bool)
    pi, pd = tknn.pruned_nn_search_plain(qt, tt, all_vis, float("inf"), tile_q=64, tile_t=128)
    assert torch.equal(pi, di) and torch.equal(pd, dd)
    rng = np.random.default_rng(4)
    vis = torch.from_numpy(rng.random((2, nqt, ntt)) < 0.5)
    q2, t2 = torch.cat([qt, qt.flip(1)]), torch.cat([tt, tt])
    pi, pd = tknn.pruned_nn_search(q2, t2, vis, 1e6, tile_q=64, tile_t=128)
    for b in range(2):
        for r in range(0, 300, 37):
            cols = torch.nonzero(vis[b, r // 64].repeat_interleave(128)[:1000]).flatten()
            if len(cols) == 0:
                assert pi[b, r] == -1
                continue
            ci, cd = tknn.nn_search_xla(q2[b, r:r + 1], t2[b, cols])
            assert pi[b, r] == cols[ci[0]] and pd[b, r] == cd[0]


@pytest.mark.parametrize("name", ["nn_search_xla", "dense_nn_search", "pruned_nn_search_plain",
                                  "pruned_nn_search", "nn_search_pruned", "nn_search_pruned_xla"])
def test_matchers_return_idx_then_d2(name):
    """Every exact 1-NN entry returns ``(idx, d2)``, int32 and f32; with
    every cell visited and a bound no row reaches, each equals the dense
    search bit for bit."""
    q, t = _scene(1500, 300, 3, seed=8)
    qt, tt = torch.from_numpy(q)[None], torch.from_numpy(t)[None]
    index = tknn.build_target_index(tt)
    visit = torch.ones((1, -(-300 // tknn.TILE_Q), index.bbox_min.shape[1]), dtype=torch.bool)
    kw = dict(tile_q=tknn.TILE_Q, tile_t=tknn.INDEX_TILE_T)
    calls = {
        "nn_search_xla": lambda: tknn.nn_search_xla(qt, tt),
        "dense_nn_search": lambda: tknn.dense_nn_search(qt, tt),
        "pruned_nn_search_plain": lambda: tknn.pruned_nn_search_plain(
            qt, index.points, visit, float("inf"), **kw),
        "pruned_nn_search": lambda: tknn.pruned_nn_search(
            qt, index.points, visit, float("inf"), **kw),
        "nn_search_pruned": lambda: tknn.nn_search_pruned(qt, index, 1e6),
        "nn_search_pruned_xla": lambda: tknn.nn_search_pruned_xla(qt, index, 1e6),
    }
    idx, d2 = calls[name]()
    want_i, want_d = tknn.nn_search_xla(qt, tt)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert torch.equal(idx, want_i) and torch.equal(d2, want_d)


def test_kernel_wrappers_refuse_other_devices_and_dims():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tknn.dense_nn_search(torch.zeros((1, 4, 3), **meta), torch.zeros((1, 8, 3), **meta))
    with pytest.raises(ValueError, match="D in"):
        tknn.dense_nn_search(torch.zeros((1, 4, 4), **meta), torch.zeros((1, 8, 4), **meta))
    vis = torch.ones((1, 1, 1), dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.pruned_nn_search(torch.zeros((1, 4, 3), **meta), torch.zeros((1, 8, 8), **meta),
                              vis, 1.0, tile_q=256, tile_t=512)
    with pytest.raises(ValueError, match="D in"):
        tknn.pruned_nn_search(torch.zeros((1, 4, 2), **meta), torch.zeros((1, 8, 8), **meta),
                              vis, 1.0, tile_q=256, tile_t=512)


# ---------------------------------------------------------------------------
# The seeded search's pose mode (TPU kernel 2e)
# ---------------------------------------------------------------------------


def _pose(angle, shift):
    c, s = np.cos(angle), np.sin(angle)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    p[:3, 3] = shift
    return p


@pytest.mark.parametrize("d", [3, 6])
def test_kd_cached_pose_matches_jax(d):
    """Two pairs, a pose each: the port's oracle on raw queries equals it on
    queries moved by se3.transform_points, bit for bit; the port against
    JAX's oracle with pose= (both pairs) and JAX's kernel in interpret mode
    (pair 0); match_kd_cached(pose=) with a query mask."""
    q, t = _scene(4000, 512, d, seed=20 + d, offset=0.0)
    jidx = jkd.build_kd_index(t, block_target=256)
    tidx = convert.kd_index_from_arrays(jidx, "cpu")
    poses = np.stack([_pose(0.3, [0.2, -0.1, 0.05]), _pose(-0.2, [-0.3, 0.1, 0.0])])
    maxd = 0.5
    raw, blks = [], []
    for p in poses:
        # Raw queries: the inverse pose's image of the scene queries, so the
        # pose brings them back near the targets.
        inv = np.linalg.inv(p.astype(np.float64))
        raw.append(np.concatenate([q[:, :3] @ inv[:3, :3].T + inv[:3, 3], q[:, 3:]], 1))
        q_t = raw[-1][:, :3].astype(np.float32) @ p[:3, :3].T + p[:3, 3]
        lb = _n(jkd._box_lb(jnp.asarray(np.concatenate([q_t, q[:, 3:]], 1)),
                            jidx.block_min, jidx.block_max))
        blk = np.argmin(lb, axis=1).astype(np.int32)
        blk[::11] = -1
        blks.append(blk)
    raw, blks = np.stack(raw).astype(np.float32), np.stack(blks)
    bidx = tkd.stack_kd_indexes([tidx, tidx])
    qr, pt, bt = torch.from_numpy(raw), torch.from_numpy(poses), torch.from_numpy(blks)
    ti, td = tkd.nn_search_kd_cached(qr, bidx, maxd, bt, pose=pt)
    moved = torch.cat([tse3.transform_points(qr[..., :3], pt), qr[..., 3:]], dim=-1)
    ri, rd = tkd.nn_search_kd_cached_oracle(moved, bidx, maxd, bt)
    assert torch.equal(ti, ri) and torch.equal(td, rd)
    assert (ti[:, ::11] == -1).all() and (ti >= 0).float().mean() > 0.5
    for b in range(2):
        ji, jd = (_n(x) for x in jkd.nn_search_kd_cached_oracle(
            jnp.asarray(raw[b]), jidx, maxd, jnp.asarray(blks[b]), pose=jnp.asarray(poses[b])))
        np.testing.assert_allclose(td[b].numpy(), jd, rtol=1e-4, atol=1e-6)
        assert (ti[b].numpy() == ji).mean() > 0.99
    ki, kd2 = (_n(x) for x in jkd.nn_search_kd_cached(
        jnp.asarray(raw[0]), jidx, maxd, jnp.asarray(blks[0]), interpret=True,
        pose=jnp.asarray(poses[0])))
    np.testing.assert_allclose(td[0].numpy(), kd2, rtol=1e-4, atol=1e-6)
    assert (ti[0].numpy() == ki).mean() > 0.99
    # One (4, 4) pose for an unbatched pair; a query mask freezes rows.
    ui, ud = tkd.nn_search_kd_cached(qr[1], tidx, maxd, bt[1], pose=pt[1])
    assert torch.equal(ui, ti[1]) and torch.equal(ud, td[1])
    mask = torch.ones_like(bt, dtype=torch.bool)
    mask[:, :50] = False
    mi, md, mv = tkd.match_kd_cached(qr, bidx, maxd, bt, query_mask=mask, pose=pt)
    assert not mv[:, :50].any() and (mi[:, :50] == -1).all()
    assert torch.equal(mi[:, 50:], ti[:, 50:])
    jm = _n(jkd.match_kd_cached(jnp.asarray(raw[0]), jidx, maxd, jnp.asarray(blks[0]),
                                query_mask=jnp.asarray(mask[0].numpy()), impl="xla",
                                pose=jnp.asarray(poses[0]))[2])
    assert (mv[0].numpy() != jm).sum() <= 2


# ---------------------------------------------------------------------------
# The eager per-stage profiler
# ---------------------------------------------------------------------------


def _pair(n=3000, seed=0):
    """A small ETH-style pair (moved copy, normals from the sheet)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-3, 3, (n, 2))
    z = 0.3 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])
    t = np.column_stack([xy, z]).astype(np.float32)
    nrm = np.column_stack([-0.3 * np.cos(xy[:, 0]) * np.cos(xy[:, 1]),
                           0.3 * np.sin(xy[:, 0]) * np.sin(xy[:, 1]), np.ones(n)])
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    colors = rng.uniform(0, 255, (n, 4)).astype(np.float32)
    pose = _pose(0.02, [0.03, -0.02, 0.01])
    src = (t - pose[:3, 3]) @ pose[:3, :3]
    return src.astype(np.float32), t, nrm, colors


def _configs():
    common = dict(max_distance=0.05, n_iterations=1)
    return {
        "geometry": dict(metric="SYMMETRIC", selection="RANDOM", selection_proba=0.3, **common),
        "colour": dict(metric="POINT_TO_PLANE", color_icp=True, **common),
        "projective": dict(metric="POINT_TO_PLANE", matching="PROJECTIVE", rejection=True,
                           **common),
    }


def _cfg(mod, kw):
    args = dict(kw)
    for key, enum in (("metric", mod.Metric), ("selection", mod.Selection),
                      ("matching", mod.Matching)):
        if key in args:
            args[key] = getattr(enum, args[key])
    cfg = mod.ICPConfig(minimizer=mod.Minimizer.LINEAR, **args)
    if cfg.matching == mod.Matching.PROJECTIVE:
        cfg = cfg.with_camera(fx=40.0, fy=40.0, cx=31.5, cy=23.5, width=64, height=48)
    return cfg


def _clouds(name):
    """(jax source, jax target) clouds for each config; the projective
    target is an image-shaped 64 x 48 grid seen from 2 m."""
    src, t, nrm, colors = _pair()
    if name == "projective":
        vv, uu = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
        z = 2.0 + 0.1 * np.sin(uu / 7.0) * np.cos(vv / 5.0)
        img = np.stack([(uu - 31.5) / 40.0 * z, (vv - 23.5) / 40.0 * z, z], -1).reshape(-1, 3)
        img = img.astype(np.float32)
        n_img = np.tile(np.array([[0, 0, -1]], np.float32), (len(img), 1))
        tgt = jcloud.from_numpy(img, normals=n_img)
        src = (img[::3] + np.float32([0.01, -0.01, 0.0])).astype(np.float32)
        return jcloud.from_numpy(src, normals=n_img[::3]), tgt
    return (jcloud.from_numpy(src, normals=nrm, colors=colors),
            jcloud.from_numpy(t, normals=nrm, colors=colors))


@pytest.mark.parametrize("name", ["geometry", "colour", "projective"])
def test_profile_stages_matches_jax(name):
    """profile_stages on the CPU: finite, non-negative fields, one
    repetition count, JAX's report lines; and the stage chain's increment
    on an injected selection mask against JAX's stage functions."""
    kw = _configs()[name]
    jcfg, tcfg = _cfg(jconfig, kw), _cfg(tconfig, kw)
    js, jt = _clouds(name)
    ts, tt = convert.cloud_from_arrays(js, "cpu"), convert.cloud_from_arrays(jt, "cpu")
    times = tprof.profile_stages(tcfg, ts, tt, repetitions=2, device="cpu")
    fields = {f: getattr(times, f) for f in tprof.StageTimes.__dataclass_fields__}
    assert times.n_iterations == 2
    assert all(np.isfinite(v) and v >= 0 for v in fields.values())
    assert times.matching > 0 and times.solver > 0 and times.total_wall > 0
    assert set(fields) == set(jprof.StageTimes.__dataclass_fields__)
    assert times.report() == jprof.StageTimes(**fields).report()
    # The increment of one stage chain on the same mask in both packages.
    rng = np.random.default_rng(3)
    mask = _n(js.valid) & (rng.random(js.capacity) < 0.5)
    pose = _pose(0.01, [0.01, 0.0, -0.01])
    inc, _ = tprof._iteration_stages(
        tcfg, tcloud.Cloud(*(f[None] for f in ts)), tcloud.Cloud(*(f[None] for f in tt)),
        torch.from_numpy(pose)[None], torch.from_numpy(mask)[None])
    jmask, jpose = jnp.asarray(mask), jnp.asarray(pose)
    pts = jnp.where(jmask[:, None], jse3.transform_points(js.points, jpose), jcloud.PAD_SENTINEL)
    nrm = jse3.transform_normals(js.normals, jpose)
    if name == "projective":
        idx, _, valid = jproj.projective_match(
            pts, jt.points, jt.valid, fx=jcfg.projective_fx, fy=jcfg.projective_fy,
            cx=jcfg.projective_cx, cy=jcfg.projective_cy, width=jcfg.projective_width,
            height=jcfg.projective_height, window=jcfg.projective_window,
            max_distance=jcfg.max_distance, query_mask=jmask)
    elif name == "colour":
        idx, _, valid = jknn.match(jknn.color_features(pts, js.colors),
                                   jknn.color_features(jt.points, jt.colors),
                                   jcfg.max_distance, query_mask=jmask)
    else:
        idx, _, valid = jknn.match(pts, jt.points, jcfg.max_distance, query_mask=jmask)
    idx = jnp.clip(idx, 0, jt.capacity - 1)
    m = jw.MatchArrays(src_points=pts, tgt_points=jt.points[idx], src_normals=nrm,
                       tgt_normals=jt.normals[idx], src_colors=js.colors,
                       tgt_colors=jt.colors[idx], valid=valid & jt.valid[idx])
    w = jw.apply_weights(jcfg.weighting, m, jcfg.max_distance)
    if jcfg.rejection:
        m = m._replace(valid=jrej.normal_angle_mask(m.src_normals, m.tgt_normals, m.valid))
    assert int(m.valid.sum()) > 100
    np.testing.assert_allclose(inc[0].numpy(), _n(jicp._solve(jcfg, m, w)), atol=1e-5)


def test_trace_writes_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")):
        with spans.span("icp.matching"):
            tknn.nn_search(torch.zeros(8, 3), torch.ones(16, 3))
    path = tmp_path / "t" / "trace.json"
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "icp_span"]
    assert [e["name"] for e in mine] == ["icp.matching"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == mine[0]["tid"]]
    assert ops and all(mine[0]["ts"] <= e["ts"] <= mine[0]["ts"] + mine[0]["dur"] for e in ops)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version (chip_smoke.py runs
# the full-size checks)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_dense_and_pruned_match_plain_on_card(d):
    """dense_nn_search and pruned_nn_search (nn_search_pruned at a tight
    and a loose bound) against their plain versions on the card, bit for
    bit, on two pairs with sentinel queries and duplicated targets; the
    cached search's pose mode against its oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    q, t = _scene(5000, 3001, d, seed=30 + d)
    t[4000:4100] = t[100:200]
    q[::13, :3] = tcloud.PAD_SENTINEL
    qc, tc = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    q2, t2 = torch.stack([qc, qc.flip(0)]), torch.stack([tc, tc.flip(0)])
    got, want = tknn.dense_nn_search(q2, t2), tknn.nn_search_xla(q2, t2)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    idx = tknn.build_target_index(t2)
    for maxd in (0.01, 10.0):
        bv = tknn.bound_value(maxd)
        visit = tknn.pruned_visit_mask(q2, idx, bv)
        args = (q2, idx.points, visit, bv)
        got = tknn.pruned_nn_search(*args, tile_q=tknn.TILE_Q, tile_t=tknn.INDEX_TILE_T)
        want = tknn.pruned_nn_search_plain(*args, tile_q=tknn.TILE_Q, tile_t=tknn.INDEX_TILE_T)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), maxd
        assert bool((got[0] >= 0).any())
    kd = tkd.build_kd_index(t, block_target=256, device=dev)
    kd = tkd.KDIndex(*(None if f is None else f[None] for f in kd))
    pose = torch.from_numpy(_pose(0.1, [0.05, -0.02, 0.01])).to(dev)
    blk = tkd.box_topk(qc[None], torch.full((1, len(q)), 0.5, device=dev),
                       kd.block_min, kd.block_max, 1)[0][..., 0]
    blk[:, ::5] = -1
    got = tkd.nn_search_kd_cached(qc[None], kd, 0.5, blk, pose=pose)
    want = tkd.nn_search_kd_cached_oracle(qc[None], kd, 0.5, blk, pose=pose)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The matchers' contract on hard inputs, and the pruned search's workspace
# ---------------------------------------------------------------------------

NN_N, NN_M = 1337, 5000          # neither a multiple of NN_BAND, tile_q or a group
NN_TILE_QS = (100, 256, 600)     # below, at and above a band, no multiple of 64
NN_EMPTY_TILE = 0                # the query tile of pair 0 that visits no cell


def _nn_contract_pair(d, seed):
    """One pair of hard inputs (f32 numpy, queries (NN_N, d), targets
    (NN_M, d)): targets on a sheet 15 m from the origin ordered far to near
    from the queries' centre (so a row's best falls late in the walk),
    rows 100-139 repeated 2,600 rows later (ties across tiles, chunks and
    groups) with queries on both copies, queries within 1e-5 of target rows
    (their expansion d2 cancels, often below 0) and every 13th query at the
    pad sentinel."""
    q, t = _scene(NN_M, NN_N, d, seed=seed)
    t = t[np.argsort(-((t[:, :3] - q[:, :3].mean(0)) ** 2).sum(1), kind="stable")]
    t[2700:2740] = t[100:140]
    q[3:123:3] = t[100:140]
    rng = np.random.default_rng(seed)
    near = t[rng.integers(0, NN_M, len(q[5::17]))]
    q[5::17] = near + rng.normal(0, 1e-5, near.shape).astype(np.float32)
    q[::13, :3] = tcloud.PAD_SENTINEL
    return q, t


def _nn_contract_inputs(d, seed=60):
    """B = 3 pairs of :func:`_nn_contract_pair`; the bound of the pruned
    search is the plain dense d2 of one row of pair 0 (that row ends at
    (-1, bound)); returns (q, t, bound, that row) as CPU tensors."""
    pairs = [_nn_contract_pair(d, seed + 7 * i) for i in range(3)]
    q = torch.from_numpy(np.stack([p[0] for p in pairs]))
    t = torch.from_numpy(np.stack([p[1] for p in pairs]))
    _, d2 = tknn.nn_search_xla(q, t)
    real = d2[0] < 1e3
    row = int(torch.nonzero(real)[int(0.7 * int(real.sum()))])
    return q, t, float(d2[0, row]), row


def _nn_contract_visit(q, t, idx, row, tile_q, tile_t, seed):
    """A random visit mask (B, ceil(N / tile_q), ceil(M / tile_t)) with
    about 60% of the cells set, pair 0's query tile NN_EMPTY_TILE visiting
    none and the bound row's nearest cell visited."""
    b, n = q.shape[:2]
    shape = (b, -(-n // tile_q), -(-t.shape[1] // tile_t))
    visit = torch.from_numpy(np.random.default_rng(seed).random(shape) < 0.6)
    visit[0, NN_EMPTY_TILE] = False
    visit[0, row // tile_q, int(idx[0, row]) // tile_t] = True
    return visit


def _prefix_drops(q, t):
    """For each query row of pair 0: the number of 32-row groups in which
    its running minimum (in target row order) falls strictly."""
    qn, tn = tknn.norm2(q[:1]), tknn.norm2(t[:1])
    d2 = tknn.expanded_d2(q[:1], qn, t[:1], tn)[0]
    m = d2.shape[1]
    gmin = torch.nn.functional.pad(d2, (0, -m % 32), value=float("inf")).reshape(
        d2.shape[0], -1, 32).amin(-1)
    run = torch.cummin(gmin, dim=1).values
    return (run[:, 1:] < run[:, :-1]).sum(1) + 1


@pytest.mark.parametrize("d", [3, 6])
def test_nn_contract_inputs_hold_hard_cases(d):
    """The card contract test's inputs (built here on the CPU) hold every
    case it names, and the two facts its kernels rest on hold on their
    values in float64 emulation: fma(-2, g, s) rounds to the plain
    version's s - 2g, and the ordered 64-bit key sorts (d2, row) as the
    plain version's first minimum does."""
    q, t, bound, row = _nn_contract_inputs(d)
    b, n, m = q.shape[0], q.shape[1], t.shape[1]
    assert b == 3 and n % tknn.NN_BAND and m % tknn.NN_GROUP
    assert all(n % tq for tq in NN_TILE_QS)
    assert -(-n // tknn.NN_BAND) * b < 132                      # fewer bands than SMs
    assert bool((q[:, ::13, 0] == tcloud.PAD_SENTINEL).all())   # sentinel rows
    idx, d2 = tknn.nn_search_xla(q, t)
    assert int((d2 < 0).sum()) > 10                             # negative expansion d2
    # Ties across tiles and chunks: rows whose least d2 sits at two rows
    # 2,600 apart (the lower one found).
    tied = (idx[:, 3:123:3] >= 100) & (idx[:, 3:123:3] < 140)
    assert int(tied.sum()) > 30
    qn, tn = tknn.norm2(q), tknn.norm2(t)
    for p in range(b):
        for r in torch.nonzero(tied[p]).flatten()[:5].tolist():
            r = 3 + 3 * r
            full = tknn.expanded_d2(q[p:p + 1, r:r + 1], qn[p:p + 1, r:r + 1], t[p:p + 1],
                                    tn[p:p + 1])[0, 0]
            at = torch.nonzero(full == d2[p, r]).flatten()
            assert len(at) >= 2 and int(at[0]) == int(idx[p, r]) and int(at[-1]) >= 2700
    # The best falls late: in several groups, and past the first half.
    drops = _prefix_drops(q, t)
    assert float((drops >= 4).float().mean()) > 0.5
    assert float((idx[0] >= m // 2).float().mean()) > 0.25
    # The pruned search's cases, at each tile_q.
    assert float(d2[0, row]) == bound and row >= max(NN_TILE_QS)
    for tq in NN_TILE_QS:
        visit = _nn_contract_visit(q, t, idx, row, tq, tknn.INDEX_TILE_T, seed=tq)
        assert not bool(visit[0, NN_EMPTY_TILE].any())
        pi, pd = tknn.pruned_nn_search_plain(q, t, visit, bound, tile_q=tq,
                                             tile_t=tknn.INDEX_TILE_T)
        assert int(pi[0, row]) == -1 and float(pd[0, row]) == bound   # best == bound
        assert bool((pi >= 0).any()) and bool((pi < 0).any())
        assert bool((pd[pi >= 0] < 0).any())                    # negative d2 kept
    # float64 emulation of the kernel's last step and of its merge key.
    qf, tf = q[0, :200].numpy(), t[0].numpy()
    f32 = np.float32
    g = qf[:, None, 0] * tf[None, :, 0]
    for j in range(1, d):
        g = (g + qf[:, None, j] * tf[None, :, j]).astype(f32)
    s = (tknn.norm2(q[0, :200]).numpy()[:, None] + tknn.norm2(t[0]).numpy()[None]).astype(f32)
    plain = (s - (g * f32(2)).astype(f32)).astype(f32)
    a, c = s.astype(np.float64), -2.0 * g.astype(np.float64)
    e = a + c                                                   # TwoSum: e exact iff err 0
    bb = e - a
    assert not np.any((a - (e - bb)) + (c - bb))
    np.testing.assert_array_equal(e.astype(f32).view(np.uint32), plain.view(np.uint32))
    assert (plain < 0).any()
    u = plain.view(np.uint32)
    ordk = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    keys = (ordk << np.uint64(32)) | np.arange(plain.shape[1], dtype=np.uint64)[None]
    want_i, want_d = tknn.nn_search_xla(q[0, :200], t[0])
    best = keys.min(1)
    np.testing.assert_array_equal((best & np.uint64(0xffffffff)).astype(np.int32),
                                  want_i.numpy())
    hi = (best >> np.uint64(32)).astype(np.uint32)
    back = np.where(hi & 0x80000000, hi & 0x7fffffff, ~hi).astype(np.uint32).view(f32)
    np.testing.assert_array_equal(back, want_d.numpy())
    vals = np.array([-2.5, -1e-30, 0.0, 1e-30, 3.0, np.inf, -np.inf, 3.0, -2.5], f32)
    rows = np.arange(len(vals), dtype=np.uint64)
    uv = vals.view(np.uint32)
    kv = (np.where(uv & 0x80000000, ~uv, uv | 0x80000000).astype(np.uint64) << np.uint64(32)) | rows
    np.testing.assert_array_equal(np.argsort(kv, kind="stable"), np.lexsort((rows, vals)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_dense_and_pruned_contract_on_card(d):
    """dense_nn_search and pruned_nn_search equal their plain versions bit
    for bit on the hard inputs that test_nn_contract_inputs_hold_hard_cases
    checks: negative expansion d2, exact ties across tiles and chunks (the
    lower row wins whichever CTA merges first), a row whose best equals the
    bound (-1), a query tile that visits no cell, N a multiple of neither
    the band nor tile_q at B = 3, targets ordered far to near, fewer bands
    than SMs, sentinel query rows; tile_q below, at and above a band; the
    targets with more columns than features. With 4-row target tiles the
    visited cells outnumber the walk's CTAs, so each CTA walks runs of
    several items, in the list's order (which changes from call to call:
    several calls each); there the counting build shows that some CTA
    walked a band's tiles out of order and that every rescan found its
    row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    dev = torch.device("cuda")
    q, t, _, _ = _nn_contract_inputs(d)
    q, t = q.to(dev), t.to(dev)
    want = tknn.nn_search_xla(q, t)
    got = tknn.dense_nn_search(q, t)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    real = want[1][0] < 1e3
    row = int(torch.nonzero(real)[int(0.7 * int(real.sum()))])
    bound = float(want[1][0, row])
    t8 = torch.nn.functional.pad(t, (0, 8 - d))
    for tq, tt in [(tq, tknn.INDEX_TILE_T) for tq in NN_TILE_QS] + [(256, 4)]:
        visit = _nn_contract_visit(q, t, want[0], row, tq, tt, seed=tq).to(dev)
        args = (q, t8, visit, bound)
        kw = dict(tile_q=tq, tile_t=tt)
        want_p = tknn.pruned_nn_search_plain(*args, **kw)
        # The list's order changes from call to call: several calls, and with
        # 4-row tiles on the counting build, whose counts show that CTAs
        # walked a band's tiles out of order.
        counts = (ctypes.c_ulonglong * 6)()
        if tt == 4:
            read = _cuda.variant("dense_nn_search.cu", chip_smoke.NN_COUNT_DEFINES).nn_search_counts
            read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
            torch.cuda.synchronize()
            assert read(counts, 1) == 0
        for _ in range(3):
            runs = [tknn.pruned_nn_search(*args, **kw)]
            if tt == 4:
                runs.append(tknn._pruned_nn_search_launch(*args, tq, tt,
                                                          chip_smoke.NN_COUNT_DEFINES))
            torch.cuda.synchronize()
            for got_p in runs:
                assert torch.equal(got_p[0], want_p[0]) and torch.equal(got_p[1], want_p[1]), tt
        if tt == 4:
            assert read(counts, 1) == 0
            assert counts[4] == 0 and counts[5] > 0, list(counts)   # no miss; tiles out of order
        assert int(want_p[0][0, row]) == -1 and bool((want_p[1][want_p[0] >= 0] < 0).any())


@pytest.mark.parametrize("b,n,m,d,tile_q,tile_t", [
    (1, 4352, 365_056, 3, 256, 512), (1, 307_200, 307_200, 6, 256, 512),
    (3, 1337, 5000, 6, 600, 100)])
def test_pruned_search_workspace_bytes(b, n, m, d, tile_q, tile_t):
    """The wrapper's scratch size is the kernel's: the packed target tiles
    (each padded to whole groups, 16 or 32 bytes a record), a 64-bit key a
    row, the item count, then one int for every (pair, query tile, band,
    target tile) item; each piece 16-byte aligned."""
    n_tiles, pad = -(-m // tile_t), -(-tile_t // 32) * 32
    items = b * -(-n // tile_q) * -(-tile_q // 256) * n_tiles
    rec = 16 if d == 3 else 32
    a16 = lambda x: -(-x // 16) * 16  # noqa: E731
    want = a16(b * n_tiles * pad * rec) + a16(8 * b * n) + 16 + a16(4 * items)
    assert tknn._pruned_search_workspace_bytes(b, n, m, d, tile_q, tile_t) == want
    assert tknn._dense_search_workspace_bytes(b, m, d) == b * -(-m // 32) * 32 * rec


def test_pruned_search_workspace_bytes_refuses():
    """Tilings the kernel does not take are refused before any launch."""
    ws = tknn._pruned_search_workspace_bytes
    with pytest.raises(ValueError, match="hold a row"):
        ws(1, 8, 100, 3, 0, 512)
    with pytest.raises(ValueError, match="hold a row"):
        ws(1, 8, 100, 3, 256, 0)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ws(1, 8, 2**31, 3, 256, 1)       # packed rows past an int32
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ws(64, 2**20, 2**20, 3, 1, 64)   # items past an int32


@pytest.mark.parametrize("name", ["dense_nn_search", "pruned_nn_search"])
def test_nn_search_launch_takes_its_workspace(monkeypatch, name):
    """On a CUDA tensor each entry launches its kernel once with the
    workspace its bytes function sizes, and arguments matching the C
    entry's types (launch and checks replaced, meta tensors)."""
    calls = []
    monkeypatch.setattr(_cuda, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(_cuda, "launch",
                        lambda name, *args, defines=(): calls.append((name, args)))
    b, n, m, d = 3, 1337, 5000, 6
    q = torch.zeros((b, n, d), device="meta")
    if name == "dense_nn_search":
        tknn.dense_nn_search(q, torch.zeros((b, m, d), device="meta"))
    else:
        visit = torch.zeros((b, -(-n // 600), -(-m // 100)), dtype=torch.bool, device="meta")
        tknn.pruned_nn_search(q, torch.zeros((b, m, 8), device="meta"), visit, 0.25,
                              tile_q=600, tile_t=100)
    (called, args), = calls
    assert called == name
    argtypes = _cuda.KERNELS[name][2]
    assert len(args) + 1 == len(argtypes)  # the stream is appended at launch
    for a, t in zip(args, argtypes):
        if isinstance(a, torch.Tensor):
            assert t is ctypes.c_void_p
        elif isinstance(a, float):
            assert t is ctypes.c_float
        else:
            assert t in (ctypes.c_int, ctypes.c_longlong), (a, t)
    if name == "dense_nn_search":
        ws, ws_bytes = args[4], args[5]
        assert ws_bytes == ws.numel() == tknn._dense_search_workspace_bytes(b, m, d)
        assert args[6:] == (b, n, m, d)
    else:
        assert args[3] == 0.25
        ws, ws_bytes = args[6], args[7]
        assert ws_bytes == ws.numel() == tknn._pruned_search_workspace_bytes(b, n, m, d, 600, 100)
        assert args[8:] == (b, n, m, 8, 600, 100, d)


def test_rescan_count_build_is_kept_apart_from_the_production_build():
    """The dense and pruned searches' rescan-counting build (chip_smoke's
    ``rescan_reading``) gets a library path of its own, so it never
    replaces the production build; the source guards its counters and
    their reader behind the define; and its launch path refuses CPU
    tensors rather than running the plain version."""
    import chip_smoke

    src = _cuda.CSRC / "dense_nn_search.cu"
    prod, counting = _cuda._lib_path(src), _cuda._lib_path(src, chip_smoke.NN_COUNT_DEFINES)
    assert prod != counting and prod.parent == counting.parent
    assert counting.name.startswith("dense_nn_search-nn_rescan_count-")
    text = src.read_text()
    assert text.count("#ifdef NN_RESCAN_COUNT") >= 3
    guarded = text[text.rindex("#ifdef NN_RESCAN_COUNT"):]
    assert 'extern "C" int nn_search_counts(' in guarded
    q = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tknn._dense_nn_search_launch(q, torch.zeros((1, 8, 3)), chip_smoke.NN_COUNT_DEFINES)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tknn._pruned_nn_search_launch(q, torch.zeros((1, 8, 8)),
                                      torch.ones((1, 1, 1), dtype=torch.bool), 1.0, 256, 512,
                                      chip_smoke.NN_COUNT_DEFINES)
