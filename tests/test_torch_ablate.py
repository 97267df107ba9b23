"""The visited-list ablation (TPU kernel ``scripts/knn_ablate.py``
``make_kernel``, ported as ``csrc/visited_ablate.cu``) held against the JAX
script's kernel in Pallas interpret mode on the CPU, and the cluster
kernel's merge of a chunk's column slices (emulated here at 1, 2, 8 and 16
CTAs a cluster) held against the plain version on hand-built inputs with
planted merge cases, which the card test runs through the kernel.

The JAX kernel is built here with ``search``'s grid spec
(``knn_ablate.py:184-220``) and ``interpret=True``; the script is imported
from ``scripts/`` as it stands. Inputs: a Morton-ordered surface sheet of
8,192 targets in 512-row tiles, 2,048 noisy queries over half of it in
eight 256-row tiles, chunks of 2 tiles, squared bound 1: each query tile
lists a part of the 16 tiles and the prune ends some walks early.

Tolerances: indices are equal except at ties within the expansion's
rounding, and distances of the expansion modes agree within it:
``(2D + 2) 2^-24 (|q|^2 + |t|^2)`` (``chip_smoke.expansion_tol``: the D
products and sums of q.t and of each norm, rounded once each; the JAX
script sums under jit in another order). Direct differences agree to 2
ulp. The TF32 modes are held against the exact plain modes within
``knn_ablate.tf32_error_bound``, and on the card against their own plain
version within ``knn_ablate.tf32_order_bound``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from icp_variants_tpu.ops import knn as jknn
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.scripts import knn_ablate as tab

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import knn_ablate as jab  # noqa: E402  (the JAX package's script, unchanged)

torch.set_num_threads(2)

N_T, N_Q, TILE_T, CHUNK, MAXD = 8192, 2048, 512, 2, 1.0


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    xy = rng.uniform(-8, 8, (N_T, 2))
    t = np.column_stack([xy, 0.5 * np.sin(xy[:, 0]) * np.cos(xy[:, 1])]).astype(np.float32)
    t = t[np.argsort(tknn.morton_codes_np(t))]
    west = np.flatnonzero(t[:, 0] < 0)
    q = (t[rng.choice(west, N_Q)] + rng.normal(0, 0.2, (N_Q, 3))).astype(np.float32)
    q = q[np.argsort(tknn.morton_codes_np(q))]
    inp = tab.ablate_inputs(torch.from_numpy(q), torch.from_numpy(t), MAXD, tile_t=TILE_T,
                            chunk=CHUNK)
    return dict(q=q, t=t, inp=inp)


def _jax_lists(case):
    """The JAX script's operands (knn_ablate.main's), for its kernel."""
    index = jknn.build_target_index(jnp.asarray(case["t"]), tile_t=TILE_T)
    bound_val = jnp.float32(MAXD) * (1 + 1e-6) + 1e-30
    qp = jknn._pad_rows(jknn._pad_features(jnp.asarray(case["q"])), 256, 0.0)
    qn2 = jnp.sum(qp * qp, axis=1, keepdims=True)
    qt = qp.reshape(-1, 256, jknn.FEATURE_PAD)
    vlist, suffix, counts, _ = jknn._visit_lists(
        jnp.min(qt, axis=1), jnp.max(qt, axis=1), index.bbox_min, index.bbox_max, bound_val)
    n_tiles = index.points.shape[0] // TILE_T
    max_v = ((n_tiles + 127) // 128) * 128
    vlist = jnp.pad(vlist, ((0, 0), (0, max_v - n_tiles)))
    suffix = jnp.pad(suffix, ((0, 0), (0, max_v - n_tiles)), constant_values=jknn._LB_PAD)
    return dict(index=index, qn2=qn2, q_aug=qp.at[:, 7].set(-1.0), vlist=vlist,
                suffix=suffix, counts=(counts + CHUNK - 1) // CHUNK, max_v=max_v,
                bv=jnp.asarray([bound_val], jnp.float32))


def _jax_search(lists, mode):
    """knn_ablate.search with interpret=True: (d2, idx), (N,) each."""
    q_aug, max_v = lists["q_aug"], lists["max_v"]
    nqt = q_aug.shape[0] // 256
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(nqt,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 3 + [
            pl.BlockSpec((256, 8), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((256, 1), lambda i, *_: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=[pl.BlockSpec((256, 1), lambda i, *_: (i, 0), memory_space=pltpu.VMEM)] * 2,
        scratch_shapes=[
            pltpu.SMEM((8, max_v), jnp.int32),
            pltpu.SMEM((8, max_v), jnp.float32),
            pltpu.SMEM((2,), jnp.int32),
            pltpu.VMEM((2, 8, CHUNK * TILE_T), jnp.float32),
            pltpu.SemaphoreType.DMA((2, CHUNK)),
            pltpu.SemaphoreType.DMA(()),
            pltpu.SemaphoreType.DMA(()),
        ],
    )
    vlist = jnp.broadcast_to(lists["vlist"][:, None, :], (nqt, 8, max_v))
    suffix = jnp.broadcast_to(lists["suffix"][:, None, :], (nqt, 8, max_v))
    d2, idx = pl.pallas_call(
        jab.make_kernel(TILE_T, max_v, CHUNK, mode),
        grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((q_aug.shape[0], 1), jnp.float32),
                   jax.ShapeDtypeStruct((q_aug.shape[0], 1), jnp.int32)],
        interpret=True,
    )(lists["counts"], lists["bv"], vlist, suffix, lists["index"].points_t3, q_aug,
      lists["qn2"])
    return np.asarray(d2)[:, 0], np.asarray(idx)[:, 0]


def test_inputs_match_jax_script(case):
    """The hoisted lists, augmented pages and queries equal the JAX
    script's (pages' 0.5|t|^2 row and qn2 within their sums' rounding)."""
    inp, lists = case["inp"], _jax_lists(case)
    np.testing.assert_array_equal(inp.vlist.numpy(), np.asarray(lists["vlist"]))
    np.testing.assert_array_max_ulp(inp.suffix.numpy(), np.asarray(lists["suffix"]), maxulp=2)
    np.testing.assert_array_equal(inp.counts.numpy(), np.asarray(lists["counts"]))
    np.testing.assert_array_equal(inp.q_aug.numpy(), np.asarray(lists["q_aug"]))
    np.testing.assert_array_max_ulp(inp.qn2.numpy(), np.asarray(lists["qn2"])[:, 0], maxulp=2)
    np.testing.assert_array_max_ulp(inp.pages.numpy(), np.asarray(lists["index"].points_t3),
                                    maxulp=2)
    counts = inp.counts.numpy()
    assert counts.min() >= 2 and counts.max() < TILE_T // CHUNK


def _expansion_tol(q, t):
    """The expansion's rounding bound for f64 rows ``q`` against ``t``."""
    return 8 * 2.0 ** -24 * ((q ** 2).sum(-1) + (t ** 2).sum(-1))


def _tied(q, t, ia, ib):
    """Where two index arrays differ, both targets are real and lie at
    squared distances from the query within the rounding of each other."""
    diff = np.flatnonzero(ia != ib)
    assert len(diff) <= max(2, len(ia) // 100), len(diff)
    if len(diff):
        assert (ia[diff] >= 0).all() and (ib[diff] >= 0).all()
        qa = q[diff].astype(np.float64)
        ta, tb = t[ia[diff]].astype(np.float64), t[ib[diff]].astype(np.float64)
        da, db = ((qa - ta) ** 2).sum(1), ((qa - tb) ** 2).sum(1)
        assert (np.abs(da - db) <= _expansion_tol(qa, ta) + _expansion_tol(qa, tb)).all()


@pytest.mark.parametrize("mode", ["full", "noprune", "maxonly", "dmaonly", "direct"])
def test_ablation_modes_match_jax_interpret(case, mode):
    inp = case["inp"]
    jd, ji = _jax_search(_jax_lists(case), mode)
    td, ti = (x.numpy() for x in tab.ablate_search_plain(inp, mode))
    q = np.zeros((len(td), 3), np.float32)
    q[:N_Q] = case["q"]
    t = np.concatenate([case["t"], np.full((1, 3), np.nan, np.float32)])
    tol = _expansion_tol(q.astype(np.float64), np.nan_to_num(t[ti].astype(np.float64)))
    if mode == "dmaonly":
        assert (td == inp.bound).all() and (ti == -1).all()
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(ji, ti)
        return
    if mode == "maxonly":
        assert (ti == -1).all() and (ji == -1).all()
    else:
        _tied(q, case["t"], ti, ji)
        assert (ti >= 0).mean() > 0.9
    if mode == "direct":
        np.testing.assert_array_max_ulp(td, jd, maxulp=2)
    else:
        assert (np.abs(td.astype(np.float64) - jd) <= tol).all()


def test_exact_modes_agree_and_match_brute_force(case):
    """full, noprune and direct find the brute-force nearest target on
    every row within the bound, up to the expansion's rounding; maxonly's
    distances are full's."""
    inp = case["inp"]
    full = [x.numpy() for x in tab.ablate_search_plain(inp, "full")]
    q = case["q"].astype(np.float64)
    t = case["t"].astype(np.float64)
    d2 = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    ref = d2.min(1)
    tol = _expansion_tol(q, t[d2.argmin(1)])
    for mode in ("full", "noprune", "direct"):
        td, ti = (x.numpy()[:N_Q] for x in tab.ablate_search_plain(inp, mode))
        inside = ref < inp.bound - tol
        assert (ti[inside] >= 0).all(), mode
        got = d2[np.arange(N_Q)[inside], ti[inside]]
        assert (np.abs(got - ref[inside]) <= tol[inside]).all(), mode
        assert (np.abs(td[inside] - ref[inside]) <= tol[inside]).all(), mode
        assert (ti[ref > inp.bound + tol] == -1).all(), mode
    np.testing.assert_array_equal(tab.ablate_search_plain(inp, "maxonly")[0].numpy(), full[0])


@pytest.mark.parametrize("mode", ["default", "high"])
def test_tf32_modes_within_their_bound(case, mode):
    """The TF32 modes' distances lie within tf32_error_bound of the exact
    full mode's, taken at both modes' winners; high's bound is far below
    default's and default really rounds."""
    inp = case["inp"]
    fd, fi = tab.ablate_search_plain(inp, "full")
    md, mi = tab.ablate_search_plain(inp, mode)
    e = torch.maximum(tab.tf32_error_bound(inp, mode, mi), tab.tf32_error_bound(inp, mode, fi))
    assert bool(((md - fd).abs() <= e).all())
    assert bool((mi >= -1).all() and (mi < inp.pages.shape[0] * TILE_T).all())
    if mode == "default":
        assert float((md - fd).abs().max()) > 0
    assert tab.TF32_GAMMA["high"] < tab.TF32_GAMMA["default"] / 50


@pytest.mark.parametrize("mode", ["full", "noprune", "default", "high", "direct"])
def test_plain_d2_at_reproduces_the_plain_winners(case, mode):
    """plain_d2_at rounds as the plain search does: at the search's own
    winners it gives the plain d2 bit for bit, and the bound elsewhere."""
    inp = case["inp"]
    d2, idx = tab.ablate_search_plain(inp, mode)
    assert (idx >= 0).all()
    assert torch.equal(tab.plain_d2_at(inp, mode, idx), d2)
    none = torch.full_like(idx, -1)
    assert (tab.plain_d2_at(inp, mode, none) == inp.bound).all()


@pytest.mark.parametrize("mode", ["default", "high"])
def test_tf32_check_holds_a_winner_to_its_plain_version(case, mode):
    """tf32_check passes the plain result against itself and catches a
    wrong winner that reports its own distance: each found row's
    neighbouring target in the tile, with that target's plain d2."""
    inp = case["inp"]
    d2, idx = tab.ablate_search_plain(inp, mode)
    assert tab.tf32_check(inp, mode, (d2, idx), (d2, idx)) == (0.0, 0)
    assert tab.tf32_order_bound(inp, idx).max() < tab.tf32_error_bound(inp, mode, idx).max() / 3
    found = idx >= 0
    wrong = torch.where(found, idx ^ 1, idx)
    worst, n_other = tab.tf32_check(inp, mode, (tab.plain_d2_at(inp, mode, wrong), wrong),
                                    (d2, idx))
    assert worst > 1 and n_other == int(found.sum())
    # A d2 that is not the named target's fails though the winner is right.
    worst, n_other = tab.tf32_check(inp, mode, (torch.where(found, d2 * 0.9, d2), idx),
                                    (d2, idx))
    assert worst > 1 and n_other == 0


def test_ablate_work_counts_what_the_run_scored(case):
    """Bytes and operations of each mode from the chunks its run scored:
    the prune scores no more than noprune, dmaonly has no operations."""
    inp = case["inp"]
    runs = {m: tab._ablate_plain(inp, m)[2] for m in ("full", "noprune", "dmaonly")}
    assert (runs["full"] <= runs["noprune"]).all() and (runs["full"] < runs["noprune"]).any()
    assert torch.equal(runs["noprune"], inp.counts.long())
    assert torch.equal(runs["dmaonly"], runs["noprune"])
    cols = int(runs["full"].sum()) * CHUNK * TILE_T * 256
    nbytes, ops, kind = tab.ablate_work(inp, "full", runs["full"])
    assert ops == cols * 8 and kind == "f32" and nbytes > 0
    assert tab.ablate_work(inp, "dmaonly", runs["dmaonly"])[1] == 0
    assert tab.ablate_work(inp, "default", runs["full"])[2] == "tf32"


def test_ablate_search_refuses_unknown_modes(case):
    with pytest.raises(ValueError, match="mode"):
        tab.ablate_search(case["inp"], "fast")


@pytest.mark.cuda
def test_ablation_kernel_matches_plain_on_card(case):
    """Every mode of csrc/visited_ablate.cu against its plain version on
    the card: the exact modes bit for bit, the TF32 modes within
    tf32_order_bound of their own plain version (tf32_check) and within
    their tf32_error_bound of the exact plain result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp = tab.AblateInputs(*(x.cuda() if isinstance(x, torch.Tensor) else x
                             for x in case["inp"]))
    fd, fi = tab.ablate_search_plain(inp, "full")
    for mode in tab.MODES:
        kd, ki = tab.ablate_search(inp, mode)
        torch.cuda.synchronize()
        if mode in ("default", "high"):
            worst, _ = tab.tf32_check(inp, mode, (kd, ki), tab.ablate_search_plain(inp, mode))
            assert worst <= 1.0, (mode, worst)
            e = torch.maximum(tab.tf32_error_bound(inp, mode, ki),
                              tab.tf32_error_bound(inp, mode, fi))
            assert bool(((kd - fd).abs() <= e).all()), mode
        else:
            pd, pi = tab.ablate_search_plain(inp, mode)
            assert torch.equal(kd, pd) and torch.equal(ki, pi), mode


# ---------------------------------------------------------------------------
# The cluster kernel's contract: slices of each chunk merged across a thread
# block cluster (csrc/visited_ablate.cu), on inputs with planted cases
# ---------------------------------------------------------------------------

C_TILE_T, C_TILES, C_NQT = 40, 32, 5
C_BOUND = float(tknn.bound_value(1.0))
C_FAR = -40.0


def _half_norm(t):
    """0.5 |t|^2 over the first seven columns of the (n, d) f32 rows, as
    augment_pages rounds it."""
    pad = np.zeros((len(t), 7), np.float32)
    pad[:, :t.shape[1]] = t
    return (tknn.norm2(torch.from_numpy(pad)) * 0.5).numpy()


def _pair_g_d2(q, t, d):
    """g and the expansion's d2 of f32 query ``q`` against target ``t`` (d
    features each), rounded as the plain search rounds them."""
    qa = np.zeros((1, 8), np.float32)
    qa[0, :d] = q
    qa[0, 7] = -1.0
    qn2 = tknn.norm2(torch.from_numpy(np.pad(q[None], ((0, 0), (0, 8 - d)))))
    rows = list(range(d)) + [7]
    tt = np.zeros((1, 8), np.float32)
    tt[0, :d] = t
    tt[0, 7] = _half_norm(t[None])[0]
    g = tab._dot(torch.from_numpy(qa[:, rows])[None], torch.from_numpy(tt[:, rows].T)[None])
    return float(g[0, 0, 0]), float(qn2[0] - g[0, 0, 0] * 2.0)


def _collision(q, base, d, rng):
    """Two targets a few ulp from ``base`` (in its nonzero features),
    ``(t_a, t_b)``, where t_b's g against ``q`` is strictly larger than
    t_a's while both round to one d2."""
    def near(t):
        step = np.where(t != 0, rng.integers(-4, 5, d), 0).astype(np.int32)
        return (t.view(np.int32) + step).view(np.float32)

    for _ in range(20000):
        t_a = near(base)
        t_b = near(t_a)
        (g_a, d_a), (g_b, d_b) = _pair_g_d2(q, t_a, d), _pair_g_d2(q, t_b, d)
        if g_b > g_a and d_b == d_a:
            return t_a, t_b
    raise AssertionError("no colliding target found")


def contract_inputs(d, chunk, seed=11):
    """Hand-built ablation inputs (CPU) that hold the cluster merge's hard
    cases, and where they are: 5 query tiles against 32 target tiles of 40
    rows, squared bound 1 (the planted rows and columns are returned in a
    dict beside the inputs).

    tile 0: random queries, a shuffled list of the 16 random target tiles,
      no prune; tile 1: no chunk; tile 2: random queries, all 32 tiles, the
      suffix past chunk 1 above the bound, so the prune ends the walk after
      two chunks; tile 3: queries on chunk 0's targets, the suffix past
      chunk 0 at half the bound: the one-chunk lag stages chunk 1, then the
      prune ends the walk (two chunks; without the lag, one); tile 4: the
      planted rows against 16 far tiles, each row's targets placed in them:
      row 0 two targets in chunk 0's first and last column (different
      slices at every cluster size) whose g differ but round to one d2, row
      1 one target twice, in chunk 0's columns 1 and C - 2 (an exact tie
      across slices), row 2 one target in chunk 0 and chunk 1 (a tie
      between chunks), row 3 a colliding pair (larger g, same d2) split
      over chunk 0 and chunk 1; every other row far from all targets."""
    rng = np.random.default_rng(seed)
    n = C_TILES * C_TILE_T
    pts = np.zeros((n, d), np.float32)
    pts[:16 * C_TILE_T] = rng.uniform(-1.5, 1.5, (16 * C_TILE_T, d))
    pts[16 * C_TILE_T:, :] = 30.0 + rng.uniform(0, 5, (16 * C_TILE_T, d))
    q = rng.uniform(-1, 1, (C_NQT * 256, d)).astype(np.float32)
    max_v = C_TILES
    vlist = np.zeros((C_NQT, max_v), np.int32)
    suffix = np.zeros((C_NQT, max_v), np.float32)
    counts = np.zeros(C_NQT, np.int32)
    vlist[0, :16] = rng.permutation(16)
    counts[0] = 16 // chunk
    vlist[1] = rng.permutation(C_TILES)
    vlist[2] = rng.permutation(C_TILES)
    counts[2] = C_TILES // chunk
    suffix[2, 2 * chunk:] = 4 * C_BOUND
    vlist[3] = rng.permutation(C_TILES)
    counts[3] = C_TILES // chunk
    suffix[3, chunk:] = 0.5 * C_BOUND
    near = np.concatenate([np.arange(C_TILE_T) + t * C_TILE_T for t in vlist[3, :chunk]])
    q[3 * 256:4 * 256] = pts[rng.choice(near, 256)] + rng.normal(0, 0.01, (256, d))
    # tile 4: the planted rows against the far tiles 16..31
    plist = 16 + rng.permutation(16)
    vlist[4, :16] = plist
    counts[4] = 16 // chunk
    cols = chunk * C_TILE_T

    def at(col, k=0):
        """The target row of chunk k's column col in tile 4's list."""
        return plist[k * chunk + col // C_TILE_T] * C_TILE_T + col % C_TILE_T

    r4 = 4 * 256
    q[r4:r4 + 256] = C_FAR
    e = np.zeros(d, np.float32)
    v3 = lambda x, y, z: np.concatenate([[x, y, z], e[3:]]).astype(np.float32)  # noqa: E731
    # rows 0 and 3: q and t orthogonal, so g = -0.5 |t|^2 keeps the fine steps
    # of a small number while d2 = qn2 - 2g rounds in [0.5, 1)
    q[r4] = v3(0.7746, 0.0, 0.0)
    pts[at(0)], pts[at(cols - 1)] = _collision(q[r4], v3(0.0, -0.25, 0.1), d, rng)
    q[r4 + 1] = v3(5.0, 0.0, 0.0)            # row 1: an exact tie across slices
    pts[at(1)] = pts[at(cols - 2)] = v3(5.3, 0.0, 0.0)
    q[r4 + 2] = v3(0.0, 5.0, 0.0)            # row 2: a tie between chunks
    pts[at(2)] = pts[at(2, 1)] = v3(0.0, 5.2, 0.0)
    q[r4 + 3] = v3(0.0, 0.7746, 0.0)         # row 3: a colliding pair over two chunks
    pts[at(3)], pts[at(3, 1)] = _collision(q[r4 + 3], v3(-0.3, 0.0, 0.1), d, rng)
    pages = np.zeros((C_TILES, 8, C_TILE_T), np.float32)
    pages[:, :d, :] = pts.reshape(C_TILES, C_TILE_T, d).transpose(0, 2, 1)
    pages[:, 7, :] = _half_norm(pts).reshape(C_TILES, C_TILE_T)
    qp = np.zeros((len(q), 8), np.float32)
    qp[:, :d] = q
    qn2 = tknn.norm2(torch.from_numpy(qp))
    qp[:, 7] = -1.0
    inp = tab.AblateInputs(
        q_aug=torch.from_numpy(qp), qn2=qn2, pages=torch.from_numpy(pages),
        vlist=torch.from_numpy(vlist), suffix=torch.from_numpy(suffix),
        counts=torch.from_numpy(counts), bound=C_BOUND, tile_t=C_TILE_T, chunk=chunk, d=d)
    planted = dict(collision=(r4, at(0), at(cols - 1), 0, cols - 1),
                   tie=(r4 + 1, at(1), at(cols - 2), 1, cols - 2),
                   chunk_tie=(r4 + 2, at(2), at(2, 1)),
                   chunk_collision=(r4 + 3, at(3), at(3, 1)))
    return inp, planted


def _slice_values(mode, inp, qf, qn2, t):
    """Per (tile, row, column) of a chunk the value its winner is chosen by:
    g (expansion modes) or d2 (direct), rounded as the plain search."""
    if mode == "direct":
        v = None
        for r in range(qf.shape[-1]):
            diff = t[:, None, r, :] - qf[:, :, r, None]
            v = diff * diff if v is None else v + diff * diff
        return v
    if mode == "default":
        return tab._dot(tab._tf32(qf), tab._tf32(t))
    if mode == "high":
        q_hi, t_hi = tab._tf32(qf), tab._tf32(t)
        q_lo, t_lo = tab._tf32(qf - q_hi), tab._tf32(t - t_hi)
        return (tab._dot(q_lo, t_hi) + tab._dot(q_hi, t_lo)) + tab._dot(q_hi, t_hi)
    return tab._dot(qf, t)


def _emulate(inp, mode, cluster, rule="kernel"):
    """The cluster kernel's walk on the CPU: each chunk cut into
    ``cluster`` slices (knn_ablate.cluster_slices), each slice's first
    best column, and the slices merged as the kernel merges them (``rule``
    "kernel": on g, then the column, or on d2 for direct; noprune once, at
    the end, on (d2, chunk, -g, column)); ``rule`` "d2": every slice's d2,
    then the column (the merge the kernel must not use). The prune as the
    plain version's. Returns (d2, idx, chunks run)."""
    nqt = inp.counts.shape[0]
    tile_t, chunk, d = inp.tile_t, inp.chunk, inp.d
    rows = list(range(d)) if mode == "direct" else list(range(d)) + [7]
    qf = inp.q_aug.reshape(nqt, 256, 8)[:, :, rows]
    qn2 = inp.qn2.reshape(nqt, 256)
    slices = [(lo, hi) for lo, hi in tab.cluster_slices(chunk * tile_t, cluster) if hi > lo]
    larger = mode != "direct"
    best = torch.full((nqt, 256), inp.bound)
    idx = torch.full((nqt, 256), -1, dtype=torch.int32)
    counts = inp.counts.long()
    active = counts > 0
    n_run = torch.zeros(nqt, dtype=torch.int64)
    # noprune: each slice's best chunk per row, (d2, chunk, g, column)
    keep = [[torch.full((nqt, 256), inp.bound), torch.full((nqt, 256), 1 << 30),
             torch.zeros(nqt, 256), torch.zeros((nqt, 256), dtype=torch.int64)]
            for _ in slices]
    d2_of = (lambda v: v) if mode == "direct" else (lambda v: qn2 - v * 2.0)
    max_v = inp.vlist.shape[1]
    for k in range(int(counts.max()) if nqt else 0):
        if not bool(active.any()):
            break
        n_run += active
        nxt = active & (k + 1 < counts)
        if mode not in ("noprune", "dmaonly"):
            nxt &= inp.suffix[:, min((k + 1) * chunk, max_v - 1)] <= best.amax(1)
        if mode != "dmaonly":
            tiles = inp.vlist[:, k * chunk:(k + 1) * chunk].long()
            t = inp.pages[tiles][:, :, rows, :].permute(0, 2, 1, 3).reshape(
                nqt, len(rows), chunk * tile_t)
            v = _slice_values(mode, inp, qf, qn2, t)
            parts = []
            for lo, hi in slices:
                sv, sp = (torch.max if larger else torch.min)(v[..., lo:hi], dim=-1)
                parts.append((sv, sp + lo))
            if mode == "noprune":
                for (sv, sp), kp in zip(parts, keep):
                    sd = d2_of(sv)
                    new = (sd < kp[0]) & active[:, None]
                    kp[0] = torch.where(new, sd, kp[0])
                    kp[1] = torch.where(new, k, kp[1])
                    kp[2] = torch.where(new, sv, kp[2])
                    kp[3] = torch.where(new, sp, kp[3])
            else:
                cv, cp = parts[0]
                for sv, sp in parts[1:]:
                    if rule == "d2":
                        a, b = d2_of(sv), d2_of(cv)
                        win = (a < b) | ((a == b) & (sp < cp))
                    else:
                        better = sv > cv if larger else sv < cv
                        win = better | ((sv == cv) & (sp < cp))
                    cv, cp = torch.where(win, sv, cv), torch.where(win, sp, cp)
                lmin = d2_of(cv)
                better = (lmin < best) & active[:, None]
                best = torch.where(better, lmin, best)
                if mode != "maxonly":
                    tid = torch.gather(tiles, 1, cp // tile_t)
                    idx = torch.where(better, (tid * tile_t + cp % tile_t).to(torch.int32), idx)
        active = nxt
    if mode == "noprune":
        bd, bk, bg, bp = keep[0]
        for sd, sk, sg, sp in keep[1:]:
            win = (sd < bd) | ((sd == bd) & ((sk < bk) | ((sk == bk) & (
                (sg > bg) | ((sg == bg) & (sp < bp))))))
            bd, bk = torch.where(win, sd, bd), torch.where(win, sk, bk)
            bg, bp = torch.where(win, sg, bg), torch.where(win, sp, bp)
        found = bk < (1 << 30)
        pos = bk.clamp(max=max_v // chunk - 1) * chunk + bp // tile_t
        tid = torch.gather(inp.vlist.long(), 1, pos)
        best = torch.where(found, bd, best)
        idx = torch.where(found, (tid * tile_t + bp % tile_t).to(torch.int32), idx)
    return best.reshape(-1), idx.reshape(-1), n_run


@pytest.fixture(scope="module")
def contract_cases():
    return {(d, chunk): contract_inputs(d, chunk) for d in (3, 6) for chunk in (2, 8)}


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("mode", tab.MODES)
def test_cluster_merge_rule_matches_plain(contract_cases, mode, cluster):
    """The kernel's merge of a chunk's slices across a cluster, emulated on
    the CPU, equals the plain search bit for bit in every mode at every
    cluster size, D = 3 and 6, chunks of 2 and 8 tiles, on the planted
    inputs (so also the chunks each query tile scores)."""
    for (d, chunk), (inp, _) in contract_cases.items():
        want = tab._ablate_plain(inp, mode)
        got = _emulate(inp, mode, cluster)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (mode, cluster, d, chunk)


@pytest.mark.parametrize("cluster", [2, 8, 16])
def test_a_merge_on_d2_takes_the_wrong_winner(contract_cases, cluster):
    """Merging slices on (d2, column) instead of (g, column) picks row 0's
    earlier target, whose g is smaller but rounds to the same d2: the
    planted collision is what the kernel's rule is there for."""
    for (d, chunk), (inp, planted) in contract_cases.items():
        row, t_a, t_b, _, _ = planted["collision"]
        d2, idx, _ = _emulate(inp, "full", cluster, rule="d2")
        assert int(idx[row]) == t_a
        assert int(tab._ablate_plain(inp, "full")[1][row]) == t_b


@pytest.mark.parametrize("chunk", [2, 8])
@pytest.mark.parametrize("d", [3, 6])
def test_contract_inputs_hold_the_planted_cases(contract_cases, d, chunk):
    """The card contract test's inputs hold what they are built for: g
    that differ but round to one d2 in two slices (at 2, 8 and 16 CTAs a
    cluster) and in two chunks, an exact tie across slices, a tie between
    chunks, a query tile with no chunk, walks the prune ends early (one of
    them only through the one-chunk lag), and slices whose width is not a
    multiple of 8."""
    inp, planted = contract_cases[(d, chunk)]
    d2, idx, n_run = tab._ablate_plain(inp, "full")
    cols = chunk * C_TILE_T
    pages = inp.pages.numpy()

    def g_d2(row, target):
        t = pages[target // C_TILE_T, :d, target % C_TILE_T]
        return _pair_g_d2(inp.q_aug[row, :d].numpy(), t, d)

    def apart(c_a, c_b):
        """Chunk columns c_a and c_b lie in different slices at 2, 8 and
        16 CTAs a cluster."""
        return all([lo <= c_a < hi for lo, hi in sl] != [lo <= c_b < hi for lo, hi in sl]
                   for sl in (tab.cluster_slices(cols, s) for s in (2, 8, 16)))

    row, t_a, t_b, c_a, c_b = planted["collision"]
    (g_a, d_a), (g_b, d_b) = g_d2(row, t_a), g_d2(row, t_b)
    assert g_b > g_a and d_a == d_b and int(idx[row]) == t_b and apart(c_a, c_b)
    row, t_1, t_2, c_1, c_2 = planted["tie"]
    assert t_1 != t_2 and g_d2(row, t_1) == g_d2(row, t_2) and int(idx[row]) == t_1
    assert apart(c_1, c_2)
    row, t_1, t_2 = planted["chunk_tie"]
    assert t_1 != t_2 and g_d2(row, t_1) == g_d2(row, t_2) and int(idx[row]) == t_1
    row, t_e, t_f = planted["chunk_collision"]
    (g_e, d_e), (g_f, d_f) = g_d2(row, t_e), g_d2(row, t_f)
    assert g_f > g_e and d_e == d_f and int(idx[row]) == t_e
    for r in range(4):
        assert float(d2[4 * 256 + r]) < inp.bound
    assert bool((idx[4 * 256 + 4:5 * 256] == -1).all())
    counts = inp.counts.long()
    assert int(counts[1]) == 0 and int(n_run[1]) == 0
    assert int(n_run[2]) == 2 < int(counts[2])
    assert int(n_run[3]) == 2 < int(counts[3])
    # without the lag (the best after chunk k deciding chunk k + 1) tile 3
    # would stop after one chunk: every row found a target below half the bound
    assert float(d2[3 * 256:4 * 256].max()) < float(inp.suffix[3, chunk])
    assert (n_run <= tab._ablate_plain(inp, "noprune")[2]).all()
    widths = {hi - lo for c in (2 * C_TILE_T, 8 * C_TILE_T) for s in (8, 16)
              for lo, hi in tab.cluster_slices(c, s) if hi > lo}
    assert any(w % 8 for w in widths) and all(w % 4 == 0 for w in widths)


def test_cluster_slices_cover_every_column_once():
    """cluster_slices cuts a chunk into contiguous slices of a width that is
    a multiple of 4 (the kernel stages each with 16-byte copies), at most
    one a CTA, the last ones short or empty; the production cluster size is
    the kernel source's."""
    for cols in (8, 80, 320, 1024, 4096, 4104):
        for s in (1, 2, 8, 12, 16):
            sl = tab.cluster_slices(cols, s)
            assert len(sl) == s and sl[0][0] == 0 and sl[-1][1] == cols
            assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
            assert all(lo % 4 == 0 and hi >= lo for lo, hi in sl)
            assert max(hi - lo for lo, hi in sl) == -(-(-(-cols // s)) // 4) * 4
    src = (_cuda_csrc() / "visited_ablate.cu").read_text()
    assert f"#define ABL_CLUSTER {tab.CLUSTER} " in src
    assert tab._smem_bytes("full", 4, 4096, 768) <= tab.SMEM_LIMIT
    assert [tab.issue_instructions(m, 3) for m in tab.MODES] == [8, 8, 8, 0, 3, 3, 9]


def _cuda_csrc():
    from icp_variants_tpu_torch.ops import _cuda
    return _cuda.CSRC


def test_ablation_measurement_builds_are_kept_apart():
    """The counting build of the kernel gets a library path of its own (it
    does not replace the production build), the source keeps its reader
    behind its define, and chip_smoke builds it beside the production
    libraries."""
    import chip_smoke
    from icp_variants_tpu_torch.ops import _cuda

    src = _cuda.CSRC / "visited_ablate.cu"
    assert _cuda._lib_path(src, tab.COUNT_DEFINES) != _cuda._lib_path(src, ())
    text = src.read_text()
    guarded = text[text.rindex("#ifdef ABL_COUNT"):]
    assert 'extern "C" int visited_ablate_counts(' in guarded[:guarded.index("#endif")]
    assert ("visited_ablate.cu", tab.COUNT_DEFINES) in chip_smoke.measurement_builds()


@pytest.mark.cuda
def test_ablation_contract_on_card(contract_cases):
    """Every mode of the cluster kernel on the planted inputs at chunk 2
    and 8, D = 3 and 6: the exact modes bit-equal to plain, the TF32 modes
    within tf32_order_bound of their plain version and tf32_error_bound of
    the exact result; the -DABL_COUNT build's chunks scored, in every CTA
    of every query tile's cluster, equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for (d, chunk), (cpu, _) in contract_cases.items():
        inp = tab.AblateInputs(*(x.cuda() if isinstance(x, torch.Tensor) else x for x in cpu))
        fd, fi = tab.ablate_search_plain(inp, "full")
        for mode in tab.MODES:
            pd, pi, runs = tab._ablate_plain(inp, mode)
            kd, ki = tab.ablate_search(inp, mode)
            torch.cuda.synchronize()
            if mode in ("default", "high"):
                worst, _ = tab.tf32_check(inp, mode, (kd, ki), (pd, pi))
                assert worst <= 1.0, (mode, d, chunk, worst)
                e = torch.maximum(tab.tf32_error_bound(inp, mode, ki),
                                  tab.tf32_error_bound(inp, mode, fi))
                assert bool(((kd - fd).abs() <= e).all()), (mode, d, chunk)
            else:
                assert torch.equal(kd, pd) and torch.equal(ki, pi), (mode, d, chunk)
            cd, ci, chunks = tab.ablate_counted(inp, mode)
            assert torch.equal(cd, kd) and torch.equal(ci, ki), (mode, d, chunk)
            assert bool((chunks == runs.cpu()[:, None]).all()), (mode, d, chunk)
