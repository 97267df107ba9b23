"""The visited-list ablation (TPU kernel ``scripts/knn_ablate.py``
``make_kernel``, ported as ``csrc/visited_ablate.cu``) held against the JAX
script's kernel in Pallas interpret mode on the CPU.

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
