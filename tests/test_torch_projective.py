"""The port's projective matcher and the projective RGB-D tracker against
the JAX package on the CPU: the pixel projection, the window search's plain
version against JAX ``projective_match`` and ``projective_match_resident``
(Pallas interpret mode) on every case of ``tests/test_projective.py``, on
batched pairs, at the image edges and far off the image, on a tie that pins
the (block, slot) order, and against an independent float64 window scan;
then both arms of the tracker (linear point-to-plane, and the room run's LM
point-to-point) against JAX ``run_icp_batch`` on small synthetic frames,
and one projective multires run through the segmented driver.

Tolerances: the projected pixels are equal; both packages compute them in
the same order of f32 operations (a product, a quotient, a sum: XLA has no
multiply-add to fuse there) and round half to even. A projection within an
ulp of a half pixel could still round differently if a compiler reordered
it; the self-check at half pixels below shows that it does not. Window-scan
distances are compared to 2 ulp, as XLA:CPU may fuse the sum of squares
(see tests/test_torch_kdtree.py), and indices may differ only where both
pixels lie at the same distance within that rounding. The tracker: equal
per-iteration match counts; poses within 1e-4 on the linear arm and within
1e-4 on the LM arm too (both solve in f32 in another summation order; the
LM arm's ten inner steps freeze at the same cost decrease)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_variants_tpu.data import rgbd as jrgbd
from icp_variants_tpu.ops import projective as jproj
from icp_variants_tpu.pipeline import config as jconfig
from icp_variants_tpu.pipeline import icp as jicp
from icp_variants_tpu_torch import convert
from icp_variants_tpu_torch.data import rgbd as trgbd
from icp_variants_tpu_torch.ops import projective as tproj
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp

torch.set_num_threads(2)


def _n(x):
    return np.asarray(x)


def make_image_cloud(h=24, w=32, fx=40.0, fy=40.0):
    """``tests/test_projective.py``'s image-shaped target: a gently waved
    plane at 2 m seen through a pinhole camera."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 2.0 + 0.01 * np.sin(uu * 0.5) * np.cos(vv * 0.3)
    pts = np.stack(
        [(uu - cx) / fx * depth, (vv - cy) / fy * depth, depth], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    valid = np.ones(h * w, bool)
    return pts, valid, dict(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)


def _both(q, pts, valid, cam, **kw):
    """(port, JAX) ``projective_match`` outputs as numpy."""
    mask = kw.pop("query_mask", None)
    t = tproj.projective_match(torch.from_numpy(q), torch.from_numpy(pts),
                               torch.from_numpy(valid), **cam, **kw,
                               query_mask=None if mask is None else torch.from_numpy(mask))
    j = jproj.projective_match(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(valid),
                               **cam, **kw, query_mask=None if mask is None else jnp.asarray(mask))
    return [x.numpy() for x in t], [_n(x) for x in j]


def _assert_same(t, j, q, pts, rows=None):
    """Valid sets equal; on ``rows`` (default: every row) the found sets
    equal, d2 to 2 ulp (the miss distance exactly) and indices equal but at
    ties."""
    (ti, td, tv), (ji, jd, jv) = t, j
    np.testing.assert_array_equal(tv, jv)
    if rows is not None:
        ti, td, ji, jd = ti[rows], td[rows], ji[rows], jd[rows]
    found = ti >= 0
    np.testing.assert_array_equal(found, ji >= 0)
    np.testing.assert_array_max_ulp(td[found], jd[found], maxulp=2)
    np.testing.assert_array_equal(td[~found], jd[~found])
    diff = np.flatnonzero(ti != ji)
    assert len(diff) <= max(2, len(ti) // 100), len(diff)
    if len(diff):
        qa = q[diff].astype(np.float64)
        np.testing.assert_allclose(((qa - pts[ti[diff]]) ** 2).sum(1),
                                   ((qa - pts[ji[diff]]) ** 2).sum(1),
                                   rtol=4 * np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# The projection
# ---------------------------------------------------------------------------


@jax.jit
def _jax_projection(q):
    """``projective.py:111-119`` of the JAX package at the test camera."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    safe_z = jnp.where(z == 0, 1.0, z)
    u0 = jnp.round(jnp.clip(x * 40.0 / safe_z + 15.5, -1.0e6, 1.0e6)).astype(jnp.int32)
    v0 = jnp.round(jnp.clip(y * 40.0 / safe_z + 11.5, -1.0e6, 1.0e6)).astype(jnp.int32)
    return jnp.stack([u0, v0], -1)


def test_project_pixels_matches_jax():
    """Random points, points on half pixels, z = 0 and far projections."""
    rng = np.random.default_rng(0)
    q = np.concatenate([
        rng.uniform(-1.5, 1.5, (2000, 3)) + [0, 0, 2.0],
        np.column_stack([rng.integers(-30, 30, (500, 2)) * 0.025, np.full(500, 2.0)]),
        [[0.0, 0.0, 0.0], [1.0, -1.0, 0.0], [5e3, -5e3, 1e-3], [-1e9, 1e9, 1.0]],
    ]).astype(np.float32)
    got = tproj.project_pixels(torch.from_numpy(q), 40.0, 40.0, 15.5, 11.5).numpy()
    assert got.dtype == np.int32 and got.shape == (len(q), 2)
    np.testing.assert_array_equal(got, _n(_jax_projection(jnp.asarray(q))))
    # Half pixels round to even: x = 0 projects to u = 15.5 -> 16.
    assert tuple(got[2500]) == (16, 12)
    assert tuple(got[-1]) == (-1_000_000, 1_000_000)
    # JAX's own matcher at window 0 reads the projected pixel back.
    pts, valid, cam = make_image_cloud()
    inside = ((got[:, 0] >= 0) & (got[:, 0] < cam["width"])
              & (got[:, 1] >= 0) & (got[:, 1] < cam["height"]))
    ji, _, _ = jproj.projective_match(jnp.asarray(q[inside]), jnp.asarray(pts),
                                      jnp.asarray(valid), **cam, window=0, max_distance=1e9)
    np.testing.assert_array_equal(_n(ji), got[inside, 1] * cam["width"] + got[inside, 0])


# ---------------------------------------------------------------------------
# The window search: tests/test_projective.py's cases, port against JAX
# ---------------------------------------------------------------------------


def test_self_match():
    pts, valid, cam = make_image_cloud()
    t, j = _both(pts, pts, valid, cam, max_distance=0.01)
    _assert_same(t, j, pts, pts)
    ti, td, tv = t
    assert tv.all()
    np.testing.assert_array_equal(ti, np.arange(len(pts)))
    np.testing.assert_allclose(td, 0.0, atol=1e-10)


def test_window_limits():
    pts, valid, cam = make_image_cloud()
    far = np.asarray([[100.0, 100.0, 2.0]], np.float32)
    t, j = _both(far, pts, valid, cam, max_distance=0.01)
    _assert_same(t, j, far, pts)
    assert not t[2][0] and t[0][0] == -1 and t[1][0] == np.float32(tproj.BIG)


def test_invalid_targets_skipped():
    pts, valid, cam = make_image_cloud()
    valid2 = valid.copy()
    q_index = 13 * cam["width"] + 17
    valid2[q_index] = False
    q = pts[q_index:q_index + 1]
    t, j = _both(q, pts, valid2, cam, max_distance=0.01)
    _assert_same(t, j, q, pts)
    assert t[2][0] and t[0][0] != q_index


def test_threshold_squared():
    pts, valid, cam = make_image_cloud()
    q = pts[:1] + np.array([0.0, 0.0, 0.05], np.float32)
    for maxd, want in ((0.002, False), (0.003, True)):
        t, j = _both(q, pts, valid, cam, max_distance=maxd)
        _assert_same(t, j, q, pts)
        assert bool(t[2][0]) == want


def test_query_mask():
    pts, valid, cam = make_image_cloud()
    mask = np.zeros(len(pts), bool)
    mask[::3] = True
    t, j = _both(pts, pts, valid, cam, max_distance=0.01, query_mask=mask)
    _assert_same(t, j, pts, pts)
    np.testing.assert_array_equal(t[2], mask)


def _resident_case(seed=5, n=700):
    """``TestResidentProjective``'s 96 x 64 image, 10% invalid pixels, and
    noisy queries near it, 10% of them masked."""
    W, H = 96, 64
    fx = fy = 80.0
    cx, cy = (W - 1) / 2, (H - 1) / 2
    rng = np.random.default_rng(seed)
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = 2.0 + 0.1 * np.sin(uu / 7.0) * np.cos(vv / 5.0)
    tgt = np.stack([(uu - cx) / fx * z, (vv - cy) / fy * z, z], -1).reshape(-1, 3).astype(np.float32)
    tvalid = rng.random(W * H) > 0.1
    q = (tgt[rng.integers(0, W * H, n)] + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    qmask = rng.random(n) > 0.1
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=W, height=H)
    return q, tgt, tvalid, qmask, cam


def test_plain_matches_xla_and_resident():
    """The plain version against JAX's window scan and its resident kernel
    in interpret mode, on every row."""
    q, tgt, tvalid, qmask, cam = _resident_case()
    kw = dict(window=12, max_distance=0.1)
    t, j = _both(q, tgt, tvalid, cam, query_mask=qmask, **kw)
    _assert_same(t, j, q, tgt)
    r = [_n(x) for x in jproj.projective_match_resident(
        jnp.asarray(q), jnp.asarray(tgt), jnp.asarray(tvalid), query_mask=jnp.asarray(qmask),
        interpret=True, **cam, **kw)]
    # The resident kernel searches live rows below the threshold only: its
    # misses read the miss bound, so rows are compared where it matched.
    _assert_same(t, r, q, tgt, rows=r[2])
    assert t[2].mean() > 0.5


def test_batched_pairs_match_jax():
    """Three pairs with their own targets, masks and chunking, in one call,
    against JAX pair by pair; an unbatched call equals its row."""
    cases = [_resident_case(seed=s, n=300) for s in (1, 2, 3)]
    cam = cases[0][4]
    q, tgt, tvalid, qmask = (np.stack([c[i] for c in cases]) for i in range(4))
    ti, td, tv = (x.numpy() for x in tproj.projective_match(
        *(torch.from_numpy(x) for x in (q, tgt, tvalid)), **cam, max_distance=0.1,
        query_mask=torch.from_numpy(qmask), chunk=128))
    assert ti.shape == (3, 300)
    for b in range(3):
        j = [_n(x) for x in jproj.projective_match(
            jnp.asarray(q[b]), jnp.asarray(tgt[b]), jnp.asarray(tvalid[b]), **cam,
            max_distance=0.1, query_mask=jnp.asarray(qmask[b]))]
        _assert_same((ti[b], td[b], tv[b]), j, q[b], tgt[b])
    one = tproj.projective_match(*(torch.from_numpy(x[1]) for x in (q, tgt, tvalid)), **cam,
                                 max_distance=0.1, query_mask=torch.from_numpy(qmask[1]))
    for a, want in zip(one, (ti[1], td[1], tv[1])):
        np.testing.assert_array_equal(a.numpy(), want)


def _window_scan_f64(q, pix, tgt, tvalid, width, height, window):
    """Independent reference: per query, the float64 squared distance of
    every valid in-image pixel within +-window of its pixel; returns the
    minimum (inf if none) and the set of pixels within 1e-6 relative."""
    out = []
    for qi, (u0, v0) in zip(q.astype(np.float64), pix):
        us = np.arange(max(u0 - window, 0), min(u0 + window, width - 1) + 1)
        vs = np.arange(max(v0 - window, 0), min(v0 + window, height - 1) + 1)
        lin = (vs[:, None] * width + us[None, :]).reshape(-1)
        lin = lin[tvalid[lin]]
        if not len(lin):
            out.append((np.inf, set()))
            continue
        d2 = ((tgt[lin].astype(np.float64) - qi) ** 2).sum(1)
        m = d2.min()
        out.append((m, set(lin[d2 <= m * (1 + 1e-6)].tolist())))
    return out


def test_edges_and_off_image_candidates():
    """Queries whose windows cross each image edge, and projections far off
    the image (+-1e6 after the clip): the plain version sees exactly the
    window's in-image valid pixels, like JAX and a float64 window scan."""
    _, tgt, tvalid, _, cam = _resident_case(seed=7)
    W, H = cam["width"], cam["height"]
    z = 2.0
    pix = []
    for u in (-13, -12, -5, 0, 3, 11, 12, 13, W - 14, W - 13, W - 1, W + 4, W + 11, W + 12, W + 13):
        for v in (-13, -12, -1, 0, 12, 13, H // 2, H - 13, H - 1, H + 11, H + 12, H + 13):
            pix.append((u, v))
    pix = np.asarray(pix, np.float64)
    rng = np.random.default_rng(8)
    off = rng.normal(0, 0.3, (len(pix), 2))            # sub-pixel offsets
    x = (pix[:, 0] + off[:, 0] * 0.9 - cam["cx"]) / cam["fx"] * z
    y = (pix[:, 1] + off[:, 1] * 0.9 - cam["cy"]) / cam["fy"] * z
    q = np.column_stack([x, y, np.full(len(x), z) + rng.normal(0, 0.05, len(x))])
    far = [[1e4, 0.0, 1e-3], [-1e4, 0.0, 1e-3], [0.0, 1e4, 1e-3], [0.0, -1e4, 1e-3],
           [1e5, 1e5, 0.0], [1e6, -1e6, 1.0]]
    q = np.concatenate([q, far]).astype(np.float32)
    t, j = _both(q, tgt, tvalid, cam, max_distance=1e9)
    _assert_same(t, j, q, tgt)
    tpix = tproj.project_pixels(torch.from_numpy(q), cam["fx"], cam["fy"], cam["cx"],
                                cam["cy"]).numpy()
    assert (np.abs(tpix[-6:]) == 1_000_000).any(axis=1).all()
    ref = _window_scan_f64(q, tpix, tgt, tvalid, W, H, 12)
    ti, td, _ = t
    for i, (m, best) in enumerate(ref):
        if np.isinf(m):
            assert ti[i] == -1 and td[i] == np.float32(tproj.BIG), i
        else:
            assert ti[i] in best, i
            np.testing.assert_allclose(td[i], m, rtol=1e-6)
    assert np.isinf([m for m, _ in ref]).sum() >= 6 and (ti >= 0).sum() > len(q) // 2


def test_tie_goes_to_block_order():
    """Two pixels holding the same point: P1 = (u 3, v 10) in block (0, 0)
    and P2 = (u 20, v 2) in block (0, 1). Raster order would take P2 first;
    the (block, slot) order takes P1, in the port and in JAX alike."""
    W, H = 48, 40
    cam = dict(fx=40.0, fy=40.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0, width=W, height=H)
    tgt = np.full((W * H, 3), 7.0, np.float32)
    tvalid = np.zeros(W * H, bool)
    p1, p2 = 10 * W + 3, 2 * W + 20
    tgt[p1] = tgt[p2] = (0.1, 0.2, 2.0)
    tvalid[p1] = tvalid[p2] = True
    # The query projects to (12, 6): both pixels lie in its window.
    q = np.asarray([[(12 - cam["cx"]) / 20.0, (6 - cam["cy"]) / 20.0, 2.0]], np.float32)
    assert tuple(tproj.project_pixels(torch.from_numpy(q), 40.0, 40.0, cam["cx"],
                                      cam["cy"])[0].tolist()) == (12, 6)
    t, j = _both(q, tgt, tvalid, cam, max_distance=100.0)
    assert t[0][0] == p1 and j[0][0] == p1
    assert t[1][0] == j[1][0]


# ---------------------------------------------------------------------------
# The window search's order: the kernel's rank key against the plain
# version's first argmin, and the kernel's contract on the card
# ---------------------------------------------------------------------------


def _rank(u, v, width, block):
    """Position of pixel (u, v) in the plain version's first-argmin order:
    block row, block column, then row and column inside the block
    (``csrc/projective_window_search.cu``'s ``proj_rank``)."""
    wb = -(-width // block)
    return ((v // block) * wb + u // block) * block * block + (v % block) * block + u % block


def _window_contract_inputs(seed, w=100, h=70):
    """An integer-valued image (every distance exact in f32, ties
    everywhere) with about 20% invalid pixels and a 30 x 30 all-invalid
    patch; queries with integer coordinates at every pixel from 14 before
    to 14 past each edge in raster order (every offset mod 16 in both axes,
    windows cut by the border or wholly outside it), then 1,024 at random
    pixels (neighbours far apart) and 4 clipped to +-1e6. Returns numpy
    (q, pix, img, ok)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 3, (h * w, 3)).astype(np.float32)
    ok = rng.random(h * w) > 0.2
    ok.reshape(h, w)[:30, 40:70] = False
    uu, vv = np.meshgrid(np.arange(-14, w + 14), np.arange(-14, h + 14))
    scattered = np.column_stack([rng.integers(-14, w + 14, 1024), rng.integers(-14, h + 14, 1024)])
    far = np.array([[1_000_000, 5], [-1_000_000, -1_000_000], [7, 1_000_000], [-1_000_000, 20]])
    pix = np.concatenate([np.column_stack([uu.ravel(), vv.ravel()]), scattered, far])
    q = rng.integers(0, 3, (len(pix), 3)).astype(np.float32)
    return q, pix.astype(np.int32), img, ok


def _window_reference(q, pix, img, ok, w, h, window, block):
    """numpy: per query the least d2 over the valid in-image pixels of its
    window and, among the pixels at it, the least ``_rank`` (idx, d2), or
    (-1, BIG); and whether the raster-first pixel at that d2 is another."""
    d = np.arange(-window, window + 1)
    u = pix[:, 0, None, None] + d[None, None, :]
    v = pix[:, 1, None, None] + d[None, :, None]
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    lin = np.where(inside, v * w + u, 0)
    diff = img[lin] - q[:, None, None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    d2 = np.where(inside & ok[lin], d2, np.inf).reshape(len(q), -1)
    best = d2.min(1)
    at = d2 == best[:, None]
    rank = np.where(at, _rank(u, v, w, block).reshape(len(q), -1), np.iinfo(np.int64).max)
    idx = np.take_along_axis(lin.reshape(len(q), -1), rank.argmin(1)[:, None], 1)[:, 0]
    raster = np.take_along_axis(lin.reshape(len(q), -1), at.argmax(1)[:, None], 1)[:, 0]
    found = np.isfinite(best)
    return (np.where(found, idx, -1).astype(np.int32),
            np.where(found, best, np.float32(tproj.BIG)).astype(np.float32),
            found & (raster != idx))


@pytest.mark.parametrize("window,block", [(12, 16), (20, 16), (12, 5), (3, 4)])
def test_window_rank_is_the_plain_order(window, block):
    """The plain window search takes, among the window's pixels at the
    least d2, the least ``_rank``: the key the kernel reduces with. The
    inputs hold rows whose raster-first pixel at that d2 is another one,
    rows with no valid pixel, and clipped projections. ``_rank`` grows with
    v inside a column, which the kernel's per-column scan relies on."""
    w, h = 100, 70
    q, pix, img, ok = _window_contract_inputs(seed=20 + window + block, w=w, h=h)
    ti, td = (x[0].numpy() for x in tproj.projective_match_plain(
        *(torch.from_numpy(a)[None] for a in (q, pix, img, ok)), width=w, height=h,
        window=window, block=block))
    ri, rd, other = _window_reference(q, pix, img, ok, w, h, window, block)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(td, rd)
    assert other.sum() > 0 and (ri < 0).sum() > 0 and (ri >= 0).sum() > len(q) // 4
    u, v = np.meshgrid(np.arange(w), np.arange(h - 1))
    assert (_rank(u, v + 1, w, block) > _rank(u, v, w, block)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("window,block", [(12, 16), (20, 16), (12, 5)])
def test_window_search_contract_on_card(window, block):
    """The warp-per-query window search equals its plain version bit for
    bit: windows crossing block edges and image edges at every offset mod
    16 (the rolled loops with runtime bounds), windows wider than 32
    columns (window 20: two column chunks a lane), off-image and clipped
    windows, invalid pixels and an all-invalid patch, scattered windows,
    and rows whose block-order winner differs from the raster-order one
    (asserted present); then the same queries on a float-valued image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, h = 100, 70
    q, pix, img, ok = _window_contract_inputs(seed=20 + window + block, w=w, h=h)
    _, _, other = _window_reference(q, pix, img, ok, w, h, window, block)
    assert other.sum() > 0
    rng = np.random.default_rng(window)
    dev = torch.device("cuda")
    for image in (img, img + rng.normal(0, 0.3, img.shape).astype(np.float32)):
        args = [torch.from_numpy(a)[None].to(dev) for a in (q, pix, image, ok)]
        kw = dict(width=w, height=h, window=window, block=block)
        got = tproj.projective_window_search(*args, **kw)
        want = tproj.projective_match_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool((got[0] < 0).any()) and bool((got[0] >= 0).any())


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tproj.projective_window_search(
            q, torch.zeros((1, 4, 2), dtype=torch.int32, device="meta"),
            torch.zeros((1, 48, 3), device="meta"), torch.zeros((1, 48), dtype=torch.bool,
                                                                 device="meta"),
            width=8, height=6)


# ---------------------------------------------------------------------------
# The tracker, both arms, against JAX run_icp_batch
# ---------------------------------------------------------------------------

W_IMG, H_IMG = 64, 48
FX_IMG, FY_IMG = 525.0 * W_IMG / 640, 525.0 * H_IMG / 480
CX_IMG, CY_IMG = (W_IMG - 1) / 2.0, (H_IMG - 1) / 2.0
SHIFT = 0.005
K_IMG = np.array([[FX_IMG, 0, CX_IMG], [0, FY_IMG, CY_IMG], [0, 0, 1]], np.float32)


def wavy_frame(i):
    """``tests/test_workloads.make_wavy_tum_dataset``'s frame i, in memory:
    a wavy surface seen from a camera at x = -SHIFT * i, depth quantized as
    its 16-bit PNG stores it (1/5000 m), random colours."""
    vv, uu = np.meshgrid(np.arange(H_IMG), np.arange(W_IMG), indexing="ij")
    z = np.full((H_IMG, W_IMG), 2.0)
    for _ in range(8):
        x_world = (uu - CX_IMG) / FX_IMG * z - SHIFT * i
        y_world = (vv - CY_IMG) / FY_IMG * z
        z = 2.0 + 0.12 * np.sin(4.0 * x_world) * np.cos(4.0 * y_world)
    depth = (np.round(z * 5000) / 5000).astype(np.float32)
    rgb = np.random.default_rng(i).integers(0, 255, (H_IMG, W_IMG, 4), dtype=np.uint8)
    return depth, rgb


@pytest.fixture(scope="module")
def frames():
    """Frame 0 image-shaped as the target; frames 1-2 as sources, stride-4
    compacted in xyz-Morton order (the bench's source contract at a
    smaller stride) and full-size (the multires contract)."""
    eye = np.eye(4, dtype=np.float32)
    cap = W_IMG * H_IMG
    f = [wavy_frame(i) for i in range(3)]
    jt = jrgbd.cloud_from_depth(*f[0], K_IMG, eye, keep_original_size=True, capacity=cap)
    js = jicp.stack_clouds([
        jrgbd.cloud_from_depth(*f[i], K_IMG, eye, keep_original_size=False, downsample_factor=4,
                               capacity=cap // 4, morton_order=True) for i in (1, 2)])
    jfull = jicp.stack_clouds([
        jrgbd.cloud_from_depth(*f[i], K_IMG, eye, keep_original_size=True, capacity=cap)
        for i in (1, 2)])
    jts = jicp.stack_clouds([jt] * 2)
    return dict(js=js, jt=jts, jfull=jfull, ts=convert.cloud_from_arrays(js, "cpu"),
                tt=convert.cloud_from_arrays(jts, "cpu"),
                tfull=convert.cloud_from_arrays(jfull, "cpu"),
                tt_port=trgbd.cloud_from_depth(*f[0], K_IMG, eye, keep_original_size=True,
                                               capacity=cap, for_projective=True, device="cpu"))


def _cfgs(arm, **kw):
    """(JAX, port) configs of an arm: linear point-to-plane (the bench's),
    or point-to-point LM (the room run's)."""
    out = []
    for cfg_mod in (jconfig, tconfig):
        metric, minimizer = ((cfg_mod.Metric.POINT_TO_PLANE, cfg_mod.Minimizer.LINEAR)
                             if arm == "linear" else
                             (cfg_mod.Metric.POINT_TO_POINT, cfg_mod.Minimizer.NONLINEAR_LM))
        cfg = cfg_mod.ICPConfig(metric=metric, minimizer=minimizer,
                                matching=cfg_mod.Matching.PROJECTIVE, n_iterations=20,
                                max_distance=0.1).replace(**kw)
        out.append(cfg.with_camera(fx=FX_IMG, fy=FY_IMG, cx=CX_IMG, cy=CY_IMG,
                                   width=W_IMG, height=H_IMG))
    return out


@pytest.mark.parametrize("arm", ["linear", "lm"])
def test_tracker_matches_jax(frames, arm):
    jcfg, tcfg = _cfgs(arm, projective_chunk=256)
    jr = jicp.run_icp_batch(jcfg, frames["js"], frames["jt"], key=jax.random.PRNGKey(0))
    tr = ticp.run_icp_batch(tcfg, frames["ts"], frames["tt"], device="cpu")
    nm = tr.trace.num_matches.numpy()
    np.testing.assert_array_equal(nm, _n(jr.trace.num_matches))
    assert (nm > 0.8 * frames["ts"].valid.sum(1, keepdim=True).numpy()).all()
    np.testing.assert_allclose(tr.pose.numpy(), _n(jr.pose), atol=1e-4)
    if arm == "linear":
        # Towards the cameras' -x shifts (frames 1 and 2 sit at x = -5,
        # -10 mm; projective correspondences slide on the smooth wave, so
        # 20 iterations cover part of the way; point-to-point barely moves).
        t = tr.pose.numpy()[:, 0, 3]
        assert t[1] < t[0] < 0, t
    # The port's own image-shaped target equals the JAX package's.
    for name in ("points", "valid"):
        np.testing.assert_array_equal(getattr(frames["tt_port"], name).numpy(),
                                      getattr(frames["tt"], name)[0].numpy())


def test_multires_segmented_matches_jax(frames):
    """Full-size sources through the segmented multires driver, linear arm:
    each pyramid level's projective matching against the image target."""
    jcfg, tcfg = _cfgs("linear", multi_resolution=True, n_iterations=8)
    jr = jicp.run_icp_batch_multires_segmented(
        jcfg, frames["jfull"], frames["jt"], key=jax.random.PRNGKey(0),
        num_source_points=W_IMG * H_IMG)
    tr = ticp.run_icp_batch_multires_segmented(
        tcfg, frames["tfull"], frames["tt"], num_source_points=W_IMG * H_IMG, device="cpu")
    np.testing.assert_array_equal(tr.trace.num_matches.numpy(), _n(jr.trace.num_matches))
    np.testing.assert_allclose(tr.pose.numpy(), _n(jr.pose), atol=1e-4)
    assert tr.trace.num_matches.shape[1] == len(ticp.cloud_lib.multires_stride_schedule(
        W_IMG * H_IMG, 8, True))
    assert tr.match_blocks is None


def test_target_must_be_image_shaped(frames):
    _, tcfg = _cfgs("linear")
    with pytest.raises(ValueError, match="image-shaped"):
        ticp.run_icp_batch(tcfg, frames["ts"], frames["ts"], device="cpu")
