"""The linear solvers' normal equations (``solvers/linear.normal_equations``):
the plain version on the CPU, the CUDA entry's checks and arguments, and on
the card the kernel ``csrc/normal_equations.cu`` against a float64 sum of
the same rows and whole ``run_icp_batch`` runs against the cuBLAS products it
replaces.

The rows, the float64 sums and their tolerance are ``chip_smoke``'s
(``ne_rows``, ``ne_sums64``, ``NE_TOL``): 1e-5 of the sum of the terms'
magnitudes, each row's factors taken at their parts' magnitudes, so a
rounded difference such as ``n.d - n.s`` counts at its parts' size. That
is some 170 units of f32 rounding; a term carries about 12 roundings and
the kernel's sums are about 30 additions deep (8 rows a thread, 8 levels of
the CTA's tree, 8 of the chunks'). Where every term is zero the sums must be
zero exactly."""

import ctypes

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from icp_variants_tpu_torch.core import cloud as tcloud
from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.solvers import linear

torch.set_num_threads(2)

METRICS = ("plane", "symmetric")
# (pairs, rows a pair): the colour tracker's, the projective tracker's and
# the ETH sweep's shapes, then a ragged N, one pair, and N under one chunk.
CARD_SHAPES = [(8, 307_200), (64, 38_400), (176, 4_352), (3, 5_037), (1, 20_000), (5, 77)]


def _args(metric, seed, b, n, device):
    return chip_smoke.ne_solver_args(metric, chip_smoke.ne_rows(seed, b, n), device)


def _assert_near_f64(metric, args, ata, atb):
    """``ata``, ``atb`` within ``chip_smoke.NE_TOL`` of the terms'
    magnitudes of the float64 sum of ``args``' rows."""
    a64, b64, amag, bmag = chip_smoke.ne_sums64(metric, args)
    for got, want, mag, what in ((ata, a64, amag, "ata"), (atb, b64, bmag, "atb")):
        gap, share = chip_smoke.ne_gap(got, want, mag)
        assert share <= 1.0, (what, gap, share)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,want", [(0, (256, 1)), (1, (256, 1)), (256, (256, 1)),
                                    (2_048, (2_048, 1)), (2_049, (1_280, 2)),
                                    (4_352, (1_536, 3)), (38_400, (2_048, 19)),
                                    (307_200, (2_048, 150)), (1_000_192, (2_048, 489))])
def test_chunks_cover_the_rows(n, want):
    """A chunk holds a multiple of the CTA's threads, at most NE_CHUNK_ROWS
    rows; the chunks cover the pair's rows, none empty but at N = 0."""
    rows, chunks = linear.normal_equation_chunks(n)
    assert (rows, chunks) == want
    assert rows % linear.NE_THREADS == 0 and rows <= linear.NE_CHUNK_ROWS
    assert chunks * rows >= n and (n == 0 or (chunks - 1) * rows < n)


def _plain_before(metric, src, tgt, tn, sn, weights, valid, cs, ct):
    """The solvers' row building as it stood before the kernel, inline."""
    w = weights * valid.to(src.dtype)
    s, d = src - cs[..., None, :], tgt - ct[..., None, :]
    if metric == "plane":
        n = torch.where(torch.isfinite(tn), tn, 0.0)
        finite_n = torch.isfinite(tn).all(dim=-1).to(src.dtype)
        cols = [n[..., 2] * s[..., 1] - n[..., 1] * s[..., 2],
                n[..., 0] * s[..., 2] - n[..., 2] * s[..., 0],
                n[..., 1] * s[..., 0] - n[..., 0] * s[..., 1], n[..., 0], n[..., 1], n[..., 2]]
        rhs = torch.sum(n * d, dim=-1) - torch.sum(n * s, dim=-1)
        lam = linear.LAMBDA_PLANE
    else:
        ns = torch.where(torch.isfinite(sn), sn, 0.0)
        nt = torch.where(torch.isfinite(tn), tn, 0.0)
        finite_n = (torch.isfinite(sn).all(dim=-1) & torch.isfinite(tn).all(dim=-1)).to(src.dtype)
        n, sd = ns + nt, s + d
        cols = [sd[..., 1] * n[..., 2] - sd[..., 2] * n[..., 1],
                sd[..., 2] * n[..., 0] - sd[..., 0] * n[..., 2],
                sd[..., 0] * n[..., 1] - sd[..., 1] * n[..., 0], n[..., 0], n[..., 1], n[..., 2]]
        rhs = torch.sum((d - s) * n, dim=-1)
        lam = linear.LAMBDA_SYMMETRIC
    specs = [(cols, rhs, lam * w * finite_n)] + linear._point_row_specs(
        s, d, linear.LAMBDA_POINT * w)
    return linear._accumulate_normal_equations_soa(specs)


@pytest.mark.parametrize("metric", METRICS)
def test_cpu_takes_the_plain_path_unchanged(metric):
    """A CPU tensor runs the plain version: bit for bit the row building
    and products the solvers ran before the kernel, no kernel launched;
    and within the f32 tolerance of the float64 sum."""
    args = _args(metric, 1, 3, 500, "cpu")
    before = dict(_cuda.LAUNCHES)
    ata, atb = linear.normal_equations(*args)
    assert dict(_cuda.LAUNCHES) == before
    want_a, want_b = _plain_before(metric, *args)
    assert torch.equal(ata, want_a) and torch.equal(atb, want_b)
    _assert_near_f64(metric, args, ata, atb)


def test_cpu_unbatched_rows_match_their_batch_row():
    """(N, 3) operands (one pair, no leading axis) give the batch's row."""
    args = _args("symmetric", 2, 2, 300, "cpu")
    ata, atb = linear.normal_equations(*args)
    one = linear.normal_equations(*(a[1] for a in args))
    assert one[0].shape == (6, 6) and one[1].shape == (6,)
    np.testing.assert_allclose(one[0].numpy(), ata[1].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(one[1].numpy(), atb[1].numpy(), rtol=1e-6, atol=1e-6)


def _meta_args(metric, b=2, n=37):
    table = torch.zeros((b, n, 8), device="meta")
    return dict(src=torch.zeros((b, n, 3), device="meta"), tgt=table[..., :3],
                tgt_normals=table[..., 3:6],
                src_normals=torch.zeros((b, n, 3), device="meta") if metric == "symmetric"
                else None,
                weights=torch.zeros((b, n), device="meta"),
                valid=torch.zeros((b, n), dtype=torch.bool, device="meta"),
                center_src=torch.zeros((b, 3), device="meta"),
                center_tgt=torch.zeros((b, 3), device="meta"))


@pytest.mark.parametrize("case,match", [
    ("src_f64", "float32"), ("weights_shape", "shape"), ("valid_float", "torch.bool"),
    ("normals_strided", "last axis"), ("centre_shape", "shape"), ("meta", "CUDA")])
def test_cuda_entry_refuses_before_launch(monkeypatch, case, match):
    """The CUDA entry raises on a wrong dtype, shape, layout or device
    before anything is launched."""
    calls = []
    monkeypatch.setattr(_cuda, "launch", lambda *a, **k: calls.append(a))
    kw = _meta_args("symmetric")
    if case == "src_f64":
        kw["src"] = kw["src"].double()
    elif case == "weights_shape":
        kw["weights"] = torch.zeros((2, 38), device="meta")
    elif case == "valid_float":
        kw["valid"] = kw["valid"].float()
    elif case == "normals_strided":
        kw["src_normals"] = torch.zeros((2, 3, 37), device="meta").transpose(1, 2)
    elif case == "centre_shape":
        kw["center_tgt"] = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match=match):
        linear.normal_equations_cuda(**kw)
    assert calls == []


@pytest.mark.parametrize("metric", METRICS)
def test_cuda_entry_arguments_match_the_c_entry(monkeypatch, metric):
    """One launch a call, its arguments typed as the C entry's: the
    target rows' table strides, the chunk rows, the weights of the rows and
    the metric (meta tensors past every check but the device's, which is
    replaced with the launch)."""
    calls = []
    monkeypatch.setattr(linear, "_require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    b, n = 2, 4_352
    ata, atb = linear.normal_equations_cuda(**_meta_args(metric, b, n))
    assert ata.shape == (b, 6, 6) and atb.shape == (b, 6)
    (name, args), = calls
    assert name == "normal_equations"
    argtypes = _cuda.KERNELS[name][2]
    assert len(args) + 1 == len(argtypes)  # the stream is appended at launch
    for a, t in zip(args, argtypes):
        if a is None or isinstance(a, torch.Tensor):
            assert t is ctypes.c_void_p
        elif isinstance(a, float):
            assert t is ctypes.c_float
        else:
            assert t in (ctypes.c_int, ctypes.c_longlong), (a, t)
    assert args[4:12] == (n * 3, 3, n * 8, 8, n * 8, 8) + ((n * 3, 3) if metric == "symmetric"
                                                          else (0, 0))
    assert (args[3] is None) == (metric == "plane")
    partials = args[16]
    assert partials.shape == (b, 3, 27)
    lam_row = linear.LAMBDA_PLANE if metric == "plane" else linear.LAMBDA_SYMMETRIC
    assert args[20:] == (b, n, 1_536, lam_row, linear.LAMBDA_POINT, METRICS.index(metric))


def test_cuda_tensors_route_to_the_entry(monkeypatch):
    """Off the CPU, ``normal_equations`` hands the entry (B, N, 3) row
    views (a leading pair axis added or merged, the table's strides kept)
    and gives back the caller's leading shape."""
    seen = []

    def entry(*args):
        seen.append(args)
        b = args[0].shape[0]
        return torch.zeros((b, 6, 6), device="meta"), torch.zeros((b, 6), device="meta")

    monkeypatch.setattr(linear, "normal_equations_cuda", entry)
    kw = _meta_args("plane", 2, 37)
    ata, atb = linear.normal_equations(*(kw[k][0] if kw[k] is not None else None for k in kw))
    assert ata.shape == (6, 6) and atb.shape == (6,)
    src, tgt = seen[0][0], seen[0][1]
    assert src.shape == tgt.shape == (1, 37, 3) and tgt.stride()[1:] == (8, 1)
    lead = {k: (v[None].expand(3, *v.shape) if v is not None else None) for k, v in kw.items()}
    ata, atb = linear.normal_equations(*lead.values())
    assert ata.shape == (3, 2, 6, 6) and atb.shape == (3, 2, 6)
    assert seen[1][0].shape == (6, 37, 3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", CARD_SHAPES, ids=[f"{b}x{n}" for b, n in CARD_SHAPES])
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_matches_float64_sum(metric, b, n):
    """The kernel against the float64 sum of the same rows, within the
    f32 tolerance, at the main paths' shapes, a ragged N, one pair and N
    under one chunk; NaN and inf normals, zero weights and invalid rows in
    every pair; one launch."""
    dev = _card()
    args = _args(metric, b * 7 + n, b, n, dev)
    before = _cuda.LAUNCHES["normal_equations"]
    ata, atb = linear.normal_equations(*args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["normal_equations"] == before + 1
    _assert_near_f64(metric, args, ata, atb)
    assert torch.equal(ata, ata.transpose(-1, -2))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_is_deterministic_and_batch_blind(metric):
    """Two launches give the same bits; a pair's sums are the same bits
    alone as in its batch; all rows invalid, or all weights zero, give
    zeros exactly."""
    dev = _card()
    args = _args(metric, 5, 6, 9_000, dev)
    first = linear.normal_equations(*args)
    second = linear.normal_equations(*args)
    alone = linear.normal_equations(*(None if a is None else a[2:3] for a in args))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(alone[0][0], first[0][2]) and torch.equal(alone[1][0], first[1][2])
    invalid = list(args)
    invalid[5] = torch.zeros_like(args[5])
    zero_w = list(args)
    zero_w[4] = torch.zeros_like(args[4])
    for case in (invalid, zero_w):
        ata, atb = linear.normal_equations(*case)
        assert not ata.any() and not atb.any()


def _pipeline_data(dev, n_pairs=2, n_points=30_000):
    """ETH-like pairs at 20 m scale on the card, their kd indexes and the
    ground truth the pipeline's RMSE reads."""
    srcs, tgts, gt = [], [], []
    for i in range(n_pairs):
        tp, tn = bench.synth_cloud(n_points, 2 * i)
        T = bench.eth_true_pose(i)
        sp = (tp @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        sn = (tn @ T[:3, :3].T).astype(np.float32)
        gt.append((sp, tp))
        srcs.append(tcloud.from_numpy(sp, normals=sn, morton_order=True, device=dev))
        tgts.append(tcloud.from_numpy(tp, normals=tn, morton_order=True, device=dev))
    kd = tkd.stack_kd_indexes([
        tkd.build_kd_index(t.points.cpu().numpy(), t.valid.cpu().numpy(), block_target=256,
                           device=dev) for t in tgts])
    gt_src, gt_tgt = (np.stack(x) for x in zip(*gt))
    return ticp.stack_clouds(srcs), ticp.stack_clouds(tgts), kd, dict(
        gt_source_points=gt_src, gt_target_points=gt_tgt)


def _rotation_gap(a, b):
    """Angle (rad) between the rotations of (B, 4, 4) poses, from
    |R_a^T R_b - I| (Frobenius) = 2 sqrt(2) sin(angle / 2), in float64."""
    r = a[:, :3, :3].double().transpose(-1, -2) @ b[:, :3, :3].double()
    eye = torch.eye(3, dtype=torch.float64, device=r.device)
    return 2.0 * torch.arcsin((torch.linalg.norm(r - eye, dim=(-2, -1)) / 8 ** 0.5).clamp(max=1))


# The benchmark's limits on the arm's cells (PERF.md §2): the symmetric arm
# runs the ETH cell, point-to-plane the projective cell (the colour cell's
# limits are set at its own 307,200-row frames).
RUN_LIMITS = {"symmetric": (2.0e-3, 1.2e-4), "plane": (3.0e-5, 5e-6)}


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_pipeline_poses_match_the_cublas_products(monkeypatch, metric):
    """``run_icp_batch`` on the card with the kernel against the same run
    with the cuBLAS products the solvers used before (the plain version on
    CUDA tensors): one kernel launch an iteration, final poses within the
    benchmark's limits of the arm's cell, the same first match counts, and
    the RMSE down tenfold."""
    dev = _card()
    sources, targets, kd, gt = _pipeline_data(dev)
    cfg = tconfig.ICPConfig(
        metric=tconfig.Metric.SYMMETRIC if metric == "symmetric" else tconfig.Metric.POINT_TO_PLANE,
        minimizer=tconfig.Minimizer.LINEAR, selection=tconfig.Selection.RANDOM,
        selection_proba=0.05, n_iterations=12, max_distance=10.0, matching_checks=0)
    before = _cuda.LAUNCHES["normal_equations"]
    fused = ticp.run_icp_batch(cfg, sources, targets, seed=3, kd_indexes=kd, device=dev,
                               **gt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["normal_equations"] - before == cfg.n_iterations

    def cublas(src, tgt, tn, sn, weights, valid, cs, ct):
        w = weights * valid.to(src.dtype)
        return linear._accumulate_normal_equations_soa(
            linear._row_specs(src, tgt, tn, sn, w, cs, ct))

    monkeypatch.setattr(linear, "normal_equations_cuda", cublas)
    before = _cuda.LAUNCHES["normal_equations"]
    products = ticp.run_icp_batch(cfg, sources, targets, seed=3, kd_indexes=kd, device=dev,
                                  **gt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["normal_equations"] == before
    t_lim, r_lim = RUN_LIMITS[metric]
    t_gap = torch.linalg.norm(fused.pose[:, :3, 3] - products.pose[:, :3, 3], dim=-1)
    assert float(t_gap.mean()) <= t_lim
    assert float(_rotation_gap(fused.pose, products.pose).mean()) <= r_lim
    assert torch.equal(fused.trace.num_matches[:, 0], products.trace.num_matches[:, 0])
    assert bool((fused.trace.rmse[:, -1] < 0.1 * fused.trace.rmse[:, 0]).all())
