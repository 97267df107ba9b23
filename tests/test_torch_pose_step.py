"""The linear solvers' tail (``solvers/linear.pose_step``): the 6x6 solve
and the increment's recovery. On the CPU: the plain version unchanged, the
ICP loop multiplying the pose by ``_solve``'s increment on every arm, the
CUDA entry's checks and arguments, and the routing of CUDA tensors and of
the ICP loop's linear arms. On the card: the kernel
``csrc/pose_step.cu`` against the plain version run in float64 on the same
f32 inputs (``chip_smoke``'s ``ps_inputs``, ``ps_tail64``, ``ps_ulps``),
ill-conditioned, empty and non-finite pairs, and whole ``run_icp_batch``
runs against the same runs with the plain tail on the card."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.ops import weighting
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.solvers import linear
from test_torch_normal_equations import RUN_LIMITS, _pipeline_data, _rotation_gap

torch.set_num_threads(2)

METRICS = ("plane", "symmetric")
# The three cells' batches and arms: colour, projective, ETH.
CARD_SHAPES = [(8, "plane"), (64, "plane"), (176, "symmetric")]


def _tail_before(ata, atb, cs, ct, symmetric):
    """The solvers' tail as it stood before the pose step, inline."""
    eye6 = torch.eye(6, dtype=ata.dtype)
    if not symmetric:
        x = torch.linalg.solve_ex(ata + 1e-12 * eye6, atb[..., None])[0][..., 0]
        R = se3.euler_xyz_to_matrix(x[..., 0], x[..., 1], x[..., 2])
        return (se3.translation_matrix(ct) @ se3.pose_matrix(R, x[..., 3:6])
                @ se3.translation_matrix(-ct))
    x = torch.linalg.solve_ex(ata + (1e-4 ** 2) * eye6, atb[..., None])[0][..., 0]
    a_tilde, t_tilde = x[..., :3], x[..., 3:6]
    tan_theta = torch.linalg.norm(a_tilde, dim=-1)
    big = tan_theta > 1e-12
    safe_tan = torch.where(big, tan_theta, 1.0)
    sin_theta = tan_theta / torch.sqrt(1.0 + tan_theta * tan_theta)
    cos_theta = torch.where(big, sin_theta / safe_tan, 1.0)
    t = t_tilde * cos_theta[..., None]
    R = torch.where(big[..., None, None],
                    se3.rodrigues_matrix(a_tilde / safe_tan[..., None], sin_theta, cos_theta),
                    torch.eye(3, dtype=x.dtype))
    rod = se3.pose_matrix(R, torch.zeros_like(t))
    return (se3.translation_matrix(ct) @ rod @ se3.translation_matrix(t) @ rod
            @ se3.translation_matrix(-cs))


def _match_arrays(seed, b, n, device):
    """``chip_smoke.ne_rows``' matches as the ICP loop's MatchArrays and
    weights."""
    src, tgt, tn, sn, w, valid, _, _ = chip_smoke.ne_solver_args(
        "symmetric", chip_smoke.ne_rows(seed, b, n), device)
    m = weighting.MatchArrays(src_points=src, tgt_points=tgt, src_normals=sn, tgt_normals=tn,
                              src_colors=torch.zeros_like(src), tgt_colors=torch.zeros_like(tgt),
                              valid=valid)
    return m, w


def _unit(normals):
    """Unit normals, the non-finite ones zero (GICP's covariances need
    unit normals)."""
    return torch.nn.functional.normalize(torch.nan_to_num(normals, nan=0.0, posinf=0.0), dim=-1)


def _poses(b, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0.0, 0.5, (b, 3)).astype(np.float32))
    return se3.pose_matrix(se3.axis_angle_to_matrix(w), torch.from_numpy(
        rng.uniform(-5.0, 5.0, (b, 3)).astype(np.float32))).to(device)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_cpu_takes_the_plain_tail_unchanged(metric):
    """On CPU tensors the solvers' increments, and ``pose_step``'s, are bit
    for bit the tail they ran before the pose step, and nothing is
    launched."""
    sym = metric == "symmetric"
    src, tgt, tn, sn, w, valid, _, _ = chip_smoke.ne_solver_args(
        metric, chip_smoke.ne_rows(4, 3, 400), "cpu")
    ct = se3.masked_mean(tgt, valid)
    cs = se3.masked_mean(src, valid) if sym else ct
    before = dict(_cuda.LAUNCHES)
    if sym:
        inc = linear.estimate_pose_symmetric(src, tgt, sn, tn, w, valid)
    else:
        inc = linear.estimate_pose_point_to_plane(src, tgt, tn, w, valid)
    ata, atb = linear.normal_equations(src, tgt, tn, sn, w, valid, cs, ct)
    step = linear.pose_step(ata, atb, cs, ct, sym)
    assert dict(_cuda.LAUNCHES) == before
    want = _tail_before(ata, atb, cs, ct, sym)
    assert torch.equal(inc, want) and torch.equal(step, want)


def test_cpu_gicp_takes_the_plain_tail_unchanged():
    """GICP's increment on CPU tensors is the Euler tail of its own normal
    equations, bit for bit as before."""
    src, tgt, tn, sn, w, valid, _, ct = chip_smoke.ne_solver_args(
        "symmetric", chip_smoke.ne_rows(6, 2, 300), "cpu")
    tn, sn = (_unit(t) for t in (tn, sn))
    inc = linear.estimate_pose_gicp(src, tgt, sn, tn, w, valid)
    center = se3.masked_mean(tgt, valid)
    s, d = src - center[..., None, :], tgt - center[..., None, :]
    lt = linear.gicp_whitener(sn, tn).transpose(-1, -2)
    ata, atb = linear._accumulate_normal_equations(
        lt @ linear._point_rows(s), (lt @ (d - s)[..., None])[..., 0],
        (w * valid.to(w.dtype))[..., None].expand(*w.shape, 3))
    assert torch.equal(inc, _tail_before(ata, atb, center, center, False))


ARMS = {"point_to_point": (tconfig.Metric.POINT_TO_POINT, tconfig.Minimizer.LINEAR),
        "plane": (tconfig.Metric.POINT_TO_PLANE, tconfig.Minimizer.LINEAR),
        "symmetric": (tconfig.Metric.SYMMETRIC, tconfig.Minimizer.LINEAR),
        "gicp": (tconfig.Metric.GICP, tconfig.Minimizer.LINEAR),
        "lm": (tconfig.Metric.POINT_TO_PLANE, tconfig.Minimizer.NONLINEAR_LM)}


@pytest.mark.parametrize("metric", list(ARMS))
def test_cpu_loop_step_multiplies_as_before(monkeypatch, metric):
    """On the CPU the ICP loop's pose is ``_solve``'s increments
    multiplied onto the initial pose, ``increment @ pose``, bit for bit on
    every arm, with no launch: ``_solve`` is the one function that decides
    an iteration's step (the benchmark's own checks replace it)."""
    metric_, minimizer = ARMS[metric]
    cfg = tconfig.ICPConfig(metric=metric_, minimizer=minimizer,
                            selection=tconfig.Selection.RANDOM, selection_proba=0.5,
                            n_iterations=3, max_distance=10.0, matching_checks=0)
    sources, targets, kd, _ = _pipeline_data("cpu", n_pairs=2, n_points=1_500)
    increments = []
    real = ticp._solve

    def solve(*args, **kw):
        increments.append(real(*args, **kw))
        return increments[-1]

    monkeypatch.setattr(ticp, "_solve", solve)
    init = _poses(2, 7)
    before = dict(_cuda.LAUNCHES)
    res = ticp.run_icp_batch(cfg, sources, targets, init, seed=3, kd_indexes=kd, device="cpu")
    assert dict(_cuda.LAUNCHES) == before
    assert len(increments) == cfg.n_iterations
    want = init
    for inc in increments:
        want = inc @ want
    assert torch.equal(res.pose, want)


def _meta_args(b=3, solution=False):
    return dict(ata=torch.zeros((b, 6, 6), device="meta"), atb=torch.zeros((b, 6), device="meta"),
                center_src=torch.zeros((b, 3), device="meta"),
                center_tgt=torch.zeros((b, 3), device="meta"), symmetric=True,
                solution=torch.zeros((b, 6), dtype=torch.float64, device="meta")
                if solution else None)


@pytest.mark.parametrize("case,match", [
    ("ata_f64", "float32"), ("atb_shape", "shape"), ("centre_shape", "shape"),
    ("atb_strided", "contiguous"), ("centre_f64", "float32"), ("solution_f32", "float64"),
    ("ata_strided", "contiguous"), ("meta", "CUDA")])
def test_cuda_entry_refuses_before_launch(monkeypatch, case, match):
    """The CUDA entry raises on a wrong dtype, shape, layout or device
    before anything is launched."""
    calls = []
    monkeypatch.setattr(_cuda, "launch", lambda *a, **k: calls.append(a))
    kw = _meta_args(solution=True)
    if case == "ata_f64":
        kw["ata"] = kw["ata"].double()
    elif case == "atb_shape":
        kw["atb"] = torch.zeros((3, 7), device="meta")
    elif case == "centre_shape":
        kw["center_src"] = torch.zeros((4, 3), device="meta")
    elif case == "atb_strided":
        kw["atb"] = torch.zeros((3, 12), device="meta")[:, ::2]
    elif case == "centre_f64":
        kw["center_tgt"] = kw["center_tgt"].double()
    elif case == "solution_f32":
        kw["solution"] = kw["solution"].float()
    elif case == "ata_strided":
        kw["ata"] = torch.zeros((3, 6, 12), device="meta")[..., ::2]
    with pytest.raises(ValueError, match=match):
        linear.pose_step_cuda(**kw)
    assert calls == []


@pytest.mark.parametrize("with_solution", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_entry_arguments_match_the_c_entry(monkeypatch, metric, with_solution):
    """One launch a call, its arguments typed as the C entry's: the
    operands' pointers (a null solution without one), the pairs, the arm's
    diagonal term and its recovery (meta tensors past every check but the
    device's, which is replaced with the launch)."""
    calls = []
    monkeypatch.setattr(linear, "_require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    kw = _meta_args(b=5, solution=with_solution)
    kw["symmetric"] = metric == "symmetric"
    inc = linear.pose_step_cuda(**kw)
    assert inc.shape == (5, 4, 4) and inc.dtype == torch.float32
    (name, args), = calls
    assert name == "pose_step"
    argtypes = _cuda.KERNELS[name][2]
    assert len(args) + 1 == len(argtypes)  # the stream is appended at launch
    for a, t in zip(args, argtypes):
        if a is None or isinstance(a, torch.Tensor):
            assert t is ctypes.c_void_p
        elif isinstance(a, float):
            assert t is ctypes.c_double
        else:
            assert t is ctypes.c_int, (a, t)
    assert args[0] is kw["ata"] and args[3] is kw["center_tgt"] and args[4] is inc
    assert args[5] is kw["solution"]
    diag = linear.DIAG_SYMMETRIC if metric == "symmetric" else linear.DIAG_EULER
    assert args[6:] == (5, diag, METRICS.index(metric))
    assert linear.DIAG_SYMMETRIC == linear.TIKHONOV_SYMMETRIC ** 2 and linear.DIAG_EULER == 1e-12


def test_cuda_tensors_route_to_the_entry(monkeypatch):
    """Off the CPU, ``pose_step`` hands the entry (B, ...) operands (a
    leading pair axis added or merged) and gives back the caller's
    leading shape."""
    seen = []

    def entry(ata, atb, cs, ct, symmetric):
        seen.append((ata.shape, atb.shape, cs.shape, ct.shape, symmetric))
        return torch.zeros((ata.shape[0], 4, 4), device="meta")

    monkeypatch.setattr(linear, "pose_step_cuda", entry)
    kw = _meta_args(b=6)
    lead = {k: v.reshape(2, 3, *v.shape[1:]) for k, v in kw.items()
            if isinstance(v, torch.Tensor)}
    inc = linear.pose_step(lead["ata"], lead["atb"], lead["center_src"], lead["center_tgt"],
                           True)
    assert inc.shape == (2, 3, 4, 4)
    inc = linear.pose_step(kw["ata"][0], kw["atb"][0], kw["center_src"][0],
                           kw["center_tgt"][0], False)
    assert inc.shape == (4, 4)
    assert seen == [((6, 6, 6), (6, 6), (6, 3), (6, 3), True),
                    ((1, 6, 6), (1, 6), (1, 3), (1, 3), False)]


@pytest.mark.parametrize("metric", ["plane", "symmetric", "gicp"])
def test_loop_routes_linear_arms_to_the_kernel(monkeypatch, metric):
    """Off the CPU the ICP loop's linear arms take their increment from one
    call of the pose step's entry, with the arm's recovery."""
    seen = []

    def entry(ata, atb, cs, ct, symmetric):
        seen.append(symmetric)
        return torch.full((ata.shape[0], 4, 4), 2.0, device="meta")

    def sums(src, *args):
        b = src.shape[0]
        return torch.zeros((b, 6, 6), device="meta"), torch.zeros((b, 6), device="meta")

    monkeypatch.setattr(linear, "pose_step_cuda", entry)
    monkeypatch.setattr(linear, "normal_equations_cuda", sums)
    cfg = tconfig.ICPConfig(metric={"plane": tconfig.Metric.POINT_TO_PLANE,
                                    "symmetric": tconfig.Metric.SYMMETRIC,
                                    "gicp": tconfig.Metric.GICP}[metric],
                            minimizer=tconfig.Minimizer.LINEAR)
    b, n = 3, 50
    z = torch.zeros((b, n, 3), device="meta")
    m = weighting.MatchArrays(src_points=z, tgt_points=z, src_normals=z, tgt_normals=z,
                              src_colors=z, tgt_colors=z,
                              valid=torch.zeros((b, n), dtype=torch.bool, device="meta"))
    inc = ticp._solve(cfg, m, torch.zeros((b, n), device="meta"))
    assert seen == [metric == "symmetric"]
    assert inc.shape == (b, 4, 4)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plain_on_card(ata, atb, cs, ct, symmetric, solution=None):
    """The plain tail on the card's tensors, in their f32, in the entry's
    place."""
    return linear._plain_pose_step(ata, atb, cs, ct, symmetric)


@pytest.mark.cuda
@pytest.mark.parametrize("b,metric", CARD_SHAPES, ids=[f"{b}-{m}" for b, m in CARD_SHAPES])
def test_kernel_matches_the_float64_tail(b, metric):
    """At the three cells' batches, the kernel's increment is within 4 f32
    ulps of each entry's magnitude of the plain tail run in float64 on the
    same f32 inputs; one launch a call."""
    dev = _card()
    sym = metric == "symmetric"
    ata, atb, cs, ct = chip_smoke.ps_inputs(metric, b, 17 + b, dev)
    before = _cuda.LAUNCHES["pose_step"]
    inc = linear.pose_step(ata, atb, cs, ct, sym)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pose_step"] == before + 1
    want = chip_smoke.ps_tail64(ata, atb, cs, ct, sym)
    assert chip_smoke.ps_ulps(inc, want) <= chip_smoke.PS_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_solves_ill_conditioned_pairs_to_float64_rounding(metric):
    """Normal equations that are singular in f32 (a repeated column), left
    regular by the diagonal term alone (condition numbers past 1e10): the
    kernel's ``(ata + diag I) x - atb`` is within float64 rounding of the
    residual of torch's float64 solve."""
    dev = _card()
    rng = np.random.default_rng(11)
    b = 16
    a = rng.integers(-5, 6, (b, 12, 6)).astype(np.float64)
    a[..., 5] = a[..., 4]
    ata = np.einsum("bki,bkj->bij", a, a)
    atb = np.einsum("bki,bk->bi", a, rng.integers(-9, 10, (b, 12)).astype(np.float64))
    zeros = torch.zeros((b, 3), device=dev)
    solution = torch.empty((b, 6), dtype=torch.float64, device=dev)
    linear.pose_step_cuda(torch.from_numpy(ata.astype(np.float32)).to(dev),
                          torch.from_numpy(atb.astype(np.float32)).to(dev), zeros, zeros,
                          metric == "symmetric", solution=solution)
    x = solution.cpu().numpy()
    diag = linear.DIAG_SYMMETRIC if metric == "symmetric" else linear.DIAG_EULER
    lhs = ata + diag * np.eye(6)
    ref = torch.linalg.solve(torch.from_numpy(lhs), torch.from_numpy(atb)).numpy()
    eps = np.finfo(np.float64).eps
    for got in (x, ref):
        assert np.isfinite(got).all()
    r_got = np.abs(np.einsum("bij,bj->bi", lhs, x) - atb).max(-1)
    r_ref = np.abs(np.einsum("bij,bj->bi", lhs, ref) - atb).max(-1)
    scale = (np.einsum("bij,bj->bi", np.abs(lhs), np.abs(x)) + np.abs(atb)).max(-1)
    assert (np.linalg.cond(lhs) > 1e10).all()
    assert (r_got <= r_ref + 64 * eps * scale).all(), (r_got, r_ref, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_on_empty_and_non_finite_pairs(metric):
    """A pair with no match gives the identity increment, as the plain tail
    does; pairs with a NaN in ``ata`` or an inf in ``atb`` give non-finite
    increments where the plain tail's are, and the other pairs stay
    finite."""
    dev = _card()
    sym = metric == "symmetric"
    m, w = _match_arrays(21, 6, 2_000, dev)
    m = m._replace(valid=m.valid.clone())
    m.valid[1] = False
    if sym:
        def solve():
            return linear.estimate_pose_symmetric(m.src_points, m.tgt_points, m.src_normals,
                                                  m.tgt_normals, w, m.valid)
    else:
        def solve():
            return linear.estimate_pose_point_to_plane(m.src_points, m.tgt_points,
                                                       m.tgt_normals, w, m.valid)
    inc = solve()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linear, "pose_step_cuda", _plain_on_card)
        plain_inc = solve()
    eye = torch.eye(4, device=dev)
    assert torch.equal(inc[1], eye) and torch.equal(plain_inc[1], eye)

    ata, atb, cs, ct = chip_smoke.ps_inputs(metric, 6, 23, dev)
    ata[2, 1, 3] = float("nan")
    atb[3, 4] = float("inf")
    got = linear.pose_step(ata, atb, cs, ct, sym)
    plain = linear._plain_pose_step(ata, atb, cs, ct, sym)
    got_bad = ~torch.isfinite(got).all(-1).all(-1)
    plain_bad = ~torch.isfinite(plain).all(-1).all(-1)
    assert plain_bad[2:4].all() and not plain_bad[[0, 1, 4, 5]].any()
    assert torch.equal(got_bad, plain_bad)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_is_deterministic_and_batch_blind(metric):
    """Two launches give the same bits, and a pair's answers are the same
    bits alone, in a slice or in the whole batch."""
    dev = _card()
    sym = metric == "symmetric"
    ata, atb, cs, ct = chip_smoke.ps_inputs(metric, 176, 5, dev)
    first = linear.pose_step(ata, atb, cs, ct, sym)
    assert torch.equal(linear.pose_step(ata, atb, cs, ct, sym), first)
    for lo, hi in ((3, 4), (100, 133), (170, 176)):
        part = linear.pose_step(ata[lo:hi], atb[lo:hi], cs[lo:hi], ct[lo:hi], sym)
        assert torch.equal(part, first[lo:hi])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["plane", "symmetric", "gicp"])
def test_pipeline_poses_match_the_torch_tail(monkeypatch, metric):
    """``run_icp_batch`` on the card with the kernel against the same run
    with the plain tail's PyTorch ops on the card: one kernel launch an
    iteration, final poses within the benchmark's limits of the arm's cell
    (GICP, on no cell, held to the ETH cell's on these ETH-like pairs), the
    same first match counts, and the RMSE down tenfold."""
    dev = _card()
    sources, targets, kd, gt = _pipeline_data(dev)
    cfg = tconfig.ICPConfig(
        metric={"plane": tconfig.Metric.POINT_TO_PLANE, "symmetric": tconfig.Metric.SYMMETRIC,
                "gicp": tconfig.Metric.GICP}[metric],
        minimizer=tconfig.Minimizer.LINEAR, selection=tconfig.Selection.RANDOM,
        selection_proba=0.05, n_iterations=12, max_distance=10.0, matching_checks=0)
    before = _cuda.LAUNCHES["pose_step"]
    fused = ticp.run_icp_batch(cfg, sources, targets, seed=3, kd_indexes=kd, device=dev, **gt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pose_step"] - before == cfg.n_iterations

    monkeypatch.setattr(linear, "pose_step_cuda", _plain_on_card)
    before = _cuda.LAUNCHES["pose_step"]
    plain = ticp.run_icp_batch(cfg, sources, targets, seed=3, kd_indexes=kd, device=dev, **gt)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["pose_step"] == before
    t_lim, r_lim = RUN_LIMITS["plane" if metric == "plane" else "symmetric"]
    t_gap = torch.linalg.norm(fused.pose[:, :3, 3] - plain.pose[:, :3, 3], dim=-1)
    assert float(t_gap.mean()) <= t_lim
    assert float(_rotation_gap(fused.pose, plain.pose).mean()) <= r_lim
    assert torch.equal(fused.trace.num_matches[:, 0], plain.trace.num_matches[:, 0])
    assert bool((fused.trace.rmse[:, -1] < 0.1 * fused.trace.rmse[:, 0]).all())
