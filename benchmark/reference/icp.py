"""Plain ICP: the registration each cell's answers are judged against.

One pair at a time, in plain PyTorch on whatever device it is handed:

* selection: every valid row at the iteration's stride (the coarse-to-fine
  schedule when multi-resolution is on), or the Bernoulli draws of
  compacted random selection, worked out again from the call's seed;
* matching: the exact nearest valid target row in xyz (or in
  [xyz, rgb/255] under colour ICP) by brute force over the rows a box
  around each block of queries holds, or the nearest valid
  pixel of the projective window, under the squared distance threshold;
* rejection of matches whose normals differ by more than 60 degrees;
* the linearised point-to-plane or symmetric solve, and the increment
  applied from the left.

The arithmetic is float32, the precision the configurations state, with
TF32 off; its linear algebra is matrix products (the rigid transforms of
the points and normals, the composition of poses, the normal equations,
and the ranking of the brute-force search). ``precision="tf32"`` is the
control: every matrix product takes its operands rounded to TF32 (10
mantissa bits), as the tensor cores do with TF32 on. ``precision="fp64"``
runs everything in float64, a witness of how far float32 rounding alone
moves an answer. The brute-force search settles the best few candidates of
its ranking by direct differences, so it finds the exact neighbour except
at ties within rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NN_CANDIDATES = 4          # rows settled by direct differences per query
QUERY_CHUNK = 1024         # query rows per brute-force block
COS_REJECT = math.cos(60.0 * math.pi / 180.0)
LAMBDA_POINT = 0.1         # ICPOptimizer.h:737
TIKHONOV_SYMMETRIC = 1e-4  # ICPOptimizer.h:863


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _chain(precision: str, *ms: torch.Tensor) -> torch.Tensor:
    out = ms[0]
    for m in ms[1:]:
        out = _mm(out, m, precision)
    return out


def stride_schedule(num_points: int, n_iterations: int, enabled: bool,
                    minimum_points: int = 100) -> list[int]:
    """Per-iteration strides of the coarse-to-fine loop: halve the point
    count until it would drop below ``minimum_points`` for the first
    stride, halve the stride each iteration, and run past
    ``n_iterations`` until full resolution."""
    if not enabled:
        return [1] * n_iterations
    stride, size = 1, num_points
    while True:
        size //= 2
        if size < minimum_points:
            break
        stride *= 2
    out, i = [], 0
    while True:
        out.append(stride)
        if stride == 1 and i >= n_iterations - 1:
            return out
        stride = max(stride // 2, 1)
        i += 1


def compact_capacity(n: int, proba: float) -> int:
    """Query slots of compacted random selection: expected count plus ten
    binomial sigmas plus 64, to a multiple of 128."""
    sigma = (n * proba * (1.0 - proba)) ** 0.5
    k = int(n * proba + 10.0 * sigma) + 64
    return min(n, ((k + 127) // 128) * 128)


def gap_draws(call_seed: int, batch: int, row: int, capacity: int, proba: float,
              n_iterations: int, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Row ``row``'s selections for each iteration of a call of ``batch``
    pairs seeded with ``call_seed``: one uniform block of (batch, slots)
    from a generator on ``device`` per iteration, turned into geometric
    gaps between successes. Returns ``(rows, in_range)`` per iteration."""
    k_cap = compact_capacity(capacity, proba)
    gen = torch.Generator(device=device).manual_seed(int(call_seed))
    tiny = float(np.finfo(np.float32).tiny)
    out = []
    for _ in range(n_iterations):
        u = torch.rand(batch, k_cap, generator=gen, device=device).clamp_min(tiny)
        g = torch.floor(torch.log(u) / np.log1p(-proba)).to(torch.int64)
        lattice = torch.clamp(torch.cumsum(g + 1, dim=-1) - 1, max=capacity)
        rows = lattice[row]
        out.append((torch.clamp(rows, max=capacity - 1), rows < capacity))
    return out


def nearest(q: torch.Tensor, t: torch.Tensor, t_ok: torch.Tensor, max_d2: float,
            precision: str):
    """Nearest valid row of ``t`` (N, D) for each row of ``q`` (M, D) among
    the rows within ``max_d2`` of it: ``(idx, d2)``, idx -1 and d2 = inf
    where none is. Queries go in blocks of QUERY_CHUNK rows; a block
    searches the valid targets inside its bounding box widened by
    sqrt(``max_d2``) on every axis (which holds every target within
    ``max_d2`` of any of its queries), ranks them by ``|t|^2 - 2 q.t`` (a
    matrix product, centred on the box) and settles the best NN_CANDIDATES
    by direct squared differences."""
    reach = math.sqrt(max_d2) * (1.0 + 1e-5) + 1e-6
    idx_out, d2_out = [], []
    for s in range(0, q.shape[0], QUERY_CHUNK):
        qs = q[s:s + QUERY_CHUNK]
        lo, hi = qs.min(0).values - reach, qs.max(0).values + reach
        cidx = torch.nonzero(t_ok & ((t >= lo) & (t <= hi)).all(-1))[:, 0]
        if cidx.numel() == 0:
            idx_out.append(torch.full((qs.shape[0],), -1, dtype=torch.int64, device=q.device))
            d2_out.append(torch.full((qs.shape[0],), torch.inf, dtype=q.dtype, device=q.device))
            continue
        center = 0.5 * (lo + hi)
        tc, qc = t[cidx] - center, qs - center
        score = (tc * tc).sum(-1)[None, :] - 2.0 * _mm(qc, tc.T, precision)
        k = min(NN_CANDIDATES, cidx.numel())
        cand = torch.topk(score, k, dim=-1, largest=False).indices
        diff = qs[:, None, :] - t[cidx[cand]]
        d2 = (diff * diff).sum(-1)
        best = torch.argmin(d2, dim=-1, keepdim=True)
        idx_out.append(cidx[torch.gather(cand, 1, best)[:, 0]])
        d2_out.append(torch.gather(d2, 1, best)[:, 0])
    return torch.cat(idx_out), torch.cat(d2_out)


def projective_nearest(q: torch.Tensor, t_img: torch.Tensor, t_ok: torch.Tensor, cam: dict,
                       window: int):
    """Nearest valid target pixel within +-``window`` pixels of each
    query's projection (pixels inside the image only): ``(idx, d2)``,
    idx -1 and d2 = inf where the window holds none."""
    w, h = cam["width"], cam["height"]
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    u0 = torch.round(torch.clamp(x * cam["fx"] / safe_z + cam["cx"], -1e6, 1e6)).to(torch.int64)
    v0 = torch.round(torch.clamp(y * cam["fy"] / safe_z + cam["cy"], -1e6, 1e6)).to(torch.int64)
    best = torch.full_like(x, torch.inf)
    arg = torch.full_like(u0, -1)
    offs = torch.arange(-window, window + 1, device=q.device)
    for dv in range(-window, window + 1):
        u = u0[:, None] + offs[None, :]
        v = (v0 + dv)[:, None].expand_as(u)
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        lin = torch.where(inside, v * w + u, 0)
        ok = inside & t_ok[lin]
        tp = t_img[lin]
        dx, dy, dz = tp[..., 0] - x[:, None], tp[..., 1] - y[:, None], tp[..., 2] - z[:, None]
        d2 = torch.where(ok, dx * dx + dy * dy + dz * dz, torch.inf)
        m, a = torch.min(d2, dim=-1)
        better = m < best
        best = torch.where(better, m, best)
        arg = torch.where(better, torch.gather(lin, 1, a[:, None])[:, 0], arg)
    return arg, best


def _finite_or_zero(n: torch.Tensor):
    ok = torch.isfinite(n).all(dim=-1)
    return torch.where(ok[:, None], n, 0.0), ok


def _point_rows(s: torch.Tensor, d: torch.Tensor):
    """The three small-angle rows of ``M s + t = d``,
    M = [[1, -g, b], [g, 1, -a], [-b, a, 1]], unknowns (a, b, g, t)."""
    z, o = torch.zeros_like(s[:, 0]), torch.ones_like(s[:, 0])
    rows = [
        torch.stack([z, s[:, 2], -s[:, 1], o, z, z], -1),
        torch.stack([-s[:, 2], z, s[:, 0], z, o, z], -1),
        torch.stack([s[:, 1], -s[:, 0], z, z, z, o], -1),
    ]
    return rows, [d[:, k] - s[:, k] for k in range(3)]


def _normal_equations(rows, rhs, weights, precision):
    """Sum of w^2 a a^T and w^2 a b over every row, by matrix products."""
    A = torch.cat(rows, dim=0)
    b = torch.cat(rhs, dim=0)
    w2 = torch.cat(weights, dim=0) ** 2
    wa = A * w2[:, None]
    return _mm(wa.T, A, precision), _mm(wa.T, b[:, None], precision)[:, 0]


def _translation(t: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=t.dtype, device=t.device)
    m[:3, 3] = t
    return m


def _pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=R.dtype, device=R.device)
    m[:3, :3] = R
    m[:3, 3] = t
    return m


def _masked_mean(p: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    w = ok.to(p.dtype)
    return (p * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1e-12)


def solve_point_to_plane(s_pts, t_pts, t_nrm, ok, precision):
    """Linearised point-to-plane step (plane rows weight 1, point rows
    0.1), centred at the matched targets' mean; Euler angles
    R = Rx(a) Ry(b) Rz(g)."""
    c = _masked_mean(t_pts, ok)
    s, d = s_pts - c, t_pts - c
    n, n_ok = _finite_or_zero(t_nrm)
    w = ok.to(s.dtype)
    plane = torch.stack([s[:, 1] * n[:, 2] - s[:, 2] * n[:, 1],
                         s[:, 2] * n[:, 0] - s[:, 0] * n[:, 2],
                         s[:, 0] * n[:, 1] - s[:, 1] * n[:, 0],
                         n[:, 0], n[:, 1], n[:, 2]], -1)
    prow, prhs = _point_rows(s, d)
    ata, atb = _normal_equations(
        [plane] + prow, [(n * (d - s)).sum(-1)] + prhs,
        [w * n_ok.to(s.dtype)] + [LAMBDA_POINT * w] * 3, precision)
    x = torch.linalg.solve(ata + 1e-12 * torch.eye(6, dtype=ata.dtype, device=ata.device), atb)
    ca, sa = torch.cos(x[0]), torch.sin(x[0])
    cb, sb = torch.cos(x[1]), torch.sin(x[1])
    cg, sg = torch.cos(x[2]), torch.sin(x[2])
    one, zero = torch.ones_like(ca), torch.zeros_like(ca)
    Rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, ca, -sa]),
                      torch.stack([zero, sa, ca])])
    Ry = torch.stack([torch.stack([cb, zero, sb]), torch.stack([zero, one, zero]),
                      torch.stack([-sb, zero, cb])])
    Rz = torch.stack([torch.stack([cg, -sg, zero]), torch.stack([sg, cg, zero]),
                      torch.stack([zero, zero, one])])
    R = _chain(precision, Rx, Ry, Rz)
    return _chain(precision, _translation(c), _pose(R, x[3:6]), _translation(-c))


def solve_symmetric(s_pts, t_pts, s_nrm, t_nrm, ok, precision):
    """Symmetric ICP step (Rusinkiewicz 2019): both sides centred at their
    matched means, symmetric rows weight 1 and point rows 0.1, Tikhonov
    1e-4, rotation by tan(theta) about the solved axis, composed as
    T(mu_t) R T(t) R T(-mu_s)."""
    ms, mt = _masked_mean(s_pts, ok), _masked_mean(t_pts, ok)
    s, d = s_pts - ms, t_pts - mt
    ns, ok_s = _finite_or_zero(s_nrm)
    nt, ok_t = _finite_or_zero(t_nrm)
    n, sd = ns + nt, s + d
    w = ok.to(s.dtype)
    sym = torch.stack([sd[:, 1] * n[:, 2] - sd[:, 2] * n[:, 1],
                       sd[:, 2] * n[:, 0] - sd[:, 0] * n[:, 2],
                       sd[:, 0] * n[:, 1] - sd[:, 1] * n[:, 0],
                       n[:, 0], n[:, 1], n[:, 2]], -1)
    prow, prhs = _point_rows(s, d)
    ata, atb = _normal_equations(
        [sym] + prow, [((d - s) * n).sum(-1)] + prhs,
        [w * (ok_s & ok_t).to(s.dtype)] + [LAMBDA_POINT * w] * 3, precision)
    x = torch.linalg.solve(
        ata + TIKHONOV_SYMMETRIC ** 2 * torch.eye(6, dtype=ata.dtype, device=ata.device), atb)
    a, t = x[:3], x[3:6]
    tan = torch.linalg.norm(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    if float(tan) > 1e-12:
        axis = a / tan
        sin = tan / torch.sqrt(1.0 + tan * tan)
        cos = sin / tan
        K = torch.stack([torch.stack([torch.zeros_like(tan), -axis[2], axis[1]]),
                         torch.stack([axis[2], torch.zeros_like(tan), -axis[0]]),
                         torch.stack([-axis[1], axis[0], torch.zeros_like(tan)])])
        R = eye + sin * K + (1.0 - cos) * _mm(K, K, precision)
        t = t * cos
    else:
        R = eye
    rod = _pose(R, torch.zeros_like(t))
    return _chain(precision, _translation(mt), rod, _translation(t), rod, _translation(-ms))


def register(cfg: dict, source: dict, target: dict, init_pose, *, precision: str = "fp32",
             draws=None, device="cpu") -> dict:
    """The registration of ``source`` onto ``target`` from ``init_pose``:
    ``{"pose": the final (4, 4) pose, "t_norm": the norm of the pose's
    translation after each iteration, "matches": the matches entering
    each iteration's solve}`` (NumPy; the program's trace holds the same
    two rows, as ``rmse`` without ground truth and ``num_matches``).
    ``source`` / ``target``: the padded clouds of
    :mod:`derive` (NumPy). ``cfg``: metric ``SYMMETRIC`` or
    ``POINT_TO_PLANE``, ``max_distance`` (squared), ``n_iterations``,
    ``selection`` ``ALL`` or ``RANDOM`` (then ``draws``: one ``(rows,
    in_range)`` per iteration, :func:`gap_draws`), ``multi_resolution``,
    ``color_icp``, ``matching`` ``KNN`` or ``PROJECTIVE`` (then ``camera``
    and ``projective_window``), ``rejection``."""
    if precision not in ("fp32", "tf32", "fp64"):
        raise ValueError(f"precision must be fp32, tf32 or fp64, got {precision!r}")
    dev = torch.device(device)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _register(cfg, source, target, init_pose, precision, draws, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _register(cfg, source, target, init_pose, precision, draws, dev):
    dtype = torch.float64 if precision == "fp64" else torch.float32

    def on(x):
        x = torch.as_tensor(x).to(dev)
        return x.to(dtype) if x.is_floating_point() else x

    s_pts, s_nrm, s_col, s_ok = (on(source[k]) for k in ("points", "normals", "colors", "valid"))
    t_pts, t_nrm, t_col, t_ok = (on(target[k]) for k in ("points", "normals", "colors", "valid"))
    colour = bool(cfg.get("color_icp", False))
    projective = cfg.get("matching", "KNN") == "PROJECTIVE"
    t_feat = torch.cat([t_pts, t_col * (1.0 / 255.0)], -1) if colour else t_pts
    cap = s_pts.shape[0]
    strides = stride_schedule(cap, cfg["n_iterations"], bool(cfg.get("multi_resolution", False)))
    s_nrm_ok = torch.isfinite(s_nrm).all(-1)
    rows_all = torch.arange(cap, device=dev)
    pose = on(np.asarray(init_pose, np.float32))
    t_norm, matches = [], []
    for it, stride in enumerate(strides):
        if cfg.get("selection", "ALL") == "RANDOM":
            rows, in_range = draws[it]
            mask = in_range & s_ok[rows]
        else:
            rows = rows_all
            mask = s_ok.clone()
            if cfg.get("multi_resolution", False):
                mask &= (rows_all % stride == 0) & s_nrm_ok
        rows = rows[mask]
        R, t = pose[:3, :3], pose[:3, 3]
        q = _mm(s_pts[rows], R.T, precision) + t
        qn = _mm(s_nrm[rows], R.T, precision)
        if projective:
            idx, d2 = projective_nearest(q, t_pts, t_ok, cfg["camera"], cfg["projective_window"])
        else:
            qf = torch.cat([q, s_col[rows] * (1.0 / 255.0)], -1) if colour else q
            idx, d2 = nearest(qf, t_feat, t_ok, cfg["max_distance"], precision)
        ok = (d2 <= cfg["max_distance"]) & (idx >= 0)
        idx = idx.clamp(min=0)
        tp, tn = t_pts[idx], t_nrm[idx]
        if cfg.get("rejection", True):
            cos = (qn * tn).sum(-1) / (torch.linalg.norm(qn, dim=-1) * torch.linalg.norm(tn, dim=-1))
            ok &= ~((cos < COS_REJECT) & ~torch.isnan(cos))
        if cfg["metric"] == "SYMMETRIC":
            inc = solve_symmetric(q, tp, qn, tn, ok, precision)
        elif cfg["metric"] == "POINT_TO_PLANE":
            inc = solve_point_to_plane(q, tp, tn, ok, precision)
        else:
            raise ValueError(f"the reference has no {cfg['metric']} solve")
        pose = _mm(inc, pose, precision)
        t_norm.append(torch.linalg.norm(pose[:3, 3]))
        matches.append(ok.sum())
    return {"pose": pose.detach().cpu().numpy(),
            "t_norm": torch.stack(t_norm).double().cpu().numpy(),
            "matches": torch.stack(matches).cpu().numpy()}
