"""Linear (small-angle) point-to-plane, symmetric-ICP and GICP solvers.

PyTorch port of ``icp_variants_tpu.solvers.linear``
(``LinearICPOptimizer``, ICPOptimizer.h:676-898). The 6x6 normal
equations are accumulated directly from per-match Jacobian columns and
solved on the device; every function broadcasts over a leading pair axis.
The solve uses ``torch.linalg.solve_ex``, which reports singular systems in
its ``info`` output instead of synchronising with the host.

Row layouts per match (weights fold in mask * per-match weight):
* plane row  (lambda=1.0):  [n x s ; n] . x = n.(d - s)        (ICPOptimizer.h:698-710)
* point rows (lambda=0.1):  small-angle  Ms + t - d            (ICPOptimizer.h:717-733)
* symmetric row (lambda=1.0): [(s~+d~) x (ns+nt) ; ns+nt] . x = (d~-s~).(ns+nt)
                                                               (ICPOptimizer.h:809-815)
* GICP rows: the three point rows premultiplied by the whitener L^T
  (Segal et al., RSS 2009; an extension with no reference analog).

The GICP whiteners are closed-form 3x3 inverses and Cholesky factors,
elementwise over the matches: no cuSOLVER call, so no host sync.

The point-to-plane and symmetric normal equations are one launch of the
kernel ``csrc/normal_equations.cu`` an iteration on a CUDA tensor
(:func:`normal_equations_cuda`), which reads the match arrays once and
builds each row in registers; on a CPU tensor the plain version builds the
Jacobian columns and sums them (:func:`_accumulate_normal_equations_soa`).
The sums run in the ``icp.reduce`` span of
:mod:`icp_variants_tpu_torch.runtime.spans`.

The point-to-plane, symmetric and GICP solvers' tail -- the 6x6 solve and
the increment's recovery -- is one
launch of ``csrc/pose_step.cu`` an iteration on a CUDA tensor
(:func:`pose_step_cuda`, in float64 inside the kernel); on a CPU tensor
the plain version runs it as PyTorch ops (:func:`_plain_pose_step`).
"""

from __future__ import annotations

import torch

from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.parallel.distributed import psum_many
from icp_variants_tpu_torch.runtime import spans

LAMBDA_POINT = 0.1       # ICPOptimizer.h:737
LAMBDA_PLANE = 1.0       # ICPOptimizer.h:738
LAMBDA_SYMMETRIC = 1.0   # ICPOptimizer.h:840
TIKHONOV_SYMMETRIC = 1e-4  # ICPOptimizer.h:863
GICP_EPSILON = 1e-3      # Segal et al., plane-disk covariance floor


def _point_rows(s: torch.Tensor) -> torch.Tensor:
    """The three small-angle point-to-point rows per match, (..., N, 3, 6):
    row k solves coordinate k of ``Ms + t = d`` with
    M = [[1, -g, b], [g, 1, -a], [-b, a, 1]] (ICPOptimizer.h:717-733)."""
    zeros, ones = torch.zeros_like(s[..., 0]), torch.ones_like(s[..., 0])
    r0 = torch.stack([zeros, s[..., 2], -s[..., 1], ones, zeros, zeros], dim=-1)
    r1 = torch.stack([-s[..., 2], zeros, s[..., 0], zeros, ones, zeros], dim=-1)
    r2 = torch.stack([s[..., 1], -s[..., 0], zeros, zeros, zeros, ones], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def _accumulate_normal_equations(
    rows: torch.Tensor,   # (..., N, R, 6)
    rhs: torch.Tensor,    # (..., N, R)
    row_w: torch.Tensor,  # (..., N, R) mask-and-lambda weights
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``A^T A`` and ``A^T b`` of the weighted rows (each residual weighted
    by ``row_w^2``) as one batched product over the N * R rows; with
    ``group`` (N split over its ranks) summed across them."""
    with spans.span("icp.reduce"):
        wr = (rows * row_w[..., None]).flatten(-3, -2)
        wb = (rhs * row_w).flatten(-2, -1)
        ata, atb = psum_many(
            (wr.transpose(-1, -2) @ wr, (wr.transpose(-1, -2) @ wb[..., None])[..., 0]), group)
    return ata, atb


def _point_row_specs(s: torch.Tensor, d: torch.Tensor, w):
    """The three small-angle point rows of ``Ms + t = d`` with
    M = [[1, -g, b], [g, 1, -a], [-b, a, 1]] as sparse column specs
    ``(cols, rhs, w)``: each column is an (..., N) tensor, a constant or
    None (a structural zero)."""
    return [
        ([None, s[..., 2], -s[..., 1], 1.0, None, None], d[..., 0] - s[..., 0], w),
        ([-s[..., 2], None, s[..., 0], None, 1.0, None], d[..., 1] - s[..., 1], w),
        ([s[..., 1], -s[..., 0], None, None, None, 1.0], d[..., 2] - s[..., 2], w),
    ]


def _accumulate_normal_equations_soa(row_specs, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``ata[i, j] = sum_r sum_n w_r^2 a_i a_j`` and ``atb[i] = sum_r sum_n
    w_r^2 a_i b`` over row specs ``(cols, rhs, w)`` (see
    :func:`_point_row_specs`). Each spec becomes one (..., N, 6) Jacobian
    and one batched product, instead of one reduction per entry. With
    ``group`` (N split over its ranks) the (..., 6, 6) and (..., 6) sums are
    summed across them in one collective."""
    ata = atb = None
    with spans.span("icp.reduce"):
        for cols, rhs, w in row_specs:
            ref = rhs
            J = torch.stack([
                torch.zeros_like(ref) if c is None
                else (torch.full_like(ref, c) if isinstance(c, float) else c)
                for c in cols
            ], dim=-1)
            wJ = (w * w)[..., None] * J
            a = wJ.transpose(-1, -2) @ J
            b = (wJ * rhs[..., None]).sum(dim=-2)
            ata = a if ata is None else ata + a
            atb = b if atb is None else atb + b
        ata, atb = psum_many((ata, atb), group)
    return ata, atb


# Rows of one pair a CTA of csrc/normal_equations.cu sums at most, and its
# threads a CTA (a chunk's rows are a multiple of them).
NE_CHUNK_ROWS = 2048
NE_THREADS = 256
_NE_SUMS = 27          # ata's upper triangle and atb, a chunk's partial sums
# Per device, the kernel's int counter a pair: 0 between launches (the
# kernel sets each back), grown as a batch needs.
_ne_counters: dict[torch.device, torch.Tensor] = {}


def _row_specs(src, tgt, tgt_normals, src_normals, w, center_src, center_tgt):
    """The rows of the linear point-to-plane solve (``src_normals`` None)
    or of the symmetric solve, about the given centres, as
    :func:`_accumulate_normal_equations_soa`'s column specs: the plane or
    symmetric row (ICPOptimizer.h:698-710, 809-815), then the three point
    rows. ``w`` folds in the mask."""
    s = src - center_src[..., None, :]
    d = tgt - center_tgt[..., None, :]
    nt = torch.where(torch.isfinite(tgt_normals), tgt_normals, 0.0)
    finite_n = torch.isfinite(tgt_normals).all(dim=-1)
    if src_normals is None:
        n = nt
        cols = [
            n[..., 2] * s[..., 1] - n[..., 1] * s[..., 2],
            n[..., 0] * s[..., 2] - n[..., 2] * s[..., 0],
            n[..., 1] * s[..., 0] - n[..., 0] * s[..., 1],
            n[..., 0], n[..., 1], n[..., 2],
        ]
        rhs = torch.sum(n * d, dim=-1) - torch.sum(n * s, dim=-1)
        lam = LAMBDA_PLANE
    else:
        ns = torch.where(torch.isfinite(src_normals), src_normals, 0.0)
        finite_n = finite_n & torch.isfinite(src_normals).all(dim=-1)
        n = ns + nt
        sd = s + d
        cols = [
            sd[..., 1] * n[..., 2] - sd[..., 2] * n[..., 1],
            sd[..., 2] * n[..., 0] - sd[..., 0] * n[..., 2],
            sd[..., 0] * n[..., 1] - sd[..., 1] * n[..., 0],
            n[..., 0], n[..., 1], n[..., 2],
        ]
        rhs = torch.sum((d - s) * n, dim=-1)
        lam = LAMBDA_SYMMETRIC
    specs = [(cols, rhs, lam * w * finite_n.to(src.dtype))]
    return specs + _point_row_specs(s, d, LAMBDA_POINT * w)


def normal_equation_chunks(n: int) -> tuple[int, int]:
    """``(rows a chunk, chunks a pair)`` of :func:`normal_equations_cuda`
    for ``n`` rows a pair: as few chunks as hold NE_CHUNK_ROWS rows each,
    their rows evened out to a multiple of NE_THREADS (at least one chunk).
    A function of ``n`` alone, so a pair's sums are taken in the same order
    whatever the batch it is in."""
    chunks = max(1, -(-n // NE_CHUNK_ROWS))
    rows = max(1, -(-n // (chunks * NE_THREADS))) * NE_THREADS
    return rows, max(1, -(-n // rows))


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                   rows: bool = False, kernel: str = "normal_equations") -> None:
    """Raise unless ``t`` has ``dtype`` and ``shape`` and is contiguous
    (with ``rows``: along its last axis only, so the rows of a wider table
    pass)."""
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not (t.stride(-1) == 1 if rows else t.is_contiguous()):
        raise ValueError(f"{kernel}: {name} must be contiguous"
                         + (" along its last axis" if rows else ""))


def _require_cuda(*ts, kernel: str = "normal_equations") -> None:
    """Raise unless every tensor given (None aside) lies on a CUDA device."""
    for t in ts:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{kernel}: expected CUDA tensors, got {t.device}")


def normal_equations_cuda(
    src: torch.Tensor,                  # (B, N, 3) f32
    tgt: torch.Tensor,                  # (B, N, 3) f32
    tgt_normals: torch.Tensor,          # (B, N, 3) f32
    src_normals: torch.Tensor | None,   # (B, N, 3) f32, or None: point-to-plane
    weights: torch.Tensor,              # (B, N) f32
    valid: torch.Tensor,                # (B, N) bool
    center_src: torch.Tensor,           # (B, 3) f32
    center_tgt: torch.Tensor,           # (B, 3) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ata, atb)``, (B, 6, 6) and (B, 6), of :func:`_row_specs`'s rows
    with ``w = weights * valid``, by one launch of
    ``csrc/normal_equations.cu`` on the current stream. The (B, N, 3)
    arrays may be the rows of wider tables (any strides but a contiguous
    last axis); the rest contiguous. Raises before the launch on any other
    dtype, shape, layout or device (the device last)."""
    b, n = src.shape[0], src.shape[1]
    symmetric = src_normals is not None
    for name, t in (("src", src), ("tgt", tgt), ("tgt_normals", tgt_normals),
                    ("src_normals", src_normals)):
        if t is not None:
            _check_operand(name, t, torch.float32, (b, n, 3), rows=True)
    _check_operand("weights", weights, torch.float32, (b, n))
    _check_operand("valid", valid, torch.bool, (b, n))
    _check_operand("center_src", center_src, torch.float32, (b, 3))
    _check_operand("center_tgt", center_tgt, torch.float32, (b, 3))
    _require_cuda(src, tgt, tgt_normals, src_normals, weights, valid, center_src, center_tgt)
    dev = src.device
    rows, chunks = normal_equation_chunks(n)
    counters = _ne_counters.get(dev)
    if counters is None or counters.numel() < b:
        counters = _ne_counters[dev] = torch.zeros(max(b, 256), dtype=torch.int32, device=dev)
    partials = torch.empty((b, chunks, _NE_SUMS), dtype=torch.float32, device=dev)
    ata = torch.empty((b, 6, 6), dtype=torch.float32, device=dev)
    atb = torch.empty((b, 6), dtype=torch.float32, device=dev)
    _cuda.launch(
        "normal_equations", src, tgt, tgt_normals, src_normals, *src.stride()[:2],
        *tgt.stride()[:2], *tgt_normals.stride()[:2],
        *(src_normals.stride()[:2] if symmetric else (0, 0)),
        weights, valid, center_src, center_tgt, partials, counters, ata, atb, b, n, rows,
        LAMBDA_SYMMETRIC if symmetric else LAMBDA_PLANE, LAMBDA_POINT,
        int(symmetric))  # the kernel's NE_PLANE = 0, NE_SYMMETRIC = 1
    return ata, atb


def normal_equations(src, tgt, tgt_normals, src_normals, weights, valid, center_src,
                     center_tgt, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ata, atb)``, (..., 6, 6) and (..., 6): the normal equations of the
    linear point-to-plane solve (``src_normals`` None) or the symmetric
    solve, its rows (:func:`_row_specs`) taken about ``center_src`` and
    ``center_tgt`` (..., 3); with ``group`` (N split over its ranks) summed
    across them. A CPU tensor runs the plain version, the rows as columns
    summed by :func:`_accumulate_normal_equations_soa`; a CUDA tensor the
    kernel, :func:`normal_equations_cuda` (f32)."""
    if src.device.type == "cpu":
        w = weights * valid.to(src.dtype)
        return _accumulate_normal_equations_soa(
            _row_specs(src, tgt, tgt_normals, src_normals, w, center_src, center_tgt), group)
    lead, n = src.shape[:-2], src.shape[-2]

    def rows(t):
        return None if t is None else t.reshape(-1, n, 3)

    with spans.span("icp.reduce"):
        ata, atb = normal_equations_cuda(
            rows(src), rows(tgt), rows(tgt_normals), rows(src_normals),
            weights.reshape(-1, n).contiguous(), valid.reshape(-1, n).contiguous(),
            center_src.reshape(-1, 3).contiguous(), center_tgt.reshape(-1, 3).contiguous())
        ata, atb = psum_many((ata, atb), group)
    return ata.reshape(*lead, 6, 6), atb.reshape(*lead, 6)


def _eye6(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(6, dtype=like.dtype, device=like.device)


def _solve6(ata: torch.Tensor, atb: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(ata, atb[..., None])[0][..., 0]


# The diagonal terms of the solves: point-to-plane and GICP, and the
# symmetric solve's Tikhonov term (ICPOptimizer.h:863).
DIAG_EULER = 1e-12
DIAG_SYMMETRIC = TIKHONOV_SYMMETRIC ** 2


def _plain_pose_step(ata, atb, center_src, center_tgt, symmetric: bool) -> torch.Tensor:
    """:func:`pose_step` as PyTorch ops in the inputs' dtype, on their
    device: ``solve_ex``, then the increment's recovery -- Euler angles
    R = Rx(a) Ry(b) Rz(g) about ``center_tgt`` (ICPOptimizer.h:768-779), or
    the rotation recovered from the symmetric solve's a*tan(theta)
    parametrization, composed as ``T(mu_t) . R . T(t) . R . T(-mu_s)``
    (ICPOptimizer.h:866-898)."""
    if not symmetric:
        x = _solve6(ata + DIAG_EULER * _eye6(ata), atb)
        R = se3.euler_xyz_to_matrix(x[..., 0], x[..., 1], x[..., 2])
        pose_centered = se3.pose_matrix(R, x[..., 3:6])
        return (
            se3.translation_matrix(center_tgt) @ pose_centered
            @ se3.translation_matrix(-center_tgt)
        )
    x = _solve6(ata + DIAG_SYMMETRIC * _eye6(ata), atb)
    a_tilde, t_tilde = x[..., :3], x[..., 3:6]
    tan_theta = torch.linalg.norm(a_tilde, dim=-1)
    big = tan_theta > 1e-12
    safe_tan = torch.where(big, tan_theta, 1.0)
    axis = a_tilde / safe_tan[..., None]
    sin_theta = tan_theta / torch.sqrt(1.0 + tan_theta * tan_theta)
    cos_theta = torch.where(big, sin_theta / safe_tan, 1.0)
    t = t_tilde * cos_theta[..., None]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    R = torch.where(big[..., None, None], se3.rodrigues_matrix(axis, sin_theta, cos_theta), eye)
    rod = se3.pose_matrix(R, torch.zeros_like(t))
    return (
        se3.translation_matrix(center_tgt) @ rod @ se3.translation_matrix(t) @ rod
        @ se3.translation_matrix(-center_src)
    )


def pose_step_cuda(
    ata: torch.Tensor,                  # (B, 6, 6) f32
    atb: torch.Tensor,                  # (B, 6) f32
    center_src: torch.Tensor,           # (B, 3) f32
    center_tgt: torch.Tensor,           # (B, 3) f32
    symmetric: bool,
    solution: torch.Tensor | None = None,  # (B, 6) f64 out, or None
) -> torch.Tensor:
    """The (B, 4, 4) f32 increment of :func:`_plain_pose_step` by one launch
    of ``csrc/pose_step.cu`` on the current stream, computed in float64 and
    rounded once. ``solution``, a test hook, receives the 6-vector solve
    (the rounded increment cannot show how well an ill-conditioned system
    was solved). Every operand contiguous. Raises before the launch on any
    other dtype, shape, layout or device (the device last)."""
    b = ata.shape[0]
    what = "pose_step"
    _check_operand("ata", ata, torch.float32, (b, 6, 6), kernel=what)
    _check_operand("atb", atb, torch.float32, (b, 6), kernel=what)
    _check_operand("center_src", center_src, torch.float32, (b, 3), kernel=what)
    _check_operand("center_tgt", center_tgt, torch.float32, (b, 3), kernel=what)
    if solution is not None:
        _check_operand("solution", solution, torch.float64, (b, 6), kernel=what)
    _require_cuda(ata, atb, center_src, center_tgt, solution, kernel=what)
    increment = torch.empty((b, 4, 4), dtype=torch.float32, device=ata.device)
    _cuda.launch(
        "pose_step", ata, atb, center_src, center_tgt, increment, solution, b,
        DIAG_SYMMETRIC if symmetric else DIAG_EULER,
        int(symmetric))  # the kernel's PS_EULER = 0, PS_SYMMETRIC = 1
    return increment


def pose_step(ata, atb, center_src, center_tgt, symmetric: bool) -> torch.Tensor:
    """The increment of one linear step: ``x`` solving ``(ata + diag I) x =
    atb`` (diag :data:`DIAG_SYMMETRIC` or :data:`DIAG_EULER`), and the
    increment recovered from it -- the symmetric solve's about the means
    ``center_src`` and ``center_tgt``, else Euler angles about
    ``center_tgt``. (..., 6, 6), (..., 6), (..., 3) -> (..., 4, 4). A CPU
    tensor runs the plain version, :func:`_plain_pose_step`; a CUDA tensor
    the kernel, :func:`pose_step_cuda` (f32)."""
    if ata.device.type == "cpu":
        return _plain_pose_step(ata, atb, center_src, center_tgt, symmetric)
    increment = pose_step_cuda(
        ata.reshape(-1, 6, 6).contiguous(), atb.reshape(-1, 6).contiguous(),
        center_src.reshape(-1, 3).contiguous(), center_tgt.reshape(-1, 3).contiguous(),
        symmetric)
    return increment.reshape(*ata.shape[:-2], 4, 4)


def estimate_pose_point_to_plane(
    src: torch.Tensor,          # (..., N, 3) matched transformed source points
    tgt: torch.Tensor,          # (..., N, 3) matched target points
    tgt_normals: torch.Tensor,  # (..., N, 3)
    weights: torch.Tensor,      # (..., N)
    valid: torch.Tensor,        # (..., N) bool
    group=None,
) -> torch.Tensor:
    """Linearized point-to-plane solve, centred at the matched-target mean
    (an exact reparametrization); returns the (..., 4, 4) increment. Pose
    from Euler angles R = Rx(a) Ry(b) Rz(g) (ICPOptimizer.h:768-779)."""
    center = se3.masked_mean(tgt, valid, group=group)
    ata, atb = normal_equations(src, tgt, tgt_normals, None, weights, valid, center, center,
                                group)
    return pose_step(ata, atb, center, center, symmetric=False)


def estimate_pose_symmetric(
    src: torch.Tensor,          # (..., N, 3) matched transformed source points
    tgt: torch.Tensor,          # (..., N, 3) matched target points
    src_normals: torch.Tensor,  # (..., N, 3) transformed source normals
    tgt_normals: torch.Tensor,  # (..., N, 3)
    weights: torch.Tensor,      # (..., N)
    valid: torch.Tensor,        # (..., N) bool
    group=None,
) -> torch.Tensor:
    """Symmetric ICP (Rusinkiewicz 2019) linear solve,
    ICPOptimizer.h:784-898: centre both clouds at their matched means,
    solve with Tikhonov 1e-4, recover the rotation from the
    a*tan(theta) parametrization and compose
    ``T(mu_t) . R . T(t) . R . T(-mu_s)``."""
    mean_src = se3.masked_mean(src, valid, group=group)
    mean_tgt = se3.masked_mean(tgt, valid, group=group)
    ata, atb = normal_equations(src, tgt, tgt_normals, src_normals, weights, valid, mean_src,
                                mean_tgt, group)
    return pose_step(ata, atb, mean_src, mean_tgt, symmetric=True)


def _cholesky3(m: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric positive-definite (..., 3, 3)
    matrices, entry by entry (NaN where not positive definite, as LAPACK's
    factor is)."""
    l00 = torch.sqrt(m[..., 0, 0])
    l10 = m[..., 1, 0] / l00
    l20 = m[..., 2, 0] / l00
    l11 = torch.sqrt(m[..., 1, 1] - l10 * l10)
    l21 = (m[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(m[..., 2, 2] - l20 * l20 - l21 * l21)
    zero = torch.zeros_like(l00)
    return torch.stack([
        torch.stack([l00, zero, zero], dim=-1),
        torch.stack([l10, l11, zero], dim=-1),
        torch.stack([l20, l21, l22], dim=-1),
    ], dim=-2)


def gicp_whitener(
    src_normals: torch.Tensor,  # (..., N, 3) transformed source normals
    tgt_normals: torch.Tensor,  # (..., N, 3)
    eps: float = GICP_EPSILON,
) -> torch.Tensor:
    """Per-match GICP whitening matrices L, (..., N, 3, 3) lower-triangular.

    Each point is a plane-aligned Gaussian with covariance
    ``C = I - (1 - eps) n n^T``; the source normals are the transformed
    ones, so ``C_s' = R C_s R^T`` directly. L is the Cholesky factor of
    ``M = (C_t + C_s')^{-1}``, so the whitened residual ``L^T d`` turns the
    Mahalanobis objective into least squares. Non-finite normals become
    zero: an isotropic covariance, point-to-point for that match."""
    ns = torch.where(torch.isfinite(src_normals), src_normals, 0.0)
    nt = torch.where(torch.isfinite(tgt_normals), tgt_normals, 0.0)
    eye = torch.eye(3, dtype=src_normals.dtype, device=src_normals.device)
    c = (2.0 * eye
         - (1.0 - eps) * (ns[..., :, None] * ns[..., None, :])
         - (1.0 - eps) * (nt[..., :, None] * nt[..., None, :]))
    m = se3._inv3(c)
    m = 0.5 * (m + m.transpose(-1, -2))  # symmetrize against the inverse's rounding
    return _cholesky3(m)


def estimate_pose_gicp(
    src: torch.Tensor,          # (..., N, 3) matched transformed source points
    tgt: torch.Tensor,          # (..., N, 3) matched target points
    src_normals: torch.Tensor,  # (..., N, 3) transformed source normals
    tgt_normals: torch.Tensor,  # (..., N, 3)
    weights: torch.Tensor,      # (..., N)
    valid: torch.Tensor,        # (..., N) bool
    group=None,
) -> torch.Tensor:
    """Linearized Generalized-ICP solve; returns the (..., 4, 4) increment.

    One Gauss-Newton step on the whitened small-angle system: each match's
    three point rows of ``Ms + t = d`` premultiplied by ``L^T``, centred at
    the matched-target mean (an exact reparametrization), Euler-angle pose
    recovery as the point-to-plane solve."""
    w = weights * valid.to(src.dtype)
    center = se3.masked_mean(tgt, valid, group=group)
    s = src - center[..., None, :]
    d = tgt - center[..., None, :]
    Lt = gicp_whitener(src_normals, tgt_normals).transpose(-1, -2)
    rows = Lt @ _point_rows(s)                                   # (..., N, 3, 6)
    rhs = (Lt @ (d - s)[..., None])[..., 0]                      # (..., N, 3)
    ata, atb = _accumulate_normal_equations(rows, rhs, w[..., None].expand_as(rhs), group)
    return pose_step(ata, atb, center, center, symmetric=False)
