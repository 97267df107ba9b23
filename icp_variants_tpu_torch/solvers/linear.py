"""Linear (small-angle) point-to-plane and symmetric-ICP solvers.

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
"""

from __future__ import annotations

import torch

from icp_variants_tpu_torch.core import se3

LAMBDA_POINT = 0.1       # ICPOptimizer.h:737
LAMBDA_PLANE = 1.0       # ICPOptimizer.h:738
LAMBDA_SYMMETRIC = 1.0   # ICPOptimizer.h:840
TIKHONOV_SYMMETRIC = 1e-4  # ICPOptimizer.h:863


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


def _accumulate_normal_equations_soa(row_specs) -> tuple[torch.Tensor, torch.Tensor]:
    """``ata[i, j] = sum_r sum_n w_r^2 a_i a_j`` and ``atb[i] = sum_r sum_n
    w_r^2 a_i b`` over row specs ``(cols, rhs, w)`` (see
    :func:`_point_row_specs`). Each spec becomes one (..., N, 6) Jacobian
    and one batched product, instead of one reduction per entry."""
    ata = atb = None
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
    return ata, atb


def _eye6(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(6, dtype=like.dtype, device=like.device)


def _solve6(ata: torch.Tensor, atb: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(ata, atb[..., None])[0][..., 0]


def estimate_pose_point_to_plane(
    src: torch.Tensor,          # (..., N, 3) matched transformed source points
    tgt: torch.Tensor,          # (..., N, 3) matched target points
    tgt_normals: torch.Tensor,  # (..., N, 3)
    weights: torch.Tensor,      # (..., N)
    valid: torch.Tensor,        # (..., N) bool
) -> torch.Tensor:
    """Linearized point-to-plane solve, centred at the matched-target mean
    (an exact reparametrization); returns the (..., 4, 4) increment. Pose
    from Euler angles R = Rx(a) Ry(b) Rz(g) (ICPOptimizer.h:768-779)."""
    w = weights * valid.to(src.dtype)
    center = se3.masked_mean(tgt, valid)
    s = src - center[..., None, :]
    d = tgt - center[..., None, :]
    n = torch.where(torch.isfinite(tgt_normals), tgt_normals, 0.0)
    finite_n = torch.isfinite(tgt_normals).all(dim=-1).to(src.dtype)
    plane_cols = [
        n[..., 2] * s[..., 1] - n[..., 1] * s[..., 2],
        n[..., 0] * s[..., 2] - n[..., 2] * s[..., 0],
        n[..., 1] * s[..., 0] - n[..., 0] * s[..., 1],
        n[..., 0], n[..., 1], n[..., 2],
    ]
    plane_rhs = torch.sum(n * d, dim=-1) - torch.sum(n * s, dim=-1)
    specs = [(plane_cols, plane_rhs, LAMBDA_PLANE * w * finite_n)]
    specs += _point_row_specs(s, d, LAMBDA_POINT * w)
    ata, atb = _accumulate_normal_equations_soa(specs)
    x = _solve6(ata + 1e-12 * _eye6(ata), atb)
    R = se3.euler_xyz_to_matrix(x[..., 0], x[..., 1], x[..., 2])
    pose_centered = se3.pose_matrix(R, x[..., 3:6])
    return (
        se3.translation_matrix(center) @ pose_centered @ se3.translation_matrix(-center)
    )


def estimate_pose_symmetric(
    src: torch.Tensor,          # (..., N, 3) matched transformed source points
    tgt: torch.Tensor,          # (..., N, 3) matched target points
    src_normals: torch.Tensor,  # (..., N, 3) transformed source normals
    tgt_normals: torch.Tensor,  # (..., N, 3)
    weights: torch.Tensor,      # (..., N)
    valid: torch.Tensor,        # (..., N) bool
) -> torch.Tensor:
    """Symmetric ICP (Rusinkiewicz 2019) linear solve,
    ICPOptimizer.h:784-898: centre both clouds at their matched means,
    solve with Tikhonov 1e-4, recover the rotation from the
    a*tan(theta) parametrization and compose
    ``T(mu_t) . R . T(t) . R . T(-mu_s)``."""
    w = weights * valid.to(src.dtype)
    mean_src = se3.masked_mean(src, valid)
    mean_tgt = se3.masked_mean(tgt, valid)
    s = src - mean_src[..., None, :]
    d = tgt - mean_tgt[..., None, :]
    ns = torch.where(torch.isfinite(src_normals), src_normals, 0.0)
    nt = torch.where(torch.isfinite(tgt_normals), tgt_normals, 0.0)
    finite_n = (
        torch.isfinite(src_normals).all(dim=-1) & torch.isfinite(tgt_normals).all(dim=-1)
    ).to(src.dtype)
    n_sum = ns + nt
    sd = s + d
    sym_cols = [
        sd[..., 1] * n_sum[..., 2] - sd[..., 2] * n_sum[..., 1],
        sd[..., 2] * n_sum[..., 0] - sd[..., 0] * n_sum[..., 2],
        sd[..., 0] * n_sum[..., 1] - sd[..., 1] * n_sum[..., 0],
        n_sum[..., 0], n_sum[..., 1], n_sum[..., 2],
    ]
    sym_rhs = torch.sum((d - s) * n_sum, dim=-1)
    specs = [(sym_cols, sym_rhs, LAMBDA_SYMMETRIC * w * finite_n)]
    specs += _point_row_specs(s, d, LAMBDA_POINT * w)
    ata, atb = _accumulate_normal_equations_soa(specs)
    x = _solve6(ata + (TIKHONOV_SYMMETRIC ** 2) * _eye6(ata), atb)

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
        se3.translation_matrix(mean_tgt) @ rod @ se3.translation_matrix(t) @ rod
        @ se3.translation_matrix(-mean_src)
    )
