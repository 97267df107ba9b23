"""SE(3) primitives: axis-angle poses, rotations, rigid transforms.

PyTorch port of ``icp_variants_tpu.core.se3`` (the reference's pose
machinery, ``utils.h:26-176``). Every function broadcasts over leading
batch dimensions: a pose is ``(..., 4, 4)``, a point set ``(..., N, 3)``,
so the batched ICP driver passes its pair axis straight through.

Transforms are written as explicit per-coordinate products and sums, not
as a matrix product: the coordinates feed nearest-neighbour matching, so
they must stay in full f32 whatever the matmul precision settings (the
analogue of the JAX package's ``precision=HIGHEST``).
"""

from __future__ import annotations

import torch

from icp_variants_tpu_torch.parallel.distributed import psum_many

_SMALL_ANGLE = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def rotate_axis_angle(w: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate ``points`` (..., N, 3) by the axis-angle vector ``w`` (..., 3)
    (Rodrigues, as Ceres' ``AngleAxisRotatePoint``); first-order
    ``p + w x p`` near theta = 0."""
    w = w.unsqueeze(-2)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    big = theta2 > _SMALL_ANGLE
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    axis = w / theta
    rotated = (
        points * torch.cos(theta)
        + _cross(axis, points) * torch.sin(theta)
        + axis * torch.sum(points * axis, dim=-1, keepdim=True)
        * (1.0 - torch.cos(theta))
    )
    small = points + _cross(w, points)
    return torch.where(big, rotated, small)


def apply_increment(x: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 6-vector increment ``[w, t]`` (``PoseIncrement::apply``)."""
    return rotate_axis_angle(x[..., :3], points) + x[..., None, 3:6]


def apply_increment_inv_rotation(x: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate by the inverse rotation of the increment, no translation."""
    return rotate_axis_angle(-x[..., :3], points)


def cross_matrix(k: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric [k]_x, (..., 3) -> (..., 3, 3)."""
    zero = torch.zeros_like(k[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -k[..., 2], k[..., 1]], dim=-1),
            torch.stack([k[..., 2], zero, -k[..., 0]], dim=-1),
            torch.stack([-k[..., 1], k[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def axis_angle_to_matrix(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    big = theta2 > _SMALL_ANGLE
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    K = cross_matrix(w / theta[..., 0])
    eye = _eye3(w)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(big, R, eye + cross_matrix(w))


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), w >= 0
    (branchless Shepperd: the candidate seeded by the largest diagonal
    combination)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]

    def cand(seed, a, b, c, d):
        s = 2.0 * torch.sqrt(torch.clamp(seed, min=1e-12))
        return torch.stack([a / s * 2.0, b / s * 2.0, c / s * 2.0, d / s * 2.0], -1) * 0.5

    s0 = 1.0 + tr
    s1 = 1.0 + m[0][0] - m[1][1] - m[2][2]
    s2 = 1.0 - m[0][0] + m[1][1] - m[2][2]
    s3 = 1.0 - m[0][0] - m[1][1] + m[2][2]
    qs = torch.stack([
        cand(s0, s0, m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]),
        cand(s1, m[2][1] - m[1][2], s1, m[0][1] + m[1][0], m[0][2] + m[2][0]),
        cand(s2, m[0][2] - m[2][0], m[0][1] + m[1][0], s2, m[1][2] + m[2][1]),
        cand(s3, m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1], s3),
    ], dim=-2)                                         # (..., 4, 4)
    best = torch.argmax(torch.stack([s0, s1, s2, s3], -1), dim=-1)
    q = torch.gather(qs, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), through a
    quaternion so it stays accurate near theta = pi."""
    q = matrix_to_quaternion(R)
    w_, xyz = q[..., :1], q[..., 1:]
    norm_xyz = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(norm_xyz, w_)
    ok = norm_xyz > 1e-12
    axis = xyz / torch.where(ok, norm_xyz, torch.ones_like(norm_xyz))
    return torch.where(ok, axis * theta, xyz * 2.0)


def pose_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def increment_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """6-vector increment -> 4x4 transform (``PoseIncrement::convertToMatrix``)."""
    return pose_matrix(axis_angle_to_matrix(x[..., :3]), x[..., 3:6])


def translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pure translation (``gettranslationMatrix``)."""
    eye = _eye3(t).expand(*t.shape[:-1], 3, 3)
    return pose_matrix(eye, t)


def rodrigues_matrix(axis: torch.Tensor, sin_theta: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    """R = I + sin(theta) K + (1 - cos(theta)) K^2 (``getRodriguesMatrix``)."""
    K = cross_matrix(axis)
    s = torch.as_tensor(sin_theta, dtype=axis.dtype, device=axis.device)[..., None, None]
    c = torch.as_tensor(cos_theta, dtype=axis.dtype, device=axis.device)[..., None, None]
    return _eye3(axis) + s * K + (1.0 - c) * (K @ K)


def euler_xyz_to_matrix(alpha: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """R = Rx(alpha) Ry(beta) Rz(gamma) (ICPOptimizer.h:771-773)."""
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    one, zero = torch.ones_like(ca), torch.zeros_like(ca)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    Rx = mat([[one, zero, zero], [zero, ca, -sa], [zero, sa, ca]])
    Ry = mat([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    Rz = mat([[cg, -sg, zero], [sg, cg, zero], [zero, zero, one]])
    return Rx @ Ry @ Rz


def matrix_to_euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """(alpha, beta, gamma) with R = Rx(a) Ry(b) Rz(g), Eigen's
    ``eulerAngles(0, 1, 2)`` convention (first angle kept in [0, pi])."""
    beta = torch.atan2(R[..., 0, 2], torch.sqrt(R[..., 0, 0] ** 2 + R[..., 0, 1] ** 2))
    alpha = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    gamma = torch.atan2(-R[..., 0, 1], R[..., 0, 0])

    def wrap(a):
        return torch.atan2(torch.sin(a), torch.cos(a))

    flipped = torch.stack([alpha + torch.pi, wrap(torch.pi - beta), wrap(gamma + torch.pi)], -1)
    return torch.where((alpha < 0)[..., None], flipped, torch.stack([alpha, beta, gamma], -1))


def _apply_linear(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``v @ M.T`` for v (..., N, 3), M (..., 3, 3) as explicit f32
    products and sums (rows summed in column order)."""
    cols = []
    for r in range(3):
        acc = v[..., 0] * M[..., r, 0, None]
        acc = acc + v[..., 1] * M[..., r, 1, None]
        acc = acc + v[..., 2] * M[..., r, 2, None]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Rigid transform R p + t of (..., N, 3) by (..., 4, 4)
    (``transformPoints``, utils.h:106-118)."""
    return _apply_linear(points, pose[..., :3, :3]) + pose[..., None, :3, 3]


def _inv3(R: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det)."""
    c0 = torch.linalg.cross(R[..., :, 1], R[..., :, 2], dim=-1)
    c1 = torch.linalg.cross(R[..., :, 2], R[..., :, 0], dim=-1)
    c2 = torch.linalg.cross(R[..., :, 0], R[..., :, 1], dim=-1)
    det = torch.sum(R[..., :, 0] * c0, dim=-1)
    return torch.stack([c0, c1, c2], dim=-2) / det[..., None, None]


def transform_normals(normals: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Normals by R^-T (``transformNormals``, utils.h:122-133):
    ``n^T R^-1`` row-wise."""
    return _apply_linear(normals, _inv3(pose[..., :3, :3]).transpose(-1, -2))


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid (..., 4, 4) transform."""
    Rinv = pose[..., :3, :3].transpose(-1, -2)
    return pose_matrix(Rinv, -_apply_linear(pose[..., None, :3, 3], Rinv)[..., 0, :])


def masked_mean(
    points: torch.Tensor, mask: torch.Tensor, weights: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """Mean of masked (optionally weighted) points over axis -2
    (``computeMean``, utils.h:136-145). With ``group`` the points axis is
    split over its ranks: numerator and denominator are summed across them."""
    w = mask.to(points.dtype)
    if weights is not None:
        w = w * weights
    num = torch.sum(points * w[..., None], dim=-2)
    den = torch.sum(w, dim=-1, keepdim=True)
    num, den = psum_many((num, den), group)
    return num / torch.clamp(den, min=1e-12)
