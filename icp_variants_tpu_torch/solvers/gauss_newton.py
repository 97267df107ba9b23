"""Levenberg-Marquardt non-linear ICP inner solver.

PyTorch port of ``icp_variants_tpu.solvers.gauss_newton`` (the Ceres path
of the reference, CeresICPOptimizer, ICPOptimizer.h:181-483): per ICP
iteration, with the correspondences held fixed, at most ``max_iterations``
LM steps (LEVENBERG_MARQUARDT, ICPOptimizer.h:352-360) on the residual
stack over a 6-dof axis-angle + translation increment (constraints.h).

The residual stack is a function of one pair's 6-vector increment; its
Jacobian comes from ``torch.func.jacfwd`` (six forward-mode passes, the
counterpart of ``jax.jacfwd`` and of Ceres' Jets) under ``torch.func.vmap``
over the explicit pair axis B. ``J^T J`` and ``J^T r`` are batched
products, the damped 6x6 systems solve through ``torch.linalg.solve_ex``
(singular systems show in its ``info``, no host sync), and accept / reject
and the converged freeze are ``torch.where`` selects, so the loop never
waits for the device.

Residual blocks mirror prepareConstraints*:
* POINT_TO_POINT: 3 rows per match, lambda 0.1      (constraints.h:29-31, 46)
* POINT_TO_PLANE: the same 3 point rows plus 1 plane row, lambda 1.0
                                                    (ICPOptimizer.h:412-431)
* SYMMETRIC:      the point rows plus 1 symmetric row, lambda 1.0, the
                  target rotated by the inverse increment rotation
                                                    (constraints.h:95-143)
* GICP:           3 whitened rows per match, ``L^T (moved - tgt)``, with the
                  whitener ``linear.gicp_whitener`` fixed for the ICP
                  iteration (standard GICP IRLS; an extension)
Every row is scaled by the match weight; invalid rows are masked to zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.parallel.distributed import psum, psum_many
from icp_variants_tpu_torch.pipeline.config import Metric
from icp_variants_tpu_torch.solvers import linear

LAMBDA_POINT = 0.1      # constraints.h:46
LAMBDA_PLANE = 1.0      # constraints.h:91
LAMBDA_SYMMETRIC = 1.0  # constraints.h:142


class _Residuals(NamedTuple):
    """One pair's fixed data of the residual stack."""

    src: torch.Tensor          # (N, 3)
    tgt: torch.Tensor          # (N, 3)
    src_normals: torch.Tensor  # (N, 3) zeros where not finite
    tgt_normals: torch.Tensor  # (N, 3) zeros where not finite
    w_point: torch.Tensor      # (N,) weight incl. mask, point rows
    w_metric: torch.Tensor     # (N,) weight incl. mask and finite-normal mask
    gicp_l: torch.Tensor       # (N, 3, 3) GICP whiteners; (0, 3, 3) for other metrics


def _residual_fn(metric: Metric):
    """The residual stack ``r(x, data)`` (M,) of one pair for ``metric``."""

    def residuals(x: torch.Tensor, d: _Residuals) -> torch.Tensor:
        moved = se3.apply_increment(x, d.src)
        diff = moved - d.tgt
        if metric == Metric.GICP:
            # The pure Mahalanobis objective: no extra point rows (the
            # isotropic floor lives in the whitener's epsilon).
            white = (d.gicp_l.transpose(-1, -2) @ diff[..., None])[..., 0]
            return (d.w_metric[:, None] * white).reshape(-1)
        parts = [((LAMBDA_POINT * d.w_point)[:, None] * diff).reshape(-1)]
        if metric == Metric.POINT_TO_PLANE:
            parts.append(LAMBDA_PLANE * d.w_metric * torch.sum(d.tgt_normals * diff, dim=-1))
        elif metric == Metric.SYMMETRIC:
            tgt_rot = se3.apply_increment_inv_rotation(x, d.tgt)
            n_sum = d.src_normals + d.tgt_normals
            parts.append(LAMBDA_SYMMETRIC * d.w_metric
                         * torch.sum(n_sum * (moved - tgt_rot), dim=-1))
        return torch.cat(parts)

    return residuals


class LMResult(NamedTuple):
    increment: torch.Tensor     # (B, 6) solved pose increments
    cost: torch.Tensor          # (B,) final 0.5*|r|^2
    initial_cost: torch.Tensor  # (B,)
    n_accepted: torch.Tensor    # (B,) int32


def solve_lm(
    metric: Metric,
    src: torch.Tensor,
    tgt: torch.Tensor,
    src_normals: torch.Tensor,
    tgt_normals: torch.Tensor,
    weights: torch.Tensor,
    valid: torch.Tensor,
    *,
    max_iterations: int = 10,
    function_tolerance: float = 1e-6,
    group=None,
) -> LMResult:
    """At most ``max_iterations`` LM steps per pair; every input carries the
    pair axis B: (B, N, 3) points and normals, (B, N) weights and mask.

    Marquardt-Nielsen damping: solve ``(J^T J + mu diag(J^T J)) dx =
    -J^T r``; on a cost decrease accept and shrink mu, else reject and grow
    it. Once an accepted step's relative cost decrease falls below
    ``function_tolerance`` (Ceres' option) the pair's state freezes.

    With ``group`` the N axis is split over its ranks: each cost and each
    step's ``J^T J`` / ``J^T r`` are summed across them (after the
    ``torch.func`` transforms return: a collective cannot run inside
    them), so every rank solves the same damped system and takes the same
    accept / reject branch."""
    res_fn = _residual_fn(metric)
    mask = valid.to(src.dtype)
    finite_sn = torch.isfinite(src_normals).all(dim=-1)
    finite_tn = torch.isfinite(tgt_normals).all(dim=-1)
    if metric == Metric.SYMMETRIC:
        finite_metric = (finite_sn & finite_tn).to(src.dtype)
    elif metric == Metric.GICP:
        # Non-finite normals already become isotropic in the whitener.
        finite_metric = torch.ones_like(mask)
    else:
        finite_metric = finite_tn.to(src.dtype)
    gicp_l = (linear.gicp_whitener(src_normals, tgt_normals) if metric == Metric.GICP
              else src.new_zeros((src.shape[0], 0, 3, 3)))
    data = _Residuals(
        src=src,
        tgt=tgt,
        src_normals=torch.where(finite_sn[..., None], src_normals, 0.0),
        tgt_normals=torch.where(finite_tn[..., None], tgt_normals, 0.0),
        w_point=weights * mask,
        w_metric=weights * mask * finite_metric,
        gicp_l=gicp_l,
    )
    residuals = torch.func.vmap(res_fn)
    jacobian = torch.func.vmap(torch.func.jacfwd(res_fn))

    def cost_of(x):
        r = residuals(x, data)
        return psum(0.5 * torch.sum(r * r, dim=-1), group)

    b = src.shape[0]
    x = torch.zeros((b, 6), dtype=src.dtype, device=src.device)
    c0 = cost_of(x)
    cost = c0
    mu = torch.full_like(c0, 1e-4)
    nu = torch.full_like(c0, 2.0)
    done = torch.zeros_like(c0, dtype=torch.bool)
    n_acc = torch.zeros_like(c0, dtype=torch.int32)
    for _ in range(max_iterations):
        J = jacobian(x, data)                                  # (B, M, 6)
        r = residuals(x, data)                                 # (B, M)
        jtj, g = psum_many((J.transpose(-1, -2) @ J,
                            (J.transpose(-1, -2) @ r[..., None])[..., 0]), group)
        diag = torch.diag_embed(torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-12))
        dx = -torch.linalg.solve_ex(jtj + mu[:, None, None] * diag, g[..., None])[0][..., 0]

        new_cost = cost_of(x + dx)
        pred_red = -(torch.sum(g * dx, dim=-1)
                     + 0.5 * torch.sum(dx * (jtj @ dx[..., None])[..., 0], dim=-1))
        rho = (cost - new_cost) / torch.clamp(pred_red, min=1e-30)

        accept = (new_cost < cost) & ~done
        x_next = torch.where(accept[:, None], x + dx, x)
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        mu_next = torch.where(accept, mu * factor, mu * nu)
        nu_next = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        cost_next = torch.where(accept, new_cost, cost)

        rel_decrease = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        done_next = done | (accept & (rel_decrease < function_tolerance))
        mu = torch.where(done, mu, mu_next)
        nu = torch.where(done, nu, nu_next)
        x, cost, done = x_next, cost_next, done_next
        n_acc = n_acc + accept.to(torch.int32)
    return LMResult(increment=x, cost=cost, initial_cost=c0, n_accepted=n_acc)


def estimate_pose_lm(metric: Metric, *args, **kwargs) -> torch.Tensor:
    """(B, 4, 4) incremental poses: ``PoseIncrement::
    convertToMatrix`` of the LM solution (ICPOptimizer.h:308-309)."""
    return se3.increment_to_matrix(solve_lm(metric, *args, **kwargs).increment)
