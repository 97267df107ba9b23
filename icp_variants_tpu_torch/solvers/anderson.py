"""Anderson-accelerated ICP (AA-ICP), an extension beyond the reference.

PyTorch port of ``icp_variants_tpu.solvers.anderson``. ICP is a fixed-point
iteration ``pose_{k+1} = G(pose_k)``; Anderson acceleration (type II,
window m) extrapolates the next iterate from the last m residuals
``f_k = g_k - x_k`` in a 6-dof pose chart (Pavlov et al., "AA-ICP",
arXiv:1709.05479). Two safeguards keep it near the plain iteration where
the match set changes discontinuously:

1. growth restart: when the residual norm grows, drop the history and
   take the plain step;
2. decaying trust clamp: every correction is capped at
   ``CLAMP * DECAY**restarts`` times the current residual norm.

The state carries a leading pair axis B (the JAX package vmaps its driver
over pairs): every restart, count and clamp is per pair, and one pair's
restart leaves the others' history alone. The buffers have fixed shapes
(rings of m + 1 entries) and the (m, m) mixing solve is ``solve_ex``, so a
step never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_variants_tpu_torch.core import se3

# Trust-region scale on AA corrections, halved on every growth restart (the
# JAX package's constants).
CLAMP = 5.0
DECAY = 0.5


def pose_to_vec(pose: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose -> (..., 6) chart (axis-angle, translation); a
    bijective chart for rotation angles below pi."""
    return torch.cat([se3.matrix_to_axis_angle(pose[..., :3, :3]), pose[..., :3, 3]], dim=-1)


def vec_to_pose(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pose_to_vec`."""
    return se3.pose_matrix(se3.axis_angle_to_matrix(x[..., :3]), x[..., 3:])


class AAState(NamedTuple):
    """Ring buffers of the last ``m + 1`` (iterate, residual) pairs, per
    pair. ``count`` is the number of valid entries from the newest
    backwards, ``prev_norm`` the previous squared residual norm (the
    restart test), ``restarts`` the growth restarts so far (they decay the
    clamp)."""

    xs: torch.Tensor         # (..., m + 1, 6)
    fs: torch.Tensor         # (..., m + 1, 6)
    count: torch.Tensor      # (...,) int32
    prev_norm: torch.Tensor  # (...,) f32, +inf at the start
    restarts: torch.Tensor   # (...,) int32


def init(m: int, batch: tuple[int, ...] = (), dtype=torch.float32, device=None) -> AAState:
    """A fresh state for ``batch`` pairs on ``device`` (``None`` = the
    default device of new tensors; callers pass their pose's device)."""
    return AAState(
        xs=torch.zeros((*batch, m + 1, 6), dtype=dtype, device=device),
        fs=torch.zeros((*batch, m + 1, 6), dtype=dtype, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
        prev_norm=torch.full(batch, float("inf"), dtype=torch.float32, device=device),
        restarts=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def init_like(m: int, pose: torch.Tensor) -> AAState:
    """:func:`init` for the pairs of ``pose`` (..., 4, 4), on its device."""
    return init(m, tuple(pose.shape[:-2]), device=pose.device)


def step(state: AAState, x_k: torch.Tensor, g_k: torch.Tensor, m: int
         ) -> tuple[AAState, torch.Tensor]:
    """One AA(m) mixing step per pair: given the current iterates ``x_k``
    (..., 6) and the plain fixed-point updates ``g_k = G(x_k)``, return the
    new state and the accelerated next iterates. A pair with no usable
    history (or right after a restart) takes exactly its plain step."""
    f_k = g_k - x_k
    norm = torch.sum(f_k * f_k, dim=-1)

    # Growth restart: the residual grew, so the last extrapolation was bad
    # (or G changed): drop the history, halve the trust clamp from now on.
    grew = norm > state.prev_norm
    restarts = state.restarts + grew.to(torch.int32)
    count = torch.where(grew, torch.zeros_like(state.count), state.count)

    xs = torch.cat([state.xs[..., 1:, :], x_k[..., None, :]], dim=-2)
    fs = torch.cat([state.fs[..., 1:, :], f_k[..., None, :]], dim=-2)
    count = torch.clamp(count + 1, max=m + 1)

    # Differences over the ring's tail: column j pairs entries j and j + 1;
    # only the newest count - 1 columns are valid. Invalid columns are
    # zeroed, and with the ridge their mixing weights solve to exactly 0.
    dF = (fs[..., 1:, :] - fs[..., :-1, :]).transpose(-1, -2)                    # (..., 6, m)
    dG = ((xs[..., 1:, :] + fs[..., 1:, :])
          - (xs[..., :-1, :] + fs[..., :-1, :])).transpose(-1, -2)               # (..., 6, m)
    col = torch.arange(m, device=x_k.device)
    valid = (col >= (m - (count[..., None] - 1)))[..., None, :]
    dF = torch.where(valid, dF, 0.0)
    dG = torch.where(valid, dG, 0.0)

    A = dF.transpose(-1, -2) @ dF
    ridge = 1e-10 * (torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) + 1.0)
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    gamma = torch.linalg.solve_ex(A + ridge[..., None, None] * eye,
                                  dF.transpose(-1, -2) @ f_k[..., None])[0]
    x_aa = g_k - (dG @ gamma)[..., 0]

    # Decaying trust clamp: the correction may leave the plain step by at
    # most CLAMP * DECAY**restarts residual norms.
    delta = x_aa - g_k
    delta_norm = torch.sqrt(torch.sum(delta * delta, dim=-1)) + 1e-30
    trust = CLAMP * torch.pow(DECAY, restarts.to(torch.float32))
    scale = torch.clamp(trust * torch.sqrt(norm) / delta_norm, max=1.0)
    x_aa = g_k + scale[..., None] * delta

    x_next = torch.where((count > 1)[..., None], x_aa, g_k)
    return AAState(xs=xs, fs=fs, count=count, prev_norm=norm, restarts=restarts), x_next
