"""Pose-graph refinement over a scan sequence.

Port of ``icp_variants_tpu.parallel.pose_graph``: the pairwise ICP results
become edges of a pose graph over absolute scan poses, jointly refined by
Gauss-Newton. :func:`refine_sharded` splits the edge set over the ranks of
a mesh's ``pairs`` axis and sums the normal equations across them.

Conventions
-----------
* ``poses[i]`` maps scan-i coordinates into world coordinates.
* An ICP run with source = scan j, target = scan i yields ``A_ij`` with
  ``p_i = A_ij p_j``; consistency demands ``T_i @ A_ij ~= T_j``.
* Edge residual: ``r = [log_SO3(R_err), t_err]`` of
  ``(T_i A_ij)^-1 T_j``, weighted per edge.

Gauge freedom is fixed by a strong prior on pose 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.core import se3
from icp_variants_tpu_torch.core.device import resolve_device
from icp_variants_tpu_torch.parallel.distributed import Mesh, psum


class PoseGraph(NamedTuple):
    """Edge list over V absolute poses (pad edges with weight 0)."""

    edge_i: torch.Tensor       # (E,) int64 target-scan index
    edge_j: torch.Tensor       # (E,) int64 source-scan index
    rel_poses: torch.Tensor    # (E, 4, 4) measured A_ij (p_i = A_ij p_j)
    weights: torch.Tensor      # (E,) edge confidence; 0 = padding


def _log_se3(T: torch.Tensor) -> torch.Tensor:
    """Approximate se(3) log: [log_SO3(R), t]. Exact for the rotation part;
    the translation uses the raw offset (standard for small-residual PGO)."""
    return torch.cat([se3.matrix_to_axis_angle(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def edge_residuals(x: torch.Tensor, base_poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """(E, 6) weighted residuals with increments ``x`` (V, 6) applied from
    the left of ``base_poses`` (V, 4, 4)."""
    Ti = se3.increment_to_matrix(x[graph.edge_i]) @ base_poses[graph.edge_i]
    Tj = se3.increment_to_matrix(x[graph.edge_j]) @ base_poses[graph.edge_j]
    err = se3.invert_pose(Ti @ graph.rel_poses) @ Tj
    return graph.weights[:, None] * _log_se3(err)


# Below this many poses the block JTJ assembles densely and solves with one
# dense solve (6V x 6V is tiny); above it the system is solved matrix-free
# by block-Jacobi-preconditioned CG over the edge blocks (the JAX value).
DENSE_MAX_POSES = 96


def _edge_one(z, pose_i, pose_j, rel, w):
    Ti = se3.increment_to_matrix(z[:6]) @ pose_i
    Tj = se3.increment_to_matrix(z[6:]) @ pose_j
    return w * _log_se3(se3.invert_pose(Ti @ rel) @ Tj)


def _edge_blocks(poses: torch.Tensor, graph: PoseGraph):
    """Per-edge linearization at the current poses: the weighted residual
    ``r_e`` (E, 6) and the two (E, 6, 6) Jacobian blocks with respect to
    the incident pose increments, by forward-mode differentiation over each
    edge's own 12-dim increment (O(E) work)."""
    e = graph.edge_i.shape[0]
    z0 = torch.zeros((e, 12), dtype=torch.float32, device=poses.device)
    args = (z0, poses[graph.edge_i], poses[graph.edge_j], graph.rel_poses, graph.weights)
    r = torch.func.vmap(_edge_one)(*args)
    # Forward mode carries some tangents of se3's 0-dim scalar arithmetic
    # in float64 (a Python float plus a 0-dim tensor promotes the tangent);
    # the blocks are used in float32, as the JAX package's are.
    J = torch.func.vmap(torch.func.jacfwd(_edge_one))(*args).to(torch.float32)  # (E, 6, 12)
    return r, J[:, :, :6], J[:, :, 6:]


def _scatter_rows(v: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((v, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)


def refine(
    base_poses,
    graph: PoseGraph,
    *,
    n_iterations: int = 10,
    damping: float = 1e-6,
    prior_weight: float = 1e4,
    group=None,
    n_cg: int = 100,
) -> torch.Tensor:
    """Gauss-Newton pose-graph refinement; returns the refined (V, 4, 4)
    poses on the graph's device.

    The normal equations are assembled from the per-edge 6x6 blocks
    (:func:`_edge_blocks`): densely for ``V <= DENSE_MAX_POSES``,
    matrix-free by block-Jacobi-preconditioned conjugate gradients
    (``n_cg`` iterations) beyond.

    With ``group``, ``graph`` holds this rank's share of the edges (zero
    weights pad it) and every reduction over edges sums across the group:
    the gradient, the dense H or the preconditioner's blocks, and each CG
    product; the pose update then runs the same on every rank."""
    dev = graph.rel_poses.device
    poses = torch.as_tensor(base_poses, dtype=torch.float32).to(dev)
    v = poses.shape[0]
    ei, ej = graph.edge_i, graph.edge_j
    # Gauge prior clamps pose 0; damping regularizes the whole system.
    prior_row = (torch.arange(v, device=dev) == 0).to(torch.float32)[:, None] * prior_weight
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(n_iterations):
        r, Ji, Jj = _edge_blocks(poses, graph)
        g = psum(_scatter_rows(v, ei, torch.einsum("eab,ea->eb", Ji, r))
                 + _scatter_rows(v, ej, torch.einsum("eab,ea->eb", Jj, r)), group)
        if v <= DENSE_MAX_POSES:
            H = torch.zeros((v * v, 6, 6), dtype=torch.float32, device=dev)
            H.index_add_(0, ei * v + ei, torch.einsum("eab,eac->ebc", Ji, Ji))
            H.index_add_(0, ei * v + ej, torch.einsum("eab,eac->ebc", Ji, Jj))
            H.index_add_(0, ej * v + ei, torch.einsum("eab,eac->ebc", Jj, Ji))
            H.index_add_(0, ej * v + ej, torch.einsum("eab,eac->ebc", Jj, Jj))
            H = psum(H, group)
            jtj = (H.reshape(v, v, 6, 6).permute(0, 2, 1, 3).reshape(6 * v, 6 * v)
                   + torch.diag(prior_row.expand(v, 6).reshape(-1))
                   + damping * torch.eye(6 * v, dtype=torch.float32, device=dev))
            dx = -torch.linalg.solve(jtj, g.reshape(-1)).reshape(v, 6)
        else:
            # Block diagonal of H (V, 6, 6) for the Jacobi preconditioner.
            D = psum(_scatter_rows(v, ei, torch.einsum("eab,eac->ebc", Ji, Ji))
                     + _scatter_rows(v, ej, torch.einsum("eab,eac->ebc", Jj, Jj)), group)
            D_inv = torch.linalg.inv(D + eye6[None] * (damping + prior_row)[:, :, None])

            def matvec(xv):
                y = torch.einsum("eab,eb->ea", Ji, xv[ei]) + torch.einsum("eab,eb->ea", Jj, xv[ej])
                out = psum(_scatter_rows(v, ei, torch.einsum("eab,ea->eb", Ji, y))
                           + _scatter_rows(v, ej, torch.einsum("eab,ea->eb", Jj, y)), group)
                return out + (damping + prior_row) * xv

            def precon(xv):
                return torch.einsum("vab,vb->va", D_inv, xv)

            b = -g
            x, rr = torch.zeros_like(b), b
            p = precon(b)
            rz = torch.sum(b * p)
            for _ in range(n_cg):
                hp = matvec(p)
                denom = torch.sum(p * hp)
                alpha = torch.where(denom > 0, rz / torch.clamp_min(denom, 1e-30), 0.0)
                x = x + alpha * p
                rr = rr - alpha * hp
                z = precon(rr)
                rz_new = torch.sum(rr * z)
                beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, 1e-30), 0.0)
                p = z + beta * p
                rz = rz_new
            dx = x
        poses = se3.increment_to_matrix(dx) @ poses
    return poses


def refine_sharded(base_poses, graph: PoseGraph, mesh: Mesh, *,
                   n_iterations: int = 10) -> torch.Tensor:
    """:func:`refine` with the edge set split over the mesh's ``pairs``
    axis, its normal equations summed across it. Every rank passes the
    whole graph and gets the whole refined (V, 4, 4) poses, on the mesh's
    device. Edges are padded to a multiple of the axis size with
    zero-weight identity edges."""
    n_shards = mesh.size("pairs")
    dev = mesh.device
    e = graph.edge_i.shape[0]
    pad = (-e) % n_shards
    per = (e + pad) // n_shards
    own = slice(mesh.coords["pairs"] * per, (mesh.coords["pairs"] + 1) * per)

    def grow(x, fill):
        x = torch.as_tensor(x).to(dev)
        if pad:
            x = torch.cat([x, fill.to(x.device, x.dtype).expand(pad, *x.shape[1:])])
        return x[own]

    local = PoseGraph(
        edge_i=grow(graph.edge_i, torch.zeros(1)),
        edge_j=grow(graph.edge_j, torch.zeros(1)),
        rel_poses=grow(graph.rel_poses, torch.eye(4, device=dev)[None]),
        weights=grow(graph.weights, torch.zeros(1)),
    )
    return refine(base_poses, local, n_iterations=n_iterations, group=mesh.group("pairs"))


def sequential_graph(pair_poses: np.ndarray, weights: np.ndarray | None = None,
                     device=None) -> tuple[np.ndarray, PoseGraph]:
    """Build a chain pose graph from sequential pairwise ICP results.

    ``pair_poses[k]`` is the ICP estimate aligning scan k+1 onto scan k
    (``A_{k,k+1}``). Returns the odometry-composed absolute poses (the
    initialization, host float32) and the graph on ``device`` (``None`` =
    the card)."""
    device = resolve_device(device)
    pair_poses = np.asarray(pair_poses, np.float32)
    e = pair_poses.shape[0]
    abs_poses = [np.eye(4, dtype=np.float32)]
    for k in range(e):
        abs_poses.append(abs_poses[-1] @ pair_poses[k])
    if weights is None:
        weights = np.ones((e,), np.float32)
    graph = PoseGraph(
        edge_i=torch.arange(e, dtype=torch.int64, device=device),
        edge_j=torch.arange(1, e + 1, dtype=torch.int64, device=device),
        rel_poses=torch.from_numpy(pair_poses).to(device),
        weights=torch.as_tensor(np.asarray(weights, np.float32)).to(device),
    )
    return np.stack(abs_poses), graph
