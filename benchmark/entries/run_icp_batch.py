"""Entry ``run_icp_batch``: the batched driver (ETH sweeps, projective tracking)."""

from __future__ import annotations


def call(cfg, sources, targets, init_poses, *, seed, kd_indexes, device):
    from icp_variants_tpu_torch.pipeline import icp

    return icp.run_icp_batch(cfg, sources, targets, init_poses, seed=seed,
                             kd_indexes=kd_indexes, device=device)
