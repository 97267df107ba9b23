"""Entry ``run_icp_batch_multires_segmented``: the segmented pyramid driver
(dense colour tracking), its schedule seeded from the sources' capacity."""

from __future__ import annotations


def call(cfg, sources, targets, init_poses, *, seed, kd_indexes, device):
    from icp_variants_tpu_torch.pipeline import icp

    return icp.run_icp_batch_multires_segmented(
        cfg, sources, targets, init_poses, seed=seed, kd_indexes=kd_indexes, device=device,
        num_source_points=sources.capacity)
