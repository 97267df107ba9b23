"""Data kind ``depth_frames``: ``synth_depth_frame`` frames; keyframe group
g tracks frames k + 1 .. k + ``frames_per_keyframe`` against keyframe
k = k0 + ``keyframes[g]``, with k0 drawn from the seed below
``frame_offsets``. Sources and targets are laid out as the traffic mix
says (``source_layout``, ``target_layout``; see ``reference/derive.py``):
the program back-projects them with its own code, the reference again
with its own from the same raw frames."""

from __future__ import annotations

import numpy as np

from benchmark.harness import synth
from benchmark.harness.cells import OFFSET_STREAM, Cell, port_config
from benchmark.harness.spec import icp_settings, mix_seed


def _layout_kw(layout: str, cap: int, down: int) -> dict:
    return {
        "image": dict(keep_original_size=True, for_projective=True, capacity=cap),
        "full_colour_morton": dict(keep_original_size=True, color_morton_order=True,
                                   downsample_factor=down, capacity=cap // down),
        "compact": dict(keep_original_size=False, capacity=cap),
        "compact_xyz_morton": dict(keep_original_size=False, downsample_factor=down,
                                   capacity=cap // down, morton_order=True),
    }[layout]


def build(config: dict, traffic: dict, seed: int, device, entry) -> Cell:
    from icp_variants_tpu_torch.data import rgbd
    from icp_variants_tpu_torch.ops import kdtree
    from icp_variants_tpu_torch.pipeline import icp

    data, cam = config["data"], config["camera"]
    settings = icp_settings(config, traffic)
    cfg = port_config(settings, cam)
    k0 = mix_seed(seed, 0, OFFSET_STREAM) % data["frame_offsets"]
    per_kf = traffic["frames_per_keyframe"]
    groups = [k0 + k for k in traffic["keyframes"]]
    rows = [(kf, kf + f + 1) for kf in groups for f in range(per_kf)]
    frames = {i: synth.synth_depth_frame(i) for i in sorted({x for r in rows for x in r})}
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    cap = cam["width"] * cam["height"]
    down = traffic.get("source_downsample", 1)
    src_layout, tgt_layout = traffic["source_layout"], traffic["target_layout"]
    src_kw, tgt_kw = _layout_kw(src_layout, cap, down), _layout_kw(tgt_layout, cap, 1)
    tgt_host = {kf: rgbd.cloud_from_depth(*frames[kf], K, eye, device="cpu", **tgt_kw)
                for kf in groups}
    kd = {kf: icp.build_kd_for(cfg, tgt_host[kf], device=device) for kf in groups}
    sources = icp.stack_clouds([
        rgbd.cloud_from_depth(*frames[f], K, eye, device=device, **src_kw) for _, f in rows])
    targets = icp.stack_clouds([tgt_host[kf] for kf, _ in rows]).to(device)
    kd_indexes = (None if kd[groups[0]] is None
                  else kdtree.stack_kd_indexes([kd[kf] for kf, _ in rows]))
    src_cap, tgt_cap = sources.capacity, targets.capacity

    def reference_inputs(i: int, j: int, device) -> dict:
        from benchmark.reference import derive

        kf, f = rows[j]
        return {"source": derive.depth_cloud(*frames[f], K, src_layout, src_cap, down),
                "target": derive.depth_cloud(*frames[kf], K, tgt_layout, tgt_cap),
                "draws": None}

    return Cell.make(config, traffic, seed, device, cfg, settings, entry, sources, targets,
                     kd_indexes, len(rows), reference_inputs)
