"""The JAX package's reading of the projective RGB-D tracker on the CPU.

Runs ``bench.prepare_tum_state``'s frames (frame 0 image-shaped as the
target, frames 1-8 stride-8 compacted in xyz-Morton order as sources)
through ``icp.run_icp_batch`` on the CPU in both arms of the PyTorch port's
projective cell:

* linear: ``bench.bench_tum_projective``'s configuration (point-to-plane,
  linear solve, ``projective_chunk=4096``);
* lm: ``room.default_config(matching=Matching.PROJECTIVE)`` (point-to-point,
  the Ceres-style LM solver, 10 inner steps, function tolerance 1e-6).

Prints one JSON line per arm: the per-frame final translations, the
per-frame and mean translation error (max-abs against the known camera
shift, ``bench.measure_color_accuracy``'s formula), the mean rotation error,
the per-iteration match counts of frame 1, and the seconds the run took.
``chip_smoke.py`` holds the card's per-frame translations against these.
With ``--port`` the PyTorch port runs the same frames on the CPU after each
arm (its plain versions), and the line adds its per-frame translation gap.

    JAX_PLATFORMS=cpu python scripts/projective_reference_cpu.py [--frames N] [--port]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import bench  # noqa: E402
from icp_variants_tpu.pipeline import icp  # noqa: E402
from icp_variants_tpu.pipeline.config import Matching  # noqa: E402
from icp_variants_tpu.workloads import room  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=bench.TUM_BATCH_FRAMES)
    ap.add_argument("--port", action="store_true",
                    help="also run the PyTorch port on the CPU and print its gap")
    args = ap.parse_args()
    state = bench.prepare_tum_state()
    n = args.frames
    sources = jax.tree.map(lambda x: x[:n], state["sources_ds"])
    targets = jax.tree.map(lambda x: x[:n], state["targets_img"])
    cfgs = {
        "linear": bench._tum_base_config(matching=Matching.PROJECTIVE, projective_chunk=4096),
        "lm": room.default_config(matching=Matching.PROJECTIVE),
    }
    for arm, cfg in cfgs.items():
        t0 = time.perf_counter()
        res = icp.run_icp_batch(cfg, sources, targets, key=jax.random.PRNGKey(0))
        poses = np.asarray(jax.device_get(res.pose), np.float64)
        seconds = time.perf_counter() - t0
        t_errs, r_errs = [], []
        for b in range(n):
            gt_t = np.array([-bench.TUM_SHIFT * (b + 1), 0.0, 0.0])
            t_errs.append(float(np.abs(poses[b, :3, 3] - gt_t).max()))
            r_errs.append(float(bench.rotation_geodesic_deg(poses[b, :3, :3])))
        out = {}
        if args.port:
            out = port_gap(cfg, sources, targets, poses)
        print(json.dumps({
            **out, "arm": arm, "frames": n, "seconds": seconds,
            "translations": poses[:, :3, 3].tolist(),
            "t_err_m": t_errs, "mean_t_err_m": float(np.mean(t_errs)),
            "mean_r_err_deg": float(np.mean(r_errs)),
            "num_matches_frame1": np.asarray(res.trace.num_matches)[0].tolist(),
        }), flush=True)


def port_gap(cfg, sources, targets, poses) -> dict:
    """The port's run of ``cfg`` on the same clouds, on the CPU: its
    per-frame largest translation gap to ``poses`` and its seconds. The
    port's config takes the JAX one's fields as they are (its enums are
    IntEnums with the same values)."""
    import torch

    from icp_variants_tpu_torch import convert
    from icp_variants_tpu_torch.pipeline import config as tconfig
    from icp_variants_tpu_torch.pipeline import icp as ticp

    tcfg = tconfig.ICPConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    t0 = time.perf_counter()
    res = ticp.run_icp_batch(tcfg, convert.cloud_from_arrays(sources, "cpu"),
                             convert.cloud_from_arrays(targets, "cpu"), device="cpu")
    gap = np.abs(res.pose.to(torch.float64).numpy()[:, :3, 3] - poses[:, :3, 3]).max(1)
    return {"port_seconds": time.perf_counter() - t0, "port_gap_m": gap.tolist()}


if __name__ == "__main__":
    main()
