"""The JAX package's reading of the bunny runs on the CPU.

Runs the repository's bunny halves (``assets/bunny``) through the JAX
package on the CPU in the six configurations that ``chip_smoke.py``'s
register phase runs on the card:

* default: ``workloads.bunny.default_config()`` (LM point-to-point, 20
  iterations, max squared distance 3e-4), through ``bunny.align_bunny``;
* p2p_linear, gicp_linear, gicp_lm, p2p_lm_aa2: the same with the linear
  point-to-point (Procrustes) solve, linear GICP, GICP through LM, and LM
  point-to-point with Anderson acceleration (m = 2);
* register: ``api.register`` on the halves' vertices with no normals (k = 5
  PCA normals by the dense k-NN) and the bunny's GT pairs as the oracle,
  under the default configuration.

Prints one JSON line per run: the final pose, the per-iteration RMSE and
match counts, the final RMSE and the seconds the run took. ``chip_smoke.py``
keeps the poses and final RMSEs as constants and holds the card's runs
against them. With ``--port`` the PyTorch port runs the same configuration
on the CPU after each run, and the line adds its pose gap (largest entry of
the 4x4 difference) and its match counts.

    JAX_PLATFORMS=cpu python scripts/bunny_reference_cpu.py [--port]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from icp_variants_tpu import api  # noqa: E402
from icp_variants_tpu.data.loaders import BunnyDataLoader  # noqa: E402
from icp_variants_tpu.pipeline.config import Metric, Minimizer  # noqa: E402
from icp_variants_tpu.workloads import bunny  # noqa: E402

RUNS = {
    "default": {},
    "p2p_linear": {"minimizer": "LINEAR"},
    "gicp_linear": {"metric": "GICP", "minimizer": "LINEAR"},
    "gicp_lm": {"metric": "GICP"},
    "p2p_lm_aa2": {"anderson_m": 2},
    "register": {},
}


def overrides(change, metric_enum, minimizer_enum):
    out = dict(change)
    if "metric" in out:
        out["metric"] = getattr(metric_enum, out["metric"])
    if "minimizer" in out:
        out["minimizer"] = getattr(minimizer_enum, out["minimizer"])
    return out


def run_jax(name):
    cfg = bunny.default_config(**overrides(RUNS[name], Metric, Minimizer))
    if name != "register":
        r = bunny.align_bunny(cfg)
        return r.pose, r.rmse_per_iteration, r.num_matches
    loader = BunnyDataLoader()
    gt_src, gt_tgt = loader.gt_correspondences()
    r = api.register(loader.source_mesh.vertices, loader.target_mesh.vertices, cfg,
                     gt_source_points=gt_src, gt_target_points=gt_tgt)
    return r.pose, r.rmse, r.num_matches


def run_port(name):
    from icp_variants_tpu_torch import api as tapi
    from icp_variants_tpu_torch.data.loaders import BunnyDataLoader as TLoader
    from icp_variants_tpu_torch.pipeline.config import Metric as TMetric
    from icp_variants_tpu_torch.pipeline.config import Minimizer as TMinimizer
    from icp_variants_tpu_torch.workloads import bunny as tbunny

    cfg = tbunny.default_config(**overrides(RUNS[name], TMetric, TMinimizer))
    if name != "register":
        r = tbunny.align_bunny(cfg, device="cpu")
        return r.pose, r.rmse_per_iteration, r.num_matches
    loader = TLoader(device="cpu")
    gt_src, gt_tgt = loader.gt_correspondences()
    r = tapi.register(loader.source_mesh.vertices, loader.target_mesh.vertices, cfg,
                      gt_source_points=gt_src, gt_target_points=gt_tgt, device="cpu")
    return r.pose, r.rmse, r.num_matches


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the PyTorch port on the CPU and print its gap")
    args = ap.parse_args()
    for name in RUNS:
        t0 = time.perf_counter()
        pose, rmse, nm = run_jax(name)
        seconds = time.perf_counter() - t0
        out = {"run": name, "seconds": seconds, "pose": np.asarray(pose).tolist(),
               "final_rmse": float(rmse[-1]), "rmse": np.asarray(rmse).tolist(),
               "num_matches": np.asarray(nm).tolist()}
        if args.port:
            ppose, prmse, pnm = run_port(name)
            out.update(port_pose_gap=float(np.abs(np.asarray(ppose, np.float64)
                                                  - np.asarray(pose, np.float64)).max()),
                       port_final_rmse=float(prmse[-1]),
                       port_num_matches=np.asarray(pnm).tolist())
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
