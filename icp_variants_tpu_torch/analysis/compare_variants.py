"""Side-by-side ICP-variant comparison on one scan pair.

The reference's analysis flow is per-run RMSE files + generatePlot.py
(analysis scripts, SURVEY §2.1 #30). This tool drives the whole variant
matrix — the reference's six-knob pipeline plus this framework's
extensions (GICP metric, Huber/Tukey robust weighting, Trimmed ICP,
Anderson acceleration) — over one pair in a single command, writes each
curve as a ``<name>_RMSE.txt`` ready for ``generate_plot``, and prints a
summary table (final RMSE + iterations to reach each run's 90%-converged
level).

    python -m icp_variants_tpu_torch.analysis.compare_variants --out-dir out
    python -m icp_variants_tpu_torch.analysis.compare_variants \
        --variants point_lm gicp_linear tukey --plot curves.png

Default pair: the Stanford bunny halves shipped in assets/. Any variant
name not listed in ``--variants`` is skipped; ``--list`` shows the matrix.
The runs are on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from icp_variants_tpu_torch.pipeline.config import (
    ICPConfig, Metric, Minimizer, Weighting,
)

# The comparison matrix: reference configurations first, extensions after.
# Bunny-scale max_distance; n_iterations matches the bunny driver.
_BASE = dict(n_iterations=20, max_distance=0.0003)
VARIANTS: dict[str, ICPConfig] = {
    "point_lm": ICPConfig(
        metric=Metric.POINT_TO_POINT, minimizer=Minimizer.NONLINEAR_LM,
        **_BASE,
    ),
    "plane_lm": ICPConfig(
        metric=Metric.POINT_TO_PLANE, minimizer=Minimizer.NONLINEAR_LM,
        **_BASE,
    ),
    "symmetric_lm": ICPConfig(
        metric=Metric.SYMMETRIC, minimizer=Minimizer.NONLINEAR_LM, **_BASE,
    ),
    "point_linear": ICPConfig(
        metric=Metric.POINT_TO_POINT, minimizer=Minimizer.LINEAR, **_BASE,
    ),
    "plane_linear": ICPConfig(
        metric=Metric.POINT_TO_PLANE, minimizer=Minimizer.LINEAR, **_BASE,
    ),
    "symmetric_linear": ICPConfig(
        metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR, **_BASE,
    ),
    # Extensions (no reference analogs):
    "gicp_linear": ICPConfig(
        metric=Metric.GICP, minimizer=Minimizer.LINEAR, **_BASE,
    ),
    "gicp_lm": ICPConfig(
        metric=Metric.GICP, minimizer=Minimizer.NONLINEAR_LM, **_BASE,
    ),
    "huber": ICPConfig(
        metric=Metric.POINT_TO_POINT, minimizer=Minimizer.LINEAR,
        weighting=Weighting.HUBER, **_BASE,
    ),
    "tukey": ICPConfig(
        metric=Metric.POINT_TO_POINT, minimizer=Minimizer.LINEAR,
        weighting=Weighting.TUKEY, **_BASE,
    ),
    "trimmed_0.8": ICPConfig(
        metric=Metric.POINT_TO_POINT, minimizer=Minimizer.LINEAR,
        trim_ratio=0.8, **_BASE,
    ),
    "point_lm_aa2": ICPConfig(
        metric=Metric.POINT_TO_POINT, minimizer=Minimizer.NONLINEAR_LM,
        anderson_m=2, **_BASE,
    ),
}


def run_variants(
    names: list[str],
    out_dir: str,
    max_distance: float | None = None,
    device=None,
) -> dict[str, dict]:
    """Run each named variant on the bunny pair on ``device`` (``None`` =
    the card); write ``<name>_RMSE.txt`` into ``out_dir`` and return
    {name: {final_rmse, iters_to_90pct}}. Random selection draws from a
    ``torch.Generator`` seeded 0, where the JAX package takes
    ``PRNGKey(0)``."""
    import torch

    from icp_variants_tpu_torch.core.device import resolve_device
    from icp_variants_tpu_torch.data.loaders import BunnyDataLoader
    from icp_variants_tpu_torch.pipeline import icp as icp_mod

    dev = resolve_device(device)
    loader = BunnyDataLoader(device=dev)
    sample = loader.get_item(0)
    gt_src, gt_tgt = loader.gt_correspondences()

    os.makedirs(out_dir, exist_ok=True)
    summary: dict[str, dict] = {}
    for name in names:
        cfg = VARIANTS[name]
        if max_distance is not None:
            cfg = cfg.replace(max_distance=max_distance)
        res = icp_mod.run_icp(
            cfg, sample.source, sample.target,
            gt_source_points=gt_src, gt_target_points=gt_tgt,
            generator=torch.Generator(device=dev).manual_seed(0), device=dev,
        )
        rmse = res.trace.rmse.cpu().numpy()
        np.savetxt(os.path.join(out_dir, f"{name}_RMSE.txt"), rmse)
        # Iterations until the curve first reaches within 10% of its own
        # final level — a convergence-speed proxy comparable across
        # variants that end at different floors.
        level = rmse[-1] * 1.1 + 1e-12
        hit = np.nonzero(rmse <= level)[0]
        summary[name] = {
            "final_rmse": float(rmse[-1]),
            "iters_to_90pct": int(hit[0]) if hit.size else len(rmse),
        }
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out-dir", default="out")
    ap.add_argument(
        "--variants", nargs="*", default=list(VARIANTS),
        help="subset of the matrix to run (default: all)",
    )
    ap.add_argument("--max-distance", type=float)
    ap.add_argument("--plot", help="also render the curves to this PNG")
    ap.add_argument("--list", action="store_true", help="show the matrix")
    ap.add_argument("--device", default="cuda", help="where the runs happen (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.list:
        for name, cfg in VARIANTS.items():
            print(f"{name:18s} {cfg.describe().splitlines()[-1].strip()}")
        return 0

    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; see --list")

    summary = run_variants(args.variants, args.out_dir, args.max_distance, device=args.device)
    width = max(len(n) for n in summary)
    print(f"{'variant':{width}s}  final RMSE   iters-to-90%")
    for name, row in summary.items():
        print(
            f"{name:{width}s}  {row['final_rmse']:.6f}     "
            f"{row['iters_to_90pct']}"
        )

    if args.plot:
        from icp_variants_tpu_torch.analysis.generate_plot import plot_curves

        files = [
            os.path.join(args.out_dir, f"{n}_RMSE.txt") for n in summary
        ]
        plot_curves(files, list(summary), args.plot, logy=True)
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
