"""Convergence-curve plots across variant runs (generatePlot.py equivalent).

The reference hardcodes a matplotlib comparison of per-iteration RMSE files
(generatePlot.py:1-61). Here any number of labeled error files plot onto one
figure:

    python -m icp_variants_tpu_torch.analysis.generate_plot \
        out/point_RMSE.txt out/plane_RMSE.txt --labels point plane \
        --output curves.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def plot_curves(files: list[str], labels: list[str] | None, output: str,
                title: str = "RMSE per ICP iteration", logy: bool = False) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or files
    fig, ax = plt.subplots(figsize=(8, 5))
    for path, label in zip(files, labels):
        vals = np.loadtxt(path).ravel()
        ax.plot(np.arange(len(vals)), vals, marker="o", markersize=3, label=label)
    ax.set_xlabel("iteration")
    ax.set_ylabel("RMSE")
    if logy:
        ax.set_yscale("log")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(output, dpi=150)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--labels", nargs="*")
    ap.add_argument("--output", default="convergence.png")
    ap.add_argument("--title", default="RMSE per ICP iteration")
    ap.add_argument("--logy", action="store_true")
    args = ap.parse_args(argv)
    if args.labels and len(args.labels) != len(args.files):
        print("labels must match files", file=sys.stderr)
        return 2
    plot_curves(args.files, args.labels, args.output, args.title, args.logy)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
