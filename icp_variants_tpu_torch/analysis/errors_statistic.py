"""Summary statistics over an error file (errors_statistic.py equivalent).

The reference loads one error file and prints a pandas ``describe()``
(errors_statistic.py:1-15). Same surface here, numpy-only:

    python -m icp_variants_tpu_torch.analysis.errors_statistic out/bunny0_RMSE.txt
"""

from __future__ import annotations

import sys

import numpy as np


def describe(values: np.ndarray) -> dict:
    values = np.asarray(values, np.float64).ravel()
    if values.size == 0:
        # Empty error file (0-iteration or crashed run): report count=0
        # instead of tracebacking on zero-size reductions.
        return {"count": 0}
    return {
        "count": int(values.size),
        "mean": float(values.mean()),
        "std": float(values.std(ddof=1)) if values.size > 1 else 0.0,
        "min": float(values.min()),
        "25%": float(np.percentile(values, 25)),
        "50%": float(np.percentile(values, 50)),
        "75%": float(np.percentile(values, 75)),
        "max": float(values.max()),
    }


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: errors_statistic <error_file.txt> [...]", file=sys.stderr)
        return 2
    for path in argv:
        stats = describe(np.loadtxt(path))
        print(path)
        for k, v in stats.items():
            print(f"  {k:>6}: {v:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
