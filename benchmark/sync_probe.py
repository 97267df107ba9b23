"""Where a cell's call makes the host wait for the device.

    python benchmark/sync_probe.py --workload <name> [--seed N]

Builds the cell as a run does, warms it up, then issues one call under
``torch.cuda.set_sync_debug_mode("warn")`` and prints each distinct line
of the program at which PyTorch reported a synchronising operation, with
its count. Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import cells, spec

    if not torch.cuda.is_available():
        print("sync_probe.py needs a CUDA device", file=sys.stderr)
        return 2
    _, config, traffic = spec.load_cell(spec.load_benchmark(), args.workload)
    cell = cells.build(config, traffic, args.seed, "cuda")
    cell.dispatch(0)
    torch.cuda.synchronize()
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "icp_variants_tpu_torch" in f.filename]
        where = f"{frames[-1].filename.split('icp_variants_tpu_torch')[-1]}:{frames[-1].lineno}" \
            if frames else f"{filename}:{lineno}"
        sites[f"{where} {str(message)[:80]}"] += 1

    old = warnings.showwarning
    warnings.showwarning = record
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        cell.dispatch(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = old
    torch.cuda.synchronize()
    print(f"{args.workload}: {sum(sites.values())} synchronising operations in one call")
    for site, n in sites.most_common():
        print(f"  {n} x {site}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
