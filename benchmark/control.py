"""The readings that a cell's limits are set from.

    python benchmark/control.py --workload <name> --seeds 11,12,13 --controls 11,12 \
        --calls 3 [--out FILE]

For each seed the cell is built as a run builds it, ``--calls`` calls are
issued back to back at the cell's own load, and every number the check
reads is read through ``check.check``, the function a run's check is, on
the sample a run draws:

* ``program``: the program's answers against the reference in float32
  (the lower reading);
* on the seeds of ``--controls``, two controls judged against the same
  reference answers: ``reference_tf32``, the reference with its matrix
  products on TF32 operands put in the program's place (the nearest
  precision below the configurations' float32 with TF32 off), and
  ``program_tf32``, the program's own calls again with
  ``torch.backends.cuda.matmul.allow_tf32`` on (the step a later change
  to the normal-equation product might take). Their readings are the
  upper ones.

Each number is the statistic over the sample that a run's check takes
(``check.STATISTIC``), and every answer's gaps are kept. One JSON line per
seed on standard output, and appended to ``--out`` when given. Needs a
GPU; the CPU tests call :func:`readings` at small sizes, where
``program_tf32`` rounds the operands of every float32 matrix product to
TF32: harsher than the switch on the card, under which the program's final
poses stayed within their float32 gaps.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def tf32_products(device):
    """Float32 matrix products on TF32 operands: the card's switch, or on
    the CPU its rounding applied to the operands of ``@``, ``matmul`` and
    ``bmm``."""
    import torch

    if torch.device(device).type == "cuda":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return
    from benchmark.reference.icp import round_tf32

    def rounded(fn):
        def wrapper(a, b, *args, **kw):
            if a.dtype == torch.float32 and b.dtype == torch.float32:
                a, b = round_tf32(a), round_tf32(b)
            return fn(a, b, *args, **kw)
        return wrapper

    saved = (torch.Tensor.__matmul__, torch.matmul, torch.bmm)
    torch.Tensor.__matmul__ = rounded(saved[0])
    torch.matmul, torch.bmm = rounded(saved[1]), rounded(saved[2])
    try:
        yield
    finally:
        torch.Tensor.__matmul__, torch.matmul, torch.bmm = saved


def _stack(outputs) -> dict:
    import torch

    return {k: torch.stack([out[n] for out in outputs]).cpu().numpy()
            for n, k in enumerate(("pose", "rmse", "num_matches"))}


def _summary(verdict: dict) -> dict:
    return {"failed": verdict["failed"], "readings": verdict["readings"],
            "numbers": {k: list(v) for k, v in verdict["numbers"].items()},
            "answers": verdict["answers"]}


def readings(bench: dict, name: str, seed: int, calls: int, device, controls: bool,
             config: dict | None = None, traffic: dict | None = None) -> dict:
    """The program's readings on ``seed`` and, with ``controls``, both
    controls'. ``config`` / ``traffic`` replace the cell's files (tests)."""
    import torch

    from benchmark.harness import cells, check, spec

    _, cfg_file, traffic_file = spec.load_cell(bench, name)
    config = cfg_file if config is None else config
    traffic = traffic_file if traffic is None else traffic
    cell = cells.build(config, traffic, seed, device)
    answers = _stack([cell.dispatch(i) for i in range(calls)])
    picks = check.sample_answers(seed, calls, cell.batch, traffic["check"]["answers"])
    program_tf32 = None
    if controls:
        program_tf32 = {k: v.copy() for k, v in answers.items()}
        with tf32_products(device):
            for i in sorted({i for i, _ in picks}):
                out = cell.dispatch(i)
                cell.init_poses.pop()
                for n, k in enumerate(("pose", "rmse", "num_matches")):
                    program_tf32[k][i] = out[n].cpu().numpy()
    cell.dispatch = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": name, "seed": seed, "calls": calls, "sample": picks,
           "gpu": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    refs: dict = {}
    out["program"] = _summary(check.check(cell, config, traffic, seed, answers, device,
                                          refs=refs))
    if controls:
        out["program_tf32"] = _summary(check.check(cell, config, traffic, seed, program_tf32,
                                                   device, refs=refs))
        in_place = {k: v.copy() for k, v in answers.items()}
        for i, j in picks:
            ctl = check.reference_answer(config, cell, i, j, "tf32", device)
            in_place["pose"][i, j] = ctl["pose"]
            n = min(len(ctl["t_norm"]), in_place["rmse"].shape[-1])
            in_place["rmse"][i, j, :n] = ctl["t_norm"][:n]
            in_place["num_matches"][i, j, :n] = ctl["matches"][:n]
        out["reference_tf32"] = _summary(check.check(cell, config, traffic, seed, in_place,
                                                     device, refs=refs))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", default="", help="comma-separated seeds that read the controls")
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    controls = {int(s) for s in args.controls.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(bench, args.workload, seed, args.calls, "cuda",
                                   seed in controls))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
