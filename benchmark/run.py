"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. The cell's
configuration and traffic mix are found by the names in ``BENCHMARK.json``
(``benchmark/harness/spec.py``). The run makes its inputs from the seed,
builds the program's indexes, warms up with two calls of the cell's shapes
(all of which counts as set-up), measures a closed-loop window of calls
(``benchmark/harness/window.py``), reads the device peak, frees the
program's state and judges a sample of the window's answers against the
plain reference (``benchmark/harness/check.py``). With ``--trace 0`` the
last line of standard output holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read by ``benchmark/metrics/`` from a
profiled stretch of whole calls inside the window.

It exits with 2, printing no result, without a GPU or with fewer than the
cell's chips, and with 3 if a module of the JAX package (or JAX) is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "icp_variants_tpu")
WARMUP_CALL = 1 << 40   # call indices of the warm-up calls start here


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = process_age_s()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its own CUDA libraries under ``build/icp_variants_tpu_torch``)."""
    cache = root / "build" / "benchmark_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             config: dict | None = None, traffic: dict | None = None,
             bench_dir: Path | None = None, log=sys.stderr) -> dict:
    """One run of cell ``name`` on ``device``; returns the result line's
    object. The cell's files are read under ``bench_dir`` (default: this
    directory); ``config`` / ``traffic`` replace them (tests run the
    harness at small sizes on the CPU)."""
    import torch

    from benchmark.harness import cells, check, spec, trace as trace_lib, window
    from icp_variants_tpu_torch.ops import _cuda

    bench_dir = spec.BENCH_DIR if bench_dir is None else bench_dir
    entry, cfg_file, traffic_file = spec.load_cell(bench, name, bench_dir)
    config = cfg_file if config is None else config
    traffic = traffic_file if traffic is None else traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = cells.build(config, traffic, seed, device, bench_dir)
    for k in range(traffic.get("warmup_calls", 2)):
        cell.dispatch(WARMUP_CALL + k)
    if cuda:
        torch.cuda.synchronize()
    cell.init_poses.clear()
    setup_s = AGE_AT_START + time.perf_counter() - T_START

    stretch = (traffic["trace_first"], traffic["trace_calls"]) if trace else None
    win = window.run(cell.dispatch, seconds, device, stretch=stretch,
                     launches=_cuda.LAUNCHES if cuda else None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    answers = {k: torch.stack([out[n] for out in win.outputs]).cpu().numpy()
               for n, k in enumerate(("pose", "rmse", "num_matches"))}
    units = win.calls * cell.batch
    print(f"window: {win.calls} calls of {cell.batch} {cell.unit} in {win.seconds} s; "
          f"host issue ms per call (outside any stretch): median "
          f"{statistics.median(win.issue_ms) if win.issue_ms else 'none'}", file=log)

    result = {"correct": False, "attempted": units, "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": entry["chips"] if cuda else 0, "memory_peak_bytes": int(peak)}
    if trace:
        dev_ev, host_ev = trace_lib.from_profiler(win.profile)
        st = trace_lib.Stretch(dev_ev, host_ev, win.stretch_calls, cell.batch,
                               issue_ms=win.issue_ms)
        for m in spec.cell_metrics(bench, name, "per_layer"):
            value = spec.metric_reader(m["name"], bench_dir)(st)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = trace_lib.busy_us(dev_ev) / 1e6
        device_info["window_s"] = trace_lib.span_us(dev_ev) / 1e6
        result["breakdown"] = trace_lib.breakdown(dev_ev, host_ev)
        port_events = sum(1 for e in dev_ev if e["kind"] == "kernel"
                          and trace_lib.matches(e["name"], tuple(_cuda.KERNELS)))
        print(f"stretch: {win.stretch_calls} calls, {len(dev_ev)} device events, "
              f"{len(host_ev)} host events; the port's C entries launched "
              f"{sum(win.port_launches.values())} times ({win.port_launches}) for "
              f"{port_events} of its kernel events", file=log)
        win.profile = None
    else:
        for m in spec.cell_metrics(bench, name, "end_to_end"):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == f"{cell.unit}_per_s":
                value = units / win.seconds
            else:
                raise ValueError(f"the harness does not measure {m['name']!r}")
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = device_info

    # The program's state goes before the reference runs on the same device.
    cell.dispatch = None
    win.outputs.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = check.check(cell, config, traffic, seed, answers, device)
    result["failed"] = verdict["failed"]
    result["correct"] = verdict["failed"] == 0
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["numbers"].items()}
    print(f"checked answers (call, row): {verdict['sample']}; their gaps to the reference "
          f"({', '.join(check.GAPS)}): {[tuple(g.values()) for g in verdict['answers']]}; "
          f"over the sample, compared or not: {verdict['readings']}", file=log)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs(ROOT)

    import torch

    from benchmark.harness import spec

    bench = spec.load_benchmark()
    entry = spec.workload_entry(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
