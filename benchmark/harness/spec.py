"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` is read from ``configs/<config>.json`` (the
deployment: its source, its data, its ICP settings and the reference that
judges it) and ``workloads/<traffic>.json`` (the traffic mix: the batch it
sends, its overrides of the ICP settings, the trace stretch and the
limits of the check). A per-layer metric ``<quantity>.<unit>`` is read by
``metrics/<quantity>.<unit>.py`` where that file exists, else by
``metrics/<quantity>.py``. A later cell, traffic mix or metric is a new
file and a new entry; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(bench: dict, name: str, bench_dir: Path = BENCH_DIR) -> tuple[dict, dict, dict]:
    """``(workload entry, configuration, traffic)`` of cell ``name``."""
    entry = workload_entry(bench, name)
    with open(bench_dir / "configs" / f"{entry['config']}.json") as f:
        config = json.load(f)
    with open(bench_dir / "workloads" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return entry, config, traffic


def cell_metrics(bench: dict, name: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``name`` reports: those whose ``workloads`` list it, or that have
    no such list."""
    return [m for m in bench[section] if name in m.get("workloads", [name])]


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of per-layer metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {bench_dir / 'metrics'}")


def icp_settings(config: dict, traffic: dict) -> dict:
    """The configuration's ICP settings with the traffic mix's overrides."""
    return {**config["icp"], **traffic.get("icp", {})}


def mix_seed(*parts: int) -> int:
    """A 63-bit seed from whole numbers of any size (the run's seed, a call
    index, a stream tag)."""
    state = np.random.SeedSequence([int(p) % (1 << 64) for p in parts]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
