"""Experiment harness: the runtime-configured sweep runner.

Port of ``icp_variants_tpu.workloads.experiments``, the equivalent of
``experiment.cpp``: reads a CSV config matrix with columns

    expName, expType, useLinear, useMetric, matchingMethod, selectionMethod,
    weightingMethod, useMultiresolution, numIterations, maxMatchingDist,
    samplingProba

(schema at Data/experiment.csv:1, parsing at experiment.cpp:414-447) and
dispatches each row to the bunny / room / ETH workload, writing per-config
``<expName>_RMSE*.txt`` error files plus a JSON summary, every row on
``device`` (``None`` = the card).

Completed rows are recorded incrementally (``summary.json``), so a
crashed sweep resumes from where it stopped (the reference gets the same
from its per-file outputs).
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass

import numpy as np

from icp_variants_tpu_torch.pipeline.config import (
    ICPConfig,
    Matching,
    Metric,
    Minimizer,
    Selection,
    Weighting,
)


@dataclass
class ExperimentRow:
    name: str
    exp_type: str           # "bunny" | "room" | "eth"
    config: ICPConfig

    @staticmethod
    def from_csv_row(row: list[str]) -> "ExperimentRow":
        (name, exp_type, use_linear, use_metric, matching, selection,
         weighting, multires, n_iter, max_dist, proba) = row[:11]
        cfg = ICPConfig(
            metric=Metric(int(use_metric)),
            minimizer=Minimizer.LINEAR if int(use_linear) else Minimizer.NONLINEAR_LM,
            matching=Matching(int(matching)),
            selection=Selection(int(selection)),
            weighting=Weighting(int(weighting)),
            multi_resolution=bool(int(multires)),
            n_iterations=int(n_iter),
            max_distance=float(max_dist),
            selection_proba=float(proba),
        )
        return ExperimentRow(name=name, exp_type=exp_type.strip(), config=cfg)


def read_experiment_csv(path: str) -> list[ExperimentRow]:
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    return [ExperimentRow.from_csv_row(r) for r in rows[1:]]  # skip header


def write_error_file(path: str, values: np.ndarray) -> None:
    """One value per line (ConvergenceMeasure::writeRMSEToFile,
    ConvergenceMeasure.h:153-163)."""
    with open(path, "w") as f:
        for v in np.asarray(values).ravel():
            f.write(f"{float(v):g}\n")


def run_experiments(
    csv_path: str,
    out_dir: str = "out",
    bunny_data_dir: str | None = None,
    room_data_dir: str | None = None,
    eth_csv_path: str | None = None,
    max_pairs: int | None = None,
    resume: bool = True,
    device=None,
) -> dict:
    """Run every row of the config matrix on ``device`` (``None`` = the
    card); returns the summary dict."""
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, "summary.json")
    summary: dict = {}
    if resume and os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = json.load(f)

    for i, row in enumerate(read_experiment_csv(csv_path)):
        key = f"{row.name}:{i}"
        if key in summary:
            continue
        prefix = os.path.join(out_dir, row.name)

        try:
            _run_row(row, prefix, summary, key, bunny_data_dir, room_data_dir,
                     eth_csv_path, max_pairs, i, device)
        except Exception as exc:  # noqa: BLE001 — the sweep survives bad rows
            # A crashing configuration (bad data path, out of memory,
            # degenerate geometry) is recorded and the sweep goes on.
            summary[key] = {"type": row.exp_type, "error": repr(exc)}

        with open(summary_path, "w") as f:
            json.dump(summary, f, indent=2)

    return summary


def _run_row(row, prefix, summary, key, bunny_data_dir, room_data_dir,
             eth_csv_path, max_pairs, i, device):
    from icp_variants_tpu_torch.workloads import bunny as bunny_wl

    if row.exp_type == "bunny":
        res = bunny_wl.align_bunny(row.config, data_dir=bunny_data_dir, seed=i, device=device)
        write_error_file(f"{prefix}_RMSE.txt", res.rmse_per_iteration)
        summary[key] = {
            "type": "bunny",
            "final_rmse": res.final_rmse,
            "config": row.config.describe(),
        }
    elif row.exp_type == "room":
        if room_data_dir is None:
            summary[key] = {"type": "room", "skipped": "no room_data_dir"}
        else:
            from icp_variants_tpu_torch.workloads import room as room_wl

            res = room_wl.reconstruct_room(room_data_dir, row.config, device=device)
            for fi, curve in enumerate(res.rmse_per_frame):
                write_error_file(f"{prefix}_RMSE{fi}.txt", curve)
            summary[key] = {
                "type": "room",
                "final_rmse": res.final_rmse,
                "config": row.config.describe(),
            }
    elif row.exp_type == "eth":
        if eth_csv_path is None:
            summary[key] = {"type": "eth", "skipped": "no eth_csv_path"}
        else:
            from icp_variants_tpu_torch.workloads import eth as eth_wl

            # experiment.cpp:327-328 applies the unscaled GT pose.
            res = eth_wl.align_eth(
                eth_csv_path, row.config, pose_scaling=1.0,
                max_pairs=max_pairs, seed=i, device=device,
            )
            for p in res.pairs:
                write_error_file(f"{prefix}_RMSE{p.index}.txt", p.rmse_per_iteration)
                write_error_file(
                    f"{prefix}_Benchmark{p.index}.txt", p.benchmark_per_iteration
                )
            write_error_file(f"{prefix}_benchmark_error.txt", res.final_errors)
            summary[key] = {
                "type": "eth",
                "final_errors": res.final_errors.tolist(),
                "config": row.config.describe(),
            }
    else:
        summary[key] = {"skipped": f"unknown expType {row.exp_type!r}"}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv_path")
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--room-data-dir")
    ap.add_argument("--eth-csv-path")
    ap.add_argument("--max-pairs", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    s = run_experiments(
        args.csv_path, out_dir=args.out_dir, room_data_dir=args.room_data_dir,
        eth_csv_path=args.eth_csv_path, max_pairs=args.max_pairs, device=args.device,
    )
    print(json.dumps(s, indent=2))
