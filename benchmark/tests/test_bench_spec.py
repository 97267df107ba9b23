"""BENCHMARK.json against the benchmark's contract, and the cells, traffic
mixes and metric readers found by name."""

from __future__ import annotations

import io
import json
import re
import shutil

import pytest

from benchmark import run
from benchmark.harness import cells, check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(set(names)) == len(names), section
        for e in bench[section]:
            assert set(e) - {"workloads"} == KEYS[section], (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    assert len(json.dumps(bench)) <= 64 * 1024


def test_bounds_and_cell_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = {m["name"] for m in spec.cell_metrics(bench, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.cell_metrics(bench, cell, "per_layer")


def test_every_cell_and_metric_is_found_by_name(bench):
    for w in bench["workloads"]:
        entry, config, traffic = spec.load_cell(bench, w["name"])
        assert config["name"] == w["config"] and traffic["name"] == w["traffic"]
        limits = traffic["check"]["limits"]
        assert limits and set(limits) <= set(check.GAPS)
        assert traffic["check"]["early_iterations"] >= 1
        file = next(c["file"] for c in bench["configs"] if c["name"] == w["config"])
        assert (spec.ROOT / file).exists()
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_cell_added_as_files_alone_is_picked_up(bench, tmp_path):
    copy_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, copy_dir, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((copy_dir / "configs" / "eth_apartment.json").read_text())
    config["name"] = "eth_small"
    config["data"]["points"] = 24_000
    config["icp"]["n_iterations"] = 4
    (copy_dir / "configs" / "eth_small.json").write_text(json.dumps(config))
    # A new kind of data and a new entry are files of their own too.
    for folder, old, new in (("kinds", "scan_sequence", "scan_copy"),
                             ("entries", "run_icp_batch", "batch_copy")):
        shutil.copy(copy_dir / folder / f"{old}.py", copy_dir / folder / f"{new}.py")
    config["data"]["kind"] = "scan_copy"
    (copy_dir / "configs" / "eth_small.json").write_text(json.dumps(config))
    traffic = json.loads((copy_dir / "workloads" / "seq44x4.json").read_text())
    traffic.update(name="pair1x2", pairs=1, perturbations=2, warmup_calls=1, entry="batch_copy")
    (copy_dir / "workloads" / "pair1x2.json").write_text(json.dumps(traffic))
    (copy_dir / "metrics" / "calls.pairs.py").write_text(
        "def read(stretch):\n    return stretch.calls\n")
    grown = json.loads(json.dumps(bench))
    grown["workloads"].append({"name": "eth_small.pair1x2", "config": "eth_small",
                               "traffic": "pair1x2", "chips": 1, "why": "a test cell"})
    entry, config2, traffic2 = spec.load_cell(grown, "eth_small.pair1x2", copy_dir)
    assert (config2["data"]["points"], traffic2["pairs"]) == (24_000, 1)
    assert spec.metric_reader("calls.pairs", copy_dir)(type("S", (), {"calls": 3})()) == 3
    # A metric without a file of its own is read by its quantity's reader.
    assert spec.metric_reader("matcher_ms.newunit", copy_dir).__module__.endswith("matcher_ms")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.pairs", copy_dir)
    with pytest.raises(FileNotFoundError):
        cells.load_module("kinds", "no_such_kind", copy_dir)
    res = run.run_cell(grown, "eth_small.pair1x2", 7, 0.01, False, "cpu", bench_dir=copy_dir,
                       log=io.StringIO())
    assert res["correct"] and res["attempted"] % 2 == 0
    # scan_copy and batch_copy exist only in the copy, so the run read them.
    assert not (spec.BENCH_DIR / "kinds" / "scan_copy.py").exists()
