"""What the harness and its reference load, checked in fresh processes, by
the whole top-level name of each module."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "icp_variants_tpu"}


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax_package():
    code = f"""
import io, json, sys
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from benchmark import run
from benchmark.harness import spec
from conftest import tiny, ETH
bench = spec.load_benchmark()
config, traffic = tiny(bench, ETH)
res = run.run_cell(bench, ETH, 5, 0.01, True, "cpu", config=config, traffic=traffic,
                   log=io.StringIO())
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "correct": res["correct"]}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded["correct"]
    assert "icp_variants_tpu_torch" in loaded["top"]
    assert not FORBIDDEN & set(loaded["top"])


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.icp, benchmark.reference.derive
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not (FORBIDDEN | {"icp_variants_tpu_torch"}) & top


def test_without_a_gpu_the_command_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "tum_fr1_room.projective_kf8x8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
