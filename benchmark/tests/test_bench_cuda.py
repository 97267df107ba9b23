"""One short cell on the card, through the benchmark's own command."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_one_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "tum_fr1_room.projective_kf8x8", "--seed", "2147483999", "--seconds",
                          "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
