"""Shared fixtures of the harness's CPU tests: the benchmark's own files,
and each configuration cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402

ETH = "eth_apartment.seq44x4"
COLOUR = "tum_fr1_room.colour_kf8"
PROJECTIVE = "tum_fr1_room.projective_kf8x8"


@pytest.fixture(scope="session")
def bench():
    return spec.load_benchmark()


def tiny(bench: dict, name: str) -> tuple[dict, dict]:
    """Cell ``name``'s configuration and traffic at a CPU test's size, with
    its check's limits as committed."""
    _, config, traffic = spec.load_cell(bench, name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    if name == ETH:
        config["data"]["points"] = 24_000   # above the kd path's 20,000-point floor
        config["icp"]["n_iterations"] = 6
        traffic.update(pairs=1, perturbations=2)
        traffic["check"]["answers"] = 2
    elif name == COLOUR:
        config["icp"]["n_iterations"] = 3
        traffic.update(frames_per_keyframe=1, source_downsample=32)
    else:
        config["icp"]["n_iterations"] = 2
        traffic.update(keyframes=[0], frames_per_keyframe=1)
        traffic["check"]["answers"] = 1
    traffic.update(warmup_calls=1, trace_first=1, trace_calls=1)
    return config, traffic
