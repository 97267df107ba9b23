"""The check on the CPU at small sizes: each cell's sound run is correct
against the plain reference under the committed limits; the controls (the
reference with TF32 products, the program with TF32 products) and the
faults a run can have are not."""

from __future__ import annotations

import io
import math

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.harness import check
from conftest import COLOUR, ETH, PROJECTIVE, tiny

SEED = 2**31 + 97


def _run(bench, name, seconds=0.01, **kw):
    config, traffic = tiny(bench, name)
    return run.run_cell(bench, name, SEED, seconds, False, "cpu", config=config,
                        traffic=traffic, log=io.StringIO(), **kw)


@pytest.mark.parametrize("name", [ETH, COLOUR, PROJECTIVE])
def test_sound_run_is_correct(bench, name):
    res = _run(bench, name)
    assert res["correct"] and res["failed"] == 0, res["check"]
    assert res["attempted"] >= 1
    assert list(res)[-1] == "check" and "answers_not_rigid" in res["check"]
    for value, limit in ((v["value"], v["limit"]) for v in res["check"].values()):
        assert value <= limit


@pytest.mark.parametrize("name", [ETH, COLOUR, PROJECTIVE])
def test_control_fails_the_limits(bench, name):
    """Both controls, judged by the run's own check: the reference with
    TF32 matrix products put in the program's place, and the program with
    its float32 products on TF32 operands."""
    config, traffic = tiny(bench, name)
    res = control.readings(bench, name, SEED, 1, "cpu", True, config, traffic)
    assert res["program"]["failed"] == 0, res["program"]["numbers"]
    for key in ("reference_tf32", "program_tf32"):
        assert res[key]["failed"] > 0, (key, res[key]["numbers"])


def test_answer_gaps_read_the_early_trace():
    ref = {"pose": np.eye(4), "t_norm": np.array([1.0, 0.5, 0.2, 0.1]),
           "matches": np.array([10, 12, 12, 12])}
    rmse, nm = np.array([1.0, 0.5 + 3e-6, 0.2, 0.3]), np.array([10, 11, 12, 12])
    gaps = check.answer_gaps(np.eye(4), rmse, nm, ref, early=3)
    assert gaps["early_t_gap_m"] == pytest.approx(3e-6) and gaps["early_match_gap"] == 1
    assert gaps["pose_t_gap_m"] == 0 and gaps["pose_r_gap_rad"] == 0
    assert all(v == math.inf for v in check.answer_gaps(np.eye(4), rmse[:3], nm[:3], ref,
                                                        early=3).values())
    rmse[0] = np.nan
    assert check.answer_gaps(np.eye(4), rmse, nm, ref, early=3)["early_t_gap_m"] == math.inf


def _unchanged_state(monkeypatch):
    from icp_variants_tpu_torch.pipeline import icp

    monkeypatch.setattr(icp, "_solve", lambda cfg, m, w, group=None: torch.eye(4).expand(
        m.valid.shape[0], 4, 4))


def _half_batch(monkeypatch):
    from icp_variants_tpu_torch.core.cloud import Cloud
    from icp_variants_tpu_torch.ops.kdtree import KDIndex
    from icp_variants_tpu_torch.pipeline import icp

    real = icp.run_icp_batch

    def half(cfg, sources, targets, init_poses, **kw):
        h = max(1, sources.valid.shape[0] // 2)
        kd = kw.pop("kd_indexes", None)
        kd = None if kd is None else KDIndex(*(None if f is None else f[:h] for f in kd))
        res = real(cfg, Cloud(*(f[:h] for f in sources)), Cloud(*(f[:h] for f in targets)),
                   init_poses[:h], kd_indexes=kd, **kw)
        rest = init_poses.shape[0] - h
        trace = type(res.trace)(*(torch.cat([x, torch.zeros_like(x[:1]).expand(rest, -1)])
                                  for x in res.trace))
        return res._replace(pose=torch.cat([res.pose, init_poses[h:]]), trace=trace)

    monkeypatch.setattr(icp, "run_icp_batch", half)


def _answer_altered(monkeypatch):
    from icp_variants_tpu_torch.pipeline import icp

    real = icp.run_icp_batch

    def altered(*a, **kw):
        res = real(*a, **kw)
        c, s = torch.cos(torch.tensor(1e-3)), torch.sin(torch.tensor(1e-3))
        turn = torch.tensor([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        return res._replace(pose=turn @ res.pose)

    monkeypatch.setattr(icp, "run_icp_batch", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _answer_altered])
def test_a_run_with_a_fault_is_not_correct(bench, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(bench, ETH)
    assert not res["correct"] and res["failed"] > 0, res["check"]
