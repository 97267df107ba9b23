"""Deciding ``correct``: the program's answers against the plain reference.

An answer is one registration: its final pose, and the trace the program
keeps of each iteration (``rmse``, which without ground truth is the norm
of the pose's translation after the iteration, and ``num_matches``, the
matches entering its solve). Once the window has closed, every answer's
pose is checked to be a finite rigid pose, and a sample drawn from the seed
(always holding one answer of the last call) is registered again by the
reference from the same raw inputs and initial pose. Four gaps are read per
answer: of the final pose's translation (m) and rotation (rad), and, over
the first ``early_iterations`` iterations, the largest gap of the
translation's norm (m) and of the match count. The final pose's gaps are
taken as their mean over the sample: float32 rounding alone moves single
final poses of a weakly held registration by a spread whose largest value
swings from seed to seed, while one answer that is wrong moves the mean
past any limit. The early iterations see what the fixed point absorbs
later: a step computed in a lower precision moves the first poses of every
answer before the last iterations pull them back; their gaps are taken as
their median (``STATISTIC``). The traffic mix gives a limit to the gaps that separate a
sound program from the control (``benchmark/control.py``); only those are
compared.
"""

from __future__ import annotations

import importlib
import math

import numpy as np

from benchmark.harness.spec import mix_seed

SAMPLE_STREAM = 4
GAPS = ("pose_t_gap_m", "pose_r_gap_rad", "early_t_gap_m", "early_match_gap")
# How the sample's gaps make one number: the final pose's by their mean,
# the early iterations' by their median (a match that flips within
# rounding in one answer moves that answer's early steps by a hundred
# times the others' gap, while a step worked out in a lower precision
# moves the early steps of every answer).
STATISTIC = {"pose_t_gap_m": np.mean, "pose_r_gap_rad": np.mean,
             "early_t_gap_m": np.median, "early_match_gap": np.median}


def sample_answers(seed: int, calls: int, batch: int, count: int) -> list[tuple[int, int]]:
    """``count`` distinct (call, row) answers drawn from the seed; the first
    is of the last call."""
    rng = np.random.default_rng(mix_seed(seed, calls, SAMPLE_STREAM))
    total = calls * batch
    picks = [(calls - 1) * batch + int(rng.integers(batch))]
    rest = rng.permutation(total)
    for a in rest:
        if len(picks) >= min(count, total):
            break
        if int(a) not in picks:
            picks.append(int(a))
    return [(a // batch, a % batch) for a in picks]


def pose_gaps(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(largest translation difference in m, rotation angle of a's rotation
    relative to b's in rad), in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    t = float(np.abs(a[:3, 3] - b[:3, 3]).max())
    r = a[:3, :3] @ b[:3, :3].T
    axial = 0.5 * np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return t, math.atan2(float(np.linalg.norm(axial)), 0.5 * (np.trace(r) - 1.0))


def rigid(p: np.ndarray, tol: float = 1e-3) -> bool:
    """A finite pose whose rotation block is orthonormal within ``tol``."""
    p = np.asarray(p, np.float64)
    return bool(np.isfinite(p).all()
                and np.abs(p[:3, :3] @ p[:3, :3].T - np.eye(3)).max() < tol
                and np.abs(p[3] - [0, 0, 0, 1]).max() < tol)


def reference_answer(config: dict, cell, i: int, j: int, precision: str, device) -> dict:
    """The reference's registration ``j`` of call ``i``
    (``benchmark.reference.<config["reference"]>.register``)."""
    ref = importlib.import_module(f"benchmark.reference.{config['reference']}")
    cfg = dict(cell.settings)
    if "camera" in config:
        cfg["camera"] = config["camera"]
    cfg.setdefault("projective_window", 12)
    init = cell.init_poses[i][j].detach().cpu().numpy()
    return ref.register(cfg, init_pose=init, precision=precision, device=device,
                        **cell.reference_inputs(i, j, device))


def answer_gaps(pose, rmse, num_matches, ref: dict, early: int) -> dict:
    """The four gaps of one answer to the reference's (inf where either
    side is not a finite rigid pose or the traces differ in length)."""
    t_ref = np.asarray(ref["t_norm"], np.float64)
    m_ref = np.asarray(ref["matches"], np.float64)
    if not (rigid(pose) and np.isfinite(ref["pose"]).all() and len(rmse) == len(t_ref)):
        return dict.fromkeys(GAPS, math.inf)
    k = min(early, len(t_ref))
    dt = np.abs(np.asarray(rmse[:k], np.float64) - t_ref[:k])
    dm = np.abs(np.asarray(num_matches[:k], np.float64) - m_ref[:k])
    t, r = pose_gaps(pose, ref["pose"])
    return {"pose_t_gap_m": t, "pose_r_gap_rad": r,
            "early_t_gap_m": float(np.nan_to_num(dt, nan=math.inf).max()),
            "early_match_gap": float(dm.max())}


def check(cell, config: dict, traffic: dict, seed: int, answers: dict, device,
          precision: str = "fp32", refs: dict | None = None) -> dict:
    """``answers``: every answer of the window, ``{"pose": (calls, B, 4,
    4), "rmse": (calls, B, T), "num_matches": (calls, B, T)}``. The
    numbers compared are the gaps over the sample (``STATISTIC``) that the
    traffic mix gives a limit, and the count of answers that are not a finite
    rigid pose (limit 0). ``refs`` ({(call, row): reference answer})
    reuses reference answers already worked out, and gains those worked
    out here. Returns ``{"failed", "numbers": {name: (value, limit)},
    "readings": {gap: number}, "answers", "sample", "refs"}``, ``answers``
    holding every gap of every sampled answer."""
    poses = answers["pose"]
    calls, batch = poses.shape[:2]
    limits = traffic["check"]["limits"]
    early = traffic["check"]["early_iterations"]
    refs = {} if refs is None else refs
    bad = sum(not rigid(p) for p in poses.reshape(-1, 4, 4))
    picks = sample_answers(seed, calls, batch, traffic["check"]["answers"])
    gaps = []
    for i, j in picks:
        if (i, j) not in refs:
            refs[(i, j)] = reference_answer(config, cell, i, j, precision, device)
        gaps.append(answer_gaps(poses[i, j], answers["rmse"][i, j], answers["num_matches"][i, j],
                                refs[(i, j)], early))
    readings = {k: float(STATISTIC[k]([g[k] for g in gaps])) for k in GAPS}
    numbers = {k: (readings[k], lim) for k, lim in limits.items()}
    numbers["answers_not_rigid"] = (bad, 0)
    over = sum(not value <= lim for value, lim in numbers.values())
    return {"failed": int(bad + over), "numbers": numbers, "readings": readings,
            "answers": gaps, "sample": picks, "refs": refs}
