"""The one traffic generator: a cell's inputs, made from the seed, and its
call into the program.

The configuration's ``data.kind`` names the module that makes the inputs,
``kinds/<kind>.py``, and the traffic mix's ``entry`` the module that calls
the program, ``entries/<entry>.py``; both are found by name, so a new kind
of data or a new entry is a new file. A kind's ``build(config, traffic,
seed, device, entry)`` returns a :class:`Cell` (through :meth:`Cell.make`),
with the reference's inputs for each answer worked out again from the raw
data. Every call takes fresh initial poses and a fresh selection seed, both
drawn from the run's seed and the call's index; the initial poses are made
on the device, so a call hands nothing from the host to the card.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import torch

from benchmark.harness.spec import BENCH_DIR, mix_seed

# Stream tags of mix_seed: which draw a seed is for.
SCAN_STREAM, POSE_STREAM, CALL_STREAM, OFFSET_STREAM = 0, 1, 2, 3


@dataclass
class Cell:
    """A built cell: ``dispatch(i)`` issues call i and returns its ``(pose
    (B, 4, 4), rmse (B, T), num_matches (B, T))`` without waiting for
    them; ``init_poses[i]`` are its inputs; ``reference_inputs(i, j,
    device)`` hands the reference what registration j of call i was made
    from (``source``, ``target``, ``draws``)."""

    unit: str
    batch: int
    settings: dict
    dispatch: Callable[[int], tuple]
    reference_inputs: Callable[[int, int, object], dict]
    init_poses: list = field(default_factory=list)

    @classmethod
    def make(cls, config: dict, traffic: dict, seed: int, device, cfg, settings: dict, entry,
             sources, targets, kd_indexes, batch: int, reference_inputs) -> "Cell":
        """The cell whose call ``i`` runs ``entry.call`` on the stacked
        ``sources`` / ``targets`` from poses drawn for call ``i``."""
        draw = PoseDraw(traffic.get("init_pose", config["init_pose"]), device)
        cell = cls(unit=config["unit"], batch=batch, settings=settings, dispatch=None,
                   reference_inputs=reference_inputs)

        def dispatch(i: int) -> tuple:
            pose0 = draw(seed, i, batch)
            cell.init_poses.append(pose0)
            res = entry.call(cfg, sources, targets, pose0, seed=call_seed(seed, i),
                             kd_indexes=kd_indexes, device=device)
            return res.pose, res.trace.rmse, res.trace.num_matches

        cell.dispatch = dispatch
        return cell


def port_config(settings: dict, camera: dict | None):
    """The program's ICPConfig of the cell's settings (enum members by name)."""
    from icp_variants_tpu_torch.pipeline import config as cfg_mod

    enums = {"metric": cfg_mod.Metric, "minimizer": cfg_mod.Minimizer,
             "matching": cfg_mod.Matching, "selection": cfg_mod.Selection,
             "weighting": cfg_mod.Weighting}
    kw = {k: (enums[k][v] if k in enums else v) for k, v in settings.items()}
    cfg = cfg_mod.ICPConfig(**kw)
    if camera is not None:
        cfg = cfg.with_camera(fx=camera["fx"], fy=camera["fy"], cx=camera["cx"],
                              cy=camera["cy"], width=camera["width"], height=camera["height"])
    return cfg


class PoseDraw:
    """Initial poses on ``device`` per ``spec``: a rotation by an angle drawn
    uniformly from ``spec["angle"]`` about ``spec["axis"]`` (a unit vector,
    or ``"random"``: a direction drawn uniformly), and a translation drawn
    uniformly from the box ``spec["translation"]``. Its constants go to the
    device once, so a draw copies nothing from the host."""

    def __init__(self, spec: dict, device):
        self.device = device
        self.random_axis = spec["axis"] == "random"
        self.axis = None if self.random_axis else torch.tensor(
            spec["axis"], dtype=torch.float32).to(device)
        self.angle = tuple(float(a) for a in spec["angle"])
        self.box = torch.tensor(spec["translation"], dtype=torch.float32).to(device)

    def __call__(self, seed: int, call: int, batch: int) -> torch.Tensor:
        """(batch, 4, 4) float32 poses of call ``call``."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(mix_seed(seed, call, POSE_STREAM))
        u = torch.rand(batch, 4, generator=gen, device=dev)
        axis = (torch.randn(batch, 3, generator=gen, device=dev) if self.random_axis
                else self.axis.expand(batch, 3))
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        lo, hi = self.angle
        angle = lo + (hi - lo) * u[:, 0]
        t = self.box[:, 0] + (self.box[:, 1] - self.box[:, 0]) * u[:, 1:4]
        k = torch.zeros(batch, 3, 3, device=dev)
        k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
        k = k - k.transpose(1, 2)
        s, c = torch.sin(angle)[:, None, None], torch.cos(angle)[:, None, None]
        pose = torch.eye(4, device=dev).repeat(batch, 1, 1)
        pose[:, :3, :3] = torch.eye(3, device=dev) + s * k + (1.0 - c) * (k @ k)
        pose[:, :3, 3] = t
        return pose


def call_seed(seed: int, call: int) -> int:
    return mix_seed(seed, call, CALL_STREAM)


def load_module(folder: str, name: str, bench_dir: Path = BENCH_DIR):
    """Module ``<bench_dir>/<folder>/<name>.py``."""
    path = bench_dir / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder} module {name!r} under {bench_dir / folder}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(config: dict, traffic: dict, seed: int, device, bench_dir: Path = BENCH_DIR) -> Cell:
    kind = load_module("kinds", config["data"]["kind"], bench_dir)
    entry = load_module("entries", traffic["entry"], bench_dir)
    return kind.build(config, traffic, seed, device, entry)
