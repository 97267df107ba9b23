"""One rank of the multi-rank path: its rehearsal, or a list of cases.

    python -m icp_variants_tpu_torch.scripts.multihost_rehearsal RANK WORLD RENDEZVOUS \\
        [--device cpu] [--backend gloo] [--cases DIR]

Start one process per rank, each with its own RANK (0 .. WORLD - 1).
RENDEZVOUS is a ``torch.distributed`` init method every rank can reach
(``file:///path``, ``tcp://host:port``) or a bare port
(``tcp://127.0.0.1:PORT``). ``--device`` is the rank's device (default: the
card, ``cuda:{rank % device count}``); ``--backend`` defaults to ``nccl``
on the card and ``gloo`` on the CPU. Ranks that share one card pass
``--backend gloo``: NCCL refuses a communicator with one device twice.

Without ``--cases``, the rehearsal of the JAX package's
``scripts/multihost_rehearsal.py``: bring-up, a global mesh (two ranks a
pair when the world is even, else one), one sharded ICP step on a small
synthetic batch, and ``REHEARSAL OK`` printed.

With ``--cases DIR``, every case of ``DIR/spec.json`` in order
(``write_spec`` writes it; the arrays are ``.npz`` files beside it): for
each, a mesh of ``points_per_pair`` ranks a pair, then

* ``kind: "icp"``: ``sharded_icp.run_icp_batch_sharded`` on the case's
  clouds, kd indexes, ground truth and per-shard draws, once to warm up
  when ``warmup`` is set, then once with the kernels' launch counts and the
  collectives' counts set to 0 just before it and read just after;
  ``padding_check`` adds, on the rank whose points shard is padding only,
  one direct ``kdtree.match_kd`` of its (all masked) queries;
* ``kind: "refine"``: ``pose_graph.refine_sharded`` on the case's graph
  (once to warm up first when ``warmup`` is set);
* ``kind: "trajectory"``: ``workloads.eth.refine_trajectory(mesh=)`` on the
  chain of the case's relative poses.

Each rank writes ``DIR/out/<case>.rank<R>.npz`` (poses, traces and the
batch rows it holds) and, last, ``DIR/out/rank<R>.json`` (per case: wall
seconds, launches, collectives, mesh coordinates), and prints ``CASES OK``.
Any failure exits nonzero. :func:`start_ranks` and :func:`join_ranks`
start the ranks of a world on one host and wait for them.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def config_dict(cfg) -> dict:
    """An ``ICPConfig`` as JSON-ready fields (enums by value)."""
    return {f.name: (int(v) if isinstance(v, enum.Enum) else v)
            for f in dataclasses.fields(cfg) for v in (getattr(cfg, f.name),)}


def config_from_dict(fields: dict):
    """The ``ICPConfig`` of :func:`config_dict`'s fields."""
    from icp_variants_tpu_torch.pipeline.config import ICPConfig

    base = ICPConfig()
    return base.replace(**{k: type(getattr(base, k))(v) if isinstance(getattr(base, k), enum.Enum)
                           else v for k, v in fields.items()})


def write_spec(root, cases) -> None:
    """Write ``root/spec.json`` for ``--cases root``: ``cases`` is a list of
    dicts with ``name``, ``kind``, ``points_per_pair``, ``data`` (an
    ``.npz`` file name under ``root``) and, for ``icp``, ``cfg`` (an
    ``ICPConfig``) and the optional ``seed``, ``run_benchmark``,
    ``num_source_points``, ``selected`` (the prefix of the arrays
    ``<prefix>_rows`` / ``<prefix>_flags``), ``warmup`` and
    ``padding_check``; for ``refine``, ``n_iterations`` and ``warmup``."""
    out = [dict(c, cfg=config_dict(c["cfg"])) if "cfg" in c else dict(c) for c in cases]
    Path(root, "spec.json").write_text(json.dumps({"cases": out}, indent=1))


def start_ranks(world: int, rendezvous: str, log_dir, *, cases=None, device=None,
                backend=None) -> list[subprocess.Popen]:
    """Start ``world`` processes of this script, ranks 0 .. world - 1, from
    the repository's root; each one's output goes to
    ``log_dir/rank<R>.log``. Join them with :func:`join_ranks`."""
    root = Path(__file__).resolve().parents[2]
    extra = [*(["--device", device] if device else []),
             *(["--backend", backend] if backend else []),
             *(["--cases", str(cases)] if cases else [])]
    procs = []
    for rank in range(world):
        with open(Path(log_dir, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "icp_variants_tpu_torch.scripts.multihost_rehearsal",
                 str(rank), str(world), rendezvous, *extra],
                cwd=root, stdout=log, stderr=subprocess.STDOUT))
    return procs


def join_ranks(procs, log_dir, timeout: float) -> list[str]:
    """Wait for the ranks of :func:`start_ranks` at most ``timeout`` seconds
    in all; returns their outputs. Raises (the ranks killed) when one
    outlives the time or exits nonzero."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [Path(log_dir, f"rank{r}.log").read_text() for r in range(len(procs))]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed or outlived {timeout} s:\n" + "\n".join(
            f"--- rank {r} (rc {procs[r].returncode}) ---\n{outs[r][-4000:]}" for r in bad))
    return outs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _icp_case(case, data, mesh, rank, out_dir):
    import torch.distributed as dist

    from icp_variants_tpu_torch.core.cloud import Cloud
    from icp_variants_tpu_torch.ops import _cuda, kdtree
    from icp_variants_tpu_torch.parallel import distributed, sharded_icp

    dev = mesh.device
    cfg = config_from_dict(case["cfg"])
    src = Cloud(*(data[f"src_{f}"] for f in Cloud._fields))
    tgt = Cloud(*(data[f"tgt_{f}"] for f in Cloud._fields))
    kd = (kdtree.KDIndex(*(data.get(f"kd_{f}") for f in kdtree.KDIndex._fields))
          if "kd_pages" in data else None)
    sel = case.get("selected")
    selected = (data[f"{sel}_rows"], data[f"{sel}_flags"]) if sel else None
    gt = {k: data[v] for k, v in (("gt_source_points", "gt_src"), ("gt_target_points", "gt_tgt"),
                                  ("gt_valid", "gt_valid")) if v in data}

    def run():
        return sharded_icp.run_icp_batch_sharded(
            cfg, src, tgt, mesh, seed=case.get("seed", 0),
            run_benchmark=case.get("run_benchmark", False),
            num_source_points=case.get("num_source_points"), kd_indexes=kd,
            selected=selected, **gt)

    if case.get("warmup"):
        run()
        _sync(dev)
    if dist.is_initialized():
        dist.barrier()
    _cuda.reset_launches()
    distributed.COLLECTIVES.clear()
    t0 = time.perf_counter()
    res, pairs = run()
    _sync(dev)
    wall = time.perf_counter() - t0
    info = dict(wall_s=wall, launches=dict(_cuda.LAUNCHES),
                collectives=dict(distributed.COLLECTIVES), pairs=[pairs.start, pairs.stop],
                coords=dict(mesh.coords), iterations=int(res.trace.rmse.shape[1]))
    if case.get("padding_check"):
        info["padding"] = _padding_check(cfg, src, tgt, kd, mesh, pairs)
    np.savez(out_dir / f"{case['name']}.rank{rank}.npz", pose=res.pose.cpu().numpy(),
             rmse=res.trace.rmse.cpu().numpy(), benchmark=res.trace.benchmark.cpu().numpy(),
             num_matches=res.trace.num_matches.cpu().numpy(),
             pairs=np.array([pairs.start, pairs.stop]))
    return info


def _padding_check(cfg, src, tgt, kd, mesh, pairs):
    """On a rank whose points shard is padding only: its shard's queries
    (the sentinel rows, every one masked) through ``kdtree.match_kd`` at
    the case's arm, the launches counted from 0 around it. Returns the
    rows, matched rows, rows not at -1 and the launches; None on a rank
    holding real rows."""
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import _cuda, kdtree, knn
    from icp_variants_tpu_torch.parallel import sharded_icp

    n = mesh.size("points")
    padded = sharded_icp.pad_cloud_rows(src, n * cloud_lib.PAD_MULTIPLE)
    local = sharded_icp._shard_rows(padded.valid[pairs], n, mesh.coords["points"], False)
    if bool(local.any()):
        return None
    q = sharded_icp._shard_rows(padded.points[pairs], n, mesh.coords["points"], 0.0)
    q = q.to(mesh.device)
    tp = tgt.points[pairs].to(mesh.device)
    fidx = knn.build_target_index(tp, tile_t=knn.V2_TILE_T)
    kd_local = kdtree.KDIndex(*(None if f is None else f[pairs].to(mesh.device) for f in kd))
    _cuda.reset_launches()
    idx, _d2, valid = kdtree.match_kd(q, kd_local, fidx, cfg.max_distance,
                                      query_mask=torch.zeros(q.shape[:2], dtype=torch.bool,
                                                             device=q.device),
                                      checks=cfg.matching_checks)
    _sync(mesh.device)
    return dict(rows=int(q.shape[0] * q.shape[1]), matched=int(valid.sum()),
                not_minus_one=int((idx != -1).sum()), launches=dict(_cuda.LAUNCHES))


def _refine_case(case, data, mesh, rank, out_dir):
    from icp_variants_tpu_torch.parallel import distributed
    from icp_variants_tpu_torch.parallel import pose_graph as pg

    graph = pg.PoseGraph(*(data[f].to(mesh.device) for f in pg.PoseGraph._fields))

    def run():
        return pg.refine_sharded(data["base_poses"], graph, mesh,
                                 n_iterations=case.get("n_iterations", 10))

    if case.get("warmup"):
        run()
        _sync(mesh.device)
    distributed.COLLECTIVES.clear()
    t0 = time.perf_counter()
    refined = run()
    _sync(mesh.device)
    wall = time.perf_counter() - t0
    np.savez(out_dir / f"{case['name']}.rank{rank}.npz", pose=refined.cpu().numpy())
    return dict(wall_s=wall, collectives=dict(distributed.COLLECTIVES), coords=dict(mesh.coords))


def _trajectory_case(case, data, mesh, rank, out_dir):
    from icp_variants_tpu_torch.workloads import eth

    run = eth.ETHRunResult()
    for k, rel in enumerate(data["rel_poses"].cpu().numpy()):
        run.add(eth.ETHPairResult(index=k, initial_error=0.0, final_error=0.0,
                                  initial_rmse=0.0, final_rmse=0.0,
                                  rmse_per_iteration=np.zeros(0), benchmark_per_iteration=np.zeros(0),
                                  pose=rel))
    t0 = time.perf_counter()
    _, refined, _ = eth.refine_trajectory(run, mesh=mesh)
    np.savez(out_dir / f"{case['name']}.rank{rank}.npz", pose=refined)
    return dict(wall_s=time.perf_counter() - t0, coords=dict(mesh.coords))


_CASE_KINDS = {"icp": _icp_case, "refine": _refine_case, "trajectory": _trajectory_case}


def run_cases(root: Path, rank: int, device) -> dict:
    """Run every case of ``root/spec.json``; returns the per-case summary,
    also written to ``root/out/rank<rank>.json``."""
    from icp_variants_tpu_torch.parallel import distributed

    spec = json.loads((root / "spec.json").read_text())
    out_dir = root / "out"
    out_dir.mkdir(exist_ok=True)
    meshes, loaded, summary = {}, {}, {}
    for case in spec["cases"]:
        ppp = case["points_per_pair"]
        if ppp not in meshes:
            meshes[ppp] = distributed.global_mesh(ppp, device=device)
        mesh = meshes[ppp]
        if case["data"] not in loaded:
            with np.load(root / case["data"]) as z:
                loaded[case["data"]] = {k: torch.from_numpy(z[k]).to(mesh.device) for k in z.files}
        summary[case["name"]] = _CASE_KINDS[case["kind"]](case, loaded[case["data"]], mesh, rank,
                                                         out_dir)
        print(f"rank {rank}: case {case['name']}: {summary[case['name']]}", flush=True)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(summary))
    return summary


def rehearse(rank: int, world: int, device) -> None:
    """The JAX package's rehearsal: a global mesh, one sharded ICP step on
    replicated host data, finite poses for this rank's pairs."""
    from icp_variants_tpu_torch.core.cloud import Cloud
    from icp_variants_tpu_torch.parallel import distributed, sharded_icp
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer

    mesh = distributed.global_mesh(points_per_pair=2 if world % 2 == 0 else 1, device=device)
    if mesh.size("pairs") * mesh.size("points") != world:
        raise RuntimeError(f"mesh {mesh} does not span the {world} ranks")
    cfg = ICPConfig(metric=Metric.POINT_TO_PLANE, minimizer=Minimizer.LINEAR, max_distance=1.0)
    n_pairs, cap = mesh.size("pairs"), 512
    rng = np.random.default_rng(0)  # the same seed on every rank: replicated host data
    src = rng.standard_normal((n_pairs, cap, 3)).astype(np.float32) * 0.1
    nrm = rng.standard_normal((n_pairs, cap, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    col = rng.integers(0, 256, (n_pairs, cap, 4)).astype(np.float32)
    valid = np.ones((n_pairs, cap), bool)
    tgt = src + 0.01
    t = torch.from_numpy
    step = sharded_icp.make_sharded_icp_step(cfg, mesh)
    res, pairs = step(Cloud(t(src), t(nrm), t(col), t(valid)),
                      Cloud(t(tgt), t(nrm), t(col), t(valid)),
                      torch.eye(4).expand(n_pairs, 4, 4))
    if not bool(torch.isfinite(res.pose).all()):
        raise RuntimeError("the sharded step gave non-finite poses")
    print(f"REHEARSAL OK rank={rank}/{world} mesh={mesh.shape} pairs={pairs.start}:{pairs.stop}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("rendezvous")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--cases", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from icp_variants_tpu_torch.core.device import resolve_device
    from icp_variants_tpu_torch.parallel import distributed

    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init = (f"tcp://127.0.0.1:{args.rendezvous}" if args.rendezvous.isdigit()
            else args.rendezvous)
    distributed.initialize(init, world_size=args.world, rank=args.rank, backend=args.backend,
                           device=dev)
    if distributed.process_count() != args.world:
        raise RuntimeError(f"{distributed.process_count()} ranks up, {args.world} expected")
    device = distributed.rank_device(args.device)
    if device.type == "cuda":
        from icp_variants_tpu_torch.ops import _cuda

        _cuda.build_all()
    try:
        if args.cases:
            run_cases(Path(args.cases), args.rank, device)
            print(f"CASES OK rank={args.rank}/{args.world}", flush=True)
        else:
            rehearse(args.rank, args.world, device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
