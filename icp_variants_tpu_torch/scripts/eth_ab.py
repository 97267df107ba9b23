"""Time the ETH path of two checkouts of the repository in turns on one card.

    python3 -m icp_variants_tpu_torch.scripts.eth_ab OTHER_ROOT [--rounds 10]

One worker process runs per checkout: this repository's root (A) and
``OTHER_ROOT`` (B), for example the parent commit unpacked with
``git archive`` into a git-ignored directory. Each worker imports its own
checkout's ``chip_smoke.py`` and ``icp_variants_tpu_torch`` (so each side
runs its own kernels and wrappers), builds the ETH path's data as
``chip_smoke.eth_phase`` does (``make_pairs``: 16 pairs of 365,000 points
from fixed seeds, their kd indexes) and runs each arm once to warm up.

Then, per round, each worker runs each arm (exact, checks16) once while the
other waits, A before B in even rounds and B before A in odd ones, so drift
of the shared host hits both alike. A run's wall is ``run_icp_batch`` to
``torch.cuda.synchronize()`` (``chip_smoke.timed_runs``' measure), with the
host's issue time beside it.

Each worker also times one ``kd_block_search`` call at the path's shapes (16
pairs x 4,352 queries, k = 4, picks from ``box_topk``) and one
``visited_search`` call at the exact arm's fallback inputs on those queries
(the rows whose top-4 certificate fails at the bound search within it, the
rest frozen): the host's seconds from the call to its return (median over
15 batches of 20 calls issued back to back) and the call's CUDA-event ms.

Prints one JSON line per round and, last, a summary: per checkout and arm
the walls, their median and pairs/s, and the two kernels' timings. The
workers' own output goes to standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARMS = {"exact": 0, "checks16": 16}
QUERIES = 4352


def _worker() -> None:
    """Serve ``run ARM SEED``, ``issue NAME`` and ``quit`` lines from standard
    input, one JSON reply line each, for the checkout on ``sys.path``."""
    reply = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    import numpy as np
    import torch

    import chip_smoke as cs
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import kdtree, knn
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer, Selection

    dev = torch.device("cuda")
    pairs = cs.make_pairs(cs.BATCH_PAIRS, cs.N_POINTS)
    sources = icp.stack_clouds([
        cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
        for sp, sn, _, _ in pairs])
    targets_host = [cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
                    for _, _, tp, tn in pairs]
    targets = icp.stack_clouds(targets_host).to(dev)
    kd = kdtree.stack_kd_indexes([
        kdtree.build_kd_index(t.points, t.valid, device=dev) for t in targets_host])
    cfgs = {arm: ICPConfig(
        metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR, selection=Selection.RANDOM,
        selection_proba=cs.SELECTION_P, n_iterations=cs.N_ITERATIONS,
        max_distance=cs.MAX_DISTANCE, matching_checks=checks) for arm, checks in ARMS.items()}

    def run(arm, seed):
        return icp.run_icp_batch(cfgs[arm], sources, targets, kd_indexes=kd, seed=seed,
                                 device=dev)

    for arm in ARMS:
        run(arm, 1)
    torch.cuda.synchronize()

    cap = sources.points.shape[1]
    q = sources.points[:, ::cap // QUERIES][:, :QUERIES].contiguous()
    binit = torch.full(q.shape[:2], knn.bound_value(cs.MAX_DISTANCE), device=dev)
    sel, _ = kdtree.box_topk(q, binit, kd.block_min, kd.block_max, 4)

    fidx = knn.build_target_index(targets.points, tile_t=knn.V2_TILE_T)
    fail = kdtree.nn_search_kd_resident(q, kd, cs.MAX_DISTANCE)[2]
    fradii = torch.where(fail, binit, -1.0).contiguous()
    calls = {
        "kd_block_search": lambda: kdtree.kd_block_search(q, sel, binit, kd.pages),
        "visited_search": lambda: knn.visited_search(q, fradii, fidx),
    }

    reply.write(json.dumps({"pairs": int(q.shape[0])}) + "\n")
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "quit":
            break
        if cmd[0] == "run":
            t0 = time.perf_counter()
            run(cmd[1], int(cmd[2]))
            issue = time.perf_counter() - t0
            torch.cuda.synchronize()
            out = {"wall": time.perf_counter() - t0, "issue": issue}
        else:  # issue NAME
            call = calls[cmd[1]]
            per = []
            for _ in range(15):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    call()
                per.append((time.perf_counter() - t0) / 20)
            torch.cuda.synchronize()
            out = {"host_s": float(np.median(per)), "ms": cs.time_ms(call, 20)}
            if cmd[1] == "visited_search":
                out["live_rows"] = int(fail.sum())
        reply.write(json.dumps(out) + "\n")


def _start(root: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker"],
                            cwd=root, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, bufsize=1)
    return proc


def _ask(proc: subprocess.Popen, line: str | None = None) -> dict:
    if line is not None:
        proc.stdin.write(line + "\n")
        proc.stdin.flush()
    got = proc.stdout.readline()
    if not got:
        raise RuntimeError(f"worker exited (rc {proc.wait()})")
    return json.loads(got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_root", type=Path)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    roots = {"A": Path(__file__).resolve().parents[2], "B": args.other_root.resolve()}
    procs, pairs = {}, {}
    try:
        for side, root in roots.items():
            procs[side] = _start(root)
            pairs[side] = _ask(procs[side])["pairs"]  # data built, arms warmed up
        walls = {s: {a: [] for a in ARMS} for s in roots}
        issues = {s: {a: [] for a in ARMS} for s in roots}
        for r in range(args.rounds):
            order = ["A", "B"] if r % 2 == 0 else ["B", "A"]
            row = {"round": r, "order": "".join(order)}
            for side in order:
                for arm in ARMS:
                    got = _ask(procs[side], f"run {arm} {2 + r}")
                    walls[side][arm].append(got["wall"])
                    issues[side][arm].append(got["issue"])
                    row[f"{side} {arm}"] = got["wall"]
            print(json.dumps(row), flush=True)
        summary = {"roots": {s: str(p) for s, p in roots.items()}, "rounds": args.rounds}
        for side in roots:
            for arm in ARMS:
                med = statistics.median(walls[side][arm])
                summary[f"{side} {arm}"] = dict(
                    walls=walls[side][arm], issues=issues[side][arm], median_s=med,
                    pairs_per_s=pairs[side] / med)
            for name in ("kd_block_search", "visited_search"):
                summary[f"{side} {name}"] = _ask(procs[side], f"issue {name}")
        print(json.dumps(summary), flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    proc.stdin.write("quit\n")
                    proc.stdin.flush()
                    proc.wait(timeout=60)
                except (OSError, subprocess.TimeoutExpired):
                    proc.kill()
                    proc.wait()
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        _worker()
    else:
        sys.exit(main())
