"""Time the dense and tile-pruned expansion matchers of checkouts in turns.

    python3 -m icp_variants_tpu_torch.scripts.nn_ab [--ablation] ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory
and this one: ``out/parent . . out/parent`` times parent, this, this,
parent. For each ROOT in the order given, one worker process runs this file
with ROOT first on ``sys.path``, so it imports that checkout's
``icp_variants_tpu_torch`` (its own kernels, built into its own ``build/``,
and its own wrappers). Every worker builds the same inputs through this
checkout's ``chip_smoke.matcher_inputs``, as phase 7 does: ETH pair 0
(``make_pairs``), its 365,056 rows with the unselected ones at the pad
sentinel for the dense search and its 4,352 selected query slots for the
pruned one; colour frame 1 against frame 0 (``prepare_tum_state``). It
times ``knn.dense_nn_search`` at both widths (median of 5 CUDA-event
timings) and ``knn.pruned_nn_search`` at max_distance 10 and 0.01 (ETH)
and 0.1 (colour) (median of 20), and hashes each result. Then it calls
``profile_stages`` twice on the ETH headline and colour exact configs (3
repetitions each) and reads the matching stage and the stages' total per
iteration of the second call, and the whole wall (``total_wall``, the
warm-up pass included) of both: the first call in the process is the cold
one.

With ``--ablation`` each worker times the visited-list ablation kernel
instead: on phase 8's inputs (``chip_smoke.ablation_queries``: the JAX
ablation script's 4,736 query slots against its 365,000 targets, chunk 8,
squared bound 10) it hashes each mode's result and times each of the
seven modes (median of 20 CUDA-event timings). Needs a card.

Prints, per worker, one JSON line; then per reading the ms of each run in
order, and whether every run gave the same result bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys


def _worker(ablation: bool) -> dict:
    """Time the matchers, or the ablation kernel, of the checkout at the
    front of ``sys.path``."""
    import importlib.util
    import pathlib

    # This checkout's chip_smoke.py: its imports of the port resolve to ROOT's.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[2] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from icp_variants_tpu_torch.ops import _cuda

    _cuda.build_all()
    return _ablation(cs) if ablation else _matchers(cs)


def _result_sha(idx, d2) -> str:
    return hashlib.sha256(idx.cpu().numpy().tobytes() + d2.cpu().numpy().tobytes()).hexdigest()[:16]


def _ablation(cs) -> dict:
    """Each mode of the ablation kernel on phase 8's inputs: its hash and ms."""
    import torch

    from icp_variants_tpu_torch.scripts import knn_ablate

    dev = torch.device("cuda")
    q, t = cs.ablation_queries()
    inp = knn_ablate.ablate_inputs(torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev),
                                   cs.MAX_DISTANCE)
    out = {"root": os.getcwd(), "ms": {}, "sha": {}}
    for mode in knn_ablate.MODES:
        d2, idx = knn_ablate.ablate_search(inp, mode)
        out["sha"][mode] = _result_sha(idx, d2)
        out["ms"][mode] = cs.time_ms(lambda mode=mode: knn_ablate.ablate_search(inp, mode),
                                     cs.ABLATE_REPS)
    return out


def _matchers(cs) -> dict:
    """The dense and pruned matchers' readings and profile_stages'."""
    import torch

    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import knn
    from icp_variants_tpu_torch.pipeline import icp, profiling
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer, Selection

    dev = torch.device("cuda")
    sp, sn, tp, tn = cs.make_pairs(1)[0]
    src = cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
    tgt = cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device=dev)
    tgt_h, sources = cs.prepare_tum_state(dev)
    frame = icp.Cloud(*(f[0] for f in sources))
    ctgt = tgt_h.to(dev)
    ins = cs.matcher_inputs(src, tgt, frame, ctgt)
    q3, t3, qk, q6, t6 = (ins[k] for k in ("q3", "t3", "qk", "q6", "t6"))

    calls = {"dense_eth": lambda: knn.dense_nn_search(q3, t3),
             "dense_colour": lambda: knn.dense_nn_search(q6, t6)}
    for label, q, t, maxd in (("pruned_eth_10", qk, t3, cs.MAX_DISTANCE),
                              ("pruned_eth_0.01", qk, t3, 0.01),
                              ("pruned_colour_0.1", q6, t6, cs.TUM_MAX_DISTANCE)):
        index = knn.build_target_index(t, tile_t=knn.INDEX_TILE_T)
        bv = knn.bound_value(maxd)
        args = (q, index.points, knn.pruned_visit_mask(q, index, bv, knn.TILE_Q), bv)
        calls[label] = (lambda a: lambda: knn.pruned_nn_search(
            *a, tile_q=knn.TILE_Q, tile_t=knn.INDEX_TILE_T))(args)
    out = {"root": os.getcwd(), "ms": {}, "sha": {}}
    for name, fn in calls.items():
        idx, d2 = fn()
        out["sha"][name] = _result_sha(idx, d2)
        out["ms"][name] = cs.time_ms(fn, 5 if name.startswith("dense") else 20)
    cfgs = {"eth": ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                             selection=Selection.RANDOM, selection_proba=cs.SELECTION_P,
                             n_iterations=cs.N_ITERATIONS, max_distance=cs.MAX_DISTANCE),
            "colour": cs.tum_base_config(color_icp=True, multi_resolution=True,
                                         matching_checks=0)}
    ms = out["ms"]
    for call in ("cold", "warm"):
        for label, s_, t_ in (("eth", src, tgt), ("colour", frame, ctgt)):
            times = profiling.profile_stages(cfgs[label], s_, t_, repetitions=3, device=dev)
            ms[f"profile_{label}_wall_{call}"] = times.total_wall * 1e3
            if call == "warm":
                ms[f"profile_{label}_matching"] = times.matching * 1e3
                ms[f"profile_{label}_stages"] = 1e3 * (
                    times.selection + times.matching + times.weighting + times.rejection
                    + times.solver + times.convergence)
    return out


def main(runs_of: list[str], ablation: bool = False) -> int:
    """Run this file's worker once per checkout root in ``runs_of``, in
    order, each in its checkout (``ablation``: the ablation kernel's
    readings). Prints each worker's JSON line, then each reading by run."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    runs = []
    worker = [sys.executable, os.path.abspath(__file__), "--worker"] + ["--ablation"] * ablation
    for i, root in enumerate(runs_of):
        r = subprocess.run(worker, cwd=os.path.abspath(root), capture_output=True, text=True)
        lines = [line for line in r.stdout.splitlines() if line.startswith("{")]
        if r.returncode != 0 or not lines:
            print(f"run {i + 1} ({root}) failed, rc {r.returncode}:\n{r.stderr[-3000:]}")
            return 1
        runs.append(json.loads(lines[-1]))
        print(f"run {i + 1} ({root}): {lines[-1]}", flush=True)
    for name in runs[0]["ms"]:
        print(name, " | ".join(f"{root} {run['ms'][name]:.4f}"
                               for root, run in zip(runs_of, runs)))
    for name in runs[0]["sha"]:
        print(name, "same result in every run:", len({run["sha"][name] for run in runs}) == 1)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    ablation = "--ablation" in args
    args = [a for a in args if a != "--ablation"]
    if args[:1] == ["--worker"]:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(_worker(ablation)), flush=True)
    else:
        if not args:
            sys.exit(__doc__)
        sys.exit(main(args, ablation))
