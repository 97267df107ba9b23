"""The scaling-efficiency harness of the multi-rank path.

Run the same command on every rank, each with its own ``--proc-id``:

    # every rank of N:
    python -m icp_variants_tpu_torch.scripts.pod_scaling_bench --init file:///shared/rdzv \\
        --nprocs N --proc-id RANK
    # the one-rank baseline:
    python -m icp_variants_tpu_torch.scripts.pod_scaling_bench --single
    # a small rehearsal on the CPU:
    python -m icp_variants_tpu_torch.scripts.pod_scaling_bench --toy --device cpu ...

Under a launcher that sets ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
(``torchrun``) no coordinates are needed. ``--init`` also takes a bare
port (``tcp://127.0.0.1:PORT``).

The workload is the ETH headline (symmetric linear ICP, RANDOM p = 0.01,
squared max distance 10, kd matching where ``build_kd_for`` serves it)
over ``--pairs-per-host`` pairs a rank, with the mesh's ``pairs`` axis
spanning every rank (no collective in the run). The coordinator prints
one JSON line (the JAX package's ``scripts/pod_scaling_bench.py``
fields)::

    {"world": N, "pairs": B, "pairs_per_sec": X, "pairs_per_sec_per_host": X / N, ...}

Scaling efficiency is ``pairs_per_sec_per_host`` at N ranks over that of
one rank, from two invocations on the same kind of host. Ranks sharing
one card measure the card's sharing, not scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _pair(i, cap):
    """The JAX harness's pair ``i``: a synthetic ETH-scale target and its
    copy rotated by 0.03 + 0.004 i rad about z and shifted."""
    import numpy as np

    from chip_smoke import synth_cloud

    tgt_pts, tgt_nrm = synth_cloud(cap, 2 * i)
    ang = 0.03 + 0.004 * i
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    src_pts = (tgt_pts @ R.T + [0.2, -0.1, 0.05]).astype(np.float32)
    return src_pts, (tgt_nrm @ R.T).astype(np.float32), tgt_pts, tgt_nrm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", default=None, help="rendezvous: an init method or a port")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--single", action="store_true", help="no process group: one-rank baseline")
    ap.add_argument("--pairs-per-host", type=int, default=16)
    ap.add_argument("--cap", type=int, default=365_000)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--toy", action="store_true", help="small clouds and 5 iterations")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch
    import torch.distributed as dist

    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.core.device import resolve_device
    from icp_variants_tpu_torch.ops import kdtree
    from icp_variants_tpu_torch.parallel import distributed, sharded_icp
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer, Selection

    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    if not args.single:
        init = args.init
        if init is not None and init.isdigit():
            init = f"tcp://127.0.0.1:{init}"
        distributed.initialize(init, world_size=args.nprocs, rank=args.proc_id,
                               backend=args.backend, device=dev)
    world = distributed.process_count()
    mesh = distributed.global_mesh(points_per_pair=1, device=args.device)
    n_pairs = args.pairs_per_host * world
    cap, iters = (2048, 5) if args.toy else (args.cap, args.iters)
    cfg = ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                    selection=Selection.RANDOM, selection_proba=0.01, n_iterations=iters,
                    max_distance=10.0)

    # Replicated host data: the same seeds on every rank.
    pairs = [_pair(i, cap) for i in range(n_pairs)]
    sources = icp.stack_clouds([cloud_lib.from_numpy(sp, normals=sn, morton_order=True,
                                                     device="cpu") for sp, sn, _, _ in pairs])
    targets = icp.stack_clouds([cloud_lib.from_numpy(tp, normals=tn, morton_order=True,
                                                     device="cpu") for _, _, tp, tn in pairs])
    kds = [icp.build_kd_for(cfg, cloud_lib.Cloud(*(f[i] for f in targets)), device="cpu")
           for i in range(n_pairs)]
    kd_indexes = kdtree.stack_kd_indexes(kds) if all(k is not None for k in kds) else None
    sources, targets = sources.to(mesh.device), targets.to(mesh.device)
    if kd_indexes is not None:
        kd_indexes = kdtree.KDIndex(*(None if f is None else f.to(mesh.device)
                                      for f in kd_indexes))

    def run(seed):
        res = sharded_icp.run_icp_batch_sharded(cfg, sources, targets, mesh, seed=seed,
                                                kd_indexes=kd_indexes).result
        res.pose.cpu()
        if dist.is_initialized():
            dist.barrier()

    run(0)   # kernel loads and allocator warm-up
    t0 = time.perf_counter()
    for s in range(args.runs):
        run(s + 1)
    dt = (time.perf_counter() - t0) / (args.runs * n_pairs)
    if distributed.is_coordinator():
        print(json.dumps({
            "world": world, "pairs": n_pairs, "cap": cap, "iters": iters,
            "kd_path": kd_indexes is not None, "device": str(mesh.device),
            "pairs_per_sec": round(1.0 / dt, 4),
            "pairs_per_sec_per_host": round(1.0 / dt / world, 4),
        }), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
