"""CLI dispatcher: the two reference executables plus workload shortcuts.

    python -m icp_variants_tpu_torch bunny [--artifacts-dir out]
    python -m icp_variants_tpu_torch room <tum_dataset_dir> [--artifacts-dir out]
    python -m icp_variants_tpu_torch eth <pose_csv> [--max-pairs N] [--batch N]
    python -m icp_variants_tpu_torch experiments <config.csv> [--out-dir out]

Port of ``icp_variants_tpu.__main__``: the reference's `icp_variants`
(main.cpp) and `experiments` (experiment.cpp) binaries, with the same flags
and messages. Every command runs on ``--device`` (default ``cuda``, the
card; without one it raises unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import json
import sys


def _run_refine(args, cfg, res, eth) -> None:
    """`eth --refine`: pose-graph refinement over the sweep's sequential
    chain (+ optional odometry-proximity loop closures), reporting the
    odometry-vs-refined trajectory error against the CSV's composed GT
    relative poses. Uses the sharded CG refiner when more than one rank is
    up (a launcher such as ``torchrun`` started this command on each)."""
    import numpy as np
    import torch

    from icp_variants_tpu_torch.data.loaders import ETHDataLoader
    from icp_variants_tpu_torch.parallel import distributed
    from icp_variants_tpu_torch.parallel import pose_graph as pg

    mesh = None
    if distributed.initialize(device=args.device) and distributed.process_count() > 1:
        mesh = distributed.global_mesh(device=args.device)
        print(f"refine: sharded CG over {distributed.process_count()} ranks")
    odometry, refined, graph = eth.refine_trajectory(res, mesh=mesh, device=args.device)
    loader = ETHDataLoader(args.pose_csv, downsample=args.downsample, device=args.device)
    if args.loop_closure_radius > 0:
        # One capacity across the closure pairs, sized over the rows this
        # run's scans span (a --max-pairs run must not pad to the
        # dataset-wide max).
        n_rows = min(max(p.index for p in res.pairs) + 1,
                     loader.get_length())
        counts = loader.point_counts(max_pairs=n_rows)
        loader.capacity = int(-(-int(counts.max()) // 512) * 512)
        cands = eth.find_loop_closures(
            odometry, radius=args.loop_closure_radius)
        if cands:
            print(f"refine: registering {len(cands)} loop closures: {cands}")
            edges = eth.register_closures(loader, cands, cfg, odometry)
            odometry, refined, graph = eth.refine_trajectory(
                res, extra_edges=edges, mesh=mesh, device=args.device)
        else:
            print("refine: no loop-closure candidates within radius")
    # GT trajectory convention follows the CSV flavor (ETHDataLoader.h):
    # _local csvs store scans in their own frames and the pose column IS
    # the true reading->reference transform — compose it; _global csvs
    # store PRE-ALIGNED scans (the pose column only seeds the driver's
    # perturbation), so the true scan-to-scan transform is the identity
    # and the GT trajectory is all-identity.
    is_local = "_local" in args.pose_csv
    gt = [np.eye(4, dtype=np.float32)]
    for k in range(len(res.pairs)):
        step = (loader._gt_pose(res.pairs[k].index)
                if is_local else np.eye(4, dtype=np.float32))
        gt.append((gt[-1] @ step).astype(np.float32))

    def ate(traj):
        return float(np.sqrt(np.mean([
            np.sum((t[:3, 3] - g[:3, 3]) ** 2) for t, g in zip(traj, gt)
        ])))

    def edge_rms(traj):
        poses = torch.from_numpy(np.stack(traj).astype(np.float32)).to(graph.rel_poses.device)
        r = pg.edge_residuals(torch.zeros((poses.shape[0], 6), device=poses.device), poses,
                              graph).cpu().numpy()
        return float(np.sqrt(np.mean(r * r)))

    print(f"refine: {len(odometry)} poses, {graph.edge_i.shape[0]} edges")
    print(f"edge residual RMS: odometry {edge_rms(odometry):.6f} "
          f"-> refined {edge_rms(refined):.6f}")
    print(f"trajectory ATE vs GT ({'local' if is_local else 'global'} "
          f"convention): odometry {ate(odometry):.6f} m "
          f"-> refined {ate(refined):.6f} m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="icp_variants_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_device(p):
        p.add_argument(
            "--device", default="cuda",
            help="where the run happens: cuda (default; raises without a card) or cpu",
        )

    def add_common(p):
        add_device(p)
        p.add_argument(
            "--metric", type=int, default=0,
            help="0 point 1 plane 2 symmetric (reference); 3 gicp (Generalized-ICP extension)",
        )
        p.add_argument("--linear", action="store_true")
        p.add_argument(
            "--anderson-m", type=int, default=0,
            help="AA-ICP acceleration window (0 = plain ICP, reference "
            "parity; 2 reaches a given error in ~3x fewer iterations on "
            "smooth pairs, but terminal RMSE can end slightly worse — "
            "x1.08 on the tight-threshold bunny; see ROADMAP/PARITY)",
        )
        p.add_argument(
            "--selection", type=int, default=0,
            help="0 all 1 random Bernoulli(p) 2 random-fast (fixed-count "
            "extension); reference SELECTION_METHOD (main.cpp:24)",
        )
        p.add_argument(
            "--selection-proba", type=float, default=0.01,
            help="sampling probability for --selection 1/2 "
            "(reference uses 0.01, main.cpp:379)",
        )
        p.add_argument(
            "--weighting", type=int, default=0,
            help="0 constant 1 distances 2 normals 3 colors (reference "
            "modes); 4 Huber 5 Tukey (robust M-estimator extensions, "
            "MAD-adaptive scale)",
        )
        p.add_argument(
            "--trim-ratio", type=float, default=1.0,
            help="Trimmed ICP: keep only this fraction of matches (best "
            "by distance) each iteration — robust to partial overlap "
            "(1.0 = off, reference parity)",
        )
        p.add_argument(
            "--iterations", type=int, default=0,
            help="override the workload's default ICP iteration count "
            "(0 = keep the reference default)",
        )
        p.add_argument(
            "--matching-checks", type=int, default=0,
            help="APPROXIMATE kd matching: bound each query's candidate "
            "budget to ~this many target points and skip the exactness "
            "certificate — FLANN SearchParams(checks) parity (the "
            "reference runs checks=16, NearestNeighbor.h:134). 0 = exact "
            "(default). Only the kd-indexed matching path honors it; see "
            "PARITY.md 'Approximate matching arm'",
        )

    b = sub.add_parser("bunny", help="align the Stanford bunny pair")
    add_common(b)
    b.add_argument("--artifacts-dir")
    b.add_argument(
        "--profile", action="store_true",
        help="print the fused per-stage TimeMeasure + kernel efficiency",
    )

    r = sub.add_parser("room", help="TUM RGB-D frame-to-frame-0 tracking")
    r.add_argument("dataset_dir")
    add_common(r)
    r.add_argument("--projective", action="store_true")
    r.add_argument("--frame-step", type=int, default=10)
    r.add_argument("--max-frames", type=int, default=10)
    r.add_argument("--artifacts-dir")

    e = sub.add_parser("eth", help="ETH registration benchmark sweep")
    e.add_argument("pose_csv")
    add_common(e)
    e.add_argument("--max-pairs", type=int)
    e.add_argument("--batch", type=int, default=0, help=">0: batched runner")
    e.add_argument("--pose-scaling", type=float, default=0.1)
    e.add_argument(
        "--downsample", type=int,
        help="load-time stride subsampling of huge clouds (extension)",
    )
    e.add_argument(
        "--checkpoint-dir",
        help="batched runner: write per-batch sweep checkpoints here and "
        "resume a crashed run from the first incomplete batch",
    )
    e.add_argument(
        "--refine", action="store_true",
        help="pose-graph refinement over the sweep's sequential chain "
        "(parallel/pose_graph — the global-consistency capstone the "
        "reference lacks): chain the per-pair poses into a trajectory, "
        "jointly refine, and print odometry-vs-refined trajectory error "
        "against the CSV ground truth",
    )
    e.add_argument(
        "--loop-closure-radius", type=float, default=0.0,
        help="with --refine: also register loop-closure edges between "
        "non-adjacent scans whose odometry positions sit within this "
        "many meters (0 = chain only)",
    )

    x = sub.add_parser("experiments", help="CSV config-matrix sweep")
    x.add_argument("config_csv")
    x.add_argument("--out-dir", default="out")
    x.add_argument("--room-data-dir")
    x.add_argument("--eth-csv-path")
    x.add_argument("--max-pairs", type=int)
    add_device(x)

    args = ap.parse_args(argv)

    from icp_variants_tpu_torch.pipeline.config import (
        Metric, Minimizer, Selection, Weighting,
    )

    def mm(metric, linear):
        d = dict(
            metric=Metric(metric),
            minimizer=Minimizer.LINEAR if linear else Minimizer.NONLINEAR_LM,
        )
        if getattr(args, "selection", 0):
            d["selection"] = Selection(args.selection)
            d["selection_proba"] = args.selection_proba
        if getattr(args, "anderson_m", 0):
            d["anderson_m"] = args.anderson_m
        if getattr(args, "trim_ratio", 1.0) < 1.0:
            d["trim_ratio"] = args.trim_ratio
        if getattr(args, "weighting", 0):
            d["weighting"] = Weighting(args.weighting)
        if getattr(args, "matching_checks", 0):
            d["matching_checks"] = args.matching_checks
        if getattr(args, "iterations", 0):
            d["n_iterations"] = args.iterations
        return d

    if args.cmd == "bunny":
        from icp_variants_tpu_torch.workloads import bunny

        cfg = bunny.default_config(**mm(args.metric, args.linear))
        res = bunny.align_bunny(cfg, artifacts_dir=args.artifacts_dir, device=args.device)
        for i, v in enumerate(res.rmse_per_iteration):
            print(f"  {i:02d}  {v:.6f}")
        print("final RMSE:", res.final_rmse)
        if args.profile:
            from icp_variants_tpu_torch.data.loaders import BunnyDataLoader
            from icp_variants_tpu_torch.pipeline import profiling

            sample = BunnyDataLoader(device=args.device).get_item(0)
            print(profiling.fused_report(cfg, sample.source, sample.target, device=args.device))
        return 0

    if args.cmd == "room":
        from icp_variants_tpu_torch.pipeline.config import Matching
        from icp_variants_tpu_torch.workloads import room

        cfg = room.default_config(
            **mm(args.metric, args.linear),
            matching=Matching.PROJECTIVE if args.projective else Matching.KNN,
        )
        res = room.reconstruct_room(
            args.dataset_dir, cfg, frame_step=args.frame_step,
            max_frames=args.max_frames, artifacts_dir=args.artifacts_dir,
            device=args.device,
        )
        for i, (a, b_) in enumerate(zip(res.initial_rmse, res.final_rmse)):
            print(f"frame {i}: rmse {a:.5f} -> {b_:.5f}")
        return 0

    if args.cmd == "eth":
        from icp_variants_tpu_torch.workloads import eth

        cfg = eth.default_config(**mm(args.metric, args.linear))
        if args.batch > 0:
            res = eth.align_eth_batch(
                args.pose_csv, cfg, pose_scaling=args.pose_scaling,
                max_pairs=args.max_pairs, batch_size=args.batch,
                downsample=args.downsample,
                checkpoint_dir=args.checkpoint_dir, device=args.device,
            )
        else:
            if args.checkpoint_dir:
                raise SystemExit(
                    "--checkpoint-dir requires the batched runner: "
                    "add --batch N (the sequential path has no "
                    "checkpointing and would silently ignore the flag)"
                )
            res = eth.align_eth(
                args.pose_csv, cfg, pose_scaling=args.pose_scaling,
                downsample=args.downsample,
                max_pairs=args.max_pairs, device=args.device,
            )
        for p in res.pairs:
            print(f"pair {p.index}: benchmark {p.initial_error:.5f} -> {p.final_error:.5f}")
        print("min error", res.min_error, "at", res.index_min_error)
        if args.refine:
            _run_refine(args, cfg, res, eth)
        return 0

    if args.cmd == "experiments":
        from icp_variants_tpu_torch.workloads import experiments

        s = experiments.run_experiments(
            args.config_csv, out_dir=args.out_dir,
            room_data_dir=args.room_data_dir, eth_csv_path=args.eth_csv_path,
            max_pairs=args.max_pairs, device=args.device,
        )
        print(json.dumps(s, indent=2))
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
