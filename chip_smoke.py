#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``icp_variants_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # the full run, fifteen to nineteen minutes

Phases, in order; any failure exits nonzero:

1. Set-up: fail at once without a CUDA device; TF32 off for matmul and
   cuDNN; the card's name and power limit; build the ten kernels from
   ``icp_variants_tpu_torch/csrc`` (nvcc, one per source in parallel) and
   print the time.
2. ETH kernels (D = 3): each kernel against its plain PyTorch version at
   the ETH path's shapes (16 pairs x 4,352 queries on 365,056-point
   targets), plus the fallback search and the exact-arm matcher against
   scipy's cKDTree. Median times of kernel and plain version, CUDA events.
   kd_block_search's lane use at k = 4 from its measurement build
   (``resident_bench.lane_use``; that build's result equal to the
   production one's).
3. The ETH path: ``run_icp_batch`` on the ETH headline configuration
   (symmetric linear ICP, p = 0.01 Bernoulli selection, max squared
   distance 10, 50 iterations) over 16 synthetic pairs of 365,000 points,
   both matching arms (exact: top-4 blocks + certificate + fallback;
   FLANN-parity: checks=16). One warm-up run per arm, then timed runs per
   arm taken in turns (median pairs/s; launches counted on each arm's
   first); the mean translation / rotation error against the known
   perturbations, gated at 1 cm and at 0.01 mm, and each arm's matcher at
   pair 0's final pose against cKDTree. One profiled run per arm.
4. The colour path: the dense colour-multires tracker (the JAX package's
   ``bench.bench_color_multires`` / ``measure_color_accuracy``): 8
   synthetic 640 x 480 RGB-D frames (307,200 rows each, 6-dim colour
   Morton order) tracked against frame 0 by
   ``run_icp_batch_multires_segmented``: point-to-plane linear ICP, 35
   iterations, squared max distance 0.1 in the 6-dim feature space,
   SELECT_ALL; exact arm (128 kd blocks, warm start) and checks16 arm (256
   kd blocks, the stride-1 level seeded from the stride-2 level's blocks).
   A warm-up run per arm; then every kernel at D = 6 against its plain
   version (kd_radius_search at k = 0 on one frame's warm radii) at the
   full fine-level shapes, 8 x 307,200 rows at the warm-up's final poses
   (-1 rows included; the plain versions in windows of rows;
   visited_search at the exact arm's real fallback radii, and all rows live
   on a subset), each timed there, kd_block_search's lane use read as in
   phase 2, cached_block_search's time split by launch (bucketing, walk,
   out; ``torch.profiler``); then timed runs in turns (median
   frames/s, launches on each arm's first), one profiled run per arm, the
   mean translation / rotation error against the known camera shifts
   (gated at 1 cm and at a tighter gate set from the card's readings), the
   exact arm's warm run against one cold run (equal match counts per
   iteration, poses within rtol 1e-4 / atol 1e-5), at
   frame 0's final pose each arm's matcher against cKDTree over the 6-dim
   target features, and the fixed point: one more stride-1 step at each
   arm's final pose, solved in f64 on the same matches, must barely move
   any frame. Two probes read the gates' reach: the checks16 arm with TF32
   on (since ``csrc/normal_equations.cu`` sums the normal equations in f32,
   TF32 reaches only the pose products), and with a planted fault in the
   seeded search, which must cross a gate.
5. The projective path: the projective RGB-D tracker (the JAX package's
   ``bench.bench_tum_projective`` and the room run's solver): frames 1-8
   stride-8 compacted (38,400 rows) tracked against frame 0 kept
   image-shaped (640 x 480) by ``run_icp_batch``, window +-12 px, 35
   iterations, squared max distance 0.1; arms linear point-to-plane and LM
   point-to-point. The window search against its plain version on every
   row at the identity pose, at the linear warm-up's final poses and on 512
   rows per frame at and past the image edges, timed there and split by
   cause (window loads, from the ``-DPWS_LOADS_ONLY`` build, and
   distances); against a float64 window scan on 4,096 rows of frame 0;
   timed runs in turns
   (median frames/s, launches on each arm's first), one profiled run per
   arm; gates: mean t_err within 2 cm, every frame's final translation
   within 2e-5 m of the JAX package's CPU reading, and the fixed point (one
   more step at the final pose, solved in f64 -- scipy's least_squares for
   the LM arm -- within a gate set from the card's readings). A planted
   fault (every 8th match moved one pixel along its row) must cross both.
5b. The linear solvers' normal equations (``csrc/normal_equations.cu``)
   at the colour (8 x 307,200 rows, point-to-plane), projective (64 x
   38,400, point-to-plane) and ETH (176 x 4,352, symmetric) shapes, on
   synthetic rows with NaN and inf normals, zero weights and invalid rows:
   against a float64 sum of the same rows (gated at 1e-5 of the terms'
   magnitudes), two launches equal bit for bit, its ms a launch (queued
   CUDA events, and the profiler's kernel time) beside its byte bound, the
   plain version on the card (column stacks and batched cuBLAS products)
   and those products alone (``library_ms``).
5c. The linear solvers' tail (``csrc/pose_step.cu``: the 6 x 6 solve and
   the increment's recovery) at the colour (8 pairs, point-to-plane),
   projective (64, point-to-plane) and ETH (176, symmetric) batches, on
   phase 5b's normal equations: the increment within 4 f32 ulps of each
   entry's magnitude of the plain version run in float64 on the same f32
   inputs, two launches equal bit for bit, its ms a launch (queued CUDA
   events, and the profiler's kernel time; at most 10 us at the ETH batch)
   beside the plain version on the card (its device ms queued, its host ms
   a call and its kernels a call), and each side's host ms a call.
6. The dense exact path past the resident rule: 4 pairs of 1,000,000-point
   indoor scans (``bench.make_indoor_pairs``' scene, source and target
   sampled independently, ~70% overlap), symmetric linear ICP, SELECT_ALL,
   exact arm, squared max distance 10, 50 iterations, warm start on, kd
   indexes of 512 blocks x 2,048 slots built by the caller and passed to
   ``run_icp_batch`` (``build_kd_for`` gives None past the rule): the warm
   matcher's route through box_topk + kd_radius_search. One warm-up run,
   one cold run (``kd_warm_start=False``) that the warm runs must equal
   (match counts per iteration, poses within rtol 1e-4 / atol 1e-5) up to
   exact ties: the warm-up and the cold run with each iteration's matches
   and counted rows recorded, equal bit for bit until the first iteration
   where some row's matches differ, every such row there an exact f32
   tie, and every row counted differently after it within the runs'
   measured rounding of a tie, the distance bound or the angle threshold
   (``warm_cold_parting``); 3
   timed warm runs (median pairs/s) and a profiled one; box_topk (512
   blocks, k = 4) against its plain version on every row at the first
   iteration's radii, and timed there; kd_radius_search
   against its plain version on every row at the first iteration's radii
   and at the final pose's cached radii (k = 4) and on pair 0 at k = 0;
   visited_search at the fallback's real inputs (the rows whose
   certificate fails at the final pose's cached radii at the bound, the
   rest frozen) against its plain version on every live row, timed there;
   pair 0's warm matcher at its final pose against cKDTree on all rows; the
   mean error against the true poses under a gross gate. Then one
   600,000-point pair, whose table the JAX package serves in its packed
   mode: two match_kd_warm calls and kd_block_search against its plain
   version on every row.
7. The dense and tile-pruned matchers and the seeded search's pose mode:
   dense_nn_search (the matcher behind ``knn.match``) on ETH pair 0 as
   ``profile_stages`` feeds it (365,056 rows, p = 0.01 mask-based,
   unselected rows at the pad sentinel, D = 3) and on colour frame 1
   against frame 0 (D = 6), each against its plain version on every row
   and against cKDTree on the selected rows within the expansion's
   rounding; ``profile_stages`` on the ETH headline and colour configs
   (its report printed; the kernel launched 4 times per call);
   pruned_nn_search (``nn_search_pruned``) on pair 0's selected queries
   at max_distance 10 and 0.01 and on the colour frame at 0.1, against its
   plain version and cKDTree; each of these five readings beside its bound
   and the rounding contract's issue floor (2D + 2 instructions a pair),
   split by launch (``kernel_split``), with the rescans counted by the
   ``-DNN_RESCAN_COUNT`` build and one profiled call attributed to its
   kernel (``device_ms_by_port_kernel``); cached_block_search's pose mode at the
   colour checks16 arm's fine level (raw features, the warm-up's final
   poses) against its plain version and transform-then-search, its time
   split by launch.
8. Tooling: the measurement tools at full width. The fused stage profiler
   (``profiling.fused_report``: the driver's ``stop_after`` probes, stage
   differencing on the host's clock and on the card's kernel time, the
   work model) on ETH pair 0 under the headline configuration at 10
   iterations, both arms, 3 repetitions; its report printed, the host stage sum held to at most
   1.5 x the full run + 0.05 s and the matching stage's kernel time
   above 0. TPU kernel 8, the visited-list ablation
   (``scripts.knn_ablate``, kernel ``visited_ablate``) on the JAX
   script's inputs (4,736 query slots of the 365,000-point cloud rotated
   and moved, in 19 tiles of 256, against its 713 target tiles of 512,
   chunk 8, squared bound 10): every mode against its plain version (the
   exact modes bit for bit, dmaonly (bound, -1), default and high within
   the order bound of their own plain version in d2 and idx, and within
   their TF32 bounds of the exact result), full against cKDTree, every mode timed (median of
   20) beside the production visited_search on the same queries; the
   kernel runs one thread block cluster per query tile: the cluster's
   size, the clusters resident at once, each mode's issue floor (its
   instructions a (row, column) stated) and the chain floor of the
   longest walk printed, the ``-DABL_COUNT`` build's chunks scored by
   every CTA of every tile's cluster held equal to the plain version's in
   every mode. The kd
   block search's probe decomposition (``scripts.resident_bench``) at the
   ETH shapes (16 pairs x 4,736 queries, k = 4): box_topk, the probe and
   the full search timed; the probe writes (binit, -1) on every row and the
   full search equals its plain version.
9. Register: the solvers, normals and one-call API on real data and at
   ETH scale. The repository's bunny halves (``assets/bunny``) through
   ``workloads.bunny.align_bunny`` on the card in five configurations (the
   default LM point-to-point, linear point-to-point, linear GICP, LM GICP,
   LM point-to-point with Anderson acceleration m = 2) and through
   ``api.register`` with no normals (dense k-NN PCA normals on the card):
   each final pose within a stated gap of the JAX package's CPU reading
   (``scripts/bunny_reference_cpu.py``, kept as constants here), its final
   RMSE under tests/test_icp_bunny.py's bound and within 10% of JAX's,
   visited_search launched every iteration and named in a profile; the
   default run's final-iteration queries through visited_search equal to
   its plain version. ``api.register`` on ETH pair 0 (365,000 points, no
   normals) under the headline configuration's exact arm: the normals'
   seconds on the card (median of 3), their k = 5 neighbours against
   cKDTree (ties counted), their angle to a float64 PCA; the call's, the kd
   build's and the run's seconds; the pose against the true one (1 cm and
   0.01 mm); box_topk, kd_block_search and visited_search named in the
   run's profile. The 16-pair ETH batch (exact arm) under linear
   point-to-point, linear GICP, LM GICP and symmetric with Anderson
   acceleration (m = 2): pairs/s (median of 3 timed runs), busy share,
   launches a run, the host syncs of one run by source line
   (``torch.cuda.set_sync_debug_mode``), the mean error gated (1 cm; 10 cm
   for point-to-point, which slides along the sheets), and the f32 solve
   of one more iteration at the final pose against a float64 numpy solve
   of the same matches.
10. Entry points from files: the port's CLI (``__main__.main``, in-process)
   on files written under a temporary directory. ``eth <csv> --batch 16
   --max-pairs 16 --metric 2 --linear --selection 1`` (the headline
   configuration, with ``--refine``, under the profiler's device
   activity) over 17 scans of one 365,000-point scene, pre-aligned as in
   ``plain_global.csv`` (15 binary and 2 ASCII PCD files; row k registers
   scan k+1 onto scan k, its pose ``eth_true_pose(k)``): the sweep's wall
   and pairs/s end to end, the host seconds of the parse, normals, kd
   builds and perturbation and how much of them the prefetch hid, the busy
   share, launches, each pair's benchmark error, odometry and refined ATE;
   gates: every final error below its initial one, the final poses and
   benchmark curves equal bit for bit to a direct ``run_icp_batch`` on the
   same clouds and kd indexes (read sequentially on the main thread) with
   the same generator seed, every kd index built by the port's
   ``libicpio.so`` partition. ``--batch 4 --max-pairs 8
   --checkpoint-dir``, twice: the second run resumes all and registers
   nothing; the first's batch 1 normals (the prefetch worker's stream)
   overlap batch 0's run on the card. ``room`` on 11 TUM frames of
   ``synth_depth_frame`` written as PNGs, k-NN and ``--projective`` (8
   frames tracked each) and ``--projective --artifacts-dir`` (2 frames and
   their meshes): every final RMSE below the initial. The pose graph of
   the ``--refine`` run's edges, with one edge drifted and two loop
   closures, refined on the card against a float64 Gauss-Newton
   (``pose_graph_check``). ``experiments assets/experiment.csv``
   (3 bunny rows, 1 room row) and ``bunny --artifacts-dir``: the error
   files and artifacts read back.
11. The multi-device path (``parallel/sharded_icp``, ``parallel/distributed``,
   ``pose_graph.refine_sharded``): the port's per-rank worker
   (``scripts/multihost_rehearsal.py``) as separate processes on the one
   card, on phase 3's pairs, kd indexes and draws written as numpy under a
   temporary directory (the ETH headline's exact arm, 16 pairs x 365,056
   rows x 50 iterations, every 64th source row a ground-truth row): a world
   of one (nccl, mesh 1 x 1) equal to the unsharded run bit for bit; a
   world of two (gloo on the card) with mesh pairs 1 x points 2 (each rank
   182,528 query rows a pair against the whole targets, fed phase 3's own
   draws split by shard: iteration 0's match counts equal, poses within
   rtol 1e-3 / atol 5e-5, mean translation error within 0.01 mm, both
   ranks bit-identical) and pairs 2 x points 1 (8 pairs a rank; case 2's
   gates: ``torch.sum`` over the query rows takes another order at 8 pairs,
   ``scripts/batch_parting.py``); a shard of padding only (2 pairs of 256 source rows over two
   points shards, SELECT_ALL): box_topk, kd_block_search and
   visited_search launch on it and return misses; ``refine_sharded`` of
   phase 10's pose graph on two ranks within 1e-4 / 1e-5 of the
   single-device refine and within phase 10's gate of the float64 solve.
   Per rank and case: each kernel's launches, the collectives an
   iteration, the wall (two ranks sharing one card: not a scaling figure).
12. The record: launches of each kernel on the main paths (the ETH, colour,
   projective, dense, register, entry-point and sharded runs, the profile path); fails unless each ran
   where its path needs it (pruned_nn_search and the pose mode, on no
   pipeline path, count phase 7's direct calls, and the ablation kernel and
   the block search's probe phase 8's checked calls, read from the
   wrappers' counts).

It prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
power limit line, and as its last line ``{"ok": true, "device": {...}}``.
The synthetic data (``synth_cloud``, ``eth_true_pose``, ``make_pairs``,
``synth_depth_frame``, ``prepare_tum_state``, ``projective_state``,
``tum_base_config``, ``synth_indoor_cloud``, ``make_indoor_pairs``) are
copies of ``bench.py``'s, with the same seeds; this script imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import collections
import functools
import json
import math
import subprocess
import sys
import time

import numpy as np

N_POINTS = 365_000
N_ITERATIONS = 50
SELECTION_P = 0.01
MAX_DISTANCE = 10.0
BATCH_PAIRS = 16
CHECKS_APPROX = 16
# Timed main-path runs per arm: the host clock of a one-card machine that
# shares its host's cores varies run to run; the median is reported. Three
# keep the script within its time limit.
N_TIMED_RUNS = 3
# Peak rates of one H100 SXM (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM bandwidth. Every f32 operation counts as one here.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Cycles the card sleeps before queued_ms' first timed call (~50 ms at the
# H100's clock), so the host has queued them all when the timing starts.
QUEUE_SLEEP_CYCLES = 90_000_000
# Dense TF32 tensor-core peak of the same card (data sheet).
PEAK_TF32_OPS = 495e12
# Late in a long run (phase 7, eight minutes in) a profiled window of tens
# of ms lost some or all of its kernels. The likely cause, not isolated:
# torch.profiler keeps the kernels whose GPU timestamps, converted to the
# host's clock, fall inside the window, and the conversion drifts. Each
# profile pads its window by this many seconds on each side.
PROFILE_PAD_S = 2.0
# The launches of cached_block_search, as kernel_split names them.
CACHED_PARTS = ("bin", "scan", "scatter", "walk", "out")
# Mean translation error gates: 1 cm for a gross failure, and 0.01 mm,
# set from the card's readings (about 0.0003 mm on both arms): a TF32 solve
# or a matcher fault in a later iteration moves the error past it.
T_ERR_LIMIT_M = 0.01
T_ERR_TIGHT_M = 1e-5

# The colour-multires tracker (bench.py:359-365, main.cpp:236-266).
TUM_W, TUM_H = 640, 480
TUM_FX = TUM_FY = 525.0
TUM_CX, TUM_CY = 319.5, 239.5
TUM_ITERATIONS = 35
TUM_MAX_DISTANCE = 0.1
TUM_BATCH_FRAMES = 8
TUM_SHIFT = 0.01
# Mean translation error gates of the colour arms: 1 cm for a gross
# failure, and 1.2 mm, set from the card's readings (0.995 mm exact, 0.957
# mm checks16; the JAX package's TPU record is about 1 mm on both). That
# error is the algorithm's own on these frames (a planted matcher fault
# read 1.01 mm), so the tight gate is the fixed point's: one more stride-1
# step at each arm's final pose, solved in f64 on the same matches, must
# move no frame by more than FIXED_POINT_T_M (card readings 1.0e-7 m on
# both arms; the planted fault read 2.6e-4 m), and the f32 solve of that
# step must agree with the f64 one within SOLVE_GAP_T_M (readings 4e-8 to
# 6e-8).
COLOR_T_ERR_TIGHT_M = 1.2e-3
FIXED_POINT_T_M = 1e-6
SOLVE_GAP_T_M = 1e-6
# The projective RGB-D tracker (bench.py:399-437, 470-492; room.py:30-42;
# main.cpp:183-341): frames 1-8 stride-8 compacted against frame 0
# image-shaped, window +-12 px; arms "linear" (point-to-plane, the bench's
# config 2) and "lm" (point-to-point LM, the room run's solver).
PROJ_SOURCE_STRIDE = 8
PROJ_WINDOW = 12
# Rows per frame in each step of the window search's plain version (one
# unchunked call over 8 x 38,400 rows would build 8.5 GB of candidates).
PROJ_PLAIN_ROWS = 4096
# Rows of frame 0 held against the float64 window scan.
PROJ_CHECK_ROWS = 4096
# The JAX package's reading of both arms on these frames, on the CPU
# (scripts/projective_reference_cpu.py: bench.prepare_tum_state's frames
# through icp.run_icp_batch): per-frame final translations (m) and the mean
# translation error against the camera shifts.
JAX_PROJECTIVE_T = {
    "linear": [
        [-0.000824596150778234, -0.00017086898151319474, 0.00010577329521765932],
        [-0.01259005069732666, -0.0001584840501891449, 8.491001790389419e-05],
        [-0.02115204930305481, -0.0002101334248436615, 6.318125815596431e-05],
        [-0.033163025975227356, -0.00015084388724062592, 6.335569923976436e-05],
        [-0.04018717259168625, -0.00019821910245809704, 0.0001048662670655176],
        [-0.047395169734954834, 0.0011494369246065617, 0.000103008933365345],
        [-0.054646484553813934, -0.00031858484726399183, 0.00014559004921466112],
        [-0.0613694041967392, 0.0015484971227124333, 0.00015447793703060597],
    ],
    "lm": [
        [-0.0005392316961660981, -0.0001619825343368575, 0.00011009873560396954],
        [-0.00931607000529766, -0.0002202578034484759, 8.163996244547889e-05],
        [-0.019270656630396843, -0.00020040081290062517, 0.00011019577505066991],
        [-0.029788030311465263, -0.0001868590625235811, 9.08260844880715e-05],
        [-0.03645975515246391, -0.0002254370047012344, 0.00011839060607599095],
        [-0.04344067722558975, -0.0002837468055076897, 0.00010706387547543272],
        [-0.04967668280005455, -0.000335970486048609, 0.00013968600251246244],
        [-0.0561363585293293, 0.0013692397624254227, 0.00015305385750252753],
    ],
}
JAX_PROJECTIVE_T_ERR_M = {"linear": 0.011084005849552343, "lm": 0.01442156720615458}
# Gates of the projective arms. The mean translation error is the
# algorithm's own on these frames (the JAX package reads 11.1 / 14.4 mm:
# projective correspondences slide on the smooth surface), so the gross
# gate sits at 2 cm, below the 45 mm of no tracking at all. The tight gates
# are set from the card's readings (NVIDIA H100 80GB HBM3, 700 W): every
# frame's final translation within PROJ_JAX_GAP_M of the JAX package's
# (readings 3.5e-6 m linear, 1.5e-6 m LM), and the fixed point: one more
# step at the final pose, solved in f64, moves no frame by more than
# PROJ_FIXED_POINT_T_M (readings 0.462 / 0.511 mm: after 35 iterations the
# far frames still move, so this bounds the last step; a planted matcher
# fault read 0.952 / 2.091 mm and a 1.1 cm gap to the JAX reading).
PROJ_T_ERR_LIMIT_M = 0.02
PROJ_JAX_GAP_M = 2e-5
PROJ_FIXED_POINT_T_M = {"linear": 6e-4, "lm": 7e-4}
# Rows per frame in each window of a plain version's pass over the full
# 8 x 307,200 rows (one unwindowed call of the plain kd_block_search would
# gather 570 GB).
PLAIN_CHUNK_ROWS = 2048
# Rows per frame of the all-live visited_search comparison: four windows
# of 512 consecutive rows (all rows live at full size is impractical).
SUBSET_WINDOW, SUBSET_WINDOWS = 512, 4
# The dense exact path past the resident rule: bench.make_indoor_pairs'
# scene at 1,000,000 points a cloud (a 512 x 2,048 kd table: past both of
# the JAX package's resident layouts), and one 600,000-point pair (256 x
# 2,432, where the JAX package takes its packed layout).
DENSE_POINTS = 1_000_000
DENSE_PAIRS = 4
DENSE_PACKED_POINTS = 600_000
# Gross gates on the dense path's mean errors against the true poses, set
# from the card's readings (NVIDIA H100 80GB HBM3, 700 W: 16.44 mm and
# 0.0152 deg; per pair 14.9-17.5 mm). The error is the algorithm's own: the
# source and target are sampled independently and overlap ~70%, and every
# source point within sqrt(10) m of the target matches. The tight gate of
# this path is warm against cold.
DENSE_T_ERR_LIMIT_M = 0.025
DENSE_R_ERR_LIMIT_DEG = 0.05

# Phase 8: repetitions of each fused-profile run (after one warm-up) and the
# iterations of each of its runs (its report is per iteration; 10, not the
# main path's 50, keep the script within its limit), the JAX ablation
# script's query slots and stratified draws, and the launches each ablation
# mode and probe is timed over (median).
FUSED_REPS = 3
FUSED_ITERATIONS = 10
ABLATE_SLOTS = 4736
ABLATE_DRAWS = 3651
ABLATE_REPS = 20

# Phase 9: the bunny runs (main.cpp:43-181, workloads/bunny.py) on the
# repository's bunny halves, the configuration changes of each run, and
# the JAX package's CPU reading of the same runs
# (scripts/bunny_reference_cpu.py): final pose and RMSE.
BUNNY_RUNS = {
    "default": {},
    "p2p_linear": {"minimizer": "LINEAR"},
    "gicp_linear": {"metric": "GICP", "minimizer": "LINEAR"},
    "gicp_lm": {"metric": "GICP"},
    "p2p_lm_aa2": {"anderson_m": 2},
    "register": {},
}
JAX_BUNNY = {
    "default": dict(final_rmse=0.003453620010986924, pose=[
        [0.9872665405273438, -0.1488410383462906, -0.05613647401332855, -0.01761474832892418],
        [0.14813953638076782, 0.9888289570808411, -0.016479967162013054, -0.002884984016418457],
        [0.0579623319208622, 0.007954071275889874, 0.9982869625091553, -0.0003888396895490587],
        [0.0, 0.0, 0.0, 1.0],
    ]),
    "p2p_linear": dict(final_rmse=0.003448997624218464, pose=[
        [0.9872596859931946, -0.14889726042747498, -0.05612589791417122, -0.017604265362024307],
        [0.14819997549057007, 0.988821268081665, -0.01640845462679863, -0.002881802385672927],
        [0.05794167518615723, 0.007881534285843372, 0.9982901811599731, -0.0003844788298010826],
        [0.0, 0.0, 0.0, 1.0],
    ]),
    "gicp_linear": dict(final_rmse=1.3066825886198785e-05, pose=[
        [0.9773380160331726, -0.21168531477451324, -0.00026260834420099854, -0.01514597050845623],
        [0.2116851806640625, 0.9773378968238831, -0.00045944092562422156, -0.003262351965531707],
        [0.0003538957389537245, 0.0003934321866836399, 0.9999999403953552, -3.711440513143316e-05],
        [0.0, 0.0, 0.0, 1.0],
    ]),
    "gicp_lm": dict(final_rmse=1.3064039194432553e-05, pose=[
        [0.9773378372192383, -0.21168527007102966, -0.000262603658484295, -0.015145968645811081],
        [0.2116851508617401, 0.9773378372192383, -0.0004593372286763042, -0.003262351732701063],
        [0.00035388863761909306, 0.00039334886241704226, 0.9999998807907104, -3.710365854203701e-05],
        [0.0, 0.0, 0.0, 1.0],
    ]),
    "p2p_lm_aa2": dict(final_rmse=0.0037412471137940884, pose=[
        [0.9865747094154358, -0.14977754652500153, -0.06509263068437576, -0.0177441593259573],
        [0.1486954241991043, 0.9886559844017029, -0.021190010011196136, -0.0029613899532705545],
        [0.06752800196409225, 0.011226549744606018, 0.9976541996002197, -0.0007733700913377106],
        [0.0, 0.0, 0.0, 1.0],
    ]),
    "register": dict(final_rmse=0.0027777282521128654, pose=[
        [0.9871582388877869, -0.15631495416164398, -0.032922033220529556, -0.017048504203557968],
        [0.1552211046218872, 0.9873109459877014, -0.03352217376232147, -0.002218785462900996],
        [0.037744347006082535, 0.027981530874967575, 0.9988954067230225, -0.0015794631326571107],
        [0.0, 0.0, 0.0, 1.0],
    ]),
}
# Largest entry gap between a bunny run's final pose on the card and the
# JAX package's CPU reading, and the final RMSE's relative gap to it. JAX's
# CPU matcher sums the expansion, the card's visited_search direct
# differences (ROADMAP.md queue 3), so a few rows match differently. The
# point-to-point runs have not converged after 20 iterations (they slide
# along the halves), so a small change early moves the final pose along
# that slide: with Anderson acceleration, whose extrapolation amplifies the
# LM solves' f32 rounding (its step alone agrees with JAX's to 1e-8 on the
# same inputs), and in register, whose PCA normals come from the card's
# sqrt / acos / cos and flip the normal-angle rejection of a few rows. The
# gaps are set from the port's CPU readings (scripts/bunny_reference_cpu.py
# --port: 1.4e-4 default, 8.0e-5 p2p_linear, 6e-8 / 1.8e-7 GICP, 1.1e-3
# Anderson, 1.1e-5 register) and the card's (NVIDIA H100 80GB HBM3, 700 W:
# 1.38e-4, 8.1e-5, 1.2e-7, 1.8e-7, 7.7e-3, 1.85e-3; final RMSE within
# 0.2% / 0.03% / 0.02% / 0.002% / 2.6% / 2.4% of JAX's).
BUNNY_JAX_GAP = {"default": 1e-3, "p2p_linear": 1e-3, "gicp_linear": 1e-5, "gicp_lm": 1e-5,
                 "p2p_lm_aa2": 2e-2, "register": 1e-2}
BUNNY_RMSE_RTOL = 0.1
# tests/test_icp_bunny.py's CONVERGED_RMSE for the metric (GICP: the plane
# metrics' bound; it converges to about 1.3e-5).
BUNNY_CONVERGED_RMSE = {"POINT_TO_POINT": 5.0e-3, "GICP": 1.0e-3}
# register at ETH scale: the PCA normals' neighbourhoods whose relative
# eigen-gap (l2 - l1) / l3 lies below this floor are skipped in the angle
# check, and the largest angle allowed between the card's normal and a
# float64 PCA over the same neighbours elsewhere. The f32 covariance of 5
# points ~0.1 m apart at 20 m from the origin carries a relative error of
# ~1e-5 (the centring's rounding), and the eigenvector's error is that over
# the gap: the port's CPU reading on pair 0's source is 0.031 deg at most
# over the 364,443 rows at a floor of 1e-2 (0.185 deg at 1e-3, 1.3 deg at
# 1e-4), with no sign flipped.
NORMALS_GAP_FLOOR = 1e-2
NORMALS_ANGLE_DEG = 0.1
# The new solver arms at ETH scale: timed runs per arm (3, not 5: the LM
# arm takes 5 s a run), the gross gate of the arms that converge (1 cm,
# T_ERR_LIMIT_M), and of linear point-to-point, which slides along these
# smooth sheets: 10 cm, set from the card's reading (NVIDIA H100 80GB HBM3,
# 700 W: a mean of 52.5 mm over the 16 pairs after 50 iterations, from
# starts 0.1-0.5 m off; the port's CPU run of pair 0 reads 12.1 cm; the
# bunny's point-to-point bound is 5x the plane metrics' for the same
# reason).
SOLVER_TIMED_RUNS = 3
P2P_T_ERR_LIMIT_M = 0.1
# Largest entry gap between an arm's f32 increment and the float64 one on
# its final iteration's matches, set from the card's readings (1.1e-6
# linear point-to-point, 1.1e-8 linear GICP, 3.4e-7 LM GICP).
ETH_SOLVE_GAP = 1e-5


def synth_cloud(n, seed):
    """Structured surface-ish cloud at ETH scale (~tens of meters)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    z = (
        2.0 * np.sin(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1])
        + 0.1 * rng.standard_normal(n)
    ).astype(np.float32)
    pts = np.column_stack([xy, z])
    nrm = np.column_stack(
        [
            -0.6 * np.cos(0.3 * xy[:, 0]) * np.cos(0.2 * xy[:, 1]),
            0.4 * np.sin(0.3 * xy[:, 0]) * np.sin(0.2 * xy[:, 1]),
            np.ones(n, np.float32),
        ]
    ).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def eth_true_pose(i):
    """The rigid perturbation applied to pair i's source by make_pairs."""
    ang = 0.05 + 0.01 * i
    R = np.array(
        [[np.cos(ang), -np.sin(ang), 0],
         [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    shift = np.array([0.5 - 0.1 * i, -0.3 + 0.05 * i, 0.1], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = shift
    return T


def make_pairs(n_pairs=BATCH_PAIRS, n_points=N_POINTS):
    """Distinct (source, target) pairs; pair i's source is its target moved
    by ``eth_true_pose(i)``."""
    pairs = []
    for i in range(n_pairs):
        tgt_pts, tgt_nrm = synth_cloud(n_points, 2 * i)
        T = eth_true_pose(i)
        R, shift = T[:3, :3], T[:3, 3]
        src_pts = (tgt_pts @ R.T + shift).astype(np.float32)
        src_nrm = (tgt_nrm @ R.T).astype(np.float32)
        pairs.append((src_pts, src_nrm, tgt_pts, tgt_nrm))
    return pairs


def synth_indoor_cloud(n, seed, sensor=(10.0, 7.5, 1.5), crop=None):
    """Indoor-like multi-surface scene at ETH-Apartment scale: floor, two
    walls and four boxes, a 1/r^2 density falloff from a sensor origin and
    8 mm surface noise; ``crop=(xlo, xhi)`` keeps that x window before the
    resampling. Returns ``(points, normals)`` with exactly ``n`` rows."""
    rng = np.random.default_rng(seed)
    boxes = [
        (4.0, 3.0, 1.2, 2.0, 0.8),     # x, y, w, d, h
        (13.0, 9.0, 2.5, 1.0, 1.1),
        (8.0, 11.0, 1.0, 1.0, 0.5),
        (16.0, 4.0, 1.5, 2.2, 0.7),
    ]
    surfaces = [("floor", None, 20.0 * 15.0),
                ("wallx", None, 20.0 * 3.0),
                ("wally", None, 15.0 * 3.0)]
    for b in boxes:
        x, y, w, d, h = b
        surfaces.append(("boxtop", b, w * d))
        surfaces.append(("boxside", b, 2 * (w + d) * h))
    areas = np.array([s[2] for s in surfaces])
    m = 3 * n
    counts = rng.multinomial(m, areas / areas.sum())
    pts_l, nrm_l = [], []
    for (kind, b, _), c in zip(surfaces, counts):
        if c == 0:
            continue
        u, v = rng.random(c), rng.random(c)
        if kind == "floor":
            p = np.column_stack([20 * u, 15 * v, np.zeros(c)])
            nm = np.tile([0.0, 0.0, 1.0], (c, 1))
        elif kind == "wallx":
            p = np.column_stack([20 * u, np.zeros(c), 3 * v])
            nm = np.tile([0.0, 1.0, 0.0], (c, 1))
        elif kind == "wally":
            p = np.column_stack([np.zeros(c), 15 * u, 3 * v])
            nm = np.tile([1.0, 0.0, 0.0], (c, 1))
        elif kind == "boxtop":
            x, y, w, d, h = b
            p = np.column_stack([x + w * (u - 0.5), y + d * (v - 0.5), np.full(c, h)])
            nm = np.tile([0.0, 0.0, 1.0], (c, 1))
        else:
            x, y, w, d, h = b
            t = u * 2 * (w + d)
            px = np.where(t < w, x - w / 2 + t,
                          np.where(t < w + d, x + w / 2,
                                   np.where(t < 2 * w + d, x + w / 2 - (t - w - d), x - w / 2)))
            py = np.where(t < w, y - d / 2,
                          np.where(t < w + d, y - d / 2 + (t - w),
                                   np.where(t < 2 * w + d, y + d / 2, y + d / 2 - (t - 2 * w - d))))
            p = np.column_stack([px, py, h * v])
            nx = np.where(t < w, 0.0, np.where(t < w + d, 1.0, np.where(t < 2 * w + d, 0.0, -1.0)))
            ny = np.where(t < w, -1.0, np.where(t < w + d, 0.0, np.where(t < 2 * w + d, 1.0, 0.0)))
            nm = np.column_stack([nx, ny, np.zeros(c)])
        pts_l.append(p)
        nrm_l.append(nm)
    pts = np.concatenate(pts_l).astype(np.float32)
    nrm = np.concatenate(nrm_l).astype(np.float32)
    if crop is not None:
        keep = (pts[:, 0] >= crop[0]) & (pts[:, 0] <= crop[1])
        pts, nrm = pts[keep], nrm[keep]
    r2 = np.sum((pts - np.asarray(sensor, np.float32)) ** 2, axis=1)
    w8 = 1.0 / np.maximum(r2, 1.0)
    rows = rng.choice(len(pts), size=n, replace=True, p=w8 / w8.sum())
    pts, nrm = pts[rows], nrm[rows]
    pts = pts + rng.normal(0, 0.008, pts.shape).astype(np.float32)
    return pts.astype(np.float32), nrm


def indoor_true_pose(i):
    """The rigid perturbation applied to indoor pair i's source."""
    ang = 0.04 + 0.008 * i
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(ang), -np.sin(ang), 0],
                          [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    T[:3, 3] = np.array([0.4 - 0.06 * i, -0.25 + 0.04 * i, 0.05], np.float32)
    return T


def make_indoor_pairs(n_pairs, n_points):
    """(source, target) pairs of the indoor scene: x windows [0, 16] and
    [4.5, 20] (~70% overlap), sampled independently; pair i's source moved
    by ``indoor_true_pose(i)``."""
    pairs = []
    for i in range(n_pairs):
        tgt_pts, tgt_nrm = synth_indoor_cloud(n_points, 3 * i + 1, crop=(0.0, 16.0))
        src_pts, src_nrm = synth_indoor_cloud(n_points, 3 * i + 2, crop=(4.5, 20.0))
        T = indoor_true_pose(i)
        src_pts = (src_pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        src_nrm = (src_nrm @ T[:3, :3].T).astype(np.float32)
        pairs.append((src_pts, src_nrm, tgt_pts, tgt_nrm))
    return pairs


def rotation_error_deg(R):
    """Rotation angle of a residual rotation, in f64 and small-angle
    accurate: atan2(|axial part|, (tr - 1) / 2), not arccos in f32."""
    R = np.asarray(R, np.float64)
    s = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    c = 0.5 * (np.trace(R) - 1.0)
    return math.degrees(math.atan2(float(np.linalg.norm(s)), float(c)))


def profile_run(fn, wall_s: float, top: int = 8, cpu: bool = True) -> dict:
    """Device time of one more run of ``fn`` under ``torch.profiler``
    (``cpu=False``: the card's activity alone, for runs of tens of
    thousands of launches, whose host-side events take the profiler
    minutes to read back):
    total kernel time, kernel launches, the ``top`` kernel names by time
    (names cut to 90 characters, times of equal cut names summed), and
    the device busy share = kernel time / ``wall_s`` (the unprofiled run's
    wall time; the profiler slows the host, not the kernels), and each of
    the port's kernels' time summed over every ``__global__`` whose name
    holds the kernel's name (kd_block_search launches five)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from icp_variants_tpu_torch.ops import _cuda

    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return {"device_ms": "not measured"}
    by_name, by_port = collections.Counter(), collections.Counter()
    for e in kernels:
        by_name[e.key[:90]] += e.self_device_time_total / 1e3
        for name in _cuda.KERNELS:
            if name in e.key:
                by_port[name] += e.self_device_time_total / 1e3
    return {
        "device_ms": total_us / 1e3,
        "device_busy_share": total_us / 1e6 / wall_s,
        "kernel_launches": int(sum(e.count for e in kernels)),
        "device_ms_by_kernel": dict(by_name.most_common(top)),
        "device_ms_by_port_kernel": dict(by_port),
    }


def kernel_split(fn, prefix, parts, reps=5) -> dict:
    """Device ms per launch of each ``__global__`` named ``<prefix>_<part>``
    over ``reps`` calls of ``fn`` under ``torch.profiler`` (after one
    warm-up call): a kernel of several launches, each once a call, split by
    launch. Divided by the launches the profiler recorded (late in a long
    run it may drop some events; the window is padded, PROFILE_PAD_S).
    Raises :class:`Failure` if it sees no launch of one of ``parts``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    us, count = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and prefix + "_" in e.key:
            part = e.key.split(prefix + "_", 1)[1].split("<")[0].split("(")[0]
            us[part] += e.self_device_time_total
            count[part] += e.count
    missing = [part for part in parts if part not in us]
    if missing:
        raise Failure(f"{prefix}: the profiler saw no launch of its {', '.join(missing)}")
    return {part: us[part] / 1e3 / count[part] for part in us}


@functools.lru_cache(maxsize=None)
def synth_depth_frame(i):
    """Indoor-like 640x480 depth frame: wavy surface + raised boxes
    (furniture with sharp depth steps -> invalid normals at the edges),
    viewed from a camera at x = -TUM_SHIFT*i. Returns (depth f32 (H, W) in
    metres, color u8 (H, W, 4))."""
    vv, uu = np.meshgrid(np.arange(TUM_H), np.arange(TUM_W), indexing="ij")
    sx = TUM_SHIFT * i
    z = np.full((TUM_H, TUM_W), 2.0)
    boxes = [(-0.6, -0.3, 0.35, 0.25, 0.5), (0.4, 0.2, 0.3, 0.3, 0.35),
             (0.1, -0.5, 0.2, 0.2, 0.25)]
    for _ in range(8):  # fixed-point solve of the pixel-ray / surface hit
        xw = (uu - TUM_CX) / TUM_FX * z - sx
        yw = (vv - TUM_CY) / TUM_FY * z
        base = 2.0 + 0.12 * np.sin(3.0 * xw) * np.cos(3.0 * yw)
        for (bx, by, w, h, dz) in boxes:
            inside = (np.abs(xw - bx) < w) & (np.abs(yw - by) < h)
            base = np.where(inside, base - dz, base)
        z = base
    xw = (uu - TUM_CX) / TUM_FX * z - sx
    yw = (vv - TUM_CY) / TUM_FY * z
    color = np.stack([
        (127 + 120 * np.sin(5.0 * xw)).astype(np.uint8),
        (127 + 120 * np.cos(4.0 * yw)).astype(np.uint8),
        (127 + 120 * np.sin(3.0 * (xw + yw))).astype(np.uint8),
        np.full((TUM_H, TUM_W), 255, np.uint8),
    ], axis=-1)
    return z.astype(np.float32), color


def prepare_tum_state(device):
    """Frame 0 as the compact tracking target (on the host) and
    TUM_BATCH_FRAMES full-size source frames in 6-dim colour Morton order
    (on ``device``)."""
    from icp_variants_tpu_torch.data import rgbd
    from icp_variants_tpu_torch.pipeline import icp

    K = np.array([[TUM_FX, 0, TUM_CX], [0, TUM_FY, TUM_CY], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    cap = TUM_W * TUM_H
    depth0, color0 = synth_depth_frame(0)
    tgt = rgbd.cloud_from_depth(depth0, color0, K, eye, keep_original_size=False,
                                capacity=cap, device="cpu")
    srcs = [rgbd.cloud_from_depth(*synth_depth_frame(i), K, eye, keep_original_size=True,
                                  capacity=cap, color_morton_order=True, device=device)
            for i in range(1, TUM_BATCH_FRAMES + 1)]
    return tgt, icp.stack_clouds(srcs)


def tum_base_config(**overrides):
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer

    cfg = ICPConfig(
        metric=Metric.POINT_TO_PLANE, minimizer=Minimizer.LINEAR,
        n_iterations=TUM_ITERATIONS, max_distance=TUM_MAX_DISTANCE,
    ).with_camera(fx=TUM_FX, fy=TUM_FY, cx=TUM_CX, cy=TUM_CY, width=TUM_W, height=TUM_H)
    return cfg.replace(**overrides)


def eth_config(**overrides):
    """The ETH headline configuration (symmetric linear ICP, p = 0.01
    Bernoulli selection, squared max distance 10, 50 iterations), its exact
    arm unless ``matching_checks`` is overridden."""
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer, Selection

    return ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                     selection=Selection.RANDOM, selection_proba=SELECTION_P,
                     n_iterations=N_ITERATIONS, max_distance=MAX_DISTANCE,
                     matching_checks=0).replace(**overrides)


def time_ms(fn, reps):
    """Median ms of ``fn`` between CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out))


def queued_ms(fn, reps):
    """CUDA-event ms a call of ``fn`` over ``reps`` calls queued behind a
    sleeping kernel, after one warm-up call: the calls' device time back to
    back, where a short kernel would otherwise be timed at the host's pace
    of issue."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def plain_pass(fn, n, rows=PLAIN_CHUNK_ROWS):
    """``fn(s, e)`` over windows [s, e) of ``n`` rows, outputs joined along
    the row axis; returns them and the whole pass's CUDA-event ms."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [fn(s, min(s + rows, n)) for s in range(0, n, rows)]
    end.record()
    end.synchronize()
    return tuple(torch.cat(o, dim=1) for o in zip(*outs)), start.elapsed_time(end)


def bound(nbytes, nops):
    """Least time in ms for ``nbytes`` of traffic and ``nops`` f32
    operations on the card, and which of the two bounds it."""
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class Failure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failure(what)
    print(f"  ok: {what}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from icp_variants_tpu_torch.ops import _cuda

    # ---- phase 1: set-up -------------------------------------------------
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1: set-up", flush=True)
    print(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    print(f"  torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(f"  card: {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    build_s = _cuda.build_all(measurement_builds())
    n_src = len({src for src, _, _ in _cuda.KERNELS.values()})
    print(f"  kernel build: {build_s:.2f} s (nvcc, {len(_cuda.KERNELS)} kernels from {n_src} "
          f"sources and {len(measurement_builds())} measurement builds, in parallel)")
    for name, log in _cuda.BUILD_LOG.items():
        if " " in name:
            continue  # a measurement build
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    phase_s = {"1 set-up": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"  {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    rows_eth, launches_eth, eth = timed("2-3 ETH", eth_phase)
    rows_color, launches_color, colour = timed("4 colour", color_phase)
    rows_proj, launches_proj = timed("5 projective", projective_phase)
    rows_ne = timed("5b normal equations", normal_equations_phase)
    rows_ps = timed("5c pose step", pose_step_phase)
    rows_dense, launches_dense = timed("6 dense", dense_phase)
    rows_match, launches_match = timed("7 matchers", matcher_phase, colour)
    del colour
    rows_tool = timed("8 tooling", tooling_phase, eth)
    launches_register = timed("9 register", register_phase, eth, card)
    launches_entry, graph_case = timed("10 entry points", entry_phase, card)
    sharded = timed("11 multi-device", multidevice_phase, eth, graph_case, card)
    del eth
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}),
          flush=True)
    record(rows_eth, launches_eth,
           {**rows_color, **rows_proj, **rows_ne, **rows_ps, **rows_dense, **rows_match,
            **rows_tool},
           collections.Counter(launches_color) + collections.Counter(launches_proj)
           + collections.Counter(launches_dense) + collections.Counter(launches_match)
           + launches_register + launches_entry, sharded)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def measurement_builds():
    """The measurement builds the phases load, ``(source, defines)``, built
    beside the production libraries in phase 1."""
    from icp_variants_tpu_torch.scripts import knn_ablate, resident_bench

    return (("kd_block_search.cu", resident_bench.LANE_DEFINES),
            ("projective_window_search.cu", ("PWS_LOADS_ONLY",)),
            ("dense_nn_search.cu", NN_COUNT_DEFINES),
            ("visited_ablate.cu", knn_ablate.COUNT_DEFINES))


def eth_phase(n_pairs: int = BATCH_PAIRS, n_points: int = N_POINTS):
    """Phases 2-3 on the card with ``n_pairs`` pairs of ``n_points``
    points; returns the kernel rows, the launches of the main-path runs and
    the path's data (sources, host targets, kd indexes) for phase 8, and
    the exact arm's first timed run and its seed for phase 11.
    Raises :class:`Failure` on a failed check."""
    import torch

    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.ops import _cuda, kdtree, knn, selection
    from icp_variants_tpu_torch.pipeline import icp

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- host data ------------------------------------------------------
    t0 = time.perf_counter()
    pairs = make_pairs(n_pairs, n_points)
    sources = icp.stack_clouds([
        cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
        for sp, sn, _, _ in pairs])
    targets_host = [
        cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
        for _, _, tp, tn in pairs]
    targets = icp.stack_clouds(targets_host).to(dev)
    kd = kdtree.stack_kd_indexes([
        kdtree.build_kd_index(t.points, t.valid, device=dev) for t in targets_host])
    sync()
    b, cap = sources.valid.shape
    nc, cap_pad = kd.pages.shape[1], kd.pages.shape[-1]
    print(f"  host data: {b} pairs x {cap} rows, kd {nc} blocks of cap_pad {cap_pad}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 2: kernels against their plain versions ---------------------
    print("phase 2: ETH kernels (D = 3) against plain versions at the path's shapes",
          flush=True)
    k_cap = icp._compact_capacity(cap, SELECTION_P)
    gen = torch.Generator(device=dev).manual_seed(0)
    sel_idx, in_range = selection.bernoulli_gap_indices(
        gen, SELECTION_P, 1, cap, k_cap, batch=(b,), device=dev)
    src_table = icp._fuse_cloud_table(sources)
    qcloud, qmask = icp._compact_cloud(sources, src_table, sel_idx, in_range, False)
    first = torch.argmax(qmask.to(torch.uint8), dim=-1)
    q = torch.where(qmask[..., None], qcloud.points,
                    knn.take_rows(qcloud.points, first[:, None])).contiguous()
    n = q.shape[1]
    bound_val = knn.bound_value(MAX_DISTANCE)
    binit = torch.full((b, n), bound_val, device=dev)
    print(f"  queries: {b} x {n} (first iteration's draw, identity pose)")

    rows = {}
    d = 3
    # Real (unpadded) points per kd block and per fallback tile: the bounds
    # count the work these inputs need, not padding slots.
    block_real = (kd.block_orig >= 0).sum(-1)                      # (B, nc)
    for k in (4, 1):
        sel_k, resid_k = kdtree.box_topk(q, binit, kd.block_min, kd.block_max, k)
        sel_p, resid_p = kdtree.box_topk_plain(q, binit, kd.block_min, kd.block_max, k)
        sync()
        check(torch.equal(sel_k, sel_p), f"box_topk k={k}: sel equal to plain")
        check(torch.equal(resid_k, resid_p), f"box_topk k={k}: resid equal to plain")
        d2_k, idx_k = kdtree.kd_block_search(q, sel_k, binit, kd.pages)
        d2_p, idx_p = kdtree.kd_block_search_plain(q, sel_k, binit, kd.pages)
        sync()
        check(torch.equal(d2_k, d2_p), f"kd_block_search k={k}: d2 equal to plain")
        _tie_or_equal(idx_k, idx_p, d2_k, q, kd.pages, f"kd_block_search k={k}")
        if k == 4:
            members = sel_k >= 0
            n_member = int(members.sum())
            bi = torch.arange(b, device=dev)[:, None, None].expand_as(sel_k)
            member_pts = int(block_real[bi[members], sel_k[members].long()].sum())
            used = torch.zeros((b, nc), dtype=torch.bool, device=dev)
            used[bi[members], sel_k[members].long()] = True
            distinct = int(used.sum())
            distinct_pts = int(block_real[used].sum())
            rows["box_topk"] = dict(
                err=float((resid_k - resid_p).abs().nan_to_num(0.0).max()),
                ms=time_ms(lambda: kdtree.box_topk(q, binit, kd.block_min, kd.block_max, 4), 50),
                plain_ms=time_ms(lambda: kdtree.box_topk_plain(q, binit, kd.block_min, kd.block_max, 4), 10),
                bound=bound(b * n * (d + 1 + k + 1) * 4 + b * nc * d * 2 * 4,
                            b * n * nc * (6 * d - 1 + k + 1)),
            )
            rows["kd_block_search"] = dict(
                err=float((d2_k - d2_p).abs().max()),
                ms=time_ms(lambda: kdtree.kd_block_search(q, sel_k, binit, kd.pages), 20),
                plain_ms=time_ms(lambda: kdtree.kd_block_search_plain(q, sel_k, binit, kd.pages), 3),
                bound=bound(b * n * (d + k + 1 + 2) * 4 + distinct_pts * d * 4,
                            member_pts * 9),
            )
            print(f"  k=4: {n_member} member blocks over {b * n} queries "
                  f"({member_pts} real points searched), {distinct} distinct "
                  f"(pair, block) pages")
            lane_reading("ETH k=4", q, sel_k, binit, kd.pages)

    fidx = knn.build_target_index(targets.points, tile_t=knn.V2_TILE_T)
    n_tiles, tile_t = fidx.points_t3.shape[1], fidx.points_t3.shape[-1]
    radius = binit.clone()
    vd_k, vi_k = knn.visited_search(q, radius, fidx)
    vd_p, vi_p = knn.visited_search_plain(q, radius, fidx)
    sync()
    check(torch.equal(vd_k, vd_p), "visited_search (all radii >= 0): d2 equal to plain")
    check(torch.equal(vi_k, vi_p), "visited_search: idx equal to plain")
    # Work an exact search needs on these inputs, for the bound: per query,
    # the real points of every tile whose box lies within that query's
    # nearest-neighbour distance (the plain result vd_p), 9 operations each.
    tile_real = targets.valid.to(torch.int64)
    tile_real = torch.nn.functional.pad(tile_real, (0, n_tiles * tile_t - cap))
    tile_real = tile_real.reshape(b, n_tiles, tile_t).sum(-1)          # (B, n_tiles)
    need = knn.box_lb(q, fidx.bbox_min[..., :d], fidx.bbox_max[..., :d]) <= vd_p[..., None]
    need_pts = int((need * tile_real[:, None, :]).sum())
    touched = need.any(1)                                              # (B, n_tiles)
    rows["visited_search"] = dict(
        err=float((vd_k - vd_p).abs().max()),
        ms=time_ms(lambda: knn.visited_search(q, radius, fidx), 10),
        plain_ms=time_ms(lambda: knn.visited_search_plain(q, radius, fidx), 2),
        bound=bound(b * n * (d + 1 + 2) * 4 + int(tile_real[touched].sum()) * d * 4,
                    need_pts * 9),
    )
    print(f"  visited_search: each query needs {int(need.sum()) / (b * n):.2f} of "
          f"{n_tiles} tiles on average ({need_pts} real points in all), "
          f"{int(touched.sum())} distinct (pair, tile) touched")
    del need

    # Pair 0 against scipy: the fallback search and the exact-arm matcher.
    from scipy.spatial import cKDTree

    t_np = targets.points[0].cpu().numpy()
    t_ok = targets.valid[0].cpu().numpy()
    rows_ok = np.flatnonzero(t_ok)
    tree = cKDTree(t_np[rows_ok])
    q0 = q[0].cpu().numpy()
    dref, iref = tree.query(q0, k=1)
    iref = rows_ok[iref]
    d2ref = (dref * dref).astype(np.float64)
    sub = np.arange(0, n, max(1, n // 512))[:512]
    vd0, vi0 = vd_k[0].cpu().numpy(), vi_k[0].cpu().numpy()
    check(np.allclose(vd0[sub], d2ref[sub], rtol=1e-5, atol=1e-6)
          and bool(np.all((vi0[sub] == iref[sub])
                          | np.isclose(vd0[sub], d2ref[sub], rtol=1e-6, atol=0))),
          "visited_search == cKDTree on 512 queries of pair 0")
    kd0 = kdtree.KDIndex(*(None if f is None else f[:1] for f in kd))
    fidx0 = knn.TargetIndex(*(f[:1] for f in fidx))
    midx, md2, mvalid = kdtree.match_kd(q[:1], kd0, fidx0, MAX_DISTANCE, checks=0)
    midx, md2, mvalid = (x[0].cpu().numpy() for x in (midx, md2, mvalid))
    within = d2ref <= MAX_DISTANCE
    check(bool(np.all(mvalid == within)), "exact-arm match_kd: valid == cKDTree within threshold")
    check(bool(np.all((midx[within] == iref[within])
                      | np.isclose(md2[within], d2ref[within], rtol=1e-6, atol=0)))
          and np.allclose(md2[within], d2ref[within], rtol=1e-5, atol=1e-6),
          f"exact-arm match_kd == cKDTree on all {n} queries of pair 0")
    for name, r in rows.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), max_abs_err {r['err']}")
    del vd_p, vi_p, d2_p, idx_p
    torch.cuda.empty_cache()

    launches = {name: 0 for name in _cuda.KERNELS}
    # ---- phase 3: the ETH path ----------------------------------------
    print(f"phase 3: ETH path, {b} pairs x {cap} rows x {N_ITERATIONS} iterations",
          flush=True)
    arms, runs = {}, {}
    checks_of = {"exact": 0, "checks16": CHECKS_APPROX}
    for arm, checks in checks_of.items():
        cfg = eth_config(matching_checks=checks)

        def run(seed, cfg=cfg):
            return icp.run_icp_batch(cfg, sources, targets, kd_indexes=kd,
                                     seed=seed, device=dev)

        runs[arm] = run
        run(1)
        sync()
    walls, issues, counts, results = timed_runs(runs)
    for arm in runs:
        dt, issued = float(np.median(walls[arm])), float(np.median(issues[arm]))
        poses = results[arm].pose.cpu().numpy().astype(np.float64)
        nm = results[arm].trace.num_matches.cpu().numpy()
        check(poses.shape == (b, 4, 4) and np.isfinite(poses).all(),
              f"{arm}: {b} finite 4x4 poses")
        t_errs, r_errs = [], []
        for i in range(b):
            resid = poses[i] @ eth_true_pose(i).astype(np.float64)
            t_errs.append(float(np.abs(resid[:3, 3]).max()))
            r_errs.append(rotation_error_deg(resid[:3, :3]))
        arms[arm] = dict(
            pairs_per_s=b / dt, seconds=dt, seconds_each=walls[arm], host_issue_s=issued,
            t_err_m=float(np.mean(t_errs)), r_err_deg=float(np.mean(r_errs)),
            launches=counts[arm], mean_matches=float(nm.mean()),
        )
        print(f"  {arm}: {b / dt:.4f} pairs/s (median of {N_TIMED_RUNS} runs: {dt:.4f} s "
              f"per batch, host issue {issued:.4f} s; runs "
              f"{[round(w, 4) for w in walls[arm]]}), mean t_err "
              f"{np.mean(t_errs) * 1e3:.4f} mm, mean r_err {np.mean(r_errs):.6f} deg, "
              f"mean matches/iter {nm.mean():.1f}, launches {counts[arm]}", flush=True)
        check(np.mean(t_errs) <= T_ERR_LIMIT_M, f"{arm}: mean t_err <= 1 cm")
        check(np.mean(t_errs) <= T_ERR_TIGHT_M, f"{arm}: mean t_err <= 0.01 mm")
        # The arm's matcher at pair 0's final pose against cKDTree, on pair
        # 0's real phase-2 queries moved by that pose.
        qf = se3.transform_points(q[:1, qmask[0]], results[arm].pose[:1]).contiguous()
        fi, fd2, fvalid = kdtree.match_kd(qf, kd0, fidx0, MAX_DISTANCE, checks=checks_of[arm])
        fi, fd2, fvalid = (x[0].cpu().numpy() for x in (fi, fd2, fvalid))
        qf_np = qf[0].cpu().numpy()
        dref_f, iref_f = tree.query(qf_np, k=1)
        iref_f, d2ref_f = rows_ok[iref_f], (dref_f * dref_f).astype(np.float64)
        within_f = d2ref_f <= MAX_DISTANCE
        real = ((qf_np - t_np[np.clip(fi, 0, None)]) ** 2).sum(1)
        same = (fi == iref_f) | np.isclose(fd2, d2ref_f, rtol=1e-6, atol=0)
        print(f"  {arm} at pair 0's final pose: {int(fvalid.sum())} of {len(fi)} queries "
              f"matched, {int((same & fvalid).sum())} equal to cKDTree, nearest-neighbour "
              f"distance max {float(np.sqrt(d2ref_f.max())):.3e} m")
        if checks_of[arm] == 0:
            check(bool(np.all(fvalid == within_f)) and bool(np.all(same[within_f]))
                  and np.allclose(fd2[within_f], d2ref_f[within_f], rtol=1e-5, atol=1e-6),
                  f"{arm}: every match at pair 0's final pose == cKDTree within the threshold")
        else:
            check(bool(np.all(fvalid <= within_f))
                  and np.allclose(fd2[fvalid], real[fvalid], rtol=1e-5, atol=1e-6)
                  and bool(np.all(fd2[fvalid] >= d2ref_f[fvalid] * (1 - 1e-5) - 1e-9)),
                  f"{arm}: every match at pair 0's final pose is a real point, no nearer "
                  "than cKDTree's")
        for name in ("box_topk", "kd_block_search"):
            check(counts[arm].get(name, 0) >= N_ITERATIONS,
                  f"{arm}: {name} launched >= {N_ITERATIONS} times")
        for name in launches:
            launches[name] += counts[arm].get(name, 0)
    # Profiled runs come after every timed run: a profiler session can slow
    # the host's later kernel launches.
    for arm, run in runs.items():
        prof = profile_run(lambda: run(99), arms[arm]["seconds"])
        arms[arm].update(prof)
        print(f"  {arm} profile: device {prof['device_ms']} ms, busy share "
              f"{prof.get('device_busy_share')}, {prof.get('kernel_launches')} launches")
        for name, ms in prof.get("device_ms_by_kernel", {}).items():
            print(f"    device {ms:9.3f} ms  {name}")
    check(launches["visited_search"] >= 1, "visited_search launched on the main path")
    print("  main path: " + json.dumps(arms))

    # timed_runs' first round runs seed 2 (phase 11 replays its draws).
    return rows, launches, dict(sources=sources, targets_host=targets_host, kd=kd,
                                exact=results["exact"], exact_seed=2)


def timed_runs(runs):
    """N_TIMED_RUNS runs of each arm's ``runs[arm](seed)``, in turns
    (exact, checks16, checks16, exact, ...) so host drift hits both arms
    alike. Returns per arm the wall seconds, the host seconds to queue the
    run, and the launch counts and result of its first run (each count set
    to 0 just before it): the main path's run."""
    import torch

    from icp_variants_tpu_torch.ops import _cuda

    walls = {arm: [] for arm in runs}
    issues = {arm: [] for arm in runs}
    counts, results = {}, {}
    for r in range(N_TIMED_RUNS):
        for arm in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            if r == 0:
                _cuda.reset_launches()
            t0 = time.perf_counter()
            res = runs[arm](2 + r)
            issues[arm].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls[arm].append(time.perf_counter() - t0)
            if r == 0:
                counts[arm] = dict(_cuda.LAUNCHES)
                results[arm] = res
    return walls, issues, counts, results


def lane_reading(label, q, sel, binit, pages):
    """Print kd_block_search's lane use on these operands, read from its
    measurement build (``resident_bench.lane_use``), and check that build's
    result equal to the production one's."""
    from icp_variants_tpu_torch.scripts import resident_bench

    r = resident_bench.lane_use(q, sel, binit, pages)
    colour = ("" if r["colour"] is None else
              f", colour terms {r['colour']:.4f} over {r['colour_steps']} warp steps")
    print(f"  kd_block_search lanes, {label} (active / 32, measurement build): spatial "
          f"{r['spatial']:.4f} over {r['spatial_steps']} warp steps{colour}", flush=True)
    check(r["equal"], f"kd_block_search, {label}: the lane-counting build's result equal to "
          "the production build's")


# The measurement build of csrc/dense_nn_search.cu that counts the walk's
# (query, group) steps, moved marks, run flushes, rescans, misses and runs
# ended by a lower tile.
NN_COUNT_DEFINES = ("NN_RESCAN_COUNT",)


def issue_floor(pairs, d):
    """Least ms for ``pairs`` (query, target) pairs of the expansion under
    the rounding contract: 2D + 2 instructions a pair (D products and D - 1
    sums of g, the sum qn2 + tn2, one fused s - 2g, the running minimum),
    none contracted, at one a lane a clock: half of PEAK_F32_OPS, which
    counts an FMA as two operations."""
    return pairs * (2 * d + 2) / (PEAK_F32_OPS / 2) * 1e3


def rescan_reading(label, call, want):
    """Run ``call(defines)`` once on the counting build of the dense and
    pruned searches (``-DNN_RESCAN_COUNT``, not counted in the launches),
    check its (idx, d2) equal to ``want`` (the production build's), and
    return its counts: (query, 32-row group) steps, group marks moved, run
    flushes with a mark, rescans, the rescanned share of the pairs and the
    runs that a lower tile of their band ended (the card's list of cells
    comes in any order); a rescan that found no row fails the check."""
    import ctypes

    import torch

    from icp_variants_tpu_torch.ops import _cuda

    read = _cuda.variant("dense_nn_search.cu", NN_COUNT_DEFINES).nn_search_counts
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    counts = (ctypes.c_ulonglong * 6)()
    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise Failure("nn_search_counts: reset failed")
    got = call(NN_COUNT_DEFINES)
    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise Failure("nn_search_counts: read failed")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label}: the rescan-counting build's result equal to the production build's")
    steps, marks, flushes, rescans, misses, restarts = (int(c) for c in counts)
    out = dict(group_steps=steps, marks_moved=marks, flushes=flushes, rescans=rescans,
               rescanned_share=rescans / steps if steps else 0.0, tile_restarts=restarts)
    print(f"  {label} (counting build): {steps} (query, group) steps, {marks} marks moved, "
          f"{flushes} run flushes with a mark, {rescans} rescans of 32 rows: "
          f"{out['rescanned_share']:.3e} of the pairs walked again; {restarts} runs ended by "
          "a lower tile of their band", flush=True)
    check(misses == 0, f"{label}: every rescan found its row ({misses} missed)")
    return out


def _tie_or_equal(idx_k, idx_p, d2_k, q, pages, what):
    """Kernel and plain indices into ``pages`` agree, or differ only where
    the kernel's point lies at exactly the kernel's reported distance."""
    import torch

    diff = idx_k != idx_p
    n_diff = int(diff.sum())
    if not n_diff:
        check(True, f"{what}: idx equal to plain")
        return
    b, n, d = q.shape
    cap_pad = pages.shape[-1]
    blk = (idx_k // cap_pad).clamp(min=0).long()
    slot = (idx_k % cap_pad).long()
    bi = torch.arange(b, device=q.device)[:, None].expand_as(blk)
    pts = pages[bi, blk, :d, :].gather(-1, slot[..., None, None].expand(b, n, d, 1))[..., 0]
    dd = ((pts - q) ** 2).sum(-1)
    check(bool(torch.all((dd == d2_k) | ~diff)),
          f"{what}: {n_diff} idx differ, all at tied distances")


def color_phase():
    """Phase 4 on the card; returns the D = 6 kernel rows and the launches
    of the colour main-path runs. Raises :class:`Failure` on a failed
    check."""
    import torch
    from scipy.spatial import cKDTree

    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.ops import kdtree, knn
    from icp_variants_tpu_torch.pipeline import icp

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    torch.cuda.empty_cache()
    print(f"phase 4: colour path, {TUM_BATCH_FRAMES} frames x {TUM_W * TUM_H} rows x "
          f"{TUM_ITERATIONS} iterations", flush=True)
    t0 = time.perf_counter()
    tgt_host, sources = prepare_tum_state(dev)
    targets = icp.stack_clouds([tgt_host] * TUM_BATCH_FRAMES).to(dev)
    checks_of = {"exact": 0, "checks16": CHECKS_APPROX}
    cfgs, kds = {}, {}
    for arm, checks in checks_of.items():
        cfg = tum_base_config(color_icp=True, multi_resolution=True, matching_checks=checks)
        kd0 = icp.build_kd_for(cfg, tgt_host, device=dev)
        check(kd0 is not None and kd0.block_min.shape[-1] == 6,
              f"colour {arm}: build_kd_for gives a 6-dim kd index for the dense config")
        cfgs[arm], kds[arm] = cfg, kdtree.stack_kd_indexes([kd0] * TUM_BATCH_FRAMES)
    sync()
    b, cap = sources.valid.shape
    kx, ka = kds["exact"], kds["checks16"]
    d = 6
    print(f"  host data: {b} frames x {cap} rows (target {int(tgt_host.valid.sum())} valid rows); "
          f"kd exact {kx.pages.shape[1]} blocks of cap_pad {kx.pages.shape[-1]}, checks16 "
          f"{ka.pages.shape[1]} of {ka.pages.shape[-1]}; {time.perf_counter() - t0:.1f} s",
          flush=True)

    def run(arm, seed):
        return icp.run_icp_batch_multires_segmented(
            cfgs[arm], sources, targets, seed=seed, num_source_points=TUM_W * TUM_H,
            kd_indexes=kds[arm], device=dev)

    t0 = time.perf_counter()
    warm = {arm: run(arm, 1) for arm in cfgs}
    sync()
    print(f"  warm-up runs: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- kernels at D = 6 against their plain versions ---------------------
    # The fine (stride-1) level's queries at each arm's final warm-up pose;
    # masked rows pinned to the first valid row, as run_icp_batch does.
    fine = icp._slice_clouds_stride(sources, 1)
    qmask = fine.valid

    def fine_queries(pose):
        pts = se3.transform_points(fine.points, pose)
        first = torch.argmax(qmask.to(torch.uint8), dim=-1)
        pts = torch.where(qmask[..., None], pts, knn.take_rows(pts, first[:, None]))
        return knn.color_features(pts, fine.colors).contiguous()

    q_ex, q_ap = fine_queries(warm["exact"].pose), fine_queries(warm["checks16"].pose)
    bv = knn.bound_value(TUM_MAX_DISTANCE)
    n = cap
    b_full = torch.full((b, n), bv, device=dev)
    rows = {}
    shapes = f"{b} x {n} rows (D = 6)"
    plain_on = f"{shapes}, in windows of {PLAIN_CHUNK_ROWS} rows per frame"
    for arm, kd_, q_, k in (("exact", kx, q_ex, 4), ("checks16", ka, q_ap, 1)):
        sel, res = kdtree.box_topk(q_, b_full, kd_.block_min, kd_.block_max, k)
        (sel_p, res_p), box_plain_ms = plain_pass(
            lambda s, e: kdtree.box_topk_plain(q_[:, s:e], b_full[:, s:e], kd_.block_min,
                                               kd_.block_max, k), n)
        check(torch.equal(sel, sel_p) and torch.equal(res, res_p),
              f"box_topk D=6 k={k} ({arm} index, all {b} x {n} rows): sel and resid equal to plain")
        d2, idx = kdtree.kd_block_search(q_, sel, b_full, kd_.pages)
        (d2_p, idx_p), kd_plain_ms = plain_pass(
            lambda s, e: kdtree.kd_block_search_plain(q_[:, s:e], sel[:, s:e], b_full[:, s:e],
                                                      kd_.pages), n)
        check(torch.equal(d2, d2_p),
              f"kd_block_search D=6 k={k} ({arm} index, all {b} x {n} rows): d2 equal to plain")
        _tie_or_equal(idx, idx_p, d2, q_, kd_.pages, f"kd_block_search D=6 k={k} ({arm} index)")
        if arm == "exact":
            nc = kd_.pages.shape[1]
            block_real = (kd_.block_orig >= 0).sum(-1)                   # (B, nc)
            members = sel >= 0
            bi = torch.arange(b, device=dev)[:, None, None].expand_as(sel)
            member_pts = int(block_real[bi[members], sel[members].long()].sum())
            used = torch.zeros((b, nc), dtype=torch.bool, device=dev)
            used[bi[members], sel[members].long()] = True
            rows["box_topk"] = dict(
                err=float((res - res_p).abs().nan_to_num(0.0).max()),
                shapes=f"{shapes}, k = 4, {nc} blocks",
                ms=time_ms(lambda: kdtree.box_topk(q_ex, b_full, kd_.block_min, kd_.block_max, k), 10),
                plain_ms=box_plain_ms, plain_on=plain_on,
                bound=bound(b * n * (d + 1 + k + 1) * 4 + b * nc * d * 2 * 4,
                            b * n * nc * (6 * d - 1 + k + 1)))
            rows["kd_block_search"] = dict(
                err=float((d2 - d2_p).abs().max()), shapes=f"{shapes}, k = 4",
                ms=time_ms(lambda: kdtree.kd_block_search(q_ex, sel, b_full, kd_.pages), 5),
                plain_ms=kd_plain_ms, plain_on=plain_on,
                bound=bound(b * n * (d + k + 1 + 2) * 4 + int(block_real[used].sum()) * d * 4,
                            member_pts * 3 * d))
            print(f"  kd_block_search k=4: {int(members.sum())} member blocks, "
                  f"{member_pts} real points searched, {int(used.sum())} distinct (frame, block)")
            lane_reading("colour exact k=4", q_, sel, b_full, kd_.pages)
            del members, bi
        del sel, res, sel_p, res_p, d2, idx, d2_p, idx_p
        torch.cuda.empty_cache()

    # The seeded block search: the checks16 warm-up's final blocks, -1 for
    # masked rows (as match_kd_cached passes them).
    blk = torch.where(qmask, warm["checks16"].match_blocks, -1).contiguous()
    check(bool((blk < 0).any()) and bool((blk >= 0).any()),
          f"cached_block_search: {int((blk < 0).sum())} of {blk.numel()} rows are -1")
    ci_k, cd_k = kdtree.nn_search_kd_cached(q_ap, ka, TUM_MAX_DISTANCE, blk)
    (ci_p, cd_p), cached_plain_ms = plain_pass(
        lambda s, e: kdtree.nn_search_kd_cached_oracle(q_ap[:, s:e], ka, TUM_MAX_DISTANCE,
                                                       blk[:, s:e]), n)
    check(torch.equal(cd_k, cd_p), f"cached_block_search D=6 (all {b} x {n} rows): d2 equal to plain")
    _tie_or_equal(ci_k, ci_p, cd_k, q_ap, ka.pages, "cached_block_search D=6")
    nc_a = ka.pages.shape[1]
    real_a = (ka.block_orig >= 0).sum(-1)
    has = blk >= 0
    bi = torch.arange(b, device=dev)[:, None].expand_as(blk)
    row_pts = int(real_a[bi[has], blk[has].long()].sum())
    used = torch.zeros((b, nc_a), dtype=torch.bool, device=dev)
    used[bi[has], blk[has].long()] = True
    rows["cached_block_search"] = dict(
        err=float((cd_k - cd_p).abs().max()), shapes=f"{shapes}, {nc_a} blocks",
        ms=time_ms(lambda: kdtree.nn_search_kd_cached(q_ap, ka, TUM_MAX_DISTANCE, blk), 10),
        plain_ms=cached_plain_ms, plain_on=plain_on,
        bound=bound(b * n * (d + 1 + 2) * 4 + int(real_a[used].sum()) * d * 4, row_pts * 3 * d))
    print(f"  cached_block_search: {int(has.sum())} seeded rows, {row_pts} real points "
          f"searched, {int(used.sum())} distinct (frame, block)")
    split = kernel_split(lambda: kdtree.nn_search_kd_cached(q_ap, ka, TUM_MAX_DISTANCE, blk),
                         "cached_block_search", CACHED_PARTS)
    rows["cached_block_search"]["split_ms"] = split
    print("  cached_block_search by launch (profiler, ms a launch): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    check(set(split) == set(CACHED_PARTS),
          "cached_block_search: the profiler reads its five launches (bucketing, walk, out)")
    del ci_k, cd_k, ci_p, cd_p

    # The fallback search: all rows live on a subset of each frame, and at
    # the full shapes at the exact arm's real fallback radii (rows whose
    # top-4 certificate fails at the warm-up's final pose; the rest frozen),
    # there held against the plain version on every live row.
    fidx = knn.build_target_index(knn.color_features(targets.points, targets.colors),
                                  tile_t=knn.V2_TILE_T)
    starts = np.linspace(0, cap - SUBSET_WINDOW, SUBSET_WINDOWS).astype(np.int64)
    sub = torch.from_numpy(np.concatenate([np.arange(s, s + SUBSET_WINDOW) for s in starts])).to(dev)
    qs = q_ex[:, sub].contiguous()
    b_sub = torch.full(qs.shape[:2], bv, device=dev)
    vd_k, vi_k = knn.visited_search(qs, b_sub, fidx)
    vd_p, vi_p = knn.visited_search_plain(qs, b_sub, fidx)
    sync()
    check(torch.equal(vd_k, vd_p) and torch.equal(vi_k, vi_p),
          f"visited_search D=6 (all rows live, {b} x {len(sub)} rows): equal to plain")
    _, _, fail = kdtree.nn_search_kd_resident(q_ex, kx, TUM_MAX_DISTANCE)
    radii = torch.where(fail, bv, -1.0).contiguous()
    frow = fallback_row("D=6 at the fallback's radii", q_ex, radii, fidx, targets.valid, 5)
    rows["visited_search"] = dict(
        frow, err=max(float((vd_k - vd_p).abs().max()), frow["err"]),
        shapes=f"{shapes}, {frow['live_rows']} live rows (the exact arm's fallback radii)",
        all_live_ms=time_ms(lambda: knn.visited_search(qs, b_sub, fidx), 5),
        all_live_plain_ms=time_ms(lambda: knn.visited_search_plain(qs, b_sub, fidx), 2),
        all_live_on=f"{b} x {len(sub)} rows, all live")
    print(f"  visited_search D=6 all live on {b} x {len(sub)} rows: kernel "
          f"{rows['visited_search']['all_live_ms']:.4f} ms, plain "
          f"{rows['visited_search']['all_live_plain_ms']:.4f} ms")
    del fail, radii

    # kd_radius_search at k = 0 (radius-complete membership) on frame 0, at
    # the warm radii of the exact warm-up's final pose: the cache one warm
    # matching stage leaves there.
    cfg_x = cfgs["exact"].replace(multi_resolution=False)
    feats = knn.color_features(targets.points, targets.colors)
    gran = torch.arange(n, device=dev) // cfg_x.kd_warm_granule
    empty = torch.full((b, int(gran[-1]) + 1), -1, dtype=torch.int32, device=dev)
    _, _, _, cache = icp._match_kd_stage(cfg_x, q_ex, kx, fidx, qmask, empty, False, feats)
    radius = kdtree.warm_radius(q_ex, cache[:, gran], feats, TUM_MAX_DISTANCE, qmask)[0]
    r0 = torch.clamp(radius[:1], max=bv).contiguous()
    box = (kx.block_min[:1], kx.block_max[:1], kx.pages[:1])
    rd, ri = knn.kd_radius_search(q_ex[:1], r0, *box)
    (rd_p, ri_p), rad_plain_ms = plain_pass(
        lambda s, e: knn.kd_radius_search_plain(q_ex[:1, s:e], r0[:, s:e], *box), n, rows=256)
    check(torch.equal(rd, rd_p) and torch.equal(ri, ri_p),
          f"kd_radius_search D=6 k=0 (frame 0, all {n} rows at the warm radii): d2 and idx "
          f"equal to plain; {int((ri >= 0).sum())} found, {int((r0 < 0).sum())} frozen")
    rows["kd_radius_search_d6"] = dict(
        err=float((rd - rd_p).abs().max()), shapes=f"1 x {n} rows (D = 6), k = 0, {kx.pages.shape[1]} blocks",
        ms=time_ms(lambda: knn.kd_radius_search(q_ex[:1], r0, *box), 10),
        plain_ms=rad_plain_ms, plain_on="the same rows, in windows of 256")
    del rd, ri, rd_p, ri_p, cache, radius
    for name, r in rows.items():
        if "bound" not in r:
            print(f"  {name}: kernel {r['ms']:.4f} ms at {r['shapes']}; plain {r['plain_ms']:.4f} "
                  f"ms; max_abs_err {r['err']}", flush=True)
            continue
        print(f"  {name} (D=6): kernel {r['ms']:.4f} ms at {r['shapes']}; plain "
              f"{r['plain_ms']:.4f} ms on {r['plain_on']}; bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]}); max_abs_err {r['err']}", flush=True)
    torch.cuda.empty_cache()

    # ---- the main path: timed runs in turns --------------------------------
    walls, issues, counts, results = timed_runs(
        {arm: (lambda seed, arm=arm: run(arm, seed)) for arm in cfgs})
    arms = {}
    for arm in cfgs:
        dt, issued = float(np.median(walls[arm])), float(np.median(issues[arm]))
        poses = results[arm].pose.cpu().numpy().astype(np.float64)
        nm = results[arm].trace.num_matches.cpu().numpy()
        check(poses.shape == (b, 4, 4) and np.isfinite(poses).all(),
              f"colour {arm}: {b} finite 4x4 poses")
        t_errs, r_errs = color_errors(poses)
        arms[arm] = dict(
            frames_per_s=b / dt, seconds=dt, seconds_each=walls[arm], host_issue_s=issued,
            t_err_m=float(np.mean(t_errs)), r_err_deg=float(np.mean(r_errs)),
            mean_matches_per_iter=float(nm.mean()), fine_matches_per_iter=float(nm[:, -1].mean()),
            launches=counts[arm])
        print(f"  colour {arm}: {b / dt:.4f} frames/s (median of {N_TIMED_RUNS} runs: {dt:.4f} s "
              f"per batch, host issue {issued:.4f} s; runs {[round(w, 4) for w in walls[arm]]}), "
              f"mean t_err {np.mean(t_errs) * 1e3:.4f} mm, mean r_err {np.mean(r_errs):.6f} deg, "
              f"matches/iter mean {nm.mean():.1f} (last {nm[:, -1].mean():.1f}), "
              f"launches {counts[arm]}", flush=True)
        check(np.mean(t_errs) <= T_ERR_LIMIT_M, f"colour {arm}: mean t_err <= 1 cm")
        check(np.mean(t_errs) <= COLOR_T_ERR_TIGHT_M,
              f"colour {arm}: mean t_err <= {COLOR_T_ERR_TIGHT_M * 1e3:g} mm")
    n_seeded = sum(c for s, c in icp._stride_groups(icp.cloud_lib.multires_stride_schedule(
        TUM_W * TUM_H, TUM_ITERATIONS, True)) if s == 1)
    n_iter = len(icp.cloud_lib.multires_stride_schedule(TUM_W * TUM_H, TUM_ITERATIONS, True))
    for name in ("box_topk", "kd_block_search", "visited_search"):
        check(counts["exact"].get(name, 0) >= n_iter,
              f"colour exact: {name} launched >= {n_iter} times")
    check(counts["checks16"].get("cached_block_search", 0) >= n_seeded,
          f"colour checks16: cached_block_search launched >= {n_seeded} times (the seeded level)")
    for name in ("box_topk", "kd_block_search"):
        check(counts["checks16"].get(name, 0) >= n_iter - n_seeded,
              f"colour checks16: {name} launched >= {n_iter - n_seeded} times (unseeded levels)")
    # The exact arm runs warm (the JAX package's rule); one cold run on the
    # same frames must give the same answer.
    t0 = time.perf_counter()
    cold = icp.run_icp_batch_multires_segmented(
        cfgs["exact"].replace(kd_warm_start=False), sources, targets, seed=2,
        num_source_points=TUM_W * TUM_H, kd_indexes=kx, device=dev)
    sync()
    arms["exact"]["cold_seconds"] = time.perf_counter() - t0
    warm_x = results["exact"]
    print(f"  colour exact cold run: {arms['exact']['cold_seconds']:.4f} s; largest pose gap "
          f"to the warm run {float((warm_x.pose - cold.pose).abs().max()):.3e}", flush=True)
    check(icp._warm_applies(cfgs["exact"])
          and torch.equal(warm_x.trace.num_matches, cold.trace.num_matches),
          f"colour exact: warm == cold, match counts equal in all {n_iter} iterations of every frame")
    check(torch.allclose(warm_x.pose, cold.pose, rtol=1e-4, atol=1e-5),
          "colour exact: warm and cold final poses within rtol 1e-4, atol 1e-5")

    # ---- each arm's matcher at frame 0's final pose against cKDTree ---------
    tfeat = knn.color_features(tgt_host.points, tgt_host.colors).numpy().astype(np.float64)
    rows_ok = np.flatnonzero(tgt_host.valid.numpy())
    tree = cKDTree(tfeat[rows_ok])
    vrows = torch.nonzero(qmask[0]).flatten()
    fsub = vrows[torch.linspace(0, len(vrows) - 1, 4096, device=dev).long()]
    kd0 = {arm: kdtree.KDIndex(*(None if f is None else f[:1] for f in kds[arm])) for arm in kds}
    fidx0 = knn.TargetIndex(*(f[:1] for f in fidx))
    for arm in cfgs:
        qf = fine_queries(results[arm].pose)[:1, fsub].contiguous()
        qf_np = qf[0].cpu().numpy().astype(np.float64)
        dref, iref = tree.query(qf_np, k=1)
        iref, d2ref = rows_ok[iref], dref * dref
        within = d2ref <= TUM_MAX_DISTANCE
        clear = np.abs(d2ref - TUM_MAX_DISTANCE) > 1e-6
        if arm == "exact":
            mi, md, mv = kdtree.match_kd(qf, kd0[arm], fidx0, TUM_MAX_DISTANCE, checks=0)
            mi, md, mv = (x[0].cpu().numpy() for x in (mi, md, mv))
            same = (mi == iref) | np.isclose(md, d2ref, rtol=1e-6, atol=0)
            check(bool(np.all((mv == within)[clear])) and bool(np.all(same[mv & within]))
                  and np.allclose(md[mv], d2ref[mv], rtol=1e-5, atol=1e-7),
                  f"colour exact at frame 0's final pose: every match of {len(fsub)} rows "
                  "== cKDTree within the threshold")
        else:
            blk0 = results[arm].match_blocks[:1, fsub].contiguous()
            mi, md, mv = kdtree.match_kd_cached(qf, kd0[arm], TUM_MAX_DISTANCE, blk0)
            orig = knn.take_rows(kd0[arm].page_orig, mi.clamp(min=0))
            mi, md, mv, orig = (x[0].cpu().numpy() for x in (mi, md, mv, orig))
            real = ((qf_np - tfeat[np.clip(orig, 0, None)]) ** 2).sum(1)
            same = (orig == iref) | np.isclose(md, d2ref, rtol=1e-6, atol=0)
            check(bool(np.all(mv <= within | ~clear))
                  and np.allclose(md[mv], real[mv], rtol=1e-5, atol=1e-7)
                  and bool(np.all(md[mv] >= d2ref[mv] * (1 - 1e-5) - 1e-9)),
                  f"colour checks16 at frame 0's final pose: every seeded match of "
                  f"{len(fsub)} rows is a real point, no nearer than cKDTree's")
        print(f"  colour {arm} at frame 0's final pose: {int(mv.sum())} of {len(fsub)} rows "
              f"matched, {int((same & mv).sum())} equal to cKDTree, {int(within.sum())} "
              "within the threshold by cKDTree", flush=True)
    # Profiled runs come after every timed run.
    for arm in cfgs:
        prof = profile_run(lambda: run(arm, 99), arms[arm]["seconds"], top=10)
        arms[arm].update(prof)
        print(f"  colour {arm} profile: device {prof['device_ms']} ms, busy share "
              f"{prof.get('device_busy_share')}, {prof.get('kernel_launches')} launches")
        for name, ms in prof.get("device_ms_by_kernel", {}).items():
            print(f"    device {ms:9.3f} ms  {name}")

    # ---- the fixed point, and what the gates see of two faults ---------------
    # Each arm's final pose against one more step solved in f64; then the
    # checks16 arm run again with TF32 on (in the pose products only: the
    # normal equations are the f32 kernel's), and
    # with a planted fault in the seeded search (every 8th row's match moved
    # to the next slot of its block), each read against the same gates.
    def fixed_point(arm, res):
        step_m, gap = fixed_point_step(cfgs[arm], fine, targets, fidx, kds[arm], res)
        t_err = float(np.mean(color_errors(res.pose.cpu().numpy().astype(np.float64))[0]))
        print(f"  colour {arm}: mean t_err {t_err * 1e3:.4f} mm; one more step at the final "
              f"pose, solved in f64, moves a frame by at most {step_m * 1e3:.6f} mm; the f32 "
              f"solve of that step differs from it by {gap:.3e}", flush=True)
        return dict(t_err_m=t_err, fixed_point_step_m=step_m, f32_f64_solve_gap=gap)

    for arm in cfgs:
        arms[arm].update(fixed_point(arm, results[arm]))
    probe = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_prof = profile_run(lambda: probe.setdefault("tf32", run("checks16", 7)),
                                arms["checks16"]["seconds"], top=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    real_cached = kdtree.nn_search_kd_cached

    def planted(queries, index, max_distance, blk_ids, pose=None):
        idx, d2 = real_cached(queries, index, max_distance, blk_ids, pose=pose)
        row = torch.arange(idx.shape[-1], device=idx.device)
        moved = torch.where(idx % index.pages.shape[-1] > 0, idx - 1, idx + 1)
        return torch.where((idx >= 0) & (row % 8 == 0), moved, idx), d2

    kdtree.nn_search_kd_cached = planted
    try:
        faulty = run("checks16", 8)
        sync()
    finally:
        kdtree.nn_search_kd_cached = real_cached
    print("  probe, checks16 with TF32 on; its top kernels:", flush=True)
    for name, ms in tf32_prof.get("device_ms_by_kernel", {}).items():
        print(f"    device {ms:9.3f} ms  {name}")
    arms["checks16"]["probe_tf32"] = fixed_point("checks16", probe["tf32"])
    print("  probe, checks16 with the planted fault:", flush=True)
    fault = arms["checks16"]["probe_planted_fault"] = fixed_point("checks16", faulty)
    print("  colour path: " + json.dumps(arms))
    for arm in cfgs:
        check(arms[arm]["fixed_point_step_m"] <= FIXED_POINT_T_M,
              f"colour {arm}: one more f64-solved step moves no frame by more than "
              f"{FIXED_POINT_T_M * 1e3:g} mm")
        check(arms[arm]["f32_f64_solve_gap"] <= SOLVE_GAP_T_M,
              f"colour {arm}: the f32 solve agrees with the f64 one within {SOLVE_GAP_T_M:g}")
    check(fault["fixed_point_step_m"] > FIXED_POINT_T_M or fault["t_err_m"] > COLOR_T_ERR_TIGHT_M,
          "colour checks16: the planted fault crosses a gate")
    launches = collections.Counter()
    for arm in cfgs:
        launches.update(counts[arm])
    state = dict(sources=sources, targets=targets, tgt_host=tgt_host, cfgs=cfgs, kds=kds,
                 warm=warm, blk=blk, q_ap=q_ap)
    return rows, dict(launches), state


def color_errors(poses):
    """Per-frame translation error (max-abs, m) and rotation error (deg) of
    (B, 4, 4) f64 colour-path poses against the known camera shifts."""
    t_errs, r_errs = [], []
    for i, pose in enumerate(poses):
        gt_t = np.array([-TUM_SHIFT * (i + 1), 0.0, 0.0])
        t_errs.append(float(np.abs(pose[:3, 3] - gt_t).max()))
        r_errs.append(rotation_error_deg(pose[:3, :3]))
    return t_errs, r_errs


def fixed_point_step(cfg, fine, targets, fidx, kd, result):
    """One more stride-1 iteration of ``result``'s run at its final pose, as
    the driver's last level runs it: the arm's matcher on the card (seeded
    from ``result.match_blocks`` on the approximate arm; the cold exact
    search, equal to the warm one, on the exact arm), target rows,
    normal-angle rejection and the configuration's constant weights; the
    point-to-plane increment solved in f32 and in f64 on the same matches.
    Returns the largest translation of the f64 increment over the frames
    (m) and the largest entry gap between the f32 and f64 increments."""
    import torch

    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.ops import knn, rejection
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.solvers import linear

    pose, mask, cache = result.pose, fine.valid, result.match_blocks
    pts = se3.transform_points(fine.points, pose)
    first = torch.argmax(mask.to(torch.uint8), dim=-1)
    pts = torch.where(mask[..., None], pts, knn.take_rows(pts, first[:, None]))
    idx, _, valid, _ = icp._match_kd_stage(
        cfg.replace(multi_resolution=False), knn.color_features(pts, fine.colors), kd, fidx,
        mask, cache, cache is not None, None)
    tgt = knn.take_rows(icp._fuse_cloud_table(targets), idx.clamp(0, targets.capacity - 1))
    valid = valid & (tgt[..., 6] > 0.5)
    if cfg.rejection:
        valid = rejection.normal_angle_mask(
            se3.transform_normals(fine.normals, pose), tgt[..., 3:6], valid)
    # The f64 solve runs the plain version on the host: the card's solver
    # sums in f32 (csrc/normal_equations.cu).
    d32, d64 = (linear.estimate_pose_point_to_plane(
        pts.to(dev, dt), tgt[..., :3].to(dev, dt), tgt[..., 3:6].to(dev, dt),
        torch.ones(valid.shape, dtype=dt, device=dev), valid.to(dev))
        for dev, dt in ((pts.device, torch.float32), ("cpu", torch.float64)))
    return float(d64[:, :3, 3].abs().max()), float((d32.cpu().double() - d64).abs().max())


def projective_state(device):
    """The projective half of the JAX package's ``bench.prepare_tum_state``
    (``targets_img``, ``sources_ds``): frame 0 image-shaped (640 x 480 =
    307,200 rows, invalid pixels in place) as every frame's target, and
    frames 1-8 stride-8 compacted in xyz-Morton order (capacity 38,400) as
    the sources, on ``device``."""
    from icp_variants_tpu_torch.data import rgbd
    from icp_variants_tpu_torch.pipeline import icp

    K = np.array([[TUM_FX, 0, TUM_CX], [0, TUM_FY, TUM_CY], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    cap = TUM_W * TUM_H
    tgt = rgbd.cloud_from_depth(*synth_depth_frame(0), K, eye, keep_original_size=True,
                                capacity=cap, for_projective=True, device=device)
    srcs = [rgbd.cloud_from_depth(*synth_depth_frame(i), K, eye, keep_original_size=False,
                                  downsample_factor=PROJ_SOURCE_STRIDE,
                                  capacity=cap // PROJ_SOURCE_STRIDE, morton_order=True,
                                  device=device)
            for i in range(1, TUM_BATCH_FRAMES + 1)]
    return icp.stack_clouds([tgt] * TUM_BATCH_FRAMES), icp.stack_clouds(srcs)


def projective_configs():
    """The two arms: ``bench.bench_tum_projective``'s linear point-to-plane
    configuration, and the room run's (``room.default_config(matching=
    Matching.PROJECTIVE)``, main.cpp:211-268) point-to-point LM."""
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Matching, Metric, Minimizer

    room = ICPConfig(metric=Metric.POINT_TO_POINT, minimizer=Minimizer.NONLINEAR_LM,
                     n_iterations=TUM_ITERATIONS, max_distance=TUM_MAX_DISTANCE,
                     matching=Matching.PROJECTIVE)
    return {
        "linear": tum_base_config(matching=Matching.PROJECTIVE, projective_chunk=4096),
        "lm": room.with_camera(fx=TUM_FX, fy=TUM_FY, cx=TUM_CX, cy=TUM_CY, width=TUM_W,
                               height=TUM_H),
    }


def projective_queries(sources, pose):
    """Each frame's source points moved by ``pose``, masked rows pinned to
    the first valid row (as ``run_icp_batch`` does), and their pixels."""
    import torch

    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.ops import knn, projective

    mask = sources.valid
    pts = se3.transform_points(sources.points, pose)
    first = torch.argmax(mask.to(torch.uint8), dim=-1)
    q = torch.where(mask[..., None], pts, knn.take_rows(pts, first[:, None])).contiguous()
    return q, projective.project_pixels(q, TUM_FX, TUM_FY, TUM_CX, TUM_CY)


def edge_queries(b, device):
    """512 rows per frame: 384 whose pixels lie on and past each image edge
    (windows cut by the border or wholly outside it), and 128 projected far
    off the image, most of them clipped at +-1e6 (z = 0, near-zero z)."""
    import torch

    rng = np.random.default_rng(3)
    us = np.array([-13, -12, -7, 0, 5, 11, 12, 13, 320, TUM_W - 14, TUM_W - 13, TUM_W - 1,
                   TUM_W + 5, TUM_W + 11, TUM_W + 12, TUM_W + 13])
    vs = np.array([-13, -12, -1, 0, 12, 13, 240, TUM_H - 13, TUM_H - 1, TUM_H + 11,
                   TUM_H + 12, TUM_H + 13])
    pu, pv = (g.reshape(-1) for g in np.meshgrid(us, vs))
    pu, pv = np.tile(pu, 2), np.tile(pv, 2)
    z = rng.uniform(1.5, 2.5, len(pu))
    q = np.column_stack([(pu + rng.uniform(-0.45, 0.45, len(pu)) - TUM_CX) / TUM_FX * z,
                         (pv + rng.uniform(-0.45, 0.45, len(pu)) - TUM_CY) / TUM_FY * z, z])
    far = np.array([[1e4, 0.0, 1e-3], [-1e4, 0.0, 1e-3], [0.0, 1e4, 1e-3], [0.0, -1e4, 1e-3],
                    [1e3, 1e3, 0.0], [-1e3, -1e3, 0.0], [1e6, -1e6, 1.0], [0.5, 0.5, 0.0]])
    q = np.concatenate([q, np.tile(far, (16, 1))])
    return torch.from_numpy(np.tile(q.astype(np.float32), (b, 1, 1))).to(device)


def window_pixels(pix, valid_img):
    """Per query, the valid in-image pixels within the +-PROJ_WINDOW window
    of its pixel (the work the search needs), from a summed-area table."""
    import torch

    b = valid_img.shape[0]
    sat = torch.nn.functional.pad(
        valid_img.reshape(b, TUM_H, TUM_W).to(torch.int64).cumsum(1).cumsum(2), (1, 0, 1, 0))
    flat = sat.reshape(b, -1)

    def at(v, u):
        return torch.gather(flat, 1, (v * (TUM_W + 1) + u).long().reshape(b, -1)).reshape(v.shape)

    u_lo = torch.clamp(pix[..., 0] - PROJ_WINDOW, 0, TUM_W)
    u_hi = torch.clamp(pix[..., 0] + PROJ_WINDOW + 1, 0, TUM_W).maximum(u_lo)
    v_lo = torch.clamp(pix[..., 1] - PROJ_WINDOW, 0, TUM_H)
    v_hi = torch.clamp(pix[..., 1] + PROJ_WINDOW + 1, 0, TUM_H).maximum(v_lo)
    return at(v_hi, u_hi) - at(v_lo, u_hi) - at(v_hi, u_lo) + at(v_lo, u_lo)


def window_scan_f64(q, pix, img, ok):
    """Independent reference in numpy float64: per query the squared
    distance of every valid in-image pixel within +-PROJ_WINDOW of its
    pixel. Returns the (M, S, S) distances (inf elsewhere) and linear
    pixels."""
    d = np.arange(-PROJ_WINDOW, PROJ_WINDOW + 1)
    uu = pix[:, 0, None, None] + d[None, None, :]
    vv = pix[:, 1, None, None] + d[None, :, None]
    inside = (uu >= 0) & (uu < TUM_W) & (vv >= 0) & (vv < TUM_H)
    lin = np.where(inside, vv * TUM_W + uu, 0)
    d2 = ((img[lin] - q[:, None, None, :]) ** 2).sum(-1)
    return np.where(inside & ok[lin], d2, np.inf), lin


def projective_phase():
    """Phase 5 on the card: the projective RGB-D tracker; returns its kernel
    row and the launches of its main-path runs. Raises :class:`Failure`."""
    import torch

    from icp_variants_tpu_torch.ops import _cuda, projective
    from icp_variants_tpu_torch.pipeline import icp

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    targets, sources = projective_state(dev)
    cfgs = projective_configs()
    b, n = sources.valid.shape
    print(f"phase 5: projective path, {b} frames x {n} source rows against {targets.capacity}-row "
          f"image targets x {TUM_ITERATIONS} iterations; host data "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run(arm, seed):
        return icp.run_icp_batch(cfgs[arm], sources, targets, seed=seed, device=dev)

    t0 = time.perf_counter()
    warm = {arm: run(arm, 1) for arm in cfgs}
    sync()
    print(f"  warm-up runs: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the kernel against its plain version, every row -------------------
    tp, tv = targets.points, targets.valid
    kw = dict(width=TUM_W, height=TUM_H, window=PROJ_WINDOW)
    thr = TUM_MAX_DISTANCE

    def compare(q, pix, mask, what):
        ki, kd = projective.projective_window_search(q, pix, tp, tv, **kw)
        pi, pd = projective.projective_match_plain(q, pix, tp, tv, chunk=PROJ_PLAIN_ROWS, **kw)
        sync()
        check(torch.equal(ki, pi) and torch.equal(kd, pd)
              and torch.equal((kd <= thr) & mask, (pd <= thr) & mask),
              f"projective_window_search {what} (all {q.shape[0]} x {q.shape[1]} rows): idx, "
              f"d2 and valid equal to plain; {int((ki < 0).sum())} rows find no pixel")
        return ki, kd

    q_id, pix_id = projective_queries(sources, torch.eye(4, device=dev).expand(b, 4, 4))
    compare(q_id, pix_id, sources.valid, "at the identity pose")
    q_fin, pix_fin = projective_queries(sources, warm["linear"].pose)
    ki, kd = compare(q_fin, pix_fin, sources.valid, "at the linear warm-up's final poses")
    q_edge = edge_queries(b, dev)
    pix_edge = projective.project_pixels(q_edge, TUM_FX, TUM_FY, TUM_CX, TUM_CY)
    ei, _ = compare(q_edge, pix_edge, torch.ones_like(q_edge[..., 0], dtype=torch.bool),
                    "on rows at and past the image edges")
    check(bool((ei < 0).any()) and bool((ei >= 0).any())
          and bool((pix_edge.abs() == 1_000_000).any()),
          "the edge rows hold found rows, misses and clipped projections")
    need = window_pixels(pix_fin, tv)
    ms = time_ms(lambda: projective.projective_window_search(q_fin, pix_fin, tp, tv, **kw), 20)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    projective.projective_match_plain(q_fin, pix_fin, tp, tv, chunk=PROJ_PLAIN_ROWS, **kw)
    end.record()
    end.synchronize()
    row = dict(
        err=0.0, shapes=f"{b} x {n} queries, {b} x {TUM_W} x {TUM_H} image targets, window "
                        f"+-{PROJ_WINDOW}", ms=ms, plain_ms=start.elapsed_time(end),
        plain_on=f"the same rows, {PROJ_PLAIN_ROWS} rows per frame per step",
        bound=bound(b * n * (3 + 2 + 2) * 4 + b * TUM_W * TUM_H * (3 * 4 + 1),
                    int(need.sum()) * 9))
    print(f"  projective_window_search: kernel {ms:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound'][0]:.5f} ms ({row['bound'][1]}); {float(need.float().mean()):.1f} "
          f"valid pixels per window on average", flush=True)

    # Split by cause: the -DPWS_LOADS_ONLY build reads the same window rows
    # and takes no distance (its launches are not counted).
    def loads_only():
        idx = torch.empty((b, n), dtype=torch.int32, device=dev)
        d2 = torch.empty((b, n), dtype=torch.float32, device=dev)
        _cuda.launch("projective_window_search", q_fin, pix_fin, tp, tv, d2, idx, b, n, TUM_W,
                     TUM_H, PROJ_WINDOW, projective.BLOCK, defines=("PWS_LOADS_ONLY",))
        return idx

    check(bool((loads_only() == -1).all()),
          "projective_window_search, loads-only build: no row matched (idx -1 everywhere)")
    loads_ms = time_ms(loads_only, 20)
    row["split_ms"] = dict(loads=loads_ms, distance=ms - loads_ms)
    print(f"  projective_window_search by cause: window loads {loads_ms:.4f} ms (the "
          f"-DPWS_LOADS_ONLY build), distances and the warp's reduction {ms - loads_ms:.4f} ms",
          flush=True)

    # ---- independent check: a float64 window scan on 4,096 rows of frame 0 --
    rows = torch.nonzero(sources.valid[0]).flatten()
    rows = rows[torch.linspace(0, len(rows) - 1, PROJ_CHECK_ROWS, device=dev).long()]
    img = tp[0].cpu().numpy().astype(np.float64)
    ok = tv[0].cpu().numpy()
    q64 = q_fin[0, rows].cpu().numpy().astype(np.float64)
    d2_64, lin = window_scan_f64(q64, pix_fin[0, rows].cpu().numpy().astype(np.int64), img, ok)
    m64 = d2_64.reshape(len(rows), -1).min(1)
    k_i, k_d = ki[0, rows].cpu().numpy(), kd[0, rows].cpu().numpy()
    found = k_i >= 0
    in_window = np.array([k_i[j] in lin[j][np.isfinite(d2_64[j])] for j in range(len(rows))])
    kd64 = ((img[np.clip(k_i, 0, None)] - q64) ** 2).sum(1)
    eps = np.finfo(np.float32).eps
    check(bool(np.all(in_window[found])) and bool(np.all(np.isinf(m64[~found])))
          and bool(np.all(kd64[found] <= m64[found] * (1 + 8 * eps) + 1e-12))
          and np.allclose(k_d[found], m64[found], rtol=1e-5, atol=1e-9)
          and bool(np.all(m64[k_d > thr] > thr * (1 - 1e-5))),
          f"projective_window_search == a float64 window scan on {len(rows)} rows of frame 0 "
          f"at its final pose ({int(found.sum())} found, {int((k_d <= thr).sum())} within the "
          "threshold; every miss has no valid pixel within it)")

    # ---- both arms end to end ----------------------------------------------
    walls, issues, counts, results = timed_runs(
        {arm: (lambda seed, arm=arm: run(arm, seed)) for arm in cfgs})
    arms = {}
    for arm in cfgs:
        dt, issued = float(np.median(walls[arm])), float(np.median(issues[arm]))
        poses = results[arm].pose.cpu().numpy().astype(np.float64)
        nm = results[arm].trace.num_matches.cpu().numpy()
        check(poses.shape == (b, 4, 4) and np.isfinite(poses).all(),
              f"projective {arm}: {b} finite 4x4 poses")
        t_errs, r_errs = color_errors(poses)
        gap = np.abs(poses[:, :3, 3] - np.asarray(JAX_PROJECTIVE_T[arm])).max(1)
        arms[arm] = dict(
            frames_per_s=b / dt, seconds=dt, seconds_each=walls[arm], host_issue_s=issued,
            t_err_m=float(np.mean(t_errs)), t_err_each_m=t_errs, r_err_deg=float(np.mean(r_errs)),
            translations=poses[:, :3, 3].tolist(), jax_gap_m=gap.tolist(),
            mean_matches_per_iter=float(nm.mean()), launches=counts[arm])
        print(f"  projective {arm}: {b / dt:.4f} frames/s (median of {N_TIMED_RUNS} runs: "
              f"{dt:.4f} s per batch, host issue {issued:.4f} s; runs "
              f"{[round(w, 4) for w in walls[arm]]}), mean t_err {np.mean(t_errs) * 1e3:.4f} mm "
              f"(the JAX package's CPU reading {JAX_PROJECTIVE_T_ERR_M[arm] * 1e3:.4f} mm), mean "
              f"r_err {np.mean(r_errs):.6f} deg, matches/iter {nm.mean():.1f}, per-frame "
              f"translation gap to the JAX package's CPU reading max {gap.max():.3e} m, "
              f"launches {counts[arm]}", flush=True)
        check(counts[arm].get("projective_window_search", 0) == TUM_ITERATIONS,
              f"projective {arm}: projective_window_search launched {TUM_ITERATIONS} times")
    for arm in cfgs:
        prof = profile_run(lambda: run(arm, 99), arms[arm]["seconds"], top=10)
        arms[arm].update(prof)
        print(f"  projective {arm} profile: device {prof['device_ms']} ms, busy share "
              f"{prof.get('device_busy_share')}, {prof.get('kernel_launches')} launches")
        for name, t in prof.get("device_ms_by_kernel", {}).items():
            print(f"    device {t:9.3f} ms  {name}")

    # ---- the fixed point, and what the gates see of a planted fault ----------
    for arm in cfgs:
        steps, gap = projective_fixed_point(cfgs[arm], sources, targets, results[arm].pose)
        arms[arm].update(fixed_point_step_m=max(steps), fixed_point_steps_m=steps,
                         f32_f64_solve_gap=gap)
        print(f"  projective {arm}: one more step at the final pose, solved in f64, moves a "
              f"frame by at most {max(steps) * 1e3:.6f} mm (per frame "
              f"{[round(x * 1e3, 6) for x in steps]} mm); the f32 solve of that step differs "
              f"from it by {gap:.3e}", flush=True)
    real_search = projective.projective_window_search

    def planted(*args, **kwargs):
        idx, d2 = real_search(*args, **kwargs)
        row_i = torch.arange(idx.shape[-1], device=idx.device)
        moved = torch.where(idx % TUM_W < TUM_W - 1, idx + 1, idx - 1)
        return torch.where((idx >= 0) & (row_i % 8 == 0), moved, idx), d2

    probes = {}
    projective.projective_window_search = planted
    try:
        faulty = {arm: run(arm, 8) for arm in cfgs}
        sync()
    finally:
        projective.projective_window_search = real_search
    for arm in cfgs:
        poses = faulty[arm].pose.cpu().numpy().astype(np.float64)
        step = max(projective_fixed_point(cfgs[arm], sources, targets, faulty[arm].pose)[0])
        probes[arm] = dict(
            t_err_m=float(np.mean(color_errors(poses)[0])), fixed_point_step_m=step,
            jax_gap_m=float(np.abs(poses[:, :3, 3] - np.asarray(JAX_PROJECTIVE_T[arm])).max()))
        arms[arm]["probe_planted_fault"] = probes[arm]
        print(f"  probe, {arm} with every 8th match moved to the next pixel of its row: mean "
              f"t_err {probes[arm]['t_err_m'] * 1e3:.4f} mm, fixed-point step "
              f"{step * 1e3:.6f} mm, gap to the JAX reading {probes[arm]['jax_gap_m']:.3e} m",
              flush=True)
    print("  projective path: " + json.dumps(arms))
    # The gates, after every reading is printed.
    for arm in cfgs:
        check(arms[arm]["t_err_m"] <= PROJ_T_ERR_LIMIT_M,
              f"projective {arm}: mean t_err <= {PROJ_T_ERR_LIMIT_M * 1e3:g} mm")
        check(max(arms[arm]["jax_gap_m"]) <= PROJ_JAX_GAP_M,
              f"projective {arm}: every frame's final translation within "
              f"{PROJ_JAX_GAP_M:g} m of the JAX package's CPU reading")
        check(arms[arm]["fixed_point_step_m"] <= PROJ_FIXED_POINT_T_M[arm],
              f"projective {arm}: one more f64-solved step moves no frame by more than "
              f"{PROJ_FIXED_POINT_T_M[arm] * 1e3:g} mm")
        check(probes[arm]["fixed_point_step_m"] > PROJ_FIXED_POINT_T_M[arm]
              and probes[arm]["jax_gap_m"] > PROJ_JAX_GAP_M,
              f"projective {arm}: the planted fault crosses the fixed-point gate and the "
              "agreement with the JAX package's reading")
    launches = collections.Counter()
    for arm in cfgs:
        launches.update(counts[arm])
    return {"projective_window_search": row}, dict(launches)


def projective_fixed_point(cfg, sources, targets, pose):
    """One more iteration of the projective tracker at ``pose``, as
    ``run_icp_batch`` runs it (the window search on the card, target rows,
    normal-angle rejection, constant weights), its increment solved in f32
    by the arm's solver and in f64: the linear point-to-plane solve in f64,
    or for the LM arm scipy's ``least_squares`` on the same point-to-point
    residuals (solved to convergence). Returns each frame's largest
    translation component of the f64 increment (m) and the largest entry
    gap between the f32 and f64 increments (4x4)."""
    import torch
    from scipy.optimize import least_squares
    from scipy.spatial.transform import Rotation

    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.ops import knn, projective, rejection
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import Minimizer
    from icp_variants_tpu_torch.solvers import gauss_newton, linear

    q, _ = projective_queries(sources, pose)
    idx, _, valid = projective.projective_match(
        q, targets.points, targets.valid, fx=TUM_FX, fy=TUM_FY, cx=TUM_CX, cy=TUM_CY,
        width=TUM_W, height=TUM_H, window=PROJ_WINDOW, max_distance=cfg.max_distance,
        query_mask=sources.valid)
    tgt = knn.take_rows(icp._fuse_cloud_table(targets), idx.clamp(0, targets.capacity - 1))
    valid = valid & (tgt[..., 6] > 0.5)
    src_n = se3.transform_normals(sources.normals, pose)
    if cfg.rejection:
        valid = rejection.normal_angle_mask(src_n, tgt[..., 3:6], valid)
    w = torch.ones(valid.shape, device=valid.device)
    if cfg.minimizer == Minimizer.LINEAR:
        # The f64 solve runs the plain version on the host (fixed_point_step).
        d32, d64 = (linear.estimate_pose_point_to_plane(
            q.to(dev, dt), tgt[..., :3].to(dev, dt), tgt[..., 3:6].to(dev, dt), w.to(dev, dt),
            valid.to(dev))
            for dev, dt in ((q.device, torch.float32), ("cpu", torch.float64)))
        return (d64[:, :3, 3].abs().amax(-1).tolist(),
                float((d32.cpu().double() - d64).abs().max()))
    d32 = gauss_newton.estimate_pose_lm(
        cfg.metric, q, tgt[..., :3], src_n, tgt[..., 3:6], w, valid,
        max_iterations=cfg.lm_max_inner_iterations,
        function_tolerance=cfg.lm_function_tolerance).double().cpu().numpy()
    steps, gap = [], 0.0
    for i in range(q.shape[0]):
        keep = valid[i].cpu().numpy()
        s = q[i].cpu().numpy().astype(np.float64)[keep]
        d = tgt[i, :, :3].cpu().numpy().astype(np.float64)[keep]

        def resid(x, s=s, d=d):
            R = Rotation.from_rotvec(x[:3]).as_matrix()
            return (0.1 * (s @ R.T + x[3:] - d)).reshape(-1)

        x = least_squares(resid, np.zeros(6), method="lm", xtol=1e-12, ftol=1e-12,
                          gtol=1e-12).x
        inc = np.eye(4)
        inc[:3, :3], inc[:3, 3] = Rotation.from_rotvec(x[:3]).as_matrix(), x[3:]
        steps.append(float(np.abs(x[3:]).max()))
        gap = max(gap, float(np.abs(d32[i] - inc).max()))
    return steps, gap


# Phase 5b, the linear solvers' reduction (csrc/normal_equations.cu) at
# the main paths' shapes: (label, pairs, rows a pair, metric).
NE_SHAPES = (("colour", 8, 307_200, "plane"), ("projective", 64, 38_400, "plane"),
             ("eth", 176, 4_352, "symmetric"))
NE_REPS = 50
NE_PLAIN_REPS = 5
# Its f32 sums against the float64 sum of the same rows: within this share
# of the sum of the terms' magnitudes, each row's factors taken at their
# parts' magnitudes (so a rounded difference such as n.d - n.s counts at
# its parts' size). Some 170 units of f32 rounding, against about 12
# roundings in a term and sums about 30 additions deep (8 rows a thread,
# 8 levels of a CTA's tree, 8 of the chunks'); all-zero terms sum to 0.
NE_TOL = 1e-5


def ne_rows(seed, b, n):
    """(src, table, src_normals, weights, valid) numpy arrays of ``b``
    pairs x ``n`` matches at the ETH sweep's 20 m scale: a smooth sheet
    moved by a small rigid motion with noise, NaN target and inf source
    normals, zero weights and invalid rows; the target points and normals
    as columns 0-2 and 3-5 of a (B, N, 8) row table, as the pipeline
    gathers them."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, (b, n, 2))
    z = 2.0 * np.sin(0.3 * xy[..., 0]) * np.cos(0.2 * xy[..., 1])
    tgt = np.concatenate([xy, z[..., None]], -1)
    nt = np.stack([-0.6 * np.cos(0.3 * xy[..., 0]) * np.cos(0.2 * xy[..., 1]),
                   0.4 * np.sin(0.3 * xy[..., 0]) * np.sin(0.2 * xy[..., 1]),
                   np.ones((b, n))], -1)
    nt /= np.linalg.norm(nt, axis=-1, keepdims=True)
    src = tgt + rng.normal(0, 0.1, (b, 1, 3)) + rng.normal(0, 0.01, (b, n, 3))
    ns = nt + rng.normal(0, 0.01, (b, n, 3))
    nt[:, ::13, 1] = np.nan
    ns[:, 5::17, 2] = np.inf
    weights = rng.uniform(0.0, 1.0, (b, n))
    weights[:, ::11] = 0.0
    valid = rng.random((b, n)) > 0.15
    table = np.zeros((b, n, 8), np.float32)
    table[..., :3], table[..., 3:6] = tgt, nt
    return (src.astype(np.float32), table, ns.astype(np.float32),
            weights.astype(np.float32), valid)


def ne_solver_args(metric, arrays, device):
    """``linear.normal_equations``' arguments on ``device`` from
    :func:`ne_rows`' arrays: the target points and normals as views of the
    row table, the centres the f32 matched means (the target's for both
    under point-to-plane)."""
    import torch

    src, table, ns, weights, valid = arrays
    w = valid.astype(np.float64)[..., None]
    den = np.maximum(w.sum(1), 1e-12)
    ct = ((table[..., :3] * w).sum(1) / den).astype(np.float32)
    cs = ct if metric == "plane" else ((src * w).sum(1) / den).astype(np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (src, table, ns, weights, valid, cs, ct)]
    return (t[0], t[1][..., :3], t[1][..., 3:6], t[2] if metric == "symmetric" else None,
            *t[3:])


def ne_sums64(metric, args):
    """Float64 ``(ata, atb)`` of the solvers' rows on ``args``
    (:func:`ne_solver_args`' order), and the sums of the terms' magnitudes
    the tolerance reads: numpy (B, 6, 6), (B, 6) each."""
    src, tgt, tn, sn, weights, valid, cs, ct = (
        None if a is None else a.cpu().numpy().astype(np.float64) for a in args)
    s, d = src - cs[:, None], tgt - ct[:, None]
    w = weights * valid
    fin = np.isfinite(tn).all(-1)
    nt = np.where(np.isfinite(tn), tn, 0.0)
    if metric == "plane":
        n, p = nt, s
        rhs = (n * d).sum(-1) - (n * s).sum(-1)
        rhs_mag = (np.abs(n * d) + np.abs(n * s)).sum(-1)
    else:
        n, p = np.where(np.isfinite(sn), sn, 0.0) + nt, s + d
        fin = fin & np.isfinite(sn).all(-1)
        rhs = ((d - s) * n).sum(-1)
        rhs_mag = ((np.abs(d) + np.abs(s)) * np.abs(n)).sum(-1)

    def cross(u, v, sign=-1.0):
        return np.stack([u[..., 1] * v[..., 2] + sign * u[..., 2] * v[..., 1],
                         u[..., 2] * v[..., 0] + sign * u[..., 0] * v[..., 2],
                         u[..., 0] * v[..., 1] + sign * u[..., 1] * v[..., 0]], -1)

    z, o = np.zeros_like(s[..., 0]), np.ones_like(s[..., 0])
    point = [np.stack(r, -1) for r in ([z, s[..., 2], -s[..., 1], o, z, z],
                                       [-s[..., 2], z, s[..., 0], z, o, z],
                                       [s[..., 1], -s[..., 0], z, z, z, o])]
    rows = [np.concatenate([cross(p, n), n], -1)] + point
    mags = [np.concatenate([cross(np.abs(p), np.abs(n), 1.0), np.abs(n)], -1)]
    mags += [np.abs(r) for r in point]
    rhss = [rhs] + [d[..., k] - s[..., k] for k in range(3)]
    rhs_mags = [rhs_mag] + [np.abs(d[..., k]) + np.abs(s[..., k]) for k in range(3)]
    from icp_variants_tpu_torch.solvers import linear

    qs = [(linear.LAMBDA_PLANE * w * fin) ** 2] + [(linear.LAMBDA_POINT * w) ** 2] * 3

    def total(spec, a_of, r_of):
        return sum(np.einsum(spec, q, a, *([a] if r is None else [r]))
                   for q, a, r in zip(qs, a_of, r_of))

    return (total("bn,bni,bnj->bij", rows, [None] * 4),
            total("bn,bni,bn->bi", rows, rhss),
            total("bn,bni,bnj->bij", mags, [None] * 4),
            total("bn,bni,bn->bi", mags, rhs_mags))


def ne_gap(got, want, mag) -> tuple[float, float]:
    """The largest absolute gap of the f32 sums ``got`` (a tensor) from the
    float64 ``want``, and the largest gap as a share of its tolerance
    (``NE_TOL`` x ``mag``; inf where a zero tolerance is missed)."""
    got = got.double().cpu().numpy()
    gap = np.abs(got - want)
    allowed = NE_TOL * mag
    share = np.where(allowed > 0, gap / np.where(allowed > 0, allowed, 1.0),
                     np.where(gap > 0, np.inf, 0.0))
    return float(gap.max()), float(share.max()) if np.isfinite(got).all() else float("inf")


def normal_equations_phase() -> dict:
    """Phase 5b: ``csrc/normal_equations.cu`` at the colour, projective and
    ETH shapes (``NE_SHAPES``) on :func:`ne_rows`' data: ``ata`` and
    ``atb`` against the float64 sum of the same rows within ``NE_TOL``,
    two launches equal bit for bit, CUDA-event ms a launch (``queued_ms``;
    the profiler's kernel time beside it) next to its byte bound, the plain
    version on the card (the Jacobian columns and four
    batched cuBLAS products, what the solvers ran before the kernel) and
    those four ``bmm`` products alone on prebuilt Jacobians as
    ``library_ms`` (timed only: the port never calls them). Returns the
    kernel's row, the colour shapes' at the top, the others under their
    labels."""
    import torch

    from icp_variants_tpu_torch.solvers import linear

    print("phase 5b: the normal equations", flush=True)
    dev = torch.device("cuda")
    out = {}
    for i, (label, b, n, metric) in enumerate(NE_SHAPES):
        args = ne_solver_args(metric, ne_rows(100 + i, b, n), dev)
        got = linear.normal_equations(*args)
        again = linear.normal_equations(*args)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"normal_equations {label} ({b} x {n}, {metric}): two launches equal bit for bit")
        a64, b64, amag, bmag = ne_sums64(metric, args)
        (ea, sa), (eb, sb) = ne_gap(got[0], a64, amag), ne_gap(got[1], b64, bmag)
        check(max(sa, sb) <= 1.0,
              f"normal_equations {label}: ata and atb within {NE_TOL:g} of the terms' "
              f"magnitudes of the float64 sum (largest share of the tolerance {max(sa, sb):.3f})")
        ms = queued_ms(lambda: linear.normal_equations(*args), NE_REPS)
        prof_ms = kernel_split(lambda: linear.normal_equations(*args), "normal_equations",
                               ("kernel",), reps=NE_REPS)["kernel"]
        src, tgt, tn, sn, w, v, cs, ct = args

        def plain():
            wv = w * v.to(w.dtype)
            return linear._accumulate_normal_equations_soa(
                linear._row_specs(src, tgt, tn, sn, wv, cs, ct))

        plain_ms = time_ms(plain, NE_PLAIN_REPS)
        wv = w * v.to(w.dtype)
        jac = []
        for cols, rhs, rw in linear._row_specs(src, tgt, tn, sn, wv, cs, ct):
            J = torch.stack([torch.zeros_like(rhs) if c is None else
                             (torch.full_like(rhs, c) if isinstance(c, float) else c)
                             for c in cols], dim=-1)
            jac.append(((rw * rw)[..., None] * J, J))

        def products():
            return [wj.transpose(-1, -2) @ j for wj, j in jac]

        library_ms = time_ms(products, NE_PLAIN_REPS)
        del jac
        row_bytes = 4 * (3 * (4 if metric == "symmetric" else 3) + 1) + 1
        nbytes = b * n * row_bytes + b * 4 * (6 + 36 + 6)
        nops = b * n * 160  # f32 operations a row, about the same on either arm
        bnd = bound(nbytes, nops)
        out[label] = dict(
            ms=ms, profiler_ms=prof_ms, plain_ms=plain_ms, library_ms=library_ms, bound=bnd,
            err=max(ea, eb),
            tol_share=max(sa, sb), shapes=dict(pairs=b, rows=n, metric=metric,
                                               chunk_rows=linear.normal_equation_chunks(n)[0],
                                               chunks=linear.normal_equation_chunks(n)[1]),
            plain_on="every row, on the card (column stacks and cuBLAS bmm)")
        print(f"  normal_equations {label} ({b} x {n}, {metric}): {ms:.4f} ms a launch "
              f"(queued CUDA events; the profiler's kernel time {prof_ms:.4f}), bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}, {nbytes / 1e6:.1f} MB), {bnd[0] / ms:.1%} of it; "
              f"plain {plain_ms:.4f} ms, cuBLAS bmm alone {library_ms:.4f} ms; largest gap "
              f"from the float64 sum {max(ea, eb):.3e} ({max(sa, sb):.3f} of the tolerance)",
              flush=True)
    row = dict(out["colour"])
    row.update({k: v for k, v in out.items() if k != "colour"})
    row["err"] = max(r["err"] for r in out.values())
    return {"normal_equations": row}


# Phase 5c, the linear solvers' tail (csrc/pose_step.cu) at the three
# cells' batches: (label, pairs, metric). The tail sees the batch alone;
# its normal equations are summed from PS_ROWS rows a pair.
PS_SHAPES = (("colour", 8, "plane"), ("projective", 64, "plane"), ("eth", 176, "symmetric"))
PS_ROWS = 4_096
PS_REPS = 200
PS_PLAIN_REPS = 10
# The kernel's increment against the plain version in float64
# on the same f32 inputs, in f32 ulps of each entry's magnitude: the kernel
# rounds its float64 answer once (half an ulp), the rest is float64
# rounding.
PS_ULPS = 4
PS_MAX_MS = 0.010   # a launch at the ETH batch


def ps_inputs(metric, b, seed, device):
    """``linear.pose_step``'s operands but the recovery: ``(ata, atb,
    center_src, center_tgt)`` of ``b`` pairs, the normal equations of
    :func:`ne_rows`' matches (PS_ROWS a pair) about their centres."""
    from icp_variants_tpu_torch.solvers import linear

    args = ne_solver_args(metric, ne_rows(seed, b, PS_ROWS), device)
    ata, atb = linear.normal_equations(*args)
    return ata, atb, args[6], args[7]


def ps_tail64(ata, atb, cs, ct, symmetric):
    """The plain tail (``linear._plain_pose_step``) in float64 on the host
    from the same f32 operands: the numpy increment."""
    from icp_variants_tpu_torch.solvers import linear

    return linear._plain_pose_step(*(t.double().cpu() for t in (ata, atb, cs, ct)),
                                   symmetric).numpy()


def ps_ulps(got, want) -> float:
    """The largest gap of the f32 tensor ``got`` from the float64 ``want``
    in f32 ulps of each entry's magnitude (inf where ``got`` is not
    finite; an entry of 0 must be met exactly)."""
    got = got.double().cpu().numpy()
    if not np.isfinite(got).all():
        return float("inf")
    spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return float((np.abs(got - want) / spacing).max())


def pose_step_phase() -> dict:
    """Phase 5c: ``csrc/pose_step.cu`` at the three cells' batches
    (``PS_SHAPES``) on :func:`ps_inputs`: the increment within
    ``PS_ULPS`` of the float64 plain tail, two launches equal bit
    for bit, its CUDA-event ms a launch (``queued_ms``; the profiler's
    kernel time beside it; at most ``PS_MAX_MS`` at the ETH batch), the
    plain version on the card (PyTorch ops in f32: device ms queued, host
    ms a call, kernels a call, and its own gap in ulps, not gated) and
    both sides' host ms a call. The kernel is bound by its latency: its
    byte bound is printed beside it. Returns the kernel's row, the colour
    batch's at the top, the others under their labels."""
    import torch

    from icp_variants_tpu_torch.solvers import linear

    print("phase 5c: the pose step", flush=True)
    dev = torch.device("cuda")
    out = {}

    def host_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    for i, (label, b, metric) in enumerate(PS_SHAPES):
        sym = metric == "symmetric"
        ata, atb, cs, ct = ps_inputs(metric, b, 300 + i, dev)

        def kernel():
            return linear.pose_step(ata, atb, cs, ct, sym)

        def plain():
            return linear._plain_pose_step(ata, atb, cs, ct, sym)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              f"pose_step {label} ({b} pairs, {metric}): two launches equal bit for bit")
        want = ps_tail64(ata, atb, cs, ct, sym)
        ulps = ps_ulps(got, want)
        check(ulps <= PS_ULPS,
              f"pose_step {label}: increment within {PS_ULPS} f32 ulps of the "
              f"float64 plain tail (largest {ulps:.2f})")
        plain_ulps = ps_ulps(plain(), want)
        ms = queued_ms(kernel, PS_REPS)
        prof_ms = kernel_split(kernel, "pose_step", ("kernel",), reps=PS_REPS)["kernel"]
        plain_ms = queued_ms(plain, PS_PLAIN_REPS)
        kernel_host_ms, plain_host_ms = host_ms(kernel, PS_REPS), host_ms(plain, PS_PLAIN_REPS)
        plain_kernels = profile_run(plain, 1.0, cpu=False).get("kernel_launches")
        nbytes = b * 4 * (36 + 6 + 3 + 3 + 16)
        bnd = (nbytes / PEAK_BYTES * 1e3, "latency (the byte bound beside it)")
        if label == "eth":
            check(ms <= PS_MAX_MS, f"pose_step eth: {ms * 1e3:.2f} us a launch, at most "
                                   f"{PS_MAX_MS * 1e3:.0f} us")
        out[label] = dict(
            ms=ms, profiler_ms=prof_ms, plain_ms=plain_ms, host_ms=kernel_host_ms,
            plain_host_ms=plain_host_ms, plain_kernels=plain_kernels, bound=bnd, err=ulps,
            plain_err=plain_ulps, shapes=dict(pairs=b, metric=metric),
            plain_on="every pair, on the card (PyTorch ops in f32: solve_ex and the "
                     "recovery)")
        print(f"  pose_step {label} ({b} pairs, {metric}): {ms * 1e3:.2f} us a launch (queued "
              f"CUDA events; the profiler's kernel time {prof_ms * 1e3:.2f} us), byte bound "
              f"{bnd[0] * 1e3:.3f} us; host {kernel_host_ms:.4f} ms a call; plain on the card "
              f"{plain_ms:.4f} ms of device time, {plain_host_ms:.4f} ms of host time and "
              f"{plain_kernels} kernels a call; largest gap from the float64 tail {ulps:.2f} "
              f"ulps (plain f32 {plain_ulps:.2f})", flush=True)
    row = dict(out["colour"])
    row.update({k: v for k, v in out.items() if k != "colour"})
    row["err"] = max(r["err"] for r in out.values())
    return {"pose_step": row}


def dense_queries(sources, pose):
    """Each pair's source points moved by ``pose``, masked rows pinned to the
    first valid row (as ``run_icp_batch`` does)."""
    import torch

    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.ops import knn

    pts = se3.transform_points(sources.points, pose)
    first = torch.argmax(sources.valid.to(torch.uint8), dim=-1)
    return torch.where(sources.valid[..., None], pts, knn.take_rows(pts, first[:, None])).contiguous()


def stage_records(fn):
    """``fn()`` (one ``run_icp_batch``) with each iteration's matching stage
    (queries, idx, d2, valid) and normal-angle test (source normals, the
    validity it leaves) recorded; returns ``(fn(), records)``, one dict an
    iteration."""
    from icp_variants_tpu_torch.ops import rejection
    from icp_variants_tpu_torch.pipeline import icp

    with Spy(icp, "_match_kd_stage",
             keep=lambda a, kw, out: dict(q=a[1], idx=out[0], d2=out[1], kv=out[2])) as m, \
            Spy(rejection, "normal_angle_mask",
                keep=lambda a, kw, out: dict(n_src=a[0], fin=out)) as r:
        out = fn()
    check(len(m.calls) == len(r.calls) == N_ITERATIONS,
          f"dense: {N_ITERATIONS} matching stages and normal-angle tests recorded in a run")
    return out, [{**x, **y} for x, y in zip(m.calls, r.calls)]


def warm_cold_parting(rec_w, rec_c, kd, targets) -> dict:
    """The gate that holds the dense warm run to the cold one, iteration by
    iteration and row by row (records of :func:`stage_records`).

    Per pair, the runs' matches (which rows match, and the idx and d2 of
    each) and the rows they count are equal bit for bit up to the first
    iteration where some row's matches differ. There the queries are still
    equal, and every row whose matches differ is an exact f32 tie: both
    runs match it at one d2, to two target points, each at that d2 from the
    query in the JAX package's order of operations, the warm one at the
    lower page index. (The cold search, ``kd_block_search``, takes a tie in
    its earliest ``box_topk`` pick; the warm search past the resident rule,
    ``kd_radius_search``, at the lowest page index. The JAX package's warm
    and cold matchers part on exact ties as well, by their kernels' own
    rules: ``tests/test_torch_warm.py``,
    ``test_warm_and_cold_part_only_on_exact_ties``.) Only those rows may count
    differently there. The other normal moves the solve by rounding, and
    after it every row the runs count differently is one the measured
    rounding explains: matched to two points at d2s within what the query
    shift allows (a near-tie); or matched in one run only, within that of
    the distance bound; or matched alike, its two cosines on both sides of
    the normal-angle threshold within what the source normals' shift
    allows. The validity model behind this (kd-stage validity, the target
    row's validity, the angle test, computed as the pipeline does) must
    reproduce both runs' counted rows at every iteration. Raises
    :class:`Failure` on a failed check; returns what it read."""
    import torch

    from icp_variants_tpu_torch.ops import knn, rejection
    from icp_variants_tpu_torch.pipeline import icp

    eps = float(np.finfo(np.float32).eps)
    cos_th = math.cos(rejection.ANGLE_THRESHOLD_RAD)
    table = icp._fuse_cloud_table(targets)
    b = table.shape[0]

    def differs(w, c):
        return (w["kv"] != c["kv"]) | (w["kv"] & c["kv"] & (
            (w["idx"] != c["idx"]) | (w["d2"] != c["d2"])))

    def d2_direct(q, p):
        diff = q - p
        return diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]

    def counted(rec):
        """The rows a run counts, as the pipeline decides them: matched, a
        valid target row, not rejected by the angle test."""
        rows = knn.take_rows(table, torch.clamp(rec["idx"], 0, table.shape[-2] - 1))
        nt, ns = rows[..., 3:6], rec["n_src"]
        cos = torch.sum(ns * nt, dim=-1) / (torch.linalg.norm(ns, dim=-1)
                                            * torch.linalg.norm(nt, dim=-1))
        reject = (cos < cos_th) & ~torch.isnan(cos)
        return rec["kv"] & (rows[..., 6] > 0.5) & ~reject, cos, reject

    first = [N_ITERATIONS] * b
    for t in reversed(range(N_ITERATIONS)):
        d = differs(rec_w[t], rec_c[t]).any(-1).tolist()
        first = [t if x else f for x, f in zip(d, first)]
    ties = [[] for _ in range(b)]
    kinds = [collections.Counter() for _ in range(b)]
    gaps = [{} for _ in range(b)]
    model_ok, before_ok, after_bad = True, [True] * b, [[] for _ in range(b)]
    for t in range(N_ITERATIONS):
        w, c = rec_w[t], rec_c[t]
        (fw, cw, rw), (fc, cc, rc) = counted(w), counted(c)
        model_ok &= torch.equal(fw, w["fin"]) and torch.equal(fc, c["fin"])
        flip = fw != fc
        for i in range(b):
            gap = int(fw[i].sum()) - int(fc[i].sum())
            if gap:
                gaps[i][t] = gap
            if t < first[i]:
                before_ok[i] &= not bool(flip[i].any())
                continue
            if t == first[i]:
                rows = torch.nonzero(differs(w, c)[i]).flatten()
                q = w["q"][i, rows]
                iw, ic = w["idx"][i, rows].long(), c["idx"][i, rows].long()
                pages = kd.page_orig[i].long()
                pw = [int(torch.nonzero(pages == j)[0]) for j in iw.tolist()]
                pc = [int(torch.nonzero(pages == j)[0]) for j in ic.tolist()]
                d2 = w["d2"][i, rows]
                check(torch.equal(w["q"][i], c["q"][i])
                      and bool((w["kv"][i, rows] & c["kv"][i, rows]).all())
                      and bool((iw != ic).all()) and torch.equal(d2, c["d2"][i, rows])
                      and torch.equal(d2_direct(q, targets.points[i, iw]), d2)
                      and torch.equal(d2_direct(q, targets.points[i, ic]), d2)
                      and all(a < z for a, z in zip(pw, pc)),
                      f"dense pair {i}: the runs part at iteration {t} on {len(rows)} exact f32 "
                      "tie(s): the queries equal; each row matched in both runs at one d2, to "
                      "two target points at that d2, the warm one at the lower page index")
                tied = torch.zeros_like(flip[i])
                tied[rows] = True
                check(not bool((flip[i] & ~tied).any()),
                      f"dense pair {i} iteration {t}: only the tied rows count differently")
                kinds[i]["tie"] += int(flip[i].sum())
                ties[i] = [dict(iteration=t, row=r, d2=x, warm=[a, p1], cold=[z, p2])
                           for r, x, a, z, p1, p2 in zip(rows.tolist(), d2.tolist(),
                                                         iw.tolist(), ic.tolist(), pw, pc)]
                continue
            r = torch.nonzero(flip[i]).flatten()
            if not len(r):
                continue
            dq = torch.linalg.norm(w["q"][i, r].double() - c["q"][i, r].double(), dim=-1)
            dn = torch.linalg.norm(w["n_src"][i, r].double() - c["n_src"][i, r].double(), dim=-1)
            d2w, d2c = w["d2"][i, r].double(), c["d2"][i, r].double()
            kvw, kvc = w["kv"][i, r], c["kv"][i, r]
            same = w["idx"][i, r] == c["idx"][i, r]
            dmax = torch.maximum(d2w, d2c).clamp(min=0)
            tol_d2 = (2 * dmax.sqrt() + dq) * dq + 8 * eps * dmax
            near_tie = ~same & kvw & kvc & ((d2w - d2c).abs() <= tol_d2)
            at_bound = (kvw != kvc) & (MAX_DISTANCE - torch.where(kvw, d2w, d2c) <= tol_d2)
            cw_r, cc_r = cw[i, r].double(), cc[i, r].double()
            at_angle = (same & kvw & kvc & (rw[i, r] != rc[i, r])
                        & ((cw_r - cc_r).abs() <= 2 * dn + 8 * eps))
            bad = torch.nonzero(~(near_tie | at_bound | at_angle)).flatten().tolist()
            for j in bad[:4]:
                print(f"    pair {i} iteration {t} row {int(r[j])}: warm idx "
                      f"{int(w['idx'][i, r[j]])} d2 {float(d2w[j])!r} cos {float(cw_r[j])!r}; "
                      f"cold idx {int(c['idx'][i, r[j]])} d2 {float(d2c[j])!r} cos "
                      f"{float(cc_r[j])!r}; query shift {float(dq[j]):.3e}, source normal "
                      f"shift {float(dn[j]):.3e}", flush=True)
            after_bad[i] += [(t, int(r[j])) for j in bad]
            kinds[i]["near tie"] += int(near_tie.sum())
            kinds[i]["distance bound"] += int((at_bound & ~near_tie).sum())
            kinds[i]["angle threshold"] += int((at_angle & ~near_tie & ~at_bound).sum())
    check(model_ok, f"dense: the validity model reproduces both runs' counted rows in all "
                    f"{N_ITERATIONS} iterations")
    kinds = [{k: v for k, v in x.items() if v} for x in kinds]
    for i in range(b):
        check(before_ok[i], f"dense pair {i}: warm == cold, the matches and the counted rows "
                            f"equal bit for bit in iterations 0-{first[i] - 1}")
        check(not after_bad[i],
              f"dense pair {i}: each row counted differently after the runs part lies within "
              f"the runs' rounding of a tie, the distance bound or the angle threshold "
              f"(unexplained (iteration, row): {after_bad[i][:8]})")
        print(f"  dense pair {i}: warm and cold "
              + ("equal bit for bit in every iteration" if first[i] == N_ITERATIONS else
                 f"equal bit for bit until iteration {first[i]}, where they part on "
                 f"{len(ties[i])} exact tie(s) ("
                 + "; ".join(f"row {x['row']} at d2 {x['d2']!r}: warm idx {x['warm'][0]} page "
                             f"{x['warm'][1]}, cold idx {x['cold'][0]} page {x['cold'][1]}"
                             for x in ties[i])
                 + f"); after it, rows counted differently by cause {kinds[i]}, count gaps "
                   f"warm - cold by iteration {gaps[i]}"), flush=True)
    return dict(parted_at=first, ties=ties, counted_differently=kinds, count_gaps=gaps)


def needed_work(kd, q, sel, d2):
    """Bytes and f32 operations a search over each query's picked blocks
    needs on these inputs: the blocks whose box lower bound is <= the
    query's result distance (its NN distance, or its radius where nothing
    was found), 3D operations per real point of them, and each needed
    (pair, block)'s real points once, besides the query, radius, pick and
    output bytes."""
    import torch

    b, n, d = q.shape
    k = sel.shape[-1]
    blk = sel.clamp(min=0).long()
    bi = torch.arange(b, device=q.device)[:, None, None].expand_as(blk)
    gap = torch.clamp_min(torch.maximum(kd.block_min[bi, blk] - q[:, :, None],
                                        q[:, :, None] - kd.block_max[bi, blk]), 0.0)
    need = (sel >= 0) & ((gap * gap).sum(-1) <= d2[..., None])
    block_real = (kd.block_orig >= 0).sum(-1)                       # (B, nc)
    need_pts = int(block_real[bi[need], blk[need]].sum())
    used = torch.zeros(block_real.shape, dtype=torch.bool, device=q.device)
    used[bi[need], blk[need]] = True
    nbytes = b * n * (d + 1 + k + 2) * 4 + int(block_real[used].sum()) * d * 4
    return nbytes, need_pts * 3 * d, need_pts, int(used.sum())


def fallback_row(label, q, radii, fidx, valid, reps):
    """visited_search at a fallback's real radii (``radii`` >= 0 on the
    rows whose certificate failed, -1 elsewhere): the kernel on every row;
    each live row held equal to the plain version (the live rows gathered
    to the front of each pair, the plain version in windows of rows), each
    frozen row (radius, -1); the tiles each live row needs (box bound <= its
    result d2); kernel ms, plain ms over the live rows, and the bound (its
    query, radius and result bytes, each touched tile's real points once,
    3D operations per needed real point). Returns the row's dict."""
    import torch

    from icp_variants_tpu_torch.ops import knn

    b, n, d = q.shape
    live = radii >= 0
    vd, vi = knn.visited_search(q, radii, fidx)
    live_n = live.sum(1)
    n_live = int(live_n.sum())
    l_max = max(int(live_n.max()), 1)
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True)[:, :l_max]
    lq = knn.take_rows(q, order)
    lr = torch.where(knn.take_rows(live, order), knn.take_rows(radii, order), -1.0)
    (lp_d, lp_i), plain_ms = plain_pass(
        lambda s, e: knn.visited_search_plain(lq[:, s:e].contiguous(), lr[:, s:e].contiguous(),
                                              fidx), l_max)
    ld, li = knn.take_rows(vd, order), knn.take_rows(vi, order)
    check(torch.equal(ld, lp_d) and torch.equal(li, lp_i)
          and torch.equal(vd[~live], radii[~live]) and bool((vi[~live] == -1).all()),
          f"visited_search {label}: all {n_live} live rows of {b * n} equal to plain, every "
          "frozen row (radius, -1)")
    n_tiles, tile_t = fidx.points_t3.shape[1], fidx.points_t3.shape[-1]
    cap = valid.shape[1]
    tile_real = torch.nn.functional.pad(valid.to(torch.int64), (0, n_tiles * tile_t - cap))
    tile_real = tile_real.reshape(b, n_tiles, tile_t).sum(-1).float()
    need_tiles, need_pts = 0, 0
    touched = torch.zeros((b, n_tiles), dtype=torch.bool, device=q.device)
    for s in range(0, l_max, 8192):
        e = min(s + 8192, l_max)
        lb = knn.box_lb(lq[:, s:e], fidx.bbox_min[..., :d], fidx.bbox_max[..., :d])
        need = (lb <= ld[:, s:e, None]) & (lr[:, s:e] >= 0)[..., None]
        need_tiles += int(need.sum())
        need_pts += int(torch.bmm(need.float(), tile_real[:, :, None]).double().sum())
        touched |= need.any(1)
        del lb, need
    row = dict(
        err=float((ld - lp_d).abs().max()), live_rows=n_live,
        tiles_needed_per_live_row=need_tiles / max(n_live, 1),
        ms=time_ms(lambda: knn.visited_search(q, radii, fidx), reps), plain_ms=plain_ms,
        plain_on="the same live rows only (frozen rows need no work)",
        bound=bound(b * n * 3 * 4 + n_live * d * 4 + int(tile_real[touched].sum()) * d * 4,
                    need_pts * 3 * d))
    print(f"  visited_search {label}: {n_live} live rows of {b * n} ({int(live_n.max())} in "
          f"the fullest pair), each needs {row['tiles_needed_per_live_row']:.2f} of {n_tiles} "
          f"tiles ({need_pts} real points in all); kernel {row['ms']:.4f} ms, plain "
          f"{plain_ms:.4f} ms on the live rows, bound {row['bound'][0]:.5f} ms "
          f"({row['bound'][1]})", flush=True)
    return row


def dense_phase():
    """Phase 6 on the card: dense exact registration of 1,000,000-point
    scans with caller-built kd indexes past the resident rule, and the
    600,000-point packed-size pair. Returns the kernel rows and the launches
    of the main-path run. Raises :class:`Failure` on a failed check."""
    import torch
    from scipy.spatial import cKDTree

    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import _cuda, kdtree, knn
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer, Selection

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    torch.cuda.empty_cache()
    print(f"phase 6: dense exact path past the resident rule, {DENSE_PAIRS} pairs x "
          f"{DENSE_POINTS} points x {N_ITERATIONS} iterations", flush=True)
    t0 = time.perf_counter()
    pairs = make_indoor_pairs(DENSE_PAIRS, DENSE_POINTS)
    sources = icp.stack_clouds([
        cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
        for sp, sn, _, _ in pairs])
    targets_host = [cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
                    for _, _, tp, tn in pairs]
    targets = icp.stack_clouds(targets_host).to(dev)
    sync()
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kd = kdtree.stack_kd_indexes([
        kdtree.build_kd_index(t.points, t.valid, device=dev) for t in targets_host])
    sync()
    kd_s = time.perf_counter() - t0
    b, cap = sources.valid.shape
    nc, cap_pad = kd.pages.shape[1], kd.pages.shape[-1]
    print(f"  host data: {b} pairs x {cap} rows, {data_s:.1f} s; host kd build (not in the "
          f"metric): {kd_s:.2f} s for {nc} blocks of cap_pad {cap_pad}", flush=True)
    cfg = ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                    selection=Selection.ALL, n_iterations=N_ITERATIONS,
                    max_distance=MAX_DISTANCE, matching_checks=0, kd_warm_start=True)
    check(icp._warm_applies(cfg) and icp.build_kd_for(cfg, targets_host[0], device=dev) is None,
          "the warm rule applies, and build_kd_for gives no kd index past the resident rule")
    check(kdtree._resident_layout(kd) == (False, False),
          f"the {nc} x {cap_pad} kd table lies past the resident rule, unpacked and packed")

    def run(c):
        return icp.run_icp_batch(c, sources, targets, kd_indexes=kd, device=dev)

    # The warm-up and the cold run record each iteration's matching stage
    # and normal-angle test, which the warm == cold gate below reads.
    t0 = time.perf_counter()
    warm0, rec_w = stage_records(lambda: run(cfg))
    sync()
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold, rec_c = stage_records(lambda: run(cfg.replace(kd_warm_start=False)))
    sync()
    cold_s = time.perf_counter() - t0
    print(f"  warm-up run {warmup_s:.2f} s; cold run (kd_warm_start=False) {cold_s:.4f} s "
          "(both recorded)", flush=True)
    warm_cold = warm_cold_parting(rec_w, rec_c, kd, targets)
    del rec_w, rec_c
    torch.cuda.empty_cache()
    walls, issues, counts, results = timed_runs({"warm": lambda seed: run(cfg)})
    res, launches = results["warm"], counts["warm"]
    dt, issued = float(np.median(walls["warm"])), float(np.median(issues["warm"]))
    poses = res.pose.cpu().numpy().astype(np.float64)
    nm = res.trace.num_matches.cpu().numpy()
    check(poses.shape == (b, 4, 4) and np.isfinite(poses).all(), f"dense: {b} finite 4x4 poses")
    t_errs, r_errs = [], []
    for i in range(b):
        resid = poses[i] @ indoor_true_pose(i).astype(np.float64)
        t_errs.append(float(np.abs(resid[:3, 3]).max()))
        r_errs.append(rotation_error_deg(resid[:3, :3]))
    gap = float((res.pose - cold.pose).abs().max())
    arm = dict(pairs_per_s=b / dt, seconds=dt, seconds_each=walls["warm"], host_issue_s=issued,
               cold_seconds=cold_s, host_data_s=data_s, host_kd_build_s=kd_s,
               t_err_m=float(np.mean(t_errs)), t_err_each_m=t_errs,
               r_err_deg=float(np.mean(r_errs)), mean_matches_per_iter=float(nm.mean()),
               warm_cold_pose_gap=gap, launches=launches)
    print(f"  dense warm: {b / dt:.4f} pairs/s (median of {N_TIMED_RUNS} runs: {dt:.4f} s per "
          f"batch, host issue {issued:.4f} s; runs {[round(w, 4) for w in walls['warm']]}); cold "
          f"{cold_s:.4f} s; mean t_err {np.mean(t_errs) * 1e3:.4f} mm (per pair "
          f"{[round(x * 1e3, 4) for x in t_errs]}), mean r_err {np.mean(r_errs):.6f} deg, "
          f"matches/iter {nm.mean():.1f}, warm-cold pose gap {gap:.3e}, launches {launches}",
          flush=True)
    check(torch.allclose(res.pose, cold.pose, rtol=1e-4, atol=1e-5),
          "dense: warm and cold final poses within rtol 1e-4, atol 1e-5")
    for name in ("box_topk", "kd_radius_search", "visited_search"):
        check(launches.get(name, 0) >= N_ITERATIONS,
              f"dense warm: {name} launched >= {N_ITERATIONS} times in the timed run")
    check(launches.get("kd_block_search", 0) == 0,
          "dense warm: kd_block_search not launched (the route past the rule)")

    check(torch.equal(warm0.pose, res.pose) and torch.equal(warm0.trace.rmse, res.trace.rmse)
          and torch.equal(warm0.trace.num_matches, res.trace.num_matches),
          "dense: the recorded warm-up run equals the timed warm run bit for bit (poses, RMSE "
          "and match counts of every iteration)")
    arm["warm_cold"] = warm_cold
    del warm0

    # ---- kd_radius_search against its plain version, every row -------------
    bv = knn.bound_value(MAX_DISTANCE)
    mask = sources.valid
    feats = targets.points
    fidx = knn.build_target_index(feats, tile_t=knn.V2_TILE_T)
    q0 = dense_queries(sources, torch.eye(4, device=dev).expand(b, 4, 4))
    qf = dense_queries(sources, res.pose)
    gran = torch.arange(cap, device=dev) // cfg.kd_warm_granule
    empty = torch.full((b, int(gran[-1]) + 1), -1, dtype=torch.int32, device=dev)
    _, _, _, cache = icp._match_kd_stage(cfg, qf, kd, fidx, mask, empty, False, feats)
    cached_r = kdtree.warm_radius(qf, cache[:, gran], feats, MAX_DISTANCE, mask)[0]

    boxes = (kd.block_min, kd.block_max, kd.pages)
    row = dict(err=0.0)
    for label, q, r in (("first iteration's radii (the bound)", q0, torch.where(mask, bv, -1.0)),
                        ("final pose's cached radii", qf, cached_r)):
        binit = torch.clamp(r, max=bv).contiguous()
        sel, resid = kdtree.box_topk(q, binit, kd.block_min, kd.block_max, 4)
        if label.startswith("first"):
            # box_topk at the dense path's shapes: the first warm iteration's
            # queries and radii (an empty cache: the bound, -1 on masked rows).
            (sel_p, resid_p), box_plain_ms = plain_pass(
                lambda s, e: kdtree.box_topk_plain(q[:, s:e], binit[:, s:e], kd.block_min,
                                                   kd.block_max, 4), cap)
            check(torch.equal(sel, sel_p) and torch.equal(resid, resid_p),
                  f"box_topk k=4 at the {label} ({nc} blocks, all {b} x {cap} rows): sel and "
                  "resid equal to plain")
            box_row = dict(
                err=float((resid - resid_p).abs().nan_to_num(0.0).max()),
                ms=time_ms(lambda: kdtree.box_topk(q, binit, kd.block_min, kd.block_max, 4), 20),
                plain_ms=box_plain_ms,
                bound=bound(b * cap * (3 + 1 + 4 + 1) * 4 + b * nc * 3 * 2 * 4,
                            b * cap * nc * (6 * 3 - 1 + 4 + 1)),
                shapes=f"{b} x {cap} rows (D = 3), k = 4, {nc} blocks, the {label}",
                plain_on=f"the same rows, in windows of {PLAIN_CHUNK_ROWS}")
            print(f"  box_topk k=4 at the {label}: kernel {box_row['ms']:.4f} ms, plain "
                  f"{box_plain_ms:.4f} ms, bound {box_row['bound'][0]:.5f} ms "
                  f"({box_row['bound'][1]})", flush=True)
            del sel_p, resid_p
        del resid
        d2, idx = knn.kd_radius_search(q, binit, *boxes, sel)
        (d2_p, idx_p), plain_ms = plain_pass(
            lambda s, e: knn.kd_radius_search_plain(q[:, s:e], binit[:, s:e], *boxes,
                                                    sel[:, s:e]), cap)
        check(torch.equal(d2, d2_p) and torch.equal(idx, idx_p),
              f"kd_radius_search k=4 at the {label} (all {b} x {cap} rows): d2 and idx equal to "
              f"plain; {int((idx >= 0).sum())} found")
        row["err"] = max(row["err"], float((d2 - d2_p).abs().max()))
        nbytes, nops, need_pts, distinct = needed_work(kd, q, sel, d2)
        ms = time_ms(lambda: knn.kd_radius_search(q, binit, *boxes, sel), 10)
        print(f"  kd_radius_search k=4 at the {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms; {need_pts} real points needed, {distinct} distinct (pair, block)", flush=True)
        if label.startswith("final"):
            row.update(ms=ms, plain_ms=plain_ms, bound=bound(nbytes, nops),
                       shapes=f"{b} x {cap} rows (D = 3), k = 4, {nc} blocks of {cap_pad} slots, "
                              "the final pose's cached radii",
                       plain_on=f"the same rows, in windows of {PLAIN_CHUNK_ROWS}")
        else:
            row.update(first_iteration_ms=ms, first_iteration_plain_ms=plain_ms,
                       first_iteration_bound_ms=bound(nbytes, nops)[0])
        del d2, idx, d2_p, idx_p, sel
        torch.cuda.empty_cache()
    b0 = torch.clamp(cached_r[:1], max=bv).contiguous()
    box0 = (kd.block_min[:1], kd.block_max[:1], kd.pages[:1])
    d2, idx = knn.kd_radius_search(qf[:1], b0, *box0)
    # Smaller windows: a cache-less granule's rows search every block within
    # the bound, so a window's widest row may hold a hundred blocks.
    (d2_p, idx_p), plain0_ms = plain_pass(
        lambda s, e: knn.kd_radius_search_plain(qf[:1, s:e], b0[:, s:e], *box0), cap, rows=512)
    check(torch.equal(d2, d2_p) and torch.equal(idx, idx_p),
          f"kd_radius_search k=0 on pair 0 (all {cap} rows, cached radii): d2 and idx equal to "
          f"plain; {int((idx >= 0).sum())} found")
    row["k0_pair0"] = dict(ms=time_ms(lambda: knn.kd_radius_search(qf[:1], b0, *box0), 10),
                           plain_ms=plain0_ms)
    print(f"  kd_radius_search k=0 on pair 0: kernel {row['k0_pair0']['ms']:.4f} ms, plain "
          f"{plain0_ms:.4f} ms; bound {row['bound'][0]:.5f} ms ({row['bound'][1]}) at k=4",
          flush=True)
    del d2, idx, d2_p, idx_p

    # ---- visited_search at the fallback's real inputs ----------------------
    # The rows whose top-k certificate fails at the final pose's cached radii
    # (match_kd_warm's fail) search within the bound; the rest are frozen.
    fail = kdtree.nn_search_kd_warm(qf, kd, MAX_DISTANCE, cached_r)[2]
    fradii = torch.where(fail, bv, -1.0).to(torch.float32).contiguous()
    vrow = fallback_row("at the dense fallback's radii", qf, fradii, fidx, targets.valid, 10)
    vrow["shapes"] = (f"{b} x {cap} rows (D = 3), {vrow['live_rows']} live (the final pose's "
                      f"certificate failures), {fidx.points_t3.shape[1]} tiles of "
                      f"{knn.V2_TILE_T}")
    del fail, fradii

    # ---- pair 0's warm matcher at its final pose against cKDTree ----------
    kd0 = kdtree.KDIndex(*(None if f is None else f[:1] for f in kd))
    fidx0 = knn.TargetIndex(*(f[:1] for f in fidx))
    mi, md, mv = kdtree.match_kd_warm(qf[:1], kd0, MAX_DISTANCE, cache[:1, gran], feats[:1],
                                      mask[:1], fallback_index=fidx0)
    mi, md, mv = (x[0].cpu().numpy() for x in (mi, md, mv))
    t_np = targets_host[0].points.numpy()
    rows_ok = np.flatnonzero(targets_host[0].valid.numpy())
    dref, iref = cKDTree(t_np[rows_ok]).query(qf[0].cpu().numpy(), k=1, workers=8)
    iref, d2ref = rows_ok[iref], dref * dref
    real = mask[0].cpu().numpy()                   # padding rows search nothing
    within = (d2ref <= MAX_DISTANCE) & real
    clear = np.abs(d2ref - MAX_DISTANCE) > 1e-4
    same = (mi == iref) | np.isclose(md, d2ref, rtol=1e-6, atol=0)
    print(f"  pair 0's warm matcher at its final pose: {int(mv.sum())} of {int(real.sum())} rows "
          f"matched, {int((same & mv).sum())} equal to cKDTree, {int(within.sum())} within the "
          "threshold by cKDTree", flush=True)
    check(bool(np.all((mv == within)[clear])) and bool(np.all(same[mv & within]))
          and np.allclose(md[mv], d2ref[mv], rtol=1e-5, atol=1e-6),
          f"dense: every match of pair 0's {int(real.sum())} rows at its final pose == cKDTree "
          "within the threshold")

    prof = profile_run(lambda: run(cfg), dt, top=10)
    arm.update(prof)
    print(f"  dense warm profile: device {prof['device_ms']} ms, busy share "
          f"{prof.get('device_busy_share')}, {prof.get('kernel_launches')} launches")
    for name, t in prof.get("device_ms_by_kernel", {}).items():
        print(f"    device {t:9.3f} ms  {name}")
    del sources, targets, kd, fidx, cache, cached_r, q0, qf, res, cold, kd0, fidx0
    torch.cuda.empty_cache()

    # ---- the packed-size pair: within the rule through kd_block_search ------
    sp, sn, tp, tn = make_indoor_pairs(1, DENSE_PACKED_POINTS)[0]
    src = icp.stack_clouds([cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)])
    tgt_h = cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
    kdp = kdtree.stack_kd_indexes([kdtree.build_kd_index(tgt_h.points, tgt_h.valid, device=dev)])
    tgt = icp.stack_clouds([tgt_h]).to(dev)
    ncp, cpp = kdp.pages.shape[1], kdp.pages.shape[-1]
    check(kdtree._resident_layout(kdp) == (True, True),
          f"the {DENSE_PACKED_POINTS}-point table ({ncp} x {cpp}) takes the JAX package's packed "
          "layout")
    fidx_p = knn.build_target_index(tgt.points, tile_t=knn.V2_TILE_T)
    cap_p = src.capacity
    gran = torch.arange(cap_p, device=dev) // cfg.kd_warm_granule
    cache = torch.full((1, int(gran[-1]) + 1), -1, dtype=torch.int32, device=dev)
    qp = dense_queries(src, torch.eye(4, device=dev)[None])
    _cuda.reset_launches()
    for _ in range(2):
        pidx, _, pvalid = kdtree.match_kd_warm(qp, kdp, MAX_DISTANCE, cache[:, gran], tgt.points,
                                               src.valid, fallback_index=fidx_p)
        radius = kdtree.warm_radius(qp, cache[:, gran], tgt.points, MAX_DISTANCE, src.valid)[0]
        cache = icp._granule_update(cache, pidx, pvalid, cfg.kd_warm_granule)
    sync()
    check(_cuda.LAUNCHES["kd_block_search"] == 2 and _cuda.LAUNCHES["kd_radius_search"] == 0,
          f"packed-size pair: two match_kd_warm calls, {int(pvalid.sum())} of {cap_p} rows "
          "matched, through kd_block_search (not kd_radius_search)")
    binit = torch.clamp(radius, max=bv).contiguous()
    sel = kdtree.box_topk(qp, binit, kdp.block_min, kdp.block_max, 4)[0]
    d2, idx = kdtree.kd_block_search(qp, sel, binit, kdp.pages)
    (d2_p, idx_p), plain_ms = plain_pass(
        lambda s, e: kdtree.kd_block_search_plain(qp[:, s:e], sel[:, s:e], binit[:, s:e],
                                                  kdp.pages), cap_p)
    check(torch.equal(d2, d2_p), f"kd_block_search on the packed-size pair (all {cap_p} rows at "
          "the second call's warm radii): d2 equal to plain")
    _tie_or_equal(idx, idx_p, d2, qp, kdp.pages, "kd_block_search on the packed-size pair")
    nbytes, nops, need_pts, _ = needed_work(kdp, qp, sel, d2)
    packed = dict(err=float((d2 - d2_p).abs().max()),
                  ms=time_ms(lambda: kdtree.kd_block_search(qp, sel, binit, kdp.pages), 10),
                  plain_ms=plain_ms, bound=bound(nbytes, nops),
                  shapes=f"1 x {cap_p} rows (D = 3), k = 4, {ncp} blocks of {cpp} slots, warm radii")
    print(f"  kd_block_search on the packed-size pair: kernel {packed['ms']:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {packed['bound'][0]:.5f} ms ({packed['bound'][1]})",
          flush=True)
    print("  dense path: " + json.dumps(arm))
    check(arm["t_err_m"] <= DENSE_T_ERR_LIMIT_M,
          f"dense: mean t_err <= {DENSE_T_ERR_LIMIT_M * 1e3:g} mm")
    check(arm["r_err_deg"] <= DENSE_R_ERR_LIMIT_DEG,
          f"dense: mean r_err <= {DENSE_R_ERR_LIMIT_DEG:g} deg")
    return ({"kd_radius_search": row, "kd_block_search_packed": packed, "box_topk_dense": box_row,
             "visited_search_dense": vrow}, dict(launches))


def expansion_tol(q, t, d):
    """First-order rounding bound of the expansion's d2 for f64 rows ``q``
    against ``t``: (2D + 2) * 2^-24 * (|q|^2 + |t|^2) (the D products and
    sums of each norm and of q.t, each rounded once)."""
    return (2 * d + 2) * 2.0 ** -24 * ((q ** 2).sum(-1) + (t ** 2).sum(-1))


def expansion_vs_ckdtree(q, t_real, rows_ok, idx, d2, bound_val=None):
    """Hold an expansion search's answers (``idx`` into the target rows,
    ``d2``) for f64 queries ``q`` against cKDTree over the real target rows
    ``t_real`` (``rows_ok`` their row numbers): each returned point is a
    real row whose exact distance lies within the rounding of the kernel's
    d2 and of cKDTree's distance, and with ``bound_val`` a row is found
    exactly where cKDTree's distance lies below the bound by more than the
    rounding (and not where it lies above by more). Returns None on a
    failure, else (rows found, rows whose index equals cKDTree's, the worst
    share of the tolerance used)."""
    from scipy.spatial import cKDTree

    d = q.shape[-1]
    dref, jref = cKDTree(t_real).query(q, k=1, workers=-1)
    d2ref, iref = dref * dref, rows_ok[jref]
    e_ref = expansion_tol(q, t_real[jref], d)
    found = idx >= 0
    if bound_val is not None:
        clear = np.abs(d2ref - bound_val) > 2 * e_ref
        if not (np.all(found[(d2ref < bound_val) & clear])
                and not np.any(found[(d2ref > bound_val) & clear])):
            return None
    pos = np.searchsorted(rows_ok, idx[found])
    if np.any(pos >= len(rows_ok)) or np.any(rows_ok[np.minimum(pos, len(rows_ok) - 1)]
                                             != idx[found]):
        return None                                      # not a real target row
    qf, tf = q[found], t_real[pos]
    exact = ((qf - tf) ** 2).sum(-1)
    e_ret = expansion_tol(qf, tf, d)
    gap = np.abs(d2[found].astype(np.float64) - exact) / e_ret
    over = (exact - d2ref[found]) / (e_ret + e_ref[found])
    if gap.max(initial=0) > 1 or over.max(initial=0) > 1 or over.min(initial=0) < -1e-6:
        return None
    same = int((idx[found] == iref[found]).sum())
    return int(found.sum()), same, float(max(gap.max(initial=0), over.max(initial=0)))


def cell_work(visit, q_real, t_real, tile_q, tile_t, d):
    """Bytes and f32 operations the pruned search needs: 3D operations per
    (real query, real target) pair of each visited (query tile, target
    tile) cell; each query, visit byte and output once, each visited target
    tile's real rows once."""
    import torch

    b, nqt, ntt = visit.shape
    rq = torch.nn.functional.pad(q_real.long(), (0, nqt * tile_q - q_real.shape[1]))
    rq = rq.reshape(b, nqt, tile_q).sum(-1).double()
    rt = torch.nn.functional.pad(t_real.long(), (0, ntt * tile_t - t_real.shape[1]))
    rt = rt.reshape(b, ntt, tile_t).sum(-1).double()
    pairs = float(torch.einsum("bij,bi,bj->", visit.double(), rq, rt))
    touched = visit.any(1)
    n = q_real.shape[1]
    nbytes = b * n * (d + 1 + 2) * 4 + float(rt[touched].sum()) * (d + 1) * 4 + visit.numel()
    return nbytes, pairs * 3 * d, pairs


def matcher_inputs(src, tgt, frame, ctgt) -> dict:
    """Phase 7's matcher inputs, on the clouds' device (also those of
    ``scripts/nn_ab.py``): ETH pair 0 (``src`` against ``tgt``, Morton
    ordered) with the rows that the p = 0.01 mask (``mask``) leaves out at
    the pad sentinel (``q3``) against its target rows (``t3``), for the
    dense search; its compacted query slots (``qk``, live where ``qm``, a
    dead slot repeating the first live row), for the pruned one; colour
    ``frame``'s features, invalid rows at the sentinel (``q6``), against
    the target ``ctgt``'s (``t6``)."""
    import torch

    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import knn, selection
    from icp_variants_tpu_torch.pipeline import icp

    dev = src.points.device
    mask = selection.random_sampling(torch.Generator(device=dev).manual_seed(0), src.valid,
                                     SELECTION_P)
    q3 = torch.where(mask[:, None], src.points, cloud_lib.PAD_SENTINEL)[None].contiguous()
    k_cap = icp._compact_capacity(src.capacity, SELECTION_P)
    sel_idx, in_range = selection.bernoulli_gap_indices(
        torch.Generator(device=dev).manual_seed(0), SELECTION_P, 1, src.capacity, k_cap,
        batch=(1,), device=dev)
    src_b = icp.stack_clouds([src])
    qc, qm = icp._compact_cloud(src_b, icp._fuse_cloud_table(src_b), sel_idx, in_range, False)
    first = torch.argmax(qm.to(torch.uint8), dim=-1)
    qk = torch.where(qm[..., None], qc.points, knn.take_rows(qc.points, first[:, None]))
    q6 = knn.color_features(torch.where(frame.valid[:, None], frame.points,
                                        cloud_lib.PAD_SENTINEL), frame.colors)[None]
    t6 = knn.color_features(ctgt.points, ctgt.colors)[None]
    return dict(mask=mask, q3=q3, t3=tgt.points[None].contiguous(), qk=qk.contiguous(), qm=qm,
                q6=q6.contiguous(), t6=t6.contiguous())


def matcher_phase(colour):
    """Phase 7 on the card: the dense matcher behind ``knn.match`` (TPU
    kernel 6) as the per-stage profiler feeds it, ``profile_stages`` itself,
    the tile-pruned matcher (TPU kernel 7) and the seeded search's pose
    mode (TPU kernel 2e) at full width. ``colour`` is the colour phase's
    state. Returns the kernel rows and the launches of the profile path.
    Raises :class:`Failure` on a failed check."""
    import torch

    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import _cuda, kdtree, knn
    from icp_variants_tpu_torch.pipeline import icp, profiling
    from icp_variants_tpu_torch.pipeline.config import (
        ICPConfig, Metric, Minimizer, Selection,
    )

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    print("phase 7: the dense matcher and its profiler, the tile-pruned matcher, the seeded "
          "search's pose mode", flush=True)
    t0 = time.perf_counter()
    sp, sn, tp, tn = make_pairs(1)[0]
    src = cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
    tgt_h = cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
    tgt = tgt_h.to(dev)
    cap = src.capacity
    print(f"  host data: ETH pair 0, {cap} rows; {time.perf_counter() - t0:.1f} s", flush=True)
    rows = {}

    # ---- kernel 6 at both widths, as profile_stages feeds it ---------------
    def dense_check(label, q, t, q_ok, t_ok, plain_rows=PLAIN_CHUNK_ROWS):
        """dense_nn_search on (1, N, D) queries against (1, M, D) targets:
        against its plain version on every row, and on the ``q_ok`` rows
        against cKDTree over the ``t_ok`` rows."""
        d = q.shape[-1]
        idx, d2 = knn.dense_nn_search(q, t)
        (idx_p, d2_p), plain_ms = plain_pass(lambda s, e: knn.nn_search_xla(q[:, s:e], t),
                                            q.shape[1], rows=plain_rows)
        check(torch.equal(idx, idx_p) and torch.equal(d2, d2_p),
              f"dense_nn_search D={d} ({label}, all {q.shape[1]} rows): idx and d2 equal to plain")
        rows_ok = np.flatnonzero(t_ok[0].cpu().numpy())
        sel = q_ok[0].cpu().numpy()
        res = expansion_vs_ckdtree(q[0].cpu().numpy()[sel].astype(np.float64),
                                   t[0].cpu().numpy()[rows_ok].astype(np.float64), rows_ok,
                                   idx[0].cpu().numpy()[sel], d2[0].cpu().numpy()[sel])
        check(res is not None,
              f"dense_nn_search D={d} ({label}): on all {int(sel.sum())} selected rows the "
              f"returned point's exact distance is within the expansion's rounding "
              f"((2D+2) 2^-24 (|q|^2+|t|^2)) of the kernel's d2 and of cKDTree's")
        n_real_t = len(rows_ok)
        row = dict(err=float((d2 - d2_p).abs().max()),
                   ms=time_ms(lambda: knn.dense_nn_search(q, t), 5), plain_ms=plain_ms,
                   bound=bound(q.shape[1] * (d + 2) * 4 + t.shape[1] * d * 4,
                               q.shape[1] * n_real_t * 3 * d),
                   shapes=f"1 x {q.shape[1]} rows against {t.shape[1]} ({n_real_t} real), D = {d}",
                   plain_on=f"the same rows, in windows of {plain_rows}")
        print(f"  dense_nn_search D={d} ({label}): kernel {row['ms']:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {row['bound'][0]:.5f} ms ({row['bound'][1]}), the "
              f"contract's issue floor {issue_floor(q.shape[1] * n_real_t, d):.5f} ms; "
              f"{res[1]} of {res[0]} selected rows equal to cKDTree's index, worst "
              f"{res[2]:.3f} of the rounding tolerance", flush=True)
        row["split_ms"] = kernel_split(lambda: knn.dense_nn_search(q, t), "dense_nn_search",
                                       ("pack", "walk"), reps=2)
        print(f"  dense_nn_search D={d} ({label}) by launch (profiler, ms a launch): "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["split_ms"].items()), flush=True)
        row["rescans"] = rescan_reading(f"dense_nn_search D={d} ({label})",
                                        lambda defs: knn._dense_nn_search_launch(q, t, defs),
                                        (idx, d2))
        return row

    frame = icp.Cloud(*(f[0] for f in colour["sources"]))
    ctgt = colour["tgt_host"].to(dev)
    ins = matcher_inputs(src, tgt, frame, ctgt)
    rows["dense_nn_search"] = dense_check("ETH pair 0, p = 0.01 mask-based, unselected rows at "
                                          "the pad sentinel", ins["q3"], ins["t3"],
                                          ins["mask"][None], tgt.valid[None])
    rows["dense_nn_search_colour"] = dense_check("colour frame 1 against frame 0", ins["q6"],
                                                 ins["t6"], frame.valid[None], ctgt.valid[None])
    del ins["q3"]
    torch.cuda.empty_cache()

    # ---- profile_stages at full width -------------------------------------
    eth_cfg = ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                        selection=Selection.RANDOM, selection_proba=SELECTION_P,
                        n_iterations=N_ITERATIONS, max_distance=MAX_DISTANCE)
    reports, launches = {}, collections.Counter()
    for label, cfg, s_, t_ in (("ETH headline, pair 0", eth_cfg, src, tgt),
                               ("colour exact, frame 1", colour["cfgs"]["exact"], frame, ctgt)):
        _cuda.reset_launches()
        times = profiling.profile_stages(cfg, s_, t_, repetitions=3, device=dev)
        n6 = _cuda.LAUNCHES["dense_nn_search"]
        launches.update(_cuda.LAUNCHES)
        print(f"  profile_stages ({label}):", flush=True)
        for line in times.report().splitlines():
            print(f"    {line}")
        fields = [times.selection, times.matching, times.weighting, times.rejection,
                  times.solver, times.total_wall]
        check(all(np.isfinite(f) and f >= 0 for f in fields) and times.matching > 0,
              f"profile_stages ({label}): finite, non-negative stage times")
        check(n6 == 4, f"profile_stages ({label}): dense_nn_search launched {n6} times "
                       "(warm-up + 3)")
        reports[label] = dict(selection_ms=times.selection * 1e3, matching_ms=times.matching * 1e3,
                              weighting_ms=times.weighting * 1e3,
                              rejection_ms=times.rejection * 1e3, solver_ms=times.solver * 1e3)
    print("  profile_stages: " + json.dumps(reports))
    # The profiles' attribution by port kernel (every __global__ of the
    # expansion matchers carries its entry's name).
    t0 = time.perf_counter()
    profiling.profile_stages(eth_cfg, src, tgt, repetitions=1, device=dev)
    torch.cuda.synchronize()
    prof = profile_run(lambda: profiling.profile_stages(eth_cfg, src, tgt, repetitions=1,
                                                        device=dev), time.perf_counter() - t0)
    by_port = prof.get("device_ms_by_port_kernel", {})
    print(f"  profile_stages (ETH headline, pair 0), one call profiled: device ms by port kernel "
          f"{json.dumps(by_port)}", flush=True)
    check(by_port.get("dense_nn_search", 0) > 0,
          "profile_stages (ETH headline, pair 0), one call profiled: device time attributed to "
          "dense_nn_search")

    # ---- kernel 7: the tile-pruned matcher ---------------------------------
    direct = 0

    def pruned_check(label, q, q_ok, targets, t_ok, maxd):
        """nn_search_pruned's kernel against its plain version (bit for bit)
        and against cKDTree within the threshold. The checked call's launch
        is read from the wrapper's count; the timing loop's are not kept."""
        nonlocal direct
        d = q.shape[-1]
        index = knn.build_target_index(targets, tile_t=knn.INDEX_TILE_T)
        bv = knn.bound_value(maxd)
        visit = knn.pruned_visit_mask(q, index, bv, knn.TILE_Q)
        args = (q, index.points, visit, bv)
        kw = dict(tile_q=knn.TILE_Q, tile_t=knn.INDEX_TILE_T)
        _cuda.reset_launches()
        idx, d2 = knn.pruned_nn_search(*args, **kw)
        n_launch = _cuda.LAUNCHES["pruned_nn_search"]
        check(n_launch == 1, f"pruned_nn_search D={d} ({label}, max_distance {maxd:g}): "
                             f"one call launched the kernel {n_launch} times")
        direct += n_launch
        (idx_p, d2_p), plain_ms = plain_pass(
            lambda s, e: knn.pruned_nn_search_plain(q[:, s:e], index.points,
                                                    visit[:, s // knn.TILE_Q:], bv, **kw),
            q.shape[1], rows=8 * knn.TILE_Q)
        check(torch.equal(d2, d2_p) and torch.equal(idx, idx_p),
              f"pruned_nn_search D={d} ({label}, max_distance {maxd:g}, all {q.shape[1]} rows): "
              "d2 and idx equal to plain")
        again = [knn.pruned_nn_search(*args, **kw) for _ in range(3)]
        check(all(torch.equal(a[0], idx_p) and torch.equal(a[1], d2_p) for a in again),
              f"pruned_nn_search D={d} ({label}, max_distance {maxd:g}): 3 more calls (the "
              "card's list of cells in another order each time) equal to plain")
        rows_ok = np.flatnonzero(t_ok[0].cpu().numpy())
        sel = q_ok[0].cpu().numpy()
        res = expansion_vs_ckdtree(q[0].cpu().numpy()[sel].astype(np.float64),
                                   targets[0].cpu().numpy()[rows_ok].astype(np.float64), rows_ok,
                                   idx[0].cpu().numpy()[sel], d2[0].cpu().numpy()[sel], bv)
        check(res is not None,
              f"pruned_nn_search D={d} ({label}, max_distance {maxd:g}): found exactly where "
              f"cKDTree's distance is below the bound beyond the rounding, each match within it")
        q_real = q_ok.clone()
        nbytes, nops, pairs = cell_work(visit, q_real, t_ok, knn.TILE_Q, knn.INDEX_TILE_T, d)
        row = dict(err=float((d2 - d2_p).abs().max()),
                   ms=time_ms(lambda: knn.pruned_nn_search(*args, **kw), 10), plain_ms=plain_ms,
                   bound=bound(nbytes, nops),
                   shapes=f"1 x {q.shape[1]} rows (D = {d}) against {targets.shape[1]}, "
                          f"{knn.INDEX_TILE_T}-row tiles, max_distance {maxd:g}",
                   plain_on=f"the same rows, in windows of {8 * knn.TILE_Q}",
                   visited_cells=f"{int(visit.sum())} of {visit.numel()}")
        print(f"  pruned_nn_search D={d} ({label}, max_distance {maxd:g}): kernel "
              f"{row['ms']:.4f} ms, plain {plain_ms:.4f} ms, bound {row['bound'][0]:.5f} ms "
              f"({row['bound'][1]}), the contract's issue floor {issue_floor(pairs, d):.5f} ms; "
              f"{row['visited_cells']} cells visited, {pairs:.4g} real pairs; "
              f"{res[0]} of {int(sel.sum())} real rows found, {res[1]} equal to cKDTree's index",
              flush=True)
        row["split_ms"] = kernel_split(lambda: knn.pruned_nn_search(*args, **kw),
                                       "pruned_nn_search", ("pack", "list", "walk", "out"))
        print(f"  pruned_nn_search D={d} ({label}, max_distance {maxd:g}) by launch (profiler, "
              "ms a launch): " + ", ".join(f"{k} {v:.4f}" for k, v in row["split_ms"].items()),
              flush=True)
        prof = profile_run(lambda: knn.pruned_nn_search(*args, **kw), row["ms"] / 1e3)
        got = prof.get("device_ms_by_port_kernel", {}).get("pruned_nn_search", 0)
        check(got > 0, f"pruned_nn_search D={d} ({label}, max_distance {maxd:g}), one call "
                       f"profiled: device time attributed to pruned_nn_search ({got:.4f} ms)")
        row["rescans"] = rescan_reading(
            f"pruned_nn_search D={d} ({label}, max_distance {maxd:g})",
            lambda defs: knn._pruned_nn_search_launch(*args, knn.TILE_Q, knn.INDEX_TILE_T, defs),
            (idx, d2))
        return row

    for maxd in (MAX_DISTANCE, 0.01):
        row = pruned_check(f"ETH pair 0's {ins['qk'].shape[1]} selected query slots", ins["qk"],
                           ins["qm"], ins["t3"], tgt.valid[None], maxd)
        if maxd == MAX_DISTANCE:
            rows["pruned_nn_search"] = row
        else:
            rows["pruned_nn_search"]["tight"] = row
    rows["pruned_nn_search"]["colour"] = pruned_check(
        "colour frame 1 against frame 0", ins["q6"], frame.valid[None], ins["t6"],
        ctgt.valid[None], TUM_MAX_DISTANCE)
    rows["pruned_nn_search"]["direct_launches"] = direct
    del ins
    torch.cuda.empty_cache()

    # ---- kernel 2e: the seeded search's pose mode -------------------------
    ka, warm = colour["kds"]["checks16"], colour["warm"]["checks16"]
    sources, blk, q_ap = colour["sources"], colour["blk"], colour["q_ap"]
    b, n = blk.shape
    d = 6
    raw = knn.color_features(sources.points, sources.colors).contiguous()
    pose = warm.pose.contiguous()
    _cuda.reset_launches()
    pi, pd = kdtree.nn_search_kd_cached(raw, ka, TUM_MAX_DISTANCE, blk, pose=pose)
    pose_launches = _cuda.LAUNCHES["cached_block_search"]
    check(pose_launches == 1, f"cached_block_search with pose=: one call launched the kernel "
                              f"{pose_launches} times")
    (pi_p, pd_p), plain_ms = plain_pass(
        lambda s, e: kdtree.nn_search_kd_cached_oracle(raw[:, s:e], ka, TUM_MAX_DISTANCE,
                                                       blk[:, s:e], pose=pose), n)
    check(torch.equal(pi, pi_p) and torch.equal(pd, pd_p),
          f"cached_block_search with pose= (all {b} x {n} rows, raw features, the checks16 "
          "warm-up's final poses): idx and d2 equal to plain")
    ti, td = kdtree.nn_search_kd_cached(q_ap, ka, TUM_MAX_DISTANCE, blk)
    agree = float((pi == ti).float().mean())
    check(torch.allclose(pd, td, rtol=1e-4, atol=1e-6) and agree >= 0.99,
          f"cached_block_search with pose= against transform-then-search: d2 within rtol 1e-4 / "
          f"atol 1e-6, {agree:.6f} of the indices equal (bit for bit: "
          f"{bool(torch.equal(pd, td) and torch.equal(pi, ti))})")
    real_a = (ka.block_orig >= 0).sum(-1)
    has = blk >= 0
    bi = torch.arange(b, device=dev)[:, None].expand_as(blk)
    row_pts = int(real_a[bi[has], blk[has].long()].sum())
    used = torch.zeros((b, ka.pages.shape[1]), dtype=torch.bool, device=dev)
    used[bi[has], blk[has].long()] = True
    pose_row = dict(
        err=float((pd - pd_p).abs().max()), ms=time_ms(
            lambda: kdtree.nn_search_kd_cached(raw, ka, TUM_MAX_DISTANCE, blk, pose=pose), 10),
        plain_ms=plain_ms, plain_on=f"{b} x {n} rows (D = 6), in windows of {PLAIN_CHUNK_ROWS}",
        bound=bound(b * n * (d + 1 + 2) * 4 + b * 64 + int(real_a[used].sum()) * d * 4,
                    row_pts * 3 * d + 15 * int(has.sum())),
        shapes=f"{b} x {n} rows (D = 6, raw), {ka.pages.shape[1]} blocks, a pose per frame")
    print(f"  cached_block_search with pose=: kernel {pose_row['ms']:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {pose_row['bound'][0]:.5f} ms ({pose_row['bound'][1]})",
          flush=True)
    pose_row["split_ms"] = kernel_split(
        lambda: kdtree.nn_search_kd_cached(raw, ka, TUM_MAX_DISTANCE, blk, pose=pose),
        "cached_block_search", CACHED_PARTS)
    print("  cached_block_search with pose= by launch (profiler, ms a launch): "
          + ", ".join(f"{k} {v:.4f}" for k, v in pose_row["split_ms"].items()), flush=True)
    del raw, pi, pd, pi_p, pd_p, ti, td
    pose_row["launches"] = pose_launches
    rows["cached_block_search_pose"] = pose_row
    return rows, dict(launches)


def ablation_queries():
    """The JAX package's ``scripts/knn_ablate.main`` inputs, seeds included:
    ``synth_cloud(N_POINTS, 0)`` as target and, rotated 0.05 rad about z and
    moved by (0.5, -0.3, 0.1), as source, both in Morton order; ABLATE_SLOTS
    query slots, the first ABLATE_DRAWS a stratified draw of source rows,
    the rest copies of the first. Returns (queries, targets), numpy f32."""
    from icp_variants_tpu_torch.ops import knn

    src, _ = synth_cloud(N_POINTS, 0)
    tgt, _ = synth_cloud(N_POINTS, 0)
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    src = src @ R.T + np.array([0.5, -0.3, 0.1], np.float32)
    src = src[np.argsort(knn.morton_codes_np(src))]
    tgt = tgt[np.argsort(knn.morton_codes_np(tgt))]
    cap = len(src)
    rng = np.random.default_rng(0)
    slots = np.arange(ABLATE_SLOTS)
    starts = (slots * cap) // ABLATE_DRAWS
    ends = ((slots + 1) * cap) // ABLATE_DRAWS
    u = rng.random(ABLATE_SLOTS)
    idx = np.minimum(starts + (u * np.maximum(ends - starts, 1)).astype(int), cap - 1)
    q = src[idx]
    q[ABLATE_DRAWS:] = q[0]
    return q.astype(np.float32), tgt.astype(np.float32)


def ablation_cluster(inp, kern, runs):
    """The ablation kernel's cluster launch at phase 8's shapes: its fit
    printed, and the ``-DABL_COUNT`` build's chunks scored per CTA checked
    equal to the plain version's ``runs`` and its result to the production
    build's ``kern``. Returns each mode's floors, for phase 8's printed
    lines only (they are worked out, not measured): its instructions a
    (row, column) (``knn_ablate.issue_instructions``), its issue floor (the
    chunks scored at half of PEAK_F32_OPS: one instruction a lane a clock)
    and its chain floor (the longest walk's chunks, each one chunk's
    instructions on the cluster's SMs)."""
    import torch

    from icp_variants_tpu_torch.scripts import knn_ablate

    fit = {mode: knn_ablate.cluster_fit(inp, mode) for mode in knn_ablate.MODES}
    size = fit["full"]["cluster"]
    print(f"  visited_ablate cluster: {size} CTAs a query tile, "
          f"{inp.counts.shape[0] * size} CTAs of {fit['full']['threads']} threads; clusters "
          "resident at once / CTAs an SM / dynamic shared memory a CTA: "
          + ", ".join(f"{m} {f['clusters_resident']} / {f['ctas_per_sm']} / {f['smem_bytes']} B"
                      for m, f in fit.items()), flush=True)
    cols = inp.chunk * inp.tile_t
    sm_rate = PEAK_F32_OPS / 2 / torch.cuda.get_device_properties(0).multi_processor_count
    floors = {}
    for mode in knn_ablate.MODES:
        instr = knn_ablate.issue_instructions(mode, inp.d)
        n_run = runs[mode]
        pairs = int(n_run.sum()) * cols * knn_ablate.TILE_Q
        chain = int(n_run.max()) * knn_ablate.TILE_Q * cols * instr / (size * sm_rate) * 1e3
        floors[mode] = (instr, pairs * instr / (PEAK_F32_OPS / 2) * 1e3, chain)
        d2, idx, chunks = knn_ablate.ablate_counted(inp, mode)
        check(torch.equal(d2, kern[mode][0]) and torch.equal(idx, kern[mode][1]),
              f"visited_ablate {mode}: the -DABL_COUNT build's result equal to the production "
              "build's")
        check(bool((chunks == n_run.cpu()[:, None]).all()),
              f"visited_ablate {mode}: the -DABL_COUNT build's chunks scored equal to the plain "
              f"version's in all {chunks.numel()} CTAs ({int(n_run.sum())} chunks over "
              f"{len(n_run)} tiles, longest walk {int(n_run.max())})")
    return floors


def ablation_phase():
    """Phase 8's TPU kernel 8 on the card: the visited-list ablation
    (``scripts.knn_ablate``, kernel ``visited_ablate``) in all seven modes
    on the JAX ablation script's inputs; returns the kernel's row. Raises
    :class:`Failure` on a failed check."""
    import torch

    from icp_variants_tpu_torch.ops import _cuda, knn
    from icp_variants_tpu_torch.scripts import cuda_ms, knn_ablate

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    q_np, t_np = ablation_queries()
    inp = knn_ablate.ablate_inputs(torch.from_numpy(q_np).to(dev),
                                   torch.from_numpy(t_np).to(dev), MAX_DISTANCE)
    nqt, max_v = inp.vlist.shape
    print(f"  ablation inputs: {len(q_np)} query slots in {nqt} tiles of "
          f"{knn_ablate.TILE_Q}, {inp.pages.shape[0]} target tiles of {inp.tile_t}, chunk "
          f"{inp.chunk}; chunks per query tile {inp.counts.tolist()}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plain, runs, plain_ms = {}, {}, {}
    for mode in knn_ablate.MODES:
        start.record()
        d2_p, idx_p, runs[mode] = knn_ablate._ablate_plain(inp, mode)
        end.record()
        end.synchronize()
        plain[mode], plain_ms[mode] = (d2_p, idx_p), start.elapsed_time(end)
    _cuda.reset_launches()
    kern = {mode: knn_ablate.ablate_search(inp, mode) for mode in knn_ablate.MODES}
    torch.cuda.synchronize()
    direct = _cuda.LAUNCHES["visited_ablate"]
    check(direct == len(knn_ablate.MODES),
          f"visited_ablate: {len(knn_ablate.MODES)} checked calls launched the kernel {direct} "
          "times")
    full_d2, full_idx = plain["full"]
    errs = {}
    for mode, (d2, idx) in kern.items():
        d2_p, idx_p = plain[mode]
        if mode in ("default", "high"):
            n_rows = inp.pages.shape[0] * inp.tile_t
            worst, n_other = knn_ablate.tf32_check(inp, mode, (d2, idx), (d2_p, idx_p))
            check(worst <= 1.0 and bool(((idx >= -1) & (idx < n_rows)).all()),
                  f"visited_ablate {mode}: d2 and idx against its plain version within the "
                  f"order bound (2^-17 S + 2^-22 qn2) on every row, worst {worst:.4f} of it; "
                  f"{n_other} rows take another winner, each a tie within it")
            e = torch.maximum(knn_ablate.tf32_error_bound(inp, mode, idx),
                              knn_ablate.tf32_error_bound(inp, mode, full_idx))
            gap = (d2 - full_d2).abs()
            check(bool((gap <= e).all()),
                  f"visited_ablate {mode}: d2 within the TF32 bound of the exact plain result on "
                  f"every row (worst {float((gap / e.clamp(min=1e-30)).max()):.3f} of the bound)")
            errs[mode] = float((d2 - d2_p).abs().max())
            continue
        check(torch.equal(d2, d2_p) and torch.equal(idx, idx_p),
              f"visited_ablate {mode}: d2 and idx equal to plain on all {len(d2)} rows")
        errs[mode] = float((d2 - d2_p).abs().max())
    check(torch.equal(plain["maxonly"][0], full_d2) and bool((kern["maxonly"][1] == -1).all()),
          "visited_ablate maxonly: full's d2, idx -1")
    check(bool((kern["dmaonly"][0] == inp.bound).all() and (kern["dmaonly"][1] == -1).all()),
          "visited_ablate dmaonly: (bound, -1) on every row")
    n_real = len(t_np)
    res = expansion_vs_ckdtree(q_np.astype(np.float64), t_np.astype(np.float64),
                               np.arange(n_real), kern["full"][1][:len(q_np)].cpu().numpy(),
                               kern["full"][0][:len(q_np)].cpu().numpy(), inp.bound)
    check(res is not None,
          f"visited_ablate full: found exactly where cKDTree's distance is below the bound "
          f"beyond the rounding, each of its {len(q_np)} query slots within it")
    floors = ablation_cluster(inp, kern, runs)
    ms = knn_ablate.ablate(inp, reps=ABLATE_REPS)
    modes = {}
    for mode in knn_ablate.MODES:
        nbytes, nops, kind = knn_ablate.ablate_work(inp, mode, runs[mode])
        peak = PEAK_TF32_OPS if kind == "tf32" else PEAK_F32_OPS
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, nops / peak * 1e3
        modes[mode] = dict(ms=ms[mode], plain_ms=plain_ms[mode], bound_ms=max(t_b, t_o),
                           bound_by="bytes" if t_b >= t_o else "operations",
                           max_abs_err=errs[mode], chunks_run=int(runs[mode].sum()))
        m = modes[mode]
        instr, issue_ms, chain_ms = floors[mode]
        print(f"  visited_ablate {mode:8s}: kernel {ms[mode]:.4f} ms, plain "
              f"{plain_ms[mode]:.4f} ms, bound {m['bound_ms']:.5f} ms ({m['bound_by']}, {kind}), "
              f"issue floor {issue_ms:.5f} ms ({instr} instructions a (row, column)), chain "
              f"floor {chain_ms:.5f} ms; {m['chunks_run']} chunks scored", flush=True)
    # The production fallback kernel on the same queries at the same bound.
    q_dev = torch.from_numpy(q_np).to(dev)[None].contiguous()
    fidx = knn.build_target_index(torch.from_numpy(t_np).to(dev)[None], tile_t=knn.V2_TILE_T)
    radius = torch.full(q_dev.shape[:2], inp.bound, device=dev)
    vd, _vi = knn.visited_search(q_dev, radius, fidx)
    prod_ms = cuda_ms(lambda: knn.visited_search(q_dev, radius, fidx), ABLATE_REPS)
    same = float((vd[0] == kern["direct"][0][:len(q_np)]).float().mean())
    print(f"  visited_search (production, {knn.V2_TILE_T}-row tiles) on the same queries: "
          f"{prod_ms:.4f} ms; d2 equal to the direct mode's on {same:.4f} of the rows",
          flush=True)
    row = dict(
        modes=modes, direct_launches=direct, visited_search_ms=prod_ms,
        shapes=f"{len(q_np)} query slots ({nqt} tiles of {knn_ablate.TILE_Q}) against "
               f"{n_real} targets ({inp.pages.shape[0]} tiles of {inp.tile_t}), chunk "
               f"{inp.chunk}, squared bound {MAX_DISTANCE:g}",
        plain_on="all query tiles side by side, chunk by chunk")
    del inp, kern, plain, q_dev, fidx
    torch.cuda.empty_cache()
    return row


def tooling_phase(eth):
    """Phase 8 on the card: the measurement tools. ``eth`` is the ETH
    phase's data. Returns the kernel rows of the ablation kernel and of the
    block search's probe. Raises :class:`Failure` on a failed check."""
    import torch

    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import _cuda, kdtree
    from icp_variants_tpu_torch.pipeline import profiling
    from icp_variants_tpu_torch.pipeline.config import (
        ICPConfig, Metric, Minimizer, Selection,
    )
    from icp_variants_tpu_torch.scripts import cuda_ms, resident_bench

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    print("phase 8: tooling: the fused stage profiler, the visited-list ablation, the kd "
          "block search's probe decomposition", flush=True)
    rows = {}

    # ---- the fused stage profiler on ETH pair 0, both arms -----------------
    src0 = cloud_lib.Cloud(*(f[0] for f in eth["sources"]))
    tgt0 = eth["targets_host"][0].to(dev)
    kd0 = kdtree.KDIndex(*(None if f is None else f[0] for f in eth["kd"]))
    fused = {}
    for arm, checks in (("exact", 0), ("checks16", CHECKS_APPROX)):
        cfg = ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                        selection=Selection.RANDOM, selection_proba=SELECTION_P,
                        n_iterations=FUSED_ITERATIONS, max_distance=MAX_DISTANCE,
                        matching_checks=checks)
        t0 = time.perf_counter()
        rep = profiling.fused_report(cfg, src0, tgt0, repetitions=FUSED_REPS, kd_index=kd0,
                                     device=dev)
        print(f"  fused_report (ETH pair 0, {arm}; {time.perf_counter() - t0:.1f} s):")
        for line in rep.text.splitlines():
            print(f"    {line}")
        times, dtimes = rep.host, rep.device
        total = (times.selection + times.matching + times.weighting + times.rejection
                 + times.solver + times.convergence)
        check(total * times.n_iterations <= 1.5 * times.full_run + 0.05,
              f"fused profile ({arm}): stage sum {total * 1e3:.3f} ms x {times.n_iterations} "
              f"<= 1.5 x full run {times.full_run:.4f} s + 0.05 s")
        # The host's clock cannot resolve the matching stage of one
        # host-bound pair; the card's kernel time can.
        check(dtimes is not None and dtimes.matching > 0,
              f"fused profile ({arm}): the matching stage's kernel time > 0 "
              f"({dtimes.matching * 1e3 if dtimes else float('nan'):.4f} ms per iteration)")
        fused[arm] = {f"{where}_{k}": v for where, t in (("host", times), ("device", dtimes))
                      for k, v in dict(
                          floor_ms=t.overhead * 1e3, selection_ms=t.selection * 1e3,
                          matching_ms=t.matching * 1e3, weighting_ms=t.weighting * 1e3,
                          rejection_ms=t.rejection * 1e3, solver_ms=t.solver * 1e3,
                          convergence_ms=t.convergence * 1e3, full_run_s=t.full_run).items()}
        fused[arm]["n_iterations"] = times.n_iterations
    print("  fused profile: " + json.dumps(fused))
    del src0, tgt0, kd0

    rows["visited_ablate"] = ablation_phase()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    # ---- TPU kernel 2's probe: resident_bench.probe_decomp ------------------
    kd = eth["kd"]
    pts = eth["sources"].points.cpu().numpy()
    ok = eth["sources"].valid.cpu().numpy()
    q = torch.from_numpy(resident_bench.probe_queries(pts, ok)).to(dev)
    dec = resident_bench.probe_decomp(kd, q, MAX_DISTANCE, reps=ABLATE_REPS)
    b, n = q.shape[:2]
    _cuda.reset_launches()
    pd2, pidx = kdtree.kd_block_search(q, dec["sel"], dec["binit"], kd.pages, probe=1)
    probe_launches = _cuda.LAUNCHES["kd_block_search"]
    p_plain = kdtree.kd_block_search_plain(q, dec["sel"], dec["binit"], kd.pages, probe=1)
    check(probe_launches == 1 and torch.equal(pd2, dec["binit"]) and bool((pidx == -1).all())
          and torch.equal(pd2, p_plain[0]) and torch.equal(pidx, p_plain[1])
          and torch.equal(dec["probe"][0], pd2) and torch.equal(dec["probe"][1], pidx),
          f"kd_block_search probe=1: one launch, (binit, -1) on all {b} x {n} rows, equal to "
          "plain")
    start.record()
    want = kdtree.kd_block_search_plain(q, dec["sel"], dec["binit"], kd.pages)
    end.record()
    end.synchronize()
    full_plain_ms = start.elapsed_time(end)
    check(torch.equal(dec["full"][0], want[0]), "kd_block_search (probe_decomp's full launch): "
                                               "d2 equal to plain")
    _tie_or_equal(dec["full"][1], want[1], dec["full"][0], q, kd.pages,
                  "kd_block_search (probe_decomp's full launch)")
    probe_plain_ms = cuda_ms(lambda: kdtree.kd_block_search_plain(
        q, dec["sel"], dec["binit"], kd.pages, probe=1), ABLATE_REPS)
    sel = dec["sel"]
    members = sel >= 0
    used = torch.zeros((b, kd.pages.shape[1]), dtype=torch.bool, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None].expand_as(sel)
    used[bi[members], sel[members].long()] = True
    block_real = (kd.block_orig >= 0).sum(-1)
    staged_bytes = int(block_real[used].sum()) * 3 * 4
    probe_bound = bound(b * n * (3 + 4 + 1 + 2) * 4 + staged_bytes, 0)
    rows["kd_block_search_probe"] = dict(
        ms=dec["staging_ms"], plain_ms=probe_plain_ms, bound=probe_bound,
        err=float((pd2 - p_plain[0]).abs().max()), launches=probe_launches,
        prefix_ms=dec["prefix_ms"],
        staging_ms=dec["staging_ms"], distance_ms=dec["distance_ms"], full_ms=dec["full_ms"],
        full_plain_ms=full_plain_ms,
        shapes=f"{b} pairs x {n} queries (the JAX script's draw), k = 4, bound "
               f"{MAX_DISTANCE:g}, {kd.pages.shape[1]} blocks of {kd.pages.shape[-1]}")
    print(f"  probe_decomp ({b} x {n} queries): box_topk {dec['prefix_ms']:.4f} ms, "
          f"kd_block_search probe {dec['staging_ms']:.4f} ms (staging), full "
          f"{dec['full_ms']:.4f} ms (distance {dec['distance_ms']:.4f} ms); probe bound "
          f"{probe_bound[0]:.5f} ms ({probe_bound[1]}), plain probe {probe_plain_ms:.4f} ms",
          flush=True)
    return rows


def sync_sites(fn) -> dict:
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode("warn")``:
    every operation that makes the host wait for the card warns there.
    Returns the count of those warnings by the file and line of the Python
    frame that called the operation."""
    import os
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def bunny_config(name):
    from icp_variants_tpu_torch.pipeline.config import Metric, Minimizer
    from icp_variants_tpu_torch.workloads import bunny

    enums = {"metric": Metric, "minimizer": Minimizer}
    return bunny.default_config(**{k: getattr(enums[k], v) if k in enums else v
                                   for k, v in BUNNY_RUNS[name].items()})


def bunny_runs(card, launches) -> dict:
    """Phase 9, part 1: the bunny halves on the card in each configuration
    of ``BUNNY_RUNS``, against the JAX package's CPU reading; the final
    iteration's queries of the default run through visited_search against
    its plain version."""
    import torch

    from icp_variants_tpu_torch import api
    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.data.loaders import BunnyDataLoader
    from icp_variants_tpu_torch.ops import _cuda, knn
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.workloads import bunny

    dev = torch.device("cuda")
    loader = BunnyDataLoader(device=dev)
    gt_src, gt_tgt = loader.gt_correspondences()
    bunny.align_bunny(device=dev)            # warm-up
    out = {}
    for name in BUNNY_RUNS:
        cfg = bunny_config(name)
        if name == "register":
            def run(cfg=cfg):
                r = api.register(loader.source_mesh.vertices, loader.target_mesh.vertices, cfg,
                                 gt_source_points=gt_src, gt_target_points=gt_tgt, device=dev)
                return r.pose, r.rmse, r.num_matches
        else:
            def run(cfg=cfg):
                r = bunny.align_bunny(cfg, device=dev)
                return r.pose, r.rmse_per_iteration, r.num_matches
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        pose, rmse, nm = run()
        wall = time.perf_counter() - t0
        counts = dict(_cuda.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        prof = profile_run(run, wall, cpu=False)
        gap = float(np.abs(pose.astype(np.float64) - np.asarray(JAX_BUNNY[name]["pose"])).max())
        limit = BUNNY_CONVERGED_RMSE[cfg.metric.name]
        out[name] = dict(seconds=wall, final_rmse=float(rmse[-1]),
                         jax_final_rmse=JAX_BUNNY[name]["final_rmse"], jax_pose_gap=gap,
                         num_matches=nm.tolist(), launches=counts,
                         device_ms=prof["device_ms"],
                         device_busy_share=prof.get("device_busy_share"),
                         kernel_launches=prof.get("kernel_launches"),
                         device_ms_by_port_kernel=prof.get("device_ms_by_port_kernel"))
        print(f"  bunny {name}: {wall:.4f} s, final RMSE {float(rmse[-1]):.6e} (JAX CPU "
              f"{JAX_BUNNY[name]['final_rmse']:.6e}), pose gap to JAX {gap:.3e}, launches "
              f"{counts}, device {prof['device_ms']} ms, busy {prof.get('device_busy_share')}, "
              f"by port kernel {prof.get('device_ms_by_port_kernel')}  [{card}]", flush=True)
        check(np.isfinite(pose).all() and gap <= BUNNY_JAX_GAP[name],
              f"bunny {name}: final pose within {BUNNY_JAX_GAP[name]:g} of the JAX CPU reading")
        check(float(rmse[-1]) < limit
              and abs(float(rmse[-1]) / JAX_BUNNY[name]["final_rmse"] - 1.0) <= BUNNY_RMSE_RTOL,
              f"bunny {name}: final RMSE < {limit:g} and within {BUNNY_RMSE_RTOL:.0%} of the "
              "JAX CPU reading")
        check("visited_search" in prof.get("device_ms_by_port_kernel", {})
              and counts.get("visited_search", 0) >= cfg.n_iterations,
              f"bunny {name}: visited_search in the profile and launched every iteration")

    # The default run's final iteration: its queries are the source moved by
    # the pose after 19 iterations (SELECT_ALL draws nothing).
    cfg = bunny_config("default")
    sample = loader.get_item(0)
    before = icp.run_icp(cfg.replace(n_iterations=cfg.n_iterations - 1), sample.source,
                         sample.target, init_pose=np.eye(4, dtype=np.float32), device=dev)
    src = icp.stack_clouds([sample.source])
    pts = se3.transform_points(src.points, before.pose[None])
    first = torch.argmax(src.valid.to(torch.uint8), dim=-1)
    q = torch.where(src.valid[..., None], pts, knn.take_rows(pts, first[:, None])).contiguous()
    fidx = knn.build_target_index(icp.stack_clouds([sample.target]).points, tile_t=knn.V2_TILE_T)
    radius = torch.full(q.shape[:2], knn.bound_value(cfg.max_distance), device=dev)
    vd_k, vi_k = knn.visited_search(q, radius, fidx)
    vd_p, vi_p = knn.visited_search_plain(q, radius, fidx)
    torch.cuda.synchronize()
    check(torch.equal(vd_k, vd_p) and torch.equal(vi_k, vi_p),
          f"visited_search on the default bunny run's final-iteration queries ({q.shape[1]} rows) "
          "equal to its plain version bit for bit")
    return out


def eth_register(card, launches) -> dict:
    """Phase 9, part 2: ``api.register`` on ETH pair 0 (365,000 points)
    with no normals, under the ETH headline configuration's exact arm."""
    import torch
    from scipy.spatial import cKDTree

    from icp_variants_tpu_torch import api
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import _cuda, normals
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer, Selection

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    src_pts, _, tgt_pts, _ = make_pairs(1, N_POINTS)[0]
    valid = np.ones(len(src_pts), bool)
    cfg = ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                    selection=Selection.RANDOM, selection_proba=SELECTION_P,
                    n_iterations=N_ITERATIONS, max_distance=MAX_DISTANCE, matching_checks=0)

    # The normals: time (median of 3), neighbours against cKDTree, angles
    # against a float64 PCA over cKDTree's neighbours.
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        nrm = normals.estimate_normals_knn_fast(src_pts, valid, device=dev)
        sync()
        walls.append(time.perf_counter() - t0)
    normals_s = float(np.median(walls[1:]))
    nrm = nrm.cpu().numpy()
    idx = normals.self_knn_fast(src_pts, valid, device=dev).cpu().numpy()
    p64 = src_pts.astype(np.float64)
    dref, iref = cKDTree(p64).query(p64, k=5, workers=-1)
    d2 = np.sum((p64[:, None, :] - p64[idx]) ** 2, axis=-1)
    differ = np.any(idx != iref, axis=1)
    exact_ties = differ & np.all(d2 == dref ** 2, axis=1)
    rounding_ties = differ & ~exact_ties & np.all(
        np.abs(d2 - dref ** 2) <= 4 * 2.0 ** -24 * dref ** 2 + 1e-12, axis=1)
    print(f"  register, ETH pair 0 ({len(src_pts)} points): normals on the card "
          f"{normals_s:.4f} s (median of 3; runs {[round(w, 4) for w in walls]}); k = 5 "
          f"neighbours differ from cKDTree's on {int(differ.sum())} rows: {int(exact_ties.sum())} "
          f"exact ties, {int(rounding_ties.sum())} ties within 4 f32 ulps  [{card}]", flush=True)
    check(not np.any(differ & ~exact_ties & ~rounding_ties),
          "register normals: k = 5 neighbours equal to cKDTree's on every row but ties")
    neigh = p64[iref]
    c = neigh - neigh.mean(1, keepdims=True)
    w, v = np.linalg.eigh(np.einsum("nki,nkj->nij", c, c) / 5)
    n64 = v[..., 0]
    n64 = np.where((np.sum(n64 * -p64, axis=1) < 0)[:, None], -n64, n64)
    ok = (w[:, 1] - w[:, 0]) / np.maximum(w[:, 2], 1e-30) >= NORMALS_GAP_FLOOR
    cos = np.clip(np.sum(nrm.astype(np.float64) * n64, axis=1), -1.0, 1.0)
    angle = np.degrees(np.arccos(cos))
    print(f"  register normals against float64 PCA: {int((~ok).sum())} rows skipped (eigen-gap "
          f"< {NORMALS_GAP_FLOOR:g}), max angle {angle[ok].max():.3e} deg over {int(ok.sum())} "
          f"rows", flush=True)
    check(angle[ok].max() <= NORMALS_ANGLE_DEG,
          f"register normals within {NORMALS_ANGLE_DEG} deg of float64 PCA (signs included)")

    # The call as a user makes it, its launches counted.
    sync()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = api.register(src_pts, tgt_pts, cfg, device=dev)
    register_s = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    for k, n in counts.items():
        launches[k] += n
    resid = res.pose.astype(np.float64) @ eth_true_pose(0).astype(np.float64)
    t_err, r_err = float(np.abs(resid[:3, 3]).max()), rotation_error_deg(resid[:3, :3])

    # Its parts: the kd build, then the run alone (median of 3) and profiled.
    t_nrm = normals.estimate_normals_knn_fast(tgt_pts, valid, device=dev).cpu().numpy()
    s_nrm = normals.estimate_normals_knn_fast(src_pts, valid, device=dev).cpu().numpy()
    sc = cloud_lib.from_numpy(src_pts, normals=s_nrm, morton_order=True, device=dev)
    tc = cloud_lib.from_numpy(tgt_pts, normals=t_nrm, morton_order=True, device=dev)
    sync()
    t0 = time.perf_counter()
    kd = icp.build_kd_for(cfg, tc, device=dev)
    sync()
    kd_s = time.perf_counter() - t0

    def run():
        return icp.run_icp(cfg, sc, tc, kd_index=kd, seed=0, device=dev)

    run()
    run_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        sync()
        run_walls.append(time.perf_counter() - t0)
    run_s = float(np.median(run_walls))
    prof = profile_run(run, run_s, cpu=False)
    by_port = prof.get("device_ms_by_port_kernel", {})
    row = dict(points=len(src_pts), normals_s=normals_s, normals_walls=walls,
               neighbours_differ=int(differ.sum()), exact_ties=int(exact_ties.sum()),
               rounding_ties=int(rounding_ties.sum()), normals_max_angle_deg=float(angle[ok].max()),
               normals_rows_skipped=int((~ok).sum()), register_s=register_s, kd_build_s=kd_s,
               run_s=run_s, run_walls=run_walls, t_err_m=t_err, r_err_deg=r_err, launches=counts,
               device_ms=prof["device_ms"], device_busy_share=prof.get("device_busy_share"),
               kernel_launches=prof.get("kernel_launches"), device_ms_by_port_kernel=by_port)
    print(f"  register: {register_s:.4f} s for the call (normals of both clouds, Morton order, "
          f"kd build, run); kd build {kd_s:.4f} s; the run alone {run_s:.4f} s (median of 3: "
          f"{[round(x, 4) for x in run_walls]}); t_err {t_err * 1e3:.6f} mm, r_err {r_err:.6f} "
          f"deg; launches {counts}; device {prof['device_ms']} ms, busy "
          f"{prof.get('device_busy_share')}, {prof.get('kernel_launches')} launches, by port "
          f"kernel {by_port}  [{card}]", flush=True)
    check(t_err <= T_ERR_LIMIT_M, "register at ETH scale: t_err <= 1 cm against eth_true_pose(0)")
    # The tight gate is the ETH path's (the card's reading here: 0.0003 mm,
    # as the path's with the given normals).
    check(t_err <= T_ERR_TIGHT_M, "register at ETH scale: t_err <= 0.01 mm")
    for name in ("box_topk", "kd_block_search", "visited_search"):
        check(name in by_port and counts.get(name, 0) > 0,
              f"register at ETH scale: {name} launched and named in the run's profile")
    return row


def _kabsch64(s, d, w):
    """The Procrustes increment of solvers/procrustes.py (unweighted means,
    weighted source rows) in float64 numpy."""
    sm, dm = s.mean(0), d.mean(0)
    A = (d - dm).T @ ((s - sm) * w[:, None])
    U, _, Vt = np.linalg.svd(A)
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    R = U @ D @ Vt
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, R @ (dm - sm) - R @ dm + dm
    return T


def _whitener64(ns, nt, eps):
    ns, nt = (np.where(np.isfinite(n), n, 0.0) for n in (ns, nt))
    c = (2.0 * np.eye(3) - (1 - eps) * ns[:, :, None] * ns[:, None, :]
         - (1 - eps) * nt[:, :, None] * nt[:, None, :])
    return np.linalg.cholesky(np.linalg.inv(c))


def _gicp_linear64(s, d, ns, nt, w, eps):
    """The linear GICP increment of solvers/linear.py in float64 numpy."""
    c = d.mean(0)
    s, d = s - c, d - c
    Lt = np.swapaxes(_whitener64(ns, nt, eps), 1, 2)
    z, o = np.zeros(len(s)), np.ones(len(s))
    P = np.stack([np.stack([z, s[:, 2], -s[:, 1], o, z, z], 1),
                  np.stack([-s[:, 2], z, s[:, 0], z, o, z], 1),
                  np.stack([s[:, 1], -s[:, 0], z, z, z, o], 1)], 1)
    rows = (Lt @ P) * w[:, None, None]
    rhs = (Lt @ (d - s)[:, :, None])[..., 0] * w[:, None]
    J, b = rows.reshape(-1, 6), rhs.reshape(-1)
    x = np.linalg.solve(J.T @ J + 1e-12 * np.eye(6), J.T @ b)
    a, bb, g = x[:3]
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(bb), 0, np.sin(bb)], [0, 1, 0], [-np.sin(bb), 0, np.cos(bb)]])
    Rz = np.array([[np.cos(g), -np.sin(g), 0], [np.sin(g), np.cos(g), 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rx @ Ry @ Rz
    T[:3, 3] = x[3:] + c - T[:3, :3] @ c
    return T


def _gicp_lm64(s, d, ns, nt, w, eps):
    """GICP through LM on the whitened residuals, solved to convergence by
    scipy's least_squares in float64."""
    from scipy.optimize import least_squares
    from scipy.spatial.transform import Rotation

    Lt = np.swapaxes(_whitener64(ns, nt, eps), 1, 2)

    def resid(x):
        moved = s @ Rotation.from_rotvec(x[:3]).as_matrix().T + x[3:]
        return (w[:, None] * (Lt @ (moved - d)[:, :, None])[..., 0]).reshape(-1)

    x = least_squares(resid, np.zeros(6), method="lm", xtol=1e-14, ftol=1e-14,
                      gtol=1e-14).x
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = Rotation.from_rotvec(x[:3]).as_matrix(), x[3:]
    return T


def solve_gap(cfg, sources, targets, kd, pose) -> float:
    """One more iteration of the arm at its final ``pose`` on the phase-2
    draw (the exact kd matcher, target rows, normal-angle rejection,
    constant weights), its increment solved in f32 by the arm's solver and
    in float64 numpy on the same matches. Returns the largest entry gap
    between the two (4x4) over the pairs."""
    import torch

    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.ops import kdtree, knn, rejection, selection, weighting
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import Metric, Minimizer
    from icp_variants_tpu_torch.solvers import linear

    dev = pose.device
    b, cap = sources.valid.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    sel_idx, in_range = selection.bernoulli_gap_indices(
        gen, SELECTION_P, 1, cap, icp._compact_capacity(cap, SELECTION_P), batch=(b,),
        device=dev)
    qc, qmask = icp._compact_cloud(sources, icp._fuse_cloud_table(sources), sel_idx, in_range,
                                   False)
    pts = se3.transform_points(qc.points, pose)
    first = torch.argmax(qmask.to(torch.uint8), dim=-1)
    pts = torch.where(qmask[..., None], pts, knn.take_rows(pts, first[:, None])).contiguous()
    nrm = se3.transform_normals(qc.normals, pose)
    fidx = knn.build_target_index(targets.points, tile_t=knn.V2_TILE_T)
    idx, _, valid = kdtree.match_kd(pts, kd, fidx, cfg.max_distance, query_mask=qmask, checks=0)
    tgt = knn.take_rows(icp._fuse_cloud_table(targets), idx.clamp(0, targets.capacity - 1))
    valid = valid & (tgt[..., 6] > 0.5)
    valid = rejection.normal_angle_mask(nrm, tgt[..., 3:6], valid)
    m = weighting.MatchArrays(src_points=pts, tgt_points=tgt[..., :3], src_normals=nrm,
                              tgt_normals=tgt[..., 3:6], src_colors=qc.colors,
                              tgt_colors=torch.zeros_like(qc.colors), valid=valid)
    w = weighting.apply_weights(cfg.weighting, m, cfg.max_distance)
    inc32 = icp._solve(cfg, m, w).double().cpu().numpy()
    gap = 0.0
    for i in range(b):
        keep = valid[i].cpu().numpy()
        s, d, ns, nt, wi = (x[i].cpu().numpy().astype(np.float64)[keep]
                            for x in (pts, tgt[..., :3], nrm, tgt[..., 3:6], w))
        if cfg.metric == Metric.POINT_TO_POINT:
            inc = _kabsch64(s, d, wi)
        elif cfg.minimizer == Minimizer.LINEAR:
            inc = _gicp_linear64(s, d, ns, nt, wi, linear.GICP_EPSILON)
        else:
            inc = _gicp_lm64(s, d, ns, nt, wi, linear.GICP_EPSILON)
        gap = max(gap, float(np.abs(inc32[i] - inc).max()))
    return gap


def solver_arms(eth, card, launches) -> dict:
    """Phase 9, part 3: the 16-pair ETH batch (exact arm) under the new
    solvers: linear point-to-point, linear GICP, LM GICP and symmetric
    linear with Anderson acceleration (m = 2)."""
    import torch

    from icp_variants_tpu_torch.ops import _cuda
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import ICPConfig, Metric, Minimizer, Selection

    dev = torch.device("cuda")
    sources, kd = eth["sources"], eth["kd"]
    targets = icp.stack_clouds(eth["targets_host"]).to(dev)
    b = sources.valid.shape[0]
    base = ICPConfig(metric=Metric.SYMMETRIC, minimizer=Minimizer.LINEAR,
                     selection=Selection.RANDOM, selection_proba=SELECTION_P,
                     n_iterations=N_ITERATIONS, max_distance=MAX_DISTANCE, matching_checks=0)
    arms = {
        "p2p_linear": base.replace(metric=Metric.POINT_TO_POINT),
        "gicp_linear": base.replace(metric=Metric.GICP),
        "gicp_lm": base.replace(metric=Metric.GICP, minimizer=Minimizer.NONLINEAR_LM),
        "symmetric_aa2": base.replace(anderson_m=2),
    }
    out = {}
    for arm, cfg in arms.items():
        def run(seed, cfg=cfg):
            return icp.run_icp_batch(cfg, sources, targets, kd_indexes=kd, seed=seed, device=dev)

        run(1)
        torch.cuda.synchronize()
        walls = []
        for r in range(SOLVER_TIMED_RUNS):
            if r == 0:
                _cuda.reset_launches()
            t0 = time.perf_counter()
            res = run(2 + r)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if r == 0:
                counts, first = dict(_cuda.LAUNCHES), res
        for k, n in counts.items():
            launches[k] += n
        wall = float(np.median(walls))
        prof = profile_run(lambda: run(99), wall, cpu=False)
        syncs = sync_sites(lambda: run(98))
        poses = first.pose.cpu().numpy().astype(np.float64)
        t_errs = [float(np.abs((poses[i] @ eth_true_pose(i).astype(np.float64))[:3, 3]).max())
                  for i in range(b)]
        r_errs = [rotation_error_deg((poses[i] @ eth_true_pose(i).astype(np.float64))[:3, :3])
                  for i in range(b)]
        gap = None if arm == "symmetric_aa2" else solve_gap(cfg, sources, targets, kd,
                                                              first.pose)
        out[arm] = dict(pairs_per_s=b / wall, seconds=wall, seconds_each=walls,
                        t_err_m=float(np.mean(t_errs)), t_err_each_m=t_errs,
                        r_err_deg=float(np.mean(r_errs)), launches=counts,
                        mean_matches=float(first.trace.num_matches.float().mean()),
                        device_ms=prof["device_ms"],
                        device_busy_share=prof.get("device_busy_share"),
                        kernel_launches=prof.get("kernel_launches"),
                        device_ms_by_port_kernel=prof.get("device_ms_by_port_kernel"),
                        device_ms_by_kernel=prof.get("device_ms_by_kernel"),
                        sync_sites=syncs, f32_f64_solve_gap=gap)
        print(f"  {arm}: {b / wall:.4f} pairs/s (median of {SOLVER_TIMED_RUNS} runs: "
              f"{[round(x, 4) for x in walls]} s), mean t_err {np.mean(t_errs) * 1e3:.6f} mm, "
              f"mean r_err {np.mean(r_errs):.6f} deg, launches {counts}, device "
              f"{prof['device_ms']} ms, busy {prof.get('device_busy_share')}, "
              f"{prof.get('kernel_launches')} launches a run, host syncs {syncs}, f32 vs f64 "
              f"solve gap {gap}  [{card}]", flush=True)
        for name, ms in prof.get("device_ms_by_kernel", {}).items():
            print(f"    device {ms:9.3f} ms  {name}")
        limit = P2P_T_ERR_LIMIT_M if arm == "p2p_linear" else T_ERR_LIMIT_M
        check(np.isfinite(poses).all() and np.mean(t_errs) <= limit,
              f"{arm}: mean t_err <= {limit * 100:g} cm")
        if gap is not None:
            check(gap <= ETH_SOLVE_GAP, f"{arm}: f32 solve within {ETH_SOLVE_GAP:g} of the "
                                        "float64 solve on the final iteration's matches")
        for name in ("box_topk", "kd_block_search"):
            check(counts.get(name, 0) >= N_ITERATIONS, f"{arm}: {name} launched every iteration")
    return out


def register_phase(eth, card):
    """Phase 9 on the card: the solvers, normals and one-call API of this
    slice on the bunny halves and at ETH scale. Returns the launches of
    its main runs (each counted from 0 just before the run)."""
    import torch

    torch.cuda.empty_cache()
    print(f"phase 9: register: the bunny halves, api.register at ETH scale, the new solver arms "
          f"[{card}]", flush=True)
    launches = collections.Counter()
    result = dict(card=card, bunny=bunny_runs(card, launches),
                  eth_register=eth_register(card, launches),
                  solver_arms=solver_arms(eth, card, launches))
    print("  register phase: " + json.dumps(result))
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the entry points from files (the CLI, in-process)
# ---------------------------------------------------------------------------

ETH_FILE_SCANS = 17          # a chain of 16 pairs
ETH_ASCII_SCANS = (3, 11)    # written as ASCII (the native scan); the rest binary
ENTRY_ETH_ARGS = ("--metric", "2", "--linear", "--selection", "1")
ROOM_FRAMES = 11             # frames 0-10: `room` tracks 1-8, the experiments' room row 10
ROOM_TRACKED = TUM_BATCH_FRAMES
# The artifact writer runs on a short `room --projective --artifacts-dir`
# call of its own: each frame's OFF mesh (~300k vertices, ~36 MB of text)
# takes ~4 s to write.
ROOM_TRACKED_ARTIFACTS = 2


def write_eth_files(root):
    """ETH_FILE_SCANS scans of one static scene (``synth_cloud(N_POINTS,
    0)``) as .pcd files, pre-aligned as ``plain_global.csv``'s scans are,
    and the pose CSV in that layout (columns 1-2 the reading and reference
    file names, 4-15 the 3x4 pose): row k registers scan k+1 onto scan k,
    and its pose is ``eth_true_pose(k)``, which the driver scales by 0.1
    and applies to the reading. Returns the CSV path and the scene."""
    import os

    from icp_variants_tpu_torch.data import pcd_io

    data = os.path.join(root, "plain")
    os.makedirs(data, exist_ok=True)
    scene, _ = synth_cloud(N_POINTS, 0)
    for i in range(ETH_FILE_SCANS):
        pcd_io.write_pcd(os.path.join(data, f"scan{i:02d}.pcd"), scene,
                         binary=i not in ETH_ASCII_SCANS)
    rows = [f"{k},scan{k + 1:02d}.pcd,scan{k:02d}.pcd,1.0,"
            + ",".join(f"{x:.9g}" for x in eth_true_pose(k)[:3, :4].reshape(-1))
            for k in range(ETH_FILE_SCANS - 1)]
    csv = os.path.join(root, "plain_global.csv")
    with open(csv, "w") as f:
        f.write("id,reading,reference,overlap," + ",".join(f"T{k}" for k in range(12)) + "\n")
        f.write("\n".join(rows) + "\n")
    return csv, scene


def write_tum_files(root):
    """ROOM_FRAMES frames of ``synth_depth_frame(i)`` in the TUM layout:
    ``rgb/`` and ``depth/`` PNGs (16-bit depth at 5000 per metre),
    ``rgb.txt``, ``depth.txt``, ``groundtruth.txt`` (camera i at x =
    -TUM_SHIFT i, identity rotation)."""
    import os

    from PIL import Image

    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for i in range(ROOM_FRAMES):
        depth, color = synth_depth_frame(i)
        ts = f"{1000.0 + 0.1 * i:.4f}"
        Image.fromarray(np.round(depth * 5000.0).astype(np.uint16)).save(
            os.path.join(root, f"depth/{i:03d}.png"))
        Image.fromarray(np.ascontiguousarray(color[..., :3]), "RGB").save(
            os.path.join(root, f"rgb/{i:03d}.png"))
        lines["depth.txt"].append(f"{ts} depth/{i:03d}.png")
        lines["rgb.txt"].append(f"{ts} rgb/{i:03d}.png")
        lines["groundtruth.txt"].append(f"{ts} {-TUM_SHIFT * i:.6f} 0 0 0 0 0 1")
    for name, rows in lines.items():
        with open(os.path.join(root, name), "w") as f:
            f.write("# written by chip_smoke.py\n# a\n# b\n" + "\n".join(rows) + "\n")


class Spy:
    """Wrap ``owner.name`` for the duration of a ``with``: record each
    call's arguments, result and seconds in ``calls``, or only what
    ``keep(args, kwargs, out)`` returns."""

    def __init__(self, owner, name, keep=None):
        self.owner, self.name, self.calls, self.keep = owner, name, [], keep

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            self.calls.append(
                dict(args=args, kwargs=kwargs, out=out, seconds=time.perf_counter() - t0)
                if self.keep is None else self.keep(args, kwargs, out))
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _so3_exp64(w):
    th = float(np.linalg.norm(w))
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1.0 - np.cos(th)) / th ** 2 * K @ K


def _so3_log64(R):
    th = math.acos(float(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return v if th < 1e-12 else v * th / math.sin(th)


def _se3_exp64(xi):
    """The left increment ``[R(xi[:3]) | xi[3:]]``, float64."""
    T = np.eye(4)
    T[:3, :3] = _so3_exp64(xi[:3])
    T[:3, 3] = xi[3:]
    return T


def _graph_residuals64(poses, edges):
    """Each edge's ``w [log_SO3(R_e), t_e]`` of ``(T_i A)^-1 T_j``, float64
    (the pose graph's residual, ``parallel/pose_graph.edge_residuals``)."""
    out = []
    for i, j, A, w in edges:
        E = np.linalg.inv(poses[i] @ A) @ poses[j]
        out.append(w * np.concatenate([_so3_log64(E[:3, :3]), E[:3, 3]]))
    return np.concatenate(out)


def _refine64(poses, edges, iterations=20):
    """Plain float64 Gauss-Newton over the same objective, pose 0 held
    fixed (the gauge), central-difference Jacobians of left increments."""
    poses = np.array(poses, np.float64)
    v, h = len(poses), 1e-6
    for _ in range(iterations):
        r = _graph_residuals64(poses, edges)
        J = np.zeros((len(r), 6 * (v - 1)))
        for k in range(1, v):
            for m in range(6):
                e = np.zeros(6)
                e[m] = h
                cols = []
                for sgn in (1.0, -1.0):
                    p = poses.copy()
                    p[k] = _se3_exp64(sgn * e) @ poses[k]
                    cols.append(_graph_residuals64(p, edges))
                J[:, 6 * (k - 1) + m] = (cols[0] - cols[1]) / (2 * h)
        dx = np.linalg.lstsq(J, -r, rcond=None)[0]
        for k in range(1, v):
            poses[k] = _se3_exp64(dx[6 * (k - 1):6 * k]) @ poses[k]
        if np.abs(dx).max() < 1e-12:
            break
    return poses


def pose_graph_check(rel, device, drift_edge=7):
    """The port's ``pose_graph.refine`` on ``device`` against
    :func:`_refine64` on one graph: the chain ``rel`` (``rel[k]`` maps scan
    k+1 into scan k) with a known drift put into edge ``drift_edge``
    (0.0269 rad and 0.0616 m) and two loop-closure edges carrying the
    undrifted chain's poses, which the refinement must use to pull the
    drift back. Fails unless the refined poses agree with the float64
    solve within 1e-4 (m and rad), far under the drift, and the refined
    trajectory lies closer to the undrifted one than the odometry.
    Returns the readings, and the graph (host arrays: the base poses and
    the edges) with its refined and float64 poses."""
    import torch

    from icp_variants_tpu_torch.parallel import pose_graph as pg

    rel = np.asarray(rel, np.float64)
    n = len(rel)
    truth = [np.eye(4)]
    for k in range(n):
        truth.append(truth[-1] @ rel[k])
    drifted = rel.copy()
    drifted[drift_edge] = _se3_exp64(np.array([0.01, -0.015, 0.02, 0.05, -0.03, 0.02])) \
        @ rel[drift_edge]
    odometry, graph = pg.sequential_graph(drifted.astype(np.float32), device=device)
    closures = [(0, n), (n // 4, 3 * n // 4)]
    extra = [np.linalg.inv(truth[i]) @ truth[j] for i, j in closures]
    graph = pg.PoseGraph(
        edge_i=torch.cat([graph.edge_i, torch.tensor([i for i, _ in closures], device=device)]),
        edge_j=torch.cat([graph.edge_j, torch.tensor([j for _, j in closures], device=device)]),
        rel_poses=torch.cat([graph.rel_poses, torch.from_numpy(
            np.stack(extra).astype(np.float32)).to(device)]),
        weights=torch.cat([graph.weights, torch.ones(len(closures), device=device)]))
    t0 = time.perf_counter()
    refined = pg.refine(odometry, graph).cpu().numpy().astype(np.float64)
    refine_s = time.perf_counter() - t0
    edges = [(int(i), int(j), A, float(w)) for i, j, A, w in zip(
        graph.edge_i.tolist(), graph.edge_j.tolist(),
        graph.rel_poses.cpu().numpy().astype(np.float64), graph.weights.tolist())]
    ref = _refine64(odometry, edges)
    gap_t = float(np.abs(refined[:, :3, 3] - ref[:, :3, 3]).max())
    gap_r = max(float(np.linalg.norm(_so3_log64(a[:3, :3].T @ b[:3, :3])))
                for a, b in zip(refined, ref))

    def ate(traj):
        return float(np.sqrt(np.mean([np.sum((a[:3, 3] - b[:3, 3]) ** 2)
                                      for a, b in zip(traj, truth)])))

    def cost(traj):
        return float(np.sum(_graph_residuals64(np.asarray(traj, np.float64), edges) ** 2))

    out = dict(poses=n + 1, edges=len(edges), refine_s=refine_s, gap_t_m=gap_t, gap_r_rad=gap_r,
               ate_odometry_m=ate(odometry), ate_refined_m=ate(refined), ate_f64_m=ate(ref),
               cost_odometry=cost(odometry), cost_refined=cost(refined), cost_f64=cost(ref))
    print(f"  pose graph ({device}; {n + 1} poses, {len(edges)} edges, edge {drift_edge} "
          f"drifted, closures {closures}): refine {refine_s:.3f} s; ATE to the undrifted chain "
          f"odometry {out['ate_odometry_m']:.6f} -> refined {out['ate_refined_m']:.6f} m "
          f"(float64 {out['ate_f64_m']:.6f}); cost {out['cost_odometry']:.6e} -> "
          f"{out['cost_refined']:.6e} (float64 {out['cost_f64']:.6e}); against the float64 "
          f"solve {gap_t:.3e} m, {gap_r:.3e} rad", flush=True)
    check(gap_t <= 1e-4 and gap_r <= 1e-4,
          f"pose graph: refine on {device} equals a float64 Gauss-Newton on the same graph "
          f"within 1e-4 m and 1e-4 rad ({gap_t:.2e} m, {gap_r:.2e} rad; the drift 0.0616 m, "
          f"0.0269 rad)")
    check(out["ate_refined_m"] < 0.5 * out["ate_odometry_m"]
          and out["cost_refined"] < 0.05 * out["cost_odometry"],
          "pose graph: the refinement pulled the drift back (ATE to the undrifted chain under "
          "half the odometry's, the cost under 5% of it)")
    arrays = dict(base_poses=np.asarray(odometry, np.float32),
                  edge_i=graph.edge_i.cpu().numpy(), edge_j=graph.edge_j.cpu().numpy(),
                  rel_poses=graph.rel_poses.cpu().numpy(), weights=graph.weights.cpu().numpy())
    return out, dict(arrays=arrays, refined=refined, f64=ref)


def run_cli(argv, launches, label):
    """``icp_variants_tpu_torch.__main__.main(argv)`` in-process, the card
    synchronised after it; the kernels' launches counted from 0 around it
    (added to ``launches``). Returns (stdout lines, wall seconds, its
    launches)."""
    import contextlib
    import io

    import torch

    from icp_variants_tpu_torch import __main__ as cli
    from icp_variants_tpu_torch.ops import _cuda

    out = io.StringIO()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_launches = collections.Counter(_cuda.LAUNCHES)
    launches.update(run_launches)
    check(rc == 0, f"{label}: main() returned {rc}")
    return out.getvalue().splitlines(), wall, dict(run_launches)


def entry_phase(card):
    """Phase 10 on the card: the port's CLI (``__main__.main``) from files
    it writes under a temporary directory. Returns the launches of its
    runs and the pose graph of :func:`pose_graph_check` (for phase 11).
    Raises :class:`Failure` on a failed check."""
    import os
    import re
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from icp_variants_tpu_torch.data import loaders, off_io, pcd_io, ply_io
    from icp_variants_tpu_torch.ops import kdtree
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.runtime import native
    from icp_variants_tpu_torch.workloads import eth as eth_wl

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    print(f"phase 10: entry points from files through the CLI [{card}]", flush=True)
    launches = collections.Counter()
    result = dict(card=card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        csv, scene = write_eth_files(os.path.join(tmp, "eth"))
        tum_dir = os.path.join(tmp, "tum")
        write_tum_files(tum_dir)
        result["write_s"] = time.perf_counter() - t0
        print(f"  wrote {ETH_FILE_SCANS} scans of {N_POINTS} points ({len(ETH_ASCII_SCANS)} "
              f"ASCII) and {ROOM_FRAMES} TUM frames of {TUM_W} x {TUM_H}: "
              f"{result['write_s']:.2f} s", flush=True)

        # ---- ETH from files, the headline configuration, with --refine ------
        # One run under the profiler (the card's activity only, for the busy
        # share): pairs/s from the sweep's wall (align_eth_batch, which ends
        # in its reads of the results), the pose graph after it.
        argv = ("eth", csv, "--batch", "16", "--max-pairs", "16", *ENTRY_ETH_ARGS, "--refine")
        with Spy(eth_wl, "align_eth_batch") as sweep, Spy(native, "kd_partition") as part, \
                Spy(kdtree, "kd_partition_np") as part_np, Spy(icp, "run_icp_batch") as runs, \
                Spy(eth_wl, "refine_trajectory") as traj, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            lines, wall, run_l = run_cli(argv, launches, "eth")
            time.sleep(PROFILE_PAD_S)
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e3
        res = sweep.calls[0]["out"]
        n = len(res.pairs)
        load = res.load
        sweep_s = sweep.calls[0]["seconds"]
        eth = dict(argv=" ".join(argv[2:]), wall_s=wall, pairs=n, sweep_s=sweep_s,
                   pairs_per_s=n / sweep_s, launches=run_l, device_ms=device_ms,
                   busy_share=device_ms / 1e3 / wall, load={k: v for k, v in load.items()},
                   hidden_s=load["load"] - load["wait"],
                   kd_partition_calls=len(part.calls), kd_partition_np_calls=len(part_np.calls),
                   libicpio=str(native.LIB_PATH.relative_to(native._REPO_ROOT)),
                   benchmark=[(p.initial_error, p.final_error) for p in res.pairs])
        print(f"  eth {eth['argv']} (profiled, the card's activity): {n} pairs, the sweep "
              f"{sweep_s:.3f} s end to end = {eth['pairs_per_s']:.3f} pairs/s; the command "
              f"{wall:.3f} s; device kernel time {device_ms:.1f} ms, busy share "
              f"{eth['busy_share']:.3f} [{card}]")
        print(f"  host seconds: parse {load['parse']:.3f}, normals (on the card, Morton "
              f"order, upload) {load['normals']:.3f}, kd build {load['kd']:.3f}, perturbation "
              f"{load['perturb']:.3f}; load {load['load']:.3f}, of it hidden by the prefetch "
              f"{eth['hidden_s']:.3f} (the consumer waited {load['wait']:.3f})")
        print(f"  launches: {run_l}")
        for p in res.pairs:
            print(f"    pair {p.index:2d}: benchmark {p.initial_error:.6f} -> "
                  f"{p.final_error:.3e}, rmse {p.initial_rmse:.6f} -> {p.final_rmse:.3e}")
        check(lines[:n] == [f"pair {p.index}: benchmark {p.initial_error:.5f} -> "
                            f"{p.final_error:.5f}" for p in res.pairs],
              "eth: the CLI printed every pair's line")
        check(n == 16 and all(p.final_error < p.initial_error for p in res.pairs),
              "eth: every pair's final benchmark error below its initial one")
        check(native._lib is not None and native.LIB_PATH.exists()
              and native.LIB_PATH.parent == native.BUILD_DIR,
              f"eth: the port's {eth['libicpio']} built and loaded")
        check(len(part.calls) == 16 and not part_np.calls,
              f"eth: native.kd_partition built all {len(part.calls)} kd indexes "
              f"(numpy partition calls: {len(part_np.calls)})")
        check(len(runs.calls) == 1, "eth: one run_icp_batch call for the 16-pair batch")

        # The same clouds and kd indexes built directly (the sequential reader,
        # the main thread, no prefetch), the same generator seed.
        cfg = runs.calls[0]["args"][0]
        t0 = time.perf_counter()
        loader = loaders.ETHDataLoader(csv, capacity=runs.calls[0]["args"][1].capacity,
                                       device=dev)
        raw = [pcd_io.read_pcd(loader._path(f"scan{i:02d}.pcd")) for i in range(ETH_FILE_SCANS)]
        scans = [loader._cloud_from_points(pts) for pts in raw]
        rows = [loader.rows[k + 1] for k in range(16)]
        check(all(r[1] == f"scan{k + 1:02d}.pcd" and r[2] == f"scan{k:02d}.pcd"
                  for k, r in enumerate(rows)), "eth: the CSV chains scan k+1 onto scan k")
        sources, targets, kds = [], [], []
        for k in range(16):
            scaled = eth_wl.scale_pose(loader._gt_pose(k), 0.1)
            sources.append(eth_wl.perturb_cloud(scans[k + 1], scaled))
            targets.append(scans[k])
            kds.append(icp.build_kd_for(cfg, scans[k], device=dev))
        src = icp.stack_clouds(sources)
        counts = loader.point_counts(max_pairs=16)
        direct = icp.run_icp_batch(
            cfg, src, icp.stack_clouds(targets), gt_source_points=src.points,
            gt_target_points=torch.stack([s.points for s in scans[1:]]), gt_valid=src.valid,
            generator=torch.Generator(device=dev).manual_seed(0), run_benchmark=True,
            kd_indexes=kdtree.stack_kd_indexes(kds), num_source_points=int(counts.max()),
            device=dev)
        poses = direct.pose.cpu().numpy()
        cli_poses = np.stack([p.pose for p in res.pairs])
        gap = float(np.abs(poses.astype(np.float64) - cli_poses).max())
        eth["direct_s"] = time.perf_counter() - t0
        eth["direct_pose_gap"] = gap
        ascii_gap = max(float(np.abs(raw[i] - scene).max()) for i in ETH_ASCII_SCANS)
        check(np.array_equal(poses, cli_poses)
              and np.array_equal(direct.trace.benchmark.cpu().numpy(),
                                 np.stack([p.benchmark_per_iteration for p in res.pairs])),
              f"eth: the CLI's 16 final poses and benchmark curves equal a direct "
              f"run_icp_batch on the same clouds, kd indexes and seed, bit for bit "
              f"(gap {gap:.3e}; the direct load {eth['direct_s']:.2f} s)")
        check(all(np.array_equal(raw[i], scene)
                  for i in range(ETH_FILE_SCANS) if i not in ETH_ASCII_SCANS)
              and 0 < ascii_gap < 1e-5,
              f"eth: binary scans read back bit for bit, ASCII scans within %.7g's rounding "
              f"({ascii_gap:.2e} m)")
        del direct, src, sources, targets, kds, scans, raw
        torch.cuda.empty_cache()

        ate = [ln for ln in lines if ln.startswith("trajectory ATE")]
        nums = [float(x) for x in re.findall(r"(\d+\.\d+) m", ate[0])] if ate else []
        eth.update(refine_s=wall - sweep_s, ate_odometry_m=nums[:1], ate_refined_m=nums[1:2],
                   refine_lines=lines[-3:])
        print(f"  eth --refine: {eth['refine_s']:.3f} s after the sweep; " + "; ".join(lines[-3:]))
        check(len(nums) == 2 and nums[1] <= nums[0] + 1e-5 and nums[1] < 1e-3,
              f"eth --refine: trajectory ATE odometry {nums[:1]} m -> refined {nums[1:2]} m")
        # The pre-aligned chain leaves the CLI's refine nothing to correct,
        # so its graph is held on the card against a float64 solve with a
        # drifted edge and two loop closures: the CLI's 16 edges, each
        # composed with eth_true_pose(k) to give the chain a real shape.
        rel = traj.calls[0]["out"][2].rel_poses.cpu().numpy()
        eth["pose_graph"], graph_case = pose_graph_check(
            np.stack([eth_true_pose(k) @ rel[k] for k in range(len(rel))]), dev)
        result["eth"] = eth

        # ---- checkpoint and resume ------------------------------------------
        ck = os.path.join(tmp, "ck")
        argv_ck = ("eth", csv, "--batch", "4", "--max-pairs", "8", "--checkpoint-dir", ck,
                   *ENTRY_ETH_ARGS)
        with Spy(eth_wl, "align_eth_batch") as sweep:
            _, wall_c, run_lc = run_cli(argv_ck, launches, "eth --checkpoint-dir")
        first = sweep.calls[0]["out"]
        with Spy(eth_wl, "align_eth_batch") as sweep, \
                Spy(loaders.ETHDataLoader, "get_items") as loads, Spy(icp, "run_icp_batch") as rr:
            _, wall_c2, run_lc2 = run_cli(argv_ck, launches, "eth --checkpoint-dir, again")
        again = sweep.calls[0]["out"]
        ld = first.load
        ck_row = dict(wall_s=wall_c, launches=run_lc, load=dict(ld), resume_wall_s=wall_c2,
                      resume_launches=run_lc2, resume_loads=len(loads.calls),
                      resume_runs=len(rr.calls))
        print(f"  eth --batch 4 --max-pairs 8 --checkpoint-dir: {wall_c:.3f} s; normals spans "
              f"{ld.get('normals_device_ms', 0.0):.1f} device ms, of them "
              f"{ld.get('overlap_ms', 0.0):.1f} while batch 0's run was in flight; hidden "
              f"{ld['load'] - ld['wait']:.3f} of {ld['load']:.3f} host s; again: "
              f"{wall_c2:.3f} s, {len(loads.calls)} loads, {len(rr.calls)} runs")
        check(ld.get("overlap_ms", 0.0) > 0,
              "prefetch: batch 1's normals (worker stream) ran on the card while batch 0's "
              "run was in flight")
        check(len(first.pairs) == 8 and not loads.calls and not rr.calls and not run_lc2,
              "checkpoint: the second run resumed all 8 pairs and registered nothing")
        check(all(np.array_equal(a.pose, b.pose) for a, b in zip(first.pairs, again.pairs)),
              "checkpoint: the resumed poses equal the first run's")
        result["checkpoint"] = ck_row

        # ---- room, both modes -------------------------------------------------
        room = {}
        for label, tracked, extra in (
                ("knn", ROOM_TRACKED, ()),
                ("projective", ROOM_TRACKED, ("--projective",)),
                ("projective --artifacts-dir", ROOM_TRACKED_ARTIFACTS,
                 ("--projective", "--artifacts-dir", os.path.join(tmp, "room_art")))):
            argv_r = ("room", tum_dir, "--frame-step", "1", "--max-frames", str(tracked - 1),
                      *extra)
            lines, wall_m, run_lm = run_cli(argv_r, launches, f"room {label}")
            rm = [tuple(float(x) for x in re.findall(r"rmse (\S+) -> (\S+)", ln)[0])
                  for ln in lines if ln.startswith("frame ")]
            room[label] = dict(wall_s=wall_m, launches=run_lm, rmse=rm)
            print(f"  room {label}: {len(rm)} frames in {wall_m:.3f} s; rmse "
                  + ", ".join(f"{a:.5f} -> {b:.5f}" for a, b in rm))
            check(len(rm) == tracked and all(b < a for a, b in rm),
                  f"room {label}: every tracked frame's final RMSE below its initial one")
        meshes = sorted(os.listdir(os.path.join(tmp, "room_art")))
        m0 = off_io.read_off(os.path.join(tmp, "room_art", "mesh_0.off"))
        check(len(meshes) == ROOM_TRACKED_ARTIFACTS + 1 and len(m0.vertices) > 0,
              f"room --artifacts-dir: {len(meshes)} meshes, mesh_0 {len(m0.vertices)} vertices")
        result["room"] = room

        # ---- experiments and bunny -------------------------------------------
        out_dir = os.path.join(tmp, "exp")
        lines, wall_x, run_lx = run_cli(
            ("experiments", "assets/experiment.csv", "--out-dir", out_dir,
             "--room-data-dir", tum_dir), launches, "experiments")
        summary = json.loads("\n".join(lines))
        files = sorted(os.listdir(out_dir))
        curves = {f: np.loadtxt(os.path.join(out_dir, f)) for f in files if f.endswith(".txt")}
        print(f"  experiments: {wall_x:.3f} s, rows {sorted(summary)}, files {files}")
        check(len(summary) == 4 and not any("error" in v for v in summary.values())
              and "bunny0_RMSE.txt" in curves and "room1_RMSE0.txt" in curves
              and all(np.isfinite(c).all() and c.size > 0 for c in curves.values()),
              "experiments: 3 bunny rows and 1 room row, their error files read back")
        art = os.path.join(tmp, "bunny_art")
        lines, wall_b, run_lb = run_cli(("bunny", "--artifacts-dir", art), launches, "bunny")
        plys = {f: ply_io.read_ply(os.path.join(art, f)) for f in sorted(os.listdir(art))
                if f.endswith(".ply")}
        joined = off_io.read_off(os.path.join(art, "bunny_icp.off"))
        rmse_txt = np.loadtxt(os.path.join(art, "RMSE.txt"))
        print(f"  bunny --artifacts-dir: {wall_b:.3f} s, {lines[-1]}; "
              + ", ".join(f"{k} {len(v['points'])} points" for k, v in plys.items())
              + f", bunny_icp.off {len(joined.vertices)} vertices")
        check(len(plys) == 3 and all(len(v["points"]) > 1000 for v in plys.values())
              and len(joined.vertices) > 2000 and rmse_txt.shape == (20,),
              "bunny: the .ply, .off and RMSE.txt artifacts read back")
        result.update(experiments=dict(wall_s=wall_x, launches=run_lx, files=files),
                      bunny=dict(wall_s=wall_b, launches=run_lb))
    print("  entry phase: " + json.dumps(result, default=float))
    return launches, graph_case


# ---------------------------------------------------------------------------
# Phase 11: the multi-device path (per-rank workers sharing the card)
# ---------------------------------------------------------------------------

MD_GT_STRIDE = 64            # every 64th source row is a ground-truth row
MD_PADDING_PAIRS = 2
MD_PADDING_STRIDE = 1426     # 365,056 / 1,426 = 256 source rows: one shard of real rows
MD_RANKS_TIMEOUT_S = 240
MD_T_GAP_M = 1e-5            # mean translation error within 0.01 mm of the unsharded run's
MD_KERNELS = ("box_topk", "kd_block_search", "visited_search")


def _mean_t_err(poses):
    poses = np.asarray(poses, np.float64)
    return float(np.mean([np.abs((poses[i] @ eth_true_pose(i).astype(np.float64))[:3, 3]).max()
                          for i in range(len(poses))]))


def _run_world(world, root, backend, label, device=None):
    """The port's per-rank worker (``multihost_rehearsal``) on every case of
    ``root``: ``world`` processes on this card; returns each rank's summary
    (wall, launches, collectives per case). A rank's nonzero exit or
    overrun fails the phase."""
    from icp_variants_tpu_torch.scripts import multihost_rehearsal as rehearsal

    t0 = time.perf_counter()
    procs = rehearsal.start_ranks(world, f"file://{root}/rdzv", root, cases=root,
                                  backend=backend, device=device)
    try:
        outs = rehearsal.join_ranks(procs, root, MD_RANKS_TIMEOUT_S)
    except RuntimeError as exc:
        raise Failure(f"{label}: {exc}") from exc
    wall = time.perf_counter() - t0
    check(all("CASES OK" in o for o in outs),
          f"{label}: {world} rank(s), backend {backend or ('gloo' if device else 'nccl')}, "
          "every case run "
          f"({wall:.1f} s with start-up)")
    return [json.loads((root / "out" / f"rank{r}.json").read_text()) for r in range(world)]


def _rank_results(root, name, world):
    return [dict(np.load(root / "out" / f"{name}.rank{r}.npz")) for r in range(world)]


def multidevice_phase(eth, graph, card):
    """Phase 11 on the card: the port's multi-device path
    (``parallel/sharded_icp``, ``parallel/distributed``,
    ``pose_graph.refine_sharded``) driven by its per-rank worker
    (``scripts/multihost_rehearsal.py``), the ranks separate processes on
    the one card, on phase 3's data and draws (the ETH headline's exact
    arm, 16 pairs x 365,056 rows x 50 iterations) written as numpy under a
    temporary directory. Returns each kernel's launches per case and rank.
    Raises :class:`Failure` on a failed check."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from icp_variants_tpu_torch.core import se3
    from icp_variants_tpu_torch.core.cloud import Cloud
    from icp_variants_tpu_torch.ops import kdtree, selection
    from icp_variants_tpu_torch.parallel import sharded_icp
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import Selection
    from icp_variants_tpu_torch.scripts import multihost_rehearsal as rehearsal

    print(f"phase 11: the multi-device path, ranks as processes sharing one card [{card}]",
          flush=True)
    sources, kd = eth["sources"], eth["kd"]
    dev = sources.points.device
    targets = icp.stack_clouds(eth["targets_host"]).to(dev)
    b, cap = sources.valid.shape
    cfg = eth_config()

    # ---- phase 3's draws, its unsharded run, the ground-truth rows -------
    k_cap = icp._compact_capacity(cap, SELECTION_P)
    gen = torch.Generator(device=dev).manual_seed(eth["exact_seed"])
    draws = [selection.bernoulli_gap_indices(gen, SELECTION_P, 1, cap, k_cap, batch=(b,),
                                             device=dev) for _ in range(N_ITERATIONS)]
    sel = torch.stack([d[0] for d in draws], dim=1)
    inr = torch.stack([d[1] for d in draws], dim=1)
    inv = torch.from_numpy(np.stack([np.linalg.inv(eth_true_pose(i)) for i in range(b)])
                           .astype(np.float32)).to(dev)
    gt_src = sources.points[:, ::MD_GT_STRIDE].contiguous()
    gt = dict(gt_source_points=gt_src, gt_target_points=se3.transform_points(gt_src, inv),
              gt_valid=sources.valid[:, ::MD_GT_STRIDE].contiguous())
    t0 = time.perf_counter()
    ref = icp.run_icp_batch(cfg, sources, targets, kd_indexes=kd, selected=(sel, inr),
                            run_benchmark=True, device=dev, **gt)
    ref.pose.cpu()
    ref_s = time.perf_counter() - t0
    phase3 = eth["exact"]
    check(torch.equal(ref.pose, phase3.pose)
          and torch.equal(ref.trace.num_matches, phase3.trace.num_matches),
          "phase 3's draws replayed through selected=: the unsharded run equals phase 3's "
          "exact-arm run bit for bit (poses, match counts)")
    ref_np = {k: v.cpu().numpy() for k, v in (("pose", ref.pose), ("rmse", ref.trace.rmse),
                                              ("benchmark", ref.trace.benchmark),
                                              ("num_matches", ref.trace.num_matches))}

    # The padding case: 256 source rows a pair over two points shards, so
    # the second shard is padding only; SELECT_ALL on the exact arm.
    cfg_all = cfg.replace(selection=Selection.ALL)
    small = Cloud(*(f[:MD_PADDING_PAIRS, ::MD_PADDING_STRIDE].contiguous() for f in sources))
    small_tgt = Cloud(*(f[:MD_PADDING_PAIRS] for f in targets))
    small_kd = kdtree.KDIndex(*(None if f is None else f[:MD_PADDING_PAIRS] for f in kd))
    ref_small = icp.run_icp_batch(cfg_all, small, small_tgt, kd_indexes=small_kd, device=dev)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_md_"))
    try:
        t0 = time.perf_counter()

        def host(x):
            return x.detach().cpu().numpy()

        one = sharded_icp.shard_draws(sel.cpu(), inr.cpu(), 1, cap, SELECTION_P)
        two = sharded_icp.shard_draws(sel.cpu(), inr.cpu(), 2, cap // 2, SELECTION_P)
        check(torch.equal(one[0][:, 0], sel.cpu()) and torch.equal(one[1][:, 0], inr.cpu()),
              "shard_draws over one shard returns the run's draws unchanged")
        arrays = {f"src_{f}": host(x) for f, x in zip(Cloud._fields, sources)}
        arrays.update({f"tgt_{f}": host(x) for f, x in zip(Cloud._fields, targets)})
        arrays.update({f"kd_{f}": host(x) for f, x in zip(kdtree.KDIndex._fields, kd)
                       if x is not None})
        arrays.update(gt_src=host(gt["gt_source_points"]), gt_tgt=host(gt["gt_target_points"]),
                      gt_valid=host(gt["gt_valid"]), one_rows=host(one[0]),
                      one_flags=host(one[1]), two_rows=host(two[0]), two_flags=host(two[1]))
        np.savez(tmp / "eth.npz", **arrays)
        small_arrays = {f"src_{f}": host(x) for f, x in zip(Cloud._fields, small)}
        small_arrays.update({f"tgt_{f}": host(x) for f, x in zip(Cloud._fields, small_tgt)})
        small_arrays.update({f"kd_{f}": host(x) for f, x in zip(kdtree.KDIndex._fields, small_kd)
                             if x is not None})
        np.savez(tmp / "small.npz", **small_arrays)
        np.savez(tmp / "graph.npz", **graph["arrays"])
        del arrays, small_arrays
        write_s = time.perf_counter() - t0
        w1, w2 = tmp / "world1", tmp / "world2"
        w1.mkdir()
        w2.mkdir()
        common = dict(kind="icp", data="../eth.npz", cfg=cfg, run_benchmark=True, warmup=True)
        rehearsal.write_spec(w1, [dict(common, name="world1", points_per_pair=1,
                                       selected="one")])
        rehearsal.write_spec(w2, [
            dict(common, name="points2", points_per_pair=2, selected="two"),
            dict(common, name="pairs2", points_per_pair=1, selected="one"),
            dict(name="padding", kind="icp", data="../small.npz", cfg=cfg_all,
                 points_per_pair=2, padding_check=True),
            dict(name="refine", kind="refine", data="../graph.npz", points_per_pair=1,
                 n_iterations=10, warmup=True)])
        print(f"  unsharded run {ref_s:.3f} s; the inputs written as numpy in {write_s:.1f} s "
              f"({sum(f.stat().st_size for f in tmp.glob('*.npz')) / 1e9:.2f} GB)", flush=True)

        # The workers' device: the card (nccl by default), or the CPU for a
        # rehearsal of this phase on small data.
        on_cpu = "cpu" if dev.type == "cpu" else None
        summary1 = _run_world(1, w1, None, "world of one", on_cpu)
        summary2 = _run_world(2, w2, "gloo", "world of two", on_cpu)
        res1 = _rank_results(w1, "world1", 1)[0]
        res_points = _rank_results(w2, "points2", 2)
        res_pairs = _rank_results(w2, "pairs2", 2)
        res_pad = _rank_results(w2, "padding", 2)
        res_refine = _rank_results(w2, "refine", 2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- case 1: a world of one, nccl, mesh 1 x 1 ------------------------
    check(all(np.array_equal(res1[k], ref_np[k]) for k in ref_np),
          "world of one (nccl, mesh 1 x 1): poses, RMSE, benchmark and match counts equal the "
          "unsharded run bit for bit")

    # ---- case 2: two ranks, mesh pairs 1 x points 2 ----------------------
    check(np.array_equal(res_points[0]["pose"], res_points[1]["pose"])
          and all(np.array_equal(res_points[0][k], res_points[1][k])
                  for k in ("rmse", "benchmark", "num_matches")),
          "points 2: both ranks hold the same poses and traces bit for bit")
    pts = res_points[0]
    nm_gap = int(np.abs(pts["num_matches"] - ref_np["num_matches"]).max())
    pose_gap = float(np.abs(pts["pose"] - ref_np["pose"]).max())
    t_sharded, t_ref = _mean_t_err(pts["pose"]), _mean_t_err(ref_np["pose"])
    print(f"  points 2: {b} pairs x {cap // 2} source rows a rank; iteration 0's match counts "
          f"{pts['num_matches'][:, 0].tolist()}; largest match-count gap over all iterations "
          f"{nm_gap}; largest pose entry gap {pose_gap:.3e}; mean t_err {t_sharded * 1e3:.6f} mm "
          f"against the unsharded {t_ref * 1e3:.6f} mm")
    check(np.array_equal(pts["num_matches"][:, 0], ref_np["num_matches"][:, 0]),
          "points 2: iteration 0's match counts equal the unsharded run's for every pair")
    check(np.allclose(pts["pose"], ref_np["pose"], rtol=1e-3, atol=5e-5),
          "points 2: final poses within rtol 1e-3 / atol 5e-5 of the unsharded run")
    check(abs(t_sharded - t_ref) <= MD_T_GAP_M,
          "points 2: mean translation error within 0.01 mm of the unsharded run's")

    # ---- case 3: two ranks, mesh pairs 2 x points 1 ----------------------
    pairs_np = {k: np.concatenate([r[k] for r in res_pairs]) for k in ref_np}
    check([tuple(r["pairs"]) for r in res_pairs] == [(0, b // 2), (b // 2, b)],
          "pairs 2: each rank holds 8 pairs")
    same = {k: bool(np.array_equal(pairs_np[k], ref_np[k])) for k in ref_np}
    t_pairs = _mean_t_err(pairs_np["pose"])
    print(f"  pairs 2: bit for bit the unsharded run's: {same}; largest pose entry gap "
          f"{float(np.abs(pairs_np['pose'] - ref_np['pose']).max()):.3e}, largest match-count "
          f"gap {int(np.abs(pairs_np['num_matches'] - ref_np['num_matches']).max())}, mean t_err "
          f"{t_pairs * 1e3:.6f} mm")
    # Not bit for bit: torch.sum over the query rows (se3.masked_mean's)
    # reduces in another order at 8 pairs than at 16 on the card
    # (icp_variants_tpu_torch/scripts/batch_parting.py), so case 2's gates.
    check(np.array_equal(pairs_np["num_matches"][:, 0], ref_np["num_matches"][:, 0])
          and np.allclose(pairs_np["pose"], ref_np["pose"], rtol=1e-3, atol=5e-5)
          and abs(t_pairs - t_ref) <= MD_T_GAP_M,
          "pairs 2: iteration 0's match counts equal the unsharded run's, poses within rtol "
          "1e-3 / atol 5e-5, mean translation error within 0.01 mm")

    # ---- case 4: the all-padding shard -----------------------------------
    info_pad = [s["padding"] for s in summary2]
    pad_rank = [r for r, s in enumerate(summary2) if s["padding"]["padding"] is not None]
    check(pad_rank == [1], "padding: the second points shard holds padding only")
    run_l = info_pad[1]["launches"]
    direct = info_pad[1]["padding"]
    print(f"  padding: rank 1's run launches {run_l}; its {direct['rows']} masked queries "
          f"through match_kd: {direct['matched']} matched, {direct['not_minus_one']} not -1, "
          f"launches {direct['launches']}")
    check(all(run_l.get(k, 0) >= cfg_all.n_iterations for k in MD_KERNELS)
          and all(direct["launches"].get(k, 0) >= 1 for k in MD_KERNELS)
          and direct["matched"] == 0 and direct["not_minus_one"] == 0,
          "padding: box_topk, kd_block_search and visited_search launch on the all-padding "
          "shard every iteration and return misses (-1) on all its rows")
    check(np.array_equal(res_pad[0]["num_matches"], ref_small.trace.num_matches.cpu().numpy())
          and np.allclose(res_pad[0]["pose"], ref_small.pose.cpu().numpy(), rtol=1e-3, atol=5e-5),
          "padding: match counts equal the unsharded run of the 256 rows, poses within rtol "
          "1e-3 / atol 5e-5")

    # ---- case 5: refine_sharded on two ranks -----------------------------
    check(np.array_equal(res_refine[0]["pose"], res_refine[1]["pose"]),
          "refine_sharded: both ranks hold the same poses bit for bit")
    refined = res_refine[0]["pose"].astype(np.float64)
    gap_single = float(np.abs(refined - graph["refined"]).max())
    gap_t = float(np.abs(refined[:, :3, 3] - graph["f64"][:, :3, 3]).max())
    gap_r = max(float(np.linalg.norm(_so3_log64(a[:3, :3].T @ c[:3, :3])))
                for a, c in zip(refined, graph["f64"]))
    print(f"  refine_sharded (2 ranks, {len(graph['arrays']['edge_i'])} edges): "
          f"{summary2[0]['refine']['wall_s']:.3f} s after a warm-up call, "
          f"{summary2[0]['refine']['collectives'].get('calls', 0)} collectives; against the "
          "single-device refine "
          f"{gap_single:.3e}; against the float64 solve {gap_t:.3e} m, {gap_r:.3e} rad")
    check(np.allclose(refined, graph["refined"], rtol=1e-4, atol=1e-5),
          "refine_sharded: within rtol 1e-4 / atol 1e-5 of the single-device refine")
    check(gap_t <= 1e-4 and gap_r <= 1e-4,
          "refine_sharded: within 1e-4 m and 1e-4 rad of the float64 Gauss-Newton (phase 10's "
          "gate)")

    # ---- what the ranks did ------------------------------------------------
    summaries = {"world1": summary1, "points2": summary2, "pairs2": summary2,
                 "padding": summary2}
    sharded = collections.defaultdict(dict)
    for case, summ in summaries.items():
        for r, s in enumerate(summ):
            c = s[case]
            for name in MD_KERNELS:
                sharded[name][f"{case} rank {r}"] = c["launches"].get(name, 0)
            calls = c["collectives"].get("calls", 0)
            print(f"  {case} rank {r} (coords {c['coords']}, pairs {c['pairs']}): "
                  f"{c['wall_s']:.3f} s, launches {c['launches']}, collectives {calls} "
                  f"({calls / c['iterations']:.1f} an iteration, "
                  f"{c['collectives'].get('bytes', 0)} bytes)", flush=True)
    for case in ("points2", "pairs2"):
        wall = max(s[case]["wall_s"] for s in summary2)
        print(f"  {case}: two ranks sharing one card: not a scaling figure: {wall:.3f} s, "
              f"{b / wall:.4f} pairs/s [{card}]; one rank, unsharded: {ref_s:.3f} s")
    for name in MD_KERNELS:
        least = 1 if name == "visited_search" else N_ITERATIONS
        check(all(sharded[name][f"{case} rank {r}"] >= least
                  for case in ("world1", "points2", "pairs2")
                  for r in range(len(summaries[case]))),
              f"{name}: launched >= {least} times on every rank of every sharded ETH run")
    return dict(sharded)


def record(rows_eth, launches_eth, rows, launches, sharded) -> None:
    """Phase 12: the kernels line. Each kd kernel's time, bound and plain
    time are at the colour path's full shapes (D = 6; the plain version in
    windows of rows, visited_search's on the live rows only), its ETH
    numbers (D = 3, full shapes) under ``eth``, visited_search's at the
    dense fallback's (D = 3) under ``dense``; the projective window
    search's at the projective path's; kd_radius_search's at the dense
    path's (D = 3), its colour reading (D = 6, k = 0) under ``colour``, and
    kd_block_search's on the packed-size pair under ``packed``; box_topk's
    at the dense path's shapes (512 blocks) under ``dense``;
    dense_nn_search's at the ETH width as the profiler feeds it (D = 3), its
    colour frame under ``colour``; pruned_nn_search's on ETH pair 0's
    selected queries at max_distance 10, at 0.01 under ``tight`` and on the
    colour frame under ``colour``; cached_block_search's pose mode under
    ``transform_pose``; kd_block_search's probe (at the ETH probe
    decomposition's shapes) under ``probe``; visited_ablate's at the JAX
    ablation script's shapes, the full mode's at the top and every mode's
    under ``modes``. Launches are summed over every path's main runs
    (dense_nn_search's on the profile path), phase 11's sharded runs
    included, which are also listed by case and rank under ``sharded``
    (``sharded``: each kernel's counts there); pruned_nn_search and the pose
    mode run on no pipeline path, and their launches are phase 7's direct
    calls, read from the wrappers' counts, as are phase 8's for the
    ablation kernel and the probe."""
    print("phase 12: the record", flush=True)
    sources_of = {
        "box_topk": ("icp_variants_tpu_torch/csrc/box_topk.cu",
                     "icp_variants_tpu/ops/kdtree.py:501"),
        "kd_block_search": ("icp_variants_tpu_torch/csrc/kd_block_search.cu",
                            "icp_variants_tpu/ops/knn.py:1321"),
        "visited_search": ("icp_variants_tpu_torch/csrc/visited_search.cu",
                           "icp_variants_tpu/ops/knn.py:500"),
        "cached_block_search": ("icp_variants_tpu_torch/csrc/cached_block_search.cu",
                                "icp_variants_tpu/ops/kdtree.py:671"),
        "projective_window_search": (
            "icp_variants_tpu_torch/csrc/projective_window_search.cu",
            "icp_variants_tpu/ops/knn.py:1321"),
        "kd_radius_search": ("icp_variants_tpu_torch/csrc/kd_radius_search.cu",
                             "icp_variants_tpu/ops/knn.py:891"),
        "dense_nn_search": ("icp_variants_tpu_torch/csrc/dense_nn_search.cu",
                            "icp_variants_tpu/ops/knn.py:120"),
        "pruned_nn_search": ("icp_variants_tpu_torch/csrc/dense_nn_search.cu",
                             "icp_variants_tpu/ops/knn.py:360"),
        "visited_ablate": ("icp_variants_tpu_torch/csrc/visited_ablate.cu",
                           "scripts/knn_ablate.py:37 (pallas_call at :210)"),
        "normal_equations": ("icp_variants_tpu_torch/csrc/normal_equations.cu",
                             "none: the JAX package leaves the solvers' normal equations to "
                             "XLA (icp_variants_tpu/solvers/linear.py)"),
        "pose_step": ("icp_variants_tpu_torch/csrc/pose_step.cu",
                      "none: the JAX package leaves the solvers' 6 x 6 solve and pose algebra "
                      "to XLA (icp_variants_tpu/solvers/linear.py)"),
    }
    kernels = []
    for name, (src, replaces) in sources_of.items():
        c, e = rows[name], rows_eth.get(name)
        if name == "visited_ablate":
            # TPU kernel 8 is a measurement aid: its count is phase 8's calls,
            # and its headline numbers are the full mode's.
            n_launch = c["direct_launches"]
            check(n_launch > 0, f"{name}: launched {n_launch} times by phase 8's checked calls "
                                "(no pipeline path runs it)")
            full = c["modes"]["full"]
            kernels.append(dict(
                name=name, route="cuda", source=src, replaces=replaces, launches=n_launch,
                launches_on="phase 8's checked calls, one per mode: no pipeline path runs "
                            "the ablation",
                max_abs_err=max(m["max_abs_err"] for m in c["modes"].values()),
                ms=full["ms"], plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
                bound_by=full["bound_by"], library_ms=None, shapes=c["shapes"],
                plain_on=c["plain_on"], modes=c["modes"],
                visited_search_ms=c["visited_search_ms"]))
            continue
        if name == "pruned_nn_search":
            # TPU kernel 7 is on no pipeline path: its count is the phase's calls.
            n_launch = c["direct_launches"]
            check(n_launch > 0, f"{name}: launched {n_launch} times by phase 7's direct calls "
                                "(no pipeline path runs it)")
        else:
            n_launch = (launches_eth.get(name, 0) + launches.get(name, 0)
                        + sum(sharded.get(name, {}).values()))
            check(n_launch > 0, f"{name}: launched {n_launch} times on the main paths")
        entry = dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=n_launch,
            max_abs_err=max(c["err"], e["err"] if e else 0.0), ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound"][0], bound_by=c["bound"][1],
            library_ms=None, shapes=c["shapes"], plain_on=c["plain_on"])
        if name in sharded:
            entry["sharded"] = sharded[name]
        if name in ("kd_block_search", "cached_block_search"):
            entry["shared_source"] = "icp_variants_tpu_torch/csrc/block_major.cuh"
        if name == "cached_block_search":
            entry["also_replaces"] = ("icp_variants_tpu/ops/knn.py:1321 (restrict_col and "
                                      "transform_pose modes)")
            entry["split_ms"] = c["split_ms"]
            p = rows["cached_block_search_pose"]
            entry["transform_pose"] = dict(
                ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound"][0],
                bound_by=p["bound"][1], max_abs_err=p["err"], shapes=p["shapes"],
                launches=p["launches"], launches_on="phase 7's direct call: no pipeline path "
                "runs the pose mode", split_ms=p["split_ms"])
        if name in ("dense_nn_search", "pruned_nn_search"):
            entry.update(split_ms=c["split_ms"], rescans=c["rescans"])
        if name == "dense_nn_search":
            entry["launches_on"] = "the profile path: profile_stages at ETH and colour width"
            col = rows["dense_nn_search_colour"]
            entry["max_abs_err"] = max(c["err"], col["err"])
            entry["colour"] = dict(ms=col["ms"], plain_ms=col["plain_ms"], bound_ms=col["bound"][0],
                                   bound_by=col["bound"][1], shapes=col["shapes"],
                                   split_ms=col["split_ms"], rescans=col["rescans"])
        if name == "pruned_nn_search":
            entry["launches_on"] = "phase 7's direct calls: no pipeline path runs TPU kernel 7"
            entry["max_abs_err"] = max(c["err"], c["tight"]["err"], c["colour"]["err"])
            entry["visited_cells"] = c["visited_cells"]
            for key in ("tight", "colour"):
                r = c[key]
                entry[key] = dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                                  bound_by=r["bound"][1], shapes=r["shapes"],
                                  visited_cells=r["visited_cells"], split_ms=r["split_ms"],
                                  rescans=r["rescans"])
        if name == "normal_equations":
            entry.update(library_ms=c["library_ms"], profiler_ms=c["profiler_ms"],
                         tol_share=max(r["tol_share"] for r in (c, c["projective"], c["eth"])),
                         library="four cuBLAS bmm (wJ^T J) on prebuilt (B, N, 6) Jacobians")
            for key in ("projective", "eth"):
                r = c[key]
                entry[key] = dict(ms=r["ms"], profiler_ms=r["profiler_ms"],
                                  plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                                  bound_ms=r["bound"][0], bound_by=r["bound"][1],
                                  max_abs_err=r["err"], shapes=r["shapes"])
        if name == "pose_step":
            entry.update(profiler_ms=c["profiler_ms"], host_ms=c["host_ms"],
                         plain_host_ms=c["plain_host_ms"], plain_kernels=c["plain_kernels"],
                         plain_err=c["plain_err"], err_unit="f32 ulps of the entry's magnitude")
            for key in ("projective", "eth"):
                r = c[key]
                entry[key] = dict(ms=r["ms"], profiler_ms=r["profiler_ms"],
                                  plain_ms=r["plain_ms"], host_ms=r["host_ms"],
                                  plain_host_ms=r["plain_host_ms"],
                                  plain_kernels=r["plain_kernels"], bound_ms=r["bound"][0],
                                  bound_by=r["bound"][1], max_abs_err=r["err"],
                                  plain_err=r["plain_err"], shapes=r["shapes"])
        if name == "projective_window_search":
            entry["mode"] = "pixel_window"
            entry["split_ms"] = c["split_ms"]
        if name == "kd_radius_search":
            entry["max_abs_err"] = max(c["err"], rows["kd_radius_search_d6"]["err"])
            entry["colour"] = {key: rows["kd_radius_search_d6"][key]
                               for key in ("ms", "plain_ms", "shapes")}
            entry["first_iteration"] = dict(ms=c["first_iteration_ms"],
                                            plain_ms=c["first_iteration_plain_ms"],
                                            bound_ms=c["first_iteration_bound_ms"])
            entry["k0_pair0"] = c["k0_pair0"]
        if name == "kd_block_search":
            p = rows["kd_block_search_packed"]
            entry["packed"] = dict(ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound"][0],
                                   bound_by=p["bound"][1], max_abs_err=p["err"],
                                   shapes=p["shapes"])
            p = rows["kd_block_search_probe"]
            check(p["launches"] > 0, f"kd_block_search probe: launched {p['launches']} times "
                                     "by phase 8's probe_decomp")
            entry["probe"] = dict(
                ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound"][0],
                bound_by=p["bound"][1], max_abs_err=p["err"], launches=p["launches"],
                launches_on="phase 8's checked probe call: no pipeline path runs the probe",
                prefix_ms=p["prefix_ms"], staging_ms=p["staging_ms"],
                distance_ms=p["distance_ms"], full_ms=p["full_ms"],
                full_plain_ms=p["full_plain_ms"], shapes=p["shapes"])
        if name == "visited_search":
            p = rows["visited_search_dense"]
            entry["max_abs_err"] = max(entry["max_abs_err"], p["err"])
            entry["dense"] = dict(ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound"][0],
                                  bound_by=p["bound"][1], max_abs_err=p["err"],
                                  shapes=p["shapes"], plain_on=p["plain_on"],
                                  live_rows=p["live_rows"],
                                  tiles_needed_per_live_row=p["tiles_needed_per_live_row"])
        if name == "box_topk":
            p = rows["box_topk_dense"]
            entry["max_abs_err"] = max(entry["max_abs_err"], p["err"])
            entry["dense"] = dict(ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound"][0],
                                  bound_by=p["bound"][1], max_abs_err=p["err"],
                                  shapes=p["shapes"], plain_on=p["plain_on"])
        if e is not None:
            entry["eth"] = dict(ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound"][0],
                                bound_by=e["bound"][1], max_abs_err=e["err"],
                                launches=launches_eth.get(name, 0))
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
