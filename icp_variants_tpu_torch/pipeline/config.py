"""The single configuration surface of the framework.

The reference scatters its knobs over compile-time ``#define``s
(main.cpp:22-41), programmatic setters (ICPOptimizer.h:41-95) and an
11-column experiment CSV (experiment.cpp:414-447). Here everything is one
frozen (hashable) dataclass. Field names and defaults are those of
``icp_variants_tpu.pipeline.config`` so a config mirrors field for field;
several comments below describe matcher options of the JAX package that
this port does not run yet (see ROADMAP.md).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace


class Selection(enum.IntEnum):
    """selection.h:8 — ``selection_methods``; RANDOM_FAST is an extension:
    a fixed-count uniform index draw instead of Bernoulli + compaction
    (statistically equivalent subsampling, one gather instead of a
    full-cloud cumsum per iteration)."""

    ALL = 0
    RANDOM = 1
    RANDOM_FAST = 2


class Matching(enum.IntEnum):
    """ICPOptimizer.h:71-78 — 0 = k-NN (FLANN there, Pallas here), 1 = projective."""

    KNN = 0
    PROJECTIVE = 1


class Weighting(enum.IntEnum):
    """weighting.h:8 — ``weighting_methods``. HUBER and TUKEY are
    extensions (robust M-estimator weights with a per-iteration
    MAD-adaptive scale, ops/weighting.py; no reference analog)."""

    CONSTANT = 0
    DISTANCES = 1
    NORMALS = 2
    COLORS = 3
    HUBER = 4
    TUKEY = 5


class Metric(enum.IntEnum):
    """ICPOptimizer.h:46-48 setMetric — error metric selection. GICP is
    an extension (Generalized-ICP plane-to-plane Mahalanobis metric,
    solvers/linear.py gicp_whitener; no reference analog)."""

    POINT_TO_POINT = 0
    POINT_TO_PLANE = 1
    SYMMETRIC = 2
    GICP = 3


class Minimizer(enum.IntEnum):
    """main.cpp:26 USE_LINEAR_ICP — closed-form/linear vs LM non-linear."""

    NONLINEAR_LM = 0
    LINEAR = 1


@dataclass(frozen=True)
class ICPConfig:
    """All six pipeline knobs + the cross-cutting options.

    Defaults mirror the reference's constructor defaults
    (ICPOptimizer.h:29-31): k-NN matching, select-all, constant weighting,
    normal-angle rejection ON, point-to-point metric, 20 iterations,
    max (squared) matching distance 3e-4.
    """

    metric: Metric = Metric.POINT_TO_POINT
    minimizer: Minimizer = Minimizer.NONLINEAR_LM
    matching: Matching = Matching.KNN
    selection: Selection = Selection.ALL
    weighting: Weighting = Weighting.CONSTANT
    rejection: bool = True

    # Trimmed ICP (Chetverikov et al.): keep only the best `trim_ratio`
    # fraction of valid matches by distance each iteration — robust
    # registration under partial overlap. 1.0 (the default, reference
    # parity) disables trimming. Extension — no reference analog
    # (ops/rejection.py trimmed_mask).
    trim_ratio: float = 1.0

    n_iterations: int = 20
    # NOTE: compared against SQUARED distances, exactly like the reference
    # (ICPOptimizer.h:154 "// Sqaure distance", NearestNeighbor.h:182).
    max_distance: float = 0.0003
    selection_proba: float = 1.0
    # Gather randomly-selected queries into a fixed ~1.25*p*N buffer before
    # matching (the static-shape analog of the reference's compaction at
    # selection.h:88-106). Disable to keep full-size masked queries.
    compact_queries: bool = True
    color_icp: bool = False
    multi_resolution: bool = False
    multi_resolution_min_points: int = 100  # ICPOptimizer.h:21

    # Warm-start kd matching: carry each source row's last match through
    # the scan and search within the exact distance to it (an upper bound
    # on the NN distance, so results are identical). Only active on the
    # kd matching path, and only WHERE IT WINS: dense (SELECT_ALL)
    # selection, where every row re-seeds its own cache slot each
    # iteration (measured 3.29 vs 3.52 s/frame on the TUM color tracker).
    # Under sparse compacted selection the granule cache dilutes and warm
    # LOSES (9.9 vs 12.35 pairs/s on the ETH headline, every hardware
    # A/B since r2) — there the scan runs the cold resident/union matcher
    # regardless of this flag (pipeline/icp._warm_applies), keeping the
    # production default equal to the measured winner in BOTH regimes.
    # A TPU-native capability with no reference analog (FLANN queries
    # are stateless, NearestNeighbor.h:160-186).
    # FLANN-parity APPROXIMATE matching (opt-in). The reference's FLANN
    # search is itself approximate — SearchParams(16) bounds the leaf
    # visits per query (NearestNeighbor.h:134, 172-174) — while this
    # framework's default matcher is exact within the threshold. checks>0
    # bounds each query's kd candidate budget to ~`matching_checks` target
    # POINTS (rounded up to whole kd blocks) and skips the exactness
    # certificate + fallback: a query whose true NN lies outside its
    # best-lower-bound blocks gets the best candidate found instead
    # (exactly FLANN's failure mode). 0 (default) = exact. Only the
    # kd-indexed matching path honors it; ICP is famously tolerant of
    # slightly-wrong NNs (see PARITY.md "Approximate matching arm").
    matching_checks: int = 0

    # kd index block size (points per block at full occupancy; 0 = the
    # module default, kdtree.BLOCK_TARGET). The block capacity is the
    # approximate arm's candidate-budget GRANULE (checks round up to
    # whole blocks, kdtree.checks_to_k), so smaller blocks cut the
    # per-query vector work of the k-capped kernels — at the price of a
    # denser prefix ranking (lb matrix width = block count) and more
    # member blocks per gate walk. Part of the executable's shape.
    kd_block_target: int = 0

    # Approximate-arm membership cache (checks > 0 + SELECT_ALL only):
    # each source row carries the kd BLOCK of its previous match through
    # the scan. In the segmented multires driver the cache seeds ACROSS
    # pyramid levels — but only levels whose parent lattice is pixel-
    # adjacent (icp.SEED_MAX_PARENT_STRIDE): far-parent seeds cross
    # color boundaries in the 6-dim tree and permanently starve the
    # restricted rows (a mid-r5 bug collapsed the match set 4x and cost
    # 13 mm; ROADMAP round-5 log). Seeded levels skip the per-query box
    # ranking; honest win +24% at equal-or-better accuracy. Within the
    # FLANN-class approximation contract: the k=1-budget arm already
    # accepts best-in-chosen-block results, and the cache self-refreshes
    # from each iteration's matches. No effect on the exact arm.
    kd_seed_membership: bool = True

    kd_warm_start: bool = True
    # Warm cache granularity: one slot per `granule` Morton-consecutive
    # source rows. Any granule-mate's match is a valid radius bound (it is
    # a real target point, merely a little farther), and with per-iteration
    # random re-selection a granule is re-seeded ~granule*p times per
    # iteration — per-ROW caches would almost always miss at p=0.01.
    kd_warm_granule: int = 128
    # Query-tile width of the warm bitmap-kernel search (None = the
    # module default, kdtree.TILE_Q_DEFAULT). Narrower tiles shrink each
    # tile's block membership (less VPU work per query) at more DMA
    # issues; part of the executable's shape, hence a config knob.
    kd_warm_tile_q: int | None = None

    # LM inner loop (Ceres solver options, ICPOptimizer.h:352-360).
    lm_max_inner_iterations: int = 10
    lm_function_tolerance: float = 1e-6

    # Anderson acceleration window (AA-ICP, arXiv:1709.05479): > 0 mixes
    # the last m fixed-point residuals into each pose update, converging
    # in fewer iterations with a plain-step safeguard fallback; 0 (the
    # default, reference parity) is the plain ICP iteration. Extension —
    # no reference analog (solvers/anderson.py).
    anderson_m: int = 0

    # Projective matching camera (NearestNeighborSearchProjective, set via
    # setCameraParamsMatchingMethod). Stored as plain floats to stay hashable.
    projective_width: int = 0
    projective_height: int = 0
    projective_fx: float = 0.0
    projective_fy: float = 0.0
    projective_cx: float = 0.0
    projective_cy: float = 0.0
    projective_window: int = 12  # searchWindow, NearestNeighbor.h:319
    # Queries per projective-matcher chunk (0 = the module default,
    # ops/projective.CHUNK). The chunk sizes the live candidate tensor
    # (chunk x 9 x 768 f32 per frame); batched multi-frame programs must
    # shrink it or the vmapped tensor outgrows HBM (8 frames at the
    # default = 7.2 GB, measured OOM in bench_tum_projective).
    projective_chunk: int = 0

    def with_camera(self, fx: float, fy: float, cx: float, cy: float, width: int, height: int) -> "ICPConfig":
        return replace(
            self,
            projective_fx=float(fx),
            projective_fy=float(fy),
            projective_cx=float(cx),
            projective_cy=float(cy),
            projective_width=int(width),
            projective_height=int(height),
        )

    def replace(self, **kw) -> "ICPConfig":
        return replace(self, **kw)

    def describe(self) -> str:
        """Config banner, mirroring printICPConfiguration (ICPOptimizer.h:97-138)."""
        lines = ["ICP configuration:"]
        if self.color_icp:
            lines.append("  Color-ICP enabled")
        if self.multi_resolution:
            lines.append("  Multi-Resolution ICP enabled")
        lines.append(f"  1. Selection: {self.selection.name.lower()}"
                     + (f" (p={self.selection_proba})" if self.selection == Selection.RANDOM else ""))
        match_desc = f"  2. Matching: {self.matching.name.lower()} (max sq distance {self.max_distance})"
        if self.matching_checks > 0:
            match_desc += (
                f" [APPROXIMATE: checks={self.matching_checks} candidate "
                "budget rounded UP to whole kd blocks (block-granularity "
                "floor, kdtree.checks_to_k), FLANN-SearchParams class]"
            )
        lines.append(match_desc)
        lines.append(f"  3. Weighting: {self.weighting.name.lower()}")
        rej = "angle of normals" if self.rejection else "keep all"
        if self.trim_ratio < 1.0:
            rej += f" + trimmed ICP (keep best {self.trim_ratio:.0%})"
        lines.append(f"  4. Rejection: {rej}")
        lines.append(f"  5. Metric: {self.metric.name.lower()}")
        lines.append(f"  6. Minimizer: {self.minimizer.name.lower()}, {self.n_iterations} iterations")
        if self.anderson_m > 0:
            lines.append(f"  Anderson acceleration: window m={self.anderson_m}")
        return "\n".join(lines)
