"""The span recorder (``runtime/spans.py``), the ICP loop's spans and the kd
matchers' work counters, on the CPU at test size, and the counters of the
CUDA kernels against the plain versions on the card.

Two configurations: the ETH headline path (symmetric linear ICP, compacted
random selection, exact kd matching with the certificate and the
visited-list fallback) on two pairs of 6,000-point sheets, and the dense
colour-multires tracker (segmented pyramid, exact arm, warm start) on two
80 x 60 RGB-D frames against a keyframe. Recording changes no result:
poses, traces and launches are compared for equality."""

import numpy as np
import pytest
import torch

from icp_variants_tpu_torch.core import cloud as tcloud
from icp_variants_tpu_torch.data import rgbd as trgbd
from icp_variants_tpu_torch.ops import _cuda
from icp_variants_tpu_torch.ops import kdtree as tkd
from icp_variants_tpu_torch.ops import knn as tknn
from icp_variants_tpu_torch.pipeline import config as tconfig
from icp_variants_tpu_torch.pipeline import icp as ticp
from icp_variants_tpu_torch.pipeline import profiling as tprof
from icp_variants_tpu_torch.runtime import spans

torch.set_num_threads(2)

STAGES = ("icp.selection", "icp.matching", "icp.weighting", "icp.rejection", "icp.solve",
          "icp.measure")
N_ITER = 6


def _sheet(n, seed):
    """A wavy 20 m x 20 m sheet with bumps and its normals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10.0, 10.0, (n, 2))
    z = 0.6 * np.sin(0.5 * xy[:, 0]) * np.cos(0.4 * xy[:, 1])
    dzx = 0.3 * np.cos(0.5 * xy[:, 0]) * np.cos(0.4 * xy[:, 1])
    dzy = -0.24 * np.sin(0.5 * xy[:, 0]) * np.sin(0.4 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    nrm = np.column_stack([-dzx, -dzy, np.ones(n)])
    return pts, (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def eth():
    cfg = tconfig.ICPConfig(metric=tconfig.Metric.SYMMETRIC, minimizer=tconfig.Minimizer.LINEAR,
                            selection=tconfig.Selection.RANDOM, selection_proba=0.05,
                            max_distance=10.0, n_iterations=N_ITER, kd_block_target=256)
    srcs, tgts = [], []
    for i in range(2):
        tp, tn = _sheet(6000, 2 * i)
        a = 0.05 + 0.03 * i
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     np.float32)
        sp, sn = tp @ R.T + np.float32([0.3, -0.2, 0.1]), tn @ R.T
        srcs.append(tcloud.from_numpy(sp, normals=sn, morton_order=True, device="cpu"))
        tgts.append(tcloud.from_numpy(tp, normals=tn, morton_order=True, device="cpu"))
    kds = tkd.stack_kd_indexes([ticp.build_kd_for(cfg, t, min_points=0, device="cpu")
                                for t in tgts])
    return dict(cfg=cfg, sources=ticp.stack_clouds(srcs), targets=ticp.stack_clouds(tgts),
                kd_indexes=kds)


W, H = 80, 60
K = np.array([[525.0 * W / 640, 0, (W - 1) / 2], [0, 525.0 * W / 640, (H - 1) / 2], [0, 0, 1]],
             np.float32)


def _frame(i):
    """A wavy surface with a raised box and smooth colours, seen from a
    camera at x = -0.01 i."""
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xw = (uu - K[0, 2]) / K[0, 0] * 2.0 - 0.01 * i
    yw = (vv - K[1, 2]) / K[1, 1] * 2.0
    z = 2.0 + 0.12 * np.sin(3.0 * xw) * np.cos(3.0 * yw)
    z = np.where((np.abs(xw + 0.3) < 0.3) & (np.abs(yw) < 0.25), z - 0.4, z).astype(np.float32)
    color = np.stack([(127 + 120 * np.sin(5.0 * xw)), (127 + 120 * np.cos(4.0 * yw)),
                      (127 + 120 * np.sin(3.0 * (xw + yw))), np.full((H, W), 255.0)],
                     axis=-1).astype(np.uint8)
    return z, color


@pytest.fixture(scope="module")
def colour():
    cfg = tconfig.ICPConfig(metric=tconfig.Metric.POINT_TO_PLANE,
                            minimizer=tconfig.Minimizer.LINEAR, n_iterations=8, max_distance=0.1,
                            color_icp=True, multi_resolution=True, kd_block_target=256)
    eye = np.eye(4, dtype=np.float32)
    srcs = [trgbd.cloud_from_depth(*_frame(i), K, eye, keep_original_size=True, capacity=W * H,
                                   color_morton_order=True, device="cpu") for i in (1, 2)]
    tgt = trgbd.cloud_from_depth(*_frame(0), K, eye, keep_original_size=False, capacity=W * H,
                                device="cpu")
    kd = ticp.build_kd_for(cfg, tgt, min_points=0, device="cpu")
    return dict(cfg=cfg, sources=ticp.stack_clouds(srcs), targets=ticp.stack_clouds([tgt] * 2),
                kd_indexes=tkd.stack_kd_indexes([kd] * 2), num_source_points=W * H)


def _run_eth(eth, **kw):
    return ticp.run_icp_batch(eth["cfg"], eth["sources"], eth["targets"], seed=3,
                              kd_indexes=eth["kd_indexes"], device="cpu", **kw)


def _run_colour(colour, monkeypatch):
    """The segmented pyramid, every level its own segment."""
    monkeypatch.setattr(ticp, "SEGMENT_PROGRAM_OVERHEAD_MS", 0.0)
    return ticp.run_icp_batch_multires_segmented(
        colour["cfg"], colour["sources"], colour["targets"], seed=3,
        num_source_points=colour["num_source_points"], kd_indexes=colour["kd_indexes"],
        device="cpu")


def _names(rec):
    return [s.name for s in rec.spans]


def _complete(rec):
    assert not rec._stack
    assert all(s is not None and s.t0_ns <= s.t1_ns for s in rec.spans)


def test_off_records_nothing(eth):
    """No recording and no profiler: the shared null context, no counter
    slots, and nothing lands in PROFILED."""
    assert spans.span("icp.solve") is spans.span("icp.matching") is spans.call()
    assert spans.counters("kd_block_search", "cpu") is None
    before = len(spans.PROFILED.spans)
    _run_eth(eth)
    assert spans._rec is None and len(spans.PROFILED.spans) == before


def test_nesting_parent_and_call():
    with spans.recording() as rec:
        with spans.call():
            with spans.span("a"):
                with spans.span("b"):
                    pass
            with spans.call():          # a nested entry call opens no second icp.call
                with spans.span("c"):
                    pass
        with spans.call():
            pass
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    _complete(rec)
    assert _names(rec) == ["icp.call", "a", "b", "c", "icp.call"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 0, -1]
    assert [s.call for s in rec.spans] == [1, 1, 1, 1, 2]
    a, b = rec.spans[1], rec.spans[2]
    assert a.t0_ns <= b.t0_ns <= b.t1_ns <= a.t1_ns
    assert rec.counters == dict.fromkeys(spans.COUNTERS, 0)
    assert spans._rec is None


def _same(r0, r1):
    assert torch.equal(r0.pose, r1.pose)
    for a, b in zip(r0.trace, r1.trace):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["eth", "colour"])
def test_recording_changes_no_result(eth, colour, monkeypatch, which):
    """Poses, traces and the port's C-entry launches are bit-identical with
    recording on and off."""
    run = ((lambda: _run_eth(eth)) if which == "eth"
           else (lambda: _run_colour(colour, monkeypatch)))
    _cuda.reset_launches()
    off = run()
    launches_off = dict(_cuda.LAUNCHES)
    with spans.recording() as rec:
        on = run()
    launches_on = {k: v - launches_off.get(k, 0) for k, v in _cuda.LAUNCHES.items()}
    _same(off, on)
    assert launches_on == launches_off
    _complete(rec)
    assert _names(rec).count("icp.call") == 1 and rec.spans[0].name == "icp.call"
    assert rec.counters["kd_rows"] > 0 and rec.counters["kd_entries"] >= rec.counters["kd_rows"]


def test_stage_spans_in_order(eth):
    """Each iteration emits the stage spans in order, once per iteration,
    under icp.call after icp.prepare; icp.reduce nests in icp.solve."""
    with spans.recording() as rec:
        _run_eth(eth)
    _complete(rec)
    top = [s.name for s in rec.spans if s.parent == 0]
    assert top == ["icp.prepare"] + list(STAGES) * N_ITER
    reduce = [s for s in rec.spans if s.name == "icp.reduce"]
    assert len(reduce) == N_ITER
    assert all(rec.spans[s.parent].name == "icp.solve" for s in reduce)
    for s in rec.spans[1:]:
        p = rec.spans[s.parent]
        assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns


def test_segmented_pyramid_spans(colour, monkeypatch):
    """The segmented pyramid: one icp.call; each level's slice under
    icp.level, its inner call's set-up and stages nested in the same call."""
    with spans.recording() as rec:
        _run_colour(colour, monkeypatch)
    _complete(rec)
    names = _names(rec)
    assert names.count("icp.call") == 1
    levels = names.count("icp.level")
    assert levels >= 2 and names.count("icp.prepare") == levels + 1
    assert names.count("icp.matching") == colour["cfg"].n_iterations
    assert {s.call for s in rec.spans} == {1}
    assert all(rec.spans[s.parent].name == "icp.call"
               for s in rec.spans if s.name in ("icp.level", "icp.prepare") + STAGES)


@pytest.mark.parametrize("stage", ticp.PROBE_STAGES)
def test_probe_leaves_no_span_open(eth, stage):
    """A stop_after probe's early return closes its spans: the iteration's
    stages up to the probed one, then none."""
    with spans.recording() as rec:
        _run_eth(eth, stop_after=stage)
    _complete(rec)
    top = [s.name for s in rec.spans if s.parent == 0]
    upto = {"floor": 0, "selection": 1, "matching": 2, "weighting": 3, "rejection": 4,
            "solve": 5}[stage]
    assert top == ["icp.prepare"] + list(STAGES[:upto]) * N_ITER


def test_shared_clock_and_profiled_spans(eth):
    """Under a CPU-activity torch profiler the aten ops of a recorded run
    fall inside the matching span's [t0, t1] on the profiler's clock; with
    no recording open, a profiled call records into PROFILED."""
    from torch.profiler import ProfilerActivity, profile

    with spans.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_eth(eth)
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::linalg_solve_ex"]
    solves = [s for s in rec.spans if s.name == "icp.solve"]
    assert len(ops) == len(solves) == N_ITER
    for op, s in zip(sorted(ops, key=lambda e: e.start_ns()), solves):
        assert s.t0_ns <= op.start_ns() <= op.start_ns() + op.duration_ns() <= s.t1_ns
    call = rec.spans[0]
    first = min(e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("aten::"))
    assert call.t0_ns <= first

    spans.PROFILED.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _run_eth(eth)
    assert _names(spans.PROFILED)[:2] == ["icp.call", "icp.prepare"]
    assert spans.PROFILED.read_counters()["kd_rows"] > 0
    assert spans._rec is None
    spans.PROFILED.clear()


def _hand_kd_counts(sel, nc, chunk):
    rows = entries = 0
    buckets = {}
    for b in range(sel.shape[0]):
        for r in range(sel.shape[1]):
            seen = []
            for v in sel[b, r].tolist():
                if v < 0:
                    continue
                c = min(v, nc - 1)
                if c not in seen:
                    seen.append(c)
                    buckets[(b, c)] = buckets.get((b, c), 0) + 1
            rows += bool(seen)
            entries += len(seen)
    return [rows, entries, sum(-(-n // chunk) for n in buckets.values())]


@pytest.mark.parametrize("d", [3, 6])
def test_kd_plain_counters_match_hand_counts(d):
    """kd_block_search_plain adds rows with a pick, distinct picks
    and per-(pair, block) chunks, counted here by hand; probes count too."""
    g = torch.Generator().manual_seed(d)
    b, n, k, nc, cap = 2, 300, 4, 9, 8
    sel = torch.randint(-3, nc, (b, n, k), generator=g, dtype=torch.int32)
    sel[0, :5] = -1
    sel[1, :200, :] = 4                   # one bucket past a chunk at D = 3
    q = torch.rand((b, n, d), generator=g)
    pages = torch.rand((b, nc, 8, cap), generator=g)
    binit = torch.full((b, n), 1e9)
    want = _hand_kd_counts(sel, nc, tkd.KDB_CHUNK[d])
    with spans.recording() as rec:
        tkd.kd_block_search(q, sel, binit, pages)
        tkd.kd_block_search(q, sel, binit, pages, probe=1)
    assert [rec.counters[c] for c in ("kd_rows", "kd_entries", "kd_chunks")] == [
        2 * x for x in want]
    assert rec.counters["fallback_rows"] == 0


def test_icp_counters_match_sel_and_certificate(eth, monkeypatch):
    """Over a recorded ETH run, kd_rows / kd_entries / kd_chunks equal the
    counts taken by hand from every box_topk pick list, and fallback_rows
    the rows whose certificate failed."""
    picks, fails = [], []
    box_topk, cert = tkd.box_topk, tkd._certificate_fail

    def keep_sel(*a, **kw):
        sel, resid = box_topk(*a, **kw)
        picks.append(sel.clone())
        return sel, resid

    def keep_fail(*a, **kw):
        f = cert(*a, **kw)
        fails.append(f.clone())
        return f

    monkeypatch.setattr(tkd, "box_topk", keep_sel)
    monkeypatch.setattr(tkd, "_certificate_fail", keep_fail)
    with spans.recording() as rec:
        _run_eth(eth)
    nc = eth["kd_indexes"].pages.shape[1]
    want = np.sum([_hand_kd_counts(s, nc, tkd.KDB_CHUNK[3]) for s in picks], axis=0)
    assert len(picks) == N_ITER and len(fails) >= N_ITER
    assert [rec.counters[c] for c in ("kd_rows", "kd_entries", "kd_chunks")] == want.tolist()
    assert rec.counters["fallback_rows"] == sum(int(f.sum()) for f in fails)


def test_visited_plain_counts_live_rows():
    g = torch.Generator().manual_seed(5)
    t = torch.rand((2, 500, 3), generator=g)
    index = tknn.build_target_index(t, tile_t=64)
    q = torch.rand((2, 40, 3), generator=g)
    radius = torch.where(torch.rand((2, 40), generator=g) < 0.3, 0.5, -1.0)
    with spans.recording() as rec:
        tknn.visited_search(q, radius, index)
    assert rec.counters["fallback_rows"] == int((radius >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# On the card: the kernels' counters and answers with the pointer null and set
# ---------------------------------------------------------------------------


def _card_inputs(d):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(40 + d)
    b, n, k, nc, cap = 2, 5000, 4, 64, 256
    sel = torch.randint(-2, nc, (b, n, k), generator=g, dtype=torch.int32)
    sel[1, :1500] = 7
    q = torch.rand((b, n, d), generator=g)
    pages = torch.rand((b, nc, 8, cap), generator=g)
    binit = torch.where(torch.rand((b, n), generator=g) < 0.5, 0.05, 1e9).float()
    t = torch.rand((b, 4000, d), generator=g)
    radius = torch.where(torch.rand((b, n), generator=g) < 0.1, 0.02, -1.0)
    return [x.to(dev) for x in (q, sel, binit, pages, t, radius)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_kernel_counters_match_plain_on_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, sel, binit, pages, t, radius = _card_inputs(d)
    index = tknn.build_target_index(t, tile_t=tknn.V2_TILE_T)
    with spans.recording() as card:
        tkd.kd_block_search(q, sel, binit, pages)
        tkd.kd_block_search(q, sel, binit, pages, probe=1)
        tknn.visited_search(q, radius, index)
    with spans.recording() as plain:
        tkd.kd_block_search(q.cpu(), sel.cpu(), binit.cpu(), pages.cpu())
        tkd.kd_block_search(q.cpu(), sel.cpu(), binit.cpu(), pages.cpu(), probe=1)
        tknn.visited_search(q.cpu(), radius.cpu(), tknn.TargetIndex(*(
            x.cpu() if isinstance(x, torch.Tensor) else x for x in index)))
    assert card.counters == plain.counters
    assert card.counters["kd_chunks"] > 0 and card.counters["fallback_rows"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 6])
def test_kernel_answers_with_and_without_counters_on_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, sel, binit, pages, t, radius = _card_inputs(d)
    index = tknn.build_target_index(t, tile_t=tknn.V2_TILE_T)
    off = tkd.kd_block_search(q, sel, binit, pages) + tknn.visited_search(q, radius, index)
    with spans.recording():
        on = tkd.kd_block_search(q, sel, binit, pages) + tknn.visited_search(q, radius, index)
    torch.cuda.synchronize()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_trace_exporter_writes_spans(eth, tmp_path):
    """profiling.trace records the spans and writes them beside the
    profiler's events, on its time base."""
    import json

    with tprof.trace(str(tmp_path / "t")):
        _run_eth(eth)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "icp_span"]
    assert [e["name"] for e in mine].count("icp.solve") == N_ITER
    assert mine[0]["name"] == "icp.call" and {e["args"]["call"] for e in mine} == {1}
    aten = [e for e in events if e.get("name") == "aten::linalg_solve_ex"]
    solve = [e for e in mine if e["name"] == "icp.solve"]
    for op, s in zip(sorted(aten, key=lambda e: e["ts"]), sorted(solve, key=lambda e: e["ts"])):
        assert s["ts"] <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + s["dur"] + 1.0
        assert s["tid"] == op["tid"]
