"""Split kd_radius_search's time at the dense exact path's shapes by cause.

    python3 -m icp_variants_tpu_torch.scripts.radius_split [--reps 10]

Run from the repository root, on the card. The inputs are made as
``chip_smoke.dense_phase`` makes them: 4 pairs of 1,000,000-point indoor
scans (``make_indoor_pairs``), caller-built kd indexes of 512 x 2,048, the
sources at the identity pose, and the warm radii of the second iteration
(one ``match_kd_warm`` call from an empty granule cache, then
``warm_radius`` from the updated cache), with box_topk's k = 4 picks at
those radii.

One production call is split by ``__global__`` (``torch.profiler``):
bucketing = bin + scan + scatter of both rounds, each round's walk, and the
output. The ``-DRS_PROBE`` build's round-0 walk stages every chunk's block
and takes no distance, so round 0's walk splits into staging and distance;
its result must be (radius, -1). Prints one JSON line with the production
call's CUDA-event ms (``chip_smoke.time_ms``, median of ``--reps``), its
bound at these inputs (``chip_smoke.needed_work``: the real points of the
picked blocks whose bound is within each row's answer) and the split.
"""

from __future__ import annotations

import argparse
import collections
import json

import torch


def dense_inputs(cs):
    """The dense path's second-iteration inputs (see the module doc)."""
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.ops import kdtree, knn
    from icp_variants_tpu_torch.pipeline import icp
    from icp_variants_tpu_torch.pipeline.config import ICPConfig

    dev = torch.device("cuda")
    pairs = cs.make_indoor_pairs(cs.DENSE_PAIRS, cs.DENSE_POINTS)
    sources = icp.stack_clouds([
        cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
        for sp, sn, _, _ in pairs])
    targets_host = [cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
                    for _, _, tp, tn in pairs]
    targets = icp.stack_clouds(targets_host).to(dev)
    kd = kdtree.stack_kd_indexes([
        kdtree.build_kd_index(t.points, t.valid, device=dev) for t in targets_host])
    fidx = knn.build_target_index(targets.points, tile_t=knn.V2_TILE_T)
    b, cap = sources.valid.shape
    q = cs.dense_queries(sources, torch.eye(4, device=dev).expand(b, 4, 4))
    granule = ICPConfig().kd_warm_granule
    gran = torch.arange(cap, device=dev) // granule
    cache = torch.full((b, int(gran[-1]) + 1), -1, dtype=torch.int32, device=dev)
    idx, _, valid = kdtree.match_kd_warm(q, kd, cs.MAX_DISTANCE, cache[:, gran], targets.points,
                                         sources.valid, fallback_index=fidx)
    cache = icp._granule_update(cache, idx, valid, granule)
    radius = kdtree.warm_radius(q, cache[:, gran], targets.points, cs.MAX_DISTANCE,
                                sources.valid)[0]
    bv = knn.bound_value(cs.MAX_DISTANCE)
    binit = torch.clamp(radius, max=bv).contiguous()
    sel, _ = kdtree.box_topk(q, binit, kd.block_min, kd.block_max, 4)
    return dict(q=q, binit=binit, sel=sel, kd=kd)


def kernel_times(fn) -> list[tuple[str, float]]:
    """(name, device ms) of each kernel launch of one ``fn()`` call, in order."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in evs]


def radius_split(launches, probe_launches) -> dict:
    """kd_radius_search's production call by cause, from its kernel launches
    and the probe build's."""
    by = collections.Counter()
    walks = []
    for name, ms in launches:
        for part in ("bin", "scan", "scatter", "out"):
            if f"kd_radius_search_{part}" in name:
                by["bucketing" if part != "out" else "output"] += ms
        if "kd_radius_search_walk" in name:
            walks.append(ms)
        if "emset" in name:
            by["memset"] += ms
    probe_walks = [ms for name, ms in probe_launches if "kd_radius_search_walk" in name]
    split = dict(by, walk_round0=walks[0], walk_round1=sum(walks[1:]),
                 staging_round0=probe_walks[0],
                 distance_round0=walks[0] - probe_walks[0], launches=len(launches))
    split["total"] = sum(ms for _, ms in launches)
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import chip_smoke as cs
    from icp_variants_tpu_torch.ops import _cuda, knn

    if not torch.cuda.is_available():
        raise SystemExit("radius_split: needs a CUDA card")
    _cuda.build_all()
    _cuda.variant("kd_radius_search.cu", ("RS_PROBE",))
    dense = dense_inputs(cs)
    kd = dense["kd"]
    args_rs = (dense["q"], dense["binit"], kd.block_min, kd.block_max, kd.pages, dense["sel"])
    probe = knn._kd_radius_search_launch(*args_rs, defines=("RS_PROBE",))
    if not (torch.equal(probe[0], dense["binit"]) and bool((probe[1] == -1).all())):
        raise SystemExit("kd_radius_search probe: not (radius, -1)")
    rows = int(dense["q"].shape[0] * dense["q"].shape[1])
    d2 = knn.kd_radius_search(*args_rs)[0]
    nbytes, nops, need_pts, _ = cs.needed_work(kd, dense["q"], dense["sel"], d2)
    bound_ms, bound_by = cs.bound(nbytes, nops)
    split = radius_split(
        kernel_times(lambda: knn.kd_radius_search(*args_rs)),
        kernel_times(lambda: knn._kd_radius_search_launch(*args_rs, defines=("RS_PROBE",))))
    print(json.dumps({"input": f"kd_radius_search dense, {rows} rows, k = 4, second-iteration "
                               "radii", "ms": cs.time_ms(lambda: knn.kd_radius_search(*args_rs),
                                                         args.reps),
                      "bound_ms": bound_ms, "bound_by": bound_by, "needed_points": need_pts,
                      "split_ms": split}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
