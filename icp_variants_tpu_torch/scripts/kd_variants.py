"""Time variants of the block-major kd search against this checkout's build.

    python3 -m icp_variants_tpu_torch.scripts.kd_variants unroll=1 d3=128x1 d6=256x2 ...

Run from the repository root, on the card. Each variant is a copy of
``csrc/`` with one edit to ``block_major.cuh`` (the machinery that
``kd_block_search.cu`` and ``cached_block_search.cu`` share):

* ``unroll=N``: the walk's slot loop unrolled N deep (its ``#pragma unroll``);
* ``d3=CxQ`` / ``d6=CxQ``: the kd search's launch shape ``KdbShape<3, false>``
  / ``KdbShape<6, false>``, C entries of a bucket per CTA and Q queries per
  thread (C <= 256 Q); ``s3=CxQ`` / ``s6=CxQ``: the seeded search's
  (``KdbShape<D, true>``).

Every variant's two sources are built (one ``nvcc`` each, all at once,
``_cuda``'s flags) into ``build/kd_variants/<name>/`` and launched through
their own libraries with the production C entries. The inputs are the main
paths' shapes, made as ``chip_smoke.py`` makes them: ETH (D = 3; 16 pairs
of 365,000 points, 4,352 queries a pair taken at a stride from the
sources, k = 4), colour (D = 6; 8 frames x 307,200 fine-level rows at the
identity pose, the exact arm's kd index, k = 4), both through
kd_block_search from the bound, and colour seeded (the same rows on the
checks16 arm's 256-block index, each seeded with its top-1 block, through
cached_block_search: k = 1 from the common bound). Per input, each build's
result must equal the production build's; then all builds are timed in
``--rounds`` rounds of alternating order (``chip_smoke.time_ms``, CUDA
events, median of ``--reps``). Prints each walk's ptxas register line and
one JSON line per input: the ms of every round per build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from icp_variants_tpu_torch.ops import _cuda, kdtree, knn

_SLOT_LOOP = re.compile(r"#pragma unroll \d+(\n\s*for \(int s4 )")


def _edit(src: str, spec: str) -> str:
    """``block_major.cuh``'s text with the edit ``spec`` applied."""
    key, val = spec.split("=")
    if key == "unroll":
        out, n = _SLOT_LOOP.subn(rf"#pragma unroll {int(val)}\1", src)
    elif key in ("d3", "d6", "s3", "s6"):
        chunk, q = (int(v) for v in val.split("x"))
        d, seeded = key[1], "true" if key[0] == "s" else "false"
        out, n = re.subn(
            rf"(struct KdbShape<{d}, {seeded}> \{{ static constexpr int chunk = )\d+"
            rf"(, queries = )\d+", rf"\g<1>{chunk}\g<2>{q}", src)
    else:
        raise ValueError(f"unknown variant {spec!r}")
    if n != 1:
        raise ValueError(f"variant {spec!r}: its line is not in block_major.cuh")
    return out


_ENTRIES = {"kd": "kd_block_search", "cached": "cached_block_search"}


def _build(specs: list[str]) -> dict:
    """Build every variant; returns name -> {"kd": C entry, "cached": C
    entry}, typed as ``_cuda.KERNELS`` types them."""
    root = _cuda.BUILD_DIR.parent / "kd_variants"
    src = (_cuda.CSRC / "block_major.cuh").read_text()
    procs = {}
    for spec in specs:
        d = root / spec.replace("=", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, d / "csrc")
        (d / "csrc" / "block_major.cuh").write_text(_edit(src, spec))
        for key, name in _ENTRIES.items():
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(d / "csrc"), "-o",
                   str(d / f"{key}.so"), str(d / "csrc" / _cuda.KERNELS[name][0])]
            procs[spec, key] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    fns = {spec: {} for spec in specs}
    for (spec, key), (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{spec} {key}: nvcc rc {proc.returncode}\n{log}")
        _print_walks(spec, log)
        _, fn_name, argtypes = _cuda.KERNELS[_ENTRIES[key]]
        fn = getattr(ctypes.CDLL(str(d / f"{key}.so")), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[spec][key] = fn
    return fns


def _print_walks(name: str, log: str) -> None:
    """The ptxas register lines of the walks (not the probe's)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(
            r"entry function .*(kd|cached)_block_search_walkILi(\d)ELb0ELb\dELb(\d)E", line)
        if m:
            regs = next((x.strip() for x in lines[i + 1:i + 4] if "registers" in x), "")
            pose = ", pose" if m.group(3) == "1" else ""
            print(f"  {name} {m.group(1)} walk<{m.group(2)}{pose}>: {regs}", flush=True)


def _launch(fn, q, sel, binit, pages):
    """One launch of a variant's kd_block_search entry; returns (d2, idx)."""
    b, n, d = q.shape
    k, nc, cap_pad = sel.shape[-1], pages.shape[1], pages.shape[-1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws_bytes = kdtree._block_search_workspace_bytes(b, n, nc, k)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    err = fn(q.data_ptr(), sel.data_ptr(), binit.data_ptr(), pages.data_ptr(), d2.data_ptr(),
             idx.data_ptr(), ws.data_ptr(), ws_bytes, b, n, nc, cap_pad, k, 0, None, d,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kd_block_search variant failed to launch ({err})")
    return d2, idx


def _launch_cached(fn, q, blk, bound, pages):
    """One launch of a variant's cached_block_search entry (no pose);
    returns (idx, d2), as ``kdtree.nn_search_kd_cached`` does."""
    b, n, d = q.shape
    nc, cap_pad = pages.shape[1], pages.shape[-1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws_bytes = kdtree._block_search_workspace_bytes(b, n, nc, 1)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    err = fn(q.data_ptr(), blk.data_ptr(), None, bound, pages.data_ptr(), d2.data_ptr(),
             idx.data_ptr(), ws.data_ptr(), ws_bytes, b, n, nc, cap_pad, d,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cached_block_search variant failed to launch ({err})")
    return idx, d2


def _eth_inputs(cs, dev):
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.pipeline import icp

    pairs = cs.make_pairs(cs.BATCH_PAIRS, cs.N_POINTS)
    src = icp.stack_clouds([cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
                            for sp, sn, _, _ in pairs])
    targets = [cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
               for _, _, tp, tn in pairs]
    kd = kdtree.stack_kd_indexes([
        kdtree.build_kd_index(t.points, t.valid, device=dev) for t in targets])
    cap = src.points.shape[1]
    q = src.points[:, ::cap // 4352][:, :4352].contiguous()
    return q, kd, knn.bound_value(cs.MAX_DISTANCE)


def _colour_inputs(cs, dev, checks=0):
    from icp_variants_tpu_torch.pipeline import icp

    tgt, sources = cs.prepare_tum_state(dev)
    cfg = cs.tum_base_config(color_icp=True, multi_resolution=True, matching_checks=checks)
    kd = kdtree.stack_kd_indexes([icp.build_kd_for(cfg, tgt, device=dev)] * cs.TUM_BATCH_FRAMES)
    fine = icp._slice_clouds_stride(sources, 1)
    first = torch.argmax(fine.valid.to(torch.uint8), dim=-1)
    pts = torch.where(fine.valid[..., None], fine.points,
                      knn.take_rows(fine.points, first[:, None]))
    q = knn.color_features(pts, fine.colors).contiguous()
    return q, kd, knn.bound_value(cs.TUM_MAX_DISTANCE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    dev = torch.device("cuda")
    _cuda.build_all()
    for name in _ENTRIES.values():
        _print_walks("production", _cuda.BUILD_LOG.get(_cuda.KERNELS[name][0], ""))
    fns = _build(args.variants)
    ok = True
    inputs = (("eth", _eth_inputs, 4), ("colour", _colour_inputs, 4),
              ("colour seeded", lambda cs, dev: _colour_inputs(cs, dev, cs.CHECKS_APPROX), 1))
    for label, make, k in inputs:
        q, kd, bv = make(cs, dev)
        binit = torch.full(q.shape[:2], bv, device=dev)
        sel, _ = kdtree.box_topk(q, binit, kd.block_min, kd.block_max, k)
        if k == 1:
            blk = sel[..., 0].contiguous()
            maxd = cs.TUM_MAX_DISTANCE
            calls = {"production": lambda: kdtree.nn_search_kd_cached(q, kd, maxd, blk)}
            for spec, fn in fns.items():
                calls[spec] = lambda fn=fn["cached"]: _launch_cached(fn, q, blk, bv, kd.pages)
        else:
            calls = {"production": lambda: kdtree.kd_block_search(q, sel, binit, kd.pages)}
            for spec, fn in fns.items():
                calls[spec] = lambda fn=fn["kd"]: _launch(fn, q, sel, binit, kd.pages)
        want = calls["production"]()
        equal = {}
        for name, call in calls.items():
            got = call()
            equal[name] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        ok &= all(equal.values())
        ms = {name: [] for name in calls}
        names = list(calls)
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                ms[name].append(cs.time_ms(calls[name], args.reps))
        print(json.dumps({"input": label, "shape": list(q.shape), "k": k, "equal": equal,
                          "ms": ms}), flush=True)
        del q, kd, sel, binit, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
