"""Time variants of kd_block_search's walk against this checkout's build.

    python3 -m icp_variants_tpu_torch.scripts.kd_variants unroll=1 d3=128x1 d6=256x2 ...

Run from the repository root, on the card. Each variant is a copy of
``csrc/`` with one edit to ``kd_block_search.cu``:

* ``unroll=N``: the walk's slot loop unrolled N deep (its ``#pragma unroll``);
* ``d3=CxQ`` / ``d6=CxQ``: the launch shape ``KdbShape<3>`` / ``KdbShape<6>``,
  C entries of a bucket per CTA and Q queries per thread (C <= 256 Q).

Every variant is built (one ``nvcc`` each, all at once, ``_cuda``'s flags)
into ``build/kd_variants/<name>/`` and launched through its own library with
the production C entry. The inputs are the main paths' shapes, made as
``chip_smoke.py`` makes them: ETH (D = 3; 16 pairs of 365,000 points, 4,352
queries a pair taken at a stride from the sources, k = 4) and colour (D = 6;
8 frames x 307,200 fine-level rows at the identity pose, the exact arm's kd
index, k = 4), every row from the bound. Per input, each build's result must
equal the production build's; then all builds are timed in ``--rounds``
rounds of alternating order (``chip_smoke.time_ms``, CUDA events, median of
``--reps``). Prints each walk's ptxas register line and one JSON line per
input: the ms of every round per build.
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
    """``kd_block_search.cu``'s text with the edit ``spec`` applied."""
    key, val = spec.split("=")
    if key == "unroll":
        out, n = _SLOT_LOOP.subn(rf"#pragma unroll {int(val)}\1", src)
    elif key in ("d3", "d6"):
        chunk, q = (int(v) for v in val.split("x"))
        d = key[1]
        out, n = re.subn(
            rf"(struct KdbShape<{d}> \{{ static constexpr int chunk = )\d+(, queries = )\d+",
            rf"\g<1>{chunk}\g<2>{q}", src)
    else:
        raise ValueError(f"unknown variant {spec!r}")
    if n != 1:
        raise ValueError(f"variant {spec!r}: its line is not in kd_block_search.cu")
    return out


def _build(specs: list[str]) -> dict:
    """Build every variant; returns name -> typed C entry."""
    root = _cuda.BUILD_DIR.parent / "kd_variants"
    src = (_cuda.CSRC / "kd_block_search.cu").read_text()
    procs = {}
    for spec in specs:
        d = root / spec.replace("=", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, d / "csrc")
        (d / "csrc" / "kd_block_search.cu").write_text(_edit(src, spec))
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(d / "csrc"), "-o", str(d / "kdb.so"),
               str(d / "csrc" / "kd_block_search.cu")]
        procs[spec] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for spec, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{spec}: nvcc rc {proc.returncode}\n{log}")
        _print_walks(spec, log)
        fn = ctypes.CDLL(str(d / "kdb.so")).kd_block_search_launch
        fn.argtypes, fn.restype = _cuda.KERNELS["kd_block_search"][2], ctypes.c_int
        fns[spec] = fn
    return fns


def _print_walks(name: str, log: str) -> None:
    """The ptxas register lines of the walks (not the probe's)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"entry function .*kd_block_search_walkILi(\d)ELb0E", line)
        if m:
            regs = next((x.strip() for x in lines[i + 1:i + 4] if "registers" in x), "")
            print(f"  {name} walk<{m.group(1)}>: {regs}", flush=True)


def _launch(fn, q, sel, binit, pages):
    """One launch of a variant's C entry; returns (d2, idx)."""
    b, n, d = q.shape
    k, nc, cap_pad = sel.shape[-1], pages.shape[1], pages.shape[-1]
    d2 = torch.empty((b, n), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=q.device)
    ws_bytes = kdtree._block_search_workspace_bytes(b, n, nc, k)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    err = fn(q.data_ptr(), sel.data_ptr(), binit.data_ptr(), pages.data_ptr(), d2.data_ptr(),
             idx.data_ptr(), ws.data_ptr(), ws_bytes, b, n, nc, cap_pad, k, 0, d,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kd_block_search variant failed to launch ({err})")
    return d2, idx


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


def _colour_inputs(cs, dev):
    from icp_variants_tpu_torch.pipeline import icp

    tgt, sources = cs.prepare_tum_state(dev)
    cfg = cs.tum_base_config(color_icp=True, multi_resolution=True, matching_checks=0)
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
    _print_walks("production", _cuda.BUILD_LOG.get("kd_block_search.cu", ""))
    fns = _build(args.variants)
    ok = True
    for label, make in (("eth", _eth_inputs), ("colour", _colour_inputs)):
        q, kd, bv = make(cs, dev)
        binit = torch.full(q.shape[:2], bv, device=dev)
        sel, _ = kdtree.box_topk(q, binit, kd.block_min, kd.block_max, 4)
        calls = {"production": lambda: kdtree.kd_block_search(q, sel, binit, kd.pages)}
        for spec, fn in fns.items():
            calls[spec] = lambda fn=fn: _launch(fn, q, sel, binit, kd.pages)
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
        print(json.dumps({"input": label, "shape": list(q.shape), "equal": equal, "ms": ms}),
              flush=True)
        del q, kd, sel, binit, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
