"""Find the torch ops whose result on a pair depends on the batch's size.

    python3 -m icp_variants_tpu_torch.scripts.batch_parting [--pairs 16] [--half 8]

On the card, from the repository's root. It runs the ETH headline's
exact arm (``chip_smoke.make_pairs``' 16 pairs of 365,000 points, their kd
indexes, seed 2's draws fed through ``selected=``) over the whole batch
and over its first ``--half`` pairs alone: the whole run (50 iterations)
to print whether the first pairs' poses and match counts part, then one
iteration of each under a ``TorchFunctionMode`` that records every torch
op's tensor inputs before it and its outputs after it. The two op
sequences are aligned by name; the ops whose inputs agree on the first
pairs and whose outputs do not are the ones that take another reduction
order at another batch size (``data_ptr`` reads aside, which differ by
nature).

This is how the sharded driver's ``pairs`` axis parts from the unsharded
run: a rank holding 8 of 16 pairs runs every op at B = 8.
"""

from __future__ import annotations

import argparse
import contextlib
import difflib
import sys

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

# Tensors larger than this (elements) are not copied by the recorder.
SNAPSHOT_LIMIT = 20_000_000


def _snap(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone() if x.numel() <= SNAPSHOT_LIMIT else ("big", tuple(x.shape))
    return x


class Recorder(TorchFunctionMode):
    """Every torch op called under it: ``(name, tensor inputs, outputs)``,
    each tensor copied at the call."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [_snap(a) for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        out = func(*args, **kwargs)
        outs = [_snap(o) for o in tree_flatten(out)[0]]
        self.ops.append((getattr(func, "__qualname__", str(func)), ins, outs))
        return out


def _same(a, b, whole: int, half: int):
    """Whether ``a`` (whole batch) restricted to the first ``half`` pairs
    equals ``b`` bit for bit; None when they cannot be compared."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.shape[:1] == (whole,) and b.shape[:1] == (half,):
            a = a[:half]
        if a.shape != b.shape or a.dtype != b.dtype:
            return None
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return bool(torch.equal(a, b))
    if isinstance(a, tuple) or isinstance(b, tuple):
        return None
    try:
        return bool(a == b)
    except (RuntimeError, TypeError, ValueError):
        return None


def parting_ops(whole_ops, half_ops, whole: int, half: int) -> list[str]:
    """The aligned ops whose inputs agree and whose outputs part."""
    w = [o for o in whole_ops if "__get__" not in o[0] and o[0] != "TensorBase.data_ptr"]
    h = [o for o in half_ops if "__get__" not in o[0] and o[0] != "TensorBase.data_ptr"]
    sm = difflib.SequenceMatcher(None, [o[0] for o in w], [o[0] for o in h], autojunk=False)
    found = []
    for tag, a0, a1, b0, b1 in sm.get_opcodes():
        if tag != "equal":
            continue
        for i, j in zip(range(a0, a1), range(b0, b1)):
            name, ins_w, outs_w = w[i]
            _, ins_h, outs_h = h[j]
            ins_eq = [_same(u, v, whole, half) for u, v in zip(ins_w, ins_h)]
            outs_eq = [_same(u, v, whole, half) for u, v in zip(outs_w, outs_h)]
            if ins_w and all(e is not False for e in ins_eq) and any(e is False for e in outs_eq):
                shapes = [tuple(t.shape) for t in ins_w if isinstance(t, torch.Tensor)]
                found.append(f"op {i} {name}, inputs {shapes}")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--half", type=int, default=8)
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from icp_variants_tpu_torch.core import cloud as cloud_lib
    from icp_variants_tpu_torch.core.cloud import Cloud
    from icp_variants_tpu_torch.ops import _cuda, kdtree, selection
    from icp_variants_tpu_torch.pipeline import icp

    if not torch.cuda.is_available():
        print("batch_parting: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all()
    dev = torch.device("cuda")
    pairs = cs.make_pairs(args.pairs)
    sources = icp.stack_clouds([cloud_lib.from_numpy(sp, normals=sn, morton_order=True, device=dev)
                                for sp, sn, _, _ in pairs])
    host = [cloud_lib.from_numpy(tp, normals=tn, morton_order=True, device="cpu")
            for _, _, tp, tn in pairs]
    targets = icp.stack_clouds(host).to(dev)
    kd = kdtree.stack_kd_indexes([kdtree.build_kd_index(t.points, t.valid, device=dev)
                                  for t in host])
    b, cap = sources.valid.shape
    cfg = cs.eth_config()
    k_cap = icp._compact_capacity(cap, cs.SELECTION_P)
    gen = torch.Generator(device=dev).manual_seed(2)
    draws = [selection.bernoulli_gap_indices(gen, cs.SELECTION_P, 1, cap, k_cap, batch=(b,),
                                             device=dev) for _ in range(cs.N_ITERATIONS)]
    sel = torch.stack([d[0] for d in draws], 1)
    inr = torch.stack([d[1] for d in draws], 1)

    def run(n, cfg_n, n_iter, mode=None):
        clouds = (Cloud(*(f[:n] for f in sources)), Cloud(*(f[:n] for f in targets)))
        kd_n = kdtree.KDIndex(*(None if f is None else f[:n] for f in kd))
        with mode or contextlib.nullcontext():
            return icp.run_icp_batch(cfg_n, *clouds, kd_indexes=kd_n,
                                     selected=(sel[:n, :n_iter], inr[:n, :n_iter]), device=dev)

    h = args.half
    whole, part = run(b, cfg, cfg.n_iterations), run(h, cfg, cfg.n_iterations)
    gap = (whole.pose[:h] - part.pose).abs()
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}: {cfg.n_iterations} "
          f"iterations, pairs 0-{h - 1} at B = {b} and B = {h}: largest pose gap "
          f"{float(gap.max()):.3e}, pairs parting "
          f"{(gap.amax((1, 2)) > 0).nonzero().flatten().tolist()}, match counts equal "
          f"{bool(torch.equal(whole.trace.num_matches[:h], part.trace.num_matches))}", flush=True)
    one = cfg.replace(n_iterations=1)
    rec_w, rec_h = Recorder(), Recorder()
    run(b, one, 1, rec_w)
    run(h, one, 1, rec_h)
    torch.cuda.synchronize()
    found = parting_ops(rec_w.ops, rec_h.ops, b, h)
    print(f"one iteration: {len(rec_w.ops)} / {len(rec_h.ops)} ops recorded; the ops whose "
          f"inputs agree on pairs 0-{h - 1} and whose outputs part:")
    for line in found:
        print(f"  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
