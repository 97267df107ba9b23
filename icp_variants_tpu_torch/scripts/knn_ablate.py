"""Ablation of the visited-list search: which part of its work costs?

PyTorch port of the JAX package's ``scripts/knn_ablate.py``. The same
visited-list 1-NN runs in modes that each drop or change one part:

* ``full``: the production walk: prune, double-buffered staging, max and
  argmax of the expansion;
* ``noprune``: every listed chunk (the prune's benefit and cost);
* ``maxonly``: the max only, idx left at -1 (the argmax's share);
* ``dmaonly``: every chunk staged, no arithmetic; returns (bound, -1)
  (staging and loop overhead);
* ``default``: the expansion's product by TF32 tensor-core products (the
  TPU's single bf16 pass at DEFAULT precision);
* ``high``: split TF32, three products (the TPU's HIGH precision);
* ``direct``: direct differences over the D features.

Only ``full``, ``noprune`` and ``direct`` return matches; ``default`` and
``high`` return distances within :func:`tf32_error_bound` of the exact
modes', and the kernel's within :func:`tf32_order_bound` of their own
plain version's (:func:`tf32_check`). The kernel is ``csrc/visited_ablate.cu``; :func:`ablate_search`
launches it on CUDA tensors and runs :func:`ablate_search_plain` on CPU
tensors. On the card :func:`ablate` times every mode; ``chip_smoke.py``
runs it on the JAX script's own inputs (:func:`ablate_inputs`).

The kernel runs one thread block cluster of :data:`CLUSTER` CTAs per query
tile; CTA r scores the columns :func:`cluster_slices` gives it of every
chunk, and the cluster merges the slices' answers per chunk (noprune: once,
at the end). :func:`cluster_fit` reads a launch's fit on the card, and
:func:`ablate_counted` runs the ``-DABL_COUNT`` build, which records the
chunks each CTA scored.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from icp_variants_tpu_torch.ops import _cuda, knn
from icp_variants_tpu_torch.scripts import cuda_ms

# The kernel's mode numbers are the positions in MODES.
MODES = ("full", "noprune", "maxonly", "dmaonly", "default", "high", "direct")
TILE_Q = 256        # query rows per tile (one cluster of CTAs)
TILE_T = 512        # target rows per tile
CHUNK = 8           # target tiles scored together
# The JAX script's visit-list width is a multiple of this many tiles.
_LIST_MULTIPLE = 128
SMEM_LIMIT = 227 * 1024
# The production build's CTAs a cluster (csrc/visited_ablate.cu ABL_CLUSTER).
CLUSTER = 16
# The counting build's define: it records the chunks each CTA scored.
COUNT_DEFINES = ("ABL_COUNT",)
# First-order TF32 rounding factors of tf32_error_bound (see there).
TF32_GAMMA = {"default": 1.01 * 2.0 ** -9, "high": 2.0 ** -15}
# The factor of tf32_order_bound: a TF32 mode's kernel against its plain
# version, the same rounded operands summed in another order (see there).
TF32_ORDER_GAMMA = 2.0 ** -17


class AblateInputs(NamedTuple):
    """The ablation's operands, built once (the lists are hoisted out of the
    timed search, as in the JAX script)."""

    q_aug: torch.Tensor    # (nqt * TILE_Q, 8) f32 features, column 7 = -1
    qn2: torch.Tensor      # (nqt * TILE_Q,) f32 |q|^2 over the 8 columns
    pages: torch.Tensor    # (n_tiles, 8, tile_t) f32, row 7 = 0.5 |t|^2
    vlist: torch.Tensor    # (nqt, max_v) int32 visited tile ids
    suffix: torch.Tensor   # (nqt, max_v) f32 suffix minimum of their bounds
    counts: torch.Tensor   # (nqt,) int32 chunks per query tile
    bound: float
    tile_t: int
    chunk: int
    d: int                 # features per point


def augment_pages(index: knn.TargetIndex) -> torch.Tensor:
    """(n_tiles, 8, tile_t) feature-major pages of an unbatched
    :class:`knn.TargetIndex` with row 7 set to ``0.5 |t|^2`` over the
    first seven columns (the JAX package's augmented pages; the port's
    index leaves that row at its padding, and is not changed here). Pad
    rows (1e6 in every column) get 3.5e12 and never win the max."""
    half = knn.norm2(index.points[:, :7]) * 0.5
    pages = index.points_t3.clone()
    pages[:, 7, :] = half.reshape(pages.shape[0], pages.shape[2])
    return pages


def ablate_inputs(queries: torch.Tensor, targets: torch.Tensor, max_distance: float, *,
                  tile_t: int = TILE_T, chunk: int = CHUNK) -> AblateInputs:
    """The JAX script's operands (``knn_ablate.main``) on the tensors'
    device: queries (N, d) padded to whole TILE_Q-row tiles with zero rows,
    targets (M, d) in a ``tile_t``-row index, the visit lists of every query
    tile's box within ``knn.bound_value(max_distance)`` (padded to
    ``max_v`` = n_tiles rounded up to a multiple of 128 and of ``chunk``,
    tile 0 and :data:`knn._LB_PAD` past each count) and the chunk
    counts."""
    d = queries.shape[-1]
    index = knn.build_target_index(targets.float(), tile_t=tile_t)
    bound = knn.bound_value(max_distance)
    qp = knn._pad_rows(knn._pad_features(queries.float()), TILE_Q, 0.0)
    qn2 = knn.norm2(qp)
    qtiles = qp.reshape(-1, TILE_Q, knn.FEATURE_PAD)
    vlist, suffix, counts, _ = knn._visit_lists(
        qtiles.amin(1), qtiles.amax(1), index.bbox_min, index.bbox_max, bound)
    n_tiles = index.points_t3.shape[0]
    step = int(np.lcm(_LIST_MULTIPLE, chunk))
    max_v = -(-n_tiles // step) * step
    vlist = torch.nn.functional.pad(vlist, (0, max_v - n_tiles)).contiguous()
    suffix = torch.nn.functional.pad(suffix, (0, max_v - n_tiles), value=knn._LB_PAD)
    q_aug = qp.clone()
    q_aug[:, 7] = -1.0
    return AblateInputs(
        q_aug=q_aug, qn2=qn2, pages=augment_pages(index), vlist=vlist,
        suffix=suffix.contiguous(), counts=((counts + chunk - 1) // chunk).to(torch.int32),
        bound=bound, tile_t=tile_t, chunk=chunk, d=d)


def issue_instructions(mode: str, d: int) -> int:
    """Instructions per (row, column) that bound ``mode``'s issue on the
    CUDA cores at ``d`` features (``csrc/visited_ablate.cu``): 2D + 2 for
    the expansion (D + 1 FMUL, D FADD, one FMNMX), 3D for direct
    differences (D FADD, D FMUL, D - 1 FADD, one FMNMX), 3 per accumulator
    element of the TF32 modes (a compare and two selects; the products run
    on the tensor cores), none for dmaonly."""
    if mode not in MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; modes are {MODES}")
    return {"direct": 3 * d, "default": 3, "high": 3, "dmaonly": 0}.get(mode, 2 * d + 2)


def cluster_slices(cols: int, cluster: int = CLUSTER) -> list[tuple[int, int]]:
    """The chunk columns ``[lo, hi)`` of each CTA rank of a cluster: slices
    of ``ceil(cols / cluster)`` rounded up to 4 columns (so every staged
    slice is 16-byte aligned), the last ones short or empty."""
    w = -(-cols // cluster)
    w = (w + 3) // 4 * 4
    return [(min(cols, r * w), min(cols, r * w + w)) for r in range(cluster)]


def _smem_bytes(mode: str, rows: int, cols: int, max_v: int) -> int:
    """Dynamic shared memory of one CTA: where ``mode`` prunes, a receive
    buffer of two chunks' partials (8 bytes a row from each CTA); two
    stages of ``rows`` staged rows of its slice, at a pitch of the slice
    width rounded up to 32, plus 8; then the tile's visit list and
    suffix."""
    w = cluster_slices(cols)[0][1]
    recv = 0 if mode in ("noprune", "dmaonly") else 2 * CLUSTER * TILE_Q * 8
    return recv + 2 * rows * (-(-w // 32) * 32 + 8) * 4 + max_v * 8


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 fraction bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dot(q, t):
    """(nqt, TILE_Q, C) sums over the staged rows in order of ``q[..., r] *
    t[:, r, :]``, every product and sum rounded on its own."""
    g = q[:, :, 0, None] * t[:, None, 0, :]
    for r in range(1, q.shape[-1]):
        g = g + q[:, :, r, None] * t[:, None, r, :]
    return g


def _score(mode, qf, qn2, t):
    """A chunk's answer per row: ``(lmin, lpos)`` of the (nqt, TILE_Q) rows
    over the (nqt, R, C) staged rows ``t``; ``qf`` (nqt, TILE_Q, R) holds
    the matching query features."""
    if mode == "direct":
        d2 = None
        for r in range(qf.shape[-1]):
            diff = t[:, None, r, :] - qf[:, :, r, None]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        return torch.min(d2, dim=-1)
    if mode == "default":
        g = _dot(_tf32(qf), _tf32(t))
    elif mode == "high":
        q_hi, t_hi = _tf32(qf), _tf32(t)
        q_lo, t_lo = _tf32(qf - q_hi), _tf32(t - t_hi)
        g = (_dot(q_lo, t_hi) + _dot(q_hi, t_lo)) + _dot(q_hi, t_hi)
    else:
        g = _dot(qf, t)
    gmax, gpos = torch.max(g, dim=-1)
    return qn2 - gmax * 2.0, gpos


def _ablate_plain(inp: AblateInputs, mode: str):
    """:func:`ablate_search_plain` and the chunks each query tile scored
    ((nqt,) int64; the staged chunks, for dmaonly)."""
    if mode not in MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; modes are {MODES}")
    dev = inp.q_aug.device
    nqt = inp.counts.shape[0]
    tile_t, chunk, d = inp.tile_t, inp.chunk, inp.d
    rows = list(range(d)) if mode == "direct" else list(range(d)) + [7]
    qf = inp.q_aug.reshape(nqt, TILE_Q, 8)[:, :, rows]
    qn2 = inp.qn2.reshape(nqt, TILE_Q)
    best = torch.full((nqt, TILE_Q), inp.bound, dtype=torch.float32, device=dev)
    idx = torch.full((nqt, TILE_Q), -1, dtype=torch.int32, device=dev)
    counts = inp.counts.long()
    active = counts > 0
    n_run = torch.zeros(nqt, dtype=torch.int64, device=dev)
    prune = mode not in ("noprune", "dmaonly")
    max_v = inp.vlist.shape[1]
    for k in range(int(counts.max()) if nqt else 0):
        if not bool(active.any()):
            break
        n_run += active
        nxt = active & (k + 1 < counts)
        if prune:  # the tile's largest running best before chunk k
            nxt &= inp.suffix[:, min((k + 1) * chunk, max_v - 1)] <= best.amax(1)
        if mode != "dmaonly":
            tiles = inp.vlist[:, k * chunk:(k + 1) * chunk].long()     # (nqt, chunk)
            t = inp.pages[tiles][:, :, rows, :]                        # (nqt, chunk, R, tile_t)
            t = t.permute(0, 2, 1, 3).reshape(nqt, len(rows), chunk * tile_t)
            lmin, lpos = _score(mode, qf, qn2, t)
            better = (lmin < best) & active[:, None]
            best = torch.where(better, lmin, best)
            if mode != "maxonly":
                tid = torch.gather(tiles, 1, lpos // tile_t)
                idx = torch.where(better, (tid * tile_t + lpos % tile_t).to(torch.int32), idx)
        active = nxt
    return best.reshape(-1), idx.reshape(-1), n_run


def ablate_search_plain(inp: AblateInputs, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ablate_search`, query tiles side by side,
    chunk by chunk, with the kernel's order of rounding."""
    d2, idx, _ = _ablate_plain(inp, mode)
    return d2, idx


def ablate_search(inp: AblateInputs, mode: str,
                  defines: tuple[str, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """The visited-list search in ``mode`` (one of :data:`MODES`):
    ``(d2, idx)``, (nqt * TILE_Q,) each. idx is the target's tiled position
    (tile * tile_t + slot), -1 where nothing beats the bound (d2 is then the
    bound) and everywhere in maxonly and dmaonly. A CUDA tensor launches
    ``csrc/visited_ablate.cu`` (D = 3 or 6; with ``defines``, that build of
    it, uncounted); a CPU tensor runs :func:`ablate_search_plain`."""
    if mode not in MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; modes are {MODES}")
    if inp.q_aug.device.type == "cpu":
        return ablate_search_plain(inp, mode)
    d = _cuda.feature_dim("visited_ablate", inp.d)
    nqt, max_v = inp.vlist.shape
    n_tiles, tile_t = inp.pages.shape[0], inp.tile_t
    chk = _cuda.check_cuda_tensor
    chk("q_aug", inp.q_aug, torch.float32, (nqt * TILE_Q, 8))
    chk("qn2", inp.qn2, torch.float32, (nqt * TILE_Q,))
    chk("pages", inp.pages, torch.float32, (n_tiles, 8, tile_t))
    chk("vlist", inp.vlist, torch.int32, (nqt, max_v))
    chk("suffix", inp.suffix, torch.float32, (nqt, max_v))
    chk("counts", inp.counts, torch.int32, (nqt,))
    rows = d if mode == "direct" else d + 1
    smem = _smem_bytes(mode, rows, inp.chunk * tile_t, max_v)
    if smem > SMEM_LIMIT or tile_t % 8 or max_v % inp.chunk:
        raise ValueError(f"visited_ablate: chunk {inp.chunk} x tile_t {tile_t} needs {smem} B "
                         f"of shared memory a CTA (at most {SMEM_LIMIT}); tile_t must be a "
                         f"multiple of 8 and max_v {max_v} of the chunk")
    d2 = torch.empty((nqt * TILE_Q,), dtype=torch.float32, device=inp.q_aug.device)
    idx = torch.empty((nqt * TILE_Q,), dtype=torch.int32, device=inp.q_aug.device)
    _cuda.launch("visited_ablate", inp.q_aug, inp.qn2, inp.pages, inp.vlist, inp.suffix,
                 inp.counts, inp.bound, d2, idx, nqt, max_v, tile_t, inp.chunk,
                 MODES.index(mode), d, defines=defines)
    return d2, idx


def cluster_fit(inp: AblateInputs, mode: str) -> dict:
    """The fit of a launch of ``mode`` on these inputs on the current card:
    CTAs a cluster, clusters resident at once
    (``cudaOccupancyMaxActiveClusters``), CTAs an SM holds, threads a CTA
    and dynamic shared memory a CTA. Makes no launch."""
    out = (ctypes.c_int * 5)()
    fn = _cuda.library("visited_ablate").visited_ablate_fit
    fn.argtypes, fn.restype = [ctypes.c_int] * 6 + [ctypes.c_void_p], ctypes.c_int
    nqt, max_v = inp.vlist.shape
    err = fn(nqt, max_v, inp.tile_t, inp.chunk, MODES.index(mode), inp.d, out)
    if err:
        raise RuntimeError(f"visited_ablate_fit failed ({err})")
    return dict(zip(("cluster", "clusters_resident", "ctas_per_sm", "threads", "smem_bytes"),
                    out))


def ablate_counted(inp: AblateInputs, mode: str):
    """One search in ``mode`` on the counting build (``-DABL_COUNT``;
    uncounted): ``(d2, idx, chunks)``, chunks (nqt, CLUSTER) int64 on the
    CPU, the chunks each CTA of each query tile's cluster scored (staged,
    for dmaonly): every CTA of a tile's cluster takes the same walk, and
    it equals :func:`_ablate_plain`'s count."""
    d2, idx = ablate_search(inp, mode, COUNT_DEFINES)
    nqt = inp.counts.shape[0]
    out = torch.zeros((nqt, CLUSTER), dtype=torch.int32)
    fn = _cuda.library("visited_ablate", COUNT_DEFINES).visited_ablate_counts
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    torch.cuda.synchronize(inp.q_aug.device)
    err = fn(out.data_ptr(), nqt * CLUSTER)
    if err:
        raise RuntimeError(f"visited_ablate_counts failed ({err})")
    return d2, idx, out.long()


def _abs_products(inp: AblateInputs, idx: torch.Tensor) -> torch.Tensor:
    """Per row, ``S = sum_f |q_f| |t_f|`` over the staged features of the
    expansion for the target at tiled position ``idx`` (0 where idx = -1)."""
    rows = list(range(inp.d)) + [7]
    pos = idx.clamp(min=0).long()
    t = inp.pages[pos // inp.tile_t, :, pos % inp.tile_t]          # (N, 8)
    s = (inp.q_aug[:, rows].abs() * t[:, rows].abs()).sum(-1)
    return torch.where(idx >= 0, s, 0.0)


def tf32_error_bound(inp: AblateInputs, mode: str, idx: torch.Tensor) -> torch.Tensor:
    """Per row, how far a TF32 mode's d2 for the target at tiled position
    ``idx`` (-1: none, bound 0) may lie from the exact modes' f32 d2:
    ``gamma * S + 2^-22 * qn2`` with ``S = sum_f |q_f| |t_f|`` over the
    staged features.

    default: each operand is rounded to 11 significant bits (relative error
    2^-11), so a product is off by at most (2^-10 + 2^-22) of itself; the
    tensor core's f32 accumulation of the 8 products and the f32 reference's
    own sum add at most 2^-20 S each, and d2 = qn2 - 2g doubles g's error:
    gamma = 2 (2^-10 + 2^-22 + 2^-19) (1 + 2^-9) < 1.01 * 2^-9. The final
    subtraction rounds both sides: 2^-22 (qn2 + 2S), its S part inside the
    1.01. high: hi + lo keeps 22 bits, the dropped lo*lo and the roundings
    of lo leave 3 * 2^-22 S, the 24-term accumulation 3 * 2^-20 S and the
    reference 2^-20 S: twice that is below 2^-16.5 S; gamma = 2^-15 keeps
    a margin for the chunk prune, which a rounding can flip within 2^-20 S.
    The winners of two modes may differ; hold a row within the larger of
    the bounds at both winners."""
    s = _abs_products(inp, idx)
    return torch.where(idx >= 0, TF32_GAMMA[mode] * s + 2.0 ** -22 * inp.qn2, 0.0)


def tf32_order_bound(inp: AblateInputs, idx: torch.Tensor) -> torch.Tensor:
    """Per row, how far the kernel's d2 in a TF32 mode (default or high)
    for the target at tiled position ``idx`` may lie from its plain
    version's: ``2^-17 S + 2^-22 qn2`` (S as in :func:`tf32_error_bound`).

    Both round the same operands to TF32 (``cvt.rna``), and a product of
    two TF32 values is exact in f32, so they differ only in how the
    products are summed. The plain version adds them one by one, each sum
    rounded: at most 2^-21 S for the 12 products of high. A tensor-core
    ``mma`` adds its 8 products to the accumulator, aligned to the largest
    and rounded once, within 2^-20 S (a model of the hardware; the check on
    the card tests it): 1.5 * 2^-19 S for high's three chained products.
    d2 = qn2 - 2g doubles the difference of the sums, 1.75 * 2^-18 S, and
    its rounding on both sides adds 2^-22 (qn2 + 2S): below 2^-17 S + 2^-22
    qn2, 1/258 of default's :func:`tf32_error_bound` and 1/4 of high's."""
    s = _abs_products(inp, idx)
    return torch.where(idx >= 0, TF32_ORDER_GAMMA * s + 2.0 ** -22 * inp.qn2, 0.0)


def plain_d2_at(inp: AblateInputs, mode: str, idx: torch.Tensor) -> torch.Tensor:
    """Per row, the plain version's d2 in ``mode`` for the target at tiled
    position ``idx``, rounded as the plain search rounds it (the bound
    where idx = -1): at the plain search's own winner it is the plain d2
    bit for bit."""
    rows = list(range(inp.d)) if mode == "direct" else list(range(inp.d)) + [7]
    pos = idx.clamp(min=0).long()
    t = inp.pages[pos // inp.tile_t, :, pos % inp.tile_t][:, rows]          # (N, R)
    d2, _ = _score(mode, inp.q_aug[:, None, rows], inp.qn2[:, None], t[:, :, None])
    return torch.where(idx >= 0, d2[:, 0], inp.bound)


def tf32_check(inp: AblateInputs, mode: str, got, plain) -> tuple[float, int]:
    """A TF32 mode's search result ``got`` = (d2, idx) held against its
    plain version's ``plain``: ``(worst, n_other)``, the worst row's
    largest of three gaps over :func:`tf32_order_bound` (taken at both
    winners; at most 1 passes) and the rows whose winner differs. The gaps:
    d2 from the plain d2; d2 from the plain d2 of its own idx
    (:func:`plain_d2_at`), so the distance is that of the target it names;
    and, where the winners differ, the plain d2 of got's winner from the
    plain d2, so another winner is a tie within the rounding. Where both
    are -1, d2 must be the bound exactly."""
    d2, idx = got
    d2_p, idx_p = plain
    e = torch.maximum(tf32_order_bound(inp, idx), tf32_order_bound(inp, idx_p))
    at = plain_d2_at(inp, mode, idx)
    other = idx != idx_p
    gaps = torch.stack([(d2 - d2_p).abs(), torch.where(idx >= 0, (at - d2).abs(), 0.0),
                        torch.where(other, (at - d2_p).abs(), 0.0)]).amax(0)
    ratio = torch.where(gaps == 0, 0.0, gaps / e.clamp(min=1e-30))
    return float(ratio.max()), int(other.sum())


def ablate_work(inp: AblateInputs, mode: str, chunks_run: torch.Tensor):
    """The work of one search in ``mode`` on these inputs, given the chunks
    each query tile ran (:func:`_ablate_plain`'s count): ``(bytes, ops,
    kind)``. Bytes: each query, list entry and output once, and the staged
    rows of each distinct target tile a run chunk lists, once. Ops per
    (query row, column) of a run chunk: 2(D + 1) f32 for the expansion
    (D + 1 products, D sums and the max), 3D for direct differences, 16
    TF32 for default (an 8-deep product) and 48 for high; none for
    dmaonly. ``kind`` is the peak the ops run at: "f32" or "tf32"."""
    d, tile_t, chunk = inp.d, inp.tile_t, inp.chunk
    nqt, max_v = inp.vlist.shape
    rows = d if mode == "direct" else d + 1
    pos = torch.arange(max_v, device=inp.vlist.device)
    staged = pos[None, :] < (chunks_run * chunk)[:, None]
    n_tiles = inp.pages.shape[0]
    touched = torch.zeros(n_tiles, dtype=torch.bool, device=inp.vlist.device)
    touched[inp.vlist[staged].long()] = True
    nq = nqt * TILE_Q
    nbytes = (nq * (8 + 1 + 2) * 4 + nqt * (max_v * 8 + 4)
              + int(touched.sum()) * rows * tile_t * 4)
    cols = int(chunks_run.sum()) * chunk * tile_t * TILE_Q
    per = {"default": 16, "high": 48, "direct": 3 * d, "dmaonly": 0}.get(mode, 2 * (d + 1))
    return nbytes, cols * per, "tf32" if mode in ("default", "high") else "f32"


def ablate(inp: AblateInputs, modes=MODES, reps: int = 20) -> dict[str, float]:
    """Median ms of one search in each of ``modes`` on the card, over
    ``reps`` launches between CUDA events (the lists are built once, out of
    the timed call, as in the JAX script)."""
    return {mode: cuda_ms(lambda mode=mode: ablate_search(inp, mode), reps) for mode in modes}
