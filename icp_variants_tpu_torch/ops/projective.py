"""Projective correspondence search (RGB-D frame-to-frame).

PyTorch port of ``icp_variants_tpu.ops.projective``
(``NearestNeighborSearchProjective``, NearestNeighbor.h:317-444): each
transformed source point is projected into the target image through the
depth intrinsics, and the closest valid target pixel within the
``(2W+1)^2`` window around its projected pixel wins (W = 12 by default),
under the squared max-distance threshold.

* :func:`project_pixels` computes each query's pixel ``(u0, v0)`` exactly as
  the JAX package does; it feeds both the plain version and the kernel.
* :func:`projective_match_plain` is the JAX package's block-gather
  formulation over an explicit pair axis, chunked by rows: the image
  re-tiled into ``BLOCK x BLOCK`` pixel blocks, each query's ``nb x nb``
  block neighbourhood, the exact window mask, the first argmin.
* :func:`projective_window_search` launches the hand-written CUDA kernel
  ``csrc/projective_window_search.cu`` on CUDA tensors (it scans the
  window straight from the image-shaped target) and runs the plain version
  on CPU tensors.
* :func:`projective_match` is the matching stage: ``(idx, d2, valid)``.

The JAX package also holds a resident-VMEM variant
(``projective_match_resident``) behind a VMEM fit rule
(``_resident_fits_projective``) and a sliced-gather switch
(``SLICED_GATHER``). Both choose a TPU kernel or a TPU gather, not an
answer: the resident and the XLA paths give the same valid set and
distances (``tests/test_projective.py``), so neither is copied here.

Tie order: among equal distances the first pixel in (block, slot) order
wins, block ``br * wb + bc`` row-major over the block grid and slot
``sv * BLOCK + su`` row-major inside the block (not image raster order).
Queries must be finite.
"""

from __future__ import annotations

import torch

from icp_variants_tpu_torch.ops import _cuda, knn

# Coordinate of invalid / out-of-image pixels: squared distances ~3e18
# stay finite in f32 and never beat BIG.
PAD_COORD = 1.0e9
# Distance of "no valid pixel in the window" (idx -1).
BIG = 3.0e13
BLOCK = 16          # pixels per block side
CHUNK = 32768       # query rows per frame in each step of the plain version
# Clip of the projected pixel before the int cast: off-screen projections
# could overflow int32, and the window test rejects them either way.
_PIXEL_CLIP = 1.0e6


def project_pixels(points: torch.Tensor, fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """``(..., 2)`` int32 pixel ``(u0, v0)`` of each point ``(..., 3)``:
    ``round(clip(x * fx / safe_z + cx, +-1e6))`` in that order of f32
    operations, ``safe_z = where(z == 0, 1, z)``, rounding half to even
    (NearestNeighbor.h:378-379, bit for bit the JAX package's)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    u0 = torch.round(torch.clamp(x * fx / safe_z + cx, -_PIXEL_CLIP, _PIXEL_CLIP))
    v0 = torch.round(torch.clamp(y * fy / safe_z + cy, -_PIXEL_CLIP, _PIXEL_CLIP))
    return torch.stack([u0, v0], dim=-1).to(torch.int32)


def _block_table(target_points, target_valid, width, height, wb, hb, block):
    """(B, hb * wb, 3 * block^2) coordinate-major block rows of the image;
    invalid and padding pixels hold PAD_COORD."""
    b = target_points.shape[0]
    img = torch.where(target_valid[..., None], target_points, PAD_COORD)
    img = img.reshape(b, height, width, 3)
    img = torch.nn.functional.pad(
        img, (0, 0, 0, wb * block - width, 0, hb * block - height), value=PAD_COORD)
    return (img.reshape(b, hb, block, wb, block, 3)
            .permute(0, 1, 3, 5, 2, 4)
            .reshape(b, hb * wb, 3 * block * block))


def projective_match_plain(
    queries: torch.Tensor,
    pix: torch.Tensor,
    target_points: torch.Tensor,
    target_valid: torch.Tensor,
    *,
    width: int,
    height: int,
    window: int = 12,
    block: int = BLOCK,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`projective_window_search` (the JAX package's
    ``projective_match`` window scan), over ``chunk`` query rows per frame
    at a time. Returns ``(idx, d2)``, (B, N) each: idx the linear pixel
    ``v * width + u`` of the first minimum in (block, slot) order, or -1
    with d2 = BIG when no valid pixel lies in the window."""
    b, n = queries.shape[0], queries.shape[1]
    dev = queries.device
    nb = (2 * window + 1 - 2) // block + 2       # blocks per axis covering any window
    wb, hb = max(-(-width // block), nb), max(-(-height // block), nb)
    b2 = block * block
    blocks = _block_table(target_points, target_valid, width, height, wb, hb, block)
    slot = torch.arange(b2, dtype=torch.int32, device=dev)
    sv, su = slot // block, slot % block
    offs = torch.arange(nb, dtype=torch.int32, device=dev)
    bi = torch.arange(b, device=dev)[:, None]
    out_idx, out_d2 = [], []
    for s in range(0, n, chunk):
        q = queries[:, s:s + chunk]
        m = q.shape[1]
        u0, v0 = pix[:, s:s + chunk, 0], pix[:, s:s + chunk, 1]
        c0 = torch.clamp(torch.div(u0 - window, block, rounding_mode="floor"), 0, wb - nb)
        r0 = torch.clamp(torch.div(v0 - window, block, rounding_mode="floor"), 0, hb - nb)
        bids = ((r0[..., None, None] + offs[:, None]) * wb
                + (c0[..., None, None] + offs[None, :])).reshape(b, m, nb * nb)
        cand = blocks[bi, bids.reshape(b, -1).long()].reshape(b, m, nb * nb, 3 * b2)
        d2 = None
        for c in range(3):
            diff = cand[..., c * b2:(c + 1) * b2] - q[:, :, None, c, None]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        del cand
        pv = (bids // wb)[..., None] * block + sv
        pu = (bids % wb)[..., None] * block + su
        inwin = ((torch.abs(pu - u0[..., None, None]) <= window)
                 & (torch.abs(pv - v0[..., None, None]) <= window)
                 & (pu < width) & (pv < height))
        d2 = torch.where(inwin, d2, BIG).reshape(b, m, -1)
        best, a = torch.min(d2, dim=-1)
        lin = torch.gather((pv * width + pu).reshape(b, m, -1), -1, a[..., None])[..., 0]
        out_idx.append(torch.where(best < BIG, lin, -1).to(torch.int32))
        out_d2.append(best)
    return torch.cat(out_idx, dim=1), torch.cat(out_d2, dim=1)


def projective_window_search(
    queries: torch.Tensor,
    pix: torch.Tensor,
    target_points: torch.Tensor,
    target_valid: torch.Tensor,
    *,
    width: int,
    height: int,
    window: int = 12,
    block: int = BLOCK,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per query, the nearest valid target pixel within ``+-window`` of its
    pixel ``pix`` (from :func:`project_pixels`), among pixels inside the
    image. ``queries`` (B, N, 3) f32, ``pix`` (B, N, 2) int32,
    ``target_points`` (B, width * height, 3) f32 image-shaped,
    ``target_valid`` (B, width * height) bool. Returns ``(idx, d2)`` as
    :func:`projective_match_plain`, which a CPU tensor runs (``chunk`` rows
    at a time); a CUDA tensor launches ``csrc/projective_window_search.cu``."""
    if queries.device.type == "cpu":
        return projective_match_plain(queries, pix, target_points, target_valid, width=width,
                                      height=height, window=window, block=block, chunk=chunk)
    b, n = queries.shape[0], queries.shape[1]
    chk = _cuda.check_cuda_tensor
    chk("queries", queries, torch.float32, (b, n, 3))
    chk("pix", pix, torch.int32, (b, n, 2))
    chk("target_points", target_points, torch.float32, (b, width * height, 3))
    chk("target_valid", target_valid, torch.bool, (b, width * height))
    idx = torch.empty((b, n), dtype=torch.int32, device=queries.device)
    d2 = torch.empty((b, n), dtype=torch.float32, device=queries.device)
    _cuda.launch("projective_window_search", queries, pix, target_points, target_valid,
                 d2, idx, b, n, width, height, window, block)
    return idx, d2


def projective_match(
    query_points: torch.Tensor,
    target_points: torch.Tensor,
    target_valid: torch.Tensor,
    *,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    window: int = 12,
    max_distance: float = 0.1,
    query_mask: torch.Tensor | None = None,
    block: int = BLOCK,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matching stage of projective ICP: ``(idx, d2, valid)`` per query,
    the JAX package's ``projective_match`` contract. idx is the linear
    target pixel of the window minimum (-1 if the window holds no valid
    pixel; d2 is then BIG), ``valid = (d2 <= max_distance) & query_mask``
    (the squared threshold, NearestNeighbor.h:407). Tensors carry a
    leading pair axis or describe one pair."""
    batched, (q, tp, tv, mask) = knn._batch_args(query_points, target_points, target_valid,
                                                 query_mask)
    q = q.float().contiguous()
    pix = project_pixels(q, fx, fy, cx, cy)
    idx, d2 = projective_window_search(
        q, pix, tp.float().contiguous(), tv.to(torch.bool).contiguous(), width=width,
        height=height, window=window, block=block, chunk=chunk)
    valid = d2 <= max_distance
    if mask is not None:
        valid = valid & mask
    return (idx, d2, valid) if batched else (idx[0], d2[0], valid[0])
