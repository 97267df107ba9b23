"""Matching layer: device milliseconds per registered pair or tracked
frame in the port's matcher kernels (``ops/kdtree``, ``ops/knn``,
``ops/projective`` over ``csrc/*.cu``), named by the prefixes of their
``__global__`` functions."""

from __future__ import annotations

from benchmark.harness.trace import kernel_us

FAMILIES = ("box_topk", "kd_block_search", "visited_search", "cached_block_search",
            "kd_radius_search", "dense_nn_search", "pruned_nn_search",
            "projective_window_search")


def read(stretch):
    us = kernel_us(stretch.device, FAMILIES)
    return us / 1e3 / stretch.units if us else None
