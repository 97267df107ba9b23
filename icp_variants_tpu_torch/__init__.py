"""PyTorch / CUDA port of ``icp_variants_tpu`` for one NVIDIA H100.

The layout mirrors the JAX package (``core/``, ``ops/``, ``solvers/``,
``pipeline/``) with the same module and function names. The JAX package
stays the reference the port is held against; this package imports
``torch``, numpy and scipy only, never ``jax`` nor ``icp_variants_tpu``.

Every entry point takes ``device=None``, which means ``"cuda"``: without a
card it raises unless the caller asks for ``device="cpu"``. The kd-matching
kernels are hand-written CUDA under ``csrc/``, built with ``nvcc`` at their
first CUDA launch (``ops/_cuda.py``); a CPU tensor takes each kernel's
plain PyTorch version instead.
"""
