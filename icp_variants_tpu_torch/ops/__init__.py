"""Matching-stage operators; the CUDA kernels are built lazily (ops/_cuda.py)."""
