"""End-to-end workloads."""
