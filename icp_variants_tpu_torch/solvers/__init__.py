"""Pose solvers."""
