"""Pose-graph refinement over scan sequences (single device)."""
