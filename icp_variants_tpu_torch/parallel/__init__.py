"""Multi-rank registration and pose-graph refinement.

* :mod:`.distributed`: process-group bring-up, the (``pairs``, ``points``)
  mesh and the shard-safe sum ``psum``.
* :mod:`.sharded_icp`: the ICP driver over the mesh.
* :mod:`.pose_graph`: pose-graph refinement, on one device or with its
  edges split over the ranks (``refine_sharded``).

The submodules other than :mod:`.distributed` load on first use: the
solvers import :mod:`.distributed`, and :mod:`.sharded_icp` imports them.
"""

import importlib

from icp_variants_tpu_torch.parallel import distributed

__all__ = ["distributed", "pose_graph", "sharded_icp"]


def __getattr__(name):
    if name in ("pose_graph", "sharded_icp"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
