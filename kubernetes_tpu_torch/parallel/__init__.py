"""The sharded tier: the batch solve with the node axis over a mesh of
shards (``parallel/sharded.py``)."""

from kubernetes_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedBackend,
    SState,
    SStatic,
    make_mesh,
    solve_scan_sharded,
)

__all__ = ["Mesh", "SState", "SStatic", "ShardedBackend", "make_mesh",
           "solve_scan_sharded"]
