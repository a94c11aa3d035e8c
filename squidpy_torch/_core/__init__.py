from squidpy_torch._core.graph import SpatialGraph, graph_from_adata
from squidpy_torch._core.rng import spawn_keys

__all__ = ["SpatialGraph", "graph_from_adata", "spawn_keys"]
