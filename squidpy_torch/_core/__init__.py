from squidpy_torch._core.anndata import AnnData, Raw, concat
from squidpy_torch._core.graph import SpatialGraph, graph_from_adata
from squidpy_torch._core.io_h5ad import read_h5ad, write_h5ad
from squidpy_torch._core.rng import spawn_keys
from squidpy_torch._core.spatialdata import SpatialData

__all__ = ["AnnData", "Raw", "SpatialData", "SpatialGraph", "concat", "graph_from_adata", "read_h5ad", "spawn_keys",
           "write_h5ad"]
