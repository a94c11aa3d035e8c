"""The graph module of the ported slice: kNN graph, neighbourhood enrichment, co-occurrence."""

from __future__ import annotations

from squidpy_torch.gr import neighbors
from squidpy_torch.gr._build import SpatialNeighborsResult, spatial_neighbors_knn
from squidpy_torch.gr._nhood import NhoodEnrichmentResult, nhood_enrichment
from squidpy_torch.gr._ppatterns import co_occurrence

__all__ = [
    "NhoodEnrichmentResult",
    "SpatialNeighborsResult",
    "co_occurrence",
    "neighbors",
    "nhood_enrichment",
    "spatial_neighbors_knn",
]
