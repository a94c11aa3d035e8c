"""The graph module of the port: spatial graphs (kNN, radius, Delaunay, grid, a custom builder, polygon
masking), neighbourhood enrichment, co-occurrence, spatial autocorrelation."""

from __future__ import annotations

from squidpy_torch.gr import neighbors
from squidpy_torch.gr._build import (
    SpatialNeighborsResult,
    mask_graph,
    spatial_neighbors,
    spatial_neighbors_delaunay,
    spatial_neighbors_from_builder,
    spatial_neighbors_grid,
    spatial_neighbors_knn,
    spatial_neighbors_radius,
)
from squidpy_torch.gr._nhood import NhoodEnrichmentResult, nhood_enrichment
from squidpy_torch.gr._ppatterns import AutocorrResult, co_occurrence, spatial_autocorr

__all__ = [
    "AutocorrResult",
    "NhoodEnrichmentResult",
    "SpatialNeighborsResult",
    "co_occurrence",
    "mask_graph",
    "neighbors",
    "nhood_enrichment",
    "spatial_autocorr",
    "spatial_neighbors",
    "spatial_neighbors_delaunay",
    "spatial_neighbors_from_builder",
    "spatial_neighbors_grid",
    "spatial_neighbors_knn",
    "spatial_neighbors_radius",
]
