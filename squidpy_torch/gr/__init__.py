"""The graph module of the port: spatial graphs (kNN, radius, Delaunay, grid, a custom builder, polygon
masking), neighbourhood enrichment, interaction matrix, group centralities, co-occurrence, spatial
autocorrelation and Ripley's statistics."""

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
from squidpy_torch.gr._nhood import (
    CentralityResult,
    NhoodEnrichmentResult,
    centrality_scores,
    interaction_matrix,
    nhood_enrichment,
)
from squidpy_torch.gr._ppatterns import AutocorrResult, co_occurrence, spatial_autocorr
from squidpy_torch.gr._ripley import RipleyTable, ripley

__all__ = [
    "AutocorrResult",
    "CentralityResult",
    "NhoodEnrichmentResult",
    "RipleyTable",
    "SpatialNeighborsResult",
    "centrality_scores",
    "co_occurrence",
    "interaction_matrix",
    "mask_graph",
    "neighbors",
    "nhood_enrichment",
    "ripley",
    "spatial_autocorr",
    "spatial_neighbors",
    "spatial_neighbors_delaunay",
    "spatial_neighbors_from_builder",
    "spatial_neighbors_grid",
    "spatial_neighbors_knn",
    "spatial_neighbors_radius",
]
