"""The graph module of the port: spatial graphs (kNN, radius, Delaunay, grid, a custom builder, polygon
masking), neighbourhood enrichment, interaction matrix, group centralities, co-occurrence, spatial
autocorrelation, Ripley's statistics, the receptor-ligand permutation test, sepal and niches."""

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
from squidpy_torch.gr._ligrec import LigrecFrame, LigrecResult, PermutationTest, PermutationTestABC, ligrec
from squidpy_torch.gr._niche import calculate_niche
from squidpy_torch.gr._nhood import (
    CentralityResult,
    NhoodEnrichmentResult,
    centrality_scores,
    interaction_matrix,
    nhood_enrichment,
)
from squidpy_torch.gr._ppatterns import AutocorrResult, co_occurrence, spatial_autocorr
from squidpy_torch.gr._ripley import RipleyTable, ripley
from squidpy_torch.gr._sepal import SepalResult, sepal
from squidpy_torch.gr.neighbors import GraphMatrixT

__all__ = [
    "AutocorrResult",
    "GraphMatrixT",
    "CentralityResult",
    "LigrecFrame",
    "LigrecResult",
    "NhoodEnrichmentResult",
    "PermutationTest",
    "PermutationTestABC",
    "RipleyTable",
    "SepalResult",
    "SpatialNeighborsResult",
    "calculate_niche",
    "centrality_scores",
    "co_occurrence",
    "interaction_matrix",
    "ligrec",
    "mask_graph",
    "neighbors",
    "nhood_enrichment",
    "ripley",
    "sepal",
    "spatial_autocorr",
    "spatial_neighbors",
    "spatial_neighbors_delaunay",
    "spatial_neighbors_from_builder",
    "spatial_neighbors_grid",
    "spatial_neighbors_knn",
    "spatial_neighbors_radius",
]
