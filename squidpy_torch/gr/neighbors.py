"""Graph construction for spatial neighbour graphs (counterpart of ``squidpy_tpu/gr/neighbors.py``).

The builder classes and postprocessors of the JAX package. The kNN query
runs on the device up to 50k points and on the host ``cKDTree`` beyond, the
radius search on the device (kernel K6 on the card, which writes each row's
diagonal itself, :mod:`squidpy_torch.ops.knn`); the Delaunay triangulation
is host qhull, as in the JAX package. The host steps of a build carry
profiler ranges named ``spatial_neighbors.*``.
"""

from __future__ import annotations

import warnings
from abc import ABC, abstractmethod
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from typing import Any, Generic, TypeVar, cast

import numpy as np
import scipy.sparse as sps
from scipy.sparse import csr_matrix, spmatrix
from scipy.spatial import Delaunay
from torch.profiler import record_function

from squidpy_torch._constants._constants import CoordType, Transform
from squidpy_torch._device import NDArrayA, assert_positive
from squidpy_torch.ops.knn import auto_knn, radius_graph

__all__ = [
    "GraphMatrixT",
    "GraphBuilder",
    "GraphBuilderCSR",
    "GraphPostprocessor",
    "DistanceIntervalPostprocessor",
    "PercentilePostprocessor",
    "TransformPostprocessor",
    "KNNBuilder",
    "RadiusBuilder",
    "DelaunayBuilder",
    "GridBuilder",
    "symmetric_normalize_csr",
]

CoordT = TypeVar("CoordT")
GraphMatrixT = TypeVar("GraphMatrixT")
GraphPostprocessor = Callable[[GraphMatrixT, GraphMatrixT], tuple[GraphMatrixT, GraphMatrixT]]


def _standard_postprocessors(
    *,
    interval: tuple[float, float] | None = None,
    percentile: float | None = None,
    transform: str | Transform | None = None,
) -> list[GraphPostprocessor]:
    """Optional distance-interval pruning, optional percentile pruning, then
    the adjacency transform (always last)."""
    steps: list[GraphPostprocessor] = []
    if interval is not None:
        steps.append(DistanceIntervalPostprocessor(tuple(sorted(interval))))
    if percentile is not None:
        steps.append(PercentilePostprocessor(percentile))
    steps.append(TransformPostprocessor(Transform(transform) if transform is not None else Transform.NONE))
    return steps


class GraphBuilder(ABC, Generic[CoordT, GraphMatrixT]):
    """Base class for spatial graph construction strategies."""

    def __init__(
        self,
        transform: str | Transform | None = None,
        set_diag: bool = False,
        percentile: float | None = None,
        postprocessors: Sequence[GraphPostprocessor] = (),
    ) -> None:
        self.transform = Transform(transform) if transform is not None else Transform.NONE
        self.set_diag = bool(set_diag)
        self.percentile = percentile
        self._postprocessors: list[GraphPostprocessor] = list(postprocessors)

    def build(self, coords: CoordT) -> tuple[GraphMatrixT, GraphMatrixT]:
        graph = self.build_graph(coords)
        with record_function("spatial_neighbors.postprocess"):
            for step in self.postprocessors():
                graph = step(*graph)
        return graph

    @abstractmethod
    def build_graph(self, coords: CoordT) -> tuple[GraphMatrixT, GraphMatrixT]:
        """Construct raw adjacency and distance matrices."""

    def postprocessors(self) -> Sequence[GraphPostprocessor]:
        """Post-build processing steps applied to ``(adj, dst)``."""
        return self._postprocessors

    @abstractmethod
    def uns_params(self) -> dict[str, Any]:
        """Parameters stored in ``adata.uns`` after graph construction."""

    def combine(
        self, mats: Sequence[tuple[GraphMatrixT, GraphMatrixT]], ixs: Sequence[int]
    ) -> tuple[GraphMatrixT, GraphMatrixT]:
        """Combine per-library results into a single graph."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot merge per-library graphs; "
            "implement `combine` to support `library_key`."
        )


class GraphBuilderCSR(GraphBuilder[NDArrayA, csr_matrix], ABC):
    """CSR-output specialization with block-diagonal multi-library combine."""

    def build(self, coords: NDArrayA) -> tuple[csr_matrix, csr_matrix]:
        # in-place setdiag on freshly-assembled CSR triggers scipy's
        # efficiency warning; it is the cheapest correct way here
        with warnings.catch_warnings(action="ignore", category=sps.SparseEfficiencyWarning):
            return super().build(coords)

    @abstractmethod
    def build_graph(self, coords: NDArrayA) -> tuple[csr_matrix, csr_matrix]:
        """Construct raw adjacency and distance matrices."""

    def combine(
        self, mats: Sequence[tuple[csr_matrix, csr_matrix]], ixs: Sequence[int]
    ) -> tuple[csr_matrix, csr_matrix]:
        """Stack per-library blocks and restore the original obs order."""
        adj_blocks, dst_blocks = zip(*mats)
        combined = [sps.block_diag(blocks, format="csr") for blocks in (adj_blocks, dst_blocks)]
        pos = np.asarray(ixs)
        if pos.size and np.any(pos[1:] < pos[:-1]):
            inv = np.argsort(pos)
            combined = [m[inv][:, inv] for m in combined]
        return cast(csr_matrix, combined[0]), cast(csr_matrix, combined[1])


def _finalize_pair(adj: csr_matrix, dst: csr_matrix, *, set_diag: bool) -> tuple[csr_matrix, csr_matrix]:
    """Self-loops on/off, zero self-distances; both matrices get explicit
    diagonal entries so their ``.data`` arrays stay parallel (the interval
    postprocessor masks one with the other)."""
    with record_function("spatial_neighbors.finalize"):
        adj.setdiag(1.0 if set_diag else adj.diagonal())
        dst.setdiag(0.0)
    return adj, dst


def _knn_to_csr(
    dists: NDArrayA, col_indices: NDArrayA, n: int, *, set_diag: bool
) -> tuple[csr_matrix, csr_matrix]:
    k = col_indices.shape[1]
    rows = np.repeat(np.arange(n), k)
    cols = col_indices.reshape(-1)
    adj = csr_matrix((np.ones(n * k, dtype=np.float32), (rows, cols)), shape=(n, n))
    dst = csr_matrix((dists.reshape(-1).astype(np.float64), (rows, cols)), shape=(n, n))
    return _finalize_pair(adj, dst, set_diag=set_diag)


class KNNBuilder(GraphBuilderCSR):
    """k-nearest-neighbour graph (exact)."""

    def __init__(
        self,
        n_neighs: int = 6,
        transform: str | Transform | None = None,
        set_diag: bool = False,
        percentile: float | None = None,
    ) -> None:
        assert_positive(n_neighs, name="n_neighs")
        steps = _standard_postprocessors(percentile=percentile, transform=transform)
        super().__init__(transform=transform, set_diag=set_diag, percentile=percentile, postprocessors=steps)
        self.n_neighs = n_neighs

    def uns_params(self) -> dict[str, Any]:
        return dict(coord_type=CoordType.GENERIC.v, n_neighbors=self.n_neighs, transform=self.transform.v)

    def build_graph(self, coords: NDArrayA) -> tuple[csr_matrix, csr_matrix]:
        n = coords.shape[0]
        dists, col_indices = auto_knn(coords, self.n_neighs)
        return _knn_to_csr(dists, col_indices, n, set_diag=self.set_diag)


class RadiusBuilder(GraphBuilderCSR):
    """Radius graph: all pairs within euclidean distance ``radius``. A tuple
    searches with its larger end and prunes to the interval afterwards."""

    def __init__(
        self,
        radius: float | tuple[float, float],
        transform: str | Transform | None = None,
        set_diag: bool = False,
        percentile: float | None = None,
    ) -> None:
        steps = _standard_postprocessors(
            interval=radius if isinstance(radius, tuple) else None,
            percentile=percentile,
            transform=transform,
        )
        super().__init__(transform=transform, set_diag=set_diag, percentile=percentile, postprocessors=steps)
        self.radius = radius

    def uns_params(self) -> dict[str, Any]:
        return dict(coord_type=CoordType.GENERIC.v, radius=self.radius, transform=self.transform.v)

    def build_graph(self, coords: NDArrayA) -> tuple[csr_matrix, csr_matrix]:
        # the search writes each row's diagonal (distance 0) in its place, so
        # the CSR is finished here: explicit diagonal entries, 1.0 or 0.0 in adj
        n = coords.shape[0]
        r = self.radius if isinstance(self.radius, (int, float)) else max(self.radius)
        indptr, indices, dists, diag = radius_graph(coords, float(r))
        with record_function("spatial_neighbors.csr"):
            data = np.ones(len(indices), dtype=np.float32)
            if not self.set_diag:
                data[diag] = 0.0
            adj = csr_matrix((data, indices, indptr), shape=(n, n))
            dst = csr_matrix((dists.astype(np.float64), indices.copy(), indptr.copy()), shape=(n, n))
        return adj, dst


class DelaunayBuilder(GraphBuilderCSR):
    """Delaunay-triangulation graph (host qhull, as in the JAX package).

    ``radius`` only prunes edges after construction: a tuple keeps edges
    with length in the interval, a scalar is shorthand for ``(0, r)``.
    """

    def __init__(
        self,
        radius: float | tuple[float, float] | None = None,
        transform: str | Transform | None = None,
        set_diag: bool = False,
        percentile: float | None = None,
    ) -> None:
        if isinstance(radius, (int, float)):
            radius = (0.0, float(radius))
        steps = _standard_postprocessors(interval=radius, percentile=percentile, transform=transform)
        super().__init__(transform=transform, set_diag=set_diag, percentile=percentile, postprocessors=steps)
        self.radius = radius

    def uns_params(self) -> dict[str, Any]:
        return dict(coord_type=CoordType.GENERIC.v, radius=self.radius, transform=self.transform.v)

    def build_graph(self, coords: NDArrayA) -> tuple[csr_matrix, csr_matrix]:
        n = coords.shape[0]
        tri = Delaunay(coords)
        indptr, indices = tri.vertex_neighbor_vertices
        adj = csr_matrix((np.ones_like(indices, dtype=np.float32), indices, indptr), shape=(n, n))
        rows = np.repeat(np.arange(n), np.diff(indptr))
        dists = np.linalg.norm(coords[rows] - coords[indices], axis=1)
        dst = csr_matrix((dists, indices.copy(), indptr.copy()), shape=(n, n))
        return _finalize_pair(adj, dst, set_diag=self.set_diag)


class GridBuilder(GraphBuilderCSR):
    """Grid-lattice graph (Visium-style): kNN with a median-distance cutoff;
    ``n_rings > 1`` expands connectivity ring by ring (distance = ring index)."""

    def __init__(
        self,
        n_neighs: int = 6,
        n_rings: int = 1,
        delaunay: bool = False,
        transform: str | Transform | None = None,
        set_diag: bool = False,
    ) -> None:
        assert_positive(n_neighs, name="n_neighs")
        assert_positive(n_rings, name="n_rings")
        steps = _standard_postprocessors(transform=transform)
        super().__init__(transform=transform, set_diag=set_diag, percentile=None, postprocessors=steps)
        self.n_neighs = n_neighs
        self.n_rings = n_rings
        self.delaunay = delaunay

    def uns_params(self) -> dict[str, Any]:
        return dict(
            coord_type=CoordType.GRID.v,
            n_neighbors=self.n_neighs,
            n_rings=self.n_rings,
            delaunay=self.delaunay,
            transform=self.transform.v,
        )

    def build_graph(self, coords: NDArrayA) -> tuple[csr_matrix, csr_matrix]:
        if self.n_rings > 1:
            adj = self._base_adjacency(coords, set_diag=True)
            res, walk = adj, adj
            for i in range(self.n_rings - 1):
                walk = walk @ adj
                walk[res.nonzero()] = 0.0
                walk.eliminate_zeros()
                walk.data[:] = i + 2.0
                res = res + walk
            adj = res
            adj.setdiag(float(self.set_diag))
            adj.eliminate_zeros()
            dst = adj.copy()
            adj.data[:] = 1.0
        else:
            adj = self._base_adjacency(coords, set_diag=self.set_diag)
            dst = adj.copy()
        dst.setdiag(0.0)
        return adj, dst

    def _base_adjacency(self, coords: NDArrayA, *, set_diag: bool) -> csr_matrix:
        n = coords.shape[0]
        if self.delaunay:
            tri = Delaunay(coords)
            indptr, indices = tri.vertex_neighbor_vertices
            adj = csr_matrix((np.ones_like(indices, dtype=np.float32), indices, indptr), shape=(n, n))
        else:
            dists, col_indices = auto_knn(coords, self.n_neighs)
            dists_f, cols_f = dists.reshape(-1), col_indices.reshape(-1)
            rows_f = np.repeat(np.arange(n), self.n_neighs)
            # keep only lattice-adjacent candidates: the grid spacing is near
            # the median kNN distance, so a 1.3x-median cutoff prunes
            # diagonal and boundary artifacts
            cutoff = np.median(dists_f) * 1.3
            keep = dists_f < cutoff
            adj = csr_matrix(
                (np.ones(int(keep.sum()), dtype=np.float32), (rows_f[keep], cols_f[keep])),
                shape=(n, n),
            )
        if set_diag:
            adj.setdiag(1.0)
        return adj


def _filter_by_radius_interval(adj: csr_matrix, dst: csr_matrix, radius: tuple[float, float]) -> None:
    minn, maxx = radius
    mask = (dst.data < minn) | (dst.data > maxx)
    a_diag = adj.diagonal()
    dst.data[mask] = 0.0
    adj.data[mask] = 0.0
    adj.setdiag(a_diag)


@dataclass(frozen=True)
class DistanceIntervalPostprocessor:
    interval: tuple[float, float]

    def __call__(self, adj: csr_matrix, dst: csr_matrix) -> tuple[csr_matrix, csr_matrix]:
        _filter_by_radius_interval(adj, dst, self.interval)
        return adj, dst


@dataclass(frozen=True)
class PercentilePostprocessor:
    percentile: float

    def __call__(self, adj: csr_matrix, dst: csr_matrix) -> tuple[csr_matrix, csr_matrix]:
        threshold = np.percentile(dst.data, self.percentile)
        adj[dst > threshold] = 0.0
        dst[dst > threshold] = 0.0
        return adj, dst


@dataclass(frozen=True)
class TransformPostprocessor:
    transform: Transform

    def __call__(self, adj: csr_matrix, dst: csr_matrix) -> tuple[csr_matrix, csr_matrix]:
        adj.eliminate_zeros()
        dst.eliminate_zeros()
        if self.transform == Transform.SPECTRAL:
            return cast(csr_matrix, _transform_a_spectral(adj)), dst
        if self.transform == Transform.COSINE:
            return cast(csr_matrix, _transform_a_cosine(adj)), dst
        if self.transform == Transform.NONE:
            return adj, dst
        raise NotImplementedError(f"Transform `{self.transform}` is not yet implemented.")


def symmetric_normalize_csr(adj: spmatrix) -> csr_matrix:
    """``D^{-1/2} A D^{-1/2}`` spectral normalization, vectorized over the nnz."""
    adj = adj.tocsr() if not sps.isspmatrix_csr(adj) else adj
    degrees = np.sqrt(1.0 / np.asarray(adj.sum(axis=0)).ravel())
    if adj.shape[0] != len(degrees):
        raise ValueError("len(degrees) must equal number of rows of adj")
    rows = np.repeat(np.arange(adj.shape[0]), np.diff(adj.indptr))
    res_data = (degrees[rows] * degrees[adj.indices] * adj.data).astype(np.float32)
    return csr_matrix((res_data, adj.indices, adj.indptr), shape=adj.shape)


def _transform_a_spectral(a: spmatrix) -> spmatrix:
    if not sps.isspmatrix_csr(a):
        a = a.tocsr()
    if not a.nnz:
        return a
    return symmetric_normalize_csr(a)


def _transform_a_cosine(a: spmatrix) -> spmatrix:
    from sklearn.metrics.pairwise import cosine_similarity  # only this transform needs sklearn

    return cosine_similarity(a, dense_output=False)
