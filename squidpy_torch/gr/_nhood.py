"""Neighbourhood enrichment, interaction matrix and group centralities
(counterpart of ``squidpy_tpu/gr/_nhood.py``).

z-score = (observed count - mean(permuted counts)) / std(permuted counts),
per cluster pair, over directed stored edges. At ``n >= MIN_CIPHER_N`` the
shuffles come from the keyed index cipher (kernel K4) and are counted by the
pair counter (kernel K3), 500 permutations at a time; smaller inputs shuffle
by a stable sort of the same threefry words, and a ``library_key`` shuffles
within each library by K10's grouped entry. Keys, shuffles, counts and
z-scores equal the JAX package's on the cipher path. The interaction matrix
counts through K3 too (weighted: a float64 sum on the device); the group
centralities are host scipy, copied from the JAX package.
"""

from __future__ import annotations

import logging
from collections.abc import Iterable
from typing import Any, Literal, NamedTuple

import numpy as np
import torch
from scipy import sparse as sp
from torch.profiler import record_function

from squidpy_torch._constants._constants import Centrality
from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.graph import SpatialGraph, graph_from_adata
from squidpy_torch._core.index_cipher import MIN_CIPHER_N, cipher_label_columns
from squidpy_torch._core.rng import group_layout, permutation_columns, shuffle_group_columns, spawn_keys
from squidpy_torch._device import NDArrayA, assert_positive, get_device, to_host
from squidpy_torch.gr._utils import (
    _assert_categorical_obs,
    _assert_connectivity_key,
    _categorical_codes,
    _save_data,
    extract_adata_if_sdata,
)
from squidpy_torch.ops.nhood import analytic_pair_count_moments, cluster_pair_counts, permuted_pair_counts_cols
from squidpy_torch.utils._memoize import memoize_arrays

__all__ = ["CentralityResult", "NhoodEnrichmentResult", "centrality_scores", "interaction_matrix", "nhood_enrichment"]

_PERM_CHUNK = 500

logger = logging.getLogger(__name__)


class NhoodEnrichmentResult(NamedTuple):
    zscore: NDArrayA
    counts: NDArrayA


class CentralityResult(NamedTuple):
    """The JAX package's centrality DataFrame without pandas: ``index`` holds
    the categories (its rows); ``columns`` maps each score name to its values
    in that order, in the DataFrame's column order."""

    index: NDArrayA
    columns: dict[str, NDArrayA]


def nhood_enrichment(
    adata: Any,
    cluster_key: str,
    library_key: str | None = None,
    connectivity_key: str | None = None,
    n_perms: int = 1000,
    numba_parallel: bool = False,
    seed: int | None = None,
    copy: bool = False,
    n_jobs: int | None = None,
    backend: str = "loky",
    show_progress_bar: bool = True,
    *,
    mode: Literal["perm", "analytic"] = "perm",
    table_key: str | None = None,
    cache: bool | str = False,
) -> NhoodEnrichmentResult | None:
    """Compute neighbourhood enrichment by permutation test (``mode='perm'``)
    or by the exact closed-form permutation moments (``mode='analytic'``).

    ``numba_parallel``, ``n_jobs``, ``backend`` and ``show_progress_bar`` are
    accepted for API compatibility and ignored.
    ``library_key`` names a categorical obs column of libraries (sections):
    labels are then shuffled only within their library (K10's grouped
    entry), never by the cipher; it needs ``mode='perm'``. ``cache`` (``True``
    or a directory) keeps the permutation counts on disk, keyed by the
    graph, labels, libraries, seed and counts, so an identical seeded call
    reads them back (it needs a ``seed``, else it is turned off with a
    warning).
    Stores ``uns['{cluster_key}_nhood_enrichment'] = {'zscore', 'count'}``.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    connectivity_key = Key.obsp.spatial_conn(connectivity_key)
    _assert_categorical_obs(adata, cluster_key)
    _assert_connectivity_key(adata, connectivity_key)
    assert_positive(n_perms, name="n_perms")

    int_clust, n_cls = _categorical_codes(adata, cluster_key)

    if mode == "analytic":
        if library_key is not None:
            raise ValueError("`library_key` stratification requires `mode='perm'`.")
        # observed counts from the same self-loop-free edge set the moments use
        adj = sp.csr_matrix(adata.obsp[connectivity_key], copy=True)
        adj.setdiag(0)
        adj.eliminate_zeros()
        src, dst = adj.nonzero()
        count = (
            np.bincount(int_clust[src].astype(np.int64) * n_cls + int_clust[dst], minlength=n_cls * n_cls)
            .reshape(n_cls, n_cls)
            .astype(np.uint32)
        )
        mean, var = analytic_pair_count_moments(adj, np.bincount(int_clust, minlength=n_cls))
        with np.errstate(invalid="ignore", divide="ignore"):
            zscore = (count.astype(np.float64) - mean) / np.sqrt(var)
    elif mode == "perm":
        graph = graph_from_adata(adata, connectivity_key)
        labels_dev = torch.from_numpy(int_clust).to(get_device())
        count = to_host(cluster_pair_counts(graph.indices, graph.mask, labels_dev, n_cls), np.int64).astype(np.uint32)
        lib_codes = None
        if library_key is not None:
            _assert_categorical_obs(adata, key=library_key)
            lib_codes = np.asarray(adata.obs[library_key].cat.codes)

        def compute() -> dict[str, np.ndarray]:
            return {"perms": _permuted_counts(graph, labels_dev, int_clust, n_cls, n_perms, seed, lib_codes)}

        if cache and seed is None:
            logger.warning("`cache` requires an explicit `seed`; caching is disabled for this call")
            cache = False
        if cache:
            adj = sp.csr_matrix(adata.obsp[connectivity_key])
            arrays = {"indptr": adj.indptr, "indices": adj.indices, "labels": int_clust}
            if lib_codes is not None:
                arrays["libs"] = lib_codes
            params = {"seed": seed, "n_perms": n_perms, "n_cls": n_cls}
            perms = memoize_arrays(cache, "nhood_enrichment", arrays, params, compute)["perms"]
        else:
            perms = compute()["perms"]
        # zero-variance pairs (e.g. singleton clusters) yield NaN, as in the
        # reference; suppress only the warning
        with np.errstate(invalid="ignore", divide="ignore"):
            zscore = (count - perms.mean(axis=0)) / perms.std(axis=0)
    else:
        raise ValueError(f"Expected `mode` to be one of ['perm', 'analytic'], got `{mode!r}`.")

    if copy:
        return NhoodEnrichmentResult(zscore=zscore, counts=count)
    _save_data(adata, attr="uns", key=Key.uns.nhood_enrichment(cluster_key), data={"zscore": zscore, "count": count})
    return None


def _permuted_counts(
    graph: Any,
    labels_dev: torch.Tensor,
    int_clust: np.ndarray,
    n_cls: int,
    n_perms: int,
    seed: int | None,
    lib_codes: np.ndarray | None = None,
) -> np.ndarray:
    """``(n_perms, C, C)`` float64 counts, in chunks of 500 permutations.

    Shuffles are generated and counted in column layout (permutation axis
    minor): within each library when ``lib_codes`` is given (the group order
    made once a call), else by the cipher at scale or the sort shuffles. The
    tail chunk is padded with repeated keys, as in the JAX package, and its
    extra counts are dropped.
    """
    with record_function("nhood_enrichment.group_layout"):
        layout = group_layout(lib_codes) if lib_codes is not None else None
    use_cipher = layout is None and labels_dev.shape[0] >= MIN_CIPHER_N
    class_counts = np.bincount(int_clust, minlength=n_cls)
    keys = spawn_keys(seed, n_perms)
    chunk = min(n_perms, _PERM_CHUNK)
    payload = torch.uint8 if n_cls <= 255 else None
    parts: list[np.ndarray] = []
    for c0 in range(0, n_perms, chunk):
        kc = keys[c0 : c0 + chunk]
        n_real = kc.shape[0]
        if n_real < chunk:
            kc = np.concatenate([kc, np.broadcast_to(kc[-1:], (chunk - n_real, 2))])
        if layout is not None:
            cols = shuffle_group_columns(kc, labels_dev, payload_dtype=payload, layout=layout)
        elif use_cipher:
            cols = cipher_label_columns(kc, class_counts, out_dtype=payload)
        else:
            cols = permutation_columns(kc, labels_dev, payload_dtype=payload)
        with record_function("nhood_enrichment.pair_counts"):
            counts_c = permuted_pair_counts_cols(graph.indices, graph.mask, cols, n_cls)
        with record_function("nhood_enrichment.to_host"):
            parts.append(to_host(counts_c, np.float64)[:n_real])
    return np.concatenate(parts, axis=0)


def centrality_scores(
    adata: Any,
    cluster_key: str,
    score: str | Iterable[str] | None = None,
    connectivity_key: str | None = None,
    copy: bool = False,
    n_jobs: int | None = None,
    backend: str = "loky",
    show_progress_bar: bool = False,
    *,
    table_key: str | None = None,
) -> CentralityResult | None:
    """Compute group centrality scores per cluster (host scipy, copied from
    the JAX package).

    Valid scores: ``closeness_centrality``, ``average_clustering``,
    ``degree_centrality``: the Everett-Borgatti definitions networkx gives,
    over the undirected simple view of the stored graph (symmetrised,
    unweighted, no self-loops). ``n_jobs``, ``backend`` and
    ``show_progress_bar`` are accepted for API compatibility and ignored.
    Stores ``uns['{cluster_key}_centrality_scores']``.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    connectivity_key = Key.obsp.spatial_conn(connectivity_key)
    _assert_categorical_obs(adata, cluster_key)
    _assert_connectivity_key(adata, connectivity_key)

    if isinstance(score, (str, Centrality)):
        wanted = [Centrality(score)]
    elif score is None:
        wanted = list(Centrality)
    else:
        wanted = [Centrality(c) for c in score]

    with record_function("centrality_scores.graph"):
        adj = sp.csr_matrix(adata.obsp[connectivity_key])
        und = ((adj + adj.T) != 0).astype(np.int8).tocsr()
        und.setdiag(0)
        und.eliminate_zeros()

    cats = np.asarray(adata.obs[cluster_key].cat.categories)
    codes = np.asarray(adata.obs[cluster_key].cat.codes, dtype=np.int64)
    n = und.shape[0]
    n_cls = len(cats)
    member = np.zeros((n_cls, n), dtype=bool)
    member[codes[codes >= 0], np.flatnonzero(codes >= 0)] = True
    sizes = member.sum(axis=1)

    columns: dict[str, NDArrayA] = {}
    for cent in wanted:
        with record_function(f"centrality_scores.{cent.s}"):
            if cent == Centrality.DEGREE:
                columns[cent.s] = _group_degree_centrality(und, member, sizes)
            elif cent == Centrality.CLUSTERING:
                columns[cent.s] = _group_average_clustering(und, member, sizes)
            elif cent == Centrality.CLOSENESS:
                columns[cent.s] = _group_closeness_centrality(und, member)
            else:
                raise NotImplementedError(f"Centrality `{cent}` is not yet implemented.")

    res = CentralityResult(index=cats, columns=columns)
    if copy:
        return res
    _save_data(adata, attr="uns", key=Key.uns.centrality_scores(cluster_key), data=res)
    return None


def _group_degree_centrality(und: sp.csr_matrix, member: NDArrayA, sizes: NDArrayA) -> NDArrayA:
    """Everett-Borgatti group degree: |N(S) \\ S| / (n - |S|), all groups at
    once by one (C, n) @ (n, n) sparse product."""
    n = und.shape[0]
    reached = (sp.csr_matrix(member, dtype=np.int8) @ und).toarray() > 0
    outside_reached = (reached & ~member).sum(axis=1)
    return outside_reached / np.maximum(n - sizes, 1)


def _group_average_clustering(und: sp.csr_matrix, member: NDArrayA, sizes: NDArrayA) -> NDArrayA:
    """Mean local clustering coefficient per group: per-node triangle counts
    from ``(B @ B) * B`` row sums, then a masked mean per group
    (``nx.average_clustering(G, nodes=S)``)."""
    deg = np.asarray(und.sum(axis=1)).ravel().astype(np.float64)
    tri2 = np.asarray((und @ und).multiply(und).sum(axis=1)).ravel()  # 2 * triangles(v)
    denom = deg * (deg - 1.0)
    coeff = np.divide(tri2, denom, out=np.zeros_like(deg), where=denom > 0)
    return (member @ coeff) / np.maximum(sizes, 1)


def _group_closeness_centrality(und: sp.csr_matrix, member: NDArrayA) -> NDArrayA:
    """Everett-Borgatti group closeness: |V - S| / sum_{v in V - S} d(v, S),
    one multi-source hop-metric ``dijkstra`` a group; unreachable nodes add
    0 to the sum and an empty sum gives 0, as in networkx."""
    from scipy.sparse.csgraph import dijkstra

    scores = np.zeros(member.shape[0], dtype=np.float64)
    for c, inside in enumerate(member):
        sources = np.flatnonzero(inside)
        if len(sources) == 0:
            continue
        dist = dijkstra(und, directed=False, unweighted=True, indices=sources, min_only=True)
        dist = dist[~inside]
        total = dist[np.isfinite(dist)].sum()
        scores[c] = len(dist) / total if total > 0 else 0.0
    return scores


def interaction_matrix(
    adata: Any,
    cluster_key: str,
    connectivity_key: str | None = None,
    normalized: bool = False,
    copy: bool = False,
    weights: bool = False,
    *,
    table_key: str | None = None,
) -> NDArrayA | None:
    """Compute the cluster interaction matrix: stored edges ``i -> j`` (or
    their total weight) by the clusters of ``i`` and ``j``, cells with a NaN
    cluster dropped; K3 counts them, the weighted sum runs in float64.

    Stores ``uns['{cluster_key}_interactions']``.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    connectivity_key = Key.obsp.spatial_conn(connectivity_key)
    _assert_categorical_obs(adata, cluster_key)
    _assert_connectivity_key(adata, connectivity_key)

    col = adata.obs[cluster_key]
    codes = np.asarray(col.cat.codes)
    mask = codes >= 0  # a NaN cell has code -1
    if not mask.any():
        raise RuntimeError(f"After removing NaNs in `adata.obs[{cluster_key!r}]`, none remain.")

    g = adata.obsp[connectivity_key]
    g = g[mask, :][:, mask]
    n_cats = len(col.cat.categories)
    int_clust = codes[mask].astype(np.int32)

    graph = SpatialGraph.from_csr(g)
    labels = torch.from_numpy(int_clust).to(graph.indices.device)
    counts = cluster_pair_counts(graph.indices, graph.mask, labels, n_cats, weights=graph.weights if weights else None)
    output = to_host(counts, np.float64)
    is_int = np.issubdtype(g.dtype, np.integer) or np.issubdtype(g.dtype, np.bool_)
    if is_int:
        output = output.astype(int)

    if normalized:
        output = output / output.sum(axis=1).reshape((-1, 1))

    if copy:
        return output
    _save_data(adata, attr="uns", key=Key.uns.interaction_matrix(cluster_key), data=output)
    return None
