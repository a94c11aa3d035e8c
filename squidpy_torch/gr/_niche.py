"""Niche (spatial domain) detection (counterpart of ``squidpy_tpu/gr/_niche.py``).

Flavors: ``neighborhood`` (n-hop weighted neighbour-category profiles ->
Leiden on their kNN graph), ``utag`` (row-normalised ``A @ X`` -> PCA ->
Leiden), ``cellcharter`` (k-hop mean or variance aggregation -> PCA -> GMM)
and ``spatialleiden`` (gated on the optional package). From
``_DEVICE_HOPS_MIN_N`` (1,000) cells the hop patterns come from kernel K13
(:mod:`squidpy_torch.ops.hops`) and every sparse product from kernel K5a;
the kNN search is kernel K12; below, the JAX package's scipy host branches
run here too.

The container decides what is written: where ``adata.obs`` is a pandas
DataFrame, the JAX package's columns (object strings, ``pd.Categorical``
for ``cellcharter``); on a duck-typed container, numpy arrays of the same
values. pandas and sklearn are imported only where they are used.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Literal

import numpy as np
import torch
from scipy import sparse as sps
from torch.profiler import record_function

from squidpy_torch._core.device_x import device_expression
from squidpy_torch._core.graph import SpatialGraph
from squidpy_torch._device import get_device
from squidpy_torch.gr._utils import extract_adata_if_sdata
from squidpy_torch.models.clustering import gmm_cluster, graph_cluster, pca_embed, zscore

__all__ = ["calculate_niche"]

logger = logging.getLogger(__name__)

# below this many cells the profiles and hop features take the scipy host
# branches (the JAX package switches at 20,000, its TPU setting). On one
# H100 (NVIDIA H100 80GB HBM3, 700.00 W; examples/niche_crossover.py, 10
# calls a branch and size) the device branch took 11.7 / 19.5 / 33.6 / 78.5
# ms a neighborhood call at 1k / 2k / 5k / 10k cells against the host
# branch's 13.1 / 25.2 / 48.2 / 117.8 ms, and 0.405 / 0.543 s a cellcharter
# call at 5k / 10k against 0.588 / 0.865 s (its float32 GMM fails at 1k and
# 2k cells of that data in both branches). The device branch is ahead from
# the smallest size measured, 1,000 cells; smaller sections are unmeasured.
_DEVICE_HOPS_MIN_N = 1_000
_NOT_A_NICHE = "not_a_niche"


def calculate_niche(
    data: Any,
    flavor: Literal["neighborhood", "utag", "cellcharter", "spatialleiden"],
    library_key: str | None = None,
    mask: Any = None,
    groups: str | None = None,
    n_neighbors: int | None = None,
    resolutions: float | tuple[float, float] | list[float | tuple[float, float]] | None = None,
    min_niche_size: int | None = None,
    scale: bool = True,
    abs_nhood: bool = False,
    distance: int | None = None,
    n_hop_weights: list[float] | None = None,
    aggregation: str | None = None,
    n_components: int | None = None,
    random_state: int = 42,
    spatial_connectivities_key: str = "spatial_connectivities",
    latent_connectivities_key: str = "connectivities",
    layer_ratio: float = 1.0,
    n_iterations: int = -1,
    use_weights: bool | tuple[bool, bool] = True,
    use_rep: str | None = None,
    inplace: bool = True,
    *,
    table_key: str | None = None,
) -> Any | None:
    """Calculate niches (spatial domains); the labels go to ``adata.obs``.

    Columns: ``nhood_niche_res={res}``, ``utag_niche_res={res}`` or
    ``cellcharter_niche`` (values prefixed ``lib={id}_`` with
    ``library_key``). ``mask`` is a boolean pandas Series indexed by the
    cells' names (or, on a container without names, a boolean array of the
    cells). Returns the container with the columns when ``inplace=False``.
    """
    if flavor == "cellcharter" and aggregation is None:
        aggregation = "mean"
    if distance is None:
        distance = 3 if flavor == "cellcharter" else 1
    if flavor == "cellcharter" and n_components is None:
        n_components = 10

    _validate_niche_args(data, flavor, library_key, table_key, groups, n_neighbors, resolutions, aggregation)

    if resolutions is None:
        resolutions = [0.5]

    adata = extract_adata_if_sdata(data, table_key=table_key)
    _assert_key(adata, spatial_connectivities_key, "obsp")
    if flavor == "spatialleiden":
        _assert_key(adata, latent_connectivities_key, "obsp")
        return _spatialleiden(data, adata, spatial_connectivities_key, latent_connectivities_key, resolutions,
                              layer_ratio, use_weights, n_iterations, random_state, inplace, table_key)

    result_columns = _get_result_columns(flavor=flavor, resolutions=resolutions)
    table = _Table.of(adata, spatial_connectivities_key)
    keep = _mask_rows(table, mask)
    args = {"flavor": flavor, "groups": groups, "n_neighbors": n_neighbors, "min_niche_size": min_niche_size,
            "scale": scale, "abs_nhood": abs_nhood, "n_hop_weights": n_hop_weights, "aggregation": aggregation,
            "n_components": n_components, "random_state": random_state, "use_rep": use_rep}

    if library_key is not None:
        _assert_key(adata, library_key, "obs")
        logger.info(f"Stratifying by library_key '{library_key}'")
        libs = _obs_values(adata, library_key)
        columns = {col: np.full(table.n, _NOT_A_NICHE, dtype=object) for col in result_columns}
        for lib_id in dict.fromkeys(libs.tolist()):
            rows = np.nonzero(libs == lib_id)[0]
            if len(rows) == 0:  # a NaN library matches no cell
                logger.warning(f"Library '{lib_id}' contains no cells, skipping")
                continue
            lib_cols = _niche_columns(
                table.subset(rows), keep=None if keep is None else keep[rows],
                resolutions=None if flavor == "cellcharter" else resolutions,
                distance=None if flavor == "utag" else distance, **args,
            )
            for col, values in lib_cols.items():
                columns[col][rows] = [v if v == _NOT_A_NICHE else f"lib={lib_id}_{v}" for v in values]
    else:
        columns = _niche_columns(table, keep=keep, resolutions=resolutions, distance=distance, **args)

    if not inplace or hasattr(data, "tables"):
        # the JAX package's copy: a neighborhood column is dropped and added
        # again, the others are assigned in place
        out = _copy_container(adata)
        _write_columns(out, columns, replace=flavor == "neighborhood" and library_key is None)
        if hasattr(data, "tables") and inplace:
            data.tables[table_key] = out
            return None
        return out
    for col in columns:
        if col in adata.obs:
            logger.info(f"Overwriting existing column '{col}'")
    _write_columns(adata, columns, replace=True)
    return None


def _get_result_columns(flavor: str, resolutions: Any) -> list[str]:
    if flavor == "cellcharter":
        return ["cellcharter_niche"]
    if not isinstance(resolutions, list):
        resolutions = [resolutions]
    prefix = {"neighborhood": "nhood_niche", "utag": "utag_niche", "spatialleiden": "spatialleiden"}[flavor]
    return [f"{prefix}_res={res}" for res in resolutions]


def _assert_key(adata: Any, key: str, attr: str) -> None:
    if key not in getattr(adata, attr):
        raise KeyError(f"Key `{key}` not found in `adata.{attr}`.")


def _is_frame(obs: Any) -> bool:
    return hasattr(obs, "columns") and hasattr(obs, "index")


def _obs_values(adata: Any, key: str) -> np.ndarray:
    """The values of an obs column as a numpy array (a categorical's codes
    turned into its categories)."""
    col = adata.obs[key]
    cat = getattr(col, "cat", None)
    if cat is not None and not _is_frame(adata.obs):
        return np.asarray(cat.categories, dtype=object)[np.asarray(cat.codes)]
    return np.asarray(col)


class _Table:
    """What the niche computations read of a container (or of one library
    of it): the adjacency, the cells' names, the obs columns, the
    expression and ``obsm``."""

    def __init__(self, adata: Any, adj: sps.csr_matrix, rows: np.ndarray | None = None) -> None:
        self._adata, self.adj, self._rows = adata, adj, rows
        self.n = adj.shape[0]
        self.uns: dict = {} if rows is not None else adata.uns
        self.raw = None

    @classmethod
    def of(cls, adata: Any, key: str) -> _Table:
        return cls(adata, sps.csr_matrix(adata.obsp[key]))

    def subset(self, rows: np.ndarray) -> _Table:
        return _Table(self._adata, self.adj[rows][:, rows].tocsr(), rows)

    def _take(self, values: Any) -> Any:
        return values if self._rows is None else values[self._rows]

    @property
    def obs_names(self) -> np.ndarray | None:
        index = getattr(self._adata.obs, "index", None)
        return None if index is None else self._take(np.asarray(index))

    def obs_values(self, key: str) -> np.ndarray:
        return self._take(_obs_values(self._adata, key))

    def obsm(self, key: str) -> np.ndarray:
        _assert_key(self._adata, key, "obsm")
        return self._take(np.asarray(self._adata.obsm[key]))

    @property
    def X(self) -> Any:  # noqa: N802 - the container's name
        x = self._adata.X
        if self._rows is None:
            return x
        return x[self._rows] if sps.issparse(x) else np.asarray(x)[self._rows]

    @property
    def var_names(self) -> list:
        return list(self._adata.var_names)


def _mask_rows(table: _Table, mask: Any) -> np.ndarray | None:
    """The cells a mask keeps, as a boolean array: a pandas Series by the
    cells' names, else an array of the cells."""
    if mask is None:
        return None
    if hasattr(mask, "index") and table.obs_names is not None:
        kept = np.asarray(mask.index)[np.asarray(mask, dtype=bool)]
        return np.isin(table.obs_names, kept)
    keep = np.asarray(mask, dtype=bool)
    if keep.shape != (table.n,):
        raise ValueError(f"Expected a mask of {table.n} cells, found shape {keep.shape}.")
    return keep


def _copy_container(adata: Any) -> Any:
    if hasattr(adata, "copy"):
        return adata.copy()
    out = copy.copy(adata)
    out.obs, out.uns = dict(adata.obs), dict(adata.uns)
    return out


def _write_columns(adata: Any, columns: dict[str, np.ndarray], replace: bool) -> None:
    """Write the result columns: on a pandas frame as the JAX package writes
    them (``replace``: drop an old column and its colours first, so the new
    one goes last), else as numpy arrays."""
    frame = _is_frame(adata.obs)
    for col, values in columns.items():
        if frame and col == "cellcharter_niche" and values.dtype != object:
            import pandas as pd

            values = pd.Categorical(values)
        elif frame:
            values = np.asarray(values, dtype=object)
        if replace:
            adata.uns.pop(f"{col}_colors", None)
            if frame and col in adata.obs.columns:
                del adata.obs[col]
        adata.obs[col] = values


def _niche_columns(table: _Table, *, flavor: str, keep: np.ndarray | None, resolutions: Any, distance: int | None,
                   groups: str | None, n_neighbors: int | None, min_niche_size: int | None, scale: bool,
                   abs_nhood: bool, n_hop_weights: list[float] | None, aggregation: str | None,
                   n_components: int | None, random_state: int, use_rep: str | None) -> dict[str, np.ndarray]:
    """One container's (or one library's) result columns, by column name."""
    if resolutions is None:
        resolutions = [0.5]
    if distance is None:
        distance = 3 if flavor == "cellcharter" else 1
    if flavor == "neighborhood":
        return _get_nhood_profile_niches(table, keep, groups, n_neighbors, resolutions, min_niche_size, scale,
                                         abs_nhood, distance, n_hop_weights, random_state)
    if flavor == "utag":
        return _get_utag_niches(table, n_neighbors, resolutions, random_state)
    return _get_cellcharter_niches(table, distance, aggregation, n_components, random_state, use_rep)


def _res_value(res: Any) -> float:
    return float(res) if not isinstance(res, tuple) else float(res[0])


def _device_X(table: _Table) -> torch.Tensor:
    """The (n, g) float32 expression on the device, through the cached
    device expression handle where it fits, else shipped dense."""
    handle = device_expression(table)
    if handle is not None:
        return handle.full_dense()
    x = table.X
    dense = np.asarray(x.todense()) if sps.issparse(x) else np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(dense, dtype=np.float32)).to(get_device())


def _category_codes(values: np.ndarray) -> tuple[np.ndarray, int]:
    """Each cell's position among the sorted distinct values, as the JAX
    package numbers the categories."""
    unique, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int64).ravel(), len(unique)


def _get_nhood_profile_niches(table: _Table, keep: np.ndarray | None, groups: str, n_neighbors: int,
                              resolutions: Any, min_niche_size: int | None, scale: bool, abs_nhood: bool,
                              distance: int, n_hop_weights: list[float] | None,
                              random_state: int) -> dict[str, np.ndarray]:
    """Neighbour-category profiles (and their weighted n-hop sums) -> clustering."""
    adj = table.adj
    if distance > 1:
        if n_hop_weights is None:
            n_hop_weights = [1] * distance
        elif len(n_hop_weights) < distance:
            n_hop_weights = n_hop_weights + [n_hop_weights[-1]] * (distance - len(n_hop_weights))
    codes, n_cats = _category_codes(table.obs_values(groups))

    if table.n >= _DEVICE_HOPS_MIN_N:
        # the profile stays on the device: z-scores and the kNN search follow there
        with record_function("calculate_niche.profiles"):
            features = _nhood_profiles_device(codes, n_cats, adj, abs_nhood, distance, n_hop_weights)
    else:
        profile = _neighborhood_profile(codes, n_cats, adj, abs_nhood)
        if distance > 1:
            weighted = n_hop_weights[0] * profile
            hop_adj = adj.copy()
            for n_hop in range(1, distance):
                hop_adj = hop_adj @ adj
                weighted = weighted + n_hop_weights[n_hop] * _neighborhood_profile(codes, n_cats, hop_adj, abs_nhood)
            if not abs_nhood:
                weighted = weighted / sum(n_hop_weights)
            profile = weighted
        features = profile.astype(float)

    if scale:
        with record_function("calculate_niche.zscore"):
            features = zscore(features)
    if keep is not None:
        features = features[torch.from_numpy(keep).to(features.device)] if isinstance(
            features, torch.Tensor) else np.asarray(features)[keep]

    columns = {}
    for res in resolutions if isinstance(resolutions, list) else [resolutions]:
        labels = graph_cluster(features, n_neighbors, resolution=_res_value(res), random_state=random_state)
        col = labels.astype(object)
        if keep is not None:
            col = np.full(table.n, _NOT_A_NICHE, dtype=object)
            col[keep] = labels
        if min_niche_size is not None:
            values, counts = np.unique(col.astype(str), return_counts=True)
            small = set(values[counts < min_niche_size])
            col = np.asarray([_NOT_A_NICHE if v in small else v for v in col], dtype=object)
        columns[f"nhood_niche_res={res}"] = col
    return columns


def _neighborhood_profile(codes: np.ndarray, n_cats: int, adj: sps.spmatrix, abs_nhood: bool) -> np.ndarray:
    """obs x category neighbour-category frequencies (absolute, or relative
    to the largest neighbour count); the stored entries, not their weights,
    make the neighbours."""
    adj = sps.csr_matrix(adj)
    n = adj.shape[0]
    deg = np.diff(adj.indptr)
    rows = np.repeat(np.arange(n), deg)
    abs_freq = np.zeros((n, n_cats), dtype=np.int64)
    np.add.at(abs_freq, (rows, codes[adj.indices]), 1)
    if abs_nhood:
        return abs_freq
    k = int(deg.max()) if n else 1
    return abs_freq / k


def _ell_k5a(idx: torch.Tensor, n: int, w: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A sentinel-padded ELL (index ``n``) as K5a takes it: padded slots at
    row 0 with weight 0 (binary weights unless ``w`` is given)."""
    live = idx < n
    weights = live.to(torch.float32) if w is None else torch.where(live, w, 0.0)
    return torch.where(live, idx, 0).contiguous(), weights.contiguous()


def _nhood_profiles_device(codes: np.ndarray, n_cats: int, adj: sps.spmatrix, abs_nhood: bool, distance: int,
                           n_hop_weights: list[float] | None) -> torch.Tensor:
    """The n-hop neighbour-category profiles on the device, (n, C) float32:
    the patterns of ``A^k`` from :func:`squidpy_torch.ops.hops.hop_reach`
    (K13), the per-category counts as products with the one-hot matrix
    (K5a); the counts are exact integers in float32."""
    from squidpy_torch.ops.autocorr import spmv_genes
    from squidpy_torch.ops.hops import ell_sentinel, hop_reach

    n = adj.shape[0]
    dev = get_device()
    onehot = torch.from_numpy(np.eye(n_cats, dtype=np.float32)[codes]).to(dev)
    bi, bw = ell_sentinel(adj)
    bi_d, bw_d = torch.from_numpy(bi).to(dev), torch.from_numpy(bw).to(dev)

    def profile_of(idx: torch.Tensor, deg_max: int) -> torch.Tensor:
        counts = spmv_genes(*_ell_k5a(idx, n), onehot)
        return counts if abs_nhood else counts / deg_max

    deg1 = int(np.diff(adj.indptr).max()) if n else 1
    profile = profile_of(bi_d, deg1)
    if distance > 1:
        weighted = n_hop_weights[0] * profile
        with record_function("calculate_niche.hops"):
            reach = hop_reach(bi_d, bw_d, distance)
        for n_hop, (idx, deg) in enumerate(reach, start=1):
            weighted = weighted + n_hop_weights[n_hop] * profile_of(idx, int(deg.max()))
        if not abs_nhood:
            weighted = weighted / sum(n_hop_weights)
        profile = weighted
    return profile


def _get_utag_niches(table: _Table, n_neighbors: int, resolutions: Any, random_state: int) -> dict[str, np.ndarray]:
    """UTAG: the row-normalised ``A @ X`` (K5a), PCA, clustering; the
    smoothed matrix stays on the device."""
    with record_function("calculate_niche.expression"):
        x_dev = _device_X(table)
    with record_function("calculate_niche.smoothing"):
        smoothed = SpatialGraph.from_csr(table.adj, dtype=np.float32).row_normalize().spmv(x_dev)
    del x_dev
    emb = pca_embed(smoothed)
    del smoothed
    columns = {}
    for res in resolutions if isinstance(resolutions, list) else [resolutions]:
        labels = graph_cluster(emb, n_neighbors, resolution=_res_value(res), random_state=random_state)
        columns[f"utag_niche_res={res}"] = labels.astype(object)
    return columns


def _get_cellcharter_niches(table: _Table, distance: int, aggregation: str, n_components: int, random_state: int,
                            use_rep: str | None = None) -> dict[str, np.ndarray]:
    """CellCharter: k-hop aggregated features -> embedding -> GMM, on the
    device end to end."""
    adjacency_matrix = table.adj
    with record_function("calculate_niche.expression"):
        x_dev = _device_X(table)
    if table.n >= _DEVICE_HOPS_MIN_N:
        with record_function("calculate_niche.features"):
            arr = _cellcharter_hop_features(adjacency_matrix, x_dev, distance, aggregation)
    else:
        aggregated = []
        adj_hop = _setdiag(adjacency_matrix, 0)
        adj_visited = _setdiag(adjacency_matrix.copy(), 1)
        for k in range(distance + 1):
            if k == 0:
                aggregated.append(x_dev)
                continue
            if k > 1:
                adj_hop, adj_visited = _hop(adj_hop, adjacency_matrix, adj_visited)
            graph = SpatialGraph.from_csr(sps.csr_matrix(_normalize(adj_hop)), dtype=np.float32)
            mean_m = graph.spmv(x_dev)
            if aggregation == "mean":
                aggregated.append(mean_m)
            elif aggregation == "variance":
                aggregated.append(graph.spmv(x_dev * x_dev) - mean_m * mean_m)
            else:
                raise ValueError(
                    f"Invalid aggregation method '{aggregation}'. Please choose either 'mean' or 'variance'."
                )
        arr = torch.cat(aggregated, dim=1)
    del x_dev

    if use_rep is not None:
        embedding = table.obsm(use_rep)
        if embedding.shape[1] < n_components:
            raise ValueError(
                f"Embedding has {embedding.shape[1]} components, but n_components={n_components}. "
                f"Please provide an embedding with at least {n_components} components."
            )
        embedding = embedding[:, :n_components]
    else:
        logger.warning(
            "CellCharter recommends a dimensionality-reduced embedding (e.g. scVI). "
            "'use_rep' not provided — PCA will be used as proxy."
        )
        embedding = pca_embed(arr)
    del arr
    return {"cellcharter_niche": np.asarray(gmm_cluster(embedding, n_components, random_state))}


def _cellcharter_hop_features(adjacency_matrix: sps.spmatrix, x_dev: torch.Tensor, distance: int,
                              aggregation: str) -> torch.Tensor:
    """The k-hop ring aggregation on the device: the numbers of the host
    ``_setdiag``/``_hop``/``_normalize`` chain, with the exact rings from
    :func:`squidpy_torch.ops.hops.hop_rings` (K13) and every product by K5a."""
    from squidpy_torch.ops.autocorr import spmv_genes
    from squidpy_torch.ops.hops import ell_sentinel, hop_rings

    if aggregation not in ("mean", "variance"):
        raise ValueError(f"Invalid aggregation method '{aggregation}'. Please choose either 'mean' or 'variance'.")
    n = adjacency_matrix.shape[0]
    dev = x_dev.device
    bi, bw = ell_sentinel(adjacency_matrix)
    bi_d, bw_d = torch.from_numpy(bi).to(dev), torch.from_numpy(bw).to(dev)
    # hop 1 = setdiag(A, 0), row-normalised by the weighted degree (_normalize)
    self_col = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    r1_idx = torch.where(bi_d == self_col, n, bi_d)
    r1_w = torch.where(r1_idx < n, bw_d, 0.0)
    rs = r1_w.sum(dim=1, keepdim=True)
    hops = [(r1_idx, torch.where(rs > 0, r1_w / rs, 0.0))]
    if distance >= 2:
        with record_function("calculate_niche.hops"):
            rings = hop_rings(bi_d, bw_d, distance)
        for idx, deg in rings:
            d = torch.clamp_min(deg.to(torch.float32), 1.0)[:, None]
            hops.append((idx, torch.where(idx < n, 1.0 / d, 0.0)))

    feats = [x_dev]
    sq = x_dev * x_dev if aggregation == "variance" else None
    for idx, w in hops:
        ell = _ell_k5a(idx, n, w)
        mean_m = spmv_genes(*ell, x_dev)
        feats.append(mean_m if sq is None else spmv_genes(*ell, sq) - mean_m * mean_m)
    return torch.cat(feats, dim=1)


def _spatialleiden(data: Any, adata: Any, spatial_connectivities_key: str, latent_connectivities_key: str,
                   resolutions: Any, layer_ratio: float, use_weights: Any, n_iterations: int, random_state: int,
                   inplace: bool, table_key: str | None) -> Any | None:
    """The ``spatialleiden`` flavor, on a copy of the container, through the
    optional package."""
    try:
        import spatialleiden as sl
    except ImportError as e:
        raise ImportError("Please install the spatialleiden algorithm: `pip install spatialleiden`.") from e
    out = _copy_container(adata)
    columns = {}
    for res in resolutions if isinstance(resolutions, list) else [resolutions]:
        key = f"spatialleiden_res={res}"
        sl.spatialleiden(
            out, resolution=res, use_weights=use_weights, n_iterations=n_iterations, layer_ratio=layer_ratio,
            latent_neighbors_key=latent_connectivities_key, spatial_neighbors_key=spatial_connectivities_key,
            random_state=random_state, directed=False, key_added=key,
        )
        columns[key] = out.obs[key]
    if not inplace:
        return out
    if hasattr(data, "tables"):
        data.tables[table_key] = out
        return None
    for key, values in columns.items():
        adata.obs[key] = values
    return None


# -- sparse helpers (copied from the JAX package) ----------------------------

def _setdiag(adjacency_matrix: sps.spmatrix, value: int) -> sps.csr_matrix:
    adjacency_matrix = adjacency_matrix.tolil()
    adjacency_matrix.setdiag(value)
    adjacency_matrix = adjacency_matrix.tocsr()
    if value == 0:
        adjacency_matrix.eliminate_zeros()
    return adjacency_matrix


def _hop(adj_hop: sps.spmatrix, adj: sps.spmatrix, adj_visited: sps.spmatrix | None = None
         ) -> tuple[sps.spmatrix, sps.spmatrix]:
    adj_hop = adj_hop @ adj
    if adj_visited is not None:
        adj_hop = (adj_hop > adj_visited).astype(float)
        adj_visited = adj_visited + adj_hop
    return adj_hop, adj_visited


def _normalize(adj: sps.spmatrix) -> sps.spmatrix:
    deg = np.asarray(adj.sum(axis=1)).squeeze()
    with np.errstate(divide="ignore"):
        deg_inv = 1.0 / deg
    deg_inv[~np.isfinite(deg_inv)] = 0
    return sps.spdiags(deg_inv, 0, len(deg_inv), len(deg_inv)) @ adj


# -- niche metrics (copied from the JAX package; pandas and sklearn imported here) --

def _fide_score(adata: Any, niche_key: str, average: bool) -> Any:
    """F1-score of intra-domain edges: high = spatially continuous niches."""
    from sklearn.metrics import f1_score

    i, j = adata.obsp["spatial_connectivities"].nonzero()
    niche_labels = adata.obs.iloc[i][niche_key]
    neighbor_labels = adata.obs.iloc[j][niche_key]
    return f1_score(niche_labels, neighbor_labels, average="macro" if average else None)


def _jensen_shannon_divergence(adata: Any, niche_key: str, library_key: str) -> Any:
    """Mean pairwise Jensen-Shannon distance of the niche-label
    distributions across slides (0 for one slide)."""
    from scipy.spatial import distance as sp_distance

    niche_labels = sorted(adata.obs[niche_key].unique())
    dists = []
    for _, slide in adata.obs.groupby(library_key, observed=True):
        counts = slide[niche_key].value_counts(normalize=True)
        dists.append([counts.get(label, 0) for label in niche_labels])
    arr = np.array(dists)
    if len(arr) < 2:
        return 0.0
    vals = [sp_distance.jensenshannon(arr[i], arr[j]) for i in range(len(arr)) for j in range(i + 1, len(arr))]
    return float(np.mean(vals))


def _validate_niche_args(data: Any, flavor: str, library_key: str | None, table_key: str | None,
                         groups: str | None, n_neighbors: int | None, resolutions: Any,
                         aggregation: str | None) -> None:
    if flavor not in ("neighborhood", "utag", "cellcharter", "spatialleiden"):
        raise ValueError(
            f"Invalid flavor `{flavor!r}`. Valid options: "
            f"['neighborhood', 'utag', 'cellcharter', 'spatialleiden']."
        )
    if hasattr(data, "tables") and table_key is None:
        raise TypeError("missing required keyword-only argument: 'table_key'")
    if flavor == "neighborhood":
        if groups is None:
            raise ValueError("flavor='neighborhood' requires `groups`.")
        if n_neighbors is None:
            raise ValueError("flavor='neighborhood' requires `n_neighbors`.")
        if resolutions is None:
            raise ValueError("flavor='neighborhood' requires `resolutions`.")
    if flavor == "utag":
        if n_neighbors is None:
            raise ValueError("flavor='utag' requires `n_neighbors`.")
        if resolutions is None:
            raise ValueError("flavor='utag' requires `resolutions`.")
    if flavor == "cellcharter" and aggregation not in ("mean", "variance"):
        raise ValueError(
            f"Invalid aggregation method '{aggregation}'. Please choose either 'mean' or 'variance'."
        )
