"""Point-pattern statistics: spatial autocorrelation and co-occurrence
(counterpart of ``squidpy_tpu/gr/_ppatterns.py``).

Scores and permutation nulls run on the device (:mod:`squidpy_torch.ops.autocorr`,
kernels K5a and K5b; co-occurrence in :mod:`squidpy_torch.ops.cooccur` and
:mod:`squidpy_torch.ops.dense_pairs`); the analytic moments, p-values and
multiple-testing corrections are host numpy, copied from the JAX package.
Results are plain numpy containers, not pandas.
"""

from __future__ import annotations

import logging
from collections.abc import Sequence
from typing import Any, Literal, NamedTuple

import numpy as np
import torch
from scipy import sparse as sp
from scipy import stats
from torch.profiler import record_function

from squidpy_torch._constants._constants import BF16_GATHER_MIN_N, SpatialAutocorr
from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.device_x import device_expression
from squidpy_torch._core.graph import SpatialGraph, locality_walk, walk_buckets
from squidpy_torch._core.index_cipher import MIN_CIPHER_N, cipher_index_batch
from squidpy_torch._core.rng import permutation_batch, spawn_keys
from squidpy_torch._device import NDArrayA, assert_positive, get_device, to_host
from squidpy_torch.gr._utils import (
    _assert_categorical_obs,
    _assert_connectivity_key,
    _assert_spatial_basis,
    _categorical_codes,
    _save_data,
    _take_columns,
    _var_positions,
    extract_adata_if_sdata,
)
from squidpy_torch.ops.autocorr import (
    geary_perm_scores,
    geary_scores,
    geary_scores_bucketed,
    geary_scores_from_u,
    moran_perm_scores,
    moran_scores,
    moran_scores_bucketed,
    moran_scores_from_u,
    spmv_genes,
    spmv_genes_bucketed,
)
from squidpy_torch.ops.cooccur import co_occurrence_counts, co_occurrence_probs
from squidpy_torch.ops.dense_pairs import MAX_CLASSES, dense_pair_counts
from squidpy_torch.utils._memoize import memoize_arrays
from squidpy_torch.utils._stats import multipletests
from squidpy_torch.utils._utils import deprecated_params

__all__ = ["AutocorrResult", "co_occurrence", "spatial_autocorr"]

logger = logging.getLogger(__name__)

CACHE_MAX_BYTES = 512e6  # an expression matrix above this is not fingerprinted for `cache`


class AutocorrResult(NamedTuple):
    """The JAX package's result DataFrame without pandas.

    ``index`` holds the feature names in the DataFrame's row order;
    ``columns`` maps each column name (``I``/``C``, ``pval_norm``,
    ``var_norm``, ``pval_z_sim``, ``pval_sim``, ``var_sim``, the corrected
    p-values) to its values in that row order, in the DataFrame's column
    order.
    """

    index: NDArrayA
    columns: dict[str, NDArrayA]


def _to_dense_block(x: Any, col_slice: slice) -> np.ndarray:
    block = x[:, col_slice]
    if sp.issparse(block):
        block = block.toarray()
    return np.ascontiguousarray(np.asarray(block, dtype=np.float32))


def _is_numeric(col: Any) -> bool:
    """A numeric, non-categorical, non-boolean obs column (pandas'
    ``select_dtypes(include=np.number)``)."""
    return getattr(col, "cat", None) is None and np.issubdtype(np.asarray(col).dtype, np.number)


def _sort_order(values: NDArrayA, ascending: bool) -> NDArrayA:
    """The row order of pandas' ``sort_values`` on one float column: its
    default quicksort over the non-NaN values (reversed around the sort when
    descending, as pandas does), NaN last in both directions."""
    mask = np.isnan(values)
    idx = np.arange(len(values))
    non_nans, non_nan_idx = values[~mask], idx[~mask]
    if not ascending:
        non_nans, non_nan_idx = non_nans[::-1], non_nan_idx[::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")]
    if not ascending:
        order = order[::-1]
    return np.concatenate([order, np.nonzero(mask)[0]])


def spatial_autocorr(
    adata: Any,
    connectivity_key: str = Key.obsp.spatial_conn(),
    genes: str | int | Sequence[str] | Sequence[int] | None = None,
    mode: SpatialAutocorr | Literal["moran", "geary"] = "moran",
    transformation: bool = True,
    n_perms: int | None = None,
    two_tailed: bool = False,
    corr_method: str | None = "fdr_bh",
    attr: Literal["obs", "X", "obsm"] = "X",
    layer: str | None = None,
    seed: int | None = None,
    use_raw: bool = False,
    copy: bool = False,
    n_jobs: int | None = None,
    backend: str = "loky",
    show_progress_bar: bool = True,
    *,
    table_key: str | None = None,
    gene_block_size: int | None = None,
    cache: bool | str = False,
) -> AutocorrResult | None:
    """Global spatial autocorrelation (Moran's I or Geary's C) per feature.

    Scores are one ELL pass per gene block (kernel K5a); with ``n_perms``
    the pass computes ``u = W z`` once and every permutation is a gather-dot
    over it (kernel K5b). Shuffles are the JAX package's: its sort shuffles
    below 65,536 cells, its index cipher (kernel K4) above. From
    ``BF16_GATHER_MIN_N`` cells on, the null's operands are bf16, as the JAX
    package gathers them there. Analytic
    p-values follow Cliff & Ord. ``n_jobs``, ``backend`` and
    ``show_progress_bar`` are accepted for API compatibility and ignored.
    ``cache`` (``True`` or a directory) keeps the scores and the null on
    disk, keyed by the graph, the expression, seed, permutations and
    transformation: it needs a ``seed`` when ``n_perms`` is set, and is
    turned off (with a warning) for an expression matrix above 512 MB.

    Stores (or, with ``copy``, returns) an :class:`AutocorrResult` under
    ``uns['moranI']`` / ``uns['gearyC']``.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    _assert_connectivity_key(adata, connectivity_key)
    mode = SpatialAutocorr(mode)

    def extract_x(genes: Any) -> tuple[Any, list[Any]]:
        if genes is None:
            var = getattr(adata, "var", {})
            names = np.asarray(adata.var_names)
            genes = names[np.asarray(var["highly_variable"], dtype=bool)] if "highly_variable" in var else names
        elif isinstance(genes, str):
            genes = [genes]
        genes = list(genes)
        if not use_raw:
            x = adata.X if layer is None else adata.layers[layer]
            return _take_columns(x, _var_positions(adata.var_names, genes)), genes
        if adata.raw is None:
            raise AttributeError("No `.raw` attribute found. Try specifying `use_raw=False`.")
        raw_names = set(np.asarray(adata.raw.var_names).tolist())
        genes = [g for g in genes if g in raw_names]
        return _take_columns(adata.raw.X, _var_positions(adata.raw.var_names, genes)), genes

    def extract_obs(cols: Any) -> tuple[Any, list[Any]]:
        if cols is None:
            cols = [c for c in adata.obs if _is_numeric(adata.obs[c])]
        elif isinstance(cols, str):
            cols = [cols]
        cols = list(cols)
        n_obs = adata.obsp[connectivity_key].shape[0]
        vals = np.column_stack([np.asarray(adata.obs[c]) for c in cols]) if cols else np.empty((n_obs, 0))
        return vals, cols

    def extract_obsm(ixs: Any) -> tuple[Any, list[Any]]:
        if layer not in adata.obsm:
            raise KeyError(f"Key `{layer}` not found in `adata.obsm`.")
        arr = np.asarray(adata.obsm[layer])
        ixs = list(np.arange(arr.shape[1])) if ixs is None else list(np.ravel([ixs]))
        return arr[:, ixs], ixs

    if attr == "X":
        vals, index = extract_x(genes)
    elif attr == "obs":
        vals, index = extract_obs(genes)
    elif attr == "obsm":
        vals, index = extract_obsm(genes)
    else:
        raise NotImplementedError(f"Extracting from `adata.{attr}` is not yet implemented.")

    # X ships to the device once (narrowest lossless container) and every
    # gene block is sliced or densified there. Each step below runs in a
    # named profiler range, so a profile splits the call's host time.
    dev_handle = dev_cols = None
    if attr == "X":
        holder = adata.raw if use_raw else adata
        with record_function("spatial_autocorr.device_expression"):
            dev_handle = device_expression(
                adata, layer=layer, use_raw=use_raw,
                # a small gene subset does not force the whole matrix onto the
                # device; an already-cached handle is reused either way
                create=2 * len(index) >= len(holder.var_names),
            )
            if dev_handle is not None:
                dev_cols = dev_handle.columns_of(list(map(str, index)))

    stat, ascending = ("I", False) if mode == SpatialAutocorr.MORAN else ("C", True)
    n_cells, n_feats = vals.shape
    expected = -1.0 / (n_cells - 1) if mode == SpatialAutocorr.MORAN else 1.0

    with record_function("spatial_autocorr.csr_normalize"):
        g_csr = sp.csr_matrix(adata.obsp[connectivity_key], copy=True)
        if transformation:  # l1 row-normalize
            row_sums = np.asarray(g_csr.sum(axis=1)).ravel()
            scale = np.divide(1.0, row_sums, out=np.zeros_like(row_sums, dtype=float), where=row_sums != 0)
            g_csr = sp.csr_matrix(sp.diags(scale) @ g_csr)

    device = get_device()
    with record_function("spatial_autocorr.from_csr"):
        graph = SpatialGraph.from_csr(g_csr, dtype=np.float32)
    # skewed-degree graphs run the ELL passes per degree bucket, so rows pay
    # their own k_b, not the global k_max (None for kNN graphs)
    with record_function("spatial_autocorr.degree_buckets"):
        buckets = graph.degree_buckets()
    # on the card K5a walks the rows (of each bucket) in the cells' Morton
    # order (None elsewhere); u = W z is the same in any row order
    with record_function("spatial_autocorr.walk"):
        walk = locality_walk(adata, graph.indices.shape[0], device)
        if walk is not None and buckets is not None:
            buckets = walk_buckets(buckets, walk)

    def _spmv(y: torch.Tensor) -> torch.Tensor:
        if buckets is not None:
            return spmv_genes_bucketed(buckets, y)
        return spmv_genes(graph.indices, graph.weights, y, walk=walk)

    def _scores(y: torch.Tensor) -> torch.Tensor:
        if mode == SpatialAutocorr.MORAN:
            return moran_scores_bucketed(buckets, y, s0) if buckets is not None else moran_scores(
                graph.indices, graph.weights, y, s0, walk=walk)
        return geary_scores_bucketed(buckets, y, s0) if buckets is not None else geary_scores(
            graph.indices, graph.weights, y, s0, walk=walk)

    s0 = float(g_csr.sum())
    if s0 == 0.0:
        # edgeless graph: the statistic is undefined; NaN, as the reference's 0/0
        s0 = float("nan")
    if gene_block_size is None:
        # the JAX package's sizing (a 16 GB card): 512-gene blocks unless the
        # (n_cells, block) buffer passes ~2.5 GB
        gene_block_size = int(np.clip(2.5e9 // max(4 * n_cells, 1), 64, 512))

    if n_perms is not None:
        assert_positive(n_perms, name="n_perms")

    def _score_blocks() -> dict[str, np.ndarray]:
        perms = None
        if n_perms is not None:
            with record_function("spatial_autocorr.permutations"):
                keys = spawn_keys(seed, n_perms)
                if n_cells >= MIN_CIPHER_N:
                    perms = cipher_index_batch(keys, n_cells)  # O(n) keyed index cipher, kernel K4
                else:
                    perms = permutation_batch(keys, n_cells, device)

        row_sums_dev = torch.from_numpy(np.asarray(g_csr.sum(axis=1), dtype=np.float32).ravel()).to(device)
        col_sums_dev = torch.from_numpy(np.asarray(g_csr.sum(axis=0), dtype=np.float32).ravel()).to(device)
        # the null's operands: bf16 at scale, as the JAX package gathers them
        # (its sims denominator then comes from the bf16 z; scores and cg never)
        gather_dtype = torch.bfloat16 if n_cells >= BF16_GATHER_MIN_N else torch.float32
        score_parts: list[np.ndarray] = []
        sims_parts: list[np.ndarray] = []
        with record_function("spatial_autocorr.gene_blocks"):
            for start_col in range(0, n_feats, gene_block_size):
                if dev_cols is not None:
                    xb = dev_handle.dense_block(dev_cols[start_col : start_col + gene_block_size])
                else:
                    xb = torch.from_numpy(_to_dense_block(vals, slice(start_col, start_col + gene_block_size)))
                    xb = xb.to(device)
                if perms is None:
                    score_parts.append(to_host(_scores(xb)))
                    continue
                # the permutation identities need u = W z: one ELL pass serves the
                # observed score and the null
                zb = xb - torch.mean(xb, dim=0, keepdim=True)
                del xb
                ub = _spmv(zb)
                zg, ug = zb.to(gather_dtype), ub.to(gather_dtype)
                if mode == SpatialAutocorr.MORAN:
                    score_parts.append(to_host(moran_scores_from_u(zb, ub, s0)))
                    sims_parts.append(to_host(moran_perm_scores(zg, ug, perms, s0)))
                else:
                    score_parts.append(to_host(geary_scores_from_u(zb, ub, row_sums_dev, col_sums_dev, s0)))
                    cg = torch.sum(col_sums_dev[:, None] * (zb * zb), dim=0)  # permutation-invariant third term
                    sims_parts.append(to_host(geary_perm_scores(zg, ug, row_sums_dev.to(gather_dtype), cg, perms, s0)))
        out = {"score": np.concatenate(score_parts).astype(np.float64) if score_parts else np.empty(0)}
        if sims_parts:
            out["sims"] = np.concatenate(sims_parts, axis=1).astype(np.float64)
        return out

    if cache:
        if n_perms is not None and seed is None:
            logger.warning("`cache` requires an explicit `seed`; caching is disabled for this call")
            cache = False
        elif (vals.data.nbytes if sp.issparse(vals) else np.asarray(vals).nbytes) > CACHE_MAX_BYTES:
            logger.warning("`cache`: expression matrix too large to fingerprint cheaply; caching is disabled")
            cache = False
    if cache:
        memo_arrays: dict[str, Any] = {"g_data": g_csr.data, "g_indices": g_csr.indices, "g_indptr": g_csr.indptr}
        if sp.issparse(vals):
            v = vals.tocsr()
            memo_arrays.update(x_data=v.data, x_indices=v.indices, x_indptr=v.indptr)
        else:
            memo_arrays["x"] = np.asarray(vals)
        result = memoize_arrays(cache, f"spatial_autocorr_{mode.s}", memo_arrays,
                                {"seed": seed, "n_perms": n_perms, "transformation": transformation}, _score_blocks)
    else:
        result = _score_blocks()
    score = result["score"]
    sims = result.get("sims")

    with record_function("spatial_autocorr.pvalues"), np.errstate(divide="ignore", invalid="ignore"):
        pvals = _score_pvalues(score, sims, g_csr, mode=mode, expected=expected, two_tailed=two_tailed)
    columns: dict[str, NDArrayA] = {stat: score}
    columns.update({k: np.broadcast_to(np.asarray(v, dtype=np.float64), score.shape).copy() for k, v in pvals.items()})
    if corr_method is not None:
        for pv in [c for c in columns if "pval" in c]:
            columns[f"{pv}_{corr_method}"] = multipletests(columns[pv], alpha=0.05, method=corr_method)[1]

    with record_function("spatial_autocorr.sort"):
        order = _sort_order(score, ascending)
    result = AutocorrResult(index=np.asarray(index)[order], columns={k: v[order] for k, v in columns.items()})
    if copy:
        return result
    _save_data(adata, attr="uns", key=mode.s + stat, data=result)
    return None


@deprecated_params({"n_splits": "1.10.0", "n_jobs": "1.10.0", "backend": "1.10.0", "show_progress_bar": "1.10.0"})
def co_occurrence(
    adata: Any,
    cluster_key: str,
    spatial_key: str = Key.obsm.spatial,
    interval: int | NDArrayA = 50,
    copy: bool = False,
    *,
    table_key: str | None = None,
    use_pallas: bool = False,
) -> tuple[NDArrayA, NDArrayA] | None:
    """Co-occurrence probability of clusters across distance thresholds.

    At 100k cells and above the pair counts come from the binned sweep
    (kernel K1); below, from the dense triangular sweep. ``use_pallas=True``
    counts every pair with the dense expanded-form kernel K2 (the JAX
    package's Pallas kernel), for at most 128 clusters. Stores
    ``uns['{cluster_key}_co_occurrence'] = {'occ', 'interval'}``.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    _assert_categorical_obs(adata, key=cluster_key)
    _assert_spatial_basis(adata, key=spatial_key)

    spatial = np.asarray(adata.obsm[spatial_key], dtype=np.float32)
    labs, n_cls = _categorical_codes(adata, cluster_key)
    if use_pallas and n_cls > MAX_CLASSES:
        raise ValueError(f"`use_pallas=True` takes at most {MAX_CLASSES} clusters, found {n_cls}.")

    if isinstance(interval, int):
        thresh_min, thresh_max = _find_min_max(spatial)
        interval = np.linspace(thresh_min, thresh_max, num=interval, dtype=np.float32)
    else:
        interval = np.asarray(sorted(interval), dtype=np.float32)
    if len(interval) <= 1:
        raise ValueError(f"Expected interval to be of length `>= 2`, found `{len(interval)}`.")

    thresholds = (interval[1:].astype(np.float64) ** 2).astype(np.float32)
    if use_pallas:
        counts = dense_pair_counts(spatial, labs, thresholds, n_cls)
    else:
        counts = co_occurrence_counts(spatial, labs, thresholds, n_cls)
    out = co_occurrence_probs(counts)

    if copy:
        return out, interval
    _save_data(adata, attr="uns", key=Key.uns.co_occurrence(cluster_key), data={"occ": out, "interval": interval})
    return None


def _find_min_max(spatial: NDArrayA) -> tuple[float, float]:
    """Distance-threshold heuristics (copied from the JAX package)."""
    coord_sum = np.sum(spatial, axis=1)
    min_idx, min_idx2 = np.argpartition(coord_sum, 2)[:2]
    max_idx = np.argmax(coord_sum)
    thres_max = float(np.linalg.norm(spatial[min_idx] - spatial[max_idx])) / 2.0
    thres_min = float(np.linalg.norm(spatial[min_idx] - spatial[min_idx2]))
    return np.float32(thres_min), np.float32(thres_max)


def _normality_variance(w: Any, mode: SpatialAutocorr) -> float:
    """Variance of the statistic under the normality assumption (Cliff & Ord
    1981, copied from the JAX package), in terms of ``S0 = sum w_ij``,
    ``S1 = 1/2 sum (w_ij + w_ji)^2`` and ``S2 = sum_i (sum_j w_ij + sum_j w_ji)^2``;
    Geary's C has its own variance, distinct from Moran's."""
    n = w.shape[0]
    s0 = float(w.sum())
    if s0 == 0.0:  # edgeless graph: variance undefined
        return float("nan")
    sym = w + w.transpose()
    sym_sq = sym.multiply(sym) if sp.issparse(sym) else np.multiply(sym, sym)
    s1 = float(sym_sq.sum()) / 2.0
    degree = np.asarray(w.sum(axis=1)).ravel() + np.asarray(w.sum(axis=0)).ravel()
    s2 = float(np.square(degree).sum())
    if mode == SpatialAutocorr.MORAN:
        mean_sq = 1.0 / (n - 1) ** 2  # E[I]^2 under H0
        return (n * n * s1 - n * s2 + 3.0 * s0 * s0) / ((n * n - 1) * s0 * s0) - mean_sq
    return ((n - 1) * (2.0 * s1 + s2) - 4.0 * s0 * s0) / (2.0 * (n + 1) * s0 * s0)


def _directional_tail(z: NDArrayA) -> NDArrayA:
    """P(Z beyond z) in the direction z points: the one-tailed p-value."""
    return np.asarray(stats.norm.cdf(-np.abs(z)))


def _score_pvalues(
    score: NDArrayA, sims: NDArrayA | None, w: Any, *, mode: SpatialAutocorr, expected: float, two_tailed: bool
) -> dict[str, Any]:
    """Analytic (normality) and permutation p-values (copied from the JAX
    package): ``pval_norm``/``var_norm`` always, ``pval_z_sim``/``pval_sim``/
    ``var_sim`` for a null ``sims`` of shape ``(n_perms, n_feats)``;
    ``pval_z_sim`` stays one-tailed regardless of ``two_tailed``."""
    with record_function("spatial_autocorr.normality_variance"):
        var_norm = _normality_variance(w, mode)
    z_norm = (score - expected) / np.sqrt(var_norm)
    p_norm = _directional_tail(z_norm)
    if two_tailed:
        p_norm = p_norm * 2.0
    out: dict[str, Any] = {"pval_norm": p_norm, "var_norm": var_norm}
    if sims is not None:
        n_perms = sims.shape[0]
        z_sim = (score - sims.mean(axis=0)) / sims.std(axis=0)
        out["pval_z_sim"] = _directional_tail(z_sim)
        n_ge = (sims >= score).sum(axis=0)
        # count the smaller tail, i.e. how extreme the observed score is
        tail_count = np.minimum(n_ge, n_perms - n_ge)
        out["pval_sim"] = (tail_count + 1) / (n_perms + 1)
        out["var_sim"] = sims.var(axis=0)
    return out
