"""Ripley's F, G and L statistics (counterpart of ``squidpy_tpu/gr/_ripley.py``).

Same support (convex hull area, ``max_dist = sqrt(area / 2)``), the same
F/G/L definitions, Monte-Carlo envelope and seeded streams as the JAX
package. Nearest-neighbour searches run as kernel K8 and pair counts as K7
(or K1 for a cluster of 100,000 points or more), the whole envelope in one
launch; the hull, the point-process sampling, the ECDFs and the p-values
are host numpy, copied. The long tables are :class:`RipleyTable`s, not
DataFrames.
"""

from __future__ import annotations

from typing import Any, Literal, NamedTuple

import numpy as np
from scipy.spatial import ConvexHull
from torch.profiler import record_function

from squidpy_torch._constants._constants import RipleyStat
from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._device import NDArrayA
from squidpy_torch.gr._utils import (
    _assert_categorical_obs,
    _assert_spatial_basis,
    _save_data,
    extract_adata_if_sdata,
)
from squidpy_torch.ops.knn import cross_knn
from squidpy_torch.ops.ripley import batched_nn_distances, batched_pair_counts, pair_counts_cumulative, ppp_sample

__all__ = ["RipleyTable", "ripley"]


class RipleyTable(NamedTuple):
    """The JAX package's long DataFrame (``pd.melt`` of a bins x columns
    table) without pandas, row for row: ``bins`` and ``stats`` are its
    ``bins`` and ``stats`` columns; ``name`` is the name of its middle
    column (the cluster key, or ``simulations``), ``values`` that column's
    values and ``categories`` the categories ``astype('category')`` gives
    it (its sorted unique values)."""

    bins: NDArrayA
    name: str
    values: NDArrayA
    categories: NDArrayA
    stats: NDArrayA


def _ecdf(distances: NDArrayA, support: NDArrayA) -> NDArrayA:
    """Empirical CDF of NN distances over the support bins (normalized by
    the in-range count, matching the reference's histogram construction)."""
    counts, _ = np.histogram(distances, bins=support)
    return np.concatenate(([0.0], np.cumsum(counts) / counts.sum()))


def _ecdf_rows(distances: NDArrayA, support: NDArrayA) -> NDArrayA:
    """Row-wise `_ecdf` for a (S, m) distance matrix → (S, n_steps).

    One searchsorted pass over all simulations; bin semantics match
    ``np.histogram(bins=support)`` exactly: right-open bins, the last bin
    closed, out-of-range values dropped. The JAX package's ``np.add.at``
    becomes one ``np.bincount`` of (row, bin) ids, the same integer counts:
    at an envelope of 1M queries (1e8 distances) it was the call's slowest
    host step (PERF.md)."""
    L = len(support)
    idx = np.searchsorted(support, distances, side="right")
    idx = np.where(distances == support[-1], L - 1, idx)  # closed last bin
    valid = (idx >= 1) & (idx <= L - 1)
    S = distances.shape[0]
    ids = (np.arange(S)[:, None] * (L - 1) + (idx - 1))[valid]
    counts = np.bincount(ids, minlength=S * (L - 1)).reshape(S, L - 1)
    denom = counts.sum(axis=1, keepdims=True).astype(float)
    cdf = np.cumsum(counts, axis=1) / denom
    return np.concatenate([np.zeros((S, 1)), cdf], axis=1)


def _l_transform(ordered_pairs: NDArrayA, n: int, area: float) -> NDArrayA:
    """Variance-stabilized L from cumulative ordered pair counts."""
    k_estimate = (ordered_pairs / n) * (area / n)
    return np.sqrt(k_estimate / np.pi)


def _reshape_res(results: NDArrayA, columns: Any, index: NDArrayA, var_name: str) -> RipleyTable:
    """``pd.DataFrame(results, columns, index).melt(...)`` as a
    :class:`RipleyTable`: one row a (column, bin), column-major."""
    columns = np.asarray(columns)
    n_bins, n_cols = results.shape
    return RipleyTable(
        bins=np.tile(np.asarray(index), n_cols),
        name=var_name,
        values=np.repeat(columns, n_bins),
        categories=np.unique(columns),
        stats=np.asarray(results).T.reshape(-1),
    )


def ripley(
    adata: Any,
    cluster_key: str,
    mode: Literal["F", "G", "L"] = "F",
    spatial_key: str = Key.obsm.spatial,
    metric: str = "euclidean",
    n_neigh: int = 2,
    n_simulations: int = 100,
    n_observations: int = 1000,
    max_dist: float | None = None,
    n_steps: int = 50,
    seed: int | None = None,
    copy: bool = False,
    *,
    table_key: str | None = None,
) -> dict[str, RipleyTable | NDArrayA] | None:
    r"""Ripley's F, G or L statistics for point processes, with Monte-Carlo envelopes.

    Stores ``uns['{cluster_key}_ripley_{mode}'] = {'{mode}_stat', 'sims_stat',
    'bins', 'pvalues'}``; the two statistics are :class:`RipleyTable`s.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    _assert_categorical_obs(adata, key=cluster_key)
    _assert_spatial_basis(adata, key=spatial_key)
    if metric != "euclidean":
        raise ValueError(f"Unsupported metric `{metric}` — the distance kernels are euclidean-only.")
    mode = RipleyStat(mode)
    coords = np.asarray(adata.obsm[spatial_key], dtype=np.float64)
    labels = adata.obs[cluster_key]
    codes = np.asarray(labels.cat.codes)

    with record_function("ripley.hull"):
        hull = ConvexHull(coords)
    area = hull.volume
    support = np.linspace(0.0, (area / 2) ** 0.5 if max_dist is None else max_dist, n_steps)

    # only categories with members: an empty cluster has no point cloud to query
    present = np.unique(codes)
    categories = np.asarray(labels.cat.categories)[present]

    obs_rng, *sim_rngs = (
        np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(n_simulations + 1)
    )

    # the observed curve of each cluster; F draws a fresh point-process
    # reference set a cluster from the shared stream (the last draw is reused
    # by the envelope, as in the reference)
    ref_pts: NDArrayA | None = None
    observed: list[NDArrayA] = []
    with record_function("ripley.observed"):
        # each cluster's rows in their original order, from one stable sort of
        # the codes (the same arrays as `coords[codes == code]`, one pass over them)
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        starts = np.searchsorted(sorted_codes, present, side="left")
        ends = np.searchsorted(sorted_codes, present, side="right")
        for code, start, end in zip(present, starts, ends):
            members = coords[order[start:end]]
            if mode == RipleyStat.L:
                curve = _l_transform(pair_counts_cumulative(members, support), len(coords), area)
            else:
                if mode == RipleyStat.F:
                    with record_function("ripley.ppp"):
                        ref_pts = ppp_sample(hull, 1, n_observations, rng=obs_rng)
                    queries = ref_pts
                elif mode == RipleyStat.G:
                    queries = coords[codes != code]
                else:
                    raise NotImplementedError(f"Mode `{mode.s!r}` is not yet implemented.")
                nn_d, _ = cross_knn(queries, members, n_neigh)
                curve = _ecdf(nn_d.squeeze(), support)
            observed.append(curve)
    obs_mat = np.stack(observed)  # (n_cls, n_steps)

    # the Monte-Carlo envelope: each simulation replays its own spawned
    # stream; the statistics of all clouds run in one launch
    with record_function("ripley.ppp"):
        clouds = np.stack([ppp_sample(hull, 1, n_observations, rng=r) for r in sim_rngs])
    with record_function("ripley.envelope"):
        if mode == RipleyStat.L:
            sims_mat = np.stack(
                [_l_transform(row, len(coords), area) for row in batched_pair_counts(clouds, support)]
            )
        else:
            env_queries = ref_pts if mode == RipleyStat.F else coords
            nn_all = batched_nn_distances(env_queries, clouds)  # (S, m)
            with record_function("ripley.ecdf_rows"):
                sims_mat = _ecdf_rows(nn_all, support)

    with record_function("ripley.pvalues"):
        exceed = (sims_mat[None, :, :] >= obs_mat[:, None, :]).sum(axis=1)
        pvalues = (1.0 + exceed) / (n_simulations + 1)
        pvalues = np.minimum(pvalues, 1.0 - pvalues)

    res = {
        f"{mode}_stat": _reshape_res(obs_mat.T, columns=categories, index=support, var_name=cluster_key),
        "sims_stat": _reshape_res(sims_mat.T, columns=np.arange(n_simulations), index=support, var_name="simulations"),
        "bins": support,
        "pvalues": pvalues,
    }
    if copy:
        return res
    _save_data(adata, attr="uns", key=Key.uns.ripley(cluster_key, mode.s), data=res)
    return None
