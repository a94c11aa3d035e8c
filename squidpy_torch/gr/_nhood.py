"""Neighbourhood enrichment (counterpart of ``squidpy_tpu/gr/_nhood.py``).

z-score = (observed count - mean(permuted counts)) / std(permuted counts),
per cluster pair, over directed stored edges. At ``n >= MIN_CIPHER_N`` the
shuffles come from the keyed index cipher (kernel K4) and are counted by the
pair counter (kernel K3), 500 permutations at a time; smaller inputs shuffle
by a stable sort of the same threefry words. Keys, shuffles, counts and
z-scores equal the JAX package's on the cipher path.
"""

from __future__ import annotations

from typing import Any, Literal, NamedTuple

import numpy as np
import torch
from scipy import sparse as sp

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.graph import graph_from_adata
from squidpy_torch._core.index_cipher import MIN_CIPHER_N, cipher_label_columns
from squidpy_torch._core.rng import permutation_columns, spawn_keys
from squidpy_torch._device import NDArrayA, assert_positive, get_device, to_host
from squidpy_torch.gr._utils import (
    _assert_categorical_obs,
    _assert_connectivity_key,
    _categorical_codes,
    _save_data,
    extract_adata_if_sdata,
)
from squidpy_torch.ops.nhood import analytic_pair_count_moments, cluster_pair_counts, permuted_pair_counts_cols

__all__ = ["NhoodEnrichmentResult", "nhood_enrichment"]

_PERM_CHUNK = 500


class NhoodEnrichmentResult(NamedTuple):
    zscore: NDArrayA
    counts: NDArrayA


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
    Stores ``uns['{cluster_key}_nhood_enrichment'] = {'zscore', 'count'}``.
    """
    if library_key is not None:
        raise NotImplementedError(
            "`library_key` stratification is not ported to squidpy_torch yet; "
            "see ROADMAP.md, queue 1, 'library_key shuffles'."
        )
    if cache:
        raise NotImplementedError(
            "`cache=` is not ported to squidpy_torch yet; see ROADMAP.md, queue 1, 'cache='."
        )
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    connectivity_key = Key.obsp.spatial_conn(connectivity_key)
    _assert_categorical_obs(adata, cluster_key)
    _assert_connectivity_key(adata, connectivity_key)
    assert_positive(n_perms, name="n_perms")

    int_clust, n_cls = _categorical_codes(adata, cluster_key)

    if mode == "analytic":
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
        perms = _permuted_counts(graph, labels_dev, int_clust, n_cls, n_perms, seed)
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
    graph: Any, labels_dev: torch.Tensor, int_clust: np.ndarray, n_cls: int, n_perms: int, seed: int | None
) -> np.ndarray:
    """``(n_perms, C, C)`` float64 counts, in chunks of 500 permutations.

    Shuffles are generated and counted in column layout (permutation axis
    minor). The tail chunk is padded with repeated keys, as in the JAX
    package, and its extra counts are dropped.
    """
    use_cipher = labels_dev.shape[0] >= MIN_CIPHER_N
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
        if use_cipher:
            cols = cipher_label_columns(kc, class_counts, out_dtype=payload)
        else:
            cols = permutation_columns(kc, labels_dev, payload_dtype=payload)
        counts_c = permuted_pair_counts_cols(graph.indices, graph.mask, cols, n_cls)
        parts.append(to_host(counts_c, np.float64)[:n_real])
    return np.concatenate(parts, axis=0)
