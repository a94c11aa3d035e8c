"""Clustering and embedding backends of the niche detection (counterpart of
``squidpy_tpu/models/clustering.py``).

- graph clustering: the native C++ Leiden (:func:`squidpy_torch.native.leiden_csr`)
  on the symmetrised kNN graph of the features: exact up to 200,000 rows,
  whose search is kernel K12 on the card
  (:func:`squidpy_torch.ops.knn.feature_knn`), above that from the IVF
  index (:mod:`squidpy_torch.ops.ivf_knn`, kernels K14-K16); communities
  are numbered largest first;
- PCA and the GMM run on the device for tensors (and, as in the JAX
  package, for large host inputs); small host inputs keep sklearn's host
  paths, imported only there;
- z-scores: torch for tensors, numpy float64 for host arrays.

The port dispatches on ``torch.Tensor`` where the JAX package dispatches on
``jax.Array``.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch
from scipy import sparse as sp

from torch.profiler import record_function

from squidpy_torch._device import get_device, to_host

__all__ = ["gmm_cluster", "graph_cluster", "knn_graph", "pca_embed", "zscore"]

logger = logging.getLogger(__name__)

# the exact search (K12) up to here; above, the IVF index (ops/ivf_knn.py),
# guarded by a sampled-recall check, with the full sweep as the fallback
_EXACT_KNN_MAX_N = 200_000
# below this sampled recall the IVF graph falls back to the full sweep
_IVF_RECALL_FLOOR = 0.92
# sklearn's host EM below, the device EM from here
_GMM_DEVICE_MIN_N = 20_000


def knn_graph(X: Any, n_neighbors: int) -> sp.csr_matrix:
    """Symmetrised binary kNN adjacency of the rows of ``X`` (a tensor, or a
    host array sent to the selected device): exact up to
    ``_EXACT_KNN_MAX_N`` rows (K12), above that from the IVF index (K14-K16)
    whose sampled recall must reach ``_IVF_RECALL_FLOOR``, else from the
    full sweep (:func:`squidpy_torch.ops.knn.brute_force_knn_approx`, K12).
    Past the IVF kernels' list of 32 neighbours a row the graph is K12's
    exact one at every size (the JAX package takes the IVF there).

    The JAX package pads the features with zero columns to share compiles
    (``_pad_feature_bucket``); the port does not pad here: a zero column
    adds exactly +0 to a difference-form d2 summed in axis order, so every
    d2 and every neighbour is the same either way (the kernels pad to their
    own width on the card)."""
    from squidpy_torch.native import symmetrize_knn
    from squidpy_torch.ops import ivf_knn as ivf
    from squidpy_torch.ops.knn import brute_force_knn_approx, feature_knn

    n = X.shape[0]
    k = min(n_neighbors, n - 1)
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(get_device())
    if n > _EXACT_KNN_MAX_N and k > ivf._MAX_K:
        logger.info(f"n_neighbors {k} > {ivf._MAX_K}, past the IVF kernels' lists: the exact search")
    if n <= _EXACT_KNN_MAX_N or k > ivf._MAX_K:
        with record_function("calculate_niche.knn_search"):
            idx = to_host(feature_knn(X, k)[1])
    else:
        _, idx = ivf.ivf_knn(X, k, return_distances=False)
        with record_function("calculate_niche.ivf_recall"):
            recall = ivf.sampled_recall(X, idx, k, n_samples=256, seed=0)
        if recall < _IVF_RECALL_FLOOR:
            logger.info(f"IVF kNN sampled recall {recall:.3f} < {_IVF_RECALL_FLOOR} (unstructured features); "
                        "falling back to the full sweep")
            with record_function("calculate_niche.ivf_fallback"):
                _, idx = brute_force_knn_approx(X, k)
    with record_function("calculate_niche.symmetrize_knn"):
        return symmetrize_knn(idx, n)


def graph_cluster(X: Any, n_neighbors: int, resolution: float = 1.0, random_state: int = 0) -> np.ndarray:
    """Community labels ('0', '1', ...) of the rows of ``X``: Leiden on the
    kNN graph, communities numbered largest first."""
    from squidpy_torch.native import leiden_csr

    adj = knn_graph(X, n_neighbors)
    with record_function("calculate_niche.leiden"):
        labels, k = leiden_csr(adj, resolution=resolution, seed=int(random_state))
    sizes = np.bincount(labels, minlength=max(k, 1))
    order = np.argsort(-sizes, kind="stable")  # largest community -> '0'
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    return remap[labels].astype(str)


def gmm_cluster(X: Any, n_components: int, random_state: int = 42) -> np.ndarray:
    """Gaussian-mixture cluster labels: the device EM
    (:func:`squidpy_torch.ops.gmm.gmm_em_labels`) for tensors and from
    ``_GMM_DEVICE_MIN_N`` rows, sklearn's host EM below."""
    if isinstance(X, torch.Tensor) or len(X) >= _GMM_DEVICE_MIN_N:
        from squidpy_torch.ops.gmm import gmm_em_labels

        with record_function("calculate_niche.gmm"):
            return gmm_em_labels(X, n_components, random_state)
    from sklearn.mixture import GaussianMixture

    gmm = GaussianMixture(n_components=n_components, random_state=random_state, init_params="random_from_data")
    gmm.fit(np.asarray(X))
    return gmm.predict(np.asarray(X))


def pca_embed(X: Any, n_comps: int | None = None, random_state: int = 0) -> Any:
    """PCA embedding (scanpy's default: min(50, min(shape) - 1) components).

    Tensors, and host arrays of 1e8 values or more, embed on the device
    (:func:`squidpy_torch.ops.pca.pca_device`) and stay there; smaller host
    arrays take sklearn's host PCA."""
    if n_comps is None:
        n_comps = min(50, min(X.shape) - 1)
    n_comps = max(1, min(n_comps, min(X.shape) - 1))
    if isinstance(X, torch.Tensor) or getattr(X, "size", 0) >= 100_000_000:
        from squidpy_torch.ops.pca import pca_device

        with record_function("calculate_niche.pca"):
            if not isinstance(X, torch.Tensor):
                X = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(get_device())
            return pca_device(X, n_comps)
    from sklearn.decomposition import PCA

    return PCA(n_components=n_comps, svd_solver="auto", random_state=random_state).fit_transform(
        np.asarray(X, dtype=np.float64)
    )


def zscore(X: Any) -> Any:
    """Column z-scores with a zero-variance guard (scanpy's ``pp.scale``);
    tensors stay on their device in float32."""
    if isinstance(X, torch.Tensor):
        mu = X.mean(dim=0)
        sd = X.std(dim=0, correction=0)
        return (X - mu) / torch.where(sd == 0, 1.0, sd)
    X = np.asarray(X, dtype=np.float64)
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd[sd == 0] = 1.0
    return (X - mu) / sd
