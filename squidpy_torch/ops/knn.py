"""Exact k-nearest-neighbour and radius search (counterpart of ``squidpy_tpu/ops/knn.py``).

Same kNN dispatch as the JAX package: an exact brute-force search on the
device up to ``_BRUTE_FORCE_MAX_N`` points, the multi-threaded host
``cKDTree`` beyond. The brute force is plain torch (the JAX version is XLA
code, not a Pallas kernel): expanded-form squared distances by
``torch.matmul`` with TF32 off, ``torch.topk``, then exact difference-form
distances for the winners. The radius search is kernel K6 on the card
(:mod:`squidpy_torch.ops.radius`).
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch.profiler import record_function

from squidpy_torch._device import get_device, to_host
from squidpy_torch.ops.radius import _sqrt_rn, radius_pairs

__all__ = ["auto_knn", "brute_force_knn", "pairwise_sq_dists", "radius_graph", "radius_neighbors"]

# above this size the O(n^2) device sweep loses to the host tree; both are
# exact, so the dispatch is purely a performance decision
_BRUTE_FORCE_MAX_N = 50_000

# the TF32 switch is process-wide; graphs built in threads (library_key with
# n_jobs > 1) must not restore it under each other's products
_TF32_LOCK = threading.Lock()


def auto_knn(coords: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact kNN: device brute force for n <= 50k, host KDTree beyond."""
    coords = np.ascontiguousarray(coords)
    n = coords.shape[0]
    if n <= _BRUTE_FORCE_MAX_N:
        return brute_force_knn(coords, k)
    if k >= n:
        raise ValueError(f"Expected `n_neighs` < number of observations ({n}), found `{k}`.")
    from scipy.spatial import cKDTree

    d, i = cKDTree(coords).query(coords, k=k + 1, workers=-1)
    self_pos = i == np.arange(n)[:, None]
    # duplicates can push the self index out of the top k+1 — then drop the
    # farthest entry instead (any k of the tied nearest are correct)
    drop = np.where(self_pos.any(axis=1), self_pos.argmax(axis=1), k)
    keep = np.ones((n, k + 1), dtype=bool)
    keep[np.arange(n), drop] = False
    return d[keep].reshape(n, k), i[keep].reshape(n, k).astype(np.int32)


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Expanded-form squared distances ``(m, n)``, clamped at 0; the product
    runs in full float32 (TF32 off for the call)."""
    a2 = (a * a).sum(dim=1, keepdim=True)
    b2 = (b * b).sum(dim=1, keepdim=True)
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            cross = a @ b.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.clamp_min(a2 + b2.T - 2.0 * cross, 0.0)


def brute_force_knn(
    coords: np.ndarray, k: int, *, exclude_self: bool = True, row_tile: int = 1024
) -> tuple[np.ndarray, np.ndarray]:
    """Exact euclidean kNN ``(distances, indices)`` of shape ``(n, k)``, sorted
    by ascending distance (sklearn's ``kneighbors`` contract)."""
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    n = coords.shape[0]
    if k >= n:
        raise ValueError(f"Expected `n_neighs` < number of observations ({n}), found `{k}`.")
    x = torch.from_numpy(coords).to(get_device())
    dists, idxs = [], []
    for r0 in range(0, n, row_tile):
        rows = x[r0 : r0 + row_tile]
        d2 = pairwise_sq_dists(rows, x)
        if exclude_self:
            ar = torch.arange(rows.shape[0], device=x.device)
            d2[ar, r0 + ar] = float("inf")
        idx = torch.topk(d2, k, dim=1, largest=False, sorted=True).indices
        # exact distances via the difference form: the expansion loses
        # precision for near-coincident points; correctly rounded roots, so
        # the CPU's equal the card's
        diff = x[idx] - rows[:, None, :]
        dists.append(_sqrt_rn((diff * diff).sum(dim=-1)).cpu().numpy())
        idxs.append(idx.to(torch.int32).cpu().numpy())
    d = np.concatenate(dists)
    i = np.concatenate(idxs)
    order = np.argsort(d, axis=1, kind="stable")
    return np.take_along_axis(d, order, axis=1), np.take_along_axis(i, order, axis=1)


def radius_neighbors(
    coords: np.ndarray, radius: float, *, row_tile: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All neighbours within ``radius`` (inclusive), excluding self, as CSR
    ``(indptr int64, indices int32, distances float32)`` with each row's
    columns ascending. The test is float32 difference-form ``d2 <= r2`` with
    ``r2 = float32(float(radius) ** 2)``; on the card it runs as K6, on the
    CPU as its plain version in row tiles of ``row_tile`` (no result depends
    on it)."""
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    with record_function("spatial_neighbors.radius_search"):
        indptr, indices, dists = radius_pairs(torch.from_numpy(coords).to(get_device()), radius, row_tile=row_tile)
    with record_function("spatial_neighbors.to_host"):
        return to_host(indptr), to_host(indices), to_host(dists)


def radius_graph(coords: np.ndarray, radius: float) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`radius_neighbors` with each point its own neighbour at distance
    0, in its ascending place (K6's ``with_self``), and the position of each
    row's diagonal entry in ``indices`` (int64, ``n``)."""
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    with record_function("spatial_neighbors.radius_search"):
        indptr, indices, dists = radius_pairs(torch.from_numpy(coords).to(get_device()), radius, with_self=True)
        entry_rows = torch.searchsorted(indptr, torch.arange(indices.numel(), device=indptr.device), right=True) - 1
        diag = torch.nonzero(indices == entry_rows).squeeze(1)
    with record_function("spatial_neighbors.to_host"):
        return to_host(indptr), to_host(indices), to_host(dists), to_host(diag)
