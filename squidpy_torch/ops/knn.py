"""Exact k-nearest-neighbour and radius search (counterpart of ``squidpy_tpu/ops/knn.py``).

Same kNN dispatch as the JAX package: an exact brute-force search on the
device up to ``_BRUTE_FORCE_MAX_N`` points, the multi-threaded host
``cKDTree`` beyond. The brute force is plain torch (the JAX version is XLA
code, not a Pallas kernel): expanded-form squared distances by
``torch.matmul`` with TF32 off, ``torch.topk``, then exact difference-form
distances for the winners. The radius search is kernel K6 on the card
(:mod:`squidpy_torch.ops.radius`). The search of queries against other
points (:func:`cross_knn`, and Ripley's batches of simulated clouds) is
kernel K8 on the card (``csrc/cross_knn.cu``, :func:`nearest_points`).
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch.profiler import record_function

from squidpy_torch import _cuda
from squidpy_torch._device import get_device, to_host
from squidpy_torch.ops.radius import _sqrt_rn, radius_pairs

__all__ = [
    "auto_knn",
    "brute_force_knn",
    "cross_knn",
    "nearest_points",
    "pairwise_sq_dists",
    "pairwise_sq_dists_exact",
    "radius_graph",
    "radius_neighbors",
]

# above this size the O(n^2) device sweep loses to the host tree; both are
# exact, so the dispatch is purely a performance decision
_BRUTE_FORCE_MAX_N = 50_000

# K8 keeps up to this many keys a query in registers; a larger k takes its
# slower branch, a list in global memory
_K8_REGISTER_K = 32
_NAN_D2_BITS = 0x7FC00000  # the key bits of a NaN d2, after +inf
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 26}  # (rows, n) temporaries of K8's plain version

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


def pairwise_sq_dists_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference-form squared distances ``(m, n)`` for threshold tests:
    ``(a_0 - b_0)^2``, then ``+ (a_k - b_k)^2`` over the axes in order, each
    subtraction, multiply and add rounded on its own."""
    if a.shape[1] == 0:
        return torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    diff = a[:, 0][:, None] - b[:, 0][None, :]
    d2 = diff * diff
    for dim in range(1, a.shape[1]):
        diff = a[:, dim][:, None] - b[:, dim][None, :]
        d2 = d2 + diff * diff
    return d2


def _nearest_plain(queries: torch.Tensor, data: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K8: row tiles of difference-form ``d2``, the k
    least keys ``bits(d2) << 32 | index`` by ``torch.topk``, correctly
    rounded roots."""
    n_sets, n, _ = data.shape
    m = queries.shape[0]
    dev = queries.device
    dist = torch.empty((n_sets, m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_sets, m, k), dtype=torch.int32, device=dev)
    rows = max(1, _PLAIN_PAIRS[dev.type] // max(n, 1))
    col = torch.arange(n, dtype=torch.int64, device=dev)
    for s in range(n_sets):
        for r0 in range(0, m, rows):
            d2 = pairwise_sq_dists_exact(queries[r0 : r0 + rows], data[s])
            bits = torch.where(torch.isnan(d2), _NAN_D2_BITS, d2.view(torch.int32)).to(torch.int64)
            keys = torch.topk((bits << 32) | col, k, dim=1, largest=False, sorted=True).values
            idx[s, r0 : r0 + rows] = (keys & 0xFFFFFFFF).to(torch.int32)
            dist[s, r0 : r0 + rows] = _sqrt_rn((keys >> 32).to(torch.int32).view(torch.float32))
    return dist, idx


def nearest_points(queries: torch.Tensor, data: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K8: the ``k`` nearest points of ``data`` to each query, ascending.

    ``queries`` is (m, d) and ``data`` (n, d) or a batch (S, n, d), float32;
    returns distances (S, m, k) float32 and indices (S, m, k) int32 (S = 1
    for a single set). Points rank by difference-form ``d2`` (each
    operation rounded), ties to the lowest index; distances are correctly
    rounded roots. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, whose k above 32 takes a slower branch."""
    if data.ndim == 2:
        data = data[None]
    if queries.ndim != 2 or data.ndim != 3 or queries.shape[1] != data.shape[2]:
        raise ValueError(f"Expected queries (m, d) and data (S, n, d), found {tuple(queries.shape)} "
                         f"and {tuple(data.shape)}.")
    n_sets, n, dim = data.shape
    m = queries.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"Expected 1 <= k <= {n} points, found k = {k}.")
    if queries.device.type == "cpu":
        return _nearest_plain(queries.to(torch.float32), data.to(torch.float32), k)
    queries = queries.to(torch.float32).contiguous()
    data = data.to(torch.float32).contiguous()
    _cuda.require(queries, "queries", torch.float32)
    _cuda.require(data, "data", torch.float32)
    if max(m, n, n_sets * m * k) >= 2**31:
        raise ValueError("K8 takes fewer than 2^31 queries, points and outputs a set.")
    dist = torch.empty((n_sets, m, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((n_sets, m, k), dtype=torch.int32, device=queries.device)
    if m == 0 or n_sets == 0:
        return dist, idx
    scratch = torch.full((n_sets, m, k), -1, dtype=torch.int64, device=queries.device) if k > _K8_REGISTER_K else None
    code = _cuda.library().sqt_cross_knn(
        queries.data_ptr(), m, data.data_ptr(), n_sets, n, dim, k, None if scratch is None else scratch.data_ptr(),
        dist.data_ptr(), idx.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "cross_knn")
    _cuda.launches["cross_knn"] += 1
    return dist, idx


def cross_knn(queries: np.ndarray, data: np.ndarray, k: int, *, row_tile: int = 2048
              ) -> tuple[np.ndarray, np.ndarray]:
    """The ``k`` nearest points of ``data`` for each query point (self-matches
    allowed), sorted ascending: the ``tree.kneighbors(queries)`` contract.
    ``k`` is cut to the points there are; no queries give empty arrays.
    ``row_tile`` is kept for the JAX package's signature and changes
    nothing."""
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    data = np.ascontiguousarray(data, dtype=np.float32)
    k = min(k, data.shape[0])
    if queries.shape[0] == 0 or k == 0:
        return np.zeros((queries.shape[0], k), dtype=np.float32), np.zeros((queries.shape[0], k), dtype=np.int32)
    dev = get_device()
    d, i = nearest_points(torch.from_numpy(queries).to(dev), torch.from_numpy(data).to(dev), k)
    return to_host(d[0]), to_host(i[0])  # K8's order: ascending d2, ties to the lowest index


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
