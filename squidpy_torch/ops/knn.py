"""Exact k-nearest-neighbour and radius search (counterpart of ``squidpy_tpu/ops/knn.py``).

Same kNN dispatch as the JAX package: an exact brute-force search on the
device up to ``_BRUTE_FORCE_MAX_N`` points, the multi-threaded host
``cKDTree`` beyond. The brute force is plain torch (the JAX version is XLA
code, not a Pallas kernel): expanded-form squared distances by
``torch.matmul`` with TF32 off, ``torch.topk``, then exact difference-form
distances for the winners. The radius search is kernel K6 on the card
(:mod:`squidpy_torch.ops.radius`). The search of queries against other
points (:func:`cross_knn`, and Ripley's batches of simulated clouds) is
kernel K8 on the card (``csrc/cross_knn.cu``, :func:`nearest_points`): an
exact search of a cell grid that K6's kernels build, on the card, or for
small inputs a scan of every point. The exact search of the niche
features' nearest other rows (:func:`feature_knn`) is kernel K12 on the
card (``csrc/feature_knn.cu``).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from squidpy_torch import _cuda
from squidpy_torch._device import full_float32, get_device, to_host
from squidpy_torch.ops.radius import (_GAP_MARGIN, _bin_k6, _event, _grid_bounds_k6, _knn_grid_geometry,
                                     _sqrt_rn, radius_pairs)

__all__ = [
    "auto_knn",
    "brute_force_knn",
    "brute_force_knn_approx",
    "cross_knn",
    "feature_knn",
    "feature_knn_rows",
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
# K8 scans every point of small sets (the envelopes' clouds) when the work in
# all is small and k fits its register list: there the grid's fixed cost (a
# read-back of the points' bounds, two counting sorts, ~0.3 ms on one H100)
# outweighs its search. A large set's scan runs n tests a thread, which idles
# the card when the queries are few, and the global list costs the scan O(k)
# a candidate.
_K8_SCAN_MAX_POINTS = 4096
_K8_SCAN_MAX_PAIRS = 1 << 28
_NAN_D2_BITS = 0x7FC00000  # the key bits of a NaN d2, after +inf
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 26}  # (rows, n) temporaries of K8's plain version

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
    with full_float32():
        cross = a @ b.T
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
    launches the kernel: an exact search of a cell grid, or for small sets
    and little work a scan of every point (:func:`_k8_route`). A k above 32
    takes a slower branch."""
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
    if dim == 0:
        raise ValueError("K8 takes points of at least one dimension.")
    if max(m, n_sets * n, n_sets * m * k) >= 2**31:
        raise ValueError("K8 takes fewer than 2^31 queries, points and outputs.")
    if _k8_route(n_sets, m, n, k) == "scan":
        return _nearest_scan(queries, data, k)
    return _nearest_grid(queries, data, k)


def _k8_route(n_sets: int, m: int, n: int, k: int) -> str:
    """``scan`` (every point) for small sets and little work with k in
    registers, else ``grid``: both give the same neighbours."""
    small = n <= _K8_SCAN_MAX_POINTS and n_sets * m * n < _K8_SCAN_MAX_PAIRS and k <= _K8_REGISTER_K
    return "scan" if small else "grid"


def _k8_outputs(n_sets: int, m: int, k: int, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """K8's distances and indices (S, m, k), and for k above its register
    list the global list's scratch, all ones (else None)."""
    dist = torch.empty((n_sets, m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_sets, m, k), dtype=torch.int32, device=dev)
    scratch = torch.full((n_sets, m, k), -1, dtype=torch.int64, device=dev) if k > _K8_REGISTER_K else None
    return dist, idx, scratch


def _nearest_scan(queries: torch.Tensor, data: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's scan of every point, on ``queries`` (m, d) and ``data`` (S, n, d) float32."""
    n_sets, n, dim = data.shape
    m = queries.shape[0]
    dist, idx, scratch = _k8_outputs(n_sets, m, k, queries.device)
    if m == 0 or n_sets == 0:
        return dist, idx
    code = _cuda.library().sqt_cross_knn_brute(
        queries.data_ptr(), m, data.data_ptr(), n_sets, n, dim, k, None if scratch is None else scratch.data_ptr(),
        dist.data_ptr(), idx.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "cross_knn")
    _cuda.launches["cross_knn"] += 1
    return dist, idx


def _nearest_grid(queries: torch.Tensor, data: torch.Tensor, k: int, stats: dict[str, Any] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's grid search on ``queries`` (m, d) and ``data`` (S, n, d) float32:
    one grid for every set (K6's bounds, read back once, and its counting
    sort, each set's cells after the last set's), the queries sorted into
    the same cells by the same kernels, then the search. Given ``stats``, it
    fills it with the grid, the kernel's counts of tests and rings and the
    device milliseconds of its steps (timed by CUDA events; it then waits
    for each step)."""
    n_sets, n, dim = data.shape
    m = queries.shape[0]
    dev = queries.device
    dist, idx, scratch = _k8_outputs(n_sets, m, k, dev)
    if m == 0 or n_sets == 0:
        return dist, idx
    g = min(dim, 3)
    ev = [_event()] if stats is not None else None
    flat = data.view(n_sets * n, dim)
    finite, lo, hi = _grid_bounds_k6(flat, g, stats)
    dims, side = _knn_grid_geometry(g, n_sets, finite, lo, hi)
    grid = _bin_k6(flat, g, lo, side, dims, finite, n_sets=n_sets)
    if ev is not None:
        ev.append(_event())
    qgrid = _bin_k6(queries, g, lo, side, dims, m)
    if ev is not None:
        ev.append(_event())
    counters = torch.zeros(5, dtype=torch.int64, device=dev) if stats is not None else None
    low = (lo + [0.0, 0.0, 0.0])[:3]
    code = _cuda.library().sqt_cross_knn(
        qgrid.pts.data_ptr(), qgrid.order.data_ptr(), qgrid.cell.data_ptr(), m, grid.pts.data_ptr(),
        grid.order.data_ptr(), grid.cell_start.data_ptr(), n_sets, n, dim, k, *low, side, *dims, _GAP_MARGIN,
        None if scratch is None else scratch.data_ptr(), None if counters is None else counters.data_ptr(),
        dist.data_ptr(), idx.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "cross_knn")
    _cuda.launches["cross_knn"] += 1
    if ev is not None:
        ev.append(_event())
        torch.cuda.synchronize()
        stats.update({name: a.elapsed_time(b) for name, a, b in zip(("grid_ms", "query_sort_ms", "search_ms"),
                                                                    ev[:-1], ev[1:])})
        tests, most, rings, most_rings, scanning = (int(v) for v in counters.cpu())
        stats.update(side=side, dims=dims, cells=math.prod(dims), points=finite, tests=tests, most_tests=most,
                     rings=rings, most_rings=most_rings, scanning=scanning, queries=m * n_sets)
    return dist, idx


def _feature_pad(d: int) -> int:
    """K12's padded feature width: a multiple of 8 up to 64, of 32 above."""
    return -(-max(d, 1) // 8) * 8 if d <= 64 else -(-d // 32) * 32


def _feature_knn_rows_plain(x: torch.Tensor, rows: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K12 on the listed ``rows``: row tiles of
    difference-form ``d2`` against every row, the row itself excluded, the
    k least keys ``bits(d2) << 32 | index`` by ``torch.topk``, correctly
    rounded roots."""
    n = x.shape[0]
    m = rows.numel()
    dist = torch.empty((m, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((m, k), dtype=torch.int32, device=x.device)
    step = max(1, _PLAIN_PAIRS[x.device.type] // max(n, 1))
    col = torch.arange(n, dtype=torch.int64, device=x.device)
    for r0 in range(0, m, step):
        q = rows[r0 : r0 + step].to(torch.int64)
        d2 = pairwise_sq_dists_exact(x[q], x)
        bits = torch.where(torch.isnan(d2), _NAN_D2_BITS, d2.view(torch.int32)).to(torch.int64)
        keys = (bits << 32) | col
        keys[torch.arange(q.numel(), device=x.device), q] = torch.iinfo(torch.int64).max
        keys = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        idx[r0 : r0 + step] = (keys & 0xFFFFFFFF).to(torch.int32)
        dist[r0 : r0 + step] = _sqrt_rn((keys >> 32).to(torch.int32).view(torch.float32))
    return dist, idx


def _feature_knn_plain(x: torch.Tensor, k: int, stop: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K12: row tiles of difference-form ``d2``
    against every row, the row itself excluded, the k least keys
    ``bits(d2) << 32 | index`` by ``torch.topk``, correctly rounded roots;
    for the rows before ``stop`` only, if given."""
    m = x.shape[0] if stop is None else min(stop, x.shape[0])
    return _feature_knn_rows_plain(x, torch.arange(m, device=x.device), k)


def feature_knn(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K12: the ``k`` nearest other rows of the feature matrix ``x``
    (n, d), ascending: distances (n, k) float32 and indices (n, k) int32.

    Rows rank by difference-form ``d2`` in axis order (each operation
    rounded), ties to the lowest index, the row itself excluded by index;
    distances are correctly rounded roots. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel on ``x`` padded with zero
    columns to K12's width (a zero column adds exactly +0 to every d2): up
    to 64 padded features a tensor-core filter whose candidates are re-ranked
    by the exact keys, wider features the exact route (:func:`_k12_route`)."""
    if x.ndim != 2:
        raise ValueError(f"Expected a feature matrix (n, d), found shape {tuple(x.shape)}.")
    n, d = x.shape
    if not 1 <= k < n:
        raise ValueError(f"Expected `n_neighs` < number of observations ({n}), found `{k}`.")
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _feature_knn_plain(x.contiguous(), k)
    return _feature_knn_k12(x, k)


def feature_knn_rows(x: torch.Tensor, rows: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K12's exact route on the listed distinct ``rows`` of ``x``
    (n, d): each listed row's ``k`` nearest other rows, ascending, as
    distances (m, k) float32 and indices (m, k) int32, in :func:`feature_knn`'s
    order (the sampled exact neighbours of the IVF's recall check)."""
    n, d = x.shape
    if not 1 <= k < n:
        raise ValueError(f"Expected `n_neighs` < number of observations ({n}), found `{k}`.")
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _feature_knn_rows_plain(x.contiguous(), rows, k)
    dp = _feature_pad(d)
    xp = x.contiguous() if dp == d else torch.nn.functional.pad(x, (0, dp - d)).contiguous()
    dev = x.device
    listed = rows.to(device=dev, dtype=torch.int32).contiguous()
    n_rows = torch.tensor([listed.numel()], dtype=torch.int32, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    scratch = torch.full((n, k), -1, dtype=torch.int64, device=dev) if k > _K8_REGISTER_K else None
    p = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _cuda.check(_cuda.library().sqt_feature_knn(p(xp), n, dp, k, p(listed), p(n_rows), p(scratch), p(dist), p(idx),
                                                _cuda.stream_ptr()), "feature_knn")
    _cuda.launches["feature_knn"] += 1
    return dist[listed.to(torch.int64)], idx[listed.to(torch.int64)]


# K12's filter route takes up to this many padded features (its rows' bf16
# terms live in registers); a row past `_K12_CAP` re-ranked candidates, or
# with an unbounded norm, leaves the filter for the exact route; lists of
# up to `_K12_SHARED_K` keys live in shared memory, longer ones in a global
# scratch row
_K12_FILTER_MAX_DP = 64
_K12_CAP = 4096
_K12_SHARED_K = 64
_K12_NORM_LIMIT = 2.0**124  # a centred norm at or above this is unbounded


def _k12_route(dp: int) -> str:
    """``filter`` (the tensor-core filter and exact re-rank) up to 64 padded
    features, else ``exact`` (the exact keys of every pair)."""
    return "filter" if dp <= _K12_FILTER_MAX_DP else "exact"


def _k12_tile_cols(dp: int) -> int:
    """Columns K12's filter stages a tile (csrc/feature_knn.cu ``tile_cols``)."""
    return 128 if dp <= 32 else 64


def _k12_filter_constants(dp: int) -> tuple[float, float]:
    """The filter's error bound ``delta = c (n_i + n_j) + a`` at ``dp``
    padded features: ``c = (dp + 20) 2^-19``, ``a = (dp + 1) 2^-120``
    (derived in csrc/feature_knn.cu)."""
    return (dp + 20) * 2.0**-19, (dp + 1) * 2.0**-120


def _k12_centred(xp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The filter's inputs: the columns centred on the means of their finite
    entries (float32, each value rounded once) and each row's float32
    ``|xc|^2``, NaN where it is not finite or not below 2^124."""
    finite = torch.isfinite(xp)
    total = torch.where(finite, xp, 0.0).to(torch.float64).sum(dim=0)
    mu = (total / finite.sum(dim=0).clamp_min(1)).to(torch.float32)
    xc = (xp - mu).contiguous()
    norms = (xc * xc).sum(dim=1)
    norms = torch.where(torch.isfinite(norms) & (norms < _K12_NORM_LIMIT), norms, float("nan")).contiguous()
    return xc, norms


def _feature_knn_k12(x: torch.Tensor, k: int, *, route: str | None = None, cap: int = _K12_CAP,
                     stats: dict[str, Any] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K12's launches on the float32 (n, d) CUDA tensor ``x``, zero-padded to
    the kernel's width: the route :func:`_k12_route` picks (or ``route``),
    with a scratch list a row for k above 32. The filter route lists the
    rows it cannot finish on the device and the exact route takes them at
    once, so no count is read back. Given ``stats``, it fills it with the
    route and, for the filter, the candidates a finished row re-ranked
    (mean, largest) and the rows on the exact route (read back)."""
    n, d = x.shape
    dp = _feature_pad(d)
    if n >= 2**31 or n * max(k, dp) >= 2**40:
        raise ValueError("K12 takes fewer than 2^31 rows.")
    route = route or _k12_route(dp)
    if route not in ("filter", "exact") or (route == "filter" and dp > _K12_FILTER_MAX_DP):
        raise ValueError(f"K12 has no route {route!r} at {dp} padded features.")
    if cap < 1:
        raise ValueError(f"K12's candidate cap must be positive, found {cap}.")
    xp = x.contiguous() if dp == d else torch.nn.functional.pad(x, (0, dp - d)).contiguous()
    _cuda.require(xp, "x", torch.float32, (n, dp))
    dev = x.device
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    scratch = torch.full((n, k), -1, dtype=torch.int64, device=dev) if k > _K8_REGISTER_K else None
    p = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _cuda.library()
    if route == "exact":
        _cuda.check(lib.sqt_feature_knn(p(xp), n, dp, k, None, None, p(scratch), p(dist), p(idx), _cuda.stream_ptr()),
                    "feature_knn")
        _cuda.launches["feature_knn"] += 1
        if stats is not None:
            stats.update(route=route)
        return dist, idx
    xc, norms = _k12_centred(xp)
    c, a = _k12_filter_constants(dp)
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    n_rows = torch.zeros(1, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    lists = scratch if k > _K12_SHARED_K else None
    _cuda.check(lib.sqt_feature_knn_filter(p(xp), p(xc), p(norms), n, dp, k, c, a, cap, p(lists), p(rows),
                                           p(n_rows), p(counts), p(dist), p(idx), _cuda.stream_ptr()), "feature_knn")
    _cuda.launches["feature_knn"] += 1
    _cuda.check(lib.sqt_feature_knn(p(xp), n, dp, k, p(rows), p(n_rows), p(scratch), p(dist), p(idx),
                                    _cuda.stream_ptr()), "feature_knn")
    _cuda.launches["feature_knn"] += 1
    if stats is not None:
        done = counts[counts >= 0].to(torch.float64)
        stats.update(route=route, candidates_mean=float(done.mean()) if done.numel() else 0.0,
                     candidates_max=int(done.max()) if done.numel() else 0, exact_rows=int(n_rows[0]))
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


def brute_force_knn_approx(coords: Any, k: int, *, exclude_self: bool = True, recall_target: float = 0.99,
                           row_tile: int = 1024, col_tile: int = 8192) -> tuple[np.ndarray, np.ndarray]:
    """The full sweep behind the IVF's fallback, with the JAX package's
    signature: ``(distances, indices)`` (n, k) as numpy, each row ascending.
    The JAX package selects by TPU PartialReduce, approximate on a TPU and
    exact on the CPU; the port computes the exact graph everywhere, by
    :func:`feature_knn` (K12 on the card), ``coords`` a tensor (kept on its
    device) or a host array (sent to the selected one). With
    ``exclude_self=False`` each row's own key (d2 = 0) joins its list.
    ``recall_target``, ``row_tile`` and ``col_tile`` change nothing."""
    x = coords if isinstance(coords, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(coords, dtype=np.float32)).to(get_device())
    n = x.shape[0]
    if k >= n:
        raise ValueError(f"Expected `n_neighs` < number of observations ({n}), found `{k}`.")
    d, i = (to_host(t) for t in feature_knn(x, k))
    if exclude_self:
        return d, i
    # the k least keys with the row's own (0, row) among them: its place is
    # before the first neighbour at d2 > 0 or at d2 = 0 with a higher index
    rows = np.arange(n)[:, None]
    pos = ((d == 0) & (i < rows)).sum(axis=1, keepdims=True)
    col, prev = np.arange(k), np.maximum(np.arange(k) - 1, 0)  # past its place, the list shifted by one
    d_out = np.where(col < pos, d, np.where(col == pos, np.float32(0.0), d[:, prev]))
    i_out = np.where(col < pos, i, np.where(col == pos, rows, i[:, prev])).astype(np.int32)
    return d_out, i_out


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
