"""IVF approximate kNN (counterpart of ``squidpy_tpu/ops/ivf_knn.py``).

The clustering graphs of ``calculate_niche`` above 200,000 rows come from an
inverted-file index built and searched on the device, as in the JAX package:

1. k-means over C ~ sqrt(n) centroids (:func:`kmeans_device`): Lloyd's
   assignment and each row's nearest centroids are kernel K14's nearest
   entry (a tensor-core filter whose candidates the exact keys re-rank, up
   to 64 padded features; ``csrc/knn_filter.cuh``), the centroids' update
   its update entry (``csrc/ivf_kmeans.cu``);
2. the member table (:func:`_pack_members`, a host numpy copy of the JAX
   package's): each cluster's rows, the farthest spilled to the nearest
   centroid with room (ranked by K14) when a cluster passes the cap;
3. the replica table (:func:`_build_replicas`): each row is a query of its
   ``nprobe`` nearest centroids (K14), inverted by a stable sort (plain
   torch) into each cluster's queries, the farthest probes dropped where a
   cluster passes ``cap_q``;
4. the search (:func:`_search`, kernel K15, ``csrc/ivf_search.cu``): each
   cluster's queries against its own members, k least keys a replica (the
   same filter, each cluster centred on its members' mean);
5. the merge (:func:`_merge_slots`, plain torch): each row's ``nprobe``
   result rows gathered, one exact top k;
6. the refine pass (:func:`_refine`, kernel K16, ``csrc/ivf_refine.cu``):
   the row's neighbours and theirs, the k nearest distinct ones, the rows
   taken in the member table's cluster order (:func:`_row_order`).

:func:`sampled_recall` holds the result against the exact neighbours of 256
sampled rows, from K12's exact route on the listed rows
(:func:`squidpy_torch.ops.knn.feature_knn_rows`).

Every ranking is by the key ``bits(d2) << 32 | index``, d2 the difference
form in axis order, each operation rounded on its own, so ties go to the
lowest index and each kernel agrees with its plain version bit for bit. The
JAX package ranks the centroids, the probes and the search by the expanded
form and rounds each row tile's centroid sums to bf16; the port's index
equals JAX's where no near tie decides (ROADMAP.md queue 3). A CPU tensor
runs each kernel's plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import time
from collections.abc import Iterator
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from squidpy_torch import _cuda
from squidpy_torch._device import get_device, to_host
from squidpy_torch.ops.knn import (
    _NAN_D2_BITS,
    _feature_pad,
    _k12_filter_constants,
    feature_knn_rows,
    pairwise_sq_dists_exact,
)
from squidpy_torch.ops.radius import _sqrt_rn

__all__ = ["IvfIndex", "ivf_index_from_numpy", "ivf_knn", "ivf_search", "kmeans_device", "sampled_recall"]

_NO_KEY = 0x7FFFFFFFFFFFFFFF  # above every real key; its index bits read as -1
_RUN = 32  # rows a run of K14's update sums (csrc/ivf_kmeans.cu kRun)
# K15 and K16 keep at most this many keys a row, K14 as many centroids;
# models/clustering.py knn_graph takes K12's exact search past it
_MAX_K = 32
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 26}  # temporaries of the plain versions
_MERGE_ROWS = 1 << 18  # rows a chunk of the merge's gather and top k
# K14's and K15's filter routes (csrc/knn_filter.cuh) take up to this many
# padded features, a multiple of 8, and bound at most this many columns a
# row (m, or k + 1 where the row itself is among the columns)
_IVF_FILTER_MAX_DP = 64
_IVF_FILTER_MAX_NEED = 32
# the filters' counters: candidates and first-tile candidates of the rows
# the filter finished, the largest, those rows, the rows past their buffer
_STAT_NAMES = ("candidates", "first_tile", "candidates_max", "finished", "exact")


@dataclass
class IvfIndex:
    """An IVF index on the device: centroids (C, dp) float32, the member
    table (C, cap) and the replica table (C, cap_q) int32 (sentinel n, real
    rows at the front of each row), the slot map (n, nprobe) int32 (each
    query's replica rows, sentinel C * cap_q)."""

    centroids: torch.Tensor
    members: torch.Tensor
    qtable: torch.Tensor
    slot_map: torch.Tensor


def ivf_index_from_numpy(centroids: np.ndarray, members: np.ndarray, qtable: np.ndarray, slot_map: np.ndarray,
                         device: Any = None) -> IvfIndex:
    """The port's index from numpy tables (the JAX package's, whose padded
    rows a caller has cut to n), on ``device`` (the selected one by
    default)."""
    dev = torch.device(device) if device is not None else get_device()
    cents = np.ascontiguousarray(centroids, dtype=np.float32)
    cents = np.pad(cents, ((0, 0), (0, _feature_pad(cents.shape[1]) - cents.shape[1])))
    return IvfIndex(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in (cents, np.asarray(members, np.int32), np.asarray(qtable, np.int32),
                                np.asarray(slot_map, np.int32))))


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` float32 with zero columns up to K12's width (each adds exactly +0 to every d2)."""
    x = x.to(torch.float32)
    dp = _feature_pad(x.shape[1])
    return (x if dp == x.shape[1] else torch.nn.functional.pad(x, (0, dp - x.shape[1]))).contiguous()


def _keys(d2: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``bits(d2) << 32 | id`` as int64, a NaN d2 after +inf."""
    bits = torch.where(torch.isnan(d2), _NAN_D2_BITS, d2.view(torch.int32)).to(torch.int64)
    return (bits << 32) | ids.to(torch.int64)


def _key_ids(keys: torch.Tensor) -> torch.Tensor:
    """The index bits of keys as int32, -1 for the no-key."""
    return torch.where(keys == _NO_KEY, -1, keys & 0xFFFFFFFF).to(torch.int32)


def _key_d2(keys: torch.Tensor) -> torch.Tensor:
    """The d2 bits of keys as float32, +inf for the no-key."""
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    return torch.where(keys == _NO_KEY, float("inf"), d2)


# ---- K14: nearest centroids and the update ----------------------------------

def _nearest_plain(x: torch.Tensor, cents: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K14's nearest entry: each row's ``m`` least
    keys over the centroids, ascending, as indices (n, m) int32, and the
    first one's d2 (n,) float32."""
    n, c = x.shape[0], cents.shape[0]
    idx = torch.empty((n, m), dtype=torch.int32, device=x.device)
    d2_out = torch.empty(n, dtype=torch.float32, device=x.device)
    rows = max(1, _PLAIN_PAIRS[x.device.type] // max(c, 1))
    col = torch.arange(c, device=x.device)
    for r0 in range(0, n, rows):
        keys = _keys(pairwise_sq_dists_exact(x[r0 : r0 + rows], cents), col)
        keys = torch.topk(keys, m, dim=1, largest=False, sorted=True).values
        idx[r0 : r0 + rows] = (keys & 0xFFFFFFFF).to(torch.int32)
        d2_out[r0 : r0 + rows] = _key_d2(keys[:, 0])
    return idx, d2_out


def _ivf_route(dp: int, need: int) -> str:
    """``filter`` (the tensor-core filter and exact re-rank) at a multiple of
    8 up to 64 padded features and at most 32 columns to bound (``need``: m,
    or k + 1 where the row itself is among the columns), else ``exact`` (the
    exact keys of every pair): K14's nearest entry and K15 alike."""
    return "filter" if dp <= _IVF_FILTER_MAX_DP and dp % 8 == 0 and need <= _IVF_FILTER_MAX_NEED else "exact"


def _filter_scratch(sets: int, width: int, dp: int, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """The filter routes' scratch for ``sets`` sets of ``width`` candidates:
    the bf16 terms (16 bytes a k-step of 16 features and column, the columns
    padded to 8), -n_j / 2 a column and each set's centre."""
    cap8 = -(-width // 8) * 8
    terms = torch.empty(sets * cap8 * -(-dp // 16) * 16, dtype=torch.int32, device=dev)
    hneg = torch.empty((sets, cap8), dtype=torch.float32, device=dev)
    mu = torch.empty((sets, dp), dtype=torch.float32, device=dev)
    return terms, hneg, mu


def _filter_stats(counters: torch.Tensor | None, stats: dict | None, route: str) -> None:
    """Given ``stats``, the route and, for the filter, its counters: the
    candidates a finished query re-ranked (mean, largest), the share of them
    from the second pass's first tile, and the queries past their buffer
    (``exact_rows``: they re-rank every column)."""
    if stats is None:
        return
    stats.update(route=route)
    if counters is None:
        return
    got = dict(zip(_STAT_NAMES, to_host(counters).tolist()))
    done = max(got["finished"], 1)
    stats.update(candidates_mean=got["candidates"] / done, candidates_max=got["candidates_max"],
                 first_tile_share=got["first_tile"] / max(got["candidates"], 1), exact_rows=got["exact"])


def _nearest(x: torch.Tensor, cents: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Kernel K14's nearest entry: each row of ``x`` (n, dp) its ``m``
    nearest centroids of ``cents`` (C, dp), ascending, as indices (n, m)
    int32, ties to the lowest index, and for ``m = 1`` their d2 (n,)."""
    if not 1 <= m <= cents.shape[0]:
        raise ValueError(f"Expected 1 <= m <= {cents.shape[0]} centroids, found {m}.")
    if x.device.type == "cpu":
        idx, d2 = _nearest_plain(x, cents, m)
        return idx, (d2 if m == 1 else None)
    return _nearest_k14(x, cents, m)


def _nearest_k14(x: torch.Tensor, cents: torch.Tensor, m: int, *, route: str | None = None,
                 stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K14's nearest entry on the route :func:`_ivf_route` picks (or
    ``route``): the filter route centres both sides on the centroids' mean,
    bounds each row's m-th d2 in a first sweep of the centroids and re-ranks
    in a second; given ``stats``, it fills it as :func:`_filter_stats`
    says."""
    if m > _MAX_K:
        raise ValueError(f"K14 ranks at most {_MAX_K} centroids a row, found {m}.")
    n, dp = x.shape
    c = cents.shape[0]
    route = route or _ivf_route(dp, m)
    if route not in ("filter", "exact") or (route == "filter" and _ivf_route(dp, m) != "filter"):
        raise ValueError(f"K14 has no route {route!r} at {dp} padded features.")
    _cuda.require(x, "x", torch.float32, (n, dp))
    _cuda.require(cents, "centroids", torch.float32, (c, dp))
    idx = torch.empty((n, m), dtype=torch.int32, device=x.device)
    d2 = torch.empty(n, dtype=torch.float32, device=x.device) if m == 1 else None
    p = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _cuda.library()
    counters = None
    if route == "exact":
        _cuda.check(lib.sqt_ivf_nearest(p(x), n, dp, p(cents), c, m, p(idx), p(d2), _cuda.stream_ptr()), "ivf_kmeans")
    else:
        terms, hneg, mu = _filter_scratch(1, c, dp, x.device)
        counters = torch.zeros(len(_STAT_NAMES), dtype=torch.int64, device=x.device) if stats is not None else None
        cc, aa = _k12_filter_constants(dp)
        _cuda.check(lib.sqt_ivf_nearest_filter(p(x), n, dp, p(cents), c, m, cc, aa, p(terms), p(hneg), p(mu),
                                               p(counters), p(idx), p(d2), _cuda.stream_ptr()), "ivf_kmeans")
    _cuda.launches["ivf_kmeans"] += 1
    _filter_stats(counters, stats, route)
    return idx, d2


def _update_layout(codes: torch.Tensor, valid: torch.Tensor, c: int) -> tuple[torch.Tensor, ...]:
    """The update's order: the rows that count grouped by cluster in index
    order (a stable sort), each cluster's first position (C + 1,) and the
    offsets of its runs of ``_RUN`` rows (C + 1,), all int32."""
    ucodes = torch.where(valid, codes.to(torch.int64), c)
    order = torch.sort(ucodes, stable=True).indices.to(torch.int32)
    counts = torch.bincount(ucodes, minlength=c + 1)[:c]
    zero = torch.zeros(1, dtype=torch.int64, device=codes.device)
    starts = torch.cat([zero, torch.cumsum(counts, 0)]).to(torch.int32)
    run_off = torch.cat([zero, torch.cumsum((counts + _RUN - 1) // _RUN, 0)]).to(torch.int32)
    return order, starts, run_off


def _update_plain(x: torch.Tensor, order: torch.Tensor, starts: torch.Tensor, run_off: torch.Tensor,
                  cents: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K14's update, in the kernel's order: each
    cluster's rows (bf16-rounded) in runs of ``_RUN`` summed left to right
    from +0, the runs' sums by the pairwise tree, then sum / count (an empty
    cluster keeps its centroid)."""
    dev, c = x.device, cents.shape[0]
    xb = x.to(torch.bfloat16).to(torch.float32)
    starts, run_off, order = starts.to(torch.int64), run_off.to(torch.int64), order.to(torch.int64)
    total = int(run_off[-1])
    g = torch.arange(total, device=dev)
    owner = torch.searchsorted(run_off, g, right=True) - 1
    local = g - run_off[owner]
    first = starts[owner] + local * _RUN
    end = starts[owner + 1]
    acc = torch.zeros((total, x.shape[1]), dtype=torch.float32, device=dev)
    for j in range(_RUN if total else 0):
        pos = first + j
        rows = order[pos.clamp(max=order.numel() - 1)]
        acc = acc + torch.where((pos < end)[:, None], xb[rows], 0.0)  # + +0 leaves a sum from +0 as it is
    n_runs = (run_off[1:] - run_off[:-1])[owner]
    s = 1
    while total and s < int(n_runs.max()):
        target = g[(local % (2 * s) == 0) & (local + s < n_runs)]
        acc[target] = acc[target] + acc[target + s]
        s *= 2
    counts = (starts[1:] - starts[:-1]).to(torch.float32)
    sums = torch.zeros_like(cents)
    has = counts > 0
    sums[has] = acc[run_off[:-1][has]]
    return torch.where(has[:, None], sums / torch.clamp_min(counts, 1.0)[:, None], cents)


def _update(x: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Kernel K14's update entry: the new centroids (C, dp) from the rows
    ``x`` (n, dp) whose ``valid`` is set and their ``codes`` (n,)."""
    c = cents.shape[0]
    order, starts, run_off = _update_layout(codes, valid, c)
    if x.device.type == "cpu":
        return _update_plain(x, order, starts, run_off, cents)
    n, dp = x.shape
    _cuda.require(x, "x", torch.float32, (n, dp))
    _cuda.require(cents, "centroids", torch.float32, (c, dp))
    max_runs = n // _RUN + c + 1  # at least the runs there are, with no read-back of their count
    runs = torch.empty((max_runs, dp), dtype=torch.float32, device=x.device)
    out = torch.empty_like(cents)
    _cuda.check(_cuda.library().sqt_ivf_update(x.data_ptr(), n, dp, order.data_ptr(), starts.data_ptr(),
                                               run_off.data_ptr(), c, max_runs, runs.data_ptr(), cents.data_ptr(),
                                               out.data_ptr(), _cuda.stream_ptr()), "ivf_kmeans")
    _cuda.launches["ivf_kmeans"] += 1
    return out


def _kmeans(x: torch.Tensor, init: torch.Tensor, iters: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd's iterations from the centroids ``init`` on the padded rows
    ``x``: the centroids, each row's code (n,) int32 and its d2 (n,)
    float32. Non-finite entries count as 0 in the distances, and a row whose
    first entry is not finite is left out of the update (the JAX package's
    rules)."""
    valid = torch.isfinite(x[:, 0])
    xz = torch.where(torch.isfinite(x), x, 0.0)
    cents = init.contiguous()
    for _ in range(iters):
        codes, _ = _nearest(xz, cents, 1)
        cents = _update(xz, codes[:, 0], valid, cents)
    codes, d2 = _nearest(xz, cents, 1)
    return cents, codes[:, 0], d2


def _as_tensor(coords: Any) -> torch.Tensor:
    if isinstance(coords, torch.Tensor):
        return coords
    return torch.from_numpy(np.ascontiguousarray(coords, dtype=np.float32)).to(get_device())


def kmeans_device(coords: Any, n_clusters: int, *, iters: int = 4, seed: int = 0, row_tile: int = 65536
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lloyd's k-means on the device, from the rows
    ``np.random.default_rng(seed).choice(n, n_clusters, replace=False)``.
    Returns ``(centroids, codes, d2_own)`` as numpy. ``row_tile`` is kept
    for the JAX package's signature and changes nothing."""
    x = _as_tensor(coords)
    n, d = x.shape
    init = np.random.default_rng(seed).choice(n, size=n_clusters, replace=False)
    xp = _padded(x)
    cents, codes, d2 = _kmeans(xp, xp[torch.from_numpy(init).to(x.device)], iters)
    return to_host(cents[:, :d]), to_host(codes), to_host(d2)


# ---- the member table (host) ----------------------------------------------

def _stable_order(codes: np.ndarray, n_clusters: int) -> np.ndarray:
    """``np.argsort(codes, kind="stable")``, on numpy's radix path (16-bit
    keys) where the codes fit: the same order, ~7x faster at 1M rows."""
    return np.argsort(codes.astype(np.uint16) if n_clusters <= 1 << 16 else codes, kind="stable")


def _pack_members(codes: np.ndarray, d2_own: np.ndarray, centroids: Any, coords: Any, cap: int) -> np.ndarray:
    """(C, cap) member-index table (sentinel n); a cluster past ``cap``
    spills its farthest members (by ``d2_own``) to the nearest centroid with
    room, ranked by K14 over ``min(C, 16)`` centroids, else to the emptiest.
    A copy of the JAX package's, which ranks by ``cross_knn``."""
    n = codes.shape[0]
    n_clusters = centroids.shape[0]
    sizes = np.bincount(codes, minlength=n_clusters)
    codes = codes.copy()

    over = np.flatnonzero(sizes > cap)
    if over.size:
        spill_rows: list[np.ndarray] = []
        order = _stable_order(codes, n_clusters)
        starts = np.zeros(n_clusters + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        for c in over:
            mem = order[starts[c] : starts[c + 1]]
            far = mem[np.argsort(d2_own[mem], kind="stable")[cap:]]
            spill_rows.append(far)
        spill = np.concatenate(spill_rows)
        # only the spill rows' centroids are ranked, on the device
        x = _as_tensor(coords)
        cents = centroids if isinstance(centroids, torch.Tensor) else _as_tensor(centroids)
        rows = _padded(x[torch.from_numpy(spill).to(x.device)])
        cand = to_host(_nearest(rows, _padded(cents.to(x.device)), min(n_clusters, 16))[0])
        room = cap - np.minimum(sizes, cap)
        room[over] = 0
        for row, choices in zip(spill, cand):
            placed = False
            for c in choices:
                if room[c] > 0:
                    room[c] -= 1
                    codes[row] = c
                    placed = True
                    break
            if not placed:  # every ranked centroid full: the emptiest one
                c = int(np.argmax(room))
                room[c] -= 1
                codes[row] = c
        sizes = np.bincount(codes, minlength=n_clusters)
        if sizes.max() > cap:
            raise ValueError("IVF spill overflow: raise the member cap")

    order = _stable_order(codes, n_clusters)
    starts = np.zeros(n_clusters + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    members = np.full((n_clusters, cap), n, dtype=np.int32)
    sorted_codes = codes[order]
    members[sorted_codes, np.arange(n) - starts[sorted_codes]] = order
    return members


# ---- the replica table ----------------------------------------------------

def _build_replicas(x: torch.Tensor, cents: torch.Tensor, nprobe: int, cap_q: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's ``nprobe`` nearest centroids (K14, on ``x`` with its
    non-finite entries zeroed), inverted into the (C, cap_q) replica table
    and the (n, nprobe) slot map by one stable sort of ``cluster * nprobe +
    rank`` (plain torch): a cluster past ``cap_q`` drops its farthest probes.
    Also returns the count of dropped replicas (a tensor)."""
    n, c = x.shape[0], cents.shape[0]
    dev = x.device
    probes, _ = _nearest(torch.where(torch.isfinite(x), x, 0.0), cents, nprobe)
    flat_c = probes.reshape(-1).to(torch.int64)
    rank_of = torch.arange(nprobe, device=dev).repeat(n)
    flat_q = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(nprobe)
    order = torch.sort(flat_c * nprobe + rank_of, stable=True).indices
    sorted_c = flat_c[order]
    start = torch.searchsorted(sorted_c, torch.arange(c, device=dev))
    rank = torch.arange(sorted_c.numel(), device=dev) - start[sorted_c]
    keep = rank < cap_q
    slot = torch.where(keep, sorted_c * cap_q + rank, c * cap_q)
    qtable = torch.full((c * cap_q + 1,), n, dtype=torch.int32, device=dev)
    qtable[slot] = flat_q[order]  # dropped replicas land on the extra slot, cut below
    slot_map = torch.empty(n * nprobe, dtype=torch.int32, device=dev)
    slot_map[order] = slot.to(torch.int32)
    return qtable[:-1].view(c, cap_q), slot_map.view(n, nprobe), (~keep).sum()


# ---- K15: the cluster search ----------------------------------------------

def _search_plain(x: torch.Tensor, members: torch.Tensor, qtable: torch.Tensor, k: int, exclude_self: bool,
                  clusters: int | None = None) -> torch.Tensor:
    """Plain torch version of K15 over the first ``clusters`` clusters
    (all by default): (C * cap_q, k) int64 keys, the no-key elsewhere."""
    n = x.shape[0]
    c, cap_q = qtable.shape
    out = torch.full((c * cap_q, k), _NO_KEY, dtype=torch.int64, device=x.device)
    for ci in range(c if clusters is None else min(clusters, c)):
        q_ids = qtable[ci][qtable[ci] < n].to(torch.int64)
        m_ids = members[ci][members[ci] < n].to(torch.int64)
        if not q_ids.numel() or not m_ids.numel():
            continue
        rows = max(1, _PLAIN_PAIRS[x.device.type] // m_ids.numel())
        for r0 in range(0, q_ids.numel(), rows):
            q = q_ids[r0 : r0 + rows]
            keys = _keys(pairwise_sq_dists_exact(x[q], x[m_ids]), m_ids[None, :].expand(q.numel(), -1))
            if exclude_self:
                keys = torch.where(m_ids[None, :] == q[:, None], _NO_KEY, keys)
            if keys.shape[1] < k:
                keys = torch.cat([keys, keys.new_full((keys.shape[0], k - keys.shape[1]), _NO_KEY)], dim=1)
            keys = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
            out[ci * cap_q + r0 : ci * cap_q + r0 + q.numel()] = keys
    return out


def _search(x: torch.Tensor, members: torch.Tensor, qtable: torch.Tensor, k: int, exclude_self: bool
            ) -> torch.Tensor:
    """Kernel K15: each replica's k least keys among its cluster's members,
    (C * cap_q, k) int64, ascending, the no-key where there is none."""
    if x.device.type == "cpu":
        return _search_plain(x, members, qtable, k, exclude_self)
    return _search_k15(x, members, qtable, k, exclude_self)


def _search_k15(x: torch.Tensor, members: torch.Tensor, qtable: torch.Tensor, k: int, exclude_self: bool, *,
                route: str | None = None, stats: dict | None = None) -> torch.Tensor:
    """K15 on the route :func:`_ivf_route` picks (or ``route``). The filter
    route centres each cluster on its members' mean, bounds each replica's
    k-th d2 in a first sweep of the members and re-ranks the candidates of a
    second; given ``stats``, it fills it as :func:`_filter_stats` says."""
    if k > _MAX_K:
        raise ValueError(f"K15 keeps at most {_MAX_K} neighbours a row, found {k}.")
    n, dp = x.shape
    c, cap_m = members.shape
    cap_q = qtable.shape[1]
    need = k + int(exclude_self)
    route = route or _ivf_route(dp, need)
    if route not in ("filter", "exact") or (route == "filter" and _ivf_route(dp, need) != "filter"):
        raise ValueError(f"K15 has no route {route!r} at {dp} padded features and k = {k}.")
    _cuda.require(x, "x", torch.float32, (n, dp))
    _cuda.require(members, "members", torch.int32, (c, cap_m))
    _cuda.require(qtable, "qtable", torch.int32, (c, cap_q))
    msize = (members < n).sum(dim=1, dtype=torch.int32)
    qsize = (qtable < n).sum(dim=1, dtype=torch.int32)
    out = torch.full((c * cap_q, k), _NO_KEY, dtype=torch.int64, device=x.device)
    p = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _cuda.library()
    counters = None
    if route == "exact":
        _cuda.check(lib.sqt_ivf_search(p(x), n, dp, p(members), cap_m, p(msize), p(qtable), cap_q, p(qsize), c, k,
                                       int(exclude_self), p(out), _cuda.stream_ptr()), "ivf_search")
    else:
        terms, hneg, mu = _filter_scratch(c, cap_m, dp, x.device)
        counters = torch.zeros(len(_STAT_NAMES), dtype=torch.int64, device=x.device) if stats is not None else None
        cc, aa = _k12_filter_constants(dp)
        _cuda.check(lib.sqt_ivf_search_filter(p(x), n, dp, p(members), cap_m, p(msize), p(qtable), cap_q, p(qsize), c, k,
                                              int(exclude_self), cc, aa, p(terms), p(hneg), p(mu), p(counters), p(out),
                                              _cuda.stream_ptr()), "ivf_search")
    _cuda.launches["ivf_search"] += 1
    _filter_stats(counters, stats, route)
    return out


def _merge_slots(keys: torch.Tensor, slot_map: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's ``nprobe`` result rows gathered through the slot map (the
    sentinel slot reads the no-key) and one exact top k of their keys: the
    merged indices (n, k) int32, -1 where fewer than k were found. A point
    lies in one cluster only, so the keys are distinct."""
    n, nprobe = slot_map.shape
    table = torch.cat([keys, torch.full((1, k), _NO_KEY, dtype=torch.int64, device=keys.device)])
    out = torch.empty((n, k), dtype=torch.int32, device=keys.device)
    for r0 in range(0, n, _MERGE_ROWS):
        got = table[slot_map[r0 : r0 + _MERGE_ROWS].to(torch.int64)].reshape(-1, nprobe * k)
        out[r0 : r0 + _MERGE_ROWS] = _key_ids(torch.topk(got, k, dim=1, largest=False, sorted=True).values)
    return out


# ---- K16: the refine pass -------------------------------------------------

_K16_FEAT = 32  # features a staged chunk of K16, at most (csrc/ivf_refine.cu takes up to 128)
_K16_WARPS = (8, 4, 2, 1)  # warps a block K16's layout chooses from, the larger first
_K16_SM_WARPS = 32  # warps an SM at K16's 64 registers a thread (65,536 registers)
_SM_SMEM = 233_472  # bytes of shared memory an H100 SM gives its blocks, 1 KB of each reserved
_BLOCK_SMEM = 232_448  # bytes a block may take


def _k16_layout(k: int, dp: int) -> dict[str, int]:
    """K16's layout (``csrc/ivf_refine.cu``) for k neighbours and dp padded
    features: the features a staged chunk (``feat``: dp in equal chunks of at
    most :data:`_K16_FEAT`, a multiple of 4), the floats between staged rows
    (``stride``, ``feat | 4``), the hash set's ``slots`` (the power of two
    at least 1.5 (k + k^2), at least 32), a warp's shared memory in bytes
    (``warp_smem``: two buffers of 32 staged rows, which the hash set of
    8-byte slots overlays, the candidate list and the query row), and the
    ``warps`` a block that let the most warps share an SM (``warps_an_sm``,
    by shared memory, the registers and the SM's 32 blocks; ties to the
    larger block)."""
    n_cand = k + k * k
    chunks = -(-dp // _K16_FEAT)
    feat = 4 * -(-dp // (4 * chunks))
    stride = feat | 4
    slots = max(32, 1 << ((3 * n_cand + 1) // 2 - 1).bit_length())
    warp_smem = 4 * (max(2 * 32 * stride, 2 * slots) + -(-n_cand // 4) * 4 + dp)
    fits = [(w * min(32, _K16_SM_WARPS // w, _SM_SMEM // (w * warp_smem + 1024)), w) for w in _K16_WARPS
            if w * warp_smem <= _BLOCK_SMEM]
    if not fits:
        raise ValueError(f"K16 cannot hold a row of {dp} padded features at k = {k} in a block's shared memory.")
    warps_an_sm, warps = max(fits)
    return {"warps": warps, "feat": feat, "chunks": -(-dp // feat), "stride": stride, "slots": slots,
            "warp_smem": warp_smem, "block_smem": warps * warp_smem, "warps_an_sm": warps_an_sm}


def _row_order(members: torch.Tensor, n: int) -> torch.Tensor | None:
    """The rows in cluster order: the valid entries of the member table
    (C, cap), read row by row, as int32, where they hold every row of
    0..n-1 exactly once (as :func:`_pack_members` makes them); None (index
    order) where they do not. Two reads back to the host."""
    flat = members.reshape(-1)
    order = flat[(flat >= 0) & (flat < n)]
    if order.numel() != n:
        return None
    seen = torch.zeros(n, dtype=torch.bool, device=members.device)
    seen[order.to(torch.int64)] = True
    return order.to(torch.int32).contiguous() if bool(seen.all()) else None


def _refine_plain(x: torch.Tensor, idx: torch.Tensor, k: int, exclude_self: bool, rows: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K16 on the rows ``rows`` (every row, in index
    order, by default), taken in that order: each row's k + k^2 candidates,
    their keys, repeats and invalid ids dropped, the k least, as correctly
    rounded distances and indices (len(rows), k), the i-th of rows[i]."""
    n = x.shape[0]
    dev = x.device
    rows = torch.arange(n, device=dev) if rows is None else rows.to(device=dev, dtype=torch.int64)
    m = rows.numel()
    n_cand = k + k * k
    idx64 = idx.to(torch.int64)
    dist = torch.empty((m, k), dtype=torch.float32, device=dev)
    out = torch.empty((m, k), dtype=torch.int32, device=dev)
    chunk = max(1, _PLAIN_PAIRS[dev.type] // (n_cand * x.shape[1]))
    for r0 in range(0, m, chunk):
        r1 = min(r0 + chunk, m)
        sel = rows[r0:r1]
        base = idx64[sel]
        ok = (base >= 0) & (base < n)
        hop = torch.where(ok[:, :, None], idx64[base.clamp(0, n - 1)], -1).reshape(r1 - r0, k * k)
        cand = torch.cat([base, hop], dim=1)
        valid = (cand >= 0) & (cand < n)
        if exclude_self:
            valid &= cand != sel[:, None]
        xc = x[cand.clamp(0, n - 1)]  # (rows, n_cand, dp)
        xq = x[sel][:, None, :]
        diff = xq[..., 0] - xc[..., 0]
        d2 = diff * diff
        for e in range(1, x.shape[1]):
            diff = xq[..., e] - xc[..., e]
            d2 = d2 + diff * diff
        keys = torch.where(valid, _keys(d2, cand.clamp(0, n - 1)), _NO_KEY)
        keys = torch.sort(keys, dim=1).values
        keys[:, 1:] = torch.where(keys[:, 1:] == keys[:, :-1], _NO_KEY, keys[:, 1:])
        keys = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        out[r0:r1] = _key_ids(keys)
        dist[r0:r1] = _sqrt_rn(_key_d2(keys))
    return dist, out


def _refine(x: torch.Tensor, idx: torch.Tensor, k: int, exclude_self: bool, order: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K16: one refine pass over every row of ``x`` (n, dp) from the
    lists ``idx`` (n, k) int32, the kernel taking the rows in ``order`` (n,)
    int32, a permutation of them (:func:`_row_order`; index order by
    default): distances (n, k) float32 and indices (n, k) int32, ascending,
    +inf and -1 past the distinct candidates, each row's at its own index.
    The result does not depend on the order, which the CPU's plain version
    does not take."""
    if x.device.type == "cpu":
        return _refine_plain(x, idx, k, exclude_self)
    return _refine_k16(x, idx, k, exclude_self, order)


def _refine_k16(x: torch.Tensor, idx: torch.Tensor, k: int, exclude_self: bool, order: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K16's launch on the layout :func:`_k16_layout` gives."""
    if k > _MAX_K:
        raise ValueError(f"K16 keeps at most {_MAX_K} neighbours a row, found {k}.")
    n, dp = x.shape
    _cuda.require(x, "x", torch.float32, (n, dp))
    _cuda.require(idx, "idx", torch.int32, (n, k))
    if order is not None:
        _cuda.require(order, "order", torch.int32, (n,))
    lay = _k16_layout(k, dp)
    dist = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out = torch.empty((n, k), dtype=torch.int32, device=x.device)
    _cuda.check(_cuda.library().sqt_ivf_refine(x.data_ptr(), n, dp, idx.data_ptr(), k, int(exclude_self),
                                               order.data_ptr() if order is not None else None, lay["warps"],
                                               lay["feat"], lay["slots"], dist.data_ptr(), out.data_ptr(),
                                               _cuda.stream_ptr()), "ivf_refine")
    _cuda.launches["ivf_refine"] += 1
    return dist, out


# ---- the search on an index, the recall check, the whole ----------------

@contextmanager
def _phase(name: str, stats: dict | None, dev: torch.device) -> Iterator[None]:
    """The profiler's range ``calculate_niche.ivf_<name>``; given ``stats``,
    the phase's milliseconds added under ``<name>_ms`` (a device sync at
    each end)."""
    with record_function(f"calculate_niche.ivf_{name}"):
        if stats is None:
            yield
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats[f"{name}_ms"] = stats.get(f"{name}_ms", 0.0) + 1e3 * (time.perf_counter() - t0)


def ivf_search(x: torch.Tensor, index: IvfIndex, k: int, *, refine_iters: int = 1, exclude_self: bool = True,
               stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The search (K15), the merge and ``max(refine_iters, 1)`` refine
    passes (K16) of the rows ``x`` (n, d) on ``index``: distances (n, k)
    float32 and indices (n, k) int32, ascending."""
    xp = _padded(x)
    phase = lambda name: _phase(name, stats, xp.device)  # noqa: E731
    with phase("search"):
        keys = _search(xp, index.members, index.qtable, k, exclude_self)
    with phase("merge"):
        idx = _merge_slots(keys, index.slot_map, k)
        del keys
    dist = None
    with phase("refine"):
        order = _row_order(index.members, xp.shape[0])
        for _ in range(max(refine_iters, 1)):  # at least one: it also gives the exact distances
            dist, idx = _refine(xp, idx, k, exclude_self, order)
    return dist, idx


def sampled_recall(coords: Any, idx: np.ndarray, k: int, *, n_samples: int = 256, seed: int = 0) -> float:
    """Share of the exact k nearest other rows of ``n_samples`` sampled rows
    (``np.random.default_rng(seed).choice``) found in their rows of ``idx``:
    the runtime guard of the data-dependent recall. The exact neighbours
    come from K12's exact route on the sampled rows."""
    x = _as_tensor(coords)
    n = x.shape[0]
    sample = np.random.default_rng(seed).choice(n, size=min(n_samples, n), replace=False)
    exact = to_host(feature_knn_rows(x, torch.from_numpy(sample).to(x.device), min(k, n - 1))[1])
    hits = 0.0
    for s, row in enumerate(sample):
        want = set(exact[s].tolist())
        hits += len(want & set(idx[row].tolist())) / max(len(want), 1)
    return hits / len(sample)


def _ivf_knn(coords: Any, k: int, *, n_clusters: int | None = None, nprobe: int = 16, iters: int = 4,
             refine_iters: int = 1, cap_factor: float = 1.5, cap_q_factor: float = 1.4, seed: int = 0,
             exclude_self: bool = True, stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor, IvfIndex]:
    """:func:`ivf_knn` on the device: distances and indices as tensors, and
    the index; given ``stats``, fills it with the index's sizes and each
    phase's milliseconds."""
    x = _as_tensor(coords)
    n, d = x.shape
    if k >= n:
        raise ValueError(f"Expected `n_neighs` < number of observations ({n}), found `{k}`.")
    if n_clusters is None:
        n_clusters = int(2 ** np.round(np.log2(max(np.sqrt(n), 2.0))))
    n_clusters = max(2, min(n_clusters, n // max(2 * k, 8)))
    nprobe = min(nprobe, n_clusters)
    xp = _padded(x)
    phase = lambda name: _phase(name, stats, xp.device)  # noqa: E731

    init_rows = np.random.default_rng(seed).choice(n, size=n_clusters, replace=False)
    with phase("kmeans"):
        cents, codes, d2_own = _kmeans(xp, xp[torch.from_numpy(init_rows).to(xp.device)], iters)
    # the member cap, a multiple of 128 as in the JAX package
    cap = int(np.ceil(cap_factor * n / n_clusters / 128.0) * 128)
    while nprobe * cap < k + 1:  # the probe union must hold k + 1 candidates
        cap += 128
    with phase("pack"):
        codes_h = to_host(codes)
        members = _pack_members(codes_h, to_host(d2_own), cents, xp, cap)
        members_d = torch.from_numpy(members).to(xp.device)
    cap_q = int(np.ceil(cap_q_factor * nprobe * n / n_clusters / 8.0) * 8)
    with phase("replicas"):
        qtable, slot_map, dropped = _build_replicas(xp, cents, nprobe, cap_q)
    index = IvfIndex(cents, members_d, qtable, slot_map)
    dist, idx = ivf_search(xp, index, k, refine_iters=refine_iters, exclude_self=exclude_self, stats=stats)
    if stats is not None:
        sizes = np.bincount(codes_h, minlength=n_clusters)
        stats.update(n_clusters=n_clusters, nprobe=nprobe, cap=cap, cap_q=cap_q,
                     spilled=int(np.maximum(sizes - cap, 0).sum()), largest_cluster=int(sizes.max()),
                     dropped_replicas=int(dropped))
    return dist, idx, index


def ivf_knn(coords: Any, k: int, *, n_clusters: int | None = None, nprobe: int = 16, iters: int = 4,
            refine_iters: int = 1, cap_factor: float = 1.5, cap_q_factor: float = 1.4, seed: int = 0,
            exclude_self: bool = True, return_distances: bool = True) -> tuple[np.ndarray | None, np.ndarray]:
    """Approximate kNN of the rows of ``coords`` (a tensor, kept on its
    device, or a host array, sent to the selected one) through an IVF index
    with per-query multiprobe and NN-descent refinement. Returns ``(d, i)``
    as numpy, each row ascending (the sklearn ``kneighbors`` contract), ``d``
    None without ``return_distances``. A row with fewer than ``k`` distinct
    candidates ends with distance +inf and index -1. At most 32 neighbours
    (and ``nprobe`` at most 32) on the card, where more raise;
    :func:`squidpy_torch.models.clustering.knn_graph` takes K12's exact
    search past 32 neighbours."""
    dist, idx, _ = _ivf_knn(coords, k, n_clusters=n_clusters, nprobe=nprobe, iters=iters, refine_iters=refine_iters,
                            cap_factor=cap_factor, cap_q_factor=cap_q_factor, seed=seed, exclude_self=exclude_self)
    return (to_host(dist) if return_distances else None), to_host(idx)
