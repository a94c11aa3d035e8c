"""Ripley's pair counts and nearest-neighbour batches, and Poisson point-process
sampling (counterpart of ``squidpy_tpu/ops/ripley.py``).

Pair counts run as kernel K7 on the card (``csrc/ripley_pairs.cu``): every
pair ``i < j`` of a point set, or of each set of a batch, its first
threshold found through a bucket table built once a support
(:func:`_k7_table`), counted into a histogram made cumulative. One large
set may take the binned sweep instead (K1 with one class,
:func:`squidpy_torch.ops.pairbins.binned_ordered_pair_counts`): on the CPU
from 100,000 points, as in the JAX package, on the card only where it was
measured faster (:func:`_k7_route`). The nearest-neighbour batch of the envelope is
kernel K8 (:func:`squidpy_torch.ops.knn.nearest_points`). The point-process
sampler is host numpy/scipy, copied from the JAX package, so its clouds are
bitwise the same for the same generator.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import ConvexHull, Delaunay

from squidpy_torch import _cuda
from squidpy_torch._device import get_device, to_host
from squidpy_torch.ops.knn import nearest_points, pairwise_sq_dists_exact

__all__ = [
    "batched_nn_distances",
    "batched_pair_counts",
    "pair_counts_cumulative",
    "ppp_sample",
    "ripley_pairs",
]

# K7's launch: 256 threads, each holding 4 column points; a row tile of at
# most 256 points staged for 1-3 dimensions; the thresholds, the bucket
# splits and the counters in shared memory where they fit
_K7_SMEM_BYTES = 200 * 1024
_K7_THREADS = 256
_K7_WARPS = 8
_K7_COLS = 1024  # a column tile: 4 points a thread
_K7_ROW_TILE_MAX = 256
_K7_MIN_BUCKETS = 2048
_K7_SLOT_BUCKETS = 1024  # buckets of the slot layout: 2 counters a bucket a copy
_K7_SLOT_COPIES = 4  # copies of the slot counters, each shared by two warps
_K7_MIN_ITEMS = 512  # row tiles shrink (to 32 points) until a launch has this many work items
_K7_DENSE_MAX_N = 1_000_000  # `auto` takes K7 on the card up to here (measured; see _k7_route)
_K7_DENSE_MIN_REACH = 0.5  # and above, while the support reaches this share of the points' extent
_K7_HIST_MODES = {"slots": 0, "shared": 1, "global": 2}
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 26}  # (rows, n) temporaries of K7's plain version


class K7Layout(NamedTuple):
    hist: str  # "slots": slot counters (2 a bucket) and the splits in shared memory; "shared": L bins; "global"
    copies: int  # shared copies of the counters (0 with "global")
    n_buckets: int  # a power of two, at least 4L
    thr_shared: bool


def _k7_layout(dim: int, n_thr: int) -> K7Layout:
    """K7's shared memory: for L <= ``_K7_SLOT_BUCKETS / 4``
    ``_K7_SLOT_COPIES`` copies of the slot counters beside the splits and
    the thresholds; else the
    table in global memory and L-bin copies, a warp's, then one, then none
    (global atomics), with the thresholds staged where they still fit."""
    rows = _K7_ROW_TILE_MAX * dim * 4 if dim <= 3 else 0
    thr = (n_thr + n_thr % 2) * 4

    def fits(*parts: int) -> bool:
        return rows + sum(parts) <= _K7_SMEM_BYTES

    if 4 * n_thr <= _K7_SLOT_BUCKETS:
        slots = 2 * (_K7_SLOT_BUCKETS + 1)
        words = _K7_SLOT_COPIES * (slots + n_thr) + slots // 2 + 1 + 2 * n_thr  # counters, splits, sums
        if fits(words * 4, thr):
            return K7Layout("slots", _K7_SLOT_COPIES, _K7_SLOT_BUCKETS, True)
    n_buckets = max(_K7_MIN_BUCKETS, 1 << (4 * n_thr - 1).bit_length())
    for copies in (_K7_WARPS, 1):
        if fits(copies * n_thr * 4):
            return K7Layout("shared", copies, n_buckets, fits(copies * n_thr * 4, thr))
    return K7Layout("global", 0, n_buckets, fits(thr))


def _k7_row_tile(n_sets: int, n: int) -> int:
    """K7's row tile: the largest power of two up to ``_K7_ROW_TILE_MAX``
    that leaves a launch ``_K7_MIN_ITEMS`` work items, 32 at least."""
    col_tiles = -(-n // _K7_COLS)
    row_tile = _K7_ROW_TILE_MAX
    while row_tile > 32 and n_sets * (_K7_COLS // row_tile) * col_tiles * (col_tiles + 1) // 2 < _K7_MIN_ITEMS:
        row_tile //= 2
    return row_tile


def _k7_table(thr: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """K7's bucket table for ``thr`` (L,) float32 ascending, on its device:
    int32 ``(3 (n_buckets + 1) + 1,)``. A pair's bucket is
    ``min(floor(float32(d2 * scale)), n_buckets)``, ``scale =
    float32(n_buckets / thr[-1])`` (0 unless finite and positive); bucket
    ``n_buckets`` also takes every d2 past ``thr[-1]`` and NaN. For each
    bucket: a float32 split (as bits), then two slot bins. A d2 of the
    bucket ``<= split`` takes the first, else the second (-1: counted
    nowhere). The split is the bucket's largest d2 up to ``thr[-1]`` when
    no threshold lies in ``[least, largest)`` of its d2 (then every d2 of
    the bucket has one first threshold), and that threshold when one value
    does (repeated or not) and the bucket ends below ``thr[-1]``; else it is
    NaN and the kernel walks the thresholds from the first bin. The last
    entry holds the scale's bits."""
    dev = thr.device
    n_thr = thr.numel()
    scale = torch.full((1,), float(n_buckets), dtype=torch.float32, device=dev) / thr[-1:]
    scale = torch.where((scale > 0) & torch.isfinite(scale), scale, torch.zeros_like(scale))
    s64 = scale.to(torch.float64)
    top = thr[-1:].view(torch.int32).to(torch.int64)  # d2 <= thr[-1]: non-negative floats order as their bits
    b = torch.arange(1, n_buckets + 1, device=dev, dtype=torch.float64)
    # the least x with float32(x * scale) >= b lies within a few ulps of b / scale;
    # float32 x times float32 scale is exact in float64, so one rounding gives the kernel's product
    x0 = (b / s64).to(torch.float32).view(torch.int32).to(torch.int64)
    inf = 0x7F800000  # with scale 0 no d2 reaches bucket 1
    cand = (x0[:, None] + torch.arange(-4, 5, device=dev)).clamp(0, inf)
    prod = (cand.to(torch.int32).view(torch.float32).to(torch.float64) * s64).to(torch.float32)
    ok = torch.cat([prod >= b[:, None].to(torch.float32), torch.ones_like(cand[:, :1], dtype=torch.bool)], dim=1)
    cand = torch.cat([cand, torch.full_like(cand[:, :1], inf)], dim=1)
    lo = torch.cat([torch.zeros_like(top), cand.gather(1, ok.to(torch.int8).argmax(dim=1, keepdim=True))[:, 0]])
    end = torch.cat([lo[1:] - 1, torch.full_like(top, 2**31 - 1)])  # the bucket's largest d2, past thr[-1] or not
    hi = torch.minimum(end, top)

    def f32(bits: torch.Tensor) -> torch.Tensor:
        return bits.to(torch.int32).view(torch.float32)

    first = torch.searchsorted(thr, f32(lo))
    last = torch.searchsorted(thr, f32(hi))
    empty = lo > hi
    inside = torch.where(empty, 0, last - first)
    f = first.clamp(max=n_thr - 1)
    one_value = thr[f] == thr[(last - 1).clamp(min=0)]
    walk = empty | ((inside >= 1) & (~one_value | (end > top)))
    split = torch.where(inside == 0, f32(hi), thr[f])
    split = torch.where(walk, torch.full_like(split, float("nan")), split)
    k0 = torch.where(empty, 0, f)
    k1 = torch.where((inside >= 1) & ~walk, last, -1)
    table = torch.empty(3 * (n_buckets + 1) + 1, dtype=torch.int32, device=dev)
    table[: n_buckets + 1] = split.view(torch.int32)
    table[n_buckets + 1 : -1] = torch.stack([k0, k1], dim=1).reshape(-1).to(torch.int32)
    table[-1:] = scale.view(torch.int32)
    return table


def _ripley_pairs_plain(points: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K7: row tiles against the later columns,
    ``d2`` in the difference form, each pair's first threshold by
    ``searchsorted``, a histogram made cumulative."""
    n_sets, n, _ = points.shape
    n_thr = thr.numel()
    dev = points.device
    out = torch.zeros((n_sets, n_thr), dtype=torch.int64, device=dev)
    rows = max(1, _PLAIN_PAIRS[dev.type] // max(n, 1))
    for s in range(n_sets):
        hist = torch.zeros(n_thr, dtype=torch.int64, device=dev)
        for r0 in range(0, n, rows):
            block = points[s, r0 : r0 + rows]
            d2 = pairwise_sq_dists_exact(block, points[s, r0:])  # column c is point r0 + c
            upper = torch.arange(d2.shape[1], device=dev)[None, :] > torch.arange(block.shape[0], device=dev)[:, None]
            first = torch.searchsorted(thr, d2)
            ok = upper & (first < n_thr) & (d2 <= thr[first.clamp(max=n_thr - 1)])
            hist += torch.bincount(first[ok], minlength=n_thr)
        out[s] = torch.cumsum(hist, dim=0)
    return out


def ripley_pairs(points: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Kernel K7: ``(S, L)`` int64 counts of the pairs ``i < j`` of each point
    set with float32 difference-form ``d2 <= thresholds[l]``.

    ``points`` is (n, d) or a batch (S, n, d) float32; ``thresholds`` (L,)
    float32 in any order. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    if points.ndim == 2:
        points = points[None]
    if points.ndim != 3:
        raise ValueError(f"Expected points of shape (n, d) or (S, n, d), found {tuple(points.shape)}.")
    n_sets, n, dim = points.shape
    thresholds = thresholds.to(torch.float32).reshape(-1)
    n_thr = thresholds.numel()
    if n < 2 or n_thr == 0 or n_sets == 0 or dim == 0:
        return torch.zeros((n_sets, n_thr), dtype=torch.int64, device=points.device)
    if points.device.type != "cpu":  # the thresholds read back once: K7's table is built on the host, once a support
        return _pairs_host_thresholds(points, to_host(thresholds))
    order = torch.argsort(thresholds, stable=True)  # counted ascending
    out = torch.empty((n_sets, n_thr), dtype=torch.int64)
    out[:, order] = _ripley_pairs_plain(points.to(torch.float32), thresholds[order].contiguous())
    return out


@functools.lru_cache(maxsize=8)
def _k7_inputs(thr_bytes: bytes, dim: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending float32 thresholds (given as bytes) and K7's table for them,
    built on the host and moved to ``device`` once a support: ``ripley`` L
    counts every cell type and the envelope against the same support."""
    thr = torch.frombuffer(bytearray(thr_bytes), dtype=torch.float32)
    table = _k7_table(thr, _k7_layout(dim, thr.numel()).n_buckets)
    return thr.to(device), table.to(device)


def _pairs_host_thresholds(points: torch.Tensor, thr: np.ndarray) -> torch.Tensor:
    """:func:`ripley_pairs` with float32 thresholds held on the host; on the
    card the sorted thresholds and K7's table come from :func:`_k7_inputs`."""
    if points.device.type == "cpu" or points.shape[1] < 2 or thr.size == 0:
        return ripley_pairs(points, torch.from_numpy(thr))
    ascending = bool(np.all(thr[1:] >= thr[:-1]))
    order = np.arange(thr.size) if ascending else np.argsort(thr, kind="stable")
    thr_dev, table = _k7_inputs(np.ascontiguousarray(thr[order]).tobytes(), points.shape[2], str(points.device))
    counts = _launch_k7(points.to(torch.float32).contiguous(), thr_dev, table=table)
    if ascending:
        return counts
    out = torch.empty_like(counts)
    out[:, torch.from_numpy(order).to(points.device)] = counts
    return out


def _launch_k7(points: torch.Tensor, thr: torch.Tensor, row_tile: int | None = None,
               layout: K7Layout | None = None, mode: int = 0, table: torch.Tensor | None = None) -> torch.Tensor:
    """K7 on ``points`` (S, n, d) float32 and ascending ``thr`` (L,) float32,
    with ``table`` from :func:`_k7_table` for the layout's bucket count
    (built here when None). ``row_tile`` and ``layout`` override the
    launch's shape; ``mode`` 1 or 2 (d = 2, the slot layout) runs only d2
    and the compare with the largest threshold, or adds the bucket, its
    split and the slot, and returns the kernel's register sums (a 1-element
    tensor) instead of counts."""
    n_sets, n, dim = points.shape
    n_thr = thr.numel()
    _cuda.require(points, "points", torch.float32)
    _cuda.require(thr, "thresholds", torch.float32)
    if n >= 2**31 or n_sets >= 2**31 or n_thr >= 2**29:
        raise ValueError("K7 takes fewer than 2^31 points and sets and 2^29 thresholds.")
    layout = layout or _k7_layout(dim, n_thr)
    row_tile = row_tile or _k7_row_tile(n_sets, n)
    if table is None:
        table = _k7_table(thr, layout.n_buckets)
    _cuda.require(table, "table", torch.int32, (3 * (layout.n_buckets + 1) + 1,))
    hist = torch.zeros(n_sets * n_thr + 1, dtype=torch.int64, device=points.device)
    out = torch.empty((n_sets, n_thr), dtype=torch.int64, device=points.device)
    code = _cuda.library().sqt_ripley_pairs(
        points.data_ptr(), n_sets, n, dim, thr.data_ptr(), n_thr, table.data_ptr(), layout.n_buckets,
        _K7_HIST_MODES[layout.hist], layout.copies, int(layout.thr_shared), row_tile,
        mode, hist.data_ptr(), out.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "ripley_pairs")
    _cuda.launches["ripley_pairs"] += 1
    return out if mode == 0 else hist[:1]


def _support_sq(support: np.ndarray) -> np.ndarray:
    """``float32(float64(support) ** 2)``: the squared thresholds, as the JAX package builds them."""
    return (np.asarray(support, dtype=np.float64) ** 2).astype(np.float32)


def _k7_route(n: int, support: np.ndarray, extent: float, device: torch.device) -> str:
    """``pair_counts_cumulative(method='auto')``'s route for one set of ``n``
    points whose box spans ``extent`` (its longest side): ``dense`` (K7)
    or ``binned`` (the planner and K1). On the CPU the JAX package's cut:
    binned from 100,000 points. On the card dense up to
    ``_K7_DENSE_MAX_N`` points, where it was measured faster at Ripley's
    default support and at a 50 um one, and above that while the support
    reaches ``_K7_DENSE_MIN_REACH`` of the extent, where the sweep culls
    little."""
    if device.type != "cuda":
        return "binned" if n >= 100_000 else "dense"
    if n <= _K7_DENSE_MAX_N:
        return "dense"
    reach = float(np.max(support)) / extent if extent > 0 else np.inf
    return "dense" if reach >= _K7_DENSE_MIN_REACH else "binned"


def pair_counts_cumulative(
    points: np.ndarray, support: np.ndarray, *, row_tile: int = 1024, method: str = "auto"
) -> np.ndarray:
    """#ordered pairs (i, j), i != j, with ``d_ij <= support[r]``, float64
    ``(L,)``: the KDTree ``two_point_correlation(...) - n`` quantity of the
    reference's L function.

    ``method='auto'`` takes the route of :func:`_k7_route`: the dense sweep
    (K7) or the binned sweep (K1 with one class); ``'dense'`` and
    ``'binned'`` force one. Both count the same pairs. ``row_tile`` is kept
    for the JAX package's signature and changes nothing."""
    if method not in ("auto", "dense", "binned"):
        raise ValueError(f"Unknown pair-count method `{method}`.")
    dev = get_device()
    if method == "auto":  # the extent matters only past _K7_DENSE_MAX_N points on the card
        n = points.shape[0]
        extent = _extent(points) if dev.type == "cuda" and n > _K7_DENSE_MAX_N else 0.0
        method = _k7_route(n, support, extent, dev)
    if method == "binned":
        from squidpy_torch.ops.pairbins import binned_ordered_pair_counts

        return binned_ordered_pair_counts(points, support)
    pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32)).to(dev)
    # triangular counts doubled to ordered pairs (exact in float64 below 2^53)
    return 2.0 * to_host(_pairs_host_thresholds(pts[None], _support_sq(support))[0]).astype(np.float64)


def _extent(points: np.ndarray) -> float:
    """The longest side of the finite points' box (0 with none)."""
    pts = np.asarray(points, dtype=np.float64)
    pts = pts[np.isfinite(pts).all(axis=1)]
    return float(np.ptp(pts, axis=0).max()) if len(pts) else 0.0


def batched_nn_distances(queries: np.ndarray, clouds: np.ndarray) -> np.ndarray:
    """Nearest-neighbour distance from each query to each simulated cloud:
    ``(m, d) x (S, n, d) -> (S, m)`` float32, in one launch of K8 (k = 1)."""
    dev = get_device()
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
    c = torch.from_numpy(np.ascontiguousarray(clouds, dtype=np.float32)).to(dev)
    return to_host(nearest_points(q, c, 1)[0][..., 0])


def batched_pair_counts(clouds: np.ndarray, support: np.ndarray) -> np.ndarray:
    """Ordered pair counts ``(S, L)`` float64 with ``d <= support[r]`` for
    every simulated cloud, in one launch of K7: the L-mode envelope. Takes at
    most 65,000 points a cloud, as the JAX package does."""
    clouds = np.ascontiguousarray(clouds, dtype=np.float32)
    n = clouds.shape[1]
    if n > 65_000:
        raise ValueError(f"batched_pair_counts is exact only for n ≤ 65k per cloud, got {n}.")
    tri = _pairs_host_thresholds(torch.from_numpy(clouds).to(get_device()), _support_sq(support))
    return 2.0 * to_host(tri).astype(np.float64)


def ppp_sample(
    hull: ConvexHull,
    n_simulations: int,
    n_observations: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Simulate a Poisson point process on a convex hull (host numpy, copied
    from the JAX package).

    Batched rejection sampling: draw uniform points in the bounding box, keep
    those inside the hull triangulation (vectorized ``find_simplex``), repeat
    until filled.
    """
    vxs = hull.points[hull.vertices]
    deln = Delaunay(vxs)
    lo = vxs.min(0)
    hi = vxs.max(0)
    # acceptance probability = hull area / bbox area
    bbox_area = np.prod(hi - lo)
    accept = max(hull.volume / bbox_area, 1e-3)

    result = np.empty((n_simulations, n_observations, 2))
    for s in range(n_simulations):
        filled = 0
        while filled < n_observations:
            need = n_observations - filled
            batch = int(need / accept * 1.2) + 16
            pts = rng.uniform(lo, hi, size=(batch, 2))
            inside = deln.find_simplex(pts) >= 0
            good = pts[inside][:need]
            result[s, filled : filled + len(good)] = good
            filled += len(good)
    return result.squeeze()
