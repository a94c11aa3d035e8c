"""Ripley's pair counts and nearest-neighbour batches, and Poisson point-process
sampling (counterpart of ``squidpy_tpu/ops/ripley.py``).

Pair counts run as kernel K7 on the card (``csrc/ripley_pairs.cu``): every
pair ``i < j`` of a point set, or of each set of a batch, its first
threshold found by a search, counted into a histogram made cumulative;
from 100,000 points on, one set goes to the binned sweep instead (K1 with
one class, :func:`squidpy_torch.ops.pairbins.binned_ordered_pair_counts`),
as in the JAX package. The nearest-neighbour batch of the envelope is
kernel K8 (:func:`squidpy_torch.ops.knn.nearest_points`). The point-process
sampler is host numpy/scipy, copied from the JAX package, so its clouds are
bitwise the same for the same generator.
"""

from __future__ import annotations

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

# K7's launch: 256 threads, a tile of 512 points (rows staged for 1-3
# dimensions), a bucket table, and L-bin uint32 histograms, one a warp where
# they fit
_K7_SMEM_BYTES = 200 * 1024
_K7_TILE = 512
_K7_WARPS = 8
_K7_BUCKETS = 2048
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 26}  # (rows, n) temporaries of K7's plain version


def _k7_layout(dim: int, n_thr: int) -> tuple[int, int]:
    """(shared histogram copies, thresholds staged) of one K7 block: a copy a
    warp, else one, else none (global atomics), with the thresholds staged
    where they fit."""
    base = (_K7_TILE * dim if dim <= 3 else 0) * 4 + _K7_BUCKETS * 4
    for copies in (_K7_WARPS, 1):
        if base + (1 + copies) * n_thr * 4 <= _K7_SMEM_BYTES:
            return copies, 1
    return 0, int(base + n_thr * 4 <= _K7_SMEM_BYTES)


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
    order = torch.argsort(thresholds, stable=True)  # the kernel takes them ascending
    thr = thresholds[order].contiguous()
    if n < 2 or n_thr == 0 or n_sets == 0 or dim == 0:
        return torch.zeros((n_sets, n_thr), dtype=torch.int64, device=points.device)
    if points.device.type == "cpu":
        counts = _ripley_pairs_plain(points.to(torch.float32), thr)
    else:
        counts = _launch_k7(points.to(torch.float32).contiguous(), thr)
    out = torch.empty_like(counts)
    out[:, order] = counts
    return out


def _launch_k7(points: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    n_sets, n, dim = points.shape
    n_thr = thr.numel()
    _cuda.require(points, "points", torch.float32)
    _cuda.require(thr, "thresholds", torch.float32)
    if n >= 2**31 or n_sets >= 2**31 or n_thr >= 2**31:
        raise ValueError("K7 takes fewer than 2^31 points, sets and thresholds.")
    copies, staged = _k7_layout(dim, n_thr)
    hist = torch.zeros(n_sets * n_thr + 1, dtype=torch.int64, device=points.device)
    out = torch.empty((n_sets, n_thr), dtype=torch.int64, device=points.device)
    code = _cuda.library().sqt_ripley_pairs(
        points.data_ptr(), n_sets, n, dim, thr.data_ptr(), n_thr, _K7_BUCKETS, copies, staged, hist.data_ptr(),
        out.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "ripley_pairs")
    _cuda.launches["ripley_pairs"] += 1
    return out


def _support_sq(support: np.ndarray) -> np.ndarray:
    """``float32(float64(support) ** 2)``: the squared thresholds, as the JAX package builds them."""
    return (np.asarray(support, dtype=np.float64) ** 2).astype(np.float32)


def pair_counts_cumulative(
    points: np.ndarray, support: np.ndarray, *, row_tile: int = 1024, method: str = "auto"
) -> np.ndarray:
    """#ordered pairs (i, j), i != j, with ``d_ij <= support[r]``, float64
    ``(L,)``: the KDTree ``two_point_correlation(...) - n`` quantity of the
    reference's L function.

    ``method='auto'`` takes the binned sweep (K1 with one class) from 100,000
    points on, the dense sweep (K7) below; ``'dense'`` and ``'binned'``
    force one. ``row_tile`` is kept for the JAX package's signature and
    changes nothing."""
    if method not in ("auto", "dense", "binned"):
        raise ValueError(f"Unknown pair-count method `{method}`.")
    if method == "binned" or (method == "auto" and points.shape[0] >= 100_000):
        from squidpy_torch.ops.pairbins import binned_ordered_pair_counts

        return binned_ordered_pair_counts(points, support)
    pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32)).to(get_device())
    thr = torch.from_numpy(_support_sq(support)).to(pts.device)
    # triangular counts doubled to ordered pairs (exact in float64 below 2^53)
    return 2.0 * to_host(ripley_pairs(pts, thr)[0]).astype(np.float64)


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
    dev = get_device()
    tri = ripley_pairs(torch.from_numpy(clouds).to(dev), torch.from_numpy(_support_sq(support)).to(dev))
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
