"""Dense all-pairs co-occurrence counts (counterpart of ``squidpy_tpu/ops/pallas_pairs.py``).

``co_occurrence(use_pallas=True)`` counts, for every squared threshold, the
ordered pairs ``i != j`` per class pair with ``d2 <= thr``, where d2 is the
expanded form ``(|p_i|^2 + |p_j|^2) - 2 <p_i, p_j>`` that the JAX package's
Pallas kernel computes. On a CUDA tensor the count runs as kernel K2
(``csrc/dense_pairs.cu``); on the CPU it runs the plain torch version below,
which rounds every product and sum on its own, in the kernel's order, so the
two agree bitwise. Counts are int64: the TPU kernel's float32 slabs are exact
only below 2^24 per (class pair, threshold), these at any size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from squidpy_torch import _cuda
from squidpy_torch._device import get_device, to_host

__all__ = ["MAX_CLASSES", "dense_pair_counts", "dense_pairs"]

# the JAX kernel pads the one-hot labels to 128 lanes
MAX_CLASSES = 128

# shared-memory budget of one K2 block: the staged row tile (and column tile
# for a runtime dimension), thresholds, bucket table and, when it fits, the
# (L, C * C + 1) uint32 histogram
_K2_SMEM_BYTES = 200 * 1024
_SM_SMEM_BYTES = 228 * 1024  # shared memory of one H100 SM; each block also reserves 1 KB
_K2_THREADS = 512  # 2D and 3D blocks
_K2_MAX_REG = 2  # column points a thread keeps in registers: 1 or 2
_K2_PAIRS_PER_BLOCK = 8  # a tile is made smaller until each block has this many tile pairs
K2_BUCKETS = 2048  # d2 buckets of the threshold table (even)
H100_SMS = 132


class K2Layout(NamedTuple):
    tile: int  # points per tile: threads x reg
    reg: int  # column points per thread
    threads: int
    blocks: int  # persistent blocks asked for: as many as shared memory and threads let share every SM
    tile_pairs: int  # tile pairs ti <= tj of the upper triangle
    flush_every: int  # tile pairs a block may add into its uint32 histogram between flushes
    n_buckets: int
    shared: bool  # whether the (L, C, C) histogram sits in shared memory


def _k2_layout(n: int, dim: int, n_thr: int, n_cls: int, n_sm: int = H100_SMS) -> K2Layout:
    """K2's launch shape. 2D and 3D points: ``_K2_THREADS`` threads, each
    keeping ``reg`` column points in registers, the largest up to
    ``_K2_MAX_REG`` that leaves every block ``_K2_PAIRS_PER_BLOCK`` tile
    pairs among those that keep the histogram in shared memory (when any
    does). Other dimensions: one column point a thread, tile 256 (64 above 16
    dimensions). The launcher runs at most as many blocks as the card's
    occupancy (registers included) keeps resident."""
    stride = (dim + 5) // 4 * 4 if dim in (2, 3) else dim + 2
    cands = []
    for reg in range(_K2_MAX_REG, 0, -1) if dim in (2, 3) else (1,):
        tile = _K2_THREADS * reg if dim in (2, 3) else (256 if dim <= 16 else 64)
        staged = 1 if dim in (2, 3) else 2
        base = (staged * tile * stride + n_thr) * 4 + K2_BUCKETS * 2
        if base > _K2_SMEM_BYTES:
            continue
        hist = n_thr * (n_cls * n_cls + 1) * 4  # rows padded by one bin against bank conflicts
        shared = base + hist <= _K2_SMEM_BYTES
        threads = tile // reg
        per_sm = max(1, min(2048 // threads, _SM_SMEM_BYTES // (base + hist * shared + 1024)))
        n_tiles = -(-n // tile)
        cands.append(K2Layout(tile, reg, threads, per_sm * n_sm, n_tiles * (n_tiles + 1) // 2,
                              (2**31 - 1) // tile**2, K2_BUCKETS, shared))
    if not cands:
        raise ValueError(f"{dim}-dimensional points do not fit the dense pair kernel's shared memory.")
    if any(c.shared for c in cands):
        cands = [c for c in cands if c.shared]
    return next((c for c in cands if c.tile_pairs >= _K2_PAIRS_PER_BLOCK * c.blocks), cands[-1])


def _k2_table(thr: np.ndarray, n_buckets: int) -> tuple[np.float32, np.ndarray]:
    """Plain version of the threshold table each K2 block builds in shared
    memory, for ascending float32 ``thr``: ``scale = fl(n_buckets /
    thr[-1])`` (0 unless positive and finite) and, per bucket ``b``, the
    first ``k`` with ``thr[k] >= x_b`` (at most ``L - 1``), where ``x_b`` is
    the least float32 ``x`` with ``fl(x * scale) >= b`` (``-inf`` for bucket
    0). A d2 lands in bucket ``clip(int(fl(d2 * scale)), 0, n_buckets - 1)``,
    so its first threshold is at or after its bucket's entry."""
    thr = np.asarray(thr, np.float32)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        scale = np.float32(n_buckets) / thr[-1]
    if not (np.isfinite(scale) and scale > 0):
        scale = np.float32(0)
    first = np.zeros(n_buckets, np.int64)
    if scale > 0:
        b = np.arange(1, n_buckets, dtype=np.float32)
        x = b / scale  # within a few ulps of x_b: step down past it, then up onto it
        while np.any(down := x * scale >= b):
            x = np.where(down, np.nextafter(x, np.float32(-np.inf)), x)
        while np.any(up := x * scale < b):
            x = np.where(up, np.nextafter(x, np.float32(np.inf)), x)
        first[1:] = np.minimum(np.searchsorted(thr, x, side="left"), len(thr) - 1)
    return scale, first


def _expanded_d2(pi: torch.Tensor, pj: torch.Tensor, ni: torch.Tensor, nj: torch.Tensor) -> torch.Tensor:
    dot = pi[:, None, 0] * pj[None, :, 0]
    for k in range(1, pi.shape[1]):
        dot = dot + pi[:, None, k] * pj[None, :, k]
    return (ni[:, None] + nj[None, :]) - 2.0 * dot


def _sq_norms(pts: torch.Tensor) -> torch.Tensor:
    norm = pts[:, 0] * pts[:, 0]
    for k in range(1, pts.shape[1]):
        norm = norm + pts[:, k] * pts[:, k]
    return norm


def _dense_plain(pts: torch.Tensor, labels: torch.Tensor, thr: torch.Tensor, n_cls: int) -> torch.Tensor:
    """Plain torch version of K2 for ascending ``thr``: each pair i < j's first
    threshold index (one ``searchsorted``) is histogrammed, then the ordered
    cumulative counts are ``cumsum(h + h^T)`` over thresholds."""
    n = pts.shape[0]
    n_thr = thr.shape[0]
    cc = n_cls * n_cls
    hist = torch.zeros((n_thr + 1) * cc, dtype=torch.int64, device=pts.device)
    norms = _sq_norms(pts)
    lab = labels.to(torch.int64)
    ok_lab = (lab >= 0) & (lab < n_cls)
    step = max(1, (1 << 24) // max(n, 1))
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        d2 = _expanded_d2(pts[i0:i1], pts[i0:], norms[i0:i1], norms[i0:])
        gi = torch.arange(i0, i1, device=pts.device)
        gj = torch.arange(i0, n, device=pts.device)
        ok = (gi[:, None] < gj[None, :]) & ok_lab[i0:i1, None] & ok_lab[None, i0:]
        r = torch.searchsorted(thr, d2)  # first threshold with d2 <= thr; NaN sorts past the end
        use = ok & (r < n_thr)
        e = r * cc + lab[i0:i1, None] * n_cls + lab[None, i0:]
        hist += torch.bincount(e[use], minlength=hist.numel())
    h = hist.view(n_thr + 1, n_cls, n_cls)[:n_thr]
    return (h + h.transpose(1, 2)).cumsum(0)


def dense_pairs(pts: torch.Tensor, labels: torch.Tensor, thr: torch.Tensor, n_cls: int,
                stats: dict | None = None) -> torch.Tensor:
    """Kernel K2: ``(L, C, C)`` int64 cumulative ordered pair counts.

    ``pts`` (n, d) float32, ``labels`` (n,) int32 (labels outside ``[0, C)``
    are not counted), ``thr`` (L,) float32 squared thresholds sorted
    ascending. A CPU tensor runs the plain torch version; a CUDA tensor
    launches the kernel. Given a ``stats`` dict, a launch fills it with its
    layout, the blocks it launched, the histogram flushes and the most tile
    pairs one block took (this waits for the card).
    """
    if not 1 <= n_cls <= MAX_CLASSES:
        raise ValueError(f"the dense pair kernel takes 1 to {MAX_CLASSES} classes, found {n_cls}.")
    if pts.device.type == "cpu":
        return _dense_plain(pts, labels, thr, n_cls)
    n, dim = pts.shape
    n_thr = thr.shape[0]
    _cuda.require(pts, "pts", torch.float32)
    _cuda.require(labels, "labels", torch.int32, (n,))
    _cuda.require(thr, "thr", torch.float32, (n_thr,))
    if not 0 < dim <= 128:
        raise ValueError(f"the dense pair kernel takes 1 to 128 dimensions, found {dim}.")
    if n >= 2**31:
        raise ValueError(f"too many points for the dense pair kernel: {n}.")
    out = torch.zeros((n_thr, n_cls, n_cls), dtype=torch.int64, device=pts.device)
    if n < 2 or n_thr == 0:
        return out
    if bool((thr[1:] < thr[:-1]).any()):
        raise ValueError("thresholds must be sorted ascending.")
    lay = _k2_layout(n, dim, n_thr, n_cls, torch.cuda.get_device_properties(pts.device).multi_processor_count)
    # the (L, C, C) histogram, then the tile-pair counter, the two tallies and the blocks launched
    hist = torch.zeros(n_thr * n_cls * n_cls + 4, dtype=torch.int64, device=pts.device)
    code = _cuda.library().sqt_dense_pairs(
        pts.data_ptr(), labels.data_ptr(), n, dim, thr.data_ptr(), n_thr, n_cls, lay.n_buckets,
        lay.tile, lay.reg, lay.blocks, lay.flush_every, int(lay.shared), hist.data_ptr(), out.data_ptr(),
        _cuda.stream_ptr(),
    )
    _cuda.check(code, "dense_pairs")
    _cuda.launches["dense_pairs"] += 1
    if stats is not None:
        stats.update(lay._asdict(), launched_blocks=int(hist[-1]), flushes=int(hist[-3]),
                     most_tile_pairs=int(hist[-2]))
    return out


def dense_pair_counts(coords: np.ndarray, labels: np.ndarray, thresholds: np.ndarray, n_cls: int) -> np.ndarray:
    """Cumulative ordered pair counts ``(C, C, L)`` float64 with ``d2 <= thresholds[l]``,
    self-pairs excluded, the thresholds in the caller's order."""
    dev = get_device()
    thr = np.asarray(thresholds, dtype=np.float32).ravel()
    order = np.argsort(thr, kind="stable")
    counts = dense_pairs(
        torch.from_numpy(np.ascontiguousarray(coords, dtype=np.float32)).to(dev),
        torch.from_numpy(np.asarray(labels, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(thr[order])).to(dev),
        n_cls,
    )
    out = np.empty((len(thr), n_cls, n_cls), dtype=np.float64)
    out[order] = to_host(counts, np.float64)
    return np.transpose(out, (1, 2, 0))
