"""Co-occurrence pair counts (counterpart of ``squidpy_tpu/ops/cooccur.py``).

Below 100k points the counts come from a dense sweep of every pair: kernel
K17 (``csrc/cooccur_pairs.cu``) on the card, its plain torch version
(:func:`cooccur_block_pairs`, a triangular sweep over tile pairs) on the
CPU. At scale they come from the binned sweep of
:mod:`squidpy_torch.ops.pairbins`, whose device work is kernel K1. All give
the same exact integer counts. The JAX package's hi/lo digit pairs were a
workaround for the TPU matrix unit's bf16 inputs; here counts are int64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from squidpy_torch import _cuda
from squidpy_torch._device import get_device, to_host
from squidpy_torch.ops.ripley import _k7_row_tile, _k7_table

__all__ = ["co_occurrence_counts", "co_occurrence_probs", "cooccur_block_pairs", "cooccur_pairs"]

# K17's routes (csrc/cooccur_pairs.cu). The class route: points in class
# order, 2 (L + 2) uint32 counters a lane in shared memory (shared by the 8
# warps of a block), beside the bucket bytes and the thresholds, each copied
# once a lane (1024 buckets), for up to 254 distinct thresholds (a bucket's
# byte holds L + 1). The index route (past it): the bucket table (16 bytes a
# bucket), the staged rows and labels, then copies of the (L, C, C) uint32
# first-bin counters; a second and later copy only while the block stays
# under _K17_COPIES_BYTES (two blocks an SM), at most one a warp. Its
# buckets: 4L, a power of two, within [1024, 4096] (past 1024 thresholds
# some buckets hold several, and their pairs walk the thresholds)
_K17_SMEM_BYTES = 224 * 1024
_K17_COPIES_BYTES = 96 * 1024
_K17_MAX_COPIES = 8
_K17_MIN_BUCKETS, _K17_MAX_BUCKETS = 1024, 4096
_K17_COLS = 1024
_K17_CLASS_BUCKETS = 1024
_K17_CLASS_MAX_THR = 254


class K17Layout(NamedTuple):
    route: str  # "class": class order, lane-private bins; "index": the caller's order, (L, C, C) copies
    copies: int  # the index route's shared copies of the (L, C, C) counters; 0: 64-bit global atomics
    n_buckets: int  # the bucket table's: a power of two
    row_tile: int


def _k17_class_smem(dim: int, n_thr: int, row_tile: int) -> int:
    """Shared bytes of a class-route block: the counters of both directions,
    the thresholds and the bucket bytes, each a lane, the staged rows (1-3
    dimensions) and their indices."""
    rows = row_tile * ((dim if dim <= 3 else 0) + 1)
    return 4 * ((3 * n_thr + 7) * 32 + (_K17_CLASS_BUCKETS // 4 + 1) * 32 + rows)


def _k17_layout(n: int, dim: int, n_thr: int, n_cls: int) -> K17Layout:
    """K17's launch for ``n`` points in ``dim`` dimensions, ``n_thr``
    thresholds and ``n_cls`` classes: the class route wherever its block
    fits, else the index route (:func:`_k17_index_layout`); the row tile is
    K7's rule for one set."""
    row_tile = _k7_row_tile(1, n)
    if n_thr <= _K17_CLASS_MAX_THR and _k17_class_smem(dim, n_thr, row_tile) <= _K17_SMEM_BYTES:
        return K17Layout("class", 0, _K17_CLASS_BUCKETS, row_tile)
    return _k17_index_layout(n, dim, n_thr, n_cls)


def _k17_index_layout(n: int, dim: int, n_thr: int, n_cls: int) -> K17Layout:
    """The index route's launch (the earlier design): its bucket table's size,
    the copies of its (L, C, C) counters that fit shared memory (0: 64-bit
    global atomics) and K7's row tile."""
    row_tile = _k7_row_tile(1, n)
    n_buckets = min(max(_K17_MIN_BUCKETS, 1 << (4 * n_thr - 1).bit_length()), _K17_MAX_BUCKETS)
    fixed = (n_buckets + 1) * 16 + row_tile * ((dim if dim <= 3 else 0) + 1) * 4
    copy = n_thr * n_cls * n_cls * 4
    copies = 0
    if fixed + copy <= _K17_SMEM_BYTES:
        copies = 1
        while copies < _K17_MAX_COPIES and fixed + 2 * copies * copy <= _K17_COPIES_BYTES:
            copies *= 2
    return K17Layout("index", copies, n_buckets, row_tile)


def _k17_scratch_words(n: int, dim: int, n_thr: int, n_cls: int, row_tile: int) -> int:
    """The class route's int64 scratch: the row and column tile tables (int4
    each), a header of 4, the row tiles' item offsets, the (L, C, C) counts,
    then, as int32 and float32 pairs, the class starts, each point's index
    and the points in class order."""
    max_rt = -(-n // row_tile) + n_cls
    max_ct = -(-n // _K17_COLS) + n_cls
    return (2 * max_rt + 2 * max_ct + 4 + max_rt + 1 + n_thr * n_cls * n_cls + (n_cls + 2) // 2 + (n + 1) // 2
            + (n * dim + 1) // 2)


def _bucket_bounds(thr: np.ndarray, n_buckets: int) -> tuple[np.float32, np.ndarray, np.ndarray]:
    """The scale and each bucket's least and largest d2 (float32, ``n_buckets
    + 1`` each) for ascending ``thr``: a d2 takes bucket ``min(floor(float32(d2
    * scale)), n_buckets)``, the top bucket also every d2 past ``thr[-1]``, inf
    and NaN (its largest is inf). As :func:`_k7_table` finds them."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        scale = np.float32(n_buckets) / thr[-1]
    if not (np.isfinite(scale) and scale > 0):
        scale = np.float32(0.0)
    inf = 0x7F800000
    b = np.arange(1, n_buckets + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        x0 = (b / np.float64(scale)).astype(np.float32).view(np.int32).astype(np.int64)
        cand = np.clip(x0[:, None] + np.arange(-4, 5), 0, inf)
        prod = (cand.astype(np.int32).view(np.float32).astype(np.float64) * np.float64(scale)).astype(np.float32)
        ok = np.concatenate([prod >= b[:, None].astype(np.float32), np.ones((len(b), 1), bool)], axis=1)
    cand = np.concatenate([cand, np.full((len(b), 1), inf)], axis=1)
    lo = np.r_[0, cand[np.arange(len(b)), ok.argmax(axis=1)]]
    hi = np.r_[np.maximum(lo[1:] - 1, 0), inf]  # the bucket's largest d2, as bits
    return scale, lo.astype(np.int32).view(np.float32), hi.astype(np.int32).view(np.float32)


def _k17_lane_tables(thr: np.ndarray,
                     n_buckets: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.float32, int]:
    """The class route's tables for distinct ascending float32 ``thr`` (L,):
    the bucket bytes, ``(n_buckets // 4 + 1) * 128`` uint8, bucket b's at
    ``[b // 4][lane][b % 4]`` for each of 32 lanes: the count ``e`` of
    thresholds up to the bucket's largest d2, or L + 1 where more than two
    lie inside it (a walk); the thresholds, ``(L + 3) * 32`` float32, ``[r]
    [lane]`` holding ``thr[r - 2]`` and -inf in rows 0, 1 and L + 2; each
    bucket's first threshold at or above its least d2, int32 ``(n_buckets +
    1,)``; the scale; and the most thresholds a bucket holds, 1 or 2, or 3
    for more. A pair's bin, searchsorted's (L: none), is ``e - (thr[e - 1]
    >= d2) - (thr[e - 2] >= d2)``, the second term only where a bucket holds
    two: a threshold below the bucket is below its d2."""
    n_thr = len(thr)
    scale, lo, hi = _bucket_bounds(thr, n_buckets)
    first = np.searchsorted(thr, lo, side="left")
    e = np.searchsorted(thr, hi, side="right")
    most = int((e - first).max())
    entry = np.where(e - first <= 2, e, n_thr + 1)
    padded = np.full((n_buckets // 4 + 1) * 4, n_thr, np.uint8)
    padded[: n_buckets + 1] = entry
    bins = np.repeat(padded.reshape(-1, 1, 4), 32, axis=1).reshape(-1)
    neg = np.float32(-np.inf)
    thr_rep = np.repeat(np.r_[neg, neg, np.asarray(thr, np.float32), neg].astype(np.float32)[:, None], 32, axis=1)
    return np.ascontiguousarray(bins), thr_rep.reshape(-1), first.astype(np.int32), scale, max(min(most, 3), 1)


def _k17_table(thr: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The index route's bucket table for ascending ``thr`` (L,) float32: int32
    ``(n_buckets + 2, 4)``, a row a bucket holding K7's split (as bits) and
    its two slot bins (:func:`_k7_table`) and a zero, then a row holding the
    scale's bits, so a pair's bucket is one 16-byte load."""
    k7 = _k7_table(thr, n_buckets)
    table = torch.zeros((n_buckets + 2, 4), dtype=torch.int32, device=thr.device)
    table[: n_buckets + 1, 0] = k7[: n_buckets + 1]
    table[: n_buckets + 1, 1:3] = k7[n_buckets + 1 : -1].view(n_buckets + 1, 2)
    table[n_buckets + 1, 0] = k7[-1]
    return table


def triangular_block_pairs(n: int, tile: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangle block-pair index lists ``(ti, tj)`` with ``tj >= ti``."""
    n_tiles = (n + tile - 1) // tile
    ti, tj = np.triu_indices(n_tiles)
    return ti.astype(np.int32), tj.astype(np.int32)


def cooccur_block_pairs(
    coords: torch.Tensor, labels: torch.Tensor, thresholds: torch.Tensor, n_cls: int, tile: int
) -> torch.Tensor:
    """Strict-upper-triangle cumulative pair counts ``(L, C, C)`` int64: the
    plain version of kernel K17, for ascending ``thresholds``.

    Sweeps every upper-triangle ``(tile, tile)`` block once with an ``i < j``
    mask. Each pair's first threshold index with ``d2 <= thr`` is one
    ``searchsorted``; a histogram over it and a cumulative sum over
    thresholds give the counts. d2 is the difference form, rounded as the
    JAX sweep rounds it.
    """
    n, dim = coords.shape
    n_l = thresholds.shape[0]
    cc = n_cls * n_cls
    hist = torch.zeros((n_l + 1) * cc, dtype=torch.int64, device=coords.device)
    lab = labels.to(torch.int64)
    for ti, tj in zip(*triangular_block_pairs(n, tile)):
        i0, j0 = int(ti) * tile, int(tj) * tile
        xi, xj = coords[i0 : i0 + tile], coords[j0 : j0 + tile]
        diff = xi[:, None, 0] - xj[None, :, 0]
        d2 = diff * diff
        for d in range(1, dim):
            diff = xi[:, None, d] - xj[None, :, d]
            d2 = d2 + diff * diff
        la, lb = lab[i0 : i0 + tile], lab[j0 : j0 + tile]
        gi = torch.arange(i0, i0 + xi.shape[0], device=coords.device)
        gj = torch.arange(j0, j0 + xj.shape[0], device=coords.device)
        ok = (
            (gi[:, None] < gj[None, :])
            & ((la >= 0) & (la < n_cls))[:, None]
            & ((lb >= 0) & (lb < n_cls))[None, :]
        )
        r = torch.searchsorted(thresholds, d2)  # first threshold with d2 <= thr
        use = ok & (r < n_l)
        hist += torch.bincount((r * cc + la[:, None] * n_cls + lb[None, :])[use], minlength=hist.numel())
    return hist.view(n_l + 1, n_cls, n_cls).cumsum(0)[:n_l]


def cooccur_pairs(
    coords: torch.Tensor, labels: torch.Tensor, thresholds: np.ndarray, n_cls: int, *, tile: int = 2048
) -> torch.Tensor:
    """Strict-upper-triangle cumulative pair counts ``(L, C, C)`` int64 of
    ``coords`` (n, d) float32 and ``labels`` (n,) int32, both on one device,
    for float32 ``thresholds`` (L,) held on the host, counted ascending
    and returned in their given order.

    A CUDA tensor launches kernel K17; a CPU tensor runs the plain version,
    :func:`cooccur_block_pairs`, with row tiles of ``tile`` points."""
    thr = np.asarray(thresholds, dtype=np.float32).reshape(-1)
    order = np.argsort(thr, kind="stable")
    thr = np.ascontiguousarray(thr[order])
    if coords.device.type == "cpu":
        counts = cooccur_block_pairs(coords, labels, torch.from_numpy(thr), n_cls, tile)
    else:
        counts = _cooccur_k17(coords, labels, thr, n_cls)
    if np.array_equal(order, np.arange(thr.size)):
        return counts
    out = torch.empty_like(counts)
    out[torch.from_numpy(order).to(counts.device)] = counts
    return out


def _cooccur_k17(coords: torch.Tensor, labels: torch.Tensor, thr: np.ndarray, n_cls: int,
                 layout: K17Layout | None = None, mode: int = 0) -> torch.Tensor:
    """Kernel K17's counts ``(L, C, C)`` for ``coords`` (n, d) float32 and
    ``labels`` (n,) int32 on the card and ascending host thresholds ``thr``,
    by the route of :func:`_k17_layout` unless ``layout`` is given. ``mode``
    1 and 2 (d = 2) run the kernel's measuring modes, which count nothing:
    ``out`` then holds no counts, and no launch is counted."""
    n, dim = coords.shape
    if n < 2 or thr.size == 0 or n_cls == 0 or dim == 0:
        return torch.zeros((thr.size, n_cls, n_cls), dtype=torch.int64, device=coords.device)
    if n >= 2**31 - 2 * _K17_COLS or thr.size * n_cls * n_cls >= 2**31:
        raise ValueError("K17 takes fewer than 2^31 points and L * C^2 counters.")
    layout = layout or _k17_layout(n, dim, thr.size, n_cls)
    _cuda.require(coords, "coords", torch.float32)
    _cuda.require(labels, "labels", torch.int32, (n,))
    out = torch.empty((thr.size, n_cls, n_cls), dtype=torch.int64, device=coords.device)
    if layout.route == "class":
        bins, thr_rep, first, scale, tab, inverse = _k17_lane_inputs(thr.tobytes(), layout.n_buckets,
                                                                      str(coords.device))
        n_thr = thr_rep.numel() // 32 - 3  # the distinct thresholds
        words = _k17_scratch_words(n, dim, n_thr, n_cls, layout.row_tile)
        scratch = torch.zeros(words, dtype=torch.int64, device=coords.device)
        counts = out if inverse is None else torch.empty((n_thr, n_cls, n_cls), dtype=torch.int64,
                                                         device=coords.device)
        code = _cuda.library().sqt_cooccur_pairs(
            coords.data_ptr(), labels.data_ptr(), n, dim, n_thr, n_cls, bins.data_ptr(), thr_rep.data_ptr(),
            first.data_ptr(), scale, layout.n_buckets, tab, layout.row_tile, mode, scratch.data_ptr(), words,
            counts.data_ptr(), _cuda.stream_ptr(),
        )
        if inverse is not None:  # a repeated threshold's counts are its value's
            torch.index_select(counts, 0, inverse, out=out)
    else:
        thr_dev, table = _k17_inputs(thr.tobytes(), layout.n_buckets, str(coords.device))
        scratch = torch.zeros(thr.size * n_cls * n_cls + 1, dtype=torch.int64, device=coords.device)
        code = _cuda.library().sqt_cooccur_pairs_index(
            coords.data_ptr(), labels.data_ptr(), n, dim, thr_dev.data_ptr(), thr.size, n_cls, table.data_ptr(),
            layout.n_buckets, layout.copies, layout.row_tile, mode, scratch.data_ptr(), out.data_ptr(),
            _cuda.stream_ptr(),
        )
    _cuda.check(code, "cooccur_pairs")
    if mode == 0:
        _cuda.launches["cooccur_pairs"] += 1
    return out


@functools.lru_cache(maxsize=8)
def _k17_inputs(thr_bytes: bytes, n_buckets: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending float32 thresholds (given as bytes) and the index route's
    bucket table for them, built on the host and moved to ``device`` once a
    support."""
    thr = torch.frombuffer(bytearray(thr_bytes), dtype=torch.float32)
    return thr.to(device), _k17_table(thr, n_buckets).to(device)


@functools.lru_cache(maxsize=8)
def _k17_lane_inputs(thr_bytes: bytes, n_buckets: int,
                     device: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, float, int, torch.Tensor | None]:
    """The class route's tables (:func:`_k17_lane_tables`) for the distinct
    values of ascending float32 thresholds given as bytes, built on the host
    and moved to ``device`` once a support, and each threshold's place among
    the distinct values where some repeat (else None)."""
    uniq, inverse = np.unique(np.frombuffer(thr_bytes, np.float32), return_inverse=True)
    bins, thr_rep, first, scale, tab = _k17_lane_tables(uniq, n_buckets)
    places = None if uniq.size * 4 == len(thr_bytes) else torch.from_numpy(inverse.reshape(-1)).to(device)
    return (torch.from_numpy(bins).to(device), torch.from_numpy(thr_rep).to(device),
            torch.from_numpy(first).to(device), float(scale), tab, places)


def co_occurrence_counts(
    coords: np.ndarray,
    labels: np.ndarray,
    thresholds: np.ndarray,
    n_cls: int,
    *,
    row_tile: int = 2048,
    method: str = "auto",
) -> np.ndarray:
    """Cumulative pair counts ``(C, C, L)`` float64 with ``d2 <= thresholds[r]``
    (``counts[label_i, label_j, r]``, self-pairs excluded).

    ``method='auto'`` takes the binned sweep at 100k points and above and the
    dense sweep below (K17 on the card); both give identical counts.
    """
    if method not in ("auto", "dense", "binned"):
        raise ValueError(f"Unknown co-occurrence method `{method}`.")
    if method == "binned" or (method == "auto" and coords.shape[0] >= 100_000):
        from squidpy_torch.ops.pairbins import binned_cooccur_counts

        return binned_cooccur_counts(coords, labels, thresholds, n_cls)

    coords = np.ascontiguousarray(coords, dtype=np.float32)
    n = coords.shape[0]
    dev = get_device()
    upper = cooccur_pairs(
        torch.from_numpy(coords).to(dev),
        torch.from_numpy(np.ascontiguousarray(labels, dtype=np.int32)).to(dev),
        thresholds,
        n_cls,
        tile=min(row_tile, max(8, n)),
    )
    counts = to_host(upper, np.float64)
    ordered = counts + np.swapaxes(counts, 1, 2)  # (L, C, C)
    return np.transpose(ordered, (1, 2, 0))


def co_occurrence_probs(counts: np.ndarray) -> np.ndarray:
    """Conditional co-occurrence probability ratio (copied from the JAX package).

    ``occ_prob[i, c, r] = P(label_i | within r of a cell with label_c) / P(label_i)``.
    """
    k, _, n_l = counts.shape
    occ_prob = np.zeros((k, k, n_l), dtype=np.float64)
    row_sums = counts.sum(axis=0)  # (k, L): total pairs with second label == c
    totals = row_sums.sum(axis=0)  # (L,)
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in range(n_l):
            if totals[r] == 0:
                continue
            probs = row_sums[:, r] / totals[r]
            for c in range(k):
                for i in range(k):
                    if probs[i] != 0.0 and row_sums[c, r] != 0.0:
                        occ_prob[i, c, r] = (counts[c, i, r] / row_sums[c, r]) / probs[i]
    return occ_prob
