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

# K17's shared memory: the bucket table (16 bytes a bucket), the staged rows
# and labels, then copies of the (L, C, C) uint32 first-bin counters; a
# second and later copy only while the block stays under _K17_COPIES_BYTES
# (two blocks an SM), at most one a warp. The buckets: 4L, a power of two,
# within [1024, 4096] (past 1024 thresholds some buckets hold several, and
# their pairs walk the thresholds)
_K17_SMEM_BYTES = 224 * 1024
_K17_COPIES_BYTES = 96 * 1024
_K17_MAX_COPIES = 8
_K17_MIN_BUCKETS, _K17_MAX_BUCKETS = 1024, 4096


class K17Layout(NamedTuple):
    copies: int  # shared copies of the (L, C, C) counters; 0: 64-bit global atomics
    n_buckets: int  # the bucket table's (`_k17_table`): a power of two
    row_tile: int


def _k17_layout(n: int, dim: int, n_thr: int, n_cls: int) -> K17Layout:
    """K17's launch for ``n`` points in ``dim`` dimensions, ``n_thr``
    thresholds and ``n_cls`` classes: the counters' copies, the bucket
    table's size and the row tile (K7's rule for one set)."""
    row_tile = _k7_row_tile(1, n)
    n_buckets = min(max(_K17_MIN_BUCKETS, 1 << (4 * n_thr - 1).bit_length()), _K17_MAX_BUCKETS)
    fixed = (n_buckets + 1) * 16 + row_tile * ((dim if dim <= 3 else 0) + 1) * 4
    copy = n_thr * n_cls * n_cls * 4
    copies = 0
    if fixed + copy <= _K17_SMEM_BYTES:
        copies = 1
        while copies < _K17_MAX_COPIES and fixed + 2 * copies * copy <= _K17_COPIES_BYTES:
            copies *= 2
    return K17Layout(copies, n_buckets, row_tile)


def _k17_table(thr: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """K17's bucket table for ascending ``thr`` (L,) float32: int32
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


def _cooccur_k17(coords: torch.Tensor, labels: torch.Tensor, thr: np.ndarray, n_cls: int) -> torch.Tensor:
    """Kernel K17's counts ``(L, C, C)`` for ``coords`` (n, d) float32 and
    ``labels`` (n,) int32 on the card and ascending host thresholds ``thr``."""
    n, dim = coords.shape
    if n < 2 or thr.size == 0 or n_cls == 0 or dim == 0:
        return torch.zeros((thr.size, n_cls, n_cls), dtype=torch.int64, device=coords.device)
    if n >= 2**31 - 2 * 1024 or thr.size * n_cls * n_cls >= 2**31:
        raise ValueError("K17 takes fewer than 2^31 points and L * C^2 counters.")
    layout = _k17_layout(n, dim, thr.size, n_cls)
    thr_dev, table = _k17_inputs(thr.tobytes(), layout.n_buckets, str(coords.device))
    _cuda.require(coords, "coords", torch.float32)
    _cuda.require(labels, "labels", torch.int32, (n,))
    hist = torch.zeros(thr.size * n_cls * n_cls + 1, dtype=torch.int64, device=coords.device)
    out = torch.empty((thr.size, n_cls, n_cls), dtype=torch.int64, device=coords.device)
    code = _cuda.library().sqt_cooccur_pairs(
        coords.data_ptr(), labels.data_ptr(), n, dim, thr_dev.data_ptr(), thr.size, n_cls, table.data_ptr(),
        layout.n_buckets, layout.copies, layout.row_tile, hist.data_ptr(), out.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "cooccur_pairs")
    _cuda.launches["cooccur_pairs"] += 1
    return out


@functools.lru_cache(maxsize=8)
def _k17_inputs(thr_bytes: bytes, n_buckets: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending float32 thresholds (given as bytes) and K17's bucket table
    for them, built on the host and moved to ``device`` once a support."""
    thr = torch.frombuffer(bytearray(thr_bytes), dtype=torch.float32)
    return thr.to(device), _k17_table(thr, n_buckets).to(device)


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
