"""Co-occurrence pair counts (counterpart of ``squidpy_tpu/ops/cooccur.py``).

Below 100k points the counts come from a dense triangular sweep over tile
pairs in plain torch (the JAX version is XLA code, not a Pallas kernel); at
scale they come from the binned sweep of :mod:`squidpy_torch.ops.pairbins`,
whose device work is kernel K1. Both give the same exact integer counts. The
JAX package's hi/lo digit pairs were a workaround for the TPU matrix unit's
bf16 inputs; here counts are int64.
"""

from __future__ import annotations

import numpy as np
import torch

from squidpy_torch._device import get_device, to_host

__all__ = ["co_occurrence_counts", "co_occurrence_probs", "cooccur_block_pairs"]


def triangular_block_pairs(n: int, tile: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangle block-pair index lists ``(ti, tj)`` with ``tj >= ti``."""
    n_tiles = (n + tile - 1) // tile
    ti, tj = np.triu_indices(n_tiles)
    return ti.astype(np.int32), tj.astype(np.int32)


def cooccur_block_pairs(
    coords: torch.Tensor, labels: torch.Tensor, thresholds: torch.Tensor, n_cls: int, tile: int
) -> torch.Tensor:
    """Strict-upper-triangle cumulative pair counts ``(L, C, C)`` int64.

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
    dense triangular sweep below; both give identical counts.
    """
    if method not in ("auto", "dense", "binned"):
        raise ValueError(f"Unknown co-occurrence method `{method}`.")
    if method == "binned" or (method == "auto" and coords.shape[0] >= 100_000):
        from squidpy_torch.ops.pairbins import binned_cooccur_counts

        return binned_cooccur_counts(coords, labels, thresholds, n_cls)

    coords = np.ascontiguousarray(coords, dtype=np.float32)
    n = coords.shape[0]
    dev = get_device()
    upper = cooccur_block_pairs(
        torch.from_numpy(coords).to(dev),
        torch.from_numpy(np.asarray(labels, dtype=np.int32)).to(dev),
        torch.from_numpy(np.asarray(thresholds, dtype=np.float32)).to(dev),
        n_cls,
        min(row_tile, max(8, n)),
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
