"""Kernel K1: boundary-block pair counts of the binned sweep.

Counterpart of ``squidpy_tpu/ops/pallas_binned.py``. For each planned work
item (tile pair ``ti <= tj``, threshold group ``gid``, window ``[rempty,
rfull)``) it counts the class pairs ``(a, b)`` of points ``i < j`` with
``d2(i, j) <= thr[r]`` for every threshold ``r`` of the group inside the
window. On a CUDA tensor it launches ``csrc/binned_pairs.cu``, one block per
distinct tile pair (:func:`segments` folds a pair's items into one window);
on the CPU it runs the plain torch version below. Counts are int64, so none
of the TPU kernel's item chunking, zero-initialising dummy items, base-4096
digits or 8M-item exactness bound is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from squidpy_torch import _cuda

__all__ = ["binned_pair_counts", "binned_pairs", "chunk_pairs_kept", "segments"]

# shared-memory budget of one K1 block: the two staged tiles, then as many
# (C, C) int32 histogram rows as fit
_K1_SMEM_BYTES = 200 * 1024
# the kernel culls candidate pairs by the bounding boxes of 32-point chunks
_K1_CHUNK = 32


def _k1_layout(tile: int, dim: int, n_thr: int, n_cls: int) -> tuple[int, int]:
    """(bytes of the staged tiles, chunk boxes and thresholds; shared
    histogram rows) of one K1 block. The rows (at most ``n_thr``) cover the
    top of each window, beside one overflow row; 0 when fewer than two rows
    fit, and every pair then takes global atomics."""
    nchunk = -(-tile // _K1_CHUNK)
    base = (2 * tile * dim + 4 * nchunk * dim + n_thr) * 4 + 2 * tile * 4
    fit = (_K1_SMEM_BYTES - base) // (n_cls * n_cls * 4)
    return base, min(n_thr, fit - 1) if fit >= 2 else 0


def segments(items: torch.Tensor, n_thr: int, gsize: int) -> torch.Tensor:
    """``(4, S)`` int32 rows ``ti, tj, lo, hi``: one per distinct tile pair of
    the ``(5, B)`` items, in their order, with the window ``[lo, hi)`` that
    its items' threshold groups cover. A pair's items are consecutive and
    list its groups in order (as the planner writes them), so the window
    runs from the first item's group start (raised to ``rempty``) to the
    last item's group end (cut at ``rfull`` and ``n_thr``). Computed on the
    items' device."""
    it = items[:, items[0] >= 0].to(torch.int64)
    ti, tj, rf, re, gid = it
    if ti.numel() == 0:
        return torch.empty((4, 0), dtype=torch.int32, device=items.device)
    first = torch.ones_like(ti, dtype=torch.bool)
    first[1:] = (ti[1:] != ti[:-1]) | (tj[1:] != tj[:-1])
    start = torch.nonzero(first).squeeze(1)
    last = torch.cat([start[1:] - 1, start.new_tensor([ti.numel() - 1])])
    lo = torch.maximum(re[start], gid[start] * gsize)
    hi = torch.minimum(torch.minimum(rf[last], (gid[last] + 1) * gsize), torch.full_like(lo, n_thr))
    seg = torch.stack([ti[start], tj[start], lo, hi])
    return seg[:, hi > lo].to(torch.int32).contiguous()


def chunk_pairs_kept(coords_p: torch.Tensor, n: int, seg: torch.Tensor, thr: torch.Tensor,
                     tile: int) -> torch.Tensor:
    """Plain torch version of K1's culling predicate: ``(S, m, m)`` bool over
    the 32-point chunk pairs ``(a, b)`` of each segment's tiles (``m`` chunks
    a tile), False where the chunks' bounding boxes (over real points) are
    farther apart than the window's last threshold, with the planner's
    margin ``dmin2 * (1 - 1e-5) - 1e-30`` in float64."""
    dev = coords_p.device
    dim = coords_p.shape[1]
    m = -(-tile // _K1_CHUNK)
    t = torch.arange(m * _K1_CHUNK, device=dev)
    tiles = torch.unique(seg[:2].long())
    gidx = tiles[:, None] * tile + t  # (T, m * 32)
    real = (t < tile) & (gidx < n)
    pts = coords_p[gidx.clamp(max=coords_p.shape[0] - 1)].double()
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    lo_box = torch.where(real[..., None], pts, inf).view(-1, m, _K1_CHUNK, dim).amin(2)  # (T, m, d)
    hi_box = torch.where(real[..., None], pts, -inf).view(-1, m, _K1_CHUNK, dim).amax(2)
    pos = torch.searchsorted(tiles, seg[:2].long())
    alo, ahi = lo_box[pos[0]][:, :, None], hi_box[pos[0]][:, :, None]  # (S, m, 1, d)
    blo, bhi = lo_box[pos[1]][:, None], hi_box[pos[1]][:, None]  # (S, 1, m, d)
    gap = torch.clamp(torch.maximum(blo - ahi, alo - bhi), min=0.0)
    dmin2 = torch.sum(gap * gap, dim=-1)
    reach = thr[seg[3].long() - 1].double()[:, None, None]
    return ~(reach < dmin2 * (1.0 - 1e-5) - 1e-30)


def _binned_plain(
    coords_p: torch.Tensor,
    labels_p: torch.Tensor,
    n: int,
    items: torch.Tensor,
    thr: torch.Tensor,
    n_thr: int,
    tile: int,
    gsize: int,
    n_cls: int,
) -> torch.Tensor:
    """Plain torch version of K1, batched over items.

    Each pair's first threshold index ``r`` with ``d2 <= thr[r]`` (one
    ``searchsorted``), raised to the item's window start, adds +1 at ``r``
    and -1 at the window end; a cumulative sum over thresholds then gives
    each threshold's count inside every item's window.
    """
    dev = coords_p.device
    cc = n_cls * n_cls
    ti, tj, rf, re, gid = items.to(torch.int64)
    off = gid * gsize
    lo = torch.maximum(re, off)
    hi = torch.minimum(torch.minimum(rf, off + gsize), torch.full_like(off, n_thr))
    keep = (ti >= 0) & (hi > lo)
    ti, tj, lo, hi = ti[keep], tj[keep], lo[keep], hi[keep]
    thr_real = thr[:n_thr].contiguous()
    delta = torch.zeros((n_thr + 1) * cc, dtype=torch.int64, device=dev)
    ar = torch.arange(tile, device=dev)
    budget = (1 << 24) if dev.type == "cuda" else (1 << 21)
    step = max(1, budget // (tile * tile))
    for b0 in range(0, ti.shape[0], step):
        gi = ti[b0 : b0 + step, None] * tile + ar  # (b, t)
        gj = tj[b0 : b0 + step, None] * tile + ar
        xi, xj = coords_p[gi], coords_p[gj]  # (b, t, d)
        # difference form, one rounded multiply and add per dimension, as
        # the kernel and the JAX engines compute it
        diff = xi[:, :, None, 0] - xj[:, None, :, 0]
        d2 = diff * diff
        for dim in range(1, coords_p.shape[1]):
            diff = xi[:, :, None, dim] - xj[:, None, :, dim]
            d2 = d2 + diff * diff
        la = labels_p[gi].to(torch.int64)
        lb = labels_p[gj].to(torch.int64)
        ok = (
            (gi[:, :, None] < gj[:, None, :])
            & (gj < n)[:, None, :]
            & ((la >= 0) & (la < n_cls))[:, :, None]
            & ((lb >= 0) & (lb < n_cls))[:, None, :]
        )
        lo_b = lo[b0 : b0 + step, None, None]
        hi_b = hi[b0 : b0 + step, None, None]
        r = torch.maximum(torch.searchsorted(thr_real, d2), lo_b)
        use = ok & (r < hi_b)
        e = la[:, :, None] * n_cls + lb[:, None, :]
        delta += torch.bincount((r * cc + e)[use], minlength=delta.numel())
        delta -= torch.bincount((hi_b * cc + e)[use], minlength=delta.numel())
    return delta.view(n_thr + 1, n_cls, n_cls).cumsum(0)[:n_thr]


def binned_pairs(
    coords_p: torch.Tensor,
    labels_p: torch.Tensor,
    n: int,
    items: torch.Tensor,
    thr: torch.Tensor,
    n_thr: int,
    tile: int,
    gsize: int,
    n_cls: int,
) -> torch.Tensor:
    """Kernel K1: ``(n_thr, C, C)`` int64 strict-upper boundary counts.

    ``coords_p`` (n_pad, d) float32 and ``labels_p`` (n_pad,) int32 are
    tile-padded (labels -1 on padding); ``items`` is (5, B) int32 rows
    ``ti, tj, rfull, rempty, gid``; ``thr`` holds the ``G * gsize`` squared
    thresholds, of which the first ``n_thr`` are real. A CPU tensor runs the
    plain torch version; a CUDA tensor launches the kernel.
    """
    if coords_p.device.type == "cpu":
        return _binned_plain(coords_p, labels_p, n, items, thr, n_thr, tile, gsize, n_cls)
    n_pad, dim = coords_p.shape
    _cuda.require(coords_p, "coords_p", torch.float32)
    _cuda.require(labels_p, "labels_p", torch.int32, (n_pad,))
    _cuda.require(items, "items", torch.int32)
    _cuda.require(thr, "thr", torch.float32)
    if dim not in (2, 3):
        raise ValueError(f"the binned pair kernel takes 2D or 3D coordinates, found {dim}.")
    if items.ndim != 2 or items.shape[0] != 5:
        raise ValueError(f"`items` must have shape (5, B), found {tuple(items.shape)}.")
    if n_pad % tile or thr.numel() % gsize or not 0 <= n_thr <= thr.numel() or n > n_pad:
        raise ValueError("inconsistent tile padding, threshold groups or point count.")
    base, hist_rows = _k1_layout(tile, dim, n_thr, n_cls)
    if base > _K1_SMEM_BYTES:
        raise ValueError(f"tile {tile} does not fit the kernel's shared memory.")
    n_tiles = n_pad // tile
    if items.shape[1] and (int(items[:2].min()) < -1 or int(items[:2].max()) >= n_tiles
                           or int(items[4].min()) < 0 or int(items[4].max()) * gsize >= thr.numel()):
        raise ValueError("work items point outside the padded tiles or threshold groups.")
    out = torch.empty((n_thr, n_cls, n_cls), dtype=torch.int64, device=coords_p.device)
    if n_thr == 0:
        return out
    seg = segments(items, n_thr, gsize)
    delta = torch.zeros((n_thr + 1, n_cls, n_cls), dtype=torch.int64, device=coords_p.device)
    code = _cuda.library().sqt_binned_pairs(
        coords_p.data_ptr(), labels_p.data_ptr(), n, dim, seg.data_ptr(), seg.shape[1], thr.data_ptr(), n_thr,
        tile, n_cls, hist_rows, delta.data_ptr(), out.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "binned_pairs")
    _cuda.launches["binned_pairs"] += 1
    return out


def binned_inputs(
    coords_s: np.ndarray, labels_s: np.ndarray, plan: object, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Device inputs of :func:`binned_pairs` for a Morton-sorted input and its
    plan: padded coordinates and labels, the real items, the thresholds and
    their count."""
    n, dim = coords_s.shape
    coords_p = np.zeros((plan.n_pad, dim), np.float32)
    coords_p[:n] = coords_s
    labels_p = np.full(plan.n_pad, -1, np.int32)
    labels_p[:n] = labels_s
    m = plan.n_items
    items = np.stack([plan.ti[:m], plan.tj[:m], plan.rfull[:m], plan.rempty[:m], plan.gid[:m]]).astype(np.int32)
    thr = np.ascontiguousarray(plan.thr_groups.ravel(), dtype=np.float32)
    n_thr = int(np.isfinite(thr).sum())
    return (
        torch.from_numpy(coords_p).to(device),
        torch.from_numpy(labels_p).to(device),
        torch.from_numpy(items).to(device),
        torch.from_numpy(thr).to(device),
        n_thr,
    )


def binned_pair_counts(
    coords_s: np.ndarray, labels_s: np.ndarray, plan: object, n_cls: int, *, device: torch.device
) -> torch.Tensor:
    """``(L, C, C)`` int64 boundary-block upper counts for a Morton-sorted
    input and its plan; the plan's analytic full-block counts are not added."""
    coords_p, labels_p, items, thr, n_thr = binned_inputs(coords_s, labels_s, plan, device)
    return binned_pairs(coords_p, labels_p, plan.n, items, thr, n_thr, plan.tile, plan.gsize, n_cls)
