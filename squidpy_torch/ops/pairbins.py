"""Spatially binned pair-count sweep (counterpart of ``squidpy_tpu/ops/pairbins.py``).

Points are Morton-sorted; every upper-triangle tile pair is classified per
threshold as empty, analytically full (``cnt_i x cnt_j``, no distances) or
boundary, and only boundary (tile pair, threshold group) work items reach
the device, where kernel K1 (:mod:`squidpy_torch.ops.binned_kernel`) counts
them. The host planner below (``_part1by1`` .. ``plan_binned_pairs``) is a
verbatim numpy copy of the JAX package's, so plans are bitwise equal; its
conservative empty/full margins cover the difference-form f32 distances the
kernel computes, and the counts equal the dense sweep's exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from squidpy_torch._device import get_device, to_host
from squidpy_torch.ops.binned_kernel import binned_pair_counts

__all__ = [
    "BinnedPairPlan",
    "binned_cooccur_counts",
    "morton_argsort",
    "plan_binned_pairs",
    "sorted_plan",
]


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of ``x`` so bit i lands at position 2i."""
    x = x.astype(np.uint64) & np.uint64(0xFFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x33333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x55555555)
    return x


def morton_argsort(coords: np.ndarray) -> np.ndarray:
    """Stable Morton-order (Z-curve) permutation of 2D/3D points.

    Pair counts are invariant to point order; the Z-curve only tightens the
    per-tile bounding boxes that drive the empty/full block classification.
    """
    c = np.asarray(coords, dtype=np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-300)
    d = c.shape[1]
    if d >= 3:
        # 3 dims × 10 bits interleaved (bbox tightness only; exactness never
        # depends on the ordering)
        q = np.minimum(((c[:, :3] - lo[:3]) / span[:3] * 1023.0).astype(np.uint64), 1023)
        code = np.zeros(len(c), dtype=np.uint64)
        for axis in range(3):
            x = q[:, axis]
            x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
            x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
            x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
            x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
            code |= x << np.uint64(axis)
    elif d == 2:
        q = np.minimum(((c - lo) / span * 65535.0).astype(np.uint64), 65535)
        code = _part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << np.uint64(1))
    else:
        code = c[:, 0]
    return np.argsort(code, kind="stable")


@dataclass
class BinnedPairPlan:
    """Host-side plan: boundary work list + analytic full-block counts."""

    tile: int
    gsize: int
    n: int
    n_pad: int
    ti: np.ndarray  # (B,) int32 block row ids, −1 = padding item
    tj: np.ndarray  # (B,) int32
    rfull: np.ndarray  # (B,) int32 first threshold index where the block is full
    rempty: np.ndarray  # (B,) int32 first threshold index where the block is non-empty
    gid: np.ndarray  # (B,) int32 threshold-group id of this work item
    thr_groups: np.ndarray  # (G, gsize) f32 squared thresholds, −inf padded
    offsets: np.ndarray  # (G,) int32 global threshold index of each group start
    full_cum: np.ndarray  # (L, C, C) float64 cumulative full-block upper counts
    n_items: int  # real items before padding
    n_pairs_total: int  # all upper-triangle block pairs (diagnostics)


def _bucket_len(n: int, minimum: int = 256) -> int:
    """Round a work-list length up so different datasets share executables."""
    b = minimum
    while b < n:
        b *= 2
    return b


def plan_binned_pairs(
    coords_sorted: np.ndarray,
    labels_sorted: np.ndarray,
    thresholds_sq: np.ndarray,
    n_cls: int,
    *,
    tile: int,
    gsize: int = 8,
    bucket_min: int = 256,
    pair_enum: str = "auto",
) -> BinnedPairPlan:
    """Classify every upper-triangle tile pair against every threshold.

    ``coords_sorted`` must already be Morton-sorted f32; ``thresholds_sq``
    ascending squared thresholds (any float dtype, compared in f64 with a
    conservative margin for the device's f32 expanded-form rounding).

    ``pair_enum`` selects the tile-pair enumeration: ``'triu'`` classifies
    all T² upper-triangle pairs, ``'tree'`` enumerates only KDTree-near
    pairs (identical plans — omitted pairs are provably empty at every
    threshold), ``'auto'`` picks by tile count and threshold reach.
    """
    if pair_enum not in ("auto", "tree", "triu"):
        raise ValueError(f"Unknown pair enumeration `{pair_enum}`.")
    coords_sorted = np.asarray(coords_sorted, dtype=np.float32)
    n = coords_sorted.shape[0]
    thr = np.asarray(thresholds_sq, dtype=np.float64)
    L = len(thr)
    t = min(tile, max(8, n))
    n_tiles = -(-n // t)
    n_pad = n_tiles * t

    c64 = coords_sorted.astype(np.float64)
    starts = np.arange(0, n, t)
    lo = np.minimum.reduceat(c64, starts, axis=0)
    hi = np.maximum.reduceat(c64, starts, axis=0)
    # per-tile class histograms over REAL points only; labels outside
    # [0, n_cls) contribute nothing, matching the device kernels' one-hot
    # behavior (out-of-range -> zero row)
    tile_id = np.arange(n) // t
    lab64 = labels_sorted.astype(np.int64)
    in_range = (lab64 >= 0) & (lab64 < n_cls)
    cnt = np.bincount(
        (tile_id * n_cls + lab64)[in_range], minlength=n_tiles * n_cls
    )
    cnt = cnt.reshape(n_tiles, n_cls).astype(np.float64)

    # Pair enumeration: the O(T²) triu sweep allocates and classifies every
    # tile pair — ~48M pairs and ~1 GB of temporaries at 10M cells, most of
    # which are provably empty. When a KDTree reach query over tile centers
    # would prune (short-range thresholds, large T), enumerate only pairs
    # with center distance ≤ max threshold + both tile radii: every omitted
    # pair has dmin > thr_max ⇒ empty at all thresholds and never full.
    centers = (lo + hi) * 0.5
    radii = 0.5 * np.sqrt(np.sum((hi - lo) ** 2, axis=1))
    thr_dist = float(np.sqrt(max(thr[-1], 0.0))) * (1.0 + 1e-5)
    # typical (median) tile radius drives the prune estimate — clustered data
    # leaves a few huge gap-spanning tiles whose radius would otherwise veto
    # the tree path for everyone
    r_med = float(np.median(radii)) if n_tiles else 0.0
    domain = np.prod(np.maximum(c64.max(axis=0) - c64.min(axis=0), 1e-30)) if n else 1.0
    est_reach = thr_dist + 2.0 * r_med
    near_fraction = min(1.0, np.pi * est_reach * est_reach / max(domain, 1e-30))
    if pair_enum == "tree" or (
        pair_enum == "auto" and n_tiles > 2048 and near_fraction < 0.5
    ):
        from scipy.spatial import cKDTree

        # per-tile reach thr + 2·r_i: a near pair (d_center ≤ thr + r_i + r_j)
        # always falls inside the FATTER endpoint's ball, since
        # r_i + r_j ≤ 2·max(r_i, r_j) — conservative with per-tile radii, no
        # dependence on the global max radius
        tree = cKDTree(centers)
        balls = tree.query_ball_point(centers, r=thr_dist + 2.0 * radii, workers=-1)
        counts_b = np.fromiter((len(b) for b in balls), dtype=np.int64, count=n_tiles)
        src = np.repeat(np.arange(n_tiles, dtype=np.int64), counts_b)
        dst = np.concatenate(balls).astype(np.int64) if counts_b.sum() else np.empty(0, np.int64)
        # canonicalize to i<j BEFORE filtering: a pair may be discovered only
        # from its fatter endpoint's ball, in either orientation (the original
        # `src < dst` filter silently dropped pairs whose fat endpoint had the
        # larger index — caught by a label-independent total-count check)
        ti = np.minimum(src, dst)
        tj = np.maximum(src, dst)
        keep = ti < tj
        ti, tj = ti[keep], tj[keep]
        # dedupe (a pair can appear from both endpoints' balls), keep i<j order
        key = ti * n_tiles + tj
        key, uniq_idx = np.unique(key, return_index=True)
        ti, tj = ti[uniq_idx], tj[uniq_idx]
        ti = np.concatenate([ti, np.arange(n_tiles)])
        tj = np.concatenate([tj, np.arange(n_tiles)])
        order_p = np.lexsort((tj, ti))
        ti, tj = ti[order_p], tj[order_p]
    else:
        ti, tj = np.triu_indices(n_tiles)
    gap = np.maximum(np.maximum(lo[tj] - hi[ti], lo[ti] - hi[tj]), 0.0)
    dmin2 = np.sum(gap * gap, axis=1)
    span = np.maximum(hi[tj] - lo[ti], hi[ti] - lo[tj])
    dmax2 = np.sum(span * span, axis=1)

    # Conservative margin: the device computes d² in the difference form
    # Σ(a_d−b_d)² in full f32 (pairwise_sq_dists_exact), whose error is a few
    # ulps OF d² ITSELF (≲ 5·2⁻²³ relative). A 1e-5 relative band is ~20×
    # that, so host full/empty classification can never contradict the
    # device compare (which is what the dense oracle uses for every pair) —
    # bitwise parity with the dense sweep holds.
    r_empty = np.searchsorted(thr, dmin2 * (1.0 - 1e-5) - 1e-30, side="left").astype(np.int64)
    r_full = np.searchsorted(thr, dmax2 * (1.0 + 1e-5) + 1e-30, side="left").astype(np.int64)
    diag = ti == tj
    # diagonal blocks keep their strict i<j mask on device for all thresholds
    r_full[diag] = L
    r_empty[diag] = 0

    # analytic full-block contribution: from threshold r_full on, the block
    # contributes cnt_i ⊗ cnt_j to every (cumulative) threshold
    full_bucket = np.zeros((L, n_cls, n_cls), dtype=np.float64)
    sel = (~diag) & (r_full < L)
    if np.any(sel):
        f = r_full[sel]
        a = cnt[ti[sel]]
        b = cnt[tj[sel]]
        order = np.argsort(f, kind="stable")
        f_sorted = f[order]
        uniq, first = np.unique(f_sorted, return_index=True)
        bounds = np.append(first, len(f_sorted))
        for u, s0, s1 in zip(uniq, bounds[:-1], bounds[1:]):
            idx = order[s0:s1]
            full_bucket[u] = a[idx].T @ b[idx]
    full_cum = np.cumsum(full_bucket, axis=0)

    # device boundary window per pair: thresholds in [r_empty, min(r_full, L))
    win_end = np.minimum(r_full, L)
    has_work = win_end > r_empty
    pe = r_empty[has_work]
    pf = win_end[has_work]
    pti = ti[has_work].astype(np.int32)
    ptj = tj[has_work].astype(np.int32)
    prf = np.minimum(r_full[has_work], np.iinfo(np.int32).max).astype(np.int32)
    pre = pe.astype(np.int32)

    g_start = pe // gsize
    g_end = (pf - 1) // gsize + 1
    reps = (g_end - g_start).astype(np.int64)
    total = int(reps.sum())
    pair_rep = np.repeat(np.arange(len(pti)), reps)
    intra = np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
    gid = (np.repeat(g_start, reps) + intra).astype(np.int32)

    G = -(-L // gsize)
    thr_groups = np.full((G, gsize), -np.inf, dtype=np.float32)
    thr_groups.ravel()[:L] = np.asarray(thresholds_sq, dtype=np.float32)
    offsets = (np.arange(G, dtype=np.int32) * gsize).astype(np.int32)

    B = _bucket_len(max(total, 1), bucket_min)
    item_ti = np.full(B, -1, np.int32)
    item_tj = np.zeros(B, np.int32)
    item_rf = np.zeros(B, np.int32)
    item_re = np.zeros(B, np.int32)
    item_g = np.zeros(B, np.int32)
    item_ti[:total] = pti[pair_rep]
    item_tj[:total] = ptj[pair_rep]
    item_rf[:total] = prf[pair_rep]
    item_re[:total] = pre[pair_rep]
    item_g[:total] = gid

    return BinnedPairPlan(
        tile=t,
        gsize=gsize,
        n=n,
        n_pad=n_pad,
        ti=item_ti,
        tj=item_tj,
        rfull=item_rf,
        rempty=item_re,
        gid=item_g,
        thr_groups=thr_groups,
        offsets=offsets,
        full_cum=full_cum,
        n_items=total,
        n_pairs_total=len(ti),
    )


def sorted_plan(
    coords: np.ndarray,
    labels: np.ndarray,
    thresholds_sq: np.ndarray,
    n_cls: int,
    *,
    tile: int | None = None,
    gsize: int = 8,
    pair_enum: str = "auto",
) -> tuple[np.ndarray, np.ndarray, BinnedPairPlan]:
    """Morton-sorted float32 coordinates, int32 labels and their plan, as
    :func:`binned_cooccur_counts` sends them to the device."""
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    labels = np.asarray(labels, dtype=np.int32)
    n = coords.shape[0]
    if tile is None:
        # the JAX package's tile choice, so plans stay equal
        tile = 1024 if n >= 300_000 else 512 if n >= 20_000 else 256
    perm = morton_argsort(coords)
    coords_s = np.ascontiguousarray(coords[perm])
    labels_s = np.ascontiguousarray(labels[perm])
    plan = plan_binned_pairs(coords_s, labels_s, thresholds_sq, n_cls, tile=tile, gsize=gsize, pair_enum=pair_enum)
    return coords_s, labels_s, plan


def binned_cooccur_counts(
    coords: np.ndarray,
    labels: np.ndarray,
    thresholds_sq: np.ndarray,
    n_cls: int,
    *,
    tile: int | None = None,
    gsize: int = 8,
    pair_enum: str = "auto",
) -> np.ndarray:
    """Cumulative ordered pair counts ``(C, C, L)`` float64 via the binned sweep.

    Drop-in for :func:`squidpy_torch.ops.cooccur.co_occurrence_counts`:
    identical counts, near-O(n·L) device work instead of O(n²·L).
    """
    coords_s, labels_s, plan = sorted_plan(
        coords, labels, thresholds_sq, n_cls, tile=tile, gsize=gsize, pair_enum=pair_enum
    )
    upper = to_host(binned_pair_counts(coords_s, labels_s, plan, n_cls, device=get_device()), np.float64)
    upper = upper + plan.full_cum
    ordered = upper + np.swapaxes(upper, 1, 2)  # (L, C, C)
    return np.transpose(ordered, (1, 2, 0))
