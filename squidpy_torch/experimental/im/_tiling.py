"""Per-label centroids and bounding boxes of a label image (copy of the
cell-info pass of ``squidpy_tpu/experimental/im/_tiling.py``).

Host numpy only: one sweep of ``np.bincount`` over the labels for the areas
and coordinate sums, and a stable sort of the labelled pixels for the
bounding boxes. The tiling itself is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CellInfo", "compute_cell_info"]


def _as_2d(arr: np.ndarray) -> np.ndarray:
    return arr.squeeze() if arr.ndim > 2 else arr


@dataclass(frozen=True)
class CellInfo:
    """Centroid and bounding box of a single label."""

    label: int
    centroid_y: float
    centroid_x: float
    bbox_h: int
    bbox_w: int
    bbox_y0: int = 0
    bbox_x0: int = 0


def _accumulate_chunk(
    chunk: np.ndarray,
    y0: int,
    x0: int,
    acc: dict[int, list[float]],
) -> None:
    """Accumulate per-label area, coordinate sums and bounding box from one
    chunk (a vectorised bincount sweep; no per-label loop over pixels)."""
    labels = chunk.ravel()
    if labels.size == 0:
        return
    present = np.unique(labels)
    present = present[present > 0]
    if not len(present):
        return
    h, w = chunk.shape
    yy = np.repeat(np.arange(h, dtype=np.float64), w) + y0
    xx = np.tile(np.arange(w, dtype=np.float64), h) + x0
    maxlab = int(present.max())
    area = np.bincount(labels, minlength=maxlab + 1)
    sumy = np.bincount(labels, weights=yy, minlength=maxlab + 1)
    sumx = np.bincount(labels, weights=xx, minlength=maxlab + 1)
    # bounding boxes from each label's min and max coordinates
    ys, xs = np.nonzero(chunk)
    labs_nz = chunk[ys, xs]
    order = np.argsort(labs_nz, kind="stable")
    labs_s = labs_nz[order]
    ys_s = ys[order] + y0
    xs_s = xs[order] + x0
    starts = np.searchsorted(labs_s, present)
    ends = np.searchsorted(labs_s, present, side="right")
    for lid, s, e in zip(present.tolist(), starts.tolist(), ends.tolist()):
        a = acc.setdefault(lid, [0.0, 0.0, 0.0, np.inf, -np.inf, np.inf, -np.inf])
        a[0] += float(area[lid])
        a[1] += float(sumy[lid])
        a[2] += float(sumx[lid])
        a[3] = min(a[3], float(ys_s[s:e].min()))
        a[4] = max(a[4], float(ys_s[s:e].max()) + 1)
        a[5] = min(a[5], float(xs_s[s:e].min()))
        a[6] = max(a[6], float(xs_s[s:e].max()) + 1)


def _acc_to_info(acc: dict[int, list[float]]) -> dict[int, CellInfo]:
    return {
        lid: CellInfo(
            label=lid,
            centroid_y=a[1] / a[0],
            centroid_x=a[2] / a[0],
            bbox_h=int(a[4] - a[3]),
            bbox_w=int(a[6] - a[5]),
            bbox_y0=int(a[3]),
            bbox_x0=int(a[5]),
        )
        for lid, a in acc.items()
    }


def compute_cell_info(labels: np.ndarray) -> dict[int, CellInfo]:
    """Centroid and bounding box of every label of an in-memory 2D label image."""
    acc: dict[int, list[float]] = {}
    _accumulate_chunk(_as_2d(np.asarray(labels)), 0, 0, acc)
    return _acc_to_info(acc)
