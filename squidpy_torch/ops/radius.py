"""All pairs within a radius, as CSR rows (counterpart of ``squidpy_tpu/ops/knn.py:408`` ``radius_neighbors``).

The pairs are those with float32 difference-form ``d2 <= r2``, self
excluded, where ``r2 = float32(float(radius) ** 2)``: the square taken in
float64 and rounded once, as numpy compares a float32 block with a Python
float. ``d2`` sums ``diff * diff`` over the axes in order, each subtraction,
multiply and add rounded on its own. Against a finite ``r2`` a point with a
non-finite coordinate has no neighbours and is no one's neighbour (its tests
are NaN, or inf). An infinite ``r2`` (``radius`` of inf, or above ~1.8e19)
accepts every ``d2`` that is not NaN, as the JAX package's test does: an
overflowed ``d2`` of finite points, and an infinite coordinate against a
finite one.

On a CUDA tensor the search runs as kernel K6 (``csrc/radius_pairs.cu``):
:func:`cell_grid` bins the finite points into a uniform grid whose side is
a little above the radius (every point into one cell if ``r2`` is inf), and
sorts them by cell; the kernel counts each
row's neighbours among the 3^min(d, 3) cells around it, a scan gives the row
offsets, the kernel writes columns and distances at them, and one sort puts
each row's columns in ascending order. On the CPU it runs the plain version,
the JAX package's own algorithm: row tiles against every column.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from squidpy_torch import _cuda

__all__ = ["CellGrid", "cell_grid", "radius_pairs", "radius_threshold"]

# the cell side over the largest distance the float32 test accepts: a few
# float32 roundings of d2 and the float64 binning are far below 2^-10
_CELL_MARGIN = 1.0 + 2.0**-10
# squares below half the least float32 subnormal round to 0, so an accepted
# pair's d2 may exceed r2 by about this much in absolute terms
_UNDERFLOW_D2 = 2.0**-146
_MAX_CELLS_PER_POINT = 2
_PLAIN_TILE_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 27}  # (rows, n) float32 temporaries of the plain version


def radius_threshold(radius: float) -> np.float32:
    """``float32(float(radius) ** 2)``: the threshold on float32 ``d2``."""
    with np.errstate(over="ignore"):
        return np.float32(float(radius) ** 2)


class CellGrid(NamedTuple):
    """The finite points binned for K6, in cell order."""

    order: torch.Tensor  # (m,) int64: rows of the finite points, sorted by cell
    cells: torch.Tensor  # (m, 3) int32: each sorted point's cell coordinates (0 past the gridded axes)
    cell_start: torch.Tensor  # (nx * ny * nz + 1,) int64: offsets of each cell's points in the sort
    dims: tuple[int, int, int]  # cells along the first min(d, 3) axes, then 1s
    side: float  # the cell side, in the coordinates' units


def _grid_dims(extent: list[float], side: float, cap: int) -> tuple[list[int], float]:
    """Cells along each axis at ``side``, enlarging the side until their
    product is at most ``cap``. A bigger side keeps every accepted pair in
    adjacent cells; it only adds candidates."""
    while True:
        dims = [int(e // side) + 1 for e in extent]
        total = math.prod(dims)
        if total <= cap:
            return dims, side
        side *= max((total / cap) ** (1.0 / len(extent)), 1.0 + 2.0**-6)


def cell_grid(x: torch.Tensor, r2: float) -> CellGrid:
    """Bin the points of ``x`` (n, d) whose first ``min(d, 3)`` coordinates
    are finite into a uniform grid on those axes, with cell coordinates in
    float64 and at most ``2 m`` cells for ``m`` such points.

    The side is ``sqrt(r2 + 2^-146) * (1 + 2^-10)``: above the largest true
    distance of a pair whose float32 ``d2`` is ``<= r2``, so every such pair
    lies in adjacent cells. An infinite ``r2`` accepts pairs at any distance,
    non-finite coordinates included: then every point lies in one cell."""
    n, d = x.shape
    if math.isinf(r2):
        every = torch.arange(n, device=x.device)
        return CellGrid(order=every, cells=torch.zeros((n, 3), dtype=torch.int32, device=x.device),
                        cell_start=torch.tensor([0, n], dtype=torch.int64, device=x.device), dims=(1, 1, 1),
                        side=math.inf)
    g = min(d, 3)
    xg = x[:, :g].to(torch.float64)
    valid = torch.nonzero(torch.isfinite(xg).all(dim=1)).squeeze(1)
    m = int(valid.numel())
    pts = xg.index_select(0, valid)
    if m and g:
        lo, hi = torch.aminmax(pts, dim=0)
        extent = (hi - lo).tolist()
    else:
        lo, extent = torch.zeros(g, dtype=torch.float64, device=x.device), [0.0] * g
    side = math.sqrt(float(r2) + _UNDERFLOW_D2) * _CELL_MARGIN
    dims, side = _grid_dims(extent, side, max(_MAX_CELLS_PER_POINT * m, 1)) if g else ([], side)
    dims3 = (dims + [1, 1, 1])[:3]
    q = torch.zeros((m, 3), dtype=torch.int64, device=x.device)
    if g and m:
        top = torch.tensor(dims, dtype=torch.int64, device=x.device) - 1
        q[:, :g] = torch.minimum(torch.floor((pts - lo) / side).to(torch.int64).clamp_min(0), top)
    cell = (q[:, 2] * dims3[1] + q[:, 1]) * dims3[0] + q[:, 0]
    cell, perm = torch.sort(cell, stable=True)
    n_cells = math.prod(dims3)
    cell_start = torch.zeros(n_cells + 1, dtype=torch.int64, device=x.device)
    cell_start[1:] = torch.cumsum(torch.bincount(cell, minlength=n_cells), dim=0)
    return CellGrid(
        order=valid.index_select(0, perm), cells=q.index_select(0, perm).to(torch.int32),
        cell_start=cell_start, dims=(dims3[0], dims3[1], dims3[2]), side=side,
    )


def candidate_pairs(grid: CellGrid) -> int:
    """Ordered pairs (i, j), i != j, that K6 tests: every point against the
    points of the 3 x 3 x 3 cells around its own (a measure of its work)."""
    nx, ny, nz = grid.dims
    per_cell = torch.diff(grid.cell_start).reshape(1, 1, nz, ny, nx).to(torch.float64)
    padded = torch.nn.functional.pad(per_cell, (1, 1, 1, 1, 1, 1))
    around = torch.nn.functional.avg_pool3d(padded, 3, stride=1) * 27
    return int(round(float((per_cell * around).sum()))) - int(grid.order.numel())


def _sqrt_rn(d2: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square roots, as K6's ``sqrtf``. Torch's
    vectorised CPU ``sqrt`` is off by an ulp for some float32 and float64
    inputs, so the CPU takes numpy's; on the card the float64 root, rounded
    once to float32, is exact."""
    if d2.is_cuda:
        return torch.sqrt(d2.to(torch.float64)).to(torch.float32)
    return torch.from_numpy(np.sqrt(d2.numpy()))


def _radius_plain(x: torch.Tensor, r2: float, row_tile: int | None = None) -> tuple[torch.Tensor, ...]:
    """Plain torch version of K6, the JAX package's algorithm: row tiles
    against every column, ``d2`` in the difference form, ``<= r2``, the
    diagonal masked, ``torch.nonzero`` (row-major, so each row's columns
    ascend)."""
    n, d = x.shape
    if row_tile is None:
        row_tile = _PLAIN_TILE_ELEMS["cuda" if x.is_cuda else "cpu"] // max(n, 1)
    row_tile = max(1, min(row_tile, max(n, 1)))
    thr = torch.tensor(r2, dtype=torch.float32, device=x.device)
    rows, cols, d2s = [], [], []
    for r0 in range(0, n, row_tile):
        block = x[r0 : r0 + row_tile]
        d2 = torch.zeros((block.shape[0], n), dtype=torch.float32, device=x.device) if d == 0 else None
        for a in range(d):
            diff = block[:, a : a + 1] - x[:, a][None, :]
            d2 = diff * diff if a == 0 else d2 + diff * diff
        keep = d2 <= thr
        ar = torch.arange(block.shape[0], device=x.device)
        keep[ar, r0 + ar] = False
        i, j = torch.nonzero(keep, as_tuple=True)
        rows.append(i + r0)
        cols.append(j)
        d2s.append(d2[i, j])
    row = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64, device=x.device)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    indptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), dim=0)
    col = torch.cat(cols).to(torch.int32) if cols else torch.zeros(0, dtype=torch.int32, device=x.device)
    dist = _sqrt_rn(torch.cat(d2s)) if d2s else torch.zeros(0, dtype=torch.float32, device=x.device)
    return indptr, col, dist


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _launch_k6(grid: CellGrid, pts: torch.Tensor, orig: torch.Tensor, r2: float, counts: torch.Tensor,
               fill: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None) -> None:
    """The count pass (``fill=None``: writes ``counts``) or the fill pass
    (``fill=(indptr, indices, distances)``) over the sorted points ``pts``
    and their rows ``orig`` (int32)."""
    nx, ny, nz = grid.dims
    indptr, out_idx, out_dist = (t.data_ptr() for t in fill) if fill is not None else (None, None, None)
    code = _cuda.library().sqt_radius_pairs(
        pts.data_ptr(), pts.shape[1], orig.data_ptr(), grid.cells.data_ptr(), grid.cell_start.data_ptr(),
        pts.shape[0], nx, ny, nz, float(r2), counts.data_ptr(), indptr, out_idx, out_dist, int(fill is not None),
        _cuda.stream_ptr(),
    )
    _cuda.check(code, "radius_pairs")
    _cuda.launches["radius_pairs"] += 1


def radius_pairs(
    x: torch.Tensor, radius: float, *, row_tile: int | None = None, stats: dict[str, Any] | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K6: ``(indptr int64 (n + 1,), indices int32, distances float32)``
    of every pair within ``radius`` (inclusive) of the points ``x`` (n, d)
    float32, self excluded, each row's columns ascending.

    A CPU tensor runs the plain version (in row tiles of ``row_tile``, which
    changes no result); a CUDA tensor launches the kernel. Given ``stats``,
    the CUDA path fills it with the grid and the device milliseconds of its
    steps (it then waits for each step)."""
    if x.ndim != 2:
        raise ValueError(f"Expected points of shape (n, d), found {tuple(x.shape)}.")
    n = x.shape[0]
    r2 = float(radius_threshold(radius))
    if x.device.type == "cpu":
        return _radius_plain(x.to(torch.float32), r2, row_tile)
    if n >= 2**31:
        raise ValueError(f"K6 writes int32 columns: at most 2^31 - 1 points, found {n}.")
    x = x.to(torch.float32).contiguous()
    _cuda.require(x, "x", torch.float32)
    return _radius_k6(x, r2, stats)


def _radius_k6(x: torch.Tensor, r2: float, stats: dict[str, Any] | None) -> tuple[torch.Tensor, ...]:
    """K6 on ``x`` (n, d) float32: the grid, the count pass, the scan, the
    fill pass and the row order; given ``stats``, timed by CUDA events."""
    n = x.shape[0]
    counts = torch.zeros(n, dtype=torch.int32, device=x.device)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    if math.isnan(r2):  # no d2 is <= NaN
        return indptr, torch.zeros(0, dtype=torch.int32, device=x.device), torch.zeros(0, device=x.device)
    ev = [_event()] if stats is not None else None
    grid = cell_grid(x, r2)
    pts = x.index_select(0, grid.order).contiguous()
    orig = grid.order.to(torch.int32)
    if ev is not None:
        ev.append(_event())
    _launch_k6(grid, pts, orig, r2, counts)
    if ev is not None:
        ev.append(_event())
    indptr[1:] = torch.cumsum(counts, dim=0, dtype=torch.int64)
    nnz = int(indptr[-1])
    out_idx = torch.empty(nnz, dtype=torch.int32, device=x.device)
    out_dist = torch.empty(nnz, dtype=torch.float32, device=x.device)
    if ev is not None:
        ev.append(_event())
    _launch_k6(grid, pts, orig, r2, counts, (indptr, out_idx, out_dist))
    if ev is not None:
        ev.append(_event())
    # each row's columns ascending: one sort of (row, column) keys
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), counts.long(), output_size=nnz)
    keys, perm = torch.sort(rows * n + out_idx.long())
    indices = (keys - rows * n).to(torch.int32)
    distances = out_dist.index_select(0, perm)
    if ev is not None:
        ev.append(_event())
        torch.cuda.synchronize()
        names = ("grid_ms", "count_ms", "scan_ms", "fill_ms", "order_ms")
        stats.update({k: a.elapsed_time(b) for k, a, b in zip(names, ev[:-1], ev[1:])})
        stats.update(pairs=nnz, points=int(grid.order.numel()), candidates=candidate_pairs(grid), side=grid.side,
                     dims=grid.dims, cells=math.prod(grid.dims))
    return indptr, indices, distances
