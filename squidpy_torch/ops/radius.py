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
finite one. ``with_self=True`` adds each row's diagonal (column = row,
distance 0.0) in its ascending place, for every row: what a graph builder
would get from scipy's ``setdiag`` of the CSR without it.

On a CUDA tensor the search runs as kernel K6 (``csrc/radius_pairs.cu``),
on the card from end to end: a reduction gives the finite points' bounds
(the first of two reads of the card), the cell side and counts follow on
the host, and a counting sort (histogram, scan, scatter) bins the points
into a uniform grid whose side is a little above the radius (every point
into one cell if ``r2`` is inf); the count pass counts each row's
neighbours among the 3^min(d, 3) cells around it, a scan gives the row
offsets (the second read: the edge count and the row-order tiers), the fill
pass writes columns and distances at them, and the order pass sorts each
row in its own slots (a warp a row up to 64 entries, a block a row in
shared memory up to 16,384, chunks and merges in global memory beyond). On
the CPU it runs the plain version, the JAX package's own algorithm: row
tiles against every column.
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
_MAX_CELLS = 1 << 30  # cell ids, and the extra cell of the points with none, stay int32
_PLAIN_TILE_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 27}  # (rows, n) float32 temporaries of the plain version
# the row order's tiers: rows up to the first length sort in a warp, up to the
# second (a power of two) in a block's shared memory, longer ones in chunks of
# it merged in global memory
_ORDER_TIERS = (64, 16384)
# K8's cells hold about this many of a set's points on average
_KNN_CELL_POINTS = 2.0
# K8's ring bound shrinks each float64 gap by this much of its terms' magnitudes
_GAP_MARGIN = 2.0**-30


def radius_threshold(radius: float) -> np.float32:
    """``float32(float(radius) ** 2)``: the threshold on float32 ``d2``."""
    with np.errstate(over="ignore"):
        return np.float32(float(radius) ** 2)


class CellGrid(NamedTuple):
    """Every point of ``x`` binned for K6, in cell order."""

    order: torch.Tensor  # (n,) int32: the rows, sorted by cell; the points with no cell last
    pts: torch.Tensor  # (n, d) float32: the points in that order
    cell: torch.Tensor  # (n,) int32: each sorted point's cell (z * ny + y) * nx + x, or nx * ny * nz for none
    cell_start: torch.Tensor  # (nx * ny * nz + 2,) int32: offsets of each cell's points in the sort
    dims: tuple[int, int, int]  # cells along the first min(d, 3) axes, then 1s
    side: float  # the cell side, in the coordinates' units
    points: int  # the points in a cell (all but those with no cell)


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


def _one_cell(r2: float, g: int) -> bool:
    """Every point in one cell: an infinite ``r2`` accepts pairs at any
    distance, non-finite coordinates included; ``d = 0`` has no axis."""
    return math.isinf(r2) or g == 0


def _grid_geometry(r2: float, g: int, m: int, lo: list[float], hi: list[float]) -> tuple[tuple[int, int, int], float]:
    """The cells along each axis and the side, from the ``m`` finite
    points' per-axis bounds (float64 of their float32 extremes)."""
    side = math.inf if math.isinf(r2) else math.sqrt(float(r2) + _UNDERFLOW_D2) * _CELL_MARGIN
    if _one_cell(r2, g):
        return (1, 1, 1), side
    extent = [h - low for low, h in zip(lo, hi)] if m else [0.0] * g
    dims, side = _grid_dims(extent, side, max(min(_MAX_CELLS_PER_POINT * m, _MAX_CELLS), 1))
    dims3 = (dims + [1, 1, 1])[:3]
    return (dims3[0], dims3[1], dims3[2]), side


def _knn_grid_geometry(g: int, n_sets: int, m: int, lo: list[float], hi: list[float]
                       ) -> tuple[tuple[int, int, int], float]:
    """K8's grid: the cells along each axis and the side of one uniform grid
    for all ``n_sets`` sets, over the bounding box ``lo``-``hi`` of their
    ``m`` finite points (float64 of the float32 extremes). The side gives a
    set's mean share of those points about ``_KNN_CELL_POINTS`` a cell over
    the box's axes of non-zero extent, enlarged while the cells exceed
    ``2 m / n_sets`` a set (and 2^30 in all). Any side gives the same
    neighbours; it sets only how many candidates a query tests."""
    if m == 0 or g == 0:
        return (1, 1, 1), 1.0
    per_set = m / n_sets
    extent = [h - low for low, h in zip(lo, hi)]
    spread = [e for e in extent if e > 0]
    if not spread:  # every finite point at one place
        return (1, 1, 1), 1.0
    side = (math.prod(spread) * _KNN_CELL_POINTS / per_set) ** (1.0 / len(spread))
    cap = max(min(_MAX_CELLS_PER_POINT * math.ceil(per_set), _MAX_CELLS // n_sets - 1), 1)
    dims, side = _grid_dims(extent, side, cap)
    dims3 = (dims + [1, 1, 1])[:3]
    return (dims3[0], dims3[1], dims3[2]), side


def _square_below(gap: float) -> np.float32:
    """A float64 gap rounded down to float32 (0 below 0) and squared in float32."""
    with np.errstate(over="ignore"):
        low = np.float32(max(gap, 0.0))
        if float(low) > gap:  # round down (compared in float64: numpy would compare in float32)
            low = np.nextafter(low, np.float32(-np.inf))
        return low * low


def _ring_bound(q: np.ndarray, lo: list[float], side: float, box_lo: list[int], box_hi: list[int],
                dims: tuple[int, ...], margin: float = _GAP_MARGIN) -> np.float32 | None:
    """K8's stopping rule, as its kernel computes it: a lower bound on the
    float32 difference-form ``d2`` from the query ``q`` (float32, its first
    ``g`` coordinates used) to every point binned into a cell outside the
    box ``box_lo``-``box_hi`` (cell indices along each gridded axis,
    inclusive) of the grid at ``lo`` with ``side`` and ``dims``; None when
    the box holds every cell.

    An unvisited point lies beyond the box on some axis ``a``, at least that
    side's gap from ``q`` along ``a``, and inside the grid's extent
    ``[lo, lo + dims * side]`` on every other axis, at least ``q``'s
    distance to it there. Each gap is taken in float64, shrunk by ``margin``
    times its terms' magnitudes (far above the float64 binning's and the
    gap's own rounding, a few 2^-53), rounded down to float32 and squared,
    and the squares are summed in axis order in float32: each subtraction,
    multiply and add of ``d2`` rounds monotonically, and the axes past the
    grid's add terms that are not negative, so the point's ``d2`` is at
    least that sum. The bound is the least sum over the box's sides that
    have cells beyond them."""
    g = len(box_lo)
    qa = [float(q[a]) - lo[a] for a in range(g)]
    outside = []  # each axis's square of q's distance to the grid's extent
    for a in range(g):
        top = dims[a] * side
        outside.append(_square_below(max(-qa[a] - margin * abs(qa[a]), (qa[a] - top) - margin * (abs(qa[a]) + top))))
    best = None
    for a in range(g):
        gaps = []
        if box_lo[a] > 0:
            b = box_lo[a] * side
            gaps.append((qa[a] - b) - margin * (abs(qa[a]) + abs(b)))
        if box_hi[a] < dims[a] - 1:
            b = (box_hi[a] + 1) * side
            gaps.append((b - qa[a]) - margin * (abs(qa[a]) + abs(b)))
        for gap in gaps:
            terms = outside[:a] + [_square_below(gap)] + outside[a + 1 :]
            total = terms[0]
            with np.errstate(over="ignore"):
                for t in terms[1:]:
                    total = total + t
            best = total if best is None else min(best, total)
    return best


def cell_grid(x: torch.Tensor, r2: float) -> CellGrid:
    """Bin the points of ``x`` (n, d) whose first ``min(d, 3)`` coordinates
    are finite into a uniform grid on those axes, with cell coordinates in
    float64 and at most ``2 m`` cells for ``m`` such points; the other
    points go to one extra cell after the grid's, which no one walks.

    The side is ``sqrt(r2 + 2^-146) * (1 + 2^-10)``: above the largest true
    distance of a pair whose float32 ``d2`` is ``<= r2``, so every such pair
    lies in adjacent cells. An infinite ``r2`` accepts pairs at any distance,
    non-finite coordinates included: then every point lies in one cell.

    On a CUDA tensor K6's kernels bin the points (a counting sort: the order
    inside a cell is arbitrary); on the CPU the plain version (a stable sort
    by cell)."""
    if x.is_cuda:
        return _cell_grid_k6(x.to(torch.float32).contiguous(), r2, None)
    x = x.to(torch.float32)
    n, d = x.shape
    g = min(d, 3)
    xg = x[:, :g].to(torch.float64)
    finite = torch.isfinite(xg).all(dim=1)
    m = int(finite.sum())
    lo, hi = ([0.0] * g, [0.0] * g) if m == 0 or g == 0 else (t.tolist() for t in torch.aminmax(xg[finite], dim=0))
    dims, side = _grid_geometry(r2, g, m, lo, hi)
    n_cells = math.prod(dims)
    if _one_cell(r2, g):
        m, cell = n, torch.zeros(n, dtype=torch.int64)
    else:
        top = torch.tensor(dims[:g], dtype=torch.int64) - 1
        low = torch.tensor(lo, dtype=torch.float64)
        q = torch.zeros((n, 3), dtype=torch.int64)
        q[:, :g] = torch.minimum(torch.floor((torch.where(finite[:, None], xg, low) - low) / side).to(torch.int64)
                                 .clamp_min(0), top)
        cell = torch.where(finite, (q[:, 2] * dims[1] + q[:, 1]) * dims[0] + q[:, 0], n_cells)
    cell, perm = torch.sort(cell, stable=True)
    cell_start = torch.zeros(n_cells + 2, dtype=torch.int32)
    cell_start[1:] = torch.cumsum(torch.bincount(cell, minlength=n_cells + 1), dim=0)
    return CellGrid(order=perm.to(torch.int32), pts=x.index_select(0, perm), cell=cell.to(torch.int32),
                    cell_start=cell_start, dims=dims, side=side, points=m)


def candidate_pairs(grid: CellGrid) -> int:
    """Ordered pairs (i, j), i != j, that K6 tests: every point against the
    points of the 3 x 3 x 3 cells around its own (a measure of its work)."""
    nx, ny, nz = grid.dims
    per_cell = torch.diff(grid.cell_start[: nx * ny * nz + 1]).reshape(1, 1, nz, ny, nx).to(torch.float64)
    padded = torch.nn.functional.pad(per_cell, (1, 1, 1, 1, 1, 1))
    around = torch.nn.functional.avg_pool3d(padded, 3, stride=1) * 27
    return int(round(float((per_cell * around).sum()))) - grid.points


def _sqrt_rn(d2: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square roots, as K6's ``sqrtf``. Torch's
    vectorised CPU ``sqrt`` is off by an ulp for some float32 and float64
    inputs, so the CPU takes numpy's; on the card the float64 root, rounded
    once to float32, is exact."""
    if d2.is_cuda:
        return torch.sqrt(d2.to(torch.float64)).to(torch.float32)
    return torch.from_numpy(np.sqrt(d2.numpy()))


def _radius_plain(x: torch.Tensor, r2: float, row_tile: int | None = None,
                  with_self: bool = False) -> tuple[torch.Tensor, ...]:
    """Plain torch version of K6, the JAX package's algorithm: row tiles
    against every column, ``d2`` in the difference form, ``<= r2``, the
    diagonal masked (or, ``with_self``, kept at distance 0),
    ``torch.nonzero`` (row-major, so each row's columns ascend)."""
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
        keep[ar, r0 + ar] = with_self
        d2[ar, r0 + ar] = 0.0
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


def _launch(entry: str, *args: Any) -> None:
    """One call into K6's C interface, counted as one launch of K6: the
    call starts one or more CUDA kernels on the current stream (the bounds
    two; the order one, two more for rows past a warp's sort, and one a
    merge round)."""
    _cuda.check(getattr(_cuda.library(), entry)(*args, _cuda.stream_ptr()), "radius_pairs")
    _cuda.launches["radius_pairs"] += 1


def _read(t: torch.Tensor, stats: dict[str, Any] | None) -> np.ndarray:
    """A few scalars copied to the host: one wait for the card."""
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    return t.cpu().numpy()


def _bound_floats(keys: np.ndarray) -> list[float]:
    """The floats behind ``bounds_kernel``'s order-preserving int keys."""
    bits = keys.astype(np.int32)
    bits = np.where(bits < 0, bits ^ np.int32(0x7FFFFFFF), bits)
    return bits.view(np.float32).astype(np.float64).tolist()


def _grid_bounds_k6(x: torch.Tensor, g: int, stats: dict[str, Any] | None) -> tuple[int, list[float], list[float]]:
    """K6's bounds kernel on ``x`` (n, d) float32, read back once: the rows
    whose first ``g`` coordinates are finite, and those rows' per-axis
    bounds (0.0 when there are none)."""
    n, d = x.shape
    bounds = torch.empty(7, dtype=torch.int32, device=x.device)
    _launch("sqt_radius_bounds", x.data_ptr(), n, d, g, bounds.data_ptr())
    b = _read(bounds, stats)
    m = int(b[6])
    if m == 0:
        return 0, [0.0] * g, [0.0] * g
    return m, _bound_floats(b[:g]), _bound_floats(b[3 : 3 + g])


def _bin_k6(x: torch.Tensor, g: int, lo: list[float], side: float, dims: tuple[int, int, int], points: int,
            one_cell: bool = False, n_sets: int = 1) -> CellGrid:
    """K6's counting sort of ``x`` (n, d) float32 into the grid at ``lo``
    with ``side`` and ``dims`` (the bin kernel, a scan, the scatter). With
    ``n_sets`` > 1, ``x`` holds that many sets of ``n / n_sets``
    consecutive rows, each binned into its own copy of the grid: set
    ``s``'s cells, then its cell of the points with none, take the ids
    from ``s * (nx * ny * nz + 1)`` on."""
    n, d = x.shape
    dev = x.device
    n_cells = math.prod(dims)
    cell = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    low = (lo + [0.0, 0.0, 0.0])[:3]
    _launch("sqt_radius_bin", x.data_ptr(), n, d, g, low[0], low[1], low[2], side, *dims, int(one_cell),
            cell.data_ptr(), count.data_ptr())
    if n_sets > 1:
        offsets = torch.arange(n_sets, dtype=torch.int32, device=dev) * (n_cells + 1)
        cell.view(n_sets, -1).add_(offsets[:, None])
        count = torch.zeros(n_sets * (n_cells + 1), dtype=torch.int32, device=dev).index_add_(0, cell,
                                                                                            torch.ones_like(cell))
    cell_start = torch.zeros(count.numel() + 1, dtype=torch.int32, device=dev)
    cell_start[1:] = torch.cumsum(count, dim=0, dtype=torch.int32)
    cursor = cell_start[:-1].clone()
    pts = torch.empty((n, d), dtype=torch.float32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    cell_sorted = torch.empty(n, dtype=torch.int32, device=dev)
    _launch("sqt_radius_scatter", x.data_ptr(), n, d, cell.data_ptr(), cursor.data_ptr(), pts.data_ptr(),
            order.data_ptr(), cell_sorted.data_ptr())
    return CellGrid(order=order, pts=pts, cell=cell_sorted, cell_start=cell_start, dims=dims, side=side,
                    points=points)


def _cell_grid_k6(x: torch.Tensor, r2: float, stats: dict[str, Any] | None) -> CellGrid:
    """:func:`cell_grid` by K6's kernels on ``x`` (n, d) float32: the bounds
    (read back once, unless every point goes to one cell), then the counting
    sort."""
    n, d = x.shape
    g = min(d, 3)
    if _one_cell(r2, g):
        m, lo, hi = n, [0.0] * g, [0.0] * g
    else:
        m, lo, hi = _grid_bounds_k6(x, g, stats)
    dims, side = _grid_geometry(r2, g, m, lo, hi)
    return _bin_k6(x, g, lo, side, dims, m, _one_cell(r2, g))


def radius_pairs(
    x: torch.Tensor, radius: float, *, with_self: bool = False, row_tile: int | None = None,
    stats: dict[str, Any] | None = None, _tiers: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K6: ``(indptr int64 (n + 1,), indices int32, distances float32)``
    of every pair within ``radius`` (inclusive) of the points ``x`` (n, d)
    float32, each row's columns ascending; self excluded, or with
    ``with_self`` each row's diagonal (distance 0.0) included.

    A CPU tensor runs the plain version (in row tiles of ``row_tile``, which
    changes no result); a CUDA tensor launches the kernel. Given ``stats``,
    the CUDA path fills it with the grid, the rows of each row-order tier
    (a warp's sort; one block's; a block's chunks and merge rounds), its
    host syncs and the device milliseconds of its steps (it then waits for
    each step). ``_tiers`` overrides the row order's tier limits (the
    warp's, at most 64; the block's, a power of two up to 16,384), which
    change no result."""
    if x.ndim != 2:
        raise ValueError(f"Expected points of shape (n, d), found {tuple(x.shape)}.")
    n = x.shape[0]
    r2 = float(radius_threshold(radius))
    if x.device.type == "cpu":
        return _radius_plain(x.to(torch.float32), r2, row_tile, with_self)
    if n >= 2**31:
        raise ValueError(f"K6 writes int32 columns: at most 2^31 - 1 points, found {n}.")
    x = x.to(torch.float32).contiguous()
    _cuda.require(x, "x", torch.float32)
    return _radius_k6(x, r2, stats, with_self, _tiers)


def _radius_k6(x: torch.Tensor, r2: float, stats: dict[str, Any] | None, with_self: bool = False,
               tiers: tuple[int, int] | None = None) -> tuple[torch.Tensor, ...]:
    """K6 on ``x`` (n, d) float32: the grid, the count pass, the scan, the
    fill pass and the row order, with two reads of the card (the grid's
    bounds; the edge count and the rows past a warp's sort); given
    ``stats``, timed by CUDA events."""
    n, d = x.shape
    dev = x.device
    warp_lim, block_lim = tiers or _ORDER_TIERS
    if stats is not None:
        stats["host_syncs"] = 0
    if math.isnan(r2) or n == 0:  # no d2 is <= NaN: at most the diagonal
        k = n if with_self else 0
        return (torch.arange(n + 1, device=dev) if with_self else torch.zeros(n + 1, dtype=torch.int64, device=dev),
                torch.arange(k, dtype=torch.int32, device=dev), torch.zeros(k, device=dev))
    ev = [_event()] if stats is not None else None
    grid = _cell_grid_k6(x, r2, stats)
    nx, ny, nz = grid.dims
    if ev is not None:
        ev.append(_event())
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    long_rows = torch.empty(n, dtype=torch.int32, device=dev)
    tier_sizes = torch.zeros(2, dtype=torch.int32, device=dev)
    common = (grid.pts.data_ptr(), d, grid.order.data_ptr(), grid.cell.data_ptr(), grid.cell_start.data_ptr(), n,
              nx, ny, nz, r2, int(with_self))
    _launch("sqt_radius_pairs", *common, counts.data_ptr(), long_rows.data_ptr(), tier_sizes.data_ptr(), warp_lim,
            None, None, None, 0)
    if ev is not None:
        ev.append(_event())
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(counts, dim=0, dtype=torch.int64)
    nnz, n_long, longest = (int(v) for v in _read(torch.cat([indptr[-1:], tier_sizes.to(torch.int64)]), stats))
    out_idx = torch.empty(nnz, dtype=torch.int32, device=dev)
    out_dist = torch.empty(nnz, dtype=torch.float32, device=dev)
    if ev is not None:
        ev.append(_event())
    _launch("sqt_radius_pairs", *common, counts.data_ptr(), None, None, warp_lim, indptr.data_ptr(),
            out_idx.data_ptr(), out_dist.data_ptr(), 1)
    if ev is not None:
        ev.append(_event())
    # rows past the block limit merge through a copy as long as the output
    tmp = nnz if longest > block_lim else 0
    tmp_idx = torch.empty(tmp, dtype=torch.int32, device=dev)
    tmp_dist = torch.empty(tmp, dtype=torch.float32, device=dev)
    _launch("sqt_radius_order", indptr.data_ptr(), n, out_idx.data_ptr(), out_dist.data_ptr(), tmp_idx.data_ptr(),
            tmp_dist.data_ptr(), long_rows.data_ptr(), n_long, longest, warp_lim, block_lim)
    if ev is not None:
        ev.append(_event())
        torch.cuda.synchronize()
        names = ("grid_ms", "count_ms", "scan_ms", "fill_ms", "order_ms")
        stats.update({k: a.elapsed_time(b) for k, a, b in zip(names, ev[:-1], ev[1:])})
        n_global = int((counts > block_lim).sum())
        stats.update(pairs=nnz, points=grid.points, candidates=candidate_pairs(grid), side=grid.side, dims=grid.dims,
                     cells=math.prod(grid.dims), rows_warp=n - n_long, rows_block=n_long - n_global,
                     rows_global=n_global, longest=longest)
    return indptr, out_idx, out_dist
