"""The port's radius search (K6 and its plain version) against squidpy_tpu's ``radius_neighbors``.

Tolerances: ``indptr`` and ``indices`` are bitwise equal. Both packages
test float32 difference-form ``d2 <= float32(float(r) ** 2)``, but XLA on
the CPU fuses JAX's sum into ``fma(dy, dy, dx * dx)`` (in 3D
``fma(dz, dz, fma(dy, dy, dx * dx))``), while the port rounds each multiply
and add, as K6 does on the card. So:

- a distance may differ by the rounding of its ``d2`` (at most 15% of
  the edges, by at most ``d - 1`` float32 ulps): every port
  distance is ``sqrt`` of the unfused float32 ``d2`` and every JAX distance
  ``sqrt`` of the fused one, bitwise, each checked against a numpy
  emulation;
- a pair whose ``d2`` lies within an ulp of ``r2`` may be kept by one
  package only (a knife edge): the bitwise fixtures are checked to hold
  none, and one test builds such a pair and shows it is the only
  difference.

The kernel's grid (``cell_grid``) runs on the CPU too: its invariants and
candidate count are checked, and the wrapper's grid, scan, fill and row
order around a numpy emulation of the kernel's C interface (walking the
cells as the kernel walks them) must give the plain version's CSR bitwise. The kernel itself is held to the
plain version on the card (tests marked ``cuda``, skipped without one).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import squidpy_torch as sqt
from squidpy_torch.ops.knn import radius_neighbors
from squidpy_torch import _cuda
from squidpy_torch.ops import radius as trad
from squidpy_torch.ops.radius import _radius_plain, candidate_pairs, cell_grid, radius_pairs, radius_threshold
from squidpy_tpu.ops.knn import radius_neighbors as jax_radius_neighbors

torch.set_num_threads(1)

# whether the float32 of each radius's float64 square rounds it up: both
# directions are covered
RADII = {0.3: True, 0.7: True, 1.6: False, 3.3: True, 8.2: False, 12.345: True, 25.3: True}


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _coords(n: int, d: int, radius: float, seed: int, mean_neighbours: float = 12.0) -> np.ndarray:
    """Uniform float32 points with about ``mean_neighbours`` within ``radius``."""
    ball = {1: 2.0, 2: np.pi, 3: 4.0 / 3.0 * np.pi}[d] * radius**d
    side = (n * ball / mean_neighbours) ** (1.0 / d)
    return np.random.default_rng(seed).uniform(0.0, side, (n, d)).astype(np.float32)


def _d2_unfused(c: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The port's float32 d2: each subtraction, multiply and add rounded."""
    diff = c[i] - c[j]
    d2 = diff[:, 0] * diff[:, 0]
    for a in range(1, c.shape[1]):
        d2 = d2 + diff[:, a] * diff[:, a]
    return d2


def _d2_fused(c: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """XLA:CPU's float32 d2: ``fma(d_a, d_a, acc)`` for every axis after the
    first, emulated in float64 (the product is exact there)."""
    diff = c[i] - c[j]
    d2 = diff[:, 0] * diff[:, 0]
    for a in range(1, c.shape[1]):
        d2 = (diff[:, a].astype(np.float64) ** 2 + d2.astype(np.float64)).astype(np.float32)
    return d2


def _all_pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    i, j = np.nonzero(~np.eye(n, dtype=bool))
    return i, j


def _straddling(c: np.ndarray, r2: np.float32) -> list[tuple[int, int]]:
    """Ordered pairs kept by one of the two roundings of d2 only."""
    i, j = _all_pairs(len(c))
    with np.errstate(invalid="ignore", over="ignore"):
        diff = (_d2_unfused(c, i, j) <= r2) != (_d2_fused(c, i, j) <= r2)
    return list(zip(i[diff].tolist(), j[diff].tolist()))


def _rows(indptr: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))


def _assert_matches_jax(c: np.ndarray, radius: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    got = radius_neighbors(c, radius)
    want = jax_radius_neighbors(c, radius)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int32 and got[2].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rows, cols = _rows(got[0]), got[1].astype(np.int64)
    np.testing.assert_array_equal(got[2], np.sqrt(_d2_unfused(c, rows, cols)))
    np.testing.assert_array_equal(want[2], np.sqrt(_d2_fused(c, rows, cols)))
    ulps = np.abs(got[2].astype(np.float64) - want[2]) / np.spacing(np.maximum(got[2], want[2]))
    assert np.all(ulps <= c.shape[1] - 1) and np.mean(ulps > 0) <= 0.15
    return got


@pytest.mark.parametrize("radius", list(RADII))
@pytest.mark.parametrize("d", [2, 3])
def test_radius_neighbors_match_jax(d, radius):
    c = _coords(1500, d, radius, seed=d)
    r2 = radius_threshold(radius)
    assert (float(r2) > radius**2) == RADII[radius] and float(r2) != radius**2
    assert not _straddling(c, r2)
    indptr, indices, _ = _assert_matches_jax(c, radius)
    assert indptr[-1] > 4 * len(c)
    rows = _rows(indptr)
    assert np.all(rows != indices) and np.all(np.diff(indices)[np.diff(rows) == 0] > 0)  # no self, ascending


def test_threshold_is_the_float32_of_the_float64_square():
    """At r = 25.3 the float32 of r^2 (taken in float64) lies above the float32
    square of float32(r): a pair whose d2 is the former is kept."""
    radius = 25.3
    right = np.float32(radius**2)
    wrong = np.float32(np.float32(radius) * np.float32(radius))
    assert radius_threshold(radius) == right and wrong < right
    # a pair (0, 0) - (x, y) whose d2, in both roundings, is exactly `right`
    base = np.float32(radius)
    xs = base + np.arange(-40, 41, dtype=np.float32) * np.spacing(base)
    ys = np.arange(0, 3000, dtype=np.float32) * np.float32(1e-3)
    x, y = (a.ravel() for a in np.meshgrid(xs, ys))
    c = np.stack([x, y], axis=1)
    pts = np.concatenate([np.zeros((1, 2), np.float32), c])
    origin, others = np.zeros(len(c), dtype=np.int64), np.arange(1, len(pts))
    hit = np.nonzero((_d2_unfused(pts, origin, others) == right) & (_d2_fused(pts, origin, others) == right))[0]
    assert len(hit), "no float32 pair with d2 == float32(r^2) in the search box"
    pair = np.stack([[0.0, 0.0], c[hit[0]], [1e4, 1e4]]).astype(np.float32)
    indptr, indices, dists = _assert_matches_jax(pair, radius)
    np.testing.assert_array_equal(indptr, [0, 1, 2, 2])
    np.testing.assert_array_equal(indices, [1, 0])
    assert dists[0] == np.sqrt(right)


def test_coincident_points_zero_radius_and_nan_rows():
    c = _coords(1200, 2, 6.0, seed=5)
    c[1::5] = c[::5][: len(c[1::5])]  # every fifth point has a twin
    c[7], c[8] = (1e-30, 2e-30), (0.0, 0.0)  # distinct, but d2 underflows to 0
    c[[22, 33]] = np.nan
    c[43, 1] = np.inf
    c[44, 0] = np.nan
    for radius in (0.0, 6.0, 1e4):
        assert not _straddling(c, radius_threshold(radius))
        indptr, indices, dists = _assert_matches_jax(c, radius)
        for bad in (22, 33, 43, 44):
            assert indptr[bad] == indptr[bad + 1] and bad not in indices
        if radius == 0.0:
            assert np.all(dists == 0) and indptr[-1] == 2 * (len(c[1::5]) + 1)
            assert indices[indptr[7]] == 8 and indices[indptr[8]] == 7
        if radius == 1e4:  # larger than the extent: every finite pair
            m = len(c) - 4
            assert indptr[-1] == m * (m - 1)


def test_infinite_radius_keeps_infinite_coordinates():
    """An infinite r2 (from r = inf, or r above ~1.8e19) accepts every d2
    that is not NaN, as JAX's test does: a point at an infinite coordinate
    neighbours every finite point, but not a point at the same infinity on
    one axis (inf - inf is NaN), and a NaN point neighbours no one."""
    c = _coords(300, 2, 6.0, seed=6)
    c[[3, 10]] = np.inf
    c[[20, 21], 1] = -np.inf
    c[30, 0] = np.nan
    finite = np.setdiff1d(np.arange(len(c)), [3, 10, 20, 21, 30])
    for radius in (np.inf, 1e20):
        assert np.isinf(radius_threshold(radius))
        got, want = radius_neighbors(c, radius), jax_radius_neighbors(c, radius)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        rows, cols = _rows(got[0]), got[1].astype(np.int64)
        with np.errstate(invalid="ignore", over="ignore"):
            np.testing.assert_array_equal(got[2], np.sqrt(_d2_unfused(c, rows, cols)))
            np.testing.assert_array_equal(want[2], np.sqrt(_d2_fused(c, rows, cols)))
        row = lambda i: got[1][got[0][i] : got[0][i + 1]]  # noqa: E731
        np.testing.assert_array_equal(row(3), np.sort(np.r_[finite, 20, 21]))
        np.testing.assert_array_equal(row(20), np.sort(np.r_[finite, 3, 10]))
        assert len(row(30)) == 0 and 30 not in got[1]
        assert np.all(np.isinf(got[2][rows == 3])) and np.all(np.isfinite(got[2][np.isin(rows, finite)
                                                                                   & np.isin(cols, finite)]))


def test_knife_edge_pair_is_the_only_difference():
    """At ``r = sqrt(d2)`` of a pair whose two roundings of d2 differ, the
    package with the smaller d2 keeps the pair and the other does not; every
    other pair agrees."""
    c = _coords(600, 2, 6.0, seed=9)
    i, j = _all_pairs(len(c))
    unfused, fused = _d2_unfused(c, i, j), _d2_fused(c, i, j)
    near = np.nonzero((unfused != fused) & (unfused > 20) & (unfused < 30))[0]
    k = near[0]
    low = min(unfused[k], fused[k])
    radius = float(np.sqrt(np.float64(low)))
    assert radius_threshold(radius) == low
    edges = _straddling(c, low)
    assert sorted(edges) == sorted([(int(i[k]), int(j[k])), (int(j[k]), int(i[k]))])
    got, want = radius_neighbors(c, radius), jax_radius_neighbors(c, radius)
    keys = [set(zip(_rows(r[0]).tolist(), r[1].tolist())) for r in (got, want)]
    port_keeps = unfused[k] <= low
    assert (keys[0] - keys[1] if port_keeps else keys[1] - keys[0]) == set(edges)
    assert not (keys[1] - keys[0] if port_keeps else keys[0] - keys[1])


def test_plain_roots_are_correctly_rounded():
    """The plain version's roots are numpy's, correctly rounded as the
    card's ``sqrtf``; torch's vectorised CPU ``sqrt`` is not always."""
    d2 = np.random.default_rng(4).uniform(0.0, 700.0, 1 << 20).astype(np.float32)
    exact = np.sqrt(d2.astype(np.float64)).astype(np.float32)  # double rounding is exact for a root
    np.testing.assert_array_equal(trad._sqrt_rn(torch.from_numpy(d2)).numpy(), exact)


def test_empty_and_single_point():
    for c in (np.zeros((0, 2), np.float32), np.ones((1, 3), np.float32)):
        got = radius_neighbors(c, 1.0)
        want = jax_radius_neighbors(c, 1.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_row_tiles_change_nothing():
    c = _coords(700, 3, 2.0, seed=3)
    x = torch.from_numpy(c)
    whole = _radius_plain(x, float(radius_threshold(2.0)))
    for tile in (1, 64, 699):
        for a, b in zip(whole, radius_pairs(x, 2.0, row_tile=tile)):
            assert torch.equal(a, b)


# -- the kernel's grid, walked on the CPU as the kernel walks it ----------------


def _grid_cases() -> list[tuple[str, np.ndarray, float]]:
    rng = np.random.default_rng(11)
    dup = rng.uniform(0, 40, (300, 2)).astype(np.float32)
    dup[1::3] = dup[::3][: len(dup[1::3])]
    dup[5], dup[6] = (1e-30, 0.0), (0.0, 0.0)  # d2 underflows to 0
    nan = rng.uniform(0, 40, (300, 3)).astype(np.float32)
    nan[[3, 90]] = np.nan
    nan[100, 2] = np.inf
    wide = rng.uniform(0, 1000, (300, 2)).astype(np.float32)
    inf = rng.uniform(0, 40, (60, 2)).astype(np.float32)
    inf[[2, 9]], inf[[4, 5], 1], inf[7, 0] = np.inf, -np.inf, np.nan
    return [
        ("2d", rng.uniform(0, 60, (400, 2)).astype(np.float32), 4.0),
        ("3d", rng.uniform(0, 25, (400, 3)).astype(np.float32), 4.0),
        ("1d", rng.uniform(0, 200, (300, 1)).astype(np.float32), 1.5),
        ("5d, grid on three axes", rng.uniform(0, 6, (300, 5)).astype(np.float32), 3.0),
        ("coincident, r = 0", dup, 0.0),
        ("coincident", dup, 3.0),
        ("nan and inf rows", nan, 6.0),
        ("radius above the extent", rng.uniform(0, 10, (200, 2)).astype(np.float32), 50.0),
        ("tiny radius, side enlarged to 2n cells", wide, 1e-3),
        ("tiny radius, side enlarged, pairs kept", wide, 30.0),
        ("infinite radius, infinite coordinates", inf, np.inf),
    ]


@pytest.mark.parametrize("name,c,radius", _grid_cases(), ids=[case[0] for case in _grid_cases()])
def test_cell_grid_invariants(name, c, radius):
    """The grid holds each point with finite gridded coordinates (every
    point if ``r2`` is inf) once, in cell order, in at most 2m cells;
    ``candidate_pairs`` counts each point against its 3^3 cells' points."""
    r2 = float(radius_threshold(radius))
    grid = cell_grid(torch.from_numpy(c), r2)
    kept = np.ones(len(c), bool) if np.isinf(r2) else np.isfinite(c[:, : min(c.shape[1], 3)]).all(axis=1)
    np.testing.assert_array_equal(np.sort(grid.order.numpy()), np.nonzero(kept)[0])
    assert np.prod(grid.dims) <= max(2 * kept.sum(), 1)
    assert torch.all(torch.diff(grid.cell_start) >= 0) and int(grid.cell_start[-1]) == kept.sum()
    cells = grid.cells.numpy().astype(np.int64)
    flat = (cells[:, 2] * grid.dims[1] + cells[:, 1]) * grid.dims[0] + cells[:, 0]
    assert np.all(np.diff(flat) >= 0) and np.all(cells < np.array(grid.dims))
    near = np.abs(cells[:, None, :] - cells[None, :, :]).max(axis=2) <= 1
    assert candidate_pairs(grid) == int(near.sum()) - len(cells)


def _view(ptr: int, dtype: np.dtype, count: int) -> np.ndarray:
    """A writable numpy view of ``count`` items at a tensor's ``data_ptr``."""
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * (count * itemsize)).from_address(ptr), dtype=dtype)


class _EmulatedK6:
    """``sqt_radius_pairs`` in numpy, reading and writing CPU tensors through
    the pointers the wrapper passes, one sorted point at a time as a thread
    of the kernel does."""

    def __init__(self) -> None:
        self.launches: list[int] = []

    def sqt_radius_pairs(self, pts, d, orig, cells, cell_start, m, nx, ny, nz, r2, counts, indptr, out_idx, out_dist,
                         fill, stream):
        self.launches.append(fill)
        if m == 0:
            return 0
        p = _view(pts, np.float32, m * d).reshape(m, d)
        o = _view(orig, np.int32, m)
        c = _view(cells, np.int32, 3 * m).reshape(m, 3)
        start = _view(cell_start, np.int64, nx * ny * nz + 1)
        found = []
        for t in range(m):
            cx, cy, cz = c[t]
            hits, dists = [], []
            for z in range(max(cz - 1, 0), min(cz + 1, nz - 1) + 1):
                for y in range(max(cy - 1, 0), min(cy + 1, ny - 1) + 1):
                    # the three cells along x: one contiguous range of the sort
                    base = (z * ny + y) * nx
                    s = np.arange(start[base + max(cx - 1, 0)], start[base + min(cx + 1, nx - 1) + 1])
                    s = s[s != t]
                    d2 = np.zeros(len(s), np.float32)
                    with np.errstate(invalid="ignore", over="ignore"):
                        for a in range(d):
                            diff = p[t, a] - p[s, a]
                            d2 = diff * diff if a == 0 else d2 + diff * diff
                        keep = d2 <= np.float32(r2)
                    hits += o[s[keep]].tolist()
                    dists += np.sqrt(d2[keep]).tolist()
            found.append((o[t], hits, dists))
        rows = int(o.max()) + 1
        if not fill:
            view = _view(counts, np.int32, rows)
            for row, hits, _ in found:
                view[row] = len(hits)
            return 0
        offsets = _view(indptr, np.int64, rows + 1)
        total = max(int(offsets[row]) + len(hits) for row, hits, _ in found)
        cols, dist = _view(out_idx, np.int32, total), _view(out_dist, np.float32, total)
        for row, hits, dists in found:
            cols[offsets[row] : offsets[row] + len(hits)] = hits
            dist[offsets[row] : offsets[row] + len(hits)] = dists
        return 0


@pytest.mark.parametrize("name,c,radius", _grid_cases(), ids=[case[0] for case in _grid_cases()])
def test_kernel_path_around_an_emulated_kernel(name, c, radius, monkeypatch):
    """The CUDA path's glue (grid, count pass, scan, fill pass, row order)
    on the CPU, with the kernel's C interface emulated: the plain CSR."""
    emulated = _EmulatedK6()
    monkeypatch.setattr(_cuda, "library", lambda: emulated)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setitem(_cuda.launches, "radius_pairs", 0)
    x = torch.from_numpy(c)
    got = trad._radius_k6(x, float(radius_threshold(radius)), None)
    for g, w in zip(got, radius_pairs(x, radius)):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert emulated.launches == [0, 1] and _cuda.launches["radius_pairs"] == 2


def test_grid_side_and_cap():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0, 100, (1000, 2)).astype(np.float32))
    grid = cell_grid(x, float(radius_threshold(5.0)))
    assert grid.side == pytest.approx(5.0 * (1 + 2**-10), rel=1e-12)
    extent = (x.max(0).values - x.min(0).values).double().tolist()
    assert grid.dims == (int(extent[0] // grid.side) + 1, int(extent[1] // grid.side) + 1, 1)
    coarse = cell_grid(x, float(radius_threshold(0.01)))  # 10^8 cells at this side: enlarged to <= 2n
    assert np.prod(coarse.dims) <= 2000 and coarse.side > 0.01


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    for name, c, radius in _grid_cases():
        want = radius_pairs(torch.from_numpy(c), radius)
        stats: dict = {}
        got = radius_pairs(torch.from_numpy(c).cuda(), radius, stats=stats)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), name
        assert stats["pairs"] == int(want[0][-1])
