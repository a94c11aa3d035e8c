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
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
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


def test_with_self_is_scipy_setdiag_of_the_csr_without():
    """``with_self=True`` is the CSR without the diagonal put through scipy's
    ``setdiag(0.0)``: one more entry a row (column = row, distance 0.0) in
    its ascending place, for NaN, inf and coincident points, at r = 0 and at
    an infinite radius too."""
    c = _coords(400, 2, 6.0, seed=21)
    c[1::7] = c[::7][: len(c[1::7])]
    c[[5, 50]] = np.nan
    c[60, 1] = np.inf
    c[[70, 71], 0] = -np.inf
    x = torch.from_numpy(c)
    for radius in (0.0, 6.0, 1e4, np.inf):
        without = radius_pairs(x, radius)
        want = sp.csr_matrix((without[2].numpy(), without[1].numpy(), without[0].numpy()), shape=(len(c), len(c)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", sp.SparseEfficiencyWarning)
            want.setdiag(0.0)
        got = radius_pairs(x, radius, with_self=True)
        np.testing.assert_array_equal(got[0].numpy(), want.indptr)
        np.testing.assert_array_equal(got[1].numpy(), want.indices)
        np.testing.assert_array_equal(got[2].numpy(), want.data)
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32 and got[2].dtype == torch.float32
        assert torch.equal(torch.diff(got[0]), torch.diff(without[0]) + 1)


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
        ("every point coincident", np.full((90, 2), 3.5, np.float32), 1.0),
        ("no finite point", np.full((40, 2), np.nan, np.float32), 1.0),
        ("no coordinates", np.zeros((30, 0), np.float32), 1.0),
    ]


def _view(ptr: int | None, dtype: np.dtype, count: int) -> np.ndarray:
    """A writable numpy view of ``count`` items at a tensor's ``data_ptr``."""
    if not count:
        return np.zeros(0, dtype)
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * (count * itemsize)).from_address(ptr), dtype=dtype)


class _EmulatedK6:
    """K6's C interface in numpy, reading and writing CPU tensors through the
    pointers the wrapper passes, as the kernels do: the bounds as
    order-preserving int keys, the cells in float64, the scatter in an
    arbitrary order inside each cell (as atomics leave it), the two passes
    one sorted point at a time, the list of rows past a warp's sort, and
    the row order by tier: those rows in chunks, then, past the block limit,
    merge rounds through the scratch copy in each row's own parity."""

    def __init__(self, seed: int = 0) -> None:
        self.calls: list[str] = []
        self.tiers: dict[str, int] = {}
        self.rng = np.random.default_rng(seed)

    def sqt_radius_bounds(self, x, n, d, g, bounds, stream):
        self.calls.append("bounds")
        pts = _view(x, np.float32, n * d).reshape(n, d)[:, :g]
        finite = pts[np.isfinite(pts).all(axis=1)]
        keys = lambda v: np.where(v.view(np.int32) < 0, v.view(np.int32) ^ np.int32(0x7FFFFFFF),  # noqa: E731
                                  v.view(np.int32))
        out = _view(bounds, np.int32, 7)
        out[:] = [2**31 - 1] * 3 + [-(2**31)] * 3 + [len(finite)]
        if len(finite):
            out[:g], out[3 : 3 + g] = keys(finite.min(axis=0)), keys(finite.max(axis=0))
        return 0

    def sqt_radius_bin(self, x, n, d, g, lo0, lo1, lo2, side, nx, ny, nz, one_cell, cell, cell_count, stream):
        self.calls.append("bin")
        pts = _view(x, np.float32, n * d).reshape(n, d)[:, :g].astype(np.float64)
        out, count = _view(cell, np.int32, n), _view(cell_count, np.int32, nx * ny * nz + 1)
        if one_cell:
            out[:] = 0
        else:
            finite = np.isfinite(pts).all(axis=1)
            q = np.zeros((n, 3), np.int64)
            with np.errstate(invalid="ignore"):
                q[:, :g] = np.floor((pts - np.array([lo0, lo1, lo2])[:g]) / side)
            q = np.clip(q, 0, np.array([nx, ny, nz]) - 1)
            out[:] = np.where(finite, (q[:, 2] * ny + q[:, 1]) * nx + q[:, 0], nx * ny * nz)
        np.add.at(count, out, 1)
        return 0

    def sqt_radius_scatter(self, x, n, d, cell, cursor, pts, orig, cell_sorted, stream):
        self.calls.append("scatter")
        if n == 0:
            return 0
        src = _view(x, np.float32, n * d).reshape(n, d)
        c = _view(cell, np.int32, n)
        cur = _view(cursor, np.int32, int(c.max()) + 1)
        dst, o, cs = _view(pts, np.float32, n * d).reshape(n, d), _view(orig, np.int32, n), _view(cell_sorted, np.int32, n)
        for i in self.rng.permutation(n):  # atomics in any order
            slot = cur[c[i]]
            cur[c[i]] += 1
            dst[slot], o[slot], cs[slot] = src[i], i, c[i]
        return 0

    def sqt_radius_pairs(self, pts, d, orig, cell, cell_start, n, nx, ny, nz, r2, with_self, counts, long_rows,
                         tier_sizes, warp_lim, indptr, out_idx, out_dist, fill, stream):
        self.calls.append("fill" if fill else "count")
        p = _view(pts, np.float32, n * d).reshape(n, d)
        o, c = _view(orig, np.int32, n), _view(cell, np.int32, n)
        start = _view(cell_start, np.int32, nx * ny * nz + 2)
        found = []
        for t in range(n):
            hits, dists = [], []
            if c[t] < nx * ny * nz:
                cx, cy, cz = c[t] % nx, c[t] // nx % ny, c[t] // (nx * ny)
                for z in range(max(cz - 1, 0), min(cz + 1, nz - 1) + 1):
                    for y in range(max(cy - 1, 0), min(cy + 1, ny - 1) + 1):
                        # the three cells along x: one contiguous range of the sort
                        base = (z * ny + y) * nx
                        s = np.arange(start[base + max(cx - 1, 0)], start[base + min(cx + 1, nx - 1) + 1])
                        d2 = np.zeros(len(s), np.float32)
                        with np.errstate(invalid="ignore", over="ignore"):
                            for a in range(d):
                                diff = p[t, a] - p[s, a]
                                d2 = diff * diff if a == 0 else d2 + diff * diff
                            keep = (d2 <= np.float32(r2)) & (s != t)
                        if with_self:  # its own point, where the walk meets it
                            keep |= s == t
                            d2[s == t] = 0.0
                        hits += o[s[keep]].tolist()
                        dists += np.sqrt(d2[keep]).tolist()
            elif with_self:
                hits, dists = [o[t]], [np.float32(0.0)]
            found.append((o[t], hits, dists))
        if not fill:
            view, sizes, listed = _view(counts, np.int32, n), _view(tier_sizes, np.int32, 2), _view(long_rows, np.int32, n)
            for row, hits, _ in found:
                view[row] = len(hits)
                if len(hits) > warp_lim:
                    listed[sizes[0]] = row
                    sizes[0] += 1
                    sizes[1] = max(sizes[1], len(hits))
            return 0
        offsets = _view(indptr, np.int64, n + 1)
        cols, dist = _view(out_idx, np.int32, int(offsets[-1])), _view(out_dist, np.float32, int(offsets[-1]))
        for row, hits, dists in found:
            cols[offsets[row] : offsets[row] + len(hits)] = hits
            dist[offsets[row] : offsets[row] + len(hits)] = dists
        return 0

    def sqt_radius_order(self, indptr, n, idx, dist, tmp_idx, tmp_dist, long_rows, n_long, longest, warp_lim,
                         block_lim, stream):
        self.calls.append("order")
        offsets = _view(indptr, np.int64, n + 1)
        nnz = int(offsets[-1])
        cols, dst = _view(idx, np.int32, nnz), _view(dist, np.float32, nnz)
        listed = _view(long_rows, np.int32, n_long)
        lens = np.diff(offsets)
        assert np.all(lens[listed] > warp_lim) and len(set(listed.tolist())) == n_long
        assert n_long == np.sum(lens > warp_lim) and longest == max(lens[listed], default=0)
        self.tiers = {"warp": int(np.sum((lens >= 2) & (lens <= warp_lim))),
                      "block": int(np.sum((lens[listed] <= block_lim))), "global": int(np.sum(lens[listed] > block_lim))}

        def sort(c, v, lo, hi):
            perm = np.argsort(c[lo:hi], kind="stable")
            c[lo:hi], v[lo:hi] = c[lo:hi][perm], v[lo:hi][perm]

        def rounds(length, chunk):
            return int(np.ceil(np.log2(length / chunk))) if length > chunk else 0

        for row in np.nonzero(lens <= warp_lim)[0]:
            sort(cols, dst, offsets[row], offsets[row + 1])
        if not n_long:
            return 0
        chunk = min(1 << int(np.ceil(np.log2(longest))), block_lim)
        bufs = [(cols, dst), (_view(tmp_idx, np.int32, nnz if longest > block_lim else 0),
                              _view(tmp_dist, np.float32, nnz if longest > block_lim else 0))]
        at = {}  # each row's buffer: its chunks land where its own rounds end in idx/dist
        for row in listed:
            lo, hi = int(offsets[row]), int(offsets[row + 1])
            at[row] = rounds(hi - lo, chunk) % 2
            part = [(cols[a : min(a + chunk, hi)].copy(), dst[a : min(a + chunk, hi)].copy()) for a in range(lo, hi, chunk)]
            for a, (c, v) in zip(range(lo, hi, chunk), part):
                perm = np.argsort(c, kind="stable")
                bufs[at[row]][0][a : a + len(c)], bufs[at[row]][1][a : a + len(c)] = c[perm], v[perm]
        width = chunk
        while width < longest:
            for row in listed:
                lo, hi = int(offsets[row]), int(offsets[row + 1])
                if hi - lo <= width:
                    continue
                (s_c, s_v), (d_c, d_v) = bufs[at[row]], bufs[1 - at[row]]
                for a in range(lo, hi, 2 * width):
                    b, e = min(a + width, hi), min(a + 2 * width, hi)
                    assert np.all(np.diff(s_c[a:b]) > 0) and np.all(np.diff(s_c[b:e]) > 0)  # merged runs are sorted
                    perm = np.argsort(s_c[a:e], kind="stable")
                    d_c[a:e], d_v[a:e] = s_c[a:e][perm], s_v[a:e][perm]
                at[row] = 1 - at[row]
            width *= 2
        assert not any(at.values())  # every row ends in idx/dist
        return 0


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels emulated"])
@pytest.mark.parametrize("name,c,radius", _grid_cases(), ids=[case[0] for case in _grid_cases()])
def test_cell_grid_invariants(name, c, radius, kernels, monkeypatch):
    """The grid holds every point once, in cell order: those with finite
    gridded coordinates (every point if ``r2`` is inf) in at most 2m cells,
    the others in the extra cell after them; ``candidate_pairs`` counts
    each gridded point against its 3^3 cells' points. The same for the
    plain binning and for K6's kernels (emulated), whose counting sort
    leaves each cell's points in any order."""
    r2 = float(radius_threshold(radius))
    x = torch.from_numpy(c)
    if kernels:
        monkeypatch.setattr(_cuda, "library", lambda: _EmulatedK6())
        monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
        monkeypatch.setitem(_cuda.launches, "radius_pairs", 0)
        stats: dict = {}
        grid = trad._cell_grid_k6(x, r2, stats)
        assert stats.get("host_syncs", 0) == (0 if trad._one_cell(r2, min(c.shape[1], 3)) else 1)
    else:
        grid = cell_grid(x, r2)
    kept = np.ones(len(c), bool) if np.isinf(r2) else np.isfinite(c[:, : min(c.shape[1], 3)]).all(axis=1)
    order = grid.order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(len(c)))
    np.testing.assert_array_equal(grid.pts.numpy(), c[order])
    n_cells = int(np.prod(grid.dims))
    assert grid.points == kept.sum() and n_cells <= max(2 * kept.sum(), 1)
    start = grid.cell_start.numpy()
    assert start.dtype == np.int32 and len(start) == n_cells + 2 and np.all(np.diff(start) >= 0)
    assert start[-1] == len(c) and start[-2] == kept.sum()
    cell = grid.cell.numpy()
    np.testing.assert_array_equal(cell, np.repeat(np.arange(n_cells + 1), np.diff(start)))
    np.testing.assert_array_equal(kept[order], cell < n_cells)
    coords = np.stack([cell % grid.dims[0], cell // grid.dims[0] % grid.dims[1], cell // (grid.dims[0] * grid.dims[1])],
                      axis=1)[: grid.points]
    near = np.abs(coords[:, None, :] - coords[None, :, :]).max(axis=2) <= 1
    assert candidate_pairs(grid) == int(near.sum()) - len(coords)
    if kernels:
        want = cell_grid(x, r2)
        assert (grid.dims, grid.side) == (want.dims, want.side)
        assert torch.equal(grid.cell_start, want.cell_start)
        np.testing.assert_array_equal(np.sort(order[cell == 0]), np.sort(want.order.numpy()[want.cell.numpy() == 0]))


# the tiers' limits lowered so every row-order tier runs at these sizes
LOW_TIERS = (4, 8)


@pytest.mark.parametrize("with_self", [False, True], ids=["self excluded", "with self"])
@pytest.mark.parametrize("tiers", ["default tiers", "lowered tiers"])
@pytest.mark.parametrize("name,c,radius", _grid_cases(), ids=[case[0] for case in _grid_cases()])
def test_kernel_path_around_an_emulated_kernel(name, c, radius, tiers, with_self, monkeypatch):
    """The CUDA path's glue (grid bounds and counting sort, count pass,
    scan, fill pass, the row order's tiers) on the CPU, with the kernels' C
    interface emulated: the plain CSR, bitwise, in two reads of the card."""
    emulated = _EmulatedK6(seed=len(c))
    monkeypatch.setattr(_cuda, "library", lambda: emulated)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setitem(_cuda.launches, "radius_pairs", 0)
    if tiers == "lowered tiers":
        monkeypatch.setattr(trad, "_ORDER_TIERS", LOW_TIERS)
    x = torch.from_numpy(c)
    r2 = float(radius_threshold(radius))
    got = trad._radius_k6(x, r2, None, with_self)
    for g, w in zip(got, radius_pairs(x, radius, with_self=with_self)):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    grid_calls = ["bin", "scatter"] if trad._one_cell(r2, min(c.shape[1], 3)) else ["bounds", "bin", "scatter"]
    assert emulated.calls == grid_calls + ["count", "fill", "order"]
    assert _cuda.launches["radius_pairs"] == len(emulated.calls)
    lens = np.diff(got[0].numpy())
    warp_lim, block_lim = trad._ORDER_TIERS
    assert emulated.tiers == {"warp": int(np.sum((lens >= 2) & (lens <= warp_lim))),
                              "block": int(np.sum((lens > warp_lim) & (lens <= block_lim))),
                              "global": int(np.sum(lens > block_lim))}


def test_lowered_tiers_reach_every_tier():
    """At the lowered limits the fixtures send rows to all three tiers, and
    through more than one merge round."""
    cases = {case[0]: case[1:] for case in _grid_cases()}
    pts, radius = cases["radius above the extent"]
    lens = np.diff(radius_pairs(torch.from_numpy(pts), radius)[0].numpy())
    assert lens.max() > 4 * LOW_TIERS[1]
    pts, radius = cases["2d"]
    lens = np.diff(radius_pairs(torch.from_numpy(pts), radius)[0].numpy())
    assert all(np.any(sel) for sel in ((lens >= 2) & (lens <= 4), (lens > 4) & (lens <= 8), lens > 8))


def test_tier_limits_are_checked_by_the_kernel_interface():
    """The wrapper's own tier limits are within what ``sqt_radius_order``
    takes: a warp's 64 entries, a power-of-two block of at most 16,384."""
    warp_lim, block_lim = trad._ORDER_TIERS
    assert 1 <= warp_lim <= 64 <= block_lim <= 16384 and block_lim & (block_lim - 1) == 0
    assert 4 <= LOW_TIERS[1] and LOW_TIERS[1] & (LOW_TIERS[1] - 1) == 0


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
        for with_self in (False, True):
            for tiers in (None, LOW_TIERS):
                want = radius_pairs(torch.from_numpy(c), radius, with_self=with_self)
                stats: dict = {}
                got = radius_pairs(torch.from_numpy(c).cuda(), radius, with_self=with_self, stats=stats, _tiers=tiers)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w), name
                assert stats["host_syncs"] <= 2
                if "pairs" in stats:
                    assert stats["pairs"] == int(want[0][-1])
