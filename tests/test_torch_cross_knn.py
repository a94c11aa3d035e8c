"""K8's cell-grid search (``ops/knn.py`` ``_nearest_grid``) on the CPU, around a
numpy emulation of its C interface.

K8 runs only on the card. What surrounds it runs here: K6's bounds, bin and
scatter (emulated as in ``test_torch_radius.py``), the grid's geometry
(``ops/radius.py`` ``_knn_grid_geometry``), the queries' counting sort and
the launch. ``sqt_cross_knn`` is emulated as the kernel walks: rings of
cells outward from each query's cell, stopping once ``_ring_bound`` (the
kernel's lower bound on the float32 ``d2`` of every unvisited point) is
strictly above the ``d2`` of the last key of its list (the k-th, or for a k
that is not a power of two up to 32 the next power's), then the cell of points with none
when it never stops, and a scan of every point for a non-finite query.

Tolerance: bitwise. Every result must equal the plain version
(``_nearest_plain``, every point by ``torch.topk``) on inputs built to break
the walk: ties across cell boundaries with the lower index a ring out,
points exactly at a ring's bound (also with no margin at all), coincident
points, queries outside the points' box, clusters with empty space between
them, k above a 3 x 3 block's points and above the register list, 1D, 3D
and 4D, NaN and infinite coordinates, coordinates near 1e19 whose ``d2``
overflow, one point, and k = n. The kernel itself is held to the plain
version on the card (``test_torch_ripley.py``, marked ``cuda``, on these
same inputs).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from test_torch_radius import _EmulatedK6, _view

import squidpy_torch as sqt
from squidpy_torch import _cuda
from squidpy_torch.ops import knn as tknn
from squidpy_torch.ops import radius as trad

torch.set_num_threads(1)

NAN_BITS = 0x7FC00000


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _keys(q: np.ndarray, pts: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``bits(d2) << 32 | row``: the port's difference-form d2, each
    operation rounded in float32, a NaN d2 at 0x7fc00000."""
    with np.errstate(invalid="ignore", over="ignore"):
        diff = q[0] - pts[:, 0]
        d2 = diff * diff
        for a in range(1, pts.shape[1]):
            diff = q[a] - pts[:, a]
            d2 = d2 + diff * diff
    bits = np.where(np.isnan(d2), NAN_BITS, d2.view(np.uint32)).astype(np.uint64)
    return (bits << np.uint64(32)) | rows.astype(np.uint64)


class _EmulatedK8(_EmulatedK6):
    """K6's bounds, bin and scatter (inherited) and ``sqt_cross_knn`` in
    numpy, reading and writing CPU tensors through the pointers the
    wrapper passes. It counts what the kernel's stats count: tests, rings
    and queries that scanned every point."""

    def __init__(self, seed: int = 0) -> None:
        super().__init__(seed)
        self.tests: list[int] = []
        self.rings: list[int] = []
        self.scanning = 0

    def sqt_cross_knn(self, qpts, qorig, qcell, m, pts, orig, cell_start, n_sets, n, dim, k, lo0, lo1, lo2, side,
                      nx, ny, nz, margin, scratch, stats, out_d, out_i, stream):
        self.calls.append("search")
        assert (scratch is not None) == (k > 32) and stats is None
        g, dims, n_cells = min(dim, 3), (nx, ny, nz), nx * ny * nz
        q = _view(qpts, np.float32, m * dim).reshape(m, dim)
        q_rows, q_cell = _view(qorig, np.int32, m), _view(qcell, np.int32, m)
        p = _view(pts, np.float32, n_sets * n * dim).reshape(n_sets * n, dim)
        rows = _view(orig, np.int32, n_sets * n)
        starts = _view(cell_start, np.int32, n_sets * (n_cells + 1) + 1)
        dist = _view(out_d, np.float32, n_sets * m * k).reshape(n_sets, m, k)
        idx = _view(out_i, np.int32, n_sets * m * k).reshape(n_sets, m, k)
        lo = [lo0, lo1, lo2][:g]
        kc = 1 << (k - 1).bit_length() if k <= 32 else k  # the kernel's list: it stops on its last key
        for s in range(n_sets):
            cs = starts[s * (n_cells + 1) :]
            for t in range(m):
                slots: list[np.ndarray] = []
                if q_cell[t] >= n_cells:  # a non-finite gridded coordinate: every point
                    slots.append(np.arange(s * n, s * n + n))
                    self.scanning += 1
                    rings = 0
                else:
                    c = int(q_cell[t])
                    cc = (c % nx, c // nx % ny, c // (nx * ny))
                    rings, stopped = 0, False
                    while True:
                        r = rings
                        box_lo = [max(cc[a] - r, 0) for a in range(3)]
                        box_hi = [min(cc[a] + r, dims[a] - 1) for a in range(3)]
                        for z in range(box_lo[2], box_hi[2] + 1):
                            for y in range(box_lo[1], box_hi[1] + 1):
                                row = (z * ny + y) * nx
                                if max(abs(z - cc[2]), abs(y - cc[1])) == r:  # the row's cells of the box
                                    slots.append(np.arange(cs[row + box_lo[0]], cs[row + box_hi[0] + 1]))
                                else:  # the two cells at distance r along x
                                    for x in (cc[0] - r, cc[0] + r) if r else ():
                                        if 0 <= x < nx:
                                            slots.append(np.arange(cs[row + x], cs[row + x + 1]))
                        rings += 1
                        bound = trad._ring_bound(q[t], lo, side, box_lo[:g], box_hi[:g], dims[:g], margin)
                        if bound is None:  # the box holds every cell
                            break
                        keys = _keys(q[t], p[np.concatenate(slots)], rows[np.concatenate(slots)] - s * n)
                        last = 0xFFFFFFFF if len(keys) < kc else int(np.partition(keys, kc - 1)[kc - 1] >> np.uint64(32))
                        if int(np.float32(bound).view(np.uint32)) > last:
                            stopped = True
                            break
                    if not stopped:  # the points with no cell
                        slots.append(np.arange(cs[n_cells], cs[n_cells + 1]))
                sel = np.concatenate(slots)
                keys = np.sort(_keys(q[t], p[sel], rows[sel] - s * n))[:k]
                assert len(keys) == k and len(np.unique(sel)) == len(sel)  # no point tested twice
                dist[s, q_rows[t]] = np.sqrt((keys >> np.uint64(32)).astype(np.uint32).view(np.float32))
                idx[s, q_rows[t]] = (keys & np.uint64(0xFFFFFFFF)).astype(np.int32)
                self.tests.append(len(sel))
                self.rings.append(rings)
        return 0


def _boundary_ties() -> tuple[np.ndarray, np.ndarray]:
    """200 points whose box is [0, 10]^2, so the grid's side is exactly 1
    (two points a cell): points on the cell boundaries x = 1..9 and y =
    1..9 along the rows y = 5.5 and x = 5.5, queries at the cells' centres
    between them. Each query's two nearest points lie at exactly 0.5, one
    in its own cell and one on the boundary of the next: the bound after
    ring 0 meets that point's d2. The rows are shuffled, so the next
    ring's point holds the lower index for some queries. The other points
    lie 2 or more from every query."""
    rng = np.random.default_rng(7)
    on_edges = [(x, 5.5) for x in range(1, 10)] + [(5.5, y) for y in range(1, 10)]
    corners = [(0.0, 0.0), (10.0, 0.0), (0.0, 10.0), (10.0, 10.0)]
    fill = rng.uniform([0.0, 0.0], [3.0, 3.0], (200 - len(on_edges) - len(corners), 2))
    data = np.concatenate([np.array(on_edges + corners, np.float64), fill])[rng.permutation(200)]
    queries = [(x + 0.5, 5.5) for x in range(1, 9)] + [(5.5, y + 0.5) for y in range(1, 9)]
    return np.array(queries, np.float32), data.astype(np.float32)


def _cases() -> list[tuple[str, np.ndarray, np.ndarray, int]]:
    """(name, queries (m, d), data (S, n, d), k), float32."""
    rng = np.random.default_rng(3)
    ties_q, ties = _boundary_ties()
    uniform = rng.uniform(0, 100, (400, 2))
    twice = np.repeat(rng.uniform(0, 100, (150, 2)), 2, axis=0)  # every point twice: ties by index
    clusters = np.concatenate([rng.normal(0, 0.01, (150, 2)), rng.normal(1000, 0.01, (150, 2))])
    nonfinite = rng.uniform(0, 50, (300, 2))
    nonfinite[[4, 40, 140]] = np.nan
    nonfinite[[9, 99], 1] = np.inf
    nonfinite[[17, 71], 0] = -np.inf
    nan_queries = rng.uniform(0, 50, (60, 2))
    nan_queries[[0, 7]] = np.nan
    nan_queries[3, 1] = np.inf
    nan_queries[5, 0] = -np.inf
    four = rng.uniform(0, 20, (300, 4))
    four[[3, 30], 3] = np.nan  # a non-finite coordinate off the grid's axes
    four_q = rng.uniform(0, 20, (80, 4))
    four_q[[2, 20], 3] = np.inf
    huge = rng.uniform(-1e19, 1e19, (200, 2))
    huge[:20] = rng.uniform(0, 1, (20, 2))  # beside them, a few points whose d2 do not overflow
    sets = rng.uniform(0, 100, (5, 120, 2))
    sets[2, [5, 6]] = np.nan
    cases = [
        ("ties across cell boundaries", ties_q, ties, 1),
        ("ties across cell boundaries, k = 3", ties_q, ties, 3),
        ("uniform", rng.uniform(0, 100, (150, 2)), uniform, 2),
        ("coincident points", rng.uniform(0, 100, (120, 2)), twice, 3),
        ("every point at one place", rng.uniform(0, 5, (30, 2)), np.full((40, 2), 2.5), 4),
        ("queries outside the box", rng.uniform(-300, 400, (120, 2)), uniform, 2),
        ("clusters far apart", rng.uniform(-100, 1100, (80, 2)), clusters, 2),
        ("k above the 3 x 3 block", rng.uniform(0, 100, (60, 2)), uniform, 30),
        ("k above the register list", rng.uniform(0, 100, (60, 2)), uniform, 40),
        ("1D", rng.uniform(-10, 210, (120, 1)), rng.uniform(0, 200, (300, 1)), 5),
        ("3D", rng.uniform(0, 30, (100, 3)), rng.uniform(0, 30, (400, 3)), 7),
        ("4D, non-finite off the grid", four_q, four, 3),
        ("NaN and inf points", rng.uniform(-10, 60, (100, 2)), nonfinite, 3),
        ("NaN and inf queries", nan_queries, nonfinite, 2),
        ("coordinates near 1e19", rng.uniform(-1e19, 1e19, (60, 2)), huge, 3),
        ("coordinates near 1e19, the k-th d2 overflows", rng.uniform(-1e19, 1e19, (40, 2)),
         rng.uniform(-1e19, 1e19, (25, 2)), 25),
        ("one point", rng.uniform(0, 10, (20, 2)), np.array([[3.0, 4.0]]), 1),
        ("k = n", rng.uniform(0, 10, (20, 2)), rng.uniform(0, 10, (50, 2)), 50),
        ("five sets", rng.uniform(-5, 105, (90, 2)), sets, 1),
    ]
    return [(name, q.astype(np.float32), np.asarray(d, np.float32).reshape(-1, *np.shape(d)[-2:]), k)
            for name, q, d, k in cases]


def _emulated(monkeypatch, seed: int = 0) -> _EmulatedK8:
    emulated = _EmulatedK8(seed)
    monkeypatch.setattr(_cuda, "library", lambda: emulated)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setitem(_cuda.launches, "radius_pairs", 0)
    monkeypatch.setitem(_cuda.launches, "cross_knn", 0)
    return emulated


@pytest.mark.parametrize("margin", ["margin", "no margin"])
@pytest.mark.parametrize("name,queries,data,k", _cases(), ids=[case[0] for case in _cases()])
def test_grid_search_matches_plain(name, queries, data, k, margin, monkeypatch):
    """The wrapper around the emulated kernel: the plain version's
    neighbours and distances, bitwise, in one read of the card. With no
    margin the ring bound can equal a point's d2 exactly (the boundary
    ties), and the strict test keeps walking."""
    emulated = _emulated(monkeypatch, seed=len(queries))
    if margin == "no margin":
        monkeypatch.setattr(tknn, "_GAP_MARGIN", 0.0)
    q, x = torch.from_numpy(queries), torch.from_numpy(data)
    got = tknn._nearest_grid(q, x, k)
    want = tknn._nearest_plain(q, x, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    assert emulated.calls == ["bounds", "bin", "scatter", "bin", "scatter", "search"]
    assert _cuda.launches["radius_pairs"] == 5 and _cuda.launches["cross_knn"] == 1
    n_scanning = int((~np.isfinite(queries[:, : min(queries.shape[1], 3)])).any(axis=1).sum()) * len(data)
    assert emulated.scanning == n_scanning


def test_boundary_ties_reach_the_next_ring(monkeypatch):
    """The tie fixture is what it claims: each query's two nearest points
    are at d2 = 0.25, one in the next cell, and for some queries that one
    holds the lower index and wins."""
    queries, data = _boundary_ties()
    n = len(data)
    dims, side = trad._knn_grid_geometry(2, 1, n, [0.0, 0.0], [10.0, 10.0])
    assert side == 1.0 and dims == (11, 11, 1)
    _, idx = tknn._nearest_plain(torch.from_numpy(queries), torch.from_numpy(data)[None], 2)
    d2 = ((data[idx[0].numpy()] - queries[:, None, :]) ** 2).sum(axis=-1)
    assert np.all(d2 == 0.25)
    cell = lambda p: tuple(np.floor(p).astype(int))  # noqa: E731  (side 1 from the origin)
    winner_out = [cell(data[idx[0, t, 0]]) != cell(queries[t]) for t in range(len(queries))]
    assert any(winner_out) and not all(winner_out)


def test_the_walk_prunes(monkeypatch):
    """On uniform points the walk stops after a ring or two: the tests a
    query are a small multiple of k, not n."""
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 1000, (3000, 2)).astype(np.float32)
    queries = rng.uniform(0, 1000, (300, 2)).astype(np.float32)
    emulated = _emulated(monkeypatch)
    got = tknn._nearest_grid(torch.from_numpy(queries), torch.from_numpy(data)[None], 2)
    want = tknn._nearest_plain(torch.from_numpy(queries), torch.from_numpy(data)[None], 2)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert np.mean(emulated.tests) < 40 and max(emulated.tests) < 100
    assert max(emulated.rings) <= 3 and emulated.scanning == 0


def test_clusters_walk_many_rings(monkeypatch):
    """Between far clusters the k nearest lie many rings out, and the walk
    still stops before the whole grid."""
    name, queries, data, k = next(case for case in _cases() if case[0] == "clusters far apart")
    emulated = _emulated(monkeypatch)
    tknn._nearest_grid(torch.from_numpy(queries), torch.from_numpy(data), k)
    assert max(emulated.rings) >= 5


@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_ring_bound_is_below_every_unvisited_point(dim):
    """``_ring_bound`` against the float32 d2 of every point that K6's bin
    formula puts outside the box, for boxes around many queries, with
    points on and just off the cell boundaries."""
    rng = np.random.default_rng(dim)
    g = min(dim, 3)
    pts = rng.uniform(-40, 60, (600, dim)).astype(np.float32)
    finite = pts.astype(np.float64)
    lo, hi = finite[:, :g].min(0).tolist(), finite[:, :g].max(0).tolist()
    dims, side = trad._knn_grid_geometry(g, 1, len(pts), lo, hi)
    edges = (np.array(lo) + side * rng.integers(1, max(dims[:g]), (200, g))).astype(np.float32)
    step = rng.choice([-1, 0, 1], edges.shape)  # on a boundary, or a float32 below or above it
    with np.errstate(invalid="ignore"):
        pts[:200, :g] = np.where(step == 0, edges, np.nextafter(edges, step * np.float32(np.inf)))
    cells = np.clip(np.floor((pts[:, :g].astype(np.float64) - lo) / side).astype(np.int64), 0, np.array(dims[:g]) - 1)
    positive = 0
    for q in rng.uniform(-60, 80, (40, dim)).astype(np.float32):
        qc = np.clip(np.floor((q[:g].astype(np.float64) - lo) / side).astype(np.int64), 0, np.array(dims[:g]) - 1)
        for r in range(4):
            box_lo, box_hi = np.maximum(qc - r, 0), np.minimum(qc + r, np.array(dims[:g]) - 1)
            bound = trad._ring_bound(q, lo, side, box_lo.tolist(), box_hi.tolist(), dims[:g])
            outside = ((cells < box_lo) | (cells > box_hi)).any(axis=1)
            if bound is None:
                assert not outside.any()
                break
            d2 = (_keys(q, pts[outside], np.zeros(int(outside.sum()))) >> np.uint64(32)).astype(np.uint32)
            assert np.all(d2 >= np.float32(bound).view(np.uint32))
            positive += bound > 0
    assert positive >= 40  # the bound is not trivially 0


def test_ring_bound_rounds_down_and_saturates():
    # a gap of exactly 0.5 beyond the box: the margin takes it just below 0.25
    assert trad._ring_bound(np.float32([5.5, 5.5]), [0.0, 0.0], 1.0, [5, 5], [5, 5], (11, 11)) < 0.25
    assert trad._ring_bound(np.float32([5.5, 5.5]), [0.0, 0.0], 1.0, [5, 5], [5, 5], (11, 11), margin=0.0) == 0.25
    # the box holds every cell
    assert trad._ring_bound(np.float32([5.5]), [0.0], 1.0, [0], [10], (11,)) is None
    # a query inside the box at its edge: nothing between
    assert trad._ring_bound(np.float32([5.0]), [0.0], 1.0, [5], [5], (11,)) == 0.0
    # a gap above float32's largest value: the square saturates at inf, above every finite d2
    assert trad._ring_bound(np.float32([-3e38]), [-3e38], 4e38, [0], [0], (2,)) == np.inf
    assert trad._ring_bound(np.float32([0.0]), [0.0], 2e19, [0], [0], (2,)) == np.inf


def test_grid_geometry():
    dims, side = trad._knn_grid_geometry(2, 1, 52_735, [0.0, 0.0], [1e4, 1e4])
    assert 1.5 <= 52_735 / math.prod(dims) <= 2.5  # about two points a cell
    dims, side = trad._knn_grid_geometry(2, 100, 100_000, [0.0, 0.0], [1e4, 1e4])  # a set's share of the points
    assert 1.5 <= 1000 / math.prod(dims) <= 2.5
    assert trad._knn_grid_geometry(2, 1, 0, [0.0, 0.0], [0.0, 0.0]) == ((1, 1, 1), 1.0)
    assert trad._knn_grid_geometry(3, 1, 9, [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]) == ((1, 1, 1), 1.0)
    dims, side = trad._knn_grid_geometry(2, 1, 1000, [0.0, 0.0], [1e4, 0.0])  # a line: cells along it only
    assert dims[1:] == (1, 1) and 400 <= dims[0] <= 2000
    dims, side = trad._knn_grid_geometry(2, 1, 1000, [0.0, 0.0], [1e4, 1e-3])  # elongated: cells capped at 2 n
    assert math.prod(dims) <= 2000
    dims, side = trad._knn_grid_geometry(2, 1, 200, [-1e19, -1e19], [1e19, 1e19])
    assert math.isfinite(side) and math.prod(dims) <= 400


def test_route_by_shape():
    """The scan only for small sets and little work with k in registers:
    the F envelope's 100 clouds of 1000 points against 1000 queries; the
    grid for the G envelope (1M queries), a type's 53k points (even against
    1000 queries: a scan of that many points a thread idles the card) and
    k above the register list."""
    assert tknn._k8_route(100, 1000, 1000, 1) == "scan"
    assert tknn._k8_route(100, 1_000_000, 1000, 1) == "grid"
    assert tknn._k8_route(1, 1000, 52_735, 2) == "grid"
    assert tknn._k8_route(1, 1000, 3000, 40) == "grid"
    assert tknn._k8_route(1, 300, 500, 7) == "scan"
