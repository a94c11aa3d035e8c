"""squidpy_torch's feature-space kNN (``ops/knn.py`` ``feature_knn``, kernel K12)
and clustering graph against squidpy_tpu's ``brute_force_knn`` / ``knn_graph``.

Tolerances. The port ranks rows by the difference-form d2 summed in axis
order, ties to the lowest index, the row itself excluded by index; the JAX
package ranks by the expanded form ``|a|^2 + |b|^2 - 2ab``, whose error is
a few ulps of max |x|^2 times d. So each row's neighbour set equals JAX's
except at near ties: every row whose sets differ is asserted to have its
k-th and (k+1)-th float64 d2 within :data:`TIE_ULPS` ulps of max |x|^2
times d (ROADMAP queue 3, "Brute-force kNN near ties"). Distances of the
neighbours both packages find agree within 2 ulps up to 16 features and
within :func:`_dist_ulps` above (each package sums the squares in its own
order and takes a correctly rounded root). On the fixtures the clustering
graphs are asserted equal.

K12 runs only on the card: its wrapper (padding to K12's width, the
centring and norms of the filter route, the scratch list for k above 32,
the listed rows that the exact route takes) runs here around a numpy
emulation of its C interface; the cuda-marked test holds the kernel to the
plain version. The filter's candidate rule (csrc/feature_knn.cu) is held
here on adversarial inputs: bf16 terms rounded as ``cvt.rn.bf16x2``
rounds them (to nearest even: a carry into the kept mantissa bits, then a
mask), the tensor cores' sums taken in float32 in two orders and in
float64, and every member of the plain version's top k asserted among the
pairs the rule re-ranks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_radius import _view

import squidpy_torch as sqt
from squidpy_torch import _cuda
from squidpy_torch.models import clustering as tcl
from squidpy_torch.ops import knn as tknn
from squidpy_tpu.models import clustering as jcl
from squidpy_tpu.ops import knn as jknn

torch.set_num_threads(1)

TIE_ULPS = 8


def _dist_ulps(d: int) -> int:
    """Distances of common neighbours: within 2 ulps up to 16 features;
    above, the two packages' sums of d squares (sequential, and XLA's
    reduction order) differ by about sqrt(d) roundings of d2, half as many
    ulps of its root: 2 + ceil(sqrt(d) / 4) (4 at 50 features, where 3 was
    seen)."""
    return 2 if d <= 16 else 2 + int(np.ceil(np.sqrt(d) / 4))


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _features(n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, (6, d))
    return (centers[rng.integers(0, 6, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)


def _exact_d2(x: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    diff = x[rows][:, None, :].astype(np.float64) - x[cols].astype(np.float64)
    return (diff * diff).sum(axis=-1)


def _assert_sets_near_ties(x: np.ndarray, it: np.ndarray, ij: np.ndarray, k: int) -> int:
    """Equal neighbour sets, or a near tie at the k-th neighbour; returns the
    rows that differ."""
    n, d = x.shape
    band = TIE_ULPS * np.finfo(np.float32).eps * d * float((x.astype(np.float64) ** 2).sum(axis=1).max())
    differ = [i for i in range(n) if set(it[i]) != set(ij[i])]
    for i in differ:
        d2 = np.sort(_exact_d2(x, np.array([i]), np.delete(np.arange(n), i))[0])
        assert d2[k] - d2[k - 1] <= band, (i, d2[k - 1], d2[k], band)
    return len(differ)


@pytest.mark.parametrize(("n", "d", "k"), [(2000, 8, 15), (1500, 16, 15), (1200, 50, 10), (800, 3, 40)])
def test_plain_against_jax(n, d, k):
    x = _features(n, d, seed=d)
    dt, it = tknn.feature_knn(torch.from_numpy(x), k)
    dj, ij = jknn.brute_force_knn(x, k)
    it, dt = it.numpy(), dt.numpy()
    assert it.dtype == np.int32 and dt.dtype == np.float32 and it.shape == (n, k)
    assert _assert_sets_near_ties(x, it, ij, k) <= n // 100
    assert not (it == np.arange(n)[:, None]).any()
    assert np.all(np.diff(dt, axis=1) >= 0)
    for i in range(0, n, 5):
        common = np.intersect1d(it[i], ij[i])
        a = dt[i][[list(it[i]).index(c) for c in common]]
        b = dj[i][[list(ij[i]).index(c) for c in common]]
        ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert ulps.max(initial=0) <= _dist_ulps(d)


def test_ties_go_to_the_lowest_index_and_duplicates_find_each_other():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, size=(600, 4)).astype(np.float32)  # many exact ties, exact d2
    _, it = tknn.feature_knn(torch.from_numpy(x), 7)
    d2 = _exact_d2(x, np.arange(600), np.arange(600))
    np.fill_diagonal(d2, np.inf)
    want = np.lexsort((np.broadcast_to(np.arange(600), d2.shape), d2), axis=1)[:, :7]
    np.testing.assert_array_equal(it.numpy(), want)
    y = _features(300, 6, 5)
    y[10] = y[250]
    dt, it = tknn.feature_knn(torch.from_numpy(y), 3)
    assert it[10, 0] == 250 and it[250, 0] == 10 and dt[10, 0] == 0 and dt[250, 0] == 0


def test_non_finite_rows_rank_last():
    x = _features(300, 5, 1)
    x[7, 2] = np.nan
    x[9, 0] = np.inf
    dt, it = tknn.feature_knn(torch.from_numpy(x), 299)
    assert it[0, -1] == 7 and it[0, -2] == 9  # NaN d2 after +inf, each after every finite one
    assert torch.isnan(dt[0, -1]) and torch.isinf(dt[0, -2])


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="n_neighs"):
        tknn.feature_knn(torch.zeros((5, 2)), 5)
    with pytest.raises(ValueError, match="feature matrix"):
        tknn.feature_knn(torch.zeros(5), 1)


@pytest.mark.parametrize(("d", "dp"), [(1, 8), (8, 8), (9, 16), (50, 56), (64, 64), (65, 96), (256, 256), (300, 320)])
def test_k12_width(d, dp):
    assert tknn._feature_pad(d) == dp


def _bf16_rn(v: np.ndarray) -> np.ndarray:
    """float32 to bf16 (as float32) as ``cvt.rn.bf16x2.f32`` rounds: to 7
    stored mantissa bits, ties to even (non-finite values kept)."""
    v = np.asarray(v, np.float32)
    b = v.view(np.uint32).astype(np.uint64)
    bits = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return np.where(np.isfinite(v), bits.astype(np.uint32).view(np.float32), v)


def _plain_keys(x: np.ndarray) -> np.ndarray:
    """(n, n) uint64 keys ``bits(d2) << 32 | j`` of the plain version's
    float32 difference-form d2 (NaN as 0x7fc00000), the diagonal all ones."""
    n, dp = x.shape
    d2 = np.zeros((n, n), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for e in range(dp):
            diff = x[:, None, e] - x[None, :, e]
            d2 = (d2 + diff * diff).astype(np.float32)
    bits = np.where(np.isnan(d2), np.uint32(tknn._NAN_D2_BITS), d2.view(np.uint32)).astype(np.uint64)
    keys = (bits << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    np.fill_diagonal(keys, np.iinfo(np.uint64).max)
    return keys


def _threshold(last: np.ndarray) -> np.ndarray:
    """T_i: the d2 of each list's k-th key, +inf while the list is short or that d2 is NaN."""
    bits = (last >> np.uint64(32)).astype(np.uint32)
    t = bits.view(np.float32).astype(np.float64)
    return np.where((last == np.iinfo(np.uint64).max) | (bits == tknn._NAN_D2_BITS), np.inf, t)


def _filter_emulation(xp: np.ndarray, xc: np.ndarray, norms: np.ndarray, k: int, cap: int,
                      order: str = "forward") -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """K12's filter on the padded rows ``xp``, their centred rows ``xc`` and
    norms (NaN if unbounded): column tiles (:func:`_k12_tile_cols`) in index order; A = -n_j / 2
    plus the products lo_i hi_j, hi_i lo_j, hi_i hi_j of the bf16 terms,
    summed in float32 forward (the C operand first) or ``reverse`` (it last),
    or in ``float64`` and rounded once; a pair is re-ranked unless A < M_it
    (M in float64, at or above the kernel's rounded-down M, so no pair passes
    here that the kernel's rule would reject; the kernel re-ranks both
    columns of a lane's pair when either passes, a superset of these); each
    row's exact list of k
    keys, its threshold after each tile (the kernel's, updated when it
    flushes its queue, may be staler and only admits more), its count, the
    rows past ``cap`` or unbounded.
    Returns (re-ranked pairs (n, n) bool, listed rows (n,) bool, lists
    (n, k) uint64, counts (n,) int)."""
    n, dp = xp.shape
    c, a = tknn._k12_filter_constants(dp)
    keys = _plain_keys(xp)
    hi = _bf16_rn(xc)
    with np.errstate(invalid="ignore", over="ignore"):
        lo = _bf16_rn((xc - hi).astype(np.float32))
    ranked = np.zeros((n, n), bool)
    listed = np.isnan(norms)
    counts = np.zeros(n, np.int64)
    lists = np.full((n, k), np.iinfo(np.uint64).max, np.uint64)
    rows = np.arange(n)
    ni = norms.astype(np.float64)
    tile = tknn._k12_tile_cols(dp)
    for t0 in range(0, n, tile):
        cols = np.arange(t0, min(t0 + tile, n))
        hneg = (np.float32(-0.5) * norms[cols]).astype(np.float32)
        nmax = 0.0 if np.all(np.isnan(norms[cols])) else float(np.nanmax(norms[cols]))
        with np.errstate(invalid="ignore", over="ignore"):
            prods = [(lo[:, None, e] * hi[None, cols, e], hi[:, None, e] * lo[None, cols, e],
                      hi[:, None, e] * hi[None, cols, e]) for e in range(dp)]
            if order == "float64":
                acc = np.broadcast_to(hneg.astype(np.float64), (n, len(cols))).copy()
                for trio in prods:
                    for p in trio:
                        acc += p.astype(np.float64)
                acc = acc.astype(np.float32)
            elif order == "forward":
                acc = np.broadcast_to(hneg, (n, len(cols))).astype(np.float32)
                for trio in prods:
                    for p in trio:
                        acc = (acc + p).astype(np.float32)
            else:
                acc = np.zeros((n, len(cols)), np.float32)
                for trio in prods[::-1]:
                    for p in trio[::-1]:
                        acc = (acc + p).astype(np.float32)
                acc = (acc + hneg).astype(np.float32)
            delta = c * (ni + nmax) + a
            m = (ni - delta - _threshold(lists[:, -1])) / 2
            cand = ~(acc.astype(np.float64) < m[:, None])
        cand &= ~listed[:, None] & (cols[None, :] != rows[:, None])
        ranked[:, cols] |= cand
        counts += cand.sum(axis=1)
        merged = np.concatenate([lists, np.where(cand, keys[:, cols], np.iinfo(np.uint64).max)], axis=1)
        lists = np.sort(merged, axis=1)[:, :k]
        listed |= counts > cap
    return ranked, listed, lists, counts


class _EmulatedK12:
    """K12's C interface in numpy. ``sqt_feature_knn``, the exact route:
    float32 difference-form d2 over the padded columns in order, keys (bits
    << 32 | index), the row excluded; every row, or the listed rows.
    ``sqt_feature_knn_filter``: :func:`_filter_emulation` on the wrapper's
    centred rows and norms; the finished rows' outputs and counts, the
    listed rows in a shuffled order (as atomics leave them), and for k above
    64 the lists in the scratch rows, all ones at the listed rows."""

    def __init__(self, seed: int = 0) -> None:
        self.calls = []
        self.rng = np.random.default_rng(seed)
        self.filtered = None

    @staticmethod
    def _write(keys, rows, k, n, out_d, out_i):
        od = _view(out_d, np.float32, n * k).reshape(n, k)
        oi = _view(out_i, np.int32, n * k).reshape(n, k)
        oi[rows] = (keys & np.uint64(0xFFFFFFFF)).astype(np.int32)
        with np.errstate(invalid="ignore"):
            od[rows] = np.sqrt((keys >> np.uint64(32)).astype(np.uint32).view(np.float32))

    def sqt_feature_knn(self, x, n, dp, k, rows, n_rows, scratch, out_d, out_i, stream):
        self.calls.append(("exact", dp, k, rows is not None))
        assert (dp <= 64 and dp % 8 == 0) or dp % 32 == 0
        take = np.arange(n) if rows is None else _view(rows, np.int32, n)[: _view(n_rows, np.int32, 1)[0]]
        if k > 32:
            assert np.all(_view(scratch, np.int64, n * k).reshape(n, k)[take] == -1)
        xs = _view(x, np.float32, n * dp).reshape(n, dp)
        best = np.sort(_plain_keys(xs)[take], axis=1)[:, :k]
        self._write(best, take, k, n, out_d, out_i)
        return 0

    def sqt_feature_knn_filter(self, x, xc, norms, n, dp, k, c, a, cap, lists, rows, n_rows, counts, out_d, out_i,
                               stream):
        self.calls.append(("filter", dp, k, lists is not None))
        assert dp <= 64 and dp % 8 == 0 and (c, a) == tknn._k12_filter_constants(dp)
        assert (lists is not None) == (k > 64)
        xs = _view(x, np.float32, n * dp).reshape(n, dp)
        xcs = _view(xc, np.float32, n * dp).reshape(n, dp)
        nrm = _view(norms, np.float32, n)
        ranked, listed, best, cnt = _filter_emulation(xs, xcs, nrm, k, cap)
        self.filtered = (ranked, listed, cnt)
        done = np.flatnonzero(~listed)
        self._write(best[done], done, k, n, out_d, out_i)
        _view(counts, np.int32, n)[:] = np.where(listed, -1, cnt)
        order = self.rng.permutation(np.flatnonzero(listed)).astype(np.int32)
        _view(rows, np.int32, n)[: len(order)] = order
        _view(n_rows, np.int32, 1)[0] = len(order)
        if lists is not None:
            lv = _view(lists, np.int64, n * k).reshape(n, k)
            lv[:] = np.where(listed[:, None], -1, best.view(np.int64))
        return 0


@pytest.fixture()
def emulated_k12(monkeypatch):
    emu = _EmulatedK12()
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "require", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setitem(_cuda.launches, "feature_knn", 0)
    return emu


@pytest.mark.parametrize(("d", "k"), [(3, 5), (16, 15), (50, 33), (70, 4)])
def test_k12_wrapper_emulated(emulated_k12, d, k):
    """The route by width (the filter up to 64 padded features, then the
    exact route on the listed rows; the exact route alone above), bitwise
    against the plain version."""
    x = torch.from_numpy(_features(300, d, 2))
    before = _cuda.launches["feature_knn"]
    got = tknn._feature_knn_k12(x, k)
    want = tknn._feature_knn_plain(x, k)
    dp = tknn._feature_pad(d)
    if dp <= 64:
        assert emulated_k12.calls == [("filter", dp, k, k > 64), ("exact", dp, k, True)]
    else:
        assert emulated_k12.calls == [("exact", dp, k, False)]
    assert _cuda.launches["feature_knn"] == before + len(emulated_k12.calls)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize(("case", "k", "cap"), [("nan", 7, 4096), ("ties", 5, 40), ("ties", 70, 40),
                                                ("offset", 33, 100), ("clusters", 66, 4096)])
def test_k12_wrapper_exact_route_rows(emulated_k12, case, k, cap):
    """Rows the filter cannot finish (an unbounded norm; re-ranked
    candidates past ``cap``) are listed and taken by the exact route; the
    outputs stay bitwise the plain version's, for k in registers, in shared
    lists and in the scratch rows."""
    rng = np.random.default_rng(11)
    if case == "nan":
        x = _features(300, 6, 3)
        x[4, 2], x[9, 0] = np.nan, np.inf
    elif case == "ties":
        x = rng.integers(0, 2, (300, 3)).astype(np.float32)  # ~37 copies of each row
    elif case == "offset":
        x = (np.where(rng.random((300, 1)) < 0.5, -1000.0, 1000.0) + rng.normal(0, 1e-3, (300, 5))).astype(np.float32)
    else:
        x = _features(300, 12, 4)
    xt = torch.from_numpy(x)
    stats = {}
    got = tknn._feature_knn_k12(xt, k, cap=cap, stats=stats)
    want = tknn._feature_knn_plain(xt, k)
    assert torch.equal(got[1], want[1]) and bool(((got[0] == want[0]) | (got[0].isnan() & want[0].isnan())).all())
    ranked, listed, counts = emulated_k12.filtered
    assert stats["route"] == "filter" and stats["exact_rows"] == int(listed.sum())
    if case == "clusters":
        assert stats["exact_rows"] == 0 and stats["candidates_max"] == counts.max()
    else:
        assert stats["exact_rows"] > 0
    if case == "nan":
        assert listed[4] and listed[9] and listed.sum() == 2


ADVERSARIAL = ["ties", "duplicates", "offset", "far_clusters", "ulp", "d1", "d16", "d50", "d256", "k40"]


def _adversarial(case: str) -> tuple[np.ndarray, int]:
    """Seeded inputs built to stress the filter's bound, and their k."""
    rng = np.random.default_rng(ADVERSARIAL.index(case))
    if case == "ties":  # exact ties: every d2 a small integer
        return rng.integers(0, 3, (400, 4)).astype(np.float32), 15
    if case == "duplicates":
        x = _features(400, 10, 1)
        x[rng.integers(0, 400, 150)] = x[rng.integers(0, 400, 150)]
        return x, 15
    if case == "offset":  # norms far above the gaps; the centring removes the offset
        return (1e4 + rng.normal(0, 1, (400, 16))).astype(np.float32), 15
    if case == "far_clusters":  # an offset the centring cannot remove
        sign = np.where(rng.random((400, 1)) < 0.5, -1.0, 1.0)
        return (sign * 1e3 + rng.normal(0, 1e-2, (400, 8))).astype(np.float32), 15
    if case == "ulp":  # row 0's d2 to rows 1..40 are consecutive integers in [2^23, 2^24): one ulp apart
        x = rng.uniform(-30000, 30000, (400, 4)).astype(np.float32)
        x[0] = 0.0
        for m in range(40):
            x[1 + 9 * m] = _four_squares(2**23 + 5000 + m)
        return x, 15
    if case == "k40":
        return _features(400, 16, 7), 40
    d = int(case[1:])
    return _features(200 if d == 256 else 400, d, 5), 15


def _four_squares(target: int) -> np.ndarray:
    """Four integers whose squares sum to ``target`` (every partial sum exact in float32)."""
    for a in range(int(np.sqrt(target)), 0, -1):
        for b in range(int(np.sqrt(target - a * a)), -1, -1):
            rest = target - a * a - b * b
            for c in range(int(np.sqrt(rest)), -1, -1):
                dd = int(np.sqrt(rest - c * c))
                if dd * dd == rest - c * c:
                    return np.array([a, b, c, dd], np.float32)
    raise AssertionError(target)


@pytest.mark.parametrize("order", ["forward", "reverse", "float64"])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_k12_filter_keeps_the_exact_top_k(case, order):
    """Every member of the plain version's top k is among the pairs the
    filter's rule re-ranks, so its lists equal the plain version's keys."""
    x, k = _adversarial(case)
    dp = tknn._feature_pad(x.shape[1])
    xp = np.zeros((x.shape[0], dp), np.float32)
    xp[:, : x.shape[1]] = x
    xc, norms = (t.numpy() for t in tknn._k12_centred(torch.from_numpy(xp)))
    ranked, listed, lists, counts = _filter_emulation(xp, xc, norms, k, cap=10**9, order=order)
    want = np.sort(_plain_keys(xp), axis=1)[:, :k]
    member = np.zeros_like(ranked)
    np.put_along_axis(member, (want & np.uint64(0xFFFFFFFF)).astype(np.int64), True, axis=1)
    assert not listed.any()
    assert np.all(ranked[member]), f"{int((member & ~ranked).sum())} members not re-ranked"
    np.testing.assert_array_equal(lists, want)
    if case == "ulp":
        d2 = (want[0] >> np.uint64(32)).astype(np.uint32).view(np.float32)
        assert d2[k - 1] == 2**23 + 5000 + k - 1 and np.nextafter(d2[k - 1], np.float32(np.inf)) == 2**23 + 5000 + k
    if case in ("d16", "d50", "k40"):
        assert counts.mean() < x.shape[0] / 2  # the rule filters


@pytest.mark.parametrize(("d", "seed"), [(16, 0), (50, 1)])
def test_knn_graph_equals_jax(d, seed):
    x = _features(1500, d, seed)
    it = tknn.feature_knn(torch.from_numpy(x), 15)[1].numpy()
    ij = jknn.brute_force_knn(x, 15)[1]
    assert all(set(a) == set(b) for a, b in zip(it, ij)), "fixture has a near tie at the 15th neighbour"
    at, aj = tcl.knn_graph(x, 15), jcl.knn_graph(x, 15)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(at, name), getattr(aj, name))
    np.testing.assert_array_equal(tcl.graph_cluster(x, 15, 0.7, 3), jcl.graph_cluster(x, 15, 0.7, 3))


def test_knn_graph_past_the_exact_search_raises(monkeypatch):
    """Past the exact search the graph comes from the IVF index, which no
    longer raises there; it still raises where the IVF does (k >= n), and on
    101 equal rows it links each row to 5 others."""
    monkeypatch.setattr(tcl, "_EXACT_KNN_MAX_N", 100)
    adj = tcl.knn_graph(np.zeros((101, 3), np.float32), 5)
    assert adj.shape == (101, 101) and (adj != adj.T).nnz == 0 and (np.diff(adj.indptr) >= 5).all()
    with pytest.raises(ValueError, match="n_neighs"):
        from squidpy_torch.ops.ivf_knn import ivf_knn

        ivf_knn(np.zeros((101, 3), np.float32), 101)


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "d", "k"), [(20_000, 16, 15), (5000, 50, 15), (3000, 100, 40), (2000, 256, 7)])
def test_k12_matches_plain_on_card(n, d, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K12 has no CPU mode")
    x = torch.from_numpy(_features(n, d, 4)).cuda()
    x[5] = x[9]
    got, want = tknn.feature_knn(x, k), tknn._feature_knn_plain(x, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
