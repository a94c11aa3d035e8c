"""co_occurrence's dense sweep below 100k points: the plain version against
squidpy_tpu, and kernel K17's wrapper around a numpy emulation of its C
interface.

Tolerances: every count is an integer and is compared bitwise. The JAX
package rounds d2 as XLA:CPU contracts it, so the fixtures are asserted free
of pairs whose d2 lies within a relative 1e-5 of a threshold (2-D also by
``_straddling``, which replays both roundings).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch
from test_torch_cooccur import _straddling
from test_torch_cooccur_card import _k17_cases

import squidpy_torch as sqt
from squidpy_torch import _cuda
from squidpy_torch.ops import cooccur as tco
from squidpy_torch.ops.cooccur import co_occurrence_counts, cooccur_block_pairs, cooccur_pairs
from squidpy_tpu.ops.cooccur import co_occurrence_counts as jax_co_occurrence_counts

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _exact_d2(pts: np.ndarray) -> np.ndarray:
    """Every pair's d2 in float64 (exact for float32 inputs up to rounding
    far below float32's), sorted."""
    p = np.asarray(pts, np.float64)
    i, j = np.triu_indices(len(p), 1)
    return np.sort(((p[i] - p[j]) ** 2).sum(axis=1))


def _near_threshold(pts: np.ndarray, thr: np.ndarray, rel: float = 1e-6) -> int:
    """Pairs i < j whose exact d2 lies within ``rel`` of a threshold: any
    float32 rounding of a sum of at most three squares is off by less (about
    (d + 2) x 6e-8), so both packages put such a fixture's pairs in the same bins."""
    d2 = _exact_d2(pts)
    t = np.asarray(thr, np.float64)
    lo, hi = np.searchsorted(d2, t * (1 - rel)), np.searchsorted(d2, t * (1 + rel), side="right")
    return int((hi - lo).sum())


def _gapped_thresholds(pts: np.ndarray, targets: np.ndarray, window: int = 64) -> np.ndarray:
    """Thresholds near ``targets``: each the middle of the widest gap between
    the sorted exact d2 of the pairs among the ``window`` nearest the target
    on either side, in float32. The points stay uniform; the thresholds avoid them."""
    d2 = _exact_d2(pts)
    out = []
    for t in targets:
        k = int(np.searchsorted(d2, t))
        seg = d2[max(k - window, 0) : k + window]
        g = int(np.argmax(np.diff(seg)))
        out.append((seg[g] + seg[g + 1]) / 2)
    return np.asarray(out, np.float32)


def _fixture(n: int, dim: int, n_cls: int, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10 * np.sqrt(n), (n, dim)).astype(np.float32)
    labs = rng.integers(-1, n_cls, n).astype(np.int32)  # -1: a NaN cell, counted nowhere
    thr = _gapped_thresholds(pts, np.linspace(2.0, 6.0 * np.sqrt(n), 49) ** 2)
    return pts, labs, thr


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_cls", [1, 5, 40])
def test_dense_counts_match_jax(dim, n_cls):
    """The port's dense counts (the plain version on the CPU) against JAX's
    dense sweep, bitwise, on fixtures with no pair near a threshold."""
    pts, labs, thr = _fixture(1200, dim, n_cls, seed=10 * dim + n_cls)
    assert _near_threshold(pts, thr) == 0
    if dim == 2:
        assert not _straddling(pts, thr)
    got = co_occurrence_counts(pts, labs, thr, n_cls, method="dense")
    want = jax_co_occurrence_counts(pts, labs, thr, n_cls, method="dense")
    assert got.dtype == want.dtype == np.float64 and got.shape == (n_cls, n_cls, 49)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0 and (labs < 0).any()


def test_dense_counts_small_tiles_and_unsorted_thresholds():
    """Row tiles smaller than the input, and thresholds given out of order:
    each threshold's counts in its given place."""
    pts, labs, thr = _fixture(700, 2, 6, seed=3)
    want = cooccur_block_pairs(torch.from_numpy(pts), torch.from_numpy(labs), torch.from_numpy(thr), 6, 2048)
    order = np.random.default_rng(0).permutation(len(thr))
    got = cooccur_pairs(torch.from_numpy(pts), torch.from_numpy(labs), thr[order], 6, tile=64)
    np.testing.assert_array_equal(got.numpy(), want.numpy()[order])


# ------------------------------------------------------------------ K17's wrapper around an emulation


def _view(ptr: int, dtype: np.dtype, count: int) -> np.ndarray:
    """A writable numpy view of ``count`` items at a tensor's ``data_ptr``."""
    if not count:
        return np.zeros(0, dtype)
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * (count * itemsize)).from_address(ptr), dtype=dtype)


def _d2(p: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The difference-form d2 of pairs (i, j) in float32, rounded per operation."""
    with np.errstate(invalid="ignore", over="ignore"):  # inf - inf: NaN, as on the card
        diff = p[i, 0] - p[j, 0]
        d2 = diff * diff
        for a in range(1, p.shape[1]):
            diff = p[i, a] - p[j, a]
            d2 = d2 + diff * diff
    return d2.astype(np.float32)


def _bucket(d2: np.ndarray, scale: np.float32, n_buckets: int) -> np.ndarray:
    """The kernel's bucket: the floor of float32(d2 * scale), the top bucket
    for anything past it, inf or NaN."""
    with np.errstate(invalid="ignore", over="ignore"):
        y = (d2 * scale).astype(np.float32)
    return np.where(np.isfinite(y) & (y < n_buckets), np.floor(np.nan_to_num(y)), n_buckets).astype(np.int64)


def _lane_bins(d2: np.ndarray, bins: np.ndarray, thr_rep: np.ndarray, first: np.ndarray, scale: np.float32,
               n_buckets: int, lanes: np.ndarray, tab: int) -> np.ndarray:
    """The class route's bin of each d2, read from ``lanes``' copies of the
    tables: ``e - (thr[e - 1] >= d2)``, less ``(thr[e - 2] >= d2)`` where
    ``tab`` is 2 or more, and the walk from the bucket's first threshold
    where e is the junk bin L + 1. L: counted nowhere."""
    n_thr = thr_rep.shape[0] - 3
    b = _bucket(d2, scale, n_buckets)
    e = bins.reshape(-1, 32, 4)[b // 4, lanes, b % 4].astype(np.int64)
    with np.errstate(invalid="ignore"):
        k = e - (thr_rep[e + 1, lanes] >= d2)
        if tab >= 2:
            k -= thr_rep[e, lanes] >= d2
    junk = np.flatnonzero(e == n_thr + 1)
    assert tab == 3 or not junk.size
    for w in junk:
        kk = int(first[b[w]])
        while kk < n_thr and not thr_rep[kk + 2, lanes[w]] >= d2[w]:
            kk += 1
        k[w] = kk
    return k


def _scratch_words(n: int, dim: int, n_thr: int, n_cls: int, row_tile: int) -> int:
    """The C interface's own count of the class route's scratch words."""
    max_rt, max_ct = -(-n // row_tile) + n_cls, -(-n // 1024) + n_cls
    return (2 * max_rt + 2 * max_ct + 4 + max_rt + 1 + n_thr * n_cls * n_cls + (n_cls + 2) // 2 + (n + 1) // 2
            + (n * dim + 1) // 2)


class _EmulatedK17:
    """Both routes of ``csrc/cooccur_pairs.cu`` in numpy, reading and writing
    CPU tensors through the pointers the wrapper passes, checking the
    arguments as the C interface does and recording the layouts.

    ``sqt_cooccur_pairs`` (the class route): the counting sort into class
    order (within a class the warps' atomics leave any order, so each class
    is shuffled here), the column and row tiles and each row tile's items as
    the one-block kernel lists them (its closed form of a class's items held
    to the count), then one block taking the items in order: a pair's bin
    from the lane's copies of the tables, its lane's (a, b) or (b, a)
    counter by the original indices, and the flushes when the class pair
    changes or every ``flush_every`` items, no counter passing 32 bits.
    ``sqt_cooccur_pairs_index`` (the index route): every pair i < j, its first
    bin from the 16-byte bucket table or the walk, labels outside [0, C)
    counted nowhere."""

    def __init__(self, seed: int = 0) -> None:
        self.layouts: list[tuple] = []
        self.rng = np.random.default_rng(seed)
        self.largest = 0  # the largest counter any flush found
        self.flushes = 0
        self.tabs: list[int] = []  # the class route's table variant a call

    def sqt_cooccur_pairs(self, pts, labels, n, dim, n_thr, n_cls, bins, thr_rep, first, scale, n_buckets, tab,
                          row_tile, mode, scratch, scratch_words, out, stream):
        assert n >= 2 and dim > 0 and 0 < n_thr <= 254 and n_cls > 0 and n_buckets % 4 == 0 and mode == 0
        assert row_tile > 0 and 1024 % row_tile == 0 and bins % 4 == 0 and scratch % 16 == 0
        assert scratch_words >= _scratch_words(n, dim, n_thr, n_cls, row_tile)
        assert not _view(scratch, np.int64, scratch_words).any()  # zeroed
        self.layouts.append(("class", 0, n_buckets, row_tile))
        p = _view(pts, np.float32, n * dim).reshape(n, dim)
        lab = _view(labels, np.int32, n)
        rep = _view(bins, np.uint8, (n_buckets // 4 + 1) * 128).reshape(-1, 32, 4)
        trep = _view(thr_rep, np.float32, (n_thr + 3) * 32).reshape(n_thr + 3, 32)
        assert (rep == rep[:, :1]).all() and (trep == trep[:, :1]).all()  # one copy a lane
        assert np.isneginf(trep[[0, 1, -1]]).all() and (np.diff(trep[2:-1, 0]) > 0).all()  # distinct, ascending
        fst = _view(first, np.int32, n_buckets + 1)
        assert tab in (1, 2, 3) and (tab == 3) == (rep == n_thr + 1).any()  # the walk's variant where a bucket needs it
        self.tabs.append(tab)

        # the class order; a label outside [0, C) drops out
        key = np.where((lab >= 0) & (lab < n_cls), lab, -1)
        order = np.concatenate([self.rng.permutation(np.flatnonzero(key == c)) for c in range(n_cls)]).astype(np.int64)
        starts = np.r_[0, np.cumsum(np.bincount(key[key >= 0], minlength=n_cls))]
        sp, orig = p[order], order
        # the tiles and items, as the one-block kernel lists them
        per_col = 1024 // row_tile
        col_tiles, col_start = [], []
        for c in range(n_cls):
            col_start.append(len(col_tiles))
            col_tiles += [(c0, min(c0 + 1024, starts[c + 1]), c) for c0 in range(starts[c], starts[c + 1], 1024)]
        items = []
        for c in range(n_cls):
            rt = -(-(starts[c + 1] - starts[c]) // row_tile)
            q, r = divmod(rt, per_col)
            closed = rt * (len(col_tiles) - col_start[c]) - (per_col * q * (q - 1) // 2 + r * q)
            before = len(items)
            for t in range(rt):
                row0 = starts[c] + t * row_tile
                items += [((row0, min(row0 + row_tile, starts[c + 1]), c), col_tiles[ct])
                          for ct in range(col_start[c] + t // per_col, len(col_tiles))]
            assert len(items) - before == closed

        # one block takes the items in order
        flush_every = 0xFFFFFFFF // (8 * row_tile * 4)
        lo, hi = np.zeros((n_thr, 32), np.int64), np.zeros((n_thr, 32), np.int64)
        hist = np.zeros((n_thr, n_cls, n_cls), np.int64)
        cur, since = None, 0

        def flush(pair):
            self.largest = max(self.largest, int(lo.max()), int(hi.max()))
            assert lo.max() <= 0xFFFFFFFF and hi.max() <= 0xFFFFFFFF
            hist[:, pair[0], pair[1]] += lo.sum(axis=1)
            hist[:, pair[1], pair[0]] += hi.sum(axis=1)
            lo[:], hi[:] = 0, 0
            self.flushes += 1

        for (row0, row_end, ca), (col0, col_end, cb) in items:
            if (ca, cb) != cur or since == flush_every:
                if cur is not None:
                    flush(cur)
                cur, since = (ca, cb), 0
            since += 1
            i, j = np.meshgrid(np.arange(row0, row_end), np.arange(col0, col_end), indexing="ij")
            i, j = i.ravel(), j.ravel()
            if ca == cb:
                i, j = i[i < j], j[i < j]
            lanes = (j - col0) % 32
            k = _lane_bins(_d2(sp, i, j), rep, trep, fst, np.float32(scale), n_buckets, lanes, tab)
            up = orig[i] > orig[j]  # the (b, a) half
            keep = k < n_thr
            np.add.at(lo, (k[keep & ~up], lanes[keep & ~up]), 1)
            np.add.at(hi, (k[keep & up], lanes[keep & up]), 1)
        if cur is not None:
            flush(cur)
        _view(out, np.int64, n_thr * n_cls * n_cls)[:] = np.cumsum(hist, axis=0).reshape(-1)
        return 0

    def sqt_cooccur_pairs_index(self, pts, labels, n, dim, thr, n_thr, n_cls, table, n_buckets, copies, row_tile,
                                mode, hist, out, stream):
        assert n >= 2 and dim > 0 and n_thr > 0 and n_cls > 0 and 0 <= copies <= 8 and mode == 0
        assert row_tile > 0 and 1024 % row_tile == 0 and 1024 <= n_buckets <= 4096
        self.layouts.append(("index", copies, n_buckets, row_tile))
        cc = n_cls * n_cls
        assert not _view(hist, np.int64, n_thr * cc + 1).any()  # zeroed, the work counter last
        p = _view(pts, np.float32, n * dim).reshape(n, dim)
        lab = _view(labels, np.int32, n)
        t = _view(thr, np.float32, n_thr)
        assert table % 16 == 0  # one 16-byte load a bucket
        tab = _view(table, np.int32, 4 * (n_buckets + 2)).reshape(n_buckets + 2, 4)
        split, bins, scale = tab[: n_buckets + 1, 0].view(np.float32), tab[: n_buckets + 1, 1:3], tab[-1, :1].view(
            np.float32)[0]
        i, j = np.triu_indices(n, 1)
        d2 = _d2(p, i, j)
        ok = (lab[i] >= 0) & (lab[i] < n_cls) & (lab[j] >= 0) & (lab[j] < n_cls)
        d2 = np.where(ok, d2, np.float32(np.nan)).astype(np.float32)
        bucket = _bucket(d2, scale, n_buckets)
        sp = split[bucket]
        with np.errstate(invalid="ignore"):
            k = np.where(d2 <= sp, bins[bucket, 0], bins[bucket, 1]).astype(np.int64)
            walk = np.flatnonzero(np.isnan(sp) & (d2 <= t[-1]))
        for w in walk:
            k[w] = bins[bucket[w], 0]
            while t[k[w]] < d2[w]:
                k[w] += 1
        use = k >= 0
        first = np.bincount(k[use] * cc + lab[i][use] * n_cls + lab[j][use], minlength=n_thr * cc)
        _view(out, np.int64, n_thr * cc)[:] = np.cumsum(first.reshape(n_thr, cc), axis=0).reshape(-1)
        return 0


@pytest.fixture
def emulated(monkeypatch) -> _EmulatedK17:
    emu = _EmulatedK17()
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setitem(_cuda.launches, "cooccur_pairs", 0)
    return emu


@pytest.mark.parametrize("name,pts,labs,thr,n_cls", _k17_cases(), ids=[c[0] for c in _k17_cases()])
def test_k17_wrapper_matches_plain(name, pts, labs, thr, n_cls, emulated):
    """The wrapper's layout and tables around the emulated kernel: the plain
    version's counts, bitwise, one launch counted."""
    p, lab = torch.from_numpy(pts), torch.from_numpy(labs)
    got = tco._cooccur_k17(p, lab, thr, n_cls)
    want = cooccur_block_pairs(p, lab, torch.from_numpy(thr), n_cls, 256)
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=name)
    assert _cuda.launches["cooccur_pairs"] == 1
    assert emulated.layouts == [tuple(tco._k17_layout(len(pts), pts.shape[1], len(thr), n_cls))]


@pytest.mark.parametrize("name,pts,labs,thr,n_cls", _k17_cases(), ids=[c[0] for c in _k17_cases()])
def test_k17_index_route_matches_plain(name, pts, labs, thr, n_cls, emulated):
    """The index route (the earlier design), forced on every case: bitwise."""
    p, lab = torch.from_numpy(pts), torch.from_numpy(labs)
    layout = tco._k17_index_layout(len(pts), pts.shape[1], len(thr), n_cls)
    got = tco._cooccur_k17(p, lab, thr, n_cls, layout=layout)
    want = cooccur_block_pairs(p, lab, torch.from_numpy(thr), n_cls, 256)
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=name)
    assert emulated.layouts == [tuple(layout)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_k17_class_order_within_a_class_is_free(seed, monkeypatch):
    """The class route's counts do not depend on the order the atomics leave
    within a class: three shuffles, on labels that the order reverses."""
    emu = _EmulatedK17(seed)
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setitem(_cuda.launches, "cooccur_pairs", 0)
    _, pts, labs, thr, n_cls = next(c for c in _k17_cases() if c[0] == "labels descending with the index")
    p, lab = torch.from_numpy(pts), torch.from_numpy(labs)
    got = tco._cooccur_k17(p, lab, thr, n_cls)
    want = cooccur_block_pairs(p, lab, torch.from_numpy(thr), n_cls, 256)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert emu.layouts[0][0] == "class"


def test_k17_flushes_on_each_class_pair(emulated):
    """One block takes the items in order and flushes when the class pair
    changes: at C = 3 with one class past a column tile, once for each of
    the 6 pairs (a, b), a <= b, whose items follow one another, and more
    where a row tile's items run on into the next class."""
    _, pts, labs, thr, n_cls = next(c for c in _k17_cases() if c[0] == "a class past a column tile")
    p, lab = torch.from_numpy(pts), torch.from_numpy(labs)
    got = tco._cooccur_k17(p, lab, thr, n_cls)
    np.testing.assert_array_equal(got.numpy(), cooccur_block_pairs(p, lab, torch.from_numpy(thr), n_cls, 256).numpy())
    assert emulated.flushes >= 6 and 0 < emulated.largest < 2**32


def test_k17_walks_thresholds_within_a_bucket(emulated):
    """The fixtures of those cases do put pairs into buckets holding two
    thresholds (the second compare) and three (the junk bin: the walk), so
    both variants of the class route run."""
    for case, tab in (("thresholds within a bucket", 2), ("three thresholds within a bucket", 3)):
        _, pts, labs, thr, n_cls = next(c for c in _k17_cases() if c[0] == case)
        layout = tco._k17_layout(len(pts), 2, len(thr), n_cls)
        assert layout.route == "class"
        bins, _, first, scale, got_tab = tco._k17_lane_tables(thr, layout.n_buckets)
        assert got_tab == tab
        i, j = np.triu_indices(len(pts), 1)
        b = _bucket(_d2(pts, i, j), scale, layout.n_buckets)
        e = bins.reshape(-1, 32, 4)[b // 4, 0, b % 4].astype(np.int64)
        held = e - first[b]  # the thresholds inside each pair's bucket, where it is not the junk bin
        assert ((e == len(thr) + 1) if tab == 3 else (held == 2)).sum() > 0
        tco._cooccur_k17(torch.from_numpy(pts), torch.from_numpy(labs), thr, n_cls)
    assert emulated.tabs == [2, 3]


def _edge_thresholds() -> list[np.ndarray]:
    rng = np.random.default_rng(9)
    lin = (np.linspace(1.0, 60.0, 49) ** 2).astype(np.float32)
    return [
        lin,
        np.float32([0, 0, 25, 25, 25, 100, 100, 400, 3000]),
        np.sort(rng.uniform(0, 3600, 254)).astype(np.float32),
        np.float32([0.0, 0.0, 1.0, 400.0]),
        np.float32([5.0]),
        np.sort(np.r_[lin, lin[20] + np.float32(1e-3), np.nextafter(lin[30], np.float32(np.inf))]).astype(np.float32),
        np.float32([0.0]),
        np.float32([1.0, np.inf]),
        np.sort(np.r_[lin, lin[20] + np.float32(1e-3), lin[20] + np.float32(2e-3)]).astype(np.float32),
        np.r_[np.sort(rng.uniform(0, 1, 40)), 3600.0].astype(np.float32),  # forty thresholds in the first bucket
    ]


@pytest.mark.parametrize("case", range(len(_edge_thresholds())))
def test_k17_lane_tables_rule(case):
    """The class route's bin rule on its tables is searchsorted's first
    threshold with d2 <= thr (L where none) over the distinct thresholds the
    wrapper passes, for every threshold, its neighbouring floats, each
    bucket's edges, 0, inf and NaN, on every lane, by the table's variant."""
    thr = np.unique(_edge_thresholds()[case])
    bins, thr_rep, first, scale, tab = tco._k17_lane_tables(thr, 1024)
    assert bins.shape == (257 * 128,) and thr_rep.shape == ((len(thr) + 3) * 32,) and first.shape == (1025,)
    _, lo, hi = tco._bucket_bounds(thr, 1024)
    rng = np.random.default_rng(case)
    with np.errstate(over="ignore", invalid="ignore"):
        d2 = np.r_[thr, np.nextafter(thr, np.float32(np.inf)), np.nextafter(thr, np.float32(0)), lo, hi[:-1],
                   np.nextafter(lo, np.float32(0)), rng.uniform(0, 1.3 * max(float(thr[np.isfinite(thr)][-1]), 1.0), 20_000),
                   [0.0, np.inf, np.nan]].astype(np.float32)
    d2 = d2[~(d2 < 0)]
    want = np.searchsorted(thr, d2, side="left")
    want[np.isnan(d2)] = len(thr)
    for lane in (0, 13, 31):
        got = _lane_bins(d2, bins, thr_rep.reshape(-1, 32), first, scale, 1024, np.full(len(d2), lane), tab)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(("n", "dim", "n_thr", "n_cls", "want"), [
    (99_000, 2, 49, 16, ("class", 0, 1024, 256)),  # h1's section
    (99_000, 2, 49, 1, ("class", 0, 1024, 256)),
    (99_000, 2, 49, 200, ("class", 0, 1024, 256)),  # a shared route at any C: the counters do not grow with it
    (99_000, 2, 49, 4000, ("class", 0, 1024, 256)),
    (4_992, 2, 49, 16, ("class", 0, 1024, 32)),  # Visium: small row tiles
    (3_001, 3, 49, 5, ("class", 0, 1024, 32)),
    (99_000, 5, 100, 40, ("class", 0, 1024, 256)),
    (30_000, 2, 254, 4, ("class", 0, 1024, 256)),  # the largest L a bucket's byte holds
    (30_000, 2, 255, 4, ("index", 4, 1024, 256)),  # past it: the index route, copies of (L, C, C)
    (20_000, 7, 600, 3, ("index", 1, 4096, 256)),
    (20_000, 2, 5000, 2, ("index", 1, 4096, 256)),  # more thresholds than buckets' quarters: the table stays 64 KB
    (30_000, 2, 3000, 4, ("index", 0, 4096, 256)),  # one copy does not fit: global atomics
])
def test_k17_layout(n, dim, n_thr, n_cls, want):
    got = tco._k17_layout(n, dim, n_thr, n_cls)
    assert tuple(got) == want
    if got.route == "class":
        assert tco._k17_class_smem(dim, n_thr, got.row_tile) <= tco._K17_SMEM_BYTES
    else:
        fixed = (got.n_buckets + 1) * 16 + got.row_tile * ((dim if dim <= 3 else 0) + 1) * 4
        assert fixed + got.copies * n_thr * n_cls * n_cls * 4 <= tco._K17_SMEM_BYTES
        assert got.n_buckets >= min(4 * n_thr, 4096)
    assert got.n_buckets & (got.n_buckets - 1) == 0


@pytest.mark.parametrize("n_thr", [1, 49, 600])
def test_k17_table_packs_k7s(n_thr):
    """The index route's table, a row a bucket: K7's split bits and two slot
    bins, then a zero; the last row the scale."""
    thr = (np.linspace(0.0, 80.0, n_thr) ** 2).astype(np.float32)
    n_buckets = tco._k17_index_layout(1000, 2, n_thr, 4).n_buckets
    k7 = tco._k7_table(torch.from_numpy(thr), n_buckets).numpy()
    got = tco._k17_table(torch.from_numpy(thr), n_buckets).numpy()
    assert got.shape == (n_buckets + 2, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:-1, 0], k7[: n_buckets + 1])
    np.testing.assert_array_equal(got[:-1, 1:3].reshape(-1), k7[n_buckets + 1 : -1])
    np.testing.assert_array_equal(got[-1], [k7[-1], 0, 0, 0])
    assert not got[:-1, 3].any()


def test_k17_bucket_bounds_match_k7s():
    """Each bucket's least d2 is K7's: a d2 takes the bucket whose least is
    the largest at or below it, on the kernel's float32 product."""
    thr = (np.linspace(1.0, 60.0, 49) ** 2).astype(np.float32)
    scale, lo, hi = tco._bucket_bounds(thr, 1024)
    assert scale == np.float32(1024) / thr[-1]
    for b in (1, 2, 511, 1023, 1024):
        assert _bucket(lo[b : b + 1], scale, 1024)[0] == b
        assert _bucket(np.nextafter(lo[b : b + 1], np.float32(0)), scale, 1024)[0] == b - 1
    assert np.isinf(hi[-1]) and (hi[:-1] < lo[1:]).all()


def test_k17_inputs_are_cached_per_support():
    thr = (np.linspace(1.0, 50.0, 49) ** 2).astype(np.float32)
    a = tco._k17_inputs(thr.tobytes(), 1024, "cpu")
    assert tco._k17_inputs(thr.tobytes(), 1024, "cpu") is a
    np.testing.assert_array_equal(a[0].numpy(), thr)
    np.testing.assert_array_equal(a[1].numpy(), tco._k17_table(torch.from_numpy(thr), 1024).numpy())
    b = tco._k17_lane_inputs(thr.tobytes(), 1024, "cpu")
    assert tco._k17_lane_inputs(thr.tobytes(), 1024, "cpu") is b and b[-1] is None
    for got, want in zip(b, tco._k17_lane_tables(thr, 1024)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    repeated = np.sort(np.r_[thr, thr[[3, 3, 40]]]).astype(np.float32)
    c = tco._k17_lane_inputs(repeated.tobytes(), 1024, "cpu")
    np.testing.assert_array_equal(c[1].numpy(), b[1].numpy())  # the distinct values' tables
    np.testing.assert_array_equal(thr[c[-1].numpy()], repeated)


def test_cpu_counts_never_launch_k17(monkeypatch):
    monkeypatch.setattr(_cuda, "library", lambda: pytest.fail("a CPU call reached the CUDA build"))
    pts, labs, thr = _fixture(300, 2, 4, seed=1)
    co_occurrence_counts(pts, labs, thr, 4)
