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


class _EmulatedK17:
    """``sqt_cooccur_pairs`` in numpy, reading and writing CPU tensors through
    the pointers the wrapper passes: the difference-form d2 rounded per
    operation, the bucket by the float32 product's floor, its split and
    slot bin or the walk of the thresholds where the split is NaN, labels
    outside [0, C) counted nowhere, the first-bin histogram made cumulative.
    It checks the arguments as the C interface does and records the layout."""

    def __init__(self) -> None:
        self.layouts: list[tuple[int, int, int]] = []

    def sqt_cooccur_pairs(self, pts, labels, n, dim, thr, n_thr, n_cls, table, n_buckets, copies, row_tile, hist,
                          out, stream):
        assert n >= 2 and dim > 0 and n_thr > 0 and n_cls > 0 and 0 <= copies <= 8
        assert row_tile > 0 and 1024 % row_tile == 0 and 1024 <= n_buckets <= 4096
        self.layouts.append((copies, n_buckets, row_tile))
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
        with np.errstate(invalid="ignore", over="ignore"):  # inf - inf: NaN, as on the card
            diff = p[i, 0] - p[j, 0]
            d2 = diff * diff
            for a in range(1, dim):
                diff = p[i, a] - p[j, a]
                d2 = d2 + diff * diff
        ok = (lab[i] >= 0) & (lab[i] < n_cls) & (lab[j] >= 0) & (lab[j] < n_cls)
        d2 = np.where(ok, d2, np.float32(np.nan)).astype(np.float32)
        with np.errstate(invalid="ignore", over="ignore"):
            y = d2 * scale
        bucket = np.where(np.isfinite(y) & (y < n_buckets), np.floor(np.nan_to_num(y)), n_buckets).astype(np.int64)
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
    """The wrapper's layout and packed bucket table around the emulated
    kernel: the plain version's counts, bitwise, one launch counted."""
    p, lab = torch.from_numpy(pts), torch.from_numpy(labs)
    got = tco._cooccur_k17(p, lab, thr, n_cls)
    want = cooccur_block_pairs(p, lab, torch.from_numpy(thr), n_cls, 256)
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=name)
    assert _cuda.launches["cooccur_pairs"] == 1
    assert emulated.layouts == [tuple(tco._k17_layout(len(pts), pts.shape[1], len(thr), n_cls))]


def test_k17_walks_thresholds_within_a_bucket(emulated):
    """The fixture of that case does put pairs into buckets whose split is
    NaN (two distinct thresholds in one bucket), so the walk is exercised."""
    _, pts, labs, thr, n_cls = next(c for c in _k17_cases() if c[0] == "thresholds within a bucket")
    layout = tco._k17_layout(len(pts), 2, len(thr), n_cls)
    table = tco._k7_table(torch.from_numpy(thr), layout.n_buckets).numpy()
    split, scale = table[: layout.n_buckets + 1].view(np.float32), table[-1:].view(np.float32)[0]
    i, j = np.triu_indices(len(pts), 1)
    d2 = ((pts[i] - pts[j]) ** 2).sum(axis=1).astype(np.float32)
    bucket = np.minimum(np.floor(d2 * scale), layout.n_buckets).astype(np.int64)
    assert np.isnan(split).any() and (np.isnan(split[bucket]) & (d2 <= thr[-1])).sum() > 0


@pytest.mark.parametrize(("n", "dim", "n_thr", "n_cls", "want"), [
    (99_000, 2, 49, 16, (1, 1024, 256)),  # one 50 KB copy
    (99_000, 2, 49, 1, (8, 1024, 256)),  # a copy a warp
    (99_000, 2, 49, 5, (8, 1024, 256)),
    (99_000, 2, 49, 8, (4, 1024, 256)),
    (99_000, 2, 49, 32, (1, 1024, 256)),  # 200,704 bytes of counters beside the table and rows: inside the budget
    (99_000, 2, 49, 33, (0, 1024, 256)),  # past it: global atomics
    (99_000, 2, 49, 200, (0, 1024, 256)),
    (4_992, 2, 49, 16, (1, 1024, 32)),  # Visium: small row tiles, items enough for every SM
    (3_001, 3, 49, 5, (8, 1024, 32)),
    (20_000, 7, 600, 3, (1, 4096, 256)),
    (20_000, 2, 5000, 2, (1, 4096, 256)),  # more thresholds than buckets' quarters: the table stays 64 KB
])
def test_k17_layout(n, dim, n_thr, n_cls, want):
    got = tco._k17_layout(n, dim, n_thr, n_cls)
    assert tuple(got) == want
    fixed = (got.n_buckets + 1) * 16 + got.row_tile * ((dim if dim <= 3 else 0) + 1) * 4
    assert fixed + got.copies * n_thr * n_cls * n_cls * 4 <= tco._K17_SMEM_BYTES
    assert got.n_buckets & (got.n_buckets - 1) == 0 and got.n_buckets >= min(4 * n_thr, 4096)


@pytest.mark.parametrize("n_thr", [1, 49, 600])
def test_k17_table_packs_k7s(n_thr):
    """A row a bucket: K7's split bits and two slot bins, then a zero; the
    last row the scale."""
    thr = (np.linspace(0.0, 80.0, n_thr) ** 2).astype(np.float32)
    n_buckets = tco._k17_layout(1000, 2, n_thr, 4).n_buckets
    k7 = tco._k7_table(torch.from_numpy(thr), n_buckets).numpy()
    got = tco._k17_table(torch.from_numpy(thr), n_buckets).numpy()
    assert got.shape == (n_buckets + 2, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:-1, 0], k7[: n_buckets + 1])
    np.testing.assert_array_equal(got[:-1, 1:3].reshape(-1), k7[n_buckets + 1 : -1])
    np.testing.assert_array_equal(got[-1], [k7[-1], 0, 0, 0])
    assert not got[:-1, 3].any()


def test_k17_inputs_are_cached_per_support():
    thr = (np.linspace(1.0, 50.0, 49) ** 2).astype(np.float32)
    a = tco._k17_inputs(thr.tobytes(), 1024, "cpu")
    assert tco._k17_inputs(thr.tobytes(), 1024, "cpu") is a
    np.testing.assert_array_equal(a[0].numpy(), thr)
    np.testing.assert_array_equal(a[1].numpy(), tco._k17_table(torch.from_numpy(thr), 1024).numpy())


def test_cpu_counts_never_launch_k17(monkeypatch):
    monkeypatch.setattr(_cuda, "library", lambda: pytest.fail("a CPU call reached the CUDA build"))
    pts, labs, thr = _fixture(300, 2, 4, seed=1)
    co_occurrence_counts(pts, labs, thr, 4)
