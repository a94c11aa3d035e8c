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
scratch list for k above 32) runs here around a numpy emulation of its C
interface; the cuda-marked test holds the kernel to the plain version.
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


class _EmulatedK12:
    """``sqt_feature_knn`` in numpy: float32 difference-form d2 over the
    padded columns in order, keys (bits << 32 | index), the row excluded."""

    def __init__(self) -> None:
        self.calls = []

    def sqt_feature_knn(self, x, n, dp, k, scratch, out_d, out_i, stream):
        self.calls.append((dp, k, scratch is not None))
        assert (dp <= 64 and dp % 8 == 0) or dp % 32 == 0
        if k > 32:
            assert np.all(_view(scratch, np.int64, n * k) == -1)
        xs = _view(x, np.float32, n * dp).reshape(n, dp)
        d2 = np.zeros((n, n), np.float32)
        for e in range(dp):
            diff = xs[:, None, e] - xs[None, :, e]
            d2 = (d2 + diff * diff).astype(np.float32)
        keys = (d2.view(np.int32).astype(np.int64) << 32) | np.arange(n)
        np.fill_diagonal(keys, np.iinfo(np.int64).max)
        best = np.sort(keys, axis=1)[:, :k]
        _view(out_i, np.int32, n * k)[:] = (best & 0xFFFFFFFF).ravel()
        _view(out_d, np.float32, n * k)[:] = np.sqrt((best >> 32).astype(np.int32).view(np.float32)).ravel()
        return 0


@pytest.mark.parametrize(("d", "k"), [(3, 5), (16, 15), (50, 33), (70, 4)])
def test_k12_wrapper_emulated(monkeypatch, d, k):
    emu = _EmulatedK12()
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "require", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    x = torch.from_numpy(_features(300, d, 2))
    before = _cuda.launches["feature_knn"]
    got = tknn._feature_knn_k12(x, k)
    want = tknn._feature_knn_plain(x, k)
    assert emu.calls == [(tknn._feature_pad(d), k, k > 32)] and _cuda.launches["feature_knn"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    monkeypatch.setattr(tcl, "_EXACT_KNN_MAX_N", 100)
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        tcl.knn_graph(np.zeros((101, 3), np.float32), 5)


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "d", "k"), [(20_000, 16, 15), (5000, 50, 15), (3000, 100, 40), (2000, 256, 7)])
def test_k12_matches_plain_on_card(n, d, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K12 has no CPU mode")
    x = torch.from_numpy(_features(n, d, 4)).cuda()
    x[5] = x[9]
    got, want = tknn.feature_knn(x, k), tknn._feature_knn_plain(x, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
