"""squidpy_torch co-occurrence and the whole slice against squidpy_tpu.

Tolerances: counts are bitwise equal; probabilities and z-scores are equal
(the same float64 numpy arithmetic on equal integers); brute-force kNN
distances rtol 1e-6.

One known difference, named by ``test_knife_edge_pair_is_the_only_difference``:
the port rounds d2 = dx*dx + dy*dy once per operation (the plain torch
version and kernel K1 alike), while XLA on the CPU fuses one product into
an FMA. A pair whose two d2 straddle a threshold is counted by one package
and not the other. The bitwise tests use fixtures with no such pair
(asserted); the named test holds the difference to exactly that pair.

The chained slice runs at n = 3000, below the cipher threshold; its shuffles
are bitwise equal because no column's threefry sort words tie (asserted).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch._core.rng import random_bits, spawn_keys
from squidpy_torch.ops.cooccur import co_occurrence_counts
from squidpy_tpu.ops.cooccur import co_occurrence_counts as jax_co_occurrence_counts

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _straddling(pts: np.ndarray, thr: np.ndarray) -> list[tuple[int, int, int, float, float]]:
    """Pairs i < j whose f32 d2, rounded per operation (the port) and as
    XLA:CPU contracts it, fma(dx, dx, dy*dy), fall on opposite sides of a
    threshold r: ``(i, j, r, port d2, contracted d2)``. ``thr`` ascends."""
    p = np.asarray(pts, np.float32)
    t = np.asarray(thr, np.float32)
    reach = float(np.sqrt(t.max())) * 1.001 + 1e-3
    i, j = cKDTree(p.astype(np.float64)).query_pairs(reach, output_type="ndarray").T
    dx, dy = p[i, 0] - p[j, 0], p[i, 1] - p[j, 1]
    sep = dx * dx + dy * dy
    fused = (dx.astype(np.float64) ** 2 + (dy * dy).astype(np.float64)).astype(np.float32)
    r_sep, r_fused = np.searchsorted(t, sep), np.searchsorted(t, fused)  # first r with d2 <= thr[r]
    out = []
    for h in np.flatnonzero(r_sep != r_fused):
        for r in range(min(r_sep[h], r_fused[h]), max(r_sep[h], r_fused[h])):
            out.append((int(min(i[h], j[h])), int(max(i[h], j[h])), r, float(sep[h]), float(fused[h])))
    return sorted(out, key=lambda e: (e[2], e[0], e[1]))


def _default_thresholds(pts: np.ndarray, num: int) -> np.ndarray:
    from squidpy_torch.gr._ppatterns import _find_min_max

    lo, hi = _find_min_max(np.asarray(pts, np.float32))
    interval = np.linspace(lo, hi, num=num, dtype=np.float32)
    return (interval[1:].astype(np.float64) ** 2).astype(np.float32)


def _adata(n: int, n_cls: int, seed: int) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    adata = sq.AnnData(
        X=np.zeros((n, 1)),
        obs=pd.DataFrame({"cl": pd.Categorical.from_codes(rng.integers(0, n_cls, n), [f"c{i}" for i in range(n_cls)])},
                         index=[str(i) for i in range(n)]),
        var=pd.DataFrame(index=["g"]),
    )
    adata.obsm["spatial"] = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    return adata


@pytest.mark.parametrize("interval", [50, "explicit"])
def test_co_occurrence_dense_matches_jax(interval):
    adata = _adata(2000, 5, seed=2)
    if interval == "explicit":
        interval = np.array([40.0, 5.0, 12.5, 0.0, 90.0])  # unsorted on purpose
        thr = (np.sort(interval)[1:] ** 2).astype(np.float32)
    else:
        thr = _default_thresholds(adata.obsm["spatial"], interval)
    assert not _straddling(adata.obsm["spatial"], thr)
    occ_t, int_t = sqt.gr.co_occurrence(adata, "cl", interval=interval, copy=True)
    occ_j, int_j = sq.gr.co_occurrence(adata, "cl", interval=interval, copy=True)
    np.testing.assert_array_equal(int_t, int_j)
    np.testing.assert_array_equal(occ_t, occ_j)


def test_knife_edge_pair_is_the_only_difference():
    """In this fixture one pair's d2 straddles a threshold: the port rounds it
    to 91050.046875 (> thr 91050.04, and nearer the exact 91050.04542), XLA:CPU
    fuses it to 91050.0390625 (<= thr). The counts differ by that pair only."""
    adata = _adata(2000, 5, seed=1)
    pts = np.asarray(adata.obsm["spatial"], np.float32)
    codes = np.asarray(adata.obs["cl"].cat.codes, np.int32)
    thr = _default_thresholds(pts, 50)
    edges = _straddling(pts, thr)
    assert [(i, j, r) for i, j, r, _, _ in edges] == [(196, 211, 47)], edges
    _, _, _, d2_port, d2_fused = edges[0]
    exact = float(((pts[196].astype(np.float64) - pts[211]) ** 2).sum())
    assert d2_fused <= thr[47] < d2_port and abs(d2_port - exact) < abs(d2_fused - exact)
    got = co_occurrence_counts(pts, codes, thr, 5)
    want = jax_co_occurrence_counts(pts, codes, thr, 5)
    want[codes[196], codes[211], 47] -= 1
    want[codes[211], codes[196], 47] -= 1
    np.testing.assert_array_equal(got, want)


def test_co_occurrence_counts_binned_below_dispatch():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 700, (5000, 2)).astype(np.float32)
    labs = rng.integers(0, 6, 5000).astype(np.int32)
    thr = (np.linspace(1.0, 150.0, 30) ** 2).astype(np.float32)
    got = co_occurrence_counts(pts, labs, thr, 6, method="binned")
    want = jax_co_occurrence_counts(pts, labs, thr, 6, method="binned")
    assert not _straddling(pts, thr)
    assert got.dtype == want.dtype == np.float64 and got.shape == (6, 6, 30)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, co_occurrence_counts(pts, labs, thr, 6, method="dense"))


def test_co_occurrence_rejects_bad_input():
    adata = _adata(100, 3, seed=0)
    with pytest.raises(ValueError, match="at most 128 clusters"):
        sqt.gr.co_occurrence(_adata(100, 129, seed=0), "cl", use_pallas=True)
    with pytest.raises(ValueError, match="length"):
        sqt.gr.co_occurrence(adata, "cl", interval=np.array([3.0]))
    with pytest.raises(ValueError, match="method"):
        co_occurrence_counts(np.zeros((3, 2)), np.zeros(3, int), np.ones(1), 1, method="fast")


@pytest.mark.parametrize(("keyword", "value"), [("n_splits", 2), ("n_jobs", 2), ("backend", "loky"),
                                                ("show_progress_bar", False)])
def test_deprecated_keywords_warn_and_change_nothing(keyword, value):
    """Each package warns with a FutureWarning, drops the keyword and returns
    the call's result without it; the two packages' results are equal."""
    rng = np.random.default_rng(0)
    adata = _adata(600, 4, seed=0)
    adata.obsm["spatial"] = rng.uniform(0, 100, (600, 2))
    assert not _straddling(adata.obsm["spatial"], _default_thresholds(adata.obsm["spatial"], 8))
    results = {}
    for name, pkg in (("torch", sqt), ("jax", sq)):
        plain = pkg.gr.co_occurrence(adata, "cl", interval=8, copy=True)
        with pytest.warns(FutureWarning, match=keyword):
            got = pkg.gr.co_occurrence(adata, "cl", interval=8, copy=True, **{keyword: value})
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a, b)
        results[name] = got
    for a, b in zip(results["torch"], results["jax"]):
        np.testing.assert_array_equal(a, b)


def test_slice_chained_matches_jax():
    n, n_perms, seed = 3000, 40, 0
    words = random_bits(spawn_keys(seed, n_perms), (n,))
    assert all(len(np.unique(w)) == n for w in words)  # no tied sort words
    a, b = _adata(n, 6, seed=3), _adata(n, 6, seed=3)
    for pkg, adata in ((sq, a), (sqt, b)):
        pkg.gr.spatial_neighbors_knn(adata, n_neighs=6)
        pkg.gr.nhood_enrichment(adata, "cl", n_perms=n_perms, seed=seed)
        pkg.gr.co_occurrence(adata, "cl", interval=25)
    assert not _straddling(a.obsm["spatial"], _default_thresholds(a.obsm["spatial"], 25))
    assert (a.obsp["spatial_connectivities"] != b.obsp["spatial_connectivities"]).nnz == 0
    da, db = a.obsp["spatial_distances"], b.obsp["spatial_distances"]
    assert (da != 0).nnz == (db != 0).nnz and np.array_equal(da.indices, db.indices)
    np.testing.assert_allclose(db.data, da.data, rtol=1e-6)
    assert a.uns["spatial_neighbors"] == b.uns["spatial_neighbors"]
    for key, fields in (("cl_nhood_enrichment", ("zscore", "count")), ("cl_co_occurrence", ("occ", "interval"))):
        for f in fields:
            np.testing.assert_array_equal(b.uns[key][f], a.uns[key][f], err_msg=f"{key}[{f}]")
