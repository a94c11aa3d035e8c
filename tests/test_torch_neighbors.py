"""The port's graph builders and the statistics on their graphs against squidpy_tpu's.

Each public function runs in both packages on the same ``AnnData`` inputs,
made from a seed. Tolerances:

- ``obsp`` CSR (``indptr``, ``indices``, ``data``) and ``uns[...]['params']``
  are bitwise equal, with one documented exception: a radius graph's
  distances, which XLA on the CPU computes from a fused ``d2``
  (``tests/test_torch_radius.py``); where they differ, the port's is the
  root of the unfused float32 ``d2`` and JAX's of the fused one. No fixture
  holds a pair on a knife edge of the radius or of an interval bound
  (asserted). A kNN graph's distances (the facade's kNN modes and
  ``KNNBuilder``) are held to rtol 1e-6, as in ``tests/test_torch_graph.py``;
- the facade's ``FutureWarning`` messages are equal, word for word;
- ``nhood_enrichment`` counts and z-scores are bitwise equal (below 65,536
  cells both packages stable-sort the same threefry words; no column of these
  fixtures holds two equal words, asserted);
- ``spatial_autocorr`` as in ``tests/test_torch_autocorr.py``: scores to
  ``1e-5 * sum |terms|`` through their normalisation, p-values to rtol 1e-3,
  ``pval_sim`` and ``var_norm`` exactly.
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp
from test_torch_autocorr import _assert_frames_agree, _score_bound

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch._core.graph import SpatialGraph
from squidpy_torch._core.rng import random_bits, spawn_keys
from squidpy_torch.gr import neighbors as tnb
from squidpy_torch.ops.knn import radius_neighbors
from squidpy_tpu.gr import neighbors as jnb

torch.set_num_threads(1)

RADIUS = 20.0  # ~12.6 neighbours at ~10 um spacing


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _adata(n: int, seed: int, *, kind: str = "random", visium: bool = False) -> sq.AnnData:
    """Uniform points ~10 apart (``random``), or a hexagonal (``hex``) or
    square (``square``) lattice of spacing 1; 5 clusters, two interleaved
    libraries, 6 genes; ``visium`` adds ``uns['spatial']``."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        coords = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    else:
        side = int(np.ceil(np.sqrt(n)))
        jj, ii = np.divmod(np.arange(side * side), side)
        coords = np.c_[ii + 0.5 * (jj % 2), jj * np.sqrt(3) / 2] if kind == "hex" else np.c_[ii, jj].astype(float)
        coords = coords[:n]
    x = rng.poisson(rng.uniform(0.5, 4.0, 6), size=(n, 6)).astype(np.float32)
    x[:, 0] += np.linspace(0.0, 3.0, n, dtype=np.float32)
    adata = sq.AnnData(
        X=x,
        obs=pd.DataFrame({"cl": pd.Categorical(rng.integers(0, 5, n).astype(str)),
                          "lib": pd.Categorical(np.array(["a", "b"])[np.arange(n) % 2])},
                         index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=[f"gene_{i}" for i in range(6)]),
    )
    adata.obsm["spatial"] = coords
    if visium:
        adata.uns["spatial"] = {"lib": {"scalefactors": {"spot_diameter_fullres": 1.0}}}
    return adata


def _pair(n: int = 600, seed: int = 0, **kw) -> tuple[sq.AnnData, sq.AnnData]:
    """The same input twice: one for each package."""
    return _adata(n, seed, **kw), _adata(n, seed, **kw)


def _d2(c: np.ndarray, rows: np.ndarray, cols: np.ndarray, fused: bool) -> np.ndarray:
    diff = c[rows].astype(np.float32) - c[cols].astype(np.float32)
    if fused:  # XLA:CPU: fma(dy, dy, dx * dx)
        return (diff[:, 1].astype(np.float64) ** 2 + (diff[:, 0] * diff[:, 0]).astype(np.float64)).astype(np.float32)
    return diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]


def _assert_no_knife_edge(coords: np.ndarray, bounds: tuple[float, ...]) -> None:
    """No pair is kept by one rounding of d2 only, at a radius ``b`` (d2 <=
    float32(b^2)) or at an interval bound ``b`` (the float64 distance < b or
    > b)."""
    i, j = np.nonzero(~np.eye(len(coords), dtype=bool))
    unfused, fused = _d2(coords, i, j, fused=False), _d2(coords, i, j, fused=True)
    du, df = np.sqrt(unfused).astype(np.float64), np.sqrt(fused).astype(np.float64)
    for b in bounds:
        r2 = np.float32(b * b)
        assert not np.any((unfused <= r2) != (fused <= r2)), b
        assert not np.any((du < b) != (df < b)) and not np.any((du > b) != (df > b)), b


def _assert_csr(got, want, what: str, coords: np.ndarray | None = None, rtol: float = 0.0) -> None:
    """Bitwise (or to ``rtol``), or for a radius graph's distances (``coords``
    given) each differing entry the root of its own rounding of d2."""
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    np.testing.assert_array_equal(got.indptr, want.indptr, err_msg=what)
    np.testing.assert_array_equal(got.indices, want.indices, err_msg=what)
    assert got.data.dtype == want.data.dtype, what
    if rtol or coords is None:
        np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=0, err_msg=what)
        return
    rows = np.repeat(np.arange(got.shape[0]), np.diff(got.indptr))
    diff = got.data != want.data
    r, c = rows[diff], got.indices[diff]
    np.testing.assert_array_equal(got.data[diff], np.sqrt(_d2(coords, r, c, fused=False)), err_msg=what)
    np.testing.assert_array_equal(want.data[diff], np.sqrt(_d2(coords, r, c, fused=True)), err_msg=what)


def _assert_same_graph(at: sq.AnnData, aj: sq.AnnData, key: str = "spatial", radius: bool = False,
                       knn: bool = False) -> None:
    for suffix in ("connectivities", "distances"):
        name = f"{key}_{suffix}"
        coords = np.asarray(at.obsm["spatial"]) if radius and suffix == "distances" else None
        _assert_csr(at.obsp[name], aj.obsp[name], name, coords, rtol=1e-6 if knn and suffix == "distances" else 0.0)
    got, want = at.uns[f"{key}_neighbors"], aj.uns[f"{key}_neighbors"]
    assert got == want, (got, want)


def _both(fn_name: str, at: sq.AnnData, aj: sq.AnnData, **kw) -> None:
    getattr(sqt.gr, fn_name)(at, **kw)
    getattr(sq.gr, fn_name)(aj, **kw)


RADIUS_CASES = {
    "scalar": dict(radius=RADIUS),
    "interval": dict(radius=(8.0, RADIUS)),
    "set_diag": dict(radius=RADIUS, set_diag=True),
    "percentile": dict(radius=RADIUS, percentile=80.0),
    "spectral": dict(radius=RADIUS, transform="spectral"),
    "library_key, 1 job": dict(radius=RADIUS, library_key="lib", n_jobs=1),
    "library_key, 2 jobs": dict(radius=RADIUS, library_key="lib", n_jobs=2),
    "key_added": dict(radius=(0.0, 12.5), key_added="niche"),
    "interval, set_diag": dict(radius=(8.0, RADIUS), set_diag=True),
    "percentile, set_diag": dict(radius=RADIUS, percentile=80.0, set_diag=True),
    "spectral, set_diag": dict(radius=RADIUS, transform="spectral", set_diag=True),
    "cosine": dict(radius=RADIUS, transform="cosine"),
    "interval, percentile, cosine, set_diag": dict(radius=(8.0, RADIUS), percentile=70.0, transform="cosine",
                                                   set_diag=True),
    "library_key, set_diag": dict(radius=RADIUS, library_key="lib", set_diag=True),
}


@pytest.mark.parametrize("case", list(RADIUS_CASES))
def test_spatial_neighbors_radius_matches_jax(case):
    kw = RADIUS_CASES[case]
    at, aj = _pair()
    _assert_no_knife_edge(np.asarray(at.obsm["spatial"]), (RADIUS, 8.0, 12.5))
    _both("spatial_neighbors_radius", at, aj, **kw)
    key = kw.get("key_added", "spatial")
    _assert_same_graph(at, aj, key, radius=True)
    adj = at.obsp[f"{key}_connectivities"]
    assert adj.nnz > 2 * at.n_obs
    if "library_key" in kw:
        lib = np.asarray(at.obs["lib"].cat.codes)
        coo = adj.tocoo()
        assert np.all(lib[coo.row] == lib[coo.col])


class _RadiusBuilderBefore(tnb.RadiusBuilder):
    """The radius builder as it assembled its CSR before the search wrote
    the diagonal: the CSR without it, then scipy's ``setdiag`` on both
    matrices."""

    def build_graph(self, coords):
        n = coords.shape[0]
        r = self.radius if isinstance(self.radius, (int, float)) else max(self.radius)
        indptr, indices, dists = radius_neighbors(coords, float(r))
        adj = sp.csr_matrix((np.ones(len(indices), dtype=np.float32), indices, indptr), shape=(n, n))
        dst = sp.csr_matrix((dists.astype(np.float64), indices.copy(), indptr.copy()), shape=(n, n))
        adj.setdiag(1.0 if self.set_diag else adj.diagonal())
        dst.setdiag(0.0)
        return adj, dst


def _assert_identical_csr(got, want, what: str) -> None:
    """The same CSR to the bit: arrays, their dtypes and the sorted flag
    (sorted, where no cosine transform reordered both)."""
    for field in ("indptr", "indices", "data"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, (what, field, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{field}")
    assert got.has_sorted_indices == want.has_sorted_indices, what


@pytest.mark.parametrize("case", list(RADIUS_CASES))
def test_radius_graph_is_the_setdiag_of_the_csr_without_it(case):
    """The finished CSR the search now gives is bitwise what scipy's
    ``setdiag`` made of the CSR without the diagonal, through every
    postprocessor and ``library_key``'s combine."""
    kw = dict(RADIUS_CASES[case])
    key = kw.pop("key_added", "spatial")
    library_key, n_jobs = kw.pop("library_key", None), kw.pop("n_jobs", 1)
    at, before = _adata(600, 0), _adata(600, 0)
    sqt.gr.spatial_neighbors_radius(at, library_key=library_key, n_jobs=n_jobs, key_added=key, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sp.SparseEfficiencyWarning)
        sqt.gr.spatial_neighbors_from_builder(before, _RadiusBuilderBefore(**kw), library_key=library_key,
                                              n_jobs=n_jobs, key_added=key)
    for suffix in ("connectivities", "distances"):
        name = f"{key}_{suffix}"
        _assert_identical_csr(at.obsp[name], before.obsp[name], name)


def test_radius_builder_writes_explicit_diagonals():
    """Before the postprocessors, every row holds its diagonal: 1.0 or an
    explicit 0.0 in the adjacency, 0.0 in the distances."""
    coords = np.asarray(_adata(300, 3).obsm["spatial"])
    coords[[4, 9]] = np.nan  # rows with no neighbour still hold their diagonal
    for set_diag in (False, True):
        adj, dst = tnb.RadiusBuilder(radius=RADIUS, set_diag=set_diag).build_graph(coords)
        rows = np.repeat(np.arange(len(coords)), np.diff(adj.indptr))
        diag = rows == adj.indices
        assert np.count_nonzero(diag) == len(coords)
        assert np.all(adj.data[diag] == float(set_diag)) and np.all(adj.data[~diag] == 1.0)
        assert np.all(dst.data[diag] == 0.0) and np.array_equal(dst.indices, adj.indices)
        assert np.diff(adj.indptr)[4] == 1 and np.diff(adj.indptr)[9] == 1


DELAUNAY_CASES = {
    "plain": dict(),
    "interval": dict(radius=(5.0, 15.0)),
    "scalar radius": dict(radius=12.5),
    "percentile, set_diag": dict(percentile=90.0, set_diag=True),
    "library_key": dict(library_key="lib"),
}


@pytest.mark.parametrize("case", list(DELAUNAY_CASES))
def test_spatial_neighbors_delaunay_matches_jax(case):
    at, aj = _pair()
    _both("spatial_neighbors_delaunay", at, aj, **DELAUNAY_CASES[case])
    _assert_same_graph(at, aj)


@pytest.mark.parametrize("kind,kw", [
    ("hex", dict(n_neighs=6, n_rings=1)),
    ("hex", dict(n_neighs=6, n_rings=2)),
    ("hex", dict(n_neighs=6, n_rings=3, set_diag=True)),
    ("square", dict(n_neighs=4, n_rings=2)),
    ("hex", dict(n_neighs=6, delaunay=True)),
    ("square", dict(n_neighs=4, n_rings=2, delaunay=True, transform="spectral")),
], ids=["hex", "hex, 2 rings", "hex, 3 rings, set_diag", "square, 2 rings", "hex, delaunay",
        "square, 2 rings, delaunay, spectral"])
def test_spatial_neighbors_grid_matches_jax(kind, kw):
    at, aj = _pair(400, kind=kind)
    _both("spatial_neighbors_grid", at, aj, **kw)
    _assert_same_graph(at, aj)
    if kw.get("n_rings", 1) > 1 and not kw.get("set_diag"):
        assert set(np.unique(at.obsp["spatial_distances"].data)) == set(range(1, kw["n_rings"] + 1))


@pytest.mark.parametrize("name,kw", [
    ("KNNBuilder", dict(n_neighs=7, percentile=90.0)),
    ("RadiusBuilder", dict(radius=(8.0, RADIUS), transform="spectral")),
    ("DelaunayBuilder", dict(radius=12.5, set_diag=True)),
    ("GridBuilder", dict(n_neighs=6, n_rings=2)),
])
def test_spatial_neighbors_from_builder_matches_jax(name, kw):
    at, aj = _pair(400, kind="hex" if name == "GridBuilder" else "random")
    sqt.gr.spatial_neighbors_from_builder(at, getattr(tnb, name)(**kw), key_added="built")
    sq.gr.spatial_neighbors_from_builder(aj, getattr(jnb, name)(**kw), key_added="built")
    _assert_same_graph(at, aj, "built", radius=name == "RadiusBuilder", knn=name == "KNNBuilder")


def test_copy_returns_the_result_and_writes_nothing():
    at, aj = _pair()
    got = sqt.gr.spatial_neighbors_radius(at, radius=RADIUS, copy=True)
    want = sq.gr.spatial_neighbors_radius(aj, radius=RADIUS, copy=True)
    assert isinstance(got, sqt.gr.SpatialNeighborsResult) and not at.obsp.keys() and not at.uns
    _assert_csr(got.connectivities, want.connectivities, "connectivities")


# -- the deprecated facade --------------------------------------------------------

FACADE_CASES = {
    "generic knn": ("random", False, dict(coord_type="generic", n_neighs=5)),
    "visium metadata, grid": ("hex", True, dict()),
    "visium metadata, n_neighs set: knn": ("random", True, dict(n_neighs=6)),
    "no metadata: knn": ("random", False, dict()),
    "grid ignores radius": ("hex", True, dict(coord_type="grid", n_rings=2, radius=3.0)),
    "delaunay ignores n_neighs": ("random", False, dict(coord_type="generic", delaunay=True, n_neighs=10)),
    "delaunay drops a scalar radius": ("random", False, dict(coord_type="generic", delaunay=True, radius=5.0)),
    "delaunay keeps an interval": ("random", False, dict(delaunay=True, radius=(1.0, 12.5))),
    "radius ignores n_neighs": ("random", False, dict(coord_type="generic", radius=RADIUS, n_neighs=4)),
    "radius interval, percentile": ("random", False, dict(radius=(8.0, RADIUS), percentile=90.0)),
    "grid delaunay, library_key": ("hex", True, dict(coord_type="grid", delaunay=True, library_key="lib")),
}


def _messages(fn, *args, **kw) -> list[tuple[type, str]]:
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn(*args, **kw)
    return [(w.category, str(w.message)) for w in rec if issubclass(w.category, FutureWarning)]


@pytest.mark.parametrize("case", list(FACADE_CASES))
def test_spatial_neighbors_facade_matches_jax(case):
    kind, visium, kw = FACADE_CASES[case]
    at, aj = _pair(400, kind=kind, visium=visium)
    if kind == "random":
        _assert_no_knife_edge(np.asarray(at.obsm["spatial"]), (RADIUS, 8.0, 12.5, 1.0))
    got = _messages(sqt.gr.spatial_neighbors, at, **kw)
    want = _messages(sq.gr.spatial_neighbors, aj, **kw)
    assert got == want and "deprecated" in got[0][1]
    resolved = at.uns["spatial_neighbors"]["params"]
    _assert_same_graph(at, aj, radius="radius" in resolved, knn="n_neighbors" in resolved and "n_rings" not in resolved)
    assert resolved["coord_type"] == ("grid" if kw.get("coord_type") == "grid" or case.endswith(", grid")
                                      else "generic")


def test_facade_rejects_percentile_on_a_grid():
    at, aj = _pair(100, kind="hex", visium=True)
    with pytest.raises(ValueError) as got, pytest.warns(FutureWarning):
        sqt.gr.spatial_neighbors(at, coord_type="grid", percentile=50.0)
    with pytest.raises(ValueError) as want, pytest.warns(FutureWarning):
        sq.gr.spatial_neighbors(aj, coord_type="grid", percentile=50.0)
    assert str(got.value) == str(want.value)


# -- element centroids (elements_to_coordinate_systems) --------------------------

ENTRY_POINTS = ["spatial_neighbors", "spatial_neighbors_knn", "spatial_neighbors_radius", "spatial_neighbors_delaunay",
                "spatial_neighbors_grid"]
CENTROID_RADIUS = 15.0  # the first ring of the jittered lattice (~10 apart), not the second (~17.3)


def _lattice(n: int, rng) -> np.ndarray:
    """A hexagonal lattice of spacing 10 with a little jitter."""
    side = int(np.ceil(np.sqrt(n)))
    jj, ii = np.divmod(np.arange(side * side), side)
    pts = np.c_[ii + 0.5 * (jj % 2), jj * np.sqrt(3) / 2][:n] * 10.0
    return pts + rng.uniform(-0.8, 0.8, pts.shape)


def _sdata(pkg, table, shapes=None, labels=None):
    from types import SimpleNamespace

    return SimpleNamespace(tables={"table": table}, shapes=shapes or {}, labels=labels or {}, points={})


def _two_region_input(pkg, seed: int = 0):
    """Region ``a``: circles (an ``x``/``y`` frame whose index is the
    instance id); region ``b``: a labels image (background 0, ids with
    gaps, 3 x 3 squares). The table lists both regions interleaved, each in
    a shuffled instance order."""
    rng = np.random.default_rng(seed)
    na, nb = 40, 36
    pts_a = _lattice(na, rng)
    ids_a = rng.permutation(np.arange(100, 100 + na))
    circles = pd.DataFrame({"x": pts_a[:, 0], "y": pts_a[:, 1], "radius": np.full(na, 2.0)}, index=ids_a)
    img = np.zeros((120, 120), dtype=np.int32)
    ids_b = np.sort(rng.choice(np.arange(1, 500), nb, replace=False))
    for k, (y, x) in zip(ids_b, np.round(_lattice(nb, rng)[:, ::-1] + 15).astype(int)):
        img[y - 1 : y + 2, x - 1 : x + 2] = k
    inst = np.r_[rng.permutation(ids_a), rng.permutation(ids_b)]
    region = np.array(["a"] * na + ["b"] * nb)
    order = rng.permutation(na + nb)
    table = pkg.AnnData(X=np.zeros((na + nb, 2)),
                        obs=pd.DataFrame({"region": region[order], "instance_id": inst[order]},
                                         index=[f"cell{i}" for i in range(na + nb)]))
    table.uns["spatialdata_attrs"] = {"region": ["a", "b"], "region_key": "region", "instance_key": "instance_id"}
    return _sdata(pkg, table, shapes={"a": circles}, labels={"b": img}), table


def _spy_library_key(monkeypatch, module) -> list:
    """Record the library key each call hands to ``_run_spatial_neighbors``."""
    seen: list = []
    run = module._run_spatial_neighbors

    def spy(adata, builder, **kw):
        seen.append(kw.get("library_key"))
        return run(adata, builder, **kw)

    monkeypatch.setattr(module, "_run_spatial_neighbors", spy)
    return seen


@pytest.mark.parametrize("fn", ENTRY_POINTS)
def test_element_centroids_match_jax(fn, monkeypatch):
    """Every entry point resolves circles and labels centroids, in the
    table's instance order, and the region key as the library key: the
    coordinates, the key and the graph equal JAX's (bitwise, but for the
    documented exceptions: the kNN modes' distances to rtol 1e-6, a radius
    graph's distances each the root of its own rounding of d2)."""
    from squidpy_torch.gr import _build as tbuild
    from squidpy_tpu.gr import _build as jbuild

    (st, tt), (sj, tj) = _two_region_input(sqt), _two_region_input(sq)
    keys = _spy_library_key(monkeypatch, tbuild), _spy_library_key(monkeypatch, jbuild)
    kw = {"radius": CENTROID_RADIUS} if fn == "spatial_neighbors_radius" else {}
    systems = {"a": "global", "b": "global"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        getattr(sqt.gr, fn)(st, elements_to_coordinate_systems=systems, **kw)
        getattr(sq.gr, fn)(sj, elements_to_coordinate_systems=systems, **kw)
    got, want = np.asarray(tt.obsm["spatial"]), np.asarray(tj.obsm["spatial"])
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    assert keys[0] == keys[1] == ["region"]
    assert list(tt.obs["region"].cat.categories) == list(tj.obs["region"].cat.categories) == ["a", "b"]
    radius = fn == "spatial_neighbors_radius"
    if radius:
        _assert_no_knife_edge(got, (CENTROID_RADIUS,))
    _assert_same_graph(tt, tj, radius=radius, knn=fn in ("spatial_neighbors", "spatial_neighbors_knn"))
    adj = tt.obsp["spatial_connectivities"].toarray()
    in_a = np.asarray(tt.obs["region"]) == "a"
    assert adj[np.ix_(in_a, ~in_a)].sum() == 0 and adj[in_a][:, in_a].sum() > 0


def _circles_case(pkg):
    rng = np.random.default_rng(0)
    n = 60
    centers = rng.uniform(0, 100, size=(n, 2))
    shapes = pd.DataFrame({"x": centers[:, 0], "y": centers[:, 1], "radius": np.full(n, 2.0)}, index=np.arange(n))
    table = pkg.AnnData(X=np.zeros((n, 3)), obs=pd.DataFrame({"region": ["cells"] * n, "instance_id": np.arange(n)}))
    table.uns["spatialdata_attrs"] = {"region": "cells", "region_key": "region", "instance_key": "instance_id"}
    return _sdata(pkg, table, shapes={"cells": shapes}), table, {"cells": "global"}, 4, centers


def _labels_case(pkg):
    img = np.zeros((40, 40), dtype=np.int32)
    img[2:6, 2:6] = 1  # centroid (3.5, 3.5)
    img[10:20, 30:40] = 2  # centroid (34.5, 14.5) in (x, y)
    img[30:34, 10:18] = 3  # centroid (13.5, 31.5)
    table = pkg.AnnData(X=np.zeros((3, 2)), obs=pd.DataFrame({"region": ["seg"] * 3, "instance_id": [1, 2, 3]}))
    table.uns["spatialdata_attrs"] = {"region": "seg", "region_key": "region", "instance_key": "instance_id"}
    return _sdata(pkg, table, labels={"seg": img}), table, {"seg": "global"}, 2, \
        np.array([[3.5, 3.5], [34.5, 14.5], [13.5, 31.5]])


def _order_case(pkg):
    centers = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [10.0, 10.0]])
    shapes = pd.DataFrame({"x": centers[:, 0], "y": centers[:, 1]}, index=[0, 1, 2, 3])
    order = [2, 0, 3, 1]
    table = pkg.AnnData(X=np.zeros((4, 1)), obs=pd.DataFrame({"region": ["s"] * 4, "instance_id": order}))
    table.uns["spatialdata_attrs"] = {"region": "s", "region_key": "region", "instance_key": "instance_id"}
    return _sdata(pkg, table, shapes={"s": shapes}), table, {"s": "global"}, 2, centers[order]


def _regions_case(pkg):
    rng = np.random.default_rng(1)
    a = pd.DataFrame({"x": rng.uniform(0, 10, 30), "y": rng.uniform(0, 10, 30)})
    b = pd.DataFrame({"x": rng.uniform(100, 110, 30), "y": rng.uniform(0, 10, 30)})
    table = pkg.AnnData(X=np.zeros((60, 1)), obs=pd.DataFrame({"region": ["a"] * 30 + ["b"] * 30,
                                                               "instance_id": list(range(30)) * 2}))
    table.uns["spatialdata_attrs"] = {"region": ["a", "b"], "region_key": "region", "instance_key": "instance_id"}
    return _sdata(pkg, table, shapes={"a": a, "b": b}), table, {"a": "global", "b": "global"}, 3, \
        np.r_[np.c_[a["x"], a["y"]], np.c_[b["x"], b["y"]]]


@pytest.mark.parametrize("case", [_circles_case, _labels_case, _order_case, _regions_case],
                         ids=["circles", "labels image", "instance order", "two regions"])
def test_element_centroid_scenarios_match_jax(case):
    """The JAX package's element-centroid scenarios, in both packages: the
    centroids it expects, and the same coordinates and kNN graph."""
    (st, tt, systems, k, expected), (sj, tj, _, _, _) = case(sqt), case(sq)
    sqt.gr.spatial_neighbors_knn(st, n_neighs=k, elements_to_coordinate_systems=systems)
    sq.gr.spatial_neighbors_knn(sj, n_neighs=k, elements_to_coordinate_systems=systems)
    np.testing.assert_allclose(tt.obsm["spatial"], expected)
    assert np.array_equal(tt.obsm["spatial"], tj.obsm["spatial"])
    _assert_same_graph(tt, tj, knn=True)
    if case is _regions_case:  # the region key becomes the library key: no edge across regions
        adj = tt.obsp["spatial_connectivities"].toarray()
        assert adj[:30, 30:].sum() == 0 and adj[30:, :30].sum() == 0


def _missing_system(pkg):
    shapes = pd.DataFrame({"x": [0.0, 1.0], "y": [0.0, 1.0]})
    table = pkg.AnnData(X=np.zeros((2, 1)), obs=pd.DataFrame({"region": ["s", "s"], "instance_id": [0, 1]}))
    table.uns["spatialdata_attrs"] = {"region": "s", "region_key": "region", "instance_key": "instance_id"}
    return _sdata(pkg, table, shapes={"s": shapes}), {"other": "global"}


def _missing_centroid(pkg):
    shapes = pd.DataFrame({"x": [0.0, 1.0, 2.0], "y": [0.0, 1.0, 0.5]}, index=[0, 1, 2])
    table = pkg.AnnData(X=np.zeros((3, 1)), obs=pd.DataFrame({"region": ["s"] * 3, "instance_id": [0, 7, 2]}))
    table.uns["spatialdata_attrs"] = {"region": "s", "region_key": "region", "instance_key": "instance_id"}
    return _sdata(pkg, table, shapes={"s": shapes}), {"s": "global"}


@pytest.mark.parametrize("case,match", [(_missing_system, "coordinate system"), (_missing_centroid, "no centroid")],
                         ids=["missing coordinate system", "instance without a centroid"])
def test_element_centroid_errors_match_jax(case, match):
    errors = []
    for pkg in (sqt, sq):
        sdata, systems = case(pkg)
        with pytest.raises(ValueError, match=match) as err:
            pkg.gr.spatial_neighbors_knn(sdata, n_neighs=1, elements_to_coordinate_systems=systems)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_compute_cell_info_matches_jax():
    """The port's copy of ``compute_cell_info`` on a random labels image
    with gaps in its ids: the same labels, centroids and boxes, bitwise."""
    from squidpy_torch.experimental.im import compute_cell_info as tinfo
    from squidpy_tpu.experimental.im import compute_cell_info as jinfo

    rng = np.random.default_rng(3)
    ids = rng.choice(np.arange(1, 10_000), 60, replace=False)
    img = np.zeros((200, 150), dtype=np.int64)
    for k in ids:
        y, x = rng.integers(0, 190), rng.integers(0, 140)
        img[y : y + rng.integers(1, 10), x : x + rng.integers(1, 10)] = k
    got, want = tinfo(img), jinfo(img[None])  # JAX squeezes a leading axis; the copy does the same
    assert sorted(got) == sorted(want) == sorted(int(k) for k in np.unique(img) if k)
    for k in want:
        assert got[k].__dict__ == want[k].__dict__
    assert tinfo(img[None]) == got and tinfo(np.zeros((5, 5), np.int32)) == {}


# -- mask_graph --------------------------------------------------------------------

OUTER = np.array([[50.0, 40.0], [200.0, 60.0], [210.0, 220.0], [30.0, 190.0]])
HOLE = np.array([[90.0, 90.0], [150.0, 90.0], [150.0, 150.0], [90.0, 150.0]])


@pytest.mark.parametrize("polygon,negative", [
    (OUTER, False), ([OUTER, HOLE], False), ([OUTER, HOLE], True),
], ids=["raw ring", "ring with a hole", "ring with a hole, negative"])
def test_mask_graph_matches_jax(polygon, negative):
    at, aj = _pair()
    sq.gr.spatial_neighbors_knn(aj, n_neighs=6)
    for key in ("spatial_connectivities", "spatial_distances"):
        at.obsp[key] = aj.obsp[key].copy()
    at.uns["spatial_neighbors"] = dict(aj.uns["spatial_neighbors"])
    got = sqt.gr.mask_graph(at, table_key=None, polygon_mask=polygon, negative_mask=negative, copy=True)
    want = sq.gr.mask_graph(aj, table_key=None, polygon_mask=polygon, negative_mask=negative, copy=True)
    for g, w, name in zip(got, want, ("connectivities", "distances")):
        _assert_csr(g, w, name)
    assert 0 < got[0].nnz < aj.obsp["spatial_connectivities"].nnz
    sqt.gr.mask_graph(at, table_key=None, polygon_mask=polygon, negative_mask=negative, key_added="roi")
    sq.gr.mask_graph(aj, table_key=None, polygon_mask=polygon, negative_mask=negative, key_added="roi")
    _assert_same_graph(at, aj, "roi_spatial")


# -- statistics on the new graphs ---------------------------------------------------


def _graph(kind: str, n: int = 2000, seed: int = 3) -> tuple[sq.AnnData, sq.AnnData]:
    at, aj = _pair(n, seed)
    if kind == "radius":
        _assert_no_knife_edge(np.asarray(at.obsm["spatial"]), (RADIUS,))
        _both("spatial_neighbors_radius", at, aj, radius=RADIUS)
    else:
        _both("spatial_neighbors_delaunay", at, aj)
    _assert_same_graph(at, aj, radius=kind == "radius")
    return at, aj


@pytest.mark.parametrize("kind", ["radius", "delaunay"])
def test_new_graphs_take_degree_buckets(kind):
    at, _ = _graph(kind)
    graph = SpatialGraph.from_csr(at.obsp["spatial_connectivities"], dtype=np.float32)
    buckets = graph.degree_buckets()
    assert buckets is not None and len(buckets) > 1, kind


@pytest.mark.parametrize("mode", ["perm", "analytic"])
@pytest.mark.parametrize("kind", ["radius", "delaunay"])
def test_nhood_enrichment_on_new_graphs_matches_jax(kind, mode):
    at, aj = _graph(kind)
    n_perms = 50
    words = random_bits(spawn_keys(7, n_perms), (at.n_obs,))
    assert all(len(np.unique(w)) == at.n_obs for w in words)
    got = sqt.gr.nhood_enrichment(at, "cl", n_perms=n_perms, seed=7, mode=mode, copy=True)
    want = sq.gr.nhood_enrichment(aj, "cl", n_perms=n_perms, seed=7, mode=mode, copy=True)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.zscore, want.zscore)


@pytest.mark.parametrize("mode,n_perms", [("moran", None), ("moran", 20), ("geary", None), ("geary", 20)])
@pytest.mark.parametrize("kind", ["radius", "delaunay"])
def test_spatial_autocorr_on_new_graphs_matches_jax(kind, mode, n_perms):
    at, aj = _graph(kind)
    kw = dict(mode=mode, n_perms=n_perms, seed=0, copy=True)
    df = sq.gr.spatial_autocorr(aj, **kw)
    res = sqt.gr.spatial_autocorr(at, **kw)
    stat = "I" if mode == "moran" else "C"
    _assert_frames_agree(res, df, stat, _score_bound(at, res, mode, True, "X"))
