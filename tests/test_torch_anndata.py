"""The port's containers and I/O against squidpy_tpu's: ``AnnData``
(slicing, ``copy``, ``concat``, ``obs_vector``, the ``*_make_unique``
helpers), h5ad files written by one package and read by the other, the
``SpatialData`` store each way, and the zarr v2 arrays. Everything is
compared exactly: frames with ``check_exact``, arrays bitwise.
"""

from __future__ import annotations

import inspect

import numpy as np
import pandas as pd
import pytest
from scipy import sparse as sp
from test_torch_read import assert_same, assert_same_adata

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.im import _zarr as tzarr
from squidpy_tpu.im import _zarr as jzarr


def _build(pkg, seed: int = 0, sparse: bool = True, n: int = 30, g: int = 8):
    rng = np.random.default_rng(seed)
    x = rng.poisson(1.0, (n, g)).astype(np.float32)
    obs = pd.DataFrame({"cl": pd.Categorical(rng.choice(["a", "b", "c"], n)), "score": rng.random(n),
                        "flag": rng.random(n) > 0.5, "name": [f"n{i}" for i in range(n)]},
                       index=[f"cell{i}" for i in range(n)])
    var = pd.DataFrame({"gene_ids": [f"id{j}" for j in range(g)]}, index=[f"g{j}" for j in range(g)])
    adata = pkg.AnnData(X=sp.csr_matrix(x) if sparse else x, obs=obs, var=var)
    adata.obsm["spatial"] = rng.uniform(0, 100, (n, 2))
    adata.obsm["frame"] = pd.DataFrame(rng.random((n, 2)), index=obs.index, columns=["u", "v"])
    adata.varm["pcs"] = rng.random((g, 3))
    adata.obsp["spatial_connectivities"] = sp.random(n, n, density=0.1, random_state=seed, format="csr")
    adata.layers["counts"] = x.copy()
    adata.uns["cl_colors"] = np.asarray(["#ff0000", "#00ff00", "#0000ff"])
    adata.uns["params"] = {"k": 6, "radius": 2.5, "name": "knn", "nested": {"flag": True}}
    return adata


def test_construction_matches_jax():
    assert_same_adata(_build(sqt), _build(sq))
    for kw in ({"shape": (4, 3)}, {"X": np.ones((2, 5))}, {"obs": pd.DataFrame({"a": [1, 2]})}, {}):
        assert_same_adata(sqt.AnnData(**kw), sq.AnnData(**kw))
    assert repr(_build(sqt)) == repr(_build(sq))
    with pytest.raises(ValueError, match="rows"):
        sqt.AnnData(X=np.ones((2, 2)), obs=pd.DataFrame({"a": [1, 2, 3]}))


@pytest.mark.parametrize("index", [
    slice(3, 20), [0, 4, 9], np.arange(30) % 3 == 0, "cell7", (slice(None), ["g2", "g5"]), (["cell1", "cell3"], [1, 0]),
    (np.arange(30) > 10, np.arange(8) < 4), 5,
], ids=["slice", "positions", "mask", "name", "var names", "both", "both masks", "int"])
@pytest.mark.parametrize("with_raw", [False, True])
def test_slicing_matches_jax(index, with_raw):
    got, want = _build(sqt), _build(sq)
    if with_raw:
        got.raw, want.raw = sqt._core.Raw(got), sq._core.Raw(want)
    a, b = got[index], want[index]
    assert_same_adata(a, b)
    if with_raw:
        assert_same(a.raw.X, b.raw.X)
        assert_same(a.raw.var, b.raw.var)
        assert_same(a.raw[:, ["g1", "g3"]].X, b.raw[:, ["g1", "g3"]].X)


def test_copy_is_deep_and_matches_jax():
    got, want = _build(sqt).copy(), _build(sq).copy()
    assert_same_adata(got, want)
    orig = _build(sqt)
    dup = orig.copy()
    dup.obsm["spatial"][0, 0] = -1.0
    dup.uns["params"]["nested"]["flag"] = False
    dup.obs["score"] = 0.0
    assert orig.obsm["spatial"][0, 0] != -1.0 and orig.uns["params"]["nested"]["flag"] and orig.obs["score"].any()


@pytest.mark.parametrize("join", ["inner", "outer"])
@pytest.mark.parametrize("label", [None, "batch"])
@pytest.mark.parametrize("index_unique", [None, "-"])
@pytest.mark.parametrize("sparse", [True, False])
def test_concat_matches_jax(join, label, index_unique, sparse):
    results = []
    for pkg in (sqt, sq):
        a, b = _build(pkg, 1, sparse), _build(pkg, 2, sparse, n=20, g=10)
        b.var_names = [f"g{j}" for j in range(3, 13)]
        results.append(pkg.concat([a, b], join=join, label=label, keys=["s1", "s2"], index_unique=index_unique))
    assert_same_adata(*results)
    with pytest.raises(ValueError, match="No objects"):
        sqt.concat([])


def test_obs_vector_and_make_unique_match_jax():
    got, want = _build(sqt, sparse=True), _build(sq, sparse=True)
    for key, layer in (("score", None), ("cl", None), ("g3", None), ("g3", "counts")):
        assert_same(got.obs_vector(key, layer=layer), want.obs_vector(key, layer=layer), key)
    for adata in (got, want):
        adata.var_names = ["a", "b", "a", "c", "a", "b", "d", "e"]
        adata.obs_names = [f"c{i % 10}" for i in range(30)]
        adata.var_names_make_unique()
        adata.obs_names_make_unique()
    assert_same(got.var_names, want.var_names)
    assert_same(got.obs_names, want.obs_names)
    assert list(got.var_names[:5]) == ["a", "b", "a-1", "c", "a-2"]
    with pytest.raises(ValueError, match="Shape mismatch"):
        got.X = np.ones((2, 2))


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("sparse", [True, False])
def test_h5ad_round_trip_between_packages(tmp_path, writer, sparse):
    """A file written by either package reads back equal in both."""
    src = _build(sqt if writer == "torch" else sq, sparse=sparse)
    src.uns["__squidpy_tpu_cache"] = {"x": object()}  # device caches are not written
    if writer == "torch":
        src.uns["__squidpy_torch_ell__spatial_connectivities"] = {"graph": object()}
    path = tmp_path / "a.h5ad"
    src.write_h5ad(str(path))
    got, want = sqt.read_h5ad(str(path)), sq.read_h5ad(str(path))
    assert_same_adata(got, want)
    assert got.raw is None and want.raw is None  # neither writer writes `raw`
    assert not [k for k in got.uns if k.startswith("__")]
    np.testing.assert_array_equal(got.obsm["spatial"], src.obsm["spatial"])
    assert_same(got.X, src.X, "X")
    np.testing.assert_array_equal(got.obs["score"].to_numpy(), src.obs["score"].to_numpy())


def _sdata(pkg):
    rng = np.random.default_rng(4)
    table = _build(pkg, 3)
    return pkg.SpatialData(
        images={"he": rng.integers(0, 255, (3, 32, 40), dtype=np.uint8),
                "pyramid": {"0": rng.random((2, 16, 16)).astype(np.float32), "1": rng.random((2, 8, 8))}},
        labels={"cells": rng.integers(0, 50, (32, 40)).astype(np.int32)},
        shapes={"spots": pd.DataFrame({"x": rng.random(5), "y": rng.random(5), "radius": np.full(5, 2.5)})},
        tables={"table": table},
    )


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_spatialdata_round_trip_between_packages(tmp_path, writer):
    src = _sdata(sqt if writer == "torch" else sq)
    src.write(tmp_path / "store.zarr")
    got, want = sqt.SpatialData.read(tmp_path / "store.zarr"), sq.SpatialData.read(tmp_path / "store.zarr")
    assert repr(got) == repr(want)
    for tree in ("images", "labels", "shapes"):
        assert_same(getattr(got, tree), getattr(want, tree), tree)
    assert_same_adata(got.tables["table"], want.tables["table"])
    assert_same(got.images["he"], src.images["he"])
    src.images.pop("pyramid")
    src.write(tmp_path / "store.zarr")  # a rewrite reflects the current container
    assert sorted(sqt.SpatialData.read(tmp_path / "store.zarr").images) == ["he"]
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "file").write_text("x")
    with pytest.raises(ValueError, match="refusing to overwrite"):
        sqt.SpatialData().write(tmp_path / "other")


@pytest.mark.parametrize(("shape", "dtype", "chunks", "compress"), [
    ((7, 5), np.float32, None, True), ((3, 4, 5), np.int16, (2, 3, 2), True), ((6,), np.float64, (4,), False),
    ((), np.int64, None, True), ((0, 3), np.uint8, None, True), ((5, 5), ">f4", (2, 5), True),
])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_zarr_array_round_trip_between_packages(tmp_path, shape, dtype, chunks, compress, writer):
    rng = np.random.default_rng(0)
    arr = np.asarray(rng.integers(0, 100, shape)).astype(dtype)
    (tzarr if writer == "torch" else jzarr).write_array(tmp_path, "a", arr, dims=tuple("xyz"[: len(shape)]),
                                                         attrs={"scale": 0.5}, chunks=chunks, compress=compress)
    got, want = tzarr.read_array(tmp_path / "a"), jzarr.read_array(tmp_path / "a")
    assert_same(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], arr)
    assert got[0].dtype == want[0].dtype
    arrays = {"u": rng.random((4, 3)), "v": np.arange(6, dtype=np.int32)}
    tzarr.write_group(tmp_path / "g", arrays, group_attrs={"k": 1}, dims={"u": ("a", "b")})
    assert tzarr.is_zarr_store(tmp_path / "g") and not tzarr.is_zarr_store(tmp_path / "a" / ".zarray")
    for read in (tzarr.read_group, jzarr.read_group):
        got_arrays, attrs = read(tmp_path / "g")
        assert attrs == {"k": 1} and sorted(got_arrays) == ["u", "v"]
        for k in arrays:
            np.testing.assert_array_equal(got_arrays[k], arrays[k])


@pytest.mark.parametrize("name", ["AnnData", "SpatialData", "concat", "read_h5ad"])
def test_top_level_signatures_match_jax(name):
    got, want = getattr(sqt, name), getattr(sq, name)
    got = got.__init__ if inspect.isclass(got) else got
    want = want.__init__ if inspect.isclass(want) else want
    assert ([(p.name, p.kind, p.default) for p in inspect.signature(got).parameters.values()]
            == [(p.name, p.kind, p.default) for p in inspect.signature(want).parameters.values()])


@pytest.mark.parametrize("name", ["var_by_distance", "sliding_window", "_calculate_window_corners"])
def test_tl_signatures_match_jax(name):
    got, want = inspect.signature(getattr(sqt.tl, name)), inspect.signature(getattr(sq.tl, name))
    assert ([(p.name, p.kind, p.default) for p in got.parameters.values()]
            == [(p.name, p.kind, p.default) for p in want.parameters.values()])


def test_spatial_graph_is_exported():
    from squidpy_torch._core.graph import SpatialGraph

    assert sqt.SpatialGraph is SpatialGraph
    assert {"AnnData", "SpatialData", "SpatialGraph", "concat", "read_h5ad", "read", "tl"} <= set(sqt.__all__)
