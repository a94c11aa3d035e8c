"""squidpy_torch's ``gr.calculate_niche`` against squidpy_tpu's.

Tolerances. The labels are equal on every fixture, for the three flavors,
with ``library_key``, ``mask``, ``min_niche_size`` and ``inplace=False``,
on the host branches (the port's ``_DEVICE_HOPS_MIN_N`` raised above the
fixtures by monkeypatching) and (``_DEVICE_HOPS_MIN_N`` and
``_GMM_DEVICE_MIN_N`` lowered in both packages) on the device branches. That
holds because each fixture is asserted free of the packages' documented
divergences: the clustering graphs both packages build are asserted equal
(the kNN search ranks by another d2 in each package, so near ties at the
k-th neighbour could swap; ``test_torch_feature_knn.py``), and the GMM
fits from the same rows (``test_torch_pca_gmm.py`` asserts its margins).
Leiden is bitwise (``test_torch_native.py``) and the hops are bitwise on
these binary graphs (``test_torch_hops.py``). The device profiles of the
neighborhood flavor are bitwise (exact counts, the same float32
operations); the cellcharter features agree within 1e-5 relative (float32
sums in two orders). Distance 1 profiles are left out of the label tests:
they take few distinct values, so most kNN ranks are exact ties that
the JAX package's expanded-form rounding breaks and the port breaks by
index.

JAX's ``utag`` smoothing and ``cellcharter`` features promote to float64
under x64 (this suite's setting), where the port (and JAX on a TPU) runs
float32: those flavors are compared with x64 off (``_x64_off``).
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.gr import _niche as tn
from squidpy_torch.models import clustering as tcl
from squidpy_tpu.gr import _niche as jn
from squidpy_tpu.models import clustering as jcl

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


@contextlib.contextmanager
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.fixture()
def host_branches(monkeypatch):
    """Both packages on their host branches at test size (the JAX package's
    threshold lies above every fixture)."""
    monkeypatch.setattr(tn, "_DEVICE_HOPS_MIN_N", 10**9)


@pytest.fixture()
def device_branches(monkeypatch):
    """Both packages on their device branches at test size."""
    for mod in (tn, jn):
        monkeypatch.setattr(mod, "_DEVICE_HOPS_MIN_N", 0)
    monkeypatch.setattr(tcl, "_GMM_DEVICE_MIN_N", 0)
    monkeypatch.setattr(jcl, "_GMM_DEVICE_MIN_N", 0)


@pytest.fixture()
def graphs(monkeypatch):
    """Records each package's clustering graphs, in call order."""
    seen = {"torch": [], "jax": []}
    for name, mod in (("torch", tcl), ("jax", jcl)):
        real = mod.knn_graph

        def spy(X, k, real=real, name=name):
            adj = real(X, k)
            seen[name].append(adj)
            return adj

        monkeypatch.setattr(mod, "knn_graph", spy)
    return seen


def _assert_same_graphs(seen):
    """The fixture condition: no near tie swapped a neighbour."""
    assert len(seen["torch"]) == len(seen["jax"]) > 0
    for a, b in zip(seen["torch"], seen["jax"]):
        assert a.shape == b.shape and (a != b).nnz == 0, "fixture: a near tie at the k-th neighbour"


def _domains(n: int = 1200, seed: int = 0, n_types: int = 8, n_genes: int = 20) -> sq.AnnData:
    """Four spatial quadrants, each with its own mix of cell types and its
    own expression, a kNN graph of 6, and two libraries."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    dom = (coords[:, 0] > coords[:, 0].mean()).astype(int) + 2 * (coords[:, 1] > coords[:, 1].mean())
    mix = rng.dirichlet(np.ones(n_types), 4)
    types = np.array([rng.choice(n_types, p=mix[d]) for d in dom])
    x = rng.poisson(1 + 2 * dom[:, None] * np.linspace(0, 1, n_genes)[None]).astype(np.float64)
    adata = sq.AnnData(X=x)
    adata.obs.index = [f"cell_{i}" for i in range(n)]
    adata.obsm["spatial"] = coords
    adata.obs["ct"] = pd.Categorical(np.array(list("abcdefgh"))[types])
    adata.obs["lib"] = pd.Categorical(np.where(coords[:, 0] > 6 * np.sqrt(n), "right", "left"))
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    return adata


def _both(adata, **kw):
    """Each package's result container (``inplace=False``)."""
    rj = sq.gr.calculate_niche(adata, inplace=False, **kw)
    rt = sqt.gr.calculate_niche(adata, inplace=False, **kw)
    return rt, rj


def _assert_same_columns(rt, rj, cols):
    for col in cols:
        assert col in rt.obs and col in rj.obs
        assert isinstance(rt.obs[col].dtype, pd.CategoricalDtype) == isinstance(rj.obs[col].dtype,
                                                                                 pd.CategoricalDtype)
        np.testing.assert_array_equal(rt.obs[col].astype(str).to_numpy(), rj.obs[col].astype(str).to_numpy())
    assert list(rt.obs.columns) == list(rj.obs.columns)


NHOOD = dict(flavor="neighborhood", groups="ct", n_neighbors=15)


@pytest.mark.parametrize("branch", ["host", "device"])
@pytest.mark.parametrize("kw", [
    dict(resolutions=[0.5, 1.0], distance=3, n_hop_weights=[1, 0.5, 0.25]),
    dict(resolutions=0.7, distance=2),
    dict(resolutions=[0.5], distance=3, n_hop_weights=[1, 0.5], abs_nhood=True),
    dict(resolutions=[0.5], distance=3, n_hop_weights=[1, 0.37, 0.11], scale=False),
    dict(resolutions=[1.0], distance=3, min_niche_size=150),
], ids=["weights", "default_weights", "abs_short_weights", "no_scale", "min_niche_size"])
def test_neighborhood(request, graphs, branch, kw):
    request.getfixturevalue(f"{branch}_branches")
    adata = _domains()
    rt, rj = _both(adata, **NHOOD, **kw)
    _assert_same_graphs(graphs)
    res = kw["resolutions"] if isinstance(kw["resolutions"], list) else [kw["resolutions"]]
    _assert_same_columns(rt, rj, [f"nhood_niche_res={r}" for r in res])
    if "min_niche_size" in kw:
        counts = rt.obs["nhood_niche_res=1.0"].value_counts()
        assert (counts.drop("not_a_niche", errors="ignore") >= 150).all() and "not_a_niche" in counts


@pytest.mark.parametrize("branch", ["host", "device"])
def test_neighborhood_library_and_mask(request, graphs, branch):
    request.getfixturevalue(f"{branch}_branches")
    adata = _domains()
    mask = pd.Series(np.arange(adata.n_obs) % 5 != 0, index=adata.obs.index)
    rt, rj = _both(adata, **NHOOD, resolutions=[0.5], distance=3, library_key="lib", mask=mask)
    _assert_same_graphs(graphs)
    _assert_same_columns(rt, rj, ["nhood_niche_res=0.5"])
    col = rt.obs["nhood_niche_res=0.5"].to_numpy()
    assert np.all(col[~mask.to_numpy()] == "not_a_niche")
    assert {v.split("_")[0] for v in col[mask.to_numpy()]} == {"lib=left", "lib=right"}


def test_neighborhood_inplace_overwrites(graphs):
    adata, ref = _domains(), _domains()
    adata.obs["nhood_niche_res=0.5"] = "old"
    adata.uns["nhood_niche_res=0.5_colors"] = ["#000000"]
    ref.obs["nhood_niche_res=0.5"] = "old"
    assert sqt.gr.calculate_niche(adata, **NHOOD, resolutions=0.5, distance=2) is None
    sq.gr.calculate_niche(ref, **NHOOD, resolutions=0.5, distance=2)
    _assert_same_graphs(graphs)
    _assert_same_columns(adata, ref, ["nhood_niche_res=0.5"])
    assert "nhood_niche_res=0.5_colors" not in adata.uns


def test_device_profiles_bitwise(device_branches):
    adata = _domains(900, seed=3)
    adj = adata.obsp["spatial_connectivities"]
    codes, n_cats = tn._category_codes(tn._obs_values(adata, "ct"))
    for abs_nhood, distance, weights in ((False, 1, None), (False, 3, [1, 0.5, 0.25]), (True, 2, [1.0, 0.3])):
        got = tn._nhood_profiles_device(codes, n_cats, adj, abs_nhood, distance, weights)
        want = jn._nhood_profiles_device(adata, "ct", adj, abs_nhood, distance, weights, as_frame=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("aggregation", ["mean", "variance"])
def test_cellcharter_hop_features(aggregation):
    adata = _domains(900, seed=4)
    adj = adata.obsp["spatial_connectivities"]
    x = adata.X.astype(np.float32)
    got = tn._cellcharter_hop_features(adj, torch.from_numpy(x), 3, aggregation).numpy()
    with _x64_off():
        want = np.asarray(jn._cellcharter_hop_features(adj, jnp.asarray(x), 3, aggregation))
    assert got.shape == want.shape == (900, 4 * 20)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("branch", ["host", "device"])
@pytest.mark.parametrize("library", [False, True])
def test_utag(request, graphs, branch, library):
    request.getfixturevalue(f"{branch}_branches")
    adata = _domains(seed=1)
    kw = dict(flavor="utag", n_neighbors=15, resolutions=[0.5, 1.0], library_key="lib" if library else None)
    with _x64_off():
        rt, rj = _both(adata, **kw)
    _assert_same_graphs(graphs)
    _assert_same_columns(rt, rj, ["utag_niche_res=0.5", "utag_niche_res=1.0"])


@pytest.mark.parametrize("branch", ["host", "device"])
@pytest.mark.parametrize(("aggregation", "library"), [("mean", False), ("variance", False), ("mean", True)])
def test_cellcharter(request, branch, aggregation, library):
    request.getfixturevalue(f"{branch}_branches")
    adata = _domains(seed=2)
    kw = dict(flavor="cellcharter", distance=3, aggregation=aggregation, n_components=4,
              library_key="lib" if library else None)
    with _x64_off():
        rt, rj = _both(adata, **kw)
    _assert_same_columns(rt, rj, ["cellcharter_niche"])
    assert isinstance(rt.obs["cellcharter_niche"].dtype, pd.CategoricalDtype) != library


def test_cellcharter_use_rep():
    adata = _domains(seed=5)
    rng = np.random.default_rng(0)
    adata.obsm["X_emb"] = np.vstack([rng.normal(3 * (i % 4), 1.0, 6) for i in range(adata.n_obs)])
    rt, rj = _both(adata, flavor="cellcharter", use_rep="X_emb", n_components=4)
    _assert_same_columns(rt, rj, ["cellcharter_niche"])
    adata.obsm["X_small"] = adata.obsm["X_emb"][:, :2]
    for pkg in (sq, sqt):
        with pytest.raises(ValueError, match="Embedding has 2 components"):
            pkg.gr.calculate_niche(adata, flavor="cellcharter", use_rep="X_small", n_components=4)


def test_spatialleiden_is_gated():
    adata = _domains(200)
    adata.obsp["connectivities"] = adata.obsp["spatial_connectivities"]
    for pkg in (sq, sqt):
        with pytest.raises(ImportError, match="spatialleiden"):
            pkg.gr.calculate_niche(adata, flavor="spatialleiden", resolutions=0.5)


@pytest.mark.parametrize(("kw", "err", "match"), [
    (dict(flavor="bogus"), ValueError, "Invalid flavor"),
    (dict(flavor="neighborhood", n_neighbors=5, resolutions=0.5), ValueError, "requires `groups`"),
    (dict(flavor="neighborhood", groups="ct", resolutions=0.5), ValueError, "requires `n_neighbors`"),
    (dict(flavor="utag", resolutions=0.5), ValueError, "requires `n_neighbors`"),
    (dict(flavor="cellcharter", aggregation="median"), ValueError, "Invalid aggregation"),
    (dict(flavor="utag", n_neighbors=5, resolutions=0.5, spatial_connectivities_key="nope"), KeyError, "nope"),
    (dict(flavor="utag", n_neighbors=5, resolutions=0.5, library_key="nope"), KeyError, "nope"),
    (dict(flavor="spatialleiden"), KeyError, "connectivities"),
])
def test_validation_errors(kw, err, match):
    adata = _domains(200)
    for pkg in (sq, sqt):
        with pytest.raises(err, match=match):
            pkg.gr.calculate_niche(adata, **kw)


def test_sdata_needs_a_table_key():
    sdata = SimpleNamespace(tables={"t": _domains(200)})
    for pkg in (sq, sqt):
        with pytest.raises(TypeError, match="table_key"):
            pkg.gr.calculate_niche(sdata, flavor="utag", n_neighbors=5, resolutions=0.5)


def test_sdata_table_is_replaced(graphs):
    tt, tj = _domains(400), _domains(400)
    st, sj = SimpleNamespace(tables={"t": tt}), SimpleNamespace(tables={"t": tj})
    kw = dict(**NHOOD, resolutions=0.5, distance=2, table_key="t")
    sqt.gr.calculate_niche(st, **kw)
    sq.gr.calculate_niche(sj, **kw)
    assert st.tables["t"] is not tt and "nhood_niche_res=0.5" not in tt.obs
    _assert_same_columns(st.tables["t"], sj.tables["t"], ["nhood_niche_res=0.5"])


class _Cat:
    def __init__(self, values: np.ndarray) -> None:
        cats, codes = np.unique(values, return_inverse=True)
        self.cat = SimpleNamespace(codes=codes.astype(np.int32), categories=list(cats))


def _duck(adata: sq.AnnData) -> SimpleNamespace:
    """The container as plain mappings and arrays: no pandas anywhere."""
    return SimpleNamespace(obs={"ct": _Cat(adata.obs["ct"].astype(str).to_numpy()),
                                "lib": _Cat(adata.obs["lib"].astype(str).to_numpy())},
                           obsp={"spatial_connectivities": adata.obsp["spatial_connectivities"]},
                           obsm={}, uns={}, X=adata.X, var_names=list(adata.var_names), raw=None)


@pytest.mark.parametrize("flavor", ["neighborhood", "utag", "cellcharter"])
def test_duck_typed_container_gets_numpy_columns(flavor):
    adata = _domains(600, seed=6)
    duck = _duck(adata)
    kw = {"neighborhood": dict(**NHOOD, resolutions=0.5, distance=2, library_key="lib"),
          "utag": dict(flavor="utag", n_neighbors=10, resolutions=0.5),
          "cellcharter": dict(flavor="cellcharter", n_components=3)}[flavor]
    sqt.gr.calculate_niche(duck, **kw)
    ref = sqt.gr.calculate_niche(adata, inplace=False, **kw)
    col = {"neighborhood": "nhood_niche_res=0.5", "utag": "utag_niche_res=0.5",
           "cellcharter": "cellcharter_niche"}[flavor]
    assert isinstance(duck.obs[col], np.ndarray) and len(duck.obs[col]) == 600
    np.testing.assert_array_equal(duck.obs[col].astype(str), ref.obs[col].astype(str).to_numpy())
    mask = np.arange(600) % 3 == 0
    out = sqt.gr.calculate_niche(duck, **{**kw, "mask": mask}, inplace=False) if flavor == "neighborhood" else None
    if out is not None:
        assert out is not duck and np.all(out.obs[col][~mask] == "not_a_niche")


def test_niche_metrics():
    adata = _domains(400)
    adata.obs["niche"] = pd.Categorical(np.where(adata.obsm["spatial"][:, 0] > 100, "a", "b"))
    np.testing.assert_array_equal(tn._fide_score(adata, "niche", False), jn._fide_score(adata, "niche", False))
    assert tn._fide_score(adata, "niche", True) == jn._fide_score(adata, "niche", True)
    assert tn._jensen_shannon_divergence(adata, "niche", "lib") == jn._jensen_shannon_divergence(adata, "niche", "lib")
