"""``calculate_niche``'s clustering graphs past the exact search: the IVF
path of ``models/clustering.py`` ``knn_graph`` in both packages, with
``_EXACT_KNN_MAX_N`` monkeypatched below the fixtures (no file of either
package changes).

Tolerances. With ``_IVF_RECALL_FLOOR`` monkeypatched above 1, both
packages take their fallback, the full sweep: exact in both on the CPU, so
the clustering graphs are equal on fixtures free of near ties at the k-th
neighbour (asserted through the graphs, as ``test_torch_niche.py`` does)
and the labels bitwise. On the IVF path each package builds its own index
(the ranking and sum orders of ``test_torch_ivf_knn.py``), so the labels
are held to JAX's by the adjusted Rand index, at least :data:`ARI_FLOOR`.
The neighbourhood profiles hold duplicate rows, whose exact ties the two
full sweeps break apart: there the graphs differ only by such swaps
(asserted) and the labels are held by :data:`ARI_TIES_FLOOR`.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score
from test_torch_ivf_knn import _uniform
from test_torch_niche import NHOOD, _assert_same_graphs, _both, _domains, _x64_off, graphs  # noqa: F401

import squidpy_torch as sqt
from squidpy_torch.models import clustering as tcl
from squidpy_torch.ops import ivf_knn as tivf
from squidpy_torch.ops import knn as tknn
from squidpy_tpu.models import clustering as jcl
from squidpy_tpu.ops import knn as jknn

torch.set_num_threads(1)

ARI_FLOOR = 0.9  # 1.0 on these fixtures
# Leiden on graphs a few swapped copies apart (the neighborhood fallback):
# 0.875 on this fixture
ARI_TIES_FLOOR = 0.8
CALLS = {"neighborhood": dict(**NHOOD, resolutions=[0.5], distance=3, n_hop_weights=[1, 0.5, 0.25]),
         "utag": dict(flavor="utag", n_neighbors=15, resolutions=[0.5])}
COLUMN = {"neighborhood": "nhood_niche_res=0.5", "utag": "utag_niche_res=0.5"}


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


@pytest.fixture()
def ivf_path(monkeypatch):
    """Both packages' clustering graphs from the IVF index at test size."""
    for mod in (tcl, jcl):
        monkeypatch.setattr(mod, "_EXACT_KNN_MAX_N", 100)


@pytest.fixture()
def fallback(monkeypatch, ivf_path):
    """Both packages past the IVF's recall check: the full sweep."""
    for mod in (tcl, jcl):
        monkeypatch.setattr(mod, "_IVF_RECALL_FLOOR", 1.5)


def test_knn_graph_fallback_matches_jax(fallback, caplog):
    X = _uniform(1500, 8, seed=0)  # asserted free of near ties at the 10th neighbour in test_torch_ivf_knn.py
    with caplog.at_level(logging.INFO, logger=tcl.logger.name):
        got = tcl.knn_graph(X, 10)
    assert "falling back to the full sweep" in caplog.text
    want = jcl.knn_graph(X, 10)
    assert got.shape == want.shape and (got != want).nnz == 0


def test_knn_graph_ivf_path(ivf_path, monkeypatch):
    """Above the recall floor the graph is the IVF's, symmetrised; no fallback."""
    X = _uniform(1500, 8, seed=0)
    monkeypatch.setattr("squidpy_torch.ops.knn.brute_force_knn_approx", None)  # the fallback would fail
    got = tcl.knn_graph(X, 10)
    _, idx = tivf.ivf_knn(X, 10, return_distances=False)
    assert tivf.sampled_recall(X, idx, 10) >= tcl._IVF_RECALL_FLOOR
    from squidpy_torch.native import symmetrize_knn

    assert (got != symmetrize_knn(idx, 1500)).nnz == 0


@pytest.mark.parametrize("k", [8, 10], ids=["at the lists' limit: IVF", "past it: exact"])
def test_knn_graph_past_the_ivf_lists_is_exact(ivf_path, monkeypatch, caplog, k):
    """Past the IVF kernels' lists (``_MAX_K``, emulated at 8 here) the
    graph is K12's exact one, whatever the size; up to it, the IVF's."""
    from squidpy_torch.native import symmetrize_knn

    X = _uniform(1500, 8, seed=0)
    monkeypatch.setattr(tivf, "_MAX_K", 8)
    calls = []
    real = tivf.ivf_knn
    monkeypatch.setattr(tivf, "ivf_knn", lambda *a, **kw: calls.append(a[1]) or real(*a, **kw))
    with caplog.at_level(logging.INFO, logger=tcl.logger.name):
        got = tcl.knn_graph(X, k)
    if k > 8:
        assert not calls and "past the IVF kernels' lists" in caplog.text
        want = symmetrize_knn(tknn.feature_knn(torch.from_numpy(X), k)[1].numpy(), len(X))
        assert (got != want).nnz == 0
    else:
        assert calls == [k] and "past the IVF" not in caplog.text


@pytest.mark.cuda
def test_knn_graph_past_the_ivf_lists_on_card(monkeypatch):
    """On the card, ``n_neighbors`` past the IVF kernels' 32 takes K12's
    exact search above ``_EXACT_KNN_MAX_N`` instead of raising."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K12 has no CPU mode")
    from squidpy_torch.native import symmetrize_knn

    monkeypatch.setattr(tcl, "_EXACT_KNN_MAX_N", 100)
    X = torch.from_numpy(_uniform(3000, 16, seed=0)).cuda()
    k = tivf._MAX_K + 8
    got = tcl.knn_graph(X, k)
    want = symmetrize_knn(tknn.feature_knn(X, k)[1].cpu().numpy(), len(X))
    assert (got != want).nnz == 0


@pytest.mark.parametrize("library", [False, True])
def test_utag_fallback_labels_bitwise(fallback, graphs, library):
    adata = _domains(seed=1)
    with _x64_off():
        rt, rj = _both(adata, **CALLS["utag"], library_key="lib" if library else None)
    _assert_same_graphs(graphs)
    np.testing.assert_array_equal(rt.obs[COLUMN["utag"]].astype(str).to_numpy(),
                                  rj.obs[COLUMN["utag"]].astype(str).to_numpy())


def test_neighborhood_fallback_differs_only_at_duplicate_rows(fallback, monkeypatch):
    """The neighbourhood profiles hold duplicate rows, so a k-th neighbour
    can tie exactly between copies: the port's full sweep (K12) takes the
    lowest index, JAX's (``approx_min_k``, the exact top k on the CPU) the
    highest (ROADMAP.md queue 3). Every row whose neighbours differ swaps a
    copy for a copy of higher index, and the labels stay near JAX's."""
    adata = _domains()
    seen = {"torch": [], "jax": []}
    for name, mod in (("torch", tcl), ("jax", jcl)):
        def spy(X, k, real=mod.knn_graph, name=name):
            seen[name].append(np.asarray(X, np.float32))
            return real(X, k)

        monkeypatch.setattr(mod, "knn_graph", spy)
    rt, rj = _both(adata, **CALLS["neighborhood"])
    X = seen["torch"][0]
    _, it = tknn.feature_knn(torch.from_numpy(X), 15)
    _, ij = jknn.brute_force_knn_approx(seen["jax"][0], 15)
    rows = [r for r in range(len(X)) if set(it[r].tolist()) != set(ij[r].tolist())]
    assert rows, "fixture: no exact tie between copies"
    for r in rows:
        gone, came = set(it[r].tolist()) - set(ij[r].tolist()), set(ij[r].tolist()) - set(it[r].tolist())
        assert all(any(np.array_equal(X[a], X[b]) and a < b for a in gone) for b in came)
    ari = adjusted_rand_score(rj.obs[COLUMN["neighborhood"]].astype(str), rt.obs[COLUMN["neighborhood"]].astype(str))
    assert ari >= ARI_TIES_FLOOR, ari


@pytest.mark.parametrize("flavor", ["neighborhood", "utag"])
def test_calculate_niche_ivf_labels_near_jax(ivf_path, flavor):
    adata = _domains()
    with _x64_off() if flavor == "utag" else contextlib.nullcontext():
        rt, rj = _both(adata, **CALLS[flavor])
    ari = adjusted_rand_score(rj.obs[COLUMN[flavor]].astype(str), rt.obs[COLUMN[flavor]].astype(str))
    assert ari >= ARI_FLOOR, ari
