"""The port's interaction matrix and group centralities against squidpy_tpu's.

Tolerances: unweighted interaction counts are bitwise equal (K3 and the
JAX package's exact int32 counts), and so are their normalised rows (the
same float64 numpy division). Weighted sums are float64 in both packages,
summed in another order (the port's ``index_add_`` runs as float64 atomics
on the card): within 1e-12 of the sum of |terms| (with positive weights,
1e-12 relative; a normalised row, a quotient of two such sums, 2e-12).
The centralities are the
JAX package's host scipy code on the same graph: within 1e-12 relative,
with the same index and column order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.ops import nhood as tnh
from squidpy_tpu.ops import nhood as jnh

torch.set_num_threads(1)

SUM_TOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the float64 atomics run only there")


def _adata(n: int, n_cls: int, seed: int, nan_frac: float = 0.0) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_cls, n)
    codes[rng.random(n) < nan_frac] = -1
    adata = sq.AnnData(
        X=np.zeros((n, 1)),
        obs=pd.DataFrame({"cl": pd.Categorical.from_codes(codes, [f"c{i}" for i in range(n_cls)])},
                         index=[str(i) for i in range(n)]),
        var=pd.DataFrame(index=["g"]),
    )
    adata.obsm["spatial"] = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    sqt.gr.spatial_neighbors_knn(adata, n_neighs=6)
    return adata


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("nan_frac", [0.0, 0.1])
def test_interaction_matrix_unweighted_bitwise(normalized, nan_frac):
    adata = _adata(2000, 6, 1, nan_frac)
    got = sqt.gr.interaction_matrix(adata, "cl", normalized=normalized, copy=True)
    want = sq.gr.interaction_matrix(adata, "cl", normalized=normalized, copy=True)
    assert got.dtype == want.dtype == np.float64 and got.shape == (6, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalized", [False, True])
def test_interaction_matrix_weighted(normalized):
    """Positive weights, so the sum of |terms| is the sum itself: 1e-12
    relative (and for a normalised row, of its two sums)."""
    adata = _adata(2000, 5, 2, 0.05)
    # distance-derived weights: a float64 graph of irrational values
    w = adata.obsp["spatial_distances"].tocsr().copy()
    w.data = 1.0 / (1.0 + w.data)
    adata.obsp["w_connectivities"] = w
    got = sqt.gr.interaction_matrix(adata, "cl", connectivity_key="w", weights=True, normalized=normalized, copy=True)
    want = sq.gr.interaction_matrix(adata, "cl", connectivity_key="w", weights=True, normalized=normalized, copy=True)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=(2 if normalized else 1) * SUM_TOL, atol=0)


@pytest.mark.parametrize("weights", [False, True])
def test_interaction_matrix_integer_graph(weights):
    adata = _adata(1500, 4, 3)
    g = adata.obsp["spatial_connectivities"].tocsr().astype(np.int64)
    g.data = np.random.default_rng(0).integers(1, 5, g.nnz)
    adata.obsp["int_connectivities"] = g
    got = sqt.gr.interaction_matrix(adata, "cl", connectivity_key="int", weights=weights, copy=True)
    want = sq.gr.interaction_matrix(adata, "cl", connectivity_key="int", weights=weights, copy=True)
    assert np.issubdtype(got.dtype, np.integer) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_interaction_matrix_writes_uns():
    adata = _adata(800, 3, 4)
    assert sqt.gr.interaction_matrix(adata, "cl") is None
    got = adata.uns["cl_interactions"]
    sq.gr.interaction_matrix(adata, "cl")
    np.testing.assert_array_equal(got, adata.uns["cl_interactions"])


def test_interaction_matrix_nan_only_raises():
    adata = _adata(300, 3, 5)
    adata.obs["nan"] = pd.Categorical.from_codes(np.full(adata.n_obs, -1), ["a", "b"])
    for mod in (sqt, sq):
        with pytest.raises(RuntimeError, match="none remain"):
            mod.gr.interaction_matrix(adata, "nan", copy=True)


@pytest.mark.parametrize("n_cls", [1, 7])
def test_weighted_cluster_pair_counts_match_jax(n_cls):
    rng = np.random.default_rng(n_cls)
    n, k = 3000, 8
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.8
    w = np.where(mask, rng.random((n, k)), 0.0)
    labels = rng.integers(0, n_cls, n).astype(np.int32)
    want = np.asarray(jnh.cluster_pair_counts(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(labels), n_cls,
                                              weights=jnp.asarray(w)))
    got = tnh.cluster_pair_counts(torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(labels), n_cls,
                                  weights=torch.from_numpy(w))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    terms = np.zeros((n_cls, n_cls))
    np.add.at(terms, (np.broadcast_to(labels[:, None], (n, k))[mask], labels[idx][mask]), np.abs(w[mask]))
    assert np.all(np.abs(got.numpy() - want) <= SUM_TOL * terms)


@pytest.mark.parametrize("score", [None, "closeness_centrality", ["average_clustering", "degree_centrality"]])
def test_centrality_scores_match_jax(score):
    adata = _adata(1500, 5, 6, 0.05)
    got = sqt.gr.centrality_scores(adata, "cl", score=score, copy=True)
    want = sq.gr.centrality_scores(adata, "cl", score=score, copy=True)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got.index, np.asarray(want.index))
    for name, col in got.columns.items():
        np.testing.assert_allclose(col, want[name].to_numpy(), rtol=1e-12, atol=0)


def test_centrality_scores_writes_uns():
    adata = _adata(600, 3, 7)
    assert sqt.gr.centrality_scores(adata, "cl") is None
    got = adata.uns["cl_centrality_scores"]
    assert isinstance(got, sqt.gr.CentralityResult)
    assert list(got.columns) == ["degree_centrality", "average_clustering", "closeness_centrality"]
    with pytest.raises(ValueError, match="Invalid option"):
        sqt.gr.centrality_scores(adata, "cl", score="betweenness", copy=True)


@pytest.mark.cuda
def test_weighted_counts_on_card(cuda_card):
    rng = np.random.default_rng(0)
    n, k, n_cls = 100_000, 8, 16
    idx = torch.from_numpy(rng.integers(0, n, (n, k)).astype(np.int32))
    mask = torch.from_numpy(rng.random((n, k)) < 0.9)
    w = torch.from_numpy(rng.random((n, k)))
    labels = torch.from_numpy(rng.integers(0, n_cls, n).astype(np.int32))
    want = tnh.cluster_pair_counts(idx, mask, labels, n_cls, weights=w)
    got = tnh.cluster_pair_counts(idx.cuda(), mask.cuda(), labels.cuda(), n_cls, weights=w.cuda()).cpu()
    assert torch.all((got - want).abs() <= SUM_TOL * want.abs())
