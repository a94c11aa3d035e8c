"""squidpy_torch graph layer against squidpy_tpu's (``_core/graph.py``, kNN builder).

Tolerances: ELL arrays and the cKDTree kNN graph (n > 50k) are bitwise
equal. The brute-force kNN (n <= 50k) ranks by expanded-form f32 squared
distances, whose error is a few ulps of max |p|^2 in both packages, so its
distances are held to rtol 1e-6 and its neighbour sets must be equal except
in rows whose k-th and (k+1)-th distances are tied to within that error.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp
from scipy.spatial import cKDTree

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch._core.graph import SpatialGraph, graph_from_adata
from squidpy_torch.ops.knn import brute_force_knn
from squidpy_tpu._core.graph import SpatialGraph as JaxSpatialGraph
from squidpy_tpu.ops.knn import brute_force_knn as jax_brute_force_knn

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _adata(n: int, seed: int) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    adata = sq.AnnData(
        X=np.zeros((n, 1)),
        obs=pd.DataFrame({"cl": pd.Categorical.from_codes(rng.integers(0, 4, n), list("abcd"))},
                         index=[str(i) for i in range(n)]),
        var=pd.DataFrame(index=["g"]),
    )
    adata.obsm["spatial"] = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    return adata


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_from_csr_matches_jax(dtype):
    rng = np.random.default_rng(0)
    n = 300
    adj = sp.random(n, n, density=0.03, random_state=1, format="csr")
    adj.data = (adj.data * 10).astype(dtype)
    dst = adj.copy().astype(np.float64)
    dst.data = rng.uniform(0, 5, dst.nnz)
    got = SpatialGraph.from_csr(adj, dst)
    want = JaxSpatialGraph.from_csr(adj, dst)
    for field in ("indices", "weights", "mask", "distances"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.k_max % 8 == 0 and got.nnz == adj.nnz


def test_from_csr_distances_with_other_pattern():
    adj = sp.csr_matrix(np.array([[0, 1, 1], [1, 0, 0], [1, 1, 0]], dtype=np.float32))
    dst = sp.csr_matrix(np.array([[0, 2.0, 0], [3.0, 0, 0], [4.0, 5.0, 0]]))  # an explicit zero dropped
    got = SpatialGraph.from_csr(adj, dst).distances.numpy()
    np.testing.assert_array_equal(got, np.asarray(JaxSpatialGraph.from_csr(adj, dst).distances))


def test_graph_cache_follows_the_csr_object():
    adata = _adata(500, 0)
    sqt.gr.spatial_neighbors_knn(adata)
    g1 = graph_from_adata(adata, "spatial_connectivities")
    assert graph_from_adata(adata, "spatial_connectivities") is g1
    sqt.gr.spatial_neighbors_knn(adata, n_neighs=4)
    g2 = graph_from_adata(adata, "spatial_connectivities")
    assert g2 is not g1 and int(g2.mask.sum(1).max()) == 4


def _near_tie_rows(coords: np.ndarray, k: int, rows: np.ndarray) -> np.ndarray:
    """Rows whose k-th and (k+1)-th squared distances lie within the expanded
    form's error bound (16 ulps of max |p|^2)."""
    d, _ = cKDTree(coords).query(coords[rows], k=k + 2)  # self + k + 1
    tol = 16 * np.finfo(np.float32).eps * float((coords.astype(np.float64) ** 2).sum(1).max())
    return np.abs(d[:, k + 1] ** 2 - d[:, k] ** 2) <= tol


@pytest.mark.parametrize("n", [2000, 60_000])  # brute force, then cKDTree
def test_spatial_neighbors_knn_matches_jax(n):
    a, b = _adata(n, 1), _adata(n, 1)
    sq.gr.spatial_neighbors_knn(a, n_neighs=6)
    sqt.gr.spatial_neighbors_knn(b, n_neighs=6)
    assert a.uns["spatial_neighbors"] == b.uns["spatial_neighbors"]
    ca, cb = a.obsp["spatial_connectivities"], b.obsp["spatial_connectivities"]
    differ = np.flatnonzero(np.asarray((ca != cb).sum(axis=1)).ravel())
    if n > 50_000:
        assert differ.size == 0
        assert (a.obsp["spatial_distances"] != b.obsp["spatial_distances"]).nnz == 0
    else:
        coords = np.asarray(a.obsm["spatial"], np.float32)
        assert _near_tie_rows(coords, 6, differ).all(), differ
        same = np.setdiff1d(np.arange(n), differ)
        np.testing.assert_allclose(
            b.obsp["spatial_distances"][same].toarray(), a.obsp["spatial_distances"][same].toarray(), rtol=1e-6
        )


def test_brute_force_knn_matches_jax():
    coords = np.random.default_rng(3).uniform(0, 400, (3000, 2)).astype(np.float32)
    d_t, i_t = brute_force_knn(coords, 5, row_tile=256)
    d_j, i_j = jax_brute_force_knn(coords, 5)
    assert i_t.dtype == np.int32
    same = (np.sort(i_t, 1) == np.sort(i_j, 1)).all(1)
    assert _near_tie_rows(coords, 5, np.flatnonzero(~same)).all()
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_brute_force_knn_roots_are_correctly_rounded(dim):
    """The brute force's distances are the correctly rounded float32 roots
    of their difference-form ``d2`` (numpy's, as the card's), bit for bit,
    and still agree with the JAX package's to rtol 1e-6."""
    coords = np.random.default_rng(8).uniform(0, 300, (4000, dim)).astype(np.float32)
    d_t, i_t = brute_force_knn(coords, 6, row_tile=512)
    diff = coords[i_t] - coords[:, None, :]
    d2 = diff[..., 0] * diff[..., 0]
    for a in range(1, dim):
        d2 = d2 + diff[..., a] * diff[..., a]
    np.testing.assert_array_equal(d_t, np.sqrt(d2))
    d_j, i_j = jax_brute_force_knn(coords, 6)
    same = (np.sort(i_t, 1) == np.sort(i_j, 1)).all(1)
    assert _near_tie_rows(coords, 6, np.flatnonzero(~same)).all()
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-6)


def test_knn_rejects_k_at_least_n():
    with pytest.raises(ValueError, match="n_neighs"):
        brute_force_knn(np.zeros((4, 2), np.float32), 4)


@pytest.mark.parametrize("n_jobs", [1, 2])
def test_library_key_graph_matches_jax(n_jobs):
    a, b = _adata(1200, 2), _adata(1200, 2)
    libs = pd.Categorical.from_codes(np.random.default_rng(5).integers(0, 3, 1200), ["s1", "s2", "s3"])
    a.obs["lib"], b.obs["lib"] = libs, libs
    sq.gr.spatial_neighbors_knn(a, n_neighs=5, library_key="lib", n_jobs=n_jobs)
    sqt.gr.spatial_neighbors_knn(b, n_neighs=5, library_key="lib", n_jobs=n_jobs)
    ca, cb = a.obsp["spatial_connectivities"], b.obsp["spatial_connectivities"]
    assert (ca != cb).nnz == 0
    codes = libs.codes
    assert all(codes[i] == codes[j] for i, j in zip(*cb.nonzero()))
    np.testing.assert_allclose(b.obsp["spatial_distances"].data, a.obsp["spatial_distances"].data, rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_row_normalize_spmv_and_to_csr_match_jax(weighted):
    """``row_normalize``, ``spmv`` (a matrix through K5a's plain version, and
    a vector) and ``to_csr`` against the JAX package's, float32. The
    normalised weights are bitwise on binary graphs (exact row sums), and
    on weighted ones within 4 ulps (each package sums a row in its own
    order); the products within 1e-6 (XLA on the CPU fuses ``w * x`` into
    the sum's adds, K5a rounds each)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 300
    pts = rng.uniform(0, 100, (n, 2))
    _, nb = cKDTree(pts).query(pts, k=7)
    w = rng.uniform(0.5, 2.0, n * 6) if weighted else np.ones(n * 6)
    adj = sp.csr_matrix((w, (np.repeat(np.arange(n), 6), nb[:, 1:].ravel())), shape=(n, n))
    adj = adj.maximum(adj.T).tocsr()
    x = rng.normal(size=(n, 5)).astype(np.float32)
    gt = SpatialGraph.from_csr(adj, dtype=np.float32).row_normalize()
    gj = JaxSpatialGraph.from_csr(adj, dtype=jnp.float32).row_normalize()
    tol = {} if not weighted else dict(rtol=4 * np.finfo(np.float32).eps)
    assert_close = np.testing.assert_allclose if weighted else np.testing.assert_array_equal
    assert_close(gt.weights.numpy(), np.asarray(gj.weights), **tol)
    mat_t, mat_j = gt.spmv(torch.from_numpy(x)).numpy(), np.asarray(gj.spmv(jnp.asarray(x)))
    vec_t, vec_j = gt.spmv(torch.from_numpy(x[:, 0])).numpy(), np.asarray(gj.spmv(jnp.asarray(x[:, 0])))
    np.testing.assert_allclose(mat_t, mat_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vec_t, vec_j, rtol=1e-6, atol=1e-6)
    at, _ = gt.to_csr()
    aj, _ = gj.to_csr()
    assert (at != aj).nnz == 0 or np.allclose(at.toarray(), aj.toarray(), rtol=4 * np.finfo(np.float32).eps)
    assert at.shape == (n, n) and at.nnz == adj.nnz
