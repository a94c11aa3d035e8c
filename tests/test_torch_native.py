"""squidpy_torch's native Leiden, Louvain and kNN symmetrisation against squidpy_tpu's.

Tolerance: bitwise. The port builds copies of the JAX package's
``louvain.cpp`` and ``knngraph.cpp`` with the same g++ flags; in ISO C++
mode g++ contracts no multiply-add, so one CSR gives the same labels from
both libraries.
"""

from __future__ import annotations

import numpy as np
import pytest
from scipy import sparse as sp
from scipy.spatial import cKDTree

import squidpy_torch.native as tnat
import squidpy_tpu.native as jnat


def _blob_knn(n: int, n_blobs: int, k: int, spread: float, seed: int, weighted: bool = False) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    gx = int(np.ceil(np.sqrt(n_blobs)))
    centers = np.array([[10.0 * (i % gx), 10.0 * (i // gx)] for i in range(n_blobs)])
    pts = centers[rng.integers(0, n_blobs, size=n)] + rng.normal(0, spread, size=(n, 2))
    _, idx = cKDTree(pts).query(pts, k=k + 1)
    w = rng.uniform(0.2, 3.0, n * k) if weighted else np.ones(n * k)
    adj = sp.csr_matrix((w, (np.repeat(np.arange(n), k), idx[:, 1:].ravel())), shape=(n, n))
    return adj.maximum(adj.T).tocsr()


def _random_graph(n: int, m: int, seed: int) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = rows != cols
    adj = sp.csr_matrix((np.ones(keep.sum()), (rows[keep], cols[keep])), shape=(n, n))
    return adj.maximum(adj.T).tocsr()


GRAPHS = {
    "blobs": lambda: _blob_knn(3000, 7, 8, 1.5, 0),
    "blobs_weighted": lambda: _blob_knn(2000, 5, 10, 0.8, 1, weighted=True),
    "sparse_noise": lambda: _random_graph(3000, 12_000, 9),
    "tight_blobs": lambda: _blob_knn(5000, 20, 6, 0.15, 5),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize(("resolution", "seed"), [(1.0, 0), (0.5, 42), (2.0, 7)])
def test_leiden_bitwise(graph, resolution, seed):
    adj = GRAPHS[graph]()
    lt, kt = tnat.leiden_csr(adj, resolution=resolution, seed=seed)
    lj, kj = jnat.leiden_csr(adj, resolution=resolution, seed=seed)
    assert kt == kj and lt.dtype == lj.dtype
    np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("n_iterations", [-1, 1, 2, 5])
def test_leiden_iterations_bitwise(n_iterations):
    adj = GRAPHS["blobs"]()
    np.testing.assert_array_equal(tnat.leiden_csr(adj, seed=3, n_iterations=n_iterations)[0],
                                  jnat.leiden_csr(adj, seed=3, n_iterations=n_iterations)[0])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("max_levels", [1, 32])
def test_louvain_bitwise(graph, max_levels):
    adj = GRAPHS[graph]()
    lt, kt = tnat.louvain_csr(adj, resolution=0.8, seed=11, max_levels=max_levels)
    lj, kj = jnat.louvain_csr(adj, resolution=0.8, seed=11, max_levels=max_levels)
    assert kt == kj
    np.testing.assert_array_equal(lt, lj)


def test_singletons_and_empty():
    adj = sp.csr_matrix((5, 5))
    for fn in ("leiden_csr", "louvain_csr"):
        lt, kt = getattr(tnat, fn)(adj)
        lj, kj = getattr(jnat, fn)(adj)
        assert kt == kj
        np.testing.assert_array_equal(lt, lj)
    assert tnat.leiden_csr(sp.csr_matrix((0, 0)))[1] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_symmetrize_knn_bitwise(seed):
    rng = np.random.default_rng(seed)
    n, k = 2000, 15
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    idx[::7, 0] = np.arange(0, n, 7)  # self entries are ignored
    idx[::11, 1] = -1  # so are entries outside [0, n)
    idx[::13, 2] = n
    idx[5, :] = idx[5, 0]  # duplicates collapse
    at, aj = tnat.symmetrize_knn(idx, n), jnat.symmetrize_knn(idx, n)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(at, name), getattr(aj, name))
    assert at.shape == aj.shape == (n, n) and (at != at.T).nnz == 0


def test_symmetrize_knn_rejects_bad_tables():
    with pytest.raises(ValueError, match="2D neighbor table"):
        tnat.symmetrize_knn(np.zeros(4, dtype=np.int32))
    with pytest.raises(ValueError, match="3 rows for 4 nodes"):
        tnat.symmetrize_knn(np.zeros((3, 2), dtype=np.int32), 4)


def test_library_is_built_into_the_build_directory():
    so = tnat.ensure_built()
    assert so.parent.name == "_build" and so.parent.parent.name == "squidpy_torch"
    assert so.name.startswith("libsquidpy_torch_native_") and so.exists()
    assert tnat.ensure_built() == so  # keyed by the sources' hash: built once
