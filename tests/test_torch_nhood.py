"""squidpy_torch pair counts and neighbourhood enrichment against squidpy_tpu's.

Tolerances: counts are bitwise equal; z-scores are equal including NaN
positions (the same float64 numpy arithmetic on equal integers). The
sort-based shuffles below MIN_CIPHER_N are held statistically, to the exact
permutation-null moments. The CUDA kernel (K3) is held to the plain version
on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.gr._nhood import _permuted_counts
from squidpy_torch.ops import nhood as tnh
from squidpy_tpu.ops import nhood as jnh

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _masked_ell(n: int, k: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = rng.random((n, k)) < 0.8
    return idx, mask


@pytest.mark.parametrize("n_cls", [1, 16, 40])
def test_permuted_pair_counts_cols_match_jax(n_cls):
    n, k, P = 3000, 8, 7
    idx, mask = _masked_ell(n, k, n_cls)
    cols = np.random.default_rng(1).integers(0, n_cls, (n, P)).astype(np.uint8)
    want = np.asarray(jnh.permuted_pair_counts_cols(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(cols), n_cls))
    got = tnh.permuted_pair_counts_cols(torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(cols), n_cls)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_cls", [1, 16, 40])
def test_cluster_pair_counts_match_jax(n_cls):
    n, k = 3000, 8
    idx, mask = _masked_ell(n, k, 2 * n_cls)
    labels = np.random.default_rng(2).integers(0, n_cls, n).astype(np.int32)
    want = np.asarray(jnh.cluster_pair_counts(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(labels), n_cls))
    got = tnh.cluster_pair_counts(torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(labels), n_cls)
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_of_range_labels_count_nothing():
    idx = torch.tensor([[1], [0]], dtype=torch.int32)
    mask = torch.ones((2, 1), dtype=torch.bool)
    labels = torch.tensor([0, 255], dtype=torch.uint8)[:, None]
    assert int(tnh.pair_counts_cols(idx, mask, labels, labels, 3).sum()) == 0


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


@pytest.fixture(scope="module")
def adata_70k() -> sq.AnnData:
    adata = _adata(70_000, 8, seed=0)
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)  # n > 50k: the host cKDTree, shared by both packages
    return adata


@pytest.mark.parametrize("mode", ["perm", "analytic"])
def test_nhood_enrichment_matches_jax_cipher_path(adata_70k, mode):
    want = sq.gr.nhood_enrichment(adata_70k, "cl", n_perms=20, seed=4, mode=mode, copy=True)
    got = sqt.gr.nhood_enrichment(adata_70k, "cl", n_perms=20, seed=4, mode=mode, copy=True)
    assert got.counts.dtype == want.counts.dtype == np.uint32
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.zscore, want.zscore)  # NaN positions included


def test_nhood_enrichment_writes_uns(adata_70k):
    sqt.gr.nhood_enrichment(adata_70k, "cl", n_perms=3, seed=0)
    res = adata_70k.uns["cl_nhood_enrichment"]
    assert set(res) == {"zscore", "count"} and res["zscore"].shape == (8, 8)


def test_sort_path_matches_null_moments():
    """Below MIN_CIPHER_N: permuted counts from the sorted threefry words match
    the exact permutation-null mean and variance."""
    adata = _adata(3000, 3, seed=1)
    sqt.gr.spatial_neighbors_knn(adata, n_neighs=4)
    adj = adata.obsp["spatial_connectivities"]
    codes = np.asarray(adata.obs["cl"].cat.codes, dtype=np.int32)
    graph = sqt._core.graph_from_adata(adata, "spatial_connectivities")
    P = 300
    perms = _permuted_counts(graph, torch.from_numpy(codes), codes, 3, P, seed=2)
    assert np.all(perms.sum(axis=(1, 2)) == adj.nnz)
    mean, var = tnh.analytic_pair_count_moments(adj, np.bincount(codes, minlength=3))
    z_mean = (perms.mean(0) - mean) / np.sqrt(var / P)
    assert np.abs(z_mean).max() < 4.5, z_mean
    ratio = perms.var(0) / var
    assert ratio.min() > 0.6 and ratio.max() < 1.6, ratio


def test_unported_options_raise(adata_70k):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sqt.gr.nhood_enrichment(adata_70k, "cl", library_key="cl")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sqt.gr.nhood_enrichment(adata_70k, "cl", cache=True, seed=0)


@pytest.mark.parametrize("n_cols,n_cls", [(1, 4), (5, 16), (64, 16), (500, 16), (16, 200), (3, 400)])
def test_k3_layout(n_cols, n_cls):
    p_blk, row_blocks, shared = tnh._k3_layout(1_000_000, n_cols, n_cls)
    assert 256 % p_blk == 0 and row_blocks >= 1
    assert shared == (p_blk * n_cls * n_cls * 4 <= tnh._K3_SMEM_BYTES)
    assert shared or p_blk == 1


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    for n_cls, dtype in ((16, torch.uint8), (200, torch.uint8), (300, torch.int32)):
        idx, mask = _masked_ell(20_000, 8, n_cls)
        cols = torch.randint(0, n_cls, (20_000, 37), dtype=dtype).cuda()
        idx_d, mask_d = torch.from_numpy(idx).cuda(), torch.from_numpy(mask).cuda()
        got = tnh.pair_counts_cols(idx_d, mask_d, cols, cols, n_cls)
        assert torch.equal(got, tnh._pair_counts_plain(idx_d, mask_d, cols, cols, n_cls))


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
