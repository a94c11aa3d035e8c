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
    """``library_key`` and ``cache`` are ported; what still raises is the
    JAX package's own error: a ``library_key`` needs ``mode='perm'``, and a
    library column must be categorical."""
    adata_70k.obs["lib"] = pd.Categorical(np.arange(70_000) % 3)
    with pytest.raises(ValueError, match="requires `mode='perm'`"):
        sqt.gr.nhood_enrichment(adata_70k, "cl", library_key="lib", mode="analytic")
    with pytest.raises(ValueError, match="requires `mode='perm'`"):
        sq.gr.nhood_enrichment(adata_70k, "cl", library_key="lib", mode="analytic")
    adata_70k.obs["lib_int"] = np.arange(70_000) % 3
    with pytest.raises(TypeError, match="categorical"):
        sqt.gr.nhood_enrichment(adata_70k, "cl", library_key="lib_int", n_perms=2, seed=0)


def _libraries(n: int, sizes: list[int], seed: int, nan: int = 0) -> pd.Categorical:
    codes = np.repeat(np.arange(len(sizes)), sizes)
    assert len(codes) == n
    np.random.default_rng(seed).shuffle(codes)
    codes[:nan] = -1
    return pd.Categorical.from_codes(codes, [f"s{i}" for i in range(len(sizes))])


@pytest.mark.parametrize("n,sizes,nan", [(3000, [1000, 1700, 300], 0), (3000, [2999, 1], 4),
                                          (70_000, [30_000, 25_000, 15_000], 0)],
                         ids=["three sections", "a one-cell section and NaN", "70k cells (no cipher)"])
def test_nhood_enrichment_library_key_matches_jax(n, sizes, nan, adata_70k):
    """Within-library shuffles: counts and z-scores bitwise the JAX
    package's, 1003 permutations (a padded tail chunk), NaN libraries
    their own group; at 70k cells neither package takes the cipher."""
    if n == 70_000:
        adata = adata_70k
    else:
        adata = _adata(n, 5, seed=n + nan)
        sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    adata.obs["lib"] = _libraries(n, sizes, seed=7, nan=nan)
    perms = 1003 if n < 10_000 else 40
    want = sq.gr.nhood_enrichment(adata, "cl", library_key="lib", n_perms=perms, seed=3, copy=True)
    got = sqt.gr.nhood_enrichment(adata, "cl", library_key="lib", n_perms=perms, seed=3, copy=True)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.zscore, want.zscore)
    plain = sqt.gr.nhood_enrichment(adata, "cl", n_perms=perms, seed=3, copy=True)
    assert not np.array_equal(plain.zscore, got.zscore, equal_nan=True)  # the libraries change the null


def test_library_order_is_made_once(monkeypatch):
    """The group order is made once a call, not once a 500-permutation chunk."""
    from squidpy_torch.gr import _nhood

    adata = _adata(2000, 4, seed=5)
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    adata.obs["lib"] = _libraries(2000, [1200, 800], seed=1)
    calls = []
    real = _nhood.group_layout
    monkeypatch.setattr(_nhood, "group_layout", lambda g: calls.append(1) or real(g))
    sqt.gr.nhood_enrichment(adata, "cl", library_key="lib", n_perms=1200, seed=0, copy=True)
    assert len(calls) == 1


@pytest.mark.parametrize("n_cols,n_cls", [(1, 4), (5, 16), (64, 16), (500, 16), (16, 200), (3, 400)])
def test_k3_layout(n_cols, n_cls):
    lay = tnh._k3_layout(1_000_000, n_cols, n_cls, 8)
    assert lay.row_blocks >= 1 and (lay.row_blocks - 1) * lay.rows_per_block < 1_000_000
    assert lay.row_blocks * lay.rows_per_block >= 1_000_000
    if lay.branch == "packed":
        assert lay.cols_per_block == 128 and lay.rows_per_block * 8 <= 65_535
        assert lay.blocks == lay.row_blocks * -(-n_cols // 128)
    else:
        assert 256 % lay.cols_per_block == 0
        fits = lay.cols_per_block * n_cls * n_cls * 4 <= tnh._K3_SMEM_BYTES
        assert lay.branch == ("shared" if fits else "global")
        assert fits or lay.cols_per_block == 1


@pytest.mark.parametrize("n_cols,n_cls,branch", [(1, 16, "shared"), (7, 16, "shared"), (500, 16, "packed"),
                                                 (64, 17, "shared"), (16, 200, "global"), (3, 400, "global"),
                                                 (32, 16, "packed"), (31, 16, "shared"), (33, 1, "packed")])
def test_k3_branch(n_cols, n_cls, branch):
    """Packed for C <= 16 and P >= 32, whatever n and k_max (shapes only)."""
    for n, k_max in ((1_000_000, 8), (3_000, 6), (1, 1)):
        assert tnh._k3_layout(n, n_cols, n_cls, k_max).branch == branch


@pytest.mark.parametrize("n", [1, 31, 5_000, 1_000_000, 3_244_001, 2**31 - 1])
@pytest.mark.parametrize("k_max", [1, 6, 8, 16, 64, 1_000])
@pytest.mark.parametrize("sms", [132, 114])
def test_k3_packed_rows_bound(n, k_max, sms):
    """No packed counter can pass 65,535: a block's rows x k_max stay within
    it; the rows cover n; the last wave of resident blocks is at least 80%
    full, unless the grid spans more than 10 waves or n runs out of rows."""
    lay = tnh._k3_layout(n, 500, 16, k_max, sms)
    assert lay.branch == "packed"
    assert lay.rows_per_block * k_max <= 65_535
    assert lay.row_blocks * lay.rows_per_block >= n > (lay.row_blocks - 1) * lay.rows_per_block
    resident = tnh._K3_PACKED_RESIDENT * sms
    waves = -(-lay.blocks // resident)
    assert lay.rows_per_block == 1 or waves > 10 or lay.blocks - (waves - 1) * resident >= 0.8 * resident


def test_k3_packed_rows_reach_the_bound():
    """The overflow shape of the card tests: all labels 0 and every slot set,
    so one block's bin (0, 0) holds rows x k_max = 65,472 counts per column,
    and each column's total passes 65,535 only across blocks."""
    n, k_max = 3 * 132 * (65_535 // 64), 64
    lay = tnh._k3_layout(n, 32, 16, k_max, 132)
    assert lay == tnh.K3Layout("packed", 128, 396, 1_023, 396)
    assert 65_535 - k_max < lay.rows_per_block * k_max <= 65_535 < n * k_max


@pytest.mark.parametrize("n_cols", [33, 500])
def test_permuted_pair_counts_wide_columns_match_jax(n_cols):
    """Column counts that leave a partial last column block (33 of 128, 500 of
    4 x 128) on the card's packed branch: the plain version against JAX."""
    n, k = 1_500, 8
    idx, mask = _masked_ell(n, k, n_cols)
    cols = np.random.default_rng(n_cols).integers(0, 16, (n, n_cols)).astype(np.uint8)
    want = np.asarray(jnh.permuted_pair_counts_cols(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(cols), 16))
    got = tnh.permuted_pair_counts_cols(torch.from_numpy(idx), torch.from_numpy(mask), torch.from_numpy(cols), 16)
    np.testing.assert_array_equal(got.numpy(), want)


def _card_cases(sms: int):
    """(name, n, k, P, C, labels drawn below, dtype, mask density, branch):
    every branch, aligned and unaligned packed loads, k_max not a multiple
    of 8, labels outside [0, C), and the overflow shape."""
    return [
        ("packed uint8", 20_000, 8, 36, 16, 18, torch.uint8, 0.8, "packed"),
        ("packed unaligned, C=5", 20_000, 8, 33, 5, 5, torch.uint8, 0.8, "packed"),
        ("packed k=13, 3 column blocks", 9_000, 13, 300, 16, 16, torch.uint8, 0.8, "packed"),
        ("packed int32", 20_000, 8, 36, 16, 18, torch.int32, 0.8, "packed"),
        ("packed int32 unaligned", 20_000, 8, 37, 16, 18, torch.int32, 0.8, "packed"),
        ("shared P=1 int32", 20_000, 8, 1, 16, 16, torch.int32, 0.8, "shared"),
        ("shared P=7", 20_000, 8, 7, 16, 17, torch.uint8, 0.8, "shared"),
        ("shared C=40", 20_000, 8, 37, 40, 40, torch.uint8, 0.8, "shared"),
        ("global C=200", 20_000, 8, 16, 200, 200, torch.uint8, 0.8, "global"),
        ("global C=300 int32", 20_000, 8, 37, 300, 300, torch.int32, 0.8, "global"),
        ("overflow: all labels 0", 3 * sms * (65_535 // 64), 64, 32, 16, 1, torch.uint8, 1.0, "packed"),
    ]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, n, k, n_cols, n_cls, hi, dtype, density, branch in _card_cases(sms):
        idx = torch.randint(0, n, (n, k), generator=g, device="cuda", dtype=torch.int32)
        mask = torch.rand((n, k), generator=g, device="cuda") < density
        cols = torch.randint(-1 if dtype == torch.int32 else 0, hi, (n, n_cols), generator=g, device="cuda").to(dtype)
        stats: dict = {}
        got = tnh.pair_counts_cols(idx, mask, cols, cols, n_cls, stats=stats)
        assert stats["branch"] == branch, name
        assert torch.equal(got, tnh._pair_counts_plain(idx, mask, cols, cols, n_cls)), name
        if name.startswith("overflow"):
            assert stats["rows_per_block"] * k > 65_535 - k and int(got[0, 0, 0]) == n * k


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
