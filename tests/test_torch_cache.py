"""``cache=`` of ``nhood_enrichment`` and ``spatial_autocorr`` against the JAX
package's memoization (``squidpy_torch/utils/_memoize.py``).

The digest of a call is the JAX package's for the same arrays and
parameters, so both packages name a call's entry alike (each under its own
directory); a second seeded call reads the entry back and gives the same
result bitwise; without a seed the cache is off with a warning; a corrupt
entry is computed again and rewritten. Every cache lives under ``tmp_path``.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.gr import _nhood, _ppatterns
from squidpy_torch.utils import _memoize as tmemo
from squidpy_tpu.utils import _memoize as jmemo

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _adata(n: int = 1500, n_genes: int = 6, seed: int = 0, sparse: bool = False) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, (n, n_genes)).astype(np.float32)
    adata = sq.AnnData(
        X=sp.csr_matrix(x) if sparse else x,
        obs=pd.DataFrame({"cl": pd.Categorical.from_codes(rng.integers(0, 4, n), list("abcd")),
                          "lib": pd.Categorical.from_codes(rng.integers(0, 2, n), ["s0", "s1"])},
                         index=[str(i) for i in range(n)]),
        var=pd.DataFrame(index=[f"g{i}" for i in range(n_genes)]),
    )
    adata.obsm["spatial"] = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    return adata


def _entries(path) -> list[str]:
    return sorted(p.name for p in path.rglob("*.npz"))


@pytest.mark.parametrize("seed", [0, 1])
def test_cache_key_matches_jax(seed):
    rng = np.random.default_rng(seed)
    arrays = {"b": rng.integers(0, 9, 50).astype(np.int8), "a": rng.random((7, 3)),
              "c": sp.csr_matrix(rng.random((4, 4))).indptr}
    params = {"seed": seed, "n_perms": 100, "transformation": True}
    assert tmemo.cache_key("op", arrays, params) == jmemo.cache_key("op", arrays, params)
    assert tmemo.cache_key("op", arrays, {**params, "seed": seed + 1}) != tmemo.cache_key("op", arrays, params)


def test_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SQUIDPY_TORCH_CACHE", str(tmp_path / "env"))
    assert tmemo.resolve_cache_dir(True) == tmp_path / "env"
    assert tmemo.resolve_cache_dir(str(tmp_path)) == tmp_path
    assert tmemo.resolve_cache_dir(False) is None


@pytest.mark.parametrize("library", [False, True], ids=["no libraries", "library_key"])
def test_nhood_cache(library, tmp_path, monkeypatch):
    adata = _adata(seed=3)
    kw = dict(n_perms=50, seed=4, copy=True, library_key="lib" if library else None)
    want = sq.gr.nhood_enrichment(adata, "cl", cache=str(tmp_path / "jax"), **kw)
    first = sqt.gr.nhood_enrichment(adata, "cl", cache=str(tmp_path / "torch"), **kw)
    assert _entries(tmp_path / "torch") == _entries(tmp_path / "jax") and len(_entries(tmp_path / "torch")) == 1
    np.testing.assert_array_equal(first.zscore, want.zscore)

    def fail(*args, **kwargs):
        raise AssertionError("the permutations ran again")

    monkeypatch.setattr(_nhood, "_permuted_counts", fail)
    again = sqt.gr.nhood_enrichment(adata, "cl", cache=str(tmp_path / "torch"), **kw)
    np.testing.assert_array_equal(again.zscore, first.zscore)
    np.testing.assert_array_equal(again.counts, first.counts)


def test_nhood_cache_without_seed_is_off(tmp_path, caplog):
    adata = _adata(seed=5)
    with caplog.at_level(logging.WARNING):
        sqt.gr.nhood_enrichment(adata, "cl", n_perms=5, cache=str(tmp_path), copy=True)
    assert "requires an explicit `seed`" in caplog.text
    assert _entries(tmp_path) == []


def test_nhood_cache_true_uses_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("SQUIDPY_TORCH_CACHE", str(tmp_path))
    sqt.gr.nhood_enrichment(_adata(seed=6), "cl", n_perms=5, seed=0, cache=True, copy=True)
    assert len(_entries(tmp_path / "nhood_enrichment")) == 1


def test_nhood_corrupt_entry_is_rewritten(tmp_path):
    adata = _adata(seed=7)
    kw = dict(n_perms=20, seed=1, copy=True, cache=str(tmp_path))
    first = sqt.gr.nhood_enrichment(adata, "cl", **kw)
    (entry,) = list(tmp_path.rglob("*.npz"))
    entry.write_bytes(b"not an npz file")
    again = sqt.gr.nhood_enrichment(adata, "cl", **kw)
    np.testing.assert_array_equal(again.zscore, first.zscore)
    with np.load(entry) as z:
        assert z["perms"].shape == (20, 4, 4)


@pytest.mark.parametrize("mode,sparse", [("moran", False), ("geary", True)])
def test_autocorr_cache(mode, sparse, tmp_path, monkeypatch):
    adata = _adata(seed=8, sparse=sparse)
    kw = dict(mode=mode, n_perms=30, seed=2, copy=True)
    want = sq.gr.spatial_autocorr(adata, cache=str(tmp_path / "jax"), **kw)
    first = sqt.gr.spatial_autocorr(adata, cache=str(tmp_path / "torch"), **kw)
    assert _entries(tmp_path / "torch") == _entries(tmp_path / "jax") and len(_entries(tmp_path / "torch")) == 1
    np.testing.assert_array_equal(first.index, want.index.to_numpy())

    def fail(*args, **kwargs):
        raise AssertionError("the scores ran again")

    monkeypatch.setattr(_ppatterns, "moran_perm_scores", fail)
    monkeypatch.setattr(_ppatterns, "geary_perm_scores", fail)
    again = sqt.gr.spatial_autocorr(adata, cache=str(tmp_path / "torch"), **kw)
    np.testing.assert_array_equal(again.index, first.index)
    for col, vals in first.columns.items():
        np.testing.assert_array_equal(again.columns[col], vals)


def test_autocorr_cache_without_seed(tmp_path, caplog):
    """Permutations without a seed turn the cache off with a warning; the
    scores alone need no seed and are cached."""
    adata = _adata(seed=9)
    with caplog.at_level(logging.WARNING):
        sqt.gr.spatial_autocorr(adata, n_perms=5, cache=str(tmp_path), copy=True)
    assert "requires an explicit `seed`" in caplog.text and _entries(tmp_path) == []
    sqt.gr.spatial_autocorr(adata, cache=str(tmp_path), copy=True)
    assert len(_entries(tmp_path / "spatial_autocorr_moran")) == 1


def test_autocorr_corrupt_entry_is_rewritten(tmp_path):
    adata = _adata(seed=10)
    kw = dict(mode="geary", n_perms=10, seed=3, copy=True, cache=str(tmp_path))
    first = sqt.gr.spatial_autocorr(adata, **kw)
    (entry,) = list(tmp_path.rglob("*.npz"))
    entry.write_bytes(b"\x00" * 10)
    again = sqt.gr.spatial_autocorr(adata, **kw)
    for col, vals in first.columns.items():
        np.testing.assert_array_equal(again.columns[col], vals)
    with np.load(entry) as z:
        assert set(z.files) == {"score", "sims"}


def test_autocorr_cache_skips_large_expression(tmp_path, caplog, monkeypatch):
    """An expression matrix above 512 MB is not fingerprinted: the cache is
    off with a warning (the limit lowered here to the test matrix's size)."""
    adata = _adata(n=300, seed=11)
    assert _ppatterns.CACHE_MAX_BYTES == 512e6
    monkeypatch.setattr(_ppatterns, "CACHE_MAX_BYTES", adata.X.nbytes - 1)
    with caplog.at_level(logging.WARNING):
        sqt.gr.spatial_autocorr(adata, n_perms=3, seed=0, cache=str(tmp_path), copy=True)
    assert "too large to fingerprint" in caplog.text and _entries(tmp_path) == []
