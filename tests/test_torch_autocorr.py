"""squidpy_torch spatial autocorrelation against squidpy_tpu's.

The JAX package runs here as its own suite runs it: on the CPU with x64, so
its scores are float64; the port computes in float32. Tolerances:

- sort shuffles (``permutation_batch``), degree buckets and the device
  expression blocks are bitwise equal;
- an ELL sum or permuted numerator ``sum_t term_t`` is held to
  ``1e-5 * sum_t |term_t|`` per gene (float32 inputs and sums against
  float64: a few float32 roundings of the terms' magnitude; a relative
  tolerance is meaningless for Moran numerators near 0), ``u = W z`` to
  that bound per element;
- public scores likewise (the bound carried through the normalisation),
  p-values to rtol 1e-3 (smooth functions of the scores, whose float32
  error they amplify by up to |z|), ``pval_sim`` exactly (no permuted score
  lies within float32 error of its observed score in these fixtures, so the
  tail counts agree), ``var_norm`` exactly (host float64 from the same CSR).
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
from squidpy_torch._core import device_x as tdx
from squidpy_torch._core import rng as trng
from squidpy_torch._core.graph import SpatialGraph as TGraph
from squidpy_torch.ops import autocorr as tac
from squidpy_tpu._core import device_x as jdx
from squidpy_tpu._core import rng as jrng
from squidpy_tpu._core.graph import SpatialGraph as JGraph
from squidpy_tpu.ops import autocorr as jac

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _skewed_graph(n: int, seed: int = 0) -> sp.csr_matrix:
    """Radius-graph-like adjacency: most rows ~6 neighbours, a hub core ~60."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        k = 60 if i < n // 20 else 6
        nbrs = rng.choice(n - 1, size=k, replace=False)
        rows += [i] * k
        cols += list(nbrs + (nbrs >= i))
    g = sp.csr_matrix((rng.uniform(0.5, 1.5, len(rows)), (rows, cols)), shape=(n, n))
    g.sum_duplicates()
    return g


def _knn_graph(n: int, seed: int) -> sp.csr_matrix:
    adata = _adata(n, 1, seed)
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    return sp.csr_matrix(adata.obsp["spatial_connectivities"])


def _adata(n: int, n_genes: int, seed: int, *, sparse: bool = False) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    x = rng.poisson(rng.uniform(0.5, 4.0, n_genes), size=(n, n_genes)).astype(np.float32)
    x[:, 0] += np.linspace(0.0, 3.0, n, dtype=np.float32)  # one gene with a spatial trend
    adata = sq.AnnData(
        X=sp.csr_matrix(x) if sparse else x,
        obs=pd.DataFrame({"area": rng.uniform(10, 50, n), "count": rng.integers(0, 9, n),
                          "cl": pd.Categorical(rng.integers(0, 3, n).astype(str))},
                         index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=[f"gene_{i}" for i in range(n_genes)]),
    )
    coords = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    adata.obsm["spatial"] = coords
    adata.obsm["pcs"] = rng.normal(size=(n, 3)) + coords[:, :1] / coords.max()
    return adata


def _abs_bound(terms_abs: np.ndarray) -> np.ndarray:
    return 1e-5 * terms_abs


# -- keys and shuffles -----------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 100, 1625, 1626, 3000, 20_000])
def test_permutation_batch_matches_jax(n):
    """Bitwise: the same threefry words and stable sorts on both sides (so
    even tied words order the same); 1625/1626 straddle JAX's switch from one
    sort round to two."""
    keys = trng.spawn_keys(7, 5)
    want = np.asarray(jrng.permutation_batch(jnp.asarray(keys), jnp.arange(n)))
    got = trng.permutation_batch(keys, n, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.shape == (5, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_keys_match_jax():
    import jax

    keys = trng.spawn_keys(3, 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jnp.asarray(keys)))
    np.testing.assert_array_equal(trng.split_keys(keys, 3), want)


# -- graph -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_degree_buckets_match_jax(dtype):
    g = _skewed_graph(400)
    want = JGraph.from_csr(g, dtype=dtype).degree_buckets()
    got = TGraph.from_csr(g, dtype=dtype).degree_buckets()
    assert got is not None and len(got) == len(want) >= 2
    for parts_t, parts_j in zip(got, want):
        for t, j in zip(parts_t, parts_j):
            assert t.numpy().dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_degree_buckets_none_on_knn_graph():
    g = _knn_graph(500, seed=1)
    assert JGraph.from_csr(g).degree_buckets() is None
    assert TGraph.from_csr(g).degree_buckets() is None


# -- ops: K5a and K5b plain versions ----------------------------------------


def _ops_inputs(skewed: bool, seed: int = 0):
    csr = _skewed_graph(600, seed) if skewed else _knn_graph(600, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.poisson(2.0, size=(csr.shape[0], 9)).astype(np.float32) + rng.normal(size=(csr.shape[0], 9)).astype(
        np.float32)
    return csr, x, float(csr.sum())


def _graphs(csr):
    return TGraph.from_csr(csr, dtype=np.float32), JGraph.from_csr(csr, dtype=np.float64)


@pytest.mark.parametrize("skewed", [False, True])
def test_spmv_genes_match_jax(skewed):
    csr, x, _ = _ops_inputs(skewed)
    tg, jg = _graphs(csr)
    want = np.asarray(jac.spmv_genes(jg.indices, jg.weights, jnp.asarray(x, dtype=jnp.float64)))
    got = tac.spmv_genes(tg.indices, tg.weights, torch.from_numpy(x)).numpy()
    bound = _abs_bound(abs(csr) @ np.abs(x.astype(np.float64)))
    assert np.all(np.abs(got - want) <= bound)
    if skewed:
        got_b = tac.spmv_genes_bucketed(tg.degree_buckets(), torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got_b, got)  # the same slot-by-slot sums, row by row


def _terms_abs_moran(csr, x):
    z = np.abs(x - x.mean(axis=0))
    return np.sum(z * (abs(csr) @ z), axis=0)


def _terms_abs_geary(csr, x):
    coo = csr.tocoo()
    return np.abs(coo.data) @ (x[coo.row] - x[coo.col]) ** 2


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("mode", ["moran", "geary"])
def test_scores_match_jax(mode, bucketed):
    csr, x, s0 = _ops_inputs(skewed=True, seed=2)
    tg, jg = _graphs(csr)
    x64 = x.astype(np.float64)
    if bucketed:
        tb, jb = tg.degree_buckets(), jg.degree_buckets()
        fn_t, fn_j = getattr(tac, f"{mode}_scores_bucketed"), getattr(jac, f"{mode}_scores_bucketed")
        got = fn_t(tb, torch.from_numpy(x), s0).numpy()
        want = np.asarray(fn_j(jb, jnp.asarray(x64), jnp.asarray(s0)))
    else:
        fn_t, fn_j = getattr(tac, f"{mode}_scores"), getattr(jac, f"{mode}_scores")
        got = fn_t(tg.indices, tg.weights, torch.from_numpy(x), s0).numpy()
        want = np.asarray(fn_j(jg.indices, jg.weights, jnp.asarray(x64), jnp.asarray(s0)))
    n = x.shape[0]
    den = np.sum((x64 - x64.mean(axis=0)) ** 2, axis=0)
    if mode == "moran":
        scale, terms = n / s0 / den, _terms_abs_moran(csr, x64)
    else:
        scale, terms = (n - 1) / (2 * s0) / den, _terms_abs_geary(csr, x64)
    assert np.all(np.abs(got - want) <= scale * _abs_bound(terms) + 1e-5 * np.abs(want)), (got, want)


@pytest.mark.parametrize("layout", ["rows", "columns"])
@pytest.mark.parametrize("mode", ["moran", "geary"])
def test_perm_scores_match_jax(mode, layout):
    """``perms`` as a (P, n) table or as the transposed view of an (n, P)
    table (the cipher's layout) give the same sims."""
    csr, x, s0 = _ops_inputs(skewed=False, seed=3)
    tg, _ = _graphs(csr)
    n = x.shape[0]
    x64 = x.astype(np.float64)
    z64 = x64 - x64.mean(axis=0)
    u64 = csr @ z64
    z, u = torch.from_numpy(z64.astype(np.float32)), torch.from_numpy(u64.astype(np.float32))
    perms = trng.permutation_batch(trng.spawn_keys(0, 12), n, torch.device("cpu"))
    perms_t = perms if layout == "rows" else perms.T.contiguous().T
    r64 = np.asarray(csr.sum(axis=1)).ravel()
    c64 = np.asarray(csr.sum(axis=0)).ravel()
    pj = jnp.asarray(perms.numpy())
    if mode == "moran":
        want = np.asarray(jac.moran_perm_scores(jnp.asarray(z64), jnp.asarray(u64), pj, jnp.asarray(s0)))
        got = tac.moran_perm_scores(z, u, perms_t, s0).numpy()
        terms = np.stack([np.sum(np.abs(z64) * np.abs(u64[p]), axis=0) for p in perms.numpy()])
        scale = n / s0 / np.sum(z64 * z64, axis=0)
    else:
        cg64 = np.sum(c64[:, None] * z64 * z64, axis=0)
        want = np.asarray(jac.geary_perm_scores(jnp.asarray(z64), jnp.asarray(u64), jnp.asarray(r64),
                                                jnp.asarray(cg64), pj, jnp.asarray(s0)))
        cg = torch.sum(torch.from_numpy(c64.astype(np.float32))[:, None] * (z * z), dim=0)
        got = tac.geary_perm_scores(z, u, torch.from_numpy(r64.astype(np.float32)), cg, perms_t, s0).numpy()
        terms = np.stack([np.sum(np.abs(z64) * (np.abs(z64) * r64[p, None] + 2 * np.abs(u64[p])), axis=0)
                          for p in perms.numpy()]) + cg64
        scale = (n - 1) / (2 * s0) / np.sum(z64 * z64, axis=0)
    assert got.shape == want.shape == (12, x.shape[1])
    assert np.all(np.abs(got - want) <= scale * _abs_bound(terms) + 1e-5 * np.abs(want))


def test_ell_and_perm_modes_reject_unknown():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="ELL mode"):
        tac.ell_autocorr("fast", torch.zeros((4, 1), dtype=torch.int32), torch.zeros((4, 1)), x)
    with pytest.raises(ValueError, match="permutation mode"):
        tac.perm_autocorr("fast", x, x, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="row sums"):
        tac.perm_autocorr("moran", x, x, torch.zeros((1, 4), dtype=torch.int32), torch.zeros(4))


# -- device expression ------------------------------------------------------


@pytest.mark.parametrize("kind", ["u8", "u16", "float", "sparse_u8", "sparse_float"])
def test_device_expression_blocks_match_jax(kind):
    rng = np.random.default_rng(4)
    x = rng.poisson(3.0, size=(300, 20)).astype(np.float32)
    if kind == "u16":
        x[0, 0] = 40_000
    elif kind.endswith("float"):
        x = x + 0.25
    if kind.startswith("sparse"):
        x[x < 3] = 0
        x = sp.csr_matrix(x)
    names = [f"g{i}" for i in range(20)]
    th, jh = tdx.DeviceExpression(x, names, torch.device("cpu")), jdx.DeviceExpression(x, names)
    for cols in (np.arange(20), np.arange(3, 9), np.array([7, 2, 19, 2])):
        np.testing.assert_array_equal(th.dense_block(cols).numpy(), np.asarray(jh.dense_block(cols)))
    assert th.dense_block(np.arange(4)).dtype == torch.float32
    container = {"u8": torch.uint8, "u16": torch.int16, "float": torch.float32, "sparse_u8": torch.uint8,
                 "sparse_float": torch.float32}[kind]
    assert (th._dense if not kind.startswith("sparse") else th._data).dtype == container


def test_device_expression_cache_and_invalidation():
    adata = _adata(200, 6, seed=5)
    h1 = tdx.device_expression(adata)
    assert tdx.device_expression(adata) is h1 and h1.ship_count == 1
    adata.X[:] = adata.X + 1.0  # in-place mutation changes the fingerprint
    h2 = tdx.device_expression(adata)
    assert h2 is not h1
    adata.X = adata.X.copy()  # a new object
    assert tdx.device_expression(adata, create=False) is None
    assert h2.columns_of(["gene_1", "gene_0"]).tolist() == [1, 0]
    assert h2.columns_of(["nope"]) is None


# -- public API ---------------------------------------------------------------


def _assert_frames_agree(res, df, stat, bound):
    assert list(res.index) == list(df.index)
    assert list(res.columns) == list(df.columns)
    for col in df.columns:
        want, got = df[col].to_numpy(dtype=np.float64), res.columns[col]
        assert got.shape == want.shape
        if col == stat:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            ok = ~np.isnan(want)
            assert np.all(np.abs(got - want)[ok] <= bound[ok] + 1e-5 * np.abs(want[ok])), col
        elif col in ("var_norm", "pval_sim") or col.startswith("pval_sim_"):
            np.testing.assert_array_equal(got, want, err_msg=col)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-12, err_msg=col)


def _score_bound(adata, res, mode, transformation, attr, layer=None):
    """``1e-5 * sum |terms|`` of each row's statistic, through its normalisation."""
    g = sp.csr_matrix(adata.obsp["spatial_connectivities"], dtype=np.float64)
    if transformation:
        rs = np.asarray(g.sum(axis=1)).ravel()
        g = sp.csr_matrix(sp.diags(np.divide(1.0, rs, out=np.zeros_like(rs), where=rs != 0)) @ g)
    n, s0 = g.shape[0], float(g.sum())
    if attr == "X":
        names = list(adata.var_names)
        x = np.asarray(sp.csr_matrix(adata.X).todense())[:, [names.index(i) for i in res.index]]
    elif attr == "obs":
        x = np.column_stack([np.asarray(adata.obs[c]) for c in res.index])
    else:
        x = np.asarray(adata.obsm[layer])[:, list(res.index)]
    x = x.astype(np.float64)
    den = np.sum((x - x.mean(axis=0)) ** 2, axis=0)
    if mode == "moran":
        return n / s0 / den * _abs_bound(_terms_abs_moran(g, x))
    return (n - 1) / (2 * s0) / den * _abs_bound(_terms_abs_geary(g, x))


CASES = [
    # mode, n_perms, transformation, two_tailed, corr_method, attr, sparse
    ("moran", None, True, False, "fdr_bh", "X", False),
    ("moran", 20, True, False, "fdr_bh", "X", True),
    ("moran", 20, False, True, "bonferroni", "X", False),
    ("geary", None, True, False, "fdr_bh", "X", True),
    ("geary", 20, False, False, None, "X", False),
    ("geary", 20, True, True, "holm", "X", True),
    ("moran", 20, True, False, "fdr_bh", "obs", False),
    ("geary", None, True, False, "fdr_bh", "obsm", False),
]


@pytest.mark.parametrize("mode,n_perms,transformation,two_tailed,corr_method,attr,sparse", CASES)
def test_spatial_autocorr_matches_jax(mode, n_perms, transformation, two_tailed, corr_method, attr, sparse):
    adata = _adata(3000, 14, seed=6, sparse=sparse)
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    kw = dict(mode=mode, n_perms=n_perms, transformation=transformation, two_tailed=two_tailed,
              corr_method=corr_method, attr=attr, seed=0, copy=True)
    if attr == "obsm":
        kw["layer"] = "pcs"
    df = sq.gr.spatial_autocorr(adata, **kw)
    res = sqt.gr.spatial_autocorr(adata, **kw)
    assert isinstance(res, sqt.gr.AutocorrResult)
    stat = "I" if mode == "moran" else "C"
    bound = _score_bound(adata, res, mode, transformation, attr, kw.get("layer"))
    _assert_frames_agree(res, df, stat, bound)


@pytest.mark.parametrize("mode", ["moran", "geary"])
def test_spatial_autocorr_cipher_path_matches_jax(mode):
    """At 70k cells both packages shuffle with the keyed index cipher (K4)."""
    adata = _adata(70_000, 6, seed=7, sparse=True)
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    df = sq.gr.spatial_autocorr(adata, mode=mode, n_perms=20, seed=1, copy=True)
    res = sqt.gr.spatial_autocorr(adata, mode=mode, n_perms=20, seed=1, copy=True)
    stat = "I" if mode == "moran" else "C"
    _assert_frames_agree(res, df, stat, _score_bound(adata, res, mode, True, "X"))


def test_spatial_autocorr_skewed_graph_and_uns():
    """A skewed graph takes the bucketed passes; the result lands in uns."""
    adata = _adata(1000, 5, seed=8)
    adata.obsp["spatial_connectivities"] = _skewed_graph(1000, seed=2)
    for mode, key in (("moran", "moranI"), ("geary", "gearyC")):
        df = sq.gr.spatial_autocorr(adata, mode=mode, n_perms=10, seed=0, copy=True)
        assert sqt.gr.spatial_autocorr(adata, mode=mode, n_perms=10, seed=0) is None
        res = adata.uns[key]
        stat = "I" if mode == "moran" else "C"
        _assert_frames_agree(res, df, stat, _score_bound(adata, res, mode, True, "X"))


def test_spatial_autocorr_genes_raw_and_nan_rows():
    """A gene subset in a given order, ``use_raw``, and a constant gene,
    whose 0/0 score sorts last as in pandas."""
    adata = _adata(500, 8, seed=9)
    adata.X[:, 3] = 2.0
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    genes = ["gene_5", "gene_3", "gene_0", "gene_1"]
    for mode in ("moran", "geary"):
        df = sq.gr.spatial_autocorr(adata, genes=genes, mode=mode, copy=True)
        res = sqt.gr.spatial_autocorr(adata, genes=genes, mode=mode, copy=True)
        assert list(res.index) == list(df.index) and res.index[-1] == "gene_3"
    from squidpy_tpu._core.anndata import Raw

    adata.raw = Raw(adata)
    df = sq.gr.spatial_autocorr(adata, use_raw=True, copy=True)
    res = sqt.gr.spatial_autocorr(adata, use_raw=True, copy=True)
    assert list(res.index) == list(df.index)


def test_sort_order_is_pandas_sort_values():
    rng = np.random.default_rng(0)
    vals = np.round(rng.normal(size=200), 1)  # many ties
    vals[[3, 50, 51]] = np.nan
    for ascending in (True, False):
        want = pd.DataFrame({"s": vals}).sort_values(by="s", ascending=ascending).index.to_numpy()
        np.testing.assert_array_equal(sqt.gr._ppatterns._sort_order(vals, ascending), want)


def test_spatial_autocorr_argument_errors():
    adata = _adata(100, 3, seed=10)
    sq.gr.spatial_neighbors_knn(adata, n_neighs=4)
    with pytest.raises(NotImplementedError, match="cache"):
        sqt.gr.spatial_autocorr(adata, cache=True)
    with pytest.raises(ValueError, match="Invalid option"):
        sqt.gr.spatial_autocorr(adata, mode="ripley")
    with pytest.raises(NotImplementedError, match="adata.layers"):
        sqt.gr.spatial_autocorr(adata, attr="layers")
    with pytest.raises(KeyError, match="obsm"):
        sqt.gr.spatial_autocorr(adata, attr="obsm", layer="nope")
    with pytest.raises(ValueError, match="positive"):
        sqt.gr.spatial_autocorr(adata, n_perms=0)
    with pytest.raises(KeyError, match="connectivity"):
        sqt.gr.spatial_autocorr(adata, connectivity_key="nope")


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_card):
    csr, x, s0 = _ops_inputs(skewed=True, seed=11)
    tg = TGraph.from_csr(csr, dtype=np.float32)
    with sqt.set_device("cuda"):
        tgc = TGraph.from_csr(csr, dtype=np.float32)
        xc = torch.from_numpy(x).cuda()
        np.testing.assert_array_equal(tac.spmv_genes(tgc.indices, tgc.weights, xc).cpu().numpy(),
                                      tac._ell_plain("spmv", tg.indices, tg.weights, torch.from_numpy(x), None).numpy())
        for mode in ("moran", "geary"):
            got = tac.ell_autocorr(mode, tgc.indices, tgc.weights, xc).cpu().numpy()
            want = tac._ell_plain(mode, tg.indices, tg.weights, torch.from_numpy(x), None).numpy()
            terms = (_terms_abs_moran(csr, x) if mode == "moran" else _terms_abs_geary(csr, x))
            assert np.all(np.abs(got - want) <= _abs_bound(terms) + 1e-6 * np.abs(want))
        perms = trng.permutation_batch(trng.spawn_keys(0, 40), x.shape[0], torch.device("cuda"))
        r = xc[:, 0].abs().contiguous()
        for mode in ("moran", "geary"):
            rr = r if mode == "geary" else None
            got = tac.perm_autocorr(mode, xc, xc, perms, rr)
            want = tac._perm_plain(mode, xc, xc, rr, perms)
            scale = tac._perm_plain(mode, xc.abs(), -xc.abs() if mode == "geary" else xc.abs(), rr, perms)
            assert bool(((got - want).abs() <= 1e-5 * scale.abs()).all())


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
