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


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


def _to_jax(t: torch.Tensor):
    """A bf16 tensor as a JAX bf16 array with the same bits."""
    return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))


def _bf16_band(x: np.ndarray) -> np.ndarray:
    return _bf16(x).double().numpy()


@pytest.mark.parametrize("normalized", [True, False], ids=["s0=n", "s0!=n"])
@pytest.mark.parametrize("mode", ["moran", "geary"])
def test_perm_scores_bf16_match_jax(mode, normalized):
    """At n = 2^19 the null's operands are bf16, as the JAX package gathers
    them with ``gather_bf16=True, z_bf16=True``. Tolerance: each side's
    float32 numerator lies within ``1e-6 * sum |terms|`` of the exact sum over
    the bf16 operands, so the two may differ only where that band straddles a
    bf16 rounding boundary (by the band's bf16 width, carried through the
    scaling), plus 1e-6 relative for the float32 denominator and scaling."""
    n, g, n_perms = 1 << 19, 5, 3
    rng = np.random.default_rng(12)
    k = 4
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, rows.size)
    csr = sp.csr_matrix((rng.uniform(0.5, 1.5, rows.size), (rows, cols)), shape=(n, n))
    if normalized:
        csr = sp.csr_matrix(sp.diags(1.0 / np.asarray(csr.sum(axis=1)).ravel()) @ csr)
    s0 = float(csr.sum())
    x = rng.poisson(rng.uniform(0.3, 3.0, g), size=(n, g)).astype(np.float32)
    z32 = x - x.mean(axis=0, dtype=np.float32)
    u32 = (csr @ z32.astype(np.float64)).astype(np.float32)
    r32 = np.asarray(csr.sum(axis=1), np.float32).ravel()
    zb, ub, rb = _bf16(z32), _bf16(u32), _bf16(r32)
    perms_np = np.stack([rng.permutation(n) for _ in range(n_perms)]).astype(np.int32)
    perms = torch.from_numpy(perms_np)
    zq, uq, rq = zb.double().numpy(), ub.double().numpy(), rb.double().numpy()
    den = np.sum(zq * zq, axis=0)
    if mode == "moran":
        want = np.asarray(jac.moran_perm_scores(_to_jax(zb), _to_jax(ub), jnp.asarray(perms_np), s0,
                                                gather_bf16=True, z_bf16=True))
        got = tac.moran_perm_scores(zb, ub, perms, s0).numpy()
        exact = np.stack([np.sum(zq * uq[p], axis=0) for p in perms_np])
        terms = np.stack([np.sum(np.abs(zq * uq[p]), axis=0) for p in perms_np])
        scale_b = _bf16_band(np.float32(n) / np.float32(s0))
        lo = _bf16_band(_bf16_band(exact - 1e-6 * terms) * scale_b)
        hi = _bf16_band(_bf16_band(exact + 1e-6 * terms) * scale_b)
        tol = (hi - lo) / den + 1e-6 * np.abs(want)
    else:
        cg = torch.sum(torch.from_numpy(np.asarray(csr.sum(axis=0), np.float32).ravel())[:, None]
                       * torch.from_numpy(z32) ** 2, dim=0)
        want = np.asarray(jac.geary_perm_scores(_to_jax(zb), _to_jax(ub), jnp.asarray(r32), jnp.asarray(cg.numpy()),
                                                jnp.asarray(perms_np), s0, gather_bf16=True, z_bf16=True))
        got = tac.geary_perm_scores(zb, ub, rb, cg, perms, s0).numpy()
        exact = np.stack([np.sum(zq * (zq * rq[p, None] - 2 * uq[p]), axis=0) for p in perms_np])
        terms = np.stack([np.sum(np.abs(zq) * (np.abs(zq) * rq[p, None] + 2 * np.abs(uq[p])), axis=0)
                          for p in perms_np])
        lo, hi = _bf16_band(exact - 1e-6 * terms), _bf16_band(exact + 1e-6 * terms)
        scale = (n - 1) / (2 * s0) / den
        tol = (hi - lo) * scale + 1e-6 * scale * (np.abs(exact) + np.abs(cg.numpy().astype(np.float64)))
    assert got.dtype == np.float32 and got.shape == want.shape == (n_perms, g)
    # the band is one bf16 value in most entries, where the two must agree to
    # float32 scaling: an unrounded float32 numerator would fail there
    assert np.mean(hi == lo) >= 0.5
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol), (got, want)


@pytest.mark.parametrize("n,mode", [((1 << 19) - 1, "moran"), (1 << 19, "moran"), (1 << 19, "geary")])
def test_spatial_autocorr_switches_to_bf16_at_min_n(n, mode, monkeypatch):
    """The null's operands turn bf16 exactly at ``BF16_GATHER_MIN_N`` cells;
    scores and Geary's third term stay float32."""
    from squidpy_torch._constants._constants import BF16_GATHER_MIN_N
    from squidpy_torch.gr import _ppatterns as tpp

    assert BF16_GATHER_MIN_N == 1 << 19
    seen = {}
    name = f"{mode}_perm_scores"
    real = getattr(tpp, name)

    def spy(*args, **kw):
        seen["dtypes"] = [a.dtype for a in args if isinstance(a, torch.Tensor)]
        return real(*args, **kw)

    monkeypatch.setattr(tpp, name, spy)
    rng = np.random.default_rng(13)
    rows = np.repeat(np.arange(n), 3)
    adj = sp.csr_matrix((np.ones(rows.size), (rows, rng.integers(0, n, rows.size))), shape=(n, n))
    adata = sq.AnnData(X=rng.poisson(1.0, size=(n, 2)).astype(np.float32),
                       var=pd.DataFrame(index=["gene_0", "gene_1"]))
    adata.obsp["spatial_connectivities"] = adj
    res = sqt.gr.spatial_autocorr(adata, mode=mode, n_perms=2, seed=0, copy=True)
    want = torch.bfloat16 if n >= BF16_GATHER_MIN_N else torch.float32
    tensors = seen["dtypes"][:-1] if mode == "moran" else seen["dtypes"][:3]  # z, u (, r); then perms (, cg)
    assert tensors == [want] * len(tensors)
    if mode == "geary":
        assert seen["dtypes"][3] == torch.float32  # cg
    assert np.all(np.isfinite(res.columns["var_sim"]))


# -- the locality walk of K5a -------------------------------------------------


def _points(dim: int, kind: str, n: int = 4000) -> np.ndarray:
    rng = np.random.default_rng(dim * 10 + len(kind))
    if kind == "uniform":
        return rng.uniform(0.0, 10 * np.sqrt(n), (n, dim))
    if kind == "ties":  # few distinct cells, many equal codes
        return rng.integers(0, 6, (n, dim)).astype(np.float64)
    if kind == "coincident":  # every point repeated, in scattered positions
        pts = np.repeat(rng.normal(size=(n // 8, dim)), 8, axis=0)
        return pts[rng.permutation(len(pts))]
    return rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)  # float32 coordinates


@pytest.mark.parametrize("kind", ["uniform", "ties", "coincident", "float32"])
@pytest.mark.parametrize("dim", [2, 3])
def test_morton_order_matches_morton_argsort(dim, kind):
    """The walk's torch Morton order equals ``ops/pairbins.py``
    ``morton_argsort`` (both packages' copies) bitwise: the same float64
    quantisation, bit interleave and stable sort."""
    from squidpy_torch._core.graph import morton_order
    from squidpy_torch.ops.pairbins import morton_argsort as t_morton
    from squidpy_tpu.ops.pairbins import morton_argsort as j_morton

    pts = _points(dim, kind)
    got = morton_order(torch.from_numpy(pts))
    assert got.dtype == torch.int32 and got.shape == (len(pts),)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_morton(pts)))
    np.testing.assert_array_equal(got.numpy(), t_morton(pts))


def _walked_inputs(bucketed: bool, seed: int = 14):
    csr, x, s0 = _ops_inputs(skewed=bucketed, seed=seed)
    coords = np.random.default_rng(seed).uniform(0.0, 100.0, (csr.shape[0], 2))
    from squidpy_torch._core.graph import morton_order, walk_buckets

    tg = TGraph.from_csr(csr, dtype=np.float32)
    buckets = tg.degree_buckets()
    assert (buckets is not None) == bucketed
    walk = morton_order(torch.from_numpy(coords))
    return tg, buckets, walk_buckets(buckets, walk) if bucketed else None, walk, csr, x, s0


@pytest.mark.parametrize("bucketed", [False, True], ids=["full", "buckets"])
@pytest.mark.parametrize("mode", ["spmv", "moran", "geary"])
def test_walked_rows_give_the_unwalked_result(mode, bucketed):
    """K5a over the ELL rows in Morton order equals the unwalked launch:
    ``u = W z`` bitwise (each row keeps its slots), the numerators within
    ``1e-5 * sum |terms|`` (their rows are summed in another order)."""
    tg, buckets, walked, walk, csr, x, _ = _walked_inputs(bucketed)
    if bucketed:
        assert sum(r.shape[0] for r, _, _ in walked) == x.shape[0]
        for (rows, idx, _), (rows_w, idx_w, _) in zip(buckets, walked):
            assert idx_w.shape == idx.shape  # each row keeps its bucket's slots
            np.testing.assert_array_equal(np.sort(rows_w.numpy()), rows.numpy())  # the bucket's rows,
            rank = np.argsort(walk.numpy())
            assert np.all(np.diff(rank[rows_w.numpy()]) > 0)  # in walk order
    xt = torch.from_numpy(x)
    z = xt - xt.mean(dim=0, keepdim=True)
    if mode == "spmv":
        want = tac.spmv_genes(tg.indices, tg.weights, z)
        got = tac.spmv_genes_bucketed(walked, z) if bucketed else tac.spmv_genes(tg.indices, tg.weights, z, walk=walk)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        if bucketed:
            np.testing.assert_array_equal(tac.spmv_genes_bucketed(buckets, z).numpy(), want.numpy())
        return
    y = z if mode == "moran" else xt
    if bucketed:
        got = sum(tac.ell_autocorr(mode, i, w, y, r) for r, i, w in walked).numpy()
        want = sum(tac.ell_autocorr(mode, i, w, y, r) for r, i, w in buckets).numpy()
    else:
        got = tac.ell_autocorr(mode, tg.indices, tg.weights, y, walk=walk).numpy()
        want = tac.ell_autocorr(mode, tg.indices, tg.weights, y).numpy()
    x64 = x.astype(np.float64)
    terms = _terms_abs_moran(csr, x64) if mode == "moran" else _terms_abs_geary(csr, x64)
    assert np.all(np.abs(got.astype(np.float64) - want) <= _abs_bound(terms)), (got, want)


@pytest.mark.parametrize("n_b,g,aligned,per_sm,sms,l2", [
    (1_000_000, 512, True, 4, 132, 50 << 20),  # the main path's block on an H100
    (1_000_003, 14, False, 4, 132, 50 << 20),
    (5_000, 512, True, 3, 132, 50 << 20),  # a small bucket: every warp gets rows
    (300_000, 160_000, False, 2, 4, 4 << 20),  # more slices than resident warps
    (1, 1, False, 1, 1, 1),
])
def test_k5a_layout_covers_the_rows(n_b, g, aligned, per_sm, sms, l2):
    lay = tac._k5a_layout(n_b, g, aligned, per_sm, 32, sms, l2)
    assert lay.aligned == aligned
    assert lay.slices * 128 >= g > (lay.slices - 1) * 128
    assert lay.blocks >= per_sm * sms and lay.blocks * tac._K5A_WARPS >= lay.slices
    assert lay.groups == lay.blocks * tac._K5A_WARPS // lay.slices >= 1
    items_rows = lay.items // lay.slices * lay.rows_per_item
    assert lay.items % lay.slices == 0 and n_b <= items_rows < n_b + lay.rows_per_item
    assert lay.stretch_rows == lay.groups * lay.rows_per_item
    # the stretch's gene rows fill at most the L2's share, unless one row an item is already more
    assert lay.rows_per_item == 1 or lay.stretch_rows * 4 * g <= l2 * tac._K5A_L2_SHARE
    # and no warp is left without rows while others hold several
    assert lay.rows_per_item == 1 or lay.groups * (lay.rows_per_item - 1) < n_b
    if (n_b, g) == (1_000_000, 512):
        assert (lay.slices, lay.groups, lay.rows_per_item, lay.stretch_rows) == (4, 1056, 6, 6336)


@pytest.mark.parametrize("kind", ["missing", "nan", "inf", "rows", "one_column", "four_columns", "strings"])
def test_locality_walk_is_the_identity_without_usable_coordinates(kind):
    from squidpy_torch._core.graph import _morton_walk

    adata = _adata(300, 2, seed=15)
    coords = np.asarray(adata.obsm["spatial"])
    if kind == "missing":
        del adata.obsm["spatial"]
    elif kind in ("nan", "inf"):
        coords = coords.copy()
        coords[17, 1] = np.nan if kind == "nan" else np.inf
        adata.obsm["spatial"] = coords
    elif kind == "rows":
        adata.obsm["spatial"] = np.vstack([coords, coords[:1]])
    elif kind == "one_column":
        adata.obsm["spatial"] = coords[:, :1]
    elif kind == "four_columns":
        adata.obsm["spatial"] = np.hstack([coords, coords])
    else:
        adata.obsm["spatial"] = np.full((300, 2), "a")
    assert _morton_walk(adata, 300, torch.device("cpu")) is None


@pytest.mark.parametrize("dim", [2, 3])
def test_locality_walk_is_the_morton_order(dim):
    from squidpy_torch._core.graph import _morton_walk, locality_walk
    from squidpy_torch.ops.pairbins import morton_argsort

    adata = _adata(300, 2, seed=16)
    pts = np.random.default_rng(16).integers(0, 1000, (300, dim))  # integer coordinates
    adata.obsm["spatial"] = pts
    walk = _morton_walk(adata, 300, torch.device("cpu"))
    np.testing.assert_array_equal(walk.numpy(), morton_argsort(pts))
    # only K5a on the card walks: the CPU's plain path keeps the row order
    assert locality_walk(adata, 300, torch.device("cpu")) is None


def test_locality_walk_is_cached_per_coordinate_array(monkeypatch):
    """The card's walk is built once while the same coordinate array is
    installed, and again when it is replaced or the cell count differs."""
    from squidpy_torch._core import graph as tgraph

    built = []
    monkeypatch.setattr(tgraph, "_morton_walk", lambda a, n, d: built.append(n) or torch.arange(n, dtype=torch.int32))
    adata = _adata(300, 2, seed=17)
    card = torch.device("cuda")
    first = tgraph.locality_walk(adata, 300, card)
    assert tgraph.locality_walk(adata, 300, card) is first and built == [300]
    adata.obsm["spatial"] = np.asarray(adata.obsm["spatial"]).copy()
    assert tgraph.locality_walk(adata, 300, card) is not first and built == [300, 300]
    tgraph.locality_walk(adata, 299, card)
    assert built == [300, 300, 299]
    del adata.obsm["spatial"]
    tgraph.locality_walk(adata, 300, card)
    assert len(built) == 4  # nothing to key the cache on: asked anew


@pytest.mark.parametrize("mode,n_perms", [("moran", 20), ("geary", 20), ("moran", None), ("geary", None)])
def test_spatial_autocorr_with_and_without_coordinates(mode, n_perms, monkeypatch):
    """With ``obsm['spatial']`` the ELL passes walk the rows in Morton order;
    without, in row order. With permutations every column is bitwise equal
    (``u = W z`` is); without, the fused numerators sum the rows in another
    order, so the scores agree to the test's tolerance. Both still match
    the JAX package."""
    from squidpy_torch._core.graph import _morton_walk
    from squidpy_torch.gr import _ppatterns as tpp

    adata = _adata(3000, 14, seed=6)  # test_spatial_autocorr_matches_jax's fixture
    sq.gr.spatial_neighbors_knn(adata, n_neighs=6)
    walks = []
    # the walk the card would take, forced onto the CPU's plain path
    monkeypatch.setattr(tpp, "locality_walk", lambda *a: walks.append(_morton_walk(*a)) or walks[-1])
    kw = dict(mode=mode, n_perms=n_perms, seed=0, copy=True)
    walked = sqt.gr.spatial_autocorr(adata, **kw)
    coords = adata.obsm["spatial"]
    del adata.obsm["spatial"]
    plain = sqt.gr.spatial_autocorr(adata, **kw)
    adata.obsm["spatial"] = coords
    assert walks[0] is not None and walks[1] is None
    stat = "I" if mode == "moran" else "C"
    if n_perms is not None:
        assert list(walked.index) == list(plain.index)
        for col in plain.columns:
            np.testing.assert_array_equal(walked.columns[col], plain.columns[col], err_msg=col)
    else:
        order = {g: i for i, g in enumerate(plain.index)}
        bound = _score_bound(adata, walked, mode, True, "X")
        diff = np.abs(walked.columns[stat] - plain.columns[stat][[order[g] for g in walked.index]])
        assert np.all(diff <= bound)
    df = sq.gr.spatial_autocorr(adata, **kw)
    _assert_frames_agree(walked, df, stat, _score_bound(adata, walked, mode, True, "X"))


def test_ell_autocorr_allocates_u_by_coverage():
    """With a row map, ``u`` is zero on rows the map leaves out (a degree
    bucket, its own ELL rows in map order) and every row is written when it
    covers them all (a walk over the graph's own ELL arrays)."""
    csr, x, _ = _ops_inputs(skewed=False, seed=18)
    tg = TGraph.from_csr(csr, dtype=np.float32)
    xt = torch.from_numpy(x)
    want = tac.spmv_genes(tg.indices, tg.weights, xt)
    rows = torch.arange(0, x.shape[0], 3, dtype=torch.int32)
    part = tac.ell_autocorr("spmv", tg.indices[rows.long()], tg.weights[rows.long()], xt, rows)
    np.testing.assert_array_equal(part[rows.long()].numpy(), want[rows.long()].numpy())
    left = torch.ones(x.shape[0], dtype=torch.bool)
    left[rows.long()] = False
    assert not part[left].any()
    # a walk: the graph's own arrays, walked in the order of `perm`
    perm = torch.from_numpy(np.random.default_rng(18).permutation(x.shape[0]).astype(np.int32))
    full = tac.ell_autocorr("spmv", tg.indices, tg.weights, xt, walk=perm)
    np.testing.assert_array_equal(full.numpy(), want.numpy())


@pytest.mark.parametrize("mode", ["spmv", "moran", "geary"])
def test_full_size_bucket_reads_its_own_rows(mode):
    """A bucket over every row, in permuted order with its own reordered ELL
    arrays (ELL row r for graph row ``rows[r]``), is a bucket, not a walk:
    it gives ``W x``, and a walk is asked for only by ``walk=``."""
    csr, x, _ = _ops_inputs(skewed=False, seed=19)
    tg = TGraph.from_csr(csr, dtype=np.float32)
    xt = torch.from_numpy(x)
    rows = torch.from_numpy(np.random.default_rng(19).permutation(x.shape[0]).astype(np.int32))
    got = tac.ell_autocorr(mode, tg.indices[rows.long()], tg.weights[rows.long()], xt, rows)
    want = tac.ell_autocorr(mode, tg.indices, tg.weights, xt)
    if mode == "spmv":
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        x64 = x.astype(np.float64)
        terms = _terms_abs_moran(csr, x64) if mode == "moran" else _terms_abs_geary(csr, x64)
        assert np.all(np.abs(got.numpy().astype(np.float64) - want.numpy()) <= _abs_bound(terms))
    with pytest.raises(ValueError, match="walk"):
        tac.ell_autocorr(mode, tg.indices, tg.weights, xt, rows, walk=rows)


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
        # the walked launch: the whole graph, and its degree buckets, in Morton order
        from squidpy_torch._core.graph import morton_order, walk_buckets

        coords = np.random.default_rng(11).uniform(0.0, 100.0, (x.shape[0], 2))
        walk = morton_order(torch.from_numpy(coords).cuda())
        u_want = tac._ell_plain("spmv", tg.indices, tg.weights, torch.from_numpy(x), None).numpy()
        for buckets in (None, tgc.degree_buckets()):
            walked = walk_buckets(buckets, walk) if buckets is not None else None
            u_got = (tac.spmv_genes_bucketed(walked, xc) if walked is not None
                     else tac.spmv_genes(tgc.indices, tgc.weights, xc, walk=walk))
            np.testing.assert_array_equal(u_got.cpu().numpy(), u_want)
            for mode in ("moran", "geary"):
                got = (sum(tac.ell_autocorr(mode, i, w, xc, r) for r, i, w in walked) if walked is not None
                       else tac.ell_autocorr(mode, tgc.indices, tgc.weights, xc, walk=walk)).cpu().numpy()
                want = tac._ell_plain(mode, tg.indices, tg.weights, torch.from_numpy(x), None).numpy()
                terms = (_terms_abs_moran(csr, x) if mode == "moran" else _terms_abs_geary(csr, x))
                assert np.all(np.abs(got - want) <= _abs_bound(terms) + 1e-6 * np.abs(want))
        perms = trng.permutation_batch(trng.spawn_keys(0, 40), x.shape[0], torch.device("cuda"))
        for dtype in (torch.float32, torch.bfloat16):  # K5b's two operand types (bf16 at n >= 2^19)
            xd = xc.to(dtype)
            r = xd[:, 0].abs().contiguous()
            for mode in ("moran", "geary"):
                rr = r if mode == "geary" else None
                got = tac.perm_autocorr(mode, xd, xd, perms, rr)
                want = tac._perm_plain(mode, xd, xd, rr, perms)
                scale = tac._perm_plain(mode, xd.abs(), -xd.abs() if mode == "geary" else xd.abs(), rr, perms)
                assert got.dtype == torch.float32
                assert bool(((got - want).abs() <= 1e-5 * scale.abs()).all()), (dtype, mode)


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
