"""squidpy_torch's sepal against squidpy_tpu's (``ops/sepal.py``, ``gr/_sepal.py``).

Tolerances. The node tables (``_compute_idxs``) are bitwise. The diffusion's
state is bitwise JAX's in float64 and in float32: both add the neighbours in
order, use no FMA, and multiply by the rounded reciprocal where JAX divides
by a constant (XLA rewrites ``/ 3`` and ``/ n_sat`` so on the CPU; the port
does the same, held by ``test_jax_multiplies_by_the_reciprocal``). The
entropies differ: each package sums in its own order (the port in runs of 8
rows, then a pairwise tree; XLA in windows of 32) and takes its own ``log``.
So a gene's convergence step may differ, but only at a near tie: at the
earlier of the two steps both packages' entropy changes lie within
:data:`BAND_ULPS` ulps of the entropy from ``thresh`` (``_assert_iterations``
replays the port's state and takes JAX's ``_entropy_cols`` on it; the
states agree, so that gives JAX's steps but at such ties). In float64 no
gene differs on these inputs; in float32 at ``thresh=1e-8`` on a few
hundred nodes the rounding of the entropy decides most steps, and every one
is asserted to be a near tie.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.gr import _sepal as tsepal
from squidpy_torch.ops import sepal as tops
from squidpy_tpu.gr import _sepal as jsepal
from squidpy_tpu.ops import sepal as jops

torch.set_num_threads(1)

BAND_ULPS = 16  # measured at most 10 ulps of ent / n_sat between the packages' entropy changes


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


def _lattice(side: int, hexa: bool) -> np.ndarray:
    jj, ii = np.divmod(np.arange(side * side), side)
    return np.c_[ii + 0.5 * (jj % 2), jj * np.sqrt(3) / 2] if hexa else np.c_[ii, jj].astype(float)


def _grid_adata(side: int = 12, n_genes: int = 6, hexa: bool = False, seed: int = 0, hvg: bool = False) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    coords = _lattice(side, hexa)
    x = rng.poisson(5.0, size=(len(coords), n_genes)).astype(float)
    x[:, 0] = np.exp(-((coords[:, 0] - side / 2) ** 2 + (coords[:, 1] - side / 2) ** 2) / 4.0) * 50
    var = pd.DataFrame(index=[f"g{i}" for i in range(n_genes)])
    if hvg:
        var["highly_variable"] = np.arange(n_genes) % 3 != 1
    adata = sq.AnnData(X=x, var=var, obs=pd.DataFrame(index=[str(i) for i in range(len(coords))]))
    adata.obsm["spatial"] = coords
    sq.gr.spatial_neighbors_grid(adata, n_neighs=6 if hexa else 4)
    return adata


def _tables(adata, k: int):
    g = adata.obsp["spatial_connectivities"].tocsr()
    sat, sat_idx, unsat, nearest = jsepal._compute_idxs(g, np.asarray(adata.obsm["spatial"], dtype=float), k)
    return sat, sat_idx, unsat, np.searchsorted(sat, nearest).astype(np.int32)


def _replay(x: np.ndarray, tables, hexa: bool, n_steps: int, dt: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The port's unfrozen trajectory from ``x``: each step's entropy (over
    n_sat) by the port's sums and by JAX's ``_entropy_cols``, and its ulp."""
    sat, sat_idx, unsat, pos = (torch.from_numpy(np.asarray(a)).long() for a in tables)
    dtype = torch.float32 if x.dtype == np.float32 else torch.float64
    dt_, _, recip3, recip_sat, eps = tops._constants(dtype, len(sat), dt, 0.0)
    n_sat = len(sat)
    jax_ent = jax.jit(lambda c: jops._entropy_cols(c) / n_sat)
    conc = torch.from_numpy(x)
    port, jx = [], []
    for _ in range(n_steps):
        centre = conc[sat]
        nh = conc[sat_idx[:, 0]]
        for j in range(1, sat_idx.shape[1]):
            nh = nh + conc[sat_idx[:, j]]
        upd = ((2.0 * nh - 12.0 * centre) * recip3 if hexa else nh - 4.0 * centre) * dt_
        new = conc.clone()
        new[sat] = centre + upd
        new[unsat] = conc[unsat] + upd[pos]
        conc = torch.where(new < 0, torch.zeros((), dtype=dtype), new)
        port.append((tops._entropy(conc[sat], eps) * recip_sat).numpy())
        jx.append(np.asarray(jax_ent(jnp.asarray(conc[sat].numpy()))))
    port, jx = np.asarray(port), np.asarray(jx)
    return port, jx, np.spacing(np.abs(port))


def _first_below(ent: np.ndarray, thresh: float) -> np.ndarray:
    """Each column's first step with |change| <= thresh (from 1.0), NaN if none."""
    prev = np.vstack([np.ones((1, ent.shape[1]), ent.dtype), ent[:-1]])
    hit = np.abs(ent - prev) <= ent.dtype.type(thresh)
    return np.where(hit.any(axis=0), hit.argmax(axis=0), np.nan)


def _assert_iterations(x, tables, hexa, n_iter, dt, thresh, got, want) -> int:
    """``got`` (the port) against ``want`` (JAX). The port's replay gives
    ``got`` exactly. Every gene where ``got`` and ``want`` differ, and every
    gene where JAX's ``_entropy_cols`` compiled alone on the port's state
    gives another step than JAX's loop (XLA compiles the loop's reduction
    apart: an ulp here and there), is a near tie: at the earlier of the two
    steps both packages' entropy changes lie within BAND_ULPS ulps of the
    entropy from ``thresh``. Returns the number of genes where ``got`` and
    ``want`` differ."""
    finite = np.isfinite(got).all() and np.isfinite(want).all()
    steps = int(min(n_iter, np.nanmax(np.r_[got, want, -1.0]) + 1)) if finite else n_iter
    port, jx, ulp = _replay(x, tables, hexa, steps, dt)
    np.testing.assert_array_equal(_first_below(port, thresh), got)
    prev = lambda e: np.vstack([np.ones((1, e.shape[1]), e.dtype), e[:-1]])  # noqa: E731
    d_port, d_jax = np.abs(port - prev(port)), np.abs(jx - prev(jx))
    thr = x.dtype.type(thresh)

    def differing(a, b):
        return np.flatnonzero(~((a == b) | (np.isnan(a) & np.isnan(b))))

    for a, b in ((got, want), (_first_below(jx, thresh), want)):
        for g in differing(a, b):
            i = int(np.nanmin([a[g], b[g]]))
            band = BAND_ULPS * max(ulp[i, g], ulp[i - 1, g] if i else 0.0)
            assert abs(d_port[i, g] - thr) <= band and abs(d_jax[i, g] - thr) <= band, (g, i, d_port[i, g], band)
    return len(differing(got, want))


def _diffuse_both(x, tables, hexa, n_iter, dt, thresh):
    want = np.asarray(jops.sepal_diffusion(jnp.asarray(x), *(jnp.asarray(a) for a in tables), hexa, n_iter, dt, thresh))
    got = tops.sepal_diffusion(torch.from_numpy(x), *(torch.from_numpy(np.asarray(a)) for a in tables), hexa, n_iter,
                               dt, thresh).numpy()
    assert got.dtype == want.dtype == x.dtype
    return got, want


@pytest.mark.parametrize("hexa", [False, True], ids=["square", "hex"])
def test_diffusion_float64_matches_jax(hexa):
    adata = _grid_adata(side=16, n_genes=10, hexa=hexa, seed=1)
    tables = _tables(adata, 6 if hexa else 4)
    x = np.asarray(adata.X, dtype=np.float64)
    got, want = _diffuse_both(x, tables, hexa, 1500, 0.001, 1e-8)
    assert np.isfinite(got[1:]).all()  # the noise genes converge within the budget
    assert _assert_iterations(x, tables, hexa, 1500, 0.001, 1e-8, got, want) == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh", [1e-8, 1e-6])
@pytest.mark.parametrize("hexa", [False, True], ids=["square", "hex"])
def test_diffusion_float32_differs_only_at_near_ties(hexa, thresh):
    """float32, as the card and a TPU run it: the states agree bitwise, the
    steps only where the entropy's rounding straddles thresh (asserted for
    each such gene; at 1e-8 most genes are such, at 1e-6 few)."""
    adata = _grid_adata(side=18, n_genes=12, hexa=hexa, seed=2)
    tables = _tables(adata, 6 if hexa else 4)
    x = np.asarray(adata.X, dtype=np.float32)
    got, want = _diffuse_both(x, tables, hexa, 1200, 0.001, thresh)
    differ = _assert_iterations(x, tables, hexa, 1200, 0.001, thresh, got, want)
    if thresh == 1e-6:
        assert differ <= 4


def test_diffusion_budget_and_frozen_genes():
    """``thresh=0`` keeps every gene running to the budget (NaN); a zero
    gene converges at step 1 (its entropy stays 0) and keeps its state."""
    adata = _grid_adata(side=10, n_genes=4, seed=3)
    tables = _tables(adata, 4)
    x = np.asarray(adata.X, dtype=np.float64)
    x[:, 2] = 0.0
    got, want = _diffuse_both(x, tables, False, 40, 0.001, 0.0)
    np.testing.assert_array_equal(got, want)
    assert got[2] == 1.0 and np.isnan(got[[0, 1, 3]]).all()
    done, state = tops.sepal_diffusion(torch.from_numpy(x), *(torch.from_numpy(np.asarray(a)) for a in tables), False,
                                       40, 0.001, 0.0, return_state=True)
    assert torch.equal(state[:, 2], torch.zeros(x.shape[0], dtype=torch.float64))
    assert not torch.equal(state[:, 0], torch.from_numpy(x[:, 0]))


def test_ordered_sum_is_runs_then_a_tree():
    """K11's order: runs of 8 rows in order, then a pairwise tree over the
    runs padded with zeros; here on values whose float32 sum depends on it."""
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0, 5.0, 7.0, 1e-3, 2.0, 4.0, 1e8, -1e8, 0.5], dtype=torch.float32)
    runs = [x[0:8], x[8:13]]
    want = []
    for r in runs:
        s = r[0]
        for v in r[1:]:
            s = s + v
        want.append(s)
    assert torch.equal(tops._ordered_sum(x[:, None])[0], want[0] + want[1])


def test_jax_multiplies_by_the_reciprocal():
    """XLA on the CPU turns JAX's division by a constant into a product with
    the rounded reciprocal: the hex laplacian's ``/ 3.0`` and the entropy's
    ``/ n_sat``. The port does the same."""
    a = np.random.default_rng(0).random(100_000) * 100
    for dtype in (np.float32, np.float64):
        v = a.astype(dtype)
        got = np.asarray(jax.jit(lambda t: t / 3.0)(jnp.asarray(v)))
        np.testing.assert_array_equal(got, v * (dtype(1) / dtype(3)))
        assert not np.array_equal(got, v / dtype(3))
        got = np.asarray(jax.jit(lambda t: t / 437)(jnp.asarray(v)))
        np.testing.assert_array_equal(got, v * (dtype(1) / dtype(437)))
    assert tops._constants(torch.float32, 437, 0.001, 1e-8)[3] == float(np.float32(1) / np.float32(437))


# --- the node tables -----------------------------------------------------------------------


def _islands_adata() -> sq.AnnData:
    """A square lattice with holes plus far, small components: unsaturated
    nodes without a saturated neighbour (the L1 fallback), some equidistant
    from two saturated nodes (the first wins)."""
    coords = _lattice(10, False)
    keep = ~(((coords[:, 0] == 4) | (coords[:, 0] == 5)) & (coords[:, 1] > 2))
    coords = coords[keep]
    extra = np.array([[20.0, 20.0], [21.0, 20.0], [-7.0, 4.5], [4.5, -3.0], [14.0, 14.0], [30.0, -1.0]])
    coords = np.vstack([coords, extra])
    n = len(coords)
    adata = sq.AnnData(X=np.random.default_rng(0).poisson(3.0, (n, 3)).astype(float),
                       var=pd.DataFrame(index=["a", "b", "c"]), obs=pd.DataFrame(index=[str(i) for i in range(n)]))
    adata.obsm["spatial"] = coords
    sq.gr.spatial_neighbors_grid(adata, n_neighs=4)
    return adata


@pytest.mark.parametrize("case", ["square", "hex", "islands"])
def test_compute_idxs_matches_jax(case):
    adata = _islands_adata() if case == "islands" else _grid_adata(side=9, hexa=case == "hex")
    k = 6 if case == "hex" else 4
    g = adata.obsp["spatial_connectivities"].tocsr()
    spatial = np.asarray(adata.obsm["spatial"], dtype=float)
    want = jsepal._compute_idxs(g, spatial, k)
    got = tsepal._compute_idxs(g, spatial, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if case == "islands":
        unsat = want[2]
        is_sat = np.isin(np.arange(g.shape[0]), want[0])
        lonely = [u for u in unsat if not is_sat[g.indices[g.indptr[u] : g.indptr[u + 1]]].any()]
        assert len(lonely) >= 4  # the fallback runs


def test_compute_idxs_l1_ties_take_the_first(monkeypatch):
    """A node at equal L1 distance from two saturated nodes takes the first
    (the island's (4.5, -3.0) between (4, 1) and (5, 1)), in one-row chunks
    of distances as in one."""
    adata = _islands_adata()
    g = adata.obsp["spatial_connectivities"].tocsr()
    spatial = np.asarray(adata.obsm["spatial"], dtype=float)
    want = jsepal._compute_idxs(g, spatial, 4)
    node = int(np.flatnonzero((spatial == [4.5, -3.0]).all(axis=1))[0])
    first = int(np.flatnonzero((spatial == [4.0, 1.0]).all(axis=1))[0])
    assert want[3][list(want[2]).index(node)] == first
    monkeypatch.setattr(tsepal, "_DIST_ENTRIES", 1)
    np.testing.assert_array_equal(tsepal._compute_idxs(g, spatial, 4)[3], want[3])


# --- gr.sepal --------------------------------------------------------------------------------


def _stub_iterations(conc) -> np.ndarray:
    """A stand-in diffusion: iterations from each column's total (ties, and
    NaN where the total is a multiple of 5), equal for both packages."""
    total = np.rint(np.asarray(conc, dtype=np.float64).sum(axis=0))
    return np.where(total % 5 == 0, np.nan, total % 7).astype(np.float32)


@pytest.mark.parametrize("block", [1, 3, 512])
@pytest.mark.parametrize("hvg", [False, True])
def test_sepal_frame_matches_jax(block, hvg, monkeypatch):
    """With both diffusions replaced by the same stand-in: the index order
    (pandas' descending sort, ties and NaN last), the scores, the
    ``highly_variable`` genes, for any gene block."""
    import squidpy_tpu.parallel.sharded as jsharded

    adata = _grid_adata(side=8, n_genes=11, seed=4, hvg=hvg)
    adata.X[:, 3] = adata.X[:, 5]  # equal totals: a tie
    monkeypatch.setattr(jsharded, "auto_sepal_iters", lambda conc, *a: jnp.asarray(_stub_iterations(conc)))
    monkeypatch.setattr(tsepal, "sepal_diffusion", lambda conc, *a: torch.from_numpy(_stub_iterations(conc.numpy())))
    want = sq.gr.sepal(adata, max_neighs=4, copy=True)
    got = sqt.gr.sepal(adata, max_neighs=4, copy=True, gene_block_size=block)
    assert list(want.columns) == ["sepal_score"]
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    np.testing.assert_array_equal(got.columns["sepal_score"], want["sepal_score"].to_numpy())
    assert np.isnan(got.columns["sepal_score"]).any()


@pytest.mark.parametrize("hexa", [False, True], ids=["square", "hex"])
def test_sepal_matches_jax_without_x64(hexa):
    """``gr.sepal`` in float32 against the JAX package without x64 (as on a
    TPU): equal scores but at near ties of its iterations, each asserted."""
    adata = _grid_adata(side=14, n_genes=8, hexa=hexa, seed=5)
    kw = dict(max_neighs=6 if hexa else 4, n_iter=1500, thresh=1e-6, copy=True)
    with _x64_off():
        want = sq.gr.sepal(adata, **kw)
    got = sqt.gr.sepal(adata, **kw)
    w = want["sepal_score"].reindex(list(map(str, adata.var_names))).to_numpy()
    order = np.argsort(got.index.astype(str))
    names = np.asarray(got.index, dtype=str)[order]
    assert list(names) == sorted(map(str, adata.var_names))
    g = got.columns["sepal_score"][order][np.argsort(np.argsort(list(map(str, adata.var_names))))]
    iters = lambda s: np.rint(s / 0.001)  # noqa: E731
    tables = _tables(adata, kw["max_neighs"])
    _assert_iterations(np.asarray(adata.X, dtype=np.float32), tables, hexa, 1500, 0.001, 1e-6, iters(g), iters(w))
    if np.array_equal(g, w, equal_nan=True):
        np.testing.assert_array_equal(got.index, want.index.to_numpy())


def test_sepal_blocks_change_nothing_and_write_uns():
    adata = _grid_adata(side=10, n_genes=7, seed=6)
    whole = sqt.gr.sepal(adata, max_neighs=4, n_iter=800, copy=True)
    for block in (1, 3, 512):
        part = sqt.gr.sepal(adata, max_neighs=4, n_iter=800, copy=True, gene_block_size=block)
        np.testing.assert_array_equal(part.index, whole.index)
        np.testing.assert_array_equal(part.columns["sepal_score"], whole.columns["sepal_score"])
    assert sqt.gr.sepal(adata, max_neighs=4, n_iter=800) is None
    res = adata.uns["sepal_score"]
    assert isinstance(res, sqt.gr.SepalResult)
    np.testing.assert_array_equal(res.columns["sepal_score"], whole.columns["sepal_score"])


def test_sepal_genes_raw_and_layers():
    """``genes`` as a name or a list, ``layer`` and ``use_raw`` read the
    JAX package's columns (its ``_extract_expression``), sparse or dense."""
    adata = _grid_adata(side=8, n_genes=6, seed=7)
    adata.layers["counts"] = sp.csr_matrix(adata.X * 2)
    adata.raw = adata[:, ["g0", "g2", "g5"]].copy()
    from squidpy_torch.gr._utils import _extract_expression as t_extract
    from squidpy_tpu.gr._utils import _extract_expression as j_extract

    for kw in (dict(genes=["g1", "g4"]), dict(genes=["g3"], layer="counts"), dict(genes=["g0", "g1", "g5"], use_raw=True),
               dict(genes=None), dict(genes=None, use_raw=True)):
        (xt, gt), (xj, gj) = t_extract(adata, **kw), j_extract(adata, **kw)
        assert list(gt) == list(gj)
        np.testing.assert_array_equal(xt.toarray() if sp.issparse(xt) else xt, xj.toarray() if sp.issparse(xj) else xj)
    got = sqt.gr.sepal(adata, max_neighs=4, genes="g1", n_iter=500, copy=True)
    assert list(got.index) == ["g1"]
    got = sqt.gr.sepal(adata, max_neighs=4, genes=["g0", "g1", "g5"], use_raw=True, n_iter=500, copy=True)
    assert sorted(got.index) == ["g0", "g5"]


def test_sepal_errors(caplog):
    adata = _grid_adata(side=6, n_genes=3, seed=8)
    with pytest.raises(ValueError, match="either `4` or `6`"):
        sqt.gr.sepal(adata, max_neighs=5)
    with pytest.raises(ValueError, match="Expected `max_neighs=6`"):
        sqt.gr.sepal(adata, max_neighs=6)
    with pytest.raises(ValueError, match="No genes"):
        sqt.gr.sepal(adata, max_neighs=4, genes=[])
    with pytest.raises(KeyError, match="connectivity"):
        sqt.gr.sepal(adata, max_neighs=4, connectivity_key="nope")
    with pytest.raises(KeyError, match="obsm"):
        sqt.gr.sepal(adata, max_neighs=4, spatial_key="nope")
    with pytest.raises(KeyError, match="not found"):
        sqt.gr.sepal(adata, max_neighs=4, genes=["absent"])
    import logging

    with caplog.at_level(logging.WARNING):
        sqt.gr.sepal(adata, max_neighs=4, n_iter=3, copy=True)
    assert "Found `NaN` in sepal scores" in caplog.text


def test_genes_per_block():
    assert tsepal._genes_per_block(1_000_000, torch.device("cpu")) == (512 << 20) // (12 * 1_000_000)
    assert tsepal._genes_per_block(10**12, torch.device("cpu")) == 1


# --- K11 on the card -------------------------------------------------------------------------


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
def test_k11_matches_plain_on_card(cuda_card):
    """K11 against its plain version on the card, bitwise (the iterations
    and the final state): square and hex, the budget (thresh 0) and the
    default threshold."""
    cuda = torch.device("cuda")
    for side, hexa, n_genes, n_iter, thresh in ((20, False, 40, 300, 0.0), (23, True, 70, 3000, 1e-8),
                                                (40, False, 33, 3000, 1e-8)):
        adata = _grid_adata(side=side, n_genes=n_genes, hexa=hexa, seed=side)
        tables = [torch.from_numpy(np.asarray(a, dtype=np.int32)).to(cuda) for a in _tables(adata, 6 if hexa else 4)]
        x = torch.from_numpy(np.asarray(adata.X, dtype=np.float32)).to(cuda)
        dk, sk = tops.sepal_diffusion(x, *tables, hexa, n_iter, 0.001, thresh, return_state=True)
        dp, spl = tops._diffusion_plain(x, *tables, hexa, n_iter, 0.001, thresh)
        assert torch.equal(torch.nan_to_num(dk, nan=-1.0), torch.nan_to_num(dp, nan=-1.0))
        assert torch.equal(sk, spl)
