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
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch import _cuda
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
    recip3dt = tops._recip3dt(dtype, dt)
    n_sat = len(sat)
    jax_ent = jax.jit(lambda c: jops._entropy_cols(c) / n_sat)
    conc = torch.from_numpy(x)
    port, jx = [], []
    for _ in range(n_steps):
        centre = conc[sat]
        nh = conc[sat_idx[:, 0]]
        for j in range(1, sat_idx.shape[1]):
            nh = nh + conc[sat_idx[:, j]]
        lap = 2.0 * nh - 12.0 * centre if hexa else nh - 4.0 * centre
        upd = lap * recip3dt if hexa else lap * dt_
        new = conc.clone()
        new[sat] = centre + upd
        new[unsat] = conc[unsat] + (((lap * recip3) * dt_) if hexa else upd)[pos]
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


# --- K11's routes, their C interface emulated in torch on the CPU ----------------------------


def _view(ptr: int, dtype: np.dtype, count: int) -> np.ndarray:
    """A writable numpy view of ``count`` items at a tensor's ``data_ptr``."""
    if not count:
        return np.zeros(0, dtype)
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * (count * itemsize)).from_address(ptr), dtype=dtype)


def _tview(ptr: int, dtype: np.dtype, shape: tuple[int, ...]) -> torch.Tensor:
    return torch.from_numpy(_view(ptr, dtype, int(np.prod(shape))).reshape(shape))


def _run_sums(v: torch.Tensor) -> torch.Tensor:
    """Column sums of ``v`` (rows, g) in runs of 8 rows added in order, one
    a run (rows padded with zeros to whole runs)."""
    runs = -(-v.shape[0] // 8)
    v = torch.nn.functional.pad(v, (0, 0, 0, runs * 8 - v.shape[0])).view(runs, 8, v.shape[1])
    s = v[:, 0]
    for t in range(1, 8):
        s = s + v[:, t]
    return s


def _tree(v: torch.Tensor, width: int) -> torch.Tensor:
    """The pairwise tree over each aligned group of ``width`` (a power of
    two) rows of ``v``, zeros past its end: ``(groups, g)``."""
    groups = max(1, -(-v.shape[0] // width))
    s = torch.nn.functional.pad(v, (0, 0, 0, groups * width - v.shape[0])).view(groups, width, v.shape[1])
    while s.shape[1] > 1:
        s = s[:, 0::2] + s[:, 1::2]
    return s[:, 0]


def _clamp0(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, torch.zeros((), dtype=x.dtype), x)


class _EmulatedK11:
    """K11's entry points in torch, reading and writing CPU tensors through
    the pointers the wrapper passes, as the kernels compute: the streaming
    pass (state p's entropy terms with the sum pass p - 1 finished, state
    p + 1, its positive partials a block of 256 rows; the partials folded by
    groups of 32, level after level, each group by whichever member arrives
    last, in a shuffled order; the test of step p - 1 by the root; the
    copy of a gene frozen two passes ago), and the resident route (blocks of
    genes, chunk partials of 32 positions folded by a warp's tree)."""

    def __init__(self, optin: int, seed: int = 0, sms: int = 132):
        self.optin, self.sms = optin, sms
        self.rng = np.random.default_rng(seed)
        self.calls: list[str] = []
        self.passes: list[int] = []

    def sqt_device_info(self, ptr):
        _view(ptr, np.int32, 2)[:] = self.optin, self.sms
        return 0

    @staticmethod
    def _stencil(sat, nbr, n_sat, k, unsat, near, n_unsat):
        t = lambda p, c: torch.from_numpy(_view(p, np.int32, c).astype(np.int64))  # noqa: E731
        return t(sat, n_sat), t(nbr, n_sat * k).view(n_sat, k), t(unsat, n_unsat), t(near, n_unsat)

    @staticmethod
    def _step(c, base, tb, hexa, dt, recip3, recip3dt):
        """The next state of the rows a pass writes (the saturated and
        unsaturated nodes, clamped), ``base`` at every other row."""
        sat, nbr, unsat, near = tb
        centre = c[sat]
        nh = c[nbr[:, 0]]
        for j in range(1, nbr.shape[1]):
            nh = nh + c[nbr[:, j]]
        lap = 2.0 * nh - 12.0 * centre if hexa else nh - 4.0 * centre
        new = base.clone()
        new[sat] = _clamp0(centre + (lap * recip3dt if hexa else lap * dt))
        new[unsat] = _clamp0(c[unsat] + ((lap * recip3 if hexa else lap) * dt)[near])
        return new

    @staticmethod
    def _terms(old, safe, eps):
        pos = old > 0
        zero = torch.zeros((), dtype=old.dtype)
        xn = torch.where(pos, old / safe, zero)
        return torch.where(pos, xn * torch.log(torch.maximum(xn, torch.full_like(xn, eps))), zero)

    def sqt_sepal_passes(self, conc_a, conc_b, ld, n_genes, sat, nbr, n_sat, k, unsat, near, n_unsat, hexa, dt,
                         recip3, recip3dt, recip_sat, eps, thresh, n_iter, i0, passes, part, tickets, active, sums,
                         prev, done, stream):
        self.calls.append("passes")
        n = int(max(_view(sat, np.int32, n_sat).max(initial=-1), _view(unsat, np.int32, n_unsat).max(initial=-1))) + 1
        assert i0 + passes <= n_iter + 1 and ld == n_genes + n_genes % 2  # even: two genes a lane
        tb = self._stencil(sat, nbr, n_sat, k, unsat, near, n_unsat)
        bufs = (_tview(conc_a, np.float32, (n, ld))[:, :n_genes], _tview(conc_b, np.float32, (n, ld))[:, :n_genes])
        parts, groups = tops._k11_levels(n_sat)
        tiles = -(-n_genes // 64)
        assert _view(part, np.float32, 4 * 32 * tiles * max(parts, 1)).size
        tk = _tview(tickets, np.int32, (max(groups, 1), tiles))
        act = _tview(active, np.uint8, (2, n_genes))
        sm = _tview(sums, np.float32, (2, n_genes))
        pv, dn = _tview(prev, np.float32, (n_genes,)), _tview(done, np.float32, (n_genes,))
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        for p in range(i0, i0 + passes):
            self.passes.append(p)
            a = p & 1
            src, dst = bufs[a], bufs[a ^ 1]
            live = act[a].bool()
            copy = ~live & (dn == p - 2)
            step, ent = live & (p < n_iter), live & (p >= 1)
            assert bool((tk == 0).all())
            new = self._step(src, dst, tb, bool(hexa), f32(dt), f32(recip3), f32(recip3dt))
            dst[:, step] = new[:, step]
            zero = torch.zeros((), dtype=torch.float32)
            x = torch.where(step[None, :] & (new[tb[0]] > 0), new[tb[0]], zero)
            safe = torch.where(sm[a] < eps, torch.ones(n_genes), sm[a])
            h = torch.where(ent[None, :], self._terms(src[tb[0]], safe, f32(eps)), zero)
            src[:, copy] = dst[:, copy]
            both = torch.stack([x, h], dim=-1).view(n_sat, -1)
            level = _tree(_run_sums(both), 32)  # one partial a block of 256 rows (32 runs)
            while level.shape[0] > 1:  # groups of 32, each folded by whichever member arrives last
                level = _tree(level, 32)
            root = level[0].view(n_genes, 2)
            conv = torch.zeros(n_genes, dtype=torch.bool)
            if p >= 1:
                e = torch.where(sm[a] < eps, zero, -root[:, 1]) * f32(recip_sat)
                conv = ent & ((e - pv).abs() <= f32(thresh))
                dn[conv] = float(p - 1)
                pv[ent] = e[ent]
            sm[a ^ 1][step] = root[step, 0]
            act[a ^ 1] = (live & ~conv).to(torch.uint8)
        return 0

    def sqt_sepal_resident(self, conc, ld, n_genes, n, sat, nbr, n_sat, k, unsat, near, n_unsat, hexa, dt, recip3,
                           recip3dt, recip_sat, eps, thresh, n_iter, genes, done, stream):
        self.calls.append("resident")
        assert 1 <= genes <= tops._RES_MAX_GENES and ld == n_genes
        assert tops._k11_resident_smem(n, n_sat, genes) + tops._RES_STATIC <= self.optin
        tb = self._stencil(sat, nbr, n_sat, k, unsat, near, n_unsat)
        state = _tview(conc, np.float32, (n, ld))
        dn = _tview(done, np.float32, (n_genes,))
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        span = max(32, tops._next_pow2(-(-n_sat // 32)))
        zero = torch.zeros((), dtype=torch.float32)
        for g0 in self.rng.permutation(range(0, n_genes, genes)):  # blocks in any order
            cols = slice(g0, min(g0 + genes, n_genes))
            buf = [state[:, cols].clone(), _clamp0(state[:, cols])]
            gn = buf[0].shape[1]
            live = torch.ones(gn, dtype=torch.bool)
            prev, s_sum = torch.ones(gn), torch.zeros(gn)
            d = torch.full((gn,), float("nan"))
            final = torch.zeros(gn, dtype=torch.long)
            for p in range(n_iter + 1):
                if not bool(live.any()):
                    break
                cur, step = p & 1, p < n_iter
                old = buf[cur]
                new = self._step(old, buf[cur ^ 1], tb, bool(hexa), f32(dt), f32(recip3), f32(recip3dt))
                if step:
                    buf[cur ^ 1][:, live] = new[:, live]
                x = torch.where(step & (new[tb[0]] > 0), new[tb[0]], zero)
                safe = torch.where(s_sum < eps, torch.ones(gn), s_sum)
                h = self._terms(old[tb[0]], safe, f32(eps)) if p >= 1 else torch.zeros_like(x)
                both = torch.stack([x, h], dim=-1).view(n_sat, -1)
                chunks = _tree(_run_sums(both), 4)  # a warp's 32 positions: 4 runs
                v = _tree(torch.nn.functional.pad(chunks, (0, 0, 0, span - chunks.shape[0])), span)[0].view(gn, 2)
                stop = torch.zeros(gn, dtype=torch.bool)
                if p >= 1:
                    e = torch.where(s_sum < eps, zero, -v[:, 1]) * f32(recip_sat)
                    conv = live & ((e - prev).abs() <= f32(thresh))
                    d[conv] = float(p - 1)
                    prev = torch.where(live, e, prev)
                    stop |= conv
                if not step:
                    stop |= live
                stop &= live
                s_sum = torch.where(live & ~stop, v[:, 0], s_sum)
                final[stop] = cur
                live &= ~stop
                if p == 0 and n_iter > 0:
                    buf[0] = _clamp0(buf[0])
            for gi in range(gn):
                state[:, g0 + gi] = buf[int(final[gi])][:, gi]
            dn[cols] = d
        return 0


_H100_OPTIN = 232_448  # the opt-in shared memory a block of an H100


@pytest.fixture()
def k11(monkeypatch):
    """K11's C interface emulated (``_EmulatedK11``) behind the wrapper's
    CUDA branch, every tensor on the CPU; the card's opt-in shared memory
    as given, which picks the route."""

    def make(optin: int) -> _EmulatedK11:
        emu = _EmulatedK11(optin)
        monkeypatch.setattr(_cuda, "library", lambda: emu)
        monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
        monkeypatch.setattr(_cuda, "require", lambda *args, **kwargs: None)
        monkeypatch.setitem(_cuda.launches, "sepal_diffusion", 0)
        monkeypatch.setitem(_cuda.launches, "sepal_resident", 0)
        return emu

    return make


def _k11_both(x: np.ndarray, tables, hexa: bool, n_iter: int, thresh: float, dt: float = 0.001):
    """The K11 wrapper (around the emulation) and the plain version."""
    t32 = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) for a in tables]
    got = tops._diffusion_k11(torch.from_numpy(x), *t32, hexa, n_iter, dt, thresh)
    want = tops._diffusion_plain(torch.from_numpy(x), *t32, hexa, n_iter, dt, thresh)
    return got, want


def _assert_k11_equal(got, want) -> None:
    (dg, sg), (dw, sw) = got, want
    assert torch.equal(torch.nan_to_num(dg, nan=-1.0), torch.nan_to_num(dw, nan=-1.0))
    assert torch.equal(sg, sw)


def _k11_data(side: int, n_genes: int, hexa: bool, seed: int) -> tuple[np.ndarray, tuple]:
    """float32 counts on a lattice with a zero gene (it converges at step 1)
    and a gene with negative entries (clamped at step 0)."""
    adata = _grid_adata(side=side, n_genes=n_genes, hexa=hexa, seed=seed)
    x = np.asarray(adata.X, dtype=np.float32)
    x[:, 1] = 0.0
    x[::7, 2] = -3.0
    return x, _tables(adata, 6 if hexa else 4)


@pytest.mark.parametrize("thresh", [0.0, 1e-8, 1e-6])
@pytest.mark.parametrize("hexa", [False, True], ids=["square", "hex"])
@pytest.mark.parametrize("route", ["streaming", "resident"])
def test_k11_routes_emulated_match_plain(route, hexa, thresh, k11):
    """Both routes bitwise the plain version (steps and state), float32:
    the late entropy, the one-pass-late freeze and its copy, the returned
    buffer, the fold of the partials; a budget that is no multiple of 64 at
    ``thresh=0`` (only the zero gene converges), the default threshold and
    a looser one."""
    emu = k11(_H100_OPTIN if route == "resident" else 0)
    x, tables = _k11_data(14, 11, hexa, seed=21)
    n_iter = 150 if thresh == 0.0 else 1500
    got, want = _k11_both(x, tables, hexa, n_iter, thresh)
    _assert_k11_equal(got, want)
    assert float(got[0][1]) == 1.0
    if thresh == 0.0:
        assert int(torch.isnan(got[0]).sum()) == x.shape[1] - 1
    else:  # the noise genes converge within the budget
        assert bool(torch.isfinite(got[0][1:]).all())
    if route == "resident":
        assert emu.calls == ["resident"] and _cuda.launches["sepal_resident"] == 1
        assert _cuda.launches["sepal_diffusion"] == 0
    else:
        assert set(emu.calls) == {"passes"} and _cuda.launches["sepal_diffusion"] == len(emu.calls)
        assert emu.passes == list(range(len(emu.passes)))
        if thresh == 0.0:
            assert len(emu.passes) == n_iter + 1 and len(emu.calls) == 3  # 64 + 64 + 23 passes


@pytest.mark.parametrize("edge", ["call end - 1", "call end", "budget end - 1", "budget end", "never"])
def test_k11_streaming_freeze_at_the_edges(edge, k11, monkeypatch):
    """A gene that freezes at the last steps of a call of passes (its
    convergence known in the next call's first pass, its copy then), at the
    last steps of the budget, or never; the wrapper's early stop when every
    gene is done; frozen at steps 0 and 1 (every gene at a loose threshold;
    the zero gene)."""
    emu = k11(0)
    x, tables = _k11_data(12, 9, False, seed=22)
    plain = _k11_both(x, tables, False, 3000, 1e-5)[1][0].numpy()
    last = int(np.nanmax(plain))  # the last gene to converge
    assert np.isfinite(plain).all() and last > 5
    n_iter, every = 3000, 64
    if edge == "call end - 1":
        every = last + 2  # known in the call's last pass, copied in the next call's first
    elif edge == "call end":
        every = last + 1  # known in the next call's first pass
    elif edge == "budget end - 1":
        n_iter = last + 2
    elif edge == "budget end":
        n_iter = last + 1  # known in the last pass, which takes no step
    else:
        n_iter = last
    monkeypatch.setattr(tops, "_CHECK_EVERY", every)
    emu.passes.clear()
    got, want = _k11_both(x, tables, False, n_iter, 1e-5)
    _assert_k11_equal(got, want)
    assert bool(torch.isnan(got[0]).any()) == (edge == "never")
    assert max(emu.passes) <= n_iter
    if edge == "call end - 1":
        assert max(emu.passes) == every - 1  # every gene done after the first call: no copy needed
    elif edge == "call end":
        assert max(emu.passes) == min(2 * every - 1, n_iter)  # the early stop after the second call
    k11(0)
    every_gene = _k11_both(x, tables, False, 40, 10.0)
    _assert_k11_equal(*every_gene)
    assert bool((every_gene[0][0] == 0.0).all())


@pytest.mark.parametrize("route", ["streaming", "resident"])
@pytest.mark.parametrize("n_iter", [0, 1, 2, 64, 65, 203])
def test_k11_short_budgets_and_rows_outside_both_tables(route, n_iter, k11):
    """Budgets of 0, 1, 2, 64, 65 and 203 steps; nodes of degree above k
    (in neither table: a step keeps them, clamped at 0) and negative
    entries there, on both routes."""
    k11(_H100_OPTIN if route == "resident" else 0)
    adata = _grid_adata(side=10, n_genes=5, seed=23)
    g = sp.lil_matrix(adata.obsp["spatial_connectivities"])
    for a, b in ((11, 88), (45, 54), (23, 77)):  # long edges: degree-5 nodes
        g[a, b] = g[b, a] = 1.0
    adata.obsp["spatial_connectivities"] = g.tocsr()
    tables = _tables(adata, 4)
    assert len(tables[0]) + len(tables[2]) < adata.n_obs
    x = np.asarray(adata.X, dtype=np.float32)
    x[[11, 88, 45], :] = -2.5
    got, want = _k11_both(x, tables, False, n_iter, 1e-6)
    _assert_k11_equal(got, want)


def _jax_state(x: np.ndarray, tables, hexa: bool, n_iter: int, dt: float) -> np.ndarray:
    """The JAX package's loop body (``squidpy_tpu/ops/sepal.py``) with every
    gene active, ``n_iter`` times: its state at ``thresh=0``."""
    sat, sat_idx, unsat, pos = (jnp.asarray(a) for a in tables)

    def body(_, conc):
        nhood = jnp.sum(conc[sat_idx, :], axis=1)
        centre = conc[sat, :]
        d2 = (2.0 * nhood - 12.0 * centre) / 3.0 if hexa else nhood - 4.0 * centre
        new = conc.at[sat, :].add(d2 * dt)
        new = new.at[unsat, :].add(d2[pos, :] * dt)
        return jnp.maximum(new, 0.0)

    return np.asarray(jax.jit(lambda c: jax.lax.fori_loop(0, n_iter, body, c))(jnp.asarray(x)))


@pytest.mark.parametrize("hexa", [False, True], ids=["square", "hex"])
@pytest.mark.parametrize("route", ["streaming", "resident"])
def test_k11_routes_emulated_match_jax_states(route, hexa, k11):
    """At ``thresh=0`` every gene but the zero one runs the budget: both
    routes' states bitwise JAX's loop on the CPU in float32 (XLA keeps no
    FMA and multiplies by the rounded 1/3, as the port), the steps JAX's."""
    k11(_H100_OPTIN if route == "resident" else 0)
    x, tables = _k11_data(13, 7, hexa, seed=24)
    with _x64_off():
        want_state = _jax_state(x, tables, hexa, 97, 0.001)
        want_done = np.asarray(jops.sepal_diffusion(jnp.asarray(x), *(jnp.asarray(a) for a in tables), hexa, 97,
                                                    0.001, 0.0))
    done, state = _k11_both(x, tables, hexa, 97, 0.0)[0]
    np.testing.assert_array_equal(done.numpy(), want_done)
    live = np.isnan(want_done)
    np.testing.assert_array_equal(state.numpy()[:, live], want_state[:, live])


@pytest.mark.parametrize("n,n_sat,n_genes,optin,most,genes", [
    (4992, 4800, 2000, _H100_OPTIN, 5, 4),  # a Visium section: two 20 KB columns a gene; 500 blocks in 4 rounds
    (4992, 4800, 3, _H100_OPTIN, 3, 2),
    (99_856, 99_225, 256, _H100_OPTIN, 0, 0),  # 316 x 316 bins: streaming
    (1_000_000, 996_004, 64, _H100_OPTIN, 0, 0),
    (1000, 900, 40, _H100_OPTIN, 8, 4),
    (1000, 900, 5000, _H100_OPTIN, 8, 8),
    (4992, 4800, 2000, 0, 0, 0),
])
def test_k11_route(n, n_sat, n_genes, optin, most, genes):
    """The most genes whose buffers fit, and from half that up the count
    with the fewest genes a block times rounds of blocks on 132 SMs."""
    assert tops._k11_route(n, n_sat, n_genes, optin, 132) == genes
    if most:
        assert tops._k11_resident_smem(n, n_sat, most) + tops._RES_STATIC <= optin
    if 0 < most < min(n_genes, tops._RES_MAX_GENES):
        assert tops._k11_resident_smem(n, n_sat, most + 1) + tops._RES_STATIC > optin
    if genes:
        rounds = lambda g: -(-(-(-n_genes // g)) // 132) * g  # noqa: E731
        assert all(rounds(genes) <= rounds(g) for g in range(-(-most // 2), most + 1))


@pytest.mark.parametrize("n_sat,parts,groups", [(1, 0, 0), (256, 0, 0), (257, 2, 1), (8192, 32, 1),
                                                (8193, 33 + 2, 2 + 1), (996_004, 3891 + 122 + 4, 122 + 4 + 1)])
def test_k11_levels(n_sat, parts, groups):
    assert tops._k11_levels(n_sat) == (parts, groups)


@pytest.mark.cuda
def test_k11_streaming_route_matches_plain_on_card(cuda_card, monkeypatch):
    """The streaming route forced on shapes the resident route would take:
    bitwise the plain version, an odd gene count (the padded leading
    dimension), a zero gene, the budget and the default threshold."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(tops, "_k11_route", lambda *args: 0)
    for side, hexa, n_genes, n_iter, thresh in ((20, False, 41, 300, 0.0), (23, True, 71, 3000, 1e-8)):
        x, tables = _k11_data(side, n_genes, hexa, seed=side)
        t32 = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(cuda) for a in tables]
        xc = torch.from_numpy(x).to(cuda)
        dk, sk = tops.sepal_diffusion(xc, *t32, hexa, n_iter, 0.001, thresh, return_state=True)
        dp, spl = tops._diffusion_plain(xc, *t32, hexa, n_iter, 0.001, thresh)
        assert torch.equal(torch.nan_to_num(dk, nan=-1.0), torch.nan_to_num(dp, nan=-1.0))
        assert torch.equal(sk, spl)
