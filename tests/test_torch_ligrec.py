"""squidpy_torch ligrec against squidpy_tpu's (``gr/_ligrec.py``, ``ops/ligrec.py``).

Tolerances: the observed means, the exceedance counts and the p-values are
bitwise equal on integral data on both precision routes (float64 up to 4M
elements of the filtered matrix, float32 above), with the receptor's term of
the compare fused into one fma as XLA computes it on the CPU
(``test_jax_fuses_the_receptor_term`` pins that). On fractional data the
sums are added in another order, so a compare can flip only where the two
sides lie within a few ulps: ``test_fractional_differences_are_near_ties``.
Interactions, their order and metadata are equal to ``pt.interactions``. K9
is held to its plain version on the card (marked ``cuda``).
"""

from __future__ import annotations

from contextlib import contextmanager
from fractions import Fraction
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.gr import _ligrec as tlr
from squidpy_torch.ops import ligrec as tops
from squidpy_tpu._core.anndata import Raw
from squidpy_tpu.gr._ligrec import PermutationTest as JPermutationTest
from squidpy_tpu.ops import ligrec as jops

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _adata(n: int = 400, g: int = 16, n_cls: int = 4, seed: int = 0, frac: bool = False, nan: bool = False,
           dtype=np.float32) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    x = rng.poisson(1.0, (n, g)).astype(dtype)
    if frac:
        x = (x * rng.lognormal(0.0, 0.5, x.shape)).astype(dtype)
    if nan:
        x[rng.random(x.shape) < 0.01] = np.nan
    labels = rng.integers(0, n_cls, n)
    adata = sq.AnnData(X=x, obs=pd.DataFrame({"cl": pd.Categorical([f"c{v}" for v in labels])}))
    adata.var_names = [f"g{i}" for i in range(g)]
    return adata


def _interactions(adata, k: int = 4) -> list[tuple[str, str]]:
    genes = list(adata.var_names)
    return list(product(genes[:k], genes[k : 2 * k]))


def _assert_same(rt: tlr.LigrecResult, rj: dict) -> None:
    assert rt.means.index == list(rj["means"].index)
    assert rt.means.columns == list(rj["means"].columns)
    assert rt.pvalues.index == rt.means.index and rt.pvalues.columns == rt.means.columns
    np.testing.assert_array_equal(rt.means.values, rj["means"].to_numpy(dtype=float))
    np.testing.assert_array_equal(rt.pvalues.values, rj["pvalues"].to_numpy(dtype=float))
    meta = rj["metadata"]
    assert list(rt.metadata) == list(meta.columns)
    for c in meta.columns:
        assert list(rt.metadata[c]) == list(meta[c])


def _both(adata_j, adata_t, **kw) -> tuple[tlr.LigrecResult, dict]:
    rj = sq.gr.ligrec(adata_j, "cl", copy=True, **kw)
    rt = sqt.gr.ligrec(adata_t, "cl", copy=True, **kw)
    return rt, rj


# --- ops: observed means and permutation counts -----------------------------------


def _count_inputs(n: int, g: int, n_cls: int, n_perms: int, dtype, seed: int, frac: bool = False,
                  empty: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.poisson(1.0, (n, g)).astype(dtype)
    if frac:
        x = (x * rng.lognormal(0.0, 0.5, x.shape)).astype(dtype)
    lab = rng.integers(0, n_cls - 1 if empty else n_cls, n)
    sh = np.stack([rng.permutation(lab) for _ in range(n_perms)]).astype(np.int32)
    counts = np.bincount(lab, minlength=n_cls).astype(dtype)
    rec, lig = rng.integers(0, g, 12).astype(np.int32), rng.integers(0, g, 12).astype(np.int32)
    pairs = np.array(list(np.ndindex(n_cls, n_cls)), dtype=np.int32)
    mean = (x.T @ np.eye(n_cls, dtype=dtype)[lab]) / np.where(counts == 0, 1, counts).astype(dtype)
    m_sum = (mean[rec[:, None], pairs[None, :, 0]] + mean[lig[:, None], pairs[None, :, 1]]).astype(dtype)
    return x, lab, sh, counts, rec, lig, pairs[:, 0].copy(), pairs[:, 1].copy(), m_sum


def _jax_counts(x, sh, counts, rec, lig, c1, c2, m_sum, n_cls, chunk_size=None):
    args = [jnp.asarray(a) for a in (x, sh, counts, rec, lig, c1, c2, m_sum)]
    return np.asarray(jops.ligrec_perm_counts(*args, n_cls, chunk_size=chunk_size))


def _port_counts(x, sh, counts, rec, lig, c1, c2, m_sum, n_cls, chunk_size=None):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, sh, counts, rec, lig, c1, c2, m_sum)]
    return tops.ligrec_perm_counts(*args, n_cls, chunk_size=chunk_size).numpy()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_cls,empty", [(4, False), (2, False), (5, True)])
def test_cluster_means_bitwise(dtype, n_cls, empty):
    x, lab, *_ = _count_inputs(300, 9, n_cls, 1, dtype, seed=n_cls, empty=empty)
    want = np.asarray(jops.cluster_means(jnp.asarray(x), jnp.asarray(lab), n_cls))
    got = tops.cluster_means(torch.from_numpy(x), torch.from_numpy(lab), n_cls).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if empty:
        assert (got[-1] == 0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_perms", [1, 3, 5, 17])
@pytest.mark.parametrize("n_cls,empty", [(4, False), (2, False), (5, True)])
def test_perm_counts_bitwise(dtype, n_perms, n_cls, empty):
    """Integral data, chunk 2 in both packages: the counts are equal,
    entry for entry, the many exact ties of integral sums included."""
    inputs = _count_inputs(257, 10, n_cls, n_perms, dtype, seed=n_perms * 7 + n_cls, empty=empty)
    x, lab, *rest = inputs
    want = _jax_counts(x, *rest, n_cls, chunk_size=2)
    got = _port_counts(x, *rest, n_cls, chunk_size=2)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_perm_counts_across_slabs():
    """Cells past one slab (K9's order: by cell in a slab, then by slab)
    give the same counts as JAX's, and the chunking changes nothing."""
    x, lab, *rest = _count_inputs(2 * tops.SLAB + 37, 6, 3, 4, np.float32, seed=5)
    want = _jax_counts(x, *rest, 3)
    np.testing.assert_array_equal(_port_counts(x, *rest, 3, chunk_size=3), want)
    np.testing.assert_array_equal(_port_counts(x, *rest, 3), want)


def _fma_rounding(sums, inv, c1, c2, rec, lig, m_sum, dtype, fused: bool) -> np.ndarray:
    """Counts with the left side rounded as ``fma(s_rec, inv_rec, g_lig)``
    (exactly, by rationals) or as the unfused ``g_rec + g_lig``."""
    s_rec, s_lig = sums[:, c1[None], rec[:, None]], sums[:, c2[None], lig[:, None]]
    g_lig = (s_lig * inv[c2][None, None]).astype(dtype)
    if fused:
        flat = [Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
                for a, b, c in zip(s_rec.ravel(), np.broadcast_to(inv[c1][None, None], s_rec.shape).ravel(),
                                   g_lig.ravel())]
        exact = np.array([float(v) for v in flat]).reshape(s_rec.shape)
        left = exact.astype(dtype)
        # float(v) rounds once to float64; for float32 take the nearest float32 to the rational
        if dtype == np.float32:
            for k, v in enumerate(flat):
                cands = [np.nextafter(left.flat[k], np.float32(-np.inf)), left.flat[k],
                         np.nextafter(left.flat[k], np.float32(np.inf))]
                left.flat[k] = min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                                         int(np.array(c).view(np.int32)) & 1))
    else:
        left = ((s_rec * inv[c1][None, None]).astype(dtype) + g_lig).astype(dtype)
    return (left > m_sum[None]).sum(axis=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jax_fuses_the_receptor_term(dtype):
    """XLA on the CPU fuses ``groups[c1, rec] * inv[c1]`` into the add:
    JAX's counts equal the fused rounding on integral data and differ from
    the unfused one there, so the port fuses the same term."""
    x, lab, sh, counts, rec, lig, c1, c2, m_sum = _count_inputs(120, 5, 3, 30, dtype, seed=11)
    inv = (1.0 / counts).astype(dtype)
    sums = np.stack([(x.T @ np.eye(3, dtype=dtype)[s]).T for s in sh])  # exact: integral
    want = _jax_counts(x, sh, counts, rec, lig, c1, c2, m_sum, 3)
    fused = _fma_rounding(sums, inv, c1, c2, rec, lig, m_sum, dtype, fused=True)
    unfused = _fma_rounding(sums, inv, c1, c2, rec, lig, m_sum, dtype, fused=False)
    np.testing.assert_array_equal(want, fused)
    assert not np.array_equal(want, unfused)
    np.testing.assert_array_equal(_port_counts(x, sh, counts, rec, lig, c1, c2, m_sum, 3), fused)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fractional_differences_are_near_ties(dtype):
    """Fractional data: the port sums each cluster in slab order, XLA in its
    dot's order, so the sums may differ in the last bits and a compare may
    flip, but only where the fused left side lies within 64 ulps of
    ``m_sum`` (each package's float32 sums of ~175 terms err by far less)."""
    x, lab, sh, counts, rec, lig, c1, c2, m_sum = _count_inputs(700, 8, 4, 40, dtype, seed=3, frac=True)
    want = _jax_counts(x, sh, counts, rec, lig, c1, c2, m_sum, 4)
    got = _port_counts(x, sh, counts, rec, lig, c1, c2, m_sum, 4)
    sums = np.stack([(x.astype(np.float64).T @ np.eye(4)[s]).T for s in sh])  # float64 reference sums
    inv = (1.0 / counts).astype(dtype).astype(np.float64)
    left = sums[:, c1[None], rec[:, None]] * inv[c1][None, None] + sums[:, c2[None], lig[:, None]] * inv[c2][None, None]
    ulp = np.spacing(np.abs(m_sum).astype(dtype)).astype(np.float64)
    near = (np.abs(left - m_sum[None]) <= 64 * ulp[None]).sum(axis=0)
    assert np.all(np.abs(got - want) <= near)
    assert near.sum() <= 0.01 * left.size


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fma_plain_is_correctly_rounded(dtype):
    """The plain version's fma against rational arithmetic, on counts times
    reciprocals (the compare's operands) and on cancelling random products."""
    rng = np.random.default_rng(7)
    np_t = np.float32 if dtype == torch.float32 else np.float64
    a = np.concatenate([rng.integers(0, 3000, 1500), rng.standard_normal(1500) * 2.0 ** rng.integers(-20, 20, 1500)])
    b = np.concatenate([1.0 / rng.integers(1, 700, 1500), rng.standard_normal(1500)])
    a, b = a.astype(np_t), b.astype(np_t)
    c = np.concatenate([(rng.integers(0, 3000, 1500) / rng.integers(1, 700, 1500)).astype(np_t),
                        (-(a[1500:].astype(np.float64) * b[1500:]) * (1 + 1e-6 * rng.standard_normal(1500))).astype(np_t)])
    got = tops.fma_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(g)) - v)
        for nb in (np.nextafter(g, np_t(-np.inf)), np.nextafter(g, np_t(np.inf))):
            assert err <= abs(Fraction(float(nb)) - v)


def test_fma_plain_keeps_non_finite():
    a = torch.tensor([np.inf, 1.0, np.nan, 2.0], dtype=torch.float64)
    b = torch.tensor([1.0, np.inf, 1.0, 3.0], dtype=torch.float64)
    c = torch.tensor([0.0, 1.0, 0.0, -np.inf], dtype=torch.float64)
    out = tops.fma_plain(a, b, c)
    assert out[0] == np.inf and out[1] == np.inf and torch.isnan(out[2]) and out[3] == -np.inf
    assert torch.equal(tops.fma_plain(a.float(), b.float(), c.float()).isinf(), out.isinf())


def test_labels_outside_the_clusters_add_nothing():
    x, lab, sh, counts, rec, lig, c1, c2, m_sum = _count_inputs(300, 6, 3, 5, np.float64, seed=2)
    bad = sh.copy()
    bad[:, ::5] = -1
    keep = np.ones(300, bool)
    keep[::5] = False
    sums = tops._cluster_sums_plain(torch.from_numpy(x), torch.from_numpy(bad), 3).numpy()
    want = np.stack([(x[keep].T @ np.eye(3)[s[keep]]).T for s in sh])
    np.testing.assert_array_equal(sums, want)


def _route_input(case: str, dtype) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(3)
    x = rng.poisson(1.0, (500, 6)).astype(np.float64)
    n_cls = 4
    if case == "fractional":
        x[7, 2] = 0.5
    elif case == "negative":
        x[3, 1] = -1.0
    elif case == "above 255":
        x[9, 0] = 256.0
    elif case == "at 255":
        x[9, 0] = 255.0
    elif case == "nan":
        x[0, 0] = np.nan
    elif case == "infinite":
        x[0, 0] = np.inf
    elif case in ("column total 2^24", "column total 2^24 - 1"):
        x = np.zeros((65_794, 2))
        x[:65_793, 1] = 255.0  # 2^24 - 1
        x[65_793, 1] = 1.0 if case == "column total 2^24" else 0.0
    elif case == "256 clusters":
        n_cls = 256
    return x.astype(dtype), n_cls


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["integral", "at 255", "fractional", "negative", "above 255", "nan", "infinite",
                                  "column total 2^24", "column total 2^24 - 1", "256 clusters"])
def test_k9_route(case, dtype):
    """The integral route takes integral X in [0, 255] whose every column
    total is below 2^24 (float32) or 2^53 (float64), with at most 255
    clusters; everything else the float route."""
    x, n_cls = _route_input(case, dtype)
    integral = case in ("integral", "at 255", "column total 2^24 - 1") or (
        case == "column total 2^24" and dtype == np.float64)
    assert tops._k9_route(torch.from_numpy(x), n_cls) == ("integral" if integral else "float")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,n_cls,outside", [(300, 3, False), (5000, 16, True), (2 * tops.SLAB + 77, 7, True),
                                             (65_794, 2, False)])
def test_integral_sums_equal_the_float_order(n, n_cls, outside, dtype):
    """Under the route rule the integral route's exact sums, rounded once,
    are bitwise the float route's slab-order sums: every partial sum is an
    integer below 2^24, so no order rounds. At 65,794 cells a column sums to
    2^24 - 1 (the largest the rule lets through in float32)."""
    rng = np.random.default_rng(n)
    if n == 65_794:
        x = np.zeros((n, 3))
        x[: n - 1, 1] = 255.0
        x[:, 2] = rng.integers(0, 256, n)
        x[:, 2] *= x[:, 2].sum() < 2**24
    else:
        x = rng.poisson(3.0, (n, 5)).astype(np.float64)
        x[::11, 0] = 255.0
    x = torch.from_numpy(x.astype(dtype))
    sh = torch.from_numpy(np.stack([rng.permutation(rng.integers(0, n_cls, n)) for _ in range(4)]).astype(np.int32))
    if outside:
        sh[:, ::5] = -1
        sh[:, 1::7] = n_cls + 2
    assert tops._k9_route(x, n_cls) == "integral"
    assert torch.equal(tops._cluster_sums_int(x, sh, n_cls), tops._cluster_sums_plain(x, sh, n_cls))


def test_labels_u8_and_counts_operand():
    """K9's operands: uint8 labels, rows padded to 128 columns with 255,
    labels outside the clusters as 255, and padded uint8 labels taken as
    they are; X transposed to uint8, zero past n."""
    lab = torch.tensor([[0, 3, -1, 4, 2], [1, 1, 255, 0, 3]], dtype=torch.int32)
    u8 = tops._labels_u8(lab, 5, 4)
    assert u8.dtype == torch.uint8 and u8.shape == (2, 128)
    assert u8[:, :5].tolist() == [[0, 3, 255, 255, 2], [1, 1, 255, 0, 3]] and bool((u8[:, 5:] == 255).all())
    assert tops._labels_u8(u8, 5, 4) is u8
    assert tops.label_stride(128) == 128 and tops.label_stride(129) == 256 and tops.label_stride(1) == 128
    x = torch.tensor([[1.0, 255.0], [0.0, 7.0], [3.0, 0.0]])
    xt = tops.counts_operand(x)
    assert xt.dtype == torch.uint8 and xt.shape == (2, 128)
    assert xt[:, :3].tolist() == [[1, 0, 3], [255, 7, 0]] and not bool(xt[:, 3:].any())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_perm_counts_take_padded_uint8_labels(dtype):
    """The counts from K10's uint8 rows (padded, 255 past n) equal those
    from int32 labels, on both routes."""
    x, lab, sh, counts, rec, lig, c1, c2, m_sum = _count_inputs(700, 9, 5, 6, dtype, seed=8)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, sh, counts, rec, lig, c1, c2, m_sum)]
    u8 = tops._labels_u8(args[1], 700, 5)
    for route in ("integral", "float"):
        want = tops.ligrec_perm_counts(*args, 5, route=route)
        got = tops.ligrec_perm_counts(args[0], u8, *args[2:], 5, route=route)
        assert torch.equal(got, want)


def test_ligrec_takes_the_integral_route_on_counts(monkeypatch):
    """``ligrec`` on counts sums by the integral route (and on fractional
    data by the float route), bitwise JAX's either way."""
    taken = []
    own = tops._cluster_sums_int
    monkeypatch.setattr(tops, "_cluster_sums_int", lambda *a: taken.append(1) or own(*a))
    for frac in (False, True):
        adata = _adata(n=600, g=12, n_cls=4, seed=21, frac=frac)
        rt, rj = _both(adata, adata, interactions=_interactions(adata), n_perms=30, seed=2, use_raw=False)
        _assert_same(rt, rj)
        assert bool(taken) == (not frac)
        taken.clear()


@pytest.mark.parametrize("n_cls,itemsize,layout", [(16, 4, (4, 4)), (16, 8, (4, 4)), (2, 8, (4, 4)), (100, 4, (4, 2)),
                                                    (100, 8, (4, 1)), (300, 8, (3, 1)), (1000, 8, (0, 1))])
def test_k9_layout(n_cls, itemsize, layout):
    warps, per_warp = tops._k9_layout(n_cls, itemsize)
    assert (warps, per_warp) == layout
    assert warps * per_warp * n_cls * 32 * itemsize <= 227 * 1024


# --- prepare: interaction forms, upper-casing, filters, complexes -------------------------


def _pt_pair(adata, use_raw=False):
    return JPermutationTest(adata, use_raw=use_raw), tlr.PermutationTest(adata, use_raw=use_raw)


def _assert_same_interactions(pt_t, pt_j) -> None:
    df = pt_j.interactions
    assert list(pt_t.interactions) == list(df.columns)
    for c in df.columns:
        want = [None if (isinstance(v, float) and v != v) else v for v in df[c]]
        assert list(pt_t.interactions[c]) == want, c


def _forms(adata):
    g = list(adata.var_names)
    pairs = [(g[0], g[1]), (g[2].upper(), g[3]), (g[1], g[0]), (g[0], g[1]), (g[4], "absent")]
    return {
        "dataframe": pd.DataFrame({"source": [p[0] for p in pairs], "target": [p[1] for p in pairs],
                                   "zeta": list(range(5)), "alpha": list("abcde")}),
        "mapping": {"target": [p[1] for p in pairs], "source": [p[0] for p in pairs], "meta": [1.5] * 5},
        "genes": g[:4],
        "pair_of_sequences": (g[:3], g[3:6]),
        "pairs": pairs,
        "none_rows": pd.DataFrame({"source": [g[0], None, g[2], np.nan], "target": [g[1], g[2], None, g[3]]}),
    }


@pytest.mark.parametrize("form", ["dataframe", "mapping", "genes", "pair_of_sequences", "pairs", "none_rows"])
def test_prepare_forms(form):
    adata = _adata(g=10)
    interactions = _forms(adata)[form]
    pt_j, pt_t = _pt_pair(adata)
    pt_j.prepare(interactions)
    pt_t.prepare(interactions)
    _assert_same_interactions(pt_t, pt_j)
    assert [pt_t._genes[p] for p in pt_t._filtered] == list(pt_j._filtered_data.columns)


def test_prepare_upper_cases_and_drops_duplicate_genes():
    adata = _adata(g=8)
    adata.var_names = ["a", "B", "A", "c", "d", "E", "e", "f"]  # A and E twice after upper-casing
    interactions = [("a", "b"), ("A", "C"), ("e", "F"), ("E", "f")]
    pt_j, pt_t = _pt_pair(adata)
    pt_j.prepare(interactions)
    pt_t.prepare(interactions)
    _assert_same_interactions(pt_t, pt_j)
    assert [pt_t._genes[p] for p in pt_t._filtered] == list(pt_j._filtered_data.columns)
    np.testing.assert_array_equal(pt_t._columns(pt_t._filtered), pt_j._filtered_data.to_numpy())


@pytest.mark.parametrize("policy", ["min", "all"])
def test_prepare_complexes(policy):
    adata = _adata(g=10, frac=True, seed=4)
    g = list(adata.var_names)
    interactions = pd.DataFrame({
        "source": [f"{g[0]}_{g[1]}_{g[2]}", g[3], f"{g[4]}_missing", "missing_gone", f"{g[5]}_{g[5]}"],
        "target": [g[6], f"{g[7]}_{g[8]}", g[9], g[0], f"{g[1]}_{g[2]}"],
        "kind": ["x", "y", "z", "w", "v"],
    })
    pt_j, pt_t = _pt_pair(adata)
    pt_j.prepare(interactions, complex_policy=policy)
    pt_t.prepare(interactions, complex_policy=policy)
    _assert_same_interactions(pt_t, pt_j)


@pytest.mark.parametrize("labels", [[0, 0, 1, 0, 2], ["b", "a", "b", "b", "a"], [4, 3, 2, 1, 0]],
                         ids=["repeated ints", "repeated strings", "unique, reversed"])
def test_prepare_complexes_all_joins_on_row_labels(labels):
    """``complex_policy='all'`` on a DataFrame whose index repeats labels:
    the JAX package joins each column's member lists on the index, so a row
    takes the members of every row with its label; the port follows its
    rows (a row's own members alone where labels are unique)."""
    adata = _adata(g=10, frac=True, seed=5)
    g = list(adata.var_names)
    interactions = pd.DataFrame({
        "source": [f"{g[0]}_{g[1]}", g[2], f"{g[3]}_{g[4]}", g[5], g[6]],
        "target": [g[6], f"{g[7]}_{g[8]}", g[9], f"{g[1]}_{g[2]}", g[0]],
        "db": list("abcde"),
    }, index=labels)
    pt_j, pt_t = _pt_pair(adata)
    pt_j.prepare(interactions, complex_policy="all")
    pt_t.prepare(interactions, complex_policy="all")
    _assert_same_interactions(pt_t, pt_j)
    rt, rj = _both(adata, adata, interactions=interactions, complex_policy="all", n_perms=20, seed=0, use_raw=False)
    _assert_same(rt, rj)


def test_prepare_errors():
    adata = _adata()
    with pytest.raises(ValueError, match="No interactions"):
        tlr.PermutationTest(adata, use_raw=False).prepare([])
    with pytest.raises(KeyError, match="source"):
        tlr.PermutationTest(adata, use_raw=False).prepare(pd.DataFrame({"a": [1]}))
    with pytest.raises(ValueError, match="empty"):
        tlr.PermutationTest(adata, use_raw=False).prepare(pd.DataFrame({"source": [], "target": []}))
    with pytest.raises(ValueError, match="no interactions remain"):
        tlr.PermutationTest(adata, use_raw=False).prepare([("x", "y")])
    with pytest.raises(ValueError, match="length `2`"):
        tlr.PermutationTest(adata, use_raw=False).prepare([("g0", "g1", "g2")])
    with pytest.raises(TypeError, match="iterable"):
        tlr.PermutationTest(adata, use_raw=False).prepare(5)
    with pytest.raises(ImportError, match="omnipath"):
        tlr.PermutationTest(adata, use_raw=False).prepare(None)
    with pytest.raises(TypeError, match="AnnData"):
        tlr.PermutationTest(object())
    with pytest.raises(AttributeError, match="raw"):
        tlr.PermutationTest(adata, use_raw=True)


# --- test / ligrec --------------------------------------------------------------------------


@pytest.mark.parametrize("clusters", [None, ["c0", "c2"], [("c2", "c0"), ("c1", "c1"), ("c0", "c3")]],
                         ids=["none", "strings", "pairs"])
def test_ligrec_clusters(clusters):
    """None, strings and pairs; strings and the pairs select a row subset."""
    adata = _adata(seed=1)
    rt, rj = _both(adata, adata, interactions=_interactions(adata), clusters=clusters, n_perms=40, seed=2,
                   use_raw=False)
    _assert_same(rt, rj)


@pytest.mark.parametrize("frac", [False, True], ids=["integral", "fractional"])
def test_ligrec_float64_route(frac):
    """Integral and fractional data in float64: no compare of this input
    lies near a tie (flips are held in test_fractional_differences_*)."""
    adata = _adata(n=600, g=20, n_cls=5, seed=6, frac=frac)
    rt, rj = _both(adata, adata, interactions=_interactions(adata, 6), n_perms=60, seed=0, use_raw=False)
    _assert_same(rt, rj)


def test_ligrec_nan_values():
    adata = _adata(seed=8, nan=True)
    rt, rj = _both(adata, adata, interactions=_interactions(adata), n_perms=30, seed=1, use_raw=False)
    _assert_same(rt, rj)


def test_ligrec_nan_cells_are_left_out():
    """Cells without a cluster: the JAX package raises (``np.isin`` of
    pandas' NA strings); the port leaves them out, which gives JAX's result
    on the other cells, bitwise."""
    adata = _adata(seed=8)
    cl = adata.obs["cl"].astype(object)
    cl.iloc[::17] = np.nan
    adata.obs["cl"] = pd.Categorical(cl)
    kw = dict(interactions=_interactions(adata), n_perms=30, seed=1, use_raw=False, copy=True)
    with pytest.raises(TypeError):
        sq.gr.ligrec(adata, "cl", **kw)
    keep = np.asarray(adata.obs["cl"].notna())
    rj = sq.gr.ligrec(adata[keep].copy(), "cl", **kw)
    _assert_same(sqt.gr.ligrec(adata, "cl", **kw), rj)


def test_ligrec_use_raw_gene_symbols_and_threshold():
    adata = _adata(g=12, seed=9)
    adata.raw = Raw(_adata(g=20, seed=10))
    adata.raw.var["symbol"] = [f"sym{i}" for i in range(20)]
    inter = [(f"SYM{i}", f"sym{j}") for i in range(4) for j in range(5, 9)]
    for kw in (dict(use_raw=True), dict(use_raw=True, threshold=0.3)):
        rt, rj = _both(adata, adata, interactions=inter, n_perms=25, seed=4, gene_symbols="symbol", **kw)
        _assert_same(rt, rj)
    assert list(adata.raw.var_names) == [f"g{i}" for i in range(20)]  # restored


@pytest.mark.parametrize("corr_axis", ["clusters", "interactions"])
@pytest.mark.parametrize("corr_method", ["fdr_bh", "fdr_by", "bonferroni", "holm", "sidak"])
def test_ligrec_fdr(corr_method, corr_axis):
    adata = _adata(seed=12)
    rt, rj = _both(adata, adata, interactions=_interactions(adata), n_perms=30, seed=5, use_raw=False,
                   corr_method=corr_method, corr_axis=corr_axis)
    _assert_same(rt, rj)


def test_ligrec_metadata_and_complex_all():
    adata = _adata(g=10, seed=13)
    g = list(adata.var_names)
    inter = pd.DataFrame({"source": [f"{g[0]}_{g[1]}", g[2]], "target": [g[3], f"{g[4]}_{g[5]}"],
                          "zz": [1, 2], "db": ["x", "y"]})
    rt, rj = _both(adata, adata, interactions=inter, complex_policy="all", n_perms=20, seed=0, use_raw=False)
    _assert_same(rt, rj)
    assert list(rt.metadata) == ["db", "zz"]


def test_ligrec_uns_key_added_and_seed():
    adata = _adata(seed=14)
    inter = _interactions(adata)
    assert sqt.gr.ligrec(adata, "cl", interactions=inter, n_perms=20, seed=3, use_raw=False) is None
    assert sqt.gr.ligrec(adata, "cl", interactions=inter, n_perms=20, seed=3, use_raw=False, key_added="mine") is None
    a, b = adata.uns["cl_ligrec"], adata.uns["mine"]
    assert isinstance(a, sqt.gr.LigrecResult)
    np.testing.assert_array_equal(a.pvalues.values, b.pvalues.values)
    other = sqt.gr.ligrec(adata, "cl", interactions=inter, n_perms=20, seed=4, use_raw=False, copy=True)
    assert not np.array_equal(other.pvalues.values, a.pvalues.values, equal_nan=True)
    rj = sq.gr.ligrec(adata, "cl", interactions=inter, n_perms=20, seed=3, use_raw=False, copy=True)
    _assert_same(a, rj)


def test_ligrec_errors():
    adata = _adata()
    inter = _interactions(adata)
    adata.obs["one"] = pd.Categorical(["x"] * adata.n_obs)
    with pytest.raises(ValueError, match="at least"):
        sqt.gr.ligrec(adata, "one", interactions=inter, use_raw=False, copy=True, n_perms=2)
    with pytest.raises(ValueError, match="Invalid cluster"):
        sqt.gr.ligrec(adata, "cl", interactions=inter, use_raw=False, copy=True, n_perms=2, clusters=["c0", "q"])
    with pytest.raises(ValueError, match="positive"):
        sqt.gr.ligrec(adata, "cl", interactions=inter, use_raw=False, copy=True, n_perms=0)
    with pytest.raises(KeyError):
        sqt.gr.ligrec(adata, "nope", interactions=inter, use_raw=False, copy=True)


@contextmanager
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("subset", [False, True], ids=["device_handle", "host_float32"])
def test_ligrec_float32_route_bitwise(subset):
    """Above 4M elements of the filtered matrix the port runs float32:
    through the device expression handle for all cells, through the host
    otherwise; integral counts give equal means and p-values. With x64 on
    (this suite) the JAX package's handle serves float64 blocks, so its
    handle route is held as the package runs without x64, as on a TPU."""
    adata = _adata(n=90_000, g=64, n_cls=8, seed=15)
    kw = dict(clusters=[f"c{i}" for i in range(7)]) if subset else {}
    kw.update(interactions=_interactions(adata, 32), n_perms=20, seed=1, use_raw=False, copy=True)
    if subset:
        rj = sq.gr.ligrec(adata, "cl", **kw)
    else:
        with _x64_off():
            rj = sq.gr.ligrec(adata, "cl", **kw)
    rt = sqt.gr.ligrec(adata, "cl", **kw)
    assert (adata.uns.get("__squidpy_torch_device_x__None_False") is None) == subset
    _assert_same(rt, rj)


def test_genesymbols_without_a_key_needs_no_pandas():
    from squidpy_torch.gr._utils import _genesymbols

    obj = object()
    with _genesymbols(obj, key=None) as got:
        assert got is obj


@pytest.mark.cuda
def test_k9_matches_plain_on_card(cuda_card):
    """Both K9 routes against the plain version on the card: the integral
    route where the route rule takes it (counts; more than 16 clusters, 64
    genes and a slab), the float route on fractional data and when asked
    for on counts."""
    with sqt.set_device("cuda"):
        for dtype, n_cls, frac, n, g in ((np.float32, 16, False, 5000, 40), (np.float64, 3, True, 4097, 40),
                                         (np.float32, 100, True, 2049, 40), (np.float64, 20, False, 17_000, 70),
                                         (np.float32, 255, False, 3000, 9)):
            x, lab, *rest = _count_inputs(n, g, n_cls, 9, dtype, seed=n, frac=frac)
            args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (x, *rest)]
            route = tops._k9_route(args[0], n_cls)
            assert route == ("float" if frac else "integral")
            got = tops.ligrec_perm_counts(*args, n_cls, chunk_size=4)
            assert torch.equal(got, tops.ligrec_perm_counts_plain(*args, n_cls))
            if not frac:
                assert torch.equal(tops.ligrec_perm_counts(*args, n_cls, route="float"), got)


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
