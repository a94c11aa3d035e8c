"""squidpy_torch dense pair counts (K2) and ``co_occurrence(use_pallas=True)``
against squidpy_tpu's Pallas kernel, run in interpret mode as its own suite
runs it on the CPU.

Tolerance: counts are equal on fixtures asserted to hold no pair on a
threshold's knife edge. Both packages compute the expanded form
``d2 = (|a|^2 + |b|^2) - 2 <a, b>``; the port rounds each product and sum on
its own, while XLA on the CPU may contract them into FMAs, and the expanded
form's own float32 error is a few ulps of ``|a|^2 + |b|^2``. A pair whose
exact d2 lies within that error of a threshold may be counted by one package
and not the other; ``test_differences_are_knife_edge_pairs`` holds every
difference to such pairs. Interpret mode unrolls the threshold loop, so the
fixtures keep n <= 600 and L <= 8.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.ops import dense_pairs as tdp
from squidpy_tpu.ops.pallas_pairs import cooccur_counts_pallas

torch.set_num_threads(1)

_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _knife_edges(pts: np.ndarray, thr: np.ndarray, ulps: float = 16.0) -> list[tuple[int, int, int]]:
    """Pairs ``(i, j, l)``, i < j, whose exact d2 lies within ``ulps`` float32
    ulps of ``|p_i|^2 + |p_j|^2 + thr[l]`` of threshold l."""
    p = np.asarray(pts, np.float64)
    sq_n = (p * p).sum(axis=1)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(axis=2)
    scale = sq_n[:, None] + sq_n[None, :]
    i, j = np.triu_indices(len(p), k=1)
    out = []
    for l, t in enumerate(np.asarray(thr, np.float64)):
        near = np.abs(d2[i, j] - t) <= ulps * _EPS * (scale[i, j] + t)
        out += [(int(a), int(b), l) for a, b in zip(i[near], j[near])]
    return out


def _clear_thresholds(pts: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """Each candidate squared threshold moved to the middle of the widest gap
    between pair d2 values within 10% of it, so no pair sits near it."""
    p = np.asarray(pts, np.float64)
    i, j = np.triu_indices(len(p), k=1)
    d2 = np.sort(((p[i] - p[j]) ** 2).sum(axis=1))
    out = []
    for t in np.asarray(cands, np.float64):
        w = d2[(d2 >= 0.9 * t) & (d2 <= 1.1 * t)]
        k = int(np.argmax(np.diff(w)))
        out.append(0.5 * (w[k] + w[k + 1]))
    return np.asarray(out, np.float32)


def _fixture(n: int, dim: int, n_cls: int, seed: int, n_thr: int = 6):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (n, dim)).astype(np.float32)
    labs = rng.integers(0, n_cls, n).astype(np.int32)
    thr = _clear_thresholds(pts, rng.uniform(5.0, 45.0, n_thr) ** 2)  # unsorted on purpose
    return pts, labs, thr


@pytest.mark.parametrize("n,dim,n_cls,seed", [(150, 2, 4, 0), (600, 2, 16, 1), (400, 3, 5, 2), (200, 5, 3, 3),
                                              (300, 2, 128, 4)])
def test_dense_pairs_match_jax_interpret(n, dim, n_cls, seed):
    pts, labs, thr = _fixture(n, dim, n_cls, seed)
    assert not _knife_edges(pts, thr)
    got = tdp.dense_pair_counts(pts, labs, thr, n_cls)
    want = cooccur_counts_pallas(pts, labs, thr, n_cls)
    assert got.shape == want.shape == (n_cls, n_cls, len(thr)) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_differences_are_knife_edge_pairs():
    """Thresholds set to pairs' exact d2 (rounded to float32): those pairs sit
    on the knife edge. Every count that differs from JAX's is explained by
    knife-edge pairs of that class pair and threshold, and nothing else
    differs."""
    pts, labs, _ = _fixture(400, 2, 4, seed=5)
    p = pts.astype(np.float64)
    i, j = np.triu_indices(len(p), k=1)
    d2 = ((p[i] - p[j]) ** 2).sum(axis=1)
    pick = np.random.default_rng(6).choice(np.flatnonzero((d2 > 100) & (d2 < 1500)), 6, replace=False)
    thr = np.sort(d2[pick]).astype(np.float32)
    edges = _knife_edges(pts, thr)
    assert len(edges) >= 6
    got = tdp.dense_pair_counts(pts, labs, thr, 4)
    want = cooccur_counts_pallas(pts, labs, thr, 4)
    allowed = np.zeros_like(got)
    for a, b, l in edges:
        # a knife-edge pair at threshold l may flip the cumulative counts of
        # l (and of later thresholds only if it is a knife edge there too)
        allowed[labs[a], labs[b], l] += 1
        allowed[labs[b], labs[a], l] += 1
    assert np.all(np.abs(got - want) <= allowed)


def test_dense_pairs_plain_equals_difference_form_away_from_edges():
    """Away from knife edges the expanded form counts what the dense
    difference-form sweep counts."""
    from squidpy_torch.ops.cooccur import co_occurrence_counts

    pts, labs, thr = _fixture(500, 2, 6, seed=7, n_thr=10)
    assert not _knife_edges(pts, thr)
    got = tdp.dense_pair_counts(pts, labs, thr, 6)
    order = np.argsort(thr)
    want = np.empty_like(got)
    want[:, :, order] = co_occurrence_counts(pts, labs, thr[order], 6)
    np.testing.assert_array_equal(got, want)


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


def test_co_occurrence_use_pallas_matches_jax():
    adata = _adata(500, 5, seed=8)
    pts = np.asarray(adata.obsm["spatial"], np.float32)
    radii = np.sqrt(_clear_thresholds(pts, np.array([20.0, 45.0, 80.0, 120.0, 160.0]) ** 2).astype(np.float64))
    interval = np.concatenate([[0.0], radii])
    occ_j, int_j = sq.gr.co_occurrence(adata, "cl", interval=interval, copy=True, use_pallas=True)
    assert not _knife_edges(pts, (int_j[1:].astype(np.float64) ** 2).astype(np.float32))
    occ_t, int_t = sqt.gr.co_occurrence(adata, "cl", interval=interval, copy=True, use_pallas=True)
    np.testing.assert_array_equal(int_t, int_j)
    np.testing.assert_array_equal(occ_t, occ_j)
    assert occ_t.shape == (5, 5, 5) and np.isfinite(occ_t).all()
    sqt.gr.co_occurrence(adata, "cl", interval=interval, use_pallas=True)
    np.testing.assert_array_equal(adata.uns["cl_co_occurrence"]["occ"], occ_j)


def test_dense_pairs_argument_errors():
    adata = _adata(300, 129, seed=9)
    with pytest.raises(ValueError, match="at most 128 clusters"):
        sqt.gr.co_occurrence(adata, "cl", use_pallas=True)
    with pytest.raises(ValueError, match="1 to 128 classes"):
        tdp.dense_pairs(torch.zeros((3, 2)), torch.zeros(3, dtype=torch.int32), torch.ones(1), 0)
    with pytest.raises(ValueError, match="do not fit"):
        tdp._k2_layout(400, 4, 4)


@pytest.mark.parametrize("dim,n_thr,n_cls,shared", [(2, 49, 16, True), (2, 49, 128, False), (3, 8, 4, True),
                                                     (128, 4, 2, True)])
def test_k2_layout(dim, n_thr, n_cls, shared):
    tile, got = tdp._k2_layout(dim, n_thr, n_cls)
    assert got == shared and tile in (64, 256)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    for n, dim, n_cls in ((3000, 2, 16), (2000, 3, 128), (700, 7, 3)):
        pts, labs, thr = _fixture(n, dim, n_cls, seed=n)
        thr_t = torch.from_numpy(np.sort(thr))
        args = (torch.from_numpy(pts), torch.from_numpy(labs))
        got = tdp.dense_pairs(*(a.cuda() for a in args), thr_t.cuda(), n_cls)
        assert torch.equal(got.cpu(), tdp._dense_plain(*args, thr_t, n_cls))


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
