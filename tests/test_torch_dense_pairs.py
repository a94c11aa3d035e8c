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


def test_nan_cells_at_128_categories():
    """NaN cells (``cat.codes`` = -1) of a 128-category column: squidpy_tpu's
    Pallas K2 counts them as category 127 (its one-hot sets lane -1, which is
    lane 127, and the ``[:128]`` slice keeps it); the port counts them
    nowhere, as squidpy_tpu's default path does. Both results are pinned."""
    n, n_cls = 300, 128
    rng = np.random.default_rng(11)
    codes = rng.integers(0, n_cls - 1, n)  # category 127 holds only what the NaN cells add
    nan = rng.choice(n, 30, replace=False)
    pts = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    radii = np.sqrt(_clear_thresholds(pts.astype(np.float32), np.array([30.0, 60.0, 90.0]) ** 2).astype(np.float64))
    interval = np.concatenate([[0.0], radii])

    def adata(c: np.ndarray) -> sq.AnnData:
        a = sq.AnnData(X=np.zeros((n, 1)), var=pd.DataFrame(index=["g"]),
                       obs=pd.DataFrame({"cl": pd.Categorical.from_codes(c, [f"c{i}" for i in range(n_cls)])},
                                        index=[str(i) for i in range(n)]))
        a.obsm["spatial"] = pts
        return a

    with_nan, as_127 = codes.copy(), codes.copy()
    with_nan[nan], as_127[nan] = -1, n_cls - 1
    occ_jax, int_jax = sq.gr.co_occurrence(adata(with_nan), "cl", interval=interval, copy=True, use_pallas=True)
    assert not _knife_edges(pts.astype(np.float32), (int_jax[1:].astype(np.float64) ** 2).astype(np.float32))
    occ_port, _ = sqt.gr.co_occurrence(adata(with_nan), "cl", interval=interval, copy=True, use_pallas=True)
    # squidpy_tpu's K2: the NaN cells are category 127
    occ_127, _ = sqt.gr.co_occurrence(adata(as_127), "cl", interval=interval, copy=True, use_pallas=True)
    np.testing.assert_array_equal(occ_jax, occ_127)
    # the port: the NaN cells count nowhere, as in squidpy_tpu's default path
    occ_default, _ = sq.gr.co_occurrence(adata(with_nan), "cl", interval=interval, copy=True)
    np.testing.assert_array_equal(occ_port, occ_default)
    assert not np.array_equal(occ_port, occ_jax, equal_nan=True)


def test_dense_pairs_argument_errors():
    adata = _adata(300, 129, seed=9)
    with pytest.raises(ValueError, match="at most 128 clusters"):
        sqt.gr.co_occurrence(adata, "cl", use_pallas=True)
    with pytest.raises(ValueError, match="1 to 128 classes"):
        tdp.dense_pairs(torch.zeros((3, 2)), torch.zeros(3, dtype=torch.int32), torch.ones(1), 0)
    with pytest.raises(ValueError, match="do not fit"):
        tdp._k2_layout(1000, 400, 4, 4)


@pytest.mark.parametrize("dim,n_thr,n_cls,shared", [(2, 49, 16, True), (2, 49, 128, False), (3, 8, 4, True),
                                                     (128, 4, 2, True), (2, 49, 31, True)])
def test_k2_layout(dim, n_thr, n_cls, shared):
    lay = tdp._k2_layout(200_000, dim, n_thr, n_cls)
    assert lay.shared == shared
    assert lay.tile == lay.threads * lay.reg and lay.reg in (1, 2)
    assert lay.tile in ((512, 1024) if dim in (2, 3) else (64, 256))
    assert lay.blocks % tdp.H100_SMS == 0 and lay.n_buckets % 2 == 0
    n_tiles = -(-200_000 // lay.tile)
    assert lay.tile_pairs == n_tiles * (n_tiles + 1) // 2
    # with the most column points a thread can keep, every block still gets
    # _K2_PAIRS_PER_BLOCK tile pairs, unless the tile is already the smallest
    assert lay.tile_pairs >= tdp._K2_PAIRS_PER_BLOCK * lay.blocks or lay.reg == 1


@pytest.mark.parametrize("n_cls", [16, 30, 31, 32])
def test_k2_layout_prefers_a_shared_histogram(n_cls):
    """At 200k 2D points the tile pairs alone would pick R = 2 (tile 1024).
    Where the (L, C, C) histogram fits in shared memory only beside the
    smaller tile (C = 31 at L = 49), R = 1 keeps it there rather than sending
    every pair to global atomics; where it fits beside neither, R = 2."""
    hist = 49 * (n_cls * n_cls + 1) * 4
    fits = {tile: (tile * 4 + 49) * 4 + tdp.K2_BUCKETS * 2 + hist <= tdp._K2_SMEM_BYTES for tile in (512, 1024)}
    lay = tdp._k2_layout(200_000, 2, 49, n_cls)
    assert lay.shared == fits[512]
    assert lay.reg == (1 if fits[512] and not fits[1024] else 2)
    assert (n_cls == 31) == (lay.reg == 1)


@pytest.mark.parametrize("n", [2, 30_000, 200_000, 1_000_000, 2**31 - 1])
def test_k2_flush_bound(n):
    """A tile pair adds at most tile^2 to one bin of a block's uint32
    histogram: between two flushes no bin may pass 2^31 - 1."""
    lay = tdp._k2_layout(n, 2, 49, 16)
    assert lay.flush_every >= 1
    assert lay.flush_every * lay.tile**2 <= 2**31 - 1 < (lay.flush_every + 1) * lay.tile**2
    # the kernel's int64 tile-pair index and int point index hold at this n
    assert lay.tile_pairs < 2**63 and -(-n // lay.tile) < 2**31
    if n == 1_000_000:
        assert (lay.tile, lay.flush_every, lay.tile_pairs) == (1024, 2047, 477_753)
        assert lay.tile_pairs < lay.flush_every * lay.blocks  # most blocks never flush before the end


def _decode(p: int) -> tuple[int, int]:
    """The kernel's linear tile-pair index -> (ti, tj), ti <= tj, tj-major."""
    t = int((np.sqrt(8.0 * float(p) + 1.0) - 1.0) * 0.5)
    while t * (t + 1) // 2 > p:
        t -= 1
    while (t + 1) * (t + 2) // 2 <= p:
        t += 1
    return p - t * (t + 1) // 2, t


@pytest.mark.parametrize("n", [5_000, 200_000, 2**31 - 1])
def test_k2_tile_pair_decode(n):
    lay = tdp._k2_layout(n, 2, 49, 16)
    n_tiles = -(-n // lay.tile)
    if n_tiles <= 200:
        got = [_decode(p) for p in range(lay.tile_pairs)]
        assert got == [(i, j) for j in range(n_tiles) for i in range(j + 1)]
    rng = np.random.default_rng(n % 1000)
    for p in [*rng.integers(0, lay.tile_pairs, 2000).tolist(), lay.tile_pairs - 1, 0, 1]:
        ti, tj = _decode(p)
        assert 0 <= ti <= tj < n_tiles and tj * (tj + 1) // 2 + ti == p


def _lookup(d2: np.ndarray, scale: np.float32, table: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """Numpy emulation of K2's first-threshold lookup: pairs with
    ``!(d2 <= thr[-1])`` get ``L`` (not counted), the rest their bucket's
    table entry, then a forward walk while ``thr[k] < d2``."""
    d2 = np.asarray(d2, np.float32)
    nb = table.shape[0]
    keep = d2 <= thr[-1]
    with np.errstate(invalid="ignore", over="ignore"):
        v = np.where(keep, d2 * scale, np.float32(0)).astype(np.float32)
    v = np.where(np.isnan(v), np.float32(0), v)  # -inf * 0: the card converts NaN to int 0
    b = np.clip(np.trunc(v), 0, nb - 1).astype(np.int64)
    k = table[b].astype(np.int64)
    for _ in range(len(thr)):
        step = keep & (thr[np.minimum(k, len(thr) - 1)] < d2)
        if not step.any():
            break
        k += step
    return np.where(keep, k, len(thr))


def _edge_d2(thr: np.ndarray, scale: np.float32, n_buckets: int, rng) -> np.ndarray:
    """d2 values on every edge the lookup can get wrong: each threshold and
    its float32 neighbours, each bucket's boundary +- a few ulps, 0, -0,
    small negatives, above the largest threshold, inf and NaN, and random
    values over the thresholds' range."""
    f32 = np.float32
    cand = [thr, np.nextafter(thr, f32(-np.inf)), np.nextafter(thr, f32(np.inf))]
    if scale > 0:
        bound = (np.arange(1, n_buckets, dtype=np.float64) / float(scale)).astype(f32)
        for ulp in range(-3, 4):
            x = bound
            for _ in range(abs(ulp)):
                x = np.nextafter(x, f32(np.inf) if ulp > 0 else f32(-np.inf))
            cand.append(x)
    hi = float(np.abs(thr).max()) or 1.0
    with np.errstate(over="ignore"):  # near the float32 maximum these round to inf, also an edge
        cand += [np.array([0.0, -0.0, -1e-3, -1e-30, -hi, np.inf, -np.inf, np.nan, 2 * hi + 1], f32),
                 rng.uniform(-0.1 * hi, 1.2 * hi, 20_000).astype(f32)]
    return np.concatenate(cand).astype(f32)


_THRESHOLDS = {
    "main path radii": (np.linspace(3.0, 250.0, 50)[1:] ** 2).astype(np.float32),
    "equal": np.array([0, 0, 1, 1, 1, 4, 9, 9, 9, 30], np.float32),
    "zero first": np.array([0, 2.5, 7, 7.5, 100], np.float32),
    "all zero": np.zeros(4, np.float32),
    "negative": np.array([-5, -1, -1, 0, 2], np.float32),
    "all negative": np.array([-3, -1], np.float32),
    "below every pair": np.array([-1e30], np.float32),
    "one": np.array([42.0], np.float32),
    "denormal max": np.array([0, 1e-41], np.float32),
    "wide range": np.array([1e-6, 1e-3, 1, 1e3, 1e6, 1e9, 1e12], np.float32),
    "near the float32 maximum": np.array([1, 1e30, 3e38], np.float32),
}


@pytest.mark.parametrize("n_buckets", [2, 16, tdp.K2_BUCKETS])
@pytest.mark.parametrize("name", sorted(_THRESHOLDS))
def test_k2_table_lookup_equals_searchsorted(name, n_buckets):
    thr = _THRESHOLDS[name]
    scale, table = tdp._k2_table(thr, n_buckets)
    assert table.shape == (n_buckets,) and scale.dtype == np.float32
    assert np.all(np.diff(table) >= 0) and table[0] == 0 and table.max() < len(thr)
    d2 = _edge_d2(thr, scale, n_buckets, np.random.default_rng(len(thr)))
    want = torch.searchsorted(torch.from_numpy(thr), torch.from_numpy(d2)).numpy()
    np.testing.assert_array_equal(_lookup(d2, scale, table, thr), want)


@pytest.mark.parametrize("seed", range(6))
def test_k2_table_lookup_random(seed):
    rng = np.random.default_rng(seed)
    n_thr = int(rng.integers(1, 200))
    thr = np.sort(rng.choice([rng.uniform(0, 1e4, n_thr), rng.exponential(50.0, n_thr) - 5,
                              np.round(rng.uniform(0, 20, n_thr))])).astype(np.float32)
    n_buckets = int(rng.choice([4, 64, tdp.K2_BUCKETS]))
    scale, table = tdp._k2_table(thr, n_buckets)
    d2 = _edge_d2(thr, scale, n_buckets, rng)
    want = torch.searchsorted(torch.from_numpy(thr), torch.from_numpy(d2)).numpy()
    np.testing.assert_array_equal(_lookup(d2, scale, table, thr), want)


@pytest.mark.parametrize("n_buckets", [16, tdp.K2_BUCKETS])
def test_k2_table_entries_are_least_bucket_bounds(n_buckets):
    """Each entry is searchsorted at the least float32 x of its bucket: one
    ulp below that x falls in the bucket before."""
    thr = _THRESHOLDS["main path radii"]
    scale, table = tdp._k2_table(thr, n_buckets)
    for b in range(1, n_buckets):
        x = np.float32(b / np.float64(scale))
        while np.float32(x * scale) >= b:
            x = np.nextafter(x, np.float32(-np.inf))
        x = np.nextafter(x, np.float32(np.inf))  # the least x in bucket b
        assert table[b] == np.searchsorted(thr, x, side="left")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    cases = [_fixture(n, dim, n_cls, seed=n) + (n_cls,) for n, dim, n_cls in ((3000, 2, 16), (2000, 3, 128), (700, 7, 3))]
    rng = np.random.default_rng(11)
    # n not a multiple of any tile; coincident points (d2 <= 0 by rounding);
    # equal and zero thresholds; one threshold below every pair; the first
    # shape also at a size that takes two column points a thread (R = 2)
    big = rng.uniform(0, 3000, (100_001, 2)).astype(np.float32)
    big[1::7] = big[::7][: len(big[1::7])]
    big_labs = rng.integers(-1, 17, len(big)).astype(np.int32)  # -1 and 16 are not counted
    pts, labs = big[:5001], big_labs[:5001]
    edge_thr = np.array([0, 0, 4, 4, 100, 900, 900, 2500], np.float32)
    cases += [(pts, labs, edge_thr, 16),
              (pts, labs, np.array([-1e30], np.float32), 16),
              (pts[:2049, :], labs[:2049], np.array([0, 10, 1e9], np.float32), 16),
              (np.repeat(pts[:50], 3, axis=0).astype(np.float32), labs[:150], np.zeros(3, np.float32), 16),
              (big, big_labs, edge_thr, 16)]
    for pts, labs, thr, n_cls in cases:
        # the plain version runs on the card too: it rounds each op on its own there as well
        thr_t = torch.from_numpy(np.sort(thr)).cuda()
        args = (torch.from_numpy(np.ascontiguousarray(pts)).cuda(), torch.from_numpy(labs).cuda())
        stats: dict = {}
        got = tdp.dense_pairs(*args, thr_t, n_cls, stats=stats)
        assert torch.equal(got, tdp._dense_plain(*args, thr_t, n_cls))
        assert stats["reg"] == (2 if len(pts) == len(big) else 1)


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
