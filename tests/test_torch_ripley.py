"""The port's Ripley statistics (K7 pair counts, K8 nearest neighbours, the
point-process sampler, ``gr.ripley``) against squidpy_tpu's.

Tolerances:

- point-process samples, clouds, bins, and every integer count are bitwise
  equal;
- both packages count pairs by float32 difference-form ``d2 <= thr`` with
  the same thresholds, but XLA on the CPU fuses JAX's 2D sum into
  ``fma(d0, d0, d1 * d1)``, where the port (plain torch, K7) rounds each
  operation. So a pair whose two roundings of ``d2`` lie on either side of a
  threshold (a knife edge) is counted by one package only: each package's
  counts equal a numpy emulation of its own rounding, the bitwise fixtures
  are checked to hold no knife edge, and one test builds a knife-edge pair
  and shows it is the only difference;
- nearest neighbours: the port ranks by difference-form ``d2`` (ties to the
  lowest index) and its distances are the correctly rounded roots of its own
  ``d2``, bitwise against a numpy emulation; JAX ranks by the expanded form
  and recomputes the winners' distances with a fused ``d2``. So indices are
  equal on fixtures with no near-tie (two candidates whose ``d2`` lie within
  the expanded form's error, ``4 eps (|q|^2 + max |p|^2)``), and distances
  agree to 2 float32 ulps (the fused against the unfused ``d2``);
- ECDFs, L curves and p-values are bitwise equal on fixtures where no
  distance lies within those bounds of a support edge.

The kernels themselves are held to their plain versions on the card (tests
marked ``cuda``, skipped without one).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import ConvexHull

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.gr import _ripley as tgr
from squidpy_torch.ops import knn as tknn
from squidpy_torch.ops import ripley as trip
from squidpy_tpu.gr import _ripley as jgr
from squidpy_tpu.ops import knn as jknn
from squidpy_tpu.ops import ripley as jrip

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _d2_port(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The port's float32 d2 (m, n): each subtraction, multiply and add rounded."""
    diff = a[:, None, 0] - b[None, :, 0]
    d2 = diff * diff
    for k in range(1, a.shape[1]):
        diff = a[:, None, k] - b[None, :, k]
        d2 = d2 + diff * diff
    return d2


def _d2_jax(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """XLA:CPU's float32 2D d2 of the dense pair sweep: ``fma(d0, d0, d1 * d1)``,
    emulated in float64 (the product is exact there)."""
    d0 = a[:, None, 0] - b[None, :, 0]
    d1 = a[:, None, 1] - b[None, :, 1]
    return (d0.astype(np.float64) ** 2 + (d1 * d1).astype(np.float64)).astype(np.float32)


def _thresholds(support: np.ndarray) -> np.ndarray:
    return (np.asarray(support, dtype=np.float64) ** 2).astype(np.float32)


def _upper(d2: np.ndarray) -> np.ndarray:
    return d2[np.triu_indices(d2.shape[0], 1)]


def _cumulative(d2: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """Ordered pair counts with ``d2 <= thr[l]``, float64 (L,)."""
    d2 = np.sort(d2)
    return 2.0 * np.searchsorted(d2, thr, side="right").astype(np.float64)


def _knife_edges(p: np.ndarray, thr: np.ndarray) -> int:
    """Pairs i < j whose two roundings of d2 fall on either side of a threshold."""
    p = p.astype(np.float32)
    ts = np.sort(thr)
    a = np.searchsorted(ts, _upper(_d2_port(p, p)), side="left")
    b = np.searchsorted(ts, _upper(_d2_jax(p, p)), side="left")
    return int((a != b).sum())


def _points(n: int, seed: int, side: float = 100.0, dim: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.0, side, (n, dim))


# ------------------------------------------------------------------ sampling


@pytest.mark.parametrize("n_sims", [1, 4])
def test_ppp_sample_bitwise(n_sims):
    hull = ConvexHull(_points(300, 0))
    got = trip.ppp_sample(hull, n_sims, 150, rng=np.random.default_rng(5))
    want = jrip.ppp_sample(hull, n_sims, 150, rng=np.random.default_rng(5))
    assert got.shape == want.shape == ((150, 2) if n_sims == 1 else (n_sims, 150, 2))
    np.testing.assert_array_equal(got, want)


def test_envelope_clouds_bitwise():
    """The envelope's clouds, one spawned stream each, as ``ripley`` draws them."""
    hull = ConvexHull(_points(300, 1))

    def clouds(mod):
        _, *rngs = (np.random.default_rng(s) for s in np.random.SeedSequence(7).spawn(11))
        return np.stack([mod.ppp_sample(hull, 1, 80, rng=r) for r in rngs])

    np.testing.assert_array_equal(clouds(trip), clouds(jrip))


# ------------------------------------------------------------------ pair counts (K7, K1 with one class)


@pytest.mark.parametrize(("n", "seed", "method"), [(700, 3, "dense"), (700, 3, "binned"), (700, 3, "auto"),
                                                   (1500, 4, "dense"), (257, 5, "auto")])
def test_pair_counts_cumulative_match_jax(n, seed, method):
    pts = _points(n, seed)
    support = np.linspace(0.0, 70.0, 50)
    assert _knife_edges(pts, _thresholds(support)) == 0  # the fixture holds no knife edge
    got = trip.pair_counts_cumulative(pts, support, method=method)
    want = jrip.pair_counts_cumulative(pts, support)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [1, 2, 3, 5])
def test_pair_counts_equal_their_rounding(dim):
    """The plain version of K7 against a numpy emulation of its rounding, in
    1-5 dimensions (the kernel's templated and runtime-``dim`` paths); JAX's
    2D counts against an emulation of its fused rounding."""
    pts = _points(600, 10 + dim, dim=dim).astype(np.float32)
    support = np.linspace(0.0, 60.0, 37)
    thr = _thresholds(support)
    np.testing.assert_array_equal(trip.pair_counts_cumulative(pts, support),
                                  _cumulative(_upper(_d2_port(pts, pts)), thr))
    if dim == 2:
        np.testing.assert_array_equal(jrip.pair_counts_cumulative(pts, support),
                                      _cumulative(_upper(_d2_jax(pts, pts)), thr))


def test_knife_edge_pair_is_the_only_difference():
    """A pair whose fused and unfused d2 straddle a threshold: the port
    counts it by its own d2, JAX by its own, and nothing else differs."""
    pts = _points(400, 21).astype(np.float32)
    un, fu = _upper(_d2_port(pts, pts)), _upper(_d2_jax(pts, pts))
    edge = np.flatnonzero(un != fu)[0]
    lo, hi = sorted((float(un[edge]), float(fu[edge])))
    support = np.sqrt(np.linspace(0.0, 900.0, 20))
    assert _knife_edges(pts, _thresholds(support)) == 0
    s = np.sqrt(lo)  # a support whose float32 square is lo: lo counts, hi does not
    while np.float32(s * s) > lo:
        s = np.nextafter(s, 0.0)
    while np.float32(s * s) < lo:
        s = np.nextafter(s, np.inf)
    assert np.float32(s * s) == np.float32(lo) < np.float32(hi)
    support = np.sort(np.append(support, s))
    got = trip.pair_counts_cumulative(pts, support)
    want = jrip.pair_counts_cumulative(pts, support)
    r = int(np.searchsorted(support, s))
    diff = got - want
    expected = np.zeros_like(diff)
    expected[r] = 2.0 if un[edge] == np.float32(lo) else -2.0
    same = (un <= np.float32(lo)) == (fu <= np.float32(lo))
    assert int((~same).sum()) == 1  # the pair is the fixture's one knife edge at this threshold
    np.testing.assert_array_equal(diff, expected)


def test_ripley_pairs_any_threshold_order():
    pts = torch.from_numpy(_points(300, 6).astype(np.float32))
    thr = torch.from_numpy(_thresholds(np.linspace(0.0, 50.0, 20)))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(20))
    want = trip.ripley_pairs(pts, thr)
    np.testing.assert_array_equal(trip.ripley_pairs(pts, thr[perm]).numpy(), want[:, perm].numpy())
    assert trip.ripley_pairs(pts[:1], thr).sum() == 0  # one point: no pairs


def test_batched_pair_counts_match_jax():
    clouds = np.random.default_rng(8).uniform(0.0, 100.0, (6, 300, 2))
    support = np.linspace(0.0, 70.0, 25)
    for c in clouds:
        assert _knife_edges(c, _thresholds(support)) == 0
    got = trip.batched_pair_counts(clouds, support)
    want = jrip.batched_pair_counts(clouds, support)
    assert got.shape == (6, 25) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(("dim", "n_thr", "want"), [
    (2, 50, trip.K7Layout("slots", trip._K7_SLOT_COPIES, 1024, True)),
    (5, 50, trip.K7Layout("slots", trip._K7_SLOT_COPIES, 1024, True)),  # a runtime dim stages no rows
    (2, 8000, trip.K7Layout("shared", 1, 32768, True)),
    (2, 30000, trip.K7Layout("shared", 1, 131072, False)),
    (2, 60000, trip.K7Layout("global", 0, 262144, False)),
])
def test_k7_layout(dim, n_thr, want):
    """Slot counters beside the splits and the thresholds while L <= 256
    (1024 buckets), then L-bin copies (a warp's, then one), then none (global
    atomics), with the thresholds staged while they still fit; always a
    power of two of at least 4L buckets."""
    got = trip._k7_layout(dim, n_thr)
    assert got == want
    assert got.n_buckets >= 4 * n_thr and got.n_buckets & (got.n_buckets - 1) == 0
    rows = trip._K7_ROW_TILE_MAX * dim * 4 if dim <= 3 else 0
    thr = (n_thr + n_thr % 2) * got.thr_shared
    if got.hist == "slots":
        words = got.copies * (2 * (got.n_buckets + 1) + n_thr) + got.n_buckets + 2 + 2 * n_thr
    else:
        words = got.copies * n_thr
    assert rows + 4 * (words + thr) <= trip._K7_SMEM_BYTES


def _table_numpy(thr: np.ndarray, n_buckets: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.float32]:
    """Each bucket's split and slot bins by a numpy search: its least d2
    found by ``nextafter`` steps from ``b / scale`` until the float32
    product with the scale crosses b, its largest one step below the next
    bucket's least (the top bucket: every larger float); the thresholds in
    ``[least, largest)`` up to ``thr[-1]`` decide the rest."""
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.float32(n_buckets) / thr[-1]
    scale = scale if scale > 0 and np.isfinite(scale) else np.float32(0)
    b = np.arange(n_buckets + 1, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.where(b > 0, (b / scale).astype(np.float32) if scale > 0 else np.float32(np.inf), np.float32(0))
    x = x.astype(np.float32)
    while True:  # down while the step below is still in the bucket or above
        prev = np.nextafter(x, np.float32(-np.inf))
        down = (b > 0) & (prev >= 0) & (prev * scale >= b)
        if not down.any():
            break
        x = np.where(down, prev, x)
    while True:  # up while below the bucket
        up = (b > 0) & (x * scale < b) & np.isfinite(x)
        if not up.any():
            break
        x = np.where(up, np.nextafter(x, np.float32(np.inf)), x)
    end = np.append(np.nextafter(x[1:], np.float32(-np.inf)), np.float32(np.inf))
    hi = np.minimum(end, thr[-1])
    empty = x > hi
    first, last = np.searchsorted(thr, x, "left"), np.searchsorted(thr, hi, "left")
    inside = np.where(empty, 0, last - first)  # thresholds in [least, largest) of the bucket
    f = np.minimum(first, len(thr) - 1)
    one_value = thr[f] == thr[np.maximum(last - 1, 0)]
    walk = empty | ((inside >= 1) & (~one_value | (end > thr[-1])))
    split = np.where(walk, np.float32(np.nan), np.where(inside == 0, hi, thr[f])).astype(np.float32)
    return split, np.where(empty, 0, f), np.where((inside >= 1) & ~walk, last, -1), scale


@pytest.mark.parametrize("n_thr", [50, 8000, 60000])
@pytest.mark.parametrize("kind", ["linear", "random", "tiny"])
def test_k7_table(n_thr, kind):
    """K7's bucket table against a numpy search at each bucket's
    boundaries: every bucket's split and two slot bins, and the scale;
    Ripley's linear support, random thresholds with ties, and thresholds
    near the bottom of float32's normal range."""
    rng = np.random.default_rng(n_thr)
    support = {"linear": np.linspace(0.0, 80.0, n_thr), "random": rng.uniform(0, 3e4, n_thr).round(-1),
               "tiny": np.linspace(0.0, 1e-15, n_thr)}[kind]
    thr = np.sort(_thresholds(support))
    n_buckets = trip._k7_layout(2, n_thr).n_buckets
    table = trip._k7_table(torch.from_numpy(thr), n_buckets).numpy()
    split, k0, k1, scale = _table_numpy(thr, n_buckets)
    assert table.shape == (3 * (n_buckets + 1) + 1,) and table[-1] == scale.view(np.int32)
    np.testing.assert_array_equal(table[: n_buckets + 1].view(np.float32), split)
    np.testing.assert_array_equal(table[n_buckets + 1 : -1 : 2], k0)
    np.testing.assert_array_equal(table[n_buckets + 2 : -1 : 2], k1)
    assert (~np.isnan(split)).mean() > 0.99  # nearly every bucket is decided by its split


@pytest.mark.parametrize("n_thr", [1, 7, 37, 7000])
def test_k7_table_gives_each_pairs_first_threshold(n_thr):
    """Every d2 of a point set, beyond the last threshold, on and beside
    each threshold, NaN and inf: the kernel's rule on the table (the
    bucket by the float32 product's floor; its slot by the split, or the
    walk from the first bin where the split is NaN) is
    ``searchsorted(thr, d2)``, and no bin past the last threshold."""
    pts = _points(500, 17).astype(np.float32)
    thr = np.sort(_thresholds(np.linspace(0.0, 60.0, n_thr) if n_thr > 1 else np.r_[30.0]))
    if n_thr == 7:
        thr = np.sort(np.r_[thr, thr[3], thr[3]])  # repeated thresholds
    n_buckets = trip._k7_layout(2, len(thr)).n_buckets
    table = trip._k7_table(torch.from_numpy(thr), n_buckets).numpy()
    split, slot_bin, scale = table[: n_buckets + 1].view(np.float32), table[n_buckets + 1 : -1], table[-1:].view(np.float32)[0]
    d2 = np.concatenate([_upper(_d2_port(pts, pts)), thr, np.nextafter(thr, np.float32(np.inf)),
                         np.nextafter(thr, np.float32(0)), np.float32([np.nan, np.inf, 0.0])]).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        y = d2 * scale
    bucket = np.where(np.isfinite(y) & (y < n_buckets), np.floor(np.nan_to_num(y)), n_buckets).astype(np.int64)
    sp = split[bucket]
    with np.errstate(invalid="ignore"):
        k = slot_bin[2 * bucket + ~(d2 <= sp)].astype(np.int64)
    for i in np.flatnonzero(np.isnan(sp)):
        k[i] = -1
        if d2[i] <= thr[-1]:
            k[i] = slot_bin[2 * bucket[i]]
            while thr[k[i]] < d2[i]:
                k[i] += 1
    with np.errstate(invalid="ignore"):
        want = np.where(d2 <= thr[-1], np.searchsorted(thr, d2, "left"), -1)
    np.testing.assert_array_equal(k, want)


@pytest.mark.parametrize(("n_sets", "n", "want"), [
    (1, 52_735, 256), (100, 1000, 128), (1, 200_276, 256), (1, 1025, 32), (7, 5000, 128),
])
def test_k7_row_tile(n_sets, n, want):
    """The largest row tile up to 256 that leaves every launch
    ``_K7_MIN_ITEMS`` work items, 32 at least, dividing the column tile."""
    row_tile = trip._k7_row_tile(n_sets, n)
    assert row_tile == want and trip._K7_COLS % row_tile == 0
    col_tiles = -(-n // trip._K7_COLS)
    items = n_sets * trip._K7_COLS // row_tile * col_tiles * (col_tiles + 1) // 2
    assert items >= trip._K7_MIN_ITEMS or row_tile == 32


@pytest.mark.parametrize(("n", "max_support", "extent", "device", "want"), [
    (99_999, 7071.0, 10_000.0, "cpu", "dense"),  # the CPU keeps the JAX package's 100k cut
    (100_000, 7071.0, 10_000.0, "cpu", "binned"),
    (100_000, 50.0, 10_000.0, "cpu", "binned"),
    (100_000, 7071.0, 10_000.0, "cuda", "dense"),  # the card: dense where it was measured faster
    (200_000, 50.0, 10_000.0, "cuda", "dense"),
    (1_000_000, 7071.0, 10_000.0, "cuda", "dense"),
    (1_000_000, 50.0, 10_000.0, "cuda", "dense"),
    (2_000_000, 7071.0, 10_000.0, "cuda", "dense"),  # past 1M: dense while the support reaches far
    (2_000_000, 50.0, 10_000.0, "cuda", "binned"),
])
def test_k7_route(n, max_support, extent, device, want):
    support = np.linspace(0.0, max_support, 50)
    assert trip._k7_route(n, support, extent, torch.device(device)) == want


def test_pair_counts_auto_takes_the_route():
    """``auto`` counts the same pairs by either route (CPU: the plain binned
    sweep from 100,000 points, dense below)."""
    pts = _points(2000, 44)
    support = np.linspace(0.0, 20.0, 30)
    extent = trip._extent(pts)
    assert 99.0 < extent <= 100.0
    assert trip._k7_route(len(pts), support, extent, torch.device("cpu")) == "dense"
    np.testing.assert_array_equal(trip.pair_counts_cumulative(pts, support),
                                  trip.pair_counts_cumulative(pts, support, method="binned"))


def test_batched_pair_counts_cloud_limit():
    clouds = np.zeros((1, 65_001, 2), np.float32)
    with pytest.raises(ValueError, match="65k"):
        trip.batched_pair_counts(clouds, np.linspace(0, 1, 3))
    with pytest.raises(ValueError, match="65k"):
        jrip.batched_pair_counts(clouds, np.linspace(0, 1, 3))


def test_pair_counts_method_must_be_known():
    with pytest.raises(ValueError, match="Unknown pair-count method"):
        trip.pair_counts_cumulative(_points(10, 0), np.linspace(0, 1, 3), method="tree")


# ------------------------------------------------------------------ nearest neighbours (K8)


def _knn_emulated(q: np.ndarray, data: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The port's selection in numpy: the k least (d2, index), unfused d2,
    correctly rounded roots."""
    d2 = _d2_port(q.astype(np.float32), data.astype(np.float32))
    cols = np.broadcast_to(np.arange(d2.shape[1]), d2.shape)
    order = np.lexsort((cols, d2), axis=-1)[:, :k]
    sel = np.take_along_axis(d2, order, axis=1)
    return np.sqrt(sel), order.astype(np.int32)


def _near_ties(q: np.ndarray, data: np.ndarray, k: int) -> int:
    """Queries whose k-th and (k+1)-th candidates (by the port's d2) lie
    within the expanded form's error of each other."""
    q, data = q.astype(np.float32), data.astype(np.float32)
    d2 = np.sort(_d2_port(q, data), axis=1).astype(np.float64)
    bound = 4 * EPS32 * ((q.astype(np.float64) ** 2).sum(1) + (data.astype(np.float64) ** 2).sum(1).max())
    gaps = np.diff(d2[:, : k + 1], axis=1) if d2.shape[1] > k else np.full((len(q), 1), np.inf)
    return int((gaps <= bound[:, None]).any(axis=1).sum())


@pytest.mark.parametrize(("k", "seed"), [(1, 31), (2, 32), (3, 33), (40, 9070)])
def test_cross_knn_match_jax(k, seed):
    """k = 40 is above K8's register list (32): its slower branch on the card.
    Centred coordinates keep the expanded form's error, and so the near
    ties, small."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-50.0, 50.0, (200, 2))
    data = rng.uniform(-50.0, 50.0, (500, 2))
    assert _near_ties(q, data, k) == 0
    d, i = tknn.cross_knn(q, data, k)
    dj, ij = jknn.cross_knn(q, data, k)
    assert d.dtype == np.float32 and i.dtype == np.int32 and d.shape == i.shape == (200, k)
    np.testing.assert_array_equal(i, ij)
    de, ie = _knn_emulated(q, data, k)
    np.testing.assert_array_equal(i, ie)
    np.testing.assert_array_equal(d, de)
    np.testing.assert_allclose(d, dj, rtol=2 * EPS32, atol=0)


def test_cross_knn_edge_cases():
    data = _points(5, 2)
    for mod in (tknn, jknn):
        d, i = mod.cross_knn(np.zeros((0, 2)), data, 3)
        assert d.shape == i.shape == (0, 3) and d.dtype == np.float32 and i.dtype == np.int32
    d, i = tknn.cross_knn(_points(4, 3), data, 9)  # k above the points there are: all of them
    dj, ij = jknn.cross_knn(_points(4, 3), data, 9)
    assert d.shape == (4, 5)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_allclose(d, dj, rtol=2 * EPS32, atol=0)


def test_nearest_points_ties_go_to_the_lowest_index():
    data = np.repeat(_points(50, 4).astype(np.float32), 3, axis=0)  # every point three times
    q = _points(40, 5).astype(np.float32)
    for k in (1, 2, 4, 40):
        dist, idx = tknn.nearest_points(torch.from_numpy(q), torch.from_numpy(data), k)
        de, ie = _knn_emulated(q, data, k)
        np.testing.assert_array_equal(idx[0].numpy(), ie)
        np.testing.assert_array_equal(dist[0].numpy(), de)
    assert (idx[0, :, 0] % 3 == 0).all()  # the first copy of the nearest point


def test_batched_nn_distances_match_jax():
    rng = np.random.default_rng(12)
    q = rng.uniform(0.0, 100.0, (250, 2))
    clouds = rng.uniform(0.0, 100.0, (5, 200, 2))
    for c in clouds:
        assert _near_ties(q, c, 1) == 0
    got = trip.batched_nn_distances(q, clouds)
    want = jrip.batched_nn_distances(q, clouds)
    assert got.shape == (5, 250) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.stack([_knn_emulated(q, c, 1)[0][:, 0] for c in clouds]))
    np.testing.assert_allclose(got, want, rtol=2 * EPS32, atol=0)


# ------------------------------------------------------------------ gr.ripley


def _adata(n: int, n_cls: int, seed: int, key: str = "cl") -> sq.AnnData:
    rng = np.random.default_rng(seed)
    adata = sq.AnnData(
        X=np.zeros((n, 1)),
        obs=pd.DataFrame({key: pd.Categorical.from_codes(rng.integers(0, n_cls, n), [f"c{i}" for i in range(n_cls)])},
                         index=[str(i) for i in range(n)]),
        var=pd.DataFrame(index=["g"]),
    )
    adata.obsm["spatial"] = rng.uniform(0, 10 * np.sqrt(n), (n, 2))
    return adata


def _edge_safe(q: np.ndarray, data: np.ndarray, k: int, support: np.ndarray) -> bool:
    """No k-nearest distance within 8 float32 ulps of a support edge, nor,
    for a query with a near tie (where JAX may pick another neighbour),
    within the expanded form's error of one."""
    q, data = q.astype(np.float32), data.astype(np.float32)
    d2 = np.sort(_d2_port(q, data), axis=1)[:, : k + 1].astype(np.float64)
    bound = 4 * EPS32 * ((q.astype(np.float64) ** 2).sum(1) + (data.astype(np.float64) ** 2).sum(1).max())
    near = (np.diff(d2, axis=1) <= bound[:, None]).any(axis=1) if d2.shape[1] > k else np.zeros(len(q), bool)
    d2 = d2[:, :k]
    band = 8 * EPS32 * d2 + np.where(near, bound, 0.0)[:, None]
    e2 = np.asarray(support, dtype=np.float64) ** 2
    pos = np.clip(np.searchsorted(e2, d2), 1, len(e2) - 1)
    gap = np.minimum(np.abs(d2 - e2[pos - 1]), np.abs(d2 - e2[pos]))
    return bool((gap > band).all())


def _assert_table(table: tgr.RipleyTable, df: pd.DataFrame, name: str) -> None:
    assert list(df.columns) == ["bins", name, "stats"] and table.name == name
    np.testing.assert_array_equal(table.bins, df["bins"].to_numpy())
    np.testing.assert_array_equal(table.values, df[name].to_numpy())
    np.testing.assert_array_equal(table.categories, np.asarray(df[name].cat.categories))
    np.testing.assert_array_equal(table.stats, df["stats"].to_numpy())


def _check_fixture(adata: sq.AnnData, mode: str, support: np.ndarray) -> None:
    """The observed curves hold no knife edge (see the module docstring)."""
    coords = adata.obsm["spatial"].astype(np.float32)
    codes = adata.obs["cl"].cat.codes.to_numpy()
    if mode == "L":
        for c in np.unique(codes):
            assert _knife_edges(coords[codes == c], _thresholds(support)) == 0
        return
    for c in np.unique(codes):
        if mode == "G":  # near ties may pick another neighbour: only its distance reaches the ECDF
            assert _edge_safe(coords[codes != c], coords[codes == c], 2, support)


@pytest.mark.parametrize("mode", ["F", "G", "L"])
def test_ripley_matches_jax(mode):
    adata = _adata(3000, 4, 40)
    kw = dict(cluster_key="cl", mode=mode, n_simulations=12, n_observations=150, n_steps=30, seed=3, copy=True)
    got = sqt.gr.ripley(adata, **kw)
    want = sq.gr.ripley(adata, **kw)
    _check_fixture(adata, mode, got["bins"])
    assert set(got) == set(want) == {f"{mode}_stat", "sims_stat", "bins", "pvalues"}
    np.testing.assert_array_equal(got["bins"], want["bins"])
    _assert_table(got[f"{mode}_stat"], want[f"{mode}_stat"], "cl")
    _assert_table(got["sims_stat"], want["sims_stat"], "simulations")
    np.testing.assert_array_equal(got["pvalues"], want["pvalues"])
    assert got["pvalues"].shape == (4, 30)


def test_ripley_writes_uns_and_is_seeded():
    adata = _adata(1200, 3, 41)
    kw = dict(mode="L", n_simulations=6, n_observations=100, n_steps=12)
    assert sqt.gr.ripley(adata, "cl", seed=9, **kw) is None
    first = adata.uns["cl_ripley_L"]
    again = sqt.gr.ripley(adata, "cl", seed=9, copy=True, **kw)
    other = sqt.gr.ripley(adata, "cl", seed=10, copy=True, **kw)
    np.testing.assert_array_equal(first["sims_stat"].stats, again["sims_stat"].stats)
    np.testing.assert_array_equal(first["L_stat"].stats, again["L_stat"].stats)
    assert not np.array_equal(first["sims_stat"].stats, other["sims_stat"].stats)
    sq.gr.ripley(adata, "cl", seed=9, **kw)  # the JAX package writes the same key
    np.testing.assert_array_equal(first["pvalues"], adata.uns["cl_ripley_L"]["pvalues"])


def test_ripley_single_present_category():
    """G with one present category queries an empty set: a NaN curve, as in JAX."""
    adata = _adata(300, 1, 42)
    adata.obs["one"] = pd.Categorical(["a"] * adata.n_obs, categories=["a", "zz"])
    kw = dict(mode="G", n_simulations=3, n_observations=40, n_steps=6, seed=0, copy=True)
    with np.errstate(invalid="ignore"):
        got = sqt.gr.ripley(adata, "one", **kw)
        want = sq.gr.ripley(adata, "one", **kw)
    _assert_table(got["G_stat"], want["G_stat"], "one")
    assert np.isnan(got["G_stat"].stats[1:]).all() and got["G_stat"].stats[0] == 0
    np.testing.assert_array_equal(got["pvalues"], want["pvalues"])


def test_ripley_nan_cells_mirror_jax():
    """Cells with a NaN cluster (code -1) form one more curve, labelled with
    the last category, in the JAX package; the port keeps that behaviour
    (ROADMAP queue 3)."""
    adata = _adata(400, 3, 44)
    codes = adata.obs["cl"].cat.codes.to_numpy().copy()
    codes[:40] = -1
    adata.obs["cl"] = pd.Categorical.from_codes(codes, ["c0", "c1", "c2"])
    kw = dict(mode="L", n_simulations=5, n_observations=50, n_steps=5, seed=0, copy=True)
    got = sqt.gr.ripley(adata, "cl", **kw)
    want = sq.gr.ripley(adata, "cl", **kw)
    assert got["pvalues"].shape == want["pvalues"].shape == (4, 5)
    assert list(got["L_stat"].values[::5]) == ["c2", "c0", "c1", "c2"]
    _assert_table(got["L_stat"], want["L_stat"], "cl")
    np.testing.assert_array_equal(got["pvalues"], want["pvalues"])


def test_ripley_rejects_other_metrics_and_modes():
    adata = _adata(100, 2, 43)
    with pytest.raises(ValueError, match="Unsupported metric"):
        sqt.gr.ripley(adata, "cl", metric="manhattan", copy=True)
    with pytest.raises(ValueError, match="Invalid option"):
        sqt.gr.ripley(adata, "cl", mode="K", copy=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ecdf_rows_match_jax(dtype):
    """The port's ``np.bincount`` of (row, bin) ids against the JAX
    package's ``np.add.at``: bitwise, values on edges, out of range, NaN and
    a row with nothing in range included."""
    rng = np.random.default_rng(0)
    support = np.linspace(0, 5.0, 11)
    d = rng.uniform(-0.5, 6.5, size=(7, 500)).astype(dtype)
    d[0, :4] = [0.0, 5.0, 2.5, np.nan]
    d[1, :] = support[rng.integers(0, 11, 500)]
    d[2, :] = 7.0
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(tgr._ecdf_rows(d, support), jgr._ecdf_rows(d, support))
    np.testing.assert_array_equal(tgr._ecdf(d[1], support), jgr._ecdf(d[1], support))


# ------------------------------------------------------------------ the kernels on the card


def _k7_card_cases() -> list[tuple[str, np.ndarray, np.ndarray]]:
    """K7's shapes on the card: the slot layout (one set, batches, the
    envelope's 100 clouds of 1000), coincident points (every pair in one
    bin, two sets so the counters flush on the change of set), n = 1, 2,
    511, 513 and one past the 1024-point column tile, NaN coordinates,
    d = 1, 3, 5, repeated thresholds, and the generic path's layouts at
    8000, 30,000 and 60,000 thresholds."""
    rng = np.random.default_rng(12)
    cases = [(f"S={s} n={n} d={d} L={L}", rng.uniform(0, 100, (s, n, d)), np.linspace(0.0, 80.0, L))
             for s, n, d, L in [(1, 3000, 2, 50), (7, 1000, 2, 50), (100, 1000, 2, 50), (2, 1500, 3, 9),
                                (1, 700, 5, 40), (2, 1500, 1, 9), (1, 1025, 2, 8000), (1, 1025, 2, 30000),
                                (1, 600, 2, 60000)]]
    cases += [(f"n={n}", rng.uniform(0, 100, (1, n, 2)), np.linspace(0.0, 80.0, 50)) for n in (1, 2, 511, 513, 1025)]
    cases.append(("coincident", np.repeat(rng.uniform(0, 100, (2, 1, 2)), 3000, axis=1), np.linspace(0.0, 80.0, 50)))
    nan = rng.uniform(0, 100, (1, 3000, 2))
    nan[0, rng.integers(0, 3000, 40), rng.integers(0, 2, 40)] = np.nan
    cases.append(("NaN coordinates", nan, np.linspace(0.0, 80.0, 50)))
    cases.append(("repeated thresholds", rng.uniform(0, 100, (1, 2000, 2)), np.r_[0, 0, 10, 10, 10, 50, 200, 3]))
    return cases


@pytest.mark.cuda
def test_k7_matches_plain_on_card(cuda_card):
    for name, pts, support in _k7_card_cases():
        p = torch.from_numpy(pts.astype(np.float32))
        thr = torch.from_numpy(_thresholds(support))
        want = trip.ripley_pairs(p, thr)
        got = trip.ripley_pairs(p.cuda(), thr.cuda())
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=name)


@pytest.mark.cuda
def test_k8_matches_plain_on_card(cuda_card, monkeypatch):
    for n_sets, m, n, dim, k in [(1, 2000, 3000, 2, 2), (9, 500, 800, 2, 1), (1, 300, 500, 3, 7),
                                 (1, 300, 500, 4, 3), (2, 200, 300, 2, 40)]:
        rng = np.random.default_rng(m + k)
        q = torch.from_numpy(rng.uniform(0, 100, (m, dim)).astype(np.float32))
        data = torch.from_numpy(np.repeat(rng.uniform(0, 100, (n_sets, n // 2, dim)), 2, axis=1).astype(np.float32))
        want = tknn.nearest_points(q, data, k)
        got = tknn.nearest_points(q.cuda(), data.cuda(), k)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    # the grid search's adversarial inputs (test_torch_cross_knn.py), also with no ring-bound margin
    from test_torch_cross_knn import _cases

    for margin in (tknn._GAP_MARGIN, 0.0):
        monkeypatch.setattr(tknn, "_GAP_MARGIN", margin)
        for name, queries, data, k in _cases():
            q, x = torch.from_numpy(queries), torch.from_numpy(data)
            want = tknn.nearest_points(q, x, k)
            got = tknn.nearest_points(q.cuda(), x.cuda(), k)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy(), err_msg=name)
            np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy(), err_msg=name)
