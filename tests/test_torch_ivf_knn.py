"""squidpy_torch's IVF kNN (``ops/ivf_knn.py``, kernels K14-K16) against
squidpy_tpu's ``ops/ivf_knn.py``.

Tolerances. The port ranks centroids, probes, search candidates and refine
candidates by the key ``bits(d2) << 32 | index``, d2 the difference form
in axis order (ties to the lowest index); the JAX package ranks the first
three by the expanded form, whose error is a few ulps of max |x|^2 times d,
and sums the refine's d2 in XLA's order. So:

- k-means: the init rows are bitwise JAX's; the codes are equal on a
  fixture whose best and second-best centroid d2 lie at least
  :data:`KMEANS_MARGIN` of max |x|^2 apart at every iteration (asserted),
  and the centroids lie within :data:`CENTROID_TOL` of max |x| of JAX's
  (both sum the same bf16-rounded rows in float32, in two orders);
- the member table (with and without spill), the replica table and the
  slot map are bitwise JAX's from JAX's codes, d2 and centroids, on
  fixtures whose ranked centroids lie at least :data:`TIE_ULPS` ulps of
  max |x|^2 times d apart (asserted);
- on JAX's own index (:func:`ivf_index_from_numpy`), the port's merged and
  refined neighbours equal JAX's on fixtures whose k + 1 nearest
  candidates lie that far apart (asserted); the distances agree within 2
  ulps (8 features: each package sums the squares in its own order and
  takes a correctly rounded root);
- ``sampled_recall`` equals JAX's float for float (both take the exact
  neighbours of the same sampled rows; blobs have no near ties there);
- the whole ``ivf_knn``: both packages' distance-based recall against the
  exact kNN over JAX's floors, within :data:`RECALL_MARGIN` of each other.

K14-K16 run only on the card (the cuda-marked test holds each to its plain
version, on each route); the order of K14's update sums is held here by a
numpy emulation. So is the rule of K14's and K15's tensor-core filter routes
(csrc/knn_filter.cuh): the bounding pass's lists a lane, the bound T_i, then
the candidate test, with the bf16 terms rounded as ``cvt.rn`` rounds them
and the tensor cores' sums in two float32 orders and in float64; every
member of the plain version's top k is asserted among the candidates (or
the row past its buffer re-ranks every column) on adversarial inputs. The
wrappers' filter and exact routes run around a numpy emulation of their C
interface, bitwise against the plain versions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_feature_knn import _bf16_rn, _four_squares
from test_torch_radius import _view

import squidpy_torch as sqt
from squidpy_torch import _cuda
from squidpy_torch.ops import ivf_knn as tivf
from squidpy_torch.ops import knn as tknn
from squidpy_tpu.ops import ivf_knn as jivf
from squidpy_tpu.ops import knn as jknn

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
TIE_ULPS = 8
KMEANS_MARGIN = 32 * EPS32  # of max |x|^2: 4 ulps a feature at 8 features
CENTROID_TOL = 2.0**-20  # of max |x|
RECALL_MARGIN = 0.01


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _blobs(n: int, d: int, n_centers: int = 12, seed: int = 0) -> np.ndarray:
    """The JAX package's test fixture: Gaussian blobs of unit spread."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, size=(n_centers, d))
    return (centers[rng.integers(0, n_centers, n)] + rng.normal(0, 1.0, (n, d))).astype(np.float32)


def _skewed(n: int, seed: int = 0) -> np.ndarray:
    """The JAX package's spill fixture: a dense and a wide Gaussian."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 0.5, (2 * n // 3, 16)), rng.normal(6, 3.0, (n - 2 * n // 3, 16))]
                          ).astype(np.float32)


def _exact(X: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    d, i = tknn.feature_knn(torch.from_numpy(X), k)
    return d.numpy(), i.numpy()


def _recall(d_approx: np.ndarray, d_exact: np.ndarray) -> float:
    """JAX's test measure: a hit is any neighbour at most the exact k-th distance."""
    return float(np.mean(d_approx <= d_exact[:, -1][:, None] * (1 + 1e-6)))


def _uniform(n: int, d: int, seed: int) -> np.ndarray:
    """Rows uniform in [-0.5, 0.5]^d: a small max |x|^2 keeps the expanded
    form's ties rare."""
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (n, d)).astype(np.float32)


def _tie_tol(X: np.ndarray) -> float:
    """The expanded form's near ties: TIE_ULPS ulps of max |x|^2 times d."""
    return TIE_ULPS * EPS32 * float(np.abs(X).max()) ** 2 * X.shape[1]


def _assert_apart(data: np.ndarray, points: np.ndarray, cand: np.ndarray, rows: int, tol: float | None, what: str,
                  boundary: bool = False) -> None:
    """The fixture condition: for each of ``points`` (m, d), the float64 d2
    of its ``rows`` + 1 nearest distinct candidates (ids into ``data`` in
    its row of ``cand``; ids outside [0, len(data)) left out) lie more than
    ``tol`` apart: every two in turn, or with ``boundary`` the ``rows``-th
    and the next. ``tol`` None: d ulps of the larger d2 (two orders of a
    sum of d squares differ by less)."""
    for p, ids in zip(points, cand):
        ids = np.unique(ids[(ids >= 0) & (ids < len(data))])
        d2 = np.sort(((data[ids].astype(np.float64) - p.astype(np.float64)) ** 2).sum(axis=1))[: rows + 1]
        if d2.size <= rows:
            continue
        gaps = np.diff(d2)[-1:] if boundary else np.diff(d2)
        lim = tol if tol is not None else EPS32 * data.shape[1] * d2[1:][-gaps.size:]
        assert np.all(gaps > lim), f"fixture: a near tie among the {what}"


# -- the port's versions of the JAX package's tests --------------------------


@pytest.mark.parametrize(("case", "k", "kw", "floor"), [
    ("blobs 16 features", 15, {}, 0.95),
    ("blobs 64 features", 10, {}, 0.95),
    ("spill", 10, {"cap_factor": 1.0, "n_clusters": 16}, 0.9),
])
def test_recall_over_floor_and_near_jax(case, k, kw, floor):
    X = {"blobs 16 features": lambda: _blobs(8000, 16), "blobs 64 features": lambda: _blobs(5000, 64, seed=4),
         "spill": lambda: _skewed(6000)}[case]()
    de, _ = _exact(X, k)
    stats: dict = {}
    dt, _, _ = tivf._ivf_knn(X, k, seed=1, stats=stats, **kw)
    dj, _ = jivf.ivf_knn(X, k, seed=1, **kw)
    rt, rj = _recall(dt.numpy(), de), _recall(dj, de)
    assert rt > floor and rj > floor
    assert abs(rt - rj) <= RECALL_MARGIN
    if case == "spill":
        assert stats["spilled"] > 0


def test_output_contract():
    X = _blobs(3000, 16)
    d, i = tivf.ivf_knn(X, 8, seed=0)
    assert d.shape == (3000, 8) and i.shape == (3000, 8) and d.dtype == np.float32 and i.dtype == np.int32
    assert (np.diff(d, axis=1) >= 0).all(), "rows ascend"
    assert not (i == np.arange(3000)[:, None]).any(), "self excluded"
    assert (i >= 0).all() and (i < 3000).all()
    picked = np.linalg.norm(X[i].astype(np.float64) - X[:, None, :], axis=-1)
    np.testing.assert_allclose(d, picked, rtol=1e-6, atol=1e-6)
    assert tivf.ivf_knn(X, 8, seed=0, return_distances=False)[0] is None


def test_deterministic():
    X = _blobs(3000, 16)
    a, b = tivf.ivf_knn(X, 8, seed=5), tivf.ivf_knn(torch.from_numpy(X), 8, seed=5)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_k_too_large_raises():
    with pytest.raises(ValueError, match="n_neighs"):
        tivf.ivf_knn(_blobs(100, 8), 100)


def test_member_table_is_a_partition():
    X = _blobs(4000, 8)
    cents, codes, d2 = tivf.kmeans_device(X, 16, seed=0)
    members = tivf._pack_members(codes, d2, cents, X, int(np.ceil(1.5 * 4000 / 16 / 8) * 8))
    assert np.array_equal(np.sort(members[members < 4000]), np.arange(4000))


def test_assignment_is_the_nearest_centroid():
    """Codes and d2 are the least difference-form d2 in axis order, ties to
    the lowest index (two centroids made equal)."""
    X = _blobs(3000, 8)
    cents, codes, d2 = tivf.kmeans_device(X, 32, iters=4, seed=0)
    cents[5] = cents[3]
    idx, d2_own = tivf._nearest(torch.from_numpy(X), torch.from_numpy(cents), 1)
    full = tknn.pairwise_sq_dists_exact(torch.from_numpy(X), torch.from_numpy(cents)).numpy()
    np.testing.assert_array_equal(idx[:, 0].numpy(), full.argmin(axis=1))
    np.testing.assert_array_equal(d2_own.numpy(), full.min(axis=1))
    assert not (idx[:, 0].numpy() == 5).any()


@pytest.mark.parametrize("which", ["exact", "jax ivf", "junk"])
def test_sampled_recall_matches_jax(which):
    X = _blobs(3000, 16)
    k = 10
    idx = {"exact": lambda: _exact(X, k)[1], "jax ivf": lambda: jivf.ivf_knn(X, k, seed=0, nprobe=2)[1],
           "junk": lambda: np.random.default_rng(0).integers(0, 3000, size=(3000, k)).astype(np.int32)}[which]()
    got = tivf.sampled_recall(X, idx, k, n_samples=64, seed=0)
    assert got == jivf.sampled_recall(X, idx, k, n_samples=64, seed=0)
    if which == "exact":
        assert got == 1.0
    if which == "junk":
        assert got < 0.2


# -- against the JAX package, stage by stage ---------------------------------


def test_kmeans_init_codes_and_centroids_match_jax():
    X = _blobs(3000, 8, seed=5)
    scale = float(np.abs(X).max())
    init = np.random.default_rng(5).choice(3000, size=32, replace=False)
    for it in range(5):
        ct, kt, dt = tivf.kmeans_device(X, 32, iters=it, seed=5)
        cj, kj, _ = jivf.kmeans_device(X, 32, iters=it, seed=5)
        if it == 0:
            np.testing.assert_array_equal(ct, X[init])
            np.testing.assert_array_equal(cj, X[init])
        d2 = np.sort(((X[:, None, :].astype(np.float64) - ct[None].astype(np.float64)) ** 2).sum(axis=-1), axis=1)
        assert (d2[:, 1] - d2[:, 0]).min() > KMEANS_MARGIN * scale**2, "fixture: a row near a centroid boundary"
        np.testing.assert_array_equal(kt, kj)
        assert np.abs(ct - cj).max() <= CENTROID_TOL * scale
        assert dt.dtype == np.float32 and dt.shape == (3000,)


def _jax_index(X: np.ndarray, k: int, *, nprobe: int = 16, cap_factor: float = 1.5, seed: int = 0) -> dict:
    """The JAX package's ``ivf_knn`` stage by stage (n <= 65,536: one row
    tile, no padded rows), asserted equal to its own ``ivf_knn``."""
    n, d = X.shape
    c = max(2, min(int(2 ** np.round(np.log2(max(np.sqrt(n), 2.0)))), n // max(2 * k, 8)))
    nprobe = min(nprobe, c)
    coords_s = jnp.concatenate([jnp.asarray(X), jnp.zeros((1, d), jnp.float32)])
    init = np.random.default_rng(seed).choice(n, size=c, replace=False)
    cents, codes, best = jivf._kmeans_iterations(coords_s[:-1], coords_s[init], c, 4, n)
    cap = int(np.ceil(cap_factor * n / c / 128.0) * 128)
    while nprobe * cap < k + 1:
        cap += 128
    members = jivf._pack_members(np.asarray(codes), np.asarray(best), np.asarray(cents), X, cap)
    cap_q = int(np.ceil(1.4 * nprobe * n / c / 8.0) * 8)
    n_dev = jnp.asarray(n, jnp.int32)
    qtable, slot_map = jivf._build_replicas(coords_s[:-1], cents, n_dev, nprobe, n, c, cap_q)
    vals, idx = jivf._ivf_search_chunk(coords_s, jnp.asarray(members), qtable, jnp.asarray(0, jnp.int32), n_dev, k,
                                       True, c)
    merged = jivf._merge_slots(jnp.concatenate([vals, jnp.full((1, k), jnp.inf, vals.dtype)]),
                               jnp.concatenate([idx, jnp.zeros((1, k), jnp.int32)]), slot_map, k)
    d2, refined = jivf._refine_pass(coords_s, merged, n_dev, k, n, True)
    dj, ij = jivf.ivf_knn(X, k, nprobe=nprobe, cap_factor=cap_factor, seed=seed)
    np.testing.assert_array_equal(ij, np.asarray(refined))
    np.testing.assert_array_equal(dj, np.sqrt(np.asarray(d2)))
    return {"cents": np.asarray(cents), "codes": np.asarray(codes), "best": np.asarray(best), "cap": cap,
            "members": members, "cap_q": cap_q, "nprobe": nprobe, "qtable": np.asarray(qtable),
            "slot_map": np.asarray(slot_map), "merged": np.asarray(merged), "d": np.sqrt(np.asarray(d2)),
            "refined": np.asarray(refined)}


@pytest.mark.parametrize("spill", [False, True], ids=["no spill", "spill"])
def test_pack_members_matches_jax(spill):
    X = _uniform(3000, 8, seed=7)
    c = 32
    cents, codes, best = jivf.kmeans_device(X, c, seed=7)
    cap = int(np.ceil((1.0 if spill else 1.5) * 3000 / c / 8) * 8)
    over = np.bincount(codes, minlength=c) > cap
    assert over.any() == spill
    if spill:
        # the spilled rows' 16 ranked centroids and the 17th, apart
        spilled = np.flatnonzero(over[codes])
        _assert_apart(cents, X[spilled], np.tile(np.arange(c), (len(spilled), 1)), 16, _tie_tol(X), "ranked centroids")
    got = tivf._pack_members(codes, best, cents, X, cap)
    np.testing.assert_array_equal(got, jivf._pack_members(codes, best, cents, X, cap))


def test_replica_tables_match_jax():
    X = _uniform(2000, 8, seed=0)
    ji = _jax_index(X, 8, nprobe=8, seed=0)
    _assert_apart(ji["cents"], X, np.tile(np.arange(len(ji["cents"])), (len(X), 1)), ji["nprobe"], _tie_tol(X),
                  "probes")
    qtable, slot_map, dropped = tivf._build_replicas(torch.from_numpy(X), torch.from_numpy(ji["cents"]), ji["nprobe"],
                                                     ji["cap_q"])
    np.testing.assert_array_equal(qtable.numpy(), ji["qtable"])
    np.testing.assert_array_equal(slot_map.numpy(), ji["slot_map"])
    assert int(dropped) == int((ji["slot_map"] == ji["qtable"].size).sum())


def test_search_merge_refine_on_the_jax_index():
    """The merged lists as sets (JAX orders them by the expanded form), the
    refined lists in order."""
    X = _uniform(3000, 8, seed=0)
    k = 8
    ji = _jax_index(X, k, seed=0)
    n, cap_q = len(X), ji["cap_q"]
    index = tivf.ivf_index_from_numpy(ji["cents"], ji["members"], ji["qtable"], ji["slot_map"], "cpu")
    xp = tivf._padded(torch.from_numpy(X))
    keys = tivf._search(xp, index.members, index.qtable, k, True)
    merged = tivf._merge_slots(keys, index.slot_map, k).numpy()
    # fixture: each row's k-th and (k+1)-th nearest probed members (itself left out) apart
    kept = ji["slot_map"] < ji["qtable"].size
    probed = np.where(kept[:, :, None], ji["members"][np.where(kept, ji["slot_map"] // cap_q, 0)], -1).reshape(n, -1)
    probed = np.where(probed == np.arange(n)[:, None], -1, probed)
    _assert_apart(X, X, probed, k, _tie_tol(X), "probed members", boundary=True)
    np.testing.assert_array_equal(np.sort(merged, axis=1), np.sort(ji["merged"], axis=1))
    # the refine on JAX's merged lists: candidates the list and its lists
    cand = np.concatenate([ji["merged"], ji["merged"][ji["merged"]].reshape(n, -1)], axis=1)
    cand = np.where(cand == np.arange(n)[:, None], -1, cand)
    _assert_apart(X, X, cand, k, None, "refine candidates")
    d, i = tivf._refine(xp, torch.from_numpy(ji["merged"]), k, True)
    np.testing.assert_array_equal(i.numpy(), ji["refined"])
    assert np.all(np.abs(d.numpy().view(np.int32) - ji["d"].astype(np.float32).view(np.int32)) <= 2)
    # the whole search on the index
    d2, i2 = tivf.ivf_search(torch.from_numpy(X), index, k)
    np.testing.assert_array_equal(i2.numpy(), ji["refined"])
    np.testing.assert_array_equal(d2.numpy(), d.numpy())


def test_fewer_than_k_candidates_end_with_inf_and_minus_one():
    """Two far blobs of 20 rows, one probe each: a row sees its own blob
    only, 19 other rows, so its last 6 of 25 slots are +inf and -1. (The
    JAX package leaves those slots undefined: inf distances beside ids its
    sentinels reach; ROADMAP.md queue 3.)"""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 1, (20, 4)), rng.normal(100, 1, (20, 4))]).astype(np.float32)
    d, i = tivf.ivf_knn(X, 25, nprobe=1)
    assert np.isfinite(d[:, :19]).all() and (i[:, :19] >= 0).all()
    assert np.isinf(d[:, 19:]).all() and (i[:, 19:] == -1).all()
    blob = np.arange(40) // 20
    assert (blob[i[:, :19]] == blob[:, None]).all()


# -- K14's update order, K12's full sweep ------------------------------------


def _update_emulation(x: np.ndarray, codes: np.ndarray, valid: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """K14's update in numpy, as csrc/ivf_kmeans.cu orders it: each
    cluster's valid rows in index order, bf16-rounded, in runs of 32 summed
    left to right from +0 in float32, the runs' sums by a pairwise tree over
    the runs padded with zeros to a power of two, then sum / count."""
    xb = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    out = cents.copy()
    for c in range(len(cents)):
        rows = np.flatnonzero((codes == c) & valid)
        if not rows.size:
            continue
        runs = []
        for r0 in range(0, rows.size, 32):
            s = np.zeros(x.shape[1], np.float32)
            for r in rows[r0 : r0 + 32]:
                s = s + xb[r]
            runs.append(s)
        width = 1 << int(np.ceil(np.log2(len(runs))))
        level = runs + [np.zeros(x.shape[1], np.float32)] * (width - len(runs))
        while len(level) > 1:
            level = [level[j] + level[j + 1] for j in range(0, len(level), 2)]
        out[c] = level[0] / np.float32(rows.size)
    return out


@pytest.mark.parametrize("case", ["blobs", "one large cluster", "empty and invalid", "signed zeros and ties"])
def test_update_order_emulation_matches_plain(case):
    rng = np.random.default_rng(7)
    n, c, d = 3000, 16, 8
    x = (rng.normal(0, 50, (n, d)) * rng.lognormal(0, 2, (n, 1))).astype(np.float32)
    codes = rng.integers(0, c, n).astype(np.int32)
    valid = np.ones(n, bool)
    if case == "one large cluster":
        codes[rng.random(n) < 0.8] = 3  # ~2400 rows: 75 runs, an odd tree
    if case == "empty and invalid":
        codes[codes == 9] = 10
        valid[::7] = False
    if case == "signed zeros and ties":
        x[::3] = -0.0
        x[1::3] = np.float32(1.0 + 2.0**-8)  # halfway between two bf16 values: rounds to even
    cents = rng.normal(size=(c, d)).astype(np.float32)
    t = tivf._update(torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(valid), torch.from_numpy(cents))
    np.testing.assert_array_equal(t.numpy(), _update_emulation(x, codes, valid, cents))
    if case == "empty and invalid":
        np.testing.assert_array_equal(t.numpy()[9], cents[9])


@pytest.mark.parametrize("exclude_self", [True, False])
def test_brute_force_knn_approx_matches_jax(exclude_self):
    """The full sweep behind the fallback: JAX's PartialReduce selection is
    the exact top k on the CPU, the port's is exact: equal neighbours on a
    fixture free of near ties at the k-th (asserted), distances within 2
    ulps; with the row itself, at position 0."""
    X = _uniform(1500, 8, seed=0)
    k = 10
    others = np.where(np.eye(1500, dtype=bool), -1, np.tile(np.arange(1500), (1500, 1)))
    _assert_apart(X, X, others, k, _tie_tol(X), "neighbours", boundary=True)
    _assert_apart(X, X, others, k, None, "neighbours")
    dt, it = tknn.brute_force_knn_approx(X, k, exclude_self=exclude_self)
    dj, ij = jknn.brute_force_knn_approx(X, k, exclude_self=exclude_self)
    np.testing.assert_array_equal(it, ij)
    assert np.all(np.abs(dt.view(np.int32) - dj.astype(np.float32).view(np.int32)) <= 2)
    if not exclude_self:
        np.testing.assert_array_equal(it[:, 0], np.arange(1500))
        np.testing.assert_array_equal(it[:, 1:], _exact(X, k - 1)[1])


def test_brute_force_knn_approx_with_duplicates_keeps_key_order():
    """With the row itself: its key (0, row) sits after duplicate rows of
    lower index and before those of higher index."""
    X = _blobs(200, 4)
    X[10] = X[3]
    X[11] = X[3]
    d, i = tknn.brute_force_knn_approx(X, 5, exclude_self=False)
    np.testing.assert_array_equal(i[3, :3], [3, 10, 11])
    np.testing.assert_array_equal(i[10, :3], [3, 10, 11])
    np.testing.assert_array_equal(i[11, :3], [3, 10, 11])
    assert (d[3, :3] == 0).all()


# -- K14's and K15's filter routes: the rule, and the wrappers around an emulated C interface


_U64_MAX = np.iinfo(np.uint64).max


def _cross_keys(q: np.ndarray, y: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(nq, ny) uint64 keys ``bits(d2) << 32 | id`` of the float32
    difference-form d2 of each query row against each candidate row, summed
    in axis order (NaN as 0x7fc00000)."""
    d2 = np.zeros((q.shape[0], y.shape[0]), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for e in range(q.shape[1]):
            diff = q[:, None, e] - y[None, :, e]
            d2 = (d2 + diff * diff).astype(np.float32)
    bits = np.where(np.isnan(d2), np.uint32(tknn._NAN_D2_BITS), d2.view(np.uint32)).astype(np.uint64)
    return (bits << np.uint64(32)) | ids.astype(np.uint64)[None, :]


def _ivf_filter_emulation(q: np.ndarray, y: np.ndarray, need: int, order: str = "forward"
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The rule of the filter route (csrc/knn_filter.cuh) for query rows
    ``q`` against candidate rows ``y`` (padded, float32): both centred on
    the mean of ``y``'s finite entries; the bf16 terms; A = -n_j / 2 plus
    the products lo_i hi_j, hi_i lo_j, hi_i hi_j summed in float32 forward
    (the C operand first) or ``reverse`` (it last), or in ``float64`` and
    rounded once. The bounding pass: U = n_i + delta_it - 2 A, each lane
    (the columns 8 f + 2 t and + 1) its S least (S = 1, 4 or 8, the least
    that 4 S >= need), T_i the least of the lanes' least (need = 1) or the
    largest of their S-th least. The candidates: every pair unless A < M_it =
    (n_i - delta_it - T_i) / 2. U and M in float64: U no larger and M no
    smaller than the kernel's rounded values, so no column is a candidate
    here that the kernel would not take. Returns (candidates (nq, ny) bool,
    T_i (nq,) float64)."""
    n_q, dp = q.shape
    n_c = y.shape[0]
    c, a = tknn._k12_filter_constants(dp)
    fin = np.isfinite(y)
    mu = (np.where(fin, y, 0.0).astype(np.float64).sum(axis=0) / np.maximum(fin.sum(axis=0), 1)).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        qc, yc = (q - mu).astype(np.float32), (y - mu).astype(np.float32)
        nq_, ny_ = ((qc * qc).sum(axis=1, dtype=np.float32), (yc * yc).sum(axis=1, dtype=np.float32))
    bound = lambda v: np.where(np.isfinite(v) & (v < 2.0**124), v, np.nan).astype(np.float32)  # noqa: E731
    ni, nj = bound(nq_).astype(np.float64), bound(ny_)
    hq, hy = _bf16_rn(qc), _bf16_rn(yc)
    with np.errstate(invalid="ignore", over="ignore"):
        lq, ly = _bf16_rn((qc - hq).astype(np.float32)), _bf16_rn((yc - hy).astype(np.float32))
        hneg = (np.float32(-0.5) * nj).astype(np.float32)
        prods = [(lq[:, None, e] * hy[None, :, e], hq[:, None, e] * ly[None, :, e], hq[:, None, e] * hy[None, :, e])
                 for e in range(dp)]
        if order == "float64":
            acc = np.broadcast_to(hneg.astype(np.float64), (n_q, n_c)).copy()
            for trio in prods:
                for pr in trio:
                    acc += pr.astype(np.float64)
            acc = acc.astype(np.float32)
        elif order == "forward":
            acc = np.broadcast_to(hneg, (n_q, n_c)).astype(np.float32)
            for trio in prods:
                for pr in trio:
                    acc = (acc + pr).astype(np.float32)
        else:
            acc = np.zeros((n_q, n_c), np.float32)
            for trio in prods[::-1]:
                for pr in trio[::-1]:
                    acc = (acc + pr).astype(np.float32)
            acc = (acc + hneg).astype(np.float32)
    tile = tknn._k12_tile_cols(dp)
    col = np.arange(n_c)
    nmax = np.zeros(n_c)
    for t0 in range(0, n_c, tile):
        seg = nj[t0 : t0 + tile]
        nmax[t0 : t0 + tile] = 0.0 if np.all(np.isnan(seg)) else float(np.nanmax(seg))
    with np.errstate(invalid="ignore", over="ignore"):
        delta = c * (ni[:, None] + nmax[None, :]) + a
        u = ni[:, None] + delta - 2.0 * acc.astype(np.float64)
    s = 1 if need == 1 else (4 if need <= 16 else 8)
    lane = (col % 8) // 2
    per_lane = []
    for t in range(4):
        ut = np.where(np.isnan(u[:, lane == t]), np.inf, u[:, lane == t])
        ut = np.sort(np.concatenate([ut, np.full((n_q, s), np.inf)], axis=1), axis=1)
        per_lane.append(ut[:, 0] if need == 1 else ut[:, s - 1])
    thr = np.min(per_lane, axis=0) if need == 1 else np.max(per_lane, axis=0)
    with np.errstate(invalid="ignore", over="ignore"):
        m = (ni[:, None] - delta - thr[:, None]) / 2.0
        cand = ~(acc.astype(np.float64) < m)
    return cand, thr


def _buffer(need: int) -> int:
    """A row's candidate buffer (csrc/knn_filter.cuh ``buffer_cols``)."""
    return 16 * (1 if need == 1 else (4 if need <= 16 else 8))


def _assert_filter_keeps_top(q: np.ndarray, y: np.ndarray, ids: np.ndarray, qids: np.ndarray | None, k: int,
                             order: str) -> np.ndarray:
    """The rule keeps every member of each query's exact top k (the query's
    own id left out when ``qids`` is given), or the query re-ranks every
    column; T_i is at least the k-th least exact d2. Returns the counts."""
    need = k + (qids is not None)
    cand, thr = _ivf_filter_emulation(q, y, need, order)
    keys = _cross_keys(q, y, ids)
    if qids is not None:
        keys = np.where(ids[None, :] == qids[:, None], _U64_MAX, keys)
    top = np.argsort(keys, axis=1, kind="stable")[:, :k]
    counts = cand.sum(axis=1)
    kept = np.take_along_axis(cand, top, axis=1) | (counts > _buffer(need))[:, None]
    assert kept.all(), f"{int((~kept).sum())} members of the exact top {k} not re-ranked"
    kth = (np.take_along_axis(keys, top[:, -1:], axis=1)[:, 0] >> np.uint64(32)).astype(np.uint32).view(np.float32)
    bounded = np.isfinite(thr)
    assert np.all(thr[bounded] >= kth[bounded].astype(np.float64)), "T_i below the k-th exact d2"
    return counts


IVF_ADVERSARIAL = ["blobs", "ulp", "duplicates", "offset", "nan", "d50"]


def _ivf_adversarial(case: str) -> tuple[np.ndarray, np.ndarray]:
    """Seeded (query rows, candidate rows), padded to K12's width: blobs;
    one-ulp gaps between integer d2 in [2^23, 2^24); duplicate candidates
    and queries; a common offset of 1e4 (centred away); NaN and inf in rows
    and candidates; 50 features."""
    rng = np.random.default_rng(IVF_ADVERSARIAL.index(case))
    if case == "ulp":  # the origin's d2 to 40 candidates are consecutive integers in [2^23, 2^24): one ulp apart
        y = rng.uniform(-30000, 30000, (300, 4)).astype(np.float32)
        q = np.zeros((4, 4), np.float32)
        for i in range(40):
            y[3 + 7 * i] = _four_squares(2**23 + 5000 + i)
    elif case == "duplicates":
        y = _blobs(300, 10, seed=2)
        y[rng.integers(0, 300, 120)] = y[rng.integers(0, 300, 120)]
        q = y[rng.integers(0, 300, 60)] + np.where(rng.random((60, 1)) < 0.5, 0.0, 0.01).astype(np.float32)
    elif case == "offset":
        y = (1e4 + rng.normal(0, 1, (300, 16))).astype(np.float32)
        q = (1e4 + rng.normal(0, 1, (60, 16))).astype(np.float32)
    elif case == "nan":
        y = _blobs(300, 6, seed=3)
        q = _blobs(60, 6, seed=4)
        y[[5, 77]] = np.nan
        y[100, 2] = np.inf
        q[[3, 9], 1] = np.nan
        q[20, 0] = -np.inf
    else:
        d = 50 if case == "d50" else 16
        y, q = _blobs(300, d, seed=5), _blobs(60, d, seed=6)
    dp = tknn._feature_pad(y.shape[1])
    pad = lambda v: np.pad(v, ((0, 0), (0, dp - v.shape[1]))).astype(np.float32)  # noqa: E731
    return pad(q), pad(y)


@pytest.mark.parametrize("order", ["forward", "reverse", "float64"])
@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("case", IVF_ADVERSARIAL)
def test_k14_filter_keeps_the_exact_nearest(case, m, order):
    """K14's rule: rows against the centroids (here 300 candidate rows),
    every member of each row's exact m nearest among the candidates."""
    q, y = _ivf_adversarial(case)
    counts = _assert_filter_keeps_top(q, y, np.arange(len(y)), None, m, order)
    if case in ("blobs", "d50", "offset"):
        assert counts.mean() < len(y) / 4  # the rule filters


@pytest.mark.parametrize("order", ["forward", "reverse", "float64"])
@pytest.mark.parametrize("case", IVF_ADVERSARIAL)
def test_k15_filter_keeps_the_exact_top_k(case, order):
    """K15's rule on one cluster: its members (here 300 rows of ids 1000 +
    j) centred on their own mean, replicas among them (the replica's own id
    left out: k + 1 bound) and outside them."""
    q, y = _ivf_adversarial(case)
    ids = 1000 + np.arange(len(y))
    q = np.concatenate([q, y[:20]])  # replicas that are members
    qids = np.concatenate([np.arange(len(q) - 20), ids[:20]])
    counts = _assert_filter_keeps_top(q, y, ids, qids, 15, order)
    if case in ("blobs", "d50", "offset"):
        assert counts.mean() < len(y) / 4


def test_ivf_route_rule():
    assert tivf._ivf_route(16, 16) == "filter" and tivf._ivf_route(64, 32) == "filter"
    assert tivf._ivf_route(96, 16) == "exact" and tivf._ivf_route(16, 33) == "exact"
    assert tivf._ivf_route(12, 1) == "exact"  # a width the filter has no instance for


class _EmulatedIvf:
    """K14's nearest entry and K15 as C interfaces in numpy, reading and
    writing CPU tensors through the wrapper's pointers. The exact routes:
    every pair's exact key; the filter routes: :func:`_ivf_filter_emulation`
    on each set (K14: the rows against the centroids; K15: each cluster's
    replicas against its members), the exact keys of the candidates (of every
    column past the row's buffer), the counters when asked for."""

    def __init__(self) -> None:
        self.calls = []

    @staticmethod
    def _rank(q, y, ids, qids, k, need):
        cand, _ = _ivf_filter_emulation(q, y, need)
        keys = _cross_keys(q, y, ids)
        if qids is not None:
            keys = np.where(ids[None, :] == qids[:, None], _U64_MAX, keys)
        counts = cand.sum(axis=1)
        over = counts > _buffer(need)
        keys = np.where(cand | over[:, None], keys, _U64_MAX)
        best = np.sort(keys, axis=1)[:, :k]
        if best.shape[1] < k:
            best = np.concatenate([best, np.full((len(q), k - best.shape[1]), _U64_MAX, np.uint64)], axis=1)
        return np.where(best == _U64_MAX, np.uint64(tivf._NO_KEY), best), counts, over

    @staticmethod
    def _stats(ptr, counts, over):
        if ptr is None:
            return
        done = counts[~over]
        _view(ptr, np.int64, 5)[:] = [done.sum(), 0, done.max(initial=0), done.size, over.sum()]

    def sqt_ivf_nearest(self, x, n, dp, cents, c, m, out_i, out_d2, stream):
        self.calls.append(("nearest", "exact", dp, m))
        xs = _view(x, np.float32, n * dp).reshape(n, dp)
        ys = _view(cents, np.float32, c * dp).reshape(c, dp)
        best = np.sort(_cross_keys(xs, ys, np.arange(c)), axis=1)[:, :m]
        self._write_nearest(best, n, m, out_i, out_d2)
        return 0

    @staticmethod
    def _write_nearest(best, n, m, out_i, out_d2):
        _view(out_i, np.int32, n * m).reshape(n, m)[:] = (best & np.uint64(0xFFFFFFFF)).astype(np.int32)
        if out_d2 is not None:
            _view(out_d2, np.float32, n)[:] = (best[:, 0] >> np.uint64(32)).astype(np.uint32).view(np.float32)

    def sqt_ivf_nearest_filter(self, x, n, dp, cents, c, m, cc, aa, terms, hneg, mu, stats, out_i, out_d2, stream):
        self.calls.append(("nearest", "filter", dp, m))
        assert dp <= 64 and dp % 8 == 0 and m <= 32 and (cc, aa) == tknn._k12_filter_constants(dp)
        assert None not in (terms, hneg, mu)
        xs = _view(x, np.float32, n * dp).reshape(n, dp)
        ys = _view(cents, np.float32, c * dp).reshape(c, dp)
        best, counts, over = self._rank(xs, ys, np.arange(c), None, m, m)
        self._write_nearest(best, n, m, out_i, out_d2)
        self._stats(stats, counts, over)
        return 0

    def _clusters(self, x, n, dp, members, cap, msize, qtable, cap_q, qsize, c):
        xs = _view(x, np.float32, n * dp).reshape(n, dp)
        mem = _view(members, np.int32, c * cap).reshape(c, cap)
        qt = _view(qtable, np.int32, c * cap_q).reshape(c, cap_q)
        ms, qs = _view(msize, np.int32, c), _view(qsize, np.int32, c)
        assert np.array_equal(ms, (mem < n).sum(axis=1)) and np.array_equal(qs, (qt < n).sum(axis=1))
        for ci in range(c):
            yield ci, xs[qt[ci, : qs[ci]]], qt[ci, : qs[ci]], xs[mem[ci, : ms[ci]]], mem[ci, : ms[ci]]

    def sqt_ivf_search(self, x, n, dp, members, cap, msize, qtable, cap_q, qsize, c, k, exclude_self, out, stream):
        self.calls.append(("search", "exact", dp, k))
        o = _view(out, np.uint64, c * cap_q * k).reshape(c * cap_q, k)
        for ci, q, qids, y, ids in self._clusters(x, n, dp, members, cap, msize, qtable, cap_q, qsize, c):
            if not len(q) or not len(y):
                continue
            keys = _cross_keys(q, y, ids)
            if exclude_self:
                keys = np.where(ids[None, :] == qids[:, None], np.uint64(tivf._NO_KEY), keys)
            keys = np.sort(np.concatenate([keys, np.full((len(q), k), np.uint64(tivf._NO_KEY))], axis=1), axis=1)
            o[ci * cap_q : ci * cap_q + len(q)] = keys[:, :k]
        return 0

    def sqt_ivf_search_filter(self, x, n, dp, members, cap, msize, qtable, cap_q, qsize, c, k, exclude_self, cc, aa,
                              terms, hneg, mu, stats, out, stream):
        self.calls.append(("search", "filter", dp, k))
        assert dp <= 64 and dp % 8 == 0 and k + exclude_self <= 32 and (cc, aa) == tknn._k12_filter_constants(dp)
        assert None not in (terms, hneg, mu)
        o = _view(out, np.uint64, c * cap_q * k).reshape(c * cap_q, k)
        all_counts, all_over = [], []
        for ci, q, qids, y, ids in self._clusters(x, n, dp, members, cap, msize, qtable, cap_q, qsize, c):
            if not len(q):
                continue
            if not len(y):
                all_counts.append(np.zeros(len(q), int))
                all_over.append(np.zeros(len(q), bool))
                continue
            best, counts, over = self._rank(q, y, ids, qids if exclude_self else None, k, k + exclude_self)
            o[ci * cap_q : ci * cap_q + len(q)] = best
            all_counts.append(counts)
            all_over.append(over)
        self._stats(stats, np.concatenate(all_counts), np.concatenate(all_over))
        return 0


@pytest.fixture()
def emulated_ivf(monkeypatch):
    emu = _EmulatedIvf()
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "require", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    for name in ("ivf_kmeans", "ivf_search"):
        monkeypatch.setitem(_cuda.launches, name, 0)
    return emu


@pytest.mark.parametrize(("d", "m", "route"), [(16, 1, "filter"), (16, 16, "filter"), (50, 32, "filter"),
                                               (8, 5, "filter"), (70, 16, "exact")])
def test_k14_wrapper_emulated(emulated_ivf, d, m, route):
    """K14's nearest entry by the route the rule picks, bitwise the plain
    version; NaN rows, equal centroids; the counters."""
    x = tivf._padded(torch.from_numpy(_blobs(700, d, seed=d)))
    x[3, 1] = float("nan")
    cents = x[torch.from_numpy(np.random.default_rng(1).choice(700, 100, replace=False))].clone()
    cents[7] = cents[2]
    cents = torch.nan_to_num(cents).contiguous()
    stats = {}
    got = tivf._nearest_k14(x, cents, m, stats=stats)
    want = tivf._nearest_plain(x, cents, m)
    assert emulated_ivf.calls == [("nearest", route, x.shape[1], m)]
    assert _cuda.launches["ivf_kmeans"] == 1 and stats["route"] == route
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (m != 1)
    if m == 1:
        assert torch.equal(got[1].isnan(), want[1].isnan()) and torch.equal(
            torch.nan_to_num(got[1]), torch.nan_to_num(want[1]))
    if route == "filter":  # the NaN row's candidates pass its buffer where it is short of the centroids
        assert stats["candidates_max"] <= _buffer(m) and (stats["exact_rows"] >= 1) == (cents.shape[0] > _buffer(m))


@pytest.mark.parametrize(("d", "k", "exclude_self", "route"), [(16, 15, True, "filter"), (8, 8, False, "filter"),
                                                               (50, 31, True, "filter"), (16, 32, True, "exact"),
                                                               (100, 10, True, "exact")])
def test_k15_wrapper_emulated(emulated_ivf, d, k, exclude_self, route):
    """K15 on a real index by the route the rule picks (k + 1 bound past 32,
    or wide rows: the exact route), bitwise the plain version, with a NaN
    row and duplicate rows."""
    X = _blobs(2000, d, seed=d + k)
    X[10] = X[20]
    X[30, 2] = np.nan
    xp = tivf._padded(torch.from_numpy(X))
    with sqt.set_device("cpu"):
        _, _, index = tivf._ivf_knn(np.nan_to_num(X), min(k, 20), n_clusters=16, nprobe=4, seed=0)
    stats = {}
    got = tivf._search_k15(xp, index.members, index.qtable, k, exclude_self, stats=stats)
    want = tivf._search_plain(xp, index.members, index.qtable, k, exclude_self)
    assert emulated_ivf.calls == [("search", route, xp.shape[1], k)]
    assert _cuda.launches["ivf_search"] == 1 and stats["route"] == route
    assert torch.equal(got, want)


# -- K16: the row order, the layout, the wrapper around an emulation -----------


def _k16_case(case: str, k: int, n: int, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows (n, dp) float32 (16 features, 132 for "wide") and lists (n, k)
    int32 that K16 must handle: every entry a repeat; ids of -1 and of n or
    more (to the int32 limits); the row in its own list; duplicate rows and
    small integers (equal d2: ties to the lower id); NaN rows; fewer than k
    distinct candidates; rows past one staged chunk."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 132 if case == "wide" else 16)).astype(np.float32)
    idx = rng.integers(0, n, (n, k))
    if case == "repeats":
        idx[:] = ((np.arange(n) + 1) % n)[:, None]
    elif case == "out of range":
        idx = rng.integers(-3, n + 3, (n, k))
        idx[::7, 0] = np.iinfo(np.int32).max
        idx[::11, -1] = np.iinfo(np.int32).min
    elif case == "self":
        idx[:, 0] = np.arange(n)
        idx[::2, -1] = np.arange(0, n, 2)
    elif case == "duplicate rows":
        x = rng.integers(0, 3, x.shape).astype(np.float32)
        x[1::2] = x[::2]
    elif case == "nan":
        x[3] = np.nan
        x[7, 2] = np.nan
        idx[::5, -1] = 3
        idx[::3, 0] = 7
    elif case == "few":
        idx = rng.integers(0, 3, (n, k))
    return torch.from_numpy(x), torch.from_numpy(idx.astype(np.int32))


K16_CASES = ["repeats", "out of range", "self", "duplicate rows", "nan", "few", "wide"]


def _same_refine(got: tuple[torch.Tensor, torch.Tensor], want: tuple[torch.Tensor, torch.Tensor]) -> bool:
    """Equal indices, and equal distances with NaN equal to NaN."""
    (gd, gi), (wd, wi) = got, want
    return (torch.equal(gi, wi) and torch.equal(gd.isnan(), wd.isnan())
            and torch.equal(gd.nan_to_num(0.0, float("inf")), wd.nan_to_num(0.0, float("inf"))))


def test_row_order_covers_every_row_once_with_nan_and_spilled_rows():
    """The cluster order of a real index is a permutation of the rows, NaN
    rows and spilled rows included; a table that repeats or misses a row
    gives index order (None)."""
    X = _skewed(3000, seed=1)
    X[[5, 600, 2999]] = np.nan
    X[17, 3] = np.nan
    stats = {}
    _, _, index = tivf._ivf_knn(X, 8, n_clusters=8, nprobe=2, cap_factor=1.0, stats=stats)
    assert stats["spilled"] > 0
    order = tivf._row_order(index.members, len(X))
    assert order is not None and order.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(len(X)))
    members = index.members.clone()
    at = (members < len(X)).nonzero()[0]
    members[at[0], at[1]] = members[at[0], at[1] + 1]  # a row twice, another missing
    assert tivf._row_order(members, len(X)) is None
    assert tivf._row_order(index.members[:-1], len(X)) is None


@pytest.mark.parametrize("order", ["reverse", "random", "cluster"])
def test_refine_plain_same_under_any_row_order(monkeypatch, order):
    """The plain version on the rows in any order gives each row the result
    it has in index order (its row chunks hold other rows); ``_refine``
    given the order returns index order."""
    X = _blobs(2500, 8, seed=4)
    X[9] = X[10]
    X[11, 1] = np.nan
    x = tivf._padded(torch.from_numpy(X))
    n, k = len(X), 6
    _, idx, index = tivf._ivf_knn(X, k, n_clusters=16, nprobe=3, seed=0)
    perm = {"reverse": torch.arange(n - 1, -1, -1), "random": torch.from_numpy(np.random.default_rng(2).permutation(n)),
            "cluster": tivf._row_order(index.members, n)}[order].to(torch.int32)
    want = tivf._refine_plain(x, idx, k, True)
    monkeypatch.setitem(tivf._PLAIN_PAIRS, "cpu", (k + k * k) * x.shape[1] * 100)  # chunks of 100 rows
    got = tivf._refine_plain(x, idx, k, True, rows=perm)
    assert _same_refine(got, (want[0][perm.long()], want[1][perm.long()]))
    assert _same_refine(tivf._refine(x, idx, k, True, perm), want)


@pytest.mark.parametrize("k", [1, 15, 32])
@pytest.mark.parametrize("dp", [4, 16, 56, 132])
def test_k16_layout(k, dp):
    """Equal chunks of at most ``_K16_FEAT`` features covering dp; staged
    rows 4 mod 8 floats apart (conflict-free float4 reads); a hash set of a
    power of two at least 1.5 (k + k^2) slots; the shared memory the kernel
    computes; the most warps an SM."""
    lay = tivf._k16_layout(k, dp)
    n_cand = k + k * k
    feat, chunks = lay["feat"], lay["chunks"]
    assert feat % 4 == 0 and feat <= tivf._K16_FEAT and feat <= 128
    assert (chunks - 1) * feat < dp <= chunks * feat and chunks == -(-dp // tivf._K16_FEAT)
    assert dp - (chunks - 1) * feat >= feat - 4 * (chunks - 1)  # chunks equal but for rounding
    assert lay["stride"] % 8 == 4 and lay["stride"] >= feat
    slots = lay["slots"]
    assert slots & (slots - 1) == 0 and slots >= max(32, 1.5 * n_cand) and slots < max(64, 3 * n_cand + 2)
    assert lay["warp_smem"] == 4 * (max(64 * lay["stride"], 2 * slots) + -(-n_cand // 4) * 4 + dp)
    assert lay["block_smem"] == lay["warps"] * lay["warp_smem"] <= tivf._BLOCK_SMEM
    a_sm = {w: w * min(32, tivf._K16_SM_WARPS // w, tivf._SM_SMEM // (w * lay["warp_smem"] + 1024))
            for w in tivf._K16_WARPS}
    assert lay["warps_an_sm"] == a_sm[lay["warps"]] == max(a_sm.values())
    assert all(a_sm[w] < lay["warps_an_sm"] for w in a_sm if w > lay["warps"])


def test_k16_layout_rejects_rows_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tivf._k16_layout(15, 64_000)


_NO_KEY_U = np.uint64(tivf._NO_KEY)


class _EmulatedK16:
    """``sqt_ivf_refine`` in numpy, step by step as csrc/ivf_refine.cu runs
    a warp (its lanes in order): the candidates' ids, the hash set with
    linear probing and the list of new ids, batches of 32, the first sorted
    into the lanes' list, each later one's keys below the k-th inserted by
    the shuffle up, the results at each row's index. Asserts the layout the
    wrapper passes."""

    def __init__(self) -> None:
        self.calls = []

    def sqt_ivf_refine(self, x, n, dp, idx, k, exclude_self, order, warps, feat, slots, out_d, out_i, stream):
        lay = tivf._k16_layout(k, dp)
        assert (warps, feat, slots) == (lay["warps"], lay["feat"], lay["slots"])
        self.calls.append((dp, k, order is not None))
        xs = _view(x, np.float32, n * dp).reshape(n, dp)
        ids = _view(idx, np.int32, n * k).reshape(n, k).astype(np.int64)
        rows = np.arange(n) if order is None else _view(order, np.int32, n)
        assert np.array_equal(np.sort(rows), np.arange(n))
        od = _view(out_d, np.float32, n * k).reshape(n, k)
        oi = _view(out_i, np.int32, n * k).reshape(n, k)
        shift = 32 - (slots.bit_length() - 1)
        lane = np.arange(32)
        for row in rows:
            raw = [ids[row]] + [ids[nb] if 0 <= nb < n else np.full(k, -1) for nb in ids[row]]
            table = np.full(slots, -1, np.int64)
            found = []
            for cand in np.concatenate(raw):
                if not 0 <= cand < n or (exclude_self and cand == row):
                    continue
                h = ((int(cand) * 0x9E3779B1) & 0xFFFFFFFF) >> shift
                while table[h] not in (-1, cand):
                    h = (h + 1) & (slots - 1)
                if table[h] == -1:
                    table[h] = cand
                    found.append(cand)
            best = np.full(32, _NO_KEY_U, np.uint64)
            kth = _NO_KEY_U
            for b0 in range(0, len(found), 32):
                c = np.asarray(found[b0 : b0 + 32])
                d2 = np.zeros(len(c), np.float32)
                for e in range(dp):
                    diff = xs[row, e] - xs[c, e]
                    d2 = d2 + diff * diff
                bits = np.where(np.isnan(d2), np.uint32(0x7FC00000), d2.view(np.uint32)).astype(np.uint64)
                keys = (bits << np.uint64(32)) | c.astype(np.uint64)
                if b0 == 0:  # the first batch, sorted across the warp
                    best = np.sort(np.concatenate([keys, np.full(32 - len(keys), _NO_KEY_U, np.uint64)]))
                for key in keys[keys < kth] if b0 else ():
                    up = np.roll(best, 1)
                    best = np.where(best > key, np.where((lane == 0) | (up < key), key, up), best)
                kth = best[k - 1]
            have = best[:k] != _NO_KEY_U
            d2 = (best[:k] >> np.uint64(32)).astype(np.uint32).view(np.float32)
            od[row] = np.where(have, np.sqrt(d2), np.float32(np.inf))
            oi[row] = np.where(have, (best[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64), -1)
        return 0


@pytest.fixture()
def emulated_k16(monkeypatch):
    emu = _EmulatedK16()
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "require", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setitem(_cuda.launches, "ivf_refine", 0)
    return emu


@pytest.mark.parametrize("k", [1, 15, 32])
@pytest.mark.parametrize("case", K16_CASES)
def test_k16_wrapper_emulated(emulated_k16, case, k):
    """K16's wrapper around the emulation of its kernel, in index order and
    in a random order, with and without the row itself, bitwise the plain
    version on the adversarial lists."""
    x, idx = _k16_case(case, k, 96)
    x = tivf._padded(x)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(len(x)).astype(np.int32))
    for exclude_self in (True, False):
        want = tivf._refine_plain(x, idx, k, exclude_self)
        for order in (None, perm):
            got = tivf._refine_k16(x, idx, k, exclude_self, order)
            assert _same_refine(got, want), (exclude_self, order is None)
    assert _cuda.launches["ivf_refine"] == 4 and emulated_k16.calls[-1] == (x.shape[1], k, True)


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "d", "k"), [(20_000, 16, 15), (5000, 50, 15), (3000, 100, 8), (4000, 8, 32)])
def test_k14_k15_k16_match_plain_on_card(n, d, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K14-K16 have no CPU mode")
    x = tivf._padded(torch.from_numpy(_blobs(n, d, seed=3)).cuda())
    x[5] = x[9]
    cents = x[torch.from_numpy(np.random.default_rng(0).choice(n, 64, replace=False)).cuda()].contiguous()
    dp = x.shape[1]
    for m in (1, 16):
        want = tivf._nearest_plain(x, cents, m)
        for route in ("filter", "exact") if tivf._ivf_route(dp, m) == "filter" else ("exact",):
            got = tivf._nearest_k14(x, cents, m, route=route)
            assert torch.equal(got[0], want[0]), route
            if m == 1:
                assert torch.equal(got[1], want[1]), route
    codes = tivf._nearest(x, cents, 1)[0][:, 0]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    valid[::13] = False
    layout = tivf._update_layout(codes, valid, 64)
    assert torch.equal(tivf._update(x, codes, valid, cents), tivf._update_plain(x, *layout, cents))
    _, idx, index = tivf._ivf_knn(x, k, seed=0)
    keys = tivf._search_plain(x, index.members, index.qtable, k, True)
    for route in ("filter", "exact") if tivf._ivf_route(dp, k + 1) == "filter" else ("exact",):
        assert torch.equal(tivf._search_k15(x, index.members, index.qtable, k, True, route=route), keys), route
    merged = tivf._merge_slots(keys, index.slot_map, k)
    got, want = tivf._refine(x, merged, k, True), tivf._refine_plain(x, merged, k, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    order = tivf._row_order(index.members, n)
    assert order is not None
    assert _same_refine(tivf._refine(x, merged, k, True, order), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 15, 32])
@pytest.mark.parametrize("case", K16_CASES)
def test_k16_adversarial_lists_match_plain_on_card(case, k):
    """K16 on the adversarial lists, in index order and in a random order,
    with and without the row itself, bitwise its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K16 has no CPU mode")
    x, idx = _k16_case(case, k, 3000)
    x, idx = tivf._padded(x.cuda()), idx.cuda()
    perm = torch.from_numpy(np.random.default_rng(3).permutation(len(x)).astype(np.int32)).cuda()
    for exclude_self in (True, False):
        want = tivf._refine_plain(x, idx, k, exclude_self)
        for order in (None, perm):
            got = tivf._refine(x, idx, k, exclude_self, order)
            assert _same_refine(got, want), (exclude_self, order is None)
