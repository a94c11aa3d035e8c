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
version); the order of K14's update sums is held here by a numpy emulation.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squidpy_torch as sqt
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


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(("n", "d", "k"), [(20_000, 16, 15), (5000, 50, 15), (3000, 100, 8), (4000, 8, 32)])
def test_k14_k15_k16_match_plain_on_card(n, d, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K14-K16 have no CPU mode")
    x = tivf._padded(torch.from_numpy(_blobs(n, d, seed=3)).cuda())
    x[5] = x[9]
    cents = x[torch.from_numpy(np.random.default_rng(0).choice(n, 64, replace=False)).cuda()].contiguous()
    for m in (1, 16):
        got, want = tivf._nearest(x, cents, m), tivf._nearest_plain(x, cents, m)
        assert torch.equal(got[0], want[0])
        if m == 1:
            assert torch.equal(got[1], want[1])
    codes = tivf._nearest(x, cents, 1)[0][:, 0]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    valid[::13] = False
    layout = tivf._update_layout(codes, valid, 64)
    assert torch.equal(tivf._update(x, codes, valid, cents), tivf._update_plain(x, *layout, cents))
    _, idx, index = tivf._ivf_knn(x, k, seed=0)
    keys = tivf._search(x, index.members, index.qtable, k, True)
    assert torch.equal(keys, tivf._search_plain(x, index.members, index.qtable, k, True))
    merged = tivf._merge_slots(keys, index.slot_map, k)
    got, want = tivf._refine(x, merged, k, True), tivf._refine_plain(x, merged, k, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
