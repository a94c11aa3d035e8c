"""squidpy_torch binned sweep against squidpy_tpu's (``ops/pairbins.py``, K1).

Tolerance: bitwise. The planner is a verbatim numpy copy, so every plan
array must be equal. The plain binned engine (K1's CPU version) must equal
both JAX engines on the fixtures of ``tests/test_pallas_binned.py``: the XLA
engine, and the Pallas kernel in interpret mode. All three compute the
difference-form f32 d2; the port rounds once per multiply and add, while
XLA on the CPU fuses one product into an FMA. Should a pair's two d2
straddle a threshold and split them, the failure message names the pair and
both d2 values (tests/test_torch_cooccur.py holds one such pair).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import squidpy_torch as sqt
from squidpy_torch.ops import binned_kernel as tbk
from squidpy_torch.ops import pairbins as tpb
from squidpy_tpu.ops import pairbins as jpb
from squidpy_tpu.ops.pallas_binned import binned_pair_counts_pallas
from squidpy_tpu.parallel.sharded import auto_binned_pair_counts

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _fixture(n=2000, seed=5, n_blobs=6, n_cls=5, dim=2):
    """Clustered blobs, as in tests/test_pallas_binned.py."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 100, size=(n_blobs, dim))
    pts = (centers[rng.integers(0, n_blobs, n)] + rng.normal(0, 3, (n, dim))).astype(np.float32)
    labs = rng.integers(0, n_cls, n).astype(np.int32)
    return pts, labs


def _sorted_plan(pts, labs, thr, n_cls, tile, gsize, pair_enum="auto"):
    perm = tpb.morton_argsort(pts)
    pts_s, labs_s = np.ascontiguousarray(pts[perm]), np.ascontiguousarray(labs[perm])
    plan = tpb.plan_binned_pairs(pts_s, labs_s, thr, n_cls, tile=tile, gsize=gsize, pair_enum=pair_enum)
    return pts_s, labs_s, plan


def _knife_edges(pts: np.ndarray, thr: np.ndarray) -> str:
    """Name the pairs whose f32 d2, rounded per operation (the port) and as
    XLA:CPU contracts it, fma(dx, dx, dy*dy), straddle a threshold."""
    p = np.asarray(pts, np.float32)
    t = np.asarray(thr, np.float32)
    i, j = np.triu_indices(len(p), 1)
    diff = p[i] - p[j]
    sep = diff[:, 0] * diff[:, 0]
    for d in range(1, p.shape[1]):
        sep = sep + diff[:, d] * diff[:, d]
    fused = (diff[:, 0].astype(np.float64) ** 2 + (sep - diff[:, 0] * diff[:, 0]).astype(np.float64)).astype(np.float32)
    hit = np.flatnonzero(np.searchsorted(t, sep) != np.searchsorted(t, fused))
    pairs = [f"({i[h]}, {j[h]}) d2_port={sep[h]!r} d2_contracted={fused[h]!r}" for h in hit[:10]]
    return "counts differ; knife-edge pairs: " + ("; ".join(pairs) or "none")


CASES = [  # (fixture kwargs, thresholds, n_cls, tile, gsize)
    pytest.param({}, np.linspace(0.5, 80.0, 17), 5, 64, 4, id="tile64-gsize4"),
    pytest.param({}, np.linspace(0.5, 80.0, 17), 5, 128, 8, id="tile128-gsize8"),
    pytest.param({"n": 800}, np.linspace(1.0, 60.0, 7), 1, 64, 4, id="single-class"),
    pytest.param({"n": 1500, "n_blobs": 3}, np.linspace(0.2, 20.0, 23), 4, 64, 8, id="tight-blobs"),
]


@pytest.mark.parametrize("pair_enum", ["triu", "tree"])
@pytest.mark.parametrize("kw,thr,n_cls,tile,gsize", CASES)
def test_plan_matches_jax(kw, thr, n_cls, tile, gsize, pair_enum):
    pts, labs = _fixture(**kw)
    thr = (thr**2).astype(np.float32)
    perm = tpb.morton_argsort(pts)
    np.testing.assert_array_equal(perm, jpb.morton_argsort(pts))
    got = tpb.plan_binned_pairs(pts[perm], labs[perm], thr, n_cls, tile=tile, gsize=gsize, pair_enum=pair_enum)
    want = jpb.plan_binned_pairs(pts[perm], labs[perm], thr, n_cls, tile=tile, gsize=gsize, pair_enum=pair_enum)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert type(g) is type(w), f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_morton_argsort_3d_matches_jax():
    pts, _ = _fixture(dim=3)
    np.testing.assert_array_equal(tpb.morton_argsort(pts), jpb.morton_argsort(pts))


@pytest.mark.parametrize("kw,thr,n_cls,tile,gsize", CASES)
def test_plain_engine_matches_both_jax_engines(kw, thr, n_cls, tile, gsize):
    pts, labs = _fixture(**kw)
    thr = (thr**2).astype(np.float32)
    pts_s, labs_s, plan = _sorted_plan(pts, labs, thr, n_cls, tile, gsize)
    got = tbk.binned_pair_counts(pts_s, labs_s, plan, n_cls, device=torch.device("cpu")).numpy()
    assert got.dtype == np.int64 and got.shape == (len(thr), n_cls, n_cls)
    xla = jpb._combine_binned(auto_binned_pair_counts(pts_s, labs_s, plan, n_cls), plan, len(thr), n_cls)
    xla -= plan.full_cum
    pallas = binned_pair_counts_pallas(pts_s, labs_s, plan, n_cls, interpret=True)
    if not (np.array_equal(got, xla) and np.array_equal(got, pallas)):
        pytest.fail(_knife_edges(pts_s, thr))


def test_plain_engine_matches_xla_engine_3d():
    pts, labs = _fixture(n=1200, dim=3)
    thr = (np.linspace(0.5, 60.0, 13) ** 2).astype(np.float32)
    pts_s, labs_s, plan = _sorted_plan(pts, labs, thr, 5, 64, 4)
    got = tbk.binned_pair_counts(pts_s, labs_s, plan, 5, device=torch.device("cpu")).numpy()
    want = jpb._combine_binned(auto_binned_pair_counts(pts_s, labs_s, plan, 5), plan, len(thr), 5) - plan.full_cum
    if not np.array_equal(got, want):
        pytest.fail(_knife_edges(pts_s, thr))


@pytest.mark.parametrize("kw,thr,n_cls,tile,gsize", CASES[:2])
def test_binned_counts_match_jax_binned_counts(kw, thr, n_cls, tile, gsize):
    pts, labs = _fixture(**kw)
    thr = (thr**2).astype(np.float32)
    got = tpb.binned_cooccur_counts(pts, labs, thr, n_cls, tile=tile, gsize=gsize)
    want = jpb.binned_cooccur_counts(pts, labs, thr, n_cls, tile=tile, gsize=gsize, engine="xla")
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pair_enum", ["triu", "tree"])
@pytest.mark.parametrize("kw,thr,n_cls,tile,gsize", CASES)
def test_segments_are_the_plans_distinct_tile_pairs(kw, thr, n_cls, tile, gsize, pair_enum):
    """K1 runs one block per distinct tile pair: the segments derived from the
    items are the plan's distinct (ti, tj) with window [rempty, min(rfull, L))."""
    pts, labs = _fixture(**kw)
    thr = (thr**2).astype(np.float32)
    _, _, plan = _sorted_plan(pts, labs, thr, n_cls, tile, gsize, pair_enum)
    m = plan.n_items
    pairs = np.stack([plan.ti[:m], plan.tj[:m], plan.rempty[:m], np.minimum(plan.rfull[:m], len(thr))]).astype(np.int64)
    want = np.unique(pairs, axis=1)  # (ti, tj) are unique per pair, so this sorts by (ti, tj)
    assert len(np.unique(want[:2], axis=1).T) == want.shape[1] < m
    items = torch.from_numpy(np.stack([plan.ti, plan.tj, plan.rfull, plan.rempty, plan.gid]).astype(np.int32))
    got = tbk.segments(items, len(thr), gsize)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _difference_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a[:, None, 0] - b[None, :, 0]
    d2 = diff * diff
    for d in range(1, a.shape[1]):
        diff = a[:, None, d] - b[None, :, d]
        d2 = d2 + diff * diff
    return d2


@pytest.mark.parametrize("case", ["tile64", "tile128", "tight-blobs", "3d"])
def test_chunk_culling_never_drops_a_pair_in_reach(case):
    """K1's culling predicate (plain torch version) keeps every 32 x 32 chunk
    pair that holds a pair i < j of real points whose float32 difference-form
    d2 lies within the window's last threshold; it must also cull some."""
    if case == "3d":
        pts, labs = _fixture(n=1200, dim=3)
        thr, tile, gsize = np.linspace(0.5, 60.0, 13), 128, 4
    elif case == "tight-blobs":
        pts, labs = _fixture(n=1500, n_blobs=3)
        thr, tile, gsize = np.linspace(0.2, 20.0, 23), 64, 8
    else:
        pts, labs = _fixture()
        thr, tile, gsize = np.linspace(0.5, 80.0, 17), int(case[4:]), 8
    thr = (thr**2).astype(np.float32)
    pts_s, labs_s, plan = _sorted_plan(pts, labs, thr, 5, tile, gsize)
    coords_p, _, items, thr_t, n_thr = tbk.binned_inputs(pts_s, labs_s, plan, torch.device("cpu"))
    seg = tbk.segments(items, n_thr, gsize)
    kept = tbk.chunk_pairs_kept(coords_p, plan.n, seg, thr_t, plan.tile)
    m = -(-plan.tile // 32)
    assert kept.shape == (seg.shape[1], m, m)
    assert not bool(kept.all())
    for s_idx, (ti, tj, lo, hi) in enumerate(seg.T.tolist()):
        gi = torch.arange(ti * plan.tile, (ti + 1) * plan.tile)
        gj = torch.arange(tj * plan.tile, (tj + 1) * plan.tile)
        d2 = _difference_d2(coords_p[gi], coords_p[gj])
        live = (d2 <= thr_t[hi - 1]) & (gi[:, None] < gj[None, :]) & (gj[None, :] < plan.n)
        pad = m * 32 - plan.tile
        live = torch.nn.functional.pad(live, (0, pad, 0, pad)).view(m, 32, m, 32).any(dim=3).any(dim=1)
        assert not bool((live & ~kept[s_idx]).any()), (ti, tj)


@pytest.mark.parametrize("tile,dim,n_thr,n_cls,rows", [
    (1024, 2, 49, 16, 49),  # the main path: every threshold of a window has its row
    (1024, 2, 49, 40, 26),  # top rows of a window, the rest through the overflow row
    (512, 2, 49, 96, 4),
    (512, 2, 49, 154, 1),
    (512, 2, 49, 155, 0),  # not two rows: global atomics only
    (128, 3, 21, 5, 21),
])
def test_k1_shared_histogram_rows(tile, dim, n_thr, n_cls, rows):
    """K1 keeps as many shared (C, C) rows as fit its budget beside the staged
    tiles and one overflow row, at most one per threshold."""
    base, got = tbk._k1_layout(tile, dim, n_thr, n_cls)
    assert got == rows
    assert base + (rows + 1) * n_cls * n_cls * 4 <= tbk._K1_SMEM_BYTES or rows == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    # all rows shared (C=5), top rows and the overflow row (C=120 at tile 128:
    # 2 of 21 rows), global atomics only (C=240)
    for dim, n_cls in ((2, 5), (3, 5), (2, 120), (2, 240)):
        pts, labs = _fixture(n=3000, dim=dim, n_cls=n_cls)
        thr = (np.linspace(0.5, 50.0, 21) ** 2).astype(np.float32)
        pts_s, labs_s, plan = _sorted_plan(pts, labs, thr, n_cls, 128, 8)
        args = tbk.binned_inputs(pts_s, labs_s, plan, torch.device("cuda"))
        call = (args[0], args[1], plan.n, args[2], args[3], args[4], plan.tile, plan.gsize, n_cls)
        assert torch.equal(tbk.binned_pairs(*call), tbk._binned_plain(*call))


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
