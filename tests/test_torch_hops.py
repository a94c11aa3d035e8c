"""squidpy_torch's k-hop expansion (``ops/hops.py``, kernel K13) against squidpy_tpu's.

Tolerances. On binary graphs everything is bitwise the JAX package's: the
ring ELLs (index sets, ascending order, padding, bucketed widths), the
degrees, and the visited ELL with its values; every run sum is an exact
integer there. The self-loop quirk of the ``prod > visited`` rule (a node
with two or more 2-cycles re-enters ring 2) is reproduced. On weighted
graphs the port sums a run left to right and the JAX package reads it off
prefix sums, so a ring may differ only where ``run_w`` and ``run_v`` lie
within a few ulps; the weighted fixtures are asserted free of such near
ties (:func:`_assert_margin`), and then both agree bitwise too.

K13 runs only on the card. Its wrapper (``_hop_k13``: the count pass, the
read-back of the maximum degrees and of the rows past the warp's capacity,
the block route's scratch spans, the emit pass) runs here around a numpy
emulation of its C interface that sorts each row's (index << 32 |
position) keys and sums its runs as the kernel does; the cuda-marked test
holds the kernel itself to the plain version on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sps
from scipy.spatial import cKDTree
from test_torch_radius import _view

import squidpy_torch as sqt
from squidpy_torch import _cuda
from squidpy_torch.ops import hops as th
from squidpy_tpu.gr._niche import _hop, _setdiag
from squidpy_tpu.ops import hops as jh

torch.set_num_threads(1)

MARGIN = 1e-5  # weighted fixtures: |prod - visited| above this share of the larger


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def spatial_knn(n: int, k: int, seed: int, weighted: bool = False, diag: bool = False) -> sps.csr_matrix:
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (n, 2))
    _, idx = cKDTree(pts).query(pts, k=k + 1)
    w = rng.uniform(0.5, 2.0, n * k) if weighted else np.ones(n * k)
    A = sps.csr_matrix((w, (np.repeat(np.arange(n), k), idx[:, 1:].ravel())), shape=(n, n))
    A = A.maximum(A.T).tolil()
    A.setdiag(1.0 if diag else 0.0)
    A = A.tocsr()
    A.eliminate_zeros()
    return A


def _assert_same(t_hops, j_hops):
    assert len(t_hops) == len(j_hops)
    for (ti, td), (ji, jd) in zip(t_hops, j_hops):
        ji, jd = np.asarray(ji), np.asarray(jd)
        assert ti.dtype == torch.int32 and td.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), ji)  # sets, order, padding and width
        np.testing.assert_array_equal(td.numpy(), jd)


def _assert_margin(A: sps.csr_matrix, distance: int) -> None:
    """No ring decision of the fixture within ``MARGIN`` of a tie: at every
    stored entry of each hop's product, the path weight and the visited
    value differ by more than ``MARGIN`` of the larger (or are both 0)."""
    adj_hop, vis = _setdiag(A, 0), _setdiag(A.copy(), 1)
    for _ in range(2, distance + 1):
        prod = sps.csr_matrix(adj_hop @ A)
        gap = prod - vis.multiply(prod != 0)
        big = np.maximum(np.abs(prod.data), 1e-300)
        rel = np.abs(sps.csr_matrix(gap)[prod.nonzero()]).A1 / big[np.argsort(np.lexsort(prod.nonzero()[::-1]))]
        assert rel.min() > MARGIN or np.all(rel[rel <= MARGIN] == 0), rel.min()
        adj_hop, vis = _hop(adj_hop, A, vis)


@pytest.mark.parametrize("drop_diag", [False, True])
def test_ell_sentinel_bitwise(drop_diag):
    A = spatial_knn(300, 5, 7, weighted=True, diag=True)
    ti, tw = th.ell_sentinel(A, drop_diag=drop_diag)
    ji, jw = jh.ell_sentinel(A, drop_diag=drop_diag)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize(("n", "k", "seed"), [(400, 4, 0), (500, 6, 1)])
@pytest.mark.parametrize("fn", ["hop_rings", "hop_reach"])
def test_hops_binary_bitwise(fn, n, k, seed):
    bi, bw = th.ell_sentinel(spatial_knn(n, k, seed))
    _assert_same(getattr(th, fn)(bi, bw, 3), getattr(jh, fn)(bi, bw, 3))


@pytest.mark.parametrize("fn", ["hop_rings", "hop_reach"])
def test_hops_with_diagonal_and_isolated_nodes(fn):
    A = spatial_knn(300, 4, 3, diag=True).tolil()
    A[17, :] = 0
    A[:, 17] = 0  # an isolated node
    bi, bw = th.ell_sentinel(A.tocsr())
    _assert_same(getattr(th, fn)(bi, bw, 2), getattr(jh, fn)(bi, bw, 2))


def test_self_loop_quirk():
    A = sps.csr_matrix(np.array([[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 1], [0, 0, 1, 0]], dtype=float))
    bi, bw = th.ell_sentinel(A)
    (idx, _), = th.hop_rings(bi, bw, 2)
    _assert_same(th.hop_rings(bi, bw, 2), jh.hop_rings(bi, bw, 2))
    assert 0 in set(idx[0][idx[0] < 4].tolist())  # the self loop survived


def _ring1(bi, bw, n):
    self_idx = np.arange(n, dtype=np.int32)[:, None]
    r1 = np.where(bi == self_idx, n, bi).astype(np.int32)
    off = np.where(bi == self_idx, n, bi)
    vis_idx = np.concatenate([self_idx, off], axis=1).astype(np.int32)
    vis_val = np.concatenate([np.ones((n, 1), np.float32), np.where(off < n, bw, 0.0)], axis=1).astype(np.float32)
    return r1, np.where(r1 < n, bw, 0.0).astype(np.float32), vis_idx, vis_val


@pytest.mark.parametrize("weighted", [False, True])
def test_one_hop_with_visited_bitwise(weighted):
    """One hop against the JAX package's ``_emit_pass``: the ring, its
    degrees, and the visited ELL with its values."""
    n = 300
    A = spatial_knn(n, 5, 2, weighted=weighted)
    if weighted:
        _assert_margin(A, 2)
    bi, bw = th.ell_sentinel(A)
    r1, r1w, vi, vv = _ring1(bi, bw, n)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    r_idx, r_deg, v_idx, v_val, v_deg = th.hop_expand(t(bi), t(bw), t(r1), t(r1w), t(vi), t(vv))
    jargs = tuple(jnp.asarray(a) for a in (bi, bw, r1, r1w, vi, vv))
    rd, vd = jh._deg_pass(*jargs, n=n, chunk=n, use_visited=True)
    w_out, v_out = jh._bucket(int(jnp.max(rd))), jh._bucket(int(jnp.max(vd)))
    jr, jrd, jvi, jvv = jh._emit_pass(*jargs, n=n, chunk=n, w_out=w_out, v_out=v_out, use_visited=True)
    np.testing.assert_array_equal(r_idx.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(r_deg.numpy(), np.asarray(jrd))
    np.testing.assert_array_equal(v_idx.numpy(), np.asarray(jvi))
    np.testing.assert_array_equal(v_deg.numpy(), np.asarray(vd))
    if not weighted:
        np.testing.assert_array_equal(v_val.numpy(), np.asarray(jvv))
        return
    # the JAX package reads a visited value off prefix sums of the row's
    # sorted elements: within a few ulps of the row's total, where the port
    # keeps the value itself
    live = r1 < n
    total = (r1w.astype(np.float64) * np.where(live, bw.sum(axis=1)[np.minimum(r1, n - 1)], 0.0)).sum(axis=1)
    total += vv.astype(np.float64).sum(axis=1)
    bound = 4 * np.finfo(np.float32).eps * total[:, None]
    assert np.all(np.abs(v_val.numpy().astype(np.float64) - np.asarray(jvv, dtype=np.float64)) <= bound)


@pytest.mark.parametrize("seed", [0, 1])
def test_hop_rings_weighted_with_margins(seed):
    A = spatial_knn(400, 4, seed, weighted=True)
    _assert_margin(A, 3)
    bi, bw = th.ell_sentinel(A)
    _assert_same(th.hop_rings(bi, bw, 3), jh.hop_rings(bi, bw, 3))


def test_hop_reach_weighted_matches_matrix_powers():
    A = spatial_knn(400, 4, 4, weighted=True)
    bi, bw = th.ell_sentinel(A)
    hop = A.copy()
    for idx, deg in th.hop_reach(bi, bw, 3):
        hop = sps.csr_matrix(hop @ A)
        hop.sort_indices()
        np.testing.assert_array_equal(deg.numpy(), np.diff(hop.indptr))
        for i in range(0, 400, 7):
            row = idx[i][: int(deg[i])].numpy()
            np.testing.assert_array_equal(row, hop.indices[hop.indptr[i] : hop.indptr[i + 1]])


def test_hop_expand_rejects_half_a_visited_ell():
    z = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="come together"):
        th.hop_expand(z, z.float(), z, z.float(), z, None)


# -- K13's wrapper around an emulation of its C interface -------------------

class _EmulatedK13:
    """``sqt_hops_rows`` and ``sqt_hops_overflow`` in numpy, on the CPU
    tensors the wrapper passes: each row's elements as (index << 32 |
    position) keys, sorted, each run summed left to right in float32 from
    0, the rows past ``cap`` listed in a shuffled order (as atomics leave
    them) with their degrees left 0."""

    def __init__(self, seed: int = 0) -> None:
        self.calls: list[str] = []
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _graph(args):
        bi, bw, n, k1, ri, rw, R, vi, vv, V = args
        g = {"n": n, "k1": k1, "R": R, "V": V, "bi": _view(bi, np.int32, n * k1).reshape(n, k1),
             "bw": _view(bw, np.float32, n * k1).reshape(n, k1), "ri": _view(ri, np.int32, n * R).reshape(n, R),
             "rw": _view(rw, np.float32, n * R).reshape(n, R)}
        if V:
            g["vi"] = _view(vi, np.int32, n * V).reshape(n, V)
            g["vv"] = _view(vv, np.float32, n * V).reshape(n, V)
        return g

    @staticmethod
    def _row(g, row):
        n, k1, R = g["n"], g["k1"], g["R"]
        keys, vals = [], []
        for r in range(R):
            rr = g["ri"][row, r]
            if rr >= n:
                continue
            for j in range(k1):
                b = g["bi"][rr, j]
                if b < n:
                    keys.append((int(b) << 32) | (r * k1 + j))
                    vals.append(np.float32(g["rw"][row, r]) * np.float32(g["bw"][rr, j]))
        for v in range(g["V"]):
            if g["vi"][row, v] < n:
                keys.append((int(g["vi"][row, v]) << 32) | (R * k1 + v))
                vals.append(np.float32(g["vv"][row, v]))
        order = np.argsort(np.asarray(keys, dtype=np.uint64), kind="stable")
        keys = [keys[i] for i in order]
        vals = [vals[i] for i in order]
        ring, vis = [], []
        p = 0
        while p < len(keys):
            idx, run_w, run_v = keys[p] >> 32, np.float32(0), np.float32(0)
            while p < len(keys) and keys[p] >> 32 == idx:
                visited = (keys[p] & 0xFFFFFFFF) >= R * k1
                run_w = np.float32(run_w + (np.float32(0) if visited else vals[p]))
                run_v = np.float32(run_v + (vals[p] if visited else np.float32(0)))
                p += 1
            keep = run_w > run_v
            ring.append(idx) if keep else None
            if run_v > 0 or keep:
                vis.append((idx, np.float32(run_v + np.float32(1.0 if keep else 0.0))))
        return len(keys), ring, vis

    def _write(self, g, row, ring, vis, mode, r_deg, v_deg, outs):
        w_out, v_out, r_out, v_out_idx, v_out_val = outs
        n = g["n"]
        if mode == 0:
            _view(r_deg, np.int32, n)[row] = len(ring)
            _view(v_deg, np.int32, n)[row] = len(vis) if g["V"] else 0
            return
        ro = _view(r_out, np.int32, n * w_out).reshape(n, w_out)
        ro[row] = n
        ro[row, : len(ring)] = ring
        if g["V"]:
            vo = _view(v_out_idx, np.int32, n * v_out).reshape(n, v_out)
            vl = _view(v_out_val, np.float32, n * v_out).reshape(n, v_out)
            vo[row], vl[row] = n, 0.0
            vo[row, : len(vis)] = [i for i, _ in vis]
            vl[row, : len(vis)] = [v for _, v in vis]

    def sqt_hops_rows(self, mode, *rest):
        self.calls.append(f"rows{mode}")
        graph, cap, r_deg, v_deg, over_rows, over_cnt, n_over, outs = (rest[:10], rest[10], rest[11], rest[12],
                                                                       rest[13], rest[14], rest[15], rest[16:21])
        g = self._graph(graph)
        listed = []
        for row in self.rng.permutation(g["n"]):
            cnt, ring, vis = self._row(g, row)
            if cnt > cap:
                listed.append((row, cnt))
                continue
            self._write(g, row, ring, vis, mode, r_deg, v_deg, outs)
        if mode == 0:
            for row, cnt in listed:
                _view(r_deg, np.int32, g["n"])[row] = 0
                _view(v_deg, np.int32, g["n"])[row] = 0
                slot = _view(n_over, np.int32, 1)[0]
                _view(over_rows, np.int32, g["n"])[slot], _view(over_cnt, np.int32, g["n"])[slot] = row, cnt
                _view(n_over, np.int32, 1)[0] += 1
        return 0

    def sqt_hops_overflow(self, mode, *rest):
        self.calls.append(f"overflow{mode}")
        graph, (over_rows, over_cnt, offsets, n_listed, keys, vals), (r_deg, v_deg), outs = (
            rest[:10], rest[10:16], rest[16:18], rest[18:23])
        g = self._graph(graph)
        rows, cnts = _view(over_rows, np.int32, n_listed), _view(over_cnt, np.int32, n_listed)
        starts = _view(offsets, np.int64, n_listed)
        spans = np.diff(starts)  # each listed row's scratch: the next power of two at or above its count
        assert starts[0] == 0 and np.array_equal(spans, 1 << np.ceil(np.log2(cnts[:-1])).astype(np.int64))
        for i in range(n_listed):
            cnt, ring, vis = self._row(g, rows[i])
            assert cnt == cnts[i]
            self._write(g, rows[i], ring, vis, mode, r_deg, v_deg, outs)
        return 0


@pytest.fixture()
def emulated(monkeypatch):
    emu = _EmulatedK13()
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    return emu


@pytest.mark.parametrize(("weighted", "cap"), [(False, 512), (False, 20), (True, 30), (False, 1)])
@pytest.mark.parametrize("visited", [True, False])
def test_k13_wrapper_emulated(emulated, weighted, cap, visited):
    """The wrapper's two passes, read-backs and block route (rows past
    ``cap``) bitwise against the plain version, over two hops."""
    n = 150
    A = spatial_knn(n, 5, 8, weighted=weighted)
    bi, bw = th.ell_sentinel(A)
    r1, r1w, vi, vv = (torch.from_numpy(a) for a in _ring1(bi, bw, n))
    bi, bw = torch.from_numpy(bi), torch.from_numpy(bw)
    args = (bi, bw, r1, r1w, vi if visited else None, vv if visited else None)
    before = _cuda.launches["hops"]
    for _ in range(2):
        got = th._hop_k13(*args, cap=cap)
        want = th._hop_plain(*args)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
        args = (bi, bw, got[0], (got[0] < n).to(torch.float32), got[2], got[3])
    listed = any(c.startswith("overflow") for c in emulated.calls)
    assert listed == (cap < 100)
    assert _cuda.launches["hops"] - before == len(emulated.calls)


def test_k13_rejects_a_capacity_past_shared_memory():
    z = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="warp capacity"):
        th._hop_k13(z, z.float(), z, z.float(), None, None, cap=th._K13_WARP_CAP + 1)


@pytest.mark.cuda
@pytest.mark.parametrize(("weighted", "cap"), [(False, 512), (True, 512), (False, 16)])
def test_k13_matches_plain_on_card(weighted, cap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K13 has no CPU mode")
    n = 20_000
    A = spatial_knn(n, 6, 3, weighted=weighted)
    bi, bw = th.ell_sentinel(A)
    r1, r1w, vi, vv = (torch.from_numpy(a).cuda() for a in _ring1(bi, bw, n))
    bi, bw = torch.from_numpy(bi).cuda(), torch.from_numpy(bw).cuda()
    for visited in (True, False):
        args = (bi, bw, r1, r1w, vi if visited else None, vv if visited else None)
        for _ in range(2):
            got, want = th._hop_k13(*args, cap=cap), th._hop_plain(*args)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)
            args = (bi, bw, got[0], (got[0] < n).to(torch.float32), got[2], got[3])
