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

K13 runs only on the card. Its wrapper (``_hop_k13``: the ELLs padded to
widths of multiples of 4, the key width, the warp route's staging, the
block route over the rows past the warp's capacity, the hop's one
read-back, the copy into the bucketed ELLs, the block route over the late
rows) runs here around a numpy emulation of its C interface that sorts
each row's (index, position) keys, packed into 32 bits where the wrapper
says they fit, and sums its runs as the kernel does. The wrapper's host
reads of tensors (each a read-back on the card) are counted, one a hop.
The cuda-marked test holds the kernel itself to the plain version on the
card.
"""

from __future__ import annotations

import sys

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
    """``sqt_hops_warp``, ``sqt_hops_block`` and ``sqt_hops_place`` in
    numpy, on the CPU tensors the wrapper passes: each row's elements as
    (index << 32 | position) keys, sorted, each run summed left to right in
    float32 from 0; the warp route takes the rows in a shuffled order (as
    atomics leave them) and lists those past ``cap``."""

    def __init__(self, seed: int = 0) -> None:
        self.calls: list[str] = []
        self.rng = np.random.default_rng(seed)
        self.key_bits: list[int] = []
        self.over: list[int] = []
        self.late: list[int] = []
        self.host_reads = 0  # counted by the ``emulated`` fixture

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

    @staticmethod
    def _write(g, row, ring, vis, outs):
        w_out, v_out, r_out, v_out_idx, v_out_val = outs
        n = g["n"]
        ro = _view(r_out, np.int32, n * w_out).reshape(n, w_out)
        ro[row] = n
        ro[row, : len(ring)] = ring
        if g["V"]:
            vo = _view(v_out_idx, np.int32, n * v_out).reshape(n, v_out)
            vl = _view(v_out_val, np.float32, n * v_out).reshape(n, v_out)
            vo[row], vl[row] = n, 0.0
            vo[row, : len(vis)] = [i for i, _ in vis]
            vl[row, : len(vis)] = [v for _, v in vis]

    @staticmethod
    def _push(view_count, view_rows, row):
        slot = view_count[0]
        view_rows[slot] = row
        view_count[0] += 1

    def _stage(self, g, row, ring, vis, stage, r_deg, v_deg, late_rows, n_late):
        """A row's degrees and staged entries, cut at the staging widths; late if it passes them."""
        w_stage, v_stage, r_stage, v_stage_idx, v_stage_val = stage
        n = g["n"]
        _view(r_deg, np.int32, n)[row] = len(ring)
        _view(v_deg, np.int32, n)[row] = len(vis) if g["V"] else 0
        rs = _view(r_stage, np.int32, n * w_stage).reshape(n, w_stage)
        rs[row, : min(len(ring), w_stage)] = ring[:w_stage]
        late = len(ring) > w_stage
        if g["V"]:
            vi = _view(v_stage_idx, np.int32, n * v_stage).reshape(n, v_stage)
            vv = _view(v_stage_val, np.float32, n * v_stage).reshape(n, v_stage)
            vi[row, : min(len(vis), v_stage)] = [i for i, _ in vis][:v_stage]
            vv[row, : min(len(vis), v_stage)] = [v for _, v in vis][:v_stage]
            late |= len(vis) > v_stage
        if late:
            self._push(_view(n_late, np.int32, 1), _view(late_rows, np.int32, n), row)

    def sqt_hops_warp(self, base_idx, base_w, base_deg, *args):
        graph, (key_bits, pbits, cap), stage = (base_idx, base_w, *args[:8]), args[8:11], args[11:16]
        r_deg, v_deg, over_rows, n_over, late_rows, n_late = args[16:22]
        self.calls.append(f"warp{key_bits}")
        g = self._graph(graph)
        assert np.array_equal(_view(base_deg, np.int32, g["n"]), (g["bi"] < g["n"]).sum(axis=1))
        assert g["k1"] % 4 == 0 and g["V"] % 4 == 0
        positions = g["R"] * g["k1"] + g["V"]
        if key_bits == 32:  # every packed key and the pad word's key part fit, in order
            assert positions <= 1 << pbits and (g["n"] + 1) << pbits < 2**32 and cap <= th._K13_WARP_CAP
        else:
            assert cap <= th._K13_WARP_CAP_64
        self.key_bits.append(key_bits)
        for row in self.rng.permutation(g["n"]):
            cnt, ring, vis = self._row(g, row)
            if cnt > cap:
                self._push(_view(n_over, np.int32, 1), _view(over_rows, np.int32, g["n"]), row)
                continue
            self._stage(g, row, ring, vis, stage, r_deg, v_deg, late_rows, n_late)
        self.over.append(int(_view(n_over, np.int32, 1)[0]))
        return 0

    def sqt_hops_block(self, mode, *args):
        graph, (rows, n_rows, blocks, span, keys, vals), stage = args[:10], args[10:16], args[16:21]
        (r_deg, v_deg, late_rows, n_late), outs = args[21:25], args[25:30]
        self.calls.append(f"block{mode}")
        g = self._graph(graph)
        assert blocks >= 1 and span >= g["R"] * g["k1"] + g["V"] and span & (span - 1) == 0
        count = int(_view(n_rows, np.int32, 1)[0])
        if mode == 1:
            self.late.append(count)
        for row in _view(rows, np.int32, g["n"])[:count].copy():
            _, ring, vis = self._row(g, row)
            if mode == 0:
                self._stage(g, row, ring, vis, stage, r_deg, v_deg, late_rows, n_late)
            else:
                self._write(g, row, ring, vis, outs)
        return 0

    def sqt_hops_place(self, n, V, w_stage, v_stage, r_stage, v_stage_idx, v_stage_val, r_deg, v_deg, w_out, v_out,
                       r_out, v_out_idx, v_out_val, stream):
        self.calls.append("place")
        slot = np.arange(w_out)[None, :]
        d = np.minimum(_view(r_deg, np.int32, n), w_stage)[:, None]
        rs = _view(r_stage, np.int32, n * w_stage).reshape(n, w_stage)
        ro = _view(r_out, np.int32, n * w_out).reshape(n, w_out)
        ro[:] = np.where(slot < d, rs[:, np.minimum(slot[0], w_stage - 1)], n)
        if V:
            slot = np.arange(v_out)[None, :]
            d = np.minimum(_view(v_deg, np.int32, n), v_stage)[:, None]
            take = np.minimum(slot[0], v_stage - 1)
            vi = _view(v_stage_idx, np.int32, n * v_stage).reshape(n, v_stage)[:, take]
            vv = _view(v_stage_val, np.float32, n * v_stage).reshape(n, v_stage)[:, take]
            _view(v_out_idx, np.int32, n * v_out).reshape(n, v_out)[:] = np.where(slot < d, vi, n)
            _view(v_out_val, np.float32, n * v_out).reshape(n, v_out)[:] = np.where(slot < d, vv, 0.0)
        return 0


_HOST_READS = ("tolist", "item", "cpu", "numpy", "__int__", "__float__", "__bool__", "__index__")


@pytest.fixture()
def emulated(monkeypatch):
    """The emulation in place of K13's library; ``emu.host_reads`` counts the
    calls of :data:`_HOST_READS` on tensors made from ``ops/hops.py``."""
    emu = _EmulatedK13()
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setitem(_cuda.launches, "hops", 0)

    def counted(real):
        def read(self, *args, **kwargs):
            if sys._getframe(1).f_code.co_filename == th.__file__:
                emu.host_reads += 1
            return real(self, *args, **kwargs)
        return read

    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, counted(getattr(torch.Tensor, name)))
    return emu


def _two_hops(emulated, n, weighted, visited, **kw):
    """Two hops of K13's wrapper from ring 1, each bitwise against the plain
    version and each with one host read."""
    A = spatial_knn(n, 5, 8, weighted=weighted)
    bi, bw = th.ell_sentinel(A)
    r1, r1w, vi, vv = (torch.from_numpy(a) for a in _ring1(bi, bw, n))
    bi, bw = torch.from_numpy(bi), torch.from_numpy(bw)
    args = (bi, bw, r1, r1w, vi if visited else None, vv if visited else None)
    before = _cuda.launches["hops"]
    for _ in range(2):
        reads = emulated.host_reads
        got = th._hop_k13(*args, **kw)
        assert emulated.host_reads - reads == 1
        want = th._hop_plain(*args)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
        args = (bi, bw, got[0], (got[0] < n).to(torch.float32), got[2], got[3])
    assert _cuda.launches["hops"] - before == len(emulated.calls)


@pytest.mark.parametrize(("weighted", "cap"), [(False, 512), (False, 20), (True, 30), (False, 1)])
@pytest.mark.parametrize("visited", [True, False])
def test_k13_wrapper_emulated(emulated, weighted, cap, visited):
    """The wrapper's single pass: packed 32-bit keys, the block route over
    the rows past ``cap``, the hop's one read-back, the placement; bitwise
    against the plain version over two hops."""
    _two_hops(emulated, 150, weighted, visited, cap=cap)
    assert emulated.key_bits == [32, 32]
    assert (max(emulated.over) > 0) == (cap < 100)
    assert emulated.calls.count("place") == 2 and emulated.calls.count("block0") == 2


@pytest.mark.parametrize(("key_bits", "cap", "stage_width"), [(64, 512, None), (64, 25, 3), (32, 1024, 1),
                                                              (32, 40, 6), (None, 1, 2)])
@pytest.mark.parametrize("visited", [True, False])
def test_k13_wrapper_keys_and_late_rows(emulated, key_bits, cap, stage_width, visited):
    """The 64-bit key branch (forced), and rows past the staging widths
    (lowered), placed by the block route after the hop's read-back, from
    both routes; bitwise over two hops."""
    _two_hops(emulated, 150, True, visited, cap=cap, key_bits=key_bits, stage_width=stage_width)
    assert emulated.key_bits == [key_bits or 32] * 2
    if stage_width is not None:
        assert max(emulated.late) > 0 and emulated.calls.count("block1") >= 1
    else:
        assert "block1" not in emulated.calls


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("visited", [True, False])
def test_k13_host_reads_counted(emulated, with_stats, visited):
    """The count of host reads sees each one: a hop reads back once, and
    once more for ``stats``' listed rows."""
    n = 120
    bi, bw = th.ell_sentinel(spatial_knn(n, 5, 3))
    r1, r1w, vi, vv = (torch.from_numpy(a) for a in _ring1(bi, bw, n))
    bi, bw = torch.from_numpy(bi), torch.from_numpy(bw)
    th._hop_k13(bi, bw, r1, r1w, vi if visited else None, vv if visited else None, cap=8,
                stats={} if with_stats else None)
    assert emulated.host_reads == 1 + with_stats and max(emulated.over) > 0


def test_k13_stats_and_widths(emulated):
    """One read-back a hop, one more for the stats; the staging width from
    the input widths; the ELLs padded to multiples of 4 (a visited ELL of
    width 9)."""
    n = 120
    bi, bw = th.ell_sentinel(spatial_knn(n, 5, 3))
    r1, r1w, vi, vv = (torch.from_numpy(a) for a in _ring1(bi, bw, n))
    bi, bw = torch.from_numpy(bi), torch.from_numpy(bw)
    stats = {}
    got = th._hop_k13(bi, bw, r1, r1w, vi[:, :9].contiguous(), vv[:, :9].contiguous(), stats=stats)
    assert emulated.host_reads == 2
    want = th._hop_plain(bi, bw, r1, r1w, vi[:, :9].contiguous(), vv[:, :9].contiguous())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert stats["key_bits"] == 32 and stats["late_rows"] == 0
    assert stats["w_stage"] == th._k13_stage_width(r1.shape[1], bi.shape[1])
    assert stats["v_stage"] == 12 + stats["w_stage"]
    assert th._k13_stage_width(8, 8) == 32 and th._k13_stage_width(24, 8) == 96 and th._k13_stage_width(2, 4) == 8


@pytest.mark.parametrize(("n", "positions", "want"), [(1000, 1, (1, 32)), (200_000, 432, (9, 32)),
                                                      (1_000_000, 432, (9, 32)), (2**22, 1024, (10, 64)),
                                                      (2**22 - 2, 1024, (10, 32)), (2**21, 1025, (11, 64))])
def test_k13_key_width(n, positions, want):
    assert th._k13_keys(n, positions) == want


def test_k13_rejects_a_capacity_past_shared_memory():
    z = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="warp capacity"):
        th._hop_k13(z, z.float(), z, z.float(), None, None, cap=th._K13_WARP_CAP + 1)
    with pytest.raises(ValueError, match="warp capacity"):
        th._hop_k13(z, z.float(), z, z.float(), None, None, cap=th._K13_WARP_CAP_64 + 1, key_bits=64)


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
