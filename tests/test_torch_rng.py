"""squidpy_torch keys against jax.random (``_core/rng.py``).

Tolerance: bitwise. The port computes JAX's threefry keys on the host in
numpy and the sort words on the device (K10, or its plain torch version on
the CPU), so every word must be equal.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from squidpy_torch import _cuda
from squidpy_torch._core import rng as trng
from squidpy_tpu._core import rng as jrng

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_spawn_keys_match_jax(seed, n):
    want = np.asarray(jrng.spawn_keys(seed, n))
    got = trng.spawn_keys(seed, n)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (8,), (3, 4), (1000,)])
def test_random_bits_match_jax(shape):
    keys = trng.spawn_keys(5, 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(jnp.asarray(keys)))
    got = trng.random_bits(keys, shape)
    assert got.shape == (4, *shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trng.random_bits(keys[1], shape), want[1])


def test_seed_none_draws_from_seed_sequence(monkeypatch):
    class FixedEntropy:
        entropy = 98765432123456789

    monkeypatch.setattr(np.random, "SeedSequence", FixedEntropy)
    np.testing.assert_array_equal(trng.spawn_keys(None, 9), np.asarray(jrng.spawn_keys(None, 9)))


def test_seed_none_differs_between_calls():
    assert not np.array_equal(trng.spawn_keys(None, 4), trng.spawn_keys(None, 4))


def test_threefry_known_answer():
    # Random123's published threefry2x32_20 vector for key = counter = 0
    x1, x2 = trng.threefry2x32(0, 0, 0, 0)
    assert (int(x1[0]), int(x2[0])) == (0x6B200159, 0x99BA4EFE)


def test_permutation_columns_multisets_and_jax_columns():
    rng = np.random.default_rng(0)
    n, P = 3000, 6
    labels = rng.integers(0, 5, n).astype(np.int32)
    keys = trng.spawn_keys(11, P)
    got = trng.permutation_columns(keys, torch.from_numpy(labels)).numpy()
    want = np.asarray(jrng.permutation_columns(jnp.asarray(keys), jnp.asarray(labels)))
    assert got.shape == (n, P)
    words = trng.random_bits(keys, (n,))
    for p in range(P):
        np.testing.assert_array_equal(np.bincount(got[:, p], minlength=5), np.bincount(labels, minlength=5))
        # without tied sort words the stable sort is the JAX sort exactly
        if len(np.unique(words[p])) == n:
            np.testing.assert_array_equal(got[:, p], want[:, p])


def test_permutation_columns_bitwise_with_tied_words():
    """At 65,000 values, just below the 65,536 where nhood_enrichment turns
    to the cipher, a column holds two equal sort words with probability
    ~0.39 (7 of these 24). JAX's ``lax.sort_key_val`` is stable, as the port's sort is, so
    every column is bitwise JAX's, the tied ones included: the values are
    distinct, so a tie taken in the other order would show."""
    n, P = 65_000, 24
    values = np.random.default_rng(1).permutation(n).astype(np.int32)
    keys = trng.spawn_keys(23, P)
    words = trng.random_bits(keys, (n,))
    tied = [p for p in range(P) if len(np.unique(words[p])) < n]
    assert len(tied) > 0
    got = trng.permutation_columns(keys, torch.from_numpy(values)).numpy()
    want = np.asarray(jrng.permutation_columns(jnp.asarray(keys), jnp.asarray(values)))
    np.testing.assert_array_equal(got, want)


_DEVICE_N = [1, 1625, 1626, 65_537]


@pytest.mark.parametrize("n", _DEVICE_N)
def test_device_words_match_random_bits_and_jax(n):
    """K10's plain version: the words of ``random_bits`` and of
    ``jax.random.bits``, bitwise, at the sizes where JAX's shuffle goes from
    one round to two (1626) and past 2^16."""
    keys = trng.spawn_keys(n % 97, 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jnp.asarray(keys)))
    np.testing.assert_array_equal(trng.random_bits(keys, (n,)), want)
    got = trng.random_bits_device(keys, n, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.shape == (6, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", _DEVICE_N)
def test_sort_keys_order_as_unsigned_words(n):
    """The flipped words sort, signed and stably, as the words sort unsigned,
    ties included (drawn here by forcing equal words)."""
    keys = trng.spawn_keys(3, 4)
    words = trng.random_bits(keys, (n,))
    flipped = trng.random_bits_device(keys, n, torch.device("cpu"), sort_keys=True).numpy()
    np.testing.assert_array_equal(flipped.view(np.uint32), words ^ np.uint32(0x80000000))
    tied_words = words // np.uint32(1 << 28)  # 16 distinct values: many ties
    tied = (tied_words ^ np.uint32(0x80000000)).view(np.int32)
    np.testing.assert_array_equal(np.argsort(tied, axis=1, kind="stable"), np.argsort(tied_words, axis=1, kind="stable"))
    t = torch.sort(torch.from_numpy(tied), dim=1, stable=True).indices.numpy()
    np.testing.assert_array_equal(t, np.argsort(tied_words, axis=1, kind="stable"))


@pytest.mark.parametrize("n", _DEVICE_N)
def test_permutation_batch_matches_jax(n):
    keys = trng.spawn_keys(n % 89, 5)
    want = np.asarray(jrng.permutation_batch(jnp.asarray(keys), jnp.arange(n, dtype=jnp.int32)))
    got = trng.permutation_batch(keys, n, torch.device("cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_permutation_batch_chunks_change_nothing(monkeypatch):
    keys = trng.spawn_keys(2, 9)
    whole = trng.permutation_batch(keys, 3000, torch.device("cpu"))
    monkeypatch.setattr(trng, "_keys_per_chunk", lambda n, device: 2)
    np.testing.assert_array_equal(trng.permutation_batch(keys, 3000, torch.device("cpu")).numpy(), whole.numpy())


def test_threefry_plain_keys_with_the_top_bit():
    """Key words at and above 2^31 (negative as int32) against numpy's threefry."""
    keys = np.array([[0xFFFFFFFF, 0x80000001], [0, 0xDEADBEEF], [0x80000000, 0x7FFFFFFF]], dtype=np.uint32)
    got = trng._threefry_plain(torch.from_numpy(keys.view(np.int32)), 5).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, trng.random_bits(keys, (5,)))


@pytest.mark.cuda
def test_k10_matches_plain_on_card(cuda_card):
    keys = trng.spawn_keys(7, 70_000)
    kt = torch.from_numpy(keys.view(np.int32)).cuda()
    for n, flip in ((1, True), (1626, False), (65_537, True)):
        got = trng.threefry_bits(kt[: 64 if n > 1 else 70_000], n, flip=flip)
        assert torch.equal(got, trng._threefry_plain(kt[: got.shape[0]], n, flip))


@pytest.mark.cuda
def test_k10_shuffle_matches_plain_on_card(cuda_card, monkeypatch):
    """The shuffle kernel against its plain version (words, torch.sort,
    gathers), bitwise: rounds 1-2, payloads, ties, and the overflow path
    (every word equal, capacity lowered)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    labels = torch.from_numpy(np.random.default_rng(0).integers(0, 16, 70_000).astype(np.uint8))
    for n, mask, cap in ((1625, trng._FULL_MASK, None), (1626, trng._FULL_MASK, None), (65_537, trng._FULL_MASK, None),
                         (65_537, 0xFFF00000, None), (20_000, 0, 64), (5000, 0x80000000, 64)):
        if cap is not None:
            monkeypatch.setattr(trng, "_SORT_CAP", cap)
        subs = trng._round_keys(trng.spawn_keys(n, 12), trng._rounds(n))
        for pay in (None, labels[:n]):
            got = trng._shuffle(subs, n, cuda, None if pay is None else pay.cuda(), mask=mask)
            want = trng._shuffle(subs, n, cpu, pay, mask=mask)
            assert torch.equal(got.cpu(), want)


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def test_shuffle_group_columns_not_ported():
    """Once a stub that raised, now ported: one group is a plain column shuffle,
    bitwise ``permutation_columns`` and the JAX package's grouped shuffle."""
    values = np.random.default_rng(8).integers(0, 9, 700).astype(np.int32)
    keys = trng.spawn_keys(5, 6)
    got = trng.shuffle_group_columns(keys, torch.from_numpy(values), np.zeros(700, np.int8)).numpy()
    np.testing.assert_array_equal(got, trng.permutation_columns(keys, torch.from_numpy(values)).numpy())
    want = jrng.shuffle_group_columns(jnp.asarray(keys), jnp.asarray(values), np.zeros(700, np.int8))
    np.testing.assert_array_equal(got, np.asarray(want))


def _groups(sizes, seed, nan=0):
    """Group codes (int8, as pandas gives them) of the given sizes in a
    shuffled order, the first ``nan`` cells set to -1 (a NaN library)."""
    codes = np.repeat(np.arange(len(sizes)), sizes).astype(np.int8)
    np.random.default_rng(seed).shuffle(codes)
    codes[:nan] = -1
    return codes


_GROUPINGS = {
    "one group": [3000],
    "two unequal": [2900, 100],
    "seven with a single cell": [1000, 1, 640, 7, 1200, 52, 100],
    "fifty unequal": list(np.random.default_rng(3).integers(1, 120, 50)),
}


@pytest.mark.parametrize("nan", [0, 17], ids=["no NaN library", "NaN library"])
@pytest.mark.parametrize("grouping", list(_GROUPINGS))
@pytest.mark.parametrize("payload", [jnp.uint8, None], ids=["uint8", "int32"])
def test_shuffle_group_columns_match_jax(grouping, nan, payload):
    """Bitwise the JAX package's (group, word) sort, rows back in their
    original order, for one group, 2 to 50 unequal groups, a group of one
    cell and code -1 (a group of its own, sorted first)."""
    groups = _groups(_GROUPINGS[grouping], seed=len(grouping), nan=nan)
    n = len(groups)
    values = np.random.default_rng(n).integers(0, 200, n).astype(np.int32)
    keys = trng.spawn_keys(n % 31, 7)
    want = np.asarray(jrng.shuffle_group_columns(jnp.asarray(keys), jnp.asarray(values), groups, payload_dtype=payload))
    got = trng.shuffle_group_columns(keys, torch.from_numpy(values), groups,
                                     payload_dtype=torch.uint8 if payload is not None else None).numpy()
    assert got.dtype == want.dtype and got.shape == (n, 7)
    np.testing.assert_array_equal(got, want)
    for lib in np.unique(groups):  # values move only within their group
        rows = groups == lib
        for p in range(7):
            np.testing.assert_array_equal(np.sort(got[rows, p]), np.sort(values[rows].astype(got.dtype)))


def test_shuffle_group_columns_bitwise_with_tied_words():
    """At 65,000 cells in three libraries a column holds two equal words with
    probability ~0.39; the segments' sorts are stable in both packages, so
    every column is bitwise JAX's, the tied ones included (distinct values,
    so a tie taken in the other order would show)."""
    n, P = 65_000, 24
    groups = _groups([30_000, 25_000, 10_000], seed=9)
    values = np.random.default_rng(1).permutation(n).astype(np.int32)
    keys = trng.spawn_keys(23, P)
    words = trng.random_bits(keys, (n,))
    assert any(len(np.unique(words[p])) < n for p in range(P))
    got = trng.shuffle_group_columns(keys, torch.from_numpy(values), groups).numpy()
    want = np.asarray(jrng.shuffle_group_columns(jnp.asarray(keys), jnp.asarray(values), groups))
    np.testing.assert_array_equal(got, want)


def test_group_layout():
    groups = np.array([2, -1, 2, 0, -1, 2], dtype=np.int8)
    lay = trng.group_layout(groups)
    np.testing.assert_array_equal(lay.order, [1, 4, 3, 0, 2, 5])
    np.testing.assert_array_equal(lay.starts, [0, 2, 3, 6])
    empty = trng.group_layout(np.zeros(0, np.int8))
    assert len(empty.order) == 0 and list(empty.starts) == [0]
    with pytest.raises(ValueError, match="one code a value"):
        trng.shuffle_group_columns(trng.spawn_keys(0, 2), torch.zeros(5, dtype=torch.int32), np.zeros(4))


# --- K10's shuffle kernel, its C interface emulated in numpy ---------------------------


def _view(ptr: int | None, dtype: np.dtype, count: int) -> np.ndarray:
    """A writable numpy view of ``count`` items at a tensor's ``data_ptr``."""
    if not count:
        return np.zeros(0, dtype)
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * (count * itemsize)).from_address(ptr), dtype=dtype)


_PAYLOAD = {1: np.uint8, 4: np.uint32, 8: np.uint64}


def _bitonic(a: np.ndarray) -> None:
    """The overflow kernel's network in place: every compare puts the
    smaller key at the lower index, and pairs whose upper index is past the
    end (virtual +inf) are skipped."""
    m = len(a)
    span = 1
    while span < m:
        span <<= 1
    k = 2
    while k <= span:
        j = k >> 1
        while j > 0:
            t = np.arange(span // 2, dtype=np.int64)
            i = 2 * t - (t & (j - 1))  # the lower element of pair t
            p = i ^ (k - 1) if j == k >> 1 else i + j
            keep = p < m
            i, p = i[keep], p[keep]
            x, y = a[i], a[p]
            swap = x > y
            a[i[swap]], a[p[swap]] = y[swap], x[swap]
            j >>= 1
        k <<= 1


class _EmulatedK10:
    """K10's shuffle entry points in numpy, reading and writing CPU tensors
    through the pointers the wrapper passes, as the kernels do: the
    histogram of the words' top bits; the scan (offsets, cursors, the
    overflow list in any order, the largest bucket); the scatter of each
    row's keys ((word << bits) << 32 | i, or i << 8 | the uint8 value in
    its low bits) into its buckets in a shuffled order, as atomics leave
    them; the sort of each bucket up to ``cap`` (a counting
    sort by the next 11 bits, placed in a shuffled order, then each run of 4
    sub-buckets sorted alone, as a thread does) and of each listed bucket by
    the bitonic network; the epilogue writing the previous round's output
    at each sorted position, or in the first round the payload or the
    position."""

    def __init__(self, seed: int = 0) -> None:
        self.calls: list[str] = []
        self.sorted_by: dict[str, int] = {"local": 0, "overflow": 0}
        self.packed = False
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _words(keys, rows, n, mask):
        k = _view(keys, np.uint32, 2 * rows).reshape(rows, 2)
        return trng.random_bits(k, (n,)) & np.uint32(mask)

    def sqt_shuffle_hist(self, keys, rows, n, mask, bits, hist, stats, stream):
        self.calls.append("hist")
        nb = 1 << bits
        w = self._words(keys, rows, n, mask)
        h = _view(hist, np.int32, rows * nb).reshape(rows, nb)
        for r in range(rows):
            h[r] = np.bincount((w[r] >> np.uint32(32 - bits)) if bits else np.zeros(n, np.int64), minlength=nb)
        _view(stats, np.int32, 2)[:] = 0
        return 0

    def sqt_shuffle_scan(self, rows, n, bits, cap, hist, offs, overflow, stats, stream):
        self.calls.append("scan")
        nb = 1 << bits
        h = _view(hist, np.int32, rows * nb).reshape(rows, nb)
        o = _view(offs, np.int32, rows * (nb + 1)).reshape(rows, nb + 1)
        st = _view(stats, np.int32, 2)
        assert np.all(h.sum(axis=1) == n)
        o[:, 0] = 0
        o[:, 1:] = np.cumsum(h, axis=1)
        over = np.flatnonzero(h.ravel() > cap)
        self.rng.shuffle(over)
        _view(overflow, np.int32, rows * nb)[: len(over)] = over
        st[:] = len(over), h.max()
        h[:] = o[:, :-1]
        return 0

    def sqt_shuffle_scatter(self, keys, rows, n, mask, bits, vals, vals_ld, hist, tmp, stream):
        self.calls.append("scatter")
        nb = 1 << bits
        w = self._words(keys, rows, n, mask)
        cur = _view(hist, np.int32, rows * nb).reshape(rows, nb)
        t = _view(tmp, np.uint64, rows * n).reshape(rows, n)
        if vals is not None:
            assert n < 1 << 24
            v = _view(vals, np.uint8, (rows - 1) * vals_ld + n)
        for r in range(rows):
            for i in self.rng.permutation(n):
                b = int(w[r, i]) >> (32 - bits) if bits else 0
                low = (int(i) << 8) | int(v[r * vals_ld + i]) if vals is not None else int(i)
                t[r, cur[r, b]] = (((int(w[r, i]) << bits) & 0xFFFFFFFF) << 32) | low
                cur[r, b] += 1
        self.packed = vals is not None
        return 0

    def sqt_shuffle_sort(self, tmp, offs, overflow, stats, rows, n, bits, cap, prev, prev_ld, payload, payload_bytes,
                         packed, out, out_ld, stream):
        self.calls.append("sort")
        nb = 1 << bits
        t = _view(tmp, np.uint64, rows * n).reshape(rows, n)
        o = _view(offs, np.int32, rows * (nb + 1)).reshape(rows, nb + 1)
        dtype = _PAYLOAD[payload_bytes] if payload_bytes else np.int32
        pv = _view(prev, dtype, rows * prev_ld).reshape(rows, prev_ld) if prev is not None else None
        pay = _view(payload, dtype, n) if payload_bytes else None
        dst = _view(out, dtype, rows * out_ld).reshape(rows, out_ld)
        listed = set(_view(overflow, np.int32, rows * nb)[: _view(stats, np.int32, 2)[0]].tolist())
        for r in range(rows):
            for b in range(nb):
                off, m = o[r, b], o[r, b + 1] - o[r, b]
                seg = t[r, off : off + m]
                if m > cap:
                    assert r * nb + b in listed
                    _bitonic(seg)
                    self.sorted_by["overflow"] += 1
                elif m:
                    sub = (seg >> np.uint64(53)).astype(np.int64)
                    order = self.rng.permutation(m)  # placed in any order within a sub-bucket
                    placed = order[np.argsort(sub[order], kind="stable")]
                    keys = seg[placed]
                    starts = np.searchsorted(np.sort(sub), np.arange(0, 2049, 4))
                    for lo, hi in zip(starts[:-1], starts[1:]):
                        keys[lo:hi] = np.sort(keys[lo:hi])
                    seg[:] = keys
                    self.sorted_by["local"] += 1
                else:
                    continue
                if packed:
                    assert self.packed and pv is None and payload_bytes == 1
                    dst[r, off : off + m] = (seg & np.uint64(0xFF)).astype(np.uint8)
                    continue
                pos = (seg & np.uint64(0xFFFFFFFF)).astype(np.int64)
                dst[r, off : off + m] = pv[r, pos] if pv is not None else pay[pos] if pay is not None else pos
        return 0


    # --- K10g: coarse and fine buckets of a segment, tiles of one segment -----------------

    def _glayout(self, tiles, n_tiles, segs, coarse, nbc, n_starts, max_bits, n):
        """The layout read back, checked as the kernels rely on it: tiles of
        one segment each, of 4096 << (fb - 8) positions (more where a
        segment would have more than 256 tiles), covering every position
        once in order; each segment's fine bits max(nat, 8), its tiles'
        bucket starts after the previous tile's; every segment's coarse
        buckets listed in order; the sort's shared arrays large enough."""
        t = _view(tiles, np.int32, 4 * n_tiles).reshape(n_tiles, 4).astype(np.int64)
        n_seg = int(t[:, 0].max()) + 1
        sg = _view(segs, np.int32, 4 * n_seg).reshape(n_seg, 4).astype(np.int64)
        cs = _view(coarse, np.int32, 2 * nbc).reshape(nbc, 2)
        first_tile, per_seg, fb, nat = sg.T
        assert np.all(fb == np.maximum(nat, 8)) and fb.max() == max_bits <= 13
        assert t[0, 1] == 0 and np.all(t[1:, 1] == t[:-1, 1] + t[:-1, 2]) and t[-1, 1] + t[-1, 2] == n
        assert np.all(t[:, 2] >= 1) and np.all(np.diff(t[:, 0]) >= 0) and np.all(np.diff(t[:, 0]) <= 1)
        np.testing.assert_array_equal(np.bincount(t[:, 0], minlength=n_seg), per_seg)
        np.testing.assert_array_equal(first_tile, np.cumsum(per_seg) - per_seg)
        width = np.left_shift(1, fb[t[:, 0]]) + 1
        np.testing.assert_array_equal(t[:, 3], np.cumsum(width) - width)
        assert width.sum() == n_starts and per_seg.max() <= 256
        assert np.all(per_seg * (np.left_shift(1, fb - nat) + 1) <= 768)
        widths = np.left_shift(1, nat)
        np.testing.assert_array_equal(cs[:, 0], np.repeat(np.arange(n_seg), widths))
        np.testing.assert_array_equal(cs[:, 1], np.arange(nbc) - np.repeat(np.cumsum(widths) - widths, widths))
        return t, sg, cs

    def sqt_shuffle_gscatter(self, keys, rows, n, mask, tiles, n_tiles, segs, coarse, nbc, n_starts, max_bits, vals,
                             starts, tmp, stream):
        """Each tile's keys over its own positions in fine-bucket order (in
        item order within a bucket on the packed route, the stable scatter;
        in any order with positions), and its bucket starts."""
        self.calls.append("gscatter")
        t, sg, _ = self._glayout(tiles, n_tiles, segs, coarse, nbc, n_starts, max_bits, n)
        self.packed = vals is not None
        if self.packed:
            assert n < 1 << 24 and max_bits <= 11
        w = self._words(keys, rows, n, mask).astype(np.uint64)
        st = _view(starts, np.int32, rows * n_starts).reshape(rows, n_starts)
        st[:] = -7  # every entry is the kernel's to write
        dst = _view(tmp, np.uint32 if self.packed else np.uint64, rows * n).reshape(rows, n)
        v = _view(vals, np.uint8, n).astype(np.uint64) if self.packed else None
        for s, first, count, sbase in t:
            fb = int(sg[s, 2])
            for r in range(rows):
                idx = np.arange(count) if self.packed else self.rng.permutation(count)
                words = w[r, first : first + count]
                srt = idx[np.argsort(words[idx] >> np.uint64(32 - fb), kind="stable")]
                b = (words[srt] >> np.uint64(32 - fb)).astype(np.int64)
                st[r, sbase : sbase + (1 << fb) + 1] = np.searchsorted(b, np.arange((1 << fb) + 1))
                low = (words[srt] << np.uint64(fb)) & np.uint64(0xFFFFFFFF)
                pos = (first + srt).astype(np.uint64)
                dst[r, first : first + count] = low | v[pos] if self.packed else (low << np.uint64(32)) | pos
        return 0

    def _runs(self, t, sg, cs, c, st_row, src_row):
        """Coarse bucket c's keys as the sort reads them, one run a tile of
        its segment: the sort keys (csrc/threefry.cu sort_key) in (tile,
        fine bucket, slot) order, the bucket's first group-sorted slot, and
        the segment's coarse bits."""
        s, cl = (int(v) for v in cs[c])
        first_tile, per_seg, fb, nat = (int(v) for v in sg[s])
        nf = 1 << (fb - nat)
        keys, fines = [], []
        before = 0
        for tl in range(first_tile, first_tile + per_seg):
            first, sbase = int(t[tl, 1]), int(t[tl, 3])
            bounds = st_row[sbase + (cl * nf) : sbase + (cl * nf) + nf + 1].astype(np.int64)
            before += int(bounds[0])
            keys.append(src_row[first + bounds[0] : first + bounds[-1]].astype(np.uint64))
            fines.append(np.repeat(cl * nf + np.arange(nf), np.diff(bounds)))
        keys, fine = np.concatenate(keys), np.concatenate(fines).astype(np.uint64)
        j = np.arange(len(keys), dtype=np.uint64)
        if self.packed:
            word = (fine << np.uint64(32 - fb)) | (keys >> np.uint64(fb))
            low = (j << np.uint64(8)) | (keys & np.uint64(0xFF))
        else:
            word = (fine << np.uint64(32 - fb)) | ((keys >> np.uint64(32)) >> np.uint64(fb))
            low = keys & np.uint64(0xFFFFFFFF)
        return (word << np.uint64(32)) | low, int(t[first_tile, 1]) + before, nat

    def _gepilogue(self, n, rows, order, payload, payload_bytes, packed, out, out_ld):
        assert bool(packed) == self.packed and payload_bytes in (1, 4, 8) and (payload_bytes == 1 or not packed)
        dtype = _PAYLOAD[payload_bytes]
        at = _view(order, np.int32, n) if order is not None else np.arange(n)
        return _view(payload, dtype, n), at, _view(out, dtype, rows * out_ld).reshape(rows, out_ld)

    def _gemit(self, sorted_keys, r, off, at, pay, dst):
        slots = at[off : off + len(sorted_keys)]
        if self.packed:
            dst[r, slots] = (sorted_keys & np.uint64(0xFF)).astype(np.uint8)
        else:
            dst[r, slots] = pay[(sorted_keys & np.uint64(0xFFFFFFFF)).astype(np.int64)]

    def sqt_shuffle_gsort(self, tmp, starts, tiles, n_tiles, segs, coarse, nbc, n_starts, max_bits, rows, n, cap,
                          order, payload, payload_bytes, packed, out, out_ld, overflow, stats, stream):
        """A coarse bucket up to ``cap`` a block: its keys placed by the next
        11 bits of the word in any order, then each key at its sub-bucket's
        start plus its count of the smaller keys there; larger buckets
        listed in any order, their scratch offsets in that order."""
        self.calls.append("gsort")
        t, sg, cs = self._glayout(tiles, n_tiles, segs, coarse, nbc, n_starts, max_bits, n)
        src = _view(tmp, np.uint32 if self.packed else np.uint64, rows * n).reshape(rows, n)
        st = _view(starts, np.int32, rows * n_starts).reshape(rows, n_starts)
        assert np.all(st >= 0)
        pay, at, dst = self._gepilogue(n, rows, order, payload, payload_bytes, packed, out, out_ld)
        listed, largest = [], 0
        for r in range(rows):
            for c in range(nbc):
                keys, off, nat = self._runs(t, sg, cs, c, st[r], src[r])
                m = len(keys)
                largest = max(largest, m)
                if m > cap:
                    listed.append((r * nbc + c, m))
                    continue
                if not m:
                    continue
                sub = (((keys >> np.uint64(32)) << np.uint64(nat)) & np.uint64(0xFFFFFFFF)) >> np.uint64(21)
                placed = self.rng.permutation(m)
                placed = placed[np.argsort(sub[placed], kind="stable")]
                pk, ps = keys[placed], sub[placed]  # each key goes to its sub-bucket's start plus its rank
                self._gemit(pk[np.lexsort((pk, ps))], r, off, at, pay, dst)  # there, as ordered by (sub, key)
                self.sorted_by["local"] += 1
        order_ = self.rng.permutation(len(listed))
        listed = [listed[i] for i in order_]
        ov = _view(overflow, np.int64, 2 * rows * nbc).reshape(rows * nbc, 2)
        sizes = np.array([m for _, m in listed], dtype=np.int64)
        ov[: len(listed), 0] = [code for code, _ in listed]
        ov[: len(listed), 1] = np.cumsum(sizes) - sizes
        _view(stats, np.int64, 4)[:3] = len(listed), largest, sizes.sum()
        return 0

    def sqt_shuffle_goverflow(self, tmp, starts, tiles, n_tiles, segs, coarse, nbc, n_starts, max_bits, rows, n,
                              overflow, n_over, scratch, order, payload, payload_bytes, packed, out, out_ld, stream):
        """Each listed coarse bucket's sort keys in the scratch at its offset,
        sorted by the bitonic network."""
        self.calls.append("goverflow")
        t, sg, cs = self._glayout(tiles, n_tiles, segs, coarse, nbc, n_starts, max_bits, n)
        src = _view(tmp, np.uint32 if self.packed else np.uint64, rows * n).reshape(rows, n)
        st = _view(starts, np.int32, rows * n_starts).reshape(rows, n_starts)
        ov = _view(overflow, np.int64, 2 * n_over).reshape(n_over, 2)
        pay, at, dst = self._gepilogue(n, rows, order, payload, payload_bytes, packed, out, out_ld)
        for code, soff in ov:
            r, c = divmod(int(code), nbc)
            keys, off, _ = self._runs(t, sg, cs, c, st[r], src[r])
            scr = _view(scratch, np.uint64, soff + len(keys))[soff:]
            scr[:] = keys
            _bitonic(scr)
            self._gemit(scr, r, off, at, pay, dst)
            self.sorted_by["overflow"] += 1
        return 0


@pytest.fixture()
def emulated(monkeypatch):
    emu = _EmulatedK10(seed=5)
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "require", lambda *args, **kwargs: None)
    monkeypatch.setitem(_cuda.launches, "threefry_shuffle", 0)
    monkeypatch.setitem(_cuda.launches, "threefry_grouped", 0)
    monkeypatch.setattr(trng, "_keys_per_chunk", lambda n, device, *_: 1 << 20)  # no card to ask
    return emu


_CARD = torch.device("cuda")  # the kernel path's branch; every tensor stays on the CPU


def _both(subs, n, payload=None, ld=None, **kw):
    """The wrapper around the emulated kernel and the plain version."""
    rows = subs[0].shape[0] if subs else 4
    dtype = payload.dtype if payload is not None else torch.int32
    out = torch.full((rows, ld or n), 7, dtype=dtype)
    got = trng._shuffle(subs, n, _CARD, payload, out, **kw)
    want = trng._shuffle(subs, n, torch.device("cpu"), payload, torch.full((rows, ld or n), 7, dtype=dtype), **kw)
    return got, want


@pytest.mark.parametrize("n", [1, 2, 1625, 1626, 4097, 65_535, 65_536])
def test_emulated_shuffle_matches_sort_and_jax(n, emulated):
    """Every round, the rows' composition and the int32 output: bitwise
    ``torch.sort(stable=True)`` and ``jax.random.permutation``, at the
    sizes where JAX goes from one round to two, n not a multiple of the
    4096-item tile, one bucket (n <= 2048) and several."""
    keys = trng.spawn_keys(n % 101, 3)
    subs = trng._round_keys(keys, trng._rounds(n))
    got, want = _both(subs, n) if subs else (None, None)
    if subs:
        assert torch.equal(got, want)
        assert emulated.calls == ["hist", "scan", "scatter", "sort"] * len(subs)
        assert _cuda.launches["threefry_shuffle"] == 4 * len(subs)
    jax_perm = np.asarray(jrng.permutation_batch(jnp.asarray(keys), jnp.arange(n, dtype=jnp.int32)))
    out = torch.empty((3, n), dtype=torch.int32)
    np.testing.assert_array_equal(trng.permutation_batch(keys, n, _CARD, out=out).numpy(), jax_perm)


def test_emulated_permutation_batch_chunks(emulated, monkeypatch):
    """``permutation_batch``'s chunks on the kernel path, two rounds, with
    uint8 labels as the payload into rows padded past n (left untouched)."""
    n = 3000
    keys = trng.spawn_keys(4, 7)
    labels = torch.from_numpy(np.random.default_rng(1).integers(0, 16, n).astype(np.uint8))
    monkeypatch.setattr(trng, "_keys_per_chunk", lambda n, device: 3)
    out = torch.full((7, 3072), 255, dtype=torch.uint8)
    got = trng.permutation_batch(keys, n, _CARD, payload=labels, out=out)
    want = labels[trng.permutation_batch(keys, n, torch.device("cpu")).long()]
    assert got is out and torch.equal(got[:, :n], want) and bool((got[:, n:] == 255).all())
    assert emulated.calls.count("hist") == 3 * 2  # three chunks of two rounds


@pytest.mark.parametrize("packed", [True, False], ids=["uint8 in the keys", "uint8 gathered"])
def test_emulated_uint8_labels_both_epilogues(packed, emulated, monkeypatch):
    """uint8 labels ride in the keys' low byte below 2^24 items; the gather
    epilogue (forced here by lowering that limit) gives the same rows, over
    two rounds."""
    if not packed:
        monkeypatch.setattr(trng, "_PACKED_MAX_N", 0)
    n = 4500
    subs = trng._round_keys(trng.spawn_keys(6, 3), 2)
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, 256, n).astype(np.uint8))
    got, want = _both(subs, n, labels, ld=4608)
    assert torch.equal(got, want) and emulated.packed == packed


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64, torch.float32])
def test_emulated_values_epilogue(dtype, emulated):
    """``permutation_columns``' round (the keys themselves, one sort) with
    the values as the payload, against JAX's ``sort_key_val`` columns."""
    n, P = 5000, 4
    values = np.random.default_rng(2).permutation(n).astype(np.int64) % 200
    keys = trng.spawn_keys(9, P)
    got, want = _both([keys], n, torch.from_numpy(values).to(dtype))
    assert torch.equal(got, want)
    jax_cols = np.asarray(jrng.permutation_columns(jnp.asarray(keys), jnp.asarray(values.astype(np.int32))))
    np.testing.assert_array_equal(got.T.numpy().astype(np.int64), jax_cols)


@pytest.mark.parametrize("mask", [0xFFF00000, 0xF0000000, 0x80000000, 0x00000FFF],
                         ids=["4096 words", "16 words", "top bit only", "low bits only"])
def test_emulated_ties(mask, emulated):
    """Crafted words with many ties (the words and-ed with ``mask``): each
    tie kept in position order, as a stable sort keeps it; the top bit
    compared unsigned. Two rounds, so round 2's ties follow round 1's
    output positions."""
    n = 9000
    subs = trng._round_keys(trng.spawn_keys(3, 2), 2)
    got, want = _both(subs, n, mask=mask)
    assert torch.equal(got, want)
    w = trng.random_bits(subs[0], (n,)) & np.uint32(mask)
    np.testing.assert_array_equal(trng._shuffle(subs[:1], n, torch.device("cpu"), mask=mask).numpy(),
                                  np.argsort(w, axis=1, kind="stable"))


def test_emulated_keys_with_the_top_bit(emulated):
    """Key words at and above 2^31 (negative as int32) on the kernel path."""
    keys = np.array([[0xFFFFFFFF, 0x80000001], [0x80000000, 0x7FFFFFFF]], dtype=np.uint32)
    got, want = _both([keys], 3000)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,mask,cap", [(3000, 0, 64), (6000, 0xFF800000, 64), (2049, trng._FULL_MASK, 1024),
                                        (777, 0, 1)])
def test_emulated_overflow_path(n, mask, cap, emulated, monkeypatch):
    """Buckets past the local sort's capacity (lowered here) take the
    bitonic network: every word equal (one bucket of n), a few large
    buckets, ordinary words with a small capacity (several buckets, the
    last one included), and a capacity of one key; payload and index
    epilogues, composed over two rounds."""
    monkeypatch.setattr(trng, "_SORT_CAP", cap)
    subs = trng._round_keys(trng.spawn_keys(n, 3), 2)
    labels = torch.from_numpy(np.random.default_rng(n).integers(0, 255, n).astype(np.uint8))
    for payload in (None, labels):
        got, want = _both(subs, n, payload, ld=n + 5, mask=mask)
        assert torch.equal(got, want)
        assert bool((got[:, n:] == 7).all())
    assert emulated.sorted_by["overflow"] > 0


@pytest.mark.parametrize("n,bits", [(1, 0), (2048, 0), (2049, 1), (1_000_000, 9), (2_700_000, 11), (10**9, 13)])
def test_bucket_bits(n, bits):
    assert trng._bucket_bits(n) == bits
    assert n <= trng._BUCKET_MEAN << bits or bits == trng._MAX_BITS


@pytest.mark.parametrize("n,rounds", [(0, 0), (1, 0), (2, 1), (1625, 1), (1626, 2), (2_642_245, 2), (2_642_246, 3)])
def test_rounds_at_the_edges(n, rounds):
    assert trng._rounds(n) == rounds


# --- K10's grouped entry, its C interface emulated in numpy -----------------------------


def _grouped_both(keys, values, groups, mask=trng._FULL_MASK, ld=None):
    """The grouped wrapper around the emulated kernel (the CUDA branch, on
    CPU tensors) and the plain version, into rows padded to ``ld``."""
    lay = trng.group_layout(groups)
    vsorted = values[torch.from_numpy(lay.order)].contiguous()
    n = len(groups)
    outs = [torch.full((keys.shape[0], ld or n), 7, dtype=values.dtype) for _ in range(2)]
    got = trng._shuffle_grouped(keys, lay, vsorted, outs[0], _CARD, mask=mask)
    want = trng._shuffle_grouped(keys, lay, vsorted, outs[1], torch.device("cpu"), mask=mask)
    return got, want


@pytest.mark.parametrize("grouping", ["one group", "two unequal", "seven with a single cell", "fifty unequal"])
def test_emulated_grouped_matches_plain_and_jax(grouping, emulated):
    """The grouped host layout (tiles of one segment, segments' buckets,
    bucket bits from each length) and the four calls, bitwise the plain
    version and the JAX package's columns; a NaN library included."""
    groups = _groups(_GROUPINGS[grouping], seed=2, nan=3)
    n = len(groups)
    values = torch.from_numpy(np.random.default_rng(4).integers(0, 250, n).astype(np.uint8))
    keys = trng.spawn_keys(n % 13, 3)
    got, want = _grouped_both(keys, values, groups)
    assert torch.equal(got, want)
    assert emulated.calls == ["gscatter", "gsort"] and emulated.packed
    assert _cuda.launches["threefry_grouped"] == 2 and _cuda.launches["threefry_shuffle"] == 0
    jax_cols = jrng.shuffle_group_columns(jnp.asarray(keys), jnp.asarray(values.numpy()), groups)
    np.testing.assert_array_equal(got.T.numpy(), np.asarray(jax_cols))


@pytest.mark.parametrize("grouping", ["one group", "two unequal", "seven with a single cell", "fifty unequal"])
def test_emulated_grouped_int32_matches_plain_and_jax(grouping, emulated):
    """int32 values (gathered at the sorted positions, not packed in the
    keys) bitwise the plain version and the JAX package's columns."""
    groups = _groups(_GROUPINGS[grouping], seed=12, nan=3)
    n = len(groups)
    values = torch.from_numpy(np.random.default_rng(13).integers(0, 2**31 - 1, n).astype(np.int32))
    keys = trng.spawn_keys(n % 17, 5)
    got, want = _grouped_both(keys, values, groups)
    assert torch.equal(got, want) and not emulated.packed
    jax_cols = jrng.shuffle_group_columns(jnp.asarray(keys), jnp.asarray(values.numpy()), groups)
    np.testing.assert_array_equal(got.T.numpy(), np.asarray(jax_cols))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint8])
def test_emulated_grouped_gathered_payloads(dtype, emulated, monkeypatch):
    """Payloads gathered at the sorted positions (4 and 8 bytes, and uint8
    with the packing limit lowered to 0), into rows padded past n (left
    untouched)."""
    monkeypatch.setattr(trng, "_PACKED_MAX_N", 0)
    groups = _groups([700, 1, 3000, 250], seed=5, nan=2)
    values = torch.from_numpy(np.random.default_rng(6).permutation(len(groups)) % 250).to(dtype)
    got, want = _grouped_both(trng.spawn_keys(7, 2), values, groups, ld=len(groups) + 9)
    assert torch.equal(got, want) and not emulated.packed
    assert bool((got[:, len(groups):] == 7).all())


def test_emulated_grouped_large_segments_and_ties(emulated):
    """A segment of 9000 (several buckets, tiles across it), words and-ed to
    4096 values (ties kept in position order within a segment)."""
    groups = _groups([9000, 4100, 1], seed=7)
    values = torch.from_numpy(np.random.default_rng(8).permutation(len(groups)).astype(np.int32))
    got, want = _grouped_both(trng.spawn_keys(8, 2), values, groups, mask=0xFFF00000)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cap,mask", [(64, trng._FULL_MASK), (16, 0)], ids=["capacity lowered", "every word equal"])
def test_emulated_grouped_overflow_path(cap, mask, emulated, monkeypatch):
    """Buckets past the local sort's capacity take the bitonic network, in
    every segment (every word equal: a segment's one bucket holds all of it)."""
    monkeypatch.setattr(trng, "_SORT_CAP", cap)
    groups = _groups([3000, 40, 1, 2500], seed=9, nan=5)
    values = torch.from_numpy(np.random.default_rng(9).integers(0, 250, len(groups)).astype(np.uint8))
    got, want = _grouped_both(trng.spawn_keys(9, 2), values, groups, mask=mask)
    assert torch.equal(got, want) and emulated.sorted_by["overflow"] > 0 and emulated.packed
    assert emulated.calls == ["gscatter", "gsort", "goverflow"]
    assert _cuda.launches["threefry_grouped"] == 3


def test_emulated_grouped_chunks(emulated, monkeypatch):
    """Keys in chunks (three here) change nothing."""
    groups = _groups([1500, 900, 600], seed=10)
    values = torch.from_numpy(np.random.default_rng(10).integers(0, 9, len(groups)).astype(np.uint8))
    keys = trng.spawn_keys(10, 7)
    monkeypatch.setattr(trng, "_keys_per_chunk", lambda n, device, *_: 3)
    got, want = _grouped_both(keys, values, groups)
    assert torch.equal(got, want) and emulated.calls.count("gscatter") == 3


def test_emulated_grouped_chunks_reuse_the_device_layout(emulated, monkeypatch):
    """A layout's device order and tile table are made once and reused by
    every chunk and every later call with that layout (``nhood_enrichment``
    passes one layout for all its chunks)."""
    groups = _groups([1500, 900, 600], seed=18, nan=2)
    values = torch.from_numpy(np.random.default_rng(18).integers(0, 9, len(groups)).astype(np.uint8))
    keys = trng.spawn_keys(18, 7)
    monkeypatch.setattr(trng, "_keys_per_chunk", lambda n, device, *_: 3)
    made = []
    tiles = trng._group_tiles
    monkeypatch.setattr(trng, "_group_tiles", lambda starts: made.append(1) or tiles(starts))
    lay = trng.group_layout(groups)
    vsorted = values[torch.from_numpy(lay.order)].contiguous()
    outs = [torch.full((7, len(groups)), 7, dtype=torch.uint8) for _ in range(3)]
    for out in outs[:2]:
        trng._shuffle_grouped(keys, lay, vsorted, out, _CARD)
    assert made == [1] and emulated.calls.count("gscatter") == 6
    assert {k[0] for k in lay.cache} == {"order", "tiles"}
    cached = dict(lay.cache)
    trng._shuffle_grouped(keys, trng.group_layout(groups), vsorted, outs[2], _CARD)
    assert made == [1, 1] and all(lay.cache[k] is v for k, v in cached.items())
    want = trng._shuffle_grouped_plain(keys, lay, vsorted, torch.empty_like(outs[0]))
    assert all(torch.equal(out, want) for out in outs)


@pytest.mark.parametrize("sizes", [[1], [2048], [2049], [4096, 1], [10_000, 3, 8193, 1], [1] * 40,
                                   [300_000, 600_000, 5_000_000], [40_000_000, 7]])
def test_group_tiles(sizes):
    """K10g's host layout: each segment's coarse bits from its length (a
    coarse bucket holds at most 3072 items on average), its fine bits at
    least 8, its positions in tiles of 4096 << (fine bits - 8) (larger
    where that leaves more than 256) that never cross a segment, each tile's
    2^fb + 1 bucket starts after the previous tile's (about one a 16 items),
    its coarse buckets listed in order."""
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    tiles, segs, coarse, n_starts, max_bits = trng._group_tiles(starts)
    nat = np.array([trng._coarse_bits(s) for s in sizes])
    assert all(s <= 3072 << b or b == 13 for s, b in zip(sizes, nat))
    assert all(b == 0 or s > 3072 << (b - 1) for s, b in zip(sizes, nat))
    fb = np.maximum(nat, 8)
    tile = np.maximum(np.left_shift(4096, fb - 8), -(-np.asarray(sizes) // (256 * 4096)) * 4096)
    per_seg = -(-np.asarray(sizes) // tile)
    assert per_seg.max() <= 256
    np.testing.assert_array_equal(segs[:, 3], nat)
    np.testing.assert_array_equal(segs[:, 2], fb)
    np.testing.assert_array_equal(segs[:, 1], per_seg)
    np.testing.assert_array_equal(segs[:, 0], np.cumsum(per_seg) - per_seg)
    width = np.left_shift(1, fb[tiles[:, 0]]) + 1
    np.testing.assert_array_equal(tiles[:, 3], np.cumsum(width) - width)
    assert n_starts == int(width.sum()) and max_bits == fb.max()
    assert np.all(tiles[:, 2] <= tile[tiles[:, 0]]) and tiles[:, 2].sum() == sum(sizes)
    np.testing.assert_array_equal(tiles[:, 1] - starts[tiles[:, 0]], (np.arange(len(tiles)) - segs[tiles[:, 0], 0])
                                  * tile[tiles[:, 0]])
    np.testing.assert_array_equal(tiles[:, 1] + tiles[:, 2] <= starts[tiles[:, 0] + 1], True)
    assert len(tiles) == per_seg.sum()
    np.testing.assert_array_equal(coarse[:, 0], np.repeat(np.arange(len(sizes)), np.left_shift(1, nat)))
    np.testing.assert_array_equal(coarse[:, 1], np.concatenate([np.arange(1 << b) for b in nat]))
    assert n_starts <= sum(s // 16 + t + (1 << int(b)) + 1 for s, t, b in zip(sizes, per_seg, fb))
    assert np.all(per_seg * (np.left_shift(1, fb - nat) + 1) <= 768)  # the sort's shared bounds


def test_emulated_grouped_fine_buckets_and_ties_across_tiles(emulated):
    """The packed route (uint8 values in 32-bit keys, the stable scatter)
    on segments whose fine bits are raised to 8 above their coarse bits
    (9000 items: 2 coarse bits, 64 fine buckets a coarse one, 3 tiles),
    words and-ed to 4096 values: ties whose two items fall in different
    tiles of one segment keep position order, bitwise the plain version and
    JAX."""
    groups = _groups([9000, 4100, 1], seed=17, nan=3)
    lay = trng.group_layout(groups)
    tiles, segs = trng._group_tiles(lay.starts)[:2]
    assert list(segs[:, 2]) == [8, 8, 8, 8] and list(segs[:, 3]) == [0, 2, 1, 0] and list(segs[:, 1]) == [1, 3, 2, 1]
    keys = trng.spawn_keys(19, 3)
    words = trng.random_bits(keys, (len(groups),)) & np.uint32(0xFFF00000)
    tile_of = np.repeat(np.arange(len(tiles)), tiles[:, 2])
    seg_of = np.repeat(np.arange(len(segs)), np.diff(lay.starts))
    first = {}
    crossed = 0
    for j, (s, w) in enumerate(zip(seg_of, words[0])):
        if (s, w) in first and tile_of[first[s, w]] != tile_of[j]:
            crossed += 1
        first.setdefault((s, w), j)
    assert crossed > 0
    values = torch.from_numpy(np.random.default_rng(18).integers(0, 250, len(groups)).astype(np.uint8))
    got, want = _grouped_both(keys, values, groups, mask=0xFFF00000)
    assert torch.equal(got, want) and emulated.packed
    want_jax = np.argsort(np.stack([seg_of.astype(np.int64) << 32 | words[p] for p in range(3)]), axis=1,
                          kind="stable")
    vs = values.numpy()[lay.order]
    for p in range(3):
        np.testing.assert_array_equal(got[p, lay.order].numpy(), vs[want_jax[p]])


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_emulated_grouped_segment_with_fine_bits_above_8(dtype, emulated):
    """A segment of 800,000 items (9 coarse bits = 9 fine bits: one fine
    bucket a coarse one, tiles of two sub-tiles), beside a small one, on
    both routes: bitwise the plain version and JAX."""
    groups = _groups([800_000, 3000], seed=21, nan=2)
    segs = trng._group_tiles(trng.group_layout(groups).starts)[1]
    assert list(segs[:, 2]) == [8, 9, 8] and list(segs[:, 3]) == [0, 9, 0]
    values = torch.from_numpy(np.random.default_rng(22).integers(0, 250, len(groups))).to(dtype)
    keys = trng.spawn_keys(23, 1)
    got, want = _grouped_both(keys, values, groups)
    assert torch.equal(got, want) and emulated.packed == (dtype == torch.uint8)
    jax_cols = jrng.shuffle_group_columns(jnp.asarray(keys), jnp.asarray(values.numpy()), groups)
    np.testing.assert_array_equal(got.T.numpy(), np.asarray(jax_cols))


@pytest.mark.parametrize("cap,mask", [(64, trng._FULL_MASK), (16, 0)], ids=["capacity lowered", "every word equal"])
def test_emulated_grouped_overflow_path_gathered(cap, mask, emulated, monkeypatch):
    """The overflow sort on the gathered route (int64 values, 64-bit keys
    carrying positions)."""
    monkeypatch.setattr(trng, "_SORT_CAP", cap)
    groups = _groups([3000, 40, 1, 2500], seed=24, nan=5)
    values = torch.from_numpy(np.random.default_rng(24).permutation(len(groups)).astype(np.int64))
    got, want = _grouped_both(trng.spawn_keys(24, 2), values, groups, mask=mask)
    assert torch.equal(got, want) and not emulated.packed and emulated.sorted_by["overflow"] > 0
    assert emulated.calls == ["gscatter", "gsort", "goverflow"]


@pytest.mark.parametrize("itemsize,n,max_bits,packed", [(1, 1000, 8, True), (1, 1000, 11, True), (1, 1000, 12, False),
                                                        (1, 1 << 24, 8, False), (4, 1000, 8, False),
                                                        (8, 1000, 8, False)])
def test_grouped_route(itemsize, n, max_bits, packed):
    """The packed route takes uint8 values below 2^24 items while every
    segment's fine bits are at most 11 (segments up to 2^22 items); the
    others are gathered through 64-bit keys."""
    dtype = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[itemsize]
    vsorted = torch.empty(n, dtype=dtype)
    dev = trng._GroupedDevice(*(torch.empty(0),) * 4, n_starts=100, max_bits=max_bits)
    assert trng._packed_route(vsorted, dev) == packed


def test_grouped_chunk_of_part_f1_fits_one_launch_set():
    """1M cells in 8 sections of 70k-181k: K10g's bytes a value (a 4-byte
    key, the uint8 output, the bucket starts' share) let an 8 GiB budget
    take a 500-key chunk whole."""
    sizes = [70_000, 181_000, 120_000, 95_000, 160_000, 130_000, 110_000, 134_000]
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    tiles, segs, coarse, n_starts, max_bits = trng._group_tiles(starts)
    dev = trng._GroupedDevice(*(torch.empty(0),) * 4, n_starts=n_starts, max_bits=max_bits)
    n = sum(sizes)
    per_value = trng._grouped_bytes(n, dev, True, 1)
    assert per_value == 6 and (8 << 30) // (per_value * n) >= 500
    assert trng._grouped_bytes(n, dev, False, 4) == 13


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
@pytest.mark.parametrize("nan", [False, True], ids=["no -1", "with -1"])
@pytest.mark.parametrize("dtype,span,narrow", [(np.int8, 100, np.int8), (np.int32, 120, np.int8),
                                               (np.int64, 127, np.int8), (np.int32, 300, np.int16),
                                               (np.int64, 30_000, np.int16), (np.int32, 70_000, np.int32),
                                               (np.int64, 2**31 - 1, np.int32), (np.int16, 100, np.int8)])
def test_group_layout_narrow_codes(dtype, span, narrow, nan, layout):
    """``group_layout`` sorts the codes at the narrowest signed width that
    holds their range, -1 included (numpy's radix path for 8 and 16 bits):
    ``order`` and ``starts`` equal the stable argsort of the codes as int64."""
    rng = np.random.default_rng(span % 97)
    n = 5000
    codes = np.sort(rng.integers(0, 8, n)) if layout == "contiguous" else rng.integers(0, 8, n)
    codes = (codes * (span // 7)).astype(dtype)
    if nan:
        codes[rng.choice(n, 50, replace=False)] = -1
    narrowed = trng._narrowest_codes(codes)
    assert narrowed.dtype == narrow and np.array_equal(narrowed.astype(np.int64), codes.astype(np.int64))
    lay = trng.group_layout(codes)
    want = np.argsort(codes.astype(np.int64), kind="stable")
    np.testing.assert_array_equal(lay.order, want)
    sorted_codes = codes.astype(np.int64)[want]
    np.testing.assert_array_equal(lay.starts, np.append(np.flatnonzero(np.r_[True, np.diff(sorted_codes) != 0]), n))


@pytest.mark.cuda
def test_k10_grouped_matches_plain_on_card(cuda_card, monkeypatch):
    """The grouped entry against its plain version on the card, bitwise:
    uint8 (packed) and int32 payloads, a NaN library, a single-cell group,
    ties, the overflow path."""
    cuda = torch.device("cuda")
    for sizes, mask, cap in (([70_000, 1, 30_000, 5], trng._FULL_MASK, None), ([20_000, 9000], 0xFFF00000, None),
                             ([5000, 3000], 0, 64)):
        if cap is not None:
            monkeypatch.setattr(trng, "_SORT_CAP", cap)
        groups = _groups(sizes, seed=len(sizes), nan=4)
        keys = trng.spawn_keys(len(groups), 9)
        lay = trng.group_layout(groups)
        for dtype in (torch.uint8, torch.int32):
            values = torch.from_numpy(np.random.default_rng(1).integers(0, 200, len(groups))).to(dtype)
            vsorted = values[torch.from_numpy(lay.order)].contiguous()
            got = torch.empty((9, len(groups)), dtype=dtype, device=cuda)
            trng._shuffle_grouped(keys, lay, vsorted.to(cuda), got, cuda, mask=mask)
            want = trng._shuffle_grouped(keys, lay, vsorted, torch.empty((9, len(groups)), dtype=dtype),
                                         torch.device("cpu"), mask=mask)
            assert torch.equal(got.cpu(), want)
