"""Deterministic keyed RNG fan-out (counterpart of ``squidpy_tpu/_core/rng.py``).

``seed`` plus permutation index fully determines each shuffle, independent
of chunking. The keys are JAX's own: a numpy port of ``threefry2x32`` and of
``jax.random.PRNGKey``/``split``/``bits`` as JAX computes them with
``jax_threefry_partitionable`` on (the default since JAX 0.5): ``split`` and
``bits`` hash the 64-bit iota of the output shape, split into two uint32
words, and 32-bit ``bits`` are the XOR of the two output words. The keys are
a few thousand words per call, so they are made on the host (``spawn_keys``,
``split_keys``); the shuffles themselves, up to 2e9 sort words a call, run
on the device: kernel K10 (``csrc/threefry.cu``) draws each round's words
in registers and sorts every row by (word, position) in buckets
(:func:`permutation_batch`, :func:`permutation_columns`), and its grouped
entry sorts each group's segment of a row by (segment, word) for the
library-stratified shuffles (:func:`shuffle_group_columns`); its plain torch
version, on the CPU, draws the words with :func:`_threefry_plain` and sorts
them with ``torch.sort(stable=True)``. :func:`threefry_bits` is K10's word
entry alone. Everything downstream (shuffles, counts, z-scores) is bitwise
equal to the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from squidpy_torch import _cuda

__all__ = [
    "GroupLayout",
    "group_layout",
    "permutation_batch",
    "permutation_columns",
    "random_bits",
    "random_bits_device",
    "shuffle_group_columns",
    "spawn_keys",
    "split_keys",
    "threefry2x32",
    "threefry_bits",
]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(
    k1: np.ndarray, k2: np.ndarray, x1: np.ndarray, x2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``; all four broadcast, uint32 arithmetic wraps."""
    k1, k2, x1, x2 = (np.atleast_1d(np.asarray(v, dtype=np.uint32)) for v in (k1, k2, x1, x2))
    k1, k2, x1, x2 = np.broadcast_arrays(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _iota_2x32(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed: its two 32-bit halves."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=np.uint32)


def spawn_keys(seed: int | None, n: int) -> np.ndarray:
    """``(n, 2)`` uint32 keys, equal to ``jax.random.split(PRNGKey(seed), n)``.

    ``seed=None`` draws fresh OS entropy, as the JAX package does, so repeated
    unseeded runs differ.
    """
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    key = _prng_key(seed)
    hi, lo = _iota_2x32((n,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(keys: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32-bit random words, equal to ``jax.random.bits(key, shape, uint32)``.

    ``keys`` is one key ``(2,)`` or a batch ``(..., 2)``; the result has shape
    ``keys.shape[:-1] + shape``.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_2x32(shape)
    expand = (...,) + (None,) * len(shape)
    b1, b2 = threefry2x32(keys[..., 0][expand], keys[..., 1][expand], hi, lo)
    return (b1 ^ b2).reshape(keys.shape[:-1] + shape)


def split_keys(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` of each key: ``(..., 2)`` -> ``(..., num, 2)``."""
    keys = np.asarray(keys, dtype=np.uint32)
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(keys[..., 0][..., None], keys[..., 1][..., None], hi, lo)
    return np.stack([b1, b2], axis=-1)


_MASK32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def _rotl_plain(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _threefry_plain(keys: torch.Tensor, n: int, flip: bool = False) -> torch.Tensor:
    """Plain torch version of K10: ``(n_keys, n)`` int32 bit patterns of the
    words ``b1 ^ b2`` (xor-ed with 0x80000000 when ``flip``). uint32 is
    emulated in int64 with 32-bit masks: torch has no uint32 shifts on the
    CPU. ``keys`` is ``(n_keys, 2)``, any integer type holding the uint32 words."""
    k = keys.to(torch.int64) & _MASK32
    k1, k2 = k[:, :1], k[:, 1:]
    ks = (k1, k2, k1 ^ k2 ^ int(_KS_PARITY))
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    x0 = ((i >> 32) + ks[0]) & _MASK32
    x1 = ((i & _MASK32) + ks[1]) & _MASK32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = x0 ^ _rotl_plain(x1, r)
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _MASK32
    w = x0 ^ x1
    if flip:
        w = w ^ _SIGN32
    return torch.where(w >= _SIGN32, w - (1 << 32), w).to(torch.int32)


def threefry_bits(keys: torch.Tensor, n: int, *, flip: bool = False) -> torch.Tensor:
    """K10's word entry: ``(n_keys, n)`` int32 bit patterns of the threefry words of
    ``keys`` (``(n_keys, 2)`` int32 holding the uint32 key words), row ``p``
    bitwise :func:`random_bits` of key ``p``; with ``flip`` each word is
    xor-ed with 0x80000000, so a signed sort of the result orders a row as an
    unsigned sort of the words, ties included. A CPU tensor runs the plain
    torch version; a CUDA tensor launches the kernel."""
    if keys.device.type == "cpu":
        return _threefry_plain(keys, n, flip)
    _cuda.require(keys, "keys", torch.int32)
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"`keys` must have shape (n_keys, 2), found {tuple(keys.shape)}.")
    out = torch.empty((keys.shape[0], n), dtype=torch.int32, device=keys.device)
    code = _cuda.library().sqt_threefry_bits(keys.data_ptr(), keys.shape[0], n, int(flip), out.data_ptr(),
                                            _cuda.stream_ptr())
    _cuda.check(code, "threefry_shuffle")
    _cuda.launches["threefry_shuffle"] += 1
    return out


def random_bits_device(keys: np.ndarray, n: int, device: torch.device, *, sort_keys: bool = False) -> torch.Tensor:
    """The words of :func:`random_bits` ``(keys, (n,))`` as a ``(n_keys, n)``
    int32 tensor of their bit patterns on ``device`` (K10's word entry on a
    CUDA device). With ``sort_keys`` each word is xor-ed with 0x80000000: a
    signed stable sort of the result is the unsigned stable sort of the
    words."""
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint32).reshape(-1, 2))
    return threefry_bits(torch.from_numpy(keys.view(np.int32)).to(device), n, flip=sort_keys)


# bytes a shuffled value takes on the card: the scatter's key and two
# rounds' outputs (at most 8 bytes each)
_BYTES_PER_VALUE = 24


def _keys_per_chunk(n: int, device: torch.device, bytes_per_value: int = _BYTES_PER_VALUE) -> int:
    """Keys a chunk of :func:`permutation_batch` (or, with its own
    ``bytes_per_value``, of K10g): K10's scratch and outputs take
    :data:`_BYTES_PER_VALUE` bytes a value; a quarter of the card's free
    memory (at most 8 GiB), or 512 MiB on the CPU. The chunking never
    changes a result."""
    if device.type == "cuda":
        budget = min(torch.cuda.mem_get_info(device)[0] // 4, 8 << 30)
    else:
        budget = 512 << 20
    return max(1, int(budget // (bytes_per_value * max(n, 1))))


def _rounds(n: int) -> int:
    """JAX's shuffle rounds for n items: ``ceil(3 ln n / ln(2^32 - 1))``."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def _round_keys(keys: np.ndarray, rounds: int) -> list[np.ndarray]:
    """Each round's subkeys, as ``jax.random.permutation`` splits them."""
    subs = []
    for _ in range(rounds):
        keys, sub = np.moveaxis(split_keys(keys), -2, 0)
        subs.append(np.ascontiguousarray(sub))
    return subs


_FULL_MASK = 0xFFFFFFFF
# the local sort's capacity: keys of one bucket in shared memory
# (csrc/threefry.cu kCap); larger buckets take the global-memory sort
_SORT_CAP = 4096
_BUCKET_MEAN = 2048  # items a bucket on average, at most
_MAX_BITS = 13  # buckets a row: at most 2^13
_PACKED_MAX_N = 1 << 24  # uint8 payloads ride in the keys below this many items


def _bucket_bits(n: int) -> int:
    """Top bits of the word that pick an item's bucket: the fewest (at most
    :data:`_MAX_BITS`) that leave a bucket at most :data:`_BUCKET_MEAN`
    items on average."""
    bits = 0
    while (_BUCKET_MEAN << bits) < n and bits < _MAX_BITS:
        bits += 1
    return bits


def _as_int32(word: int) -> int:
    return word - (1 << 32) if word >= _SIGN32 else word


def _sort_round_plain(sub: torch.Tensor, n: int, prev: torch.Tensor | None, mask: int) -> torch.Tensor:
    """Plain torch version of one K10 round: the words (and-ed with
    ``mask``), ``torch.sort(stable=True)`` of them as uint32, composed with
    the previous round's output: ``(rows, n)`` int64."""
    w = _threefry_plain(sub, n)
    if mask != _FULL_MASK:
        w = w & _as_int32(mask)
    order = torch.sort(w ^ _as_int32(_SIGN32), dim=1, stable=True).indices
    return order if prev is None else torch.gather(prev, 1, order)


def _shuffle_plain(subs: list[np.ndarray], n: int, payload: torch.Tensor | None, out: torch.Tensor,
                   mask: int = _FULL_MASK) -> torch.Tensor:
    """Plain torch version of K10's rounds (on ``out``'s device): each
    round's words sorted by ``torch.sort(stable=True)``, composed by
    gathers, then the payload's gather; into ``out[:, :n]``."""
    perm = torch.arange(n, device=out.device).expand(out.shape[0], n)  # n <= 1 takes no round
    for r, sub in enumerate(subs):
        perm = _sort_round_plain(torch.from_numpy(sub.view(np.int32)).to(out.device), n, perm if r else None, mask)
    out[:, :n] = payload[perm] if payload is not None else perm.to(torch.int32)
    return out


def _launch(entry: str, *args: object, kernel: str = "threefry_shuffle") -> None:
    """One call into K10's C interface, counted as one launch of ``kernel``
    (the shuffle, or its grouped entry)."""
    _cuda.check(getattr(_cuda.library(), entry)(*args, _cuda.stream_ptr()), kernel)
    _cuda.launches[kernel] += 1


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _run_round(steps: tuple, st: torch.Tensor, nb: int, stats: dict | None, kernel: str) -> None:
    """One round's calls (histogram, scan, scatter, sort); given ``stats``,
    each timed by CUDA events and the round's overflowing buckets and
    largest bucket read back (one wait)."""
    events = [_event()] if stats is not None else None
    for _, call in steps:
        _launch(*call, kernel=kernel)
        if events is not None:
            events.append(_event())
    if stats is not None:
        n_over, largest = st.tolist()  # waits for the round
        stats.setdefault("overflow", []).append(n_over)
        stats.setdefault("largest_bucket", []).append(largest)
        stats["buckets"] = nb
        for (name, _), a, b in zip(steps, events, events[1:]):
            stats.setdefault(f"{name}_ms", []).append(a.elapsed_time(b))


def _shuffle_k10(subs: list[np.ndarray], n: int, payload: torch.Tensor | None, out: torch.Tensor, mask: int,
                 cap: int, stats: dict | None = None) -> None:
    """K10's rounds into ``out`` ``(rows, ld)``, ``ld >= n``: each round's
    histogram, scan, scatter and sort (four launches). The first round
    writes ``payload`` (or the int32 position) at each sorted position, a
    later one the previous round's output, so the last round writes
    ``payload[perm]`` (or the int32 permutation) at columns ``[0, n)``. A
    uint8 payload rides in the sort keys' low byte (the scatter reads it in
    item order, the sort writes it back): no gather.
    Given ``stats``, the largest bucket and the overflowing buckets of every
    round are read back, and each step is timed by CUDA events (one wait a
    round)."""
    rows, device = out.shape[0], out.device
    bits = _bucket_bits(n)
    nb = 1 << bits
    hist = torch.empty((rows, nb), dtype=torch.int32, device=device)
    offs = torch.empty((rows, nb + 1), dtype=torch.int32, device=device)
    overflow = torch.empty(rows * nb, dtype=torch.int32, device=device)
    st = torch.empty(2, dtype=torch.int32, device=device)
    tmp = torch.empty((rows, n), dtype=torch.int64, device=device)
    pay_ptr, pay_bytes = (payload.data_ptr(), payload.element_size()) if payload is not None else (None, 0)
    # uint8 values ride in the keys' low byte (positions below 2^24): no gather
    packed = pay_bytes == 1 and n < _PACKED_MAX_N
    prev = None
    for r, sub in enumerate(subs):
        keys = torch.from_numpy(sub.view(np.int32)).to(device)
        last = r == len(subs) - 1
        dst = out if last else torch.empty((rows, n), dtype=out.dtype, device=device)
        prev_ptr, prev_ld = (prev.data_ptr(), prev.stride(0)) if prev is not None else (None, 0)
        vals = (prev_ptr, prev_ld) if prev is not None else (pay_ptr, 0)
        vals = vals if packed else (None, 0)
        steps = (("hist", ("sqt_shuffle_hist", keys.data_ptr(), rows, n, mask, bits, hist.data_ptr(), st.data_ptr())),
                 ("scan", ("sqt_shuffle_scan", rows, n, bits, cap, hist.data_ptr(), offs.data_ptr(),
                           overflow.data_ptr(), st.data_ptr())),
                 ("scatter", ("sqt_shuffle_scatter", keys.data_ptr(), rows, n, mask, bits, *vals, hist.data_ptr(),
                              tmp.data_ptr())),
                 ("sort", ("sqt_shuffle_sort", tmp.data_ptr(), offs.data_ptr(), overflow.data_ptr(), st.data_ptr(),
                           rows, n, bits, cap, None if packed else prev_ptr, prev_ld, pay_ptr, pay_bytes, int(packed),
                           dst.data_ptr(), dst.stride(0))))
        _run_round(steps, st, nb, stats, "threefry_shuffle")
        prev = dst


def _shuffle(subs: list[np.ndarray], n: int, device: torch.device, payload: torch.Tensor | None = None,
             out: torch.Tensor | None = None, *, mask: int = _FULL_MASK, stats: dict | None = None) -> torch.Tensor:
    """Rows of stable sorts by the words of each round's subkeys ``subs``
    (each ``(rows, 2)`` uint32), composed: the int32 permutations ``(rows,
    n)``, or ``payload[perm]`` with ``payload`` ``(n,)``; written into
    ``out`` ``(rows, ld >= n)``, columns from n on untouched, when given
    (and then needed when ``subs`` is empty: n <= 1 takes no round).
    K10 on a CUDA device, its plain version on the CPU (and for no round). ``mask`` ands every
    word (ties, in tests)."""
    dtype = payload.dtype if payload is not None else torch.int32
    if out is None:
        out = torch.empty((subs[0].shape[0], n), dtype=dtype, device=device)
    rows = out.shape[0]
    if out.dtype != dtype or out.ndim != 2 or any(sub.shape[0] != rows for sub in subs) or out.shape[1] < n:
        raise ValueError(f"`out` must be ({rows}, >= {n}) {dtype}, found {tuple(out.shape)} {out.dtype}.")
    if payload is not None and (payload.shape != (n,) or payload.device != out.device):
        raise ValueError(f"`payload` must have shape ({n},) on `out`'s device.")
    if rows == 0 or n == 0:
        return out
    if device.type == "cpu" or not subs:
        return _shuffle_plain(subs, n, payload, out, mask)
    if n >= 2**31 - 1:
        raise ValueError(f"K10 writes int32 positions: at most 2^31 - 2 items, found {n}.")
    if payload is not None:
        payload = payload.contiguous()
        if payload.element_size() not in (1, 4, 8):
            raise TypeError(f"K10 moves payloads of 1, 4 or 8 bytes, found {payload.dtype}.")
        _cuda.require(payload, "payload", payload.dtype, (n,))
    _cuda.require(out, "out", dtype)
    _shuffle_k10(subs, n, payload, out, mask, _SORT_CAP, stats)
    return out


def permutation_batch(keys: np.ndarray, n: int, device: torch.device, payload: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """``(n_keys, n)`` int32 index permutations, row ``p`` bitwise equal to
    ``jax.random.permutation(keys[p], n)``; with ``payload`` ``(n,)`` the
    rows of ``payload[perm]`` instead, written into ``out`` ``(n_keys, ld
    >= n)`` when given.

    JAX shuffles by ``ceil(3 ln n / ln(2^32 - 1))`` rounds (1 below n = 1626,
    2 up to ~2.6M): each round splits the key, draws 32-bit words from the
    subkey and stably sorts the running permutation by them. On a CUDA
    device kernel K10 runs the rounds (words in registers, a bucket sort by
    (word, position)); keys are taken in chunks sized by the device's
    memory.
    """
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    rounds = _rounds(n)
    if out is None:
        dtype = payload.dtype if payload is not None else torch.int32
        out = torch.empty((keys.shape[0], n), dtype=dtype, device=device)
    step = _keys_per_chunk(n, device)
    for c0 in range(0, keys.shape[0], step):
        _shuffle(_round_keys(keys[c0 : c0 + step], rounds), n, device, payload, out[c0 : c0 + step])
    return out


def permutation_columns(keys: np.ndarray, values: torch.Tensor, payload_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Independent permutations of ``values``, one per COLUMN: ``(len(values), n_keys)``.

    Column ``p`` sorts ``values`` by the uint32 words ``random_bits(keys[p],
    (n,))`` with a stable sort: one K10 round with ``keys`` as its subkeys
    and ``values`` as its payload. The words are the JAX package's, and its
    ``lax.sort_key_val`` is stable too, so equal words keep the values'
    order in both and every column is bitwise the JAX package's.
    """
    if payload_dtype is not None:
        values = values.to(payload_dtype)
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint32).reshape(-1, 2))
    return _shuffle([keys], values.shape[0], values.device, values).T.contiguous()


class GroupLayout(NamedTuple):
    """The group-sorted order of a shuffle within groups, made once a call:
    ``order`` (n,) int64, the stable argsort of the group codes (code -1, a
    NaN library, is a group of its own and sorts first), and ``starts``
    (S + 1,) int64, each group's first position in that order, then n.
    ``cache`` keeps what the card's kernels make of it (the order and the
    tile table on the device), so every chunk of a call reuses them."""

    order: np.ndarray
    starts: np.ndarray
    cache: dict


def _narrowest_codes(groups: np.ndarray) -> np.ndarray:
    """Integer codes cast to the narrowest signed type that holds their range
    (int8, int16, else int32; wider codes as they are): numpy's stable
    argsort takes its radix path for 8- and 16-bit integers, and the same
    values sort into the same stable order at any width."""
    if not np.issubdtype(groups.dtype, np.integer) or not len(groups):
        return groups
    lo, hi = int(groups.min()), int(groups.max())
    for dtype in (np.int8, np.int16, np.int32):
        info = np.iinfo(dtype)
        if info.min <= lo and hi <= info.max:
            return groups.astype(dtype, copy=False)
    return groups


def group_layout(groups: np.ndarray) -> GroupLayout:
    """The :class:`GroupLayout` of ``groups`` (integer codes), as the JAX
    package orders them: a stable argsort, the codes compared as int32
    (sorted at the narrowest width that holds them, the same order)."""
    groups = np.asarray(groups)
    order = np.argsort(_narrowest_codes(groups), kind="stable")
    sorted_codes = groups[order].astype(np.int32)
    if np.any(sorted_codes[1:] < sorted_codes[:-1]):
        raise ValueError("Group codes must fit in int32.")
    starts = np.flatnonzero(np.r_[True, sorted_codes[1:] != sorted_codes[:-1]]) if len(groups) else np.zeros(0, int)
    return GroupLayout(order=order, starts=np.append(starts, len(groups)).astype(np.int64), cache={})


_TILE = 4096  # items a sub-tile of K10g's scatter (csrc/threefry.cu kTile)
_MIN_FINE_BITS = 8  # a segment's fine buckets: at least 2^8, so a 32-bit key has 8 free bits
_PACKED_MAX_BITS = 11  # the packed route's fine bits, at most (csrc/threefry.cu kPackedMaxBits)
_GROUP_BUCKET_MEAN = 3072  # items a coarse bucket of K10g on average, at most: far below its 4096-key sort
_TILES_MAX = 256  # tiles a segment, at most (csrc/threefry.cu kTilesMax)
_BOUNDS_MAX = 768  # a coarse bucket's (fine buckets + 1) x tiles, at most (csrc/threefry.cu kBoundsMax)


class _GroupedDevice(NamedTuple):
    """K10g's layout on the card (:func:`_group_tiles`): ``tiles`` (n_tiles,
    4), ``segs`` (S, 4) and ``coarse`` (nbc, 2) int32; ``order`` (n,)
    int32; a row's bucket starts ``n_starts`` and the largest fine bits
    ``max_bits``."""

    tiles: torch.Tensor
    segs: torch.Tensor
    coarse: torch.Tensor
    order: torch.Tensor
    n_starts: int
    max_bits: int


def _coarse_bits(n: int) -> int:
    """K10g's coarse bits of a segment of n items: the fewest (at most
    :data:`_MAX_BITS`) that leave a bucket at most :data:`_GROUP_BUCKET_MEAN`
    items on average."""
    bits = 0
    while (_GROUP_BUCKET_MEAN << bits) < n and bits < _MAX_BITS:
        bits += 1
    return bits


def _group_tiles(starts: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """K10g's host layout from the segment bounds: ``(tiles, segs, coarse,
    n_starts, max_bits)``. A segment of L items has :func:`_coarse_bits` (L)
    coarse bits ``nat`` (a block of the sort each coarse bucket) and ``fb =
    max(nat, 8)`` fine bits (the buckets of the scatter); its items are cut
    into tiles of ``4096 << (fb - 8)`` (more, in sub-tiles of 4096, where
    that leaves more than 256 tiles), so a row holds about one bucket start
    a 16 items. ``tiles`` (n_tiles, 4): segment, first position, count, the
    tile's first bucket start in a row (2^fb + 1 a tile); ``segs`` (S, 4):
    first tile, tiles, ``fb``, ``nat``; ``coarse`` (nbc, 2): segment, coarse
    bucket of it."""
    lengths = np.diff(starts)
    nat = np.array([_coarse_bits(int(length)) for length in lengths], dtype=np.int64)
    fb = np.maximum(nat, _MIN_FINE_BITS)
    tile = np.maximum(np.left_shift(_TILE, fb - _MIN_FINE_BITS), -(-lengths // (_TILES_MAX * _TILE)) * _TILE)
    per_seg = -(-lengths // tile)
    seg = np.repeat(np.arange(len(lengths)), per_seg)
    within = np.arange(len(seg)) - np.repeat(np.cumsum(per_seg) - per_seg, per_seg)
    first = starts[seg] + tile[seg] * within
    count = np.minimum(tile[seg], starts[seg + 1] - first)
    width = np.left_shift(1, fb[seg]) + 1
    sbase = np.cumsum(width) - width
    if width.sum() >= 2**31 - 1:
        raise ValueError(f"K10g keeps {int(width.sum())} bucket starts a row: more than int32 holds.")
    if np.any(per_seg * (np.left_shift(1, fb - nat) + 1) > _BOUNDS_MAX):
        raise ValueError("K10g: a coarse bucket's tiles and fine buckets overflow the sort's shared bounds.")
    tiles = np.stack([seg, first, count, sbase], axis=1).astype(np.int32)
    segs = np.stack([np.cumsum(per_seg) - per_seg, per_seg, fb, nat], axis=1).astype(np.int32)
    widths = np.left_shift(1, nat)
    coarse_seg = np.repeat(np.arange(len(lengths)), widths)
    coarse = np.stack([coarse_seg, np.arange(len(coarse_seg)) - np.repeat(np.cumsum(widths) - widths, widths)],
                      axis=1).astype(np.int32)
    return tiles, segs, coarse, int(width.sum()), int(fb.max(initial=_MIN_FINE_BITS))


def _cached(layout: GroupLayout, key: tuple, make):
    """``make()`` once for ``layout``: kept in its ``cache``."""
    if key not in layout.cache:
        layout.cache[key] = make()
    return layout.cache[key]


def _device_order(layout: GroupLayout, device: torch.device) -> torch.Tensor:
    """The group-sorted order on ``device`` as int32 (the kernels' type; it
    indexes as well), narrowed there, made once a layout."""
    return _cached(layout, ("order", str(device)), lambda: torch.from_numpy(layout.order).to(device).to(torch.int32))


def _grouped_device(layout: GroupLayout, device: torch.device) -> _GroupedDevice:
    def make():
        tiles, segs, coarse, n_starts, max_bits = _group_tiles(layout.starts)
        return _GroupedDevice(*(torch.from_numpy(a).to(device) for a in (tiles, segs, coarse)),
                              _device_order(layout, device), n_starts, max_bits)
    return _cached(layout, ("tiles", str(device)), make)


def _packed_route(vsorted: torch.Tensor, dev: _GroupedDevice) -> bool:
    """K10g's route: uint8 values ride in 32-bit keys below 2^24 items when
    every segment's fine bits are at most 11 (segments up to 2^22 items);
    other payloads (int32, int64, uint8 past those limits) are gathered at
    the positions that 64-bit keys carry."""
    return vsorted.element_size() == 1 and vsorted.shape[0] < _PACKED_MAX_N and dev.max_bits <= _PACKED_MAX_BITS


def _grouped_bytes(n: int, dev: _GroupedDevice, packed: bool, out_bytes: int) -> int:
    """Bytes a shuffled value takes on the card in K10g: its key (4 or 8),
    its output, and its share of the row's bucket starts."""
    return (4 if packed else 8) + out_bytes + -(-4 * dev.n_starts // max(n, 1))


def _shuffle_grouped_plain(keys: np.ndarray, layout: GroupLayout, vsorted: torch.Tensor, out: torch.Tensor,
                           mask: int = _FULL_MASK) -> torch.Tensor:
    """Plain torch version of K10's grouped entry: one ``torch.sort(stable=True)``
    of the int64 keys ``(segment << 32) | word`` a row, the values in
    group-sorted order gathered at the sorted positions, and each row's
    slots written back at their original rows ``order``."""
    n = vsorted.shape[0]
    device = out.device
    w = _threefry_plain(torch.from_numpy(keys.view(np.int32)).to(device), n)
    if mask != _FULL_MASK:
        w = w & _as_int32(mask)
    rank = torch.from_numpy(np.repeat(np.arange(len(layout.starts) - 1), np.diff(layout.starts))).to(device)
    idx = torch.sort((rank << 32) | (w.to(torch.int64) & _MASK32), dim=1, stable=True).indices
    out[:, torch.from_numpy(layout.order).to(device)] = vsorted[idx]
    return out


def _shuffle_grouped_k10(keys: np.ndarray, dev: _GroupedDevice, vsorted: torch.Tensor, out: torch.Tensor, mask: int,
                         cap: int, stats: dict | None = None, fused: bool = True) -> None:
    """K10g into ``out`` ``(rows, ld >= n)``: the scatter and the sort (two
    launches), then one read of the sort's overflow count (the one wait a
    chunk) and, for coarse buckets past ``cap``, the overflow sort (a
    third). The route is :func:`_packed_route`'s; the sort writes each slot
    at its original row (or, with ``fused`` off, at its group-sorted slot).
    Given ``stats``, each step is timed by CUDA events, and the coarse
    buckets a row, the largest and the overflowing ones are recorded."""
    rows, n, device = out.shape[0], vsorted.shape[0], out.device
    packed = _packed_route(vsorted, dev)
    starts = torch.empty((rows, dev.n_starts), dtype=torch.int32, device=device)
    overflow = torch.empty((rows * dev.coarse.shape[0], 2), dtype=torch.int64, device=device)
    st = torch.empty(4, dtype=torch.int64, device=device)
    tmp = torch.empty((rows, n), dtype=torch.int32 if packed else torch.int64, device=device)
    keys_t = torch.from_numpy(keys.view(np.int32)).to(device)
    layout = (dev.tiles.data_ptr(), dev.tiles.shape[0], dev.segs.data_ptr(), dev.coarse.data_ptr(),
              dev.coarse.shape[0], dev.n_starts, dev.max_bits)
    epilogue = (dev.order.data_ptr() if fused else None, vsorted.data_ptr(), vsorted.element_size(), int(packed),
                out.data_ptr(), out.stride(0))
    steps = (("scatter", ("sqt_shuffle_gscatter", keys_t.data_ptr(), rows, n, mask, *layout,
                          vsorted.data_ptr() if packed else None, starts.data_ptr(), tmp.data_ptr())),
             ("sort", ("sqt_shuffle_gsort", tmp.data_ptr(), starts.data_ptr(), *layout, rows, n, cap, *epilogue,
                       overflow.data_ptr(), st.data_ptr())))
    events = [_event()] if stats is not None else None
    for _, call in steps:
        _launch(*call, kernel="threefry_grouped")
        if events is not None:
            events.append(_event())
    n_over, largest, total, _ = st.tolist()  # waits for the chunk
    if n_over:
        scratch = torch.empty(total, dtype=torch.int64, device=device)
        _launch("sqt_shuffle_goverflow", tmp.data_ptr(), starts.data_ptr(), *layout, rows, n, overflow.data_ptr(),
                n_over, scratch.data_ptr(), *epilogue, kernel="threefry_grouped")
    if stats is not None:
        if n_over:
            events.append(_event())
        torch.cuda.synchronize(device)
        stats.setdefault("overflow", []).append(n_over)
        stats.setdefault("largest_bucket", []).append(largest)
        stats["buckets"] = dev.coarse.shape[0]
        names = [name for name, _ in steps] + (["overflow"] if n_over else [])
        for name, a, b in zip(names, events, events[1:]):
            stats.setdefault(f"{name}_ms", []).append(a.elapsed_time(b))


def _shuffle_grouped(keys: np.ndarray, layout: GroupLayout, vsorted: torch.Tensor, out: torch.Tensor,
                     device: torch.device, *, mask: int = _FULL_MASK, stats: dict | None = None,
                     fused: bool = True) -> torch.Tensor:
    """Each row of ``out`` ``(n_keys, ld >= n)``: ``vsorted`` (the values in
    group-sorted order) sorted within each segment by the words of its key,
    written at the original rows. K10's grouped entry on a CUDA device, keys
    in chunks sized by the card's memory and the route's bytes a value
    (``stats`` and ``fused`` as in :func:`_shuffle_grouped_k10`); its plain
    version on the CPU. ``mask`` ands every word (ties, in tests)."""
    n = vsorted.shape[0]
    dev = None
    per_value = _BYTES_PER_VALUE
    if device.type == "cuda":
        if n >= 2**31 - 1:
            raise ValueError(f"K10 writes int32 positions: at most 2^31 - 2 items, found {n}.")
        if vsorted.element_size() not in (1, 4, 8):
            raise TypeError(f"K10 moves payloads of 1, 4 or 8 bytes, found {vsorted.dtype}.")
        _cuda.require(vsorted, "values", vsorted.dtype, (n,))
        _cuda.require(out, "out", vsorted.dtype)
        dev = _grouped_device(layout, out.device)
        per_value = _grouped_bytes(n, dev, _packed_route(vsorted, dev), out.element_size())
    step = _keys_per_chunk(n, device, per_value)
    for c0 in range(0, keys.shape[0], step):
        if dev is None:
            _shuffle_grouped_plain(keys[c0 : c0 + step], layout, vsorted, out[c0 : c0 + step], mask)
        else:
            _shuffle_grouped_k10(keys[c0 : c0 + step], dev, vsorted, out[c0 : c0 + step], mask, _SORT_CAP, stats,
                                 fused)
    return out


def shuffle_group_columns(keys: np.ndarray, values: torch.Tensor, groups: np.ndarray | None = None,
                          payload_dtype: torch.dtype | None = None, *, layout: GroupLayout | None = None
                          ) -> torch.Tensor:
    """Batched within-group permutations, one per COLUMN: ``(len(values), n_keys)``
    (counterpart of ``squidpy_tpu/_core/rng.py`` ``shuffle_group_columns``).

    Values move only within their group (library). Word ``j`` of key ``p``,
    ``random_bits(keys[p], (n,))[j]``, belongs to position ``j`` of the
    group-sorted order; each group's segment is sorted stably by word, and
    each column goes back to the original row order: bitwise the JAX
    package's two-key ``lax.sort``. ``layout`` (:func:`group_layout` of
    ``groups``) may be made once and passed for every call. On a CUDA
    device K10's grouped entry sorts all segments of a row at once, keys in
    chunks sized by the card's memory; on the CPU its plain version.
    """
    if payload_dtype is not None:
        values = values.to(payload_dtype)
    if layout is None:
        layout = group_layout(groups)
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint32).reshape(-1, 2))
    n, device = values.shape[0], values.device
    if layout.order.shape != (n,):
        raise ValueError(f"`groups` must have one code a value ({n}), found {layout.order.shape[0]}.")
    out = torch.empty((keys.shape[0], n), dtype=values.dtype, device=device)
    if n and keys.shape[0]:
        with record_function("shuffle_group_columns.device_layout"):
            order = _device_order(layout, device)
        with record_function("shuffle_group_columns.values_order"):
            vsorted = values[order].contiguous()
        with record_function("shuffle_group_columns.shuffle"):
            _shuffle_grouped(keys, layout, vsorted, out, device)
    with record_function("shuffle_group_columns.transpose"):
        return out.T.contiguous()
