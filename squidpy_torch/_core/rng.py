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
(:func:`permutation_batch`, :func:`permutation_columns`); its plain torch
version, on the CPU, draws the words with :func:`_threefry_plain` and sorts
them with ``torch.sort(stable=True)``. :func:`threefry_bits` is K10's word
entry alone. Everything downstream (shuffles, counts, z-scores) is bitwise
equal to the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from squidpy_torch import _cuda

__all__ = [
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


def _keys_per_chunk(n: int, device: torch.device) -> int:
    """Keys a chunk of :func:`permutation_batch`: K10's scratch and outputs
    take :data:`_BYTES_PER_VALUE` bytes a value; a quarter of the card's free
    memory (at most 8 GiB), or 512 MiB on the CPU. The chunking never
    changes a result."""
    if device.type == "cuda":
        budget = min(torch.cuda.mem_get_info(device)[0] // 4, 8 << 30)
    else:
        budget = 512 << 20
    return max(1, int(budget // (_BYTES_PER_VALUE * max(n, 1))))


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


def _launch(entry: str, *args: object) -> None:
    """One call into K10's C interface, counted as one launch of K10."""
    _cuda.check(getattr(_cuda.library(), entry)(*args, _cuda.stream_ptr()), "threefry_shuffle")
    _cuda.launches["threefry_shuffle"] += 1


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


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
        events = [_event()] if stats is not None else None
        for _, call in steps:
            _launch(*call)
            if events is not None:
                events.append(_event())
        if stats is not None:
            n_over, largest = st.tolist()  # waits for the round
            stats.setdefault("overflow", []).append(n_over)
            stats.setdefault("largest_bucket", []).append(largest)
            stats["buckets"] = nb
            for (name, _), a, b in zip(steps, events, events[1:]):
                stats.setdefault(f"{name}_ms", []).append(a.elapsed_time(b))
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


def shuffle_group_columns(*args: object, **kwargs: object) -> torch.Tensor:
    """Library-stratified shuffles (``library_key``) are not ported yet."""
    raise NotImplementedError(
        "Library-stratified shuffles (`library_key`) are not ported to squidpy_torch yet; "
        "see ROADMAP.md, queue 1, 'library_key shuffles'."
    )
