"""Deterministic keyed RNG fan-out (counterpart of ``squidpy_tpu/_core/rng.py``).

``seed`` plus permutation index fully determines each shuffle, independent
of chunking. The keys are JAX's own: a numpy port of ``threefry2x32`` and of
``jax.random.PRNGKey``/``split``/``bits`` as JAX computes them with
``jax_threefry_partitionable`` on (the default since JAX 0.5): ``split`` and
``bits`` hash the 64-bit iota of the output shape, split into two uint32
words, and 32-bit ``bits`` are the XOR of the two output words. The keys are
a few thousand words per call, so they are made on the host (``spawn_keys``,
``split_keys``); the sort words of the shuffles, up to 2e9 a call, are made
on the device by :func:`random_bits_device` (kernel K10, ``csrc/threefry.cu``,
on a CUDA device; a plain torch version on the CPU). Everything downstream
(shuffles, counts, z-scores) is then bitwise equal to the JAX package.
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
    """Kernel K10: ``(n_keys, n)`` int32 bit patterns of the threefry words of
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
    _cuda.check(code, "threefry_bits")
    _cuda.launches["threefry_bits"] += 1
    return out


def random_bits_device(keys: np.ndarray, n: int, device: torch.device, *, sort_keys: bool = False) -> torch.Tensor:
    """The words of :func:`random_bits` ``(keys, (n,))`` as a ``(n_keys, n)``
    int32 tensor of their bit patterns on ``device`` (kernel K10 on a CUDA
    device). With ``sort_keys`` each word is xor-ed with 0x80000000: a
    signed stable sort of the result is the unsigned stable sort of the
    words."""
    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint32).reshape(-1, 2))
    return threefry_bits(torch.from_numpy(keys.view(np.int32)).to(device), n, flip=sort_keys)


def _keys_per_chunk(n: int, device: torch.device) -> int:
    """Keys a chunk of :func:`permutation_batch`: its words, the sort's
    output and indices and the running permutation take ~32 bytes a value;
    a quarter of the card's free memory (at most 8 GiB), or 512 MiB on the
    CPU. The chunking never changes a result."""
    if device.type == "cuda":
        budget = min(torch.cuda.mem_get_info(device)[0] // 4, 8 << 30)
    else:
        budget = 512 << 20
    return max(1, int(budget // (32 * max(n, 1))))


def permutation_batch(keys: np.ndarray, n: int, device: torch.device) -> torch.Tensor:
    """``(n_keys, n)`` int32 index permutations, row ``p`` bitwise equal to
    ``jax.random.permutation(keys[p], n)``.

    JAX shuffles by ``ceil(3 ln n / ln(2^32 - 1))`` rounds (1 below n = 1626,
    2 up to ~2.6M): each round splits the key, draws 32-bit words from the
    subkey and stably sorts the running permutation by them. The words are
    made on ``device`` (:func:`random_bits_device`) as int32 sort keys, and
    the stable sorts run there; keys are taken in chunks sized by the
    device's memory.
    """
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    uint32max = np.iinfo(np.uint32).max
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
    step = _keys_per_chunk(n, device)
    parts = []
    for c0 in range(0, keys.shape[0], step):
        key = keys[c0 : c0 + step]
        x = None
        for _ in range(rounds):
            key, sub = np.moveaxis(split_keys(key), -2, 0)
            order = torch.sort(random_bits_device(sub, n, device, sort_keys=True), dim=1, stable=True).indices
            x = order if x is None else torch.gather(x, 1, order)
        if x is None:  # n <= 1: no round
            x = torch.zeros((key.shape[0], n), dtype=torch.int64, device=device)
        parts.append(x.to(torch.int32))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def permutation_columns(keys: np.ndarray, values: torch.Tensor, payload_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Independent permutations of ``values``, one per COLUMN: ``(len(values), n_keys)``.

    Column ``p`` sorts ``values`` by the uint32 words ``random_bits(keys[p],
    (n,))`` (made on ``values``' device, :func:`random_bits_device`) with a
    stable sort. The words are the JAX package's, and its
    ``lax.sort_key_val`` is stable too, so equal words keep the values'
    order in both and every column is bitwise the JAX package's.
    """
    if payload_dtype is not None:
        values = values.to(payload_dtype)
    n = values.shape[0]
    u = random_bits_device(keys, n, values.device, sort_keys=True)
    order = torch.sort(u, dim=1, stable=True).indices
    return values[order].T.contiguous()


def shuffle_group_columns(*args: object, **kwargs: object) -> torch.Tensor:
    """Library-stratified shuffles (``library_key``) are not ported yet."""
    raise NotImplementedError(
        "Library-stratified shuffles (`library_key`) are not ported to squidpy_torch yet; "
        "see ROADMAP.md, queue 1, 'library_key shuffles'."
    )
