"""Deterministic keyed RNG fan-out (counterpart of ``squidpy_tpu/_core/rng.py``).

``seed`` plus permutation index fully determines each shuffle, independent
of chunking. The keys are JAX's own: a numpy port of ``threefry2x32`` and of
``jax.random.PRNGKey``/``split``/``bits`` as JAX computes them with
``jax_threefry_partitionable`` on (the default since JAX 0.5): ``split`` and
``bits`` hash the 64-bit iota of the output shape, split into two uint32
words, and 32-bit ``bits`` are the XOR of the two output words. The keys are
a few thousand words per call, so they are made on the host; everything
downstream (shuffles, counts, z-scores) is then bitwise equal to the JAX
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "permutation_batch",
    "permutation_columns",
    "random_bits",
    "shuffle_group_columns",
    "spawn_keys",
    "split_keys",
    "threefry2x32",
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


def permutation_batch(keys: np.ndarray, n: int, device: torch.device) -> torch.Tensor:
    """``(n_keys, n)`` int32 index permutations, row ``p`` bitwise equal to
    ``jax.random.permutation(keys[p], n)``.

    JAX shuffles by ``ceil(3 ln n / ln(2^32 - 1))`` rounds (2 at n = 3000):
    each round splits the key, draws 32-bit words from the subkey and stably
    sorts the running permutation by them. The words are made on the host,
    the stable sorts run on ``device``; keys are taken in chunks so the host
    words stay within ~32 MB.
    """
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    uint32max = np.iinfo(np.uint32).max
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
    step = max(1, (1 << 22) // max(n, 1))
    parts = []
    for c0 in range(0, keys.shape[0], step):
        key = keys[c0 : c0 + step]
        x = torch.arange(n, dtype=torch.int64, device=device).expand(key.shape[0], n)
        for _ in range(rounds):
            key, sub = np.moveaxis(split_keys(key), -2, 0)
            words = torch.from_numpy(random_bits(sub, (n,)).astype(np.int64)).to(device)
            x = torch.gather(x, 1, torch.sort(words, dim=1, stable=True).indices)
        parts.append(x.to(torch.int32))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def permutation_columns(keys: np.ndarray, values: torch.Tensor, payload_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Independent permutations of ``values``, one per COLUMN: ``(len(values), n_keys)``.

    Column ``p`` sorts ``values`` by the uint32 words ``random_bits(keys[p],
    (n,))`` with a stable sort. The words are the JAX package's, and its
    ``lax.sort_key_val`` is stable too, so equal words keep the values'
    order in both and every column is bitwise the JAX package's.
    """
    if payload_dtype is not None:
        values = values.to(payload_dtype)
    n = values.shape[0]
    u = torch.from_numpy(random_bits(keys, (n,)).astype(np.int64)).to(values.device)
    order = torch.sort(u, dim=1, stable=True).indices
    return values[order].T.contiguous()


def shuffle_group_columns(*args: object, **kwargs: object) -> torch.Tensor:
    """Library-stratified shuffles (``library_key``) are not ported yet."""
    raise NotImplementedError(
        "Library-stratified shuffles (`library_key`) are not ported to squidpy_torch yet; "
        "see ROADMAP.md, queue 1, 'library_key shuffles'."
    )
