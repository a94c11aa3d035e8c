"""O(n) keyed index-cipher permutations (counterpart of ``squidpy_tpu/_core/index_cipher.py``).

``shuffled[i, p] = L(pi_p(i))``: ``pi_p`` is an alternating Feistel cipher on
``Z_a x Z_b`` (``a = ceil(sqrt(n))``, ``b = ceil(n / a)``), cycle-walked into
``[0, n)``, and ``L(t) = #{class boundaries <= t}``. Round keys are the JAX
package's (``random_bits`` of each permutation key), so every column is
bitwise equal to ``squidpy_tpu``'s.

On a CUDA tensor the cipher runs as kernel K4 (``csrc/index_cipher.cu``), one
thread per (i, p). On the CPU it runs the plain torch version below, in int64
with 32-bit masks because torch has no uint32 shifts, division or modulo on
the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from squidpy_torch import _cuda
from squidpy_torch._core.rng import random_bits
from squidpy_torch._device import get_device

__all__ = ["MIN_CIPHER_N", "cipher_index_batch", "cipher_label_columns", "cipher_columns"]

# same dispatch threshold as the JAX package: below it the sort-based
# generator is used
MIN_CIPHER_N = 65_536

DEFAULT_ROUNDS = 8

_MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B

_KIND_U8_LABELS, _KIND_I32_LABELS, _KIND_POSITIONS = 0, 1, 2


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2^32`` for ``0 <= x < 2^32`` without int64 overflow."""
    lo = (x & 0xFFFF) * m
    hi = (((x >> 16) * m) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _radices(n: int) -> tuple[int, int]:
    a = math.isqrt(n - 1) + 1 if n > 1 else 1
    b = -(-n // a)
    return a, b


def _encrypt(y: torch.Tensor, round_keys: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """One cipher pass on ``[0, a*b)``; ``y`` (n, P) and ``round_keys`` (R, P) int64."""
    u = y % a
    v = y // a
    for r in range(round_keys.shape[0]):
        rk = round_keys[r][None, :]
        if r % 2 == 0:
            u = (u + _mix32(v ^ rk) % a) % a
        else:
            v = (v + _mix32(u ^ rk) % b) % b
    return v * a + u


def _walked(y: torch.Tensor, round_keys: torch.Tensor, a: int, b: int, n: int) -> torch.Tensor:
    """Cycle-walk out-of-range lanes until the whole slab lies in [0, n)."""
    y = _encrypt(y, round_keys, a, b)
    if a * b == n:
        return y
    while bool((y >= n).any()):
        y = torch.where(y >= n, _encrypt(y, round_keys, a, b), y)
    return y


def _cipher_plain(round_keys: torch.Tensor, n: int, edges: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain torch version of K4: ``(n, P)`` labels, or positions when ``edges`` is None."""
    a, b = _radices(n)
    rk = round_keys.to(torch.int64)
    y = torch.arange(n, dtype=torch.int64, device=rk.device)[:, None].expand(n, rk.shape[1])
    pos = _walked(y, rk, a, b, n)
    if edges is None:
        return pos.to(out_dtype)
    return torch.searchsorted(edges.to(torch.int64), pos, right=True).to(out_dtype)


def cipher_columns(
    round_keys: torch.Tensor, n: int, edges: torch.Tensor | None, out_dtype: torch.dtype
) -> torch.Tensor:
    """Kernel K4: ``(n, P)`` cipher labels (``edges`` = ascending class
    boundaries, int32) or positions (``edges=None``, int32 output).

    ``round_keys`` is ``(R, P)``: int64 holding uint32 values. A CPU tensor
    runs the plain torch version; a CUDA tensor launches the kernel.
    """
    if round_keys.device.type == "cpu":
        return _cipher_plain(round_keys, n, edges, out_dtype)
    rounds, n_cols = round_keys.shape
    if edges is None:
        kind = _KIND_POSITIONS
        if out_dtype != torch.int32:
            raise TypeError(f"cipher positions are int32, not {out_dtype}.")
    else:
        kind = {torch.uint8: _KIND_U8_LABELS, torch.int32: _KIND_I32_LABELS}.get(out_dtype)
        if kind is None:
            raise TypeError(f"cipher labels are uint8 or int32, not {out_dtype}.")
        _cuda.require(edges, "edges", torch.int32)
        if edges.device != round_keys.device:
            raise ValueError("`edges` and `round_keys` must be on the same device.")
    if not 0 < n < 2**32:
        raise ValueError(f"cipher domain size must lie in [1, 2^32), found {n}.")
    # the kernel reads the keys as uint32: the same low 32 bits as int32
    rk = round_keys.to(torch.int64)
    rk32 = torch.where(rk >= 2**31, rk - 2**32, rk).to(torch.int32).contiguous()
    a, b = _radices(n)
    out = torch.empty((n, n_cols), dtype=out_dtype, device=round_keys.device)
    lib = _cuda.library()
    code = lib.sqt_index_cipher(
        rk32.data_ptr(), rounds, n_cols, n, a, b,
        edges.data_ptr() if edges is not None else None, 0 if edges is None else edges.numel(),
        out.data_ptr(), kind, _cuda.stream_ptr(),
    )
    _cuda.check(code, "index_cipher")
    _cuda.launches["index_cipher"] += 1
    return out


def _round_keys(keys: np.ndarray, rounds: int) -> torch.Tensor:
    """(R, P) round keys (uint32 values in int64) on the selected device."""
    rk = random_bits(keys, (rounds,)).T.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(rk)).to(get_device())


def cipher_label_columns(
    keys: np.ndarray,
    class_counts: np.ndarray,
    *,
    rounds: int = DEFAULT_ROUNDS,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Independent uniform arrangements of a label multiset, one per COLUMN.

    Returns ``(n, n_keys)`` labels with ``n = sum(class_counts)``; column ``p``
    holds exactly ``class_counts[c]`` labels ``c``, arranged by the keyed
    bijection of ``keys[p]``.
    """
    counts = np.asarray(class_counts, dtype=np.int64)
    n = int(counts.sum())
    if out_dtype is None:
        out_dtype = torch.uint8 if len(counts) <= 256 else torch.int32
    edges = torch.from_numpy(np.cumsum(counts)[:-1].astype(np.int32)).to(get_device())
    return cipher_columns(_round_keys(keys, rounds), n, edges, out_dtype)


def cipher_index_batch(keys: np.ndarray, n: int, *, rounds: int = DEFAULT_ROUNDS) -> torch.Tensor:
    """Batched index permutations ``(n_keys, n)`` int32: row ``p`` is the keyed
    bijection of ``arange(n)``. The result is the transposed view of the
    ``(n, n_keys)`` table K4 writes, not a copy (4 GB at 1M x 1000)."""
    return cipher_columns(_round_keys(keys, rounds), n, None, torch.int32).T
