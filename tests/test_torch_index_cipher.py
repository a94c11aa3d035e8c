"""squidpy_torch index cipher against squidpy_tpu's (``_core/index_cipher.py``).

Tolerance: bitwise. Round keys are the JAX package's, and the plain torch
cipher reproduces its uint32 arithmetic in int64 with masks, so every label
and position must be equal. The CUDA kernel (K4) is held to the plain
version on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import squidpy_torch as sqt
from squidpy_torch._core import index_cipher as tic
from squidpy_torch._core.rng import spawn_keys
from squidpy_tpu._core import index_cipher as jic
from squidpy_tpu._core.rng import spawn_keys as jax_spawn_keys

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _counts(n: int, n_cls: int, seed: int) -> np.ndarray:
    return np.bincount(np.random.default_rng(seed).integers(0, n_cls, n), minlength=n_cls)


@pytest.mark.parametrize("n_cls", [1, 3, 16])
@pytest.mark.parametrize("n_cols", [1, 5])
@pytest.mark.parametrize("n", [2, 1000, 70_001])
def test_cipher_label_columns_match_jax(n, n_cols, n_cls):
    a, b = tic._radices(n)
    assert (a * b != n) == (n != 2)  # 1000 and 70_001 cycle-walk, 2 = 2 x 1 does not
    counts = _counts(n, n_cls, seed=n + n_cols + n_cls)
    want = np.asarray(jic.cipher_label_columns(jax_spawn_keys(7, n_cols), counts))
    got = tic.cipher_label_columns(spawn_keys(7, n_cols), counts).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_cols", [1, 5])
@pytest.mark.parametrize("n", [2, 1000, 70_001])
def test_cipher_index_batch_match_jax(n, n_cols):
    want = np.asarray(jic.cipher_index_batch(jax_spawn_keys(3, n_cols), n))
    got = tic.cipher_index_batch(spawn_keys(3, n_cols), n).numpy()
    assert got.dtype == np.int32 and got.shape == (n_cols, n)
    np.testing.assert_array_equal(got, want)


def test_many_classes_int32_labels_match_jax():
    counts = np.full(300, 4)
    want = np.asarray(jic.cipher_label_columns(jax_spawn_keys(0, 2), counts))
    got = tic.cipher_label_columns(spawn_keys(0, 2), counts).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_mul32_and_mix32_match_uint32():
    x = np.random.default_rng(0).integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    got = tic._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    want = np.asarray(jic._mix32(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_sort_path_label_multisets():
    """Below MIN_CIPHER_N the shuffles sort threefry words; every column keeps
    the label multiset."""
    from squidpy_torch._core.rng import permutation_columns

    n = tic.MIN_CIPHER_N - 1
    labels = np.random.default_rng(1).integers(0, 7, n).astype(np.int32)
    cols = permutation_columns(spawn_keys(2, 4), torch.from_numpy(labels), payload_dtype=torch.uint8).numpy()
    assert cols.shape == (n, 4) and cols.dtype == np.uint8
    for p in range(4):
        np.testing.assert_array_equal(np.bincount(cols[:, p], minlength=7), np.bincount(labels, minlength=7))


_U32 = np.uint64(0xFFFFFFFF)


def _quot_rem(x: np.ndarray, d: np.ndarray, m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K4's exact reduction, emulated in numpy uint64 as the kernel computes
    it: the high 64 bits of the 96-bit ``m * x`` from two 32 x 32 -> 64
    multiplies, ``x`` itself where ``d = 1``, and ``x - q * d``."""
    x, d, m = (np.asarray(v, dtype=np.uint64) for v in (x, d, m))
    lo = (m & _U32) * x
    hi = (m >> np.uint64(32)) * x + (lo >> np.uint64(32))
    q = np.where(d == 1, x, hi >> np.uint64(32))
    return q, (x - q * d) & _U32


def _multiplier(d: int) -> int:
    return -(-(1 << 64) // d) % (1 << 64)  # ceil(2^64 / d) mod 2^64


def test_fastdiv_emulation_is_exact_for_every_divisor():
    """Every divisor a radix can take (1..65,536) on the numerators 0, d - 1,
    d, 2d - 1, 2^32 - 1 and 64 random 32-bit values each."""
    d = np.arange(1, 65_537, dtype=np.uint64)
    m = np.array([_multiplier(int(v)) for v in d], dtype=np.uint64)
    rand = np.random.default_rng(0).integers(0, 2**32, (d.size, 64), dtype=np.uint64)
    edge = np.stack([np.zeros_like(d), d - 1, d, 2 * d - 1, np.full_like(d, 2**32 - 1)], axis=1)
    x = np.concatenate([edge, rand], axis=1)
    q, r = _quot_rem(x, d[:, None], m[:, None])
    np.testing.assert_array_equal(q, x // d[:, None])
    np.testing.assert_array_equal(r, x % d[:, None])


@pytest.mark.parametrize("n", [65_536, 1_000_000, 1_000_003, 2**32 - 1])
def test_host_multipliers_are_the_emulated_ones(n):
    a, b = tic._radices(n)
    assert (a * b != n) == (n in (1_000_003, 2**32 - 1))  # these cycle-walk; 1,000,000 = 1000 x 1000
    assert a <= 65_536 and b <= 65_536  # so the conditional subtraction cannot wrap
    x = np.concatenate([np.random.default_rng(n).integers(0, a * b, 4096, dtype=np.uint64), [0, a * b - 1]])
    for d in (a, b):
        assert tic._fastdiv_multiplier(d) == _multiplier(d)
        q, r = _quot_rem(x, d, tic._fastdiv_multiplier(d))
        np.testing.assert_array_equal(q, x // np.uint64(d))
        np.testing.assert_array_equal(r, x % np.uint64(d))


@pytest.mark.parametrize("n_edges", [0, 1, 2, 15, 16, 255, 300])
def test_padded_boundary_search_is_searchsorted(n_edges):
    """K4's label search, emulated: boundaries padded with all-ones to a power
    of two above their count, then one branch-free step per halving."""
    rng = np.random.default_rng(n_edges)
    n = 1_000_003
    edges = np.sort(rng.integers(0, n + 1, n_edges)).astype(np.uint64)  # equal boundaries too
    pad = 1
    while pad <= n_edges:
        pad *= 2
    bounds = np.concatenate([edges, np.full(pad - n_edges, 2**32 - 1, np.uint64)])
    y = np.concatenate([rng.integers(0, n, 2000), edges.astype(np.int64), np.maximum(edges.astype(np.int64) - 1, 0),
                        [0, n - 1]]).astype(np.uint64)
    lo = np.zeros(y.size, dtype=np.int64)
    step = pad // 2
    while step:
        lo += np.where(bounds[lo + step - 1] <= y, step, 0)
        step //= 2
    np.testing.assert_array_equal(lo, np.searchsorted(edges, y, side="right"))


@pytest.mark.parametrize("n_cols,pw", [(1, 1), (3, 1), (20, 4), (33, 2), (100, 8), (500, 32), (1000, 32), (64, 32)])
def test_k4_block_columns(n_cols, pw):
    assert tic._k4_block_columns(n_cols) == pw
    assert -(-n_cols // pw) * pw - n_cols <= n_cols / 16


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    """Labels (uint8, int32) and positions against the plain version: a
    cycle-walking n (70,001 and 1,000,003), an n = a * b that does not walk
    (65,536), n = 2 (radix b = 1), and a round count other than 8 (the
    kernel's generic round loop)."""
    with sqt.set_device("cuda"):
        for n, n_cols, rounds in ((70_001, 33, 8), (1_000_003, 5, 8), (65_536, 20, 8), (2, 3, 8), (70_001, 7, 5)):
            counts = _counts(n, 16 if n > 16 else 2, seed=n)
            edges = torch.from_numpy(np.cumsum(counts)[:-1].astype(np.int32)).cuda()
            rk = tic._round_keys(spawn_keys(n % 89, n_cols), rounds)
            for e, dt in ((edges, torch.uint8), (edges.cpu().cuda(), torch.int32), (None, torch.int32)):
                got = tic.cipher_columns(rk, n, e, dt)
                assert torch.equal(got, tic._cipher_plain(rk, n, e, dt)), (n, n_cols, rounds, dt)


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
