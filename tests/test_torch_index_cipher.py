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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_card):
    with sqt.set_device("cuda"):
        counts = _counts(70_001, 16, seed=0)
        edges = torch.from_numpy(np.cumsum(counts)[:-1].astype(np.int32)).cuda()
        rk = tic._round_keys(spawn_keys(0, 33), 8)
        for e, dt in ((edges, torch.uint8), (edges.cpu().cuda(), torch.int32), (None, torch.int32)):
            got = tic.cipher_columns(rk, 70_001, e, dt)
            assert torch.equal(got, tic._cipher_plain(rk, 70_001, e, dt))


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
