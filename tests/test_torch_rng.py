"""squidpy_torch keys against jax.random (``_core/rng.py``).

Tolerance: bitwise. The port computes JAX's threefry keys on the host in
numpy and the sort words on the device (K10, or its plain torch version on
the CPU), so every word must be equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def test_shuffle_group_columns_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trng.shuffle_group_columns(None, None, None)
