"""squidpy_torch keys against jax.random (``_core/rng.py``).

Tolerance: bitwise. The port computes JAX's threefry keys on the host in
numpy, so every word must be equal.
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


def test_shuffle_group_columns_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trng.shuffle_group_columns(None, None, None)
