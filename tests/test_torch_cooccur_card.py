"""Kernel K17 (``csrc/cooccur_pairs.cu``) against its plain version on the
card, on the branch cases that ``test_torch_cooccur_dense.py`` also runs
through a numpy emulation of its C interface. This file imports no JAX: it
is the one to run where there is a card. Counts are compared bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from squidpy_torch.ops.cooccur import cooccur_block_pairs, cooccur_pairs


def _k17_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray, int]]:
    """K17's branches at test size: many classes, one class, 3-D, 1-D and
    5-D, labels outside [0, C), coincident points against a threshold of 0,
    NaN and inf coordinates, repeated thresholds, two and three thresholds
    within a bucket (the walk) and more thresholds than the table's buckets
    (the index route), n = 2 and one past a column tile; and orders the class order
    rearranges: labels descending with the index, one class holding every
    other point, an empty class beside a one-point class, and one class
    past a column tile among small ones."""
    rng = np.random.default_rng(17)
    uni = rng.uniform(0, 100, (600, 2)).astype(np.float32)
    lin = (np.linspace(1.0, 60.0, 49) ** 2).astype(np.float32)
    nan = uni.copy()
    nan[rng.integers(0, 600, 30), rng.integers(0, 2, 30)] = np.nan
    nan[[3, 9], 0] = np.inf
    bad = rng.integers(-3, 8, 600).astype(np.int32)  # -3..-1 and 5..7 lie outside [0, 5)
    coincident = np.repeat(rng.uniform(0, 50, (150, 2)), 4, axis=0).astype(np.float32)
    close = np.sort(np.r_[lin, lin[20] + np.float32(1e-3), np.nextafter(lin[30], np.float32(np.inf))]).astype(
        np.float32)
    three = np.sort(np.r_[lin, lin[20] + np.float32(1e-3), lin[20] + np.float32(2e-3)]).astype(np.float32)
    one_point = rng.choice(np.int32([0, 1, 2, 4]), 600)  # class 3 empty
    one_point[rng.integers(0, 600)] = 5
    big_class = rng.uniform(0, 250, (1500, 2)).astype(np.float32)
    return [
        ("C=5", uni, rng.integers(0, 5, 600).astype(np.int32), lin, 5),
        ("C=200, global atomics", uni, rng.integers(0, 200, 600).astype(np.int32), lin, 200),
        ("one class", uni, np.zeros(600, np.int32), lin, 1),
        ("3-D", rng.uniform(0, 60, (500, 3)).astype(np.float32), rng.integers(0, 4, 500).astype(np.int32), lin, 4),
        ("1-D", rng.uniform(0, 300, (500, 1)).astype(np.float32), rng.integers(0, 3, 500).astype(np.int32), lin, 3),
        ("5-D", rng.uniform(0, 40, (400, 5)).astype(np.float32), rng.integers(0, 3, 400).astype(np.int32), lin, 3),
        ("labels outside [0, C)", uni, bad, lin, 5),
        ("coincident, threshold 0", coincident, rng.integers(0, 3, 600).astype(np.int32),
         np.float32([0.0, 0.0, 1.0, 400.0]), 3),
        ("NaN and inf coordinates", nan, rng.integers(0, 4, 600).astype(np.int32), lin, 4),
        ("repeated thresholds", uni, rng.integers(0, 4, 600).astype(np.int32),
         np.float32([0, 0, 25, 25, 25, 100, 100, 400, 3000]), 4),
        ("thresholds within a bucket", uni, rng.integers(0, 4, 600).astype(np.int32), close, 4),
        ("three thresholds within a bucket", uni, rng.integers(0, 4, 600).astype(np.int32), three, 4),
        ("more thresholds than a table's buckets", uni, rng.integers(0, 3, 600).astype(np.int32),
         np.sort(rng.uniform(0, 3600, 3000)).astype(np.float32), 3),
        ("n = 2", uni[:2], np.int32([0, 1]), lin, 2),
        ("one past a column tile", rng.uniform(0, 200, (1025, 2)).astype(np.float32),
         rng.integers(0, 3, 1025).astype(np.int32), lin, 3),
        ("labels descending with the index", uni, (5 - np.arange(600) * 6 // 600).astype(np.int32), lin, 6),
        ("one class holds every other point", uni,
         np.where(np.arange(600) % 2 == 0, 0, rng.integers(1, 5, 600)).astype(np.int32), lin, 5),
        ("an empty class and a one-point class", uni, one_point, lin, 6),
        ("a class past a column tile", big_class, np.where(np.arange(1500) < 1100, 1, rng.integers(0, 3, 1500)).astype(
            np.int32), lin, 3),
    ]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
def test_k17_matches_plain_on_card(cuda_card):
    for name, pts, labs, thr, n_cls in _k17_cases():
        p, lab = torch.from_numpy(pts), torch.from_numpy(labs)
        want = cooccur_block_pairs(p, lab, torch.from_numpy(thr), n_cls, 256)
        got = cooccur_pairs(p.cuda(), lab.cuda(), thr, n_cls)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(), err_msg=name)
