"""squidpy_torch's image features (K18-K20's plain versions and
``im.calculate_image_features``) against squidpy_tpu's on the same inputs.

Tolerances, each derived from how JAX computes the value:

- Counts (``graycomatrix``, ``glcm_batch``, both histogram rules) and
  quantiles (both rules): bitwise. The port's quantile weights and its fused
  interpolation (``fma(v_lo, w_lo, v_hi w_hi)`` batched,
  ``fma(v_hi, w_hi, v_lo w_lo)`` per crop) and ``jnp.linspace``'s edges
  reproduce XLA:CPU's rounding, which the tests here pin.
- GLCM props: JAX sums 65,536 float32 terms of the normalised matrix; the
  port divides exact integer sums in float64. Contrast, dissimilarity,
  homogeneity and ASM sum non-negative terms: |port - JAX| <= 1e-5 * the
  value (PERF.md section 2's 1e-5 of the sum of |terms|); energy is the
  square root of ASM, so the same. Correlation divides centred sums, whose
  terms cancel: JAX's float32 error scales with the uncentred magnitude, so
  the bound is 1e-5 * (E|ij| + |mean_i mean_j|) / (std_i std_j).
- Mean and std: JAX reduces in float32, the port in float64: |port - JAX|
  <= 1e-5 * mean|x| for the mean and 1e-5 * (mean|x| + std) for the std.
- Frames: quantile, histogram and segmentation columns exactly; mean, std
  and texture columns within rtol = atol = 1e-5 (the bounds above at these
  crops' values), correlation within 1e-4 (the bound above: E|ij| / (std_i
  std_j) stays below 10 on uniform uint8 crops).
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_radius import _view

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.ops import features as tf
from squidpy_tpu.ops import features as jf

torch.set_num_threads(1)
ROOT = Path(sqt.__file__).resolve().parent.parent
ANGLES = [0, np.pi / 4, np.pi / 2, 3 * np.pi / 4]
PROPS = ("contrast", "dissimilarity", "homogeneity", "ASM", "energy", "correlation")
SUM_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _exact_stats(images: np.ndarray, dr: int, dc: int, levels: int, symmetric: bool = False,
                 ignore: int | None = None) -> dict[str, np.ndarray]:
    """Means, stds and E|ij| of each crop's normalised GLCM, from numpy."""
    out = {k: [] for k in ("mi", "mj", "si", "sj", "eij")}
    for img in images.astype(np.int64):
        h, w = img.shape
        y0, y1, x0, x1 = max(0, -dr), min(h, h - dr), max(0, -dc), min(w, w - dc)
        i = img[y0:y1, x0:x1].ravel()
        j = img[y0 + dr : y1 + dr, x0 + dc : x1 + dc].ravel()
        if ignore is not None:
            keep = (i != ignore) & (j != ignore)
            i, j = i[keep], j[keep]
        if symmetric:
            i, j = np.r_[i, j], np.r_[j, i]
        if not len(i):  # no pair: both give JAX's empty-matrix props
            i = j = np.zeros(1, np.int64)
        for k, v in zip(("mi", "mj", "si", "sj", "eij"), (i.mean(), j.mean(), i.std(), j.std(), (i * j).mean())):
            out[k].append(v)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_props_close(got: np.ndarray, want: np.ndarray, stats: dict[str, np.ndarray]) -> None:
    """``got``/``want`` (n, 6) in PROPS order; the module docstring's bounds."""
    for p in range(5):
        tol = SUM_TOL * np.abs(got[:, p]) + 1e-300
        bad = np.abs(got[:, p] - want[:, p]) > tol
        assert not bad.any(), (PROPS[p], got[bad, p], want[bad, p])
    denom = stats["si"] * stats["sj"]
    scale = np.where(denom > 0, (np.abs(stats["eij"]) + np.abs(stats["mi"] * stats["mj"])) / np.where(denom > 0, denom, 1),
                     0.0)
    bad = np.abs(got[:, 5] - want[:, 5]) > SUM_TOL * scale
    assert not bad.any(), ("correlation", got[bad, 5], want[bad, 5])


def _crops(kind: str, n: int, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    if kind == "smooth":  # tissue-like: a ramp plus noise, few levels a crop
        yy, xx = np.mgrid[0:h, 0:w]
        base = (yy[None] * 3 + xx[None] * 2 + rng.integers(0, 80, (n, 1, 1))) % 200
        return (base + rng.integers(0, 12, (n, h, w))).astype(np.uint8)
    return np.full((n, h, w), 91, dtype=np.uint8)  # constant


# ------------------------------------------------------------------- K18


@pytest.mark.parametrize("kind", ["uniform", "smooth", "constant"])
@pytest.mark.parametrize("shape", [(9, 9), (17, 12), (33, 33)])
def test_glcm_counts_bitwise(kind, shape):
    imgs = _crops(kind, 6, *shape, seed=sum(shape))
    got = tf.glcm_batch(imgs, [1, 2], ANGLES)
    want = jf.glcm_batch(imgs, [1, 2], ANGLES)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("normed", [False, True])
def test_graycomatrix_bitwise(symmetric, normed):
    img = _crops("smooth", 1, 21, 19, seed=3)[0]
    got = tf.graycomatrix(img, [1, 2], ANGLES, symmetric=symmetric, normed=normed)
    want = jf.graycomatrix(img, [1, 2], ANGLES, symmetric=symmetric, normed=normed)
    assert np.array_equal(got, want)
    # the per-crop texture reads these counts through the copied host graycoprops
    for p in PROPS:
        assert np.array_equal(tf.graycoprops(got, p), jf.graycoprops(want, p))


def test_graycomatrix_past_256_levels_on_the_cpu():
    """int32 images of more than 256 levels (no uint8 cast): the plain
    version counts them as JAX does; on the card K18's global route takes
    them as int32 pixels (``tests/test_torch_image_card.py``)."""
    img = np.random.default_rng(5).integers(0, 300, (11, 13)).astype(np.int32)
    assert np.array_equal(tf.graycomatrix(img, [1, 3], ANGLES, levels=300), jf.graycomatrix(img, [1, 3], ANGLES, levels=300))


def test_graycomatrix_levels_and_dtype_checks():
    img = np.arange(40, dtype=np.int32).reshape(5, 8)
    assert np.array_equal(tf.graycomatrix(img, [1], [0], levels=40), jf.graycomatrix(img, [1], [0], levels=40))
    with pytest.raises(ValueError, match="must be smaller than"):
        tf.graycomatrix(img, [1], [0], levels=39)
    with pytest.raises(ValueError, match="invalid property"):
        tf.glcm_props_batch(img[None].astype(np.uint8), [1], [0], ("mean",), levels=40)


@pytest.mark.parametrize("kind", ["uniform", "smooth", "constant"])
@pytest.mark.parametrize("distance", [1, 2])
@pytest.mark.parametrize("shape", [(9, 9), (33, 28)])
def test_glcm_props_batch_against_jax(kind, distance, shape):
    imgs = _crops(kind, 8, *shape, seed=distance * 7 + shape[0])
    got = tf.glcm_props_batch(imgs, [distance], ANGLES, PROPS)
    want = jf.glcm_props_batch(imgs, [distance], ANGLES, PROPS)
    assert got.shape == want.shape == (8, 1, 4, 6)
    for a, (dr, dc) in enumerate(tf._offsets([distance], ANGLES)):
        _assert_props_close(got[:, 0, a], want[:, 0, a], _exact_stats(imgs, dr, dc, 256))
    if kind == "constant":
        assert np.array_equal(got, want)  # a single cell: every prop exact in both


@pytest.mark.parametrize("offset", [(0, 1), (1, 1), (1, -1), (2, 0)])
def test_glcm_symmetric_ignore_level_against_jax(offset):
    """``per_cell_texture_batch``'s call: 33 levels, the sentinel 32 ignored, symmetric."""
    rng = np.random.default_rng(sum(offset) + 5)
    q = rng.integers(0, 33, (10, 14, 15)).astype(np.int32)
    q[:, :3, :] = 32  # padding rows of a ragged bbox
    q[0] = 32  # a crop of sentinels only: no pair
    got = tf.glcm_props(torch.from_numpy(q)[..., None], [0], [offset], 33, symmetric=True, ignore_level=32)[:, 0, 0]
    want = np.asarray(jf._glcm_props_kernel(jnp.asarray(q), *offset, 33, PROPS, ignore_level=32, symmetric=True))
    _assert_props_close(got.numpy(), want.astype(np.float64), _exact_stats(q, *offset, 33, True, 32))
    assert np.array_equal(got[0].numpy(), [0, 0, 0, 0, 0, 1])  # JAX's empty matrix: correlation 1


def test_glcm_props_from_integers_bitwise_counts():
    """The plain version's sums against the counts matrix: sum c^2 over P + P^T
    and the |i - j| histogram."""
    imgs = _crops("smooth", 4, 13, 11, seed=9)
    t = torch.from_numpy(imgs).to(torch.int64)
    for sym in (False, True):
        sums, hist = tf._glcm_sums_plain(t, 1, -1, 256, sym, None)
        P = jf.glcm_batch(imgs, [1], [3 * np.pi / 4])[..., 0, 0]
        if sym:
            P = P + np.transpose(P, (0, 2, 1))
        assert np.array_equal(sums[:, 8].numpy(), (P.astype(np.int64) ** 2).sum(axis=(1, 2)))
        assert hist.sum(1).tolist() == sums[:, 0].tolist()


def _exact_props(S, Si, Sj, Sii, Sjj, Sij, symmetric=False):
    """Correlation from Python integers: each centred product exact, rounded
    to double once (the rule of ``csrc/glcm.cu`` `centred`), and the true
    value from the exact rational."""
    from fractions import Fraction

    if symmetric:
        S, Si, Sj, Sii, Sjj, Sij = 2 * S, Si + Sj, Si + Sj, Sii + Sjj, Sii + Sjj, 2 * Sij
    vi, vj, cov = S * Sii - Si * Si, S * Sjj - Sj * Sj, S * Sij - Si * Sj
    rounded = 1.0 if vi == 0 or vj == 0 else float(cov) / np.sqrt(float(vi) * float(vj))
    true = 1.0 if vi == 0 or vj == 0 else float(np.sign(cov)) * float(Fraction(cov * cov, vi * vj)) ** 0.5
    return rounded, true


def _hand_sums(pairs: dict[tuple[int, int], int]) -> tuple[list[int], list[int]]:
    """K18's nine sums and the d histogram of the pairs (i, j) -> count."""
    S = sum(pairs.values())
    f = lambda g: sum(c * g(i, j) for (i, j), c in pairs.items())  # noqa: E731
    sums = [S, f(lambda i, j: i), f(lambda i, j: j), f(lambda i, j: i * i), f(lambda i, j: j * j),
            f(lambda i, j: i * j), f(lambda i, j: abs(i - j)), f(lambda i, j: (i - j) ** 2),
            sum(c * c for c in pairs.values())]
    hist = [0] * 256
    for (i, j), c in pairs.items():
        hist[abs(i - j)] += c
    return sums, hist


def test_glcm_props_past_int64_exact():
    """The centred products past int64 (S sum i^2 > 2^63): the plain
    version's correlation is the exact integers rounded to double once,
    within 1e-12 of the true value. The first case is the 12,000^2 slide
    taken as one crop at offset (0, 1): half its pairs at (0, 0), half at
    (255, 255), 1,000 each at (0, 255) and (255, 0); int64 arithmetic wraps
    its correlation to 0.998124, the exact value is 0.999972."""
    S = 12_000 * 11_999
    cases = [({(0, 0): (S - 2000) // 2, (255, 255): (S - 2000) // 2, (0, 255): 1000, (255, 0): 1000}, False)]
    rng = np.random.default_rng(11)
    for k in range(6):  # bright crops of 5,000-40,000 pixels a side: a few hundred cells each
        n = int(rng.integers(5_000, 40_000)) ** 2
        cells = rng.integers(180, 256, (int(rng.integers(2, 300)), 2))
        w = rng.dirichlet(np.ones(len(cells)))
        pairs: dict[tuple[int, int], int] = {}
        for (i, j), c in zip(cells.tolist(), np.floor(w * n).astype(np.int64).tolist()):
            pairs[(i, j)] = pairs.get((i, j), 0) + c
        cases.append((pairs, k % 2 == 1))
    rows, hists, want = [], [], []
    for pairs, sym in cases:
        sums, hist = _hand_sums(pairs)
        assert sums[0] * sums[3] >= 2**63  # past int64
        rows.append(sums)
        hists.append(hist)
        want.append(_exact_props(*sums[:6], symmetric=sym))
    for (pairs, sym), sums, hist, (rounded, true) in zip(cases, rows, hists, want):
        got = tf._glcm_props_plain(torch.tensor([sums]), torch.tensor([hist]), sym)[0]
        assert float(got[5]) == rounded
        assert abs(float(got[5]) - true) <= 1e-12
    S, Si, Sj, Sii, Sjj, Sij = rows[0][:6]
    wrapped = np.array([S, Si, Sj, Sii, Sjj, Sij], dtype=np.int64)
    with np.errstate(over="ignore"):
        vi = wrapped[0] * wrapped[3] - wrapped[1] * wrapped[1]
        vj = wrapped[0] * wrapped[4] - wrapped[2] * wrapped[2]
        cov = wrapped[0] * wrapped[5] - wrapped[1] * wrapped[2]
    assert abs(float(cov) / np.sqrt(float(vi) * float(vj)) - 0.998124) < 1e-6  # what int64 gave
    assert abs(want[0][1] - 0.999972) < 1e-6


def test_centred_products_exact():
    """``_centred`` (a b - c d rounded once) against Python integers on
    entries on both sides of 2^62."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**62, 400, dtype=np.int64) >> rng.integers(0, 40, 400)
    b, c, d = (rng.integers(0, 2**62, 400, dtype=np.int64) >> rng.integers(0, 40, 400) for _ in range(3))
    got = tf._centred(*(torch.from_numpy(t) for t in (a, b, c, d))).numpy()
    want = [float(int(w) * int(x) - int(y) * int(z)) for w, x, y, z in zip(a, b, c, d)]
    assert np.array_equal(got, np.asarray(want))


def test_glcm_moments_limit(monkeypatch):
    """Props past the int64 sums: the plain version then keeps its sums in
    Python integers (forced here on small crops through ``_sums_fit``),
    which give its int64 sums and props exactly; no size is refused."""
    assert tf._sums_fit(12_000 * 11_999, 256)  # a slide taken as one crop
    assert not tf._sums_fit(46_400 * 46_399, 256) and not tf._sums_fit(2**30, 2**16)
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.integers(0, 33, (5, 23, 19)).astype(np.int64))
    img[0] = 7
    img[1, :, :5] = 40  # outside the levels: those pairs drop
    for sym, ignore in ((False, None), (True, None), (True, 3), (False, 32)):
        for dr, dc in ((0, 1), (1, -1), (3, 0)):
            want, want_hist = tf._glcm_sums_plain(img, dr, dc, 33, sym, ignore)
            with monkeypatch.context() as m:
                m.setattr(tf, "_sums_fit", lambda pairs, levels: False)
                got, hist = tf._glcm_sums_plain(img, dr, dc, 33, sym, ignore)
            assert isinstance(got, list) and got == want.tolist() and torch.equal(hist, want_hist)
            assert torch.equal(tf._glcm_props_plain(got, hist, sym), tf._glcm_props_plain(want, want_hist, sym))
    assert tf.glcm_props(torch.zeros((1, 4, 4, 1), dtype=torch.int32), [0], [(0, 1)], 300).shape == (1, 1, 1, 6)


def test_glcm_plain_in_row_chunks(monkeypatch):
    """The plain versions take an offset's pairs a run of whole rows at a
    time: runs of one row give what one run of every row gives."""
    img = torch.from_numpy(np.random.default_rng(13).integers(0, 40, (3, 17, 21)).astype(np.int32))
    offs = [(0, 1), (2, -3), (-1, 2), (5, 0), (17, 0)]
    counts = tf._glcm_counts_plain(img, offs, 40)
    sums = [tf._glcm_sums_plain(img, dr, dc, 40, True, 5) for dr, dc in offs]
    monkeypatch.setitem(tf._PLAIN_PAIRS, "cpu", 1)
    assert torch.equal(tf._glcm_counts_plain(img, offs, 40), counts)
    for (dr, dc), (want, want_hist) in zip(offs, sums):
        got, hist = tf._glcm_sums_plain(img, dr, dc, 40, True, 5)
        assert torch.equal(got, want) and torch.equal(hist, want_hist)


def test_k18_route_rule():
    offs = tf._offsets([1], ANGLES)
    assert tf.k18_packed(89, 89, offs, False) and tf.k18_packed(177, 177, offs, False)
    assert not tf.k18_packed(300, 300, offs, False)  # 89,700 pairs an offset
    assert tf.k18_packed(255, 257, offs, False)  # 65,280 pairs at most
    assert not tf.k18_packed(256, 257, offs, False)  # 65,536 at angle 0
    assert not tf.k18_packed(200, 200, offs, True)  # symmetric: the diagonal counts 2 a pair
    assert tf.k18_route(89, 89, offs, False, 256) == "shared" == tf.k18_route(177, 177, offs, False, 256)
    assert tf.k18_route(24, 24, [(0, 1)], True, 33) == "shared"
    assert tf.k18_route(300, 300, offs, False, 256) == "global"  # past the 16-bit counters
    assert tf.k18_route(48, 48, offs, False, 300, torch.int32) == "global"  # past 256 levels
    assert tf.k18_route(48, 48, offs, False, 256, torch.int32) == "global"  # int32 pixels
    assert tf.k18_route(1, 100_000, [(0, 1)], False, 256) == "global"  # a plane past the staged bytes
    assert tf.k18_route(60_000, 1, [(1, 0)], False, 256) == "global"  # rows padded to 4 bytes pass them
    assert tf._k18_images(torch.tensor([[-5, 3, 400]], dtype=torch.int64), 300).tolist() == [[-1, 3, 300]]
    assert tf._k18_images(torch.tensor([[7]], dtype=torch.int16), 300).dtype == torch.int32


# ------------------------------------------------------------------- K19


@pytest.mark.parametrize("data", ["uint8", "float", "ties"])
@pytest.mark.parametrize("quantiles", [(0.9, 0.5, 0.1), (0.0, 0.33, 1.0, 0.75)])
def test_summary_batch_against_jax(data, quantiles):
    rng = np.random.default_rng(len(quantiles))
    if data == "uint8":
        crops = rng.integers(0, 256, (25, 11, 13, 3)).astype(np.uint8)
    elif data == "float":
        crops = rng.normal(40, 25, (25, 11, 13, 3)).astype(np.float32)
    else:
        crops = rng.integers(0, 4, (25, 11, 13, 3)).astype(np.float32) / np.float32(3)
    got, want = tf.summary_features_batch(crops, quantiles), jf.summary_features_batch(crops, quantiles)
    assert np.array_equal(got["quantiles"], want["quantiles"])
    x = np.abs(crops.reshape(25, -1, 3).astype(np.float64))
    assert np.all(np.abs(got["mean"] - want["mean"]) <= SUM_TOL * x.mean(1))
    assert np.all(np.abs(got["std"] - want["std"]) <= SUM_TOL * (x.mean(1) + want["std"]))


def test_summary_batch_nan_sorts_last():
    crops = np.random.default_rng(1).uniform(0, 1, (4, 6, 6, 2)).astype(np.float32)
    crops[0, 0, 0, 0] = np.nan
    crops[1, :3, :, 1] = np.nan
    got, want = tf.summary_features_batch(crops, (0.9, 0.5, 0.1)), jf.summary_features_batch(crops, (0.9, 0.5, 0.1))
    np.testing.assert_array_equal(got["quantiles"], want["quantiles"])  # NaN where JAX has NaN
    assert np.isnan(got["mean"][0, 0]) and np.isnan(got["std"][1, 1])


@pytest.mark.parametrize("size", [1, 2, 9, 97, 1000])
def test_summary_per_crop_against_jnp_quantile(size):
    rng = np.random.default_rng(size)
    for arr in (rng.uniform(-5, 300, size).astype(np.float32), rng.integers(0, 256, size).astype(np.uint8)):
        q = (0.9, 0.5, 0.1, 0.01, 0.999)
        got, want = tf.summary_features(arr, q), jf.summary_features(arr, q)
        assert np.array_equal(got["quantiles"], want["quantiles"])
        x = np.abs(arr.astype(np.float64))
        assert abs(got["mean"] - want["mean"]) <= SUM_TOL * x.mean()
        assert abs(got["std"] - want["std"]) <= SUM_TOL * (x.mean() + want["std"])
    nan = rng.uniform(0, 1, size).astype(np.float32)
    nan[size // 2] = np.nan
    got, want = tf.summary_features(nan, (0.5, 0.1)), jf.summary_features(nan, (0.5, 0.1))
    np.testing.assert_array_equal(got["quantiles"], want["quantiles"])  # all NaN, as jnp.quantile gives


def _float_keys(v: np.ndarray) -> np.ndarray:
    """``csrc/crop_summary.cu`` `float_key`: order-preserving uint32 keys,
    -0 as +0 and every NaN as the canonical quiet NaN."""
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    v = np.where(np.isnan(v), np.float32(np.nan), v)
    u = v.view(np.uint32).copy()
    u[np.isnan(v)] = 0x7FC00000
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _select_model(keys: np.ndarray, ranks: np.ndarray, cap: int) -> np.ndarray:
    """A numpy model of K19's select: four 8-bit digits from the top, a
    pass counting the digit of each key under a live prefix into that
    prefix's 256 bins, the resolve moving every rank into the bin that holds
    it (the keys before it leave its rank), the live prefixes rebuilt from
    the ranks in order, and after the second digit the keys under the live
    prefixes copied out (in any order) when they fit ``cap``."""
    pref = np.zeros(len(ranks), np.uint64)
    rank = ranks.astype(np.int64).copy()
    live, idx = np.zeros(1, np.uint64), np.zeros(len(ranks), np.int64)
    pool = keys.astype(np.uint64)
    for p in range(4):
        shift = 24 - 8 * p
        top = pool >> np.uint64(shift + 8)
        where = np.searchsorted(live, top)
        hit = (where < len(live)) & (live[np.minimum(where, len(live) - 1)] == top)
        bins = np.zeros((len(live), 256), np.int64)
        np.add.at(bins, (where[hit], ((pool[hit] >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)), 1)
        in_bin = np.zeros(len(ranks), np.int64)
        for k in range(len(ranks)):
            cum = np.cumsum(bins[idx[k]])
            digit = int(np.searchsorted(cum, rank[k], side="right"))
            rank[k] -= int(cum[digit - 1]) if digit else 0
            in_bin[k] = bins[idx[k], digit]
            pref[k] = (pref[k] << np.uint64(8)) | np.uint64(digit)
        live, first = np.unique(pref, return_index=True)
        idx = np.searchsorted(live, pref)
        under = int(in_bin[first].sum())  # the keys under the new live prefixes
        if p == 1 and under <= cap:
            keep = np.isin(pool >> np.uint64(16), live)
            pool = np.random.default_rng(p).permutation(pool[keep])  # the ballot copy leaves any order
            assert len(pool) == under
    return pref.astype(np.uint32)


@pytest.mark.parametrize("data", ["uint8", "ties", "signed", "specials", "constant"])
@pytest.mark.parametrize("cap", [0, 1 << 30])
def test_k19_select_model_against_sort(data, cap):
    """The select's digit passes and rank bookkeeping for several ranks at
    once give the keys ``np.sort`` puts at those ranks: uint8 pixels (a few
    top digits), ties, signed values with -0 and +0, and +-inf and NaN."""
    rng = np.random.default_rng(hash(data) % 1000)
    if data == "uint8":
        v = rng.integers(0, 256, 3000).astype(np.float32)
    elif data == "ties":
        v = rng.choice(np.float32([1.5, 1.5000001, 2.0, -3.0]), 2001)
    elif data == "signed":
        v = rng.normal(0, 1e3, 2500).astype(np.float32)
        v[::7] = np.float32(0.0)
        v[::11] = np.float32(-0.0)
    elif data == "specials":
        v = rng.uniform(-5, 5, 1500).astype(np.float32)
        v[::9] = np.inf
        v[::13] = -np.inf
        v[::17] = np.nan
    else:
        v = np.full(777, np.float32(91.0))
    keys = _float_keys(v)
    p = len(keys)
    for quantiles in ((0.9, 0.5, 0.1), (0.0, 1.0), tuple(np.linspace(0, 1, 16))):
        for rule in (0, 1):
            ranks = tf._k19_ranks(tf.quantile_table(quantiles, p, rule))[0]
            assert len(ranks) <= tf.SELECT_RANKS
            got = _select_model(keys, ranks, cap)
            assert np.array_equal(got, np.sort(keys)[ranks]), (quantiles, rule)


def test_k19_layout_and_tables():
    """K19's route rule and its cached table on the device."""
    smem, sms = 232_448, 132
    assert tf._k19_layout(14_976, 7921, 6, smem, sms)[:3] == ("select", 256, 1)
    assert tf._k19_layout(14_976, 31_329, 6, smem, sms)[:2] == ("select", 512)
    assert tf._k19_layout(900, 40_000, 6, smem, sms)[:2] == ("select", 1024)
    assert tf._k19_layout(1, 7921, 3, smem, sms)[:2] == ("select", 1024)  # the per-crop path: one wide block
    assert tf._k19_layout(1, 40_000, 6, smem, sms)[:3] == ("select", 1024, 1)  # one crop whose keys fit
    assert tf._k19_layout(1, 90_000, 6, smem, sms)[0] == "split"  # one large crop over several blocks
    route, threads, blocks, cap = tf._k19_layout(1, 160_000, 6, smem, sms)
    assert (route, threads) == ("split", 256) and blocks * 1024 >= 160_000 // 16 and cap == 0
    assert tf._k19_layout(3, 60_000, 6, smem, sms)[0] == "split"  # past the shared keys
    assert tf._k19_layout(600, 7921, 2999, smem, sms)[0] == "sort"  # 1,500 quantiles
    table = tf.quantile_table((0.9, 0.5, 0.1), 7921, 0)
    ranks, qlo, qhi = tf._k19_ranks(table)
    assert np.array_equal(ranks[qlo], table[0]) and np.array_equal(ranks[qhi], table[1])
    assert list(ranks) == sorted(set(ranks))
    t1, at = tf._k19_device_table(table, torch.device("cpu"))
    t2, _ = tf._k19_device_table(tuple(np.copy(t) for t in table), torch.device("cpu"))
    assert t1 is t2 and at == [0, 6, 9, 12, 15]
    assert np.array_equal(t1.numpy()[12:15].view(np.float32), table[2])


def test_fma32_rounds_once():
    """The plain versions' fused multiply-add against exact rational arithmetic."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a, b, c = (rng.uniform(-1, 1, 4000).astype(np.float32) * np.float32(2.0) ** rng.integers(-20, 20, 4000)
               for _ in range(3))
    got = tf._fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for k in range(0, 4000, 7):
        exact = Fraction(float(a[k])) * Fraction(float(b[k])) + Fraction(float(c[k]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.int32)) & 1))
        assert got[k] == best, (a[k], b[k], c[k])


# ------------------------------------------------------------------- K20


@pytest.mark.parametrize("v_range", [None, (0.0, 1.0), (0.2, 0.7), (0.5, 0.5), (0.9, 0.1)])
@pytest.mark.parametrize("bins", [1, 7, 10, 16])
def test_histogram_batch_against_jax(v_range, bins):
    rng = np.random.default_rng(bins)
    crops = rng.uniform(-0.1, 1.1, (12, 9, 10, 3)).astype(np.float32)
    crops[3] = np.float32(0.5)  # a constant crop: span 1
    got, want = tf.histogram_features_batch(crops, bins, v_range), jf.histogram_features_batch(crops, bins, v_range)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_histogram_batch_uint8_and_nan():
    rng = np.random.default_rng(2)
    crops = rng.integers(0, 256, (10, 12, 12, 3)).astype(np.uint8)
    assert np.array_equal(tf.histogram_features_batch(crops, 10, None), jf.histogram_features_batch(crops, 10, None))
    f = crops.astype(np.float32)
    f[2, 0, 0, 1] = np.nan  # the crop's range is NaN: it counts nothing
    for vr in (None, (10, 200)):
        assert np.array_equal(tf.histogram_features_batch(f, 10, vr), jf.histogram_features_batch(f, 10, vr))


@pytest.mark.parametrize("bins", [1, 2, 3, 7, 10, 16, 33, 34, 64, 100])
def test_histogram_edges_against_jnp_linspace(bins):
    rng = np.random.default_rng(bins)
    lo = np.r_[rng.uniform(-100, 100, 300), rng.integers(0, 255, 200)].astype(np.float32)
    hi = (lo + np.r_[rng.uniform(0.001, 300, 300), rng.integers(1, 255, 200)]).astype(np.float32)
    lo[:5] = hi[:5]  # an empty range: lo - 0.5 .. hi + 0.5
    got = tf.histogram_edges(torch.from_numpy(lo), torch.from_numpy(hi), bins).numpy()
    want = np.stack([np.asarray(jnp.histogram_bin_edges(jnp.zeros(1, jnp.float32), bins, (a, b)))
                     for a, b in zip(lo, hi)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("data", ["uint8", "float"])
@pytest.mark.parametrize("bins", [3, 10, 16])
def test_histogram_per_crop_against_jnp_histogram(data, bins):
    rng = np.random.default_rng(bins)
    for t in range(12):
        arr = rng.integers(0, 256, (9, 11)).astype(np.uint8) if data == "uint8" else \
            rng.uniform(-2, 9, (9, 11)).astype(np.float32)
        for vr in ((float(arr.min()), float(arr.max())), (20.0, 100.0), (3.0, 3.0)):
            got, want = tf.histogram_features(arr, bins, vr), jf.histogram_features(arr, bins, vr)
            assert got.dtype == want.dtype and np.array_equal(got, want), (t, vr)
    arr = rng.uniform(0, 1, 50).astype(np.float32)
    arr[7] = np.nan
    assert np.array_equal(tf.histogram_features(arr, 10, (0.0, 1.0)), jf.histogram_features(arr, 10, (0.0, 1.0)))


def _edges_at_or_below(edges: np.ndarray, v: float) -> int:
    """``csrc/crop_histogram.cu`` `edges_at_or_below`: the first edge above
    v by a binary search."""
    lo, hi = 0, len(edges)
    while lo < hi:
        mid = (lo + hi) >> 1
        if edges[mid] <= v:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _k20_bin(edges: np.ndarray, v: float) -> int:
    """K20's rule-1 bin of v (-1: dropped): the search on non-decreasing
    edges, the count edge by edge where an edge falls below its left
    neighbour, the top edge into the last bin, NaN dropped."""
    if np.isnan(v):
        return -1
    bins = len(edges) - 1
    idx = int(np.sum(edges <= v)) if np.any(edges[1:] < edges[:-1]) else _edges_at_or_below(edges, v)
    if v == edges[-1]:
        idx = bins
    return idx - 1 if 1 <= idx <= bins else -1


@pytest.mark.parametrize("bins", [1, 2, 10, 1023, 2000, 30_000])
def test_k20_binary_search_rule(bins):
    """K20's binary search against the linear count on edges with ties, at,
    between and outside the edges, NaN, and the plain version's bins."""
    rng = np.random.default_rng(bins)
    base = tf.histogram_edges(torch.tensor([np.float32(-3.0)]), torch.tensor([np.float32(7.0)]), bins)[0].numpy()
    tied = np.sort(np.repeat(rng.choice(base, max(2, bins // 3)), rng.integers(1, 4, max(2, bins // 3))))[: bins + 1]
    tied = np.sort(np.r_[tied, np.full(bins + 1 - len(tied), tied[-1])]).astype(np.float32)
    for edges in (base, tied):
        probes = np.r_[edges, (edges[:-1] + edges[1:]) / 2, np.nextafter(edges, np.float32(np.inf)),
                       np.nextafter(edges, np.float32(-np.inf)), edges[0] - 1, edges[-1] + 1, np.nan].astype(np.float32)
        probes = probes[rng.permutation(len(probes))[:3000]] if len(probes) > 3000 else probes
        for v in probes:
            assert _edges_at_or_below(edges, v) == int(np.sum(edges <= v)) or np.isnan(v)
        plain = tf._histogram_plain(torch.from_numpy(probes).view(1, -1, 1), bins, 1,
                                    torch.tensor([edges[0]]), torch.tensor([edges[-1]]), False)
        if edges is base:  # the plain version's own edges
            want = np.bincount([b for b in (_k20_bin(edges, v) for v in probes) if b >= 0], minlength=bins)
            assert np.array_equal(plain[0, 0].numpy(), want)
    falling = np.float32([0.0, 1.0, 0.5, 2.0])  # a falling edge: the count edge by edge
    assert [_k20_bin(falling, v) for v in np.float32([0.75, 1.5, 2.0, -1.0])] == [1, 2, 2, -1]


SMEM, SMS = 232_448, 132  # an H100's opt-in shared memory a block and its SMs


def _u8_launch_ok(layout, size: int) -> bool:
    """``sqt_crop_histogram_u8``'s checks of its launch (``csrc/crop_histogram.cu``)."""
    return (layout.chunk % 16 == 0 and layout.chunk <= 2**31 - 1 and (not layout.fused or layout.splits == 1)
            and layout.splits * layout.chunk >= size)


def _u8_smem(layout, n_c: int, bins: int) -> int:
    """The uint8 entry's shared bytes (``sqt_crop_histogram_u8``)."""
    words = n_c * tf.K20_CHANNEL_WORDS
    if layout.fused:
        words += tf.K20_FOLD_WORDS + (n_c * bins if layout.hist_shared else 0)
    return 4 * words


@pytest.mark.parametrize("entry", ["uint8", "float32"])
def test_k20_layout(entry):
    """K20's entry by dtype and its routes: uint8 crops count values (fused
    at the main path's shapes and while the fold fits beside the counters,
    split where a block's 32-bit counters could pass their width or the
    crops are few), the float32 entry past the channels of one block's
    counters in shared memory; the float32 entry's shared histogram and
    edges while they fit. The shared words the layout counts are the
    kernel's own (``csrc/crop_histogram.cu``'s constants)."""
    lay = tf._k20_layout
    if entry == "float32":
        f = lay(4992, 89 * 89, 3, 10, 0, False, SMEM, SMS)
        assert (f.entry, f.splits, f.fused, f.hist_shared, f.edges_shared) == ("float32", 1, False, True, False)
        assert lay(4992, 177 * 177, 3, 10, 0, False, SMEM, SMS).hist_shared
        r1 = lay(1, 7921, 1, 1023, 1, False, SMEM, SMS)
        assert r1.edges_shared and r1.hist_shared
        assert not lay(1, 7921, 1, 1024, 1, False, SMEM, SMS).edges_shared  # 1,025 edges: global, searched there
        assert not lay(3, 7921, 3, 30_000, 0, False, SMEM, SMS).hist_shared  # 360 KB of counters: global
        assert lay(3, 99, 3, 13_653, 0, False, SMEM, SMS).hist_shared
        assert not lay(3, 99, 3, 13_654, 0, False, SMEM, SMS).hist_shared
        for c, bins, rule in ((3, 10, 0), (3, 13_653, 0), (1, 1023, 1), (1, 1024, 1), (40, 1000, 1)):
            f = lay(7, 99, c, bins, rule, False, SMEM, SMS)
            words = 36 + (c * bins if f.hist_shared else 0) + (bins + 1 if f.edges_shared else 0)  # `kF32Words` first
            assert 4 * words <= SMEM
        return
    src = (Path(tf.__file__).parent.parent / "csrc" / "crop_histogram.cu").read_text()
    assert f"constexpr int kChannelWords = {tf.K20_CHANNEL_WORDS};" in src
    assert f"constexpr int kFoldWords = {tf.K20_FOLD_WORDS};" in src
    i2 = lay(4992, 89 * 89, 3, 10, 0, True, SMEM, SMS)
    assert (i2.entry, i2.fused, i2.splits, i2.hist_shared) == ("uint8", True, 1, True)
    s2 = lay(4992, 177 * 177, 3, 10, 0, True, SMEM, SMS)
    assert (s2.entry, s2.fused, s2.splits) == ("uint8", True, 1)
    many = lay(200, 7921, 3, 30_000, 0, True, SMEM, SMS)
    assert many.entry == "uint8" and many.fused and not many.hist_shared  # 360 KB of bins: atomics into the output
    slide = lay(1, 12_000 * 12_000, 1, 10, 1, True, SMEM, SMS)
    assert slide.splits > 1 and not slide.fused  # split over the card, then the fold kernel
    one = lay(1, 89 * 89, 1, 10, 1, True, SMEM, SMS)
    assert (one.fused, one.splits) == (True, 1)
    few = lay(4, 400 * 400, 3, 10, 0, True, SMEM, SMS)
    assert few.splits == 480_000 // tf.K20_MIN_SPLIT + 1 and not few.fused  # four crops split over the card
    huge = lay(200, 3_000_000_000, 1, 10, 0, True, SMEM, SMS)
    assert huge.splits == 2 and huge.chunk <= tf.K20_CHUNK_MAX  # a block's 32-bit counters
    fused_most = (SMEM // 4 - tf.K20_FOLD_WORDS) // (tf.K20_CHANNEL_WORDS + 10)  # channels folded in the block
    assert lay(200, 99, fused_most, 10, 0, True, SMEM, SMS).fused
    past = lay(200, 99, fused_most + 1, 10, 0, True, SMEM, SMS)
    assert (past.entry, past.fused, past.splits) == ("uint8", False, 1)  # the value table and the fold kernel
    most = SMEM // 4 // tf.K20_CHANNEL_WORDS  # channels of one block's counters in shared memory
    assert lay(4, 99, most, 10, 0, True, SMEM, SMS).entry == "uint8"
    assert lay(4, 99, most + 1, 10, 0, True, SMEM, SMS).entry == "float32"
    for n, p, c, bins in ((4992, 7921, 3, 10), (4992, 31_329, 3, 10), (200, 7921, 3, 30_000), (1, 144_000_000, 1, 10),
                          (4, 160_000, 3, 10), (3, 65_536, 1, 2000), (100, 999, 7, 256), (4, 99, most, 10),
                          (200, 99, fused_most, 10), (200, 99, fused_most + 1, 10), (4, 99, 200, 300), (1, 1, 1, 1),
                          (7, 16, 1, 1), (200, 3_000_000_000, 1, 10)):
        layout = lay(n, p, c, bins, 0, True, SMEM, SMS)
        assert _u8_launch_ok(layout, p * c) and _u8_smem(layout, c, bins) <= SMEM, (n, p, c, bins, layout)
        if not layout.fused:
            assert 4 * (tf.K20_FOLD_WORDS + (c * bins if layout.hist_shared else 0)) <= SMEM  # the fold kernel's


BYTE_RANGES = [(50.0, 200.0), (50.5, 200.25), (100.0, 100.0), (-3.5, 120.7), (0.0, 255.0), (17.0, 17.25),
               (200.0, 50.0), (3.0, 250.0)]


@pytest.mark.parametrize("v_range", BYTE_RANGES, ids=[f"{a}-{b}" for a, b in BYTE_RANGES])
@pytest.mark.parametrize("rule,bins", [(0, 1), (0, 7), (0, 10), (0, 256), (0, 300), (0, 30_000), (1, 1), (1, 7), (1, 10),
                                       (1, 256), (1, 300), (1, 2000)])
def test_k20_value_bins_every_byte(rule, bins, v_range):
    """The fold's plain twin on all 256 byte values, bitwise the plain
    version and JAX (``_histogram_batch_kernel`` over a fixed range, which
    is the per-crop rule's formula at the crop's own lowest and highest
    value; ``jnp.histogram``): each value a crop of one pixel."""
    lo, hi = (float(np.float32(v)) for v in v_range)
    got = tf._k20_value_bins(lo, hi, bins, rule).numpy()
    vals = np.arange(256, dtype=np.float32)
    n = torch.full((256,), lo), torch.full((256,), hi)
    plain = tf._histogram_plain(torch.from_numpy(vals).view(256, 1, 1), bins, rule, *n, False)[:, 0].numpy()
    if rule == 0:
        jax_counts = np.asarray(jf._histogram_batch_kernel(jnp.asarray(vals.reshape(256, 1, 1, 1)), bins,
                                                           jnp.float32(lo), jnp.float32(hi), False))[:, 0]
    else:
        import jax

        jax_counts = np.asarray(jax.vmap(lambda a: jnp.histogram(a, bins=bins, range=(lo, hi))[0])(
            jnp.asarray(vals[:, None])))
    # a reversed range gives jnp.histogram decreasing edges, which its
    # searchsorted treats as sorted (numpy refuses such a range); the port
    # counts #edges <= v there, as its plain version always has
    for counts in (plain,) if rule == 1 and lo > hi else (plain, jax_counts):
        assert set(np.unique(counts.sum(1))) <= {0, 1}
        want = np.where(counts.sum(1) > 0, counts.argmax(1), -1)
        assert np.array_equal(got, want)


def _u8_count_then_fold(crops: np.ndarray, bins: int, v_range, rule: int) -> np.ndarray:
    """The uint8 entry in numpy: n_ch x 256 value counts a crop, the range
    (per crop: the lowest and highest value counted in any channel), each
    value's bin by ``_k20_value_bins``, its count added there."""
    n, c = crops.shape[0], crops.shape[-1]
    flat = crops.reshape(n, -1, c)
    out = np.zeros((n, c, bins), np.int64)
    for i in range(n):
        counts = np.stack([np.bincount(flat[i, :, ch], minlength=256) for ch in range(c)])
        if v_range is None:
            present = np.nonzero(counts.sum(0))[0]
            lo, hi = (float(present[0]), float(present[-1])) if len(present) else (np.inf, -np.inf)
        else:
            lo, hi = (float(np.float32(v)) for v in v_range)
        vb = tf._k20_value_bins(lo, hi, bins, rule).numpy()
        for ch in range(c):
            np.add.at(out[i, ch], vb[vb >= 0], counts[ch][vb >= 0])
    return out


@pytest.mark.parametrize("kind", ["random", "nearly constant", "narrow"])
@pytest.mark.parametrize("v_range", [None, (50.0, 200.0), (50.5, 200.25), (137.0, 137.0), (-10.0, 60.0)])
@pytest.mark.parametrize("bins", [10, 300])
def test_k20_uint8_count_then_fold_against_jax(kind, v_range, bins):
    rng = np.random.default_rng(bins)
    if kind == "random":
        crops = rng.integers(0, 256, (9, 13, 11, 3)).astype(np.uint8)
    elif kind == "nearly constant":
        crops = np.full((9, 13, 11, 3), 137, np.uint8)
        crops[::2, ::5, ::3, 1] = 138
        crops[4] = 200  # one crop of one value: span 1
    else:
        crops = np.clip(rng.normal(240, 4, (9, 13, 11, 3)), 0, 255).astype(np.uint8)
    want = jf.histogram_features_batch(crops, bins, v_range)
    assert np.array_equal(_u8_count_then_fold(crops, bins, v_range, 0), want)
    assert np.array_equal(tf.histogram_features_batch(crops, bins, v_range), want)


@pytest.mark.parametrize("bins", [3, 10, 2000])
def test_k20_uint8_count_then_fold_per_crop_jnp_histogram(bins):
    rng = np.random.default_rng(bins)
    for t in range(6):
        arr = rng.integers(0, 256, (19, 17)).astype(np.uint8)
        for vr in ((float(arr.min()), float(arr.max())), (20.0, 100.0), (3.0, 3.0), (50.5, 200.25)):
            want = jf.histogram_features(arr, bins, vr)
            assert np.array_equal(_u8_count_then_fold(arr.reshape(1, -1, 1), bins, vr, 1)[0, 0], want), (t, vr)
            assert np.array_equal(tf.histogram_features(arr, bins, vr), want), (t, vr)


class _EmulatedK20:
    """K20's C interface in numpy, reading and writing CPU tensors through
    the pointers the wrapper passes: the uint8 entry's blocks each count
    their own bytes of a crop (by position, as the kernel's chunks cut it)
    and fold them (fused) or add them into the value table; the fold kernel;
    the float32 entry through the plain version. It checks each launch as
    the C side does."""

    def __init__(self) -> None:
        self.calls: list[str] = []

    def sqt_crop_histogram_u8(self, x, n, p, n_ch, bins, rule, lo, hi, per_crop_range, splits, chunk, hist_global,
                              counts, out, stream):
        self.calls.append("u8 fused" if counts is None else "u8 split")
        size = p * n_ch
        layout = tf.K20Layout("uint8", splits, chunk, counts is None, not hist_global, False)
        if not _u8_launch_ok(layout, size):
            return 1
        data = _view(x, np.uint8, n * size).reshape(n, size)
        los, his = _view(lo, np.float32, n), _view(hi, np.float32, n)
        res = _view(out, np.int32, n * n_ch * bins).reshape(n, n_ch, bins)
        table = None if counts is None else _view(counts, np.int32, n * n_ch * 256).reshape(n, n_ch * 256)
        for i in range(n):
            for s in range(splits):
                pos = np.arange(s * chunk, min((s + 1) * chunk, size))
                block = np.zeros(n_ch * 256, np.int64)
                np.add.at(block, (pos % n_ch) * 256 + data[i, pos], 1)
                if table is not None:
                    table[i, : n_ch * 256] += block.astype(np.int32)
                else:
                    self._fold(block.reshape(n_ch, 256), bins, rule, los[i], his[i], per_crop_range, hist_global,
                               res[i])
        return 0

    def sqt_crop_histogram_fold(self, counts, n, n_ch, bins, rule, lo, hi, per_crop_range, hist_global, out, stream):
        self.calls.append("fold")
        table = _view(counts, np.int32, n * n_ch * 256).reshape(n, n_ch, 256)
        los, his = _view(lo, np.float32, n), _view(hi, np.float32, n)
        res = _view(out, np.int32, n * n_ch * bins).reshape(n, n_ch, bins)
        for i in range(n):
            self._fold(table[i], bins, rule, los[i], his[i], per_crop_range, hist_global, res[i])
        return 0

    @staticmethod
    def _fold(tot, bins, rule, lo, hi, per_crop_range, hist_global, res):
        if rule == 0 and per_crop_range:
            present = np.nonzero(tot.sum(0))[0]
            lo, hi = (float(present[0]), float(present[-1])) if len(present) else (np.inf, -np.inf)
        vb = tf._k20_value_bins(float(lo), float(hi), bins, rule).numpy()
        if not hist_global:
            res[:] = 0  # the shared histogram, written whole
        for ch in range(tot.shape[0]):
            np.add.at(res[ch], vb[vb >= 0], tot[ch][vb >= 0].astype(np.int32))

    def sqt_crop_histogram(self, x, n, p, n_ch, bins, rule, lo, hi, per_crop_range, hist_global, gedges, counts,
                           stream):
        self.calls.append("float32")
        if rule == 1 and gedges is None and bins + 1 > 1024:
            return 1
        xs = torch.from_numpy(_view(x, np.float32, n * p * n_ch).reshape(n, p, n_ch).copy())
        los, his = (torch.from_numpy(_view(v, np.float32, n).copy()) for v in (lo, hi))
        got = tf._histogram_plain(xs, bins, rule, los, his, bool(per_crop_range)).to(torch.int32).numpy()
        res = _view(counts, np.int32, n * n_ch * bins)
        res[:] = got.ravel() + (res if hist_global else 0)  # a shared histogram is written whole
        return 0


@pytest.fixture
def emulated_k20(monkeypatch):
    from squidpy_torch import _cuda

    emu = _EmulatedK20()
    monkeypatch.setattr(_cuda, "launches", dict.fromkeys(_cuda.KERNELS, 0))  # counts of these calls stay here
    monkeypatch.setattr(tf, "k20_entry_launches", dict.fromkeys(tf.k20_entry_launches, 0))
    monkeypatch.setattr(_cuda, "library", lambda: emu)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(tf, "_device_info", lambda dev: (SMEM, SMS))
    return emu


@pytest.mark.parametrize("case", ["i2", "30000 bins", "fixed range", "split crop", "few crops", "rule 1 one crop",
                                  "2000 edges", "209 channels", "500 channels", "float32", "empty crops"])
def test_k20_wrapper_on_emulated_entries(case, emulated_k20):
    """``_histogram_k20`` around a numpy emulation of both entries' C
    interface, on each route, bitwise the plain version; the launches
    counted once a call."""
    from squidpy_torch import _cuda

    rng = np.random.default_rng(7)
    shapes = {"i2": (40, 89 * 89, 3, 10, None, 0), "30000 bins": (8, 300, 3, 30_000, None, 0),
              "fixed range": (30, 500, 3, 7, (50.5, 200.25), 0), "split crop": (1, 200_000, 1, 10, (10.0, 240.0), 1),
              "few crops": (3, 40_000, 3, 10, None, 0), "rule 1 one crop": (1, 7921, 1, 10, (40.0, 250.0), 1),
              "2000 edges": (1, 999, 1, 2000, (-3.0, 300.0), 1), "209 channels": (2, 30, 209, 10, None, 0),
              "500 channels": (2, 30, 500, 10, None, 0),
              "float32": (20, 999, 3, 10, None, 0), "empty crops": (0, 99, 3, 10, None, 0)}
    n, p, c, bins, v_range, rule = shapes[case]
    x = torch.from_numpy(rng.integers(0, 256, (n, p, c)).astype(np.uint8))
    if case == "float32":
        x = x.to(torch.float32) + 0.25
    lo = torch.full((n,), 0.0 if v_range is None else float(v_range[0]))
    hi = torch.full((n,), 0.0 if v_range is None else float(v_range[1]))
    got = tf._histogram_k20(x, bins, rule, lo, hi, v_range is None)
    want = tf._histogram_plain(x.to(torch.float32), bins, rule, lo, hi, v_range is None)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    layout = tf._k20_layout(n, p, c, bins, rule, x.dtype == torch.uint8, SMEM, SMS)
    expected = {"uint8": ["u8 fused"] if layout.fused else ["u8 split", "fold"], "float32": ["float32"]}[layout.entry]
    assert emulated_k20.calls == ([] if not n else expected)
    assert _cuda.launches["crop_histogram"] == (1 if n else 0)
    if case == "split crop":
        assert layout.splits > 1
    if case == "209 channels":  # the counters fit, the fold beside them does not: the value table
        assert (layout.entry, layout.fused, layout.splits) == ("uint8", False, 1)
    if case == "500 channels":
        assert layout.entry == "float32"


# ---------------------------------------------------------- the slice


def _section(pkg, n: int = 40, size: int = 160, seed: int = 0, dtype=np.uint8, diameter: float = 15.0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (size, size, 3)).astype(dtype)
    if dtype != np.uint8:
        img = img / dtype(255.0)
    adata = pkg.AnnData(X=np.zeros((n, 1)), obs=pd.DataFrame(index=[f"spot{i}" for i in range(n)]))
    adata.obsm["spatial"] = rng.uniform(5, size - 5, (n, 2))  # spots near the border: padded crops
    adata.uns["spatial"] = {"lib": {"scalefactors": {"spot_diameter_fullres": diameter}}}
    return adata, pkg.im.ImageContainer(img, layer="image")


def _assert_frames_close(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns) and list(got.index) == list(want.index)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if "texture" in col or col.endswith(("_mean", "_std")):
            rel = 1e-4 if "correlation" in col else SUM_TOL  # texture columns: float32 props of JAX
            assert np.allclose(g.astype(np.float64), w.astype(np.float64), rtol=rel, atol=rel, equal_nan=True), col
        else:
            assert np.array_equal(g.astype(np.float64), w.astype(np.float64), equal_nan=True), col


@pytest.mark.parametrize("kwargs", [{}, {"spot_scale": 2}, {"features_kwargs": {
    "summary": {"quantiles": (0.25, 0.75), "channels": [0, 2]}, "histogram": {"bins": 5, "v_range": (50, 200)},
    "texture": {"props": ("energy", "contrast"), "distances": (1, 2), "angles": (0, np.pi / 2)}}}],
    ids=["defaults", "spot_scale", "features_kwargs"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_calculate_image_features_batched(kwargs, dtype):
    """Equal crops take the batched path: one K19, K20 and K18 launch."""
    frames = []
    for pkg in (sqt, sq):
        adata, img = _section(pkg, dtype=dtype)
        assert pkg.im.calculate_image_features(adata, img, features=["summary", "histogram", "texture"], **kwargs) \
            is None
        frames.append(adata.obsm["img_features"])
    _assert_frames_close(*frames)


@pytest.mark.parametrize("kwargs", [{}, {"features_kwargs": {"histogram": {"bins": 7, "v_range": (50.5, 200.25)}}}],
                         ids=["own range", "fixed range"])
def test_calculate_image_features_uint8_and_float32_alike(kwargs):
    """A uint8 image (K20's byte entry on the card) and the same image as
    float32 (its float entry): each package's frames equal JAX's, and the
    histogram columns of the two dtypes equal each other."""
    frames = {}
    for dtype in (np.uint8, np.float32):
        for pkg in (sqt, sq):
            adata, img = _section(pkg, seed=5)
            if dtype == np.float32:
                img = pkg.im.ImageContainer(img["image"].astype(np.float32), layer="image")
            frames[dtype, pkg] = pkg.im.calculate_image_features(adata, img, features=["summary", "histogram"],
                                                                 copy=True, **kwargs)
        _assert_frames_close(frames[dtype, sqt], frames[dtype, sq])
    hist = [c for c in frames[np.uint8, sqt].columns if c.startswith("histogram")]
    assert len(hist) == 3 * kwargs.get("features_kwargs", {}).get("histogram", {}).get("bins", 10)
    assert np.array_equal(frames[np.uint8, sqt][hist].to_numpy(np.float64),
                          frames[np.float32, sqt][hist].to_numpy(np.float64))


def test_calculate_image_features_per_crop_with_segmentation():
    """``segmentation`` (and ``custom``) take the per-crop path: K19 and K20
    by ``jnp.quantile``'s and ``jnp.histogram``'s rules, K18's counts entry."""
    frames = []
    for pkg in (sqt, sq):
        adata, img = _section(pkg, n=12, size=120, seed=4)
        img.add_img(_blobs(120), layer="segmented")
        frames.append(pkg.im.calculate_image_features(
            adata, img, layer="image", features=["summary", "histogram", "texture", "segmentation", "custom"],
            features_kwargs={"segmentation": {"label_layer": "segmented",
                                              "props": ("label", "area", "centroid", "mean_intensity")},
                             "custom": {"func": lambda a: float(a.mean())}},
            copy=True))
    got, want = frames
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        if col == "segmentation_centroid":
            for g, w in zip(got[col], want[col]):
                assert np.array_equal(g, w)
        elif "mean_intensity" in col:
            assert np.allclose(got[col].astype(float), want[col].astype(float), rtol=SUM_TOL, atol=0, equal_nan=True), col
        elif col.startswith("texture") or col.endswith(("_mean", "_std")):
            _assert_frames_close(got[[col]], want[[col]])
        else:
            assert np.array_equal(got[col].to_numpy(np.float64), want[col].to_numpy(np.float64), equal_nan=True), col


def _blobs(size: int) -> np.ndarray:
    """A label image of a few square cells."""
    lab = np.zeros((size, size), dtype=np.uint32)
    for k, (y, x) in enumerate([(10, 10), (30, 60), (70, 20), (90, 90), (50, 45)], start=1):
        lab[y : y + 12, x : x + 9] = k
    return lab


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_calculate_image_features_ragged_crops(dtype):
    """Two libraries with other spot diameters give crops of two sizes: the
    per-crop path (float crops through ``_img_as_ubyte`` for the texture)."""
    frames = []
    for pkg in (sqt, sq):
        rng = np.random.default_rng(7)
        pixels = rng.integers(0, 256, (100, 100, 2, 3)).astype(np.uint8)
        if dtype == np.float32:
            pixels = pixels.astype(np.float32) / np.float32(255)
        img = pkg.im.ImageContainer(pixels, layer="image", library_id=["a", "b"])
        n = 16
        lib = np.where(np.arange(n) < 8, "a", "b")
        adata = pkg.AnnData(X=np.zeros((n, 1)), obs=pd.DataFrame({"lib": pd.Categorical(lib)},
                                                                  index=[f"s{i}" for i in range(n)]))
        adata.obsm["spatial"] = rng.uniform(10, 90, (n, 2))
        adata.uns["spatial"] = {"a": {"scalefactors": {"spot_diameter_fullres": 11.0}},
                                "b": {"scalefactors": {"spot_diameter_fullres": 17.0}}}
        frames.append(pkg.im.calculate_image_features(adata, img, library_id="lib",
                                                      features=["summary", "histogram", "texture"], copy=True))
    _assert_frames_close(*frames)


_NO_PANDAS = textwrap.dedent(
    """
    import sys
    for name in ("pandas", "jax", "squidpy_tpu", "PIL", "h5py"):
        sys.modules[name] = None
    import numpy as np, torch
    torch.set_num_threads(1)
    import squidpy_torch as sqt
    sqt.set_device("cpu")
    data = np.load(sys.argv[1])

    class StandIn:
        def __init__(self, coords):
            self.obs, self.obsm = {}, {"spatial": coords}
            self.uns = {"spatial": {"lib": {"scalefactors": {"spot_diameter_fullres": 15.0}}}}

    out = {}
    for path in ("batched", "per_crop"):
        adata = StandIn(data["coords"])
        img = sqt.im.ImageContainer(data["img"], layer="image")
        feats = ["summary", "histogram", "texture"] + (["custom"] if path == "per_crop" else [])
        sqt.im.calculate_image_features(adata, img, features=feats,
                                        features_kwargs={"custom": {"func": np.mean}})
        res = adata.obsm["img_features"]
        assert type(res).__name__ == "Columns" and list(res.index) == list(range(len(data["coords"])))
        for k, v in res.columns.items():
            out[f"{path}|{k}"] = np.asarray(v, dtype=np.float64)
    assert sys.modules.get("pandas") is None
    np.savez(sys.argv[2], names=np.asarray(list(out)), **{f"c{i}": v for i, v in enumerate(out.values())})
    print("OK")
    """
)


def test_calculate_image_features_without_pandas(tmp_path):
    """With pandas blocked, both paths give a Columns: JAX's columns, order and values."""
    adata, img = _section(sq, n=20)
    np.savez(tmp_path / "in.npz", coords=adata.obsm["spatial"], img=img["image"][:, :, 0, :])
    proc = subprocess.run([sys.executable, "-c", _NO_PANDAS, str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                          capture_output=True, text=True, timeout=300, cwd=str(ROOT), check=False)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    res = np.load(tmp_path / "out.npz")
    names = list(res["names"])
    for path in ("batched", "per_crop"):
        feats = ["summary", "histogram", "texture"] + (["custom"] if path == "per_crop" else [])
        adata, img = _section(sq, n=20)
        want = sq.im.calculate_image_features(adata, img, features=feats,
                                              features_kwargs={"custom": {"func": np.mean}}, copy=True)
        cols = [n.split("|", 1)[1] for n in names if n.startswith(f"{path}|")]
        assert cols == list(want.columns)
        got = pd.DataFrame({c: res[f"c{names.index(f'{path}|{c}')}"] for c in cols}, index=want.index)
        _assert_frames_close(got, want.astype(np.float64))
