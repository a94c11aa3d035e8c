"""squidpy_torch's PCA, GMM and z-scores (``ops/pca.py``, ``ops/gmm.py``,
``models/clustering.py``) against squidpy_tpu's.

Tolerances. The covariance, the projection, the EM's products and the
z-scores' reductions are float32 sums that torch and XLA take in their own
orders, so they agree to a stated relative tolerance, not bitwise:

- the PCA embedding within :data:`PCA_TOL` of the largest |value| of each
  component, on fixtures whose eigenvalues are asserted to be at least
  :data:`EIG_GAP` apart (relative), so no component turns with the rounding;
- the GMM's labels and iteration counts equal, on fixtures where every
  point's two largest log-responsibilities under the port's fit are
  asserted at least :data:`GMM_MARGIN` apart; the last mean
  log-likelihood within 1e-5 relative, the means within :data:`MEAN_TOL`
  of the data's scale;
- z-scores within 1e-6 relative (float32 means and deviations);
- the host branches (sklearn's PCA and GaussianMixture below the device
  sizes, numpy z-scores) are the same code in both packages: bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import squidpy_torch as sqt
from squidpy_torch.models import clustering as tcl
from squidpy_torch.ops import gmm as tgmm
from squidpy_torch.ops import pca as tpca
from squidpy_tpu.models import clustering as jcl
from squidpy_tpu.ops import gmm as jgmm
from squidpy_tpu.ops import pca as jpca

torch.set_num_threads(1)

PCA_TOL = 1e-4
EIG_GAP = 1e-2
GMM_MARGIN = 1e-2
MEAN_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _low_rank(n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scales = np.geomspace(10.0, 0.1, d)
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    return ((rng.normal(size=(n, d)) * scales) @ basis.T + rng.normal(3.0, 1.0, d)).astype(np.float32)


def _blobs(n: int, k: int, d: int, seed: int, sep: float = 6.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=sep, size=(k, d))
    scales = rng.uniform(0.5, 1.5, size=(k, d))
    labels = rng.integers(0, k, size=n)
    return (centers[labels] + rng.normal(size=(n, d)) * scales[labels]).astype(np.float32)


@pytest.mark.parametrize(("n", "d", "n_comps"), [(3000, 12, 5), (2000, 40, 10), (500, 8, 7)])
def test_pca_device_against_jax(n, d, n_comps):
    x = _low_rank(n, d, seed=d)
    ev = np.linalg.eigvalsh(np.cov(x.astype(np.float64), rowvar=False))[::-1][: n_comps + 1]
    assert np.all(-np.diff(ev) / ev[:-1] > EIG_GAP), "fixture: components too close to call"
    et = tpca.pca_device(torch.from_numpy(x), n_comps).numpy()
    ej = np.asarray(jpca.pca_device(x, n_comps))
    assert et.shape == ej.shape == (n, n_comps) and et.dtype == np.float32
    scale = np.abs(ej).max(axis=0)
    assert np.all(np.abs(et - ej) <= PCA_TOL * scale)


def test_pca_embed_dispatch():
    x = _low_rank(400, 10, 1)
    on_device = tcl.pca_embed(torch.from_numpy(x))
    assert isinstance(on_device, torch.Tensor) and on_device.shape == (400, 9)  # min(50, min(shape) - 1)
    np.testing.assert_array_equal(tcl.pca_embed(x), jcl.pca_embed(x))  # sklearn's host PCA in both
    assert tcl.pca_embed(torch.from_numpy(x), n_comps=99).shape == (400, 9)


def _margins(x: np.ndarray, k: int, seed: int, n_it: int) -> np.ndarray:
    """Each point's gap between its two largest log-responsibilities under
    the port's fit after ``n_it`` iterations."""
    xt = torch.from_numpy(x) - torch.from_numpy(x).mean(dim=0)
    idx = np.random.RandomState(seed).choice(len(x), size=k, replace=False)
    means = xt[torch.from_numpy(idx)]
    covs = (1e-6 * torch.eye(x.shape[1])).expand(k, -1, -1).contiguous()
    weights = torch.full((k,), 1.0 / k)
    for _ in range(n_it):
        resp, _ = tgmm._e_step(xt, weights, means, covs)
        weights, means, covs = tgmm._m_step(xt, resp, 1e-6)
    resp, _ = tgmm._e_step(xt, weights, means, covs)
    top2 = torch.topk(torch.log(resp.to(torch.float64)), 2, dim=0).values
    return (top2[0] - top2[1]).numpy()


@pytest.mark.parametrize(("n", "k", "d", "seed"), [(3000, 3, 4, 1), (4000, 4, 6, 2), (2500, 5, 3, 7)])
def test_gmm_against_jax(n, k, d, seed):
    x = _blobs(n, k, d, seed)
    idx = np.random.RandomState(seed).choice(n, size=k, replace=False)
    lt, mt, llt, it_t = tgmm._gmm_em(torch.from_numpy(x), idx, 1e-6, 1e-3, 100)
    lj, mj, llj, it_j = jgmm._gmm_em(x, idx, np.float32(1e-6), np.float32(1e-3), 100)
    assert np.all(_margins(x, k, seed, it_t) > GMM_MARGIN), "fixture: a point near a decision boundary"
    assert int(it_j) == it_t
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert abs(llt - float(llj)) <= 1e-5 * abs(float(llj))
    assert np.all(np.abs(mt.numpy() - np.asarray(mj)) <= MEAN_TOL * np.abs(x).max())
    np.testing.assert_array_equal(tgmm.gmm_em_labels(x, k, seed), jgmm.gmm_em_labels(x, k, seed))


def test_gmm_stops_at_max_iter_and_rejects_too_many_components():
    x = _blobs(1000, 3, 2, 3)
    idx = np.random.RandomState(0).choice(1000, size=3, replace=False)
    assert tgmm._gmm_em(torch.from_numpy(x), idx, 1e-6, 0.0, 4)[3] == 4
    with pytest.raises(ValueError, match="exceeds n_samples"):
        tgmm.gmm_em_labels(x[:2], 3)


def test_gmm_collapsed_component_labels_one_cluster_as_jax():
    """From ``random_from_data`` starts at ``reg_covar * I``, the first
    E-step assigns every row to its nearest start, so a component of fewer
    rows than features gets a covariance that float32 cannot factor
    (``reg_covar`` 1e-6 is below an ulp of its variances). XLA's Cholesky
    returns NaN factors there, and so does the port's (``cholesky_ex``, the
    factor set to NaN where ``info != 0``): the mean log-likelihood turns
    NaN, the loop stops on the same iteration, and every row is labelled 0
    in both packages. ``calculate_niche(flavor='cellcharter')`` meets it at
    1000 cells of 50 PCA components and 10 components."""
    x = (np.random.default_rng(0).normal(size=(1000, 50)) * np.geomspace(10.0, 1.0, 50)).astype(np.float32)
    idx = np.random.RandomState(42).choice(1000, size=10, replace=False)
    lt, _, llt, it_t = tgmm._gmm_em(torch.from_numpy(x), idx, 1e-6, 1e-3, 100)
    lj, _, llj, it_j = jgmm._gmm_em(x, idx, np.float32(1e-6), np.float32(1e-3), 100)
    assert np.isnan(llt) and np.isnan(float(llj))
    assert it_t == int(it_j)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    labels = tgmm.gmm_em_labels(x, 10, 42)
    np.testing.assert_array_equal(labels, np.asarray(jgmm.gmm_em_labels(x, 10, 42)))
    assert np.unique(labels).tolist() == [0]


def test_gmm_cluster_dispatch(monkeypatch):
    x = _blobs(600, 3, 3, 4)
    np.testing.assert_array_equal(tcl.gmm_cluster(x, 3, 5), jcl.gmm_cluster(x, 3, 5))  # sklearn in both
    monkeypatch.setattr(tcl, "_GMM_DEVICE_MIN_N", 500)
    np.testing.assert_array_equal(tcl.gmm_cluster(x, 3, 5), tgmm.gmm_em_labels(x, 3, 5))
    np.testing.assert_array_equal(tcl.gmm_cluster(torch.from_numpy(x[:100]), 3, 5), tgmm.gmm_em_labels(x[:100], 3, 5))


def test_zscore_against_jax():
    x = _low_rank(1000, 6, 2)
    x[:, 3] = 2.5  # a constant column: divided by 1
    zt = tcl.zscore(torch.from_numpy(x)).numpy()
    zj = np.asarray(jcl.zscore(__import__("jax").numpy.asarray(x)))
    assert zt.dtype == np.float32 and np.all(zt[:, 3] == 0)
    np.testing.assert_allclose(zt, zj, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcl.zscore(x.astype(np.float64)), jcl.zscore(x.astype(np.float64)))
