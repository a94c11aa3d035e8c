"""Full-covariance Gaussian-mixture EM on the device (counterpart of ``squidpy_tpu/ops/gmm.py``).

Every E and M step is a few float32 ``einsum`` products over the ``(n, d)``
data with TF32 off, and per-component Cholesky factors
(``torch.linalg.cholesky_ex``, ``torch.cholesky_solve``). The fit is the JAX
package's: the data centred once, means started at ``n_components`` data
rows drawn by ``np.random.RandomState(random_state).choice`` (the rows
sklearn's ``random_from_data`` takes for the seed, so both packages fit
from one start), covariances at ``reg_covar * I``, one E-step an
iteration whose mean log-likelihood is the convergence test (one
iteration of lag against sklearn's), and ``max_iter``. The loop reads one
scalar back an iteration for its stop test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from squidpy_torch._device import full_float32, get_device, to_host

__all__ = ["gmm_em_labels"]


def _e_step(X: torch.Tensor, weights: torch.Tensor, means: torch.Tensor, covs: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Responsibilities ``(K, n)`` and the mean log-likelihood a sample."""
    d = X.shape[1]
    k = means.shape[0]
    # a covariance that float32 cannot factor gets an all-NaN factor, as
    # XLA's Cholesky gives it: the log-likelihood turns NaN, the loop's stop
    # test fails and every row is labelled 0, as in the JAX package (no
    # read-back of `info`)
    chol, info = torch.linalg.cholesky_ex(covs)  # (K, d, d)
    chol = torch.where((info != 0)[:, None, None], torch.nan, chol)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(dim=1)
    eye = torch.eye(d, dtype=X.dtype, device=X.device).expand(k, d, d)
    prec = torch.cholesky_solve(eye, chol)
    # quad(x, k) = x' P_k x - 2 x' P_k mu_k + mu_k' P_k mu_k
    xp = torch.einsum("nd,kde->kne", X, prec)
    xpx = torch.einsum("knd,nd->kn", xp, X)
    pmu = torch.einsum("kde,ke->kd", prec, means)
    xpmu = torch.einsum("nd,kd->kn", X, pmu)
    mupmu = torch.einsum("kd,kd->k", means, pmu)
    quad = xpx - 2.0 * xpmu + mupmu[:, None]
    log2pi = torch.tensor(np.log(2.0 * np.pi), dtype=X.dtype, device=X.device)
    logp = -0.5 * (d * log2pi + logdet[:, None] + quad)
    logr = logp + torch.log(weights)[:, None]
    lse = torch.logsumexp(logr, dim=0)
    return torch.exp(logr - lse[None, :]), lse.mean()


def _m_step(X: torch.Tensor, resp: torch.Tensor, reg_covar: float
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weights, means and covariances from the responsibilities (centred form)."""
    n, d = X.shape
    nk = resp.sum(dim=1) + 10.0 * torch.finfo(X.dtype).eps
    means = torch.einsum("kn,nd->kd", resp, X) / nk[:, None]
    xc = X[None, :, :] - means[:, None, :]
    covs = torch.einsum("kn,knd,kne->kde", resp, xc, xc) / nk[:, None, None]
    covs = covs + reg_covar * torch.eye(d, dtype=X.dtype, device=X.device)
    return nk / n, means, covs


def _gmm_em(X: torch.Tensor, init_idx: np.ndarray, reg_covar: float, tol: float, max_iter: int
            ) -> tuple[torch.Tensor, torch.Tensor, float, int]:
    """The fit from the rows ``init_idx``: labels (n,) int32, means, the last
    mean log-likelihood and the iterations run."""
    X = X - X.mean(dim=0)
    k, d = len(init_idx), X.shape[1]
    means = X[torch.from_numpy(np.asarray(init_idx, dtype=np.int64)).to(X.device)]
    covs = (reg_covar * torch.eye(d, dtype=X.dtype, device=X.device)).expand(k, d, d).contiguous()
    weights = torch.full((k,), 1.0 / k, dtype=X.dtype, device=X.device)
    ll_prev, n_it, dll, tol32 = -math.inf, 0, np.float32(np.inf), np.float32(tol)
    with full_float32():
        while n_it < max_iter and dll >= tol32:
            # one E-step an iteration: its log-likelihood (under the
            # parameters entering the iteration) is the convergence monitor
            resp, ll = _e_step(X, weights, means, covs)
            weights, means, covs = _m_step(X, resp, reg_covar)
            ll = float(ll)
            n_it += 1
            dll = abs(np.float32(ll) - np.float32(ll_prev))
            ll_prev = ll
        resp, ll = _e_step(X, weights, means, covs)
    return torch.argmax(resp, dim=0).to(torch.int32), means, float(ll), n_it


def gmm_em_labels(X, n_components: int, random_state: int = 42, *, reg_covar: float = 1e-6, tol: float = 1e-3,
                  max_iter: int = 100) -> np.ndarray:
    """Cluster labels ``(n,)`` of a full-covariance GMM EM fit, as sklearn's
    ``GaussianMixture(init_params='random_from_data', reg_covar=1e-6,
    tol=1e-3, max_iter=100)`` defines it; ``X`` is a tensor (fitted on its
    device) or a host array (fitted on the selected device)."""
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(get_device())
    X = X.to(torch.float32)
    n = X.shape[0]
    if n_components > n:
        raise ValueError(f"n_components={n_components} exceeds n_samples={n}.")
    idx = np.random.RandomState(random_state).choice(n, size=n_components, replace=False)
    labels, _, _, _ = _gmm_em(X, idx, reg_covar, tol, max_iter)
    return to_host(labels)
