"""PCA embedding of a device matrix (counterpart of ``squidpy_tpu/ops/pca.py``).

The ``(d, d)`` covariance and the projection are plain float32 matrix
products, ``torch.matmul`` with TF32 off (the JAX package leaves them to
XLA, outside any kernel); the small covariance is decomposed on the host in
float64 numpy, with the JAX package's sign convention: each component is
flipped so that its largest-magnitude loading is positive.
"""

from __future__ import annotations

import numpy as np
import torch

from squidpy_torch._device import full_float32, to_host

__all__ = ["pca_device"]


def pca_device(X: torch.Tensor, n_comps: int) -> torch.Tensor:
    """The top ``n_comps`` PCA embedding ``(n, n_comps)`` float32 of ``X``
    (n, d), on ``X``'s device; only the (d, d) covariance goes to the host."""
    X = X.to(torch.float32)
    n = X.shape[0]
    with full_float32():
        mu = X.mean(dim=0)
        xc = X - mu
        cov = (xc.T @ xc) / max(n - 1, 1)
    del xc
    w, v = np.linalg.eigh(to_host(cov, np.float64))  # ascending eigenvalues
    v = v[:, ::-1][:, :n_comps]
    flip = np.sign(v[np.argmax(np.abs(v), axis=0), np.arange(v.shape[1])])
    flip[flip == 0] = 1.0
    comps = torch.from_numpy(np.ascontiguousarray(v * flip).astype(np.float32)).to(X.device)
    with full_float32():
        return (X - mu) @ comps
