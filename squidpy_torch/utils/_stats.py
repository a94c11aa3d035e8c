"""Multiple-testing corrections (verbatim copy of ``squidpy_tpu/utils/_stats.py``).

Upstream squidpy calls ``statsmodels.stats.multitest.multipletests`` in
``gr/_ppatterns.py``; this module reimplements the methods squidpy uses in
plain numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["multipletests"]


def _fdr_bh(pvals: np.ndarray) -> np.ndarray:
    n = len(pvals)
    order = np.argsort(pvals)
    ranked = pvals[order] * n / np.arange(1, n + 1)
    adj = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.minimum(adj, 1.0)
    return out

def _fdr_by(pvals: np.ndarray) -> np.ndarray:
    n = len(pvals)
    c = np.sum(1.0 / np.arange(1, n + 1))
    order = np.argsort(pvals)
    ranked = pvals[order] * n * c / np.arange(1, n + 1)
    adj = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.minimum(adj, 1.0)
    return out

def _bonferroni(pvals: np.ndarray) -> np.ndarray:
    return np.minimum(pvals * len(pvals), 1.0)

def _holm(pvals: np.ndarray) -> np.ndarray:
    n = len(pvals)
    order = np.argsort(pvals)
    ranked = pvals[order] * (n - np.arange(n))
    adj = np.maximum.accumulate(ranked)
    out = np.empty(n)
    out[order] = np.minimum(adj, 1.0)
    return out

def _sidak(pvals: np.ndarray) -> np.ndarray:
    return 1.0 - np.power(1.0 - pvals, len(pvals))


_METHODS = {
    "fdr_bh": _fdr_bh,
    "fdr_by": _fdr_by,
    "bonferroni": _bonferroni,
    "holm": _holm,
    "sidak": _sidak,
}


def multipletests(
    pvals: np.ndarray,
    alpha: float = 0.05,
    method: str = "fdr_bh",
) -> tuple[np.ndarray, np.ndarray, float, float]:
    """statsmodels-compatible signature subset: returns
    ``(reject, pvals_corrected, alphacSidak, alphacBonf)``."""
    pvals = np.asarray(pvals, dtype=float)
    finite = np.isfinite(pvals)
    out = np.full_like(pvals, np.nan)
    if finite.any():
        fn = _METHODS.get(method)
        if fn is None:
            raise ValueError(f"Unknown correction method `{method}`. Valid: {sorted(_METHODS)}.")
        out[finite] = fn(pvals[finite])
    reject = out <= alpha
    n = max(int(finite.sum()), 1)
    return reject, out, 1.0 - (1.0 - alpha) ** (1.0 / n), alpha / n
