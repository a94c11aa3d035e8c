"""Spatial autocorrelation: Moran's I and Geary's C, batched over genes
(counterpart of ``squidpy_tpu/ops/autocorr.py``).

- Scores run one pass over the padded-ELL graph per gene block: kernel K5a
  (``csrc/ell_autocorr.cu``) computes ``u = W x``, or, without materialising
  ``u``, the Moran numerator ``sum_i z_i (W z)_i`` or the Geary numerator
  ``sum_ij w_ij (x_i - x_j)^2`` per gene. Degree-bucketed graphs launch it
  once per bucket.
- Permutations use the algebra of row-permuted weights: with ``u = W z``,
  ``z^T P W z = sum_i z_i u_p(i)``, and Geary's permuted numerator is
  ``sum_i z_i (z_i r_p(i) - 2 u_p(i)) + c_g`` with ``r`` the row sums of W and
  the permutation-invariant ``c_g = sum_j colsum_j z_j^2``. Kernel K5b
  (``csrc/perm_autocorr.cu``) computes the sums for all permutations.

A CPU tensor runs each kernel's plain torch version below, which follows the
JAX package's order of operations; a CUDA tensor launches the kernel. The
port computes in float32 everywhere (the JAX package's bf16 gathers at
n >= 2^19 are a TPU choice the port does not copy).
"""

from __future__ import annotations

import torch

from squidpy_torch import _cuda

__all__ = [
    "geary_perm_scores",
    "geary_scores",
    "geary_scores_bucketed",
    "geary_scores_from_u",
    "moran_perm_scores",
    "moran_scores",
    "moran_scores_bucketed",
    "moran_scores_from_u",
    "perm_autocorr",
    "ell_autocorr",
    "spmv_genes",
    "spmv_genes_bucketed",
]

MODES = {"spmv": 0, "moran": 1, "geary": 2}

# K5a launch: 32 genes x 8 rows per block; row groups sized for ~4096
# blocks, each walking its rows in order
_K5A_TARGET_BLOCKS = 4096
# K5b launch: 32 genes x 32 permutations per block, over a fixed number of
# row groups whose (R, P, g) partials are summed in a second pass
_K5B_TARGET_BLOCKS = 2048
_K5B_MAX_GROUPS = 64


def _ell_plain(mode: str, indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
               rows: torch.Tensor | None) -> torch.Tensor:
    """Plain torch version of K5a, slot by slot as the JAX package sums:
    ``spmv`` -> (n_b, g) rows of ``W x``; ``moran`` -> (g,) ``sum_i (w z_i) z_j``;
    ``geary`` -> (g,) ``sum_i w (x_i - x_j)^2``."""
    xr = x if rows is None else x[rows.long()]
    idx = indices.long()
    acc = torch.zeros(xr.shape if mode == "spmv" else x.shape[1:], dtype=x.dtype, device=x.device)
    for k in range(indices.shape[1]):
        w = weights[:, k, None]
        xj = x[idx[:, k]]
        if mode == "spmv":
            acc = acc + w * xj
        elif mode == "moran":
            acc = acc + torch.sum((w * xr) * xj, dim=0)
        else:
            diff = xr - xj
            acc = acc + torch.sum(w * (diff * diff), dim=0)
    return acc


def _k5a_groups(n_rows: int, n_genes: int) -> int:
    gene_tiles = -(-n_genes // 32)
    return max(1, min(-(-n_rows // 8), -(-_K5A_TARGET_BLOCKS // gene_tiles)))


def ell_autocorr(mode: str, indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
                 rows: torch.Tensor | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K5a over a padded-ELL graph or one degree bucket of it.

    ``indices``/``weights`` (n_b, k) int32/float32 are the ELL rows (of the
    bucket ``rows``, or of rows ``0..n-1`` when ``rows`` is None); ``x`` is
    the (n, g) float32 gene block. ``mode='spmv'`` returns ``W x``: with
    ``rows``, as an (n, g) tensor (``out`` if given, else zeros) whose rows
    ``rows`` are written;
    ``'moran'``/``'geary'`` return the (g,) numerator over those rows. A CPU
    tensor runs the plain torch version; a CUDA tensor launches the kernel.
    """
    if mode not in MODES:
        raise ValueError(f"Unknown ELL mode `{mode}`; expected one of {sorted(MODES)}.")
    if indices.device.type == "cpu":
        res = _ell_plain(mode, indices, weights, x, rows)
        if mode != "spmv" or (rows is None and out is None):
            return res
        if out is None:
            out = torch.zeros_like(x)
        out[rows.long() if rows is not None else slice(None)] = res
        return out
    n_b, k = indices.shape
    n, g = x.shape
    _cuda.require(indices, "indices", torch.int32)
    _cuda.require(weights, "weights", torch.float32, (n_b, k))
    _cuda.require(x, "x", torch.float32)
    if rows is not None:
        _cuda.require(rows, "rows", torch.int32, (n_b,))
    elif n_b != n:
        raise ValueError(f"without `rows` the ELL graph must have {n} rows, found {n_b}.")
    if n >= 2**31 or n * g >= 2**40 or n_b * k >= 2**31:
        raise ValueError("the ELL kernel takes fewer than 2^31 rows and edges.")
    if n_b * k and (int(indices.min()) < 0 or int(indices.max()) >= n):
        raise ValueError("neighbour indices must lie in [0, n).")
    if rows is not None and n_b and (int(rows.min()) < 0 or int(rows.max()) >= n):
        raise ValueError("bucket rows must lie in [0, n).")
    groups = _k5a_groups(n_b, g)
    partial = None
    if mode == "spmv":
        if out is None:  # a bucket writes only its rows
            out = (torch.zeros if rows is not None else torch.empty)((n, g), dtype=torch.float32, device=x.device)
        _cuda.require(out, "out", torch.float32, (n, g))
        result = out
    else:
        partial = torch.empty((groups, g), dtype=torch.float64, device=x.device)
        result = torch.zeros((g,), dtype=torch.float32, device=x.device)
    if n_b == 0 or g == 0:
        return result
    code = _cuda.library().sqt_ell_autocorr(
        MODES[mode], rows.data_ptr() if rows is not None else None, indices.data_ptr(), weights.data_ptr(),
        n_b, k, x.data_ptr(), g, groups, out.data_ptr() if partial is None else None,
        partial.data_ptr() if partial is not None else None, result.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "ell_autocorr")
    _cuda.launches["ell_autocorr"] += 1
    return result


def spmv_genes(indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``W @ x`` for ``x`` of shape ``(n, g)`` over a padded-ELL graph."""
    return ell_autocorr("spmv", indices, weights, x)


def spmv_genes_bucketed(buckets: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """``W @ x`` over degree buckets, each bucket's rows written in place."""
    u = torch.zeros_like(x)
    for rows, idx, w in buckets:
        ell_autocorr("spmv", idx, w, x, rows, out=u)
    return u


def _centered(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    z = x - torch.mean(x, dim=0, keepdim=True)
    return z, torch.sum(z * z, dim=0)


def moran_scores(indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor, s0: float) -> torch.Tensor:
    """Moran's I per gene, ``(n / S0) (z^T W z) / (z^T z)``, without materialising ``W z``."""
    z, den = _centered(x)
    return (x.shape[0] / s0) * ell_autocorr("moran", indices, weights, z) / den


def moran_scores_bucketed(buckets: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], x: torch.Tensor,
                          s0: float) -> torch.Tensor:
    """Moran's I per gene over degree buckets (the same result as :func:`moran_scores`)."""
    z, den = _centered(x)
    num = sum(ell_autocorr("moran", idx, w, z, rows) for rows, idx, w in buckets)
    return (x.shape[0] / s0) * num / den


def geary_scores(indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor, s0: float) -> torch.Tensor:
    """Geary's C per gene, ``((n-1) / (2 S0)) sum w_ij (x_i - x_j)^2 / sum (x_i - mean)^2``."""
    num = ell_autocorr("geary", indices, weights, x)
    _, den = _centered(x)
    return ((x.shape[0] - 1) / (2.0 * s0)) * num / den


def geary_scores_bucketed(buckets: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], x: torch.Tensor,
                          s0: float) -> torch.Tensor:
    """Geary's C per gene over degree buckets (the same result as :func:`geary_scores`)."""
    num = sum(ell_autocorr("geary", idx, w, x, rows) for rows, idx, w in buckets)
    _, den = _centered(x)
    return ((x.shape[0] - 1) / (2.0 * s0)) * num / den


def moran_scores_from_u(z: torch.Tensor, u: torch.Tensor, s0: float) -> torch.Tensor:
    """Moran's I from centred values and ``u = W z`` (plain torch)."""
    return (z.shape[0] / s0) * torch.sum(z * u, dim=0) / torch.sum(z * z, dim=0)


def geary_scores_from_u(z: torch.Tensor, u: torch.Tensor, row_sums: torch.Tensor, col_sums: torch.Tensor,
                        s0: float) -> torch.Tensor:
    """Geary's C from centred values and ``u = W z`` (plain torch):
    ``sum_ij w_ij (z_i - z_j)^2 = sum_i (r_i + c_i) z_i^2 - 2 z^T u``."""
    num = torch.sum((row_sums + col_sums)[:, None] * (z * z) - 2.0 * (z * u), dim=0)
    return ((z.shape[0] - 1) / (2.0 * s0)) * num / torch.sum(z * z, dim=0)


def _perm_plain(mode: str, z: torch.Tensor, u: torch.Tensor, r: torch.Tensor | None,
                perms: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K5b: ``(P, g)`` permuted numerators, a few
    permutations at a time."""
    n, g = z.shape
    out = torch.empty((perms.shape[0], g), dtype=z.dtype, device=z.device)
    step = max(1, (1 << 26) // max(n * g, 1))
    for p0 in range(0, perms.shape[0], step):
        pc = perms[p0 : p0 + step].long()
        ug = u[pc]  # (c, n, g)
        if mode == "moran":
            out[p0 : p0 + step] = torch.sum(z * ug, dim=1)
        else:
            out[p0 : p0 + step] = torch.sum(z * (z * r[pc][:, :, None] - 2.0 * ug), dim=1)
    return out


def _k5b_groups(n: int, n_genes: int, n_perms: int) -> int:
    tiles = -(-n_genes // 32) * -(-n_perms // 32)
    return max(1, min(n, _K5B_MAX_GROUPS, -(-_K5B_TARGET_BLOCKS // tiles)))


def perm_autocorr(mode: str, z: torch.Tensor, u: torch.Tensor, perms: torch.Tensor,
                  r: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K5b: ``(P, g)`` float32 permuted numerators.

    ``moran``: ``sum_i z[i, g] u[p(i), g]``; ``geary``: ``sum_i z[i, g] (z[i, g]
    r[p(i)] - 2 u[p(i), g])``. ``perms`` is ``(P, n)`` int32, read through its
    strides, so the transposed view of K4's ``(n, P)`` positions needs no
    copy. A CPU tensor runs the plain torch version; a CUDA tensor launches
    the kernel.
    """
    if mode not in ("moran", "geary"):
        raise ValueError(f"Unknown permutation mode `{mode}`; expected 'moran' or 'geary'.")
    if (mode == "geary") != (r is not None):
        raise ValueError("row sums `r` are given for Geary's C and only for it.")
    if z.device.type == "cpu":
        return _perm_plain(mode, z, u, r, perms)
    n, g = z.shape
    n_perms = perms.shape[0]
    _cuda.require(z, "z", torch.float32)
    _cuda.require(u, "u", torch.float32, (n, g))
    if r is not None:
        _cuda.require(r, "r", torch.float32, (n,))
    if perms.device != z.device or perms.dtype != torch.int32 or perms.ndim != 2 or perms.shape[1] != n:
        raise ValueError(f"`perms` must be a (P, {n}) int32 tensor on {z.device}.")
    if n >= 2**31 or n * g >= 2**40:
        raise ValueError("the permutation kernel takes fewer than 2^31 rows.")
    if n_perms and n and (int(perms.min()) < 0 or int(perms.max()) >= n):
        raise ValueError("permutation indices must lie in [0, n).")
    out = torch.empty((n_perms, g), dtype=torch.float32, device=z.device)
    if n_perms == 0 or g == 0 or n == 0:
        return out.zero_()
    groups = _k5b_groups(n, g, n_perms)
    partial = torch.empty((groups, n_perms, g), dtype=torch.float64, device=z.device)
    code = _cuda.library().sqt_perm_autocorr(
        MODES[mode], z.data_ptr(), u.data_ptr(), r.data_ptr() if r is not None else None, n, g,
        perms.data_ptr(), n_perms, perms.stride(0), perms.stride(1), groups, partial.data_ptr(), out.data_ptr(),
        _cuda.stream_ptr(),
    )
    _cuda.check(code, "perm_autocorr")
    _cuda.launches["perm_autocorr"] += 1
    return out


def moran_perm_scores(z: torch.Tensor, u: torch.Tensor, perms: torch.Tensor, s0: float) -> torch.Tensor:
    """Moran's I under row permutations of W: ``(P, g)``, ``perms`` ``(P, n)``."""
    den = torch.sum(z * z, dim=0)
    return (z.shape[0] / s0) * perm_autocorr("moran", z, u, perms) / den


def geary_perm_scores(z: torch.Tensor, u: torch.Tensor, r: torch.Tensor, cg: torch.Tensor, perms: torch.Tensor,
                      s0: float) -> torch.Tensor:
    """Geary's C under row permutations of W: ``(P, g)``. ``r`` are the row
    sums of W and ``cg`` the permutation-invariant third term, both from the
    caller."""
    den = torch.sum(z * z, dim=0)
    return ((z.shape[0] - 1) / (2.0 * s0)) * (perm_autocorr("geary", z, u, perms, r) + cg) / den
