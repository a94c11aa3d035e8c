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
JAX package's order of operations; a CUDA tensor launches the kernel. Scores
are float32. The permutation null takes its operands as the caller gives
them: float32, or, at ``n >= BF16_GATHER_MIN_N`` cells, ``z``, ``u`` and
``r`` in bf16 as the JAX package gathers them there. Products of bf16 values
are exact in float32 and are summed in float32 or wider; the numerator is
then rounded to bf16 once, and scaled in the JAX package's dtypes (see
:func:`moran_perm_scores` and :func:`geary_perm_scores`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
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

# K5a launch: persistent blocks of 8 warps; a warp's item is consecutive ELL
# rows of one 128-gene slice (4 genes a lane), and the items the resident
# warps hold at once cover a stretch of rows whose gene rows fill this share
# of the L2 (a quarter: on an H100 at 1M x 512 a quarter and an eighth were
# fastest, a half ~25% slower)
_K5A_WARPS = 8  # csrc/ell_autocorr.cu kWarps
_K5A_SLICE = 128  # genes a warp: 32 lanes x kVec
_K5A_L2_SHARE = 0.25
# K5b launch: one launch per 16-gene tile of u, which stays in L2 while the
# tile's records are gathered (32-byte bf16 records from 2^19 rows, 64-byte
# float32 records below, so at most 32 MB a tile); blocks of 32 / (record /
# 16) permutations x a row group, ~1024 blocks a launch; the (groups, P, g)
# partials are summed in a second pass
_K5B_GENES = 16
_K5B_TARGET_BLOCKS = 1024
_K5B_MIN_GROUP_ROWS = 16 * 8  # one run of 16 rows for each of a block's 8 warps
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ell_plain(mode: str, indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
               rows: torch.Tensor | None, walk: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of K5a, slot by slot as the JAX package sums:
    ``spmv`` -> (n_b, g) rows of ``W x`` (in the order of ``rows``, or of
    ``walk`` over the graph's own rows); ``moran`` -> (g,) ``sum_i (w z_i)
    z_j``; ``geary`` -> (g,) ``sum_i w (x_i - x_j)^2``, summed over the rows
    in that order."""
    if walk is not None:
        rows, indices, weights = walk, indices[walk.long()], weights[walk.long()]
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


class K5aLayout(NamedTuple):
    """How a K5a launch covers its rows: float4 lanes (``aligned``) or
    scalar loads, ``slices`` 128-gene slices, ``blocks`` persistent blocks
    (``resident_per_sm`` an SM at ``registers`` a thread), ``groups`` warps
    a slice, items of ``rows_per_item`` rows, and the ``stretch_rows`` the
    resident warps' items cover at once."""

    aligned: bool
    slices: int
    blocks: int
    groups: int
    rows_per_item: int
    items: int
    stretch_rows: int
    resident_per_sm: int
    registers: int


def _k5a_layout(n_b: int, g: int, aligned: bool, resident_per_sm: int, registers: int, sms: int,
                l2_bytes: int) -> K5aLayout:
    """The launch for ``n_b`` ELL rows of ``g`` genes: every warp resident,
    and items sized so the warps' rows together hold ``_K5A_L2_SHARE`` of
    the L2 in gene rows (at most an equal share of the rows each)."""
    slices = -(-g // _K5A_SLICE)
    blocks = max(resident_per_sm * sms, -(-slices // _K5A_WARPS))
    groups = blocks * _K5A_WARPS // slices
    stretch = max(1, int(l2_bytes * _K5A_L2_SHARE) // (4 * g))
    rows_per_item = max(1, min(stretch // groups, -(-n_b // groups)))
    items = -(-n_b // rows_per_item) * slices
    return K5aLayout(aligned, slices, blocks, groups, rows_per_item, items, groups * rows_per_item, resident_per_sm,
                     registers)


@functools.lru_cache(maxsize=None)
def _k5a_device(mode: int, aligned: bool, device: int) -> tuple[int, int, int, int]:
    """Resident blocks an SM and registers a thread of one K5a instance, and
    the device's SMs and L2 bytes (read once per device)."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _cuda.check(_cuda.library().sqt_ell_autocorr_layout(mode, int(aligned), out), "ell_autocorr")
    return tuple(out)


def k5a_layout(mode: str, n_b: int, x: torch.Tensor, out: torch.Tensor | None = None) -> K5aLayout:
    """The layout of a K5a launch over ``n_b`` ELL rows of the CUDA gene
    block ``x`` (and ``u``, ``out``): float4 lanes when every row of both
    starts on 16 bytes."""
    g = x.shape[1]
    aligned = g % 4 == 0 and x.data_ptr() % 16 == 0 and (out is None or out.data_ptr() % 16 == 0)
    per_sm, regs, sms, l2 = _k5a_device(MODES[mode], aligned, x.device.index or 0)
    return _k5a_layout(n_b, g, aligned, per_sm, regs, sms, l2)


def ell_autocorr(mode: str, indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
                 rows: torch.Tensor | None = None, out: torch.Tensor | None = None,
                 walk: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K5a over a padded-ELL graph, one degree bucket of it, or the
    whole graph in a walk order.

    ``indices``/``weights`` (n_b, k) int32/float32 are the ELL rows of the
    distinct graph rows ``rows`` (of rows ``0..n-1`` when ``rows`` is None).
    ``walk``, an (n,) int32 permutation of ``x``'s n rows, instead walks the
    graph's own arrays (row i for graph row i) in that order: the kernel
    reads each row's slots through it, and no ELL row moves. ``x`` is the
    (n, g) float32 gene block. ``mode='spmv'`` returns ``W x``: with
    ``rows``, as an (n, g) tensor (``out`` if given, else new: zeros where
    ``rows`` leave rows unwritten) whose rows ``rows`` are written;
    ``'moran'``/``'geary'`` return the (g,) numerator over those rows. A CPU
    tensor runs the plain torch version; a CUDA tensor launches the kernel.
    """
    if mode not in MODES:
        raise ValueError(f"Unknown ELL mode `{mode}`; expected one of {sorted(MODES)}.")
    if walk is not None and rows is not None:
        raise ValueError("`walk` orders the graph's own rows; it takes no bucket `rows`.")
    n_b, k = indices.shape
    n, g = x.shape
    order = rows if rows is not None else walk
    if mode == "spmv" and out is None and (order is not None or indices.device.type != "cpu"):
        out = (torch.zeros if rows is not None else torch.empty)((n, g), dtype=x.dtype, device=x.device)
    if indices.device.type == "cpu":
        res = _ell_plain(mode, indices, weights, x, rows, walk)
        if mode != "spmv" or out is None:
            return res
        out[order.long() if order is not None else slice(None)] = res
        return out
    _cuda.require(indices, "indices", torch.int32)
    _cuda.require(weights, "weights", torch.float32, (n_b, k))
    _cuda.require(x, "x", torch.float32)
    if rows is not None:
        _cuda.require(rows, "rows", torch.int32, (n_b,))
    elif n_b != n:
        raise ValueError(f"without `rows` the ELL graph must have {n} rows, found {n_b}.")
    if walk is not None:
        _cuda.require(walk, "walk", torch.int32, (n,))
    if n >= 2**31 or n * g >= 2**40 or n_b * k >= 2**31:
        raise ValueError("the ELL kernel takes fewer than 2^31 rows and edges.")
    if n_b * k:  # one reduction an array, one wait
        ranges = [*torch.aminmax(indices)] + ([*torch.aminmax(order)] if order is not None else [])
        lo, hi, *row_range = torch.stack(ranges).tolist()
        if lo < 0 or hi >= n:
            raise ValueError("neighbour indices must lie in [0, n).")
        if row_range and (row_range[0] < 0 or row_range[1] >= n):
            raise ValueError(f"{'bucket rows' if rows is not None else 'the walk'} must lie in [0, n).")
    if mode == "spmv":
        _cuda.require(out, "out", torch.float32, (n, g))
        result = out
    else:
        result = torch.zeros((g,), dtype=torch.float32, device=x.device)
    if n_b == 0 or g == 0 or k == 0:  # nothing to sum: W x is 0 on these rows
        if mode == "spmv" and n_b and g:
            result.index_fill_(0, rows.long(), 0.0) if rows is not None else result.zero_()
        return result
    layout = k5a_layout(mode, n_b, x, out)
    partial = None if mode == "spmv" else torch.empty((layout.groups, g), dtype=torch.float64, device=x.device)
    code = _cuda.library().sqt_ell_autocorr(
        MODES[mode], int(layout.aligned), order.data_ptr() if order is not None else None, indices.data_ptr(),
        weights.data_ptr(), n_b, k, x.data_ptr(), g, layout.slices, layout.blocks, layout.rows_per_item,
        layout.items, int(walk is not None), result.data_ptr() if partial is None else None,
        partial.data_ptr() if partial is not None else None, result.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "ell_autocorr")
    _cuda.launches["ell_autocorr"] += 1
    return result


def spmv_genes(indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
               walk: torch.Tensor | None = None) -> torch.Tensor:
    """``W @ x`` for ``x`` of shape ``(n, g)`` over a padded-ELL graph, its
    rows walked in the order ``walk`` if given."""
    return ell_autocorr("spmv", indices, weights, x, walk=walk)


def spmv_genes_bucketed(buckets: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """``W @ x`` over degree buckets, each bucket's rows written in place;
    the buckets cover every row."""
    u = torch.empty_like(x)
    for rows, idx, w in buckets:
        ell_autocorr("spmv", idx, w, x, rows, out=u)
    return u


def _centered(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    z = x - torch.mean(x, dim=0, keepdim=True)
    return z, torch.sum(z * z, dim=0)


def moran_scores(indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor, s0: float,
                 walk: torch.Tensor | None = None) -> torch.Tensor:
    """Moran's I per gene, ``(n / S0) (z^T W z) / (z^T z)``, without
    materialising ``W z`` (the rows walked in the order ``walk`` if given)."""
    z, den = _centered(x)
    return (x.shape[0] / s0) * ell_autocorr("moran", indices, weights, z, walk=walk) / den


def moran_scores_bucketed(buckets: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], x: torch.Tensor,
                          s0: float) -> torch.Tensor:
    """Moran's I per gene over degree buckets (the same result as :func:`moran_scores`)."""
    z, den = _centered(x)
    num = sum(ell_autocorr("moran", idx, w, z, rows) for rows, idx, w in buckets)
    return (x.shape[0] / s0) * num / den


def geary_scores(indices: torch.Tensor, weights: torch.Tensor, x: torch.Tensor, s0: float,
                 walk: torch.Tensor | None = None) -> torch.Tensor:
    """Geary's C per gene, ``((n-1) / (2 S0)) sum w_ij (x_i - x_j)^2 / sum
    (x_i - mean)^2`` (the rows walked in the order ``walk`` if given)."""
    num = ell_autocorr("geary", indices, weights, x, walk=walk)
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
    """Plain torch version of K5b: ``(P, g)`` float32 permuted numerators, a
    few permutations at a time. bf16 operands are widened to float32 before
    any product, so each product is exact as in the kernel."""
    n, g = z.shape
    zf = z.float()
    out = torch.empty((perms.shape[0], g), dtype=torch.float32, device=z.device)
    step = max(1, (1 << 26) // max(n * g, 1))
    for p0 in range(0, perms.shape[0], step):
        pc = perms[p0 : p0 + step].long()
        ug = u[pc].float()  # (c, n, g)
        if mode == "moran":
            out[p0 : p0 + step] = torch.sum(zf * ug, dim=1)
        else:
            out[p0 : p0 + step] = torch.sum(zf * (zf * r[pc].float()[:, :, None] - 2.0 * ug), dim=1)
    return out


def _k5b_groups(n: int, n_perms: int, record: int) -> int:
    perm_blocks = -(-n_perms // (32 * 16 // record))
    return max(1, min(-(-n // _K5B_MIN_GROUP_ROWS), -(-_K5B_TARGET_BLOCKS // perm_blocks)))


def _gene_tiles(x: torch.Tensor, w: int) -> torch.Tensor:
    """``(n, g)`` -> ``(ceil(g / w), n, w)`` gene-tile-major copy, zero-padded."""
    n, g = x.shape
    pad = -g % w
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.view(n, (g + pad) // w, w).transpose(0, 1).contiguous()


def perm_autocorr(mode: str, z: torch.Tensor, u: torch.Tensor, perms: torch.Tensor,
                  r: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K5b: ``(P, g)`` float32 permuted numerators, unrounded.

    ``moran``: ``sum_i z[i, g] u[p(i), g]``; ``geary``: ``sum_i z[i, g] (z[i, g]
    r[p(i)] - 2 u[p(i), g])``. ``z``, ``u`` (and ``r``) are all float32 or all
    bf16. ``perms`` is ``(P, n)`` int32, read through its strides, so the
    transposed view of K4's ``(n, P)`` positions needs no copy. A CPU tensor
    runs the plain torch version; a CUDA tensor launches the kernel.
    """
    if mode not in ("moran", "geary"):
        raise ValueError(f"Unknown permutation mode `{mode}`; expected 'moran' or 'geary'.")
    if (mode == "geary") != (r is not None):
        raise ValueError("row sums `r` are given for Geary's C and only for it.")
    if z.dtype not in _DTYPES:
        raise TypeError(f"`z` must be float32 or bfloat16, found {z.dtype}.")
    if z.device.type == "cpu":
        return _perm_plain(mode, z, u, r, perms)
    n, g = z.shape
    n_perms = perms.shape[0]
    _cuda.require(z, "z", z.dtype)
    _cuda.require(u, "u", z.dtype, (n, g))
    if r is not None:
        _cuda.require(r, "r", z.dtype, (n,))
    if perms.device != z.device or perms.dtype != torch.int32 or perms.ndim != 2 or perms.shape[1] != n:
        raise ValueError(f"`perms` must be a (P, {n}) int32 tensor on {z.device}.")
    if n >= 2**31 or n * g >= 2**40:
        raise ValueError("the permutation kernel takes fewer than 2^31 rows.")
    if n_perms and n and (int(perms.min()) < 0 or int(perms.max()) >= n):
        raise ValueError("permutation indices must lie in [0, n).")
    if n_perms == 0 or g == 0 or n == 0:
        return torch.zeros((n_perms, g), dtype=torch.float32, device=z.device)
    w = _K5B_GENES
    zt, ut = _gene_tiles(z, w), _gene_tiles(u, w)
    tiles = zt.shape[0]
    groups = _k5b_groups(n, n_perms, w * z.element_size())
    # Geary: r[p(i)] in float32, gathered by the first tile, laid out as the positions
    rg = torch.empty_like(perms, dtype=torch.float32) if r is not None else None
    partial = torch.empty((groups, n_perms, tiles * w), dtype=torch.float64, device=z.device)
    out = torch.empty((n_perms, tiles * w), dtype=torch.float32, device=z.device)
    code = _cuda.library().sqt_perm_autocorr(
        MODES[mode], _DTYPES[z.dtype], zt.data_ptr(), ut.data_ptr(),
        r.data_ptr() if r is not None else None, rg.data_ptr() if rg is not None else None,
        rg.stride(0) if rg is not None else 0, rg.stride(1) if rg is not None else 0, n, tiles,
        perms.data_ptr(), n_perms, perms.stride(0), perms.stride(1), groups, partial.data_ptr(), out.data_ptr(),
        _cuda.stream_ptr(),
    )
    _cuda.check(code, "perm_autocorr")
    _cuda.launches["perm_autocorr"] += 1
    return out[:, :g]


def _perm_den(z: torch.Tensor) -> torch.Tensor:
    """``sum_i z_i^2`` per gene in float32, from ``z`` as given (the JAX
    package's sims denominator, re-accumulated from its gather operand)."""
    zf = z.float()
    return torch.sum(zf * zf, dim=0)


def moran_perm_scores(z: torch.Tensor, u: torch.Tensor, perms: torch.Tensor, s0: float) -> torch.Tensor:
    """Moran's I under row permutations of W: ``(P, g)`` float32, ``perms`` ``(P, n)``.

    With bf16 ``z``/``u`` the dtypes follow the JAX package's: the numerator
    is rounded to bf16, times ``n / s0`` (a weakly typed scalar there, so
    rounded to bf16 and the product rounded to bf16), then divided by the
    float32 denominator."""
    n = z.shape[0]
    num = perm_autocorr("moran", z, u, perms)
    if z.dtype == torch.bfloat16:
        scale = torch.tensor(float(np.float32(n) / np.float32(s0)), dtype=torch.bfloat16, device=z.device)
        return (num.to(torch.bfloat16) * scale).float() / _perm_den(z)
    return (n / s0) * num / _perm_den(z)


def geary_perm_scores(z: torch.Tensor, u: torch.Tensor, r: torch.Tensor, cg: torch.Tensor, perms: torch.Tensor,
                      s0: float) -> torch.Tensor:
    """Geary's C under row permutations of W: ``(P, g)`` float32. ``r`` are the
    row sums of W (in ``z``'s dtype) and ``cg`` the permutation-invariant
    third term in float32, both from the caller. With bf16 operands the
    numerator is rounded to bf16 and widened back to float32 before ``+ cg``,
    as in the JAX package."""
    num = perm_autocorr("geary", z, u, perms, r)
    if z.dtype == torch.bfloat16:
        num = num.to(torch.bfloat16).float()
    return ((z.shape[0] - 1) / (2.0 * s0)) * (num + cg) / _perm_den(z)
