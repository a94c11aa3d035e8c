"""Device-resident expression handle (counterpart of ``squidpy_tpu/_core/device_x.py``).

The expression matrix ships to the device ONCE, in its narrowest lossless
container (u8/u16 for integral non-negative counts, else float32), and serves
dense float32 gene blocks to ``spatial_autocorr``. Sparse X ships as CSC (the
nnz values and their row indices) and each block is densified on the device
by a scatter.

The handle is cached on ``adata.uns`` under a weak reference to the exact
live X object plus a strided value fingerprint, so replacing X or mutating
it in place (``adata.X[:] = ...``, ``X.data *= ...``) invalidates it.
"""

from __future__ import annotations

import weakref
from typing import Any

import numpy as np
import torch
from scipy import sparse as sp

from squidpy_torch._device import get_device

__all__ = ["HBM_BUDGET_BYTES", "DeviceExpression", "device_expression"]

# do not pin more than this much device memory for the cached expression;
# the JAX package's value, sized for a 16 GB card (ROADMAP queue 1)
HBM_BUDGET_BYTES = 6_000_000_000


def _narrowest_container(x: np.ndarray) -> np.ndarray:
    """u8/u16 when losslessly integral and non-negative (raw counts), else
    the input (copied from the JAX package)."""
    if not x.size or not np.issubdtype(x.dtype, np.floating):
        return x
    dmin = float(x.min())
    dmax = float(x.max())
    if 0.0 <= dmin and dmax < 65536.0:
        # bounded blocks: no full-size floor/bool temporaries on the host
        step = max(1, (1 << 22) // max(x.shape[1] if x.ndim == 2 else 1, 1))
        for r in range(0, x.shape[0], step):
            blk = x[r : r + step]
            if not np.array_equal(blk, np.floor(blk)):
                return x
        return x.astype(np.uint8 if dmax < 256.0 else np.uint16)
    return x


def _x_fingerprint(x: Any) -> tuple:
    """Strided value checksum (<= 4096 samples) plus shape/nnz (copied from
    the JAX package)."""
    arr = x.data if sp.issparse(x) else np.asarray(x)
    if arr.ndim == 2 and not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr[:: max(1, arr.shape[0] // 64)])
    flat = arr.ravel()
    k = flat.size
    if k == 0:
        return (tuple(x.shape), 0)
    s = flat[:: max(1, k // 4096)][:4096].astype(np.float64, copy=False)
    return (tuple(x.shape), k, float(s.sum()), float(s[0]), float(s[-1]))


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array to the device; uint16 travels as its int16 bit pattern
    (gathers of uint16 are not implemented on every backend) and is widened
    back in :func:`_as_float`. Floats other than uint8/uint16 become float32."""
    if arr.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).to(device)
    if arr.dtype != np.uint8:
        arr = np.asarray(arr, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _as_float(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.int16:  # uint16 bit pattern
        t = t.to(torch.int32) & 0xFFFF
    return t.to(torch.float32).contiguous()


class DeviceExpression:
    """Device-resident ``(n_cells, n_genes)`` expression with dense block access.

    ``ship_count`` counts host-to-device transfers of the matrix: any number
    of statistic calls on the same live X ship it once.
    """

    def __init__(self, x: Any, var_names: list[str], device: torch.device) -> None:
        self.var_names = list(map(str, var_names))
        self._col_of = {g: i for i, g in enumerate(self.var_names)}
        # duplicated names are ambiguous here (the dict keeps the LAST
        # occurrence) while the streaming fallback is positional: callers
        # take the fallback for those genes (columns_of -> None)
        seen: set[str] = set()
        self._dup_names = {g for g in self.var_names if g in seen or seen.add(g)}
        self.n_obs, self.n_vars = x.shape
        self.device = device
        if sp.issparse(x):
            csc = sp.csc_matrix(x)
            self._kind = "csc"
            self._data = _to_device(_narrowest_container(np.asarray(csc.data)), device)
            self._rows = torch.from_numpy(csc.indices.astype(np.int64)).to(device)
            self._indptr = np.asarray(csc.indptr, dtype=np.int64)  # host: block slicing
            self.nbytes = self._data.nbytes + self._rows.nbytes
        else:
            self._kind = "dense"
            self._dense = _to_device(_narrowest_container(np.ascontiguousarray(x)), device)
            self.nbytes = self._dense.nbytes
        self.ship_count = 1

    def columns_of(self, genes: list[str]) -> np.ndarray | None:
        """Column indices for a gene-name list, or None if any is missing or
        duplicated in ``var_names``."""
        if any(str(g) in self._dup_names or str(g) not in self._col_of for g in genes):
            return None
        return np.asarray([self._col_of[str(g)] for g in genes], dtype=np.int64)

    def dense_block(self, cols: np.ndarray) -> torch.Tensor:
        """Device-side dense float32 ``(n, len(cols))`` block, with no host ship."""
        cols = np.asarray(cols, dtype=np.int64)
        if self._kind == "dense":
            if len(cols) and np.array_equal(cols, np.arange(cols[0], cols[0] + len(cols))):
                return _as_float(self._dense[:, int(cols[0]) : int(cols[0]) + len(cols)])
            return _as_float(self._dense[:, torch.from_numpy(cols).to(self.device)])
        # CSC: scatter each gene's nonzeros into its dense column
        starts = self._indptr[cols]
        counts = self._indptr[cols + 1] - starts
        total = int(counts.sum())
        out = torch.zeros((self.n_obs, len(cols)), dtype=torch.float32, device=self.device)
        if total == 0:
            return out
        # flat positions into the nnz arrays: arange(total) shifted per gene
        firsts = np.cumsum(counts) - counts
        shift = torch.from_numpy(starts - firsts).to(self.device)
        reps = torch.from_numpy(counts).to(self.device)
        gather = torch.arange(total, device=self.device) + torch.repeat_interleave(shift, reps, output_size=total)
        col_ids = torch.repeat_interleave(torch.arange(len(cols), device=self.device), reps, output_size=total)
        out[self._rows[gather], col_ids] = _as_float(self._data[gather])
        return out


def device_expression(
    adata: Any, *, layer: str | None = None, use_raw: bool = False, create: bool = True
) -> DeviceExpression | None:
    """The cached device expression handle of ``adata`` (ships X on first use).

    Returns None (the caller streams blocks from the host) when the device
    copy would exceed :data:`HBM_BUDGET_BYTES`, or when ``create=False`` and
    no valid handle is cached.
    """
    src_holder = adata.raw if use_raw else adata
    x = src_holder.X if layer is None else adata.layers[layer]
    device = get_device()
    cache_key = f"__squidpy_torch_device_x__{layer}_{use_raw}"
    cached = adata.uns.get(cache_key)
    if (
        cached is not None
        and cached.get("x_ref") is not None
        and cached["x_ref"]() is x
        and cached["handle"].device.type == device.type
        and cached.get("fp") == _x_fingerprint(x)
    ):
        return cached["handle"]
    if not create:
        return None

    if sp.issparse(x):
        est = x.data.nbytes // (2 if x.data.dtype.itemsize >= 4 else 1) + 4 * x.nnz
    else:
        est = np.asarray(x).nbytes // (2 if np.asarray(x).dtype.itemsize >= 4 else 1)
    if est > HBM_BUDGET_BYTES:
        return None

    handle = DeviceExpression(x, list(src_holder.var_names), device)
    try:
        x_ref = weakref.ref(x)
    except TypeError:  # object does not support weak references
        x_ref = None
    adata.uns[cache_key] = {"handle": handle, "x_ref": x_ref, "fp": _x_fingerprint(x)}
    return handle
