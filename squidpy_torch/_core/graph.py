"""Device-resident spatial graph (counterpart of ``squidpy_tpu/_core/graph.py``).

The graph is kept as CSR in ``adata.obsp`` and converted once into a padded
ELL layout: dense ``(n, k_max)`` neighbour-index / weight / distance tensors
with a validity mask, on the selected device. ``k_max`` is padded to a
multiple of 8 as in the JAX package, so the ELL arrays are equal to its own.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from scipy import sparse as sp

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._device import get_device

__all__ = ["SpatialGraph", "graph_from_adata", "locality_walk", "morton_order", "round_up", "walk_buckets"]


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class SpatialGraph:
    """Padded-ELL spatial neighbour graph.

    Attributes
    ----------
    indices
        ``(n, k_max)`` int32 neighbour indices; padded entries point at row 0
        and are masked out.
    weights
        ``(n, k_max)`` connectivity values (0 where masked).
    mask
        ``(n, k_max)`` bool validity mask.
    distances
        ``(n, k_max)`` edge distances (0 where masked), or None.
    """

    indices: torch.Tensor
    weights: torch.Tensor
    mask: torch.Tensor
    distances: torch.Tensor | None = None

    @property
    def k_max(self) -> int:
        return self.indices.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.mask.sum())

    @classmethod
    def from_csr(
        cls,
        adj: sp.spmatrix,
        dst: sp.spmatrix | None = None,
        *,
        pad_multiple: int = 8,
        dtype: Any = None,
    ) -> SpatialGraph:
        """Convert a scipy CSR adjacency (and optional distances) to padded ELL.

        ``dtype=None`` keeps the input's floating dtype (float32 for integer
        or boolean adjacencies), as the JAX package does with x64 enabled.
        """
        adj = sp.csr_matrix(adj)
        np_dtype = np.dtype(dtype) if dtype is not None else adj.dtype
        if not np.issubdtype(np_dtype, np.floating):
            np_dtype = np.dtype(np.float32)
        n = adj.shape[0]
        deg = np.diff(adj.indptr)
        k_max = max(int(deg.max()) if n else 0, 1)
        k_max = round_up(k_max, pad_multiple)

        indices = np.zeros((n, k_max), dtype=np.int32)
        weights = np.zeros((n, k_max), dtype=np_dtype)
        mask = np.zeros((n, k_max), dtype=bool)
        if adj.nnz:
            rows = np.repeat(np.arange(n), deg)
            pos = np.arange(adj.nnz) - np.repeat(adj.indptr[:-1], deg)
            indices[rows, pos] = adj.indices
            weights[rows, pos] = adj.data
            mask[rows, pos] = True

        device = get_device()
        distances = None
        if dst is not None:
            dst = sp.csr_matrix(dst)
            dvals = np.zeros((n, k_max), dtype=np_dtype)
            if adj.nnz:
                same = (
                    dst.nnz == adj.nnz
                    and np.array_equal(dst.indices, adj.indices)
                    and np.array_equal(dst.indptr, adj.indptr)
                )
                dvals[rows, pos] = dst.data if same else np.asarray(dst[rows, adj.indices]).ravel()
            distances = torch.from_numpy(dvals).to(device)

        return cls(
            indices=torch.from_numpy(indices).to(device),
            weights=torch.from_numpy(weights).to(device),
            mask=torch.from_numpy(mask).to(device),
            distances=distances,
        )

    def degree_buckets(
        self, *, pad_multiple: int = 8, max_buckets: int = 4, min_saving: float = 1.3
    ) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] | None:
        """Row partition by degree for skewed graphs (copied from the JAX package).

        Returns per-bucket ``(rows int32, indices[rows, :k_b], weights[rows,
        :k_b])`` with bucket widths from host degree quantiles, or None when the
        padded layout is already tight (slot saving below ``min_saving``),
        which includes every kNN graph, or when the ELL rows are not
        left-packed.
        """
        n, k_max = self.indices.shape
        if n == 0 or k_max <= pad_multiple:
            return None
        deg_dev = self.mask.sum(dim=1, dtype=torch.int32)
        slots = torch.arange(k_max, dtype=torch.int32, device=self.mask.device)
        if not bool(torch.equal(self.mask, slots[None, :] < deg_dev[:, None])):
            return None  # bucketing a non-packed layout would drop entries
        deg = deg_dev.cpu().numpy()
        nz = deg[deg > 0]
        if not len(nz):
            return None
        qs = np.quantile(nz, [0.5, 0.75, 0.9][: max_buckets - 1])
        edges = sorted({min(int(round_up(max(int(q), 1), pad_multiple)), k_max) for q in qs} | {k_max})
        padded = sum(
            int((deg <= hi).sum() - (deg <= lo).sum()) * hi for lo, hi in zip([-1] + edges[:-1], edges)
        )
        if (n * k_max) / max(padded, 1) < min_saving:
            return None
        out = []
        lo = -1
        for hi in edges:
            rows = np.nonzero((deg > lo) & (deg <= hi))[0]
            lo = hi
            if not len(rows):
                continue
            rows_dev = torch.from_numpy(rows.astype(np.int32)).to(self.indices.device)
            sel = rows_dev.long()
            out.append((rows_dev, self.indices[sel, :hi].contiguous(), self.weights[sel, :hi].contiguous()))
        return out if len(out) > 1 else None


def _spread_bits(q: torch.Tensor, masks: tuple[int, ...], shifts: tuple[int, ...]) -> torch.Tensor:
    for shift, mask in zip(shifts, masks):
        q = (q | (q << shift)) & mask
    return q


def morton_order(coords: torch.Tensor) -> torch.Tensor:
    """Stable Morton (Z-curve) order of ``(n, 2)`` or ``(n, 3)`` finite
    points as an ``(n,)`` int32 tensor on their device: the permutation of
    ``ops/pairbins.py`` ``morton_argsort`` (16 bits an axis in 2D, 10 in 3D,
    quantised in float64 from the same ``lo`` and ``span``), bit for bit."""
    c = coords.to(torch.float64)
    if c.ndim != 2 or c.shape[1] not in (2, 3):
        raise ValueError(f"Morton order takes (n, 2) or (n, 3) points, found shape {tuple(c.shape)}.")
    if c.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=c.device)
    lo, hi = torch.aminmax(c, dim=0)
    span = torch.clamp(hi - lo, min=1e-300)
    if c.shape[1] == 3:
        q = torch.clamp(((c - lo) / span * 1023.0).to(torch.int64), max=1023)
        masks, shifts = (0x030000FF, 0x0300F00F, 0x030C30C3, 0x09249249), (16, 8, 4, 2)
        code = sum(_spread_bits(q[:, a], masks, shifts) << a for a in range(3))
    else:
        q = torch.clamp(((c - lo) / span * 65535.0).to(torch.int64), max=65535)
        masks, shifts = (0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555), (8, 4, 2, 1)
        code = _spread_bits(q[:, 0], masks, shifts) | (_spread_bits(q[:, 1], masks, shifts) << 1)
    return torch.argsort(code, stable=True).to(torch.int32)


def walk_buckets(
    buckets: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], walk: torch.Tensor
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each degree bucket ``(rows, indices, weights)`` with its rows sorted
    by their rank in ``walk`` (a permutation of the graph's rows). Each row
    keeps its slots, so ``W x`` is unchanged."""
    rank = torch.empty_like(walk)
    rank[walk.long()] = torch.arange(walk.shape[0], dtype=walk.dtype, device=walk.device)
    out = []
    for rows, idx, w in buckets:
        sel = torch.argsort(rank.index_select(0, rows))
        out.append((rows.index_select(0, sel), idx.index_select(0, sel), w.index_select(0, sel)))
    return out


def _morton_walk(adata: Any, n_cells: int, device: torch.device) -> torch.Tensor | None:
    """The Morton order of the cells' coordinates (``obsm['spatial']``),
    computed on ``device``; None (the identity walk) unless they are
    ``n_cells`` finite points of 2 or 3 coordinates."""
    obsm = getattr(adata, "obsm", None)
    if obsm is None or Key.obsm.spatial not in obsm:
        return None
    coords = np.asarray(obsm[Key.obsm.spatial])
    real = np.issubdtype(coords.dtype, np.integer) or np.issubdtype(coords.dtype, np.floating)
    if not real or coords.ndim != 2 or coords.shape[0] != n_cells or coords.shape[1] not in (2, 3):
        return None
    if coords.dtype not in (np.float32, np.float64):
        coords = coords.astype(np.float64)
    c = torch.as_tensor(np.ascontiguousarray(coords), device=device)
    if not bool(torch.isfinite(c).all()):
        return None
    return morton_order(c)


_WALK_KEY = "__squidpy_torch_walk__"


def locality_walk(adata: Any, n_cells: int, device: torch.device) -> torch.Tensor | None:
    """The order kernel K5a walks the ELL rows in on a CUDA ``device``: the
    Morton order of ``obsm['spatial']`` (see :func:`_morton_walk`), so a
    gathered gene row is found in the card's L2 by its other neighbours.

    None (the identity walk) on any other device, whose plain path gains
    nothing from an order. The walk is cached on ``adata.uns`` while the
    same live coordinate array is installed (checked by weak reference), so
    only the first call pays for it; a walk only orders the rows, so one
    made stale by an in-place edit costs time, never a result.
    """
    if device.type != "cuda":
        return None
    coords = getattr(adata, "obsm", {}).get(Key.obsm.spatial)
    cached = adata.uns.get(_WALK_KEY)
    if (
        coords is not None
        and cached is not None
        and cached["coords_ref"] is not None
        and cached["coords_ref"]() is coords
        and cached["n_cells"] == n_cells
        and cached["device"] == device
    ):
        return cached["walk"]
    walk = _morton_walk(adata, n_cells, device)
    try:
        coords_ref = weakref.ref(coords)
    except TypeError:  # absent, or no weak references: not cached
        coords_ref = None
    adata.uns[_WALK_KEY] = {"walk": walk, "coords_ref": coords_ref, "n_cells": n_cells, "device": device}
    return walk


def _cache_key(connectivity_key: str) -> str:
    return f"__squidpy_torch_ell__{connectivity_key}"


def graph_from_adata(adata: Any, connectivity_key: str, distances_key: str | None = None) -> SpatialGraph:
    """Build (and cache on ``adata.uns``) the device graph from obsp CSR.

    The cache is valid only while the same live CSR object is installed
    (checked by weak reference), on the same device, and holds distances if
    they are asked for.
    """
    key = _cache_key(connectivity_key)
    cached = adata.uns.get(key)
    adj = adata.obsp[connectivity_key]
    want_dist = distances_key is not None
    if (
        cached is not None
        and cached.get("adj_ref") is not None
        and cached["adj_ref"]() is adj
        and cached["graph"].indices.device.type == get_device().type
        and (not want_dist or cached.get("has_distances"))
    ):
        return cached["graph"]
    dst = adata.obsp.get(distances_key) if want_dist else None
    g = SpatialGraph.from_csr(adj, dst)
    try:
        adj_ref = weakref.ref(adj)
    except TypeError:  # object does not support weak references
        adj_ref = None
    adata.uns[key] = {"graph": g, "adj_ref": adj_ref, "has_distances": g.distances is not None}
    return g
