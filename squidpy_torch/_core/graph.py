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

from squidpy_torch._device import get_device

__all__ = ["SpatialGraph", "graph_from_adata", "round_up"]


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
