"""Sepal: spatially variable genes by simulated diffusion (counterpart of
``squidpy_tpu/gr/_sepal.py``).

On a grid graph (4 neighbours a node, Visium HD's square bins, or 6, Visium's
hexagonal spots) every gene of a block diffuses from its expression until
its entropy converges; the score is ``dt`` times the step it took (NaN where
it did not within ``n_iter``). The diffusion runs on the device in float32
(kernel K11 on the card), as the JAX package runs it without x64; the node
tables come from the graph on the host, copied from the JAX package without
sklearn.
"""

from __future__ import annotations

import logging
from collections.abc import Sequence
from typing import Any, Literal, NamedTuple

import numpy as np
import torch
from scipy import sparse as sp
from scipy.spatial.distance import cdist

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.device_x import device_expression
from squidpy_torch._device import NDArrayA, get_device
from squidpy_torch.gr._ppatterns import _sort_order
from squidpy_torch.gr._utils import (
    _assert_connectivity_key,
    _assert_non_empty_sequence,
    _assert_spatial_basis,
    _extract_expression,
    _save_data,
    extract_adata_if_sdata,
)
from squidpy_torch.ops.sepal import sepal_diffusion

__all__ = ["SepalResult", "sepal"]

logger = logging.getLogger(__name__)

# device bytes a (cell, gene) of a block holds: the two state buffers and
# the dense block they start from, float32
_BYTES_PER_ENTRY = 12
_DIST_ENTRIES = 1 << 24  # L1 distances a chunk of `_compute_idxs`' fallback


class SepalResult(NamedTuple):
    """The JAX package's sepal DataFrame without pandas: ``index`` holds the
    genes in the frame's row order (scores descending, NaN last, as pandas'
    ``sort_values``); ``columns`` maps ``sepal_score`` to the values in that
    order."""

    index: NDArrayA
    columns: dict[str, NDArrayA]


def _genes_per_block(n_cells: int, device: torch.device) -> int:
    """Genes a block may hold: a quarter of the card's free memory (at most
    8 GiB), or 512 MiB on the CPU, over :data:`_BYTES_PER_ENTRY` bytes a
    (cell, gene). The JAX package's 2.7e8 cells x genes is its 16 GB TPU's
    limit; the block width never changes a score."""
    if device.type == "cuda":
        budget = min(torch.cuda.mem_get_info(device)[0] // 4, 8 << 30)
    else:
        budget = 512 << 20
    return max(1, int(budget // (_BYTES_PER_ENTRY * max(n_cells, 1))))


def sepal(
    adata: Any,
    max_neighs: Literal[4, 6],
    genes: str | Sequence[str] | None = None,
    n_iter: int | None = 30000,
    dt: float = 0.001,
    thresh: float = 1e-8,
    connectivity_key: str = Key.obsp.spatial_conn(),
    spatial_key: str = Key.obsm.spatial,
    layer: str | None = None,
    use_raw: bool = False,
    copy: bool = False,
    n_jobs: int | None = None,
    show_progress_bar: bool = True,
    *,
    table_key: str | None = None,
    gene_block_size: int = 512,
) -> SepalResult | None:
    """Identify spatially variable genes with Sepal (diffusion simulation).

    ``genes=None`` takes the ``highly_variable`` genes where ``var`` has
    that column, else all. ``n_jobs`` and ``show_progress_bar`` are accepted
    for API compatibility and ignored. Stores (or, with ``copy``, returns) a
    :class:`SepalResult` under ``uns['sepal_score']``. NaN scores mean no
    convergence within ``n_iter``.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    _assert_connectivity_key(adata, connectivity_key)
    _assert_spatial_basis(adata, key=spatial_key)
    if max_neighs not in (4, 6):
        raise ValueError(f"Expected `max_neighs` to be either `4` or `6`, found `{max_neighs}`.")

    spatial = np.asarray(adata.obsm[spatial_key], dtype=np.float64)

    if genes is None:
        genes = np.asarray(adata.var_names)
        var = getattr(adata, "var", {})
        if "highly_variable" in var:
            genes = genes[np.asarray(var["highly_variable"], dtype=bool)]
    genes = _assert_non_empty_sequence(genes, name="genes")

    g = sp.csr_matrix(adata.obsp[connectivity_key], copy=True)
    g.eliminate_zeros()
    max_n = np.diff(g.indptr).max()
    if max_n != max_neighs:
        raise ValueError(f"Expected `max_neighs={max_neighs}`, found node with `{max_n}` neighbors.")

    sat, sat_idx, unsat, nearest_sat = _compute_idxs(g, spatial, max_neighs)
    unsat_to_sat_pos = np.searchsorted(sat, nearest_sat).astype(np.int32)

    vals, genes = _extract_expression(adata, genes=genes, use_raw=use_raw, layer=layer)
    holder = adata.raw if use_raw and getattr(adata, "raw", None) is not None else adata
    create = 2 * len(genes) >= len(holder.var_names)  # a small gene subset does not ship the whole matrix
    dev_handle = device_expression(adata, layer=layer, use_raw=use_raw, create=create)
    dev_cols = dev_handle.columns_of(list(map(str, genes))) if dev_handle is not None else None

    device = get_device()
    tables = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
              for a in (sat, sat_idx, unsat, unsat_to_sat_pos)]
    n_cells = g.shape[0]
    block = max(1, min(int(gene_block_size), _genes_per_block(n_cells, device)))

    scores_parts: list[np.ndarray] = []
    for c0 in range(0, len(genes), block):
        if dev_cols is not None:
            conc = dev_handle.dense_block(dev_cols[c0 : c0 + block])
        else:
            part = vals[:, c0 : c0 + block]
            part = part.toarray() if sp.issparse(part) else np.asarray(part)
            conc = torch.from_numpy(np.ascontiguousarray(part, dtype=np.float32)).to(device)
        iters = sepal_diffusion(conc, *tables, max_neighs == 6, int(n_iter), float(dt), float(thresh))
        scores_parts.append(iters.cpu().numpy().astype(np.float64) * dt)
    score = np.concatenate(scores_parts) if scores_parts else np.empty(0)

    if np.isnan(score).any():
        logger.warning("Found `NaN` in sepal scores, consider increasing `n_iter` to a higher value")
    order = _sort_order(score, ascending=False)
    result = SepalResult(index=np.asarray(genes, dtype=object)[order], columns={"sepal_score": score[order]})
    if copy:
        return result
    _save_data(adata, attr="uns", key="sepal_score", data=result)
    return None


def _compute_idxs(
    g: sp.csr_matrix, spatial: np.ndarray, sat_thresh: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Saturated nodes (degree ``sat_thresh``), their neighbour table, the
    unsaturated nodes and each one's nearest saturated node: its first
    saturated graph neighbour, else the saturated node nearest in L1 (the
    first of equals), as ``sklearn``'s ``pairwise_distances`` and ``argmin``
    give it (scipy's ``cdist`` ``cityblock``, which it calls)."""
    degrees = np.diff(g.indptr)
    nodes = np.arange(g.shape[0])
    sat = nodes[degrees == sat_thresh]
    unsat = nodes[degrees < sat_thresh]

    sat_idx = g.indices[(g.indptr[sat][:, None] + np.arange(sat_thresh)[None, :]).ravel()]
    sat_idx = sat_idx.reshape(len(sat), sat_thresh).astype(np.int32)

    is_sat = np.zeros(g.shape[0], dtype=bool)
    is_sat[sat] = True
    nearest_sat = np.full(len(unsat), -1, dtype=np.int64)
    for k, u in enumerate(unsat):
        neigh = g.indices[g.indptr[u] : g.indptr[u + 1]]
        sat_neigh = neigh[is_sat[neigh]]
        if len(sat_neigh):
            nearest_sat[k] = sat_neigh[0]
    missing = np.flatnonzero(nearest_sat < 0)
    rows = max(1, _DIST_ENTRIES // max(len(sat), 1))  # distance rows a chunk
    for c0 in range(0, len(missing), rows):
        ks = missing[c0 : c0 + rows]
        dist = cdist(spatial[unsat[ks]], spatial[sat], "cityblock")
        nearest_sat[ks] = sat[np.argmin(dist, axis=1)]
    return sat, sat_idx, unsat, nearest_sat.astype(np.int32)
