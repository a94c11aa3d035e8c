"""Co-occurrence of clusters across distance thresholds (counterpart of ``squidpy_tpu/gr/_ppatterns.py``).

``spatial_autocorr`` (Moran/Geary) is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._device import NDArrayA
from squidpy_torch.gr._utils import (
    _assert_categorical_obs,
    _assert_spatial_basis,
    _categorical_codes,
    _save_data,
    extract_adata_if_sdata,
)
from squidpy_torch.ops.cooccur import co_occurrence_counts, co_occurrence_probs

__all__ = ["co_occurrence"]


def co_occurrence(
    adata: Any,
    cluster_key: str,
    spatial_key: str = Key.obsm.spatial,
    interval: int | NDArrayA = 50,
    copy: bool = False,
    *,
    table_key: str | None = None,
    use_pallas: bool = False,
) -> tuple[NDArrayA, NDArrayA] | None:
    """Co-occurrence probability of clusters across distance thresholds.

    At 100k cells and above the pair counts come from the binned sweep
    (kernel K1); below, from the dense triangular sweep. ``use_pallas=True``
    selected the JAX package's experimental dense Pallas kernel (K2), which is
    not ported yet. Stores ``uns['{cluster_key}_co_occurrence'] = {'occ',
    'interval'}``.
    """
    if use_pallas:
        raise NotImplementedError(
            "`use_pallas=True` (the dense pair kernel K2, squidpy_tpu/ops/pallas_pairs.py) is not ported to "
            "squidpy_torch yet; see ROADMAP.md, queue 2, K2."
        )
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    _assert_categorical_obs(adata, key=cluster_key)
    _assert_spatial_basis(adata, key=spatial_key)

    spatial = np.asarray(adata.obsm[spatial_key], dtype=np.float32)
    labs, n_cls = _categorical_codes(adata, cluster_key)

    if isinstance(interval, int):
        thresh_min, thresh_max = _find_min_max(spatial)
        interval = np.linspace(thresh_min, thresh_max, num=interval, dtype=np.float32)
    else:
        interval = np.asarray(sorted(interval), dtype=np.float32)
    if len(interval) <= 1:
        raise ValueError(f"Expected interval to be of length `>= 2`, found `{len(interval)}`.")

    thresholds = (interval[1:].astype(np.float64) ** 2).astype(np.float32)
    counts = co_occurrence_counts(spatial, labs, thresholds, n_cls)
    out = co_occurrence_probs(counts)

    if copy:
        return out, interval
    _save_data(adata, attr="uns", key=Key.uns.co_occurrence(cluster_key), data={"occ": out, "interval": interval})
    return None


def _find_min_max(spatial: NDArrayA) -> tuple[float, float]:
    """Distance-threshold heuristics (copied from the JAX package)."""
    coord_sum = np.sum(spatial, axis=1)
    min_idx, min_idx2 = np.argpartition(coord_sum, 2)[:2]
    max_idx = np.argmax(coord_sum)
    thres_max = float(np.linalg.norm(spatial[min_idx] - spatial[max_idx])) / 2.0
    thres_min = float(np.linalg.norm(spatial[min_idx] - spatial[min_idx2]))
    return np.float32(thres_min), np.float32(thres_max)
