"""Design matrix of distances to anchor points (counterpart of
``squidpy_tpu/tl/_var_by_distance.py``).

Per (library, anchor) nearest-anchor distances from scipy's ``cKDTree`` in
float64 (the JAX package uses sklearn's ``KDTree``; both sum the squared
differences in axis order and take one square root), the JAX package's
normalization (anchors at distance 0 -> NaN, the nearest non-anchor -> 0, a
min-max scale per slide), raw-distance columns and covariates. On a pandas
container the result is JAX's DataFrame; without pandas, a :class:`Columns`.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
from scipy.spatial import cKDTree

from squidpy_torch._device import NDArrayA
from squidpy_torch.gr._utils import _save_data, extract_adata_if_sdata
from squidpy_torch.tl._utils import Columns, first_appearance, is_frame, obs_index, obs_values

__all__ = ["var_by_distance"]

logger = logging.getLogger(__name__)


def var_by_distance(
    adata: Any,
    groups: str | list[str] | NDArrayA,
    cluster_key: str | None = None,
    library_key: str | None = None,
    library_id: str | list[str] | None = None,
    design_matrix_key: str = "design_matrix",
    covariates: str | list[str] | None = None,
    metric: str = "euclidean",
    spatial_key: str = "spatial",
    copy: bool = False,
    *,
    table_key: str | None = None,
) -> Any:
    """Build a design matrix of distances to anchor observation group(s).

    Writes ``obsm[design_matrix_key]`` (or returns it with ``copy``): a
    DataFrame on a pandas container, else a :class:`Columns`."""
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    logger.info(f"Creating {design_matrix_key}")
    if metric != "euclidean":
        raise NotImplementedError(f"Only the `euclidean` metric is supported, found `{metric}`.")

    custom_coord: np.ndarray | None = None
    if isinstance(groups, str):
        anchors = [groups]
    elif isinstance(groups, np.ndarray):
        if groups.ndim != 1:
            raise ValueError(f"Expected a 1D array for 'groups', but got shape {groups.shape}.")
        custom_coord = groups.astype(float).reshape(1, -1)
        anchors = ["custom_anchor"]
    elif isinstance(groups, list):
        anchors = list(groups)
    else:
        raise TypeError(f"Expected `groups` to be of type `str or list or ndarray`, got `{type(groups).__name__}`.")

    if cluster_key is None and custom_coord is None:
        raise ValueError("Please specify `cluster_key` when anchors are obs groups.")

    library = None if library_key is None else obs_values(adata, library_key)
    if library is None:
        slides: list[Any] = [None]
    else:
        all_slides = first_appearance(library)
        if library_id is not None:
            requested = [library_id] if isinstance(library_id, str) else list(library_id)
            for x in requested:
                if x not in all_slides:
                    raise ValueError(f"library id {x} not in {library_key}")
            slides = requested
        else:
            slides = all_slides

    spatial = np.asarray(adata.obsm[spatial_key], dtype=float)
    n_obs = spatial.shape[0]
    finite = ~np.isnan(spatial).any(axis=1)
    clusters = None if cluster_key is None else obs_values(adata, cluster_key).astype(str)

    columns: dict[str, NDArrayA] = {}
    for anchor in anchors:
        raw = np.full(n_obs, np.nan)
        norm = np.full(n_obs, np.nan)
        found_anchor = custom_coord is not None
        for slide in slides:
            slide_mask = np.ones(n_obs, dtype=bool) if slide is None else library == slide
            rows = slide_mask & finite
            if custom_coord is not None:
                anchor_coord = custom_coord
            else:
                anchor_coord = spatial[slide_mask & (clusters == str(anchor)) & finite]
                if not len(anchor_coord):
                    continue
                found_anchor = True
            mindist = cKDTree(anchor_coord).query(spatial[rows], k=1)[0].ravel()
            raw[rows] = mindist
            # anchors (distance 0) -> NaN, nearest non-anchor -> 0, farthest -> 1 (per slide)
            d = mindist.copy()
            d[d == 0] = np.nan
            if np.isfinite(d).any():
                d[np.nanargmin(d)] = 0.0
                dmin, dmax = np.nanmin(d), np.nanmax(d)
                scale = (dmax - dmin) or 1.0
                norm[rows] = (d - dmin) / scale
        if not found_anchor:
            raise ValueError(f"Anchor group `{anchor}` not found in `adata.obs[{cluster_key!r}]` on any slide.")
        columns[str(anchor)] = norm
        columns[f"{anchor}_raw"] = raw

    if isinstance(covariates, str):
        covariates = [covariates]
    result = (_frame(adata, cluster_key, library_key, columns, covariates) if is_frame(adata.obs)
              else _columns(adata, n_obs, cluster_key, library_key, columns, covariates))
    if copy:
        logger.info("Finish")
        return result
    _save_data(adata, attr="obsm", key=design_matrix_key, data=result)
    logger.info(f"Adding `adata.obsm[{design_matrix_key!r}]`")
    return None


def _frame(adata: Any, cluster_key: str | None, library_key: str | None, columns: dict[str, NDArrayA],
           covariates: list[str] | None) -> Any:
    """The JAX package's DataFrame, column for column."""
    import pandas as pd

    df = pd.DataFrame(index=adata.obs.index)
    if cluster_key is not None:
        df[cluster_key] = adata.obs[cluster_key].values
    if library_key is not None:
        df[library_key] = adata.obs[library_key].values
    for name, values in columns.items():
        df[name] = values
    if covariates is not None:
        df[covariates] = adata.obs[covariates].copy()
    return df


def _columns(adata: Any, n_obs: int, cluster_key: str | None, library_key: str | None,
             columns: dict[str, NDArrayA], covariates: list[str] | None) -> Columns:
    """The same columns as numpy arrays, for a container without pandas."""
    out: dict[str, NDArrayA] = {}
    for key in (cluster_key, library_key):
        if key is not None:
            out[key] = obs_values(adata, key)
    out.update(columns)
    for key in covariates or ():
        out[key] = obs_values(adata, key)
    return Columns(obs_index(adata, n_obs), out)
