"""Sliding-window assignment of observations to spatial grid windows
(counterpart of ``squidpy_tpu/tl/_sliding_window.py``).

Non-overlapping windows give one ordered categorical assignment column;
overlapping windows give one boolean membership column a window. On a pandas
container the columns are written (or returned) as the JAX package writes
them; without pandas, as numpy arrays (the assignment as an object array of
window names, None outside every window) or a :class:`Columns`.
"""

from __future__ import annotations

import logging
from itertools import product
from typing import Any

import numpy as np

from squidpy_torch._device import NDArrayA
from squidpy_torch.gr._utils import _save_data, extract_adata_if_sdata
from squidpy_torch.tl._utils import Columns, first_appearance, is_frame, obs_index, obs_values

__all__ = ["sliding_window"]

logger = logging.getLogger(__name__)


def _window_coords(adata: Any, coord_columns: tuple[str, str], spatial_key: str) -> tuple[NDArrayA, NDArrayA]:
    """The (x, y) columns: explicit obs columns win over obsm."""
    x_col, y_col = coord_columns
    if x_col in adata.obs and y_col in adata.obs:
        return obs_values(adata, x_col), obs_values(adata, y_col)
    if spatial_key in adata.obsm:
        xy = np.asarray(adata.obsm[spatial_key])[:, :2]
        return xy[:, 0], xy[:, 1]
    raise ValueError(
        f"Coordinates not found. Provide `{coord_columns}` in `adata.obs` or specify a "
        f"suitable `spatial_key` in `adata.obsm`."
    )


def _auto_window_size(xy: NDArrayA, target_windows: float = 4.0) -> int:
    """A window size that tiles the larger coordinate extent into
    ``target_windows`` windows, widened by ~1% (divide by 3.95 rather than 4)
    so cells on the max border do not spill into a sliver extra window."""
    extent = float(np.max(np.ptp(xy, axis=0)))
    return max(int(extent / (target_windows - 0.05)), 1)


def sliding_window(
    adata: Any,
    library_key: str | None = None,
    window_size: int | None = None,
    overlap: int = 0,
    coord_columns: tuple[str, str] = ("globalX", "globalY"),
    sliding_window_key: str = "sliding_window_assignment",
    spatial_key: str = "spatial",
    drop_partial_windows: bool = False,
    copy: bool = False,
    *,
    table_key: str | None = None,
) -> Any:
    """Divide a tissue slice into regularly shaped spatially contiguous windows."""
    if overlap < 0:
        raise ValueError("Overlap must be non-negative.")

    adata = extract_adata_if_sdata(adata, table_key=table_key)
    x, y = _window_coords(adata, coord_columns, spatial_key)
    x_col, y_col = coord_columns

    if window_size is None:
        window_size = _auto_window_size(np.column_stack([x, y]))
    if window_size <= 0:
        raise ValueError("Window size must be larger than 0.")

    if library_key is not None and library_key not in adata.obs:
        raise ValueError(f"Library key '{library_key}' not found in adata.obs")
    library = None if library_key is None else obs_values(adata, library_key)
    libraries = [None] if library is None else first_appearance(library)

    if sliding_window_key in adata.obs:
        logger.warning(f"Overwriting existing column '{sliding_window_key}' in adata.obs.")

    n = len(x)
    assignment = np.full(n, None, dtype=object)
    members: dict[str, NDArrayA] = {}
    n_windows = 0
    for lib in libraries:
        rows = np.arange(n) if lib is None else np.flatnonzero(library == lib)
        lx, ly = x[rows], y[rows]
        corners = _calculate_window_corners(
            min_x=np.nanmin(lx), max_x=np.nanmax(lx), min_y=np.nanmin(ly), max_y=np.nanmax(ly),
            window_size=window_size, overlap=overlap, drop_partial_windows=drop_partial_windows,
        ).columns
        lib_prefix = f"{lib}_" if lib is not None else ""
        n_windows += len(corners["x_start"])
        for idx in range(len(corners["x_start"])):
            inside = ((lx >= corners["x_start"][idx]) & (lx <= corners["x_end"][idx])
                      & (ly >= corners["y_start"][idx]) & (ly <= corners["y_end"][idx]))
            if overlap == 0:  # a point on a shared edge ends in the later window
                assignment[rows[inside]] = f"{lib_prefix}window_{idx}"
            else:
                col = members.setdefault(f"{sliding_window_key}_{lib_prefix}window_{idx}", np.zeros(n, dtype=bool))
                col[rows[inside]] = True

    columns: dict[str, Any] = dict(members)
    if overlap == 0:
        if not n_windows:  # the JAX package never makes the column, and fails reading it
            raise KeyError(sliding_window_key)
        columns = {sliding_window_key: assignment}
    frame = is_frame(adata.obs)
    if frame:
        columns = _as_series(adata, columns, sliding_window_key, overlap)
    columns[x_col] = _column(adata, x, frame)
    columns[y_col] = _column(adata, y, frame)

    if copy:
        if frame:
            import pandas as pd

            return pd.DataFrame(columns, index=adata.obs.index)
        return Columns(obs_index(adata, n), columns)
    for col_name, col_data in columns.items():
        _save_data(adata, attr="obs", key=col_name, data=col_data)
    return None


def _as_series(adata: Any, columns: dict[str, NDArrayA], key: str, overlap: int) -> dict[str, Any]:
    """The columns as the JAX package builds them: the assignment an ordered
    categorical whose categories sort by window number (stable, in order of
    first appearance), the memberships boolean."""
    import pandas as pd

    index = adata.obs.index
    if overlap:
        return {name: pd.Series(values, index=index) for name, values in columns.items()}
    values = columns[key]
    named = np.array([v is not None for v in values], dtype=bool)
    values = np.where(named, values, np.nan)
    cats = sorted(first_appearance(values[named]), key=lambda v: int(v.split("_")[-1]))
    return {key: pd.Series(pd.Categorical(values, ordered=True, categories=cats), index=index)}


def _column(adata: Any, values: NDArrayA, frame: bool) -> Any:
    if not frame:
        return values
    import pandas as pd

    return pd.Series(values, index=adata.obs.index)


def _calculate_window_corners(
    min_x: float,
    max_x: float,
    min_y: float,
    max_y: float,
    window_size: float,
    overlap: float = 0,
    drop_partial_windows: bool = False,
) -> Columns:
    """Corner coordinates of all windows covering the bounding box: columns
    ``x_start``, ``x_end``, ``y_start``, ``y_end``, one row a window."""
    if overlap < 0:
        raise ValueError("Overlap must be non-negative.")
    if overlap >= window_size:
        raise ValueError("Overlap must be less than the window size.")

    step = window_size - overlap
    x_starts = np.arange(min_x, max_x, step)
    y_starts = np.arange(min_y, max_y, step)
    grid = np.asarray(list(product(x_starts, y_starts))).reshape(-1, 2)
    x_start, y_start = grid[:, 0], grid[:, 1]
    x_end, y_end = x_start + window_size, y_start + window_size

    if drop_partial_windows:
        keep = (x_end <= max_x) & (y_end <= max_y)
        x_start, x_end, y_start, y_end = x_start[keep], x_end[keep], y_start[keep], y_end[keep]
    else:
        x_end, y_end = np.minimum(x_end, max_x), np.minimum(y_end, max_y)
    return Columns(np.arange(len(x_start)), {"x_start": x_start, "x_end": x_end, "y_start": y_start,
                                            "y_end": y_end})
