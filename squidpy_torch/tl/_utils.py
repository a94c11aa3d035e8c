"""What the tools read of a container and write back, with or without pandas."""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from squidpy_torch._device import NDArrayA

__all__ = ["Columns", "first_appearance", "is_frame", "obs_index", "obs_values"]


class Columns(NamedTuple):
    """The JAX package's result DataFrame without pandas: ``index`` holds the
    row labels (the container's cell names, or positions), ``columns`` maps
    each column name to its values, in the DataFrame's column order."""

    index: NDArrayA
    columns: dict[str, NDArrayA]


def is_frame(obs: Any) -> bool:
    """Whether ``obs`` is a pandas DataFrame (duck-typed: columns and index)."""
    return hasattr(obs, "columns") and hasattr(obs, "index")


def obs_values(adata: Any, key: str) -> NDArrayA:
    """An obs column as a numpy array; a stand-in categorical's codes turned
    into its categories (NaN for code -1, as pandas gives it)."""
    col = adata.obs[key]
    cat = getattr(col, "cat", None)
    if cat is not None and not is_frame(adata.obs):
        codes = np.asarray(cat.codes)
        values = np.asarray(cat.categories, dtype=object)[np.maximum(codes, 0)]
        values[codes < 0] = np.nan
        return values
    return np.asarray(col)


def obs_index(adata: Any, n: int) -> NDArrayA:
    """The container's cell names, or their positions where it has none."""
    index = getattr(adata.obs, "index", None)
    if index is None:
        index = getattr(adata, "obs_names", None)
    return np.arange(n) if index is None else np.asarray(index)


def first_appearance(values: NDArrayA) -> list[Any]:
    """The distinct values in order of first appearance (pandas' ``unique``),
    NaN left out."""
    seen: dict[Any, None] = {}
    for v in values.tolist():
        if v == v:  # NaN is not
            seen.setdefault(v, None)
    return list(seen)
