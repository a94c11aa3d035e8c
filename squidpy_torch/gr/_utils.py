"""Graph-module utilities (counterpart of ``squidpy_tpu/gr/_utils.py``), without pandas.

Containers are duck-typed as in the JAX package: ``.obs``, ``.obsm``,
``.obsp`` and ``.uns`` mappings, where a categorical ``obs[key]`` exposes
``.cat.codes`` and ``.cat.categories``.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from contextlib import contextmanager
from typing import Any

import numpy as np
from scipy import sparse as sp

__all__ = [
    "_assert_categorical_obs",
    "_assert_connectivity_key",
    "_assert_non_empty_sequence",
    "_assert_spatial_basis",
    "_categorical_codes",
    "_extract_expression",
    "_genesymbols",
    "_save_data",
    "_take_columns",
    "_var_positions",
    "extract_adata_if_sdata",
]


def extract_adata_if_sdata(adata: Any, table_key: str | None = None) -> Any:
    """Accept AnnData or SpatialData (duck-typed on ``.tables``); return the table."""
    if hasattr(adata, "tables"):
        tables = adata.tables
        if table_key is not None:
            if table_key not in tables:
                raise KeyError(f"Table `{table_key}` not found in `sdata.tables`.")
            return tables[table_key]
        if len(tables) != 1:
            raise ValueError(
                f"Expected exactly one table in `sdata.tables`, found `{len(tables)}`. Please specify `table_key`."
            )
        return next(iter(tables.values()))
    return adata


def _assert_categorical_obs(adata: Any, key: str) -> None:
    if key not in adata.obs:
        raise KeyError(f"Key `{key}` not found in `adata.obs`.")
    col = adata.obs[key]
    cat = getattr(col, "cat", None)
    if cat is None or not hasattr(cat, "codes") or not hasattr(cat, "categories"):
        raise TypeError(
            f"Expected `adata.obs[{key!r}]` to be `categorical`, found `{getattr(col, 'dtype', type(col))}`."
        )


def _categorical_codes(adata: Any, key: str) -> tuple[np.ndarray, int]:
    """``(codes as int32, number of categories)`` of a categorical obs column."""
    col = adata.obs[key]
    return np.asarray(col.cat.codes, dtype=np.int32), len(col.cat.categories)


def _assert_connectivity_key(adata: Any, key: str) -> None:
    if key not in adata.obsp:
        raise KeyError(
            f"Spatial connectivity key `{key}` not found in `adata.obsp`. "
            f"Please run `squidpy_torch.gr.spatial_neighbors_knn` first."
        )


def _assert_spatial_basis(adata: Any, key: str) -> None:
    if key not in adata.obsm:
        raise KeyError(f"Spatial basis `{key}` not found in `adata.obsm`.")


def _assert_non_empty_sequence(seq: Any, *, name: str) -> list[Any]:
    if isinstance(seq, str):
        seq = [seq]
    seq = list(seq)
    if not len(seq):
        raise ValueError(f"No {name} have been selected.")
    return seq


def _var_positions(var_names: Any, genes: Sequence[Any]) -> list[int]:
    """Column positions of ``genes`` (names, or integer positions) in ``var_names``."""
    first: dict[str, int] = {}
    for i, name in enumerate(np.asarray(var_names)):
        first.setdefault(str(name), i)
    pos = []
    for g in genes:
        if isinstance(g, (int, np.integer)) and not isinstance(g, bool):
            pos.append(int(g))
        elif str(g) in first:
            pos.append(first[str(g)])
        else:
            raise KeyError(f"Gene `{g}` not found in `var_names`.")
    return pos


def _take_columns(x: Any, pos: list[int]) -> Any:
    if pos == list(range(x.shape[1])):
        return x
    return x[:, pos] if sp.issparse(x) else np.asarray(x)[:, pos]


def _extract_expression(
    adata: Any, genes: list[str] | None = None, use_raw: bool = False, layer: str | None = None
) -> tuple[Any, list[str]]:
    """``(cells x genes)`` expression and the gene names: of ``adata.raw``
    with ``use_raw`` (genes missing there dropped), else of ``X`` or
    ``layers[layer]``; columns taken by name, sparse stays sparse."""
    if use_raw and getattr(adata, "raw", None) is not None:
        raw_names = [str(g) for g in adata.raw.var_names]
        genes = raw_names if genes is None else [g for g in genes if str(g) in set(raw_names)]
        return _take_columns(adata.raw.X, _var_positions(raw_names, genes)), genes
    if genes is None:
        genes = list(adata.var_names)
    x = adata.X if layer is None else adata.layers[layer]
    return _take_columns(x, _var_positions(adata.var_names, genes)), genes


def _save_data(adata: Any, *, attr: str, key: str, data: Any) -> None:
    """Write a result under a conventional key."""
    getattr(adata, attr)[key] = data


@contextmanager
def _genesymbols(adata: Any, *, key: str | None = None, use_raw: bool = False) -> Iterator[Any]:
    """Temporarily rename ``var_names`` to the gene symbols in ``adata.var[key]``
    (of ``adata.raw`` with ``use_raw``). The renamed index is built with the
    var index's own type, so no pandas is imported here."""
    if key is None:
        yield adata
        return
    obj = adata.raw if use_raw and getattr(adata, "raw", None) is not None else adata
    if key not in obj.var:
        raise KeyError(f"Unable to find gene symbols in `adata.var[{key!r}]`.")
    original = obj.var.index.copy()
    try:
        obj.var.index = type(original)([str(v) for v in obj.var[key]])
        yield adata
    finally:
        obj.var.index = original
