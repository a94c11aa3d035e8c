"""h5ad (anndata on-disk format) reader/writer built on h5py (copy of
``squidpy_tpu/_core/io_h5ad.py``).

Implements the anndata 0.8+ element encodings (``encoding-type`` attrs:
``array``, ``string-array``, ``categorical``, ``csr_matrix``, ``csc_matrix``,
``dict``, ``dataframe``, ``string``, ``numeric-scalar``, ``nullable-*``):
enough to round-trip everything squidpy stores. h5py and pandas are
imported when a file is read or written, never when this module is
imported; without them a call raises ``ImportError`` naming the package.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any

import numpy as np
from scipy import sparse as sp

from squidpy_torch._core.anndata import AnnData
from squidpy_torch.utils._utils import optional_import

if TYPE_CHECKING:
    import h5py

__all__ = ["read_h5ad", "write_h5ad"]


@functools.cache
def _h5py() -> Any:
    return optional_import("h5py", "h5ad I/O")


@functools.cache
def _pd() -> Any:
    return optional_import("pandas", "h5ad I/O")


def _str_dtype() -> Any:
    return _h5py().string_dtype(encoding="utf-8")


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _read_elem(elem: h5py.Group | h5py.Dataset) -> Any:
    h5py, pd = _h5py(), _pd()
    enc = elem.attrs.get("encoding-type", None)
    if isinstance(elem, h5py.Dataset):
        if elem.shape == ():
            val = elem[()]
            if isinstance(val, bytes):
                return val.decode()
            return val.item() if hasattr(val, "item") else val
        arr = elem[...]
        if arr.dtype == object or enc == "string-array":
            return np.asarray([x.decode() if isinstance(x, bytes) else x for x in arr.ravel()]).reshape(arr.shape)
        return arr
    # groups
    if enc in ("csr_matrix", "csc_matrix"):
        shape = tuple(elem.attrs["shape"])
        cls = sp.csr_matrix if enc == "csr_matrix" else sp.csc_matrix
        return cls((elem["data"][...], elem["indices"][...], elem["indptr"][...]), shape=shape)
    if enc == "categorical":
        cats = _read_elem(elem["categories"])
        codes = elem["codes"][...]
        ordered = bool(elem.attrs.get("ordered", False))
        return pd.Categorical.from_codes(codes, categories=cats, ordered=ordered)
    if enc == "dataframe":
        index_key = elem.attrs["_index"]
        order = [c for c in elem.attrs.get("column-order", []) if c in elem]
        index = _read_elem(elem[index_key])
        df = pd.DataFrame(index=pd.Index(index))
        cols = order if order else [k for k in elem.keys() if k != index_key]
        for col in cols:
            if col == index_key:
                continue
            df[col] = _read_elem(elem[col])
        return df
    if enc == "dict" or enc is None:
        return {k: _read_elem(elem[k]) for k in elem.keys()}
    if enc in ("nullable-integer", "nullable-boolean"):
        values = elem["values"][...]
        mask = elem["mask"][...]
        out = values.astype(float)
        out[mask] = np.nan
        return out
    # unknown group encoding: return as dict
    return {k: _read_elem(elem[k]) for k in elem.keys()}


def read_h5ad(filename: str) -> AnnData:
    """Read an ``.h5ad`` file into :class:`squidpy_torch.AnnData`."""
    with _h5py().File(filename, "r") as f:
        X = _read_elem(f["X"]) if "X" in f else None
        obs = _read_elem(f["obs"]) if "obs" in f else None
        var = _read_elem(f["var"]) if "var" in f else None
        adata = AnnData(X=X, obs=obs, var=var, shape=None if X is not None else (len(obs) if obs is not None else 0, len(var) if var is not None else 0))
        for attr in ("obsm", "varm", "obsp", "varp", "layers", "uns"):
            if attr in f:
                setattr(adata, attr, _read_elem(f[attr]))
        if "raw" in f:
            raw_grp = f["raw"]
            raw_adata = AnnData(
                X=_read_elem(raw_grp["X"]) if "X" in raw_grp else None,
                obs=obs,
                var=_read_elem(raw_grp["var"]) if "var" in raw_grp else None,
            )
            from squidpy_torch._core.anndata import Raw

            adata.raw = Raw(raw_adata)
    return adata


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _set_enc(obj: h5py.Group | h5py.Dataset, enc: str, version: str = "0.2.0") -> None:
    obj.attrs["encoding-type"] = enc
    obj.attrs["encoding-version"] = version


def _write_elem(group: h5py.Group, key: str, value: Any) -> None:
    pd, str_dt = _pd(), _str_dtype()
    if key in group:
        del group[key]
    if value is None:
        return
    if sp.issparse(value):
        value = value.tocsr() if not sp.isspmatrix_csc(value) else value
        sub = group.create_group(key)
        _set_enc(sub, "csr_matrix" if sp.isspmatrix_csr(value) else "csc_matrix", "0.1.0")
        sub.attrs["shape"] = np.asarray(value.shape, dtype=np.int64)
        sub.create_dataset("data", data=value.data)
        sub.create_dataset("indices", data=value.indices)
        sub.create_dataset("indptr", data=value.indptr)
        return
    if isinstance(value, pd.DataFrame):
        sub = group.create_group(key)
        _set_enc(sub, "dataframe")
        sub.attrs["_index"] = "_index"
        sub.attrs["column-order"] = np.asarray(list(value.columns), dtype=str_dt)
        _write_elem(sub, "_index", np.asarray(value.index.astype(str)))
        for col in value.columns:
            _write_elem(sub, str(col), value[col].values if not isinstance(value[col].dtype, pd.CategoricalDtype) else value[col].values)
        return
    if isinstance(value, (pd.Categorical,)) or (isinstance(value, pd.Series) and isinstance(value.dtype, pd.CategoricalDtype)):
        cat = value if isinstance(value, pd.Categorical) else value.values
        sub = group.create_group(key)
        _set_enc(sub, "categorical")
        sub.attrs["ordered"] = bool(cat.ordered)
        _write_elem(sub, "categories", np.asarray(cat.categories))
        sub.create_dataset("codes", data=np.asarray(cat.codes))
        _set_enc(sub["codes"], "array")
        return
    if isinstance(value, pd.Series):
        _write_elem(group, key, value.to_numpy())
        return
    if isinstance(value, pd.Index):
        _write_elem(group, key, np.asarray(value))
        return
    if isinstance(value, dict):
        sub = group.create_group(key)
        _set_enc(sub, "dict", "0.1.0")
        for k, v in value.items():
            if str(k).startswith(("__squidpy_torch", "__squidpy_tpu")):
                continue  # device-side caches are not persisted
            _write_elem(sub, str(k), v)
        return
    if isinstance(value, str):
        ds = group.create_dataset(key, data=value, dtype=str_dt)
        _set_enc(ds, "string")
        return
    if isinstance(value, (bool, np.bool_)):
        ds = group.create_dataset(key, data=bool(value))
        _set_enc(ds, "numeric-scalar")
        return
    if isinstance(value, (int, float, np.integer, np.floating)):
        ds = group.create_dataset(key, data=value)
        _set_enc(ds, "numeric-scalar")
        return
    # array-like
    arr = np.asarray(value)
    if arr.dtype == object or arr.dtype.kind in "US":
        ds = group.create_dataset(key, data=arr.astype(str).astype(object), dtype=str_dt)
        _set_enc(ds, "string-array")
        return
    ds = group.create_dataset(key, data=arr)
    _set_enc(ds, "array")


def write_h5ad(filename: str, adata: AnnData) -> None:
    """Write :class:`squidpy_torch.AnnData` (or a duck-typed AnnData) to ``.h5ad``."""
    with _h5py().File(filename, "w") as f:
        f.attrs["encoding-type"] = "anndata"
        f.attrs["encoding-version"] = "0.1.0"
        _write_elem(f, "X", adata.X)
        _write_elem(f, "obs", adata.obs)
        _write_elem(f, "var", adata.var)
        for attr in ("obsm", "varm", "obsp", "varp", "layers", "uns"):
            _write_elem(f, attr, dict(getattr(adata, attr)))
