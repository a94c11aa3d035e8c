"""A standalone, duck-type-compatible AnnData container (copy of
``squidpy_tpu/_core/anndata.py``).

The same attribute surface as :class:`anndata.AnnData` (``X``, ``obs``,
``var``, ``obsm``, ``varm``, ``obsp``, ``uns``, ``layers``, ``raw``,
slicing) plus h5ad round-tripping (:mod:`squidpy_torch._core.io_h5ad`).
``obs`` and ``var`` are pandas DataFrames, so pandas is imported where a
container is made or sliced, never when this module is imported: on a
machine without pandas ``import squidpy_torch`` works, and making a
container raises ``ImportError`` naming pandas.

Every ``squidpy_torch`` public function duck-types its ``adata`` argument, so a
real :class:`anndata.AnnData`, or a numpy stand-in, works as well.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping
from typing import TYPE_CHECKING, Any

import numpy as np
from scipy import sparse as sp

from squidpy_torch.utils._utils import optional_import

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["AnnData", "Raw", "concat"]


def _pd() -> Any:
    return optional_import("pandas", "squidpy_torch.AnnData")


def _as_df(value: pd.DataFrame | Mapping[str, Any] | None, n: int | None, axis_name: str) -> pd.DataFrame:
    pd = _pd()
    if value is None:
        df = pd.DataFrame(index=pd.RangeIndex(n if n is not None else 0).astype(str))
    elif isinstance(value, pd.DataFrame):
        df = value.copy()
        if isinstance(df.index, pd.RangeIndex):
            df.index = df.index.astype(str)
    else:
        df = pd.DataFrame(dict(value))
        df.index = df.index.astype(str)
    if n is not None and len(df) != n:
        if len(df) == 0 and len(df.columns) == 0:
            df = pd.DataFrame(index=pd.RangeIndex(n).astype(str))
        else:
            raise ValueError(f"`{axis_name}` has {len(df)} rows, expected {n}.")
    df.index.name = None
    return df


def _make_unique(names: Iterable[str]) -> pd.Index:
    """Deduplicate names with ``-N`` suffixes (anndata convention)."""
    pd = _pd()
    counts: dict[str, int] = {}
    out = []
    for name in names:
        if name in counts:
            counts[name] += 1
            out.append(f"{name}-{counts[name]}")
        else:
            counts[name] = 0
            out.append(name)
    return pd.Index(out)


class Raw:
    """Frozen snapshot of (X, var) — mirrors ``anndata.Raw``."""

    def __init__(self, adata: AnnData):
        self._X = adata.X.copy() if adata.X is not None else None
        self._var = adata.var.copy()
        self._n_obs = adata.n_obs

    @property
    def X(self):  # noqa: ANN201
        return self._X

    @property
    def var(self) -> pd.DataFrame:
        return self._var

    @property
    def var_names(self) -> pd.Index:
        return self._var.index

    @property
    def n_vars(self) -> int:
        return len(self._var)

    @property
    def shape(self) -> tuple[int, int]:
        return (self._n_obs, self.n_vars)

    def __getitem__(self, index: Any) -> Raw:
        pd = _pd()
        obs_idx, var_idx = _unpack_index(index)
        var_pos = _resolve_idx(var_idx, self._var.index)
        out = object.__new__(Raw)
        X = self._X
        if X is not None:
            obs_pos = _resolve_idx(obs_idx, pd.RangeIndex(self._n_obs).astype(str))
            X = X[obs_pos][:, var_pos] if not _is_full_slice(obs_idx) else X[:, var_pos]
        out._X = X
        out._var = self._var.iloc[var_pos] if not _is_full_slice(var_idx) else self._var
        out._n_obs = X.shape[0] if X is not None else self._n_obs
        return out


def _is_full_slice(idx: Any) -> bool:
    return isinstance(idx, slice) and idx == slice(None)


def _take_rows(v: Any, pos: np.ndarray) -> Any:
    """Positional row-subset that works for arrays and DataFrames alike."""
    if hasattr(v, "iloc"):  # a DataFrame
        return v.iloc[pos]
    return v[pos]


def _unpack_index(index: Any) -> tuple[Any, Any]:
    if isinstance(index, tuple):
        if len(index) == 1:
            return index[0], slice(None)
        if len(index) == 2:
            return index
        raise IndexError("AnnData can only be sliced in 2 dimensions.")
    return index, slice(None)


def _resolve_idx(idx: Any, names: pd.Index) -> np.ndarray:
    """Resolve an obs/var indexer to integer positions."""
    n = len(names)
    if isinstance(idx, slice):
        return np.arange(n)[idx]
    if isinstance(idx, str):
        loc = names.get_loc(idx)
        return np.asarray([loc] if np.isscalar(loc) else np.arange(n)[loc])
    if isinstance(idx, (int, np.integer)):
        return np.asarray([int(idx)])
    idx = np.asarray(idx)
    if idx.dtype == bool:
        if len(idx) != n:
            raise IndexError(f"Boolean index of length {len(idx)} does not match axis length {n}.")
        return np.where(idx)[0]
    if idx.dtype.kind in "iu":
        return idx.astype(np.int64)
    # array of names
    indexer = names.get_indexer(idx)
    if (indexer < 0).any():
        missing = np.asarray(idx)[indexer < 0]
        raise KeyError(f"Names not found: {list(missing[:5])}")
    return indexer


class AnnData:
    """Annotated data matrix: observations x variables.

    API-compatible subset of :class:`anndata.AnnData` sufficient for the whole
    squidpy surface: attribute access, aligned mappings, slicing, ``copy`` and
    h5ad round-trip (via :func:`squidpy_torch.read_h5ad` / :meth:`write_h5ad`).
    """

    def __init__(
        self,
        X: np.ndarray | sp.spmatrix | None = None,
        obs: pd.DataFrame | Mapping[str, Any] | None = None,
        var: pd.DataFrame | Mapping[str, Any] | None = None,
        uns: Mapping[str, Any] | None = None,
        obsm: Mapping[str, Any] | None = None,
        varm: Mapping[str, Any] | None = None,
        obsp: Mapping[str, Any] | None = None,
        varp: Mapping[str, Any] | None = None,
        layers: Mapping[str, Any] | None = None,
        shape: tuple[int, int] | None = None,
        dtype: Any = None,
    ):
        if X is not None:
            if not sp.issparse(X):
                X = np.asarray(X)
            if dtype is not None:
                X = X.astype(dtype)
            if X.ndim != 2:
                raise ValueError(f"X must be 2-dimensional, got shape {X.shape}.")
            n_obs, n_vars = X.shape
        elif shape is not None:
            n_obs, n_vars = shape
        else:
            n_obs = len(obs) if obs is not None and hasattr(obs, "__len__") else None
            n_vars = len(var) if var is not None and hasattr(var, "__len__") else None

        self._X = X
        self.obs = _as_df(obs, n_obs, "obs")
        self.var = _as_df(var, n_vars, "var")
        self.uns: dict[str, Any] = dict(uns) if uns else {}
        self.obsm: dict[str, Any] = dict(obsm) if obsm else {}
        self.varm: dict[str, Any] = dict(varm) if varm else {}
        self.obsp: dict[str, Any] = dict(obsp) if obsp else {}
        self.varp: dict[str, Any] = dict(varp) if varp else {}
        self.layers: dict[str, Any] = dict(layers) if layers else {}
        self.raw: Raw | None = None

    # -- basic properties -------------------------------------------------
    @property
    def X(self):  # noqa: ANN201
        return self._X

    @X.setter
    def X(self, value) -> None:  # noqa: ANN001
        if value is not None:
            if not sp.issparse(value):
                value = np.asarray(value)
            if value.shape != self.shape:
                raise ValueError(f"Shape mismatch: X {value.shape} vs AnnData {self.shape}.")
        self._X = value

    @property
    def n_obs(self) -> int:
        return len(self.obs)

    @property
    def n_vars(self) -> int:
        return len(self.var)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_obs, self.n_vars)

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names: Iterable[str]) -> None:
        pd = _pd()
        self.obs.index = pd.Index(names)

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @var_names.setter
    def var_names(self, names: Iterable[str]) -> None:
        pd = _pd()
        self.var.index = pd.Index(names)

    def obs_vector(self, key: str, layer: str | None = None) -> np.ndarray:
        """Column ``key`` from ``.obs`` or from X/layer by var name, as a dense 1D array."""
        if key in self.obs.columns:
            return self.obs[key].to_numpy()
        j = self.var_names.get_loc(key)
        M = self.X if layer is None else self.layers[layer]
        col = M[:, j]
        return np.asarray(col.todense()).ravel() if sp.issparse(col) else np.asarray(col).ravel()

    # -- mutation helpers --------------------------------------------------
    def var_names_make_unique(self) -> None:
        if not self.var.index.is_unique:
            self.var.index = _make_unique(self.var.index)

    def obs_names_make_unique(self) -> None:
        if not self.obs.index.is_unique:
            self.obs.index = _make_unique(self.obs.index)

    # -- slicing -----------------------------------------------------------
    def __getitem__(self, index: Any) -> AnnData:
        obs_idx, var_idx = _unpack_index(index)
        obs_pos = _resolve_idx(obs_idx, self.obs_names)
        var_pos = _resolve_idx(var_idx, self.var_names)

        X = self._X
        if X is not None:
            X = X[obs_pos][:, var_pos]
        out = AnnData(
            X=X,
            obs=self.obs.iloc[obs_pos],
            var=self.var.iloc[var_pos],
            uns=self.uns,
            shape=(len(obs_pos), len(var_pos)) if X is None else None,
        )
        out.obsm = {k: _take_rows(v, obs_pos) for k, v in self.obsm.items()}
        out.varm = {k: _take_rows(v, var_pos) for k, v in self.varm.items()}
        out.obsp = {k: v[obs_pos][:, obs_pos] for k, v in self.obsp.items()}
        out.varp = {k: v[var_pos][:, var_pos] for k, v in self.varp.items()}
        out.layers = {k: v[obs_pos][:, var_pos] for k, v in self.layers.items()}
        out.raw = self.raw[obs_pos, :] if self.raw is not None else None
        return out

    def copy(self) -> AnnData:
        out = AnnData(
            X=self._X.copy() if self._X is not None else None,
            obs=self.obs.copy(),
            var=self.var.copy(),
            uns=_deepcopy_uns(self.uns),
            shape=self.shape if self._X is None else None,
        )
        out.obsm = {k: v.copy() if hasattr(v, "copy") else v for k, v in self.obsm.items()}
        out.varm = {k: v.copy() if hasattr(v, "copy") else v for k, v in self.varm.items()}
        out.obsp = {k: v.copy() if hasattr(v, "copy") else v for k, v in self.obsp.items()}
        out.varp = {k: v.copy() if hasattr(v, "copy") else v for k, v in self.varp.items()}
        out.layers = {k: v.copy() if hasattr(v, "copy") else v for k, v in self.layers.items()}
        out.raw = self.raw
        return out

    def __repr__(self) -> str:
        lines = [f"AnnData object with n_obs × n_vars = {self.n_obs} × {self.n_vars}"]
        for attr in ("obs", "var"):
            cols = list(getattr(self, attr).columns)
            if cols:
                lines.append(f"    {attr}: {', '.join(map(repr, cols))}")
        for attr in ("uns", "obsm", "varm", "obsp", "varp", "layers"):
            keys = list(getattr(self, attr).keys())
            if keys:
                lines.append(f"    {attr}: {', '.join(map(repr, keys))}")
        return "\n".join(lines)

    # -- I/O ----------------------------------------------------------------
    def write_h5ad(self, filename: str, **kwargs: Any) -> None:
        from squidpy_torch._core.io_h5ad import write_h5ad

        write_h5ad(filename, self)

    write = write_h5ad


def _deepcopy_uns(d: Mapping[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, Mapping):
            out[k] = _deepcopy_uns(v)
        elif hasattr(v, "copy"):
            out[k] = v.copy()
        else:
            out[k] = v
    return out


def concat(adatas: Iterable[AnnData], join: str = "inner", label: str | None = None, keys: Iterable[str] | None = None, index_unique: str | None = None) -> AnnData:
    """Concatenate AnnData objects along the obs axis (inner join on vars)."""
    pd = _pd()
    adatas = list(adatas)
    if not adatas:
        raise ValueError("No objects to concatenate.")
    var_names = adatas[0].var_names
    for a in adatas[1:]:
        if join == "inner":
            var_names = var_names.intersection(a.var_names)
        else:
            var_names = var_names.union(a.var_names)

    def _reindex_vars(a: AnnData) -> AnnData:
        if a.var_names.equals(var_names):
            return a
        if join == "inner":
            return a[:, var_names]
        # outer: map existing columns into the union, zero-fill the rest
        out = AnnData(shape=(a.n_obs, len(var_names)), obs=a.obs, var=pd.DataFrame(index=var_names))
        if a.X is not None:
            pos = var_names.get_indexer(a.var_names)
            X = sp.lil_matrix((a.n_obs, len(var_names))) if sp.issparse(a.X) else np.zeros((a.n_obs, len(var_names)))
            X[:, pos] = a.X.todense() if sp.issparse(a.X) else a.X
            out.X = sp.csr_matrix(X) if sp.issparse(a.X) else np.asarray(X)
        out.obsm = dict(a.obsm)
        return out

    subs = [_reindex_vars(a) for a in adatas]

    Xs = [a.X for a in subs]
    if any(x is None for x in Xs):
        X = None
    elif any(sp.issparse(x) for x in Xs):
        X = sp.vstack([sp.csr_matrix(x) for x in Xs], format="csr")
    else:
        X = np.vstack(Xs)

    obs_parts = []
    for i, a in enumerate(subs):
        obs = a.obs.copy()
        if label is not None:
            obs[label] = (list(keys)[i] if keys is not None else str(i))
        if index_unique is not None:
            key = list(keys)[i] if keys is not None else str(i)
            obs.index = [f"{n}{index_unique}{key}" for n in obs.index]
        obs_parts.append(obs)
    obs = pd.concat(obs_parts, axis=0)
    if label is not None:
        obs[label] = obs[label].astype("category")

    out = AnnData(X=X, obs=obs, var=subs[0].var.copy(), shape=(len(obs), len(var_names)) if X is None else None)
    for k in set.intersection(*(set(a.obsm) for a in subs)) if subs else set():
        out.obsm[k] = np.vstack([np.asarray(a.obsm[k]) for a in subs])
    return out
