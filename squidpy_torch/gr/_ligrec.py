"""Receptor-ligand analysis, the CellPhoneDB permutation test (counterpart of
``squidpy_tpu/gr/_ligrec.py``), without pandas.

``PermutationTestABC.prepare`` (interaction forms, upper-casing and
de-duplication, gene filtering, complex policies ``'min'``/``'all'``) and
``test`` (cluster pairs, row subsets, the threshold mask, NaN semantics,
FDR along clusters or interactions) are host code copied from the JAX
package, with pandas' semantics written out: the interactions are a table of
named columns in row order, and the results a :class:`LigrecResult`. The
observed means run on the host or, for the device expression handle, as a
one-hot product on the device; the permutations' shuffled labels are drawn
on the device (kernel K10) and their counts run as kernel K9
(:mod:`squidpy_torch.ops.ligrec`). Precision follows the JAX package as its
test suite runs it (x64 on): float64 up to :data:`_EXACT_SIZE_LIMIT`
elements of the filtered matrix, float32 above.
"""

from __future__ import annotations

from abc import ABC
from collections.abc import Iterable, Mapping
from itertools import product
from types import MappingProxyType
from typing import Any, Literal, NamedTuple

import numpy as np
import torch
from scipy import sparse as sp
from torch.profiler import record_function

from squidpy_torch._constants._constants import ComplexPolicy, CorrAxis
from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.device_x import _narrowest_container, device_expression
from squidpy_torch._core.rng import _keys_per_chunk, permutation_batch, spawn_keys
from squidpy_torch._device import NDArrayA, assert_positive, get_device, to_host
from squidpy_torch.gr._utils import _assert_categorical_obs, _genesymbols, _save_data, extract_adata_if_sdata
from squidpy_torch.ops.ligrec import _k9_route, cluster_means, counts_operand, label_stride, ligrec_perm_counts
from squidpy_torch.utils import check_tuple_needles, multipletests

__all__ = ["LigrecFrame", "LigrecResult", "PermutationTest", "PermutationTestABC", "ligrec"]

SOURCE = "source"
TARGET = "target"

# above this many elements of the interaction-filtered matrix the test runs
# in float32 (and through the device expression handle where it can), at or
# below it in float64: the JAX package's rule with x64 on, as its tests run
_EXACT_SIZE_LIMIT = 4_000_000


class LigrecFrame(NamedTuple):
    """One of the JAX package's result DataFrames without pandas: ``index``
    the (source, target) rows, ``columns`` the (cluster_1, cluster_2)
    columns, ``values`` the dense float64 ``(rows, columns)`` values, equal to
    the frame's ``to_numpy(dtype=float)``."""

    index: list[tuple[Any, Any]]
    columns: list[tuple[str, str]]
    values: NDArrayA


class LigrecResult(NamedTuple):
    """``ligrec``'s result: ``means`` and ``pvalues`` (:class:`LigrecFrame`)
    and ``metadata``, the interactions' other columns in the JAX frame's
    column order (sorted), each a column of values in row order."""

    means: LigrecFrame
    pvalues: LigrecFrame
    metadata: dict[str, NDArrayA]


def _is_na(v: Any) -> bool:
    """pandas' missing values: None, float NaN and ``pd.NA``."""
    return v is None or (isinstance(v, float) and v != v) or type(v).__name__ == "NAType"


def _upper(v: Any) -> Any:
    """``Series.str.upper`` of one value: non-strings become missing."""
    return v.upper() if isinstance(v, str) else None


def _fdr_correct(values: NDArrayA, corr_method: str, corr_axis: Literal["interactions", "clusters"] | CorrAxis,
                 alpha: float = 0.05) -> NDArrayA:
    """FDR-correct ``(interactions, cluster pairs)`` p-values along the
    requested axis; NaN p-values count as 1 in the correction and stay NaN."""

    def fdr(col: NDArrayA) -> NDArrayA:
        _, qvals, _, _ = multipletests(np.nan_to_num(col, copy=True, nan=1.0), method=corr_method, alpha=alpha)
        qvals[np.isnan(col)] = np.nan
        return qvals

    corr_axis = CorrAxis(corr_axis)
    if corr_axis == CorrAxis.CLUSTERS:
        return np.stack([fdr(values[:, j]) for j in range(values.shape[1])], axis=1)
    if corr_axis == CorrAxis.INTERACTIONS:
        return np.stack([fdr(values[i]) for i in range(values.shape[0])], axis=0)
    raise NotImplementedError(f"FDR correction for `{corr_axis}` is not implemented.")


class PermutationTestABC(ABC):
    """Receptor-ligand interaction testing.

    Workflow::

        pt = PermutationTest(adata).prepare(interactions)
        res = pt.test("clusters")
    """

    def __init__(self, adata: Any, use_raw: bool = True):
        if not hasattr(adata, "obs") or not hasattr(adata, "var_names"):
            raise TypeError(f"Expected `adata` to be an AnnData, found `{type(adata).__name__}`.")
        if not adata.n_obs:
            raise ValueError("No cells are in `adata.obs_names`.")
        if not adata.n_vars:
            raise ValueError("No genes are in `adata.var_names`.")

        self._adata = adata
        self._use_raw = bool(use_raw)
        if use_raw:
            if adata.raw is None:
                raise AttributeError("No `.raw` attribute found. Try specifying `use_raw=False`.")
            if adata.raw.shape[0] != adata.n_obs:
                raise ValueError(
                    f"Expected `{adata.n_obs}` cells in `.raw` object, found `{adata.raw.shape[0]}`."
                )
            data_obj = adata.raw
        else:
            data_obj = adata

        # X stays as it is (dense or CSC); gene columns are taken from it on
        # demand, in the JAX package's dtype (floats kept, float16 and
        # non-floats as float32) with NaN as 0
        x = data_obj.X
        self._x = sp.csc_matrix(x) if sp.issparse(x) else np.asarray(x)
        kind = self._x.dtype
        self._dtype = kind if np.issubdtype(kind, np.floating) and kind != np.float16 else np.dtype(np.float32)
        values = self._x.data if sp.issparse(self._x) else self._x
        self._had_nan = bool(np.issubdtype(kind, np.floating) and np.isnan(values).any())
        self._genes = [str(g) for g in data_obj.var_names]  # column names
        self._gene_cols = list(range(len(self._genes)))  # their columns of X
        self._filtered: list[int] | None = None  # positions in self._genes

        self._interactions: dict[str, list[Any]] | None = None
        self._row_labels: list[Any] = []

    def _columns(self, pos: list[int]) -> NDArrayA:
        """``(n_obs, len(pos))`` values of the genes at positions ``pos``,
        column-major as the JAX package's ``DataFrame.to_numpy()``."""
        cols = [self._gene_cols[p] for p in pos]
        block = self._x[:, cols].toarray() if sp.issparse(self._x) else self._x[:, cols]
        block = np.asfortranarray(block, dtype=self._dtype)
        if self._had_nan:
            block = np.nan_to_num(block, nan=0.0, posinf=np.inf, neginf=-np.inf, copy=False)
        return block

    def prepare(
        self,
        interactions: Any,
        complex_policy: Literal["min", "all"] | ComplexPolicy = ComplexPolicy.MIN.v,
    ) -> PermutationTestABC:
        """Validate and filter interactions; resolve protein complexes."""
        complex_policy = ComplexPolicy(complex_policy)

        with record_function("ligrec.prepare"):
            index = None  # a DataFrame's row labels: complexes 'all' joins on them
            if isinstance(interactions, Mapping):
                interactions = _table_of_mapping(interactions)
            elif hasattr(interactions, "columns"):  # a DataFrame, duck-typed
                index = list(interactions.index)
                interactions = {c: list(interactions[c]) for c in interactions.columns}
            elif isinstance(interactions, Iterable):
                interactions = tuple(interactions)
                if not len(interactions):
                    raise ValueError("No interactions were specified.")
                if isinstance(interactions[0], str):
                    interactions = list(product(interactions, repeat=2))
                elif len(interactions) == 2:
                    interactions = tuple(zip(*interactions))
                if not all(len(i) == 2 for i in interactions):
                    raise ValueError("Not all interactions are of length `2`.")
                interactions = {SOURCE: [i[0] for i in interactions], TARGET: [i[1] for i in interactions]}
            else:
                raise TypeError(
                    f"Expected either a `pandas.DataFrame`, `dict` or `iterable`, found `{type(interactions).__name__}`"
                )
            if SOURCE not in interactions:
                raise KeyError(f"Column `{SOURCE!r}` is not in `interactions`.")
            if TARGET not in interactions:
                raise KeyError(f"Column `{TARGET!r}` is not in `interactions`.")
            self._interactions = interactions
            if not len(self._interactions[SOURCE]):
                raise ValueError("The interactions are empty")
            self._row_labels = index if index is not None else list(range(len(self._interactions[SOURCE])))

            # gene symbols are case-normalized on both sides before any matching
            self._genes = [g.upper() for g in self._genes]
            for col in (SOURCE, TARGET):
                self._interactions[col] = [_upper(v) for v in self._interactions[col]]
            self._dedupe_interactions()

            first: dict[str, int] = {}
            for i, g in enumerate(self._genes):
                first.setdefault(g, i)
            if len(first) < len(self._genes):  # keep each gene's first column
                keep = sorted(first.values())
                self._genes = [self._genes[i] for i in keep]
                self._gene_cols = [self._gene_cols[i] for i in keep]

            self._filter_interactions_complexes(complex_policy)
            self._filter_interactions_by_genes()
            self._trim_data()
            self._dedupe_interactions()
        return self

    def _take_rows(self, keep: list[bool] | NDArrayA) -> None:
        self._interactions = {c: [v for v, k in zip(vals, keep) if k] for c, vals in self._interactions.items()}
        self._row_labels = [v for v, k in zip(self._row_labels, keep) if k]

    def _dedupe_interactions(self) -> None:
        """Drop NaN-bearing and repeated (source, target) pairs, keeping the
        first occurrence so interaction metadata stays aligned."""
        seen: set[tuple[Any, Any]] = set()
        keep = []
        for s, t in zip(self._interactions[SOURCE], self._interactions[TARGET]):
            ok = not (_is_na(s) or _is_na(t)) and (s, t) not in seen
            if ok:
                seen.add((s, t))
            keep.append(ok)
        self._take_rows(keep)

    def test(
        self,
        cluster_key: str,
        clusters: Any = None,
        n_perms: int = 1000,
        threshold: float = 0.01,
        seed: int | None = None,
        corr_method: str | None = None,
        corr_axis: Literal["interactions", "clusters"] | CorrAxis = CorrAxis.INTERACTIONS.v,
        alpha: float = 0.05,
        copy: bool = False,
        key_added: str | None = None,
        numba_parallel: bool | None = None,
        **kwargs: Any,
    ) -> LigrecResult | None:
        """Run the CellPhoneDB permutation test."""
        assert_positive(n_perms, name="n_perms")
        _assert_categorical_obs(self._adata, key=cluster_key)

        if corr_method is not None:
            corr_axis = CorrAxis(corr_axis)
        col = self._adata.obs[cluster_key]
        if len(col.cat.categories) <= 1:
            raise ValueError(f"Expected at least `2` clusters, found `{len(col.cat.categories)}`.")

        # the clusters as strings: `astype("string").astype("category")`
        # keeps the strings of the categories cells hold, sorted
        names = [str(c) for c in col.cat.categories]
        codes = np.asarray(col.cat.codes, dtype=np.int64)
        present = np.unique(codes[codes >= 0])
        categories = sorted({names[c] for c in present})

        if clusters is None:
            clusters = list(names)
        if all(isinstance(c, str) for c in clusters):
            clusters = list(product(clusters, repeat=2))
        clusters = sorted(check_tuple_needles(clusters, categories, msg="Invalid cluster `{0!r}`.", reraise=True))
        clusters_flat = {c for cs in clusters for c in cs}

        chosen = np.array([name in clusters_flat for name in names] + [False])
        row_mask = chosen[codes]  # code -1 (NaN) takes the appended False
        kept = sorted({names[c] for c in np.unique(codes[row_mask])})
        cluster_mapper = {c: i for i, c in enumerate(kept)}
        recode = np.array([cluster_mapper.get(name, -1) for name in names] + [-1], dtype=np.int32)
        clustering = recode[codes[row_mask]]

        genes = [self._genes[p] for p in self._filtered]
        gene_mapper = {g: i for i, g in enumerate(genes)}
        clusters_ = np.array([[cluster_mapper[c1], cluster_mapper[c2]] for c1, c2 in clusters], dtype=np.int32)
        interactions_ = np.array(
            [[gene_mapper[s], gene_mapper[t]] for s, t in zip(self._interactions[SOURCE], self._interactions[TARGET])],
            dtype=np.int32,
        ).reshape(-1, 2)

        # the device expression handle, as the JAX package takes it: only in
        # float32, for all cells, without NaN cleaning, and with every gene
        # resolved by its upper-cased name (ambiguous names stay on the host)
        x_dev = None
        all_rows = bool(row_mask.all())
        if len(clustering) * len(genes) > _EXACT_SIZE_LIMIT and all_rows and not self._had_nan:
            n_vars_src = self._adata.raw.n_vars if self._use_raw else self._adata.n_vars
            handle = device_expression(self._adata, use_raw=self._use_raw, create=2 * len(genes) >= n_vars_src)
            if handle is not None:
                upper_map: dict[str, int] = {}
                for i, v in enumerate(handle.var_names):
                    u = v.upper()
                    upper_map[u] = -1 if u in upper_map else i
                cols = [upper_map.get(g) for g in genes]
                if all(c is not None and c >= 0 for c in cols):
                    x_dev = handle.dense_block(np.asarray(cols, dtype=np.int64))

        data = None
        if x_dev is None:
            data = self._columns(self._filtered)
            if not all_rows:
                data = np.asfortranarray(data[row_mask])
        res_means, res_pvalues = _analysis(
            data, clustering, len(kept), interactions_, clusters_,
            threshold=threshold, n_perms=n_perms, seed=seed, x_dev=x_dev,
        )

        with record_function("ligrec.container"):
            index = list(zip(self._interactions[SOURCE], self._interactions[TARGET]))
            pvalues = np.asarray(res_pvalues, dtype=np.float64)
            if corr_method is not None:
                pvalues = _fdr_correct(pvalues, corr_method, corr_axis, alpha=alpha)
            other = [c for c in self._interactions if c not in (SOURCE, TARGET)]
            try:
                other = sorted(other)  # `Index.difference` sorts where it can
            except TypeError:
                pass
            res = LigrecResult(
                means=LigrecFrame(index, list(clusters), np.asarray(res_means, dtype=np.float64)),
                pvalues=LigrecFrame(index, list(clusters), pvalues),
                metadata={c: np.asarray(self._interactions[c]) for c in other},
            )

        if copy:
            return res
        _save_data(self._adata, attr="uns", key=Key.uns.ligrec(cluster_key, key_added), data=res)
        return None

    def _trim_data(self) -> None:
        wanted = set(self._interactions[SOURCE]) | set(self._interactions[TARGET])
        self._filtered = [p for p, g in enumerate(self._genes) if g in wanted]

    def _filter_interactions_by_genes(self) -> None:
        known = set(self._genes)
        self._take_rows([s in known and t in known
                         for s, t in zip(self._interactions[SOURCE], self._interactions[TARGET])])
        if not len(self._interactions[SOURCE]):
            raise ValueError("After filtering by genes, no interactions remain.")

    def _resolve_complex_min(self, annotation: str | None, cache: dict[str, str | None]) -> str | None:
        """CellPhoneDB 'min' policy: a complex contributes its least-expressed
        member (by mean over cells, summed in the column's dtype as pandas
        does, the first of equal means); members absent from the data are
        ignored, and a complex with no present member resolves to ``None``."""
        if annotation is None:
            return None
        if "_" not in annotation:
            return annotation
        if annotation not in cache:
            position = {}
            for p, g in enumerate(self._genes):
                position.setdefault(g, p)
            members = [g for g in annotation.split("_") if g in position]
            if len(members) > 1:
                block = self._columns([position[g] for g in members])
                count = block.dtype.type(block.shape[0])
                means = [np.ascontiguousarray(block[:, k]).sum(dtype=block.dtype) / count
                         for k in range(len(members))]
                cache[annotation] = members[int(np.argmin(means))]
            else:
                cache[annotation] = members[0] if members else None
        return cache[annotation]

    def _filter_interactions_complexes(self, complex_policy: ComplexPolicy) -> None:
        """Resolve ``A_B_C`` complex annotations: ``'min'`` picks the member
        with minimum mean expression, ``'all'`` expands every source-member x
        target-member combination (metadata columns first, repeated, then
        source and target)."""
        if complex_policy == ComplexPolicy.MIN:
            resolved: dict[str, str | None] = {}
            for col in (SOURCE, TARGET):
                self._interactions[col] = [self._resolve_complex_min(v, resolved) for v in self._interactions[col]]
        elif complex_policy == ComplexPolicy.ALL:
            # the JAX package joins each column's member lists back on the
            # row labels, then explodes them: a row takes the members of
            # every row with its label (itself alone when labels are unique)
            other = [c for c in self._interactions if c not in (SOURCE, TARGET)]
            rows_of: dict[Any, list[int]] = {}
            for r, label in enumerate(self._row_labels):
                rows_of.setdefault(label, []).append(r)
            members = {c: [str(v).split("_") for v in self._interactions[c]] for c in (SOURCE, TARGET)}
            table: dict[str, list[Any]] = {c: [] for c in (*other, SOURCE, TARGET)}
            labels = []
            for r, label in enumerate(self._row_labels):
                for r_s in rows_of[label]:
                    for sm in members[SOURCE][r_s]:
                        for r_t in rows_of[label]:
                            for tm in members[TARGET][r_t]:
                                for c in other:
                                    table[c].append(self._interactions[c][r])
                                table[SOURCE].append(sm)
                                table[TARGET].append(tm)
                                labels.append(label)
            self._interactions, self._row_labels = table, labels
        else:
            raise NotImplementedError(f"Complex policy {complex_policy!r} is not implemented.")

    @property
    def interactions(self) -> dict[str, list[Any]] | None:
        """The interactions: column name -> values in row order."""
        return self._interactions

    def __repr__(self) -> str:
        n = len(self._interactions[SOURCE]) if self._interactions is not None else None
        return f"<{self.__class__.__name__}[n_interaction={n}]>"

    __str__ = __repr__


def _table_of_mapping(mapping: Mapping[str, Any]) -> dict[str, list[Any]]:
    """``pd.DataFrame(mapping)`` of column sequences: columns in key order."""
    table = {}
    for k, v in mapping.items():
        if isinstance(v, str) or not isinstance(v, Iterable):
            raise ValueError("If using all scalar values, you must pass an index")
        table[k] = list(v)
    if len({len(v) for v in table.values()}) > 1:
        raise ValueError("All arrays must be of the same length")
    return table


class PermutationTest(PermutationTestABC):
    """Permutation test with optional omnipath interaction fetching."""

    def prepare(
        self,
        interactions: Any = None,
        complex_policy: Literal["min", "all"] = ComplexPolicy.MIN.v,
        interactions_params: Mapping[str, Any] = MappingProxyType({}),
        transmitter_params: Mapping[str, Any] = MappingProxyType({"categories": "ligand"}),
        receiver_params: Mapping[str, Any] = MappingProxyType({"categories": "receptor"}),
        **_: Any,
    ) -> PermutationTest:
        if interactions is None:
            try:
                from omnipath.interactions import import_intercell_network
            except ImportError as e:
                raise ImportError(
                    "`interactions=None` requires the optional `omnipath` package to fetch the "
                    "intercell network. Install omnipath or pass interactions explicitly "
                    "(a DataFrame with 'source'/'target' columns)."
                ) from e
            interactions = import_intercell_network(
                interactions_params=interactions_params,
                transmitter_params=transmitter_params,
                receiver_params=receiver_params,
            )
            if SOURCE in interactions.columns:
                interactions.pop(SOURCE)
            if TARGET in interactions.columns:
                interactions.pop(TARGET)
            interactions.rename(
                columns={"genesymbol_intercell_source": SOURCE, "genesymbol_intercell_target": TARGET},
                inplace=True,
            )
            interactions[SOURCE] = interactions[SOURCE].str.replace("^COMPLEX:", "", regex=True)
            interactions[TARGET] = interactions[TARGET].str.replace("^COMPLEX:", "", regex=True)

        super().prepare(interactions, complex_policy=complex_policy)
        return self


def ligrec(
    adata: Any,
    cluster_key: str,
    interactions: Any = None,
    complex_policy: Literal["min", "all"] = ComplexPolicy.MIN.v,
    threshold: float = 0.01,
    corr_method: str | None = None,
    corr_axis: Literal["interactions", "clusters"] = CorrAxis.CLUSTERS.v,
    use_raw: bool = True,
    copy: bool = False,
    key_added: str | None = None,
    gene_symbols: str | None = None,
    *,
    table_key: str | None = None,
    **kwargs: Any,
) -> LigrecResult | None:
    """Receptor-ligand permutation test (CellPhoneDB). Stores a
    :class:`LigrecResult` in ``uns['{cluster_key}_ligrec']`` (or
    ``uns[key_added]``), or returns it with ``copy=True``."""
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    with _genesymbols(adata, key=gene_symbols, use_raw=use_raw):
        return (
            PermutationTest(adata, use_raw=use_raw)
            .prepare(interactions, complex_policy=complex_policy, **kwargs)
            .test(
                cluster_key=cluster_key,
                threshold=threshold,
                corr_method=corr_method,
                corr_axis=corr_axis,
                copy=copy,
                key_added=key_added,
                **kwargs,
            )
        )


def _ship(x: NDArrayA, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host matrix to the device in its own container, widened there to
    ``dtype``; uint16 travels as its int16 bit pattern."""
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:
        t = torch.from_numpy(x.view(np.int16)).to(device).to(torch.int32) & 0xFFFF
    else:
        t = torch.from_numpy(x).to(device)
    return t.to(dtype)


def _perm_counts(x_dev: torch.Tensor, clustering: NDArrayA, keys: NDArrayA, counts: NDArrayA, rec: NDArrayA,
                 lig: NDArrayA, c1: NDArrayA, c2: NDArrayA, m_sum: NDArrayA, n_cls: int) -> NDArrayA:
    """Exceedance counts ``(I, J)`` over the permutations of ``keys``, drawn
    and counted a chunk of keys at a time (at 1M cells and 1000 permutations
    the shuffled labels alone would take 1 GB). K10 writes each chunk's
    shuffled labels (uint8 up to 255 clusters) straight into the buffer K9
    reads; K9's route, and its uint8 copy of X, are found once a call."""
    device = x_dev.device
    n = len(clustering)
    narrow = n_cls <= 255
    labels = torch.from_numpy(np.asarray(clustering, dtype=np.uint8 if narrow else np.int32)).to(device)
    args = [torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device) for a in (rec, lig, c1, c2)]
    counts_t = torch.from_numpy(np.asarray(counts)).to(device=device, dtype=x_dev.dtype)
    m_sum_t = torch.from_numpy(np.ascontiguousarray(m_sum)).to(device=device, dtype=x_dev.dtype)
    total = torch.zeros((len(rec), len(c1)), dtype=torch.int64, device=device)
    with record_function("ligrec.route"):
        route = _k9_route(x_dev, n_cls)
        xt = counts_operand(x_dev) if route == "integral" and device.type == "cuda" else None
    step = _keys_per_chunk(n, device)
    rows = min(step, keys.shape[0])
    buf = (torch.full((rows, label_stride(n)), 255, dtype=torch.uint8, device=device) if narrow
           else torch.empty((rows, n), dtype=torch.int32, device=device))
    for c0 in range(0, keys.shape[0], step):
        kc = keys[c0 : c0 + step]
        with record_function("ligrec.permutations"):
            shuffled = permutation_batch(kc, n, device, payload=labels, out=buf[: len(kc)])
        with record_function("ligrec.counts"):
            total += ligrec_perm_counts(x_dev, shuffled, counts_t, *args, m_sum_t, n_cls, route=route, xt=xt)
    return to_host(total)


def _analysis(
    data: NDArrayA | None,  # (n_cells, n_genes), None when x_dev is given
    clustering: NDArrayA,  # (n_cells,) int32 codes
    n_cls: int,
    interactions: NDArrayA,  # (I, 2) [receptor, ligand] gene columns
    interaction_clusters: NDArrayA,  # (J, 2) cluster pairs
    threshold: float,
    n_perms: int,
    seed: int | None,
    x_dev: torch.Tensor | None = None,  # the float32 gene block of the device expression handle
) -> tuple[NDArrayA, NDArrayA]:
    """Observed means and mask, then the permutations' exceedance counts.

    The observed means come from the JAX package's two routes: for the
    device handle, one-hot products on the device (float32 sums, float32
    division); otherwise the same numpy products on the host, in float64 up
    to :data:`_EXACT_SIZE_LIMIT` elements and float32 above, with the matrix
    shipped in its narrowest lossless container and widened on the device.
    """
    device = get_device()
    with record_function("ligrec.means"):
        if x_dev is not None:
            labels_dev = torch.from_numpy(np.asarray(clustering, dtype=np.int64)).to(device)
            counts = np.bincount(clustering, minlength=n_cls).astype(np.float64)
            mean = to_host(cluster_means(x_dev, labels_dev, n_cls)).T.astype(np.float64)
            frac = to_host(cluster_means((x_dev > 0).to(x_dev.dtype), labels_dev, n_cls)).T.astype(np.float64)
            mask = frac >= threshold
        else:
            host_t = np.float64 if data.size <= _EXACT_SIZE_LIMIT else np.float32
            data_h = data if data.dtype == host_t else data.astype(host_t)
            # the matrix in its narrowest lossless container (raw counts as
            # u8/u16), widened to host_t on the device
            x_dev = _ship(_narrowest_container(data_h), torch.float64 if host_t is np.float64 else torch.float32, device)

            onehot = np.zeros((len(clustering), n_cls), dtype=host_t)
            onehot[np.arange(len(clustering)), clustering] = 1.0
            counts = onehot.sum(axis=0)
            safe_counts = np.where(counts == 0, 1.0, counts).astype(host_t)
            mean = (data_h.T @ onehot) / safe_counts  # (G, C)
            frac = ((data_h > 0).astype(host_t).T @ onehot) / safe_counts
            mask = frac >= threshold  # (G, C)

        rec, lig = interactions[:, 0], interactions[:, 1]
        c1, c2 = interaction_clusters[:, 0], interaction_clusters[:, 1]
        m1 = mean[rec[:, None], c1[None, :]]  # (I, J)
        m2 = mean[lig[:, None], c2[None, :]]
        both_positive = (m1 > 0) & (m2 > 0)
        mask_ok = mask[rec[:, None], c1[None, :]] & mask[lig[:, None], c2[None, :]]
        x_t = np.float32 if x_dev.dtype == torch.float32 else np.float64
        m_sum = (m1 + m2).astype(x_t)

    keys = spawn_keys(seed, n_perms)
    exceed = _perm_counts(x_dev, clustering, keys, np.asarray(counts, dtype=x_t), rec, lig, c1, c2, m_sum, n_cls)

    with record_function("ligrec.pvalues"):
        pvalues = exceed.astype(np.float64) / n_perms
        pvalues[~(both_positive & mask_ok)] = np.nan
        res_means = np.where(both_positive, (m1 + m2) / 2.0, 0.0)
    return res_means, pvalues
