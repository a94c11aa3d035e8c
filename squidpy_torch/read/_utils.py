"""Reader utilities: 10x h5 / text counts, image loading (copy of
``squidpy_tpu/read/_utils.py``).

A direct h5py implementation of the CellRanger v2/v3 matrix format. pandas,
h5py and PIL are imported by the functions that need them; without them a
call raises ``ImportError`` naming the package.
"""

from __future__ import annotations

import gzip
import os
from pathlib import Path
from typing import Any, Union

import numpy as np
from scipy.sparse import csc_matrix, csr_matrix

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.anndata import AnnData
from squidpy_torch._device import NDArrayA
from squidpy_torch.utils._utils import optional_import

PathLike = Union[os.PathLike, str]

__all__ = ["PathLike", "_read_counts", "_load_image", "read_10x_h5", "read_10x_mtx"]


def _pd() -> Any:
    return optional_import("pandas", "squidpy_torch.read")


def _decode(x: Any) -> str:
    return x.decode("utf-8") if isinstance(x, bytes) else str(x)


def read_10x_h5(filename: PathLike, genome: str | None = None) -> AnnData:
    """Read a CellRanger-format HDF5 count matrix (v2 legacy or v3)."""
    pd, h5py = _pd(), optional_import("h5py", "squidpy_torch.read")

    with h5py.File(str(filename), "r") as f:
        keys = list(f.keys())
        if "matrix" in keys:  # v3
            grp = f["matrix"]
            M, N = grp["shape"][...]
            X = csc_matrix(
                (grp["data"][...], grp["indices"][...], grp["indptr"][...]),
                shape=(M, N),
            ).T.tocsr()
            barcodes = [_decode(b) for b in grp["barcodes"][...]]
            feats = grp["features"]
            var = pd.DataFrame(index=pd.Index([_decode(n) for n in feats["name"][...]]))
            var["gene_ids"] = [_decode(i) for i in feats["id"][...]]
            if "feature_type" in feats:
                var["feature_types"] = [_decode(t) for t in feats["feature_type"][...]]
            if "genome" in feats:
                var["genome"] = [_decode(g) for g in feats["genome"][...]]
        else:  # v2 legacy: one group per genome
            genome = genome or keys[0]
            grp = f[genome]
            M, N = grp["shape"][...]
            X = csc_matrix(
                (grp["data"][...], grp["indices"][...], grp["indptr"][...]),
                shape=(M, N),
            ).T.tocsr()
            barcodes = [_decode(b) for b in grp["barcodes"][...]]
            var = pd.DataFrame(index=pd.Index([_decode(n) for n in grp["gene_names"][...]]))
            var["gene_ids"] = [_decode(i) for i in grp["genes"][...]]

    adata = AnnData(X=X, obs=pd.DataFrame(index=pd.Index(barcodes)), var=var)
    adata.var_names_make_unique()
    return adata


def read_10x_mtx(path: PathLike, prefix: str = "", **kwargs: Any) -> AnnData:
    """Read a CellRanger mtx directory (``matrix.mtx[.gz]`` + barcodes + features)."""
    pd = _pd()
    from scipy.io import mmread

    path = Path(path)

    def find(*names: str) -> Path:
        for n in names:
            p = path / f"{prefix}{n}"
            if p.exists():
                return p
        raise FileNotFoundError(f"None of {names} found in `{path}`.")

    X = csr_matrix(mmread(str(find("matrix.mtx.gz", "matrix.mtx"))).T)
    bc_path = find("barcodes.tsv.gz", "barcodes.tsv")
    opener = gzip.open if bc_path.suffix == ".gz" else open
    with opener(bc_path, "rt") as fh:
        barcodes = [line.strip().split("\t")[0] for line in fh]
    feat_path = find("features.tsv.gz", "features.tsv", "genes.tsv.gz", "genes.tsv")
    opener = gzip.open if feat_path.suffix == ".gz" else open
    with opener(feat_path, "rt") as fh:
        rows = [line.strip().split("\t") for line in fh]
    var = pd.DataFrame(index=pd.Index([r[1] if len(r) > 1 else r[0] for r in rows]))
    var["gene_ids"] = [r[0] for r in rows]
    adata = AnnData(X=X, obs=pd.DataFrame(index=pd.Index(barcodes)), var=var)
    adata.var_names_make_unique()
    return adata


def _read_text_counts(path: PathLike, delimiter: str = ",", first_column_names: bool = True) -> AnnData:
    pd = _pd()
    df = pd.read_csv(str(path), sep=delimiter, header=0, index_col=0 if first_column_names else None)
    return AnnData(
        X=df.to_numpy(dtype=float),
        obs=pd.DataFrame(index=df.index.astype(str)),
        var=pd.DataFrame(index=df.columns.astype(str)),
    )


def _read_counts(
    path: str | Path,
    counts_file: str,
    library_id: str | None = None,
    **kwargs: Any,
) -> tuple[AnnData, str]:
    path = Path(path)
    if counts_file.endswith(".h5"):
        h5py = optional_import("h5py", "squidpy_torch.read")
        adata = read_10x_h5(path / counts_file, **{k: v for k, v in kwargs.items() if k == "genome"})
        with h5py.File(path / counts_file, mode="r") as f:
            attrs = dict(f.attrs)
            if library_id is None:
                try:
                    lid = attrs.pop("library_ids")[0]
                    library_id = _decode(lid)
                except (KeyError, ValueError):
                    raise KeyError(
                        "Unable to extract library id from attributes. Please specify one explicitly."
                    ) from None
            adata.uns[Key.uns.spatial] = {library_id: {"metadata": {}}}
            for key in ["chemistry_description", "software_version"]:
                if key not in attrs:
                    continue
                val = attrs[key]
                if isinstance(val, np.ndarray):
                    val = val[0]
                adata.uns[Key.uns.spatial][library_id]["metadata"][key] = _decode(val)
        return adata, library_id

    if library_id is None:
        raise ValueError("Please explicitly specify library id.")

    if counts_file.endswith((".csv", ".txt")):
        adata = _read_text_counts(
            path / counts_file,
            delimiter=kwargs.get("delimiter", ","),
            first_column_names=kwargs.get("first_column_names", True),
        )
    elif counts_file.endswith(".mtx.gz"):
        adata = read_10x_mtx(path, **kwargs)
    else:
        raise NotImplementedError(f"Unsupported counts file format: `{counts_file}`.")

    adata.uns[Key.uns.spatial] = {library_id: {"metadata": {}}}
    return adata, library_id


def _load_image(path: PathLike) -> NDArrayA:
    image = optional_import("PIL.Image", "squidpy_torch.read's images")
    return np.asarray(image.open(path))
