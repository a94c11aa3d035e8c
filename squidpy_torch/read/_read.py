"""Spatial dataset readers: Visium (SpaceRanger), Vizgen (MERSCOPE),
Nanostring (CosMx).

Implemented from the vendors' on-disk layouts:

* SpaceRanger ``outs/`` — ``filtered_feature_bc_matrix.h5`` +
  ``spatial/{tissue_positions[_list].csv, scalefactors_json.json,
  tissue_{hires,lowres}_image.png}``.  v1 ships a headerless
  ``tissue_positions_list.csv``; v2/v3 a headered ``tissue_positions.csv``
  (first header token is ``barcode``).  Position rows are
  ``barcode, in_tissue, array_row, array_col, pxl_row_in_fullres,
  pxl_col_in_fullres``.
* MERSCOPE exports — ``cell_by_gene.csv`` (cells x genes incl. ``Blank-*``
  control probes), ``cell_metadata.csv`` with micron centroids
  ``center_x``/``center_y``, and an optional 3x3 micron->mosaic-pixel affine
  under ``images/``.
* CosMx flat files — ``*exprMat_file.csv`` / ``*metadata_file.csv`` keyed by
  ``(fov, cell_ID)``; per-FOV composite/label images in ``CellComposite/`` and
  ``CellLabels/`` named ``*_F<number>.<ext>``; optional FOV position table.

Copy of ``squidpy_tpu/read/_read.py``; pandas is imported by the readers, never
when this module is imported.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import TYPE_CHECKING, Any, Iterable

import numpy as np
from scipy.sparse import csr_matrix

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.anndata import AnnData
from squidpy_torch.read._utils import PathLike, _load_image, _pd, _read_counts

if TYPE_CHECKING:
    import pandas as pd

__all__ = ["visium", "vizgen", "nanostring"]

logger = logging.getLogger(__name__)


def _attach_centroids(
    adata: AnnData,
    table: pd.DataFrame,
    *,
    x: str,
    y: str,
    obsm_key: str = Key.obsm.spatial,
) -> None:
    """Align ``table`` onto ``adata.obs_names``, store the ``(x, y)`` columns
    as ``obsm[obsm_key]`` and fold every other column into ``obs``."""
    aligned = table.reindex(adata.obs_names)
    adata.obsm[obsm_key] = np.column_stack([aligned[x].to_numpy(), aligned[y].to_numpy()])
    extra = aligned.drop(columns=[x, y])
    for col in extra.columns:
        adata.obs[col] = extra[col].to_numpy()


# SpaceRanger tissue-position row schema (both v1 and v2/v3 variants).
_POSITION_FIELDS = (
    "in_tissue",
    "array_row",
    "array_col",
    "pxl_row_in_fullres",
    "pxl_col_in_fullres",
)


def _spot_positions(spatial_dir: Path) -> pd.DataFrame:
    """Parse the SpaceRanger tissue-position table, whichever vintage.

    Returns a frame indexed by barcode with columns ``_POSITION_FIELDS``.
    Header presence is sniffed from the first token rather than the filename,
    because some public datasets rename one vintage's file to the other's.
    """
    pd = _pd()
    candidates = [spatial_dir / "tissue_positions.csv", spatial_dir / "tissue_positions_list.csv"]
    for pos_path in candidates:
        if pos_path.exists():
            break
    else:
        raise FileNotFoundError(f"No tissue positions file found under `{spatial_dir}`.")

    with open(pos_path) as fh:
        first_token = fh.readline().split(",", 1)[0].strip().lower()
    table = pd.read_csv(
        pos_path,
        header=0 if first_token == "barcode" else None,
        index_col=0,
        names=["barcode", *_POSITION_FIELDS],
    )
    table.index = table.index.astype(str)
    return table


def visium(
    path: PathLike,
    *,
    counts_file: str = "filtered_feature_bc_matrix.h5",
    library_id: str | None = None,
    load_images: bool = True,
    source_image_path: PathLike | None = None,
    **kwargs: Any,
) -> AnnData:
    """Read a *10x Genomics* Visium (Space Ranger) dataset.

    Loads counts, hires/lowres tissue images, scale factors and spot
    coordinates; ``obsm['spatial']`` is ``(x, y)`` in full-resolution pixels
    (SpaceRanger's ``pxl_col_in_fullres, pxl_row_in_fullres``).
    """
    root = Path(path)
    spatial_dir = root / Key.uns.spatial
    adata, library_id = _read_counts(root, counts_file=counts_file, library_id=library_id, **kwargs)

    if not load_images:
        return adata

    lib_entry = adata.uns[Key.uns.spatial][library_id]
    lib_entry[Key.uns.image_key] = {
        res: _load_image(spatial_dir / f"tissue_{res}_image.png") for res in ("hires", "lowres")
    }
    lib_entry["scalefactors"] = json.loads((spatial_dir / "scalefactors_json.json").read_text())

    positions = _spot_positions(spatial_dir)
    _attach_centroids(adata, positions, x="pxl_col_in_fullres", y="pxl_row_in_fullres")

    if source_image_path is not None:
        src = Path(source_image_path).absolute()
        if not src.exists():
            logger.warning(f"Path to the high-resolution tissue image `{src}` does not exist")
        lib_entry["metadata"]["source_image_path"] = str(src)

    return adata


def vizgen(
    path: str | Path,
    *,
    counts_file: str,
    meta_file: str,
    transformation_file: str | None = None,
    library_id: str = "library",
    **kwargs: Any,
) -> AnnData:
    """Read a *Vizgen* (MERSCOPE) dataset.

    ``Blank-*`` control probes are split out of ``X`` into
    ``obsm['blank_genes']``; ``obsm['spatial']`` holds the micron centroids;
    the optional micron->mosaic affine lands under
    ``uns['spatial'][library_id]['scalefactors']['transformation_matrix']``.
    """
    pd = _pd()
    root = Path(path)
    adata, library_id = _read_counts(
        path=root, counts_file=counts_file, library_id=library_id, delimiter=",", first_column_names=True, **kwargs
    )

    is_blank = adata.var_names.str.contains("Blank")
    adata.obsm["blank_genes"] = pd.DataFrame(
        np.asarray(adata[:, is_blank].X), columns=adata.var_names[is_blank], index=adata.obs_names
    )
    adata = adata[:, ~is_blank].copy()
    adata.X = csr_matrix(adata.X)

    meta = pd.read_csv(root / meta_file, index_col=0)
    meta.index = meta.index.astype(str)
    _attach_centroids(adata, meta, x="center_x", y="center_y")

    if transformation_file is not None:
        affine = np.loadtxt(root / "images" / transformation_file)
        tm = pd.DataFrame(affine)
        tm.columns = tm.columns.astype(str)
        adata.uns[Key.uns.spatial][library_id]["scalefactors"] = {"transformation_matrix": tm}

    return adata


# the F-number usually sits right before the extension (CellComposite_F001.jpg)
# but vendor/exported names may append suffixes (…_F001_overlay.jpg) — accept
# anything after the number as long as the extension is an image type
_FOV_SUFFIX = re.compile(r"_F0*(\d+)(?:[_.-][^.]*)?\.(jpg|jpeg|png|tif|tiff)$", re.IGNORECASE)
_IMG_DIRS = {"CellComposite": "hires", "CellLabels": "segmentation"}


def _cosmx_obs_names(cell_ids: Iterable[Any], fovs: Iterable[Any]) -> pd.Index:
    """CosMx cells are unique per (fov, cell_ID); join as ``<cell>_<fov>``."""
    pd = _pd()
    return pd.Index([f"{c}_{f}" for c, f in zip(cell_ids, fovs)])


def nanostring(
    path: str | Path,
    *,
    counts_file: str,
    meta_file: str,
    fov_file: str | None = None,
) -> AnnData:
    """Read a *Nanostring* (CosMx) dataset.

    Cells are keyed ``<cell_ID>_<fov>``; ``obsm['spatial']`` holds the
    FOV-local pixel centroids and ``obsm['spatial_fov']`` the global ones.
    Composite/label images and FOV metadata land per-FOV under
    ``uns['spatial'][fov]``.
    """
    pd = _pd()
    root = Path(path)

    expr = pd.read_csv(root / counts_file)
    expr.index = _cosmx_obs_names(expr.pop("cell_ID"), expr["fov"])
    expr = expr.drop(columns=["fov"])

    meta = pd.read_csv(root / meta_file)
    meta["cell_ID"] = meta["cell_ID"].astype(np.int64)
    meta.index = _cosmx_obs_names(meta["cell_ID"], meta["fov"])
    meta["fov"] = pd.Categorical(meta["fov"].astype(str))

    shared = meta.index.intersection(expr.index)
    adata = AnnData(
        csr_matrix(expr.loc[shared].to_numpy()),
        obs=meta.loc[shared],
        var=pd.DataFrame(index=expr.columns),
        uns={Key.uns.spatial: {}},
    )

    local_cols = ["CenterX_local_px", "CenterY_local_px"]
    adata.obsm[Key.obsm.spatial] = adata.obs[local_cols].to_numpy()
    adata.obsm["spatial_fov"] = adata.obs[["CenterX_global_px", "CenterY_global_px"]].to_numpy()
    adata.obs.drop(columns=local_cols, inplace=True)

    fov_entries = {
        fov: {"images": {}, "scalefactors": {"tissue_hires_scalef": 1, "spot_diameter_fullres": 1}}
        for fov in adata.obs["fov"].cat.categories
    }
    adata.uns[Key.uns.spatial] = fov_entries

    for subdir, kind in _IMG_DIRS.items():
        img_dir = root / subdir
        if not img_dir.is_dir():
            continue
        for img_path in sorted(img_dir.iterdir()):
            m = _FOV_SUFFIX.search(img_path.name)
            if m is None:
                continue
            fov = m.group(1)
            if fov not in fov_entries:
                logger.warning(f"FOV `{fov}` does not exist in {subdir} folder, skipping it.")
                continue
            fov_entries[fov]["images"][kind] = _load_image(img_path)

    if fov_file is not None:
        positions = pd.read_csv(root / fov_file, index_col="fov")
        for fov, row in positions.iterrows():
            entry = fov_entries.get(str(fov))
            if entry is None:
                logger.warning(f"FOV `{fov}` does not exist, skipping it.")
                continue
            entry["metadata"] = row.to_dict()

    return adata
