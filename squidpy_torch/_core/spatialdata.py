"""Minimal SpatialData container (copy of ``squidpy_tpu/_core/spatialdata.py``).

A lightweight stand-in for ``spatialdata.SpatialData``: four element trees,
``images``, ``labels``, ``shapes`` and ``tables``. Every function of the
port that takes a container resolves its table through ``tables``
(:func:`squidpy_torch.gr._utils.extract_adata_if_sdata`).

Persistence uses the in-repo zarr v2 store (:mod:`squidpy_torch.im._zarr`):
images/labels as zarr arrays (multiscale levels as nested groups), shapes as
JSON-encoded records, tables as anndata-format h5ad files inside the store
directory. pandas (shapes) and h5py (tables) are imported only for the
trees that need them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Union

import numpy as np

from squidpy_torch.utils._utils import optional_import

__all__ = ["SpatialData"]

Pathlike_t = Union[str, Path]


class SpatialData:
    """Container of spatial elements: ``images``, ``labels``, ``shapes``, ``tables``."""

    def __init__(
        self,
        images: Mapping[str, Any] | None = None,
        labels: Mapping[str, Any] | None = None,
        shapes: Mapping[str, Any] | None = None,
        tables: Mapping[str, Any] | None = None,
    ) -> None:
        self.images: dict[str, Any] = dict(images or {})
        self.labels: dict[str, Any] = dict(labels or {})
        self.shapes: dict[str, Any] = dict(shapes or {})
        self.tables: dict[str, Any] = dict(tables or {})

    def __repr__(self) -> str:
        parts = [
            f"{tree}: {sorted(getattr(self, tree))}"
            for tree in ("images", "labels", "shapes", "tables")
            if getattr(self, tree)
        ]
        return f"SpatialData({'; '.join(parts) or 'empty'})"

    # -- persistence -------------------------------------------------------
    def write(self, path: Pathlike_t) -> None:
        """Write the container as a zarr v2 group directory.

        Layout: ``images/<k>`` and ``labels/<k>`` as zarr arrays (a dict of
        scales becomes a subgroup with one array per level), ``shapes/<k>``
        as JSON records, ``tables/<k>.h5ad`` in anndata format.
        """
        from squidpy_torch.im._zarr import _ZARR_FORMAT, write_array

        root = Path(path)
        if root.exists():
            # overwrite semantics: a re-write reflects the CURRENT container —
            # leftover element directories from a previous write would
            # otherwise resurrect deleted/renamed elements on read()
            import shutil

            if not (root / ".zgroup").exists() and any(root.iterdir()):
                raise ValueError(
                    f"`{root}` exists and is not a zarr group written by SpatialData.write; "
                    "refusing to overwrite."
                )
            shutil.rmtree(root)
        root.mkdir(parents=True, exist_ok=True)
        (root / ".zgroup").write_text(json.dumps({"zarr_format": _ZARR_FORMAT}))
        for tree in ("images", "labels"):
            tdir = root / tree
            tdir.mkdir(exist_ok=True)
            (tdir / ".zgroup").write_text(json.dumps({"zarr_format": _ZARR_FORMAT}))
            for name, node in getattr(self, tree).items():
                if hasattr(node, "keys") and not hasattr(node, "shape"):  # multiscale
                    gdir = tdir / name
                    gdir.mkdir(exist_ok=True)
                    (gdir / ".zgroup").write_text(json.dumps({"zarr_format": _ZARR_FORMAT}))
                    for level, arr in node.items():
                        write_array(gdir, str(level), np.asarray(arr))
                else:
                    write_array(tdir, name, np.asarray(node))
        if self.shapes:
            sdir = root / "shapes"
            sdir.mkdir(exist_ok=True)
            pd = optional_import("pandas", "SpatialData shapes")
            for name, table in self.shapes.items():
                pd.DataFrame(table).to_json(sdir / f"{name}.json", orient="table")
        if self.tables:
            adir = root / "tables"
            adir.mkdir(exist_ok=True)
            from squidpy_torch._core.io_h5ad import write_h5ad

            for name, adata in self.tables.items():
                write_h5ad(str(adir / f"{name}.h5ad"), adata)

    @classmethod
    def read(cls, path: Pathlike_t) -> "SpatialData":
        from squidpy_torch.im._zarr import read_array

        root = Path(path)
        out = cls()
        for tree in ("images", "labels"):
            tdir = root / tree
            if not tdir.is_dir():
                continue
            for child in sorted(tdir.iterdir()):
                if not child.is_dir():
                    continue
                if (child / ".zarray").exists():
                    getattr(out, tree)[child.name], _ = read_array(child)
                elif (child / ".zgroup").exists():  # multiscale subgroup
                    levels = {
                        lv.name: read_array(lv)[0]
                        for lv in sorted(child.iterdir())
                        if lv.is_dir() and (lv / ".zarray").exists()
                    }
                    getattr(out, tree)[child.name] = levels
        sdir = root / "shapes"
        if sdir.is_dir():
            pd = optional_import("pandas", "SpatialData shapes")
            for f in sorted(sdir.glob("*.json")):
                out.shapes[f.stem] = pd.read_json(f, orient="table")
        adir = root / "tables"
        if adir.is_dir():
            from squidpy_torch._core.io_h5ad import read_h5ad

            for f in sorted(adir.glob("*.h5ad")):
                out.tables[f.stem] = read_h5ad(str(f))
        return out
