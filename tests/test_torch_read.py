"""squidpy_torch.read against squidpy_tpu.read on the same files, written
into ``tmp_path``: 10x h5 (v3 and the legacy v2 layout), mtx (v3 gzipped, v2
plain), a SpaceRanger folder (both position-table vintages), Vizgen and
Nanostring CSVs with images. ``X``, ``obs``, ``var``, ``obsm`` and ``uns``
must be equal (frames exactly, arrays bitwise).
"""

from __future__ import annotations

import gzip
import json

import numpy as np
import pandas as pd
import pytest
from scipy import sparse as sp

import squidpy_torch as sqt
import squidpy_tpu as sq


def assert_same(got, want, path: str = "") -> None:
    """Equal values, recursively: frames exactly, arrays and sparse matrices
    bitwise with their dtypes, mappings key for key."""
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True, obj=path)
    elif isinstance(want, pd.Index):
        pd.testing.assert_index_equal(got, want, exact=True, obj=path)
    elif sp.issparse(want):
        assert sp.issparse(got) and got.format == want.format and got.dtype == want.dtype, path
        assert got.shape == want.shape and (got != want).nnz == 0, path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def assert_same_adata(got, want) -> None:
    assert type(got).__module__.startswith("squidpy_torch") and got.shape == want.shape
    assert_same(got.X, want.X, "X")
    for attr in ("obs", "var", "obsm", "uns", "obsp", "layers"):
        assert_same(getattr(got, attr), getattr(want, attr), attr)


def _counts(n_cells: int, n_genes: int, seed: int) -> tuple[sp.csc_matrix, list[str], list[str], list[str]]:
    """(genes x cells) CSC counts as CellRanger stores them, barcodes, gene
    ids and names (two names repeated: made unique by the readers)."""
    rng = np.random.default_rng(seed)
    m = sp.random(n_genes, n_cells, density=0.2, random_state=seed, format="csc",
                  data_rvs=lambda k: rng.integers(1, 30, k)).astype(np.int32)
    barcodes = [f"{''.join(rng.choice(list('ACGT'), 12))}-1" for _ in range(n_cells)]
    ids = [f"ENSG{i:06d}" for i in range(n_genes)]
    names = [f"Gene{i}" for i in range(n_genes)]
    names[3] = names[5] = "Dup"
    return m, barcodes, ids, names


def _write_10x_h5(path, version: int, seed: int = 0, library_id: str = "lib_A") -> list[str]:
    import h5py

    m, barcodes, ids, names = _counts(40, 25, seed)
    with h5py.File(path, "w") as f:
        grp = f.create_group("matrix" if version == 3 else "GRCh38")
        grp.create_dataset("data", data=m.data)
        grp.create_dataset("indices", data=m.indices.astype(np.int64))
        grp.create_dataset("indptr", data=m.indptr.astype(np.int64))
        grp.create_dataset("shape", data=np.asarray(m.shape, np.int32))
        grp.create_dataset("barcodes", data=np.asarray(barcodes, dtype="S"))
        if version == 3:
            feats = grp.create_group("features")
            feats.create_dataset("id", data=np.asarray(ids, dtype="S"))
            feats.create_dataset("name", data=np.asarray(names, dtype="S"))
            feats.create_dataset("feature_type", data=np.asarray(["Gene Expression"] * len(ids), dtype="S"))
            feats.create_dataset("genome", data=np.asarray(["GRCh38"] * len(ids), dtype="S"))
            f.attrs["library_ids"] = np.asarray([library_id], dtype="S")
            f.attrs["chemistry_description"] = np.asarray(["Spatial 3' v1"], dtype="S")
            f.attrs["software_version"] = "spaceranger-2.0.0"
        else:
            grp.create_dataset("genes", data=np.asarray(ids, dtype="S"))
            grp.create_dataset("gene_names", data=np.asarray(names, dtype="S"))
    return barcodes


@pytest.mark.parametrize("version", [3, 2])
def test_read_10x_h5_matches_jax(tmp_path, version):
    _write_10x_h5(tmp_path / "m.h5", version)
    got, want = sqt.read.read_10x_h5(tmp_path / "m.h5"), sq.read.read_10x_h5(tmp_path / "m.h5")
    assert_same_adata(got, want)
    assert "Dup-1" in list(got.var_names)


@pytest.mark.parametrize("version", [3, 2])
def test_read_10x_mtx_matches_jax(tmp_path, version):
    from scipy.io import mmwrite

    m, barcodes, ids, names = _counts(30, 20, seed=version)
    gz = version == 3
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    mmwrite(str(tmp_path / "matrix.mtx"), m)
    if gz:
        with open(tmp_path / "matrix.mtx", "rb") as src, gzip.open(tmp_path / "matrix.mtx.gz", "wb") as dst:
            dst.write(src.read())
        (tmp_path / "matrix.mtx").unlink()
    with opener(tmp_path / f"barcodes.tsv{suffix}", "wt") as fh:
        fh.write("\n".join(barcodes) + "\n")
    feats = [f"{i}\t{n}\tGene Expression" if gz else f"{i}\t{n}" for i, n in zip(ids, names)]
    with opener(tmp_path / (f"features.tsv{suffix}" if gz else "genes.tsv"), "wt") as fh:
        fh.write("\n".join(feats) + "\n")
    assert_same_adata(sqt.read.read_10x_mtx(tmp_path), sq.read.read_10x_mtx(tmp_path))


def _space_ranger(tmp_path, headered: bool):
    from PIL import Image

    root = tmp_path / "visium"
    (root / "spatial").mkdir(parents=True)
    barcodes = _write_10x_h5(root / "filtered_feature_bc_matrix.h5", 3)
    rng = np.random.default_rng(1)
    for res, side in (("hires", 60), ("lowres", 30)):
        Image.fromarray(rng.integers(0, 255, (side, side, 3), dtype=np.uint8)).save(
            root / "spatial" / f"tissue_{res}_image.png")
    (root / "spatial" / "scalefactors_json.json").write_text(json.dumps(
        {"spot_diameter_fullres": 89.4, "tissue_hires_scalef": 0.15, "tissue_lowres_scalef": 0.045,
         "fiducial_diameter_fullres": 144.4}))
    order = rng.permutation(len(barcodes))  # the table's rows in another order than the matrix's
    rows = [f"{barcodes[i]},{int(i % 7 != 0)},{i // 8},{i % 8},{1000 + 138 * (i // 8)},{900 + 160 * (i % 8)}"
            for i in order]
    header = "barcode,in_tissue,array_row,array_col,pxl_row_in_fullres,pxl_col_in_fullres\n"
    name = "tissue_positions.csv" if headered else "tissue_positions_list.csv"
    (root / "spatial" / name).write_text((header if headered else "") + "\n".join(rows))
    return root


@pytest.mark.parametrize("headered", [True, False], ids=["v2 positions", "v1 positions"])
@pytest.mark.parametrize("load_images", [True, False])
def test_visium_matches_jax(tmp_path, headered, load_images):
    root = _space_ranger(tmp_path, headered)
    kw = {"load_images": load_images, "source_image_path": root / "missing.tif"}
    got, want = sqt.read.visium(root, **kw), sq.read.visium(root, **kw)
    assert_same_adata(got, want)
    if load_images:
        assert got.uns["spatial"]["lib_A"]["images"]["hires"].shape == (60, 60, 3)
        assert got.obsm["spatial"].shape == (40, 2)
    got = sqt.read.visium(root, library_id="mine", counts_file="filtered_feature_bc_matrix.h5")
    assert_same_adata(got, sq.read.visium(root, library_id="mine"))


def test_vizgen_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    genes = ["GeneA", "GeneB", "Blank-1", "GeneC", "Blank-2"]
    cells = [str(i) for i in range(12)]
    counts = pd.DataFrame(rng.integers(0, 9, (12, 5)), index=cells, columns=genes)
    counts.index.name = "cell"
    counts.to_csv(tmp_path / "cell_by_gene.csv")
    meta = pd.DataFrame({"fov": rng.integers(0, 3, 12), "volume": rng.random(12),
                         "center_x": rng.random(12) * 100, "center_y": rng.random(12) * 100},
                        index=cells[::-1])  # another order than the counts'
    meta.index.name = "EntityID"
    meta.to_csv(tmp_path / "cell_metadata.csv")
    (tmp_path / "images").mkdir()
    np.savetxt(tmp_path / "images" / "micron_to_mosaic_pixel_transform.csv",
               np.array([[9.2, 0.0, 12.5], [0.0, 9.2, -3.25], [0.0, 0.0, 1.0]]), delimiter=" ")
    for transformation_file in ("micron_to_mosaic_pixel_transform.csv", None):
        kw = {"counts_file": "cell_by_gene.csv", "meta_file": "cell_metadata.csv",
              "transformation_file": transformation_file, "library_id": "section"}
        assert_same_adata(sqt.read.vizgen(tmp_path, **kw), sq.read.vizgen(tmp_path, **kw))


def test_nanostring_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    n = 12
    fovs = [1] * 6 + [2] * 4 + [3] * 2
    ids = list(range(1, 7)) + list(range(1, 5)) + [1, 2]
    counts = pd.DataFrame(rng.integers(0, 5, (n, 4)), columns=["G1", "G2", "NegPrb1", "G3"])
    counts.insert(0, "fov", fovs)
    counts.insert(0, "cell_ID", ids)
    counts.iloc[:-1].to_csv(tmp_path / "exprMat_file.csv", index=False)  # a cell with metadata only
    meta = pd.DataFrame({"cell_ID": ids, "fov": fovs, "CenterX_local_px": rng.integers(0, 50, n),
                         "CenterY_local_px": rng.integers(0, 50, n), "CenterX_global_px": rng.integers(0, 500, n),
                         "CenterY_global_px": rng.integers(0, 500, n), "Area": rng.random(n)})
    meta.to_csv(tmp_path / "metadata_file.csv", index=False)
    for sub in ("CellComposite", "CellLabels"):
        (tmp_path / sub).mkdir()
        for f in (1, 2, 7):  # FOV 7 has no cells: skipped with a warning
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                tmp_path / sub / f"Img_F{f:03d}{'_overlay' if f == 2 else ''}.png")
        (tmp_path / sub / "notes.txt").write_text("not an image")
    pd.DataFrame({"fov": [1, 2, 3, 9], "x_global_px": [0.0, 500.5, 1000.0, 5.0],
                  "y_global_px": [0.0, 0.0, 250.25, 1.0]}).to_csv(tmp_path / "fov_positions.csv", index=False)
    kw = {"counts_file": "exprMat_file.csv", "meta_file": "metadata_file.csv", "fov_file": "fov_positions.csv"}
    got, want = sqt.read.nanostring(tmp_path, **kw), sq.read.nanostring(tmp_path, **kw)
    assert_same_adata(got, want)
    assert got.shape == (11, 4) and "hires" in got.uns["spatial"]["2"]["images"]


def test_read_counts_errors(tmp_path):
    from squidpy_torch.read._utils import _read_counts

    (tmp_path / "c.csv").write_text("cell,G1\n0,1\n")
    with pytest.raises(ValueError, match="library id"):
        _read_counts(tmp_path, "c.csv")
    with pytest.raises(NotImplementedError, match="Unsupported counts file"):
        _read_counts(tmp_path, "c.loom", library_id="x")
    got, lid = _read_counts(tmp_path, "c.csv", library_id="x")
    want, _ = sq.read._utils._read_counts(tmp_path, "c.csv", library_id="x")
    assert lid == "x"
    assert_same_adata(got, want)


@pytest.mark.parametrize("name", ["visium", "vizgen", "nanostring", "read_10x_h5", "read_10x_mtx"])
def test_reader_signatures_match_jax(name):
    import inspect

    got = inspect.signature(getattr(sqt.read, name)).parameters
    want = inspect.signature(getattr(sq.read, name)).parameters
    assert [(p.name, p.kind, p.default) for p in got.values()] == [(p.name, p.kind, p.default) for p in want.values()]
