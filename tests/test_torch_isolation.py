"""squidpy_torch stands alone: no jax, squidpy_tpu, pandas, sklearn, h5py, PIL or matplotlib, and an
explicit device."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import squidpy_torch as sqt
from squidpy_torch import _device

torch.set_num_threads(1)

PKG = Path(sqt.__file__).resolve().parent

_SLICE = textwrap.dedent(
    """
    import sys
    for name in ("jax", "jaxlib", "pandas", "sklearn", "squidpy_tpu", "h5py", "PIL", "matplotlib"):
        sys.modules[name] = None  # any import of them raises ImportError
    import numpy as np, torch
    torch.set_num_threads(1)
    import squidpy_torch as sqt
    from types import SimpleNamespace

    class Cat:
        def __init__(self, codes, k):
            self.cat = SimpleNamespace(codes=codes, categories=[str(i) for i in range(k)])

    class StandIn:
        raw = None

        def __init__(self, coords, codes, k, x):
            self.obs, self.obsm, self.obsp, self.uns = {"cl": Cat(codes, k)}, {"spatial": coords}, {}, {}
            self.X, self.var_names = x, [f"g{i}" for i in range(x.shape[1])]
            self.n_obs, self.n_vars = x.shape

    sqt.set_device("cpu")
    rng = np.random.default_rng(0)
    n = 3000
    x = rng.poisson(2.0, (n, 6)).astype(np.float32)
    adata = StandIn(rng.uniform(0, 500, (n, 2)), rng.integers(0, 5, n).astype(np.int32), 5, x)
    sqt.gr.spatial_neighbors_knn(adata, n_neighs=6)
    sqt.gr.nhood_enrichment(adata, "cl", n_perms=20, seed=0)
    sqt.gr.co_occurrence(adata, "cl", interval=10)
    assert adata.obsp["spatial_connectivities"].nnz == n * 6
    assert adata.uns["cl_nhood_enrichment"]["zscore"].shape == (5, 5)
    assert np.isfinite(adata.uns["cl_co_occurrence"]["occ"]).all()
    sqt.gr.co_occurrence(adata, "cl", interval=6, use_pallas=True)
    assert np.isfinite(adata.uns["cl_co_occurrence"]["occ"]).all()
    sqt.gr.spatial_autocorr(adata, mode="moran", n_perms=10, seed=0)
    sqt.gr.spatial_autocorr(adata, mode="geary")
    assert np.isfinite(adata.uns["moranI"].columns["pval_sim"]).all()
    assert sorted(adata.uns["gearyC"].index) == adata.var_names
    sqt.gr.calculate_niche(adata, flavor="neighborhood", groups="cl", n_neighbors=10, resolutions=0.5, distance=2)
    sqt.gr.calculate_niche(adata, flavor="utag", n_neighbors=10, resolutions=[0.5])
    sqt.gr.calculate_niche(adata, flavor="cellcharter", n_components=3)
    assert adata.obs["nhood_niche_res=0.5"].shape == adata.obs["utag_niche_res=0.5"].shape == (n,)
    assert adata.obs["cellcharter_niche"].dtype.kind == "i"
    sqt.gr.spatial_neighbors_radius(adata, radius=(2.0, 15.0), key_added="radius")
    sqt.gr.nhood_enrichment(adata, "cl", connectivity_key="radius", n_perms=20, seed=0)
    sqt.gr.spatial_autocorr(adata, connectivity_key="radius_connectivities", mode="moran", n_perms=10, seed=0)
    sqt.gr.spatial_neighbors_delaunay(adata, key_added="delaunay", transform="spectral")
    sqt.gr.spatial_neighbors_grid(adata, n_neighs=4, n_rings=2, key_added="grid")
    sqt.gr.spatial_neighbors_from_builder(adata, sqt.gr.neighbors.RadiusBuilder(radius=12.0), key_added="built")
    sqt.gr.mask_graph(adata, None, np.array([[0, 0], [300, 0], [300, 300], [0, 300]]))
    import warnings
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        sqt.gr.spatial_neighbors(adata, delaunay=True, key_added="facade")
    assert adata.obsp["radius_connectivities"].nnz > 0 and adata.uns["delaunay_neighbors"]["params"]["coord_type"] == "generic"
    assert 0 < adata.obsp["mask_spatial_connectivities"].nnz < adata.obsp["spatial_connectivities"].nnz
    for mode in ("F", "G", "L"):
        sqt.gr.ripley(adata, "cl", mode=mode, n_simulations=5, n_observations=50, n_steps=10, seed=0)
        assert adata.uns[f"cl_ripley_{mode}"]["pvalues"].shape == (5, 10)
    sqt.gr.interaction_matrix(adata, "cl", weights=True)
    sqt.gr.centrality_scores(adata, "cl")
    assert adata.uns["cl_interactions"].shape == (5, 5)
    assert list(adata.uns["cl_centrality_scores"].index) == [str(i) for i in range(5)]
    sqt.gr.ligrec(adata, "cl", interactions=[("g0", "g3"), ("g1", "g4"), ("g2", "g5")], n_perms=20, seed=0,
                  use_raw=False, complex_policy="all", corr_method="fdr_bh")
    assert adata.uns["cl_ligrec"].pvalues.values.shape == (3, 25)
    sqt.tl.var_by_distance(adata, ["1", "3"], "cl", covariates="cl")
    design = adata.obsm["design_matrix"]
    assert list(design.columns) == ["cl", "1", "1_raw", "3", "3_raw"] and len(design.index) == n
    assert np.nanmax(design.columns["1"]) == 1.0 and np.isnan(design.columns["3"][adata.obs["cl"].cat.codes == 3]).all()
    sqt.tl.sliding_window(adata, window_size=100)
    assert set(adata.obs["sliding_window_assignment"]) == {f"window_{i}" for i in range(25)}
    windows = sqt.tl.sliding_window(adata, window_size=100, overlap=40, copy=True)
    assert all(c.dtype == bool for k, c in windows.columns.items() if k.startswith("sliding_window_assignment_"))
    img = rng.integers(0, 256, (120, 140, 3)).astype(np.uint8)
    cont = sqt.im.ImageContainer(img)
    sqt.im.process(cont, method="smooth", sigma=1.5)
    sqt.im.process(cont, layer="image", method="gray")
    sqt.im.segment(cont, layer="image_gray", method="watershed", thresh=0.5)
    spots = StandIn(rng.uniform(10, 110, (20, 2)), np.zeros(20, np.int32), 1, np.zeros((20, 1)))
    spots.uns["spatial"] = {"lib": {"scalefactors": {"spot_diameter_fullres": 17.0}}}
    sqt.im.calculate_image_features(spots, cont, layer="image", features=["summary", "histogram", "texture"])
    sqt.im.calculate_image_features(spots, cont, layer="image", features=["summary", "segmentation"], key_added="seg",
                                    features_kwargs={"segmentation": {"label_layer": "segmented_watershed"}})
    batched, per_crop = spots.obsm["img_features"], spots.obsm["seg"]
    assert len(batched.columns) == 3 * (5 + 10 + 20) and len(batched.index) == 20
    assert "segmentation_label" in per_crop.columns and np.isfinite(per_crop.columns["summary_ch-0_mean"]).all()
    import squidpy_torch.read
    from squidpy_torch.im import _zarr
    for call in (sqt.AnnData, lambda: squidpy_torch.read.read_10x_mtx("."), lambda: sqt.read_h5ad("x.h5ad")):
        try:
            call()
        except ImportError as err:
            assert "`pandas`" in str(err) or "`h5py`" in str(err), err
        else:
            raise AssertionError("a container or reader ran without pandas or h5py")
    leaked = [m for m in ("jax", "pandas", "sklearn", "squidpy_tpu", "h5py", "PIL", "matplotlib")
              if sys.modules.get(m) is not None]
    assert not leaked, leaked
    print("SLICE OK")
    """
)


def test_slice_runs_without_jax_pandas_sklearn():
    proc = subprocess.run(
        [sys.executable, "-c", _SLICE], capture_output=True, text=True, timeout=300,
        cwd=str(PKG.parent), check=False,
    )
    assert proc.returncode == 0 and "SLICE OK" in proc.stdout, proc.stderr[-3000:]


def _module_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_level_import_of_jax_pandas_sklearn(path):
    assert not _module_level_imports(path) & {"jax", "jaxlib", "squidpy_tpu", "pandas", "sklearn", "h5py", "PIL",
                                              "matplotlib"}


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with sqt.set_device("cuda"):
            pass
    previous = _device._DEVICE
    try:
        _device._DEVICE = torch.device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sqt.get_device()
    finally:
        _device._DEVICE = previous


def test_set_device_context_restores():
    before = _device._DEVICE
    with sqt.set_device("cpu") as dev:
        assert dev == torch.device("cpu") and sqt.get_device() == torch.device("cpu")
    assert _device._DEVICE == before
    with pytest.raises(ValueError, match="Unsupported device"):
        sqt.set_device("meta")


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On the CPU every wrapper runs its plain version and builds nothing."""
    from squidpy_torch import _cuda

    monkeypatch.setattr(_cuda, "library", lambda: pytest.fail("a CPU call reached the CUDA build"))
    with sqt.set_device("cpu"):
        from squidpy_torch._core.index_cipher import cipher_index_batch
        from squidpy_torch._core.rng import spawn_keys

        assert cipher_index_batch(spawn_keys(0, 2), 100).shape == (2, 100)
    assert all(v == 0 for v in _cuda.launches.values())


def test_library_builds_once_across_threads(monkeypatch, tmp_path):
    """Threads that reach a cold build at once (the radius builder's thread
    pool) build the library once and share it."""
    import threading
    import time

    from squidpy_torch import _cuda

    builds, loaded = [], object()

    def slow_compile(sources, so):
        builds.append(so)
        time.sleep(0.2)  # a second thread arrives while the first builds
        return "log"

    monkeypatch.setattr(_cuda, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "build_log", "")
    monkeypatch.setattr(_cuda, "_compile", slow_compile)
    monkeypatch.setattr(_cuda, "_load", lambda so: loaded)
    got, start = [], threading.Barrier(4)

    def call():
        start.wait()
        got.append(_cuda.library())

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and got == [loaded] * 4 and _cuda.build_log == "log"


def test_kernel_sources_carry_their_notes():
    from squidpy_torch._cuda import KERNELS

    for name, (source, replaces) in KERNELS.items():
        text = (PKG.parent / source).read_text()
        assert "Replaces" in text and "Bound on the card" in text and "Design" in text, name
        assert replaces.split(":")[0].split("/")[-1] in text, name
