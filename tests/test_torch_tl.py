"""squidpy_torch.tl against squidpy_tpu.tl on the same pandas AnnData, and
without pandas.

Tolerances: none. The nearest-anchor distances come from scipy's cKDTree in
the port and sklearn's KDTree in the JAX package; both sum the squared
differences in axis order in float64 and take one square root, and the
frames are compared exactly (``check_exact``), distances bitwise.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import squidpy_torch as sqt
import squidpy_tpu as sq

ROOT = Path(sqt.__file__).resolve().parent.parent


def _adata(n: int = 900, seed: int = 0, coords_in_obs: bool = False, nan: bool = True) -> sq.AnnData:
    rng = np.random.default_rng(seed)
    lib = rng.choice(["s2", "s1", "s3"], n)
    spatial = rng.uniform(0, 1000, (n, 2))
    spatial[lib == "s2"] += 3000.0  # sections apart, as a study lays them out
    if nan:
        spatial[[5, 77]] = np.nan  # cells without coordinates
    obs = pd.DataFrame({
        "cl": pd.Categorical(rng.choice(["a", "b", "c", "d"], n)),
        "lib": pd.Categorical(lib),
        "age": rng.uniform(20, 80, n),
        "batch": rng.choice(["x", "y"], n),
    }, index=[f"cell{i}" for i in range(n)])
    if coords_in_obs:
        obs["globalX"] = rng.integers(0, 500, n).astype(np.int64)
        obs["globalY"] = rng.uniform(0, 400, n).astype(np.float32)
    adata = sq.AnnData(X=np.zeros((n, 1)), obs=obs, var=pd.DataFrame(index=["g"]))
    adata.obsm["spatial"] = spatial
    return adata


@pytest.mark.parametrize("groups", ["a", ["a", "c"], np.array([300.0, 450.0])], ids=["str", "list", "ndarray"])
@pytest.mark.parametrize("library_key", [None, "lib"])
@pytest.mark.parametrize("covariates", [None, "age", ["age", "batch"]])
@pytest.mark.parametrize("copy", [True, False])
def test_var_by_distance_matches_jax(groups, library_key, covariates, copy):
    frames = []
    for pkg in (sqt, sq):
        adata = _adata()
        out = pkg.tl.var_by_distance(adata, groups, "cl", library_key=library_key, covariates=covariates, copy=copy)
        frames.append(out if copy else adata.obsm["design_matrix"])
        assert (out is None) != copy
    got, want = frames
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    for col in want.columns:
        if col.endswith("_raw"):
            np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy())


def test_var_by_distance_library_id_and_errors():
    for pkg in (sqt, sq):
        with pytest.raises(ValueError, match="library id s9 not in lib"):
            pkg.tl.var_by_distance(_adata(), "a", "cl", library_key="lib", library_id="s9")
        with pytest.raises(ValueError, match="Anchor group `z` not found"):
            pkg.tl.var_by_distance(_adata(), "z", "cl")
        with pytest.raises(ValueError, match="cluster_key"):
            pkg.tl.var_by_distance(_adata(), "a")
        with pytest.raises(NotImplementedError):
            pkg.tl.var_by_distance(_adata(), "a", "cl", metric="cosine")
        with pytest.raises(TypeError):
            pkg.tl.var_by_distance(_adata(), 3, "cl")
    got = sqt.tl.var_by_distance(_adata(), "b", "cl", library_key="lib", library_id=["s3", "s1"], copy=True)
    want = sq.tl.var_by_distance(_adata(), "b", "cl", library_key="lib", library_id=["s3", "s1"], copy=True)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert got["b"].isna().sum() > 0


@pytest.mark.parametrize(("window_size", "overlap"), [(None, 0), (300, 0), (300, 100), (450, 200)])
@pytest.mark.parametrize("library_key", [None, "lib"])
@pytest.mark.parametrize("drop_partial_windows", [False, True])
@pytest.mark.parametrize("copy", [True, False])
def test_sliding_window_matches_jax(window_size, overlap, library_key, drop_partial_windows, copy):
    obs = []
    kwargs = {"library_key": library_key, "window_size": window_size, "overlap": overlap,
              "drop_partial_windows": drop_partial_windows, "copy": copy}
    if window_size is None and drop_partial_windows and library_key:
        # each section is narrower than the automatic window: every window is partial and dropped, no
        # column is made, and both packages fail reading it
        for pkg in (sqt, sq):
            with pytest.raises(KeyError, match="sliding_window_assignment"):
                pkg.tl.sliding_window(_adata(seed=1, nan=False), **kwargs)
        kwargs["window_size"] = 200
    for pkg in (sqt, sq):
        adata = _adata(seed=1, nan=window_size is not None)  # the automatic size of NaN coordinates raises
        out = pkg.tl.sliding_window(adata, **kwargs)
        obs.append(out if copy else adata.obs)
        assert (out is None) != copy
    pd.testing.assert_frame_equal(obs[0], obs[1], check_exact=True)
    cols = [c for c in obs[1].columns if c.startswith("sliding_window_assignment")]
    assert cols and (obs[1][cols[0]].notna().any())


def test_sliding_window_obs_coordinates_and_overwrite(caplog):
    """Coordinates from obs columns (int64 and float32), the assignment
    column written twice."""
    adatas = []
    for pkg in (sqt, sq):
        adata = _adata(seed=2, coords_in_obs=True)
        pkg.tl.sliding_window(adata, window_size=120)
        pkg.tl.sliding_window(adata, window_size=90, library_key="lib")
        adatas.append(adata)
    pd.testing.assert_frame_equal(adatas[0].obs, adatas[1].obs, check_exact=True)
    assert any("Overwriting" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize(("args", "kwargs"), [
    ((0.0, 100.0, 0.0, 50.0, 30), {}),
    ((0.0, 100.0, 0.0, 50.0, 30), {"overlap": 10}),
    ((1.5, 99.0, -3.0, 47.25, 20), {"overlap": 5, "drop_partial_windows": True}),
    ((0, 100, 0, 50, 30), {}),
])
def test_calculate_window_corners_matches_jax(args, kwargs):
    got = sqt.tl._calculate_window_corners(*args, **kwargs)
    want = sq.tl._calculate_window_corners(*args, **kwargs)
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        assert got.columns[col].dtype == want[col].dtype
        np.testing.assert_array_equal(got.columns[col], want[col].to_numpy())
    for pkg in (sqt, sq):
        with pytest.raises(ValueError, match="less than the window size"):
            pkg.tl._calculate_window_corners(0, 1, 0, 1, 5, overlap=5)
        with pytest.raises(ValueError, match="non-negative"):
            pkg.tl.sliding_window(_adata(), overlap=-1)
        with pytest.raises(ValueError, match="NaN"):  # the automatic size of NaN coordinates, in both packages
            pkg.tl.sliding_window(_adata())


_NO_PANDAS = textwrap.dedent(
    """
    import sys
    for name in ("jax", "jaxlib", "pandas", "sklearn", "squidpy_tpu", "h5py"):
        sys.modules[name] = None
    import numpy as np
    from types import SimpleNamespace
    import squidpy_torch as sqt

    class Cat:
        def __init__(self, codes, cats):
            self.cat = SimpleNamespace(codes=codes, categories=cats)

    class StandIn:
        def __init__(self, d):
            self.obs = {"cl": Cat(d["cl"], list(d["cl_cats"])), "lib": Cat(d["lib"], list(d["lib_cats"])),
                        "age": d["age"]}
            self.obsm, self.uns = {"spatial": d["spatial"]}, {}

    d = dict(np.load(sys.argv[1], allow_pickle=True))
    a = StandIn(d)
    sqt.tl.var_by_distance(a, ["a", "c"], "cl", library_key="lib", covariates="age")
    dm = a.obsm["design_matrix"]
    b = StandIn(d)
    sqt.tl.sliding_window(b, window_size=300, spatial_key="spatial")
    w = sqt.tl.sliding_window(StandIn(d), window_size=300, overlap=100, library_key="lib", copy=True)
    assert sys.modules.get("pandas") is None
    np.savez(sys.argv[2], index=dm.index, **{"dm_" + k: v for k, v in dm.columns.items()},
             assignment=b.obs["sliding_window_assignment"], **{"w_" + k: v for k, v in w.columns.items()})
    print("TL OK")
    """
)


def test_tl_runs_without_pandas(tmp_path):
    """Both functions on a numpy stand-in with pandas blocked, in a
    subprocess: the same columns as JAX's frames on the same data."""
    adata = _adata()
    np.savez(tmp_path / "in.npz", cl=adata.obs["cl"].cat.codes.to_numpy(), cl_cats=np.asarray(adata.obs["cl"].cat.categories),
             lib=adata.obs["lib"].cat.codes.to_numpy(), lib_cats=np.asarray(adata.obs["lib"].cat.categories),
             age=adata.obs["age"].to_numpy(), spatial=adata.obsm["spatial"])
    proc = subprocess.run([sys.executable, "-c", _NO_PANDAS, str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                          capture_output=True, text=True, timeout=300, cwd=str(ROOT), check=False)
    assert proc.returncode == 0 and "TL OK" in proc.stdout, proc.stderr[-3000:]
    got = np.load(tmp_path / "out.npz", allow_pickle=True)
    want = sq.tl.var_by_distance(adata, ["a", "c"], "cl", library_key="lib", covariates="age", copy=True)
    np.testing.assert_array_equal(got["index"], np.arange(adata.n_obs))
    for col in want.columns:
        np.testing.assert_array_equal(got[f"dm_{col}"].astype(want[col].to_numpy().dtype), want[col].to_numpy())
    win = sq.tl.sliding_window(adata, window_size=300, copy=True)["sliding_window_assignment"]
    assignment = got["assignment"]
    np.testing.assert_array_equal(assignment[win.notna().to_numpy()], win.dropna().astype(str).to_numpy())
    assert all(v is None for v in assignment[win.isna().to_numpy()])
    over = sq.tl.sliding_window(adata, window_size=300, overlap=100, library_key="lib", copy=True)
    assert sorted(k[2:] for k in got.files if k.startswith("w_")) == sorted(over.columns)
    for col in over.columns:
        np.testing.assert_array_equal(got[f"w_{col}"], over[col].to_numpy())
