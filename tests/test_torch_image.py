"""squidpy_torch.im's container, processing, segmentation and region
properties against squidpy_tpu.im on the same inputs.

Tolerances: none where both packages run the same host code or exact
integer arithmetic (crops, padding, masks, uncrop, zarr round trips, tiled
``apply``, ``gray``, the watershed, coordinate props). Two are stated:

- ``smooth`` and ``gaussian_blur``: JAX's XLA convolution and the port's
  ``F.conv2d`` sum the taps in their own orders in float32:
  |port - JAX| <= 1e-5 * max|x| (the taps sum to 1, so that is 1e-5 of the
  sum of |terms|).
- rescaled crops (``scale != 1``): JAX's ``jax.image.resize`` contracts the
  same float64-built weights with another float32 summation order:
  |port - JAX| <= 1e-5 * max|x| on float32 layers.
- intensity props: float64 sums of float32 values in another order:
  1e-12 relative.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

import squidpy_torch as sqt
import squidpy_tpu as sq
from squidpy_torch.ops import features as tf
from squidpy_tpu.ops import features as jf

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with sqt.set_device("cpu"):
        yield


def _image(shape=(100, 120, 3), dtype=np.uint8, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 1, shape).astype(dtype)


def _both(img, **kw):
    return sqt.im.ImageContainer(img, **kw), sq.im.ImageContainer(img, **kw)


def _assert_same(a, b) -> None:
    """Two containers: layers bitwise, library ids and attrs equal."""
    assert list(a) == list(b) and a.library_ids == b.library_ids
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert tuple(a.attrs["coords"]) == tuple(b.attrs["coords"])
    assert tuple(a.attrs["padding"]) == tuple(b.attrs["padding"])
    assert a.attrs["scale"] == b.attrs["scale"] and a.attrs["mask_circle"] == b.attrs["mask_circle"]


# ------------------------------------------------------------ container


@pytest.mark.parametrize("shape,dims", [((10, 20), "default"), ((10, 20, 3), "default"), ((10, 20, 2, 3), "default"),
                                        ((3, 10, 20), ("channels", "y", "x")), ((10, 2, 20), ("y", "z", "x"))])
def test_construction_and_dimensions(shape, dims):
    img = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    a, b = sqt.im.ImageContainer(), sq.im.ImageContainer()
    a.add_img(img, layer="image", dims=dims)
    b.add_img(img, layer="image", dims=dims)
    _assert_same(a, b)
    assert repr(a) == repr(b) and a._repr_html_() == b._repr_html_()


def test_io_infers_dimensions_like_jax(tmp_path):
    from squidpy_torch.im import _io as tio
    from squidpy_tpu.im import _io as jio
    from squidpy_tpu.im._tiff import write_tiff

    img = _image((30, 40, 3))
    write_tiff(tmp_path / "x.tif", img)
    assert tio._infer_shape_dtype(tmp_path / "x.tif") == jio._infer_shape_dtype(tmp_path / "x.tif")
    for shape in ((30, 40), (30, 40, 3), (3, 30, 40), (30, 40, 2, 3), (5, 30, 40, 3)):
        for infer in ("default", "channels_last", "z_last"):
            assert tio._infer_dimensions(shape, infer) == jio._infer_dimensions(shape, infer)
    a, b = _both(str(tmp_path / "x.tif"))
    _assert_same(a, b)


@pytest.mark.parametrize("y,x,size", [(10, 10, (30, 40)), (-5, -7, (30, 40)), (80, 100, (40, 40)), (0, 0, None),
                                      (0.25, 0.5, (0.5, 0.25))])
@pytest.mark.parametrize("cval", [0, 7, 0.5])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_crop_corner_padding(y, x, size, cval, dtype):
    a, b = _both(_image(dtype=dtype))
    kw = dict(size=size, cval=cval)
    _assert_same(a.crop_corner(y, x, **kw), b.crop_corner(y, x, **kw))
    _assert_same(a.crop_corner(y, x, preserve_dtypes=False, **kw), b.crop_corner(y, x, preserve_dtypes=False, **kw))


@pytest.mark.parametrize("radius", [0, 5, (3, 8), 40])
@pytest.mark.parametrize("mask_circle", [False, True])
def test_crop_center(radius, mask_circle):
    a, b = _both(_image())
    if mask_circle and isinstance(radius, tuple):
        with pytest.raises(ValueError, match="square"):
            a.crop_center(50, 60, radius, mask_circle=True)
        return
    _assert_same(a.crop_center(50, 60, radius, mask_circle=mask_circle, cval=3),
                 b.crop_center(50, 60, radius, mask_circle=mask_circle, cval=3))


@pytest.mark.parametrize("scale", [0.5, 0.37, 2.0, 1.6])
def test_crop_scale_float(scale):
    a, b = _both(_image(dtype=np.float32))
    ca, cb = a.crop_corner(5, 7, size=(40, 50), scale=scale), b.crop_corner(5, 7, size=(40, 50), scale=scale)
    assert ca["image"].shape == cb["image"].shape and ca["image"].dtype == cb["image"].dtype
    assert np.abs(ca["image"] - cb["image"]).max() <= 1e-5 * np.abs(a["image"]).max()
    assert tuple(ca.attrs["coords"]) == tuple(cb.attrs["coords"]) and ca.attrs["scale"] == cb.attrs["scale"]


def test_resize_weights_against_jax():
    import jax

    from squidpy_torch.im._container import _resize_weights

    for n_in, n_out in [(40, 20), (40, 15), (40, 80), (7, 3), (3, 11)]:
        eye = np.eye(n_in, dtype=np.float64)
        want = np.asarray(jax.image.resize(eye, (n_out, n_in), method="linear")).T  # (in, out)
        assert np.allclose(_resize_weights(n_in, n_out), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("size", [(50, 60), (33, 40), 100])
@pytest.mark.parametrize("as_array", [False, "image", True])
def test_generate_equal_crops_and_uncrop(size, as_array):
    a, b = _both(_image())
    ga = list(a.generate_equal_crops(size=size, as_array=as_array))
    gb = list(b.generate_equal_crops(size=size, as_array=as_array))
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        if as_array is False:
            _assert_same(x, y)
        elif as_array is True:
            assert all(np.array_equal(x[k], y[k]) for k in y)
        else:
            assert np.array_equal(x, y)
    if as_array is False:
        _assert_same(sqt.im.ImageContainer.uncrop(ga, shape=a.shape), sq.im.ImageContainer.uncrop(gb, shape=b.shape))


def _spots(pkg, n=12, seed=0):
    rng = np.random.default_rng(seed)
    adata = pkg.AnnData(X=np.zeros((n, 1)), obs=pd.DataFrame(index=[f"s{i}" for i in range(n)]))
    adata.obsm["spatial"] = rng.uniform(0, 100, (n, 2))  # spots near the border: padded crops
    adata.uns["spatial"] = {"lib": {"scalefactors": {"spot_diameter_fullres": 13.0}}}
    return adata


@pytest.mark.parametrize("kw", [{}, {"spot_scale": 2.5}, {"obs_names": ["s3", "s1", "s7"]}, {"mask_circle": True},
                                {"scale": 0.5}, {"as_array": "image", "squeeze": False}])
def test_generate_spot_crops(kw):
    a, b = _both(_image(dtype=np.float32))
    ga = list(a.generate_spot_crops(_spots(sqt), return_obs=True, **kw))
    gb = list(b.generate_spot_crops(_spots(sq), return_obs=True, **kw))
    assert [o for _, o in ga] == [o for _, o in gb]
    for (x, _), (y, _) in zip(ga, gb):
        if isinstance(y, np.ndarray):
            assert np.array_equal(x, y)
        elif kw.get("scale"):
            assert np.abs(x["image"] - y["image"]).max() <= 1e-5
        else:
            _assert_same(x, y)
            assert x.attrs["cell"] == y.attrs["cell"]


def test_spot_crops_with_container_scale_and_library_column():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (60, 60, 2, 1)).astype(np.uint8)
    out = []
    for pkg in (sqt, sq):
        cont = pkg.im.ImageContainer(img, library_id=["a", "b"], scale=0.5)
        adata = pkg.AnnData(X=np.zeros((6, 1)), obs=pd.DataFrame({"lib": pd.Categorical(list("abaabb"))},
                                                                 index=[f"c{i}" for i in range(6)]))
        adata.obsm["spatial"] = rng.uniform(0, 120, (6, 2)) * 0 + np.arange(6)[:, None] * 20.0
        adata.uns["spatial"] = {"a": {"scalefactors": {"spot_diameter_fullres": 8.0}},
                                "b": {"scalefactors": {"spot_diameter_fullres": 12.0}}}
        out.append(list(cont.generate_spot_crops(adata, library_id="lib", as_array="image")))
    for x, y in zip(*out):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("suffix", [".zarr", ".h5"])
def test_save_load_round_trip(tmp_path, suffix):
    if suffix == ".h5":
        pytest.importorskip("h5py")
    a, b = _both(_image())
    a.add_img(_image(dtype=np.float32, seed=1), layer="other")
    b.add_img(_image(dtype=np.float32, seed=1), layer="other")
    ca, cb = a.crop_corner(-3, 5, size=(40, 50)), b.crop_corner(-3, 5, size=(40, 50))
    ca.save(tmp_path / f"port{suffix}")
    cb.save(tmp_path / f"jax{suffix}")
    # each package reads what the other wrote
    _assert_same(sqt.im.ImageContainer.load(tmp_path / f"jax{suffix}"), cb)
    _assert_same(sqt.im.ImageContainer.load(tmp_path / f"port{suffix}"), sq.im.ImageContainer.load(tmp_path / f"jax{suffix}"))


@pytest.mark.parametrize("chunks,depth", [(None, 0), (37, 0), ((40, 25), 4), (16, 8)])
@pytest.mark.parametrize("lazy", [False, True])
def test_apply_whole_and_tiled(chunks, depth, lazy):
    from scipy import ndimage as ndi

    def fn(arr):
        return ndi.uniform_filter(arr.astype(np.float32), size=(5, 5, 1))

    a, b = _both(_image())
    kw = dict(chunks=chunks, lazy=lazy and chunks is not None, depth=depth)
    ra, rb = a.apply(fn, new_layer="f", **kw), b.apply(fn, new_layer="f", **kw)
    assert np.array_equal(np.asarray(ra["f"][:, :]), np.asarray(rb["f"][:, :]))


def test_apply_per_library_and_drop():
    img = _image((30, 40, 3, 2))
    out = []
    for pkg in (sqt, sq):
        cont = pkg.im.ImageContainer(img, library_id=["a", "b", "c"])
        out.append(cont.apply({"a": lambda x: x // 2, "c": lambda x: x + 1}, drop=True))
    _assert_same(*out)


# ------------------------------------------------------------- process


@pytest.mark.parametrize("sigma", [1.0, 2.0, [3.0, 3.0]])
@pytest.mark.parametrize("shape", [(64, 70, 3), (20, 25, 1), (9, 40, 2)])
def test_process_smooth(sigma, shape):
    img = _image(shape, dtype=np.float32) * np.float32(255)
    a, b = _both(img)
    sqt.im.process(a, method="smooth", sigma=sigma)
    sq.im.process(b, method="smooth", sigma=sigma)
    assert a["image_smooth"].shape == b["image_smooth"].shape and a["image_smooth"].dtype == b["image_smooth"].dtype
    assert np.abs(a["image_smooth"] - b["image_smooth"]).max() <= 1e-5 * np.abs(img).max()


def test_gaussian_blur_2d_and_zero_sigma():
    from squidpy_torch.ops.filters import gaussian_blur as tg
    from squidpy_tpu.ops.filters import gaussian_blur as jg

    img = _image((30, 31), dtype=np.float32)
    assert np.abs(tg(img, 1.5) - jg(img, 1.5)).max() <= 1e-5
    assert tg(img, 0) is img


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_process_gray_and_custom(dtype):
    a, b = _both(_image(dtype=dtype))
    for pkg, cont in ((sqt, a), (sq, b)):
        pkg.im.process(cont, method="gray")
        pkg.im.process(cont, method=lambda arr: arr[..., :1] * 2, layer="image", layer_added="twice")
    assert np.array_equal(a["image_gray"], b["image_gray"]) and np.array_equal(a["twice"], b["twice"])
    ca = sqt.im.process(a, layer="image", method="gray", copy=True)
    cb = sq.im.process(b, layer="image", method="gray", copy=True)
    _assert_same(ca, cb)


# ------------------------------------------------------------- segment


def _blob_image() -> np.ndarray:
    """tests/test_image.py's blob fixture: Gaussian blobs on black."""
    img = np.zeros((120, 120), dtype=np.float32)
    rng = np.random.default_rng(0)
    centers = rng.uniform(15, 105, size=(12, 2))
    yy, xx = np.mgrid[0:120, 0:120]
    for cy, cx in centers:
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    return (img / img.max() * 255).astype(np.uint8)


@pytest.mark.parametrize("kw", [{"thresh": 60}, {}, {"thresh": 60, "chunks": 60}, {"thresh": 60, "chunks": (50, 70)},
                                {"thresh": 200, "geq": False}])
def test_segment_watershed_bitwise(kw):
    a, b = _both(_blob_image())
    sqt.im.segment(a, method="watershed", **kw)
    sq.im.segment(b, method="watershed", **kw)
    assert a["segmented_watershed"].dtype == b["segmented_watershed"].dtype
    assert np.array_equal(a["segmented_watershed"], b["segmented_watershed"])
    assert len(np.unique(a["segmented_watershed"])) > 2


def test_segment_custom_and_z_subset():
    img = np.stack([_blob_image(), _blob_image()[::-1]], axis=-1)[:, :, :, None]
    out = []
    for pkg in (sqt, sq):
        cont = pkg.im.ImageContainer(img, library_id=["a", "b"])
        pkg.im.segment(cont, method=lambda arr: (arr > 100).astype(np.int32), library_id="b")
        pkg.im.segment(cont, layer="image", method="watershed", thresh=60, library_id=["a"], layer_added="ws")
        out.append(cont)
    _assert_same(*out)
    assert repr(sqt.im.SegmentationCustom(np.sum)) == repr(sq.im.SegmentationCustom(np.sum))


def test_threshold_otsu_and_peaks():
    from squidpy_torch.im._segment import peak_local_max as tp, threshold_otsu as to
    from squidpy_tpu.im._segment import peak_local_max as jp, threshold_otsu as jo

    img = _blob_image().astype(np.float64)
    assert to(img) == jo(img)
    assert np.array_equal(tp(img, np.ones((5, 5))), jp(img, np.ones((5, 5))))


def test_native_watershed_and_relabel_merge_bitwise():
    from squidpy_torch import native as tn
    from squidpy_tpu import native as jn

    assert "watershed.cpp" in [s.name for s in tn._SRCS]
    rng = np.random.default_rng(0)
    elev = rng.uniform(0, 1, (60, 70)).astype(np.float32)
    markers = np.zeros((60, 70), np.int32)
    markers[rng.integers(0, 60, 15), rng.integers(0, 70, 15)] = np.arange(1, 16)
    mask = rng.uniform(size=(60, 70)) > 0.1
    for m in (None, mask):
        assert np.array_equal(tn.watershed(elev, markers, mask=m), jn.watershed(elev, markers, mask=m))
    labels = rng.integers(0, 20, 500)
    pairs = rng.integers(1, 20, (12, 2))
    got, want = tn.relabel_merge(labels, pairs), jn.relabel_merge(labels, pairs)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    with pytest.raises(ValueError, match="matching 2D"):
        tn.watershed(elev, markers[:10])


# --------------------------------------------------------- regionprops

_COORD_PROPS = ["label", "area", "bbox_area", "bbox", "centroid", "eccentricity", "equivalent_diameter", "extent",
                "major_axis_length", "minor_axis_length", "orientation", "perimeter", "convex_area", "solidity",
                "feret_diameter_max", "filled_area", "euler_number", "perimeter_crofton"]


@pytest.mark.parametrize("seed", [0, 1])
def test_regionprops_against_jax(seed):
    rng = np.random.default_rng(seed)
    lab = np.zeros((50, 60), np.int32)
    for k in range(1, 9):
        y, x = rng.integers(0, 45, 2)
        lab[y : y + rng.integers(2, 9), x : x + rng.integers(1, 12)] = k * 3  # labels with gaps
    lab[5, 5] = 40  # a one-pixel region
    inten = rng.uniform(0, 300, lab.shape).astype(np.float32)
    got = tf.regionprops(lab, _COORD_PROPS + ["mean_intensity", "min_intensity", "max_intensity"], inten)
    want = jf.regionprops(lab, _COORD_PROPS + ["mean_intensity", "min_intensity", "max_intensity"], inten)
    assert list(got) == list(want)
    for k in want:
        if k == "mean_intensity":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
        else:
            assert np.array_equal(got[k], want[k]), k


def test_regionprops_empty_and_errors():
    empty = np.zeros((5, 5), np.int32)
    got, want = tf.regionprops(empty, ["centroid", "area"]), jf.regionprops(empty, ["centroid", "area"])
    assert list(got) == list(want) and all(len(v) == 0 for v in got.values())
    with pytest.raises(ValueError, match="requires an intensity image"):
        tf.regionprops(np.eye(4, dtype=np.int32), ["mean_intensity"])
    with pytest.raises(ValueError, match="Unsupported region property"):
        tf.regionprops(np.eye(4, dtype=np.int32), ["nope"])


@pytest.mark.parametrize("props", [("label", "area", "mean_intensity"), ("centroid", "eccentricity", "perimeter")])
def test_features_segmentation_against_jax(props):
    a, b = _both(_blob_image())
    for pkg, cont in ((sqt, a), (sq, b)):
        pkg.im.segment(cont, method="watershed", thresh=60)
    fa = a.features_segmentation("segmented_watershed", intensity_layer="image", props=props)
    fb = b.features_segmentation("segmented_watershed", intensity_layer="image", props=props)
    assert list(fa) == list(fb)
    for k in fb:
        np.testing.assert_allclose(np.asarray(fa[k], dtype=float), np.asarray(fb[k], dtype=float), rtol=1e-12, atol=0)


def test_im_exports_and_signatures():
    import inspect

    assert sqt.im.__all__ == sq.im.__all__
    for name in sq.im.__all__:
        a, b = getattr(sqt.im, name), getattr(sq.im, name)
        if inspect.isfunction(b):
            assert inspect.signature(a).parameters == inspect.signature(b).parameters, name
    for name, member in inspect.getmembers(sq.im.ImageContainer, inspect.isfunction):
        if not name.startswith("_") or name in ("__init__",):
            assert inspect.signature(getattr(sqt.im.ImageContainer, name)).parameters == \
                inspect.signature(member).parameters, name
