"""Container for microscopy images (counterpart of ``squidpy_tpu/im/_container.py``).

Layers are plain numpy arrays in a fixed ``(y, x, z, channels)`` layout, as
in the JAX package. Rescaling runs on the device as JAX's
``jax.image.resize(method="linear")`` computes it (antialiased triangle
weights a axis, ``_resize_weights``, contracted with torch in float32).
``generate_spot_crops`` reads the container duck-typed (``obsm``, ``uns``,
``obs`` and the cell names), so a numpy stand-in without pandas serves too.
h5py, PIL and matplotlib are imported inside the calls that use them; ``save``
and ``load`` of a ``.zarr`` path go through the port's zarr store.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Iterator, Mapping, Sequence
from copy import copy as _copy, deepcopy
import logging
from pathlib import Path
from typing import Any, Union

import numpy as np
import torch

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch.im._coords import (
    _NULL_COORDS,
    _NULL_PADDING,
    CropCoords,
    CropPadding,
    _update_attrs_coords,
    _update_attrs_scale,
)
from squidpy_torch._device import NDArrayA, assert_positive, get_device, to_host
from squidpy_torch.tl._utils import obs_index, obs_values
from squidpy_torch.utils._validators import assert_in_range, assert_non_negative

logger = logging.getLogger(__name__)

__all__ = ["ImageContainer"]

Pathlike_t = Union[str, Path]
FoI_t = Union[int, float]
Input_t = Union[Pathlike_t, NDArrayA, "ImageContainer"]


def _open_image_file(path: Pathlike_t) -> NDArrayA:
    """Read an image file (jpeg/png/tiff/…) into a numpy array.

    TIFFs decode through the in-repo container parser when the encoding is
    supported (incl. BigTIFF/tiled, which PIL may reject at WSI scale);
    anything else — and exotic TIFF compressions — falls back to PIL.
    """
    from squidpy_torch.im._tiff import TiffReader, is_tiff

    if is_tiff(path):
        reader = TiffReader(path)
        if all(p.supported for p in reader.pages):
            if len(reader.pages) == 1:
                return reader.read_full()
            # decide stack-vs-pyramid from IFD metadata BEFORE decoding: a
            # pyramidal WSI must decode only its full-resolution level, not
            # every level (1.33x the slide, all held at once)
            shapes = [p.shape for p in reader.pages]
            if len(set(shapes)) == 1:
                pages = [reader.read_full(i) for i in range(len(reader.pages))]
                arr = np.stack(pages, axis=0)  # (pages, y, x[, c])
                if arr.ndim == 3:  # pages as channels
                    arr = np.transpose(arr, (1, 2, 0))
                return arr
            finest = max(range(len(shapes)), key=lambda i: shapes[i][0] * shapes[i][1])
            return reader.read_full(finest)

    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None
    with Image.open(str(path)) as handle:
        if getattr(handle, "n_frames", 1) > 1:
            frames = []
            for i in range(handle.n_frames):
                handle.seek(i)
                frames.append(np.asarray(handle))
            arr = np.stack(frames, axis=0)  # (pages, y, x[, c])
            if arr.ndim == 3:  # pages as channels
                arr = np.transpose(arr, (1, 2, 0))
        else:
            arr = np.asarray(handle)
    return arr


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float64 weights of ``jax.image.resize(method="linear")``
    along one axis: the triangle kernel widened by 1 / scale when shrinking
    (antialias), each column normalised, samples outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0)


def _resize_linear(arr: NDArrayA, ny: int, nx: int) -> NDArrayA:
    """``arr`` (y, x, z, c) resized to (ny, nx) in float32 on the device;
    an axis whose size stays is left alone, as JAX skips it."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(get_device()).to(torch.float32)
    if ny != arr.shape[0]:
        wy = torch.from_numpy(_resize_weights(arr.shape[0], ny).astype(np.float32)).to(t.device)
        t = torch.einsum("yxzc,yY->Yxzc", t, wy)
    if nx != arr.shape[1]:
        wx = torch.from_numpy(_resize_weights(arr.shape[1], nx).astype(np.float32)).to(t.device)
        t = torch.einsum("yxzc,xX->yXzc", t, wx)
    return to_host(t)


def _to_yxzc(img: NDArrayA, dims: str | Sequence[str] = "default") -> NDArrayA:
    """Normalize an array to the canonical (y, x, z, channels) layout."""
    img = np.asarray(img)
    if isinstance(dims, str) and dims != "default":
        dims = tuple(dims)
    if not isinstance(dims, str):
        order = list(dims)
        if sorted(order) not in (sorted(["y", "x"]), sorted(["y", "x", "z"]), sorted(["y", "x", "channels"]), sorted(["y", "x", "z", "channels"])):
            raise ValueError(f"Invalid `dims`: {order}.")
        arr = np.transpose(img, [order.index(d) for d in ["y", "x", "z", "channels"] if d in order])
        for pos, d in enumerate(["y", "x", "z", "channels"]):
            if d not in order:
                arr = np.expand_dims(arr, pos)
        return arr
    # default inference (reference: im/_io.py:101-180): 2D -> (y, x, 1, 1);
    # 3D -> channels last; 4D -> (y, x, z, channels) assumed
    if img.ndim == 2:
        return img[:, :, None, None]
    if img.ndim == 3:
        return img[:, :, None, :]
    if img.ndim == 4:
        return img
    raise ValueError(f"Expected image to have 2-4 dimensions, found `{img.ndim}`.")


from squidpy_torch.im._feature_mixin import FeatureMixin


class ImageContainer(FeatureMixin):
    """Container for microscopy images with layers of shape ``(y, x, z, channels)``."""

    def __init__(
        self,
        img: Input_t | None = None,
        layer: str = "image",
        lazy: bool = True,
        scale: float = 1.0,
        **kwargs: Any,
    ):
        self._layers: dict[str, NDArrayA] = {}
        self._library_ids: list[str] = []
        self.attrs: dict[Any, Any] = {
            Key.img.coords: _NULL_COORDS,
            Key.img.padding: _NULL_PADDING,
            Key.img.scale: scale,
            Key.img.mask_circle: False,
        }
        if img is not None:
            self.add_img(img, layer=layer, **kwargs)

    # -- construction ------------------------------------------------------
    @classmethod
    def concat(
        cls,
        imgs: Iterable[ImageContainer],
        library_ids: Sequence[str] | None = None,
        combine_attrs: str = "identical",
        **kwargs: Any,
    ) -> ImageContainer:
        """Concatenate containers along the Z (library) dimension."""
        imgs = list(imgs)
        if not imgs:
            raise ValueError("No images to concatenate.")
        if library_ids is None:
            library_ids = [lid for img in imgs for lid in img.library_ids]
        else:
            library_ids = [
                lid for img, lib in zip(imgs, library_ids)
                for lid in ([lib] * len(img.library_ids) if isinstance(lib, str) else lib)
            ]
        if len(set(library_ids)) != len(library_ids):
            raise ValueError(f"Found non-unique library ids: `{library_ids}`.")

        out = cls()
        out._library_ids = list(map(str, library_ids))
        keys = list(imgs[0]._layers.keys())
        for img in imgs[1:]:
            if list(img._layers.keys()) != keys:
                raise ValueError("All images must share the same layers to concatenate.")
        for key in keys:
            out._layers[key] = np.concatenate([img._layers[key] for img in imgs], axis=2)
        out.attrs = dict(imgs[0].attrs)
        return out

    @classmethod
    def from_adata(
        cls,
        adata: Any,
        img_key: str | None = None,
        library_id: str | None = None,
        spatial_key: str = Key.obsm.spatial,
        **kwargs: Any,
    ) -> ImageContainer:
        """Build from images stored under ``adata.uns['spatial']``."""
        if spatial_key not in adata.uns:
            raise KeyError(f"Unable to find `adata.uns[{spatial_key!r}]`.")
        library_id = Key.uns.library_id(adata, spatial_key, library_id)
        spatial_data = adata.uns[spatial_key][library_id]
        images = spatial_data.get(Key.uns.image_key, {})
        img_key = img_key or (next(iter(images)) if images else None)
        if img_key is None or img_key not in images:
            raise KeyError(f"Unable to find image key `{img_key}` in `adata.uns[{spatial_key!r}][{library_id!r}]`.")
        scale = spatial_data.get(Key.uns.scalefactor_key, {}).get(f"tissue_{img_key}_scalef", 1.0)
        return cls(np.asarray(images[img_key]), layer=img_key, scale=float(scale), library_id=library_id, **kwargs)

    def add_img(
        self,
        img: Input_t,
        layer: str | None = None,
        dims: str | Sequence[str] = "default",
        library_id: str | Sequence[str] | None = None,
        lazy: bool = True,
        chunks: int | str | None = None,
        copy: bool = True,
        **kwargs: Any,
    ) -> None:
        """Add a new image layer from an array, file path, or container."""
        layer = self._get_next_image_id("image") if layer is None else layer

        if isinstance(img, ImageContainer):
            if len(img._layers) != 1:
                raise ValueError("Can only add a container with exactly 1 layer.")
            arr = next(iter(img._layers.values()))
        elif isinstance(img, (str, Path)):
            arr = _to_yxzc(_open_image_file(img), dims)
        else:
            arr = _to_yxzc(np.asarray(img), dims)
            if copy:
                arr = arr.copy()

        n_z = arr.shape[2]
        if library_id is None:
            library_id = [str(i) for i in range(n_z)] if not self._library_ids else self._library_ids
        elif isinstance(library_id, str):
            library_id = [library_id] if n_z == 1 else [f"{library_id}_{i}" for i in range(n_z)]
        library_id = list(map(str, library_id))
        if len(library_id) != n_z:
            raise ValueError(f"Expected `{n_z}` library ids, found `{len(library_id)}`.")

        if self._layers:
            y, x = self.shape
            if arr.shape[:2] != (y, x):
                raise ValueError(
                    f"Expected image of shape `{(y, x)}`, found `{arr.shape[:2]}`."
                )
            if self._library_ids and library_id != self._library_ids:
                raise ValueError(
                    f"Expected library ids `{self._library_ids}`, found `{library_id}`."
                )
        else:
            self._library_ids = library_id

        self._layers[layer] = arr
        logger.info("Adding `%s` into object", layer)

    # -- persistence -------------------------------------------------------
    def save(self, path: Pathlike_t, **kwargs: Any) -> None:
        """Save the container.

        A ``.zarr`` path writes the reference's on-disk format — a zarr v2
        group with xarray ``_ARRAY_DIMENSIONS`` per layer (in-repo
        pure-Python store, interoperable with real zarr/xarray; the
        reference's im/_container.py:179-223); any other
        path writes HDF5 with the same attribute schema.
        """
        if str(path).rstrip("/").endswith(".zarr"):
            from squidpy_torch.im._zarr import write_group

            group_attrs = {
                "library_ids": list(self._library_ids),
                "coords": list(self.attrs[Key.img.coords].to_tuple()),
                "padding": list(self.attrs[Key.img.padding].to_tuple()),
                "scale": float(self.attrs[Key.img.scale]),
                "mask_circle": bool(self.attrs.get(Key.img.mask_circle, False)),
            }
            dims = {name: ("y", "x", "z", "channels") for name in self._layers}
            write_group(path, dict(self._layers), group_attrs=group_attrs, dims=dims)
            return
        import h5py

        with h5py.File(str(path), "w") as f:
            f.attrs["library_ids"] = np.asarray(self._library_ids, dtype=h5py.string_dtype())
            f.attrs["coords"] = np.asarray(self.attrs[Key.img.coords].to_tuple(), dtype=float)
            f.attrs["padding"] = np.asarray(self.attrs[Key.img.padding].to_tuple(), dtype=float)
            f.attrs["scale"] = float(self.attrs[Key.img.scale])
            f.attrs["mask_circle"] = bool(self.attrs.get(Key.img.mask_circle, False))
            for name, arr in self._layers.items():
                f.create_dataset(name, data=arr)

    @classmethod
    def load(cls, path: Pathlike_t, lazy: bool = True, chunks: int | None = None) -> ImageContainer:
        """Load a container previously stored with :meth:`save` (zarr group
        directory or HDF5 file)."""
        from squidpy_torch.im._zarr import is_zarr_store, read_group

        if is_zarr_store(path):
            arrays, attrs = read_group(path)
            out = cls()
            out._library_ids = [str(s) for s in attrs.get("library_ids", [])]
            out.attrs[Key.img.coords] = CropCoords.from_tuple(tuple(attrs["coords"]))
            out.attrs[Key.img.padding] = CropPadding.from_tuple(tuple(attrs["padding"]))
            out.attrs[Key.img.scale] = float(attrs["scale"])
            out.attrs[Key.img.mask_circle] = bool(attrs["mask_circle"])
            out._layers.update(arrays)
            return out
        import h5py

        out = cls()
        with h5py.File(str(path), "r") as f:
            out._library_ids = [s.decode() if isinstance(s, bytes) else str(s) for s in f.attrs["library_ids"]]
            out.attrs[Key.img.coords] = CropCoords.from_tuple(tuple(f.attrs["coords"]))
            out.attrs[Key.img.padding] = CropPadding.from_tuple(tuple(f.attrs["padding"]))
            out.attrs[Key.img.scale] = float(f.attrs["scale"])
            out.attrs[Key.img.mask_circle] = bool(f.attrs["mask_circle"])
            for name in f.keys():
                out._layers[name] = f[name][...]
        return out

    # -- crops -------------------------------------------------------------
    def crop_corner(
        self,
        y: FoI_t,
        x: FoI_t,
        size: FoI_t | tuple[FoI_t, FoI_t] | None = None,
        library_id: str | None = None,
        scale: float = 1.0,
        cval: int | float = 0,
        mask_circle: bool = False,
        preserve_dtypes: bool = True,
    ) -> ImageContainer:
        """Extract a crop anchored at the upper-left corner ``(y, x)``.

        Out-of-bounds regions are padded with ``cval``; ``scale`` rescales via
        ``_resize_linear`` (JAX's bilinear resize); ``mask_circle`` masks outside the
        inscribed circle (square crops only).
        """
        self._assert_not_empty()
        y, x = self._convert_to_pixel_space((y, x))
        size = self._get_size(size)
        size = self._convert_to_pixel_space(size)
        ys, xs = size
        assert_positive(ys, name="height")
        assert_positive(xs, name="width")
        assert_positive(scale, name="scale")

        orig = CropCoords(x0=x, y0=y, x1=x + xs, y1=y + ys)
        ymin, xmin = self.shape
        coords = CropCoords(
            x0=min(max(x, 0), xmin),
            y0=min(max(y, 0), ymin),
            x1=min(x + xs, xmin),
            y1=min(y + ys, ymin),
        )
        if not coords.dy:
            raise ValueError("Height of the crop is empty.")
        if not coords.dx:
            raise ValueError("Width of the crop is empty.")

        out = ImageContainer()
        out.attrs = dict(self.attrs)
        z_sel = self._get_library_ids(library_id)
        z_idx = [self._library_ids.index(lid) for lid in z_sel]
        out._library_ids = z_sel

        ysl, xsl = coords.slice
        for name, arr in self._layers.items():
            crop = arr[ysl, xsl][:, :, z_idx, :]
            if orig != coords:
                padding = orig - coords
                if preserve_dtypes:
                    # dtype-based check, NOT value-based: a python-int cval on
                    # a uint8 layer falls back to 0 even when the value fits —
                    # the reference pins this NEP-50 behavior in its tests
                    # (tests/image/test_container.py:1105-1123)
                    if not np.can_cast(np.asarray(cval).dtype, crop.dtype, casting="safe"):
                        cval = 0
                else:
                    crop = crop.astype(np.dtype(type(cval)))
                crop = np.pad(
                    crop,
                    (
                        (int(padding.y_pre), int(padding.y_post)),
                        (int(padding.x_pre), int(padding.x_post)),
                        (0, 0),
                        (0, 0),
                    ),
                    mode="constant",
                    constant_values=cval,
                )
            out._layers[name] = crop

        out.attrs = _update_attrs_coords(out.attrs, coords)
        out.attrs[Key.img.padding] = (orig - coords) if orig != coords else _NULL_PADDING
        out._post_process(scale=scale, cval=cval, mask_circle=mask_circle, preserve_dtypes=preserve_dtypes, ref=self)
        return out

    def _post_process(
        self,
        scale: FoI_t = 1,
        cval: FoI_t = 0,
        mask_circle: bool = False,
        preserve_dtypes: bool = True,
        ref: ImageContainer | None = None,
    ) -> None:
        if scale != 1:
            for name, arr in self._layers.items():
                dtype = arr.dtype
                ny = max(int(round(arr.shape[0] * scale)), 1)
                nx = max(int(round(arr.shape[1] * scale)), 1)
                self._layers[name] = _resize_linear(arr, ny, nx).astype(dtype)
            self.attrs = _update_attrs_scale(self.attrs, scale)

        if mask_circle:
            y, x = self.shape
            if y != x:
                raise ValueError(
                    f"Masking circle is only available for square crops, found crop of shape `{(y, x)}`."
                )
            c = x // 2
            Y, X = np.ogrid[:y, :x]
            mask = ((X - c) ** 2 + (Y - c) ** 2) <= c**2
            for name, arr in self._layers.items():
                arr = arr.copy()
                arr[~mask] = cval
                self._layers[name] = arr
            self.attrs[Key.img.mask_circle] = True

        if preserve_dtypes and ref is not None:
            for name, arr in self._layers.items():
                self._layers[name] = arr.astype(ref._layers[name].dtype, copy=False)

    def crop_center(
        self,
        y: FoI_t,
        x: FoI_t,
        radius: FoI_t | tuple[FoI_t, FoI_t],
        **kwargs: Any,
    ) -> ImageContainer:
        """Extract a ``(2r+1, 2r+1)`` crop centered at ``(y, x)``."""
        y, x = self._convert_to_pixel_space((y, x))
        assert_in_range(y, 0, self.shape[0], name="height")
        assert_in_range(x, 0, self.shape[1], name="width")
        if not isinstance(radius, Iterable):
            radius = (radius, radius)
        yr, xr = self._convert_to_pixel_space(radius)
        assert_non_negative(yr, name="radius height")
        assert_non_negative(xr, name="radius width")
        return self.crop_corner(y=y - yr, x=x - xr, size=(yr * 2 + 1, xr * 2 + 1), **kwargs)

    def generate_equal_crops(
        self,
        size: FoI_t | tuple[FoI_t, FoI_t] | None = None,
        as_array: str | bool = False,
        squeeze: bool = True,
        **kwargs: Any,
    ) -> Iterator[Any]:
        """Decompose the image into a grid of equally sized crops."""
        self._assert_not_empty()
        size = self._get_size(size)
        size = self._convert_to_pixel_space(size)
        y, x = self.shape
        ys, xs = size
        assert_in_range(ys, 0, y, name="height")
        assert_in_range(xs, 0, x, name="width")

        unique_y = np.arange(0, (y // ys + (y % ys != 0)) * ys, ys)
        unique_x = np.arange(0, (x // xs + (x % xs != 0)) * xs, xs)
        for yy in unique_y:
            for xx in unique_x:
                yield self.crop_corner(y=int(yy), x=int(xx), size=(ys, xs), **kwargs)._maybe_as_array(
                    as_array, squeeze=squeeze
                )

    def generate_spot_crops(
        self,
        adata: Any,
        spatial_key: str = Key.obsm.spatial,
        library_id: Sequence[str] | str | None = None,
        spot_diameter_key: str = "spot_diameter_fullres",
        spot_scale: float = 1.0,
        obs_names: Iterable[Any] | None = None,
        as_array: str | bool = False,
        squeeze: bool = True,
        return_obs: bool = False,
        **kwargs: Any,
    ) -> Iterator[Any]:
        """Iterate over observations, yielding per-spot crops (10x datasets).

        Spot radius = ``uns`` scalefactor diameter × container scale ×
        ``spot_scale`` (reference: im/_container.py:820-845).
        """
        self._assert_not_empty()
        assert_positive(spot_scale, name="scale")
        if spatial_key not in adata.obsm:
            raise KeyError(f"Spatial basis `{spatial_key}` not found in `adata.obsm`.")

        coords = np.asarray(adata.obsm[spatial_key])
        names = obs_index(adata, coords.shape[0])
        if obs_names is None:
            rows = np.arange(len(names))
        else:
            where = {name: i for i, name in enumerate(names.tolist())}
            missing = [o for o in obs_names if o not in where]
            if missing:
                raise KeyError(f"Observations `{missing[:5]}` not found.")
            rows = np.asarray([where[o] for o in obs_names], dtype=np.int64)
        if not len(rows):
            raise ValueError("No observations have been selected.")

        scale = self.attrs.get(Key.img.scale, 1)
        spatial = coords[rows, :2]

        if library_id is None:
            lid = Key.uns.library_id(adata, spatial_key=spatial_key, library_id=None)
            obs_library_ids = [lid] * len(rows)
        else:
            if library_id in adata.obs:
                obs_library_ids = list(obs_values(adata, library_id)[rows])
            else:
                lid = Key.uns.library_id(adata, spatial_key=spatial_key, library_id=library_id)
                obs_library_ids = [lid] * len(rows)

        for i, (obs, lid) in enumerate(zip(names[rows].tolist(), obs_library_ids)):
            diameter = (
                Key.uns.spot_diameter(
                    adata, spatial_key=spatial_key, library_id=lid, spot_diameter_key=spot_diameter_key
                )
                * scale
            )
            radius = int(round(diameter // 2 * spot_scale))
            y = int(spatial[i][1] * scale)
            x = int(spatial[i][0] * scale)
            if self.attrs.get(Key.img.coords, _NULL_COORDS) != _NULL_COORDS:
                y = int(y - self.attrs[Key.img.coords].y0)
                x = int(x - self.attrs[Key.img.coords].x0)
            lib_for_crop = lid if lid in self._library_ids else None
            crop = self.crop_center(y=y, x=x, radius=radius, library_id=lib_for_crop, **kwargs)
            crop.attrs[Key.img.obs] = obs
            crop = crop._maybe_as_array(as_array, squeeze=squeeze)
            yield (crop, obs) if return_obs else crop

    @classmethod
    def uncrop(cls, crops: list[ImageContainer], shape: tuple[int, int] | None = None) -> ImageContainer:
        """Re-assemble crops into their original positions."""
        if not len(crops):
            raise ValueError("No crops were supplied.")
        keys = set(crops[0]._layers.keys())
        scales = set()
        for crop in crops:
            if set(crop._layers.keys()) != keys:
                raise ValueError(f"Expected crops to have the same layers as `{sorted(keys)}`.")
            if crop.attrs.get(Key.img.coords, _NULL_COORDS) == _NULL_COORDS:
                raise ValueError("Crop does not have coordinate metadata.")
            scales.add(crop.attrs.get(Key.img.scale, 1))
        if len(scales) != 1:
            raise ValueError(f"Unable to uncrop images of different scales `{sorted(scales)}`.")
        scale = scales.pop()

        if shape is None:
            shape = (
                max(int(c.attrs[Key.img.coords].y1) for c in crops),
                max(int(c.attrs[Key.img.coords].x1) for c in crops),
            )
        out = cls()
        out._library_ids = crops[0]._library_ids
        out.attrs[Key.img.scale] = scale
        for key in keys:
            first = crops[0]._layers[key]
            canvas = np.zeros(shape + first.shape[2:], dtype=first.dtype)
            for crop in crops:
                coords = crop.attrs[Key.img.coords]
                padding = crop.attrs.get(Key.img.padding, _NULL_PADDING)
                local = coords.to_image_coordinates(padding)
                ysl, xsl = coords.slice
                lysl, lxsl = local.slice
                canvas[ysl, xsl] = crop._layers[key][lysl, lxsl]
            out._layers[key] = canvas
        return out

    # -- compute -----------------------------------------------------------
    def apply(
        self,
        func: Callable[..., NDArrayA] | Mapping[str, Callable[..., NDArrayA]],
        layer: str | None = None,
        new_layer: str | None = None,
        channel: int | None = None,
        lazy: bool = False,
        chunks: Any = None,
        copy: bool = True,
        drop: bool = False,
        fn_kwargs: Mapping[str, Any] = {},
        **kwargs: Any,
    ) -> ImageContainer | None:
        """Apply a function per Z-slice of a layer (optionally per library id).

        With ``chunks`` set the function runs tile by tile on a global grid
        (reference: dask ``map_blocks``; with ``depth`` in ``kwargs``,
        ``map_overlap`` with reflect-padded halos —
        the reference's im/_container.py:1131-1139) so a
        WSI-sized layer streams under a bounded peak RSS. ``lazy=True`` (only
        meaningful with ``chunks``) defers the computation: 2D window reads
        of the new layer compute only the intersecting tiles.
        """
        layer = self._get_layer(layer)
        new_layer = layer if new_layer is None else new_layer
        arr = self._layers[layer]
        if channel is not None:
            arr = arr[:, :, :, channel : channel + 1]

        if callable(func):
            func_map: Mapping[str, Callable[..., NDArrayA]] = {lid: func for lid in self._library_ids}
        else:
            func_map = dict(func)
            for lid in func_map:
                if lid not in self._library_ids:
                    raise KeyError(f"Library id `{lid}` not found in `{self._library_ids}`.")

        # ``drop=True`` with a per-library func mapping keeps only the selected
        # Z-planes (reference: im/_container.py apply, tests/image/
        # test_container.py:790-800)
        kept_ids = []
        plane_funcs: list[tuple[int, Callable[..., NDArrayA] | None]] = []
        for zi, lid in enumerate(self._library_ids):
            if lid in func_map:
                plane_funcs.append((zi, func_map[lid]))
            elif drop and not callable(func):
                continue
            else:
                plane_funcs.append((zi, None))  # passthrough
            kept_ids.append(lid)

        if chunks is not None:
            from squidpy_torch.im._apply import DeferredApply, normalize_chunks, normalize_depth

            deferred = DeferredApply(
                arr,
                plane_funcs,
                fn_kwargs,
                normalize_chunks(chunks, (arr.shape[0], arr.shape[1])),
                normalize_depth(kwargs.get("depth", 0)),
                boundary=kwargs.get("boundary", "reflect"),
            )
            new_arr: Any = deferred if lazy else deferred.compute()
        else:
            slices: list[NDArrayA | None] = []
            applied = []
            for zi, f in plane_funcs:
                if f is None:
                    slices.append(None)  # passthrough, resolved below
                    continue
                res = np.asarray(f(arr[:, :, zi, :].squeeze(), **fn_kwargs))
                if res.ndim == 2:
                    res = res[:, :, None]
                applied.append(res)
                slices.append(res)
            if len({a.shape for a in applied}) > 1:
                raise ValueError(
                    f"Unable to stack an array: Z-slice results have inconsistent shapes "
                    f"`{[a.shape for a in applied]}`."
                )
            target = applied[0].shape if applied else arr.shape[:2] + (arr.shape[3],)
            resolved = []
            for s, (zi, _) in zip(slices, plane_funcs):
                if s is None:
                    plane = arr[:, :, zi, :]
                    if plane.shape == target:
                        s = plane
                    else:
                        # the applied functions changed the channel count:
                        # unselected planes are zero-filled (reference:
                        # tests/image/test_segmentation.py:245-263)
                        s = np.zeros(target, dtype=applied[0].dtype if applied else plane.dtype)
                resolved.append(s)
            new_arr = np.stack(resolved, axis=2)

        if copy:
            out = ImageContainer()
            out.attrs = dict(self.attrs)
            out._library_ids = kept_ids
            out._layers[new_layer] = new_arr
            return out
        if kept_ids != self._library_ids and (set(self._layers) - {new_layer}):
            raise ValueError(
                "Unable to drop Z-planes in place when the container holds other layers; use `copy=True`."
            )
        self._library_ids = kept_ids
        self._layers[new_layer] = new_arr
        return None

    def subset(self, adata: Any, spatial_key: str = Key.obsm.spatial, copy: bool = False) -> Any:
        """Subset ``adata`` to observations whose coordinates fall in this crop."""
        c: CropCoords = self.attrs.get(Key.img.coords, _NULL_COORDS)
        if c == _NULL_COORDS:
            return adata.copy() if copy else adata
        if spatial_key not in adata.obsm:
            raise KeyError(f"Spatial basis `{spatial_key}` not found in `adata.obsm`.")
        coordinates = np.asarray(adata.obsm[spatial_key])[:, :2]
        scale = self.attrs.get(Key.img.scale, 1)
        coordinates = coordinates * scale
        mask = (
            (coordinates[:, 0] >= c.x0)
            & (coordinates[:, 0] <= c.x1)
            & (coordinates[:, 1] >= c.y0)
            & (coordinates[:, 1] <= c.y1)
        )
        return adata[mask].copy() if copy else adata[mask]

    def rename(self, old: str, new: str) -> ImageContainer:
        """Rename a layer."""
        self._layers[new] = self._layers.pop(old)
        return self

    def interactive(self, adata: Any, **kwargs: Any) -> Any:
        """Launch the napari-based interactive viewer (requires ``napari``)."""
        try:
            import napari  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Interactive viewing requires the optional `napari` package: `pip install napari`."
            ) from e
        viewer = napari.Viewer()
        for name, arr in self._layers.items():
            viewer.add_image(arr[:, :, 0, :].squeeze(), name=name)
        return viewer

    def compute(self, layer: str | None = None) -> ImageContainer:
        """No-op (arrays are eager in this build); kept for API parity."""
        return self

    def show(
        self,
        layer: str | None = None,
        library_id: str | Sequence[str] | None = None,
        channel: int | Sequence[int] | None = None,
        channelwise: bool = False,
        segmentation_layer: str | None = None,
        segmentation_alpha: float = 0.75,
        transpose: bool | None = None,
        ax: Any = None,
        figsize: tuple[float, float] | None = None,
        dpi: int | None = None,
        save: str | None = None,
        **kwargs: Any,
    ) -> None:
        """Plot the layer(s) with matplotlib."""
        import matplotlib.pyplot as plt

        layer = self._get_layer(layer)
        arr = self._layers[layer]
        lids = self._get_library_ids(library_id)
        n = len(lids)
        if ax is None:
            fig, axes = plt.subplots(1, n, figsize=figsize or (4 * n, 4), dpi=dpi, squeeze=False)
            axes = axes.ravel()
        else:
            axes = np.atleast_1d(ax)
        for a, lid in zip(axes, lids):
            zi = self._library_ids.index(lid)
            img = arr[:, :, zi, :]
            if channel is not None:
                img = img[:, :, [channel] if isinstance(channel, int) else list(channel)]
            img = img.squeeze()
            a.imshow(img, **kwargs)
            a.set_title(lid)
            a.axis("off")
            if segmentation_layer is not None:
                seg = self._layers[segmentation_layer][:, :, zi, :].squeeze()
                masked = np.ma.masked_where(seg == 0, seg)
                a.imshow(masked, alpha=segmentation_alpha, cmap="tab20")
        if save is not None:
            plt.savefig(save, bbox_inches="tight")

    # -- properties / dunder ------------------------------------------------
    @property
    def library_ids(self) -> list[str]:
        """Library ids (Z coordinates)."""
        return list(self._library_ids)

    @library_ids.setter
    def library_ids(self, library_ids: str | Sequence[str] | Mapping[str, str]) -> None:
        if isinstance(library_ids, Mapping):
            library_ids = [str(library_ids.get(lid, lid)) for lid in self._library_ids]
        elif isinstance(library_ids, str):
            library_ids = [library_ids]
        library_ids = list(map(str, library_ids))
        if len(set(library_ids)) != len(library_ids):
            raise ValueError(f"Remapped library ids must be unique, found `{library_ids}`.")
        if len(library_ids) != len(self._library_ids):
            raise ValueError(f"Expected `{len(self._library_ids)}` library ids, found `{len(library_ids)}`.")
        self._library_ids = library_ids

    @property
    def data(self) -> dict[str, NDArrayA]:
        """The underlying layer mapping."""
        return self._layers

    @property
    def shape(self) -> tuple[int, int]:
        """(height, width)."""
        if not self._layers:
            return (0, 0)
        first = next(iter(self._layers.values()))
        return first.shape[0], first.shape[1]

    def copy(self, deep: bool = False) -> ImageContainer:
        return deepcopy(self) if deep else _copy(self)

    def __copy__(self) -> ImageContainer:
        out = ImageContainer()
        out._layers = dict(self._layers)
        out._library_ids = list(self._library_ids)
        out.attrs = dict(self.attrs)
        return out

    def __deepcopy__(self, memo: Any = None) -> ImageContainer:
        out = ImageContainer()
        out._layers = {k: v.copy() for k, v in self._layers.items()}
        out._library_ids = list(self._library_ids)
        out.attrs = dict(self.attrs)
        return out

    def _maybe_as_array(self, as_array: str | bool | Sequence[str] = False, squeeze: bool = True) -> Any:
        if as_array is False:
            return self
        if as_array is True:
            res = {k: v.squeeze() if squeeze else v for k, v in self._layers.items()}
            return res
        if isinstance(as_array, str):
            arr = self._layers[as_array]
            return arr.squeeze() if squeeze else arr
        return tuple(
            (self._layers[k].squeeze() if squeeze else self._layers[k]) for k in as_array
        )

    def _get_next_image_id(self, layer: str) -> str:
        if layer not in self._layers:
            return layer
        i = 0
        while f"{layer}_{i}" in self._layers:
            i += 1
        return f"{layer}_{i}"

    def _get_library_id(self, library_id: str | None = None) -> str:
        self._assert_not_empty()
        if library_id is None:
            if len(self._library_ids) > 1:
                raise ValueError(
                    f"Unable to determine which library id to use. Please supply one from `{self._library_ids}`."
                )
            return self._library_ids[0]
        if library_id not in self._library_ids:
            raise KeyError(f"Library id `{library_id}` not found in `{self._library_ids}`.")
        return library_id

    def _get_library_ids(self, library_id: str | Sequence[str] | None = None) -> list[str]:
        if library_id is None:
            return list(self._library_ids)
        if isinstance(library_id, str):
            library_id = [library_id]
        for lid in library_id:
            if lid not in self._library_ids:
                raise KeyError(f"Library id `{lid}` not found in `{self._library_ids}`.")
        return list(library_id)

    def _get_layer(self, layer: str | None) -> str:
        self._assert_not_empty()
        if layer is None:
            if len(self._layers) > 1:
                raise ValueError(
                    f"Unable to determine which layer to use. Please supply one from `{sorted(self._layers)}`."
                )
            return next(iter(self._layers))
        if layer not in self._layers:
            raise KeyError(f"Image layer `{layer}` not found in `{sorted(self._layers)}`.")
        return layer

    def _assert_not_empty(self) -> None:
        if not len(self._layers):
            raise ValueError("The object is empty.")

    def _get_size(self, size: Any) -> tuple[FoI_t, FoI_t]:
        if size is None:
            size = (None, None)
        if not isinstance(size, Iterable) or isinstance(size, str):
            size = (size, size)
        res = list(size)
        if res[0] is None:
            res[0] = self.shape[0]
        if res[1] is None:
            res[1] = self.shape[1]
        return res[0], res[1]

    def _convert_to_pixel_space(self, size: tuple[FoI_t, FoI_t]) -> tuple[int, int]:
        y, x = size
        if isinstance(y, float) and y <= 1:
            y = int(self.shape[0] * y)
        if isinstance(x, float) and x <= 1:
            x = int(self.shape[1] * x)
        return int(y), int(x)

    def __delitem__(self, key: str) -> None:
        del self._layers[key]

    def __iter__(self) -> Iterator[str]:
        yield from self._layers

    def __len__(self) -> int:
        return len(self._layers)

    def __contains__(self, key: str) -> bool:
        return key in self._layers

    def __getitem__(self, key: str) -> NDArrayA:
        return self._layers[key]

    def __setitem__(self, key: str, value: NDArrayA) -> None:
        self.add_img(value, layer=key)

    def __repr__(self) -> str:
        s = f"ImageContainer object with {len(self._layers)} layer(s)"
        for name, arr in self._layers.items():
            s += f"\n    {name}: y ({arr.shape[0]}), x ({arr.shape[1]}), z ({arr.shape[2]}), channels ({arr.shape[3]})"
        return s

    __str__ = __repr__

    def _ipython_key_completions_(self) -> list[str]:
        """Layer names for IPython's ``container[<TAB>`` completion
        (reference: im/_container.py:1524-1525)."""
        return sorted(map(str, self._layers))

    def _repr_html_(self) -> str:
        """Notebook HTML rendering: one line per layer with its dims
        (reference: im/_container.py:1533-1545; first 10 layers shown)."""
        import html

        if not len(self):
            return f"{self.__class__.__name__} object with 0 layers"
        inflection = "" if len(self) <= 1 else "s"
        s = f"{self.__class__.__name__} object with {len(self._layers)} layer{inflection}:"
        style = "text-indent: 25px; margin-top: 0px; margin-bottom: 0px;"
        dims = ("y", "x", "z", "channels")
        for i, (name, arr) in enumerate(self._layers.items()):
            s += f"<p style={style!r}><strong>{html.escape(str(name))}</strong>: "
            s += ", ".join(
                f"<em>{html.escape(dim)}</em> ({size})" for dim, size in zip(dims, arr.shape)
            )
            s += "</p>"
            if i == 9 and i < len(self) - 1:
                s += f"<p style={style!r}>and {len(self) - i - 1} more layer(s)</p>"
                break
        return s
