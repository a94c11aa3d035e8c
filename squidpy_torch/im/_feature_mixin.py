"""Feature-extraction mixin for ImageContainer (counterpart of
``squidpy_tpu/im/_feature_mixin.py``).

API/key parity with the reference's im/_feature_mixin.py:80-460:
``features_summary`` / ``features_histogram`` / ``features_texture`` /
``features_segmentation`` / ``features_custom`` with identical feature-name
schemes. The numerics run through :mod:`squidpy_torch.ops.features` (K18's
GLCM counts, K19's summaries, K20's histograms, device segment reductions)
instead of skimage Cython.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any, Union

import numpy as np

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch.im._coords import _NULL_PADDING, CropCoords
from squidpy_torch.ops.features import (
    graycomatrix,
    graycoprops,
    histogram_features,
    regionprops,
    summary_features,
)
from squidpy_torch._device import NDArrayA

__all__ = ["FeatureMixin"]

Feature_t = dict[str, Any]
Channel_t = Union[int, Sequence[int]]

_valid_seg_prop = sorted(
    [
        "area",
        "bbox_area",
        "centroid",
        "convex_area",
        "eccentricity",
        "equivalent_diameter",
        "euler_number",
        "extent",
        "feret_diameter_max",
        "filled_area",
        "label",
        "major_axis_length",
        "max_intensity",
        "mean_intensity",
        "min_intensity",
        "minor_axis_length",
        "orientation",
        "perimeter",
        "perimeter_crofton",
        "solidity",
    ]
)


def _get_channels(arr: NDArrayA, channels: Channel_t | None) -> list[int]:
    if channels is None:
        return list(range(arr.shape[-1]))
    if isinstance(channels, int):
        return [channels]
    return list(channels)


def _assert_non_empty(seq: Any, *, name: str) -> list[Any]:
    if isinstance(seq, (int, float, str)):
        seq = [seq]
    seq = list(seq)
    if not len(seq):
        raise ValueError(f"No {name} have been selected.")
    return seq


class FeatureMixin:
    """Feature extraction methods, mixed into :class:`ImageContainer`."""

    def _plane(self, layer: str, library_id: str) -> NDArrayA:
        zi = self._library_ids.index(library_id)
        return self._layers[layer][:, :, zi, :]

    def features_summary(
        self,
        layer: str,
        library_id: str | None = None,
        feature_name: str = "summary",
        channels: Channel_t | None = None,
        quantiles: Sequence[float] = (0.9, 0.5, 0.1),
    ) -> Feature_t:
        """Per-channel quantiles, mean and std."""
        layer = self._get_layer(layer)
        library_id = self._get_library_id(library_id)
        arr = self._plane(layer, library_id)

        quantiles = _assert_non_empty(quantiles, name="quantiles")
        channels = _assert_non_empty(_get_channels(arr, channels), name="channels")

        features = {}
        for c in channels:
            stats = summary_features(arr[..., c], tuple(quantiles))
            for q, val in zip(quantiles, stats["quantiles"]):
                features[f"{feature_name}_ch-{c}_quantile-{q}"] = float(val)
            features[f"{feature_name}_ch-{c}_mean"] = stats["mean"]
            features[f"{feature_name}_ch-{c}_std"] = stats["std"]
        return features

    def features_histogram(
        self,
        layer: str,
        library_id: str | None = None,
        feature_name: str = "histogram",
        channels: Channel_t | None = None,
        bins: int = 10,
        v_range: tuple[int, int] | None = None,
    ) -> Feature_t:
        """Per-channel fixed-range histogram counts."""
        layer = self._get_layer(layer)
        library_id = self._get_library_id(library_id)
        arr = self._plane(layer, library_id)
        channels = _assert_non_empty(_get_channels(arr, channels), name="channels")

        if v_range is None:
            v_range = float(np.min(arr)), float(np.max(arr))

        features = {}
        for c in channels:
            hist = histogram_features(arr[..., c], bins, v_range)
            for i, count in enumerate(hist):
                features[f"{feature_name}_ch-{c}_bin-{i}"] = int(count)
        return features

    def features_texture(
        self,
        layer: str,
        library_id: str | None = None,
        feature_name: str = "texture",
        channels: Channel_t | None = None,
        props: Sequence[str] = ("contrast", "dissimilarity", "homogeneity", "correlation", "ASM"),
        distances: Sequence[int] = (1,),
        angles: Sequence[float] = (0, np.pi / 4, np.pi / 2, 3 * np.pi / 4),
    ) -> Feature_t:
        """GLCM texture properties per channel/distance/angle."""
        layer = self._get_layer(layer)
        library_id = self._get_library_id(library_id)

        props = _assert_non_empty(props, name="properties")
        angles = _assert_non_empty(angles, name="angles")
        distances = _assert_non_empty(distances, name="distances")
        arr_full = self._plane(layer, library_id)
        channels = _assert_non_empty(_get_channels(arr_full, channels), name="channels")
        arr = arr_full[..., channels]

        if not np.issubdtype(arr.dtype, np.uint8):
            arr = _img_as_ubyte(arr)

        features = {}
        for ci, c in enumerate(channels):
            comatrix = graycomatrix(arr[..., ci], distances=list(distances), angles=list(angles), levels=256)
            for p in props:
                tmp = graycoprops(comatrix, prop=p)
                for d_idx, dist in enumerate(distances):
                    for a_idx, a in enumerate(angles):
                        features[f"{feature_name}_ch-{c}_{p}_dist-{dist}_angle-{a:.2f}"] = tmp[d_idx, a_idx]
        return features

    def features_segmentation(
        self,
        label_layer: str,
        intensity_layer: str | None = None,
        library_id: str | None = None,
        feature_name: str = "segmentation",
        channels: Channel_t | None = None,
        props: Sequence[str] = ("label", "area", "mean_intensity"),
    ) -> Feature_t:
        """Per-label regionprops, aggregated to mean/std (label count, centroid
        coordinates in full-image space)."""
        label_layer = self._get_layer(label_layer)
        library_id = self._get_library_id(library_id)

        props = _assert_non_empty(props, name="properties")
        unknown = sorted(set(props) - set(_valid_seg_prop))
        if unknown:
            raise ValueError(f"Invalid property `{unknown[0]}`. Valid properties are `{_valid_seg_prop}`.")

        # intensity-weighted props need pixel data; the rest run on the mask
        intensity_props = [p for p in props if "intensity" in p]
        no_intensity_props = [p for p in props if "intensity" not in p]

        if not intensity_props:
            channels = ()
        elif intensity_layer is None:
            raise ValueError("Please specify `intensity_layer` if using intensity properties.")
        else:
            channels = _assert_non_empty(
                _get_channels(self._layers[intensity_layer], channels), name="channels"
            )

        features: dict[str, Any] = {}
        label_arr = self._plane(label_layer, library_id)[..., 0]

        tmp = regionprops(label_arr, properties=no_intensity_props)
        for p in no_intensity_props:
            if p == "label":
                features[f"{feature_name}_{p}"] = len(tmp["label"])
            elif p == "centroid":
                features[f"{feature_name}_centroid"] = self._to_full_image_coordinates(
                    tmp["centroid-0"], tmp["centroid-1"]
                )
            else:
                features[f"{feature_name}_{p}_mean"] = float(np.mean(tmp[p])) if len(tmp[p]) else np.nan
                features[f"{feature_name}_{p}_std"] = float(np.std(tmp[p])) if len(tmp[p]) else np.nan

        for c in channels:
            tmp = regionprops(
                label_arr,
                properties=props,
                intensity_image=self._plane(intensity_layer, library_id)[..., c],
            )
            for p in intensity_props:
                features[f"{feature_name}_ch-{c}_{p}_mean"] = float(np.mean(tmp[p])) if len(tmp[p]) else np.nan
                features[f"{feature_name}_ch-{c}_{p}_std"] = float(np.std(tmp[p])) if len(tmp[p]) else np.nan
        return features

    def features_custom(
        self,
        func: Callable[[NDArrayA], Any],
        layer: str | None,
        channels: Channel_t | None = None,
        feature_name: str | None = None,
        library_id: str | None = None,
        additional_layers: Sequence[str] | None = None,
        **kwargs: Any,
    ) -> Feature_t:
        """Features from a custom function applied to the (y, x, channels) plane.

        ``additional_layers`` names further layers whose (squeezed) planes are
        passed positionally after the main array (reference:
        im/_feature_mixin.py features_custom, tests/image/test_features.py:156-165).
        """
        layer = self._get_layer(layer)
        library_id = self._get_library_id(library_id)
        feature_name = getattr(func, "__name__", "custom") if feature_name is None else feature_name
        channels = _get_channels(self._layers[layer], channels)

        arr = self._plane(layer, library_id)[..., channels]
        extra = [
            np.asarray(self._plane(self._get_layer(al), library_id).squeeze())
            for al in (additional_layers or ())
        ]
        res = func(np.asarray(arr.squeeze()), *extra, **kwargs)
        if np.isscalar(res):
            res = [res]
        return {f"{feature_name}_{i}": r for i, r in enumerate(np.ravel(np.asarray(res, dtype=object)))}

    def _to_full_image_coordinates(self, y: NDArrayA, x: NDArrayA) -> NDArrayA:
        """Map crop-local centroids back into full-image coordinates
        (reference: im/_feature_mixin.py:333-368)."""
        if not len(y):
            return np.array([[]], dtype=np.float64)
        h, w = self.shape
        if self.attrs.get(Key.img.mask_circle, False):
            if h != w:
                raise ValueError(f"Crop is not a square: `{(h, w)}`.")
            c = w // 2
            mask = (x - c) ** 2 + (y - c) ** 2 <= c**2
            y, x = y[mask], x[mask]
        if not len(y):
            return np.array([[]], dtype=np.float64)

        coord = self.attrs.get(Key.img.coords)
        if coord is None or coord == CropCoords(0, 0, 0, 0):
            coord = CropCoords(x0=0, y0=0, x1=w, y1=h)
        padding = self.attrs.get(Key.img.padding, _NULL_PADDING)
        y_slc, x_slc = coord.to_image_coordinates(padding).slice

        denom_y = (np.max(y) - np.min(y)) or 1.0
        denom_x = (np.max(x) - np.min(x)) or 1.0
        y = (y - np.min(y)) / denom_y
        x = (x - np.min(x)) / denom_x
        y = coord.slice[0].start + (y_slc.stop - y_slc.start) * y
        x = coord.slice[1].start + (x_slc.stop - x_slc.start) * x
        return np.column_stack((x, y))


def _img_as_ubyte(arr: NDArrayA) -> NDArrayA:
    """skimage ``img_as_ubyte`` semantics: floats in [0,1] scale by 255;
    integers rescale by dtype range."""
    if np.issubdtype(arr.dtype, np.floating):
        if arr.min() < -1.0 or arr.max() > 1.0:
            raise ValueError("Images of type float must be between -1 and 1.")
        return (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
    if np.issubdtype(arr.dtype, np.unsignedinteger):
        maxv = np.iinfo(arr.dtype).max
        return (arr.astype(np.float64) * (255.0 / maxv) + 0.5).astype(np.uint8)
    if np.issubdtype(arr.dtype, np.signedinteger):
        maxv = np.iinfo(arr.dtype).max
        return (np.clip(arr, 0, None).astype(np.float64) * (255.0 / maxv) + 0.5).astype(np.uint8)
    if arr.dtype == bool:
        return arr.astype(np.uint8) * 255
    raise TypeError(f"Unsupported dtype `{arr.dtype}`.")
