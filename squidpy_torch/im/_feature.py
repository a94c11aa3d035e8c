"""Per-spot image featurization (counterpart of ``squidpy_tpu/im/_feature.py``).

API parity with the reference's im/_feature.py:22-154: iterate the
observations' spot crops and compute the requested feature families into
``adata.obsm['img_features']``. When every crop has one shape and only
summary, histogram and texture are asked for, the crops are stacked and sent
to the device once, and each family is one kernel launch (K19, K20, and K18
for every channel at once); otherwise each crop runs through the container's
``features_*`` methods. The result is JAX's DataFrame (the same columns in
the same order) where pandas imports, else a :class:`~squidpy_torch.tl._utils.Columns`.
"""

from __future__ import annotations

import logging
from collections.abc import Mapping, Sequence
from types import MappingProxyType
from typing import Any

import numpy as np
import torch

from squidpy_torch._constants._constants import ImageFeature
from squidpy_torch._device import get_device, to_host
from squidpy_torch.gr._utils import _save_data, extract_adata_if_sdata
from squidpy_torch.im._container import ImageContainer
from squidpy_torch.tl._utils import Columns

__all__ = ["calculate_image_features"]

logger = logging.getLogger(__name__)


def _frame(names: list[Any], columns: dict[str, Any]) -> Any:
    """JAX's DataFrame of ``columns`` indexed by ``names``, or without pandas a
    :class:`Columns`."""
    try:
        import pandas as pd
    except ImportError:
        return Columns(np.asarray(names), {k: np.asarray(v) for k, v in columns.items()})
    return pd.DataFrame(columns, index=pd.Index(names))


def _rows_frame(rows: list[tuple[Any, dict[str, Any]]]) -> Any:
    """The per-crop path's frame: one row a crop, the columns in order of
    first appearance (as ``pd.DataFrame`` of the rows' Series builds it)."""
    try:
        import pandas as pd
    except ImportError:
        order: dict[str, None] = {}
        for _, feats in rows:
            order.update(dict.fromkeys(feats))
        cols = {k: np.asarray([feats.get(k, np.nan) for _, feats in rows]) for k in order}
        return Columns(np.asarray([name for name, _ in rows]), cols)
    series = [pd.Series(feats, name=name) for name, feats in rows]
    res_df = pd.DataFrame(series)
    res_df.index = pd.Index([r.name for r in series])
    return res_df


def calculate_image_features(
    adata: Any,
    img: ImageContainer,
    layer: str | None = None,
    library_id: str | Sequence[str] | None = None,
    features: str | Sequence[str] = "summary",
    features_kwargs: Mapping[str, Mapping[str, Any]] = MappingProxyType({}),
    key_added: str = "img_features",
    copy: bool = False,
    n_jobs: int | None = None,
    backend: str = "loky",
    show_progress_bar: bool = True,
    *,
    table_key: str | None = None,
    **kwargs: Any,
) -> pd.DataFrame | None:
    """Calculate image features for all observations' spot crops.

    Stores a ``(n_obs, n_features)`` DataFrame (without pandas a
    :class:`~squidpy_torch.tl._utils.Columns`) under ``obsm['img_features']``.
    """
    adata = extract_adata_if_sdata(adata, table_key=table_key)
    layer = img._get_layer(layer)

    if isinstance(features, (str, ImageFeature)):
        features = [features]
    features = [ImageFeature(f) for f in features]

    logger.info("Calculating features `%s`", [f.s for f in features])

    batchable = {ImageFeature.SUMMARY, ImageFeature.COLOR_HIST, ImageFeature.TEXTURE}
    if set(features) <= batchable:
        res_df = _calculate_features_batched(
            adata, img, layer, features, features_kwargs, library_id=library_id, **kwargs
        )
        if res_df is not None:
            if copy:
                return res_df
            _save_data(adata, attr="obsm", key=key_added, data=res_df)
            return None

    rows = []
    for crop, obs in img.generate_spot_crops(
        adata, library_id=library_id, return_obs=True, as_array=False, **kwargs
    ):
        features_dict: dict[str, Any] = {}
        for feature in features:
            fkwargs = dict(features_kwargs.get(feature.s, {}))
            if feature == ImageFeature.TEXTURE:
                res = crop.features_texture(layer=layer, **fkwargs)
            elif feature == ImageFeature.COLOR_HIST:
                res = crop.features_histogram(layer=layer, **fkwargs)
            elif feature == ImageFeature.SUMMARY:
                res = crop.features_summary(layer=layer, **fkwargs)
            elif feature == ImageFeature.SEGMENTATION:
                res = crop.features_segmentation(intensity_layer=layer, **fkwargs)
            elif feature == ImageFeature.CUSTOM:
                res = crop.features_custom(layer=layer, **fkwargs)
            else:
                raise NotImplementedError(f"Feature `{feature}` is not yet implemented.")
            features_dict.update(res)
        rows.append((obs, features_dict))

    res_df = _rows_frame(rows)
    if copy:
        return res_df
    _save_data(adata, attr="obsm", key=key_added, data=res_df)
    return None


def _calculate_features_batched(
    adata: Any,
    img: ImageContainer,
    layer: str,
    features: Sequence[ImageFeature],
    features_kwargs: Mapping[str, Mapping[str, Any]],
    library_id: Any = None,
    **kwargs: Any,
) -> Any:
    """Stack same-shaped spot crops and featurize them on the device, one
    kernel launch a family; returns None (the per-crop path) when crop shapes
    differ."""
    from squidpy_torch.im._feature_mixin import _img_as_ubyte
    from squidpy_torch.ops.features import GLCM_PROPS, _offsets, _prop_columns, crop_histogram, crop_summary, glcm_props

    crops: list[Any] = []
    names: list[Any] = []
    shape = None
    for crop, obs in img.generate_spot_crops(
        adata, library_id=library_id, return_obs=True, as_array=layer, squeeze=False, **kwargs
    ):
        if shape is None:
            shape = crop.shape
        elif crop.shape != shape:
            return None  # ragged crops -> per-crop path
        crops.append(crop[:, :, 0, :])
        names.append(obs)
    if not crops:
        return None
    batch = np.stack(crops)  # (n, h, w, c)
    n, _, _, n_ch = batch.shape
    dev = get_device()
    on_device = torch.from_numpy(batch).to(dev)
    flat: torch.Tensor | None = None  # (n, h * w, c) float32, made once for the summary (and a non-uint8 histogram)

    def as_float() -> torch.Tensor:
        nonlocal flat
        if flat is None:
            src = on_device if batch.dtype in (np.uint8, np.float32, np.float64, np.int32) else \
                torch.from_numpy(batch.astype(np.float32)).to(dev)
            flat = src.reshape(n, -1, n_ch).to(torch.float32).contiguous()
        return flat

    cols: dict[str, Any] = {}
    for feature in features:
        fkwargs = dict(features_kwargs.get(feature.s, {}))
        feature_name = fkwargs.pop("feature_name", feature.s if feature != ImageFeature.COLOR_HIST else "histogram")
        channels = fkwargs.pop("channels", None)
        channels = list(range(n_ch)) if channels is None else ([channels] if isinstance(channels, int) else list(channels))
        if feature == ImageFeature.SUMMARY:
            quantiles = tuple(fkwargs.pop("quantiles", (0.9, 0.5, 0.1)))
            q, mean, std = (to_host(t) for t in crop_summary(as_float(), quantiles, rule=0))
            for c in channels:
                for qi, qv in enumerate(quantiles):
                    cols[f"{feature_name}_ch-{c}_quantile-{qv}"] = q[:, qi, c]
                cols[f"{feature_name}_ch-{c}_mean"] = mean[:, c]
                cols[f"{feature_name}_ch-{c}_std"] = std[:, c]
        elif feature == ImageFeature.COLOR_HIST:
            bins = int(fkwargs.pop("bins", 10))
            v_range = fkwargs.pop("v_range", None)
            crops_in = on_device.reshape(n, -1, n_ch) if batch.dtype == np.uint8 else as_float()  # uint8: K20's byte entry
            hist = to_host(crop_histogram(crops_in, bins, v_range, rule=0))
            for c in channels:
                for b in range(bins):
                    cols[f"{feature_name}_ch-{c}_bin-{b}"] = hist[:, c, b].astype(int)
        elif feature == ImageFeature.TEXTURE:
            props = list(fkwargs.pop("props", ("contrast", "dissimilarity", "homogeneity", "correlation", "ASM")))
            distances = list(fkwargs.pop("distances", (1,)))
            angles = list(fkwargs.pop("angles", (0, np.pi / 4, np.pi / 2, 3 * np.pi / 4)))
            pcols = _prop_columns(props)
            if np.issubdtype(batch.dtype, np.uint8):
                u8 = on_device
            else:
                u8 = torch.from_numpy(np.ascontiguousarray(_img_as_ubyte(batch))).to(dev)
            vals = to_host(glcm_props(u8, channels, _offsets(distances, angles), 256))  # (n, ch, off, 6)
            vals = vals.reshape(n, len(channels), len(distances), len(angles), len(GLCM_PROPS))
            for ci, c in enumerate(channels):
                for pi, p in zip(pcols, props):
                    for d_idx, dist in enumerate(distances):
                        for a_idx, a in enumerate(angles):
                            cols[f"{feature_name}_ch-{c}_{p}_dist-{dist}_angle-{a:.2f}"] = vals[:, ci, d_idx, a_idx, pi]
        else:  # pragma: no cover - guarded by caller
            return None

    return _frame(names, cols)
