"""The image module (counterpart of ``squidpy_tpu/im``): the container, its
processing, segmentation and per-spot features, and the zarr v2 store
(:mod:`squidpy_torch.im._zarr`) that ``SpatialData`` persists through."""

from squidpy_torch.im._container import ImageContainer
from squidpy_torch.im._coords import CropCoords, CropPadding
from squidpy_torch.im._feature import calculate_image_features
from squidpy_torch.im._process import process
from squidpy_torch.im._segment import (
    SegmentationCustom,
    SegmentationModel,
    SegmentationWatershed,
    segment,
)

__all__ = [
    "ImageContainer",
    "CropCoords",
    "CropPadding",
    "calculate_image_features",
    "process",
    "segment",
    "SegmentationModel",
    "SegmentationWatershed",
    "SegmentationCustom",
]
