"""Crop geometry records (copy of ``squidpy_tpu/im/_coords.py``).

Behavioral counterpart of the reference's crop-coordinate machinery
(squidpy/im/_coords.py), rebuilt on named tuples: a crop
is a global-frame box (``CropCoords``), the out-of-bounds part of a crop is a
four-sided padding (``CropPadding``), and nested crops / rescales compose by
pure arithmetic on these records.

One conscious deviation: the reference computes ``center_y`` from ``x0``
(squidpy/im/_coords.py:84, an upstream bug); here
``center_y`` is derived from ``y0`` and the fix is locked by a test
(tests/test_image.py::TestCropGeometry::test_center_uses_y_axis).
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any

import numpy as np

from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._device import NDArrayA

__all__ = ["CropCoords", "CropPadding", "TupleSerializer", "_NULL_COORDS", "_NULL_PADDING"]


class TupleSerializer:
    """Scale + (de)serialization behavior shared by the geometry records.

    Subclasses are named tuples of exactly four floats, so serialization is
    the tuple itself and scaling maps over the fields.
    """

    def to_tuple(self) -> tuple[float, float, float, float]:
        return tuple(self)  # type: ignore[arg-type,return-value]

    @classmethod
    def from_tuple(cls, value: tuple[float, float, float, float]) -> TupleSerializer:
        return cls(*value)

    def __mul__(self, factor: int | float) -> TupleSerializer:  # type: ignore[override]
        if not isinstance(factor, (int, float)):
            return NotImplemented
        return type(self)(*(v * factor for v in self))  # type: ignore[attr-defined]

    def __rmul__(self, factor: int | float) -> TupleSerializer:
        return self.__mul__(factor)


class CropCoords(TupleSerializer, namedtuple("_Box", ["x0", "y0", "x1", "y1"])):
    """An axis-aligned box in global image coordinates (corner-to-corner)."""

    __slots__ = ()

    def __new__(cls, x0: float, y0: float, x1: float, y1: float) -> CropCoords:
        if x1 < x0 or y1 < y0:
            raise ValueError(f"Invalid box: corners ({x0}, {y0})..({x1}, {y1}) are not ordered.")
        return super().__new__(cls, float(x0), float(y0), float(x1), float(y1))

    @property
    def T(self) -> CropCoords:
        """The box with x- and y-axes exchanged."""
        return CropCoords(self.y0, self.x0, self.y1, self.x1)

    @property
    def dx(self) -> float:
        return self.x1 - self.x0

    @property
    def dy(self) -> float:
        return self.y1 - self.y0

    @property
    def center_x(self) -> float:
        return self.x0 + self.dx / 2.0

    @property
    def center_y(self) -> float:
        # NB: derived from y0 — the reference derives this from x0
        # (squidpy/im/_coords.py:84), which is wrong.
        return self.y0 + self.dy / 2.0

    @property
    def slice(self) -> tuple[slice, slice]:
        """Integer ``(rows, cols)`` slice selecting the box from an array."""
        return slice(int(self.y0), int(self.y1)), slice(int(self.x0), int(self.x1))

    def to_image_coordinates(self, padding: CropPadding) -> CropCoords:
        """The box's position inside its own (padded) pixel buffer.

        A crop whose buffer was padded by ``padding`` holds the real image
        data at offset ``(x_pre, y_pre)`` with the original extent.
        """
        return CropCoords(
            padding.x_pre,
            padding.y_pre,
            padding.x_pre + self.dx,
            padding.y_pre + self.dy,
        )

    def __add__(self, pad: CropPadding) -> CropCoords:  # type: ignore[override]
        """Grow the box outward by ``pad`` on each side."""
        if not isinstance(pad, CropPadding):
            return NotImplemented
        return CropCoords(self.x0 - pad.x_pre, self.y0 - pad.y_pre, self.x1 + pad.x_post, self.y1 + pad.y_post)

    def __sub__(self, inner: CropCoords) -> CropPadding:
        """Per-side absolute offset between two boxes, as a padding."""
        if not isinstance(inner, CropCoords):
            return NotImplemented
        return CropPadding(
            x_pre=abs(self.x0 - inner.x0),
            x_post=abs(self.x1 - inner.x1),
            y_pre=abs(self.y0 - inner.y0),
            y_post=abs(self.y1 - inner.y1),
        )


class CropPadding(TupleSerializer, namedtuple("_Pad", ["x_pre", "x_post", "y_pre", "y_post"])):
    """Out-of-bounds padding of a crop, one non-negative width per side."""

    __slots__ = ()

    def __new__(cls, x_pre: float, x_post: float, y_pre: float, y_post: float) -> CropPadding:
        for name, v in zip(("x_pre", "x_post", "y_pre", "y_post"), (x_pre, x_post, y_pre, y_post)):
            if v < 0:
                raise ValueError(f"Padding side `{name}` must be non-negative, got `{v}`.")
        return super().__new__(cls, float(x_pre), float(x_post), float(y_pre), float(y_post))

    @property
    def T(self) -> CropPadding:
        """The padding with x- and y-axes exchanged."""
        return CropPadding(self.y_pre, self.y_post, self.x_pre, self.x_post)


_NULL_COORDS = CropCoords(0.0, 0.0, 0.0, 0.0)
_NULL_PADDING = CropPadding(0.0, 0.0, 0.0, 0.0)


def _circular_mask(arr: NDArrayA, y: int, x: int, radius: float) -> NDArrayA:
    """Boolean disk of ``radius`` around ``(y, x)`` over ``arr``'s 2D shape."""
    rows = np.arange(arr.shape[0], dtype=float)[:, None] - y
    cols = np.arange(arr.shape[1], dtype=float)[None, :] - x
    return np.asarray(rows * rows + cols * cols <= float(radius) ** 2)


def compose_coords(outer: CropCoords, inner: CropCoords) -> CropCoords:
    """Global-frame position of ``inner``, which is expressed relative to ``outer``."""
    return CropCoords(
        outer.x0 + inner.x0,
        outer.y0 + inner.y0,
        outer.x0 + inner.x1,
        outer.y0 + inner.y1,
    )


def _update_attrs_coords(attrs: dict[Any, Any], coords: CropCoords) -> dict[Any, Any]:
    """Record a crop in container attrs, composing with any prior crop."""
    prev = attrs.get(Key.img.coords, _NULL_COORDS)
    attrs[Key.img.coords] = coords if prev == _NULL_COORDS else compose_coords(prev, coords)
    return attrs


def _update_attrs_scale(attrs: dict[Any, Any], scale: int | float) -> dict[Any, Any]:
    """Record a rescale: the scale factor, crop box and padding all scale."""
    for key in (Key.img.scale, Key.img.padding, Key.img.coords):
        attrs[key] = attrs[key] * scale
    return attrs
