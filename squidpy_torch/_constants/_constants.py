"""User-facing enums of the ported slice (copy of ``squidpy_tpu/_constants/_constants.py``)."""

from __future__ import annotations

from enum import unique

from squidpy_torch._constants._utils import ModeEnum


class Transform(ModeEnum):
    SPECTRAL = "spectral"
    COSINE = "cosine"
    NONE = None  # type: ignore[assignment]


@unique
class CoordType(ModeEnum):
    GRID = "grid"
    GENERIC = "generic"


@unique
class SpatialAutocorr(ModeEnum):
    MORAN = "moran"
    GEARY = "geary"
