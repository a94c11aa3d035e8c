"""User-facing enums of the ported slice (copy of ``squidpy_tpu/_constants/_constants.py``),
and the port's numeric switches."""

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


@unique
class Centrality(ModeEnum):
    DEGREE = "degree_centrality"
    CLUSTERING = "average_clustering"
    CLOSENESS = "closeness_centrality"


@unique
class RipleyStat(ModeEnum):
    F = "F"
    G = "G"
    L = "L"


# From this many cells on, the permutation null of ``spatial_autocorr`` takes
# its operands (z, u = W z and the row sums of W) in bf16, as the JAX package
# does with x64 off (``squidpy_tpu/gr/_ppatterns.py:253``, ``gather_bf16``).
# The port has no x64 mode, so the size alone decides.
BF16_GATHER_MIN_N = 1 << 19
