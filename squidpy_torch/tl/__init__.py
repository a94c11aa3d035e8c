"""The tools module of the port (counterpart of ``squidpy_tpu/tl``): design
matrices of distances to anchors and sliding-window assignments, host numpy
and scipy."""

from __future__ import annotations

from squidpy_torch.tl._sliding_window import _calculate_window_corners, sliding_window
from squidpy_torch.tl._var_by_distance import var_by_distance
from squidpy_torch.tl._utils import Columns

# _calculate_window_corners is exported as the JAX package exports it
__all__ = ["Columns", "_calculate_window_corners", "sliding_window", "var_by_distance"]
