"""Host utilities of the ported slice."""

from squidpy_torch.utils._stats import multipletests
from squidpy_torch.utils._validators import check_tuple_needles

__all__ = ["check_tuple_needles", "multipletests"]
