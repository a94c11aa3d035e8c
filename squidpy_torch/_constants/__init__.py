from squidpy_torch._constants import _constants as constants
from squidpy_torch._constants._pkg_constants import Key

__all__ = ["Key", "constants"]
