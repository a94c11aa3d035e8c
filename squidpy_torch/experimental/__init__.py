"""Experimental subpackage of the port (counterpart of ``squidpy_tpu.experimental``).

Only ``im``'s cell-info pass (``compute_cell_info``) is ported so far: the
graph builders' element centroids need it. The rest of the experimental
image pipeline follows in a later slice, and this package is not exported
from ``squidpy_torch`` until then.
"""

from squidpy_torch.experimental import im

__all__ = ["im"]
