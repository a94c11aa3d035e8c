"""Experimental image pipeline of the port: so far the cell-info pass."""

from squidpy_torch.experimental.im._tiling import CellInfo, compute_cell_info

__all__ = ["CellInfo", "compute_cell_info"]
