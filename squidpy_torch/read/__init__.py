"""Spatial omics dataset readers (counterpart of ``squidpy_tpu/read``)."""

from squidpy_torch.read._read import nanostring, visium, vizgen
from squidpy_torch.read._utils import read_10x_h5, read_10x_mtx

__all__ = ["visium", "vizgen", "nanostring", "read_10x_h5", "read_10x_mtx"]
