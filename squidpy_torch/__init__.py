"""squidpy_torch: the PyTorch/CUDA port of squidpy_tpu, one slice at a time.

Ported so far: the spatial graphs (``gr.spatial_neighbors`` and its kNN,
radius, Delaunay, grid and builder variants, ``gr.mask_graph``),
``gr.nhood_enrichment``,
``gr.co_occurrence`` (also with ``use_pallas=True``),
``gr.spatial_autocorr`` (Moran's I, Geary's C), ``gr.ripley`` (F, G and L
with their envelopes), ``gr.interaction_matrix``,
``gr.centrality_scores``, ``gr.ligrec`` with ``gr.PermutationTest``,
``gr.sepal``, and ``gr.calculate_niche`` (its ``neighborhood``, ``utag``
and ``cellcharter`` flavors); ``tl.var_by_distance`` and
``tl.sliding_window``; the ``AnnData`` (with ``concat``) and
``SpatialData`` containers, h5ad I/O (``read_h5ad``, ``AnnData.write_h5ad``)
and the readers ``read.visium``, ``read.vizgen``, ``read.nanostring``,
``read.read_10x_h5`` and ``read.read_10x_mtx``; and ``im``: the
``ImageContainer``, ``im.process``, ``im.segment`` and
``im.calculate_image_features``. It imports torch, numpy and
scipy, never jax or squidpy_tpu; pandas, h5py, PIL and matplotlib only inside
the functions that need them (the containers, h5ad I/O, the readers, the
image files and plots), so it
imports on a machine without them. The device is explicit: ``cuda`` by
default, ``set_device("cpu")`` (or ``with set_device("cpu"):``) for the CPU.
"""

from __future__ import annotations

from squidpy_torch import gr, im, read, tl
from squidpy_torch._constants import Key
from squidpy_torch._core import AnnData, SpatialData, SpatialGraph, concat, read_h5ad
from squidpy_torch._device import get_device, set_device

__all__ = ["AnnData", "Key", "SpatialData", "SpatialGraph", "concat", "get_device", "gr", "im", "read", "read_h5ad",
           "set_device", "tl"]
