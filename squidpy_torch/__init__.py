"""squidpy_torch: the PyTorch/CUDA port of squidpy_tpu, one slice at a time.

Ported so far: the spatial graphs (``gr.spatial_neighbors`` and its kNN,
radius, Delaunay, grid and builder variants, ``gr.mask_graph``),
``gr.nhood_enrichment``,
``gr.co_occurrence`` (also with ``use_pallas=True``),
``gr.spatial_autocorr`` (Moran's I, Geary's C), ``gr.ripley`` (F, G and L
with their envelopes), ``gr.interaction_matrix``,
``gr.centrality_scores``, ``gr.ligrec`` with ``gr.PermutationTest``,
``gr.sepal``, and ``gr.calculate_niche`` (its ``neighborhood``, ``utag``
and ``cellcharter`` flavors). It
imports torch, numpy and scipy, never jax or squidpy_tpu. The device is
explicit: ``cuda`` by default, ``set_device("cpu")`` (or
``with set_device("cpu"):``) for the CPU.
"""

from __future__ import annotations

from squidpy_torch import gr
from squidpy_torch._constants import Key
from squidpy_torch._device import get_device, set_device

__all__ = ["Key", "get_device", "gr", "set_device"]
