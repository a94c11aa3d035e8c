"""Public spatial-neighbours API of the ported slice (counterpart of ``squidpy_tpu/gr/_build.py``).

Results are written under the same keys as ``squidpy_tpu``:
``obsp['{key_added}_connectivities'/'_distances']`` and
``uns['{key_added}_neighbors']``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple

import numpy as np

from squidpy_torch._constants._constants import Transform
from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.graph import _cache_key
from squidpy_torch.gr._utils import (
    _assert_categorical_obs,
    _assert_spatial_basis,
    _save_data,
    extract_adata_if_sdata,
)
from squidpy_torch.gr.neighbors import GraphBuilder, KNNBuilder

__all__ = ["SpatialNeighborsResult", "spatial_neighbors_knn"]


class SpatialNeighborsResult(NamedTuple):
    connectivities: Any
    distances: Any


def _run_spatial_neighbors(
    adata: Any,
    builder: GraphBuilder[Any, Any],
    *,
    spatial_key: str = Key.obsm.spatial,
    library_key: str | None = None,
    key_added: str = "spatial",
    copy: bool = False,
    n_jobs: int = 1,
) -> SpatialNeighborsResult | None:
    coords_all = np.asarray(adata.obsm[spatial_key])
    if library_key is not None:
        _assert_categorical_obs(adata, key=library_key)
        codes = np.asarray(adata.obs[library_key].cat.codes)
        per_lib_coords: list[np.ndarray] = []
        idxs: list[int] = []
        for code in range(len(adata.obs[library_key].cat.categories)):
            idx = np.where(codes == code)[0]
            per_lib_coords.append(np.ascontiguousarray(coords_all[idx]))
            idxs.extend(idx.tolist())
        if n_jobs > 1:
            with ThreadPoolExecutor(max_workers=n_jobs) as pool:
                mats = list(pool.map(builder.build, per_lib_coords))
        else:
            mats = [builder.build(c) for c in per_lib_coords]
        adj, dst = builder.combine(mats, idxs)
    else:
        adj, dst = builder.build(coords_all)

    conns_key = Key.obsp.spatial_conn(key_added)
    neighbors_dict = {
        "connectivities_key": conns_key,
        "distances_key": Key.obsp.spatial_dist(key_added),
        "params": builder.uns_params(),
    }
    if copy:
        return SpatialNeighborsResult(connectivities=adj, distances=dst)

    # drop any stale device-graph cache for this key
    adata.uns.pop(_cache_key(conns_key), None)
    _save_data(adata, attr="obsp", key=conns_key, data=adj)
    _save_data(adata, attr="obsp", key=Key.obsp.spatial_dist(key_added), data=dst)
    _save_data(adata, attr="uns", key=Key.uns.spatial_neighs(key_added), data=neighbors_dict)
    return None


def spatial_neighbors_knn(
    data: Any,
    *,
    spatial_key: str = Key.obsm.spatial,
    elements_to_coordinate_systems: dict[str, str] | None = None,
    table_key: str | None = None,
    library_key: str | None = None,
    n_neighs: int = 6,
    percentile: float | None = None,
    transform: str | Transform | None = None,
    set_diag: bool = False,
    key_added: str = "spatial",
    copy: bool = False,
    n_jobs: int = 1,
) -> SpatialNeighborsResult | None:
    """Create a k-nearest-neighbour graph from spatial coordinates."""
    if elements_to_coordinate_systems is not None:
        raise NotImplementedError(
            "Resolving SpatialData element centroids (`elements_to_coordinate_systems`) is not ported to "
            "squidpy_torch yet; see ROADMAP.md, queue 1."
        )
    builder = KNNBuilder(n_neighs=n_neighs, percentile=percentile, transform=transform, set_diag=set_diag)
    adata = extract_adata_if_sdata(data, table_key=table_key)
    _assert_spatial_basis(adata, spatial_key)
    return _run_spatial_neighbors(
        adata, builder, spatial_key=spatial_key, library_key=library_key,
        key_added=key_added, copy=copy, n_jobs=n_jobs,
    )
