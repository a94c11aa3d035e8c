"""Public spatial-neighbours API of the port (counterpart of ``squidpy_tpu/gr/_build.py``).

The deprecated ``spatial_neighbors`` facade, the five mode-specific
functions, and ``mask_graph``. Results are written under the same keys as
``squidpy_tpu``: ``obsp['{key_added}_connectivities'/'_distances']`` and
``uns['{key_added}_neighbors']``. With ``elements_to_coordinate_systems``,
a SpatialData-like input's shapes, labels or points elements give the
table's coordinates (their centroids), and a region key with more than one
region becomes the library key, as in the JAX package.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple

import numpy as np

from squidpy_torch._constants._constants import CoordType, Transform
from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch._core.graph import _cache_key
from squidpy_torch.gr._utils import (
    _assert_categorical_obs,
    _assert_spatial_basis,
    _save_data,
    extract_adata_if_sdata,
)
from squidpy_torch.gr.neighbors import (
    DelaunayBuilder,
    GraphBuilder,
    GridBuilder,
    KNNBuilder,
    RadiusBuilder,
)

__all__ = [
    "SpatialNeighborsResult",
    "mask_graph",
    "spatial_neighbors",
    "spatial_neighbors_delaunay",
    "spatial_neighbors_from_builder",
    "spatial_neighbors_grid",
    "spatial_neighbors_knn",
    "spatial_neighbors_radius",
]


class SpatialNeighborsResult(NamedTuple):
    connectivities: Any
    distances: Any


def _resolve_graph_builder(
    *,
    coord_type: str | CoordType | None,
    n_neighs: int | None,
    radius: float | tuple[float, float] | None,
    delaunay: bool | None,
    n_rings: int | None,
    percentile: float | None,
    transform: str | Transform | None,
    set_diag: bool,
    has_spatial_uns: bool,
) -> GraphBuilder[Any, Any]:
    n_neighs_was_set = n_neighs is not None
    if coord_type is None:
        coord_type = CoordType.GRID if has_spatial_uns and not n_neighs_was_set else CoordType.GENERIC
    coord_type = CoordType(coord_type)
    n_neighs = 6 if n_neighs is None else n_neighs
    n_rings = 1 if n_rings is None else n_rings
    delaunay = False if delaunay is None else delaunay
    common: dict[str, Any] = {"transform": transform, "set_diag": set_diag}

    if coord_type == CoordType.GRID:
        if radius is not None:
            warnings.warn(
                "Parameter `radius` is ignored for grid coordinates.", FutureWarning, stacklevel=3
            )
        if percentile is not None:
            raise ValueError(
                "`percentile` is not supported for grid coordinates. It only applies to generic (non-grid) graphs."
            )
        return GridBuilder(n_neighs=n_neighs, **common, n_rings=n_rings, delaunay=delaunay)
    if delaunay:
        if n_neighs_was_set:
            warnings.warn(
                "Parameter `n_neighs` is ignored when `delaunay=True` use `spatial_neighbors_delaunay` instead.",
                FutureWarning,
                stacklevel=3,
            )
        # legacy contract: a scalar radius with delaunay is silently ignored
        legacy_radius = radius if isinstance(radius, tuple) else None
        return DelaunayBuilder(**common, radius=legacy_radius, percentile=percentile)
    if radius is not None:
        if n_neighs_was_set:
            warnings.warn(
                "Parameter `n_neighs` is ignored when `radius` is set use `spatial_neighbors_radius` instead.",
                FutureWarning,
                stacklevel=3,
            )
        return RadiusBuilder(**common, radius=radius, percentile=percentile)
    return KNNBuilder(n_neighs=n_neighs, **common, percentile=percentile)


def _first_unique(values: np.ndarray) -> np.ndarray:
    """The distinct ``values`` in order of first appearance (``pd.unique``'s order)."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def element_centroids(elem: Any) -> tuple[np.ndarray | None, np.ndarray]:
    """Centroids of a SpatialData-style element as ``(instance_ids, (m, 2) xy)``.

    Duck-typed, as the JAX package's ``element_centroids``:

    - 2D integer array (labels image): per-label centroid; label 0 is
      background and dropped.
    - DataFrame with ``x``/``y`` columns (circles / points): those columns.
    - GeoDataFrame-like with a ``geometry`` column of objects exposing
      ``.centroid.x/.y`` (shapes).
    - ``(m, 2)`` float array: treated as centroids directly.
    """
    if isinstance(elem, np.ndarray) or (hasattr(elem, "ndim") and hasattr(elem, "dtype")):
        arr = np.asarray(elem)
        if arr.ndim == 2 and np.issubdtype(arr.dtype, np.integer):
            from squidpy_torch.experimental.im import compute_cell_info

            info = compute_cell_info(arr)
            ids = np.array(sorted(i for i in info if i != 0))
            cent = np.array([[info[i].centroid_x, info[i].centroid_y] for i in ids], dtype=np.float64)
            return ids, cent.reshape(-1, 2)
        if arr.ndim == 2 and arr.shape[1] == 2:
            return None, np.asarray(arr, dtype=np.float64)
        raise TypeError(f"Cannot derive centroids from an array of shape {arr.shape} / dtype {arr.dtype}.")
    if hasattr(elem, "columns") and "x" in elem.columns and "y" in elem.columns:
        ids = np.asarray(elem.index)
        return ids, np.asarray(elem[["x", "y"]], dtype=np.float64)
    if hasattr(elem, "geometry"):
        geoms = list(elem.geometry)
        cent = np.array([[g.centroid.x, g.centroid.y] for g in geoms], dtype=np.float64)
        ids = np.asarray(elem.index) if hasattr(elem, "index") else None
        return ids, cent.reshape(-1, 2)
    raise TypeError(f"Cannot derive centroids from element of type `{type(elem).__name__}`.")


def _get_element(sdata: Any, name: str) -> Any:
    try:
        return sdata[name]
    except (TypeError, KeyError):
        pass
    for attr in ("shapes", "labels", "points", "images"):
        coll = getattr(sdata, attr, None)
        if coll is not None and name in coll:
            return coll[name]
    raise KeyError(f"Element `{name}` not found in the SpatialData object.")


def _attach_element_centroids(
    sdata: Any,
    table: Any,
    elements_to_coordinate_systems: dict[str, str],
    spatial_key: str,
) -> str | None:
    """Resolve per-cell coordinates from shapes/labels/points elements into
    ``table.obsm[spatial_key]``; returns the table's region key (which becomes
    the library key). Elements are taken as already expressed in their target
    coordinate system (identity transform), as in the JAX package."""
    attrs = dict(table.uns.get("spatialdata_attrs", {}))
    region = attrs.get("region")
    region_key = attrs.get("region_key")
    instance_key = attrs.get("instance_key")

    if region_key is not None and region_key in table.obs:
        regions = np.asarray(table.obs[region_key])
        ordered_regions = list(_first_unique(regions))
    else:
        region_key = None
        ordered_regions = [region] if isinstance(region, str) and region else list(elements_to_coordinate_systems)

    missing = [r for r in ordered_regions if r not in elements_to_coordinate_systems]
    if missing:
        raise ValueError(
            f"The table annotates elements {missing} that are absent from "
            f"`elements_to_coordinate_systems`; every annotated element needs a coordinate system."
        )

    blocks: list[np.ndarray] = []
    for name in ordered_regions:
        ids, cent = element_centroids(_get_element(sdata, name))
        if region_key is not None and instance_key is not None and ids is not None:
            inst = np.asarray(table.obs[instance_key])[regions == name]
            pos = {v: i for i, v in enumerate(ids)}
            try:
                order = np.array([pos[v] for v in inst])
            except KeyError as e:
                raise ValueError(
                    f"Table instance {e.args[0]!r} of region `{name}` has no centroid in the element."
                ) from None
            cent = cent[order]
        blocks.append(cent)

    centroids = np.concatenate(blocks, axis=0) if blocks else np.empty((0, 2))
    if centroids.shape[0] != table.n_obs:
        raise ValueError(
            f"Resolved `{centroids.shape[0]}` centroids for a table of `{table.n_obs}` observations; "
            f"the elements must annotate every table row exactly once."
        )
    table.obsm[spatial_key] = centroids
    return region_key


def _prepare_spatial_neighbors_input(
    data: Any,
    *,
    spatial_key: str,
    elements_to_coordinate_systems: dict[str, str] | None,
    table_key: str | None,
    library_key: str | None,
) -> tuple[Any, str | None]:
    """The table to build on and the library key. Given
    ``elements_to_coordinate_systems`` and a SpatialData-like ``data``, the
    elements' centroids become ``obsm[spatial_key]``, and a region key with
    more than one region becomes the library key (made categorical)."""
    adata = extract_adata_if_sdata(data, table_key=table_key)
    if elements_to_coordinate_systems is not None and adata is not data:
        region_key = _attach_element_centroids(data, adata, elements_to_coordinate_systems, spatial_key)
        if library_key is None and region_key is not None:
            col = adata.obs[region_key]
            values = np.asarray(col)
            if len(_first_unique(values[values == values])) > 1:  # nunique: NaN left out
                if not hasattr(getattr(col, "cat", None), "codes"):
                    import pandas as pd

                    adata.obs[region_key] = pd.Categorical(col)
                library_key = region_key
    _assert_spatial_basis(adata, spatial_key)
    return adata, library_key


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


def spatial_neighbors(
    adata: Any,
    spatial_key: str = Key.obsm.spatial,
    elements_to_coordinate_systems: dict[str, str] | None = None,
    table_key: str | None = None,
    library_key: str | None = None,
    coord_type: str | CoordType | None = None,
    n_neighs: int | None = None,
    radius: float | tuple[float, float] | None = None,
    delaunay: bool | None = None,
    n_rings: int | None = None,
    percentile: float | None = None,
    transform: str | Transform | None = None,
    set_diag: bool = False,
    key_added: str = "spatial",
    copy: bool = False,
    n_jobs: int = 1,
) -> SpatialNeighborsResult | None:
    """Create a graph from spatial coordinates (deprecated facade).

    .. deprecated::
        Use :func:`spatial_neighbors_knn`, :func:`spatial_neighbors_radius`,
        :func:`spatial_neighbors_delaunay`, :func:`spatial_neighbors_grid` or
        :func:`spatial_neighbors_from_builder` instead.

    ``coord_type=None`` resolves to a grid when ``adata.uns['spatial']``
    (Visium metadata) is present and ``n_neighs`` is unset.
    """
    warnings.warn(
        "Calling `spatial_neighbors` is deprecated. Use `spatial_neighbors_knn`, "
        "`spatial_neighbors_radius`, `spatial_neighbors_delaunay`, `spatial_neighbors_grid`, "
        "or `spatial_neighbors_from_builder` instead.",
        FutureWarning,
        stacklevel=2,
    )
    adata, library_key = _prepare_spatial_neighbors_input(
        adata, spatial_key=spatial_key, elements_to_coordinate_systems=elements_to_coordinate_systems,
        table_key=table_key, library_key=library_key,
    )
    builder = _resolve_graph_builder(
        coord_type=coord_type,
        n_neighs=n_neighs,
        radius=radius,
        delaunay=delaunay,
        n_rings=n_rings,
        percentile=percentile,
        transform=transform,
        set_diag=set_diag,
        has_spatial_uns=Key.uns.spatial in adata.uns,
    )
    return _run_spatial_neighbors(
        adata, builder, spatial_key=spatial_key, library_key=library_key,
        key_added=key_added, copy=copy, n_jobs=n_jobs,
    )


def spatial_neighbors_from_builder(
    data: Any,
    builder: GraphBuilder[Any, Any],
    *,
    spatial_key: str = Key.obsm.spatial,
    elements_to_coordinate_systems: dict[str, str] | None = None,
    table_key: str | None = None,
    library_key: str | None = None,
    key_added: str = "spatial",
    copy: bool = False,
    n_jobs: int = 1,
) -> SpatialNeighborsResult | None:
    """Create a graph from spatial coordinates using an explicit builder instance."""
    adata, library_key = _prepare_spatial_neighbors_input(
        data, spatial_key=spatial_key, elements_to_coordinate_systems=elements_to_coordinate_systems,
        table_key=table_key, library_key=library_key,
    )
    return _run_spatial_neighbors(
        adata, builder, spatial_key=spatial_key, library_key=library_key,
        key_added=key_added, copy=copy, n_jobs=n_jobs,
    )


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
    builder = KNNBuilder(n_neighs=n_neighs, percentile=percentile, transform=transform, set_diag=set_diag)
    return spatial_neighbors_from_builder(
        data, builder, spatial_key=spatial_key, elements_to_coordinate_systems=elements_to_coordinate_systems,
        table_key=table_key, library_key=library_key, key_added=key_added, copy=copy, n_jobs=n_jobs,
    )


def spatial_neighbors_radius(
    data: Any,
    *,
    radius: float | tuple[float, float],
    spatial_key: str = Key.obsm.spatial,
    elements_to_coordinate_systems: dict[str, str] | None = None,
    table_key: str | None = None,
    library_key: str | None = None,
    percentile: float | None = None,
    transform: str | Transform | None = None,
    set_diag: bool = False,
    key_added: str = "spatial",
    copy: bool = False,
    n_jobs: int = 1,
) -> SpatialNeighborsResult | None:
    """Create a radius neighbour graph from spatial coordinates (K6 on the card)."""
    builder = RadiusBuilder(radius=radius, percentile=percentile, transform=transform, set_diag=set_diag)
    return spatial_neighbors_from_builder(
        data, builder, spatial_key=spatial_key, elements_to_coordinate_systems=elements_to_coordinate_systems,
        table_key=table_key, library_key=library_key, key_added=key_added, copy=copy, n_jobs=n_jobs,
    )


def spatial_neighbors_delaunay(
    data: Any,
    *,
    spatial_key: str = Key.obsm.spatial,
    elements_to_coordinate_systems: dict[str, str] | None = None,
    table_key: str | None = None,
    library_key: str | None = None,
    radius: float | tuple[float, float] | None = None,
    percentile: float | None = None,
    transform: str | Transform | None = None,
    set_diag: bool = False,
    key_added: str = "spatial",
    copy: bool = False,
    n_jobs: int = 1,
) -> SpatialNeighborsResult | None:
    """Create a Delaunay triangulation graph from spatial coordinates."""
    builder = DelaunayBuilder(radius=radius, percentile=percentile, transform=transform, set_diag=set_diag)
    return spatial_neighbors_from_builder(
        data, builder, spatial_key=spatial_key, elements_to_coordinate_systems=elements_to_coordinate_systems,
        table_key=table_key, library_key=library_key, key_added=key_added, copy=copy, n_jobs=n_jobs,
    )


def spatial_neighbors_grid(
    data: Any,
    *,
    spatial_key: str = Key.obsm.spatial,
    elements_to_coordinate_systems: dict[str, str] | None = None,
    table_key: str | None = None,
    library_key: str | None = None,
    n_neighs: int = 6,
    n_rings: int = 1,
    delaunay: bool = False,
    transform: str | Transform | None = None,
    set_diag: bool = False,
    key_added: str = "spatial",
    copy: bool = False,
    n_jobs: int = 1,
) -> SpatialNeighborsResult | None:
    """Create a grid (Visium-style lattice) graph from spatial coordinates."""
    builder = GridBuilder(n_neighs=n_neighs, n_rings=n_rings, delaunay=delaunay, transform=transform, set_diag=set_diag)
    return spatial_neighbors_from_builder(
        data, builder, spatial_key=spatial_key, elements_to_coordinate_systems=elements_to_coordinate_systems,
        table_key=table_key, library_key=library_key, key_added=key_added, copy=copy, n_jobs=n_jobs,
    )


# polygon masking: a vectorised even-odd-rule point-in-polygon test in place
# of shapely (host numpy, copied from the JAX package)


def _close_ring(ring: np.ndarray) -> np.ndarray:
    ring = np.asarray(ring, dtype=float)
    if len(ring) and not np.array_equal(ring[0], ring[-1]):
        ring = np.vstack([ring, ring[:1]])
    return ring


def _polygon_rings(polygon_mask: Any) -> list[np.ndarray]:
    """Exterior/interior ring coordinate arrays of a shapely-like
    Polygon/MultiPolygon, or of raw ``(m, 2)`` arrays / lists of them (raw
    rings are closed automatically)."""
    rings: list[np.ndarray] = []
    if hasattr(polygon_mask, "geoms"):  # MultiPolygon
        for geom in polygon_mask.geoms:
            rings.extend(_polygon_rings(geom))
        return rings
    if hasattr(polygon_mask, "exterior"):  # Polygon
        rings.append(np.asarray(polygon_mask.exterior.coords))
        for interior in polygon_mask.interiors:
            rings.append(np.asarray(interior.coords))
        return rings
    if isinstance(polygon_mask, (list, tuple)) and len(polygon_mask) and np.asarray(polygon_mask[0]).ndim == 2:
        return [_close_ring(r) for r in polygon_mask]  # list of rings
    return [_close_ring(polygon_mask)]


def points_in_polygon(points: np.ndarray, polygon_mask: Any) -> np.ndarray:
    """Vectorised even-odd-rule containment test for a (multi)polygon with holes."""
    points = np.asarray(points, dtype=float)
    inside = np.zeros(len(points), dtype=bool)
    for ring in _polygon_rings(polygon_mask):
        x0, y0 = ring[:-1, 0], ring[:-1, 1]
        x1, y1 = ring[1:, 0], ring[1:, 1]
        px = points[:, 0][:, None]
        py = points[:, 1][:, None]
        cond = (y0[None, :] > py) != (y1[None, :] > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x0[None, :] + (py - y0[None, :]) * (x1 - x0)[None, :] / (y1 - y0)[None, :]
        crossings = np.sum(cond & (px < xint), axis=1)
        inside ^= (crossings % 2).astype(bool)
    return inside


def mask_graph(
    sdata: Any,
    table_key: str,
    polygon_mask: Any,
    negative_mask: bool = False,
    spatial_key: str = Key.obsm.spatial,
    key_added: str = "mask",
    copy: bool = False,
) -> Any:
    """Mask the spatial graph to edges (not) contained in a polygon.

    ``polygon_mask`` may be a shapely (Multi)Polygon (duck-typed) or a raw
    ``(m, 2)`` ring coordinate array / list of rings. An edge counts as
    "within" when both endpoints and its midpoint lie inside the polygon.
    """
    neighs_key = Key.uns.spatial_neighs(spatial_key)
    conns_key = Key.obsp.spatial_conn(spatial_key)
    dists_key = Key.obsp.spatial_dist(spatial_key)

    table = extract_adata_if_sdata(sdata, table_key=table_key)
    coords = np.asarray(table.obsm[spatial_key])
    adj = table.obsp[conns_key].tocsr().copy()
    dst = table.obsp[dists_key].tocsr().copy()

    coo = adj.tocoo()
    src, dst_idx = coo.row, coo.col
    p_in = points_in_polygon(coords, polygon_mask)
    mid = (coords[src] + coords[dst_idx]) / 2.0
    mid_in = points_in_polygon(mid, polygon_mask)
    within = p_in[src] & p_in[dst_idx] & mid_in

    remove = within if negative_mask else ~within
    rm_src, rm_dst = src[remove], dst_idx[remove]
    adj[rm_src, rm_dst] = 0
    adj.eliminate_zeros()
    dst[rm_src, rm_dst] = 0
    dst.eliminate_zeros()

    mask_conns_key = f"{key_added}_{conns_key}"
    mask_dists_key = f"{key_added}_{dists_key}"
    mask_neighs_key = f"{key_added}_{neighs_key}"

    neighbors_dict = {
        "connectivities_key": mask_conns_key,
        "distances_key": mask_dists_key,
        "unfiltered_graph_key": conns_key,
        "params": {"negative_mask": negative_mask, "table_key": table_key},
    }

    if copy:
        return adj, dst

    _save_data(table, attr="obsp", key=mask_conns_key, data=adj)
    _save_data(table, attr="obsp", key=mask_dists_key, data=dst)
    _save_data(table, attr="uns", key=mask_neighs_key, data=neighbors_dict)
    return None
