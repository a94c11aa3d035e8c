"""AnnData key conventions of the ported slice (copy of ``squidpy_tpu/_constants/_pkg_constants.py``).

Results land under the same ``obsp``/``obsm``/``uns`` keys as ``squidpy_tpu``.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

from squidpy_torch._constants._constants import Processing, SegmentationBackend


class Key:
    class img:
        coords = "coords"
        padding = "padding"
        scale = "scale"
        mask_circle = "mask_circle"
        obs = "cell"

        @classmethod
        def segment(cls, backend: str | SegmentationBackend, layer_added: str | None = None) -> str:
            return f"segmented_{SegmentationBackend(backend).s}" if layer_added is None else layer_added

        @classmethod
        def process(
            cls, method: str | Processing | Callable[[Any], Any], img_id: str, layer_added: str | None = None
        ) -> str:
            if layer_added is not None:
                return layer_added
            if isinstance(method, Processing):
                method = method.s
            elif callable(method):
                method = getattr(method, "__name__", "custom")
            return f"{img_id}_{method}"

    class obsm:
        spatial = "spatial"

    class uns:
        spatial = "spatial"  # Visium metadata: its presence makes the `spatial_neighbors` facade pick a grid
        image_key = "images"  # the readers' images of a library, under uns['spatial'][library_id]
        scalefactor_key = "scalefactors"
        size_key = "spot_diameter_fullres"

        @classmethod
        def spot_diameter(
            cls,
            adata: Any,
            spatial_key: str,
            library_id: str | None = None,
            spot_diameter_key: str = "spot_diameter_fullres",
        ) -> float:
            try:
                return float(adata.uns[spatial_key][library_id]["scalefactors"][spot_diameter_key])
            except KeyError:
                raise KeyError(
                    f"Unable to get the spot diameter from "
                    f"`adata.uns[{spatial_key!r}][{library_id!r}]['scalefactors'][{spot_diameter_key!r}].`"
                ) from None

        @classmethod
        def library_id(
            cls,
            adata: Any,
            spatial_key: str,
            library_id: Sequence[str] | str | None = None,
            return_all: bool = False,
        ) -> Sequence[str] | str | None:
            library_id = cls._sort_haystack(adata, spatial_key, library_id)
            if return_all or library_id is None:
                return library_id
            if len(library_id) != 1:
                raise ValueError(
                    f"Unable to determine which library id to use. Please specify one from: `{sorted(library_id)}`."
                )
            return library_id[0]

        @classmethod
        def _sort_haystack(
            cls, adata: Any, spatial_key: str, library_id: Sequence[str] | str | None = None
        ) -> Sequence[str] | None:
            if spatial_key not in adata.uns:
                raise KeyError(f"Spatial key {spatial_key!r} not found in `adata.uns`.")
            haystack = list(adata.uns[spatial_key])
            if library_id is not None:
                if isinstance(library_id, str):
                    library_id = [library_id]
                if not any(i in library_id for i in haystack):
                    raise KeyError(f"`library_id`: {library_id}` not found in `{sorted(haystack)}`.")
                return library_id
            return haystack

        @classmethod
        def spatial_neighs(cls, value: str | None = None) -> str:
            return f"{Key.obsm.spatial}_neighbors" if value is None else f"{value}_neighbors"

        @classmethod
        def ligrec(cls, cluster: str, value: str | None = None) -> str:
            return f"{cluster}_ligrec" if value is None else value

        @classmethod
        def nhood_enrichment(cls, cluster: str) -> str:
            return f"{cluster}_nhood_enrichment"

        @classmethod
        def centrality_scores(cls, cluster: str) -> str:
            return f"{cluster}_centrality_scores"

        @classmethod
        def interaction_matrix(cls, cluster: str) -> str:
            return f"{cluster}_interactions"

        @classmethod
        def co_occurrence(cls, cluster: str) -> str:
            return f"{cluster}_co_occurrence"

        @classmethod
        def ripley(cls, cluster: str, mode: str) -> str:
            return f"{cluster}_ripley_{mode}"

    class obsp:
        @staticmethod
        def _spatial_key(value: str | None, suffix: str) -> str:
            if value is None:
                return f"{Key.obsm.spatial}_{suffix}"
            if value.endswith(f"_{suffix}"):
                return value
            return f"{value}_{suffix}"

        @classmethod
        def spatial_dist(cls, value: str | None = None) -> str:
            return cls._spatial_key(value, "distances")

        @classmethod
        def spatial_conn(cls, value: str | None = None) -> str:
            return cls._spatial_key(value, "connectivities")
