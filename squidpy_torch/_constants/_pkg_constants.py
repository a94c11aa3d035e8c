"""AnnData key conventions of the ported slice (copy of ``squidpy_tpu/_constants/_pkg_constants.py``).

Results land under the same ``obsp``/``obsm``/``uns`` keys as ``squidpy_tpu``.
"""

from __future__ import annotations


class Key:
    class obsm:
        spatial = "spatial"

    class uns:
        spatial = "spatial"  # Visium metadata: its presence makes the `spatial_neighbors` facade pick a grid

        @classmethod
        def spatial_neighs(cls, value: str | None = None) -> str:
            return f"{Key.obsm.spatial}_neighbors" if value is None else f"{value}_neighbors"

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
