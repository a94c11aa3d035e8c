"""Clustering and embedding backends of the niche detection (counterpart of ``squidpy_tpu/models``)."""

from squidpy_torch.models.clustering import gmm_cluster, graph_cluster, knn_graph, pca_embed, zscore

__all__ = ["gmm_cluster", "graph_cluster", "knn_graph", "pca_embed", "zscore"]
