"""Device compute: plain torch code and the wrappers of the hand-written CUDA kernels.

- :mod:`squidpy_torch.ops.binned_kernel` — K1, binned pair counts (``csrc/binned_pairs.cu``);
- :mod:`squidpy_torch.ops.nhood` — K3, cluster-pair counts (``csrc/pair_counts.cu``);
- :mod:`squidpy_torch._core.index_cipher` — K4, cipher shuffles (``csrc/index_cipher.cu``);
- :mod:`squidpy_torch.ops.dense_pairs` — K2, dense pair counts (``csrc/dense_pairs.cu``);
- :mod:`squidpy_torch.ops.autocorr` — K5a, ELL autocorrelation sums (``csrc/ell_autocorr.cu``), and
  K5b, permuted Moran/Geary numerators (``csrc/perm_autocorr.cu``);
- :mod:`squidpy_torch.ops.radius` — K6, the radius search (``csrc/radius_pairs.cu``), behind
  :func:`squidpy_torch.ops.knn.radius_neighbors` and :func:`squidpy_torch.ops.knn.radius_graph`;
- :mod:`squidpy_torch.ops.ripley` — K7, Ripley's cumulative pair counts (``csrc/ripley_pairs.cu``);
- :mod:`squidpy_torch.ops.knn` — K8, the cross nearest-neighbour search (``csrc/cross_knn.cu``),
  :func:`squidpy_torch.ops.knn.nearest_points`.
"""
