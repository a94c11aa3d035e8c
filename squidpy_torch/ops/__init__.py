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
  :func:`squidpy_torch.ops.knn.nearest_points`;
- :mod:`squidpy_torch.ops.ligrec` — K9, ligrec's permutation counts (``csrc/ligrec_perms.cu``);
- :mod:`squidpy_torch._core.rng` — K10, the threefry shuffles (``csrc/threefry.cu``);
- :mod:`squidpy_torch.ops.sepal` — K11, sepal's diffusion (``csrc/sepal.cu``);
- :mod:`squidpy_torch.ops.knn` — K12, the exact feature-space kNN of the niches (``csrc/feature_knn.cu``),
  :func:`squidpy_torch.ops.knn.feature_knn`, its exact route on listed rows
  (:func:`squidpy_torch.ops.knn.feature_knn_rows`) and the full sweep behind the IVF's fallback
  (:func:`squidpy_torch.ops.knn.brute_force_knn_approx`);
- :mod:`squidpy_torch.ops.ivf_knn` — the IVF kNN of the niches' clustering graphs above 200k rows: K14,
  k-means' nearest centroids and update (``csrc/ivf_kmeans.cu``), K15, the cluster search
  (``csrc/ivf_search.cu``), K16, the refine pass (``csrc/ivf_refine.cu``); :func:`squidpy_torch.ops.ivf_knn.ivf_knn`,
  :func:`squidpy_torch.ops.ivf_knn.kmeans_device`, :func:`squidpy_torch.ops.ivf_knn.sampled_recall`;
- :mod:`squidpy_torch.ops.hops` — K13, the k-hop ring and reach expansion (``csrc/hops.cu``);
- :mod:`squidpy_torch.ops.pca`, :mod:`squidpy_torch.ops.gmm` — the niches' PCA and GMM, torch library calls.
"""
