"""Device compute: plain torch code and the wrappers of the hand-written CUDA kernels.

- :mod:`squidpy_torch.ops.binned_kernel` — K1, binned pair counts (``csrc/binned_pairs.cu``);
- :mod:`squidpy_torch.ops.nhood` — K3, cluster-pair counts (``csrc/pair_counts.cu``);
- :mod:`squidpy_torch._core.index_cipher` — K4, cipher shuffles (``csrc/index_cipher.cu``).
"""
