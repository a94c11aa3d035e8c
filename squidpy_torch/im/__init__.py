"""The image module of the port. It holds only the zarr v2 store
(:mod:`squidpy_torch.im._zarr`) that ``SpatialData`` persists through; the
image container comes later."""

__all__: list[str] = []
