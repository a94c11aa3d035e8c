"""Image file probing and lazy loading (copy of ``squidpy_tpu/im/_io.py``).

Functional counterpart of squidpy/im/_io.py:28-251:
header-only shape/dtype probing, dimension inference to the canonical
``(y, x, z, channels)`` layout, and lazy whole-file loading (the reference
wraps a delayed read in a dask array; here a zero-copy callable/memmap-backed
``LazyImage`` defers the pixel read until sliced).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Union

import numpy as np

from squidpy_torch._constants._constants import InferDimensions
from squidpy_torch._device import NDArrayA

__all__ = ["LazyImage", "_infer_shape_dtype", "_infer_dimensions", "_lazy_load_image"]

Pathlike_t = Union[str, Path]


def _infer_shape_dtype(path: Pathlike_t) -> tuple[tuple[int, ...], np.dtype]:
    """Probe an image file's shape and dtype from its header (no pixel read).

    TIFFs go through the in-repo container parser (also handles BigTIFF and
    reports the shape without touching pixel data); everything else through
    PIL's header probe.
    """
    from squidpy_torch.im._tiff import TiffReader, is_tiff

    if is_tiff(path):
        pages = TiffReader(path).pages
        if len(pages) > 1 and len({p.shape for p in pages}) == 1:
            # matches the loaders (_open_image_file): equal-shaped GRAYSCALE
            # pages are channels-last (y, x, pages); pages that already carry
            # channels stack on a leading axis (pages, y, x, c)
            if len(pages[0].shape) == 2:
                return (*pages[0].shape, len(pages)), np.dtype(pages[0].dtype.newbyteorder("="))
            return (len(pages), *pages[0].shape), np.dtype(pages[0].dtype.newbyteorder("="))
        return pages[0].shape, np.dtype(pages[0].dtype.newbyteorder("="))

    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None
    with Image.open(str(path)) as img:
        w, h = img.size
        n_frames = getattr(img, "n_frames", 1)
        bands = len(img.getbands())
        mode_dtypes = {"1": np.bool_, "L": np.uint8, "P": np.uint8, "RGB": np.uint8,
                       "RGBA": np.uint8, "I": np.int32, "I;16": np.uint16, "F": np.float32}
        dtype = np.dtype(mode_dtypes.get(img.mode, np.uint8))
    if n_frames > 1:
        # same convention as the loaders: grayscale frames are channels-last
        if bands > 1:
            return (n_frames, h, w, bands), dtype
        return (h, w, n_frames), dtype
    return (h, w) + ((bands,) if bands > 1 else ()), dtype


def _infer_dimensions(
    shape: tuple[int, ...],
    infer_dimensions: str | InferDimensions = InferDimensions.DEFAULT,
) -> tuple[int, ...]:
    """Map an arbitrary 2-4D shape onto the canonical (y, x, z, channels) axes.

    Returns the permutation of input axes (with -1 marking inserted singleton
    axes), following the reference's heuristics (im/_io.py:101-180): smallest
    trailing dims are channels, `z_last`/`channels_last` force the ambiguous
    axis.
    """
    infer_dimensions = InferDimensions(infer_dimensions)
    ndim = len(shape)
    if ndim == 2:
        return (0, 1, -1, -1)  # (y, x) -> (y, x, 1, 1)
    if ndim == 3:
        # one extra axis: channels or z; smallest axis is the candidate
        extra = int(np.argmin(shape))
        spatial = [i for i in range(3) if i != extra]
        if infer_dimensions == InferDimensions.Z_LAST:
            return (spatial[0], spatial[1], extra, -1)
        return (spatial[0], spatial[1], -1, extra)
    if ndim == 4:
        order = np.argsort(shape)
        small1, small2 = int(order[0]), int(order[1])
        spatial = [i for i in range(4) if i not in (small1, small2)]
        # of the two small axes, the earlier is z and the later channels
        z, c = sorted((small1, small2))
        if infer_dimensions == InferDimensions.Z_LAST:
            z, c = c, z
        return (spatial[0], spatial[1], z, c)
    raise ValueError(f"Expected image with 2-4 dimensions, found `{ndim}`.")


class LazyImage:
    """Defers the pixel read until first access; slices read-through.

    For TIFFs with a supported encoding, 2D window slices decode ONLY the
    strips/tiles intersecting the window (the WSI case: a spot crop from a
    multi-gigapixel slide reads a few tiles, never the slide) — the
    counterpart of the reference's tifffile-zarr lazy store
    (squidpy/im/_io.py:215-251).
    """

    def __init__(self, path: Pathlike_t):
        self._path = str(path)
        self.shape, self.dtype = _infer_shape_dtype(path)
        self._data: NDArrayA | None = None
        self._windowed = False
        from squidpy_torch.im._tiff import TiffReader, is_tiff

        if is_tiff(path):
            reader = TiffReader(path)
            # windowed reads only for the single-page case (multi-page stacks
            # have a leading page axis; rare enough to load eagerly)
            if len(reader.pages) == 1 and reader.pages[0].supported:
                self._reader = reader
                self._windowed = True

    def _load(self) -> NDArrayA:
        if self._data is None:
            if self._windowed:
                self._data = self._reader.read_full()
            else:
                from squidpy_torch.im._container import _open_image_file

                self._data = _open_image_file(self._path)
        return self._data

    @staticmethod
    def _bounds(sl: Any, size: int) -> tuple[int, int] | None:
        if isinstance(sl, slice) and sl.step in (None, 1):
            start, stop, _ = sl.indices(size)
            return start, stop
        return None

    def __getitem__(self, item: Any) -> NDArrayA:
        if self._windowed and self._data is None and isinstance(item, tuple) and len(item) >= 2:
            # `image[..., y0:y1, x0:x1]` (2D lazy page) windows like
            # `image[y0:y1, x0:x1]` — extract_tile uses the ellipsis form
            if item[0] is Ellipsis and len(item) == 3 and len(self.shape) == 2:
                item = item[1:]
            ys = self._bounds(item[0], self.shape[0])
            xs = self._bounds(item[1], self.shape[1])
            if ys is not None and xs is not None:
                region = self._reader.read_region(ys[0], ys[1], xs[0], xs[1])
                rest = item[2:]
                return region[(slice(None), slice(None), *rest)] if rest else region
        return self._load()[item]

    def __array__(self, dtype: Any = None) -> NDArrayA:
        arr = self._load()
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _lazy_load_image(path: Pathlike_t, infer_dimensions: str = "default") -> LazyImage:
    """Lazily open an image file (pixel data is read on first slice)."""
    return LazyImage(path)
