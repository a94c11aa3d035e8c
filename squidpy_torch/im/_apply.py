"""Chunked / halo apply engine behind :meth:`ImageContainer.apply` (copy of
``squidpy_tpu/im/_apply.py``).

The reference routes ``apply(chunks=...)`` through dask ``map_blocks`` /
``map_overlap`` (squidpy/im/_container.py:1131-1139);
here the same semantics run as an explicit tile loop over numpy views:

- ``chunks`` fixes a GLOBAL tile grid anchored at (0, 0),
- ``depth`` extends every tile by a halo, reflect-padded at image borders
  (the reference's ``boundary='reflect'`` default),
- the function is applied per padded tile, the halo trimmed off the result.

Peak memory is the output plus ONE padded tile — a WSI-sized layer streams
instead of materializing intermediate full-image copies. ``lazy=True`` defers
via :class:`DeferredApply`, whose window reads compute only the grid tiles
intersecting the request (so a spot crop from an applied multi-gigapixel
layer touches a few tiles, mirroring :class:`squidpy_torch.im._io.LazyImage`).

Because tiles are anchored to the global grid, windowed results are bitwise
identical to the full computation; like dask's ``map_overlap``, correctness
vs the unchunked path requires ``func``'s support radius ≤ ``depth``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np

__all__ = ["DeferredApply", "normalize_chunks", "normalize_depth", "tile_apply"]


def normalize_chunks(chunks: Any, shape: tuple[int, int]) -> tuple[int, int]:
    """dask-style ``chunks`` → a (cy, cx) tile size."""
    if isinstance(chunks, str):
        if chunks != "auto":
            raise ValueError(f"Unknown chunks specification `{chunks}`.")
        return (min(2048, shape[0]), min(2048, shape[1]))
    if isinstance(chunks, (int, np.integer)):
        return (int(chunks), int(chunks))
    if isinstance(chunks, Mapping):
        return (int(chunks.get(0, shape[0])), int(chunks.get(1, shape[1])))
    if isinstance(chunks, Sequence) and len(chunks) >= 2:
        return (int(chunks[0]), int(chunks[1]))
    raise ValueError(f"Unable to interpret chunks `{chunks!r}`.")


def normalize_depth(depth: Any) -> tuple[int, int]:
    """dask-style ``depth`` (int / dict / tuple) → a (dy, dx) halo."""
    if depth is None:
        return (0, 0)
    if isinstance(depth, (int, np.integer)):
        return (int(depth), int(depth))
    if isinstance(depth, Mapping):
        return (int(depth.get(0, 0)), int(depth.get(1, 0)))
    if isinstance(depth, Sequence) and len(depth) >= 2:
        return (int(depth[0]), int(depth[1]))
    raise ValueError(f"Unable to interpret depth `{depth!r}`.")


def _apply_one_tile(
    plane: Any,
    func: Callable[..., Any],
    fn_kwargs: Mapping[str, Any],
    y0: int,
    y1: int,
    x0: int,
    x1: int,
    dy: int,
    dx: int,
    boundary: str,
) -> np.ndarray:
    """Run ``func`` on the halo-extended tile ``[y0:y1, x0:x1]``; return the
    trimmed (y1-y0, x1-x0, c_out) result."""
    H, W = plane.shape[:2]
    ys0, xs0 = max(y0 - dy, 0), max(x0 - dx, 0)
    ys1, xs1 = min(y1 + dy, H), min(x1 + dx, W)
    tile = np.asarray(plane[ys0:ys1, xs0:xs1])
    pad_y = (dy - (y0 - ys0), dy - (ys1 - y1))
    pad_x = (dx - (x0 - xs0), dx - (xs1 - x1))
    if any(pad_y) or any(pad_x):
        tile = np.pad(tile, (pad_y, pad_x, (0, 0)), mode=boundary)
    res = np.asarray(func(tile.squeeze(), **fn_kwargs))
    if res.ndim == 2:
        res = res[:, :, None]
    if res.shape[:2] != tile.shape[:2]:
        raise ValueError(
            f"Chunked `apply` requires a shape-preserving function; tile of shape "
            f"`{tile.shape[:2]}` produced `{res.shape[:2]}`."
        )
    return res[dy : dy + (y1 - y0), dx : dx + (x1 - x0)]


def tile_apply(
    plane: Any,
    func: Callable[..., Any],
    fn_kwargs: Mapping[str, Any],
    chunks: tuple[int, int],
    depth: tuple[int, int],
    boundary: str = "reflect",
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Apply ``func`` over a (y, x, c) plane tile by tile (global grid)."""
    H, W = plane.shape[:2]
    cy, cx = chunks
    dy, dx = depth
    for y0 in range(0, H, cy):
        for x0 in range(0, W, cx):
            y1, x1 = min(y0 + cy, H), min(x0 + cx, W)
            res = _apply_one_tile(plane, func, fn_kwargs, y0, y1, x0, x1, dy, dx, boundary)
            if out is None:
                out = np.empty((H, W, res.shape[2]), dtype=res.dtype)
            out[y0:y1, x0:x1] = res
    return out if out is not None else np.empty((H, W, 0))


class DeferredApply:
    """Lazy result of a chunked :meth:`ImageContainer.apply`.

    Array-like over ``(y, x, z, c_out)``: contiguous 2D window slices compute
    only the global-grid tiles intersecting the window; any other access
    materializes (and caches) the full result via the bounded tile loop.
    ``planes`` has one ``(source_z, func)`` entry per KEPT output z-plane —
    ``func=None`` = identity passthrough (zero-filled when the applied planes
    changed the channel count, matching the eager path).
    """

    def __init__(
        self,
        arr: Any,  # (y, x, z, c) source
        planes: Sequence[tuple[int, Callable[..., Any] | None]],
        fn_kwargs: Mapping[str, Any],
        chunks: tuple[int, int],
        depth: tuple[int, int],
        boundary: str = "reflect",
    ):
        self._arr = arr
        self._planes = list(planes)
        self._fn_kwargs = dict(fn_kwargs)
        self._chunks = chunks
        self._depth = depth
        self._boundary = boundary
        self._data: np.ndarray | None = None

        # probe ONE tile of the first applied plane for output channels/dtype
        first = next(((zi, f) for zi, f in self._planes if f is not None), None)
        if first is None:
            c_out, dtype = arr.shape[3], arr.dtype
        else:
            cy, cx = chunks
            probe = _apply_one_tile(
                arr[:, :, first[0], :], first[1], self._fn_kwargs,
                0, min(cy, arr.shape[0]), 0, min(cx, arr.shape[1]),
                depth[0], depth[1], boundary,
            )
            c_out, dtype = probe.shape[2], probe.dtype
        self.shape: tuple[int, int, int, int] = (arr.shape[0], arr.shape[1], len(self._planes), c_out)
        self.dtype = np.dtype(dtype)

    @property
    def ndim(self) -> int:
        return 4

    def _plane_window(self, zi: int, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
        """(y1-y0, x1-x0, c_out) of output plane ``zi`` — grid tiles only."""
        src_z, func = self._planes[zi]
        src = self._arr[:, :, src_z, :]
        if func is None:
            if src.shape[2] == self.shape[3]:
                return np.asarray(src[y0:y1, x0:x1])
            return np.zeros((y1 - y0, x1 - x0, self.shape[3]), dtype=self.dtype)
        cy, cx = self._chunks
        dy, dx = self._depth
        out = np.empty((y1 - y0, x1 - x0, self.shape[3]), dtype=self.dtype)
        for ty in range((y0 // cy) * cy, y1, cy):
            for tx in range((x0 // cx) * cx, x1, cx):
                ty1 = min(ty + cy, self.shape[0])
                tx1 = min(tx + cx, self.shape[1])
                res = _apply_one_tile(
                    src, func, self._fn_kwargs, ty, ty1, tx, tx1, dy, dx, self._boundary
                )
                iy0, iy1 = max(ty, y0), min(ty1, y1)
                ix0, ix1 = max(tx, x0), min(tx1, x1)
                out[iy0 - y0 : iy1 - y0, ix0 - x0 : ix1 - x0] = res[
                    iy0 - ty : iy1 - ty, ix0 - tx : ix1 - tx
                ]
        return out

    @staticmethod
    def _bounds(sl: Any, size: int) -> tuple[int, int] | None:
        if isinstance(sl, slice) and sl.step in (None, 1):
            start, stop, _ = sl.indices(size)
            return start, stop
        return None

    def __getitem__(self, item: Any) -> np.ndarray:
        if self._data is None and isinstance(item, tuple) and len(item) >= 2:
            ys = self._bounds(item[0], self.shape[0])
            xs = self._bounds(item[1], self.shape[1])
            if ys is not None and xs is not None:
                planes = [
                    self._plane_window(zi, ys[0], ys[1], xs[0], xs[1])
                    for zi in range(self.shape[2])
                ]
                window = np.stack(planes, axis=2)
                rest = item[2:]
                return window[(slice(None), slice(None), *rest)] if rest else window
        return self.compute()[item]

    def compute(self) -> np.ndarray:
        """Materialize (and cache) the full (y, x, z, c_out) result."""
        if self._data is None:
            H, W, Z, C = self.shape
            out = np.empty(self.shape, dtype=self.dtype)
            for zi in range(Z):
                src_z, func = self._planes[zi]
                src = self._arr[:, :, src_z, :]
                if func is None:
                    out[:, :, zi, :] = (
                        np.asarray(src) if src.shape[2] == C
                        else np.zeros((H, W, C), dtype=self.dtype)
                    )
                else:
                    tile_apply(
                        src, func, self._fn_kwargs, self._chunks, self._depth,
                        self._boundary, out=out[:, :, zi, :],
                    )
            self._data = out
        return self._data

    def __array__(self, dtype: Any = None) -> np.ndarray:
        arr = self.compute()
        return arr.astype(dtype) if dtype is not None else arr
