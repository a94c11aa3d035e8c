"""Minimal pure-Python zarr v2 store, xarray-compatible layout (copy of
``squidpy_tpu/im/_zarr.py``).

Writes and reads the zarr v2 on-disk format directly: a directory of JSON
metadata (``.zgroup``, ``.zarray``, ``.zattrs``) plus a binary file a chunk,
with xarray's ``_ARRAY_DIMENSIONS`` attribute on each array. Stores written
here open with real ``zarr``/``xarray`` (and vice versa for the supported
subset: C-order arrays, zlib or no compression, no filters). Host numpy,
zlib and json only.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Any, Union

import numpy as np

__all__ = ["write_group", "read_group", "is_zarr_store"]

Pathlike_t = Union[str, Path]

_ZARR_FORMAT = 2


def is_zarr_store(path: Pathlike_t) -> bool:
    p = Path(path)
    return p.is_dir() and ((p / ".zgroup").exists() or (p / ".zarray").exists())


def _dtype_str(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    if dt.byteorder == "=":
        dt = dt.newbyteorder("<") if dt.itemsize > 1 else dt
    s = dt.str
    return s if s[0] in "<>|" else "|" + s


def _chunk_grid(shape: tuple[int, ...], chunks: tuple[int, ...]):
    from itertools import product

    ranges = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    return product(*ranges)


def write_array(
    root: Path,
    name: str,
    arr: np.ndarray,
    *,
    dims: tuple[str, ...] | None = None,
    attrs: dict[str, Any] | None = None,
    chunks: tuple[int, ...] | None = None,
    compress: bool = True,
) -> None:
    arr = np.ascontiguousarray(arr)
    adir = root / name
    adir.mkdir(parents=True, exist_ok=True)
    if chunks is None:
        # one chunk per array unless large: cap chunk bytes at ~64 MB by
        # splitting the leading axis
        chunks = list(arr.shape) or [1]
        if arr.nbytes > 64 << 20 and arr.shape:
            lead = max(1, arr.shape[0] * (64 << 20) // arr.nbytes)
            chunks[0] = int(lead)
        # zero-length dims must still get chunk extent >= 1 (the spec requires
        # positive chunk shapes; a 0 would also divide-by-zero the grid walk)
        chunks = tuple(max(1, int(c)) for c in chunks)
    meta = {
        "zarr_format": _ZARR_FORMAT,
        "shape": list(arr.shape),
        "chunks": list(chunks),
        "dtype": _dtype_str(arr.dtype),
        "compressor": {"id": "zlib", "level": 1} if compress else None,
        "fill_value": 0,
        "order": "C",
        "filters": None,
    }
    (adir / ".zarray").write_text(json.dumps(meta, indent=2))
    zattrs = dict(attrs or {})
    if dims is not None:
        zattrs["_ARRAY_DIMENSIONS"] = list(dims)
    (adir / ".zattrs").write_text(json.dumps(zattrs, indent=2))

    if not arr.shape:
        data = arr.tobytes()
        (adir / "0").write_bytes(zlib.compress(data, 1) if compress else data)
        return
    for idx in _chunk_grid(arr.shape, chunks):
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        block = arr[sl]
        # zarr chunks are padded to full chunk shape at the edges
        if block.shape != tuple(chunks):
            full = np.zeros(chunks, dtype=arr.dtype)
            full[tuple(slice(0, s) for s in block.shape)] = block
            block = full
        data = np.ascontiguousarray(block).tobytes()
        (adir / ".".join(map(str, idx))).write_bytes(
            zlib.compress(data, 1) if compress else data
        )


def read_array(adir: Path) -> tuple[np.ndarray, dict[str, Any]]:
    meta = json.loads((adir / ".zarray").read_text())
    if meta.get("zarr_format") != _ZARR_FORMAT:
        raise ValueError(f"Unsupported zarr format {meta.get('zarr_format')}.")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise NotImplementedError("Only C-order, filter-free zarr arrays are supported.")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") not in ("zlib", "gzip"):
        raise NotImplementedError(f"Unsupported zarr compressor {comp.get('id')!r}.")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    out = np.full(shape if shape else (1,), meta.get("fill_value") or 0, dtype=dtype)
    if not shape:
        raw = (adir / "0").read_bytes()
        # wbits=47 auto-detects both zlib and gzip framing (numcodecs' GZip
        # codec writes gzip headers that plain zlib.decompress rejects)
        data = zlib.decompress(raw, 47) if comp else raw
        return np.frombuffer(data, dtype=dtype)[0], _read_attrs(adir)
    sep = "." if any((adir / ".".join(map(str, idx))).exists() for idx in _chunk_grid(shape, chunks)) else "/"
    for idx in _chunk_grid(shape, chunks):
        cpath = adir / sep.join(map(str, idx))
        if not cpath.exists():
            continue  # missing chunk = fill_value
        raw = cpath.read_bytes()
        data = zlib.decompress(raw, 47) if comp else raw
        block = np.frombuffer(data, dtype=dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out, _read_attrs(adir)


def _read_attrs(d: Path) -> dict[str, Any]:
    f = d / ".zattrs"
    return json.loads(f.read_text()) if f.exists() else {}


def write_group(
    path: Pathlike_t,
    arrays: dict[str, np.ndarray],
    *,
    group_attrs: dict[str, Any] | None = None,
    dims: dict[str, tuple[str, ...]] | None = None,
) -> None:
    """Write a flat zarr group: one array per key, group-level attributes."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    (root / ".zgroup").write_text(json.dumps({"zarr_format": _ZARR_FORMAT}, indent=2))
    (root / ".zattrs").write_text(json.dumps(group_attrs or {}, indent=2))
    for name, arr in arrays.items():
        write_array(root, name, np.asarray(arr), dims=(dims or {}).get(name))


def read_group(path: Pathlike_t) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """Read a flat zarr group; returns ``(arrays, group_attrs)``."""
    root = Path(path)
    if not (root / ".zgroup").exists():
        raise ValueError(f"`{path}` is not a zarr group.")
    arrays: dict[str, np.ndarray] = {}
    for child in sorted(root.iterdir()):
        if child.is_dir() and (child / ".zarray").exists():
            arrays[child.name], _ = read_array(child)
    return arrays, _read_attrs(root)
