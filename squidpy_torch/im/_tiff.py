"""Minimal pure-Python TIFF reader/writer with lazy windowed reads (copy of
``squidpy_tpu/im/_tiff.py``).

The reference probes and lazily reads TIFF through ``tifffile``
(squidpy/im/_io.py:28-101 header probe, :215-251 lazy
load); tifffile is not a dependency here, and PIL can only decode
whole frames. This module parses the TIFF/BigTIFF container directly so a
WSI-scale slide can serve **windowed region reads** — only the strips/tiles
intersecting the requested window are read and decoded, which is what the
experimental tile pipeline needs (``extract_tile`` slices before
materializing).

Supported: classic (II/MM, magic 42) and BigTIFF (43); stripped and tiled
layouts; 8/16/32-bit unsigned, 8-bit signed, and 32/64-bit float samples;
contiguous (chunky) and separate (planar) sample layouts; compressions
none (1), deflate (8 / 32946) and PackBits (32773), with the horizontal
differencing predictor (2). Anything else falls back to a PIL whole-frame
decode in the caller. The writer emits classic or BigTIFF, stripped or
tiled, uncompressed or deflate — enough to round-trip WSI-style fixtures.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Union

import numpy as np

__all__ = ["TiffReader", "TiffPage", "write_tiff", "is_tiff"]

Pathlike_t = Union[str, Path]

# tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339

# field type -> (struct code, size)
_TYPES = {
    1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8),
}

_SUPPORTED_COMPRESSIONS = {1, 8, 32773, 32946}


def is_tiff(path: Pathlike_t) -> bool:
    try:
        with open(path, "rb") as fh:
            head = fh.read(4)
    except OSError:
        return False
    return head[:2] in (b"II", b"MM") and len(head) == 4 and head[2:4] in (
        b"\x2a\x00", b"\x00\x2a", b"\x2b\x00", b"\x00\x2b"
    )


@dataclass
class TiffPage:
    """One IFD: geometry, sample layout, and chunk (strip/tile) directory."""

    width: int
    height: int
    samples: int
    dtype: np.dtype
    compression: int
    predictor: int
    planar: int  # 1 = chunky (interleaved), 2 = separate planes
    tile_width: int | None
    tile_length: int | None
    rows_per_strip: int
    offsets: tuple[int, ...]
    byte_counts: tuple[int, ...]
    photometric: int = 1
    _tags: dict[int, tuple] = field(default_factory=dict, repr=False)

    @property
    def tiled(self) -> bool:
        return self.tile_width is not None

    @property
    def shape(self) -> tuple[int, ...]:
        if self.samples > 1:
            return (self.height, self.width, self.samples)
        return (self.height, self.width)

    @property
    def supported(self) -> bool:
        return self.compression in _SUPPORTED_COMPRESSIONS


def _decompress(raw: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.decompress(raw)
    if compression == 32773:  # PackBits
        out = bytearray()
        i, n = 0, len(raw)
        while i < n and len(out) < expected:
            h = raw[i]
            i += 1
            if h < 128:
                out += raw[i : i + h + 1]
                i += h + 1
            elif h > 128:
                out += raw[i : i + 1] * (257 - h)
                i += 1
        return bytes(out)
    raise NotImplementedError(f"TIFF compression {compression} is not supported.")


def _undo_predictor(block: np.ndarray, predictor: int) -> np.ndarray:
    """Undo horizontal differencing on a (rows, cols, planes) chunk.

    The TIFF spec (6.0 §14) differences each sample COMPONENT against the
    same component of the previous pixel, so the cumulative sum runs along
    the column axis independently per interleaved plane — flattening
    cols*planes first would mix channels and corrupt RGB data.
    """
    if predictor == 2:
        return np.cumsum(block, axis=1, dtype=block.dtype)
    return block


class TiffReader:
    """Parses the IFD chain once; pixel data is read on demand per region."""

    def __init__(self, path: Pathlike_t):
        self._path = str(path)
        self.pages: list[TiffPage] = []
        with open(self._path, "rb") as fh:
            self._parse(fh)
        if not self.pages:
            raise ValueError(f"`{path}` contains no TIFF pages.")

    # -- parsing ----------------------------------------------------------
    def _parse(self, fh: BinaryIO) -> None:
        head = fh.read(8)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise ValueError("Not a TIFF file.")
        magic = struct.unpack(bo + "H", head[2:4])[0]
        if magic == 42:
            big = False
            (first_ifd,) = struct.unpack(bo + "I", head[4:8])
        elif magic == 43:
            big = True
            fh.seek(8)
            (first_ifd,) = struct.unpack(bo + "Q", fh.read(8))
        else:
            raise ValueError(f"Bad TIFF magic number {magic}.")
        self._bo, self._big = bo, big

        off = first_ifd
        while off:
            off = self._parse_ifd(fh, off)

    def _parse_ifd(self, fh: BinaryIO, offset: int) -> int:
        bo, big = self._bo, self._big
        fh.seek(offset)
        n_fmt, cnt_fmt, entry_sz, inline = ("Q", "Q", 20, 8) if big else ("H", "I", 12, 4)
        (n_entries,) = struct.unpack(bo + n_fmt, fh.read(struct.calcsize(n_fmt)))
        entries = fh.read(n_entries * entry_sz)
        (next_off,) = struct.unpack(bo + ("Q" if big else "I"), fh.read(8 if big else 4))

        tags: dict[int, tuple] = {}
        deferred: list[tuple[int, int, int, int]] = []  # (tag, type, count, offset)
        for i in range(n_entries):
            e = entries[i * entry_sz : (i + 1) * entry_sz]
            tag, ftype = struct.unpack(bo + "HH", e[:4])
            (count,) = struct.unpack(bo + cnt_fmt, e[4 : 4 + struct.calcsize(cnt_fmt)])
            payload = e[4 + struct.calcsize(cnt_fmt) :]
            if ftype not in _TYPES:
                continue
            code, size = _TYPES[ftype]
            total = size * count * (2 if ftype in (5, 10) else 1)
            if total <= inline:
                tags[tag] = self._unpack_values(payload, ftype, count)
            else:
                (voff,) = struct.unpack(bo + ("Q" if big else "I"), payload[: 8 if big else 4])
                deferred.append((tag, ftype, count, voff))
        for tag, ftype, count, voff in deferred:
            code, size = _TYPES[ftype]
            total = size * count * (2 if ftype in (5, 10) else 1)
            fh.seek(voff)
            tags[tag] = self._unpack_values(fh.read(total), ftype, count)

        page = self._page_from_tags(tags)
        if page is not None:
            self.pages.append(page)
        return next_off

    def _unpack_values(self, raw: bytes, ftype: int, count: int) -> tuple:
        code, size = _TYPES[ftype]
        if ftype == 2:
            return (raw[: count].rstrip(b"\0").decode("ascii", "replace"),)
        if ftype in (5, 10):  # rationals: pairs
            flat = struct.unpack(self._bo + code[0] * 2 * count, raw[: size * 2 * count])
            return tuple(flat[i] / max(flat[i + 1], 1) for i in range(0, 2 * count, 2))
        return struct.unpack(self._bo + code * count, raw[: size * count])

    def _page_from_tags(self, tags: dict[int, tuple]) -> TiffPage | None:
        if _IMAGE_WIDTH not in tags or _IMAGE_LENGTH not in tags:
            return None
        width = int(tags[_IMAGE_WIDTH][0])
        height = int(tags[_IMAGE_LENGTH][0])
        samples = int(tags.get(_SAMPLES_PER_PIXEL, (1,))[0])
        bits = tags.get(_BITS_PER_SAMPLE, (8,))
        bit = int(bits[0])
        fmt = int(tags.get(_SAMPLE_FORMAT, (1,))[0])
        if fmt == 3:
            dtype = np.dtype(f"{self._bo}f{bit // 8}")
        elif fmt == 2:
            dtype = np.dtype(f"{self._bo}i{bit // 8}")
        else:
            dtype = np.dtype(f"{self._bo}u{bit // 8}")
        tiled = _TILE_OFFSETS in tags
        offsets = tags.get(_TILE_OFFSETS if tiled else _STRIP_OFFSETS, ())
        counts = tags.get(_TILE_BYTE_COUNTS if tiled else _STRIP_BYTE_COUNTS, ())
        if not offsets:
            return None
        return TiffPage(
            width=width,
            height=height,
            samples=samples,
            dtype=dtype,
            compression=int(tags.get(_COMPRESSION, (1,))[0]),
            predictor=int(tags.get(_PREDICTOR, (1,))[0]),
            planar=int(tags.get(_PLANAR_CONFIG, (1,))[0]),
            tile_width=int(tags[_TILE_WIDTH][0]) if tiled else None,
            tile_length=int(tags[_TILE_LENGTH][0]) if tiled else None,
            rows_per_strip=int(tags.get(_ROWS_PER_STRIP, (height,))[0]),
            offsets=tuple(int(o) for o in offsets),
            byte_counts=tuple(int(c) for c in counts),
            photometric=int(tags.get(_PHOTOMETRIC, (1,))[0]),
            _tags=tags,
        )

    # -- reading ----------------------------------------------------------
    def _chunk(self, fh: BinaryIO, page: TiffPage, index: int, rows: int, cols: int, planes: int) -> np.ndarray:
        """Decode chunk ``index`` to (rows, cols, planes)."""
        fh.seek(page.offsets[index])
        raw = fh.read(page.byte_counts[index])
        expected = rows * cols * planes * page.dtype.itemsize
        data = _decompress(raw, page.compression, expected)
        arr = np.frombuffer(data[:expected], dtype=page.dtype).reshape(rows, cols, planes)
        if page.predictor == 2:
            arr = _undo_predictor(arr, 2)
        return arr

    def read_region(self, y0: int, y1: int, x0: int, x1: int, page_index: int = 0) -> np.ndarray:
        """Read ``[y0:y1, x0:x1]`` decoding only intersecting strips/tiles."""
        page = self.pages[page_index]
        if not page.supported:
            raise NotImplementedError(f"TIFF compression {page.compression} is not supported.")
        y0, y1 = max(0, y0), min(page.height, y1)
        x0, x1 = max(0, x0), min(page.width, x1)
        h, w = max(0, y1 - y0), max(0, x1 - x0)
        n_planes = page.samples if page.planar == 2 else 1
        n_interleaved = 1 if page.planar == 2 else page.samples
        out = np.zeros((h, w, page.samples), dtype=page.dtype)

        with open(self._path, "rb") as fh:
            if page.tiled:
                tw, tl = page.tile_width, page.tile_length
                tiles_x = -(-page.width // tw)
                tiles_y = -(-page.height // tl)
                for plane in range(n_planes):
                    for ty in range(y0 // tl, -(-y1 // tl) if y1 else 0):
                        for tx in range(x0 // tw, -(-x1 // tw) if x1 else 0):
                            idx = plane * tiles_y * tiles_x + ty * tiles_x + tx
                            tile = self._chunk(fh, page, idx, tl, tw, n_interleaved)
                            oy0, ox0 = ty * tl, tx * tw
                            sy0, sx0 = max(y0 - oy0, 0), max(x0 - ox0, 0)
                            sy1 = min(y1 - oy0, tl)
                            sx1 = min(x1 - ox0, tw)
                            dst = out[oy0 + sy0 - y0 : oy0 + sy1 - y0, ox0 + sx0 - x0 : ox0 + sx1 - x0]
                            if page.planar == 2:
                                dst[..., plane] = tile[sy0:sy1, sx0:sx1, 0]
                            else:
                                dst[...] = tile[sy0:sy1, sx0:sx1, :]
                    # tiles are padded to full size at image edges; handled by clipping
            else:
                rps = page.rows_per_strip
                strips_y = -(-page.height // rps)
                for plane in range(n_planes):
                    for sy in range(y0 // rps, -(-y1 // rps) if y1 else 0):
                        idx = plane * strips_y + sy
                        rows = min(rps, page.height - sy * rps)
                        strip = self._chunk(fh, page, idx, rows, page.width, n_interleaved)
                        oy0 = sy * rps
                        a0, a1 = max(y0 - oy0, 0), min(y1 - oy0, rows)
                        dst = out[oy0 + a0 - y0 : oy0 + a1 - y0, :, :]
                        if page.planar == 2:
                            dst[..., plane] = strip[a0:a1, x0:x1, 0]
                        else:
                            dst[...] = strip[a0:a1, x0:x1, :]

        if page.dtype.byteorder not in ("=", "|") and page.dtype.byteorder != np.dtype(np.int32).byteorder:
            out = out.astype(page.dtype.newbyteorder("="))
        if page.samples == 1:
            return out[..., 0]
        return out

    def read_full(self, page_index: int = 0) -> np.ndarray:
        page = self.pages[page_index]
        return self.read_region(0, page.height, 0, page.width, page_index)


def write_tiff(
    path: Pathlike_t,
    array: np.ndarray,
    *,
    tile: tuple[int, int] | None = None,
    compression: str | None = None,
    bigtiff: bool = False,
    predictor: int = 1,
) -> None:
    """Write a (y, x[, c]) array as classic (or Big) TIFF, stripped or tiled.

    ``compression``: ``None`` or ``"deflate"``. ``predictor=2`` applies
    horizontal differencing per sample component (TIFF 6.0 §14, integer
    dtypes only — typically shrinks deflate output on smooth imagery).
    Tiles are padded at edges as the spec requires.
    """
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"Expected a (y, x[, c]) array, got shape {array.shape}.")
    h, w, c = arr.shape
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    comp_id = {None: 1, "deflate": 8}[compression]
    if predictor not in (1, 2):
        raise ValueError(f"predictor must be 1 or 2, got {predictor}.")
    if predictor == 2 and arr.dtype.kind not in "ui":
        raise ValueError("predictor=2 (horizontal differencing) requires an integer dtype.")

    def _diff(block: np.ndarray) -> bytes:
        if predictor == 2:
            block = block.copy()
            # per-component difference along x; modular wrap matches the
            # reader's same-dtype cumsum
            block[:, 1:] = block[:, 1:] - block[:, :-1]
        return block.tobytes()

    chunks: list[bytes] = []
    rows_per_strip = h
    if tile is not None:
        tl, tw = tile
        if tl % 16 or tw % 16:
            raise ValueError("TIFF tile dimensions must be multiples of 16.")
        for y0 in range(0, h, tl):
            for x0 in range(0, w, tw):
                block = np.zeros((tl, tw, c), dtype=arr.dtype)
                sub = arr[y0 : y0 + tl, x0 : x0 + tw]
                block[: sub.shape[0], : sub.shape[1]] = sub
                chunks.append(_diff(block))
    else:
        rows_per_strip = max(1, min(h, max(1, (1 << 16) // max(w * c * arr.dtype.itemsize, 1))))
        for y0 in range(0, h, rows_per_strip):
            chunks.append(_diff(arr[y0 : y0 + rows_per_strip]))
    if comp_id == 8:
        chunks = [zlib.compress(b) for b in chunks]

    sample_format = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]
    bits = arr.dtype.itemsize * 8
    _write_container(
        path, chunks, h, w, c, bits, comp_id, sample_format, tile, rows_per_strip,
        big=bigtiff, predictor=predictor,
    )


def _write_container(
    path: Pathlike_t,
    chunks: list[bytes],
    h: int,
    w: int,
    c: int,
    bits: int,
    comp_id: int,
    sample_format: int,
    tile: tuple[int, int] | None,
    rows_per_strip: int,
    *,
    big: bool,
    predictor: int = 1,
) -> None:
    bo = "<"
    off_t, cnt_t, entry_sz, inline = ("Q", "Q", 20, 8) if big else ("I", "I", 12, 4)
    header_sz = 16 if big else 8

    # data layout: header | chunk data... | external arrays | IFD
    data_start = header_sz
    offsets, counts = [], []
    pos = data_start
    for b in chunks:
        offsets.append(pos)
        counts.append(len(b))
        pos += len(b)

    def entry(tag: int, ftype: int, count: int, values: list[int]) -> tuple[bytes, bytes | None]:
        code, size = _TYPES[ftype]
        total = size * count
        head = struct.pack(bo + "HH" + cnt_t, tag, ftype, count)
        payload = struct.pack(bo + code * count, *values)
        if total <= inline:
            return head + payload.ljust(inline, b"\0"), None
        return head, payload

    long_t = 16 if big else 4  # type for offsets (LONG8 / LONG)
    tags: list[tuple[int, int, int, list[int]]] = [
        (_IMAGE_WIDTH, 4, 1, [w]),
        (_IMAGE_LENGTH, 4, 1, [h]),
        (_BITS_PER_SAMPLE, 3, c, [bits] * c),
        (_COMPRESSION, 3, 1, [comp_id]),
        (_PHOTOMETRIC, 3, 1, [2 if c >= 3 else 1]),
        (_SAMPLES_PER_PIXEL, 3, 1, [c]),
        (_SAMPLE_FORMAT, 3, c, [sample_format] * c),
        (_PLANAR_CONFIG, 3, 1, [1]),
    ]
    if predictor != 1:
        tags.append((_PREDICTOR, 3, 1, [predictor]))
    if tile is not None:
        tl, tw = tile
        tags += [
            (_TILE_WIDTH, 3, 1, [tw]),
            (_TILE_LENGTH, 3, 1, [tl]),
            (_TILE_OFFSETS, long_t, len(offsets), offsets),
            (_TILE_BYTE_COUNTS, long_t, len(counts), counts),
        ]
    else:
        tags += [
            (_ROWS_PER_STRIP, 4, 1, [rows_per_strip]),
            (_STRIP_OFFSETS, long_t, len(offsets), offsets),
            (_STRIP_BYTE_COUNTS, long_t, len(counts), counts),
        ]
    tags.sort(key=lambda t: t[0])

    # external payloads come after chunk data
    ext_pos = pos
    built: list[bytes] = []
    externals: list[bytes] = []
    for tag, ftype, count, values in tags:
        head_payload = entry(tag, ftype, count, values)
        if head_payload[1] is None:
            built.append(head_payload[0])
        else:
            built.append(
                head_payload[0] + struct.pack(bo + off_t, ext_pos).ljust(inline, b"\0")
            )
            externals.append(head_payload[1])
            ext_pos += len(head_payload[1])

    ifd_off = ext_pos
    with open(path, "wb") as fh:
        if big:
            fh.write(b"II" + struct.pack(bo + "HHHQ", 43, 8, 0, ifd_off))
        else:
            fh.write(b"II" + struct.pack(bo + "HI", 42, ifd_off))
        for b in chunks:
            fh.write(b)
        for e in externals:
            fh.write(e)
        if big:
            fh.write(struct.pack(bo + "Q", len(built)))
        else:
            fh.write(struct.pack(bo + "H", len(built)))
        fh.write(b"".join(built))
        fh.write(struct.pack(bo + ("Q" if big else "I"), 0))
