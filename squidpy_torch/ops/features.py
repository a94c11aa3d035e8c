"""Image features: GLCM texture (kernel K18), crop summaries (K19), crop
histograms (K20) and region properties (counterpart of
``squidpy_tpu/ops/features.py``).

Each kernel has its plain torch version beside it, which the CPU runs; a CUDA
tensor goes to the kernel, never to the plain version.

- K18 (``csrc/glcm.cu``): the co-occurrence counts of a batch of crops
  (uint8, or any integer type at any number of levels), and from exact
  integer sums over the pairs the skimage props in double
  (``_glcm_props_plain`` does the same operations in the same order; the
  sums and the centred products are exact past int64, and a cell counts
  past 2^32). ``graycomatrix`` and
  ``glcm_batch`` return the counts, equal to JAX's; the props differ from
  JAX's float32 sums by their rounding only. Routes: ``k18_route``.
- K19 (``csrc/crop_summary.cu``): a radix select of the ranks the quantiles
  read a (crop, channel), at JAX's positions, weights and rounding
  (``quantile_table``: the batched kernel's rule, or ``jnp.quantile``'s),
  and the mean and std from double sums. Routes: ``_k19_layout``.
- K20 (``csrc/crop_histogram.cu``): the batched kernel's bin rule over a
  fixed or a per-crop range, or ``jnp.histogram``'s edges and search, by
  two entries: uint8 crops as n_ch x 256 value counts folded into bins
  (``_k20_value_bins`` is the fold's plain twin), float32 crops value by
  value. Entry and routes: ``_k20_layout``.

``regionprops``' segment reductions are plain torch ``index_add_`` /
``scatter_reduce`` in float64 on the device; ``graycoprops``,
``_perimeters`` and ``_host_props`` are host code, copied.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from squidpy_torch import _cuda
from squidpy_torch._device import get_device, to_host

__all__ = [
    "graycomatrix",
    "graycoprops",
    "histogram_features",
    "summary_features",
    "regionprops",
    "summary_features_batch",
    "histogram_features_batch",
    "glcm_batch",
    "glcm_props_batch",
]

GLCM_PROPS = ("contrast", "dissimilarity", "homogeneity", "ASM", "energy", "correlation")
PACKED_MAX = 65_535  # K18's 16-bit shared counters: the most one cell may count
SHARED_LEVELS = 256  # K18's shared route: uint8 crops, a levels^2 matrix of 16-bit counters in shared memory
PLANE_MAX = 81_920  # K18's shared route: bytes of the staged channel plane (rows padded to 4 bytes)
K18_SCRATCH = 1 << 28  # bytes of counters K18's global route holds at once (a group of items)
K18_MOMENTS = 6  # K18's global route: sum i, sum j, sum i^2, sum j^2, sum ij, sum c^2, each two 64-bit words
SMEM_KEYS = 32_768  # K19's sort route sorts a channel of at most this many values in shared memory
SELECT_RANKS = 32  # K19's select resolves at most this many distinct ranks; more take the sort route
K19_STATE_BYTES = 656  # csrc/crop_summary.cu `Select`
K20_SMEM = 160 * 1024  # K20's float32 entry: shared histogram and edges, bytes; past it the histogram counts in global memory
K20_SHARED_EDGES = 1024  # K20's float32 entry, rule 1: at most this many edges in shared memory
K20_CHANNEL_WORDS = 267  # K20's uint8 entry: a channel's shared words, 256 counters and 11 of skew (`kChannelWords`)
K20_FOLD_WORDS = 258  # K20's uint8 entry: the fold's shared words, a bin for each byte value, lo and hi (`kFoldWords`)
K20_HIST_SMEM = 48 * 1024  # K20's uint8 entry: the fold's shared histogram, bytes; past it atomics into the output
K20_MIN_SPLIT = 16 * 1024  # K20's uint8 entry: the fewest bytes a block of a split crop counts
K20_CHUNK_MAX = 2**31 - 16  # K20's uint8 entry: the most bytes a block counts (its 32-bit counters)
LINSPACE_UNROLLED_BINS = 33  # XLA:CPU unrolls jnp.linspace's loop up to here: e_1 then fuses lo (1 - c)
SCRATCH_BLOCKS = 264  # grid of K19's global sort route: two blocks an SM of an H100
_TREE = 256  # least terms of the homogeneity's pairwise sum
_PLAIN_PAIRS = {"cpu": 1 << 22, "cuda": 1 << 26}  # pixel pairs K18's plain versions hold at once


_DEVICE_INFO: dict[int | None, tuple[int, int]] = {}


def _device_info(dev: torch.device) -> tuple[int, int]:
    """``_cuda.device_info`` of ``dev``, asked once."""
    if dev.index not in _DEVICE_INFO:
        _DEVICE_INFO[dev.index] = _cuda.device_info()
    return _DEVICE_INFO[dev.index]


# --------------------------------------------------------------------- K18


def _offsets(distances: list[int], angles: list[float]) -> list[tuple[int, int]]:
    """skimage's (row, col) pixel offset of each (distance, angle), distance-major."""
    return [(int(round(np.sin(a) * d)), int(round(np.cos(a) * d))) for d in distances for a in angles]


def _checked(images: np.ndarray, levels: int) -> np.ndarray:
    images = np.ascontiguousarray(images)
    if int(images.max(initial=0)) >= levels:
        raise ValueError(
            f"The maximum grayscale value `{int(images.max())}` must be smaller than `levels={levels}`."
        )
    if images.dtype != np.uint8 and levels <= 256:
        images = images.astype(np.uint8)
    return images


def _pair_chunks(img: torch.Tensor, dr: int, dc: int):
    """The (m, k) int64 reference and partner values of offset (dr, dc) of
    ``img`` (m, h, w) over its in-bounds pairs, row-major, a run of whole
    pair rows of about ``_PLAIN_PAIRS`` values at a time."""
    m, h, w = img.shape
    y0, y1, x0, x1 = max(0, -dr), min(h, h - dr), max(0, -dc), min(w, w - dc)
    if y1 <= y0 or x1 <= x0 or m == 0:
        return
    step = max(1, _PLAIN_PAIRS[img.device.type] // (m * (x1 - x0)))
    for r in range(y0, y1, step):
        r1 = min(r + step, y1)
        yield (img[:, r:r1, x0:x1].reshape(m, -1).to(torch.int64),
               img[:, r + dr : r1 + dr, x0 + dc : x1 + dc].reshape(m, -1).to(torch.int64))


def _glcm_counts_plain(img: torch.Tensor, offsets: list[tuple[int, int]], levels: int) -> torch.Tensor:
    """(m, n_off, levels^2) int64 counts of ``img`` (m, h, w): K18's count entry."""
    m = img.shape[0]
    out = torch.zeros((m, len(offsets), levels * levels), dtype=torch.int64, device=img.device)
    rows = torch.arange(m, device=img.device)[:, None] * (levels * levels)
    for o, (dr, dc) in enumerate(offsets):
        for i, j in _pair_chunks(img, dr, dc):
            ok = (i >= 0) & (j >= 0) & (i < levels) & (j < levels)
            flat = (rows + i * levels + j)[ok]
            out[:, o] += torch.bincount(flat, minlength=m * levels * levels).view(m, -1)
    return out


def _sums_fit(pairs: int, levels: int) -> bool:
    """K18's sums of an offset of ``pairs`` pixel pairs stay in int64, doubled
    by ``symmetric``: sum i^2 <= pairs (levels - 1)^2, sum c^2 <= pairs^2."""
    return 4 * pairs * max(pairs, (levels - 1) ** 2) < 2**63


def _glcm_sums_plain(img: torch.Tensor, dr: int, dc: int, levels: int, symmetric: bool,
                     ignore_level: int | None) -> tuple[torch.Tensor | list[list[int]], torch.Tensor]:
    """K18's integers of one offset for each of the m crops of ``img``: the
    sums (pairs, sum i, sum j, sum i^2, sum j^2, sum ij, sum |i - j|,
    sum (i - j)^2, sum of the squared counts over the full matrix, with
    ``symmetric`` of P + P^T), an (m, 9) int64 tensor where ``_sums_fit``
    and else m rows of Python integers, and the (m, levels) pairs at each
    |i - j|. The sums come from the histograms of i, j and |i - j| and the
    counts; sum ij = (sum i^2 + sum j^2 - sum (i - j)^2) / 2."""
    m, h, w = img.shape
    dev = img.device
    hists = torch.zeros((3, m, levels), dtype=torch.int64, device=dev)  # i, j, |i - j|
    counts = torch.zeros(m * levels * levels, dtype=torch.int64, device=dev)
    rows = torch.arange(m, device=dev)[:, None] * (levels * levels)
    for i, j in _pair_chunks(img, dr, dc):
        keep = (i >= 0) & (j >= 0) & (i < levels) & (j < levels)
        if ignore_level is not None:
            keep &= (i != ignore_level) & (j != ignore_level)
        wt = keep.to(torch.int64)
        i, j = i * wt, j * wt
        for k, v in enumerate((i, j, (i - j).abs())):
            hists[k].scatter_add_(1, v, wt)
        if symmetric:
            cell, inc = torch.minimum(i, j) * levels + torch.maximum(i, j), wt * (1 + (i == j).to(torch.int64))
        else:
            cell, inc = i * levels + j, wt
        counts.index_add_(0, (rows + cell).reshape(-1), inc.reshape(-1))
    counts = counts.view(m, levels * levels)
    diag = torch.arange(levels, device=dev) * (levels + 1)
    if _sums_fit(_max_pairs(h, w, [(dr, dc)]), levels):
        v = torch.arange(levels, dtype=torch.int64, device=dev)
        hi, hj, hd = hists
        sq = counts * counts
        if symmetric:  # an upper cell off the diagonal stands for two mirrored cells
            sq = 2 * sq
            sq[:, diag] //= 2
        Sii, Sjj, D2 = (hi * v * v).sum(1), (hj * v * v).sum(1), (hd * v * v).sum(1)
        sums = torch.stack([hd.sum(1), (hi * v).sum(1), (hj * v).sum(1), Sii, Sjj, (Sii + Sjj - D2) // 2,
                            (hd * v).sum(1), D2, sq.sum(1)], dim=1)
        return sums, hists[2]
    exact = []
    for k in range(m):
        hi, hj, hd = (hists[t, k].tolist() for t in range(3))
        row = counts[k]
        Q = sum(c * c for c in row[row > 0].tolist())
        if symmetric:
            Q = 2 * Q - sum(c * c for c in row[diag].tolist())
        Sii, Sjj, D2 = (sum(c * x * x for x, c in enumerate(t)) for t in (hi, hj, hd))
        exact.append([sum(hd), sum(c * x for x, c in enumerate(hi)), sum(c * x for x, c in enumerate(hj)), Sii, Sjj,
                      (Sii + Sjj - D2) // 2, sum(c * x for x, c in enumerate(hd)), D2, Q])
    return exact, hists[2]


def _centred(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``a b - c d`` of non-negative int64 tensors, exact, rounded to float64
    once (as ``csrc/glcm.cu`` `centred` does it in 128 bits): in int64 where
    both products stay below 2^62, in Python integers on the other entries."""
    out = (a * b - c * d).to(torch.float64)
    f64 = torch.float64
    big = (a.to(f64) * b.to(f64) >= 2.0**62) | (c.to(f64) * d.to(f64) >= 2.0**62)
    if bool(big.any()):
        exact = [float(int(w) * int(x) - int(y) * int(z))
                 for w, x, y, z in zip(a[big].tolist(), b[big].tolist(), c[big].tolist(), d[big].tolist())]
        out[big] = torch.tensor(exact, dtype=torch.float64, device=out.device)
    return out


def _props_integers(sums: torch.Tensor | list[list[int]], symmetric: bool, dev: torch.device) -> torch.Tensor:
    """(..., 7) float64 S, sum |i - j|, sum (i - j)^2, sum c^2 and the
    centred products S sum i^2 - (sum i)^2, its j twin and S sum ij -
    sum i sum j of K18's sums (with ``symmetric`` of P + P^T), each the exact
    integer rounded to double once: int64 sums in tensors, Python integers
    past them."""
    if isinstance(sums, torch.Tensor):
        S, Si, Sj, Sii, Sjj, Sij, D1, D2, Q = sums.unbind(-1)
        if symmetric:
            S, Si, Sj, Sii, Sjj, Sij, D1, D2 = 2 * S, Si + Sj, Si + Sj, Sii + Sjj, Sii + Sjj, 2 * Sij, 2 * D1, 2 * D2
        f64 = torch.float64
        return torch.stack([S.to(f64), D1.to(f64), D2.to(f64), Q.to(f64), _centred(S, Sii, Si, Si),
                            _centred(S, Sjj, Sj, Sj), _centred(S, Sij, Si, Sj)], dim=-1)
    out = []
    for S, Si, Sj, Sii, Sjj, Sij, D1, D2, Q in sums:
        if symmetric:
            S, Si, Sj, Sii, Sjj, Sij, D1, D2 = 2 * S, Si + Sj, Si + Sj, Sii + Sjj, Sii + Sjj, 2 * Sij, 2 * D1, 2 * D2
        out.append([float(S), float(D1), float(D2), float(Q), float(S * Sii - Si * Si), float(S * Sjj - Sj * Sj),
                    float(S * Sij - Si * Sj)])
    return torch.tensor(out, dtype=torch.float64, device=dev).reshape(len(out), 7)


def _glcm_props_plain(sums: torch.Tensor | list[list[int]], hist: torch.Tensor, symmetric: bool) -> torch.Tensor:
    """(..., 6) float64 props (``GLCM_PROPS`` order) from K18's integers, the
    operations of ``csrc/glcm.cu`` `glcm_props_from_sums` and
    `homogeneity_tree` in the same order."""
    if symmetric:
        hist = 2 * hist
    n_terms = max(_TREE, 1 << (hist.shape[-1] - 1).bit_length())
    d = torch.arange(n_terms, dtype=torch.int64, device=hist.device)
    counts = torch.nn.functional.pad(hist, (0, n_terms - hist.shape[-1]))
    terms = counts.to(torch.float64) / (1.0 + (d * d).to(torch.float64))
    while terms.shape[-1] > 1:
        terms = terms[..., 0::2] + terms[..., 1::2]
    homog = terms[..., 0]
    S, D1, D2, Q, vi, vj, cov = _props_integers(sums, symmetric, hist.device).unbind(-1)
    sd = torch.where(S == 0, torch.ones_like(S), S)
    asm = Q / (sd * sd)
    corr = torch.where((vi == 0) | (vj == 0), torch.ones_like(asm), cov / torch.sqrt(vi * vj))
    return torch.stack([D2 / sd, D1 / sd, homog / sd, asm, torch.sqrt(asm), corr], dim=-1)


def _max_pairs(h: int, w: int, offsets: list[tuple[int, int]]) -> int:
    return max(max(h - abs(dr), 0) * max(w - abs(dc), 0) for dr, dc in offsets)


def k18_packed(h: int, w: int, offsets: list[tuple[int, int]], symmetric: bool) -> bool:
    """K18's 16-bit shared counters hold every cell of an offset
    (``symmetric`` counts 2 a pair on the diagonal)."""
    return _max_pairs(h, w, offsets) * (2 if symmetric else 1) <= PACKED_MAX


def k18_route(h: int, w: int, offsets: list[tuple[int, int]], symmetric: bool, levels: int,
              dtype: torch.dtype = torch.uint8) -> str:
    """K18's route: ``shared`` (uint8 crops at up to 256 levels, the packed
    counters, the plane staged in shared memory) or ``global``."""
    shared = (dtype == torch.uint8 and levels <= SHARED_LEVELS and k18_packed(h, w, offsets, symmetric)
              and h * ((w + 3) & ~3) <= PLANE_MAX)
    return "shared" if shared else "global"


def _k18_images(imgs: torch.Tensor, levels: int) -> torch.Tensor:
    """The kernel's pixels: uint8 as they are, any other type as int32 (a
    value outside [0, levels) drops its pairs in both versions)."""
    if imgs.dtype == torch.uint8:
        return imgs.contiguous()
    if imgs.dtype not in (torch.int8, torch.int16, torch.int32):
        imgs = imgs.to(torch.int64).clamp(-1, levels)
    return imgs.to(torch.int32).contiguous()


_K18_TABLES: dict[tuple, torch.Tensor] = {}


def _k18_device_table(channels: list[int], offsets: list[tuple[int, int]], dev: torch.device) -> torch.Tensor:
    """The channels and the offsets' (dr, dc) as one int32 tensor on ``dev``,
    made once for each call shape (a copy to the card waits for the card)."""
    key = (str(dev), tuple(channels), tuple(offsets))
    if key not in _K18_TABLES:
        if len(_K18_TABLES) >= 64:
            _K18_TABLES.clear()
        flat = np.r_[np.asarray(channels, np.int32), np.asarray(offsets, np.int32).reshape(-1)]
        _K18_TABLES[key] = torch.from_numpy(flat.astype(np.int32)).to(dev)
    return _K18_TABLES[key]


def _glcm_k18(imgs: torch.Tensor, channels: list[int], offsets: list[tuple[int, int]], levels: int,
              symmetric: bool, ignore_level: int | None, counts: bool) -> torch.Tensor:
    """K18 on ``imgs`` (n, h, w, C) on the card: props (n, len(channels),
    n_off, 6) float64, or with ``counts`` the (n * len(channels), n_off,
    levels^2) counts."""
    n, h, w, n_c = imgs.shape
    imgs = _k18_images(imgs, levels)
    _cuda.require(imgs, "images", imgs.dtype)
    dev = imgs.device
    n_items, n_off, cells = n * len(channels), len(offsets), levels * levels
    table = _k18_device_table(channels, offsets, dev)
    host_offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32).reshape(-1, 2))
    route = k18_route(h, w, offsets, symmetric, levels, imgs.dtype)
    wide = _max_pairs(h, w, offsets) * (2 if symmetric else 1) >= 2**32  # a cell may pass uint32: 64-bit counters
    cdt, csize = (torch.int64, 8) if wide else (torch.int32, 4)
    group, gcnt, gsums, ghist = 0, None, None, None
    if route == "shared" and not counts:  # each (item, offset)'s moments and d histogram, for the props kernel
        gsums = torch.empty((n_items * n_off, 6), dtype=torch.int32, device=dev)
        ghist = torch.empty((n_items * n_off, _TREE), dtype=torch.int16, device=dev)
    elif route == "global" and not counts:
        group = max(1, min(n_items, K18_SCRATCH // (csize * cells), 65_535))
        gcnt = torch.zeros((group, cells), dtype=cdt, device=dev)
        gsums = torch.zeros((group, 2 * K18_MOMENTS), dtype=torch.int64, device=dev)
        ghist = torch.zeros((group, levels), dtype=torch.int64, device=dev)
    elif route == "global":
        group = max(1, min(n_items, 65_535))  # a grid's y extent
    props = counts_out = None
    if counts:
        alloc = torch.zeros if route == "global" else torch.empty
        counts_out = alloc((n_items, n_off, cells), dtype=cdt, device=dev)
    else:
        props = torch.empty((n_items, n_off, 6), dtype=torch.float64, device=dev)
    if n_items and n_off:
        code = _cuda.library().sqt_glcm(
            imgs.data_ptr(), int(imgs.dtype != torch.uint8), n, len(channels), table.data_ptr(), h, w, h * w * n_c,
            n_c, table.data_ptr() + 4 * len(channels), host_offs.ctypes.data, n_off, levels, int(symmetric),
            -1 if ignore_level is None else int(ignore_level), int(route == "global"), int(wide), group,
            _device_info(dev)[1],
            *(None if t is None else t.data_ptr() for t in (gcnt, gsums, ghist, props, counts_out)), _cuda.stream_ptr())
        _cuda.check(code, "glcm")
        _cuda.launches["glcm"] += 1
    if counts:
        return counts_out if wide else counts_out.to(torch.int64) & 0xFFFFFFFF  # uint32 counters
    return props.view(n, len(channels), n_off, 6)


def glcm_counts(imgs: torch.Tensor, channels: list[int], offsets: list[tuple[int, int]], levels: int) -> torch.Tensor:
    """(n * len(channels), n_off, levels^2) int64 counts of ``imgs`` (n, h, w, C)."""
    if imgs.device.type == "cuda":
        return _glcm_k18(imgs, channels, offsets, levels, False, None, counts=True)
    planes = imgs.permute(0, 3, 1, 2)[:, channels].reshape(-1, imgs.shape[1], imgs.shape[2])
    return _glcm_counts_plain(planes, offsets, levels)


def _glcm_props_batched_plain(imgs: torch.Tensor, channels: list[int], offsets: list[tuple[int, int]], levels: int,
                              symmetric: bool, ignore_level: int | None) -> torch.Tensor:
    n, h, w, _ = imgs.shape
    planes = imgs.permute(0, 3, 1, 2)[:, channels].reshape(-1, h, w)
    chunk = max(1, (1 << 24) // (levels * levels))  # bounds the (chunk, levels^2) count matrix
    out = []
    for s in range(0, planes.shape[0], chunk):
        part = planes[s : s + chunk]
        per_off = [_glcm_props_plain(*_glcm_sums_plain(part, dr, dc, levels, symmetric, ignore_level), symmetric)
                   for dr, dc in offsets]
        out.append(torch.stack(per_off, dim=1))
    res = torch.cat(out) if out else torch.zeros((0, len(offsets), 6), dtype=torch.float64, device=imgs.device)
    return res.view(n, len(channels), len(offsets), 6)


def glcm_props(imgs: torch.Tensor, channels: list[int], offsets: list[tuple[int, int]], levels: int,
               symmetric: bool = False, ignore_level: int | None = None) -> torch.Tensor:
    """(n, len(channels), n_off, 6) float64 props (``GLCM_PROPS`` order) of
    ``imgs`` (n, h, w, C): K18 on the card, its plain version on the CPU."""
    if imgs.device.type == "cuda":
        return _glcm_k18(imgs, channels, offsets, levels, symmetric, ignore_level, counts=False)
    return _glcm_props_batched_plain(imgs, channels, offsets, levels, symmetric, ignore_level)


def _prop_columns(props: tuple[str, ...] | list[str]) -> list[int]:
    out = []
    for p in props:
        if p not in GLCM_PROPS:
            raise ValueError(f"`{p}` is an invalid property.")
        out.append(GLCM_PROPS.index(p))
    return out


def _device_images(images: np.ndarray) -> torch.Tensor:
    """(n, h, w[, C]) crops on the selected device as (n, h, w, C)."""
    t = torch.from_numpy(np.ascontiguousarray(images)).to(get_device())
    return t if t.ndim == 4 else t.unsqueeze(-1)


def graycomatrix(
    image: np.ndarray,
    distances: list[int],
    angles: list[float],
    levels: int = 256,
    symmetric: bool = False,
    normed: bool = False,
) -> np.ndarray:
    """Gray-level co-occurrence matrix, skimage-convention
    (``P[i, j, d, a]``; offset row = d*sin(angle), col = d*cos(angle)).

    Raises when pixel values exceed ``levels`` (skimage behavior) instead of
    silently wrapping or dropping them.
    """
    image = _checked(image, levels)
    counts = glcm_counts(_device_images(image[None]), [0], _offsets(distances, angles), levels)
    P = to_host(counts[0]).astype(np.float64).reshape(len(distances), len(angles), levels, levels)
    P = np.ascontiguousarray(np.transpose(P, (2, 3, 0, 1)))
    if symmetric:
        P = P + np.transpose(P, (1, 0, 2, 3))
    if normed:
        sums = P.sum(axis=(0, 1), keepdims=True)
        sums[sums == 0] = 1
        P = P / sums
    return P


def graycoprops(P: np.ndarray, prop: str = "contrast") -> np.ndarray:
    """Texture properties of a GLCM (skimage ``graycoprops`` formulas)."""
    (num_level, num_level2, num_dist, num_angle) = P.shape
    P = P.astype(np.float64)
    glcm_sums = P.sum(axis=(0, 1), keepdims=True)
    glcm_sums[glcm_sums == 0] = 1
    Pn = P / glcm_sums

    I, J = np.ogrid[0:num_level, 0:num_level2]
    if prop == "contrast":
        weights = (I - J) ** 2
    elif prop == "dissimilarity":
        weights = np.abs(I - J)
    elif prop == "homogeneity":
        weights = 1.0 / (1.0 + (I - J) ** 2)
    elif prop in ("ASM", "energy"):
        asm = np.sum(Pn**2, axis=(0, 1))
        return np.sqrt(asm) if prop == "energy" else asm
    elif prop == "correlation":
        results = np.zeros((num_dist, num_angle))
        Ii = np.arange(num_level).reshape(-1, 1, 1, 1)
        Jj = np.arange(num_level2).reshape(1, -1, 1, 1)
        mean_i = np.sum(Ii * Pn, axis=(0, 1))
        mean_j = np.sum(Jj * Pn, axis=(0, 1))
        std_i = np.sqrt(np.sum(Pn * (Ii - mean_i) ** 2, axis=(0, 1)))
        std_j = np.sqrt(np.sum(Pn * (Jj - mean_j) ** 2, axis=(0, 1)))
        cov = np.sum(Pn * (Ii - mean_i) * (Jj - mean_j), axis=(0, 1))
        mask0 = (std_i < 1e-15) | (std_j < 1e-15)
        results[mask0] = 1.0
        results[~mask0] = cov[~mask0] / (std_i[~mask0] * std_j[~mask0])
        return results
    elif prop == "mean":
        weights = I  # mean of reference pixels
    else:
        raise ValueError(f"`{prop}` is an invalid property.")
    weights = weights.reshape((num_level, num_level2, 1, 1))
    return np.sum(Pn * weights, axis=(0, 1))


def glcm_batch(
    images: np.ndarray,
    distances: list[int],
    angles: list[float],
    levels: int = 256,
) -> np.ndarray:
    """GLCMs for a batch of same-size grayscale crops: ``(n, levels, levels,
    n_dist, n_angle)`` with skimage conventions, one K18 launch."""
    images = _checked(images, levels)
    n = images.shape[0]
    counts = to_host(glcm_counts(_device_images(images), [0], _offsets(distances, angles), levels))
    P = counts.astype(np.float64).reshape(n, len(distances), len(angles), levels, levels)
    return np.ascontiguousarray(np.transpose(P, (0, 3, 4, 1, 2)))


def glcm_props_batch(
    images: np.ndarray,
    distances: list[int],
    angles: list[float],
    props: tuple[str, ...],
    levels: int = 256,
) -> np.ndarray:
    """Texture properties for a crop batch, ``(n, n_dist, n_angle, n_props)``:
    K18's props of every crop and offset in one launch; only the props cross
    to the host."""
    cols = _prop_columns(props)
    images = _checked(images, levels)
    n = images.shape[0]
    vals = glcm_props(_device_images(images), [0], _offsets(distances, angles), levels)
    out = to_host(vals[:, 0][..., cols])
    return out.reshape(n, len(distances), len(angles), len(cols))


# --------------------------------------------------------------------- K19


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)`` rounded once: the exact product in float64,
    the sum rounded to odd (TwoSum's error decides the last bit), then one
    rounding to float32."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = torch.isfinite(s) & (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    return torch.where(nudge, torch.nextafter(s, toward), s).to(torch.float32)


def quantile_table(quantiles: tuple[float, ...], p: int, rule: int) -> tuple[np.ndarray, ...]:
    """Positions (lo, hi) in a sorted channel of p values and float32 weights
    (w_lo, w_hi) of each quantile. Rule 0, JAX's batched kernel: pos = q (p -
    1) in double, hi = min(lo + 1, p - 1). Rule 1, ``jnp.quantile``: pos in
    float32, lo = floor, hi = ceil."""
    lo, hi, wlo, whi = [], [], [], []
    for q in quantiles:
        if rule == 0:
            pos = q * (p - 1)
            low = int(np.floor(pos))
            lo.append(low)
            hi.append(min(low + 1, p - 1))
            frac = pos - low
            wlo.append(np.float32(1 - frac))
            whi.append(np.float32(frac))
        else:
            pos = np.float32(q) * np.float32(p - 1)
            low, high = np.floor(pos), np.ceil(pos)
            hw = np.float32(pos - low)
            wlo.append(np.float32(np.float32(1) - hw))
            whi.append(hw)
            lo.append(int(min(max(low, 0), p - 1)))
            hi.append(int(min(max(high, 0), p - 1)))
    return (np.asarray(lo, np.int32), np.asarray(hi, np.int32), np.asarray(wlo, np.float32),
            np.asarray(whi, np.float32))


def _summary_plain(x: torch.Tensor, table: tuple[np.ndarray, ...], rule: int) -> tuple[torch.Tensor, ...]:
    """K19's plain version on ``x`` (n, p, C) float32: quantiles (n, Q, C),
    mean and std (n, C)."""
    lo, hi, wlo, whi = (torch.from_numpy(t).to(x.device) for t in table)
    p = x.shape[1]
    s = torch.sort(x, dim=1).values
    a, b = s[:, lo.long(), :], s[:, hi.long(), :]
    wl, wh = wlo.view(1, -1, 1).expand_as(a), whi.view(1, -1, 1).expand_as(a)
    if rule == 0:
        q = _fma32(a, wl, b * wh)
    else:
        q = _fma32(b, wh, a * wl)
        q = torch.where(torch.isnan(x).any(dim=1, keepdim=True), torch.full_like(q, float("nan")), q)
    x64 = x.to(torch.float64)
    sx, sxx = x64.sum(1), (x64 * x64).sum(1)
    v = p * sxx - sx * sx
    var = torch.where(v < 0, torch.zeros_like(v), v) / (p * p)
    return q, (sx / p).to(torch.float32), torch.sqrt(var).to(torch.float32)


def _k19_ranks(table: tuple[np.ndarray, ...]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The distinct positions the quantiles read, ascending, and each
    quantile's two indices into them."""
    lo, hi = table[0], table[1]
    ranks = np.unique(np.r_[lo, hi]).astype(np.int32)
    return ranks, np.searchsorted(ranks, lo).astype(np.int32), np.searchsorted(ranks, hi).astype(np.int32)


_K19_TABLES: dict[tuple, tuple[torch.Tensor, list[int]]] = {}


def _k19_device_table(table: tuple[np.ndarray, ...], dev: torch.device) -> tuple[torch.Tensor, list[int]]:
    """One int32 tensor on ``dev`` holding ranks, qlo, qhi and the two
    weights' bits, and the element offset of each: made once for each table
    and device (the per-crop path asks for the same one every crop)."""
    key = (str(dev), *(t.tobytes() for t in table))
    if key not in _K19_TABLES:
        if len(_K19_TABLES) >= 64:
            _K19_TABLES.clear()
        ranks, qlo, qhi = _k19_ranks(table)
        parts = [ranks, qlo, qhi, table[2].view(np.int32), table[3].view(np.int32)]
        offsets = np.cumsum([0] + [len(t) for t in parts[:-1]]).tolist()
        _K19_TABLES[key] = torch.from_numpy(np.concatenate(parts)).to(dev), offsets
    return _K19_TABLES[key]


def _k19_layout(n_items: int, p: int, nr: int, smem: int, sms: int) -> tuple[str, int, int, int]:
    """K19's route, threads a block, blocks an item and room for candidate
    keys: ``select`` (a block an item, the keys in shared memory), ``split``
    (channels past the shared keys, an item over several blocks) or
    ``sort`` (more than ``SELECT_RANKS`` distinct ranks)."""
    if nr > SELECT_RANKS:
        return "sort", 1024, 1, 0
    room = smem - (nr * 1024 + 4 * p + K19_STATE_BYTES + 512)
    if room >= 0:
        threads = 128 if p <= 4096 else 256 if p <= 16_384 else 512 if p <= 32_768 else 1024
        if n_items < sms:  # a few items: the widest block each
            threads = 1024 if p > 4096 else max(threads, 512)
        return "select", threads, 1, min(room // 4, max(2048, p // 4))
    blocks = min(-(-p // 1024), max(-(-2 * sms // max(n_items, 1)), -(-p // 16_384)), 65_535)
    return "split", 256, max(blocks, 1), 0


def _summary_k19(x: torch.Tensor, table: tuple[np.ndarray, ...], rule: int) -> tuple[torch.Tensor, ...]:
    n, p, n_c = x.shape
    _cuda.require(x, "crops", torch.float32)
    dev = x.device
    tab, at = _k19_device_table(table, dev)
    nr, nq = at[1], len(table[0])
    smem, sms = _device_info(dev)
    route, threads, blocks, cap = _k19_layout(n * n_c, p, nr, smem, sms)
    p2 = 1 << max(p - 1, 0).bit_length()
    scratch = None
    if route == "split":
        nbytes = n * n_c * (K19_STATE_BYTES + 1024 * nr + 16 * blocks + 4)
        scratch = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    elif route == "sort" and p2 > SMEM_KEYS:
        scratch = torch.empty((min(n * n_c, SCRATCH_BLOCKS), p2), dtype=torch.int32, device=dev)
    ranks, qlo, qhi, wlo, whi = (tab.data_ptr() + 4 * a for a in at)
    out = torch.empty(n * n_c * (nq + 2), dtype=torch.float32, device=dev)
    quant = out[: n * nq * n_c].view(n, nq, n_c)
    mean, std = out[n * nq * n_c :].view(2, n, n_c).unbind(0)
    if n * n_c and p:
        code = _cuda.library().sqt_crop_summary(
            x.data_ptr(), n, p, n_c, ("select", "split", "sort").index(route), threads, blocks, cap, nr, ranks, nq,
            qlo, qhi, wlo, whi, rule, p2, SCRATCH_BLOCKS, None if scratch is None else scratch.data_ptr(),
            quant.data_ptr(), mean.data_ptr(), std.data_ptr(), _cuda.stream_ptr())
        _cuda.check(code, "crop_summary")
        _cuda.launches["crop_summary"] += 1
    return quant, mean, std


def crop_summary(x: torch.Tensor, quantiles: tuple[float, ...], rule: int = 0) -> tuple[torch.Tensor, ...]:
    """Quantiles (n, Q, C), mean and std (n, C) of ``x`` (n, p, C) float32."""
    table = quantile_table(tuple(quantiles), x.shape[1], rule)
    if x.device.type == "cuda":
        return _summary_k19(x, table, rule)
    return _summary_plain(x, table, rule)


def _device_float(crops: np.ndarray) -> torch.Tensor:
    """(n, h, w, C) crops as (n, h * w, C) float32 on the selected device; the
    cast runs there (uint8 crops cross as bytes)."""
    arr = np.ascontiguousarray(crops)
    if arr.dtype not in (np.uint8, np.int16, np.int32, np.int64, np.float32, np.float64):
        arr = arr.astype(np.float32)
    t = torch.from_numpy(arr).to(get_device())
    return t.reshape(t.shape[0], -1, t.shape[-1]).to(torch.float32).contiguous()


def summary_features(arr: np.ndarray, quantiles: tuple[float, ...]) -> dict[str, float]:
    """Per-array quantiles/mean/std (``jnp.quantile``'s rule, K19)."""
    x = _device_float(np.asarray(arr, dtype=np.float32).reshape(1, -1, 1))
    q, mean, std = crop_summary(x, tuple(quantiles), rule=1)
    return {
        "quantiles": to_host(q[0, :, 0]),
        "mean": float(to_host(mean)[0, 0]),
        "std": float(to_host(std)[0, 0]),
    }


def summary_features_batch(crops: np.ndarray, quantiles: tuple[float, ...]) -> dict[str, np.ndarray]:
    """Per-channel quantiles/mean/std for a stacked crop batch ``(n, h, w,
    c)`` in one K19 launch — the batched counterpart of
    :func:`summary_features`."""
    q, mean, std = crop_summary(_device_float(crops), tuple(quantiles), rule=0)
    return {"quantiles": to_host(q), "mean": to_host(mean), "std": to_host(std)}


# --------------------------------------------------------------------- K20


class K20Layout(NamedTuple):
    """K20's launch: ``entry`` "uint8" (value counts, then a fold of the 256
    values) or "float32"; uint8: ``splits`` blocks a crop of ``chunk``
    bytes, ``fused`` (one block counts and folds a crop; else a global
    table of value counts and a fold kernel); float32: ``edges_shared``
    (rule 1); both: ``hist_shared`` (a shared histogram written once; else
    atomics into the zeroed output)."""

    entry: str
    splits: int
    chunk: int
    fused: bool
    hist_shared: bool
    edges_shared: bool


@functools.lru_cache(maxsize=256)
def _k20_layout(n: int, p: int, n_c: int, bins: int, rule: int, uint8: bool, smem: int, sms: int) -> K20Layout:
    """K20's entry and routes for ``n`` crops of ``p`` pixels x ``n_c``
    channels (``uint8``: bytes, else any dtype as float32) on a card of
    ``smem`` shared bytes a block and ``sms`` SMs. uint8 crops take the
    uint8 entry while a block's n_c x 256 counters fit shared memory
    (``K20_CHANNEL_WORDS`` a channel), folded in the same block while the
    fold's words and histogram fit beside them; a crop splits over blocks
    past ``K20_CHUNK_MAX`` bytes, or where fewer crops than SMs would leave
    the card idle (two blocks an SM; a split counts ``K20_MIN_SPLIT``
    bytes or more). Every other dtype takes the float32 entry: the shared
    histogram and edges while they fit ``K20_SMEM`` and
    ``K20_SHARED_EDGES``. Cached: a one-crop call is host-bound."""
    size = p * n_c
    counters = 4 * n_c * K20_CHANNEL_WORDS
    if uint8 and counters <= smem:
        hist_shared = 4 * n_c * bins <= K20_HIST_SMEM
        fits = counters + 4 * (K20_FOLD_WORDS + (n_c * bins if hist_shared else 0)) <= smem
        splits = -(-size // K20_CHUNK_MAX)
        if n < sms:
            splits = max(splits, min(-(-2 * sms // max(n, 1)), -(-size // K20_MIN_SPLIT)))
        splits = max(splits, 1)
        chunk = (-(-size // splits) + 15) // 16 * 16 or 16
        return K20Layout("uint8", splits, chunk, fits and splits == 1, hist_shared, False)
    hb = 4 * n_c * bins
    edges_shared = rule == 1 and bins + 1 <= K20_SHARED_EDGES
    eb = 4 * (bins + 1) if edges_shared else 0
    return K20Layout("float32", 1, 0, False, hb + eb <= K20_SMEM, edges_shared)


def histogram_edges(lo: torch.Tensor, hi: torch.Tensor, bins: int) -> torch.Tensor:
    """``jnp.histogram``'s edges (n, bins + 1) float32 for ranges ``lo``,
    ``hi`` (n,) float32, as XLA:CPU compiles ``jnp.linspace``: c = 1 / bins,
    e_k = fma(k, hi c, lo (1 - k c)), except e_1 = fma(lo, 1 - c, hi c) up to
    ``LINSPACE_UNROLLED_BINS`` bins (the unrolled loop folds k = 1 away)."""
    same = lo == hi
    lo = torch.where(same, lo - np.float32(0.5), lo)
    hi = torch.where(same, hi + np.float32(0.5), hi)
    c = torch.tensor(np.float32(1) / np.float32(bins), device=lo.device)
    k = torch.arange(bins + 1, dtype=torch.float32, device=lo.device)[None, :]
    lo2, hi2 = lo[:, None].expand(-1, bins + 1), hi[:, None].expand(-1, bins + 1)
    hc = hi2 * c
    rest = _fma32(k.expand_as(hc), hc, lo2 * (1 - k * c))
    first = _fma32(lo2, (1 - c).expand_as(lo2), hc)
    e = torch.where(k == 1, first, rest) if bins <= LINSPACE_UNROLLED_BINS else rest
    e = torch.where(k == 0, lo2, e)
    return torch.where(k == bins, hi2, e)


def _histogram_plain(x: torch.Tensor, bins: int, rule: int, lo: torch.Tensor, hi: torch.Tensor,
                     per_crop_range: bool) -> torch.Tensor:
    """K20's plain version on ``x`` (n, p, C) float32: (n, C, bins) int64.
    It is the plain version of both entries: uint8 crops go through it as
    float32, which holds every byte exactly."""
    x = x.to(torch.float32)
    n, _, n_c = x.shape
    if rule == 0:
        if per_crop_range:
            lo, hi = x.amin(dim=(1, 2)), x.amax(dim=(1, 2))
        lo3, hi3 = lo.view(-1, 1, 1), hi.view(-1, 1, 1)
        span = torch.where(hi3 > lo3, hi3 - lo3, torch.ones_like(hi3))
        keep = (x >= lo3) & (x <= hi3)
        scaled = torch.where(keep, (x - lo3) / span * np.float32(bins), torch.zeros_like(x))
        idx = scaled.to(torch.int32).clamp(0, bins - 1).to(torch.int64)
    else:
        edges = histogram_edges(lo, hi, bins).view(n, 1, 1, bins + 1)
        idx = (edges <= x.unsqueeze(-1)).sum(-1)
        idx = torch.where(x == edges[..., -1], torch.full_like(idx, bins), idx)
        keep = (idx >= 1) & (idx <= bins) & ~torch.isnan(x)
        idx = (idx - 1).clamp(0, bins - 1)
    flat = (torch.arange(n, device=x.device).view(-1, 1, 1) * n_c + torch.arange(n_c, device=x.device).view(1, 1, -1))
    flat = (flat * bins + idx)[keep]
    return torch.bincount(flat, minlength=n * n_c * bins).view(n, n_c, bins)


def _k20_value_bins(lo: float, hi: float, bins: int, rule: int) -> torch.Tensor:
    """The plain twin of the uint8 entry's fold: the bin of each byte value
    0..255 (int64, -1 where dropped) over the range ``lo``, ``hi`` (float32;
    rule 0 with a per-crop range passes the lowest and highest value the
    crop holds, or inf and -inf for none), as the kernel computes it. Rule
    0 rounds each step once in float32; rule 1 counts each of
    ``histogram_edges``' edges at the first byte value at or above it and
    takes the prefix sum, #edges <= v, with the top edge into the last bin."""
    v = torch.arange(256, dtype=torch.float32)
    lo_t, hi_t = torch.tensor([lo], dtype=torch.float32), torch.tensor([hi], dtype=torch.float32)
    if rule == 0:
        span = hi_t - lo_t if bool(hi_t > lo_t) else torch.ones(1)
        keep = (v >= lo_t) & (v <= hi_t)
        scaled = torch.where(keep, (v - lo_t) / span * np.float32(bins), torch.zeros_like(v))
        return torch.where(keep, scaled.to(torch.int32).clamp(0, bins - 1).to(torch.int64), -1)
    edges = histogram_edges(lo_t, hi_t, bins)[0]
    counted = edges <= 255
    first = torch.where(edges <= 0, torch.zeros_like(edges), torch.ceil(edges))[counted].to(torch.int64)
    idx = torch.cumsum(torch.bincount(first, minlength=256), 0)
    idx = torch.where(v == edges[-1], bins, idx)
    return torch.where((idx >= 1) & (idx <= bins), idx - 1, -1)


k20_entry_launches = {"uint8": 0, "float32": 0}  # K20's calls by entry, counted where the wrapper launches


def _histogram_k20(x: torch.Tensor, bins: int, rule: int, lo: torch.Tensor, hi: torch.Tensor,
                   per_crop_range: bool, layout: K20Layout | None = None) -> torch.Tensor:
    """K20 on ``x`` (n, p, C) uint8 or float32 on the card, by ``layout``
    (``_k20_layout`` by default): (n, C, bins) int64."""
    n, p, n_c = x.shape
    if layout is None:
        layout = _k20_layout(n, p, n_c, bins, rule, x.dtype == torch.uint8, *_device_info(x.device))
    if layout.entry == "float32" and x.dtype != torch.float32:
        x = x.to(torch.float32)
    _cuda.require(x, "crops", torch.uint8 if layout.entry == "uint8" else torch.float32)
    out = (torch.empty if layout.hist_shared else torch.zeros)((n, n_c, bins), dtype=torch.int32, device=x.device)
    if not n:
        return out.to(torch.int64)
    if not p * n_c:
        return out.zero_().to(torch.int64)
    lib = _cuda.library()
    hist_global = int(not layout.hist_shared)
    if layout.entry == "uint8":
        table = None if layout.fused else torch.zeros((n, n_c, 256), dtype=torch.int32, device=x.device)
        code = lib.sqt_crop_histogram_u8(
            x.data_ptr(), n, p, n_c, bins, rule, lo.data_ptr(), hi.data_ptr(), int(per_crop_range), layout.splits,
            layout.chunk, hist_global, None if table is None else table.data_ptr(), out.data_ptr(), _cuda.stream_ptr())
        _cuda.check(code, "crop_histogram")
        if table is not None:
            code = lib.sqt_crop_histogram_fold(table.data_ptr(), n, n_c, bins, rule, lo.data_ptr(), hi.data_ptr(),
                                               int(per_crop_range), hist_global, out.data_ptr(), _cuda.stream_ptr())
            _cuda.check(code, "crop_histogram")
    else:
        gedges = None
        if rule == 1 and not layout.edges_shared:
            gedges = torch.empty((n, bins + 1), dtype=torch.float32, device=x.device)
        code = lib.sqt_crop_histogram(
            x.data_ptr(), n, p, n_c, bins, rule, lo.data_ptr(), hi.data_ptr(), int(per_crop_range), hist_global,
            None if gedges is None else gedges.data_ptr(), out.data_ptr(), _cuda.stream_ptr())
        _cuda.check(code, "crop_histogram")
    _cuda.launches["crop_histogram"] += 1
    k20_entry_launches[layout.entry] += 1
    return out.to(torch.int64)


def crop_histogram(x: torch.Tensor, bins: int, v_range: tuple[float, float] | None, rule: int = 0) -> torch.Tensor:
    """(n, C, bins) counts of ``x`` (n, p, C) uint8 or float32 over
    ``v_range`` or, with None (rule 0 only), each crop's own range. On the
    card uint8 crops take K20's uint8 entry (``_k20_layout``)."""
    n = x.shape[0]
    if v_range is None:
        lo = hi = torch.zeros(n, dtype=torch.float32, device=x.device)
    else:
        lo = torch.full((n,), float(np.float32(v_range[0])), dtype=torch.float32, device=x.device)
        hi = torch.full((n,), float(np.float32(v_range[1])), dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        return _histogram_k20(x, bins, rule, lo, hi, v_range is None)
    return _histogram_plain(x, bins, rule, lo, hi, v_range is None)


def _device_crops(crops: np.ndarray) -> torch.Tensor:
    """(n, h, w, C) crops as (n, h * w, C) on the selected device: uint8 as
    bytes (K20's uint8 entry), any other dtype as float32 (cast there)."""
    arr = np.ascontiguousarray(crops)
    if arr.dtype == np.uint8:
        t = torch.from_numpy(arr).to(get_device())
        return t.reshape(t.shape[0], -1, t.shape[-1])
    return _device_float(arr)


def histogram_features(arr: np.ndarray, bins: int, v_range: tuple[float, float]) -> np.ndarray:
    """Fixed-range histogram counts (``jnp.histogram``'s edges and search, K20)."""
    x = _device_crops(np.asarray(arr).reshape(1, -1, 1, 1))
    return to_host(crop_histogram(x, bins, (float(v_range[0]), float(v_range[1])), rule=1))[0, 0].astype(np.float32)


def histogram_features_batch(
    crops: np.ndarray, bins: int, v_range: tuple[float, float] | None
) -> np.ndarray:
    """Fixed-range histogram counts ``(n_crops, c, bins)`` in one K20 launch.

    ``v_range=None`` uses each crop's own range (the reference's behavior);
    the top edge is inclusive as in numpy.histogram."""
    return to_host(crop_histogram(_device_crops(crops), bins, v_range, rule=0)).astype(np.float32)


# ---------------------------------------------------------- regionprops


def _segment_stats(labels: np.ndarray, num_labels: int) -> dict[str, np.ndarray]:
    """Per-label area, coordinate sums and bounding boxes (float64), as
    ``squidpy_tpu/ops/features.py`` `_segment_stats` computes them under x64."""
    dev = get_device()
    h, w = labels.shape
    flat = torch.from_numpy(np.ascontiguousarray(labels).ravel().astype(np.int64)).to(dev)
    yy = torch.arange(h, dtype=torch.float64, device=dev).repeat_interleave(w)
    xx = torch.arange(w, dtype=torch.float64, device=dev).repeat(h)

    def ssum(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(num_labels, dtype=torch.float64, device=dev).index_add_(0, flat, v)

    def sred(v: torch.Tensor, how: str) -> torch.Tensor:
        init = float("inf") if how == "amin" else -float("inf")
        return torch.full((num_labels,), init, dtype=torch.float64, device=dev).scatter_reduce_(0, flat, v, how)

    out = {
        "area": ssum(torch.ones_like(yy)), "sy": ssum(yy), "sx": ssum(xx), "syy": ssum(yy * yy),
        "sxx": ssum(xx * xx), "sxy": ssum(xx * yy), "ymin": sred(yy, "amin"), "ymax": sred(yy, "amax"),
        "xmin": sred(xx, "amin"), "xmax": sred(xx, "amax"),
    }
    return {k: to_host(v) for k, v in out.items()}


def _segment_intensity(labels: np.ndarray, intensity: np.ndarray, num_labels: int) -> dict[str, np.ndarray]:
    """Per-label intensity sum, count, min and max (float64)."""
    dev = get_device()
    flat = torch.from_numpy(np.ascontiguousarray(labels).ravel().astype(np.int64)).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(intensity, dtype=np.float32).ravel()).to(dev).to(torch.float64)
    zeros = torch.zeros(num_labels, dtype=torch.float64, device=dev)
    out = {
        "sum": zeros.clone().index_add_(0, flat, v),
        "count": zeros.clone().index_add_(0, flat, torch.ones_like(v)),
        "min": torch.full_like(zeros, float("inf")).scatter_reduce_(0, flat, v, "amin"),
        "max": torch.full_like(zeros, -float("inf")).scatter_reduce_(0, flat, v, "amax"),
    }
    return {k: to_host(t) for k, t in out.items()}


def regionprops(
    label_image: np.ndarray,
    properties: list[str],
    intensity_image: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """Per-label region properties via device segment reductions.

    Returns skimage-``regionprops_table``-style arrays keyed by property name
    (centroid as ``centroid-0``/``centroid-1``). Labels are the sorted nonzero
    labels in the image.
    """
    label_image = np.ascontiguousarray(np.asarray(label_image))
    present = np.unique(label_image)
    present = present[present > 0]
    if not len(present):
        out: dict[str, np.ndarray] = {}
        for p in properties:
            if p == "centroid":
                out["centroid-0"] = np.empty(0)
                out["centroid-1"] = np.empty(0)
            else:
                out[p] = np.empty(0)
        out.setdefault("label", np.empty(0, dtype=np.int64))
        return out

    # compress labels to 0..n for segment reductions
    remap = np.zeros(int(label_image.max()) + 1, dtype=np.int32)
    remap[present] = np.arange(1, len(present) + 1)
    compressed = remap[label_image]
    n_seg = len(present) + 1

    stats = {k: v[1:] for k, v in _segment_stats(compressed, n_seg).items()}
    area = stats["area"]
    cy = stats["sy"] / area
    cx = stats["sx"] / area
    # central second moments
    mu20 = stats["syy"] / area - cy * cy
    mu02 = stats["sxx"] / area - cx * cx
    mu11 = stats["sxy"] / area - cx * cy
    # skimage uses inertia-tensor eigenvalues with +1/12 pixel-area correction omitted
    common = np.sqrt(np.maximum((mu20 - mu02) ** 2 + 4 * mu11**2, 0.0))
    l1 = (mu20 + mu02 + common) / 2.0
    l2 = (mu20 + mu02 - common) / 2.0
    l2 = np.maximum(l2, 0.0)

    out = {}
    intens = None
    if intensity_image is not None:
        intens = {k: v[1:] for k, v in _segment_intensity(compressed, intensity_image, n_seg).items()}

    for p in properties:
        if p == "label":
            out["label"] = present.astype(np.int64)
        elif p == "area":
            out["area"] = area
        elif p == "bbox_area":
            out["bbox_area"] = (stats["ymax"] - stats["ymin"] + 1) * (stats["xmax"] - stats["xmin"] + 1)
        elif p == "bbox":
            # skimage half-open convention: (min_row, min_col, max_row, max_col)
            out["bbox-0"] = stats["ymin"].astype(np.int64)
            out["bbox-1"] = stats["xmin"].astype(np.int64)
            out["bbox-2"] = stats["ymax"].astype(np.int64) + 1
            out["bbox-3"] = stats["xmax"].astype(np.int64) + 1
        elif p == "centroid":
            out["centroid-0"] = cy
            out["centroid-1"] = cx
        elif p == "eccentricity":
            with np.errstate(invalid="ignore", divide="ignore"):
                ecc = np.sqrt(np.maximum(1.0 - l2 / np.where(l1 == 0, 1.0, l1), 0.0))
            ecc[l1 == 0] = 0.0
            out["eccentricity"] = ecc
        elif p == "equivalent_diameter":
            out["equivalent_diameter"] = np.sqrt(4.0 * area / np.pi)
        elif p == "extent":
            bbox = (stats["ymax"] - stats["ymin"] + 1) * (stats["xmax"] - stats["xmin"] + 1)
            out["extent"] = area / bbox
        elif p == "major_axis_length":
            out["major_axis_length"] = 4.0 * np.sqrt(np.maximum(l1, 0.0))
        elif p == "minor_axis_length":
            out["minor_axis_length"] = 4.0 * np.sqrt(l2)
        elif p == "orientation":
            out["orientation"] = 0.5 * np.arctan2(2 * mu11, mu20 - mu02)
        elif p == "perimeter":
            out["perimeter"] = _perimeters(label_image, present)
        elif p in ("max_intensity", "min_intensity", "mean_intensity"):
            if intens is None:
                raise ValueError(f"Property `{p}` requires an intensity image.")
            if p == "max_intensity":
                out["max_intensity"] = intens["max"]
            elif p == "min_intensity":
                out["min_intensity"] = intens["min"]
            else:
                out["mean_intensity"] = intens["sum"] / intens["count"]
        elif p in ("convex_area", "solidity", "feret_diameter_max", "filled_area", "euler_number", "perimeter_crofton"):
            out.update(_host_props(label_image, present, p))
        else:
            raise ValueError(f"Unsupported region property `{p}`.")
    return out


def _perimeters(label_image: np.ndarray, present: np.ndarray) -> np.ndarray:
    """Boundary-pixel-count perimeter per label (4-connectivity transitions)."""
    out = np.zeros(len(present))
    padded = np.pad(label_image, 1)
    for k, lab in enumerate(present):
        mask = padded == lab
        # count exposed edges (transitions to background along x and y)
        edges = (
            np.sum(mask[1:, :] != mask[:-1, :]) + np.sum(mask[:, 1:] != mask[:, :-1])
        )
        out[k] = float(edges)
    return out


def _host_props(label_image: np.ndarray, present: np.ndarray, prop: str) -> dict[str, np.ndarray]:
    """Hull/topology props computed on host (scipy) per label."""
    from scipy import ndimage as ndi
    from scipy.spatial import ConvexHull
    from scipy.spatial.distance import pdist

    vals = np.zeros(len(present))
    for k, lab in enumerate(present):
        mask = label_image == lab
        ys, xs = np.nonzero(mask)
        pts = np.column_stack([ys, xs]).astype(float)
        if prop == "filled_area":
            vals[k] = float(ndi.binary_fill_holes(mask).sum())
        elif prop == "euler_number":
            filled = ndi.binary_fill_holes(mask)
            n_holes = int(ndi.label(filled & ~mask)[1])
            vals[k] = 1 - n_holes
        elif prop in ("convex_area", "solidity", "feret_diameter_max", "perimeter_crofton"):
            if len(pts) < 3:
                hull_area = float(len(pts))
                feret = float(pdist(pts).max()) if len(pts) > 1 else 0.0
            else:
                try:
                    hull = ConvexHull(pts)
                    hull_area = float(hull.volume) + len(pts) * 0  # lattice hull area
                    hp = pts[hull.vertices]
                    feret = float(pdist(hp).max())
                except Exception:
                    hull_area = float(len(pts))
                    feret = float(pdist(pts).max()) if len(pts) > 1 else 0.0
            if prop == "convex_area":
                vals[k] = max(hull_area, float(mask.sum()))
            elif prop == "solidity":
                vals[k] = float(mask.sum()) / max(hull_area, float(mask.sum()))
            elif prop == "feret_diameter_max":
                vals[k] = feret
            elif prop == "perimeter_crofton":
                # Crofton approximation from 4-direction intercept counts
                vals[k] = _perimeters(label_image, np.asarray([lab]))[0] * np.pi / 4.0
    return {prop: vals}
