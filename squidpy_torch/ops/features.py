"""Image features: GLCM texture (kernel K18), crop summaries (K19), crop
histograms (K20) and region properties (counterpart of
``squidpy_tpu/ops/features.py``).

Each kernel has its plain torch version beside it, which the CPU runs; a CUDA
tensor goes to the kernel, never to the plain version.

- K18 (``csrc/glcm.cu``): the co-occurrence counts of a batch of uint8
  crops, one (crop, channel) a block, and from exact integer sums over the
  pairs the skimage props in double (``_glcm_props_plain`` does the same
  operations in the same order). ``graycomatrix`` and ``glcm_batch`` return
  the counts, equal to JAX's; the props differ from JAX's float32 sums by
  their rounding only.
- K19 (``csrc/crop_summary.cu``): one sort per (crop, channel), the
  quantiles at JAX's positions, weights and rounding (``_quantile_table``:
  the batched kernel's rule, or ``jnp.quantile``'s), and the mean and std
  from double sums.
- K20 (``csrc/crop_histogram.cu``): the batched kernel's bin rule over a
  fixed or a per-crop range, or ``jnp.histogram``'s edges and search.

``regionprops``' segment reductions are plain torch ``index_add_`` /
``scatter_reduce`` in float64 on the device; ``graycoprops``,
``_perimeters`` and ``_host_props`` are host code, copied.
"""

from __future__ import annotations

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
PAIRS_MAX = 11_900_000  # pairs an offset for which S * sum i^2 (<= S^2 * 255^2) stays below 2^63
KERNEL_LEVELS = 256  # K18 takes uint8 crops
SMEM_KEYS = 32_768  # K19 sorts a channel of at most this many values in shared memory
LINSPACE_UNROLLED_BINS = 33  # XLA:CPU unrolls jnp.linspace's loop up to here: e_1 then fuses lo (1 - c)
SCRATCH_BLOCKS = 264  # grid of K18's and K19's global-scratch routes: two blocks an SM of an H100
_TREE = 256  # terms of the homogeneity's pairwise sum at up to 256 levels


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


def _pairs(img: torch.Tensor, dr: int, dc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (m, pairs) reference and partner values of offset (dr, dc) of
    ``img`` (m, h, w), over in-bounds pairs, row-major."""
    _, h, w = img.shape
    y0, y1, x0, x1 = max(0, -dr), min(h, h - dr), max(0, -dc), min(w, w - dc)
    if y1 <= y0 or x1 <= x0:
        empty = img.new_zeros((img.shape[0], 0))
        return empty, empty
    i = img[:, y0:y1, x0:x1].reshape(img.shape[0], -1)
    j = img[:, y0 + dr : y1 + dr, x0 + dc : x1 + dc].reshape(img.shape[0], -1)
    return i, j


def _glcm_counts_plain(img: torch.Tensor, offsets: list[tuple[int, int]], levels: int) -> torch.Tensor:
    """(m, n_off, levels^2) int64 counts of ``img`` (m, h, w): K18's count entry."""
    img = img.to(torch.int64)
    m = img.shape[0]
    out = torch.zeros((m, len(offsets), levels * levels), dtype=torch.int64, device=img.device)
    rows = torch.arange(m, device=img.device)[:, None] * (levels * levels)
    for o, (dr, dc) in enumerate(offsets):
        i, j = _pairs(img, dr, dc)
        ok = (i >= 0) & (j >= 0) & (i < levels) & (j < levels)
        flat = (rows + i * levels + j)[ok]
        out[:, o] = torch.bincount(flat, minlength=m * levels * levels).view(m, -1)
    return out


def _glcm_sums_plain(img: torch.Tensor, dr: int, dc: int, levels: int, symmetric: bool,
                     ignore_level: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """K18's integers of one offset for each of the m crops of ``img``:
    (m, 9) int64 sums (pairs, sum i, sum j, sum i^2, sum j^2, sum ij,
    sum |i - j|, sum (i - j)^2, sum of the squared counts over the full
    matrix, with ``symmetric`` of P + P^T) and the (m, levels) pairs at each
    |i - j|."""
    img = img.to(torch.int64)
    m = img.shape[0]
    i, j = _pairs(img, dr, dc)
    keep = (i >= 0) & (j >= 0) & (i < levels) & (j < levels)
    if ignore_level is not None:
        keep &= (i != ignore_level) & (j != ignore_level)
    w = keep.to(torch.int64)
    i, j = i * w, j * w
    d = (i - j).abs()
    sums = torch.stack([w.sum(1), i.sum(1), j.sum(1), (i * i).sum(1), (j * j).sum(1), (i * j).sum(1), d.sum(1),
                        (d * d).sum(1)], dim=1)
    hist = torch.zeros((m, levels), dtype=torch.int64, device=img.device).scatter_add_(1, d, w)
    rows = torch.arange(m, device=img.device)[:, None] * (levels * levels)
    if symmetric:
        cell, inc = torch.minimum(i, j) * levels + torch.maximum(i, j), w * (1 + (i == j).to(torch.int64))
    else:
        cell, inc = i * levels + j, w
    counts = torch.zeros(m * levels * levels, dtype=torch.int64, device=img.device)
    counts.index_add_(0, (rows + cell).reshape(-1), inc.reshape(-1))
    counts = counts.view(m, levels * levels)
    sq = counts * counts
    if symmetric:  # an upper cell off the diagonal stands for two mirrored cells
        diag = torch.arange(levels, device=img.device) * (levels + 1)
        sq = 2 * sq
        sq[:, diag] //= 2
    return torch.cat([sums, sq.sum(1, keepdim=True)], dim=1), hist


def _glcm_props_plain(sums: torch.Tensor, hist: torch.Tensor, symmetric: bool) -> torch.Tensor:
    """(..., 6) float64 props (``GLCM_PROPS`` order) from K18's integers, the
    operations of ``csrc/glcm.cu`` `glcm_props_from_sums` and
    `homogeneity_tree` in the same order."""
    S, Si, Sj, Sii, Sjj, Sij, D1, D2, Q = sums.unbind(-1)
    if symmetric:
        S, Si, Sj, Sii, Sjj, Sij, D1, D2 = 2 * S, Si + Sj, Si + Sj, Sii + Sjj, Sii + Sjj, 2 * Sij, 2 * D1, 2 * D2
        hist = 2 * hist
    n_terms = max(_TREE, 1 << (hist.shape[-1] - 1).bit_length())
    d = torch.arange(n_terms, dtype=torch.int64, device=hist.device)
    counts = torch.nn.functional.pad(hist, (0, n_terms - hist.shape[-1]))
    terms = counts.to(torch.float64) / (1.0 + (d * d).to(torch.float64))
    while terms.shape[-1] > 1:
        terms = terms[..., 0::2] + terms[..., 1::2]
    homog = terms[..., 0]
    sd = torch.where(S == 0, torch.ones_like(S), S).to(torch.float64)
    asm = Q.to(torch.float64) / (sd * sd)
    vi, vj, cov = S * Sii - Si * Si, S * Sjj - Sj * Sj, S * Sij - Si * Sj
    corr = torch.where((vi == 0) | (vj == 0), torch.ones_like(asm),
                       cov.to(torch.float64) / torch.sqrt(vi.to(torch.float64) * vj.to(torch.float64)))
    return torch.stack([D2.to(torch.float64) / sd, D1.to(torch.float64) / sd, homog / sd, asm, torch.sqrt(asm), corr],
                       dim=-1)


def _max_pairs(h: int, w: int, offsets: list[tuple[int, int]]) -> int:
    return max(max(h - abs(dr), 0) * max(w - abs(dc), 0) for dr, dc in offsets)


def k18_packed(h: int, w: int, offsets: list[tuple[int, int]], symmetric: bool) -> bool:
    """K18's route: the 16-bit shared counters hold every cell of an offset
    (``symmetric`` counts 2 a pair on the diagonal), else global uint32."""
    return _max_pairs(h, w, offsets) * (2 if symmetric else 1) <= PACKED_MAX


def _glcm_k18(imgs: torch.Tensor, channels: list[int], offsets: list[tuple[int, int]], levels: int,
              symmetric: bool, ignore_level: int | None, counts: bool) -> torch.Tensor:
    """K18 on ``imgs`` (n, h, w, C) uint8 on the card: props (n, len(channels),
    n_off, 6) float64, or with ``counts`` the (n * len(channels), n_off,
    levels^2) counts."""
    n, h, w, n_c = imgs.shape
    if levels > KERNEL_LEVELS:
        raise ValueError(f"K18 counts uint8 crops: at most {KERNEL_LEVELS} levels on the card, found `{levels}`.")
    if _max_pairs(h, w, offsets) > PAIRS_MAX:
        raise ValueError(f"K18 takes at most {PAIRS_MAX} pixel pairs an offset, found crops of {h} x {w}.")
    _cuda.require(imgs, "images", torch.uint8)
    dev = imgs.device
    n_items, n_off = n * len(channels), len(offsets)
    ch = torch.tensor(channels, dtype=torch.int32, device=dev)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev).reshape(-1, 2).contiguous()
    packed = k18_packed(h, w, offsets, symmetric)
    grid = min(n_items, SCRATCH_BLOCKS)
    gcells = None if packed else torch.empty((grid, levels * levels), dtype=torch.int32, device=dev)
    props = counts_out = None
    if counts:
        counts_out = torch.empty((n_items, n_off, levels * levels), dtype=torch.int32, device=dev)
    else:
        props = torch.empty((n_items, n_off, 6), dtype=torch.float64, device=dev)
    if n_items and n_off:
        code = _cuda.library().sqt_glcm(
            imgs.data_ptr(), n, len(channels), ch.data_ptr(), h, w, h * w * n_c, n_c, offs.data_ptr(), n_off, levels,
            int(symmetric), -1 if ignore_level is None else int(ignore_level), int(packed), SCRATCH_BLOCKS,
            None if gcells is None else gcells.data_ptr(), None if props is None else props.data_ptr(),
            None if counts_out is None else counts_out.data_ptr(), _cuda.stream_ptr())
        _cuda.check(code, "glcm")
        _cuda.launches["glcm"] += 1
    if counts:
        return counts_out.to(torch.int64)
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


def _summary_k19(x: torch.Tensor, table: tuple[np.ndarray, ...], rule: int) -> tuple[torch.Tensor, ...]:
    n, p, n_c = x.shape
    _cuda.require(x, "crops", torch.float32)
    dev = x.device
    lo, hi, wlo, whi = (torch.from_numpy(t).to(dev) for t in table)
    nq = len(table[0])
    if nq > 1024:
        raise ValueError(f"K19 takes at most 1024 quantiles, found `{nq}`.")
    p2 = 1 << max(p - 1, 0).bit_length()
    gkeys = None if p2 <= SMEM_KEYS else torch.empty((min(n * n_c, SCRATCH_BLOCKS), p2), dtype=torch.int32,
                                                          device=dev)
    quant = torch.empty((n, nq, n_c), dtype=torch.float32, device=dev)
    mean = torch.empty((n, n_c), dtype=torch.float32, device=dev)
    std = torch.empty((n, n_c), dtype=torch.float32, device=dev)
    if n * n_c and p:
        code = _cuda.library().sqt_crop_summary(
            x.data_ptr(), n, p, n_c, p2, nq, lo.data_ptr(), hi.data_ptr(), wlo.data_ptr(), whi.data_ptr(), rule,
            SCRATCH_BLOCKS, None if gkeys is None else gkeys.data_ptr(), quant.data_ptr(), mean.data_ptr(),
            std.data_ptr(), _cuda.stream_ptr())
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
    """K20's plain version on ``x`` (n, p, C) float32: (n, C, bins) int64."""
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


def _histogram_k20(x: torch.Tensor, bins: int, rule: int, lo: torch.Tensor, hi: torch.Tensor,
                   per_crop_range: bool) -> torch.Tensor:
    n, p, n_c = x.shape
    _cuda.require(x, "crops", torch.float32)
    if rule == 1 and bins + 1 > 1024:
        raise ValueError(f"K20 takes at most 1023 bins by `jnp.histogram`'s rule, found `{bins}`.")
    counts = torch.empty((n, n_c, bins), dtype=torch.int32, device=x.device)
    if n:
        code = _cuda.library().sqt_crop_histogram(x.data_ptr(), n, p, n_c, bins, rule, lo.data_ptr(), hi.data_ptr(),
                                                  int(per_crop_range), counts.data_ptr(), _cuda.stream_ptr())
        _cuda.check(code, "crop_histogram")
        _cuda.launches["crop_histogram"] += 1
    return counts.to(torch.int64)


def crop_histogram(x: torch.Tensor, bins: int, v_range: tuple[float, float] | None, rule: int = 0) -> torch.Tensor:
    """(n, C, bins) counts of ``x`` (n, p, C) float32 over ``v_range`` or,
    with None (rule 0 only), each crop's own range."""
    n = x.shape[0]
    if v_range is None:
        lo = hi = torch.zeros(n, dtype=torch.float32, device=x.device)
    else:
        lo = torch.full((n,), float(np.float32(v_range[0])), dtype=torch.float32, device=x.device)
        hi = torch.full((n,), float(np.float32(v_range[1])), dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        return _histogram_k20(x, bins, rule, lo, hi, v_range is None)
    return _histogram_plain(x, bins, rule, lo, hi, v_range is None)


def histogram_features(arr: np.ndarray, bins: int, v_range: tuple[float, float]) -> np.ndarray:
    """Fixed-range histogram counts (``jnp.histogram``'s edges and search, K20)."""
    x = _device_float(np.asarray(arr, dtype=np.float32).reshape(1, -1, 1))
    return to_host(crop_histogram(x, bins, (float(v_range[0]), float(v_range[1])), rule=1))[0, 0].astype(np.float32)


def histogram_features_batch(
    crops: np.ndarray, bins: int, v_range: tuple[float, float] | None
) -> np.ndarray:
    """Fixed-range histogram counts ``(n_crops, c, bins)`` in one K20 launch.

    ``v_range=None`` uses each crop's own range (the reference's behavior);
    the top edge is inclusive as in numpy.histogram."""
    return to_host(crop_histogram(_device_float(crops), bins, v_range, rule=0)).astype(np.float32)


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
