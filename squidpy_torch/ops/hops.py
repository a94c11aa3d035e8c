"""k-hop ring and reach expansion of a padded ELL graph (counterpart of ``squidpy_tpu/ops/hops.py``).

Kernel K13 (``csrc/hops.cu``) on the card; its plain torch version below on
the CPU. Per row and per hop, both do what the JAX package's ``_deg_pass``
and ``_emit_pass`` do: gather the candidates ``base[ring]`` with path
weights ``ring_w * base_w``, merge them with the row's visited entries,
sum each index's run, keep an index by the ring rule ``run_w > run_v``
(or, for the reach pattern of ``A^k``, ``run_w > 0``), and write the ring
ELL in ascending index order, padded with index ``n``, at a width
rounded up to :data:`_WIDTH_BUCKETS`; for :func:`hop_rings` also the new
visited ELL with values ``run_v + keep``. A run is summed in one fixed
order that both versions share: the candidates by (ring slot, base slot),
then the visited entry, left to right from 0. The JAX package reads run
sums as differences of prefix sums; on binary graphs every sum is an
exact integer, so both packages agree bit for bit there, and on weighted
graphs a ring set may differ only where ``run_w`` and ``run_v`` lie
within a few ulps, and a visited value, which the port keeps as it is,
by a few ulps of the row's total.

On the card each row is gathered and sorted once a hop: K13's warp route
stages each row's kept entries at widths chosen from the input widths, the
rows past a warp's shared memory take a block each through device memory
in the same stream, one read-back gives the maximum degrees and the count
of rows past the staging widths, and a copy places the staged rows into
the bucketed ELLs (:func:`_hop_k13`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from scipy import sparse as sp

from squidpy_torch import _cuda
from squidpy_torch._device import get_device

__all__ = ["ell_sentinel", "hop_expand", "hop_reach", "hop_rings"]

_WIDTH_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)

# K13's warp route keeps up to this many of a row's candidates and visited
# entries in shared memory as one packed word each (csrc/hops.cu
# kCapPacked), or this many 64-bit keys and weights (kCapWide); a longer
# row takes the block route through device memory, a few hundred blocks at
# a time
_K13_WARP_CAP = 1024
_K13_WARP_CAP_64 = 512
_K13_BLOCKS = 264
_K13_SCRATCH_BYTES = 1 << 28
_PLAIN_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}  # (rows, W) temporaries of the plain version


def _bucket(v: int) -> int:
    for b in _WIDTH_BUCKETS:
        if b >= v:
            return b
    return int(v)


def ell_sentinel(adj: sp.spmatrix, *, drop_diag: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> padded ELL ``(idx int32, w float32)`` with index ``n`` (weight 0)
    in empty slots, at a bucketed width (copied from the JAX package)."""
    adj = sp.csr_matrix(adj)
    n = adj.shape[0]
    indices, data = adj.indices, adj.data
    rows = np.repeat(np.arange(n), np.diff(adj.indptr))
    if drop_diag:
        keep = indices != rows
        rows, indices, data = rows[keep], indices[keep], data[keep]
    deg = np.bincount(rows, minlength=n)
    k = _bucket(max(int(deg.max()) if n else 1, 1))
    idx = np.full((n, k), n, dtype=np.int32)
    w = np.zeros((n, k), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(indices)) - starts[rows]
    idx[rows, slot] = indices
    w[rows, slot] = data
    return idx, w


def _compact(keep: torch.Tensor, m_idx: torch.Tensor, n: int, values: torch.Tensor | None = None):
    """Each row's kept entries in their (ascending) order, padded with ``n``
    (values with 0), at the chunk's own largest degree."""
    deg = keep.sum(dim=1, dtype=torch.int32)
    width = max(int(deg.max()) if deg.numel() else 0, 1)
    pos = torch.cumsum(keep, dim=1) - 1
    rows = torch.nonzero(keep, as_tuple=True)[0]
    cols = pos[keep]
    out = torch.full((keep.shape[0], width), n, dtype=torch.int32, device=keep.device)
    out[rows, cols] = m_idx[keep].to(torch.int32)
    if values is None:
        return out, deg
    val = torch.zeros((keep.shape[0], width), dtype=torch.float32, device=keep.device)
    val[rows, cols] = values[keep]
    return out, deg, val


def _hop_plain_rows(base_idx, base_w, ring_idx, ring_w, vis_idx, vis_val, n: int):
    """One hop for a block of rows (their ring and visited ELLs)."""
    c, r_width = ring_idx.shape
    k1 = base_idx.shape[1]
    safe = torch.clamp(ring_idx, max=n - 1).long()
    g_idx = base_idx[safe]  # (c, R, k1)
    g_w = base_w[safe]
    valid = (ring_idx < n)[:, :, None] & (g_idx < n)
    cand_idx = torch.where(valid, g_idx, n).reshape(c, r_width * k1)
    cand_w = torch.where(valid, ring_w[:, :, None] * g_w, 0.0).reshape(c, r_width * k1)
    if vis_idx is None:
        m_idx, m_w, m_v = cand_idx, cand_w, torch.zeros_like(cand_w)
    else:
        m_idx = torch.cat([cand_idx, vis_idx], dim=1)
        m_w = torch.cat([cand_w, torch.zeros_like(vis_val)], dim=1)
        m_v = torch.cat([torch.zeros_like(cand_w), vis_val], dim=1)
    m_idx, perm = torch.sort(m_idx, dim=1, stable=True)
    m_w, m_v = m_w.gather(1, perm), m_v.gather(1, perm)
    step = m_idx[:, 1:] != m_idx[:, :-1]
    ones = torch.ones((c, 1), dtype=torch.bool, device=m_idx.device)
    head, tail = torch.cat([ones, step], dim=1), torch.cat([step, ones], dim=1)
    # each run summed left to right from 0, as the kernel sums it
    run_w, run_v = torch.empty_like(m_w), torch.empty_like(m_v)
    sw = sv = torch.zeros(c, dtype=torch.float32, device=m_idx.device)
    for j in range(m_idx.shape[1]):
        sw = torch.where(head[:, j], 0.0, sw) + m_w[:, j]
        sv = torch.where(head[:, j], 0.0, sv) + m_v[:, j]
        run_w[:, j], run_v[:, j] = sw, sv
    is_entry = tail & (m_idx < n)
    ring_keep = is_entry & (run_w > run_v)
    ring = _compact(ring_keep, m_idx, n)
    if vis_idx is None:
        return ring, None
    vis_keep = is_entry & ((run_v > 0) | ring_keep)
    return ring, _compact(vis_keep, m_idx, n, run_v + ring_keep.to(torch.float32))


def _pad_cols(t: torch.Tensor, width: int, fill: float) -> torch.Tensor:
    if t.shape[1] == width:
        return t
    pad = torch.full((t.shape[0], width - t.shape[1]), fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1)


def _hop_plain(base_idx, base_w, ring_idx, ring_w, vis_idx, vis_val):
    """Plain torch version of K13: one hop of every row, in row blocks.
    Returns ``(r_idx, r_deg, v_idx, v_val, v_deg)`` at bucketed widths
    (the last three None without a visited ELL)."""
    n, k1 = base_idx.shape
    width = ring_idx.shape[1] * k1 + (vis_idx.shape[1] if vis_idx is not None else 0)
    rows = max(1, _PLAIN_ELEMS[ring_idx.device.type] // max(width, 1))
    parts = []
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        parts.append(_hop_plain_rows(base_idx, base_w, ring_idx[sl], ring_w[sl],
                                     vis_idx[sl] if vis_idx is not None else None,
                                     vis_val[sl] if vis_idx is not None else None, n))
    r_deg = torch.cat([p[0][1] for p in parts])
    w_out = _bucket(max(int(r_deg.max()) if n else 0, 1))
    r_idx = torch.cat([_pad_cols(p[0][0], w_out, n) for p in parts])
    if vis_idx is None:
        return r_idx, r_deg, None, None, None
    v_deg = torch.cat([p[1][1] for p in parts])
    v_out = _bucket(max(int(v_deg.max()) if n else 0, 1))
    v_idx = torch.cat([_pad_cols(p[1][0], v_out, n) for p in parts])
    v_val = torch.cat([_pad_cols(p[1][2], v_out, 0.0) for p in parts])
    return r_idx, r_deg, v_idx, v_val, v_deg


def _launch(entry: str, *args) -> None:
    """One call into K13's C interface, counted as one launch of K13."""
    _cuda.check(getattr(_cuda.library(), entry)(*args), "hops")
    _cuda.launches["hops"] += 1


def _check_hop_args(base_idx, base_w, ring_idx, ring_w, vis_idx, vis_val) -> None:
    n, k1 = base_idx.shape
    r_width = ring_idx.shape[1]
    for t, name, dt in ((base_idx, "base_idx", torch.int32), (base_w, "base_w", torch.float32),
                        (ring_idx, "ring_idx", torch.int32), (ring_w, "ring_w", torch.float32)):
        _cuda.require(t, name, dt)
    _cuda.require(ring_idx, "ring_idx", torch.int32, (n, r_width))
    _cuda.require(base_w, "base_w", torch.float32, (n, k1))
    _cuda.require(ring_w, "ring_w", torch.float32, (n, r_width))
    if vis_idx is not None:
        _cuda.require(vis_idx, "vis_idx", torch.int32, (n, vis_idx.shape[1]))
        _cuda.require(vis_val, "vis_val", torch.float32, (n, vis_idx.shape[1]))
    v_width = vis_idx.shape[1] if vis_idx is not None else 0
    if n >= 2**31 - 1 or r_width * k1 + v_width >= 2**31:
        raise ValueError("K13 takes fewer than 2^31 - 1 rows and candidates a row.")


def _pad4(idx: torch.Tensor, val: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """An ELL padded with index ``n`` (value 0) to a width that is a
    multiple of 4, for K13's 16-byte loads. Positions keep their order
    (``r * k1 + j`` orders (r, j) alike at any ``k1``), so no result moves."""
    pad = -idx.shape[1] % 4
    if not pad:
        return idx, val
    fill_i = torch.full((idx.shape[0], pad), n, dtype=idx.dtype, device=idx.device)
    fill_v = torch.zeros((idx.shape[0], pad), dtype=val.dtype, device=val.device)
    return torch.cat([idx, fill_i], dim=1).contiguous(), torch.cat([val, fill_v], dim=1).contiguous()


def _k13_keys(n: int, positions: int) -> tuple[int, int]:
    """The position bits ``p`` of a row's ``positions`` and the key width:
    32 where ``(n + 1) << p`` fits in 32 bits (one packed word an element),
    else 64."""
    p = max(1, (positions - 1).bit_length())
    return p, (32 if ((n + 1) << p) < 2**32 else 64)


def _k13_stage_width(r_width: int, k1: int) -> int:
    """The staging ring width of a hop, from its input widths alone: four
    ring widths (at least 32), at most the row's candidate slots. A row
    past it (or past ``V`` more for its visited entries) is placed by the
    block route after the hop's read-back."""
    return min(r_width * k1, max(4 * r_width, 32))


def _hop_k13(base_idx, base_w, ring_idx, ring_w, vis_idx, vis_val, cap: int | None = None,
             key_bits: int | None = None, stage_width: int | None = None, stats: dict[str, Any] | None = None):
    """K13: one hop of every row on the card, each row gathered and sorted
    once. The warp route stages each row's kept entries (32-bit packed keys
    where they fit, or ``key_bits=64``), the block route takes the rows past
    the warp's capacity ``cap`` through the device's count, one read-back
    gives the maximum degrees and the count of rows past the staging widths
    (``stage_width``, by default :func:`_k13_stage_width`), then a copy
    places the staged rows into the bucketed ELLs and the block route
    writes the late rows into them. Given ``stats``, it fills it with the
    key width, the staging widths and the listed rows (read back apart: a
    second read-back)."""
    if (vis_idx is None) != (vis_val is None):
        raise ValueError("`vis_idx` and `vis_val` come together.")
    n = base_idx.shape[0]
    use_vis = vis_idx is not None
    k1, r_width = -(-base_idx.shape[1] // 4) * 4, ring_idx.shape[1]
    v_width = -(-vis_idx.shape[1] // 4) * 4 if use_vis else 0
    pbits, fit = _k13_keys(n, r_width * k1 + v_width)
    key_bits = key_bits or fit
    if key_bits not in (32, 64) or (key_bits == 32 and fit == 64):
        raise ValueError(f"K13 cannot take {key_bits}-bit keys for {n} rows of {r_width * k1 + v_width} positions.")
    limit = _K13_WARP_CAP if key_bits == 32 else _K13_WARP_CAP_64
    cap = limit if cap is None else cap
    if not 1 <= cap <= limit:
        raise ValueError(f"K13's warp capacity must lie in [1, {limit}], found {cap}.")
    _check_hop_args(base_idx, base_w, ring_idx, ring_w, vis_idx, vis_val)
    base_idx, base_w = _pad4(base_idx, base_w, n)
    if use_vis:
        vis_idx, vis_val = _pad4(vis_idx, vis_val, n)
    w_stage = stage_width or _k13_stage_width(r_width, k1)
    v_stage = v_width + w_stage if use_vis else 0
    dev = ring_idx.device
    i32 = dict(dtype=torch.int32, device=dev)
    r_stage = torch.empty((n, w_stage), **i32)
    v_stage_idx = torch.empty((n, v_stage), **i32) if use_vis else None
    v_stage_val = torch.empty((n, v_stage), dtype=torch.float32, device=dev) if use_vis else None
    r_deg, v_deg = torch.empty(n, **i32), torch.empty(n, **i32)
    over_rows, late_rows = torch.empty(n, **i32), torch.empty(n, **i32)
    counters = torch.zeros(2, **i32)  # rows past the warp's capacity; rows past the staging widths
    p = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    graph = (p(base_idx), p(base_w), n, k1, p(ring_idx), p(ring_w), r_width, p(vis_idx), p(vis_val), v_width)
    stage = (w_stage, v_stage, p(r_stage), p(v_stage_idx), p(v_stage_val))
    n_over, n_late = counters[0:1], counters[1:2]
    base_deg = (base_idx < n).sum(dim=1, dtype=torch.int32)  # a row's element count, read without its base rows
    _launch("sqt_hops_warp", graph[0], graph[1], p(base_deg), *graph[2:], key_bits, pbits, cap, *stage, p(r_deg),
            p(v_deg), p(over_rows), p(n_over), p(late_rows), p(n_late), _cuda.stream_ptr())
    span = 1 << max(0, (r_width * k1 + v_width - 1).bit_length())
    blocks = max(1, min(_K13_BLOCKS, _K13_SCRATCH_BYTES // (12 * span)))
    keys = torch.empty(blocks * span, dtype=torch.int64, device=dev)
    vals = torch.empty(blocks * span, dtype=torch.float32, device=dev)
    block = lambda mode, rows, count, nb, outs: _launch(  # noqa: E731
        "sqt_hops_block", mode, *graph, p(rows), p(count), nb, span, p(keys), p(vals), *stage, p(r_deg), p(v_deg),
        p(late_rows), p(n_late), *outs, _cuda.stream_ptr())
    block(0, over_rows, n_over, blocks, (0, 0, None, None, None))
    max_r, max_v, late = torch.stack([r_deg.max(), v_deg.max(), n_late[0]]).tolist()  # the hop's one read-back
    w_out = _bucket(max(max_r, 1))
    v_out = _bucket(max(max_v, 1)) if use_vis else 0
    r_idx = torch.empty((n, w_out), **i32)
    v_idx = torch.empty((n, v_out), **i32) if use_vis else None
    v_val = torch.empty((n, v_out), dtype=torch.float32, device=dev) if use_vis else None
    outs = (w_out, v_out, p(r_idx), p(v_idx), p(v_val))
    _launch("sqt_hops_place", n, v_width, w_stage, v_stage, p(r_stage), p(v_stage_idx), p(v_stage_val), p(r_deg),
            p(v_deg), *outs, _cuda.stream_ptr())
    if late:
        block(1, late_rows, n_late, min(blocks, late), outs)
    if stats is not None:
        stats.update(key_bits=key_bits, over_rows=int(n_over[0]), late_rows=late, w_stage=w_stage,
                     v_stage=v_stage)
    if not use_vis:
        return r_idx, r_deg, None, None, None
    return r_idx, r_deg, v_idx, v_val, v_deg


def hop_expand(base_idx: torch.Tensor, base_w: torch.Tensor, ring_idx: torch.Tensor, ring_w: torch.Tensor,
               vis_idx: torch.Tensor | None = None, vis_val: torch.Tensor | None = None):
    """Kernel K13: one hop of a padded ELL graph (index ``n`` pads).

    ``base_idx``/``base_w`` (n, k1) int32/float32 are the graph, ``ring_idx``/
    ``ring_w`` (n, R) the last ring, ``vis_idx``/``vis_val`` (n, V) the
    visited entries (None for the reach pattern of ``A^k``). Returns
    ``(r_idx, r_deg, v_idx, v_val, v_deg)``: the new ring (n, w_out) int32
    in ascending index order with its (n,) int32 degrees and, with a
    visited ELL, the new one (n, v_out) int32 / float32 with its degrees;
    widths are the maxima rounded up to :data:`_WIDTH_BUCKETS`. A CPU
    tensor runs the plain torch version; a CUDA tensor launches the kernel.
    """
    if (vis_idx is None) != (vis_val is None):
        raise ValueError("`vis_idx` and `vis_val` come together.")
    if ring_idx.device.type == "cpu":
        return _hop_plain(base_idx, base_w, ring_idx, ring_w, vis_idx, vis_val)
    return _hop_k13(base_idx, base_w, ring_idx, ring_w, vis_idx, vis_val)


def _expand_hops(base_idx, base_w, ring_idx, ring_w, distance: int, *, use_visited: bool):
    """Hops k = 2..distance from ring 1, yielding ``[(idx, deg), ...]``."""
    n = base_idx.shape[0]
    vis_idx = vis_val = None
    if use_visited:
        # visited = setdiag(A, 1): the self entry (value 1), then the off-diagonal base
        self_idx = torch.arange(n, dtype=torch.int32, device=base_idx.device)[:, None]
        off = torch.where(base_idx == self_idx, n, base_idx)
        vis_idx = torch.cat([self_idx, off], dim=1).contiguous()
        vis_val = torch.cat([torch.ones((n, 1), dtype=torch.float32, device=base_idx.device),
                             torch.where(off < n, base_w, 0.0)], dim=1).contiguous()
    hops = []
    for _ in range(2, distance + 1):
        ring_idx, r_deg, vis_idx, vis_val, _ = hop_expand(base_idx, base_w, ring_idx.contiguous(),
                                                          ring_w.contiguous(), vis_idx, vis_val)
        ring_w = (ring_idx < n).to(torch.float32)
        hops.append((ring_idx, r_deg))
    return hops


def _as_ell(base_idx, base_w) -> tuple[torch.Tensor, torch.Tensor]:
    dev = base_idx.device if isinstance(base_idx, torch.Tensor) else get_device()
    return (torch.as_tensor(base_idx, dtype=torch.int32, device=dev).contiguous(),
            torch.as_tensor(base_w, dtype=torch.float32, device=dev).contiguous())


def hop_rings(base_idx, base_w, distance: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The exact rings of squidpy's ``_hop`` for k = 2..distance.

    ``base_idx``/``base_w``: the sentinel-padded ELL of the adjacency
    (diagonal included if present), tensors or numpy arrays (these go to the
    selected device). Ring 1 is the base without its diagonal. Returns
    ``[(idx, deg), ...]``: binary rings, whose normalised weights are
    ``(idx < n) / deg``."""
    base_idx, base_w = _as_ell(base_idx, base_w)
    n = base_idx.shape[0]
    self_idx = torch.arange(n, dtype=torch.int32, device=base_idx.device)[:, None]
    r1_idx = torch.where(base_idx == self_idx, n, base_idx)
    r1_w = torch.where(r1_idx < n, base_w, 0.0)
    return _expand_hops(base_idx, base_w, r1_idx, r1_w, distance, use_visited=True)


def hop_reach(base_idx, base_w, distance: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The patterns of ``A^k`` for k = 2..distance (the neighborhood
    flavor: its profile counts stored entries, so values do not matter).
    Returns ``[(idx, deg), ...]``."""
    base_idx, base_w = _as_ell(base_idx, base_w)
    n = base_idx.shape[0]
    return _expand_hops(base_idx, base_w, base_idx, (base_idx < n).to(torch.float32), distance, use_visited=False)
