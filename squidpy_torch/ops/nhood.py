"""Cluster-pair edge counts (counterpart of ``squidpy_tpu/ops/nhood.py``).

``counts[p, a, b]`` is the number of stored edges ``i -> j`` (mask set) with
``src[i, p] = a`` and ``table[j, p] = b``. On a CUDA tensor the count runs as
kernel K3 (``csrc/pair_counts.cu``), a per-block integer histogram in one of
three branches that :func:`_k3_layout` picks from the shapes; on the CPU it
runs the plain torch version below. Counts are exact int32 per
permutation (at most ``n * k_max`` edges), so the JAX package's 2^23-edge f32
chunking is not needed; callers sum across permutations in int64 or float64.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from squidpy_torch import _cuda

__all__ = [
    "analytic_pair_count_moments",
    "cluster_pair_counts",
    "pair_counts_cols",
    "permuted_pair_counts_cols",
]

# shared-memory budget of one shared-branch K3 block's (P_blk, C, C) int32
# histogram; a single column's C x C above it takes the global-atomics branch
_K3_SMEM_BYTES = 96 * 1024
_K3_MAX_P_BLK = 64
_K3_TARGET_BLOCKS = 1056  # 8 blocks per SM of an H100
# packed branch: C <= 16 and at least 32 columns; 128 columns a block of 512
# threads, 3 such blocks resident an SM (64 KB of shared memory each); uint16
# counters, so a block counts at most 65,535 // k_max rows
_K3_PACKED_MAX_CLS = 16
_K3_PACKED_MIN_COLS = 32
_K3_PACKED_COLS = 128
_K3_PACKED_RESIDENT = 3
_K3_COUNTER_MAX = 65_535
_H100_SMS = 132
_K3_BRANCHES = {"packed": 0, "shared": 1, "global": 2}


class K3Layout(NamedTuple):
    """A K3 launch: its branch, the columns and rows of a block, and the grid."""

    branch: str  # "packed", "shared" or "global"
    cols_per_block: int  # 128 (packed) or P_blk, a power of two <= 64
    row_blocks: int
    rows_per_block: int
    blocks: int


def _pair_counts_plain(
    indices: torch.Tensor, mask: torch.Tensor, src_cols: torch.Tensor, table_cols: torch.Tensor, n_cls: int
) -> torch.Tensor:
    """Plain torch version of K3: a bincount over row chunks."""
    n, k = indices.shape
    p = src_cols.shape[1]
    cc = n_cls * n_cls
    out = torch.zeros(p * cc, dtype=torch.int64, device=indices.device)
    col_off = torch.arange(p, device=indices.device) * cc
    rows = max(1, (1 << 22) // max(k * p, 1))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        src = src_cols[r0:r1].to(torch.int64)[:, None, :]  # (r, 1, P)
        nbr = table_cols[indices[r0:r1].to(torch.int64)].to(torch.int64)  # (r, k, P)
        ok = mask[r0:r1][:, :, None] & (src >= 0) & (src < n_cls) & (nbr >= 0) & (nbr < n_cls)
        flat = col_off + src * n_cls + nbr
        out += torch.bincount(flat[ok], minlength=p * cc)
    return out.view(p, n_cls, n_cls).to(torch.int32)


def _k3_layout(n: int, n_cols: int, n_cls: int, k_max: int, sms: int = _H100_SMS) -> K3Layout:
    """The K3 launch for these shapes on a card with ``sms`` SMs.

    Packed when ``C <= 16`` and ``P >= 32`` (and ``k_max <= 65,535``): row
    blocks of at most ``65,535 // k_max`` rows, as many as round the grid up
    to whole waves of resident blocks. Otherwise a shared (P_blk, C, C) int32
    histogram, or global atomics when one column's does not fit.
    """
    if n_cls <= _K3_PACKED_MAX_CLS and n_cols >= _K3_PACKED_MIN_COLS and k_max <= _K3_COUNTER_MAX:
        groups = -(-n_cols // _K3_PACKED_COLS)
        row_blocks = max(1, -(-n // (_K3_COUNTER_MAX // max(k_max, 1))))
        resident = _K3_PACKED_RESIDENT * sms
        waves = -(-row_blocks * groups // resident)
        row_blocks = max(row_blocks, waves * resident // groups)
        rows = max(1, -(-n // row_blocks))
        row_blocks = max(1, -(-n // rows))
        return K3Layout("packed", _K3_PACKED_COLS, row_blocks, rows, row_blocks * groups)
    cc4 = n_cls * n_cls * 4
    p_blk = 1
    while p_blk < min(n_cols, _K3_MAX_P_BLK):  # a power of two, so it divides the 256 threads
        p_blk *= 2
    while p_blk > 1 and p_blk * cc4 > _K3_SMEM_BYTES:
        p_blk //= 2
    shared = p_blk * cc4 <= _K3_SMEM_BYTES
    col_blocks = -(-n_cols // p_blk)
    row_blocks = max(1, min(-(-n // 256), -(-_K3_TARGET_BLOCKS // col_blocks)))
    rows = max(1, -(-n // row_blocks))
    return K3Layout("shared" if shared else "global", p_blk, row_blocks, rows, row_blocks * col_blocks)


def pair_counts_cols(
    indices: torch.Tensor,
    mask: torch.Tensor,
    src_cols: torch.Tensor,
    table_cols: torch.Tensor,
    n_cls: int,
    *,
    stats: dict | None = None,
) -> torch.Tensor:
    """Kernel K3: exact ``(P, C, C)`` int32 pair counts of ``(n, P)`` label columns.

    ``indices`` (n, k) int32 and ``mask`` (n, k) bool are the padded-ELL
    graph; ``src_cols`` and ``table_cols`` hold the source rows' labels and
    the table the neighbour indices point into (uint8 or int32). A CPU tensor
    runs the plain torch version; a CUDA tensor launches the kernel. Given
    ``stats``, the launch's :class:`K3Layout` fields are stored in it.
    """
    if indices.device.type == "cpu":
        return _pair_counts_plain(indices, mask, src_cols, table_cols, n_cls)
    return _launch_k3(indices, mask, src_cols, table_cols, n_cls, count=True, stats=stats)


def _launch_k3(
    indices: torch.Tensor,
    mask: torch.Tensor,
    src_cols: torch.Tensor,
    table_cols: torch.Tensor,
    n_cls: int,
    *,
    count: bool,
    stats: dict | None = None,
) -> torch.Tensor:
    """Launch K3. ``count=False`` (packed branch only, a diagnostic) replaces
    the histogram adds with a register sum: the output is then not the counts
    and the launch does not count as one of K3's."""
    n, k = indices.shape
    n_cols = src_cols.shape[1]
    _cuda.require(indices, "indices", torch.int32)
    _cuda.require(mask, "mask", torch.bool, (n, k))
    if src_cols.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"label columns must be uint8 or int32, found {src_cols.dtype}.")
    _cuda.require(src_cols, "src_cols", src_cols.dtype, (n, n_cols))
    _cuda.require(table_cols, "table_cols", src_cols.dtype)
    if table_cols.shape[1] != n_cols:
        raise ValueError(f"`table_cols` must have {n_cols} columns, found {table_cols.shape[1]}.")
    if n >= 2**31 or n * k >= 2**31:
        raise ValueError("pair counts take fewer than 2^31 rows and edges.")
    if n * k:
        lo, hi = torch.stack(torch.aminmax(indices)).tolist()  # one reduction, one wait
        if lo < 0 or hi >= table_cols.shape[0]:
            raise ValueError("neighbour indices must lie in [0, rows of `table_cols`).")
    sms = torch.cuda.get_device_properties(indices.device).multi_processor_count
    layout = _k3_layout(n, n_cols, n_cls, k, sms)
    if not count and layout.branch != "packed":
        raise ValueError(f"the register-sum diagnostic runs on the packed branch only, not `{layout.branch}`.")
    if stats is not None:
        stats.update(layout._asdict())
    out = torch.zeros((n_cols, n_cls, n_cls), dtype=torch.int32, device=indices.device)
    code = _cuda.library().sqt_pair_counts(
        src_cols.data_ptr(), table_cols.data_ptr(), src_cols.element_size(), indices.data_ptr(), mask.data_ptr(),
        n, k, n_cols, n_cls, _K3_BRANCHES[layout.branch], layout.cols_per_block, layout.row_blocks,
        layout.rows_per_block, int(count), out.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "pair_counts")
    if count:
        _cuda.launches["pair_counts"] += 1
    return out


def k3_packed_resident(label_dtype: torch.dtype = torch.uint8) -> int:
    """Packed-branch K3 blocks one SM of the current card keeps resident (the
    layout assumes ``_K3_PACKED_RESIDENT``)."""
    per_sm = ctypes.c_int(0)
    _cuda.check(_cuda.library().sqt_pair_counts_resident(1 if label_dtype == torch.uint8 else 4,
                                                         ctypes.byref(per_sm)), "pair_counts")
    return per_sm.value


def cluster_pair_counts(
    indices: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor, n_cls: int, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Directed cluster-pair edge counts ``(C, C)``: ``counts[a, b]`` = stored
    edges ``i -> j`` with ``labels[i] = a`` and ``labels[j] = b``, exact
    int32 through K3; or, given the ELL ``weights``, their total weight in
    float64 (plain torch: one ``index_add_``, float64 atomics on the card,
    so the order of the sum varies from run to run)."""
    if weights is None:
        col = labels.to(torch.int32).reshape(-1, 1).contiguous()
        return pair_counts_cols(indices, mask, col, col, n_cls)[0]
    lab = labels.to(torch.int64)
    src = lab[:, None].expand(indices.shape)
    nbr = lab[indices.to(torch.int64)]
    ok = mask & (src >= 0) & (src < n_cls) & (nbr >= 0) & (nbr < n_cls)
    out = torch.zeros(n_cls * n_cls, dtype=torch.float64, device=indices.device)
    out.index_add_(0, (src * n_cls + nbr)[ok], weights.to(torch.float64)[ok])
    return out.view(n_cls, n_cls)


def permuted_pair_counts_cols(
    indices: torch.Tensor, mask: torch.Tensor, shuffled_cols: torch.Tensor, n_cls: int
) -> torch.Tensor:
    """``(n_perms, C, C)`` int32 counts over ``(n, n_perms)`` shuffled label
    columns: each column is both the source labels and the neighbour table."""
    return pair_counts_cols(indices, mask, shuffled_cols, shuffled_cols, n_cls)


def analytic_pair_count_moments(adj: object, cluster_sizes: object) -> tuple[np.ndarray, np.ndarray]:
    """Exact permutation-null mean and variance ``(C, C)`` of cluster-pair edge
    counts (host numpy, copied from the JAX package).

    ``adj`` is a scipy sparse adjacency whose stored entries are the directed
    edges counted (self loops ignored); ``cluster_sizes`` the per-category
    node counts.
    """
    A = sp.csr_matrix(adj, copy=True)
    A.setdiag(0)
    A.eliminate_zeros()
    A.data[:] = 1.0
    n = A.shape[0]
    nc = np.asarray(cluster_sizes, dtype=np.float64)

    m = float(A.nnz)
    d_out = np.asarray(A.sum(axis=1)).ravel()
    d_in = np.asarray(A.sum(axis=0)).ravel()
    s_out = float(np.sum(d_out * (d_out - 1)))  # ordered pairs sharing a source
    s_in = float(np.sum(d_in * (d_in - 1)))  # ordered pairs sharing a target
    p_ht = float(np.sum(d_in * d_out))  # head-tail incidences (incl. reciprocal)
    r = float(A.multiply(A.T).sum())  # edges whose reverse is stored
    c_chain = 2.0 * (p_ht - r)  # i->j->l chains, both orders
    d_disj = m * (m - 1.0) - s_out - s_in - r - c_chain

    def ff(x: np.ndarray | float, k: int) -> np.ndarray | float:
        out = np.ones_like(np.asarray(x, dtype=np.float64))
        for t in range(k):
            out = out * (x - t)
        return out

    na = nc[:, None]
    nb = nc[None, :]
    # off-diagonal (a != b) joint probabilities by bucket
    p2 = na * nb / ff(n, 2)
    qso = na * ff(nb, 2) / ff(n, 3) if n >= 3 else np.zeros_like(p2)
    qsi = ff(na, 2) * nb / ff(n, 3) if n >= 3 else np.zeros_like(p2)
    qd = ff(na, 2) * ff(nb, 2) / ff(n, 4) if n >= 4 else np.zeros_like(p2)
    qr = np.zeros_like(p2)
    qc = np.zeros_like(p2)
    # diagonal (a == b)
    diag = np.eye(len(nc), dtype=bool)
    p2_d = ff(nc, 2) / ff(n, 2)
    q3_d = ff(nc, 3) / ff(n, 3) if n >= 3 else np.zeros_like(nc)
    q4_d = ff(nc, 4) / ff(n, 4) if n >= 4 else np.zeros_like(nc)
    p2 = np.where(diag, p2_d[None, :], p2)
    qso = np.where(diag, q3_d[None, :], qso)
    qsi = np.where(diag, q3_d[None, :], qsi)
    qc = np.where(diag, q3_d[None, :], qc)
    qr = np.where(diag, p2_d[None, :], qr)
    qd = np.where(diag, q4_d[None, :], qd)

    mean = m * p2
    second = m * p2 + s_out * qso + s_in * qsi + r * qr + c_chain * qc + d_disj * qd
    var = np.maximum(second - mean * mean, 0.0)
    return mean, var
