"""Dense all-pairs co-occurrence counts (counterpart of ``squidpy_tpu/ops/pallas_pairs.py``).

``co_occurrence(use_pallas=True)`` counts, for every squared threshold, the
ordered pairs ``i != j`` per class pair with ``d2 <= thr``, where d2 is the
expanded form ``(|p_i|^2 + |p_j|^2) - 2 <p_i, p_j>`` that the JAX package's
Pallas kernel computes. On a CUDA tensor the count runs as kernel K2
(``csrc/dense_pairs.cu``); on the CPU it runs the plain torch version below,
which rounds every product and sum on its own, in the kernel's order, so the
two agree bitwise. Counts are int64: the TPU kernel's float32 slabs are exact
only below 2^24 per (class pair, threshold), these at any size.
"""

from __future__ import annotations

import numpy as np
import torch

from squidpy_torch import _cuda
from squidpy_torch._device import get_device, to_host

__all__ = ["MAX_CLASSES", "dense_pair_counts", "dense_pairs"]

# the JAX kernel pads the one-hot labels to 128 lanes
MAX_CLASSES = 128

# shared-memory budget of one K2 block: staged tiles plus, when it fits, the
# (L, C, C) int32 histogram
_K2_SMEM_BYTES = 200 * 1024


def _k2_layout(dim: int, n_thr: int, n_cls: int) -> tuple[int, bool]:
    """(tile, whether the (L, C, C) histogram sits in shared memory)."""
    tile = 256 if dim <= 16 else 64
    base = (2 * tile * dim + 2 * tile + n_thr) * 4 + 2 * tile * 4
    if base > _K2_SMEM_BYTES:
        raise ValueError(f"{dim}-dimensional points do not fit the dense pair kernel's shared memory.")
    return tile, base + n_thr * n_cls * n_cls * 4 <= _K2_SMEM_BYTES


def _expanded_d2(pi: torch.Tensor, pj: torch.Tensor, ni: torch.Tensor, nj: torch.Tensor) -> torch.Tensor:
    dot = pi[:, None, 0] * pj[None, :, 0]
    for k in range(1, pi.shape[1]):
        dot = dot + pi[:, None, k] * pj[None, :, k]
    return (ni[:, None] + nj[None, :]) - 2.0 * dot


def _sq_norms(pts: torch.Tensor) -> torch.Tensor:
    norm = pts[:, 0] * pts[:, 0]
    for k in range(1, pts.shape[1]):
        norm = norm + pts[:, k] * pts[:, k]
    return norm


def _dense_plain(pts: torch.Tensor, labels: torch.Tensor, thr: torch.Tensor, n_cls: int) -> torch.Tensor:
    """Plain torch version of K2 for ascending ``thr``: each pair i < j's first
    threshold index (one ``searchsorted``) is histogrammed, then the ordered
    cumulative counts are ``cumsum(h + h^T)`` over thresholds."""
    n = pts.shape[0]
    n_thr = thr.shape[0]
    cc = n_cls * n_cls
    hist = torch.zeros((n_thr + 1) * cc, dtype=torch.int64, device=pts.device)
    norms = _sq_norms(pts)
    lab = labels.to(torch.int64)
    ok_lab = (lab >= 0) & (lab < n_cls)
    step = max(1, (1 << 24) // max(n, 1))
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        d2 = _expanded_d2(pts[i0:i1], pts[i0:], norms[i0:i1], norms[i0:])
        gi = torch.arange(i0, i1, device=pts.device)
        gj = torch.arange(i0, n, device=pts.device)
        ok = (gi[:, None] < gj[None, :]) & ok_lab[i0:i1, None] & ok_lab[None, i0:]
        r = torch.searchsorted(thr, d2)  # first threshold with d2 <= thr; NaN sorts past the end
        use = ok & (r < n_thr)
        e = r * cc + lab[i0:i1, None] * n_cls + lab[None, i0:]
        hist += torch.bincount(e[use], minlength=hist.numel())
    h = hist.view(n_thr + 1, n_cls, n_cls)[:n_thr]
    return (h + h.transpose(1, 2)).cumsum(0)


def dense_pairs(pts: torch.Tensor, labels: torch.Tensor, thr: torch.Tensor, n_cls: int) -> torch.Tensor:
    """Kernel K2: ``(L, C, C)`` int64 cumulative ordered pair counts.

    ``pts`` (n, d) float32, ``labels`` (n,) int32 (labels outside ``[0, C)``
    are not counted), ``thr`` (L,) float32 squared thresholds sorted
    ascending. A CPU tensor runs the plain torch version; a CUDA tensor
    launches the kernel.
    """
    if not 1 <= n_cls <= MAX_CLASSES:
        raise ValueError(f"the dense pair kernel takes 1 to {MAX_CLASSES} classes, found {n_cls}.")
    if pts.device.type == "cpu":
        return _dense_plain(pts, labels, thr, n_cls)
    n, dim = pts.shape
    n_thr = thr.shape[0]
    _cuda.require(pts, "pts", torch.float32)
    _cuda.require(labels, "labels", torch.int32, (n,))
    _cuda.require(thr, "thr", torch.float32, (n_thr,))
    if not 0 < dim <= 128:
        raise ValueError(f"the dense pair kernel takes 1 to 128 dimensions, found {dim}.")
    if n >= 2**31 or -(-n // 64) > 65535:
        raise ValueError(f"too many points for the dense pair kernel: {n}.")
    out = torch.zeros((n_thr, n_cls, n_cls), dtype=torch.int64, device=pts.device)
    if n < 2 or n_thr == 0:
        return out
    if bool((thr[1:] < thr[:-1]).any()):
        raise ValueError("thresholds must be sorted ascending.")
    tile, shared = _k2_layout(dim, n_thr, n_cls)
    hist = torch.zeros_like(out)
    code = _cuda.library().sqt_dense_pairs(
        pts.data_ptr(), labels.data_ptr(), n, dim, thr.data_ptr(), n_thr, n_cls, tile, int(shared),
        hist.data_ptr(), out.data_ptr(), _cuda.stream_ptr(),
    )
    _cuda.check(code, "dense_pairs")
    _cuda.launches["dense_pairs"] += 1
    return out


def dense_pair_counts(coords: np.ndarray, labels: np.ndarray, thresholds: np.ndarray, n_cls: int) -> np.ndarray:
    """Cumulative ordered pair counts ``(C, C, L)`` float64 with ``d2 <= thresholds[l]``,
    self-pairs excluded, the thresholds in the caller's order."""
    dev = get_device()
    thr = np.asarray(thresholds, dtype=np.float32).ravel()
    order = np.argsort(thr, kind="stable")
    counts = dense_pairs(
        torch.from_numpy(np.ascontiguousarray(coords, dtype=np.float32)).to(dev),
        torch.from_numpy(np.asarray(labels, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(thr[order])).to(dev),
        n_cls,
    )
    out = np.empty((len(thr), n_cls, n_cls), dtype=np.float64)
    out[order] = to_host(counts, np.float64)
    return np.transpose(out, (1, 2, 0))
