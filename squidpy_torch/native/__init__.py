"""Host C++ for the niche clustering (Leiden, Louvain, the kNN symmetrisation)
and the image segmentation (the watershed and the tiles' label merge)
(counterpart of ``squidpy_tpu/native/__init__.py``).

``louvain.cpp``, ``knngraph.cpp`` and ``watershed.cpp`` are copies of the JAX package's sources,
built here with the same ``g++`` flags (``-O3 -march=native -shared -fPIC
-std=c++17``) at first use, into ``squidpy_torch/_build/`` under a name keyed
by a hash of the sources and flags, and loaded with ``ctypes``. In ISO C++
mode g++ contracts no multiply-add into an FMA, so one CSR gives the same
labels, and one elevation map the same watershed, as the JAX package's
library. The wrappers take the JAX package's signatures; ``felzenszwalb``
comes with the ``experimental`` slice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Any

import numpy as np
from scipy import sparse as sp

__all__ = ["ensure_built", "leiden_csr", "louvain_csr", "relabel_merge", "symmetrize_knn", "watershed"]

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
_SRCS = (_HERE / "louvain.cpp", _HERE / "knngraph.cpp", _HERE / "watershed.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LIB: ctypes.CDLL | None = None
_lock = threading.Lock()


def ensure_built() -> Path:
    """Compile the library if no build of these sources and flags exists;
    returns its path. The link goes to a temporary file that replaces the
    target whole, so a process never loads a half-written library."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _SRCS:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = _BUILD_DIR / f"libsquidpy_torch_native_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, *map(str, _SRCS), "-o", str(tmp)], capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native library with exit code {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(ensure_built()))
            p = ctypes.POINTER
            csr = [p(ctypes.c_int64), p(ctypes.c_int32), p(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
                   ctypes.c_uint64, ctypes.c_int32]
            lib.louvain_csr.argtypes = [*csr, p(ctypes.c_int32)]
            lib.louvain_csr.restype = ctypes.c_int64
            lib.leiden_csr.argtypes = [*csr, ctypes.c_int32, p(ctypes.c_int32)]
            lib.leiden_csr.restype = ctypes.c_int64
            lib.symmetrize_knn.argtypes = [p(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64, p(ctypes.c_int64),
                                           p(ctypes.c_int32)]
            lib.symmetrize_knn.restype = ctypes.c_int64
            lib.watershed.argtypes = [p(ctypes.c_float), p(ctypes.c_int32), p(ctypes.c_uint8), ctypes.c_int64,
                                      ctypes.c_int64, p(ctypes.c_int32)]
            lib.watershed.restype = None
            lib.relabel_merge.argtypes = [p(ctypes.c_int64), ctypes.c_int64, p(ctypes.c_int64), ctypes.c_int64]
            lib.relabel_merge.restype = ctypes.c_int64
            _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype: Any) -> Any:
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _csr_args(adj: Any) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    adj = sp.csr_matrix(adj)
    return (adj.shape[0], np.ascontiguousarray(adj.indptr, dtype=np.int64),
            np.ascontiguousarray(adj.indices, dtype=np.int32), np.ascontiguousarray(adj.data, dtype=np.float64))


def louvain_csr(adj: Any, *, resolution: float = 1.0, seed: int = 0, max_levels: int = 32) -> tuple[np.ndarray, int]:
    """Louvain community labels over a symmetric CSR adjacency; deterministic
    per seed. Returns ``(labels, n_communities)`` with unordered compact ids."""
    n, indptr, indices, weights = _csr_args(adj)
    labels = np.zeros(n, dtype=np.int32)
    n_comm = _lib().louvain_csr(_ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
                                _ptr(weights, ctypes.c_double), n, float(resolution),
                                int(seed) & 0xFFFFFFFFFFFFFFFF, int(max_levels), _ptr(labels, ctypes.c_int32))
    return labels, int(n_comm)


def leiden_csr(adj: Any, *, resolution: float = 1.0, seed: int = 0, max_levels: int = 32,
               n_iterations: int = 2) -> tuple[np.ndarray, int]:
    """Leiden community labels over a symmetric CSR adjacency: local moves,
    the refinement phase and aggregation on the refined partition, every
    community connected; ``n_iterations`` rounds (<= 0: to convergence).
    Deterministic per seed. Returns ``(labels, n_communities)`` with
    unordered compact ids."""
    n, indptr, indices, weights = _csr_args(adj)
    labels = np.zeros(n, dtype=np.int32)
    n_comm = _lib().leiden_csr(_ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
                               _ptr(weights, ctypes.c_double), n, float(resolution),
                               int(seed) & 0xFFFFFFFFFFFFFFFF, int(max_levels), int(n_iterations),
                               _ptr(labels, ctypes.c_int32))
    return labels, int(n_comm)


def symmetrize_knn(idx: np.ndarray, n: int | None = None) -> sp.csr_matrix:
    """Symmetric binary CSR ``max(A_knn, A_knn^T)`` from an ``(n, k)``
    neighbour table, each row sorted and deduplicated; entries outside
    ``[0, n)`` and self entries are ignored."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    if idx.ndim != 2:
        raise ValueError(f"Expected a 2D neighbor table, found shape `{idx.shape}`.")
    rows, k = idx.shape
    if n is None:
        n = rows
    if rows != n:
        raise ValueError(f"Neighbor table has {rows} rows for {n} nodes.")
    indptr = np.zeros(n + 1, dtype=np.int64)
    indices = np.empty(2 * rows * k, dtype=np.int32)
    nnz = _lib().symmetrize_knn(_ptr(idx, ctypes.c_int32), n, k, _ptr(indptr, ctypes.c_int64),
                                _ptr(indices, ctypes.c_int32))
    if nnz < 0:
        raise ValueError("symmetrize_knn: bad arguments")
    return sp.csr_matrix((np.ones(nnz, dtype=np.float64), indices[:nnz], indptr), shape=(n, n))


def watershed(image: np.ndarray, markers: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """Priority-flood watershed (4-connectivity, FIFO tie-break).

    ``image`` is the elevation map (flooding ascends), ``markers`` the int
    seed labels, ``mask`` an optional boolean region restriction.
    """
    image = np.ascontiguousarray(image, dtype=np.float32)
    markers = np.ascontiguousarray(markers, dtype=np.int32)
    if image.shape != markers.shape or image.ndim != 2:
        raise ValueError(f"Expected matching 2D image/markers, found `{image.shape}`, `{markers.shape}`.")
    h, w = image.shape
    out = np.zeros((h, w), dtype=np.int32)
    mask_ptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
        if mask.shape != image.shape:
            raise ValueError("Mask shape must match image shape.")
        mask_ptr = _ptr(mask, ctypes.c_uint8)
    _lib().watershed(_ptr(image, ctypes.c_float), _ptr(markers, ctypes.c_int32), mask_ptr, h, w,
                     _ptr(out, ctypes.c_int32))
    return out


def relabel_merge(labels: np.ndarray, pairs: np.ndarray) -> tuple[np.ndarray, int]:
    """Merge equivalent labels (union-find) and relabel to consecutive ids:
    the tiles' labels of a tiled segmentation reconciled across their halos."""
    labels = np.ascontiguousarray(labels, dtype=np.int64).copy()
    pairs = np.ascontiguousarray(np.asarray(pairs, dtype=np.int64).reshape(-1, 2))
    n_out = _lib().relabel_merge(_ptr(labels, ctypes.c_int64), labels.size, _ptr(pairs, ctypes.c_int64), len(pairs))
    return labels, int(n_out)
