"""Optional on-disk memoization of permutation batches (counterpart of
``squidpy_tpu/utils/_memoize.py``).

``nhood_enrichment`` and ``spatial_autocorr`` can keep their raw permutation
statistics on disk, keyed by a digest of every input that decides them
(graph, labels or expression, seed, permutation count, parameters). The
keyed shuffles make a cached batch exactly a fresh run's, so an identical
seeded call reads it back instead of running the permutations.

``cache=True`` uses ``$SQUIDPY_TORCH_CACHE`` or
``~/.cache/squidpy_torch/memo``; ``cache="/some/dir"`` names the directory.
The digest is the JAX package's for the same arrays and parameters.
"""

from __future__ import annotations

import hashlib
import os
from collections.abc import Callable, Mapping
from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["cache_key", "memoize_arrays", "resolve_cache_dir"]


def resolve_cache_dir(cache: bool | str | os.PathLike) -> Path | None:
    """The directory of the user-facing ``cache`` argument (None: off)."""
    if cache is False or cache is None:
        return None
    if cache is True:
        return Path(os.environ.get("SQUIDPY_TORCH_CACHE", Path.home() / ".cache" / "squidpy_torch" / "memo"))
    return Path(cache)


def cache_key(op: str, arrays: Mapping[str, Any], params: Mapping[str, Any]) -> str:
    """SHA-256 digest of ``op``, each array by name (shape, dtype and raw
    bytes, in sorted name order) and the repr of the sorted parameters."""
    h = hashlib.sha256(op.encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(repr(sorted(params.items())).encode())
    return h.hexdigest()


def memoize_arrays(
    cache: bool | str | os.PathLike,
    op: str,
    arrays: Mapping[str, Any],
    params: Mapping[str, Any],
    compute: Callable[[], dict[str, np.ndarray]],
) -> dict[str, np.ndarray]:
    """``compute()``, kept under ``<cache dir>/<op>/<digest>.npz``.

    With ``cache`` off it just computes. An entry that cannot be read is
    deleted, computed again and rewritten; a write goes to a temporary file
    that replaces the entry whole, so a crash never leaves half an entry.
    """
    cache_dir = resolve_cache_dir(cache)
    if cache_dir is None:
        return compute()

    path = cache_dir / op / f"{cache_key(op, arrays, params)}.npz"
    if path.exists():
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception:  # noqa: BLE001 - a corrupt entry is computed again below
            path.unlink(missing_ok=True)

    result = {k: np.asarray(v) for k, v in compute().items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")  # np.savez keeps a name ending in .npz
    np.savez(tmp, **result)
    os.replace(tmp, path)
    return result
