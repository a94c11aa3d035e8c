"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

All kernels compile with ``nvcc`` for ``sm_90a``, one process per source,
all started together, and link into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, into
``squidpy_torch/_build/``, keyed by a hash of the sources and flags, so a
fresh checkout builds everything on its first kernel call. Nothing here is
imported or compiled on a machine without a card: the wrappers in the ops
modules reach :func:`library` only for CUDA tensors.

``launches`` counts, per kernel, the launches its wrapper made; a run resets
it with :func:`reset_launches` and reads it afterwards to show which kernels
the path went through. A kernel whose C interface has several entry points
(``radius_pairs``: bounds, bin, scatter, the two passes, the order;
``threefry_shuffle``: the words, and a round's histogram, scan, scatter and
sort; ``threefry_grouped``: the scatter and the sort of its grouped entry
(K10g), and its overflow sort where a bucket needs it;
``ligrec_perms``: its float and integral routes; ``sepal_diffusion``: a call
of up to 64 streaming passes, one kernel each) counts each call into that
interface, which may start more than one CUDA kernel. K11's two routes
count under their own names (``sepal_diffusion``, the streaming route, and
``sepal_resident``). K8's wrapper bins its points and queries by K6's bounds, bin and scatter,
and those calls count as K6's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["KERNELS", "build_log", "check", "device_info", "launches", "library", "require", "reset_launches",
           "stream_ptr"]

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source in the repo, TPU/XLA code it replaces)
KERNELS = {
    "binned_pairs": ("squidpy_torch/csrc/binned_pairs.cu", "squidpy_tpu/ops/pallas_binned.py:196"),
    "pair_counts": ("squidpy_torch/csrc/pair_counts.cu", "squidpy_tpu/ops/nhood.py:123"),
    "index_cipher": ("squidpy_torch/csrc/index_cipher.cu", "squidpy_tpu/_core/index_cipher.py:75"),
    "dense_pairs": ("squidpy_torch/csrc/dense_pairs.cu", "squidpy_tpu/ops/pallas_pairs.py:75"),
    "ell_autocorr": ("squidpy_torch/csrc/ell_autocorr.cu", "squidpy_tpu/ops/autocorr.py:59"),
    "perm_autocorr": ("squidpy_torch/csrc/perm_autocorr.cu", "squidpy_tpu/ops/autocorr.py:272"),
    "radius_pairs": ("squidpy_torch/csrc/radius_pairs.cu", "squidpy_tpu/ops/knn.py:408"),
    "ripley_pairs": ("squidpy_torch/csrc/ripley_pairs.cu", "squidpy_tpu/ops/ripley.py:30"),
    "cross_knn": ("squidpy_torch/csrc/cross_knn.cu", "squidpy_tpu/ops/knn.py:364"),
    "ligrec_perms": ("squidpy_torch/csrc/ligrec_perms.cu", "squidpy_tpu/ops/ligrec.py:50"),
    "threefry_shuffle": ("squidpy_torch/csrc/threefry.cu", "squidpy_tpu/_core/rng.py:38"),
    "threefry_grouped": ("squidpy_torch/csrc/threefry.cu", "squidpy_tpu/_core/rng.py:98"),
    "sepal_diffusion": ("squidpy_torch/csrc/sepal.cu", "squidpy_tpu/ops/sepal.py:35"),
    "sepal_resident": ("squidpy_torch/csrc/sepal.cu", "squidpy_tpu/ops/sepal.py:35"),
}

launches: dict[str, int] = dict.fromkeys(KERNELS, 0)

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_int64
_U = ctypes.c_uint32
_F = ctypes.c_float
_SIGNATURES = {
    "sqt_index_cipher": [_P, _I, _I, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
                         ctypes.c_uint64, _I, _P, _I, _P, _I, _P],
    "sqt_pair_counts": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "sqt_pair_counts_resident": [_I, _P],
    "sqt_binned_pairs": [_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "sqt_dense_pairs": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "sqt_ell_autocorr": [_I, _I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, ctypes.c_int64, _I, _P, _P, _P, _P],
    "sqt_ell_autocorr_layout": [_I, _I, _P],
    "sqt_radius_bounds": [_P, ctypes.c_int64, _I, _I, _P, _P],
    "sqt_radius_bin": [_P, ctypes.c_int64, _I, _I, _D, _D, _D, _D, _I, _I, _I, _I, _P, _P, _P],
    "sqt_radius_scatter": [_P, ctypes.c_int64, _I, _P, _P, _P, _P, _P, _P],
    "sqt_radius_pairs": [_P, _I, _P, _P, _P, ctypes.c_int64, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P, _I, _P, _P,
                         _P, _I, _P],
    "sqt_radius_order": [_P, ctypes.c_int64, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, _I, _I, _P],
    "sqt_ripley_pairs": [_P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "sqt_cross_knn": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _D, _I, _I, _I, _D, _P, _P, _P, _P,
                      _P],
    "sqt_cross_knn_brute": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "sqt_ligrec_perms": [_P, _L, _I, _P, _I, _L, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _I,
                         _P],
    "sqt_ligrec_perms_int": [_P, _L, _L, _I, _P, _L, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P,
                             _I, _P],
    "sqt_threefry_bits": [_P, _L, _L, _I, _P, _P],
    "sqt_shuffle_hist": [_P, _L, _L, _U, _I, _P, _P, _P],
    "sqt_shuffle_scan": [_L, _L, _I, _I, _P, _P, _P, _P, _P],
    "sqt_shuffle_scatter": [_P, _L, _L, _U, _I, _P, _L, _P, _P, _P],
    "sqt_shuffle_sort": [_P, _P, _P, _P, _L, _L, _I, _I, _P, _L, _P, _I, _I, _P, _L, _P],
    "sqt_shuffle_gscatter": [_P, _L, _L, _U, _P, _L, _P, _P, _L, _L, _I, _P, _P, _P, _P],
    "sqt_shuffle_gsort": [_P, _P, _P, _L, _P, _P, _L, _L, _I, _L, _L, _I, _P, _P, _I, _I, _P, _L, _P, _P, _P],
    "sqt_shuffle_goverflow": [_P, _P, _P, _L, _P, _P, _L, _L, _I, _L, _L, _P, _L, _P, _P, _P, _I, _I, _P, _L, _P],
    "sqt_sepal_passes": [_P, _P, _L, _I, _P, _P, _I, _I, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P, _P,
                         _P, _P, _P, _P, _P],
    "sqt_sepal_resident": [_P, _L, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P],
    "sqt_device_info": [_P],
    "sqt_perm_autocorr": [_I, _I, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, _I, _I, _P, _I, ctypes.c_int64,
                          ctypes.c_int64, _I, _P, _P, _P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("`nvcc` was not found on PATH or under $CUDA_HOME/bin; cannot build the CUDA kernels.")


def _compile(sources: list[Path], so: Path) -> str:
    """Build ``so`` from ``sources``: one nvcc per source, all at once, then
    one link into a temporary file that replaces ``so`` whole. Returns the
    compilers' log."""
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = _BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
    objs.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = [(src, subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for src in sources]
    logs = []
    for src, proc in procs:
        err = proc.communicate()[1]
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed on {src.name} with exit code {proc.returncode}:\n{err}")
        logs.append(err)
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(objs / f"{src.stem}.o") for src in sources)],
                          capture_output=True, text=True, check=False)
    shutil.rmtree(objs, ignore_errors=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link with exit code {link.returncode}:\n{link.stderr}")
    os.replace(tmp, so)
    return "".join(logs)


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sqt_error_string.argtypes = [ctypes.c_int]
    lib.sqt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if the sources changed.

    Threads may call this at once (``spatial_neighbors_radius`` builds each
    library's graph in a thread pool): one builds and loads under a lock,
    the others wait for it and share the result."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            sources = sorted(_SRC_DIR.glob("*.cu"))
            digest = hashlib.sha256(" ".join(FLAGS).encode())
            for f in sorted(_SRC_DIR.glob("*.cu*")):
                digest.update(f.name.encode())
                digest.update(f.read_bytes())
            so = _BUILD_DIR / f"libsquidpy_torch_{digest.hexdigest()[:16]}.so"
            if not so.exists():
                build_log = _compile(sources, so)
            _lib = _load(so)
    return _lib


def device_info() -> tuple[int, int]:
    """The current card's opt-in shared memory a block, in bytes, and its
    SMs: what the routes chosen by shape weigh a launch against."""
    out = (ctypes.c_int * 2)()
    check(library().sqt_device_info(ctypes.addressof(out)), "device_info")
    return int(out[0]), int(out[1])


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().sqt_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel `{kernel}` failed to launch: error {code} ({msg}).")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple[int, ...] | None = None) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"`{name}` must be a CUDA tensor, found device `{t.device}`.")
    if t.dtype != dtype:
        raise TypeError(f"`{name}` must have dtype {dtype}, found {t.dtype}.")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"`{name}` must have shape {tuple(shape)}, found {tuple(t.shape)}.")
    if not t.is_contiguous():
        raise ValueError(f"`{name}` must be contiguous.")
