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
``sepal_resident``). K12 (``feature_knn``) counts its filter's call and
the exact route's call on the rows the filter listed (one call on the
exact route alone above 64 features). K13 (``hops``) counts each call into its C
interface: a hop's warp route, its block route over the rows past a
warp's capacity (launched every hop, on the device's count), the copy into
the bucketed ELLs, and the block route over the late rows when there are
any. K14 (``ivf_kmeans``) counts each call into its nearest entry (the
assignment, the probes, the spill ranking; the filter route's call starts
two CUDA kernels: the centroids' terms and the sweep) and into its update
entry (two: the runs and the tree); K15 (``ivf_search``) counts each call
(the filter route's starts two CUDA kernels: the members' terms and the
sweep); K16 (``ivf_refine``) counts each launch. K8's wrapper bins its points and
queries by K6's bounds, bin and scatter, and those calls count as K6's.
K17 (``cooccur_pairs``) counts each call into either route: the class route's
class order and tiles, sweep and cumulative sum, or the index route's sweep
and sum. K18 (``glcm``), K19 (``crop_summary``) and K20
(``crop_histogram``) count each call into their C interface, one a call of
their wrappers, which takes every crop and channel of the call (and with K18
every offset): K18's shared route starts two CUDA kernels (the counts, then
the props), its global route one to three an offset and group of items;
K19's split route one a digit; K20 one or, its uint8 entry over a crop
split between blocks, two (the counts, then the fold).

``build_seconds`` gives, after a build in this process, each source's
seconds from the start of all compiles to the end of its own, and the link's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "build_log", "build_seconds", "check", "device_info", "launches", "library", "require", "reset_launches",
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
    "feature_knn": ("squidpy_torch/csrc/feature_knn.cu", "squidpy_tpu/ops/knn.py:259"),
    "hops": ("squidpy_torch/csrc/hops.cu", "squidpy_tpu/ops/hops.py:145"),
    "ivf_kmeans": ("squidpy_torch/csrc/ivf_kmeans.cu", "squidpy_tpu/ops/ivf_knn.py:57"),
    "ivf_search": ("squidpy_torch/csrc/ivf_search.cu", "squidpy_tpu/ops/ivf_knn.py:251"),
    "ivf_refine": ("squidpy_torch/csrc/ivf_refine.cu", "squidpy_tpu/ops/ivf_knn.py:312"),
    "cooccur_pairs": ("squidpy_torch/csrc/cooccur_pairs.cu", "squidpy_tpu/ops/cooccur.py:133"),
    "glcm": ("squidpy_torch/csrc/glcm.cu", "squidpy_tpu/ops/features.py:218"),
    "crop_summary": ("squidpy_torch/csrc/crop_summary.cu", "squidpy_tpu/ops/features.py:149"),
    "crop_histogram": ("squidpy_torch/csrc/crop_histogram.cu", "squidpy_tpu/ops/features.py:182"),
}

launches: dict[str, int] = dict.fromkeys(KERNELS, 0)

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_log = ""
build_seconds: dict[str, float] = {}

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
    "sqt_feature_knn": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "sqt_feature_knn_filter": [_P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P, _P, _P],
    "sqt_hops_warp": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P],
    "sqt_hops_block": [_I, _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _L, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _I, _I, _P, _P, _P, _P],
    "sqt_hops_place": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "sqt_ivf_nearest": [_P, _I, _I, _P, _I, _I, _P, _P, _P],
    "sqt_ivf_update": [_P, _I, _I, _P, _P, _P, _I, _L, _P, _P, _P, _P],
    "sqt_ivf_nearest_filter": [_P, _I, _I, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P],
    "sqt_ivf_search": [_P, _I, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P, _P],
    "sqt_ivf_search_filter": [_P, _I, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P],
    "sqt_ivf_refine": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P],
    "sqt_cooccur_pairs": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _F, _I, _I, _I, _I, _P, _L, _P, _P],
    "sqt_cooccur_pairs_index": [_P, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "sqt_glcm": [_P, _I, _I, _I, _P, _I, _I, _L, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                 _P],
    "sqt_crop_summary": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                         _P],
    "sqt_crop_histogram": [_P, _I, _L, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P],
    "sqt_crop_histogram_u8": [_P, _I, _L, _I, _I, _I, _P, _P, _I, _I, _L, _I, _P, _P, _P],
    "sqt_crop_histogram_fold": [_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P],
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
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for src in sources]
    logs, done = {}, {}

    def wait(src: Path, proc: subprocess.Popen) -> None:
        logs[src] = proc.communicate()[1]
        done[src.name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=pair) for pair in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for src, proc in procs:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} with exit code {proc.returncode}:\n{logs[src]}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(objs / f"{src.stem}.o") for src in sources)],
                          capture_output=True, text=True, check=False)
    done["link"] = time.perf_counter() - t0
    shutil.rmtree(objs, ignore_errors=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link with exit code {link.returncode}:\n{link.stderr}")
    build_seconds.clear()
    build_seconds.update(done)
    os.replace(tmp, so)
    return "".join(logs[src] for src, _ in procs)


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
