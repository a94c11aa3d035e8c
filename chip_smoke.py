#!/usr/bin/env python3
"""Run the squidpy_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no error is caught and passed over):

1. device: require a CUDA card, print its name and power limit, TF32 off;
2. build: compile the CUDA kernels from ``squidpy_torch/csrc`` (timed);
3. the main path through the public API at Xenium scale (1M cells, k=6,
   16 clusters): ``spatial_neighbors_knn`` -> ``nhood_enrichment`` (1000
   permutations, a warm-up seed then a timed one) -> ``co_occurrence`` over a
   short-range interval; launch counters reset before and read after, and
   every kernel must have run;
4. each kernel against its plain torch version on the card, bitwise, with
   both times: first on the main path's own inputs (K4 on the first
   500-permutation chunk's keys, K3 on those columns and on the observed
   labels over the kNN graph, K1 on the short-range plan), then at fixed
   shapes and in the branches the main path does not take (K3 and K1 with
   global atomics, K1 in 3D);
5. the same public calls on the card and on the CPU (plain torch) must
   agree bitwise, at 3000 cells (brute-force kNN, sort shuffles, dense
   sweep) and at 100k cells (cipher shuffles, binned sweep: K4, K3, K1).

Prints one JSON line of kernels, the ``nvidia-smi`` name/power line, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

N_CELLS = 1_000_000
N_NEIGHS = 6
N_CLS = 16
N_PERMS = 1000


class _Categorical:
    """Numpy stand-in for a categorical obs column (``.cat.codes``/``.cat.categories``)."""

    def __init__(self, codes: np.ndarray, n_cls: int) -> None:
        self.cat = SimpleNamespace(codes=codes.astype(np.int32), categories=[str(c) for c in range(n_cls)])
        self.dtype = "category"


class StandIn:
    """Numpy-only stand-in for an AnnData container: obs/obsm/obsp/uns mappings."""

    def __init__(self, coords: np.ndarray, codes: np.ndarray, n_cls: int) -> None:
        self.obs = {"cluster": _Categorical(codes, n_cls)}
        self.obsm = {"spatial": coords}
        self.obsp: dict = {}
        self.uns: dict = {}


def _dataset(n: int, seed: int) -> StandIn:
    rng = np.random.default_rng(seed)
    side = 10.0 * np.sqrt(n)  # ~10 um mean spacing, as in a Xenium section
    coords = rng.uniform(0.0, side, size=(n, 2))
    return StandIn(coords, rng.integers(0, N_CLS, size=n), N_CLS)


def _time_ms(fn, repeats: int, warm: bool = True) -> tuple[object, float]:
    """Mean milliseconds of ``repeats`` calls (CUDA events), after one warm-up
    call when ``warm``; returns the last call's result, which is compared."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / repeats


def _compare(name: str, kernel, plain, repeats: int, plain_warm: bool = True) -> dict:
    import torch

    got, ms = _time_ms(kernel, repeats)
    want, plain_ms = _time_ms(plain, 1, warm=plain_warm)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: kernel shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max()) if got.numel() else 0.0
    print(f"[kernel] {name}: max_abs_err={err} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}", flush=True)
    if err != 0.0:
        raise AssertionError(f"{name}: kernel and plain version differ (max abs err {err}); tolerance is 0")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_index_cipher(name: str, rk, n: int, edges) -> dict:
    """K4 labels ``(n, P)`` uint8 for round keys ``rk`` (R, P) and class
    boundaries ``edges``, against the plain version."""
    import torch

    from squidpy_torch._core.index_cipher import _cipher_plain, cipher_columns

    def plain():
        # columns are independent; blocks of 64 bound the int64 temporaries
        return torch.cat([_cipher_plain(rk[:, c : c + 64], n, edges, torch.uint8)
                          for c in range(0, rk.shape[1], 64)], dim=1)

    return _compare(f"index_cipher {name} n={n} P={rk.shape[1]} C={edges.numel() + 1}",
                    lambda: cipher_columns(rk, n, edges, torch.uint8), plain, repeats=10)


def random_index_cipher(n: int, n_cols: int, n_cls: int) -> dict:
    import torch

    from squidpy_torch._core.index_cipher import _cipher_plain, _round_keys, cipher_columns
    from squidpy_torch._core.rng import spawn_keys

    rng = np.random.default_rng(1)
    counts = np.bincount(rng.integers(0, n_cls, n), minlength=n_cls)
    edges = torch.from_numpy(np.cumsum(counts)[:-1].astype(np.int32)).cuda()
    rk = _round_keys(spawn_keys(0, n_cols), 8)
    res = check_index_cipher("random", rk, n, edges)
    pos = cipher_columns(rk, n, None, torch.int32)
    if not torch.equal(pos, _cipher_plain(rk, n, None, torch.int32)):
        raise AssertionError("index_cipher positions differ from the plain version")
    return res


def check_pair_counts(name: str, idx, mask, src, table, n_cls: int) -> dict:
    """K3 ``(P, C, C)`` counts of label columns over a padded-ELL graph,
    against the plain version."""
    from squidpy_torch.ops.nhood import _k3_layout, _pair_counts_plain, pair_counts_cols

    n, k_max = idx.shape
    shared = _k3_layout(n, src.shape[1], n_cls)[2]
    return _compare(
        f"pair_counts {name} n={n} k_max={k_max} P={src.shape[1]} C={n_cls} {src.dtype} shared_hist={shared}",
        lambda: pair_counts_cols(idx, mask, src, table, n_cls),
        lambda: _pair_counts_plain(idx, mask, src, table, n_cls),
        repeats=5,
    )


def random_pair_counts(n: int, k: int, k_max: int, n_cols: int, n_cls: int) -> dict:
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)
    idx = torch.randint(0, n, (n, k_max), generator=g, device="cuda", dtype=torch.int32)
    mask = torch.zeros((n, k_max), dtype=torch.bool, device="cuda")
    mask[:, :k] = True
    cols = torch.randint(0, n_cls, (n, n_cols), generator=g, device="cuda", dtype=torch.uint8)
    return check_pair_counts(f"random k={k}", idx, mask, cols, cols, n_cls)


def check_binned_pairs(name: str, pts: np.ndarray, labs: np.ndarray, thr: np.ndarray, n_cls: int,
                       plain_warm: bool = True) -> dict:
    """K1 boundary counts of the plan ``co_occurrence`` makes for these points
    and squared thresholds, against the plain version."""
    import torch

    from squidpy_torch.ops.binned_kernel import _binned_plain, _k1_smem, binned_inputs, binned_pairs
    from squidpy_torch.ops.pairbins import sorted_plan

    coords_s, labels_s, plan = sorted_plan(pts, labs, thr, n_cls)
    coords_p, labels_p, items, thr_t, n_thr = binned_inputs(coords_s, labels_s, plan, torch.device("cuda"))
    args = (coords_p, labels_p, plan.n, items, thr_t, n_thr, plan.tile, plan.gsize, n_cls)
    dim = pts.shape[1]
    shared = _k1_smem(plan.tile, dim, plan.gsize, n_cls)[1]
    return _compare(
        f"binned_pairs {name} n={plan.n} d={dim} C={n_cls} L={n_thr} tile={plan.tile} items={plan.n_items} "
        f"shared_hist={shared}",
        lambda: binned_pairs(*args),
        lambda: _binned_plain(*args),
        repeats=3,
        plain_warm=plain_warm,
    )


def random_binned_pairs(n: int, dim: int, n_cls: int) -> dict:
    from squidpy_torch.gr._ppatterns import _find_min_max

    rng = np.random.default_rng(3)
    pts = rng.uniform(0.0, 10.0 * np.sqrt(n), size=(n, dim)).astype(np.float32)
    labs = rng.integers(0, n_cls, n).astype(np.int32)
    lo, hi = _find_min_max(pts)  # the default interval=50 of co_occurrence
    interval = np.linspace(lo, hi, num=50, dtype=np.float32)
    thr = (interval[1:].astype(np.float64) ** 2).astype(np.float32)
    return check_binned_pairs("random, default interval", pts, labs, thr, n_cls)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _sync_time(fn) -> tuple[object, float]:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path(n: int) -> tuple[StandIn, np.ndarray, dict, dict]:
    """The public calls at scale, then checks of what they returned; returns
    the container, the co-occurrence interval, the kernel launches the public
    calls made and their seconds."""
    import torch

    import squidpy_torch as sqt
    from squidpy_torch import _cuda
    from squidpy_torch.gr._nhood import _permuted_counts
    from squidpy_torch.ops.cooccur import co_occurrence_counts, co_occurrence_probs

    adata = _dataset(n, seed=0)
    _, t_graph = _sync_time(lambda: sqt.gr.spatial_neighbors_knn(adata, n_neighs=N_NEIGHS))
    adj = adata.obsp["spatial_connectivities"]
    if adj.nnz != n * N_NEIGHS:
        raise AssertionError(f"kNN graph has {adj.nnz} edges, expected {n * N_NEIGHS}")

    _, t_warm = _sync_time(lambda: sqt.gr.nhood_enrichment(adata, "cluster", n_perms=N_PERMS, seed=1))
    _, t_nhood = _sync_time(lambda: sqt.gr.nhood_enrichment(adata, "cluster", n_perms=N_PERMS, seed=0))
    d_mean = float(adata.obsp["spatial_distances"].data.mean())
    interval = np.linspace(0.0, 5.0 * d_mean, 50)
    (occ, _), t_cooc = _sync_time(lambda: sqt.gr.co_occurrence(adata, "cluster", interval=interval, copy=True))
    launches = dict(_cuda.launches)  # the main path's launches; the checks below run more

    res = adata.uns["cluster_nhood_enrichment"]
    z, count = res["zscore"], res["count"]
    if z.shape != (N_CLS, N_CLS) or int(count.astype(np.int64).sum()) != n * N_NEIGHS:
        raise AssertionError("nhood_enrichment: wrong shape or observed edge total")
    # the same seeded permutations again, to check each one's edge total
    graph = adata.uns["__squidpy_torch_ell__spatial_connectivities"]["graph"]
    codes = adata.obs["cluster"].cat.codes
    labels = torch.from_numpy(codes).to(sqt.get_device())
    perms = _permuted_counts(graph, labels, codes, N_CLS, N_PERMS, 0)
    if not np.all(perms.sum(axis=(1, 2)) == n * N_NEIGHS):
        raise AssertionError("a permutation's pair counts do not sum to n * k")
    varying = perms.std(axis=0) > 0
    if not np.all(np.isfinite(z[varying])):
        raise AssertionError("non-finite z-scores off zero-variance pairs")
    with np.errstate(invalid="ignore", divide="ignore"):
        z_again = (count - perms.mean(axis=0)) / perms.std(axis=0)
    if not np.array_equal(z, z_again, equal_nan=True):
        raise AssertionError("nhood_enrichment z-scores are not reproducible from the same seed")

    thr = _squared_thresholds(interval)
    counts = co_occurrence_counts(np.asarray(adata.obsm["spatial"], np.float32), codes, thr, N_CLS)
    totals = counts.sum(axis=(0, 1))
    if not (np.all(np.isfinite(counts)) and np.all(np.diff(totals) >= 0) and totals[-1] > 0):
        raise AssertionError("co_occurrence counts not finite or per-threshold totals decreasing")
    if occ.shape != (N_CLS, N_CLS, 49) or not np.array_equal(occ, co_occurrence_probs(counts)):
        raise AssertionError("co_occurrence probabilities disagree with their counts")
    return adata, interval, launches, {
        "graph_s": t_graph, "nhood_warmup_s": t_warm, "nhood_s": t_nhood, "co_occurrence_s": t_cooc,
        "mean_knn_distance": d_mean, "pairs_at_last_threshold": float(totals[-1]),
    }


def _squared_thresholds(interval: np.ndarray) -> np.ndarray:
    """The float32 squared thresholds ``co_occurrence`` derives from an interval."""
    return (np.asarray(sorted(interval), dtype=np.float32)[1:].astype(np.float64) ** 2).astype(np.float32)


def main_path_kernel_checks(adata: StandIn, interval: np.ndarray) -> dict[str, list[dict]]:
    """Each kernel against its plain version on the inputs the main path gave
    it: the first 500-permutation chunk of ``nhood_enrichment(seed=0)`` (its
    keys, class boundaries and ELL graph), the observed count, and the plan of
    the short-range ``co_occurrence`` call."""
    import torch

    from squidpy_torch._core.index_cipher import DEFAULT_ROUNDS, _round_keys, cipher_columns
    from squidpy_torch._core.rng import spawn_keys
    from squidpy_torch.gr._nhood import _PERM_CHUNK

    codes = np.asarray(adata.obs["cluster"].cat.codes, dtype=np.int32)
    n = codes.shape[0]
    graph = adata.uns["__squidpy_torch_ell__spatial_connectivities"]["graph"]
    rk = _round_keys(spawn_keys(0, N_PERMS)[:_PERM_CHUNK], DEFAULT_ROUNDS)
    edges = torch.from_numpy(np.cumsum(np.bincount(codes, minlength=N_CLS))[:-1].astype(np.int32)).cuda()
    k4 = check_index_cipher("main path, first chunk", rk, n, edges)
    cols = cipher_columns(rk, n, edges, torch.uint8)
    k3 = check_pair_counts("main path, first chunk", graph.indices, graph.mask, cols, cols, N_CLS)
    obs = torch.from_numpy(codes).cuda().reshape(-1, 1)
    k3_obs = check_pair_counts("main path, observed", graph.indices, graph.mask, obs, obs, N_CLS)
    k1 = check_binned_pairs("main path, short range", np.asarray(adata.obsm["spatial"], np.float32), codes,
                            _squared_thresholds(interval), N_CLS, plain_warm=False)
    return {"index_cipher": [k4], "pair_counts": [k3, k3_obs], "binned_pairs": [k1]}


def _row_sorted(m) -> tuple[np.ndarray, np.ndarray]:
    """Row ids and each row's stored values, sorted within the row."""
    m = m.tocsr()
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    return rows, m.data[np.lexsort((m.data, rows))]


def reference_check(n: int, interval) -> None:
    """The public path on the card and on the CPU (plain torch) must agree:
    the kNN graph to the expanded form's rounding, the rest bitwise."""
    import squidpy_torch as sqt

    t0 = time.perf_counter()
    results = []
    graph = None
    for device in ("cuda", "cpu"):
        with sqt.set_device(device):
            adata = _dataset(n, seed=5)
            sqt.gr.spatial_neighbors_knn(adata, n_neighs=N_NEIGHS)
            knn_distances = adata.obsp["spatial_distances"]
            if graph is None:
                graph = adata.obsp["spatial_connectivities"]
            adata.obsp["spatial_connectivities"] = graph
            sqt.gr.nhood_enrichment(adata, "cluster", n_perms=50, seed=0)
            sqt.gr.co_occurrence(adata, "cluster", interval=interval)
            adata.obsp["spatial_distances"] = knn_distances
            results.append(adata)
    gpu, cpu = results
    # the brute-force kNN (n <= 50k) ranks by expanded-form d2, whose f32
    # error is a few ulps of max |p|^2 and rounds differently in the card's
    # and the CPU's matrix products, so neighbours tied to within that error
    # may swap: hold each row's sorted d2 to 16 ulps of max |p|^2, then count
    # on one graph
    (rows_gpu, d_gpu), (rows_cpu, d_cpu) = (_row_sorted(a.obsp["spatial_distances"]) for a in (gpu, cpu))
    if not np.array_equal(rows_gpu, rows_cpu):
        raise AssertionError("kNN graphs differ in their number of neighbours per row")
    max_sq = float((np.asarray(cpu.obsm["spatial"], np.float32).astype(np.float64) ** 2).sum(axis=1).max())
    np.testing.assert_allclose(d_gpu**2, d_cpu**2, rtol=1e-5, atol=16 * np.finfo(np.float32).eps * max_sq)
    for key, field in (("cluster_nhood_enrichment", "count"), ("cluster_nhood_enrichment", "zscore"),
                       ("cluster_co_occurrence", "occ")):
        if not np.array_equal(gpu.uns[key][field], cpu.uns[key][field], equal_nan=True):
            raise AssertionError(f"{key}[{field!r}] differs between card and CPU")
    print(f"[reference] n={n} interval={np.size(interval)}: card and CPU agree: kNN distances, and bitwise "
          f"nhood counts/z-scores and co-occurrence ({time.perf_counter() - t0:.1f} s)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import squidpy_torch as sqt
    from squidpy_torch import _cuda

    smi = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sqt.set_device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _cuda.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}", flush=True)

    _cuda.reset_launches()
    adata, interval, launches, secs = main_path(N_CELLS)
    print(f"[main path] n={N_CELLS} " + " ".join(f"{k}={v:.4f}" for k, v in secs.items()), flush=True)
    print(f"[launches] {launches}", flush=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")

    # the main path's own inputs first (their times go into the JSON line),
    # then the fixed shapes and the branches the main path does not take
    checks = main_path_kernel_checks(adata, interval)
    del adata
    checks["index_cipher"].append(random_index_cipher(N_CELLS, 64, N_CLS))
    checks["pair_counts"] += [random_pair_counts(N_CELLS, N_NEIGHS, 8, 64, N_CLS),
                              random_pair_counts(N_CELLS, N_NEIGHS, 8, 16, 200)]
    checks["binned_pairs"] += [random_binned_pairs(200_000, 2, N_CLS), random_binned_pairs(100_000, 3, N_CLS),
                               random_binned_pairs(20_000, 2, 96)]

    # card against CPU through the public API: small (brute-force kNN, sort
    # shuffles, dense sweep), and at 100k (cipher shuffles, binned sweep)
    reference_check(3000, 20)
    reference_check(100_000, np.linspace(0.0, 5.0 * secs["mean_knn_distance"], 9))

    kernels = []
    for name, (source, replaces) in _cuda.KERNELS.items():
        first = checks[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(c["max_abs_err"] for c in checks[name]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
