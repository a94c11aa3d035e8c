#!/usr/bin/env python3
"""Run the squidpy_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no error is caught and passed over):

1. device: require a CUDA card, print its name and power limit, TF32 off;
2. build: compile the CUDA kernels from ``squidpy_torch/csrc`` (timed);
3. the main path through the public API at Xenium scale, in two parts,
   each with the launch counters reset before it and read after it, and
   every kernel of the part required to have run:
   a. 1M cells, k=6, 16 clusters: ``spatial_neighbors_knn`` ->
      ``nhood_enrichment`` (1000 permutations, a warm-up seed then a timed
      one) -> ``co_occurrence`` over a short-range interval (K4, K3, K1);
   b. on the same graph, 512 genes of Poisson counts: ``spatial_autocorr``
      Moran without permutations, Moran with 100, Geary with 100 (K5a,
      K5b, K4 positions); then ``co_occurrence(use_pallas=True)`` on 200k
      cells with the default interval=50 (K2);
   then checks of what the calls returned;
4. each kernel against its plain torch version on the card, with both
   times, the least time the card could take (``bound_ms``) and, where one
   PyTorch call computes the same function, its time: first on the main
   path's own inputs, then at fixed shapes and in the branches the main path
   does not take (K3 and K1 with global atomics, K1 in 3D, K5a on a skewed
   graph's degree buckets, K2 with 128 classes and in 3D). Integer kernels
   (K1-K4) and K5a's ``u = W x`` must agree bitwise; the float sums of K5a's
   Moran/Geary numerators and of K5b to ``1e-5 * sum |terms|`` per output
   (they sum in another order, and a Moran numerator is near 0, so a
   relative tolerance would mean nothing);
5. the same public calls on the card and on the CPU (plain torch) must
   agree, at 3000 cells (brute-force kNN, sort shuffles, dense sweep, K2)
   and at 100k cells (cipher shuffles, binned sweep): counts, z-scores and
   co-occurrence bitwise, permutation indices bitwise, autocorrelation
   scores to the bound above and p-values to rtol 1e-3.

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
N_GENES = 512  # a Xenium panel's width
AUTOCORR_PERMS = 100
PALLAS_CELLS = 200_000
K2_SUBSET_CELLS = 30_000  # a smaller K2 shape drawn from the main path's cells, beside its own launch
SKEWED_CELLS = 200_000

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores; 32-bit integer ops are counted at it too
SUM_TOL = 1e-5  # float sums: |kernel - plain| <= SUM_TOL * sum |terms|


class _Categorical:
    """Numpy stand-in for a categorical obs column (``.cat.codes``/``.cat.categories``)."""

    def __init__(self, codes: np.ndarray, n_cls: int) -> None:
        self.cat = SimpleNamespace(codes=codes.astype(np.int32), categories=[str(c) for c in range(n_cls)])
        self.dtype = "category"


class StandIn:
    """Numpy-only stand-in for an AnnData container: obs/obsm/obsp/uns
    mappings, and X with its var_names once expression is attached."""

    def __init__(self, coords: np.ndarray, codes: np.ndarray, n_cls: int) -> None:
        self.obs = {"cluster": _Categorical(codes, n_cls)}
        self.obsm = {"spatial": coords}
        self.obsp: dict = {}
        self.uns: dict = {}
        self.X = None
        self.var_names: list[str] = []

    def set_expression(self, x: object) -> None:
        self.X = x
        self.var_names = [f"gene_{i}" for i in range(x.shape[1])]


def _dataset(n: int, seed: int) -> StandIn:
    rng = np.random.default_rng(seed)
    side = 10.0 * np.sqrt(n)  # ~10 um mean spacing, as in a Xenium section
    coords = rng.uniform(0.0, side, size=(n, 2))
    return StandIn(coords, rng.integers(0, N_CLS, size=n), N_CLS)


def poisson_counts(n: int, n_genes: int, seed: int, low: float | None = None) -> np.ndarray:
    """``(n, n_genes)`` uint8 Poisson counts, drawn on the card from a seeded
    generator: per-gene means lognormal around 0.37 (a sparse imaging panel),
    or uniform in ``[low, 4)``."""
    import torch

    rng = np.random.default_rng(seed)
    means = rng.uniform(low, 4.0, n_genes) if low is not None else np.clip(rng.lognormal(-1.0, 1.0, n_genes), 0.02, 20)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rates = torch.from_numpy(means.astype(np.float32)).cuda().expand(n, n_genes).contiguous()
    counts = torch.poisson(rates, generator=gen).clamp_(max=255).to(torch.uint8)
    return counts.cpu().numpy()


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least milliseconds the card could take: bytes over its memory rate or
    operations over its float32 rate, whichever is longer, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def _compare(name: str, kernel, plain, repeats: int, bound: tuple[float, str], plain_warm: bool = True,
             terms=None, library=None) -> dict:
    """Kernel against its plain version: bitwise, or, given ``terms`` (the
    plain version's sum of |terms| per output), to ``SUM_TOL * terms``."""
    import torch

    got, ms = _time_ms(kernel, repeats)
    want, plain_ms = _time_ms(plain, 1, warm=plain_warm)
    library_ms = _time_ms(library, repeats)[1] if library is not None else None
    if got.shape != want.shape:
        raise AssertionError(f"{name}: kernel shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    err = float(diff.max()) if got.numel() else 0.0
    line = f"[kernel] {name}: max_abs_err={err} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} " \
           f"bound_ms={bound[0]:.4f} ({bound[1]})"
    if library_ms is not None:
        line += f" library_ms={library_ms:.3f}"
    if terms is None:
        print(line, flush=True)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel and plain version differ (max abs err {err}); tolerance is 0")
    else:
        ratio = float((diff / terms.to(torch.float64).clamp_min(1e-300)).max())
        print(f"{line} max |err| / sum|terms| = {ratio:.3e} (tolerance {SUM_TOL})", flush=True)
        if not bool((diff <= SUM_TOL * terms.to(torch.float64)).all()):
            raise AssertionError(f"{name}: kernel and plain differ by more than {SUM_TOL} * sum |terms| ({ratio:.3e})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def check_index_cipher(name: str, rk, n: int, edges) -> dict:
    """K4 labels ``(n, P)`` uint8 for round keys ``rk`` (R, P) and class
    boundaries ``edges``, against the plain version."""
    import torch

    from squidpy_torch._core.index_cipher import _cipher_plain, cipher_columns

    from squidpy_torch._core.index_cipher import _radices

    def plain():
        # columns are independent; blocks of 64 bound the int64 temporaries
        return torch.cat([_cipher_plain(rk[:, c : c + 64], n, edges, torch.uint8)
                          for c in range(0, rk.shape[1], 64)], dim=1)

    rounds, n_cols = rk.shape
    a, b = _radices(n)
    # per (i, p) and cycle-walk pass: per round a key xor, the 8-op mix, two
    # mod/add steps; the radix split and join; a*b/n passes expected; then a
    # search over the class boundaries. Output n*P bytes, keys and edges read.
    ops = n * n_cols * ((rounds * 12 + 4) * a * b / n + np.log2(max(edges.numel(), 1) + 1))
    bound = _bound(n * n_cols + rk.numel() * 4 + edges.numel() * 4, ops)
    return _compare(f"index_cipher {name} n={n} P={n_cols} C={edges.numel() + 1}",
                    lambda: cipher_columns(rk, n, edges, torch.uint8), plain, repeats=10, bound=bound)


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
    n_cols = src.shape[1]
    shared = _k3_layout(n, n_cols, n_cls)[2]
    edges = int(mask.sum())
    # ELL indices and mask once, the label columns once (source and table are
    # one tensor here), the (P, C, C) int32 output once; per stored edge and
    # column: the label pair's bin and one add
    nbytes = idx.numel() * 4 + mask.numel() + src.numel() * src.element_size() + n_cols * n_cls * n_cls * 4
    bound = _bound(nbytes, 3.0 * edges * n_cols)
    return _compare(
        f"pair_counts {name} n={n} k_max={k_max} P={n_cols} C={n_cls} {src.dtype} shared_hist={shared}",
        lambda: pair_counts_cols(idx, mask, src, table, n_cls),
        lambda: _pair_counts_plain(idx, mask, src, table, n_cls),
        repeats=5, bound=bound,
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
    # every candidate pair of every item with an open window: (3d - 1) flops
    # of the difference-form d2, one compare with the window and a bin search
    # over the group; the inputs are a few MB
    m = plan.n_items
    ti, tj = plan.ti[:m].astype(np.int64), plan.tj[:m].astype(np.int64)
    off = plan.gid[:m].astype(np.int64) * plan.gsize
    live = (ti >= 0) & (np.minimum(np.minimum(plan.rfull[:m] - off, plan.gsize), n_thr - off)
                        > np.maximum(plan.rempty[:m] - off, 0))
    rows = np.clip(plan.n - ti * plan.tile, 0, plan.tile)
    cols = np.clip(plan.n - tj * plan.tile, 0, plan.tile)
    pairs = float(np.where(ti == tj, rows * (rows - 1) // 2, rows * cols)[live].sum())
    ops = pairs * (3 * dim - 1 + 1 + np.ceil(np.log2(plan.gsize + 1)))
    nbytes = plan.n * (dim + 1) * 4 + 5 * m * 4 + plan.thr_groups.size * 4 + n_thr * n_cls * n_cls * 8
    return _compare(
        f"binned_pairs {name} n={plan.n} d={dim} C={n_cls} L={n_thr} tile={plan.tile} items={plan.n_items} "
        f"shared_hist={shared}",
        lambda: binned_pairs(*args),
        lambda: _binned_plain(*args),
        repeats=3, bound=_bound(nbytes, ops),
        plain_warm=plain_warm,
    )


def random_binned_pairs(n: int, dim: int, n_cls: int) -> dict:
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.0, 10.0 * np.sqrt(n), size=(n, dim)).astype(np.float32)
    labs = rng.integers(0, n_cls, n).astype(np.int32)
    return check_binned_pairs("random, default interval", pts, labs, _default_thresholds(pts), n_cls)


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


def _normalized_graph(adata: StandIn):
    """The row-normalised CSR and its float32 ELL graph on the card, as
    ``spatial_autocorr(transformation=True)`` builds them."""
    from scipy import sparse as sp

    from squidpy_torch._core.graph import SpatialGraph

    g = sp.csr_matrix(adata.obsp["spatial_connectivities"], dtype=np.float64)
    rs = np.asarray(g.sum(axis=1)).ravel()
    g = sp.csr_matrix(sp.diags(np.divide(1.0, rs, out=np.zeros_like(rs), where=rs != 0)) @ g)
    return g, SpatialGraph.from_csr(g, dtype=np.float32)


def autocorr_path(adata: StandIn) -> tuple[dict, dict, dict]:
    """The second part of the main path: ``spatial_autocorr`` on the 1M-cell
    graph over 512 genes (Moran without permutations, Moran and Geary with
    100), then ``co_occurrence(use_pallas=True)`` on 200k cells. The launch
    counters are reset just before the public calls and read just after;
    then checks of what the calls returned. Returns the results, the
    launches and the seconds."""
    import squidpy_torch as sqt
    from squidpy_torch import _cuda
    from squidpy_torch.ops.cooccur import co_occurrence_probs
    from squidpy_torch.ops.dense_pairs import dense_pair_counts

    n = adata.obsm["spatial"].shape[0]
    x, t_x = _sync_time(lambda: poisson_counts(n, N_GENES, seed=4))
    adata.set_expression(x)
    small = _dataset(PALLAS_CELLS, seed=2)

    _cuda.reset_launches()
    moran, t_moran = _sync_time(lambda: sqt.gr.spatial_autocorr(adata, mode="moran", copy=True))
    moran_p, t_moran_p = _sync_time(lambda: sqt.gr.spatial_autocorr(
        adata, mode="moran", n_perms=AUTOCORR_PERMS, seed=0, copy=True))
    geary_p, t_geary_p = _sync_time(lambda: sqt.gr.spatial_autocorr(
        adata, mode="geary", n_perms=AUTOCORR_PERMS, seed=0, copy=True))
    (occ, interval), t_pallas = _sync_time(lambda: sqt.gr.co_occurrence(small, "cluster", copy=True, use_pallas=True))
    launches = dict(_cuda.launches)

    p_max = (AUTOCORR_PERMS // 2 + 1) / (AUTOCORR_PERMS + 1)  # the smaller tail holds at most half the sims
    for res, stat in ((moran, "I"), (moran_p, "I"), (geary_p, "C")):
        cols = res.columns
        if len(res.index) != N_GENES or not np.all(np.isfinite(cols[stat])):
            raise AssertionError(f"spatial_autocorr: {len(res.index)} rows or non-finite {stat}")
        if not np.all((cols["pval_norm"] >= 0) & (cols["pval_norm"] <= 1)):
            raise AssertionError("spatial_autocorr: pval_norm outside [0, 1]")
        if "pval_sim" in cols:
            # var_sim is finite exactly when every permuted score is
            if not np.all(np.isfinite(cols["var_sim"])):
                raise AssertionError("spatial_autocorr: a permuted score is not finite")
            if not np.all((cols["pval_sim"] > 0) & (cols["pval_sim"] <= p_max)):
                raise AssertionError(f"spatial_autocorr: pval_sim outside (0, {p_max:.4f}]")
    order = {g: i for i, g in enumerate(moran.index)}
    i_scores = moran.columns["I"][[order[g] for g in moran_p.index]]
    if not np.allclose(i_scores, moran_p.columns["I"], rtol=1e-4, atol=1e-6):
        raise AssertionError("Moran's I differs between the score-only and the permutation runs")

    coords = np.asarray(small.obsm["spatial"], np.float32)
    codes = small.obs["cluster"].cat.codes
    counts = dense_pair_counts(coords, codes, _squared_thresholds(interval), N_CLS)
    totals = counts.sum(axis=(0, 1))
    if not (np.all(np.diff(totals) >= 0) and 0 < totals[-1] <= PALLAS_CELLS * (PALLAS_CELLS - 1)):
        raise AssertionError("co_occurrence(use_pallas=True): per-threshold totals decrease or exceed n(n-1)")
    if occ.shape != (N_CLS, N_CLS, 49) or not np.array_equal(occ, co_occurrence_probs(counts)):
        raise AssertionError("co_occurrence(use_pallas=True) probabilities disagree with their counts")
    results = {"moran": moran, "moran_perms": moran_p, "geary_perms": geary_p, "pallas_dataset": small,
               "pallas_interval": interval}
    return results, launches, {
        "x_generation_s": t_x, "autocorr_moran_s": t_moran, "autocorr_moran_perms_s": t_moran_p,
        "autocorr_geary_perms_s": t_geary_p, "co_occurrence_pallas_s": t_pallas,
        "pallas_pairs_at_last_threshold": float(totals[-1]),
    }


def check_ell_autocorr(name: str, idx, w, x, z, rows=None, library=None) -> list[dict]:
    """K5a in its three modes against the plain version: ``u = W z``
    bitwise, the Moran numerator of ``z`` and the Geary numerator of ``x``
    to ``SUM_TOL * sum |terms|``."""
    import torch

    from squidpy_torch.ops.autocorr import _ell_plain, ell_autocorr

    n_b, k = idx.shape
    n, g = x.shape
    tag = f"ell_autocorr {name} n={n} rows={n_b} k={k} g={g}"
    ell_bytes = idx.numel() * 4 + w.numel() * 4 + (rows.numel() * 4 if rows is not None else 0)
    out = []
    for mode, y, flops in (("spmv", z, 2), ("moran", z, 3), ("geary", x, 4)):
        # the gene block and the ELL arrays read once; u (the bucket's rows)
        # or the (g,) numerator written once
        nbytes = n * g * 4 + ell_bytes + (n_b * g * 4 if mode == "spmv" else g * 4)
        terms = None
        if mode == "moran":
            terms = _ell_plain("moran", idx, w.abs(), z.abs(), rows)
        elif mode == "geary":
            terms = _ell_plain("geary", idx, w.abs(), x, rows)
        def plain(mode=mode, y=y):
            res = _ell_plain(mode, idx, w, y, rows)
            if mode == "spmv" and rows is not None:  # the bucket's rows of an (n, g) u
                return torch.zeros_like(y).index_copy_(0, rows.long(), res)
            return res

        out.append(_compare(
            f"{tag} mode={mode}",
            lambda mode=mode, y=y: ell_autocorr(mode, idx, w, y, rows),
            plain,
            repeats=5, bound=_bound(nbytes, flops * n_b * k * g), terms=terms,
            library=library if mode == "spmv" else None,
        ))
    return out


def check_perm_autocorr(name: str, z, u, r, perms) -> list[dict]:
    """K5b for Moran and Geary against the plain version, to
    ``SUM_TOL * sum |terms|`` (for Geary the bound |z| (|z| r + 2 |u|))."""
    from squidpy_torch.ops.autocorr import _perm_plain, perm_autocorr

    n, g = z.shape
    n_perms = perms.shape[0]
    out = []
    for mode, rr, flops in (("moran", None, 2), ("geary", r, 5)):
        u_abs = -u.abs() if mode == "geary" else u.abs()
        terms = _perm_plain(mode, z.abs(), u_abs, rr, perms)
        nbytes = 2 * n * g * 4 + n_perms * n * 4 + (n * 4 if rr is not None else 0) + n_perms * g * 4
        out.append(_compare(
            f"perm_autocorr {name} mode={mode} n={n} g={g} P={n_perms}",
            lambda mode=mode, rr=rr: perm_autocorr(mode, z, u, perms, rr),
            lambda mode=mode, rr=rr: _perm_plain(mode, z, u, rr, perms),
            repeats=3, bound=_bound(nbytes, flops * n_perms * n * g), terms=terms,
        ))
    return out


def check_dense_pairs(name: str, pts: np.ndarray, labs: np.ndarray, thr: np.ndarray, n_cls: int,
                      plain_warm: bool = True) -> dict:
    """K2 counts against the plain version, bitwise."""
    import torch

    from squidpy_torch.ops.dense_pairs import _dense_plain, _k2_layout, dense_pairs

    n, dim = pts.shape
    thr_t = torch.from_numpy(np.sort(thr).astype(np.float32)).cuda()
    args = (torch.from_numpy(np.ascontiguousarray(pts, np.float32)).cuda(),
            torch.from_numpy(np.asarray(labs, np.int32)).cuda(), thr_t, n_cls)
    return _compare(f"dense_pairs {name} n={n} d={dim} C={n_cls} L={len(thr)} "
                    f"shared_hist={_k2_layout(dim, len(thr), n_cls)[1]}",
                    lambda: dense_pairs(*args), lambda: _dense_plain(*args), repeats=3,
                    bound=_dense_pairs_bound(n, dim, len(thr), n_cls), plain_warm=plain_warm)


def _dense_pairs_bound(n: int, dim: int, n_thr: int, n_cls: int) -> tuple[float, str]:
    """Every unordered pair: the dot product (2d - 1 flops), the norm sum,
    the doubled dot and the difference (3), the compare with the largest
    threshold and a bin search over the thresholds; inputs and the output
    once."""
    ops = n * (n - 1) / 2 * (2 * dim + 2 + 1 + np.ceil(np.log2(n_thr + 1)))
    return _bound(n * (dim + 1) * 4 + n_thr * 4 + n_thr * n_cls * n_cls * 8, ops)


def _default_thresholds(pts: np.ndarray) -> np.ndarray:
    from squidpy_torch.gr._ppatterns import _find_min_max

    lo, hi = _find_min_max(np.asarray(pts, np.float32))  # the default interval=50 of co_occurrence
    return _squared_thresholds(np.linspace(lo, hi, num=50, dtype=np.float32))


def autocorr_kernel_checks(adata: StandIn, results: dict) -> dict[str, list[dict]]:
    """K5a, K5b and K2 against their plain versions on the inputs the main
    path gave them: the first 512-gene block and the normalised 1M-cell
    graph (K5a, all three modes, with ``torch.sparse.mm`` of the CSR W as
    the yardstick of ``u = W z``), ``u`` and the 100 permutations of seed 0
    (K5b, Moran and Geary), and the 200k-cell co-occurrence's points, labels
    and default thresholds (K2), then a ``K2_SUBSET_CELLS``-cell subset of them."""
    import torch

    from squidpy_torch._core.index_cipher import cipher_index_batch
    from squidpy_torch._core.rng import spawn_keys
    from squidpy_torch.ops.autocorr import ell_autocorr

    n = adata.obsm["spatial"].shape[0]
    handle = adata.uns["__squidpy_torch_device_x__None_False"]["handle"]
    xb = handle.dense_block(np.arange(N_GENES))
    zb = xb - torch.mean(xb, dim=0, keepdim=True)
    g_csr, graph = _normalized_graph(adata)
    w_sparse = torch.sparse_csr_tensor(
        torch.from_numpy(g_csr.indptr.astype(np.int64)), torch.from_numpy(g_csr.indices.astype(np.int64)),
        torch.from_numpy(g_csr.data.astype(np.float32)), size=g_csr.shape, check_invariants=False).cuda()
    k5a = check_ell_autocorr("main path, first block", graph.indices, graph.weights, xb, zb,
                             library=lambda: torch.sparse.mm(w_sparse, zb))
    del xb
    ub = ell_autocorr("spmv", graph.indices, graph.weights, zb)
    perms = cipher_index_batch(spawn_keys(0, AUTOCORR_PERMS), n)
    r = torch.from_numpy(np.asarray(g_csr.sum(axis=1), np.float32).ravel()).cuda()
    k5b = check_perm_autocorr("main path, first block", zb, ub, r, perms)
    del zb, ub, perms

    small = results["pallas_dataset"]
    pts = np.asarray(small.obsm["spatial"], np.float32)
    thr = _squared_thresholds(results["pallas_interval"])
    codes = np.asarray(small.obs["cluster"].cat.codes, np.int32)
    k2 = [check_dense_pairs("main path", pts, codes, thr, N_CLS, plain_warm=False)]
    sub = np.random.default_rng(0).choice(len(pts), K2_SUBSET_CELLS, replace=False)
    k2.append(check_dense_pairs(f"main path thresholds, {K2_SUBSET_CELLS} of the {len(pts)} cells", pts[sub],
                                codes[sub], thr, N_CLS))
    return {"ell_autocorr": k5a, "perm_autocorr": k5b, "dense_pairs": k2}


def skewed_csr(n: int, seed: int):
    """A radius-graph-like adjacency: 5% hub rows of ~60 neighbours, the rest ~6."""
    from scipy import sparse as sp

    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(n) < n // 20, 60, 6)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n - 1, rows.size)
    cols += cols >= rows  # no self loops
    g = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))
    g.sum_duplicates()
    return g


def branch_checks() -> dict[str, list[dict]]:
    """The branches the main path does not take: K5a over the degree buckets
    of a skewed ``SKEWED_CELLS``-row graph (also through ``spatial_autocorr``, Moran with
    permutations and Geary, from a sparse X), K2 with 128 classes (the global histogram) and
    in 3D."""
    import torch
    from scipy import sparse as sp

    import squidpy_torch as sqt
    from squidpy_torch.ops.autocorr import _ell_plain, spmv_genes_bucketed

    n = SKEWED_CELLS
    adata = _dataset(n, seed=6)
    adata.obsp["spatial_connectivities"] = skewed_csr(n, seed=6)
    counts = poisson_counts(n, 64, seed=6, low=0.5)
    adata.set_expression(sp.csr_matrix(counts))  # sparse X: blocks are densified on the card
    _, graph = _normalized_graph(adata)
    buckets = graph.degree_buckets()
    if buckets is None or not 2 <= len(buckets) <= 4:
        raise AssertionError(f"the skewed graph gave {None if buckets is None else len(buckets)} degree buckets")
    x = torch.from_numpy(counts.astype(np.float32)).cuda()
    z = x - torch.mean(x, dim=0, keepdim=True)
    k5a = []
    for b, (rows, idx, w) in enumerate(buckets):
        k5a += check_ell_autocorr(f"bucket {b}/{len(buckets)}", idx, w, x, z, rows=rows)
    u_plain = torch.zeros_like(z)
    for rows, idx, w in buckets:
        u_plain[rows.long()] = _ell_plain("spmv", idx, w, z, rows)
    if not torch.equal(spmv_genes_bucketed(buckets, z), u_plain):
        raise AssertionError("bucketed u = W z differs from the plain version")
    for mode, n_perms in (("moran", 20), ("geary", None)):
        res = sqt.gr.spatial_autocorr(adata, mode=mode, n_perms=n_perms, seed=0, copy=True)
        stat = "I" if mode == "moran" else "C"
        if not all(np.all(np.isfinite(v)) for v in res.columns.values()) or len(res.index) != 64:
            raise AssertionError(f"spatial_autocorr on the skewed graph ({mode}): non-finite or missing rows")
    print(f"[branch] skewed graph n={n}: {len(buckets)} degree buckets, widths "
          f"{[int(i.shape[1]) for _, i, _ in buckets]}; spatial_autocorr Moran (20 perms) and Geary finite", flush=True)

    rng = np.random.default_rng(8)
    k2 = []
    for n_pts, dim, n_cls in ((20_000, 2, 128), (20_000, 3, N_CLS)):
        pts = rng.uniform(0.0, 10.0 * np.sqrt(n_pts), (n_pts, dim)).astype(np.float32)
        k2.append(check_dense_pairs("random, default interval", pts, rng.integers(0, n_cls, n_pts), _default_thresholds(pts),
                                    n_cls))
    return {"ell_autocorr": k5a, "dense_pairs": k2}


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


def _autocorr_terms_bound(adata: StandIn, res, mode: str) -> np.ndarray:
    """``SUM_TOL * sum |terms|`` of each row's statistic, carried through its
    normalisation, on the host in float64."""
    g, _ = _normalized_graph(adata)
    n, s0 = g.shape[0], float(g.sum())
    names = list(adata.var_names)
    x = adata.X.toarray() if hasattr(adata.X, "toarray") else adata.X
    x = np.asarray(x, np.float64)[:, [names.index(i) for i in res.index]]
    z = x - x.mean(axis=0)
    den = np.sum(z * z, axis=0)
    if mode == "moran":
        return SUM_TOL * n / s0 / den * np.sum(np.abs(z) * (g @ np.abs(z)), axis=0)
    coo = g.tocoo()
    return SUM_TOL * (n - 1) / (2 * s0) / den * (coo.data @ (x[coo.row] - x[coo.col]) ** 2)


def reference_check(n: int, interval) -> None:
    """The public path on the card and on the CPU (plain torch) must agree:
    the kNN graph to the expanded form's rounding; counts, z-scores,
    co-occurrence (also ``use_pallas=True`` at 3000 cells) and permutation
    indices bitwise; autocorrelation scores to ``SUM_TOL * sum |terms|`` and
    p-values to rtol 1e-3 (``pval_sim`` and ``var_norm`` exactly)."""
    import squidpy_torch as sqt
    from squidpy_torch._core.index_cipher import MIN_CIPHER_N, cipher_index_batch
    from squidpy_torch._core.rng import permutation_batch, spawn_keys

    t0 = time.perf_counter()
    results = []
    graph = None
    x = poisson_counts(n, 16, seed=9, low=0.5)
    if n > 3000:  # the larger input takes the sparse X path (CSC blocks densified on the device)
        from scipy import sparse as sp

        x = sp.csr_matrix(x)
    for device in ("cuda", "cpu"):
        with sqt.set_device(device):
            adata = _dataset(n, seed=5)
            adata.set_expression(x)
            sqt.gr.spatial_neighbors_knn(adata, n_neighs=N_NEIGHS)
            knn_distances = adata.obsp["spatial_distances"]
            if graph is None:
                graph = adata.obsp["spatial_connectivities"]
            adata.obsp["spatial_connectivities"] = graph
            sqt.gr.nhood_enrichment(adata, "cluster", n_perms=50, seed=0)
            sqt.gr.co_occurrence(adata, "cluster", interval=interval)
            sqt.gr.spatial_autocorr(adata, mode="moran", n_perms=20, seed=0)
            sqt.gr.spatial_autocorr(adata, mode="geary", n_perms=20, seed=0)
            if n <= 3000:
                adata.uns["pallas_occ"] = sqt.gr.co_occurrence(adata, "cluster", interval=interval, copy=True,
                                                              use_pallas=True)[0]
            keys = spawn_keys(0, 20)
            adata.uns["perms"] = (cipher_index_batch(keys, n) if n >= MIN_CIPHER_N
                                  else permutation_batch(keys, n, sqt.get_device())).cpu().numpy()
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
    for key in ("perms", "pallas_occ") if n <= 3000 else ("perms",):
        if not np.array_equal(gpu.uns[key], cpu.uns[key]):
            raise AssertionError(f"{key} differs between card and CPU")
    worst = 0.0
    for key, mode, stat in (("moranI", "moran", "I"), ("gearyC", "geary", "C")):
        a, b = gpu.uns[key], cpu.uns[key]
        if list(a.index) != list(b.index) or list(a.columns) != list(b.columns):
            raise AssertionError(f"{key}: rows or columns differ between card and CPU")
        bound = _autocorr_terms_bound(cpu, b, mode)
        diff = np.abs(a.columns[stat] - b.columns[stat])
        worst = max(worst, float((diff / bound).max()) * SUM_TOL)
        if not np.all(diff <= bound):
            raise AssertionError(f"{key}[{stat!r}] differs between card and CPU beyond {SUM_TOL} * sum |terms|")
        for col in a.columns:
            if col in ("var_norm", "pval_sim") or col.startswith("pval_sim_"):
                np.testing.assert_array_equal(a.columns[col], b.columns[col], err_msg=f"{key}[{col!r}]")
            elif col != stat:
                np.testing.assert_allclose(a.columns[col], b.columns[col], rtol=1e-3, atol=1e-12,
                                           err_msg=f"{key}[{col!r}]")
    print(f"[reference] n={n} interval={np.size(interval)}: card and CPU agree: kNN distances; bitwise nhood "
          f"counts/z-scores, co-occurrence{' (also use_pallas)' if n <= 3000 else ''} and permutation indices; "
          f"Moran/Geary scores within {SUM_TOL} * sum |terms| (largest |diff| / sum |terms| {worst:.3e}), "
          f"p-values rtol 1e-3 ({time.perf_counter() - t0:.1f} s)", flush=True)


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

    phases: dict[str, float] = {}
    t_phase = time.perf_counter()
    _cuda.reset_launches()
    adata, interval, launches_a, secs = main_path(N_CELLS)
    print(f"[main path a] n={N_CELLS} " + " ".join(f"{k}={v:.4f}" for k, v in secs.items()), flush=True)
    print(f"[launches a] {launches_a}", flush=True)
    missing = [k for k in ("binned_pairs", "pair_counts", "index_cipher") if launches_a[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path's first part: {missing}")
    phases["main_path_a"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    results, launches_b, secs_b = autocorr_path(adata)
    print(f"[main path b] n={N_CELLS} genes={N_GENES} perms={AUTOCORR_PERMS} pallas_n={PALLAS_CELLS} "
          + " ".join(f"{k}={v:.4f}" for k, v in secs_b.items()), flush=True)
    print(f"[launches b] {launches_b}", flush=True)
    missing = [k for k in ("dense_pairs", "ell_autocorr", "perm_autocorr", "index_cipher") if launches_b[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path's second part: {missing}")
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    phases["main_path_b"] = time.perf_counter() - t_phase

    # the main path's own inputs first (their times go into the JSON line),
    # then the fixed shapes and the branches the main path does not take
    t_phase = time.perf_counter()
    checks = main_path_kernel_checks(adata, interval)
    checks.update(autocorr_kernel_checks(adata, results))
    del adata, results
    phases["kernels_main_path_inputs"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    checks["index_cipher"].append(random_index_cipher(N_CELLS, 64, N_CLS))
    checks["pair_counts"] += [random_pair_counts(N_CELLS, N_NEIGHS, 8, 64, N_CLS),
                              random_pair_counts(N_CELLS, N_NEIGHS, 8, 16, 200)]
    checks["binned_pairs"] += [random_binned_pairs(200_000, 2, N_CLS), random_binned_pairs(100_000, 3, N_CLS),
                               random_binned_pairs(20_000, 2, 96)]
    for name, extra in branch_checks().items():
        checks[name] += extra
    phases["kernels_other_shapes"] = time.perf_counter() - t_phase

    # card against CPU through the public API: small (brute-force kNN, sort
    # shuffles, dense sweep, K2), and at 100k (cipher shuffles, binned sweep)
    t_phase = time.perf_counter()
    reference_check(3000, 20)
    reference_check(100_000, np.linspace(0.0, 5.0 * secs["mean_knn_distance"], 9))
    phases["card_vs_cpu"] = time.perf_counter() - t_phase
    print("[phases] " + " ".join(f"{k}={v:.1f}s" for k, v in phases.items()), flush=True)

    kernels = []
    for name, (source, replaces) in _cuda.KERNELS.items():
        first = checks[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(c["max_abs_err"] for c in checks[name]),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
