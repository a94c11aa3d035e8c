#!/usr/bin/env python3
"""Run the squidpy_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no error is caught and passed over):

1. device: require a CUDA card, print its name and power limit, TF32 off;
2. build: compile the CUDA kernels from ``squidpy_torch/csrc`` (timed);
3. the main path through the public API at Xenium scale, in three parts,
   each with the launch counters reset before it and read after it, and
   every kernel of the part required to have run:
   a. 1M cells, k=6, 16 clusters: ``spatial_neighbors_knn`` ->
      ``nhood_enrichment`` (1000 permutations, a warm-up seed then a timed
      one) -> ``co_occurrence`` over a short-range interval (K4, K3, K1);
   b. on the same graph, 512 genes of Poisson counts: ``spatial_autocorr``
      Moran without permutations, Moran with 100, Geary with 100 (K5a,
      K5b, K4 positions); then ``co_occurrence(use_pallas=True)`` on 200k
      cells with the default interval=50 (K2);
   c. on the same cells and genes: ``spatial_neighbors_radius`` (r = 25,
      ~19.6 neighbours a cell: K6) -> ``nhood_enrichment`` (1000
      permutations, k_max 48) -> ``spatial_autocorr`` Moran with 100
      permutations (K5a on each of the graph's degree buckets, K4
      positions, K5b); then ``spatial_neighbors_delaunay`` (host qhull) ->
      ``nhood_enrichment`` (K4, K3);
   d. on the same 1M cells, 16 cell types drawn from a seed, the largest
      holding 20% (200k cells, so its L curve takes the binned sweep) and
      the others ~53k each: ``ripley`` L (K7 on the dense clusters and the
      envelope, K1 with one class on the largest), G and F (K8; the
      envelope in one launch), each at its defaults (100 simulations of
      1000 points, 50 steps, 2 neighbours) under the CPU profiler, whose
      ``[host]`` line splits the call (hull, observed curves, point-process
      sampling, envelope, its ECDF rows, p-values); ``interaction_matrix``
      on part a's kNN graph (counts: K3; weighted; normalised) and
      ``centrality_scores`` (all three, with its ``[host]`` split; host
      scipy, on the ~100k cells of a corner of the section and their kNN
      edges, since its closeness sweep took ~17 s at 1M cells on the
      8-core host of one H100); each
      call's launches are read and the kernels it must run required;
   then checks of what the calls returned (part c: the radius graph's
   density, symmetry and largest distance, the Delaunay graph's density,
   at least two degree buckets on each and a K5a launch on each radius
   bucket, edge totals of the counts), one more Moran call under the
   profiler, whose ``[host]`` line splits the call's host time by step, and
   one more ``spatial_neighbors_radius`` call, whose ``[host]`` line splits
   it into the search, the copy to the host, CSR assembly (K6 writes the
   diagonal, so no host insertion) and the postprocessors, beside K6's
   device steps (grid, count, scan, fill, row order), its host syncs and
   ``from_csr`` of the graph; and the diagonal insertion of the kNN and
   Delaunay builds at 1M cells (``_finalize_pair``'s profiler range,
   scipy's ``setdiag``), with whether each build's CSR is canonical;
4. each kernel against its plain torch version on the card, with both
   times, the least time the card could take (``bound_ms``) and, where one
   PyTorch call computes the same function, its time: first on the main
   path's own inputs (K5a over the ELL rows in the Morton order
   ``spatial_autocorr`` walks them in, with ``torch.sparse.mm`` as the
   yardstick of ``u = W z``, and its ``[diag]`` line: ``u = W z`` with the
   identity walk, the Morton walk and the graph relabelled into Morton
   order, the walk's own cost and the launch's layout; K5b on the bf16
   operands ``spatial_autocorr`` gives it at 1M cells, then its Moran time
   with the positions shrunk to the identity, a quarter and an eighth of the
   rows; K1's line with its
   distinct tile pairs and the pairs its culling keeps, then on the same
   points and thresholds with 40 classes, where its shared histogram holds
   only the top rows of a window; K3's ``[diag]`` line: its time with the
   adds replaced by a register sum and with every label 0, its branch and
   launch shape), then at fixed shapes and in the branches the main path
   does not take (K3's shared branch with 40 classes and global atomics
   with 200, K3's packed branch where a block's 16-bit counters reach their
   limit, K4 at a cycle-walking n, K1 with 96 classes
   (a few shared rows) and 200 (global atomics only), K1 in 3D, K5a on a
   skewed graph's degree buckets, each walked in Morton order, and K5b's
   float32 operands on that 200k-cell graph, K2 with 128 classes, in 3D, with 31 classes (the
   histogram shared only beside the smaller tile), with coincident points,
   labels outside [0, C), equal and zero thresholds and thresholds on pairs'
   d2, and its ``[diag]`` line: the main path's time with no pair counted;
   on part c's graphs, K3 on the radius and Delaunay ELL layouts (the first
   permutation chunk and the observed labels) and K5a over each degree
   bucket of the radius graph in its Morton walk, with ``torch.sparse.mm``
   of the bucket's CSR rows as the yardstick; K6 on part c's own input,
   all 1M cells at r = 25, with and without the diagonal, with its
   ``[diag]`` lines (pairs, candidates, cell side, cells, each device step,
   host syncs, rows per row-order tier), then on the ~200k cells of a
   corner fifth of the section (also with the order tiers lowered), in 3D,
   4D, with coincident points at r = 25 and r = 0, r above the extent (the
   block tier, and the global merge with lowered limits), a cluster of
   20,000 coincident points (the global merge at the natural limits), NaN
   and inf rows (also at an infinite radius), and a radius that enlarges
   the grid's side); on part d's own inputs, K8 on one G-mode cluster
   (its ~947k queries cut to 50,000, with ``torch.cdist`` + ``torch.topk``
   as the yardstick, then all of them), on the F envelope (100 clouds of
   1000 points, 1000 queries) and on the G envelope (the same clouds, all
   1M cells as queries); K7 on one dense cluster and on
   the L envelope (and, in the branches part d does not take, K7 in 3D and
   5D and with one, no, and no staged shared histogram; K8 with ties, in
   1D, 3D and 4D, and above its register list); K1's one-class call on the
   largest cluster's plan (a
   ``[diag]`` line with its planner's host time, items and tile pairs; the
   plain version not warmed), and that cluster's L counts by the dense K7
   against the binned K1, which must be equal.
   Integer kernels
   (K1-K4, K7), K6's CSR (offsets, columns and distances), K8's indices
   and distances and K5a's ``u = W x`` must agree bitwise; the float sums of K5a's
   Moran/Geary numerators and of K5b to ``1e-5 * sum |terms|`` per output
   (they sum in another order, and a Moran numerator is near 0, so a
   relative tolerance would mean nothing);
5. the same public calls on the card and on the CPU (plain torch) must
   agree, at 3000 cells (brute-force kNN, sort shuffles, dense sweep, K2)
   and at 100k cells (cipher shuffles, binned sweep): counts, z-scores and
   co-occurrence bitwise, permutation indices bitwise, autocorrelation
   scores to the bound above and p-values to rtol 1e-3; and on the card
   ``spatial_autocorr`` with and without ``obsm['spatial']`` (the Morton walk
   or the identity): with permutations every column bitwise, Moran without
   to the bound above; and at 3000 cells the graph builders (radius, its
   (10, 25) interval through the ``spatial_neighbors`` facade, with
   ``library_key`` and two threads, Delaunay, the grid with two rings and the
   facade's grid mode on a hexagonal lattice) give bitwise ``obsp`` and
   ``uns``, and nhood and autocorrelation on the radius graph agree as
   above; and at 3000 cells ``ripley`` L, G and F (tables and p-values),
   ``interaction_matrix`` (counts and normalised rows bitwise, weighted
   sums to rtol 1e-12) and ``centrality_scores`` (bitwise).

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
K1_MANY_CLS = 40  # a fine Xenium/MERFISH annotation: K1's shared histogram holds only part of a window
RADIUS = 25.0  # ~2.5 cell spacings: pi * 25^2 / 100 ~ 19.6 neighbours, a contact-plus-next-ring niche
K6_CELLS = 200_000  # K6 against its plain version (4e10 pair tests) on a corner of the main path's cells
K6_BRANCH_CELLS = 100_000  # K6's branches; the plain version tests n^2 pairs
K6_CLUSTER = 20_000  # coincident points whose rows pass K6's block tier (16,384 entries): the global merge
K6_LOW_TIERS = (8, 16)  # K6's row-order tiers lowered: rows of ~20 through the block tier and the global merge
K6_STEPS = ("grid_ms", "count_ms", "scan_ms", "fill_ms", "order_ms")  # K6's device steps, as its stats name them
RIPLEY_CLS = 16  # part d's cell types
RIPLEY_BIG_SHARE = 0.2  # the largest type's share: 200k cells, so its L curve takes the binned sweep (K1)
RIPLEY_SIMS, RIPLEY_OBS, RIPLEY_STEPS, RIPLEY_NEIGH = 100, 1000, 50, 2  # `ripley`'s defaults
K8_LIBRARY_QUERIES = 50_000  # K8 beside torch.cdist + torch.topk: the queries cut to fit the (m, n) distances
CENTRALITY_CELLS = 100_000  # centrality_scores' host closeness sweep runs on a corner of this many cells

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
    """K4 labels and positions for fresh keys; ``n`` may cycle-walk (a * b > n)."""
    import torch

    from squidpy_torch._core.index_cipher import _cipher_plain, _radices, _round_keys, cipher_columns
    from squidpy_torch._core.rng import spawn_keys

    a, b = _radices(n)
    print(f"[branch] index_cipher n={n}: radices {a} x {b}, {'cycle-walks' if a * b > n else 'no cycle walk'}",
          flush=True)
    rng = np.random.default_rng(1)
    counts = np.bincount(rng.integers(0, n_cls, n), minlength=n_cls)
    edges = torch.from_numpy(np.cumsum(counts)[:-1].astype(np.int32)).cuda()
    rk = _round_keys(spawn_keys(0, n_cols), 8)
    res = check_index_cipher("random", rk, n, edges)
    pos = cipher_columns(rk, n, None, torch.int32)
    if not torch.equal(pos, _cipher_plain(rk, n, None, torch.int32)):
        raise AssertionError("index_cipher positions differ from the plain version")
    return res


def check_pair_counts(name: str, idx, mask, src, table, n_cls: int, branch: str | None = None) -> dict:
    """K3 ``(P, C, C)`` counts of label columns over a padded-ELL graph,
    against the plain version; given ``branch``, the launch must take it."""
    from squidpy_torch.ops.nhood import _pair_counts_plain, pair_counts_cols

    n, k_max = idx.shape
    n_cols = src.shape[1]
    stats: dict = {}
    pair_counts_cols(idx, mask, src, table, n_cls, stats=stats)
    if branch is not None and stats["branch"] != branch:
        raise AssertionError(f"pair_counts {name}: the launch took the {stats['branch']} branch, not {branch}")
    edges = int(mask.sum())
    # ELL indices and mask once, the label columns once (source and table are
    # one tensor here), the (P, C, C) int32 output once; per stored edge and
    # column: the label pair's bin and one add
    nbytes = idx.numel() * 4 + mask.numel() + src.numel() * src.element_size() + n_cols * n_cls * n_cls * 4
    bound = _bound(nbytes, 3.0 * edges * n_cols)
    res = _compare(
        f"pair_counts {name} n={n} k_max={k_max} P={n_cols} C={n_cls} {src.dtype} branch={stats['branch']} "
        f"cols_per_block={stats['cols_per_block']} rows_per_block={stats['rows_per_block']} blocks={stats['blocks']}",
        lambda: pair_counts_cols(idx, mask, src, table, n_cls),
        lambda: _pair_counts_plain(idx, mask, src, table, n_cls),
        repeats=5, bound=bound,
    )
    return {**res, "layout": stats}


def pair_counts_split(idx, mask, cols, n_cls: int) -> None:
    """K3's time on the main path's chunk as it is, with the histogram adds
    replaced by a register sum (the gathers and the loop alone), and with
    every label 0 (every add of a column on one counter), beside its launch
    shape (a diagnostic; the register-sum output is not counts)."""
    import torch

    from squidpy_torch.ops.nhood import _K3_PACKED_RESIDENT, _launch_k3, k3_packed_resident, pair_counts_cols

    resident = k3_packed_resident(cols.dtype)
    if resident != _K3_PACKED_RESIDENT:
        raise AssertionError(f"{resident} packed K3 blocks fit an SM; the layout assumes {_K3_PACKED_RESIDENT}")
    stats: dict = {}
    pair_counts_cols(idx, mask, cols, cols, n_cls, stats=stats)
    zeros = torch.zeros_like(cols)
    times = [f"{name}={_time_ms(fn, 5)[1]:.3f}ms" for name, fn in (
        ("counted", lambda: pair_counts_cols(idx, mask, cols, cols, n_cls)),
        ("register_sum", lambda: _launch_k3(idx, mask, cols, cols, n_cls, count=False)),
        ("all_labels_0", lambda: pair_counts_cols(idx, mask, zeros, zeros, n_cls)),
    )]
    print(f"[diag] pair_counts n={idx.shape[0]} k_max={idx.shape[1]} P={cols.shape[1]} C={n_cls} "
          f"branch={stats['branch']} cols_per_block={stats['cols_per_block']} rows_per_block={stats['rows_per_block']} "
          f"blocks={stats['blocks']} resident_per_sm={resident}: {' '.join(times)}", flush=True)


def overflow_pair_counts() -> dict:
    """K3's packed branch where one block's bin (0, 0) reaches its 16-bit
    limit: every label 0 and every slot set, ``65,535 // k_max`` rows a
    block, so each block holds 65,472 counts a column and each column's
    total passes 65,535 only in the int32 output."""
    import torch

    k = 64
    n = 3 * torch.cuda.get_device_properties(0).multi_processor_count * (65_535 // k)
    g = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.randint(0, n, (n, k), generator=g, device="cuda", dtype=torch.int32)
    mask = torch.ones((n, k), dtype=torch.bool, device="cuda")
    cols = torch.zeros((n, 32), dtype=torch.uint8, device="cuda")
    res = check_pair_counts("overflow, all labels 0", idx, mask, cols, cols, N_CLS, branch="packed")
    rows = res["layout"]["rows_per_block"]
    if rows * k <= 65_535 - k:
        raise AssertionError(f"the overflow shape's blocks hold {rows} rows, short of the 16-bit limit")
    return res


def random_pair_counts(n: int, k: int, k_max: int, n_cols: int, n_cls: int, branch: str) -> dict:
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)
    idx = torch.randint(0, n, (n, k_max), generator=g, device="cuda", dtype=torch.int32)
    mask = torch.zeros((n, k_max), dtype=torch.bool, device="cuda")
    mask[:, :k] = True
    cols = torch.randint(0, n_cls, (n, n_cols), generator=g, device="cuda", dtype=torch.uint8)
    return check_pair_counts(f"random k={k}", idx, mask, cols, cols, n_cls, branch=branch)


def _k1_work(coords_p, n: int, seg, thr, tile: int) -> dict:
    """What K1 does on a plan: its segments (distinct tile pairs), their
    candidate pairs i < j of real points, the 32 x 32 chunk pairs its
    culling keeps (the plain predicate; chunk a <= b on a diagonal tile) and
    the candidate pairs inside them."""
    import torch

    from squidpy_torch.ops.binned_kernel import chunk_pairs_kept

    m = -(-tile // 32)
    ti, tj = seg[0].long(), seg[1].long()
    diag = ti == tj
    rows = (n - ti * tile).clamp(0, tile)
    cols = (n - tj * tile).clamp(0, tile)
    pairs = torch.where(diag, rows * (rows - 1) // 2, rows * cols)
    kept = chunk_pairs_kept(coords_p, n, seg, thr, tile)
    start = torch.arange(m, device=seg.device) * 32
    size_i = (rows[:, None] - start).clamp(0, 32)  # real points of each chunk
    size_j = (cols[:, None] - start).clamp(0, 32)
    chunk_pairs = size_i[:, :, None] * size_j[:, None, :]
    same = torch.eye(m, dtype=torch.bool, device=seg.device)
    chunk_pairs = torch.where(diag[:, None, None] & same, size_i[:, :, None] * (size_i[:, :, None] - 1) // 2,
                              chunk_pairs)
    upper = torch.triu(torch.ones(m, m, dtype=torch.bool, device=seg.device))
    kept = kept & (~diag[:, None, None] | upper)
    return {"segments": int(seg.shape[1]), "pairs": int(pairs.sum()), "chunk_pairs_kept": int(kept.sum()),
            "chunk_pairs": int((~diag).sum()) * m * m + int(diag.sum()) * m * (m + 1) // 2,
            "pairs_kept": int(chunk_pairs[kept].sum())}


def check_binned_pairs(name: str, pts: np.ndarray, labs: np.ndarray, thr: np.ndarray, n_cls: int,
                       plain_warm: bool = True) -> dict:
    """K1 boundary counts of the plan ``co_occurrence`` makes for these points
    and squared thresholds, against the plain version."""
    import torch

    from squidpy_torch.ops.binned_kernel import _binned_plain, _k1_layout, binned_inputs, binned_pairs, segments
    from squidpy_torch.ops.pairbins import sorted_plan

    coords_s, labels_s, plan = sorted_plan(pts, labs, thr, n_cls)
    coords_p, labels_p, items, thr_t, n_thr = binned_inputs(coords_s, labels_s, plan, torch.device("cuda"))
    args = (coords_p, labels_p, plan.n, items, thr_t, n_thr, plan.tile, plan.gsize, n_cls)
    dim = pts.shape[1]
    hist_rows = _k1_layout(plan.tile, dim, n_thr, n_cls)[1]
    seg = segments(items, n_thr, plan.gsize)
    work = _k1_work(coords_p, plan.n, seg, thr_t, plan.tile)
    # what this run's data needs: every candidate pair inside the chunk pairs
    # the exact culling keeps, once (the (3d - 1) flops of the difference-form
    # d2 and one compare with the window's last threshold), and one box test
    # per chunk pair (per dimension two differences, two maxima, a multiply
    # and an add; then the margin's multiply and subtract and the compare);
    # the inputs, the segments and the (L, C, C) int64 output once
    ops = work["pairs_kept"] * (3 * dim - 1 + 1) + work["chunk_pairs"] * (6 * dim + 3)
    nbytes = plan.n * (dim + 1) * 4 + seg.numel() * 4 + n_thr * 4 + n_thr * n_cls * n_cls * 8
    res = _compare(
        f"binned_pairs {name} n={plan.n} d={dim} C={n_cls} L={n_thr} tile={plan.tile} items={plan.n_items} "
        f"tile_pairs={work['segments']} candidate_pairs={work['pairs']} chunk_pairs_kept={work['chunk_pairs_kept']}"
        f"/{work['chunk_pairs']} pairs_kept={work['pairs_kept']} hist_rows={hist_rows}",
        lambda: binned_pairs(*args),
        lambda: _binned_plain(*args),
        repeats=3, bound=_bound(nbytes, ops),
        plain_warm=plain_warm,
    )
    return {**res, "tile_pairs": work["segments"], "pairs_kept": work["pairs_kept"]}


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


def _normalized_graph(adata: StandIn, key: str = "spatial_connectivities"):
    """The row-normalised CSR and its float32 ELL graph on the card, as
    ``spatial_autocorr(transformation=True)`` builds them."""
    from scipy import sparse as sp

    from squidpy_torch._core.graph import SpatialGraph

    g = sp.csr_matrix(adata.obsp[key], dtype=np.float64)
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


def check_ell_autocorr(name: str, idx, w, x, z, rows=None, library=None, walk=None) -> list[dict]:
    """K5a in its three modes (over a bucket's ``rows``, or the whole graph
    in the order ``walk``) against the plain version: ``u = W z`` bitwise,
    the Moran numerator of ``z`` and the Geary numerator of ``x`` to
    ``SUM_TOL * sum |terms|``."""
    import torch

    from squidpy_torch.ops.autocorr import _ell_plain, ell_autocorr

    n_b, k = idx.shape
    n, g = x.shape
    tag = f"ell_autocorr {name} n={n} rows={n_b} k={k} g={g}"
    order = rows if rows is not None else walk
    ell_bytes = idx.numel() * 4 + w.numel() * 4 + (order.numel() * 4 if order is not None else 0)
    out = []
    for mode, y, flops in (("spmv", z, 2), ("moran", z, 3), ("geary", x, 4)):
        # the gene block and the ELL arrays read once; u (the bucket's rows)
        # or the (g,) numerator written once
        nbytes = n * g * 4 + ell_bytes + (n_b * g * 4 if mode == "spmv" else g * 4)
        terms = None
        if mode == "moran":
            terms = _ell_plain("moran", idx, w.abs(), z.abs(), rows, walk)
        elif mode == "geary":
            terms = _ell_plain("geary", idx, w.abs(), x, rows, walk)
        def plain(mode=mode, y=y):
            res = _ell_plain(mode, idx, w, y, rows, walk)
            if mode == "spmv" and order is not None:  # the rows of an (n, g) u, in their order
                return torch.zeros_like(y).index_copy_(0, order.long(), res)
            return res

        out.append(_compare(
            f"{tag} mode={mode}",
            lambda mode=mode, y=y: ell_autocorr(mode, idx, w, y, rows, walk=walk),
            plain,
            repeats=5, bound=_bound(nbytes, flops * n_b * k * g), terms=terms,
            library=library if mode == "spmv" else None,
        ))
    return out


def ell_walk_split(adata: StandIn, graph, walk, z) -> None:
    """K5a's ``u = W z`` on the main path's block with the rows in their
    given order (the identity), in the Morton order ``spatial_autocorr``
    walks them in, and with the graph and ``z`` relabelled into that order
    (the floor a walk can reach), each checked bitwise against the others;
    the walk's own cost, built (coordinates to the card, codes, sort) and as
    later calls find it cached on the AnnData; and the launch's layout (a
    diagnostic)."""
    import torch

    from squidpy_torch._core.graph import _morton_walk, locality_walk
    from squidpy_torch._device import get_device
    from squidpy_torch.ops.autocorr import ell_autocorr, k5a_layout

    n = z.shape[0]
    build_ms, cached_ms = [], []
    for _ in range(3):
        built, t = _sync_time(lambda: _morton_walk(adata, n, get_device()))
        build_ms.append(1e3 * t)
        cached, t = _sync_time(lambda: locality_walk(adata, n, get_device()))
        cached_ms.append(1e3 * t)
    if cached is not walk or not torch.equal(built, walk):
        raise AssertionError("the Morton walk is not the one spatial_autocorr cached, or differs when built again")
    order = walk.long()
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    relabelled = (rank[graph.indices[order].long()].to(torch.int32), graph.weights[order], z[order])
    cases = (("identity", (graph.indices, graph.weights, z), None), ("morton", (graph.indices, graph.weights, z), walk),
             ("relabelled", relabelled, None))
    times, results = [], {}
    for name, args, w in cases:
        results[name], t = _time_ms(lambda args=args, w=w: ell_autocorr("spmv", *args, walk=w), 5)
        times.append(f"{name}={t:.3f}ms")
    if not (torch.equal(results["identity"], results["morton"])
            and torch.equal(results["identity"][order], results["relabelled"])):
        raise AssertionError("u = W z differs between the identity walk, the Morton walk and the relabelled graph")
    lay = k5a_layout("spmv", n, z)
    print(f"[diag] ell_autocorr spmv n={n} g={z.shape[1]} k={graph.indices.shape[1]}: {' '.join(times)} "
          f"walk_build_ms={min(build_ms):.3f} walk_cached_ms={min(cached_ms):.4f} (best of 3; built "
          f"{[round(t, 3) for t in build_ms]}) aligned={lay.aligned} slices={lay.slices} "
          f"rows_per_item={lay.rows_per_item} stretch_rows={lay.stretch_rows} blocks={lay.blocks} "
          f"resident_per_sm={lay.resident_per_sm} registers={lay.registers}", flush=True)


def host_split(adata: StandIn) -> None:
    """One more ``spatial_autocorr`` Moran call (no permutations) under the
    profiler: the host time of each of its named steps (a diagnostic)."""
    from torch.profiler import ProfilerActivity, profile

    import squidpy_torch as sqt

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, wall = _sync_time(lambda: sqt.gr.spatial_autocorr(adata, mode="moran", copy=True))
    steps = {e.key.split(".", 1)[1]: e.cpu_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("spatial_autocorr.")}
    if not steps:
        raise AssertionError("the profile holds none of spatial_autocorr's ranges")
    print(f"[host] spatial_autocorr moran n={adata.obsm['spatial'].shape[0]} genes={len(adata.var_names)}: "
          f"wall={1e3 * wall:.1f}ms " + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()), flush=True)


def check_perm_autocorr(name: str, z, u, r, perms) -> list[dict]:
    """K5b for Moran and Geary against the plain version, to
    ``SUM_TOL * sum |terms|`` (for Geary the bound |z| (|z| r + 2 |u|)), in
    the operands' dtype (bf16 at n >= 2^19, float32 below)."""
    from squidpy_torch.ops.autocorr import _perm_plain, perm_autocorr

    n, g = z.shape
    n_perms = perms.shape[0]
    elem = z.element_size()
    out = []
    for mode, rr, flops in (("moran", None, 2), ("geary", r, 5)):
        u_abs = -u.abs() if mode == "geary" else u.abs()
        terms = _perm_plain(mode, z.abs(), u_abs, rr, perms)
        # z, u (and r) in their own dtype and the positions once, the
        # float32 (P, g) numerators once
        nbytes = 2 * n * g * elem + n_perms * n * 4 + (n * elem if rr is not None else 0) + n_perms * g * 4
        out.append(_compare(
            f"perm_autocorr {name} mode={mode} n={n} g={g} P={n_perms} {str(z.dtype).replace('torch.', '')}",
            lambda mode=mode, rr=rr: perm_autocorr(mode, z, u, perms, rr),
            lambda mode=mode, rr=rr: _perm_plain(mode, z, u, rr, perms),
            repeats=3, bound=_bound(nbytes, flops * n_perms * n * g), terms=terms,
        ))
    return out


def perm_working_set(z, u, perms) -> None:
    """K5b Moran's time with the positions replaced by the identity and
    folded into a quarter and an eighth of the rows: the gathered working set
    of a gene tile shrinks while the rest of the work stays (a diagnostic;
    the results are not checked)."""
    import torch

    from squidpy_torch.ops.autocorr import perm_autocorr

    n = z.shape[0]
    identity = torch.arange(n, dtype=torch.int32, device=z.device).expand(perms.shape[0], n)
    times = []
    for name, pos in (("all", perms), ("identity", identity), ("quarter", perms % (n // 4)),
                      ("eighth", perms % (n // 8))):
        times.append(f"{name}={_time_ms(lambda pos=pos: perm_autocorr('moran', z, u, pos), 3)[1]:.3f}ms")
    print(f"[diag] perm_autocorr moran n={n} g={z.shape[1]} P={perms.shape[0]} {str(z.dtype)[6:]} "
          f"by positions: {' '.join(times)}", flush=True)


def _dense_args(pts: np.ndarray, labs: np.ndarray, thr: np.ndarray, n_cls: int) -> tuple:
    import torch

    return (torch.from_numpy(np.ascontiguousarray(pts, np.float32)).cuda(),
            torch.from_numpy(np.asarray(labs, np.int32)).cuda(),
            torch.from_numpy(np.sort(thr).astype(np.float32)).cuda(), n_cls)


def check_dense_pairs(name: str, pts: np.ndarray, labs: np.ndarray, thr: np.ndarray, n_cls: int,
                      plain_warm: bool = True, repeats: int = 3, reg: int | None = None) -> dict:
    """K2 counts against the plain version, bitwise; given ``reg``, the
    launch must keep that many column points a thread."""
    from squidpy_torch.ops.dense_pairs import _dense_plain, dense_pairs

    n, dim = pts.shape
    args = _dense_args(pts, labs, thr, n_cls)
    stats: dict = {}
    dense_pairs(*args, stats=stats)
    if reg is not None and stats["reg"] != reg:
        raise AssertionError(f"dense_pairs {name}: the launch kept {stats['reg']} column points a thread, not {reg}")
    return _compare(f"dense_pairs {name} n={n} d={dim} C={n_cls} L={len(thr)} tile={stats['tile']} "
                    f"reg={stats['reg']} blocks={stats['launched_blocks']} shared_hist={stats['shared']}",
                    lambda: dense_pairs(*args), lambda: _dense_plain(*args), repeats=repeats,
                    bound=_dense_pairs_bound(n, dim, len(thr), n_cls), plain_warm=plain_warm)


def dense_pairs_split(pts: np.ndarray, labs: np.ndarray, thr: np.ndarray, n_cls: int) -> None:
    """K2's time with the thresholds and with one threshold below every
    pair's d2 (no pair is counted: the pair loop without the histogram),
    with its launch shape, tile pairs per block and histogram flushes (a
    diagnostic; the second result is checked to be all zero)."""
    from squidpy_torch.ops.dense_pairs import dense_pairs

    times, runs = [], []
    for name, t in (("thresholds", thr), ("none_counted", np.array([-1e30], np.float32))):
        args = _dense_args(pts, labs, t, n_cls)
        runs.append({})
        out = dense_pairs(*args, stats=runs[-1])
        if name == "none_counted" and bool(out.any()):
            raise AssertionError("dense_pairs counted a pair below a threshold under every d2")
        times.append(f"{name}(L={len(t)})={_time_ms(lambda args=args: dense_pairs(*args), 5)[1]:.3f}ms")
    stats = runs[0]  # the launch with the thresholds
    print(f"[diag] dense_pairs n={len(pts)} C={n_cls} tile={stats['tile']} reg={stats['reg']} "
          f"blocks={stats['launched_blocks']} (asked {stats['blocks']}) tile_pairs={stats['tile_pairs']} "
          f"tile_pairs_per_block={stats['tile_pairs'] / stats['launched_blocks']:.1f} "
          f"most_tile_pairs_one_block={stats['most_tile_pairs']} flush_every={stats['flush_every']} "
          f"flushes={stats['flushes']}: {' '.join(times)}", flush=True)


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

    from squidpy_torch._constants._constants import BF16_GATHER_MIN_N
    from squidpy_torch._core.graph import locality_walk
    from squidpy_torch._core.index_cipher import cipher_index_batch
    from squidpy_torch._core.rng import spawn_keys
    from squidpy_torch._device import get_device
    from squidpy_torch.ops.autocorr import ell_autocorr

    n = adata.obsm["spatial"].shape[0]
    handle = adata.uns["__squidpy_torch_device_x__None_False"]["handle"]
    xb = handle.dense_block(np.arange(N_GENES))
    zb = xb - torch.mean(xb, dim=0, keepdim=True)
    g_csr, graph = _normalized_graph(adata)
    w_sparse = torch.sparse_csr_tensor(
        torch.from_numpy(g_csr.indptr.astype(np.int64)), torch.from_numpy(g_csr.indices.astype(np.int64)),
        torch.from_numpy(g_csr.data.astype(np.float32)), size=g_csr.shape, check_invariants=False).cuda()
    # the ELL rows in the Morton order spatial_autocorr walked them in (its cached walk)
    walk = locality_walk(adata, n, get_device())
    if walk is None:
        raise AssertionError("spatial_autocorr builds no walk for the main path's coordinates")
    k5a = check_ell_autocorr("main path, first block, Morton walk", graph.indices, graph.weights, xb, zb,
                             library=lambda: torch.sparse.mm(w_sparse, zb), walk=walk)
    del xb, w_sparse
    ell_walk_split(adata, graph, walk, zb)
    ub = ell_autocorr("spmv", graph.indices, graph.weights, zb, walk=walk)
    perms = cipher_index_batch(spawn_keys(0, AUTOCORR_PERMS), n)
    r = torch.from_numpy(np.asarray(g_csr.sum(axis=1), np.float32).ravel()).cuda()
    # the null's operands as spatial_autocorr hands them to K5b at this size
    dt = torch.bfloat16 if n >= BF16_GATHER_MIN_N else torch.float32
    zg, ug = zb.to(dt), ub.to(dt)
    del zb, ub
    k5b = check_perm_autocorr("main path, first block", zg, ug, r.to(dt), perms)
    perm_working_set(zg, ug, perms)
    del zg, ug, perms

    small = results["pallas_dataset"]
    pts = np.asarray(small.obsm["spatial"], np.float32)
    thr = _squared_thresholds(results["pallas_interval"])
    codes = np.asarray(small.obs["cluster"].cat.codes, np.int32)
    k2 = [check_dense_pairs("main path", pts, codes, thr, N_CLS, plain_warm=False, repeats=10)]
    dense_pairs_split(pts, codes, thr, N_CLS)
    sub = np.random.default_rng(0).choice(len(pts), K2_SUBSET_CELLS, replace=False)
    k2.append(check_dense_pairs(f"main path thresholds, {K2_SUBSET_CELLS} of the {len(pts)} cells", pts[sub],
                                codes[sub], thr, N_CLS))
    return {"ell_autocorr": k5a, "perm_autocorr": k5b, "dense_pairs": k2}


def new_graph_kernel_checks(adata: StandIn) -> dict[str, list[dict]]:
    """K3 and K5a against their plain versions on the graphs part c gave
    them: K3 on the radius graph's and the Delaunay graph's ELL layouts
    with the first 500-permutation chunk of ``nhood_enrichment(seed=0)``
    (packed branch) and the observed labels (shared branch); K5a in its
    three modes on the first 512-gene block over each degree bucket of the
    normalised radius graph, its rows in the Morton walk ``spatial_autocorr``
    took, with ``torch.sparse.mm`` of the bucket's rows of the CSR W as the
    yardstick of ``u = W z``."""
    import torch

    from squidpy_torch._core.graph import locality_walk, walk_buckets
    from squidpy_torch._core.index_cipher import DEFAULT_ROUNDS, _round_keys, cipher_columns
    from squidpy_torch._core.rng import spawn_keys
    from squidpy_torch._device import get_device
    from squidpy_torch.gr._nhood import _PERM_CHUNK

    codes = np.asarray(adata.obs["cluster"].cat.codes, dtype=np.int32)
    n = codes.shape[0]
    rk = _round_keys(spawn_keys(0, N_PERMS)[:_PERM_CHUNK], DEFAULT_ROUNDS)
    edges = torch.from_numpy(np.cumsum(np.bincount(codes, minlength=N_CLS))[:-1].astype(np.int32)).cuda()
    cols = cipher_columns(rk, n, edges, torch.uint8)
    obs = torch.from_numpy(codes).cuda().reshape(-1, 1)
    k3 = []
    for key in ("radius", "delaunay"):
        graph = adata.uns[f"__squidpy_torch_ell__{key}_connectivities"]["graph"]
        k3.append(check_pair_counts(f"{key} graph, first chunk", graph.indices, graph.mask, cols, cols, N_CLS,
                                    branch="packed"))
        k3.append(check_pair_counts(f"{key} graph, observed", graph.indices, graph.mask, obs, obs, N_CLS,
                                    branch="shared"))
    del cols
    handle = adata.uns["__squidpy_torch_device_x__None_False"]["handle"]
    xb = handle.dense_block(np.arange(N_GENES))
    zb = xb - torch.mean(xb, dim=0, keepdim=True)
    walked = walk_buckets(_degree_buckets(adata, "radius_connectivities"), locality_walk(adata, n, get_device()))
    g_csr = _normalized_graph(adata, "radius_connectivities")[0]
    k5a = []
    for b, (rows, idx, w) in enumerate(walked):
        # the yardstick: torch.sparse.mm of the bucket's rows of the CSR W
        sub = g_csr[rows.cpu().numpy()]
        w_b = torch.sparse_csr_tensor(
            torch.from_numpy(sub.indptr.astype(np.int64)), torch.from_numpy(sub.indices.astype(np.int64)),
            torch.from_numpy(sub.data.astype(np.float32)), size=sub.shape, check_invariants=False).cuda()
        k5a += check_ell_autocorr(f"radius graph, bucket {b}/{len(walked)}, Morton walk", idx, w, xb, zb, rows=rows,
                                  library=lambda w_b=w_b: torch.sparse.mm(w_b, zb))
    return {"pair_counts": k3, "ell_autocorr": k5a}


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
    permutations and Geary, from a sparse X), K2 with 128 classes (the global histogram),
    in 3D and on the edges of its threshold table and tile walk."""
    import torch
    from scipy import sparse as sp

    import squidpy_torch as sqt
    from squidpy_torch._core.graph import locality_walk, walk_buckets
    from squidpy_torch.ops.autocorr import _ell_plain, spmv_genes_bucketed
    from squidpy_torch.ops.dense_pairs import _expanded_d2, _sq_norms

    n = SKEWED_CELLS
    adata = _dataset(n, seed=6)
    adata.obsp["spatial_connectivities"] = skewed_csr(n, seed=6)
    counts = poisson_counts(n, 64, seed=6, low=0.5)
    adata.set_expression(sp.csr_matrix(counts))  # sparse X: blocks are densified on the card
    _, graph = _normalized_graph(adata)
    buckets = graph.degree_buckets()
    if buckets is None or not 2 <= len(buckets) <= 4:
        raise AssertionError(f"the skewed graph gave {None if buckets is None else len(buckets)} degree buckets")
    # each bucket's rows in the Morton order of the cells, as spatial_autocorr walks them
    walked = walk_buckets(buckets, locality_walk(adata, n, sqt.get_device()))
    x = torch.from_numpy(counts.astype(np.float32)).cuda()
    z = x - torch.mean(x, dim=0, keepdim=True)
    k5a = []
    for b, (rows, idx, w) in enumerate(walked):
        k5a += check_ell_autocorr(f"bucket {b}/{len(buckets)}, Morton walk", idx, w, x, z, rows=rows)
    u_plain = torch.zeros_like(z)
    for rows, idx, w in buckets:
        u_plain[rows.long()] = _ell_plain("spmv", idx, w, z, rows)
    if not (torch.equal(spmv_genes_bucketed(walked, z), u_plain) and torch.equal(spmv_genes_bucketed(buckets, z),
                                                                                   u_plain)):
        raise AssertionError("bucketed u = W z (walked or not) differs from the plain version")
    # K5b's float32 operands (below 2^19 cells), over this graph's u = W z
    from squidpy_torch._core.index_cipher import cipher_index_batch
    from squidpy_torch._core.rng import spawn_keys

    u = spmv_genes_bucketed(walked, z)
    r = torch.from_numpy(np.asarray(_normalized_graph(adata)[0].sum(axis=1), np.float32).ravel()).cuda()
    k5b = check_perm_autocorr("skewed graph, float32", z, u, r, cipher_index_batch(spawn_keys(1, AUTOCORR_PERMS), n))
    del u
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
    # 31 classes at 49 thresholds: the histogram fits in shared memory only
    # beside a 512-point tile, so the layout keeps one column point a thread
    n_pts = 100_000
    pts = rng.uniform(0.0, 10.0 * np.sqrt(n_pts), (n_pts, 2)).astype(np.float32)
    k2.append(check_dense_pairs("31 classes, histogram shared only beside tile 512", pts, rng.integers(0, 31, n_pts),
                                _default_thresholds(pts), 31, reg=1))
    # what the threshold table and the tile walk could get wrong, at a size
    # that takes the main path's two column points a thread: n not a
    # multiple of the tile (the last tile holds 673 points, so its second
    # column half is padding), every fourth point on top of another (d2 <= 0
    # by rounding, some below 0), labels outside [0, C), equal and zero
    # thresholds, d2 on a threshold
    n_pts = 100_001
    pts = rng.uniform(0.0, 10.0 * np.sqrt(n_pts), (n_pts, 2)).astype(np.float32)
    pts[1::4] = pts[::4][: len(pts[1::4])]
    labs = rng.integers(-1, N_CLS + 1, n_pts)
    thr = _default_thresholds(pts)
    edge_thr = np.concatenate([[0.0, 0.0], thr[:3], thr[:3], thr[20:30]]).astype(np.float32)
    k2.append(check_dense_pairs("coincident points, labels outside [0, C), equal and zero thresholds", pts, labs,
                                edge_thr, N_CLS, reg=2))
    # thresholds equal to pairs' expanded-form d2, as the kernel rounds it
    p200 = torch.from_numpy(pts[:200])
    d2 = _expanded_d2(p200, p200, _sq_norms(p200), _sq_norms(p200)).numpy()
    k2.append(check_dense_pairs("thresholds on pairs' d2", pts[:2049], labs[:2049],
                                np.unique(d2[d2 > 0])[::97][:40], N_CLS))
    return {"ell_autocorr": k5a, "perm_autocorr": k5b, "dense_pairs": k2}


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
    # the main path's 500-column chunks take the packed branch, its observed
    # labels (P = 1, int32) the shared one
    k3 = check_pair_counts("main path, first chunk", graph.indices, graph.mask, cols, cols, N_CLS, branch="packed")
    pair_counts_split(graph.indices, graph.mask, cols, N_CLS)
    del cols
    obs = torch.from_numpy(codes).cuda().reshape(-1, 1)
    k3_obs = check_pair_counts("main path, observed", graph.indices, graph.mask, obs, obs, N_CLS, branch="shared")
    pts = np.asarray(adata.obsm["spatial"], np.float32)
    k1 = check_binned_pairs("main path, short range", pts, codes, _squared_thresholds(interval), N_CLS,
                            plain_warm=False)
    many = np.random.default_rng(10).integers(0, K1_MANY_CLS, n).astype(np.int32)
    k1_many = check_binned_pairs(f"main path points and thresholds, {K1_MANY_CLS} classes", pts, many,
                                 _squared_thresholds(interval), K1_MANY_CLS, plain_warm=False)
    return {"index_cipher": [k4], "pair_counts": [k3, k3_obs], "binned_pairs": [k1, k1_many]}


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


def walk_invariance(adata: StandIn) -> None:
    """``spatial_autocorr`` on the card with ``obsm['spatial']`` (the Morton
    walk) and without it (the identity): Moran and Geary with 20 permutations
    agree in every column bitwise (``u = W z`` is the same in any row order);
    Moran without permutations, whose fused numerator sums the rows in the
    walk's order, to ``SUM_TOL * sum |terms|``."""
    import squidpy_torch as sqt

    runs = (("moran", 20), ("geary", 20), ("moran", None))
    coords = adata.obsm.pop("spatial")
    try:
        plain = [sqt.gr.spatial_autocorr(adata, mode=m, n_perms=p, seed=0, copy=True) for m, p in runs]
    finally:
        adata.obsm["spatial"] = coords
    walked = [sqt.gr.spatial_autocorr(adata, mode=m, n_perms=p, seed=0, copy=True) for m, p in runs]
    for (mode, n_perms), a, b in zip(runs, walked, plain):
        if n_perms is not None:
            if list(a.index) != list(b.index):
                raise AssertionError(f"spatial_autocorr {mode}: rows differ with and without the walk")
            for col in a.columns:
                np.testing.assert_array_equal(a.columns[col], b.columns[col], err_msg=f"walk changed {mode} {col}")
        else:
            order = {g: i for i, g in enumerate(b.index)}
            diff = np.abs(a.columns["I"] - b.columns["I"][[order[g] for g in a.index]])
            if not np.all(diff <= _autocorr_terms_bound(adata, a, "moran")):
                raise AssertionError(f"Moran's I moved beyond {SUM_TOL} * sum |terms| with the walk")
    print(f"[walk] n={adata.obsm['spatial'].shape[0]}: spatial_autocorr with and without obsm['spatial']: "
          f"Moran/Geary with 20 permutations bitwise in every column, Moran without within {SUM_TOL} * sum |terms|",
          flush=True)


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
            if device == "cuda":
                walk_invariance(adata)
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

def _degree_buckets(adata: StandIn, key: str) -> list:
    """The degree buckets ``spatial_autocorr`` takes on the graph ``key``."""
    buckets = _normalized_graph(adata, key)[1].degree_buckets()
    if buckets is None or len(buckets) < 2:
        raise AssertionError(f"the {key} graph took {0 if buckets is None else len(buckets)} degree buckets, not >= 2")
    return buckets


def _assert_symmetric(adj) -> None:
    """Every stored (i, j) has its (j, i), checked on the card."""
    import torch

    n = adj.shape[0]
    indptr = torch.from_numpy(adj.indptr.astype(np.int64)).cuda()
    cols = torch.from_numpy(adj.indices.astype(np.int64)).cuda()
    rows = torch.repeat_interleave(torch.arange(n, device=cols.device), torch.diff(indptr), output_size=cols.numel())
    if not torch.equal(torch.sort(rows * n + cols).values, torch.sort(cols * n + rows).values):
        raise AssertionError("the radius graph is not symmetric")


def radius_path(adata: StandIn) -> tuple[dict, dict]:
    """The third part of the main path, on the same 1M cells and 512 genes:
    ``spatial_neighbors_radius`` (r = 25, K6) -> ``nhood_enrichment`` (1000
    permutations: K4, K3) -> ``spatial_autocorr`` Moran with 100 permutations
    (K5a on each degree bucket, K4 positions, K5b); then
    ``spatial_neighbors_delaunay`` (host qhull) -> ``nhood_enrichment``. The
    launch counters are reset just before the public calls and read just
    after; then checks of what the calls returned. Returns the launches and
    the seconds."""
    import squidpy_torch as sqt
    from squidpy_torch import _cuda

    n = adata.obsm["spatial"].shape[0]
    _cuda.reset_launches()
    _, t_radius = _sync_time(lambda: sqt.gr.spatial_neighbors_radius(adata, radius=RADIUS, key_added="radius"))
    nh_r, t_nh_r = _sync_time(lambda: sqt.gr.nhood_enrichment(
        adata, "cluster", connectivity_key="radius", n_perms=N_PERMS, seed=0, copy=True))
    moran, t_moran = _sync_time(lambda: sqt.gr.spatial_autocorr(
        adata, connectivity_key="radius_connectivities", mode="moran", n_perms=AUTOCORR_PERMS, seed=0, copy=True))
    _, t_del = _sync_time(lambda: sqt.gr.spatial_neighbors_delaunay(adata, key_added="delaunay"))
    nh_d, t_nh_d = _sync_time(lambda: sqt.gr.nhood_enrichment(
        adata, "cluster", connectivity_key="delaunay", n_perms=N_PERMS, seed=0, copy=True))
    launches = dict(_cuda.launches)

    adj, dst = adata.obsp["radius_connectivities"], adata.obsp["radius_distances"]
    if not 18.0 < adj.nnz / n < 20.0:  # pi r^2 density, less the section's edges
        raise AssertionError(f"the radius graph has {adj.nnz / n:.2f} neighbours a cell, expected ~19.6")
    if float(dst.data.max()) > RADIUS:
        raise AssertionError("the radius graph holds a distance above the radius")
    _assert_symmetric(adj)
    tri = adata.obsp["delaunay_connectivities"]
    if not 5.9 < tri.nnz / n < 6.0:  # 6 - 6 / n on the convex hull's inside
        raise AssertionError(f"the Delaunay graph has {tri.nnz / n:.3f} neighbours a cell, expected just below 6")
    buckets_r, buckets_d = _degree_buckets(adata, "radius_connectivities"), _degree_buckets(adata, "delaunay_connectivities")
    if launches["ell_autocorr"] < len(buckets_r):
        raise AssertionError(f"K5a ran {launches['ell_autocorr']} times over {len(buckets_r)} degree buckets")
    for res, graph in ((nh_r, adj), (nh_d, tri)):
        if res.zscore.shape != (N_CLS, N_CLS) or not np.all(np.isfinite(res.zscore)):
            raise AssertionError("nhood_enrichment on a new graph: wrong shape or a non-finite z-score")
        if int(res.counts.astype(np.int64).sum()) != graph.nnz:
            raise AssertionError("nhood_enrichment on a new graph: the counts do not sum to its edges")
    p_max = (AUTOCORR_PERMS // 2 + 1) / (AUTOCORR_PERMS + 1)
    cols = moran.columns
    if len(moran.index) != N_GENES or not all(np.all(np.isfinite(v)) for v in cols.values()):
        raise AssertionError("spatial_autocorr on the radius graph: missing rows or non-finite columns")
    if not np.all((cols["pval_sim"] > 0) & (cols["pval_sim"] <= p_max)):
        raise AssertionError(f"spatial_autocorr on the radius graph: pval_sim outside (0, {p_max:.4f}]")
    k_max = {key: int(adata.uns[f"__squidpy_torch_ell__{key}_connectivities"]["graph"].k_max)
             for key in ("radius", "delaunay")}
    return launches, {
        "radius_graph_s": t_radius, "nhood_radius_s": t_nh_r, "autocorr_moran_perms_radius_s": t_moran,
        "delaunay_graph_s": t_del, "nhood_delaunay_s": t_nh_d, "radius_mean_degree": adj.nnz / n,
        "radius_k_max": k_max["radius"], "delaunay_k_max": k_max["delaunay"],
        "radius_bucket_widths": [int(i.shape[1]) for _, i, _ in buckets_r],
        "delaunay_bucket_widths": [int(i.shape[1]) for _, i, _ in buckets_d],
    }


def radius_host_split(adata: StandIn) -> None:
    """One more ``spatial_neighbors_radius`` call (``copy=True``) under the
    profiler: the host time of its named steps (the search, which waits for
    K6's two reads of the card, the copy to the host, which waits for the
    rest, CSR assembly of the finished CSR K6 wrote, the postprocessors); K6's
    device steps in a separate call as the builder makes it (``with_self``),
    by CUDA events, with its host syncs and rows per order tier; and
    ``from_csr`` of the graph, as the first statistic on it builds its ELL
    graph (a diagnostic)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import squidpy_torch as sqt
    from squidpy_torch._core.graph import SpatialGraph
    from squidpy_torch.ops.radius import radius_pairs

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, wall = _sync_time(lambda: sqt.gr.spatial_neighbors_radius(adata, radius=RADIUS, copy=True))
    steps = {e.key.split(".", 1)[1]: e.cpu_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("spatial_neighbors.")}
    if not steps:
        raise AssertionError("the profile holds none of spatial_neighbors' ranges")
    if "finalize" in steps:
        raise AssertionError("the radius build still inserts its diagonal on the host")
    stats: dict = {}
    radius_pairs(torch.from_numpy(np.asarray(adata.obsm["spatial"], np.float32)).cuda(), RADIUS, with_self=True,
                 stats=stats)
    _, t_csr = _sync_time(lambda: SpatialGraph.from_csr(adata.obsp["radius_connectivities"]))
    k6 = " ".join(f"k6_{k}={stats[k]:.3f}ms" for k in K6_STEPS)
    print(f"[host] spatial_neighbors_radius n={adata.obsm['spatial'].shape[0]} r={RADIUS}: wall={1e3 * wall:.1f}ms "
          + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items())
          + f" | {k6} k6_host_syncs={stats['host_syncs']} | from_csr_first_statistic={1e3 * t_csr:.1f}ms", flush=True)


def finalize_split(adata: StandIn) -> None:
    """The diagonal insertion (``_finalize_pair``: scipy's ``setdiag`` of
    both matrices) of the kNN (k = 6) and Delaunay builds on the main
    path's cells: its profiler range in one ``build_graph`` each, on one
    cKDTree query and one qhull run, and whether each build's CSR is
    canonical (sorted, without duplicates) before the insertion."""
    import warnings

    import scipy.sparse as sps
    from scipy.spatial import Delaunay
    from torch.profiler import ProfilerActivity, profile

    from squidpy_torch.gr import neighbors as nb
    from squidpy_torch.ops.knn import auto_knn

    coords = np.asarray(adata.obsm["spatial"])
    n = len(coords)
    dists, cols = auto_knn(coords, N_NEIGHS)
    tri = Delaunay(coords)
    indptr, indices = tri.vertex_neighbor_vertices
    canonical = {
        "knn": sps.csr_matrix((np.ones(n * N_NEIGHS), (np.repeat(np.arange(n), N_NEIGHS), cols.reshape(-1))),
                              shape=(n, n)).has_canonical_format,
        "delaunay": sps.csr_matrix((np.ones(len(indices)), indices, indptr), shape=(n, n)).has_canonical_format,
    }
    builds = {"knn": lambda: nb._knn_to_csr(dists, cols, n, set_diag=False),
              "delaunay": lambda: nb.DelaunayBuilder().build_graph(coords)}
    parts = []
    real = nb.Delaunay
    try:
        nb.Delaunay = lambda _: tri  # the qhull run above, not a second one
        for build, fn in builds.items():
            with warnings.catch_warnings(action="ignore", category=sps.SparseEfficiencyWarning), \
                    profile(activities=[ProfilerActivity.CPU]) as prof:
                adj, _ = fn()
            ms = [e.cpu_time_total / 1e3 for e in prof.key_averages() if e.key == "spatial_neighbors.finalize"]
            parts.append(f"{build} canonical={canonical[build]} nnz={adj.nnz} finalize={ms[0]:.1f}ms")
    finally:
        nb.Delaunay = real
    print(f"[host] diagonal insertion n={n}: " + " ".join(parts), flush=True)


def check_radius_pairs(name: str, pts: np.ndarray, radius: float, repeats: int = 3, plain_warm: bool = True,
                       diag: bool = False, with_self: bool = False, tiers: tuple[int, int] | None = None,
                       tier: str | None = None) -> dict:
    """K6's CSR (through its wrapper: grid, both passes, scan and row order;
    ``with_self`` writes each row's diagonal; ``tiers`` lowers the row
    order's tier limits) against the plain version on the card, bitwise;
    at most two host syncs; rows in the order tier ``tier``, where given;
    given ``diag``, a ``[diag]`` line of its grid, device steps, syncs and
    rows per tier."""
    import torch

    from squidpy_torch.ops.radius import _radius_plain, radius_pairs, radius_threshold

    x = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).cuda()
    n, d = x.shape
    stats: dict = {}
    radius_pairs(x, radius, with_self=with_self, stats=stats, _tiers=tiers)
    got, ms = _time_ms(lambda: radius_pairs(x, radius, with_self=with_self, _tiers=tiers), repeats)
    want, plain_ms = _time_ms(lambda: _radius_plain(x, float(radius_threshold(radius)), with_self=with_self), 1,
                              warm=plain_warm)
    for g, w, what in zip(got, want, ("indptr", "indices", "distances")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"radius_pairs {name}: {what} differ from the plain version (tolerance 0)")
    del want
    if stats["host_syncs"] > 2:
        raise AssertionError(f"radius_pairs {name}: {stats['host_syncs']} host syncs, at most 2")
    if tier is not None and stats[f"rows_{tier}"] <= 0:
        raise AssertionError(f"radius_pairs {name}: no row went through the {tier} tier")
    nnz = int(got[0][-1])
    # the coordinates read once; the int64 row offsets and, an edge (the
    # diagonal too, with_self), an int32 column and a float32 distance
    # written once; or, per candidate pair it tests, d subtractions, d
    # multiplies, d - 1 adds and a compare
    bound = _bound(n * d * 4 + (n + 1) * 8 + nnz * 8, stats["candidates"] * 3 * d)
    rows = f"rows warp/block/global={stats['rows_warp']}/{stats['rows_block']}/{stats['rows_global']}"
    print(f"[kernel] radius_pairs {name} n={n} d={d} r={radius} with_self={with_self} tiers={tiers or 'default'} "
          f"pairs={nnz} candidates={stats['candidates']}: max_abs_err=0.0 kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"bound_ms={bound[0]:.4f} ({bound[1]}) host_syncs={stats['host_syncs']} {rows} longest={stats['longest']}",
          flush=True)
    if diag:
        print(f"[diag] radius_pairs n={n} d={d} r={radius} with_self={with_self}: pairs={nnz} "
              f"candidates={stats['candidates']} side={stats['side']:.6f} cells={stats['cells']} dims={stats['dims']} "
              f"points={stats['points']} " + " ".join(f"{k}={stats[k]:.3f}ms" for k in K6_STEPS)
              + f" host_syncs={stats['host_syncs']} {rows} longest={stats['longest']}", flush=True)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None}


def radius_kernel_checks(adata: StandIn) -> list[dict]:
    """K6 against its plain version: first on the main path's own input (all
    its cells at its radius; the plain version tests 1e12 pairs), with the
    diagonal as the builder calls it (the ``kernels`` line's numbers), and
    without it (the default of ``radius_neighbors``), then on the ``K6_CELLS`` of
    them in a corner square of a fifth of the section (also with the order
    tiers lowered, so rows of ~20 go through the block tier and the global
    merge), then in the branches: 3D, 4D (axes past the grid), coincident
    points at r = 25 and r = 0, r above the extent (rows of 2999: the block
    tier; with lowered limits, the global merge), a cluster of 20,000
    coincident points (rows past the block tier's natural limit: the global
    merge), NaN and inf rows, and a radius so small that the grid's side is
    enlarged."""
    coords = np.asarray(adata.obsm["spatial"])
    out = [check_radius_pairs("main path, with self", coords, RADIUS, repeats=10, plain_warm=False, diag=True,
                              with_self=True)]
    out.append(check_radius_pairs("main path", coords, RADIUS, repeats=10, plain_warm=False, diag=True))
    corner = 10.0 * np.sqrt(N_CELLS) * np.sqrt(K6_CELLS / N_CELLS)
    sub = coords[(coords[:, 0] < corner) & (coords[:, 1] < corner)]
    out.append(check_radius_pairs(f"main path cells in a corner ({len(sub)})", sub, RADIUS, repeats=10,
                                  plain_warm=False))
    out.append(check_radius_pairs(f"main path cells in a corner ({len(sub)}), lowered tiers", sub, RADIUS,
                                  with_self=True, tiers=K6_LOW_TIERS, tier="global"))
    rng = np.random.default_rng(12)
    n = K6_BRANCH_CELLS
    cube = (n * 4.0 / 3.0 * np.pi * RADIUS**3 / 20.0) ** (1.0 / 3.0)  # ~20 neighbours in 3D
    out.append(check_radius_pairs("3D", rng.uniform(0.0, cube, (n, 3)), RADIUS))
    out.append(check_radius_pairs("4D", rng.uniform(0.0, 60.0, (n // 5, 4)), 12.0, with_self=True))
    flat = rng.uniform(0.0, 10.0 * np.sqrt(n), (n, 2))
    flat[1::4] = flat[::4][: len(flat[1::4])]
    out += [check_radius_pairs("coincident points", flat, RADIUS), check_radius_pairs("coincident, r = 0", flat, 0.0),
            check_radius_pairs("coincident, r = 0, with self", flat, 0.0, with_self=True)]
    small = min(n, 3000)
    above = rng.uniform(0.0, 10.0 * np.sqrt(small), (small, 2))
    out += [check_radius_pairs("r above the extent", above, 1e4, tier="block"),
            check_radius_pairs("r above the extent, with self, global merge", above, 1e4, with_self=True,
                               tiers=(64, 512), tier="global")]
    cluster = rng.uniform(0.0, 10.0 * np.sqrt(n), (n, 2))
    cluster[:K6_CLUSTER] = cluster[0]
    out.append(check_radius_pairs(f"a cluster of {K6_CLUSTER} coincident points", cluster, RADIUS, with_self=True,
                                  tier="global", repeats=2))
    bad = rng.uniform(0.0, 10.0 * np.sqrt(n), (n, 2))
    bad[::97] = np.nan
    bad[5::101, 1] = np.inf
    out += [check_radius_pairs("NaN and inf rows", bad, RADIUS),
            check_radius_pairs("NaN and inf rows, with self", bad, RADIUS, with_self=True),
            check_radius_pairs("NaN and inf rows, infinite radius", bad[:2000], np.inf, with_self=True)]
    out.append(check_radius_pairs("r = 0.01, grid side enlarged", rng.uniform(0.0, 1e3, (n // 5, 2)), 0.01))
    return out


def _hex_dataset(n: int, seed: int) -> StandIn:
    """A Visium-like hexagonal lattice of spacing 100, with ``uns['spatial']``."""
    side = int(np.ceil(np.sqrt(n)))
    jj, ii = np.divmod(np.arange(side * side), side)
    coords = (100.0 * np.c_[ii + 0.5 * (jj % 2), jj * np.sqrt(3) / 2])[:n]
    adata = StandIn(coords, np.random.default_rng(seed).integers(0, N_CLS, n), N_CLS)
    adata.uns["spatial"] = {"library": {"scalefactors": {"spot_diameter_fullres": 55.0}}}
    return adata


def graph_reference_check(n: int) -> None:
    """The graph builders on the card and on the CPU (plain torch, host
    qhull) must give the same ``obsp`` CSR and ``uns`` params, bitwise: the
    radius graph (scalar, the (10, 25) interval through the facade, and
    ``library_key`` with ``n_jobs=2``), Delaunay, the grid with two rings and
    the facade's grid mode on a hexagonal lattice; then ``nhood_enrichment``
    (counts and z-scores bitwise) and ``spatial_autocorr`` (scores to
    ``SUM_TOL * sum |terms|``, p-values rtol 1e-3) on the radius graph."""
    import warnings

    import squidpy_torch as sqt

    t0 = time.perf_counter()
    cases = (
        ("radius", "spatial_neighbors_radius", dict(radius=RADIUS)),
        ("radius, interval through the facade", "spatial_neighbors", dict(coord_type="generic", radius=(10.0, RADIUS))),
        ("radius, library_key, 2 jobs", "spatial_neighbors_radius", dict(radius=RADIUS, library_key="lib", n_jobs=2)),
        ("delaunay", "spatial_neighbors_delaunay", dict()),
        ("grid, 2 rings", "spatial_neighbors_grid", dict(n_rings=2)),
        ("facade, visium grid", "spatial_neighbors", dict()),
    )
    x = poisson_counts(n, 16, seed=13, low=0.5)
    results: dict = {}
    for device in ("cuda", "cpu"):
        with sqt.set_device(device), warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            for name, fn, kw in cases:
                adata = _hex_dataset(n, 14) if "grid" in name else _dataset(n, seed=15)
                adata.obs["lib"] = _Categorical(np.arange(n) % 2, 2)
                getattr(sqt.gr, fn)(adata, **kw)
                results[device, name] = adata
            adata = results[device, "radius"]
            adata.set_expression(x)
            sqt.gr.nhood_enrichment(adata, "cluster", n_perms=50, seed=0)
            sqt.gr.spatial_autocorr(adata, mode="moran", n_perms=20, seed=0)
            sqt.gr.spatial_autocorr(adata, mode="geary", n_perms=20, seed=0)
    for name, _, _ in cases:
        gpu, cpu = results["cuda", name], results["cpu", name]
        for key in ("spatial_connectivities", "spatial_distances"):
            a, b = gpu.obsp[key], cpu.obsp[key]
            if not all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("indptr", "indices", "data")):
                raise AssertionError(f"{name}: obsp[{key!r}] differs between card and CPU")
        if gpu.uns["spatial_neighbors"] != cpu.uns["spatial_neighbors"]:
            raise AssertionError(f"{name}: uns['spatial_neighbors'] differs between card and CPU")
    gpu, cpu = results["cuda", "radius"], results["cpu", "radius"]
    for field in ("count", "zscore"):
        if not np.array_equal(gpu.uns["cluster_nhood_enrichment"][field], cpu.uns["cluster_nhood_enrichment"][field],
                              equal_nan=True):
            raise AssertionError(f"nhood_enrichment[{field!r}] on the radius graph differs between card and CPU")
    for key, mode, stat in (("moranI", "moran", "I"), ("gearyC", "geary", "C")):
        a, b = gpu.uns[key], cpu.uns[key]
        if list(a.index) != list(b.index):
            raise AssertionError(f"{key} on the radius graph: rows differ between card and CPU")
        if not np.all(np.abs(a.columns[stat] - b.columns[stat]) <= _autocorr_terms_bound(cpu, b, mode)):
            raise AssertionError(f"{key} on the radius graph differs between card and CPU beyond the bound")
        for col in a.columns:
            if col in ("var_norm", "pval_sim"):
                np.testing.assert_array_equal(a.columns[col], b.columns[col], err_msg=f"{key}[{col!r}]")
            elif col != stat:
                np.testing.assert_allclose(a.columns[col], b.columns[col], rtol=1e-3, atol=1e-12,
                                           err_msg=f"{key}[{col!r}]")
    print(f"[reference] n={n} graph builders: card and CPU agree bitwise ({', '.join(c[0] for c in cases)}); on the "
          f"radius graph nhood counts/z-scores bitwise, Moran/Geary within {SUM_TOL} * sum |terms|, p-values rtol "
          f"1e-3 ({time.perf_counter() - t0:.1f} s)", flush=True)


def _skewed_labels(n: int, seed: int) -> np.ndarray:
    """Part d's cell types: the largest holds ``RIPLEY_BIG_SHARE`` of the
    cells, the other ``RIPLEY_CLS - 1`` share the rest evenly, drawn from a
    seed."""
    p = np.full(RIPLEY_CLS, (1.0 - RIPLEY_BIG_SHARE) / (RIPLEY_CLS - 1))
    p[0] = RIPLEY_BIG_SHARE
    return np.random.default_rng(seed).choice(RIPLEY_CLS, size=n, p=p).astype(np.int32)


def _profiled(fn, prefix: str) -> tuple[object, float, dict[str, float]]:
    """``fn()`` under the CPU profiler: its result, its wall seconds and the
    host milliseconds of each of its ``prefix.*`` ranges."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, wall = _sync_time(fn)
    steps = {e.key.split(".", 1)[1]: e.cpu_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith(prefix + ".")}
    if not steps:
        raise AssertionError(f"the profile holds none of {prefix}'s ranges")
    return out, wall, steps


def _check_ripley(res: dict, mode: str, n_cls: int) -> None:
    """What a ``ripley`` call returned: the tables' shapes, finite curves that
    start at 0 and never fall (an ECDF ends at 1), p-values in [0, 0.5] on the
    grid k / (S + 1)."""
    obs, sims = res[f"{mode}_stat"], res["sims_stat"]
    if obs.stats.shape != (RIPLEY_STEPS * n_cls,) or sims.stats.shape != (RIPLEY_STEPS * RIPLEY_SIMS,):
        raise AssertionError(f"ripley {mode}: wrong table shapes")
    if res["pvalues"].shape != (n_cls, RIPLEY_STEPS) or res["bins"].shape != (RIPLEY_STEPS,):
        raise AssertionError(f"ripley {mode}: wrong p-value or bin shapes")
    for table in (obs, sims):
        curves = table.stats.reshape(-1, RIPLEY_STEPS)
        if not (np.isfinite(curves).all() and (curves[:, 0] == 0).all() and (np.diff(curves, axis=1) >= 0).all()):
            raise AssertionError(f"ripley {mode}: curves not finite, not starting at 0 or falling")
        if mode != "L" and not np.all(curves[:, -1] == 1.0):
            raise AssertionError(f"ripley {mode}: an ECDF does not end at 1")
    k = res["pvalues"] * (RIPLEY_SIMS + 1)
    if not (np.all(k >= 0) and np.all(k <= (RIPLEY_SIMS + 1) / 2) and np.allclose(k, np.round(k), rtol=0, atol=1e-9)):
        raise AssertionError(f"ripley {mode}: p-values not in [0, 0.5] on the grid k / (S + 1)")


def ripley_path(adata: StandIn) -> tuple[dict, dict, dict]:
    """Part d: on the main path's 1M cells with skewed cell types (the largest
    20%, so its L curve takes the binned sweep), ``ripley`` L, G and F at
    their defaults, ``interaction_matrix`` on part a's kNN graph (counts,
    weights, normalised) and ``centrality_scores`` (all three), each with
    the counters reset before it and read after it, its wall and the
    ``[host]`` split of its profiler ranges; then checks of what they
    returned. ``centrality_scores`` runs on the ~100k cells of a corner of
    the section. Returns the results, the launches and the seconds."""
    import squidpy_torch as sqt
    from squidpy_torch import _cuda

    n = adata.obsm["spatial"].shape[0]
    codes = _skewed_labels(n, seed=11)
    adata.obs["celltype"] = _Categorical(codes, RIPLEY_CLS)
    results: dict = {}
    launches: dict[str, dict] = {}
    secs: dict[str, float] = {}
    defaults = dict(n_simulations=RIPLEY_SIMS, n_observations=RIPLEY_OBS, n_steps=RIPLEY_STEPS, n_neigh=RIPLEY_NEIGH)
    for mode in ("L", "G", "F"):
        _cuda.reset_launches()
        res, wall, steps = _profiled(lambda: sqt.gr.ripley(adata, "celltype", mode=mode, seed=0, copy=True,
                                                            **defaults), "ripley")
        launches[f"ripley_{mode}"] = dict(_cuda.launches)
        secs[f"ripley_{mode}_s"] = wall
        print(f"[host] ripley {mode} n={n}: wall={1e3 * wall:.1f}ms "
              + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()), flush=True)
        _check_ripley(res, mode, RIPLEY_CLS)
        results[mode] = res

    _cuda.reset_launches()
    t0 = time.perf_counter()
    counts = sqt.gr.interaction_matrix(adata, "celltype", copy=True)
    secs["interaction_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    weighted = sqt.gr.interaction_matrix(adata, "celltype", weights=True, copy=True)
    secs["interaction_weighted_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    normed = sqt.gr.interaction_matrix(adata, "celltype", normalized=True, copy=True)
    secs["interaction_normalized_s"] = time.perf_counter() - t0
    launches["interaction_matrix"] = dict(_cuda.launches)
    # the kNN graph's connectivities are 1.0: the weighted sums are the counts
    if counts.shape != (RIPLEY_CLS, RIPLEY_CLS) or int(counts.sum()) != n * N_NEIGHS:
        raise AssertionError("interaction_matrix: wrong shape or edge total")
    if not np.array_equal(weighted, counts):
        raise AssertionError("interaction_matrix: weighted sums of 1.0 differ from the counts")
    if not np.allclose(normed.sum(axis=1), 1.0, rtol=0, atol=1e-12) or not np.array_equal(
            normed, counts / counts.sum(axis=1, keepdims=True)):
        raise AssertionError("interaction_matrix: normalised rows are not the counts over their sums")

    # the closeness sweep (one multi-source dijkstra a type) took ~17 s at
    # 1M cells on the 8-core host of one H100, so the group centralities
    # run on the cells of a corner tenth of the section with their kNN
    # edges among themselves
    xy = np.asarray(adata.obsm["spatial"])
    corner = np.all(xy < xy.max(axis=0) * np.sqrt(CENTRALITY_CELLS / n), axis=1)
    sub = StandIn(xy[corner], codes[corner], RIPLEY_CLS)
    sub.obs["celltype"] = sub.obs.pop("cluster")
    sub.obsp["spatial_connectivities"] = adata.obsp["spatial_connectivities"][corner][:, corner]
    _cuda.reset_launches()
    cent, wall, steps = _profiled(lambda: sqt.gr.centrality_scores(sub, "celltype", copy=True),
                                  "centrality_scores")
    launches["centrality_scores"] = dict(_cuda.launches)
    secs["centrality_s"] = wall
    print(f"[host] centrality_scores n={int(corner.sum())} (a corner of the section): wall={1e3 * wall:.1f}ms "
          + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()), flush=True)
    if list(cent.columns) != ["degree_centrality", "average_clustering", "closeness_centrality"]:
        raise AssertionError("centrality_scores: wrong columns")
    for name, col in cent.columns.items():
        if col.shape != (RIPLEY_CLS,) or not (np.isfinite(col).all() and (col >= 0).all() and (col <= 1).all()):
            raise AssertionError(f"centrality_scores[{name!r}] not finite in [0, 1]")
    results["centrality"] = cent
    return results, launches, secs


def _ripley_inputs(adata: StandIn) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, object]:
    """Part d's own inputs, as ``ripley`` builds them: float64 coordinates,
    cell types, the support, the envelope's clouds and the observed F
    reference points (seed 0)."""
    from scipy.spatial import ConvexHull

    from squidpy_torch.ops.ripley import ppp_sample

    coords = np.asarray(adata.obsm["spatial"], dtype=np.float64)
    codes = np.asarray(adata.obs["celltype"].cat.codes)
    hull = ConvexHull(coords)
    support = np.linspace(0.0, (hull.volume / 2) ** 0.5, RIPLEY_STEPS)
    obs_rng, *sim_rngs = (np.random.default_rng(s) for s in np.random.SeedSequence(0).spawn(RIPLEY_SIMS + 1))
    ref = None
    for _ in range(RIPLEY_CLS):  # F draws one reference set a cluster from the shared stream; the last is kept
        ref = ppp_sample(hull, 1, RIPLEY_OBS, rng=obs_rng)
    clouds = np.stack([ppp_sample(hull, 1, RIPLEY_OBS, rng=r) for r in sim_rngs])
    return coords, codes, support, clouds, ref


def check_ripley_pairs(name: str, pts: np.ndarray, support: np.ndarray) -> dict:
    """K7 on point sets (S, n, 2) and Ripley's squared support, against the
    plain version, bitwise."""
    import torch

    from squidpy_torch.ops.ripley import _ripley_pairs_plain, ripley_pairs

    p = torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).cuda()
    thr = torch.from_numpy((np.asarray(support, np.float64) ** 2).astype(np.float32)).cuda()
    n_sets, n, dim = p.shape
    pairs = n_sets * n * (n - 1) / 2
    # every pair: 3d - 1 flops of d2 and one compare with the largest
    # threshold; the points and thresholds read once, the (S, L) int64 written
    bound = _bound(p.numel() * 4 + thr.numel() * 4 + n_sets * thr.numel() * 8, pairs * (3 * dim - 1 + 1))
    return _compare(f"ripley_pairs {name} S={n_sets} n={n} d={dim} L={thr.numel()} pairs={pairs:.3e}",
                    lambda: ripley_pairs(p, thr), lambda: _ripley_pairs_plain(p, thr), repeats=3, bound=bound)


def check_cross_knn(name: str, queries: np.ndarray, data: np.ndarray, k: int, library: bool = False) -> dict:
    """K8 on queries (m, 2) against point sets (S, n, 2), against the plain
    version: indices and distances bitwise (held as one tensor); given
    ``library``, ``torch.cdist`` + ``torch.topk`` as the yardstick (S = 1)."""
    import torch

    from squidpy_torch.ops.knn import _nearest_plain, nearest_points

    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).cuda()
    x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).cuda()
    x = x[None] if x.ndim == 2 else x
    n_sets, n, dim = x.shape
    m = q.shape[0]

    def pack(out):  # distances and indices side by side, compared at once (int32 indices are exact in float64)
        return torch.cat([out[0].to(torch.float64), out[1].to(torch.float64)], dim=-1)

    lib = None
    if library:
        def lib():
            return torch.topk(torch.cdist(q, x[0]), k, dim=1, largest=False, sorted=True)

    pairs = n_sets * m * n
    bound = _bound((q.numel() + x.numel()) * 4 + n_sets * m * k * 8, pairs * (3 * dim - 1 + 1))
    return _compare(f"cross_knn {name} S={n_sets} m={m} n={n} k={k} pairs={pairs:.3e}",
                    lambda: pack(nearest_points(q, x, k)), lambda: pack(_nearest_plain(q, x, k)), repeats=3,
                    bound=bound, library=lib)


def ripley_kernel_checks(adata: StandIn) -> dict[str, list[dict]]:
    """Part d's kernels on its own inputs: K8 on one G-mode cluster (first
    with the queries cut, so that ``torch.cdist`` + ``torch.topk`` fit beside
    it, then on all of them), on the F and on the G envelope (all clouds and
    queries); K7 on one dense cluster and on the L envelope; K1's
    one-class call on the 200k cluster's plan (planner time, items, tile
    pairs; the plain version not warmed), and the dense K7 against the
    binned K1 on that cluster."""
    from squidpy_torch.ops.pairbins import sorted_plan
    from squidpy_torch.ops.ripley import pair_counts_cumulative

    coords, codes, support, clouds, ref = _ripley_inputs(adata)
    dense = coords[codes == 1]
    others = coords[codes != 1]
    checks = {"cross_knn": [], "ripley_pairs": [], "binned_pairs": []}
    checks["cross_knn"].append(check_cross_knn("G cluster 1, queries cut", others[:K8_LIBRARY_QUERIES], dense,
                                               RIPLEY_NEIGH, library=True))
    checks["cross_knn"].append(check_cross_knn("G cluster 1, all queries", others, dense, RIPLEY_NEIGH))
    checks["cross_knn"].append(check_cross_knn("F envelope", ref, clouds, 1))
    checks["cross_knn"].append(check_cross_knn("G envelope", coords, clouds, 1))
    checks["ripley_pairs"].append(check_ripley_pairs("L cluster 1", dense[None], support))
    checks["ripley_pairs"].append(check_ripley_pairs("L envelope", clouds, support))

    big = coords[codes == 0]
    t0 = time.perf_counter()
    thr = (support.astype(np.float64) ** 2).astype(np.float32)
    _, _, plan = sorted_plan(big.astype(np.float32), np.zeros(len(big), np.int32), thr, 1)
    plan_s = time.perf_counter() - t0
    print(f"[diag] binned_pairs ripley L largest cluster: planner {plan_s:.3f} s, n={plan.n} tile={plan.tile} "
          f"items={plan.n_items} tile_pairs={plan.n_pairs_total}", flush=True)
    checks["binned_pairs"].append(check_binned_pairs("ripley L, largest cluster", big.astype(np.float32),
                                                     np.zeros(len(big), np.int32), thr, 1, plain_warm=False))
    dense_k7, t_dense = _sync_time(lambda: pair_counts_cumulative(big, support, method="dense"))
    binned_k1, t_binned = _sync_time(lambda: pair_counts_cumulative(big, support, method="binned"))
    if not np.array_equal(dense_k7, binned_k1):
        raise AssertionError("ripley L: the dense K7 and the binned K1 count the largest cluster differently")
    print(f"[diag] ripley L largest cluster n={len(big)}: dense (K7) {t_dense:.4f} s, binned (planner + K1) {t_binned:.4f} s, "
          f"equal counts (pairs at the last bin {dense_k7[-1]:.0f})", flush=True)
    return checks


def ripley_branch_checks() -> dict[str, list[dict]]:
    """K7 and K8 in the branches part d does not take: K7 in 3D, at a runtime
    dimension (5), with one shared histogram (8000 thresholds), with global
    atomics (30,000) and with the thresholds read from global memory
    (60,000); K8 with coincident points (ties), in 3D, at a runtime
    dimension (4 and 1), and above its 32-key register list (k = 40, and k
    = n = 64)."""
    rng = np.random.default_rng(14)
    k7 = [("3D", (2, 1500, 3), 9), ("5D", (1, 700, 5), 40), ("one shared histogram", (1, 1025, 2), 8000),
          ("global atomics", (1, 1025, 2), 30_000), ("thresholds in global memory", (1, 600, 2), 60_000)]
    checks = {"ripley_pairs": [check_ripley_pairs(name, rng.uniform(0, 100, shape), np.linspace(0, 80, n_thr))
                               for name, shape, n_thr in k7]}
    k8 = [("ties", 300, (1, 250, 3), 7), ("4D", 300, (1, 500, 4), 3), ("1D", 1000, (1, 33, 1), 33),
          ("global list, ties", 200, (2, 150, 2), 40), ("global list, k = n", 130, (1, 32, 2), 64)]
    checks["cross_knn"] = []
    for name, m, (n_sets, half, dim), k in k8:
        data = rng.uniform(0, 100, (n_sets, half, dim))
        if "ties" in name or "k = n" in name:
            data = np.repeat(data, 2, axis=1)  # every point twice
        checks["cross_knn"].append(check_cross_knn(name, rng.uniform(0, 100, (m, dim)), data, k))
    return checks


def ripley_reference_check(n: int) -> None:
    """Part d's public calls on the card and on the CPU (plain torch) must
    agree: ``ripley`` L, G and F (bins, tables and p-values bitwise),
    ``interaction_matrix`` (counts and normalised rows bitwise, weighted sums
    within 1e-12 of their terms) and ``centrality_scores`` (bitwise)."""
    import squidpy_torch as sqt

    t0 = time.perf_counter()
    graph = None
    out = {}
    for device in ("cuda", "cpu"):
        with sqt.set_device(device):
            adata = _dataset(n, seed=12)
            adata.obs["celltype"] = _Categorical(_skewed_labels(n, seed=13), RIPLEY_CLS)
            if graph is None:
                sqt.gr.spatial_neighbors_knn(adata, n_neighs=N_NEIGHS)
                graph = adata.obsp["spatial_connectivities"]
            adata.obsp["spatial_connectivities"] = graph
            w = graph.copy()
            w.data = np.random.default_rng(0).uniform(0.5, 2.0, w.nnz)
            adata.obsp["w_connectivities"] = w
            res = {mode: sqt.gr.ripley(adata, "celltype", mode=mode, seed=1, n_simulations=20,
                                       n_observations=300, copy=True) for mode in ("L", "G", "F")}
            res["counts"] = sqt.gr.interaction_matrix(adata, "celltype", copy=True)
            res["normalized"] = sqt.gr.interaction_matrix(adata, "celltype", normalized=True, copy=True)
            res["weighted"] = sqt.gr.interaction_matrix(adata, "celltype", connectivity_key="w", weights=True,
                                                        copy=True)
            res["centrality"] = sqt.gr.centrality_scores(adata, "celltype", copy=True)
            out[device] = res
    gpu, cpu = out["cuda"], out["cpu"]
    for mode in ("L", "G", "F"):
        for key in (f"{mode}_stat", "sims_stat"):
            for field in ("bins", "values", "categories", "stats"):
                np.testing.assert_array_equal(getattr(gpu[mode][key], field), getattr(cpu[mode][key], field),
                                              err_msg=f"ripley {mode} {key}.{field}")
        for key in ("bins", "pvalues"):
            np.testing.assert_array_equal(gpu[mode][key], cpu[mode][key], err_msg=f"ripley {mode} {key}")
    for key in ("counts", "normalized"):
        np.testing.assert_array_equal(gpu[key], cpu[key], err_msg=f"interaction_matrix {key}")
    np.testing.assert_allclose(gpu["weighted"], cpu["weighted"], rtol=1e-12, atol=0)  # positive weights
    np.testing.assert_array_equal(gpu["centrality"].index, cpu["centrality"].index)
    for name in cpu["centrality"].columns:
        np.testing.assert_array_equal(gpu["centrality"].columns[name], cpu["centrality"].columns[name])
    print(f"[reference] n={n} ripley L/G/F, interaction_matrix, centrality_scores: card and CPU agree (ripley "
          f"tables and p-values, counts, normalised rows and centralities bitwise; weighted sums rtol 1e-12) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


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
    func = ""
    for line in _cuda.build_log.splitlines():
        if "Function properties for" in line:
            func = line.split("Function properties for", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            print(f"[ptxas] {func}: {line.split(':', 1)[-1].strip()}", flush=True)

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
    t_phase = time.perf_counter()
    host_split(adata)
    phases["host_split"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    launches_c, secs_c = radius_path(adata)
    print(f"[main path c] n={N_CELLS} r={RADIUS} genes={N_GENES} perms={N_PERMS}/{AUTOCORR_PERMS} "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in secs_c.items()), flush=True)
    print(f"[launches c] {launches_c}", flush=True)
    missing = [k for k in ("radius_pairs", "pair_counts", "index_cipher", "ell_autocorr", "perm_autocorr")
               if launches_c[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path's third part: {missing}")
    launches = {k: launches[k] + launches_c[k] for k in launches}
    phases["main_path_c"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    radius_host_split(adata)
    phases["radius_host_split"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    finalize_split(adata)
    phases["finalize_split"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    _, launches_calls, secs_d = ripley_path(adata)
    print(f"[main path d] n={N_CELLS} types={RIPLEY_CLS} sims={RIPLEY_SIMS} obs={RIPLEY_OBS} steps={RIPLEY_STEPS} "
          + " ".join(f"{k}={v:.4f}" for k, v in secs_d.items()), flush=True)
    launches_d = {k: sum(c[k] for c in launches_calls.values()) for k in launches}
    for call, counts in launches_calls.items():
        print(f"[launches d] {call}: {counts}", flush=True)
    wanted = {"ripley_L": ("binned_pairs", "ripley_pairs"), "ripley_G": ("cross_knn",), "ripley_F": ("cross_knn",),
              "interaction_matrix": ("pair_counts",)}
    missing = [(call, k) for call, names in wanted.items() for k in names if launches_calls[call][k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path's fourth part: {missing}")
    launches = {k: launches[k] + launches_d[k] for k in launches}
    phases["main_path_d"] = time.perf_counter() - t_phase

    # the main path's own inputs first (their times go into the JSON line),
    # then the fixed shapes and the branches the main path does not take
    t_phase = time.perf_counter()
    checks = main_path_kernel_checks(adata, interval)
    checks.update(autocorr_kernel_checks(adata, results))
    for name, extra in new_graph_kernel_checks(adata).items():
        checks[name] += extra
    checks["radius_pairs"] = radius_kernel_checks(adata)
    for name, extra in ripley_kernel_checks(adata).items():
        checks[name] = checks.get(name, []) + extra
    del adata, results
    phases["kernels_main_path_inputs"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    checks["index_cipher"] += [random_index_cipher(N_CELLS, 64, N_CLS), random_index_cipher(N_CELLS + 3, 33, N_CLS)]
    checks["pair_counts"] += [random_pair_counts(N_CELLS, N_NEIGHS, 8, 64, N_CLS, "packed"),
                              random_pair_counts(N_CELLS, N_NEIGHS, 8, 16, 200, "global"),
                              random_pair_counts(N_CELLS, N_NEIGHS, 8, 37, 40, "shared"), overflow_pair_counts()]
    checks["binned_pairs"] += [random_binned_pairs(200_000, 2, N_CLS), random_binned_pairs(100_000, 3, N_CLS),
                               random_binned_pairs(20_000, 2, 96), random_binned_pairs(20_000, 2, 200)]
    for name, extra in branch_checks().items():
        checks[name] += extra
    for name, extra in ripley_branch_checks().items():
        checks[name] += extra
    phases["kernels_other_shapes"] = time.perf_counter() - t_phase

    # card against CPU through the public API: small (brute-force kNN, sort
    # shuffles, dense sweep, K2), and at 100k (cipher shuffles, binned sweep)
    t_phase = time.perf_counter()
    reference_check(3000, 20)
    reference_check(100_000, np.linspace(0.0, 5.0 * secs["mean_knn_distance"], 9))
    graph_reference_check(3000)
    ripley_reference_check(3000)
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
