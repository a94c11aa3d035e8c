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
      holding 20% (200k cells) and the others ~53k each: ``ripley`` L (K7
      on every type, the largest too, and the envelope; a ``[route]`` line
      gives the route ``auto`` takes for each type), G and F (K8; the
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
   e. ``examples/ligrec_1m.py``'s workload: 1M cells x 380 genes of
      Poisson(1.2) counts as uint8, 16 clusters, 1024 interactions (the
      first 32 genes against the next 32), 1000 permutations, threshold
      0.01: the device expression handle made first, then ``ligrec`` twice
      (seeds 0 and 1), the second under the CPU profiler, whose ``[host]``
      line splits it (prepare, observed means, permutations, counts,
      p-values, container) (K10 shuffles, K9 counts on its integral
      route);
   f. f1: part a's 1M cells as a study of 8 sections (contiguous strips,
      60k-200k cells each, sizes from a seed): ``spatial_neighbors_knn``
      with ``library_key`` (no edge across sections) and
      ``nhood_enrichment(library_key=..., n_perms=1000)`` twice (seeds 0
      and 1; K10's grouped entry (K10g) and K3, never
      the cipher), and once more under the CPU profiler, whose ``[host]
      nhood_library`` line splits it (the group layout, the device layout,
      ``values[order]``, K10g, the transpose, K3, the copy to the host); f2:
      ``examples/sepal_scale.py``'s timed run, ``sepal`` on a 1000 x 1000
      square lattice (Visium HD bins) x 1024 genes of floored Gamma counts
      with bumps, ``thresh=0``, 300 steps, twice (K11's streaming route);
      f3: ``sepal`` at its defaults on the example's 316 x 316 x 256 (the
      spatial genes must score above the background; streaming) and on a
      Visium section of 4,992 hexagonal spots x 2000 genes (K11's resident
      route);
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
   as the yardstick, then all of them), on the largest cluster against its
   ~800k queries, on one F-mode observed call (1000 reference points), on
   the F envelope (100 clouds of 1000 points, 1000 queries) and on the G
   envelope (the same clouds, all 1M cells as queries), each with a
   ``[diag] cross_knn`` line (the route ``nearest_points`` takes and both
   routes' times, the grid's side and cells, tests and rings a query,
   queries that scanned every point, the grid's, the queries' sort's and
   the search's device time, and the bound from the tests beside the
   brute-force bound of every pair), and the other route held bitwise
   against the one taken; K7 on one dense cluster (with its ``[diag]
   ripley_pairs`` line: the kernel with d2 and the compare alone, with the
   bucket table added, whole, and on the generic path of large L), on the
   L envelope and on the largest cluster (and, in the branches part d does
   not take, K7 with coincident points, at n = 1, 2, 511, 513, 1025 and
   4097, with NaN coordinates, in 1D, 3D and 5D, on 100 random clouds, and
   at 8000, 30,000 and 60,000 thresholds (one shared L-bin copy, the
   thresholds in global memory, global atomics); K8 with ties, in
   1D, 3D and 4D, and above its register list, and its grid search forced
   on inputs built to break it: ties across cell boundaries, also with no
   ring-bound margin, coincident points, queries outside the box, far
   clusters, NaN and infinite coordinates, overflowing d2, one point, k = n,
   five sets); K1's one-class call on the
   largest cluster's plan (a
   ``[diag]`` line with its planner's host time, items and tile pairs; the
   plain version not warmed), and that cluster's L counts by the dense K7
   against the binned K1, which must be equal; then both routes of
   ``pair_counts_cumulative`` timed on one type of 100k to 2M cells at
   Ripley's default support and at 50 um (``[diag] k7_route`` lines, equal
   counts asserted); on part e's own inputs (its first permutation chunk,
   ~357 keys on an 80 GB card): K9 by the integral route the route rule
   takes on its counts (with the one-hot product of JAX's form, TF32 off,
   as the yardstick of its sums), and by the float route on fractional
   data made from them; K10's shuffle of the chunk
   (two rounds, uint8 labels; K10's words, stable sorts and gathers as
   its yardstick) and its words alone; a ``[diag] k9_layout`` line of both
   routes' block layouts, a ``[diag] shuffle`` line of K10's steps
   (histogram, scan, scatter, sort with its fused epilogue, a round each),
   its buckets, largest bucket and overflowing buckets, its bound and its
   design's floor, and a ``[diag] ligrec`` line of a chunk's device steps
   (K10, the words-and-sorts path, K9 by each route, the route rule and
   the uint8 copy); then K9 in float64, at 2, 20 and 100 clusters, odd cell counts,
   several slabs and gene tiles, a cluster with no cells, labels outside
   the clusters, fractional data and permutation counts that are not a
   multiple of a launch's, each by the rule's route and, on counts, by the
   float route; K10's shuffle at n = 1, 1625, 1626, 65,537 (64 keys) and
   2.7M (4 keys, three rounds), as positions and as uint8 labels, one
   ``permutation_columns`` round of 500 keys, words with ties (4096 and 2
   distinct words), and every word equal or the capacity lowered (the
   overflow path); K10's words at n = 1, 1625, 1626, 65,537 and 1M,
   unflipped, and with more keys than the grid's rows; on part f's own
   inputs: K10g on f1's first 500-permutation chunk (the sort path, K10's
   words + one ``torch.sort`` of the (section, word) keys + the gathers, as
   its yardstick, held bitwise too), its ``[diag] grouped`` line (the
   route, the keys of one launch set, the scatter and the sort, segments,
   tiles, bucket starts, coarse buckets, the device layout alone,
   the fused write at the original rows against a separate gather, the
   bound and the design's floor), then int32 and int64 values with a
   one-cell and a NaN library, tied words, 500 sections of 2,000 cells,
   one section of 1M, 3M and 7M cells (each route asserted), the capacity
   lowered on both routes and every word equal (the overflow sort); K11 on the route each shape
   selects (asserted): f2's first 64 genes for the 300-step budget (the
   steps and the state after it) and f3's 316 x 316 x 256 (streaming), f3's
   Visium section (resident), each with a ``[diag] sepal`` line.
   Integer kernels
   (K1-K4, K7, K9, K10), K11 (its steps and state), K6's CSR (offsets, columns and distances), K8's indices
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
   sums to rtol 1e-12) and ``centrality_scores`` (bitwise); and ``ligrec``
   bitwise (means and p-values) at 3000 cells of fractional data (the
   float64 route, FDR along the clusters) and 70,000 cells x 64 genes of
   counts (the float32 route through the device expression handle); and
   ``nhood_enrichment(library_key=...)`` bitwise on a ~100k-cell band of
   part f1's study across its 8 sections.

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
RIPLEY_BIG_SHARE = 0.2  # the largest type's share: 200k cells (its L counts: K7 on the card, K1 on the CPU)
RIPLEY_SIMS, RIPLEY_OBS, RIPLEY_STEPS, RIPLEY_NEIGH = 100, 1000, 50, 2  # `ripley`'s defaults
K8_LIBRARY_QUERIES = 50_000  # K8 beside torch.cdist + torch.topk: the queries cut to fit the (m, n) distances
CENTRALITY_CELLS = 100_000  # centrality_scores' host closeness sweep runs on a corner of this many cells
LIGREC_CELLS, LIGREC_GENES, LIGREC_CLS, LIGREC_PERMS = 1_000_000, 380, 16, 1000  # examples/ligrec_1m.py

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

    raw = None

    @property
    def n_obs(self) -> int:
        return self.obsm["spatial"].shape[0]

    @property
    def n_vars(self) -> int:
        return len(self.var_names)

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
    diff[(got == want) | (torch.isnan(got) & torch.isnan(want))] = 0.0  # inf, or NaN, on both sides agrees
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


def _profiled(fn, prefix: str | tuple[str, ...]) -> tuple[object, float, dict[str, float]]:
    """``fn()`` under the CPU profiler: its result, its wall seconds and the
    host milliseconds of each of its ``prefix.*`` ranges (of each prefix)."""
    from torch.profiler import ProfilerActivity, profile

    prefixes = (prefix,) if isinstance(prefix, str) else prefix
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, wall = _sync_time(fn)
    steps = {e.key.split(".", 1)[1]: e.cpu_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith(tuple(p + "." for p in prefixes))}
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


def _print_ripley_routes(coords: np.ndarray, codes: np.ndarray) -> None:
    """The route ``pair_counts_cumulative(method='auto')`` takes for each
    cell type of ``ripley`` L at its default support."""
    from scipy.spatial import ConvexHull

    from squidpy_torch._device import get_device
    from squidpy_torch.ops.ripley import _extent, _k7_route

    coords = np.asarray(coords, dtype=np.float64)
    support = np.linspace(0.0, (ConvexHull(coords).volume / 2) ** 0.5, RIPLEY_STEPS)
    routes = []
    for c in range(RIPLEY_CLS):
        members = coords[codes == c]
        routes.append(f"{c}:{len(members)}:{_k7_route(len(members), support, _extent(members), get_device())}")
    print(f"[route] ripley L (type:cells:route) {' '.join(routes)}", flush=True)


def ripley_path(adata: StandIn) -> tuple[dict, dict, dict]:
    """Part d: on the main path's 1M cells with skewed cell types (the largest
    20%), ``ripley`` L, G and F at
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
    _print_ripley_routes(adata.obsm["spatial"], codes)
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


def check_ripley_pairs(name: str, pts: np.ndarray, support: np.ndarray, plain_warm: bool = True) -> dict:
    """K7 on point sets (S, n, d) and Ripley's squared support, against the
    plain version, bitwise: timed as ``ripley`` calls it (host thresholds,
    their table built once a support), and the public ``ripley_pairs``
    (thresholds on the card, read back once) held equal too."""
    import torch

    from squidpy_torch.ops.ripley import _pairs_host_thresholds, _ripley_pairs_plain, ripley_pairs

    p = torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).cuda()
    thr_host = (np.asarray(support, np.float64) ** 2).astype(np.float32)
    thr = torch.from_numpy(thr_host).cuda()
    n_sets, n, dim = p.shape
    pairs = n_sets * n * (n - 1) / 2
    # every pair: 3d - 1 flops of d2 and one compare with the largest
    # threshold; the points and thresholds read once, the (S, L) int64 written
    bound = _bound(p.numel() * 4 + thr.numel() * 4 + n_sets * thr.numel() * 8, pairs * (3 * dim - 1 + 1))
    result = _compare(f"ripley_pairs {name} S={n_sets} n={n} d={dim} L={thr.numel()} pairs={pairs:.3e}",
                      lambda: _pairs_host_thresholds(p, thr_host), lambda: _ripley_pairs_plain(p, thr),
                      repeats=3, bound=bound, plain_warm=plain_warm)
    if not torch.equal(ripley_pairs(p, thr), _pairs_host_thresholds(p, thr_host)):
        raise AssertionError(f"ripley_pairs {name}: the public call and the host-threshold path differ")
    return result


def ripley_pairs_split(pts: np.ndarray, support: np.ndarray) -> None:
    """K7's ``[diag]`` line on one point set (d = 2): the kernel alone
    (table prebuilt) with d2 and the compare with the largest threshold,
    counted in a register (mode 1), with the bucket table and the slot
    added (mode 2), and whole; whole again on the path that large L takes
    (the table in global memory, shared L-bin copies a warp); the table's
    build on the card and on the host; the launch's shape."""
    import torch

    from squidpy_torch.ops.ripley import (
        _K7_COLS, K7Layout, _k7_layout, _k7_row_tile, _k7_table, _launch_k7, _ripley_pairs_plain,
    )

    p = torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).cuda()[None]
    thr = torch.from_numpy((np.asarray(support, np.float64) ** 2).astype(np.float32)).cuda()
    n = p.shape[1]
    layout = _k7_layout(2, thr.numel())
    row_tile = _k7_row_tile(1, n)
    table = _k7_table(thr, layout.n_buckets)
    ms = {m: _time_ms(lambda m=m: _launch_k7(p, thr, mode=m, table=table), 5)[1] for m in (1, 2, 0)}
    generic = K7Layout("shared", 8, 2048, True)
    generic_table = _k7_table(thr, generic.n_buckets)
    got, generic_ms = _time_ms(lambda: _launch_k7(p, thr, layout=generic, table=generic_table), 5)
    if not torch.equal(got, _ripley_pairs_plain(p, thr)):
        raise AssertionError("ripley_pairs: the generic path differs from the plain version")
    col_tiles = -(-n // _K7_COLS)
    items = _K7_COLS // row_tile * col_tiles * (col_tiles + 1) // 2
    table_ms = _time_ms(lambda: _k7_table(thr, layout.n_buckets), 5)[1]
    thr_cpu = thr.cpu()
    t0 = time.perf_counter()
    _k7_table(thr_cpu, layout.n_buckets)
    host_ms = 1e3 * (time.perf_counter() - t0)
    walk = int(torch.isnan(table[: layout.n_buckets + 1].view(torch.float32)).sum())
    print(f"[diag] ripley_pairs n={n} L={thr.numel()} pairs={n * (n - 1) / 2:.3e}: d2_compare_ms={ms[1]:.4f} "
          f"d2_table_slot_ms={ms[2]:.4f} full_ms={ms[0]:.4f} generic_path_ms={generic_ms:.4f} "
          f"table_build_card_ms={table_ms:.4f} table_build_host_ms={host_ms:.3f} layout={tuple(layout)} "
          f"walk_buckets={walk} row_tile={row_tile} items={items}", flush=True)


def ripley_route_diag() -> None:
    """``pair_counts_cumulative``'s two routes for one type of n cells
    spread over the main path's section (side 10,000 um), at Ripley's
    default support and at 50 um: both times (host clock, second of two
    calls each), equal counts asserted, and the route ``auto`` takes."""
    from squidpy_torch._device import get_device
    from squidpy_torch.ops.ripley import _extent, _k7_route, pair_counts_cumulative

    rng = np.random.default_rng(15)
    side = 10.0 * np.sqrt(N_CELLS)
    for n in (100_000, 200_000, 400_000, 1_000_000, 2_000_000):
        pts = rng.uniform(0.0, side, (n, 2))
        for name, support in (("default", np.linspace(0.0, side / np.sqrt(2.0), RIPLEY_STEPS)),
                              ("50um", np.linspace(0.0, 50.0, RIPLEY_STEPS))):
            times, counts = {}, {}
            for method in ("dense", "binned"):
                _sync_time(lambda: pair_counts_cumulative(pts, support, method=method))
                counts[method], times[method] = _sync_time(lambda: pair_counts_cumulative(pts, support, method=method))
            if not np.array_equal(counts["dense"], counts["binned"]):
                raise AssertionError(f"pair_counts_cumulative n={n} {name}: the two routes count differently")
            print(f"[diag] k7_route n={n} support={name} (max {support[-1]:.1f}): dense (K7) {times['dense']:.4f} s, "
                  f"binned (planner + K1) {times['binned']:.4f} s, equal counts, auto takes "
                  f"{_k7_route(n, support, _extent(pts), get_device())}", flush=True)


def check_cross_knn(name: str, queries: np.ndarray, data: np.ndarray, k: int, library: bool = False,
                    route: str | None = None) -> dict:
    """K8 on queries (m, d) against point sets (S, n, d): the route
    ``nearest_points`` takes for the shape (``route`` forces ``grid`` or
    ``scan``) against the plain version, indices and distances bitwise
    (held as one tensor), and the other route bitwise against it; given
    ``library``, ``torch.cdist`` + ``torch.topk`` as the yardstick (S = 1).
    The bound counts what these inputs need: the queries, points and
    outputs moved once, or the tests that the grid's exact stopping rule
    makes at these inputs (the kernel's own count, from one call with
    ``stats``), 3d operations each. Its ``[diag]`` line: the grid, the
    tests and rings a query, the queries that scanned every point, the
    device time of the grid, the queries' sort and the search, both routes'
    times, and the brute-force bound (every pair) beside the new one."""
    import torch

    from squidpy_torch.ops.knn import _k8_route, _nearest_grid, _nearest_plain, _nearest_scan, nearest_points

    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).cuda()
    x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).cuda()
    x = x[None] if x.ndim == 2 else x
    n_sets, n, dim = x.shape
    m = q.shape[0]
    pairs = n_sets * m * n
    taken = route or _k8_route(n_sets, m, n, k)
    routes = {"grid": _nearest_grid, "scan": _nearest_scan}
    kernel = nearest_points if route is None else routes[route]

    def pack(out):  # distances and indices side by side, compared at once (int32 indices are exact in float64)
        return torch.cat([out[0].to(torch.float64), out[1].to(torch.float64)], dim=-1)

    lib = None
    if library:
        def lib():
            return torch.topk(torch.cdist(q, x[0]), k, dim=1, largest=False, sorted=True)

    stats: dict = {}
    _nearest_grid(q, x, k, stats)
    if stats["host_syncs"] != 1:
        raise AssertionError(f"cross_knn {name}: {stats['host_syncs']} host syncs, expected 1 (the grid's bounds)")
    route_ms = {r: _time_ms(lambda: fn(q, x, k), 3)[1] for r, fn in routes.items()}
    nbytes = (q.numel() + x.numel()) * 4 + n_sets * m * k * 8
    bound = _bound(nbytes, stats["tests"] * 3 * dim)
    brute = _bound(nbytes, pairs * (3 * dim - 1 + 1))
    walked = max(stats["queries"] - stats["scanning"], 1)
    print(f"[diag] cross_knn {name}: route={taken} grid_route_ms={route_ms['grid']:.4f} "
          f"scan_route_ms={route_ms['scan']:.4f} side={stats['side']!r} dims={stats['dims']} "
          f"cells={stats['cells']} (a set's) points={stats['points']} tests={stats['tests']} "
          f"tests/query mean={stats['tests'] / stats['queries']:.2f} max={stats['most_tests']} "
          f"rings/query mean={stats['rings'] / walked:.3f} max={stats['most_rings']} "
          f"scanning queries={stats['scanning']} grid_ms={stats['grid_ms']:.4f} "
          f"query_sort_ms={stats['query_sort_ms']:.4f} search_ms={stats['search_ms']:.4f} "
          f"bound_ms={bound[0]:.4f} ({bound[1]}) brute_force_bound_ms={brute[0]:.4f} ({brute[1]}, every pair)",
          flush=True)
    result = _compare(f"cross_knn {name} ({taken}) S={n_sets} m={m} n={n} k={k} pairs={pairs:.3e} "
                      f"tests={stats['tests']:.3e}", lambda: pack(kernel(q, x, k)),
                      lambda: pack(_nearest_plain(q, x, k)), repeats=3, bound=bound, library=lib)
    (got_d, got_i), (oth_d, oth_i) = (fn(q, x, k) for fn in (routes[taken], routes["scan" if taken == "grid" else "grid"]))
    if not (torch.equal(got_i, oth_i) and torch.equal(got_d.view(torch.int32), oth_d.view(torch.int32))):
        raise AssertionError(f"cross_knn {name}: the grid and the scan routes differ")
    return result


def ripley_kernel_checks(adata: StandIn) -> dict[str, list[dict]]:
    """Part d's kernels on its own inputs: K8 on one G-mode cluster (first
    with the queries cut, so that ``torch.cdist`` + ``torch.topk`` fit beside
    it, then on all of them), on the F and on the G envelope (all clouds and
    queries); K7 on one dense cluster (and its ``[diag]`` split), on the L
    envelope and on the 200k cluster (the plain version not warmed); K1's
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
    checks["cross_knn"].append(check_cross_knn("G largest cluster, all queries", coords[codes != 0],
                                               coords[codes == 0], RIPLEY_NEIGH))
    checks["cross_knn"].append(check_cross_knn("F cluster 1 (observed)", ref, dense, RIPLEY_NEIGH))
    checks["cross_knn"].append(check_cross_knn("F envelope", ref, clouds, 1))
    checks["cross_knn"].append(check_cross_knn("G envelope", coords, clouds, 1))
    checks["ripley_pairs"].append(check_ripley_pairs("L cluster 1", dense[None], support))
    ripley_pairs_split(dense, support)
    checks["ripley_pairs"].append(check_ripley_pairs("L envelope", clouds, support))
    checks["ripley_pairs"].append(check_ripley_pairs("L largest cluster", coords[codes == 0][None], support,
                                                     plain_warm=False))

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
    """K7 and K8 in the branches part d does not take: K7 with coincident
    points (every pair in one slot, two sets, so the counters flush on the
    change of set), at n = 1, 2, 511, 513, one past the 1024-point column
    tile (1025) and past four (4097), with NaN coordinates, in 1D, 3D and
    at a runtime dimension (5), on 100 random clouds of 1000 points, and
    on the path of large L: one shared L-bin copy (8000 thresholds), the
    thresholds in global memory too (30,000) and global atomics (60,000);
    K8 with coincident points (ties), in 3D,
    at a runtime dimension (4 and 1), above its 32-key register list
    (k = 40, and k = n = 64), and on the inputs of
    ``k8_adversarial_cases``."""
    rng = np.random.default_rng(14)
    coincident = np.repeat(rng.uniform(0, 100, (2, 1, 2)), 3000, axis=1)
    nan = rng.uniform(0, 100, (1, 3000, 2))
    nan[0, rng.integers(0, 3000, 40), rng.integers(0, 2, 40)] = np.nan
    k7 = [("coincident", coincident, 50)] + [(f"n={n}", rng.uniform(0, 100, (1, n, 2)), 50)
                                             for n in (1, 2, 511, 513, 1025, 4097)]
    k7 += [("NaN coordinates", nan, 50), ("1D", rng.uniform(0, 100, (2, 1500, 1)), 9),
           ("3D", rng.uniform(0, 100, (2, 1500, 3)), 9), ("5D", rng.uniform(0, 100, (1, 700, 5)), 40),
           ("100 clouds", rng.uniform(0, 100, (100, 1000, 2)), 50),
           ("one shared histogram", rng.uniform(0, 100, (1, 1025, 2)), 8000),
           ("thresholds in global memory", rng.uniform(0, 100, (1, 1025, 2)), 30_000),
           ("global atomics", rng.uniform(0, 100, (1, 600, 2)), 60_000)]
    checks = {"ripley_pairs": [check_ripley_pairs(name, pts, np.linspace(0, 80, n_thr)) for name, pts, n_thr in k7]}
    k8 = [("ties", 300, (1, 250, 3), 7), ("4D", 300, (1, 500, 4), 3), ("1D", 1000, (1, 33, 1), 33),
          ("global list, ties", 200, (2, 150, 2), 40), ("global list, k = n", 130, (1, 32, 2), 64)]
    checks["cross_knn"] = []
    for name, m, (n_sets, half, dim), k in k8:
        data = rng.uniform(0, 100, (n_sets, half, dim))
        if "ties" in name or "k = n" in name:
            data = np.repeat(data, 2, axis=1)  # every point twice
        checks["cross_knn"].append(check_cross_knn(name, rng.uniform(0, 100, (m, dim)), data, k))
    from squidpy_torch.ops import knn

    for name, queries, data, k in k8_adversarial_cases():  # small: the scan's side, so the grid is forced
        if "no margin" in name:  # the ring bound can then equal a point's d2: the strict test must keep walking
            margin, knn._GAP_MARGIN = knn._GAP_MARGIN, 0.0
            try:
                checks["cross_knn"].append(check_cross_knn(name, queries, data, k, route="grid"))
            finally:
                knn._GAP_MARGIN = margin
        else:
            checks["cross_knn"].append(check_cross_knn(name, queries, data, k, route="grid"))
    return checks


def _boundary_ties(side_cells: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """``2 L^2`` points whose box is [0, L]^2 (L = ``side_cells``), so K8's
    grid has a side of exactly 1: points on the cell boundaries x = 1..L-1
    along the row y = L/2 + 1/2 and y = 1..L-1 along the column x = L/2 +
    1/2, queries at the cells' centres between them (each has two nearest
    points at exactly 0.5, one in its own cell and one on the next ring's
    boundary), the rest of the points 2 or more from every query, the rows
    shuffled."""
    mid = side_cells / 2 + 0.5
    n = 2 * side_cells**2
    edges = [(x, mid) for x in range(1, side_cells)] + [(mid, y) for y in range(1, side_cells)]
    corners = [(0.0, 0.0), (side_cells, 0.0), (0.0, side_cells), (side_cells, side_cells)]
    fill = rng.uniform(0, side_cells, (4 * n, 2))
    fill = fill[(np.abs(fill - mid) >= 2.5).all(axis=1)][: n - len(edges) - len(corners)]
    data = np.concatenate([np.array(edges + corners, np.float64), fill])[rng.permutation(n)]
    queries = [(x + 0.5, mid) for x in range(1, side_cells - 1)] + [(mid, y + 0.5) for y in range(1, side_cells - 1)]
    return np.array(queries), data


def k8_adversarial_cases() -> list[tuple[str, np.ndarray, np.ndarray, int]]:
    """K8's grid search on inputs built to break it, at a few thousand
    points: ties across cell boundaries with the lower index a ring out
    (also with the ring bound's margin set to 0, so the bound meets a
    point's d2 exactly), coincident points, every point at one place,
    queries outside the points' box, clusters with empty space between
    them, k above a 3 x 3 block's points and above the register list, 1D,
    3D and 4D (a non-finite coordinate off the grid's axes), NaN and
    infinite points and queries, coordinates near 1e19 whose d2 overflow,
    one point, k = n, and five sets at once."""
    rng = np.random.default_rng(15)
    ties_q, ties = _boundary_ties(40, rng)
    uniform = rng.uniform(0, 100, (3000, 2))
    clusters = np.concatenate([rng.normal(0, 0.01, (1500, 2)), rng.normal(1000, 0.01, (1500, 2))])
    nonfinite = rng.uniform(0, 50, (3000, 2))
    nonfinite[rng.choice(3000, 30, replace=False)] = np.nan
    nonfinite[rng.choice(3000, 20, replace=False), 1] = np.inf
    nonfinite[rng.choice(3000, 20, replace=False), 0] = -np.inf
    nan_queries = rng.uniform(-10, 60, (2000, 2))
    nan_queries[rng.choice(2000, 20, replace=False)] = np.nan
    nan_queries[rng.choice(2000, 10, replace=False), 1] = np.inf
    four = rng.uniform(0, 20, (3000, 4))
    four[rng.choice(3000, 20, replace=False), 3] = np.nan
    four_q = rng.uniform(0, 20, (1000, 4))
    four_q[rng.choice(1000, 10, replace=False), 3] = np.inf
    huge = rng.uniform(-1e19, 1e19, (2000, 2))
    huge[:50] = rng.uniform(0, 1, (50, 2))
    sets = rng.uniform(0, 100, (5, 2000, 2))
    sets[2, :7] = np.nan
    return [
        ("ties across cell boundaries", ties_q, ties, 1),
        ("ties across cell boundaries, no margin", ties_q, ties, 1),
        ("ties across cell boundaries, k = 3", ties_q, ties, 3),
        ("coincident points", rng.uniform(0, 100, (2000, 2)), np.repeat(rng.uniform(0, 100, (1500, 2)), 2, 0), 3),
        ("every point at one place", rng.uniform(0, 5, (500, 2)), np.full((2000, 2), 2.5), 4),
        ("queries outside the box", rng.uniform(-300, 400, (2000, 2)), uniform, 2),
        ("clusters far apart", rng.uniform(-100, 1100, (1000, 2)), clusters, 2),
        ("k above the 3 x 3 block", rng.uniform(0, 100, (1000, 2)), uniform, 30),
        ("k above the register list", rng.uniform(0, 100, (1000, 2)), uniform, 40),
        ("1D", rng.uniform(-10, 210, (2000, 1)), rng.uniform(0, 200, (3000, 1)), 5),
        ("3D", rng.uniform(0, 30, (2000, 3)), rng.uniform(0, 30, (4000, 3)), 7),
        ("4D, non-finite off the grid", four_q, four, 3),
        ("NaN and inf points", rng.uniform(-10, 60, (2000, 2)), nonfinite, 3),
        ("NaN and inf queries", nan_queries, nonfinite, 2),
        ("coordinates near 1e19", rng.uniform(-1e19, 1e19, (500, 2)), huge, 3),
        ("coordinates near 1e19, the k-th d2 overflows", rng.uniform(-1e19, 1e19, (500, 2)),
         rng.uniform(-1e19, 1e19, (30, 2)), 30),
        ("one point", rng.uniform(0, 10, (500, 2)), np.array([[3.0, 4.0]]), 1),
        ("k = n", rng.uniform(0, 10, (100, 2)), rng.uniform(0, 10, (500, 2)), 500),
        ("five sets", rng.uniform(-5, 105, (2000, 2)), sets, 1),
    ]


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


def _ligrec_dataset(n: int, n_genes: int, seed: int, integral: bool = True) -> StandIn:
    """Part e's container: ``(n, n_genes)`` Poisson(1.2) counts as uint8,
    drawn on the card from a seeded generator (or, not ``integral``, those
    counts times lognormal float32 factors, as normalised data), and
    ``LIGREC_CLS`` uniform clusters from the seed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.poisson(torch.full((n, n_genes), 1.2, device="cuda"), generator=gen).clamp_(max=255)
    if integral:
        x = x.to(torch.uint8)
    else:
        x = (x * torch.exp(0.5 * torch.randn(x.shape, device="cuda", generator=gen))).to(torch.float32)
    codes = np.random.default_rng(seed).integers(0, LIGREC_CLS, size=n)
    adata = StandIn(np.zeros((n, 2)), codes, LIGREC_CLS)
    adata.X = x.cpu().numpy()
    adata.var_names = [f"G{i}" for i in range(n_genes)]
    return adata


def _ligrec_interactions(adata: StandIn) -> list[tuple[str, str]]:
    """``examples/ligrec_1m.py``'s interactions: the first 32 genes against the next 32."""
    from itertools import product

    genes = adata.var_names[:64]
    return list(product(genes[:32], genes[32:64]))


def _check_ligrec(res, n_inter: int, n_pairs: int, n_perms: int) -> None:
    """What a ``ligrec`` call returned: the shapes, finite non-negative means,
    p-values on the grid k / n_perms in [0, 1] and NaN exactly off the
    entries with both means positive (the threshold mask is all true here)."""
    means, pvalues = res.means.values, res.pvalues.values
    if means.shape != (n_inter, n_pairs) or pvalues.shape != (n_inter, n_pairs):
        raise AssertionError(f"ligrec: wrong shapes {means.shape}, {pvalues.shape}")
    if len(res.means.index) != n_inter or len(res.means.columns) != n_pairs:
        raise AssertionError("ligrec: wrong index or columns")
    if not (np.isfinite(means).all() and (means >= 0).all()):
        raise AssertionError("ligrec: means not finite and non-negative")
    finite = np.isfinite(pvalues)
    if not np.array_equal(finite, means > 0):
        raise AssertionError("ligrec: NaN p-values off the zero means")
    k = pvalues[finite] * n_perms
    if not (np.all(k >= 0) and np.all(k <= n_perms) and np.array_equal(k, np.round(k))):
        raise AssertionError("ligrec: p-values not on the grid k / n_perms in [0, 1]")


def ligrec_path() -> tuple[StandIn, dict, dict]:
    """Part e: ``examples/ligrec_1m.py``'s workload at full size. 1M cells x
    380 genes of Poisson(1.2) counts (uint8), 16 clusters, 1024 interactions,
    1000 permutations, threshold 0.01: the device expression handle made
    first, then two ``ligrec`` calls (seeds 0 and 1), the second under the
    CPU profiler (its ``[host]`` line splits the call by its ranges), with
    the counters reset before them and read after; then checks of what they
    returned. Returns the container, the launches and the seconds."""
    import squidpy_torch as sqt
    from squidpy_torch import _cuda
    from squidpy_torch._core.device_x import device_expression

    t0 = time.perf_counter()
    adata = _ligrec_dataset(LIGREC_CELLS, LIGREC_GENES, seed=21)
    secs = {"setup_s": time.perf_counter() - t0}
    interactions = _ligrec_interactions(adata)
    _, secs["handle_s"] = _sync_time(lambda: device_expression(adata))
    _cuda.reset_launches()
    call = dict(interactions=interactions, n_perms=LIGREC_PERMS, use_raw=False, copy=True, threshold=0.01)
    res, secs["ligrec_seed0_s"] = _sync_time(lambda: sqt.gr.ligrec(adata, "cluster", seed=0, **call))
    res1, wall, steps = _profiled(lambda: sqt.gr.ligrec(adata, "cluster", seed=1, **call), "ligrec")
    secs["ligrec_seed1_s"] = wall
    launches = dict(_cuda.launches)
    print(f"[host] ligrec n={LIGREC_CELLS} perms={LIGREC_PERMS}: wall={1e3 * wall:.1f}ms "
          + " ".join(f"{k}={v:.1f}ms" for k, v in steps.items()), flush=True)
    for r in (res, res1):
        _check_ligrec(r, len(interactions), LIGREC_CLS**2, LIGREC_PERMS)
    if not np.array_equal(res.means.values, res1.means.values):
        raise AssertionError("ligrec: the observed means depend on the seed")
    if np.array_equal(res.pvalues.values, res1.pvalues.values, equal_nan=True):
        raise AssertionError("ligrec: two seeds gave the same p-values")
    handle = device_expression(adata, create=False)
    if handle is None or handle.ship_count != 1:
        raise AssertionError("ligrec: the expression handle was not reused")
    return adata, launches, secs


def _ligrec_inputs(adata: StandIn, seed: int = 0):
    """Part e's own device inputs as ``ligrec`` builds them for its first
    permutation chunk: the float32 gene block, the codes, the interactions'
    columns, the cluster pairs, the counts, ``m_sum``, the chunk's keys and
    its shuffled uint8 labels (K10's rows, padded to ``label_stride``)."""
    import torch

    from squidpy_torch._core.device_x import device_expression
    from squidpy_torch._core.rng import _keys_per_chunk, permutation_batch, spawn_keys
    from squidpy_torch.ops.ligrec import cluster_means, label_stride

    x = device_expression(adata).dense_block(np.arange(64))
    codes = np.asarray(adata.obs["cluster"].cat.codes, dtype=np.int64)
    labels = torch.from_numpy(codes).cuda()
    rec = torch.arange(32, device="cuda").repeat_interleave(32).to(torch.int32)
    lig = (32 + torch.arange(32, device="cuda")).repeat(32).to(torch.int32)
    pairs = torch.cartesian_prod(torch.arange(LIGREC_CLS), torch.arange(LIGREC_CLS)).cuda().to(torch.int32)
    c1, c2 = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
    mean = cluster_means(x, labels, LIGREC_CLS).T.double()
    m_sum = (mean[rec.long()][:, c1.long()] + mean[lig.long()][:, c2.long()]).float()
    counts = torch.bincount(labels, minlength=LIGREC_CLS).float()
    n = len(codes)
    keys = spawn_keys(seed, LIGREC_PERMS)[: _keys_per_chunk(n, torch.device("cuda"))]
    out = torch.full((len(keys), label_stride(n)), 255, dtype=torch.uint8, device="cuda")
    shuffled = permutation_batch(keys, n, torch.device("cuda"), payload=labels.to(torch.uint8), out=out)
    return x, labels, (rec, lig, c1, c2), counts, m_sum, keys, shuffled


INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core operations


def _ligrec_bound(n: int, n_genes: int, n_perms: int, n_inter: int, n_pairs: int, itemsize: int, n_cls: int,
                  integral: bool) -> tuple[float, str]:
    # X read once (uint8 on the integral route) and the (P, n) uint8 labels
    # once, the (I, J) int64 counts written once; a permutation's (I, J)
    # multiply, fma and compare; the sums: an add a cell, gene and
    # permutation (float route) or the one-hot product's int8 operations on
    # the tensor cores, 2 n G P 16 ceil(C / 16) (integral route)
    nbytes = n * n_genes * (1 if integral else itemsize) + float(n_perms) * n + 8.0 * n_inter * n_pairs
    compare = 3.0 * n_inter * n_pairs * n_perms / F32_OPS_PER_S
    sums = (2.0 * n * n_genes * n_perms * 16 * -(-n_cls // 16) / INT8_OPS_PER_S if integral
            else float(n) * n_genes * n_perms / F32_OPS_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, sums + compare
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_ligrec_perms(name: str, x, shuffled, counts, idx, m_sum, n_cls: int, plain_warm: bool = True,
                       library: bool = False, chunk_size: int | None = None, route: str | None = None) -> dict:
    """K9 against its plain version on the same card tensors, bitwise, by
    ``route`` (the route rule's when None, printed); with ``library`` also
    JAX's form of the sums, the one-hot product over the chunk with TF32
    off, as the yardstick."""
    import torch

    from squidpy_torch.ops.ligrec import _k9_route, ligrec_perm_counts, ligrec_perm_counts_plain

    from squidpy_torch.ops.ligrec import counts_operand

    rec, lig, c1, c2 = idx
    n = x.shape[0]
    route = route or _k9_route(x, n_cls)
    xt = counts_operand(x) if route == "integral" else None  # once a call, as `ligrec` makes it
    lib = None
    if library:
        onehot = torch.zeros((n, shuffled.shape[0] * n_cls), dtype=x.dtype, device=x.device)
        cols = shuffled[:, :n].long().T + n_cls * torch.arange(shuffled.shape[0], device=x.device)[None, :]
        onehot.scatter_(1, cols, 1.0)

        def lib():
            return onehot.T @ x
    return _compare(
        f"{name} [{route} route]",
        lambda: ligrec_perm_counts(x, shuffled, counts, rec, lig, c1, c2, m_sum, n_cls, chunk_size=chunk_size,
                                   route=route, xt=xt),
        lambda: ligrec_perm_counts_plain(x, shuffled, counts, rec, lig, c1, c2, m_sum, n_cls, route=route),
        3, _ligrec_bound(n, x.shape[1], shuffled.shape[0], len(rec), len(c1), x.element_size(), n_cls,
                         route == "integral"),
        plain_warm=plain_warm, library=lib,
    )


WORD_OPS = 90.0  # 32-bit operations a threefry word


def _threefry_bound(n_keys: int, n: int) -> tuple[float, str]:
    # 4 bytes written a word; ~90 32-bit operations a word (the key schedule,
    # 20 rounds of add, rotate, xor, five key injections, the final xors)
    return _bound(4.0 * n_keys * n + 8.0 * n_keys, WORD_OPS * n_keys * n)


def check_threefry(name: str, keys, n: int, flip: bool = True, repeats: int = 3) -> dict:
    """K10's word entry against its plain version on the same card keys, bitwise."""
    import torch

    from squidpy_torch._core.rng import _threefry_plain, threefry_bits

    keys_t = torch.from_numpy(np.ascontiguousarray(np.asarray(keys, np.uint32).reshape(-1, 2)).view(np.int32)).cuda()
    return _compare(name, lambda: threefry_bits(keys_t, n, flip=flip), lambda: _threefry_plain(keys_t, n, flip),
                    repeats, _threefry_bound(keys_t.shape[0], n))


def _shuffle_bound(rows: int, n: int, rounds: int, out_bytes: int, payload_bytes: int) -> tuple[float, str]:
    # the function's least work: one word an item a round; the output
    # written once, the payload read once
    return _bound(float(rows) * n * out_bytes + n * payload_bytes + 8.0 * rows * rounds, WORD_OPS * rows * n * rounds)


def _shuffle_floor(rows: int, n: int, rounds: int, out_bytes: int) -> tuple[float, str]:
    # this design's own floor: two words an item a round (histogram and
    # scatter), the scatter's 8-byte keys written and read back, each
    # round's output written once and gathered by the next
    nbytes = float(rows) * n * (16.0 * rounds + out_bytes * (2.0 * rounds - 1))
    return _bound(nbytes, 2 * WORD_OPS * rows * n * rounds)


def _library_shuffle(subs, n: int, payload):
    """The words-and-sorts path: K10's word entry, ``torch.sort(stable=True)``
    and gathers (the yardstick of the shuffle)."""
    import torch

    from squidpy_torch._core.rng import random_bits_device

    perm = None
    for sub in subs:
        order = torch.sort(random_bits_device(sub, n, torch.device("cuda"), sort_keys=True), dim=1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, 1, order)
    return payload[perm] if payload is not None else perm.to(torch.int32)


def check_shuffle(name: str, keys, n: int, payload=None, mask: int | None = None, library: bool = False,
                  repeats: int = 3, plain_warm: bool = True) -> dict:
    """K10's shuffle (``_core/rng.py`` ``_shuffle``: JAX's rounds for n, or
    one round of the keys themselves when ``keys`` is a list of subkeys)
    against its plain version on the card (words, ``torch.sort``, gathers),
    bitwise; with ``library``, the words-and-sorts path (K10's words, ``torch.sort``,
    gathers) as the yardstick."""
    import torch

    from squidpy_torch._core import rng

    subs = keys if isinstance(keys, list) else rng._round_keys(np.asarray(keys, np.uint32), rng._rounds(n))
    rows = len(keys) if not isinstance(keys, list) else subs[0].shape[0]
    dtype = payload.dtype if payload is not None else torch.int32
    mask = rng._FULL_MASK if mask is None else mask
    out_k = torch.empty((rows, n), dtype=dtype, device="cuda")
    out_p = torch.empty((rows, n), dtype=dtype, device="cuda")
    lib = (lambda: _library_shuffle(subs, n, payload)) if library else None
    out_bytes = out_k.element_size()
    return _compare(name, lambda: rng._shuffle(subs, n, torch.device("cuda"), payload, out_k, mask=mask),
                    lambda: rng._shuffle_plain(subs, n, payload, out_p, mask), repeats,
                    _shuffle_bound(rows, n, len(subs), out_bytes, payload.element_size() if payload is not None else 0),
                    plain_warm=plain_warm, library=lib)


def shuffle_split(labels, keys) -> None:
    """``[diag] shuffle``: one K10 chunk of part e (two rounds, uint8
    labels) with each step timed by CUDA events: histogram, scan, scatter,
    sort (its epilogue fused: round 1 writes int32 positions, round 2 the
    labels through round 1's), the buckets, the largest bucket and the
    overflowing buckets a round; the function's bound and this design's
    floor."""
    import torch

    from squidpy_torch._core import rng
    from squidpy_torch.ops.ligrec import label_stride

    n = labels.shape[0]
    subs = rng._round_keys(np.asarray(keys, np.uint32), rng._rounds(n))
    out = torch.full((len(keys), label_stride(n)), 255, dtype=torch.uint8, device="cuda")
    payload = labels.to(torch.uint8)
    rng._shuffle(subs, n, torch.device("cuda"), payload, out)  # warm
    stats: dict = {}
    rng._shuffle(subs, n, torch.device("cuda"), payload, out, stats=stats)
    bound = _shuffle_bound(len(keys), n, len(subs), 1, 1)
    floor = _shuffle_floor(len(keys), n, len(subs), 1)
    steps = " ".join(f"{k}={'/'.join(f'{v:.3f}' for v in stats[k])}" for k in ("hist_ms", "scan_ms", "scatter_ms",
                                                                                "sort_ms"))
    print(f"[diag] shuffle n={n} keys={len(keys)} rounds={len(subs)} buckets={stats['buckets']} "
          f"(~{n / stats['buckets']:.0f} items a bucket) largest_bucket={stats['largest_bucket']} "
          f"overflow={stats['overflow']} (a round each) {steps}; bound_ms={bound[0]:.4f} ({bound[1]}: one word an "
          f"item a round) design_floor_ms={floor[0]:.4f} ({floor[1]}: two words, 8-byte keys)", flush=True)
    if any(stats["overflow"]):
        raise AssertionError("K10: threefry words overflowed a bucket of part e's chunk")


def ligrec_split(x, labels, idx, counts, m_sum, keys, shuffled) -> None:
    """``[diag] ligrec``: the device time of one permutation chunk's steps
    (CUDA events): K10's shuffle (words, bucket sort, the labels), the
    words-and-sorts path for the same labels (K10's words, stable sorts,
    gathers), K9 by
    its integral route and by its float route, and the one-hot product."""
    import torch

    from squidpy_torch._core import rng
    from squidpy_torch.ops.ligrec import _k9_route, counts_operand, ligrec_perm_counts

    n = labels.shape[0]
    payload = labels.to(torch.uint8)
    _, perm_ms = _time_ms(lambda: rng.permutation_batch(keys, n, torch.device("cuda"), payload=payload, out=shuffled),
                          3)
    subs = rng._round_keys(np.asarray(keys, np.uint32), rng._rounds(n))
    _, lib_ms = _time_ms(lambda: _library_shuffle(subs, n, payload), 1)
    route = _k9_route(x, LIGREC_CLS)
    xt = counts_operand(x)
    _, xt_ms = _time_ms(lambda: counts_operand(x), 3)
    _, route_ms = _time_ms(lambda: _k9_route(x, LIGREC_CLS), 3)
    _, int_ms = _time_ms(lambda: ligrec_perm_counts(x, shuffled, counts, *idx, m_sum, LIGREC_CLS, route="integral",
                                                    xt=xt), 3)
    _, float_ms = _time_ms(lambda: ligrec_perm_counts(x, shuffled, counts, *idx, m_sum, LIGREC_CLS, route="float"), 3)
    b_int = _ligrec_bound(n, x.shape[1], len(keys), len(idx[0]), len(idx[2]), 4, LIGREC_CLS, True)
    b_float = _ligrec_bound(n, x.shape[1], len(keys), len(idx[0]), len(idx[2]), 4, LIGREC_CLS, False)
    chunks = -(-LIGREC_PERMS // len(keys))
    k9_ms = int_ms if route == "integral" else float_ms
    print(f"[diag] ligrec n={n} chunk={len(keys)} keys ({chunks} chunks a call): permutation_ms={perm_ms:.3f} (K10) "
          f"sort_path_ms={lib_ms:.3f} (words, torch.sort, gathers) route={route} (rule {route_ms:.3f} ms, uint8 "
          f"copy {xt_ms:.3f} ms, once a call) k9_integral_ms={int_ms:.3f} (bound {b_int[0]:.4f}, {b_int[1]}) "
          f"k9_float_ms={float_ms:.3f} (bound {b_float[0]:.4f}, {b_float[1]}); "
          f"a call's device time ~{chunks * (perm_ms + k9_ms):.1f} ms", flush=True)


def k9_layout_diag(x, shuffled, counts, idx, m_sum) -> None:
    """``[diag] k9_layout``: K9 on part e's chunk with each block layout of
    each route (warps, permutations a warp), the one the wrapper picks
    first, each bitwise equal to it."""
    import torch

    from squidpy_torch.ops import ligrec as ops

    own, own_mma = ops._k9_layout, ops._K9_MMA_LAYOUT
    xt = ops.counts_operand(x)
    want, lines = None, []
    try:
        picked = own(LIGREC_CLS, x.element_size())
        times = []
        for layout in (picked, (4, 1), (8, 1), (4, 2), (8, 4), (4, 8)):
            ops._k9_layout = lambda n_cls, itemsize, layout=layout: layout
            got, ms = _time_ms(lambda: ops.ligrec_perm_counts(x, shuffled, counts, *idx, m_sum, LIGREC_CLS,
                                                              route="float"), 3)
            want = got if want is None else want
            if not torch.equal(got, want):
                raise AssertionError(f"K9 float layout {layout} disagrees with {picked}")
            times.append(f"{layout[0]}x{layout[1]}={ms:.3f}ms")
        lines.append(f"float (picked {picked[0]}x{picked[1]}): " + " ".join(times))
        times = []
        for layout in (own_mma, (4, 1), (4, 4), (8, 2), (2, 4), (8, 1)):
            ops._K9_MMA_LAYOUT = layout
            got, ms = _time_ms(lambda: ops.ligrec_perm_counts(x, shuffled, counts, *idx, m_sum, LIGREC_CLS,
                                                              route="integral", xt=xt), 3)
            if not torch.equal(got, want):
                raise AssertionError(f"K9 integral layout {layout} disagrees with the float route")
            times.append(f"{layout[0]}x{layout[1]}={ms:.3f}ms")
        lines.append(f"integral (picked {own_mma[0]}x{own_mma[1]}): " + " ".join(times))
    finally:
        ops._k9_layout, ops._K9_MMA_LAYOUT = own, own_mma
    print("[diag] k9_layout (warps x permutations a warp) " + "; ".join(lines), flush=True)


def ligrec_kernel_checks(adata: StandIn) -> dict[str, list[dict]]:
    """K9 on part e's first permutation chunk by the integral route the
    route rule takes (with the one-hot product as the yardstick of its
    sums; ``[diag] k9_layout`` holds the float route's layouts to it), and
    by the float route on fractional data made from it; K10's shuffle of
    that chunk (with the words-and-sorts path as the yardstick) and its
    words alone; each against its plain version; then the ``[diag] k9_layout``, ``[diag] shuffle`` and
    ``[diag] ligrec`` lines."""
    import torch

    from squidpy_torch._core.rng import split_keys
    from squidpy_torch.ops.ligrec import _k9_route

    x, labels, idx, counts, m_sum, keys, shuffled = _ligrec_inputs(adata)
    n_keys = len(keys)
    if _k9_route(x, LIGREC_CLS) != "integral":
        raise AssertionError("K9: part e's counts do not take the integral route")
    checks = {"ligrec_perms": [check_ligrec_perms(f"ligrec_perms part e ({n_keys} permutations)", x, shuffled,
                                                  counts, idx, m_sum, LIGREC_CLS, plain_warm=False, library=True)]}
    gen = torch.Generator(device="cuda").manual_seed(5)
    frac = x * torch.exp(0.5 * torch.randn(x.shape, device="cuda", generator=gen))
    checks["ligrec_perms"].append(check_ligrec_perms(
        f"ligrec_perms part e fractional ({n_keys} permutations)", frac, shuffled, counts, idx, m_sum, LIGREC_CLS,
        plain_warm=False))
    del frac
    checks["threefry_shuffle"] = [check_shuffle(f"threefry_shuffle part e ({n_keys} keys x {labels.shape[0]}, "
                                                f"uint8 labels)", keys, labels.shape[0],
                                                payload=labels.to(torch.uint8), library=True, plain_warm=False)]
    _, sub = np.moveaxis(split_keys(keys), -2, 0)
    checks["threefry_shuffle"].append(check_threefry(f"threefry_bits part e ({n_keys} keys x {labels.shape[0]})", sub,
                                                     labels.shape[0]))
    k9_layout_diag(x, shuffled, counts, idx, m_sum)
    shuffle_split(labels, keys)
    ligrec_split(x, labels, idx, counts, m_sum, keys, shuffled)
    return checks


def ligrec_branch_checks() -> dict[str, list[dict]]:
    """K9 and K10 in the branches part e does not take, each bitwise against
    its plain version: float64, 2 and 100 clusters, an odd cell count, a
    cluster with no cells, labels outside [0, C), fractional data, a
    permutation count that is not a multiple of the launch's chunk, cells
    not a multiple of the slab, each by the route the rule takes and, on
    counts, by the float route too; K10's shuffle at n = 1, 1625, 1626 (two
    rounds from here), 65,537, and ~2.7M cells with 4 keys (three rounds),
    as int32 positions and as a payload; one round of 500 keys as
    ``permutation_columns`` draws it (uint8 values); ties (4096 and 2
    distinct words) and every word equal with the local sort's capacity
    lowered (the overflow path); K10's words at n = 1, 1625, 1626, 65,537
    and 1M, unflipped, and with more keys than the grid's rows."""
    import torch

    from squidpy_torch._core import rng as trng

    rng = np.random.default_rng(31)
    out: dict[str, list[dict]] = {"ligrec_perms": [], "threefry_shuffle": []}

    def case(name, n, g, n_cls, n_perms, dtype=torch.float32, frac=False, empty=False, outside=False,
             chunk_size=None, n_inter=40):
        x = rng.poisson(1.2, (n, g)).astype(np.float64)
        if frac:
            x = x * rng.lognormal(0.0, 0.5, x.shape)
        lab = rng.integers(0, n_cls - 1 if empty else n_cls, n)
        sh = np.stack([rng.permutation(lab) for _ in range(n_perms)]).astype(np.int32)
        if outside:
            sh[:, ::7] = rng.choice([-1, n_cls, n_cls + 5], size=sh[:, ::7].shape)
        rec, lig = rng.integers(0, g, n_inter), rng.integers(0, g, n_inter)
        pairs = rng.integers(0, n_cls, (min(n_cls * n_cls, 64), 2))
        counts = np.bincount(lab, minlength=n_cls).astype(np.float64)
        mean = (x.T @ np.eye(n_cls)[lab]) / np.maximum(counts, 1)
        m_sum = mean[rec[:, None], pairs[None, :, 0]] + mean[lig[:, None], pairs[None, :, 1]]
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).cuda().to(dt)  # noqa: E731
        idx = tuple(t(a, torch.int32) for a in (rec, lig, pairs[:, 0], pairs[:, 1]))
        args = (t(x, dtype), t(sh, torch.int32), t(counts, dtype), idx, t(m_sum, dtype), n_cls)
        out["ligrec_perms"].append(check_ligrec_perms(f"ligrec_perms {name}", *args, plain_warm=False,
                                                      chunk_size=chunk_size))
        if not frac:
            out["ligrec_perms"].append(check_ligrec_perms(f"ligrec_perms {name}", *args, plain_warm=False,
                                                          chunk_size=chunk_size, route="float"))

    case("float64, 5000 cells x 24 genes, C=6, P=17", 5000, 24, 6, 17, dtype=torch.float64)
    case("C=2, 4097 cells x 40 genes, P=9", 4097, 40, 2, 9)
    case("C=100, 20,001 cells x 33 genes, P=10", 20_001, 33, 100, 10)
    case("C=100 float64, 3001 cells x 7 genes, P=5", 3001, 7, 100, 5, dtype=torch.float64)
    case("C=20, 40,000 cells (3 slabs) x 70 genes (2 gene tiles), P=13", 40_000, 70, 20, 13)
    case("a cluster without cells, 3333 cells x 64 genes, C=8, P=12", 3333, 64, 8, 12, empty=True)
    case("labels outside [0, C), 2500 cells, C=5, P=6", 2500, 16, 5, 6, outside=True)
    case("fractional float32, 10,000 cells x 48 genes, C=16, P=24", 10_000, 48, 16, 24, frac=True)
    case("fractional float64, 6000 cells x 20 genes, C=7, P=11", 6000, 20, 7, 11, dtype=torch.float64, frac=True)
    case("P=19 in launches of 4, 2049 cells x 65 genes, C=16", 2049, 65, 16, 19, chunk_size=4)
    case("1626 cells x 3 genes, C=3, P=8", 1626, 3, 3, 8)
    labels = torch.from_numpy(rng.integers(0, 16, 2_700_000).astype(np.uint8)).cuda()
    for n, n_keys in ((1, 64), (1625, 64), (1626, 64), (65_537, 64), (2_700_000, 4)):
        keys = trng.spawn_keys(n, n_keys)
        out["threefry_shuffle"].append(check_shuffle(f"threefry_shuffle {n_keys} keys x {n} ({trng._rounds(n)} "
                                                     f"rounds)", keys, n))
        out["threefry_shuffle"].append(check_shuffle(f"threefry_shuffle {n_keys} keys x {n}, uint8 labels", keys, n,
                                                     payload=labels[:n]))
    cols = [trng.spawn_keys(77, 500)]
    out["threefry_shuffle"].append(check_shuffle("threefry_shuffle permutation_columns round, 500 keys x 60,000",
                                                 cols, 60_000, payload=labels[:60_000]))
    for mask, cap, n in ((0xFFF00000, None, 1_000_000), (0x80000000, None, 60_000), (0, 4096, 40_000),
                         (0, 64, 10_000), (trng._FULL_MASK, 512, 1_000_000)):
        own = trng._SORT_CAP
        trng._SORT_CAP = cap or own
        try:
            out["threefry_shuffle"].append(check_shuffle(
                f"threefry_shuffle 8 keys x {n}, words & {mask:#010x}, capacity {trng._SORT_CAP}", trng.spawn_keys(n, 8),
                n, mask=mask, repeats=1))
        finally:
            trng._SORT_CAP = own
    keys = rng.integers(0, 2**32, (64, 2), dtype=np.uint64).astype(np.uint32)
    for n in (1, 1625, 1626, 65_537, 1_000_003):
        out["threefry_shuffle"].append(check_threefry(f"threefry_bits 64 keys x {n}", keys, n))
    out["threefry_shuffle"].append(check_threefry("threefry_bits 64 keys x 4097, words unflipped", keys, 4097,
                                                  flip=False))
    many = rng.integers(0, 2**32, (70_000, 2), dtype=np.uint64).astype(np.uint32)
    out["threefry_shuffle"].append(check_threefry("threefry_bits 70,000 keys x 5 (keys past the grid's rows)", many,
                                                  5))
    return out


def ligrec_reference_check() -> None:
    """``ligrec`` through the public API on the card and on the CPU (plain
    torch) must agree bitwise (means, p-values, index, columns, metadata):
    at 3000 cells x 50 genes of fractional data (the float64 host route; K9
    and its plain version add in one order) with FDR along the clusters, and
    at 70,000 cells x 64 genes of integral counts (the float32 route through
    the device expression handle)."""
    import squidpy_torch as sqt

    t0 = time.perf_counter()
    for n, g, integral, kw in ((3000, 50, False, dict(corr_method="fdr_bh", corr_axis="clusters")),
                               (70_000, 64, True, {})):
        src = _ligrec_dataset(n, g, seed=41 + n, integral=integral)
        interactions = _ligrec_interactions(src)
        out = {}
        for device in ("cuda", "cpu"):
            with sqt.set_device(device):
                adata = StandIn(np.zeros((n, 2)), src.obs["cluster"].cat.codes, LIGREC_CLS)
                adata.X, adata.var_names = src.X, src.var_names
                out[device] = sqt.gr.ligrec(adata, "cluster", interactions=interactions, n_perms=200, seed=3,
                                            use_raw=False, copy=True, **kw)
        gpu, cpu = out["cuda"], out["cpu"]
        for frame in ("means", "pvalues"):
            a, b = getattr(gpu, frame), getattr(cpu, frame)
            if a.index != b.index or a.columns != b.columns:
                raise AssertionError(f"ligrec {frame}: index or columns differ between card and CPU")
            np.testing.assert_array_equal(a.values, b.values, err_msg=f"ligrec {frame} n={n}")
        if not np.isfinite(gpu.pvalues.values).any():
            raise AssertionError(f"ligrec n={n}: no finite p-value")
    print(f"[reference] ligrec at 3000 cells (float64, fractional) and 70,000 (float32, integral): card and CPU "
          f"agree bitwise ({time.perf_counter() - t0:.1f} s)", flush=True)


SECTIONS = 8  # part f1's libraries: contiguous strips of part a's section, 60k-200k cells each
SECTION_PERMS_CPU = 200  # part f1's card-vs-CPU check on a ~100k-cell cut
GROUPED_CHECK_KEYS = 500  # K10's grouped entry held on one 500-permutation chunk, as nhood_enrichment makes it
SEPAL_SIDE, SEPAL_GENES, SEPAL_BUDGET = 1000, 1024, 300  # examples/sepal_scale.py: Visium HD bins, thresh=0
SEPAL_SMALL_SIDE, SEPAL_SMALL_GENES = 316, 256  # its score check, at the default threshold
VISIUM_SPOTS, VISIUM_GENES = 4992, 2000  # a Visium section: hexagonal spots
K11_CHECK_GENES = 64  # K11 held to its plain version by the state after the budget
SEPAL_DT = 0.001


def _sections(coords: np.ndarray, seed: int) -> np.ndarray:
    """Library codes of :data:`SECTIONS` contiguous strips along x, their
    sizes drawn from a seed and each within 60k-200k cells."""
    rng = np.random.default_rng(seed)
    n = len(coords)
    while True:
        w = rng.uniform(0.5, 1.6, SECTIONS)
        sizes = np.floor(w / w.sum() * n).astype(np.int64)
        sizes[-1] += n - sizes.sum()
        if sizes.min() >= 60_000 and sizes.max() <= 200_000:
            break
    codes = np.empty(n, dtype=np.int32)
    codes[np.argsort(coords[:, 0], kind="stable")] = np.repeat(np.arange(SECTIONS), sizes)
    return codes


def sections_path(adata: StandIn) -> tuple[StandIn, dict, dict]:
    """Part f1: part a's 1M cells as a study of 8 sections (libraries of
    unequal size): ``spatial_neighbors_knn(library_key=...)``, then
    ``nhood_enrichment(library_key=..., n_perms=1000)`` twice (seeds 0 and
    1) and once more under the CPU profiler (its ``[host]`` line), the
    counters reset before the calls and read after; then checks of what they
    returned. Returns the study, the launches and the seconds."""
    import squidpy_torch as sqt
    from squidpy_torch import _cuda

    coords = adata.obsm["spatial"]
    codes = _sections(coords, seed=31)
    study = StandIn(coords, np.asarray(adata.obs["cluster"].cat.codes), N_CLS)
    study.obs["library"] = _Categorical(codes, SECTIONS)
    secs = {"sizes": "/".join(map(str, np.bincount(codes)))}
    _, secs["graph_s"] = _sync_time(lambda: sqt.gr.spatial_neighbors_knn(study, n_neighs=N_NEIGHS,
                                                                           library_key="library"))
    adj = study.obsp["spatial_connectivities"].tocoo()
    if adj.nnz != len(codes) * N_NEIGHS or np.any(codes[adj.row] != codes[adj.col]):
        raise AssertionError("the sections' kNN graph has the wrong edge count or edges across sections")
    _cuda.reset_launches()
    call = dict(library_key="library", n_perms=N_PERMS, copy=True)
    res0, secs["nhood_seed0_s"] = _sync_time(lambda: sqt.gr.nhood_enrichment(study, "cluster", seed=0, **call))
    res1, secs["nhood_seed1_s"] = _sync_time(lambda: sqt.gr.nhood_enrichment(study, "cluster", seed=1, **call))
    launches = dict(_cuda.launches)
    _cuda.reset_launches()
    _, secs["nhood_profiled_s"], host = _profiled(lambda: sqt.gr.nhood_enrichment(study, "cluster", seed=3, **call),
                                                  ("nhood_enrichment", "shuffle_group_columns"))
    launches = {k: launches[k] + _cuda.launches[k] for k in launches}
    print(f"[host] nhood_library (8 sections, 1000 permutations, profiled): wall {secs['nhood_profiled_s']:.4f} s; "
          + " ".join(f"{k}={v:.1f}" for k, v in sorted(host.items())) + " (host ms)", flush=True)
    for res in (res0, res1):
        if res.zscore.shape != (N_CLS, N_CLS) or int(res.counts.astype(np.int64).sum()) != adj.nnz:
            raise AssertionError("nhood_enrichment(library_key): wrong shape or observed edge total")
        if not np.isfinite(res.zscore).all():
            raise AssertionError("nhood_enrichment(library_key): non-finite z-scores")
    if not np.array_equal(res0.counts, res1.counts) or np.array_equal(res0.zscore, res1.zscore):
        raise AssertionError("nhood_enrichment(library_key): counts depend on the seed, or z-scores do not")
    return study, launches, secs


def _grouped_bound(rows: int, n: int, out_bytes: int, payload_bytes: int) -> tuple[float, str]:
    # the function's least work: one word an item; the values and the group
    # codes read once, the output written once
    return _bound(float(rows) * n * out_bytes + n * (payload_bytes + 4) + 8.0 * rows, WORD_OPS * rows * n)


def _grouped_floor(rows: int, n: int, key_bytes: int, out_bytes: int, n_starts: int) -> tuple[float, str]:
    # K10g's own floor: one word an item (the scatter), each key written
    # once and read once, the output written once, the bucket starts
    # written once and read once
    nbytes = float(rows) * (n * (2.0 * key_bytes + out_bytes) + 8.0 * n_starts)
    return _bound(nbytes, WORD_OPS * rows * n)


def _library_grouped(keys, lay, vsorted):
    """The sort path of the grouped shuffle: K10's word entry, one
    ``torch.sort(stable=True)`` of the int64 keys (segment << 32) | word, the
    gather of the values and the scatter to the original rows."""
    import torch

    from squidpy_torch._core.rng import random_bits_device

    n = vsorted.shape[0]
    cuda = torch.device("cuda")
    words = random_bits_device(keys, n, cuda).to(torch.int64) & 0xFFFFFFFF
    rank = torch.from_numpy(np.repeat(np.arange(len(lay.starts) - 1), np.diff(lay.starts))).to(cuda)
    idx = torch.sort((rank << 32) | words, dim=1, stable=True).indices
    out = torch.empty((len(keys), n), dtype=vsorted.dtype, device=cuda)
    out[:, torch.from_numpy(lay.order).to(cuda)] = vsorted[idx]
    return out


def check_grouped(name: str, keys, values, groups, library: bool = False, plain_warm: bool = True,
                  mask: int | None = None, route: str | None = None) -> dict:
    """K10g (``_core/rng.py`` ``_shuffle_grouped``, chunked as
    ``shuffle_group_columns`` chunks) against its plain version on the card,
    bitwise; with ``library`` the sort path as the yardstick, held bitwise
    too. Each timed call starts from a fresh layout cache, so it pays the
    device layout (the order's upload and the tile table) as a call with a
    single chunk does. ``route`` (``packed`` or ``gathered``), when given, is
    asserted."""
    import torch

    from squidpy_torch._core import rng

    cuda = torch.device("cuda")
    lay = rng.group_layout(groups)
    vsorted = values[torch.from_numpy(lay.order).to(cuda)].contiguous()
    n = len(groups)
    if route is not None:
        taken = "packed" if rng._packed_route(vsorted, rng._grouped_device(lay, cuda)) else "gathered"
        if taken != route:
            raise AssertionError(f"{name}: K10g takes the {taken} route, not {route}")
    out_k = torch.empty((len(keys), n), dtype=values.dtype, device=cuda)
    out_p = torch.empty_like(out_k)
    m = rng._FULL_MASK if mask is None else mask
    lib = (lambda: _library_grouped(keys, lay, vsorted)) if library else None
    res = _compare(name, lambda: rng._shuffle_grouped(keys, lay._replace(cache={}), vsorted, out_k, cuda, mask=m),
                   lambda: rng._shuffle_grouped_plain(keys, lay, vsorted, out_p, m), 3,
                   _grouped_bound(len(keys), n, out_k.element_size(), values.element_size()),
                   plain_warm=plain_warm, library=lib)
    if library and not torch.equal(out_k, _library_grouped(keys, lay, vsorted)):
        raise AssertionError(f"{name}: the kernel and the sort path differ")
    return res


def grouped_split(keys, values, groups) -> None:
    """``[diag] grouped``: one chunk of K10g (the chunk the card's memory
    allows, asserted to hold all 500 keys: one launch set) with each step
    timed by CUDA events (the scatter, the sort, and the overflow sort if a
    bucket needed it), its route, segments, tiles, bucket starts a row,
    coarse buckets, largest bucket and overflowing buckets; the device layout
    alone (the order's upload and the tile table, made once a call); the
    sort's fused write at the original rows against a write at the
    group-sorted slots followed by a separate gather; the bound and this
    design's floor."""
    import torch

    from squidpy_torch._core import rng

    cuda = torch.device("cuda")
    lay = rng.group_layout(groups)
    vsorted = values[torch.from_numpy(lay.order).to(cuda)].contiguous()
    n = len(groups)
    _, layout_ms = _time_ms(lambda: rng._grouped_device(lay._replace(cache={}), cuda), 3)
    dev = rng._grouped_device(lay, cuda)
    packed = rng._packed_route(vsorted, dev)
    step = rng._keys_per_chunk(n, cuda, rng._grouped_bytes(n, dev, packed, values.element_size()))
    if step < len(keys):
        raise AssertionError(f"K10g: a chunk of {step} keys, fewer than the {len(keys)} of nhood_enrichment's chunk")
    chunk = np.ascontiguousarray(np.asarray(keys, np.uint32))
    out = torch.empty((len(chunk), n), dtype=values.dtype, device=cuda)
    sorted_slots = torch.empty_like(out)
    order = torch.from_numpy(lay.order).to(cuda)
    rng._shuffle_grouped_k10(chunk, dev, vsorted, out, rng._FULL_MASK, rng._SORT_CAP)  # warm
    stats: dict = {}
    rng._shuffle_grouped_k10(chunk, dev, vsorted, out, rng._FULL_MASK, rng._SORT_CAP, stats=stats)
    _, fused_ms = _time_ms(lambda: rng._shuffle_grouped_k10(chunk, dev, vsorted, out, rng._FULL_MASK, rng._SORT_CAP),
                           3)

    def apart():
        rng._shuffle_grouped_k10(chunk, dev, vsorted, sorted_slots, rng._FULL_MASK, rng._SORT_CAP, fused=False)
        out2 = torch.empty_like(out)
        out2[:, order] = sorted_slots
        return out2

    got, apart_ms = _time_ms(apart, 3)
    if not torch.equal(got, out):
        raise AssertionError("K10g: the fused write and the separate gather differ")
    steps = " ".join(f"{k}={stats[k][0]:.3f}" for k in ("scatter_ms", "sort_ms", "overflow_ms") if k in stats)
    bound = _grouped_bound(len(chunk), n, 1, 1)
    floor = _grouped_floor(len(chunk), n, 4 if packed else 8, 1, dev.n_starts)
    print(f"[diag] grouped n={n} keys={len(chunk)} (one launch set; a chunk holds up to {step}) route="
          f"{'packed (4-byte keys)' if packed else 'gathered (8-byte keys)'} segments={len(lay.starts) - 1} "
          f"tiles={dev.tiles.shape[0]} bucket_starts={dev.n_starts} (a row) coarse_buckets={stats['buckets']} "
          f"largest_bucket={stats['largest_bucket'][0]} overflow={stats['overflow'][0]} {steps} "
          f"fused_ms={fused_ms:.3f} (each slot written at its original row) apart_ms={apart_ms:.3f} (group-sorted "
          f"slots, then a gather) layout_ms={layout_ms:.3f} (the device layout, once a call); "
          f"bound_ms={bound[0]:.4f} ({bound[1]}: one word an item) design_floor_ms={floor[0]:.4f} ({floor[1]}: one "
          f"word, the keys and bucket starts written and read once)", flush=True)
    if stats["overflow"][0]:
        raise AssertionError("K10g: a bucket of part f1's chunk overflowed")


def grouped_kernel_checks(study: StandIn) -> list[dict]:
    """K10g on part f1's own inputs: the first 500-permutation chunk of
    ``nhood_enrichment``'s keys over the study's labels (uint8) and
    libraries, with the sort path as the yardstick, and its ``[diag]`` line;
    then int32 and int64 values (the gathered route) with a one-cell and a
    NaN library, tied words (ties across tiles of a section), 500 sections
    of 2,000 cells (256 fine buckets a coarse one), one section of 1M cells
    (9 fine bits: tiles of two sub-tiles), of 3M (11 fine bits, the packed
    route's last) and of 7M (12: uint8 gathered), every word equal, and the
    capacity lowered (the overflow sort, on both routes)."""
    import torch

    from squidpy_torch._core import rng

    codes = np.asarray(study.obs["cluster"].cat.codes)
    libs = np.asarray(study.obs["library"].cat.codes)
    labels = torch.from_numpy(codes).cuda().to(torch.uint8)
    keys = rng.spawn_keys(0, N_PERMS)[:GROUPED_CHECK_KEYS]
    out = [check_grouped(f"threefry_grouped part f1 ({GROUPED_CHECK_KEYS} keys x {len(codes)}, {SECTIONS} sections, "
                         f"uint8 labels)", keys, labels, libs, library=True, plain_warm=False, route="packed")]
    grouped_split(keys, labels, libs)
    g = np.random.default_rng(33)
    odd = g.integers(0, 5, 150_000).astype(np.int32)
    odd[:7] = -1
    odd[7] = 9  # a library of one cell
    vals = torch.from_numpy(g.integers(0, 2**31 - 1, 150_000).astype(np.int32)).cuda()
    out.append(check_grouped("threefry_grouped int32 values, a one-cell and a NaN library", rng.spawn_keys(1, 64),
                             vals, odd, route="gathered"))
    out.append(check_grouped("threefry_grouped int64 values", rng.spawn_keys(5, 16), vals[:100_000].to(torch.int64),
                             odd[:100_000], route="gathered"))
    out.append(check_grouped("threefry_grouped tied words (mask 0xFFF00000)", rng.spawn_keys(4, 16),
                             labels[:200_000], libs[:200_000], mask=0xFFF00000, route="packed"))
    many = np.repeat(np.arange(500), 2000).astype(np.int32)
    g.shuffle(many)
    out.append(check_grouped("threefry_grouped 500 sections of 2,000 cells", rng.spawn_keys(6, 64), labels, many,
                             route="packed"))
    whole = labels.repeat(7)
    for cells, route in ((1_000_000, "packed"), (3_000_000, "packed"), (7_000_000, "gathered")):
        out.append(check_grouped(f"threefry_grouped one section of {cells} cells", rng.spawn_keys(cells, 8),
                                 whole[:cells], np.zeros(cells, np.int8), route=route))
    old = rng._SORT_CAP
    try:
        rng._SORT_CAP = 64
        out.append(check_grouped("threefry_grouped capacity lowered to 64 (the overflow sort)", rng.spawn_keys(2, 16),
                                 labels[:200_000], libs[:200_000], route="packed"))
        out.append(check_grouped("threefry_grouped capacity lowered to 64, int32 values (the overflow sort)",
                                 rng.spawn_keys(7, 8), vals, odd, route="gathered"))
    finally:
        rng._SORT_CAP = old
    lay = rng.group_layout(libs[:300_000])
    vs = labels[:300_000][torch.from_numpy(lay.order).cuda()].contiguous()
    got = torch.empty((8, 300_000), dtype=torch.uint8, device="cuda")
    rng._shuffle_grouped(rng.spawn_keys(3, 8), lay, vs, got, torch.device("cuda"), mask=0)
    want = rng._shuffle_grouped_plain(rng.spawn_keys(3, 8), lay, vs, torch.empty_like(got), mask=0)
    if not torch.equal(got, want):
        raise AssertionError("K10g: every word equal differs from the plain version")
    print("[kernel] threefry_grouped every word equal (one bucket a section, the overflow sort): max_abs_err=0.0",
          flush=True)
    return out


def sections_reference_check(study: StandIn) -> None:
    """``nhood_enrichment(library_key=...)`` on the card and on the CPU (plain
    torch) on a ~100k-cell band of part f1's study across all its sections:
    counts and z-scores bitwise."""
    import squidpy_torch as sqt

    t0 = time.perf_counter()
    coords = study.obsm["spatial"]
    keep = coords[:, 1] < np.quantile(coords[:, 1], 0.1)
    cut = StandIn(coords[keep], np.asarray(study.obs["cluster"].cat.codes)[keep], N_CLS)
    cut.obs["library"] = _Categorical(np.asarray(study.obs["library"].cat.codes)[keep], SECTIONS)
    sqt.gr.spatial_neighbors_knn(cut, n_neighs=N_NEIGHS, library_key="library")
    out = {}
    for device in ("cuda", "cpu"):
        with sqt.set_device(device):
            out[device] = sqt.gr.nhood_enrichment(cut, "cluster", library_key="library", n_perms=SECTION_PERMS_CPU,
                                                  seed=2, copy=True)
    np.testing.assert_array_equal(out["cuda"].counts, out["cpu"].counts)
    np.testing.assert_array_equal(out["cuda"].zscore, out["cpu"].zscore)
    print(f"[reference] nhood_enrichment(library_key) at {int(keep.sum())} cells, {SECTIONS} sections, "
          f"{SECTION_PERMS_CPU} permutations: card and CPU agree bitwise ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def _lattice_adjacency(side: int):
    """The 4-neighbour square lattice of ``side`` x ``side`` bins, as
    ``examples/sepal_scale.py`` builds it."""
    from scipy import sparse as sp

    idx = np.arange(side * side).reshape(side, side)
    r = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    c = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    n = side * side
    return sp.csr_matrix((np.ones(2 * len(r)), (np.r_[r, c], np.r_[c, r])), shape=(n, n))


def _sepal_counts(side: int, n_genes: int, seed: int) -> np.ndarray:
    """``examples/sepal_scale.py``'s counts, drawn on the card: Gamma(2, 1)
    times 1 + 10 x a Gaussian bump (width uniform in side/20-side/4) for
    the first quarter of the genes, floored, as uint8 (clamped at 255)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = side * side
    n_sv = n_genes // 4
    alpha = torch.full((n, n_genes), 2.0, device="cuda")
    x = torch._standard_gamma(alpha, generator=gen)
    del alpha
    yy, xx = torch.meshgrid(torch.arange(side, device="cuda"), torch.arange(side, device="cuda"), indexing="ij")
    sx, sy = xx.reshape(-1).float(), yy.reshape(-1).float()
    cy = torch.rand(n_sv, device="cuda", generator=gen) * side
    cx = torch.rand(n_sv, device="cuda", generator=gen) * side
    w = side / 20 + torch.rand(n_sv, device="cuda", generator=gen) * (side / 4 - side / 20)
    bump = torch.exp(-((sx[:, None] - cx) ** 2 + (sy[:, None] - cy) ** 2) / (2 * w**2))
    x[:, :n_sv] *= 1.0 + 10.0 * bump
    return torch.floor(x).clamp_(max=255).to(torch.uint8).cpu().numpy()


def _sepal_dataset(side: int, n_genes: int, seed: int) -> StandIn:
    yy, xx = np.mgrid[:side, :side]
    adata = StandIn(np.column_stack([xx.ravel(), yy.ravel()]).astype(np.float64), np.zeros(side * side), 1)
    adata.obsp["spatial_connectivities"] = _lattice_adjacency(side)
    adata.set_expression(_sepal_counts(side, n_genes, seed))
    return adata


def _check_sepal(res, genes: int, budget: int) -> np.ndarray:
    s = res.columns["sepal_score"]
    if len(res.index) != genes or len(set(res.index)) != genes:
        raise AssertionError("sepal: wrong or repeated genes")
    finite = s[np.isfinite(s)]
    if np.any(finite < 0) or np.any(finite > budget * SEPAL_DT) or np.any(np.diff(finite) > 0):
        raise AssertionError("sepal: scores outside [0, n_iter * dt] or not descending")
    if not np.array_equal(np.isnan(s), np.arange(len(s)) >= len(finite)):
        raise AssertionError("sepal: NaN scores not last")
    return s


def sepal_path() -> tuple[dict, dict, dict]:
    """Parts f2 and f3. f2: ``examples/sepal_scale.py``'s timed run, a
    1000 x 1000 square lattice (Visium HD bins) x 1024 genes, ``thresh=0``
    and ``n_iter=300``, two calls; f3: sepal at its defaults on the
    example's 316 x 316 lattice x 256 genes (the spatial genes must score
    above the background) and on a Visium section of 4,992 hexagonal spots
    (``spatial_neighbors_grid(n_neighs=6)``) x 2000 genes. Each part's
    counters reset before its calls and read after. Returns the datasets,
    the launches (f2, f3) and the seconds."""
    import squidpy_torch as sqt
    from squidpy_torch import _cuda
    from squidpy_torch._core.device_x import device_expression

    secs: dict = {}
    t0 = time.perf_counter()
    big = _sepal_dataset(SEPAL_SIDE, SEPAL_GENES, seed=41)
    secs["f2_setup_s"] = time.perf_counter() - t0
    _, secs["f2_handle_s"] = _sync_time(lambda: device_expression(big))
    _cuda.reset_launches()
    call = dict(max_neighs=4, n_iter=SEPAL_BUDGET, thresh=0.0, copy=True)
    r1, secs["f2_call1_s"] = _sync_time(lambda: sqt.gr.sepal(big, **call))
    r2, secs["f2_call2_s"] = _sync_time(lambda: sqt.gr.sepal(big, **call))
    launches_f2 = dict(_cuda.launches)
    s = _check_sepal(r1, SEPAL_GENES, SEPAL_BUDGET)
    if not (np.array_equal(r1.index, r2.index) and np.array_equal(s, r2.columns["sepal_score"], equal_nan=True)):
        raise AssertionError("sepal: two calls on the same data differ")
    secs["f2_converged"] = int(np.isfinite(s).sum())

    small = _sepal_dataset(SEPAL_SMALL_SIDE, SEPAL_SMALL_GENES, seed=7)
    hexa = _hex_dataset(VISIUM_SPOTS, seed=43)
    hexa.set_expression(poisson_counts(VISIUM_SPOTS, VISIUM_GENES, seed=44, low=0.5))
    sqt.gr.spatial_neighbors_grid(hexa, n_neighs=6)
    _cuda.reset_launches()
    r3, secs["f3_square_s"] = _sync_time(lambda: sqt.gr.sepal(small, max_neighs=4, copy=True))
    r4, secs["f3_visium_s"] = _sync_time(lambda: sqt.gr.sepal(hexa, max_neighs=6, copy=True))
    launches_f3 = dict(_cuda.launches)
    s3 = dict(zip(r3.index, _check_sepal(r3, SEPAL_SMALL_GENES, 30000)))
    sv = np.nanmean([s3[f"gene_{i}"] for i in range(SEPAL_SMALL_GENES // 4)])
    bg = np.nanmean([s3[f"gene_{i}"] for i in range(SEPAL_SMALL_GENES // 4, SEPAL_SMALL_GENES)])
    secs["f3_spatial_mean"], secs["f3_background_mean"] = float(sv), float(bg)
    print(f"[score check] sepal at {SEPAL_SMALL_SIDE * SEPAL_SMALL_SIDE} bins, thresh=1e-8: spatial genes {sv:.6f} "
          f"vs background {bg:.6f} (mean scores)", flush=True)
    s4 = _check_sepal(r4, VISIUM_GENES, 30000)
    secs["f3_visium_converged"] = int(np.isfinite(s4).sum())
    return {"big": big, "small": small, "visium": hexa}, {"f2": launches_f2, "f3": launches_f3}, secs


def _sepal_steps(done, n_iter: int) -> float:
    # this run's steps: a gene runs to its convergence step (or the budget)
    return float(np.where(np.isnan(done), n_iter, done + 1).sum())


def _sepal_bound(n: int, k: int, n_sat: int, done, n_iter: int) -> tuple[float, str]:
    # the streaming route: each step reads the state and writes it once (4 +
    # 4 bytes a node and gene); operations: the stencil (k adds, 3 more, the
    # clamp) a node and the entropy's ~24 (two compares, a division, a log,
    # two adds) a saturated node
    steps = _sepal_steps(done, n_iter)
    return _bound(8.0 * n * steps, ((k + 4) * n + 24.0 * n_sat) * steps)


SMEM_BYTES_PER_CLOCK = 128  # an SM's shared-memory bandwidth a clock (H100)
SMS = 132


def _sm_clock_hz() -> float:
    """The SM clock the card reports as its maximum (``nvidia-smi
    clocks.max.sm``), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _sepal_resident_bound(n: int, k: int, n_sat: int, n_unsat: int, n_genes: int, done,
                          n_iter: int) -> tuple[tuple[float, str], float, float]:
    # the resident route moves the state through device memory once (read
    # and written: 8 bytes a node and gene), and does the streaming bound's
    # operations: the larger of the two is the contract's bound. Its state
    # lives in shared memory, whose traffic is returned beside it: each
    # step reads a saturated node's state and its k neighbours' and writes
    # one value ((k + 2) x 4 bytes), an unsaturated node's own, its saturated
    # node's and that one's k neighbours' ((k + 3) x 4 bytes), at 128 bytes a
    # clock an SM on 132 SMs at the SM clock nvidia-smi reports as its
    # maximum; returns (the bound, the shared-memory time, that clock in Hz)
    steps = _sepal_steps(done, n_iter)
    clock = _sm_clock_hz()
    smem = 4.0 * (n_sat * (k + 2) + n_unsat * (k + 3)) * steps
    t_smem = smem / (SMEM_BYTES_PER_CLOCK * SMS * clock)
    return _bound(8.0 * n * n_genes, ((k + 4) * n + 24.0 * n_sat) * steps), 1e3 * t_smem, clock


def check_sepal(name: str, adata: StandIn, hexa: bool, genes: np.ndarray, n_iter: int, thresh: float,
                route: str, plain_warm: bool = False) -> dict:
    """K11 against its plain version on the card on ``adata``'s genes, by
    the convergence steps and the state after the run (one tensor: the steps
    in row 0), bitwise, on the route the shape selects (asserted to be
    ``route``)."""
    import torch
    from scipy import sparse as sp

    from squidpy_torch import _cuda
    from squidpy_torch._core.device_x import device_expression
    from squidpy_torch.gr._sepal import _compute_idxs
    from squidpy_torch.ops.sepal import _diffusion_plain, _k11_route, sepal_diffusion

    g = sp.csr_matrix(adata.obsp["spatial_connectivities"])
    k = 6 if hexa else 4
    sat, sat_idx, unsat, near = _compute_idxs(g, np.asarray(adata.obsm["spatial"], np.float64), k)
    tables = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()
              for a in (sat, sat_idx, unsat, np.searchsorted(sat, near))]
    conc = device_expression(adata).dense_block(genes)
    genes_a_block = _k11_route(g.shape[0], len(sat), len(genes), *_cuda.device_info())
    if ("resident" if genes_a_block else "streaming") != route:
        raise AssertionError(f"{name}: the shape selects the {'resident' if genes_a_block else 'streaming'} route, "
                             f"not {route}")

    def kernel():
        done, state = sepal_diffusion(conc, *tables, hexa, n_iter, SEPAL_DT, thresh, return_state=True)
        return torch.cat([done[None, :], state])

    def plain():
        done, state = _diffusion_plain(conc, *tables, hexa, n_iter, SEPAL_DT, thresh)
        return torch.cat([done[None, :], state])

    done = kernel()[0].cpu().numpy()
    smem_note = ""
    if route == "resident":
        bound, smem_ms, clock = _sepal_resident_bound(g.shape[0], k, len(sat), len(unsat), len(genes), done, n_iter)
        smem_note = (f" smem_bound_ms={smem_ms:.4f} (shared-memory traffic at 128 B a clock x {SMS} SMs x "
                     f"{clock / 1e6:.0f} MHz, nvidia-smi clocks.max.sm);")
    else:
        bound = _sepal_bound(g.shape[0], k, len(sat), done, n_iter)
    other = ""
    if route == "resident":  # the streaming route on the same shape, forced, for the choice's record
        from squidpy_torch.ops import sepal as ops_sepal

        chosen = ops_sepal._k11_route
        ops_sepal._k11_route = lambda *args: 0
        try:
            streamed, streaming_ms = _time_ms(kernel, 1)
        finally:
            ops_sepal._k11_route = chosen
        if not torch.equal(torch.nan_to_num(streamed, nan=-1.0), torch.nan_to_num(kernel(), nan=-1.0)):
            raise AssertionError(f"{name}: the streaming and resident routes differ")
        other = f" streaming_ms={streaming_ms:.3f} (the streaming route forced, the same result)"
    layout = f"{genes_a_block} genes a block" if genes_a_block else "64 genes x 256 rows a block, one pass a step"
    print(f"[diag] sepal {name}: route={route} ({layout}), steps run "
          f"{int(np.where(np.isnan(done), n_iter, done + 1).max())}, genes converged {int(np.isfinite(done).sum())} "
          f"of {len(done)}, nodes {g.shape[0]} ({len(sat)} saturated);{other}{smem_note} "
          f"bound_ms={bound[0]:.4f} ({bound[1]})", flush=True)
    return _compare(name, kernel, plain, 2, bound, plain_warm=plain_warm)


def sepal_kernel_checks(data: dict) -> dict[str, list[dict]]:
    """K11 on part f's own inputs, each on the route its shape selects: the
    first 64 genes of f2's 1M bins for its budget of 300 steps (the state
    after it, and the steps) and f3's 316 x 316 x 256 at the default
    threshold (streaming); Visium 4,992 x 2000 at the default threshold
    (resident)."""
    streaming = [check_sepal(f"sepal_diffusion part f2 ({SEPAL_SIDE}x{SEPAL_SIDE} bins x {K11_CHECK_GENES} genes, "
                             f"{SEPAL_BUDGET} steps, thresh=0)", data["big"], False, np.arange(K11_CHECK_GENES),
                             SEPAL_BUDGET, 0.0, "streaming")]
    streaming.append(check_sepal(f"sepal_diffusion part f3 ({SEPAL_SMALL_SIDE}x{SEPAL_SMALL_SIDE} x "
                                 f"{SEPAL_SMALL_GENES} genes, thresh=1e-8)", data["small"], False,
                                 np.arange(SEPAL_SMALL_GENES), 30000, 1e-8, "streaming"))
    resident = [check_sepal(f"sepal_resident part f3 (Visium {VISIUM_SPOTS} hex spots x {VISIUM_GENES} genes, "
                            f"thresh=1e-8)", data["visium"], True, np.arange(VISIUM_GENES), 30000, 1e-8, "resident")]
    return {"sepal_diffusion": streaming, "sepal_resident": resident}


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
    wanted = {"ripley_L": ("ripley_pairs",), "ripley_G": ("cross_knn",), "ripley_F": ("cross_knn",),
              "interaction_matrix": ("pair_counts",)}
    missing = [(call, k) for call, names in wanted.items() for k in names if launches_calls[call][k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path's fourth part: {missing}")
    launches = {k: launches[k] + launches_d[k] for k in launches}
    phases["main_path_d"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    adata_e, launches_e, secs_e = ligrec_path()
    print(f"[main path e] n={LIGREC_CELLS} genes={LIGREC_GENES} clusters={LIGREC_CLS} perms={LIGREC_PERMS} "
          + " ".join(f"{k}={v:.4f}" for k, v in secs_e.items()), flush=True)
    print(f"[launches e] {launches_e}", flush=True)
    missing = [k for k in ("ligrec_perms", "threefry_shuffle") if launches_e[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path's fifth part: {missing}")
    launches = {k: launches[k] + launches_e[k] for k in launches}
    phases["main_path_e"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    study, launches_f1, secs_f1 = sections_path(adata)
    print(f"[main path f1] n={N_CELLS} sections={SECTIONS} perms={N_PERMS} "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in secs_f1.items()), flush=True)
    print(f"[launches f1] {launches_f1}", flush=True)
    missing = [k for k in ("threefry_grouped", "pair_counts") if launches_f1[k] <= 0]
    if missing or launches_f1["index_cipher"]:
        raise AssertionError(f"part f1: kernels not launched {missing}, or the cipher launched with library_key")
    sepal_data, launches_sepal, secs_f = sepal_path()
    print(f"[main path f2/f3] f2: {SEPAL_SIDE}x{SEPAL_SIDE} bins x {SEPAL_GENES} genes, {SEPAL_BUDGET} steps; f3: "
          f"{SEPAL_SMALL_SIDE}x{SEPAL_SMALL_SIDE} x {SEPAL_SMALL_GENES}, Visium {VISIUM_SPOTS} x {VISIUM_GENES} "
          + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in secs_f.items()), flush=True)
    for part, counts in launches_sepal.items():
        print(f"[launches {part}] {counts}", flush=True)
        wanted = ("sepal_diffusion",) if part == "f2" else ("sepal_diffusion", "sepal_resident")
        missing = [k for k in wanted if counts[k] <= 0]
        if missing:
            raise AssertionError(f"part {part}: {missing} not launched")
    for counts in (launches_f1, *launches_sepal.values()):
        launches = {k: launches[k] + counts[k] for k in launches}
    phases["main_path_f"] = time.perf_counter() - t_phase

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
    torch.cuda.empty_cache()
    checks.update(ligrec_kernel_checks(adata_e))
    del adata_e
    torch.cuda.empty_cache()
    checks["threefry_grouped"] = grouped_kernel_checks(study)
    checks.update(sepal_kernel_checks(sepal_data))
    del sepal_data
    torch.cuda.empty_cache()
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
    for name, extra in ligrec_branch_checks().items():
        checks[name] += extra
    ripley_route_diag()
    phases["kernels_other_shapes"] = time.perf_counter() - t_phase

    # card against CPU through the public API: small (brute-force kNN, sort
    # shuffles, dense sweep, K2), and at 100k (cipher shuffles, binned sweep)
    t_phase = time.perf_counter()
    reference_check(3000, 20)
    reference_check(100_000, np.linspace(0.0, 5.0 * secs["mean_knn_distance"], 9))
    graph_reference_check(3000)
    ripley_reference_check(3000)
    ligrec_reference_check()
    sections_reference_check(study)
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
