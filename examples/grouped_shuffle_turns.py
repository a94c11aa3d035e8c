"""K10g, the shuffle within libraries, of two checkouts of this repository, timed in turns on one card.

Each checkout (``--tree``) runs in a process of its own that imports that
checkout's ``squidpy_torch`` and ``chip_smoke.py`` and builds its kernels
there. Each makes ``chip_smoke.py``'s part f1 (1M cells in 8 sections, 16
clusters, uint8 labels) and prints one JSON line:

- ``chunk_ms``: ``_shuffle_grouped`` on the first 500-permutation chunk of
  ``nhood_enrichment``'s keys, each call from a fresh layout cache, so it pays
  the device layout as a call with one chunk does (CUDA events, mean of 5
  after one warm-up); ``cached_ms`` the same with the layout made once;
- ``group_layout_ms``: the host ``group_layout`` of the 1M int32 library
  codes (host clock, mean of 5);
- ``nhood_s``: ``nhood_enrichment(library_key=..., n_perms=1000)``, a second
  call (host clock around the call, which ends in a host read);
- ``digest``: a hash of the chunk's output, which must be the same for every
  checkout.

Run from the root of one checkout, with the other unpacked beside it (for
instance ``git archive`` of the parent commit under a git-ignored directory),
in the turns given (default: first, second, second, first)::

    python3 examples/grouped_shuffle_turns.py --tree _scratch/parent --tree .

It needs a CUDA card; the last line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

KEYS = 500  # nhood_enrichment's chunk of permutations
REPEATS = 5


def worker(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    import squidpy_torch as sqt
    from squidpy_torch._core import rng

    cuda = torch.device("cuda")
    adata = cs._dataset(cs.N_CELLS, seed=0)
    coords = adata.obsm["spatial"]
    libs = cs._sections(coords, seed=31)
    clusters = np.asarray(adata.obs["cluster"].cat.codes)
    labels = torch.from_numpy(clusters).to(cuda).to(torch.uint8)

    t0 = time.perf_counter()
    for _ in range(REPEATS):
        lay = rng.group_layout(libs)
    layout_ms = 1e3 * (time.perf_counter() - t0) / REPEATS

    vsorted = labels[torch.from_numpy(lay.order).to(cuda)].contiguous()
    keys = rng.spawn_keys(0, cs.N_PERMS)[:KEYS]
    out = torch.empty((KEYS, len(libs)), dtype=torch.uint8, device=cuda)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPEATS

    chunk_ms = timed(lambda: rng._shuffle_grouped(keys, lay._replace(cache={}), vsorted, out, cuda))
    cached_ms = timed(lambda: rng._shuffle_grouped(keys, lay, vsorted, out, cuda))
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]

    study = cs.StandIn(coords, clusters, cs.N_CLS)
    study.obs["library"] = cs._Categorical(libs, cs.SECTIONS)
    sqt.set_device("cuda")
    sqt.gr.spatial_neighbors_knn(study, n_neighs=cs.N_NEIGHS, library_key="library")
    call = dict(library_key="library", n_perms=cs.N_PERMS, copy=True)
    sqt.gr.nhood_enrichment(study, "cluster", seed=0, **call)
    t0 = time.perf_counter()
    sqt.gr.nhood_enrichment(study, "cluster", seed=1, **call)
    nhood_s = time.perf_counter() - t0
    print(json.dumps({"tree": tree, "chunk_ms": chunk_ms, "cached_ms": cached_ms, "group_layout_ms": layout_ms,
                      "nhood_s": nhood_s, "digest": digest}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--tree", action="append", required=True, help="a checkout's root (give two)")
    parser.add_argument("--order", default="0110", help="the turns, as indices into the trees")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    results = []
    for i in args.order:
        tree = args.tree[int(i)]
        proc = subprocess.run([sys.executable, __file__, "--tree", tree, "--worker", tree], capture_output=True,
                              text=True, check=False)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if len({r["digest"] for r in results}) != 1:
        print("the checkouts' outputs differ", file=sys.stderr)
        return 1
    for tree in args.tree:
        mine = [r for r in results if r["tree"] == tree]
        print(f"[turns] {tree}: chunk_ms " + " / ".join(f"{r['chunk_ms']:.3f}" for r in mine)
              + "; cached_ms " + " / ".join(f"{r['cached_ms']:.3f}" for r in mine)
              + "; group_layout_ms " + " / ".join(f"{r['group_layout_ms']:.1f}" for r in mine)
              + "; nhood_s " + " / ".join(f"{r['nhood_s']:.4f}" for r in mine), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
