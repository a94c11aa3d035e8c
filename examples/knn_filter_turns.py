"""K12, K14, K15 and K16 of two checkouts of this repository, timed in turns on one card.

Each checkout (``--tree``) runs in a process of its own that imports that
checkout's ``squidpy_torch`` and builds its kernels there. Each makes the
same seeded Gaussian blobs (12 centres of unit spread in a [-8, 8] cube) and
prints one JSON line of CUDA-event times (mean of 3 after one warm-up):

- ``k12_16_ms`` / ``k12_50_ms``: ``feature_knn`` (K12) on 200,000 x 16 and
  200,000 x 50 rows, k = 15;
- ``k14_m1_ms`` / ``k14_m16_ms``: ``ivf_knn._nearest`` (K14's nearest entry)
  of 1,000,000 x 16 rows against 1024 of them, m = 1 (Lloyd's assignment)
  and m = 16 (the probes); ``k14_56_m1_ms`` / ``k14_56_m16_ms`` the same at
  50 features (padded to 56);
- ``k15_16_ms`` / ``k15_56_ms``: ``ivf_knn._search`` (K15), k = 15, on the
  IVF index that ``ivf_knn`` builds on the 1M rows at 16 and 50 features;
- ``k16_16_ms`` / ``k16_56_ms``: ``ivf_knn._refine`` (K16), k = 15, on the
  merged lists of that search, the rows in the index's cluster order as
  ``ivf_search`` takes them (``ivf_knn._row_order``; a checkout without it
  refines in index order, as its ``ivf_search`` does);
- ``digest``: a hash of every output, which must be the same for every
  checkout (each kernel is bitwise its plain version).

Run from the root of one checkout, with the other unpacked beside it (for
instance ``git archive`` of the parent commit under a git-ignored directory),
in the turns given (default: first, second, second, first)::

    python3 examples/knn_filter_turns.py --tree _scratch/parent --tree .

It needs a CUDA card; the last line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPEATS = 3


def worker(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import squidpy_torch as sqt
    from squidpy_torch.ops import ivf_knn as ivf
    from squidpy_torch.ops import knn

    sqt.set_device("cuda")
    digest = hashlib.sha256()

    def blobs(n: int, d: int, seed: int) -> torch.Tensor:
        rng = np.random.default_rng(seed)
        centres = rng.uniform(-8, 8, (12, d))
        x = centres[rng.integers(0, 12, n)] + rng.normal(0, 1, (n, d))
        return torch.from_numpy(x.astype(np.float32)).cuda()

    def timed(fn) -> float:
        out = fn()
        for t in out if isinstance(out, tuple) else (out,):
            if t is not None:
                digest.update(t.cpu().numpy().tobytes())
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPEATS

    out = {"tree": tree}
    for d in (16, 50):
        x = blobs(200_000, d, d)
        out[f"k12_{d}_ms"] = timed(lambda: knn.feature_knn(x, 15))
    for d in (16, 50):
        x = ivf._padded(blobs(1_000_000, d, 100 + d))
        cents = x[torch.from_numpy(np.random.default_rng(d).choice(x.shape[0], 1024, replace=False)).cuda()]
        cents = cents.contiguous()
        tag = "" if d == 16 else "56_"
        out[f"k14_{tag}m1_ms"] = timed(lambda: ivf._nearest(x, cents, 1))
        out[f"k14_{tag}m16_ms"] = timed(lambda: ivf._nearest(x, cents, 16)[0])
        _, _, index = ivf._ivf_knn(x, 15, seed=0)
        out[f"k15_{x.shape[1]}_ms"] = timed(lambda: ivf._search(x, index.members, index.qtable, 15, True))
        merged = ivf._merge_slots(ivf._search(x, index.members, index.qtable, 15, True), index.slot_map, 15)
        if hasattr(ivf, "_row_order"):
            order = ivf._row_order(index.members, x.shape[0])
            out[f"k16_{x.shape[1]}_ms"] = timed(lambda: ivf._refine(x, merged, 15, True, order))
        else:
            out[f"k16_{x.shape[1]}_ms"] = timed(lambda: ivf._refine(x, merged, 15, True))
        del x, cents, index, merged
        torch.cuda.empty_cache()
    out["digest"] = digest.hexdigest()[:16]
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True, help="a checkout's root; give two")
    parser.add_argument("--order", default="0110", help="the turns, as indices into the trees")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    digests = set()
    for i in args.order:
        tree = args.tree[int(i)]
        res = subprocess.run([sys.executable, __file__, "--tree", tree, "--worker", tree], capture_output=True,
                             text=True, check=False)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        digests.add(json.loads(line)["digest"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip())
    if len(digests) != 1:
        print(f"outputs differ between the checkouts: {sorted(digests)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
