"""``calculate_niche``'s host (scipy) and device (K13, K5a) hop branches, timed on one card around their cut-over.

``squidpy_torch/gr/_niche.py`` takes the device branch of the neighbourhood
profiles (``neighborhood``) and of the hop features (``cellcharter``) from
``_DEVICE_HOPS_MIN_N`` cells, the scipy host branch below. For each size
(default 10,000, 20,000 and 50,000 cells of ``chip_smoke.py``'s part g data:
12 planted domains, 16 cell types, 300 genes of Poisson counts, the kNN
graph of 6) and each of those two flavors, called as part g1 and g3 call
them, this script forces one branch and then the other by setting the
threshold, in turns (host, device, device, host) repeated ``--rounds``
times, after one warm-up call of each: host clock around each call, which
ends in the labels on the host. Everything after the branch (z-scores, K12
and Leiden; PCA and the device GMM) is the same in both. It prints one JSON
line a (size, flavor) with both branches' seconds a turn and their means,
then the card's name and power limit::

    python3 examples/niche_crossover.py [--sizes 10000 20000 50000] [--rounds 1]

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[10_000, 20_000, 50_000])
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("niche_crossover: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import squidpy_torch as sqt
    from squidpy_torch.gr import _niche

    sqt.set_device("cuda")
    default = _niche._DEVICE_HOPS_MIN_N
    try:
        for n in args.sizes:
            adata = cs._niche_dataset(n, seed=41)
            for part in ("g1", "g3"):
                call = cs.NICHE_CALLS[part]

                def timed(branch: str) -> float:
                    _niche._DEVICE_HOPS_MIN_N = 0 if branch == "device" else n + 1
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sqt.gr.calculate_niche(adata, **call)
                    return time.perf_counter() - t0

                timed("host")
                timed("device")
                turns = {"host": [], "device": []}
                for branch in ("host", "device", "device", "host") * args.rounds:
                    turns[branch].append(timed(branch))
                print(json.dumps({"cells": n, "flavor": call["flavor"], "host_s": turns["host"],
                                  "device_s": turns["device"], "host_mean_s": sum(turns["host"]) / len(turns["host"]),
                                  "device_mean_s": sum(turns["device"]) / len(turns["device"])}), flush=True)
    finally:
        _niche._DEVICE_HOPS_MIN_N = default
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
