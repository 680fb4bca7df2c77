#!/usr/bin/env python3
"""Wall time of the port's k-means at the smoke's calls, on one CUDA card.

    python3 scripts/kmeans_bench.py [--src TREE/src] [--n 50000]

On ``chip_smoke``'s compare dataset (``make_dataset("clustered")``, n x
128, seed 0): SPANN's clustering (``build_spann``'s call: n / 16
centers, 16 iterations, balance weight 2.0), CIC's (4 centers on the
first half, 4 iterations, balance 1.0) and the PQ codebooks
(``train_pq``: 8 subspaces of 4096 samples, 256 centers, 6 iterations).
``--src`` imports the port from another tree (an A/B on one card). Prints
one JSON line: the card, each call's wall in seconds and a digest of its
assignment, so that two trees' results can be held equal.
"""
import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--n", type=int, default=50_000)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.baselines.pq import train_pq
    from repro_torch.core.clustering import kmeans
    from repro_torch.data.vectors import make_dataset
    if not torch.cuda.is_available():
        sys.exit("kmeans_bench: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    x = make_dataset("clustered", n=args.n, d=128, n_queries=10, seed=0,
                     device=dev).base

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    out = {"card": card, "src": args.src, "n": args.n}
    for name, fn in (
            ("spann", lambda: kmeans(x, max(args.n // 16, 8), iters=16,
                                     seed=0, balance_weight=2.0,
                                     device=dev)),
            ("cic", lambda: kmeans(x[:args.n // 2], 4, iters=4, seed=0,
                                   balance_weight=1.0, device=dev)),
            ("pq", lambda: (train_pq(x, M=8, device=dev).centroids,))):
        secs, res = timed(fn)
        out[f"{name}_s"] = secs
        out[f"{name}_digest"] = hashlib.sha1(
            np.ascontiguousarray(res[-1]).tobytes()).hexdigest()[:12]
    print(json.dumps(out), flush=True)
