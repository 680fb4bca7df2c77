#!/usr/bin/env python3
"""The graph phase's hop loop on the card: per hop against blocks of hops
captured as CUDA graphs.

    python3 scripts/hop_bench.py [--n 50000] [--quality-n 30000]

Builds ``chip_smoke.py``'s compare-path graph (``build_pg`` at ``--n`` x
128, R 16, L 48) and quality-path index (``build_pag`` at ``--quality-n``
with the main path's arguments) twice each, in turns: with
``core/graph_search.py``'s ``HOP_BLOCK`` at 1 (one host check of the
frontier before every hop, every hop launched op by op) and at its
default (a check a block of hops, every hop after a call's first a
replay of that hop captured as a CUDA graph). The graphs must
come out the same bit for bit; then ``greedy_search`` on 4096 of the
built graph's rows, both ways (timed in turns too), must return the
same ids, distances, paths, path distances and hop counts bit for bit.
Prints each wall, the
card's name and power limit, and ``HOP BENCH OK`` last.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--quality-n", type=int, default=30_000)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hop_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import graph_search as gs
    from repro_torch.core.build import build_pg
    from repro_torch.core.pag import build_pag
    from repro_torch.data.vectors import make_dataset
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    build.build_all(("l2_topk",))
    block = gs.HOP_BLOCK

    def timed(what, fn, hop_block):
        gs.HOP_BLOCK = hop_block
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"{what}, hop block {hop_block}: {wall:.3f} s ({card})",
              flush=True)
        return out, wall

    ds = make_dataset("clustered", n=args.n, d=cs.D, n_queries=16,
                      k_gt=cs.K, seed=0, device=dev)
    walls = {}
    pgs = {}
    for hop_block in (1, block, block, 1):
        pgs[hop_block], w = timed(f"build_pg n={args.n}", lambda: build_pg(
            ds.base, R=16, L=48, seed=0, device=dev), hop_block)
        walls.setdefault(("build_pg", hop_block), []).append(w)
    if not (np.array_equal(pgs[1].nbrs, pgs[block].nbrs)
            and pgs[1].entry == pgs[block].entry):
        raise AssertionError("build_pg: the graphs differ")
    A, nbrs, n_nodes, entry = pgs[1].device_arrays(dev)
    q = torch.from_numpy(ds.base[:4096]).to(dev)
    res = {}
    for hop_block in (1, block, block, 1):
        res[hop_block], w = timed(
            "greedy_search 4096 x L48 on the built graph",
            lambda: gs.greedy_search(A, nbrs, n_nodes, entry, q, L=48, K=48),
            hop_block)
        walls.setdefault(("greedy_search", hop_block), []).append(w)
    for name, a, b in zip(res[1]._fields, res[1], res[block]):
        if not torch.equal(a, b):
            raise AssertionError(f"greedy_search: {name} differs")
    print(f"greedy_search 4096 x L48 on the built graph: every output "
          f"equal bit for bit, hops up to {int(res[1].n_hops.max())}",
          flush=True)
    ds = make_dataset("clustered", n=args.quality_n, d=cs.D, n_queries=16,
                      k_gt=cs.K, seed=0, device=dev)
    pags = {}
    for hop_block in (1, block, block, 1):
        pags[hop_block], w = timed(
            f"build_pag n={args.quality_n}",
            lambda: build_pag(ds.base, **cs.PAG_ARGS, device=dev), hop_block)
        walls.setdefault(("build_pag", hop_block), []).append(w)
    a, b = pags[1], pags[block]
    if not (np.array_equal(a.pg.nbrs, b.pg.nbrs)
            and np.array_equal(a.plist, b.plist)):
        raise AssertionError("build_pag: the indexes differ")
    for (what, hop_block), w in walls.items():
        print(f"{what} hop block {hop_block}: walls {w}", flush=True)
    print(card)
    print("HOP BENCH OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
