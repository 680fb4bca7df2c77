#!/usr/bin/env python3
"""Splits the DiskANN baseline's search time on one NVIDIA GPU, at the
comparison's shapes, and holds two search loops against each other.

    python3 scripts/diskann_sweep.py [--n N] [--queries Q] [--reps R]

Builds the comparison's DiskANN index as ``chip_smoke.comparison`` does
(``make_dataset("clustered", seed=0)``, ``chip_smoke.CMP_N`` x 128 (50,000;
``--n 100000`` for the size before the cell was cut) with 1000 queries,
``build_diskann(R=16, L=48, M=8)`` on a "dfs" store), then runs its sweep
(L = 16, 32, 64, beam_io 4), each repetition on a fresh store of the same
latency seed, in turns (per hop, waves, waves, per hop for ``--reps 2``):

* per hop: the search loop of the port before its lock-step traversal,
  one query at a time and one ``pq_adc`` launch per hop, with a host clock
  around each step of a hop: the frontier, ``store.get``, the exact
  distances (and the neighbour filter), the H2D copy and the index of the
  code rows, the ``pq_adc`` wrapper, the ``.cpu()`` sync and the candidate
  sorting, and per query its LUT and entry point;
* waves: ``baselines.diskann.search_diskann`` as this tree has it.

Both must return the same ids, distances and per-query latencies, and
leave the same store counters. Prints one JSON line per sweep setting and
loop, and a last JSON line with every number and the card's name and
power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SPLIT = ("lut_entry", "frontier", "store_get", "exact", "h2d_index",
         "pq_adc", "cpu_sync", "cand_sort")


def per_hop_search(idx, queries, store, k: int, L: int, split: dict,
                   beam_io: int = 4, prefix: str = "dk", n_shards: int = 1):
    """The port's DiskANN search with one ``pq_adc`` launch per query and
    hop, as ``search_diskann`` ran it before the lock-step traversal, with
    each step's host seconds added to ``split``. Returns (ids, d2, lats,
    hops per query)."""
    from repro_torch.baselines.pq import adc_lut
    from repro_torch.kernels import ops
    from repro_torch.storage.simulator import ComputeModel, QueryTimeline
    clock = time.perf_counter
    compute = ComputeModel()
    dev = idx.codes.device
    qn = queries.shape[0]
    out_ids = np.full((qn, k), -1, np.int64)
    out_d2 = np.full((qn, k), np.float32(3.4e38))
    q_dev = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
        dev)
    lats, hops = [], []
    for qi in range(qn):
        t0 = clock()
        q = queries[qi]
        lut = adc_lut(idx.cb, q_dev[qi])
        tl = QueryTimeline()
        tl.add_compute(compute.scan(256, idx.cb.M))
        visited = set()
        exact: dict = {}
        entry_codes = idx.codes[idx.entry:idx.entry + 1]
        cand = [(float(ops.pq_adc(lut, entry_codes)[0]), idx.entry)]
        io_time = 0.0
        n_hops = 0
        split["lut_entry"] += clock() - t0
        while True:
            t0 = clock()
            frontier = [c for c in sorted(cand)[:L]
                        if c[1] not in visited][:beam_io]
            split["frontier"] += clock() - t0
            if not frontier:
                break
            n_hops += 1
            batch_lat = 0.0
            nbr_all = []
            for _, node in frontier:
                visited.add(node)
                t0 = clock()
                obj, lat = store.get(f"{prefix}/{node % n_shards}/{node}")
                t1 = clock()
                batch_lat = max(batch_lat, lat)
                vec = obj[: idx.d]
                exact[node] = float(((vec - q) ** 2).sum())
                nbrs = obj[idx.d:].astype(np.int64)
                nbr_all.extend([b for b in nbrs.tolist() if b < idx.n
                                and b not in visited])
                split["store_get"] += t1 - t0
                split["exact"] += clock() - t1
            io_time += batch_lat
            tl.add_compute(compute.scan(len(frontier), idx.d))
            if nbr_all:
                t0 = clock()
                nbr_arr = np.asarray(sorted(set(nbr_all)), np.int64)
                rows = idx.codes[torch.from_numpy(nbr_arr).to(dev)]
                t1 = clock()
                d_dev = ops.pq_adc(lut, rows)
                t2 = clock()
                d_approx = d_dev.cpu().numpy()
                t3 = clock()
                tl.add_compute(compute.scan(len(nbr_arr), idx.cb.M))
                cand.extend(zip(d_approx.tolist(), nbr_arr.tolist()))
                cand = sorted(set(cand))[: 4 * L]
                split["h2d_index"] += t1 - t0
                split["pq_adc"] += t2 - t1
                split["cpu_sync"] += t3 - t2
                split["cand_sort"] += clock() - t3
        items = sorted(exact.items(), key=lambda kv: kv[1])[:k]
        for j, (node, dd) in enumerate(items):
            out_ids[qi, j] = node
            out_d2[qi, j] = dd
        lats.append(tl.compute_s + io_time)
        hops.append(n_hops)
    return out_ids, out_d2, lats, hops


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--reps", type=int, default=2,
                    help="turns of each loop, in the order A B B A")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diskann_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.baselines.diskann import build_diskann, search_diskann
    from repro_torch.carry import store_from_objects
    from repro_torch.data.vectors import make_dataset, recall_at_k
    from repro_torch.kernels import build, ops
    from repro_torch.storage.simulator import ObjectStore, StorageConfig

    dev = torch.device("cuda", 0)
    n = args.n or cs.CMP_N
    n_queries = args.queries or cs.CMP_QUERIES
    build.build_all(("pq_adc",))
    t0 = time.perf_counter()
    ds = make_dataset("clustered", n=n, d=cs.D, n_queries=n_queries, seed=0,
                      device=dev)
    cfg = StorageConfig.preset("dfs")
    built = ObjectStore(cfg)
    idx = build_diskann(ds.base, built, R=16, L=48, M=8, device=dev)
    torch.cuda.synchronize()
    report = {"n": n, "queries": n_queries, "setup_s":
              time.perf_counter() - t0, "runs": []}
    print(f"setup {report['setup_s']:.1f} s", flush=True)

    def run(loop: str):
        """The whole sweep through one loop on a fresh store; returns
        its results per L."""
        store = store_from_objects(built._data, cfg)
        out = {}
        for L in cs.CMP_DK_SWEEP:
            split = defaultdict(float)
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if loop == "per_hop":
                ids, d2, lats, hops = per_hop_search(idx, ds.queries, store,
                                                     cs.K, L, split)
            else:
                ids, d2, lats = search_diskann(idx, ds.queries, store,
                                               k=cs.K, L=L)
                hops = None
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            rec = {"loop": loop, "L": L, "wall_s": wall,
                   "pq_adc_launches": launches["pq_adc"],
                   "pq_adc_rows_launches": launches.get("pq_adc_rows", 0),
                   "n_gets": store.n_gets,
                   "qps_sim": 1.0 / np.mean(lats),
                   "recall@10": recall_at_k(ids, ds.gt_ids, cs.K)}
            if hops is not None:
                total = sum(hops)
                rec.update({"hops": total, "max_hops": max(hops),
                            "split_s": dict(split),
                            "split_us_per_hop": {
                                s: split[s] / total * 1e6 for s in SPLIT},
                            "unsplit_s": wall - sum(split.values())})
            print(json.dumps(rec), flush=True)
            report["runs"].append(rec)
            out[L] = (ids, d2, np.asarray(lats), store.n_gets,
                      store.bytes_fetched)
        return out

    order = ["per_hop", "waves", "waves", "per_hop"][:2 * args.reps]
    if args.reps == 1:
        order = ["per_hop", "waves"]
    results = {}
    for loop in order:
        res = run(loop)
        results.setdefault(loop, res)
    for L in cs.CMP_DK_SWEEP:
        a, b = results["per_hop"][L], results["waves"][L]
        same = (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                and np.array_equal(a[2], b[2]) and a[3:] == b[3:])
        report[f"same_L{L}"] = bool(same)
        if not same:
            print(f"L{L}: the two loops disagree", flush=True)
    report["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(report), flush=True)
    return 0 if all(report[f"same_L{L}"] for L in cs.CMP_DK_SWEEP) else 1


if __name__ == "__main__":
    sys.exit(main())
