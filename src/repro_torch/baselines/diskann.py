"""DiskANN baseline (Jayaram Subramanya et al., NeurIPS'19).

Memory: PQ codes (+codebook), resident on the card. Storage: per-node
objects packing the full vector and the adjacency list (DiskANN's sector
layout). Search: beam traversal guided by in-memory PQ distances, but
every expansion must FETCH the node object from storage to read its
neighbor list — one blocking I/O per hop. This serial-I/O dependency is
exactly why DiskANN degrades on high-latency distributed storage (paper
Fig 1a / Fig 10); candidates are already full-precision-reranked from the
fetched vectors (no extra pass).

The search runs in two phases that give the reference's results bit for
bit. The traversal walks every query in lock-step, one wave at a time:
each unfinished query takes its frontier by the reference's rule, reads
its nodes' objects through the store's value step (no latency drawn,
nothing counted), computes their exact distances with the reference's
numpy expression and collects its new neighbours; then all queries'
neighbours are scored in one ``pq_adc_rows`` launch (one copy of the ids
up, one copy of the distances back), each under its own query's LUT, and
merged into the candidate lists, each kept sorted and distinct (the
reference re-sorts the whole list every hop; walking a thousand queries'
lists in turn made that re-sort a third slower, so the new pairs are
merged in as one sorted run instead). The replay then charges the fetches
query by query, hop by hop, in the reference's order, through
``store.get``: the latency draws come from the store's one RNG in the
reference's sequence.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.baselines.pq import (
    PQCodebook,
    adc_distances_rows,
    adc_luts,
    encode_pq,
    train_pq,
)
from repro_torch.core.build import build_pg
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.storage.simulator import (
    ComputeModel,
    ObjectStore,
    QueryTimeline,
)


@dataclasses.dataclass
class DiskANNIndex:
    codes: torch.Tensor     # [n, M] uint8, in the card's memory
    cb: PQCodebook
    entry: int
    n: int
    d: int
    R: int
    build_stats: dict


def build_diskann(x: np.ndarray, store: ObjectStore, R: int = 16,
                  L: int = 48, M: int = 8, prefix: str = "dk",
                  n_shards: int = 1, seed: int = 0,
                  device: DeviceLike = None) -> DiskANNIndex:
    device = resolve_device(device)
    t0 = time.time()
    n, d = x.shape
    pg = build_pg(x, R=R, L=L, seed=seed, device=device)
    t_graph = time.time() - t0
    cb = train_pq(x, M=M, seed=seed, device=device)
    codes = torch.from_numpy(encode_pq(cb, x, device=device)).to(device)
    t_pq = time.time() - t0 - t_graph
    # node objects: [d + width] floats (vector + padded adjacency)
    width = pg.nbrs.shape[1]
    objs = np.empty((n, d + width), np.float32)
    objs[:, :d] = x
    objs[:, d:] = pg.nbrs[:n]
    for i in range(n):
        store.put(f"{prefix}/{i % n_shards}/{i}", objs[i])
    stats = {"n": n, "d": d, "graph_s": round(t_graph, 2),
             "pq_s": round(t_pq, 2),
             "total_s": round(time.time() - t0, 2)}
    return DiskANNIndex(codes=codes, cb=cb, entry=pg.entry, n=n, d=d,
                        R=width, build_stats=stats)


@dataclasses.dataclass
class _Walk:
    """One query's traversal state: the reference's candidate list,
    visited set and exact distances, its timeline's compute charges, and
    the keys each hop fetched (replayed later through ``store.get``)."""
    cand: list              # sorted, distinct (distance, id) pairs
    tl: QueryTimeline
    visited: set = dataclasses.field(default_factory=set)
    exact: dict = dataclasses.field(default_factory=dict)
    hops: list = dataclasses.field(default_factory=list)
    cand_ids: set = dataclasses.field(default_factory=set)


def search_diskann(idx: DiskANNIndex, queries: np.ndarray,
                   store: ObjectStore, k: int = 10, L: int = 32,
                   beam_io: int = 4, prefix: str = "dk", n_shards: int = 1,
                   compute: Optional[ComputeModel] = None
                   ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Beam search with blocking per-hop node fetches.

    beam_io models DiskANN's beamwidth-way parallel I/O: up to beam_io
    node fetches issued together per hop (latency = max of the batch).
    Returns (ids, d2, per-query latency seconds), the reference's bit for
    bit, and leaves ``store``'s counters, metrics and latency draws as the
    reference does."""
    compute = compute or ComputeModel()
    dev = idx.codes.device
    qn = queries.shape[0]
    out_ids = np.full((qn, k), -1, np.int64)
    out_d2 = np.full((qn, k), np.float32(3.4e38))
    q_dev = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
        dev)
    luts = adc_luts(idx.cb, q_dev)
    # every query's entry point in one call
    entry_d = adc_distances_rows(luts, idx.codes, np.full(qn, idx.entry),
                                 np.arange(qn + 1)).cpu().numpy()
    walks = []
    for qi in range(qn):
        tl = QueryTimeline()
        tl.add_compute(compute.scan(256, idx.cb.M))  # LUT build cost
        walks.append(_Walk(cand=[(float(entry_d[qi]), idx.entry)], tl=tl,
                           cand_ids={idx.entry}))

    # traversal: one wave per hop of every unfinished query
    active = list(range(qn))
    while active:
        waiting, nbr_arrs, still = [], [], []
        for qi in active:
            w, q = walks[qi], queries[qi]
            # w.cand is kept sorted and unique: its head is the
            # reference's sorted(cand)[:L]
            frontier = [c for c in w.cand[:L]
                        if c[1] not in w.visited][:beam_io]
            if not frontier:
                continue
            still.append(qi)
            keys, nbr_all = [], []
            for _, node in frontier:
                w.visited.add(node)
                key = f"{prefix}/{node % n_shards}/{node}"
                keys.append(key)
                obj = store.value(key)
                vec = obj[: idx.d]
                w.exact[node] = float(((vec - q) ** 2).sum())
                nbrs = obj[idx.d:].astype(np.int64)
                nbr_all.extend([b for b in nbrs.tolist() if b < idx.n
                                and b not in w.visited])
            w.hops.append(keys)
            # full-precision rerank of the fetched vectors (real compute)
            w.tl.add_compute(compute.scan(len(frontier), idx.d))
            if nbr_all:
                nbr_arr = np.asarray(sorted(set(nbr_all)), np.int64)
                w.tl.add_compute(compute.scan(len(nbr_arr), idx.cb.M))
                waiting.append(qi)
                nbr_arrs.append(nbr_arr)
        if not still:
            break
        # every waiting query's neighbours: one copy up, one launch, one
        # copy back
        lens = np.zeros(qn, np.int64)
        lens[waiting] = [len(a) for a in nbr_arrs]
        rows = np.concatenate(nbr_arrs) if nbr_arrs else lens[:0]
        d_all = adc_distances_rows(
            luts, idx.codes, rows,
            np.concatenate([[0], np.cumsum(lens)])).cpu().numpy()
        start = 0
        for qi, nbr_arr in zip(waiting, nbr_arrs):
            w = walks[qi]
            d_approx = d_all[start:start + len(nbr_arr)]
            start += len(nbr_arr)
            # the reference's sorted(set(cand + new))[:4L], as a merge of
            # two sorted runs. A node's distance is one float in one
            # search, so a pair repeats exactly when its id does
            new = [(dd, b) for dd, b in zip(d_approx.tolist(),
                                            nbr_arr.tolist())
                   if b not in w.cand_ids]
            new.sort()
            merged = sorted(w.cand + new)
            w.cand = merged[: 4 * L]
            w.cand_ids.update(b for _, b in new)
            w.cand_ids.difference_update(b for _, b in merged[4 * L:])
        active = still

    # replay: the fetches charged in the reference's order
    lats = []
    for qi, w in enumerate(walks):
        io_time = 0.0
        for keys in w.hops:
            batch_lat = 0.0
            for key in keys:
                _, lat = store.get(key)
                batch_lat = max(batch_lat, lat)   # beam_io-parallel fetch
            io_time += batch_lat                  # blocking: stalls compute
        items = sorted(w.exact.items(), key=lambda kv: kv[1])[:k]
        for j, (node, dd) in enumerate(items):
            out_ids[qi, j] = node
            out_d2[qi, j] = dd
        lats.append(w.tl.compute_s + io_time)
    return out_ids, out_d2, lats
