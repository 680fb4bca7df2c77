"""DiskANN baseline (Jayaram Subramanya et al., NeurIPS'19).

Memory: PQ codes (+codebook), resident on the card. Storage: per-node
objects packing the full vector and the adjacency list (DiskANN's sector
layout). Search: beam traversal guided by in-memory PQ distances, but
every expansion must FETCH the node object from storage to read its
neighbor list — one blocking I/O per hop. This serial-I/O dependency is
exactly why DiskANN degrades on high-latency distributed storage (paper
Fig 1a / Fig 10); candidates are already full-precision-reranked from the
fetched vectors (no extra pass).

The host keeps the reference's per-query loop (candidate list, visited
set, ``store.get`` order, ``QueryTimeline`` charges); each hop gathers
its neighbours' code rows on the card and scores them with one
``pq_adc`` launch, and the entry point's distance is one launch too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.baselines.pq import (
    PQCodebook,
    adc_distances,
    adc_lut,
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


def search_diskann(idx: DiskANNIndex, queries: np.ndarray,
                   store: ObjectStore, k: int = 10, L: int = 32,
                   beam_io: int = 4, prefix: str = "dk", n_shards: int = 1,
                   compute: Optional[ComputeModel] = None
                   ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Beam search with blocking per-hop node fetches.

    beam_io models DiskANN's beamwidth-way parallel I/O: up to beam_io
    node fetches issued together per hop (latency = max of the batch).
    Returns (ids, d2, per-query latency seconds)."""
    compute = compute or ComputeModel()
    dev = idx.codes.device
    qn = queries.shape[0]
    out_ids = np.full((qn, k), -1, np.int64)
    out_d2 = np.full((qn, k), np.float32(3.4e38))
    q_dev = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
        dev)
    lats = []
    for qi in range(qn):
        q = queries[qi]
        lut = adc_lut(idx.cb, q_dev[qi])
        tl = QueryTimeline()
        tl.add_compute(compute.scan(256, idx.cb.M))  # LUT build cost

        visited = set()
        exact: dict = {}
        entry_codes = idx.codes[idx.entry:idx.entry + 1]
        cand = [(float(adc_distances(lut, entry_codes)[0]), idx.entry)]
        io_time = 0.0
        while True:
            frontier = [c for c in sorted(cand)[:L]
                        if c[1] not in visited][:beam_io]
            if not frontier:
                break
            batch_lat = 0.0
            nbr_all = []
            for _, node in frontier:
                visited.add(node)
                obj, lat = store.get(f"{prefix}/{node % n_shards}/{node}")
                batch_lat = max(batch_lat, lat)   # beam_io-parallel fetch
                vec = obj[: idx.d]
                exact[node] = float(((vec - q) ** 2).sum())
                nbrs = obj[idx.d:].astype(np.int64)
                nbr_all.extend([b for b in nbrs.tolist() if b < idx.n
                                and b not in visited])
            io_time += batch_lat                  # blocking: stalls compute
            # full-precision rerank of the fetched vectors (real compute)
            tl.add_compute(compute.scan(len(frontier), idx.d))
            if nbr_all:
                nbr_arr = np.asarray(sorted(set(nbr_all)), np.int64)
                rows = idx.codes[torch.from_numpy(nbr_arr).to(dev)]
                d_approx = adc_distances(lut, rows).cpu().numpy()
                tl.add_compute(compute.scan(len(nbr_arr), idx.cb.M))
                cand.extend(zip(d_approx.tolist(), nbr_arr.tolist()))
                cand = sorted(set(cand))[: 4 * L]

        items = sorted(exact.items(), key=lambda kv: kv[1])[:k]
        for j, (node, dd) in enumerate(items):
            out_ids[qi, j] = node
            out_d2[qi, j] = dd
        lats.append(tl.compute_s + io_time)
    return out_ids, out_d2, lats
