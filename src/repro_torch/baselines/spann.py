"""SPANN baseline (Chen et al., NeurIPS'21).

Memory: partition centroids, navigated via an in-memory PG over centroids
(standing in for SPTAG). Storage: posting lists. Build: balanced k-means
(flexible-balance penalty) + closure multi-assignment (each point joins
every centroid within (1+eps_closure) of its nearest — SPANN's boundary
redundancy). Search: centroid beam search; probe all centroids with
d <= (1+eps_probe) * d_min (capped); fetch postings in one parallel
blocking round; full-scan; top-k.

The closure assignment takes each point's 8 nearest centroids with
``topk_l2`` (the ``l2_topk`` kernel on the card), in chunks of points,
instead of the reference's full [n, n_parts] distance matrix; the
posting scan is the reference's per-query numpy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.build import PG, build_pg
from repro_torch.core.clustering import kmeans
from repro_torch.core.distances import topk_l2
from repro_torch.core.graph_search import greedy_search
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.storage.simulator import (
    ComputeModel,
    ObjectStore,
    QueryTimeline,
)

N_CLOSURE = 8   # centroids a point may join (the reference's argsort[:, :8])
CLOSURE_CHUNK = 8192   # points per topk_l2 call of the closure assignment


@dataclasses.dataclass
class SPANNIndex:
    centroids: np.ndarray
    pg: PG                   # centroid navigation graph
    counts: np.ndarray
    n: int
    d: int
    build_stats: dict
    device: torch.device


def build_spann(x: np.ndarray, store: ObjectStore,
                points_per_part: int = 16, eps_closure: float = 0.15,
                max_postings: int = 64, prefix: str = "sp",
                n_shards: int = 1, seed: int = 0,
                kmeans_iters: int = 16, device: DeviceLike = None
                ) -> SPANNIndex:
    device = resolve_device(device)
    t0 = time.time()
    n, d = x.shape
    n_parts = max(n // points_per_part, 8)
    centers, assign = kmeans(x, n_parts, iters=kmeans_iters, seed=seed,
                             balance_weight=2.0, device=device)
    t_cluster = time.time() - t0

    # closure multi-assignment: join centroids within (1+eps)^2 * d_min
    c_dev = torch.from_numpy(centers).to(device)
    order, d2 = [], []
    for s in range(0, n, CLOSURE_CHUNK):
        xb = torch.from_numpy(np.ascontiguousarray(
            x[s:s + CLOSURE_CHUNK], np.float32)).to(device)
        ids, dd = topk_l2(xb, c_dev, N_CLOSURE)
        order.append(ids.cpu().numpy())
        d2.append(dd.cpu().numpy())
    order, d2 = np.concatenate(order), np.concatenate(d2)
    d_min = d2[:, :1]
    member = d2 <= (1.0 + eps_closure) ** 2 * np.maximum(d_min, 1e-12)
    posts = [[] for _ in range(n_parts)]
    for i in range(n):
        for j, ok in zip(order[i].tolist(), member[i].tolist()):
            if ok and len(posts[j]) < max_postings:
                posts[j].append(i)
    counts = np.array([len(p) for p in posts], np.int32)
    for j, p in enumerate(posts):
        obj = np.zeros((len(p), d + 1), np.float32)
        if p:
            ids = np.asarray(p)
            obj[:, 0] = ids
            obj[:, 1:] = x[ids]
        store.put(f"{prefix}/{j % n_shards}/{j}", obj)

    pg = build_pg(centers, R=16, L=32, seed=seed, device=device)
    stats = {"n": n, "d": d, "n_parts": n_parts,
             "cluster_s": round(t_cluster, 2),
             "total_s": round(time.time() - t0, 2),
             "avg_posting": float(counts.mean()),
             "replication": float(counts.sum() / n)}
    return SPANNIndex(centroids=centers, pg=pg, counts=counts, n=n, d=d,
                      build_stats=stats, device=device)


def search_spann(idx: SPANNIndex, queries: np.ndarray, store: ObjectStore,
                 k: int = 10, L: int = 32, eps_probe: float = 0.3,
                 n_probe_max: int = 32, prefix: str = "sp",
                 n_shards: int = 1,
                 compute: Optional[ComputeModel] = None
                 ) -> Tuple[np.ndarray, np.ndarray, list]:
    compute = compute or ComputeModel()
    qn = queries.shape[0]
    dev = idx.device
    A_dev, nbrs_dev, n_nodes, entry = idx.pg.device_arrays(dev)
    q_dev = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
        dev)
    res = greedy_search(A_dev, nbrs_dev, n_nodes, entry, q_dev, L=L,
                        K=min(L, n_probe_max))
    beam_ids = res.ids.cpu().numpy()
    beam_d2 = res.dists.cpu().numpy()
    hops = res.n_hops.cpu().numpy()

    out_ids = np.full((qn, k), -1, np.int64)
    out_d2 = np.full((qn, k), np.float32(3.4e38))
    lats = []
    width = idx.pg.nbrs.shape[1]
    for qi in range(qn):
        tl = QueryTimeline()
        tl.add_compute(compute.search_hop(int(hops[qi]) * width, idx.d))
        d_min = float(beam_d2[qi, 0])
        sel = [int(c) for c, dd in zip(beam_ids[qi], beam_d2[qi])
               if dd <= (1 + eps_probe) ** 2 * max(d_min, 1e-12)
               and c < idx.pg.n_nodes][:n_probe_max]
        cand_ids, cand_d2 = [], []
        max_lat = 0.0
        scan_cost = 0.0
        for pid in sel:
            if idx.counts[pid] == 0:
                continue
            obj, lat = store.get(f"{prefix}/{pid % n_shards}/{pid}")
            max_lat = max(max_lat, lat)      # parallel blocking round
            scan_cost += compute.scan(obj.shape[0], idx.d)
            diff = obj[:, 1:] - queries[qi][None]
            cand_ids.append(obj[:, 0].astype(np.int64))
            cand_d2.append(np.einsum("nd,nd->n", diff, diff))
        if cand_ids:
            ids = np.concatenate(cand_ids)
            dd = np.concatenate(cand_d2)
            order = np.lexsort((dd, ids))
            ids, dd = ids[order], dd[order]
            first = np.r_[True, ids[1:] != ids[:-1]]
            ids, dd = ids[first], dd[first]
            top = np.argsort(dd)[:k]
            out_ids[qi, : len(top)] = ids[top]
            out_d2[qi, : len(top)] = dd[top]
        lats.append(tl.compute_s + max_lat + scan_cost)
    return out_ids, out_d2, lats
