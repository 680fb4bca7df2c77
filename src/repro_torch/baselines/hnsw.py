"""HNSW-lite baseline (Malkov & Yashunin) — the paper's in-memory
comparison (Fig 9). Hierarchy of geometric-sized levels, each a Vamana-
built PG over its subset; search descends greedily, beam at level 0.
All in memory; latency = compute model only (and real wall-clock in the
memory benchmark). The level graphs are built and searched on the
index's device; the level sampling is the reference's numpy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.build import PG, build_pg
from repro_torch.core.graph_search import greedy_search
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.storage.simulator import ComputeModel


@dataclasses.dataclass
class HNSWIndex:
    levels: List[PG]            # level 0 = full set
    level_ids: List[np.ndarray]  # subset original ids per level
    n: int
    d: int
    build_stats: dict
    device: torch.device


def build_hnsw(x: np.ndarray, R: int = 16, L: int = 48,
               level_ratio: float = 0.1, min_level: int = 256,
               seed: int = 0, device: DeviceLike = None) -> HNSWIndex:
    device = resolve_device(device)
    t0 = time.time()
    n, d = x.shape
    rng = np.random.default_rng(seed)
    levels, level_ids = [], []
    ids = np.arange(n)
    while True:
        pg = build_pg(x[ids], R=R, L=L, seed=seed, device=device)
        levels.append(pg)
        level_ids.append(ids)
        if len(ids) <= min_level:
            break
        ids = np.sort(rng.choice(ids, size=max(int(len(ids) * level_ratio),
                                               min_level), replace=False))
    stats = {"n": n, "d": d, "n_levels": len(levels),
             "total_s": round(time.time() - t0, 2)}
    return HNSWIndex(levels=levels, level_ids=level_ids, n=n, d=d,
                     build_stats=stats, device=device)


def search_hnsw(idx: HNSWIndex, queries: np.ndarray, k: int = 10,
                L: int = 32, compute: Optional[ComputeModel] = None
                ) -> Tuple[np.ndarray, np.ndarray, list]:
    compute = compute or ComputeModel()
    dev = idx.device
    qn = queries.shape[0]
    q_dev = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
        dev)
    # descend: greedy (L=2) from top level down, carrying the entry point
    entry = np.full(qn, idx.levels[-1].entry, np.int64)
    total_hops = np.zeros(qn)
    width = idx.levels[0].nbrs.shape[1]
    for lvl in range(len(idx.levels) - 1, 0, -1):
        pg = idx.levels[lvl]
        A_dev, nbrs_dev, n_nodes, _ = pg.device_arrays(dev)
        res = greedy_search(A_dev, nbrs_dev, n_nodes,
                            torch.from_numpy(entry).to(dev), q_dev, L=2,
                            K=1)
        best = res.ids[:, 0].cpu().numpy()
        total_hops += res.n_hops.cpu().numpy()
        orig = idx.level_ids[lvl][np.minimum(best, pg.n_nodes - 1)]
        # map to next level's row (level ids are sorted; next level is a
        # superset of this level's subset)
        nxt = idx.level_ids[lvl - 1]
        entry = np.searchsorted(nxt, orig)

    pg0 = idx.levels[0]
    A_dev, nbrs_dev, n_nodes, _ = pg0.device_arrays(dev)
    res = greedy_search(A_dev, nbrs_dev, n_nodes,
                        torch.from_numpy(entry).to(dev), q_dev, L=L, K=k)
    out_ids = res.ids[:, :k].cpu().numpy().astype(np.int64)
    out_d2 = res.dists[:, :k].cpu().numpy()
    hops0 = res.n_hops.cpu().numpy()

    lats = [compute.search_hop(float(total_hops[qi] + hops0[qi]) * width,
                               idx.d) for qi in range(qn)]
    out_ids = np.where(out_ids < pg0.n_nodes, out_ids, -1)
    return out_ids, out_d2, lats
