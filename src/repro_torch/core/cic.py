"""Concurrent Index Construction (paper §IV-D, Algorithm 4).

Split the dataset into c partitions, build per-partition PGs independently
(the "many cheap machines" stage — embarrassingly parallel), then merge:
every point queries the graphs of its η-close partitions (δ(x, c_j) ≤ η
δ(x, c_i), squared form η²) and the union of its per-graph neighbor
candidates is robust-pruned back to R.

Complexity (paper Eq. 4): O(c · n/c · log(n/c)) build + η-limited merge,
vs O(n log n) monolithic. The partition builds, graph searches and
prunes run on the device; the bookkeeping is the reference's numpy.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.build import (
    PG,
    _medoid,
    build_pg,
    gathered_dist2,
    repair_connectivity,
)
from repro_torch.core.clustering import kmeans
from repro_torch.core.distances import cdist2
from repro_torch.core.graph_search import greedy_search, robust_prune
from repro_torch.device import DeviceLike, resolve_device

INF = np.float32(3.4e38)


def cic_build(x: np.ndarray, c: int = 4, R: int = 16, L: int = 48,
              eta: float = 2.0, k_merge: int = 12, seed: int = 0,
              batch: int = 1024, kmeans_iters: int = 4,
              stats: Dict = None, device: DeviceLike = None) -> PG:
    """Returns a merged global PG over x [n, d]."""
    device = resolve_device(device)
    t0 = time.time()
    n, d = x.shape
    centers, assign = kmeans(x, c, iters=kmeans_iters, seed=seed,
                             balance_weight=1.0, device=device)
    part_ids = [np.where(assign == j)[0] for j in range(c)]

    # stage 1: independent per-partition builds (parallel on real fleet)
    t1 = time.time()
    sub_pgs: List[PG] = []
    for j in range(c):
        sub = build_pg(x[part_ids[j]], R=R, L=L, batch=batch,
                       seed=seed + j, device=device)
        sub_pgs.append(sub)
    t_build = time.time() - t1

    # global arena: concat sub-graphs with id offsets
    offsets = np.zeros(c + 1, np.int64)
    for j in range(c):
        offsets[j + 1] = offsets[j] + len(part_ids[j])
    perm = np.concatenate(part_ids)            # global row -> original id
    A = np.concatenate([x[p] for p in part_ids]).astype(np.float32)
    width = sub_pgs[0].nbrs.shape[1]
    nbrs = np.full((n, width), n, np.int32)
    for j, sub in enumerate(sub_pgs):
        nb = sub.nbrs[: sub.n_nodes].copy()
        nb = np.where(nb < sub.n_nodes, nb + offsets[j], n)
        nbrs[offsets[j]: offsets[j + 1]] = nb
    # entry: medoid of x is an original id -> map to global row
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    pg = PG(A=A, nbrs=nbrs, n_nodes=n, entry=int(inv[_medoid(x, device)]),
            R_prune=sub_pgs[0].R_prune)

    # stage 2: η-limited cross-partition merge (Alg 4 lines 4-13)
    t2 = time.time()
    x_dev = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    d2c = cdist2(x_dev, torch.from_numpy(centers).to(device)).cpu().numpy()
    own = d2c[np.arange(n), assign]
    eta2 = eta * eta
    extra_ids: List[np.ndarray] = [np.full((n, 0), n, np.int32)]
    # for each foreign partition j, search its graph with the points whose
    # η-rule admits j
    for j in range(c):
        sel = (d2c[:, j] <= eta2 * own) & (assign != j)
        rows = np.where(sel)[0]
        if len(rows) == 0:
            continue
        sub = sub_pgs[j]
        A_dev, nbrs_dev, n_nodes, entry = sub.device_arrays(device)
        found = np.full((n, k_merge), n, np.int32)
        for s in range(0, len(rows), batch):
            rs = rows[s:s + batch]
            r = greedy_search(A_dev, nbrs_dev, n_nodes, entry, x_dev[rs],
                              L=max(L // 2, k_merge), K=k_merge)
            ids = r.ids.cpu().numpy()
            found[rs] = np.where(ids < sub.n_nodes, ids + offsets[j], n)
        extra_ids.append(found)
    cand_foreign = np.concatenate(extra_ids, axis=1)   # [n, sum_k]

    # prune union(own nbrs, foreign candidates) per point, batched
    alpha2 = 1.2 * 1.2
    A_dev = torch.from_numpy(pg.A).to(device)
    for s in range(0, n, batch):
        rows = np.arange(s, min(s + batch, n))
        if len(rows) < batch:
            rows = np.concatenate([rows, rows[:1].repeat(
                batch - len(rows))])
        cand = np.concatenate([pg.nbrs[rows], cand_foreign[perm[rows]]],
                              axis=1)
        # note: cand_foreign is indexed by ORIGINAL id; rows are global
        cd = gathered_dist2(pg.A, np.minimum(cand, n - 1), pg.A[rows])
        cd = np.where((cand >= n) | (cand == rows[:, None]), INF, cd)
        pruned = robust_prune(torch.from_numpy(cand).to(device),
                              torch.from_numpy(cd).to(device), A_dev, n,
                              alpha2, R=pg.R_prune)
        pg.nbrs[rows, : pg.R_prune] = pruned.cpu().numpy()
    t_merge = time.time() - t2

    repair_connectivity(pg, device=device)
    if stats is not None:
        stats.update({
            "c": c, "n": n, "kmeans_s": round(t1 - t0, 2),
            "build_s": round(t_build, 2), "merge_s": round(t_merge, 2),
            "total_s": round(time.time() - t0, 2),
            "per_part_build_s": round(t_build / c, 2),
            "parallel_total_s": round((t1 - t0) + t_build / c + t_merge, 2),
        })
    # remap arena to ORIGINAL ids so downstream indexes agree with x rows
    remap = np.full(n + 1, n, np.int32)
    remap[:n] = perm.astype(np.int32)
    A_orig = np.empty_like(pg.A)
    A_orig[perm] = pg.A
    nbrs_orig = np.full_like(pg.nbrs, n)
    nbrs_orig[perm] = remap[np.minimum(pg.nbrs, n)]
    return PG(A=A_orig, nbrs=nbrs_orig, n_nodes=n,
              entry=int(perm[pg.entry]), R_prune=pg.R_prune)
