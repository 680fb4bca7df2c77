"""Point Aggregation Graph (paper §IV): naive construction (Alg 2),
Dynamic Representation Selection (Alg 3) and Graph-based Redundancy (§IV-C,
Def 5 RNG occlusion over nearest-neighbor + routing-path candidates).

Geometry conventions: pairwise distances are squared (paper's δ);
aggregation radii are TRUE distances (sphere geometry / triangle
inequalities in §V-A need metric distances), so radius checks compare
sqrt(δ). Recorded in DESIGN.md §10.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.build import PG, build_pg, insert_nodes
from repro_torch.core.graph_search import greedy_search
from repro_torch.device import DeviceLike, resolve_device

INF = np.float32(3.4e38)


@dataclasses.dataclass
class PAG:
    """The in-memory half of the index (aggregation points + PG + radii +
    partition membership). Residual vectors live in the storage layer."""
    pg: PG
    node_src: np.ndarray    # [m_cap] original dataset id of each agg point
    radius: np.ndarray      # [m_cap] f32 TRUE-distance aggregation radius
    plist: np.ndarray       # [m_cap, cap] int32 original ids, pad -1
    pcount: np.ndarray      # [m_cap] int32
    cap: int
    n_total: int
    build_stats: Dict = dataclasses.field(default_factory=dict)

    @property
    def n_parts(self) -> int:
        return self.pg.n_nodes

    def arrays(self):
        return {
            "A": self.pg.A, "nbrs": self.pg.nbrs,
            "node_src": self.node_src, "radius": self.radius,
            "plist": self.plist, "pcount": self.pcount,
            "meta": np.array([self.pg.n_nodes, self.pg.entry,
                              self.pg.R_prune, self.cap, self.n_total],
                             np.int64),
        }

    @classmethod
    def from_arrays(cls, arrs) -> "PAG":
        n_nodes, entry, r_prune, cap, n_total = [int(v) for v in
                                                 arrs["meta"]]
        pg = PG(A=np.asarray(arrs["A"]), nbrs=np.asarray(arrs["nbrs"]),
                n_nodes=n_nodes, entry=entry, R_prune=r_prune)
        return cls(pg=pg, node_src=np.asarray(arrs["node_src"]),
                   radius=np.asarray(arrs["radius"]),
                   plist=np.asarray(arrs["plist"]),
                   pcount=np.asarray(arrs["pcount"]), cap=cap,
                   n_total=n_total)


def _neighbor_radii(pg: PG, ids: np.ndarray, gamma1: float) -> np.ndarray:
    """Per-node radius = gamma1-percentile of PG-neighbor TRUE distances."""
    nbrs = pg.nbrs[ids, :pg.R_prune]
    safe = np.minimum(nbrs, pg.m_cap - 1)
    diffs = pg.A[safe] - pg.A[ids][:, None, :]
    d2 = np.einsum("bcd,bcd->bc", diffs, diffs)
    valid = nbrs < pg.n_nodes
    d2 = np.where(valid, d2, INF)
    order = np.sort(d2, axis=1)
    cnt = valid.sum(axis=1)
    pos = np.clip((gamma1 * np.maximum(cnt - 1, 0)).astype(int), 0, None)
    r2 = order[np.arange(len(ids)), pos]
    r2 = np.where(cnt > 0, r2, 0.0)
    return np.sqrt(np.maximum(r2, 0.0)).astype(np.float32)


def _occlusion_filter(cand: np.ndarray, cand_d2: np.ndarray,
                      A: torch.Tensor, max_keep: int) -> np.ndarray:
    """Def 5 RNG rule over each row's candidate aggregation points.

    a1 occludes a2 (a1 closer to x than a2) if δ(a1, a2) < δ(a2, x).
    Returns a keep-mask; at most max_keep survivors per row (in distance
    order). Vectorized over rows; k is small (<=16). The [B, k, k, d]
    pairwise differences run on A's device (A is the PG arena there)."""
    b, k = cand.shape
    order = np.argsort(cand_d2, axis=1)
    cand = np.take_along_axis(cand, order, axis=1)
    d2 = np.take_along_axis(cand_d2, order, axis=1)
    pts = A[torch.from_numpy(np.minimum(cand, A.shape[0] - 1)).to(
        A.device)]                                      # [B, k, d]
    diffs = pts[:, :, None, :] - pts[:, None, :, :]
    pair = torch.einsum("bijd,bijd->bij", diffs, diffs).cpu().numpy()
    keep = np.ones((b, k), bool)
    kept_count = np.ones((b,), np.int32)  # first always kept
    for j in range(1, k):
        occluded = np.zeros((b,), bool)
        for i in range(j):
            occluded |= keep[:, i] & (pair[:, i, j] < d2[:, j])
        ok = ~occluded & (kept_count < max_keep)
        keep[:, j] = ok
        kept_count += ok.astype(np.int32)
    # undo ordering
    out = np.zeros_like(keep)
    np.put_along_axis(out, order, keep, axis=1)
    return out


def _accept_with_capacity(res_ids, agg, d2, ok, pcount, plist, cap):
    """Greedily accept (residual -> agg) assignments column-wise honoring
    per-partition capacity; nearest residuals win ties. Returns boolean
    accepted mask, updating pcount/plist in place."""
    b, k = agg.shape
    # a residual may list the same partition in several candidate columns
    # (path + beam unions): keep only the first ok occurrence per row
    ok = ok.copy()
    for j in range(1, k):
        dup_prev = ((agg[:, :j] == agg[:, j:j + 1]) & ok[:, :j]).any(axis=1)
        ok[:, j] &= ~dup_prev
    accepted = np.zeros((b, k), bool)
    for j in range(k):
        cand = np.where(ok[:, j])[0]
        if len(cand) == 0:
            continue
        order = cand[np.argsort(d2[cand, j], kind="stable")]
        a = agg[order, j]
        # position within same-agg group (stable sort trick)
        so = np.argsort(a, kind="stable")
        a_s = a[so]
        starts = np.r_[0, np.flatnonzero(a_s[1:] != a_s[:-1]) + 1]
        grp = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts,
                                                              len(a_s)]))
        pos_in_grp = np.arange(len(a_s)) - starts[grp]
        slot = pcount[a_s] + pos_in_grp
        acc_s = slot < cap
        rows = order[so][acc_s]
        aggs = a_s[acc_s]
        slots = slot[acc_s]
        plist[aggs, slots] = res_ids[rows]
        np.add.at(pcount, a_s[acc_s], 1)
        accepted[rows, j] = True
    return accepted


def build_pag(x: np.ndarray, *, p: float = 0.2, k: int = 8,
              lam: float = 3.0, gamma1: float = 1.0, gamma2: float = 0.9,
              redundancy: int = 4, use_drs: bool = True,
              use_path_redundancy: bool = True,
              R: int = 16, L_build: int = 48, L_assign: int = 32,
              batch: int = 2048, seed: int = 0,
              max_promote_rounds: int = 8,
              device: DeviceLike = None) -> PAG:
    """Algorithm 3 (with DRS+GR); use_drs=False gives Algorithm 2 (naive).

    Returns the in-memory PAG; residual vectors are addressed by original
    dataset ids (the storage layer materializes per-partition objects).
    The graph searches and prunes run on ``device`` (default: the CUDA
    card); the acceptance bookkeeping is numpy, as in the reference.
    """
    device = resolve_device(device)
    t0 = time.time()
    n, d = x.shape
    rng = np.random.default_rng(seed)
    m0 = max(int(p * n), 8)
    cap = max(int(lam / p), 4) if use_drs else n  # naive: unbounded
    cap = min(cap, n)

    agg_src = rng.choice(n, size=m0, replace=False).astype(np.int32)
    is_agg = np.zeros(n, bool)
    is_agg[agg_src] = True
    res_src = np.where(~is_agg)[0].astype(np.int32)

    m_cap = int(m0 * 2.0) + 1024
    pg = build_pg(x[agg_src], R=R, L=L_build, m_cap=m_cap, batch=batch,
                  seed=seed, device=device)
    t_graph = time.time() - t0

    node_src = np.full(m_cap, -1, np.int32)
    node_src[:m0] = agg_src
    radius = np.zeros(m_cap, np.float32)
    ids0 = np.arange(m0)
    if use_drs:
        radius[:m0] = _neighbor_radii(pg, ids0, gamma1)
        d_o = np.quantile(radius[:m0], gamma2)
        radius[:m0] = np.minimum(radius[:m0], d_o)
    else:
        radius[:m0] = np.float32(np.sqrt(3.4e37))
        d_o = radius[0]

    plist = np.full((m_cap, cap), -1, np.int32)
    pcount = np.zeros(m_cap, np.int32)

    pending = res_src
    n_promoted = 0
    for round_i in range(max_promote_rounds + 1):
        if len(pending) == 0:
            break
        force = round_i == max_promote_rounds  # last round: must assign
        promote: list = []
        for i in range(0, len(pending), batch):
            ids = pending[i:i + batch]
            n_real = len(ids)
            pad = batch - n_real  # fixed shapes -> one jit compile
            if pad:
                ids = np.concatenate([ids, ids[:1].repeat(pad)])
            A_dev, nbrs_dev, n_nodes, entry = pg.device_arrays(device)
            res = greedy_search(A_dev, nbrs_dev, n_nodes, entry,
                                torch.from_numpy(x[ids]).to(device),
                                L=L_assign, K=k)
            cand = res.ids.cpu().numpy()                # [B, k]
            cand_d2 = res.dists.cpu().numpy()
            if use_path_redundancy:
                # routing-path candidates: last hops of the search path
                path = res.path.cpu().numpy()[:, -k:]
                path_safe = np.minimum(path, pg.m_cap - 1)
                pdiff = pg.A[path_safe] - x[ids][:, None, :]
                pd2 = np.einsum("bcd,bcd->bc", pdiff, pdiff)
                pd2 = np.where(path < pg.n_nodes, pd2, INF)
                cand = np.concatenate([cand, path], axis=1)
                cand_d2 = np.concatenate([cand_d2, pd2], axis=1)
                # dedup (keep first occurrence by distance later)
                so = np.argsort(cand, axis=1, kind="stable")
                cs = np.take_along_axis(cand, so, axis=1)
                dup = np.zeros_like(cs, bool)
                dup[:, 1:] = cs[:, 1:] == cs[:, :-1]
                dd = np.take_along_axis(cand_d2, so, axis=1)
                dd = np.where(dup, INF, dd)
                np.put_along_axis(cand_d2, so, dd, axis=1)

            valid = (cand < pg.n_nodes) & (cand_d2 < INF)
            within = np.sqrt(np.maximum(cand_d2, 0)) <= radius[
                np.minimum(cand, m_cap - 1)]
            if force:
                within = within | (np.arange(cand.shape[1])[None, :]
                                   == np.argmin(cand_d2, axis=1)[:, None])
            ok = valid & within
            keep = _occlusion_filter(cand, np.where(ok, cand_d2, INF),
                                     A_dev, max_keep=max(redundancy, 1))
            ok &= keep
            if pad:
                ok[n_real:] = False
            accepted = _accept_with_capacity(
                ids, cand, cand_d2, ok, pcount, plist, cap)
            got = accepted[:n_real].any(axis=1)
            promote.extend(ids[:n_real][~got].tolist())

        pending = np.asarray(sorted(set(promote)), np.int32)
        if len(pending) and round_i < max_promote_rounds:
            # Alg 3 step 3: promote unassignable residuals into the PG
            if pg.n_nodes + len(pending) > pg.m_cap:
                extra = len(pending) + 1024
                _grow_pg(pg, extra)
                node_src = _grow(node_src, -1, extra)
                radius = _grow(radius, 0.0, extra)
                plist = _grow(plist, -1, extra)
                pcount = _grow(pcount, 0, extra)
                m_cap = pg.m_cap
            new_ids = insert_nodes(pg, x[pending], L=L_build,
                                   device=device)
            node_src[new_ids] = pending
            r_new = _neighbor_radii(pg, new_ids, gamma1)
            radius[new_ids] = np.minimum(r_new, d_o) if use_drs else \
                np.float32(np.sqrt(3.4e37))
            n_promoted += len(pending)
            pending = np.array([], np.int32)  # promoted ones are agg now

    stats = {
        "n": n, "d": d, "m0": m0, "n_parts": pg.n_nodes,
        "n_promoted": n_promoted, "cap": cap,
        "graph_s": round(t_graph, 2), "total_s": round(time.time() - t0, 2),
        "p": p, "gamma1": gamma1, "gamma2": gamma2, "lam": lam,
        "redundancy": redundancy, "drs": use_drs,
    }
    return PAG(pg=pg, node_src=node_src, radius=radius, plist=plist,
               pcount=pcount, cap=cap, n_total=n, build_stats=stats)


def _grow(a: np.ndarray, fill, extra: int) -> np.ndarray:
    out = np.full((a.shape[0] + extra,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def _grow_pg(pg: PG, extra: int):
    """Grow the PG arena in place (sentinel ids remapped old->new m_cap)."""
    old = pg.m_cap
    new = old + extra
    A = np.zeros((new, pg.A.shape[1]), np.float32)
    A[:old] = pg.A
    nbrs = np.full((new, pg.nbrs.shape[1]), new, np.int32)
    nb = pg.nbrs.copy()
    nb[nb >= old] = new
    nbrs[:old] = nb
    pg.A, pg.nbrs = A, nbrs
