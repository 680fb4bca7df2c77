"""Proximity-graph construction (Vamana-style batched insert rounds).

Offline build = Python/numpy orchestration over batched tensor ops on
the device (greedy_search + robust_prune), the same structure DiskANN
uses (CPU-orchestrated). Two passes with alpha 1.0 -> 1.2, reverse-edge
insertion with overflow pruning.

The graph lives in a fixed-capacity arena (m_cap rows) so later PAG
promotion (Alg 3 step 3) can insert new nodes without reallocation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distances import cdist2
from repro_torch.core.graph_search import greedy_search, robust_prune


@dataclasses.dataclass
class PG:
    """Mutable proximity-graph arena.

    nbrs columns [0, R_prune) are alpha-RNG-pruned edges (rewritten by
    insert/reverse passes); columns [R_prune, R_total) are NSW-style random
    long-range edges fixed at init — they guarantee navigability across
    strongly clustered data (greedy beam search otherwise stalls at
    cluster boundaries; see tests/test_pag.py)."""
    A: np.ndarray          # [m_cap, d] float32 (rows >= n_nodes are zeros)
    nbrs: np.ndarray       # [m_cap, R_total] int32, sentinel = m_cap
    n_nodes: int
    entry: int
    R_prune: int = 0       # 0 -> whole width prunable

    def __post_init__(self):
        if self.R_prune == 0:
            self.R_prune = self.nbrs.shape[1]

    @property
    def m_cap(self) -> int:
        return self.A.shape[0]

    @property
    def R(self) -> int:
        return self.R_prune

    def device_arrays(self, device):
        """(A, nbrs as int64, n_nodes, entry) for ``greedy_search``."""
        return (torch.from_numpy(self.A).to(device),
                torch.from_numpy(self.nbrs).to(device, torch.long),
                int(self.n_nodes), int(self.entry))


def _medoid(x: np.ndarray, device) -> int:
    mean = x.mean(axis=0, keepdims=True)
    d2 = cdist2(torch.from_numpy(mean).to(device),
                torch.from_numpy(np.ascontiguousarray(x)).to(device))
    return int(d2.argmin())


MAX_REV_ADD = 8  # reverse-edge additions kept per destination per batch


def _reverse_edges(pg: PG, ids: np.ndarray, alpha2: float, device):
    """Insert reverse edges id -> (its new nbrs); prune overflowing rows.

    Vectorized: group by destination (sort + unique), cap additions per
    destination at MAX_REV_ADD, compact valid-existing + additions into a
    padded matrix, and robust-prune only the rows that overflow R.
    """
    m_cap, R = pg.m_cap, pg.R_prune
    src = np.repeat(ids.astype(np.int32), R)
    dst = pg.nbrs[ids, :R].reshape(-1)
    ok = dst < pg.n_nodes
    src, dst = src[ok], dst[ok]
    if len(dst) == 0:
        return
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    uniq, starts, counts = np.unique(dst_s, return_index=True,
                                     return_counts=True)
    n_u = len(uniq)
    adds = np.full((n_u, MAX_REV_ADD), m_cap, np.int32)
    take = np.minimum(counts, MAX_REV_ADD)
    for j in range(MAX_REV_ADD):  # MAX_REV_ADD is tiny; rows vectorized
        sel = take > j
        adds[sel, j] = src_s[starts[sel] + j]

    W = R + MAX_REV_ADD
    mat = np.concatenate([pg.nbrs[uniq, :R], adds], axis=1)  # [n_u, W]
    valid = mat < pg.n_nodes
    # dedup within row (keep first occurrence)
    sort_idx = np.argsort(np.where(valid, mat, m_cap + 1), axis=1,
                          kind="stable")
    mat_s = np.take_along_axis(mat, sort_idx, axis=1)
    dup = np.zeros_like(valid)
    dup[:, 1:] = mat_s[:, 1:] == mat_s[:, :-1]
    valid_s = (mat_s < pg.n_nodes) & ~dup
    n_valid = valid_s.sum(axis=1)
    # compact: stable-sort validity so real entries come first
    comp_idx = np.argsort(~valid_s, axis=1, kind="stable")
    compact = np.take_along_axis(mat_s, comp_idx, axis=1)
    compact = np.where(
        np.arange(W)[None, :] < n_valid[:, None], compact, m_cap)

    fits = n_valid <= R
    pg.nbrs[uniq[fits], :R] = compact[fits, :R]

    over = ~fits
    if over.any():
        rows = uniq[over]
        cand = compact[over]                                  # [B, W]
        cand_safe = np.minimum(cand, m_cap - 1)
        diffs = pg.A[cand_safe] - pg.A[rows][:, None, :]
        cd = np.einsum("bcd,bcd->bc", diffs, diffs).astype(np.float32)
        cd = np.where(cand < pg.n_nodes, cd, np.float32(3.4e38))
        pruned = robust_prune(
            torch.from_numpy(cand).to(device),
            torch.from_numpy(cd).to(device),
            torch.from_numpy(pg.A).to(device), pg.n_nodes, alpha2, R=R)
        pg.nbrs[rows, :R] = pruned.cpu().numpy()


def build_pg(x: np.ndarray, R: int = 16, L: int = 48,
             alpha: float = 1.2, m_cap: Optional[int] = None,
             batch: int = 1024, seed: int = 0, n_random: int = 2,
             passes: Tuple[float, ...] = (1.0, None), *,
             device) -> PG:
    """Build a Vamana-style PG over x [m, d] (+n_random NSW long edges);
    the batch searches and prunes run on ``device``."""
    m, d = x.shape
    m_cap = m_cap or m
    assert m_cap >= m
    rng = np.random.default_rng(seed)

    A = np.zeros((m_cap, d), np.float32)
    A[:m] = x
    nbrs = np.full((m_cap, R + n_random), m_cap, np.int32)
    # random init graph (prunable region) + fixed random long edges
    nbrs[:m, :] = rng.integers(0, m, size=(m, R + n_random))
    pg = PG(A=A, nbrs=nbrs, n_nodes=m, entry=_medoid(x, device),
            R_prune=R)

    passes = tuple(a if a is not None else alpha for a in passes)
    for a in passes:
        alpha2 = float(a * a)
        order = rng.permutation(m)
        for i in range(0, m, batch):
            ids = order[i:i + batch]
            if len(ids) < batch:  # fixed shapes: pad by repeating (benign)
                ids = np.concatenate([ids, order[: batch - len(ids)]])
            _insert_batch(pg, ids, L, alpha2, device)
    repair_connectivity(pg, device=device)
    return pg


def reachable_mask(pg: PG) -> np.ndarray:
    seen = np.zeros(pg.n_nodes, bool)
    seen[pg.entry] = True
    frontier = np.array([pg.entry])
    while len(frontier):
        nxt = pg.nbrs[frontier].reshape(-1)
        nxt = nxt[nxt < pg.n_nodes]
        nxt = nxt[~seen[nxt]]
        if len(nxt) == 0:
            break
        nxt = np.unique(nxt)
        seen[nxt] = True
        frontier = nxt
    return seen


def repair_connectivity(pg: PG, sample: int = 256, *, device):
    """Link unreachable nodes to their nearest reachable node (both
    directions), guaranteeing the entry point reaches every node. RNG-
    family graphs are connected in theory; batched approximate builds can
    drop bridge edges on strongly clustered data — this restores them,
    mirroring DiskANN implementations' final connect pass."""
    m_cap = pg.m_cap
    for _ in range(100):
        seen = reachable_mask(pg)
        if seen.all():
            return
        missing = np.where(~seen)[0]
        inside = np.where(seen)[0]
        sub = missing[:: max(len(missing) // sample, 1)][:sample]
        d2 = cdist2(torch.from_numpy(pg.A[sub]).to(device),
                    torch.from_numpy(pg.A[inside]).to(device))
        nearest = inside[d2.argmin(1).cpu().numpy()]
        for a, b in zip(sub.tolist(), nearest.tolist()):
            for u, v in ((a, b), (b, a)):
                row = pg.nbrs[u]
                free = np.where(row >= m_cap)[0]
                row[free[0] if len(free) else -1] = v


INSERT_CHUNK = 4096  # rows searched + pruned at once (bounds memory)


def _insert_batch(pg: PG, ids: np.ndarray, L: int, alpha2: float,
                  device):
    """Search, prune and link ``ids`` against the graph as it stands. Rows
    are independent until the edges are written, so they go in chunks of
    ``INSERT_CHUNK`` (a promotion round inserts every pending residual
    at once) with the same result as one pass."""
    A_dev, nbrs_dev, n_nodes, entry = pg.device_arrays(device)
    m_cap = pg.m_cap
    pruned = []
    for s in range(0, len(ids), INSERT_CHUNK):
        part = ids[s:s + INSERT_CHUNK]
        q = torch.from_numpy(pg.A[part]).to(device)
        res = greedy_search(A_dev, nbrs_dev, n_nodes, entry, q, L=L, K=L)
        # candidates: beam results + current neighbors + visited path
        cand = np.concatenate([res.ids.cpu().numpy(),
                               res.path.cpu().numpy(), pg.nbrs[part]],
                              axis=1)
        cand_safe = np.minimum(cand, m_cap - 1)
        diffs = pg.A[cand_safe] - pg.A[part][:, None, :]
        cd = np.einsum("bcd,bcd->bc", diffs, diffs).astype(np.float32)
        invalid = (cand >= pg.n_nodes) | (cand == part[:, None])
        cd = np.where(invalid, np.float32(3.4e38), cd)
        pruned.append(robust_prune(
            torch.from_numpy(cand).to(device),
            torch.from_numpy(cd).to(device),
            A_dev, pg.n_nodes, alpha2, R=pg.R_prune).cpu().numpy())
    pg.nbrs[ids, :pg.R_prune] = np.concatenate(pruned)
    _reverse_edges(pg, ids, alpha2, device)


def insert_nodes(pg: PG, new_x: np.ndarray, L: int = 48,
                 alpha: float = 1.2, *, device) -> np.ndarray:
    """Insert new points into the arena (PAG promotion). Returns their ids."""
    k = new_x.shape[0]
    assert pg.n_nodes + k <= pg.m_cap, "PG arena capacity exceeded"
    ids = np.arange(pg.n_nodes, pg.n_nodes + k, dtype=np.int32)
    pg.A[ids] = new_x
    pg.n_nodes += k
    n_rand = pg.nbrs.shape[1] - pg.R_prune
    if n_rand:
        rng = np.random.default_rng(int(pg.n_nodes))
        pg.nbrs[ids, pg.R_prune:] = rng.integers(
            0, pg.n_nodes, size=(k, n_rand))
    _insert_batch(pg, ids, L, float(alpha * alpha), device)
    return ids
