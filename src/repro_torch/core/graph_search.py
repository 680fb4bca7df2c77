"""Algorithm 1: batched greedy (beam) search on a proximity graph.

The graph is a padded adjacency matrix ``nbrs [m_cap, R]`` (sentinel =
m_cap for missing edges) over points ``A [m_cap, d]`` of which the first
``n_nodes`` rows are valid. The reference ``vmap``s a ``while_loop`` over
queries; here the batch dimension is written out and every query runs
the same hop loop. A query whose frontier is empty is frozen (its beam,
path, visited set and hop count no longer move) while the others go on;
the loop asks the device once per block of hops whether any query is
still live, and on the card every hop but the first is a CUDA graph
replay.
The visited set is a ``[Q, m_cap + 1]`` bool mask (fine at the
aggregation-point scales PAG keeps in memory: m = p*n).

Stable sorts (``torch.argsort(..., stable=True)``) and first-index
``argmin`` reproduce the reference's dedup and tie rules.

Also returns the expansion order (= the routing path the paper's
Routing-Path Redundancy and the asynchronous search consume) and the
per-hop best-unexpanded distances (consumed by the APP early-stop replay).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.core.distances import sq_norms

INF = 3.4e38   # float32 sentinel distance (rounds to the reference's)


class SearchResult(NamedTuple):
    ids: torch.Tensor         # [Q, K] nearest candidate ids (padded m_cap)
    dists: torch.Tensor       # [Q, K] squared distances
    path: torch.Tensor        # [Q, H] expansion order (padded m_cap)
    path_dists: torch.Tensor  # [Q, H] distance of each expanded node
    n_hops: torch.Tensor      # [Q]


def _rows_dist2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q [Q, d], x [Q, C, d] -> [Q, C] = |q|^2 - 2 q.x + |x|^2 clamped."""
    qx = torch.bmm(x, q[:, :, None])[:, :, 0]
    return (sq_norms(q)[:, None] - 2.0 * qx + sq_norms(x)).clamp_min(0.0)


def _first_dup(ids: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Mask over ``order`` (a stable argsort of ids): True at every later
    copy of an id."""
    sid = ids.gather(1, order)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    return dup


def _merge_beam(c_ids, c_d, c_exp, new_ids, new_d, L):
    """Merge candidates, dedup, keep best L by distance (row-wise)."""
    ids = torch.cat([c_ids, new_ids], 1)
    ds = torch.cat([c_d, new_d], 1)
    exp = torch.cat([c_exp, torch.zeros_like(new_ids, dtype=torch.bool)], 1)
    # dedup: mark later duplicates as INF
    order = torch.argsort(ids, dim=1, stable=True)
    ds_o = ds.gather(1, order).masked_fill(_first_dup(ids, order), INF)
    ds = ds.scatter(1, order, ds_o)
    keep = torch.argsort(ds, dim=1, stable=True)[:, :L]
    return ids.gather(1, keep), ds.gather(1, keep), exp.gather(1, keep)


HOP_BLOCK = 16        # hops run between two host checks of the frontier


class _Beam:
    """The search state of a batch of ``qn`` queries over one graph,
    advanced in place, one hop at a time: static tensors, so that on the
    card one hop is captured as a CUDA graph (``graphed``) and replayed
    for every hop after it. The graph reads ``A`` and ``nbrs`` where the
    call that captured it found them; it lives as long as the call."""

    def __init__(self, A, n_nodes: int, qn: int, L: int, max_hops: int,
                 graphed: bool):
        dev, m_cap = A.device, A.shape[0]
        self.n_nodes, self.L, self.max_hops, self.m_cap = \
            n_nodes, L, max_hops, m_cap
        self.graphed, self.graph = graphed, None
        self.rows = torch.arange(qn, device=dev)
        self.q = torch.empty((qn, A.shape[1]), dtype=torch.float32,
                             device=dev)
        self.c_ids = torch.empty((qn, L), dtype=torch.long, device=dev)
        self.c_d = torch.empty((qn, L), dtype=torch.float32, device=dev)
        self.c_exp = torch.empty((qn, L), dtype=torch.bool, device=dev)
        self.visited = torch.empty((qn, m_cap + 1), dtype=torch.bool,
                                   device=dev)
        self.path = torch.empty((qn, max_hops), dtype=torch.long,
                                device=dev)
        self.path_d = torch.empty((qn, max_hops), dtype=torch.float32,
                                  device=dev)
        self.hop_count = torch.empty(qn, dtype=torch.long, device=dev)

    def reset(self, A, queries: torch.Tensor, entries: torch.Tensor
              ) -> None:
        """Each query's beam holds its entry point alone."""
        self.q.copy_(queries)
        self.c_ids.fill_(self.m_cap)
        self.c_ids[:, 0] = entries
        self.c_d.fill_(INF)
        self.c_d[:, 0] = _rows_dist2(self.q, A[entries][:, None, :])[:, 0]
        self.c_exp.zero_()
        self.visited.zero_()
        self.visited[self.rows, entries] = True
        self.path.fill_(self.m_cap)
        self.path_d.fill_(INF)
        self.hop_count.zero_()

    def live(self) -> torch.Tensor:
        """[Q] whether a query's beam still holds an unexpanded candidate."""
        return ((~self.c_exp) & (self.c_d < INF)).any(1)

    def hop(self, A, nbrs) -> None:
        """One hop. Graphed, the first is run eagerly on a side stream (the
        warm-up a capture needs) and then captured, not run; every later
        one replays the capture."""
        if not self.graphed:
            self.step(A, nbrs)
        elif self.graph is not None:
            self.graph.replay()
        else:
            stream = torch.cuda.Stream(A.device)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self.step(A, nbrs)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(capture_error_mode="thread_local")
                self.step(A, nbrs)
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(stream)
            self.graph = graph

    def step(self, A, nbrs) -> None:
        """One hop: every live query expands its best unexpanded candidate;
        a frozen query's beam, path, visited set and hop count stay as
        they are."""
        m_cap, rows = self.m_cap, self.rows
        c_ids, c_d, c_exp = self.c_ids, self.c_d, self.c_exp
        active = self.live()
        live = active[:, None]
        masked = c_d.masked_fill(c_exp, INF)
        j = masked.argmin(1)
        cur = c_ids[rows, j]
        cur_d = c_d[rows, j]
        exp_new = c_exp.scatter(1, j[:, None], True)
        at = self.hop_count.clamp(max=self.max_hops - 1)[:, None]
        self.path.scatter_(1, at, torch.where(live, cur[:, None],
                                              self.path.gather(1, at)))
        self.path_d.scatter_(1, at, torch.where(live, cur_d[:, None],
                                                self.path_d.gather(1, at)))

        nb = nbrs[cur.clamp(max=m_cap - 1)]                     # [Q, R]
        nb = nb.masked_fill(cur[:, None] >= m_cap, m_cap)
        nb_v = nb.clamp(max=m_cap)
        valid = (nb < self.n_nodes) & ~self.visited.gather(1, nb_v)
        nd = _rows_dist2(self.q, A[nb.clamp(max=m_cap - 1)])
        nd = nd.masked_fill(~valid, INF)
        # frozen queries mark only the sentinel column
        self.visited.scatter_(1, nb_v.masked_fill(~live, m_cap), True)

        n_ids, n_d, n_exp = _merge_beam(c_ids, c_d, exp_new, nb, nd, self.L)
        c_ids.copy_(torch.where(live, n_ids, c_ids))
        c_d.copy_(torch.where(live, n_d, c_d))
        c_exp.copy_(torch.where(live, n_exp, c_exp))
        self.hop_count.add_(active.long())


def greedy_search(A: torch.Tensor, nbrs: torch.Tensor, n_nodes: int,
                  entry: Union[int, torch.Tensor], queries: torch.Tensor, *,
                  L: int = 64, K: int = 10, max_hops: int = 0,
                  block: int = 0) -> SearchResult:
    """Beam search. A [m_cap, d]; nbrs [m_cap, R] (int64); entry scalar id
    or per-query [Q] ids; queries [Q, d], all on one device. A query stops
    when its beam has no unexpanded candidates.

    The hops run in blocks of ``block`` with one host check a block of
    whether any query is live (a hop on frozen queries changes nothing, so
    the result is the per-hop loop's bit for bit); on the card the first
    hop is captured as a CUDA graph and every later one is a replay of it.
    ``block`` 0 takes HOP_BLOCK; 1 is the per-hop loop, every hop launched
    op by op."""
    block = block or HOP_BLOCK
    max_hops = max_hops or (L + 32)
    qn = queries.shape[0]
    entries = torch.as_tensor(entry, dtype=torch.long,
                              device=A.device).expand(qn)
    if A.is_cuda:
        A, nbrs = A.contiguous(), nbrs.contiguous()
    beam = _Beam(A, n_nodes, qn, L, max_hops, A.is_cuda and block > 1)
    beam.reset(A, queries.float(), entries)
    done = 0
    while done < max_hops and bool(beam.live().any()):  # a host sync
        n = min(block, max_hops - done)
        for _ in range(n):
            beam.hop(A, nbrs)
        done += n

    order = torch.argsort(beam.c_d, dim=1, stable=True)[:, :K]
    return SearchResult(beam.c_ids.gather(1, order),
                        beam.c_d.gather(1, order), beam.path, beam.path_d,
                        beam.hop_count)


def robust_prune(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                 A: torch.Tensor, n_nodes: int, alpha: float, *, R: int
                 ) -> torch.Tensor:
    """DiskANN/RNG-style diverse pruning, row-wise.

    cand_ids/cand_d [B, C] sorted-or-not candidate sets; returns [B, R]
    padded with m_cap. Occlusion rule: drop y if exists selected s with
    alpha * δ(s, y) < δ(p, y)  (squared-distance form of Def 5 / DiskANN).
    """
    m_cap = A.shape[0]
    b = cand_ids.shape[0]
    rows = torch.arange(b, device=A.device)
    order = torch.argsort(cand_d, dim=1, stable=True)
    ids = cand_ids.long().gather(1, order)
    ds = cand_d.float().gather(1, order)
    alive = (ids < n_nodes) & (ds < INF)
    # dedup
    so = torch.argsort(ids, dim=1, stable=True)
    alive = alive.scatter(1, so, alive.gather(1, so) & ~_first_dup(ids, so))
    x = A[ids.clamp(max=m_cap - 1)]                             # [B, C, d]
    out = torch.full((b, R), m_cap, dtype=torch.long, device=A.device)
    for i in range(R):
        masked = ds.masked_fill(~alive, INF)
        j = masked.argmin(1)
        ok = masked[rows, j] < INF
        sel = ids[rows, j]
        out[:, i] = torch.where(ok, sel, m_cap)
        alive[rows, j] = False
        # occlude: y dropped if alpha^2-scaled δ(sel, y) < δ(p, y)
        d_sel = _rows_dist2(A[sel.clamp(max=m_cap - 1)], x)
        alive &= ~((alpha * d_sel < ds) & ok[:, None])
    return out
