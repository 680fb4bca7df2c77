"""Distributed serving of the PAG index (DESIGN.md §6).

ShardedServing: partitions round-robined over shards; the replicated
in-memory PG routes queries; queries go through the BATCHED data plane
(core/search.py: cross-query coalesced get_many fetches, one masked
kernel launch per batch) unless cfg.engine overrides it. Shard failure ->
the router drops that shard's partitions (bounded recall degradation);
stragglers tamed by hedged duplicate fetches. ``device`` is where the
graph phase and the scan kernels run (default: the CUDA card).

make_anns_serve_step / make_anns_assign_step: the pod-scale data plane,
the reference's ``shard_map`` steps on a ``launch.mesh.Mesh`` of
``torch.distributed`` ranks. Every rank holds its block of the database
(the "distributed storage" tier is the mesh's aggregate device memory),
scans it through a CUDA kernel (``l2_topk_masked`` to serve, ``l2_topk``
to assign) and merges k-candidates with ``all_gather`` over each mesh
axis. Each rank calls the step with its own blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pag import PAG
from repro_torch.core.search import SearchConfig, search_pag
from repro_torch.device import DeviceLike
from repro_torch.distributed import shm
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.storage.simulator import ComputeModel, ObjectStore


# --------------------------------------------------------------------------
# router-level sharded serving (simulation-backed, exact results)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedServing:
    pag: PAG
    store: ObjectStore
    n_shards: int
    dim: int
    prefix: str = "part"
    replicas: int = 1           # replica layout written by write_partitions
    dead_shards: Set[int] = dataclasses.field(default_factory=set)
    resilient: Optional[object] = None   # long-lived ResilientStore
    device: DeviceLike = None   # graph phase + kernels (None: the card)

    def kill_shard(self, shard: int):
        self.dead_shards.add(shard)
        self.store.kill_prefix(f"{self.prefix}/{shard}/")

    def revive(self):
        self.dead_shards.clear()
        self.store.revive_all()

    def enable_resilience(self, policy) -> "ShardedServing":
        """Install a long-lived retry/failover/breaker plane: breaker
        state persists across searches, so a dead shard stops eating
        retry budget after a few queries instead of per batch."""
        from repro_torch.storage.resilience import ResilientStore
        self.resilient = ResilientStore(self.store, policy)
        return self

    def rebalance(self, new_n_shards: int):
        """Elastic scaling: re-map partitions across a new shard count by
        rewriting objects under the new prefix layout (on a real cluster
        this is a background copy between storage nodes; results are
        identical throughout because the router owns the mapping)."""
        moved = 0
        for pid in range(self.pag.n_parts):
            old_key = f"{self.prefix}/{pid % self.n_shards}/{pid}"
            new_key = f"{self.prefix}/{pid % new_n_shards}/{pid}"
            if old_key == new_key:
                continue
            obj = self.store._data.get(old_key)
            if obj is None:
                continue
            self.store.put(new_key, obj)
            del self.store._data[old_key]
            moved += 1
        self.n_shards = new_n_shards
        return moved

    def search(self, queries: np.ndarray, cfg: SearchConfig,
               compute: Optional[ComputeModel] = None, **kw):
        """``**kw`` passes the micro-batch pipeline arguments through to
        ``search_pag`` (``prefetched`` / ``prefetch_probes`` /
        ``trace_t0_s`` — see ``serving.engine.AnnsFrontend``)."""
        if self.replicas > 1 and cfg.replicas == 1:
            cfg = dataclasses.replace(cfg, replicas=self.replicas)
        if self.resilient is not None and cfg.resilience is None:
            cfg = dataclasses.replace(cfg, resilience=self.resilient)
        return search_pag(self.pag, self.dim, queries, self.store, cfg,
                          compute=compute, prefix=self.prefix,
                          n_shards=self.n_shards,
                          dead_shard_fallback=True, device=self.device,
                          **kw)


# --------------------------------------------------------------------------
# pod-scale data plane (torch.distributed over a launch.mesh.Mesh)
# --------------------------------------------------------------------------

def _via_host(mesh: Mesh, axis: str, t: torch.Tensor) -> bool:
    """A CUDA ``t`` under a gloo group: ranks that share one card, whose
    exchanges go through the axis's shared host segment
    (``distributed/shm.py``)."""
    return t.is_cuda and dist.get_backend(mesh.groups[axis]) == "gloo"


def _segment(mesh: Mesh, axis: str, t: torch.Tensor) -> shm.Segment:
    """The axis group's shared segment, made on its first exchange."""
    seg = mesh.segments.get(axis)
    if seg is None:
        seg = mesh.segments[axis] = shm.Segment(mesh.groups[axis], t.device)
    return seg


def _stacked(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` (``all_gather``) stacked ``[n,
    *t.shape]`` in their order along it, on ``t``'s device (not for a
    ``_via_host`` exchange)."""
    parts = t.new_empty((mesh.shape[axis], *t.shape))
    dist.all_gather(list(parts.unbind(0)), t.contiguous(),
                    group=mesh.groups[axis])
    return parts


def _exchange(mesh: Mesh, axis: str, t: torch.Tensor, dim: int
              ) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` (``all_gather``) concatenated on
    ``dim`` in their order along it, on ``t``'s device: through the
    axis's shared host segment for ranks sharing a card, each part
    copied from the host into its place. Every collective of the port
    goes through one of ``_gather``, ``_sum_axis`` and
    ``_reduce_scatter``, which name it (the census's ``collectives``,
    ``launch/dryrun.py``, counts the bytes each of them receives)."""
    if _via_host(mesh, axis, t):
        if mesh.shape[axis] == 1:
            return t.clone()
        return _segment(mesh, axis, t).gather(t, dim)
    return torch.cat(list(_stacked(mesh, axis, t).unbind(0)), dim)


def _gather(mesh: Mesh, axis: str, t: torch.Tensor, dim: int
            ) -> torch.Tensor:
    """An all-gather: n x ``t``'s bytes received."""
    return _exchange(mesh, axis, t, dim)


def _sum_axis(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` added in rank order, in ``t``'s
    dtype: the same bits on every rank of the line. Two ranks make one
    addition an element, which ``all_reduce`` gives alike on both, with
    half a gather's bytes (``t``'s received); more ranks gather every
    ``t`` (n x its bytes)."""
    if mesh.shape[axis] == 2:
        if _via_host(mesh, axis, t):
            return _segment(mesh, axis, t).sum_pair(t)
        out = t.clone()
        dist.all_reduce(out, group=mesh.groups[axis])
        return out
    parts = _exchange(mesh, axis, t[None], 0)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def slice_sum(parts: torch.Tensor, dim: int, start: int, size: int,
              device) -> torch.Tensor:
    """The sum over ``parts`` [n, ...] of each part's slice ``[start,
    start + size)`` along ``dim`` (of a part), added in rank order in the
    parts' dtype, on ``device``: each slice moved there on its own, so
    that only the slices, never the whole parts, reach it."""
    acc = parts[0].narrow(dim, start, size).to(device, copy=True)
    for part in parts[1:]:
        acc += part.narrow(dim, start, size).to(device)
    return acc


def _reduce_scatter(mesh: Mesh, axis: str, g: torch.Tensor, dim: int
                    ) -> torch.Tensor:
    """This rank's block along ``dim`` of the ranks' ``g`` summed over
    ``axis``, in rank order: a gather of every ``g`` (n x its bytes; gloo
    has no reduce-scatter) and a sum of this rank's slice of each
    (``slice_sum``; through the shared segment, only that slice of each
    part reaches the card)."""
    if _via_host(mesh, axis, g):
        if mesh.shape[axis] == 1:
            return g.clone()
        return _segment(mesh, axis, g).reduce_scatter(g, dim)
    size = g.shape[dim] // mesh.shape[axis]
    return slice_sum(_stacked(mesh, axis, g), dim,
                     mesh.axis_index(axis) * size, size, g.device)


def psum(mesh: Mesh, axes: Sequence[str], t: torch.Tensor) -> torch.Tensor:
    """``jax.lax.psum(t, axes)``, no gradient: summed over each axis in
    turn, in rank order along it (``_sum_axis``)."""
    for a in axes:
        t = _sum_axis(mesh, a, t)
    return t


def max_over(mesh: Mesh, axes: Sequence[str], t: torch.Tensor
             ) -> torch.Tensor:
    """``jax.lax.pmax(t, axes)``, no gradient: the elementwise max of the
    ranks' ``t`` over each axis in turn (an all-gather, n x ``t``'s
    bytes)."""
    t = t.detach()
    for a in axes:
        t = _gather(mesh, a, t[None], 0).amax(0)
    return t


class _Gather(torch.autograd.Function):
    """The gather forward; backward, each rank keeps its own block of the
    gathered gradient summed over the axis (a reduce-scatter, made of a
    gather and a rank-order sum: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(mesh, axis, t, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.mesh, ctx.axis, g, ctx.dim), None, None, \
            None


class _GatherOwn(torch.autograd.Function):
    """The gather forward; backward, each rank keeps its own block of the
    gathered gradient, unsummed: for a gathered tensor that every rank
    then consumes whole and alike, so that the gradient reaching it is
    the same on every rank (a sum would count it n times)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(mesh, axis, t, dim)

    @staticmethod
    def backward(ctx, g):
        size = g.shape[ctx.dim] // ctx.mesh.shape[ctx.axis]
        start = ctx.mesh.axis_index(ctx.axis) * size
        return g.narrow(ctx.dim, start, size), None, None, None


class _Sum(torch.autograd.Function):
    """``psum`` forward, the identity backward: for a sum that every rank
    consumes whole, so that each rank back-propagates only its own
    part."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return psum(mesh, axes, t)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """The identity forward, ``psum`` backward: for a tensor that every
    rank of the axes holds whole and feeds to its own part of a sum."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return psum(ctx.mesh, ctx.axes, g), None, None


def gather_axis(mesh: Mesh, axis: str, t: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """``jax.lax.all_gather(t, axis, axis=dim, tiled=True)``: the blocks of
    the ranks along ``axis`` concatenated on ``dim`` in their order along
    it. Under gloo a CUDA tensor crosses through the axis's shared host
    segment (the ranks share one card; ``distributed/shm.py``); under
    nccl it stays on the card. Its gradient is the
    reduce-scatter: each rank gets its block of the gathered gradient
    summed over the axis."""
    return _Gather.apply(t, mesh, axis, dim)


def gather_own(mesh: Mesh, axis: str, t: torch.Tensor,
               dim: int = 1) -> torch.Tensor:
    """``gather_axis``'s forward, whose gradient is this rank's block of
    the gathered gradient alone (no collective): for a gather whose whole
    result every rank of ``axis`` uses alike."""
    return _GatherOwn.apply(t, mesh, axis, dim)


def sum_over(mesh: Mesh, axes: Sequence[str], t: torch.Tensor
             ) -> torch.Tensor:
    """``psum`` over ``axes`` whose gradient is the identity."""
    return _Sum.apply(t, mesh, tuple(axes))


def copy_over(mesh: Mesh, axes: Sequence[str], t: torch.Tensor
              ) -> torch.Tensor:
    """``t`` itself, whose gradient is summed over ``axes``."""
    return _Copy.apply(t, mesh, tuple(axes))


def stable_topk(d2: torch.Tensor, ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``min(k, width)`` columns by (d2, column), ascending:
    ``jax.lax.top_k(-d2, k)``'s order, ties to the lower column."""
    d2, pos = torch.sort(d2, dim=1, stable=True)
    w = min(k, d2.shape[1])
    return d2[:, :w].contiguous(), torch.gather(ids, 1, pos[:, :w])


def merge_topk(mesh: Mesh, axes: Sequence[str], d2: torch.Tensor,
               ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hierarchical merge: for each axis in turn, gather the ranks'
    [Q, w] candidates along it and keep the stable top-k. Returns (ids,
    d2), the same on every rank of the gathered axes."""
    for a in axes:
        d2, ids = stable_topk(gather_axis(mesh, a, d2),
                              gather_axis(mesh, a, ids), k)
    return ids, d2


def linear_rank(mesh: Mesh) -> int:
    """This rank's block index: its coordinates row-major over the mesh
    axes, as the reference's serve step linearises them."""
    r = 0
    for a in mesh.axis_names:
        r = r * mesh.shape[a] + mesh.axis_index(a)
    return r


def gather_pools(db_block: torch.Tensor, rows: torch.Tensor
                 ) -> torch.Tensor:
    """``db_block[rows]``: [Q, C] local row ids -> pools [Q, C, d]."""
    q, c = rows.shape
    return db_block.index_select(0, rows.reshape(-1)).view(q, c, -1)


def serve_scan(queries: torch.Tensor, pools: torch.Tensor,
               rows: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's local scan: ``l2_topk_masked`` over each query's own
    pool, cut to the reference's ``min(k, C)`` columns (the kernel pads a
    narrower pool to k with ``(3.4e38, -1)``). Returns (d2, local ids)."""
    d2, local = ops.l2_topk_masked(queries, pools, rows, k)
    w = min(k, rows.shape[1])
    return d2[:, :w].contiguous(), local[:, :w].contiguous()


def make_anns_serve_step(mesh: Mesh, k: int = 100):
    """DSANN's serving data plane at pod scale: every rank owns a block of
    residual partitions (the whole database sharded over ALL mesh axes,
    row-major); the replicated in-memory PG has already produced, per
    query, the probed partitions' local row ids on each owner rank. The
    step gathers those rows (the async fetch), full-scans them with the
    ``l2_topk_masked`` kernel (ties to the lower pool position, so a row
    probed twice comes out twice, as in the reference) and merges top-k
    hierarchically across the mesh, axis by axis (the I/O+merge pattern
    of Alg 5).

    Inputs (this rank's): queries [Q, d] f32 (the same on every rank),
             db_block [N_loc, d] f32,
             rows [Q, P_loc * cap] int32 local row ids in [0, N_loc).
    Returns: (ids [Q, min(k, world * C)] int32 global row ids, d2 f32),
             the same on every rank.
    """
    axes = tuple(mesh.axis_names)

    def step(queries, db_block, rows):
        pools = gather_pools(db_block, rows)
        d2, local = serve_scan(queries, pools, rows, k)
        gids = local + linear_rank(mesh) * db_block.shape[0]
        return merge_topk(mesh, axes, d2, gids, k)

    return step


def assign_scan(res_block: torch.Tensor, agg_block: torch.Tensor, k: int,
                row_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's local scan: ``l2_topk`` of each chunk of ``row_chunk``
    residual rows against the whole aggregation block (ties to the lower
    id). Returns (d2, local ids) [n_local, k]."""
    parts = [ops.l2_topk(res_block[i:i + row_chunk], agg_block, k)
             for i in range(0, res_block.shape[0], row_chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def make_anns_assign_step(mesh: Mesh, k: int = 8, row_chunk: int = 4096,
                          col_chunk: int = 65536):
    """DRS/CIC assignment data plane: residual blocks sharded over the
    data axes (``pod`` and ``data``) find their k nearest aggregation
    points; the aggregation set (p*n, too big to replicate at billion
    scale) is sharded over the model axis, with a top-k merge over it —
    the dominant compute of index construction (Alg 3 line 16),
    distributed.

    The reference walks each row chunk over column chunks of the block
    with a running top-k; ``l2_topk`` gives the same top-k over the whole
    block in one launch a row chunk, so ``col_chunk`` only keeps the
    reference's limits: both chunks must divide their blocks and the
    column chunk hold k.

    Inputs (this rank's): res_block [n_local, d] f32 (its data block),
             agg_block [m_local, d] f32 (its model block).
    Returns: (ids [n_local, k] int32 global aggregation ids, d2 f32) of
             this rank's residual block; ``gather_rows`` assembles them.
    """
    def step(res_block, agg_block):
        n_local, m_local = res_block.shape[0], agg_block.shape[0]
        rc, cc = min(row_chunk, n_local), min(col_chunk, m_local)
        if n_local % rc or m_local % cc:
            raise ValueError(f"chunks ({rc}, {cc}) do not divide the "
                             f"blocks ({n_local}, {m_local})")
        if cc < k:
            raise ValueError(f"column chunk {cc} holds fewer than k={k}")
        d2, local = assign_scan(res_block, agg_block, k, rc)
        gids = local + mesh.axis_index("model") * m_local
        return merge_topk(mesh, ("model",), d2, gids, k)

    return step


def gather_rows(mesh: Mesh, *blocks: torch.Tensor):
    """The whole result of a step sharded over the data axes: each block
    gathered on its rows over ``data``, then ``pod`` (the reference's
    ``P(("pod", "data"))`` order)."""
    out = []
    for t in blocks:
        for a in reversed(data_axes(mesh)):
            t = gather_axis(mesh, a, t, dim=0)
        out.append(t)
    return tuple(out)
