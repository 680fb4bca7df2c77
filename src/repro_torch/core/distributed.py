"""Distributed serving of the PAG index (DESIGN.md §6).

ShardedServing: partitions round-robined over shards; the replicated
in-memory PG routes queries; queries go through the BATCHED data plane
(core/search.py: cross-query coalesced get_many fetches, one masked
kernel launch per batch) unless cfg.engine overrides it. Shard failure ->
the router drops that shard's partitions (bounded recall degradation);
stragglers tamed by hedged duplicate fetches. ``device`` is where the
graph phase and the scan kernels run (default: the CUDA card).

The reference's pod-scale ``shard_map`` steps are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set

import numpy as np

from repro_torch.core.pag import PAG
from repro_torch.core.search import SearchConfig, search_pag
from repro_torch.device import DeviceLike
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
