"""Prefetch-ahead pipelining (ROADMAP data-plane item).

The DSANN bet is hiding distributed-storage latency behind asynchronous
I/O *within* a batch (Alg 5). Prefetch-ahead extends the overlap
*across* micro-batches: while batch N runs its refine/scan stages, the
scheduler already issues batch N+1's probe-wave objects (the PQ code
objects under compression — small, cheap to speculate on) so that when
batch N+1 starts, its wave finds the payloads already in flight or
landed and pays only the *residual* latency ``max(0, ready - start)``.

Two pieces:

* ``predict_probes`` — the prediction hook's default implementation:
  replay the in-memory graph phase (traversal + APP, ``plan.probe_orders``
  — the exact code path ``search_pag`` uses) for the queued queries of
  the next micro-batch. The graph structure lives in memory (paper §IV:
  only partition payloads live on distributed storage), so prediction
  costs no storage I/O and its compute is the same traversal the next
  batch charges to its own timelines — nothing is double-counted on the
  event clock.

* ``PrefetchHandle`` — the issued wave: verified payloads keyed by
  storage key plus each key's event-clock ready time *relative to the
  issuing batch's start*. The frontend converts these to absolute clock
  times and feeds the next flush the residual latencies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.graph_search import greedy_search
from repro_torch.dataplane.plan import probe_orders
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class PrefetchHandle:
    """One issued prefetch wave (see module docstring)."""
    payload: str                                # PAYLOAD_FLOAT | _CODE
    issued_rel_s: float = 0.0                   # event-clock issue time
    objects: Dict[str, np.ndarray] = \
        dataclasses.field(default_factory=dict)  # key -> verified payload
    ready_rel_s: Dict[str, float] = \
        dataclasses.field(default_factory=dict)  # key -> arrival time
    nbytes: int = 0
    n_keys: int = 0                             # keys issued (incl. lost)

    def residuals(self, start_s: float) -> Dict[str, tuple]:
        """(object, residual latency) per key for a batch starting at
        absolute event-clock ``start_s`` — what ``search_pag`` consumes
        via its ``prefetched`` argument. ``ready_rel_s`` must already be
        on the same clock as ``start_s`` (the frontend shifts it)."""
        return {
            key: (obj, max(0.0, self.ready_rel_s[key] - start_s))
            for key, obj in self.objects.items()
        }


def predict_probes(pag, queries: np.ndarray, cfg,
                   device: DeviceLike = None) -> list:
    """Exact probe prediction for a pending micro-batch: run the
    in-memory graph phase + APP replay that ``search_pag`` itself runs
    (same ``probe_orders`` code path ⇒ the prediction IS the next
    batch's probe list, partition for partition)."""
    device = resolve_device(device)
    pg = pag.pg
    A_dev, nbrs_dev, n_nodes, entry = pg.device_arrays(device)
    res = greedy_search(A_dev, nbrs_dev, n_nodes, entry,
                        torch.from_numpy(np.ascontiguousarray(
                            queries, np.float32)).to(device),
                        L=cfg.L, K=cfg.L)
    return probe_orders(pag, res.path.cpu().numpy(),
                        res.path_dists.cpu().numpy(),
                        res.n_hops.cpu().numpy(), cfg.rho, cfg.n_probe_max)
