"""Fetch planning for the staged query data plane.

The data plane runs as a pipeline of stages (DESIGN.md §8, paper Alg 5):
*plan* (graph frontier → partition probe orders), *fetch waves* (the
``WaveScheduler``), *scan* (the ``ScanStage`` kernel launches). This
module owns the plan half:

* ``KeySpace`` — the v2 storage layout as one value: logical partition
  id → replica key chains for the float residual / PQ code payloads,
  plus the codebook keys. Built once per search call; every wave and
  the prefetch pipeline derive their keys from it instead of
  re-deriving ``replica_keys`` call sites.

* ``FetchPlan`` — one wave's worth of work, built once per batch from
  the per-query probe orders: the distinct partitions in first-probe
  order (the coalesced wave's issue order) and the probers of each
  partition (per-query charging + batched-scan amortization). The
  batched probe wave, the per-query reference wave, the PQ probe wave,
  and the exact refine wave all consume the same plan shape.

* ``probe_orders`` / ``app_probe_order`` — the APP early-stop replay
  (§V-A) shared by ``search_pag`` and the prefetch predictor
  (``dataplane.prefetch.predict_probes``), so predicted probes are the
  probes the next batch will actually issue.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.storage.resilience import codebook_keys, replica_keys

PAYLOAD_FLOAT = "float"   # float residual objects (v1 / v2 exact path)
PAYLOAD_CODE = "code"     # uint8 PQ code objects (v2 compressed path)


@dataclasses.dataclass(frozen=True)
class KeySpace:
    """Logical partition ids -> storage keys of the v2 payload layout."""
    prefix: str = "part"
    n_shards: int = 1
    replicas: int = 1

    def keys(self, pid: int, payload: str = PAYLOAD_FLOAT) -> List[str]:
        """Replica key chain (primary first) of one partition payload."""
        if payload == PAYLOAD_FLOAT:
            return replica_keys(self.prefix, pid, self.n_shards,
                                self.replicas)
        if payload == PAYLOAD_CODE:
            return replica_keys(self.prefix, pid, self.n_shards,
                                self.replicas, obj="pq")
        raise ValueError(f"unknown payload: {payload!r}")

    def codebook_keys(self) -> List[str]:
        return codebook_keys(self.prefix, self.replicas)


@dataclasses.dataclass
class FetchPlan:
    """One wave of the data plane: logical partitions -> storage keys.

    Built ONCE per batch from the per-query probe orders. ``order`` is
    the coalesced issue order (each distinct partition appears once, at
    its first prober's position); ``probers`` maps each partition to
    every query probing it (per-query latency charging, coalesced-scan
    amortization, cache ``account_shared``)."""
    probes_all: List[List[int]]
    keyspace: KeySpace
    payload: str = PAYLOAD_FLOAT
    order: List[int] = dataclasses.field(default_factory=list)
    probers: Dict[int, List[int]] = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, probes_all: List[List[int]], keyspace: KeySpace,
              payload: str = PAYLOAD_FLOAT) -> "FetchPlan":
        order: List[int] = []
        probers: Dict[int, List[int]] = {}
        for qi, probes in enumerate(probes_all):
            for pid in probes:
                if pid not in probers:
                    probers[pid] = []
                    order.append(pid)
                probers[pid].append(qi)
        return cls(probes_all, keyspace, payload, order, probers)

    @property
    def n_queries(self) -> int:
        return len(self.probes_all)

    def rkeys(self, pid: int) -> List[str]:
        """Replica key chain of ``pid`` for this wave's payload."""
        return self.keyspace.keys(pid, self.payload)

    def key(self, pid: int) -> str:
        """Primary key of ``pid`` (cache / bare-plane identity)."""
        return self.rkeys(pid)[0]

    def first_prober(self, pid: int) -> int:
        return self.probers[pid][0]


def app_probe_order(path: np.ndarray, path_d2: np.ndarray, hops: int,
                    radius: np.ndarray, rho: float, n_probe_max: int
                    ) -> List[int]:
    """APP (§V-A): walk the expansion order; keep partitions whose sphere
    can overlap the current best ball; stop when the current node's
    distance exceeds rho * (d_min + r_best + r_cur) (true distances).
    ``hops`` beyond the recorded path length is clamped (an empty path
    yields an empty probe order)."""
    probes: List[int] = []
    d_min = np.inf
    r_best = 0.0
    for t in range(min(hops, len(path))):
        node = int(path[t])
        d_cur = float(np.sqrt(max(path_d2[t], 0.0)))
        r_cur = float(radius[node])
        if d_cur > rho * (d_min + r_best + r_cur) and probes:
            break  # early stop (paper Fig 7 rule, scaled by rho)
        if d_cur < d_min:
            d_min, r_best = d_cur, r_cur
        probes.append(node)
        if len(probes) >= n_probe_max:
            break
    return probes


def probe_orders(pag, path_all: np.ndarray, path_d2_all: np.ndarray,
                 hops: np.ndarray, rho: float, n_probe_max: int
                 ) -> List[List[int]]:
    """APP replay for a whole batch (nonempty partitions only) — the
    probe list ``search_pag`` fetches AND the list the prefetch
    predictor forecasts (same code path: predictions are exact)."""
    return [
        [pid for pid in app_probe_order(path_all[qi], path_d2_all[qi],
                                        int(hops[qi]), pag.radius,
                                        rho, n_probe_max)
         if int(pag.pcount[pid]) > 0]
        for qi in range(len(hops))
    ]
