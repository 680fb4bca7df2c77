"""Wave execution for the staged data plane.

``WaveScheduler`` owns ALL storage-wave execution of one search call:
the coalesced batched wave (``run_coalesced`` — one cache pass + one
concurrent ``get_many`` / replicated-chain wave over a ``FetchPlan``),
the seed per-query wave (``run_per_query`` — blocking per-partition
GETs), the codebook metadata fetch, per-query timeline charging +
``DegradedInfo`` accounting, the batch event clock (``bt``), cache
admission, and prefetch-ahead (serving a wave from the previous batch's
``PrefetchHandle`` and issuing the next batch's).

``core.search`` holds NO storage calls of its own anymore: the probe
wave, the PQ probe wave, the exact refine wave, and the per-query
reference plane are all ``WaveScheduler`` methods over ``FetchPlan``s.

Bit-identity contract: with no prefetch state, every code path below
performs the exact same store/cache calls in the exact same order as
the pre-refactor ``core.search`` internals (the store's latency RNG
advances per call, so call ORDER is part of the observable behavior —
the equivalence tests pin it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dataplane.plan import FetchPlan, KeySpace
from repro_torch.dataplane.prefetch import PrefetchHandle
from repro_torch.storage.resilience import (
    FetchOutcome,
    ResiliencePolicy,
    ResilientStore,
)
from repro_torch.storage.simulator import (
    ComputeModel,
    ObjectStore,
    QueryTimeline,
    TimelineEvent,
)

# where a wave's object came from (label + accounting semantics)
SRC_STORE = "store"        # fetched this wave     -> "{kind} p{pid}"
SRC_CACHE = "cache"        # PartitionCache hit    -> "hit p{pid}"
SRC_PREFETCH = "prefetch"  # previous batch's wave -> "pfhit p{pid}"


def resolve_resilient(store: ObjectStore, resilience) \
        -> Optional[ResilientStore]:
    """resilience: None | ResiliencePolicy (fresh wrapper per call) | a
    long-lived ResilientStore (must wrap the same store)."""
    if resilience is None:
        return None
    if isinstance(resilience, ResilientStore):
        if resilience.store is not store:
            raise ValueError("cfg.resilience wraps a different store")
        return resilience
    if isinstance(resilience, ResiliencePolicy):
        return ResilientStore(store, resilience)
    raise TypeError(f"cfg.resilience: {type(resilience)!r}")


@dataclasses.dataclass
class WaveResult:
    """One executed wave: payloads + accounting, keyed by partition."""
    plan: FetchPlan
    objs: Dict[int, np.ndarray]
    lat: Dict[int, float]               # charged latency per partition
    outcomes: Dict[int, FetchOutcome]   # store-served / lost pids only
    source: Dict[int, str]              # SRC_* per served pid
    n_store: int                        # GETs that reached the store


class WaveScheduler:
    """Executes fetch waves and owns every clock they charge."""

    def __init__(self, store: ObjectStore, cfg, *,
                 timelines: List[QueryTimeline],
                 degraded: List,
                 compute: ComputeModel,
                 dead_shard_fallback: bool = True,
                 record: bool = False,
                 prefetched: Optional[Dict[str, Tuple[np.ndarray, float]]]
                 = None):
        self.store = store
        self.cfg = cfg
        self.resilient = resolve_resilient(store, cfg.resilience)
        self.timelines = timelines
        self.degraded = degraded
        self.compute = compute
        self.dead_shard_fallback = dead_shard_fallback
        # batch event clock (the batched engine's makespan)
        self.bt = QueryTimeline(record=record)
        # key -> (verified object, residual latency) from the previous
        # micro-batch's prefetch wave (see dataplane.prefetch)
        self.prefetched = dict(prefetched) if prefetched else {}
        self.n_prefetch_hits = 0
        self.n_store = 0        # store fetches across ALL waves + codebook

    # ------------------------------------------------------ batched wave
    def run_coalesced(self, plan: FetchPlan, *, cache) -> WaveResult:
        """One coalesced wave over a plan's distinct partitions:
        prefetch-handle pass, cache pass, then one concurrent store wave
        (``get_many``, or replicated chains when resilience is on).
        ``cache`` may be None (the exact refine wave: only compressed
        objects are cached)."""
        cfg = self.cfg
        objs: Dict[int, np.ndarray] = {}
        lat: Dict[int, float] = {}
        outcomes: Dict[int, FetchOutcome] = {}
        source: Dict[int, str] = {}
        to_fetch: List[int] = []
        for pid in plan.order:
            key = plan.key(pid)
            pf = self.prefetched.get(key)
            if pf is not None:
                # already in flight / landed from the previous batch's
                # prefetch wave; pay only the residual latency
                objs[pid], lat[pid] = pf
                source[pid] = SRC_PREFETCH
                self.n_prefetch_hits += 1
                if cache is not None:  # verified at prefetch time
                    cache.put(key, pf[0])
                continue
            cached = cache.get(key) if cache is not None else None
            if cached is not None:
                objs[pid], lat[pid] = cached, 0.0  # local-memory hit
                source[pid] = SRC_CACHE
            else:
                to_fetch.append(pid)

        if self.resilient is not None:
            waves = self.resilient.get_many_replicated(
                {pid: plan.rkeys(pid) for pid in to_fetch},
                hedge_after_s=cfg.hedge_after_s,
                max_inflight=cfg.max_inflight)
            n_store = 0
            for pid in to_fetch:
                oc = waves[pid]
                outcomes[pid] = oc
                if oc.ok:
                    objs[pid], lat[pid] = oc.value, oc.elapsed_s
                    source[pid] = SRC_STORE
                    n_store += 1
                elif not self.dead_shard_fallback:
                    raise KeyError(f"partition lost: {plan.key(pid)}")
        else:
            fetched = self.store.get_many(
                [plan.key(pid) for pid in to_fetch],
                hedge_after_s=cfg.hedge_after_s,
                on_missing="skip" if self.dead_shard_fallback
                else "raise",
                max_inflight=cfg.max_inflight)
            for pid in to_fetch:
                got = fetched.get(plan.key(pid))
                if got is None:
                    outcomes[pid] = FetchOutcome()  # dead shard: skipped
                    continue
                objs[pid], lat[pid] = got
                source[pid] = SRC_STORE
                outcomes[pid] = FetchOutcome(
                    value=got[0], elapsed_s=got[1], ok=True,
                    replica_used=0)
            n_store = len(fetched)
        if cache is not None:
            # corrupted payloads must never be admitted to the cache:
            # the resilient chain already verified survivors; the bare
            # plane checks the put-time checksum here at admission
            cache.put_many({
                plan.key(pid): objs[pid] for pid in to_fetch
                if pid in objs and (self.resilient is not None
                                    or self.store.verify(plan.key(pid),
                                                         objs[pid]))})
            for pid in plan.order:
                if pid in objs:
                    cache.account_shared(plan.key(pid),
                                         len(plan.probers[pid]) - 1)
        self.n_store += n_store
        return WaveResult(plan, objs, lat, outcomes, source, n_store)

    # ------------------------------------------------ per-query charging
    @staticmethod
    def _label(wave: WaveResult, pid: int, kind: str) -> str:
        src = wave.source.get(pid, SRC_STORE)
        if src == SRC_CACHE:
            return f"hit p{pid}"
        if src == SRC_PREFETCH:
            return f"pfhit p{pid}"
        return f"{kind} p{pid}"

    def charge_queries(self, wave: WaveResult, scan_cost,
                       kind: str = "scan"):
        """Per-query accounting of one coalesced wave: every prober is
        charged the shared fetch chain's cost (latency incl.
        retries/failovers) and its own scan (``scan_cost(obj) -> s``);
        lost partitions are reported. ``kind`` labels the wave's spans
        on the trace."""
        plan = wave.plan
        for pid in plan.order:
            oc = wave.outcomes.get(pid)
            for qi in plan.probers[pid]:
                if oc is not None:
                    self.degraded[qi].add_outcome(oc)
                if pid not in wave.objs:
                    self.degraded[qi].n_probes_lost += 1
            if pid not in wave.objs:
                if oc is not None and oc.elapsed_s > 0:
                    for qi in plan.probers[pid]:  # chain burned budget
                        self.timelines[qi].issue_io(
                            oc.elapsed_s, 0.0, label=f"lost p{pid}",
                            detail=oc)
                continue
            label = self._label(wave, pid, kind)
            for qi in plan.probers[pid]:
                self.timelines[qi].issue_io(
                    wave.lat[pid], scan_cost(wave.objs[pid]),
                    label=label, detail=oc)

    # ------------------------------------------------- batch event clock
    def charge_batch_codebook(self, cb_lat: float):
        if cb_lat > 0:
            self.bt.issue_io(cb_lat, 0.0, label="codebook")

    def _charge_batch_pid(self, wave: WaveResult, pid: int, bcost,
                          kind: str):
        if pid in wave.objs:
            self.bt.issue_io(
                wave.lat[pid], bcost(wave.objs[pid]),
                label=self._label(wave, pid, kind),
                detail=wave.outcomes.get(pid))
        else:
            oc = wave.outcomes.get(pid)
            if oc is not None and oc.elapsed_s > 0:
                self.bt.issue_io(oc.elapsed_s, 0.0,  # burned budget
                                 label=f"lost p{pid}", detail=oc)

    def charge_batch_probe(self, wave: WaveResult,
                           traversal_s: List[float], x_dim: int,
                           pq: bool, kind: str):
        """Probe-wave schedule on the batch clock: a fetch issues when
        its FIRST prober's traversal retires; one coalesced scan per
        distinct partition amortizes dispatch across its probers."""
        plan = wave.plan
        first = {pid: plan.first_prober(pid) for pid in plan.order}
        for qi in range(plan.n_queries):
            self.bt.add_compute(traversal_s[qi],
                                label=f"traversal q{qi}")
            for pid in plan.probes_all[qi]:
                if first[pid] != qi:
                    continue
                n_probers = len(plan.probers[pid])
                self._charge_batch_pid(
                    wave, pid,
                    lambda o, n=n_probers: self.compute.scan_batched(
                        o.shape[0], o.shape[1] if pq else x_dim, n),
                    kind)

    def charge_batch_refine(self, wave: WaveResult, x_dim: int,
                            kind: str = "exact"):
        """Refine-wave schedule on the batch clock (post-barrier: all
        fetches issue together once the ADC stage retired)."""
        plan = wave.plan
        for pid in plan.order:
            n_probers = len(plan.probers[pid])
            self._charge_batch_pid(
                wave, pid,
                lambda o, n=n_probers: self.compute.scan_batched(
                    o.shape[0], x_dim, n),
                kind)

    def barrier(self, mode: str):
        """Stage boundary on every clock (ADC -> exact refine)."""
        for tl in self.timelines:
            tl.barrier(mode)
        self.bt.barrier(mode)

    def finish_batch(self, mode: str) -> float:
        """Resolve the batch clock; the batched engine's makespan."""
        return self.bt.finish_async() if mode == "async" \
            else self.bt.finish_sync()

    # ---------------------------------------------------- per-query wave
    def run_per_query(self, plan: FetchPlan, *, cache, scan_cost,
                      kind: str = "scan") -> Tuple[Dict[int, np.ndarray],
                                                   int]:
        """The seed data plane, one wave: blocking per-partition GETs,
        query by query (no cross-query coalescing — a partition probed
        by two queries is fetched twice unless a cache or the prefetch
        handle serves the second). Charges each query's timeline and
        fills per-query ``DegradedInfo``. Returns (objs, n_store)."""
        cfg = self.cfg
        objs: Dict[int, np.ndarray] = {}
        n_store = 0
        for qi, probes in enumerate(plan.probes_all):
            for pid in probes:
                key = plan.key(pid)
                oc = None
                pf = self.prefetched.get(key)
                cached = None if pf is not None else \
                    (cache.get(key) if cache is not None else None)
                if pf is not None:
                    obj, io_lat = pf   # residual latency only
                    label = f"pfhit p{pid}"
                    self.n_prefetch_hits += 1
                    if cache is not None:  # verified at prefetch time
                        cache.put(key, obj)
                elif cached is not None:
                    obj, io_lat = cached, 0.0  # local-memory hit
                    label = f"hit p{pid}"
                elif self.resilient is not None:
                    oc = self.resilient.get_replicated(
                        plan.rkeys(pid), hedge_after_s=cfg.hedge_after_s)
                    self.degraded[qi].add_outcome(oc)
                    if not oc.ok:
                        self.degraded[qi].n_probes_lost += 1
                        self.timelines[qi].issue_io(
                            oc.elapsed_s, 0.0, label=f"lost p{pid}",
                            detail=oc)
                        if self.dead_shard_fallback:
                            continue  # degraded: budget burned, no data
                        raise KeyError(f"partition lost: {key}")
                    obj, io_lat = oc.value, oc.elapsed_s
                    label = f"{kind} p{pid}"
                    n_store += 1
                    if cache is not None:
                        cache.put(key, obj)
                else:
                    try:
                        if cfg.hedge_after_s is not None:
                            obj, io_lat = self.store.get_hedged(
                                key, cfg.hedge_after_s)
                        else:
                            obj, io_lat = self.store.get(key)
                    except KeyError:
                        self.degraded[qi].n_probes_lost += 1
                        if self.dead_shard_fallback:
                            continue  # degraded: skip dead partition
                        raise
                    label = f"{kind} p{pid}"
                    n_store += 1
                    if cache is not None and self.store.verify(key, obj):
                        cache.put(key, obj)  # no corrupt admission
                objs[pid] = obj
                self.timelines[qi].issue_io(io_lat, scan_cost(obj),
                                            label=label, detail=oc)
        self.n_store += n_store
        return objs, n_store

    # ------------------------------------------------- metadata (pq)
    def load_codebook(self, keyspace: KeySpace, *, cache):
        """Fetch the per-index PQ codebook object — index metadata shared
        by every query, fetched once per search call in BOTH engines and
        admitted to the cache (steady-state serving pays for it once).
        Returns (PQCodebook | None, latency_s, outcome)."""
        from repro_torch.baselines.pq import PQCodebook
        cfg = self.cfg
        keys = keyspace.codebook_keys()
        oc: Optional[FetchOutcome] = None
        cached = cache.get(keys[0]) if cache is not None else None
        if cached is not None:
            arr, lat = cached, 0.0  # local-memory hit
        elif self.resilient is not None:
            oc = self.resilient.get_replicated(
                keys, hedge_after_s=cfg.hedge_after_s)
            if not oc.ok:
                if self.dead_shard_fallback:
                    return None, oc.elapsed_s, oc
                raise KeyError(f"pq codebook lost: {keys[0]}")
            arr, lat = oc.value, oc.elapsed_s
            self.n_store += 1
            if cache is not None:
                cache.put(keys[0], arr)
        else:
            try:
                if cfg.hedge_after_s is not None:
                    arr, lat = self.store.get_hedged(
                        keys[0], cfg.hedge_after_s)
                else:
                    arr, lat = self.store.get(keys[0])
            except KeyError:
                if self.dead_shard_fallback:
                    return None, 0.0, None
                raise
            self.n_store += 1
            if cache is not None and self.store.verify(keys[0], arr):
                cache.put(keys[0], arr)  # no corrupt admission
        arr = np.asarray(arr)
        m, _, d_sub = arr.shape
        return PQCodebook(arr, m, m * d_sub), lat, oc

    # --------------------------------------------------- prefetch-ahead
    def prefetch(self, probes_next: List[List[int]],
                 keyspace: KeySpace, payload: str, *,
                 cache, t_issue_s: float) -> PrefetchHandle:
        """Issue the NEXT micro-batch's probe wave at event-clock time
        ``t_issue_s`` of the CURRENT batch (post-barrier, so it overlaps
        this batch's refine/scan stages on the clock). The wave is real
        (store RNG draws, bytes counted) but charged to no query
        timeline here: the next batch pays the residual latency via
        ``PrefetchHandle.residuals``. Keys already resident in the cache
        are skipped (``PartitionCache.contains`` — stats-neutral);
        corrupt payloads are dropped (the next wave refetches through
        the resilient chain). When the batch clock is recording, each
        in-flight key is traced as an async "prefetch p*" slice."""
        plan = FetchPlan.build(probes_next, keyspace, payload)
        handle = PrefetchHandle(payload=payload, issued_rel_s=t_issue_s)
        pid_of: Dict[str, int] = {}
        keys: List[str] = []
        for pid in plan.order:
            key = plan.key(pid)
            if cache is not None and cache.contains(key):
                continue
            pid_of[key] = pid
            keys.append(key)
        if not keys:
            return handle
        handle.n_keys = len(keys)
        fetched = self.store.get_many(
            keys, hedge_after_s=self.cfg.hedge_after_s,
            on_missing="skip", max_inflight=self.cfg.max_inflight,
            now_s=t_issue_s)
        for key, (v, lat) in fetched.items():
            if not self.store.verify(key, v):
                continue  # corrupt: drop, the next wave refetches
            handle.objects[key] = v
            handle.ready_rel_s[key] = t_issue_s + lat
            handle.nbytes += v.nbytes
            if self.bt.record:  # trace-only: never stalls this batch
                self.bt.events.append(TimelineEvent(
                    "io", t_issue_s, t_issue_s + lat,
                    f"prefetch p{pid_of[key]}", self.bt.stage))
        return handle
