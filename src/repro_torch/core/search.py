"""Search on the PAG index (paper §V): graph traversal + Adaptive
Partition Probe early stop (§V-A) + asynchronous partition fetch (Alg 5).

Execution = real computation (exact recall); time = storage-simulator
event clock (see DESIGN.md §8). This module is the *orchestrator*: the
data plane itself is the staged pipeline in ``repro_torch.dataplane`` —

    plan   (``FetchPlan`` over a ``KeySpace``: probe orders -> keys)
    waves  (``WaveScheduler``: every storage wave, every clock)
    scan   (``ScanStage``: the masked l2_topk / pq_adc CUDA launches)

``search_pag`` builds the plans and sequences the stages; it performs
no storage GETs of its own.

Two data-plane engines (``SearchConfig.engine``):

* ``"batched"`` (default) — the batch-coalesced plane. The graph phase
  runs for the whole query batch, then partition probes are coalesced
  across queries: each distinct partition is fetched ONCE per batch
  (``WaveScheduler.run_coalesced`` — one concurrent RPC wave, hedging
  preserved), filled into the optional cache, and scanned for all
  probing queries in a single vectorized distance/top-k pass. Per-query
  latency accounting survives: each query's ``QueryTimeline`` carries
  its own traversal compute and its own probes, with a shared fetch's
  latency charged to every prober. Batch throughput
  (``SearchStats.batch_qps``) comes from the scheduler's batch-level
  event clock: fetches issue as their first prober's traversal retires,
  coalesced scans amortize the per-partition dispatch overhead.

* ``"per_query"`` — the seed data plane kept as reference/baseline
  (``WaveScheduler.run_per_query``): a python loop issuing blocking (or
  hedged) per-partition GETs per query. Same probes, same candidate
  pools, same scan arithmetic ⇒ bit-identical results to the batched
  engine (tested), only the simulated I/O schedule differs.

``SearchConfig`` knobs:

* ``mode`` — ``"async"`` replays Alg 5 (fetches overlap traversal
  compute; scans run as partitions arrive); ``"sync"`` is the blocking
  baseline (all fetches awaited after traversal, scans back-to-back).
  Affects only the simulated clock, never the returned neighbors.
* ``hedge_after_s`` — straggler mitigation: each GET is duplicated
  after this many seconds and the minimum latency wins (applies to both
  engines and to ``get_many``). ``None`` disables hedging.
* ``cache`` — optional ``PartitionCache``. Lookups happen before any
  storage GET; hits cost zero latency for every prober. In the batched
  engine the cache is consulted once per distinct partition and filled
  from the fetch wave; coalesced probers beyond the first are counted
  as hits (see ``PartitionCache.account_shared``) so hit-rate stays
  comparable with the per-query plane.
* ``replicas`` / ``resilience`` — the fault-tolerance plane. With
  ``replicas=R`` partitions are stored R-way (``write_partitions``)
  and a ``ResiliencePolicy`` (or a long-lived ``ResilientStore``)
  turns each partition fetch into a retry/backoff + timeout + replica
  failover + circuit-breaker chain whose full event-clock cost is
  charged to the query timeline. Per-query damage is reported in
  ``SearchStats.degraded``.
* ``max_inflight`` — bounds the concurrency of the batched engine's
  RPC wave (sub-waves on the event clock; queueing charged).
* ``compression`` — ``"pq"`` switches the probe wave to the v2
  compressed payloads: the wave fetches only the per-partition PQ code
  objects, one masked ADC kernel launch scores every query's pooled
  candidates (``ScanStage.adc_select``), and an exact refine wave
  fetches the full float residual objects only for the partitions
  holding each query's ADC-top ``rerank_k`` candidates. A
  ``PartitionCache`` then caches the *compressed* objects. A lost code
  object degrades exactly like a lost partition; corrupt payloads are
  never admitted to the cache.

Prefetch-ahead (cross-batch pipelining, see ``dataplane.prefetch``):
``prefetch_probes`` hands ``search_pag`` the predicted probe orders of
the NEXT micro-batch; the batched engine issues that wave's payload
objects at the event-clock point where this batch enters its
refine/scan stages and returns the in-flight wave as
``SearchStats.prefetch``. The next call consumes it via ``prefetched``
(key -> (object, residual latency)) and pays only the residual.

v2 payload format (``write_partitions(compression="pq")``), per
partition ``pid`` with ``S`` shards / ``R`` replicas:

* float residuals  ``prefix/{pid%S}/{pid}``            (+ ``/r{j}``)
* PQ codes         ``prefix/{pid%S}/{pid}/pq``         (+ ``/r{j}``)
* codebook         ``prefix/meta/pq_codebook``         (+ ``/r{j}``)

Code objects are colocated with their float siblings (one shard loss
kills both), carry put-time checksums, and replicate round-robin like
the float path. Ids are NOT stored in code objects — the in-memory
``pag.plist`` already maps partition rows to original ids. The float
object's id column bit-casts ``int32`` ids into the ``float32`` column
(``_pack_ids``/``_unpack_ids``) so billion-scale ids survive exactly
(a plain float cast is only exact below 2^24).

Devices: the graph phase, the ADC tables and the two scan kernels run on
``device`` (default: the CUDA card; ``device="cpu"`` runs the kernels'
plain versions). The storage simulator, the APP replay and the pooling
are host numpy, as in the reference. With a metrics registry or a
tracer installed, the host wall time of the graph phase, the pooling and
the kernel launches is recorded (``search.graph_wall_s``,
``search.pool_wall_s``, ``kernels.launch_s``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph_search import greedy_search
from repro_torch.core.pag import PAG
from repro_torch.dataplane.plan import (
    PAYLOAD_CODE,
    PAYLOAD_FLOAT,
    FetchPlan,
    KeySpace,
    probe_orders,
)
from repro_torch.dataplane.prefetch import PrefetchHandle
from repro_torch.dataplane.scan import (
    ID_SENTINEL,
    INF,
    ScanStage,
    dedup_first,
)
from repro_torch.dataplane.wave import WaveScheduler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.obs.metrics import COUNT_BUCKETS
from repro_torch.storage.resilience import FetchOutcome, codebook_keys, \
    replica_keys
from repro_torch.storage.simulator import (
    ComputeModel,
    ObjectStore,
    QueryTimeline,
)

__all__ = [
    "ID_SENTINEL", "INF", "DegradedInfo", "SearchConfig", "SearchStats",
    "search_pag", "write_partitions",
]


def _pack_ids(ids: np.ndarray) -> np.ndarray:
    """Bit-cast int32 ids into the float32 id column of a partition
    object. A plain value cast is only exact below 2^24 (float32 has a
    24-bit mantissa); the bit-cast is exact for the whole int32 range,
    so billion-scale ids survive storage round-trips."""
    return np.ascontiguousarray(ids, np.int32).view(np.float32)


def _unpack_ids(col: np.ndarray) -> np.ndarray:
    """Inverse of ``_pack_ids``: float32 id column -> int64 ids."""
    return np.ascontiguousarray(col, np.float32).view(np.int32) \
        .astype(np.int64)


def write_partitions(pag: PAG, x: np.ndarray, store: ObjectStore,
                     prefix: str = "part", n_shards: int = 1,
                     replicas: int = 1, compression: str = "none",
                     pq_m: int = 8, pq_seed: int = 0,
                     device: DeviceLike = None):
    """Materialize per-partition residual objects in the storage layer.

    Object = float32 [cnt, 1 + d]: column 0 carries the original id (a
    BIT-CAST int32, exact for all ids — see ``_pack_ids``), columns 1:
    the vector. Partitions are round-robined over ``n_shards`` logical
    shards (prefix/<shard>/<pid>) so failure injection can kill a shard
    (fault-tolerance tests). ``replicas=R`` writes R copies per
    partition: the primary under the legacy key and replica j under
    ``prefix/<(pid+j)%n_shards>/<pid>/r<j>`` — adjacent shards, so one
    shard loss never removes every copy (R <= shards).

    ``compression="pq"`` additionally writes the v2 compressed payloads:
    one per-index PQ codebook (trained here, stored under
    ``prefix/meta/pq_codebook``) and per-partition uint8 [cnt, M] code
    objects colocated with their float siblings
    (``prefix/<shard>/<pid>/pq``), replicated and checksummed exactly
    like the float path. Returns the trained ``PQCodebook`` (or None).

    PQ training and encoding run on ``device`` (default: the CUDA card).
    Encoding is row-wise, so the whole base is encoded once and each
    partition's code object is the slice of its rows (the reference
    encodes partition by partition; the codes are the same)."""
    if compression not in ("none", "pq"):
        raise ValueError(f"unknown compression: {compression!r}")
    cb = None
    if compression == "pq":
        from repro_torch.baselines.pq import encode_pq, train_pq
        device = resolve_device(device)
        x32 = np.asarray(x, np.float32)
        cb = train_pq(x32, M=pq_m, seed=pq_seed, device=device)
        codes_all = encode_pq(cb, x32, device=device)
        for key in codebook_keys(prefix, replicas):
            store.put(key, cb.centroids)
    for pid in range(pag.n_parts):
        cnt = int(pag.pcount[pid])
        ids = pag.plist[pid, :cnt]
        obj = np.zeros((cnt, x.shape[1] + 1), np.float32)
        obj[:, 0] = _pack_ids(ids)
        obj[:, 1:] = x[ids]
        for key in replica_keys(prefix, pid, n_shards, replicas):
            store.put(key, obj)
        if cb is not None:
            codes = codes_all[ids]
            for key in replica_keys(prefix, pid, n_shards, replicas,
                                    obj="pq"):
                store.put(key, codes)
    return cb


@dataclasses.dataclass
class SearchConfig:
    L: int = 32                 # traversal beam width
    k: int = 10                 # results
    rho: float = 1.25           # APP scale factor (paper's ρ)
    n_probe_max: int = 16       # cap on fetched partitions
    mode: str = "async"         # async | sync (Alg 5 vs blocking)
    engine: str = "batched"     # batched | per_query (data plane)
    hedge_after_s: Optional[float] = None  # straggler mitigation
    cache: Optional[object] = None  # PartitionCache (beyond-paper, §V-B)
    replicas: int = 1           # R-way partition replication
    # ResiliencePolicy (fresh breaker state per call) or a long-lived
    # ResilientStore wrapping the same store (serving tier: breakers
    # persist across batches). None = the bare skip/raise data plane.
    resilience: Optional[object] = None
    max_inflight: Optional[int] = None  # bound the batched RPC wave
    # Compressed data plane (v2 payloads). "pq": the probe wave fetches
    # only PQ code objects, a masked ADC kernel launch ranks each
    # query's pooled candidates, and the exact refine wave fetches the
    # float residuals of the partitions holding the ADC-top ``rerank_k``
    # candidates. ``pq_m`` is the write-side subspace count (the search
    # itself reads M from the stored codebook object).
    compression: str = "none"   # none | pq
    pq_m: int = 8
    rerank_k: int = 32          # ADC-top candidates refined exactly


@dataclasses.dataclass
class DegradedInfo:
    """Per-query damage report of the fault-tolerance plane."""
    n_probes_wanted: int = 0    # partitions APP asked for
    n_probes_lost: int = 0      # ... that no replica could serve
    retries: int = 0            # same-replica re-attempts (shared fetch
    failovers: int = 0          # chains charge every prober, like I/O)
    timeouts: int = 0
    corruptions: int = 0
    breaker_skips: int = 0
    breakers_open: int = 0      # open breakers after the fetch phase

    @property
    def degraded(self) -> bool:
        return self.n_probes_lost > 0

    def add_outcome(self, oc: "FetchOutcome"):
        self.retries += oc.retries
        self.failovers += oc.failovers
        self.timeouts += oc.timeouts
        self.corruptions += oc.corruptions
        self.breaker_skips += oc.breaker_skips

    @classmethod
    def merge(cls, infos: Iterable["DegradedInfo"]) -> "DegradedInfo":
        """Batch-level aggregation: sum the per-query damage counters
        (``breakers_open`` is a post-fetch snapshot shared by the whole
        batch, so it takes the max, not the sum). The one place the
        seven fields are summed — callers must not hand-roll this."""
        out = cls()
        for d in infos:
            out.n_probes_wanted += d.n_probes_wanted
            out.n_probes_lost += d.n_probes_lost
            out.retries += d.retries
            out.failovers += d.failovers
            out.timeouts += d.timeouts
            out.corruptions += d.corruptions
            out.breaker_skips += d.breaker_skips
            out.breakers_open = max(out.breakers_open, d.breakers_open)
        return out


@dataclasses.dataclass
class SearchStats:
    latencies_s: List[float]
    n_probes: List[int]
    n_hops: List[int]
    n_distinct_fetches: int = 0   # storage GETs after coalescing + cache
    batch_span_s: float = 0.0     # event-clock makespan of the batch
    degraded: List[DegradedInfo] = dataclasses.field(default_factory=list)
    # PartitionCache health after this batch (cumulative over the
    # cache's lifetime; None when the search ran cache-less)
    cache_hit_rate: Optional[float] = None
    cache_bytes_evicted: int = 0
    # prefetch-ahead pipelining (dataplane.prefetch): probes served from
    # the previous micro-batch's prefetch wave, and the wave this batch
    # issued for the NEXT one (None unless ``prefetch_probes`` was given)
    n_prefetch_hits: int = 0
    prefetch: Optional[PrefetchHandle] = None
    # tracer group of this batch's span tree ("" when not tracing) —
    # lets the frontend attach flow arrows to the per-query tracks
    trace_group: str = ""

    def n_degraded_queries(self) -> int:
        return sum(1 for d in self.degraded if d.degraded)

    def degraded_total(self) -> DegradedInfo:
        """The batch's merged damage report (``DegradedInfo.merge``)."""
        return DegradedInfo.merge(self.degraded)

    def total_retries(self) -> int:
        return self.degraded_total().retries

    def total_failovers(self) -> int:
        return self.degraded_total().failovers

    def qps(self) -> float:
        lat = np.asarray(self.latencies_s)
        return float(1.0 / np.maximum(lat.mean(), 1e-12))

    def batch_qps(self) -> float:
        """Throughput of the whole batch on the simulated event clock
        (per_query engine: serial stream, span = sum of latencies)."""
        return float(len(self.latencies_s)
                     / max(self.batch_span_s, 1e-12))

    def p999(self) -> float:
        return float(np.quantile(np.asarray(self.latencies_s), 0.999))

    def p99(self) -> float:
        return float(np.quantile(np.asarray(self.latencies_s), 0.99))


def search_pag(pag: PAG, x_dim: int, queries: np.ndarray,
               store: ObjectStore, cfg: SearchConfig,
               compute: Optional[ComputeModel] = None,
               prefix: str = "part", n_shards: int = 1,
               dead_shard_fallback: bool = True,
               prefetched: Optional[Dict[str, Tuple[np.ndarray, float]]]
               = None,
               prefetch_probes: Optional[List[List[int]]] = None,
               trace_t0_s: float = 0.0, device: DeviceLike = None
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
    """Returns (result ids [Q, k] original ids, sq-dists [Q, k], stats).

    ``prefetched`` / ``prefetch_probes`` / ``trace_t0_s`` serve the
    micro-batch pipeline (``serving.engine.AnnsFrontend``): objects the
    previous batch already fetched (key -> (object, residual latency)),
    the predicted probe orders of the next batch (the batched engine
    issues their wave mid-batch and returns it as ``stats.prefetch``),
    and the absolute event-clock offset of this batch's span tree
    (so frontend and batch tracks share one clock in the trace)."""
    device = resolve_device(device)
    compute = compute or ComputeModel()
    tracer = get_tracer()
    metrics = get_metrics()
    timed = tracer.enabled or metrics.enabled   # host wall clocks
    t_wall = time.perf_counter() if timed else 0.0
    pg = pag.pg
    A_dev, nbrs_dev, n_nodes, entry = pg.device_arrays(device)
    res = greedy_search(A_dev, nbrs_dev, n_nodes, entry,
                        torch.from_numpy(np.ascontiguousarray(
                            queries, np.float32)).to(device),
                        L=cfg.L, K=cfg.L)
    path_all = res.path.cpu().numpy()
    path_all_d2 = res.path_dists.cpu().numpy()
    hops = res.n_hops.cpu().numpy()
    beam_ids = res.ids.cpu().numpy()
    beam_d2 = res.dists.cpu().numpy()
    if timed:  # the copies back waited for the device
        metrics.observe("search.graph_wall_s", time.perf_counter() - t_wall)

    q_count = queries.shape[0]
    R_edges = pg.nbrs.shape[1]
    traversal_s = [compute.search_hop(int(hops[qi]) * R_edges, x_dim)
                   for qi in range(q_count)]
    # APP replay: probe order per query (nonempty partitions only)
    probes_all = probe_orders(pag, path_all, path_all_d2, hops,
                              cfg.rho, cfg.n_probe_max)

    if cfg.compression not in ("none", "pq"):
        raise ValueError(f"unknown compression: {cfg.compression!r}")
    pq = cfg.compression == "pq"
    keyspace = KeySpace(prefix, n_shards, cfg.replicas)

    rec = tracer.enabled   # keep the per-event schedule for the spans
    timelines = [QueryTimeline(record=rec) for _ in range(q_count)]
    degraded = [DegradedInfo(n_probes_wanted=len(probes_all[qi]))
                for qi in range(q_count)]
    for qi in range(q_count):
        timelines[qi].add_compute(traversal_s[qi])

    sched = WaveScheduler(store, cfg, timelines=timelines,
                          degraded=degraded, compute=compute,
                          dead_shard_fallback=dead_shard_fallback,
                          record=rec, prefetched=prefetched)
    scan = ScanStage(device)

    codebook, cb_lat = None, 0.0
    if pq:
        codebook, cb_lat, cb_oc = sched.load_codebook(keyspace,
                                                      cache=cfg.cache)
        if codebook is None:
            # the compressed plane is down for this batch: every probe
            # degrades like a lost partition (beam-only results)
            for qi in range(q_count):
                degraded[qi].n_probes_lost = len(probes_all[qi])
                if cb_oc is not None:
                    degraded[qi].add_outcome(cb_oc)
            probes_all = [[] for _ in range(q_count)]
        if cb_lat > 0:  # shared metadata fetch: charged to every query
            for qi in range(q_count):
                timelines[qi].issue_io(cb_lat, 0.0, label="codebook")

    # probe wave: code objects under "pq" compression, else residuals.
    # The ADC scan of a code object costs scan(cnt, M); exact scans
    # cost scan(cnt, d).
    probe_payload = PAYLOAD_CODE if pq else PAYLOAD_FLOAT
    probe_cost = (lambda o: compute.scan(o.shape[0], o.shape[1])) if pq \
        else (lambda o: compute.scan(o.shape[0], x_dim))
    exact_cost = lambda o: compute.scan(o.shape[0], x_dim)  # noqa: E731
    probe_kind = "adc" if pq else "scan"

    fobjs: Dict[int, np.ndarray] = {}
    refine_all: List[List[int]] = [[] for _ in range(q_count)]
    handle: Optional[PrefetchHandle] = None
    batch_span: Optional[float] = None

    if cfg.engine == "batched":
        plan = FetchPlan.build(probes_all, keyspace, probe_payload)
        wave = sched.run_coalesced(plan, cache=cfg.cache)
        sched.charge_queries(wave, probe_cost, kind=probe_kind)
        objs = wave.objs
        # batch event clock: a fetch issues when its FIRST prober's
        # traversal retires; one coalesced scan per distinct partition
        sched.charge_batch_codebook(cb_lat)
        sched.charge_batch_probe(wave, traversal_s, x_dim, pq,
                                 probe_kind)
        if pq:
            if codebook is not None and objs:
                refine_all = scan.adc_select(codebook, queries,
                                             probes_all, objs, pag,
                                             cfg.rerank_k)
            # stage boundary: the exact refine wave can only issue
            # after the ADC pass over the code objects has retired
            sched.barrier(cfg.mode)
            t_prefetch = sched.bt.compute_s  # refine stage starts here
            fplan = FetchPlan.build(refine_all, keyspace, PAYLOAD_FLOAT)
            fwave = sched.run_coalesced(fplan, cache=None)
            sched.charge_queries(fwave, exact_cost, kind="exact")
            sched.charge_batch_refine(fwave, x_dim)
            fobjs = fwave.objs
        else:
            t_prefetch = sched.bt.compute_s  # all traversals retired
        if prefetch_probes is not None:
            # overlap the NEXT micro-batch's probe wave with this
            # batch's refine/scan tail on the event clock
            handle = sched.prefetch(prefetch_probes, keyspace,
                                    probe_payload, cache=cfg.cache,
                                    t_issue_s=t_prefetch)
        batch_span = sched.finish_batch(cfg.mode)
    elif cfg.engine == "per_query":
        # seed data plane: blocking per-partition GETs, query by query
        plan = FetchPlan.build(probes_all, keyspace, probe_payload)
        objs, _ = sched.run_per_query(plan, cache=cfg.cache,
                                      scan_cost=probe_cost,
                                      kind=probe_kind)
        if pq:
            if codebook is not None and objs:
                refine_all = scan.adc_select(codebook, queries,
                                             probes_all, objs, pag,
                                             cfg.rerank_k)
            sched.barrier(cfg.mode)  # ADC retires before the refine wave
            fplan = FetchPlan.build(refine_all, keyspace, PAYLOAD_FLOAT)
            fobjs, _ = sched.run_per_query(fplan, cache=None,
                                           scan_cost=exact_cost,
                                           kind="exact")
        batch_span = None  # serial stream: filled from latencies below
    else:
        raise ValueError(f"unknown engine: {cfg.engine!r}")

    if sched.resilient is not None:
        n_open = sched.resilient.n_open_breakers()
        for d in degraded:
            d.breakers_open = n_open

    # candidate pools: aggregation points on the beam (they are dataset
    # points) + residuals of the available probed partitions, deduped by
    # original id (redundant copies, Def 5). Under "pq" the exact pool
    # draws from the refine wave's float objects.
    t_wall = time.perf_counter() if timed else 0.0
    pool_src = refine_all if pq else probes_all
    pool_objs = fobjs if pq else objs
    valid_beam = (beam_ids < pg.n_nodes) & (beam_d2 < INF)
    beam_safe = np.minimum(beam_ids, pg.m_cap - 1)
    pool_ids: List[np.ndarray] = []
    pool_vecs: List[np.ndarray] = []
    for qi in range(q_count):
        nodes = beam_safe[qi][valid_beam[qi]]
        ids_list = [pag.node_src[nodes].astype(np.int64)]
        vec_list = [pg.A[nodes].astype(np.float32)]
        for pid in pool_src[qi]:
            obj = pool_objs.get(pid)
            if obj is None:
                continue
            ids_list.append(_unpack_ids(obj[:, 0]))
            vec_list.append(obj[:, 1:])
        ids_cat = np.concatenate(ids_list)
        keep = dedup_first(ids_cat)
        pool_ids.append(ids_cat[keep])
        pool_vecs.append(np.concatenate(vec_list)[keep])
    if timed:
        metrics.observe("search.pool_wall_s", time.perf_counter() - t_wall)

    out_ids, out_d2 = scan.topk(queries.astype(np.float32), pool_ids,
                                pool_vecs, cfg.k)

    stats = SearchStats([], [], [],
                        n_distinct_fetches=sched.n_store,
                        degraded=degraded,
                        n_prefetch_hits=sched.n_prefetch_hits,
                        prefetch=handle)
    if cfg.cache is not None:
        stats.cache_hit_rate = cfg.cache.hit_rate
        stats.cache_bytes_evicted = cfg.cache.bytes_evicted
    for qi in range(q_count):
        tl = timelines[qi]
        lat_q = tl.finish_async() if cfg.mode == "async" \
            else tl.finish_sync()
        stats.latencies_s.append(lat_q)
        stats.n_probes.append(
            sum(1 for pid in probes_all[qi] if pid in objs))
        stats.n_hops.append(int(hops[qi]))
    stats.batch_span_s = batch_span if batch_span is not None \
        else float(np.sum(stats.latencies_s))
    if metrics.enabled:
        metrics.inc("search.batches")
        metrics.inc("search.queries", q_count)
        for qi in range(q_count):
            metrics.observe("search.latency_s", stats.latencies_s[qi])
            metrics.observe("search.pool_size", len(pool_ids[qi]),
                            bounds=COUNT_BUCKETS)
            metrics.observe("search.retries_per_query",
                            degraded[qi].retries, bounds=COUNT_BUCKETS)
        if stats.n_prefetch_hits:
            metrics.inc("search.prefetch_hits", stats.n_prefetch_hits)
        metrics.observe("search.batch_span_s", stats.batch_span_s)
    if rec:
        from repro_torch.obs.trace import emit_search_spans
        stats.trace_group = emit_search_spans(
            tracer,
            batch_events=(sched.bt.events
                          if cfg.engine == "batched" else None),
            batch_span_s=stats.batch_span_s, timelines=timelines,
            latencies_s=stats.latencies_s, engine=cfg.engine, pq=pq,
            n_probes=stats.n_probes, t0_s=trace_t0_s) or ""
    return out_ids, out_d2, stats
