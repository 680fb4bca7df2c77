"""Serving tier: the ANN micro-batching front-end that feeds the batched
DSANN data plane. The reference's batched LM ``Engine`` (the other half
of the RAG-serving integration) is not ported yet.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.obs import get_metrics, get_tracer
from repro_torch.obs.metrics import COUNT_BUCKETS


class AnnsFrontend:
    """Micro-batching front-end for the ANN data plane.

    Individually-submitted queries are buffered and flushed as batched
    ``search_pag`` calls (one chunk per ``max_batch`` tickets), so
    concurrent requests share the coalesced partition fetches (the
    batched engine's cross-query dedup). ``submit`` returns a ticket;
    ``flush`` runs every buffered chunk and returns per-ticket
    ``(ids, d2, latency_s)``. An explicit ``max_batch`` caps request
    latency under heavy load: ``submit`` auto-flushes a full buffer
    into ``results`` (disable with ``auto_flush=False`` to build a
    multi-chunk pipeline first, e.g. for prefetch-ahead).

    Prefetch-ahead (``prefetch=True``; ROADMAP data-plane item): while
    chunk N runs, the data plane already issues chunk N+1's probe-wave
    objects (``dataplane.prefetch``). ``predictor`` maps the next
    chunk's queries to predicted probe orders; the default replays the
    in-memory graph phase (``predict_probes`` — exact predictions).
    Chunk N+1 then pays only each object's residual latency beyond the
    frontend clock, which is what drops the fetch-stall share of its
    batch span (benchmarks/prefetch.py measures it).

    Fault-tolerance plane: each flushed ticket also gets a per-query
    ``DegradedInfo`` in ``self.degraded`` (partitions lost, retries,
    failovers, breaker state) so a caller can tell a full answer from
    a degraded one and e.g. re-issue or annotate it.

    Tracing: flushes lay end-to-end on the ``frontend`` event-clock
    track; each batch's span tree is shifted to the same clock
    (``trace_t0_s``) and every ticket gets a flow arrow to the
    per-query track its query landed on."""

    def __init__(self, serving, cfg, max_batch: int = 64,
                 compute=None, prefetch: bool = False,
                 predictor=None, auto_flush: bool = True):
        self.serving = serving      # ShardedServing (or compatible)
        self.cfg = cfg              # SearchConfig
        self.max_batch = max_batch
        self.compute = compute
        self.prefetch = prefetch
        self.auto_flush = auto_flush
        if predictor is None and prefetch:
            from repro_torch.dataplane.prefetch import predict_probes
            predictor = lambda q: predict_probes(  # noqa: E731
                self.serving.pag, q, self.cfg, device=self.serving.device)
        self.predictor = predictor
        self.results: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        self.degraded: Dict[int, object] = {}   # ticket -> DegradedInfo
        self.queue_wait_s: Dict[int, float] = {}  # ticket -> wall wait
        self.n_prefetch_hits = 0    # probes served by prefetch waves
        self._pending: List[Tuple[int, np.ndarray, float]] = []
        self._next_ticket = 0
        self._clock_s = 0.0     # event-clock cursor: flushes lay end-to-end
        self._handle = None     # in-flight PrefetchHandle (absolute clock)

    def submit(self, query: np.ndarray) -> int:
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, np.asarray(query),
                              time.perf_counter()))
        if self.auto_flush and len(self._pending) >= self.max_batch:
            self.flush()
        return ticket

    def flush(self) -> Dict[int, Tuple[np.ndarray, np.ndarray, float]]:
        """Run the buffered queries as batched searches (one chunk per
        ``max_batch`` tickets). Returns (and accumulates into
        ``results``) ticket -> (ids, d2, latency_s)."""
        while self._pending:
            chunk = self._pending[:self.max_batch]
            self._pending = self._pending[self.max_batch:]
            self._flush_chunk(chunk)
        return self.results

    def _flush_chunk(self, chunk):
        tracer, metrics = get_tracer(), get_metrics()
        now = time.perf_counter()
        tickets = [t for t, _, _ in chunk]
        batch = np.stack([q for _, q, _ in chunk])
        waits = [now - t0 for _, _, t0 in chunk]
        t0 = self._clock_s
        kw = {}
        if self._handle is not None:
            # the previous chunk prefetched this chunk's probe wave;
            # pay only each object's residual latency past our start
            kw["prefetched"] = self._handle.residuals(t0)
            self._handle = None
        if self.prefetch and self.predictor is not None and self._pending:
            nxt = np.stack([q for _, q, _ in
                            self._pending[:self.max_batch]])
            kw["prefetch_probes"] = self.predictor(nxt)
        if tracer.enabled:
            # batch spans share the frontend clock (flow arrows point
            # forward in time)
            kw["trace_t0_s"] = t0
        ids, d2, stats = self.serving.search(batch, self.cfg,
                                             compute=self.compute, **kw)
        if stats.prefetch is not None:
            # handle times are relative to this chunk's start; pin them
            # to the frontend clock for the next chunk's residuals
            for key in stats.prefetch.ready_rel_s:
                stats.prefetch.ready_rel_s[key] += t0
            stats.prefetch.issued_rel_s += t0
            self._handle = stats.prefetch
        self.n_prefetch_hits += stats.n_prefetch_hits
        for row, ticket in enumerate(tickets):
            self.results[ticket] = (ids[row], d2[row],
                                    stats.latencies_s[row])
            self.queue_wait_s[ticket] = waits[row]
            if stats.degraded:
                self.degraded[ticket] = stats.degraded[row]
        self.last_stats = stats
        if metrics.enabled:
            metrics.inc("frontend.flushes")
            metrics.observe("frontend.batch_size", len(tickets),
                            bounds=COUNT_BUCKETS)
            for w in waits:
                metrics.observe("frontend.queue_wait_s", w)
        if tracer.enabled:
            # flushes lay end-to-end on the frontend's event clock;
            # ticket slices stack (aspan) since they start together
            tracer.span("frontend", f"flush[{len(tickets)}q]", t0,
                        stats.batch_span_s, cat="flush",
                        args={"tickets": len(tickets)})
            for row, ticket in enumerate(tickets):
                tracer.aspan("frontend", f"t{ticket}", t0,
                             stats.latencies_s[row], cat="ticket",
                             args={"queue_wait_s": waits[row]})
                if stats.trace_group:
                    # ticket -> its per-query child track
                    tracer.flow("frontend", t0,
                                f"{stats.trace_group}/q{row}", t0,
                                name=f"t{ticket}")
        self._clock_s += stats.batch_span_s

    @property
    def clock_s(self) -> float:
        """Event-clock time of every flushed batch laid end to end: the
        stream's simulated makespan (tickets / clock_s = stream QPS)."""
        return self._clock_s

    def degraded_summary(self):
        """Batch-level ``DegradedInfo`` aggregated over every flushed
        ticket (see ``DegradedInfo.merge``); None when the search plane
        reported no per-query damage records."""
        if not self.degraded:
            return None
        from repro_torch.core.search import DegradedInfo
        return DegradedInfo.merge(self.degraded.values())
