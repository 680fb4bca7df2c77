"""Distributed-storage simulation layer.

The container is CPU-only, so storage *timing* is simulated while all
*data* operations are real (fetched bytes are the actual residual vectors;
recall is exact). Latency model per GET:

    latency = base + size/bandwidth + LogNormal(mu, sigma)

with parameters for the paper's Table I tiers:
    mem   0                             (in-memory baseline)
    ssd   ~100 us                       (local SSD)
    dfs   0.1–10 ms heavy-tailed        (Pangu-like DFS)

Also provides: failure injection (dead shards -> KeyError, the router
degrades gracefully), a pluggable ``FaultPlan`` (transient errors,
timeout spikes, slow shards, flapping windows, payload corruption with
per-object checksums computed at ``put`` time), hedged requests
(straggler mitigation: duplicate issue at the p95 timeout, take the min
— the classic tail-taming trick), bounded fetch concurrency
(``get_many(max_inflight=...)`` models a sliding-window RPC wave), and
an event-clock used by the async search to overlap compute with I/O.

Fault determinism: every injected fault is a pure function of
``(plan.seed, key, attempt)`` — NOT of call order — so the batched and
per-query data planes observe identical fault outcomes for the same
keys (tests assert identical search results under the same plan).
``sticky=True`` drops the attempt index from the hash: the fault then
models a damaged replica object (only failover to another replica
helps), not a network blip (which a same-replica retry fixes).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.obs import get_metrics
from repro_torch.obs.metrics import BYTE_BUCKETS, COUNT_BUCKETS


class TransientError(KeyError):
    """A retryable storage error (network blip, flapping shard). Subclass
    of KeyError so fault-unaware callers degrade exactly like the
    dead-shard path: skip the partition (the baseline the resilience
    layer is measured against)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault injection for ``ObjectStore``.

    * ``transient_p`` — probability a GET raises ``TransientError``.
    * ``sticky`` — hash faults per key instead of per (key, attempt):
      transient/corruption faults persist across retries of the same
      replica object and only replica failover recovers.
    * ``timeout_p`` / ``timeout_spike_s`` — probability a GET's latency
      gains a spike far beyond any sane per-request deadline (the
      resilient layer cancels at its timeout; a plain caller eats it).
    * ``slow_prefixes`` — latency multiplier per key prefix (brown-out /
      degraded shard).
    * ``flap_windows`` — prefix -> (t_start, t_end): GETs issued with
      ``now_s`` inside the window raise ``TransientError``; the shard
      recovers by itself afterwards (retry-after-backoff territory).
    * ``corrupt_p`` — probability the returned payload is corrupted
      (stored object untouched); detectable via ``ObjectStore.verify``
      against the checksum recorded at ``put`` time.
    """
    transient_p: float = 0.0
    sticky: bool = False
    timeout_p: float = 0.0
    timeout_spike_s: float = 1.0
    corrupt_p: float = 0.0
    slow_prefixes: Mapping[str, float] = \
        dataclasses.field(default_factory=dict)
    flap_windows: Mapping[str, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)
    seed: int = 0

    def _u(self, key: str, attempt: int, salt: str) -> float:
        """Deterministic uniform in [0, 1) from (seed, key[, attempt]).
        blake2b, not crc32: CRC is linear, so single-character changes
        (e.g. the attempt index) XOR a constant into the hash and
        correlate decisions across attempts."""
        a = -1 if self.sticky else attempt
        h = hashlib.blake2b(f"{self.seed}:{salt}:{key}:{a}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "little") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    kind: str = "dfs"            # mem | ssd | dfs
    base_latency_s: float = 0.0
    bandwidth_Bps: float = 0.0
    jitter_mu: float = 0.0       # of the lognormal additive term
    jitter_sigma: float = 0.0
    seed: int = 0

    @staticmethod
    def preset(kind: str, seed: int = 0) -> "StorageConfig":
        if kind == "mem":
            return StorageConfig("mem", 0.0, float("inf"), 0.0, 0.0, seed)
        if kind == "ssd":
            return StorageConfig("ssd", 80e-6, 2e9, np.log(20e-6), 0.6,
                                 seed)
        if kind == "dfs":
            # Pangu-like: 0.1-10 ms (paper Table I); heavy lognormal tail
            return StorageConfig("dfs", 300e-6, 1e9, np.log(700e-6), 1.0,
                                 seed)
        raise ValueError(kind)


class ObjectStore:
    """Key -> numpy array object store with simulated latencies."""

    def __init__(self, cfg: StorageConfig,
                 fault_plan: Optional[FaultPlan] = None):
        self.cfg = cfg
        self.fault_plan = fault_plan
        self._data: Dict[str, np.ndarray] = {}
        self._crc: Dict[str, int] = {}
        self._rng = np.random.default_rng(cfg.seed)
        self._dead_prefixes: List[str] = []
        self.n_gets = 0
        self.n_batch_gets = 0
        self.bytes_fetched = 0

    # ------------------------------------------------------------- admin
    def put(self, key: str, value: np.ndarray):
        v = np.ascontiguousarray(value)
        self._data[key] = v
        self._crc[key] = zlib.crc32(v.tobytes())

    def set_fault_plan(self, plan: Optional[FaultPlan]):
        self.fault_plan = plan

    def verify(self, key: str, value: np.ndarray) -> bool:
        """Check ``value`` against the checksum recorded at put time.
        Unknown keys verify trivially (no checksum on record)."""
        crc = self._crc.get(key)
        if crc is None:
            return True
        return zlib.crc32(np.ascontiguousarray(value).tobytes()) == crc

    def keys(self):
        return self._data.keys()

    def kill_prefix(self, prefix: str):
        """Failure injection: all keys under prefix become unavailable."""
        self._dead_prefixes.append(prefix)

    def revive_all(self):
        self._dead_prefixes = []

    def total_bytes(self) -> int:
        return sum(v.nbytes for v in self._data.values())

    # ------------------------------------------------------------ access
    def _latency(self, nbytes: int) -> float:
        c = self.cfg
        lat = c.base_latency_s
        if np.isfinite(c.bandwidth_Bps) and c.bandwidth_Bps > 0:
            lat += nbytes / c.bandwidth_Bps
        if c.jitter_sigma > 0:
            lat += self._rng.lognormal(c.jitter_mu, c.jitter_sigma)
        return lat

    def _corrupted(self, key: str, v: np.ndarray) -> np.ndarray:
        """Deterministic payload corruption: one element of a COPY is
        blown up; the stored object (and its checksum) are untouched."""
        bad = np.array(v, copy=True)
        if bad.size:
            h = zlib.crc32(f"{self.fault_plan.seed}:flip:{key}".encode())
            flat = bad.reshape(-1)
            if np.issubdtype(bad.dtype, np.integer):
                # integer payloads (PQ code objects): XOR a nonzero
                # pattern — always changes the element, never overflows
                flat[h % bad.size] ^= np.asarray(0xA5, bad.dtype)
            else:
                # finite garbage: wrong enough to poison ids/distances,
                # still castable (no overflow warnings downstream)
                flat[h % bad.size] = np.float32(2 ** 30)
        return bad

    def get(self, key: str, now_s: float = 0.0, attempt: int = 0
            ) -> Tuple[np.ndarray, float]:
        """Returns (value, simulated_latency_seconds).

        ``now_s`` is the caller's event-clock time (flap windows are
        evaluated against it); ``attempt`` is the caller's retry index
        for this key (advances the deterministic fault stream unless the
        plan is sticky)."""
        for p in self._dead_prefixes:
            if key.startswith(p):
                get_metrics().inc("storage.dead_shard_errors")
                raise KeyError(f"shard down: {key}")
        plan = self.fault_plan
        if plan is not None:
            for pref, (t0, t1) in plan.flap_windows.items():
                if key.startswith(pref) and t0 <= now_s < t1:
                    get_metrics().inc("storage.transient_errors")
                    raise TransientError(f"shard flapping: {key}")
            if plan.transient_p > 0 and \
                    plan._u(key, attempt, "err") < plan.transient_p:
                get_metrics().inc("storage.transient_errors")
                raise TransientError(f"transient error: {key}")
        v = self._data[key]
        self.n_gets += 1
        self.bytes_fetched += v.nbytes
        lat = self._latency(v.nbytes)
        if plan is not None:
            for pref, mult in plan.slow_prefixes.items():
                if key.startswith(pref):
                    lat *= mult
            if plan.timeout_p > 0 and \
                    plan._u(key, attempt, "tmo") < plan.timeout_p:
                lat += plan.timeout_spike_s
            if plan.corrupt_p > 0 and \
                    plan._u(key, attempt, "crp") < plan.corrupt_p:
                v = self._corrupted(key, v)
        m = get_metrics()
        m.inc("storage.gets")
        m.inc("storage.bytes_fetched", v.nbytes)
        m.observe("storage.rpc_latency_s", lat)
        m.observe("storage.object_bytes", v.nbytes, BYTE_BUCKETS)
        return v, lat

    def get_hedged(self, key: str, hedge_after_s: float,
                   now_s: float = 0.0, attempt: int = 0) -> Tuple[
            np.ndarray, float]:
        """Straggler mitigation: duplicate request after hedge_after_s.
        The duplicate is a real second RPC and is counted in
        ``n_gets``/``bytes_fetched`` (it consumes backend capacity even
        when the first copy wins); only its latency is redrawn."""
        v, lat1 = self.get(key, now_s=now_s, attempt=attempt)
        if lat1 <= hedge_after_s:
            return v, lat1
        self.n_gets += 1
        self.bytes_fetched += v.nbytes
        m = get_metrics()
        m.inc("storage.gets")
        m.inc("storage.hedged_duplicates")
        m.inc("storage.bytes_fetched", v.nbytes)
        lat2 = hedge_after_s + self._latency(v.nbytes)
        return v, min(lat1, lat2)

    def get_many(self, keys: Iterable[str],
                 hedge_after_s: Optional[float] = None,
                 on_missing: str = "raise",
                 max_inflight: Optional[int] = None,
                 now_s: float = 0.0
                 ) -> Dict[str, Tuple[np.ndarray, float]]:
        """Coalesced batch fetch: one RPC wave, every key issued
        concurrently (latencies drawn independently per key; hedging
        applied per key as in get_hedged). Duplicate keys are fetched
        once. ``on_missing``: "raise" propagates the KeyError of a dead
        or absent key, "skip" omits it from the result (the degraded
        dead-shard path).

        ``max_inflight`` bounds the concurrency of the wave: at most
        that many RPCs are outstanding; further keys issue as slots
        free (sliding window on the event clock). Returned latencies
        are then *effective* — queueing delay included — measured from
        the wave start. ``None`` keeps the unlimited wave."""
        if on_missing not in ("raise", "skip"):
            raise ValueError(on_missing)
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1: {max_inflight}")
        out: Dict[str, Tuple[np.ndarray, float]] = {}
        inflight: List[float] = []   # completion-time heap
        for key in keys:
            if key in out:
                continue
            issue = 0.0
            if max_inflight is not None and len(inflight) >= max_inflight:
                issue = heapq.heappop(inflight)
            try:
                if hedge_after_s is not None:
                    v, lat = self.get_hedged(key, hedge_after_s,
                                             now_s=now_s + issue)
                else:
                    v, lat = self.get(key, now_s=now_s + issue)
            except KeyError:
                if max_inflight is not None:  # error still held a slot
                    heapq.heappush(inflight,
                                   issue + self.cfg.base_latency_s)
                if on_missing == "raise":
                    raise
                continue
            if max_inflight is not None:
                heapq.heappush(inflight, issue + lat)
            out[key] = (v, issue + lat)
        self.n_batch_gets += 1
        m = get_metrics()
        m.inc("storage.batch_gets")
        m.observe("storage.wave_keys", len(out), COUNT_BUCKETS)
        return out


@dataclasses.dataclass
class ComputeModel:
    """Per-query compute-time model for the simulated QPS numbers.

    seconds = flops * sec_per_flop (+ per-hop / per-partition overheads).
    Calibrated against single-thread CPU throughput so in-memory simulated
    QPS matches measured QPS within a small factor (see benchmarks).
    """
    sec_per_flop: float = 2.5e-10     # ~4 Gflop/s effective single thread
    hop_overhead_s: float = 2e-6
    partition_overhead_s: float = 1e-6

    def search_hop(self, n_dists: int, d: int) -> float:
        return 3 * n_dists * d * self.sec_per_flop + self.hop_overhead_s

    def scan(self, n_points: int, d: int) -> float:
        return 3 * n_points * d * self.sec_per_flop \
            + self.partition_overhead_s

    def scan_batched(self, n_points: int, d: int, n_queries: int) -> float:
        """One coalesced partition scan serving n_queries probers: the
        distance flops scale with the probers, the per-partition dispatch
        overhead is paid once (the batched-engine amortization)."""
        return 3 * n_points * d * n_queries * self.sec_per_flop \
            + self.partition_overhead_s


@dataclasses.dataclass
class FetchRecord:
    issue_s: float      # compute-cursor time the GET was issued (async)
    latency_s: float    # simulated storage latency
    scan_cost_s: float  # full-scan compute once the partition arrives
    label: str = ""     # tracing label ("adc p12", "hit p3", "codebook")
    detail: object = None   # tracing payload (e.g. a FetchOutcome)


@dataclasses.dataclass
class TimelineEvent:
    """One resolved interval of a query's schedule (tracing only).
    ``kind``: "compute" (traversal on the compute thread), "io" (a fetch
    in flight — overlaps compute in async mode), "stall" (compute thread
    waiting on an arrival), "scan" (partition scan on the compute
    thread). compute/stall/scan tile the timeline exactly; io floats."""
    kind: str
    t0_s: float
    t1_s: float
    label: str = ""
    stage: int = 0      # barrier-delimited stage (0 = probe, 1 = refine)
    detail: object = None

    @property
    def dur_s(self) -> float:
        return self.t1_s - self.t0_s


@dataclasses.dataclass
class QueryTimeline:
    """Event-clock for one query: a single compute thread (traversal then
    scans) overlapped with asynchronous storage fetches (Alg 5).

    ``record=True`` additionally keeps the *resolved schedule* as
    ``TimelineEvent``s (``events``) for the span tracer: compute is
    recorded eagerly; io/stall/scan intervals are derived by the same
    resolution loop that computes ``finish_async``/``finish_sync`` —
    one algorithm, so traced totals are bit-identical to untraced ones.
    """
    compute_s: float = 0.0          # traversal compute consumed so far
    fetches: List[FetchRecord] = dataclasses.field(default_factory=list)
    record: bool = False
    events: List[TimelineEvent] = \
        dataclasses.field(default_factory=list)
    stage: int = 0                  # incremented at every barrier
    _finished: bool = False         # events already flushed by finish_*

    def add_compute(self, dt: float, label: str = "traversal"):
        if self.record and dt > 0:
            self.events.append(TimelineEvent(
                "compute", self.compute_s, self.compute_s + dt, label,
                self.stage))
        self.compute_s += dt

    def issue_io(self, latency: float, scan_cost: float,
                 label: str = "", detail: object = None):
        self.fetches.append(FetchRecord(self.compute_s, latency,
                                        scan_cost, label, detail))

    def _resolve(self, mode: str,
                 events: Optional[List[TimelineEvent]] = None) -> float:
        """Resolve the outstanding fetches into a schedule; returns the
        finish time and (optionally) appends the io/stall/scan events.
        This is THE event-clock algorithm — finish_async/finish_sync and
        the tracer all go through it."""
        if mode == "sync":
            # blocking: all fetches issued after traversal, awaited
            # together; scans back-to-back afterwards
            if not self.fetches:
                return self.compute_s
            start = self.compute_s + max(f.latency_s
                                         for f in self.fetches)
            if events is not None:
                for f in self.fetches:
                    events.append(TimelineEvent(
                        "io", self.compute_s,
                        self.compute_s + f.latency_s, f.label,
                        self.stage, f.detail))
                if start > self.compute_s:
                    events.append(TimelineEvent(
                        "stall", self.compute_s, start, "stall",
                        self.stage))
            if events is not None:
                t = start
                for f in self.fetches:
                    if f.scan_cost_s > 0:
                        events.append(TimelineEvent(
                            "scan", t, t + f.scan_cost_s, f.label,
                            self.stage))
                    t += f.scan_cost_s
            # seed fold order (start + sum(costs)): keep bit-identical
            return start + sum(f.scan_cost_s for f in self.fetches)
        # async (Alg 5): fetch issued mid-traversal at its issue time;
        # scans run on the compute thread as data arrives. Sort key
        # matches the seed implementation — (ready, cost) — so resolved
        # totals are bit-identical in latency-tie cases (cache hits).
        t = self.compute_s
        for f in sorted(self.fetches,
                        key=lambda f: (f.issue_s + f.latency_s,
                                       f.scan_cost_s)):
            ready = f.issue_s + f.latency_s
            if events is not None:
                events.append(TimelineEvent("io", f.issue_s, ready,
                                            f.label, self.stage,
                                            f.detail))
                if ready > t:
                    events.append(TimelineEvent("stall", t, ready,
                                                "stall", self.stage))
            start = max(t, ready)
            if events is not None and f.scan_cost_s > 0:
                events.append(TimelineEvent(
                    "scan", start, start + f.scan_cost_s, f.label,
                    self.stage))
            t = start + f.scan_cost_s
        return t

    def finish_async(self) -> float:
        """Alg 5 finish time; flushes events once when recording."""
        return self._finish("async")

    def finish_sync(self) -> float:
        return self._finish("sync")

    def _finish(self, mode: str) -> float:
        evs = self.events if (self.record and not self._finished) \
            else None
        t = self._resolve(mode, evs)
        if evs is not None:
            self._finished = True
        return t

    def barrier(self, mode: str = "async"):
        """Stage boundary (the two-stage compressed data plane): collapse
        every outstanding fetch into the compute cursor, so later IO can
        only issue after all current-stage scans retired — e.g. the exact
        refine wave issues only once the ADC pass over the fetched code
        objects has completed."""
        self.compute_s = self._resolve(
            mode, self.events if self.record else None)
        self.fetches = []
        self.stage += 1
