"""Recovery policy over the simulated object store (the availability
half of the paper's claim: distributed storage gives the index service
cost-effective AND highly-available residuals).

Pieces:

* ``replica_keys`` — R-way replica placement for partition objects.
  Replica 0 keeps the legacy key ``prefix/{shard}/{pid}`` (replica-
  unaware readers keep working); replica j >= 1 lands on the *next*
  shards round-robin as ``prefix/{(pid + j) % n_shards}/{pid}/r{j}``,
  so one dead shard never takes out every copy of a partition (for
  R <= n_shards).

* ``ResiliencePolicy`` — retry with exponential backoff + deterministic
  jitter, per-request timeout, per-query deadline budget, and circuit-
  breaker tuning.

* ``CircuitBreaker`` — per-shard closed -> open -> half-open machine.
  The cooldown is counted in *requests routed past the shard* rather
  than wall time: the simulator's event clock is per-query, so a
  request-count cooldown keeps the breaker deterministic and engine-
  order independent while still modeling "stop hammering a dead shard,
  probe it occasionally".

* ``ResilientStore`` — wraps an ``ObjectStore`` and fetches one logical
  partition from its replica set: try a replica (skipping shards whose
  breaker is open), time out requests whose draw exceeds the per-request
  timeout, verify the payload checksum, retry the same replica with
  backoff for transient blips, fail over to the next replica for sticky
  damage, and give up when the per-query deadline budget is exhausted.
  Every outcome carries the event-clock time the whole chain consumed —
  retries, backoff waits, and failovers are charged honestly to the
  query timeline.

All jitter/fault randomness is derived from hashes of (seed, key,
attempt), never from call order, so the batched and per-query data
planes resolve the same faults to the same surviving payloads.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import get_metrics, get_tracer
from repro_torch.storage.simulator import ObjectStore


def replica_keys(prefix: str, pid: int, n_shards: int, replicas: int,
                 obj: str = "") -> List[str]:
    """Keys of the R copies of partition ``pid`` (primary first).

    ``obj`` selects the payload kind of the v2 partition format: ""
    is the float residual object (legacy key, replica-unaware readers
    keep working); "pq" is the uint8 PQ code object, colocated on the
    same shard as its float sibling (``prefix/{shard}/{pid}/pq`` and
    ``.../pq/r{j}``) so a shard loss kills both together."""
    suffix = f"/{obj}" if obj else ""
    keys = [f"{prefix}/{pid % n_shards}/{pid}{suffix}"]
    for j in range(1, replicas):
        keys.append(f"{prefix}/{(pid + j) % n_shards}/{pid}{suffix}/r{j}")
    return keys


def codebook_keys(prefix: str, replicas: int = 1) -> List[str]:
    """Keys of the R copies of the per-index PQ codebook object. The
    codebook is index metadata, not partition data, so it lives under
    the shard-less ``{prefix}/meta/`` namespace (a ``kill_prefix`` on a
    data shard never removes it; killing the whole prefix does)."""
    keys = [f"{prefix}/meta/pq_codebook"]
    for j in range(1, replicas):
        keys.append(f"{prefix}/meta/pq_codebook/r{j}")
    return keys


def shard_of(key: str) -> str:
    """Shard prefix of a partition key (``prefix/{shard}/...``)."""
    parts = key.split("/")
    return "/".join(parts[:2]) if len(parts) >= 2 else key


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    max_attempts_per_replica: int = 2   # 1 = failover-only, no retry
    max_total_attempts: int = 6         # across all replicas
    base_backoff_s: float = 1e-3        # exp backoff: base * mult^i
    backoff_multiplier: float = 2.0
    jitter_frac: float = 0.1            # +-uniform fraction of backoff
    request_timeout_s: float = 0.05     # cancel a single GET at this age
    deadline_s: float = 0.5             # per-query fetch budget
    breaker_fail_threshold: int = 3     # consecutive fails -> open
    breaker_cooldown_requests: int = 8  # opens skip this many requests
    verify_checksums: bool = True
    error_cost_s: Optional[float] = None  # None: store base latency
    seed: int = 0

    def backoff(self, key: str, attempt_no: int) -> float:
        """Backoff before (1-indexed) retry ``attempt_no``; deterministic
        jitter decorrelates replicas without breaking replayability."""
        b = self.base_backoff_s * self.backoff_multiplier ** (attempt_no - 1)
        h = hashlib.blake2b(f"{self.seed}:jit:{key}:{attempt_no}".encode(),
                            digest_size=8).digest()
        u = int.from_bytes(h, "little") / 2.0 ** 64
        return b * (1.0 + self.jitter_frac * (2.0 * u - 1.0))


class CircuitBreaker:
    """closed -> open (after N consecutive failures) -> half-open (after
    a request-count cooldown) -> closed on a successful probe."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, fail_threshold: int = 3,
                 cooldown_requests: int = 8):
        self.fail_threshold = fail_threshold
        self.cooldown_requests = cooldown_requests
        self.state = self.CLOSED
        self._fails = 0
        self._skips_left = 0
        self.n_trips = 0

    def _transition(self, state: str):
        if state != self.state:
            get_metrics().inc(f"breaker.to_{state}")
        self.state = state

    def allow(self) -> bool:
        """May a request be routed to this shard right now? While open,
        each call consumes one unit of cooldown; when the cooldown is
        spent the breaker half-opens and lets a probe through."""
        if self.state == self.OPEN:
            if self._skips_left > 0:
                self._skips_left -= 1
                return False
            self._transition(self.HALF_OPEN)
        return True

    def record_success(self):
        self._fails = 0
        self._transition(self.CLOSED)

    def record_failure(self):
        self._fails += 1
        if self.state == self.HALF_OPEN or \
                self._fails >= self.fail_threshold:
            self._transition(self.OPEN)
            self._skips_left = self.cooldown_requests
            self._fails = 0
            self.n_trips += 1


@dataclasses.dataclass
class FetchOutcome:
    """Result + accounting of one replicated fetch chain."""
    value: Optional[np.ndarray] = None
    elapsed_s: float = 0.0          # event-clock time the chain consumed
    ok: bool = False
    replica_used: int = -1
    retries: int = 0                # extra attempts on the same replica
    failovers: int = 0              # replica switches after an attempt
    timeouts: int = 0
    corruptions: int = 0
    breaker_skips: int = 0
    # tracing only (None unless a tracer is installed): the chain's
    # internal schedule as (name, t0, t1) relative to the chain start —
    # attempts, backoff waits, timeouts, failover boundaries
    events: Optional[List[Tuple[str, float, float]]] = None


class ResilientStore:
    """Replica-failover / retry / breaker wrapper around ObjectStore.

    Breaker state and aggregate counters persist for the lifetime of
    the wrapper — a serving tier should hold ONE instance across
    batches so breakers actually shield dead shards between queries.
    """

    def __init__(self, store: ObjectStore, policy: ResiliencePolicy):
        self.store = store
        self.policy = policy
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.n_retries = 0
        self.n_failovers = 0
        self.n_timeouts = 0
        self.n_corruptions = 0
        self.n_breaker_skips = 0
        self.n_deadline_giveups = 0

    # ----------------------------------------------------------- breakers
    def _breaker(self, shard: str) -> CircuitBreaker:
        br = self._breakers.get(shard)
        if br is None:
            br = CircuitBreaker(self.policy.breaker_fail_threshold,
                                self.policy.breaker_cooldown_requests)
            self._breakers[shard] = br
        return br

    def breaker_states(self) -> Dict[str, str]:
        return {s: b.state for s, b in self._breakers.items()}

    def n_open_breakers(self) -> int:
        return sum(1 for b in self._breakers.values()
                   if b.state == CircuitBreaker.OPEN)

    # ------------------------------------------------------------ fetches
    def _error_cost(self) -> float:
        if self.policy.error_cost_s is not None:
            return self.policy.error_cost_s
        return self.store.cfg.base_latency_s

    def get_replicated(self, rkeys: Sequence[str], now_s: float = 0.0,
                       hedge_after_s: Optional[float] = None
                       ) -> FetchOutcome:
        """Fetch one logical object from its replica set. Never raises:
        a chain that exhausts replicas/attempts/deadline returns
        ``ok=False`` with the time it burned."""
        p = self.policy
        m = get_metrics()
        oc = FetchOutcome()
        # chain sub-events for the span tracer, relative to chain start;
        # only allocated when a tracer is installed (zero-cost default)
        evs = [] if get_tracer().enabled else None
        oc.events = evs
        t = 0.0
        total = 0
        attempted_prev = False
        for r, key in enumerate(rkeys):
            if total >= p.max_total_attempts or t >= p.deadline_s:
                break
            br = self._breaker(shard_of(key))
            if not br.allow():
                oc.breaker_skips += 1
                self.n_breaker_skips += 1
                m.inc("resilience.breaker_skips")
                if evs is not None:
                    evs.append((f"breaker_skip r{r}", t, t))
                continue
            if attempted_prev:
                oc.failovers += 1
                self.n_failovers += 1
                m.inc("resilience.failovers")
                if evs is not None:
                    evs.append((f"failover r{r}", t, t))
            for a in range(p.max_attempts_per_replica):
                if total >= p.max_total_attempts:
                    break
                if total > 0:          # backoff before every re-attempt
                    b = p.backoff(key, total)
                    if evs is not None:
                        evs.append(("backoff", t, t + b))
                    t += b
                if t >= p.deadline_s:  # budget burned waiting
                    t = p.deadline_s
                    break
                if a > 0:
                    oc.retries += 1
                    self.n_retries += 1
                    m.inc("resilience.retries")
                total += 1
                attempted_prev = True
                t_try = t
                try:
                    if hedge_after_s is not None:
                        v, lat = self.store.get_hedged(
                            key, hedge_after_s, now_s=now_s + t, attempt=a)
                    else:
                        v, lat = self.store.get(key, now_s=now_s + t,
                                                attempt=a)
                except KeyError:
                    t += self._error_cost()
                    br.record_failure()
                    if evs is not None:
                        evs.append((f"error r{r}a{a}", t_try, t))
                    continue
                if lat > p.request_timeout_s:
                    t += p.request_timeout_s   # cancelled at the timeout
                    oc.timeouts += 1
                    self.n_timeouts += 1
                    m.inc("resilience.timeouts")
                    br.record_failure()
                    if evs is not None:
                        evs.append((f"timeout r{r}a{a}", t_try, t))
                    continue
                t += lat
                if p.verify_checksums and not self.store.verify(key, v):
                    oc.corruptions += 1
                    self.n_corruptions += 1
                    m.inc("resilience.corruptions")
                    br.record_failure()
                    if evs is not None:
                        evs.append((f"corrupt r{r}a{a}", t_try, t))
                    continue
                br.record_success()
                oc.value, oc.ok = v, True
                oc.replica_used = r
                oc.elapsed_s = t
                if evs is not None:
                    evs.append((f"get r{r}a{a}", t_try, t))
                return oc
        oc.elapsed_s = min(t, p.deadline_s)
        if t >= p.deadline_s:
            self.n_deadline_giveups += 1
            m.inc("resilience.deadline_giveups")
        m.inc("resilience.failed_chains")
        return oc

    def get_many_replicated(
            self, keyed: Dict[Hashable, Sequence[str]],
            hedge_after_s: Optional[float] = None,
            max_inflight: Optional[int] = None, now_s: float = 0.0
            ) -> Dict[Hashable, FetchOutcome]:
        """One concurrent wave of replicated fetch chains (the batched
        data plane's coalesced RPC wave, with recovery). Each logical
        object's whole chain occupies one concurrency slot; with
        ``max_inflight`` the wave slides on the event clock and
        ``elapsed_s`` includes queueing delay from the wave start."""
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1: {max_inflight}")
        out: Dict[Hashable, FetchOutcome] = {}
        inflight: List[float] = []
        for pid, rkeys in keyed.items():
            issue = 0.0
            if max_inflight is not None and len(inflight) >= max_inflight:
                issue = heapq.heappop(inflight)
            oc = self.get_replicated(rkeys, now_s=now_s + issue,
                                     hedge_after_s=hedge_after_s)
            oc.elapsed_s += issue
            if max_inflight is not None:
                heapq.heappush(inflight, oc.elapsed_s)
            out[pid] = oc
        self.store.n_batch_gets += 1
        return out
