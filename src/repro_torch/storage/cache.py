"""Partition cache for the serving tier (beyond-paper extension).

The paper (§V-B) leaves caching as future work, noting that DSANN's
partition access pattern is hard to predict so "the effectiveness of
caching is significantly constrained". This LRU byte-bounded cache lets us
QUANTIFY that remark: benchmarks/cache_effect.py measures hit rate and QPS
across workload skews — confirming the paper's intuition for uniform
workloads and showing where skewed (production-like) workloads break it.

``admission="doorkeeper"`` adds a TinyLFU-style frequency gate: a small
count-min sketch records access frequency, and a non-resident key is
admitted only once it has been seen at least twice. A long one-hit-wonder
scan (the batched plane's worst reuse-distance case) then cannot evict
the hot working set — its keys bounce off the doorkeeper while residents
keep their LRU position.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Optional

import numpy as np

from repro_torch.obs import get_metrics


class _CountMinSketch:
    """Small conservative frequency sketch (deterministic blake2b rows).
    Counters halve once the stream reaches ``8 * width`` additions so
    stale popularity ages out (the TinyLFU reset trick)."""

    def __init__(self, width: int = 1024, depth: int = 4):
        self.width = width
        self.depth = depth
        self._t = np.zeros((depth, width), np.uint32)
        self._adds = 0

    def _cols(self, key: str) -> np.ndarray:
        h = hashlib.blake2b(key.encode(), digest_size=4 * self.depth) \
            .digest()
        return np.frombuffer(h, np.uint32) % self.width

    def add(self, key: str):
        self._t[np.arange(self.depth), self._cols(key)] += 1
        self._adds += 1
        if self._adds >= 8 * self.width:   # age out stale popularity
            self._t >>= 1
            self._adds //= 2

    def estimate(self, key: str) -> int:
        return int(self._t[np.arange(self.depth), self._cols(key)].min())


class PartitionCache:
    def __init__(self, capacity_bytes: int, admission: str = "always"):
        if admission not in ("always", "doorkeeper"):
            raise ValueError(f"unknown admission policy: {admission!r}")
        self.capacity = capacity_bytes
        self.admission = admission
        self._sketch = _CountMinSketch() if admission == "doorkeeper" \
            else None
        self._data: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.bytes_evicted = 0      # cumulative LRU eviction volume
        self.n_evictions = 0
        self.n_admission_rejects = 0   # doorkeeper bounces

    def get(self, key: str) -> Optional[np.ndarray]:
        m = get_metrics()
        if self._sketch is not None:
            self._sketch.add(key)   # every lookup is a popularity vote
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            m.inc("cache.hits")
            m.set_gauge("cache.hit_rate", self.hit_rate)
            return self._data[key]
        self.misses += 1
        m.inc("cache.misses")
        m.set_gauge("cache.hit_rate", self.hit_rate)
        return None

    def contains(self, key: str) -> bool:
        """Stats-neutral residency probe: no hit/miss counting, no LRU
        touch, no sketch vote. The prefetch pipeline uses this to skip
        keys already resident without distorting hit-rate numbers."""
        return key in self._data

    def put(self, key: str, value: np.ndarray):
        if value.nbytes > self.capacity:
            return
        if key in self._data:
            self._data.move_to_end(key)
            return
        if self._sketch is not None and self._sketch.estimate(key) < 2:
            # doorkeeper: a key never seen before this fetch is a
            # one-hit wonder until proven otherwise — don't let it
            # evict proven-warm residents
            self.n_admission_rejects += 1
            get_metrics().inc("cache.admission_rejects")
            return
        self._data[key] = value
        self._bytes += value.nbytes
        while self._bytes > self.capacity and self._data:
            _, evicted = self._data.popitem(last=False)
            self._bytes -= evicted.nbytes
            self.bytes_evicted += evicted.nbytes
            self.n_evictions += 1
            get_metrics().inc("cache.evictions")
        get_metrics().set_gauge("cache.bytes", self._bytes)

    def put_many(self, items: "dict[str, np.ndarray]"):
        """Fill the cache from one coalesced fetch wave."""
        for key, value in items.items():
            self.put(key, value)

    def account_shared(self, key: str, n_extra: int):
        """Accounting hook for the batched data plane: ``n_extra`` probers
        beyond the first were served by a single resident / in-flight copy
        of ``key`` (cross-query coalescing). In the per-query plane each
        of them would have been a cache lookup against the copy the first
        prober inserted, so they count as hits — keeping hit-rate (and
        the doorkeeper's popularity votes) comparable across engines."""
        if n_extra > 0:
            self.hits += n_extra
            if self._sketch is not None:
                for _ in range(n_extra):
                    self._sketch.add(key)

    @property
    def hit_rate(self) -> float:
        """Lifetime hit fraction; a cache that saw zero lookups reports
        0.0 (never NaN — a benchmark dividing by query count relies on
        a finite value here)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self):
        """Zero the hit/miss/eviction counters without dropping resident
        objects — back-to-back benchmark passes measure each pass's hit
        rate instead of a lifetime blend leaking across passes."""
        self.hits = 0
        self.misses = 0
        self.bytes_evicted = 0
        self.n_evictions = 0
        self.n_admission_rejects = 0
