"""Metrics registry: counters, gauges, and fixed-bucket histograms,
snapshot-able to a flat ``{name: value}`` dict.

The data plane reports through the convenience methods (``inc`` /
``set_gauge`` / ``observe``); instruments are created on first use so
instrumentation sites never pre-register. ``NoopMetrics`` (singleton
``NOOP_METRICS``) is the zero-cost default — every method is a bare
``pass``.

Histograms use fixed bucket *upper bounds* (defaults log-spaced from
1 µs to 10 s — sized for simulated RPC latencies; byte-sized metrics
pass ``BYTE_BUCKETS``). The snapshot flattens each histogram to
``name.count`` / ``name.sum`` / ``name.mean`` / ``name.max`` plus one
``name.le_<bound>`` cumulative count per bucket, so the whole registry
serializes to one flat JSON-friendly dict.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# log-spaced seconds: 1us .. 10s (3 per decade), plus +inf overflow
LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(m * 10.0 ** e, 12)
    for e in range(-6, 1) for m in (1.0, 2.0, 5.0)) + (10.0,)
BYTE_BUCKETS: Tuple[float, ...] = tuple(
    float(2 ** e) for e in range(6, 28, 2))      # 64 B .. 64 MB
COUNT_BUCKETS: Tuple[float, ...] = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram; ``bounds`` are inclusive upper bounds,
    with an implicit +inf overflow bucket at the end."""

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS):
        self.bounds: List[float] = sorted(bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket holding
        the q-th observation); the overflow bucket reports ``max``."""
        if not self.count:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max


class MetricsRegistry:
    enabled = True

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(bounds or LATENCY_BUCKETS)
        return h

    # ------------------------------------------------------- convenience
    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float,
                bounds: Optional[Sequence[float]] = None) -> None:
        self.histogram(name, bounds).observe(v)

    # ------------------------------------------------------------- admin
    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()

    def to_openmetrics(self) -> str:
        """OpenMetrics text exposition of the registry: counters as
        ``<name>_total``, gauges bare, histograms as cumulative
        ``_bucket{le="..."}`` series (with the mandatory ``+Inf``
        bucket) plus ``_sum``/``_count``, terminated by ``# EOF``.
        Metric names swap the registry's dots for underscores
        (``storage.gets`` -> ``storage_gets``)."""
        def name_of(n: str) -> str:
            return n.replace(".", "_").replace("-", "_")

        def value_of(v: float) -> str:
            f = float(v)
            if f == int(f) and abs(f) < 1e15:
                return str(int(f))
            return repr(f)   # repr round-trips; %g would lose digits

        lines: List[str] = []
        for name, c in sorted(self._counters.items()):
            n = name_of(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n}_total {value_of(c.value)}")
        for name, g in sorted(self._gauges.items()):
            n = name_of(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {value_of(g.value)}")
        for name, h in sorted(self._hists.items()):
            n = name_of(name)
            lines.append(f"# TYPE {n} histogram")
            acc = 0
            for bound, cnt in zip(h.bounds, h.counts):
                acc += cnt
                lines.append(f'{n}_bucket{{le="{bound:g}"}} {acc}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {value_of(h.sum)}")
            lines.append(f"{n}_count {h.count}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, float]:
        """One flat dict: counters and gauges by name; histograms
        flattened to .count/.sum/.mean/.max/.p50/.p99 + .le_* buckets."""
        out: Dict[str, float] = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[name] = g.value
        for name, h in sorted(self._hists.items()):
            out[f"{name}.count"] = float(h.count)
            out[f"{name}.sum"] = h.sum
            out[f"{name}.mean"] = h.mean
            out[f"{name}.max"] = h.max if h.count else 0.0
            out[f"{name}.p50"] = h.quantile(0.50)
            out[f"{name}.p99"] = h.quantile(0.99)
            acc = 0
            for bound, n in zip(h.bounds, h.counts):
                acc += n
                out[f"{name}.le_{bound:g}"] = float(acc)
        return out


class NoopMetrics(MetricsRegistry):
    """Disabled registry: report calls are no-ops. The instrument
    accessors still work (returning throwaway instruments) so shared
    code can hold references without None checks."""

    enabled = False

    def inc(self, name, n=1.0):
        pass

    def set_gauge(self, name, v):
        pass

    def observe(self, name, v, bounds=None):
        pass


NOOP_METRICS = NoopMetrics()
