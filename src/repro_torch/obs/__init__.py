"""Observability plane: span tracing + metrics on the simulated event
clock (DESIGN.md §8), with a zero-cost no-op default.

The data plane (storage simulator, resilience chains, cache, both
search engines, the serving front-end) reports into whatever tracer /
metrics registry is *currently installed*:

    from repro_torch.obs import observe, Tracer, MetricsRegistry
    tracer, metrics = Tracer(), MetricsRegistry()
    with observe(tracer=tracer, metrics=metrics):
        search_pag(...)            # spans + counters recorded
    tracer.save("trace.json")      # chrome://tracing / ui.perfetto.dev
    print(metrics.snapshot())      # flat {name: value} dict

By default a disabled no-op pair is installed: every instrumentation
site degrades to an attribute lookup plus an empty method call, and
search results / ``SearchStats`` are bit-identical to the uninstrumented
code path (tested in tests/test_obs.py).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

from repro_torch.obs.metrics import NOOP_METRICS, MetricsRegistry
from repro_torch.obs.trace import NOOP_TRACER, Span, Tracer

__all__ = [
    "MetricsRegistry", "Span", "Tracer",
    "get_metrics", "get_tracer", "observe",
]

_tracer: Tracer = NOOP_TRACER
_metrics: MetricsRegistry = NOOP_METRICS


def get_tracer() -> Tracer:
    """The currently-installed tracer (the disabled no-op by default)."""
    return _tracer


def get_metrics() -> MetricsRegistry:
    """The currently-installed metrics registry (no-op by default)."""
    return _metrics


@contextlib.contextmanager
def observe(tracer: Optional[Tracer] = None,
            metrics: Optional[MetricsRegistry] = None) -> Iterator[None]:
    """Install a tracer and/or metrics registry for the dynamic extent
    of the block; either may be omitted (the previous one is kept)."""
    global _tracer, _metrics
    prev_t, prev_m = _tracer, _metrics
    if tracer is not None:
        _tracer = tracer
    if metrics is not None:
        _metrics = metrics
    try:
        yield
    finally:
        _tracer, _metrics = prev_t, prev_m
