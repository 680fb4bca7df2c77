"""Text reporting over a recorded trace: per-batch timeline breakdowns.

``timeline_breakdown`` folds a ``Tracer``'s span tree into one table per
batch root: how the batch span divides between traversal compute, fetch
stalls, and partition scans (the compute-thread slices tile the root
exactly, so the percentages sum to ~100%), plus the async stage extents
(fetch/refine waves, ADC pass) that overlap the compute thread. This is
the quick look — load the ``trace.json`` in Perfetto for the full tree.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.obs.trace import Span, Tracer

# compute-thread categories tile the batch root span
_TILE_CATS = ("compute", "stall", "scan")
_CAT_LABEL = {"compute": "traversal", "stall": "fetch stall",
              "scan": "scan"}


def _fmt_s(t: float) -> str:
    if t >= 1.0:
        return f"{t:8.3f}s "
    if t >= 1e-3:
        return f"{t * 1e3:8.3f}ms"
    return f"{t * 1e6:8.3f}us"


def _tile_durs(tracer: Tracer, root: Span) -> Dict[str, float]:
    """Total duration per compute-thread category under one batch root
    (the slices tile the root, so the values sum to ~root.dur_s)."""
    tile: Dict[str, float] = {c: 0.0 for c in _TILE_CATS}
    for s in tracer.spans:
        if s.track == root.track and s is not root \
                and s.ph == "X" and s.cat in tile:
            tile[s.cat] += s.dur_s
    return tile


def batch_tile_shares(tracer: Tracer, root: Span) -> Dict[str, float]:
    """Machine-readable version of ``batch_breakdown``: fraction of the
    batch span per tile category, keyed ``traversal`` / ``fetch_stall``
    / ``scan`` / ``other`` (benchmarks compare these across configs)."""
    tile = _tile_durs(tracer, root)
    total = root.dur_s or 1.0
    return {
        "traversal": tile["compute"] / total,
        "fetch_stall": tile["stall"] / total,
        "scan": tile["scan"] / total,
        "other": max(0.0, root.dur_s - sum(tile.values())) / total,
    }


def fetch_stall_share(tracer: Tracer) -> float:
    """Aggregate fetch-stall share over every batch root in the trace:
    total stalled compute-thread time / total batch span. The
    prefetch-ahead acceptance metric (benchmarks/prefetch.py)."""
    stall = span = 0.0
    for r in tracer.roots("batch"):
        stall += _tile_durs(tracer, r)["stall"]
        span += r.dur_s
    return stall / span if span else 0.0


def batch_breakdown(tracer: Tracer, root: Span) -> str:
    """One batch root -> a small text table (see module docstring)."""
    kids = [s for s in tracer.spans
            if s.track == root.track and s is not root]
    tile = _tile_durs(tracer, root)
    total = root.dur_s or 1.0
    covered = sum(tile.values())
    args = root.args or {}
    head = (f"{root.track}: {root.name} engine={args.get('engine', '?')}"
            f" pq={args.get('pq', '?')}  span {_fmt_s(root.dur_s).strip()}")
    lines = [head]
    for cat in _TILE_CATS:
        lines.append(f"  {_CAT_LABEL[cat]:<12}{_fmt_s(tile[cat])}"
                     f"  {100.0 * tile[cat] / total:5.1f}%")
    slack = root.dur_s - covered
    if slack > 1e-12:  # untiled remainder (per_query idle tail etc.)
        lines.append(f"  {'other':<12}{_fmt_s(slack)}"
                     f"  {100.0 * slack / total:5.1f}%")
    stages = [s for s in kids if s.ph == "b" and s.cat == "stage"]
    for s in sorted(stages, key=lambda s: s.t0_s):
        lines.append(f"  ~ {s.name:<12}{_fmt_s(s.dur_s)}"
                     f"  [{_fmt_s(s.t0_s).strip()} .."
                     f" {_fmt_s(s.t1_s).strip()}] (overlaps compute)")
    return "\n".join(lines)


def timeline_breakdown(tracer: Tracer) -> str:
    """Every batch root in the trace, one breakdown table each."""
    roots = tracer.roots("batch")
    if not roots:
        return "(no batch spans recorded)"
    out: List[str] = [batch_breakdown(tracer, r) for r in roots]
    if tracer.n_dropped:
        out.append(f"({tracer.n_dropped} spans dropped over"
                   f" track/span caps)")
    return "\n\n".join(out)
