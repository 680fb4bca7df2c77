"""Hierarchical span tracer on the simulated event clock, with a
Chrome-trace / Perfetto ``trace.json`` exporter.

Spans live on named *tracks* (one Perfetto thread row each): the batch
event clock gets one track per flushed batch (``batch0``, ``batch1``,
...), each traced query gets a child track (``batch0/q3``), the serving
front-end gets ``frontend``, and host-side CUDA kernel launches go on
a wall-clock track in their own process group (the two clocks must not
share a timeline). Three span shapes:

* ``span``    — a complete slice (``ph: "X"``). Slices on one track nest
  by time containment, which is how the hierarchy renders: the root
  batch/query span contains its compute/stall/scan children exactly.
* ``aspan``   — an async slice (``ph: "b"``/``"e"``): overlapping
  intervals (concurrent storage GETs of one RPC wave) stack instead of
  nesting, so I/O that overlaps compute stays readable.
* ``instant`` — a zero-duration marker (``ph: "i"``): retries,
  failovers, breaker skips, cache hits.

Plus *flow arrows* (``flow()``: a ``ph: "s"`` / ``ph: "f"`` pair
sharing one id) linking causally-related points on different tracks —
the serving front-end draws one from each ticket span to the per-query
child track its query landed on. Flows are emitted whole or not at all
(balanced ids even under track/span caps).

``NoopTracer`` (module singleton ``NOOP_TRACER``) is the zero-cost
default: ``enabled`` is False and every method is a bare ``pass`` —
instrumentation sites guard heavy work behind ``tracer.enabled``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

WALL_GROUP = "host-wall"      # wall-clock process group (kernel launches)
EVENT_GROUP = "event-clock"   # simulated-time process group


@dataclasses.dataclass
class Span:
    track: str                # track (thread row) name
    name: str
    t0_s: float               # start on the track's clock (seconds)
    dur_s: float
    cat: str = ""
    ph: str = "X"   # "X" complete | "b/e" async | "i" instant | "s/f" flow
    group: str = EVENT_GROUP  # process group (clock domain)
    args: Optional[Dict[str, Any]] = None
    flow_id: int = 0          # shared id of a flow's "s"/"f" endpoints

    @property
    def t1_s(self) -> float:
        return self.t0_s + self.dur_s


class Tracer:
    """Collects spans; exports Chrome trace-event JSON.

    ``max_tracks`` bounds the number of distinct tracks (a benchmark
    sweep would otherwise create one track per query per batch); spans
    aimed at a track beyond the cap are dropped, and ``n_dropped``
    reports how many. ``max_spans`` bounds total memory."""

    enabled = True

    def __init__(self, max_tracks: int = 256, max_spans: int = 500_000):
        self.max_tracks = max_tracks
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.n_dropped = 0
        self._tracks: Dict[str, int] = {}   # name -> creation order
        self._groups: Dict[str, int] = {}   # group counters (next_name)
        self._wall_t = 0.0                  # cursor of the wall track
        self._flow_id = 0                   # flow-arrow id counter

    # ------------------------------------------------------------- tracks
    def track(self, name: str) -> Optional[str]:
        """Register (or look up) a track; None once the cap is hit."""
        if name in self._tracks:
            return name
        if len(self._tracks) >= self.max_tracks:
            self.n_dropped += 1
            return None
        self._tracks[name] = len(self._tracks)
        return name

    def next_name(self, group: str) -> str:
        """Fresh sequential name, e.g. next_name("batch") -> "batch3"."""
        i = self._groups.get(group, 0)
        self._groups[group] = i + 1
        return f"{group}{i}"

    # -------------------------------------------------------------- spans
    def _add(self, span: Span) -> None:
        if len(self.spans) >= self.max_spans:
            self.n_dropped += 1
            return
        if self.track(span.track) is None:
            return
        self.spans.append(span)

    def span(self, track: str, name: str, t0_s: float, dur_s: float,
             cat: str = "", args: Optional[dict] = None,
             group: str = EVENT_GROUP) -> None:
        """A complete slice; nests by containment on its track."""
        self._add(Span(track, name, t0_s, dur_s, cat, "X", group, args))

    def aspan(self, track: str, name: str, t0_s: float, dur_s: float,
              cat: str = "", args: Optional[dict] = None) -> None:
        """An async slice: overlapping intervals stack, not nest."""
        self._add(Span(track, name, t0_s, dur_s, cat, "b", EVENT_GROUP,
                       args))

    def instant(self, track: str, name: str, t_s: float,
                args: Optional[dict] = None) -> None:
        self._add(Span(track, name, t_s, 0.0, "mark", "i", EVENT_GROUP,
                       args))

    def flow(self, from_track: str, t_from_s: float, to_track: str,
             t_to_s: float, name: str = "flow") -> None:
        """A flow arrow from one track's point to another's (Perfetto
        renders it as an arc). All-or-nothing: if either endpoint's
        track is over the cap or the span budget can't hold both
        endpoints, the whole flow is dropped — exported "s"/"f" ids
        always come in balanced pairs."""
        if self.track(from_track) is None or self.track(to_track) is None:
            self.n_dropped += 1
            return
        if len(self.spans) + 2 > self.max_spans:
            self.n_dropped += 1
            return
        self._flow_id += 1
        self.spans.append(Span(from_track, name, t_from_s, 0.0, "flow",
                               "s", EVENT_GROUP, None, self._flow_id))
        self.spans.append(Span(to_track, name, t_to_s, 0.0, "flow",
                               "f", EVENT_GROUP, None, self._flow_id))

    def wall_span(self, name: str, dur_s: float,
                  args: Optional[dict] = None,
                  track: str = "kernels") -> None:
        """Host wall-clock span (kernel launches); sequential cursor —
        the wall clock and the event clock never share a timeline."""
        self._add(Span(track, name, self._wall_t, dur_s, "kernel", "X",
                       WALL_GROUP, args))
        self._wall_t += dur_s

    # ------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable). Event-clock and
        wall-clock tracks live in separate process groups; timestamps
        are microseconds."""
        groups = {EVENT_GROUP: 1, WALL_GROUP: 2}
        events: List[dict] = []
        for group, pid in groups.items():
            events.append({"ph": "M", "pid": pid, "name": "process_name",
                           "args": {"name": f"{group}"}})
        seen: Dict[Tuple[int, str], int] = {}   # (pid, track) -> tid
        aid = 0
        for s in self.spans:
            pid = groups[s.group]
            tid = seen.get((pid, s.track))
            if tid is None:
                tid = len([k for k in seen if k[0] == pid]) + 1
                seen[(pid, s.track)] = tid
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": s.track}})
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": self._tracks.get(s.track, tid)}})
            ev = {"name": s.name, "cat": s.cat or "default", "pid": pid,
                  "tid": tid, "ts": s.t0_s * 1e6}
            if s.args:
                ev["args"] = s.args
            if s.ph == "X":
                ev.update(ph="X", dur=s.dur_s * 1e6)
                events.append(ev)
            elif s.ph == "b":
                aid += 1
                ev.update(ph="b", id=aid)
                events.append(ev)
                events.append({**ev, "ph": "e", "ts": s.t1_s * 1e6})
            elif s.ph == "s":
                ev.update(ph="s", id=s.flow_id)
                events.append(ev)
            elif s.ph == "f":
                ev.update(ph="f", bp="e", id=s.flow_id)
                events.append(ev)
            else:
                ev.update(ph="i", s="t")
                events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    # -------------------------------------------------------------- query
    def track_spans(self, track: str, ph: str = "X") -> List[Span]:
        return [s for s in self.spans if s.track == track and s.ph == ph]

    def roots(self, cat: str) -> List[Span]:
        """The root ("X", category ``cat``) span of every track that has
        one — batch roots with cat="batch", query roots with "query"."""
        return [s for s in self.spans if s.ph == "X" and s.cat == cat]


class NoopTracer(Tracer):
    """Disabled tracer: every record call is a no-op; instrumentation
    guards any span *construction* work behind ``enabled``."""

    enabled = False

    def __init__(self):
        super().__init__(max_tracks=0, max_spans=0)

    def track(self, name):           # noqa: D102
        return None

    def span(self, *a, **k):
        pass

    def aspan(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def flow(self, *a, **k):
        pass

    def wall_span(self, *a, **k):
        pass


NOOP_TRACER = NoopTracer()


# ---------------------------------------------------------------------------
# search-trace emission: QueryTimeline event history -> spans
# ---------------------------------------------------------------------------

def _emit_timeline_events(tracer: Tracer, track: str, events,
                          shift_s: float = 0.0) -> None:
    """Convert one ``QueryTimeline`` recorded history into spans:
    compute/stall/scan slices tile the root on the main track; io
    intervals (which overlap compute in async mode) become async slices;
    resilience-chain sub-events (retries, backoff, failover attempts)
    nest inside their io slice; zero-latency ``hit`` fetches become
    cache-hit instants."""
    for ev in events:
        t0, t1 = ev.t0_s + shift_s, ev.t1_s + shift_s
        if ev.kind == "io":
            if ev.t1_s <= ev.t0_s and ev.label.startswith("hit"):
                tracer.instant(track, f"cache_hit {ev.label[4:]}", t0)
                continue
            args = None
            oc = ev.detail
            if oc is not None and not isinstance(oc, (list, tuple)):
                args = {"retries": oc.retries, "failovers": oc.failovers,
                        "timeouts": oc.timeouts,
                        "corruptions": oc.corruptions,
                        "breaker_skips": oc.breaker_skips,
                        "ok": oc.ok, "replica": oc.replica_used}
                for name, e0, e1 in (oc.events or ()):
                    if e1 > e0:
                        tracer.aspan(track, name, t0 + e0, e1 - e0,
                                     cat="chain")
                    else:
                        tracer.instant(track, name, t0 + e0)
                if oc.breaker_skips:
                    tracer.instant(track, "breaker_skip", t0,
                                   {"n": oc.breaker_skips})
            tracer.aspan(track, ev.label or "get", t0, max(t1 - t0, 0.0),
                         cat="io", args=args)
        elif ev.kind in ("compute", "stall", "scan"):
            tracer.span(track, ev.label or ev.kind, t0,
                        max(ev.t1_s - ev.t0_s, 0.0), cat=ev.kind,
                        args={"stage": ev.stage})


def _is_prefetch(ev) -> bool:
    """Prefetch-wave io events belong to the NEXT batch's schedule; they
    ride on this batch's clock as trace-only slices and must not widen
    this batch's own fetch-wave stage extents."""
    return ev.kind == "io" and ev.label.startswith("prefetch")


def _stage_extent(events, kind: str, stage: int):
    ts = [(ev.t0_s, ev.t1_s) for ev in events
          if ev.kind == kind and ev.stage == stage
          and not _is_prefetch(ev)]
    if not ts:
        return None
    return min(t for t, _ in ts), max(t for _, t in ts)


def emit_search_spans(tracer: Tracer, *, batch_events, batch_span_s: float,
                      timelines, latencies_s, engine: str, pq: bool,
                      n_probes=None, group: Optional[str] = None,
                      t0_s: float = 0.0) -> str:
    """Emit one ``search_pag`` call as a span tree.

    * a batch track: root ``batch`` span of exactly ``batch_span_s``,
      compute/stall/scan children from the batch event clock (batched
      engine) or serialized per-query slices (per_query engine), plus
      ``fetch_wave`` / ``adc_scan`` / ``refine_wave`` stage spans (and
      ``prefetch_wave`` when the batch issued the next micro-batch's
      objects mid-flight);
    * one track per traced query (capped by the tracer): root ``query``
      span of exactly that query's latency with its own probe children.

    ``t0_s`` shifts the whole tree on the event clock — the serving
    front-end passes its flush cursor so frontend and batch tracks
    share one timeline (flow arrows then point forward in time).

    Returns the batch group name (track prefix)."""
    g = group or tracer.next_name("batch")
    q_count = len(timelines)
    tracer.span(g, f"batch[{q_count}q]", t0_s, batch_span_s, cat="batch",
                args={"engine": engine, "pq": pq, "queries": q_count})

    # per_query engine: the stream is serial on the batch clock — shift
    # each query's schedule by the stream offset so the batch track (and
    # the query tracks) read as the actual serial timeline.
    offsets = [0.0] * q_count
    if engine == "per_query":
        off = 0.0
        for qi in range(q_count):
            offsets[qi] = off
            off += latencies_s[qi]

    if batch_events is not None:
        _emit_timeline_events(tracer, g, batch_events, t0_s)
        evs = batch_events
    else:
        for qi, tl in enumerate(timelines):
            tracer.span(g, f"q{qi}", t0_s + offsets[qi],
                        latencies_s[qi], cat="scan", args={"stage": 0})
        evs = [ev for tl in timelines for ev in tl.events]

    # stage spans on the batch track (async: they overlap compute)
    wave_names = [("fetch_wave", "io", 0), ("refine_wave", "io", 1)]
    scan_names = [("adc_scan" if pq else "probe_scan", "scan", 0),
                  ("refine_scan", "scan", 1)]
    for name, kind, stage in wave_names + (scan_names if pq else
                                           scan_names[:1]):
        ext = _stage_extent(evs, kind, stage)
        if ext is not None:
            tracer.aspan(g, name, t0_s + ext[0], ext[1] - ext[0],
                         cat="stage")
    pf = [(ev.t0_s, ev.t1_s) for ev in evs if _is_prefetch(ev)]
    if pf:
        p0 = min(t for t, _ in pf)
        tracer.aspan(g, "prefetch_wave", t0_s + p0,
                     max(t for _, t in pf) - p0, cat="stage",
                     args={"keys": len(pf)})

    for qi, tl in enumerate(timelines):
        track = tracer.track(f"{g}/q{qi}")
        if track is None:
            continue                        # over the track cap
        args = {"engine": engine}
        if n_probes is not None:
            args["n_probes"] = n_probes[qi]
        tracer.span(track, f"query q{qi}", t0_s + offsets[qi],
                    latencies_s[qi], cat="query", args=args)
        _emit_timeline_events(tracer, track, tl.events,
                              t0_s + offsets[qi])
    return g
