"""Dapper-shaped control-plane tracer (docs/observability.md).

The port's copy of ``tpu_docker_api/telemetry/trace.py``, unchanged but
for its context variable's name.

SURVEY.md §5.1: the reference observes itself through process logs only.
The metrics registry (telemetry/metrics.py) answered "how much/how often";
this module answers "where did *this* request's 23 ms go" — a causally
linked span tree from the HTTP handler down through the store apply, the
scheduler claim, the family-lock wait, the runtime fan-out batch and the
async work-queue tail.

Design (always-on sampled, stdlib-only):

- :class:`Span` — traceId / spanId / parentId, name, attrs, status, a wall
  timestamp for display and a **monotonic** start for duration/coverage
  math. Spans live in context-local storage (``contextvars``) while open,
  so child creation needs no plumbing: ``trace.child("kv.apply")`` finds
  its parent wherever the call happens to run.
- :class:`Tracer` — per-process (per-``Program``) span sink: a bounded
  ring of recent traces (O(``buffer_size``) memory; eviction is normal
  ring behavior but LOUD — ``trace_dropped_total``), exported at
  ``GET /api/v1/traces`` (+ ``/{traceId}``). One tracer per daemon keeps
  multi-daemon test processes (the failover bench boots three) from
  cross-contaminating buffers: a child span records into its PARENT's
  tracer, not a global.
- **Links, not parentage, across process death.** The work queue journals
  the submitting span's (traceId, spanId) into each ``TaskRecord`` and the
  admission journal carries the enqueueing request's traceId; the daemon
  that executes a record in the same process CONTINUES the trace (same
  traceId, parent = the submit span), while a replayed/adopted record —
  a different daemon, or this one after a reboot — starts a fresh trace
  carrying ``links=[originTraceId]``: the origin's span tree ended with
  the dead process, so pretending parentage would fabricate a timeline.
- **Crash parity.** Spans close in ``finally``; an ``Exception`` marks
  ``status="error"``, a ``BaseException`` (the chaos harness's
  ``SimulatedCrash`` — the kill -9 model) marks ``status="lost"``. Spans
  still open when a tracer shuts down (``close()``) are force-finished as
  ``lost`` — a reboot never inherits open spans, and the buffer is
  readable after any crash.
- **Disabled mode is a no-op, not a code path.** ``tracing_enabled=false``
  means root creation returns the shared no-op context manager and every
  ``child()`` call is one ``ContextVar.get`` returning None — the churn
  benchmark gates this accounting at ≤ 1% of the flow p50.

Writer loops (reconciler passes, admission ticks, autoscaler ticks,
compactor passes) open self-rooted spans with ``trim_idle=True``: a pass
that finished ``ok`` without recording a single child span (nothing
written, nothing claimed, nothing waited on) is discarded instead of
buffered, so a quiet daemon's tick loops cannot evict the request traces
an operator actually wants.
"""

from __future__ import annotations

import collections
import contextvars
import threading
import time
import uuid

#: context-local open span (the parent for the next child() call)
_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "tpu_docker_api_torch_trace_span", default=None)

#: per-trace span cap: a runaway loop inside one request must not grow the
#: buffer unboundedly — further spans are counted, not stored
MAX_SPANS_PER_TRACE = 512


class Span:
    """One timed operation. Open until :meth:`Tracer._finish` runs (always
    via the context manager's ``finally``)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attrs",
                 "status", "links", "start_ts", "start_mono", "duration_ms",
                 "tracer", "trim_idle", "is_root")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str, name: str, attrs: dict,
                 links: tuple = (), trim_idle: bool = False,
                 is_root: bool = False) -> None:
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.links = tuple(links)
        self.status = "open"
        self.start_ts = time.time()
        self.start_mono = time.perf_counter()
        self.duration_ms: float | None = None
        self.trim_idle = trim_idle
        #: LOCAL root: opened with no in-process parent span. Distinct
        #: from parent_id == "" — a traceparent-continued request has a
        #: REMOTE parent id yet is still this process's root (it must
        #: count as rooted and fire slow-trace events)
        self.is_root = is_root

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "status": self.status,
            "startTs": round(self.start_ts, 6),
            "startMonoMs": round(self.start_mono * 1e3, 3),
            "durationMs": (None if self.duration_ms is None
                           else round(self.duration_ms, 3)),
            "isRoot": self.is_root,
            "attrs": dict(self.attrs),
            "links": list(self.links),
        }


class _SpanScope:
    """Context manager binding one span to the context-local slot.
    ``Exception`` → status ``error`` (the flow failed but unwound);
    ``BaseException`` → ``lost`` (the kill -9 model: the flow never
    finished and never will)."""

    __slots__ = ("_span", "_token")

    def __init__(self, span: Span) -> None:
        self._span = span

    def __enter__(self) -> Span:
        self._token = _current.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        _current.reset(self._token)
        if exc_type is None:
            # a caller that enveloped its own failure (the HTTP handler)
            # may pre-set status; untouched spans close ok
            status = ("ok" if self._span.status == "open"
                      else self._span.status)
        elif issubclass(exc_type, Exception):
            status = "error"
        else:
            status = "lost"
        self._span.tracer._finish(self._span, status)
        return False


class _Noop:
    """Shared no-op scope: the disabled / no-active-trace fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _TraceEntry:
    __slots__ = ("spans", "dropped_spans")

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.dropped_spans = 0


class Tracer:
    """Bounded in-process trace sink. One per daemon (``Program``)."""

    def __init__(self, buffer_size: int = 256, enabled: bool = True,
                 registry=None, slow_ms: float = 0.0,
                 max_events: int = 128) -> None:
        self._mu = threading.Lock()
        self.buffer_size = max(1, int(buffer_size))
        self.enabled = bool(enabled)
        self._registry = registry
        self.slow_ms = float(slow_ms)
        #: trace_id -> entry, oldest first (OrderedDict as ring)
        self._traces: "collections.OrderedDict[str, _TraceEntry]" = (
            collections.OrderedDict())
        self._open: dict[str, Span] = {}
        #: open spans per trace (a root with trim_idle must not be
        #: discarded while a cross-thread child is still in flight)
        self._open_by_trace: dict[str, int] = {}
        self._dropped = 0
        #: slow-trace events for the merged /api/v1/events ring
        self._events: collections.deque = collections.deque(maxlen=max_events)

    # -- span creation ------------------------------------------------------------

    def span(self, name: str, parent: Span | None = None,
             trace_id: str = "", parent_id: str = "",
             links: tuple = (), attrs: dict | None = None,
             trim_idle: bool = False, root: bool | None = None):
        """Open a span scope. Parent resolution: an explicit ``parent``
        Span wins (the cross-thread fan-out case), else the context-local
        current span, else this is a root. ``trace_id`` / ``parent_id``
        seed the span from a REMOTE context (the HTTP layer's traceparent
        / X-Request-Id, a journaled queue record); ``links`` attach origin
        traces without claiming parentage (queue replay). ``root``
        overrides local-rootness: the HTTP handler passes True because a
        traceparent-continued request is still THIS process's serving root
        despite its remote parent id, while a queue continuation (also
        parentless in-process, also remote parent id) is NOT — its trace
        already has the submitting request as root. Default: root iff no
        parent of any kind. Disabled tracer ⇒ shared no-op."""
        if not self.enabled:
            return NOOP
        if parent is None:
            parent = _current.get()
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        else:
            trace_id = trace_id or uuid.uuid4().hex
        if root is None:
            root = parent is None and not parent_id
        span = Span(self, trace_id, uuid.uuid4().hex[:16], parent_id,
                    name, dict(attrs or ()), links=links,
                    trim_idle=trim_idle, is_root=root)
        with self._mu:
            self._open[span.span_id] = span
            self._open_by_trace[trace_id] = (
                self._open_by_trace.get(trace_id, 0) + 1)
        return _SpanScope(span)

    def _finish(self, span: Span, status: str) -> None:
        with self._mu:
            if self._open.pop(span.span_id, None) is None:
                # already finished — close_orphans racing the owning
                # thread's scope exit; a second append would duplicate
                # the span (two identical roots) in the buffer
                return
            left = self._open_by_trace.get(span.trace_id, 1) - 1
            if left <= 0:
                self._open_by_trace.pop(span.trace_id, None)
            else:
                self._open_by_trace[span.trace_id] = left
        span.duration_ms = (time.perf_counter() - span.start_mono) * 1e3
        span.status = status
        with self._mu:
            entry = self._traces.get(span.trace_id)
            if entry is None:
                entry = _TraceEntry()
                self._traces[span.trace_id] = entry
            self._traces.move_to_end(span.trace_id)
            if span.trim_idle and status == "ok" and not entry.spans \
                    and not self._open_by_trace.get(span.trace_id):
                # an idle loop pass: nothing beneath it happened — keep the
                # ring for traces that carry information
                if span.trace_id in self._traces:
                    del self._traces[span.trace_id]
                return
            if len(entry.spans) >= MAX_SPANS_PER_TRACE:
                entry.dropped_spans += 1
                self._count_drop("span")
            else:
                entry.spans.append(span)
            while len(self._traces) > self.buffer_size:
                self._traces.popitem(last=False)
                self._dropped += 1
                self._count_drop("trace")
        if (self.slow_ms > 0 and span.is_root
                and span.duration_ms >= self.slow_ms):
            self._events.append({
                "ts": time.time(), "event": "slow-trace",
                "traceId": span.trace_id, "name": span.name,
                "durationMs": round(span.duration_ms, 3),
            })

    def _count_drop(self, kind: str) -> None:
        if self._registry is not None:
            self._registry.counter_inc(
                "trace_dropped_total", {"kind": kind},
                help="Traces evicted from (or spans dropped by) the "
                     "bounded trace buffer")

    # -- views (GET /api/v1/traces) -----------------------------------------------

    def summaries(self, limit: int = 100) -> dict:
        """Recent trace summaries, newest first."""
        items = []
        with self._mu:
            entries = list(self._traces.items())
            dropped = self._dropped
            open_n = len(self._open)
            for trace_id, entry in reversed(entries[-limit:] if limit > 0
                                            else entries):
                if not entry.spans:
                    continue
                roots = [s for s in entry.spans if s.is_root]
                head = roots[0] if roots else entry.spans[0]
                t0 = min(s.start_mono for s in entry.spans)
                t1 = max(s.start_mono + (s.duration_ms or 0.0) / 1e3
                         for s in entry.spans)
                links = sorted({ln for s in entry.spans for ln in s.links})
                items.append({
                    "traceId": trace_id,
                    "root": head.name,
                    "rootCount": len(roots),
                    "spans": len(entry.spans),
                    "status": ("lost" if any(s.status == "lost"
                                             for s in entry.spans)
                               else head.status),
                    "startTs": round(min(s.start_ts for s in entry.spans), 6),
                    "durationMs": round((t1 - t0) * 1e3, 3),
                    "links": links,
                })
        return {"items": items, "dropped": dropped, "openSpans": open_n,
                "enabled": self.enabled, "bufferSize": self.buffer_size}

    def trace_view(self, trace_id: str) -> dict | None:
        """Full span tree for one trace (spans in start order), or None."""
        with self._mu:
            entry = self._traces.get(trace_id)
            if entry is None:
                return None
            spans = sorted(entry.spans, key=lambda s: s.start_mono)
            return {"traceId": trace_id,
                    "spans": [s.to_dict() for s in spans],
                    "droppedSpans": entry.dropped_spans}

    def find_by_request_id(self, request_id: str) -> dict | None:
        """Newest trace whose root span carries ``requestId == request_id``
        in its attrs — the fallback for requests that arrived with BOTH a
        ``traceparent`` (which keys the trace) and an ``X-Request-Id``
        (which the envelope echoed). O(buffer) scan of a bounded ring."""
        with self._mu:
            match = None
            for trace_id, entry in self._traces.items():
                # only the HTTP handler's request spans carry the attr —
                # and a traceparent-continued one has a REMOTE parentId,
                # so the attr (not rootness) is the match criterion
                for s in entry.spans:
                    if s.attrs.get("requestId") == request_id:
                        match = trace_id  # keep scanning: newest wins
                        break
        return None if match is None else self.trace_view(match)

    def stats(self) -> dict:
        with self._mu:
            return {"traces": len(self._traces), "openSpans": len(self._open),
                    "dropped": self._dropped, "enabled": self.enabled,
                    "bufferSize": self.buffer_size}

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        return list(self._events)[-limit:]  # deque snapshots are thread-safe

    # -- lifecycle ----------------------------------------------------------------

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def close_orphans(self) -> int:
        """Force-finish every still-open span as ``lost`` — the reboot
        contract: no daemon ever inherits (or reports) an open span from a
        dead flow. Returns how many were closed."""
        with self._mu:
            orphans = list(self._open.values())
        for span in orphans:
            self._finish(span, "lost")
        return len(orphans)

    def close(self) -> None:
        self.close_orphans()


# -- module helpers (the instrumentation surface) ------------------------------


def current() -> Span | None:
    """The context-local open span, or None."""
    return _current.get()


def current_trace_id() -> str:
    span = _current.get()
    return span.trace_id if span is not None else ""


def child(name: str, **attrs):
    """Child scope of the context-local current span; shared no-op when no
    trace is active (ONE ContextVar.get — the disabled-mode cost the churn
    family's overhead gate accounts)."""
    parent = _current.get()
    if parent is None:
        return NOOP
    return parent.tracer.span(name, parent=parent, attrs=attrs)


def child_of(parent: Span | None, name: str, **attrs):
    """Explicit-parent child scope — for worker threads (the fan-out pool)
    where the caller's context does not propagate."""
    if parent is None:
        return NOOP
    return parent.tracer.span(name, parent=parent, attrs=attrs)


def pass_span(tracer: "Tracer | None", name: str, **attrs):
    """Span scope for one writer-loop pass (reconcile, admission tick,
    autoscale tick, compaction). Called from a loop thread it opens a
    SELF-ROOTED trace with ``trim_idle`` (a pass that did nothing beneath
    it is discarded, so quiet tick loops can't evict request traces);
    called inside an active trace (the HTTP ?mode=/compact routes) it is
    an ordinary child span of that request."""
    parent = _current.get()
    if parent is not None:
        return parent.tracer.span(name, parent=parent, attrs=attrs)
    if tracer is None:
        return NOOP
    return tracer.span(name, attrs=attrs, trim_idle=True)


def traced(name: str):
    """Decorator form of :func:`child` for hot entry points (scheduler
    claims): zero-overhead pass-through when no trace is active."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            parent = _current.get()
            if parent is None:
                return fn(*args, **kwargs)
            with parent.tracer.span(name, parent=parent):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def stamp(event: dict) -> dict:
    """Attach the current traceId to an event-ring entry (in place), so
    ``GET /api/v1/events?traceId=`` joins events to traces. No active
    trace ⇒ untouched (the legacy event shape)."""
    span = _current.get()
    if span is not None:
        event["traceId"] = span.trace_id
    return event


# -- W3C traceparent (the remote-context handshake) ----------------------------


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """``00-<trace32>-<span16>-<flags>`` → (trace_id, parent_span_id), or
    None for anything malformed (a bad header must never fail a request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # all-zero ids are explicitly invalid per the spec
    return trace_id, span_id


def format_traceparent(span: Span) -> str:
    trace_id = span.trace_id
    if len(trace_id) != 32 or not all(c in "0123456789abcdef"
                                      for c in trace_id):
        # opaque request ids (X-Request-Id) are legal trace ids internally
        # but not on the wire; no valid traceparent can carry them
        return ""
    return f"00-{trace_id}-{span.span_id}-01"
