"""The store failure domain: ``StoreHealth`` + ``StoreHealthKV``
(docs/robustness.md "Store brownouts").

The *host* failure domain (service/host_health.py: healthy → suspect →
down with a grace window, then "never act on unverifiable state") has its
symmetric twin here, for the state store itself. Every KV op the daemon
issues flows through :class:`StoreHealthKV`, which measures it and feeds
the outcome to :class:`StoreHealth` — a passive, grace-windowed state
machine::

    healthy --(fail_threshold consecutive failures)--> degraded
    degraded --(continuous failure >= outage_grace_s)--> outage
    any mode --(one successful op)--> healthy

Passive is the point: when the store is healthy this layer adds ZERO
store round trips (it only observes traffic that was happening anyway),
and a sub-threshold blip — one dropped packet, one slow fsync — causes
zero mode flips. Detection and healing both ride ops that exist for their
own reasons: the leader lease renew, the informer relist, API traffic.

Mode drives behavior elsewhere:

- **outage** ⇒ the API layer fails mutations fast with the typed
  :class:`errors.StoreDegraded` (HTTP 503 + ``Retry-After``) — an intent
  that cannot be journaled must never half-apply — except one
  **single-flight probe mutation** per ``probe_interval_s``, which is
  allowed through so a healed store is re-detected even on a deployment
  with no elector or informer traffic (the store analog of the host
  breaker's half-open probe).
- **outage** ⇒ reads serve from the informer mirror with EXPLICIT
  staleness (envelope field + header — see :func:`mark_stale_read` /
  :func:`consume_stale_read`), instead of burning a deadline-bounded
  store attempt per GET.
- **outage** ⇒ every writer loop (supervisor, reconciler, admission,
  autoscaler, workflow engine, compactor) checks :meth:`allows_writes`
  and holds — observes, but does not act.
- **outage → healthy** ⇒ ``on_recover`` hooks fire (the daemon wires a
  dirty-all reconcile + supervisor wake), so recovery is loss-free and
  immediate rather than waiting out the anti-entropy interval.

The port's copy of ``tpu_docker_api/service/store_health.py``, whole. The
port's daemon has no elector, informer read path or job supervisor yet, so
API traffic and the reconciler's passes are what feed the machine, and
``on_recover`` marks the reconciler's families dirty.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.state.kv import KV, Watch
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry

log = logging.getLogger(__name__)

#: store_op_ms histogram buckets: sub-ms memory ops through multi-second
#: deadline expiries
_OP_MS_BUCKETS = (0.05, 0.2, 1.0, 5.0, 25.0, 100.0, 500.0, 2000.0, 10000.0)

_MODE_VALUE = {"healthy": 0, "degraded": 1, "outage": 2}

#: per-request staleness marker (thread-per-request HTTP server: the
#: handler thread that served the read consumes its own marker)
_STALE = threading.local()


def mark_stale_read(lag_ms: float) -> None:
    """Called by the read path that served a request from the informer
    mirror during a store outage — the HTTP layer surfaces it as the
    ``stale`` envelope field + ``X-Stale-Read`` header."""
    _STALE.lag_ms = lag_ms


def consume_stale_read() -> float | None:
    """Pop this thread's staleness marker (None = the request touched no
    stale read). Popping, not reading: a keep-alive thread serves many
    requests and a marker must never leak across them."""
    lag = getattr(_STALE, "lag_ms", None)
    _STALE.lag_ms = None
    return lag


class StoreHealth:
    """Grace-windowed store-mode state machine fed by op outcomes."""

    def __init__(self, fail_threshold: int = 3, outage_grace_s: float = 2.0,
                 probe_interval_s: float = 1.0,
                 registry: MetricsRegistry | None = None,
                 clock=time.monotonic, max_events: int = 256) -> None:
        self._threshold = max(1, fail_threshold)
        self._grace_s = outage_grace_s
        self._probe_interval_s = probe_interval_s
        self._registry = registry if registry is not None else MetricsRegistry()
        self._clock = clock
        self._mu = threading.Lock()
        self._mode = "healthy"
        self._streak = 0                # consecutive failures
        self._first_fail_at: float | None = None
        self._last_transition = time.time()
        self._last_probe_at: float | None = None
        self._last_error = ""
        self._on_recover: list = []
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._registry.gauge_fn(
            "store_mode", lambda: float(_MODE_VALUE[self._mode]),
            help="Store health mode (0 = healthy, 1 = degraded, 2 = outage)")

    # -- feeding ------------------------------------------------------------------

    def observe(self, op: str, ms: float, ok: bool, error: str = "") -> None:
        """One op outcome (called by StoreHealthKV for every store round
        trip). ``ok`` is "the store answered" — application errors like
        NotExistInStore prove the path alive; only StoreUnavailable
        counts as a failure."""
        self._registry.counter_inc(
            "store_ops_total", {"outcome": "ok" if ok else "unavailable"},
            help="Store ops by outcome (unavailable = connection-class)")
        self._registry.observe(
            "store_op_ms", ms, buckets=_OP_MS_BUCKETS,
            help="Store op wall time, milliseconds")
        recovered_from = None
        # a single observe can ride through BOTH edges (the Nth failure may
        # already be past the grace window when the feed is sparse, e.g. a
        # backed-off informer) — record every transition, not just the last
        transitions: list[tuple[str, str]] = []
        now = self._clock()
        with self._mu:
            prev = self._mode
            if ok:
                self._streak = 0
                self._first_fail_at = None
                if prev != "healthy":
                    self._mode = "healthy"
                    self._last_transition = time.time()
                    transitions.append((prev, "healthy"))
                    if prev == "outage":
                        recovered_from = prev
            else:
                self._streak += 1
                self._last_error = error
                if self._first_fail_at is None:
                    self._first_fail_at = now
                if prev == "healthy" and self._streak >= self._threshold:
                    self._mode = prev = "degraded"
                    self._last_transition = time.time()
                    transitions.append(("healthy", "degraded"))
                if (prev == "degraded"
                        and now - self._first_fail_at >= self._grace_s):
                    self._mode = "outage"
                    self._last_transition = time.time()
                    transitions.append((prev, "outage"))
                    self._registry.counter_inc(
                        "store_outages_total",
                        help="Store outage episodes (grace window elapsed)")
        for frm, to in transitions:
            self._record("store-mode-" + to, frm=frm,
                         error=error[:200] if error else "")
            log.warning("store health: %s -> %s%s", frm, to,
                        f" ({error})" if error else "")
        if recovered_from is not None:
            for hook in list(self._on_recover):
                try:
                    hook()
                except Exception:  # noqa: BLE001 — one bad hook must not
                    log.exception("store on_recover hook failed")

    # -- mode surface -------------------------------------------------------------

    @property
    def mode(self) -> str:
        return self._mode

    def allows_writes(self) -> bool:
        """The writer-loop gate: a restart/preempt/scale/compact decision
        must never fire while its intent cannot be journaled."""
        return self._mode != "outage"

    def admit_mutation(self) -> None:
        """API-layer mutation gate. Healthy/degraded: pass. Outage: fail
        fast with the typed 503 — zero store round trips — EXCEPT one
        probe mutation per ``probe_interval_s``, admitted through to the
        store so its outcome re-detects a heal (single-flight in time,
        like the host breaker's half-open probe)."""
        with self._mu:
            if self._mode != "outage":
                return
            now = self._clock()
            if (self._last_probe_at is None
                    or now - self._last_probe_at >= self._probe_interval_s):
                self._last_probe_at = now
                return  # this caller IS the probe
            retry_in = self._probe_interval_s - (now - self._last_probe_at)
        raise errors.StoreDegraded(
            f"store outage: mutations held until the store heals "
            f"(last error: {self._last_error[:200]})",
            retry_after_s=max(retry_in, 0.05),
            data={"storeMode": "outage"})

    def serve_stale_reads(self) -> bool:
        """True while reads should ride the informer mirror (outage mode):
        an explicit stale read beats a deadline-bounded failure per GET."""
        return self._mode == "outage"

    def on_recover(self, fn) -> None:
        """Subscribe to outage → healthy transitions (fired outside the
        lock, after the mode flip is visible)."""
        self._on_recover.append(fn)

    # -- views / telemetry --------------------------------------------------------

    def _record(self, kind: str, **extra) -> None:
        evt = trace.stamp({"ts": time.time(), "event": kind, **extra})
        with self._mu:
            self._events.append(evt)

    def note_stale_read(self, lag_ms: float) -> None:
        self._registry.counter_inc(
            "store_stale_reads_total",
            help="Reads served from the informer mirror during a store "
                 "outage (explicit staleness surfaced to the caller)")
        mark_stale_read(lag_ms)

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            return list(self._events)[-limit:]

    def status_view(self) -> dict:
        rv = self._registry.counter_value
        with self._mu:
            return {
                "mode": self._mode,
                "consecutiveFailures": self._streak,
                "lastTransitionTs": self._last_transition,
                "lastError": self._last_error[:200],
                "failThreshold": self._threshold,
                "outageGraceS": self._grace_s,
                "opsOk": int(rv("store_ops_total", {"outcome": "ok"})),
                "opsUnavailable": int(
                    rv("store_ops_total", {"outcome": "unavailable"})),
                "outagesTotal": int(rv("store_outages_total")),
                "staleReads": int(rv("store_stale_reads_total")),
            }


class _HealthWatch(Watch):
    """Watch wrapper: a poll that dies with StoreUnavailable feeds the
    state machine like any other op (a dead watch stream IS store
    traffic); a drained poll — even empty — proves the path alive."""

    def __init__(self, inner: Watch, health: StoreHealth) -> None:
        self._inner = inner
        self._health = health

    def poll(self, timeout_s: float):
        t0 = time.perf_counter()
        try:
            events = self._inner.poll(timeout_s)
        except errors.StoreUnavailable as e:
            self._health.observe("watch.poll",
                                 (time.perf_counter() - t0) * 1e3,
                                 ok=False, error=str(e))
            raise
        self._health.observe("watch.poll",
                             (time.perf_counter() - t0) * 1e3, ok=True)
        return events

    def close(self) -> None:
        self._inner.close()


class StoreHealthKV(KV):
    """Measurement wrapper installed directly above the raw backend: every
    op is timed and its outcome fed to :class:`StoreHealth`. Purely
    observational — no op is blocked, retried or rerouted here (fail-fast
    and stale-serving live at the API/read layers), so the healthy path
    is byte-for-byte the inner backend's plus one clock read."""

    def __init__(self, inner: KV, health: StoreHealth) -> None:
        self.inner = inner
        self.health = health

    def _invoke(self, op: str, fn):
        t0 = time.perf_counter()
        try:
            result = fn()
        except errors.StoreUnavailable as e:
            self.health.observe(op, (time.perf_counter() - t0) * 1e3,
                                ok=False, error=str(e))
            raise
        except errors.ApiError:
            # application outcome (NotExistInStore, GuardFailed,
            # ContinueExpired): the store ANSWERED — the path is alive
            self.health.observe(op, (time.perf_counter() - t0) * 1e3, ok=True)
            raise
        self.health.observe(op, (time.perf_counter() - t0) * 1e3, ok=True)
        return result

    def put(self, key: str, value: str) -> None:
        return self._invoke("put", lambda: self.inner.put(key, value))

    def get(self, key: str) -> str:
        return self._invoke("get", lambda: self.inner.get(key))

    def delete(self, key: str) -> None:
        return self._invoke("delete", lambda: self.inner.delete(key))

    def range_prefix(self, prefix: str) -> dict[str, str]:
        return self._invoke("range_prefix",
                            lambda: self.inner.range_prefix(prefix))

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        return self._invoke(
            "keys_prefix",
            lambda: self.inner.keys_prefix(prefix, limit=limit,
                                           start_after=start_after))

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        return self._invoke(
            "range_prefix_page",
            lambda: self.inner.range_prefix_page(prefix, limit,
                                                 start_after=start_after,
                                                 at_rev=at_rev))

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        return self._invoke(
            "range_prefix_with_rev",
            lambda: self.inner.range_prefix_with_rev(prefix))

    def delete_prefix(self, prefix: str) -> None:
        return self._invoke("delete_prefix",
                            lambda: self.inner.delete_prefix(prefix))

    def current_rev(self) -> int:
        return self._invoke("current_rev", lambda: self.inner.current_rev())

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        # the base template (our public ``apply``) already validated and
        # fired the txn crash points — delegate to the inner backend's
        # atomic ``_apply`` so they never fire twice per batch
        return self._invoke("apply", lambda: self.inner._apply(ops, guards))

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        return _HealthWatch(self.inner.watch(prefix, start_rev), self.health)

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name: str):
        # backend/wrapper helpers (FaultyKV's fault controls, CountingKV's
        # snapshot) pass through — instrumentation must not hide them
        return getattr(self.inner, name)
