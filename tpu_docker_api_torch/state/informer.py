"""Watch-fed read caches: the client-go informer/reflector pattern.

The reference reads etcd on demand for every request; an HA split makes
standby replicas re-seed from the store on EVERY read (`state/version.py`
read-through), so read fan-out still scaled with store capacity. This
module flips that: **list once, then watch** (`KV.range_prefix_with_rev` +
`KV.watch`, state/kv.py), replaying the event stream into a local mirror so
a standby serves GETs with ZERO store round trips per request — staleness
bounded by watch lag instead of by replica uptime, and the read path scales
with replica count.

Two pieces:

- :class:`Informer` — the reflector. One background thread: initial
  ``range_prefix`` + revision snapshot, then watch replay into the mirror,
  firing registered per-prefix handlers per event. On :class:`WatchLost`
  (compaction, overflow) or a store outage it RELISTS with capped backoff
  and emits a degradation event — the same loud-degrade stance as the
  durable work queue (docs/robustness.md): the cache never silently serves
  across a gap, and while unsynced the read path falls back to
  read-through.

- :class:`InformerReadKV` — the read-path switch. Wraps the daemon's store
  so ``get``/``range_prefix`` are served from the mirror while ``active()``
  (standby role) AND the informer is synced; every other call — and every
  read while degraded — delegates to the inner store untouched. Leader and
  ``leader_election = false`` behavior is byte-for-byte the old path.

Telemetry (the registry is the one set of books — status_view reads the
same counters /metrics exports): ``informer_events_total``,
``informer_relists_total``, ``informer_cache_hits_total``,
``informer_cache_misses_total`` and the ``informer_watch_lag_ms`` gauge.

The port's copy of ``tpu_docker_api/state/informer.py``, whole. The
port's daemon runs an ``Informer`` over the raw store as the reconciler's
dirty feed (``reconcile_full_interval_s > 0``); ``InformerReadKV`` is wired
with leader election (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.state.kv import KV, Watch, WatchEvent
from tpu_docker_api_torch.utils.backoff import backoff_delay_s

log = logging.getLogger(__name__)


class Informer:
    """Mirror of one KV subtree, kept current by watch replay.

    Reads (:meth:`get`, :meth:`range_prefix`) are lock-guarded dict lookups
    — never a store round trip. ``synced`` is True only while the gapless
    contract holds: initial list done and the watch stream alive; any gap
    or outage flips it False (readers fall back to the store) until the
    relist completes. Handlers registered via :meth:`register` see every
    mutation exactly once in revision order — including the synthetic
    diff events a relist emits for changes the gap swallowed — so a
    derived cache (e.g. a VersionMap shadow) can never drift from the
    mirror it feeds on.
    """

    POLL_TIMEOUT_S = 0.25

    def __init__(self, kv: KV, prefix: str, registry=None,
                 relist_backoff_base_s: float = 0.1,
                 relist_backoff_max_s: float = 5.0,
                 poll_timeout_s: float = POLL_TIMEOUT_S) -> None:
        from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry

        self._kv = kv
        self.prefix = prefix
        self.registry = registry if registry is not None else MetricsRegistry()
        self._backoff_base_s = relist_backoff_base_s
        self._backoff_max_s = relist_backoff_max_s
        self._poll_timeout_s = poll_timeout_s
        self._mu = threading.Lock()
        self._mirror: dict[str, str] = {}
        self._synced = False
        self._last_rev = 0
        #: monotonic timestamp of the last successful store contact (a
        #: drained poll — even an empty one — proves the mirror is current
        #: up to that instant); None = never synced
        self._last_contact: float | None = None
        self._handlers: list[tuple[str, Callable[[WatchEvent], None]]] = []
        self._relist_hooks: list[Callable[[], None]] = []
        self._events: collections.deque = collections.deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.registry.gauge_fn(
            "informer_watch_lag_ms", self.watch_lag_ms,
            help="ms since the informer last proved its mirror current "
                 "(-1 = never synced)")

    # -- read surface -------------------------------------------------------------

    @property
    def synced(self) -> bool:
        return self._synced

    @property
    def last_rev(self) -> int:
        return self._last_rev

    def get(self, key: str) -> str | None:
        with self._mu:
            return self._mirror.get(key)

    def range_prefix(self, prefix: str) -> dict[str, str]:
        with self._mu:
            return {k: v for k, v in sorted(self._mirror.items())
                    if k.startswith(prefix)}

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        """Snapshot + the revision it reflects under ONE lock hold — the
        pair must be atomic or a consumer doing list-then-watch against
        the mirror would lose the events applied between the two reads."""
        with self._mu:
            snap = {k: v for k, v in sorted(self._mirror.items())
                    if k.startswith(prefix)}
            return snap, self._last_rev

    def watch_lag_ms(self) -> float:
        last = self._last_contact
        if last is None:
            return -1.0
        return round((time.monotonic() - last) * 1e3, 3)

    def status_view(self) -> dict:
        """Operator block for /healthz and GET /api/v1/leader — counters
        read back from the registry, so this view and /metrics are one."""
        rv = self.registry.counter_value
        return {
            "synced": self._synced,
            "lastRev": self._last_rev,
            "watchLagMs": self.watch_lag_ms(),
            "eventsTotal": int(rv("informer_events_total")),
            "relistsTotal": int(rv("informer_relists_total")),
            "cacheHits": int(rv("informer_cache_hits_total")),
            "cacheMisses": int(rv("informer_cache_misses_total")),
        }

    def events_view(self, limit: int = 100) -> list[dict]:
        return list(self._events)[-limit:]  # deque snapshots are thread-safe

    # -- handler registration -----------------------------------------------------

    def register(self, prefix: str,
                 fn: Callable[[WatchEvent], None]) -> None:
        """Subscribe ``fn`` to every event whose key starts with ``prefix``
        (fired from the informer thread, in revision order). Register
        BEFORE :meth:`start` so the initial list's synthetic events are
        seen too."""
        self._handlers.append((prefix, fn))

    def on_relist(self, fn: Callable[[], None]) -> None:
        """Subscribe to every full list+rewatch cycle — fired AFTER the
        mirror swap, BEFORE the synthetic diff events. A consumer that
        derives incremental state from the event stream (the reconciler's
        dirty-set) uses this to fall back to treat-everything-as-changed:
        a relist means a gap swallowed an unknown set of events, and the
        synthetic diff only re-emits what the MIRROR noticed — a derived
        store with wider state than the mirror must reset, not trust it."""
        self._relist_hooks.append(fn)

    def _fire(self, events: list[WatchEvent]) -> None:
        for ev in events:
            for prefix, fn in self._handlers:
                if not ev.key.startswith(prefix):
                    continue
                try:
                    fn(ev)
                except Exception:  # noqa: BLE001 — one bad handler must
                    log.exception("informer handler failed for %s", ev.key)

    # -- the reflector loop -------------------------------------------------------

    def _relist(self) -> Watch:
        """List + swap the mirror + open the watch from the snapshot's
        revision. Changes the gap swallowed are re-emitted as synthetic
        diff events (vs the OLD mirror), so handlers stay exactly mirror-
        consistent without ever seeing a double."""
        snapshot, rev = self._kv.range_prefix_with_rev(self.prefix)
        with self._mu:
            old = self._mirror
            diff = [WatchEvent(rev, "put", k, v)
                    for k, v in snapshot.items() if old.get(k) != v]
            diff += [WatchEvent(rev, "delete", k, None)
                     for k in old if k not in snapshot]
            self._mirror = dict(snapshot)
            self._last_rev = rev
            self._synced = True
            self._last_contact = time.monotonic()
        self.registry.counter_inc(
            "informer_relists_total",
            help="Full list+rewatch cycles (1 = the initial sync; more = "
                 "WatchLost or store-outage recoveries)")
        for hook in self._relist_hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — one bad hook must not
                log.exception("informer relist hook failed")
        self._fire(diff)
        return self._kv.watch(self.prefix, rev)

    def _apply(self, events: list[WatchEvent]) -> None:
        with self._mu:
            for ev in events:
                if ev.op == "put":
                    self._mirror[ev.key] = ev.value
                else:
                    self._mirror.pop(ev.key, None)
                self._last_rev = max(self._last_rev, ev.rev)
        self.registry.counter_inc("informer_events_total",
                                  value=float(len(events)),
                                  help="Watch events replayed into the "
                                       "informer mirror")
        self._fire(events)

    def _degrade(self, reason: str, detail: str) -> None:
        """Loud degradation: the mirror can no longer prove itself gapless
        — stop serving it (readers fall back to the store) and say so."""
        self._synced = False
        log.warning("informer[%s] degraded (%s): %s",
                    self.prefix, reason, detail)
        self._events.append(trace.stamp(
            {"ts": time.time(), "event": "informer-degraded",
             "reason": reason, "detail": detail[:300]}))

    def _loop(self) -> None:
        attempt = 0
        watch: Watch | None = None
        while not self._stop.is_set():
            try:
                watch = self._relist()
                attempt = 0
                while not self._stop.is_set():
                    events = watch.poll(self._poll_timeout_s)
                    # a drained poll — even empty — proves currency
                    self._last_contact = time.monotonic()
                    if events:
                        self._apply(events)
            except errors.WatchLost as e:
                self._degrade("watch-lost", str(e))
                # no backoff: a lost watch is the store TELLING us to
                # relist, not the store being down
            except Exception as e:  # noqa: BLE001 — store outage et al.
                self._degrade("store-outage", f"{type(e).__name__}: {e}")
                self._stop.wait(backoff_delay_s(
                    attempt, self._backoff_base_s, self._backoff_max_s))
                attempt += 1
            finally:
                if watch is not None:
                    watch.close()
                    watch = None

    # -- lifecycle ----------------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="informer", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_timeout_s * 4 + 5)
            self._thread = None


class InformerReadKV(KV):
    """Read-path switch (see module docstring). ``get``/``range_prefix``
    serve from the informer mirror while ``active()`` and synced; every
    write — and every read while inactive or degraded — delegates to the
    inner store unchanged. The mirror is authoritative for ABSENCE too: a
    key the synced mirror lacks raises NotExistInStore without a store
    round trip (that is a cache hit, not a miss).

    One more mode when a ``store_health`` monitor is attached
    (service/store_health.py): while the store is in **outage**, reads
    serve from the mirror EVEN THOUGH it is unsynced — and regardless of
    role, leader included — with the staleness marked per request
    (``note_stale_read`` → envelope ``stale`` field + ``X-Stale-Read``
    header). An explicitly-stale answer beats burning a deadline-bounded
    store attempt per GET against a store known to be down; absence stays
    authoritative against the last-known mirror. Paginated walks are the
    exception — they are rev-anchored against the store's history, which
    a stale mirror cannot prove, so they keep paying the bounded attempt."""

    def __init__(self, inner: KV, informer: Informer,
                 active: Callable[[], bool], store_health=None) -> None:
        self.inner = inner
        self.informer = informer
        self._active = active
        self.store_health = store_health

    def _stale(self) -> bool:
        return (self.store_health is not None
                and self.store_health.serve_stale_reads())

    def _stale_hit(self) -> None:
        self.store_health.note_stale_read(self.informer.watch_lag_ms())

    def _serving(self) -> bool:
        if not self._active():
            return False  # leader/single: never counted, never mirrored
        if self.informer.synced:
            return True
        # configured for cached reads but degraded/unsynced: read-through
        # fallback, counted as a miss so the degradation is visible
        self.informer.registry.counter_inc(
            "informer_cache_misses_total",
            help="Standby reads that fell through to the store (informer "
                 "unsynced/degraded)")
        return False

    def _hit(self) -> None:
        self.informer.registry.counter_inc(
            "informer_cache_hits_total",
            help="Standby reads served from the informer mirror (zero "
                 "store round trips)")

    def get(self, key: str) -> str:
        if self._stale():
            self._stale_hit()
            value = self.informer.get(key)
            if value is None:
                raise errors.NotExistInStore(key)
            return value
        if self._serving():
            self._hit()
            value = self.informer.get(key)
            if value is None:
                raise errors.NotExistInStore(key)
            return value
        return self.inner.get(key)

    def range_prefix(self, prefix: str) -> dict[str, str]:
        if self._stale():
            self._stale_hit()
            return self.informer.range_prefix(prefix)
        if self._serving():
            self._hit()
            return self.informer.range_prefix(prefix)
        return self.inner.range_prefix(prefix)

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        if self._stale():
            self._stale_hit()
            return self.informer.range_prefix_with_rev(prefix)
        if self._serving():
            self._hit()
            # one informer lock hold: snapshot and rev must be atomic or
            # the list-then-watch handshake would lose in-between events
            return self.informer.range_prefix_with_rev(prefix)
        return self.inner.range_prefix_with_rev(prefix)

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        if self._stale():
            self._stale_hit()
            ks = [k for k in self.informer.range_prefix(prefix)
                  if k > start_after]
            return ks[:limit] if limit > 0 else ks
        if self._serving():
            self._hit()
            ks = [k for k in self.informer.range_prefix(prefix)
                  if k > start_after]
            return ks[:limit] if limit > 0 else ks
        return self.inner.keys_prefix(prefix, limit=limit,
                                      start_after=start_after)

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        # always the inner store: a page sequence is rev-anchored against
        # the STORE's revision history, which the mirror cannot prove (its
        # revs advance with watch lag) — a standby pays the read rather
        # than risking a silently inconsistent walk
        return self.inner.range_prefix_page(prefix, limit,
                                            start_after=start_after,
                                            at_rev=at_rev)

    def current_rev(self) -> int:
        return self.inner.current_rev()

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        return self.inner.watch(prefix, start_rev)

    # -- writes: delegate untouched ----------------------------------------------

    def put(self, key: str, value: str) -> None:
        self.inner.put(key, value)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def delete_prefix(self, prefix: str) -> None:
        self.inner.delete_prefix(prefix)

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        # the base template (our public ``apply``) already validated and
        # fired the txn crash points — delegate to the inner BACKEND's
        # atomic ``_apply`` so they never fire twice per batch
        self.inner._apply(ops, guards)

    def close(self) -> None:
        self.inner.close()
