"""Pluggable key-value backends.

Parity: reference ``internal/etcd/{client,common}.go`` — a clientv3 wrapper with
``Put/Get/Del``. Here the surface is an abstract ``KV`` with three backends:

- ``MemoryKV`` — hermetic tests (the seam SURVEY.md §4 calls for),
- ``SqliteKV`` — durable single-host deployments without an etcd cluster,
- ``EtcdKV``  — etcd v3 via its grpc-gateway JSON API (``/v3/kv/*``), keeping
  the reference's deployment shape without a grpc/protobuf dependency.

The port's copy of ``tpu_docker_api/state/kv.py``. Its ``EtcdKV`` speaks
HTTP through the standard library's ``http.client`` where JAX's uses
``requests``: one keep-alive connection per calling thread for the unary
calls, and a dedicated connection per watch stream, cancelled by shutting
its socket down.

All backends add ``range_prefix``/``delete_prefix``, which the reference lacks
and which per-version key layout (state/keys.py) needs, and ``apply`` — an
atomic multi-key put/delete batch (the etcd txn / Kubernetes-apiserver write
pattern) so a version transition is ONE store round trip instead of a
sequence of windows a crash can land between.

``apply`` also takes **guards** — compare preconditions evaluated atomically
with the batch (etcd's native txn compares; sqlite/memory check under the
same txn/lock that applies the ops). A failed guard applies NOTHING and raises the typed
:class:`errors.GuardFailed`. This is the primitive the HA control plane
rides: leader-lease CAS and epoch fencing of a deposed leader's writes are
both one guarded apply.

The read-scaling half is **watch**: every mutation is stamped with a
monotonic revision and emitted as a ``(rev, op, key, value)`` event, so a
standby replica can list once and then tail changes instead of re-reading
the store per request (the client-go informer pattern).
``MemoryKV`` notifies in-process subscribers under the same lock hold that
applies the mutation; ``SqliteKV`` appends to a changelog table INSIDE the
same transaction as the data write (watchers — including ones in other
processes sharing the file — tail it by indexed rev); ``EtcdKV`` rides the
native ``/v3/watch`` stream. ``delete_prefix`` expands to one delete event
per existing key, so a watch-fed cache never needs a relist on the happy
path; a gap (compaction, slow-consumer overflow, canceled stream) surfaces
as the typed :class:`errors.WatchLost`, whose only correct recovery is
relist-then-rewatch.
"""

from __future__ import annotations

import abc
import base64
import bisect
import collections
import contextlib
import http.client
import json
import select
import socket
import sqlite3
import threading
import time
import urllib.parse
from typing import NamedTuple

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.telemetry import trace

#: op kinds KV.apply accepts: ("put", key, value) | ("delete", key) |
#: ("delete_prefix", prefix)
_APPLY_OPS = {"put": 3, "delete": 2, "delete_prefix": 2}

#: events retained for watch replay/buffering on the hermetic backends
#: (MemoryKV global log + per-watch queues; SqliteKV changelog rows). A
#: watcher that falls further behind than this loses the gapless contract
#: and gets a typed WatchLost instead of a silent gap.
WATCH_LOG_RETAIN = 4096


class WatchEvent(NamedTuple):
    """One mutation, as a watcher sees it. ``rev`` is the store's monotonic
    revision: non-decreasing across events, strictly greater than any
    earlier mutation's rev (etcd stamps every key changed by one txn with
    the same rev; memory/sqlite stamp per key). ``op`` is ``"put"`` or
    ``"delete"``; ``value`` is None for deletes. A ``delete_prefix`` is
    always expanded to one event per key that actually existed — deleting
    an absent key emits nothing, matching etcd."""

    rev: int
    op: str
    key: str
    value: str | None


class Watch(abc.ABC):
    """Handle on an event stream from :meth:`KV.watch`. Pull-based so every
    backend (push-notified memory, poll-tailed sqlite, streamed etcd) looks
    identical to the informer loop that consumes it."""

    @abc.abstractmethod
    def poll(self, timeout_s: float = 0.0) -> list[WatchEvent]:
        """Events since the last poll, in rev order; blocks up to
        ``timeout_s`` when none are pending ([] on timeout). Raises
        :class:`errors.WatchLost` when the gapless contract is broken
        (compaction past our rev, buffer overflow, canceled stream) and
        :class:`errors.StoreUnavailable` when the path to the store died —
        both mean relist-then-rewatch."""

    def close(self) -> None:  # noqa: B027
        pass


def _check_guards(guards: list[tuple] | None) -> list[tuple]:
    """Validate guard shapes: ``("value", key, expected)`` with expected a
    str (current value must equal it) or None (key must be absent)."""
    guards = list(guards or [])
    for g in guards:
        if (len(g) != 3 or g[0] != "value" or not isinstance(g[1], str)
                or not (g[2] is None or isinstance(g[2], str))):
            raise ValueError(f"malformed guard {g!r}")
    return guards


def _guard_mismatch(key: str, expected: str | None,
                    actual: str | None) -> "errors.GuardFailed":
    def short(v):
        if v is None:
            return "<absent>"
        return v if len(v) <= 64 else v[:61] + "..."

    return errors.GuardFailed(
        f"guard on {key}: expected {short(expected)}, found {short(actual)}")


class KV(abc.ABC):
    """Minimal KV surface (reference etcd.Put/Get/Del, common.go:45-73)."""

    @abc.abstractmethod
    def put(self, key: str, value: str) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> str:
        """Return the value; raise errors.NotExistInStore if absent."""

    @abc.abstractmethod
    def delete(self, key: str) -> None:
        """Delete the key (no error if absent, matching etcd semantics)."""

    @abc.abstractmethod
    def range_prefix(self, prefix: str) -> dict[str, str]:
        """All key→value pairs whose key starts with ``prefix``, key-sorted."""

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        """Sorted keys under ``prefix`` — no value fetch, no deserialize
        (etcd ``keys_only``, sqlite ``SELECT k``). ``start_after`` is
        exclusive; ``limit`` ≤ 0 means unbounded. The cheap primitive for
        callers that only inspect key names (latest-version derivation,
        marker sweeps): at O(100k) objects, hauling every value over the
        wire to throw it away was pure waste. Base fallback rides
        ``range_prefix`` so wrapper/test KVs keep working; real backends
        override with a values-free scan."""
        ks = [k for k in self.range_prefix(prefix) if k > start_after]
        return ks[:limit] if limit > 0 else ks

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        """One bounded, rev-anchored page: up to ``limit`` key→value pairs
        with key > ``start_after`` under ``prefix`` (key order), plus the
        revision the page reflects. ``at_rev = 0`` serves the current
        state and returns its revision — the first page of a walk;
        ``at_rev > 0`` must serve the SAME snapshot that revision did, or
        raise the typed :class:`errors.ContinueExpired` — so a page
        sequence is a consistent snapshot or a loud 410, never a silent
        dup/skip. etcd serves old revisions natively (MVCC); memory and
        sqlite prove no event touched the prefix since ``at_rev`` via
        their watch logs (a trimmed log ⇒ ContinueExpired, same stance as
        WatchLost). The base fallback (wrapper/test KVs) pages the full
        range and can only anchor to the current revision."""
        if limit <= 0:
            raise ValueError("range_prefix_page requires limit > 0")
        cur = self.current_rev()
        if at_rev > 0 and at_rev != cur:
            raise errors.ContinueExpired(
                f"page anchored at rev {at_rev}, store at {cur}")
        items = {}
        for k, v in self.range_prefix(prefix).items():
            if k <= start_after:
                continue
            items[k] = v
            if len(items) >= limit:
                break
        return items, cur

    def delete_prefix(self, prefix: str) -> None:
        for k in self.range_prefix(prefix):
            self.delete(k)

    def apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        """Atomically apply a batch of ``("put", k, v)`` / ``("delete", k)``
        / ``("delete_prefix", p)`` ops — all land or none do. The two
        ``txn.*`` crash points bracket the commit so the chaos suite can
        prove both halves of the contract: a crash BEFORE the txn leaves
        nothing applied, a crash AFTER leaves everything applied.

        ``guards`` are compare preconditions — ``("value", key, expected)``
        where ``expected`` is the exact current value (str) or None for
        "key must be absent" — evaluated atomically WITH the batch: a
        mismatch applies nothing and raises the typed
        :class:`errors.GuardFailed` (the contention loser's signal; never
        blind-retried at this layer). Subclasses override ``_apply`` with a
        genuinely atomic implementation; the base fallback (check, then
        sequential ops) keeps wrapper/test KVs working but is NOT atomic."""
        guards = _check_guards(guards)
        if not ops and not guards:
            return
        for op in ops:
            want = _APPLY_OPS.get(op[0])
            if want is None or len(op) != want:
                raise ValueError(f"malformed apply op {op!r}")
        from tpu_docker_api_torch.service.crashpoints import crash_point

        # the crash points sit INSIDE the span, so a simulated kill at
        # either txn boundary closes it as status="lost"
        with trace.child("kv.apply", ops=len(ops), guards=len(guards)):
            crash_point("txn.before_apply")
            self._apply(ops, guards)
            crash_point("txn.after_apply")

    def cas(self, key: str, expected: str | None, new: str) -> None:
        """Compare-and-swap convenience: write ``new`` iff the key's current
        value is exactly ``expected`` (None = create-if-absent). Raises
        :class:`errors.GuardFailed` when the compare loses."""
        self.apply([("put", key, new)], guards=[("value", key, expected)])

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        for _, key, expected in guards or []:
            actual = self.get_or(key)
            if actual != expected:
                raise _guard_mismatch(key, expected, actual)
        for op in ops:
            if op[0] == "put":
                self.put(op[1], op[2])
            elif op[0] == "delete":
                self.delete(op[1])
            else:
                self.delete_prefix(op[1])

    def get_or(self, key: str, default: str | None = None) -> str | None:
        try:
            return self.get(key)
        except errors.NotExistInStore:
            return default

    # -- watch ---------------------------------------------------------------

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        """Tail mutations under ``prefix``: events with rev **strictly
        greater than** ``start_rev``, in order, with no gaps. Pair with
        :meth:`range_prefix_with_rev` for the list-then-watch handshake:
        snapshot at rev R, watch from R, and nothing is missed or doubled.
        Backends implement this; plain wrapper KVs delegate."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support watch")

    def current_rev(self) -> int:
        """The store's latest revision (0 = no mutation ever observed).
        Backends with real revision tracking override; the base returns 0
        so simple test doubles keep working (watch from 0 = everything)."""
        return 0

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        """Atomic (snapshot, revision) pair — the list half of the informer
        handshake. The revision is taken with the snapshot (same lock hold
        / read transaction / response header), so ``watch(prefix, rev)``
        delivers exactly the mutations the snapshot does not contain."""
        return self.range_prefix(prefix), self.current_rev()

    def close(self) -> None:  # noqa: B027
        pass


class _MemoryWatch(Watch):
    """Per-subscriber bounded queue. The emitting thread offers events
    under the store lock; poll drains under the watch's own condition (the
    kv-lock → watch-lock order is one-way, so no deadlock)."""

    def __init__(self, kv: "MemoryKV", prefix: str, maxlen: int) -> None:
        self._kv = kv
        self.prefix = prefix
        self._maxlen = maxlen
        self._cv = threading.Condition()
        self._q: collections.deque[WatchEvent] = collections.deque()
        self._lost: str | None = None

    def _offer(self, events: list[WatchEvent]) -> None:
        """Called by the mutator with kv._mu held."""
        with self._cv:
            for ev in events:
                if not ev.key.startswith(self.prefix):
                    continue
                if self._q and len(self._q) >= self._maxlen:
                    # a slow consumer must lose LOUDLY, not drop silently
                    self._lost = (f"watch buffer overflow at "
                                  f"{self._maxlen} events")
                    break
                self._q.append(ev)
            self._cv.notify_all()

    def _mark_lost(self, why: str) -> None:
        with self._cv:
            self._lost = why
            self._cv.notify_all()

    def poll(self, timeout_s: float = 0.0) -> list[WatchEvent]:
        with self._cv:
            if not self._q and self._lost is None and timeout_s > 0:
                self._cv.wait(timeout_s)
            if self._lost is not None:
                raise errors.WatchLost(self._lost)
            out = list(self._q)
            self._q.clear()
            return out

    def close(self) -> None:
        self._kv._unsubscribe(self)


class MemoryKV(KV):
    """In-process dict store for hermetic tests (and the shared-object
    store multi-``Program`` harnesses inject). Every mutation funnels
    through :meth:`_apply`, which stamps revisions and notifies watch
    subscribers under the SAME lock hold that applies the ops — an
    in-process watcher can never observe a gap or a reordering."""

    def __init__(self, log_retain: int = WATCH_LOG_RETAIN) -> None:
        self._d: dict[str, str] = {}
        #: sorted slice of the live keys, maintained incrementally (bisect
        #: insert/remove) so prefix windows and bounded pages are
        #: O(log N + result) instead of a full sort per call — at O(100k)
        #: keys, sorting per list request is what made lists O(N log N)
        self._keys: list[str] = []
        self._mu = threading.Lock()
        self._rev = 0
        self._log_retain = log_retain
        self._log: collections.deque[WatchEvent] = collections.deque()
        self._trimmed_below = 0  # revs <= this are gone from the log
        self._watches: list[_MemoryWatch] = []

    def put(self, key: str, value: str) -> None:
        self._apply([("put", key, value)])

    def get(self, key: str) -> str:
        with self._mu:
            if key not in self._d:
                raise errors.NotExistInStore(key)
            return self._d[key]

    def delete(self, key: str) -> None:
        self._apply([("delete", key)])

    def _window_locked(self, prefix: str, start_after: str = "") -> tuple[int, int]:
        """[lo, hi) indices of self._keys inside ``prefix``, past
        ``start_after`` (exclusive). Caller holds the lock."""
        lo = bisect.bisect_right(self._keys, max(prefix, start_after)) \
            if start_after >= prefix else bisect.bisect_left(self._keys, prefix)
        if not prefix:
            return lo, len(self._keys)
        end = _prefix_end(prefix)
        hi = len(self._keys) if end == "\0" \
            else bisect.bisect_left(self._keys, end)
        return lo, hi

    def range_prefix(self, prefix: str) -> dict[str, str]:
        with self._mu:
            lo, hi = self._window_locked(prefix)
            return {k: self._d[k] for k in self._keys[lo:hi]}

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        with self._mu:
            lo, hi = self._window_locked(prefix, start_after)
            if limit > 0:
                hi = min(hi, lo + limit)
            return self._keys[lo:hi]

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        if limit <= 0:
            raise ValueError("range_prefix_page requires limit > 0")
        with self._mu:
            if at_rev > 0:
                # serve at_rev iff we can PROVE the prefix is untouched
                # since then: every event after at_rev is still in the log
                # (else the proof is gone — same stance as WatchLost) and
                # none of them landed under the prefix
                if at_rev < self._trimmed_below:
                    raise errors.ContinueExpired(
                        f"page anchored at rev {at_rev}, log trimmed "
                        f"through {self._trimmed_below}")
                for ev in self._log:
                    if ev.rev > at_rev and ev.key.startswith(prefix):
                        raise errors.ContinueExpired(
                            f"prefix {prefix!r} mutated at rev {ev.rev} "
                            f"past the page anchor {at_rev}")
            lo, hi = self._window_locked(prefix, start_after)
            hi = min(hi, lo + limit)
            return ({k: self._d[k] for k in self._keys[lo:hi]},
                    at_rev or self._rev)

    def delete_prefix(self, prefix: str) -> None:
        # one lock hold, not one delete per key — the purge paths submit a
        # single op and the backend must honor that shape
        self._apply([("delete_prefix", prefix)])

    def current_rev(self) -> int:
        with self._mu:
            return self._rev

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        with self._mu:
            lo, hi = self._window_locked(prefix)
            return {k: self._d[k] for k in self._keys[lo:hi]}, self._rev

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        w = _MemoryWatch(self, prefix, maxlen=self._log_retain)
        with self._mu:
            if start_rev < self._trimmed_below:
                # replay would have a hole: fail at first poll, like etcd's
                # compacted-revision cancel
                w._mark_lost(f"start rev {start_rev} compacted (log "
                             f"trimmed through rev {self._trimmed_below})")
            else:
                w._offer([ev for ev in self._log if ev.rev > start_rev])
            self._watches.append(w)
        return w

    def _unsubscribe(self, w: _MemoryWatch) -> None:
        with self._mu:
            if w in self._watches:
                self._watches.remove(w)

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        with self._mu:
            # guards evaluate under the SAME lock hold that applies the ops:
            # no other writer can slip between the compare and the commit
            for _, key, expected in guards or []:
                actual = self._d.get(key)
                if actual != expected:
                    raise _guard_mismatch(key, expected, actual)
            events: list[WatchEvent] = []

            def emit(op: str, key: str, value: str | None) -> None:
                self._rev += 1
                events.append(WatchEvent(self._rev, op, key, value))

            for op in ops:
                if op[0] == "put":
                    if op[1] not in self._d:
                        bisect.insort(self._keys, op[1])
                    self._d[op[1]] = op[2]
                    emit("put", op[1], op[2])
                elif op[0] == "delete":
                    if self._d.pop(op[1], None) is not None:
                        self._keys.pop(bisect.bisect_left(self._keys, op[1]))
                        emit("delete", op[1], None)
                else:
                    lo, hi = self._window_locked(op[1])
                    for k in self._keys[lo:hi]:
                        del self._d[k]
                        emit("delete", k, None)
                    del self._keys[lo:hi]
            for ev in events:
                if len(self._log) >= self._log_retain:
                    self._trimmed_below = self._log.popleft().rev
                self._log.append(ev)
            for w in self._watches:
                w._offer(events)


class _SqliteWatch(Watch):
    """Tail of the ``kv_log`` changelog table by indexed rev. Works across
    PROCESSES: any SqliteKV instance over the same file sees rows the
    moment the writer's transaction commits (this is what makes two real
    daemons over shared sqlite — the HA verification setup — watchable).
    Poll is a bounded-cadence scan; staleness is one poll interval."""

    SCAN_SLEEP_S = 0.02

    def __init__(self, kv: "SqliteKV", prefix: str, start_rev: int) -> None:
        self._kv = kv
        self.prefix = prefix
        self._last_rev = start_rev

    def poll(self, timeout_s: float = 0.0) -> list[WatchEvent]:
        deadline = time.monotonic() + timeout_s
        while True:
            events, scanned = self._kv._read_log_since(
                self._last_rev, self.prefix)
            # advance past non-matching rows too, or every poll re-scans them
            self._last_rev = max(self._last_rev, scanned)
            if events:
                return events
            if time.monotonic() >= deadline:
                return []
            time.sleep(min(self.SCAN_SLEEP_S,
                           max(deadline - time.monotonic(), 0.001)))


class SqliteKV(KV):
    """Durable store on sqlite (WAL). One data table, one changelog table,
    synchronous writes.

    Unlike the reference — which flushes scheduler/version state only on
    graceful Stop (SURVEY.md §3.1) — every ``put`` here commits, so a hard
    crash loses nothing. A busy timeout bounds lock waits: a foreign
    process holding the database (backup tooling, a second daemon by
    mistake) makes ops block up to ``busy_timeout_s`` and then fail,
    instead of raising ``database is locked`` instantly or hanging.

    Every mutation routes through :meth:`_apply`, which appends one
    ``kv_log`` row per changed key INSIDE the same transaction as the data
    write: a committed mutation and its watch event are indivisible (a
    crash can never persist one without the other), and the AUTOINCREMENT
    rev is monotonic across every process sharing the file. The log is
    trimmed to ``log_retain`` rows (watermark in ``kv_meta``); a watcher
    behind the watermark gets a typed WatchLost.
    """

    BUSY_TIMEOUT_S = 5.0
    TRIM_EVERY = 64

    def __init__(self, path: str, busy_timeout_s: float = BUSY_TIMEOUT_S,
                 log_retain: int = WATCH_LOG_RETAIN,
                 trim_every: int = TRIM_EVERY) -> None:
        self._conn = sqlite3.connect(
            path, timeout=busy_timeout_s, check_same_thread=False
        )
        self._busy_timeout_s = busy_timeout_s
        self._mu = threading.Lock()
        self._log_retain = log_retain
        self._trim_every = max(1, trim_every)
        self._applies_since_trim = 0
        with self._mu:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_s * 1000)}")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT NOT NULL)"
            )
            # AUTOINCREMENT (not bare rowid): revs must never be reused
            # after a trim, or a watcher could silently resume across a gap
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv_log ("
                "rev INTEGER PRIMARY KEY AUTOINCREMENT, "
                "op TEXT NOT NULL, k TEXT NOT NULL, v TEXT)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv_meta (k TEXT PRIMARY KEY, "
                "v TEXT NOT NULL)"
            )
            self._conn.execute(
                "INSERT OR IGNORE INTO kv_meta(k, v) VALUES('trim_rev', '0')"
            )
            self._conn.commit()

    @contextlib.contextmanager
    def _busy_guard(self):
        """Normalize a busy/locked exhaustion (a foreign writer held the
        database past ``busy_timeout_s``) to the typed
        :class:`errors.StoreUnavailable` — the sqlite analog of EtcdKV's
        connection-class normalization, so callers classify store-path
        failures with ONE except clause instead of matching sqlite3
        internals. Other OperationalErrors (corruption, disk I/O) still
        surface raw: they are not an availability condition."""
        try:
            yield
        except sqlite3.OperationalError as e:
            msg = str(e).lower()
            if "locked" in msg or "busy" in msg:
                raise errors.StoreUnavailable(
                    f"sqlite busy past the {self._busy_timeout_s}s bounded "
                    f"wait: {e}") from e
            raise

    def put(self, key: str, value: str) -> None:
        self._apply([("put", key, value)])

    def get(self, key: str) -> str:
        with self._busy_guard(), self._mu:
            row = self._conn.execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        if row is None:
            raise errors.NotExistInStore(key)
        return row[0]

    def delete(self, key: str) -> None:
        self._apply([("delete", key)])

    @staticmethod
    def _prefix_where(prefix: str) -> tuple[str, tuple]:
        """One index-friendly range predicate (``k >= prefix AND k <
        end``) selecting exactly the prefix's subtree — the per-key GLOB
        scan this replaces walked the whole table. Falls back to GLOB for
        prefixes whose incremented end is not valid TEXT (raw-0xff keys —
        an etcd-wire artifact sqlite deployments never store)."""
        if not prefix:
            return "1=1", ()
        end = _prefix_end(prefix)
        try:
            end.encode()
        except UnicodeEncodeError:  # pragma: no cover — non-TEXT end
            return "k GLOB ?", (prefix.replace("[", "[[]") + "*",)
        if end == "\0":  # all-0xff prefix: no upper bound
            return "k >= ?", (prefix,)
        return "k >= ? AND k < ?", (prefix, end)

    def range_prefix(self, prefix: str) -> dict[str, str]:
        where, params = self._prefix_where(prefix)
        with self._busy_guard(), self._mu:
            rows = self._conn.execute(
                f"SELECT k, v FROM kv WHERE {where} ORDER BY k", params,
            ).fetchall()
        return dict(rows)

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        """Keys only — never deserializes a value row (``SELECT k`` rides
        the primary-key index end to end)."""
        where, params = self._prefix_where(prefix)
        if start_after:
            where += " AND k > ?"
            params = params + (start_after,)
        sql = f"SELECT k FROM kv WHERE {where} ORDER BY k"
        if limit > 0:
            sql += " LIMIT ?"
            params = params + (limit,)
        with self._busy_guard(), self._mu:
            rows = self._conn.execute(sql, params).fetchall()
        return [k for (k,) in rows]

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        """One bounded SELECT (``k > ? AND k < ? ORDER BY k LIMIT ?``)
        inside one read transaction with the rev-anchor proof: the page is
        served at ``at_rev`` only if the changelog still covers every
        event past it AND none of those events touched the prefix — the
        same one-WAL-snapshot discipline as ``_read_log_since``."""
        if limit <= 0:
            raise ValueError("range_prefix_page requires limit > 0")
        where, params = self._prefix_where(prefix)
        page_where, page_params = where, params
        if start_after:
            page_where += " AND k > ?"
            page_params = page_params + (start_after,)
        with self._busy_guard(), self._mu:
            try:
                self._conn.execute("BEGIN")
                if at_rev > 0:
                    trim_rev = int(self._conn.execute(
                        "SELECT v FROM kv_meta WHERE k = 'trim_rev'"
                    ).fetchone()[0])
                    if at_rev < trim_rev:
                        raise errors.ContinueExpired(
                            f"page anchored at rev {at_rev}, changelog "
                            f"trimmed through {trim_rev}")
                    touched = self._conn.execute(
                        f"SELECT rev FROM kv_log WHERE rev > ? AND {where} "
                        f"LIMIT 1", (at_rev,) + params).fetchone()
                    if touched is not None:
                        raise errors.ContinueExpired(
                            f"prefix {prefix!r} mutated at rev {touched[0]} "
                            f"past the page anchor {at_rev}")
                rows = self._conn.execute(
                    f"SELECT k, v FROM kv WHERE {page_where} ORDER BY k "
                    f"LIMIT ?", page_params + (limit,)).fetchall()
                rev = at_rev or self._current_rev_locked()
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise
        return dict(rows), rev

    def delete_prefix(self, prefix: str) -> None:
        """One transaction: a single bounded DELETE statement for the data
        rows (a purge of an N-key family is not N round trips) plus the
        per-key changelog expansion, so a crash mid-purge can never leave
        half a family behind — or a family gone but unobservable."""
        self._apply([("delete_prefix", prefix)])

    def current_rev(self) -> int:
        with self._busy_guard(), self._mu:
            return self._current_rev_locked()

    def _current_rev_locked(self) -> int:
        # sqlite_sequence survives log trims; MAX(rev) alone would regress
        # after a full trim of a quiet store
        row = self._conn.execute(
            "SELECT seq FROM sqlite_sequence WHERE name = 'kv_log'"
        ).fetchone()
        return int(row[0]) if row else 0

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        where, params = self._prefix_where(prefix)
        with self._busy_guard(), self._mu:
            try:
                # explicit txn: the snapshot and its rev are one consistent
                # read even with a foreign process writing concurrently
                self._conn.execute("BEGIN")
                rows = self._conn.execute(
                    f"SELECT k, v FROM kv WHERE {where} ORDER BY k", params,
                ).fetchall()
                rev = self._current_rev_locked()
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise
        return dict(rows), rev

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        return _SqliteWatch(self, prefix, start_rev)

    def _read_log_since(self, last_rev: int,
                        prefix: str) -> tuple[list[WatchEvent], int]:
        """(matching events with rev > last_rev, highest rev scanned).
        Raises WatchLost when the trim watermark passed last_rev — the
        changelog no longer proves there is no gap. Watermark and rows are
        read in ONE explicit transaction (one WAL snapshot): two
        autocommit statements would let a FOREIGN process's trim land
        between them, passing the staleness check against the old
        watermark while the row scan already reflects the post-trim log —
        a silent, permanently undetected gap."""
        with self._busy_guard(), self._mu:
            try:
                self._conn.execute("BEGIN")
                trim_rev = int(self._conn.execute(
                    "SELECT v FROM kv_meta WHERE k = 'trim_rev'"
                ).fetchone()[0])
                rows = self._conn.execute(
                    "SELECT rev, op, k, v FROM kv_log WHERE rev > ? "
                    "ORDER BY rev LIMIT 1000", (last_rev,),
                ).fetchall()
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise
        if last_rev < trim_rev:
            raise errors.WatchLost(
                f"changelog compacted to rev {trim_rev}, watcher at "
                f"{last_rev}")
        events = [WatchEvent(int(r), op, k, v) for r, op, k, v in rows
                  if k.startswith(prefix)]
        scanned = int(rows[-1][0]) if rows else last_rev
        return events, scanned

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        """All ops — data rows AND their changelog rows — in ONE sqlite
        transaction: a mid-batch failure (or a crash before the commit)
        rolls everything back, so a mutation and its watch event are
        indivisible. Guards SELECT and compare inside that transaction —
        BEGIN IMMEDIATE takes the write lock up front, so even a foreign
        process (second daemon, backup tooling) cannot change a guarded
        key between the compare and the commit."""
        with self._busy_guard(), self._mu:
            try:
                self._conn.execute("BEGIN IMMEDIATE")
                for _, key, expected in guards or []:
                    row = self._conn.execute(
                        "SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
                    actual = None if row is None else row[0]
                    if actual != expected:
                        raise _guard_mismatch(key, expected, actual)
                log_rows: list[tuple[str, str, str | None]] = []
                for op in ops:
                    if op[0] == "put":
                        self._conn.execute(
                            "INSERT INTO kv(k, v) VALUES(?, ?) "
                            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                            (op[1], op[2]),
                        )
                        log_rows.append(("put", op[1], op[2]))
                    elif op[0] == "delete":
                        cur = self._conn.execute(
                            "DELETE FROM kv WHERE k = ?", (op[1],))
                        if cur.rowcount > 0:
                            log_rows.append(("delete", op[1], None))
                    else:
                        where, params = self._prefix_where(op[1])
                        doomed = self._conn.execute(
                            f"SELECT k FROM kv WHERE {where} ORDER BY k",
                            params).fetchall()
                        self._conn.execute(
                            f"DELETE FROM kv WHERE {where}", params)
                        log_rows.extend(("delete", k, None) for (k,) in doomed)
                self._conn.executemany(
                    "INSERT INTO kv_log(op, k, v) VALUES(?, ?, ?)", log_rows)
                self._applies_since_trim += 1
                if self._applies_since_trim >= self._trim_every:
                    self._applies_since_trim = 0
                    self._trim_log_locked()
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise

    def _trim_log_locked(self) -> None:
        """Bound the changelog (inside the caller's transaction): drop rows
        below ``max_rev - log_retain`` and advance the watermark watchers
        compare against."""
        max_rev = self._current_rev_locked()
        floor = max_rev - self._log_retain
        if floor <= 0:
            return
        self._conn.execute("DELETE FROM kv_log WHERE rev <= ?", (floor,))
        self._conn.execute(
            "UPDATE kv_meta SET v = ? WHERE k = 'trim_rev' "
            "AND CAST(v AS INTEGER) < ?", (str(floor), floor))

    def close(self) -> None:
        with self._mu:
            self._conn.close()


class EtcdHTTPError(Exception):
    """The gateway answered with a non-2xx status: the store is reachable
    (not an outage), the request was refused. ``status`` and the decoded
    ``error`` field of the grpc-gateway's JSON body ride along."""

    def __init__(self, status: int, body: bytes) -> None:
        try:
            detail = json.loads(body).get("error", "")
        except (ValueError, AttributeError):
            detail = body[:200].decode("utf-8", "replace")
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


#: what a dead, hung or restarting gateway raises on a connection: refused,
#: reset, timed out, or a reply cut off mid-way
_CONN_ERRORS = (OSError, http.client.HTTPException)


class EtcdKV(KV):
    """etcd v3 over its grpc-gateway JSON API.

    The reference dials etcd gRPC with a 2 s blocking connect and 1 s per-op
    timeout (etcd/client.go:14-23, common.go:31); we keep the same budgets on
    HTTP. Keys/values are base64 on the wire per the gateway contract.

    Store-outage tolerance (docs/robustness.md "Durable work queue"): every
    connection-class failure (refused/reset/timeout) is normalized to
    :class:`errors.StoreUnavailable` — the KV analog of the host layer's
    ``HostUnreachable`` — so callers classify store-path failures with one
    except clause. Idempotent READS (``get``/``range_prefix``) additionally
    retry up to ``retry_attempts`` times with capped exponential backoff
    before giving up; writes are normalized but never retried here (the
    work queue owns write retry policy, and a blind double-put hides real
    outages).

    Connections: a shared pool of idle keep-alive ``http.client``
    connections, at most ``POOL_SIZE`` of them (the counterpart of a
    ``requests.Session``'s pool). Each request checks one out, or dials a
    new one when none is idle, and hands it back when its reply has been
    read; a connection handed back to a full pool is closed. So the open
    sockets are the busy ones plus at most ``POOL_SIZE`` idle, however many
    threads have come and gone. An idle connection is checked for a peer
    close before reuse (a request is never sent down a socket the gateway
    already closed); any connection-class failure drops it, so the next
    attempt dials anew.
    """

    DIAL_TIMEOUT_S = 2.0
    OP_TIMEOUT_S = 1.0
    RETRY_ATTEMPTS = 3
    RETRY_BASE_S = 0.05
    RETRY_MAX_S = 1.0
    POOL_SIZE = 10  # urllib3's default pool_maxsize, as a Session uses

    def __init__(self, addr: str, retry_attempts: int = RETRY_ATTEMPTS,
                 retry_base_s: float = RETRY_BASE_S,
                 retry_max_s: float = RETRY_MAX_S,
                 op_deadline_s: float = 0.0) -> None:
        self._addr = addr.rstrip("/")
        url = urllib.parse.urlsplit(self._addr)
        if url.scheme not in ("http", "https") or not url.hostname:
            raise ValueError(f"etcd address {addr!r}: want http(s)://host:port")
        self._conn_cls = (http.client.HTTPSConnection if url.scheme == "https"
                          else http.client.HTTPConnection)
        self._host, self._port = url.hostname, url.port
        self._path = url.path
        #: idle connections, newest last; every open one, busy or idle, is
        #: in ``_conns`` so close() reaches those other threads hold
        self._idle: list = []
        self._conns: set = set()
        self._conns_mu = threading.Lock()
        self._closed = False
        self._retry_attempts = max(1, retry_attempts)
        self._retry_base_s = retry_base_s
        self._retry_max_s = retry_max_s
        # per-op deadline (config store_op_deadline_s): the socket timeout
        # every request rides, so a hung store surfaces as a typed
        # StoreUnavailable in bounded time instead of wedging an API
        # thread that holds a family lock. <= 0 keeps the reference's 1 s
        # OP_TIMEOUT_S
        self._op_timeout_s = op_deadline_s if op_deadline_s > 0 else self.OP_TIMEOUT_S
        # fail fast if unreachable, like the reference's blocking dial
        # (no retry: a daemon pointed at a dead store must error at boot,
        # not spin through a backoff schedule before reporting it)
        self._post("/v3/kv/range", {"key": _b64("probe"), "limit": 1},
                   timeout=self.DIAL_TIMEOUT_S)

    def _checkout(self, timeout: float):
        """An idle connection, or a new one, its socket timeout set to
        ``timeout``. An idle socket that reads as ready has been closed
        (or written to) by the peer: it is dropped, not reused."""
        while True:
            with self._conns_mu:
                conn = self._idle.pop() if self._idle else None
            if conn is None:
                conn = self._conn_cls(self._host, self._port, timeout=timeout)
                with self._conns_mu:
                    self._conns.add(conn)
                break
            try:
                ready, _, _ = select.select([conn.sock], [], [], 0)
            except (OSError, ValueError, TypeError):
                ready = [conn.sock]
            if not ready:
                break
            self._drop(conn)
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def _checkin(self, conn) -> None:
        """Hand a connection whose reply was read in full back to the pool,
        or close it when the pool is full or the store closed."""
        with self._conns_mu:
            if (not self._closed and conn in self._conns
                    and len(self._idle) < self.POOL_SIZE):
                self._idle.append(conn)
                return
        self._drop(conn)

    def _drop(self, conn) -> None:
        conn.close()
        with self._conns_mu:
            self._conns.discard(conn)

    def _post(self, path: str, body: dict, timeout: float | None = None,
              idempotent: bool = False) -> dict:
        from tpu_docker_api_torch.utils.backoff import backoff_delay_s

        attempts = self._retry_attempts if idempotent else 1
        data = json.dumps(body).encode()
        last: Exception | None = None
        for attempt in range(attempts):
            conn = self._checkout(timeout or self._op_timeout_s)
            try:
                conn.request("POST", self._path + path, body=data,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                raw = resp.read()
            except _CONN_ERRORS as e:
                self._drop(conn)
                last = e
                if attempt + 1 < attempts:
                    time.sleep(backoff_delay_s(
                        attempt, self._retry_base_s, self._retry_max_s))
                continue
            except BaseException:
                self._drop(conn)
                raise
            if resp.will_close:
                self._drop(conn)
            else:
                self._checkin(conn)
            if not 200 <= resp.status < 300:
                raise EtcdHTTPError(resp.status, raw)
            return json.loads(raw)
        raise errors.StoreUnavailable(
            f"etcd {self._addr}{path}: {type(last).__name__}: {last}"
        ) from last

    def put(self, key: str, value: str) -> None:
        self._post("/v3/kv/put", {"key": _b64(key), "value": _b64(value)})

    def get(self, key: str) -> str:
        resp = self._post("/v3/kv/range", {"key": _b64(key)}, idempotent=True)
        kvs = resp.get("kvs", [])
        if not kvs:
            raise errors.NotExistInStore(key)
        return _unb64(kvs[0]["value"])

    def delete(self, key: str) -> None:
        self._post("/v3/kv/deleterange", {"key": _b64(key)})

    def range_prefix(self, prefix: str) -> dict[str, str]:
        resp = self._post(
            "/v3/kv/range",
            {"key": _b64(prefix), "range_end": _b64(_prefix_end(prefix))},
            idempotent=True,
        )
        out = {_unb64_key(kv["key"]): _unb64(kv["value"])
               for kv in resp.get("kvs", [])}
        return dict(sorted(out.items()))

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        """Native ``keys_only`` range: the server never ships a value byte."""
        body = {"key": _b64(max(prefix, start_after + "\0")),
                "range_end": _b64(_prefix_end(prefix)), "keys_only": True}
        if limit > 0:
            body["limit"] = str(limit)
        resp = self._post("/v3/kv/range", body, idempotent=True)
        return sorted(_unb64_key(kv["key"]) for kv in resp.get("kvs", []))

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        """Native MVCC page: ``limit`` + ``key`` (start_after + one NUL =
        the smallest strictly-greater key) + ``revision`` on
        ``/v3/kv/range``, so etcd itself serves every page of a walk at
        the first page's revision. A compacted revision comes back as the
        gateway's 400 ``...required revision has been compacted`` —
        mapped to the typed ContinueExpired, exactly like Kubernetes'
        410 Gone."""
        if limit <= 0:
            raise ValueError("range_prefix_page requires limit > 0")
        body = {"key": _b64(max(prefix, start_after + "\0")),
                "range_end": _b64(_prefix_end(prefix)),
                "limit": str(limit)}
        if at_rev > 0:
            body["revision"] = str(at_rev)
        try:
            resp = self._post("/v3/kv/range", body, idempotent=True)
        except EtcdHTTPError as e:
            if "compacted" in e.detail:
                raise errors.ContinueExpired(
                    f"revision {at_rev} compacted: {e.detail}") from e
            raise
        out = {_unb64_key(kv["key"]): _unb64(kv["value"])
               for kv in resp.get("kvs", [])}
        return (dict(sorted(out.items())),
                at_rev or int(resp.get("header", {}).get("revision", 0)))

    def current_rev(self) -> int:
        resp = self._post("/v3/kv/range", {"key": _b64("\0"), "limit": 1},
                          idempotent=True)
        return int(resp.get("header", {}).get("revision", 0))

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        """One range call: the response header's revision IS the snapshot's
        revision (etcd's own list-then-watch handshake)."""
        resp = self._post(
            "/v3/kv/range",
            {"key": _b64(prefix), "range_end": _b64(_prefix_end(prefix))},
            idempotent=True,
        )
        out = {_unb64_key(kv["key"]): _unb64(kv["value"])
               for kv in resp.get("kvs", [])}
        return dict(sorted(out.items())), int(
            resp.get("header", {}).get("revision", 0))

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        """Native ``/v3/watch`` stream on the gateway: the server pushes
        events (deletes already expanded per key by etcd itself); a
        compacted start revision comes back as a cancel response carrying
        ``compact_revision``, surfaced as the typed WatchLost."""
        return _EtcdWatch(self, prefix, start_rev)

    def delete_prefix(self, prefix: str) -> None:
        self._post(
            "/v3/kv/deleterange",
            {"key": _b64(prefix), "range_end": _b64(_prefix_end(prefix))},
        )

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        """Native etcd transaction (``/v3/kv/txn``): guards map to the txn's
        ``compare`` list — a value guard is a VALUE compare, an absence
        guard (expected None) is ``VERSION == 0``, etcd's "key was never
        put" sentinel — so the compare-and-commit is ONE server-side atomic
        round trip, with no failure branch (a lost compare changes
        nothing). A txn is a WRITE, so it rides the normalize-but-never-
        retry path — a blind re-apply after an ambiguous timeout could
        double-commit a batch whose first attempt landed
        (``idempotent=False`` is load-bearing, not a default)."""
        compare = []
        for _, key, expected in guards or []:
            if expected is None:
                compare.append({"key": _b64(key), "result": "EQUAL",
                                "target": "VERSION", "version": "0"})
            else:
                compare.append({"key": _b64(key), "result": "EQUAL",
                                "target": "VALUE", "value": _b64(expected)})
        success = []
        for op in ops:
            if op[0] == "put":
                success.append({"requestPut": {
                    "key": _b64(op[1]), "value": _b64(op[2])}})
            elif op[0] == "delete":
                success.append({"requestDeleteRange": {"key": _b64(op[1])}})
            else:
                success.append({"requestDeleteRange": {
                    "key": _b64(op[1]),
                    "range_end": _b64(_prefix_end(op[1]))}})
        body: dict = {"success": success}
        if compare:
            body["compare"] = compare
        resp = self._post("/v3/kv/txn", body, idempotent=False)
        # proto3 JSON omits false booleans: an absent ``succeeded`` on a
        # guarded txn IS the failed compare
        if compare and not resp.get("succeeded"):
            raise errors.GuardFailed(
                f"etcd txn compare failed on "
                f"{[g[1] for g in guards or []]}")

    def close(self) -> None:
        with self._conns_mu:
            self._closed = True
            conns, self._conns, self._idle = self._conns, set(), []
        for conn in conns:
            conn.close()


class _EtcdWatch(Watch):
    """One ``/v3/watch`` stream on a connection of its own. A dedicated
    reader thread blocks on the chunked HTTP response and feeds a queue;
    poll drains it — the informer loop never blocks on a socket it cannot
    time-bound. The stream dying (connection reset, gateway restart) is a
    StoreUnavailable at the next poll; a cancel/compaction response is a
    WatchLost. Either way the consumer relists. ``close`` shuts the socket
    down: the reader's blocked read returns at once, and the reader, which
    owns the response, closes it."""

    def __init__(self, kv: "EtcdKV", prefix: str, start_rev: int) -> None:
        self.prefix = prefix
        self._cv = threading.Condition()
        self._q: collections.deque[WatchEvent] = collections.deque()
        self._error: Exception | None = None
        self._closed = False
        body = {"create_request": {
            "key": _b64(prefix),
            "range_end": _b64(_prefix_end(prefix)),
            # etcd's start_revision is INCLUSIVE; our contract is
            # "events with rev > start_rev"
            "start_revision": str(start_rev + 1),
        }}
        # the dial and the reply's head ride the dial budget; the stream
        # itself then blocks without a deadline, like the reference's
        # (connect, read) = (2 s, none) watch call
        self._conn = kv._conn_cls(kv._host, kv._port,
                                  timeout=kv.DIAL_TIMEOUT_S)
        try:
            self._conn.connect()
            # held apart from the connection: http.client drops its own
            # reference once the response owns the stream
            self._sock = self._conn.sock
            self._conn.request("POST", kv._path + "/v3/watch",
                               body=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
            self._resp = self._conn.getresponse()
            if not 200 <= self._resp.status < 300:
                raise EtcdHTTPError(self._resp.status, self._resp.read())
            self._sock.settimeout(None)
        except (*_CONN_ERRORS, EtcdHTTPError) as e:
            self._conn.close()
            raise errors.StoreUnavailable(
                f"etcd watch {kv._addr}: {type(e).__name__}: {e}") from e
        self._thread = threading.Thread(
            target=self._read_loop, name="etcd-watch", daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        try:
            self._read_stream()
        finally:
            # the reader OWNS the response: closing it from another thread
            # would contend for the buffered reader this thread holds while
            # blocked mid-read (close() unblocks us by shutting the socket
            # down instead)
            for res in (self._resp, self._conn):
                try:
                    res.close()
                except Exception:  # noqa: BLE001
                    pass

    def _read_stream(self) -> None:
        try:
            while True:
                line = self._resp.readline()
                if not line:
                    # http.client's chunked readline reads a stream cut off
                    # mid-way as a plain end: a watch the server ended
                    # without a cancel is dead either way
                    raise ConnectionError("the watch stream ended")
                line = line.strip()
                if not line:
                    continue
                result = json.loads(line).get("result", {})
                if result.get("compact_revision") or result.get("canceled"):
                    self._fail(errors.WatchLost(
                        f"watch canceled (compacted at "
                        f"{result.get('compact_revision')})"))
                    return
                if result.get("created"):
                    continue
                header_rev = int(result.get("header", {}).get("revision", 0))
                events = []
                for ev in result.get("events", []):
                    kv_ = ev.get("kv", {})
                    # proto3 JSON omits default enum values: no "type" IS PUT
                    is_put = ev.get("type", "PUT") == "PUT"
                    events.append(WatchEvent(
                        int(kv_.get("mod_revision", header_rev)),
                        "put" if is_put else "delete",
                        _unb64_key(kv_["key"]),
                        _unb64(kv_.get("value", "")) if is_put else None))
                if events:
                    with self._cv:
                        self._q.extend(events)
                        self._cv.notify_all()
        except Exception as e:  # noqa: BLE001 — stream death
            if not self._closed:
                self._fail(errors.StoreUnavailable(
                    f"etcd watch stream died: {type(e).__name__}: {e}"))

    def _fail(self, err: Exception) -> None:
        with self._cv:
            self._error = err
            self._cv.notify_all()

    def poll(self, timeout_s: float = 0.0) -> list[WatchEvent]:
        with self._cv:
            if not self._q and self._error is None and not self._closed \
                    and timeout_s > 0:
                self._cv.wait(timeout_s)
            if self._q:
                out = list(self._q)
                self._q.clear()
                return out
            if self._error is not None and not self._closed:
                raise self._error
            return []

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already dead is fine
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=5)


class CountingKV(KV):
    """Instrumentation wrapper: counts store round trips per KV method.

    The churn benchmark (bench.py ``--cp-family churn``) wraps the daemon's
    store in one of these to report **round trips per control-plane flow**
    — the regression gate that keeps "batched" an invariant instead of an
    adjective. Each counted unit is one network round trip on etcd: an
    ``apply`` of 40 ops counts once, which is the whole point."""

    def __init__(self, inner: KV) -> None:
        self.inner = inner
        self._mu = threading.Lock()
        self.counts: dict[str, int] = {}

    def _count(self, method: str) -> None:
        with self._mu:
            self.counts[method] = self.counts.get(method, 0) + 1

    def snapshot(self) -> dict[str, int]:
        with self._mu:
            return dict(self.counts)

    @staticmethod
    def delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
        """Per-method round trips between two snapshots (zeroes dropped)."""
        out = {k: after[k] - before.get(k, 0) for k in after}
        return {k: v for k, v in out.items() if v}

    def put(self, key: str, value: str) -> None:
        self._count("put")
        self.inner.put(key, value)

    def get(self, key: str) -> str:
        self._count("get")
        return self.inner.get(key)

    def delete(self, key: str) -> None:
        self._count("delete")
        self.inner.delete(key)

    def range_prefix(self, prefix: str) -> dict[str, str]:
        self._count("range_prefix")
        return self.inner.range_prefix(prefix)

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        self._count("range_prefix")
        return self.inner.range_prefix_with_rev(prefix)

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        self._count("keys_prefix")
        return self.inner.keys_prefix(prefix, limit=limit,
                                      start_after=start_after)

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        self._count("range_prefix_page")
        return self.inner.range_prefix_page(prefix, limit,
                                            start_after=start_after,
                                            at_rev=at_rev)

    READ_METHODS = ("get", "range_prefix", "keys_prefix",
                    "range_prefix_page")

    def reads(self) -> int:
        """Total store read round trips so far (the scale family's gated
        quantity; watch streams are amortized and deliberately excluded)."""
        with self._mu:
            return sum(self.counts.get(m, 0) for m in self.READ_METHODS)

    def current_rev(self) -> int:
        return self.inner.current_rev()

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        # counted once per stream OPEN — the whole point of watch is that
        # the events themselves are not per-request round trips
        self._count("watch")
        return self.inner.watch(prefix, start_rev)

    def delete_prefix(self, prefix: str) -> None:
        self._count("delete_prefix")
        self.inner.delete_prefix(prefix)

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        # delegate to the inner BACKEND's atomic _apply (not its public
        # apply: the base template already validated and fired the crash
        # points once — they must not fire twice per batch)
        self._count("apply")
        self.inner._apply(ops, guards)

    def close(self) -> None:
        self.inner.close()


def _b64(s: str) -> str:
    # surrogateescape: _prefix_end may produce lone surrogates for non-ascii
    # prefix ends; they round-trip to the intended raw bytes on the wire
    # (identical to strict encoding for any valid-unicode input)
    return base64.b64encode(s.encode("utf-8", "surrogateescape")).decode()


def _unb64_key(s: str) -> str:
    """Keys decode leniently: an incremented range-end byte can make a key
    non-UTF-8, and it must round-trip back through ``_b64``."""
    return base64.b64decode(s).decode("utf-8", "surrogateescape")


def _unb64(s: str) -> str:
    """Values decode strictly: this store only ever writes UTF-8 (JSON), so
    a non-UTF-8 value is corruption by a foreign writer and must fail loudly
    at the read site, not surface as lone surrogates downstream."""
    return base64.b64decode(s).decode()




def _prefix_end(prefix: str) -> str:
    """etcd range_end for a prefix scan: prefix with last byte incremented.
    Operates on the key's raw utf-8 bytes (etcd compares bytes); raw bytes
    that aren't valid utf-8 ride in/out as surrogateescape characters."""
    b = bytearray(prefix.encode("utf-8", "surrogateescape"))
    for i in reversed(range(len(b))):
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[: i + 1]).decode(errors="surrogateescape")
        b.pop()
    return "\0"  # prefix was all 0xff: scan everything


def open_store(backend: str, *, etcd_addr: str = "", sqlite_path: str = "",
               retry_attempts: int = EtcdKV.RETRY_ATTEMPTS,
               retry_base_s: float = EtcdKV.RETRY_BASE_S,
               retry_max_s: float = EtcdKV.RETRY_MAX_S,
               op_deadline_s: float = 0.0) -> KV:
    """Open a KV backend by name (config.store_backend); ``retry_*`` maps
    from the ``store_retry_*`` config keys (etcd idempotent-read retry).
    ``op_deadline_s`` (config ``store_op_deadline_s``) bounds every op: the
    etcd socket timeout and the sqlite busy wait. <= 0 keeps each backend's
    historical budget (1 s etcd ops, 5 s sqlite busy)."""
    if backend == "memory":
        return MemoryKV()
    if backend == "sqlite":
        return SqliteKV(sqlite_path,
                        busy_timeout_s=(op_deadline_s if op_deadline_s > 0
                                        else SqliteKV.BUSY_TIMEOUT_S))
    if backend == "etcd":
        return EtcdKV(etcd_addr, retry_attempts=retry_attempts,
                      retry_base_s=retry_base_s, retry_max_s=retry_max_s,
                      op_deadline_s=op_deadline_s)
    raise ValueError(f"unknown store backend {backend!r}")
