"""Durable async reconciliation work queue.

Parity: reference ``internal/workQueue/workQueue.go`` — a buffered channel
(cap 110) drained by ``SyncLoop`` which type-switches on task kind. Earlier
fixes (SURVEY.md §5.3): bounded retry with backoff instead of infinite
re-enqueue, a dead-letter list instead of silent poison-pill spin, ordered
quiesce→copy→start chains. This revision closes the queue's last gap — the
reference's channel (and our port of it) was pure process memory, so a
daemon crash lost every queued persist, data copy and compensation:

- **declarative task records** (:class:`TaskRecord`: kind + JSON params)
  replace closure-bearing tasks at every service submit site; kinds resolve
  at execution time through a registry the services bind their context into
  (:meth:`WorkQueue.register`), so a record written by a dead daemon is
  executable by the next one;
- **a crash-safe journal** under ``keys.QUEUE_TASKS_PREFIX``: every record
  is journaled at submit (state ``pending``), claimed by the sync loop
  (``inflight``), and acked on success (key deleted = ``done``) or marked
  ``dead`` after the bounded retries. Three labeled crash points —
  ``queue.claim`` / ``queue.exec`` / ``queue.ack`` — cover the lifecycle
  boundaries for the chaos harness;
- **replay-on-restart**: :meth:`replay_journal` (driven by the reconciler)
  re-executes pending/in-flight records exactly once in submit order.
  Non-idempotent steps (data copies) prove completion via per-task
  **markers** (``keys.queue_marker_key``) written *before* the follow-up
  start, so a replayed copy never re-clobbers a started container;
- **durable dead letters**: exhausted records stay in the journal with
  ``state="dead"`` and survive restarts; ``GET /api/v1/dead-letters`` reads
  and ``POST /api/v1/dead-letters/retry`` drains the durable set;
- **store-outage tolerance**: journal writes catch ``StoreUnavailable``
  (and any other store fault) and degrade LOUDLY — event + counter, task
  still runs in-memory — instead of wedging submit or the sync loop;
- **bounded submit**: ``put`` with a timeout raising typed
  ``errors.QueueSaturated`` (HTTP 429) instead of blocking an API thread
  forever on a full queue, and submit-after-close raises
  ``errors.QueueClosed`` instead of stranding tasks in a consumerless
  queue; ``close()`` has a drain deadline so a hung engine cannot block
  daemon shutdown indefinitely.

The port's copy of ``tpu_docker_api/state/workqueue.py`` without JAX's
legacy closure tasks (``PutKVTask``/``DelKeyTask``/``CopyTask``/``FnTask``
through ``submit``), which no caller of the port has. The sharded writer
plane's ``shard_fn``/``owned_shards`` are JAX's: a record is journaled
under its family's shard, and replay, the marker sweep and dead-letter
revival adopt only the shards this process leads. The reconciler
(service/reconcile.py) replays the journal a dead daemon left on its
startup pass.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import queue
import random
import threading
import time
import uuid
from typing import Callable

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.telemetry import trace as trace_mod

log = logging.getLogger(__name__)

#: reference channel capacity (workQueue/workQueue.go:12)
DEFAULT_CAPACITY = 110
DEFAULT_MAX_RETRIES = 5
BACKOFF_BASE_S = 0.05
#: retry sleeps clamp here — an unbounded 2^attempt would stall the single
#: sync thread for minutes on a flaky engine
BACKOFF_MAX_S = 2.0
#: ±fraction of jitter on every retry sleep, so N daemons hammered by the
#: same engine outage don't retry in lockstep
BACKOFF_JITTER = 0.25
#: bounded submit: how long a producer may wait on a full queue before the
#: typed QueueSaturated (config queue_submit_timeout_s)
DEFAULT_SUBMIT_TIMEOUT_S = 5.0
#: close(): how long shutdown waits for the backlog to drain before
#: abandoning the loop thread (config queue_close_deadline_s); journaled
#: records survive for the next daemon's replay either way
DEFAULT_CLOSE_DEADLINE_S = 10.0
#: dead-letter hygiene: how many times the OPERATOR may re-drive one dead
#: record through POST /api/v1/dead-letters/retry before the typed
#: RetryBudgetExhausted refusal (config queue_dead_letter_retry_budget) —
#: the count is durable on the record, so the cap survives daemon restarts
#: and a permanently-poisoned task can't be blind-retried forever
DEFAULT_DEAD_LETTER_RETRY_BUDGET = 3


# -- declarative records (journaled, replayable) -------------------------------

@dataclasses.dataclass
class TaskRecord:
    """One unit of durable async work: a kind resolved through the registry
    plus JSON-serializable params — everything the NEXT daemon needs to
    finish work this one started. ``trace_id``/``span_id`` persist the
    submitting request's trace context, so the async tail continues that
    trace in-process and a post-crash replay can LINK back to it (span
    links, not parentage — the origin's span tree died with its daemon)."""

    task_id: str
    kind: str
    params: dict
    seq: int                      # journal key ordinal = submit order
    state: str = "pending"        # pending | inflight | dead (done = deleted)
    attempts: int = 0
    error: str = ""
    idempotency_key: str = ""
    trace_id: str = ""
    span_id: str = ""
    #: owning writer-plane shard (sharded mode: each shard journals under
    #: its own sub-prefix and replays only its own records on takeover);
    #: legacy records with no field parse to shard 0 — the legacy keyspace
    shard: int = 0
    #: durable operator-retry count: how many times this record has been
    #: revived through POST /api/v1/dead-letters/retry. Distinct from
    #: ``attempts`` (the per-revival automatic retry loop, which resets on
    #: revival): this one only grows, so the retry budget holds across
    #: restarts. Legacy records with no field parse to 0 — full budget.
    op_retries: int = 0

    def to_json(self) -> str:
        d = {
            "id": self.task_id, "kind": self.kind, "params": self.params,
            "seq": self.seq, "state": self.state, "attempts": self.attempts,
            "error": self.error, "idempotencyKey": self.idempotency_key,
            "traceId": self.trace_id, "spanId": self.span_id,
        }
        if self.shard:
            d["shard"] = self.shard
        if self.op_retries:
            d["opRetries"] = self.op_retries
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "TaskRecord":
        d = json.loads(raw)
        return cls(task_id=d["id"], kind=d["kind"], params=d["params"],
                   seq=int(d["seq"]), state=d.get("state", "pending"),
                   attempts=int(d.get("attempts", 0)),
                   error=d.get("error", ""),
                   idempotency_key=d.get("idempotencyKey", ""),
                   trace_id=d.get("traceId", ""),
                   span_id=d.get("spanId", ""),
                   shard=int(d.get("shard", 0)),
                   op_retries=int(d.get("opRetries", 0)))

    def label(self) -> str:
        return f"{self.kind}:{self.task_id}"


@dataclasses.dataclass
class TaskHandler:
    """Registry entry: how to execute a kind, and (optionally) how to
    compensate when the record dead-letters."""
    execute: Callable[[TaskRecord], None]
    on_fail: Callable[[TaskRecord], None] | None = None


class WorkQueue:
    def __init__(
        self,
        kv,
        copy_fn: Callable[[str, str], None] | None = None,
        capacity: int = DEFAULT_CAPACITY,
        max_retries: int = DEFAULT_MAX_RETRIES,
        backoff_base_s: float = BACKOFF_BASE_S,
        backoff_max_s: float = BACKOFF_MAX_S,
        backoff_jitter: float = BACKOFF_JITTER,
        seed: int | None = None,
        submit_timeout_s: float = DEFAULT_SUBMIT_TIMEOUT_S,
        close_deadline_s: float = DEFAULT_CLOSE_DEADLINE_S,
        dead_letter_retry_budget: int = DEFAULT_DEAD_LETTER_RETRY_BUDGET,
        metrics=None,
        tracer=None,
        store_gate=None,
        shard_fn: Callable[[str, dict], int] | None = None,
        owned_shards: Callable[[], frozenset[int]] | None = None,
    ) -> None:
        from tpu_docker_api_torch.utils.files import copy_dir_contents

        self._kv = kv
        self._copy = copy_fn or copy_dir_contents
        self._q: queue.Queue[TaskRecord | None] = queue.Queue(
            maxsize=capacity)
        self._max_retries = max_retries
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self._backoff_jitter = backoff_jitter
        self._rng = random.Random(seed)
        self._submit_timeout_s = submit_timeout_s
        self._close_deadline_s = close_deadline_s
        self._dl_retry_budget = dead_letter_retry_budget
        self._thread: threading.Thread | None = None
        self._closed = False
        #: dead records that were never journaled (degraded at submit);
        #: every other record dead-letters durably in the journal
        self._ephemeral_dead: list[tuple[TaskRecord, str]] = []
        self._dl_mu = threading.Lock()
        self._lifecycle_mu = threading.Lock()
        #: task_ids alive in THIS process (queued or executing): replay
        #: skips them so adoption never double-runs local work
        self._local_ids: set[str] = set()
        self._local_mu = threading.Lock()
        #: serializes replay_journal callers (periodic reconcile vs the
        #: HTTP route): overlapping replays would both adopt the same
        #: record and double-run its side effects
        self._replay_mu = threading.Lock()
        #: idempotency_key → task_id for ACTIVE records; lazily seeded
        #: from the journal so keyed submits don't re-scan the whole
        #: prefix (including the unbounded dead set) every time
        self._active_keys: dict[str, str] | None = None
        #: seed-scan race guard: records acked/dead-lettered while a seed
        #: scan is reading the journal outside the lock would otherwise be
        #: installed as permanently stale key→task_id entries
        self._seeding = 0
        self._dropped_while_seeding: set[str] = set()
        #: per-shard journal sequence counters; a shard is absent until its
        #: first scan (lazy so a store outage at construction degrades
        #: instead of failing the boot). The unsharded queue only ever
        #: uses shard 0 — the legacy flat journal prefix.
        self._seq: dict[int, int] = {}
        self._seq_mu = threading.Lock()
        #: sharded writer plane (daemon wiring): maps a submit to its
        #: owning shard (None ⇒ everything is shard 0), and names the
        #: shards THIS process currently leads so replay adopts only its
        #: own journal sub-prefixes (None ⇒ every record is adoptable —
        #: single-writer semantics)
        self._shard_fn = shard_fn
        self._owned_shards = owned_shards
        #: store-outage hold (service/store_health.py): the sync loop keeps
        #: draining submits into its hands but PAUSES execution while the
        #: gate holds — a task run against a dead store would burn its
        #: bounded retries on guaranteed failures and dead-letter work that
        #: only needed to wait. Close overrides the hold: an unexecuted
        #: journaled record is exactly what replay adopts. None ⇒ ungated.
        self._store_gate = store_gate
        self.store_skips = 0
        self._journal_failures = 0
        self._events: collections.deque = collections.deque(maxlen=128)
        if metrics is None:
            from tpu_docker_api_torch.telemetry.metrics import REGISTRY
            metrics = REGISTRY
        self._metrics = metrics
        #: trace sink for task-execution spans (daemon wires the Program's
        #: tracer); None ⇒ records still CARRY trace context, execution
        #: just records no spans of its own
        self._tracer = tracer
        self._registry: dict[str, TaskHandler] = {}
        # built-in declarative kinds every deployment has
        self.register("put_kv",
                      lambda rec: self._kv.put(rec.params["key"],
                                               rec.params["value"]))
        self.register("del_key", self._exec_del_key)
        self.register("delete_state_family", self._exec_delete_state_family)

    # -- registry -----------------------------------------------------------------

    def register(self, kind: str,
                 execute: Callable[[TaskRecord], None],
                 on_fail: Callable[[TaskRecord], None] | None = None) -> None:
        """Bind a task kind to service context. Services self-register at
        construction, so any process that can build the service can execute
        (and replay) its records. Last registration wins."""
        self._registry[kind] = TaskHandler(execute=execute, on_fail=on_fail)

    def _exec_del_key(self, rec: TaskRecord) -> None:
        if rec.params.get("prefix"):
            self._kv.delete_prefix(rec.params["key"])
        else:
            self._kv.delete(rec.params["key"])

    def _exec_delete_state_family(self, rec: TaskRecord) -> None:
        from tpu_docker_api_torch.state.store import StateStore

        # one delete_prefix round trip: the whole family subtree (every
        # version + the latest pointer) drops atomically on every backend
        # (single sqlite txn / single etcd DeleteRange) — a replayed purge
        # can never leave half a family behind
        StateStore(self._kv).delete_family(
            keys.Resource(rec.params["resource"]), rec.params["base"])

    # -- markers (exec-level idempotency for replayed records) --------------------

    def marker_done(self, task_id: str, shard: int = 0) -> bool:
        return (self._kv.get_or(keys.queue_marker_key(task_id, shard))
                is not None)

    def mark_done(self, task_id: str, shard: int = 0) -> None:
        self._kv.put(keys.queue_marker_key(task_id, shard), "1")

    def copy_dirs(self, src: str, dst: str) -> None:
        """The data-migration primitive (swappable via ``copy_fn``)."""
        self._copy(src, dst)

    # -- producer side ------------------------------------------------------------

    def submit_record(self, kind: str, params: dict,
                      idempotency_key: str = "") -> str:
        """Journal a declarative record (durable intent), then enqueue it.
        Raises :class:`errors.QueueClosed` after shutdown began and
        :class:`errors.QueueSaturated` when the queue stays full past the
        submit timeout (the journal entry is removed again — a rejected
        submit must not execute later by surprise). A store outage on the
        durability path degrades loudly: the task still runs in-memory."""
        if self._closed:
            raise errors.QueueClosed(
                f"work queue is shut down; rejected {kind} task")
        rec: TaskRecord | None = None
        journaled = False
        try:
            if idempotency_key:
                dup_id = self._find_active(idempotency_key)
                if dup_id is not None:
                    log.info("workqueue: %s submit deduplicated against "
                             "active record %s:%s", kind, kind, dup_id)
                    return dup_id
            shard = self._shard_of(kind, params)
            cur = trace_mod.current()
            rec = TaskRecord(task_id=uuid.uuid4().hex[:12], kind=kind,
                             params=dict(params),
                             seq=self._next_seq(shard),
                             idempotency_key=idempotency_key,
                             trace_id=cur.trace_id if cur else "",
                             span_id=cur.span_id if cur else "",
                             shard=shard)
            # claim local ownership BEFORE the journal write: once the
            # record is visible in KV, a concurrent reconcile's replay
            # must already see it as ours, or it would double-run it
            with self._local_mu:
                self._local_ids.add(rec.task_id)
            self._kv.put(keys.queue_task_key(rec.seq, rec.shard),
                         rec.to_json())
            journaled = True
        except Exception as e:  # noqa: BLE001 — durability degrades, loudly
            self._degrade("journal-write-failed", f"{kind}: {e}")
            if rec is None:
                cur = trace_mod.current()
                rec = TaskRecord(task_id=uuid.uuid4().hex[:12], kind=kind,
                                 params=dict(params), seq=-1,
                                 idempotency_key=idempotency_key,
                                 trace_id=cur.trace_id if cur else "",
                                 span_id=cur.span_id if cur else "")
                with self._local_mu:
                    self._local_ids.add(rec.task_id)
            else:
                # the journal write itself failed: mark the record
                # in-memory-only (seq=-1) so the dead-letter path parks it
                # observably instead of "journaling" dead state into a
                # store that never held the record
                rec.seq = -1
        self._track_key(rec)
        try:
            self._q.put(rec, timeout=self._submit_timeout_s)
        except queue.Full:
            if journaled:
                # the caller gets an error; the record must not linger and
                # execute later behind their back. Journal delete FIRST,
                # then release local ownership — the reverse order opens a
                # window where a concurrent replay adopts the still-
                # journaled record after the caller was told 429
                with contextlib.suppress(Exception):
                    self._kv.delete(keys.queue_task_key(rec.seq, rec.shard))
            self._forget_local(rec)
            raise errors.QueueSaturated(
                f"work queue full ({self._q.maxsize} tasks) after "
                f"{self._submit_timeout_s}s; retry later") from None
        return rec.task_id

    def reset_shard_cache(self, shard: int) -> None:
        """Shard-takeover cache invalidation (daemon's on-acquire hook):
        drop the shard's lazy seq counter and the idempotency-key map so
        both re-seed from the journal — the previous holder appended
        records this process never saw, and a stale counter would
        overwrite them."""
        with self._seq_mu:
            self._seq.pop(shard, None)
        with self._local_mu:
            self._active_keys = None

    def _shard_of(self, kind: str, params: dict) -> int:
        if self._shard_fn is None:
            return 0
        try:
            return int(self._shard_fn(kind, params))
        except Exception:  # noqa: BLE001 — misclassification must not
            # lose the task; shard 0 is the singleton-of-last-resort
            log.exception("workqueue: shard classification failed for %s; "
                          "routing to shard 0", kind)
            return 0

    def _next_seq(self, shard: int = 0) -> int:
        with self._seq_mu:
            if shard not in self._seq:
                prefix = keys.queue_tasks_prefix(shard)
                top = -1
                for k in self._kv.range_prefix(prefix):
                    tail = k[len(prefix):]
                    # shard 0's flat prefix is the PARENT of the s<i>/
                    # sub-prefixes: skip nested keys or a shard-0 scan
                    # would absorb every other shard's counter
                    if tail.isdigit():
                        top = max(top, int(tail))
                self._seq[shard] = top + 1
            out = self._seq[shard]
            self._seq[shard] = out + 1
            return out

    def _find_active(self, idempotency_key: str) -> str | None:
        """task_id of an active (pending/inflight) record with this key.
        Served from an in-memory map seeded ONCE from the journal (so a
        restarted daemon still dedups against a dead daemon's records) —
        a per-submit prefix scan would grow with the never-GC'd dead set."""
        with self._local_mu:
            needs_seed = self._active_keys is None
            if needs_seed:
                self._seeding += 1
        if needs_seed:
            # scan OUTSIDE the lock: on etcd this can retry with backoff
            # for seconds, and the sync loop acks through the same lock
            seeded: dict[str, str] | None = None
            try:
                scan: dict[str, str] = {}
                for rec in self._journal_records():
                    if (rec.idempotency_key
                            and rec.state in ("pending", "inflight")):
                        scan[rec.idempotency_key] = rec.task_id
                seeded = scan
            finally:
                with self._local_mu:
                    self._seeding -= 1
                    # only a CLEAN scan installs (a failed one leaves None
                    # so the next submit re-seeds), minus entries for
                    # records the sync loop finished while the scan was
                    # mid-read — installing those would swallow future
                    # keyed submits forever
                    if seeded is not None and self._active_keys is None:
                        self._active_keys = {
                            k: tid for k, tid in seeded.items()
                            if tid not in self._dropped_while_seeding}
                    if self._seeding == 0:
                        self._dropped_while_seeding.clear()
        with self._local_mu:
            return self._active_keys.get(idempotency_key)

    def _track_key(self, rec: TaskRecord) -> None:
        if not rec.idempotency_key:
            return
        with self._local_mu:
            if self._active_keys is not None:
                self._active_keys[rec.idempotency_key] = rec.task_id

    # -- lifecycle ----------------------------------------------------------------

    def start(self) -> None:
        """Launch the sync loop thread (reference: go workQueue.SyncLoop,
        main.go:112)."""
        self._closed = False
        self._thread = threading.Thread(
            target=self._sync_loop, name="workqueue-sync", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        """Drain queued tasks, then stop the loop — bounded by the close
        deadline: a hung engine call must not block daemon shutdown forever.
        An abandoned backlog is not lost — journaled records replay under
        the next daemon (the ephemeral remainder dies with the process, as
        it always did)."""
        # reject new submits as early as possible; the flag (not the
        # lifecycle lock) guards submit so a producer blocked in put()
        # cannot deadlock shutdown
        self._closed = True
        # _lifecycle_mu orders close vs retry_dead_letters: a retry that
        # wins the lock enqueues before the sentinel (and is drained); one
        # that loses sees _thread None and no-ops
        with self._lifecycle_mu:
            if self._thread is None:
                return
            deadline = time.monotonic() + self._close_deadline_s
            try:
                self._q.put(None, timeout=self._close_deadline_s)  # sentinel
            except queue.Full:
                pass  # hung consumer; the bounded join below handles it
            self._thread.join(timeout=max(0.0, deadline - time.monotonic()))
            if self._thread.is_alive():
                self._degrade(
                    "queue-close-abandoned",
                    f"sync loop still busy after {self._close_deadline_s}s; "
                    "journaled backlog will replay on next start")
            self._thread = None

    def drain(self) -> None:
        """Block until everything submitted so far is processed (test hook)."""
        self._q.join()

    @property
    def closed(self) -> bool:
        return self._closed

    def _degrade(self, kind: str, detail: str) -> None:
        """Durability-path failure: LOUD (log + counter + event), never
        blocking — a queue whose safety net wedges the daemon is worse
        than the crash it guards against."""
        self._journal_failures += 1
        log.error("workqueue %s: %s", kind, detail)
        self._metrics.counter_inc(
            "workqueue_degraded_total", {"kind": kind},
            help="Durability-path failures the queue degraded through")
        self._events.append(trace_mod.stamp(
            {"ts": time.time(), "event": kind, "detail": detail}))

    # -- consumer side ------------------------------------------------------------

    def _hold_for_store(self) -> None:
        """Pause task execution while the store gate holds (edge-triggered
        event, per-episode counter). Returns immediately once the gate
        lifts OR the queue is closing — a task executed against a down
        store on shutdown simply fails into the journal for replay."""
        if self._store_gate is None or self._store_gate():
            return
        self.store_skips += 1
        self._events.append(trace_mod.stamp(
            {"ts": time.time(), "event": "store-outage-hold", "detail": ""}))
        while not self._closed and not self._store_gate():
            time.sleep(0.05)
        self._events.append(trace_mod.stamp(
            {"ts": time.time(), "event": "store-outage-over", "detail": ""}))

    def _sync_loop(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                self._q.task_done()
                return
            try:
                self._hold_for_store()
                self._run_record(task)
            finally:
                self._q.task_done()

    def _task_scope(self, rec: TaskRecord, adopted: bool):
        """Span scope for one record execution. Same-process execution
        CONTINUES the submitting trace (same traceId, parent = the submit
        span); an adopted replay — this daemon did not submit the record,
        or a reboot reclaimed it — starts a fresh self-rooted trace with
        ``link=originTraceId``: the origin's span tree ended with its
        process, so parentage would fabricate a timeline."""
        if self._tracer is None:
            return trace_mod.NOOP
        attrs = {"taskId": rec.task_id, "seq": rec.seq}
        if not rec.trace_id:
            # a record submitted with no active trace (tracing was off at
            # submit, or a bare internal submit): its FIRST execution is
            # an ordinary task, never a "replay" — a self-rooted span,
            # trimmed like a loop pass when nothing happened beneath it
            return self._tracer.span(f"queue.task:{rec.kind}", attrs=attrs,
                                     trim_idle=True)
        if not adopted:
            return self._tracer.span(f"queue.task:{rec.kind}",
                                     trace_id=rec.trace_id,
                                     parent_id=rec.span_id, attrs=attrs)
        return self._tracer.span(f"queue.replay:{rec.kind}",
                                 links=(rec.trace_id,), attrs=attrs)

    def _run_record(self, rec: TaskRecord, adopted: bool = False) -> None:
        """Full record lifecycle: claim (journal ``inflight``) → execute
        with bounded retries → ack (journal delete) or dead-letter
        (journal ``dead`` + compensation). The three ``queue.*`` crash
        points mark the boundaries the chaos harness kills at."""
        with self._task_scope(rec, adopted):
            self._run_record_inner(rec)

    def _run_record_inner(self, rec: TaskRecord) -> None:
        from tpu_docker_api_torch.service.crashpoints import crash_point

        rec.state = "inflight"
        self._journal_write(rec)
        crash_point("queue.claim")
        handler = self._registry.get(rec.kind)
        last_err = ""
        if handler is None:
            # deterministic failure — retrying with backoff would only
            # stall the loop (or the reconciler's inline replay) for a
            # record that can never succeed on this deployment
            rec.attempts = 1
            last_err = f"no handler registered for task kind {rec.kind!r}"
        else:
            for attempt in range(self._max_retries):
                rec.attempts = attempt + 1
                try:
                    handler.execute(rec)
                except Exception as e:  # noqa: BLE001 — queue must never die
                    last_err = f"{type(e).__name__}: {e}"
                    log.warning(
                        "workqueue record %s failed (attempt %d/%d): %s",
                        rec.label(), attempt + 1, self._max_retries,
                        last_err)
                    if attempt + 1 < self._max_retries:
                        # no sleep after the FINAL attempt: it would stall
                        # the sync loop (or an inline reconciler replay)
                        # on the way to the dead-letter verdict
                        time.sleep(self.retry_delay_s(attempt))
                    continue
                crash_point("queue.exec")
                self._ack(rec)
                crash_point("queue.ack")
                return
        log.error("workqueue record %s dead-lettered: %s", rec.label(),
                  last_err)
        rec.state = "dead"
        rec.error = last_err
        self._journal_write(rec)
        if rec.seq < 0:
            # degraded at submit (store outage): there is no journal entry
            # to hold the dead state, so park it with the ephemeral dead
            # letters — exhausted work must stay observable and retryable,
            # never silently dropped
            with self._dl_mu:
                self._ephemeral_dead.append((rec, last_err))
        self._forget_local(rec)
        self._metrics.counter_inc(
            "workqueue_dead_letters_total", {"kind": rec.kind},
            help="Tasks that exhausted their retry budget")
        if handler is not None and handler.on_fail is not None:
            try:
                handler.on_fail(rec)
            except Exception:  # noqa: BLE001
                log.exception("compensation for %s failed", rec.label())

    def _ack(self, rec: TaskRecord) -> None:
        """Done: drop the journal entry and its marker in ONE atomic apply
        — the old two-delete sequence had a crash window (entry gone,
        marker leaked) that the orphan sweep existed to mop up; batching
        closes it and halves the ack's store round trips. The local claim
        releases LAST so a concurrent replayer can never adopt the record
        while its marker is going away. A store outage leaves the entry
        inflight — the next replay re-runs it, which the marker makes safe
        — so degrade loudly rather than retry-looping."""
        rec.state = "done"
        try:
            ops: list[tuple] = []
            if rec.seq >= 0:
                ops.append(("delete",
                            keys.queue_task_key(rec.seq, rec.shard)))
            # degraded (seq<0) records may still have written a marker
            ops.append(("delete",
                        keys.queue_marker_key(rec.task_id, rec.shard)))
            self._kv.apply(ops)
        except Exception as e:  # noqa: BLE001
            self._degrade("journal-ack-failed", f"{rec.label()}: {e}")
        finally:
            self._forget_local(rec)

    def _journal_write(self, rec: TaskRecord) -> None:
        if rec.seq < 0:
            return  # degraded at submit: in-memory only
        try:
            self._kv.put(keys.queue_task_key(rec.seq, rec.shard),
                         rec.to_json())
        except Exception as e:  # noqa: BLE001
            self._degrade("journal-write-failed", f"{rec.label()}: {e}")

    def _forget_local(self, rec: TaskRecord) -> None:
        with self._local_mu:
            self._local_ids.discard(rec.task_id)
            # the key maps ACTIVE records only: once acked or dead it must
            # not absorb a fresh submit (a dead record needs operator
            # retry; a new keyed submit is new intent)
            if (self._active_keys is not None and rec.idempotency_key
                    and self._active_keys.get(rec.idempotency_key)
                    == rec.task_id):
                del self._active_keys[rec.idempotency_key]
            if self._seeding and rec.idempotency_key:
                # a seed scan is mid-read: it may have already copied this
                # record as active; veto it before the scan installs
                self._dropped_while_seeding.add(rec.task_id)

    def retry_delay_s(self, attempt: int) -> float:
        """Capped, jittered exponential backoff: min(cap, base·2^attempt)
        with ±``backoff_jitter`` spread (seedable for deterministic tests)."""
        from tpu_docker_api_torch.utils.backoff import backoff_delay_s

        return backoff_delay_s(attempt, self._backoff_base_s,
                               self._backoff_max_s, self._backoff_jitter,
                               self._rng)

    # -- journal views / replay ---------------------------------------------------

    def _journal_records(self) -> list[TaskRecord]:
        out = []
        for key, raw in sorted(
                self._kv.range_prefix(keys.QUEUE_TASKS_PREFIX).items()):
            try:
                out.append(TaskRecord.from_json(raw))
            except (ValueError, KeyError, TypeError):
                log.warning("workqueue: unreadable journal entry at %s", key)
        return out  # key-sorted == seq order (zero-padded)

    def journal_replayable(self, include_local: bool = False
                           ) -> list[TaskRecord]:
        """Pending/in-flight records in submit order. By default records
        owned by THIS process (queued or executing right now) are excluded
        — they are not adoptable, they are simply not done yet.
        ``include_local=True`` processes them too (test hook: drive the
        sync loop's work inline, under armed crash points)."""
        return self._filter_replayable(self._journal_records(), include_local)

    def _filter_replayable(self, records: list[TaskRecord],
                           include_local: bool) -> list[TaskRecord]:
        with self._local_mu:
            local = set() if include_local else set(self._local_ids)
        owned = (self._owned_shards() if self._owned_shards is not None
                 else None)
        return [rec for rec in records
                if rec.state in ("pending", "inflight")
                and rec.task_id not in local
                # sharded plane: adopt ONLY the shards this process leads
                # — another shard's journal belongs to its own (live!)
                # leader, and replaying it here would double-run work
                and (owned is None or rec.shard in owned)]

    def replay_journal(self, include_local: bool = False) -> list[dict]:
        """Adopt the journal: execute every replayable record inline, in
        submit order, through the same claim→exec→ack lifecycle the loop
        uses (so retries, dead-lettering, markers and crash points all
        apply). Exactly-once EFFECT comes from the markers and the
        idempotent handlers, not from suppressing the re-run."""
        outcomes = []
        # one replayer at a time, and the journal is re-read INSIDE the
        # lock: the periodic reconcile and the HTTP route would otherwise
        # both adopt the same record and double-run its side effects.
        # One scan serves both the replay pass and the marker sweep — on
        # etcd each full-prefix read is a network round trip per pass
        with self._replay_mu:
            records = self._journal_records()
            for rec in self._filter_replayable(records, include_local):
                # re-check at adoption time: the sync loop may have acked
                # (journal entry deleted — and with it the marker, so a
                # blind re-run would re-copy into a LIVE container) or
                # dead-lettered this record since the scan / since its
                # local-ownership snapshot was taken
                if rec.seq >= 0:
                    try:
                        raw = self._kv.get_or(
                            keys.queue_task_key(rec.seq, rec.shard))
                        if (raw is None or TaskRecord.from_json(raw).state
                                not in ("pending", "inflight")):
                            continue
                    except Exception as e:  # noqa: BLE001 — skip, not
                        # double-run: an unverifiable record replays on the
                        # next pass
                        log.warning("workqueue: adoption re-check for %s "
                                    "failed, skipping: %s", rec.label(), e)
                        continue
                log.info("workqueue: replaying adopted record %s (%s)",
                         rec.label(), rec.state)
                self._run_record(rec, adopted=True)
                outcomes.append({
                    "target": rec.label(), "kind": rec.kind,
                    "state": "dead" if rec.state == "dead" else "done",
                })
                self._metrics.counter_inc(
                    "workqueue_replayed_total", {"kind": rec.kind},
                    help="Journal records adopted and replayed after a restart")
            self._sweep_orphan_markers(records)
        return outcomes

    def sweep_orphan_markers(self) -> None:
        """Public GC entry (service/compactor.py rides it): drop acked
        copy-complete markers whose journal record is gone. Same
        best-effort contract as the replay-time sweep — a failure logs
        and waits for the next pass, never raises."""
        self._sweep_orphan_markers()

    def _sweep_orphan_markers(self, records: list[TaskRecord] | None = None
                              ) -> None:
        """GC markers whose record is gone — a daemon death between _ack's
        two deletes (journal entry first, marker second: the safe order,
        since a marker must outlive its record or replay would re-copy)
        leaks the marker forever otherwise. Markers of records alive in
        this process are kept: a local handler may be between its
        mark_done and the follow-up start. A stale ``records`` list is
        safe — it only retains a marker longer, never deletes a live one,
        since acked records drop their own markers in :meth:`_ack`."""
        try:
            if records is None:
                records = self._journal_records()
            live = {rec.task_id for rec in records}
            with self._local_mu:
                live |= self._local_ids
            owned = (self._owned_shards() if self._owned_shards is not None
                     else None)
            doomed = [
                # keys-only: marker values are never inspected here, and at
                # scale the orphan sweep must not deserialize the backlog
                key for key in self._kv.keys_prefix(keys.QUEUE_MARKERS_PREFIX)
                if key.rsplit("/", 1)[-1] not in live
                # sharded plane: GC only our own shards' markers — another
                # shard's fence would (rightly) reject the delete anyway
                and (owned is None or _marker_shard(key) in owned)
            ]
            # batched deletes, chunked under etcd's max-txn-ops (default
            # 128) so a huge orphan backlog still GCs incrementally instead
            # of failing wholesale forever (sweep is GC: no atomicity need)
            for i in range(0, len(doomed), 100):
                self._kv.apply([("delete", key)
                                for key in doomed[i:i + 100]])
        except Exception as e:  # noqa: BLE001 — GC, never required
            log.warning("workqueue: marker sweep skipped: %s", e)

    # -- dead letters -------------------------------------------------------------

    def dead_letter_view(self) -> list[dict]:
        """Snapshot for the API — dead letters must be observable, not an
        in-memory secret (and since the journal, not a process secret)."""
        out = []
        with contextlib.suppress(Exception):
            for rec in self._journal_records():
                if rec.state == "dead":
                    out.append({
                        "id": rec.task_id, "kind": rec.kind,
                        "params": rec.params, "attempts": rec.attempts,
                        "task": f"{rec.kind}({json.dumps(rec.params, sort_keys=True)})",
                        "error": rec.error, "durable": True,
                        "opRetries": rec.op_retries,
                        "retryable": rec.op_retries < self._dl_retry_budget,
                    })
        with self._dl_mu:
            for t, e in self._ephemeral_dead:  # degraded-submit records
                out.append({
                    "id": t.task_id, "kind": t.kind, "params": t.params,
                    "attempts": t.attempts,
                    "task": f"{t.kind}({json.dumps(t.params, sort_keys=True)})",
                    "error": e, "durable": False,
                })
        return out

    def retry_dead_letters(self) -> int:
        """Re-enqueue dead-lettered tasks (POST /api/v1/dead-letters/retry)
        — the operator fixed the underlying fault (disk full, engine down)
        and wants the lost work to run, not a process restart. Each task
        gets a fresh AUTOMATIC retry budget, but its durable operator-retry
        count (``opRetries``) only grows: a record past
        ``dead_letter_retry_budget`` revivals is refused, and when EVERY
        dead letter is past budget the call raises the typed
        :class:`errors.RetryBudgetExhausted` instead of silently requeueing
        nothing — a permanently-poisoned task must be deleted or fixed, not
        re-driven forever. Returns how many were re-enqueued."""
        exhausted: list[str] = []
        with self._lifecycle_mu:
            if self._thread is None:
                # queue closed: durable letters stay observable in the
                # journal (and in dead_letter_view) rather than stranding
                # behind the shutdown sentinel in a consumerless queue
                return 0
            n = 0
            owned = (self._owned_shards() if self._owned_shards is not None
                     else None)
            for rec in self._journal_records():
                if rec.state != "dead":
                    continue
                if owned is not None and rec.shard not in owned:
                    continue  # that shard's leader revives its own dead
                if rec.op_retries >= self._dl_retry_budget:
                    exhausted.append(rec.label())
                    continue  # refused: stays dead, stays observable
                rec.state = "pending"
                rec.error = ""
                rec.attempts = 0
                rec.op_retries += 1
                # claim local ownership BEFORE the record becomes pending
                # in the journal: a concurrent reconcile replay must see
                # it as ours, or it double-runs the revived task
                with self._local_mu:
                    self._local_ids.add(rec.task_id)
                self._journal_write(rec)
                # active again BEFORE the enqueue: tracking after it races
                # an immediate ack, whose cleanup would find no entry to
                # remove and leave a done record's key swallowing every
                # future keyed submit
                self._track_key(rec)
                try:
                    self._q.put(rec, timeout=self._submit_timeout_s)
                except queue.Full:
                    # roll the state back so the letter stays visible;
                    # the operator retries once there is room
                    rec.state = "dead"
                    self._journal_write(rec)
                    self._forget_local(rec)
                    return n
                n += 1
            with self._dl_mu:
                entries = list(self._ephemeral_dead)
                self._ephemeral_dead.clear()
            for i, (task, err) in enumerate(entries):
                try:
                    # bounded, like every other producer: an unbounded put
                    # here would block the API thread HOLDING _lifecycle_mu,
                    # deadlocking close() past its own deadline
                    self._q.put(task, timeout=self._submit_timeout_s)
                except queue.Full:
                    with self._dl_mu:
                        self._ephemeral_dead.extend(entries[i:])
                    return n
                n += 1
            if n == 0 and exhausted:
                # nothing revived and at least one letter was refused:
                # surface the refusal as a typed 409, not {"requeued": 0}
                raise errors.RetryBudgetExhausted(
                    f"{len(exhausted)} dead letter(s) past the "
                    f"operator-retry budget ({self._dl_retry_budget}): "
                    + ", ".join(sorted(exhausted)[:5]))
            return n

    # -- stats (GET /api/v1/queue) -------------------------------------------------

    def stats(self) -> dict:
        """Depth / journal / degradation view for the operator."""
        counts = {"pending": 0, "inflight": 0, "dead": 0}
        journal_error = ""
        try:
            records = self._journal_records()
            for rec in records:
                counts[rec.state] = counts.get(rec.state, 0) + 1
        except Exception as e:  # noqa: BLE001 — a store outage must not 500
            records = []
            journal_error = f"{type(e).__name__}: {e}"
        out = {
            "depth": self._q.qsize(),
            "capacity": self._q.maxsize,
            "closed": self._closed,
            "journal": {"entries": len(records), **counts},
            "journalWriteFailures": self._journal_failures,
            "events": list(self._events),
        }
        if journal_error:
            out["journal"]["error"] = journal_error
        return out


def _marker_shard(marker_key: str) -> int:
    """Owning shard of a marker key: ``.../markers/s<i>/<tid>`` → i,
    the legacy flat layout → 0."""
    rest = marker_key[len(keys.QUEUE_MARKERS_PREFIX):]
    if rest.startswith("s"):
        sid, sep, _ = rest[1:].partition("/")
        if sep and sid.isdigit():
            return int(sid)
    return 0


def queue_depth(wq: WorkQueue) -> int:
    return wq._q.qsize()
