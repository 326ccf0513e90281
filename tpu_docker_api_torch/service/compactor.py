"""Retention-bounded history compaction.

Every rolling replace, rescale and autoscale decision appends an immutable
version record; admission leaves settled records and the work queue leaves
acked copy markers. None of it is ever read again past a bounded lookback
— but it all costs prefix-scan width and store size FOREVER, which is what
turns O(100) families into quadratic pain at O(100k). The
``HistoryCompactor`` is the writer-side GC loop (leader-only under
leader_election, like the admission and autoscale loops) that bounds it:

- **version records** — per family, every version older than the newest
  ``history_retention_versions`` is trimmed. NEVER trimmed, regardless of
  age: the version the family's ``latest`` pointer names (rollback target
  + the record every read resolves), and any version a live runtime
  member still references (a stale-but-present container or gang member
  must stay explainable until the reconciler retires it). Trimming only
  ever deletes ``.../v/NNN`` keys — the latest pointer and the version
  MAP are untouched, so a crash mid-trim can break nothing a reconcile
  pass wouldn't already tolerate (a missing OLD version just shortens
  rollback history);
- **admission records** — records whose job family no longer exists are
  pure garbage (the admission adoption settles the live ones);
- **queue markers** — acked copy-complete markers whose journal record is
  gone ride the work queue's own orphan sweep.

All deletes ride chunked ``KV.apply`` batches of ≤ 100 ops — under etcd's
default 128 max-txn-ops ceiling, same as the marker sweep — so a huge
backlog compacts incrementally instead of failing wholesale. Two labeled
crash points (``compact.before_trim`` / ``compact.mid_trim``) let the
chaos suite prove both halves: nothing doomed is half-protected, and a
partially-applied trim leaves every family serving its latest version.

The port's copy of ``tpu_docker_api/service/compactor.py``, whole.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.keys import Resource, versioned_name
from tpu_docker_api_torch.state.kv import KV
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY

log = logging.getLogger(__name__)

#: ops per KV.apply batch — below etcd's default max-txn-ops (128)
CHUNK_OPS = 100


class HistoryCompactor:
    def __init__(self, kv: KV, store: StateStore,
                 maps: list[tuple[Resource, object]],
                 retention: int,
                 runtime=None, pod=None, work_queue=None,
                 interval_s: float = 60.0,
                 registry: MetricsRegistry | None = None,
                 chunk_ops: int = CHUNK_OPS,
                 locks: dict | None = None,
                 tracer=None, owns=None, store_gate=None) -> None:
        self._kv = kv
        self._store = store
        #: trace sink for self-rooted per-pass spans (idle passes trimmed)
        self._tracer = tracer
        #: per-resource family-lock providers (base -> context manager):
        #: a family's doomed-selection AND delete run under its service
        #: lock, so a concurrent rollback that just confirmed a version
        #: in history cannot have the record GC'd out from under its read
        self._locks = locks or {}
        #: (resource, version map) pairs — the map's snapshot is the
        #: in-memory family index, so discovering families costs zero
        #: store reads on the leader
        self._maps = maps
        self._retention = retention
        #: live-member probes: the local container runtime (containers /
        #: volumes) and the pod's per-host runtimes (job gang members)
        self._runtime = runtime
        self._pod = pod
        self._wq = work_queue
        #: sharded writer plane (daemon wiring): compact only families
        #: whose shard this process leads; None ⇒ all (single-writer)
        self._owns = owns
        self._interval_s = interval_s
        self._chunk_ops = max(1, chunk_ops)
        self._registry = registry if registry is not None else REGISTRY
        #: store-outage hold (service/store_health.py): GC deletes history
        #: records — destructive writes have no business racing a store
        #: that cannot confirm them. None ⇒ ungated.
        self._store_gate = store_gate
        self.store_skips = 0
        self._mu = threading.Lock()
        self._last_report: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle (writer loop, leader-only under election) ----------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="compactor", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.compact_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("history compaction failed")

    # -- one pass -----------------------------------------------------------------

    def compact_once(self) -> dict:
        """One full compaction pass; returns the report (also kept for
        :meth:`last_report` / the POST /api/v1/compact route)."""
        if self._store_gate is not None and not self._store_gate():
            self.store_skips += 1
            return {"skipped": "store-outage", "trimmed": {},
                    "protected": 0, "chunks": 0, "durationMs": 0.0}
        with trace.pass_span(self._tracer, "compact.pass"):
            return self._compact_once_inner()

    def _compact_once_inner(self) -> dict:
        from tpu_docker_api_torch.service.crashpoints import crash_point

        t0 = time.perf_counter()
        trimmed: dict[str, int] = {}
        protected_total = 0
        chunks = 0
        fired_before = False

        def flush(ops: list[tuple]) -> None:
            nonlocal chunks, fired_before
            if not fired_before:
                crash_point("compact.before_trim")
                fired_before = True
            for i in range(0, len(ops), self._chunk_ops):
                self._kv.apply(ops[i:i + self._chunk_ops])
                chunks += 1
                # first chunk durable, the rest not: the chaos suite kills
                # here and proves a partial trim is invisible to reads
                crash_point("compact.mid_trim")

        for resource, vm in self._maps:
            lock_fn = self._locks.get(resource)
            count = 0
            bases = sorted(vm.snapshot())
            if self._owns is not None:
                bases = [b for b in bases if self._owns(b)]
            for base in bases:
                # selection AND delete under the family's service lock
                # (where one exists): an in-flight rollback/replace that
                # just confirmed a version must not lose its record to GC
                # between its history check and its read
                lock = (lock_fn(base) if lock_fn is not None
                        else contextlib.nullcontext())
                with lock:
                    doomed, kept = self._family_doomed(resource, base)
                    protected_total += kept
                    count += len(doomed)
                    if doomed:
                        flush([("delete",
                                keys.version_key(resource, base, v))
                               for v in doomed])
            if count:
                trimmed[resource.value] = count
        admission_ops: list[tuple] = []
        admission_purged = self._doomed_admission(admission_ops)
        if admission_ops:
            flush(admission_ops)
        if self._wq is not None:
            self._wq.sweep_orphan_markers()

        for res, n in trimmed.items():
            self._registry.counter_inc(
                "compactor_trimmed_total", {"resource": res},
                value=float(n), help="Version records trimmed past retention")
        self._registry.counter_inc("compactor_runs_total",
                                   help="History compaction passes")
        report = {
            "retention": self._retention,
            "trimmed": trimmed,
            "trimmedTotal": sum(trimmed.values()),
            "protectedLive": protected_total,
            "admissionPurged": admission_purged,
            "chunks": chunks,
            "durationMs": round((time.perf_counter() - t0) * 1e3, 2),
        }
        with self._mu:
            self._last_report = report
        if chunks:
            log.info("compactor: trimmed %d version record(s) %s, purged "
                     "%d admission record(s) in %d chunk(s)",
                     report["trimmedTotal"], trimmed, admission_purged,
                     chunks)
        return report

    def last_report(self) -> dict | None:
        with self._mu:
            return self._last_report

    # -- selection ----------------------------------------------------------------

    def _family_doomed(self, resource: Resource,
                       base: str) -> tuple[list[int], int]:
        """(versions to trim, live-referenced versions spared past the
        age rule). Work is O(history) per family and O(doomed) probes —
        a family already at retention costs one keys-only scan."""
        stored = self._store.history(resource, base)
        if len(stored) <= self._retention:
            return [], 0
        protected = set(stored[-self._retention:])
        latest = self._store.latest_version(resource, base)
        if latest is not None:
            protected.add(latest)
        doomed, spared = [], 0
        for v in stored:
            if v in protected:
                continue
            if self._live_ref(resource, base, v):
                spared += 1
                continue
            doomed.append(v)
        return doomed, spared

    def _live_ref(self, resource: Resource, base: str, version: int) -> bool:
        """Is this old version still referenced by anything alive in a
        runtime? Conservative on error: an unanswerable probe (dead
        engine, missing state) PROTECTS the version — GC must never need
        the benefit of the doubt."""
        try:
            if resource == Resource.CONTAINERS and self._runtime is not None:
                return self._runtime.container_exists(
                    versioned_name(base, version))
            if resource == Resource.VOLUMES and self._runtime is not None:
                return self._runtime.volume_exists(
                    versioned_name(base, version))
            if resource == Resource.JOBS and self._pod is not None:
                try:
                    st = self._store.get_job(versioned_name(base, version))
                except errors.NotExistInStore:
                    return False
                for host_id, cname, *_ in st.placements:
                    host = self._pod.hosts.get(host_id)
                    if host is not None and host.runtime.container_exists(
                            cname):
                        return True
                return False
        except Exception as e:  # noqa: BLE001 — protect on doubt
            log.warning("compactor: live-ref probe for %s %s-%d failed "
                        "(version protected): %s", resource.value, base,
                        version, e)
            return True
        # services: replicas are job families of their own — no runtime
        # object ever references a service VERSION record directly
        return False

    def _doomed_admission(self, ops: list[tuple]) -> int:
        """Admission records whose job family is gone — settled garbage
        the adoption pass has no reason left to look at. Keys carry the
        seq only, so record payloads are read (bounded by queue depth,
        not object count) to learn the base."""
        import json

        purged = 0
        try:
            records = self._kv.range_prefix(keys.ADMISSION_PREFIX)
        except Exception as e:  # noqa: BLE001 — GC, never required
            log.warning("compactor: admission scan skipped: %s", e)
            return 0
        job_map = dict(self._maps).get(Resource.JOBS)
        if job_map is None:
            return 0
        families = job_map.snapshot()
        for key, raw in records.items():
            try:
                base = json.loads(raw)["base"]
            except (ValueError, KeyError):
                continue  # foreign junk: not ours to judge
            if self._owns is not None and not self._owns(base):
                continue  # that shard's leader GCs its own records
            if base not in families:
                ops.append(("delete", key))
                purged += 1
        return purged
