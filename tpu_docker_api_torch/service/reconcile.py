"""Crash-consistent startup/periodic reconciler (docs/robustness.md).

The control plane persists desired state in the KV store and mutates the
runtime through multi-step flows (version bump → create → quiesce → copy →
start). A daemon death between any two steps — or an out-of-band ``docker
rm`` — leaves the two sources of truth disagreeing: two live versions of a
family, a version pointer with no container, chips and ports owned by
nothing. The reference has no recovery story at all (its ``Init`` rebuilds
schedulers from etcd and trusts them blindly, main.go:50-86).

``Reconciler.reconcile()`` sweeps KV desired state against
``runtime.container_list()``/``inspect`` actual state and repairs drift:

- **half-completed rolling replacements** — a latest version that exists
  but never started (docker status "created") while an older version is
  still around is rolled BACK through the same compensation recipe the
  in-process failure path uses (``ContainerService._undo_new_version``):
  the old container keeps the data, the incomplete replacement is retired
  and its resources freed. A latest that *has* run (status "exited")
  crashed — it is restarted and stale older versions are retired;
- **version pointers without specs / without containers** — rolled back to
  the newest version that actually exists;
- **orphaned containers** — runtime containers with stored state but no
  version pointer are adopted (pointer + scheduler claims restored);
  containers with no KV trace at all are removed;
- **out-of-band removals** — a family gone from the runtime has its chips
  and ports freed (double-free-guarded by scheduler ownership) and is
  marked no-longer-desired so the repair is stable;
- **leaked / missing resources** — per family, scheduler ownership is
  reconciled to exactly the latest spec's claim (free the extras, re-claim
  the missing), and owners that map to no known family are swept.

Every action is recorded as a HealthWatcher-style event, counted in
``MetricsRegistry`` (``reconcile_actions_total{action=...}``), and returned
in the report served at ``GET /api/v1/reconcile``. ``dry_run=True`` reports
the planned repairs without mutating anything.

The port's copy of ``tpu_docker_api/service/reconcile.py`` for the
container families: ``DirtySet``, the journal replay, the family and orphan
passes, the resource and foreign-owner sweeps, the modes, the periodic loop
and the store-outage hold, with JAX's constructor. The job-family repair,
the serving, admission and workflow adoption and the sharded plane's
``owns`` filter come with their services (ROADMAP Queue 1 item 10);
handing the constructor one of them raises NotImplementedError.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import ContainerRuntime
from tpu_docker_api_torch.runtime.fanout import SERIAL, Fanout
from tpu_docker_api_torch.runtime.spec import ContainerSpec
from tpu_docker_api_torch.scheduler.ports import PortScheduler
from tpu_docker_api_torch.scheduler.slices import ChipScheduler
from tpu_docker_api_torch.state.keys import (
    Resource,
    job_owner_base,
    split_versioned_name,
    versioned_name,
)
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.state.version import VersionMap
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY

log = logging.getLogger(__name__)

#: structural repairs per family per pass — each iteration re-evaluates the
#: family after a pointer rollback; anything deeper than a few is a bug
_MAX_FAMILY_PASSES = 5


class DirtySet:
    """Family-granular dirty tracking fed by the store's watch stream.

    Every mutation under a resource prefix marks its family base dirty;
    a ``dirty``-mode reconcile pass visits ONLY those families, so
    steady-state control-plane cost is O(changes), not O(objects). Two
    degraded states fall back to treat-everything-as-dirty
    (``full_pending``): process start (the set is in-process — whatever
    was dirty when a daemon died is unknown, so the first pass is full;
    that IS the durable-replay contract) and a reflector relist (a
    WatchLost gap swallowed an unknown set of events — the next pass is
    full once, then event-driven again). Out-of-band RUNTIME drift
    (``docker rm`` behind the daemon's back) never produces a KV event
    at all; the periodic anti-entropy full pass exists exactly for it.

    Services are deliberately NOT tracked: the serving adoption sweep
    already walks every service on EVERY pass (dirty or full) — it is
    one of the bounded adoption prefixes — so per-family service marks
    would be collected and never individually consumed.
    """

    #: kinds the dirty pass visits per family, keyed by key-prefix segment
    KINDS = (Resource.CONTAINERS.value, Resource.JOBS.value)

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._sets: dict[str, set[str]] = {k: set() for k in self.KINDS}
        self._full_pending = True
        self._full_reason = "startup"
        self.marks_total = 0

    def observe(self, ev) -> None:
        """Watch-event handler (informer thread): map a state key to its
        family and mark it. Keys outside the family layout (the
        versions-map singletons, scheduler state, queue/admission
        journals) are ignored — the adoption prefixes are scanned every
        pass regardless, and map singletons always change alongside the
        family keys on the flows that matter."""
        from tpu_docker_api_torch.state import keys as _keys

        rest = ev.key[len(_keys.PREFIX) + 1:]
        parts = rest.split("/")
        if len(parts) >= 2 and parts[0] in self.KINDS and parts[1]:
            self.mark(parts[0], parts[1])

    def mark(self, kind: str, base: str) -> None:
        with self._mu:
            self._sets[kind].add(base)
            self.marks_total += 1

    def mark_all(self, reason: str) -> None:
        with self._mu:
            self._full_pending = True
            self._full_reason = reason
            # the per-family marks are subsumed by the pending full pass
            for s in self._sets.values():
                s.clear()

    @property
    def full_pending(self) -> bool:
        return self._full_pending

    def peek(self) -> dict[str, set[str]]:
        """Copy without consuming — dry runs observe, they never eat
        another pass's work."""
        with self._mu:
            return {k: set(s) for k, s in self._sets.items()}

    def drain(self, consume_full: bool = False) -> dict[str, set[str]]:
        with self._mu:
            out = self._sets
            self._sets = {k: set() for k in self.KINDS}
            if consume_full:
                self._full_pending = False
            return out

    def reinsert(self, sets: dict[str, set[str]]) -> None:
        """Give a drained batch back (the pass died before repairing it)."""
        with self._mu:
            for k, s in sets.items():
                self._sets[k].update(s)

    def status_view(self) -> dict:
        with self._mu:
            return {
                "fullPending": self._full_pending,
                "fullReason": self._full_reason,
                "dirty": {k: len(s) for k, s in self._sets.items()},
                "marksTotal": self.marks_total,
            }


class Reconciler:
    def __init__(
        self,
        runtime: ContainerRuntime,
        store: StateStore,
        chips: ChipScheduler,
        ports: PortScheduler,
        versions: VersionMap,
        container_svc=None,
        shared_version_maps: list[VersionMap] | None = None,
        job_svc=None,
        job_versions: VersionMap | None = None,
        job_max_restarts: int = 3,
        job_max_migrations: int = 3,
        registry: MetricsRegistry | None = None,
        max_events: int = 512,
        work_queue=None,
        fanout: Fanout | None = None,
        admission=None,
        serving=None,
        workflow=None,
        full_interval_s: float = 0.0,
        tracer=None,
        owns=None,
        owned_shards=None,
        store_gate=None,
    ) -> None:
        for arg, value in (("job_svc", job_svc), ("admission", admission),
                           ("serving", serving), ("workflow", workflow),
                           ("owns", owns), ("owned_shards", owned_shards)):
            if value is not None:
                raise NotImplementedError(
                    f"Reconciler({arg}=...): not ported to "
                    "tpu_docker_api_torch yet (ROADMAP Queue 1 item 10)")
        self.runtime = runtime
        #: trace sink for self-rooted per-pass spans (daemon wires the
        #: Program's tracer); an idle pass's trace is trimmed, not buffered
        self._tracer = tracer
        #: runtime fan-out, the process's one bounded pool (the job scans
        #: that batch through it in JAX come with the job service)
        self._fanout = fanout or SERIAL
        self.store = store
        self.chips = chips
        self.ports = ports
        self.versions = versions
        self._svc = container_svc
        #: other owners of the SAME schedulers (the job service shares the
        #: local chip/port pools) — their claims are off-limits to the sweep
        self._shared_maps = shared_version_maps or []
        # job_versions, job_max_restarts and job_max_migrations are the job
        # repair's, which comes with the job service (item 10 iv)
        #: durable work queue: the startup sweep adopts its journal and
        #: replays pending/in-flight records BEFORE the family passes, so
        #: an interrupted copy/drain finishes forward instead of being
        #: misread as structural drift
        self._wq = work_queue
        self._registry = registry if registry is not None else REGISTRY
        #: event-driven mode: with a dirty feed attached,
        #: periodic passes visit only watch-dirtied families and the full
        #: scan is demoted to a rare anti-entropy pass every
        #: ``full_interval_s`` seconds (<= 0: every pass is full — the
        #: legacy behavior, and the safe default without a feed)
        self._full_interval_s = full_interval_s
        #: store-outage hold (service/store_health.py): a repair decided on
        #: state the sweep cannot re-read — and recorded nowhere — is drift
        #: manufactured, not drift repaired. While gated, non-dry-run passes
        #: return a skipped-shape report; dry runs still sweep (they mutate
        #: nothing). None ⇒ ungated, the pre-brownout behavior.
        self._store_gate = store_gate
        self.store_skips = 0
        self._store_held = False
        self._dirty: DirtySet | None = None
        self._last_full: float | None = None
        self._mu = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._last_report: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def attach_dirty_feed(self, informer) -> None:
        """Wire the dirty-set to a reflector (state/informer.py) over the
        RAW store. Must run before ``informer.start()`` so the initial
        list's synthetic events are observed too. The relist hook is the
        WatchLost contract: any gap ⇒ the next pass is full, once."""
        from tpu_docker_api_torch.state import keys as _keys

        self._dirty = DirtySet()
        for kind in DirtySet.KINDS:
            informer.register(f"{_keys.PREFIX}/{kind}/", self._dirty.observe)
        informer.on_relist(lambda: self._dirty.mark_all("relist"))

    def dirty_view(self) -> dict | None:
        return None if self._dirty is None else self._dirty.status_view()

    def mark_all_dirty(self, reason: str) -> None:
        """Demand that the next pass be full (no-op without a dirty feed —
        every pass is full already). The store-recovery hook: an outage's
        end means an unknown set of events was swallowed, so the loss-free
        recovery contract is relist + treat-everything-as-changed."""
        if self._dirty is not None:
            self._dirty.mark_all(reason)

    # -- lifecycle (periodic mode) ------------------------------------------------

    def start_periodic(self, interval_s: float) -> None:
        # clear, don't assume fresh: under leader election the periodic
        # sweep is stopped on lease loss and restarted on re-acquire
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval_s,), name="reconcile", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.reconcile()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("periodic reconcile failed")

    # -- the sweep ----------------------------------------------------------------

    def reconcile(self, dry_run: bool = False, mode: str = "auto") -> dict:
        """One reconcile pass. ``mode``:

        - ``"auto"`` — event-driven when a dirty feed is attached: a
          ``dirty`` pass unless the anti-entropy interval elapsed or the
          dirty-set demands a full pass (startup, relist); ``full``
          otherwise (no feed ⇒ always full, the legacy behavior);
        - ``"full"`` / ``"dirty"`` — force either (the API's ?mode=;
          ``dirty`` without a feed degrades to ``full`` and says so).

        The report carries ``mode`` (which actually ran) so callers and
        the scale benchmark can assert which cost model they measured."""
        if mode not in ("auto", "full", "dirty"):
            raise ValueError(f"mode must be auto|full|dirty, got {mode!r}")
        if (not dry_run and self._store_gate is not None
                and not self._store_gate()):
            # store outage: hold the sweep (dry runs still pass — they
            # mutate nothing). Edge-triggered event; per-skip counter.
            self.store_skips += 1
            if not self._store_held:
                self._store_held = True
                with self._mu:
                    self._events.append(trace.stamp(
                        {"ts": time.time(), "dryRun": dry_run,
                         "action": "store-outage-hold"}))
            return {"dryRun": dry_run, "mode": "skipped",
                    "skipped": "store-outage", "visitedFamilies": 0,
                    "actions": [], "driftCount": 0, "durationMs": 0.0}
        if self._store_held:
            self._store_held = False
            with self._mu:
                self._events.append(trace.stamp(
                    {"ts": time.time(), "dryRun": dry_run,
                     "action": "store-outage-over"}))
        effective = mode
        if self._dirty is None:
            effective = "full"
        elif mode == "auto":
            full_due = (self._full_interval_s <= 0 or self._last_full is None
                        or (time.monotonic() - self._last_full
                            >= self._full_interval_s))
            effective = ("full" if full_due or self._dirty.full_pending
                         else "dirty")
        elif mode == "dirty" and self._dirty.full_pending and not dry_run:
            # a forced dirty pass must not silently skip the families a
            # gap/restart left unaccounted — honor the pending full
            effective = "full"

        t0 = time.perf_counter()
        actions: list[dict] = []
        # one self-rooted trace per loop pass (background cost must be
        # attributable too); via the HTTP route it rides the request trace
        with trace.pass_span(self._tracer, "reconcile.pass",
                             mode=effective, dryRun=dry_run) as span:
            if effective == "dirty":
                visited = self._reconcile_dirty(actions, dry_run)
            else:
                visited = self._reconcile_full(actions, dry_run)
            if span is not None:
                span.attrs["actions"] = len(actions)
                span.attrs["visitedFamilies"] = visited
        report = {
            "dryRun": dry_run,
            "mode": effective,
            "visitedFamilies": visited,
            "actions": actions,
            "driftCount": len(actions),
            "durationMs": round((time.perf_counter() - t0) * 1e3, 2),
        }
        self._registry.counter_inc(
            "reconcile_runs_total",
            {"dryRun": str(dry_run).lower(), "mode": effective},
            help="Reconcile sweeps executed")
        if not dry_run:
            with self._mu:
                self._last_report = report
        if actions:
            log.info("reconcile[%s]%s: %d repairs: %s", effective,
                     " (dry-run)" if dry_run else "", len(actions),
                     [a["action"] for a in actions])
        return report

    def _reconcile_full(self, actions: list[dict], dry_run: bool) -> int:
        if self._dirty is not None and not dry_run:
            # everything is about to be visited: the pending marks (and
            # any pending full) are subsumed. Events arriving DURING the
            # sweep stay pending — a family mutated mid-sweep is simply
            # revisited by the next dirty pass. If the sweep DIES before
            # finishing, the except below re-demands a full pass — the
            # families these consumed marks tracked must not fall into
            # the dirty-only gap until the next anti-entropy interval
            self._dirty.drain(consume_full=True)
            try:
                return self._full_body(actions, dry_run)
            except BaseException:
                self._dirty.mark_all("full-pass-aborted")
                raise
        return self._full_body(actions, dry_run)

    def _full_body(self, actions: list[dict], dry_run: bool) -> int:
        self._replay_queue_journal(actions, dry_run)
        families = self.versions.snapshot()
        members = self._runtime_members()

        for base in sorted(families):
            if self._svc is not None and not dry_run:
                with self._svc.family_lock(base):
                    # under the lock, re-probe fresh — the pre-lock
                    # snapshot may predate a concurrent mutation (the
                    # snapshot's members ride along as probe candidates)
                    self._reconcile_family(base, actions, dry_run,
                                           hint=members.get(base, {}))
            else:
                self._reconcile_family(base, actions, dry_run,
                                       members=members.get(base, {}))
        for base in sorted(set(members) - set(families)):
            self._reconcile_orphan(base, actions, dry_run,
                                   hint=members.get(base, {}))
        self._sweep_foreign_owners(actions, dry_run)
        if not dry_run:
            self._last_full = time.monotonic()
        return len(families) + len(set(members) - set(families))

    def _reconcile_dirty(self, actions: list[dict], dry_run: bool) -> int:
        """O(changes) pass: only families the watch stream marked since
        the last drain, plus the adoption prefixes (queue journal,
        admission records, service fleets — each a bounded scan of
        PENDING work, not of the object space). The structural sweeps
        that inherently need the full world (unadoptable-orphan removal,
        the foreign-owner leak sweep) belong to the anti-entropy full
        pass and are deliberately absent here."""
        from tpu_docker_api_torch.service.crashpoints import crash_point

        drained = self._dirty.peek() if dry_run else self._dirty.drain()
        try:
            crash_point("reconcile.dirty_drained")
            self._replay_queue_journal(actions, dry_run)
            for base in sorted(drained[Resource.CONTAINERS.value]):
                if self.versions.get(base) is not None:
                    if self._svc is not None and not dry_run:
                        with self._svc.family_lock(base):
                            self._reconcile_family(base, actions, dry_run)
                    else:
                        self._reconcile_family(
                            base, actions, dry_run,
                            members=self._family_members(base))
                else:
                    # pointer gone: adopt from stored versions, or nothing
                    # (unadoptable runtime leftovers have no KV trace and
                    # therefore no event — the full pass removes those)
                    self._reconcile_orphan(base, actions, dry_run)
        except BaseException:
            # the pass died mid-way (SimulatedCrash, store outage): the
            # un-repaired families must not vanish from the books — give
            # the whole drained batch back (repairing twice is safe,
            # skipping is not)
            if not dry_run:
                self._dirty.reinsert(drained)
            raise
        return sum(len(s) for s in drained.values())

    def _replay_queue_journal(self, actions: list[dict],
                              dry_run: bool) -> None:
        """Adopt the durable work queue's journal: replay every pending /
        in-flight record a dead daemon left behind, exactly once, in
        submit order (state/workqueue.py). Runs FIRST so the family passes
        judge the post-replay world — an interrupted rolling-replace copy
        finishes forward rather than being rolled back as drift. Dry-run
        reports the replayable records without executing them."""
        if self._wq is None:
            return
        if dry_run:
            try:
                pending = self._wq.journal_replayable()
            except Exception as e:  # noqa: BLE001 — a store outage must
                # not abort the sweep; the journal is re-read next pass
                log.warning("reconcile: journal scan failed: %s", e)
                return
            for rec in pending:
                self._act(actions, True, "replay-task", rec.label(),
                          kind=rec.kind)
            return
        # SimulatedCrash (BaseException) propagates — that is the chaos
        # harness's kill; real task failures dead-letter inside the queue,
        # and a store outage on the journal scan skips to the next pass
        try:
            outcomes = self._wq.replay_journal()
        except Exception as e:  # noqa: BLE001
            log.warning("reconcile: journal replay failed: %s", e)
            return
        for outcome in outcomes:
            self._act(actions, False, "replay-task", outcome["target"],
                      kind=outcome["kind"], result=outcome["state"])

    def events_view(self, limit: int = 100) -> list[dict]:
        with self._mu:
            return list(self._events)[-limit:]

    def last_report(self) -> dict | None:
        with self._mu:
            return self._last_report

    # -- helpers ------------------------------------------------------------------

    def _runtime_members(self) -> dict[str, dict[int, str]]:
        out: dict[str, dict[int, str]] = {}
        for name in self.runtime.container_list():
            base, version = split_versioned_name(name)
            if version is not None:
                out.setdefault(base, {})[version] = name
        return out

    def _act(self, actions: list[dict], dry_run: bool, action: str,
             target: str, fn=None, **detail) -> None:
        entry = {"action": action, "target": target, **detail}
        actions.append(entry)
        self._registry.counter_inc("reconcile_actions_total",
                                   {"action": action, "dryRun": str(dry_run).lower()},
                                   help="Drift repairs by kind")
        log.info("reconcile%s: %s %s %s", " (dry-run)" if dry_run else "",
                 action, target, detail or "")
        if fn is not None and not dry_run:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — one failing repair must
                # not abort the sweep; the remaining families still get fixed
                # and the failure is visible in the report/events/metrics
                entry["error"] = f"{type(e).__name__}: {e}"
                self._registry.counter_inc(
                    "reconcile_action_failures_total", {"action": action},
                    help="Drift repairs that raised")
                log.warning("reconcile: %s %s failed: %s", action, target,
                            entry["error"])
        with self._mu:
            self._events.append(trace.stamp(
                {"ts": time.time(), "dryRun": dry_run, **entry}))

    #: what a CORRUPT stored record raises, as opposed to absent
    #: (NotExistInStore) or unreachable (StoreUnavailable): truncated/
    #: garbage JSON is json.JSONDecodeError (a ValueError); a structurally
    #: wrong payload trips from_dict's KeyError/TypeError/AttributeError
    POISON_ERRORS = (ValueError, KeyError, TypeError, AttributeError)

    def _quarantine(self, actions: list[dict], dry_run: bool,
                    resource: str, target: str, exc: BaseException) -> None:
        """Poison-record quarantine: one family whose latest record cannot
        even be PARSED must not wedge the whole sweep (before this, a
        corrupt container record aborted the full pass — every family
        after it, job repair and all adoption included, silently skipped
        forever). The family is skipped — loudly: a typed event, the
        ``reconcile_quarantined_total`` counter, a WARNING — and every
        other family still converges. No automatic rollback: destroying a
        version record the operator may be able to repair by hand is not
        the sweep's call."""
        self._registry.counter_inc(
            "reconcile_quarantined_total", {"resource": resource},
            help="Families skipped because their stored record is corrupt")
        self._act(actions, dry_run, "quarantine-poison-record", target,
                  resource=resource, error=f"{type(exc).__name__}: {exc}")
        log.warning("reconcile: quarantined %s (%s record unparseable: %s)",
                    target, resource, exc)

    def _family_members(self, base: str,
                        hint=None) -> dict[int, str]:
        """Runtime members of one family, by BOUNDED candidate probing:
        inspect only the versions the store knows (history + the latest
        pointer) plus the caller's hint (the sweep's one runtime listing,
        when it has one) — never a full ``container_list`` per family.
        The old per-family full listing made a locked sweep O(N) runtime
        calls PER FAMILY, i.e. O(N²) per pass at O(100k) objects. A
        runtime container whose version has no KV trace at all is
        invisible to the probe — exactly the unadoptable-orphan case the
        full pass's one-listing orphan sweep owns."""
        candidates: set[int] = set(
            self.store.history(Resource.CONTAINERS, base))
        latest = self.versions.get(base)
        if latest is not None:
            candidates.add(latest)
        if hint:
            candidates.update(hint)
        out: dict[int, str] = {}
        for v in sorted(candidates):
            name = versioned_name(base, v)
            if self.runtime.container_exists(name):
                out[v] = name
        return out

    # -- per-family repair --------------------------------------------------------

    def _reconcile_family(self, base: str, actions: list[dict],
                          dry_run: bool, members: dict[int, str] | None = None,
                          hint=None) -> None:
        for _ in range(_MAX_FAMILY_PASSES):
            if members is None:
                # locked path: probe fresh under the family lock; refreshed
                # only after a structural repair — the only time it can
                # change. Unlocked/dry-run callers pass the sweep's snapshot
                members = self._family_members(base, hint=hint)
            structural = self._family_pass(base, members, actions, dry_run)
            if not structural or dry_run:
                # dry-run stops at the first structural repair: the cascade
                # cannot be predicted without applying it
                return
            members = None
        log.warning("reconcile: family %s did not settle in %d passes",
                    base, _MAX_FAMILY_PASSES)

    def _family_pass(self, base: str, members: dict[int, str],
                     actions: list[dict], dry_run: bool) -> bool:
        """One structural evaluation. Returns True when it made (or, in
        dry-run, planned) a structural change that warrants re-evaluation."""
        latest = self.versions.get(base)
        if latest is None:
            return False
        latest_name = versioned_name(base, latest)

        try:
            state = self.store.get_container(latest_name)
        except self.POISON_ERRORS as e:
            self._quarantine(actions, dry_run, "containers", latest_name, e)
            return False
        except errors.NotExistInStore:
            # crash between version bump and spec persist: pointer with no
            # spec — roll back to the newest version that is stored
            stored = self.store.history(Resource.CONTAINERS, base)
            prev = max((v for v in stored if v < latest), default=None)
            if prev is None:
                self._act(actions, dry_run, "drop-empty-family", base,
                          fn=lambda: self.versions.remove(base))
                # members the dying flow already created can never be
                # adopted (no spec survived the crash) — remove them in
                # THIS sweep, not one orphan pass later: the repair must
                # be a fixpoint
                for v in sorted(members):
                    name = members[v]
                    self._act(actions, dry_run, "remove-orphan", name,
                              fn=lambda n=name: self.runtime.container_remove(
                                  n, force=True))
                self._release_all(base, actions, dry_run)
                return False
            self._act(actions, dry_run, "rollback-version-pointer", latest_name,
                      to=prev, fn=lambda: self.versions.rollback(base, prev))
            return True

        spec = ContainerSpec.from_dict(state.spec)
        try:
            info = self.runtime.container_inspect(latest_name)
        except errors.ContainerNotExist:
            info = None

        if info is None:
            present = sorted(v for v in members if v != latest)
            if present:
                # latest is gone but an older version survives — adopt it
                target = max(present)
                self._act(actions, dry_run, "rollback-latest-missing",
                          latest_name, to=target,
                          fn=lambda: self.versions.rollback(base, target))
                return True
            # whole family removed out-of-band: free its resources and
            # record that it is no longer desired (stable repair)
            if state.desired_running:
                def _mark_lost():
                    state.desired_running = False
                    self.store.put_container(state)
                self._act(actions, dry_run, "mark-family-lost", latest_name,
                          fn=_mark_lost)
            self._reconcile_resources(base, spec, desired=False,
                                      actions=actions, dry_run=dry_run)
            return False

        older_running = sorted(
            n for v, n in members.items()
            if v != latest and self._running(n))

        if not info.running and state.desired_running:
            if info.status == "created" and members.keys() - {latest}:
                # half-completed rolling replacement: the new version never
                # started and the old one (with the data) is still around —
                # roll back through the service's own compensation recipe
                old_name = versioned_name(
                    base, max(v for v in members if v != latest))
                self._act(actions, dry_run, "rollback-half-replacement",
                          latest_name, keep=old_name,
                          fn=lambda: self._undo_replacement(
                              base, old_name, latest_name))
                return True
            if info.status == "created":
                # created-not-started with no predecessor (crash between
                # create and first start): finish forward, nothing to migrate
                self._act(actions, dry_run, "start-created", latest_name,
                          fn=lambda: self.runtime.container_start(latest_name))
            else:
                self._restart_dead(base, latest_name, spec, actions, dry_run)
        elif info.running and not state.desired_running:
            # user asked for stop but the runtime disagrees (ambiguous stop)
            self._act(actions, dry_run, "stop-undesired", latest_name,
                      fn=lambda: self.runtime.container_stop(latest_name))

        for name in older_running:
            # two live versions of one family: the latest is authoritative —
            # retire the stale one (kept stopped, as after a normal replace)
            self._act(actions, dry_run, "retire-stale-version", name,
                      fn=lambda n=name: self.runtime.container_stop(n))

        self._reconcile_resources(base, spec, desired=state.desired_running,
                                  actions=actions, dry_run=dry_run)
        return False

    def _running(self, name: str) -> bool:
        try:
            return self.runtime.container_inspect(name).running
        except errors.ContainerNotExist:
            return False

    def _undo_replacement(self, base: str, old_name: str, new_name: str) -> None:
        if self._svc is not None:
            self._svc._undo_new_version(base, old_name, new_name)
            return
        # standalone fallback: same recipe, inline
        try:
            spec = ContainerSpec.from_dict(self.store.get_container(new_name).spec)
            self.ports.restore_ports(
                [pb.host_port for pb in spec.port_bindings], owner=base)
        except errors.NotExistInStore:
            pass
        if self.runtime.container_exists(new_name):
            self.runtime.container_remove(new_name, force=True)
        self.store.delete_version(Resource.CONTAINERS, new_name)
        _, old_version = split_versioned_name(old_name)
        self.versions.rollback(base, old_version)

    def _restart_dead(self, base: str, latest_name: str, spec: ContainerSpec,
                      actions: list[dict], dry_run: bool) -> None:
        """desired_running=true but the container is dead. A crash never
        releases chips/ports, but a crash *mid-replace* may have (the
        quiesce step frees the old ports) — re-claim before restarting so
        scheduler accounting matches the running container again."""
        port_conflicts, err_p = self._guarded_claim(
            self.ports.try_claim_ports, self._scheduled_ports(spec), base,
            dry_run)
        chip_conflicts, err_c = self._guarded_claim(
            self.chips.try_claim_chips, spec.chip_ids, base, dry_run)
        conflicts = port_conflicts + chip_conflicts
        if conflicts or err_p or err_c:
            # someone else holds the resources (or the claim itself failed):
            # restarting would double-bind — report and leave for next sweep
            self._act(actions, dry_run, "restart-blocked", latest_name,
                      conflicts=conflicts,
                      **({"error": err_p or err_c} if err_p or err_c else {}))
            return
        self._act(actions, dry_run, "restart-dead", latest_name,
                  fn=lambda: self.runtime.container_restart(latest_name))

    # -- orphans ------------------------------------------------------------------

    def _reconcile_orphan(self, base: str, actions: list[dict],
                          dry_run: bool, hint=None) -> None:
        """Runtime containers whose family has no version pointer."""
        if self._svc is not None and not dry_run:
            with self._svc.family_lock(base):
                self._orphan_pass(base, actions, dry_run, hint)
        else:
            self._orphan_pass(base, actions, dry_run, hint)

    def _orphan_pass(self, base: str, actions: list[dict],
                     dry_run: bool, hint=None) -> None:
        # re-check under the family lock: the pre-sweep snapshot may predate
        # a concurrent create (version bumped, container just created) —
        # force-removing that "orphan" would delete a container mid-build
        if self.versions.get(base) is not None:
            return
        members = self._family_members(base, hint=hint)
        if not members:
            return
        stored = set(self.store.history(Resource.CONTAINERS, base))
        adoptable = sorted(v for v in members if v in stored)
        if adoptable:
            target = adoptable[-1]
            self._act(actions, dry_run, "adopt-orphan",
                      versioned_name(base, target), version=target,
                      fn=lambda: self.versions.set(base, target))
            if not dry_run:
                self._reconcile_family(base, actions, dry_run)
            return
        for v in sorted(members):
            name = members[v]
            self._act(actions, dry_run, "remove-orphan", name,
                      fn=lambda n=name: self.runtime.container_remove(
                          n, force=True))

    # -- resource accounting ------------------------------------------------------

    def _guarded_claim(self, claim, items: list[int], owner: str,
                       dry_run: bool) -> tuple[list[int], str]:
        """Run a try_claim_* with the same error isolation _act gives fn
        callbacks: a KV hiccup mid-claim must not abort the sweep."""
        if dry_run:
            return [], ""
        try:
            return claim(items, owner=owner), ""
        except Exception as e:  # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
            self._registry.counter_inc(
                "reconcile_action_failures_total", {"action": "reclaim"},
                help="Drift repairs that raised")
            log.warning("reconcile: reclaim for %s failed: %s", owner, err)
            return [], err

    def _scheduled_ports(self, spec: ContainerSpec) -> list[int]:
        """Host ports the scheduler has jurisdiction over. Explicit
        user-specified ports outside [start_port, end_port] were never
        pool-allocated — treating them as expected claims would report
        phantom conflicts on every sweep."""
        return [pb.host_port for pb in spec.port_bindings
                if pb.host_port
                and self.ports.start_port <= pb.host_port <= self.ports.end_port]

    def _reconcile_resources(self, base: str, spec: ContainerSpec,
                             desired: bool, actions: list[dict],
                             dry_run: bool) -> None:
        """Converge scheduler ownership to exactly the latest spec's claim:
        a family that wants to run owns its spec's chips/ports, a stopped or
        lost family owns nothing. Frees are owner-guarded (``restore_*``
        skips resources re-allocated to someone else — no double-free)."""
        expected_chips = set(spec.chip_ids) if desired else set()
        owned_chips = set(self.chips.owned_chips(base))
        extra = sorted(owned_chips - expected_chips)
        if extra:
            self._act(actions, dry_run, "free-leaked-chips", base, chips=extra,
                      fn=lambda: self.chips.restore_chips(extra, owner=base))
        missing = sorted(expected_chips - owned_chips)
        if missing:
            conflicts, err = self._guarded_claim(
                self.chips.try_claim_chips, missing, base, dry_run)
            self._act(actions, dry_run,
                      "chips-conflict" if conflicts else "reclaim-chips",
                      base, chips=missing,
                      **({"conflicts": conflicts} if conflicts else {}),
                      **({"error": err} if err else {}))

        expected_ports = set(self._scheduled_ports(spec)) if desired else set()
        owned_ports = {p for p, o in self.ports.status()["owners"].items()
                       if o == base}
        extra_p = sorted(owned_ports - expected_ports)
        if extra_p:
            self._act(actions, dry_run, "free-leaked-ports", base, ports=extra_p,
                      fn=lambda: self.ports.restore_ports(extra_p, owner=base))
        missing_p = sorted(expected_ports - owned_ports)
        if missing_p:
            conflicts, err = self._guarded_claim(
                self.ports.try_claim_ports, missing_p, base, dry_run)
            self._act(actions, dry_run,
                      "ports-conflict" if conflicts else "reclaim-ports",
                      base, ports=missing_p,
                      **({"conflicts": conflicts} if conflicts else {}),
                      **({"error": err} if err else {}))

    def _release_all(self, base: str, actions: list[dict],
                     dry_run: bool) -> None:
        chips = self.chips.owned_chips(base)
        if chips:
            self._act(actions, dry_run, "free-leaked-chips", base, chips=chips,
                      fn=lambda: self.chips.restore_chips(chips, owner=base))
        ports = sorted(p for p, o in self.ports.status()["owners"].items()
                       if o == base)
        if ports:
            self._act(actions, dry_run, "free-leaked-ports", base, ports=ports,
                      fn=lambda: self.ports.restore_ports(ports, owner=base))

    def _sweep_foreign_owners(self, actions: list[dict], dry_run: bool) -> None:
        """Chips/ports whose owner is no known family — freed. Owners from
        shared version maps (the job service allocates from the same pools)
        are left alone."""
        known: set[str] = set(self.versions.snapshot())
        known |= set(self._runtime_members())
        for vm in self._shared_maps:
            known |= set(vm.snapshot())
        known.add("")  # anonymous allocations are not ours to judge

        def _is_known(owner: str) -> bool:
            # job claims are keyed by VERSIONED owner ("train-1",
            # "train-1#s0") while version maps key by base — map back
            # before judging, or every live job's chips/ports read as leaks
            return owner in known or job_owner_base(owner) in known

        chip_owners: dict[str, list[int]] = {}
        for c in self.chips.status()["chips"]:
            if c["used"]:
                chip_owners.setdefault(c["owner"], []).append(c["chipId"])
        for owner, ids in sorted(chip_owners.items()):
            if not _is_known(owner):
                self._act(actions, dry_run, "free-leaked-chips", owner,
                          chips=ids,
                          fn=lambda o=owner, i=ids: self._free_foreign(
                              self.chips.restore_chips, o, i))

        port_owners: dict[str, list[int]] = {}
        for p, o in self.ports.status()["owners"].items():
            port_owners.setdefault(o, []).append(p)
        for owner, ps in sorted(port_owners.items()):
            if not _is_known(owner):
                self._act(actions, dry_run, "free-leaked-ports", owner,
                          ports=sorted(ps),
                          fn=lambda o=owner, i=ps: self._free_foreign(
                              self.ports.restore_ports, o, i))

    def _free_foreign(self, restore, owner: str, items: list[int]) -> None:
        """Free an unknown owner's claim — re-checked under the owner's
        family lock: run_container claims chips BEFORE its version pointer
        or container exists, so the sweep's pre-claim snapshot could
        misread an in-flight create as a leak and free chips out from
        under it. Under the lock the create has either finished (owner
        known now → skip) or rolled back (restore is an owner-guarded
        no-op)."""
        lock = (self._svc.family_lock(owner) if self._svc is not None
                else contextlib.nullcontext())
        with lock:
            if self.versions.get(owner) is not None:
                return
            base = job_owner_base(owner)
            if any(vm.get(owner) is not None or vm.get(base) is not None
                   for vm in self._shared_maps):
                return
            if owner in self._runtime_members():
                return
            restore(items, owner=owner)
