"""Gang-aware job supervision (docs/robustness.md).

The per-container ``HealthWatcher`` closes the single-container failure gap;
this supervisor closes the distributed one. A multi-host job is ONE
``torch.distributed`` world: when a member dies, every surviving member is
wedged at the next collective op — restarting the dead member alone rejoins a
barrier nobody else will reach. The standard training-stack answer is gang
semantics:

- **whole-gang restart** — on any member death, stop all survivors (workers
  first, coordinator last) and restart the full gang in process order
  (coordinator first), resuming from the shared checkpoint binds;
- **exponential backoff with jitter** between gang restarts, so a pod-wide
  fault does not synchronize a thundering herd of restarts;
- **bounded restart budget** — a crash-looping job converges to the terminal
  ``failed`` phase, its slices and ports are freed for the next job, and the
  reason is surfaced via ``GET /api/v1/jobs/{name}`` and the events ring.

The supervisor polls member liveness across *all* pod hosts (the container
watcher only sees the local runtime). The watcher delegates job members to
:meth:`handle_member_death` and never restarts them itself.

Restart *counts* live on the persisted ``JobState`` so the budget survives a
daemon death; backoff *deadlines* are in-memory (monotonic clock) and reset
on restart — a fresh daemon retries once immediately, which is the safe
direction after an operator intervention.

Host failure domains (docs/robustness.md "Host failure domains") add the
disambiguation layer a restart-only supervisor lacks: a member whose host
engine is UNREACHABLE is neither dead nor missing — its state is unknown.
The supervisor consults the :class:`~tpu_docker_api_torch.service.host_health.
HostMonitor`: while the host is merely *suspect* (inside the grace window)
the gang is left completely alone — a sub-grace blip causes ZERO restarts;
once the host is confirmed *down*, the gang MIGRATES onto healthy hosts
(``JobService.migrate_gang``), charged to the separate
``job_max_migrations`` budget — a dead host must never eat the
crash-restart budget, because no restart can fix it.

The port's copy of ``tpu_docker_api/service/job_supervisor.py``, whole.
"""

from __future__ import annotations

import collections
import logging
import random
import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.fanout import SERIAL, Fanout
from tpu_docker_api_torch.schemas.job import DORMANT_PHASES
from tpu_docker_api_torch.state.keys import split_versioned_name, versioned_name
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY
from tpu_docker_api_torch.utils.backoff import backoff_delay_s

log = logging.getLogger(__name__)


class JobSupervisor:
    """Polls gang liveness; executes whole-gang recovery with backoff.

    ``clock`` and ``seed`` are injection seams for deterministic tests: the
    clock gates backoff deadlines (no sleeping inside ``poll_once``), the
    seed fixes the jitter draw.
    """

    def __init__(
        self,
        pod,
        job_svc,
        store,
        versions,
        interval_s: float = 5.0,
        max_restarts: int = 3,
        max_migrations: int = 3,
        backoff_base_s: float = 1.0,
        backoff_max_s: float = 60.0,
        backoff_jitter: float = 0.1,
        seed: int | None = None,
        clock=time.monotonic,
        registry: MetricsRegistry | None = None,
        max_events: int = 512,
        host_monitor=None,
        fanout: Fanout | None = None,
        owns=None,
        store_gate=None,
    ) -> None:
        self.pod = pod
        #: runtime fan-out: per-member liveness inspects run as one
        #: concurrent batch per family, so a poll's wall time is O(slowest
        #: host), not O(sum of hosts)
        self._fanout = fanout or SERIAL
        self._svc = job_svc
        self._store = store
        self._versions = versions
        #: sharded writer plane (daemon wiring): supervise only families
        #: whose shard this process leads; None ⇒ all (single-writer)
        self._owns = owns
        self._interval = interval_s
        self._max_restarts = max_restarts
        self._max_migrations = max_migrations
        #: HostMonitor (service/host_health.py) when host probing runs —
        #: the down/suspect verdicts that gate migration vs hands-off
        self.host_monitor = host_monitor
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self._backoff_jitter = backoff_jitter
        self._rng = random.Random(seed)
        self._clock = clock
        self._registry = registry if registry is not None else REGISTRY
        self._mu = threading.Lock()
        #: base → earliest monotonic time the next gang restart may run
        self._deadline: dict[str, float] = {}
        #: families THIS supervisor instance already attempted to restart —
        #: distinguishes "phase == restarting because a previous daemon died
        #: mid-restart" (adoption: finish without re-counting) from "our own
        #: last attempt failed" (the next attempt must consume budget)
        self._attempted: set[str] = set()
        #: same adoption bookkeeping for migrations (phase == "migrating")
        self._mig_attempted: set[str] = set()
        #: and for elastic resizes (phase == "scaling_down"/"scaling_up"):
        #: first sight finishes without re-counting, repeats count so the
        #: job_resize_max bound converges a thrashing resize to failed
        self._resize_attempted: set[str] = set()
        #: families currently observed behind an unreachable-but-not-down
        #: host — the host-blip event is recorded on ENTRY only, not every
        #: poll tick (a persistent blip must not evict the whole bounded
        #: event ring)
        self._blipped: set[str] = set()
        #: base → last poll's {deadMembers, missingMembers} — status_view
        #: serves this instead of re-inspecting every member per request
        self._last_obs: dict[str, dict] = {}
        #: store-outage hold (service/store_health.py): while the gate says
        #: the store cannot journal intent, the supervisor OBSERVES but does
        #: not act — a gang restart decided on state we cannot re-read or
        #: record would be indistinguishable from a spurious one. None ⇒
        #: ungated (byte-for-byte the pre-brownout behavior).
        self._store_gate = store_gate
        self.store_skips = 0
        self._store_held = False
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._stop = threading.Event()
        #: set by handle_member_death to cut the poll interval short — the
        #: watcher thread must never run gang recovery inline (it would
        #: block behind the family lock and stall liveness polling)
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        # gang lifecycle transitions the service performs (manual restarts,
        # fail/stop) land in the same ring the supervisor's own actions use
        job_svc.event_sink = self._service_event

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        # clear, don't assume fresh: under leader election the supervisor
        # is stopped on lease loss and restarted on re-acquire
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="job-supervise", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=self._interval + 5)
            self._thread = None

    def _loop(self) -> None:
        while True:
            self._wake.wait(self._interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the supervisor must survive
                log.exception("job supervision poll failed")

    # -- the watch loop ----------------------------------------------------------

    def poll_once(self) -> None:
        """One liveness scan over every job family; separated from the loop
        for tests."""
        if self._store_gate is not None and not self._store_gate():
            # store outage: hold the whole scan — recovery actions mutate
            # gang records, and a mutation that cannot land half-applies
            # the restart. Edge-triggered event; per-skip counter.
            self.store_skips += 1
            if not self._store_held:
                self._store_held = True
                self._record("store-outage-hold", "*")
            return
        if self._store_held:
            self._store_held = False
            self._record("store-outage-over", "*")
        families = sorted(self._versions.snapshot())
        if self._owns is not None:
            families = [b for b in families if self._owns(b)]
        for base in families:
            try:
                self._check_family(base)
            except Exception:  # noqa: BLE001 — one family (one flaky remote
                # engine) must not starve every other gang of supervision;
                # SimulatedCrash (BaseException) still propagates — that is
                # the chaos harness's kill
                log.exception("gang check of %s failed", base)
        with self._mu:
            for gone in set(self._last_obs) - set(families):
                self._last_obs.pop(gone, None)

    def handle_member_death(self, cname: str) -> bool:
        """Watcher delegation entry: returns True iff ``cname`` is a member
        of a known job — the caller must then NOT touch it. Recovery is NOT
        run inline (the watcher thread must not block behind a family lock
        mid-rescale); the supervisor's own loop is woken to handle it
        immediately instead of waiting out the poll interval."""
        base = self._svc.owns_member(cname)
        if base is None:
            return False
        self._record("member-died-delegated", base, member=cname)
        self._wake.set()
        return True

    def wake(self, *_args) -> None:
        """Cut the poll interval short (the HostMonitor's on_down hook:
        a confirmed-down host should start gang migration NOW)."""
        self._wake.set()

    # -- decision logic ----------------------------------------------------------

    def _check_family(self, base: str) -> None:
        latest = self._versions.get(base)
        if latest is None:
            return
        latest_name = versioned_name(base, latest)
        # NO family lock here: liveness polling fans out container_inspect
        # calls to every pod host, and a slow remote engine must not hold
        # this job's API flows (or the rest of the poll) hostage. Every
        # repair below re-validates state under the lock before mutating
        # (restart_gang rejects stopped/failed jobs, fail_job re-checks the
        # budget via only_if_restarts_ge, mark_gang_* re-read the phase).
        try:
            st = self._store.get_job(latest_name)
        except errors.NotExistInStore:
            return  # half-created version; the reconciler's jurisdiction
        if not st.desired_running or st.phase in DORMANT_PHASES:
            # dormant covers queued/preempted too: a queued job has no
            # members to supervise, and a preempted gang's stopped members
            # are the admission controller's doing — restarting them would
            # undo the preemption and double-bind the freed capacity
            self._note_obs(base, [], [])
            return
        if st.phase in ("scaling_down", "scaling_up"):
            # a resize is in flight (or awaiting adoption after a daemon
            # death): finish it forward — liveness verdicts on a
            # deliberately half-stopped gang would only misfire
            self._finish_resize(base, st)
            return
        dead, missing, crashed, unreachable = self._member_liveness(st)
        self._note_obs(base, dead, missing, unreachable)
        down = sorted(h for h in unreachable if self._host_down(h))
        if down and st.phase != "migrating" and self._shrinkable(st, down,
                                                                unreachable):
            # elastic host-loss repair: SHRINK to the surviving hosts —
            # no restart-budget burn, no whole-gang migration, fewer
            # moved bytes; the lost members grow back through the
            # admission queue once capacity returns
            self._shrink_family(base, st, down, sorted(unreachable))
            return
        if st.phase == "migrating" or down:
            # host-down (or an interrupted migration to adopt): the repair
            # is migration, never a restart — a gang restart would re-place
            # members onto the same dead host via the still-held grant.
            # Exclude every OBSERVED-unreachable host too, not just the
            # monitor-confirmed ones: down verdicts are in-memory and reset
            # with the daemon, so an adoption in the fresh grace window
            # would otherwise re-place onto the still-dead host and burn
            # the budget on placements that cannot start (the reconciler's
            # adoption path applies the same rule)
            self._migrate_family(base, st, down, sorted(unreachable))
            return
        if unreachable:
            # sub-grace blip (or no monitor to confirm down-ness): hands
            # off ENTIRELY — zero restarts. Recovery would fail against the
            # unreachable engine anyway, and the members there may be fine
            if base not in self._blipped:
                self._blipped.add(base)
                self._record("host-blip", base, hosts=unreachable)
            return
        if base in self._blipped:
            self._blipped.discard(base)
            self._record("host-blip-over", base)
        if missing:
            self._record("job-member-missing", base, members=missing)
            self._try_repair(base, lambda: self._svc.fail_job(
                base, f"member container(s) {missing} no longer exist"))
            return
        if not dead:
            if st.phase == "restarting":
                # adopted mid-restart and every member runs: settle
                self._svc.mark_gang_running(base)
                self._record("gang-settled", base)
            return
        if st.phase != "restarting" and not crashed:
            # every dead member exited 0 — completion, not a crash. The
            # whole gang down = the job finished; a partial clean exit is
            # an early finisher whose peers are still wrapping up — never
            # a reason to bounce the gang or burn budget
            if len(dead) == len(st.placements):
                self._try_repair(
                    base, lambda: self._svc.mark_gang_completed(base))
            return
        finishing = (st.phase == "restarting"
                     and base not in self._attempted)
        if st.restarts >= self._max_restarts and not finishing:
            self._record("job-crash-loop", base, restarts=st.restarts,
                         members=dead)
            self._try_repair(base, lambda: self._svc.fail_job(
                base, f"crash loop: {st.restarts} gang restarts "
                f"exhausted (dead members: {dead})",
                only_if_restarts_ge=self._max_restarts))
            return
        now = self._clock()
        with self._mu:
            deadline = self._deadline.get(base, 0.0)
        if now < deadline:
            self._record("gang-restart-deferred", base, members=dead,
                         wait_s=round(deadline - now, 3))
            return
        # schedule the NEXT attempt before acting: if the restart kills
        # the daemon, the replacement still observes a backoff gap
        delay = self._next_delay(st.restarts)
        with self._mu:
            self._deadline[base] = now + delay
        self._record("gang-restarting", base, members=dead,
                     attempt=st.restarts + (0 if finishing else 1),
                     backoff_s=round(delay, 3))
        self._attempted.add(base)
        try:
            self._svc.restart_gang(
                base, reason=f"member(s) died: {dead}",
                count_restart=not finishing)
            self._counter("gang_restarts_total")
        except errors.ApiError as e:
            # attempt burned (restart_gang counts BEFORE acting), backoff
            # armed; retried next poll until the budget converges the
            # job to failed. Also the stale-snapshot path: a user stop
            # that raced in makes restart_gang decline loudly
            self._record("gang-restart-failed", base, error=str(e))

    def _migrate_family(self, base: str, st, down: list[str],
                        unreachable: list[str]) -> None:
        """Host-fault repair: move the gang off ``down`` (and currently
        unreachable) hosts, bounded by the migration budget (separate from
        crash restarts — a dead host is not the workload's fault). Both
        lists may be empty when adopting an interrupted migration whose
        bad host has since recovered."""
        finishing = (st.phase == "migrating"
                     and base not in self._mig_attempted)
        if st.migrations >= self._max_migrations and not finishing:
            self._record("job-migration-loop", base,
                         migrations=st.migrations, hosts=down)
            self._try_repair(base, lambda: self._svc.fail_job(
                base, f"host(s) {down} down: {st.migrations} migrations "
                "exhausted",
                only_if_migrations_ge=self._max_migrations))
            return
        self._record("gang-migrating", base, hosts=down,
                     attempt=st.migrations + (0 if finishing else 1))
        self._mig_attempted.add(base)
        try:
            self._svc.migrate_gang(
                base, exclude_hosts=set(down) | set(unreachable),
                reason=f"host(s) down: {down}" if down
                else "finishing interrupted migration",
                count_migration=not finishing)
            self._counter("gang_migrations_total")
        except errors.ApiError as e:
            # attempt burned (migrate_gang counts BEFORE acting); retried
            # next poll until capacity appears or the budget converges the
            # job to failed
            self._record("gang-migrate-failed", base, error=str(e))

    def _shrinkable(self, st, down: list[str],
                    unreachable: list[str]) -> bool:
        """True when a host-loss can be absorbed by an elastic shrink:
        resizing enabled, the gang is elastic and running (an interrupted
        restart keeps its restart-path repair), the survivors stay at or
        above ``min_members``, and the count heuristic says the shrunken
        gang can re-place on the healthy hosts (own grant freed, bad
        hosts excluded) — otherwise the migrate/fail path keeps
        jurisdiction."""
        if not (getattr(self._svc, "resize_enabled", True) and st.elastic
                and st.num_slices == 1 and st.phase == "running"):
            return False
        bad = set(down) | set(unreachable)
        survivors = sum(1 for h, *_ in st.placements if h not in bad)
        if not max(st.min_members, 1) <= survivors < len(st.placements):
            return False
        per_host = self.pod.chips_per_host
        return self._svc.slices.fits(
            survivors * per_host, 1, assume_freed={st.job_name},
            exclude_hosts=bad)

    def _shrink_family(self, base: str, st, down: list[str],
                       unreachable: list[str]) -> None:
        """Elastic host-loss repair: resize to the surviving members.
        Charged to NEITHER the restart nor the migration budget — a
        shrink is the reaction that makes host loss survivable, and the
        gang grows back through the admission queue."""
        bad = set(down) | set(unreachable)
        survivors = sum(1 for h, *_ in st.placements if h not in bad)
        self._record("gang-shrinking", base, hosts=down,
                     fromMembers=len(st.placements), toMembers=survivors)
        self._resize_attempted.add(base)
        try:
            self._svc.resize_gang(
                base, survivors, exclude_hosts=bad,
                reason="host-down")
            self._counter("gang_shrinks_total")
        except errors.ApiError as e:
            # the resize ladder already tried every legal size (and, with
            # the market enabled, parked the gang preempted); anything
            # else is retried next poll, falling back to migrate once the
            # shrink stops being feasible
            self._record("gang-shrink-failed", base, error=str(e))

    def _finish_resize(self, base: str, st) -> None:
        """Adopt an in-flight resize (daemon died mid-resize, or our own
        last attempt failed): finish it forward toward the persisted
        ``last_resize`` target, excluding the hosts the intent recorded.
        The intent's ``attempts`` counter (bumped on every retry of THIS
        resize — never the lifetime ``resizes`` count) bounds the loop:
        past ``job_resize_max`` a never-settling resize converges to
        terminal failed."""
        finishing = base not in self._resize_attempted
        resize_max = getattr(self._svc, "resize_max", 8)
        lr = st.last_resize or {}
        attempts = int(lr.get("attempts", 1))
        if attempts >= resize_max and not finishing:
            self._record("job-resize-loop", base, attempts=attempts)
            self._try_repair(base, lambda: self._svc.fail_job(
                base, f"resize loop: {attempts} attempts exhausted",
                only_if_resize_attempts_ge=resize_max))
            return
        target = int(lr.get("toMembers") or len(st.placements) or 1)
        exclude = set(lr.get("excludeHosts") or ())
        self._record("gang-resize-adopted", base, toMembers=target,
                     attempt=attempts + (0 if finishing else 1))
        self._resize_attempted.add(base)
        try:
            self._svc.resize_gang(
                base, target, exclude_hosts=exclude,
                reason="adoption", count_resize=not finishing)
            self._counter("gang_shrinks_total")
        except errors.ApiError as e:
            self._record("gang-resize-failed", base, error=str(e))

    def _host_down(self, host_id: str) -> bool:
        """Confirmed down = the monitor's verdict (grace window elapsed).
        Without a monitor, unreachability alone NEVER condemns a host —
        hands-off is the safe default for an unprovable fault."""
        return (self.host_monitor is not None
                and self.host_monitor.is_down(host_id))

    def _try_repair(self, base: str, fn) -> None:
        try:
            fn()
        except errors.ApiError as e:
            self._record("gang-repair-failed", base, error=str(e))

    def _member_liveness(
            self, st) -> tuple[list[str], list[str], bool, list[str]]:
        """(dead, missing, crashed, unreachable_hosts) over the latest
        version's members. ``crashed`` is True when any dead member
        actually failed — nonzero exit code, or created-but-never-started
        (an interrupted launch) — as opposed to a clean exit-0 completion.
        Members behind an unreachable engine are in NO other bucket: their
        state is unknown, and treating them as dead or missing is exactly
        the misclassification that burned restart budget on host faults."""
        def probe(host_id: str, cname: str):
            host = self.pod.hosts.get(host_id)
            if host is None:
                return ("missing", None)
            try:
                return ("info", host.runtime.container_inspect(cname))
            except errors.ContainerNotExist:
                return ("missing", None)
            except errors.HOST_PATH_ERRORS:
                return ("unreachable", host_id)

        # one concurrent batch over the whole gang: wall time is the
        # SLOWEST member inspect, not the sum — a slow or breaker-open
        # host no longer serializes behind every healthy one. Results are
        # positional, so the dead/missing lists keep placement order and
        # the verdicts below stay deterministic.
        results = self._fanout.run([
            (cname, "container_inspect",
             lambda h=host_id, c=cname: probe(h, c))
            for host_id, cname, *_ in st.placements])
        dead: list[str] = []
        missing: list[str] = []
        unreachable: list[str] = []
        crashed = False
        for (host_id, cname, *_), r in zip(st.placements, results):
            kind, payload = r.unwrap()
            if kind == "missing":
                missing.append(cname)
            elif kind == "unreachable":
                if payload not in unreachable:
                    unreachable.append(payload)
            elif not payload.running:
                dead.append(cname)
                if payload.exit_code != 0 or payload.status == "created":
                    crashed = True
        return dead, missing, crashed, unreachable

    def _note_obs(self, base: str, dead: list[str], missing: list[str],
                  unreachable: list[str] | None = None) -> None:
        with self._mu:
            self._last_obs[base] = {"deadMembers": dead,
                                    "missingMembers": missing,
                                    "unreachableHosts": unreachable or []}

    def _next_delay(self, restarts: int) -> float:
        """min(cap, base·2^n), then ±jitter so a pod-wide fault does not
        restart every gang in lockstep."""
        return backoff_delay_s(restarts, self._backoff_base_s,
                               self._backoff_max_s, self._backoff_jitter,
                               self._rng)

    def _forget(self, base: str) -> None:
        with self._mu:
            self._deadline.pop(base, None)
        self._attempted.discard(base)
        self._mig_attempted.discard(base)
        self._resize_attempted.discard(base)
        self._blipped.discard(base)

    # -- events / views ----------------------------------------------------------

    def _counter(self, name: str) -> None:
        self._registry.counter_inc(
            name, help={"gang_restarts_total":
                        "Whole-gang restarts executed by the job supervisor",
                        "gang_migrations_total":
                        "Whole-gang migrations off unhealthy hosts",
                        "gang_shrinks_total":
                        "Elastic gang resizes driven by the supervisor "
                        "(host-loss shrinks + resize adoptions)",
                        "jobs_failed_total":
                        "Jobs driven to the terminal failed phase"}[name])

    def _service_event(self, kind: str, job_name: str, **detail) -> None:
        if kind in ("job-restarted", "job-stopped", "job-failed",
                    "job-completed"):
            # manual restart = fresh start (restart_job reset the persisted
            # budget — the in-memory backoff deadline must reset with it);
            # stop/fail make any armed deadline meaningless
            base, _ = split_versioned_name(job_name)
            self._forget(base)
        if kind == "job-failed":
            # EVERY terminal transition counts — the supervisor's own
            # crash-loop verdicts, the reconciler's boot-time ones, and
            # manual fail_job calls all flow through this sink
            self._counter("jobs_failed_total")
        self._record(kind, job_name, **detail)

    def _record(self, kind: str, job: str, **extra) -> None:
        evt = trace.stamp({"ts": time.time(), "job": job, "event": kind,
                           **extra})
        with self._mu:
            self._events.append(evt)
        log.info("job event: %s %s %s", job, kind, extra or "")

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            return list(self._events)[-limit:]

    def status_view(self) -> dict:
        """GET /api/v1/health/jobs — per-family gang status. Liveness comes
        from the LAST poll's observation (O(1) I/O per request): a hung
        remote engine must not wedge an operator dashboard refresh."""
        now = self._clock()
        out: dict[str, dict] = {}
        for base, latest in sorted(self._versions.snapshot().items()):
            try:
                st = self._store.get_job(versioned_name(base, latest))
            except errors.NotExistInStore:
                continue
            with self._mu:
                deadline = self._deadline.get(base, 0.0)
                obs = dict(self._last_obs.get(
                    base, {"deadMembers": [], "missingMembers": [],
                           "unreachableHosts": []}))
            out[base] = {
                "version": latest,
                "phase": st.phase,
                "priorityClass": st.priority_class,
                "desiredRunning": st.desired_running,
                "restarts": st.restarts,
                "maxRestarts": self._max_restarts,
                "migrations": st.migrations,
                "maxMigrations": self._max_migrations,
                **obs,
                "backoffRemainingS": round(max(0.0, deadline - now), 3),
                **({"failureReason": st.failure_reason}
                   if st.failure_reason else {}),
                **self._svc.elastic_info(st),
            }
        return {"jobs": out, "backoffBaseS": self._backoff_base_s,
                "backoffMaxS": self._backoff_max_s}
