"""Service resource: declarative replicated serving with SLO-driven
autoscaling through the capacity market (docs/robustness.md
"Service & autoscaler").

The control plane schedules opaque containers while ``infer/`` carries a
production serving stack whose load the scheduler never sees. This module
closes the loop:

- a **Service** owns N replica gangs — each replica a real distributed job
  (family ``<service>.r<index>``) created through the existing gang
  machinery, so replicas inherit supervision, host-fault migration, chaos
  convergence and the capacity market for free;
- the service itself is persisted **exactly like a job**: immutable spec
  versions plus a ``latest`` pointer, committed in one atomic ``KV.apply``
  (``StateStore._put``); a weight/spec update is a new service version
  rolled replica-by-replica through ``JobService.replace_job_spec`` — the
  same immutable-version rolling-replace sequencing rescales use;
- an **SLO-driven autoscaler loop** (a writer: leader-only under leader
  election, crash-pointed like the admission loop) consumes per-replica
  serving signals — TTFT p95 and queue depth, scraped from a
  replica-reported metrics endpoint (``metrics_path`` on the replica's
  coordinator port; the real path reads the paged engine's SLO export)
  or synthesized from an offered-load model for fake-runtime replicas —
  and converges the replica count: breach ⇒ scale up (HPA-style
  ``ceil(ready × signal/target)``), sustained idle below the hysteresis
  watermark ⇒ scale down, both gated by cooldowns so an oscillating
  signal never flaps the fleet;
- **scale-up enters the capacity market** at the service's priority class
  (default ``production``): a full pool queues the new replica gang, and
  the admission loop preempts strictly-lower classes (``batch``/
  ``preemptible`` training) for it — the traffic-bursts-displace-training
  scenario the priority ladder was built for. **Scale-down** rides the
  gang quiesce (workers first, coordinator last) + one-batch release path.

Crash consistency: every durable transition is bracketed by labeled
``service.*`` crash points, and ``reconcile_services`` (driven by the
Reconciler) adopts whatever a dead daemon left — missing replicas are
created, surplus and orphan replica gangs torn down, interrupted deletes
and rolls finished — so a kill at any point converges to exactly one
fully-owned replica set, never a half-scaled orphan fleet.

The port's copy of ``tpu_docker_api/service/serving.py``, whole: the CRUD,
replica convergence, rolling spec updates, the synthetic load model and the
HTTP scrape (``urllib.request``), the autoscaler's decisions and loop, the
reconciler's adoption and the sharded writer plane's ``owns`` filter. A
replica gang runs the port's server (``python -m tpu_docker_api_torch.serve``)
under its rendered environment.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import math
import threading
import time
import urllib.request

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.schemas.job import JobDelete, JobRun
from tpu_docker_api_torch.schemas.service import (
    SERVICE_OWNER_ENV,
    ServiceCreate,
    ServicePatch,
    ServiceState,
    owner_from_env,
)
from tpu_docker_api_torch.service.container import _FamilyLocks
from tpu_docker_api_torch.service.crashpoints import crash_point
from tpu_docker_api_torch.state.keys import (
    BASE_NAME_RE,
    Resource,
    split_versioned_name,
    versioned_name,
)
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY

log = logging.getLogger(__name__)

#: service_time_to_scaled_ms histogram buckets (milliseconds)
_SCALE_BUCKETS = (50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000, 60000)

#: job phases that count as a READY replica (absorbing traffic)
_READY_PHASES = ("running",)


def replica_base(service: str, index: int) -> str:
    """Replica gang family name: ``web`` replica 2 → ``web.r2`` (dots are
    legal base-name chars; '-' is the version separator and stays out)."""
    return f"{service}.r{index}"


def split_replica_base(base: str) -> tuple[str, int] | None:
    """``"web.r2"`` → ("web", 2); None when the name is not replica-shaped.
    Shape alone never condemns a job — ownership is proven by the
    ``SERVICE_OWNER_ENV`` marker in its stored env (see _job_owner)."""
    stem, sep, tail = base.rpartition(".r")
    if not sep or not stem or not tail.isdigit():
        return None
    return stem, int(tail)


class ServingService:
    """Service CRUD + replica convergence + the autoscaler loop."""

    def __init__(self, job_svc, store: StateStore, versions, job_versions,
                 admission=None, default_class: str = "production",
                 interval_s: float = 2.0,
                 up_cooldown_s: float = 10.0,
                 down_cooldown_s: float = 30.0,
                 down_watermark: float = 0.5,
                 scrape_timeout_s: float = 0.5,
                 registry: MetricsRegistry | None = None,
                 max_events: int = 256,
                 clock=time.monotonic,
                 tracer=None, owns=None, store_gate=None) -> None:
        self._job = job_svc
        #: trace sink for self-rooted per-tick spans (idle ticks trimmed)
        self._tracer = tracer
        self._store = store
        self._versions = versions          # service VersionMap
        self._job_versions = job_versions
        self._admission = admission
        #: sharded writer plane (daemon wiring): autoscale / adopt only
        #: services whose shard this process leads. Root-segment hashing
        #: (keys.shard_root) puts a service and all its <svc>.r<i> replica
        #: gangs on ONE shard, so a fleet never straddles a boundary.
        #: None ⇒ all services (single-writer).
        self._owns = owns
        self.default_class = default_class
        self._interval = interval_s
        self.up_cooldown_s = up_cooldown_s
        self.down_cooldown_s = down_cooldown_s
        self.down_watermark = down_watermark
        self._scrape_timeout = scrape_timeout_s
        self._registry = registry if registry is not None else REGISTRY
        self._clock = clock
        self._locks = _FamilyLocks()
        self._mu = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=max_events)
        #: synthetic offered load (requests/s) per service — the traffic
        #: signal fake-runtime replicas synthesize SLO metrics from. Set
        #: by the load-injection route (bench/test traffic generators);
        #: in-memory on purpose: it is an observation, not desired state
        self._offered: dict[str, float] = {}
        #: last aggregated signal per service (operator audit surface)
        self._last_sig: dict[str, dict] = {}
        #: last PER-REPLICA signal (replica family base → metrics dict),
        #: written by the same scrape `_signals` aggregates from — one
        #: set of books: the gateway's least-loaded pick reads exactly
        #: what the autoscaler decided on (service/gateway.py)
        self._replica_sig: dict[str, dict] = {}
        #: cooldown stamps (monotonic clock; in-memory — a restart resets
        #: cooldowns, which only delays the next decision one window)
        self._last_up: dict[str, float] = {}
        self._last_down: dict[str, float] = {}
        #: scale-up in flight: base → (decision monotonic ts, target) for
        #: the time-to-scaled histogram
        self._pending_up: dict[str, tuple[float, int]] = {}
        #: store-outage hold (service/store_health.py): a scale decision
        #: whose spec write cannot land would create/destroy replica gangs
        #: with no durable record of why. None ⇒ ungated.
        self._store_gate = store_gate
        self.store_skips = 0
        self._store_held = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    # -- helpers ------------------------------------------------------------------

    def _resolve_class(self, name: str) -> str:
        if self._admission is not None:
            return self._admission.resolve_class(name or self.default_class)
        from tpu_docker_api_torch.service.admission import (
            DEFAULT_PRIORITY_CLASSES,
        )

        pc = name or self.default_class
        if pc not in DEFAULT_PRIORITY_CLASSES:
            raise errors.BadRequest(
                f"unknown priorityClass {pc!r}: known classes are "
                f"{sorted(DEFAULT_PRIORITY_CLASSES)}")
        return pc

    def _latest_state(self, base: str) -> ServiceState:
        latest = self._versions.get(base)
        if latest is None:
            raise errors.ServiceNotExist(f"service {base}")
        try:
            return self._store.get_service(versioned_name(base, latest))
        except errors.NotExistInStore:
            raise errors.ServiceNotExist(
                f"service {base} (pointer v{latest} has no record; "
                "reconcile repairs it)") from None

    def _job_state(self, rb: str):
        latest = self._job_versions.get(rb)
        if latest is None:
            return None
        try:
            return self._job.store.get_job(versioned_name(rb, latest))
        except errors.NotExistInStore:
            return None

    def _job_owner(self, job_base: str) -> str | None:
        """The service owning a job family, proven by the durable env
        marker (name shape alone is only the candidate filter)."""
        if split_replica_base(job_base) is None:
            return None
        jst = self._job_state(job_base)
        return None if jst is None else owner_from_env(jst.env)

    def _replica_families(self, base: str) -> list[tuple[int, str]]:
        """Existing replica gang families of one service, index-sorted —
        marker-verified, so a user job that merely looks replica-shaped
        is never claimed."""
        out = []
        for jb in self._job_versions.snapshot():
            parsed = split_replica_base(jb)
            if parsed is None or parsed[0] != base:
                continue
            if self._job_owner(jb) == base:
                out.append((parsed[1], jb))
        return sorted(out)

    def _record(self, kind: str, service: str, **extra) -> None:
        evt = trace.stamp({"ts": time.time(), "service": service,
                           "event": kind, **extra})
        with self._mu:
            self._events.append(evt)

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            return list(self._events)[-limit:]

    # -- CRUD ---------------------------------------------------------------------

    def create_service(self, req: ServiceCreate) -> dict:
        base = req.service_name
        if not base or not BASE_NAME_RE.match(base):
            raise errors.BadRequest(
                f"invalid service name {base!r}: must be nonempty, "
                "[a-zA-Z0-9_.] only")
        if not req.image_name:
            raise errors.BadRequest("imageName required")
        if req.chips_per_replica <= 0 and not req.accelerator_type:
            raise errors.BadRequest(
                "chipsPerReplica or acceleratorType required")
        if req.min_replicas < 0 or req.max_replicas < max(req.min_replicas, 1):
            raise errors.BadRequest(
                f"need 0 <= minReplicas <= maxReplicas (>=1), got "
                f"{req.min_replicas}/{req.max_replicas}")
        if not req.min_replicas <= req.replicas <= req.max_replicas:
            raise errors.BadRequest(
                f"replicas {req.replicas} outside "
                f"[{req.min_replicas}, {req.max_replicas}]")
        if req.ttft_p95_target_ms <= 0 or req.queue_depth_target <= 0:
            raise errors.BadRequest(
                "ttftP95TargetMs and queueDepthTarget must be > 0")
        if req.replica_capacity_rps <= 0:
            raise errors.BadRequest("replicaCapacityRps must be > 0")
        priority = self._resolve_class(req.priority_class)
        with self._locks.hold(base):
            if self._versions.contains(base):
                raise errors.ServiceExisted(f"service {base}")
            version = self._versions.next_version(base)
            st = ServiceState(
                service_name=versioned_name(base, version), version=version,
                image=req.image_name, cmd=list(req.cmd), env=list(req.env),
                binds=list(req.binds),
                chips_per_replica=req.chips_per_replica,
                accelerator_type=req.accelerator_type,
                replicas=req.replicas, min_replicas=req.min_replicas,
                max_replicas=req.max_replicas, priority_class=priority,
                ttft_p95_target_ms=req.ttft_p95_target_ms,
                queue_depth_target=req.queue_depth_target,
                replica_capacity_rps=req.replica_capacity_rps,
                metrics_path=req.metrics_path,
            )
            try:
                # v0 record + latest pointer in ONE apply (StateStore._put)
                # — the durable intent every replica below derives from
                self._store.put_service(st)
            except Exception:
                self._versions.rollback(base, None)
                raise
            crash_point("service.create.after_record")
            self._ensure_replicas(base, st)
            self._record("service-created", base, replicas=st.replicas,
                         klass=priority)
            self._update_gauges(base, st)
            self._wake.set()
            log.info("created service %s: %d replica(s) x %d chips (%s)",
                     st.service_name, st.replicas, st.chips_per_replica,
                     priority)
            return self.service_info(base)

    def patch_service(self, name: str, req: ServicePatch) -> dict:
        base, version = split_versioned_name(name)
        with self._locks.hold(base):
            st = self._latest_state(base)
            if version is not None and version != st.version:
                raise errors.VersionNotMatch(
                    f"{name}: latest version is {st.version}")
            if st.phase != "active":
                raise errors.BadRequest(f"service {base} is {st.phase}")
            fields = {}
            if req.min_replicas is not None:
                fields["min_replicas"] = req.min_replicas
            if req.max_replicas is not None:
                fields["max_replicas"] = req.max_replicas
            if req.ttft_p95_target_ms is not None:
                fields["ttft_p95_target_ms"] = req.ttft_p95_target_ms
            if req.queue_depth_target is not None:
                fields["queue_depth_target"] = req.queue_depth_target
            if fields:
                st = ServiceState.from_dict({**st.to_dict(), **fields})
                if (st.min_replicas < 0
                        or st.max_replicas < max(st.min_replicas, 1)):
                    raise errors.BadRequest(
                        f"need 0 <= minReplicas <= maxReplicas (>=1), got "
                        f"{st.min_replicas}/{st.max_replicas}")
                if (st.ttft_p95_target_ms <= 0
                        or st.queue_depth_target <= 0):
                    # same rule as create: a zero target would read as a
                    # permanent breach and pin the fleet at max_replicas
                    raise errors.BadRequest(
                        "ttftP95TargetMs and queueDepthTarget must be > 0")
                self._store.put_service(st)
            if req.image_name and req.image_name != st.image:
                st = self._roll_spec(base, st, req.image_name)
            if req.replicas is not None:
                if not st.min_replicas <= req.replicas <= st.max_replicas:
                    raise errors.BadRequest(
                        f"replicas {req.replicas} outside "
                        f"[{st.min_replicas}, {st.max_replicas}]")
                st = self._scale(base, st, req.replicas, trigger="manual",
                                 reason="operator PATCH")
            elif fields:
                # new bounds may exclude the current count: the clamp is a
                # replica-count change like any other — through _scale, so
                # it is audited (lastScale) and counted as a manual op
                clamped = min(max(st.replicas, st.min_replicas),
                              st.max_replicas)
                if clamped != st.replicas:
                    st = self._scale(base, st, clamped, trigger="manual",
                                     reason="min/max retune clamp")
                else:
                    self._ensure_replicas(base, st)
            self._update_gauges(base, st)
            return self.service_info(base)

    def delete_service(self, name: str) -> None:
        base, _ = split_versioned_name(name)
        with self._locks.hold(base):
            st = self._latest_state(base)
            if st.phase != "deleting":
                # teardown intent FIRST: a crash below leaves "deleting",
                # which the reconciler finishes (one sweep, all replicas)
                st = ServiceState.from_dict(
                    {**st.to_dict(), "phase": "deleting"})
                self._store.put_service(st)
            crash_point("service.delete.after_mark")
            self._finish_delete(base)
            self._record("service-deleted", base)
            log.info("deleted service %s (all replicas torn down)", base)

    def _finish_delete(self, base: str) -> None:
        """Tear down every replica gang (quiesce + full release each),
        then drop the service family — resumable at any point."""
        for _, rb in self._replica_families(base):
            self._teardown_replica_family(rb)
        self._store.delete_family(Resource.SERVICES, base)
        self._versions.remove(base)
        for d in (self._offered, self._last_sig, self._last_up,
                  self._last_down, self._pending_up):
            d.pop(base, None)
        for rb in [k for k in self._replica_sig
                   if k.split(".", 1)[0] == base]:
            self._replica_sig.pop(rb, None)
        for gauge in ("service_replicas_desired", "service_replicas_ready",
                      "service_ttft_p95_ms", "service_queue_depth"):
            self._registry.gauge_set(gauge, 0, {"service": base})

    # -- replica convergence ------------------------------------------------------

    def _replica_run(self, base: str, st: ServiceState, idx: int) -> None:
        """Submit one replica gang through the job machinery at the
        service's class. A full pool queues it (admission enabled) — the
        admission loop then backfills/preempts for it; with the market
        disabled the refusal is surfaced as an event and retried on the
        next tick/reconcile."""
        rb = replica_base(base, idx)
        req = JobRun(
            image_name=st.image, job_name=rb,
            chip_count=st.chips_per_replica,
            accelerator_type=st.accelerator_type,
            binds=list(st.binds),
            env=list(st.env) + [f"{SERVICE_OWNER_ENV}={base}"],
            cmd=list(st.cmd),
            priority_class=st.priority_class,
        )
        try:
            out = self._job.run_job(req)
        except (errors.ChipNotEnough, errors.PortNotEnough) as e:
            self._record("service-scale-blocked", base, replica=rb,
                         error=str(e))
            log.warning("service %s: replica %s blocked: %s", base, rb, e)
            return
        except errors.ContainerExisted:
            # a half-made family (pointer without a record, mid-crash):
            # the job reconciler's scrub owns that repair — skip this tick
            log.warning("service %s: replica family %s exists but is not "
                        "adoptable yet; leaving to the job reconciler",
                        base, rb)
            return
        self._record("service-replica-created", base, replica=rb,
                     phase=out.get("phase", "running"))

    def _teardown_replica_family(self, rb: str) -> None:
        """Quiesce (workers first, coordinator last — the gang stop)
        then delete the family, freeing slices and ports in one batch (the
        bulk release path). A queued replica simply dequeues."""
        try:
            self._job.stop_job(rb)
        except (errors.ContainerNotExist, errors.NotExistInStore):
            return
        except errors.BadRequest:
            pass  # e.g. already-failed gang: delete below still releases
        crash_point("service.scale_down.after_quiesce")
        try:
            self._job.delete_job(rb, JobDelete(
                force=True, del_state_and_version_record=True))
        except errors.ContainerNotExist:
            pass

    def _ensure_replicas(self, base: str, st: ServiceState,
                         actions: list[dict] | None = None,
                         dry_run: bool = False) -> None:
        """Converge the replica fleet to exactly families 0..replicas-1:
        create missing, replace failed, tear down surplus. The shared
        engine under the autoscaler tick, the reconciler's adoption pass
        (``actions`` collects what was done) and scale application."""
        def act(kind: str, target: str, fn) -> None:
            if actions is not None:
                actions.append({"action": kind, "target": target})
            if not dry_run:
                fn()

        existing = dict((idx, rb) for idx, rb
                        in self._replica_families(base))
        for idx in range(st.replicas):
            rb = replica_base(base, idx)
            jst = self._job_state(rb) if idx in existing else None
            if idx not in existing:
                act("create-missing-replica", rb,
                    lambda i=idx: self._replica_run(base, st, i))
            elif jst is not None and jst.phase == "failed":
                # a crash-looped replica burned its budget: replace it —
                # serving capacity must heal, not stay failed
                act("replace-failed-replica", rb,
                    lambda r=rb, i=idx: (self._teardown_replica_family(r),
                                         self._replica_run(base, st, i)))
            elif jst is not None and jst.image != st.image:
                # interrupted rolling update: finish the roll forward
                act("roll-replica", rb,
                    lambda r=rb: self._job.replace_job_spec(
                        r, st.image, st.cmd,
                        list(st.env) + [f"{SERVICE_OWNER_ENV}={base}"],
                        st.binds))
        for idx, rb in existing.items():
            if idx >= st.replicas:
                act("teardown-surplus-replica", rb,
                    lambda r=rb: self._teardown_replica_family(r))

    def _roll_spec(self, base: str, st: ServiceState,
                   image: str) -> ServiceState:
        """Weight/spec update: a NEW immutable service version (spec
        resolved from it ever after), then each replica rolled through
        ``JobService.replace_job_spec`` — one at a time, so N-1 replicas
        keep serving while each rolls."""
        version = self._versions.next_version(base)
        new_st = ServiceState.from_dict({
            **st.to_dict(), "service_name": versioned_name(base, version),
            "version": version, "image": image})
        try:
            self._store.put_service(new_st)
        except Exception:
            self._versions.rollback(base, st.version)
            raise
        crash_point("service.roll.after_version")
        self._ensure_replicas(base, new_st)
        self._record("service-rolled", base, version=version, image=image)
        log.info("rolled service %s to v%d (%s)", base, version, image)
        return new_st

    # -- signals ------------------------------------------------------------------

    def set_offered_load(self, name: str, rps: float) -> dict:
        """Traffic injection for the synthetic-load path (fake-runtime
        replicas): the bench/test load generator states the offered
        request rate and the autoscaler's next tick sees it."""
        base, _ = split_versioned_name(name)
        self._latest_state(base)  # 404 on unknown service
        if not math.isfinite(rps) or rps < 0:
            raise errors.BadRequest(
                f"rps must be a finite number >= 0, got {rps}")
        self._offered[base] = float(rps)
        self._wake.set()
        return {"service": base, "offeredRps": float(rps)}

    def _ready_replicas(self, base: str, st: ServiceState,
                        fams: list[tuple[int, str]] | None = None
                        ) -> list[str]:
        out = []
        if fams is None:
            fams = self._replica_families(base)
        for idx, rb in fams:
            if idx >= st.replicas:
                continue
            jst = self._job_state(rb)
            # draining replicas are mid-quiesce: the gateway already
            # stopped picking them, so readiness (and the autoscale
            # signal scrape) must not count them either
            if (jst is not None and jst.desired_running
                    and jst.phase in _READY_PHASES and not jst.draining):
                out.append(rb)
        return out

    def replica_signal(self, rb: str) -> dict | None:
        """Last scraped/synthesized SLO signal for one replica family, or
        None when it never reported (gateway least-loaded input)."""
        return self._replica_sig.get(rb)

    def _scrape_http(self, st: ServiceState, jst) -> dict | None:
        """The real signal path: GET the replica-reported metrics endpoint
        on the coordinator host (the paged engine's SLO export shape:
        ttft/itl percentiles + queue depth). Any failure returns None —
        an unreachable replica must never wedge the loop."""
        if not jst.placements:
            return None
        host_id = jst.placements[0][0]
        host = self._job.pod.hosts.get(host_id)
        if host is None:
            return None
        url = (f"http://{host.address}:{jst.coordinator_port}"
               f"{st.metrics_path}")
        try:
            with urllib.request.urlopen(
                    url, timeout=self._scrape_timeout) as resp:
                d = json.loads(resp.read())
        except Exception:  # noqa: BLE001 — scrape is best-effort
            return None
        try:
            return {
                "ttftP95Ms": float(d.get("ttftP95Ms",
                                         d.get("ttft_p95_ms", 0.0))),
                "itlP95Ms": float(d.get("itlP95Ms",
                                        d.get("itl_p95_ms", 0.0))),
                "queueDepth": float(d.get("queueDepth",
                                          d.get("queue_depth", 0.0))),
            }
        except (TypeError, ValueError):
            return None

    def _synth(self, st: ServiceState, offered: float,
               ready: int) -> dict:
        """The fake-runtime load model: offered load divides over READY
        replicas; utilization above 1.0 breaches the targets
        proportionally. Queued replicas absorb nothing, so a pending
        scale-up keeps the breach visible until the market places it."""
        per = offered / max(ready, 1)
        util = per / max(st.replica_capacity_rps, 1e-9)
        return {
            "ttftP95Ms": round(st.ttft_p95_target_ms * util, 3),
            "itlP95Ms": round(st.ttft_p95_target_ms * util / 10, 3),
            "queueDepth": round(st.queue_depth_target * util, 3),
        }

    def _signals(self, base: str, st: ServiceState,
                 fams: list[tuple[int, str]] | None = None) -> dict | None:
        """Aggregate per-replica signals: worst replica rules (a single
        overloaded replica is an SLO breach even when the mean looks
        fine). None when nothing reports — no signal, no action. A
        service with a metrics path uses ONLY scraped signals (an
        unreachable endpoint means no signal, never a synthesized one);
        the synthetic offered-load model serves metrics-path-less
        (fake-runtime) services exclusively."""
        ready = self._ready_replicas(base, st, fams)
        per: list[dict] = []
        if st.metrics_path:
            for rb in ready:
                jst = self._job_state(rb)
                if jst is None:
                    continue
                m = self._scrape_http(st, jst)
                if m is not None:
                    per.append(m)
                    self._replica_sig[rb] = m
                else:
                    self._replica_sig.pop(rb, None)
        else:
            offered = self._offered.get(base)
            if offered is not None and ready:
                per = [self._synth(st, offered, len(ready))] * len(ready)
                for rb in ready:
                    self._replica_sig[rb] = per[0]
            elif offered and st.replicas == 0:
                # scale-from-zero: traffic against an EMPTY fleet is a
                # breach by definition — without this, a service scaled
                # to minReplicas=0 could never come back (zero ready
                # replicas ⇒ zero signals ⇒ no decision, forever)
                per = [self._synth(st, offered, 1)]
        if not per:
            self._last_sig.pop(base, None)
            return None
        sig = {
            "ttftP95Ms": max(m["ttftP95Ms"] for m in per),
            "itlP95Ms": max(m.get("itlP95Ms", 0.0) for m in per),
            "queueDepth": max(m["queueDepth"] for m in per),
            "readyReplicas": len(ready),
            "reportingReplicas": len(per),
            "ts": time.time(),
        }
        self._last_sig[base] = sig
        return sig

    # -- the autoscaler -----------------------------------------------------------

    def _scale(self, base: str, st: ServiceState, want: int, trigger: str,
               reason: str) -> ServiceState:
        """Apply one replica-count decision crash-consistently: the new
        desired count + audit record are durable FIRST (one apply), then
        the fleet converges — a daemon death in between is adopted by the
        reconciler from the durable intent."""
        want = min(max(want, st.min_replicas), st.max_replicas)
        if want == st.replicas:
            return st
        direction = "up" if want > st.replicas else "down"
        prev = st.replicas
        counter = "manual_scales" if trigger == "manual" else "auto_scales"
        new_st = ServiceState.from_dict({
            **st.to_dict(), "replicas": want,
            counter: getattr(st, counter) + 1,
            "last_scale": {"ts": time.time(), "direction": direction,
                           "from": prev, "to": want, "reason": reason,
                           "trigger": trigger}})
        self._store.put_service(new_st)
        crash_point(f"service.scale_{direction}.after_mark")
        now = self._clock()
        if direction == "up":
            self._last_up[base] = now
            self._pending_up[base] = (now, want)
        else:
            self._last_down[base] = now
            self._pending_up.pop(base, None)
        self._ensure_replicas(base, new_st)
        self._registry.counter_inc(
            "service_scale_total",
            {"service": base, "direction": direction, "trigger": trigger},
            help="Replica-count changes by direction and trigger")
        if trigger == "manual":
            self._registry.counter_inc(
                "service_manual_scale_total", {"service": base},
                help="Operator-issued replica-count changes")
        self._record("service-scaled", base, direction=direction,
                     from_=prev, to=want, reason=reason, trigger=trigger)
        log.info("service %s scaled %s: %d → %d (%s: %s)", base, direction,
                 prev, want, trigger, reason)
        return new_st

    def _decide(self, base: str, st: ServiceState, sig: dict) -> None:
        """One autoscale decision from one aggregated signal, with the
        anti-flap machinery: cooldowns on both directions and a
        hysteresis watermark (scale down only when the signal sits BELOW
        ``down_watermark × target`` — the band between watermark and
        target is deliberately dead, so oscillation around the target
        changes nothing)."""
        now = self._clock()
        ready = sig["readyReplicas"]
        ratio = max(
            sig["ttftP95Ms"] / max(st.ttft_p95_target_ms, 1e-9),
            sig["queueDepth"] / max(st.queue_depth_target, 1e-9))
        breach = (sig["ttftP95Ms"] > st.ttft_p95_target_ms
                  or sig["queueDepth"] > st.queue_depth_target)
        if breach and st.replicas < st.max_replicas:
            if now - self._last_up.get(base, -math.inf) < self.up_cooldown_s:
                return
            want = max(st.replicas + 1,
                       math.ceil(ready * min(ratio, st.max_replicas)))
            self._scale(base, st, want, trigger="autoscale",
                        reason=f"slo breach: ttftP95 {sig['ttftP95Ms']}ms "
                               f"(target {st.ttft_p95_target_ms}ms), queue "
                               f"{sig['queueDepth']} "
                               f"(target {st.queue_depth_target})")
        elif (ratio < self.down_watermark and st.replicas > st.min_replicas
              and ready >= st.replicas):
            # ready >= replicas: never shrink while a scale-up is still
            # materializing — the queued replica would read as idle
            last = max(self._last_up.get(base, -math.inf),
                       self._last_down.get(base, -math.inf))
            if now - last < self.down_cooldown_s:
                return
            want = min(st.replicas - 1,
                       max(st.min_replicas, math.ceil(ready * ratio)))
            self._scale(base, st, want, trigger="autoscale",
                        reason=f"idle: signal at {round(ratio, 3)} of "
                               f"target (< watermark "
                               f"{self.down_watermark})")

    def _settle_pending_up(self, base: str, st: ServiceState,
                           fams: list[tuple[int, str]] | None = None
                           ) -> None:
        pending = self._pending_up.get(base)
        if pending is None:
            return
        t0, target = pending
        if len(self._ready_replicas(base, st, fams)) >= min(target,
                                                           st.replicas):
            self._pending_up.pop(base, None)
            self._registry.observe(
                "service_time_to_scaled_ms",
                (self._clock() - t0) * 1e3, {"service": base},
                buckets=_SCALE_BUCKETS,
                help="Scale-up decision to all replicas ready (ms)")

    def tick(self) -> None:
        """One autoscaler pass over every service: converge the fleet,
        read signals, decide. Public — tests and the bench drive it
        inline the way ``admit_once`` is driven."""
        if self._store_gate is not None and not self._store_gate():
            # store outage: hold the autoscaler — converge/scale actions
            # mutate service specs and replica gangs. Edge-triggered event.
            self.store_skips += 1
            if not self._store_held:
                self._store_held = True
                self._record("store-outage-hold", "*")
            return
        if self._store_held:
            self._store_held = False
            self._record("store-outage-over", "*")
        with trace.pass_span(self._tracer, "autoscale.tick"):
            self._tick_inner()

    def _tick_inner(self) -> None:
        for base in sorted(self._versions.snapshot()):
            if self._owns is not None and not self._owns(base):
                continue
            try:
                with self._locks.hold(base):
                    try:
                        st = self._latest_state(base)
                    except errors.ServiceNotExist:
                        continue
                    if st.phase != "active":
                        continue
                    self._ensure_replicas(base, st)
                    # ONE replica-family scan serves the settle, signal
                    # and gauge passes (none of them mutates the fleet);
                    # a scale decision below re-scans via _ensure
                    fams = self._replica_families(base)
                    self._settle_pending_up(base, st, fams)
                    sig = self._signals(base, st, fams)
                    if sig is not None:
                        before = st.replicas
                        self._decide(base, st, sig)
                        st = self._latest_state(base)
                        if st.replicas != before:
                            fams = None  # fleet changed; gauges rescan
                    self._update_gauges(base, st, fams=fams)
            except Exception:  # noqa: BLE001 — one service must not
                # starve the others; SimulatedCrash (BaseException)
                # still propagates — that is the chaos harness's kill
                log.exception("autoscale pass for %s failed", base)

    # -- reconciliation (driven by the Reconciler) --------------------------------

    def reconcile_services(self, dry_run: bool = False) -> list[dict]:
        """Adopt whatever a dead daemon left mid-flow:

        - a pointer with no record rolls back (or the family drops);
        - phase ``deleting`` finishes the teardown sweep;
        - active services converge to exactly replicas 0..N-1 (missing
          created — through the admission market when full — failed
          replaced, surplus torn down, half-rolled specs rolled forward);
        - replica gangs whose owning service is GONE (marker-verified)
          are garbage-collected: a deleted service never strands a fleet.
        """
        actions: list[dict] = []
        for base in sorted(self._versions.snapshot()):
            if self._owns is not None and not self._owns(base):
                continue
            lock = (self._locks.hold(base) if not dry_run
                    else contextlib.nullcontext())
            with lock:
                latest = self._versions.get(base)
                if latest is None:
                    continue
                latest_name = versioned_name(base, latest)
                try:
                    st = self._store.get_service(latest_name)
                except (ValueError, KeyError, TypeError, AttributeError) as e:
                    # poison-record quarantine: an unparseable record must
                    # skip THIS family loudly, not abort the serving sweep
                    actions.append({"action": "quarantine-poison-record",
                                    "target": latest_name,
                                    "resource": "services",
                                    "error": f"{type(e).__name__}: {e}"})
                    self._registry.counter_inc(
                        "reconcile_quarantined_total",
                        {"resource": "services"},
                        help="Families skipped because their stored record "
                             "is corrupt")
                    continue
                except errors.NotExistInStore:
                    stored = self._store.history(Resource.SERVICES, base)
                    prev = max((v for v in stored if v < latest),
                               default=None)
                    if prev is None:
                        actions.append({"action": "drop-empty-service-family",
                                        "target": base})
                        if not dry_run:
                            self._versions.remove(base)
                    else:
                        actions.append({"action": "rollback-service-pointer",
                                        "target": latest_name, "to": prev})
                        if not dry_run:
                            self._versions.rollback(base, prev)
                    continue
                if st.phase == "deleting":
                    actions.append({"action": "finish-service-delete",
                                    "target": base})
                    if not dry_run:
                        self._finish_delete(base)
                        self._record("service-deleted", base,
                                     via="reconcile")
                    continue
                self._ensure_replicas(base, st, actions=actions,
                                      dry_run=dry_run)
        known = set(self._versions.snapshot())
        for jb in sorted(self._job_versions.snapshot()):
            if self._owns is not None and not self._owns(jb):
                continue
            owner = self._job_owner(jb)
            if owner is not None and owner not in known:
                actions.append({"action": "gc-orphan-replica", "target": jb,
                                "service": owner})
                if not dry_run:
                    self._teardown_replica_family(jb)
        return actions

    # -- loop lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Launch the autoscaler loop (a WRITER: leader-only under leader
        election; restartable on re-acquire)."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscale", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=self._interval + 5)
            self._thread = None

    def wake(self) -> None:
        self._wake.set()

    def _loop(self) -> None:
        while True:
            self._wake.wait(self._interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("autoscale tick failed")

    # -- views / telemetry --------------------------------------------------------

    def _update_gauges(self, base: str, st: ServiceState | None = None,
                       fams: list[tuple[int, str]] | None = None) -> None:
        try:
            st = st or self._latest_state(base)
        except errors.ServiceNotExist:
            return
        self._registry.gauge_set(
            "service_replicas_desired", st.replicas, {"service": base},
            help="Desired replica count per service")
        self._registry.gauge_set(
            "service_replicas_ready",
            len(self._ready_replicas(base, st, fams)), {"service": base},
            help="Replica gangs in phase running per service")
        sig = self._last_sig.get(base)
        if sig:
            self._registry.gauge_set(
                "service_ttft_p95_ms", sig["ttftP95Ms"], {"service": base},
                help="Worst replica TTFT p95 last observed (ms)")
            self._registry.gauge_set(
                "service_queue_depth", sig["queueDepth"], {"service": base},
                help="Worst replica queue depth last observed")

    def service_info(self, name: str) -> dict:
        """GET /services/{name}: spec + live replica fleet + the last
        autoscale decision and signal — the no-log-reading audit."""
        base, _ = split_versioned_name(name)
        st = self._latest_state(base)
        replicas = []
        ready = 0
        for idx, rb in self._replica_families(base):
            jst = self._job_state(rb)
            if jst is None:
                continue
            # surplus gangs (mid-teardown) are listed but never READY —
            # one set of books with _ready_replicas and the gauge; a
            # draining replica is likewise not ready (the gateway already
            # stopped picking it — the two surfaces must agree)
            if (idx < st.replicas and jst.desired_running
                    and jst.phase in _READY_PHASES and not jst.draining):
                ready += 1
            entry = {
                "index": idx, "family": rb, "jobName": jst.job_name,
                "phase": jst.phase, "chipCount": jst.chip_count,
                "surplus": idx >= st.replicas,
                "draining": jst.draining,
            }
            if jst.phase in ("queued", "preempted") \
                    and self._admission is not None:
                pos = self._admission.position(rb)
                if pos is not None:
                    entry["queuePosition"] = pos
            replicas.append(entry)
        out = {
            "name": st.service_name,
            "version": st.version,
            "image": st.image,
            "phase": st.phase,
            "priorityClass": st.priority_class,
            "chipsPerReplica": st.chips_per_replica,
            "replicas": st.replicas,
            "readyReplicas": ready,
            "minReplicas": st.min_replicas,
            "maxReplicas": st.max_replicas,
            "replicaStatus": replicas,
            "lastScale": st.last_scale or None,
            "slo": {
                "ttftP95TargetMs": st.ttft_p95_target_ms,
                "queueDepthTarget": st.queue_depth_target,
                "replicaCapacityRps": st.replica_capacity_rps,
                "metricsPath": st.metrics_path,
                "lastObserved": self._last_sig.get(base),
            },
            "offeredRps": self._offered.get(base, 0.0),
            # per-incarnation books, persisted with each decision: they
            # die with the family, so a recreated namesake starts at 0
            # (the /metrics counters stay process-lifetime-monotonic)
            "manualScaleTotal": st.manual_scales,
            "autoscaleTotal": st.auto_scales,
        }
        if st.accelerator_type:
            out["acceleratorType"] = st.accelerator_type
        return out

    SUMMARY_KEYS = ("name", "version", "image", "phase", "priorityClass",
                    "replicas", "readyReplicas", "minReplicas",
                    "maxReplicas", "lastScale")

    def service_summary(self, base: str) -> dict | None:
        """One list-entry view (None for a family that vanished between
        the name scan and the read — lists never 404 mid-walk)."""
        try:
            info = self.service_info(base)
        except errors.ServiceNotExist:
            return None
        return {k: info[k] for k in self.SUMMARY_KEYS}

    def list_services(self) -> list[dict]:
        out = []
        for base in sorted(self._versions.snapshot()):
            s = self.service_summary(base)
            if s is not None:
                out.append(s)
        return out
