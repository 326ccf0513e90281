"""Distributed-job orchestration over a multi-host pod.

The capability the reference cannot express (single docker socket,
internal/docker/client.go:11-14): one API call places N containers on N hosts
whose GPUs form one slice, rendered as one ``torch.distributed`` job
(BASELINE.json configs #3-#5). Flows mirror the container service's
immutable-versioned rolling-replacement semantics:

- ``run_job``   — allocate a slice (host-granular when it spans hosts), render
  one member container per host with the distributed bootstrap env
  (workload/torchenv.py: ``MASTER_*``, ``WORLD_SIZE``, a rank or a node
  rank), create and start them all (coordinator = process 0, the
  rendezvous), persist the versioned spec.
- ``patch_job_chips`` — rolling rescale with SURVEY.md §5.4's sequencing fix:
  when the pool has room, the new slice is allocated and its containers
  **created first** (minimal downtime), then the old job is quiesced
  (graceful stop ⇒ the training loop's checkpoint hook flushes), and only
  then do the new containers **start** — never two versions writing the
  shared checkpoint at once. When the pool is too small for both slices, the
  old job is quiesced and freed before allocating (rescale-in-place). Old
  containers stay (stopped) for rollback until delete, like retired
  container versions.
- ``delete_job`` / ``stop_job`` / ``restart_job`` / ``get_job_info``.
- ``restart_gang`` / ``fail_job`` — gang recovery (service/job_supervisor.py):
  whole-gang stop (coordinator last) → start (coordinator first), and the
  terminal ``failed`` transition that frees every slice and port. ``JobState``
  carries the lifecycle ``phase`` (running/restarting/migrating/failed/
  stopped) and the persisted restart + migration budgets.
- ``migrate_gang`` — host-fault recovery (docs/robustness.md "Host failure
  domains"): re-place the whole gang EXCLUDING unhealthy hosts, charged to
  ``job_max_migrations`` instead of the crash-restart budget.

Checkpoint continuity across rescales rides a shared bind (e.g. NFS, the
cross-container channel the reference also leans on, README.md:41): every
process of every version mounts the same ``binds``, so ``job-(n+1)`` resumes
from the step ``job-n`` checkpointed at quiesce.

The port's copy of ``tpu_docker_api/service/job.py``: the same flows,
crash points, fan-out batches, state and ports. The daemon wires the
capacity market (service/admission.py) into ``admission``: queueing, grow-back
records and re-admission of parked gangs. A service replica's quiesce writes
the durable ``draining`` marker first, as JAX's ``_predrain`` does, and
when the daemon runs the serving gateway it sets ``drain_coordinator``
(service/gateway.py ``DrainCoordinator``): the first member stop then waits,
deadline-bounded, for every live gateway's drain ack.
"""

from __future__ import annotations

import logging
import re
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.fanout import SERIAL, Fanout
from tpu_docker_api_torch.runtime.spec import ContainerSpec
from tpu_docker_api_torch.scheduler.pod import Pod, PodScheduler, SliceAllocation
from tpu_docker_api_torch.scheduler.slices import candidate_shapes
from tpu_docker_api_torch.schemas.job import (
    SCALING_PHASES,
    JobDelete,
    JobPatchChips,
    JobRun,
    JobState,
)
from tpu_docker_api_torch.service.container import _FamilyLocks, resolve_latest
from tpu_docker_api_torch.service.crashpoints import crash_point
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY
from tpu_docker_api_torch.state.keys import (
    BASE_NAME_RE,
    Resource,
    split_versioned_name,
    versioned_name,
)
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.state.txn import StoreTxn
from tpu_docker_api_torch.state.version import VersionMap
from tpu_docker_api_torch.workload.torchenv import (
    DistributedJob,
    ProcessPlacement,
    render_job_specs,
)

log = logging.getLogger(__name__)

#: member container names are "<versioned-job>-p<process_id>"
#: (workload/torchenv.py render_job_specs)
_MEMBER_RE = re.compile(r"^(?P<job>.+)-p(?P<pid>\d+)$")

#: resize_time_to_shrunk_ms histogram buckets (milliseconds)
_RESIZE_BUCKETS = (5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
                   30000, 60000)


class JobService:
    def __init__(
        self,
        pod: Pod,
        slices: PodScheduler,
        store: StateStore,
        versions: VersionMap,
        fanout: Fanout | None = None,
        registry: MetricsRegistry | None = None,
        resize_enabled: bool = True,
        resize_max: int = 8,
    ) -> None:
        self.pod = pod
        self.slices = slices
        self.store = store
        self.versions = versions
        self.registry = registry if registry is not None else REGISTRY
        #: elastic-gang master gate (config ``job_resize_enabled``): when
        #: False every resize DECISION site (supervisor shrink-vs-migrate,
        #: drain shrink-first, admission partial preemption / grow-back)
        #: falls back to the pre-elastic behavior byte-for-byte; the
        #: resize primitive itself stays callable so adoption can always
        #: finish an in-flight resize left by a previous configuration
        self.resize_enabled = resize_enabled
        #: loop bound for adoption retries (config ``job_resize_max``):
        #: a gang that keeps failing to settle a resize converges to
        #: terminal failed instead of thrashing forever
        self.resize_max = resize_max
        #: runtime fan-out (runtime/fanout.py): every multi-member engine
        #: batch — create, start-workers, stop-workers, remove — routes
        #: through it. The default is the serial singleton, byte-for-byte
        #: the pre-fan-out loops; daemon.py wires the pod-wide pool
        self.fanout = fanout or SERIAL
        self._locks = _FamilyLocks()
        #: optional event hook (set by JobSupervisor): called with
        #: (kind, job_name, **detail) for gang lifecycle transitions
        self.event_sink = None
        #: capacity market (service/admission.py), wired by the daemon.
        #: When set, priority classes validate against the configured
        #: ladder and — if ``admission.enabled`` — a capacity-refused
        #: POST /jobs parks as phase "queued" instead of hard-failing.
        #: None keeps the legacy refusal byte-for-byte (and validates
        #: classes against the default ladder)
        self.admission = None
        #: serving-gateway drain handshake (service/gateway.py
        #: DrainCoordinator), wired by the daemon when the gateway is on:
        #: None = mark-only, the durable marker still lands and nothing
        #: waits
        self.drain_coordinator = None
        self.drain_deadline_s = 0.0

    # -- helpers -----------------------------------------------------------------

    def _resolve_latest(self, name: str) -> tuple[str, int, str]:
        return resolve_latest(self.versions, name)

    def family_lock(self, base: str):
        """Serialize against this family's user flows (mirrors
        ContainerService.family_lock; used by supervisor + reconciler)."""
        return self._locks.hold(base)

    def _emit(self, kind: str, job_name: str, **detail) -> None:
        if self.event_sink is not None:
            try:
                self.event_sink(kind, job_name, **detail)
            except Exception:  # noqa: BLE001 — events must never break flows
                log.exception("job event sink failed for %s %s", kind, job_name)

    def owns_member(self, cname: str) -> str | None:
        """Map a container name to its job family base, or None when the
        container is not a member of any known job version. The per-container
        crash path (HealthWatcher) uses this to DECLINE job members — a gang
        member must never be restarted in isolation."""
        m = _MEMBER_RE.match(cname)
        if m is None:
            return None
        vname = m.group("job")
        base, version = split_versioned_name(vname)
        if version is None or self.versions.get(base) is None:
            return None
        try:
            st = self.store.get_job(vname)
        except errors.NotExistInStore:
            return None
        return base if any(c == cname for _, c, *_ in st.placements) else None

    def _slice_owner(self, vname: str, k: int, num_slices: int) -> str:
        # single-slice owners stay the bare versioned name (back-compat with
        # persisted scheduler state)
        return vname if num_slices == 1 else f"{vname}#s{k}"

    def _apply_slices(self, n_chips: int, num_slices: int,
                      accelerator_type: str, vname: str,
                      exclude_hosts: set[str] | None = None,
                      txn: StoreTxn | None = None,
                      ) -> list[SliceAllocation]:
        """One slice grant per slice — gang-level all-or-nothing in ONE
        scheduler apply (PodScheduler.apply_slices batches every member's
        chip map and the slice registry into a single lock hold; with a txn
        the persist defers into the flow's one claim commit)."""
        if num_slices > 1 and accelerator_type:
            # apply_slice overrides n_chips from the type, so the type would
            # be granted PER SLICE while every size precheck assumes a total
            # that splits — ambiguous; require the explicit chip count
            raise errors.BadRequest(
                "acceleratorType cannot combine with numSlices > 1; "
                "use chipCount (total across slices)")
        if n_chips % num_slices:
            raise errors.BadRequest(
                f"chipCount {n_chips} must divide by numSlices {num_slices}")
        return self.slices.apply_slices(
            [(self._slice_owner(vname, k, num_slices),
              n_chips // num_slices, accelerator_type)
             for k in range(num_slices)],
            exclude_hosts=exclude_hosts, txn=txn)

    def _restore_slices(self, vname: str, num_slices: int,
                        txn: StoreTxn | None = None) -> None:
        for k in range(num_slices):
            self.slices.restore_slice(self._slice_owner(vname, k, num_slices),
                                      txn=txn)

    def _build_placements(
        self, grants: list[SliceAllocation], owner: str,
        txn: StoreTxn | None = None,
    ) -> tuple[list[ProcessPlacement], int, int, dict[str, list[int]]]:
        """Placements over all slices (slice-major, global process ids) +
        master port + multislice port (0 unless multislice) + the host
        ports claimed per host (for rollback/free). With a txn, every
        host's port claim defers into the flow's single claim commit — the
        whole gang's ports are one store round trip, not one per member."""
        claimed: dict[str, list[int]] = {}
        placements: list[ProcessPlacement] = []
        multislice = len(grants) > 1
        try:
            pid = 0
            for k, grant in enumerate(grants):
                for host_id, chips in grant.hosts:
                    host = self.pod.hosts[host_id]
                    # process 0 also publishes the master port (+ JAX's
                    # multislice port when multislice)
                    n_ports = (3 if multislice else 2) if pid == 0 else 1
                    ports = host.ports.apply_ports(n_ports, owner=owner,
                                                   txn=txn)
                    claimed.setdefault(host_id, []).extend(ports)
                    placements.append(ProcessPlacement(
                        process_id=pid,
                        host=host.address,
                        chip_ids=chips,
                        member_port=ports[0],
                        topology=host.topology,
                        slice_id=k,
                    ))
                    pid += 1
            first_host_ports = claimed[grants[0].hosts[0][0]]
            coordinator_port = first_host_ports[1]
            megascale_port = first_host_ports[2] if multislice else 0
        except Exception:
            self._free_ports(claimed, owner, txn=txn)
            raise
        return placements, coordinator_port, megascale_port, claimed

    def _free_ports(self, claimed: dict[str, list[int]], owner: str,
                    txn: StoreTxn | None = None) -> None:
        for host_id, ports in claimed.items():
            self.pod.hosts[host_id].ports.restore_ports(ports, owner=owner,
                                                        txn=txn)

    def _specs_for(self, job_versioned: str, grants: list[SliceAllocation],
                   placements: list[ProcessPlacement], coordinator_port: int,
                   megascale_port: int, req_image: str, req_cmd: list[str],
                   req_env: list[str], req_binds: list[str]
                   ) -> list[ContainerSpec]:
        grant = grants[0]
        job = DistributedJob(
            name=job_versioned,
            placements=placements,
            master_port=coordinator_port,
            num_slices=len(grants),
            multislice_port=megascale_port,
        )
        specs = render_job_specs(
            job,
            self.pod.hosts[grant.hosts[0][0]].topology,
            image=req_image,
            cmd=req_cmd,
            base_env=req_env,
        )
        for spec in specs:
            spec.binds = list(req_binds) + spec.binds
        return specs

    @staticmethod
    def _host_order(grants: list[SliceAllocation]) -> list[tuple[str, list[int]]]:
        """(host_id, chips) in global process order — slice-major, the one
        ordering convention placements, specs, and state all share."""
        return [(host_id, chips) for g in grants for host_id, chips in g.hosts]

    def _create_and_start(self, grants: list[SliceAllocation],
                          specs: list[ContainerSpec],
                          start_now: bool = True) -> None:
        """Create every process container (one concurrent fan-out batch),
        then (optionally) start the gang — coordinator first as a barrier,
        workers concurrently after it; on any failure remove *everything*
        that was created. ``start_now=False`` is the rescale path:
        containers are created alongside the running old version and
        started only after it quiesces."""
        ordered = [(host_id, spec)
                   for (host_id, _), spec in zip(self._host_order(grants),
                                                 specs)]
        pairs = [(host_id, spec.name) for host_id, spec in ordered]
        results = self.fanout.run([
            (spec.name, "container_create",
             lambda h=host_id, s=spec: self.pod.hosts[h].runtime
             .container_create(s))
            for host_id, spec in ordered])
        created = [pairs[i] for i, r in enumerate(results) if r.ok]
        try:
            failure = next((r.error for r in results
                            if r.error is not None), None)
            if failure is not None:
                raise failure
            if start_now:
                self._start_pairs(pairs)
        except Exception:
            # rollback removes every member that was created — including
            # the ones a concurrent batch landed AFTER the failing one
            self._remove_pairs(created, force=True, log_failures=True)
            raise

    def _start_pairs(self, pairs: list[tuple[str, str]]) -> None:
        """Start a gang in process order with the concurrency contract:
        the coordinator (process 0) starts FIRST and alone — a barrier, so
        peers always find their rendezvous point — then every worker
        starts concurrently. Raises the first failure (the caller's
        rollback/adoption machinery takes over; in serial mode later
        workers are never dispatched, exactly the old loop)."""
        def start(host_id: str, cname: str) -> None:
            host = self.pod.hosts.get(host_id)
            if host is None:
                # stale placement (host removed from the pod config) — a
                # meaningful error, not a raw KeyError→500
                raise errors.ContainerNotExist(
                    f"{cname}: host {host_id} is no longer in the pod")
            host.runtime.container_start(cname)

        for batch in (pairs[:1], pairs[1:]):
            results = self.fanout.run([
                (cname, "container_start",
                 lambda h=host_id, c=cname: start(h, c))
                for host_id, cname in batch])
            for r in results:
                if r.error is not None:
                    raise r.error

    def _remove_pairs(self, pairs: list[tuple[str, str]], force: bool = True,
                      log_failures: bool = False) -> None:
        """Concurrent tolerant removes — the shape every teardown path
        (rollback, delete, scrub) shares. Missing containers and dead
        engines never abort the batch: each member's failure handling is
        inside its own call."""
        def remove(host_id: str, cname: str) -> None:
            host = self.pod.hosts.get(host_id)
            if host is None:
                return
            try:
                host.runtime.container_remove(cname, force=force)
            except errors.ContainerNotExist:
                pass
            except Exception as e:  # noqa: BLE001
                if log_failures:
                    log.exception("rollback remove of %s on %s failed",
                                  cname, host_id)
                elif isinstance(e, errors.HOST_PATH_ERRORS):
                    # the member is beyond a dead engine; the flow must
                    # still make progress (the container is lost either
                    # way — logged for the post-reboot janitor)
                    log.warning("remove of %s skipped: %s", cname, e)
                else:
                    raise

        results = self.fanout.run([
            (cname, "container_remove",
             lambda h=host_id, c=cname: remove(h, c))
            for host_id, cname in pairs])
        for r in results:
            if r.error is not None:
                raise r.error

    def _run_version(self, base: str, image: str, cmd: list[str], env: list[str],
                     binds: list[str], n_chips: int,
                     accelerator_type: str = "", start_now: bool = True,
                     num_slices: int = 1,
                     exclude_hosts: set[str] | None = None,
                     carry: dict | None = None,
                     release_old: JobState | None = None) -> JobState:
        """Version bump → ONE atomic claim txn (every slice's chips, the
        slice registry, every host's ports) → render → create[+start] →
        persist JobState (one more apply), with full rollback (the
        job-level _run_new_version). An N-member gang is O(1) store round
        trips, not O(N): bump, claim commit, state commit. ``carry`` merges
        extra JobState fields into the persisted record (migration carries
        the budget counters onto the new version).

        ``release_old`` (the resize path): the old version's slices and
        ports are released INTO the same claim txn, so the store sees one
        apply whose net effect is exactly the member delta — the new
        version's claims and the old version's release can never disagree
        across a crash. The release mutates in-memory scheduler state
        eagerly (restores are owner-guarded, so a replayed release is a
        no-op); if the claim then fails, nothing was persisted and the
        caller compensates by re-launching the old shape — the next
        full-snapshot commit reconverges the store to in-memory truth."""
        prev = self.versions.get(base)
        version = self.versions.next_version(base)
        job_versioned = versioned_name(base, version)
        crash_point("job.run.after_version_bump")
        txn = StoreTxn(self.store.kv)
        try:
            if release_old is not None:
                self._release_version_resources(release_old, txn=txn)
            grants = self._apply_slices(
                n_chips, num_slices, accelerator_type, job_versioned,
                exclude_hosts=exclude_hosts, txn=txn)
            try:
                placements, coordinator_port, megascale_port, claimed = (
                    self._build_placements(grants, job_versioned, txn=txn))
                try:
                    specs = self._specs_for(
                        job_versioned, grants, placements, coordinator_port,
                        megascale_port, image, cmd, env, binds,
                    )
                    # the whole gang's claims become durable together,
                    # BEFORE any container exists — a crash after create
                    # always finds its claims in the store (the invariant
                    # the reconciler's scrub/leak sweeps are built on)
                    txn.commit()
                    self._create_and_start(grants, specs, start_now=start_now)
                except Exception:
                    self._free_ports(claimed, job_versioned)
                    raise
            except Exception:
                self._restore_slices(job_versioned, num_slices)
                raise
        except Exception:
            self.versions.rollback(base, prev)
            raise
        crash_point("job.run.after_create")
        host_order = self._host_order(grants)
        st = JobState(
            job_name=job_versioned,
            version=version,
            image=image, cmd=list(cmd), env=list(env), binds=list(binds),
            chip_count=sum(g.n_chips for g in grants),
            coordinator_port=coordinator_port,
            placements=[
                [host_id, spec.name, pid, list(chips), placements[pid].member_port]
                for pid, ((host_id, chips), spec) in enumerate(zip(host_order, specs))
            ],
            num_slices=num_slices,
            megascale_port=megascale_port,
        )
        if carry:
            st = JobState.from_dict({**st.to_dict(), **carry})
        self.store.put_job(st)
        return st

    def _predrain(self, st: JobState, pointer: bool = True) -> JobState:
        """Persist the gateway ``draining`` marker BEFORE the first member
        stop of a service-owned replica quiesce, then wait (deadline-
        bounded) for every live gateway instance to ack it — so in-flight
        streamed responses finish before the members die and zero
        requests drop across rolls, scale-downs and stops.

        Gated on service ownership (``owner_from_env``): plain gangs keep
        their exact store-apply counts — no gateway routes to them, so
        the extra write would buy nothing. Preemptions don't come through
        here: their atomic phase→preempted flip (admission.py) IS the
        mark-before-stop, folded by the routing table the same way."""
        from tpu_docker_api_torch.schemas.service import owner_from_env

        if (st.draining or not st.placements or st.phase != "running"
                or owner_from_env(st.env) is None):
            return st
        st = JobState.from_dict({**st.to_dict(), "draining": True})
        self.store.put_job(st, pointer=pointer)
        crash_point("gateway.drain.after_mark")
        base, version = split_versioned_name(st.job_name)
        self._emit("job-draining", st.job_name)
        if self.drain_coordinator is not None:
            # version-scoped: only an ack that quiesced THIS version (or
            # observed a newer one — the roll path, where the marker
            # lands on the old record behind the latest pointer) counts
            acked = self.drain_coordinator.wait_drained(
                base, self.drain_deadline_s, version=version)
            self._emit("job-drain-acked" if acked else "job-drain-deadline",
                       st.job_name)
        crash_point("gateway.drain.after_ack")
        return st

    def _swap_version(self, base: str, old: JobState, carry: dict,
                      run_new) -> JobState:
        """THE rolling-replace state machine — one copy, shared by the
        chip rescale and the spec/weight roll (both swap a running gang
        for a new version of itself; only what the new version looks
        like differs, so ``run_new(start_now)`` is the caller's).

        Fast path (pool fits old+new): create the new gang un-started
        while the old one runs, quiesce the old gang gang-ordered
        (graceful stop ⇒ checkpoint flush), start the new one, free the
        old slice — the two versions never run concurrently against the
        shared binds. A swap failure tears the new version down and
        resumes the old one. Fallback (``ChipNotEnough``: pool too small
        for both): quiesce and free first, then allocate; on failure
        re-launch the old shape (best-effort compensation — another
        family could race for the freed capacity; logged and re-raised
        either way). Caller holds the family lock."""

        def _quiesce_old() -> None:
            # gang ordering: workers flush their checkpoint shards first,
            # the coordinator (the rendezvous point) last. pointer=False:
            # on the fast path the new version already took the family's
            # latest pointer — recording the old quiesce must not rewind
            # it (a bare-name GET would serve the retired version); on
            # the in-place path the pointer already names the old
            # version, so skipping the rewrite changes nothing
            drained = self._predrain(old, pointer=False)
            self._stop_members(drained, reverse=True)
            self.store.put_job(JobState.from_dict(
                {**drained.to_dict(), "desired_running": False,
                 "phase": "stopped", "draining": False}), pointer=False)

        def _resume_old() -> None:
            # store record first: if the restart fails too, the family's
            # latest pointer must already be back on the old version
            self.store.put_job(JobState.from_dict(old.to_dict()))
            self._start_members(old)

        try:
            st = run_new(start_now=False)
            try:
                _quiesce_old()
                crash_point("job.patch.after_quiesce_old")
                self._start_members(st)
            except Exception:
                # the old containers are intact: tear the new version
                # down and resume the old one
                log.exception("swap of %s failed; resuming old version",
                              base)
                self._teardown_version(st, old.version)
                _resume_old()
                raise
            crash_point("job.patch.after_start_new")
            self._release_version_resources(old)
        except errors.ChipNotEnough:
            # in-place: the freed old slice is the capacity
            _quiesce_old()
            self._release_version_resources(old)
            try:
                st = run_new(start_now=True)
            except Exception:
                log.exception("swap of %s failed; re-launching old shape",
                              base)
                self._run_version(base, old.image, old.cmd, old.env,
                                  old.binds, old.chip_count,
                                  num_slices=old.num_slices, carry=carry)
                raise
        return st

    @staticmethod
    def _carry_identity(st: JobState, **overrides) -> dict:
        """The JobState fields that travel with the FAMILY across
        versions (rescale, migration, resize, re-admission): priority
        identity, seniority, every budget counter, and the elastic
        contract. One helper so a new identity field can never be dropped
        by one of the five carry sites."""
        out = {
            "priority_class": st.priority_class,
            "submitted_seq": st.submitted_seq,
            "preemptions": st.preemptions,
            "restarts": st.restarts,
            "migrations": st.migrations,
            "elastic": st.elastic,
            "min_members": st.min_members,
            "members_desired": st.members_desired,
            "resizes": st.resizes,
            "last_resize": dict(st.last_resize),
        }
        out.update(overrides)
        return out

    # -- elastic resize (docs/robustness.md "Elastic gangs") ---------------------

    def resize_gang(self, name: str, to_members: int,
                    exclude_hosts: set[str] | None = None,
                    reason: str = "", count_resize: bool = True,
                    require_weight_below: int | None = None) -> JobState:
        """Resize an elastic data-parallel gang to ``to_members`` hosts —
        the reaction that replaces binary failure: a host loss or a
        partial preemption SHRINKS the gang to its surviving members
        (never below ``min_members``), a grow-back admitted through the
        capacity market restores them. Sequencing reuses the gang
        primitives end to end:

        1. persist intent FIRST (phase ``scaling_down``/``scaling_up`` +
           ``last_resize`` with the target and excluded hosts) — a daemon
           death anywhere below is adoptable: the reconciler/supervisor
           finish the resize forward without re-counting it;
        2. quiesce the whole gang (workers first, coordinator LAST —
           checkpoint binds intact, stops best-effort on unreachable
           hosts);
        3. ONE atomic apply releases the old version's slices and ports
           AND claims the new version's — the store sees exactly the
           member delta, with no window where the gang owns neither (or
           both) — then the new member containers are created;
        4. start coordinator-first; the resized gang resumes from the
           shared checkpoint binds, re-sharding its batch dimension over
           the surviving hosts;
        5. a shrink below ``members_desired`` journals a durable
           grow-back admission record at the job's class, re-admitted
           with preempted-grade precedence once pressure lifts.

        A shrink whose exact target cannot place (axis-aligned block
        fragmentation) steps down toward ``min_members``; exhausting the
        ladder parks the gang ``preempted`` (admission enabled) or fails
        it — the gang is never left half-sized. ``require_weight_below``
        re-validates the partial-preemption eligibility (strictly-lower
        class, still running) under the family lock, so a priority retune
        or user stop that raced in wins."""
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            base, _, latest_name = self._resolve_latest(name)
            st = self.store.get_job(latest_name)
            if not st.elastic:
                raise errors.BadRequest(f"job {base} is not elastic")
            if st.phase == "failed":
                raise errors.BadRequest(
                    f"job {base} is failed: {st.failure_reason}")
            if st.phase in ("queued", "preempted"):
                raise errors.BadRequest(
                    f"job {base} is {st.phase}; admission re-places it")
            if st.phase == "migrating":
                raise errors.BadRequest(
                    f"job {base} is migrating off unhealthy hosts")
            if not st.desired_running:
                raise errors.BadRequest(f"job {base} is stopped")
            if st.num_slices != 1:
                raise errors.BadRequest(
                    f"job {base} is multislice; elastic resize is "
                    "single-slice only")
            finishing = st.phase in SCALING_PHASES
            cur = len(st.placements)
            per_host = self.pod.chips_per_host
            desired = st.members_desired or cur
            floor = max(st.min_members, 1)
            if not floor <= to_members <= desired:
                raise errors.BadRequest(
                    f"job {base}: target {to_members} members outside "
                    f"[{floor}, {desired}] (minMembers..membersDesired)")
            if require_weight_below is not None:
                # partial-preemption revalidation: the plan was computed
                # lock-free — a stale snapshot must never shrink a gang
                # that stopped being a legal victim, and a concurrent
                # shrink that already took the gang below the plan's
                # target must not turn the "preemption" into a GROW
                w = (self.admission.weight(st.priority_class)
                     if self.admission is not None else 0)
                if (st.phase != "running" or w >= require_weight_below
                        or to_members >= cur):
                    raise errors.BadRequest(
                        f"job {base} is no longer a preemption victim")
            if to_members == cur and not finishing:
                raise errors.NoPatchRequired(
                    f"job {base} already has {cur} members")
            direction = "down" if to_members < cur else "up"
            exclude = set(exclude_hosts or ())
            vname = st.job_name
            if direction == "up" and not self.slices.fits(
                    to_members * per_host, 1, assume_freed={vname},
                    exclude_hosts=exclude):
                # grow-back feasibility precheck BEFORE touching the
                # running gang: a grow that cannot place must not bounce
                # a healthy shrunken gang through quiesce/relaunch
                if finishing:
                    # adopting an interrupted grow whose window closed:
                    # settle back to running at the CURRENT size (bounce
                    # the gang through the restart primitive — the dead
                    # daemon may have quiesced any subset) and leave the
                    # grow-back record to retry when pressure lifts again
                    st = JobState.from_dict(
                        {**st.to_dict(), "phase": "running"})
                    self.store.put_job(st)
                    self._stop_members(st, reverse=True)
                    self._start_members(st)
                    self._emit("job-resize-reverted", st.job_name,
                               reason="grow window closed")
                    return st
                raise errors.ChipNotEnough(
                    f"job {base}: no capacity to grow back to "
                    f"{to_members} members")
            t0 = time.perf_counter()
            intent = {
                "direction": direction, "reason": reason,
                "ts": time.time(), "fromMembers": cur,
                "toMembers": to_members,
                "excludeHosts": sorted(exclude),
                # attempts of THIS resize (adoption retries bump it; the
                # job_resize_max loop bound reads it) — distinct from the
                # lifetime ``resizes`` observability counter, which a
                # healthy long-lived elastic gang grows without limit
                "attempts": ((st.last_resize or {}).get("attempts", 0) + 1
                             if finishing else 1),
            }
            st = JobState.from_dict({
                **st.to_dict(),
                "phase": "scaling_down" if direction == "down"
                else "scaling_up",
                "resizes": st.resizes + (1 if count_resize
                                         and not finishing else 0),
                "last_resize": intent,
            })
            self.store.put_job(st)
            crash_point("job.resize.after_mark")
            # gang quiesce: workers flush their checkpoint shards first,
            # the coordinator (the rendezvous point) strictly last
            self._stop_members(st, reverse=True)
            crash_point("job.resize.after_quiesce")
            new_st = self._relaunch_resized(base, st, to_members, cur,
                                            exclude, intent, reason)
            crash_point("job.resize.after_create_new")
            # retire the old version record so supervisors/invariants read
            # it as settled (the resources were already released in the
            # delta apply; pointer=False — the resized version owns the
            # family's latest pointer)
            self.store.put_job(JobState.from_dict(
                {**st.to_dict(), "desired_running": False,
                 "phase": "stopped"}), pointer=False)
            self._start_members(new_st)
            crash_point("job.resize.after_start_new")
            got = len(new_st.placements)
            wall_ms = (time.perf_counter() - t0) * 1e3
            self.registry.counter_inc(
                "job_resizes_total",
                {"direction": "down" if got < cur else "up",
                 "reason": reason or "manual"},
                help="Elastic gang resizes executed, by direction/reason")
            if got < cur:
                self.registry.observe(
                    "resize_time_to_shrunk_ms", wall_ms, buckets=_RESIZE_BUCKETS,
                    help="Wall time from resize intent to the shrunken "
                         "gang running (ms)")
            self._emit("job-resized", new_st.job_name,
                       direction="down" if got < cur else "up",
                       reason=reason, fromMembers=cur, toMembers=got,
                       wallMs=round(wall_ms, 1))
            log.info("resized job %s: %d → %d members (%s): %s", base,
                     cur, got, new_st.job_name, reason or "requested")
            if (got < desired and self.admission is not None
                    and self.admission.enabled and self.resize_enabled):
                # durable grow-back intent through the capacity market —
                # the queue, not a private retry loop, decides when the
                # lost members return (preempted-grade precedence). The
                # job-growback-queued event is recorded ONCE, by the
                # admission ring (enqueue_growback) — one entry per
                # transition in the merged ring
                self.admission.enqueue_growback(base, new_st.priority_class)
                crash_point("job.resize.after_start_new")
            return new_st

    def _relaunch_resized(self, base: str, st: JobState, to_members: int,
                          cur: int, exclude: set[str], intent: dict,
                          reason: str) -> JobState:
        """Claim-and-create the resized version, stepping down the member
        ladder on capacity/fragmentation failure (a shrink must land on
        whatever block shape the surviving hosts offer; a failed grow
        first retries the CURRENT size — the compensation that leaves the
        gang no worse). Exhausting the ladder parks the gang preempted
        (admission enabled — it re-admits like any other victim) or fails
        it. The old version's release rides each attempt's claim txn
        (``release_old``); replayed releases are owner-guarded no-ops."""
        per_host = self.pod.chips_per_host
        floor = max(st.min_members, 1)
        ladder = [to_members]
        if to_members > cur:
            # grow: fall back to the current size first (status quo), then
            # shrink toward the floor only if even that cannot re-place
            ladder += [m for m in range(cur, floor - 1, -1)
                       if m != to_members]
        else:
            ladder += [m for m in range(to_members - 1, floor - 1, -1)]
        grid = self.pod.host_grid
        done = {k: v for k, v in intent.items() if k != "excludeHosts"}
        for target in ladder:
            if not candidate_shapes(target, grid):
                continue  # no axis-aligned tiling for this member count
            try:
                return self._run_version(
                    base, st.image, st.cmd, st.env, st.binds,
                    target * per_host, start_now=False, num_slices=1,
                    exclude_hosts=exclude or None,
                    carry=self._carry_identity(
                        st, last_resize={**done, "toMembers": target}),
                    release_old=st)
            except (errors.ChipNotEnough, errors.PortNotEnough) as e:
                log.info("resize of %s to %d members blocked: %s", base,
                         target, e)
        # ladder exhausted: even min_members cannot place — the gang
        # cannot run at any legal size right now
        self._emit("job-resize-exhausted", st.job_name, reason=reason,
                   floor=floor)
        if self.admission is not None and self.admission.enabled:
            parked = self.admission.park_preempted(
                base, reason=f"resize exhausted: {reason or 'no capacity'}")
            if parked is not None:
                raise errors.ChipNotEnough(
                    f"job {base}: no capacity at any size >= {floor}; "
                    "parked preempted for re-admission")
        self.fail_job(base, f"resize exhausted: no capacity at any size "
                            f">= {floor} ({reason or 'resize'})")
        raise errors.ChipNotEnough(
            f"job {base}: no capacity at any size >= {floor}")

    # -- flows -------------------------------------------------------------------

    def _resolve_priority(self, name: str) -> str:
        """Validated priority class ("" ⇒ default). With the admission
        controller wired the configured ladder rules; without it the
        default ladder still validates, so priorityClass is never a
        silently-accepted typo."""
        if self.admission is not None:
            return self.admission.resolve_class(name)
        from tpu_docker_api_torch.service.admission import (
            DEFAULT_CLASS,
            DEFAULT_PRIORITY_CLASSES,
        )

        pc = name or DEFAULT_CLASS
        if pc not in DEFAULT_PRIORITY_CLASSES:
            raise errors.BadRequest(
                f"unknown priorityClass {pc!r}: known classes are "
                f"{sorted(DEFAULT_PRIORITY_CLASSES)}")
        return pc

    def _requested_chips(self, req: JobRun) -> int:
        if req.accelerator_type:
            from tpu_docker_api_torch.scheduler.topology import (
                parse_accelerator_type,
            )

            _, want = parse_accelerator_type(req.accelerator_type)
            return want
        return req.chip_count

    def run_job(self, req: JobRun) -> dict:
        base = req.job_name
        if not base or not BASE_NAME_RE.match(base):
            raise errors.BadRequest(
                f"invalid job name {base!r}: must be nonempty, [a-zA-Z0-9_.] only"
            )
        if not req.image_name:
            raise errors.BadRequest("imageName required")
        if req.chip_count <= 0 and not req.accelerator_type:
            raise errors.BadRequest("chipCount or acceleratorType required")
        if req.num_slices < 1:
            raise errors.BadRequest("numSlices must be >= 1")
        min_members = 0
        if req.elastic:
            # the elastic contract is only meaningful for a gang that CAN
            # shrink in units of hosts: single-slice, whole-host members,
            # at least two of them
            if req.num_slices != 1:
                raise errors.BadRequest(
                    "elastic jobs are single-slice (numSlices == 1); "
                    "multislice gangs cannot re-shard one slice away")
            want = self._requested_chips(req)
            per_host = self.pod.chips_per_host
            if want % per_host or want // per_host < 2:
                raise errors.BadRequest(
                    f"elastic jobs must span >= 2 whole hosts: {want} "
                    f"chips is not a >= 2x multiple of {per_host} "
                    f"chips/host")
            min_members = req.min_members or 1
            if not 1 <= min_members <= want // per_host:
                raise errors.BadRequest(
                    f"minMembers must be in [1, {want // per_host}], "
                    f"got {min_members}")
        elif req.min_members:
            raise errors.BadRequest("minMembers requires elastic: true")
        priority = self._resolve_priority(req.priority_class)
        seq = self.admission.next_seq() if self.admission is not None else 0
        with self._locks.hold(base):
            if self.versions.contains(base):
                raise errors.ContainerExisted(f"job {base}")
            try:
                st = self._run_version(
                    base, req.image_name, req.cmd, req.env, req.binds,
                    req.chip_count, req.accelerator_type,
                    num_slices=req.num_slices,
                    carry={"priority_class": priority,
                           "submitted_seq": seq,
                           "elastic": req.elastic,
                           "min_members": min_members,
                           "members_desired": (
                               self._requested_chips(req)
                               // self.pod.chips_per_host
                               if req.elastic else 0)},
                )
            except (errors.ChipNotEnough, errors.PortNotEnough) as e:
                if self.admission is None or not self.admission.enabled:
                    # legacy first-fit-or-refuse, byte-for-byte
                    raise
                want = self._requested_chips(req)
                if want > self.pod.n_chips:
                    # can NEVER place, even on an empty pool: queueing it
                    # would park it forever — hard-fail, flagged so the
                    # caller knows the market declined it on principle
                    e.data = {"queueable": False}
                    raise
                return self.admission.enqueue(base, req, want, priority)
            log.info("run job %s: %d chips over %d hosts (%d slices)",
                     st.job_name, st.chip_count, len(st.placements),
                     st.num_slices)
            return self._info_dict(st)

    def patch_job_chips(self, name: str, req: JobPatchChips) -> dict:
        """Rolling rescale (BASELINE config #5), sequenced per SURVEY.md §5.4:

        Fast path (pool fits old+new): allocate the new slice and **create**
        its containers while the old job still runs, quiesce the old job
        (graceful stop ⇒ checkpoint flush), then **start** the new one —
        downtime is only the stop+start window, and the two versions never
        run concurrently against the shared checkpoint binds.

        Fallback (pool too small for both): quiesce and free the old slice
        first, then allocate; on failure, re-launch the old shape
        (best-effort compensation — another family could race for the freed
        capacity; the failure is logged and re-raised either way).
        """
        if req.chip_count <= 0 and not req.accelerator_type:
            raise errors.BadRequest("chipCount or acceleratorType required")
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            base, _, latest_name = self._resolve_latest(name)
            old = self.store.get_job(latest_name)
            if old.phase in ("queued", "preempted"):
                raise errors.BadRequest(
                    f"job {base} is {old.phase} (admission queue); it has "
                    "no running gang to rescale — stop or delete it, or "
                    "wait for admission")
            if old.phase in SCALING_PHASES:
                raise errors.BadRequest(
                    f"job {base} has an elastic resize in flight; retry "
                    "after it settles")
            want = req.chip_count
            if req.accelerator_type:
                from tpu_docker_api_torch.scheduler.topology import parse_accelerator_type
                _, want = parse_accelerator_type(req.accelerator_type)
            if want == old.chip_count:
                raise errors.NoPatchRequired(f"job {latest_name} already has {want} chips")
            # reject never-satisfiable asks BEFORE touching the running job
            # (a deterministic validation error must not bounce a healthy
            # workload through quiesce/free/relaunch)
            # capacity that even a freed old slice cannot provide — fail
            # before touching the running job. Shape infeasibilities
            # (non-multiple counts, untileable host blocks) surface as
            # BadRequest from the scheduler itself, which the fast path below
            # does NOT catch — so they also propagate without a quiesce.
            if want > self.pod.n_chips:
                raise errors.ChipNotEnough(
                    f"want {want} chips, pod has {self.pod.n_chips}")

            # identity travels with the family across versions: priority
            # class and seniority (and the budgets) must survive a rescale
            carry = self._carry_identity(old)
            if old.elastic:
                # a user rescale rewrites the elastic contract's notion of
                # "full size" — grow-back targets the new shape, and the
                # shape must stay legal for it
                per_host = self.pod.chips_per_host
                if want % per_host or want // per_host < 2:
                    raise errors.BadRequest(
                        f"job {base} is elastic: chip counts must stay "
                        f"whole-host multiples spanning >= 2 hosts "
                        f"({per_host} chips/host)")
                if want // per_host < max(old.min_members, 1):
                    raise errors.BadRequest(
                        f"job {base} is elastic: {want} chips is below "
                        f"minMembers {old.min_members}")
                carry["members_desired"] = want // per_host
            st = self._swap_version(
                base, old, carry,
                lambda start_now: self._run_version(
                    base, old.image, old.cmd, old.env, old.binds,
                    want, req.accelerator_type, start_now=start_now,
                    num_slices=old.num_slices, carry=carry))
            log.info("rescaled job %s: %d → %d chips (%s)", base,
                     old.chip_count, st.chip_count, st.job_name)
            return self._info_dict(st)

    def replace_job_spec(self, name: str, image: str, cmd: list[str],
                         env: list[str], binds: list[str]) -> dict:
        """Rolling spec replace — the weight-update flow (service/serving.py
        rides this for per-replica rollouts): same chip count, new
        image/cmd/env/binds, sequenced exactly like ``patch_job_chips``:

        Fast path (pool fits old+new): allocate + **create** the new gang
        while the old one runs, quiesce the old gang (checkpoint flush),
        **start** the new one, free the old slice. Fallback (pool too
        small for both): quiesce and free first, then allocate; on failure
        re-launch the old spec (best-effort compensation).

        A queued/preempted job has no gang to roll: its stored spec is
        rewritten in place — the admission loop resolves the spec at
        placement time, so the next admission launches the new version.
        """
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            base, _, latest_name = self._resolve_latest(name)
            old = self.store.get_job(latest_name)
            if old.phase == "failed":
                raise errors.BadRequest(
                    f"job {base} is failed: {old.failure_reason}")
            if old.phase in ("queued", "preempted"):
                new = JobState.from_dict({
                    **old.to_dict(), "image": image, "cmd": list(cmd),
                    "env": list(env), "binds": list(binds)})
                self.store.put_job(new)
                return self._info_dict(new)
            if old.phase in SCALING_PHASES:
                raise errors.BadRequest(
                    f"job {base} has an elastic resize in flight; retry "
                    "after it settles")
            carry = self._carry_identity(old)
            st = self._swap_version(
                base, old, carry,
                lambda start_now: self._run_version(
                    base, image, cmd, env, binds, old.chip_count,
                    start_now=start_now, num_slices=old.num_slices,
                    carry=carry))
            log.info("rolled job %s spec: %s → %s (%s)", base, old.image,
                     image, st.job_name)
            return self._info_dict(st)

    def stop_job(self, name: str) -> None:
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            st = self.store.get_job(latest_name)
            # gateway handshake first: a service-owned replica's draining
            # marker is durable (and acked by live gateways) strictly
            # before the first member stop; plain gangs skip the write
            st = self._predrain(st)
            # gang quiesce: workers drain first, the coordinator last, so
            # collective peers never outlive their rendezvous point (a
            # queued job has no members — the batch is empty — and a
            # preempted one is already quiesced; both still settle as
            # "stopped" below, which is what DEQUEUES them)
            self._stop_members(st, reverse=True)
            self.store.put_job(JobState.from_dict(
                {**st.to_dict(), "desired_running": False, "phase": "stopped",
                 "draining": False}
            ))
            if self.admission is not None and self.admission.enabled:
                # stop dequeues: a deliberately stopped job must not be
                # admitted (or re-admitted) behind the operator's back.
                # (Gated on enabled: the legacy deployment must not pay a
                # journal scan per stop on a queue that cannot exist.)
                self.admission.discard(base)
                self.admission.wake()
            self._emit("job-stopped", st.job_name)

    def restart_job(self, name: str) -> dict:
        """User-requested whole-gang restart. Gang ordering, not N isolated
        ``container_restart`` calls: stop every member (coordinator last),
        then start the full gang in process order via the same path
        ``_create_and_start`` uses — the coordinator comes up first so peers
        find it. Resets the supervisor's restart budget (a manual restart is
        a fresh start, not a crash)."""
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            st = self.store.get_job(latest_name)
            if st.phase == "failed":
                raise errors.BadRequest(
                    f"job {base} is failed ({st.failure_reason or 'crash loop'});"
                    " its slices and ports were freed — delete and re-run it")
            if st.phase in ("queued", "preempted"):
                raise errors.BadRequest(
                    f"job {base} is {st.phase} (admission queue); it starts "
                    "automatically when capacity allows — stop or delete "
                    "to cancel")
            if st.phase in SCALING_PHASES:
                raise errors.BadRequest(
                    f"job {base} has an elastic resize in flight; the "
                    "reconciler finishes it")
            # a stopped job normally RETAINS its grant for exactly this
            # resume — but one stopped out of queued/preempted owns
            # nothing (the market released it), and starting its old
            # members would double-bind chips the scheduler may have
            # granted elsewhere
            if not st.placements:
                raise errors.BadRequest(
                    f"job {base} was never placed (stopped while queued); "
                    "delete and re-run it")
            owners = ([latest_name] if st.num_slices == 1 else
                      [f"{latest_name}#s{k}" for k in range(st.num_slices)])
            if any(self.slices.get_grant(o) is None for o in owners):
                raise errors.BadRequest(
                    f"job {base} no longer holds its slice grant (it was "
                    "preempted before stopping); delete and re-run it")
            # validate every placement host BEFORE stopping anything: a
            # stale placement must not take a healthy gang down halfway
            for host_id, cname, *_ in st.placements:
                if self.pod.hosts.get(host_id) is None:
                    raise errors.ContainerNotExist(
                        f"{cname}: host {host_id} is no longer in the pod")
            self._stop_members(st, reverse=True)
            st = JobState.from_dict({**st.to_dict(), "desired_running": True,
                                     "phase": "running", "restarts": 0,
                                     "migrations": 0, "resizes": 0,
                                     "failure_reason": ""})
            # store record first: if a member start fails below, the family
            # still wants to run and the supervisor/reconciler finish the gang
            self.store.put_job(st)
            self._start_members(st)
            self._emit("job-restarted", st.job_name, manual=True)
            return self._info_dict(st)

    def restart_gang(self, name: str, reason: str = "",
                     count_restart: bool = True) -> JobState:
        """Whole-gang crash recovery (docs/robustness.md): one dead member
        wedges every surviving peer of the ``torch.distributed`` collective, so
        the only sound repair is stop-everything → start-everything, resuming
        from the shared checkpoint binds. Never restarts a member in
        isolation. ``count_restart=False`` is the adoption path (reconciler
        finishing a restart that a daemon death interrupted) — the attempt
        was already counted when the dying daemon marked the job
        ``restarting``."""
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            st = self.store.get_job(latest_name)
            if st.phase == "failed":
                raise errors.BadRequest(
                    f"job {base} is failed: {st.failure_reason}")
            if st.phase == "migrating":
                # a migration is in flight (or awaiting adoption): crash
                # recovery must finish THAT, not restart onto a placement
                # that still names the dead host
                raise errors.BadRequest(
                    f"job {base} is migrating off unhealthy hosts")
            if st.phase in SCALING_PHASES:
                # same rule for an in-flight resize: finishing the resize
                # IS the recovery (resize_gang restarts the gang at the
                # target size); a bare gang restart would revive the old
                # shape the resize already quiesced
                raise errors.BadRequest(
                    f"job {base} has an elastic resize in flight")
            if st.phase in ("queued", "preempted"):
                # dormant: no gang exists (or it is already quiesced and
                # released) — the admission loop owns the next transition
                raise errors.BadRequest(
                    f"job {base} is {st.phase}; admission re-places it")
            if not st.desired_running:
                # callers decide to recover on a pre-lock snapshot; a user
                # stop that raced in wins — crash recovery must not revive
                # a deliberately stopped gang
                raise errors.BadRequest(f"job {base} is stopped")
            if not self._any_member_down(st):
                # stale snapshot the other way: someone else (manual
                # restart_job, an overlapping reconcile sweep) already
                # recovered the gang — bouncing a healthy gang would kill
                # training progress and burn a budget unit for nothing
                if st.phase == "restarting":
                    st = JobState.from_dict(
                        {**st.to_dict(), "phase": "running"})
                    self.store.put_job(st)
                self._emit("gang-restart-skipped", st.job_name,
                           reason="all members already running")
                return st
            # persist intent FIRST: a daemon death anywhere below leaves
            # phase == "restarting", which the reconciler adopts by finishing
            # the restart (without re-counting it against the budget)
            st = JobState.from_dict({**st.to_dict(), "phase": "restarting",
                                     "desired_running": True,
                                     "restarts": st.restarts
                                     + (1 if count_restart else 0)})
            self.store.put_job(st)
            crash_point("job.gang.after_mark_restarting")
            # stop survivors in reverse process order (coordinator last)
            self._stop_members(st, reverse=True)
            crash_point("job.gang.after_stop_all")
            # start the FULL gang in process order — coordinator first, the
            # ordering _create_and_start/_host_order established
            self._start_members(st)
            st = JobState.from_dict({**st.to_dict(), "phase": "running"})
            self.store.put_job(st)
            self._emit("gang-restarted", st.job_name, reason=reason,
                       attempt=st.restarts)
            log.info("gang restart of %s (attempt %d): %s", st.job_name,
                     st.restarts, reason or "requested")
            return st

    def migrate_gang(self, name: str, exclude_hosts: set[str],
                     reason: str = "", count_migration: bool = True,
                     release_first_ok: bool = True) -> JobState:
        """Move a whole gang off unhealthy (or draining) hosts: quiesce
        survivors gang-ordered, release the slice, re-apply EXCLUDING
        ``exclude_hosts``, and start the gang on the new placement — the
        repair for faults no restart can fix (a gang restart would re-place
        members onto the same dead host via the still-held grant). Charged
        to the separate ``job_max_migrations`` budget (``count_migration``;
        the supervisor enforces the cap) so host faults never consume the
        crash-restart budget.

        Sequencing mirrors ``patch_job_chips``: the fast path allocates the
        new slice and CREATES its containers while the old gang still holds
        its grant, so a capacity failure leaves the old gang untouched;
        only when the pool cannot hold both does it release first
        (``release_first_ok`` — sound for a host-down migration, where the
        old placement is already broken, but forbidden for a drain of a
        LIVE host, which must fail loudly and free nothing).

        For fault migrations (``release_first_ok=True``) ``phase =
        "migrating"`` is persisted FIRST, so a daemon death anywhere in
        the flow is adoptable: the reconciler re-runs the migration
        (``count_migration=False``) against the hosts it observes
        unreachable at adoption time. An operator DRAIN deliberately
        persists no such intent: adoption always finishes release-first,
        which would let a daemon death mid-drain stop a healthy gang and
        free its slice — the exact outcome drain promises never to
        produce. An interrupted drain converges structurally (the same
        version-shape repairs an interrupted rescale uses) and the
        operator simply re-drains.
        """
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            old = self.store.get_job(latest_name)
            if old.phase == "failed":
                raise errors.BadRequest(
                    f"job {base} is failed: {old.failure_reason}")
            if old.phase in ("queued", "preempted"):
                raise errors.BadRequest(
                    f"job {base} is {old.phase}; it holds no placement "
                    "to migrate")
            if old.phase in SCALING_PHASES:
                raise errors.BadRequest(
                    f"job {base} has an elastic resize in flight; the "
                    "reconciler finishes it (excluding unreachable hosts)")
            if not old.desired_running:
                raise errors.BadRequest(f"job {base} is stopped")
            finishing = old.phase == "migrating"
            if finishing and not release_first_ok:
                raise errors.BadRequest(
                    f"job {base} already has a fault migration in flight")
            on_excluded = sorted(
                c for h, c, *_ in old.placements if h in exclude_hosts)
            if not on_excluded and not finishing:
                # stale snapshot: nothing placed on an excluded host (an
                # earlier migration or rescale already moved the gang)
                raise errors.NoPatchRequired(
                    f"job {base} has no member on {sorted(exclude_hosts)}")
            if release_first_ok:
                old = JobState.from_dict({
                    **old.to_dict(), "phase": "migrating",
                    "migrations": old.migrations
                    + (1 if count_migration else 0),
                })
                self.store.put_job(old)
            crash_point("job.migrate.after_mark")
            carry = self._carry_identity(old)
            released = False
            try:
                # fast path: new slice + created-not-started containers
                # while the old grant still stands — capacity failure here
                # touches nothing
                st = self._run_version(
                    base, old.image, old.cmd, old.env, old.binds,
                    old.chip_count, start_now=False,
                    num_slices=old.num_slices,
                    exclude_hosts=exclude_hosts, carry=carry)
                crash_point("job.migrate.after_create_new")
            except errors.ChipNotEnough:
                if not release_first_ok:
                    # drain of a live host: fail LOUDLY, free nothing —
                    # the gang keeps running where it is (no phase was
                    # ever persisted, so there is nothing to restore)
                    self._emit("gang-migrate-failed", old.job_name,
                               reason=reason, error="no healthy capacity")
                    raise
                # host-down path: the old placement is already broken —
                # releasing it cannot lose anything that isn't lost, and
                # the freed survivors' chips are the capacity the new
                # placement needs. Quiesce is gang-ordered (workers first,
                # coordinator last); stops on unreachable hosts are
                # best-effort — the members there are beyond reach
                self._stop_members(old, reverse=True)
                self._release_version_resources(old)
                released = True
                crash_point("job.migrate.after_release")
                st = self._run_version(
                    base, old.image, old.cmd, old.env, old.binds,
                    old.chip_count, start_now=False,
                    num_slices=old.num_slices,
                    exclude_hosts=exclude_hosts, carry=carry)
            if not released:
                # fast path: the old gang still runs — quiesce it now
                # (same gang ordering / best-effort rules as above)
                self._stop_members(old, reverse=True)
            # record the retirement so supervisors and invariants read the
            # old version as settled (pointer=False: the migrated version
            # owns the family's latest pointer now)
            self.store.put_job(JobState.from_dict(
                {**old.to_dict(), "desired_running": False,
                 "phase": "stopped"}), pointer=False)
            crash_point("job.migrate.after_quiesce_old")
            self._start_members(st)
            crash_point("job.migrate.after_start_new")
            if not released:
                self._release_version_resources(old)
            self._emit("gang-migrated", st.job_name, reason=reason,
                       from_hosts=sorted(exclude_hosts),
                       migration=st.migrations)
            log.info("migrated job %s off %s → %s (migration %d): %s",
                     base, sorted(exclude_hosts), st.job_name,
                     st.migrations, reason or "requested")
            return st

    def fail_job(self, name: str, reason: str,
                 only_if_restarts_ge: int | None = None,
                 only_if_migrations_ge: int | None = None,
                 only_if_resize_attempts_ge: int | None = None) -> JobState:
        """Terminal transition: the gang crash-looped through its restart
        budget (or lost a member container entirely). Stops any survivors and
        frees every slice and port the family holds — a ``failed`` job owns
        zero resources (invariants.py), so its capacity is immediately
        reusable by the next ``run_job``. Containers are kept (stopped) for
        post-mortem until ``delete_job``.

        ``only_if_restarts_ge`` re-validates the crash-loop verdict under
        the family lock: a manual ``restart_job`` that raced in reset the
        persisted budget, and the fresh gang must not be condemned on the
        caller's stale snapshot."""
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            st = self.store.get_job(latest_name)
            if (only_if_restarts_ge is not None
                    and st.restarts < only_if_restarts_ge):
                return st
            if (only_if_migrations_ge is not None
                    and st.migrations < only_if_migrations_ge):
                return st
            if (only_if_resize_attempts_ge is not None
                    and (st.last_resize or {}).get("attempts", 0)
                    < only_if_resize_attempts_ge):
                return st
            if not st.desired_running or st.phase in ("failed", "queued",
                                                      "preempted"):
                # a user stop / delete(keep-spec) that raced in wins: the
                # caller's lock-free verdict is stale, and a deliberately
                # stopped job must not be condemned as failed — nor may a
                # queued/preempted job, whose members are supposed to be
                # absent (that is the admission queue, not a crash)
                return st
            self._stop_members(st, reverse=True)
            self._release_job_resources(base)
            st = JobState.from_dict({**st.to_dict(), "phase": "failed",
                                     "desired_running": False,
                                     "failure_reason": reason})
            self.store.put_job(st)
            if self.admission is not None and self.admission.enabled:
                self.admission.wake()  # the freed slices may admit the queue head
            self._emit("job-failed", st.job_name, reason=reason)
            log.warning("job %s failed: %s", st.job_name, reason)
            return st

    def mark_gang_completed(self, name: str) -> JobState:
        """Every member exited cleanly (code 0): the job RAN TO COMPLETION —
        that is success, not a crash, and must never burn restart budget or
        end in ``failed``. Recorded as ``stopped`` (the terminal-success
        phase): resources are retained like a user stop, freed by
        ``delete_job``."""
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            st = self.store.get_job(latest_name)
            if st.phase == "failed" or not st.desired_running:
                return st
            st = JobState.from_dict({**st.to_dict(), "phase": "stopped",
                                     "desired_running": False})
            self.store.put_job(st)
            self._emit("job-completed", st.job_name)
            log.info("job %s ran to completion (all members exited 0)",
                     st.job_name)
            return st

    def mark_gang_running(self, name: str) -> None:
        """Settle a job stuck in phase ``restarting`` whose members all run
        (daemon died between the last member start and the phase flip)."""
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            st = self.store.get_job(latest_name)
            if st.phase == "restarting":
                self.store.put_job(JobState.from_dict(
                    {**st.to_dict(), "phase": "running"}))

    def _any_member_down(self, st: JobState) -> bool:
        """True when any member is dead, missing, or on a missing host —
        i.e. the gang genuinely needs recovery. An unreachable host counts
        as down (conservative: a member whose state cannot be read cannot
        be proven healthy, and the stale-snapshot protection this check
        exists for only matters when every member is PROVABLY running)."""
        for host_id, cname, *_ in st.placements:
            host = self.pod.hosts.get(host_id)
            if host is None:
                return True
            try:
                if not host.runtime.container_inspect(cname).running:
                    return True
            except (errors.ContainerNotExist, *errors.HOST_PATH_ERRORS):
                return True
        return False

    def _release_version_resources(self, st: JobState,
                                   txn: StoreTxn | None = None) -> None:
        """Free one version's slices + every host's ports — the release
        mirror of the gang claim txn: ONE atomic apply (or deferred into a
        caller's larger batch) instead of a per-slice/per-host persist
        loop."""
        own_txn = txn is None
        if own_txn:
            txn = StoreTxn(self.store.kv)
        self._restore_slices(st.job_name, st.num_slices, txn=txn)
        self._free_state_ports(st, txn=txn)
        if own_txn:
            txn.commit()

    def _release_job_resources(self, base: str) -> None:
        """Free slices + ports of EVERY stored version of the family
        (owner-guarded restores — double frees are no-ops), batched into
        one store round trip across all versions."""
        txn = StoreTxn(self.store.kv)
        for version in self.store.history(Resource.JOBS, base):
            vname = versioned_name(base, version)
            try:
                vst = self.store.get_job(vname)
            except errors.NotExistInStore:
                continue
            self._release_version_resources(vst, txn=txn)
        txn.commit()

    def delete_job(self, name: str, req: JobDelete) -> None:
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            if self.admission is not None and self.admission.enabled:
                # delete purges the admission record FIRST — a concurrent
                # admission pass must not place a job whose family is
                # being torn down (the pass re-validates under this same
                # family lock, so record-gone ⇒ it settles and moves on)
                self.admission.discard(base)
            history = self.store.history(Resource.JOBS, base)
            release_txn = StoreTxn(self.store.kv)
            for version in history:
                vname = versioned_name(base, version)
                try:
                    st = self.store.get_job(vname)
                except errors.NotExistInStore:
                    continue
                # one concurrent batch per version: an N-member delete is
                # O(slowest engine), not O(sum)
                self._remove_pairs([(h, c) for h, c, *_ in st.placements],
                                   force=req.force)
                self._release_version_resources(st, txn=release_txn)
            release_txn.commit()
            if req.del_state_and_version_record:
                self.store.delete_family(Resource.JOBS, base)
                self.versions.remove(base)
            else:
                # keep specs for re-run; drop only the runtime artifacts —
                # but record the quiesce, or the supervisor/reconciler would
                # read the kept spec as a running job with missing members
                try:
                    st = self.store.get_job(latest_name)
                    self.store.put_job(JobState.from_dict(
                        {**st.to_dict(), "desired_running": False,
                         "phase": "stopped"}))
                except errors.NotExistInStore:
                    pass
            if self.admission is not None and self.admission.enabled:
                self.admission.wake()  # freed capacity may admit the queue head
            log.info("deleted job %s (%d versions)", base, len(history))

    def get_job_info(self, name: str) -> dict:
        """Reads are allowed on historical versions — retired versions are
        the rollback material (mirrors get_container_info semantics)."""
        base, _ = split_versioned_name(name)
        if self.versions.get(base) is None:
            raise errors.ContainerNotExist(f"job {name}")
        try:
            st = self.store.get_job(name)
        except errors.NotExistInStore:
            raise errors.ContainerNotExist(f"job {name}") from None
        return self._info_dict(st, live=True)

    def elastic_info(self, st: JobState) -> dict:
        """The elastic-contract projection ({} for non-elastic jobs) —
        ONE shape shared by ``GET /jobs/{name}`` and the supervisor's
        ``/api/v1/health/jobs`` view: minMembers/membersDesired/
        membersActual, the lastResize record, and — while shrunken — the
        grow-back record's queue position."""
        if not st.elastic:
            return {}
        out = {
            "elastic": True,
            "minMembers": max(st.min_members, 1),
            "membersDesired": st.members_desired or len(st.placements),
            "membersActual": len(st.placements),
        }
        if st.resizes:
            out["resizes"] = st.resizes
        if st.last_resize:
            lr = st.last_resize
            out["lastResize"] = {
                "direction": lr.get("direction", ""),
                "reason": lr.get("reason", ""),
                "ts": lr.get("ts", 0.0),
                "fromMembers": lr.get("fromMembers", 0),
                "toMembers": lr.get("toMembers", 0),
            }
        if (st.phase == "running" and self.admission is not None
                and len(st.placements) < (st.members_desired or 0)):
            base, _ = split_versioned_name(st.job_name)
            try:
                pos = self.admission.position(base)
            except Exception:  # noqa: BLE001 — a store hiccup must not
                # break a read-only view
                pos = None
            if pos is not None:
                out["growbackQueuePosition"] = pos
        return out

    # -- internals ---------------------------------------------------------------

    def _start_members(self, st: JobState) -> None:
        """Start in process order: coordinator first (a barrier — peers
        must find it), then the workers as one concurrent batch."""
        self._start_pairs([(h, c) for h, c, *_ in st.placements])

    def _teardown_version(self, st: JobState, rollback_to: int) -> None:
        """Remove a (possibly half-started) version's containers and free its
        resources — the compensation arm of the rescale fast path."""
        base, _ = split_versioned_name(st.job_name)
        self._remove_pairs([(h, c) for h, c, *_ in st.placements], force=True)
        self._release_version_resources(st)
        self.store.delete_version(Resource.JOBS, st.job_name)
        self.versions.rollback(base, rollback_to)

    def _stop_members(self, st: JobState, reverse: bool = False) -> None:
        """``reverse=True`` is gang ordering: every worker stops first (one
        concurrent batch — they drain in parallel), the coordinator
        (process 0) strictly LAST, after the worker batch settles, so
        peers never lose their rendezvous point while still draining.
        Stops are best-effort on unreachable hosts — a member beyond a
        dead engine cannot be drained, and every caller (quiesce, fail,
        migrate) must still make progress."""
        def stop(host_id: str, cname: str) -> None:
            host = self.pod.hosts.get(host_id)
            if host is None:
                return
            try:
                host.runtime.container_stop(cname)
            except errors.ContainerNotExist:
                pass
            except errors.HOST_PATH_ERRORS as e:
                log.warning("stop of %s skipped: %s", cname, e)

        pairs = [(h, c) for h, c, *_ in st.placements]
        # the coordinator is its own barrier-separated batch on BOTH
        # orderings; reverse additionally drains the workers in reversed
        # submission order (inert under concurrency, byte-for-byte the
        # old loop in serial mode)
        batches = ((list(reversed(pairs[1:])), pairs[:1]) if reverse
                   else (pairs[:1], pairs[1:]))
        for batch in batches:
            self.fanout.run([
                (cname, "container_stop",
                 lambda h=host_id, c=cname: stop(h, c))
                for host_id, cname in batch])

    def _free_state_ports(self, st: JobState,
                          txn: StoreTxn | None = None) -> None:
        for host_id, _, pid, _, member_port in st.placements:
            host = self.pod.hosts.get(host_id)
            if host is None:
                continue
            ports = [member_port]
            if pid == 0:
                ports.append(st.coordinator_port)
                if st.megascale_port:
                    ports.append(st.megascale_port)
            host.ports.restore_ports(ports, owner=st.job_name, txn=txn)

    def _info_dict(self, st: JobState, live: bool = False) -> dict:
        per_slice = max(len(st.placements) // st.num_slices, 1)
        out = {
            "name": st.job_name,
            "version": st.version,
            "image": st.image,
            "chipCount": st.chip_count,
            "coordinatorPort": st.coordinator_port,
            "desiredRunning": st.desired_running,
            "phase": st.phase,
            "restarts": st.restarts,
            "numSlices": st.num_slices,
            "processes": [
                {
                    "processId": pid,
                    "hostId": host_id,
                    "container": cname,
                    "chipIds": list(chips),
                    "tpuPort": tpu_port,
                    "sliceId": pid // per_slice,
                }
                for host_id, cname, pid, chips, tpu_port in st.placements
            ],
        }
        out["priorityClass"] = st.priority_class
        if st.failure_reason:
            out["failureReason"] = st.failure_reason
        if st.megascale_port:
            out["megascalePort"] = st.megascale_port
        if st.migrations:
            out["migrations"] = st.migrations
        if st.preemptions:
            out["preemptions"] = st.preemptions
        out.update(self.elastic_info(st))
        if st.phase in ("queued", "preempted") and self.admission is not None:
            base, _ = split_versioned_name(st.job_name)
            pos = self.admission.position(base)
            if pos is not None:
                out["queuePosition"] = pos
        if live:
            for proc in out["processes"]:
                host = self.pod.hosts.get(proc["hostId"])
                if host is None:
                    proc["running"] = False
                    continue
                try:
                    proc["running"] = host.runtime.container_inspect(
                        proc["container"]).running
                except errors.ContainerNotExist:
                    proc["running"] = False
                except errors.HOST_PATH_ERRORS:
                    # unknown, not dead: the PATH failed, the member may
                    # well be running — surfaced distinctly so operators
                    # don't misread a network fault as a crash
                    proc["running"] = None
                    proc["hostUnreachable"] = True
        return out
