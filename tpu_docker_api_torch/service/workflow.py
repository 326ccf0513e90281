"""Workflow resource: crash-proof DAG orchestration with exactly-once
step effects and cron (docs/robustness.md "Workflows").

The cell already chaos-proves every primitive a pipeline needs — durable
task records with replay, the capacity market, rolling
spec replacement. This module composes them into the
Argo/Kubeflow shape: a **Workflow** owns a DAG of steps, each step a
real distributed job (family ``<workflow>.s<run>_<index>``) admitted at
the workflow's priority class, artifacts handed off between steps via
shared volume binds, a ``promote`` step that rolls a Service to the
produced image through the Service rolling-update machinery, and cron
schedules with explicit missed-tick catch-up semantics.

Durable by construction:

- workflow state persists like jobs and services — immutable spec
  versions plus a ``latest`` pointer, committed in ONE atomic
  ``KV.apply`` (``StateStore._put``); the DAG's control half (per-step
  status, run ordinal, cron bookkeeping) is rewritten in place on the
  latest version;
- **every step transition journals a TaskRecord** with an idempotency
  key (``wf:<name>:r<run>:s<idx>:<effect>:a<attempt>``), so a crashed
  daemon's half-applied transition is re-executed — not re-invented —
  by the next daemon's journal replay;
- the **step-complete marker** (``WorkQueue.mark_done``) is written
  *before* any successor launches — the copy-marker pattern — so
  a replayed completion proves the step already finished and a promote
  replay proves the roll already happened (belt: the service image
  comparison; braces: the marker);
- labeled ``workflow.*`` crash points bracket every boundary
  (enqueue-step, after-launch, after-complete-marker, after-promote,
  cron-fire, create, delete-mark), and ``reconcile_workflows`` (driven
  by the Reconciler) adopts whatever a dead daemon left: launching
  steps are re-submitted (idempotency-keyed — never doubled), finished
  steps' gangs are GC'd, terminal workflows free everything, orphan
  step gangs of deleted workflows are torn down.

Failure policy: a failed step retries on the supervisor's capped
exponential backoff (``utils.backoff.backoff_delay_s``) up to its
retry budget; past budget the WHOLE workflow settles terminal
``failed`` and frees every gang it owns — a poisoned pipeline must
never pin GPUs.

The port's copy of ``tpu_docker_api/service/workflow.py``, whole: a
step's gang runs whatever image and command the step names, under the
port's rendered ``torch.distributed`` environment.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.schemas.job import JobDelete, JobRun
from tpu_docker_api_torch.schemas.service import ServicePatch
from tpu_docker_api_torch.schemas.workflow import (
    CRON_CATCHUP_POLICIES,
    WORKFLOW_OWNER_ENV,
    WORKFLOW_RUN_ENV,
    WorkflowCreate,
    WorkflowPatch,
    WorkflowState,
    WorkflowStep,
    fresh_step_status,
    owner_from_env,
    run_from_env,
    validate_dag,
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
from tpu_docker_api_torch.utils.backoff import backoff_delay_s

log = logging.getLogger(__name__)

#: job phases that mean "the step's gang ran to completion" (the
#: supervisor records clean gang exit as ``stopped`` — terminal success)
_STEP_DONE_PHASES = ("stopped",)
#: job phases that are simply in flight (admitted or waiting on capacity)
_STEP_ALIVE_PHASES = ("running", "creating", "restarting", "queued",
                      "preempted", "scaling_down", "scaling_up",
                      "migrating")


def step_base(workflow: str, run: int, index: int) -> str:
    """Step gang family name: run 2 of ``pipe`` step 1 → ``pipe.s2_1``.
    The run ordinal is baked into the name so cron re-fires never
    collide with (or adopt) a previous run's families; dots are legal
    base-name chars and '-' is the version separator and stays out."""
    return f"{workflow}.s{run}_{index}"


def split_step_base(base: str) -> tuple[str, int, int] | None:
    """``"pipe.s2_1"`` → ("pipe", 2, 1); None when not step-shaped.
    Shape alone never condemns a job — ownership is proven by the
    ``WORKFLOW_OWNER_ENV`` marker in its stored env (see _job_owner)."""
    stem, sep, tail = base.rpartition(".s")
    if not sep or not stem:
        return None
    r, sep2, i = tail.partition("_")
    if not sep2 or not r.isdigit() or not i.isdigit():
        return None
    return stem, int(r), int(i)


class WorkflowService:
    """Workflow CRUD + the DAG engine + cron + reconcile adoption."""

    def __init__(self, job_svc, store: StateStore, versions, job_versions,
                 work_queue=None, serving=None, admission=None,
                 default_class: str = "batch",
                 max_step_retries: int = 2,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 interval_s: float = 2.0,
                 registry: MetricsRegistry | None = None,
                 max_events: int = 256,
                 clock=time.time,
                 tracer=None, owns=None, store_gate=None) -> None:
        self._job = job_svc
        self._store = store
        self._versions = versions          # workflow VersionMap
        self._job_versions = job_versions
        self._wq = work_queue
        self._serving = serving
        self._admission = admission
        #: sharded writer plane: drive only workflows whose shard this
        #: process leads. Root-segment hashing (keys.shard_root) puts a
        #: workflow and all its <wf>.s<r>_<i> step gangs on ONE shard.
        self._owns = owns
        self.default_class = default_class
        self.max_step_retries = max_step_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._interval = interval_s
        self._registry = registry if registry is not None else REGISTRY
        #: wall-clock seam (cron boundaries + retry notBefore persist and
        #: must stay comparable across restarts — monotonic would not be)
        self._clock = clock
        self._tracer = tracer
        self._locks = _FamilyLocks()
        self._mu = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=max_events)
        #: store-outage hold (service/store_health.py): a step transition
        #: is a journaled two-phase effect — with no journal there is no
        #: exactly-once, so the engine observes but does not advance.
        #: None ⇒ ungated.
        self._store_gate = store_gate
        self.store_skips = 0
        self._store_held = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        if self._wq is not None:
            # registered at construction, so ANY process that can build
            # this service can replay a dead daemon's step transitions
            self._wq.register("workflow_step_launch", self._exec_step_launch)
            self._wq.register("workflow_step_complete",
                              self._exec_step_complete)
            self._wq.register("workflow_step_promote",
                              self._exec_step_promote)

    # -- helpers ------------------------------------------------------------------

    def _resolve_class(self, name: str) -> str:
        if self._admission is not None:
            return self._admission.resolve_class(name or self.default_class)
        from tpu_docker_api_torch.service.admission import DEFAULT_PRIORITY_CLASSES

        pc = name or self.default_class
        if pc not in DEFAULT_PRIORITY_CLASSES:
            raise errors.BadRequest(
                f"unknown priorityClass {pc!r}: known classes are "
                f"{sorted(DEFAULT_PRIORITY_CLASSES)}")
        return pc

    def _latest_state(self, base: str) -> WorkflowState:
        latest = self._versions.get(base)
        if latest is None:
            raise errors.WorkflowNotExist(f"workflow {base}")
        try:
            return self._store.get_workflow(versioned_name(base, latest))
        except errors.NotExistInStore:
            raise errors.WorkflowNotExist(
                f"workflow {base} (pointer v{latest} has no record; "
                "reconcile repairs it)") from None

    def _job_state(self, jb: str):
        latest = self._job_versions.get(jb)
        if latest is None:
            return None
        try:
            return self._job.store.get_job(versioned_name(jb, latest))
        except errors.NotExistInStore:
            return None

    def _job_owner(self, job_base: str) -> tuple[str, int] | None:
        """(workflow, run) owning a job family, proven by the durable env
        markers (name shape alone is only the candidate filter)."""
        if split_step_base(job_base) is None:
            return None
        jst = self._job_state(job_base)
        if jst is None:
            return None
        owner = owner_from_env(jst.env)
        if owner is None:
            return None
        run = run_from_env(jst.env)
        return (owner, run if run is not None else 0)

    def _retry_budget(self, step: WorkflowStep) -> int:
        return (step.max_retries if step.max_retries >= 0
                else self.max_step_retries)

    def _record(self, kind: str, workflow: str, **extra) -> None:
        evt = trace.stamp({"ts": time.time(), "workflow": workflow,
                           "event": kind, **extra})
        with self._mu:
            self._events.append(evt)

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            return list(self._events)[-limit:]

    def _transition(self, st: WorkflowState, phase: str,
                    reason: str) -> None:
        st.last_transition = {"ts": self._clock(), "from": st.phase,
                              "to": phase, "reason": reason}
        st.phase = phase

    def _idem_key(self, base: str, st: WorkflowState, idx: int,
                  effect: str) -> str:
        stat = st.step_status[st.spec_steps()[idx].name]
        return (f"wf:{base}:r{st.run}:s{idx}:{effect}"
                f":a{stat.get('attempts', 0)}")

    # -- CRUD ---------------------------------------------------------------------

    def create_workflow(self, req: WorkflowCreate) -> dict:
        base = req.workflow_name
        if not base or not BASE_NAME_RE.match(base):
            raise errors.BadRequest(
                f"invalid workflow name {base!r}: must be nonempty, "
                "[a-zA-Z0-9_.] only")
        validate_dag(req.steps)
        if req.cron_interval_s < 0:
            raise errors.BadRequest("cronIntervalS must be >= 0")
        if req.cron_catchup not in CRON_CATCHUP_POLICIES:
            raise errors.BadRequest(
                f"unknown cronCatchup {req.cron_catchup!r} "
                f"(known: {CRON_CATCHUP_POLICIES})")
        priority = self._resolve_class(req.priority_class)
        for s in req.steps:
            if s.kind == "promote" and self._serving is None:
                raise errors.BadRequest(
                    f"step {s.name}: promote steps need the serving "
                    "subsystem, which is not wired in this deployment")
        with self._locks.hold(base):
            if self._versions.contains(base):
                raise errors.WorkflowExisted(f"workflow {base}")
            version = self._versions.next_version(base)
            st = WorkflowState(
                workflow_name=versioned_name(base, version), version=version,
                steps=[s.to_dict() for s in req.steps],
                priority_class=priority, binds=list(req.binds),
                cron_interval_s=req.cron_interval_s,
                cron_catchup=req.cron_catchup,
                phase="running", run=0,
                step_status={s.name: fresh_step_status()
                             for s in req.steps},
                cron_enabled=req.cron_enabled,
                last_fire_ts=(self._clock()
                              if req.cron_interval_s > 0 else 0.0),
            )
            try:
                # v0 record + latest pointer in ONE apply (StateStore._put)
                # — the durable DAG every transition below derives from
                self._store.put_workflow(st)
            except Exception:
                self._versions.rollback(base, None)
                raise
            crash_point("workflow.create.after_record")
            self._advance(base, st)
            self._record("workflow-created", base, steps=len(req.steps),
                         klass=priority, cron=req.cron_interval_s)
            self._wake.set()
            log.info("created workflow %s: %d step(s), class %s, cron %ss",
                     st.workflow_name, len(req.steps), priority,
                     req.cron_interval_s or "off")
            return self.workflow_info(base)

    def patch_workflow(self, name: str, req: WorkflowPatch) -> dict:
        base, version = split_versioned_name(name)
        with self._locks.hold(base):
            st = self._latest_state(base)
            if version is not None and version != st.version:
                raise errors.VersionNotMatch(
                    f"{name}: latest version is {st.version}")
            if st.phase == "deleting":
                raise errors.BadRequest(f"workflow {base} is deleting")
            if req.cron_catchup is not None:
                if req.cron_catchup not in CRON_CATCHUP_POLICIES:
                    raise errors.BadRequest(
                        f"unknown cronCatchup {req.cron_catchup!r} "
                        f"(known: {CRON_CATCHUP_POLICIES})")
                st.cron_catchup = req.cron_catchup
            if req.cron_interval_s is not None:
                if req.cron_interval_s < 0:
                    raise errors.BadRequest("cronIntervalS must be >= 0")
                st.cron_interval_s = req.cron_interval_s
            if req.cron_enabled is not None:
                st.cron_enabled = req.cron_enabled
            if (st.cron_interval_s > 0 and st.cron_enabled
                    and st.last_fire_ts <= 0):
                # first enable of a schedule: anchor it NOW, not at epoch
                # 0 — otherwise the next tick sees eons of missed fires
                st.last_fire_ts = self._clock()
            self._store.put_workflow(st)
            self._record("workflow-patched", base,
                         cronEnabled=st.cron_enabled,
                         cronIntervalS=st.cron_interval_s,
                         cronCatchup=st.cron_catchup)
            self._wake.set()
            return self.workflow_info(base)

    def delete_workflow(self, name: str) -> None:
        base, _ = split_versioned_name(name)
        with self._locks.hold(base):
            st = self._latest_state(base)
            if st.phase != "deleting":
                # teardown intent FIRST: a crash below leaves "deleting",
                # which the reconciler finishes (one sweep, every gang)
                self._transition(st, "deleting", "operator DELETE")
                self._store.put_workflow(st)
            crash_point("workflow.delete.after_mark")
            self._finish_delete(base)
            self._record("workflow-deleted", base)
            log.info("deleted workflow %s (all step gangs torn down)", base)

    def _finish_delete(self, base: str) -> None:
        """Tear down every step gang this workflow owns (any run), then
        drop the workflow family — resumable at any point."""
        for jb in self._owned_step_families(base):
            self._teardown_step_family(jb)
        self._store.delete_family(Resource.WORKFLOWS, base)
        self._versions.remove(base)
        self._registry.gauge_set("workflow_steps_running", 0,
                                 {"workflow": base})

    def _owned_step_families(self, base: str) -> list[str]:
        out = []
        for jb in sorted(self._job_versions.snapshot()):
            parsed = split_step_base(jb)
            if parsed is None or parsed[0] != base:
                continue
            owner = self._job_owner(jb)
            if owner is not None and owner[0] == base:
                out.append(jb)
        return out

    # -- step gang plumbing -------------------------------------------------------

    def _teardown_step_family(self, jb: str) -> None:
        """Quiesce then delete a step gang, freeing slices and ports in
        one batch. A queued step simply dequeues."""
        try:
            self._job.stop_job(jb)
        except (errors.ContainerNotExist, errors.NotExistInStore):
            return
        except errors.BadRequest:
            pass  # already-terminal gang: delete below still releases
        try:
            self._job.delete_job(jb, JobDelete(
                force=True, del_state_and_version_record=True))
        except errors.ContainerNotExist:
            pass

    def _launch_gang(self, base: str, st: WorkflowState, idx: int,
                     step: WorkflowStep) -> None:
        """Submit one step gang through the job machinery at the
        workflow's class. A full pool queues it (admission enabled) and
        the admission loop backfills/preempts for it."""
        jb = step_base(base, st.run, idx)
        req = JobRun(
            image_name=step.image, job_name=jb,
            chip_count=step.chip_count,
            accelerator_type=step.accelerator_type,
            # artifact hand-off: the workflow's shared binds mount into
            # every job step, then the step's own binds on top
            binds=list(st.binds) + list(step.binds),
            env=(list(step.env)
                 + [f"{WORKFLOW_OWNER_ENV}={base}",
                    f"{WORKFLOW_RUN_ENV}={st.run}"]),
            cmd=list(step.cmd),
            priority_class=st.priority_class,
        )
        self._job.run_job(req)
        self._registry.counter_inc(
            "workflow_steps_launched_total", {"workflow": base},
            help="Step gangs launched by the workflow engine")

    # -- journaled step transitions (work-queue handlers) -------------------------
    #
    # Every effect is guarded twice: the TaskRecord's idempotency key
    # dedups concurrent submits of the same transition, and the handler
    # itself re-checks durable state (job family exists? marker written?
    # service already rolled?) so an adopted replay converges instead of
    # re-applying. All three run under the family lock — the writer loop
    # and the reconciler mutate the same control record.

    def _exec_step_launch(self, rec) -> None:
        base = rec.params["workflow"]
        run = int(rec.params["run"])
        idx = int(rec.params["step"])
        with self._locks.hold(base):
            st = self._stale_guard(base, run)
            if st is None:
                return
            steps = st.spec_steps()
            if idx >= len(steps):
                return
            step = steps[idx]
            stat = st.step_status[step.name]
            if stat["state"] != "launching":
                return  # already running/succeeded — replay converged
            jb = step_base(base, run, idx)
            if self._job_versions.get(jb) is None:
                self._launch_gang(base, st, idx, step)
            crash_point("workflow.after_launch")
            stat.update({"state": "running", "job": jb})
            self._store.put_workflow(st)
            self._record("workflow-step-running", base, step=step.name,
                         run=run, job=jb)

    def _exec_step_complete(self, rec) -> None:
        base = rec.params["workflow"]
        run = int(rec.params["run"])
        idx = int(rec.params["step"])
        with self._locks.hold(base):
            st = self._stale_guard(base, run)
            if st is None:
                return
            step = st.spec_steps()[idx]
            stat = st.step_status[step.name]
            if stat["state"] == "succeeded":
                return
            # the step-complete marker lands BEFORE the successor can
            # launch (successors only launch once this flip is durable,
            # and the flip only happens after the marker) — a replayed
            # completion proves itself instead of re-running the step
            if self._wq is not None:
                self._wq.mark_done(rec.task_id, rec.shard)
            crash_point("workflow.after_complete_marker")
            stat.update({"state": "succeeded", "error": ""})
            self._settle_if_done(base, st)
            self._store.put_workflow(st)
            # free the finished gang's chips/ports; crash between the
            # flip and this teardown is repaired by the reconcile GC
            jb = stat.get("job") or step_base(base, run, idx)
            self._teardown_step_family(jb)
            self._record("workflow-step-succeeded", base, step=step.name,
                         run=run)

    def _exec_step_promote(self, rec) -> None:
        base = rec.params["workflow"]
        run = int(rec.params["run"])
        idx = int(rec.params["step"])
        with self._locks.hold(base):
            st = self._stale_guard(base, run)
            if st is None:
                return
            step = st.spec_steps()[idx]
            stat = st.step_status[step.name]
            if stat["state"] == "succeeded":
                return
            rolled = (self._wq is not None
                      and self._wq.marker_done(rec.task_id, rec.shard))
            if not rolled:
                info = self._serving.service_info(step.service)
                if info["image"] != step.image:
                    # the exactly-once roll: replace through the Service
                    # rolling-update machinery (replace_job_spec under it)
                    self._serving.patch_service(
                        step.service, ServicePatch(image_name=step.image))
                crash_point("workflow.after_promote")
                if self._wq is not None:
                    self._wq.mark_done(rec.task_id, rec.shard)
            stat.update({"state": "succeeded", "error": ""})
            self._settle_if_done(base, st)
            self._store.put_workflow(st)
            self._record("workflow-step-promoted", base, step=step.name,
                         run=run, service=step.service, image=step.image)

    def _stale_guard(self, base: str, run: int) -> WorkflowState | None:
        """A record outlives the state it was journaled against: the
        workflow may be gone, deleting, terminal, or re-fired onto a
        newer run. Stale records no-op — the current run's own records
        drive the current run."""
        try:
            st = self._latest_state(base)
        except errors.WorkflowNotExist:
            return None
        if st.phase != "running" or st.run != run:
            return None
        return st

    # -- the DAG engine -----------------------------------------------------------

    def _deps_met(self, st: WorkflowState, step: WorkflowStep) -> bool:
        return all(st.step_status[d]["state"] == "succeeded"
                   for d in step.deps)

    def _settle_if_done(self, base: str, st: WorkflowState) -> None:
        if all(s["state"] == "succeeded" for s in st.step_status.values()):
            self._transition(st, "succeeded", "all steps succeeded")
            self._registry.counter_inc(
                "workflow_runs_completed_total",
                {"workflow": base, "result": "succeeded"},
                help="Workflow runs that reached a terminal phase")

    def _fail_workflow(self, base: str, st: WorkflowState,
                       step: WorkflowStep, reason: str) -> None:
        """Past-budget settlement: terminal ``failed``, durably, THEN
        free every gang of the run — a crash mid-teardown leaves the
        terminal phase behind and the reconcile GC finishes the sweep."""
        stat = st.step_status[step.name]
        stat.update({"state": "failed", "error": reason})
        self._transition(st, "failed",
                         f"step {step.name} exhausted its retry budget: "
                         f"{reason}")
        self._store.put_workflow(st)
        self._registry.counter_inc(
            "workflow_runs_completed_total",
            {"workflow": base, "result": "failed"},
            help="Workflow runs that reached a terminal phase")
        for jb in self._owned_step_families(base):
            self._teardown_step_family(jb)
        self._record("workflow-failed", base, step=step.name, reason=reason)

    def _step_job_verdict(self, base: str, st: WorkflowState, idx: int,
                          step: WorkflowStep) -> str | None:
        """What the live job says about a ``running`` step: "done",
        "failed", or None (still in flight)."""
        jb = step_base(base, st.run, idx)
        jst = self._job_state(jb)
        if jst is None:
            # the gang vanished under us (external delete, store repair):
            # that is a failed attempt, not a success
            return "failed"
        if jst.phase in _STEP_DONE_PHASES:
            return "done"
        if jst.phase == "failed":
            return "failed"
        return None

    def _advance(self, base: str, st: WorkflowState,
                 actions: list[dict] | None = None,
                 dry_run: bool = False) -> None:
        """Drive one workflow's DAG one increment forward: launch ready
        steps (durable flip + journaled record), settle finished gangs
        through the completion records, retry or fail past budget, GC
        completed steps' leftovers. The shared engine under the writer
        tick, create, and the reconciler's adoption pass (``actions``
        collects what was done)."""
        def act(kind: str, target: str, fn) -> None:
            if actions is not None:
                actions.append({"action": kind, "target": target})
            if not dry_run:
                fn()

        if st.phase != "running":
            return
        steps = st.spec_steps()
        now = self._clock()
        for idx, step in enumerate(steps):
            stat = st.step_status[step.name]
            state = stat["state"]
            jb = step_base(base, st.run, idx)
            if state == "pending":
                if not self._deps_met(st, step):
                    continue
                if now < float(stat.get("notBefore", 0.0)):
                    continue  # retry backoff still cooling
                act("launch-step", f"{base}:{step.name}",
                    lambda i=idx, s=step: self._begin_launch(base, st, i, s))
            elif state == "launching":
                # the durable flip exists but the record may have been
                # lost pre-journal (crash between the flip apply and the
                # submit) — re-submit; the idempotency key makes a still-
                # active record absorb this instead of doubling
                act("resubmit-step", f"{base}:{step.name}",
                    lambda i=idx, s=step: self._submit_step(base, st, i, s))
            elif state == "running":
                verdict = self._step_job_verdict(base, st, idx, step)
                if verdict == "done":
                    act("complete-step", f"{base}:{step.name}",
                        lambda i=idx: self._submit_transition(
                            base, st, i, "workflow_step_complete",
                            "complete"))
                elif verdict == "failed":
                    act("retry-or-fail-step", f"{base}:{step.name}",
                        lambda i=idx, s=step, j=jb:
                            self._step_failed(base, st, i, s, j))
            elif state == "succeeded":
                # crash window between the flip and the gang teardown:
                # a finished step must not keep chips
                if self._job_versions.get(jb) is not None:
                    act("gc-finished-step-gang", jb,
                        lambda j=jb: self._teardown_step_family(j))

    def _begin_launch(self, base: str, st: WorkflowState, idx: int,
                      step: WorkflowStep) -> None:
        """The enqueue-step boundary: flip to ``launching`` durably,
        journal the launch record, THEN the crash point — a kill here
        leaves a durable intent either side of which reconcile/replay
        finishes (flip without record ⇒ resubmit; record ⇒ replay)."""
        stat = st.step_status[step.name]
        stat["state"] = "launching"
        self._store.put_workflow(st)
        self._submit_step(base, st, idx, step)
        crash_point("workflow.enqueue_step")
        self._record("workflow-step-launching", base, step=step.name,
                     run=st.run)

    def _submit_step(self, base: str, st: WorkflowState, idx: int,
                     step: WorkflowStep) -> None:
        kind = ("workflow_step_promote" if step.kind == "promote"
                else "workflow_step_launch")
        self._submit_transition(base, st, idx, kind, "launch")

    def _submit_transition(self, base: str, st: WorkflowState, idx: int,
                           kind: str, effect: str) -> None:
        if self._wq is None:
            raise errors.BadRequest(
                "workflow engine needs the durable work queue")
        self._wq.submit_record(
            kind, {"workflow": base, "run": st.run, "step": idx},
            idempotency_key=self._idem_key(base, st, idx, effect))

    def _step_failed(self, base: str, st: WorkflowState, idx: int,
                     step: WorkflowStep, jb: str) -> None:
        stat = st.step_status[step.name]
        jst = self._job_state(jb)
        reason = (jst.failure_reason or "gang failed"
                  if jst is not None else "step gang vanished")
        budget = self._retry_budget(step)
        attempts = int(stat.get("attempts", 0))
        if attempts >= budget:
            self._fail_workflow(base, st, step, reason)
            return
        # retry: free the carcass, then re-arm the step behind the
        # supervisor-style capped exponential backoff — the bumped
        # attempt count makes the NEXT launch a fresh idempotency key
        delay = backoff_delay_s(attempts, self.backoff_base_s,
                                self.backoff_max_s)
        stat.update({"state": "pending", "attempts": attempts + 1,
                     "error": reason, "job": "",
                     "notBefore": self._clock() + delay})
        self._store.put_workflow(st)
        self._teardown_step_family(jb)
        self._registry.counter_inc(
            "workflow_step_retries_total", {"workflow": base},
            help="Step attempts retried after a gang failure")
        self._record("workflow-step-retry", base, step=step.name,
                     attempt=attempts + 1, budget=budget,
                     delayS=round(delay, 3), reason=reason)

    # -- cron ---------------------------------------------------------------------

    def _cron_check(self, base: str, st: WorkflowState) -> None:
        """Fire, suppress, or realign one workflow's schedule. All
        bookkeeping lands in ONE durable apply before the crash point —
        a killed daemon either never fired (tick boundary not crossed in
        the store) or durably fired (reconcile drives the new run)."""
        if st.cron_interval_s <= 0 or not st.cron_enabled:
            return
        if st.phase == "deleting":
            return
        now = self._clock()
        k = int((now - st.last_fire_ts) // st.cron_interval_s)
        if k <= 0:
            return
        if st.phase == "running":
            # overlapping-run suppression: the previous run is still in
            # flight — those boundaries fire nothing, and the schedule
            # realigns so the backlog never bursts when the run ends
            st.suppressed_ticks += k
            st.last_fire_ts += k * st.cron_interval_s
            self._store.put_workflow(st)
            self._registry.counter_inc(
                "workflow_cron_suppressed_total", {"workflow": base},
                help="Cron ticks suppressed by an overlapping run")
            self._record("workflow-cron-suppressed", base, ticks=k,
                         run=st.run)
            return
        missed = k - 1
        if missed > 0 and st.cron_catchup == "skip":
            # missed-tick policy "skip": the downtime's boundaries are
            # gone — realign to the NEXT future boundary, fire nothing
            st.skipped_ticks += k
            st.last_fire_ts += k * st.cron_interval_s
            self._store.put_workflow(st)
            self._record("workflow-cron-skipped", base, ticks=k)
            return
        # on-time fire (k == 1) or "fire_once" catch-up: exactly ONE
        # fresh run covers every elapsed boundary
        st.run += 1
        st.fired_runs += 1
        st.skipped_ticks += missed
        st.last_fire_ts += k * st.cron_interval_s
        st.step_status = {s.name: fresh_step_status()
                          for s in st.spec_steps()}
        self._transition(st, "running",
                         f"cron fire (run {st.run}"
                         + (f", caught up {missed} missed" if missed
                            else "") + ")")
        self._store.put_workflow(st)
        crash_point("workflow.cron_fire")
        self._registry.counter_inc(
            "workflow_cron_fires_total", {"workflow": base},
            help="Cron runs fired")
        self._record("workflow-cron-fired", base, run=st.run,
                     caughtUp=missed)
        self._advance(base, st)

    # -- writer tick --------------------------------------------------------------

    def tick(self) -> None:
        """One engine pass over every workflow: cron check + DAG advance.
        Public — tests and the bench drive it inline the way the
        autoscaler's ``tick`` is driven."""
        if self._store_gate is not None and not self._store_gate():
            # store outage: hold the engine — cron fires and step
            # transitions journal before acting. Edge-triggered event.
            self.store_skips += 1
            if not self._store_held:
                self._store_held = True
                self._record("store-outage-hold", "*")
            return
        if self._store_held:
            self._store_held = False
            self._record("store-outage-over", "*")
        with trace.pass_span(self._tracer, "workflow.tick"):
            self._tick_inner()

    def _tick_inner(self) -> None:
        for base in sorted(self._versions.snapshot()):
            if self._owns is not None and not self._owns(base):
                continue
            try:
                with self._locks.hold(base):
                    try:
                        st = self._latest_state(base)
                    except errors.WorkflowNotExist:
                        continue
                    self._cron_check(base, st)
                    if st.phase == "running":
                        self._advance(base, st)
                    self._update_gauges(base, st)
            except Exception:  # noqa: BLE001 — one workflow must not
                # starve the others; SimulatedCrash (BaseException)
                # still propagates — that is the chaos harness's kill
                log.exception("workflow pass for %s failed", base)

    # -- reconciliation (driven by the Reconciler) --------------------------------

    def reconcile_workflows(self, dry_run: bool = False) -> list[dict]:
        """Adopt whatever a dead daemon left mid-DAG:

        - a pointer with no record rolls back (or the family drops);
        - phase ``deleting`` finishes the teardown sweep;
        - terminal workflows (``succeeded``/``failed``) free any gang
          still standing — terminal owns nothing;
        - running workflows advance: launching steps re-submit
          (idempotency-keyed), finished gangs complete, failures retry
          or settle terminal;
        - step gangs whose owning workflow is GONE, or that belong to a
          superseded cron run, are garbage-collected (marker-verified).
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
                    st = self._store.get_workflow(latest_name)
                except (ValueError, KeyError, TypeError, AttributeError) as e:
                    # poison-record quarantine: an unparseable record must
                    # skip THIS family loudly, not abort the workflow sweep
                    actions.append({"action": "quarantine-poison-record",
                                    "target": latest_name,
                                    "resource": "workflows",
                                    "error": f"{type(e).__name__}: {e}"})
                    self._registry.counter_inc(
                        "reconcile_quarantined_total",
                        {"resource": "workflows"},
                        help="Families skipped because their stored record "
                             "is corrupt")
                    continue
                except errors.NotExistInStore:
                    stored = self._store.history(Resource.WORKFLOWS, base)
                    prev = max((v for v in stored if v < latest),
                               default=None)
                    if prev is None:
                        actions.append(
                            {"action": "drop-empty-workflow-family",
                             "target": base})
                        if not dry_run:
                            self._versions.remove(base)
                    else:
                        actions.append(
                            {"action": "rollback-workflow-pointer",
                             "target": latest_name, "to": prev})
                        if not dry_run:
                            self._versions.rollback(base, prev)
                    continue
                if st.phase == "deleting":
                    actions.append({"action": "finish-workflow-delete",
                                    "target": base})
                    if not dry_run:
                        self._finish_delete(base)
                        self._record("workflow-deleted", base,
                                     via="reconcile")
                    continue
                if st.phase in ("succeeded", "failed"):
                    for jb in self._owned_step_families(base):
                        actions.append({"action": "gc-terminal-workflow-gang",
                                        "target": jb})
                        if not dry_run:
                            self._teardown_step_family(jb)
                    continue
                self._advance(base, st, actions=actions, dry_run=dry_run)
        known = set(self._versions.snapshot())
        for jb in sorted(self._job_versions.snapshot()):
            if self._owns is not None and not self._owns(jb):
                continue
            owner = self._job_owner(jb)
            if owner is None:
                continue
            wf, run = owner
            if wf not in known:
                actions.append({"action": "gc-orphan-step-gang",
                                "target": jb, "workflow": wf})
                if not dry_run:
                    self._teardown_step_family(jb)
                continue
            cur = self._versions.get(wf)
            if cur is None:
                continue
            with contextlib.suppress(errors.WorkflowNotExist):
                if run < self._latest_state(wf).run:
                    actions.append({"action": "gc-stale-run-gang",
                                    "target": jb, "workflow": wf,
                                    "run": run})
                    if not dry_run:
                        self._teardown_step_family(jb)
        return actions

    # -- loop lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Launch the engine loop (a WRITER: leader-only under leader
        election; restartable on re-acquire)."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="workflow", daemon=True)
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
                log.exception("workflow tick failed")

    # -- views / telemetry --------------------------------------------------------

    def _update_gauges(self, base: str,
                       st: WorkflowState | None = None) -> None:
        try:
            st = st or self._latest_state(base)
        except errors.WorkflowNotExist:
            return
        running = sum(1 for s in st.step_status.values()
                      if s["state"] in ("launching", "running"))
        self._registry.gauge_set(
            "workflow_steps_running", running, {"workflow": base},
            help="Steps currently launching or running per workflow")

    def workflow_info(self, name: str) -> dict:
        """GET /workflows/{name}: spec + per-step status with the live
        gang phase — the no-log-reading audit of where the DAG stands."""
        base, _ = split_versioned_name(name)
        st = self._latest_state(base)
        steps = []
        for idx, step in enumerate(st.spec_steps()):
            stat = st.step_status[step.name]
            entry = {
                "name": step.name, "kind": step.kind,
                "deps": list(step.deps),
                "state": stat["state"],
                "attempts": int(stat.get("attempts", 0)),
                "error": stat.get("error", ""),
            }
            jb = stat.get("job") or step_base(base, st.run, idx)
            jst = self._job_state(jb)
            if jst is not None:
                entry["job"] = jb
                entry["jobPhase"] = jst.phase
                if jst.phase in ("queued", "preempted") \
                        and self._admission is not None:
                    pos = self._admission.position(jb)
                    if pos is not None:
                        entry["queuePosition"] = pos
            if float(stat.get("notBefore", 0.0)) > self._clock():
                entry["retryNotBefore"] = stat["notBefore"]
            if step.kind == "promote":
                entry["service"] = step.service
                entry["image"] = step.image
            steps.append(entry)
        out = {
            "name": st.workflow_name,
            "version": st.version,
            "phase": st.phase,
            "run": st.run,
            "priorityClass": st.priority_class,
            "binds": list(st.binds),
            "steps": steps,
            "lastTransition": st.last_transition or None,
            "cron": {
                "intervalS": st.cron_interval_s,
                "enabled": st.cron_enabled,
                "catchup": st.cron_catchup,
                "lastFireTs": st.last_fire_ts,
                "firedRuns": st.fired_runs,
                "suppressedTicks": st.suppressed_ticks,
                "skippedTicks": st.skipped_ticks,
            },
        }
        return out

    SUMMARY_KEYS = ("name", "version", "phase", "run", "priorityClass",
                    "lastTransition")

    def workflow_summary(self, base: str) -> dict | None:
        """One list-entry view (None for a family that vanished between
        the name scan and the read — lists never 404 mid-walk)."""
        try:
            info = self.workflow_info(base)
        except errors.WorkflowNotExist:
            return None
        out = {k: info[k] for k in self.SUMMARY_KEYS}
        out["steps"] = {s["name"]: s["state"] for s in info["steps"]}
        return out

    def list_workflows(self) -> list[dict]:
        out = []
        for base in sorted(self._versions.snapshot()):
            s = self.workflow_summary(base)
            if s is not None:
                out.append(s)
        return out
