"""Labeled crash points for the chaos harness (docs/robustness.md).

Service mutations call :func:`crash_point` at the places where a daemon
kill would leave the KV store and the runtime disagreeing. In production
the calls are no-ops (one global ``is None`` check). The crash-consistency
tests arm a label and the call raises :class:`SimulatedCrash`, which
deliberately derives from ``BaseException`` so the services' ``except
Exception`` rollback paths do NOT run — exactly like ``kill -9``, the
in-process compensation never gets a chance. The test then boots a fresh
``Program`` over the same KV + runtime and its reconciler
(service/reconcile.py) repairs the drift.

The port's copy of ``tpu_docker_api/service/crashpoints.py``: the same
labels, so both packages' chaos matrices iterate one set.
"""

from __future__ import annotations

import contextlib
import threading

#: every label compiled into the services, so tests can iterate "all crash
#: points" without grepping (each insertion site registers itself here)
CONTAINER_CRASH_POINTS = (
    # _run_new_version: version pointer bumped + persisted, no container yet
    "replace.after_version_bump",
    # _rolling_replace: new container created + spec persisted, old untouched
    "replace.after_create_new",
    # _rolling_replace: old container stopped, its ports freed, copy not queued
    "replace.after_quiesce_old",
    # patch_container_chips: extra chips claimed, no new version yet
    "patch.after_alloc",
    # patch_container_chips: replacement rolled, shrink chips not yet released
    "patch.after_replace",
)

#: gang-level crash points (service/job.py + service/job_supervisor.py)
JOB_CRASH_POINTS = (
    # _run_version: job version pointer bumped, no slices/containers yet
    "job.run.after_version_bump",
    # _run_version: slices claimed + all member containers created (and, on
    # the run path, started), JobState NOT yet persisted
    "job.run.after_create",
    # patch_job_chips fast path: new gang created (not started), old gang
    # quiesced and marked stopped, new members not started
    "job.patch.after_quiesce_old",
    # patch_job_chips fast path: new gang started, old slice/ports not freed
    "job.patch.after_start_new",
    # restart_gang: phase=restarting persisted, members not yet stopped
    "job.gang.after_mark_restarting",
    # restart_gang: every member stopped, none started again
    "job.gang.after_stop_all",
    # migrate_gang: phase=migrating persisted, nothing else touched
    "job.migrate.after_mark",
    # migrate_gang fast path: new gang created (not started) on healthy
    # hosts, old gang still holds its slice
    "job.migrate.after_create_new",
    # migrate_gang release-first path: old gang stopped and its slices and
    # ports freed, new version not yet allocated
    "job.migrate.after_release",
    # migrate_gang: old gang quiesced and marked stopped, new not started
    "job.migrate.after_quiesce_old",
    # migrate_gang: new gang started, old slice/ports not yet freed
    "job.migrate.after_start_new",
)

#: durable work-queue lifecycle (state/workqueue.py _run_record): the
#: journal closes the last volatile control-plane state, and these three
#: points prove replay converges from every lifecycle boundary
QUEUE_CRASH_POINTS = (
    # record marked inflight in the journal, side effects not yet run
    "queue.claim",
    # side effects ran (copy-complete marker written, follow-up done),
    # the ack (journal delete) not yet persisted
    "queue.exec",
    # ack persisted — nothing durable left, only loop bookkeeping
    "queue.ack",
)

#: KV-transaction boundary (state/kv.py ``KV.apply``): every batched
#: version transition commits through here, so two labels prove the whole
#: contract — pre-txn crash ⇒ nothing applied, post-txn crash ⇒ everything
#: applied and the reconciler finishes the flow forward
TXN_CRASH_POINTS = (
    # ops validated, the atomic commit not yet issued
    "txn.before_apply",
    # the atomic commit is durable, the flow's remaining steps are not
    "txn.after_apply",
)

#: leader-election lifecycle (service/leader.py): the failover chaos matrix
#: kills the leader daemon at each of these and proves the standby acquires
#: within the lease TTL, replays the journal, and converges — while the
#: deposed leader's epoch-fenced writes are rejected
LEADER_CRASH_POINTS = (
    # lease + epoch durably written (we hold leadership), the on-acquire
    # callbacks (writer-subsystem boot, startup reconcile) not yet run
    "leader.after_acquire",
    # writer subsystems started and the startup reconcile/replay finished —
    # the steady state every established leader dies from
    "leader.after_start_writers",
    # heartbeat renewal landed: the lease deadline was just pushed out, so
    # a standby must wait out the FULL TTL before stealing
    "leader.after_renew",
)

#: cross-shard coordination record (service/shard.py ShardedKV): a write
#: batch spanning shards CAS-bumps keys.SHARD_COORD_KEY inside ONE atomic
#: apply — so either crash side leaves the store consistent, and the shard
#: chaos matrix proves a takeover from each converges (the batch is all-in
#: with the seq bump, or absent entirely)
SHARD_CRASH_POINTS = (
    # seq re-read and the coordinated batch built; NOTHING applied yet
    "shard.coord.before_apply",
    # the batch + seq bump are durable in one apply; the caller's
    # in-process follow-ups (response, cache updates) never ran
    "shard.coord.after_apply",
)

#: runtime fan-out layer (runtime/fanout.py): fires after the FIRST call
#: of a batch completes, while the rest are un-dispatched (serial mode) or
#: genuinely in flight (parallel mode) — the "concurrent create batch is
#: half-landed" daemon death the reconciler must converge from
FANOUT_CRASH_POINTS = (
    "fanout.mid_batch",
)

#: capacity-market admission lifecycle (service/admission.py): the chaos
#: matrix kills the daemon at each of these mid-preemption and proves a
#: fresh Program reconciles to one live version with zero leaks, the
#: victim either fully preempted (queued for re-admission) or fully
#: running — never half-quiesced — and the admission journal replays
#: exactly-once
ADMISSION_CRASH_POINTS = (
    # the queued JobState + admission record are durable (ONE apply); the
    # HTTP response was never sent — the record alone drives admission
    "admission.enqueue",
    # victims are chosen and re-validated under the victim's family lock;
    # NOTHING durable has changed — a crash here leaves the victim fully
    # running and the requester fully queued
    "admission.select_victims",
    # fires TWICE per victim (target with armed(..., skip=k)): skip=0 —
    # the preempted-intent apply (JobState phase flip + re-admission
    # record, atomic) is durable but the gang still runs; skip=1 — the
    # gang is quiesced (workers first, coordinator last) but its slices
    # and ports are not yet released
    "admission.preempt",
    # the queued/preempted job is PLACED (claims committed, gang created
    # and started, JobState running) but its admission record is not yet
    # deleted — replay must settle the record, never double-place
    "admission.readmit",
)

#: elastic-gang resize lifecycle (service/job.py ``resize_gang`` +
#: service/admission.py partial preemption): the resize chaos matrix
#: kills the daemon at each of these and proves a fresh Program's
#: reconcile converges to ONE live version with zero leaks and the gang
#: at either the old or the new size — never half-resized — with the
#: grow-back record surviving (or being re-journaled) so the gang still
#: grows back once pressure lifts
RESIZE_CRASH_POINTS = (
    # the resize intent (phase scaling_down/scaling_up + last_resize) is
    # durable; every member still runs at the old size
    "job.resize.after_mark",
    # the gang is quiesced (workers first, coordinator last) but the old
    # version still owns every slice and port — the release+claim delta
    # apply has not committed
    "job.resize.after_quiesce",
    # the ONE-apply delta (old version released + new smaller/larger
    # version claimed) is durable and the new member containers exist
    # (created, not started); the old version is not yet marked stopped
    "job.resize.after_create_new",
    # fires up to TWICE per shrink (target with armed(..., skip=k)):
    # skip=0 — the resized gang is started (coordinator first) but the
    # grow-back admission record is not yet journaled (reconcile must
    # re-journal it); skip=1 — the grow-back record is durable, only the
    # response/event bookkeeping is lost
    "job.resize.after_start_new",
    # partial preemption: victims and spare-member counts are chosen;
    # NOTHING durable has changed — a crash here leaves every victim
    # fully running at full size and the requester fully queued
    "admission.partial_preempt",
)

#: Service / autoscaler lifecycle (service/serving.py): the chaos matrix
#: kills the daemon at each of these and proves a fresh Program's
#: reconcile converges to exactly ONE fully-owned replica set — every
#: replica family 0..replicas-1 exists and nothing beyond it, zero leaked
#: chips/ports — never a half-scaled orphan fleet
SERVICE_CRASH_POINTS = (
    # the v0 ServiceState (replicas=N intent included) is durable in ONE
    # apply; zero replica gangs exist yet — reconcile creates all N
    "service.create.after_record",
    # the scale-up decision (replicas=N+1 + lastScale) is durable; the
    # new replica gang was never submitted — reconcile submits it
    # (placing directly, or queueing through the admission market)
    "service.scale_up.after_mark",
    # the scale-down decision (replicas=N-1) is durable; the surplus
    # replica gang still runs — reconcile tears it down
    "service.scale_down.after_mark",
    # the surplus gang is quiesced (workers first, coordinator last) but
    # its family, slices and ports still exist — reconcile finishes the
    # delete and release
    "service.scale_down.after_quiesce",
    # the new spec version + latest pointer are durable; every replica
    # still runs the OLD spec — reconcile rolls them forward
    "service.roll.after_version",
    # phase "deleting" is durable; replica gangs still exist — reconcile
    # finishes the teardown and drops the family
    "service.delete.after_mark",
)

#: serving-gateway drain handshake (service/job.py ``_predrain`` +
#: service/gateway.py): the chaos matrix kills the daemon at each of
#: these mid-quiesce and proves a fresh Program's reconcile finishes the
#: stop the durable ``draining`` marker recorded — never a half-drained
#: replica left serving at rest
GATEWAY_CRASH_POINTS = (
    # draining=True is durable on the replica JobState; no member has
    # been stopped and no gateway ack has been awaited
    "gateway.drain.after_mark",
    # the gateway drain-ack wait finished (acked or deadline); members
    # are still running — the stop itself has not begun
    "gateway.drain.after_ack",
)

#: event-driven reconcile (service/reconcile.py): the dirty-set is
#: in-process state derived from the watch stream — a daemon death after
#: the pass DRAINED it but before the repairs ran must not lose the
#: families it held. The contract is restart ⇒ full pass (everything is
#: dirty once), proven by killing here and reconverging from a fresh boot
RECONCILE_CRASH_POINTS = (
    "reconcile.dirty_drained",
)

#: history compactor (service/compactor.py): trims are pure garbage
#: collection — a crash at either side must leave every latest pointer
#: and live-referenced version intact, and a re-run must finish the trim
COMPACTOR_CRASH_POINTS = (
    # doomed version keys are chosen; NOTHING is deleted yet
    "compact.before_trim",
    # the first ≤100-op delete chunk is durable, later chunks are not —
    # the partially-trimmed family must still serve its latest version
    "compact.mid_trim",
)

#: durable Workflow DAG lifecycle (service/workflow.py): the chaos matrix
#: kills the daemon at each of these and proves a fresh Program's
#: reconcile drives the DAG forward to completion (or terminal failure) —
#: every step effect applied exactly once (the step-complete marker is
#: written BEFORE the successor launches, the copy-marker pattern),
#: zero orphan gangs, failed-past-budget workflows settle terminal
WORKFLOW_CRASH_POINTS = (
    # the v0 WorkflowState (full DAG spec) is durable in ONE apply; no
    # step has been considered yet — reconcile starts the roots
    "workflow.create.after_record",
    # a step's launch TaskRecord is journaled (idempotency-keyed) and the
    # step is durably marked "launching"; the gang was never submitted —
    # replay/reconcile submits it exactly once
    "workflow.enqueue_step",
    # the step's gang exists (run or queued through admission) but the
    # control record still says "launching" — reconcile adopts the gang
    # instead of double-launching
    "workflow.after_launch",
    # the step-complete marker + control-record flip are durable; the
    # successor steps have NOT been launched — reconcile launches them,
    # and the marker proves the finished step never re-runs
    "workflow.after_complete_marker",
    # the promote step's replace_job_spec rolled the Service, but the
    # step is not yet marked complete — the marker protocol must prove
    # the roll happened and not roll again
    "workflow.after_promote",
    # a cron tick durably recorded its fire (lastFire + run spawn) —
    # restart must not double-fire the same tick
    "workflow.cron_fire",
    # phase "deleting" is durable; step gangs may still exist —
    # reconcile finishes the teardown and drops the family
    "workflow.delete.after_mark",
)

KNOWN_CRASH_POINTS = (CONTAINER_CRASH_POINTS + JOB_CRASH_POINTS
                      + QUEUE_CRASH_POINTS + TXN_CRASH_POINTS
                      + LEADER_CRASH_POINTS + SHARD_CRASH_POINTS
                      + FANOUT_CRASH_POINTS
                      + ADMISSION_CRASH_POINTS + RESIZE_CRASH_POINTS
                      + SERVICE_CRASH_POINTS + GATEWAY_CRASH_POINTS
                      + RECONCILE_CRASH_POINTS + COMPACTOR_CRASH_POINTS
                      + WORKFLOW_CRASH_POINTS)


class SimulatedCrash(BaseException):
    """The daemon 'died' at a labeled crash point (BaseException on purpose —
    must not be swallowed by service-level ``except Exception`` rollbacks)."""

    def __init__(self, label: str):
        super().__init__(f"simulated crash at {label}")
        self.label = label


_armed: dict[str, int] | None = None  # label → hits to skip before crashing
_mu = threading.Lock()


def crash_point(label: str) -> None:
    """No-op unless ``label`` is armed; then raises SimulatedCrash (after
    consuming the label's remaining skip budget — see :func:`armed`)."""
    if _armed is None or label not in _armed:
        return
    with _mu:
        if _armed is None or label not in _armed:
            return
        if _armed[label] > 0:
            _armed[label] -= 1
            return
    raise SimulatedCrash(label)


@contextlib.contextmanager
def armed(*labels: str, skip: int = 0):
    """Arm crash points for the duration of a test block. ``skip`` lets the
    first N hits of each label pass before crashing — the txn boundary
    fires once per ``KV.apply``, so a flow with several batched commits
    needs an index to say WHICH commit the daemon dies at."""
    global _armed
    unknown = set(labels) - set(KNOWN_CRASH_POINTS)
    if unknown:
        raise ValueError(f"unknown crash points: {sorted(unknown)}")
    with _mu:
        _armed = {label: skip for label in labels}
    try:
        yield
    finally:
        with _mu:
            _armed = None
