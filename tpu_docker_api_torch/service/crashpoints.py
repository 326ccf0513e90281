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

The port's copy of ``tpu_docker_api/service/crashpoints.py`` with the
labels its modules fire: the container service, the work queue, the
``KV.apply`` boundary, the runtime fan-out and the reconciler's dirty
pass. The job, leader, shard, admission, resize, service, gateway,
compactor and workflow labels come with those services (ROADMAP Queue 1
item 10); arming one raises ValueError.
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

#: runtime fan-out layer (runtime/fanout.py): fires after the FIRST call
#: of a batch completes, while the rest are un-dispatched (serial mode) or
#: genuinely in flight (parallel mode) — the "concurrent create batch is
#: half-landed" daemon death the reconciler must converge from
FANOUT_CRASH_POINTS = (
    "fanout.mid_batch",
)

#: event-driven reconcile (service/reconcile.py): the dirty-set is
#: in-process state derived from the watch stream — a daemon death after
#: the pass DRAINED it but before the repairs ran must not lose the
#: families it held. The contract is restart ⇒ full pass (everything is
#: dirty once), proven by killing here and reconverging from a fresh boot
RECONCILE_CRASH_POINTS = (
    "reconcile.dirty_drained",
)

KNOWN_CRASH_POINTS = (CONTAINER_CRASH_POINTS + QUEUE_CRASH_POINTS
                      + TXN_CRASH_POINTS + FANOUT_CRASH_POINTS
                      + RECONCILE_CRASH_POINTS)


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
