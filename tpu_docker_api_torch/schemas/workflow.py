"""Workflow DTOs — declarative crash-proof DAG orchestration.

Jobs run to completion and Services serve forever; a **Workflow** is the
multi-step lifecycle between them: a DAG of job steps —
fine-tune, then eval — finished by a ``promote`` step that rolls a
Service to the produced artifact through ``replace_job_spec``, plus cron
schedules for recurring runs. Workflows persist exactly like jobs and
services — immutable spec versions plus a ``latest`` pointer committed in
one atomic ``KV.apply`` — with the DAG's control half (per-step status,
run ordinal, cron bookkeeping) rewritten in place on the latest version.

Step gangs are real jobs (family ``<workflow>.s<run>_<index>``) admitted
at the workflow's priority class, so a pipeline burst backfills and
preempts through the capacity market like everything else. Artifact
hand-off rides volume binds: the workflow's shared ``binds`` mount into
every job step, so a training step's output volume is the eval step's
input without any copy step.

The port's copy of ``tpu_docker_api/schemas/workflow.py``: the same JSON
keys, stored records and env markers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from tpu_docker_api_torch import errors

#: workflow lifecycle. ``running`` = the engine owns the DAG; the
#: terminals are ``succeeded`` / ``failed`` (a cron re-fire resets a
#: terminal workflow back to ``running`` with a fresh run ordinal);
#: ``deleting`` = teardown intent is durable — a crash mid-delete leaves
#: this phase behind and the reconciler finishes the sweep.
WORKFLOW_PHASES = ("running", "succeeded", "failed", "deleting")

#: per-step state machine. ``pending`` → (deps met, backoff elapsed) →
#: ``launching`` (launch TaskRecord journaled, gang not proven yet) →
#: ``running`` (gang exists) → ``succeeded`` | back to ``pending`` with
#: ``attempts`` bumped (retry) | ``failed`` (budget burned ⇒ the whole
#: workflow settles terminal-failed and frees everything).
STEP_STATES = ("pending", "launching", "running", "succeeded", "failed")

STEP_KINDS = ("job", "promote")

#: missed-tick catch-up policy (docs/robustness.md "Workflows"): with
#: k > 1 schedule boundaries elapsed since the last fire (daemon down, or
#: the previous run still in flight), ``skip`` realigns the schedule to
#: the next future boundary firing nothing, ``fire_once`` fires exactly
#: ONE run covering all k missed ticks. k == 1 is the ordinary on-time
#: fire under both policies.
CRON_CATCHUP_POLICIES = ("skip", "fire_once")

#: env marker rendered into every step gang's JobState: maps the gang
#: back to its owning workflow DURABLY, so reconcile/invariants can
#: garbage-collect orphan step gangs after the workflow family is gone
#: (a name-shape match alone would misjudge a user job named "x.s0_1")
WORKFLOW_OWNER_ENV = "TPU_DOCKER_API_WORKFLOW"
#: companion marker: which run ordinal the gang belongs to — a cron
#: re-fire bumps the run, and gangs of superseded runs are GC'd by it
WORKFLOW_RUN_ENV = "TPU_DOCKER_API_WORKFLOW_RUN"


def owner_from_env(env: list[str]) -> str | None:
    """The owning workflow recorded in a step gang's stored env, or None.
    THE one implementation of the marker lookup — workflow.py and the
    invariants oracle must agree on what ownership means."""
    want = f"{WORKFLOW_OWNER_ENV}="
    for e in env:
        if e.startswith(want):
            return e[len(want):]
    return None


def run_from_env(env: list[str]) -> int | None:
    want = f"{WORKFLOW_RUN_ENV}="
    for e in env:
        if e.startswith(want) and e[len(want):].isdigit():
            return int(e[len(want):])
    return None


@dataclasses.dataclass
class WorkflowStep:
    """One DAG node (immutable spec half). ``kind == "job"`` runs a gang
    to completion; ``kind == "promote"`` rolls ``service`` to ``image``
    through the Service rolling-update machinery."""
    name: str
    kind: str = "job"
    deps: list[str] = dataclasses.field(default_factory=list)
    image: str = ""
    cmd: list[str] = dataclasses.field(default_factory=list)
    env: list[str] = dataclasses.field(default_factory=list)
    binds: list[str] = dataclasses.field(default_factory=list)
    chip_count: int = 0
    accelerator_type: str = ""
    #: promote target (kind == "promote"): the Service to roll to `image`
    service: str = ""
    #: per-step retry budget; -1 ⇒ config ``workflow_max_step_retries``
    max_retries: int = -1

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "WorkflowStep":
        return WorkflowStep(
            name=d.get("name", ""),
            kind=d.get("kind", "job"),
            deps=list(d.get("deps", [])),
            image=d.get("image", d.get("imageName", "")),
            cmd=list(d.get("cmd", [])),
            env=list(d.get("env", [])),
            binds=list(d.get("binds", [])),
            chip_count=errors.as_int(d.get("chipCount",
                                           d.get("chip_count", 0)),
                                     "chipCount"),
            accelerator_type=d.get("acceleratorType",
                                   d.get("accelerator_type", "")),
            service=d.get("service", ""),
            max_retries=errors.as_int(d.get("maxRetries",
                                            d.get("max_retries", -1)),
                                      "maxRetries"),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def fresh_step_status() -> dict[str, Any]:
    """A step's control record at the start of a run (and after a retry
    reset, which carries ``attempts``/``error`` forward explicitly)."""
    return {"state": "pending", "attempts": 0, "job": "", "error": "",
            "notBefore": 0.0}


@dataclasses.dataclass
class WorkflowCreate:
    """POST /workflows body."""
    workflow_name: str
    steps: list[WorkflowStep] = dataclasses.field(default_factory=list)
    priority_class: str = ""      # "" ⇒ config workflow_default_class
    #: shared artifact binds mounted into EVERY job step (the hand-off
    #: volume), on top of each step's own binds
    binds: list[str] = dataclasses.field(default_factory=list)
    #: recurring schedule: fire a fresh run every interval (0 ⇒ one-shot)
    cron_interval_s: float = 0.0
    cron_catchup: str = "skip"
    cron_enabled: bool = True

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "WorkflowCreate":
        return WorkflowCreate(
            workflow_name=d.get("workflowName", ""),
            steps=[WorkflowStep.from_dict(s) for s in d.get("steps", [])],
            priority_class=d.get("priorityClass", ""),
            binds=list(d.get("binds", [])),
            cron_interval_s=errors.as_float(
                d.get("cronIntervalS", 0.0), "cronIntervalS"),
            cron_catchup=d.get("cronCatchup", "skip"),
            cron_enabled=bool(d.get("cronEnabled", True)),
        )


@dataclasses.dataclass
class WorkflowPatch:
    """PATCH /workflows/{name} body: cron control only — the DAG spec is
    immutable (delete + recreate to change it). Disabling cron mid-flight
    lets the current run finish; no further runs fire."""
    cron_enabled: bool | None = None
    cron_interval_s: float | None = None
    cron_catchup: str | None = None

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "WorkflowPatch":
        return WorkflowPatch(
            cron_enabled=(bool(d["cronEnabled"])
                          if "cronEnabled" in d else None),
            cron_interval_s=(errors.as_float(d["cronIntervalS"],
                                             "cronIntervalS")
                             if "cronIntervalS" in d else None),
            cron_catchup=d.get("cronCatchup"),
        )


@dataclasses.dataclass
class WorkflowState:
    """Persisted per workflow version — the spec half is immutable
    (steps/binds/class/cron spec; a change makes version n+1), the
    control half (phase, run, stepStatus, cron bookkeeping) is rewritten
    in place on the latest version like a job's lifecycle phase."""
    workflow_name: str         # versioned, e.g. "pipe-1"
    version: int
    steps: list[dict]          # WorkflowStep dicts (spec order = DAG order)
    priority_class: str = "production"
    binds: list[str] = dataclasses.field(default_factory=list)
    cron_interval_s: float = 0.0
    cron_catchup: str = "skip"
    # -- control half (rewritten in place on the latest version) --------------
    phase: str = "running"
    #: run ordinal: 0 at create, bumped by every cron fire — step gang
    #: families embed it, so runs never collide on job names
    run: int = 0
    #: step name → {"state", "attempts", "job", "error", "notBefore"}
    step_status: dict = dataclasses.field(default_factory=dict)
    cron_enabled: bool = True
    #: wall-clock anchor of the schedule (the engine's injected clock);
    #: fires advance it by whole intervals so boundaries never drift
    last_fire_ts: float = 0.0
    fired_runs: int = 0
    #: ticks that found the previous run still in flight (overlap
    #: suppression) or were skipped by the catch-up policy
    suppressed_ticks: int = 0
    skipped_ticks: int = 0
    #: audit record of the last phase transition: {"ts", "from", "to",
    #: "reason"} — the operator's answer to "why is this failed"
    last_transition: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "WorkflowState":
        return WorkflowState(
            workflow_name=d["workflow_name"],
            version=int(d["version"]),
            steps=[dict(s) for s in d.get("steps", [])],
            priority_class=d.get("priority_class", "production"),
            binds=list(d.get("binds", [])),
            cron_interval_s=float(d.get("cron_interval_s", 0.0)),
            cron_catchup=d.get("cron_catchup", "skip"),
            phase=d.get("phase", "running"),
            run=int(d.get("run", 0)),
            step_status={k: dict(v)
                         for k, v in d.get("step_status", {}).items()},
            cron_enabled=bool(d.get("cron_enabled", True)),
            last_fire_ts=float(d.get("last_fire_ts", 0.0)),
            fired_runs=int(d.get("fired_runs", 0)),
            suppressed_ticks=int(d.get("suppressed_ticks", 0)),
            skipped_ticks=int(d.get("skipped_ticks", 0)),
            last_transition=dict(d.get("last_transition", {})),
        )

    def spec_steps(self) -> list[WorkflowStep]:
        return [WorkflowStep.from_dict(
            {**s, "chipCount": s.get("chip_count", 0),
             "acceleratorType": s.get("accelerator_type", ""),
             "maxRetries": s.get("max_retries", -1)})
            for s in self.steps]


def validate_dag(steps: list[WorkflowStep]) -> None:
    """Reject empty DAGs, duplicate/unknown names, bad kinds, underspecified
    steps, and cycles — at POST time, with typed errors, so a workflow the
    engine cannot drive is never persisted."""
    if not steps:
        raise errors.BadRequest("a workflow needs at least one step")
    names = [s.name for s in steps]
    if len(set(names)) != len(names):
        raise errors.BadRequest(f"duplicate step names in {names}")
    known = set(names)
    for s in steps:
        if not s.name or not s.name.replace("_", "").isalnum():
            raise errors.BadRequest(
                f"invalid step name {s.name!r}: must be nonempty, "
                "[a-zA-Z0-9_] only")
        if s.kind not in STEP_KINDS:
            raise errors.BadRequest(
                f"step {s.name}: unknown kind {s.kind!r} "
                f"(known: {STEP_KINDS})")
        unknown = set(s.deps) - known
        if unknown:
            raise errors.BadRequest(
                f"step {s.name}: unknown deps {sorted(unknown)}")
        if s.name in s.deps:
            raise errors.BadRequest(f"step {s.name} depends on itself")
        if not s.image:
            raise errors.BadRequest(f"step {s.name}: image required")
        if s.kind == "job" and s.chip_count <= 0 and not s.accelerator_type:
            raise errors.BadRequest(
                f"step {s.name}: chipCount or acceleratorType required")
        if s.kind == "promote" and not s.service:
            raise errors.BadRequest(
                f"step {s.name}: promote needs a target service")
    # Kahn's algorithm: anything left after peeling roots is a cycle
    deps = {s.name: set(s.deps) for s in steps}
    while True:
        roots = [n for n, d in deps.items() if not d]
        if not roots:
            break
        for n in roots:
            del deps[n]
        for d in deps.values():
            d.difference_update(roots)
    if deps:
        raise errors.BadRequest(
            f"dependency cycle among steps {sorted(deps)}")
