"""Distributed-job DTOs.

The reference has no job concept — its unit is one container on one host. A
GPU control plane's headline object is a **distributed training job**: N
containers (one per host) over one slice of whole GPUs, bootstrapped into one
``torch.distributed`` world (workload/torchenv.py). Jobs carry the same
immutable-versioned rolling-replacement semantics as containers: patching a
job's GPU count creates ``job-(n+1)`` on a fresh slice and retires ``job-n``.

The port's copy of ``tpu_docker_api/schemas/job.py``: the same fields and
JSON keys. ``acceleratorType`` takes the port's ``<part>-<N>`` strings
(``"h100-8"``, scheduler/topology.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from tpu_docker_api_torch import errors


@dataclasses.dataclass
class JobRun:
    """POST /jobs body."""
    image_name: str
    job_name: str
    chip_count: int = 0          # total chips; whole-host multiples span hosts
    accelerator_type: str = ""   # alternative ask: "h100-16" ⇒ GPU count
    binds: list[str] = dataclasses.field(default_factory=list)   # "src:dest"
    env: list[str] = dataclasses.field(default_factory=list)
    cmd: list[str] = dataclasses.field(default_factory=list)
    # >1 ⇒ multislice: chipCount splits into numSlices separate slices,
    # joined into one larger torch.distributed world (workload/torchenv.py)
    num_slices: int = 1
    # capacity-market priority class (service/admission.py): one of the
    # configured ``priority_class_weights`` names; "" ⇒ the configured
    # default. Higher-weight jobs may preempt strictly-lower-weight gangs
    # when the pool is full and admission is enabled
    priority_class: str = ""
    # elastic data-parallel gang (docs/robustness.md "Elastic gangs"):
    # when true, a host loss or a partial preemption SHRINKS the gang to
    # its surviving hosts (never below minMembers) instead of killing it,
    # and a durable grow-back record re-admits the lost members through
    # the capacity market once pressure lifts. Requires a single-slice
    # whole-host gang spanning >= 2 hosts.
    elastic: bool = False
    # the smallest member (host) count an elastic gang may shrink to;
    # 0 ⇒ 1 (elastic jobs only)
    min_members: int = 0

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "JobRun":
        return JobRun(
            image_name=d.get("imageName", ""),
            job_name=d.get("jobName", ""),
            chip_count=errors.as_int(d.get("chipCount", 0), "chipCount"),
            accelerator_type=d.get("acceleratorType", ""),
            binds=list(d.get("binds", [])),
            env=list(d.get("env", [])),
            cmd=list(d.get("cmd", [])),
            num_slices=errors.as_int(d.get("numSlices", 1), "numSlices"),
            priority_class=d.get("priorityClass", ""),
            elastic=bool(d.get("elastic", False)),
            min_members=errors.as_int(d.get("minMembers", 0), "minMembers"),
        )


@dataclasses.dataclass
class JobPatchChips:
    """PATCH /jobs/{name}/tpu body (JAX's path, kept) — rolling rescale
    onto a new slice."""
    chip_count: int = 0
    accelerator_type: str = ""

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "JobPatchChips":
        return JobPatchChips(
            chip_count=errors.as_int(d.get("chipCount", 0), "chipCount"),
            accelerator_type=d.get("acceleratorType", ""),
        )


@dataclasses.dataclass
class JobDelete:
    force: bool = False
    del_state_and_version_record: bool = False

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "JobDelete":
        return JobDelete(
            force=bool(d.get("force", False)),
            del_state_and_version_record=bool(
                d.get("delStateAndVersionRecord", d.get("delEtcdInfoAndVersionRecord", False))
            ),
        )


#: gang lifecycle phases (service/job_supervisor.py): a job is ``running``
#: until a member dies; the supervisor moves it through ``restarting``
#: (whole-gang stop→start in flight) back to ``running``, or — once the
#: restart budget is burned — to terminal ``failed`` (slices/ports freed).
#: ``migrating`` is the host-fault analog of ``restarting``: the gang is
#: being re-placed onto healthy hosts (whole-gang stop → release slice →
#: re-apply excluding unhealthy hosts → start), charged to its own
#: ``job_max_migrations`` budget. ``stopped`` is the user-requested
#: quiesce (resources retained for resume).
#:
#: The capacity market (service/admission.py) adds two phases: ``queued``
#: — admitted into the durable admission queue instead of hard-failing a
#: full pool (no members exist yet, no resources held) — and
#: ``preempted`` — the gang was quiesced and its slices/ports released to
#: make room for a higher-priority job; it re-admits automatically, ahead
#: of equal-priority queued jobs. Both are DORMANT: no member may run and
#: the job owns zero slices/ports (invariants.py enforces it; supervisor
#: and reconciler leave dormant members alone except to finish a
#: half-quiesced preemption).
#:
#: Elastic gangs add two in-flight phases: ``scaling_down`` — the gang is
#: being shrunk to its surviving hosts (host loss) or donating spare
#: members (partial preemption); ``scaling_up`` — a grow-back admitted
#: through the capacity market is restoring lost members. Both are
#: persisted FIRST (like ``restarting``/``migrating``) so a daemon death
#: mid-resize is adoptable: the reconciler/supervisor finish the resize
#: forward without re-counting it, and at rest neither phase may survive
#: (invariants.py flags a scaling phase at rest as a violation).
JOB_PHASES = ("running", "restarting", "migrating", "failed", "stopped",
              "queued", "preempted", "scaling_down", "scaling_up")

#: in-flight resize phases (service/job.py ``resize_gang``)
SCALING_PHASES = ("scaling_down", "scaling_up")

#: phases with no runtime footprint: members must not run, and — except
#: ``stopped``, which retains its grant for resume — the job owns nothing.
#: Supervision, gang recovery and liveness classification all skip them.
DORMANT_PHASES = ("failed", "stopped", "queued", "preempted")


@dataclasses.dataclass
class JobState:
    """Persisted per job version — everything needed to rebuild or rescale."""
    job_name: str            # versioned, e.g. "train-2"
    version: int
    image: str
    cmd: list[str]
    env: list[str]
    binds: list[str]
    chip_count: int
    coordinator_port: int    # MASTER_PORT, published on process 0's host
    # [(host_id, container_name, process_id, [chip_ids], member_port), ...]
    # (JAX's 5-tuples; the member port is the one JAX's libtpu mesh port
    # held, published and claimed but read by no GPU variable)
    # ordered slice-major with equal process counts per slice, so
    # slice_id(pid) = pid // (len(placements) // num_slices)
    placements: list[list[Any]]
    desired_running: bool = True
    num_slices: int = 1
    # JAX's megascale DCN port (multislice only), claimed and published on
    # process 0's host; no GPU variable reads it
    megascale_port: int = 0
    # gang lifecycle (JOB_PHASES); persisted so a daemon crash mid-recovery
    # is recognizable (phase == "restarting") and terminal failure survives
    phase: str = "running"
    # whole-gang restarts consumed against the supervisor's budget
    restarts: int = 0
    # host-fault migrations consumed against job_max_migrations — a
    # SEPARATE budget on purpose: a dead host must not eat the
    # crash-restart budget (no restart can fix it), and a crash-looping
    # workload must not eat the migration budget
    migrations: int = 0
    # why the job went terminal (phase == "failed"), surfaced in the API
    failure_reason: str = ""
    # capacity market (service/admission.py): the job's priority class
    # name (weights resolve through config at decision time, so operators
    # can retune without rewriting stored state)
    priority_class: str = "batch"
    # admission-order seniority: monotonically increasing submit sequence.
    # Victim selection is lowest-priority-first then YOUNGEST-first
    # (largest submitted_seq) — the paged.py seniority rule that makes
    # preemption terminate (juniors can never displace seniors)
    submitted_seq: int = 0
    # times this job was preempted (observability; not a budget — a
    # preempted job always re-admits when capacity returns)
    preemptions: int = 0
    # elastic gang contract (docs/robustness.md "Elastic gangs"): when
    # true, host loss / partial preemption shrink the gang (never below
    # min_members) instead of killing it, and members_desired records the
    # FULL member count the gang grows back to through the admission
    # queue. Non-elastic jobs keep all three at their zero defaults.
    elastic: bool = False
    min_members: int = 0
    members_desired: int = 0
    # lifetime resizes executed (observability — grows without bound on a
    # healthy long-lived elastic gang; shrinks and grow-backs both count)
    resizes: int = 0
    # the last (or in-flight, while phase is scaling_*) resize:
    # {"direction": "down"|"up", "reason", "ts", "fromMembers",
    #  "toMembers", "excludeHosts": [host ids], "attempts": n} —
    # persisted BEFORE the resize acts so adoption knows the target;
    # "attempts" counts retries of THIS resize and is what
    # ``job_resize_max`` bounds (never the lifetime counter); {} = never
    # resized
    last_resize: dict = dataclasses.field(default_factory=dict)
    # serving-gateway drain handshake (service/gateway.py): persisted
    # BEFORE the first member stop of a service-owned replica quiesce so
    # the gateway (and GET /services/{name}) see the replica leave the
    # routing table while it still serves in-flight streams. Durable stop
    # intent: reconcile adopts a draining non-dormant job by finishing
    # the stop, and invariants.py flags draining at rest (like the
    # scaling phases). Cleared by the same write that lands the job in a
    # dormant phase.
    draining: bool = False

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "JobState":
        return JobState(
            job_name=d["job_name"],
            version=int(d["version"]),
            image=d["image"],
            cmd=list(d.get("cmd", [])),
            env=list(d.get("env", [])),
            binds=list(d.get("binds", [])),
            chip_count=int(d.get("chip_count", 0)),
            coordinator_port=int(d.get("coordinator_port", 0)),
            placements=[list(p) for p in d.get("placements", [])],
            desired_running=bool(d.get("desired_running", True)),
            num_slices=int(d.get("num_slices", 1)),
            megascale_port=int(d.get("megascale_port", 0)),
            phase=d.get("phase", "running"),
            restarts=int(d.get("restarts", 0)),
            migrations=int(d.get("migrations", 0)),
            failure_reason=d.get("failure_reason", ""),
            priority_class=d.get("priority_class", "batch"),
            submitted_seq=int(d.get("submitted_seq", 0)),
            preemptions=int(d.get("preemptions", 0)),
            elastic=bool(d.get("elastic", False)),
            min_members=int(d.get("min_members", 0)),
            members_desired=int(d.get("members_desired", 0)),
            resizes=int(d.get("resizes", 0)),
            last_resize=dict(d.get("last_resize") or {}),
            draining=bool(d.get("draining", False)),
        )
