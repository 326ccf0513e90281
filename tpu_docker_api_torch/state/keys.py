"""State-store key layout.

Parity + fix: the reference keeps ONE key per resource family —
``/apis/v1/<resource>/<basename>`` with the ``-version`` suffix stripped
(etcd/common.go:75-81) — so each new version overwrites the last and the
documented rollback (README.md:142-144) is impossible. Here every version gets
its own key plus a ``latest`` pointer:

    /apis/v1/containers/<base>/v/<NNNNNNNNNN>   (zero-padded ⇒ key-sorted)
    /apis/v1/containers/<base>/latest            → version number
    /apis/v1/volumes/<base>/v/<NNNNNNNNNN>
    /apis/v1/volumes/<base>/latest

Scheduler / version-map state lives under the same tree as in the reference
(``gpus/gpuStatusMapKey`` → ``/apis/v1/scheduler/*``, ``versions/*`` →
``/apis/v1/versions/*``).

The port's copy of ``tpu_docker_api/state/keys.py``: the same keys, so a
store one package wrote reads the same in the other.
"""

from __future__ import annotations

import enum
import re

PREFIX = "/apis/v1"

#: the one source of the base-name rule: names become KV key segments and
#: container names, so no '-' (version separator), no '/' (key nesting)
BASE_NAME_RE = re.compile(r"^[a-zA-Z0-9_.]+$")


class Resource(str, enum.Enum):
    """Resource kinds (reference etcd/common.go:24-29 enums, plus the
    distributed-job and replicated-service kinds the TPU control plane
    adds)."""
    CONTAINERS = "containers"
    VOLUMES = "volumes"
    JOBS = "jobs"
    SERVICES = "services"
    WORKFLOWS = "workflows"


def split_versioned_name(name: str) -> tuple[str, int | None]:
    """``"train-3"`` → ("train", 3); ``"train"`` → ("train", None).

    The reference requires versioned names on every op but create
    (api/container.go:102-106); base names must not contain '-'
    (api/container.go:66-70) so the split is unambiguous.
    """
    base, sep, tail = name.rpartition("-")
    if sep and tail.isdigit():
        return base, int(tail)
    return name, None


def versioned_name(base: str, version: int) -> str:
    return f"{base}-{version}"


def job_owner_base(owner: str) -> str:
    """Map a job scheduler-owner back to its family base. Job claims are
    keyed by VERSIONED name, optionally with a multislice suffix
    ("train-1", "train-1#s0") — version maps key by base, so ownership
    checks must strip both before judging. Non-job owners pass through."""
    stem = owner.split("#", 1)[0]
    base, version = split_versioned_name(stem)
    return base if version is not None else owner


def family_prefix(resource: Resource, base: str) -> str:
    return f"{PREFIX}/{resource.value}/{base}/"


def version_key(resource: Resource, base: str, version: int) -> str:
    return f"{PREFIX}/{resource.value}/{base}/v/{version:010d}"


def latest_key(resource: Resource, base: str) -> str:
    return f"{PREFIX}/{resource.value}/{base}/latest"


def family_key(resource: Resource, name: str) -> str:
    """Key for a possibly-versioned name's family latest pointer."""
    base, _ = split_versioned_name(name)
    return latest_key(resource, base)


# cross-cutting singletons
SCHEDULER_CHIPS_KEY = f"{PREFIX}/scheduler/chips"
SCHEDULER_PORTS_KEY = f"{PREFIX}/scheduler/ports"
SCHEDULER_SLICES_KEY = f"{PREFIX}/scheduler/slices"
VERSIONS_CONTAINER_KEY = f"{PREFIX}/versions/containers"
VERSIONS_VOLUME_KEY = f"{PREFIX}/versions/volumes"
VERSIONS_JOB_KEY = f"{PREFIX}/versions/jobs"
VERSIONS_SERVICE_KEY = f"{PREFIX}/versions/services"
VERSIONS_WORKFLOW_KEY = f"{PREFIX}/versions/workflows"


# -- leader election (service/leader.py) ---------------------------------------
#: the TTL lease record: JSON {holderId, epoch, deadline, ttlS, advertise}.
#: Written ONLY via CAS on its previous exact value (create-if-absent on an
#: empty store), renewed by the holder's heartbeat, stolen after expiry.
LEADER_LEASE_KEY = f"{PREFIX}/leader/lease"
#: the fencing token: the epoch number alone, bumped atomically with every
#: leadership change and NEVER deleted (a graceful release drops the lease
#: but keeps the epoch, so epochs are monotonic across the store's whole
#: life). Every write a leader issues is guarded on this key still holding
#: the epoch it acquired — a deposed leader's in-flight write loses the
#: compare instead of corrupting state the new leader owns.
LEADER_EPOCH_KEY = f"{PREFIX}/leader/epoch"


# -- sharded writer plane (service/shard.py) -----------------------------------
#: shard 0 maps to the LEGACY singleton keys above, so a ``shard_count=1``
#: deployment is byte-for-byte identical to the unsharded layout (and a
#: later ``shard_count`` bump adopts the existing store as shard 0's
#: keyspace without migration). Shards i>0 get their own lease/epoch pair
#: under ``/leader/shards/<i>/`` with the exact same CAS + fencing
#: semantics — one epoch per shard, never deleted, monotonic forever.


def shard_lease_key(shard: int) -> str:
    if shard == 0:
        return LEADER_LEASE_KEY
    return f"{PREFIX}/leader/shards/{shard}/lease"


def shard_epoch_key(shard: int) -> str:
    if shard == 0:
        return LEADER_EPOCH_KEY
    return f"{PREFIX}/leader/shards/{shard}/epoch"


#: cross-shard coordination record: JSON ``{"seq": N}``, CAS-bumped by any
#: transaction whose invariants span shards (pod capacity, cross-shard
#: admission precedence, service fleets whose replicas hash apart). Two
#: shard leaders racing on a cross-shard invariant serialize here — the
#: CAS loser gets a typed GuardFailed and re-reads, exactly the lease
#: protocol's shape applied to data instead of leadership.
SHARD_COORD_KEY = f"{PREFIX}/leader/coord"


#: operator cordon set (service/host_health.py + scheduler/pod.py): JSON
#: list of host ids that must receive no new placements; persisted so a
#: cordon survives daemon restarts (uncordon is the only way out)
HOSTS_CORDONED_KEY = f"{PREFIX}/scheduler/hosts/cordoned"


# -- durable work-queue journal (state/workqueue.py) ---------------------------
#: every async task is journaled here as a declarative record (kind + JSON
#: params) keyed by a zero-padded submit sequence, so replay after a crash
#: preserves submit order. Lifecycle rides the record's ``state`` field
#: (pending → inflight → dead); successful tasks delete their key (done).
QUEUE_PREFIX = f"{PREFIX}/queue"
QUEUE_TASKS_PREFIX = f"{PREFIX}/queue/tasks/"
#: per-task side-effect markers (e.g. copy-complete): written BEFORE the
#: follow-up action so a replayed task can prove its non-idempotent step
#: already ran and must not re-apply; deleted together with the record
QUEUE_MARKERS_PREFIX = f"{PREFIX}/queue/markers/"


# -- durable admission queue (service/admission.py) ----------------------------
#: capacity-market admission records: one JSON record per job waiting for
#: capacity (state "queued") or parked after a preemption (state
#: "preempted"), keyed by a zero-padded submit sequence so a prefix scan
#: yields submit order. Written atomically WITH the job's ``JobState``
#: phase flip (one KV.apply), so queued/preempted intent and the admission
#: record can never disagree; deleted when the job places (or is stopped/
#: deleted), so queued intent survives restarts and leader failover
ADMISSION_PREFIX = f"{PREFIX}/admission/"


def admission_prefix(shard: int = 0) -> str:
    """Shard 0 owns the legacy flat prefix; shards i>0 nest under an
    ``s<i>/`` segment, so each shard leader scans (and replays) only its
    own records and a one-shard deployment keeps today's exact keys."""
    if shard == 0:
        return ADMISSION_PREFIX
    return f"{ADMISSION_PREFIX}s{shard}/"


def admission_record_key(seq: int, shard: int = 0) -> str:
    return f"{admission_prefix(shard)}{seq:012d}"


def queue_tasks_prefix(shard: int = 0) -> str:
    if shard == 0:
        return QUEUE_TASKS_PREFIX
    return f"{QUEUE_TASKS_PREFIX}s{shard}/"


def queue_task_key(seq: int, shard: int = 0) -> str:
    return f"{queue_tasks_prefix(shard)}{seq:012d}"


def queue_markers_prefix(shard: int = 0) -> str:
    if shard == 0:
        return QUEUE_MARKERS_PREFIX
    return f"{QUEUE_MARKERS_PREFIX}s{shard}/"


def queue_marker_key(task_id: str, shard: int = 0) -> str:
    return f"{queue_markers_prefix(shard)}{task_id}"


# -- serving-gateway drain handshake (service/gateway.py) ----------------------
#: live gateway-instance registry: each stateless gateway heartbeats a
#: JSON record {"id", "ts", "advertise"} under its own key. A record is
#: LIVE while its ts is within 3x the heartbeat interval — a killed
#: gateway simply stops renewing, and the control plane's drain wait
#: ignores stale entries (bounded by the drain deadline either way)
GATEWAY_INSTANCES_PREFIX = f"{PREFIX}/gateway/instances/"
#: per-family drain acks: a gateway that has (a) observed the family's
#: durable ``draining`` marker in its routing table and (b) finished every
#: in-flight request it was proxying to that family writes
#: ``{prefix}{family}/{gateway_id}``. The control plane's quiesce waits
#: until every live instance acked (or the deadline passes), then deletes
#: the family's ack prefix — zero live gateways ⇒ vacuously drained
GATEWAY_ACKS_PREFIX = f"{PREFIX}/gateway/acks/"


def gateway_instance_key(gateway_id: str) -> str:
    return f"{GATEWAY_INSTANCES_PREFIX}{gateway_id}"


def gateway_acks_prefix(base: str) -> str:
    """Every ack for one replica family, prefix-scannable and
    prefix-deletable as a unit."""
    return f"{GATEWAY_ACKS_PREFIX}{base}/"


def gateway_ack_key(base: str, gateway_id: str) -> str:
    return f"{gateway_acks_prefix(base)}{gateway_id}"


def versions_shard_key(resource: Resource, shard: int) -> str:
    """Per-shard version-map snapshot key. Shard 0 keeps the legacy
    singleton key so the existing store needs no migration."""
    if shard == 0:
        return f"{PREFIX}/versions/{resource.value}"
    return f"{PREFIX}/versions/shards/{shard}/{resource.value}"


def shard_root(base: str) -> str:
    """The shard-assignment unit for a family base name: its first
    dot-segment. Replicated-service replica gangs are named
    ``<service>.r<i>`` (service/serving.py), so hashing the root keeps a
    service and every one of its replicas on ONE shard — the autoscaler
    and fleet sweeps never straddle a shard boundary for a single fleet."""
    return base.split(".", 1)[0]


def host_chips_key(host_id: str) -> str:
    """Per-host chip-scheduler state for multi-host pods (each host's
    ChipScheduler persists independently)."""
    return f"{PREFIX}/scheduler/chips/{host_id}"


def host_ports_key(host_id: str) -> str:
    return f"{PREFIX}/scheduler/ports/{host_id}"
