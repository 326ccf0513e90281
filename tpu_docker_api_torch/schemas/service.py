"""Service DTOs — declarative replicated serving.

The reference (and every job-shaped resource here so far) models *run to
completion* work. A **Service** is the traffic-facing dual: N identical
replica gangs behind one name, each replica a distributed job created
through the existing gang machinery, with the replica count owned by an
SLO-driven autoscaler instead of an operator. Services are persisted exactly like jobs — immutable spec versions plus a ``latest``
pointer, committed in one atomic ``KV.apply`` — so a rolling weight/spec
update is a new service version rolled replica-by-replica through the
same immutable-version replace sequencing jobs use.

The port's copy of ``tpu_docker_api/schemas/service.py``: the same
fields, JSON keys, stored keys and owner env marker (the oracles of both
packages count replicas by them). ``acceleratorType`` takes the port's
``<part>-<N>`` strings (``"h100-8"``, scheduler/topology.py).

Replica gangs are real jobs (family ``<service>.r<index>``) admitted at
the service's priority class — default ``production``, so a traffic-driven
scale-up enters the capacity market above ``batch``/``preemptible``
training and may preempt it (docs/robustness.md "Capacity market").
"""

from __future__ import annotations

import dataclasses
from typing import Any

from tpu_docker_api_torch import errors

#: service lifecycle. ``active`` = the autoscaler owns the replica count;
#: ``deleting`` = teardown intent is durable — a crash mid-delete leaves
#: this phase behind and the reconciler finishes the sweep (every replica
#: gang removed, then the family dropped). There is no "stopped": a
#: service with zero traffic scales to ``min_replicas``, and deleting it
#: is the way to free them.
SERVICE_PHASES = ("active", "deleting")

#: env marker rendered into every replica gang's JobState: maps the gang
#: back to its owning service DURABLY, so the reconciler can garbage-
#: collect orphan replica fleets after the service family itself is gone
#: (a name-shape match alone would misjudge a user job named "x.r1")
SERVICE_OWNER_ENV = "TPU_DOCKER_API_SERVICE"


def owner_from_env(env: list[str]) -> str | None:
    """The owning service recorded in a replica gang's stored env, or
    None. THE one implementation of the marker lookup — serving.py and
    the invariants oracle must agree on what ownership means."""
    want = f"{SERVICE_OWNER_ENV}="
    for e in env:
        if e.startswith(want):
            return e[len(want):]
    return None


@dataclasses.dataclass
class ServiceCreate:
    """POST /services body."""
    service_name: str
    image_name: str
    chips_per_replica: int = 0
    accelerator_type: str = ""    # alternative per-replica ask, e.g. "h100-8"
    replicas: int = 1             # initial replica count
    min_replicas: int = 1
    max_replicas: int = 4
    priority_class: str = ""      # "" ⇒ config service_default_class
    binds: list[str] = dataclasses.field(default_factory=list)
    env: list[str] = dataclasses.field(default_factory=list)
    cmd: list[str] = dataclasses.field(default_factory=list)
    # SLO policy: breach of either target triggers a scale-up
    ttft_p95_target_ms: float = 200.0
    queue_depth_target: int = 4
    # synthetic-load model capacity (fake-runtime replicas): requests/s
    # one replica absorbs before its TTFT/queue signals breach the target
    replica_capacity_rps: float = 100.0
    # the replica-reported metrics endpoint (real path): GET
    # http://<host>:<coordinatorPort><metricsPath> must return the paged
    # engine's SLO export ({"ttftP95Ms", "itlP95Ms", "queueDepth"}).
    # "" ⇒ no scrape; signals come from the synthetic load model only
    metrics_path: str = ""

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ServiceCreate":
        return ServiceCreate(
            service_name=d.get("serviceName", ""),
            image_name=d.get("imageName", ""),
            chips_per_replica=errors.as_int(
                d.get("chipsPerReplica", 0), "chipsPerReplica"),
            accelerator_type=d.get("acceleratorType", ""),
            replicas=errors.as_int(d.get("replicas", 1), "replicas"),
            min_replicas=errors.as_int(d.get("minReplicas", 1),
                                       "minReplicas"),
            max_replicas=errors.as_int(d.get("maxReplicas", 4),
                                       "maxReplicas"),
            priority_class=d.get("priorityClass", ""),
            binds=list(d.get("binds", [])),
            env=list(d.get("env", [])),
            cmd=list(d.get("cmd", [])),
            ttft_p95_target_ms=errors.as_float(
                d.get("ttftP95TargetMs", 200.0), "ttftP95TargetMs"),
            queue_depth_target=errors.as_int(
                d.get("queueDepthTarget", 4), "queueDepthTarget"),
            replica_capacity_rps=errors.as_float(
                d.get("replicaCapacityRps", 100.0), "replicaCapacityRps"),
            metrics_path=d.get("metricsPath", ""),
        )


@dataclasses.dataclass
class ServicePatch:
    """PATCH /services/{name} body. ``replicas`` is a MANUAL scale (counted
    against the zero-manual-ops bench gate; the autoscaler keeps ruling
    afterwards). ``image_name`` is a weight/spec update: a new immutable
    service version, rolled replica-by-replica."""
    replicas: int | None = None
    min_replicas: int | None = None
    max_replicas: int | None = None
    image_name: str = ""
    ttft_p95_target_ms: float | None = None
    queue_depth_target: int | None = None

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ServicePatch":
        def opt_int(key):
            return (errors.as_int(d[key], key) if key in d else None)

        return ServicePatch(
            replicas=opt_int("replicas"),
            min_replicas=opt_int("minReplicas"),
            max_replicas=opt_int("maxReplicas"),
            image_name=d.get("imageName", ""),
            ttft_p95_target_ms=(
                errors.as_float(d["ttftP95TargetMs"], "ttftP95TargetMs")
                if "ttftP95TargetMs" in d else None),
            queue_depth_target=opt_int("queueDepthTarget"),
        )


@dataclasses.dataclass
class ServiceState:
    """Persisted per service version — the spec half is immutable (image/
    cmd/env/binds/chips; a change makes version n+1), the control half
    (replicas, phase, lastScale) is rewritten in place on the latest
    version like a job's lifecycle phase."""
    service_name: str          # versioned, e.g. "web-1"
    version: int
    image: str
    cmd: list[str]
    env: list[str]
    binds: list[str]
    chips_per_replica: int
    accelerator_type: str = ""
    replicas: int = 1
    min_replicas: int = 1
    max_replicas: int = 4
    priority_class: str = "production"
    phase: str = "active"
    ttft_p95_target_ms: float = 200.0
    queue_depth_target: int = 4
    replica_capacity_rps: float = 100.0
    metrics_path: str = ""
    #: audit record of the last replica-count change: {"ts", "direction",
    #: "from", "to", "reason", "trigger" ("autoscale" | "manual")} — the
    #: operator's answer to "why did this scale" without reading logs
    last_scale: dict = dataclasses.field(default_factory=dict)
    #: per-incarnation scale counts, persisted WITH the decision (same
    #: apply). The /metrics counters are process-lifetime and survive a
    #: delete+recreate of the same name; these die with the family, so
    #: the zero-manual-ops audit judges THIS service, not its namesake
    manual_scales: int = 0
    auto_scales: int = 0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ServiceState":
        return ServiceState(
            service_name=d["service_name"],
            version=int(d["version"]),
            image=d["image"],
            cmd=list(d.get("cmd", [])),
            env=list(d.get("env", [])),
            binds=list(d.get("binds", [])),
            chips_per_replica=int(d.get("chips_per_replica", 0)),
            accelerator_type=d.get("accelerator_type", ""),
            replicas=int(d.get("replicas", 1)),
            min_replicas=int(d.get("min_replicas", 1)),
            max_replicas=int(d.get("max_replicas", 4)),
            priority_class=d.get("priority_class", "production"),
            phase=d.get("phase", "active"),
            ttft_p95_target_ms=float(d.get("ttft_p95_target_ms", 200.0)),
            queue_depth_target=int(d.get("queue_depth_target", 4)),
            replica_capacity_rps=float(d.get("replica_capacity_rps", 100.0)),
            metrics_path=d.get("metrics_path", ""),
            last_scale=dict(d.get("last_scale", {})),
            manual_scales=int(d.get("manual_scales", 0)),
            auto_scales=int(d.get("auto_scales", 0)),
        )
