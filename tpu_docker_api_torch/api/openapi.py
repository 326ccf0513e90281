"""OpenAPI 3.1 contract, generated from one source of truth.

Parity: the reference ships a hand-exported OpenAPI file
(``api/gpu-docker-api.openapi.json``, 2,187 lines) that is "the canonical
interface doc" (api/gpu-docker-api-sample-interface.md:3) but can silently
drift from the gin routes. Here the contract is *generated*: every path below
is asserted against the live router in tests (test_torch_openapi.py), so the
committed ``api/openapi.json`` cannot drift without failing CI.

The port's copy of ``tpu_docker_api/api/openapi.py``: the wire contract is
JAX's — the same paths, operations, parameters and request schemas
(``chipCount`` counts GPUs, ``/tpu`` keeps its ``/gpu`` alias) — and
``api/openapi.json`` stays the one committed contract. Only five prose
texts say GPU, torch and NCCL where JAX's say TPU, JAX and ICI. Print the
port's spec with::

    python -m tpu_docker_api_torch.api.openapi
"""

from __future__ import annotations

import json
from typing import Any

_ENVELOPE_NOTE = (
    "All responses are HTTP 200 with the outcome in the body envelope "
    "{code, msg, data}: code 200 = success, 10xxx = application error "
    "(see api/codes.py)."
)


def _obj(props: dict[str, Any], required: list[str] | None = None,
         desc: str = "") -> dict:
    out: dict[str, Any] = {"type": "object", "properties": props}
    if required:
        out["required"] = required
    if desc:
        out["description"] = desc
    return out


def _arr(items: dict) -> dict:
    return {"type": "array", "items": items}


_STR = {"type": "string"}
_INT = {"type": "integer"}
_BOOL = {"type": "boolean"}

_BIND = _obj({"src": _STR, "dest": _STR}, ["src", "dest"])
_CONTAINER_PORT = _obj(
    {"containerPort": _INT, "hostPort": {**_INT, "description": "0 = scheduler-assigned"},
     "protocol": {**_STR, "default": "tcp"}},
    ["containerPort"],
)

_SCHEMAS: dict[str, dict] = {
    "Envelope": _obj(
        {"code": {**_INT, "description": "200 or application error code"},
         "msg": _STR, "data": {}},
        ["code", "msg"], _ENVELOPE_NOTE),
    "ContainerRun": _obj(
        {"imageName": _STR,
         "containerName": {**_STR, "description":
                           "base name, [a-zA-Z0-9_.]+ (no '-'); versions are name-N"},
         "chipCount": {**_INT, "description": "GPUs to attach; 0 = cardless"},
         "sliceShape": {**_STR, "description":
                        "optional explicit ICI block, e.g. \"2x2\" — disables scattered fallback"},
         "binds": _arr(_BIND), "env": _arr(_STR), "cmd": _arr(_STR),
         "containerPorts": _arr(_CONTAINER_PORT)},
        ["imageName", "containerName"]),
    "ContainerDelete": _obj({"force": _BOOL,
                             "delEtcdInfoAndVersionRecord": _BOOL}),
    "ContainerExecute": _obj({"workDir": _STR, "cmd": _arr(_STR)}, ["cmd"]),
    "ContainerPatchChips": _obj(
        {"chipCount": {**_INT, "description":
                       "desired chip count; rolling-replaces into name-(N+1)"}},
        ["chipCount"]),
    "ContainerPatchVolume": _obj(
        {"oldBind": _BIND, "newBind": _BIND}, ["oldBind", "newBind"]),
    "ContainerCommit": _obj({"newImageName": _STR}, ["newImageName"]),
    "VolumeCreate": _obj(
        {"volumeName": _STR,
         "size": {**_STR, "description": "e.g. \"20GB\"; units KB|MB|GB|TB"}},
        ["volumeName"]),
    "VolumeDelete": _obj({"delEtcdInfoAndVersionRecord": _BOOL}),
    "VolumeSize": _obj({"size": _STR}, ["size"]),
    "JobRun": _obj(
        {"imageName": _STR,
         "jobName": {**_STR, "description": "base name, [a-zA-Z0-9_.]+"},
         "chipCount": {**_INT, "description":
                       "total chips; whole-host multiples span hosts"},
         "acceleratorType": {**_STR, "description":
                             "alternative ask, e.g. \"v5p-64\""},
         "binds": _arr({**_STR, "description": "\"src:dest\""}),
         "env": _arr(_STR), "cmd": _arr(_STR),
         "numSlices": {**_INT, "description":
                       ">1 = multislice: chipCount splits into numSlices "
                       "slices joined into one torch.distributed world"},
         "priorityClass": {**_STR, "description":
                           "capacity-market class (default ladder: system > "
                           "production > batch > preemptible; \"\" = the "
                           "configured default). With admission enabled a "
                           "full pool queues the job (phase \"queued\") "
                           "instead of refusing, and higher classes may "
                           "preempt strictly-lower ones"},
         "elastic": {**_BOOL, "description":
                     "elastic data-parallel gang: host loss / drain / "
                     "partial preemption SHRINK the gang to its surviving "
                     "hosts (never below minMembers) instead of killing "
                     "it, and a durable grow-back record re-admits the "
                     "lost members through the capacity market once "
                     "pressure lifts. Requires a single-slice whole-host "
                     "gang spanning >= 2 hosts. Job info then reports "
                     "membersDesired/membersActual/minMembers, lastResize "
                     "and growbackQueuePosition"},
         "minMembers": {**_INT, "description":
                        "smallest member (host) count an elastic gang may "
                        "shrink to (default 1; elastic only)"}},
        ["imageName", "jobName"]),
    "JobPatchChips": _obj({"chipCount": _INT, "acceleratorType": _STR}),
    "JobDelete": _obj({"force": _BOOL, "delStateAndVersionRecord": _BOOL}),
    "ServiceCreate": _obj(
        {"serviceName": {**_STR, "description": "base name, [a-zA-Z0-9_.]+"},
         "imageName": _STR,
         "chipsPerReplica": {**_INT, "description":
                             "chips per replica gang (each replica is a "
                             "distributed job)"},
         "acceleratorType": {**_STR, "description":
                             "alternative per-replica ask, e.g. \"v5e-8\""},
         "replicas": {**_INT, "description": "initial replica count"},
         "minReplicas": _INT, "maxReplicas": _INT,
         "priorityClass": {**_STR, "description":
                           "capacity-market class for every replica gang "
                           "(default production — traffic-driven scale-ups "
                           "may preempt batch/preemptible training)"},
         "binds": _arr({**_STR, "description": "\"src:dest\""}),
         "env": _arr(_STR), "cmd": _arr(_STR),
         "ttftP95TargetMs": {"type": "number", "description":
                             "SLO: scale up when worst replica TTFT p95 "
                             "exceeds this"},
         "queueDepthTarget": {**_INT, "description":
                              "SLO: scale up when worst replica queue "
                              "depth exceeds this"},
         "replicaCapacityRps": {"type": "number", "description":
                                "synthetic-load model: requests/s one "
                                "replica absorbs before breaching"},
         "metricsPath": {**_STR, "description":
                         "replica-reported SLO endpoint path scraped on "
                         "the coordinator port (the paged engine's SLO "
                         "export); \"\" = synthetic signals only"}},
        ["serviceName", "imageName"]),
    "ServicePatch": _obj(
        {"replicas": {**_INT, "description":
                      "MANUAL scale (audited; the autoscaler keeps ruling "
                      "afterwards)"},
         "minReplicas": _INT, "maxReplicas": _INT,
         "imageName": {**_STR, "description":
                       "weight/spec update: a new immutable service "
                       "version, rolled replica-by-replica"},
         "ttftP95TargetMs": {"type": "number"},
         "queueDepthTarget": _INT}),
    "ServiceLoad": _obj(
        {"rps": {"type": "number", "description":
                 "offered load (requests/s) for the synthetic signal "
                 "model; fake-runtime replicas synthesize TTFT/queue "
                 "signals from it"}},
        ["rps"]),
    "WorkflowStep": _obj(
        {"name": {**_STR, "description": "DAG node name, unique per "
                  "workflow, [a-zA-Z0-9_.]+"},
         "kind": {**_STR, "enum": ["job", "promote"], "default": "job",
                  "description": "job = run a gang to completion; "
                  "promote = roll `service` to `image` through the "
                  "Service rolling-update machinery"},
         "deps": _arr({**_STR, "description": "step names that must "
                       "succeed before this step launches"}),
         "imageName": _STR,
         "chipCount": {**_INT, "description": "gang chip ask "
                       "(kind job)"},
         "acceleratorType": {**_STR, "description":
                             "alternative ask, e.g. \"v5e-8\""},
         "binds": _arr({**_STR, "description": "\"src:dest\", on top "
                        "of the workflow's shared binds"}),
         "env": _arr(_STR), "cmd": _arr(_STR),
         "service": {**_STR, "description":
                     "promote target Service (kind promote)"},
         "maxRetries": {**_INT, "description":
                        "per-step retry budget; -1 = config "
                        "workflow_max_step_retries. Exhausting it "
                        "settles the WHOLE workflow \"failed\""}},
        ["name"]),
    "WorkflowCreate": _obj(
        {"workflowName": {**_STR, "description":
                          "base name, [a-zA-Z0-9_.]+"},
         "steps": _arr({"$ref": "#/components/schemas/WorkflowStep"}),
         "priorityClass": {**_STR, "description":
                           "capacity-market class every step gang admits "
                           "at (\"\" = config workflow_default_class)"},
         "binds": _arr({**_STR, "description":
                        "artifact hand-off volume: \"src:dest\" mounted "
                        "into EVERY job step"}),
         "cronIntervalS": {"type": "number", "description":
                           "re-fire the DAG every N seconds (0 = one "
                           "run, no cron)"},
         "cronCatchup": {**_STR, "enum": ["fire_once", "skip"],
                         "default": "skip", "description":
                         "missed-tick policy across downtime: skip = "
                         "drop missed ticks entirely (default); "
                         "fire_once = one catch-up run, the remaining "
                         "missed ticks counted skipped"},
         "cronEnabled": {**_BOOL, "description":
                         "false parks the cron without deleting the "
                         "workflow (default true when cronIntervalS > 0)"}},
        ["workflowName", "steps"]),
    "WorkflowPatch": _obj(
        {"cronIntervalS": {"type": "number"},
         "cronEnabled": _BOOL,
         "cronCatchup": {**_STR, "enum": ["fire_once", "skip"]}},
        desc="Cron retune only — steps are immutable once created "
             "(delete and recreate to change the DAG)"),
    "Rollback": _obj(
        {"version": {**_INT, "description": "stored version to roll back to"},
         "dataFrom": {**_STR, "enum": ["latest", "target"],
                      "default": "latest",
                      "description": "latest = keep newest data under the old "
                      "spec; target = snapshot restore from the retained "
                      "retired version"}},
        ["version"]),
}

#: (method, path, operationId, summary, request schema name | None)
_ROUTES: list[tuple[str, str, str, str, str | None]] = [
    ("POST", "/api/v1/containers", "runContainer",
     "Create a GPU (or cardless) container; allocates chips + host ports, "
     "persists the validated spec, returns name-0", "ContainerRun"),
    ("GET", "/api/v1/containers", "listContainers",
     "Paginated family list ({items: [{name, version}], continue, rev}): "
     "?limit= bounds raw keys scanned per page, ?continue= walks a "
     "rev-anchored consistent snapshot — a concurrent write under the "
     "prefix expires the token with HTTP 410 (code 10505), never a "
     "silent dup/skip", None),
    ("GET", "/api/v1/containers/{name}", "getContainerInfo",
     "Persisted spec + live runtime state; historical versions readable", None),
    ("DELETE", "/api/v1/containers/{name}", "deleteContainer",
     "Remove container versions, return chips/ports to schedulers",
     "ContainerDelete"),
    ("POST", "/api/v1/containers/{name}/execute", "executeContainer",
     "Exec a command in the running container, return demuxed stdout",
     "ContainerExecute"),
    ("PATCH", "/api/v1/containers/{name}/tpu", "patchContainerChips",
     "Rolling chip rescale: quiesce → copy data → start name-(N+1)",
     "ContainerPatchChips"),
    ("PATCH", "/api/v1/containers/{name}/gpu", "patchContainerChipsCompat",
     "Reference-compatible alias of /tpu", "ContainerPatchChips"),
    ("PATCH", "/api/v1/containers/{name}/volume", "patchContainerVolume",
     "Swap one bind onto name-(N+1) with data migration",
     "ContainerPatchVolume"),
    ("POST", "/api/v1/containers/{name}/stop", "stopContainer",
     "Graceful stop; chips stay allocated for restart", None),
    ("PATCH", "/api/v1/containers/{name}/restart", "restartContainer",
     "Restart; carded containers re-apply chips via a new version", None),
    ("POST", "/api/v1/containers/{name}/commit", "commitContainer",
     "Snapshot container filesystem to an image", "ContainerCommit"),
    ("GET", "/api/v1/containers/{name}/history", "getContainerHistory",
     "Stored version history of the family (per-version store — the "
     "rollback the reference advertises but cannot deliver)", None),
    ("PATCH", "/api/v1/containers/{name}/rollback", "rollbackContainer",
     "Roll forward to a NEW version built from an older version's spec; "
     "data from latest or from the retained target (snapshot restore)",
     "Rollback"),
    ("POST", "/api/v1/volumes", "createVolume",
     "Create a named, size-capped volume (overlay2/xfs analog)", "VolumeCreate"),
    ("GET", "/api/v1/volumes", "listVolumes",
     "Paginated volume-family list (same limit/continue contract as "
     "GET /api/v1/containers)", None),
    ("GET", "/api/v1/volumes/{name}", "getVolumeInfo",
     "Persisted volume spec + mountpoint", None),
    ("DELETE", "/api/v1/volumes/{name}", "deleteVolume",
     "Remove volume versions", "VolumeDelete"),
    ("PATCH", "/api/v1/volumes/{name}/size", "patchVolumeSize",
     "Resize via new volume + data copy; shrink below used size refused",
     "VolumeSize"),
    ("GET", "/api/v1/volumes/{name}/history", "getVolumeHistory",
     "Stored version history of the volume family", None),
    ("PATCH", "/api/v1/volumes/{name}/rollback", "rollbackVolume",
     "New version with an older version's size; data from latest or the "
     "retained target volume", "Rollback"),
    ("POST", "/api/v1/jobs", "runJob",
     "Place a distributed torch job: one member container per host over a "
     "slice, rendezvous + MASTER_*/WORLD_SIZE env rendered", "JobRun"),
    ("GET", "/api/v1/jobs", "listJobs",
     "Paginated job-family list (same limit/continue contract as "
     "GET /api/v1/containers)", None),
    ("GET", "/api/v1/jobs/{name}", "getJobInfo",
     "Job spec + per-process live state + gang phase/restarts/failureReason; "
     "historical versions readable", None),
    ("DELETE", "/api/v1/jobs/{name}", "deleteJob",
     "Remove all job versions, free slices and ports", "JobDelete"),
    ("PATCH", "/api/v1/jobs/{name}/tpu", "patchJobChips",
     "Rolling rescale onto a new slice: create-new → quiesce-old → start-new",
     "JobPatchChips"),
    ("POST", "/api/v1/jobs/{name}/stop", "stopJob",
     "Quiesce every process container (checkpoint flush)", None),
    ("PATCH", "/api/v1/jobs/{name}/restart", "restartJob",
     "Whole-gang restart: stop every member (coordinator last), start in "
     "process order (coordinator first); resets the restart budget", None),
    ("POST", "/api/v1/services", "createService",
     "Create a replicated service: N replica gangs (each a distributed "
     "job at the service's priority class) behind one declarative record; "
     "the SLO-driven autoscaler owns the replica count", "ServiceCreate"),
    ("GET", "/api/v1/services", "listServices",
     "Every service: phase, replica counts, last autoscale decision; with "
     "?limit=/?continue= the same rev-anchored pagination contract as "
     "GET /api/v1/containers ({items, continue, rev})", None),
    ("GET", "/api/v1/services/{name}", "getServiceInfo",
     "Replica fleet detail (per-replica phase/queue position), SLO targets "
     "+ last observed signals, and the last autoscale decision with its "
     "reason — the no-log-reading scaling audit", None),
    ("PATCH", "/api/v1/services/{name}", "patchService",
     "Manual replica count (audited), min/max + SLO target retune, or an "
     "imageName weight update rolled replica-by-replica through the "
     "immutable-version replace sequencing", "ServicePatch"),
    ("DELETE", "/api/v1/services/{name}", "deleteService",
     "Tear down every replica gang (gang-ordered quiesce + one-batch "
     "release) and drop the service family", None),
    ("POST", "/api/v1/services/{name}/load", "setServiceLoad",
     "Synthetic traffic injection: offered requests/s for the fake-runtime "
     "signal model (bench/test load generators)", "ServiceLoad"),
    ("POST", "/api/v1/workflows", "createWorkflow",
     "Declare a DAG workflow: job steps (gangs admitted through the "
     "capacity market at the workflow's class) and promote steps (roll a "
     "Service through the rolling-update machinery), with shared "
     "artifact binds and optional cron re-fire. Every step transition is "
     "journaled with an idempotency key — a crashed daemon's replacement "
     "replays the DAG forward, never re-running a completed effect",
     "WorkflowCreate"),
    ("GET", "/api/v1/workflows", "listWorkflows",
     "Every workflow: phase, run counter, priority class, last "
     "transition; with ?limit=/?continue= the same rev-anchored "
     "pagination contract as GET /api/v1/containers "
     "({items, continue, rev})", None),
    ("GET", "/api/v1/workflows/{name}", "getWorkflowInfo",
     "Per-step status (state/attempts/error, live gang phase + queue "
     "position, promote target) and cron bookkeeping (lastFireTs, "
     "firedRuns, suppressed/skipped ticks) — the no-log-reading audit of "
     "where the DAG stands", None),
    ("PATCH", "/api/v1/workflows/{name}", "patchWorkflow",
     "Cron retune: interval, enable/disable, catch-up policy; steps are "
     "immutable once created", "WorkflowPatch"),
    ("DELETE", "/api/v1/workflows/{name}", "deleteWorkflow",
     "Tear down the DAG: mark deleting (durable), stop + delete every "
     "owned step gang, drop the family — mid-flight deletes are crash-"
     "safe (reconcile finishes a half-done teardown)", None),
    ("GET", "/api/v1/gateway", "getGatewayStatus",
     "Serving-gateway introspection: instance identity, the watch-fed "
     "routing table (per-endpoint breaker/EWMA/in-flight/generation), "
     "draining families, and the shed/retry/hedge/drain-ack counters; "
     "present only when gateway_enabled", None),
    ("GET", "/api/v1/resources/tpus", "getTpus",
     "Chip map: coords, owner, fragmentation (largest free block)", None),
    ("GET", "/api/v1/resources/gpus", "getTpusCompat",
     "Reference-compatible alias of /resources/tpus", None),
    ("GET", "/api/v1/resources/ports", "getUsedPorts",
     "Host-port scheduler state", None),
    ("GET", "/api/v1/resources/slices", "getSlices",
     "Pod view: host grid, per-host free chips + schedulability "
     "(cordon/down), active slice grants", None),
    ("POST", "/api/v1/hosts/{name}/cordon", "cordonHost",
     "No new placements on the host (persisted; survives daemon restarts); "
     "existing workloads untouched", None),
    ("POST", "/api/v1/hosts/{name}/uncordon", "uncordonHost",
     "Lift a cordon: the host is schedulable again", None),
    ("POST", "/api/v1/hosts/{name}/drain", "drainHost",
     "Cordon the host and migrate every gang off it (async via the work "
     "queue); no healthy capacity ⇒ the migration fails loudly and frees "
     "nothing", None),
    ("GET", "/api/v1/health/hosts", "getHostHealth",
     "Per-host probe state (healthy/suspect/down), circuit-breaker state, "
     "cordon/schedulability", None),
    ("GET", "/api/v1/events", "getHealthEvents",
     "Container liveness transitions (health watcher) merged with gang "
     "lifecycle events (job supervisor), host health transitions "
     "(host monitor), leadership transitions, informer degradations and "
     "slow-trace events — pre-sorted rings merged by timestamp; "
     "?traceId= filters to the events stamped by one trace", None),
    ("GET", "/api/v1/traces", "listTraces",
     "Recent trace summaries from the bounded in-process trace ring "
     "(telemetry/trace.py): root span name, span count, status "
     "(ok/error/lost), duration, cross-trace links — newest first, plus "
     "the ring's dropped/open-span counters; ?limit= bounds the page",
     None),
    ("GET", "/api/v1/traces/{traceId}", "getTrace",
     "One trace's full span tree: every span's name, parentId, attrs, "
     "monotonic start, duration, status and links — the 'where did this "
     "request's latency go' view. The trace id is the request's "
     "X-Request-Id (or traceparent trace-id), so a user-reported request "
     "id greps straight to its tree", None),
    ("GET", "/api/v1/health/containers", "getHealthStatus",
     "Per-container liveness + restart bookkeeping", None),
    ("GET", "/api/v1/health/jobs", "getJobHealth",
     "Per-job gang status: phase (running/restarting/migrating/failed/"
     "stopped), restart + migration budgets, dead/missing members, "
     "unreachable hosts, backoff remaining", None),
    ("GET", "/api/v1/leader", "getLeader",
     "HA control-plane election view: this replica's role (single/leader/"
     "standby), the lease holder, the monotonically increasing fencing "
     "epoch, and the lease deadline. Standbys answer every mutation with "
     "503 + this holder as the redirect hint. With read_cache=informer the "
     "watch-fed read-cache state rides along (synced, lastRev, watchLagMs, "
     "event/relist/cache-hit counters)", None),
    ("GET", "/api/v1/shards", "getShards",
     "Sharded writer plane map: every shard's lease holder, fencing epoch, "
     "deadline and advertise address (heartbeat-observed — zero store "
     "reads), plus which shards THIS replica holds. Mutations for a "
     "family another shard owns 503 with that shard's holder as the "
     "redirect hint. Unsharded deployments answer with one implicit "
     "shard carrying the single election's state", None),
    ("GET", "/api/v1/admission", "getAdmissionQueue",
     "Capacity-market admission queue: depth, per-class counts, entry "
     "positions/skip budgets, the configured priority ladder, and the "
     "admission/preemption counters (the same books /metrics exports). "
     "Queued jobs place automatically — backfilling holes, preempting "
     "strictly-lower-priority gangs, defragmenting via migration", None),
    ("GET", "/api/v1/queue", "getQueueStats",
     "Durable work-queue view: in-memory depth, journal lifecycle counts "
     "(pending/inflight/dead), degradation events and counters", None),
    ("GET", "/api/v1/dead-letters", "getDeadLetters",
     "Async tasks that exhausted retries — journaled in the KV store, so "
     "they survive daemon restarts (never silently dropped)", None),
    ("GET", "/api/v1/debug/deadletters", "getDeadLettersDebug",
     "Legacy alias of GET /api/v1/dead-letters", None),
    ("POST", "/api/v1/dead-letters/retry", "retryDeadLetters",
     "Re-enqueue every dead-lettered task (durable + ephemeral) with a "
     "fresh retry budget", None),
    ("GET", "/api/v1/reconcile", "reconcile",
     "Sweep KV desired state vs runtime actual state and repair drift "
     "(orphans, half-completed replaces, leaked chips/ports); "
     "?dryRun=true reports without mutating; ?mode=full|dirty|auto "
     "forces the anti-entropy full scan or the O(changes) watch-fed "
     "dirty pass — the report's `mode` names which ran", None),
    ("POST", "/api/v1/reconcile", "reconcilePost",
     "Canonical mutating reconcile trigger (same semantics as GET)", None),
    ("GET", "/api/v1/reconcile/events", "getReconcileEvents",
     "Recent drift-repair actions (ring buffer, newest last)", None),
    ("POST", "/api/v1/compact", "compactHistory",
     "Run one history-compaction pass now (history_retention_versions > "
     "0): trim version records past retention — never the latest pointer "
     "or a live-referenced version — purge settled admission records, "
     "sweep acked queue markers; returns the trim report", None),
    ("GET", "/api/v1/debug/threads", "getThreadDump",
     "Per-thread stack dump (the pprof-goroutine analog): hung copies and "
     "deadlocked family locks are visible here", None),
    ("GET", "/healthz", "healthz",
     "Process liveness + HA role; with read_cache=informer also the "
     "watch-fed read-cache health (a degraded informer still serves via "
     "read-through fallback, but slower — visible here)", None),
    ("GET", "/metrics", "metrics",
     "Prometheus text format: request/latency/chip/port/queue gauges", None),
]


#: GET list endpoints carrying the limit/continue pagination contract
_PAGED_LIST_PATHS = {"/api/v1/containers", "/api/v1/volumes",
                     "/api/v1/jobs", "/api/v1/services",
                     "/api/v1/workflows"}


def build_spec() -> dict:
    paths: dict[str, dict] = {}
    for method, path, op_id, summary, req_schema in _ROUTES:
        if path == "/metrics":
            # the one non-envelope endpoint: Prometheus exposition text
            response = {
                "description": "Prometheus text exposition format",
                "content": {"text/plain": {"schema": {"type": "string"}}},
            }
        else:
            response = {
                "description": _ENVELOPE_NOTE,
                "content": {"application/json": {
                    "schema": {"$ref": "#/components/schemas/Envelope"}}},
            }
        op: dict[str, Any] = {
            "operationId": op_id,
            "summary": summary,
            "responses": {"200": response},
        }
        if "{name}" in path:
            op["parameters"] = [{
                "name": "name", "in": "path", "required": True,
                "schema": _STR,
                "description": "base name (latest version) or versioned "
                               "name-N (optimistic concurrency check)",
            }]
        if "{traceId}" in path:
            op["parameters"] = [{
                "name": "traceId", "in": "path", "required": True,
                "schema": _STR,
                "description": "trace id — the request's X-Request-Id or "
                               "traceparent trace-id",
            }]
        if path == "/api/v1/events":
            op["parameters"] = [
                {"name": "limit", "in": "query", "required": False,
                 "schema": _INT,
                 "description": "max events returned (default 100)"},
                {"name": "traceId", "in": "query", "required": False,
                 "schema": _STR,
                 "description": "only events stamped by this trace — "
                                "joins the event rings to "
                                "/api/v1/traces/{traceId}"},
            ]
        if method == "GET" and path in _PAGED_LIST_PATHS:
            op["parameters"] = [
                {"name": "limit", "in": "query", "required": False,
                 "schema": _INT,
                 "description": "max raw keys scanned per page (clamped "
                                "to list_max_limit; 0/absent = the "
                                "configured list_default_limit, whose 0 "
                                "default keeps the legacy unbounded "
                                "single-page scan)"},
                {"name": "continue", "in": "query", "required": False,
                 "schema": _STR,
                 "description": "opaque token from the previous page; the "
                                "walk serves one rev-anchored consistent "
                                "snapshot or fails HTTP 410 "
                                "ContinueExpired (code 10505)"},
            ]
        if req_schema:
            op["requestBody"] = {"required": True, "content": {
                "application/json": {"schema": {
                    "$ref": f"#/components/schemas/{req_schema}"}}}}
        paths.setdefault(path, {})[method.lower()] = op
    return {
        "openapi": "3.1.0",
        "info": {
            "title": "tpu-docker-api",
            "version": "1.0.0",
            "description": (
                "GPU container control plane: versioned rolling-replace "
                "containers and volumes (gpu-docker-api parity) plus "
                "multi-host distributed torch jobs over NCCL-joined slices. "
                + _ENVELOPE_NOTE),
        },
        "paths": paths,
        "components": {"schemas": _SCHEMAS},
    }


def route_inventory() -> set[tuple[str, str]]:
    """(METHOD, path) pairs — consumed by the drift test."""
    return {(m, p) for m, p, *_ in _ROUTES}


if __name__ == "__main__":
    print(json.dumps(build_spec(), indent=2, sort_keys=False))
