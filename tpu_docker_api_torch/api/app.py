"""HTTP server: routing, validation, error mapping.

Parity: the reference's gin routes (api/container.go:19-38, volume.go:19-28,
resource.go:12-15) on a stdlib ThreadingHTTPServer. Name-format validation
follows the reference: base names must not contain ``-`` on create
(api/container.go:66-70); other ops accept ``name`` (latest) or
``name-version`` (optimistic check). Validation raises, so the reference's
fall-through validation bugs cannot happen here.

The port's copy of ``tpu_docker_api/api/app.py``: the container, volume,
job, admission, service, resource, slice, host, queue, dead-letter,
reconcile, event, trace, health, workflow, leader, shard and compaction
routes, with JAX's bodies and codes, the store-outage gate (503 +
``Retry-After``, the stale-read envelope) and the HA gates (a standby, or a
process that does not hold the family's shard, answers a mutation 503 with
the leader hint), and the serving gateway's status route.

Route table:

    POST   /api/v1/containers                  run container
    GET    /api/v1/containers                  list families (paged)
    GET    /api/v1/containers/{name}           info
    DELETE /api/v1/containers/{name}           delete
    POST   /api/v1/containers/{name}/execute   exec
    PATCH  /api/v1/containers/{name}/gpu       patch GPU count (alias: /tpu)
    PATCH  /api/v1/containers/{name}/volume    patch bind
    POST   /api/v1/containers/{name}/stop      stop
    PATCH  /api/v1/containers/{name}/restart   restart
    POST   /api/v1/containers/{name}/commit    commit to image
    GET    /api/v1/containers/{name}/history   stored version history
    PATCH  /api/v1/containers/{name}/rollback  roll to an older version's spec
    POST   /api/v1/volumes                     create volume
    GET    /api/v1/volumes                     list families (paged)
    GET    /api/v1/volumes/{name}              info
    DELETE /api/v1/volumes/{name}              delete
    PATCH  /api/v1/volumes/{name}/size         resize
    GET    /api/v1/volumes/{name}/history      stored version history
    PATCH  /api/v1/volumes/{name}/rollback     roll to an older version's size
    POST   /api/v1/jobs                        run a distributed job (gang)
    GET    /api/v1/jobs                        list families (paged)
    GET    /api/v1/jobs/{name}                 info (members live)
    DELETE /api/v1/jobs/{name}                 delete
    PATCH  /api/v1/jobs/{name}/tpu             rolling rescale (JAX's path)
    POST   /api/v1/jobs/{name}/stop            gang stop
    PATCH  /api/v1/jobs/{name}/restart         gang restart
    GET    /api/v1/admission                   capacity-market queue view
    POST   /api/v1/workflows                   create a DAG workflow (steps + cron)
    GET    /api/v1/workflows                   list workflows
    GET    /api/v1/workflows/{name}            per-step status + cron state
    PATCH  /api/v1/workflows/{name}            cron enable/interval/catch-up
    DELETE /api/v1/workflows/{name}            tear down the DAG + step gangs
    GET    /api/v1/leader                      election role, holder, epoch, lease deadline
    GET    /api/v1/shards                      per-shard lease table
    POST   /api/v1/compact                     one history-compaction pass
    GET    /api/v1/gateway                     serving-gateway status (when on)
    POST   /api/v1/services                    create a replicated service
    GET    /api/v1/services                    list services
    GET    /api/v1/services/{name}             replica fleet + last autoscale decision
    PATCH  /api/v1/services/{name}             manual scale / policy / spec roll
    DELETE /api/v1/services/{name}             tear down every replica
    POST   /api/v1/services/{name}/load        synthetic offered-load injection
    GET    /api/v1/resources/slices            pod scheduler view
    POST   /api/v1/hosts/{name}/cordon         cordon a pod host
    POST   /api/v1/hosts/{name}/uncordon       uncordon it
    POST   /api/v1/hosts/{name}/drain          cordon + migrate its gangs
    GET    /api/v1/health/hosts                host monitor view
    GET    /api/v1/health/jobs                 job supervisor view
    GET    /api/v1/resources/gpus              GPU scheduler view (alias: /tpus)
    GET    /api/v1/resources/ports             port scheduler view
    GET    /api/v1/queue                       durable work-queue stats
    GET    /api/v1/dead-letters                durable dead-letter set
    POST   /api/v1/dead-letters/retry          re-enqueue the dead letters
    GET    /api/v1/reconcile                   drift sweep (?dryRun= ?mode=; POST too)
    GET    /api/v1/reconcile/events            the sweep's repair events
    GET    /api/v1/events                      watcher, job, host, market, service, trace, store events
    GET    /api/v1/health/containers           health-watcher view
    GET    /api/v1/traces[/{traceId}]          trace summaries / one trace
    GET    /api/v1/debug/threads               per-thread stack dump
    GET    /healthz
"""

from __future__ import annotations

import collections
import heapq
import json
import logging
import math
import re
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.api import codes, response
from tpu_docker_api_torch.buildinfo import build_info
from tpu_docker_api_torch.schemas.container import (
    Bind,
    ContainerCommit,
    ContainerDelete,
    ContainerExecute,
    ContainerPatchChips,
    ContainerPatchVolume,
    ContainerRollback,
    ContainerRun,
)
from tpu_docker_api_torch.schemas.volume import (
    VolumeCreate,
    VolumeDelete,
    VolumeRollback,
    VolumeSize,
)
from tpu_docker_api_torch.service.container import ContainerService
from tpu_docker_api_torch.service.store_health import consume_stale_read
from tpu_docker_api_torch.service.volume import VolumeService
from tpu_docker_api_torch.state.keys import BASE_NAME_RE as _NAME_RE
from tpu_docker_api_torch.telemetry import trace

log = logging.getLogger(__name__)

# base-name charset + optional "-N" version suffix, derived so the two rules
# cannot drift
_VERSIONED_RE = re.compile(_NAME_RE.pattern.rstrip("$") + r"(-\d+)?$")

def _validate_base_name(name: str) -> None:
    """Create-time rule: nonempty, no '-' (reference api/container.go:66-70)."""
    if not name or not _NAME_RE.match(name):
        raise errors.BadRequest(
            f"invalid base name {name!r}: must be nonempty without '-'"
        )


def _validate_ref_name(name: str) -> None:
    if not name or not _VERSIONED_RE.match(name):
        raise errors.BadRequest(f"invalid container/volume name {name!r}")


#: resources whose mutation routes carry a family name (the shard unit)
_FAMILY_SEGMENTS = frozenset(("containers", "volumes", "jobs", "services",
                              "workflows"))
#: create bodies carry the family name under the resource's own field
_CREATE_NAME_FIELDS = ("containerName", "volumeName", "jobName",
                       "serviceName", "workflowName")


def _shard_for_request(plane, path: str, raw: bytes) -> int:
    """Owning shard for a mutation: family routes shard by the (version-
    stripped) name in the path, creates by the name in the body; anything
    else — host ops, reconcile, dead-letter retry — is shard 0. Unparsable
    input classifies as shard 0 too: the gate must never mask the
    validation error the handler would raise."""
    from tpu_docker_api_torch.state import keys

    seg = path.split("/")
    if len(seg) < 4 or seg[3] not in _FAMILY_SEGMENTS:
        return 0
    if len(seg) >= 5 and seg[4]:
        base, _ = keys.split_versioned_name(seg[4])
        return plane.map.shard_of(base)
    try:
        body = json.loads(raw) if raw else {}
    except ValueError:
        return 0
    if isinstance(body, dict):
        for field in _CREATE_NAME_FIELDS:
            name = body.get(field)
            if isinstance(name, str) and name:
                return plane.map.shard_of(name)
    return 0



class Router:
    """Tiny method+pattern router; patterns use ``{name}`` segments. Carries
    its own metrics registry so each server instance exposes only its own
    series at /metrics."""

    def __init__(self, metrics=None) -> None:
        from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry

        self._routes: list[tuple[str, re.Pattern, str, callable]] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        #: trace sink (telemetry/trace.py); build_router sets it (None =
        #: request tracing off)
        self.tracer = None
        #: HA role gate; build_router sets it (None = no gating)
        self.leader_elector = None
        #: sharded writer plane (service/shard.py); build_router sets it —
        #: when present, the mutation gate routes per shard instead
        self.shard_plane = None

    def add(self, method: str, pattern: str, handler) -> None:
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )
        self._routes.append((method, regex, pattern, handler))

    def match(self, method: str, path: str):
        """(handler, path_params, route_pattern) or None. The pattern is the
        low-cardinality metrics label (never the raw path)."""
        for m, regex, pattern, handler in self._routes:
            if m != method:
                continue
            match = regex.match(path)
            if match:
                return handler, match.groupdict(), pattern
        return None

    def dispatch(self, method: str, path: str, body: dict):
        found = self.match(method, path)
        if found is None:
            raise errors.BadRequest(f"no route for {method} {path}")
        handler, params, _ = found
        return handler(body=body, **params)


def build_router(container_svc: ContainerService, volume_svc: VolumeService,
                 chip_scheduler, port_scheduler, work_queue=None,
                 health_watcher=None, metrics=None,
                 job_svc=None, pod_scheduler=None, reconciler=None,
                 job_supervisor=None, host_monitor=None,
                 leader_elector=None, shard_plane=None,
                 informer=None, fanout=None,
                 admission=None, serving=None, workflow_svc=None,
                 compactor=None,
                 gateway=None,
                 store_health=None,
                 list_default_limit: int = 0,
                 list_max_limit: int = 5000,
                 tracer=None) -> Router:
    from tpu_docker_api_torch.state import pager
    from tpu_docker_api_torch.state.keys import Resource

    r = Router(metrics=metrics)
    r.tracer = tracer
    # store brownout gate (service/store_health.py): while the store is in
    # outage mode every mutation is refused up front — typed 503 +
    # Retry-After, zero store round trips — except the single-flight heal
    # probe; reads served from the informer mirror are marked stale
    # (envelope field + X-Stale-Read header). None gates nothing.
    r.store_health = store_health
    # HA role gate (service/leader.py): on a standby replica every non-GET
    # request is answered 503 + the leader hint BEFORE dispatch — reads
    # stay local, mutations belong to the lease holder. None (single-
    # process, or election disabled) gates nothing.
    r.leader_elector = leader_elector
    # sharded writer plane: same contract, per shard — a mutation is
    # answered 503 + the OWNING shard's leader hint unless this process
    # holds that shard's lease (api-layer routing is a redirect, never a
    # proxy: the client retries against the advertised holder)
    r.shard_plane = shard_plane

    def _page_params(body) -> tuple[int, str]:
        """(effective limit, continue token) for a list request. No (or
        non-positive) ?limit means the configured default — 0 keeps the
        legacy unbounded single-page scan; an explicit limit is clamped
        to list_max_limit."""
        try:
            # query params arrive as strings; a JSON body may send a number
            limit = int(body.get("limit", 0))
        except (TypeError, ValueError):
            raise errors.BadRequest("limit must be an integer") from None
        limit = min(limit, list_max_limit) if limit > 0 else list_default_limit
        token = str(body.get("continue", "") or "")
        return limit, token

    def _family_list(resource: Resource):
        def handler(body, **_):
            limit, token = _page_params(body)
            # one bounded rev-anchored page per request (state/pager.py)
            return pager.list_families(
                container_svc.store.kv, resource, limit=limit, token=token)
        return handler

    # -- containers (reference api/container.go:19-38) ---------------------------

    def run(body, **_):
        req = ContainerRun.from_dict(body)
        if not req.image_name:
            raise errors.BadRequest("imageName is required")
        _validate_base_name(req.container_name)
        if req.chip_count < 0:
            raise errors.BadRequest("chipCount must be >= 0")
        return container_svc.run_container(req)

    def c_info(body, name):
        _validate_ref_name(name)
        return container_svc.get_container_info(name)

    def c_delete(body, name):
        _validate_ref_name(name)
        container_svc.delete_container(name, ContainerDelete(
            force=bool(body.get("force", True)),
            del_etcd_info_and_version_record=bool(
                body.get("delEtcdInfoAndVersionRecord", False)),
        ))
        return None

    def c_exec(body, name):
        _validate_ref_name(name)
        cmd = body.get("cmd", [])
        if not cmd:
            raise errors.BadRequest("cmd is required")
        out = container_svc.execute_container(
            name, ContainerExecute(work_dir=body.get("workDir", ""), cmd=list(cmd))
        )
        return {"stdout": out}

    def c_patch_chips(body, name):
        _validate_ref_name(name)
        if "chipCount" not in body and "gpuCount" not in body:
            raise errors.BadRequest("chipCount is required")
        want = errors.as_int(
            body.get("chipCount", body.get("gpuCount", 0)), "chipCount")
        return container_svc.patch_container_chips(
            name, ContainerPatchChips(chip_count=want)
        )

    def c_patch_volume(body, name):
        _validate_ref_name(name)
        old, new = body.get("oldBind"), body.get("newBind")
        if not old or not new:
            raise errors.BadRequest("oldBind and newBind are required")
        return container_svc.patch_container_volume(name, ContainerPatchVolume(
            old_bind=Bind(old["src"], old["dest"]),
            new_bind=Bind(new["src"], new["dest"]),
        ))

    def c_stop(body, name):
        _validate_ref_name(name)
        container_svc.stop_container(name)
        return None

    def c_restart(body, name):
        _validate_ref_name(name)
        return container_svc.restart_container(name)

    def c_commit(body, name):
        _validate_ref_name(name)
        image_id = container_svc.commit_container(
            name, ContainerCommit(new_image_name=body.get("newImageName", ""))
        )
        return {"imageId": image_id}

    def c_history(body, name):
        _validate_ref_name(name)
        return container_svc.get_container_history(name)

    def _version_of(body):
        if "version" not in body:
            raise errors.BadRequest("version is required")
        try:
            return int(body["version"])
        except (TypeError, ValueError):
            raise errors.BadRequest("version must be an integer")

    def c_rollback(body, name):
        _validate_ref_name(name)
        return container_svc.rollback_container(name, ContainerRollback(
            version=_version_of(body),
            data_from=body.get("dataFrom", "latest"),
        ))

    r.add("POST", "/api/v1/containers", run)
    # paginated family lists ({items: [{name, version}], continue, rev};
    # ?limit= + ?continue= walk a rev-anchored snapshot, HTTP 410
    # ContinueExpired when the prefix moved under the walk)
    r.add("GET", "/api/v1/containers", _family_list(Resource.CONTAINERS))
    r.add("GET", "/api/v1/containers/{name}", c_info)
    r.add("DELETE", "/api/v1/containers/{name}", c_delete)
    r.add("POST", "/api/v1/containers/{name}/execute", c_exec)
    r.add("PATCH", "/api/v1/containers/{name}/tpu", c_patch_chips)
    r.add("PATCH", "/api/v1/containers/{name}/gpu", c_patch_chips)  # reference path
    r.add("PATCH", "/api/v1/containers/{name}/volume", c_patch_volume)
    r.add("POST", "/api/v1/containers/{name}/stop", c_stop)
    r.add("PATCH", "/api/v1/containers/{name}/restart", c_restart)
    r.add("POST", "/api/v1/containers/{name}/commit", c_commit)
    r.add("GET", "/api/v1/containers/{name}/history", c_history)
    r.add("PATCH", "/api/v1/containers/{name}/rollback", c_rollback)

    # -- volumes (reference api/volume.go:19-28) ---------------------------------

    def v_create(body, **_):
        name = body.get("volumeName", "")
        _validate_base_name(name)
        return volume_svc.create_volume(
            VolumeCreate(volume_name=name, size=body.get("size", ""))
        )

    def v_info(body, name):
        _validate_ref_name(name)
        return volume_svc.get_volume_info(name)

    def v_delete(body, name):
        _validate_ref_name(name)
        volume_svc.delete_volume(name, VolumeDelete(
            del_etcd_info_and_version_record=bool(
                body.get("delEtcdInfoAndVersionRecord", False)),
        ))
        return None

    def v_patch_size(body, name):
        _validate_ref_name(name)
        size = body.get("size", "")
        if not size:
            raise errors.BadRequest("size is required")
        return volume_svc.patch_volume_size(name, VolumeSize(size=size))

    def v_history(body, name):
        _validate_ref_name(name)
        return volume_svc.get_volume_history(name)

    def v_rollback(body, name):
        _validate_ref_name(name)
        return volume_svc.rollback_volume(name, VolumeRollback(
            version=_version_of(body),
            data_from=body.get("dataFrom", "latest"),
        ))

    r.add("POST", "/api/v1/volumes", v_create)
    r.add("GET", "/api/v1/volumes", _family_list(Resource.VOLUMES))
    r.add("GET", "/api/v1/volumes/{name}", v_info)
    r.add("DELETE", "/api/v1/volumes/{name}", v_delete)
    r.add("PATCH", "/api/v1/volumes/{name}/size", v_patch_size)
    r.add("GET", "/api/v1/volumes/{name}/history", v_history)
    r.add("PATCH", "/api/v1/volumes/{name}/rollback", v_rollback)

    # -- distributed jobs (multi-host slices, SURVEY.md hard part #3; no
    #    reference analog) ----------------------------------------------------

    if job_svc is not None:
        from tpu_docker_api_torch.schemas.job import (JobDelete,
                                                      JobPatchChips, JobRun)

        def j_run(body, **_):
            req = JobRun.from_dict(body)
            _validate_base_name(req.job_name)
            return job_svc.run_job(req)

        def j_info(body, name):
            _validate_ref_name(name)
            return job_svc.get_job_info(name)

        def j_delete(body, name):
            _validate_ref_name(name)
            job_svc.delete_job(name, JobDelete.from_dict(body))
            return None

        def j_patch_chips(body, name):
            _validate_ref_name(name)
            return job_svc.patch_job_chips(name, JobPatchChips.from_dict(body))

        def j_stop(body, name):
            _validate_ref_name(name)
            job_svc.stop_job(name)
            return None

        def j_restart(body, name):
            _validate_ref_name(name)
            return job_svc.restart_job(name)

        r.add("POST", "/api/v1/jobs", j_run)
        r.add("GET", "/api/v1/jobs", _family_list(Resource.JOBS))
        r.add("GET", "/api/v1/jobs/{name}", j_info)
        r.add("DELETE", "/api/v1/jobs/{name}", j_delete)
        r.add("PATCH", "/api/v1/jobs/{name}/tpu", j_patch_chips)
        r.add("POST", "/api/v1/jobs/{name}/stop", j_stop)
        r.add("PATCH", "/api/v1/jobs/{name}/restart", j_restart)
    if admission is not None:
        # capacity market: queue depth, per-class counts, positions and the
        # preemption/admission counters (the same books /metrics exports)
        r.add("GET", "/api/v1/admission",
              lambda body, **_: admission.status_view())

    # -- Services (declarative replicated serving, service/serving.py) ------------

    if serving is not None:
        from tpu_docker_api_torch.schemas.service import ServiceCreate, ServicePatch

        def s_create(body, **_):
            req = ServiceCreate.from_dict(body)
            _validate_base_name(req.service_name)
            return serving.create_service(req)

        def s_info(body, name):
            _validate_ref_name(name)
            return serving.service_info(name)

        def s_patch(body, name):
            _validate_ref_name(name)
            return serving.patch_service(name, ServicePatch.from_dict(body))

        def s_delete(body, name):
            _validate_ref_name(name)
            serving.delete_service(name)
            return None

        def s_load(body, name):
            # synthetic traffic injection (fake-runtime replicas): the
            # load generator states offered rps; the autoscaler's next
            # tick synthesizes per-replica SLO signals from it
            _validate_ref_name(name)
            if "rps" not in body:
                raise errors.BadRequest("rps is required")
            try:
                rps = float(body["rps"])
            except (TypeError, ValueError):
                raise errors.BadRequest("rps must be a number") from None
            return serving.set_offered_load(name, rps)

        def s_list(body, **_):
            limit, token = _page_params(body)
            if limit <= 0 and not token:
                # legacy shape: the unbounded flat list
                return serving.list_services()
            page = pager.list_families(
                container_svc.store.kv, Resource.SERVICES,
                limit=limit, token=token)
            items = []
            for it in page["items"]:
                s = serving.service_summary(it["name"])
                if s is not None:
                    items.append(s)
            return {"items": items, "continue": page["continue"],
                    "rev": page["rev"]}

        r.add("POST", "/api/v1/services", s_create)
        r.add("GET", "/api/v1/services", s_list)
        r.add("GET", "/api/v1/services/{name}", s_info)
        r.add("PATCH", "/api/v1/services/{name}", s_patch)
        r.add("DELETE", "/api/v1/services/{name}", s_delete)
        r.add("POST", "/api/v1/services/{name}/load", s_load)

    # -- Workflows (durable DAG orchestration, service/workflow.py) -----------

    if workflow_svc is not None:
        from tpu_docker_api_torch.schemas.workflow import (WorkflowCreate,
                                                           WorkflowPatch)

        def w_create(body, **_):
            req = WorkflowCreate.from_dict(body)
            _validate_base_name(req.workflow_name)
            return workflow_svc.create_workflow(req)

        def w_info(body, name):
            _validate_ref_name(name)
            return workflow_svc.workflow_info(name)

        def w_patch(body, name):
            _validate_ref_name(name)
            return workflow_svc.patch_workflow(name,
                                               WorkflowPatch.from_dict(body))

        def w_delete(body, name):
            _validate_ref_name(name)
            workflow_svc.delete_workflow(name)
            return None

        def w_list(body, **_):
            limit, token = _page_params(body)
            if limit <= 0 and not token:
                # legacy shape: the unbounded flat list
                return workflow_svc.list_workflows()
            page = pager.list_families(
                container_svc.store.kv, Resource.WORKFLOWS,
                limit=limit, token=token)
            items = []
            for it in page["items"]:
                s = workflow_svc.workflow_summary(it["name"])
                if s is not None:
                    items.append(s)
            return {"items": items, "continue": page["continue"],
                    "rev": page["rev"]}

        r.add("POST", "/api/v1/workflows", w_create)
        r.add("GET", "/api/v1/workflows", w_list)
        r.add("GET", "/api/v1/workflows/{name}", w_info)
        r.add("PATCH", "/api/v1/workflows/{name}", w_patch)
        r.add("DELETE", "/api/v1/workflows/{name}", w_delete)

    if pod_scheduler is not None:
        r.add("GET", "/api/v1/resources/slices",
              lambda body, **_: pod_scheduler.status())

        # -- host failure domains (docs/robustness.md): cordon/uncordon are
        #    pure scheduler state (persisted in KV); drain + health need
        #    the monitor --------------------------------------------------------
        def h_cordon(body, name):
            if host_monitor is not None:
                return host_monitor.cordon(name)
            return pod_scheduler.cordon_host(name)

        def h_uncordon(body, name):
            if host_monitor is not None:
                return host_monitor.uncordon(name)
            return pod_scheduler.uncordon_host(name)

        r.add("POST", "/api/v1/hosts/{name}/cordon", h_cordon)
        r.add("POST", "/api/v1/hosts/{name}/uncordon", h_uncordon)
    if host_monitor is not None:
        # async drain: cordon now, gang migrations ride the work queue
        r.add("POST", "/api/v1/hosts/{name}/drain",
              lambda body, name: host_monitor.drain(name))
        # per-host probe state + breaker + schedulability
        r.add("GET", "/api/v1/health/hosts",
              lambda body, **_: host_monitor.status_view())

    # -- resource views (reference api/resource.go:12-29) ------------------------

    r.add("GET", "/api/v1/resources/tpus", lambda body, **_: chip_scheduler.status())
    r.add("GET", "/api/v1/resources/gpus", lambda body, **_: chip_scheduler.status())
    r.add("GET", "/api/v1/resources/ports", lambda body, **_: port_scheduler.status())

    def healthz(body, **_):
        # role surfaced next to liveness: load balancers route mutations by
        # it, and "single" keeps the no-election deployment unambiguous
        if shard_plane is not None:
            held = sorted(shard_plane.held)
            role = "leader" if held else "standby"
        else:
            role = ("single" if leader_elector is None
                    else ("leader" if leader_elector.is_leader
                          else "standby"))
        out = {"status": "ok", "role": role, **build_info()}
        if shard_plane is not None:
            # which slice of the writer plane this replica carries: load
            # balancers shard mutations by it, operators eyeball spread
            out["shards"] = {"count": shard_plane.map.count, "held": held}
        if informer is not None:
            # read-path health rides liveness: a standby whose informer is
            # degraded still serves (read-through fallback) but slower —
            # load balancers and operators see it here
            out["informer"] = informer.status_view()
        if fanout is not None:
            # fan-out saturation (workers/in-flight/batches): a pool pinned
            # at its worker cap is the "lifecycle flows are serializing
            # again" smell, surfaced next to liveness
            out["fanout"] = fanout.status_view()
        if admission is not None:
            # capacity-market health: queue depth + the admission/
            # preemption counters read back from the metrics registry
            # (one set of books — /healthz and /metrics cannot disagree)
            out["admission"] = admission.health_view()
        if reconciler is not None:
            dirty = reconciler.dirty_view()
            if dirty is not None:
                # event-driven reconcile health: pending dirty families +
                # whether the next pass is forced full (startup/relist)
                out["reconcileDirty"] = dirty
        if job_svc is not None:
            pools = {}
            for hid, host in sorted(job_svc.pod.hosts.items()):
                try:
                    view = host.runtime.pool_view()
                except AttributeError:
                    continue  # engine without a connection pool (fake)
                pools[hid] = view
            if pools:
                out["enginePools"] = pools
        if gateway is not None:
            # serving-ingress health next to liveness: in-flight load,
            # retry-budget level, breaker/shed counters and the routing
            # table's per-endpoint view (one set of books — identical to
            # the gateway listener's own /healthz)
            out["gateway"] = gateway.status_view()
        if store_health is not None:
            # the store failure domain rides liveness too: mode (healthy/
            # degraded/outage), failure streak and the op/outage counters
            # read back from the registry
            out["storeHealth"] = store_health.status_view()
        return out

    r.add("GET", "/healthz", healthz)

    def leader_view(body, **_):
        def _with_store(out):
            # lease health and store health are one story: a leader whose
            # renewals are failing IS a store brownout in progress
            if store_health is not None:
                out["storeHealth"] = store_health.status_view()
            return out

        if shard_plane is not None:
            # shard-aware: the single-lease fields generalize to the full
            # per-shard table (satellite of docs/robustness.md "Sharded
            # writer plane"); holder/epoch/deadline come from each
            # elector's heartbeat-observed cache — zero store reads
            out = shard_plane.status_view()
            out["election"] = True
            out["sharded"] = True
            if informer is not None:
                out["informer"] = informer.status_view()
            return _with_store(out)
        if leader_elector is None:
            return _with_store(
                {"election": False, "role": "single", "accepting": True,
                 "selfId": None, "holderId": None, "epoch": None,
                 "deadline": None, "advertise": "", "ttlS": None,
                 "fencingEpoch": 0})
        out = leader_elector.status_view()
        if informer is not None:
            out["informer"] = informer.status_view()
        return _with_store(out)

    r.add("GET", "/api/v1/leader", leader_view)

    def shards_view(body, **_):
        if shard_plane is None:
            # unsharded deployments still answer: one implicit shard whose
            # lease state is the single elector's (or a bare single role)
            out = {"sharded": False, "shardCount": 1,
                   "held": [], "shards": []}
            if leader_elector is not None:
                sv = leader_elector.status_view()
                sv["shard"] = 0
                out["shards"] = [sv]
                if leader_elector.is_leader:
                    out["held"] = [0]
            return out
        out = shard_plane.status_view()
        out["sharded"] = True
        return out

    r.add("GET", "/api/v1/shards", shards_view)
    if gateway is not None:
        # serving-gateway introspection: instance identity, the watch-fed
        # routing table with per-endpoint breaker/drain/in-flight state,
        # budget levels and the shed/retry/hedge counters — read straight
        # from the gateway engine, zero store reads
        r.add("GET", "/api/v1/gateway",
              lambda body, **_: gateway.status_view())
    if (health_watcher is not None or job_supervisor is not None
            or host_monitor is not None or leader_elector is not None
            or shard_plane is not None
            or informer is not None or admission is not None
            or serving is not None or tracer is not None
            or gateway is not None or store_health is not None):
        # one events ring for the operator: container liveness transitions
        # (health watcher) merged with gang lifecycle events (job
        # supervisor), host health transitions (host monitor), leadership
        # transitions (elector), informer degradations, capacity-market
        # admissions/preemptions, service scaling, workflow steps,
        # slow-trace events and store-mode transitions, ordered by
        # timestamp (SURVEY.md §5.3)
        def h_events(body, **_):
            try:
                limit = int(body.get("limit", 100))
            except (TypeError, ValueError):
                raise errors.BadRequest("limit must be an integer") from None
            if limit <= 0:
                return []
            # each ring is time-ordered already: merge, then keep a
            # bounded tail. ?traceId= filters BEFORE the tail, so each
            # ring is read at full depth for a filtered request
            trace_id = str(body.get("traceId", "") or "")
            per_ring = 1 << 20 if trace_id else limit
            rings = [src.events_view(limit=per_ring)
                     for src in (health_watcher, job_supervisor,
                                 host_monitor, leader_elector, shard_plane,
                                 informer, admission, serving, workflow_svc,
                                 tracer, gateway, store_health)
                     if src is not None]
            merged = heapq.merge(*rings, key=lambda e: e.get("ts", 0))
            if trace_id:
                merged = (e for e in merged
                          if e.get("traceId") == trace_id)
            tail: collections.deque = collections.deque(merged, maxlen=limit)
            return list(tail)

        r.add("GET", "/api/v1/events", h_events)
    if health_watcher is not None:
        r.add("GET", "/api/v1/health/containers",
              lambda body, **_: health_watcher.status_view())
    if job_supervisor is not None:
        # per-gang phase / restart budget / backoff state
        r.add("GET", "/api/v1/health/jobs",
              lambda body, **_: job_supervisor.status_view())
    if work_queue is not None:
        # failed async tasks must be observable (fix for the reference's
        # silent infinite-retry loop, workQueue.go:33-47) — and, since the
        # durable journal, they survive daemon restarts
        r.add("GET", "/api/v1/dead-letters",
              lambda body, **_: work_queue.dead_letter_view())
        r.add("GET", "/api/v1/debug/deadletters",  # legacy alias
              lambda body, **_: work_queue.dead_letter_view())
        # ... and recoverable: re-enqueue after the operator fixed the cause
        r.add("POST", "/api/v1/dead-letters/retry",
              lambda body, **_: {"requeued": work_queue.retry_dead_letters()})
        # queue depth / journal lifecycle / degradation counters
        r.add("GET", "/api/v1/queue", lambda body, **_: work_queue.stats())
    if reconciler is not None:
        # KV-vs-runtime drift sweep (service/reconcile.py); ?dryRun=true
        # reports the planned repairs without mutating anything; ?mode=
        # forces the event-driven split (full = anti-entropy O(objects)
        # scan, dirty = O(changes) watch-fed pass, auto = cadence) and
        # the report names which one actually ran
        def reconcile_view(body, **_):
            dry = str(body.get("dryRun", "false")).lower() in ("1", "true", "yes")
            mode = str(body.get("mode", "auto"))
            if mode not in ("auto", "full", "dirty"):
                raise errors.BadRequest(
                    f"mode must be auto|full|dirty, got {mode!r}")
            return reconciler.reconcile(dry_run=dry, mode=mode)

        r.add("GET", "/api/v1/reconcile", reconcile_view)
        # canonical mutating trigger (GET kept for the reference-style
        # always-200 tooling; prefer POST from anything GET-assuming)
        r.add("POST", "/api/v1/reconcile", reconcile_view)
        r.add("GET", "/api/v1/reconcile/events",
              lambda body, **_: reconciler.events_view())

    if compactor is not None:
        # bounded history (service/compactor.py): run one compaction pass
        # now and return its report (what was trimmed / spared / purged)
        r.add("POST", "/api/v1/compact",
              lambda body, **_: compactor.compact_once())

    if tracer is not None:
        # recent trace summaries + one full span tree, served from the
        # bounded in-process ring (telemetry/trace.py)
        def t_list(body, **_):
            try:
                limit = int(body.get("limit", 100))
            except (TypeError, ValueError):
                raise errors.BadRequest("limit must be an integer") from None
            return tracer.summaries(limit=limit)

        def t_get(body, traceId):  # noqa: N803 — route param name
            view = tracer.trace_view(traceId)
            if view is None:
                # a request carrying both traceparent and X-Request-Id is
                # keyed by the traceparent id: fall back to the root-attr
                # index so the echoed requestId still finds it
                view = tracer.find_by_request_id(traceId)
            if view is None:
                raise errors.NotExistInStore(f"trace {traceId}")
            return view

        r.add("GET", "/api/v1/traces", t_list)
        r.add("GET", "/api/v1/traces/{traceId}", t_get)

    def debug_threads(body, **_):
        """Per-thread stack dump — the pprof-goroutine analog SURVEY.md §5.1
        asks for (a hung copy task or a deadlocked family lock shows up
        here)."""
        import sys
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in sys._current_frames().items():
            out.append({
                "threadId": ident,
                "name": names.get(ident, "?"),
                "stack": [
                    {"file": f.filename, "line": f.lineno, "fn": f.name}
                    for f in traceback.extract_stack(frame)
                ],
            })
        return {"threads": out}

    r.add("GET", "/api/v1/debug/threads", debug_threads)

    # pull-time utilization gauges for /metrics (SURVEY.md §5.5)
    r.metrics.gauge_fn(
        "gpus_free",
        lambda: chip_scheduler.status().get("freeChips", 0),
        help="Unallocated GPUs on this host")
    r.metrics.gauge_fn(
        "gpus_total",
        lambda: chip_scheduler.status().get("totalChips", 0),
        help="Total GPUs on this host")
    r.metrics.gauge_fn(
        "host_ports_used",
        lambda: len(port_scheduler.status().get("usedPorts", [])),
        help="Host ports handed out by the port scheduler")
    if work_queue is not None:
        from tpu_docker_api_torch.state.workqueue import queue_depth

        r.metrics.gauge_fn("workqueue_depth", lambda: queue_depth(work_queue),
                           help="Pending async tasks")
    return r


#: http_request_ms histogram buckets (milliseconds — the registry default
#: is second-scaled and would collapse every request into two bins)
_HTTP_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                    500.0, 1000.0, 5000.0)


def build_handler(router: Router):
    registry = router.metrics

    class Handler(BaseHTTPRequestHandler):
        server_version = "tpu-docker-api"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, not stderr
            log.debug("http: " + fmt, *args)

        def _handle(self, method: str) -> None:
            # drop any stale-read marker a previous request on this
            # keep-alive thread left behind — staleness must never bleed
            # across requests
            consume_stale_read()
            # request identity (SURVEY.md §5.1): a W3C traceparent names the
            # remote trace context exactly; otherwise the caller's
            # X-Request-Id doubles as the trace id; otherwise both are new
            tp = trace.parse_traceparent(self.headers.get("traceparent"))
            # sanitize before echoing (no CRLF response splitting), bounded
            raw_id = self.headers.get("X-Request-Id") or ""
            req_id = ("".join(c for c in raw_id
                              if c.isprintable() and c not in "\r\n")[:128]
                      or (tp[0] if tp else uuid.uuid4().hex[:12]))
            path, _, query = self.path.partition("?")
            if method == "GET" and path == "/metrics":
                body_bytes = registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body_bytes)))
                self.end_headers()
                self.wfile.write(body_bytes)
                return
            found = router.match(method, path)
            route = found[2] if found else "unmatched"
            t0 = time.perf_counter()
            app_code = codes.SUCCESS
            http_status = 200
            stale_lag_ms = None
            retry_after_s = None
            tracer = router.tracer
            span_scope = (tracer.span(
                f"http:{method} {route}",
                trace_id=(tp[0] if tp else req_id),
                parent_id=(tp[1] if tp else ""),
                root=True,
                attrs={"method": method, "route": route,
                       "requestId": req_id})
                if tracer is not None else trace.NOOP)
            with span_scope as root_span:
                try:
                    if found is None:
                        raise errors.BadRequest(
                            f"no route for {method} {path}")
                    handler, params, _ = found
                    # the body is drained even for requests we reject:
                    # leftover bytes would desync a keep-alive connection
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length) if length else b""
                    # ...but the HA standby contract gates BEFORE parsing or
                    # validating it: reads (GET) serve locally, every mutation
                    # gets 503 + the leader hint — a standby never
                    # half-validates a request it will not execute. Mutations
                    # are also rejected while a NEW leader's writer subsystems
                    # are still booting (accepts_mutations), so no request can
                    # race the leadership-handoff cache reload
                    elector = router.leader_elector
                    if (method != "GET" and elector is not None
                            and not elector.accepts_mutations):
                        raise errors.NotLeader(elector.standby_message())
                    # sharded plane: the same gate per shard. The target
                    # shard comes from the family name (path segment, or
                    # the create body's *Name field) — zero store reads;
                    # non-family mutations belong to shard 0, the
                    # singleton-of-last-resort. Wrong shard ⇒ 503 naming
                    # the OWNING shard's advertised holder (a redirect,
                    # never a proxy).
                    plane = router.shard_plane
                    if method != "GET" and plane is not None:
                        shard = _shard_for_request(plane, path, raw)
                        if not plane.accepting(shard):
                            raise errors.NotLeader(
                                plane.standby_message(shard))
                    # store brownout gate: in outage mode a mutation that
                    # cannot journal its intent must never half-apply —
                    # fail fast with the typed 503 + Retry-After (zero
                    # store round trips), except the single-flight heal
                    # probe admit_mutation lets through
                    if method != "GET" and router.store_health is not None:
                        router.store_health.admit_mutation()
                    body = json.loads(raw) if raw else {}
                    if not isinstance(body, dict):
                        raise errors.BadRequest("body must be a JSON object")
                    # query params merge under the body (body wins): GET
                    # handlers take options like ?limit=5 the natural way
                    for k, vs in urllib.parse.parse_qs(query).items():
                        body.setdefault(k, vs[-1])
                    with trace.child(f"dispatch:{route}"):
                        data = handler(body=body, **params)
                    # a read served from the informer mirror during a store
                    # outage marked this thread — surface the staleness
                    # explicitly (envelope + header below)
                    stale_lag_ms = consume_stale_read()
                    payload = response.success(
                        data, stale=(None if stale_lag_ms is None
                                     else {"lagMs": stale_lag_ms}))
                except errors.ApiError as e:
                    app_code = e.code
                    # the deviations from always-200: backpressure (429),
                    # a moved list snapshot (410), a store outage (503)
                    http_status = e.http_status or 200
                    # typed backoff hint (StoreDegraded): surfaced as the
                    # Retry-After header so retry-aware clients hold off
                    retry_after_s = getattr(e, "retry_after_s", None)
                    payload = response.error(e.code, str(e), data=e.data,
                                             request_id=req_id)
                except json.JSONDecodeError as e:
                    app_code = codes.BAD_REQUEST
                    payload = response.error(codes.BAD_REQUEST,
                                             f"invalid JSON: {e}",
                                             request_id=req_id)
                except Exception as e:  # noqa: BLE001 — envelope every failure
                    app_code = codes.SERVER_ERROR
                    log.exception("unhandled error on %s %s id=%s",
                                  method, self.path, req_id)
                    payload = response.error(codes.SERVER_ERROR, str(e),
                                             request_id=req_id)
                if root_span is not None:
                    root_span.attrs["code"] = app_code
                    if app_code != codes.SUCCESS:
                        root_span.status = "error"
            dur = time.perf_counter() - t0
            labels = {"method": method, "route": route, "code": str(app_code)}
            registry.counter_inc("api_requests_total", labels,
                                 help="API requests by route and app code")
            registry.observe("api_request_duration_seconds",
                             dur, {"method": method, "route": route},
                             help="API request latency")
            registry.counter_inc(
                "http_requests_total",
                {"method": method, "route": route, "code": str(http_status)},
                help="HTTP requests by route, method and status")
            registry.observe(
                "http_request_ms", dur * 1e3,
                {"method": method, "route": route},
                buckets=_HTTP_MS_BUCKETS,
                help="HTTP request wall time, milliseconds")
            log.info("%s %s code=%d dur=%.1fms id=%s",
                     method, path, app_code, dur * 1e3, req_id)
            # reference: always HTTP 200, app code in envelope
            # (response.go:15-29) — except the typed statuses above
            self.send_response(http_status)
            self.send_header("Content-Type", "application/json")
            self.send_header("X-Request-Id", req_id)
            if retry_after_s is not None:
                # integer seconds, never 0 — Retry-After: 0 reads as
                # "retry immediately", the opposite of the hint
                self.send_header("Retry-After",
                                 str(max(1, math.ceil(retry_after_s))))
            if stale_lag_ms is not None:
                # the header twin of the envelope's stale field
                self.send_header("X-Stale-Read", str(stale_lag_ms))
            if root_span is not None:
                # the W3C echo: tell the caller which span served them
                tp_out = trace.format_traceparent(root_span)
                if tp_out:
                    self.send_header("traceparent", tp_out)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802
            self._handle("GET")

        def do_POST(self):  # noqa: N802
            self._handle("POST")

        def do_DELETE(self):  # noqa: N802
            self._handle("DELETE")

        def do_PATCH(self):  # noqa: N802
            self._handle("PATCH")

    return Handler


class ApiServer:
    """Serving wrapper: bind, serve in a thread, close (reference
    program.Start's gin goroutine, main.go:95-110)."""

    def __init__(self, router: Router, host: str = "127.0.0.1", port: int = 0) -> None:
        self._httpd = ThreadingHTTPServer((host, port), build_handler(router))
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-serve", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join()
            self._thread = None
