"""The port's REST API (``api/app.py`` ``build_router`` + ``ApiServer``)
against the JAX package's on the CPU: one request script sent over HTTP
to both servers, each over its own services, fake runtime, memory store
and an HGX line of 8 GPUs. HTTP statuses and reply bodies must match key
for key, apart from the logged differences (the grant's attachment in a
stored spec, the GPU view's ``uuid``, the random ids). Every route answers
as JAX's: the reconcile, job, slice, host, admission, service, workflow,
leader, shard, compaction and gateway routes too, and no route answers
501 any more."""

import http.client
import json

import pytest

import test_torch_container_service as svc
from tpu_docker_api.api import app as japp
from tpu_docker_api.telemetry import trace as jtrace
from tpu_docker_api_torch.api import app as tapp
from tpu_docker_api_torch.telemetry import trace as ttrace


def _server(pkg, root, gateway=None):
    w = svc.World(pkg, root)
    app, trace = (japp, jtrace) if pkg is svc.JAX else (tapp, ttrace)
    router = app.build_router(w.csvc, w.vsvc, w.chips, w.ports,
                              work_queue=w.wq, tracer=trace.Tracer(),
                              list_max_limit=3, gateway=gateway)
    server = app.ApiServer(router, port=0)
    server.start()
    return server, w


def call(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    conn.request(method, path, body=data)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()))
    conn.close()
    return out


B = "/api/v1"
BIND = {"src": "/data/a", "dest": "/a"}
SCRIPT = [
    ("GET", "/healthz", None),
    ("POST", B + "/containers", {"imageName": "jax", "containerName": "t",
                                 "gpuCount": 4, "binds": [BIND],
                                 "containerPorts": [{"containerPort": 80}]}),
    ("POST", B + "/containers", {"imageName": "jax", "containerName": "t",
                                 "chipCount": 1}),
    ("POST", B + "/containers", {"imageName": "jax", "containerName": "u-1",
                                 "chipCount": 1}),
    ("POST", B + "/containers", {"containerName": "u", "chipCount": 1}),
    ("POST", B + "/containers", {"imageName": "i", "containerName": "u",
                                 "chipCount": -1}),
    ("POST", B + "/containers", {"imageName": "i", "containerName": "u",
                                 "chipCount": "2"}),
    ("POST", B + "/containers", {"imageName": "i", "containerName": "u",
                                 "chipCount": 5}),
    ("POST", B + "/containers", {"imageName": "i", "containerName": "g",
                                 "gpuCount": 0}),
    ("POST", B + "/containers/t-0/execute", {"cmd": ["python", "-c",
                                                     "print(42)"]}),
    ("POST", B + "/containers/t-0/execute", {}),
    ("PATCH", B + "/containers/t-0/gpu", {"gpuCount": 8}),
    ("PATCH", B + "/containers/t-1/tpu", {"chipCount": 6}),
    ("PATCH", B + "/containers/t-0/gpu", {"gpuCount": 2}),
    ("PATCH", B + "/containers/t/gpu", {}),
    ("PATCH", B + "/containers/t/gpu", {"gpuCount": 6}),
    ("GET", B + "/resources/gpus", None),
    ("GET", B + "/resources/tpus", None),
    ("GET", B + "/resources/ports", None),
    ("PATCH", B + "/containers/t/volume", {"oldBind": BIND,
                                           "newBind": {"src": "/data/b",
                                                       "dest": "/a"}}),
    ("PATCH", B + "/containers/t/volume", {"oldBind": BIND}),
    ("GET", B + "/containers/t/history", None),
    ("GET", B + "/containers/t-1", None),
    ("GET", B + "/containers/t", None),
    ("PATCH", B + "/containers/t/rollback", {"version": 0}),
    ("PATCH", B + "/containers/t/rollback", {"version": "x"}),
    ("PATCH", B + "/containers/t/rollback", {}),
    ("POST", B + "/containers/t/stop", None),
    ("PATCH", B + "/containers/t/restart", None),
    ("POST", B + "/containers/t/commit", {"newImageName": "t:v2"}),
    ("POST", B + "/containers/t/commit", {}),
    ("POST", B + "/volumes", {"volumeName": "v", "size": "10GB"}),
    ("POST", B + "/volumes", {"volumeName": "v-2", "size": "10GB"}),
    ("POST", B + "/volumes", {"volumeName": "w", "size": "10XB"}),
    ("PATCH", B + "/volumes/v-0/size", {"size": "20GB"}),
    ("PATCH", B + "/volumes/v-0/size", {"size": "30GB"}),
    ("PATCH", B + "/volumes/v/size", {}),
    ("GET", B + "/volumes/v/history", None),
    ("GET", B + "/volumes/v", None),
    ("PATCH", B + "/volumes/v/rollback", {"version": 0, "dataFrom": "target"}),
    ("PATCH", B + "/volumes/v/rollback", {"version": 0, "dataFrom": "nope"}),
    ("GET", B + "/containers", None),
    ("GET", B + "/containers?limit=1", None),
    ("GET", B + "/containers?limit=99", None),
    ("GET", B + "/containers?limit=x", None),
    ("GET", B + "/containers?limit=2&continue=garbage", None),
    ("GET", B + "/volumes", None),
    ("GET", B + "/queue", None),
    ("GET", B + "/dead-letters", None),
    ("POST", B + "/dead-letters/retry", None),
    ("GET", B + "/events?limit=5", None),
    ("GET", B + "/events?limit=x", None),
    ("DELETE", B + "/containers/t-2", {"force": True,
                                       "delEtcdInfoAndVersionRecord": True}),
    ("DELETE", B + "/containers/t", {"force": True}),
    ("DELETE", B + "/containers/g", {"delEtcdInfoAndVersionRecord": True}),
    ("DELETE", B + "/volumes/v", {"delEtcdInfoAndVersionRecord": True}),
    ("GET", B + "/containers/t", None),
    ("GET", B + "/containers/bad%20name", None),
    ("GET", B + "/containers", None),
    ("GET", B + "/resources/ports", None),
    ("GET", B + "/nowhere", None),
]


def _run(pkg, root):
    server, w = _server(pkg, root)
    out = []
    try:
        for method, path, body in SCRIPT:
            status, reply = call(server.port, method, path, body)
            w.wq.drain()
            reply.pop("requestId", None)
            if path.endswith("/resources/gpus") or path.endswith("/tpus"):
                for c in reply["data"]["chips"]:
                    c.pop("uuid", None)
            out.append((method, path, status, reply))
        out.append(("bad json",) + call(server.port, "POST", B + "/volumes",
                                        raw=b"{nope"))
        out.append(("not an object",) + call(server.port, "POST",
                                             B + "/volumes", raw=b"[1]"))
        for item in out[-2:]:
            item[2].pop("requestId", None)
    finally:
        server.close()
        w.wq.close()
    return svc._strip(out, root)


def test_api_replies_match_jax_key_for_key(tmp_path):
    want = _run(svc.JAX, str(tmp_path / "jax"))
    got = _run(svc.PORT, str(tmp_path / "port"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[:2]
    codes = [r[3]["code"] for r in got[:-2]]
    assert codes.count(200) > 30
    assert {10001, 10201, 10301, 10601} <= set(codes)


def test_api_gpu_view_carries_the_uuids(tmp_path):
    server, w = _server(svc.PORT, str(tmp_path))
    try:
        call(server.port, "POST", B + "/containers",
             {"imageName": "i", "containerName": "g", "gpuCount": 2})
        status, reply = call(server.port, "GET", B + "/resources/gpus")
        status_c, info = call(server.port, "GET", B + "/containers/g")
    finally:
        server.close()
        w.wq.close()
    chips = reply["data"]["chips"]
    assert [c["uuid"] for c in chips] == [
        f"GPU-00000000-0000-0000-0000-{i:012d}" for i in range(8)]
    granted = [c["uuid"] for c in chips if c["owner"] == "g"]
    assert info["data"]["state"]["spec"]["gpu_uuids"] == granted
    assert (f"CUDA_VISIBLE_DEVICES={','.join(granted)}"
            in info["data"]["state"]["spec"]["env"])


#: the routes of item 10 part v's control plane, which answered 501 before
#: workflows, leader election, shards, compaction and the gateway were
#: ported
PORTED_CONTROL = [
    ("POST", "/workflows"), ("GET", "/workflows"), ("GET", "/leader"),
    ("GET", "/shards"), ("POST", "/compact"), ("GET", "/gateway"),
]


def test_unported_routes_are_refused_by_name(tmp_path):
    servers = {name: _server(pkg, str(tmp_path / name))
               for name, pkg in (("jax", svc.JAX), ("port", svc.PORT))}
    server = servers["port"][0]
    try:
        status, reply = call(server.port, "GET", B + "/nowhere")
        assert (status, reply["code"]) == (200, 10001)
        # the capacity market's, the services', the workflows', the
        # leader's, the shards' and the compactor's routes are ported: a
        # router without those services answers as JAX's does (no route,
        # or the single-process leader and shard views)
        for method, path in (("GET", "/admission"), ("POST", "/services"),
                             ("GET", "/services/s")) + tuple(PORTED_CONTROL):
            got = {}
            for name, (srv, _) in servers.items():
                status, reply = call(srv.port, method, B + path, {})
                reply.pop("requestId", None)
                got[name] = (status, reply)
            assert got["port"] == got["jax"], path
        assert call(server.port, "GET", B + "/leader")[1]["data"][
            "role"] == "single"
        assert call(server.port, "POST", B + "/workflows", {})[1][
            "code"] == 10001
    finally:
        for srv, w in servers.values():
            srv.close()
            w.wq.close()
    # with a gateway, /gateway, /healthz's gateway block and the events
    # ring answer as JAX's: the same keys and values but the instance id
    import torch_control as tc

    views = {}
    for name, pkg, world in (("jax", tc.JAX, svc.JAX),
                             ("port", tc.PORT, svc.PORT)):
        gw = pkg.gateway.Gateway(pkg.kv.MemoryKV(),
                                 resolve_addr=lambda hid: "127.0.0.1")
        srv, w = _server(world, str(tmp_path / f"gw-{name}"), gateway=gw)
        try:
            status, reply = call(srv.port, "GET", B + "/gateway")
            health = call(srv.port, "GET", "/healthz")[1]["data"]["gateway"]
            events = call(srv.port, "GET", B + "/events")
        finally:
            srv.close()
            w.wq.close()
        assert reply["data"].pop("instanceId") == gw.instance_id
        assert health.pop("instanceId") == gw.instance_id
        views[name] = (status, reply["code"], reply["data"], health,
                       events[1]["data"])
    assert views["port"] == views["jax"]
    assert views["port"][:2] == (200, 200)
    assert views["port"][2]["counters"]["requests"] == 0


#: the routes of item 10 part iv, which answered 501 before the pod, the
#: job service, the supervisor and the host monitor were ported: each
#: group is one script sent to both packages' daemons over HTTP
POD_SCRIPTS = {
    "jobs": [
        ("POST", "/jobs", {"imageName": "jax", "jobName": "j",
                           "chipCount": 16, "binds": ["/n:/n"]}),
        ("POST", "/jobs", {"imageName": "jax", "jobName": "j",
                           "chipCount": 8}),
        ("POST", "/jobs", {"imageName": "jax", "jobName": "bad-1",
                           "chipCount": 8}),
        ("POST", "/jobs", {"imageName": "jax", "jobName": "k",
                           "chipCount": 12}),
        ("GET", "/jobs", None), ("GET", "/jobs?limit=1", None),
        ("GET", "/jobs/j", None), ("GET", "/jobs/j-3", None),
        ("PATCH", "/jobs/j/tpu", {"chipCount": 8}),
        ("PATCH", "/jobs/j/tpu", {"chipCount": 8}),
        ("GET", "/jobs/j", None), ("POST", "/jobs/j/stop", {}),
        ("PATCH", "/jobs/j/restart", {}),
        ("DELETE", "/jobs/j", {"force": True,
                               "delStateAndVersionRecord": True}),
        ("GET", "/jobs/j", None),
    ],
    "health": [
        ("POST", "/jobs", {"imageName": "jax", "jobName": "j",
                           "chipCount": 8}),
        ("GET", "/health/jobs", None), ("GET", "/health/hosts", None),
    ],
    "slices": [
        ("GET", "/resources/slices", None),
        ("POST", "/jobs", {"imageName": "jax", "jobName": "j",
                           "chipCount": 4}),
        ("GET", "/resources/slices", None),
    ],
    "hosts": [
        ("POST", "/hosts/h1/cordon", {}), ("POST", "/hosts/h9/cordon", {}),
        ("POST", "/jobs", {"imageName": "jax", "jobName": "j",
                           "chipCount": 16}),
        ("GET", "/resources/slices", None),
        ("POST", "/hosts/h1/uncordon", {}), ("POST", "/hosts/h1/drain", {}),
        ("GET", "/resources/slices", None),
    ],
    # the routes of item 10 part v ported with the capacity market and
    # the Service resource (POD_CONFIG turns the market on)
    "market": [
        ("POST", "/jobs", {"imageName": "jax", "jobName": "low",
                           "chipCount": 16, "priorityClass": "preemptible"}),
        ("POST", "/jobs", {"imageName": "jax", "jobName": "high",
                           "chipCount": 8, "priorityClass": "production"}),
        ("POST", "/jobs", {"imageName": "jax", "jobName": "x",
                           "chipCount": 8, "priorityClass": "gold"}),
        ("GET", "/admission", None), ("GET", "/jobs/high", None),
        ("POST", "/jobs/high/stop", {}), ("GET", "/admission", None),
        ("POST", "/reconcile?mode=full", {}), ("GET", "/health/jobs", None),
    ],
    "services": [
        ("POST", "/services", {"serviceName": "s", "imageName": "serve",
                               "chipsPerReplica": 8, "replicas": 1,
                               "maxReplicas": 3}),
        ("POST", "/services", {"serviceName": "s", "imageName": "serve",
                               "chipsPerReplica": 8}),
        ("POST", "/services", {"serviceName": "bad-1", "imageName": "i",
                               "chipsPerReplica": 8}),
        ("GET", "/services", None), ("GET", "/services/s", None),
        ("POST", "/services/s/load", {"rps": 500}),
        ("POST", "/services/s/load", {"rps": "lots"}),
        ("PATCH", "/services/s", {"replicas": 3}),
        ("GET", "/services/s-0", None), ("GET", "/admission", None),
        ("PATCH", "/services/s", {"imageName": "serve:v2"}),
        ("PATCH", "/services/s-0", {"replicas": 1}),
        ("DELETE", "/services/s", None), ("GET", "/services/s", None),
        ("GET", "/jobs", None),
    ],
}
#: the config a group's daemons take beside _pod_daemon's
POD_CONFIG = {"market": {"admission_enabled": True,
                         "admission_interval_s": 0},
              "services": {"admission_enabled": True,
                           "admission_interval_s": 0,
                           "autoscale_interval_s": 0}}


def _pod_daemon(pkg, **extra):
    import torch_control as tc

    cfg = pkg.config.Config(
        port=0, store_backend="memory", runtime_backend="fake",
        accelerator_type="h100-8", health_watch_interval=0,
        reconcile_on_start=False, job_supervise_interval=3600,
        host_probe_interval_s=3600, pod_hosts=[
            {"host_id": "h0", "address": "10.0.0.1",
             "grid_coord": [0, 0, 0], "local": True},
            {"host_id": "h1", "address": "10.0.0.2",
             "grid_coord": [1, 0, 0], "runtime_backend": "fake"}], **extra)
    prg = pkg.daemon.Program(cfg, host="127.0.0.1", kv=pkg.kv.MemoryKV(),
                             runtime=pkg.fake.FakeRuntime())
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    prg.start()
    return prg


@pytest.mark.parametrize("group", sorted(POD_SCRIPTS))
def test_job_slice_and_host_routes_answer_as_jax(group):
    import torch_control as tc

    got = []
    with tc.jax_knows_h100():
        for pkg in tc.PKGS:
            prg = _pod_daemon(pkg, **POD_CONFIG.get(group, {}))
            try:
                got.append([[m, path, *call(prg.api_server.port, m, B + path,
                                            body)]
                            for m, path, body in POD_SCRIPTS[group]])
                status, health = call(prg.api_server.port, "GET",
                                      "/healthz")
                # fake engines keep no connection pool: no enginePools
                assert "enginePools" not in health["data"]
            finally:
                prg.stop()
    jax, port = (_strip_clock(g) for g in got)
    for j, p in zip(jax, port):
        assert p == j, p[:2]
    assert all(status != 501 for _, _, status, _ in port)
    assert port[0][3]["code"] == 200


def _strip_clock(obj):
    """Drop what differs run to run: timestamps, trace ids, durations (an
    admission entry's ``waitingS`` is its age in seconds)."""
    if isinstance(obj, dict):
        return {k: _strip_clock(v) for k, v in obj.items()
                if k not in ("ts", "traceId", "spanId", "durationMs",
                             "sinceS", "requestId", "waitingS")}
    if isinstance(obj, list):
        return [_strip_clock(v) for v in obj]
    return obj


def _reconcile_script(pkg, root):
    from tpu_docker_api.service import reconcile as jrec
    from tpu_docker_api_torch.service import reconcile as trec

    w = svc.World(pkg, root)
    rec = (jrec if pkg is svc.JAX else trec).Reconciler(
        w.runtime, w.csvc.store, w.chips, w.ports, w.csvc.versions,
        container_svc=w.csvc, work_queue=w.wq)
    app = japp if pkg is svc.JAX else tapp
    server = app.ApiServer(app.build_router(
        w.csvc, w.vsvc, w.chips, w.ports, work_queue=w.wq,
        reconciler=rec), port=0)
    server.start()
    out = []
    try:
        call(server.port, "POST", B + "/containers", {
            "imageName": "i", "containerName": "t", "gpuCount": 2,
            "containerPorts": [{"containerPort": 80}]})
        w.runtime.crash_container("t-0")
        for method, path in [("GET", "/reconcile?dryRun=true"),
                             ("POST", "/reconcile?mode=full"),
                             ("GET", "/reconcile/events"),
                             ("GET", "/reconcile?mode=bogus"),
                             ("GET", "/reconcile")]:
            status, reply = call(server.port, method, B + path)
            reply.pop("requestId", None)
            out.append((method, path, status, _strip_clock(reply)))
        out.append(w.runtime.container_inspect("t-0").running)
    finally:
        server.close()
        w.wq.close()
    return out


def test_reconcile_routes_answer_as_jax(tmp_path):
    """``GET``/``POST /api/v1/reconcile`` (``?dryRun=`` and ``?mode=``)
    and ``GET /api/v1/reconcile/events`` on a crashed container: the
    port's replies equal JAX's, and the repair restarts it."""
    got = _reconcile_script(svc.PORT, str(tmp_path / "port"))
    want = _reconcile_script(svc.JAX, str(tmp_path / "jax"))
    assert got == want
    assert got[-1] is True
    assert [a["action"] for a in got[1][3]["data"]["actions"]] == [
        "restart-dead"]
    assert got[3][3]["code"] != 200


@pytest.mark.parametrize("path", ["/metrics", B + "/debug/threads",
                                  B + "/traces", B + "/health/containers"])
def test_observability_routes_answer(path, tmp_path):
    server, w = _server(svc.PORT, str(tmp_path))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
    finally:
        server.close()
        w.wq.close()
    if path == "/metrics":
        assert resp.status == 200 and "gpus_total 8" in body
    elif path.endswith("/health/containers"):
        # no health watcher wired into this router: not a route here
        assert json.loads(body)["code"] == 10001
    else:
        assert resp.status == 200 and json.loads(body)["code"] == 200


def _bare_router(pkg, root, **extra):
    w = svc.World(pkg, root)
    app = japp if pkg is svc.JAX else tapp
    return app.build_router(w.csvc, w.vsvc, w.chips, w.ports, **extra), w


def test_router_dispatch_matches_jax(tmp_path):
    """``Router.dispatch`` as JAX has it: a known route answers its
    handler's result; an unknown one raises ``BadRequest`` with the same
    message."""
    out = []
    for name, pkg in (("jax", svc.JAX), ("port", svc.PORT)):
        router, w = _bare_router(pkg, str(tmp_path / name))
        try:
            known = router.dispatch("GET", B + "/volumes", {})
            try:
                router.dispatch("GET", B + "/no/such/route", {})
                unknown = None
            except Exception as e:  # noqa: BLE001 - the class is compared
                unknown = (type(e).__name__, str(e))
        finally:
            w.wq.close()
        out.append((known, unknown))
    assert out[0] == out[1]
    assert out[1][1] == ("BadRequest", f"no route for GET {B}/no/such/route")


def test_events_route_guard_matches_jax(tmp_path):
    """A router wired with a workflow service and no other event source
    has JAX's route inventory: a workflow service alone adds no
    ``/api/v1/events``."""

    class _Any:
        def __getattr__(self, _):
            return lambda *a, **k: {}

    inventories = []
    for name, pkg in (("jax", svc.JAX), ("port", svc.PORT)):
        router, w = _bare_router(pkg, str(tmp_path / name),
                                 workflow_svc=_Any())
        w.wq.close()
        inventories.append(sorted((m, p) for m, _, p, _ in router._routes))
    assert inventories[0] == inventories[1]
    assert ("GET", B + "/events") not in inventories[1]
