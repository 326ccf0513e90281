"""The port's REST API (``api/app.py`` ``build_router`` + ``ApiServer``)
against the JAX package's on the CPU: one request script sent over HTTP
to both servers, each over its own services, fake runtime, memory store
and an HGX line of 8 GPUs. HTTP statuses and reply bodies must match key
for key, apart from the logged differences (the grant's attachment in a
stored spec, the GPU view's ``uuid``, the random ids). The routes of the
families the port lacks answer 501 with code 10002, naming the missing
service and ROADMAP Queue 1 item 10; the reconcile routes answer as
JAX's."""

import http.client
import json

import pytest

import test_torch_container_service as svc
from tpu_docker_api.api import app as japp
from tpu_docker_api.telemetry import trace as jtrace
from tpu_docker_api_torch.api import app as tapp
from tpu_docker_api_torch.api import codes as tcodes
from tpu_docker_api_torch.telemetry import trace as ttrace


def _server(pkg, root):
    w = svc.World(pkg, root)
    app, trace = (japp, jtrace) if pkg is svc.JAX else (tapp, ttrace)
    router = app.build_router(w.csvc, w.vsvc, w.chips, w.ports,
                              work_queue=w.wq, tracer=trace.Tracer(),
                              list_max_limit=3)
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


NOT_PORTED = [
    ("POST", "/jobs", "jobs"), ("GET", "/jobs", "jobs"),
    ("GET", "/jobs/j", "jobs"), ("PATCH", "/jobs/j/tpu", "jobs"),
    ("DELETE", "/jobs/j", "jobs"), ("GET", "/health/jobs", "job supervisor"),
    ("GET", "/admission", "admission"), ("POST", "/services", "services"),
    ("GET", "/services/s", "services"), ("POST", "/services/s/load",
                                          "services"),
    ("POST", "/workflows", "workflows"), ("GET", "/workflows", "workflows"),
    ("GET", "/resources/slices", "pod slices"),
    ("POST", "/hosts/h/cordon", "hosts"), ("POST", "/hosts/h/drain", "hosts"),
    ("GET", "/health/hosts", "hosts"), ("GET", "/gateway", "gateway"),
    ("GET", "/leader", "leader election"), ("GET", "/shards", "shards"),
    ("POST", "/compact", "history compaction"),
]


def test_unported_routes_are_refused_by_name(tmp_path):
    server, w = _server(svc.PORT, str(tmp_path))
    try:
        for method, path, what in NOT_PORTED:
            status, reply = call(server.port, method, B + path, {})
            assert status == 501, path
            assert reply["code"] == tcodes.NOT_PORTED == 10002, path
            assert what in reply["msg"], (path, reply["msg"])
            assert "ROADMAP Queue 1 item 10" in reply["msg"], path
        status, reply = call(server.port, "GET", B + "/nowhere")
        assert (status, reply["code"]) == (200, 10001)
    finally:
        server.close()
        w.wq.close()


def _strip_clock(obj):
    """Drop what differs run to run: timestamps, trace ids, durations."""
    if isinstance(obj, dict):
        return {k: _strip_clock(v) for k, v in obj.items()
                if k not in ("ts", "traceId", "spanId", "durationMs")}
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
