"""The port's daemon (``config.py``, ``daemon.py``, ``__main__.py``)
against the JAX package's on the CPU: config parsing and validation equal
JAX's but for the port's off-by-default features; features the port
lacks are refused by name; ``python -m tpu_docker_api_torch``
answers the verify recipe's container and volume flow as JAX's daemon
does; a daemon killed with SIGKILL on SQLite restarts with every
acknowledged write; a crash at a labeled point (modeled on
``tests/test_chaos.py``) converges through the startup reconcile's
journal replay; and
a GPU-less container's exec sees no GPU even when the daemon's own
environment names one."""

import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from tpu_docker_api import config as jconfig
from tpu_docker_api import daemon as jdaemon
import torch_control as tc
from tpu_docker_api_torch import config as tconfig
from tpu_docker_api_torch.daemon import Program
from tpu_docker_api_torch.runtime.fake import FakeRuntime
from tpu_docker_api_torch.schemas.container import ContainerRun
from tpu_docker_api_torch.schemas.volume import VolumeCreate, VolumeSize
from tpu_docker_api_torch.service.crashpoints import SimulatedCrash, armed
from tpu_docker_api_torch.state.kv import SqliteKV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = "/api/v1"

#: the port's defaults that differ from JAX's: features the port lacks
#: are off, and the synthesized host is an H100 one
PORT_DEFAULTS = {
    "accelerator_type": ("v5e-8", "h100-8"),
}


# -- config -------------------------------------------------------------------


def test_config_defaults_are_jax_but_the_port_off_switches():
    j = dataclasses.asdict(jconfig.Config())
    t = dataclasses.asdict(tconfig.Config())
    assert set(t) == set(j) | {"fake_runtime_root"}
    assert t.pop("fake_runtime_root") == ""
    diff = {k: (j[k], t[k]) for k in j if j[k] != t[k]}
    assert diff == PORT_DEFAULTS


def _toml(tmp_path, text, tag="cfg"):
    path = tmp_path / f"{tag}.toml"
    path.write_text(text)
    return str(path)


SINGLE_HOST = """
port = 18731
store_backend = "sqlite"
sqlite_path = "/tmp/x.db"
runtime_backend = "fake"
accelerator_type = "h100-8"
start_port = 40000
end_port = 40099
health_watch_interval = 0.5
restart_policy = "on-failure"
restart_backoff_s = 0.25
list_default_limit = 50
list_max_limit = 500
queue_submit_timeout_s = 1.5
queue_dead_letter_retry_budget = 5
trace_buffer_size = 64
trace_slow_ms = 250.0
tracing_enabled = false
reconcile_on_start = false
job_supervise_interval = 0.0
host_probe_interval_s = 0.0
autoscale_interval_s = 0.0
workflow_interval_s = 0.0
[priority_class_weights]
gold = 5
batch = 1
"""


def test_single_host_config_parses_as_jax(tmp_path):
    path = _toml(tmp_path, SINGLE_HOST)
    j = dataclasses.asdict(jconfig.load(path))
    t = dataclasses.asdict(tconfig.load(path))
    t.pop("fake_runtime_root")
    assert t == j
    assert t["service_default_class"] == "batch"  # JAX's fallback, too
    assert dataclasses.asdict(tconfig.load(None)) == dataclasses.asdict(
        tconfig.Config())


@pytest.mark.parametrize("line", [
    'restart_policy = "always"', 'read_cache = "nope"', "fanout_workers = 0",
    "list_max_limit = 0", "list_default_limit = 9999",
    "trace_buffer_size = 0", "store_op_deadline_s = -1",
    "history_compact_interval_s = 0", "queue_dead_letter_retry_budget = 0",
    'priority_class_default = "gold"', "autoscale_down_watermark = 0",
    "job_resize_max = 0", "gateway_port = 70000"])
def test_config_validation_errors_as_jax(line, tmp_path):
    path = _toml(tmp_path, line)
    with pytest.raises(ValueError) as jexc:
        jconfig.load(path)
    with pytest.raises(ValueError) as texc:
        tconfig.load(path)
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("lines,key", [
    ("leader_election = true", "leader_election"),
    ("leader_election = true\nshard_count = 2", "shard_count"),
    ('[[pod_hosts]]\nhost_id = "h0"\naddress = "a"', "pod_hosts"),
    ("job_supervise_interval = 5.0", "job_supervise_interval"),
    ("host_probe_interval_s = 5.0", "host_probe_interval_s"),
    ("admission_enabled = true", "admission_enabled"),
    ("autoscale_interval_s = 2.0", "autoscale_interval_s"),
    ("workflow_interval_s = 2.0", "workflow_interval_s"),
    ("gateway_enabled = true", "gateway_enabled"),
    ("history_retention_versions = 3", "history_retention_versions"),
])
def test_unported_features_are_refused_by_name(lines, key, tmp_path):
    path = _toml(tmp_path, lines)
    j = jconfig.load(path)  # JAX takes every one
    if key in PORTED_CONTROL_KEYS:
        # workflows, leader election, shards and compaction are ported:
        # the port loads the same TOML to the same values, and a Program
        # booted on it wires the same subsystems as JAX's does
        t = tconfig.load(path)
        assert getattr(t, key) == getattr(j, key)
        with tc.jax_knows_h100():
            got = [_wiring(pkg, cfg) for pkg, cfg in
                   ((tc.JAX, j), (tc.PORT, t))]
        assert got[1] == got[0]
        return
    if key in PORTED_POD_KEYS + PORTED_MARKET_KEYS:
        # pods, the job supervisor, the host monitor, the capacity market
        # and the autoscaler are ported: the port loads the same TOML to
        # the same values, and boots on it
        t = tconfig.load(path)
        assert getattr(t, key) == getattr(j, key)
        diff = {k: (v, getattr(t, k))
                for k, v in dataclasses.asdict(j).items()
                if v != getattr(t, k)}
        assert diff == PORT_DEFAULTS
        prg = Program(t, kv=None, runtime=FakeRuntime(),
                      pod_runtimes={"h0": FakeRuntime()})
        prg._discover_topology = lambda: _h100_topology()
        prg.init()
        try:
            assert sorted(prg.pod.hosts) == (["h0"] if key == "pod_hosts"
                                             else ["local"])
            assert (prg.host_monitor is not None) == (
                t.host_probe_interval_s > 0)
            # the market and the Service resource are always built; the
            # keys gate the policy and the loops
            assert prg.admission.enabled is t.admission_enabled
            assert prg.job_svc.admission is prg.admission
            assert prg.serving is not None
            assert prg.reconciler._serving is prg.serving
            assert prg.reconciler._admission is (
                prg.admission if t.admission_enabled else None)
        finally:
            prg.stop()
        return
    # the serving gateway is ported: the port loads the same TOML to the
    # same values, and a daemon booted on it serves the gateway's listener
    # and status views and waits on the drain coordinator, as JAX's does
    assert key in PORTED_GATEWAY_KEYS
    t = tconfig.load(path)
    assert getattr(t, key) == getattr(j, key) is True
    with tc.jax_knows_h100():
        got = [_gateway_wiring(pkg, cfg) for pkg, cfg in
               ((tc.JAX, j), (tc.PORT, t))]
    assert got[1] == got[0]
    assert got[1]["coordinator"] == "DrainCoordinator"
    assert got[1]["listener"] == (200, ["gateway", "status"], True)


#: the keys of item 10 part iv, refused before the pod and its services
#: were ported
PORTED_POD_KEYS = ("pod_hosts", "job_supervise_interval",
                   "host_probe_interval_s")
#: the keys of item 10 part v's capacity market and Service resource
PORTED_MARKET_KEYS = ("admission_enabled", "autoscale_interval_s")
#: the keys of item 10 part v's workflows, leader election, sharded
#: writer plane and history compactor
PORTED_CONTROL_KEYS = ("leader_election", "shard_count",
                       "workflow_interval_s", "history_retention_versions")
#: the key of item 10's serving gateway
PORTED_GATEWAY_KEYS = ("gateway_enabled",)


def _wiring(pkg, cfg):
    """Which subsystems a Program booted on ``cfg`` has, by class name."""
    cfg = dataclasses.replace(cfg, store_backend="memory",
                              accelerator_type="h100-8")
    prg = pkg.daemon.Program(cfg, kv=None, runtime=pkg.fake.FakeRuntime())
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    try:
        return {name: type(getattr(prg, name)).__name__
                for name in ("kv", "leader_elector", "shard_plane",
                             "informer", "workflow", "compactor",
                             "workflow_versions", "job_versions")} | {
            "interval": prg.workflow._interval,
            "shards": (None if prg.shard_map is None
                       else prg.shard_map.count)}
    finally:
        prg.stop()


def _gateway_wiring(pkg, cfg):
    """A daemon booted and started on ``cfg`` with the gateway on: its
    wiring by class name, and what its two listeners answer (the status
    view's keys and counters; the instance id is random)."""
    cfg = dataclasses.replace(cfg, store_backend="memory", port=0,
                              accelerator_type="h100-8")
    prg = pkg.daemon.Program(cfg, host="127.0.0.1",
                             runtime=pkg.fake.FakeRuntime())
    prg._discover_topology = lambda: tc.topology(pkg)
    prg.init()
    prg.start()
    try:
        status, reply = call(prg.api_server.port, "GET", B + "/gateway")
        health = call(prg.api_server.port, "GET", "/healthz")[1]["data"]
        own = call(prg.gateway_server.port, "GET", "/healthz")
        view = reply["data"]
        return {
            "status": (status, reply["code"]), "keys": sorted(view),
            "counters": view["counters"], "services": view["services"],
            "health": sorted(health["gateway"]),
            "listener": (own[0], sorted(own[1]),
                         own[1]["gateway"]["instanceId"]
                         == view["instanceId"] == prg.gateway.instance_id),
            "coordinator": type(prg.job_svc.drain_coordinator).__name__,
            "deadline": prg.job_svc.drain_deadline_s,
            "feed": type(prg.gateway_informer).__name__,
            "ephemeral": prg.gateway_server.port > 0}
    finally:
        prg.stop()


def _h100_topology():
    from tpu_docker_api_torch.scheduler.topology import HostTopology

    return HostTopology.build("h100-8")


@pytest.fixture(scope="module")
def gateway():
    from etcd_gateway import start_gateway, stop_gateway

    server, _ = start_gateway()
    yield server
    stop_gateway(server)


@pytest.mark.parametrize("lines", [
    'store_backend = "etcd"',
    "reconcile_on_start = true",
    "reconcile_interval = 5.0",
    "reconcile_full_interval_s = 30.0",
    "fanout_workers = 4",
    "store_health_fail_threshold = 5",
])
def test_reconcile_store_and_fanout_keys_load_as_jax(lines, gateway,
                                                     tmp_path):
    """The keys of the reconciler, the store's failure domain, the etcd
    store and the fan-out load as JAX's do, and a daemon boots on them."""
    addr = f"http://127.0.0.1:{gateway.server_address[1]}"
    path = _toml(tmp_path, f'{lines}\netcd_addr = "{addr}"\n'
                 'runtime_backend = "fake"\nhealth_watch_interval = 0\n')
    j = dataclasses.asdict(jconfig.load(path))
    t = dataclasses.asdict(tconfig.load(path))
    t.pop("fake_runtime_root")
    for k in PORT_DEFAULTS:
        j.pop(k), t.pop(k)
    assert t == j
    prg = Program(tconfig.load(path), host="127.0.0.1")
    prg.init()
    try:
        assert prg.fanout.workers == j["fanout_workers"]
        assert (prg.reconcile_informer is not None) == (
            j["reconcile_full_interval_s"] > 0)
        assert prg.store_health.status_view()["failThreshold"] == j[
            "store_health_fail_threshold"]
        assert prg.reconciler.reconcile()["actions"] == []
    finally:
        prg.stop()


def test_libtpu_path_has_no_gpu_counterpart(tmp_path):
    with pytest.raises(ValueError, match="libtpu_path"):
        tconfig.load(_toml(tmp_path, 'libtpu_path = "/lib/libtpu.so"'))


# -- the verify recipe against JAX's daemon -----------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(port, method, path, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path,
                 body=json.dumps(body).encode() if body is not None else None)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()))
    conn.close()
    return out


class Daemon:
    """``python -m tpu_docker_api_torch -c cfg`` in a child process."""

    def __init__(self, cfg_path, port):
        self.port = port
        self.log = open(cfg_path + ".log", "ab")  # the daemon logs a line a request
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_docker_api_torch", "-c", cfg_path,
             "--host", "127.0.0.1"], cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=self.log)
        deadline = time.monotonic() + 60
        while True:
            try:
                if call(port, "GET", "/healthz", timeout=2)[0] == 200:
                    return
            except OSError:
                pass
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.kill()
                with open(cfg_path + ".log") as f:
                    raise RuntimeError(f.read()[-2000:])
            time.sleep(0.05)

    def kill(self, sig=signal.SIGKILL):
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            self.proc.wait(timeout=30)
        self.log.close()


def _verify_flow(port, drain):
    bind = {"src": "/data/a", "dest": "/d"}
    script = [
        ("GET", "/healthz", None),
        ("POST", B + "/containers", {"imageName": "jax", "containerName": "t",
                                     "gpuCount": 4, "binds": [bind],
                                     "containerPorts": [{"containerPort": 80}]}),
        ("POST", B + "/containers/t-0/execute", {"cmd": ["python", "-c",
                                                         "print(42)"]}),
        ("PATCH", B + "/containers/t-0/gpu", {"gpuCount": 8}),
        ("GET", B + "/resources/gpus", None),
        ("POST", B + "/volumes", {"volumeName": "v", "size": "10GB"}),
        ("PATCH", B + "/volumes/v-0/size", {"size": "20GB"}),
        ("GET", B + "/containers/t/history", None),
        ("PATCH", B + "/containers/t/rollback", {"version": 0}),
        ("PATCH", B + "/volumes/v/rollback", {"version": 0,
                                              "dataFrom": "target"}),
        ("PATCH", B + "/containers/t/volume", {
            "oldBind": bind, "newBind": {"src": "/data/b", "dest": "/d"}}),
        ("GET", B + "/containers", None),
        ("GET", B + "/volumes/v/history", None),
        ("GET", B + "/queue", None),
        ("GET", B + "/dead-letters", None),
        ("DELETE", B + "/containers/t-3", {"force": True,
                                           "delEtcdInfoAndVersionRecord": True}),
        ("DELETE", B + "/volumes/v", {"delEtcdInfoAndVersionRecord": True}),
        ("GET", B + "/resources/ports", None),
        ("GET", B + "/resources/gpus", None),
        ("GET", B + "/containers", None),
    ]
    out = []
    for method, path, body in script:
        status, reply = call(port, method, path, body)
        drain()
        reply.pop("requestId", None)
        out.append((method, path, status, _norm_chips(reply)))
    return out


def _norm_chips(reply):
    """What differs between an HGX line and a v5e 2x4 host: chip ids, the
    generation and mesh, the ICI flag's meaning; counts stay."""
    data = reply.get("data")
    if isinstance(data, dict):
        if "chipIds" in data:
            data["chipIds"] = len(data["chipIds"])
        if "chips" in data:
            data["chips"] = sorted((c["used"], c["owner"])
                                   for c in data["chips"])
            for k in ("generation", "meshShape", "largestFreeBlock"):
                data.pop(k)
        data.pop("iciContiguous", None)
    return reply


def test_cli_daemon_answers_the_verify_flow_as_jax(tmp_path):
    port = _free_port()
    cfg = f"""
port = {port}
store_backend = "memory"
runtime_backend = "fake"
start_port = 40000
end_port = 40099
health_watch_interval = 0
"""
    path = _toml(tmp_path, cfg + 'accelerator_type = "h100-8"\n', "port")
    d = Daemon(path, port)
    try:
        def drain():
            # the replacement's copy runs on the daemon's queue: wait for
            # its journal to empty (the queue's own view), not a clock
            deadline = time.monotonic() + 30
            while call(port, "GET", B + "/queue")[1]["data"]["journal"][
                    "entries"]:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        got = _verify_flow(port, drain)
    finally:
        d.kill(signal.SIGTERM)
    jpath = _toml(tmp_path, cfg.replace(f"port = {port}", "port = 0")
                  + 'accelerator_type = "v5e-8"\n', "jax")
    prg = jdaemon.Program(jconfig.load(jpath), host="127.0.0.1")
    prg.init()
    prg.start()
    try:
        want = _verify_flow(prg.api_server.port, prg.wq.drain)
    finally:
        prg.stop()
    # the store-health views differ only in their clock and op counts;
    # the admission block is JAX's, key for key
    jhealth, thealth = want[0][3]["data"], got[0][3]["data"]
    assert set(jhealth) == set(thealth)
    assert thealth["admission"] == jhealth["admission"] == {
        "enabled": False, "depth": 0, "preemptionsTotal": 0,
        "partialPreemptionsTotal": 0, "admissionsTotal": 0}
    for health in (jhealth, thealth):
        for k in ("lastTransitionTs", "opsOk"):
            health["storeHealth"].pop(k)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[:2]
    assert got[1][3]["data"] == {"name": "t-0", "chipIds": 4}
    assert got[-2][3]["data"]["chips"] == [(False, "")] * 8


# -- crash and restart on SQLite ----------------------------------------------


def _boot(tmp_path, start=True):
    """A Program over the same SQLite file and fake-runtime root a dead one
    used; ``start=False`` leaves its work queue unstarted, so what a dying
    flow journaled stays pending (tests/test_chaos.py's crash model)."""
    cfg = tconfig.Config(store_backend="sqlite", runtime_backend="fake",
                         health_watch_interval=0, end_port=40099)
    prg = Program(cfg, host="127.0.0.1",
                  kv=SqliteKV(str(tmp_path / "state.db")),
                  runtime=FakeRuntime(root=str(tmp_path / "rt"),
                                      allow_exec=True, persist=True))
    prg.init()
    if start:
        prg.start()
    return prg


def _seed_volume(prg, data):
    prg.volume_svc.create_volume(VolumeCreate(volume_name="v", size="1GB"))
    with open(os.path.join(prg.runtime.volume_data_dir("v-0"), "blob"),
              "wb") as f:
        f.write(data)


@pytest.mark.parametrize("label", ["txn.after_apply", "queue.claim",
                                   "queue.exec"])
def test_crash_mid_resize_converges_on_the_boot_replay(label, tmp_path):
    """The resize's copy record is durable before the daemon dies; the
    next daemon replays the journal at boot and the data lands in v-1
    exactly once, the GPU grant and its refusal survive too."""
    data = np.random.default_rng(3).bytes(1 << 20)
    dead = _boot(tmp_path, start=False)
    dead.container_svc.run_container(ContainerRun(
        image_name="i", container_name="g", chip_count=8))
    _seed_volume(dead, data)
    with armed(label):
        with pytest.raises(SimulatedCrash):
            # txn.after_apply: the new version's state is durable, the call
            # never returns; queue.*: the resize returns, then the dead
            # daemon's queue dies running its record
            dead.volume_svc.patch_volume_size("v", VolumeSize("2GB"))
            dead.wq.replay_journal(include_local=True)
    dead.kv.close()

    prg = _boot(tmp_path)
    try:
        with open(os.path.join(prg.runtime.volume_data_dir("v-1"), "blob"),
                  "rb") as f:
            assert f.read() == data
        assert prg.wq.stats()["journal"]["entries"] == 0
        assert prg.wq.dead_letter_view() == []
        assert prg.chip_scheduler.owned_chips("g") == list(range(8))
        with pytest.raises(Exception) as exc:
            prg.container_svc.run_container(ContainerRun(
                image_name="i", container_name="h", chip_count=1))
        assert type(exc.value).__name__ == "ChipNotEnough"
        assert [v["name"] for v in prg.volume_svc.get_volume_history("v")[
            "versions"]] == ["v-0", "v-1"]
    finally:
        prg.stop()


def test_sigkill_and_restart_keeps_every_acknowledged_write(tmp_path):
    port = _free_port()
    path = _toml(tmp_path, f"""
port = {port}
store_backend = "sqlite"
sqlite_path = "{tmp_path / 'state.db'}"
runtime_backend = "fake"
fake_runtime_root = "{tmp_path / 'rt'}"
accelerator_type = "h100-8"
start_port = 41000
end_port = 41009
health_watch_interval = 0
""")
    data = np.random.default_rng(5).bytes(1 << 20)
    d = Daemon(path, port)
    try:
        assert call(port, "POST", B + "/containers", {
            "imageName": "i", "containerName": "g", "gpuCount": 1,
            "containerPorts": [{"containerPort": 80}]})[1]["code"] == 200
        for i in range(3):
            assert call(port, "POST", B + "/volumes", {
                "volumeName": f"v{i}", "size": "1GB"})[1]["code"] == 200
            info = call(port, "GET", B + f"/volumes/v{i}")[1]["data"]
            with open(os.path.join(info["runtime"]["mountpoint"], "blob"),
                      "wb") as f:
                f.write(data)
        for i in range(3):
            assert call(port, "PATCH", B + f"/volumes/v{i}-0/size",
                        {"size": "2GB"})[1]["code"] == 200
        before = call(port, "GET", B + "/resources/ports")[1]["data"]
    finally:
        d.kill()  # SIGKILL right after the acknowledged resizes
    d = Daemon(path, port)
    try:
        assert call(port, "GET", B + "/resources/ports")[1]["data"] == before
        gpus = call(port, "GET", B + "/resources/gpus")[1]["data"]
        assert [c["owner"] for c in gpus["chips"]] == ["g"] + [""] * 7
        assert call(port, "POST", B + "/containers", {
            "imageName": "i", "containerName": "h",
            "gpuCount": 8})[1]["code"] == 10601
        q = call(port, "GET", B + "/queue")[1]["data"]
        assert q["journal"]["entries"] == 0, q
        assert call(port, "GET", B + "/dead-letters")[1]["data"] == []
        for i in range(3):
            info = call(port, "GET", B + f"/volumes/v{i}")[1]["data"]
            assert info["state"]["volume_name"] == f"v{i}-1"
            with open(os.path.join(info["runtime"]["mountpoint"], "blob"),
                      "rb") as f:
                assert f.read() == data
        state = call(port, "GET", B + "/containers/g-0")[1]["data"]
        assert state["runtime"]["running"] is True
        assert state["state"]["spec"]["port_bindings"][0]["host_port"] == 41000
    finally:
        d.kill(signal.SIGTERM)


# -- the GPU-less container ---------------------------------------------------


def test_gpuless_exec_sees_no_gpu_whatever_the_host_env(monkeypatch, tmp_path):
    """A ``gpuCount: 0`` container's exec gets an empty
    ``CUDA_VISIBLE_DEVICES`` (CUDA then shows no device), not the daemon's
    own; a granted one gets exactly its UUID."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-planted")
    cfg = tconfig.Config(port=0, runtime_backend="fake",
                         health_watch_interval=0,
                         fake_runtime_root=str(tmp_path / "rt"))
    prg = Program(cfg, host="127.0.0.1")
    prg.init()
    prg.start()
    probe = [sys.executable, "-c", "import os; print(repr(os.environ.get("
             "'CUDA_VISIBLE_DEVICES')))"]
    try:
        port = prg.api_server.port
        for name, n in (("none", 0), ("one", 1)):
            assert call(port, "POST", B + "/containers", {
                "imageName": "i", "containerName": name,
                "gpuCount": n})[1]["code"] == 200
        outs = [call(port, "POST", B + f"/containers/{name}/execute",
                     {"cmd": probe})[1]["data"]["stdout"].strip()
                for name in ("none", "one")]
    finally:
        prg.stop()
    assert outs == ["''", repr("GPU-00000000-0000-0000-0000-000000000000")]


# -- topology discovery -------------------------------------------------------


def test_topology_from_the_sidecar_else_the_config(tmp_path, monkeypatch):
    """``detect_tpu_addr`` seeds the GPU scheduler from the gpu-detect
    sidecar's reply (a standard-library GET: the port does not import
    ``requests``); without it and without NVML, ``accelerator_type``
    synthesizes the host. A sidecar that answers an error fails the boot."""
    from tpu_docker_api_torch.scheduler.topology import HostTopology
    from tpu_docker_api_torch.telemetry.sidecar import SidecarServer

    srv = SidecarServer(host="127.0.0.1", port=0, fake="h100-4")
    srv.start()
    try:
        prg = Program(tconfig.Config(
            health_watch_interval=0, runtime_backend="fake",
            detect_tpu_addr=f"http://127.0.0.1:{srv.port}/"))
        prg.init()
        assert prg.chip_scheduler.topology == HostTopology.build("h100-4")
        prg.stop()
        bad = Program(tconfig.Config(
            health_watch_interval=0, runtime_backend="fake",
            detect_tpu_addr=f"http://127.0.0.1:{srv.port}/nowhere"))
        with pytest.raises(OSError, match="HTTP 404"):
            bad.init()
        bad.stop()
    finally:
        srv.close()
    from tpu_docker_api_torch.telemetry import probe

    monkeypatch.setattr(probe, "probe_local_topology", lambda: None)  # no NVML
    prg = Program(tconfig.Config(health_watch_interval=0,
                                 runtime_backend="fake",
                                 accelerator_type="h100-2"))
    prg.init()
    assert prg.chip_scheduler.status()["totalChips"] == 2
    prg.stop()
