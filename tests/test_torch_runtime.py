"""The port's runtimes against the JAX package's on the CPU:
``runtime/fake.py`` op scripts give JAX's results and call log;
``runtime/spec.py`` ``render_gpu_attachment`` renders the granted GPUs'
UUIDs; ``runtime/docker_http.py`` against ``runtime/fake_engine.py`` (a
Docker Engine on a unix socket) sends JAX's create body but for the
device attachment, which is the reference's nvidia ``DeviceRequests``,
and reads the UUIDs back on inspect. Then the port's copies of the JAX
adapter's transport, retry, pool and demux tests."""

import dataclasses
import socket
import threading

import numpy as np
import pytest

from tpu_docker_api import errors as jerrors
from tpu_docker_api.runtime import docker_http as jdocker
from tpu_docker_api.runtime import fake as jfake
from tpu_docker_api.runtime import spec as jspec
from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime import fake as tfake
from tpu_docker_api_torch.runtime import open_runtime
from tpu_docker_api_torch.runtime import spec as tspec
from tpu_docker_api_torch.runtime.docker_http import (
    DockerRuntime,
    _demux_docker_stream,
)
from tpu_docker_api_torch.runtime.fake_engine import FakeEngine, mux_frames
from tpu_docker_api_torch.runtime.spec import (
    ContainerSpec,
    DeviceMount,
    PortBinding,
    render_gpu_attachment,
)
from tpu_docker_api_torch.scheduler.topology import HostTopology, fake_uuid

U0, U1 = fake_uuid(0), fake_uuid(1)
#: the reference's attachment (service/container.go:581-588)
REFERENCE_REQUEST = [{"Driver": "nvidia", "Count": 0, "DeviceIDs": [U0, U1],
                      "Capabilities": [["gpu"]]}]


@pytest.fixture()
def engine(tmp_path):
    eng = FakeEngine(str(tmp_path / "docker.sock"))
    try:
        yield eng
    finally:
        eng.close()


@pytest.fixture()
def rt(engine):
    return DockerRuntime(engine.docker_host)


def make_spec(name="t0", mod=tspec) -> ContainerSpec:
    """The JAX adapter test's golden spec; the port's carries the two
    GPUs' UUIDs in place of the /dev/accel0 mount."""
    spec = mod.ContainerSpec(
        name=name, image="jax:latest", cmd=["python", "-c", "1"],
        env=["A=1"], binds=["v0:/data"],
        port_bindings=[mod.PortBinding(8080, 40001)],
        chip_ids=[0, 1], ici_contiguous=True)
    if mod is tspec:
        spec.gpu_uuids = [U0, U1]
    else:
        spec.devices = [mod.DeviceMount("/dev/accel0", "/dev/accel0")]
    return spec


# ------------------------------------------------------------- fake runtime


def _fake_script(seed: int, steps: int = 50) -> list[tuple]:
    rng = np.random.default_rng(seed)
    names = ["c0", "c1", "c2"]
    kinds = ["create", "start", "stop", "restart", "crash", "remove",
             "remove_force", "inspect", "exists", "list", "exec", "commit",
             "vcreate", "vremove", "vinspect", "vexists"]
    return [(kinds[rng.integers(len(kinds))], names[rng.integers(3)])
            for _ in range(steps)]


def _run_fake(mod_fake, mod_spec, script) -> list:
    rt = mod_fake.FakeRuntime()
    out = []
    for kind, name in script:
        try:
            if kind == "create":
                res = len(rt.container_create(
                    mod_spec.ContainerSpec(name=name, image="img",
                                           env=["A=1"])))
            elif kind == "start":
                res = rt.container_start(name)
            elif kind == "stop":
                res = rt.container_stop(name)
            elif kind == "restart":
                res = rt.container_restart(name)
            elif kind == "crash":
                res = rt.crash_container(name, exit_code=9)
            elif kind == "remove":
                res = rt.container_remove(name)
            elif kind == "remove_force":
                res = rt.container_remove(name, force=True)
            elif kind == "inspect":
                info = rt.container_inspect(name)
                res = (info.running, info.status, info.exit_code,
                       bool(info.pid), info.spec.env)
            elif kind == "exists":
                res = rt.container_exists(name)
            elif kind == "list":
                res = rt.container_list()
            elif kind == "exec":
                res = dataclasses.astuple(rt.container_exec(name, ["ls"]))
            elif kind == "commit":
                res = rt.container_commit(name, "snap:1").startswith(
                    "sha256:")
            elif kind == "vcreate":
                res = rt.volume_create(name, {"size": "1GB"}).driver_opts
            elif kind == "vremove":
                res = rt.volume_remove(name)
            elif kind == "vinspect":
                res = rt.volume_inspect(name).mountpoint.endswith("_data")
            else:
                res = rt.volume_exists(name)
        except Exception as e:  # noqa: BLE001 — the class is the outcome
            res = (type(e).__name__, str(e))
        out.append(res)
    out.append(list(rt.calls))
    rt.close()
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fake_runtime_scripts_match_jax(seed):
    script = _fake_script(seed)
    want = _run_fake(jfake, jspec, script)
    assert _run_fake(tfake, tspec, script) == want
    assert any(isinstance(r, tuple) and r and r[0] == "ContainerNotExist"
               for r in want)


def test_fake_exec_runs_with_the_rendered_env(tmp_path):
    """With ``allow_exec``, the child sees the spec's env: a granted
    container's process sees only its GPUs."""
    rt = tfake.FakeRuntime(root=str(tmp_path), allow_exec=True)
    spec = render_gpu_attachment(ContainerSpec(name="g", image="i"), [1],
                                 HostTopology.build("h100-8"))
    rt.container_create(spec)
    rt.container_start("g")
    res = rt.container_exec("g", ["sh", "-c", "echo $CUDA_VISIBLE_DEVICES"])
    assert (res.exit_code, res.output.strip()) == (0, U1)
    rt.container_stop("g")
    with pytest.raises(errors.ApiError, match="not running"):
        rt.container_exec("g", ["true"])


# ------------------------------------------------------------- attachment


def test_render_gpu_attachment_renders_the_granted_uuids():
    topo = HostTopology.build("h100-8")
    spec = ContainerSpec(name="t", image="i", env=["A=1", "B=2"])
    render_gpu_attachment(spec, [3, 1], topo, ici_contiguous=False)
    assert spec.chip_ids == [1, 3]
    assert spec.gpu_uuids == [fake_uuid(1), fake_uuid(3)]
    assert spec.env == ["A=1", "B=2",
                        f"CUDA_VISIBLE_DEVICES={fake_uuid(1)},{fake_uuid(3)}"]
    assert not spec.ici_contiguous
    assert spec.devices == [] and spec.binds == []
    assert not any(e.startswith("TPU_") for e in spec.env)


def test_re_render_does_not_stack_and_zero_gpus_renders_nothing():
    topo = HostTopology.build("h100-8")
    spec = ContainerSpec(name="t", image="i", env=["A=1"])
    render_gpu_attachment(spec, [0, 1], topo)
    render_gpu_attachment(spec, [5], topo)
    assert spec.env == ["A=1", f"CUDA_VISIBLE_DEVICES={fake_uuid(5)}"]
    render_gpu_attachment(spec, [], topo)
    assert (spec.env, spec.chip_ids, spec.gpu_uuids) == (["A=1"], [], [])


def test_render_refuses_a_gpu_without_uuid():
    bare = HostTopology.from_chips(HostTopology.build("h100-2").generation,
                                   {0: (0, 0, 0), 1: (1, 0, 0)})
    spec = ContainerSpec(name="t", image="i")
    with pytest.raises(errors.TopologyUnknown):
        render_gpu_attachment(spec, [1], bare)


def test_spec_round_trips_and_reads_jax_payloads():
    spec = render_gpu_attachment(make_spec(), [0, 1],
                                 HostTopology.build("h100-8"))
    spec.devices = [DeviceMount("/dev/fuse", "/dev/fuse", "rw")]
    assert ContainerSpec.from_dict(spec.to_dict()) == spec
    # a JAX-written payload (no gpu_uuids) reads with none
    jdict = make_spec(mod=jspec).to_dict()
    got = ContainerSpec.from_dict(jdict)
    assert got.gpu_uuids == [] and got.chip_ids == [0, 1]
    assert {k: v for k, v in got.to_dict().items() if k != "gpu_uuids"} \
        == jdict


# ------------------------------------------------------------- docker runtime


def _create_body(runtime_cls, engine, spec) -> dict:
    runtime_cls(engine.docker_host).container_create(spec)
    method, path, params, body = engine.last()
    assert (method, path, params) == ("POST", "/containers/create",
                                      {"name": spec.name})
    return body


def test_create_body_is_jax_golden_request_but_for_device_requests(engine):
    want = _create_body(jdocker.DockerRuntime, engine, make_spec("j",
                                                                  jspec))
    got = _create_body(DockerRuntime, engine, make_spec("t"))
    assert got["HostConfig"].pop("DeviceRequests") == REFERENCE_REQUEST
    assert want["HostConfig"].pop("Devices") == [{
        "PathOnHost": "/dev/accel0", "PathInContainer": "/dev/accel0",
        "CgroupPermissions": "rwm"}]
    assert got["HostConfig"].pop("Devices") == []
    assert got == want
    assert got["Labels"] == {"tpu-docker-api.chips": "0,1",
                             "tpu-docker-api.ici": "1"}


def test_zero_gpus_sends_no_device_requests(engine):
    cardless = [ContainerSpec(name=f"z{i}", image="jax:latest")
                for i in range(2)]
    cardless[1].devices = [DeviceMount("/dev/fuse", "/dev/fuse")]
    for spec in cardless:
        body = _create_body(DockerRuntime, engine, spec)
        assert "DeviceRequests" not in body["HostConfig"]
        jbody = _create_body(jdocker.DockerRuntime, engine, jspec.ContainerSpec(
            name="j" + spec.name, image="jax:latest",
            devices=[jspec.DeviceMount(**dataclasses.asdict(d))
                     for d in spec.devices]))
        assert body == jbody


def test_inspect_round_trips_the_uuids(rt, engine):
    spec = make_spec()
    rt.container_create(spec)
    rt.container_start("t0")
    got = rt.container_inspect("t0").spec
    assert got == spec
    assert got.gpu_uuids == [U0, U1]
    # DeviceRequests of other drivers carry no GPU UUIDs
    engine.containers["t0"]["HostConfig"]["DeviceRequests"].append(
        {"Driver": "other", "DeviceIDs": ["x"]})
    assert rt.container_inspect("t0").spec.gpu_uuids == [U0, U1]


def test_open_runtime_backends(engine):
    assert isinstance(open_runtime("fake"), tfake.FakeRuntime)
    assert isinstance(open_runtime("docker", docker_host=engine.docker_host),
                      DockerRuntime)
    with pytest.raises(ValueError):
        open_runtime("podman")


# The port's copies of tests/test_docker_http.py's adapter tests.


class TestTransport:
    def test_init_pings(self, engine):
        DockerRuntime(engine.docker_host)
        assert engine.last() == ("GET", "/_ping", {}, None)

    def test_tcp_host_rejected(self):
        with pytest.raises(ValueError):
            DockerRuntime("tcp://10.0.0.1:2375")


class TestContainerFlows:
    def test_create_unknown_image_maps_404(self, rt):
        spec = make_spec()
        spec.image = "missing:latest"
        with pytest.raises(errors.ApiError, match="missing:latest not found"):
            rt.container_create(spec)

    def test_start_stop_restart_and_304(self, rt, engine):
        rt.container_create(make_spec())
        rt.container_start("t0")
        assert engine.last()[:2] == ("POST", "/containers/t0/start")
        rt.container_start("t0")          # already running -> 304, no raise
        rt.container_stop("t0", timeout_s=7)
        assert engine.last() == ("POST", "/containers/t0/stop", {"t": "7"},
                                 None)
        rt.container_stop("t0")           # already stopped -> 304, no raise
        rt.container_restart("t0")
        assert rt.container_inspect("t0").running

    def test_ops_on_missing_container_raise_typed(self, rt):
        for op in (rt.container_start, rt.container_stop,
                   rt.container_restart, rt.container_inspect):
            with pytest.raises(errors.ContainerNotExist):
                op("ghost")
        with pytest.raises(errors.ContainerNotExist):
            rt.container_remove("ghost")

    def test_inspect_fields(self, rt):
        rt.container_create(make_spec())
        rt.container_start("t0")
        info = rt.container_inspect("t0")
        assert info.id == "id-t0" and info.running and info.pid == 4242
        assert info.data_dir == "/var/lib/docker/overlay2/id-t0/merged"

    def test_exists_and_list(self, rt):
        assert not rt.container_exists("t0")
        rt.container_create(make_spec())
        rt.container_create(make_spec("t1"))
        assert rt.container_exists("t0")
        assert rt.container_list() == ["t0", "t1"]

    def test_remove(self, rt, engine):
        rt.container_create(make_spec())
        rt.container_remove("t0", force=True)
        assert engine.last() == ("DELETE", "/containers/t0",
                                 {"force": "true"}, None)
        assert not rt.container_exists("t0")

    def test_exec_demux_and_exit_code(self, rt, engine):
        rt.container_create(make_spec())
        res = rt.container_exec("t0", ["ls", "-l"], workdir="/srv")
        assert res.output == "out-line-1\nerr-line\nout-line-2\n"
        assert res.exit_code == 3
        create = next(r for r in engine.requests
                      if r[1] == "/containers/t0/exec")
        assert create[3] == {"AttachStdout": True, "AttachStderr": True,
                             "Cmd": ["ls", "-l"], "WorkingDir": "/srv"}
        start = next(r for r in engine.requests if r[1].endswith("/start")
                     and r[1].startswith("/exec/"))
        assert start[3] == {"Detach": False, "Tty": False}

    def test_exec_missing_container(self, rt):
        with pytest.raises(errors.ContainerNotExist):
            rt.container_exec("ghost", ["true"])

    def test_commit(self, rt, engine):
        rt.container_create(make_spec())
        assert rt.container_commit("t0", "snap:v2") == "sha256:t0-snap-v2"
        assert engine.last() == ("POST", "/commit",
                                 {"container": "t0", "repo": "snap",
                                  "tag": "v2"}, None)
        assert rt.container_commit("t0", "snap") == "sha256:t0-snap-latest"


class TestVolumeFlows:
    def test_create_inspect_remove(self, rt, engine):
        vol = rt.volume_create("v0", {"size": "10GB"})
        assert engine.last() == ("POST", "/volumes/create", {}, {
            "Name": "v0", "Driver": "local", "DriverOpts": {"size": "10GB"}})
        assert vol.mountpoint == "/var/lib/docker/volumes/v0/_data"
        assert rt.volume_exists("v0") and rt.volume_inspect("v0") == vol
        rt.volume_remove("v0", force=True)
        assert engine.last() == ("DELETE", "/volumes/v0",
                                 {"force": "true"}, None)
        assert not rt.volume_exists("v0")

    def test_missing_volume_typed_errors(self, rt):
        with pytest.raises(errors.VolumeNotExist):
            rt.volume_inspect("ghost")
        with pytest.raises(errors.VolumeNotExist):
            rt.volume_remove("ghost")


@pytest.mark.parametrize("data", [
    mux_frames((1, b"abc"), (2, b"DEF")),
    mux_frames((1, b"abc")) + b"\x01\x00\x00",
    b"raw tty bytes",
    mux_frames((1, b"abc"), (2, b"DEF")) + b"\x07garbage!",
    b"",
    mux_frames((2, b"")) + mux_frames((1, b"x" * 70000)),
])
def test_demux_matches_jax(data):
    assert _demux_docker_stream(data) == jdocker._demux_docker_stream(data)


class TestStopTimeout:
    def _capture(self, rt):
        seen = {}

        def fake_request(method, path, params=None, body=None,
                         timeout=60.0, retry=None):
            seen.update(method=method, path=path, params=params,
                        timeout=timeout)
            return 204, b""

        rt._request = fake_request
        return seen

    def test_long_grace_extends_http_timeout(self, rt):
        seen = self._capture(rt)
        rt.container_stop("t0", timeout_s=120)
        assert seen["params"] == {"t": 120}
        assert seen["timeout"] >= 150

    def test_default_grace_keeps_default_timeout(self, rt):
        seen = self._capture(rt)
        rt.container_stop("t0")
        assert seen["timeout"] == 60.0


class TestTransientRetry:
    def _flaky_connect(self, rt, exc, fail_times):
        real_open = type(rt)._open_connection
        counter = {"n": 0}

        def flaky(timeout):
            counter["n"] += 1
            if counter["n"] <= fail_times:
                raise exc
            return real_open(rt, timeout)

        rt._pool.clear()
        rt._open_connection = flaky
        rt.RETRY_BACKOFF_S = 0.001
        return counter

    def test_get_retries_connection_refused(self, rt, engine):
        rt.container_create(make_spec())
        counter = self._flaky_connect(rt, ConnectionRefusedError(), 2)
        assert rt.container_inspect("t0").name == "t0"
        assert counter["n"] == 3

    def test_get_exhausted_retries_raise(self, rt):
        self._flaky_connect(rt, ConnectionResetError(), 99)
        with pytest.raises(ConnectionResetError):
            rt.container_inspect("t0")

    def test_post_is_one_shot(self, rt, engine):
        rt.container_create(make_spec())
        counter = self._flaky_connect(rt, ConnectionResetError(), 1)
        with pytest.raises(ConnectionResetError):
            rt.container_start("t0")
        assert counter["n"] == 1


def test_inspect_status_round_trips(rt, engine):
    rt.container_create(make_spec())
    engine.containers["t0"]["State"]["Status"] = "created"
    assert rt.container_inspect("t0").status == "created"
    rt.container_start("t0")
    engine.containers["t0"]["State"]["Status"] = "running"
    assert rt.container_inspect("t0").status == "running"


class TestConnectionPool:
    def test_requests_reuse_one_keep_alive_connection(self, rt):
        assert rt.pool_view()["created"] == 1
        rt.container_list()
        rt.container_list()
        view = rt.pool_view()
        assert view["created"] == 1 and view["reused"] >= 2
        assert view["idle"] == 1 and view["inUse"] == 0

    def test_posts_ride_the_pool_too(self, rt, engine):
        rt.container_create(make_spec())
        rt.container_start("t0")
        assert rt.pool_view()["created"] == 1

    def test_stale_socket_detected_and_replaced(self, rt):
        rt.container_list()
        rt._pool._idle[0].sock.shutdown(socket.SHUT_RDWR)
        assert rt.container_list() == []
        view = rt.pool_view()
        assert view["staleDropped"] == 1 and view["created"] == 2

    def test_closed_fd_counts_as_stale(self, rt):
        rt.container_list()
        rt._pool._idle[0].sock.close()
        assert rt.container_list() == []
        assert rt.pool_view()["staleDropped"] == 1

    def test_idle_retention_is_bounded(self, rt):
        conns = [rt._pool.acquire(rt._open_connection, 5.0)[0]
                 for _ in range(7)]
        for c in conns:
            rt._pool.release(c, reusable=True)
        view = rt.pool_view()
        assert view["idle"] <= view["size"] == 4 and view["inUse"] == 0

    def test_close_drains_the_pool(self, rt):
        rt.container_list()
        rt.close()
        assert rt.pool_view()["idle"] == 0

    def test_stale_socket_storm_cannot_exhaust_pool(self, rt):
        """Every idle connection dies at once; a burst of concurrent
        requests drops each corpse once, surfaces no error, dials a
        number of replacements bounded by its concurrency and leaks no
        in-use slot."""
        pool = rt._pool
        conns = [pool.acquire(rt._open_connection, 5.0)[0]
                 for _ in range(pool.size)]
        for c in conns:
            c.connect()
            pool.release(c, reusable=True)
        for c in list(pool._idle):
            c.sock.shutdown(socket.SHUT_RDWR)
        created_before = rt.pool_view()["created"]
        errs: list[Exception] = []

        def worker():
            try:
                for _ in range(5):
                    rt.container_list()
            except Exception as e:  # noqa: BLE001 — collected for assert
                errs.append(e)

        workers = [threading.Thread(target=worker) for _ in range(8)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in workers)
        assert errs == []
        view = rt.pool_view()
        assert view["staleDropped"] == pool.size and view["inUse"] == 0
        assert view["idle"] <= view["size"]
        assert view["created"] - created_before <= 8


def test_port_errors_are_the_port_classes(rt):
    """The adapter raises the port's error classes, never JAX's."""
    with pytest.raises(errors.ContainerNotExist) as exc:
        rt.container_inspect("ghost")
    assert not isinstance(exc.value, jerrors.ApiError)
    assert isinstance(make_spec(), ContainerSpec)
    assert PortBinding(1, 2).protocol == "tcp"


def test_unix_connect_waits_for_a_full_accept_backlog(tmp_path):
    """A unix socket whose accept backlog is full answers a timed
    ``connect`` with EAGAIN at once, where TCP would wait: the
    connection waits for a slot within its timeout instead of raising
    BlockingIOError (the stale-socket storm's intermittent failure)."""
    from tpu_docker_api_torch.runtime.docker_http import _UnixHTTPConnection

    path = str(tmp_path / "busy.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(0)
    held = []
    for _ in range(8):  # fill the backlog: the kernel queues a few
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.setblocking(False)
        try:
            c.connect(path)
        except BlockingIOError:
            c.close()
            break
        held.append(c)
    conn = _UnixHTTPConnection(path, timeout=5.0)
    errs: list[Exception] = []

    def dial():
        try:
            conn.connect()
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    t = threading.Thread(target=dial)
    t.start()
    t.join(0.3)  # with the backlog full, the dialer must still be waiting
    assert errs == [] and t.is_alive()
    accepted = []
    while t.is_alive():  # drain the queue: a slot opens for the dialer
        srv.settimeout(0.05)
        try:
            accepted.append(srv.accept()[0])
        except socket.timeout:
            pass
    t.join()
    assert errs == [] and conn.sock is not None
    for s in held + accepted + [conn.sock, srv]:
        s.close()
