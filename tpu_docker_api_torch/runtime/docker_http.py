"""Docker Engine runtime over the unix-socket REST API.

The reference drives dockerd through the Go SDK (docker/client.go:11-14). We
speak the Engine HTTP API directly (stdlib http.client over the unix socket)
— no docker-py dependency — implementing exactly the endpoints the service
layer needs.

The port's counterpart of ``tpu_docker_api/runtime/docker_http.py``: the
pool, retries, demux and stop timeout are the JAX package's. What differs
is the device attachment: a GPU grant is the reference's
``HostConfig.DeviceRequests=[{"Driver": "nvidia", "DeviceIDs": [UUIDs],
"Capabilities": [["gpu"]]}]`` (service/container.go:581-588), which the
NVIDIA container toolkit turns into device nodes and driver libraries, in
place of the JAX package's ``/dev/accel*`` ``Devices``; inspect reads the
UUIDs back from it, as the reference's containerDeviceRequestsDeviceIDs
does (service/container.go:551-561).
"""

from __future__ import annotations

import http.client
import json
import select
import socket
import struct
import threading
import time
import urllib.parse

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import (
    ContainerInfo,
    ContainerRuntime,
    ExecResult,
    VolumeInfo,
)
from tpu_docker_api_torch.runtime.spec import ContainerSpec, DeviceMount, PortBinding

API_VERSION = "v1.41"  # negotiated floor; reference SDK pins v24 ~ API 1.43


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 60.0) -> None:
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        # a unix socket whose accept backlog is full answers a timed
        # connect with EAGAIN at once, where TCP would wait: wait for a
        # slot within the timeout, as a TCP connect does
        deadline = time.monotonic() + (self.timeout or 0.0)
        while True:
            try:
                sock.connect(self._socket_path)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    sock.close()
                    raise
                time.sleep(0.001)
        self.sock = sock


class _ConnectionPool:
    """Thread-safe keep-alive pool of unix-socket connections to ONE engine.

    Fan-out made the transport the bottleneck: every request used to pay a
    fresh ``connect()`` (docker_http.py pre-pool), and N concurrent gang
    calls would pay N of them per batch. The pool retains up to ``size``
    idle keep-alive connections; concurrent demand beyond that still gets
    fresh connections (blocking callers on a full pool could deadlock a
    fan-out batch against itself) — only idle *retention* is bounded, so a
    burst never leaves an unbounded socket pile behind.

    Staleness: a pooled connection can die while idle (dockerd restart).
    ``acquire`` drops any idle connection whose socket is readable — on a
    request-quiet keep-alive connection, readable means EOF or protocol
    junk, never a valid state — so reuse of an obviously-dead socket is
    avoided for every method. A connection that *still* fails mid-request
    is the caller's retry-policy problem: idempotent GETs retry on a
    fresh connection, non-idempotent requests stay one-shot.
    """

    def __init__(self, size: int = 4) -> None:
        self.size = max(0, int(size))
        self._mu = threading.Lock()
        self._idle: list[_UnixHTTPConnection] = []
        self._in_use = 0
        self._created = 0
        self._reused = 0
        self._stale_dropped = 0
        self._closed = False

    @staticmethod
    def _stale(conn: _UnixHTTPConnection) -> bool:
        sock = conn.sock
        if sock is None:
            return True
        try:
            readable, _, _ = select.select([sock], [], [], 0)
        except (OSError, ValueError):
            return True
        return bool(readable)

    def acquire(self, open_fn, timeout: float
                ) -> tuple[_UnixHTTPConnection, bool]:
        """Return (connection, reused). ``open_fn(timeout)`` creates a
        fresh one when no healthy idle connection exists."""
        while True:
            with self._mu:
                if not self._idle:
                    break
                conn = self._idle.pop()
                if self._stale(conn):
                    self._stale_dropped += 1
                else:
                    self._in_use += 1
                    self._reused += 1
                    conn.timeout = timeout
                    if conn.sock is not None:
                        conn.sock.settimeout(timeout)
                    return conn, True
            conn.close()  # stale: closed outside the lock
        conn = open_fn(timeout)
        with self._mu:
            self._created += 1
            self._in_use += 1
        return conn, False

    def release(self, conn: _UnixHTTPConnection, reusable: bool) -> None:
        with self._mu:
            self._in_use = max(0, self._in_use - 1)
            if (reusable and not self._closed
                    and len(self._idle) < self.size):
                self._idle.append(conn)
                return
        conn.close()

    def clear(self) -> None:
        """Drop every idle connection (pool stays usable) — the 'dockerd
        restarted, start fresh' hook."""
        with self._mu:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()

    def close_all(self) -> None:
        with self._mu:
            idle, self._idle = self._idle, []
            self._closed = True
        for conn in idle:
            conn.close()

    def view(self) -> dict:
        with self._mu:
            return {
                "size": self.size,
                "idle": len(self._idle),
                "inUse": self._in_use,
                "created": self._created,
                "reused": self._reused,
                "staleDropped": self._stale_dropped,
            }


class DockerRuntime(ContainerRuntime):
    def __init__(self, docker_host: str = "unix:///var/run/docker.sock",
                 pool_size: int = 4) -> None:
        if not docker_host.startswith("unix://"):
            raise ValueError(f"only unix:// docker hosts supported, got {docker_host}")
        self._socket_path = docker_host[len("unix://"):]
        self._pool = _ConnectionPool(pool_size)
        self.ping()

    # -- transport ---------------------------------------------------------------

    #: transient-connection retry for idempotent requests (a dockerd restart
    #: mid-poll refuses/resets connections for a moment; GETs can just try
    #: again, non-idempotent POSTs stay one-shot — a second "create" or
    #: "stop" could double-apply)
    RETRY_ATTEMPTS = 3
    RETRY_BACKOFF_S = 0.05
    _RETRYABLE = (ConnectionRefusedError, ConnectionResetError,
                  BrokenPipeError, FileNotFoundError)

    def _open_connection(self, timeout: float) -> _UnixHTTPConnection:
        return _UnixHTTPConnection(self._socket_path, timeout=timeout)

    def _request(
        self,
        method: str,
        path: str,
        params: dict | None = None,
        body: dict | None = None,
        timeout: float = 60.0,
        retry: bool | None = None,
    ) -> tuple[int, bytes]:
        """One Engine request over the keep-alive pool.

        Retry policy is unchanged from the pre-pool transport: idempotent
        GETs retry transient connection failures with backoff, everything
        else is one-shot (a blindly repeated create/stop could
        double-apply). The pool only changes WHERE the socket comes from:
        a healthy idle keep-alive connection when one exists, a fresh
        ``connect()`` otherwise. Any connection that fails mid-request is
        discarded, so a GET's retry always reconnects — never replays on
        the socket that just broke."""
        if retry is None:
            retry = method == "GET"
        attempts = self.RETRY_ATTEMPTS if retry else 1
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        for attempt in range(attempts):
            try:
                conn, _reused = self._pool.acquire(
                    self._open_connection, timeout)
                try:
                    conn.request(method, f"/{API_VERSION}{path}{qs}",
                                 body=payload, headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                except BaseException:
                    # poisoned: an interrupted request/response leaves the
                    # connection state unusable for keep-alive
                    self._pool.release(conn, reusable=False)
                    raise
                self._pool.release(conn, reusable=not resp.will_close)
                return resp.status, data
            except self._RETRYABLE:
                if attempt == attempts - 1:
                    raise
                time.sleep(self.RETRY_BACKOFF_S * (2 ** attempt))
        raise AssertionError("unreachable")  # pragma: no cover

    def pool_view(self) -> dict:
        """Connection-pool stats (surfaced in /healthz and as the
        engine-pool gauges at /metrics)."""
        return self._pool.view()

    def close(self) -> None:
        self._pool.close_all()

    def _json(self, method: str, path: str, params: dict | None = None,
              body: dict | None = None, ok: tuple[int, ...] = (200, 201, 204)):
        status, data = self._request(method, path, params, body)
        if status == 404:
            raise _NotFound(data.decode(errors="replace"))
        if status not in ok:
            raise errors.ApiError(
                f"docker {method} {path} -> {status}: {data.decode(errors='replace')}"
            )
        return json.loads(data) if data else None

    def ping(self) -> None:
        status, _ = self._request("GET", "/_ping", timeout=5.0)
        if status != 200:
            raise errors.ApiError(f"docker ping failed: {status}")

    # -- containers --------------------------------------------------------------

    def container_create(self, spec: ContainerSpec) -> str:
        exposed = {f"{p.container_port}/{p.protocol}": {} for p in spec.port_bindings}
        port_bindings = {
            f"{p.container_port}/{p.protocol}": [{"HostPort": str(p.host_port)}]
            for p in spec.port_bindings
        }
        body = {
            "Image": spec.image,
            "Cmd": spec.cmd or None,
            "Env": spec.env,
            "OpenStdin": spec.open_stdin,
            "Tty": spec.tty,
            "ExposedPorts": exposed,
            "Labels": {
                "tpu-docker-api.chips": ",".join(map(str, spec.chip_ids)),
                "tpu-docker-api.ici": "1" if spec.ici_contiguous else "0",
            },
            "HostConfig": {
                "Binds": spec.binds,
                "PortBindings": port_bindings,
                "Privileged": spec.privileged,
                "Devices": [
                    {
                        "PathOnHost": d.host_path,
                        "PathInContainer": d.container_path,
                        "CgroupPermissions": d.permissions,
                    }
                    for d in spec.devices
                ],
            },
        }
        if spec.gpu_uuids:
            body["HostConfig"]["DeviceRequests"] = [{
                "Driver": "nvidia",
                "Count": 0,
                "DeviceIDs": list(spec.gpu_uuids),
                "Capabilities": [["gpu"]],
            }]
        try:
            resp = self._json("POST", "/containers/create",
                              params={"name": spec.name}, body=body)
        except _NotFound as e:
            raise errors.ApiError(f"image {spec.image} not found: {e}") from e
        return resp["Id"]

    def container_start(self, name: str) -> None:
        self._container_op(name, "start")

    def container_stop(self, name: str, timeout_s: int = 10) -> None:
        # dockerd holds the POST open for up to timeout_s before SIGKILL, so
        # the HTTP timeout must exceed it — with the flat 60 s transport
        # default, any stop grace > 60 s raised on a perfectly healthy daemon
        self._container_op(name, "stop", params={"t": timeout_s},
                           timeout=max(60.0, timeout_s + 30.0))

    def container_restart(self, name: str) -> None:
        self._container_op(name, "restart")

    def _container_op(self, name: str, op: str, params: dict | None = None,
                      timeout: float = 60.0) -> None:
        try:
            # 304 = already in desired state
            status, data = self._request("POST", f"/containers/{name}/{op}",
                                         params, timeout=timeout)
            if status == 404:
                raise errors.ContainerNotExist(name)
            if status not in (204, 304):
                raise errors.ApiError(
                    f"docker {op} {name} -> {status}: {data.decode(errors='replace')}"
                )
        except _NotFound:
            raise errors.ContainerNotExist(name) from None

    def container_remove(self, name: str, force: bool = False) -> None:
        try:
            self._json("DELETE", f"/containers/{name}",
                       params={"force": "true" if force else "false"})
        except _NotFound:
            raise errors.ContainerNotExist(name) from None

    def container_inspect(self, name: str) -> ContainerInfo:
        try:
            raw = self._json("GET", f"/containers/{name}/json")
        except _NotFound:
            raise errors.ContainerNotExist(name) from None
        return self._to_info(raw)

    def _to_info(self, raw: dict) -> ContainerInfo:
        cfg, host = raw.get("Config", {}), raw.get("HostConfig", {})
        ports = []
        for key, binds in (host.get("PortBindings") or {}).items():
            cport, _, proto = key.partition("/")
            for b in binds or []:
                ports.append(PortBinding(int(cport), int(b.get("HostPort") or 0), proto))
        chips_label = (cfg.get("Labels") or {}).get("tpu-docker-api.chips", "")
        spec = ContainerSpec(
            name=raw["Name"].lstrip("/"),
            image=cfg.get("Image", ""),
            cmd=cfg.get("Cmd") or [],
            env=cfg.get("Env") or [],
            binds=host.get("Binds") or [],
            port_bindings=ports,
            devices=[
                DeviceMount(d["PathOnHost"], d["PathInContainer"],
                            d.get("CgroupPermissions", "rwm"))
                for d in host.get("Devices") or []
            ],
            chip_ids=[int(c) for c in chips_label.split(",") if c],
            ici_contiguous=(cfg.get("Labels") or {}).get("tpu-docker-api.ici", "1") == "1",
            open_stdin=bool(cfg.get("OpenStdin")),
            tty=bool(cfg.get("Tty")),
            privileged=bool(host.get("Privileged")),
            gpu_uuids=[u for r in host.get("DeviceRequests") or []
                       if r.get("Driver") == "nvidia"
                       for u in r.get("DeviceIDs") or []],
        )
        state = raw.get("State", {})
        # overlay2 MergedDir, the copy-task source/target (workQueue/copy.go:16)
        merged = (raw.get("GraphDriver", {}).get("Data") or {}).get("MergedDir", "")
        return ContainerInfo(
            name=spec.name,
            id=raw.get("Id", ""),
            running=bool(state.get("Running")),
            spec=spec,
            data_dir=merged,
            pid=int(state.get("Pid") or 0),
            exit_code=int(state.get("ExitCode") or 0),
            status=str(state.get("Status") or ""),
        )

    def container_exists(self, name: str) -> bool:
        try:
            self.container_inspect(name)
            return True
        except errors.ContainerNotExist:
            return False

    def container_list(self) -> list[str]:
        raw = self._json("GET", "/containers/json", params={"all": "true"})
        names = []
        for c in raw:
            names.extend(n.lstrip("/") for n in c.get("Names", []))
        return sorted(names)

    def container_exec(self, name: str, cmd: list[str], workdir: str = "") -> ExecResult:
        body = {
            "AttachStdout": True,
            "AttachStderr": True,
            "Cmd": cmd,
        }
        if workdir:
            body["WorkingDir"] = workdir
        try:
            exec_id = self._json("POST", f"/containers/{name}/exec", body=body)["Id"]
        except _NotFound:
            raise errors.ContainerNotExist(name) from None
        status, data = self._request(
            "POST", f"/exec/{exec_id}/start",
            body={"Detach": False, "Tty": False}, timeout=600.0,
        )
        if status != 200:
            raise errors.ApiError(f"exec start -> {status}")
        output = _demux_docker_stream(data)
        inspect = self._json("GET", f"/exec/{exec_id}/json")
        return ExecResult(exit_code=int(inspect.get("ExitCode") or 0), output=output)

    def container_commit(self, name: str, image_ref: str) -> str:
        repo, _, tag = image_ref.partition(":")
        resp = self._json(
            "POST", "/commit",
            params={"container": name, "repo": repo, "tag": tag or "latest"},
        )
        return resp["Id"]

    # -- volumes -----------------------------------------------------------------

    def volume_create(self, name: str, driver_opts: dict[str, str]) -> VolumeInfo:
        body = {"Name": name, "Driver": "local", "DriverOpts": driver_opts}
        raw = self._json("POST", "/volumes/create", body=body)
        return VolumeInfo(name=raw["Name"], mountpoint=raw.get("Mountpoint", ""),
                          driver_opts=raw.get("Options") or {})

    def volume_remove(self, name: str, force: bool = False) -> None:
        try:
            self._json("DELETE", f"/volumes/{name}",
                       params={"force": "true" if force else "false"})
        except _NotFound:
            raise errors.VolumeNotExist(name) from None

    def volume_inspect(self, name: str) -> VolumeInfo:
        try:
            raw = self._json("GET", f"/volumes/{name}")
        except _NotFound:
            raise errors.VolumeNotExist(name) from None
        return VolumeInfo(name=raw["Name"], mountpoint=raw.get("Mountpoint", ""),
                          driver_opts=raw.get("Options") or {})

    def volume_exists(self, name: str) -> bool:
        try:
            self.volume_inspect(name)
            return True
        except errors.VolumeNotExist:
            return False


class _NotFound(Exception):
    pass


def _demux_docker_stream(data: bytes) -> str:
    """Demultiplex docker's 8-byte-header stdout/stderr stream (the Go side
    uses stdcopy.StdCopy, service/container.go:169-172). A stream whose FIRST
    header is not valid (stream id ∈ {0,1,2}, three zero pad bytes) is a
    tty-mode raw stream and passes through undecoded. An invalid header
    mid-stream is corruption, not tty mode: the frames already demuxed are
    kept and the unparseable remainder is appended raw, rather than
    re-emitting the whole buffer (which would re-include the binary headers
    of frames that parsed fine). A trailing fragment shorter than one header
    is indistinguishable from a truncated valid header and is dropped as
    framing, not payload."""
    out = []
    i = 0
    while i + 8 <= len(data):
        stream_id, size = struct.unpack(">BxxxL", data[i:i + 8])
        if stream_id > 2 or data[i + 1:i + 4] != b"\x00\x00\x00":
            if not out:
                return data.decode(errors="replace")  # tty mode: no framing
            out.append(data[i:])  # mid-stream corruption: keep parsed frames
            break
        out.append(data[i + 8:i + 8 + size])
        i += 8 + size
    if not out:  # short raw stream (< one header)
        return data.decode(errors="replace")
    return b"".join(out).decode(errors="replace")
