"""A minimal Docker Engine on a unix socket, for tests and the card's
smoke run.

It speaks the Engine API's golden shapes (version-prefixed paths, 201/204/
304/404 statuses, the 8-byte stdcopy exec stream) for exactly the calls
``runtime/docker_http.py`` makes, keeps containers, volumes and execs in
memory, and journals every request as ``(method, path, params, body)`` so
a caller can hold the bodies the runtime sent. A create stores its
``HostConfig`` as sent, so inspect returns what create carried
(``DeviceRequests`` included). Modeled on the mock of
``tests/test_docker_http.py``; no docker daemon is needed.

    eng = FakeEngine(path)        # serves at unix://path from a thread
    rt = DockerRuntime(eng.docker_host)
    ...
    eng.close()
"""

from __future__ import annotations

import json
import socketserver
import struct
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler

API_PREFIX = "/v1.41"


def mux_frames(*frames: tuple[int, bytes]) -> bytes:
    """Encode (stream_id, payload) pairs in docker's stdcopy framing."""
    return b"".join(struct.pack(">BxxxL", sid, len(payload)) + payload
                    for sid, payload in frames)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # AF_UNIX: client_address is b'' — stub the peer-name helpers
    def address_string(self):
        return "unix"

    def log_message(self, *args):
        pass

    def _reply(self, status: int, payload=None, raw: bytes | None = None):
        body = raw if raw is not None else (
            json.dumps(payload).encode() if payload is not None else b"")
        self.send_response(status)
        self.send_header("Content-Type",
                         "application/octet-stream" if raw is not None
                         else "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _handle(self, method: str):
        eng: FakeEngine = self.server.engine
        parsed = urllib.parse.urlsplit(self.path)
        if not parsed.path.startswith(API_PREFIX + "/"):
            return self._reply(400, {"message": f"unversioned {parsed.path}"})
        path = parsed.path[len(API_PREFIX):]
        params = dict(urllib.parse.parse_qsl(parsed.query))
        length = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(length)) if length else None
        with eng.mu:
            eng.requests.append((method, path, params, body))
            status, payload, raw = eng.route(method, path, params, body)
        self._reply(status, payload, raw)

    def do_GET(self):  # noqa: N802
        self._handle("GET")

    def do_POST(self):  # noqa: N802
        self._handle("POST")

    def do_DELETE(self):  # noqa: N802
        self._handle("DELETE")


class _Server(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    #: dockerd's listener queues up to the kernel's somaxconn; the
    #: socketserver default of 5 would refuse a burst of 8 dials
    request_queue_size = 128

    def __init__(self, path: str, engine: "FakeEngine"):
        super().__init__(path, _Handler)
        self.engine = engine


class FakeEngine:
    """In-memory dockerd serving on ``socket_path`` until ``close``."""

    def __init__(self, socket_path: str,
                 known_images: tuple[str, ...] = ("jax:latest",)) -> None:
        self.mu = threading.Lock()
        self.containers: dict[str, dict] = {}
        self.volumes: dict[str, dict] = {}
        self.execs: dict[str, dict] = {}
        #: (method, path without the version prefix, query, JSON body)
        self.requests: list[tuple[str, str, dict, dict | None]] = []
        self.known_images = set(known_images)
        self.socket_path = socket_path
        self.docker_host = "unix://" + socket_path
        self._server = _Server(socket_path, self)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        args=(0.05,), daemon=True)
        self._thread.start()

    def last(self):
        return self.requests[-1]

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

    def route(self, method: str, path: str, params: dict, body):
        """(status, JSON payload, raw bytes) of one request; the caller
        holds ``mu``."""
        if (method, path) == ("GET", "/_ping"):
            return 200, None, b"OK"
        if (method, path) == ("POST", "/containers/create"):
            name = params["name"]
            if body["Image"] not in self.known_images:
                return 404, {"message": f"No such image: {body['Image']}"}, None
            cid = f"id-{name}"
            self.containers[name] = {
                "Id": cid, "Name": f"/{name}", "Config": {
                    "Image": body["Image"], "Cmd": body.get("Cmd"),
                    "Env": body.get("Env"), "Labels": body.get("Labels"),
                    "OpenStdin": body.get("OpenStdin", False),
                    "Tty": body.get("Tty", False),
                },
                "HostConfig": body.get("HostConfig", {}),
                "State": {"Running": False, "Pid": 0, "ExitCode": 0},
                "GraphDriver": {"Name": "overlay2", "Data": {
                    "MergedDir": f"/var/lib/docker/overlay2/{cid}/merged"}},
            }
            return 201, {"Id": cid, "Warnings": []}, None
        parts = path.split("/")
        if method == "POST" and len(parts) == 4 and parts[1] == "containers":
            _, _, name, op = parts
            c = self.containers.get(name)
            if c is None:
                return 404, {"message": "no such container"}, None
            if op in ("start", "stop", "restart"):
                want = op != "stop"
                if op != "restart" and c["State"]["Running"] == want:
                    return 304, None, None
                c["State"]["Running"] = want
                c["State"]["Pid"] = 4242 if want else 0
                return 204, None, None
            if op == "exec":
                eid = f"exec-{len(self.execs)}"
                self.execs[eid] = {"ExitCode": 3, "Cmd": body["Cmd"]}
                return 201, {"Id": eid}, None
        if method == "POST" and path.startswith("/exec/") \
                and path.endswith("/start"):
            if parts[2] not in self.execs:
                return 404, {"message": "no such exec"}, None
            return 200, None, mux_frames(
                (1, b"out-line-1\n"), (2, b"err-line\n"), (1, b"out-line-2\n"))
        if method == "GET" and path.startswith("/exec/"):
            return 200, self.execs[parts[2]], None
        if (method, path) == ("POST", "/commit"):
            name = params["container"]
            if name not in self.containers:
                return 404, {"message": "no such container"}, None
            return 201, {"Id": f"sha256:{name}-{params['repo']}-"
                                f"{params['tag']}"}, None
        if (method, path) == ("GET", "/containers/json"):
            return 200, [{"Id": c["Id"], "Names": [c["Name"]]}
                         for c in self.containers.values()], None
        if method == "GET" and len(parts) == 4 and parts[3] == "json":
            c = self.containers.get(parts[2])
            if c is None:
                return 404, {"message": "no such container"}, None
            return 200, c, None
        if method == "DELETE" and len(parts) == 3 and parts[1] == "containers":
            if self.containers.pop(parts[2], None) is None:
                return 404, {"message": "no such container"}, None
            return 204, None, None
        if (method, path) == ("POST", "/volumes/create"):
            self.volumes[body["Name"]] = {
                "Name": body["Name"], "Driver": body["Driver"],
                "Options": body.get("DriverOpts") or {},
                "Mountpoint": f"/var/lib/docker/volumes/{body['Name']}/_data",
            }
            return 201, self.volumes[body["Name"]], None
        if method == "GET" and len(parts) == 3 and parts[1] == "volumes":
            v = self.volumes.get(parts[2])
            if v is None:
                return 404, {"message": "no such volume"}, None
            return 200, v, None
        if method == "DELETE" and len(parts) == 3 and parts[1] == "volumes":
            if self.volumes.pop(parts[2], None) is None:
                return 404, {"message": "no such volume"}, None
            return 204, None, None
        return 500, {"message": f"unhandled {method} {path}"}, None
