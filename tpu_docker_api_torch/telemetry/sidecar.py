"""gpu-detect sidecar: the HTTP telemetry service.

Parity: the reference's external ``detect-gpu`` sidecar (go-nvml wrapper,
README.md:194-195) serving ``GET /api/v1/detect/gpu``. The port's
counterpart of ``tpu_docker_api/telemetry/sidecar.py``, over NVML
(``telemetry/probe.py``). It serves:

    GET /api/v1/detect/gpu   — HostTopologyInfo JSON (GPUs with UUIDs,
                               names, coords, HBM, utilization, power
                               limits, holder pids; the driver version)
    GET /api/v1/detect/tpu   — the same (the JAX package's route)
    GET /healthz

Run: ``python -m tpu_docker_api_torch.telemetry.sidecar --port 2112``. With
no GPU it answers 503 with code 10603. ``--fake h100-8`` serves a
synthesized topology with fake UUIDs (the test seam of SURVEY.md §4 item
3).
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.scheduler.topology import HostTopology
from tpu_docker_api_torch.schemas.gpu import ChipInfo, HostTopologyInfo
from tpu_docker_api_torch.telemetry.probe import probe_host_info

log = logging.getLogger(__name__)


def fake_host_info(acc_type: str) -> HostTopologyInfo:
    """Synthesized topology for hardware-less environments."""
    topo = HostTopology.build(acc_type)
    gen = topo.generation
    chips = [
        ChipInfo(
            chip_id=cid,
            device_path=f"/dev/nvidia{cid}",
            coords=coords,
            cores_per_chip=gen.cores_per_chip,
            hbm_total_bytes=gen.hbm_bytes_per_chip,
            uuid=topo.uuids[cid],
            name=f"fake {gen.name}",
        )
        for cid, coords in sorted(topo.coords.items())
    ]
    return HostTopologyInfo(
        accelerator_type=acc_type,
        generation=gen.name,
        chips=chips,
        mesh_shape=topo.mesh_shape,
        driver_version="fake",
    )


class SidecarServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 2112,
                 fake: str = "") -> None:
        if fake:
            fake_host_info(fake)  # fail fast on a bad --fake type

        def topology() -> HostTopologyInfo | None:
            if fake:
                return fake_host_info(fake)
            return probe_host_info()

        class Handler(BaseHTTPRequestHandler):
            server_version = "gpu-detect"

            def log_message(self, fmt, *args):  # noqa: N802
                log.debug("sidecar: " + fmt, *args)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0]
                status = 200
                if path == "/healthz":
                    body = {"code": 200, "msg": "success",
                            "data": {"status": "ok"}}
                elif path in ("/api/v1/detect/gpu", "/api/v1/detect/tpu"):
                    msg = "no GPU found"
                    try:
                        info = topology()
                    except errors.TopologyUnknown as e:  # MIG is on
                        info, msg = None, str(e)
                    if info is None:
                        # real HTTP error so naive clients (raise_for_status)
                        # fail cleanly instead of parsing data: null
                        status = 503
                        body = {"code": errors.TopologyUnknown.code,
                                "msg": msg, "data": None}
                    else:
                        body = {"code": 200, "msg": "success",
                                "data": info.to_dict()}
                else:
                    status = 404
                    body = {"code": 10001, "msg": f"no route {path}",
                            "data": None}
                payload = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="gpu-detect")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=2112)
    parser.add_argument("--fake", default="",
                        help="serve a synthesized topology, e.g. h100-8")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    srv = SidecarServer(args.host, args.port, fake=args.fake)
    srv.start()
    log.info("gpu-detect serving on %s:%d (fake=%s)", args.host, srv.port,
             args.fake or "no")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
