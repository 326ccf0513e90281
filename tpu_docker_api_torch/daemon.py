"""Process bootstrap / lifecycle.

Parity: reference ``cmd/gpu-docker-api/main.go`` — the go-svc ``Init/Start/
Stop`` triple. Init wires config → runtime → store → workQueue → schedulers →
versions in the same order (main.go:50-86); Start launches the HTTP server and
the work-queue sync loop (main.go:88-115); Stop drains and closes every
subsystem (main.go:117-130). Scheduler and version state is persisted on
every mutation, so Stop is not load-bearing for correctness.

The port's copy of ``tpu_docker_api/daemon.py`` for one host: the wiring
order of ``Program.init/start/stop`` reduced to the modules the port
has (store and its health machine, fan-out, runtime, work queue, GPU and
port schedulers, version maps, the container and volume services, the
health watcher, the reconciler and its dirty feed, the tracer, the API).
Leader election, shards, the informer read path, pods, jobs, admission,
serving, workflows, the gateway and the compactor come with the rest of
the control plane (ROADMAP Queue 1 item 10); ``config.load`` refuses a
config that turns one on.

CLI: ``python -m tpu_docker_api_torch -c cfg.toml``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import signal
import threading
import urllib.parse

from tpu_docker_api_torch import config as config_mod
from tpu_docker_api_torch.api.app import ApiServer, build_router
from tpu_docker_api_torch.buildinfo import build_info
from tpu_docker_api_torch.runtime import open_runtime
from tpu_docker_api_torch.runtime.fanout import Fanout
from tpu_docker_api_torch.scheduler.ports import PortScheduler
from tpu_docker_api_torch.scheduler.slices import ChipScheduler
from tpu_docker_api_torch.scheduler.topology import HostTopology
from tpu_docker_api_torch.service.container import ContainerService
from tpu_docker_api_torch.service.reconcile import Reconciler
from tpu_docker_api_torch.service.store_health import (StoreHealth,
                                                       StoreHealthKV)
from tpu_docker_api_torch.service.volume import VolumeService
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.kv import open_store
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.state.version import VersionMap
from tpu_docker_api_torch.state.workqueue import WorkQueue

log = logging.getLogger(__name__)


class Program:
    def __init__(self, cfg: config_mod.Config, host: str = "0.0.0.0",
                 kv=None, runtime=None) -> None:
        self.cfg = cfg
        self.host = host
        self.api_server: ApiServer | None = None
        # injection seam for the crash-consistency tests: a "restarted"
        # Program must boot over the SAME KV + runtime the dead one used
        self._injected_kv = kv
        self._injected_runtime = runtime

    def init(self) -> None:
        cfg = self.cfg
        from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry
        from tpu_docker_api_torch.telemetry.trace import Tracer

        # metrics first: the work queue's degradation counters need a home
        # before any durable submit can happen; the tracer second, one sink
        # per Program
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(buffer_size=cfg.trace_buffer_size,
                             enabled=cfg.tracing_enabled,
                             registry=self.metrics,
                             slow_ms=cfg.trace_slow_ms)
        raw_kv = self._injected_kv or open_store(
            cfg.store_backend, etcd_addr=cfg.etcd_addr,
            sqlite_path=cfg.sqlite_path,
            retry_attempts=cfg.store_retry_attempts,
            retry_base_s=cfg.store_retry_base_s,
            retry_max_s=cfg.store_retry_max_s,
            op_deadline_s=cfg.store_op_deadline_s)
        # store failure domain (service/store_health.py): every op through
        # this daemon is measured and classified — zero extra round trips
        # on the healthy path — feeding the healthy→degraded→outage machine
        # that gates mutations and the writer loops. Installed under every
        # other wrapper, so the informer's relists double as outage probes
        self.store_health = StoreHealth(
            fail_threshold=cfg.store_health_fail_threshold,
            outage_grace_s=cfg.store_health_outage_grace_s,
            probe_interval_s=cfg.store_health_probe_interval_s,
            registry=self.metrics,
        )
        raw_kv = StoreHealthKV(raw_kv, self.store_health)
        #: the writer-loop hold: observe, don't act, while the store is out
        store_gate = self.store_health.allows_writes
        self.kv = raw_kv
        self.store = StateStore(self.kv)
        # runtime fan-out: ONE bounded pool for the whole process, so
        # total engine concurrency is capped by fanout_workers rather than
        # multiplied across subsystems; workers=1 (default) is serial
        self.fanout = Fanout(cfg.fanout_workers, registry=self.metrics,
                             name="pod")
        self.metrics.gauge_fn(
            "fanout_inflight", self.fanout.inflight,
            help="Engine calls currently submitted to the fan-out pool")
        self.metrics.gauge_fn(
            "fanout_workers", lambda: self.fanout.workers,
            help="Fan-out pool size (config fanout_workers)")
        self.runtime = self._injected_runtime or (
            open_runtime("docker", docker_host=cfg.docker_host,
                         pool_size=cfg.engine_pool_size)
            if cfg.runtime_backend == "docker"
            else open_runtime("fake", allow_exec=True,
                              root=cfg.fake_runtime_root or None,
                              persist=bool(cfg.fake_runtime_root))
        )
        self.wq = WorkQueue(
            self.kv,
            submit_timeout_s=cfg.queue_submit_timeout_s,
            close_deadline_s=cfg.queue_close_deadline_s,
            dead_letter_retry_budget=cfg.queue_dead_letter_retry_budget,
            metrics=self.metrics,
            tracer=self.tracer,
            store_gate=store_gate,
        )
        topology = self._discover_topology()
        self.chip_scheduler = ChipScheduler(topology, self.kv)
        self.port_scheduler = PortScheduler(
            self.kv, cfg.start_port, cfg.end_port
        )
        self.container_versions = VersionMap(self.kv,
                                             keys.VERSIONS_CONTAINER_KEY)
        self.volume_versions = VersionMap(self.kv, keys.VERSIONS_VOLUME_KEY)
        self.container_svc = ContainerService(
            self.runtime, self.store, self.chip_scheduler, self.port_scheduler,
            self.container_versions, self.wq,
        )
        self.volume_svc = VolumeService(
            self.runtime, self.store, self.volume_versions, self.wq
        )
        self.health_watcher = None
        if cfg.health_watch_interval > 0:
            from tpu_docker_api_torch.service.watch import HealthWatcher

            self.health_watcher = HealthWatcher(
                self.runtime,
                interval_s=cfg.health_watch_interval,
                restart_policy=cfg.restart_policy,
                crash_handler=self.container_svc.handle_crash,
                restart_backoff_s=cfg.restart_backoff_s,
                restart_backoff_max_s=cfg.restart_backoff_max_s,
                registry=self.metrics,
            )
        self.reconciler = Reconciler(
            self.runtime, self.store, self.chip_scheduler,
            self.port_scheduler, self.container_versions,
            container_svc=self.container_svc,
            registry=self.metrics,
            # durable-queue adoption: the startup sweep replays the journal
            # a dead daemon left (pending/in-flight records) before judging
            # family state
            work_queue=self.wq,
            fanout=self.fanout,
            full_interval_s=cfg.reconcile_full_interval_s,
            tracer=self.tracer,
            store_gate=store_gate,
        )
        # loss-free recovery: the instant the store heals, treat EVERYTHING
        # as changed (an outage swallows an unknown set of events) — the
        # next reconcile pass replays the journal and repairs whatever
        # drifted while the writers held
        self.store_health.on_recover(self._on_store_recover)
        # event-driven reconcile: feed the reconciler's dirty-set from the
        # store's watch stream so periodic passes are O(changes), through a
        # reflector over the store. reconcile_full_interval_s = 0 (default)
        # skips it: every pass stays a full scan
        self.reconcile_informer = None
        if cfg.reconcile_full_interval_s > 0:
            from tpu_docker_api_torch.state.informer import Informer

            self.reconcile_informer = Informer(
                raw_kv, keys.PREFIX + "/", registry=self.metrics)
            self.reconciler.attach_dirty_feed(self.reconcile_informer)

    def _discover_topology(self) -> HostTopology:
        """Topology from the gpu-detect sidecar if configured (the
        reference's first-boot detect-gpu fetch, gpuscheduler/
        scheduler.go:142-158), else from the local NVML probe, else
        synthesized from config accelerator_type."""
        cfg = self.cfg
        from tpu_docker_api_torch.schemas.gpu import HostTopologyInfo
        from tpu_docker_api_torch.telemetry.probe import (
            probe_local_topology, topology_from_info)

        if cfg.detect_tpu_addr:
            info = HostTopologyInfo.from_dict(_get_json(
                cfg.detect_tpu_addr.rstrip("/") + "/api/v1/detect/gpu")["data"])
            return topology_from_info(info)
        local = probe_local_topology()
        if local is not None:
            log.info("using locally probed topology: %d GPUs", local.n_chips)
            return local
        log.info("no GPU detected; topology from config %s",
                 cfg.accelerator_type)
        return HostTopology.build(cfg.accelerator_type)

    def _on_store_recover(self) -> None:
        """StoreHealth outage→healthy hook (fires on the thread whose op
        proved the heal — must stay cheap and non-blocking): mark every
        family dirty. The repair work — journal replay, drift sweep —
        rides the reconciler's own passes."""
        self.reconciler.mark_all_dirty("store-recovered")

    def _start_writers(self) -> None:
        """The writer role: every subsystem that MUTATES shared state —
        the work queue's sync loop, the startup reconcile (which replays
        the journal a previous incarnation left), the periodic reconcile
        and the health watcher."""
        self.wq.start()
        if self.cfg.reconcile_on_start:
            # repair whatever a previous incarnation left half-done BEFORE
            # serving traffic (an interrupted rolling replace must not be
            # visible as two live versions). A failed sweep must not block
            # boot — a recovery feature that crash-loops the daemon is
            # worse than the drift it would repair
            try:
                report = self.reconciler.reconcile()
                if report["actions"]:
                    log.warning("startup reconcile repaired %d drift(s): %s",
                                report["driftCount"],
                                [a["action"] for a in report["actions"]])
            except Exception:  # noqa: BLE001
                log.exception("startup reconcile failed; serving anyway "
                              "(rerun via /api/v1/reconcile)")
        if self.cfg.reconcile_interval > 0:
            self.reconciler.start_periodic(self.cfg.reconcile_interval)
        if self.health_watcher is not None:
            self.health_watcher.start()

    def _stop_writers(self) -> None:
        """Halt the writer role; every close is guarded and restartable."""
        if getattr(self, "health_watcher", None) is not None:
            self.health_watcher.close()
        if getattr(self, "reconciler", None) is not None:
            self.reconciler.close()
        if getattr(self, "wq", None) is not None:
            self.wq.close()

    def start(self) -> None:
        if self.reconcile_informer is not None:
            # the dirty feed warms before the first pass, so the initial
            # list's events are in the set it judges
            self.reconcile_informer.start()
        self._start_writers()
        router = build_router(
            self.container_svc, self.volume_svc,
            self.chip_scheduler, self.port_scheduler, work_queue=self.wq,
            health_watcher=self.health_watcher, metrics=self.metrics,
            reconciler=self.reconciler, fanout=self.fanout,
            store_health=self.store_health,
            list_default_limit=self.cfg.list_default_limit,
            list_max_limit=self.cfg.list_max_limit,
            tracer=self.tracer,
        )
        bi = build_info()  # warm the git probe BEFORE serving /healthz
        self.api_server = ApiServer(router, host=self.host, port=self.cfg.port)
        self.api_server.start()
        log.info("tpu-docker-api (torch) %s (%s@%s) serving on %s:%d "
                 "(%d GPUs, ports %d-%d)",
                 bi["version"], bi["branch"], bi["commit"],
                 self.host, self.api_server.port,
                 self.chip_scheduler.topology.n_chips,
                 self.cfg.start_port, self.cfg.end_port)

    def stop(self) -> None:
        """Shutdown — tolerant of a partially-completed init (every subsystem
        access is guarded), so a failed boot reports its root cause instead
        of masking it with an AttributeError during cleanup."""
        if getattr(self, "api_server", None) is not None:
            self.api_server.close()
        if getattr(self, "reconcile_informer", None) is not None:
            self.reconcile_informer.close()
        self._stop_writers()
        if getattr(self, "fanout", None) is not None:
            self.fanout.close()
        if getattr(self, "runtime", None) is not None:
            self.runtime.close()
        if getattr(self, "kv", None) is not None:
            self.kv.close()
        if getattr(self, "tracer", None) is not None:
            # no daemon ends with open spans: whatever a dying flow left
            # open closes as status="lost"
            self.tracer.close()
        log.info("tpu-docker-api stopped")


def _get_json(url: str, timeout: float = 5.0) -> dict:
    """GET ``url`` and parse its JSON body with the standard library (the
    JAX daemon uses ``requests``, which the port does not import). A
    non-2xx status raises, as ``raise_for_status`` does."""
    u = urllib.parse.urlsplit(url)
    conn_cls = (http.client.HTTPSConnection if u.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("GET", (u.path or "/") + (f"?{u.query}" if u.query else ""))
        resp = conn.getresponse()
        body = resp.read()
        if not 200 <= resp.status < 300:
            raise OSError(f"GET {url}: HTTP {resp.status}: {body[:200]!r}")
        return json.loads(body)
    finally:
        conn.close()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="tpu-docker-api-torch")
    parser.add_argument("-c", "--config", default=None, help="TOML config path")
    parser.add_argument("--host", default="0.0.0.0")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    prg = Program(config_mod.load(args.config), host=args.host)
    prg.init()
    prg.start()

    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    prg.stop()


if __name__ == "__main__":
    main()
