"""Process bootstrap / lifecycle.

Parity: reference ``cmd/gpu-docker-api/main.go`` — the go-svc ``Init/Start/
Stop`` triple. Init wires config → runtime → store → workQueue → schedulers →
versions in the same order (main.go:50-86); Start launches the HTTP server and
the work-queue sync loop (main.go:88-115); Stop drains and closes every
subsystem (main.go:117-130). Scheduler and version state is persisted on
every mutation, so Stop is not load-bearing for correctness.

The port's copy of ``tpu_docker_api/daemon.py``: the wiring order of
``Program.init/start/stop`` reduced to the modules the port has (store
and its health machine, fan-out, runtime, work queue, GPU and port
schedulers, version maps, the container and volume services, the pod and
its scheduler, the job service, the capacity market, the Service resource
and its autoscaler, the host monitor, the job supervisor, the health
watcher, the reconciler and its dirty feed, the tracer, the API). Leader
election, shards, the informer read path, workflows, the gateway and the
compactor come with the rest of the control plane (ROADMAP Queue 1 item
10 part v); ``config.load`` refuses a config that turns one on.

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
from tpu_docker_api_torch.scheduler.pod import Pod, PodHost, PodScheduler
from tpu_docker_api_torch.scheduler.ports import PortScheduler
from tpu_docker_api_torch.scheduler.slices import ChipScheduler
from tpu_docker_api_torch.scheduler.topology import HostTopology
from tpu_docker_api_torch.service.container import ContainerService
from tpu_docker_api_torch.service.host_health import HostMonitor
from tpu_docker_api_torch.service.job import JobService
from tpu_docker_api_torch.service.job_supervisor import JobSupervisor
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
                 kv=None, runtime=None, pod_runtimes=None) -> None:
        self.cfg = cfg
        self.host = host
        self.api_server: ApiServer | None = None
        # injection seam for the crash-consistency tests: a "restarted"
        # Program must boot over the SAME KV + runtime the dead one used.
        # ``pod_runtimes`` extends the seam to multi-host pods: host_id →
        # runtime for non-local [[pod_hosts]] entries, so a "restarted"
        # daemon sees the same remote engines the dead one drove
        self._injected_kv = kv
        self._injected_runtime = runtime
        self._injected_pod_runtimes = pod_runtimes or {}

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
        self.pod = self._build_pod(topology)
        self.pod_scheduler = PodScheduler(self.pod, self.kv)
        self.job_versions = VersionMap(self.kv, keys.VERSIONS_JOB_KEY)
        self.job_svc = JobService(
            self.pod, self.pod_scheduler, self.store, self.job_versions,
            fanout=self.fanout, registry=self.metrics,
            # elastic gangs: one gate + one loop bound, consulted by every
            # resize decision site (supervisor, drain) through the service
            resize_enabled=cfg.job_resize_enabled,
            resize_max=cfg.job_resize_max,
        )
        # capacity market (service/admission.py): constructed
        # unconditionally — priority-class validation and submit-seq
        # seniority stamping apply even without the market — while
        # admission_enabled gates the policy itself (queue/preempt/
        # backfill); disabled keeps the legacy hard refusal byte-for-byte
        from tpu_docker_api_torch.service.admission import AdmissionController

        self.admission = AdmissionController(
            self.job_svc, self.store, self.job_versions,
            self.pod_scheduler, self.kv,
            enabled=cfg.admission_enabled,
            classes=cfg.priority_class_weights,
            default_class=cfg.priority_class_default,
            max_skips=cfg.admission_max_skips,
            interval_s=cfg.admission_interval_s,
            registry=self.metrics,
            tracer=self.tracer,
            store_gate=store_gate,
        )
        self.job_svc.admission = self.admission
        # Service resource (service/serving.py): declarative replicated
        # serving over replica gangs, scaled by the SLO-driven autoscaler
        # through the capacity market at the service's priority class
        from tpu_docker_api_torch.service.serving import ServingService

        self.service_versions = VersionMap(self.kv,
                                           keys.VERSIONS_SERVICE_KEY)
        self.serving = ServingService(
            self.job_svc, self.store, self.service_versions,
            self.job_versions, admission=self.admission,
            default_class=cfg.service_default_class,
            interval_s=cfg.autoscale_interval_s,
            up_cooldown_s=cfg.autoscale_up_cooldown_s,
            down_cooldown_s=cfg.autoscale_down_cooldown_s,
            down_watermark=cfg.autoscale_down_watermark,
            registry=self.metrics,
            tracer=self.tracer,
            store_gate=store_gate,
        )
        # engine-pool saturation gauges: one labeled sample per DISTINCT
        # engine behind this pod (the local runtime is shared by several
        # PodHost entries; BreakerRuntime/FaultyRuntime delegate pool_view
        # to the transport underneath)
        self.metrics.gauge_series_fn(
            "engine_pool_in_use",
            lambda: self._engine_pool_series("inUse"),
            help="Engine keep-alive connections currently in use, "
                 "per engine endpoint")
        self.metrics.gauge_series_fn(
            "engine_pool_idle",
            lambda: self._engine_pool_series("idle"),
            help="Idle engine keep-alive connections retained, "
                 "per engine endpoint")
        # host failure domains: engine probing + healthy→suspect→down per
        # host; built before the supervisor so its down-verdicts gate the
        # supervisor's migrate-vs-hands-off decision from the first poll
        self.host_monitor = None
        if cfg.host_probe_interval_s > 0:
            self.host_monitor = HostMonitor(
                self.pod, self.pod_scheduler,
                interval_s=cfg.host_probe_interval_s,
                down_grace_s=cfg.host_down_grace_s,
                job_svc=self.job_svc, job_versions=self.job_versions,
                work_queue=self.wq,
                registry=self.metrics,
                fanout=self.fanout,
                # late-bound: the supervisor is constructed just below — a
                # confirmed-down host must wake it immediately, not wait
                # out the poll interval
                on_down=lambda hid: self.job_supervisor.wake(hid),
                store_gate=store_gate,
            )
        # gang supervision (whole-gang restart with backoff, crash-loop →
        # terminal failed; host-down → migration): built in init so the
        # startup reconcile and the watcher's delegation hook can use it
        # before start()
        self.job_supervisor = JobSupervisor(
            self.pod, self.job_svc, self.store, self.job_versions,
            interval_s=cfg.job_supervise_interval,
            max_restarts=cfg.job_max_restarts,
            max_migrations=cfg.job_max_migrations,
            backoff_base_s=cfg.job_backoff_base_s,
            backoff_max_s=cfg.job_backoff_max_s,
            backoff_jitter=cfg.job_backoff_jitter,
            registry=self.metrics,
            host_monitor=self.host_monitor,
            fanout=self.fanout,
            store_gate=store_gate,
        )
        self.health_watcher = None
        if cfg.health_watch_interval > 0:
            from tpu_docker_api_torch.service.watch import HealthWatcher

            self.health_watcher = HealthWatcher(
                self.runtime,
                interval_s=cfg.health_watch_interval,
                restart_policy=cfg.restart_policy,
                crash_handler=self.container_svc.handle_crash,
                # gang members are the supervisor's: the container path
                # declines them (never restart one member in isolation).
                # Only wired when the supervisor loop actually runs —
                # delegating to a stopped supervisor would strand crashed
                # members with no recovery path at all
                job_crash_handler=(
                    self.job_supervisor.handle_member_death
                    if cfg.job_supervise_interval > 0 else None),
                restart_backoff_s=cfg.restart_backoff_s,
                restart_backoff_max_s=cfg.restart_backoff_max_s,
                registry=self.metrics,
            )
        self.reconciler = Reconciler(
            self.runtime, self.store, self.chip_scheduler,
            self.port_scheduler, self.container_versions,
            container_svc=self.container_svc,
            # job families allocate from the same local chip/port pools,
            # so their claims are off-limits to the leak sweep
            shared_version_maps=[self.job_versions],
            job_svc=self.job_svc, job_versions=self.job_versions,
            job_max_restarts=cfg.job_max_restarts,
            job_max_migrations=cfg.job_max_migrations,
            registry=self.metrics,
            # durable-queue adoption: the startup sweep replays the journal
            # a dead daemon left (pending/in-flight records) before judging
            # family state
            work_queue=self.wq,
            fanout=self.fanout,
            # admission-journal adoption (enabled deployments only): purge/
            # settle/re-journal records after the family passes repaired
            # any half-preempted gang
            admission=self.admission if cfg.admission_enabled else None,
            # Service adoption: converge every service to one fully-owned
            # replica set after a crash (missing/surplus/orphan replicas,
            # interrupted deletes and spec rolls)
            serving=self.serving,
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

    def _build_pod(self, local_topology: HostTopology) -> Pod:
        """Multi-host pod from [[pod_hosts]] config, else a single-host pod
        wrapping this host's runtime + schedulers (SURVEY.md hard part #3 —
        the reference is locked to one docker socket). A host that is not
        this machine has a topology synthesized from its
        ``accelerator_type``, its GPUs named by NVML index (a real engine
        takes an index as a ``DeviceIDs`` entry; it would refuse a
        made-up UUID)."""
        cfg = self.cfg
        if not cfg.pod_hosts:
            return Pod.single_host(PodHost(
                host_id="local", address="127.0.0.1", grid_coord=(0, 0, 0),
                topology=local_topology, runtime=self.runtime,
                chips=self.chip_scheduler, ports=self.port_scheduler,
            ))
        hosts = []
        for entry in cfg.pod_hosts:
            host_id = entry["host_id"]
            if entry.get("local", False):
                # THIS machine: share the container service's runtime and
                # schedulers so local GPUs have exactly one accounting
                # (otherwise POST /containers and POST /jobs would both
                # hand out the same physical GPUs from separate pools)
                hosts.append(PodHost(
                    host_id=host_id,
                    address=entry["address"],
                    grid_coord=tuple(entry.get("grid_coord", [0, 0, 0])),
                    topology=local_topology,
                    runtime=self.runtime,
                    chips=self.chip_scheduler,
                    ports=self.port_scheduler,
                ))
                continue
            runtime = self._injected_pod_runtimes.get(host_id) or (
                open_runtime("docker", docker_host=entry.get(
                    "docker_host", cfg.docker_host),
                    pool_size=cfg.engine_pool_size)
                if entry.get("runtime_backend", cfg.runtime_backend) == "docker"
                else open_runtime("fake", allow_exec=True)
            )
            if cfg.breaker_threshold > 0:
                # circuit breaker per REMOTE engine: a dead socket must
                # cost one timeout, not one per caller per poll. The local
                # host's runtime stays unwrapped — it is shared with the
                # container service, and a local dockerd outage takes the
                # daemon with it anyway
                from tpu_docker_api_torch.service.host_health import (
                    BreakerRuntime)

                runtime = BreakerRuntime(
                    runtime, host_id=host_id,
                    threshold=cfg.breaker_threshold,
                    # cooldown tied to the probe interval so every monitor
                    # tick past it doubles as the half-open recovery probe
                    cooldown_s=cfg.host_probe_interval_s or 5.0,
                )
            topo = HostTopology.build(
                entry.get("accelerator_type", cfg.accelerator_type),
                index_names=True)
            hosts.append(PodHost(
                host_id=host_id,
                address=entry["address"],
                grid_coord=tuple(entry.get("grid_coord", [0, 0, 0])),
                topology=topo,
                runtime=runtime,
                chips=ChipScheduler(topo, self.kv, keys.host_chips_key(host_id)),
                ports=PortScheduler(self.kv, cfg.start_port, cfg.end_port,
                                    store_key=keys.host_ports_key(host_id)),
            ))
        grid = tuple(
            max(h.grid_coord[d] for h in hosts) + 1 for d in range(3)
        )
        gen = hosts[0].topology.generation
        return Pod(gen, grid, hosts)  # type: ignore[arg-type]

    def _engine_pool_series(self, key: str) -> list[tuple[dict, float]]:
        """Per-engine connection-pool stat series for /metrics: one
        ``{endpoint=...}`` sample per DISTINCT engine (dedupe by runtime
        identity — the local engine backs several PodHost entries once).
        The endpoint label value is the sorted host-id set the engine
        serves, so cardinality is bounded by pod size."""
        by_engine: dict[int, tuple] = {}
        for host_id in sorted(self.pod.hosts):
            rt = self.pod.hosts[host_id].runtime
            by_engine.setdefault(id(rt), (rt, []))[1].append(host_id)
        out = []
        for rt, host_ids in by_engine.values():
            try:
                v = rt.pool_view().get(key, 0)
            except AttributeError:
                continue
            out.append(({"endpoint": ",".join(host_ids)}, float(v)))
        return out

    def _reload_caches(self) -> None:
        """Re-read every stateful mirror (version maps, slice registry +
        cordons, per-host GPU/port maps — the local host's schedulers are
        shared with the pod, so the host walk covers them): JAX's
        leadership-handoff refresh, which leader election (part v of
        ROADMAP Queue 1 item 10) calls."""
        for vm in (self.container_versions, self.volume_versions,
                   self.job_versions, self.service_versions):
            vm.reload_from_store()
        self.pod_scheduler.reload_from_store()
        for host in self.pod.hosts.values():
            host.chips.reload_from_store()
            host.ports.reload_from_store()

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
        rides the reconciler's own passes; the supervisor wakes to re-poll."""
        self.reconciler.mark_all_dirty("store-recovered")
        self.job_supervisor.wake()

    def _start_writers(self) -> None:
        """The writer role: every subsystem that MUTATES shared state —
        the work queue's sync loop, the startup reconcile (which replays
        the journal a previous incarnation left), the periodic reconcile,
        the supervisors, the health watcher, the admission loop and the
        autoscaler."""
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
        if self.cfg.job_supervise_interval > 0:
            self.job_supervisor.start()
        if self.host_monitor is not None:
            self.host_monitor.start()
        if self.health_watcher is not None:
            self.health_watcher.start()
        if self.cfg.admission_enabled and self.cfg.admission_interval_s > 0:
            # the admission loop mutates shared state (preemption, gang
            # placement) — a writer like the supervisor
            self.admission.start()
        if self.cfg.autoscale_interval_s > 0:
            # the autoscaler mutates shared state (replica gangs, service
            # records) — a writer like the admission loop
            self.serving.start()

    def _stop_writers(self) -> None:
        """Halt the writer role; every close is guarded and restartable."""
        if getattr(self, "serving", None) is not None:
            self.serving.close()
        if getattr(self, "admission", None) is not None:
            self.admission.close()
        if getattr(self, "health_watcher", None) is not None:
            self.health_watcher.close()
        if getattr(self, "host_monitor", None) is not None:
            self.host_monitor.close()
        if getattr(self, "job_supervisor", None) is not None:
            self.job_supervisor.close()
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
            job_svc=self.job_svc, pod_scheduler=self.pod_scheduler,
            reconciler=self.reconciler, job_supervisor=self.job_supervisor,
            host_monitor=self.host_monitor, fanout=self.fanout,
            admission=self.admission, serving=self.serving,
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
        if getattr(self, "pod", None) is not None:
            for host in self.pod.hosts.values():
                if host.runtime is not self.runtime:
                    host.runtime.close()
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
