"""Process bootstrap / lifecycle.

Parity: reference ``cmd/gpu-docker-api/main.go`` — the go-svc ``Init/Start/
Stop`` triple. Init wires config → runtime → store → workQueue → schedulers →
versions in the same order (main.go:50-86); Start launches the HTTP server and
the work-queue sync loop (main.go:88-115); Stop drains and closes every
subsystem (main.go:117-130). Unlike the reference, scheduler/version state is
already durably persisted on every mutation, so Stop is not load-bearing for
correctness.

The port's copy of ``tpu_docker_api/daemon.py``: the wiring order of
``Program.init/start/stop`` with every module the port has — the store and
its health machine, leader election or the sharded writer plane, the
informer read path, fan-out, runtime, work queue, GPU and port schedulers,
version maps, the container and volume services, the pod and its
scheduler, the job service, the capacity market, the Service resource and
its autoscaler, workflows, the host monitor, the job supervisor, the
health watcher, the reconciler and its dirty feed, the history compactor,
the tracer, the API and the serving gateway with its drain coordinator —
and the writer role that the lease starts and stops.

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
from tpu_docker_api_torch.buildinfo import build_info
from tpu_docker_api_torch.api.app import ApiServer, build_router
from tpu_docker_api_torch.runtime import open_runtime
from tpu_docker_api_torch.scheduler.pod import Pod, PodHost, PodScheduler
from tpu_docker_api_torch.scheduler.ports import PortScheduler
from tpu_docker_api_torch.scheduler.slices import ChipScheduler
from tpu_docker_api_torch.scheduler.topology import HostTopology
from tpu_docker_api_torch.service.container import ContainerService
from tpu_docker_api_torch.service.job import JobService
from tpu_docker_api_torch.service.volume import VolumeService
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.kv import open_store
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.state.version import VersionMap
from tpu_docker_api_torch.state.workqueue import WorkQueue

log = logging.getLogger(__name__)


class Program:
    def __init__(self, cfg: config_mod.Config, host: str = "0.0.0.0",
                 kv=None, runtime=None, pod_runtimes=None,
                 leader_clock=None) -> None:
        self.cfg = cfg
        self.host = host
        self.api_server: ApiServer | None = None
        # injection seam for the crash-consistency harness: a "restarted"
        # Program must boot over the SAME KV + runtime the dead one used
        # (with the default memory backend, open_store would hand each
        # Program a fresh empty store and hide every crash bug).
        # ``pod_runtimes`` extends the seam to multi-host pods: host_id →
        # runtime for non-local [[pod_hosts]] entries, so a "restarted"
        # daemon sees the same remote engines the dead one drove.
        # ``leader_clock`` extends it to the leader lease: the failover
        # chaos harness drives TTL expiry with a virtual clock
        self._injected_kv = kv
        self._injected_runtime = runtime
        self._injected_pod_runtimes = pod_runtimes or {}
        self._injected_leader_clock = leader_clock

    def init(self) -> None:
        cfg = self.cfg
        from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry

        # metrics first: the work queue's degradation counters need a home
        # before any durable submit can happen
        self.metrics = MetricsRegistry()
        # tracer second: every subsystem below records spans into this one
        # sink (one per Program — multi-daemon test processes must not
        # cross-contaminate buffers); tracing_enabled=false makes every
        # span site a no-op
        from tpu_docker_api_torch.telemetry.trace import Tracer

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
            # per-op deadline: a hung store surfaces as a typed
            # StoreUnavailable in bounded time instead of a wedged thread
            # (0 = each backend's historical timeout, byte-for-byte)
            op_deadline_s=cfg.store_op_deadline_s,
        )
        # store failure domain (service/store_health.py, docs/robustness.md
        # "Store brownouts"): every op through this daemon is measured and
        # classified — purely observational on the healthy path (zero extra
        # round trips) — feeding the healthy→degraded→outage machine that
        # gates mutations, writer loops and the stale-read contract below.
        # Installed UNDER every other wrapper (fencing, sharding, informer),
        # so leader renewals and informer relists double as outage probes.
        from tpu_docker_api_torch.service.store_health import (
            StoreHealth, StoreHealthKV)

        self.store_health = StoreHealth(
            fail_threshold=cfg.store_health_fail_threshold,
            outage_grace_s=cfg.store_health_outage_grace_s,
            probe_interval_s=cfg.store_health_probe_interval_s,
            registry=self.metrics,
        )
        raw_kv = StoreHealthKV(raw_kv, self.store_health)
        #: the writer-loop hold: observe, don't act, while the store is out
        store_gate = self.store_health.allows_writes
        self._raw_kv = raw_kv
        self.leader_elector = None
        self.shard_plane = None
        self.shard_map = None
        #: serializes shard acquire/loss callbacks (each shard's elector
        #: heartbeats on its own thread) against the shared writer loops
        self._shard_mu = threading.Lock()
        self._shard_writers_on = False
        if cfg.leader_election and cfg.shard_count > 1:
            # sharded writer plane (service/shard.py, docs/robustness.md
            # "Sharded writer plane"): N leases instead of one. Every
            # write batch is fenced on the epochs of exactly the shards
            # it touches, cross-shard batches serialize through the
            # coordination record, and the acquire/loss callbacks below
            # start/stop the writer loops per shard-portfolio instead of
            # per-lease. shard_count=1 never reaches this branch — the
            # single-elector path below stays byte-for-byte.
            import os
            import socket

            from tpu_docker_api_torch.service.shard import (
                ShardedKV, ShardMap, ShardPlane)

            holder = cfg.leader_id or f"{socket.gethostname()}:{os.getpid()}"
            plane_kwargs = {}
            if self._injected_leader_clock is not None:
                plane_kwargs["clock"] = self._injected_leader_clock
            self.shard_map = ShardMap(cfg.shard_count)
            # the plane rides the RAW store (lease writes carry their own
            # CAS guards); callbacks resolve the subsystems built below
            # lazily — electors only start in start()/step()
            self.shard_plane = ShardPlane(
                raw_kv, self.shard_map, holder,
                ttl_s=cfg.leader_ttl_s,
                renew_interval_s=cfg.leader_renew_interval_s or None,
                advertise=f"{self.host}:{cfg.port}",
                on_acquire=self._on_shard_acquire,
                on_loss=self._on_shard_loss,
                preferred=frozenset(cfg.shard_preferred),
                defer_vacant_s=cfg.shard_standby_delay_s,
                **plane_kwargs,
            )
            self.kv = ShardedKV(raw_kv, self.shard_plane)
        elif cfg.leader_election:
            # HA fleet member: EVERY write this process issues — StoreTxn
            # commits, journal claim/ack, scheduler persists — carries an
            # epoch-fencing guard once the elector has held leadership, so
            # a deposed leader's in-flight writes fail typed instead of
            # corrupting state the new leader owns. The elector itself is
            # constructed at the end of init (its callbacks start/stop the
            # writer subsystems built below); the fence closure reads it
            # late. leader_election = false skips the wrapper entirely:
            # single-process deployments keep today's store byte-for-byte
            from tpu_docker_api_torch.service.leader import FencedKV

            self.kv = FencedKV(raw_kv, self._fence_guards)
        else:
            self.kv = raw_kv
        # watch-fed standby read path (state/informer.py, "stateless API
        # replicas serving reads from watch-fed caches"):
        # one informer mirrors the whole /apis/v1 tree off the RAW store
        # (watch is a read; fencing never applies), and read_kv routes
        # get/range_prefix to that mirror while this replica stands by —
        # zero store round trips per GET, staleness bounded by watch lag.
        # Writes, leader reads, degraded-informer reads and the whole
        # read_cache="read-through" / leader_election=false configuration
        # pass through to self.kv byte-for-byte.
        self.informer = None
        read_kv = self.kv
        if (cfg.leader_election and cfg.read_cache == "informer"
                and self.shard_plane is None):
            from tpu_docker_api_torch.state.informer import (
                Informer, InformerReadKV)

            self.informer = Informer(raw_kv, keys.PREFIX + "/",
                                     registry=self.metrics)
            # store_health hookup: during a store OUTAGE reads ride the
            # (possibly stale) mirror with explicit staleness, instead of
            # burning a deadline-bounded store failure per GET
            read_kv = InformerReadKV(self.kv, self.informer,
                                     active=self._standby_reads_active,
                                     store_health=self.store_health)
        self.read_kv = read_kv
        self.store = StateStore(read_kv)
        # runtime fan-out: ONE bounded pool for the whole process (job
        # service, supervisor, host monitor, reconciler), so total engine
        # concurrency is capped by fanout_workers rather than multiplied
        # across subsystems. workers=1 (default) is the serial singleton
        # behavior with per-op telemetry
        from tpu_docker_api_torch.runtime.fanout import Fanout

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
        wq_shard_kwargs = {}
        if self.shard_plane is not None:
            # journal records land in the owning shard's sub-prefix and
            # replay/sweep only over shards this process leads
            wq_shard_kwargs = {
                "shard_fn": self._task_shard,
                "owned_shards": lambda: self.shard_plane.held,
            }
        self.wq = WorkQueue(
            self.kv,
            submit_timeout_s=cfg.queue_submit_timeout_s,
            close_deadline_s=cfg.queue_close_deadline_s,
            dead_letter_retry_budget=cfg.queue_dead_letter_retry_budget,
            metrics=self.metrics,
            tracer=self.tracer,
            store_gate=store_gate,
            **wq_shard_kwargs,
        )
        topology = self._discover_topology()
        self.chip_scheduler = ChipScheduler(topology, self.kv)
        self.port_scheduler = PortScheduler(
            self.kv, cfg.start_port, cfg.end_port
        )
        # read-through while STANDING BY: the leader creates, rolls and
        # deletes families behind this replica's back, so a standby's
        # version reads must re-seed from the store every time (staleness
        # bounded by one read). The callable resolves the role live —
        # once this replica leads, its own map is authoritative again and
        # the extra reads stop
        standby_read_through = (
            (lambda: self.leader_elector is not None
             and not self.leader_elector.is_leader)
            if cfg.leader_election else False)
        if self.shard_plane is not None:
            # per-shard version maps: each shard's snapshot persists at its
            # own key (riding that shard's epoch fence), and reads on
            # shards this process does NOT lead go read-through — the
            # single-leader read contract applied per shard
            from tpu_docker_api_torch.state.version import ShardedVersionMap

            def _svm(resource):
                return ShardedVersionMap(read_kv, self.shard_map, resource,
                                         self.shard_plane.is_leader)
            self._make_versions = _svm
        else:
            _legacy_keys = {
                keys.Resource.CONTAINERS: keys.VERSIONS_CONTAINER_KEY,
                keys.Resource.VOLUMES: keys.VERSIONS_VOLUME_KEY,
                keys.Resource.JOBS: keys.VERSIONS_JOB_KEY,
                keys.Resource.SERVICES: keys.VERSIONS_SERVICE_KEY,
                keys.Resource.WORKFLOWS: keys.VERSIONS_WORKFLOW_KEY,
            }

            def _vm(resource):
                return VersionMap(read_kv, _legacy_keys[resource],
                                  read_through=standby_read_through)
            self._make_versions = _vm
        self.container_versions = self._make_versions(keys.Resource.CONTAINERS)
        self.volume_versions = self._make_versions(keys.Resource.VOLUMES)
        self.container_svc = ContainerService(
            self.runtime, self.store, self.chip_scheduler, self.port_scheduler,
            self.container_versions, self.wq,
        )
        self.volume_svc = VolumeService(
            self.runtime, self.store, self.volume_versions, self.wq
        )
        self.pod = self._build_pod(topology)
        self.pod_scheduler = PodScheduler(self.pod, self.kv)
        self.job_versions = self._make_versions(keys.Resource.JOBS)
        if self.informer is not None:
            # standby version reads go fully watch-fed: zero store reads
            # AND zero JSON re-parses per request (the shadow updates on
            # events, not on reads); the informer-degraded fallback inside
            # VersionMap keeps the old read-through staleness bound
            for vm in (self.container_versions, self.volume_versions,
                       self.job_versions):
                vm.attach_informer(self.informer)
        self.job_svc = JobService(
            self.pod, self.pod_scheduler, self.store, self.job_versions,
            fanout=self.fanout, registry=self.metrics,
            # elastic gangs (docs/robustness.md "Elastic gangs"): one gate
            # + one loop bound, consulted by every resize decision site
            # (supervisor, drain, admission) through the job service
            resize_enabled=cfg.job_resize_enabled,
            resize_max=cfg.job_resize_max,
        )
        # capacity market (service/admission.py): constructed
        # unconditionally — priority-class validation and submit-seq
        # seniority stamping apply even without the market — while
        # admission_enabled gates the policy itself (queue/preempt/
        # backfill); disabled keeps the legacy hard refusal byte-for-byte
        from tpu_docker_api_torch.service.admission import AdmissionController

        adm_shard_kwargs = {}
        if self.shard_plane is not None:
            adm_shard_kwargs = {
                "shard_fn": self.shard_map.shard_of,
                "owned_shards": lambda: self.shard_plane.held,
            }
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
            **adm_shard_kwargs,
        )
        self.job_svc.admission = self.admission
        # Service resource (service/serving.py): declarative replicated
        # serving over replica gangs, scaled by the SLO-driven autoscaler
        # through the capacity market at the service's priority class
        from tpu_docker_api_torch.service.serving import ServingService

        self.service_versions = self._make_versions(keys.Resource.SERVICES)
        if self.informer is not None:
            self.service_versions.attach_informer(self.informer)
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
            owns=self._owns_or_none(),
            store_gate=store_gate,
        )
        # Workflow resource (service/workflow.py): durable DAG orchestration
        # over job steps — every step transition a journaled task record
        # (exactly-once across crashes), promote steps rolling Services,
        # cron re-fires with explicit catch-up semantics
        from tpu_docker_api_torch.service.workflow import WorkflowService

        self.workflow_versions = self._make_versions(keys.Resource.WORKFLOWS)
        if self.informer is not None:
            self.workflow_versions.attach_informer(self.informer)
        self.workflow = WorkflowService(
            self.job_svc, self.store, self.workflow_versions,
            self.job_versions, work_queue=self.wq, serving=self.serving,
            admission=self.admission,
            default_class=cfg.workflow_default_class,
            max_step_retries=cfg.workflow_max_step_retries,
            backoff_base_s=cfg.workflow_backoff_base_s,
            backoff_max_s=cfg.workflow_backoff_max_s,
            interval_s=cfg.workflow_interval_s,
            registry=self.metrics,
            tracer=self.tracer,
            owns=self._owns_or_none(),
            store_gate=store_gate,
        )
        # engine-pool saturation gauges: one labeled sample per DISTINCT
        # engine behind this pod (the local runtime is shared by several
        # PodHost entries; BreakerRuntime/FaultyRuntime delegate pool_view
        # to the transport underneath). The endpoint label is the engine's
        # host set — cardinality bounded by pod size, and a removed host's
        # series disappears at the next scrape (pull-time rendering)
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
        from tpu_docker_api_torch.service.host_health import HostMonitor
        from tpu_docker_api_torch.service.job_supervisor import JobSupervisor
        from tpu_docker_api_torch.service.reconcile import Reconciler

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
                # late-bound: the supervisor is constructed just below —
                # a confirmed-down host must wake it immediately, not
                # wait out the poll interval
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
            owns=self._owns_or_none(),
            store_gate=store_gate,
        )
        # job families allocate from the same local chip/port pools, so
        # their claims must be off-limits to the reconciler's leak sweep
        self.reconciler = Reconciler(
            self.runtime, self.store, self.chip_scheduler,
            self.port_scheduler, self.container_versions,
            container_svc=self.container_svc,
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
            # Workflow adoption: finish interrupted step transitions, GC
            # finished/orphan step gangs, settle terminal workflows
            workflow=self.workflow,
            full_interval_s=cfg.reconcile_full_interval_s,
            tracer=self.tracer,
            owns=self._owns_or_none(),
            owned_shards=(None if self.shard_plane is None
                          else (lambda: self.shard_plane.held)),
            store_gate=store_gate,
        )
        # loss-free recovery: the instant the store heals, treat EVERYTHING
        # as changed (an outage swallows an unknown set of events) and wake
        # the supervisor — the next reconcile pass relists, replays the
        # journal and repairs whatever drifted while the writers held
        self.store_health.on_recover(self._on_store_recover)
        # event-driven reconcile: feed the reconciler's
        # dirty-set from the store's watch stream so periodic passes are
        # O(changes). Reuses the read-path informer when one exists;
        # otherwise a dedicated reflector over the RAW store (watch is a
        # read — fencing never applies). reconcile_full_interval_s = 0
        # (default) skips all of this: every pass stays a full scan.
        self.reconcile_informer = None
        if cfg.reconcile_full_interval_s > 0:
            feed = self.informer
            if feed is None:
                from tpu_docker_api_torch.state.informer import Informer

                feed = Informer(raw_kv, keys.PREFIX + "/",
                                registry=self.metrics)
                self.reconcile_informer = feed
            self.reconciler.attach_dirty_feed(feed)
        # L7 serving gateway (service/gateway.py, api/gateway_app.py): a
        # stateless ingress on its own listener — drain-aware zero-drop
        # routing, retry/hedge budgets, breakers, outlier ejection, typed
        # load shedding. The routing table registers on the informer feed
        # HERE (before start() lists) so the initial snapshot seeds it;
        # the DrainCoordinator hooks the quiesce paths so rolls, scale-
        # downs and preemptions wait for gateway drain-acks.
        self.gateway = None
        self.gateway_server = None
        self.gateway_informer = None
        if cfg.gateway_enabled:
            from tpu_docker_api_torch.api.gateway_app import GatewayServer
            from tpu_docker_api_torch.service.gateway import (
                DrainCoordinator, Gateway)

            self.gateway = Gateway(
                raw_kv,
                resolve_addr=lambda hid: (
                    self.pod.hosts[hid].address
                    if hid in self.pod.hosts else None),
                registry=self.metrics,
                tracer=self.tracer,
                signals=self.serving.replica_signal,
                request_timeout_s=cfg.gateway_request_timeout_s,
                connect_timeout_s=cfg.gateway_connect_timeout_s,
                retry_limit=cfg.gateway_retry_limit,
                retry_budget_ratio=cfg.gateway_retry_budget_ratio,
                hedge_ms=cfg.gateway_hedge_ms,
                breaker_threshold=cfg.gateway_breaker_threshold,
                breaker_cooldown_s=cfg.gateway_breaker_cooldown_s,
                outlier_latency_factor=cfg.gateway_outlier_latency_factor,
                max_inflight=cfg.gateway_max_inflight,
                max_inflight_per_endpoint=(
                    cfg.gateway_max_inflight_per_endpoint),
                pool_size=cfg.gateway_pool_size,
                heartbeat_s=cfg.gateway_heartbeat_s,
            )
            feed = self.informer or self.reconcile_informer
            if feed is None:
                from tpu_docker_api_torch.state.informer import Informer

                feed = Informer(raw_kv, keys.PREFIX + "/",
                                registry=self.metrics)
                self.gateway_informer = feed
            self.gateway.table.attach(feed)
            self.gateway_server = GatewayServer(
                self.gateway, host=self.host, port=cfg.gateway_port)
            # control-plane half of the drain handshake: quiesce/preempt
            # paths wait (deadline-bounded) for every live gateway's ack
            # before the first member stop. The coordinator rides the RAW
            # store: instance heartbeats/acks are gateway-owned liveness
            # records, not fenced control-plane state
            self.job_svc.drain_coordinator = DrainCoordinator(
                raw_kv, heartbeat_s=cfg.gateway_heartbeat_s)
            self.job_svc.drain_deadline_s = cfg.gateway_drain_deadline_s
        # bounded history (service/compactor.py): a writer loop — started
        # leader-only in _start_writers — trimming version records past
        # history_retention_versions plus settled admission/marker garbage
        self.compactor = None
        if cfg.history_retention_versions > 0:
            from tpu_docker_api_torch.service.compactor import HistoryCompactor

            self.compactor = HistoryCompactor(
                self.kv, self.store,
                maps=[(keys.Resource.CONTAINERS, self.container_versions),
                      (keys.Resource.VOLUMES, self.volume_versions),
                      (keys.Resource.JOBS, self.job_versions),
                      (keys.Resource.SERVICES, self.service_versions),
                      (keys.Resource.WORKFLOWS, self.workflow_versions)],
                retention=cfg.history_retention_versions,
                runtime=self.runtime, pod=self.pod, work_queue=self.wq,
                interval_s=cfg.history_compact_interval_s,
                registry=self.metrics,
                # trim under the same family locks the API flows hold, so
                # GC can never race a rollback/replace mid-read
                locks={keys.Resource.CONTAINERS:
                       self.container_svc.family_lock,
                       keys.Resource.JOBS: self.job_svc.family_lock},
                tracer=self.tracer,
                owns=self._owns_or_none(),
                store_gate=store_gate,
            )
        # constructed here (not in start) so the router always has the
        # instance regardless of role: on an HA standby the watcher exists
        # but only STARTS when the lease is acquired
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
        if cfg.leader_election and self.shard_plane is None:
            import os
            import socket

            from tpu_docker_api_torch.service.leader import LeaderElector

            holder = cfg.leader_id or f"{socket.gethostname()}:{os.getpid()}"
            elector_kwargs = {}
            if self._injected_leader_clock is not None:
                elector_kwargs["clock"] = self._injected_leader_clock
            # the elector rides the RAW store: its lease writes carry their
            # own CAS guards (fencing the epoch bump on the epoch it
            # replaces would be circular)
            self.leader_elector = LeaderElector(
                raw_kv, holder_id=holder, ttl_s=cfg.leader_ttl_s,
                renew_interval_s=cfg.leader_renew_interval_s or None,
                on_acquire=lambda epoch: self._start_writers(),
                on_loss=lambda reason: self._stop_writers(),
                advertise=f"{self.host}:{cfg.port}",
                **elector_kwargs,
            )

    def _reload_caches(self) -> None:
        """Re-read every stateful mirror (version maps, slice registry +
        cordons, per-host chip/port maps — the local host's schedulers are
        shared with the pod, so the host walk covers them)."""
        for vm in (self.container_versions, self.volume_versions,
                   self.job_versions, self.service_versions,
                   self.workflow_versions):
            vm.reload_from_store()
        self.pod_scheduler.reload_from_store()
        for host in self.pod.hosts.values():
            host.chips.reload_from_store()
            host.ports.reload_from_store()

    def _on_store_recover(self) -> None:
        """StoreHealth outage→healthy hook (fires on the thread whose op
        proved the heal — must stay cheap and non-blocking): mark every
        family dirty and cut the writer loops' intervals short. The actual
        repair work — informer relist, journal replay, drift sweep — rides
        the loops' own threads."""
        self.reconciler.mark_all_dirty("store-recovered")
        self.job_supervisor.wake()

    def _owns_or_none(self):
        """Family-ownership filter handed to the writer loops: None in
        unsharded mode (loops visit everything, today's behavior), else
        the plane's lock-free owns() check."""
        return None if self.shard_plane is None else self.shard_plane.owns

    def _task_shard(self, kind: str, params: dict) -> int:
        """WorkQueue shard classifier: journal a task under the shard
        owning the family it mutates. Family-less tasks (raw put_kv) are
        classified by their target key; anything global lands on shard 0,
        the singleton-of-last-resort."""
        base = params.get("base")
        if base:
            return self.shard_map.shard_of(base)
        key = params.get("key")
        if key:
            shard = self.shard_map.shard_of_key(key)
            return 0 if shard is None else shard
        return 0

    def _on_shard_acquire(self, shard: int, epoch: int) -> None:
        """Shard-portfolio takeover. Per shard: reseed that shard's
        version maps, drop its journal seq cache, then adopt + replay its
        journal via a reconcile pass (exactly-once: markers + CAS claims,
        same machinery as single-leader failover). Process-wide: the
        writer loops start once, on the FIRST shard acquired — each loop
        filters its families through plane.owns, so one set of threads
        serves however many shards this process holds. Shard 0 is the
        singleton-of-last-resort: its holder also runs the host monitor
        and health watcher."""
        with self._shard_mu:
            for vm in (self.container_versions, self.volume_versions,
                       self.job_versions, self.service_versions,
                       self.workflow_versions):
                vm.reload_shard(shard)
            self.wq.reset_shard_cache(shard)
            self.admission.reset_seq_cache()
            # global singletons (schedulers, cordons) may have moved under
            # other shard leaders — or an earlier deployment — while we
            # did not hold this slice; every acquire adopts keyspace we
            # may never have observed, so reseed on every acquire
            self.pod_scheduler.reload_from_store()
            for host in self.pod.hosts.values():
                host.chips.reload_from_store()
                host.ports.reload_from_store()
            if not self._shard_writers_on:
                self.wq.start()
                if self.cfg.reconcile_interval > 0:
                    self.reconciler.start_periodic(self.cfg.reconcile_interval)
                if self.cfg.job_supervise_interval > 0:
                    self.job_supervisor.start()
                if (self.cfg.admission_enabled
                        and self.cfg.admission_interval_s > 0):
                    self.admission.start()
                if self.cfg.autoscale_interval_s > 0:
                    self.serving.start()
                if self.cfg.workflow_interval_s > 0:
                    self.workflow.start()
                if self.compactor is not None:
                    self.compactor.start()
                self._shard_writers_on = True
            if shard == 0:
                if self.host_monitor is not None:
                    self.host_monitor.start()
                if self.health_watcher is not None:
                    self.health_watcher.start()
        if self.cfg.reconcile_on_start:
            # journal-ownership handoff for THIS shard: the reconcile pass
            # replays the dead leader's pending records (owns-filtered, so
            # it touches only families of shards we now hold). Outside the
            # mutex — a long repair must not block another shard's
            # elector callback
            try:
                report = self.reconciler.reconcile()
                if report["actions"]:
                    log.warning(
                        "shard %d takeover reconcile repaired %d drift(s): %s",
                        shard, report["driftCount"],
                        [a["action"] for a in report["actions"]])
            except Exception:  # noqa: BLE001
                log.exception("shard %d takeover reconcile failed; serving "
                              "anyway (rerun via /api/v1/reconcile)", shard)

    def _on_shard_loss(self, shard: int, reason: str) -> None:
        """Blast-radius containment, the loss side: losing ONE shard's
        lease only narrows plane.owns — the loops keep running for the
        shards still held. Only losing the LAST shard stops the writer
        role (and losing shard 0 stops the singletons it carries)."""
        with self._shard_mu:
            if shard == 0:
                if self.host_monitor is not None:
                    self.host_monitor.close()
                if self.health_watcher is not None:
                    self.health_watcher.close()
            still = self.shard_plane.held - {shard}
            if self._shard_writers_on and not still:
                self._shard_writers_on = False
                if self.compactor is not None:
                    self.compactor.close()
                self.workflow.close()
                self.serving.close()
                self.admission.close()
                self.job_supervisor.close()
                self.reconciler.close()
                self.wq.close()

    def _engine_pool_series(self, key: str) -> list[tuple[dict, float]]:
        """Per-engine connection-pool stat series for /metrics: one
        ``{endpoint=...}`` sample per DISTINCT engine (dedupe by runtime
        identity — the local dockerd backs several PodHost entries once).
        The endpoint label value is the sorted host-id set the engine
        serves, so cardinality is bounded by pod size and a shared
        engine renders as ONE series, never double-counted."""
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

    def _fence_guards(self) -> list:
        """Fence closure for the FencedKV wrapper (leader_election only):
        empty until the elector first acquires, then the acquired epoch."""
        elector = getattr(self, "leader_elector", None)
        return [] if elector is None else elector.fence_guards()

    def _standby_reads_active(self) -> bool:
        """InformerReadKV's role predicate: serve reads from the mirror
        only while STANDING BY. The leader's own maps are authoritative
        (every write is local), and the leadership-handoff cache reload in
        _start_writers must read the real store — is_leader flips True
        before on_acquire fires, so those reloads pass through here."""
        elector = getattr(self, "leader_elector", None)
        return elector is not None and not elector.is_leader

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

    def _start_writers(self) -> None:
        """The writer role: every subsystem that MUTATES shared state.
        Single-process deployments run this unconditionally in start();
        in an HA fleet (leader_election = true) exactly one replica runs
        it at a time — on lease acquire — and halts it on loss, so the
        invariants the chaos suite proves survive N daemons sharing one
        store."""
        if self.leader_elector is not None:
            # leadership handoff, step one: re-seed every in-memory KV
            # mirror from the store. This replica may have booted long
            # before the dead leader's last write — supervising gangs or
            # sweeping leaks against boot-time scheduler/version snapshots
            # would re-allocate claimed GPUs and "repair" healthy state
            self._reload_caches()
        self.wq.start()
        if self.cfg.reconcile_on_start:
            # repair whatever a previous incarnation left half-done BEFORE
            # serving traffic (an interrupted rolling replace must not be
            # visible as two live versions) — under leader election this is
            # also the journal-ownership handoff: the new leader adopts and
            # replays the dead one's pending records here. A failed sweep
            # must not block boot — a recovery feature that crash-loops the
            # daemon is worse than the drift it would repair
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
            # placement) — a writer like the supervisor, leader-only in
            # an HA fleet
            self.admission.start()
        if self.cfg.autoscale_interval_s > 0:
            # the autoscaler mutates shared state (replica gangs, service
            # records) — a writer like the admission loop, leader-only in
            # an HA fleet
            self.serving.start()
        if self.cfg.workflow_interval_s > 0:
            # the DAG engine mutates shared state (step gangs, workflow
            # records) — a writer like the autoscaler, leader-only in an
            # HA fleet
            self.workflow.start()
        if self.compactor is not None:
            # history compaction deletes shared state — a writer like the
            # loops above, leader-only in an HA fleet
            self.compactor.start()

    def _stop_writers(self) -> None:
        """Halt the writer role (lease loss, shutdown). Every close is
        guarded and restartable: a later re-acquire calls _start_writers
        again on the same instances."""
        if getattr(self, "compactor", None) is not None:
            self.compactor.close()
        if getattr(self, "workflow", None) is not None:
            self.workflow.close()
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
        if self.informer is not None:
            # the mirror warms on BOTH roles (a demoted leader must serve
            # cached reads immediately, not after a cold list) and before
            # the elector, so a standby's first GETs can already hit it;
            # until the initial list lands, reads fall through to the store
            self.informer.start()
        if self.reconcile_informer is not None:
            # the dirty-feed reflector warms on both roles too: a standby
            # promoted later must not start its first dirty passes from a
            # cold, everything-is-dirty state
            self.reconcile_informer.start()
        if self.gateway_informer is not None:
            # dedicated routing-table feed (only when no shared informer
            # exists): the gateway serves traffic on every role, so its
            # table warms unconditionally
            self.gateway_informer.start()
        if self.leader_elector is None and self.shard_plane is None:
            # single-process: writers start unconditionally, as always
            self._start_writers()
        router = build_router(
            self.container_svc, self.volume_svc,
            self.chip_scheduler, self.port_scheduler, work_queue=self.wq,
            health_watcher=self.health_watcher, metrics=self.metrics,
            job_svc=self.job_svc, pod_scheduler=self.pod_scheduler,
            reconciler=self.reconciler, job_supervisor=self.job_supervisor,
            host_monitor=self.host_monitor,
            leader_elector=self.leader_elector,
            shard_plane=self.shard_plane,
            informer=self.informer,
            fanout=self.fanout,
            admission=self.admission,
            serving=self.serving,
            workflow_svc=self.workflow,
            compactor=self.compactor,
            gateway=self.gateway,
            store_health=self.store_health,
            list_default_limit=self.cfg.list_default_limit,
            list_max_limit=self.cfg.list_max_limit,
            tracer=self.tracer,
        )
        bi = build_info()  # warm the git probe BEFORE serving /healthz
        self.api_server = ApiServer(router, host=self.host, port=self.cfg.port)
        self.api_server.start()
        if self.gateway_server is not None:
            # serving ingress on its own listener — starts after the
            # control-plane API so /healthz can already name the gateway
            self.gateway_server.start()
            log.info("gateway %s serving on %s:%d",
                     self.gateway.instance_id, self.host,
                     self.gateway_server.port)
        if self.leader_elector is not None:
            # serving is up (reads + 503-with-hint on mutations) BEFORE the
            # election begins: a standby is useful from its first second
            self.leader_elector.start()
        if self.shard_plane is not None:
            # same contract per shard: the process answers reads and
            # wrong-shard 503s before contesting any lease
            self.shard_plane.start()
        log.info("tpu-docker-api (torch) %s (%s@%s) serving on %s:%d "
                 "(%d GPUs, ports %d-%d)%s",
                 bi["version"], bi["branch"], bi["commit"],
                 self.host, self.api_server.port,
                 self.chip_scheduler.topology.n_chips,
                 self.cfg.start_port, self.cfg.end_port,
                 " [leader election enabled]"
                 if self.leader_elector is not None else "")

    def stop(self) -> None:
        """Shutdown — tolerant of a partially-completed init (every subsystem
        access is guarded), so a failed boot reports its root cause instead
        of masking it with an AttributeError during cleanup."""
        if getattr(self, "gateway_server", None) is not None:
            # the ingress goes first: stop accepting serving traffic (and
            # deregister this instance's heartbeat so drains stop waiting
            # on it) before the control plane dismantles anything
            self.gateway_server.close()
        if getattr(self, "gateway_informer", None) is not None:
            self.gateway_informer.close()
        if getattr(self, "api_server", None) is not None:
            self.api_server.close()
        if getattr(self, "leader_elector", None) is not None:
            # graceful: release the lease so the standby takes over NOW
            # instead of waiting out the TTL (the epoch key stays put —
            # fencing monotonicity)
            self.leader_elector.close(release=True)
        if getattr(self, "shard_plane", None) is not None:
            # same, per shard: every held lease is released so the
            # survivors take over immediately
            self.shard_plane.close(release=True)
        if getattr(self, "informer", None) is not None:
            self.informer.close()
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
            # reboot contract: no daemon ends with open spans — whatever a
            # dying flow left open closes as status="lost"
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
