"""Process configuration.

Parity: the reference's 6-field TOML config (``internal/config/config.go:9-24``,
defaults in ``etc/config.toml``). The port's copy of
``tpu_docker_api/config.py``: the same keys, defaults and TOML parsing, read
by ``python -m tpu_docker_api_torch -c cfg.toml``. The GPU count is an
accelerator type (``h100-8``: a generation and a per-host GPU count),
``detect_tpu_addr`` (the JAX key's name) is the gpu-detect sidecar's address.

The port has the single-host container path with its reconciler, fan-out,
store-health machine and etcd store. A key that turns on a feature the
port lacks fails :func:`load` with a ValueError naming the key and ROADMAP
Queue 1 item 10 (``_NOT_PORTED``). Where JAX's default turns such a feature
on, the port's default is off (``job_supervise_interval``,
``host_probe_interval_s``, ``autoscale_interval_s``,
``workflow_interval_s``), and ``accelerator_type`` defaults to ``h100-8``. One key is the port's own:
``fake_runtime_root``.
"""

from __future__ import annotations

import dataclasses

try:
    import tomllib  # Python >= 3.11
except ModuleNotFoundError:  # pragma: no cover — 3.10 containers
    import tomli as tomllib


@dataclasses.dataclass
class Config:
    # HTTP serve address, reference `Port` (config.go:10)
    port: int = 2378
    # state store: "memory" | "sqlite" | "etcd"
    store_backend: str = "memory"
    # etcd grpc-gateway address (used when store_backend == "etcd"),
    # reference `EtcdAddr` (config.go:11)
    etcd_addr: str = "http://localhost:2379"
    # sqlite database path (used when store_backend == "sqlite")
    sqlite_path: str = "/var/lib/tpu-docker-api/state.db"
    # gpu-detect sidecar address, reference `DetectGPUAddr` (config.go:12);
    # empty ⇒ local NVML probe via tpu_docker_api_torch.telemetry
    detect_tpu_addr: str = ""
    # accelerator type of this host when neither the sidecar nor NVML
    # answers, e.g. "h100-8"; replaces the reference's bare
    # `AvailableGpuNums` (config.go:13). JAX's default is "v5e-8"
    accelerator_type: str = "h100-8"
    # host port pool, reference `StartPort`/`EndPort` (config.go:14-15)
    start_port: int = 40000
    end_port: int = 65535
    # container runtime: "docker" | "fake"
    runtime_backend: str = "docker"
    # docker engine socket (runtime_backend == "docker")
    docker_host: str = "unix:///var/run/docker.sock"
    # the port's own: where the fake runtime (runtime_backend == "fake")
    # keeps its containers' and volumes' directories. Set, it also keeps
    # each object's record there, so a restarted daemon finds the engine
    # state a real engine would still hold. "" ⇒ a fresh temp dir (JAX)
    fake_runtime_root: str = ""
    # runtime fan-out (runtime/fanout.py): max concurrent engine calls per
    # multi-member batch — gang create/start/stop/remove, host probes,
    # liveness scans, reconciler scrubs. 1 (the default) is byte-for-byte
    # the old serial loops; raise toward the pod's host count on
    # multi-host pods so lifecycle wall time is O(slowest host) not
    # O(sum). Must be >= 1.
    fanout_workers: int = 1
    # keep-alive connection pool per docker engine: max IDLE sockets
    # retained (concurrent demand beyond this still opens fresh
    # connections; only retention is bounded). 0 disables reuse.
    engine_pool_size: int = 4
    # JAX's path to libtpu.so for TPU containers: no GPU counterpart, so
    # only "" is accepted
    libtpu_path: str = ""
    # health watcher (service/watch.py): poll interval; 0 disables the watcher
    health_watch_interval: float = 5.0
    # startup reconcile (service/reconcile.py): sweep KV desired state vs
    # runtime actual state before serving — repairs drift left by a crash
    reconcile_on_start: bool = True
    # periodic reconcile interval; 0 disables the background sweep (the
    # startup pass still runs when reconcile_on_start is true)
    reconcile_interval: float = 0.0
    # event-driven reconcile (service/reconcile.py DirtySet): > 0 turns
    # periodic passes O(changes) — a watch-fed dirty-set of family base
    # names decides what each pass visits, and the full O(objects) scan is
    # demoted to an anti-entropy pass at most every this many seconds
    # (out-of-band runtime drift like a manual `docker rm` emits no KV
    # event, so the full pass must survive — just rarely). 0 (default)
    # keeps every pass a full scan, byte-for-byte today's behavior.
    reconcile_full_interval_s: float = 0.0
    # bounded history (service/compactor.py): keep at most this many
    # version records per resource family — the latest pointer's version
    # and any version a live runtime member still references are NEVER
    # trimmed regardless of age. 0 (default) disables compaction
    # (unbounded history, today's behavior). >= 2 recommended: a rolling
    # replace briefly references latest-1.
    history_retention_versions: int = 0
    # compaction cadence (a writer: leader-only under leader_election)
    history_compact_interval_s: float = 60.0
    # list pagination (state/pager.py): limit applied when a list request
    # names none (0 = unlimited full scan, the legacy shape) and the hard
    # cap a request's ?limit is clamped to
    list_default_limit: int = 0
    list_max_limit: int = 5000
    # "none" (observe only) | "on-failure" (bounded auto-restart)
    restart_policy: str = "none"
    # per-container restart backoff (service/watch.py): base seconds between
    # automatic restarts, doubled per attempt up to the max; 0 = immediate
    # restarts (the pre-backoff behavior)
    restart_backoff_s: float = 1.0
    restart_backoff_max_s: float = 30.0
    # gang supervisor (service/job_supervisor.py): member-liveness poll
    # interval over all pod hosts; 0 disables supervision
    # (JAX: 5.0; the port has no job supervisor yet)
    job_supervise_interval: float = 0.0
    # whole-gang restarts before a crash-looping job goes terminal "failed"
    job_max_restarts: int = 3
    # exponential backoff between gang restarts: base·2^n seconds, clamped
    # to the max, ±jitter fraction so gangs don't restart in lockstep
    job_backoff_base_s: float = 1.0
    job_backoff_max_s: float = 60.0
    job_backoff_jitter: float = 0.1
    # host failure domains (service/host_health.py): engine-probe interval
    # over every pod host; 0 disables the monitor — and with it automatic
    # host-down detection / gang migration, the drain route, and
    # GET /api/v1/health/hosts; cordon/uncordon (pure scheduler state)
    # keep working
    # (JAX: 5.0; the port has no host monitor yet)
    host_probe_interval_s: float = 0.0
    # continuous probe failure longer than this confirms a host "down"
    # (scheduler stops placing, gangs migrate off); anything shorter is a
    # blip and causes ZERO restarts
    host_down_grace_s: float = 15.0
    # circuit breaker around each non-local host engine: consecutive
    # connection failures before it opens (open ⇒ calls fast-fail instead
    # of hanging on a dead socket); 0 disables the breakers
    breaker_threshold: int = 3
    # host-fault migrations before a job goes terminal "failed" — a budget
    # SEPARATE from job_max_restarts, so dead hosts never eat the
    # crash-restart budget (and crash loops never eat this one)
    job_max_migrations: int = 3
    # elastic gangs (docs/robustness.md "Elastic gangs"): when true, jobs
    # submitted with elastic=true SHRINK to their surviving hosts on host
    # loss / drain / partial preemption (never below minMembers) and grow
    # back through the admission queue, instead of migrating whole or
    # dying. False disables every automatic resize decision (supervisor,
    # drain, admission) — non-elastic jobs behave identically either way.
    job_resize_enabled: bool = True
    # attempts of ONE resize before adoption gives up on a thrashing gang
    # (terminal "failed") — a loop bound for crash-adoption retries, not
    # a policy budget: it reads last_resize.attempts, never the lifetime
    # resize counter, so a long-lived elastic gang's normal shrink/grow
    # history can never trip it
    job_resize_max: int = 8
    # durable work queue (state/workqueue.py): how long a producer (API
    # thread) may block on a full queue before the typed QueueSaturated
    # error (HTTP 429) — never forever
    queue_submit_timeout_s: float = 5.0
    # shutdown drain deadline: close() waits this long for the sync loop to
    # finish the backlog, then abandons it — journaled records replay under
    # the next daemon, so a hung engine can't block shutdown indefinitely
    queue_close_deadline_s: float = 10.0
    # store-outage tolerance (EtcdKV): idempotent READS retry up to
    # store_retry_attempts times with capped exponential backoff
    # (base·2^n clamped to max) before raising the typed StoreUnavailable;
    # writes are normalized but never blind-retried
    store_retry_attempts: int = 3
    store_retry_base_s: float = 0.05
    store_retry_max_s: float = 1.0
    # per-op store deadline (state/kv.py): bounds EVERY store round trip —
    # the EtcdKV socket timeout, the SqliteKV busy wait — so a hung store
    # surfaces as a typed StoreUnavailable instead of a wedged thread.
    # 0 (default) keeps each backend's historical timeout byte-for-byte
    store_op_deadline_s: float = 0.0
    # store brownout machine (service/store_health.py, docs/robustness.md
    # "Store brownouts"): consecutive StoreUnavailable failures before
    # healthy → degraded (blips below the threshold cause zero mode flips) …
    store_health_fail_threshold: int = 3
    # … continuous failure past the threshold for this long ⇒ outage
    # (mutations fail fast 503, reads serve stale, writer loops hold) …
    store_health_outage_grace_s: float = 2.0
    # … and while in outage, one probe mutation per interval is admitted
    # through so a healed store is re-detected even without elector traffic
    store_health_probe_interval_s: float = 1.0
    # HA control plane (service/leader.py): when true, this daemon is one
    # replica of a fleet sharing the state store — API serving is always-on,
    # but the writer subsystems (work-queue sync loop, reconciler, job
    # supervisor, host monitor, health watcher) run only while this replica
    # holds the leader lease; standbys serve reads and answer mutations
    # with 503 + a leader hint. False (the default) keeps today's
    # single-process behavior exactly: no lease, no fencing, writers start
    # unconditionally.
    leader_election: bool = False
    # lease time-to-live: a dead leader's lease is stealable this long
    # after its last renewal — the failover ceiling
    leader_ttl_s: float = 15.0
    # heartbeat renewal interval; 0 ⇒ ttl/3 (renew well inside the TTL so
    # one missed heartbeat never costs the lease)
    leader_renew_interval_s: float = 0.0
    # identity in the lease record; "" ⇒ hostname:pid
    leader_id: str = ""
    # sharded writer plane (service/shard.py, docs/robustness.md "Sharded
    # writer plane"; requires leader_election = true when > 1): partition
    # the keyspace into this many shards, each with its own lease + epoch
    # + writer loops, so one lease loss halts <= 1/N of the keyspace
    # instead of every write. 1 (the default) keeps the single-lease
    # plane byte-for-byte — no shard keys, no coordination record.
    shard_count: int = 1
    # shards THIS replica should contest immediately at boot (by id);
    # everything else waits shard_standby_delay_s before contesting a
    # VACANT lease, so a fleet booting together spreads shards instead of
    # the fastest process grabbing all of them. Expired leases are always
    # contested immediately — failover never waits on this.
    shard_preferred: list = dataclasses.field(default_factory=list)
    shard_standby_delay_s: float = 0.0
    # standby read path (state/informer.py; only meaningful with
    # leader_election = true): "informer" (default) serves standby GETs
    # from a watch-fed local mirror — zero store round trips per request,
    # staleness bounded by watch lag — falling back to per-read
    # read-through whenever the informer is unsynced/degraded;
    # "read-through" keeps per-read store re-seeding unconditionally.
    # Leader and single-process read behavior is identical either way.
    read_cache: str = "informer"
    # capacity market (service/admission.py, docs/robustness.md "Capacity
    # market"): when true, a POST /jobs that cannot place is parked in a
    # durable admission queue (phase "queued") instead of hard-failing,
    # higher-priority jobs may preempt strictly-lower-priority gangs, and
    # queued work backfills holes. False (the default) keeps today's
    # first-fit-or-refuse behavior byte-for-byte.
    admission_enabled: bool = False
    # admission-loop tick (a writer: leader-only under leader_election);
    # 0 disables the loop — passes then run only via the reconciler's
    # adoption and explicit admit_once() calls (test/bench hook)
    admission_interval_s: float = 1.0
    # starvation bound for EASY backfill: how many out-of-order admissions
    # may overtake a blocked head-of-queue entry before the queue stalls
    # behind it (the head then places before anything else moves)
    admission_max_skips: int = 4
    # the priority ladder: class name -> weight. Preemption is strictly
    # lower-weight-only, so equal-weight classes never preempt each other.
    # Weights resolve at decision time — retuning takes effect on the next
    # admission pass without rewriting stored JobState.
    priority_class_weights: dict = dataclasses.field(default_factory=lambda: {
        "system": 1000, "production": 100, "batch": 10, "preemptible": 1,
    })
    # class assigned when POST /jobs carries no priorityClass
    priority_class_default: str = "batch"
    # Service resource (service/serving.py, docs/robustness.md "Service &
    # autoscaler"): class assigned when POST /services carries no
    # priorityClass — production by default, so a traffic-driven scale-up
    # outranks batch/preemptible training in the capacity market
    service_default_class: str = "production"
    # autoscaler tick (a writer: leader-only under leader_election);
    # 0 disables the loop — services still converge via the reconciler's
    # adoption and explicit tick() calls (test/bench hook)
    # (JAX: 2.0; the port has no serving service yet)
    autoscale_interval_s: float = 0.0
    # minimum seconds between scale-UPs of one service (a breach inside
    # the window waits; the pending scale-up usually resolves it)
    autoscale_up_cooldown_s: float = 10.0
    # minimum seconds after ANY scale before a scale-DOWN — deliberately
    # longer than up: shedding capacity is cheap to delay, re-acquiring
    # it may need a preemption
    autoscale_down_cooldown_s: float = 30.0
    # hysteresis: scale down only when the worst replica signal sits
    # below watermark x target. The (watermark, 1.0] band is a dead zone,
    # so a signal oscillating around the target never flaps the fleet
    autoscale_down_watermark: float = 0.5
    # control-plane tracing (telemetry/trace.py, docs/observability.md):
    # always-on-sampled span trees from the HTTP handler down to store
    # applies, scheduler claims, lock waits, runtime fan-out and the async
    # queue tail, exported at GET /api/v1/traces. False turns every span
    # site into a no-op (one context-local read) — the churn benchmark
    # gates the disabled-mode cost at <= 1% of the flow p50.
    tracing_enabled: bool = True
    # bounded in-process trace ring: how many recent traces are kept
    # (O(buffer) memory; eviction is normal and counted loudly in
    # trace_dropped_total)
    trace_buffer_size: int = 256
    # slow-trace threshold (ms): a root span slower than this emits a
    # "slow-trace" event into the merged /api/v1/events ring; 0 disables
    trace_slow_ms: float = 0.0
    # L7 serving gateway (service/gateway.py, docs/robustness.md
    # "Serving gateway"): a stateless ingress in front of Service
    # replicas — drain-aware routing, retry/hedge budgets, breakers,
    # outlier ejection and typed load shedding. Off by default: gateway
    # deployments opt in, everything else keeps the direct-to-replica
    # path byte-for-byte.
    gateway_enabled: bool = False
    # gateway listener port; 0 = ephemeral (tests), daemon default 2380
    gateway_port: int = 0
    # end-to-end deadline per proxied request (connect + retries +
    # upstream headers); streams are bounded per-read, not end-to-end
    gateway_request_timeout_s: float = 30.0
    gateway_connect_timeout_s: float = 2.0
    # retries per request (idempotent requests only), and the token
    # budget that bounds retry AMPLIFICATION fleet-wide: each completed
    # request earns `ratio` tokens, each retry spends one
    gateway_retry_limit: int = 2
    gateway_retry_budget_ratio: float = 0.2
    # hedge: fire a second attempt at a different replica when the first
    # byte hasn't arrived within this many ms (0 = off; idempotent only)
    gateway_hedge_ms: float = 0.0
    # per-endpoint circuit breaker: open after N consecutive failures,
    # half-open single-flight probe after the cooldown
    gateway_breaker_threshold: int = 3
    gateway_breaker_cooldown_s: float = 5.0
    # eject an endpoint whose EWMA latency exceeds factor x the fleet
    # median (0 = off); ejection lasts one breaker cooldown
    gateway_outlier_latency_factor: float = 0.0
    # load shedding: global and per-endpoint in-flight caps (typed 429 /
    # skip-in-pick respectively), and the bounded upstream conn pool
    gateway_max_inflight: int = 256
    gateway_max_inflight_per_endpoint: int = 64
    gateway_pool_size: int = 8
    # drain handshake: how long a roll/scale-down/preemption waits for
    # every live gateway to ack zero in-flight before the first member
    # stop, and how often gateways heartbeat/sweep acks
    gateway_drain_deadline_s: float = 10.0
    gateway_heartbeat_s: float = 1.0
    # Workflow resource (service/workflow.py, docs/robustness.md
    # "Workflows"): DAG engine tick (a writer: leader-only under
    # leader_election); 0 disables the loop — workflows still converge via
    # the reconciler's adoption and explicit tick() calls (test/bench hook)
    # (JAX: 2.0; the port has no workflow service yet)
    workflow_interval_s: float = 0.0
    # class assigned when POST /workflows carries no priorityClass —
    # batch by default: pipelines are throughput work, a production
    # serving scale-up should outrank them in the capacity market
    workflow_default_class: str = "batch"
    # per-step retry budget when a step spec carries no maxRetries: failed
    # attempts beyond this settle the WHOLE workflow terminal "failed"
    workflow_max_step_retries: int = 2
    # exponential backoff between step retry attempts: base·2^n seconds,
    # clamped to the max
    workflow_backoff_base_s: float = 0.5
    workflow_backoff_max_s: float = 30.0
    # dead-letter hygiene (state/workqueue.py): how many times one dead
    # record may be revived through POST /api/v1/dead-letters/retry before
    # the typed RetryBudgetExhausted refusal — the count is durable on the
    # record, so the cap survives restarts
    queue_dead_letter_retry_budget: int = 3
    # multi-host pod: [[pod_hosts]] tables, each {host_id, address,
    # grid_coord=[x,y,z], docker_host?, runtime_backend?, local?}. Set
    # local=true on the entry for THIS machine so it shares the container
    # service's runtime/schedulers (one accounting for local chips). Empty ⇒
    # a single-host pod wrapping this host (jobs still work, sub-host slices
    # only). All hosts share accelerator_type.
    pod_hosts: list = dataclasses.field(default_factory=list)


def load(path: str | None = None) -> Config:
    """Load TOML config from ``path``; missing file or None ⇒ all defaults.

    Reference: ``NewConfigWithFile`` (config.go:18-24) errors on a missing
    file; we default instead so the hermetic test path needs no fixture file.
    """
    cfg = Config()
    data: dict = {}
    if path:
        with open(path, "rb") as f:
            data = tomllib.load(f)
        for field in dataclasses.fields(Config):
            if field.name in data:
                setattr(cfg, field.name, data[field.name])
    if cfg.restart_policy not in ("none", "on-failure"):
        raise ValueError(
            f"restart_policy must be 'none' or 'on-failure', "
            f"got {cfg.restart_policy!r}")
    if cfg.read_cache not in ("informer", "read-through"):
        raise ValueError(
            f"read_cache must be 'informer' or 'read-through', "
            f"got {cfg.read_cache!r}")
    if cfg.fanout_workers < 1:
        raise ValueError(
            f"fanout_workers must be >= 1, got {cfg.fanout_workers}")
    if cfg.admission_max_skips < 0:
        raise ValueError(
            f"admission_max_skips must be >= 0, got {cfg.admission_max_skips}")
    if not isinstance(cfg.job_resize_enabled, bool):
        raise ValueError(
            f"job_resize_enabled must be a boolean, "
            f"got {cfg.job_resize_enabled!r}")
    if isinstance(cfg.job_resize_max, bool) \
            or not isinstance(cfg.job_resize_max, int) \
            or cfg.job_resize_max < 1:
        raise ValueError(
            f"job_resize_max must be an integer >= 1, "
            f"got {cfg.job_resize_max!r}")
    if (not isinstance(cfg.priority_class_weights, dict)
            or not cfg.priority_class_weights):
        raise ValueError("priority_class_weights must be a non-empty "
                         "table of class -> integer weight")
    for klass, weight in cfg.priority_class_weights.items():
        if not isinstance(klass, str) or not klass:
            raise ValueError(f"priority class names must be non-empty "
                             f"strings, got {klass!r}")
        if isinstance(weight, bool) or not isinstance(weight, int):
            raise ValueError(f"priority_class_weights[{klass!r}] must be "
                             f"an integer, got {weight!r}")
    if cfg.priority_class_default not in cfg.priority_class_weights:
        raise ValueError(
            f"priority_class_default {cfg.priority_class_default!r} is not "
            f"in priority_class_weights "
            f"{sorted(cfg.priority_class_weights)}")
    if cfg.service_default_class not in cfg.priority_class_weights:
        if "service_default_class" in data:
            raise ValueError(
                f"service_default_class {cfg.service_default_class!r} is "
                f"not in priority_class_weights "
                f"{sorted(cfg.priority_class_weights)}")
        # a custom ladder without "production": the un-set service default
        # follows the job default instead of failing the whole config
        cfg.service_default_class = cfg.priority_class_default
    if cfg.reconcile_full_interval_s < 0:
        raise ValueError(f"reconcile_full_interval_s must be >= 0, "
                         f"got {cfg.reconcile_full_interval_s}")
    if cfg.history_retention_versions < 0:
        raise ValueError(f"history_retention_versions must be >= 0, "
                         f"got {cfg.history_retention_versions}")
    if cfg.history_compact_interval_s <= 0:
        raise ValueError(f"history_compact_interval_s must be > 0, "
                         f"got {cfg.history_compact_interval_s}")
    if cfg.list_max_limit < 1:
        raise ValueError(f"list_max_limit must be >= 1, "
                         f"got {cfg.list_max_limit}")
    if cfg.list_default_limit < 0 or cfg.list_default_limit > cfg.list_max_limit:
        raise ValueError(
            f"list_default_limit must be in [0, list_max_limit], "
            f"got {cfg.list_default_limit} (max {cfg.list_max_limit})")
    if cfg.store_op_deadline_s < 0:
        raise ValueError(f"store_op_deadline_s must be >= 0 (0 = backend "
                         f"default), got {cfg.store_op_deadline_s}")
    if isinstance(cfg.store_health_fail_threshold, bool) \
            or not isinstance(cfg.store_health_fail_threshold, int) \
            or cfg.store_health_fail_threshold < 1:
        raise ValueError(
            f"store_health_fail_threshold must be an integer >= 1, "
            f"got {cfg.store_health_fail_threshold!r}")
    if cfg.store_health_outage_grace_s < 0:
        raise ValueError(f"store_health_outage_grace_s must be >= 0, "
                         f"got {cfg.store_health_outage_grace_s}")
    if cfg.store_health_probe_interval_s <= 0:
        raise ValueError(f"store_health_probe_interval_s must be > 0, "
                         f"got {cfg.store_health_probe_interval_s}")
    if cfg.trace_buffer_size < 1:
        raise ValueError(f"trace_buffer_size must be >= 1, "
                         f"got {cfg.trace_buffer_size}")
    if cfg.trace_slow_ms < 0:
        raise ValueError(f"trace_slow_ms must be >= 0, "
                         f"got {cfg.trace_slow_ms}")
    if isinstance(cfg.shard_count, bool) \
            or not isinstance(cfg.shard_count, int) or cfg.shard_count < 1:
        raise ValueError(
            f"shard_count must be an integer >= 1, got {cfg.shard_count!r}")
    if cfg.shard_count > 1 and not cfg.leader_election:
        raise ValueError(
            "shard_count > 1 requires leader_election = true "
            "(each shard is a lease)")
    if not isinstance(cfg.shard_preferred, list) or any(
            isinstance(i, bool) or not isinstance(i, int)
            or i < 0 or i >= cfg.shard_count
            for i in cfg.shard_preferred):
        raise ValueError(
            f"shard_preferred must be a list of shard ids in "
            f"[0, {cfg.shard_count - 1}], got {cfg.shard_preferred!r}")
    if cfg.shard_standby_delay_s < 0:
        raise ValueError(f"shard_standby_delay_s must be >= 0, "
                         f"got {cfg.shard_standby_delay_s}")
    if not isinstance(cfg.gateway_enabled, bool):
        raise ValueError(f"gateway_enabled must be a boolean, "
                         f"got {cfg.gateway_enabled!r}")
    if isinstance(cfg.gateway_port, bool) \
            or not isinstance(cfg.gateway_port, int) \
            or not 0 <= cfg.gateway_port <= 65535:
        raise ValueError(f"gateway_port must be an integer in [0, 65535], "
                         f"got {cfg.gateway_port!r}")
    if cfg.gateway_request_timeout_s <= 0:
        raise ValueError(f"gateway_request_timeout_s must be > 0, "
                         f"got {cfg.gateway_request_timeout_s}")
    if cfg.gateway_connect_timeout_s <= 0:
        raise ValueError(f"gateway_connect_timeout_s must be > 0, "
                         f"got {cfg.gateway_connect_timeout_s}")
    if isinstance(cfg.gateway_retry_limit, bool) \
            or not isinstance(cfg.gateway_retry_limit, int) \
            or cfg.gateway_retry_limit < 0:
        raise ValueError(f"gateway_retry_limit must be an integer >= 0, "
                         f"got {cfg.gateway_retry_limit!r}")
    if cfg.gateway_retry_budget_ratio < 0:
        raise ValueError(f"gateway_retry_budget_ratio must be >= 0, "
                         f"got {cfg.gateway_retry_budget_ratio}")
    if cfg.gateway_hedge_ms < 0:
        raise ValueError(f"gateway_hedge_ms must be >= 0, "
                         f"got {cfg.gateway_hedge_ms}")
    if isinstance(cfg.gateway_breaker_threshold, bool) \
            or not isinstance(cfg.gateway_breaker_threshold, int) \
            or cfg.gateway_breaker_threshold < 0:
        raise ValueError(
            f"gateway_breaker_threshold must be an integer >= 0, "
            f"got {cfg.gateway_breaker_threshold!r}")
    if cfg.gateway_breaker_cooldown_s < 0:
        raise ValueError(f"gateway_breaker_cooldown_s must be >= 0, "
                         f"got {cfg.gateway_breaker_cooldown_s}")
    if cfg.gateway_outlier_latency_factor < 0:
        raise ValueError(f"gateway_outlier_latency_factor must be >= 0, "
                         f"got {cfg.gateway_outlier_latency_factor}")
    for knob in ("gateway_max_inflight", "gateway_max_inflight_per_endpoint"):
        v = getattr(cfg, knob)
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ValueError(f"{knob} must be an integer >= 1, got {v!r}")
    if isinstance(cfg.gateway_pool_size, bool) \
            or not isinstance(cfg.gateway_pool_size, int) \
            or cfg.gateway_pool_size < 0:
        raise ValueError(f"gateway_pool_size must be an integer >= 0, "
                         f"got {cfg.gateway_pool_size!r}")
    if cfg.gateway_drain_deadline_s < 0:
        raise ValueError(f"gateway_drain_deadline_s must be >= 0, "
                         f"got {cfg.gateway_drain_deadline_s}")
    if cfg.gateway_heartbeat_s <= 0:
        raise ValueError(f"gateway_heartbeat_s must be > 0, "
                         f"got {cfg.gateway_heartbeat_s}")
    if cfg.autoscale_interval_s < 0:
        raise ValueError(f"autoscale_interval_s must be >= 0, "
                         f"got {cfg.autoscale_interval_s}")
    if cfg.workflow_interval_s < 0:
        raise ValueError(f"workflow_interval_s must be >= 0, "
                         f"got {cfg.workflow_interval_s}")
    if cfg.workflow_default_class not in cfg.priority_class_weights:
        if "workflow_default_class" in data:
            raise ValueError(
                f"workflow_default_class {cfg.workflow_default_class!r} is "
                f"not in priority_class_weights "
                f"{sorted(cfg.priority_class_weights)}")
        # a custom ladder without "batch": the un-set workflow default
        # follows the job default instead of failing the whole config
        cfg.workflow_default_class = cfg.priority_class_default
    if isinstance(cfg.workflow_max_step_retries, bool) \
            or not isinstance(cfg.workflow_max_step_retries, int) \
            or cfg.workflow_max_step_retries < 0:
        raise ValueError(
            f"workflow_max_step_retries must be an integer >= 0, "
            f"got {cfg.workflow_max_step_retries!r}")
    if cfg.workflow_backoff_base_s < 0:
        raise ValueError(f"workflow_backoff_base_s must be >= 0, "
                         f"got {cfg.workflow_backoff_base_s}")
    if cfg.workflow_backoff_max_s < cfg.workflow_backoff_base_s:
        raise ValueError(
            f"workflow_backoff_max_s must be >= workflow_backoff_base_s, "
            f"got {cfg.workflow_backoff_max_s} < "
            f"{cfg.workflow_backoff_base_s}")
    if isinstance(cfg.queue_dead_letter_retry_budget, bool) \
            or not isinstance(cfg.queue_dead_letter_retry_budget, int) \
            or cfg.queue_dead_letter_retry_budget < 1:
        raise ValueError(
            f"queue_dead_letter_retry_budget must be an integer >= 1, "
            f"got {cfg.queue_dead_letter_retry_budget!r}")
    if cfg.autoscale_up_cooldown_s < 0 or cfg.autoscale_down_cooldown_s < 0:
        raise ValueError("autoscale cooldowns must be >= 0")
    if not 0 < cfg.autoscale_down_watermark <= 1:
        raise ValueError(
            f"autoscale_down_watermark must be in (0, 1], "
            f"got {cfg.autoscale_down_watermark}")
    _refuse_not_ported(cfg)
    return cfg


#: (key, test that the value turns the feature on, what the port lacks)
_NOT_PORTED = (
    ("shard_count", lambda v: v > 1, "the sharded writer plane "
     "(service/shard.py)"),
    ("leader_election", bool, "leader election (service/leader.py)"),
    ("pod_hosts", bool, "multi-host pods (scheduler/pod.py)"),
    ("job_supervise_interval", lambda v: v > 0,
     "the job supervisor (service/job_supervisor.py)"),
    ("host_probe_interval_s", lambda v: v > 0,
     "the host monitor (service/host_health.py)"),
    ("admission_enabled", bool, "admission (service/admission.py)"),
    ("autoscale_interval_s", lambda v: v > 0,
     "the serving service (service/serving.py)"),
    ("workflow_interval_s", lambda v: v > 0,
     "the workflow service (service/workflow.py)"),
    ("gateway_enabled", bool, "the gateway (service/gateway.py)"),
    ("history_retention_versions", lambda v: v > 0,
     "the history compactor (service/compactor.py)"),
)


def _refuse_not_ported(cfg: Config) -> None:
    """Fail the boot on a feature the port lacks, naming the key
    (the serve CLI's ``_NOT_PORTED`` pattern)."""
    for key, turns_on, what in _NOT_PORTED:
        value = getattr(cfg, key)
        if turns_on(value):
            raise ValueError(
                f"{key} = {value!r}: {what} is not ported to "
                "tpu_docker_api_torch yet (ROADMAP Queue 1 item 10)")
    if cfg.libtpu_path:
        raise ValueError(
            f"libtpu_path = {cfg.libtpu_path!r}: a TPU key with no GPU "
            "counterpart; a GPU is attached by UUID")
