"""Fault-tolerant L7 serving gateway: the component that accepts a user request and lands it on a
live replica — and keeps doing so while the control plane rolls, scales,
preempts and loses hosts underneath it.

Three cooperating pieces:

- :class:`RoutingTable` — the watch-fed endpoint view. Fed by an
  informer (state/informer.py) over the jobs + services subtrees, it
  folds each replica gang's ``JobState`` (phase, ``draining``,
  ``desired_running``, coordinator placement) and its owning service
  into per-service endpoint lists. ZERO store reads per routed request:
  every pick is a dict lookup against the mirror-fed table.

- :class:`Gateway` — the routing/failure engine behind the listener
  (api/gateway_app.py). Per request: prefix-affine rendezvous hashing
  (repeated prompt prefixes land on the replica already holding the
  pages — infer/paged.py ``register_prefix``), else
  least-loaded over live SLO signals (the SAME per-replica scrape the
  autoscaler decides on — one set of books); per-endpoint circuit
  breakers with single-flight half-open probes; latency-outlier
  ejection; idempotent-only retry budgets with jittered backoff
  (utils/backoff.py); optional hedged requests racing to first byte;
  bounded per-endpoint connection pools (runtime/docker_http.py's
  ``_ConnectionPool`` over TCP) and typed 429/503 + Retry-After load shedding; chunked
  streaming passthrough whose mid-stream upstream death surfaces as a
  typed truncation line, never a silent EOF.

- :class:`DrainCoordinator` — the control-plane half of the drain
  handshake. Gateways heartbeat instance records and, once a family's
  durable ``draining`` marker is visible AND their in-flight count to it
  hits zero, write a per-family ack key. ``JobService._predrain`` waits
  (deadline-bounded) for every live instance's ack before the first
  member stop — so a roll, an autoscale scale-down or a preemption
  finishes in-flight streams instead of dropping them. Zero live
  gateways ⇒ vacuously drained (non-gateway deployments never block).

The port's copy of ``tpu_docker_api/service/gateway.py``, whole: the same
keys, acks, scores and status views, so a store one package's gateways
acked in reads the same in the other's.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import threading
import time
import uuid
from typing import Callable

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.docker_http import _ConnectionPool
from tpu_docker_api_torch.schemas.service import owner_from_env
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry
from tpu_docker_api_torch.utils.backoff import backoff_delay_s

log = logging.getLogger(__name__)

#: response headers that must never be relayed verbatim (hop-by-hop, or
#: owned by the gateway's own framing)
_HOP_HEADERS = frozenset((
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailers", "transfer-encoding", "upgrade", "content-length",
))

#: upstream TTFB histogram buckets (milliseconds)
_TTFB_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                 10000, 30000)


class _NoEndpoint(Exception):
    """Internal: a pick found nothing routable for this attempt."""


class UpstreamConnectError(Exception):
    """Connection-level upstream failure (refused/reset/timeout before a
    complete response arrived) — retryable for idempotent requests."""

    def __init__(self, endpoint: str, exc: BaseException) -> None:
        super().__init__(f"upstream {endpoint}: {type(exc).__name__}: {exc}")
        self.endpoint = endpoint
        self.exc = exc


class UpstreamHTTPError(Exception):
    """A complete upstream reply that counts as a failure (5xx, or the
    replica's own 429/503 shed). Retryable; when the budget runs out the
    caller surfaces THIS status+body verbatim — never a generic 502."""

    def __init__(self, endpoint: str, status: int, headers: list,
                 body: bytes) -> None:
        super().__init__(f"upstream {endpoint}: HTTP {status}")
        self.endpoint = endpoint
        self.status = status
        self.headers = headers
        self.body = body


class Endpoint:
    """One replica family's folded routing view + live failure state.

    Table fields (``family`` .. ``version``) are rewritten wholesale on
    every informer event; the runtime failure state (breaker, EWMA,
    in-flight) survives table updates for the SAME address and resets
    when the address changes (a rolled replica is a new server — its
    predecessor's sins don't transfer)."""

    def __init__(self, family: str) -> None:
        self.family = family
        self.service = ""
        self.host_id = ""
        self.address = ""
        self.port = 0
        self.version = -1
        self.routable = False      # running, desired, not draining
        self.draining = False      # durable marker (or preempted flip)
        self.phase = ""
        # -- live failure state (lock = the table's lock) --
        self.inflight = 0
        #: bumps on every reset_runtime — a rolled/re-placed replica is a
        #: NEW server, and attempts still in flight against the old one
        #: are "lame": they must land before a roll can be acked
        self.generation = 0
        self.gen_inflight: dict[int, int] = {}
        self.acked_generation = 0
        self.consecutive_failures = 0
        self.breaker_open_since: float | None = None
        self.half_open_probe = False   # single-flight probe in flight
        self.ewma_ms: float | None = None
        self.samples = 0
        self.ejected_until = 0.0
        self.pool: _ConnectionPool | None = None

    def lame_inflight(self) -> int:
        """Attempts still in flight against superseded generations."""
        return sum(n for g, n in self.gen_inflight.items()
                   if g < self.generation)

    def reset_runtime(self) -> None:
        self.generation += 1
        self.consecutive_failures = 0
        self.breaker_open_since = None
        self.half_open_probe = False
        self.ewma_ms = None
        self.samples = 0
        self.ejected_until = 0.0
        if self.pool is not None:
            self.pool.clear()

    def view(self) -> dict:
        breaker = "closed"
        if self.breaker_open_since is not None:
            breaker = "half-open" if self.half_open_probe else "open"
        return {
            "family": self.family, "service": self.service,
            "address": f"{self.address}:{self.port}",
            "version": self.version, "phase": self.phase,
            "routable": self.routable, "draining": self.draining,
            "inFlight": self.inflight,
            "generation": self.generation,
            "lameInFlight": self.lame_inflight(),
            "consecutiveFailures": self.consecutive_failures,
            "breaker": breaker,
            "ewmaMs": (round(self.ewma_ms, 3)
                       if self.ewma_ms is not None else None),
            "ejected": self.ejected_until > time.monotonic(),
            "pool": self.pool.view() if self.pool is not None else None,
        }


class RoutingTable:
    """Informer-fed replica endpoint table (zero store reads per pick).

    Folds every ``{PREFIX}/jobs/<service>.r<i>/...`` version record and
    latest pointer into one :class:`Endpoint` per replica family: the
    LATEST version's phase/draining/placement wins, resolved entirely
    from watch events. Service records are folded too so endpoints know
    their owner even before the env marker is visible (and so deleted
    services drop their whole fleet)."""

    def __init__(self, resolve_addr: Callable[[str], str | None],
                 registry: MetricsRegistry | None = None,
                 on_change: Callable[[str], None] | None = None) -> None:
        self._resolve_addr = resolve_addr
        self._registry = registry if registry is not None \
            else MetricsRegistry()
        #: called with the FAMILY base after any fold that changed it —
        #: the gateway hooks drain-ack sweeps here
        self._on_change = on_change
        self._mu = threading.RLock()
        #: family base → {version: raw JobState dict}
        self._job_versions: dict[str, dict[int, dict]] = {}
        #: family base → latest pointer value
        self._latest: dict[str, int] = {}
        self._endpoints: dict[str, Endpoint] = {}
        self._jobs_prefix = keys.PREFIX + "/jobs/"

    # -- informer feed -------------------------------------------------------------

    def attach(self, informer) -> None:
        """Register fold handlers. Call BEFORE ``informer.start()`` so
        the initial list's synthetic diff events seed the table."""
        informer.register(self._jobs_prefix, self._observe_job)

    def _parse_job_key(self, key: str) -> tuple[str, int | None] | None:
        """``.../jobs/<base>/v/<NNN>`` → (base, version);
        ``.../jobs/<base>/latest`` → (base, None); else None."""
        rest = key[len(self._jobs_prefix):]
        base, _, tail = rest.partition("/")
        if not base or not tail:
            return None
        if tail == "latest":
            return base, None
        if tail.startswith("v/"):
            try:
                return base, int(tail[2:])
            except ValueError:
                return None
        return None

    def _observe_job(self, ev) -> None:
        parsed = self._parse_job_key(ev.key)
        if parsed is None:
            return
        base, version = parsed
        with self._mu:
            if version is None:                      # latest pointer
                if ev.op == "put":
                    try:
                        self._latest[base] = int(ev.value)
                    except (TypeError, ValueError):
                        return
                else:
                    self._latest.pop(base, None)
            else:                                    # version record
                fam = self._job_versions.setdefault(base, {})
                if ev.op == "put":
                    try:
                        fam[version] = json.loads(ev.value)
                    except (TypeError, ValueError):
                        return
                else:
                    fam.pop(version, None)
                    if not fam:
                        self._job_versions.pop(base, None)
            self._fold(base)
        if self._on_change is not None:
            self._on_change(base)

    def _fold(self, base: str) -> None:
        """Rebuild ``base``'s endpoint from the mirrored records (caller
        holds the lock)."""
        fam = self._job_versions.get(base)
        if not fam:
            ep = self._endpoints.pop(base, None)
            if ep is not None and ep.pool is not None:
                ep.pool.close_all()
            return
        version = self._latest.get(base)
        if version not in fam:
            version = max(fam)
        d = fam[version]
        service = owner_from_env(d.get("env") or [])
        if service is None:
            # not a service replica: plain gangs never enter the table
            self._endpoints.pop(base, None)
            return
        ep = self._endpoints.get(base)
        if ep is None:
            ep = self._endpoints[base] = Endpoint(base)
        placements = d.get("placements") or []
        host_id = placements[0][0] if placements else ""
        address = self._resolve_addr(host_id) or "" if host_id else ""
        port = int(d.get("coordinator_port") or 0)
        if (address, port) != (ep.address, ep.port) or version != ep.version:
            # a new version (or re-placement) is a NEW server: fresh
            # breaker, fresh latency history, fresh pool, new generation
            # (a brand-new endpoint is already fresh — no bump, so its
            # first appearance isn't mistaken for a roll)
            if ep.version != -1:
                ep.reset_runtime()
        ep.service = service
        ep.host_id, ep.address, ep.port = host_id, address, port
        ep.version = version
        ep.phase = d.get("phase", "running")
        # the durable marker is the primary drain signal; the atomic
        # phase→preempted flip (admission.py) plays the same role for
        # preemptions — both land strictly before the first member stop
        ep.draining = bool(d.get("draining", False)) \
            or ep.phase == "preempted"
        ep.routable = (bool(d.get("desired_running", True))
                       and ep.phase == "running" and not ep.draining
                       and bool(address) and port > 0)

    # -- read surface --------------------------------------------------------------

    def endpoint(self, family: str) -> Endpoint | None:
        with self._mu:
            return self._endpoints.get(family)

    def endpoints(self, service: str) -> list[Endpoint]:
        with self._mu:
            return [ep for ep in self._endpoints.values()
                    if ep.service == service]

    def services(self) -> list[str]:
        with self._mu:
            return sorted({ep.service for ep in self._endpoints.values()})

    def draining_families(self) -> list[str]:
        with self._mu:
            return sorted(f for f, ep in self._endpoints.items()
                          if ep.draining)

    def ack_pending_families(self) -> list[str]:
        """Families that may owe an ack: draining, or rolled to a new
        generation that hasn't been acked yet."""
        with self._mu:
            return sorted(
                f for f, ep in self._endpoints.items()
                if ep.draining or ep.generation > ep.acked_generation)

    def lock(self) -> threading.RLock:
        return self._mu

    def view(self) -> dict:
        with self._mu:
            per: dict[str, list[dict]] = {}
            for ep in self._endpoints.values():
                per.setdefault(ep.service, []).append(ep.view())
            return {svc: sorted(eps, key=lambda e: e["family"])
                    for svc, eps in sorted(per.items())}


def rendezvous_order(families: list[str], key: str) -> list[str]:
    """Highest-random-weight order of ``families`` for affinity ``key``.
    Stability is the point: removing one family (drain, ejection) never
    reshuffles the relative order of the others, so only the keys that
    hashed onto the removed replica move."""
    def score(family: str) -> bytes:
        return hashlib.sha256(f"{key}\x00{family}".encode()).digest()
    return sorted(families, key=score, reverse=True)


class DrainCoordinator:
    """Control-plane side of the drain handshake (see module docstring).
    Reads instance heartbeats + per-family acks straight from the KV —
    works across processes, N gateway instances, and gateway death (a
    dead gateway's heartbeat goes stale and stops being waited on)."""

    def __init__(self, kv, heartbeat_s: float = 1.0,
                 poll_s: float = 0.02,
                 clock: Callable[[], float] = time.time) -> None:
        self._kv = kv
        self.heartbeat_s = max(heartbeat_s, 1e-3)
        self._poll_s = poll_s
        self._clock = clock

    def live_instances(self) -> list[str]:
        now = self._clock()
        live = []
        for key, raw in self._kv.range_prefix(
                keys.GATEWAY_INSTANCES_PREFIX).items():
            try:
                rec = json.loads(raw)
                fresh = now - float(rec.get("ts", 0)) <= 3 * self.heartbeat_s
            except (TypeError, ValueError):
                continue
            if fresh:
                live.append(key[len(keys.GATEWAY_INSTANCES_PREFIX):])
        return live

    def acks(self, base: str, version: int | None = None) -> set[str]:
        """Instance ids that acked ``base``. With ``version`` set, an ack
        only counts if it quiesced exactly that version (``drained``) or
        observed a strictly newer one (``rolledTo``) — a stale ack from
        an earlier roll can't satisfy a later drain."""
        prefix = keys.gateway_acks_prefix(base)
        out: set[str] = set()
        for k, raw in self._kv.range_prefix(prefix).items():
            if version is not None:
                try:
                    rec = json.loads(raw)
                except (TypeError, ValueError):
                    continue
                if not (rec.get("drained") == version
                        or rec.get("rolledTo", -1) > version):
                    continue
            out.add(k[len(prefix):])
        return out

    def wait_drained(self, base: str, deadline_s: float,
                     version: int | None = None) -> bool:
        """Block until every LIVE gateway instance has acked ``base``'s
        drain, or ``deadline_s`` passes. Returns True when fully acked
        (vacuously with zero live gateways). ``version`` scopes which
        acks count (see :meth:`acks`); None accepts any ack. The
        family's ack keys are deleted either way — the next drain of a
        recreated namesake starts from a clean slate."""
        deadline = time.monotonic() + max(deadline_s, 0.0)
        acked = False
        while True:
            live = self.live_instances()
            if not live or set(live) <= self.acks(base, version):
                acked = True
                break
            if time.monotonic() >= deadline:
                break
            time.sleep(self._poll_s)
        try:
            self._kv.delete_prefix(keys.gateway_acks_prefix(base))
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            log.exception("gateway ack cleanup failed for %s", base)
        return acked


class GatewayResponse:
    """What one routed request produced. Exactly one of ``body`` (fully
    buffered upstream reply) or ``stream`` (chunk iterator; passthrough)
    is set. ``stream`` ALWAYS terminates: mid-stream upstream death
    yields one final typed truncation line instead of raising into the
    listener."""

    def __init__(self, status: int, headers: list[tuple[str, str]],
                 body: bytes | None = None, stream=None,
                 endpoint: str = "", attempts: int = 1,
                 hedged: bool = False) -> None:
        self.status = status
        self.headers = headers
        self.body = body
        self.stream = stream
        self.endpoint = endpoint
        self.attempts = attempts
        self.hedged = hedged
        #: True when the winning _Upstream owns the request's global
        #: in-flight slot (released at finish/stream-end, not at return)
        self.slot_deferred = False


class _Upstream:
    """One in-flight upstream exchange: connection + live HTTPResponse,
    plus the bookkeeping needed to release/close correctly."""

    def __init__(self, gw: "Gateway", ep: Endpoint, gen: int, conn, resp,
                 probe: bool) -> None:
        self.gw = gw
        self.ep = ep
        self.gen = gen
        self.conn = conn
        self.resp = resp
        self.probe = probe
        #: set on the WINNING exchange only (hedge losers and failed
        #: attempts never own the request's global in-flight slot)
        self.owns_slot = False
        self.done = False

    def finish(self, reusable: bool) -> None:
        if self.done:
            return
        self.done = True
        pool = self.ep.pool
        if pool is not None:
            pool.release(self.conn, reusable)
        else:
            self.conn.close()
        self.gw._request_done(self.ep, self.gen)
        if self.owns_slot:
            self.gw._release_slot()

    def abort(self) -> None:
        """Close without pooling (hedge loser, truncation, shutdown)."""
        try:
            self.conn.close()
        except Exception:  # noqa: BLE001
            pass
        self.finish(reusable=False)


class Gateway:
    """The routing/failure engine. Stateless across restarts on purpose
    (N instances allowed): everything here is derived — the table from
    the watch stream, breakers/EWMA from live traffic, drain acks from
    the two combined."""

    def __init__(
        self,
        kv,
        resolve_addr: Callable[[str], str | None],
        registry: MetricsRegistry | None = None,
        tracer=None,
        signals: Callable[[str], dict | None] | None = None,
        *,
        request_timeout_s: float = 30.0,
        connect_timeout_s: float = 2.0,
        retry_limit: int = 2,
        retry_budget_ratio: float = 0.2,
        hedge_ms: float = 0.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 5.0,
        outlier_latency_factor: float = 0.0,
        max_inflight: int = 256,
        max_inflight_per_endpoint: int = 64,
        pool_size: int = 8,
        heartbeat_s: float = 1.0,
        backoff_base_s: float = 0.02,
        backoff_max_s: float = 0.5,
        advertise: str = "",
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._kv = kv
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer
        self._signals = signals
        self.request_timeout_s = request_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.retry_limit = max(0, int(retry_limit))
        self.retry_budget_ratio = max(0.0, float(retry_budget_ratio))
        self.hedge_ms = max(0.0, float(hedge_ms))
        self.breaker_threshold = max(0, int(breaker_threshold))
        self.breaker_cooldown_s = breaker_cooldown_s
        self.outlier_latency_factor = max(0.0, float(outlier_latency_factor))
        self.max_inflight = max(1, int(max_inflight))
        self.max_inflight_per_endpoint = max(1, int(max_inflight_per_endpoint))
        self.pool_size = max(0, int(pool_size))
        self.heartbeat_s = max(heartbeat_s, 1e-3)
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self.advertise = advertise
        self._clock = clock
        self.instance_id = f"gw-{uuid.uuid4().hex[:8]}"
        self.table = RoutingTable(resolve_addr, registry=self.registry,
                                  on_change=self._family_changed)
        self._mu = threading.Lock()         # gateway-global counters
        self._inflight_total = 0
        #: retry token bucket: completed requests earn ``ratio`` tokens,
        #: each retry spends one — the budget bounds retry AMPLIFICATION
        #: (a melting fleet can't be hammered with retry storms), while a
        #: healthy trickle of failures always has tokens to spend
        self._retry_tokens = float(self.retry_limit)
        #: families this instance has acked in their CURRENT drain cycle
        self._acked: set[str] = set()
        self._events: list[dict] = []
        self._events_mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.registry.gauge_fn(
            "gateway_inflight", lambda: self._inflight_total,
            help="Requests currently proxied by this gateway instance")

    # -- lifecycle -----------------------------------------------------------------

    def start(self) -> None:
        self._heartbeat()          # registered before the first request
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gateway-drain", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self._kv.delete(keys.gateway_instance_key(self.instance_id))
        except Exception:  # noqa: BLE001 — best-effort deregistration
            pass
        with self.table.lock():
            for ep in list(self.table._endpoints.values()):
                if ep.pool is not None:
                    ep.pool.close_all()

    def _loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._heartbeat()
                self._sweep_drains()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("gateway heartbeat/drain sweep failed")

    def _heartbeat(self) -> None:
        self._kv.put(keys.gateway_instance_key(self.instance_id),
                     json.dumps({"id": self.instance_id, "ts": time.time(),
                                 "advertise": self.advertise}))

    # -- drain handshake (gateway side) --------------------------------------------

    def _family_changed(self, base: str) -> None:
        ep = self.table.endpoint(base)
        if ep is None:
            self._acked.discard(base)
            return
        if not ep.draining:
            # marker gone (stopped/rolled/recreated): next drain cycle
            # must write a fresh ack
            self._acked.discard(base)
        self._maybe_ack(base)

    def _maybe_ack(self, base: str) -> None:
        """Write the family's ack when it is owed: ``drained`` once a
        draining endpoint has zero in-flight, and/or ``rolledTo`` once
        every attempt against a superseded generation has landed. The
        roll ack is what keeps spec rolls fast — the draining marker
        lands on the OLD version record while the latest pointer already
        moved, so the table never surfaces ``draining``; acking 'I have
        folded version N and nothing lame is in flight' carries the same
        zero-drop guarantee."""
        ep = self.table.endpoint(base)
        if ep is None:
            return
        with self.table.lock():
            drained = (ep.draining and base not in self._acked
                       and ep.inflight == 0)
            rolled = (ep.generation > ep.acked_generation
                      and ep.lame_inflight() == 0)
            if not drained and not rolled:
                return
            payload: dict = {"id": self.instance_id, "ts": time.time()}
            prev_gen = ep.acked_generation
            if drained:
                payload["drained"] = ep.version
                self._acked.add(base)
            if rolled:
                payload["rolledTo"] = ep.version
                ep.acked_generation = ep.generation
        try:
            self._kv.put(keys.gateway_ack_key(base, self.instance_id),
                         json.dumps(payload))
        except Exception:  # noqa: BLE001 — the sweep retries
            with self.table.lock():
                if drained:
                    self._acked.discard(base)
                if rolled:
                    ep.acked_generation = min(ep.acked_generation, prev_gen)
            log.exception("gateway drain ack failed for %s", base)
            return
        if drained:
            self.registry.counter_inc(
                "gateway_drain_acks_total",
                help="Drain acks written (family quiesced with zero "
                     "in-flight)")
            self._event("drain-acked", family=base)
        if rolled:
            self.registry.counter_inc(
                "gateway_roll_acks_total",
                help="Roll acks written (new version folded, zero lame "
                     "in-flight)")
            self._event("roll-acked", family=base, version=ep.version)

    def _sweep_drains(self) -> None:
        for base in self.table.ack_pending_families():
            self._maybe_ack(base)

    def _request_done(self, ep: Endpoint, gen: int) -> None:
        """Per-ATTEMPT endpoint accounting: one pick, one release. The
        gateway-global slot is per-REQUEST and released separately
        (``_release_slot``)."""
        with self.table.lock():
            ep.inflight = max(0, ep.inflight - 1)
            n = ep.gen_inflight.get(gen, 0) - 1
            if n > 0:
                ep.gen_inflight[gen] = n
            else:
                ep.gen_inflight.pop(gen, None)
            owes_ack = ep.draining or gen < ep.generation
        if owes_ack:
            self._maybe_ack(ep.family)

    def _release_slot(self) -> None:
        """Per-REQUEST completion: free the global in-flight slot and
        earn the retry budget's completion dividend. Called exactly once
        per admitted request — at error return, or when the winning
        upstream exchange fully finishes (stream end included)."""
        with self._mu:
            self._inflight_total = max(0, self._inflight_total - 1)
            self._retry_tokens = min(
                float(self.retry_limit) if self.retry_limit else 1.0,
                self._retry_tokens + self.retry_budget_ratio)

    # -- endpoint selection --------------------------------------------------------

    def _breaker_admits(self, ep: Endpoint, now: float) -> bool:
        """Caller holds the table lock. May reserve the half-open probe
        slot (single-flight) — the caller MUST then issue the request
        (the probe flag is cleared in ``_record``)."""
        if self.breaker_threshold <= 0 or ep.breaker_open_since is None:
            return True
        if ep.half_open_probe:
            return False                      # someone else is probing
        if now - ep.breaker_open_since < self.breaker_cooldown_s:
            return False
        ep.half_open_probe = True             # reserve the single probe
        return True

    def _outlier(self, ep: Endpoint, peers: list[Endpoint]) -> bool:
        if self.outlier_latency_factor <= 0 or ep.ewma_ms is None \
                or ep.samples < 8:
            return False
        ew = sorted(p.ewma_ms for p in peers
                    if p.ewma_ms is not None and p.samples >= 8)
        if len(ew) < 2:
            return False
        median = ew[len(ew) // 2]
        if median <= 0:
            return False
        if ep.ewma_ms > self.outlier_latency_factor * median:
            now = self._clock()
            if ep.ejected_until <= now:
                ep.ejected_until = now + self.breaker_cooldown_s
                self.registry.counter_inc(
                    "gateway_outlier_ejections_total",
                    {"service": ep.service},
                    help="Endpoints ejected as latency outliers")
                self._event("outlier-ejected", family=ep.family,
                            ewmaMs=round(ep.ewma_ms, 3),
                            medianMs=round(median, 3))
            return True
        return False

    def _load(self, ep: Endpoint) -> float:
        depth = 0.0
        if self._signals is not None:
            sig = self._signals(ep.family)
            if sig:
                depth = float(sig.get("queueDepth", 0.0))
        return ep.inflight + depth

    def _pick(self, service: str, prefix_key: str | None,
              exclude: set[str], probes: list[Endpoint]
              ) -> tuple[Endpoint, int] | None:
        """One (endpoint, generation) for one attempt — or None (all
        unroutable / saturated / open). The generation pins the attempt
        to the server it was issued against, so roll acks can wait for
        exactly the lame in-flight set. Appends to ``probes`` when the
        pick consumed a half-open probe slot."""
        now = self._clock()
        with self.table.lock():
            eps = [ep for ep in self.table.endpoints(service)
                   if ep.routable and ep.family not in exclude]
            candidates = []
            for ep in eps:
                if ep.inflight >= self.max_inflight_per_endpoint:
                    continue
                if ep.ejected_until > now or self._outlier(ep, eps):
                    continue
                candidates.append(ep)
            if prefix_key:
                order = rendezvous_order([ep.family for ep in candidates],
                                         prefix_key)
                by_family = {ep.family: ep for ep in candidates}
                ordered = [by_family[f] for f in order]
            else:
                ordered = sorted(
                    candidates,
                    key=lambda ep: (self._load(ep), ep.ewma_ms or 0.0,
                                    ep.family))
            for ep in ordered:
                probing = ep.breaker_open_since is not None
                if not self._breaker_admits(ep, now):
                    continue
                if probing and ep.half_open_probe:
                    probes.append(ep)
                ep.inflight += 1
                ep.gen_inflight[ep.generation] = \
                    ep.gen_inflight.get(ep.generation, 0) + 1
                return ep, ep.generation
        return None

    def _record(self, ep: Endpoint, ok: bool, latency_ms: float | None,
                probe: bool) -> None:
        with self.table.lock():
            if probe:
                ep.half_open_probe = False
            if ok:
                ep.consecutive_failures = 0
                ep.breaker_open_since = None
                if latency_ms is not None:
                    ep.samples += 1
                    ep.ewma_ms = (latency_ms if ep.ewma_ms is None
                                  else 0.8 * ep.ewma_ms + 0.2 * latency_ms)
            else:
                ep.consecutive_failures += 1
                if (self.breaker_threshold > 0
                        and (probe or ep.consecutive_failures
                             >= self.breaker_threshold)):
                    newly = ep.breaker_open_since is None
                    ep.breaker_open_since = self._clock()
                    if newly:
                        self.registry.counter_inc(
                            "gateway_breaker_opens_total",
                            {"service": ep.service or "unknown"},
                            help="Per-endpoint circuit breaker opens")
                        self._event("breaker-open", family=ep.family,
                                    failures=ep.consecutive_failures)

    # -- the request path ----------------------------------------------------------

    def request(self, service: str, method: str, path: str,
                headers: dict[str, str], body: bytes,
                prefix_key: str | None = None,
                idempotent: bool | None = None,
                traceparent: str | None = None) -> GatewayResponse:
        """Route one client request. Raises :class:`errors.GatewayShed`
        (global cap) or :class:`errors.GatewayNoEndpoints` (nothing
        routable and nothing upstream to blame); an exhausted retry
        budget returns the LAST upstream reply verbatim instead."""
        if idempotent is None:
            idempotent = (method in ("GET", "HEAD")
                          or "idempotency-key" in
                          {k.lower() for k in headers})
        with self._mu:
            if self._inflight_total >= self.max_inflight:
                self.registry.counter_inc(
                    "gateway_shed_total", {"service": service,
                                           "reason": "inflight-cap"},
                    help="Requests shed with a typed 429/503")
                raise errors.GatewayShed(
                    f"gateway at capacity ({self.max_inflight} in flight); "
                    f"retry after backoff")
            self._inflight_total += 1
        try:
            resp = self._route(service, method, path, headers, body,
                               prefix_key, idempotent, traceparent)
        except BaseException:
            self._release_slot()
            raise
        if not resp.slot_deferred:
            # error-shaped returns (verbatim last upstream error, typed
            # 502): no live upstream owns the slot — release it here
            self._release_slot()
        return resp

    def _route(self, service, method, path, headers, body, prefix_key,
               idempotent, traceparent) -> GatewayResponse:
        deadline = self._clock() + self.request_timeout_s
        attempts = 0
        hedged_any = False
        tried: set[str] = set()
        last_err: Exception | None = None
        max_attempts = 1 + (self.retry_limit if idempotent else 0)
        while attempts < max_attempts:
            if attempts > 0:
                with self._mu:
                    if self._retry_tokens < 1.0:
                        self.registry.counter_inc(
                            "gateway_retry_budget_exhausted_total",
                            help="Retries suppressed by the token budget")
                        break
                    self._retry_tokens -= 1.0
                self.registry.counter_inc(
                    "gateway_retries_total", {"service": service},
                    help="Upstream retries issued (idempotent only)")
                time.sleep(min(
                    backoff_delay_s(attempts - 1, self._backoff_base_s,
                                    self._backoff_max_s, jitter=0.5),
                    max(0.0, deadline - self._clock())))
            if self._clock() >= deadline:
                break
            attempts += 1
            try:
                up, hedged = self._attempt(service, method, path, headers,
                                           body, prefix_key, tried,
                                           deadline, idempotent, traceparent)
                hedged_any = hedged_any or hedged
                up.owns_slot = True
                resp = self._respond(up, attempts, hedged_any, service)
                resp.slot_deferred = True
                return resp
            except _NoEndpoint:
                # nothing routable for THIS attempt: keep the last real
                # upstream error (better signal) or fall through to the
                # typed 503 when nothing was ever contacted
                break
            except (UpstreamConnectError, UpstreamHTTPError) as e:
                last_err = e
                tried.add(e.endpoint)
                self.registry.counter_inc(
                    "gateway_upstream_errors_total", {"service": service},
                    help="Upstream attempts that failed (connect or 5xx)")
                if not idempotent:
                    break
        if isinstance(last_err, UpstreamHTTPError):
            # the contract: exhaustion surfaces the LAST upstream error
            # verbatim — status, headers and body — never a generic 502
            return GatewayResponse(
                last_err.status,
                [(k, v) for k, v in last_err.headers
                 if k.lower() not in _HOP_HEADERS],
                body=last_err.body, endpoint=last_err.endpoint,
                attempts=attempts, hedged=hedged_any)
        if isinstance(last_err, UpstreamConnectError):
            payload = json.dumps({
                "error": str(last_err), "endpoint": last_err.endpoint,
                "attempts": attempts}).encode()
            return GatewayResponse(
                502, [("Content-Type", "application/json")],
                body=payload, endpoint=last_err.endpoint,
                attempts=attempts, hedged=hedged_any)
        self.registry.counter_inc(
            "gateway_shed_total", {"service": service,
                                   "reason": "no-endpoints"},
            help="Requests shed with a typed 429/503")
        raise errors.GatewayNoEndpoints(
            f"service {service!r} has no routable replica (all draining, "
            f"ejected, saturated or unknown)")

    def _attempt(self, service, method, path, headers, body, prefix_key,
                 tried, deadline, idempotent, traceparent
                 ) -> tuple[_Upstream, bool]:
        """One pick(+hedge) cycle → a winning upstream, or raises the
        pick's failure. The hedge races a SECOND endpoint to first byte
        when the primary hasn't produced one within ``hedge_ms``."""
        probes: list[Endpoint] = []
        pick = self._pick(service, prefix_key, tried, probes)
        if pick is None and tried:
            # every untried peer is gone — retrying an already-tried
            # endpoint (a 5xx can be transient) beats giving up while
            # the budget still allows attempts
            pick = self._pick(service, prefix_key, set(), probes)
        if pick is None:
            raise _NoEndpoint(service)
        ep, gen = pick
        probe = bool(probes)
        hedge_ok = (self.hedge_ms > 0 and idempotent and not probe)
        if not hedge_ok:
            return self._send(ep, gen, method, path, headers, body,
                              deadline, probe, traceparent), False
        return self._hedged(ep, gen, service, method, path, headers, body,
                            prefix_key, tried, deadline, traceparent)

    def _hedged(self, primary, primary_gen, service, method, path, headers,
                body, prefix_key, tried, deadline, traceparent
                ) -> tuple[_Upstream, bool]:
        import queue as queue_mod

        results: queue_mod.Queue = queue_mod.Queue()
        expected = 1

        def run(ep: Endpoint, gen: int, probe: bool) -> None:
            try:
                results.put(("ok", self._send(
                    ep, gen, method, path, headers, body, deadline, probe,
                    traceparent)))
            except (UpstreamConnectError, UpstreamHTTPError) as e:
                results.put(("err", e))

        threading.Thread(target=run, args=(primary, primary_gen, False),
                         daemon=True).start()
        try:
            kind, first = results.get(timeout=self.hedge_ms / 1e3)
        except queue_mod.Empty:
            kind = None
        hedged = False
        if kind is None:
            # no first byte yet: race a second endpoint
            probes: list[Endpoint] = []
            other = self._pick(service, prefix_key,
                               tried | {primary.family}, probes)
            if other is not None:
                hedged = True
                expected += 1
                self.registry.counter_inc(
                    "gateway_hedges_total", {"service": service},
                    help="Hedged second attempts launched")
                threading.Thread(target=run,
                                 args=(*other, bool(probes)),
                                 daemon=True).start()
            kind, first = results.get()
        seen = 1
        while kind == "err" and seen < expected:
            kind, first = results.get()
            seen += 1
        if kind == "err":
            raise first
        winner: _Upstream = first
        if seen < expected:
            # a loser is still in flight: close it un-pooled on arrival
            def reap() -> None:
                for _ in range(expected - seen):
                    k, r = results.get()
                    if k == "ok":
                        r.abort()
                        self.registry.counter_inc(
                            "gateway_hedge_cancelled_total",
                            help="Hedge losers cancelled after first-byte "
                                 "win")
            threading.Thread(target=reap, daemon=True).start()
        return winner, hedged

    def _send(self, ep: Endpoint, gen: int, method, path, headers, body,
              deadline, probe, traceparent) -> _Upstream:
        """One upstream exchange up to response headers (= first byte).
        The endpoint's in-flight slot was taken by ``_pick``; release on
        failure happens here, release on success happens when the
        response is fully relayed (``_Upstream.finish``)."""
        if ep.pool is None:
            ep.pool = _ConnectionPool(self.pool_size)
        timeout = max(min(self.connect_timeout_s,
                          deadline - self._clock()), 1e-3)

        def open_fn(t):
            return http.client.HTTPConnection(ep.address, ep.port,
                                              timeout=t)

        t0 = self._clock()
        conn = None
        try:
            conn, _reused = ep.pool.acquire(open_fn, timeout)
            conn.timeout = max(deadline - self._clock(), 1e-3)
            if conn.sock is not None:
                conn.sock.settimeout(conn.timeout)
            conn.putrequest(method, path, skip_accept_encoding=True)
            sent = {"host"}          # putrequest already emitted Host
            for k, v in headers.items():
                lk = k.lower()
                if lk in _HOP_HEADERS or lk in sent or lk == "traceparent":
                    continue
                sent.add(lk)
                conn.putheader(k, v)
            if traceparent:
                conn.putheader("traceparent", traceparent)
            conn.putheader("Content-Length", str(len(body)))
            conn.endheaders()
            if body:
                conn.send(body)
            resp = conn.getresponse()
        except Exception as e:  # noqa: BLE001 — connection-level failure
            if conn is not None:
                ep.pool.release(conn, reusable=False)
            self._record(ep, ok=False, latency_ms=None, probe=probe)
            self._request_done(ep, gen)
            raise UpstreamConnectError(ep.family, e) from e
        ttfb_ms = (self._clock() - t0) * 1e3
        self.registry.observe(
            "gateway_upstream_ttfb_ms", ttfb_ms,
            {"service": ep.service or "unknown"}, buckets=_TTFB_BUCKETS,
            help="Upstream time-to-first-byte through the gateway (ms)")
        if resp.status >= 500 or resp.status == 429:
            # a complete reply that still counts against the breaker —
            # drain the (bounded) body so the connection can be judged
            raw_headers = resp.getheaders()
            try:
                err_body = resp.read(1 << 20)
                reusable = not resp.will_close
            except Exception:  # noqa: BLE001
                err_body, reusable = b"", False
            ep.pool.release(conn, reusable)
            self._record(ep, ok=False, latency_ms=None, probe=probe)
            self._request_done(ep, gen)
            raise UpstreamHTTPError(ep.family, resp.status, raw_headers,
                                    err_body)
        self._record(ep, ok=True, latency_ms=ttfb_ms, probe=probe)
        return _Upstream(self, ep, gen, conn, resp, probe)

    def _respond(self, up: _Upstream, attempts: int, hedged: bool,
                 service: str) -> GatewayResponse:
        resp = up.resp
        out_headers = [(k, v) for k, v in resp.getheaders()
                       if k.lower() not in _HOP_HEADERS]
        self.registry.counter_inc(
            "gateway_requests_total",
            {"service": service, "code": str(resp.status)},
            help="Requests routed upstream by service and status")
        length = resp.getheader("Content-Length")
        if length is not None:
            # bounded reply: buffer and release the connection now
            try:
                payload = resp.read()
                reusable = not resp.will_close
            except Exception as e:  # noqa: BLE001
                # this attempt FAILED after headers: hand the slot back
                # to the retry loop (a later attempt re-takes ownership)
                up.owns_slot = False
                up.abort()
                self._record(up.ep, ok=False, latency_ms=None, probe=False)
                raise UpstreamConnectError(up.ep.family, e) from e
            up.finish(reusable)
            return GatewayResponse(resp.status, out_headers, body=payload,
                                   endpoint=up.ep.family, attempts=attempts,
                                   hedged=hedged)
        return GatewayResponse(resp.status, out_headers,
                               stream=self._relay(up),
                               endpoint=up.ep.family, attempts=attempts,
                               hedged=hedged)

    def _relay(self, up: _Upstream):
        """Streaming passthrough generator. Mid-stream upstream death
        becomes ONE final typed truncation line (ndjson, matching the
        replica's own stream framing) — clients see a structured event,
        never a silent half-response."""
        try:
            while True:
                try:
                    # read1, not read: read(n) on a chunked response
                    # blocks across chunk boundaries until n bytes or
                    # EOF, which would buffer an incremental token
                    # stream instead of passing each chunk through
                    chunk = up.resp.read1(64 * 1024)
                except Exception as e:  # noqa: BLE001 — upstream died
                    self.registry.counter_inc(
                        "gateway_truncated_streams_total",
                        {"service": up.ep.service or "unknown"},
                        help="Streams cut by mid-flight upstream death")
                    self._event("stream-truncated", family=up.ep.family,
                                reason=f"{type(e).__name__}: {e}")
                    self._record(up.ep, ok=False, latency_ms=None,
                                 probe=False)
                    yield (json.dumps({
                        "gatewayTruncated": True,
                        "endpoint": up.ep.family,
                        "reason": f"{type(e).__name__}: {e}"}).encode()
                        + b"\n")
                    up.abort()
                    return
                if not chunk:
                    up.finish(reusable=not up.resp.will_close)
                    return
                yield chunk
        finally:
            up.finish(reusable=False)  # no-op when already finished

    # -- observability -------------------------------------------------------------

    def _event(self, kind: str, **detail) -> None:
        with self._events_mu:
            self._events.append(trace.stamp(
                {"ts": time.time(), "event": f"gateway-{kind}",
                 "gateway": self.instance_id, **detail}))
            del self._events[:-256]

    def events_view(self, limit: int = 100) -> list[dict]:
        with self._events_mu:
            return list(self._events)[-limit:]

    def status_view(self) -> dict:
        rv = self.registry.counter_sum
        with self._mu:
            tokens = round(self._retry_tokens, 3)
            inflight = self._inflight_total
        return {
            "instanceId": self.instance_id,
            "advertise": self.advertise,
            "inFlight": inflight,
            "retryTokens": tokens,
            "hedgeMs": self.hedge_ms,
            "requestTimeoutS": self.request_timeout_s,
            "retryLimit": self.retry_limit,
            "maxInFlight": self.max_inflight,
            "services": self.table.view(),
            "drainingFamilies": self.table.draining_families(),
            "counters": {
                "requests": int(rv("gateway_requests_total")),
                "retries": int(rv("gateway_retries_total")),
                "hedges": int(rv("gateway_hedges_total")),
                "hedgeCancelled": int(rv("gateway_hedge_cancelled_total")),
                "shed": int(rv("gateway_shed_total")),
                "upstreamErrors": int(rv("gateway_upstream_errors_total")),
                "breakerOpens": int(rv("gateway_breaker_opens_total")),
                "outlierEjections": int(
                    rv("gateway_outlier_ejections_total")),
                "truncatedStreams": int(
                    rv("gateway_truncated_streams_total")),
                "drainAcks": int(rv("gateway_drain_acks_total")),
                "rollAcks": int(rv("gateway_roll_acks_total")),
            },
        }
