"""Host failure domains: circuit breakers + host health state machine
(docs/robustness.md "Host failure domains").

The reconciler and the gang supervisor reason about *container*
state; a whole class of pod faults lives one level up — host reboot,
NIC death, dockerd hang. Without this layer an unreachable engine surfaces
as a connection error deep inside a liveness poll, gets swallowed by
per-family error isolation, and a gang restart re-places members onto the
same dead host, burning the bounded restart budget on a fault no restart
can fix. The Kubernetes node-lifecycle answer (NotReady → taint → evict)
maps here as:

- :class:`BreakerRuntime` — a circuit breaker around each per-host
  runtime. ``breaker_threshold`` consecutive connection-class failures
  open it; open means every call fast-fails with
  :class:`~tpu_docker_api_torch.errors.HostUnreachable` instead of hanging an
  API or supervisor thread on a dead socket; after a cooldown one
  half-open probe is let through — success closes, failure re-opens.
- :class:`HostMonitor` — probes every pod host's engine on an interval
  and runs a per-host state machine ``healthy → suspect → down``: the
  first probe failure makes a host *suspect*; only after
  ``host_down_grace_s`` of continuous failure is it *down* (so a sub-grace
  blip — a dockerd restart, a dropped packet — causes ZERO restarts), at
  which point the scheduler stops placing on it and the gang supervisor
  migrates gangs off it.
- **cordon/drain** — the operator surface. Cordon (persisted in KV, so it
  survives daemon restarts) removes a host from scheduling without
  touching its workloads; drain additionally migrates every gang off it,
  asynchronously via the work queue.

The monitor observes; the scheduler excludes; the supervisor repairs.
Down-ness is deliberately in-memory (re-observed after a restart) while
cordons persist — an operator decision outlives the process, a network
observation does not.

The port's copy of ``tpu_docker_api/service/host_health.py``, whole.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import (
    ContainerInfo,
    ContainerRuntime,
    ExecResult,
    VolumeInfo,
)
from tpu_docker_api_torch.runtime.fanout import SERIAL, Fanout
from tpu_docker_api_torch.runtime.spec import ContainerSpec
from tpu_docker_api_torch.schemas.job import DORMANT_PHASES
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY

log = logging.getLogger(__name__)

#: failures that mean "the path to the engine is broken" (connection
#: refused/reset, socket timeout, a breaker already open) — as opposed to
#: the engine responding with an application error, which proves the host
#: alive. One alias of the canonical tuple: every member-state scanner
#: (supervisor/reconciler/invariants/job service) catches the same set.
CONNECTION_ERRORS = errors.HOST_PATH_ERRORS


class BreakerRuntime(ContainerRuntime):
    """Circuit breaker around one host's container runtime.

    closed → (``threshold`` consecutive connection failures) → open →
    (``cooldown_s`` elapsed, one probe allowed) → half-open →
    (probe ok) → closed / (probe fails) → open again.

    While open, every call fast-fails with ``HostUnreachable`` — a hung
    docker socket must cost one timeout, not one timeout per caller per
    poll. Connection errors from the inner runtime are normalized to
    ``HostUnreachable`` (original as ``__cause__``) so every layer above
    can classify host-path failures with one except clause. Application
    errors (``ContainerNotExist``, ...) prove the engine ALIVE: they reset
    the failure streak and close a half-open breaker.
    """

    def __init__(self, inner: ContainerRuntime, host_id: str = "",
                 threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic) -> None:
        self.inner = inner
        self.host_id = host_id
        self._threshold = max(1, threshold)
        self._cooldown_s = cooldown_s
        self._clock = clock
        self._mu = threading.Lock()
        self._state = "closed"          # "closed" | "open" | "half-open"
        self._failures = 0              # consecutive connection failures
        self._retry_at = 0.0            # monotonic: next half-open probe
        self._probing = False           # single-flight half-open probe
        self._opened_count = 0

    # -- the breaker --------------------------------------------------------------

    def _call(self, op: str, fn):
        # whether THIS call is the half-open probe — only the probe may
        # clear the single-flight flag. An unrelated call that was hung on
        # the dying socket since before the breaker opened must not reset
        # it when it finally errors, or concurrent probes pile onto the
        # dead socket (the exact pile-up the flag exists to prevent)
        is_probe = False
        with self._mu:
            now = self._clock()
            if self._state == "open":
                if now < self._retry_at:
                    raise errors.HostUnreachable(
                        f"host {self.host_id or '?'}: circuit open, "
                        f"{op} fast-failed "
                        f"(retry in {self._retry_at - now:.1f}s)")
                self._state = "half-open"
            if self._state == "half-open":
                if self._probing:
                    # someone else's probe is in flight: fast-fail rather
                    # than pile callers onto a possibly-dead socket
                    raise errors.HostUnreachable(
                        f"host {self.host_id or '?'}: circuit half-open, "
                        f"probe in flight ({op} fast-failed)")
                self._probing = True
                is_probe = True
        try:
            result = fn()
        except CONNECTION_ERRORS as e:
            with self._mu:
                if is_probe:
                    self._probing = False
                self._failures += 1
                if is_probe or self._failures >= self._threshold:
                    if self._state != "open":
                        self._opened_count += 1
                        log.warning(
                            "host %s: circuit OPEN after %d consecutive "
                            "connection failures (%s)", self.host_id,
                            self._failures, e)
                    self._state = "open"
                    self._retry_at = self._clock() + self._cooldown_s
            if isinstance(e, errors.HostUnreachable):
                raise
            raise errors.HostUnreachable(
                f"host {self.host_id or '?'}: {op} failed: "
                f"{type(e).__name__}: {e}") from e
        except Exception:
            # the engine RESPONDED (application error): the host is alive
            with self._mu:
                if is_probe:
                    self._probing = False
                self._failures = 0
                if self._state != "closed":
                    log.info("host %s: circuit closed (engine responded)",
                             self.host_id)
                self._state = "closed"
            raise
        else:
            with self._mu:
                if is_probe:
                    self._probing = False
                self._failures = 0
                if self._state != "closed":
                    log.info("host %s: circuit closed (probe ok)",
                             self.host_id)
                self._state = "closed"
            return result

    def view(self) -> dict:
        with self._mu:
            return {
                "state": self._state,
                "consecutiveFailures": self._failures,
                "threshold": self._threshold,
                "timesOpened": self._opened_count,
            }

    # -- delegated runtime surface -------------------------------------------------

    def container_create(self, spec: ContainerSpec) -> str:
        return self._call("container_create",
                          lambda: self.inner.container_create(spec))

    def container_start(self, name: str) -> None:
        return self._call("container_start",
                          lambda: self.inner.container_start(name))

    def container_stop(self, name: str, timeout_s: int = 10) -> None:
        return self._call("container_stop",
                          lambda: self.inner.container_stop(name, timeout_s))

    def container_restart(self, name: str) -> None:
        return self._call("container_restart",
                          lambda: self.inner.container_restart(name))

    def container_remove(self, name: str, force: bool = False) -> None:
        return self._call("container_remove",
                          lambda: self.inner.container_remove(name, force))

    def container_inspect(self, name: str) -> ContainerInfo:
        return self._call("container_inspect",
                          lambda: self.inner.container_inspect(name))

    def container_exists(self, name: str) -> bool:
        return self._call("container_exists",
                          lambda: self.inner.container_exists(name))

    def container_list(self) -> list[str]:
        return self._call("container_list",
                          lambda: self.inner.container_list())

    def container_exec(self, name: str, cmd: list[str],
                       workdir: str = "") -> ExecResult:
        return self._call("container_exec",
                          lambda: self.inner.container_exec(name, cmd, workdir))

    def container_commit(self, name: str, image_ref: str) -> str:
        return self._call("container_commit",
                          lambda: self.inner.container_commit(name, image_ref))

    def container_data_dir(self, name: str) -> str:
        return self._call("container_data_dir",
                          lambda: self.inner.container_data_dir(name))

    def volume_create(self, name: str, driver_opts: dict[str, str]) -> VolumeInfo:
        return self._call("volume_create",
                          lambda: self.inner.volume_create(name, driver_opts))

    def volume_remove(self, name: str, force: bool = False) -> None:
        return self._call("volume_remove",
                          lambda: self.inner.volume_remove(name, force))

    def volume_inspect(self, name: str) -> VolumeInfo:
        return self._call("volume_inspect",
                          lambda: self.inner.volume_inspect(name))

    def volume_exists(self, name: str) -> bool:
        return self._call("volume_exists",
                          lambda: self.inner.volume_exists(name))

    def volume_data_dir(self, name: str) -> str:
        return self._call("volume_data_dir",
                          lambda: self.inner.volume_data_dir(name))

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name: str):
        # backend-specific helpers (FakeRuntime.crash_container, FaultyRuntime
        # plan management) pass through un-gated — they model the environment
        return getattr(self.inner, name)


class HostMonitor:
    """Probes every pod host's engine; drives healthy → suspect → down.

    ``probe_once`` is the injectable-clock unit (no sleeping), mirroring
    the supervisor's ``poll_once``. A probe is one ``container_list`` per
    host, through the host's breaker — so while a breaker is open the
    probe fast-fails (cheap), and once its cooldown elapses the probe IS
    the half-open trial that detects recovery.

    Transitions:

    - first failed probe: ``healthy → suspect`` (grace window opens);
    - continuous failure for ``down_grace_s``: ``suspect → down`` — the
      scheduler is told (``set_host_down``) so the host receives no new
      placements, and ``on_down`` (the supervisor's wake) fires so gang
      migration starts immediately instead of at the next poll tick;
    - any successful probe: back to ``healthy`` (and the scheduler mark is
      lifted). A recovered host that is operator-cordoned STAYS cordoned.
    """

    def __init__(self, pod, slices, interval_s: float = 5.0,
                 down_grace_s: float = 15.0, clock=time.monotonic,
                 job_svc=None, job_versions=None, work_queue=None,
                 on_down=None, registry: MetricsRegistry | None = None,
                 max_events: int = 256,
                 fanout: Fanout | None = None, store_gate=None) -> None:
        self.pod = pod
        #: runtime fan-out: all hosts are probed as ONE concurrent batch,
        #: so detection wall time is O(slowest host), not O(sum) — one
        #: hung engine can no longer delay every other host's verdict by
        #: its full timeout
        self._fanout = fanout or SERIAL
        self.slices = slices            # PodScheduler (cordon/down marks)
        self._interval = interval_s
        self._grace = down_grace_s
        self._clock = clock
        self._job_svc = job_svc
        self._job_versions = job_versions
        self._wq = work_queue
        self._on_down = on_down
        #: store-outage hold (service/store_health.py): probing continues
        #: (observation), but the DOWN verdict — which cordons the host and
        #: wakes gang migration, a store-mutating cascade — is deferred
        #: while the gate holds. The grace clock keeps running: the instant
        #: the store heals, an still-failing host is confirmed down on the
        #: next probe. None ⇒ ungated.
        self._store_gate = store_gate
        self.store_skips = 0
        self._store_held = False
        self._registry = registry if registry is not None else REGISTRY
        self._mu = threading.Lock()
        now = self._clock()
        #: host_id → {"state", "since", "firstFailAt", "lastOkAt", "lastError"}
        self._hosts: dict[str, dict] = {
            hid: {"state": "healthy", "since": now, "firstFailAt": None,
                  "lastOkAt": None, "lastError": ""}
            for hid in pod.hosts
        }
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if work_queue is not None:
            # durable-queue registry: a drain journaled by a dead daemon is
            # finished by the next one through the same migrate path
            work_queue.register("drain_gang", self._task_drain)

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        # clear, don't assume fresh: under leader election the monitor is
        # stopped on lease loss and restarted on re-acquire
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="host-monitor", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._interval + 5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the monitor must survive
                log.exception("host health probe failed")

    # -- probing -----------------------------------------------------------------

    def probe_once(self) -> None:
        def probe(hid: str) -> str | None:
            """None = alive, str = the connection error (host-path down)."""
            try:
                self.pod.hosts[hid].runtime.container_list()
            except CONNECTION_ERRORS as e:
                return str(e)
            except Exception as e:  # noqa: BLE001 — engine responded:
                # an application error is a LIVE host with a complaint
                log.warning("host %s probe returned app error: %s", hid, e)
            return None

        # every host probed concurrently: detection wall time is the
        # slowest single probe. Verdicts are applied in sorted host order
        # AFTER the batch settles, so state transitions (and their events)
        # stay deterministic regardless of probe completion order
        hids = sorted(self.pod.hosts)
        results = self._fanout.run([
            (hid, "container_list", lambda h=hid: probe(h)) for hid in hids])
        for hid, r in zip(hids, results):
            err = r.unwrap()
            if err is None:
                self._probe_ok(hid)
            else:
                self._probe_failed(hid, err)

    def _probe_ok(self, hid: str) -> None:
        now = self._clock()
        with self._mu:
            st = self._hosts[hid]
            prev = st["state"]
            st.update(state="healthy", lastOkAt=now, firstFailAt=None,
                      lastError="")
            if prev != "healthy":
                st["since"] = now
        if prev == "down":
            self.slices.set_host_down(hid, False)
            self._record("host-recovered", hid, was="down")
        elif prev == "suspect":
            self._record("host-blip-over", hid)

    def _probe_failed(self, hid: str, err: str) -> None:
        now = self._clock()
        newly_down = False
        held = False
        with self._mu:
            st = self._hosts[hid]
            prev = st["state"]
            st["lastError"] = err
            if prev == "healthy":
                st.update(state="suspect", since=now, firstFailAt=now)
            elif prev == "suspect":
                first = st["firstFailAt"]
                if first is None:
                    st["firstFailAt"] = first = now
                if now - first >= self._grace:
                    if (self._store_gate is not None
                            and not self._store_gate()):
                        # store outage: the verdict would cascade into
                        # migration writes that cannot land — stay suspect,
                        # grace clock running, and confirm after the heal
                        held = True
                    else:
                        st.update(state="down", since=now)
                        newly_down = True
        if held:
            self.store_skips += 1
            if not self._store_held:
                self._store_held = True
                self._record("store-outage-hold", hid, error=err)
        elif self._store_held and (newly_down or prev == "suspect"):
            self._store_held = False
            self._record("store-outage-over", hid)
        if prev == "healthy":
            self._record("host-suspect", hid, error=err)
        if newly_down:
            # past the grace window: confirmed down — stop placing on it
            # and wake the supervisor so gang migration starts NOW
            self.slices.set_host_down(hid, True)
            self._record("host-down", hid, error=err,
                         grace_s=self._grace)
            self._registry.counter_inc(
                "hosts_down_total",
                help="Hosts confirmed down (grace window elapsed)")
            if self._on_down is not None:
                try:
                    self._on_down(hid)
                except Exception:  # noqa: BLE001
                    log.exception("on_down hook failed for %s", hid)

    def is_down(self, hid: str) -> bool:
        with self._mu:
            st = self._hosts.get(hid)
            return st is not None and st["state"] == "down"

    def host_state(self, hid: str) -> str:
        with self._mu:
            st = self._hosts.get(hid)
            return st["state"] if st else "unknown"

    # -- operator surface --------------------------------------------------------

    def cordon(self, hid: str) -> dict:
        out = self.slices.cordon_host(hid)
        self._record("host-cordoned", hid)
        return out

    def uncordon(self, hid: str) -> dict:
        out = self.slices.uncordon_host(hid)
        self._record("host-uncordoned", hid)
        return out

    def drain(self, hid: str) -> dict:
        """Cordon ``hid`` immediately, then migrate every gang with a
        member on it — asynchronously, one work-queue task per family (a
        drain of a host running N gangs must not hold the HTTP request
        for N gang restarts). A family whose migration finds no healthy
        capacity fails LOUDLY: the task raises ``ChipNotEnough``, retries,
        and dead-letters (observable at /api/v1/debug/deadletters and in
        the host events ring) — and the running gang is left untouched
        (migrate_gang's allocate-first path frees nothing on failure)."""
        if self._job_svc is None or self._job_versions is None \
                or self._wq is None:
            raise errors.BadRequest(
                "drain requires the job service, job versions, and "
                "work queue")
        out = self.cordon(hid)
        families = []
        for base in sorted(self._job_versions.snapshot()):
            latest = self._job_versions.get(base)
            if latest is None:
                continue
            try:
                st = self._job_svc.store.get_job(f"{base}-{latest}")
            except errors.NotExistInStore:
                continue
            # DORMANT covers queued/preempted too: a preempted gang keeps
            # its stale placements but holds nothing on the host — a
            # drain_gang record for it would only dead-letter (migrate
            # rejects dormant phases); re-admission places post-cordon
            if (st.desired_running and st.phase not in DORMANT_PHASES
                    and any(h == hid for h, *_ in st.placements)):
                families.append(base)
        for base in families:
            # declarative record, not a closure: the drain intent survives
            # a daemon crash and replays under the next daemon
            self._wq.submit_record(
                "drain_gang", {"base": base, "host": hid},
                idempotency_key=f"drain:{hid}:{base}")
        self._record("host-drain-queued", hid, jobs=families)
        out["drainingJobs"] = families
        return out

    def _task_drain(self, rec) -> None:
        """Execute (or replay) a ``drain_gang`` record. Naturally
        idempotent: a migration that already ran surfaces as
        ``NoPatchRequired`` (no member left on the host) and settles as
        drained instead of moving the gang twice."""
        base, hid = rec.params["base"], rec.params["host"]
        try:
            if self._drain_shrink(base, hid):
                # elastic gangs shrink off the drained host instead of
                # migrating the whole gang: the surviving members never
                # stop longer than the resize restart, and N-1 hosts'
                # worth of checkpoint state is never re-read — fewer
                # moved bytes on a live drain. The dropped members grow
                # back through the admission queue (onto other hosts; the
                # drained one is cordoned).
                self._record("job-drain-shrunk", hid, job=base)
                return
            # allocate-first only: a drain targets a LIVE host, so a
            # capacity failure must leave the gang running and free
            # nothing. Operator-driven, so it never burns the
            # fault-migration budget.
            self._job_svc.migrate_gang(
                base, exclude_hosts={hid},
                reason=f"drain of host {hid}",
                count_migration=False, release_first_ok=False)
            self._record("job-drained", hid, job=base)
        except errors.NoPatchRequired:
            # the latest version has no member on the host — but a
            # PREVIOUS drain attempt may have died between creating
            # the new gang and starting it, so "off the host" is not
            # the same as "healthy". Report honestly; the supervisor
            # finishes a half-started gang through its normal path.
            latest = self._job_versions.get(base)
            try:
                st = (self._job_svc.store.get_job(f"{base}-{latest}")
                      if latest is not None else None)
            except errors.NotExistInStore:
                st = None
            if (st is not None and st.desired_running
                    and self._job_svc._any_member_down(st)):
                self._record("host-drain-incomplete", hid, job=base,
                             note="gang re-placed off the host but not "
                             "fully running; supervisor will finish")
            else:
                self._record("job-drained", hid, job=base,
                             note="already off the host")
        except errors.ApiError as e:
            self._record("host-drain-failed", hid, job=base,
                         error=str(e))
            raise  # work-queue retries, then dead-letters — loud

    def _drain_shrink(self, base: str, hid: str) -> bool:
        """Offer an elastic gang a SHRINK off the draining host before
        reaching for whole-gang migration: the surviving members restart
        in place (no re-placement, no checkpoint re-read on N-1 hosts —
        fewer moved bytes on a live drain) and the dropped members grow
        back through the admission queue onto other hosts. Returns True
        when the shrink handled the drain; False keeps the migrate path's
        jurisdiction. Only taken when the survivors stay at or above
        ``min_members`` AND the count heuristic says the shrunken gang
        re-places on the remaining hosts — a drain must never end with a
        stopped gang."""
        svc = self._job_svc
        if not getattr(svc, "resize_enabled", True):
            return False
        latest = self._job_versions.get(base)
        if latest is None:
            return False
        try:
            st = svc.store.get_job(f"{base}-{latest}")
        except errors.NotExistInStore:
            return False
        if not (st.elastic and st.num_slices == 1
                and st.phase == "running" and st.desired_running):
            return False
        if not any(h == hid for h, *_ in st.placements):
            return False
        survivors = sum(1 for h, *_ in st.placements if h != hid)
        if not max(st.min_members, 1) <= survivors < len(st.placements):
            return False
        per_host = svc.pod.chips_per_host
        if not svc.slices.fits(survivors * per_host, 1,
                               assume_freed={st.job_name},
                               exclude_hosts={hid}):
            return False
        try:
            svc.resize_gang(base, survivors, exclude_hosts={hid},
                            reason="drain")
            return True
        except errors.NoPatchRequired:
            return True  # raced off the host already
        except errors.ApiError as e:
            log.info("drain shrink of %s off %s declined (%s); falling "
                     "back to migration", base, hid, e)
            return False

    # -- views -------------------------------------------------------------------

    def _record(self, kind: str, host: str, **extra) -> None:
        evt = trace.stamp({"ts": time.time(), "host": host, "event": kind,
                           **extra})
        with self._mu:
            self._events.append(evt)
        log.info("host event: %s %s %s", host, kind, extra or "")

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            return list(self._events)[-limit:]

    def status_view(self) -> dict:
        """GET /api/v1/health/hosts — per-host probe state + breaker +
        schedulability, O(1) I/O (served from the last probe's
        observations; a hung engine must not wedge the dashboard)."""
        now = self._clock()
        cordoned = self.slices.cordoned_hosts()
        out = {}
        with self._mu:
            states = {hid: dict(st) for hid, st in self._hosts.items()}
        for hid in sorted(self.pod.hosts):
            host = self.pod.hosts[hid]
            st = states.get(hid, {})
            entry = {
                "address": host.address,
                "state": st.get("state", "unknown"),
                "sinceS": round(now - st.get("since", now), 3),
                "cordoned": hid in cordoned,
                "schedulable": self.slices.host_schedulable(hid),
                **({"lastError": st["lastError"]}
                   if st.get("lastError") else {}),
            }
            if isinstance(host.runtime, BreakerRuntime):
                entry["breaker"] = host.runtime.view()
            out[hid] = entry
        return {"hosts": out, "downGraceS": self._grace,
                "probeIntervalS": self._interval}
