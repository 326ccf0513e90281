"""Container health watch + crash recovery (SURVEY.md §5.3).

The reference has no failure detection: a container that dies stays dead and
its chips stay marked used until someone notices. This watcher closes that
gap — a daemon thread polls the runtime, records every liveness transition as
an event, and (policy-gated) restarts containers that exited unexpectedly,
with a bounded restart budget so crash-looping workloads dead-letter instead
of flapping forever (the same bounded-retry stance the work queue takes vs
the reference's infinite re-enqueue, workQueue.go:33-47).

Events are a ring buffer served at ``GET /api/v1/events`` — the control-plane
analog of ``kubectl get events``.

The port's copy of ``tpu_docker_api/service/watch.py``.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from tpu_docker_api_torch.runtime.base import ContainerRuntime
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry, REGISTRY

log = logging.getLogger(__name__)


class HealthWatcher:
    """Polls container liveness; optionally restarts crashed containers.

    restart_policy:
      - "none":       observe + record only
      - "on-failure": restart containers that were seen running and turned
                      up dead with a nonzero exit code, up to max_restarts
                      per container version

    ``crash_handler`` (ContainerService.handle_crash when wired by the
    daemon) is the accounting-aware recovery path: it holds the family lock,
    checks declarative liveness, and refuses retired versions. The direct
    runtime restart is only a fallback for standalone use of the watcher.

    ``job_crash_handler`` (JobSupervisor.handle_member_death when wired) is
    consulted FIRST on every death: a container that belongs to a
    distributed job must never be restarted in isolation — one member
    rejoining a wedged ``torch.distributed`` collective helps nobody — so the
    watcher delegates it to the gang supervisor and stays hands-off.

    ``restart_backoff_s`` > 0 spaces restart attempts exponentially
    (``base·2^n``, clamped to ``restart_backoff_max_s``): without it a tight
    crash loop burns the whole ``max_restarts`` budget in a few poll ticks.
    A deferred restart is retried on later polls once the deadline passes
    and does not consume budget.
    """

    def __init__(
        self,
        runtime: ContainerRuntime,
        interval_s: float = 5.0,
        restart_policy: str = "none",
        max_restarts: int = 3,
        max_events: int = 512,
        crash_handler=None,
        job_crash_handler=None,
        restart_backoff_s: float = 0.0,
        restart_backoff_max_s: float = 30.0,
        clock=time.monotonic,
        registry: MetricsRegistry | None = None,
    ) -> None:
        if restart_policy not in ("none", "on-failure"):
            raise ValueError(f"unknown restart_policy {restart_policy!r}")
        self._runtime = runtime
        self._interval = interval_s
        self._policy = restart_policy
        self._max_restarts = max_restarts
        self._crash_handler = crash_handler
        self._job_crash_handler = job_crash_handler
        self._backoff_s = restart_backoff_s
        self._backoff_max_s = restart_backoff_max_s
        self._clock = clock
        self._registry = registry if registry is not None else REGISTRY
        self._mu = threading.Lock()
        self._last_running: dict[str, bool] = {}
        self._restarts: dict[str, int] = {}
        #: containers that died a crash-death and still await a restart
        #: (deferred by backoff); name → earliest monotonic retry time
        self._pending_restart: dict[str, float] = {}
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        # clear, don't assume fresh: under leader election the watcher is
        # stopped on lease loss and restarted on re-acquire
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="health-watch", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._interval + 5)
            self._thread = None

    # -- the watch loop ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must survive
                log.exception("health watch poll failed")

    def poll_once(self) -> None:
        """One scan; separated from the loop for tests and manual ticks."""
        names = set(self._runtime.container_list())
        with self._mu:
            known = dict(self._last_running)

        # disappeared entirely (removed out-of-band)
        for name in set(known) - names:
            self._record(name, "removed", known[name])
            with self._mu:
                self._last_running.pop(name, None)
                self._restarts.pop(name, None)
                self._pending_restart.pop(name, None)

        for name in names:
            try:
                info = self._runtime.container_inspect(name)
            except Exception:  # container vanished between list and inspect
                continue
            was = known.get(name)
            now = info.running
            if was is None:
                self._record(name, "observed", now)
            elif was and not now:
                self._record(name, "died", now, exit_code=info.exit_code)
                self._registry.counter_inc(
                    "containers_died_total",
                    help="Containers observed transitioning running→dead")
                if (self._job_crash_handler is not None
                        and self._job_crash_handler(name)):
                    # job member: gang supervision owns recovery — the
                    # container path must never restart it in isolation
                    self._record(name, "delegated-to-job-supervisor", False)
                    with self._mu:
                        self._pending_restart.pop(name, None)
                elif self._policy == "on-failure" and info.exit_code != 0:
                    now = self._try_restart(name)
                else:
                    # deliberately not restarted (clean exit / observe-only
                    # policy): a stale backoff deadline from an earlier
                    # crash must not resurrect this container later via the
                    # deferred-retry branch
                    with self._mu:
                        self._pending_restart.pop(name, None)
            elif not was and now:
                self._record(name, "started", now)
                with self._mu:
                    self._pending_restart.pop(name, None)
            elif not was and not now and name in self._pending_restart:
                # died earlier, restart deferred by backoff — retry once the
                # deadline passes (no running→dead edge fires again)
                now = self._try_restart(name)
            with self._mu:
                self._last_running[name] = now

    def _try_restart(self, name: str) -> bool:
        """Returns the container's liveness after the attempt."""
        ts = self._clock()
        with self._mu:
            deadline = self._pending_restart.get(name, 0.0)
            if ts < deadline:
                defer = deadline - ts
            else:
                defer = 0.0
            n = self._restarts.get(name, 0)
            if defer == 0.0:
                if n >= self._max_restarts:
                    give_up = True
                else:
                    give_up = False
                    self._restarts[name] = n + 1
        if defer > 0.0:
            self._record(name, "restart-deferred", False,
                         wait_s=round(defer, 3))
            return False
        if give_up:
            with self._mu:
                self._pending_restart.pop(name, None)
            self._record(name, "restart-budget-exhausted", False)
            return False
        if self._backoff_s > 0:
            # arm the NEXT attempt's deadline before acting
            from tpu_docker_api_torch.utils.backoff import backoff_delay_s

            with self._mu:
                self._pending_restart[name] = ts + backoff_delay_s(
                    n, self._backoff_s, self._backoff_max_s)
        try:
            if self._crash_handler is not None:
                if not self._crash_handler(name):
                    # service declined: deliberate stop, retired version, or
                    # family gone — don't count against the budget either
                    with self._mu:
                        self._restarts[name] = n
                        self._pending_restart.pop(name, None)
                    self._record(name, "restart-declined", False)
                    return False
            else:
                self._runtime.container_restart(name)
            self._record(name, "restarted", True, attempt=n + 1)
            self._registry.counter_inc(
                "containers_restarted_total",
                help="Automatic restarts by the health watcher")
            return True
        except Exception as e:  # noqa: BLE001
            log.warning("auto-restart of %s failed: %s", name, e)
            self._record(name, "restart-failed", False, error=str(e))
            return False

    # -- views -------------------------------------------------------------------

    def _record(self, name: str, kind: str, running: bool, **extra) -> None:
        evt = trace.stamp({"ts": time.time(), "container": name,
                           "event": kind, "running": running, **extra})
        with self._mu:
            self._events.append(evt)
        log.info("event: %s %s running=%s %s", name, kind, running,
                 extra or "")

    def events_view(self, limit: int = 100) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            return list(self._events)[-limit:]

    def status_view(self) -> dict:
        with self._mu:
            return {
                "watched": dict(self._last_running),
                "restartPolicy": self._policy,
                "restarts": dict(self._restarts),
            }
