"""Bounded runtime fan-out: concurrent engine calls with serial semantics.

Every multi-member flow in the service layer — gang create/start/stop/
remove, host health probes, liveness scans, reconciler scrubs — walks the
pod one engine call at a time, so an N-member gang costs O(N) engine
round trips in *wall clock* even where batched txns make it O(1) in
*store* round trips. On a multi-host pod with 10-100 ms per engine call
this is the
dominant latency term of every lifecycle flow, and one slow or
breaker-open host serializes behind every healthy one.

:class:`Fanout` is the one concurrency primitive those flows share: a
per-pod bounded thread pool with a ``run(calls) -> [FanoutResult]``
batch API.

Contracts (the parts the chaos suite and the ordering audit depend on):

- **Results are positional.** ``run`` returns one :class:`FanoutResult`
  per submitted call, in submission order, regardless of completion
  order — callers map results back to members by index.
- **Exceptions are collected, not raised.** Each call's ``Exception``
  lands in its result (``ok=False``); the caller decides whether a
  failure is tolerable (a stop on an unreachable host) or demands
  rollback (a create). ``BaseException`` — the chaos harness's
  ``SimulatedCrash``, which models ``kill -9`` — is NOT collected: the
  batch stops dispatching, already-running calls are awaited (bounded by
  their own timeouts), and the exception re-raises in the caller thread,
  so a simulated daemon death inside a batch behaves like a daemon death.
- **``workers=1`` is byte-for-byte serial.** Calls run inline on the
  caller thread, in submission order, stopping at the first ``Exception``
  (remaining calls are marked ``skipped``) — exactly the loop shape every
  flow had before fan-out existed, so the single-worker configuration
  reproduces the old behavior including which calls never happen after a
  failure.
- **Barriers are the caller's job.** ``run`` itself is one barrier (it
  returns only when every submitted call settled); ordering constraints
  *between* groups — coordinator-start strictly before any worker-start,
  coordinator-stop strictly after all worker-stops — are expressed as
  consecutive ``run`` batches.

The ``fanout.mid_batch`` crash point fires after the first call of a
batch completes (and before any later call is *dispatched* in serial
mode), modeling a daemon death while a concurrent batch is half-landed —
the chaos tier proves the reconciler converges from that state.

The port's copy of ``tpu_docker_api/runtime/fanout.py``, whole. The
port's daemon builds one pool and hands it to the reconciler; the job
service, supervisor and host monitor that share it in JAX come with ROADMAP
Queue 1 item 10.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Callable, Sequence

from tpu_docker_api_torch.service.crashpoints import crash_point
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.telemetry.metrics import MetricsRegistry

#: fanout_batch_ms histogram buckets (milliseconds — the default registry
#: buckets are second-scaled and would collapse every batch into one bin)
_BATCH_MS_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                     1000.0, 5000.0)


@dataclasses.dataclass
class FanoutResult:
    """Outcome of one call in a batch. Exactly one of the three shapes:
    ``ok`` (value holds the return), failed (``error`` holds the
    exception), or ``skipped`` (serial mode stopped at an earlier
    failure before this call was dispatched — it never ran)."""
    key: str
    ok: bool = False
    value: object = None
    error: Exception | None = None
    skipped: bool = False

    def unwrap(self):
        if self.ok:
            return self.value
        if self.error is not None:
            raise self.error
        raise RuntimeError(f"fanout call {self.key!r} was skipped")


class Fanout:
    """Bounded executor for independent engine calls.

    One instance per pod (daemon.py wires it into the job service, the
    supervisor, the host monitor and the reconciler) so the *total*
    engine-call concurrency of the process is capped by ``workers``, not
    multiplied across subsystems. ``workers=1`` never builds a thread
    pool at all — the serial path is the code, not a degenerate pool.
    """

    def __init__(self, workers: int = 1,
                 registry: MetricsRegistry | None = None,
                 name: str = "engine") -> None:
        self.workers = max(1, int(workers))
        self._registry = registry
        self._name = name
        self._mu = threading.Lock()
        self._inflight = 0
        self._batches = 0
        self._calls = 0
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None

    # -- the primitive -----------------------------------------------------------

    def run(self, calls: Sequence[tuple[str, str, Callable]]
            ) -> list[FanoutResult]:
        """Run ``(key, op, fn)`` calls, return results in submission order.

        ``key`` labels the target (container/host name) for diagnostics;
        ``op`` labels the runtime operation for the ``runtime_calls_total``
        counter. See the module docstring for the exception contract.
        """
        calls = list(calls)
        if not calls:
            return []
        t0 = time.perf_counter()
        # one span per batch; each call records a child under it (the
        # explicit-parent form — pool worker threads don't inherit the
        # caller's context). No active trace ⇒ both are shared no-ops.
        with trace.child("fanout.batch", calls=len(calls),
                         workers=self.workers) as batch_span:
            try:
                if self.workers == 1 or len(calls) == 1:
                    results = self._run_serial(calls, batch_span)
                else:
                    results = self._run_parallel(calls, batch_span)
            finally:
                self._account(calls, t0)
        return results

    def _run_serial(self, calls, batch_span=None) -> list[FanoutResult]:
        results: list[FanoutResult] = []
        failed = False
        for i, (key, op, fn) in enumerate(calls):
            if failed:
                results.append(FanoutResult(key=key, skipped=True))
                continue
            try:
                results.append(FanoutResult(
                    key=key, ok=True,
                    value=self._guarded_call(fn, batch_span, op, key)))
            except Exception as e:  # noqa: BLE001 — collected per contract
                results.append(FanoutResult(key=key, error=e))
                failed = True
            if i == 0:
                # the half-landed-batch crash seam: first call settled,
                # the rest not yet dispatched
                crash_point("fanout.mid_batch")
        return results

    @staticmethod
    def _guarded_call(fn, batch_span, op: str, key: str):
        with trace.child_of(batch_span, f"engine.{op}", key=key):
            return fn()

    def _run_parallel(self, calls, batch_span=None) -> list[FanoutResult]:
        pool = self._ensure_pool()
        futures: list[concurrent.futures.Future] = []
        with self._mu:
            self._inflight += len(calls)
        try:
            # ANY exit from this block other than a clean return — the
            # fatal (kill -9) path, the armed crash point, a submit
            # refused by a closing pool, a CancelledError from result() —
            # must first settle the batch (_abandon: cancel the
            # un-started, await the running), or calls would land AFTER
            # the batch raised and the post-crash world would not be
            # settled when reconciliation starts
            try:
                for key, op, fn in calls:
                    futures.append(pool.submit(self._guard, fn,
                                               batch_span, op, key))
                results: list[FanoutResult] = [None] * len(calls)  # type: ignore
                # collect in as-completed order (the mid-batch crash point
                # must fire while peers are genuinely in flight), fill
                # positionally
                index = {f: i for i, f in enumerate(futures)}
                first = True
                for fut in concurrent.futures.as_completed(futures):
                    i = index[fut]
                    key = calls[i][0]
                    outcome, payload = fut.result()
                    if outcome == "ok":
                        results[i] = FanoutResult(key=key, ok=True,
                                                  value=payload)
                    elif outcome == "error":
                        results[i] = FanoutResult(key=key, error=payload)
                    else:  # "fatal": BaseException — the simulated kill -9
                        raise payload
                    if first:
                        first = False
                        crash_point("fanout.mid_batch")
                return results
            except BaseException:
                self._abandon(futures)
                raise
        finally:
            with self._mu:
                self._inflight -= len(calls)

    @staticmethod
    def _guard(fn, batch_span=None, op: str = "",
               key: str = "") -> tuple[str, object]:
        """Worker-side wrapper: never let an exception live only inside a
        Future (a dropped Future would swallow a SimulatedCrash and break
        the kill -9 model). The per-call span closes before the outcome is
        captured, so a SimulatedCrash marks it ``lost`` on the way out."""
        try:
            return "ok", Fanout._guarded_call(fn, batch_span, op, key)
        except Exception as e:  # noqa: BLE001
            return "error", e
        except BaseException as e:  # SimulatedCrash et al.
            return "fatal", e

    @staticmethod
    def _abandon(futures) -> None:
        """Crash semantics: cancel what never started, await what did (so
        the post-crash world is settled — no call lands *after* the fresh
        daemon begins reconciling), then the caller re-raises."""
        for f in futures:
            f.cancel()
        concurrent.futures.wait(futures)

    def _ensure_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._mu:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix=f"fanout-{self._name}")
            return self._pool

    def _account(self, calls, t0: float) -> None:
        with self._mu:
            self._batches += 1
            self._calls += len(calls)
        if self._registry is None:
            return
        for _, op, _fn in calls:
            self._registry.counter_inc(
                "runtime_calls_total", {"op": op},
                help="Engine calls issued through the runtime fan-out layer")
        self._registry.counter_inc(
            "fanout_batches_total",
            help="Fan-out batches executed (one per multi-member flow step)")
        self._registry.observe(
            "fanout_batch_ms", (time.perf_counter() - t0) * 1e3,
            buckets=_BATCH_MS_BUCKETS,
            help="Wall-clock per fan-out batch, milliseconds")

    # -- views / lifecycle -------------------------------------------------------

    def inflight(self) -> int:
        with self._mu:
            return self._inflight

    def status_view(self) -> dict:
        with self._mu:
            return {
                "workers": self.workers,
                "inflight": self._inflight,
                "batches": self._batches,
                "calls": self._calls,
            }

    def close(self) -> None:
        with self._mu:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


#: module default for components constructed without explicit wiring
#: (tests building a bare JobService): serial, unregistered — the exact
#: pre-fan-out behavior
SERIAL = Fanout(1)
