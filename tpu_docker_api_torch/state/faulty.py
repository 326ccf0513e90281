"""Deterministic fault injection for the state store: ``FaultyKV``.

The store-side half of the chaos tier (docs/robustness.md "Store
brownouts"), mirroring :class:`~tpu_docker_api_torch.runtime.faulty.FaultyRuntime`
exactly: where crash points kill the control plane and FaultyRuntime makes
the *engine* misbehave, FaultyKV makes the *store* misbehave — on a
schedule, so every brownout a test provokes is reproducible. It replaces
the ad-hoc ``_OutageKV`` helpers that used to be copy-pasted across test
files, and is the substrate ``bench-brownout`` churns against.

Fault surface:

- **Scripted rules** — the same :class:`FaultRule`/:class:`FaultPlan`
  machinery as the runtime side (re-exported here), targeting KV op names
  (``"get"``, ``"apply"``, ``"range_prefix_with_rev"``, ...) with the same
  four modes: ``fail`` (raise before the op), ``ambiguous`` (the op LANDS,
  then an error is returned — the classic timeout-after-commit), ``latency``
  (sleep, then run) and ``unreachable``. KV-side rules raise the typed
  :class:`errors.StoreUnavailable` so production code classifies injected
  faults exactly like real ones.
- **Hard outage** — :meth:`set_outage` flips a persistent every-op-fails
  switch (the store process died / the network to it is gone), including
  the watch stream: an open watch's ``poll`` raises ``StoreUnavailable``
  so the informer degrades loudly and relists on heal.
- **Per-prefix partition** — :meth:`set_partition` fails only ops touching
  keys under a prefix (one keyspace shard behind a broken route), the
  generalization of the old workqueue ``_OutageKV``'s journal-only gate.
- **Latency window** — :meth:`set_latency` sleeps every op by a fixed
  amount (a slow, not dead, store — the brownout half of the bench).

``calls`` journals ``(op, key, outcome)`` with outcome ∈ {"ok", "fail",
"ambiguous", "latency", "unreachable"} under one lock, like
FaultyRuntime's; probabilistic rules draw from ``random.Random(plan.seed)``
so a plan replays identically.

The port's copy of ``tpu_docker_api/state/faulty.py``, whole.
"""

from __future__ import annotations

import threading
import time

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.faulty import (  # noqa: F401 — re-exported: the
    FaultPlan,  # KV chaos surface is one vocabulary with the runtime side
    FaultRule,
)
from tpu_docker_api_torch.state.kv import KV, Watch, WatchEvent  # noqa: F401


def _store_error(op: str) -> Exception:
    return errors.StoreUnavailable(f"injected outage on {op}")


class _FaultyWatch(Watch):
    """Watch wrapper: while the outage/partition covers the watched
    prefix, ``poll`` raises ``StoreUnavailable`` — a dead store cannot
    stream events, and an informer that kept draining a live watch through
    an "outage" would never degrade, making the chaos vacuous."""

    def __init__(self, kv: "FaultyKV", inner: Watch, prefix: str) -> None:
        self._kv = kv
        self._inner = inner
        self._prefix = prefix

    def poll(self, timeout_s: float) -> list[WatchEvent]:
        self._kv._check_reachable("watch.poll", self._prefix)
        return self._inner.poll(timeout_s)

    def close(self) -> None:
        self._inner.close()


class FaultyKV(KV):
    """Delegates every op to ``inner``, consulting the fault state first.

    Thread safety mirrors FaultyRuntime: the (count, rule, journal entry)
    triple is taken under one lock; the inner op — and a latency sleep —
    runs outside it so concurrency stays real.
    """

    def __init__(self, inner: KV, plan: FaultPlan | None = None) -> None:
        self.inner = inner
        self.plan = plan or FaultPlan()
        self.calls: list[tuple[str, str, str]] = []
        self._mu = threading.Lock()
        self._counts: dict[str, int] = {}
        self._outage = False
        self._partitions: set[str] = set()
        self._latency_s = 0.0

    # -- fault control surface ---------------------------------------------------

    def set_outage(self, down: bool = True) -> None:
        """Hard outage: every op — reads, writes, watch polls — raises
        ``StoreUnavailable`` until cleared. The store process died."""
        self._outage = down

    def set_partition(self, prefix: str, active: bool = True) -> None:
        """Partition one keyspace subtree: ops touching a key (or a range
        overlapping) under ``prefix`` fail; everything else is healthy."""
        if active:
            self._partitions.add(prefix)
        else:
            self._partitions.discard(prefix)

    def set_latency(self, seconds: float) -> None:
        """Slow-store window: every op sleeps ``seconds`` first (0 = off).
        The brownout's first act — latency, not death."""
        self._latency_s = max(0.0, seconds)

    def fail_nth(self, op: str, n: int, mode: str = "fail",
                 times: int = 1) -> None:
        """Script call numbers ``n .. n+times-1`` of ``op`` to fail with the
        typed ``StoreUnavailable`` (``mode="ambiguous"`` lands the op
        first) — the flake-N-then-heal shape the informer recovery tests
        drive."""
        self.plan.rules.append(FaultRule(
            op=op, on_calls=frozenset(range(n, n + times)), mode=mode,
            times=times, error=_store_error))

    def add_rules(self, rules) -> None:
        self.plan.rules.extend(rules)

    def clear_rules(self) -> None:
        self.plan.rules.clear()

    def op_count(self, op: str) -> int:
        return self._counts.get(op, 0)

    # -- interception ------------------------------------------------------------

    def _partitioned(self, key: str) -> bool:
        # single keys match by prefix; range ops pass their prefix as the
        # key, so overlap in EITHER direction hits the partition (a scan
        # of /apis/v1/ must fail when /apis/v1/queue/ is unroutable — the
        # result would silently exclude the partitioned subtree)
        return any(key.startswith(p) or p.startswith(key)
                   for p in self._partitions)

    def _check_reachable(self, op: str, key: str) -> None:
        if self._outage:
            with self._mu:
                self.calls.append((op, key, "unreachable"))
            raise errors.StoreUnavailable(
                f"injected store outage: connection refused on {op}")
        if self._partitions and self._partitioned(key):
            with self._mu:
                self.calls.append((op, key, "unreachable"))
            raise errors.StoreUnavailable(
                f"injected partition: {key!r} unroutable on {op}")

    def _invoke(self, op: str, key: str, fn):
        self._check_reachable(op, key)
        with self._mu:
            self._counts[op] = self._counts.get(op, 0) + 1
            rule = self.plan.decide(op, self._counts[op])
            if rule is None or rule.mode == "latency":
                self.calls.append((op, key, "ok" if rule is None else "latency"))
            elif rule.mode == "fail":
                self.calls.append((op, key, "fail"))
                raise rule.error(op)
            elif rule.mode == "unreachable":
                self.calls.append((op, key, "unreachable"))
                raise errors.StoreUnavailable(
                    f"injected store outage: connection refused on {op}")
        if self._latency_s > 0:
            time.sleep(self._latency_s)
        if rule is None:
            return fn()
        if rule.mode == "latency":
            time.sleep(rule.latency_s)
            return fn()
        # ambiguous: the op takes effect AND the caller sees an error —
        # journaled only once the effect actually landed
        result = fn()
        del result
        with self._mu:
            self.calls.append((op, key, "ambiguous"))
        raise rule.error(op)

    # -- the KV surface ----------------------------------------------------------

    def put(self, key: str, value: str) -> None:
        return self._invoke("put", key, lambda: self.inner.put(key, value))

    def get(self, key: str) -> str:
        return self._invoke("get", key, lambda: self.inner.get(key))

    def delete(self, key: str) -> None:
        return self._invoke("delete", key, lambda: self.inner.delete(key))

    def range_prefix(self, prefix: str) -> dict[str, str]:
        return self._invoke("range_prefix", prefix,
                            lambda: self.inner.range_prefix(prefix))

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        return self._invoke(
            "keys_prefix", prefix,
            lambda: self.inner.keys_prefix(prefix, limit=limit,
                                           start_after=start_after))

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "",
                          at_rev: int = 0) -> tuple[dict[str, str], int]:
        return self._invoke(
            "range_prefix_page", prefix,
            lambda: self.inner.range_prefix_page(prefix, limit,
                                                 start_after=start_after,
                                                 at_rev=at_rev))

    def range_prefix_with_rev(self, prefix: str) -> tuple[dict[str, str], int]:
        return self._invoke(
            "range_prefix_with_rev", prefix,
            lambda: self.inner.range_prefix_with_rev(prefix))

    def delete_prefix(self, prefix: str) -> None:
        return self._invoke("delete_prefix", prefix,
                            lambda: self.inner.delete_prefix(prefix))

    def current_rev(self) -> int:
        return self._invoke("current_rev", "*",
                            lambda: self.inner.current_rev())

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        # the base template (our public ``apply``) already validated and
        # fired the txn crash points — delegate to the inner backend's
        # atomic ``_apply`` so they never fire twice per batch. The first
        # op's key names the batch in the journal/partition check (every
        # production batch touches one family subtree).
        key = ops[0][1] if ops else (guards[0][1] if guards else "*")
        return self._invoke("apply", key,
                            lambda: self.inner._apply(ops, guards))

    def watch(self, prefix: str, start_rev: int = 0) -> Watch:
        self._check_reachable("watch", prefix)
        return _FaultyWatch(self, self.inner.watch(prefix, start_rev), prefix)

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name: str):
        # backend-specific helpers pass through un-faulted — they model
        # the test harness reaching around the fault, not store traffic
        return getattr(self.inner, name)
