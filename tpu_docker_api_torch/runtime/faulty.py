"""Deterministic fault-injection wrapper around any ContainerRuntime.

The chaos tier's second half (docs/robustness.md): where crash points kill
the control plane, ``FaultyRuntime`` makes the *engine* misbehave — on a
schedule, so every failure a test provokes is reproducible. A
:class:`FaultPlan` is a list of rules; each rule targets one runtime op and
fires on chosen call numbers with one of three modes:

- ``fail``:        raise before the op runs (one flaky call);
- ``ambiguous``:   run the op, THEN raise — the classic distributed-systems
  failure where the effect landed but the caller sees an error (timeout
  after the engine committed);
- ``latency``:     sleep, then run the op normally (slow engine);
- ``unreachable``: raise :class:`~tpu_docker_api_torch.errors.HostUnreachable`
  before the op runs (the connection-class failure host circuit breakers
  classify — a dockerd hang / NIC death as one scripted call).

For a host that goes down *as a whole* (every op failing until an operator
or a reboot brings it back), :meth:`FaultyRuntime.set_unreachable` flips a
persistent flag — the host-failure chaos tier's blip/dead switch — instead
of scripting every op.

Probabilistic rules draw from ``random.Random(seed)`` so a plan replays
identically; scripted rules (``on_calls``) need no randomness at all.

The port's copy of ``tpu_docker_api/runtime/faulty.py``, whole: the
port's own chaos tool.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Iterable

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import (
    ContainerInfo,
    ContainerRuntime,
    ExecResult,
    VolumeInfo,
)
from tpu_docker_api_torch.runtime.spec import ContainerSpec


class InjectedFault(errors.ApiError):
    """Raised by a fault rule (subclasses ApiError so the service layer's
    real error handling — rollbacks, dead-letters — engages, not a test
    backdoor)."""
    code = 10901


@dataclasses.dataclass
class FaultRule:
    """One scripted misbehavior of one runtime op.

    ``op``        — method name ("container_stop", "container_create", ...).
    ``on_calls``  — 1-based call numbers of that op which fire the rule
                    (e.g. {2} = the second stop). Empty ⇒ every call is a
                    candidate, gated by ``probability``.
    ``mode``      — "fail" | "ambiguous" | "latency" | "unreachable".
    ``latency_s`` — sleep for latency mode.
    ``times``     — total firings before the rule burns out (-1 = forever).
    ``probability`` — chance a candidate call fires (seeded; 1.0 = always).
    ``error``     — exception factory for fail/ambiguous modes.
    """
    op: str
    on_calls: frozenset[int] = frozenset()
    mode: str = "fail"
    latency_s: float = 0.0
    times: int = 1
    probability: float = 1.0
    error: Callable[[str], Exception] = lambda op: InjectedFault(
        f"injected fault on {op}")

    def __post_init__(self) -> None:
        if self.mode not in ("fail", "ambiguous", "latency", "unreachable"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        self.on_calls = frozenset(self.on_calls)


def fail_nth(op: str, n: int, mode: str = "fail") -> FaultRule:
    """The workhorse: fail (or ambiguously fail) the Nth call of ``op``."""
    return FaultRule(op=op, on_calls=frozenset({n}), mode=mode)


@dataclasses.dataclass
class FaultPlan:
    rules: list[FaultRule] = dataclasses.field(default_factory=list)
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def decide(self, op: str, call_no: int) -> FaultRule | None:
        """First live rule matching this (op, call_no), consuming one firing.
        Rules are evaluated in plan order — deterministic."""
        for rule in self.rules:
            if rule.op != op or rule.times == 0:
                continue
            if rule.on_calls and call_no not in rule.on_calls:
                continue
            if rule.probability < 1.0 and self._rng.random() >= rule.probability:
                continue
            if rule.times > 0:
                rule.times -= 1
            return rule
        return None


class FaultyRuntime(ContainerRuntime):
    """Delegates every op to ``inner``, consulting the plan first.

    ``calls`` journals (op, target, outcome) where outcome ∈
    {"ok", "fail", "ambiguous", "latency"} — chaos tests assert on it the
    same way FakeRuntime tests assert on ``runtime.calls``.

    Thread safety: call bookkeeping (the journal append, the per-op call
    counter, the plan's rule matching) is guarded by a lock, so concurrent
    fan-out callers cannot corrupt the log the chaos suite and the
    ordering audit assert on. The journal entry is appended *before* the
    inner op runs (and before a latency rule sleeps), so its order is the
    call *start* order — per-caller order is preserved, and a barrier in
    the caller (coordinator-start after the create batch settles) shows
    up as a strict ordering in the journal.

    ``journal`` / ``journal_lock`` let several per-host FaultyRuntimes
    share ONE log: the fan-out ordering audit needs a *global* order
    across hosts, which per-runtime lists cannot give.
    """

    def __init__(self, inner: ContainerRuntime, plan: FaultPlan | None = None,
                 journal: list | None = None,
                 journal_lock: threading.Lock | None = None) -> None:
        self.inner = inner
        self.plan = plan or FaultPlan()
        self.calls: list[tuple[str, str, str]] = (
            journal if journal is not None else [])
        self._mu = journal_lock if journal_lock is not None else threading.Lock()
        self._counts: dict[str, int] = {}
        #: host-down switch (set_unreachable): every op fails with
        #: HostUnreachable while set — dockerd hang / host reboot / NIC
        #: death, as opposed to a per-call rule
        self._unreachable = False

    def set_unreachable(self, down: bool = True) -> None:
        """Make the whole engine unreachable (or reachable again). Models a
        host-level fault: every op — including the host monitor's probes —
        raises ``HostUnreachable`` until the flag is cleared."""
        self._unreachable = down

    def _invoke(self, op: str, target: str, fn: Callable):
        # decide + journal under ONE lock hold: the (count, rule, entry)
        # triple must be consistent even when fan-out callers race — the
        # op itself (and a latency rule's sleep) runs outside the lock so
        # concurrency stays real
        with self._mu:
            if self._unreachable:
                self.calls.append((op, target, "unreachable"))
                raise errors.HostUnreachable(
                    f"engine unreachable: connection refused on {op}")
            self._counts[op] = self._counts.get(op, 0) + 1
            rule = self.plan.decide(op, self._counts[op])
            if rule is None or rule.mode == "latency":
                self.calls.append(
                    (op, target, "ok" if rule is None else "latency"))
            elif rule.mode == "fail":
                self.calls.append((op, target, "fail"))
                raise rule.error(op)
            elif rule.mode == "unreachable":  # per-call rule
                self.calls.append((op, target, "unreachable"))
                raise errors.HostUnreachable(
                    f"engine unreachable: connection refused on {op}")
        if rule is None:
            return fn()
        if rule.mode == "latency":
            time.sleep(rule.latency_s)
            return fn()
        # ambiguous: the op takes effect AND the caller sees an error —
        # journaled only once the effect actually LANDED (an inner op that
        # itself raised must not leave an entry claiming it took effect)
        result = fn()
        del result
        with self._mu:
            self.calls.append((op, target, "ambiguous"))
        raise rule.error(op)

    # -- containers --------------------------------------------------------------

    def container_create(self, spec: ContainerSpec) -> str:
        return self._invoke("container_create", spec.name,
                            lambda: self.inner.container_create(spec))

    def container_start(self, name: str) -> None:
        return self._invoke("container_start", name,
                            lambda: self.inner.container_start(name))

    def container_stop(self, name: str, timeout_s: int = 10) -> None:
        return self._invoke("container_stop", name,
                            lambda: self.inner.container_stop(name, timeout_s))

    def container_restart(self, name: str) -> None:
        return self._invoke("container_restart", name,
                            lambda: self.inner.container_restart(name))

    def container_remove(self, name: str, force: bool = False) -> None:
        return self._invoke("container_remove", name,
                            lambda: self.inner.container_remove(name, force))

    def container_inspect(self, name: str) -> ContainerInfo:
        return self._invoke("container_inspect", name,
                            lambda: self.inner.container_inspect(name))

    def container_exists(self, name: str) -> bool:
        return self._invoke("container_exists", name,
                            lambda: self.inner.container_exists(name))

    def container_list(self) -> list[str]:
        return self._invoke("container_list", "*",
                            lambda: self.inner.container_list())

    def container_exec(self, name: str, cmd: list[str],
                       workdir: str = "") -> ExecResult:
        return self._invoke("container_exec", name,
                            lambda: self.inner.container_exec(name, cmd, workdir))

    def container_commit(self, name: str, image_ref: str) -> str:
        return self._invoke("container_commit", name,
                            lambda: self.inner.container_commit(name, image_ref))

    def container_data_dir(self, name: str) -> str:
        return self._invoke("container_data_dir", name,
                            lambda: self.inner.container_data_dir(name))

    # -- volumes -----------------------------------------------------------------

    def volume_create(self, name: str, driver_opts: dict[str, str]) -> VolumeInfo:
        return self._invoke("volume_create", name,
                            lambda: self.inner.volume_create(name, driver_opts))

    def volume_remove(self, name: str, force: bool = False) -> None:
        return self._invoke("volume_remove", name,
                            lambda: self.inner.volume_remove(name, force))

    def volume_inspect(self, name: str) -> VolumeInfo:
        return self._invoke("volume_inspect", name,
                            lambda: self.inner.volume_inspect(name))

    def volume_exists(self, name: str) -> bool:
        return self._invoke("volume_exists", name,
                            lambda: self.inner.volume_exists(name))

    def volume_data_dir(self, name: str) -> str:
        return self._invoke("volume_data_dir", name,
                            lambda: self.inner.volume_data_dir(name))

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name: str):
        # backend-specific helpers (e.g. FakeRuntime.crash_container) pass
        # through un-faulted — they model the environment, not engine calls
        return getattr(self.inner, name)

    # -- plan management ---------------------------------------------------------

    def add_rules(self, rules: Iterable[FaultRule]) -> None:
        self.plan.rules.extend(rules)

    def clear_rules(self) -> None:
        self.plan.rules.clear()

    def op_count(self, op: str) -> int:
        return self._counts.get(op, 0)
