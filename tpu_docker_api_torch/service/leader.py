"""Lease-based leader election + epoch fencing (docs/robustness.md
"HA control plane").

The reference is a single-process control plane (cmd/gpu-docker-api/main.go);
since every byte of control-plane intent became durable and transactional in
KV, multiple daemons can share the store — but only if exactly one of them
runs the writer loops (work-queue sync, reconciler, job supervisor, host
monitor) at a time. This module is that arbiter, modeled on the etcd-lease
election in Kubernetes' client-go:

- :class:`LeaderElector` maintains a TTL **lease record** at
  ``keys.LEADER_LEASE_KEY`` via CAS (``KV.apply`` guards — the store's
  guarded-apply primitive): create-if-absent on an empty store, heartbeat renewal while
  held, steal-on-expiry by a standby. Every transition bumps a monotonically
  increasing **epoch** at ``keys.LEADER_EPOCH_KEY`` in the same atomic
  guarded apply.

- :class:`FencedKV` wraps the daemon's store so every WRITE the process
  issues carries a guard that the epoch key still holds the epoch this
  process acquired. A leader that lost its lease mid-flight — GC pause,
  partition, missed heartbeats — gets a clean typed
  :class:`errors.GuardFailed` on its next write (StoreTxn commit, journal
  claim/ack, scheduler persist ... every mutation funnels through here)
  instead of corrupting state the new leader owns. Reads are never fenced:
  standbys serve them freely.

Split-brain is therefore bounded to READS going slightly stale on a deposed
leader; its writes are structurally rejected by the store itself, not by
cooperation of the deposed process.

The port's copy of ``tpu_docker_api/service/leader.py``, whole: the same
lease and epoch records, so a store one package's daemons elected over
reads the same in the other's.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Callable

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.service.crashpoints import crash_point
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.state.kv import KV

log = logging.getLogger(__name__)

DEFAULT_TTL_S = 15.0


class LeaderElector:
    """One election participant. Drive it with :meth:`start` (background
    heartbeat thread, interval ``renew_interval_s``) or deterministically
    with :meth:`step` (tests, chaos harness). Callbacks:

    - ``on_acquire(epoch)`` — fired synchronously inside the acquiring step,
      AFTER the lease is durable; the daemon starts its writer subsystems
      here. A slow on_acquire eats into the first renewal window, so keep
      writer boot bounded (see the split-brain runbook in
      docs/robustness.md).
    - ``on_loss(reason)`` — fired when leadership is lost for any reason
      (renew CAS lost, lease stolen, store unreachable past our own
      deadline); the daemon halts its writer subsystems here. The FENCING
      epoch is NOT reset on loss: in-flight writes must keep failing their
      guards, not silently become unguarded.

    The elector talks to the RAW (unfenced) store: its lease writes carry
    their own CAS guards, and fencing an epoch bump on the epoch it is
    replacing would be circular.
    """

    def __init__(self, kv: KV, holder_id: str, ttl_s: float = DEFAULT_TTL_S,
                 renew_interval_s: float | None = None,
                 on_acquire: Callable[[int], None] | None = None,
                 on_loss: Callable[[str], None] | None = None,
                 advertise: str = "",
                 clock: Callable[[], float] = time.time,
                 lease_key: str = keys.LEADER_LEASE_KEY,
                 epoch_key: str = keys.LEADER_EPOCH_KEY,
                 shard: int | None = None,
                 defer_vacant_s: float = 0.0) -> None:
        if ttl_s <= 0:
            raise ValueError("leader ttl_s must be > 0")
        self._kv = kv
        self.holder_id = holder_id
        self.ttl_s = ttl_s
        #: which lease this elector contests: the legacy singleton by
        #: default, a per-shard lease/epoch pair in the sharded writer
        #: plane (shard.py instantiates one elector per shard — same CAS,
        #: same fencing, different keys)
        self.lease_key = lease_key
        self.epoch_key = epoch_key
        #: shard id for telemetry (None = the unsharded singleton elector)
        self.shard = shard
        #: boot-spread knob: a NON-preferred elector defers contesting an
        #: ABSENT lease by this much (measured from when it first saw the
        #: vacancy), so each shard lands on its preferred process when the
        #: fleet boots together — but an EXPIRED lease is contested
        #: immediately, so failover after a leader death never waits on
        #: this (recovery stays bounded by the TTL alone).
        self.defer_vacant_s = defer_vacant_s
        self._vacant_since: float | None = None
        # renew well inside the TTL: a single missed heartbeat must not
        # cost the lease
        self.renew_interval_s = (renew_interval_s if renew_interval_s
                                 else ttl_s / 3.0)
        self._on_acquire = on_acquire
        self._on_loss = on_loss
        self._advertise = advertise
        self._clock = clock
        # RLock: on_acquire/on_loss run inside step() and may call back
        # into is_leader/epoch (e.g. a status probe during writer boot)
        self._mu = threading.RLock()
        self._is_leader = False
        #: True only once on_acquire has COMPLETED: the API mutation gate
        #: keys off this, not off _is_leader, so a request arriving while
        #: the writer subsystems are still booting (cache reload, startup
        #: reconcile, journal replay — seconds with a backlog) cannot
        #: allocate against stale boot-time scheduler/version mirrors
        self._accepting = False
        #: last lease record observed while standing by (None = observed
        #: absent); serves the 503 leader hint without a store read per
        #: rejected request — staleness bounded by the heartbeat cadence
        self._observed: dict | None = None
        self._has_observed = False
        #: last epoch this process HELD — the fencing token. Never reset on
        #: loss (see class docstring); 0 = never led, fence_guards() empty.
        self._epoch = 0
        #: exact lease JSON we last wrote — the CAS expected value for the
        #: next renewal (and the guarded delete on graceful release)
        self._lease_raw: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._events: collections.deque = collections.deque(maxlen=64)

    # -- views --------------------------------------------------------------------

    # NOTE: is_leader/epoch/fence_guards are deliberately LOCK-FREE (plain
    # attribute reads, atomic in CPython): they are called from API threads
    # and from the work-queue sync loop via FencedKV — taking ``_mu`` there
    # would stall every request (and wedge ``on_loss`` → ``wq.close()``,
    # which joins the sync thread) behind an in-flight election step.

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    @property
    def epoch(self) -> int:
        """The fencing token: last epoch this process held (0 = never)."""
        return self._epoch

    @property
    def accepts_mutations(self) -> bool:
        """The API gate's predicate: leading AND the writer subsystems are
        fully up (on_acquire completed). False during writer boot, so a
        mutation can never race the leadership-handoff cache reload."""
        return self._is_leader and self._accepting

    def fence_guards(self) -> list[tuple]:
        """Guards every write of this process must carry: the epoch key
        still holds the epoch we acquired. Empty before first acquisition
        (writer subsystems only run while leading, so pre-acquire writes
        are bootstrap-idempotent init snapshots)."""
        epoch = self._epoch
        if epoch <= 0:
            return []
        return [("value", self.epoch_key, str(epoch))]

    def leader_hint(self) -> dict:
        """Who holds the lease (for standby 503s and GET /api/v1/leader).
        Served from memory — our own record while leading, the last
        heartbeat's observation while standing by — so a retry storm
        against a standby costs zero store reads per rejection; the one
        fallback store read covers the never-stepped window, tolerating an
        outage (an unreachable store must not 500 the hint)."""
        if self._is_leader and self._lease_raw is not None:
            rec = json.loads(self._lease_raw)
        elif self._has_observed:
            rec = self._observed
        else:
            try:
                raw = self._kv.get_or(self.lease_key)
                rec = json.loads(raw) if raw else None
            except Exception:  # noqa: BLE001 — a hint, never load-bearing
                rec = None
        if not isinstance(rec, dict):
            return {"holderId": None, "epoch": None, "deadline": None,
                    "advertise": ""}
        return {"holderId": rec.get("holderId"), "epoch": rec.get("epoch"),
                "deadline": rec.get("deadline"),
                "advertise": rec.get("advertise", "")}

    def standby_message(self) -> str:
        if self._is_leader:
            # the boot window: lease held, writer subsystems still starting
            return ("this replica has just acquired leadership and is "
                    "still starting its writer subsystems; retry shortly")
        hint = self.leader_hint()
        if hint["holderId"] is None:
            return ("this replica is a standby and no lease is currently "
                    "held; retry shortly")
        where = f" at {hint['advertise']}" if hint["advertise"] else ""
        return (f"this replica is a standby; the leader is "
                f"{hint['holderId']}{where} (epoch {hint['epoch']})")

    def status_view(self) -> dict:
        """Operator view (GET /api/v1/leader) — lock-free like the other
        read paths, so a status probe never queues behind writer boot."""
        view = {
            "election": True,
            "role": "leader" if self._is_leader else "standby",
            "accepting": self.accepts_mutations,
            "selfId": self.holder_id,
            "ttlS": self.ttl_s,
            "fencingEpoch": self._epoch,
            **self.leader_hint(),
        }
        if self.shard is not None:
            view["shard"] = self.shard
        return view

    def events_view(self, limit: int = 100) -> list[dict]:
        return list(self._events)[-limit:]  # deque snapshots are thread-safe

    def _event(self, event: str, **extra) -> None:
        if self.shard is not None:
            extra = {"shard": self.shard, **extra}
        self._events.append(trace.stamp(
            {"ts": time.time(), "event": event,
             "holder": self.holder_id, **extra}))

    # -- the election step --------------------------------------------------------

    def step(self) -> None:
        """One election tick: renew when leading, acquire/steal when not.
        Safe to call from the heartbeat thread and from tests; all state
        transitions (and their callbacks) happen inside here."""
        with self._mu:
            if self._is_leader:
                self._renew_locked()
            else:
                self._try_acquire_locked()

    def _record(self, epoch: int, now: float) -> str:
        return json.dumps({
            "holderId": self.holder_id, "epoch": epoch,
            "deadline": now + self.ttl_s, "ttlS": self.ttl_s,
            "advertise": self._advertise,
        }, sort_keys=True)

    def _renew_locked(self) -> None:
        now = self._clock()
        new_raw = self._record(self._epoch, now)
        try:
            self._kv.apply(
                [("put", self.lease_key, new_raw)],
                guards=[("value", self.lease_key, self._lease_raw)])
        except errors.GuardFailed:
            # someone stole the lease (our old record is gone): deposed
            self._demote_locked("lease stolen: renew CAS lost")
            return
        except Exception as e:  # noqa: BLE001 — store outage
            # we cannot prove the lease; past OUR OWN deadline a standby
            # may legitimately have stolen it, so stop writing. Before the
            # deadline, keep leadership and let the next tick retry.
            try:
                own_deadline = json.loads(self._lease_raw)["deadline"]
            except (TypeError, ValueError, KeyError):
                own_deadline = now
            if now >= own_deadline:
                self._demote_locked(f"store unreachable past lease "
                                    f"deadline: {e}")
            else:
                log.warning("leader %s: renew failed (%s); lease still "
                            "live until %.3f", self.holder_id, e, own_deadline)
            return
        self._lease_raw = new_raw
        crash_point("leader.after_renew")

    def _try_acquire_locked(self) -> None:
        now = self._clock()
        try:
            raw = self._kv.get_or(self.lease_key)
        except Exception as e:  # noqa: BLE001
            log.warning("elector %s: lease read failed: %s", self.holder_id, e)
            return
        cur: dict | None = None
        if raw is not None:
            try:
                cur = json.loads(raw)
            except ValueError:
                log.error("elector %s: unreadable lease record; treating "
                          "as expired", self.holder_id)
        # remember what we saw: leader_hint serves 503s from this
        self._observed = cur
        self._has_observed = True
        if cur is not None and float(cur.get("deadline", 0)) > now:
            self._vacant_since = None
            return  # a live lease is held: stay standby
        if raw is None and self.defer_vacant_s > 0:
            # vacancy (never held / gracefully released) is contested only
            # after the deferral, so the preferred process wins a fleet
            # boot; an EXPIRED lease (raw is not None) skips this branch
            # entirely — dead-leader recovery must not wait
            if self._vacant_since is None:
                self._vacant_since = now
            if now < self._vacant_since + self.defer_vacant_s:
                return
        # absent, expired or unreadable: take it. The epoch must outgrow
        # BOTH the record's epoch and the standalone epoch key (a graceful
        # release deletes the lease but keeps the key — monotonicity).
        try:
            key_epoch = int(self._kv.get_or(self.epoch_key) or 0)
        except Exception as e:  # noqa: BLE001
            log.warning("elector %s: epoch read failed: %s", self.holder_id, e)
            return
        epoch = max(int(cur.get("epoch", 0)) if cur else 0, key_epoch) + 1
        new_raw = self._record(epoch, now)
        try:
            self._kv.apply(
                [("put", self.lease_key, new_raw),
                 ("put", self.epoch_key, str(epoch))],
                # CAS on the exact value we judged expired (None = create):
                # of N racing standbys exactly one wins, the rest lose the
                # compare and stay standby
                guards=[("value", self.lease_key, raw)])
        except errors.GuardFailed:
            return  # another standby won the steal; retry next tick
        except Exception as e:  # noqa: BLE001
            log.warning("elector %s: acquire failed: %s", self.holder_id, e)
            return
        self._is_leader = True
        self._epoch = epoch
        self._lease_raw = new_raw
        self._vacant_since = None
        stolen_from = cur.get("holderId") if cur else None
        log.info("elector %s: acquired leadership%s (epoch %d%s)",
                 self.holder_id,
                 f" of shard {self.shard}" if self.shard is not None else "",
                 epoch,
                 f", stolen from expired {stolen_from}" if stolen_from else "")
        self._event("shard-acquired" if self.shard is not None
                    else "leader-acquired", epoch=epoch,
                    stolenFrom=stolen_from)
        crash_point("leader.after_acquire")
        if self._on_acquire is not None:
            self._on_acquire(epoch)
        crash_point("leader.after_start_writers")
        # only now may the API admit mutations: every in-memory mirror has
        # been re-seeded and the writer subsystems are up
        self._accepting = True

    def _demote_locked(self, reason: str) -> None:
        self._accepting = False  # gate closes BEFORE the writers stop
        self._is_leader = False
        self._lease_raw = None
        log.warning("elector %s: leadership lost (epoch %d): %s",
                    self.holder_id, self._epoch, reason)
        self._event("shard-lost" if self.shard is not None
                    else "leader-lost", epoch=self._epoch, reason=reason)
        if self._on_loss is not None:
            try:
                self._on_loss(reason)
            except Exception:  # noqa: BLE001 — the elector must survive
                log.exception("on_loss callback failed")

    # -- lifecycle ----------------------------------------------------------------

    def start(self) -> None:
        """Launch the heartbeat thread: step immediately, then every
        ``renew_interval_s`` (renewal well inside the TTL)."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="leader-elect", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                self.step()
            except Exception:  # noqa: BLE001 — a flaky store must not end
                log.exception("election step failed")  # the heartbeat
            if self._stop.wait(self.renew_interval_s):
                return

    def close(self, release: bool = True) -> None:
        """Stop the heartbeat. ``release=True`` (graceful shutdown) also
        CAS-deletes a held lease so the standby can acquire immediately
        instead of waiting out the TTL; the epoch key stays — it must
        never regress. ``release=False`` models a hard kill (bench/chaos:
        the standby must wait for expiry)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.renew_interval_s + 5)
            self._thread = None
        if not release:
            return
        with self._mu:
            if not self._is_leader:
                return
            try:
                self._kv.apply(
                    [("delete", self.lease_key)],
                    guards=[("value", self.lease_key,
                             self._lease_raw)])
                self._event("shard-released" if self.shard is not None
                            else "leader-released", epoch=self._epoch)
            except Exception as e:  # noqa: BLE001 — best effort: an
                # unreleased lease just costs the standby one TTL
                log.warning("elector %s: lease release failed: %s",
                            self.holder_id, e)
            # quiet demotion: the daemon's own stop() is already halting
            # the writer subsystems; firing on_loss would double-stop them
            self._accepting = False
            self._is_leader = False
            self._lease_raw = None


class FencedKV(KV):
    """Write-path fencing wrapper (see module docstring). Reads delegate
    untouched; every mutation — including bare ``put``/``delete``, which
    the journal's claim/ack path uses — is routed through one guarded
    atomic apply carrying ``fence()``'s guards. With an empty fence (no
    elector, or never-acquired) behavior matches the raw store."""

    def __init__(self, inner: KV,
                 fence: Callable[[], list[tuple]],
                 fence_ops: Callable[[list[tuple]], list[tuple]] | None
                 = None) -> None:
        self.inner = inner
        self._fence = fence
        #: ops-aware fence (sharded writer plane): receives the batch and
        #: returns the guards for exactly the shards it touches, so a
        #: deposed shard-1 leader is fenced out of shard 1 while its
        #: still-held shard 2 writes sail. When unset the zero-arg
        #: ``fence`` applies to every write (the single-lease contract).
        self._fence_ops = fence_ops

    def put(self, key: str, value: str) -> None:
        self.apply([("put", key, value)])

    def delete(self, key: str) -> None:
        self.apply([("delete", key)])

    def delete_prefix(self, prefix: str) -> None:
        self.apply([("delete_prefix", prefix)])

    def get(self, key: str) -> str:
        return self.inner.get(key)

    def range_prefix(self, prefix: str) -> dict[str, str]:
        return self.inner.range_prefix(prefix)

    def range_prefix_with_rev(self, prefix: str):
        return self.inner.range_prefix_with_rev(prefix)

    def keys_prefix(self, prefix: str, limit: int = 0,
                    start_after: str = "") -> list[str]:
        return self.inner.keys_prefix(prefix, limit=limit,
                                      start_after=start_after)

    def range_prefix_page(self, prefix: str, limit: int,
                          start_after: str = "", at_rev: int = 0):
        return self.inner.range_prefix_page(prefix, limit,
                                            start_after=start_after,
                                            at_rev=at_rev)

    def current_rev(self) -> int:
        return self.inner.current_rev()

    def watch(self, prefix: str, start_rev: int = 0):
        # watch is a READ: standbys tail freely, fencing never applies
        return self.inner.watch(prefix, start_rev)

    def _apply(self, ops: list[tuple], guards: list[tuple] | None = None) -> None:
        # the base template (our public ``apply``) already validated and
        # fired the txn crash points — delegate to the inner BACKEND's
        # atomic ``_apply`` so they never fire twice per batch
        fence = (self._fence_ops(ops) if self._fence_ops is not None
                 else self._fence())
        self.inner._apply(ops, list(guards or []) + fence)

    def close(self) -> None:
        self.inner.close()
