"""Sharded writer plane: partitioned leases, per-shard fencing, and
blast-radius-contained failover (docs/robustness.md "Sharded writer
plane").

Leader election made the control plane HA by electing ONE leader for the whole
keyspace — so a single lease loss stops every write for up to a TTL.
This module partitions the writer plane into ``shard_count`` failure
domains:

- :class:`ShardMap` — a deterministic assignment of family base names to
  shards via rendezvous (highest-random-weight) hashing over the family
  ROOT (``keys.shard_root``), so a replicated service and its
  ``<svc>.r<i>`` replica gangs always land on one shard, and a
  ``shard_count`` change moves only the minimal set of families (the
  rendezvous property: a family moves only if the NEW shard wins its
  weight contest). It also classifies raw store keys back to their owning
  shard for fencing.

- :class:`ShardPlane` — one :class:`~tpu_docker_api_torch.service.leader.LeaderElector`
  per shard (lease at ``keys.shard_lease_key(i)``, epoch at
  ``keys.shard_epoch_key(i)``), each with the exact CAS + epoch-fencing
  semantics of the single lease. Killing one shard's leader halts ≤ 1/N
  of the keyspace: the other shards' electors, leases and writer loops
  never notice.

- :class:`ShardedKV` — the per-shard generalization of ``FencedKV``:
  every write batch is classified op-by-op and guarded on the epoch of
  EXACTLY the shards it touches, so a deposed shard-1 leader is fenced
  out of shard 1 while its still-held shard-2 writes sail. Batches whose
  invariants span shards (≥ 2 shards, or shard keys + a global singleton
  such as the chip scheduler) additionally CAS-bump the cross-shard
  coordination record at ``keys.SHARD_COORD_KEY`` — two shard leaders
  racing on a cross-shard invariant serialize there, and the loser gets a
  typed :class:`errors.GuardFailed`. The ``shard.coord.*`` crash points
  bracket that apply for the chaos matrix.

``shard_count=1`` never constructs any of this — the daemon keeps the
single-elector path byte-for-byte.

The port's copy of ``tpu_docker_api/service/shard.py``, whole: the same
hash, lease, epoch and coordination records as JAX's.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import logging
import random
import threading
import time
from typing import Callable

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.service.crashpoints import crash_point
from tpu_docker_api_torch.service.leader import FencedKV, LeaderElector
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.kv import KV

log = logging.getLogger(__name__)

#: family resources whose keys carry a base name in their second segment
_FAMILY_RESOURCES = frozenset(r.value for r in keys.Resource)

#: bounded retries for a lost coordination-record CAS when the REST of the
#: batch's guards still hold (benign cross-shard contention, not fencing)
_COORD_RETRIES = 8


class ShardMap:
    """Deterministic family → shard assignment plus key classification."""

    def __init__(self, count: int) -> None:
        if count < 1:
            raise ValueError("shard_count must be >= 1")
        self.count = count

    @staticmethod
    def _weight(root: str, shard: int) -> int:
        h = hashlib.blake2b(f"{root}|{shard}".encode(), digest_size=8)
        return int.from_bytes(h.digest(), "big")

    def shard_of(self, base: str) -> int:
        """Owning shard for a family base name (rendezvous over the
        family root — see module docstring for why the root)."""
        if self.count <= 1:
            return 0
        root = keys.shard_root(base)
        best, best_w = 0, -1
        for i in range(self.count):
            w = self._weight(root, i)
            if w > best_w:
                best, best_w = i, w
        return best

    def shard_of_key(self, key: str) -> int | None:
        """Owning shard for a raw store key; ``None`` means the key is a
        GLOBAL singleton (scheduler maps, cordon set, leases, the
        coordination record) owned by no single shard."""
        if not key.startswith(keys.PREFIX + "/"):
            return None
        tail = key[len(keys.PREFIX) + 1:]
        head, _, rest = tail.partition("/")
        if head in _FAMILY_RESOURCES:
            base = rest.partition("/")[0]
            return self.shard_of(base) if base else None
        if head == "queue":
            # queue/tasks/<seq> | queue/tasks/s<i>/<seq> | markers likewise
            sub = rest.partition("/")[2]
            return self._sub_shard(sub)
        if head == "admission":
            return self._sub_shard(rest)
        if head == "versions":
            # versions/<resource> (shard 0) | versions/shards/<i>/<resource>
            if rest.startswith("shards/"):
                sid = rest.split("/", 2)[1]
                return int(sid) if sid.isdigit() else None
            return 0
        return None

    @staticmethod
    def _sub_shard(sub: str) -> int:
        """``s<i>/...`` → i; anything else is the legacy flat layout → 0."""
        if sub.startswith("s"):
            sid, sep, _ = sub[1:].partition("/")
            if sep and sid.isdigit():
                return int(sid)
        return 0

    def moved_families(self, roots: list[str], new_count: int) -> list[str]:
        """Which roots change shards going ``count`` → ``new_count``
        (test/operator aid — rendezvous keeps this minimal)."""
        other = ShardMap(new_count)
        return [r for r in roots if self.shard_of(r) != other.shard_of(r)]


class ShardPlane:
    """N electors, one per shard, over one raw store. Owns the per-batch
    fence computation and the operator views; the daemon owns what to DO
    on acquire/loss (start/stop writer loops, reload shard caches)."""

    def __init__(self, kv: KV, shard_map: ShardMap, holder_id: str,
                 ttl_s: float, renew_interval_s: float | None = None,
                 advertise: str = "",
                 on_acquire: Callable[[int, int], None] | None = None,
                 on_loss: Callable[[int, str], None] | None = None,
                 clock: Callable[[], float] | None = None,
                 preferred: frozenset[int] = frozenset(),
                 defer_vacant_s: float = 0.0) -> None:
        self.map = shard_map
        self.holder_id = holder_id
        self._on_acquire = on_acquire
        self._on_loss = on_loss
        self.electors: list[LeaderElector] = []
        for i in range(shard_map.count):
            ekw = {"clock": clock} if clock is not None else {}
            self.electors.append(LeaderElector(
                kv, holder_id, ttl_s=ttl_s,
                renew_interval_s=renew_interval_s,
                on_acquire=self._acquire_cb(i),
                on_loss=self._loss_cb(i),
                advertise=advertise,
                lease_key=keys.shard_lease_key(i),
                epoch_key=keys.shard_epoch_key(i),
                shard=i,
                defer_vacant_s=(0.0 if i in preferred else defer_vacant_s),
                **ekw))

    def _acquire_cb(self, shard: int):
        def cb(epoch: int) -> None:
            if self._on_acquire is not None:
                self._on_acquire(shard, epoch)
        return cb

    def _loss_cb(self, shard: int):
        def cb(reason: str) -> None:
            if self._on_loss is not None:
                self._on_loss(shard, reason)
        return cb

    # -- membership views ---------------------------------------------------------

    @property
    def held(self) -> frozenset[int]:
        """Shards this process currently leads (writer loops filter their
        families through this — lock-free, same contract as
        ``LeaderElector.is_leader``)."""
        return frozenset(i for i, e in enumerate(self.electors)
                         if e.is_leader)

    def is_leader(self, shard: int) -> bool:
        return self.electors[shard].is_leader

    def accepting(self, shard: int) -> bool:
        return self.electors[shard].accepts_mutations

    @property
    def accepts_any(self) -> bool:
        return any(e.accepts_mutations for e in self.electors)

    def owns(self, base: str) -> bool:
        """Does this process lead the shard owning ``base``? The writer
        loops' family filter."""
        return self.electors[self.map.shard_of(base)].is_leader

    # -- fencing ------------------------------------------------------------------

    def _guards_for(self, shard: int) -> list[tuple]:
        e = self.electors[shard]
        g = e.fence_guards()
        if g:
            return g
        # never held this shard: a write routed here is a bug unless the
        # store is virgin — guard "epoch key absent" so it is rejected the
        # moment any real leader has ever existed for the shard
        return [("value", e.epoch_key, None)]

    def classify(self, ops: list[tuple]) -> tuple[set[int], bool]:
        """(shards touched, touches-global) for a write batch."""
        touched: set[int] = set()
        has_global = False
        for op in ops:
            s = self.map.shard_of_key(op[1])
            if s is None:
                has_global = True
            else:
                touched.add(s)
        return touched, has_global

    def fence_ops(self, ops: list[tuple]) -> list[tuple]:
        """Per-batch fence guards: the epoch of exactly the shards the
        batch touches. Pure-global batches (scheduler persists, cordon
        writes) are guarded on every shard this process leads — a process
        deposed from ALL its shards can no longer move a global singleton,
        while a process still holding any shard is unaffected."""
        touched, has_global = self.classify(ops)
        guards: list[tuple] = []
        for s in sorted(touched):
            guards.extend(self._guards_for(s))
        if has_global and not touched:
            holders = [e for e in self.electors if e.is_leader]
            if not holders:  # deposed everywhere: stale guards must fail
                holders = [e for e in self.electors if e.epoch > 0]
            for e in holders:
                guards.extend(e.fence_guards())
        return guards

    # -- operator views -----------------------------------------------------------

    def status_view(self) -> dict:
        """GET /api/v1/shards: the shard map plus per-shard lease state,
        served from each elector's heartbeat-observed cache (zero store
        reads — the single-leader hint contract, per shard)."""
        return {
            "shardCount": self.map.count,
            "selfId": self.holder_id,
            "held": sorted(self.held),
            "shards": [e.status_view() for e in self.electors],
        }

    def standby_message(self, shard: int) -> str:
        e = self.electors[shard]
        return f"shard {shard}: {e.standby_message()}"

    def events_view(self, limit: int = 100) -> list[dict]:
        rings = [e.events_view(limit) for e in self.electors]
        merged = list(heapq.merge(*rings, key=lambda ev: ev.get("ts", 0)))
        return merged[-limit:]

    # -- lifecycle ----------------------------------------------------------------

    def step_all(self) -> None:
        for e in self.electors:
            e.step()

    def start(self) -> None:
        for e in self.electors:
            e.start()

    def close(self, release: bool = True) -> None:
        for e in self.electors:
            e.close(release=release)


class ShardedKV(FencedKV):
    """Write-path fencing for the sharded plane (see module docstring).

    Extends :class:`FencedKV` with the cross-shard coordination record:
    a batch spanning shards (or mixing shard keys with global singletons)
    CAS-bumps ``keys.SHARD_COORD_KEY`` in the same atomic apply. A lost
    coordination CAS whose shard fences still hold is benign contention
    and retried with a re-read seq (bounded); a lost SHARD fence is
    surfaced unchanged — that is a deposed leader being fenced."""

    def __init__(self, inner: KV, plane: ShardPlane) -> None:
        super().__init__(inner, fence=lambda: [],
                         fence_ops=plane.fence_ops)
        self._plane = plane

    def _needs_coord(self, ops: list[tuple]) -> bool:
        """A batch coordinates when it spans shards — or when it touches
        ANY global singleton (the chip/port ledgers, cordons): with the
        plane sharded, several leaders legitimately write the globals
        concurrently, and the coordination CAS is the one serialization
        point that turns a silent interleave into a detected, retried
        race. Pure single-shard batches carry only their shard's fence."""
        touched, has_global = self._plane.classify(ops)
        return len(touched) >= 2 or has_global

    def _apply(self, ops: list[tuple],
               guards: list[tuple] | None = None) -> None:
        if not self._needs_coord(ops):
            super()._apply(ops, guards)
            return
        base_guards = list(guards or [])
        last: Exception | None = None
        for attempt in range(_COORD_RETRIES):
            if attempt:
                # losing the CAS means another shard leader committed
                # between our read and our apply; with a slow store every
                # leader re-reading immediately re-collides forever
                # (livelock), so back off past roughly one store round
                # trip, de-phased per process/attempt
                time.sleep(random.uniform(0.0, 0.05 * attempt))
            raw = self.inner.get_or(keys.SHARD_COORD_KEY)
            seq = (json.loads(raw).get("seq", 0) if raw else 0)
            coord_ops = [("put", keys.SHARD_COORD_KEY,
                          json.dumps({"seq": seq + 1}, sort_keys=True))]
            coord_guards = [("value", keys.SHARD_COORD_KEY, raw)]
            crash_point("shard.coord.before_apply")
            try:
                self.inner._apply(
                    list(ops) + coord_ops,
                    base_guards + coord_guards + self._plane.fence_ops(ops))
            except errors.GuardFailed as e:
                # only a coordination-seq race is retryable; a fence or
                # caller guard losing means deposed/conflicted — re-raise
                if keys.SHARD_COORD_KEY not in str(e):
                    raise
                last = e
                continue
            crash_point("shard.coord.after_apply")
            return
        raise errors.GuardFailed(
            f"cross-shard coordination record contended past "
            f"{_COORD_RETRIES} retries: {last}")


def coord_seq(kv: KV) -> int:
    """Current cross-shard coordination sequence (tests/operators)."""
    raw = kv.get_or(keys.SHARD_COORD_KEY)
    return json.loads(raw).get("seq", 0) if raw else 0
