"""Version maps: name → latest version per resource family.

Parity: reference ``internal/version/version.go`` (two concurrent maps wrapping
orcaman/concurrent-map + atomics). Fix applied: the reference restores from the
store on Init but persists only in Close (version.go:40-63), so a crash loses
every bump since boot; here every mutation persists synchronously.

The port's copy of ``tpu_docker_api/state/version.py``, whole: the HA
standby's read-through and informer shadow, and ``ShardedVersionMap`` for
the sharded writer plane.
"""

from __future__ import annotations

import json
import threading

from tpu_docker_api_torch.state.kv import KV


class VersionMap:
    def __init__(self, kv: KV, store_key: str,
                 read_through=False) -> None:
        self._kv = kv
        self._key = store_key
        #: HA fleets pass a callable here (daemon wiring: "am I a
        #: standby right now?"): while it returns True every read re-seeds
        #: from the store first, because the leader rolls, creates and
        #: deletes families behind this replica's back — a hit is no more
        #: trustworthy than a miss (staleness must be bounded by one read,
        #: not by this replica's lifetime). A leader (callable False) and
        #: single-process deployments (the bool default) keep the pure
        #: in-memory map: every write is local, zero extra reads.
        #: With an informer attached (attach_informer), the standby read
        #: path upgrades again: watch-fed shadow, zero reads AND zero
        #: JSON re-parses per request.
        self._read_through = (read_through if callable(read_through)
                              else (lambda: read_through))
        self._mu = threading.Lock()
        raw = kv.get_or(store_key)
        self._m: dict[str, int] = json.loads(raw) if raw else {}
        self._informer = None
        #: standby-read shadow, replaced wholesale on every watch event for
        #: our key. READ-only: writers (next_version/set/rollback) never
        #: consult it, so a transiently-lagging event stream can at worst
        #: serve a bounded-stale read — it can never roll the authoritative
        #: map backwards and re-issue an old version number.
        self._shadow: dict[str, int] = {}

    def attach_informer(self, informer) -> None:
        """Standby mode: replace per-read store re-seeding with watch-fed
        updates (state/informer.py). Reads served from the shadow while the
        informer is synced; any degradation falls back to the per-read
        read-through path, so staleness is NEVER worse than before."""
        with self._mu:
            self._shadow = dict(self._m)
        self._informer = informer
        informer.register(self._key, self._on_informer_event)

    def _on_informer_event(self, ev) -> None:
        if ev.key != self._key:
            return  # a longer key sharing our key as its prefix
        m = json.loads(ev.value) if (ev.op == "put" and ev.value) else {}
        with self._mu:
            self._shadow = m

    def _shadow_live(self) -> bool:
        return self._informer is not None and self._informer.synced

    def _persist_locked(self) -> None:
        self._kv.put(self._key, json.dumps(self._m, sort_keys=True))

    def reload_from_store(self) -> None:
        """Replace the in-memory mirror with the store's truth — the
        leadership-handoff cache refresh (a promoted standby may have
        booted long before the old leader's last write)."""
        raw = self._kv.get_or(self._key)
        with self._mu:
            self._m = json.loads(raw) if raw else {}

    def get(self, name: str) -> int | None:
        if self._read_through():
            if self._shadow_live():
                with self._mu:
                    return self._shadow.get(name)
            self.reload_from_store()
        with self._mu:
            return self._m.get(name)

    def contains(self, name: str) -> bool:
        return self.get(name) is not None

    def next_version(self, name: str) -> int:
        """Atomically bump-and-get: first call for a name returns 0.

        The reference starts families at version 0 and names them
        ``"%s-%d"`` (service/container.go:468-486).
        """
        with self._mu:
            v = self._m.get(name)
            v = 0 if v is None else v + 1
            self._m[name] = v
            self._persist_locked()
            return v

    def set(self, name: str, version: int) -> None:
        with self._mu:
            self._m[name] = version
            self._persist_locked()

    def rollback(self, name: str, to_version: int | None) -> None:
        """Undo a failed bump (reference: deferred decrement,
        service/container.go:475-483 — done transactionally here)."""
        with self._mu:
            if to_version is None:
                self._m.pop(name, None)
            else:
                self._m[name] = to_version
            self._persist_locked()

    def remove(self, name: str) -> None:
        with self._mu:
            self._m.pop(name, None)
            self._persist_locked()

    def snapshot(self) -> dict[str, int]:
        if self._read_through():
            if self._shadow_live():
                with self._mu:
                    return dict(self._shadow)
            self.reload_from_store()
        with self._mu:
            return dict(self._m)


class ShardedVersionMap:
    """Version map partitioned across the sharded writer plane: one inner
    :class:`VersionMap` per shard (shard 0 at the LEGACY singleton key, so
    a ``shard_count`` bump adopts the existing snapshot as shard 0's
    without migration; shards i>0 at ``keys.versions_shard_key``).

    Writes delegate to the owning shard's map — and because each inner
    map persists to a key that :class:`~tpu_docker_api_torch.service.shard.ShardMap`
    classifies back to that shard, every persist rides the shard's epoch
    fence through ``ShardedKV``: a deposed shard leader's version bump
    loses its compare instead of clobbering the new leader's snapshot.
    Reads on shards this process does NOT lead go read-through (the
    leader of that shard bumps versions behind our back), while led
    shards keep the pure in-memory map — per-shard, the exact single-leader
    read contract.

    Legacy adoption: a single-leader store's version snapshot lists EVERY
    family in the shard-0 singleton, including families that hash to
    other shards after a ``shard_count`` bump. Reads therefore fall back
    to the shard-0 map on an owning-map miss, and the first write
    re-homes the family: the owning shard's map adopts the legacy
    version, then mutates its own copy (which shadows the stale legacy
    entry from then on). ``remove`` also clears a surviving legacy entry
    — that write rides shard 0's fence, so deleting a never-re-homed
    legacy family from a leader that does not hold shard 0 surfaces a
    typed GuardFailed rather than silently resurrecting the family.
    """

    def __init__(self, kv, shard_map, resource, leading) -> None:
        """``leading(shard) -> bool`` is the per-shard read-through
        inverter (typically ``plane.is_leader``)."""
        from tpu_docker_api_torch.state import keys as _keys
        self._shard_map = shard_map
        self._maps = [
            VersionMap(kv, _keys.versions_shard_key(resource, i),
                       read_through=(lambda i=i: not leading(i)))
            for i in range(shard_map.count)
        ]

    def _of(self, name: str) -> VersionMap:
        return self._maps[self._shard_map.shard_of(name)]

    def _lookup(self, name: str) -> tuple[VersionMap, int | None]:
        """Owning map first, then the legacy (shard 0) adoption home."""
        owner = self._of(name)
        v = owner.get(name)
        if v is None and owner is not self._maps[0]:
            v = self._maps[0].get(name)
        return owner, v

    def _rehome(self, name: str) -> VersionMap:
        """Ensure ``name``'s owning map carries its current version before
        a mutation — the first write after a shard_count bump adopts the
        legacy entry into the owning shard's keyspace."""
        owner, v = self._lookup(name)
        if v is not None and owner.get(name) is None:
            owner.set(name, v)
        return owner

    def reload_from_store(self) -> None:
        for m in self._maps:
            m.reload_from_store()

    def reload_shard(self, shard: int) -> None:
        """Takeover cache refresh for ONE shard (daemon on-acquire hook) —
        the other shards' maps are not ours to reseed."""
        self._maps[shard].reload_from_store()

    def get(self, name: str) -> int | None:
        return self._lookup(name)[1]

    def contains(self, name: str) -> bool:
        return self._lookup(name)[1] is not None

    def next_version(self, name: str) -> int:
        return self._rehome(name).next_version(name)

    def set(self, name: str, version: int) -> None:
        self._of(name).set(name, version)

    def rollback(self, name: str, to_version: int | None) -> None:
        self._rehome(name).rollback(name, to_version)

    def remove(self, name: str) -> None:
        owner = self._of(name)
        owner.remove(name)
        legacy = self._maps[0]
        if owner is not legacy and legacy.get(name) is not None:
            legacy.remove(name)

    def snapshot(self) -> dict[str, int]:
        merged: dict[str, int] = {}
        for m in self._maps:
            merged.update(m.snapshot())
        return merged
