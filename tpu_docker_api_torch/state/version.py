"""Version maps: name → latest version per resource family.

Parity: reference ``internal/version/version.go`` (two concurrent maps wrapping
orcaman/concurrent-map + atomics). Fix applied: the reference restores from the
store on Init but persists only in Close (version.go:40-63), so a crash loses
every bump since boot; here every mutation persists synchronously.

The port's copy of ``tpu_docker_api/state/version.py``: ``VersionMap``
for one writer, without the HA standby's read-through (``read_through``,
``reload_from_store``, ``attach_informer``), which comes with leader
election, and without ``ShardedVersionMap``, which comes with
``service/shard`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import json
import threading

from tpu_docker_api_torch.state.kv import KV


class VersionMap:
    def __init__(self, kv: KV, store_key: str) -> None:
        self._kv = kv
        self._key = store_key
        self._mu = threading.Lock()
        raw = kv.get_or(store_key)
        self._m: dict[str, int] = json.loads(raw) if raw else {}

    def _persist_locked(self) -> None:
        self._kv.put(self._key, json.dumps(self._m, sort_keys=True))

    def get(self, name: str) -> int | None:
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
        with self._mu:
            return dict(self._m)
