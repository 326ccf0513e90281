"""Host-port scheduler.

Parity: reference ``internal/scheduler/portscheduler/scheduler.go`` — exclusive
allocation over ``[start_port, end_port]`` (default 40000–65535,
scheduler.go:17-19) with linear scan. Fixes: persist on every mutation (not
only Close, scheduler.go:80-82) and return snapshots, not the live set
(scheduler.go:128-132). A rotating cursor replaces the reference's
always-from-start scan so freshly released ports aren't immediately reused
(kinder to TIME_WAIT).

The port's copy of ``tpu_docker_api/scheduler/ports.py``.
"""

from __future__ import annotations

import json
import threading

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.kv import KV
from tpu_docker_api_torch.telemetry import trace


class PortScheduler:
    def __init__(
        self,
        kv: KV,
        start_port: int = 40000,
        end_port: int = 65535,
        store_key: str = keys.SCHEDULER_PORTS_KEY,
    ) -> None:
        if start_port > end_port:
            raise ValueError("start_port > end_port")
        self.start_port = start_port
        self.end_port = end_port
        self._kv = kv
        self._key = store_key
        self._mu = threading.Lock()
        # port → owner name ("" when allocated anonymously)
        self._used: dict[int, str] = {}
        self._cursor = start_port
        raw = kv.get_or(store_key)
        if raw:
            self._restore_locked(raw)

    def _restore_locked(self, raw: str) -> None:
        state = json.loads(raw)
        used = state["used"]
        if isinstance(used, list):  # legacy ownerless layout
            used = {p: "" for p in used}
        self._used = {int(p): o for p, o in used.items()
                      if self.start_port <= int(p) <= self.end_port}
        self._cursor = state.get("cursor", self.start_port)
        if not self.start_port <= self._cursor <= self.end_port:
            self._cursor = self.start_port

    def reload_from_store(self) -> None:
        """Replace the in-memory mirror with the store's truth — the
        leadership-handoff cache refresh (see ChipScheduler)."""
        raw = self._kv.get_or(self._key)
        with self._mu:
            if raw:
                self._restore_locked(raw)
            else:
                self._used = {}
                self._cursor = self.start_port

    def _serialized_locked(self) -> str:
        return json.dumps({"used": {str(p): o for p, o in sorted(self._used.items())},
                           "cursor": self._cursor})

    def _persist_locked(self, txn=None) -> None:
        """Immediate write, or deferred into a StoreTxn (the claim /
        bulk-release batches; ops_fn re-snapshots under this lock at commit
        time — see state/txn.py)."""
        if txn is not None:
            from tpu_docker_api_torch.state.txn import RANK_HOST

            txn.enlist(RANK_HOST, self._key, self._mu,
                       lambda: [("put", self._key, self._serialized_locked())])
            return
        self._kv.put(self._key, self._serialized_locked())

    @property
    def n_free(self) -> int:
        with self._mu:
            return (self.end_port - self.start_port + 1) - len(self._used)

    @trace.traced("sched.ports.claim")
    def apply_ports(self, n: int, owner: str = "", txn=None) -> list[int]:
        """Allocate ``n`` distinct host ports (reference ApplyPorts,
        scheduler.go:85-111)."""
        if n <= 0:
            return []
        with self._mu:
            span = self.end_port - self.start_port + 1
            if span - len(self._used) < n:
                raise errors.PortNotEnough(f"want {n}, free {span - len(self._used)}")
            out: list[int] = []
            p = self._cursor
            for _ in range(span):
                if p not in self._used:
                    self._used[p] = owner
                    out.append(p)
                    if len(out) == n:
                        break
                p = p + 1 if p < self.end_port else self.start_port
            self._cursor = out[-1] + 1 if out[-1] < self.end_port else self.start_port
            self._persist_locked(txn)
            return out

    def try_claim_ports(self, ports: list[int], owner: str,
                        txn=None) -> list[int]:
        """Claim SPECIFIC ports for ``owner`` (reconciler adoption/re-claim,
        mirroring ChipScheduler.try_claim_chips). All-or-nothing: returns
        conflicts and claims nothing unless empty."""
        return self.try_claim_ports_bulk([(owner, ports)], txn=txn)

    @trace.traced("sched.ports.claim_bulk")
    def try_claim_ports_bulk(self, claims: list[tuple[str, list[int]]],
                             txn=None) -> list[int]:
        """Multi-member variant (mirrors try_claim_chips_bulk): every
        ``(owner, ports)`` pair claimed all-or-nothing across the batch in
        one lock hold + one persist. Returns conflicts (empty = claimed);
        a port asked for by two different owners in the batch conflicts."""
        with self._mu:
            want: dict[int, str] = {}
            conflicts = {
                p for owner, ports in claims for p in ports
                if not self.start_port <= p <= self.end_port
                or self._used.get(p, owner) != owner
                or want.setdefault(p, owner) != owner
            }
            if conflicts:
                return sorted(conflicts)
            for owner, ports in claims:
                for p in ports:
                    self._used[p] = owner
            self._persist_locked(txn)
            return []

    def restore_ports(self, ports: list[int], owner: str | None = None,
                      txn=None) -> None:
        """Return ports to the pool (reference RestorePorts, scheduler.go:114-125).
        With ``owner`` set, only ports still held by that owner are freed
        (double-free guard, mirroring ChipScheduler.restore_chips)."""
        with self._mu:
            freed = False
            for p in ports:
                if owner is not None and self._used.get(p) != owner:
                    continue
                freed = self._used.pop(p, None) is not None or freed
            # a no-op restore (portless container, double free) must not
            # touch the store: the ledger write is what makes the flow a
            # cross-shard batch under the sharded writer plane
            if freed:
                self._persist_locked(txn)

    def status(self) -> dict:
        """Snapshot for GET /resources/ports (reference GetPortStatus +
        sorted MarshalJSON, scheduler.go:47-56,128-132)."""
        with self._mu:
            used = dict(sorted(self._used.items()))
        return {
            "startPort": self.start_port,
            "endPort": self.end_port,
            "usedCount": len(used),
            "usedPorts": list(used),
            "owners": used,
        }
