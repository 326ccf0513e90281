"""Batched store transactions over ``KV.apply``.

Schedulers and version maps persist their state as one full-snapshot JSON
key each, synchronously under their own lock — correct, but a control-plane
flow that touches several of them (a gang create claims N host chip maps,
M host port maps and the pod slice registry) pays one store round trip per
mutation. :class:`StoreTxn` collapses that: participants defer their
persist into the txn, and ``commit()`` writes every enlisted snapshot in
ONE atomic ``KV.apply``.

Correctness of the deferred snapshot: each participant's ops are built at
COMMIT time, under that participant's own lock, and the locks are held
ACROSS the apply. Any concurrent mutation of a participant either happens
before our snapshot (and is included — full-snapshot keys make a superset
write harmless) or blocks until our write is durable (and its own persist
then lands after, carrying both states). Without the lock-across-apply a
stale snapshot could overwrite a neighbour's committed mutation.

Deadlock safety: commit acquires participant locks in (rank, key) order.
Ranks encode the nesting the live code paths already use — the pod
scheduler takes its own lock and then a host chip lock (``apply_slice``),
so POD < HOST keeps commit compatible with that ordering; no code path
nests the other way. Non-batched mutators hold a single lock only, so they
can never complete a cycle.

The port's copy of ``tpu_docker_api/state/txn.py``: the ranks stay the JAX
package's, though the pod scheduler (RANK_POD) comes with
``scheduler/pod`` (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import threading
from typing import Callable

from tpu_docker_api_torch.state.kv import KV
from tpu_docker_api_torch.telemetry import trace

#: lock-acquisition ranks (see module docstring): outer locks first
RANK_POD = 0      # PodScheduler (nests into host chip locks in apply_slice)
RANK_HOST = 1     # ChipScheduler / PortScheduler (leaf locks)
RANK_VERSIONS = 2  # VersionMap (never nests with scheduler locks)


class StoreTxn:
    """Collects deferred persists + explicit ops; commits once atomically.

    A txn is flow-local (single-threaded) and single-shot: mutate
    participants with ``txn=self``, then ``commit()`` exactly once. A txn
    that is never committed persists nothing — in-memory state dies with
    the failed flow (or the process), which is exactly the pre-txn crash
    contract the chaos suite pins.
    """

    def __init__(self, kv: KV) -> None:
        self._kv = kv
        #: store_key → (rank, lock, ops_fn); deduped by key so a gang that
        #: claims twice from one host still writes that host's map once
        self._parts: dict[str, tuple[int, threading.Lock,
                                     Callable[[], list[tuple]]]] = {}
        self._ops: list[tuple] = []
        self._committed = False

    def enlist(self, rank: int, store_key: str, lock: threading.Lock,
               ops_fn: Callable[[], list[tuple]]) -> None:
        """Register a participant: ``ops_fn`` is called at commit time,
        under ``lock``, and must return the ops persisting the
        participant's CURRENT state."""
        self._parts[store_key] = (rank, lock, ops_fn)

    def add_op(self, op: tuple) -> None:
        """Append an explicit op (e.g. a spec put) to the batch."""
        self._ops.append(op)

    @property
    def pending(self) -> bool:
        return bool(self._parts or self._ops)

    def commit(self) -> None:
        """One atomic ``KV.apply`` of every participant snapshot plus the
        explicit ops. Raises whatever the store raises — the caller's
        unwind path then restores in-memory state (nothing was persisted)."""
        if self._committed:
            raise RuntimeError("StoreTxn.commit called twice")
        self._committed = True
        parts = sorted(self._parts.items(),
                       key=lambda kv_: (kv_[1][0], kv_[0]))
        held: list[threading.Lock] = []
        with trace.child("store.txn", participants=len(parts)) as span:
            try:
                for _, (_, lock, _) in parts:
                    lock.acquire()
                    held.append(lock)
                ops: list[tuple] = []
                for _, (_, _, ops_fn) in parts:
                    ops.extend(ops_fn())
                ops.extend(self._ops)
                if span is not None:
                    span.attrs["ops"] = len(ops)
                if ops:
                    self._kv.apply(ops)
            finally:
                for lock in reversed(held):
                    lock.release()
