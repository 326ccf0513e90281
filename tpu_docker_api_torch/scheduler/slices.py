"""Topology-aware GPU allocator.

The port's counterpart of ``tpu_docker_api/scheduler/slices.py``, the
replacement for the reference's GPU scheduler (gpuscheduler/scheduler.go).
The logic is the JAX package's; on a GPU host's line of NVML indices
(scheduler/topology.py) a "contiguous block" is a run of adjacent indices.
Differences from the reference, all deliberate (SURVEY.md §2.3, §7 step 3):

- **Topology-aware**: GPUs are mesh coordinates; an allocation prefers a
  contiguous axis-aligned block and only then falls back to scattered
  GPUs, reporting which it got.
- **Deterministic**: candidate shapes and offsets are scanned in sorted order
  (the reference iterates a Go map ⇒ nondeterministic pick,
  scheduler.go:74-82).
- **Crash-safe**: state persists to the KV store on every mutation, not only
  on graceful Close (scheduler.go:59-61).
- **Status snapshots are copies**, not the live map handed to the JSON
  encoder (scheduler.go:107-112 quirk).

Grants are NVML indices, persisted under ``SCHEDULER_CHIPS_KEY`` as JAX
persists chip ids; ``uuids_of`` maps them to the UUIDs the runtime renders
(the reference's ``ApplyGpus`` hands out UUIDs directly).
"""

from __future__ import annotations

import itertools
import json
import threading

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.scheduler.topology import HostTopology, parse_slice_shape
from tpu_docker_api_torch.state import keys
from tpu_docker_api_torch.state.kv import KV
from tpu_docker_api_torch.telemetry import trace

Shape = tuple[int, int, int]
Coord = tuple[int, int, int]


def candidate_shapes(n: int, mesh: Shape) -> list[Shape]:
    """Axis-aligned block shapes of volume ``n`` that fit in ``mesh``,
    most-compact first (minimal surface area ⇒ max bisection), then
    lexicographic for determinism."""
    shapes = set()
    for a in range(1, min(n, mesh[0]) + 1):
        if n % a:
            continue
        rest = n // a
        for b in range(1, min(rest, mesh[1]) + 1):
            if rest % b:
                continue
            c = rest // b
            if c <= mesh[2]:
                shapes.add((a, b, c))

    def surface(s: Shape) -> int:
        a, b, c = s
        return a * b + b * c + a * c

    # tie-break surface ties toward x-major shapes (2,2,1) over (1,2,2)
    return sorted(shapes, key=lambda s: (surface(s), tuple(-d for d in s)))


class ChipScheduler:
    """Host-wide exclusive GPU allocator (singleton per process, like
    reference ``Scheduler`` gpuscheduler/scheduler.go:25)."""

    def __init__(
        self,
        topology: HostTopology,
        kv: KV,
        store_key: str = keys.SCHEDULER_CHIPS_KEY,
    ) -> None:
        self.topology = topology
        self._kv = kv
        self._key = store_key
        self._mu = threading.Lock()
        # chip_id → owner name ("" when allocated anonymously)
        self._used: dict[int, str] = {}
        raw = kv.get_or(store_key)
        if raw:
            # restore-from-store path (reference initFormEtcd, scheduler.go:123-140)
            stored = {int(k): v for k, v in json.loads(raw).items()}
            self._used = {k: v for k, v in stored.items()
                          if k in topology.coords}
            if self._used != stored:
                # persist ONLY when the topology filter dropped chips (a
                # genuine repair after a topology change). An unconditional
                # boot write-back would let a booting HA standby — whose
                # fence is still empty — clobber a claim the live leader
                # committed between our read and this write
                self._persist_locked()

    def reload_from_store(self) -> None:
        """Replace the in-memory ownership mirror with the store's truth —
        the leadership-handoff cache refresh: a standby promoted to leader
        may have booted long before the old leader's last claim. Read-only
        (no re-persist): refreshing a cache must never be a write."""
        raw = self._kv.get_or(self._key)
        with self._mu:
            self._used = ({int(k): v for k, v in json.loads(raw).items()
                           if int(k) in self.topology.coords} if raw else {})

    # -- persistence -------------------------------------------------------------

    def _serialized_locked(self) -> str:
        return json.dumps({str(k): v for k, v in sorted(self._used.items())})

    def _persist_locked(self, txn=None) -> None:
        """Write the ownership snapshot — immediately, or deferred into a
        :class:`~tpu_docker_api_torch.state.txn.StoreTxn` when the caller
        batches this claim with the rest of a flow's writes (ops_fn
        re-snapshots at commit time, under this lock)."""
        if txn is not None:
            from tpu_docker_api_torch.state.txn import RANK_HOST

            txn.enlist(RANK_HOST, self._key, self._mu,
                       lambda: [("put", self._key, self._serialized_locked())])
            return
        self._kv.put(self._key, self._serialized_locked())

    # -- queries -----------------------------------------------------------------

    @property
    def free_chips(self) -> list[int]:
        with self._mu:
            return sorted(set(self.topology.coords) - set(self._used))

    def owned_chips(self, owner: str) -> list[int]:
        """Chips currently claimed by ``owner`` — the allocation truth the
        container service checks before reusing a stored spec's chip list
        (a stopped container's chips were already returned to the pool)."""
        with self._mu:
            return sorted(c for c, o in self._used.items() if o == owner)

    def uuids_of(self, chip_ids: list[int]) -> list[str]:
        """The UUIDs of granted GPUs, in the order given — what the
        runtime attaches (``render_gpu_attachment``)."""
        return self.topology.uuids_for(chip_ids)

    def status(self) -> dict:
        """Resource view for GET /resources/gpus (reference GetGpusStatus,
        scheduler.go:107-112 — but a snapshot, not the live map). Each GPU
        the topology has a UUID for also carries it (``uuid``, the
        reference's key); JAX's view has no such key."""
        with self._mu:
            used = dict(self._used)
        chips = []
        for cid in sorted(self.topology.coords):
            chips.append({
                "chipId": cid,
                "coords": list(self.topology.coords[cid]),
                "used": cid in used,
                "owner": used.get(cid, ""),
            })
            if cid in self.topology.uuids:
                chips[-1]["uuid"] = self.topology.uuids[cid]
        return {
            "generation": self.topology.generation.name,
            "meshShape": list(self.topology.mesh_shape),
            "totalChips": self.topology.n_chips,
            "freeChips": self.topology.n_chips - len(used),
            "largestFreeBlock": self._largest_free_block(set(self.topology.coords) - set(used)),
            "chips": chips,
        }

    # -- allocation --------------------------------------------------------------

    @trace.traced("sched.chips.claim")
    def apply_chips(
        self, n: int, shape: str = "", owner: str = "", txn=None
    ) -> tuple[list[int], bool]:
        """Allocate ``n`` chips (or an explicit ``shape`` like "2x2").

        Returns ``(chip_ids, contiguous)``. Raises ChipNotEnough when the
        pool cannot satisfy the ask; with an explicit shape, scattered
        fallback is disabled (the caller asked for a real slice).

        Reference analog: ApplyGpus first-fit bit scan (scheduler.go:64-90).
        """
        if n <= 0 and not shape:
            return [], True
        with self._mu:
            free = set(self.topology.coords) - set(self._used)
            if shape:
                want = parse_slice_shape(shape)
                n = want[0] * want[1] * want[2]
                block = self._find_block_locked(want, free, allow_rotations=True)
                if block is None:
                    raise errors.ChipNotEnough(
                        f"no free contiguous {shape} block "
                        f"(free={len(free)}/{self.topology.n_chips})"
                    )
                self._claim_locked(block, owner, txn)
                return block, True
            if n > len(free):
                raise errors.ChipNotEnough(
                    f"want {n} chips, only {len(free)} free"
                )
            # prefer a contiguous block of any shape with volume n
            for cand in candidate_shapes(n, self.topology.mesh_shape):
                block = self._find_block_locked(cand, free)
                if block is not None:
                    self._claim_locked(block, owner, txn)
                    return block, True
            # scattered fallback (parity: the reference never guarantees
            # adjacency at all) — deterministic lowest-id-first
            picked = sorted(free)[:n]
            self._claim_locked(picked, owner, txn)
            return picked, False

    def try_claim_chips(self, chip_ids: list[int], owner: str,
                        txn=None) -> list[int]:
        """Claim SPECIFIC chips for ``owner`` — the reconciler's adoption
        path (re-own a container found in the runtime but absent from the
        allocation map). All-or-nothing: returns the conflicting chip ids
        (held by a different owner or outside the topology) and claims
        nothing unless the list is empty. Chips already owned by ``owner``
        are fine (idempotent re-adoption)."""
        return self.try_claim_chips_bulk([(owner, chip_ids)], txn=txn)

    @trace.traced("sched.chips.claim_bulk")
    def try_claim_chips_bulk(self, claims: list[tuple[str, list[int]]],
                             txn=None) -> list[int]:
        """Multi-member variant: claim every ``(owner, chip_ids)`` pair
        all-or-nothing ACROSS the whole batch, in one lock hold and one
        persist — a gang's members re-claim (reconciler adoption, unwind
        re-claims) as one scheduler apply, not N windows a crash or a rival
        claim can land between. Returns the conflicting chip ids (empty =
        everything claimed). A chip asked for by two DIFFERENT owners
        within the batch is itself a conflict — a double-grant must never
        depend on member order."""
        with self._mu:
            want: dict[int, str] = {}
            conflicts = {
                c for owner, chip_ids in claims for c in chip_ids
                if c not in self.topology.coords
                or self._used.get(c, owner) != owner
                or want.setdefault(c, owner) != owner
            }
            if conflicts:
                return sorted(conflicts)
            for owner, chip_ids in claims:
                for c in chip_ids:
                    self._used[c] = owner
            self._persist_locked(txn)
            return []

    def restore_chips(self, chip_ids: list[int], owner: str | None = None,
                      txn=None) -> None:
        """Return chips to the pool (reference RestoreGpus, scheduler.go:93-104).

        With ``owner`` set, only chips still held by that owner are freed —
        the double-free guard: a stop followed by a delete must not free
        chips that were re-allocated to another container in between.
        """
        with self._mu:
            freed = False
            for cid in chip_ids:
                if owner is not None and self._used.get(cid) != owner:
                    continue
                freed = self._used.pop(cid, None) is not None or freed
            # a no-op restore (chip-free container, double free) must not
            # touch the store: the ledger write is what makes the flow a
            # cross-shard batch under the sharded writer plane
            if freed:
                self._persist_locked(txn)

    def _claim_locked(self, chip_ids: list[int], owner: str,
                      txn=None) -> None:
        for cid in chip_ids:
            self._used[cid] = owner
        self._persist_locked(txn)

    # -- block search ------------------------------------------------------------

    def _find_block_locked(
        self, want: Shape, free: set[int], allow_rotations: bool = False
    ) -> list[int] | None:
        """First free axis-aligned block of shape ``want``, scanning offsets in
        sorted order (deterministic). Rotations are tried only for explicit
        user shapes — the count path already enumerates every orientation via
        candidate_shapes, in compactness order."""
        coord_to_chip = {c: cid for cid, c in self.topology.coords.items()}
        mx, my, mz = self.topology.mesh_shape
        rotations = sorted(set(itertools.permutations(want))) if allow_rotations else [want]
        for rot in rotations:
            a, b, c = rot
            if a > mx or b > my or c > mz:
                continue
            for ox in range(mx - a + 1):
                for oy in range(my - b + 1):
                    for oz in range(mz - c + 1):
                        cells = [
                            coord_to_chip.get((ox + dx, oy + dy, oz + dz))
                            for dx in range(a)
                            for dy in range(b)
                            for dz in range(c)
                        ]
                        if all(cid is not None and cid in free for cid in cells):
                            return sorted(cells)  # type: ignore[arg-type]
        return None

    def _largest_free_block(self, free: set[int]) -> int:
        """Fragmentation gauge: volume of the largest allocatable block."""
        total = len(free)
        for n in range(total, 0, -1):
            for cand in candidate_shapes(n, self.topology.mesh_shape):
                if self._find_block_locked(cand, free) is not None:
                    return n
        return 0
