"""Container orchestration service.

Parity: reference ``internal/service/container.go`` — all nine flows (run,
delete, execute, patch-chips, patch-volume, stop, restart, commit, info) with
the immutable-versioned rolling-replacement model: a container is never
mutated; every update creates ``base-(n+1)`` and retires ``base-n``.

Deliberate fixes over the reference (SURVEY.md §5.4, appendix):

- **quiesce→copy→start**: the old container is stopped *before* its data is
  copied, and the new container starts only *after* the copy completes (the
  reference copies async while the old container may still write and the new
  one is already running, service/container.go:249-266); a dead-lettered copy
  triggers compensation (restart the old container) instead of stranding the
  workload;
- **per-family locking**: each flow is serialized per container family, so
  concurrent requests cannot double-create or double-replace (the reference's
  flows are unserialized check-then-act);
- **owner-checked resource returns**: chips/ports are freed only if still
  held by this family, so stop-then-delete cannot free a resource that was
  re-allocated in between;
- the container spec is persisted **synchronously** with the version bump —
  a crash can never leave a version pointer without its spec;
- optimistic-concurrency checks accept a bare base name (operate on latest)
  or a versioned name (must equal latest), matching the reference's
  ``name-version`` contract (api/container.go:102-106).

The port's copy of ``tpu_docker_api/service/container.py``: the same flows,
order and rollbacks. A grant is attached with ``render_gpu_attachment``
(the GPUs' UUIDs as ``DeviceRequests`` and ``CUDA_VISIBLE_DEVICES``) where
JAX renders ``/dev/accel*``, libtpu and the TPU topology env.
"""

from __future__ import annotations

import contextlib
import logging
import threading

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import ContainerRuntime
from tpu_docker_api_torch.runtime.spec import ContainerSpec, PortBinding, render_gpu_attachment
from tpu_docker_api_torch.scheduler.ports import PortScheduler
from tpu_docker_api_torch.scheduler.slices import ChipScheduler
from tpu_docker_api_torch.schemas.container import (
    ContainerCommit,
    ContainerDelete,
    ContainerExecute,
    ContainerPatchChips,
    ContainerPatchVolume,
    ContainerRollback,
    ContainerRun,
    ContainerStop,
)
from tpu_docker_api_torch.schemas.state import ContainerState
from tpu_docker_api_torch.service.crashpoints import crash_point
from tpu_docker_api_torch.state.keys import Resource, split_versioned_name, versioned_name
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.state.txn import StoreTxn
from tpu_docker_api_torch.state.version import VersionMap
from tpu_docker_api_torch.telemetry import trace
from tpu_docker_api_torch.state.workqueue import TaskRecord, WorkQueue

log = logging.getLogger(__name__)


def resolve_latest(versions: VersionMap, name: str) -> tuple[str, int, str]:
    """(base, latest_version, latest_name); optimistic-concurrency check when
    ``name`` carries a version suffix (reference service/container.go:195-198).
    Shared by the container and job services."""
    base, version = split_versioned_name(name)
    latest = versions.get(base)
    if latest is None:
        raise errors.ContainerNotExist(name)
    if version is not None and version != latest:
        raise errors.VersionNotMatch(f"{name}: latest version is {latest}")
    return base, latest, versioned_name(base, latest)


class _FamilyLocks:
    """Named locks so flows serialize per container family, not globally."""

    def __init__(self) -> None:
        self._locks: dict[str, threading.RLock] = {}
        self._mu = threading.Lock()

    @contextlib.contextmanager
    def hold(self, base: str):
        with self._mu:
            lock = self._locks.setdefault(base, threading.RLock())
        # lock-wait time is otherwise the INVISIBLE cost of a flow: a span
        # records only when the fast try-acquire loses (contention) — the
        # uncontended path stays one non-blocking acquire, no span at all
        if not lock.acquire(blocking=False):
            with trace.child("lock.family.wait", base=base):
                lock.acquire()
        try:
            yield
        finally:
            lock.release()


class ContainerService:
    def __init__(
        self,
        runtime: ContainerRuntime,
        store: StateStore,
        chip_scheduler: ChipScheduler,
        port_scheduler: PortScheduler,
        versions: VersionMap,
        work_queue: WorkQueue,
    ) -> None:
        self.runtime = runtime
        self.store = store
        self.chips = chip_scheduler
        self.ports = port_scheduler
        self.versions = versions
        self.wq = work_queue
        self._locks = _FamilyLocks()
        # durable-queue registry: bind this service's context to the task
        # kinds it submits, so records journaled by a dead daemon replay
        # under any daemon that can construct the service
        work_queue.register("copy_container_data", self._task_copy_data,
                            on_fail=self._task_copy_failed)
        work_queue.register("start_version", self._task_start_version)

    def family_lock(self, base: str):
        """Context manager serializing against this family's user flows —
        the reconciler holds it while repairing, so repair cannot race a
        concurrent patch/stop/delete."""
        return self._locks.hold(base)

    # -- helpers -----------------------------------------------------------------

    def _resolve_latest(self, name: str) -> tuple[str, int, str]:
        return resolve_latest(self.versions, name)

    def _adjust_chip_allocation(
        self, base: str, cur_spec: ContainerSpec, want: int,
    ) -> tuple[list[int], list[int], list[int], bool]:
        """(new_chips, extra, to_release, contiguous): adjust the family's
        LIVE chip claim to ``want`` chips. The claim is the scheduler's
        ownership map, NOT the stored spec — a stopped container's chips
        were already returned on stop and may belong to someone else now,
        so only the intersection is reusable; the rest is re-applied.
        ``extra`` must be restored by the caller if the replacement fails;
        ``to_release`` is freed only after the replacement exists."""
        owned = set(self.chips.owned_chips(base))
        held = sorted(c for c in cur_spec.chip_ids if c in owned)
        held_all = len(held) == len(cur_spec.chip_ids)
        to_release: list[int] = []
        extra: list[int] = []
        if want > len(held):
            extra, extra_contig = self.chips.apply_chips(
                want - len(held), owner=base)
            new_chips = sorted(held + extra)
            contiguous = extra_contig if not held else (
                cur_spec.ici_contiguous and held_all and extra_contig)
        else:
            new_chips = held[:want]
            to_release = held[want:]
            contiguous = cur_spec.ici_contiguous and held_all
        return new_chips, extra, to_release, contiguous

    def _family_runtime_members(self, base: str) -> list[str]:
        """Every version of ``base`` present in the runtime (old retired
        versions are kept stopped for manual rollback until delete)."""
        out = []
        for name in self.runtime.container_list():
            b, v = split_versioned_name(name)
            if b == base and v is not None:
                out.append(name)
        return out

    # -- 1. run (POST /containers; reference RunGpuContainer :36-100) -------------

    def run_container(self, req: ContainerRun) -> dict:
        base = req.container_name
        with self._locks.hold(base):
            if self.versions.contains(base) or self._family_runtime_members(base):
                raise errors.ContainerExisted(base)

            spec = ContainerSpec(
                name="",  # versioned name assigned in _run_new_version
                image=req.image_name,
                cmd=list(req.cmd),
                env=list(req.env),
                binds=[b.render() for b in req.binds],
                port_bindings=[
                    PortBinding(p.container_port, p.host_port, p.protocol)
                    for p in req.container_ports
                ],
            )
            # the chip claim defers into the flow's txn so chips + ports
            # commit as ONE atomic apply inside _run_new_version — container
            # create is 3 store round trips total (version bump, claim txn,
            # spec txn), not one per mutation
            claim_txn = StoreTxn(self.store.kv)
            chip_ids, contiguous = self.chips.apply_chips(
                req.chip_count, shape=req.slice_shape, owner=base,
                txn=claim_txn,
            )
            try:
                render_gpu_attachment(
                    spec, chip_ids, self.chips.topology,
                    ici_contiguous=contiguous)
                name = self._run_new_version(base, spec, start_now=True,
                                             claim_txn=claim_txn)
            except Exception:
                self.chips.restore_chips(chip_ids, owner=base)
                raise
            log.info("run container %s (chips=%s contiguous=%s)", name, chip_ids,
                     contiguous)
            return {"name": name, "chipIds": chip_ids, "iciContiguous": contiguous}

    def _run_new_version(self, base: str, spec: ContainerSpec, start_now: bool,
                         claim_txn: StoreTxn | None = None) -> str:
        """Version bump → atomic claim txn (ports, plus whatever the caller
        enlisted — run_container defers its chip claim in) → create
        [→ start] → persist, with full rollback on failure (reference
        runContainer, service/container.go:463-535). The spec persists
        synchronously so a version pointer always has its spec, even across
        a crash; the claim commits BEFORE the container exists, so a crash
        after create always finds its claims durable (the invariant the
        reconciler's leak sweep is built on)."""
        prev = self.versions.get(base)
        version = self.versions.next_version(base)
        name = versioned_name(base, version)
        spec.name = name
        crash_point("replace.after_version_bump")

        txn = claim_txn if claim_txn is not None else StoreTxn(self.store.kv)
        fresh_ports: list[int] = []
        need = [pb for pb in spec.port_bindings if pb.host_port == 0]
        try:
            fresh_ports = self.ports.apply_ports(len(need), owner=base,
                                                 txn=txn)
            for pb, hp in zip(need, fresh_ports):
                pb.host_port = hp
            # ONE store round trip claims everything this version owns
            txn.commit()
            try:
                self.runtime.container_create(spec)
            except Exception:
                # ambiguous-failure hardening (chaos suite): the engine may
                # have committed the create before erroring — a leftover
                # container would block every retry with ContainerExisted
                with contextlib.suppress(Exception):
                    if self.runtime.container_exists(name):
                        self.runtime.container_remove(name, force=True)
                raise
            try:
                self.store.put_container(
                    ContainerState(container_name=name, version=version,
                                   spec=spec.to_dict())
                )
                if start_now:
                    self.runtime.container_start(name)
            except Exception:
                # rollback half-created container (reference :511-516)
                self.runtime.container_remove(name, force=True)
                self.store.delete_version(Resource.CONTAINERS, name)
                raise
        except Exception:
            self.ports.restore_ports(fresh_ports, owner=base)
            self.versions.rollback(base, prev)
            raise
        return name

    # -- 2. delete (DELETE /containers/{name}; reference :104-137) ----------------

    def delete_container(self, name: str, req: ContainerDelete) -> None:
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            # remove EVERY runtime version of the family, not only the latest —
            # retired versions are kept stopped for rollback and must not leak.
            # Resource frees batch into one atomic apply after the loop: a
            # 5-version family releases in 1 store round trip, not 10
            release_txn = StoreTxn(self.store.kv)
            for member in self._family_runtime_members(base):
                try:
                    info = self.runtime.container_inspect(member)
                    self.runtime.container_remove(member, force=req.force)
                    self.chips.restore_chips(info.spec.chip_ids, owner=base,
                                             txn=release_txn)
                    self.ports.restore_ports(
                        [pb.host_port for pb in info.spec.port_bindings],
                        owner=base, txn=release_txn,
                    )
                except errors.ContainerNotExist:
                    continue
            release_txn.commit()
            if req.del_etcd_info_and_version_record:
                # submit BEFORE dropping the version pointer: a saturated
                # queue (429) there would otherwise leak the state family
                # forever — the retried delete 404s on the missing pointer
                # and can never reach this purge again
                self.wq.submit_record(
                    "delete_state_family",
                    {"resource": Resource.CONTAINERS.value, "base": base},
                    idempotency_key=f"purge:containers:{base}",
                )
                self.versions.remove(base)
            log.info("deleted container family %s (purge_state=%s)",
                     base, req.del_etcd_info_and_version_record)

    # -- 3. execute (POST /containers/{name}/execute; reference :140-175) ---------

    def execute_container(self, name: str, req: ContainerExecute) -> str:
        _, _, latest_name = self._resolve_latest(name)
        # no family lock held: exec may be long-running and must not block
        # control-plane mutations
        res = self.runtime.container_exec(latest_name, req.cmd, workdir=req.work_dir)
        return res.output

    # -- 4. patch chips (PATCH /containers/{name}/gpu; reference :181-270) --------

    def patch_container_chips(self, name: str, req: ContainerPatchChips) -> dict:
        base, version, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            # re-resolve under the lock (another patch may have won the race)
            base, version, latest_name = self._resolve_latest(name)
            state = self.store.get_container(latest_name)
            spec = ContainerSpec.from_dict(state.spec)

            current = list(spec.chip_ids)
            want = req.chip_count
            if want == len(current):
                raise errors.NoPatchRequired(f"{name} already has {want} chips")
            if want < 0:
                raise errors.BadRequest("chipCount must be >= 0")

            # grow (reference :211-229) / shrink (reference :230-246);
            # shrink releases only AFTER the replacement exists, so a failed
            # replace leaves the old container's chips untouched
            new_chips, extra, to_release, contiguous = (
                self._adjust_chip_allocation(base, spec, want))
            crash_point("patch.after_alloc")
            try:
                render_gpu_attachment(
                    spec, new_chips, self.chips.topology,
                    ici_contiguous=contiguous)
                new_name = self._rolling_replace(base, latest_name, spec)
            except Exception:
                self.chips.restore_chips(extra, owner=base)
                raise
            crash_point("patch.after_replace")
            self.chips.restore_chips(to_release, owner=base)
            log.info("patched %s chips %d -> %d as %s", latest_name,
                     len(current), want, new_name)
            return {"name": new_name, "chipIds": new_chips}

    # -- 5. patch volume (PATCH /containers/{name}/volume; reference :275-328) ----

    def patch_container_volume(self, name: str, req: ContainerPatchVolume) -> dict:
        if req.old_bind is None or req.new_bind is None:
            raise errors.BadRequest("oldBind and newBind are required")
        base, version, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            base, version, latest_name = self._resolve_latest(name)
            state = self.store.get_container(latest_name)
            spec = ContainerSpec.from_dict(state.spec)

            old_str, new_str = req.old_bind.render(), req.new_bind.render()
            if old_str == new_str:
                raise errors.NoPatchRequired("binds identical")
            if old_str not in spec.binds:
                raise errors.BadRequest(f"bind {old_str} not present on {latest_name}")
            spec.binds = [new_str if b == old_str else b for b in spec.binds]

            new_name = self._rolling_replace(base, latest_name, spec)
            log.info("patched %s volume %s -> %s as %s", latest_name, old_str,
                     new_str, new_name)
            return {"name": new_name}

    # -- 6. stop (POST /containers/{name}/stop; reference :333-360) ---------------

    def stop_container(self, name: str, opts: ContainerStop | None = None) -> None:
        opts = opts or ContainerStop(restore_chips=True, restore_ports=True)
        base, _, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            info = self.runtime.container_inspect(latest_name)
            self.runtime.container_stop(latest_name)
            if opts.restore_chips:
                self.chips.restore_chips(info.spec.chip_ids, owner=base)
            if opts.restore_ports:
                self.ports.restore_ports(
                    [pb.host_port for pb in info.spec.port_bindings], owner=base
                )
            self._set_desired_running(latest_name, False)
            log.info("stopped container %s", latest_name)

    # -- 7. restart (PATCH /containers/{name}/restart; reference :365-425) --------

    def restart_container(self, name: str) -> dict:
        base, version, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            base, version, latest_name = self._resolve_latest(name)
            state = self.store.get_container(latest_name)
            spec = ContainerSpec.from_dict(state.spec)

            if not spec.chip_ids:
                # cardless short-circuit: plain runtime restart (reference :372-386)
                self.runtime.container_restart(latest_name)
                self._set_desired_running(latest_name, True)
                return {"name": latest_name}

            info = self.runtime.container_inspect(latest_name)
            if info.running:
                # running carded container: devices still attached; plain restart
                self.runtime.container_restart(latest_name)
                self._set_desired_running(latest_name, True)
                return {"name": latest_name}

            # stopped carded container: its chips/ports were restored on stop, so
            # re-allocate (possibly different chips) and roll a new version
            # (reference :390-425)
            chip_ids, contiguous = self.chips.apply_chips(
                len(spec.chip_ids), owner=base
            )
            try:
                render_gpu_attachment(
                    spec, chip_ids, self.chips.topology,
                    ici_contiguous=contiguous)
                for pb in spec.port_bindings:
                    pb.host_port = 0  # ports were restored on stop; re-allocate
                new_name = self._rolling_replace(base, latest_name, spec,
                                                 old_running=False)
            except Exception:
                self.chips.restore_chips(chip_ids, owner=base)
                raise
            log.info("restarted %s as %s (chips=%s)", latest_name, new_name, chip_ids)
            return {"name": new_name, "chipIds": chip_ids}

    def _set_desired_running(self, versioned: str, value: bool) -> None:
        """Record declarative liveness on the persisted state (synchronous —
        the crash-recovery decision must survive a control-plane restart)."""
        try:
            state = self.store.get_container(versioned)
        except errors.NotExistInStore:
            return
        if state.desired_running != value:
            state.desired_running = value
            self.store.put_container(state)

    def handle_crash(self, name: str) -> bool:
        """Crash-recovery entry for the health watcher (service/watch.py).

        Restart ``name`` only when (a) it is its family's LATEST version —
        retired versions from rolling replaces stay down — and (b) the
        control plane last wanted it running (stop_container records
        desired_running=False, so a user stop that exits 143 is never
        mistaken for a crash). Holds the family lock so recovery cannot race
        user mutations. A crash releases no chips/ports (only stop does), so
        the plain runtime restart keeps scheduler accounting consistent.
        Returns whether the container is running again.
        """
        base, version = split_versioned_name(name)
        with self._locks.hold(base):
            latest = self.versions.get(base)
            if latest is None or versioned_name(base, latest) != name:
                return False
            try:
                state = self.store.get_container(name)
            except errors.NotExistInStore:
                return False
            if not state.desired_running:
                return False
            info = self.runtime.container_inspect(name)
            if info.running:
                return True  # already recovered out-of-band
            self.runtime.container_restart(name)
            log.info("crash recovery: restarted %s", name)
            return True

    # -- 8. commit (POST /containers/{name}/commit; reference :428-447) -----------

    def commit_container(self, name: str, req: ContainerCommit) -> str:
        _, _, latest_name = self._resolve_latest(name)
        if not req.new_image_name:
            # the reference tags "" in this case (quirk catalog); we reject
            raise errors.BadRequest("newImageName is required")
        return self.runtime.container_commit(latest_name, req.new_image_name)

    # -- 9. info (GET /containers/{name}; reference :449-459) ---------------------

    def get_container_info(self, name: str) -> dict:
        base, version = split_versioned_name(name)
        if self.versions.get(base) is None:
            raise errors.ContainerNotExist(name)
        # reads are allowed on historical versions — the per-version store
        # retains them (unlike the reference's latest-wins etcd layout)
        try:
            state = self.store.get_container(name)
        except errors.NotExistInStore:
            raise errors.ContainerNotExist(name) from None
        out = {"state": state.to_dict(), "runtime": None}
        try:
            info = self.runtime.container_inspect(state.container_name)
            out["runtime"] = {
                "id": info.id,
                "running": info.running,
                "pid": info.pid,
                "exitCode": info.exit_code,
                "dataDir": info.data_dir,
            }
        except errors.ContainerNotExist:
            pass
        return out

    # -- 10. history / rollback (no working reference analog: README.md:142-144
    # advertises version rollback but the reference's latest-wins etcd layout
    # cannot deliver it, SURVEY.md appendix; the per-version store here can) --

    def get_container_history(self, name: str) -> dict:
        """Every stored version of the family, oldest first — the material
        rollback chooses from."""
        base, _ = split_versioned_name(name)
        latest = self.versions.get(base)
        if latest is None:
            raise errors.ContainerNotExist(name)
        out = []
        for v in self.store.history(Resource.CONTAINERS, base):
            vname = versioned_name(base, v)
            entry = {"name": vname, "version": v, "latest": v == latest,
                     "inRuntime": self.runtime.container_exists(vname)}
            try:
                st = self.store.get_container(vname)
                spec = ContainerSpec.from_dict(st.spec)
                entry.update(image=spec.image, chipCount=len(spec.chip_ids),
                             binds=list(spec.binds))
            except errors.NotExistInStore:
                pass
            out.append(entry)
        return {"base": base, "latest": latest, "versions": out}

    def rollback_container(self, name: str, req: ContainerRollback) -> dict:
        """Roll the family forward to a NEW version built from an older
        version's spec (K8s-revision style — rollback is itself versioned,
        never a mutation). Chips are re-derived from the current allocation
        (grown/shrunk through the scheduler to the target's count); data
        migrates from the latest container, or from the retired target
        container itself with ``dataFrom="target"`` (snapshot restore —
        retired versions are kept stopped precisely for this)."""
        base, version, latest_name = self._resolve_latest(name)
        with self._locks.hold(base):
            base, version, latest_name = self._resolve_latest(name)
            target = req.version
            if target == version:
                raise errors.NoPatchRequired(
                    f"{latest_name} is already version {target}")
            if target not in self.store.history(Resource.CONTAINERS, base):
                raise errors.BadRequest(
                    f"version {target} of {base} is not in the stored history")
            target_name = versioned_name(base, target)
            new_spec = ContainerSpec.from_dict(
                self.store.get_container(target_name).spec)
            cur_spec = ContainerSpec.from_dict(
                self.store.get_container(latest_name).spec)

            copy_from = latest_name
            if req.data_from == "target":
                if not self.runtime.container_exists(target_name):
                    raise errors.BadRequest(
                        f"dataFrom=target but {target_name} is gone from the "
                        "runtime")
                copy_from = target_name
            elif req.data_from != "latest":
                raise errors.BadRequest(
                    f"dataFrom must be 'latest' or 'target', got {req.data_from!r}")

            # adjust the LIVE chip allocation (scheduler ownership, not the
            # stored spec) to the target spec's count — shared discipline
            # with patch_container_chips
            new_chips, extra, to_release, contiguous = (
                self._adjust_chip_allocation(
                    base, cur_spec, len(new_spec.chip_ids)))
            # a STOPPED latest must not be quiesced (its ports were already
            # returned on stop) nor restarted by copy-failure compensation
            # (it was stopped deliberately) — same state check as restart
            latest_running = False
            try:
                latest_running = self.runtime.container_inspect(
                    latest_name).running
            except errors.ContainerNotExist:
                pass
            try:
                render_gpu_attachment(
                    new_spec, new_chips, self.chips.topology,
                    ici_contiguous=contiguous)
                new_name = self._rolling_replace(
                    base, latest_name, new_spec, old_running=latest_running,
                    copy_from=copy_from)
            except Exception:
                self.chips.restore_chips(extra, owner=base)
                raise
            self.chips.restore_chips(to_release, owner=base)
            log.info("rolled back %s to spec of v%d as %s (data from %s)",
                     latest_name, target, new_name, copy_from)
            return {"name": new_name, "fromVersion": target,
                    "chipIds": new_chips}

    # -- rolling replacement core -------------------------------------------------

    def _rolling_replace(
        self, base: str, old_name: str, new_spec: ContainerSpec,
        old_running: bool = True, copy_from: str | None = None,
    ) -> str:
        """Create ``base-(n+1)`` from ``new_spec``, migrate data from
        ``copy_from`` (default: ``old_name``), start the replacement.

        Fixed sequencing (SURVEY.md §5.4): quiesce the old container first,
        then copy, and only then start the new one — ordered on the work
        queue. If the copy dead-letters, compensation restarts the old
        container so the workload isn't stranded. The API returns the new
        name immediately; `GET /containers/{name}` shows runtime state while
        the migration completes.
        """
        copy_from = copy_from or old_name
        # compensation may only restart a container this flow stopped — a
        # latest that was ALREADY stopped stays stopped on copy failure
        restart_old_on_fail = old_running
        for pb in new_spec.port_bindings:
            pb.host_port = 0  # fresh host ports for the new version (reference :489-501)
        new_name = self._run_new_version(base, new_spec, start_now=False)
        crash_point("replace.after_create_new")

        quiesced_ports: list[int] | None = None
        if old_running:
            # quiesce: stop old, keep its chips (the new version inherits
            # them), release its old ports (reference stop opts :263-266)
            try:
                old_info = self.runtime.container_inspect(old_name)
                self.runtime.container_stop(old_name)
                self.ports.restore_ports(
                    [pb.host_port for pb in old_info.spec.port_bindings], owner=base
                )
                quiesced_ports = [pb.host_port
                                  for pb in old_info.spec.port_bindings]
            except errors.ContainerNotExist:
                old_running = False
            except Exception:
                # quiesce failed on a live engine error (chaos suite): undo
                # the replacement so the flow stays atomic — otherwise the
                # family is left with a version pointer at a container that
                # will never start
                self._undo_new_version(base, old_name, new_name)
                raise
        crash_point("replace.after_quiesce_old")

        # declarative records (not closures): the durable journal makes the
        # migrate-then-start intent survive a daemon crash — the reconciler
        # replays it under the next daemon (docs/robustness.md)
        try:
            if self.runtime.container_exists(copy_from):
                self.wq.submit_record(
                    "copy_container_data",
                    {"base": base, "copyFrom": copy_from, "newName": new_name,
                     "oldName": old_name, "startNew": True,
                     "restartOldOnFail": restart_old_on_fail},
                    idempotency_key=f"copy:containers:{copy_from}->{new_name}",
                )
            else:
                self.wq.submit_record(
                    "start_version", {"base": base, "name": new_name},
                    idempotency_key=f"start:containers:{new_name}",
                )
        except (errors.QueueSaturated, errors.QueueClosed):
            # a rejected submit must leave NOTHING half-applied (the same
            # contract as volume resize) — without the record neither the
            # copy nor the start can ever replay, so the family would be
            # stranded: latest an unstarted data-less container, old one
            # stopped. Un-quiesce the old container, then retire the
            # replacement, before surfacing the backpressure
            if quiesced_ports is not None:
                conflicts = self.ports.try_claim_ports(quiesced_ports,
                                                       owner=base)
                if conflicts:
                    # another family grabbed the ports inside the submit
                    # window; the engine arbitrates the actual bind
                    log.error("un-quiesce of %s: ports %s already claimed",
                              old_name, conflicts)
                with contextlib.suppress(Exception):
                    self.runtime.container_start(old_name)
            self._undo_new_version(base, old_name, new_name)
            raise
        return new_name

    # -- durable task handlers (registry kinds this service executes) -------------

    def _latest_of(self, base: str) -> str | None:
        latest = self.versions.get(base)
        return None if latest is None else versioned_name(base, latest)

    def _task_copy_data(self, rec: TaskRecord) -> None:
        """Execute a ``copy_container_data`` record: migrate data old→new,
        then start the replacement. Safe to replay: the copy-complete
        MARKER is written before the start, so a re-run after a crash at
        any point skips the copy once the new container may be running —
        a replayed copy never re-clobbers a started container."""
        p = rec.params
        with self._locks.hold(p["base"]):
            new_name = p["newName"]
            if (self._latest_of(p["base"]) != new_name
                    or not self.runtime.container_exists(new_name)):
                # the family moved on (reconciler rolled the replacement
                # back, a newer replace superseded it, or it was deleted):
                # this record is obsolete — starting a retired version
                # would resurrect a second live version
                log.info("copy task for %s is obsolete; skipping", new_name)
                return
            if not self.wq.marker_done(rec.task_id, rec.shard):
                if self.runtime.container_exists(p["copyFrom"]):
                    self.wq.copy_dirs(
                        self.runtime.container_data_dir(p["copyFrom"]),
                        self.runtime.container_data_dir(new_name))
                # marker BEFORE start: the non-idempotent step is proven
                # done before anything may write into the new container
                self.wq.mark_done(rec.task_id, rec.shard)
            if p.get("startNew", True):
                self.runtime.container_start(new_name)
                log.info("rolling replace %s -> %s complete",
                         p["oldName"], new_name)

    def _task_copy_failed(self, rec: TaskRecord) -> None:
        """Dead-letter compensation: the migration is lost, so restart the
        old container (if this flow stopped it) — the workload must not
        stay stranded on a replacement that never got its data."""
        p = rec.params
        log.error("data migration %s -> %s dead-lettered%s", p["copyFrom"],
                  p["newName"],
                  "; restarting old container" if p.get("restartOldOnFail")
                  else "")
        if p.get("restartOldOnFail"):
            with contextlib.suppress(Exception):
                self.runtime.container_start(p["oldName"])

    def _task_start_version(self, rec: TaskRecord) -> None:
        """Execute a ``start_version`` record (no-copy replacement path).
        Idempotent: starting a running container is a no-op, and an
        obsolete record (family moved on) is skipped."""
        p = rec.params
        with self._locks.hold(p["base"]):
            if (self._latest_of(p["base"]) != p["name"]
                    or not self.runtime.container_exists(p["name"])):
                log.info("start task for %s is obsolete; skipping", p["name"])
                return
            self.runtime.container_start(p["name"])

    def _undo_new_version(self, base: str, old_name: str, new_name: str) -> None:
        """Best-effort compensation: retire a freshly created replacement
        (container, ports, stored spec, version pointer) when the rest of
        the flow cannot proceed. Every step is idempotent — the reconciler
        applies the same recipe after a crash."""
        with contextlib.suppress(Exception):
            state = self.store.get_container(new_name)
            spec = ContainerSpec.from_dict(state.spec)
            self.ports.restore_ports(
                [pb.host_port for pb in spec.port_bindings], owner=base)
        with contextlib.suppress(Exception):
            if self.runtime.container_exists(new_name):
                self.runtime.container_remove(new_name, force=True)
        self.store.delete_version(Resource.CONTAINERS, new_name)
        _, old_version = split_versioned_name(old_name)
        self.versions.rollback(base, old_version)
