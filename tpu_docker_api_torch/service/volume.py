"""Volume orchestration service.

Parity: reference ``internal/service/volume.go`` — create a named+sized volume
(local driver with a ``size`` opt, which requires overlay2-on-xfs project
quotas, docs/volume/volume-size-scale-en.md), delete, resize via
new-volume-plus-copy with the shrink guard, and info. Same immutable
``name-(n)`` versioning as containers.

The port's copy of ``tpu_docker_api/service/volume.py``.
"""

from __future__ import annotations

import contextlib
import logging
import threading

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import ContainerRuntime
from tpu_docker_api_torch.schemas.state import VolumeState
from tpu_docker_api_torch.schemas.volume import (
    VolumeCreate,
    VolumeDelete,
    VolumeRollback,
    VolumeSize,
    parse_size,
)
from tpu_docker_api_torch.state.keys import Resource, split_versioned_name, versioned_name
from tpu_docker_api_torch.state.store import StateStore
from tpu_docker_api_torch.state.version import VersionMap
from tpu_docker_api_torch.state.workqueue import TaskRecord, WorkQueue
from tpu_docker_api_torch.utils.files import dir_size

log = logging.getLogger(__name__)


class VolumeService:
    def __init__(
        self,
        runtime: ContainerRuntime,
        store: StateStore,
        versions: VersionMap,
        work_queue: WorkQueue,
    ) -> None:
        self.runtime = runtime
        self.store = store
        self.versions = versions
        self.wq = work_queue
        self._locks: dict[str, threading.RLock] = {}
        self._locks_mu = threading.Lock()
        # durable-queue registry: volume data copies are declarative records
        # (kind + params), replayable by any daemon over the same KV
        work_queue.register("copy_volume_data", self._task_copy_data)

    @contextlib.contextmanager
    def _hold(self, base: str):
        with self._locks_mu:
            lock = self._locks.setdefault(base, threading.RLock())
        with lock:
            yield

    def _resolve_latest(self, name: str) -> tuple[str, int, str]:
        base, version = split_versioned_name(name)
        latest = self.versions.get(base)
        if latest is None:
            raise errors.VolumeNotExist(name)
        if version is not None and version != latest:
            raise errors.VersionNotMatch(f"{name}: latest version is {latest}")
        return base, latest, versioned_name(base, latest)

    # -- create (POST /volumes; reference CreateVolume :28-53) --------------------

    def create_volume(self, req: VolumeCreate) -> dict:
        base = req.volume_name
        with self._hold(base):
            if self.versions.contains(base):
                raise errors.VolumeExisted(base)
            if req.size:
                parse_size(req.size)  # validate unit early (api/volume.go:118-124)
            name = self._create_version(base, req.size)
            return {"name": name, "size": req.size}

    def _create_version(self, base: str, size: str) -> str:
        """Version bump → docker VolumeCreate with size opt → async persist
        (reference createVolume :56-95)."""
        prev = self.versions.get(base)
        version = self.versions.next_version(base)
        name = versioned_name(base, version)
        opts = {"size": size} if size else {}
        try:
            self.runtime.volume_create(name, opts)
        except Exception:
            self.versions.rollback(base, prev)
            raise
        # persist synchronously: a version pointer must always have its state
        self.store.put_volume(VolumeState(volume_name=name, version=version,
                                          size=size, driver_opts=opts))
        log.info("created volume %s (size=%s)", name, size or "unsized")
        return name

    # -- delete (DELETE /volumes/{name}; reference DeleteVolume :98-116) ----------

    def delete_volume(self, name: str, req: VolumeDelete) -> None:
        base, latest, latest_name = self._resolve_latest(name)
        with self._hold(base):
            # remove every runtime version of the family (old versions are
            # retained after resize for rollback and must not leak)
            for v in self.store.history(Resource.VOLUMES, base) or [latest]:
                with contextlib.suppress(errors.VolumeNotExist):
                    self.runtime.volume_remove(versioned_name(base, v), force=True)
            if req.del_etcd_info_and_version_record:
                # submit BEFORE dropping the version pointer: a saturated
                # queue (429) there would otherwise leak the state family
                # forever — the retried delete 404s on the missing pointer
                # and can never reach this purge again
                self.wq.submit_record(
                    "delete_state_family",
                    {"resource": Resource.VOLUMES.value, "base": base},
                    idempotency_key=f"purge:volumes:{base}",
                )
                self.versions.remove(base)
            log.info("deleted volume family %s", base)

    # -- resize (PATCH /volumes/{name}/size; reference PatchVolumeSize :122-187) --

    def patch_volume_size(self, name: str, req: VolumeSize) -> dict:
        base, version, latest_name = self._resolve_latest(name)
        with self._hold(base):
            return self._patch_volume_size_locked(name, req)

    def _patch_volume_size_locked(self, name: str, req: VolumeSize) -> dict:
        base, version, latest_name = self._resolve_latest(name)
        state = self.store.get_volume(latest_name)
        new_bytes = parse_size(req.size)

        if state.size and parse_size(state.size) == new_bytes:
            raise errors.NoPatchRequired(f"{latest_name} is already {req.size}")

        # shrink guard (reference :151-166 + utils DirSize)
        mountpoint = self.runtime.volume_data_dir(latest_name)
        used = dir_size(mountpoint)
        if used > new_bytes:
            raise errors.VolumeSizeUsedGreaterThanReduced(
                f"{latest_name}: {used} bytes in use > target {req.size}"
            )

        # submit BEFORE creating the version: a saturated queue (429) must
        # leave NOTHING half-applied. Sound because the copy handler takes
        # the family lock we hold (it cannot run before the volume exists)
        # and skips obsolete records (a crash before the create leaves a
        # record the replay recognizes as moot and drops)
        new_name = versioned_name(base, version + 1)
        self.wq.submit_record(
            "copy_volume_data",
            {"base": base, "copyFrom": latest_name, "newName": new_name},
            idempotency_key=f"copy:volumes:{latest_name}->{new_name}",
        )
        created = self._create_version(base, req.size)
        assert created == new_name, f"{created} != planned {new_name}"
        log.info("resized volume %s -> %s (%s)", latest_name, new_name, req.size)
        return {"name": new_name, "size": req.size}

    # -- history / rollback (no working reference analog — README.md:142-144
    # advertises rollback, the latest-wins etcd layout can't deliver it) ----------

    def get_volume_history(self, name: str) -> dict:
        base, _ = split_versioned_name(name)
        latest = self.versions.get(base)
        if latest is None:
            raise errors.VolumeNotExist(name)
        out = []
        for v in self.store.history(Resource.VOLUMES, base):
            vname = versioned_name(base, v)
            entry = {"name": vname, "version": v, "latest": v == latest}
            try:
                self.runtime.volume_inspect(vname)
                entry["inRuntime"] = True
            except errors.VolumeNotExist:
                entry["inRuntime"] = False
            with contextlib.suppress(errors.NotExistInStore):
                entry["size"] = self.store.get_volume(vname).size
            out.append(entry)
        return {"base": base, "latest": latest, "versions": out}

    def rollback_volume(self, name: str, req: VolumeRollback) -> dict:
        """New version with the target version's size; data copies from the
        latest volume (default) or from the retained target volume itself
        (``dataFrom="target"`` — snapshot restore). The shrink guard applies
        to whichever source is copied."""
        base, version, latest_name = self._resolve_latest(name)
        with self._hold(base):
            base, version, latest_name = self._resolve_latest(name)
            target = req.version
            if target == version:
                raise errors.NoPatchRequired(
                    f"{latest_name} is already version {target}")
            if target not in self.store.history(Resource.VOLUMES, base):
                raise errors.BadRequest(
                    f"version {target} of {base} is not in the stored history")
            target_name = versioned_name(base, target)
            t_state = self.store.get_volume(target_name)

            src_name = latest_name
            if req.data_from == "target":
                try:
                    self.runtime.volume_inspect(target_name)
                except errors.VolumeNotExist:
                    raise errors.BadRequest(
                        f"dataFrom=target but {target_name} is gone from the "
                        "runtime") from None
                src_name = target_name
            elif req.data_from != "latest":
                raise errors.BadRequest(
                    f"dataFrom must be 'latest' or 'target', got {req.data_from!r}")

            if t_state.size:
                used = dir_size(self.runtime.volume_data_dir(src_name))
                if used > parse_size(t_state.size):
                    raise errors.VolumeSizeUsedGreaterThanReduced(
                        f"{src_name}: {used} bytes in use > rollback target "
                        f"size {t_state.size}")

            # submit-then-create, like the resize path: saturation (429)
            # must not leave a data-less version behind
            new_name = versioned_name(base, version + 1)
            self.wq.submit_record(
                "copy_volume_data",
                {"base": base, "copyFrom": src_name, "newName": new_name},
                idempotency_key=f"copy:volumes:{src_name}->{new_name}",
            )
            created = self._create_version(base, t_state.size)
            assert created == new_name, f"{created} != planned {new_name}"
            log.info("rolled back volume %s to v%d as %s (data from %s)",
                     latest_name, target, new_name, src_name)
            return {"name": new_name, "fromVersion": target,
                    "size": t_state.size}

    # -- durable task handlers (registry kinds this service executes) -------------

    def _task_copy_data(self, rec: TaskRecord) -> None:
        """Execute a ``copy_volume_data`` record. Replay-safe: the
        copy-complete marker proves a crash-interrupted run already moved
        the data, so adoption never re-clobbers a volume a workload may
        have started writing to."""
        p = rec.params
        with self._hold(p["base"]):
            if self.wq.marker_done(rec.task_id, rec.shard):
                return
            try:
                src = self.runtime.volume_data_dir(p["copyFrom"])
                dst = self.runtime.volume_data_dir(p["newName"])
            except errors.VolumeNotExist:
                # source or replacement gone (family deleted, rollback):
                # the record is obsolete
                log.info("volume copy %s -> %s is obsolete; skipping",
                         p["copyFrom"], p["newName"])
                return
            log.info("copying volume data %s -> %s (%s -> %s)",
                     p["copyFrom"], p["newName"], src, dst)
            self.wq.copy_dirs(src, dst)
            self.wq.mark_done(rec.task_id, rec.shard)

    # -- info (GET /volumes/{name}; reference GetVolumeInfo :189-199) -------------

    def get_volume_info(self, name: str) -> dict:
        _, _, latest_name = self._resolve_latest(name)
        state = self.store.get_volume(latest_name)
        out = {"state": state.to_dict(), "runtime": None}
        try:
            info = self.runtime.volume_inspect(latest_name)
            out["runtime"] = {
                "mountpoint": info.mountpoint,
                "driverOpts": info.driver_opts,
                "usedBytes": dir_size(info.mountpoint),
            }
        except errors.VolumeNotExist:
            pass
        return out
