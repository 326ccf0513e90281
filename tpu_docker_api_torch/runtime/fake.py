"""In-memory fake container engine.

The hermetic seam SURVEY.md §4 prescribes: containers and volumes are dicts,
but their data directories are REAL directories under a tmp root, so the
rolling-replacement copy flows (workQueue CopyTask) exercise actual file IO.
With ``allow_exec=True``, ``container_exec`` runs the command as a host
subprocess inside the container's data dir, with the spec's env — enough to
run the JAX-CPU matmul smoke test of BASELINE.json config #1 without a
docker daemon, and, on a GPU host, a process that sees only the GPUs its
``CUDA_VISIBLE_DEVICES`` grants (none for a GPU-less container).

The port's copy of ``tpu_docker_api/runtime/fake.py``, plus ``persist``:
given a ``root``, the runtime keeps each container's and volume's record
(``record.json`` beside its data directory) and reloads them at
construction, so a daemon restarted over the same root finds what a real
engine, which outlives the control plane, would still hold.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import threading
import uuid

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.runtime.base import (
    ContainerInfo,
    ContainerRuntime,
    ExecResult,
    VolumeInfo,
)
from tpu_docker_api_torch.runtime.spec import ContainerSpec


class FakeRuntime(ContainerRuntime):
    def __init__(self, root: str | None = None, allow_exec: bool = False,
                 persist: bool = False) -> None:
        if persist and root is None:
            raise ValueError("a persistent FakeRuntime needs a root")
        self._root = root or tempfile.mkdtemp(prefix="tpu-docker-api-fake-")
        self._owns_root = root is None
        self._allow_exec = allow_exec
        self._persist = persist
        self._mu = threading.RLock()
        self._containers: dict[str, ContainerInfo] = {}
        self._volumes: dict[str, VolumeInfo] = {}
        self._images: dict[str, str] = {}  # image_ref → id
        #: ordered log of engine calls, for flow assertions in tests
        self.calls: list[tuple[str, str]] = []
        if persist:
            self._load()

    # -- persistence (persist=True) -------------------------------------------

    def _load(self) -> None:
        for name, rec in _records(os.path.join(self._root, "containers")):
            self._containers[name] = ContainerInfo(
                name=name, id=rec["id"], running=rec["running"],
                spec=ContainerSpec.from_dict(rec["spec"]),
                data_dir=rec["data_dir"], pid=rec["pid"],
                exit_code=rec["exit_code"], status=rec["status"])
        for name, rec in _records(os.path.join(self._root, "volumes")):
            self._volumes[name] = VolumeInfo(
                name=name, mountpoint=rec["mountpoint"],
                driver_opts=rec["driver_opts"])

    def _save_container(self, info: ContainerInfo) -> None:
        if self._persist:
            _write_record(os.path.dirname(info.data_dir), {
                "id": info.id, "running": info.running,
                "spec": info.spec.to_dict(), "data_dir": info.data_dir,
                "pid": info.pid, "exit_code": info.exit_code,
                "status": info.status})

    def _save_volume(self, info: VolumeInfo) -> None:
        if self._persist:
            _write_record(os.path.dirname(info.mountpoint), {
                "mountpoint": info.mountpoint,
                "driver_opts": info.driver_opts})

    # -- containers --------------------------------------------------------------

    def container_create(self, spec: ContainerSpec) -> str:
        with self._mu:
            if spec.name in self._containers:
                raise errors.ContainerExisted(spec.name)
            data_dir = os.path.join(self._root, "containers", spec.name, "merged")
            os.makedirs(data_dir, exist_ok=True)
            cid = uuid.uuid4().hex[:12]
            self._containers[spec.name] = ContainerInfo(
                name=spec.name, id=cid, running=False, spec=spec,
                data_dir=data_dir, status="created",
            )
            self._save_container(self._containers[spec.name])
            self.calls.append(("create", spec.name))
            return cid

    def _get(self, name: str) -> ContainerInfo:
        info = self._containers.get(name)
        if info is None:
            raise errors.ContainerNotExist(name)
        return info

    def container_start(self, name: str) -> None:
        with self._mu:
            info = self._get(name)
            info.running = True
            info.pid = os.getpid()
            info.status = "running"
            self._save_container(info)
            self.calls.append(("start", name))

    def container_stop(self, name: str, timeout_s: int = 10) -> None:
        with self._mu:
            info = self._get(name)
            info.running = False
            info.pid = 0
            if info.status != "created":  # stopping a created container is a no-op
                info.status = "exited"
            self._save_container(info)
            self.calls.append(("stop", name))

    def container_restart(self, name: str) -> None:
        with self._mu:
            info = self._get(name)
            info.running = True
            info.exit_code = 0
            info.status = "running"
            self._save_container(info)
            self.calls.append(("restart", name))

    def crash_container(self, name: str, exit_code: int = 137) -> None:
        """Fault injection (SURVEY.md §5.3 — absent in the reference): make a
        running container die out-of-band, as OOM/preemption would."""
        with self._mu:
            info = self._get(name)
            info.running = False
            info.pid = 0
            info.exit_code = exit_code
            info.status = "exited"
            self._save_container(info)
            self.calls.append(("crash", name))

    def container_remove(self, name: str, force: bool = False) -> None:
        with self._mu:
            info = self._get(name)
            if info.running and not force:
                raise errors.ApiError(f"container {name} is running; use force")
            shutil.rmtree(os.path.dirname(info.data_dir), ignore_errors=True)
            del self._containers[name]
            self.calls.append(("remove", name))

    def container_inspect(self, name: str) -> ContainerInfo:
        with self._mu:
            return self._get(name)

    def seed_running(self, names: list[str], spec: ContainerSpec,
                     running: bool = True) -> None:
        """Bulk-seed running containers sharing one spec and one data dir
        — the O(100k)-object scale harness's seam (bench.py scale family,
        tests). ``container_create`` makes a directory per container; at
        50k+ seeded objects that is filesystem work the benchmark is not
        measuring. Seeded containers behave exactly like created+started
        ones minus the per-container data dir (copies would collide — the
        scale world never exercises them) and, with ``persist``, minus a
        record: they do not outlive the runtime."""
        data_dir = os.path.join(self._root, "seed", "merged")
        os.makedirs(data_dir, exist_ok=True)
        with self._mu:
            for name in names:
                if name in self._containers:
                    raise errors.ContainerExisted(name)
                self._containers[name] = ContainerInfo(
                    name=name, id=uuid.uuid4().hex[:12], running=running,
                    spec=dataclasses.replace(spec, name=name),
                    data_dir=data_dir,
                    status="running" if running else "exited",
                    pid=os.getpid() if running else 0,
                )

    def container_exists(self, name: str) -> bool:
        with self._mu:
            return name in self._containers

    def container_list(self) -> list[str]:
        with self._mu:
            return sorted(self._containers)

    def container_exec(self, name: str, cmd: list[str], workdir: str = "") -> ExecResult:
        with self._mu:
            info = self._get(name)
            if not info.running:
                raise errors.ApiError(f"container {name} is not running")
            env = dict(os.environ)
            # the child sees exactly the container's grant: the host's own
            # CUDA_VISIBLE_DEVICES never leaks in, and a GPU-less spec
            # (which renders none) hides every GPU. JAX's fake exec passes
            # the host's variable through
            env["CUDA_VISIBLE_DEVICES"] = ""
            for e in info.spec.env:
                k, _, v = e.partition("=")
                env[k] = v
            # journaled under the lock like every other op: concurrent
            # fan-out callers must not corrupt the call log tests assert on
            self.calls.append(("exec", name))
        if not self._allow_exec:
            return ExecResult(exit_code=0, output=f"[fake exec] {' '.join(cmd)}")
        proc = subprocess.run(
            cmd,
            cwd=workdir or info.data_dir,
            env=env,
            capture_output=True,
            text=True,
            timeout=300,
        )
        return ExecResult(
            exit_code=proc.returncode, output=proc.stdout + proc.stderr
        )

    def container_commit(self, name: str, image_ref: str) -> str:
        with self._mu:
            self._get(name)
            img_id = "sha256:" + uuid.uuid4().hex
            self._images[image_ref] = img_id
            self.calls.append(("commit", name))
            return img_id

    # -- volumes -----------------------------------------------------------------

    def volume_create(self, name: str, driver_opts: dict[str, str]) -> VolumeInfo:
        with self._mu:
            if name in self._volumes:
                raise errors.VolumeExisted(name)
            mountpoint = os.path.join(self._root, "volumes", name, "_data")
            os.makedirs(mountpoint, exist_ok=True)
            info = VolumeInfo(name=name, mountpoint=mountpoint, driver_opts=dict(driver_opts))
            self._volumes[name] = info
            self._save_volume(info)
            self.calls.append(("volume_create", name))
            return info

    def volume_remove(self, name: str, force: bool = False) -> None:
        with self._mu:
            if name not in self._volumes:
                raise errors.VolumeNotExist(name)
            shutil.rmtree(os.path.dirname(self._volumes[name].mountpoint),
                          ignore_errors=True)
            del self._volumes[name]
            self.calls.append(("volume_remove", name))

    def volume_inspect(self, name: str) -> VolumeInfo:
        with self._mu:
            info = self._volumes.get(name)
            if info is None:
                raise errors.VolumeNotExist(name)
            return info

    def volume_exists(self, name: str) -> bool:
        with self._mu:
            return name in self._volumes

    def close(self) -> None:
        if self._owns_root:
            shutil.rmtree(self._root, ignore_errors=True)


_RECORD = "record.json"


def _write_record(obj_dir: str, rec: dict) -> None:
    """Write ``obj_dir/record.json`` atomically (a kill mid-write leaves the
    previous record, never half of one)."""
    tmp = os.path.join(obj_dir, f".{_RECORD}.tmp")
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, os.path.join(obj_dir, _RECORD))


def _records(kind_dir: str):
    """(name, record) of every object under ``kind_dir`` that has one."""
    if not os.path.isdir(kind_dir):
        return
    for name in sorted(os.listdir(kind_dir)):
        path = os.path.join(kind_dir, name, _RECORD)
        if os.path.exists(path):
            with open(path) as f:
                yield name, json.load(f)
