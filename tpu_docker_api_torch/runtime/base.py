"""Abstract container runtime.

The method set is exactly the docker SDK surface the reference's service layer
touches (SURVEY.md §3 call stacks): create/start/stop/restart/remove/inspect/
list/exec/commit for containers, create/remove/inspect for volumes, plus the
data-directory lookups the copy tasks need (GraphDriver MergedDir /
volume Mountpoint, workQueue/copy.go:34-85).

The port's copy of ``tpu_docker_api/runtime/base.py``.
"""

from __future__ import annotations

import abc
import dataclasses

from tpu_docker_api_torch.runtime.spec import ContainerSpec


@dataclasses.dataclass
class ContainerInfo:
    """Subset of docker inspect the services consume."""
    name: str
    id: str
    running: bool
    spec: ContainerSpec
    data_dir: str = ""     # overlay MergedDir analog (copy source/target)
    pid: int = 0
    exit_code: int = 0
    # docker State.Status ("created" | "running" | "exited" | ...). The
    # reconciler uses "created" to tell a never-started replacement (roll it
    # back) from a crashed container (restart it). "" = backend unknown.
    status: str = ""


@dataclasses.dataclass
class VolumeInfo:
    name: str
    mountpoint: str
    driver_opts: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ExecResult:
    exit_code: int
    output: str   # demuxed stdout+stderr, reference stdcopy.StdCopy
                  # (service/container.go:169-172)


class ContainerRuntime(abc.ABC):
    # -- containers --------------------------------------------------------------

    @abc.abstractmethod
    def container_create(self, spec: ContainerSpec) -> str:
        """Create (not start); returns container id. Raises on name clash."""

    @abc.abstractmethod
    def container_start(self, name: str) -> None: ...

    @abc.abstractmethod
    def container_stop(self, name: str, timeout_s: int = 10) -> None: ...

    @abc.abstractmethod
    def container_restart(self, name: str) -> None: ...

    @abc.abstractmethod
    def container_remove(self, name: str, force: bool = False) -> None: ...

    @abc.abstractmethod
    def container_inspect(self, name: str) -> ContainerInfo:
        """Raises errors.ContainerNotExist if absent."""

    @abc.abstractmethod
    def container_exists(self, name: str) -> bool: ...

    @abc.abstractmethod
    def container_list(self) -> list[str]:
        """Names of all containers, running or not."""

    @abc.abstractmethod
    def container_exec(
        self, name: str, cmd: list[str], workdir: str = ""
    ) -> ExecResult: ...

    @abc.abstractmethod
    def container_commit(self, name: str, image_ref: str) -> str:
        """Commit container fs to an image; returns image id."""

    # -- volumes -----------------------------------------------------------------

    @abc.abstractmethod
    def volume_create(self, name: str, driver_opts: dict[str, str]) -> VolumeInfo: ...

    @abc.abstractmethod
    def volume_remove(self, name: str, force: bool = False) -> None: ...

    @abc.abstractmethod
    def volume_inspect(self, name: str) -> VolumeInfo:
        """Raises errors.VolumeNotExist if absent."""

    @abc.abstractmethod
    def volume_exists(self, name: str) -> bool: ...

    # -- data dirs for migration -------------------------------------------------

    def container_data_dir(self, name: str) -> str:
        return self.container_inspect(name).data_dir

    def volume_data_dir(self, name: str) -> str:
        return self.volume_inspect(name).mountpoint

    def close(self) -> None:  # noqa: B027
        pass
