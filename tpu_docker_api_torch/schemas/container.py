"""Container request DTOs.

Parity: reference ``internal/model/container.go:7-44``. The port's copy of
``tpu_docker_api/schemas/container.py``: the same fields and wire keys.
``GpuCount`` is ``chip_count`` (a chip is one whole GPU, granted by UUID);
the body takes ``chipCount`` or the reference's ``gpuCount``. ``slice_shape``
asks for a contiguous block of NVML indices (e.g. "2") instead of a bare
count.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from tpu_docker_api_torch import errors


@dataclasses.dataclass
class ContainerPort:
    """One container→host port mapping; host side is scheduler-assigned."""
    container_port: int
    host_port: int = 0  # 0 ⇒ allocate from the port scheduler
    protocol: str = "tcp"


@dataclasses.dataclass
class Bind:
    """Volume bind ``src:dest`` (model/volume.go Bind{Src,Dest})."""
    src: str
    dest: str

    def render(self) -> str:
        return f"{self.src}:{self.dest}"


@dataclasses.dataclass
class ContainerRun:
    """POST /containers body (model/container.go:7-15, ContainerRun)."""
    image_name: str
    container_name: str
    chip_count: int = 0
    slice_shape: str = ""  # optional: ask for a contiguous block
    binds: list[Bind] = dataclasses.field(default_factory=list)
    env: list[str] = dataclasses.field(default_factory=list)
    cmd: list[str] = dataclasses.field(default_factory=list)
    container_ports: list[ContainerPort] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ContainerRun":
        return ContainerRun(
            image_name=d.get("imageName", ""),
            container_name=d.get("containerName", ""),
            chip_count=errors.as_int(
                d.get("chipCount", d.get("gpuCount", 0)), "chipCount"),
            slice_shape=d.get("sliceShape", ""),
            binds=[Bind(b["src"], b["dest"]) for b in d.get("binds", [])],
            env=list(d.get("env", [])),
            cmd=list(d.get("cmd", [])),
            container_ports=[
                ContainerPort(
                    container_port=errors.as_int(p["containerPort"],
                                                 "containerPort"),
                    host_port=errors.as_int(p.get("hostPort", 0), "hostPort"),
                    protocol=p.get("protocol", "tcp"),
                )
                for p in d.get("containerPorts", [])
            ],
        )


@dataclasses.dataclass
class ContainerDelete:
    """DELETE /containers/{name} body (model/container.go ContainerDelete)."""
    force: bool = False
    del_etcd_info_and_version_record: bool = False


@dataclasses.dataclass
class ContainerExecute:
    """POST /containers/{name}/execute body (model/container.go ContainerExecute)."""
    work_dir: str = ""
    cmd: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ContainerPatchChips:
    """PATCH /containers/{name}/gpu body (model/container.go ContainerGpuPatch)."""
    chip_count: int = 0


@dataclasses.dataclass
class ContainerPatchVolume:
    """PATCH /containers/{name}/volume body (model/container.go ContainerVolumePatch)."""
    old_bind: Bind | None = None
    new_bind: Bind | None = None


@dataclasses.dataclass
class ContainerStop:
    """Internal stop options (model/container.go ContainerStop / service use)."""
    restore_chips: bool = False
    restore_ports: bool = False


@dataclasses.dataclass
class ContainerCommit:
    """POST /containers/{name}/commit body (model/container.go ContainerCommit)."""
    new_image_name: str = ""


@dataclasses.dataclass
class ContainerRollback:
    """PATCH /containers/{name}/rollback body. No reference analog — its
    README advertises version rollback (README.md:142-144) but the
    latest-wins etcd layout cannot deliver it (SURVEY.md appendix)."""
    version: int
    data_from: str = "latest"  # "latest" (keep newest data) | "target" (snapshot restore)
