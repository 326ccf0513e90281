"""State-store payloads.

Parity: reference ``internal/model/etcd.go:12-36`` — the full, runtime-validated
container/volume spec is persisted so any flow can rebuild an identical
resource (the control plane's checkpoint, SURVEY.md §5.4). Unlike the
reference (which stores raw docker SDK structs), we persist our own
runtime-neutral spec (`tpu_docker_api_torch.runtime.spec.ContainerSpec`) as a dict,
so the payload survives a runtime-backend swap.

The port's copy of ``tpu_docker_api/schemas/state.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ContainerState:
    """Persisted per container family version (model/etcd.go EtcdContainerInfo)."""
    container_name: str  # versioned name, e.g. "train-3"
    version: int
    spec: dict[str, Any]  # runtime.spec.ContainerSpec.to_dict()
    # declarative liveness: False after a deliberate stop. The health
    # watcher's crash recovery only resurrects containers whose latest
    # version wants to run (SURVEY.md §5.3)
    desired_running: bool = True

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ContainerState":
        return ContainerState(
            container_name=d["container_name"],
            version=int(d["version"]),
            spec=d["spec"],
            desired_running=bool(d.get("desired_running", True)),
        )


@dataclasses.dataclass
class VolumeState:
    """Persisted per volume family version (model/etcd.go EtcdVolumeInfo)."""
    volume_name: str  # versioned name, e.g. "data-2"
    version: int
    size: str  # e.g. "10GB"; "" ⇒ unsized
    driver_opts: dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "VolumeState":
        return VolumeState(
            volume_name=d["volume_name"],
            version=int(d["version"]),
            size=d.get("size", ""),
            driver_opts=d.get("driver_opts", {}),
        )
