"""GPU telemetry wire format.

Parity: reference ``internal/model/gpu.go:3-28`` — the NVML-shaped
``GpuInfo/Memory/ProcessInfo`` structs returned by the detect-gpu sidecar.
The port's counterpart of ``tpu_docker_api/schemas/tpu.py``: the same
classes, fields and ``to_dict``/``from_dict`` keys, read from NVML. A chip
is one whole GPU; ``ChipInfo`` adds what the reference's struct carries and
a TPU has no word for: the UUID the scheduler hands out, the product name
and the enforced power limit.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ChipInfo:
    """One GPU as reported by the telemetry sidecar (NVML GpuInfo)."""
    chip_id: int                      # NVML index (its /dev/nvidia<minor> need not match)
    device_path: str                  # e.g. "/dev/nvidia0"
    coords: tuple[int, int, int]      # (i, 0, 0): NVSwitch joins a host's GPUs all to all
    cores_per_chip: int = 1
    hbm_total_bytes: int = 0
    hbm_used_bytes: int = 0
    duty_cycle_pct: float = 0.0       # NVML utilization.gpu
    pid: int = 0                      # a process holding the GPU, else 0
    uuid: str = ""                    # "GPU-..." (what DeviceRequests carries)
    name: str = ""                    # NVML product name
    power_limit_w: float = 0.0        # NVML enforced power limit

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["coords"] = list(self.coords)
        return d

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ChipInfo":
        return ChipInfo(
            chip_id=int(d["chip_id"]),
            device_path=d.get("device_path", f"/dev/nvidia{d['chip_id']}"),
            coords=tuple(d.get("coords", (0, 0, 0))),  # type: ignore[arg-type]
            cores_per_chip=int(d.get("cores_per_chip", 1)),
            hbm_total_bytes=int(d.get("hbm_total_bytes", 0)),
            hbm_used_bytes=int(d.get("hbm_used_bytes", 0)),
            duty_cycle_pct=float(d.get("duty_cycle_pct", 0.0)),
            pid=int(d.get("pid", 0)),
            uuid=d.get("uuid", ""),
            name=d.get("name", ""),
            power_limit_w=float(d.get("power_limit_w", 0.0)),
        )


@dataclasses.dataclass
class HostTopologyInfo:
    """The sidecar's host summary: what ``GET /api/v1/detect/gpu`` returns.

    The scheduler seeds from this on first boot, the way the reference seeds
    its GPU map from detect-gpu (gpuscheduler/scheduler.go:142-158).
    """
    accelerator_type: str             # e.g. "h100-8"
    generation: str                   # "h100", "a100", ...
    chips: list[ChipInfo] = dataclasses.field(default_factory=list)
    mesh_shape: tuple[int, int, int] = (0, 0, 0)   # host-local mesh
    driver_version: str = ""          # NVML system driver version

    def to_dict(self) -> dict[str, Any]:
        return {
            "accelerator_type": self.accelerator_type,
            "generation": self.generation,
            "chips": [c.to_dict() for c in self.chips],
            "mesh_shape": list(self.mesh_shape),
            "driver_version": self.driver_version,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "HostTopologyInfo":
        return HostTopologyInfo(
            accelerator_type=d["accelerator_type"],
            generation=d.get("generation", d["accelerator_type"].split("-")[0]),
            chips=[ChipInfo.from_dict(c) for c in d.get("chips", [])],
            mesh_shape=tuple(d.get("mesh_shape", (0, 0, 0))),  # type: ignore[arg-type]
            driver_version=d.get("driver_version", ""),
        )
