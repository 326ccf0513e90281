"""Runtime-neutral container spec + GPU attachment rendering.

The port's counterpart of ``tpu_docker_api/runtime/spec.py``. Where the
JAX package renders ``/dev/accel*`` mounts, libtpu and the TPU topology
env, a GPU container is what the reference's ``newContainerResource``
renders (service/container.go:581-588): the granted GPUs' UUIDs, which the
Docker runtime attaches as ``DeviceRequests{Driver:"nvidia",
DeviceIDs:[UUIDs], Capabilities:[["gpu"]]}`` for the NVIDIA container
toolkit, and ``CUDA_VISIBLE_DEVICES`` naming the same UUIDs, the
counterpart of ``TPU_VISIBLE_CHIPS``, so a process run beside the engine
(``FakeRuntime`` exec) sees only its grant too.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from tpu_docker_api_torch.scheduler.topology import HostTopology


@dataclasses.dataclass
class PortBinding:
    container_port: int
    host_port: int
    protocol: str = "tcp"


@dataclasses.dataclass
class DeviceMount:
    host_path: str
    container_path: str
    permissions: str = "rwm"


@dataclasses.dataclass
class ContainerSpec:
    """Everything needed to (re)create a container — the persisted payload
    that makes rolling replacement possible (model/etcd.go EtcdContainerInfo
    analog)."""

    name: str
    image: str
    cmd: list[str] = dataclasses.field(default_factory=list)
    env: list[str] = dataclasses.field(default_factory=list)
    binds: list[str] = dataclasses.field(default_factory=list)  # "src:dest"
    port_bindings: list[PortBinding] = dataclasses.field(default_factory=list)
    devices: list[DeviceMount] = dataclasses.field(default_factory=list)
    chip_ids: list[int] = dataclasses.field(default_factory=list)
    ici_contiguous: bool = True
    open_stdin: bool = True   # reference sets OpenStdin/Tty so idle containers stay up
    tty: bool = True          # (service/container.go:51-57)
    privileged: bool = False
    #: the granted GPUs' UUIDs, in chip_ids order (DeviceRequests.DeviceIDs)
    gpu_uuids: list[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ContainerSpec":
        return ContainerSpec(
            name=d["name"],
            image=d["image"],
            cmd=list(d.get("cmd", [])),
            env=list(d.get("env", [])),
            binds=list(d.get("binds", [])),
            port_bindings=[PortBinding(**p) for p in d.get("port_bindings", [])],
            devices=[DeviceMount(**m) for m in d.get("devices", [])],
            chip_ids=list(d.get("chip_ids", [])),
            ici_contiguous=bool(d.get("ici_contiguous", True)),
            open_stdin=bool(d.get("open_stdin", True)),
            tty=bool(d.get("tty", True)),
            privileged=bool(d.get("privileged", False)),
            gpu_uuids=list(d.get("gpu_uuids", [])),
        )


#: env vars we manage; stripped before re-rendering so patches don't stack
_GPU_ENV_PREFIXES = ("CUDA_VISIBLE_DEVICES=",)


def render_gpu_attachment(
    spec: ContainerSpec,
    chip_ids: list[int],
    topology: HostTopology,
    ici_contiguous: bool = True,
) -> ContainerSpec:
    """Mutate ``spec`` in place to attach ``chip_ids`` and return it.

    Sets ``spec.gpu_uuids`` to the GPUs' UUIDs (what the Docker runtime
    puts in ``DeviceRequests``) and renders ``CUDA_VISIBLE_DEVICES`` with
    the same UUIDs: CUDA takes ``GPU-<uuid>`` entries and numbers the
    visible GPUs 0..n-1 in that order. A re-render first strips what an
    earlier one rendered. Chip count 0 clears every GPU artifact — the
    "cardless" container (service/container.go RunGpuContainer with
    gpuCount 0). Raises TopologyUnknown when a GPU has no UUID.

    A host whose topology names its GPUs by NVML index
    (``HostTopology.build(..., index_names=True)``) gets those indices in
    ``gpu_uuids``, and ``CUDA_VISIBLE_DEVICES`` counts the container's own
    GPUs, ``0..n-1``: the NVIDIA runtime numbers a container's GPUs so, and
    a host index would name a GPU the container does not see.
    """
    spec.env = [e for e in spec.env if not e.startswith(_GPU_ENV_PREFIXES)]
    spec.chip_ids = sorted(chip_ids)
    spec.ici_contiguous = ici_contiguous
    spec.gpu_uuids = topology.uuids_for(spec.chip_ids)
    if spec.gpu_uuids:
        visible = (spec.gpu_uuids if not spec.gpu_uuids[0].isdigit()
                   else [str(i) for i in range(len(spec.gpu_uuids))])
        spec.env.append("CUDA_VISIBLE_DEVICES=" + ",".join(visible))
    return spec
