"""Local GPU discovery.

The port's counterpart of ``tpu_docker_api/telemetry/probe.py``: the NVML
path of the reference's detect-gpu sidecar. Through NVML
(``telemetry/nvml.py``) it reads each GPU's UUID, name, memory,
utilization, power limit and compute processes, and the driver version.
Without NVML it walks the ``/dev/nvidia<N>`` device nodes, as the JAX
probe walks ``/dev/accel*`` without its shim: the control plane works on
a host whose driver library is missing, with less telemetry.
"""

from __future__ import annotations

import glob
import os
import re

from tpu_docker_api_torch import errors
from tpu_docker_api_torch.scheduler.topology import (
    GENERATIONS,
    HostTopology,
    default_mesh_shape,
    generation_for_name,
)
from tpu_docker_api_torch.schemas.gpu import ChipInfo, HostTopologyInfo
from tpu_docker_api_torch.telemetry import nvml


def _detect_generation(name: str = "") -> str:
    """The generation of an NVML product name, else of the
    ``GPU_ACCELERATOR_TYPE`` environment variable (e.g. "h100-8"); h100
    when neither names a known part (the JAX probe's default is v5e)."""
    gen = generation_for_name(name) if name else None
    if gen is not None:
        return gen.name
    env = os.environ.get("GPU_ACCELERATOR_TYPE", "").lower()
    part = env.partition("-")[0]
    return part if part in GENERATIONS else "h100"


def list_gpu_devices() -> list[str]:
    """Sorted /dev/nvidia<N> paths present on this host (not nvidiactl,
    nvidia-uvm, ...)."""
    devs = glob.glob("/dev/nvidia[0-9]*")
    return sorted(devs, key=lambda p: int(re.sub(r"\D", "", p) or 0))


def _line_coords(shape: tuple[int, int, int], n: int):
    cid = 0
    for z in range(shape[2]):
        for y in range(shape[1]):
            for x in range(shape[0]):
                if cid >= n:
                    return
                yield cid, (x, y, z)
                cid += 1


def probe_host_info() -> HostTopologyInfo | None:
    """Hardware truth for the sidecar endpoint; None when no GPU is
    present. Raises TopologyUnknown when MIG is on: its UUIDs name GPU
    instances, and a whole-GPU grant of one would be wrong."""
    try:
        lib = nvml.load_nvml()
    except (OSError, nvml.NVMLError):
        lib = None
    if lib is not None:
        n = lib.device_count()
        if n == 0:
            return None
        mig = [i for i in range(n) if lib.mig_enabled(i)]
        if mig:
            raise errors.TopologyUnknown(
                f"MIG is enabled on GPUs {mig}: the scheduler grants whole "
                f"GPUs")
        metrics = [lib.chip_metrics(i) for i in range(n)]
        gen_name = _detect_generation(metrics[0].name)
        driver = lib.driver_version()
    else:
        devices = list_gpu_devices()
        if not devices:
            return None
        n = len(devices)
        gen_name = _detect_generation()
        driver = ""
        metrics = [nvml.ChipMetrics(
            chip_id=i, device_path=dev,
            hbm_total=GENERATIONS[gen_name].hbm_bytes_per_chip, hbm_used=0,
            duty_cycle=0.0, pid=_device_holder_pid(dev), uuid="", name="",
            power_limit_w=0.0) for i, dev in enumerate(devices)]
    gen = GENERATIONS[gen_name]
    shape = default_mesh_shape(gen, n)
    chips = [ChipInfo(
        chip_id=cid,
        device_path=m.device_path,
        coords=coords,
        cores_per_chip=gen.cores_per_chip,
        hbm_total_bytes=m.hbm_total,
        hbm_used_bytes=m.hbm_used,
        duty_cycle_pct=m.duty_cycle,
        pid=m.pid,
        uuid=m.uuid,
        name=m.name,
        power_limit_w=m.power_limit_w,
    ) for (cid, coords), m in zip(_line_coords(shape, n), metrics)]
    return HostTopologyInfo(
        accelerator_type=f"{gen_name}-{n}",
        generation=gen_name,
        chips=chips,
        mesh_shape=shape,
        driver_version=driver,
    )


def _device_holder_pid(dev_path: str) -> int:
    """Which pid (if any) holds the device node open — the process view the
    NVML ProcessInfo carried (model/gpu.go:16-28). Scans /proc/*/fd."""
    try:
        target = os.stat(dev_path).st_rdev
    except OSError:
        return 0
    for pid_dir in glob.glob("/proc/[0-9]*/fd"):
        try:
            for fd in os.listdir(pid_dir):
                try:
                    st = os.stat(os.path.join(pid_dir, fd))
                except OSError:
                    continue
                if st.st_rdev == target:
                    return int(pid_dir.split("/")[2])
        except OSError:
            continue
    return 0


def topology_from_info(info: HostTopologyInfo) -> HostTopology:
    gen = GENERATIONS[info.generation]
    return HostTopology.from_chips(
        gen, {c.chip_id: c.coords for c in info.chips},
        {c.chip_id: c.uuid for c in info.chips if c.uuid},
    )


def probe_local_topology() -> HostTopology | None:
    info = probe_host_info()
    return None if info is None else topology_from_info(info)
